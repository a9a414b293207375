"""The audio and vision front ends on the port (hubert-xlarge's
bidirectional encoder over precomputed frames; internvl2-1b's patch
projector prefixed to its Qwen2 stack) against the JAX package, at the
smoke configs, with JAX's weights carried over by ``params_from_numpy``
and the same numpy frames, patches and tokens.

JAX draws every bias as zeros and every norm scale as ones
(src/repro/models/layers.py); the weights here replace those leaves with
seeded values in both packages, so that the front ends' biases, hubert's
attention, output, MLP and LayerNorm biases and internvl2's QKV biases
show in the outputs. The JAX side of the model-level comparisons is
computed once per module (the ``jax_side`` fixture), jitted with XLA's
``xla_allow_excess_precision`` off, so that every bf16 op rounds to bf16
as it does in the port's eager ops (tests/test_torch_ssm_family.py).

Tolerances: embeddings within 1e-5 of their scale (max |ref|) at f32 and
1e-2 at bf16 (a product summed in another order, rounded once to bf16:
2^-8 of the scale, twice for the projector's two layers); logits and
cache leaves within 2e-3 of the logit scale at f32 and 2e-2 at bf16
(tests/test_serve.py:53's limit); decode-equals-forward within 2e-2 and
multi-token decode within 3e-2 against the port's own forward, the
forward offset by ``n_patches`` (tests/test_serve.py:33-84); greedy
tokens, lengths, kpos tags, tree paths, logical axes, shapes and dtypes
exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import get_smoke_config as jget_smoke
from repro.models import init_tree as jinit_tree
from repro.models import model_schema as jmodel_schema
from repro.models.model import embed_inputs as jembed_inputs
from repro.models.model import forward as jforward
from repro.models.model import param_count as jparam_count
from repro.serve import ContinuousBatcher as JBatcher
from repro.serve import Request as JRequest
from repro.serve import init_cache as jinit_cache
from repro.serve import prefill as jprefill
from repro.serve import serve_step as jserve_step
from repro_torch.configs import get_config, get_smoke_config, list_archs
from repro_torch.launch import serve as launch_serve
from repro_torch.models import (
    active_param_count,
    cast_matrices,
    embed_inputs,
    forward,
    model_schema,
    param_count,
    params_from_numpy,
)
from repro_torch.models.params import tree_paths
from repro_torch.serve import (
    ContinuousBatcher,
    Request,
    init_cache,
    prefill,
    serve_step,
    write_slot,
)

HUBERT, VLM = "hubert-xlarge", "internvl2-1b"
ARCHS = (HUBERT, VLM)
B, FRAMES, TEXT, MAX_LEN = 2, 77, 23, 64    # 77 frames: past a 64 chunk
# the leaves JAX draws as constants (init "zeros" / "ones"), drawn here in
# both packages: biases around 0, norm scales around 1
SEEDED = {"b": 0.1, "bias": 0.1, "bq": 0.1, "bk": 0.1, "bv": 0.1,
          "bo": 0.1, "scale": 0.1}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _cfgs(arch, act="f32"):
    tcfg, jcfg = get_smoke_config(arch), jget_smoke(arch)
    if act == "f32":
        tcfg = dataclasses.replace(tcfg, act_dtype=torch.float32,
                                   cache_dtype=torch.float32)
        jcfg = dataclasses.replace(jcfg, act_dtype=jnp.float32,
                                   cache_dtype=jnp.float32)
    return tcfg, jcfg


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _rel_err(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-9))


def _seeded(tree, seed=11):
    """``tree`` with the SEEDED leaves drawn from ``seed`` (biases around
    0, scales around 1), in their own dtype."""
    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        name = path[-1].key
        if name not in SEEDED:
            return leaf
        v = rng.randn(*leaf.shape) * SEEDED[name] + (name == "scale")
        return jnp.asarray(v, leaf.dtype)
    return jax.tree_util.tree_map_with_path(draw, tree)


def _jax_run(fn, *args):
    """``fn(*args)`` jitted, every op rounded to its own dtype."""
    return jax.jit(fn).lower(*args).compile(
        {"xla_allow_excess_precision": False})(*args)


def _inputs(arch, seed=3, text=TEXT, patches=True, batch=B):
    """Seeded numpy inputs: hubert's frames (B, 77, frontend_dim); the
    VLM's tokens (B, text) and, with ``patches``, (B, n_patches,
    frontend_dim) patches."""
    cfg = get_smoke_config(arch)
    rng = np.random.RandomState(seed)
    if arch == HUBERT:
        return {"frames": rng.randn(batch, FRAMES, cfg.frontend_dim)
                .astype(np.float32)}
    out = {"tokens": rng.randint(0, cfg.vocab, size=(batch, text))
           .astype(np.int32)}
    if patches:
        out["patches"] = rng.randn(batch, cfg.n_patches, cfg.frontend_dim) \
            .astype(np.float32)
    return out


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


class JaxSide:
    """The JAX package's weights and outputs, each computed on first use."""

    def __init__(self):
        self._memo = {}

    def _get(self, key, make):
        if key not in self._memo:
            self._memo[key] = make()
        return self._memo[key]

    def weights(self, arch):
        """(JAX params, the port's copy of them)."""
        def make():
            schema = jmodel_schema(_cfgs(arch)[1])
            jp = _seeded(jax.jit(
                lambda: jinit_tree(jax.random.key(0), schema))())
            return jp, params_from_numpy(_np_tree(jp), device="cpu")
        return self._get(("weights", arch), make)

    def embed(self, arch, act):
        def make():
            jcfg = _cfgs(arch, act)[1]
            jp, _ = self.weights(arch)
            return _np(_jax_run(lambda p, b: jembed_inputs(p, b, jcfg), jp,
                                _j(_inputs(arch))))
        return self._get(("embed", arch, act), make)

    def forward(self, case, act):
        def make():
            arch = HUBERT if case == HUBERT else VLM
            jcfg = _cfgs(arch, act)[1]
            jp, _ = self.weights(arch)
            batch = _inputs(arch, patches=case != "vlm_text")
            return _np(_jax_run(lambda p, b: jforward(p, b, jcfg), jp,
                                _j(batch)))
        return self._get(("forward", case, act), make)

    def prefill_step(self, act):
        """The VLM's prefill of (tokens[:, :-1], patches) and one
        serve_step of tokens[:, -1:]."""
        def make():
            jcfg = _cfgs(VLM, act)[1]
            jp, _ = self.weights(VLM)
            batch = _inputs(VLM, text=TEXT + 1)
            pre = _j({"tokens": batch["tokens"][:, :-1],
                      "patches": batch["patches"]})
            jl, jc, jlen = _jax_run(
                lambda p, b: jprefill(p, b, jcfg, MAX_LEN), jp, pre)
            jg, jc = _jax_run(
                lambda p, c, t, n: jserve_step(p, c, t, n, jcfg), jp, jc,
                jnp.asarray(batch["tokens"][:, -1:]), jlen)
            return _np(jl), np.asarray(jlen), _np(jg), _np_tree(jc)
        return self._get(("prefill_step", act), make)


@pytest.fixture(scope="module")
def jax_side():
    return JaxSide()


# ---------------------------------------------------------------------------
# configs, schema, parameters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_jax_value_for_value(arch):
    assert arch in list_archs()
    for ours, theirs in ((get_config(arch), jget_config(arch)),
                         (get_smoke_config(arch), jget_smoke(arch))):
        a, b = dataclasses.asdict(ours), dataclasses.asdict(theirs)
        for key in ("param_dtype", "act_dtype", "cache_dtype"):
            assert str(a.pop(key)).split(".")[-1] == \
                jnp.dtype(b.pop(key)).name
        assert a == b


@pytest.mark.parametrize("full", [True, False])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_counts_match_jax(arch, full):
    cfg = get_config(arch) if full else get_smoke_config(arch)
    jcfg = jget_config(arch) if full else jget_smoke(arch)
    assert param_count(cfg) == jparam_count(jcfg) == active_param_count(cfg)
    if full:
        lo, hi = {HUBERT: (0.9e9, 1.3e9),            # tests/test_models.py
                  VLM: (0.4e9, 1.1e9)}[arch]         # :166, :170
        assert lo < param_count(cfg) < hi


@pytest.mark.parametrize("full", [True, False])
@pytest.mark.parametrize("arch", ARCHS)
def test_schema_matches_jax(arch, full):
    """Every leaf's path, shape, logical axes, initializer and dtype equal
    to JAX's schema, the ``frontend`` subtree included; audio keeps the
    token table it never reads, and hubert's head is untied."""
    cfg = get_config(arch) if full else get_smoke_config(arch)
    jcfg = jget_config(arch) if full else jget_smoke(arch)
    got = tree_paths(model_schema(cfg))
    want = {"/".join(k.key for k in path): leaf for path, leaf in
            jax.tree_util.tree_flatten_with_path(
                jmodel_schema(jcfg),
                is_leaf=lambda x: hasattr(x, "logical"))[0]}
    assert sorted(got) == sorted(want)
    for path, d in got.items():
        w = want[path]
        assert d.shape == tuple(w.shape) and d.logical == tuple(w.logical)
        assert d.init == w.init and d.scale == w.scale
        assert str(d.dtype).split(".")[-1] == jnp.dtype(w.dtype).name
    fe = {p: d for p, d in got.items() if p.startswith("frontend/")}
    if arch == HUBERT:
        assert sorted(fe) == ["frontend/b", "frontend/w"]
        assert fe["frontend/w"].shape == (cfg.frontend_dim, cfg.d_model)
        assert "embed/table" in got and "lm_head/w" in got
    else:
        assert sorted(fe) == ["frontend/fc1/b", "frontend/fc1/w",
                              "frontend/fc2/b", "frontend/fc2/w"]
        assert fe["frontend/fc2/w"].logical == ("d_model", None)
        assert "lm_head/w" not in got


@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_numpy_and_cast_carry_the_frontend(arch, jax_side):
    """JAX's tree carried bit for bit, the seeded biases included; then
    ``cast_matrices`` casts the front end's matrices to the activation
    dtype and keeps its biases, and every other vector, fp32 (the
    per-head q/k/v biases have two axes and are cast like a matrix: JAX
    casts them to the activation dtype at use, the same number)."""
    jp, tp = jax_side.weights(arch)
    want, got = tree_paths(_np_tree(jp)), tree_paths(tp)
    assert sorted(got) == sorted(want)
    for path, arr in want.items():
        np.testing.assert_array_equal(got[path].numpy(), arr)
    assert got["stack/layers/attn/bq"].abs().max() > 0
    cfg = get_smoke_config(arch)
    schema = model_schema(cfg)
    cast = tree_paths(cast_matrices(tp, schema, cfg.act_dtype))
    defs = tree_paths(schema)
    for path, t in cast.items():
        vector = sum(ax != "stack" for ax in defs[path].logical) == 1
        assert t.dtype == (torch.float32 if vector else cfg.act_dtype), path
    fe = {p: t.dtype for p, t in cast.items() if p.startswith("frontend/")}
    assert fe and all(dt == (torch.float32 if p.endswith("/b")
                             else torch.bfloat16) for p, dt in fe.items())


# ---------------------------------------------------------------------------
# embeddings and the forward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("act", ["f32", "bf16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_embed_inputs_match_jax(arch, act, jax_side):
    """Frames through the audio dense; patches through fc1, tanh-GELU in
    f32 and fc2, ahead of the tokens' embeddings."""
    tcfg, _ = _cfgs(arch, act)
    _, tp = jax_side.weights(arch)
    got = embed_inputs(tp, _t(_inputs(arch)), tcfg)
    want = jax_side.embed(arch, act)
    n = FRAMES if arch == HUBERT else tcfg.n_patches + TEXT
    assert tuple(got.shape) == want.shape == (B, n, tcfg.d_model)
    assert got.dtype == tcfg.act_dtype
    assert _rel_err(_np(got), want) < (1e-5 if act == "f32" else 1e-2)


def test_vision_text_only_batch_is_its_tokens():
    """Without ``patches`` the VLM embeds its tokens alone: the text part
    of a batch with patches, bit for bit (the tokens' rows do not depend
    on the prefix)."""
    cfg = get_smoke_config(VLM)
    tp = params_from_numpy(_np_tree(_seeded(jax.jit(lambda: jinit_tree(
        jax.random.key(0), jmodel_schema(jget_smoke(VLM))))())),
        device="cpu")
    batch = _t(_inputs(VLM))
    with_p = embed_inputs(tp, batch, cfg)
    text = embed_inputs(tp, {"tokens": batch["tokens"]}, cfg)
    assert tuple(text.shape) == (B, TEXT, cfg.d_model)
    assert torch.equal(with_p[:, cfg.n_patches:], text)


@pytest.mark.parametrize("act", ["f32", "bf16"])
@pytest.mark.parametrize("case", [HUBERT, "vlm_patches", "vlm_text"])
def test_forward_matches_jax(case, act, jax_side):
    arch = HUBERT if case == HUBERT else VLM
    tcfg, _ = _cfgs(arch, act)
    _, tp = jax_side.weights(arch)
    batch = _inputs(arch, patches=case != "vlm_text")
    got = forward(tp, _t(batch), tcfg)
    want = jax_side.forward(case, act)
    assert tuple(got.shape) == want.shape and got.dtype == torch.float32
    n = {HUBERT: FRAMES, "vlm_patches": tcfg.n_patches + TEXT,
         "vlm_text": TEXT}[case]
    assert want.shape == (B, n, tcfg.vocab)
    assert _rel_err(got.numpy(), want) < (2e-3 if act == "f32" else 2e-2)
    ref = forward(tp, _t(batch), tcfg, backend="ref")
    assert torch.equal(ref, got)          # the CPU runs the plain scan


def test_hubert_attention_is_bidirectional(jax_side):
    """Changing the last frame changes the first position's logits; with
    ``encoder_only`` off (a causal stack on the same weights) it does
    not."""
    tcfg, _ = _cfgs(HUBERT)
    _, tp = jax_side.weights(HUBERT)
    frames = _t(_inputs(HUBERT))["frames"]
    other = frames.clone()
    other[:, -1] += 1.0
    for encoder in (True, False):
        cfg = dataclasses.replace(tcfg, encoder_only=encoder)
        a = forward(tp, {"frames": frames}, cfg)
        b = forward(tp, {"frames": other}, cfg)
        first = float((a[:, 0] - b[:, 0]).abs().max())
        assert (first > 1e-4) if encoder else (first == 0.0)
        assert float((a[:, -1] - b[:, -1]).abs().max()) > 1e-4


# ---------------------------------------------------------------------------
# serving the VLM: prefill with patches, decode on tokens
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("act", ["f32", "bf16"])
def test_vlm_prefill_and_step_match_jax(act, jax_side):
    """prefill of (tokens, patches) + one serve_step of a token: logits,
    lengths (patches counted), every cache leaf by tree path, kpos
    0..n_patches + L over the concatenated sequence."""
    tcfg, _ = _cfgs(VLM, act)
    _, tp = jax_side.weights(VLM)
    batch = _inputs(VLM, text=TEXT + 1)
    jl, jlen, jg, jc = jax_side.prefill_step(act)
    tl, tc, tlen = prefill(tp, _t({"tokens": batch["tokens"][:, :-1],
                                   "patches": batch["patches"]}),
                           tcfg, MAX_LEN)
    tol = 2e-3 if act == "f32" else 2e-2
    n = tcfg.n_patches + TEXT
    assert tuple(tl.shape) == jl.shape == (B, n, tcfg.vocab)
    assert _rel_err(_np(tl), jl) < tol
    assert tlen.tolist() == jlen.tolist() == [n] * B
    tg, tc = serve_step(tp, tc, torch.from_numpy(batch["tokens"][:, -1:]),
                        tlen, tcfg)
    assert _rel_err(_np(tg), jg) < tol
    want, got = tree_paths(jc), tree_paths(tc)
    assert sorted(got) == sorted(want) == ["layers/k", "layers/kpos",
                                           "layers/v"]
    for path, arr in want.items():
        assert tuple(got[path].shape) == arr.shape
        assert str(got[path].dtype).split(".")[-1] == arr.dtype.name
        if path.endswith("kpos"):
            np.testing.assert_array_equal(got[path].numpy(), arr)
        else:
            assert _rel_err(_np(got[path]), arr.astype(np.float32)) < tol
    kpos = got["layers/kpos"].numpy()
    assert (kpos[:, :, :n + 1] == np.arange(n + 1)).all()
    assert (kpos[:, :, n + 1:] == -1).all()


def test_vlm_decode_matches_forward(jax_side):
    """prefill(patches, L-1 tokens) + decode(1) == the full forward's last
    position (tests/test_serve.py:33-53)."""
    tcfg, _ = _cfgs(VLM)
    _, tp = jax_side.weights(VLM)
    batch = _t(_inputs(VLM, seed=5, text=TEXT + 1))
    full = forward(tp, batch, tcfg)
    _, cache, lengths = prefill(
        tp, {"tokens": batch["tokens"][:, :-1], "patches": batch["patches"]},
        tcfg, MAX_LEN)
    got, _ = serve_step(tp, cache, batch["tokens"][:, -1:], lengths, tcfg)
    assert _rel_err(got.numpy(), full[:, -1].numpy()) < 2e-2


def test_vlm_multi_token_decode_consistency(jax_side):
    """Decoding 4 tokens step by step == the forward on the extended
    sequence, offset by n_patches (tests/test_serve.py:56-84)."""
    tcfg, _ = _cfgs(VLM)
    _, tp = jax_side.weights(VLM)
    l0, t = 17, 4
    batch = _t(_inputs(VLM, seed=2, text=l0 + t, batch=1))
    full = forward(tp, batch, tcfg)
    _, cache, lengths = prefill(
        tp, {"tokens": batch["tokens"][:, :l0], "patches": batch["patches"]},
        tcfg, MAX_LEN)
    outs = []
    for i in range(t):
        lg, cache = serve_step(tp, cache,
                               batch["tokens"][:, l0 + i:l0 + i + 1],
                               lengths, tcfg)
        lengths = lengths + 1
        outs.append(lg)
    got = torch.stack(outs, dim=1)
    off = tcfg.n_patches
    assert _rel_err(got.numpy(), full[:, off + l0:off + l0 + t].numpy()) \
        < 3e-2


def _patch_prefill(call, prompts, patches):
    """A batcher's prefill_fn that prefills each request's tokens with its
    own patches. The batcher admits in submission order (nothing is shed
    here), so the i-th call is the i-th prompt; the prompt is checked.
    ``call(tokens (1, L), patches (1, P, F))`` -> (logits, cache)."""
    order = iter(range(len(prompts)))

    def prefill_fn(prompt):
        i = next(order)
        assert np.array_equal(prompt[0], prompts[i])
        logits, one = call(prompt, patches[i][None])
        return logits, one, prompt.shape[1] + patches[i].shape[0]
    return prefill_fn


def test_vlm_continuous_batcher_matches_jax_token_for_token(jax_side):
    """4 slots, 6 requests of 2-40 tokens, each with its own 16 seeded
    patches, 5 new tokens each, greedy, at f32: the port's batcher gives
    JAX's tokens, both driven by the same patch-attaching prefill_fn."""
    tcfg, jcfg = _cfgs(VLM)
    jp, tp = jax_side.weights(VLM)
    slots, s = 4, 64
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, tcfg.vocab, size=n).astype(np.int32)
               for n in (2, 40, 17, 3, 31, 29)]
    patches = [rng.randn(tcfg.n_patches, tcfg.frontend_dim)
               .astype(np.float32) for _ in prompts]

    step_jit = jax.jit(lambda p, c, t, n: jserve_step(p, c, t, n, jcfg))
    prefill_jit = jax.jit(
        lambda p, bt: jprefill(p, bt, jcfg, s, last_only=True))

    def jcall(tokens, pt):
        lg, one, _ = prefill_jit(jp, {"tokens": jnp.asarray(tokens),
                                      "patches": jnp.asarray(pt)})
        return lg, one

    def jwrite_slot(cache, i, one, length):
        return jax.tree.map(lambda big, o: big.at[:, i].set(o[:, 0]),
                            cache, one)

    jbat = JBatcher(slots, lambda c, t, n: step_jit(jp, c, t, n),
                    _patch_prefill(jcall, prompts, patches), jwrite_slot)
    jreqs = [JRequest(rid=r, prompt=p, max_new=5)
             for r, p in enumerate(prompts)]
    for r in jreqs:
        jbat.submit(r)
    jbat.run(jinit_cache(jcfg, slots, s))

    def tcall(tokens, pt):
        lg, one, _ = prefill(tp, {"tokens": torch.from_numpy(tokens),
                                  "patches": torch.from_numpy(pt)},
                             tcfg, s, last_only=True)
        return lg, one

    tbat = ContinuousBatcher(
        slots, lambda c, t, n: serve_step(tp, c, t, n, tcfg),
        _patch_prefill(tcall, prompts, patches), write_slot)
    treqs = [Request(rid=r, prompt=p, max_new=5)
             for r, p in enumerate(prompts)]
    for r in treqs:
        tbat.submit(r)
    tbat.run(init_cache(tcfg, slots, s, device="cpu"))
    assert all(r.done and len(r.out) == 5 for r in treqs)
    assert [r.out for r in treqs] == [[int(t) for t in r.out]
                                      for r in jreqs]
    assert tbat.steps == jbat.steps


def test_launch_serve_refuses_hubert():
    """The encoder has no decode: the CLI refuses it, as JAX's does."""
    with pytest.raises(SystemExit, match="encoder-only"):
        launch_serve.main(["--arch", HUBERT, "--smoke", "--device", "cpu"])


def test_launch_serve_serves_vlm_text_only():
    """The CLI serves internvl2 on text-only prompts (a Request carries no
    patches, as in the JAX CLI)."""
    stats = launch_serve.main(["--arch", VLM, "--smoke", "--device", "cpu",
                               "--requests", "3", "--max-new", "4"])
    assert stats["requests"] == 3 and stats["tokens"] == 3 * 4
    assert stats["decode_tokens"] == 3 * 3
