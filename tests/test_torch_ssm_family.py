"""The SSM / hybrid family on the port (mamba2-130m's Mamba-2 stack, and
zamba2-1.2b's mamba segments with the shared attention + GLU block and its
per-invocation LoRA) against the JAX package, at the smoke configs, with
JAX's weights carried over by ``params_from_numpy`` and the same numpy
inputs.

JAX draws ``lora_b``, ``conv_b`` and ``dt_bias`` as zeros and ``A_log``
and ``D`` as ones; the weights here replace those leaves with seeded
values in both packages, so that the LoRA delta, each invocation's index,
the conv bias and every head's own decay show in the outputs. The JAX
side of the model-level comparisons is computed once per module (the
``jax_side`` fixture memoises it by architecture and dtype), jitted with
XLA's ``xla_allow_excess_precision`` off, so that every bf16 op rounds to
bf16 as it does op by op in JAX and in the port's eager ops (with it on,
XLA keeps some bf16 intermediates in f32, and on zamba2's smoke model
the jitted bf16 logits are 0.027-0.029 of their scale from JAX's own
op-by-op ones, beyond the bf16 limit below; with it off they are equal).

Tolerances: ``ssd_scan`` within 1e-5 of its scale (max |ref|) at an f32
intra-chunk dtype and 2e-2 at bf16; the Mamba-2 block, its cache and its
decode step within 1e-5; logits, hidden states and cache leaves within
1e-4 of their scale at f32 activations and caches, 2e-2 at the default
bf16 (tests/test_serve.py:53's limit); decode-equals-forward within 2e-2
and multi-token decode within 3e-2 of the scale against the port's own
forward, as tests/test_serve.py:32-108 holds JAX's; greedy tokens, kpos
tags, tree paths, shapes and dtypes exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import get_smoke_config as jget_smoke
from repro.models import active_param_count as jactive_param_count
from repro.models import init_tree as jinit_tree
from repro.models import model_schema as jmodel_schema
from repro.models import ssm as jssm
from repro.models.model import embed_inputs as jembed_inputs
from repro.models.model import output_logits as joutput_logits
from repro.models.model import param_count as jparam_count
from repro.models.transformer import run_stack as jrun_stack
from repro.serve import ContinuousBatcher as JBatcher
from repro.serve import Request as JRequest
from repro.serve import init_cache as jinit_cache
from repro.serve import prefill as jprefill
from repro.serve import serve_step as jserve_step
from repro_torch.configs import get_config, get_smoke_config, list_archs
from repro_torch.launch import serve as launch_serve
from repro_torch.models import (
    active_param_count,
    embed_inputs,
    forward,
    model_schema,
    param_count,
    params_from_numpy,
    run_stack,
    ssm,
)
from repro_torch.models.params import tree_paths
from repro_torch.models.transformer import attention_layers
from repro_torch.serve import init_cache, prefill, serve_step, write_slot

MAMBA, ZAMBA = "mamba2-130m", "zamba2-1.2b"
ARCHS = (MAMBA, ZAMBA)
B, PROMPT, MAX_LEN = 2, 37, 96       # prefill(37: two chunks of 32) + a step
# the leaves JAX draws as constants, drawn here in both packages
SEEDED = {"lora_b": 0.05, "conv_b": 0.1, "dt_bias": 0.5, "A_log": 0.5,
          "D": 1.0}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _cfgs(arch, act="f32", **change):
    tcfg, jcfg = get_smoke_config(arch), jget_smoke(arch)
    if act == "f32":
        change = dict(change, act_dtype=torch.float32,
                      cache_dtype=torch.float32)
    jchange = {k: (jnp.float32 if v is torch.float32 else v)
               for k, v in change.items()}
    return (dataclasses.replace(tcfg, **change),
            dataclasses.replace(jcfg, **jchange))


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


def _tokens(vocab, shape, seed):
    return np.random.RandomState(seed).randint(0, vocab, size=shape)


def _seeded(tree, seed=11):
    """``tree`` with the SEEDED leaves drawn from ``seed`` (A_log around
    0, D around 1), in their own dtype."""
    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        name = path[-1].key
        if name not in SEEDED:
            return leaf
        v = rng.randn(*leaf.shape) * SEEDED[name] + (name == "D")
        return jnp.asarray(v, leaf.dtype)
    return jax.tree_util.tree_map_with_path(draw, tree)


def _jinit(schema, seed=0):
    """JAX's init_tree, jitted (one compile; the draws are the same)."""
    return jax.jit(lambda: jinit_tree(jax.random.key(seed), schema))()


def _jax_run(fn, *args):
    """``fn(*args)`` jitted, every op rounded to its own dtype."""
    return jax.jit(fn).lower(*args).compile(
        {"xla_allow_excess_precision": False})(*args)


class JaxSide:
    """The JAX package's weights and outputs, each computed on first use."""

    def __init__(self):
        self._memo = {}

    def _get(self, key, make):
        if key not in self._memo:
            self._memo[key] = make()
        return self._memo[key]

    def weights(self, arch):
        """(JAX params, the port's copy of them); the activation dtype
        does not change them."""
        def make():
            jp = _seeded(_jinit(jmodel_schema(_cfgs(arch)[1])))
            return jp, params_from_numpy(_np_tree(jp), device="cpu")
        return self._get(("weights", arch), make)

    def model(self, arch, act, toks):
        """forward's logits and run_stack's hidden states of ``toks``."""
        def make():
            jcfg = _cfgs(arch, act)[1]
            jp, _ = self.weights(arch)
            hidden = _jax_run(lambda p, b: jrun_stack(
                p["stack"], jembed_inputs(p, b, jcfg), jcfg), jp,
                {"tokens": jnp.asarray(toks)})
            # forward is run_stack, then output_logits
            logits = _jax_run(lambda p, h: joutput_logits(p, h, jcfg),
                              jp, hidden)
            return _np(logits), _np(hidden)
        return self._get(("model", arch, act), make)

    def prefill_step(self, arch, act, toks):
        """prefill(toks[:, :-1]) and one serve_step of toks[:, -1:]."""
        def make():
            jcfg = _cfgs(arch, act)[1]
            jp, _ = self.weights(arch)
            jl, jc, jlen = _jax_run(
                lambda p, b: jprefill(p, b, jcfg, MAX_LEN), jp,
                {"tokens": jnp.asarray(toks[:, :-1])})
            jg, jc = _jax_run(
                lambda p, c, t, n: jserve_step(p, c, t, n, jcfg), jp,
                jc, jnp.asarray(toks[:, -1:]), jlen)
            return _np(jl), np.asarray(jlen), _np(jg), _np_tree(jc)
        return self._get(("prefill_step", arch, act), make)


@pytest.fixture(scope="module")
def jax_side():
    return JaxSide()


# ---------------------------------------------------------------------------
# configs, schema, parameters, caches
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
    assert param_count(cfg) == jparam_count(jcfg)
    assert active_param_count(cfg) == jactive_param_count(jcfg) \
        == param_count(cfg)
    if full:
        lo, hi = {MAMBA: (0.1e9, 0.17e9),                # tests/test_models.py
                  ZAMBA: (1.0e9, 1.5e9)}[arch]           # :167, :171
        assert lo < param_count(cfg) < hi


@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_numpy_round_trips_every_leaf(arch, jax_side):
    """Every parameter's path, shape and dtype as JAX's tree and the
    port's schema give them, zamba2's double-stacked segments included,
    and the values carried bit for bit."""
    jp, tp = jax_side.weights(arch)
    want, got = tree_paths(_np_tree(jp)), tree_paths(tp)
    schema = tree_paths(model_schema(_cfgs(arch)[0]))
    assert sorted(got) == sorted(want) == sorted(schema)
    cfg = get_smoke_config(arch)
    conv_dim = cfg.ssm_heads * cfg.ssm_headdim \
        + 2 * cfg.ssm_groups * cfg.ssm_state
    if arch == MAMBA:
        assert got["stack/layers/mixer/conv_w"].shape == (
            cfg.n_layers, cfg.ssm_conv_kernel, conv_dim)
        assert not any("shared" in p or "attn" in p for p in got)
    else:
        n_seg = cfg.n_layers // cfg.attn_every
        assert got["stack/segments/mixer/wx"].shape == (
            n_seg, cfg.attn_every, cfg.d_model, cfg.ssm_heads,
            cfg.ssm_headdim)
        assert got["stack/shared/block/attn/wq"].shape[0] == cfg.d_model
        assert got["stack/shared/lora_a"].shape == (
            n_seg, cfg.d_model, cfg.shared_lora_rank)
        assert got["stack/tail/mixer/A_log"].shape == (
            cfg.n_layers - n_seg * cfg.attn_every, cfg.ssm_heads)
        assert attention_layers(cfg) == n_seg
    for path, arr in want.items():
        assert tuple(got[path].shape) == arr.shape == schema[path].shape
        assert str(got[path].dtype).split(".")[-1] == arr.dtype.name
        np.testing.assert_array_equal(got[path].numpy(), arr)
    for name in ("A_log", "D", "dt_bias"):
        assert got[next(p for p in got if p.endswith(name))].dtype \
            == torch.float32


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_leaves_match_jax(arch):
    """Every cache leaf's path, shape and dtype equal to JAX's init_cache,
    at the default dtypes (conv in the cache dtype, state f32)."""
    cfg, jcfg = get_smoke_config(arch), jget_smoke(arch)
    want = tree_paths(_np_tree(jinit_cache(jcfg, 3, 40)))
    got = tree_paths(init_cache(cfg, 3, 40, device="cpu"))
    assert sorted(got) == sorted(want)
    for path, arr in want.items():
        assert tuple(got[path].shape) == arr.shape
        assert str(got[path].dtype).split(".")[-1] == arr.dtype.name
        assert not got[path].float().any() or path.endswith("kpos")
    if arch == ZAMBA:
        assert got["segments/state"].shape == (2, 3, 3, 8, 16, 16)
        assert got["shared/kpos"].shape == (2, 3, 40)
        assert got["tail/conv"].dtype == torch.bfloat16
    else:
        assert sorted(got) == ["layers/conv", "layers/state"]


def test_ssm_cache_is_constant_in_length():
    """mamba2's decode cache does not grow with max_len; zamba2's grows
    only by its shared block's KV caches."""
    def nbytes(cfg, max_len):
        return sum(t.numel() * t.element_size() for t in tree_paths(
            init_cache(cfg, 1, max_len, device="cpu")).values())
    m = get_smoke_config(MAMBA)
    assert nbytes(m, 16) == nbytes(m, 4096)
    z = get_smoke_config(ZAMBA)
    per_tok = (z.n_layers // z.attn_every) * (
        2 * z.n_kv_heads * z.d_head * 2 + 4)
    assert nbytes(z, 64) - nbytes(z, 32) == 32 * per_tok


# ---------------------------------------------------------------------------
# the SSD scan and the Mamba-2 block
# ---------------------------------------------------------------------------

def _scan_inputs(seq, groups, seed=0):
    rng = np.random.RandomState(seed)
    b, h, p, n = 2, 4, 8, 16
    x = rng.randn(b, seq, h, p).astype(np.float32)
    dt = np.log1p(np.exp(rng.randn(b, seq, h))).astype(np.float32)
    a = (-np.exp(rng.randn(h) * 0.3)).astype(np.float32)
    bm = rng.randn(b, seq, groups, n).astype(np.float32)
    cm = rng.randn(b, seq, groups, n).astype(np.float32)
    h0 = rng.randn(b, h, p, n).astype(np.float32)
    return x, dt, a, bm, cm, h0


@pytest.mark.parametrize("intra", ["f32", "bf16"])
@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("seq", [40, 77])
def test_ssd_scan_matches_jax(seq, groups, with_h0, intra):
    """L 40 and 77 at chunk 16 (both padded), G 1 and 2 (groups to heads
    as jnp.repeat maps them), with and without an initial state: y and
    the last state against JAX's."""
    x, dt, a, bm, cm, h0 = _scan_inputs(seq, groups)
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[intra]
    jy, jh = jssm.ssd_scan(*map(jnp.asarray, (x, dt, a, bm, cm)), chunk=16,
                           h0=jnp.asarray(h0) if with_h0 else None,
                           return_state=True, intra_dtype=jdt)
    ty, th = ssm.ssd_scan(*map(torch.from_numpy, (x, dt, a, bm, cm)),
                          chunk=16,
                          h0=torch.from_numpy(h0) if with_h0 else None,
                          return_state=True, intra_dtype=tdt)
    assert tuple(ty.shape) == x.shape and ty.dtype == torch.float32
    assert th.dtype == torch.float32
    tol = 1e-5 if intra == "f32" else 2e-2
    assert _rel_err(_np(ty), _np(jy)) < tol
    assert _rel_err(_np(th), _np(jh)) < tol


@pytest.mark.parametrize("groups", [1, 2])
def test_ssd_scan_equals_recurrence(groups):
    """The chunked scan at f32 against the per-token recurrence
    (tests/test_models.py:132-156), from an initial state, at L 77."""
    x, dt, a, bm, cm, h0 = _scan_inputs(77, groups, seed=3)
    got, last = ssm.ssd_scan(*map(torch.from_numpy, (x, dt, a, bm, cm)),
                             chunk=16, h0=torch.from_numpy(h0),
                             return_state=True)
    b, seq, h, p = x.shape
    hpg = h // groups
    st = h0.astype(np.float64)
    want = np.zeros(x.shape)
    for t in range(seq):
        for hh in range(h):
            gi = hh // hpg
            st[:, hh] = np.exp(dt[:, t, hh] * a[hh])[:, None, None] \
                * st[:, hh] + (dt[:, t, hh][:, None, None]
                               * x[:, t, hh][:, :, None]
                               * bm[:, t, gi][:, None, :])
            want[:, t, hh] = np.einsum("bpn,bn->bp", st[:, hh], cm[:, t, gi])
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(last.numpy(), st, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("seq,groups", [(2, 1), (40, 1), (40, 2)])
def test_mamba_block_and_decode_match_jax(seq, groups):
    """mamba_block with its cache (a 2-token prompt pads the conv tail to
    K-1) and one mamba_decode step on it, at f32, on JAX's weights: the
    outputs, the conv tails and the states against JAX's; the step updates
    the port's cache in place."""
    tcfg, jcfg = _cfgs(MAMBA, ssm_groups=groups)
    jp = _seeded(_jinit(jssm.mamba_schema(jcfg), seed=2))
    tp = params_from_numpy(_np_tree(jp), device="cpu")
    rng = np.random.RandomState(7)
    x = rng.randn(B, seq, tcfg.d_model).astype(np.float32)
    x1 = rng.randn(B, 1, tcfg.d_model).astype(np.float32)
    jy, jc = jax.jit(lambda p, v: jssm.mamba_block(p, v, jcfg,
                                                   return_cache=True))(
        jp, jnp.asarray(x))
    ty, tc = ssm.mamba_block(tp, torch.from_numpy(x), tcfg,
                             return_cache=True)
    k1 = tcfg.ssm_conv_kernel - 1
    assert tuple(tc["conv"].shape) == (B, k1, jc["conv"].shape[-1])
    if seq < k1:
        assert not tc["conv"][:, :k1 - seq].any()
    for got, want in ((ty, jy), (tc["conv"], jc["conv"]),
                      (tc["state"], jc["state"])):
        assert _rel_err(_np(got), _np(want)) < 1e-5
    jo, jc = jax.jit(lambda p, v, c: jssm.mamba_decode(p, v, c, jcfg))(
        jp, jnp.asarray(x1), jc)
    conv, state = tc["conv"], tc["state"]
    to, tc = ssm.mamba_decode(tp, torch.from_numpy(x1), tc, tcfg)
    assert tc["conv"] is conv and tc["state"] is state
    for got, want in ((to, jo), (tc["conv"], jc["conv"]),
                      (tc["state"], jc["state"])):
        assert _rel_err(_np(got), _np(want)) < 1e-5


# ---------------------------------------------------------------------------
# whole model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("what", ["forward", "run_stack"])
@pytest.mark.parametrize("act", ["f32", "bf16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_model_matches_jax(arch, act, what, jax_side):
    tcfg, _ = _cfgs(arch, act)
    _, tp = jax_side.weights(arch)
    toks = _tokens(tcfg.vocab, (B, PROMPT), 3)
    logits, hidden = jax_side.model(arch, act, toks)
    batch = {"tokens": torch.from_numpy(toks)}
    if what == "forward":
        got, want = forward(tp, batch, tcfg), logits
    else:
        got = run_stack(tp["stack"], embed_inputs(tp, batch, tcfg), tcfg)
        want = hidden
    assert tuple(got.shape) == want.shape
    assert got.dtype == (torch.float32 if what == "forward"
                         else tcfg.act_dtype)
    assert _rel_err(_np(got), want) < (1e-4 if act == "f32" else 2e-2)


@pytest.mark.parametrize("act", ["f32", "bf16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_step_match_jax(arch, act, jax_side):
    """Logits and every cache leaf, by tree path, after prefill(32) + one
    decode step; kpos exactly."""
    tcfg, _ = _cfgs(arch, act)
    _, tp = jax_side.weights(arch)
    toks = _tokens(tcfg.vocab, (B, PROMPT + 1), 1)
    jl, jlen, jg, jc = jax_side.prefill_step(arch, act, toks)
    tl, tc, tlen = prefill(tp, {"tokens": torch.from_numpy(toks[:, :-1])},
                           tcfg, MAX_LEN)
    tol = 1e-4 if act == "f32" else 2e-2
    assert _rel_err(_np(tl), jl) < tol
    assert np.array_equal(tlen.numpy(), jlen)
    tg, tc = serve_step(tp, tc, torch.from_numpy(toks[:, -1:]), tlen, tcfg)
    assert tg.dtype == torch.float32 and tuple(tg.shape) == (B, tcfg.vocab)
    assert _rel_err(_np(tg), jg) < tol
    want, got = tree_paths(jc), tree_paths(tc)
    assert sorted(got) == sorted(want)
    for path, arr in want.items():
        assert tuple(got[path].shape) == arr.shape
        assert str(got[path].dtype).split(".")[-1] == arr.dtype.name
        if path.endswith("kpos"):
            np.testing.assert_array_equal(got[path].numpy(), arr)
        else:
            assert _rel_err(_np(got[path]), arr.astype(np.float32)) < tol
    if arch == ZAMBA:
        assert sorted(got) == sorted(
            [f"{s}/{leaf}" for s in ("segments", "tail")
             for leaf in ("conv", "state")]
            + [f"shared/{leaf}" for leaf in ("k", "kpos", "v")])
        assert (got["shared/kpos"][:, :, :PROMPT + 1].numpy()
                == np.arange(PROMPT + 1)).all()
    else:
        assert sorted(got) == ["layers/conv", "layers/state"]


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward(arch, jax_side):
    """prefill(L-1) + decode(1) logits == the full forward's last
    position."""
    tcfg, _ = _cfgs(arch)
    _, tp = jax_side.weights(arch)
    toks = torch.from_numpy(_tokens(tcfg.vocab, (B, PROMPT + 1), 1))
    full = forward(tp, {"tokens": toks}, tcfg)
    _, cache, lengths = prefill(tp, {"tokens": toks[:, :-1]}, tcfg, MAX_LEN)
    got, _ = serve_step(tp, cache, toks[:, -1:], lengths, tcfg)
    assert _rel_err(got.numpy(), full[:, -1].numpy()) < 2e-2


@pytest.mark.parametrize("arch", ARCHS)
def test_multi_token_decode_consistency(arch, jax_side):
    """Decoding 4 tokens step by step == forward on the extended
    sequence."""
    tcfg, _ = _cfgs(arch)
    _, tp = jax_side.weights(arch)
    l0, t = 17, 4
    toks = torch.from_numpy(_tokens(tcfg.vocab, (1, l0 + t), 2))
    full = forward(tp, {"tokens": toks}, tcfg)
    _, cache, lengths = prefill(tp, {"tokens": toks[:, :l0]}, tcfg, MAX_LEN)
    outs = []
    for i in range(t):
        lg, cache = serve_step(tp, cache, toks[:, l0 + i:l0 + i + 1],
                               lengths, tcfg)
        lengths = lengths + 1
        outs.append(lg)
    got = torch.stack(outs, dim=1)
    assert _rel_err(got.numpy(), full[:, l0:l0 + t].numpy()) < 3e-2


# ---------------------------------------------------------------------------
# continuous batching and the server CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_write_slot_lands_in_each_leafs_batch_axis(arch, jax_side):
    """A one-request cache written into slot 3 of a 4-slot cache (3 is
    not below zamba2's attn_every of 3): every leaf lands at its batch
    axis (2 for segments, 1 elsewhere), every other slot stays bit-equal."""
    tcfg, _ = _cfgs(arch)
    _, tp = jax_side.weights(arch)
    big = init_cache(tcfg, 4, 48, device="cpu")
    gen = torch.Generator().manual_seed(5)
    for leaf in tree_paths(big).values():
        leaf.copy_(torch.randint(-9, 9, leaf.shape, generator=gen)
                   .to(leaf.dtype))
    before = {p: t.clone() for p, t in tree_paths(big).items()}
    _, one, _ = prefill(tp, {"tokens": torch.from_numpy(
        _tokens(tcfg.vocab, (1, 9), 4))}, tcfg, 48)
    assert write_slot(big, 3, one, 9) is big
    after, ones = tree_paths(big), tree_paths(one)
    for path, leaf in after.items():
        axis = 2 if path.startswith("segments/") else 1
        assert leaf.shape[axis] == 4 and ones[path].shape[axis] == 1
        assert torch.equal(leaf.select(axis, 3),
                           ones[path].select(axis, 0).to(leaf.dtype))
        assert torch.equal(leaf.narrow(axis, 0, 3),
                           before[path].narrow(axis, 0, 3))


def test_zamba2_continuous_batcher_matches_jax_token_for_token(jax_side):
    """4 slots, 6 requests with prompts of 2-60 tokens, 5 new tokens each,
    greedy, at f32: the port's server path gives JAX's tokens. JAX's side
    writes each slot with an axis-correct write_slot of its own (the JAX
    CLI's writes axis 1 of zamba2's segments leaves, which is the layer)."""
    tcfg, jcfg = _cfgs(ZAMBA)
    jp, tp = jax_side.weights(ZAMBA)
    slots, s = 4, 72
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, tcfg.vocab, size=n).astype(np.int32)
               for n in (2, 60, 17, 3, 41, 29)]

    step_jit = jax.jit(lambda p, c, t, n: jserve_step(p, c, t, n, jcfg))
    prefill_jit = jax.jit(
        lambda p, bt: jprefill(p, bt, jcfg, s, last_only=True))

    def step_fn(cache, tokens, lengths):
        return step_jit(jp, cache, tokens, lengths)

    def prefill_fn(prompt):
        lg, c1, _ = prefill_jit(jp, {"tokens": jnp.asarray(prompt)})
        return lg, c1, prompt.shape[1]

    def jwrite_slot(cache, i, one, length):
        def put(axis):
            def f(big, o):
                idx = (slice(None),) * axis + (i,)
                return big.at[idx].set(o[(slice(None),) * axis + (0,)])
            return f
        return {key: jax.tree.map(put(2 if key == "segments" else 1),
                                  cache[key], one[key]) for key in cache}

    jbat = JBatcher(slots, step_fn, prefill_fn, jwrite_slot)
    jreqs = [JRequest(rid=r, prompt=p, max_new=5)
             for r, p in enumerate(prompts)]
    for r in jreqs:
        jbat.submit(r)
    jbat.run(jinit_cache(jcfg, slots, s))

    treqs, stats = launch_serve.serve_requests(
        tp, tcfg, prompts, slots=slots, max_len=s, max_new=5)
    assert all(r.done and len(r.out) == 5 for r in treqs)
    assert [r.out for r in treqs] == [[int(t) for t in r.out]
                                      for r in jreqs]
    assert stats["decode_steps"] == jbat.steps
    assert stats["tokens"] == 30 and stats["decode_tokens"] == 24


@pytest.mark.parametrize("arch", ARCHS)
def test_launch_serve_cli_on_cpu(arch):
    stats = launch_serve.main(["--arch", arch, "--smoke", "--device",
                               "cpu"])
    assert stats["requests"] == 8 and stats["tokens"] == 8 * 16
    assert stats["decode_tokens"] == 8 * 15
    assert stats["max_memory_allocated"] is None
