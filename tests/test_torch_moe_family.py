"""The MoE family on the port (deepseek-v2-lite-16b's MLA latent attention
and weight-absorbed decode with its first-k-dense + MoE stack, and
granite-moe-3b-a800m's GQA + MoE stack with renormalised gates and the
granite multipliers) against the JAX package, at the smoke configs, with
JAX's weights carried over by ``params_from_numpy`` and the same numpy
inputs.

The JAX side of the model-level comparisons is computed once per module
(the ``jax_side`` fixture memoises it by architecture and dtype).

Tolerances: the MoE routing (each token's experts, each expert's kept
tokens and which slots are filled) exactly, at f32; the MoE output,
logits, hidden states, attention outputs and cache leaves within 1e-4 of
their scale (max |ref|) at f32 activations and caches, 2e-2 at the
default bf16 (tests/test_serve.py:53's limit); decode-equals-forward
within 2e-2 and multi-token decode within 3e-2 of the scale against the
port's own forward, as tests/test_serve.py:32-108 holds JAX's; greedy
tokens, kpos tags and tree paths exactly.
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
from repro.models import attention as jattn
from repro.models import forward as jforward
from repro.models import init_tree as jinit_tree
from repro.models import model_schema as jmodel_schema
from repro.models import moe as jmoe
from repro.models.model import embed_inputs as jembed_inputs
from repro.models.model import param_count as jparam_count
from repro.models.transformer import run_stack as jrun_stack
from repro.serve import ContinuousBatcher as JBatcher
from repro.serve import Request as JRequest
from repro.serve import init_cache as jinit_cache
from repro.serve import prefill as jprefill
from repro.serve import serve_step as jserve_step
from repro.serve.decode import _seed_mla as jseed_mla
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
)
from repro_torch.models import attention as tattn
from repro_torch.models import moe as tmoe
from repro_torch.models.params import tree_leaves, tree_paths
from repro_torch.serve import prefill, serve_step
from repro_torch.serve.decode import _seed_mla, cache_schema

DEEPSEEK, GRANITE = "deepseek-v2-lite-16b", "granite-moe-3b-a800m"
ARCHS = (DEEPSEEK, GRANITE)
B, PROMPT, MAX_LEN = 2, 32, 96       # prefill(32) + one step


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


def _step_cfgs(arch, act):
    """The configs of the prefill + step comparison. deepseek's MLA decode
    asks XLA for a bf16 x bf16 -> f32 product, which XLA's CPU backend
    does not implement, so at bf16 activations both packages keep an f32
    cache there (the bf16 cache runs on the card: tests/test_torch_gpu.py
    and chip_smoke.py's lm_check)."""
    if arch == DEEPSEEK and act == "bf16":
        return _cfgs(arch, act, cache_dtype=torch.float32)
    return _cfgs(arch, act)


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


class JaxSide:
    """The JAX package's weights and outputs, each computed on first use."""

    def __init__(self):
        self._memo = {}

    def _get(self, key, make):
        if key not in self._memo:
            self._memo[key] = make()
        return self._memo[key]

    def weights(self, arch, act):
        """(JAX params, the port's copy of them)."""
        def make():
            jp = jinit_tree(jax.random.key(0), jmodel_schema(
                _cfgs(arch, act)[1]))
            return jp, params_from_numpy(_np_tree(jp), device="cpu")
        return self._get(("weights", arch, act), make)

    def model(self, arch, act, toks):
        """forward's logits and run_stack's hidden states of ``toks``."""
        def make():
            jcfg = _cfgs(arch, act)[1]
            jp, _ = self.weights(arch, act)
            batch = {"tokens": jnp.asarray(toks)}
            logits = jax.jit(lambda p, b: jforward(p, b, jcfg))(jp, batch)
            hidden = jax.jit(lambda p, b: jrun_stack(
                p["stack"], jembed_inputs(p, b, jcfg), jcfg))(jp, batch)
            return _np(logits), _np(hidden)
        return self._get(("model", arch, act), make)

    def prefill_step(self, arch, act, toks):
        """prefill(toks[:, :-1]) and one serve_step of toks[:, -1:]."""
        def make():
            jcfg = _step_cfgs(arch, act)[1]
            jp, _ = self.weights(arch, act)
            jl, jc, jlen = jax.jit(lambda p, b: jprefill(p, b, jcfg, MAX_LEN))(
                jp, {"tokens": jnp.asarray(toks[:, :-1])})
            jg, jc = jax.jit(lambda p, c, t, n: jserve_step(p, c, t, n, jcfg))(
                jp, jc, jnp.asarray(toks[:, -1:]), jlen)
            return _np(jl), np.asarray(jlen), _np(jg), _np_tree(jc)
        return self._get(("prefill_step", arch, act), make)


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
    assert param_count(cfg) == jparam_count(jcfg)
    assert active_param_count(cfg) == jactive_param_count(jcfg)
    assert active_param_count(cfg) < param_count(cfg)
    if full:
        lo, hi = {DEEPSEEK: (14e9, 17e9),                # tests/test_models.py
                  GRANITE: (2.8e9, 3.8e9)}[arch]         # :168-169
        assert lo < param_count(cfg) < hi


@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_numpy_round_trips_every_leaf(arch, jax_side):
    jp, tp = jax_side.weights(arch, "f32")
    want, got = tree_paths(_np_tree(jp)), tree_paths(tp)
    schema = tree_paths(model_schema(_cfgs(arch)[0]))
    assert sorted(got) == sorted(want) == sorted(schema)
    cfg = get_smoke_config(arch)
    if arch == DEEPSEEK:
        assert "stack/dense_layers/attn/wkv_b" in got
        assert "stack/dense_layers/ffn/gate" in got
        assert "stack/layers/ffn/shared/down" in got
        assert got["stack/dense_layers/ffn/gate"].shape == (
            1, cfg.d_model, cfg.dense_d_ff)
    else:
        assert not any(p.startswith("stack/dense_layers") for p in got)
        assert "stack/layers/attn/wk" in got
        assert not any("shared" in p for p in got)
    assert got["stack/layers/ffn/gate"].shape == (
        cfg.n_layers - cfg.first_k_dense, cfg.n_experts, cfg.d_model,
        cfg.moe_d_ff)
    for path, arr in want.items():
        assert tuple(got[path].shape) == arr.shape == schema[path].shape
        np.testing.assert_array_equal(got[path].numpy(), arr)


# ---------------------------------------------------------------------------
# the MoE layer
# ---------------------------------------------------------------------------

def _jax_route(p, xf, cfg):
    """JAX's moe_ffn routing (src/repro/models/moe.py:72-91), step for
    step: each token's experts, each expert's top-C gates and tokens."""
    logits = (xf @ p["router"].astype(xf.dtype)).astype(jnp.float32)
    if cfg.moe_score == "sigmoid":
        scores = jax.nn.sigmoid(logits)
    else:
        scores = jax.nn.softmax(logits, axis=-1)
    top_val, top_idx = jax.lax.top_k(scores, cfg.moe_top_k)
    if cfg.moe_norm_topk:
        top_val = top_val / jnp.maximum(
            jnp.sum(top_val, axis=-1, keepdims=True), 1e-20)
    top_val = top_val * cfg.moe_routed_scale
    t = xf.shape[0]
    sel = jnp.zeros((t, cfg.n_experts), jnp.float32)
    sel = sel.at[jnp.arange(t)[:, None], top_idx].max(top_val)
    score_e = jnp.where(sel > 0, sel, -jnp.inf).T
    top_c_val, top_c_idx = jax.lax.top_k(score_e, jmoe.moe_capacity(cfg, t))
    return (np.asarray(top_idx), np.asarray(top_c_val),
            np.asarray(top_c_idx), np.isfinite(np.asarray(top_c_val)))


def _moe_inputs(case, cfg, jp, t):
    rng = np.random.RandomState(5)
    if case == "ties":
        # three distinct rows repeated 300 / 150 / 62 times, shuffled: the
        # experts the 300 copies choose get more tied picks than C = 256
        rows = rng.randn(3, cfg.d_model)
        x = rows[rng.permutation(np.repeat([0, 1, 2], [300, 150, 62]))]
    else:
        x = rng.randn(t, cfg.d_model)
        if case == "overflow":
            # a shared offset along expert 0's router column, so that
            # expert is chosen by more tokens than C
            w = np.asarray(jp["router"])[:, 0]
            x = x + 15.0 * w / np.linalg.norm(w)
    return x.astype(np.float32)


MOE_CASES = {
    "softmax": (DEEPSEEK, {}),
    "sigmoid": (DEEPSEEK, dict(moe_score="sigmoid")),
    "norm_topk": (DEEPSEEK, dict(moe_norm_topk=True)),
    "sigmoid_norm_scaled": (DEEPSEEK, dict(moe_score="sigmoid",
                                           moe_norm_topk=True,
                                           moe_routed_scale=2.5)),
    "no_shared": (DEEPSEEK, dict(n_shared_experts=0)),
    "granite": (GRANITE, {}),
    "overflow": (DEEPSEEK, {}),
    "ties": (DEEPSEEK, {}),
}


@pytest.mark.parametrize("case", sorted(MOE_CASES))
def test_moe_ffn_matches_jax(case):
    """moe_ffn at f32 on JAX's moe weights: the routing exactly (each
    token's experts in order, each expert's filled slots, kept tokens and
    gates), the output within 1e-4 of its scale. At T = 512 ("overflow",
    "ties") an expert is over capacity, so JAX drops tokens: the port
    drops the same ones (in "ties", tied rows straddle the C-th slot and
    the lower index is kept)."""
    arch, change = MOE_CASES[case]
    tcfg, jcfg = _cfgs(arch, **change)
    big = case in ("overflow", "ties")
    t = 512 if big else 96
    jp = jinit_tree(jax.random.key(3), jmoe.moe_schema(jcfg))
    tp = params_from_numpy(_np_tree(jp), device="cpu")
    assert sorted(tree_paths(tp)) == sorted(tree_paths(
        tmoe.moe_schema(tcfg)))
    x = _moe_inputs(case, tcfg, jp, t)
    want = _jax_route(jp, jnp.asarray(x), jcfg)
    got = [a.numpy() for a in tmoe.route(tp, torch.from_numpy(x), tcfg)]
    np.testing.assert_array_equal(got[0], want[0])          # token experts
    np.testing.assert_array_equal(got[3], want[3])          # filled slots
    ok = want[3]
    np.testing.assert_array_equal(got[2][ok], want[2][ok])  # kept tokens
    np.testing.assert_allclose(got[1][ok], want[1][ok], rtol=0,
                               atol=1e-6)         # gates: fp32 sums
    picks = np.bincount(want[0].ravel(), minlength=jcfg.n_experts)
    c = jmoe.moe_capacity(jcfg, t)
    assert tmoe.moe_capacity(tcfg, t) == c
    if big:
        assert c == 256 and picks.max() > c         # JAX dropped tokens
        assert ok.sum() < t * jcfg.moe_top_k
    else:
        assert c == t and ok.sum() == t * jcfg.moe_top_k
    if case == "ties":
        e = int(picks.argmax())
        kept = want[2][e][ok[e]]
        assert len(kept) == c and (np.diff(kept[-40:]) > 0).all()
    xb = x.reshape(2, t // 2, -1)
    ref = _np(jmoe.moe_ffn(jp, jnp.asarray(xb), jcfg))
    out = tmoe.moe_ffn(tp, torch.from_numpy(xb), tcfg)
    assert _rel_err(_np(out), ref) < 1e-4


# ---------------------------------------------------------------------------
# MLA
# ---------------------------------------------------------------------------

def _layer0(tree):
    return jax.tree.map(lambda a: a[0], tree)


def test_mla_attention_and_decode_match_jax(jax_side):
    """Layer 0's MLA at f32 on JAX's weights: the prefill output and its
    latent (c_kv, the rope-applied shared key) within 1e-4 of JAX's; then
    the weight-absorbed decode of one more token against the seeded cache:
    its output and every cache leaf within 1e-4, kpos exactly."""
    tcfg, jcfg = _cfgs(DEEPSEEK)
    jp, tp = jax_side.weights(DEEPSEEK, "f32")
    ja = _layer0(jp["stack"]["dense_layers"]["attn"])
    ta = {k: v[0] for k, v in tp["stack"]["dense_layers"]["attn"].items()}
    rng = np.random.RandomState(6)
    x = rng.randn(B, 40, tcfg.d_model).astype(np.float32)
    x1 = rng.randn(B, 1, tcfg.d_model).astype(np.float32)
    jy, (jckv, jkr) = jattn.mla_attention(ja, jnp.asarray(x), jcfg,
                                          return_latent=True)
    ty, (tckv, tkr) = tattn.mla_attention(ta, torch.from_numpy(x), tcfg,
                                          return_latent=True)
    assert tuple(tckv.shape) == (B, 40, tcfg.kv_lora_rank)
    assert tuple(tkr.shape) == (B, 40, tcfg.qk_rope_dim)
    for got, want in ((ty, jy), (tckv, jckv), (tkr, jkr)):
        assert _rel_err(_np(got), _np(want)) < 1e-4

    jc = jseed_mla(jcfg, jckv, jkr, 64)
    tc = _seed_mla(tcfg, tckv, tkr, 64)
    lengths = np.array([40, 40], np.int32)
    jo, jc = jattn.mla_decode(ja, jnp.asarray(x1), jc, jnp.asarray(lengths),
                              jcfg)
    to, tc = tattn.mla_decode(ta, torch.from_numpy(x1), tc,
                              torch.from_numpy(lengths), tcfg)
    assert _rel_err(_np(to), _np(jo)) < 1e-4
    np.testing.assert_array_equal(tc["kpos"].numpy(), np.asarray(jc["kpos"]))
    for key in ("ckv", "krope"):
        assert _rel_err(_np(tc[key]), _np(jc[key])) < 1e-4


# ---------------------------------------------------------------------------
# whole model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("what", ["forward", "run_stack"])
@pytest.mark.parametrize("act", ["f32", "bf16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_model_matches_jax(arch, act, what, jax_side):
    tcfg, _ = _cfgs(arch, act)
    _, tp = jax_side.weights(arch, act)
    toks = _tokens(tcfg.vocab, (2, 37), 3)
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


# ---------------------------------------------------------------------------
# prefill / decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("act", ["f32", "bf16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_step_match_jax(arch, act, jax_side):
    """Logits and every cache leaf, by tree path, after prefill(32) + one
    decode step; kpos exactly."""
    tcfg, _ = _step_cfgs(arch, act)
    _, tp = jax_side.weights(arch, act)
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
        if path.endswith("kpos"):
            np.testing.assert_array_equal(got[path].numpy(), arr)
        else:
            assert _rel_err(_np(got[path]), arr.astype(np.float32)) < tol
    n_moe = tcfg.n_layers - tcfg.first_k_dense
    if arch == DEEPSEEK:
        assert sorted(got) == [f"{s}/{leaf}" for s in ("dense_layers",
                                                        "layers")
                               for leaf in ("ckv", "kpos", "krope")]
        assert got["layers/ckv"].shape == (n_moe, B, MAX_LEN,
                                           tcfg.kv_lora_rank)
        assert (got["dense_layers/kpos"][:, :, :PROMPT + 1].numpy()
                == np.arange(PROMPT + 1)).all()
    else:
        assert got["layers/k"].shape == (n_moe, B, MAX_LEN,
                                         tcfg.n_kv_heads, tcfg.d_head)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward(arch, jax_side):
    """prefill(L-1) + decode(1) logits == the full forward's last
    position."""
    tcfg, _ = _cfgs(arch)
    _, tp = jax_side.weights(arch, "f32")
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
    _, tp = jax_side.weights(arch, "f32")
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


def test_mla_cache_is_latent_sized():
    """deepseek-v2's decode cache stores the compressed latent and the
    shared rope key, not per-head K/V (tests/test_serve.py:111-126): per
    token, exactly n_layers x (kv_lora_rank + qk_rope_dim) values in the
    cache dtype, plus the int32 kpos tags."""
    cfg = get_smoke_config(DEEPSEEK)
    sch = cache_schema(cfg, batch=4, max_len=32)
    per_tok = sum(np.prod(d.shape) / (4 * 32) * d.dtype.itemsize
                  for d in tree_leaves(sch))
    full_kv = (cfg.n_layers * cfg.n_kv_heads * (cfg.qk_nope_dim
               + cfg.qk_rope_dim + cfg.v_head_dim) * 2)
    latent = cfg.n_layers * (cfg.kv_lora_rank + cfg.qk_rope_dim) * 2
    assert per_tok < full_kv * 2 / 3
    assert per_tok < latent * 3
    assert per_tok == latent + cfg.n_layers * 4


# ---------------------------------------------------------------------------
# continuous batching and the server CLI
# ---------------------------------------------------------------------------

def test_deepseek_continuous_batcher_matches_jax_token_for_token(jax_side):
    """3 slots, 5 requests with prompts of 8-60 tokens, 5 new tokens each,
    greedy, at f32: the port's server path gives JAX's tokens."""
    tcfg, jcfg = _cfgs(DEEPSEEK)
    jp, tp = jax_side.weights(DEEPSEEK, "f32")
    slots, s = 3, 96
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, tcfg.vocab, size=n).astype(np.int32)
               for n in rng.randint(8, 61, size=5)]

    step_jit = jax.jit(lambda p, c, t, n: jserve_step(p, c, t, n, jcfg))
    prefill_jit = jax.jit(
        lambda p, bt: jprefill(p, bt, jcfg, s, last_only=True))

    def step_fn(cache, tokens, lengths):
        return step_jit(jp, cache, tokens, lengths)

    def prefill_fn(prompt):
        lg, c1, _ = prefill_jit(jp, {"tokens": jnp.asarray(prompt)})
        return lg, c1, prompt.shape[1]

    def write_slot(cache, i, one, length):
        return jax.tree.map(lambda big, o: big.at[:, i].set(o[:, 0]),
                            cache, one)

    jbat = JBatcher(slots, step_fn, prefill_fn, write_slot)
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
    assert stats["tokens"] == 25 and stats["decode_tokens"] == 20


@pytest.mark.parametrize("arch", ARCHS)
def test_launch_serve_cli_on_cpu(arch):
    stats = launch_serve.main(["--arch", arch, "--smoke", "--device",
                               "cpu"])
    assert stats["requests"] == 8 and stats["tokens"] == 8 * 16
    assert stats["decode_tokens"] == 8 * 15
    assert stats["max_memory_allocated"] is None
