"""The rest of the dense family on the port (gemma2-27b's local/global
pairs with their mixed ring + linear decode cache, starcoder2-3b's
LayerNorm, biased MLP and all-local window, codeqwen1.5-7b's q/k/v biases
and full MHA) against the JAX package, at the smoke configs, with JAX's
weights carried over by ``params_from_numpy`` and the same numpy tokens.

The JAX side of every comparison is computed once per module (the
``jax_side`` fixture memoises it by architecture and dtype).

Tolerances: logits, hidden states and cache leaves within 1e-4 of their
scale (max |ref|) at f32 activations and caches, 2e-2 at the default bf16
(tests/test_serve.py:53's limit); decode-equals-forward within 2e-2 and
the multi-token and ring cases within 3e-2 of the scale against the
port's own forward, as tests/test_serve.py:32-116 holds JAX's; greedy
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
from repro.models import forward as jforward
from repro.models import init_tree as jinit_tree
from repro.models import model_schema as jmodel_schema
from repro.models.model import embed_inputs as jembed_inputs
from repro.models.model import param_count as jparam_count
from repro.models.transformer import run_stack as jrun_stack
from repro.serve import ContinuousBatcher as JBatcher
from repro.serve import Request as JRequest
from repro.serve import init_cache as jinit_cache
from repro.serve import prefill as jprefill
from repro.serve import serve_step as jserve_step
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.launch import serve as launch_serve
from repro_torch.models import (
    embed_inputs,
    forward,
    model_schema,
    param_count,
    params_from_numpy,
    run_stack,
)
from repro_torch.models.params import tree_paths
from repro_torch.serve import prefill, serve_step
from repro_torch.serve.decode import decode_hidden

ARCHS = ("gemma2-27b", "starcoder2-3b", "codeqwen1.5-7b")
GEMMA = "gemma2-27b"
B, PROMPT, MAX_LEN = 2, 32, 96       # prefill(32) + one step; gemma2's
                                     # local rings hold 64 of the 96 slots


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
            jcfg = _cfgs(arch, act)[1]
            jp, _ = self.weights(arch, act)
            jl, jc, jlen = jax.jit(lambda p, b: jprefill(p, b, jcfg, MAX_LEN))(
                jp, {"tokens": jnp.asarray(toks[:, :-1])})
            jg, jc = jax.jit(lambda p, c, t, n: jserve_step(p, c, t, n, jcfg))(
                jp, jc, jnp.asarray(toks[:, -1:]), jlen)
            return _np(jl), np.asarray(jlen), _np(jg), _np_tree(jc)
        return self._get(("prefill_step", arch, act), make)

    def decode_run(self, arch, toks, l0, max_len):
        """prefill(toks[:, :l0]), then serve_step over the rest at f32:
        the last step's logits and the final cache."""
        def make():
            jcfg = _cfgs(arch)[1]
            jp, _ = self.weights(arch, "f32")
            _, jc, jlen = jax.jit(lambda p, b: jprefill(p, b, jcfg, max_len))(
                jp, {"tokens": jnp.asarray(toks[:, :l0])})
            step = jax.jit(lambda p, c, t, n: jserve_step(p, c, t, n, jcfg))
            for i in range(l0, toks.shape[1]):
                jg, jc = step(jp, jc, jnp.asarray(toks[:, i:i + 1]), jlen)
                jlen = jlen + 1
            return _np(jg), _np_tree(jc)
        return self._get(("decode_run", arch, l0, max_len), make)


@pytest.fixture(scope="module")
def jax_side():
    return JaxSide()


# ---------------------------------------------------------------------------
# configs, schema, parameters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_jax_value_for_value(arch):
    for ours, theirs in ((get_config(arch), jget_config(arch)),
                         (get_smoke_config(arch), jget_smoke(arch))):
        a, b = dataclasses.asdict(ours), dataclasses.asdict(theirs)
        for key in ("param_dtype", "act_dtype", "cache_dtype"):
            assert str(a.pop(key)).split(".")[-1] == \
                jnp.dtype(b.pop(key)).name
        assert a == b


@pytest.mark.parametrize("full", [True, False])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_count_matches_jax(arch, full):
    cfg = get_config(arch) if full else get_smoke_config(arch)
    jcfg = jget_config(arch) if full else jget_smoke(arch)
    assert param_count(cfg) == jparam_count(jcfg)
    if full and arch == GEMMA:
        assert 26e9 < param_count(cfg) < 29e9      # tests/test_models.py:163


def test_gemma2_params_from_numpy_round_trips_every_leaf(jax_side):
    jp, tp = jax_side.weights(GEMMA, "f32")
    want, got = tree_paths(_np_tree(jp)), tree_paths(tp)
    schema = tree_paths(model_schema(_cfgs(GEMMA)[0]))
    assert sorted(got) == sorted(want) == sorted(schema)
    assert "stack/pairs/local/attn/wq" in got
    assert "stack/pairs/global/norm_post_ffn/scale" in got
    n_pairs = get_smoke_config(GEMMA).n_layers // 2
    for path, arr in want.items():
        assert tuple(got[path].shape) == arr.shape == schema[path].shape
        if path.startswith("stack/"):
            assert arr.shape[0] == n_pairs
        np.testing.assert_array_equal(got[path].numpy(), arr)


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
    tcfg, _ = _cfgs(arch, act)
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
    if arch == GEMMA:
        n = tcfg.n_layers // 2
        assert got["pairs/local/k"].shape[:3] == (n, B, tcfg.window)
        assert got["pairs/global/v"].shape[:3] == (n, B, MAX_LEN)


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


@pytest.mark.parametrize("arch", [GEMMA, "starcoder2-3b"])
def test_ring_caches_wrap_like_jax(arch, jax_side):
    """An 80-token prompt, past the smoke window of 64, then 24 decode
    steps: every local ring wraps at prefill and again while decoding, in
    both packages. The kpos tags of every layer (each of gemma2's pairs:
    the ring's last 64 positions at pos % 64, the linear cache's 0..L-1
    then -1) equal JAX's, the last logits are within 1e-4 of JAX's and
    within 3e-2 of the port's own forward."""
    tcfg, _ = _cfgs(arch)
    _, tp = jax_side.weights(arch, "f32")
    l0, t, s = 80, 24, 128
    toks = _tokens(tcfg.vocab, (1, l0 + t), 4)
    jg, jc = jax_side.decode_run(arch, toks, l0, s)
    _, tc, tlen = prefill(tp, {"tokens": torch.from_numpy(toks[:, :l0])},
                          tcfg, s)
    for i in range(l0, l0 + t):
        tg, tc = serve_step(tp, tc, torch.from_numpy(toks[:, i:i + 1]),
                            tlen, tcfg)
        tlen = tlen + 1
    full = forward(tp, {"tokens": torch.from_numpy(toks)}, tcfg)
    assert _rel_err(tg.numpy(), full[:, -1].numpy()) < 3e-2
    assert _rel_err(tg.numpy(), jg) < 1e-4
    want, got = tree_paths(jc), tree_paths(tc)
    kpos = [p for p in want if p.endswith("kpos")]
    assert kpos
    for path in kpos:
        np.testing.assert_array_equal(got[path].numpy(), want[path])
    w, n = tcfg.window, l0 + t
    ring = np.full(w, -1)
    ring[np.arange(n - w, n) % w] = np.arange(n - w, n)
    local = got["pairs/local/kpos" if arch == GEMMA else "layers/kpos"]
    assert (local.numpy() == ring).all()
    if arch == GEMMA:
        linear = np.where(np.arange(s) < n, np.arange(s), -1)
        assert (got["pairs/global/kpos"].numpy() == linear).all()


def test_gemma2_decode_hidden_matches_jax_run_stack(jax_side):
    """decode_hidden at the new position == JAX's run_stack over the
    longer sequence at that position (the kNN-LM's key space)."""
    tcfg, _ = _cfgs(GEMMA)
    _, tp = jax_side.weights(GEMMA, "f32")
    toks = _tokens(tcfg.vocab, (2, 37), 3)
    _, hidden = jax_side.model(GEMMA, "f32", toks)
    _, cache, lengths = prefill(
        tp, {"tokens": torch.from_numpy(toks[:, :-1])}, tcfg, MAX_LEN)
    got, cache = decode_hidden(tp, cache, torch.from_numpy(toks[:, -1:]),
                               lengths, tcfg)
    assert tuple(got.shape) == (2, 1, tcfg.d_model)
    assert _rel_err(got[:, 0].numpy(), hidden[:, -1]) < 1e-4
    assert (cache["pairs"]["global"]["kpos"][:, :, 36] == 36).all()


# ---------------------------------------------------------------------------
# continuous batching and the server CLI
# ---------------------------------------------------------------------------

def test_gemma2_continuous_batcher_matches_jax_token_for_token(jax_side):
    """3 slots, 5 requests with prompts of 8-80 tokens (some past the
    window, so their local rings wrap at prefill), 5 new tokens each,
    greedy, at f32: the port's server path gives JAX's tokens."""
    tcfg, jcfg = _cfgs(GEMMA)
    jp, tp = jax_side.weights(GEMMA, "f32")
    slots, s = 3, 128
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, tcfg.vocab, size=n).astype(np.int32)
               for n in rng.randint(8, 81, size=5)]
    assert max(len(p) for p in prompts) > tcfg.window

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


def test_gemma2_launch_serve_cli_on_cpu():
    stats = launch_serve.main(["--arch", GEMMA, "--smoke", "--device",
                               "cpu"])
    assert stats["requests"] == 8 and stats["tokens"] == 8 * 16
    assert stats["decode_tokens"] == 8 * 15
    assert stats["max_memory_allocated"] is None
