"""The port's LM stack (repro_torch.configs / models) against the JAX
package's, with JAX's weights carried over by ``params_from_numpy`` and the
same numpy inputs.

Tolerances: layer primitives rtol/atol 1e-5 at f32 (rope 1e-5 absolute:
sin/cos of fp32 angles); whole-model logits and hidden states within 1e-4
of their scale (max |ref|) at f32 activations (the sums of 32-layer-deep
products run in another order), and within 2e-2 of the scale at the
default bf16 activations (tests/test_serve.py:53's limit: the two
frameworks round bf16 at different places).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import get_smoke_config as jget_smoke
from repro.configs import list_archs as jlist_archs
from repro.models import forward as jforward
from repro.models import init_tree as jinit_tree
from repro.models import layers as jl
from repro.models import model_schema as jmodel_schema
from repro.models.model import embed_inputs as jembed_inputs
from repro.models.model import param_count as jparam_count
from repro.models.transformer import run_stack as jrun_stack
from repro_torch.configs import get_config, get_smoke_config, list_archs
from repro_torch.models import (
    cast_matrices,
    embed_inputs,
    forward,
    init_tree,
    model_schema,
    param_count,
    params_from_numpy,
    run_stack,
)
from repro_torch.models import layers as tl
from repro_torch.models.params import tree_paths

ARCH = "yi-6b"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _f32(cfg, jax_side: bool):
    dt = jnp.float32 if jax_side else torch.float32
    return dataclasses.replace(cfg, act_dtype=dt, cache_dtype=dt)


def _jax_params(cfg):
    return jinit_tree(jax.random.key(0), jmodel_schema(cfg))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _rel_err(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-9))


# ---------------------------------------------------------------------------
# layer primitives
# ---------------------------------------------------------------------------

def _layer_cases():
    rng = np.random.RandomState(0)
    x = rng.randn(2, 5, 16).astype(np.float32)
    w = rng.randn(16, 24).astype(np.float32)
    return {
        "rmsnorm": (lambda m, p, a: m.rmsnorm(p, a, eps=1e-5),
                    {"scale": rng.randn(16).astype(np.float32)}, x),
        "rmsnorm_plus_one": (
            lambda m, p, a: m.rmsnorm(p, a, scale_plus_one=True),
            {"scale": rng.randn(16).astype(np.float32)}, x),
        "layernorm": (lambda m, p, a: m.layernorm(p, a),
                      {"scale": rng.randn(16).astype(np.float32),
                       "bias": rng.randn(16).astype(np.float32)}, x),
        "dense": (lambda m, p, a: m.dense(p, a),
                  {"w": w, "b": rng.randn(24).astype(np.float32)}, x),
        "glu": (lambda m, p, a: m.glu(p, a),
                {"gate": w, "up": rng.randn(16, 24).astype(np.float32),
                 "down": rng.randn(24, 16).astype(np.float32)}, x),
        "mlp_gelu": (lambda m, p, a: m.mlp(p, a),
                     {"up": {"w": w}, "down": {
                         "w": rng.randn(24, 16).astype(np.float32)}}, x),
        "output_head": (
            lambda m, p, a: (m.unembed(p, a) if m is jl
                             else m.matmul_f32(a, p["table"])),
            {"table": rng.randn(40, 16).astype(np.float32)}, x),
        "softcap": (lambda m, p, a: m.softcap(a * 30.0, 20.0), {}, x),
    }


@pytest.mark.parametrize("name", sorted(_layer_cases()))
def test_layer_primitive_matches_jax(name):
    fn, p, x = _layer_cases()[name]
    want = np.asarray(fn(jl, jax.tree.map(jnp.asarray, p), jnp.asarray(x)))
    got = fn(tl, jax.tree.map(torch.from_numpy, p), torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_rope_and_embed_match_jax(dtype):
    rng = np.random.RandomState(1)
    x = rng.randn(2, 7, 3, 16).astype(np.float32)
    pos = np.array([[0, 1, 2, 3, 4, 5, 6], [9, 10, 11, 40, 41, 42, 43]])
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "f32" \
        else (jnp.bfloat16, torch.bfloat16)
    want = jl.apply_rope(jnp.asarray(x).astype(jdt), jnp.asarray(pos),
                         theta=5e6)
    got = tl.apply_rope(torch.from_numpy(x).to(tdt), torch.from_numpy(pos),
                        theta=5e6)
    tol = 1e-5 if dtype == "f32" else 1e-2
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=tol, atol=tol)
    table = rng.randn(50, 8).astype(np.float32)
    toks = rng.randint(0, 50, size=(3, 4))
    want = jl.embed({"table": jnp.asarray(table)}, jnp.asarray(toks), jdt)
    got = tl.embed({"table": torch.from_numpy(table)},
                   torch.from_numpy(toks), tdt)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


# ---------------------------------------------------------------------------
# configs, schema, parameters
# ---------------------------------------------------------------------------

def test_configs_match_jax_value_for_value():
    # every architecture of the JAX package is registered
    assert list_archs() == jlist_archs() == [
        "codeqwen1.5-7b", "deepseek-v2-lite-16b", "gemma2-27b",
        "granite-moe-3b-a800m", "hubert-xlarge", "internvl2-1b",
        "mamba2-130m", "starcoder2-3b", ARCH, "zamba2-1.2b"]
    for ours, theirs in ((get_config(ARCH), jget_config(ARCH)),
                         (get_smoke_config(ARCH), jget_smoke(ARCH))):
        a, b = dataclasses.asdict(ours), dataclasses.asdict(theirs)
        for key in ("param_dtype", "act_dtype", "cache_dtype"):
            assert str(a.pop(key)).split(".")[-1] == \
                jnp.dtype(b.pop(key)).name
        assert a == b


@pytest.mark.parametrize("full", [True, False])
def test_param_count_matches_jax(full):
    cfg = get_config(ARCH) if full else get_smoke_config(ARCH)
    jcfg = jget_config(ARCH) if full else jget_smoke(ARCH)
    assert param_count(cfg) == jparam_count(jcfg)
    if full:
        assert param_count(cfg) == 6_061_035_520


def test_params_from_numpy_round_trips_every_leaf():
    cfg = get_smoke_config(ARCH)
    jp = _np_tree(_jax_params(jget_smoke(ARCH)))
    tp = params_from_numpy(jp, device="cpu")
    want = tree_paths(jp)
    got = tree_paths(tp)
    assert sorted(got) == sorted(want)
    schema = tree_paths(model_schema(cfg))
    assert sorted(schema) == sorted(want)
    for path, arr in want.items():
        assert tuple(got[path].shape) == arr.shape == schema[path].shape
        np.testing.assert_array_equal(got[path].numpy(), arr)
    # bf16 leaves carry their bits
    jb = np.asarray(jnp.asarray([1.5, -2.25, 3e-3], jnp.bfloat16))
    tb = params_from_numpy({"a": jb}, device="cpu")["a"]
    assert tb.dtype == torch.bfloat16
    np.testing.assert_array_equal(tb.float().numpy(), jb.astype(np.float32))


def test_init_tree_follows_the_schema():
    cfg = get_smoke_config(ARCH)
    schema = model_schema(cfg)
    p = init_tree(torch.Generator().manual_seed(0), schema)
    q = init_tree(torch.Generator().manual_seed(0), schema)
    for path, d in tree_paths(schema).items():
        t = tree_paths(p)[path]
        assert tuple(t.shape) == d.shape and t.dtype == d.dtype
        assert torch.equal(t, tree_paths(q)[path])
    assert torch.equal(tree_paths(p)["final_norm/scale"],
                       torch.ones(cfg.d_model))


# ---------------------------------------------------------------------------
# whole model
# ---------------------------------------------------------------------------

def _tokens(cfg, b=2, seq=37, seed=3):
    return np.random.RandomState(seed).randint(0, cfg.vocab, size=(b, seq))


@pytest.mark.parametrize("what", ["forward", "run_stack"])
@pytest.mark.parametrize("act", ["f32", "bf16"])
def test_model_matches_jax(what, act):
    tcfg, jcfg = get_smoke_config(ARCH), jget_smoke(ARCH)
    if act == "f32":
        tcfg, jcfg = _f32(tcfg, False), _f32(jcfg, True)
    jp = _jax_params(jcfg)
    tp = params_from_numpy(_np_tree(jp), device="cpu")
    toks = _tokens(tcfg)
    if what == "forward":
        want = jax.jit(lambda p, b: jforward(p, b, jcfg))(
            jp, {"tokens": jnp.asarray(toks)})
        got = forward(tp, {"tokens": torch.from_numpy(toks)}, tcfg)
    else:
        want = jax.jit(lambda p, b: jrun_stack(
            p["stack"], jembed_inputs(p, b, jcfg), jcfg))(
            jp, {"tokens": jnp.asarray(toks)})
        got = run_stack(tp["stack"], embed_inputs(
            tp, {"tokens": torch.from_numpy(toks)}, tcfg), tcfg)
    want = np.asarray(want.astype(jnp.float32))
    assert got.shape == want.shape
    assert got.dtype == (torch.float32 if what == "forward"
                         else tcfg.act_dtype)
    assert _rel_err(got.float().numpy(), want) < \
        (1e-4 if act == "f32" else 2e-2)


def test_local_window_stack_matches_jax():
    """The all-local layer pattern (banded chunked attention) at f32."""
    tcfg = dataclasses.replace(_f32(get_smoke_config(ARCH), False),
                               window=16, layer_pattern="local")
    jcfg = dataclasses.replace(_f32(jget_smoke(ARCH), True), window=16,
                               layer_pattern="local")
    jp = _jax_params(jcfg)
    tp = params_from_numpy(_np_tree(jp), device="cpu")
    toks = _tokens(tcfg, seq=150)
    want = np.asarray(jax.jit(lambda p, b: jforward(p, b, jcfg))(
        jp, {"tokens": jnp.asarray(toks)}))
    got = forward(tp, {"tokens": torch.from_numpy(toks)}, tcfg)
    assert _rel_err(got.numpy(), want) < 1e-4


def test_cast_matrices_changes_no_number():
    """Casting the matrices once at load gives the logits that casting
    them at every use gives; norm scales stay fp32."""
    cfg = get_smoke_config(ARCH)
    schema = model_schema(cfg)
    p = init_tree(torch.Generator().manual_seed(1), schema)
    c = cast_matrices(p, schema, cfg.act_dtype)
    paths = tree_paths(c)
    assert paths["stack/layers/attn/wq"].dtype == torch.bfloat16
    assert paths["lm_head/w"].dtype == torch.bfloat16
    assert paths["stack/layers/norm1/scale"].dtype == torch.float32
    toks = torch.from_numpy(_tokens(cfg))
    assert torch.equal(forward(p, {"tokens": toks}, cfg),
                       forward(c, {"tokens": toks}, cfg))
