"""The port's training objective (``models.model.loss_fn``) and its
gradients against ``jax.value_and_grad`` of the JAX package's, one
smoke config of each stack kind: yi-6b (dense), gemma2-27b (local and
global layers, softcaps), deepseek-v2-lite-16b (MLA and MoE: the router
trained through its gates), zamba2-1.2b (mamba segments and the shared
block), hubert-xlarge (masked units over frames) and internvl2-1b (the
patches dropped from the CE). JAX's weights are carried over by
``params_from_numpy``; both packages get the same numpy batch, every
7th label masked. The JAX side is jitted once per config and module,
with XLA's ``xla_allow_excess_precision`` off.

Also: the CE over ``loss_chunk`` chunks (each under
``torch.utils.checkpoint``) against the unchunked CE, ``cfg.remat``
"full" and "dots" against "none", the plain attention's gradient
against a dense softmax attention, a bf16 loss, the standalone
``aux_load_balance_loss``, and the attention kernel's wrapper refusing
autograd.

Tolerances: at f32 activations the loss within 1e-6 relative, tokens
and accuracy exactly, each gradient leaf within 1e-4 of max(its own
max |grad|, 1e-3 of the largest leaf's) (hubert's key bias has a
gradient of exactly zero in exact arithmetic: both packages' are
rounding noise); chunked against unchunked CE: loss within 1e-6
relative, gradients 1e-5; remat: bit-equal; the plain attention's
gradient within 1e-5 of the dense one's scale; the bf16 loss within
2e-2 of the logit scale (tests/test_serve.py:53's limit);
aux_load_balance_loss within 1e-6.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import get_smoke_config as jget_smoke
from repro.models import init_tree as jinit_tree
from repro.models import model_schema as jmodel_schema
from repro.models.model import forward as jforward
from repro.models.model import loss_fn as jloss_fn
from repro.models.moe import aux_load_balance_loss as jaux_loss
from repro_torch.configs import get_smoke_config
from repro_torch.kernels.flash_attention import flash_attention_cuda
from repro_torch.models import loss_fn, params_from_numpy
from repro_torch.models.attention import chunked_attention
from repro_torch.models.moe import aux_load_balance_loss
from repro_torch.models.params import tree_paths

ARCHS = ("yi-6b", "gemma2-27b", "deepseek-v2-lite-16b", "zamba2-1.2b",
         "hubert-xlarge", "internvl2-1b")
B, L = 2, 64


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _cfgs(arch, act="f32", **change):
    tcfg, jcfg = get_smoke_config(arch), jget_smoke(arch)
    if act == "f32":
        change = dict(change, act_dtype=torch.float32)
    jchange = {k: (jnp.float32 if v is torch.float32 else v)
               for k, v in change.items()}
    return (dataclasses.replace(tcfg, **change),
            dataclasses.replace(jcfg, **jchange))


def _batch(cfg, seed=3, seq=L):
    """Seeded numpy inputs and labels (every 7th masked)."""
    rng = np.random.RandomState(seed)
    if cfg.frontend == "audio":
        b = {"frames": rng.randn(B, seq, cfg.frontend_dim)
             .astype(np.float32)}
    else:
        b = {"tokens": rng.randint(0, cfg.vocab, (B, seq)).astype(np.int32)}
        if cfg.frontend == "vision":
            b["patches"] = rng.randn(B, cfg.n_patches, cfg.frontend_dim) \
                .astype(np.float32)
    labels = rng.randint(0, cfg.vocab, (B, seq)).astype(np.int32)
    labels[:, ::7] = -1
    b["labels"] = labels
    return b


def _jax_run(fn, *args):
    """``fn(*args)`` jitted, every op rounded to its own dtype."""
    return jax.jit(fn).lower(*args).compile(
        {"xla_allow_excess_precision": False})(*args)


def _paths(tree) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(k.key) for k in path): np.asarray(v)
            for path, v in flat}


class JaxSide:
    """The JAX package's weights, loss and gradients, each computed on
    first use."""

    def __init__(self):
        self._memo = {}

    def _get(self, key, make):
        if key not in self._memo:
            self._memo[key] = make()
        return self._memo[key]

    def weights(self, arch):
        def make():
            jcfg = _cfgs(arch)[1]
            jp = jax.jit(lambda: jinit_tree(jax.random.key(0),
                                            jmodel_schema(jcfg)))()
            return jp, params_from_numpy(jax.tree.map(np.asarray, jp),
                                         device="cpu")
        return self._get(("weights", arch), make)

    def value_and_grad(self, arch, **change):
        def make():
            jcfg = _cfgs(arch, **change)[1]
            jp, _ = self.weights(arch)
            b = {k: jnp.asarray(v) for k, v in _batch(jcfg).items()}
            (loss, metrics), grads = _jax_run(jax.value_and_grad(
                lambda p, bb: jloss_fn(p, bb, jcfg), has_aux=True), jp, b)
            return (float(loss), {k: float(v) for k, v in metrics.items()},
                    _paths(grads))
        return self._get(("vg", arch, tuple(sorted(change.items()))), make)


@pytest.fixture(scope="module")
def jax_side():
    return JaxSide()


def _port_value_and_grad(params, batch, cfg):
    leaves = list(tree_paths(params).values())
    for p in leaves:
        p.requires_grad_(True)
    try:
        loss, metrics = loss_fn(
            params, {k: torch.from_numpy(v) for k, v in batch.items()}, cfg)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    finally:
        for p in leaves:
            p.requires_grad_(False)
    names = list(tree_paths(params))
    return loss.detach(), metrics, {
        n: (torch.zeros_like(p) if g is None else g).numpy()
        for n, p, g in zip(names, leaves, grads)}


def _hold_grads(got: dict, want: dict, tol: float) -> float:
    assert set(got) == set(want)
    floor = 1e-3 * max(np.abs(w).max() for w in want.values())
    worst = 0.0
    for name, w in want.items():
        scale = max(np.abs(w).max(), floor)
        err = np.abs(got[name] - w).max() / scale
        assert err <= tol, (name, err)
        worst = max(worst, err)
    return worst


@pytest.mark.parametrize("arch,change", [
    *(pytest.param(a, {}, id=a) for a in ARCHS),
    # JAX's chunked scan too
    pytest.param("yi-6b", {"loss_chunk": 16}, id="yi-6b-loss_chunk_16"),
])
def test_loss_and_grads_match_jax(arch, change, jax_side):
    """f32 activations: the loss, its metrics and every leaf's gradient
    (the router's, through the gate values, for deepseek)."""
    wl, wm, wg = jax_side.value_and_grad(arch, **change)
    tcfg, _ = _cfgs(arch, **change)
    _, tp = jax_side.weights(arch)
    loss, metrics, grads = _port_value_and_grad(tp, _batch(tcfg), tcfg)
    assert abs(float(loss) - wl) <= 1e-6 * abs(wl)
    assert int(metrics["tokens"]) == wm["tokens"] == B * L - B * (-(-L // 7))
    assert float(metrics["accuracy"]) == pytest.approx(wm["accuracy"],
                                                       abs=1e-7)
    _hold_grads(grads, wg, 1e-4)
    if arch == "deepseek-v2-lite-16b":
        assert np.abs(grads["stack/layers/ffn/router"]).max() > 0


def test_bf16_loss_within_the_logit_limit(jax_side):
    """yi-6b at its default bf16 activations: the loss within 2e-2 of the
    logit scale of JAX's (its bf16 ops rounded as the port's)."""
    tcfg, jcfg = _cfgs("yi-6b", act="bf16")
    jp, tp = jax_side.weights("yi-6b")
    b = _batch(tcfg)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    want = float(_jax_run(lambda p, bb: jloss_fn(p, bb, jcfg)[0], jp, jb))
    scale = float(jnp.abs(_jax_run(lambda p, bb: jforward(p, bb, jcfg),
                                   jp, jb)).max())
    with torch.no_grad():
        got, _ = loss_fn(tp, {k: torch.from_numpy(v) for k, v in b.items()},
                         tcfg)
    assert abs(float(got) - want) <= 2e-2 * scale, (float(got), want, scale)


@pytest.mark.parametrize("arch", ["yi-6b", "internvl2-1b"])
def test_chunked_ce_equals_unchunked(arch, jax_side):
    """loss_chunk 16 over 64 positions (four checkpointed chunks) against
    one CE over all of them."""
    _, tp = jax_side.weights(arch)
    full, _ = _cfgs(arch, loss_chunk=0)
    chunked, _ = _cfgs(arch, loss_chunk=16)
    b = _batch(full)
    l0, m0, g0 = _port_value_and_grad(tp, b, full)
    l1, m1, g1 = _port_value_and_grad(tp, b, chunked)
    assert abs(float(l1) - float(l0)) <= 1e-6 * abs(float(l0))
    assert int(m1["tokens"]) == int(m0["tokens"])
    assert float(m1["accuracy"]) == float(m0["accuracy"])
    for name in g0:
        np.testing.assert_allclose(g1[name], g0[name], rtol=0, atol=1e-5 *
                                   max(np.abs(g0[name]).max(), 1e-3))


class _CountMM(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.mm = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
            self.mm += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("arch", ["yi-6b", "zamba2-1.2b",
                                  "deepseek-v2-lite-16b"])
def test_remat_full_and_dots_equal_none(arch, jax_side):
    """The same loss and gradients bit for bit; "full" recomputes every
    layer's products in the backward, "dots" keeps them (the backward
    runs as many unbatched products as without remat)."""
    _, tp = jax_side.weights(arch)
    b = {k: torch.from_numpy(v) for k, v in _batch(_cfgs(arch)[0]).items()}
    leaves = list(tree_paths(tp).values())
    out, mm = {}, {}
    for remat in ("none", "full", "dots"):
        cfg = _cfgs(arch, remat=remat)[0]
        for p in leaves:
            p.requires_grad_(True)
        try:
            loss, _ = loss_fn(tp, b, cfg)
            with _CountMM() as count:
                grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        finally:
            for p in leaves:
                p.requires_grad_(False)
        out[remat], mm[remat] = (loss, grads), count.mm
    for remat in ("full", "dots"):
        assert torch.equal(out[remat][0], out["none"][0])
        for a, g in zip(out["none"][1], out[remat][1]):
            assert (a is None and g is None) or torch.equal(a, g)
    assert mm["full"] > mm["none"] and mm["dots"] == mm["none"], mm


def test_plain_attention_gradient_matches_dense_softmax():
    """The chunked online softmax under autograd (each block
    checkpointed) against softmax(q k^T) v: GQA 4/2, causal, ragged."""
    rng = np.random.RandomState(0)
    q = torch.from_numpy(rng.randn(2, 45, 4, 8).astype(np.float32))
    k = torch.from_numpy(rng.randn(2, 45, 2, 8).astype(np.float32))
    v = torch.from_numpy(rng.randn(2, 45, 2, 8).astype(np.float32))
    w = torch.from_numpy(rng.randn(2, 45, 4, 8).astype(np.float32))

    def grads(fn):
        qq, kk, vv = (t.clone().requires_grad_(True) for t in (q, k, v))
        out = fn(qq, kk, vv)
        return out, torch.autograd.grad((out * w).sum(), (qq, kk, vv))

    def dense(qq, kk, vv):
        kr, vr = kk.repeat_interleave(2, 2), vv.repeat_interleave(2, 2)
        s = torch.einsum("bqhd,bkhd->bhqk", qq, kr) / np.sqrt(8)
        s = s.masked_fill(torch.ones(45, 45).triu(1).bool(), -torch.inf)
        return torch.einsum("bhqk,bkhd->bqhd", s.softmax(-1), vr)

    got, gg = grads(lambda a, b, c: chunked_attention(
        a, b, c, cq=16, ckv=16, backend="ref"))
    want, gw = grads(dense)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    for a, b in zip(gg, gw):
        torch.testing.assert_close(a, b, rtol=0,
                                   atol=1e-5 * float(b.abs().max()))


def test_aux_load_balance_loss_matches_jax():
    rng = np.random.RandomState(1)
    logits = rng.randn(96, 8).astype(np.float32)
    top = np.argsort(-logits, axis=1)[:, :2].astype(np.int32)
    cfg = get_smoke_config("deepseek-v2-lite-16b")
    got = aux_load_balance_loss(torch.from_numpy(logits),
                                torch.from_numpy(top), cfg)
    want = float(jaux_loss(jnp.asarray(logits), jnp.asarray(top),
                           jget_smoke("deepseek-v2-lite-16b")))
    assert abs(float(got) - want) <= 1e-6 * abs(want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_kernel_wrapper_refuses_autograd(dtype):
    """A wrapper with no backward raises under autograd (naming the plain
    path) instead of cutting the gradient; without grad it goes on to its
    own device checks (here: the CPU is no CUDA device)."""
    q = torch.zeros((1, 16, 2, 16), dtype=dtype, requires_grad=True)
    k = torch.zeros((1, 16, 2, 16), dtype=dtype)
    v = torch.zeros((1, 16, 2, 16), dtype=dtype)
    with pytest.raises(RuntimeError, match="backend='ref'"):
        flash_attention_cuda(q, k, v)
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA device"):
        flash_attention_cuda(q, k, v)
