"""The build's CUDA kernels against their plain versions, on the card.

Marked ``gpu``; each test skips without a CUDA card. This file imports no
JAX, so it also runs where JAX is not installed (the repository's
conftest.py imports JAX, hence ``--noconftest``):

    PYTHONPATH=src python -m pytest -m gpu --noconftest tests/test_torch_gpu.py

Tolerances: ids, counts, evals and +inf positions exact; join distances
rtol 1e-5 / atol 1e-4 (the kernel sums in another order than cuBLAS);
select and merge bitwise.
"""
import numpy as np
import pytest
import torch

from repro_torch import DescentConfig, build_knn_graph, recall_at_k
from repro_torch.core import datasets
from repro_torch.kernels import _lib, ops

pytestmark = pytest.mark.gpu


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _both(fn, *args, **kw):
    before = dict(_lib.LAUNCHES)
    got = fn(*args, **kw)
    torch.cuda.synchronize()
    launched = {k: _lib.LAUNCHES[k] - before[k] for k in before}
    want = fn(*args, **kw, backend="ref")
    return got, want, launched


@pytest.mark.parametrize("n,c,cn,dp", [
    (37, 12, 5, 16), (64, 8, 8, 32), (10, 6, 0, 8), (33, 1, 1, 20),
    (4096, 20, 10, 896),         # the main path: C = 20, dp = 896
    (257, 64, 30, 130),          # the widest C the kernel takes
])
def test_join_dists_kernel(dev, n, c, cn, dp):
    rng = np.random.RandomState(n + c)
    x = torch.from_numpy(rng.randn(4 * n, dp).astype(np.float32)).to(dev)
    x2 = (x * x).sum(1)
    ids = torch.from_numpy(
        rng.randint(-1, 4 * n, size=(n, c)).astype(np.int32)).to(dev)
    ids[3] = -1
    (gd, gev), (wd, wev), launched = _both(ops.knn_join_dists, x, x2, ids, cn)
    assert launched["knn_join_dists"] == 1
    assert torch.equal(torch.isinf(gd), torch.isinf(wd))
    fin = torch.isfinite(wd)
    torch.testing.assert_close(gd[fin], wd[fin], rtol=1e-5, atol=1e-4)
    assert torch.equal(gev, wev)


@pytest.mark.parametrize("n,w,c,ties", [
    (37, 23, 9, False), (16, 5, 12, False), (50, 40, 40, True),
    (3, 0, 4, False),
    (2048, 800, 60, True),       # receiver select
    (4096, 400, 120, False),     # polish
    (8, 8192, 30, True),         # the widest row the kernel takes
])
def test_join_select_kernel(dev, n, w, c, ties):
    rng = np.random.RandomState(n + w)
    gd = (rng.randint(0, 6, size=(n, w)) / 4.0 if ties
          else rng.rand(n, w)).astype(np.float32)
    gd[rng.rand(n, w) < 0.2] = np.inf
    if w:
        gd[:, 0] = -0.0
    gi = rng.randint(-1, 99, size=(n, w)).astype(np.int32)
    kth = (rng.rand(n) * 1.5).astype(np.float32)
    kth[0] = np.inf
    args = [torch.from_numpy(a).to(dev) for a in (gd, gi, kth)]
    (gd_, gi_), (wd, wi), launched = _both(ops.knn_join_select, *args, c)
    assert launched["knn_join_select"] == 1
    assert torch.equal(gi_, wi)
    assert torch.equal(gd_, wd)


@pytest.mark.parametrize("n,k,c", [
    (64, 8, 12), (100, 20, 7), (256, 4, 40), (9, 3, 0),
    (2048, 20, 60),              # the fused join's merge
    (5, 100, 1436),              # the widest pool the kernel takes
])
def test_merge_kernel(dev, n, k, c):
    rng = np.random.RandomState(n + k)
    cur_d = np.sort(rng.rand(n, k).astype(np.float32), axis=1)
    cur_i = rng.randint(0, 10 * n, size=(n, k)).astype(np.int32)
    cand_d = (np.round(rng.rand(n, c) * 4) / 4).astype(np.float32)
    cand_i = rng.randint(-1, 10 * n, size=(n, c)).astype(np.int32)
    cur_d[1, k // 2:] = np.inf
    cur_i[1, k // 2:] = -1
    cur_d[2, -1] = np.float32(3.0e38)
    if c:
        cand_i[3, :min(c, k)] = cur_i[3, :min(c, k)]
        cand_i[4, 1:] = cand_i[4, 0]
        cand_d[0, 0] = np.inf
    args = [torch.from_numpy(a).to(dev) for a in (cur_d, cur_i, cand_d,
                                                   cand_i)]
    got, want, launched = _both(ops.knn_merge, *args)
    assert launched["knn_merge"] == 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_build_through_kernels_matches_plain_build(dev):
    """A 2048-point build through the kernels and through the plain
    versions, same generator seed: recall within 0.005."""
    x = datasets.clustered(2048, 16, 8, seed=0, device=dev)
    d = torch.cdist(x, x).square()
    d.fill_diagonal_(torch.inf)
    ti = d.topk(20, largest=False).indices
    recalls = {}
    for backend in ("auto", "plain"):
        _lib.reset_launches()
        cfg = DescentConfig(k=20, rho=1.0, max_iters=15, backend=backend)
        g = torch.Generator(device=dev).manual_seed(1)
        _, idx, _ = build_knn_graph(x, k=20, cfg=cfg, generator=g)
        recalls[backend] = recall_at_k(idx, ti)
        used = all(v > 0 for v in _lib.LAUNCHES.values())
        assert used == (backend == "auto"), _lib.LAUNCHES
    assert recalls["auto"] > 0.95
    assert abs(recalls["auto"] - recalls["plain"]) <= 0.005, recalls
