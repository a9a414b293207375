"""The port's CUDA kernels against their plain versions, on the card.

Marked ``gpu``; each test skips without a CUDA card. This file imports no
JAX, so it also runs where JAX is not installed (the repository's
conftest.py imports JAX, hence ``--noconftest``):

    PYTHONPATH=src python -m pytest -m gpu --noconftest tests/test_torch_gpu.py

Tolerances: ids, counts, evals and +inf positions exact; join distances
rtol 1e-5 / atol 1e-4 (the kernel sums in another order than cuBLAS);
select (every branch of the radix select) and merge bitwise; pairwise and
search distances 1e-4 + 1e-5 * (|a|^2 + |b|^2) (the norm expansion
cancels the digits the two norms share, so the error scales with the
norms, not the distance). The int8
tiles bitwise (their cross terms are exact integers and the epilogue keeps
the plain version's order of operations); the bf16 tiles 1e-4 + 1e-5 *
(|a|^2 + |b|^2), as the fp32 ones (bf16 products are exact in f32; only
the order of the sums differs), also for the fp32 and bf16 search tiles
at every sharing pattern. The online store's compaction and row
kernels bitwise (they only move values). Attention at f32 rtol/atol 2e-3
(tests/test_kernels.py's limit for the Pallas kernel), at bf16 rtol 1e-2 /
atol 2e-3 (one bf16 rounding of the output, 2^-7 relative, on top), on
the rows that see a key; rows that see none exactly 0. A smoke-config
prefill through the kernel against the plain chunked scan within 2e-2 of
the logit scale (tests/test_serve.py:53's bf16 limit), the front ends'
too (hubert's forward, internvl2's prefill with patches); the SSM /
hybrid family's prefill and decode steps bit-equal when repeated, and a
slot written into its batch axis bitwise. Training: the attention
kernels raise under autograd and launch nothing; a train step of the
yi-6b smoke config on the card against the CPU's: the gradients within
1e-4 of each leaf's scale, the loss within 1e-5 relative, the grad norm
1e-4, each parameter's update within 1e-3 of the learning rate where its
gradient passes 1e-3 of the leaf's largest. Elsewhere the update is held
to 2.5 learning rates, which any first Adam step meets (a flipped sign
is 2): that bound holds only finiteness, and the gradient check carries
those elements.
"""

import numpy as np
import pytest
import torch

from repro_torch import (
    DescentConfig,
    MutableKNNStore,
    OnlineConfig,
    RouterConfig,
    SearchConfig,
    brute_force_knn,
    build_knn_graph,
    build_router,
    graph_search,
    knn_delete,
    knn_insert,
    recall_at_k,
)
from repro_torch.configs import get_smoke_config
from repro_torch.core import (
    ShardMesh,
    build_knn_graph_sharded,
    datasets,
    exact_knn_sharded,
    fetch_rows_a2a,
    graph_search_sharded,
)
from repro_torch.core.quantize import quantize_corpus
from repro_torch.kernels import _lib, ops
from repro_torch.models import (
    cast_matrices,
    forward,
    init_tree,
    model_schema,
)
from repro_torch.models.params import tree_map, tree_paths
from repro_torch.serve import init_cache, prefill, serve_step, write_slot

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
    (300, 17, 9, 130),           # C not a multiple of the 4 x 4 tile
    (512, 32, 16, 4096),         # the kNN-LM's build: C = 32, d = 4096
    (2048, 40, 20, 896),         # the online store's build: rho 1.0
    (2048, 92, 46, 896),         # the wide kernel: k 91's C
    (300, 65, 30, 130),          # one past the narrow kernel
    (257, 180, 90, 131),         # two stages; dp % 4 != 0
    (130, 256, 100, 784),        # two stages
    (1000, 320, 160, 100),       # panels, the grid walking the rows
    (200, 300, 300, 131),        # panels, every slot new; dp % 4 != 0
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


def _select_case(kind, n, w, c, seed):
    """Rows that force each branch of the radix select: "few" (the
    prefilter leaves about c / 2: every survivor wins), "many"
    (no prefilter: four histogram passes), "ties" (one value on the whole
    row), "straddle" (two values, the c-th key inside a run of equal keys
    spread over every lane), "zeros" (-0.0 and +0.0 mixed), "specials"
    (-inf, +inf, NaN, FLT_MAX, ids -1)."""
    rng = np.random.RandomState(seed)
    gd = rng.rand(n, w).astype(np.float32)
    gi = rng.randint(0, 99, size=(n, w)).astype(np.int32)
    kth = np.full(n, np.inf, np.float32)
    if kind == "few":
        kth[:] = 0.5 * c / max(w, 1)
    elif kind == "ties":
        gd[:] = 0.5
    elif kind == "straddle":
        gd = np.where(rng.rand(n, w) < 0.04, 0.25, 0.5).astype(np.float32)
    elif kind == "zeros":
        gd = np.where(rng.rand(n, w) < 0.5, -0.0, 0.0).astype(np.float32)
        gd[rng.rand(n, w) < 0.3] = 0.125
        kth[::2] = 0.0        # -0.0 < 0.0 is false: only -inf would pass
    elif kind == "specials":
        r = rng.rand(n, w)
        gd[r < 0.1] = -np.inf
        gd[(r >= 0.1) & (r < 0.2)] = np.inf
        gd[(r >= 0.2) & (r < 0.3)] = np.nan
        gd[(r >= 0.3) & (r < 0.4)] = np.finfo(np.float32).max
        gi[rng.rand(n, w) < 0.2] = -1
        kth[1::3] = np.float32(0.5)
    return gd, gi, kth


@pytest.mark.parametrize("kind", ["few", "many", "ties", "straddle", "zeros",
                                  "specials"])
@pytest.mark.parametrize("n,w,c", [
    (64, 32, 6),                 # search top-E: one warp per row
    (64, 120, 60),               # top-C
    (64, 400, 120),              # polish
    (256, 800, 60),              # receiver select
    (16, 1024, 100),             # the widest row a warp takes
    (16, 40, 100),               # c > W
    (3, 0, 4),                   # W = 0
    (8, 2048, 60),               # one block per row
    (4, 8192, 30), (4, 8192, 500),   # the widest row in registers
    (16, 8193, 60),              # streamed: one past it
    (64, 16928, 273),            # streamed: k 91's receiver select
    (64, 8281, 546),             # streamed: k 91's polish select
    (8, 64800, 540),             # streamed: C 180's receiver select
    (4, 131072, 768),            # streamed: a bitonic sort of the winners
    (3, 20000, 12000),           # streamed: the winners' words in scratch
])
def test_join_select_radix_cases(dev, kind, n, w, c):
    """The radix select bitwise against its plain version (a stable sort),
    in each of its branches, at the warp and the block widths."""
    args = [torch.from_numpy(a).to(dev)
            for a in _select_case(kind, n, w, c, n + w + c)]
    (gd_, gi_), (wd, wi), launched = _both(ops.knn_join_select, *args, c)
    assert launched["knn_join_select"] == 1
    assert torch.equal(gi_, wi)
    assert torch.equal(gd_.view(torch.int32), wd.view(torch.int32))


# (shape, the device function knn_join_dists_launch, knn_join_select_launch,
# the quantized joins' launchers and the merges' launchers pick for it):
# C <= 64, a padded W <= 8192 and a pool <= 8192 the instances they
# picked before the wide joins, the wide selects and the wide merges
# existed (8 slices up to C 40, 4, then 2; 16-byte copies where dp % 4 ==
# 0; ceil(C / 16) row blocks; a block of 32 pool entries a thread), above
# them the new kernels: the wide fp32 join (three stages; its panel
# instance where its rows and cross terms do not fit: C 320 at cn 160),
# the resident select (the streamed one past 110 KB of keys), the wide
# merges
LAUNCHED_INSTANCES = [
    (("f32", 20, 896), "knn_join_dists_kernel<8, 4>"),
    (("f32", 40, 896), "knn_join_dists_kernel<8, 4>"),
    (("f32", 48, 130), "knn_join_dists_kernel<4, 1>"),
    (("f32", 64, 896), "knn_join_dists_kernel<2, 4>"),
    (("f32", 65, 896), "knn_join_dists_kernel_wide<4, 3, 0>"),
    (("f32", 92, 131), "knn_join_dists_kernel_wide<1, 3, 0>"),
    (("f32", 320, 896), "knn_join_dists_kernel_wide<4, 3, 1>"),
    (("int8", 64, 800), "knn_join_dists_q8_kernel<4>"),
    (("int8", 92, 800), "knn_join_dists_q8_kernel_wide"),
    (("bf16", 20, 800), "knn_join_dists_bf16_kernel<2>"),
    (("bf16", 92, 800), "knn_join_dists_bf16_kernel_wide"),
    (("select", 32, 6), "knn_join_select_kernel<1, 1>"),
    (("select", 800, 60), "knn_join_select_kernel<1, 32>"),
    (("select", 2048, 60), "knn_join_select_kernel<8, 8>"),
    (("select", 8192, 500), "knn_join_select_kernel<8, 32>"),
    (("select", 8193, 60), "knn_join_select_kernel_resident"),
    (("select", 16928, 273), "knn_join_select_kernel_resident"),
    (("select", 64800, 540), "knn_join_select_kernel_stream"),
    (("merge", 20, 8172), "knn_merge_kernel<8, 32>"),
    (("merge", 91, 8281), "knn_merge_kernel_wide"),
    (("merge", 91, 12000), "knn_merge_kernel_wide"),
    (("merge_rows", 20, 8172), "knn_merge_rows_kernel<8, 32>"),
    (("merge_rows", 91, 8281), "knn_merge_rows_kernel_wide"),
]


def _instance_call(dev, kind, a, b):
    """One call of the join, select or merge at shape (a, b), ready to
    run (a merge: k, c)."""
    if kind in ("merge", "merge_rows"):
        cd = torch.rand(64, a, device=dev).sort(1).values
        ci = torch.randint(0, 5000, (64, a), device=dev, dtype=torch.int32)
        qd = torch.rand(16, b, device=dev)
        qi = torch.randint(-1, 5000, (16, b), device=dev, dtype=torch.int32)
        if kind == "merge":
            return lambda: ops.knn_merge(cd[:16].contiguous(),
                                         ci[:16].contiguous(), qd, qi)
        rows = torch.arange(0, 64, 4, device=dev, dtype=torch.int32)
        return lambda: ops.knn_merge_rows(cd, ci, rows, qd, qi)
    if kind == "select":
        gd = torch.rand(16, a, device=dev)
        gi = torch.randint(0, 99, (16, a), device=dev, dtype=torch.int32)
        kth = torch.full((16,), float("inf"), device=dev)
        return lambda: ops.knn_join_select(gd, gi, kth, b)
    ids = torch.randint(0, 500, (64, a), device=dev, dtype=torch.int32)
    if kind == "f32":
        x = torch.randn(500, b, device=dev)
        x2 = (x * x).sum(1)
        return lambda: ops.knn_join_dists(x, x2, ids, a // 2)
    xs = _mirror(dev, 500, b, kind, a)
    if kind == "int8":
        return lambda: ops.knn_join_dists_q8(xs.data, xs.scale, xs.x2, ids,
                                             a // 2)
    return lambda: ops.knn_join_dists_bf16(xs.data, xs.x2, ids, a // 2)


def test_launchers_pick_their_instances(dev):
    """Each shape of LAUNCHED_INSTANCES launches its device function and
    no other, read by torch.profiler: one profile over every call, each
    warmed up (and the library built) before it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    calls = [_instance_call(dev, *shape) for shape, _ in LAUNCHED_INSTANCES]
    for run in calls:
        run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for run in calls:
            run()
            torch.cuda.synchronize()
    got = [e.name for e in sorted(
        (e for e in prof.events() if e.device_type == DeviceType.CUDA
         and ("knn_join" in e.name or "knn_merge" in e.name)),
        key=lambda e: e.time_range.start)]
    want = [name for _, name in LAUNCHED_INSTANCES]
    assert len(got) == len(want), got
    for (shape, name), g in zip(LAUNCHED_INSTANCES, got):
        assert name + ("(" if name.endswith(">") else "") in g, (shape, g)


@pytest.mark.parametrize("k", [48, 91])
def test_store_and_datastore_build_at_large_k_on_card(dev, k):
    """MutableKNNStore.build and KNNDatastore.build (their default rho
    1.0: C 2k, 96 at k 48) run on the card at k past the old C <= 64 cap:
    full lists, every build kernel launched, recall@k
    against brute_force_knn within 0.01 of the same builds through the
    plain versions with the same generator seed, and at or above the
    build floor of 0.84, on chip_smoke.py's check corpus."""
    from repro_torch import KNNDatastore
    n = 16000
    x = datasets.mnist_like(n, 784, seed=1, device=dev)
    _, truth = brute_force_knn(x, x, k)
    recalls = {}
    for backend in ("auto", "plain"):
        before = dict(_lib.LAUNCHES)
        store, _ = MutableKNNStore.build(
            x, k, descent=DescentConfig(k=k, rho=1.0, max_iters=15,
                                        backend=backend),
            generator=torch.Generator(device=dev).manual_seed(1))
        ds = KNNDatastore.build(
            x, torch.arange(n, device=dev), k=k,
            cfg=DescentConfig(k=k, rho=1.0, max_iters=10, backend=backend),
            generator=torch.Generator(device=dev).manual_seed(1))
        launched = {n: _lib.LAUNCHES[n] - before[n] for n in before}
        for name in ("knn_join_dists", "knn_join_select", "knn_merge"):
            assert (launched[name] > 0) == (backend == "auto"), launched
        assert store.nl.idx.device.type == "cuda"
        assert bool((store.nl.idx[:n] >= 0).all())
        recalls[backend] = (recall_at_k(store.nl.idx[:n], truth),
                            recall_at_k(ds.graph_idx, truth))
    for got, want in zip(recalls["auto"], recalls["plain"]):
        assert abs(got - want) <= 0.01, recalls
        assert min(got, want) >= 0.84, recalls


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


def _dup_heavy(rng, f, k, c, cur_i):
    """Candidates full of duplicates: ids from a few values, a share of
    them repeating the row's list ids, one row a single id throughout,
    distances on a coarse grid (ties)."""
    ci = rng.randint(-1, 8, size=(f, c)).astype(np.int32)
    take = rng.rand(f, c) < 0.3
    ci[take] = cur_i[np.nonzero(take)[0], rng.randint(0, k, take.sum())]
    ci[0] = ci[0, 0] if ci[0, 0] >= 0 else 3
    cd = (np.round(rng.rand(f, c) * 4) / 4).astype(np.float32)
    return cd, ci


@pytest.mark.parametrize("n,k,c", [
    (500, 20, 500),              # the online path's recorded width
    (300, 20, 400),              # the refinement's c = k^2
    (64, 20, 108), (64, 20, 109),   # a warp per row up to a pool of 128
    (4, 20, 8172), (3, 100, 8092),  # the widest pool in registers
    (500, 91, 8281),             # the wide merge: the online pool at k 91
    (64, 91, 12000),             # past its shared memory: the scratch
])
@pytest.mark.parametrize("dups", [False, True])
def test_merge_kernel_wide_pools(dev, n, k, c, dups):
    """The merge bitwise at the block-per-row widths and above a pool of
    8192 (knn_merge_kernel_wide, in shared memory and in its scratch),
    with and without rows full of duplicates; a repeated list id
    survives."""
    rng = np.random.RandomState(n + k + c)
    cur_d = np.sort(rng.rand(n, k).astype(np.float32), axis=1)
    cur_i = rng.randint(0, 10 * n, size=(n, k)).astype(np.int32)
    cur_i[1, 1] = cur_i[1, 0]                      # a repeated list id
    cur_d[2, -1] = np.float32(3.0e38)
    if dups:
        cand_d, cand_i = _dup_heavy(rng, n, k, c, cur_i)
    else:
        cand_d = (np.round(rng.rand(n, c) * 64) / 64).astype(np.float32)
        cand_i = rng.randint(-1, 10 * n, size=(n, c)).astype(np.int32)
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
        used = [_lib.LAUNCHES[k] > 0 for k in
                ("knn_join_dists", "knn_join_select", "knn_merge")]
        assert all(used) if backend == "auto" else not any(used), \
            _lib.LAUNCHES
    assert recalls["auto"] > 0.95
    assert abs(recalls["auto"] - recalls["plain"]) <= 0.005, recalls


@pytest.mark.parametrize("m,n,d", [
    (17, 784, 896),              # odd M, tile-multiple-free N
    (130, 257, 131),             # D % 4 != 0: the 4-byte load path
    (1, 1, 1), (300, 5, 0),
    (1024, 70000, 784),          # the brute-force tile at MNIST's shape
    (129, 257, 100),             # M, N one past the 128 tile; D % 32 != 0
    (255, 383, 33),              # D % 4 != 0 across two chunks
    (4096, 245, 784),            # centroid_assign: 245 centroids
    (500, 16, 784), (3, 1024, 64),   # the router's skinny and widest N
])
def test_pairwise_sq_l2_kernel(dev, m, n, d):
    g = torch.Generator(device=dev).manual_seed(m + n + d)
    a = torch.randn(m, d, generator=g, device=dev)
    b = torch.randn(n, d, generator=g, device=dev)
    if m > 1 and n > 3:
        b[3] = a[1]
    got, want, launched = _both(ops.pairwise_sq_l2, a, b)
    assert launched["pairwise_sq_l2"] == 1
    tol = 1e-4 + 1e-5 * ((a * a).sum(1)[:, None] + (b * b).sum(1)[None, :])
    assert got.shape == (m, n)
    assert bool(((got - want).abs() <= tol).all())
    assert bool((got >= 0).all())
    # a sliced, 4-byte-offset operand takes the 4-byte load path too
    if m > 1 and d:
        got2 = ops.pairwise_sq_l2(a.reshape(-1)[1:1 + (m - 1) * d]
                                  .reshape(m - 1, d), b)
        want2 = ops.pairwise_sq_l2(a.reshape(-1)[1:1 + (m - 1) * d]
                                   .reshape(m - 1, d), b, backend="ref")
        assert bool(((got2 - want2).abs() <= tol[1:]).all())


@pytest.mark.parametrize("nq,w,dp,big_n", [
    (37, 23, 16, 99), (5, 7, 8, 12), (9, 33, 131, 300),
    (512, 120, 784, 70000),      # one search round at MNIST's shape
    (64, 32, 896, 5000),         # a per-query seed tile
])
def test_search_dists_kernel(dev, nq, w, dp, big_n):
    g = torch.Generator(device=dev).manual_seed(nq + w)
    q = torch.randn(nq, dp, generator=g, device=dev)
    x = torch.randn(big_n, dp, generator=g, device=dev)
    ids = torch.randint(-1, big_n, (nq, w), generator=g, device=dev,
                        dtype=torch.int32)
    ids[2] = -1
    ids[0, 0] = big_n - 1
    ids[1, 0] = big_n                            # out of range: invalid
    q2, x2 = (q * q).sum(1), (x * x).sum(1)
    got, want, launched = _both(ops.knn_search_dists, q, q2, x, x2, ids)
    assert launched["knn_search_dists"] == 1
    assert torch.equal(torch.isinf(got), torch.isinf(want))
    assert torch.equal(torch.isinf(got), (ids < 0) | (ids >= big_n))
    fin = torch.isfinite(want)
    safe = ids.clamp(0, big_n - 1).long()
    tol = 1e-4 + 1e-5 * (q2[:, None] + x2[safe])
    assert bool(((got - want).abs()[fin] <= tol[fin]).all())


def test_search_through_kernels_matches_plain(dev):
    """A 2048-point graph searched through the kernels and through the
    plain versions, same entries: recall within 0.01, and the kernels
    (and only they) launched."""
    x = datasets.gaussian(2048, 16, seed=0, device=dev)
    _, gidx, _ = build_knn_graph(
        x, k=20, cfg=DescentConfig(k=20, rho=1.5, max_iters=15,
                                   merge_size=120),
        generator=torch.Generator(device=dev).manual_seed(1))
    q = x[:256] + 0.01 * torch.randn(256, 16, device=dev,
                                     generator=torch.Generator(
                                         device=dev).manual_seed(2))
    _, ti = brute_force_knn(x, q, 10, exclude_self=False)
    entry = torch.randperm(2048, device=dev, generator=torch.Generator(
        device=dev).manual_seed(3))[:32].to(torch.int32)
    recalls = {}
    for backend in ("auto", "plain"):
        _lib.reset_launches()
        cfg = SearchConfig(beam=32, rounds=48, expand=6, q_block=64,
                           backend=backend)
        _, gi = graph_search(x, gidx, q, k_out=10, entry=entry, cfg=cfg)
        torch.cuda.synchronize()
        recalls[backend] = recall_at_k(gi, ti)
        used = [_lib.LAUNCHES[k] > 0 for k in
                ("knn_search_dists", "knn_join_select", "knn_merge")]
        assert all(used) if backend == "auto" else not any(used), \
            _lib.LAUNCHES
    assert recalls["auto"] > 0.9, recalls
    assert abs(recalls["auto"] - recalls["plain"]) <= 0.01, recalls


# ---------------------------------------------------------------------------
# the sharded search (core/distributed.py): logical shards on one card
# ---------------------------------------------------------------------------

def test_sharded_search_on_one_card_is_the_direct_merge(dev):
    """P = 4 logical shards on cuda:0: the replicated dispatch equals the
    stable merge of four direct searches with the same entries, bitwise,
    through the kernels; the routed dispatch drops nothing; the ring's
    exact k-NN matches brute_force_knn up to ties; fetched rows are the
    rows."""
    P, n_local = 4, 512
    x = datasets.gaussian(P * n_local, 16, seed=4, device=dev)
    parts = [build_knn_graph(
        x[p * n_local:(p + 1) * n_local], k=10,
        cfg=DescentConfig(k=10, rho=1.0, max_iters=10),
        generator=torch.Generator(device=dev).manual_seed(p))[1]
        for p in range(P)]
    gidx = torch.cat(parts)
    q = x[::16] + 0.01
    g = torch.Generator(device=dev).manual_seed(5)
    ents = torch.stack([torch.randperm(n_local, generator=g, device=dev)[
        :32] for _ in range(P)]).to(torch.int32)
    cfg = SearchConfig(beam=32, rounds=24, expand=4, q_block=64)
    mesh = ShardMesh(["cuda:0"] * P)
    _lib.reset_launches()
    d, i = graph_search_sharded(mesh, x, gidx, q, k_out=10, cfg=cfg,
                                entries=ents)
    torch.cuda.synchronize()
    assert all(_lib.LAUNCHES[k] > 0 for k in
               ("knn_search_dists", "knn_join_select", "knn_merge"))
    pd, pi = [], []
    for p in range(P):
        sl = slice(p * n_local, (p + 1) * n_local)
        dd, ii = graph_search(x[sl], gidx[sl], q, k_out=10, entry=ents[p],
                              cfg=cfg)
        pd.append(dd)
        pi.append(torch.where(ii >= 0, ii + p * n_local, -1))
    md, order = torch.sort(torch.cat(pd, 1), dim=1, stable=True)
    mi = torch.gather(torch.cat(pi, 1), 1, order)
    assert torch.equal(d.view(torch.int32), md[:, :10].view(torch.int32))
    assert torch.equal(i, mi[:, :10])
    router = build_router(x, cfg=RouterConfig(n_centroids=16),
                          generator=torch.Generator(device=dev).manual_seed(6))
    _, ri, st = graph_search_sharded(mesh, x, gidx, q, k_out=10, cfg=cfg,
                                     router=router, route_p=2,
                                     with_stats=True)
    assert st["dropped_queries"] == 0 and bool((ri >= 0).all())
    ed, ei = exact_knn_sharded(mesh, x, 10)
    td, ti = brute_force_knn(x, x, 10)
    x2 = (x * x).sum(1)
    assert ((ed - td).abs() <= 1e-4 + 1e-5 * (x2[:, None] + x2[ti.long()])
            ).all()
    assert recall_at_k(ei, ti) > 0.999
    ids = [torch.randint(-1, P * n_local, (256,), device=dev,
                         dtype=torch.int32, generator=g) for _ in range(P)]
    rows, ok = fetch_rows_a2a(mesh, mesh.split(x), ids, cap=48)
    for p in range(P):
        assert torch.equal(rows[p][ok[p]], x[ids[p][ok[p]].long()])
        assert not rows[p][~ok[p]].any()


def test_shard_mesh_on_defaults_to_the_card(dev):
    """ShardMesh.on(P) puts every shard on the card; it never falls back
    to the CPU (tests/test_torch_distributed.py holds that it raises
    where there is no card)."""
    mesh = ShardMesh.on(4)
    assert [d.type for d in mesh.devices] == ["cuda"] * 4
    assert all(t.is_cuda for t in mesh.split(torch.zeros(8, 2)))


def test_sharded_build_on_one_card_is_its_plain_version(dev):
    """4096 x 64 as four logical shards on cuda:0: the build through the
    select kernel and through its plain version (backend "plain"), with
    the same key, gives the same bits and stats; the kernel launched."""
    x = datasets.clustered(4096, 64, 16, seed=7, device=dev)
    mesh = ShardMesh(["cuda:0"] * 4)
    cfg = DescentConfig(k=20, reorder=False)
    _lib.reset_launches()
    d, i, st = build_knn_graph_sharded(mesh, x, 20, cfg=cfg, key=5)
    torch.cuda.synchronize()
    assert _lib.LAUNCHES["knn_join_select"] > 0
    before = dict(_lib.LAUNCHES)
    pd, pi, pst = build_knn_graph_sharded(
        mesh, x, 20, cfg=DescentConfig(k=20, reorder=False, backend="plain"),
        key=5)
    torch.cuda.synchronize()
    assert dict(_lib.LAUNCHES) == before
    assert torch.equal(d.view(torch.int32), pd.view(torch.int32))
    assert torch.equal(i, pi) and st == pst
    _, ti = brute_force_knn(x, x, 20)
    assert recall_at_k(i, ti) > 0.9


def test_sharded_build_defaults_to_the_card(dev):
    """ShardMesh.on(4) builds on the card and returns CUDA tensors; it
    never falls back to the CPU (tests/test_torch_sharded_build.py holds
    that it raises where there is no card)."""
    x = datasets.clustered(1024, 16, 8, seed=3)
    d, i, st = build_knn_graph_sharded(
        ShardMesh.on(4), x, 10, cfg=DescentConfig(k=10, reorder=False))
    assert d.is_cuda and i.is_cuda and st["iters"] > 0


# ---------------------------------------------------------------------------
# the search tile (csrc/search_tile.cuh), fp32 and bf16
# ---------------------------------------------------------------------------

def _tile_ids(dev, case, nq, w, big_n, seed):
    """(nq, w) ids for a sharing pattern of 16-query groups: "shared"
    (every query of a group names its first query's ids), "half" (the
    first half of each query's slots are its group's first query's),
    "repeat" (each id twice in its query) or random; with ids -1 and >= N
    sprinkled in."""
    g = torch.Generator(device=dev).manual_seed(seed)
    ids = torch.randint(0, big_n, (nq, w), generator=g, device=dev,
                        dtype=torch.int32)
    lead = torch.arange(nq, device=dev) // 16 * 16
    if case == "shared":
        ids = ids[lead]
    elif case == "half":
        ids[:, :w // 2] = ids[lead, :w // 2]
    elif case == "repeat" and w > 1:
        ids[:, 1::2] = ids[:, 0:w - 1:2]
    ids[::7, 0] = -1
    ids[1::9, -1] = big_n + 3                    # >= N: an invalid slot
    return ids


def _check_tile(dev, mode, q, x, ids):
    """The search tile through the kernel against its plain version on
    fp32 rows (mode "fp32") or on their bf16 or int8 mirrors: one launch,
    +inf exactly at the invalid ids, 1e-4 + 1e-5 (q2 + c2) elsewhere
    (int8: bitwise)."""
    big_n = x.shape[0]
    if mode == "fp32":
        fn, name = ops.knn_search_dists, "knn_search_dists"
        q2, x2 = (q * q).sum(1), (x * x).sum(1)
        args = (q, q2, x, x2, ids)
    elif mode == "int8":
        fn, name = ops.knn_search_dists_q8, "knn_search_dists_q8"
        qs = quantize_corpus(q, "int8")
        xs = quantize_corpus(x, "int8")
        q2, x2 = qs.x2, xs.x2
        args = (qs.data, qs.scale, q2, xs.data, xs.scale, x2, ids)
    else:
        fn, name = ops.knn_search_dists_bf16, "knn_search_dists_bf16"
        qs = quantize_corpus(q, "bf16")
        xs = quantize_corpus(x, "bf16")
        q2, x2 = qs.x2, xs.x2
        args = (qs.data, q2, xs.data, x2, ids)
    got, want, launched = _both(fn, *args)
    assert launched[name] == 1
    assert torch.equal(torch.isinf(got), (ids < 0) | (ids >= big_n))
    assert torch.equal(torch.isinf(got), torch.isinf(want))
    if mode == "int8":
        assert torch.equal(got, want)
        return
    fin = torch.isfinite(want)
    tol = 1e-4 + 1e-5 * (q2[:, None] + x2[ids.clamp(0, big_n - 1).long()])
    assert bool(((got - want).abs()[fin] <= tol[fin]).all())


@pytest.mark.parametrize("mode", ["fp32", "bf16", "int8"])
@pytest.mark.parametrize("case,nq,w", [
    ("shared", 512, 120),        # full sharing: a group names 120 rows
    ("half", 512, 120),
    ("repeat", 512, 120),        # one id in two slots of a query
    ("random", 1, 120),          # one query: one block
    ("random", 513, 120),        # nq not a multiple of the group
    ("shared", 512, 1),          # W 1
    ("half", 70, 300),           # 38 candidates a warp: two rounds of 32
    ("random", 64, 128),         # 16 candidates a warp
    ("half", 512, 32),           # the quantized search's re-rank width
])
def test_search_tile_sharing(dev, mode, case, nq, w):
    big_n, dp = 5000, 784
    g = torch.Generator(device=dev).manual_seed(nq + w)
    q = torch.rand(nq, dp, generator=g, device=dev)
    x = torch.rand(big_n, dp, generator=g, device=dev)
    _check_tile(dev, mode, q, x, _tile_ids(dev, case, nq, w, big_n, w))


@pytest.mark.parametrize("case,dp,offset", [
    ("half", 131, 0),            # dp % 4 != 0: the 4-byte instance
    ("half", 784, 1),            # rows not 16-byte aligned
    ("shared", 12288, 0),        # the widest dp: 24 pieces of 2 KB
    ("half", 4100, 1),           # pieces, the last one partial, 4-byte
])
def test_search_tile_fp32_rows(dev, case, dp, offset):
    nq, w, big_n = 40, 50, 3000
    g = torch.Generator(device=dev).manual_seed(dp + offset)
    q = torch.rand(nq, dp, generator=g, device=dev)
    flat = torch.rand(big_n * dp + offset, generator=g, device=dev)
    x = flat[offset:].view(big_n, dp)
    _check_tile(dev, "fp32", q, x, _tile_ids(dev, case, nq, w, big_n, dp))


def test_search_tile_bf16_widest_rows(dev):
    """bf16 rows of 48 KB (w 24576), the tile's widest: 24 pieces."""
    nq, w, big_n, width = 40, 50, 600, 24576
    g = torch.Generator(device=dev).manual_seed(width)
    q = torch.rand(nq, width, generator=g, device=dev)
    x = torch.rand(big_n, width, generator=g, device=dev)
    _check_tile(dev, "bf16", q, x, _tile_ids(dev, "half", nq, w, big_n, 1))


@pytest.mark.parametrize("width", [
    49152,                       # 48 KB rows, the tile's widest: 48 pieces
    1040,                        # 65 vectors: a second piece of one vector
    16,                          # one vector: one lane of the first piece
    2064,                        # 129 vectors: three pieces, the last of one
])
def test_search_tile_int8_rows(dev, width):
    """int8 rows at the 1 KB piece's edges and at 48 KB, bitwise."""
    nq, w, big_n = 40, 50, 600
    g = torch.Generator(device=dev).manual_seed(width)
    q = torch.randn(nq, width, generator=g, device=dev)
    x = torch.randn(big_n, width, generator=g, device=dev)
    _check_tile(dev, "int8", q, x, _tile_ids(dev, "half", nq, w, big_n, 2))


@pytest.mark.parametrize("mode", ["fp32", "bf16", "int8"])
def test_search_tile_late_round(dev, mode, monkeypatch):
    """A graph search's own tile at round 6 of its first block (where the
    queries share fewer rows than at round 2), held against the plain
    version."""
    x = datasets.mnist_like(8000, 784, seed=1, device=dev)
    _, gidx, _ = build_knn_graph(
        x, k=20, cfg=DescentConfig(k=20, rho=1.0),
        generator=torch.Generator(device=dev).manual_seed(1))
    q = x[:512] + 0.01 * torch.randn(512, 784, device=dev,
                                     generator=torch.Generator(
                                         device=dev).manual_seed(2))
    name = {"fp32": "knn_search_dists", "bf16": "knn_search_dists_bf16",
            "int8": "knn_search_dists_q8"}[mode]
    real, tiles = getattr(ops, name), []

    def record(*args, **kw):
        tiles.append(tuple(a.clone() for a in args))
        return real(*args, **kw)
    monkeypatch.setattr(ops, name, record)
    graph_search(x, gidx, q, k_out=10, cfg=SearchConfig(
        beam=32, rounds=48, expand=6, q_block=512,
        precision="f32" if mode == "fp32" else mode))
    monkeypatch.undo()
    assert len(tiles) >= 6
    ids = tiles[5][-1]
    assert ids.shape == (512, 120)
    if mode == "fp32":
        _check_tile(dev, mode, q, x, ids)
        return
    got, want, launched = _both(real, *tiles[5])
    assert launched[name] == 1
    assert torch.equal(torch.isinf(got), torch.isinf(want))
    if mode == "int8":
        assert torch.equal(got, want)
        return
    fin = torch.isfinite(want)
    qx2, xx2 = tiles[5][1], tiles[5][3]
    tol = 1e-4 + 1e-5 * (qx2[:, None] + xx2[ids.clamp(0).long()])
    assert bool(((got - want).abs()[fin] <= tol[fin]).all())


# ---------------------------------------------------------------------------
# the quantized tiles
# ---------------------------------------------------------------------------

def _mirror(dev, n, w, mode, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    return quantize_corpus(3.0 * torch.randn(n, w, generator=g, device=dev),
                           mode)


@pytest.mark.parametrize("mode", ["int8", "bf16"])
@pytest.mark.parametrize("nq,w_cand,width,big_n", [
    (37, 23, 32, 99), (5, 7, 64, 12), (9, 33, 160, 300),
    (512, 120, 784, 70000),      # a search round at MNIST's width
    (512, 32, 784, 70000),       # the final re-rank's pool width
])
def test_quant_search_dists_kernel(dev, mode, nq, w_cand, width, big_n):
    qs = _mirror(dev, nq, width, mode, nq)
    xs = _mirror(dev, big_n, width, mode, big_n)
    g = torch.Generator(device=dev).manual_seed(w_cand)
    ids = torch.randint(-1, big_n, (nq, w_cand), generator=g, device=dev,
                        dtype=torch.int32)
    ids[2] = -1
    ids[0, 0] = big_n - 1
    ids[1, 0] = big_n                            # out of range: invalid
    if mode == "int8":
        fn, name = ops.knn_search_dists_q8, "knn_search_dists_q8"
        args = (qs.data, qs.scale, qs.x2, xs.data, xs.scale, xs.x2, ids)
    else:
        fn, name = ops.knn_search_dists_bf16, "knn_search_dists_bf16"
        args = (qs.data, qs.x2, xs.data, xs.x2, ids)
    got, want, launched = _both(fn, *args)
    assert launched[name] == 1
    assert torch.equal(torch.isinf(got), (ids < 0) | (ids >= big_n))
    assert torch.equal(torch.isinf(got), torch.isinf(want))
    if mode == "int8":
        assert torch.equal(got, want)
    else:
        safe = ids.clamp(0, big_n - 1).long()
        tol = 1e-4 + 1e-5 * (qs.x2[:, None] + xs.x2[safe])
        fin = torch.isfinite(want)
        assert bool(((got - want).abs()[fin] <= tol[fin]).all())


@pytest.mark.parametrize("mode", ["int8", "bf16"])
@pytest.mark.parametrize("n,c,cn,width", [
    (37, 12, 5, 32), (64, 8, 8, 64), (10, 6, 0, 96), (33, 1, 1, 32),
    (4096, 20, 10, 800),         # the default build: C = 20, w = 800
    (4096, 40, 20, 800),         # rho 1.0: C = 40
    (257, 64, 30, 288),          # the widest C the kernel takes
    (300, 17, 9, 800),           # C not a multiple of 16 (nor of 4)
    (300, 27, 13, 800),          # ring and static arrays past 48 KB
    (300, 28, 14, 800),          # C = 2 rho k: k 14 rho 1.0, k 20 rho 0.7
    (2048, 92, 46, 800),         # the wide kernels: k 91's C, 3 sets
    (300, 65, 30, 288),          # one past the narrow kernels: 33 + 32
    (257, 180, 90, 800),         # 6 sets of 30
    (130, 256, 100, 96),         # 8 sets of 32
])
def test_quant_join_dists_kernel(dev, mode, n, c, cn, width):
    big_n = 4 * n
    xs = _mirror(dev, big_n, width, mode, n + c)
    g = torch.Generator(device=dev).manual_seed(n)
    ids = torch.randint(-1, big_n + 2, (n, c), generator=g, device=dev,
                        dtype=torch.int32)           # ids >= N: invalid
    ids[3] = -1
    if c > 1:
        ids[4, 1] = ids[4, 0]                        # a repeated id
    if mode == "int8":
        fn, name = ops.knn_join_dists_q8, "knn_join_dists_q8"
        args = (xs.data, xs.scale, xs.x2, ids, cn)
    else:
        fn, name = ops.knn_join_dists_bf16, "knn_join_dists_bf16"
        args = (xs.data, xs.x2, ids, cn)
    (gd, gev), (wd, wev), launched = _both(fn, *args)
    assert launched[name] == 1
    assert torch.equal(gev, wev) and int(gev[3]) == 0
    assert torch.equal(torch.isinf(gd), torch.isinf(wd))
    if mode == "int8":
        assert torch.equal(gd, wd)
    else:
        valid = (ids >= 0) & (ids < big_n)
        x2g = torch.where(valid, xs.x2[ids.clamp(0, big_n - 1).long()], 0.0)
        tol = 1e-4 + 1e-5 * (x2g[:, :, None] + x2g[:, None, :])
        fin = torch.isfinite(wd)
        assert bool(((gd - wd).abs()[fin] <= tol[fin]).all())


@pytest.mark.parametrize("c", [33, 48, 64])
@pytest.mark.parametrize("width", [16, 48, 816])
def test_join_q8_mma_widths(dev, c, width):
    """The int8 join's mma.sync Gram (k-steps of 32 bytes, 128-byte ring
    stages) at 3 and 4 row blocks and at widths that end inside a k-step
    (16, 48) or a stage (816): bitwise equal to the plain version."""
    n, big_n = 130, 500
    xs = _mirror(dev, big_n, width, "int8", c + width)
    g = torch.Generator(device=dev).manual_seed(c * width)
    ids = torch.randint(-1, big_n + 2, (n, c), generator=g, device=dev,
                        dtype=torch.int32)
    ids[3] = -1
    ids[4, 1] = ids[4, 0]
    for cn in (0, c // 2, c):
        (gd, gev), (wd, wev), launched = _both(
            ops.knn_join_dists_q8, xs.data, xs.scale, xs.x2, ids, cn)
        assert launched["knn_join_dists_q8"] == 1
        assert torch.equal(gd, wd) and torch.equal(gev, wev)
        assert int(gev[3]) == 0 and (cn > 0 or int(gev.sum()) == 0)


@pytest.mark.parametrize("mode", ["int8", "bf16"])
def test_quant_wrappers_refuse_misaligned_rows(dev, mode):
    """The kernels read 16-byte chunks: a row of another size, or one that
    does not start on a 16-byte boundary, raises; nothing launches."""
    dtype = torch.int8 if mode == "int8" else torch.bfloat16
    bad_w = 24 if mode == "int8" else 12
    before = dict(_lib.LAUNCHES)
    ids = torch.zeros((2, 3), dtype=torch.int32, device=dev)
    for data in (torch.zeros((5, bad_w), dtype=dtype, device=dev),
                 torch.zeros(5 * 32 + 1, dtype=dtype, device=dev)[1:]
                 .view(5, 32)):
        n2 = torch.zeros(5, device=dev)
        with pytest.raises(ValueError, match="16-byte"):
            if mode == "int8":
                ops.knn_join_dists_q8(data, n2 + 1, n2, ids, 1)
            else:
                ops.knn_join_dists_bf16(data, n2, ids, 1)
        with pytest.raises(ValueError, match="16-byte"):
            q = data[:2]
            if mode == "int8":
                ops.knn_search_dists_q8(q, n2[:2], n2[:2], data, n2, n2, ids)
            else:
                ops.knn_search_dists_bf16(q, n2[:2], data, n2, ids)
    assert _lib.LAUNCHES == before


@pytest.mark.parametrize("mode", ["int8", "bf16"])
def test_quantized_build_and_search_through_kernels(dev, mode):
    """A 2048-point quantized build and search through the kernels and
    through the plain versions: recalls within 0.01, the quantized tiles
    (and only the kernels) launched, returned distances exact fp32."""
    x = datasets.clustered(2048, 16, 8, seed=0, device=dev)
    d = torch.cdist(x, x).square()
    d.fill_diagonal_(torch.inf)
    ti = d.topk(20, largest=False).indices
    q = x[:256] + 0.01
    _, qt = brute_force_knn(x, q, 10, exclude_self=False)
    entry = torch.arange(0, 2048, 64, device=dev, dtype=torch.int32)
    tiles = (("knn_join_dists_q8", "knn_search_dists_q8") if mode == "int8"
             else ("knn_join_dists_bf16", "knn_search_dists_bf16"))
    r = {}
    for backend in ("auto", "plain"):
        _lib.reset_launches()
        cfg = DescentConfig(k=20, rho=1.0, max_iters=15, backend=backend,
                            precision=mode)
        g = torch.Generator(device=dev).manual_seed(1)
        dist, idx, _ = build_knn_graph(x, k=20, cfg=cfg, generator=g)
        scfg = SearchConfig(beam=32, rounds=48, expand=6, q_block=64,
                            backend=backend, precision=mode)
        sd, si = graph_search(x, idx, q, k_out=10, entry=entry, cfg=scfg)
        torch.cuda.synchronize()
        r[backend] = (recall_at_k(idx, ti), recall_at_k(si, qt))
        if backend == "auto":
            assert all(_lib.LAUNCHES[k] > 0 for k in tiles), _lib.LAUNCHES
        else:
            assert not any(_lib.LAUNCHES.values()), _lib.LAUNCHES
        xa = x[si.long()]
        true = ((q[:, None, :] - xa) ** 2).sum(-1)
        tol = 1e-4 + 1e-5 * ((q * q).sum(-1)[:, None] + (xa * xa).sum(-1))
        assert bool(((sd - true).abs() <= tol).all())
    assert r["auto"][0] > 0.95, r
    assert abs(r["auto"][0] - r["plain"][0]) <= 0.01, r
    assert abs(r["auto"][1] - r["plain"][1]) <= 0.01, r


# ---------------------------------------------------------------------------
# the online store's kernels: compaction and the frontier row forms
# ---------------------------------------------------------------------------

def _lists(rng, n, k, hi, sort=True):
    d = rng.rand(n, k).astype(np.float32)
    if sort:
        d = np.sort(d, axis=1)
    i = rng.randint(-1, hi, size=(n, k)).astype(np.int32)
    d[1, k // 2:] = np.inf
    i[1, k // 2:] = -1
    d[2, -1], i[2, -1] = np.float32(3.0e38), 7   # a valid placeholder
    return d, i


# entries the compaction must order by its contract: -0.0 tied with +0.0
# (each read back with its stored sign), survivors at FLT_MAX and at the
# 3e38 placeholder, and -inf, NaN and +inf, which never survive
EDGES = np.array([-0.0, 0.0, -0.0, np.finfo(np.float32).max, 3.0e38,
                  -np.inf, np.nan, np.inf, 0.0], np.float32)


def _plant_edges(d, i, drop, list_rows, drop_rows):
    """EDGES at consecutive slots of the listed rows (row-major, so k 1
    spreads them over nine rows), with valid ids and not dropped."""
    k = d.shape[1]
    for s, v in enumerate(EDGES):
        r, p = s // k, s % k
        if r >= len(list_rows):
            return
        d[list_rows[r], p] = v
        i[list_rows[r], p] = 7 + s
        drop[drop_rows[r], p] = False


@pytest.mark.parametrize("n,k,sort", [
    (100, 20, True), (37, 8, False), (245, 32, True), (16, 512, False),
    (3, 1536, True), (2048, 20, True),
    (12, 1, False),              # k 1: one edge entry a row
    (5, 1537, False),            # above the old cap: a block per row
    (4, 8192, True)])            # the cap: the bitonic sort of 8192 words
def test_compact_kernel(dev, n, k, sort):
    rng = np.random.RandomState(n + k)
    d, i = _lists(rng, n, k, 5 * n, sort)
    d[0] = d[0, ::-1].copy()                      # an unsorted row
    drop = rng.rand(n, k) < 0.3
    drop[2, -1] = False
    edge_rows = np.arange(3, n)
    _plant_edges(d, i, drop, edge_rows, edge_rows)
    args = [torch.from_numpy(a).to(dev) for a in (d, i, drop)]
    got, want, launched = _both(ops.knn_compact, *args)
    assert launched["knn_compact"] == 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    # the stored sign of a zero survives (torch.equal holds -0.0 == 0.0)
    assert torch.equal(torch.signbit(got[0]), torch.signbit(want[0]))


def test_compact_wrappers_refuse_k_above_cap(dev):
    """k 8192 (the select's widest row) is the cap of both forms; k 8193
    raises ValueError before any launch."""
    from repro_torch.kernels.knn_merge import (
        COMPACT_MAX_K, knn_compact_cuda, knn_compact_rows_cuda)
    assert COMPACT_MAX_K == 8192
    k = COMPACT_MAX_K + 1
    d = torch.zeros((2, k), device=dev)
    i = torch.zeros((2, k), dtype=torch.int32, device=dev)
    drop = torch.zeros((2, k), dtype=torch.bool, device=dev)
    rows = torch.tensor([1, -1], dtype=torch.int32, device=dev)
    before = dict(_lib.LAUNCHES)
    with pytest.raises(ValueError, match="k <= 8192"):
        knn_compact_cuda(d, i, drop)
    with pytest.raises(ValueError, match="k <= 8192"):
        knn_compact_rows_cuda(d, i, rows, drop)
    assert _lib.LAUNCHES == before


@pytest.mark.parametrize("n,k,f,c,pad", [
    (64, 8, 16, 12, 3), (1000, 20, 256, 40, 17), (50, 20, 8, 1516, 2),
    (4096, 20, 1024, 400, 100), (30, 4, 5, 0, 1)])
def test_merge_rows_kernel(dev, n, k, f, c, pad):
    """Padding slots (count 0, nothing written), rows off the frontier
    passed through, k + c at the kernel's widest pool."""
    rng = np.random.RandomState(n + f)
    d, i = _lists(rng, n, k, 5 * n)
    rows = np.full((f,), -1, np.int32)
    rows[pad:] = rng.choice(n, size=f - pad, replace=False)
    rng.shuffle(rows)
    cd = (np.round(rng.rand(f, c) * 4) / 4).astype(np.float32)
    ci = rng.randint(-1, 5 * n, size=(f, c)).astype(np.int32)
    args = [torch.from_numpy(a).to(dev) for a in (d, i, rows, cd, ci)]
    got, want, launched = _both(ops.knn_merge_rows, *args)
    assert launched["knn_merge_rows"] == 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert bool((got[2][torch.from_numpy(rows).to(dev) < 0] == 0).all())


@pytest.mark.parametrize("n,k,f,c,pad", [
    (65536, 20, 500, 500, 0),    # the online path's recorded call
    (65536, 20, 500, 400, 7),    # the refinement and the delete refill
    (131072, 20, 1024, 80, 30),  # a route-width merge (warp per row)
    (50, 20, 8, 8172, 2),        # the widest pool in registers
    (65536, 91, 500, 8281, 7),   # the online path's refinement at k 91
    (4096, 91, 64, 12000, 3),    # past the shared memory: the scratch
])
@pytest.mark.parametrize("dups", [False, True])
def test_merge_rows_kernel_wide_pools(dev, n, k, f, c, pad, dups):
    """The row merge bitwise at the online path's widths, the widest pool
    in registers and above it (knn_merge_rows_kernel_wide), with and
    without rows full of duplicates."""
    rng = np.random.RandomState(n + f + c)
    d, i = _lists(rng, n, k, 5 * n)
    rows = np.full((f,), -1, np.int32)
    rows[pad:] = rng.choice(n, size=f - pad, replace=False)
    rng.shuffle(rows)
    if dups:
        cd, ci = _dup_heavy(rng, f, k, c, i[np.maximum(rows, 0)])
    else:
        cd = (np.round(rng.rand(f, c) * 64) / 64).astype(np.float32)
        ci = rng.randint(-1, 5 * n, size=(f, c)).astype(np.int32)
    args = [torch.from_numpy(a).to(dev) for a in (d, i, rows, cd, ci)]
    got, want, launched = _both(ops.knn_merge_rows, *args)
    assert launched["knn_merge_rows"] == 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert bool((got[2][torch.from_numpy(rows).to(dev) < 0] == 0).all())


@pytest.mark.parametrize("n,k,f,pad,sort", [
    (64, 8, 16, 3, True), (5000, 20, 1024, 40, True), (40, 33, 9, 0, False),
    (30, 1, 20, 2, False),       # k 1
    (10, 1537, 4, 1, False),     # above the old cap
    (6, 8192, 3, 1, True)])      # the cap
def test_compact_rows_kernel(dev, n, k, f, pad, sort):
    rng = np.random.RandomState(n * k)
    d, i = _lists(rng, n, k, 5 * n, sort)
    rows = np.full((f,), -1, np.int32)
    rows[pad:] = rng.choice(n, size=f - pad, replace=False)
    drop = rng.rand(f, k) < 0.4
    _plant_edges(d, i, drop, rows[pad:], np.arange(pad, f))
    args = [torch.from_numpy(a).to(dev) for a in (d, i, rows, drop)]
    got, want, launched = _both(ops.knn_compact_rows, *args)
    assert launched["knn_compact_rows"] == 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert torch.equal(torch.signbit(got[0]), torch.signbit(want[0]))
    assert bool((got[2][torch.from_numpy(rows).to(dev) < 0] == 0).all())


def test_online_store_through_kernels(dev):
    """A small routed store, inserted into and deleted from through the
    kernels on the card and through the plain versions on the CPU, from
    the same graph, router sample and entries: the three online kernels
    launched, no tombstone anywhere, recall within 0.01."""
    x = datasets.clustered(2304, 16, 8, seed=0, device=dev)
    _, g, _ = build_knn_graph(x[:2048], k=10, cfg=DescentConfig(
        k=10, rho=1.0, max_iters=15), device=dev)
    cfg = OnlineConfig(router=RouterConfig())
    gen = torch.Generator(device=dev).manual_seed(5)
    weights = torch.rand(2048, generator=gen, device=dev)
    fills = [torch.randperm(2048 + s, generator=gen, device=dev)[:128]
             for s in range(0, 256, 128)]
    dead = torch.arange(0, 2304, 11, device=dev)
    live = torch.ones(2304, dtype=torch.bool, device=dev)
    live[dead] = False
    r = {}
    for device in (dev, torch.device("cpu")):
        _lib.reset_launches()
        xd = x.to(device)
        store = MutableKNNStore.from_graph(
            xd[:2048], *(t.to(device) for t in (
                ((xd[:2048, None] - xd[g.long().to(device)]) ** 2).sum(-1),
                g)), cfg=cfg, device=device, router_weights=weights)
        for j, s in enumerate(range(2048, 2304, 128)):
            store, _ = knn_insert(store, xd[s:s + 128],
                                  route_fill=fills[j].to(device))
        store, _ = knn_delete(store, dead.to(device))
        if device.type == "cuda":
            torch.cuda.synchronize()
            for name in ("knn_merge_rows", "knn_compact_rows",
                         "knn_compact"):
                assert _lib.LAUNCHES[name] > 0, _lib.LAUNCHES
        idx = store.nl.idx[:2304].to(dev)
        assert not torch.isin(idx[idx >= 0], dead).any()
        xl = x[live]
        d = torch.cdist(xl, xl).square()
        d.fill_diagonal_(torch.inf)
        truth = torch.nonzero(live)[:, 0][d.topk(10, largest=False).indices]
        r[device.type] = recall_at_k(idx[live], truth)
    assert r["cuda"] > 0.9, r
    assert abs(r["cuda"] - r["cpu"]) <= 0.01, r


def _k91_online(dev, backend):
    """A routed store from the exact k = 91 graph of 2048 clustered rows,
    two inserts of 128 (the same route fills) and a delete of every 11th
    row, through ``backend`` on the card; then a MutableKNNDatastore at k
    91 (its default descent, rho 1.0: C 182) on 1536 rows, two appends of
    128 and a delete, the same generators. Returns (the store's recall@91
    over the live rows, the datastore's, wide row-merge launches)."""
    from repro_torch.serve import MutableKNNDatastore
    k = 91
    x = datasets.clustered(2304, 16, 8, seed=0, device=dev)
    dd, gi = brute_force_knn(x[:2048], x[:2048], k)
    cfg = OnlineConfig(router=RouterConfig(), chunk=256, backend=backend)
    gen = torch.Generator(device=dev).manual_seed(5)
    weights = torch.rand(2048, generator=gen, device=dev)
    fills = [torch.randperm(2048 + s, generator=gen, device=dev)[:128]
             for s in range(0, 256, 128)]
    dead = torch.arange(0, 2304, 11, device=dev)
    before = _lib.LAUNCHES["knn_merge_rows"]
    store = MutableKNNStore.from_graph(x[:2048], dd, gi, cfg=cfg,
                                       device=dev, router_weights=weights)
    for j, s in enumerate(range(2048, 2304, 128)):
        store, _ = knn_insert(store, x[s:s + 128], route_fill=fills[j])
    store, _ = knn_delete(store, dead)
    live = torch.ones(2304, dtype=torch.bool, device=dev)
    live[dead] = False
    idx = store.nl.idx[:2304]
    assert not torch.isin(idx[idx >= 0], dead).any()
    _, truth = brute_force_knn(x[live], x[live], k)
    ids = torch.nonzero(live)[:, 0]
    r_store = recall_at_k(idx[live], ids[truth.long()])
    vals = torch.arange(1792, device=dev, dtype=torch.int32) % 50
    ds = MutableKNNDatastore.build(
        x[:1536], vals[:1536], k=k, online_cfg=cfg, router=RouterConfig(),
        cfg=DescentConfig(k=k, rho=1.0, max_iters=10, backend=backend),
        device=dev, generator=torch.Generator(device=dev).manual_seed(1))
    for s in range(1536, 1792, 128):
        ds, _ = ds.append(x[s:s + 128], vals[s:s + 128],
                          generator=torch.Generator(device=dev).manual_seed(s))
    gone = torch.arange(0, 1792, 7, device=dev)
    ds, _ = ds.delete(gone)
    keep = torch.ones(1792, dtype=torch.bool, device=dev)
    keep[gone] = False
    didx = ds.store.nl.idx[:1792]
    assert not torch.isin(didx[didx >= 0], gone).any()
    _, dtruth = brute_force_knn(x[:1792][keep], x[:1792][keep], k)
    dids = torch.nonzero(keep)[:, 0]
    r_ds = recall_at_k(didx[keep], dids[dtruth.long()])
    torch.cuda.synchronize()
    return r_store, r_ds, _lib.LAUNCHES["knn_merge_rows"] - before


def test_online_store_and_datastore_at_k91_on_card(dev):
    """knn_insert / knn_delete and MutableKNNDatastore.append / .delete at
    t-SNE's k = 91 (refinement and refill merges of k + k^2 = 8372 a row,
    knn_merge_rows_kernel_wide) through the kernels, and through the plain
    versions on the card with the same draws: no tombstone in a live
    list, recall@91 of each within 0.01 of the plain run's and >= 0.84;
    the plain run launches nothing."""
    got = _k91_online(dev, "auto")
    want = _k91_online(dev, "plain")
    assert got[2] > 0 and want[2] == 0, (got, want)
    for g, w in zip(got[:2], want[:2]):
        assert abs(g - w) <= 0.01, (got, want)
        assert min(g, w) >= 0.84, (got, want)


def _ties_only(got, want, x2):
    """Lists of one iteration by two paths whose distances come from the
    norm expansion summed in other orders: distances within 1e-4 + 1e-5
    (|a|^2 + |b|^2) slot by slot, ids equal but where the other list holds
    the id at a slot of equal distance (within twice that), or where the
    entry ties with the row's k-th distance. Returns the count of cut
    ties."""
    gd, gi, wd, wi = got.dist, got.idx, want.dist, want.idx
    fin = torch.isfinite(wd)
    assert torch.equal(torch.isfinite(gd), fin)
    rows = torch.arange(wd.shape[0], device=wd.device)[:, None]
    tol = 1e-4 + 1e-5 * (x2[rows] + x2[wi.clamp_min(0).long()])
    assert bool(((gd - wd).abs() <= tol)[fin].all())
    near = (wd[:, None, :] - wd[:, :, None]).abs() \
        <= 2 * torch.maximum(tol[:, :, None], tol[:, None, :])
    held = ((gi[:, :, None] == wi[:, None, :]) & near).any(-1)
    cut = (wd - wd[:, -1:]).abs() <= 2 * torch.maximum(tol, tol[:, -1:])
    mism = gi != wi
    assert not bool((mism & ~held & ~cut).any())
    return int((mism & ~held & cut).sum())


def test_fused_iteration_through_kernels_matches_ref_backend(dev):
    """One iteration through the kernels (join_src wide enough that no
    incidence overflows) and through the lexsort "ref" path on the card,
    same lists and draws: the lists equal up to the order of tied entries
    (``_ties_only``), evals equal, updates equal but for cut ties; the
    "ref" path launches no kernel."""
    from repro_torch.core import heap, nn_descent, selection
    from repro_torch.core.layout import pad_features
    x = datasets.clustered(1000, 16, 4, seed=0, device=dev)
    xp = pad_features(x).contiguous()
    x2 = (xp * xp).sum(1)
    nl0 = heap.init_random_with_dists(
        xp, 10, generator=torch.Generator(device=dev).manual_seed(2))
    draws = [torch.rand(2 * 1000 * 10, device=dev,
                        generator=torch.Generator(device=dev).manual_seed(s))
             for s in (3, 4, 5)]
    cands = selection.selection_turbo(nl0, 10, draws=draws)
    ids = torch.cat([cands.new_idx, cands.old_idx], 1)
    src = int(torch.bincount(ids[ids >= 0].long()).max())
    out = {}
    for backend in ("auto", "ref"):
        _lib.reset_launches()
        cfg = DescentConfig(k=10, rho=1.0, join_src=src, backend=backend)
        out[backend] = nn_descent.nn_descent_iteration(xp, x2, nl0, cfg,
                                                       draws=draws)
        torch.cuda.synchronize()
        assert any(_lib.LAUNCHES.values()) == (backend == "auto")
    (nf, uf, ef), (nr, ur, er) = out["auto"], out["ref"]
    cut = _ties_only(nf, nr, x2)
    assert ef == er and abs(uf - ur) <= cut


@pytest.mark.parametrize("precision", ["f32", "int8", "bf16"])
def test_restore_on_card_searches_bit_equal(dev, tmp_path, precision):
    """A routed store with grown rows and tombstones, snapshotted and
    restored onto the card: every array bitwise, searches with the
    same generator bit-equal to the live store's, and an insert with the
    same draws gives the same lists; at int8 / bf16 the quantized-first
    restore serves at once and is the exact store after apply."""
    from repro_torch.core import persist
    x = datasets.clustered(2304, 16, 8, seed=0, device=dev)
    cfg = OnlineConfig(router=RouterConfig(), precision=precision)
    store, _ = MutableKNNStore.build(
        x[:2048], 10, cfg=cfg, device=dev, generator=torch.Generator(
            device=dev).manual_seed(1))
    store, _ = knn_insert(store, x[2048:2176], generator=torch.Generator(
        device=dev).manual_seed(2))
    store, _ = knn_delete(store, torch.arange(0, 2176, 9, device=dev))
    persist.snapshot_store(store, str(tmp_path), store.n)
    r = persist.restore_store(str(tmp_path), device=dev).store
    for a, b in ((r.x, store.x), (r.x2, store.x2), (r.alive, store.alive),
                 *zip(r.nl, store.nl), *zip(r.router.members,
                                            store.router.members)):
        assert a.device.type == dev.type and torch.equal(a, b)
    assert r.router.stale == store.router.stale and r.cfg == store.cfg

    def search(s):
        return s.search(x[:256] + 0.01, k_out=10, generator=torch.Generator(
            device=dev).manual_seed(3))
    (d1, i1), (d2, i2) = search(store), search(r)
    assert torch.equal(i1, i2)
    assert torch.equal(d1.view(torch.int32), d2.view(torch.int32))
    extra = x[2176:] + 0.001
    a, _ = knn_insert(store, extra, generator=torch.Generator(
        device=dev).manual_seed(4))
    b, _ = knn_insert(r, extra, generator=torch.Generator(
        device=dev).manual_seed(4))
    for u, v in zip(a.nl, b.nl):
        assert torch.equal(u, v)
    if precision != "f32":
        qf = persist.restore_store(str(tmp_path), quantized_first=True,
                                   device=dev)
        _, iq = search(qf.store)
        assert bool(r.alive[iq.long()].all())
        (d3, i3) = search(qf.fp32_loader.apply(qf.store))
        assert torch.equal(i3, i1)
        assert torch.equal(d3.view(torch.int32), d1.view(torch.int32))


def _grown_datastore(dev):
    """A routed datastore on the card, grown past its capacity by three
    chunks and with tombstones."""
    from repro_torch.serve import MutableKNNDatastore
    x = datasets.clustered(2304, 64, 8, seed=4, device=dev)
    vals = torch.arange(2304, device=dev, dtype=torch.int32) % 50
    ds = MutableKNNDatastore.build(
        x[:2040], vals[:2040], k=10, router=RouterConfig(), device=dev,
        generator=torch.Generator(device=dev).manual_seed(1))
    for s in range(2040, 2304, 88):
        ds, _ = ds.append(x[s:s + 88], vals[s:s + 88],
                          generator=torch.Generator(device=dev).manual_seed(s))
    ds, _ = ds.delete(torch.arange(0, 2304, 11, device=dev))
    return ds, x


def test_grown_datastore_knn_logits_bit_equal_through_restore(dev, tmp_path):
    """knn_logits on a grown MutableKNNDatastore through the kernels, and
    on its restore onto the card with the same draws: bit-equal, and no
    tombstoned row carries mass."""
    from repro_torch.serve import MutableKNNDatastore, knn_logits
    ds, x = _grown_datastore(dev)
    assert ds.store.capacity == 4096 and ds.values.shape[0] == 4096
    ds.snapshot(str(tmp_path))
    r = MutableKNNDatastore.restore(str(tmp_path), device=dev)
    assert r.store.x.device.type == "cuda"
    assert torch.equal(r.values, ds.values)
    q = x[::9] + 0.01
    before = dict(_lib.LAUNCHES)

    def logits(d):
        return knn_logits(d, q, 50, k=8, generator=torch.Generator(
            device=dev).manual_seed(3))
    a = logits(ds)
    assert _lib.LAUNCHES["knn_search_dists"] > before["knn_search_dists"]
    b = logits(r)
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    _, ids = ds.store.search(q, k_out=8)
    assert bool(ds.store.alive[ids.long()].all())


def test_batcher_cold_starts_onto_the_card(dev, tmp_path):
    """A batcher with a snapshot directory and no store restores onto the
    card by default, and grows the restored store through the kernels."""
    from repro_torch.serve import ContinuousBatcher, Request
    ds, _ = _grown_datastore(dev)
    ds.snapshot(str(tmp_path))
    proj = torch.randn(16, 64, device=dev, generator=torch.Generator(
        device=dev).manual_seed(5))

    def step_fn(cache, toks, lengths):
        lg = torch.nn.functional.one_hot(
            ((toks[:, 0] * 3 + lengths) % 16).long(), 16).float() * 4.0
        return lg.to(dev), cache

    def prefill_fn(toks):
        return torch.ones((1, 16), device=dev), None, toks.shape[1]

    b = ContinuousBatcher(2, step_fn, prefill_fn, lambda c, i, o, n: c,
                          knn_capture=lambda lg: lg @ proj, knn_chunk=8,
                          knn_snapshot_dir=str(tmp_path))
    assert b.knn_store.store.x.device.type == "cuda"
    n0 = b.knn_store.store.n
    for rid in range(3):
        b.submit(Request(rid=rid, prompt=np.array([1, 2, 3], np.int32),
                         max_new=8))
    before = _lib.LAUNCHES["knn_merge_rows"]
    b.run(None)
    assert b.knn_store.store.n == n0 + 21
    assert _lib.LAUNCHES["knn_merge_rows"] > before
    b2 = ContinuousBatcher(2, step_fn, prefill_fn, lambda c, i, o, n: c,
                           knn_snapshot_dir=str(tmp_path))
    for u, v in zip(b2.knn_store.store.nl, b.knn_store.store.nl):
        assert torch.equal(u, v)
    assert torch.equal(b2.knn_store.values, b.knn_store.values)


# (Lq, Lk, H, Hkv, Dq, Dv, keyword arguments of ops.attention)
ATTN_MODES = {
    "causal": (300, 300, 8, 2, 64, 64, dict(causal=True)),
    "window_64": (300, 300, 8, 2, 64, 64, dict(causal=True, window=64)),
    "softcap_20": (300, 300, 8, 2, 64, 64, dict(causal=True, softcap=20.0)),
    "noncausal": (200, 333, 4, 4, 32, 32, dict(causal=False)),
    "encoder_window": (257, 257, 4, 2, 32, 32,
                       dict(causal=False, window=64)),
    "gqa_32_4": (130, 130, 32, 4, 128, 128, dict(causal=True)),
    "q_offset": (100, 612, 8, 2, 128, 128, dict(causal=True, q_offset=512)),
    "decode_row": (1, 700, 8, 2, 128, 128, dict(causal=True, q_offset=699)),
    "ragged": (77, 301, 4, 2, 16, 16, dict(causal=True, q_offset=200,
                                           scale=0.3)),
    "dv_ne_dq": (150, 150, 4, 2, 192, 128, dict(causal=True)),
    "no_key_rows": (70, 40, 4, 2, 32, 32, dict(causal=True, window=16,
                                               q_offset=20)),
}


def _seen_rows(lq, lk, causal=True, window=None, q_offset=0, **_):
    qpos = torch.arange(lq)[:, None] + q_offset
    kpos = torch.arange(lk)[None, :]
    ok = torch.ones((lq, lk), dtype=torch.bool)
    if causal:
        ok &= kpos <= qpos
    if window is not None:
        ok &= kpos > qpos - window
    return ok.any(dim=1)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("mode", sorted(ATTN_MODES))
def test_attention_kernel(dev, mode, dtype):
    lq, lk, h, hkv, dq, dv, kw = ATTN_MODES[mode]
    dt = torch.float32 if dtype == "f32" else torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(len(mode))
    q = torch.randn(2, lq, h, dq, generator=g, device=dev).to(dt)
    k = torch.randn(2, lk, hkv, dq, generator=g, device=dev).to(dt)
    v = torch.randn(2, lk, hkv, dv, generator=g, device=dev).to(dt)
    got, want, launched = _both(ops.attention, q, k, v, **kw)
    assert launched["flash_attention"] == 1
    assert got.dtype == dt and tuple(got.shape) == (2, lq, h, dv)
    seen = _seen_rows(lq, lk, **kw).to(dev)
    assert torch.equal(got[:, ~seen], torch.zeros_like(got[:, ~seen]))
    rtol = 2e-3 if dtype == "f32" else 1e-2
    torch.testing.assert_close(got[:, seen].float(), want[:, seen].float(),
                               rtol=rtol, atol=2e-3)


# the bf16 kernel's widths and ring: (B, Lq, Lk, H, Hkv, Dq, Dv, kwargs)
ATTN_BF16_SHAPES = {
    "prefill_1332": (1, 1332, 1332, 32, 4, 128, 128, dict(causal=True)),
    "dh_256": (2, 300, 300, 4, 2, 256, 256, dict(causal=True)),
    "dh_80": (2, 257, 257, 8, 2, 80, 80, dict(causal=True)),
    "dq48_dv32": (2, 200, 200, 4, 2, 48, 32, dict(causal=True)),
    "long_kv_4096": (1, 256, 4096, 8, 2, 128, 128,
                     dict(causal=True, q_offset=3840)),
    "long_kv_noncausal": (1, 130, 4096, 4, 2, 64, 64, dict(causal=False)),
    "b2_q_offset": (2, 200, 712, 8, 2, 64, 64,
                    dict(causal=True, q_offset=512)),
    "bh_65544": (2, 3, 5, 32772, 4, 16, 16, dict(causal=True)),
    # gemma2's head layout: H 32/16, Dh 128, softcap 50, the query scale
    # 1/sqrt(144); its local layers' window, and its global layers
    "gemma2_local": (1, 1100, 1100, 32, 16, 128, 128, dict(
        causal=True, window=1024, softcap=50.0, scale=144.0 ** -0.5)),
    "gemma2_global": (1, 1100, 1100, 32, 16, 128, 128, dict(
        causal=True, softcap=50.0, scale=144.0 ** -0.5)),
    # hubert-xlarge's encoder: MHA 16/16 at Dh 80 (two 64-column panels),
    # non-causal over a ragged clip; internvl2-1b's 7:1 head group (14 / 2
    # at Dh 64) over 256 patches + text, causal
    "hubert_encoder": (1, 1203, 1203, 16, 16, 80, 80, dict(causal=False)),
    "internvl2_prefill": (1, 1291, 1291, 14, 2, 64, 64, dict(causal=True)),
}


@pytest.mark.parametrize("case", sorted(ATTN_BF16_SHAPES))
def test_attention_kernel_bf16_shapes(dev, case):
    """The bf16 (wgmma) kernel at the recorded prefill, at Dh 256 and 80
    and at Dq 48 / Dv 32 (TMA zero-fills the panels past D), with a kv ring
    much longer than its stages, at B 2 with q_offset, at B*H past 65535,
    at gemma2's head layout with and without its window, and at hubert's
    and internvl2's: against the plain version, at the bf16 limit."""
    b, lq, lk, h, hkv, dq, dv, kw = ATTN_BF16_SHAPES[case]
    g = torch.Generator(device=dev).manual_seed(lq + lk)
    q = torch.randn(b, lq, h, dq, generator=g, device=dev).bfloat16()
    k = torch.randn(b, lk, hkv, dq, generator=g, device=dev).bfloat16()
    v = torch.randn(b, lk, hkv, dv, generator=g, device=dev).bfloat16()
    got, want, launched = _both(ops.attention, q, k, v, **kw)
    assert launched["flash_attention"] == 1
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (b, lq, h, dv)
    seen = _seen_rows(lq, lk, **kw).to(dev)
    assert torch.equal(got[:, ~seen], torch.zeros_like(got[:, ~seen]))
    torch.testing.assert_close(got[:, seen].float(), want[:, seen].float(),
                               rtol=1e-2, atol=2e-3)


# the f32 kernel's tiles (64 query rows, 32 above Dh 128; kv tiles of 128
# keys, k slices of 32 features) at lengths and widths that are not
# multiples of them: (B, Lq, Lk, H, Hkv, Dq, Dv, kwargs)
ATTN_F32_SHAPES = {
    "dh_4": (2, 70, 130, 4, 2, 4, 4, dict(causal=True, q_offset=60)),
    "dh_12": (2, 129, 129, 4, 1, 12, 12, dict(causal=False)),
    "dh_256": (2, 161, 161, 4, 2, 256, 256, dict(causal=True)),
    "dq_256_dv_64": (1, 97, 200, 4, 2, 256, 64, dict(causal=False)),
    "dq_36_dv_200": (1, 200, 200, 2, 1, 36, 200, dict(causal=True)),
    "q_offset": (2, 65, 300, 8, 2, 128, 128, dict(causal=True, q_offset=235)),
    "window_100": (2, 333, 333, 4, 2, 128, 128, dict(causal=True,
                                                      window=100)),
    "softcap_30": (2, 191, 191, 8, 2, 64, 64, dict(causal=True,
                                                    softcap=30.0)),
    "encoder_window": (1, 257, 257, 4, 2, 128, 128,
                       dict(causal=False, window=33)),
    "long_kv": (1, 64, 1500, 8, 2, 128, 128, dict(causal=True,
                                                  q_offset=1436)),
    "bh_65544": (2, 3, 5, 32772, 4, 4, 4, dict(causal=True)),
}


@pytest.mark.parametrize("case", sorted(ATTN_F32_SHAPES))
def test_attention_kernel_f32_shapes(dev, case):
    """The f32 kernel at ragged lengths, Dh 4, 12 and 256, Dq != Dv on both
    tile heights, q_offset, window, softcap and B*H past 65535 (one 1-D
    grid): against the plain version within rtol / atol 2e-3, rows that
    see no key exactly 0."""
    b, lq, lk, h, hkv, dq, dv, kw = ATTN_F32_SHAPES[case]
    g = torch.Generator(device=dev).manual_seed(lq + lk + dq)
    q = torch.randn(b, lq, h, dq, generator=g, device=dev)
    k = torch.randn(b, lk, hkv, dq, generator=g, device=dev)
    v = torch.randn(b, lk, hkv, dv, generator=g, device=dev)
    got, want, launched = _both(ops.attention, q, k, v, **kw)
    assert launched["flash_attention"] == 1
    assert got.dtype == torch.float32 and tuple(got.shape) == (b, lq, h, dv)
    seen = _seen_rows(lq, lk, **kw).to(dev)
    assert torch.equal(got[:, ~seen], torch.zeros_like(got[:, ~seen]))
    torch.testing.assert_close(got[:, seen], want[:, seen], rtol=2e-3,
                               atol=2e-3)


def test_attention_refuses_misaligned_f32(dev):
    """The f32 kernel copies 16 bytes at a time: a view that starts off a
    16-byte boundary raises, and nothing is launched."""
    q = torch.zeros(8 * 2 * 8 + 1, device=dev)[1:].view(1, 8, 2, 8)
    before = _lib.LAUNCHES["flash_attention"]
    with pytest.raises(ValueError, match="16-byte"):
        ops.attention(q, q, q)
    assert _lib.LAUNCHES["flash_attention"] == before


def test_attention_bf16_refuses_other_widths(dev):
    """The bf16 kernel steps over 16 of Dq: a Dq of 40 is refused (f32
    takes it), and nothing is launched."""
    q = torch.zeros(1, 8, 2, 40, device=dev)
    before = _lib.LAUNCHES["flash_attention"]
    with pytest.raises(ValueError, match="multiple of 16"):
        ops.attention(q.bfloat16(), q.bfloat16(), q.bfloat16())
    assert _lib.LAUNCHES["flash_attention"] == before
    assert ops.attention(q, q, q).shape == (1, 8, 2, 40)
    assert _lib.LAUNCHES["flash_attention"] == before + 1


def test_smoke_prefill_through_kernel_matches_plain(dev):
    """The yi-6b smoke config at its bf16 activations, a ragged 150-token
    batch: prefill through the kernel (one launch per layer) against the
    plain chunked scan on the same card."""
    cfg = get_smoke_config("yi-6b")
    schema = model_schema(cfg)
    params = cast_matrices(
        init_tree(torch.Generator(device=dev).manual_seed(0), schema),
        schema, cfg.act_dtype)
    toks = torch.randint(0, cfg.vocab, (2, 150), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(1))
    before = _lib.LAUNCHES["flash_attention"]
    got, gc, _ = prefill(params, {"tokens": toks}, cfg, 256)
    torch.cuda.synchronize()
    assert _lib.LAUNCHES["flash_attention"] - before == cfg.n_layers
    want, wc, _ = prefill(params, {"tokens": toks}, cfg, 256, backend="ref")
    assert _lib.LAUNCHES["flash_attention"] - before == cfg.n_layers
    scale = want.abs().max()
    assert float((got - want).abs().max() / scale) < 2e-2
    assert torch.equal(gc["layers"]["kpos"], wc["layers"]["kpos"])


def test_gemma2_smoke_step_on_card_matches_cpu(dev):
    """The gemma2-27b smoke config (local / global pairs, window 64) at its
    bf16 activations, seeded weights: a 100-token prefill (every local ring
    wrapped; on the card through the kernel, one launch per layer) and one
    serve_step on the card against the same on the CPU, within 2e-2 of
    the logit scale; kpos tags equal."""
    cfg = get_smoke_config("gemma2-27b")
    schema = model_schema(cfg)
    cpu = cast_matrices(init_tree(torch.Generator().manual_seed(0), schema),
                        schema, cfg.act_dtype)
    toks = torch.randint(0, cfg.vocab, (2, 101),
                         generator=torch.Generator().manual_seed(1))
    card = tree_map(lambda t: t.to(dev), cpu)
    out = {}
    for where, params in (("cpu", cpu), ("cuda", card)):
        t = toks.to(params["embed"]["table"].device)
        before = _lib.LAUNCHES["flash_attention"]
        _, cache, lengths = prefill(params, {"tokens": t[:, :-1]}, cfg, 160)
        logits, cache = serve_step(params, cache, t[:, -1:], lengths, cfg)
        launched = _lib.LAUNCHES["flash_attention"] - before
        out[where] = (logits.cpu(), {k: v.cpu() for k, v in
                                      tree_paths(cache).items()}, launched)
    assert out["cpu"][2] == 0 and out["cuda"][2] == cfg.n_layers
    want, got = out["cpu"][0], out["cuda"][0]
    assert float((got - want).abs().max() / want.abs().max()) < 2e-2
    assert sorted(out["cuda"][1]) == sorted(out["cpu"][1])
    for path, leaf in out["cpu"][1].items():
        if path.endswith("kpos"):
            assert torch.equal(out["cuda"][1][path], leaf)


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b",
                                  "granite-moe-3b-a800m"])
def test_moe_smoke_prefill_through_kernel_matches_plain(dev, arch):
    """The MoE family's smoke configs at their bf16 activations, seeded
    weights, a ragged 150-token batch: prefill through the kernel (one
    launch per layer; deepseek's MLA at Dq 48 / Dv 32, scale 48^-0.5,
    granite's GQA 8/4 at Dh 16, scale 1/16) against the plain chunked scan
    on the same card, within 2e-2 of the logit scale; kpos tags equal."""
    cfg = get_smoke_config(arch)
    schema = model_schema(cfg)
    params = cast_matrices(
        init_tree(torch.Generator(device=dev).manual_seed(0), schema),
        schema, cfg.act_dtype)
    toks = torch.randint(0, cfg.vocab, (2, 150), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(1))
    before = _lib.LAUNCHES["flash_attention"]
    got, gc, _ = prefill(params, {"tokens": toks}, cfg, 256)
    torch.cuda.synchronize()
    assert _lib.LAUNCHES["flash_attention"] - before == cfg.n_layers
    want, wc, _ = prefill(params, {"tokens": toks}, cfg, 256, backend="ref")
    assert _lib.LAUNCHES["flash_attention"] - before == cfg.n_layers
    scale = want.abs().max()
    assert float((got - want).abs().max() / scale) < 2e-2
    for path, leaf in tree_paths(wc).items():
        if path.endswith("kpos"):
            assert torch.equal(tree_paths(gc)[path], leaf)


def _kept_gates(r, t: int, e: int):
    """(T, E): each token's gate at each expert that kept it, else 0."""
    _, val, idx, ok = (a.cpu() for a in r)
    g = torch.zeros(t, e)
    ev = torch.arange(e)[:, None].expand_as(idx)
    g[idx[ok], ev[ok]] = val[ok].float()
    return g


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b",
                                  "granite-moe-3b-a800m"])
def test_moe_ffn_bf16_on_card_matches_cpu(dev, arch):
    """moe_ffn at bf16 on the card against the same on the CPU, one MoE
    layer of the smoke config at T = 512 (an expert over capacity). The
    router product is a bf16 GEMM whose rounding differs between the two,
    so a route may flip where two scores are within bf16's resolution:
    the scores agree within 2^-7, at most 1% of tokens route differently,
    and on every other token the output is within 2e-2 of its scale."""
    from repro_torch.models import moe
    cfg = get_smoke_config(arch)
    sch = moe.moe_schema(cfg)
    cpu = cast_matrices(init_tree(torch.Generator().manual_seed(2), sch),
                        sch, cfg.act_dtype)
    x = torch.randn(2, 256, cfg.d_model, generator=torch.Generator()
                    .manual_seed(3))
    w = cpu["router"][:, 0].float()
    x = (x + 15.0 * w / w.norm()).to(cfg.act_dtype)
    card = tree_map(lambda t: t.to(dev), cpu)
    xf = x.reshape(512, -1)
    scores = [torch.softmax((a @ p["router"]).float(), -1).cpu()
              for a, p in ((xf, cpu), (xf.to(dev), card))]
    assert float((scores[0] - scores[1]).abs().max()) < 2 ** -7
    rc = moe.route(cpu, xf, cfg)
    rg = moe.route(card, xf.to(dev), cfg)
    assert int(rc[3].sum()) < 512 * cfg.moe_top_k      # tokens dropped
    same = ((_kept_gates(rc, 512, cfg.n_experts) > 0)
            == (_kept_gates(rg, 512, cfg.n_experts) > 0)).all(1)
    assert int((~same).sum()) <= 5
    want = moe.moe_ffn(cpu, x, cfg).float().reshape(512, -1)
    got = moe.moe_ffn(card, x.to(dev), cfg).float().cpu().reshape(512, -1)
    err = (got[same] - want[same]).abs().max()
    assert float(err / want[same].abs().max()) < 2e-2


def test_moe_step_repeats_bit_for_bit(dev):
    """The deepseek-v2-lite smoke config at bf16 on the card: the same
    prefill and decode step, twice, give the same bits (no atomic adds in
    the MoE combine), logits and every cache leaf."""
    cfg = get_smoke_config("deepseek-v2-lite-16b")
    schema = model_schema(cfg)
    params = cast_matrices(
        init_tree(torch.Generator(device=dev).manual_seed(0), schema),
        schema, cfg.act_dtype)
    toks = torch.randint(0, cfg.vocab, (4, 200), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(4))
    runs = []
    for _ in range(2):
        lg, cache, lengths = prefill(params, {"tokens": toks[:, :-1]}, cfg,
                                     256)
        st, cache = serve_step(params, cache, toks[:, -1:], lengths, cfg)
        torch.cuda.synchronize()
        runs.append((lg, st, tree_paths(cache)))
    (lg0, st0, c0), (lg1, st1, c1) = runs
    assert torch.equal(lg0, lg1) and torch.equal(st0, st1)
    assert all(torch.equal(c0[p], c1[p]) for p in c0)


def _smoke_params(arch, dev):
    cfg = get_smoke_config(arch)
    schema = model_schema(cfg)
    return cfg, cast_matrices(
        init_tree(torch.Generator(device=dev).manual_seed(0), schema),
        schema, cfg.act_dtype)


def test_zamba2_smoke_prefill_through_kernel_matches_plain(dev):
    """The zamba2-1.2b smoke config at its bf16 activations, seeded
    weights, a ragged 150-token batch: prefill through the kernel (one
    launch per shared-block invocation: MHA 8/8 at Dh 16) against the
    plain chunked scan on the same card, within 2e-2 of the logit scale;
    kpos tags equal."""
    cfg, params = _smoke_params("zamba2-1.2b", dev)
    toks = torch.randint(0, cfg.vocab, (2, 150), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(1))
    n_seg = cfg.n_layers // cfg.attn_every
    before = _lib.LAUNCHES["flash_attention"]
    got, gc, _ = prefill(params, {"tokens": toks}, cfg, 256)
    torch.cuda.synchronize()
    assert _lib.LAUNCHES["flash_attention"] - before == n_seg
    want, wc, _ = prefill(params, {"tokens": toks}, cfg, 256, backend="ref")
    assert _lib.LAUNCHES["flash_attention"] - before == n_seg
    scale = want.abs().max()
    assert float((got - want).abs().max() / scale) < 2e-2
    assert torch.equal(gc["shared"]["kpos"], wc["shared"]["kpos"])


@pytest.mark.parametrize("arch", ["mamba2-130m", "zamba2-1.2b"])
def test_ssm_family_steps_repeat_bit_for_bit(dev, arch):
    """The SSM / hybrid smoke configs at bf16 on the card: the same
    prefill (77 tokens: a padded chunk) and 4 decode steps, twice, give
    the same bits, logits and every cache leaf; every state finite."""
    cfg, params = _smoke_params(arch, dev)
    toks = torch.randint(0, cfg.vocab, (4, 81), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(4))
    runs = []
    for _ in range(2):
        lg, cache, lengths = prefill(params, {"tokens": toks[:, :77]}, cfg,
                                     128)
        steps = []
        for i in range(77, 81):
            st, cache = serve_step(params, cache, toks[:, i:i + 1], lengths,
                                   cfg)
            lengths = lengths + 1
            steps.append(st)
        torch.cuda.synchronize()
        runs.append((lg, torch.stack(steps), tree_paths(cache)))
    (lg0, st0, c0), (lg1, st1, c1) = runs
    assert torch.equal(lg0, lg1) and torch.equal(st0, st1)
    assert all(torch.equal(c0[p], c1[p]) for p in c0)
    assert all(torch.isfinite(c0[p]).all() for p in c0
               if p.endswith("state"))


def test_write_slot_on_card_hybrid(dev):
    """A zamba2 smoke request prefilled on the card and written into slot
    3 of a 4-slot CUDA cache (3 is not below attn_every): each leaf lands
    at its batch axis (2 for segments, 1 elsewhere), bitwise, and every
    other slot keeps its bits."""
    cfg, params = _smoke_params("zamba2-1.2b", dev)
    big = init_cache(cfg, 4, 64, device=dev)
    gen = torch.Generator(device=dev).manual_seed(5)
    for leaf in tree_paths(big).values():
        leaf.copy_(torch.randint(-9, 9, leaf.shape, device=dev,
                                 generator=gen).to(leaf.dtype))
    before = {p: t.clone() for p, t in tree_paths(big).items()}
    toks = torch.randint(0, cfg.vocab, (1, 20), device=dev, generator=gen)
    _, one, _ = prefill(params, {"tokens": toks}, cfg, 64)
    write_slot(big, 3, one, 20)
    torch.cuda.synchronize()
    ones = tree_paths(one)
    for path, leaf in tree_paths(big).items():
        axis = 2 if path.startswith("segments/") else 1
        assert leaf.is_cuda
        assert torch.equal(leaf.select(axis, 3),
                           ones[path].select(axis, 0).to(leaf.dtype))
        assert torch.equal(leaf.narrow(axis, 0, 3),
                           before[path].narrow(axis, 0, 3))


@pytest.mark.parametrize("arch", ["hubert-xlarge", "internvl2-1b"])
def test_frontend_smoke_through_kernel_matches_plain(dev, arch):
    """The front ends' smoke configs at their bf16 activations, seeded
    weights: hubert's forward over 150 seeded frames (bidirectional, MHA
    8/8 at Dh 16) and internvl2's prefill of 150 tokens behind 16 seeded
    patches (GQA 7/1), through the kernel (one launch per layer) against
    the plain chunked scan on the same card, within 2e-2 of the logit
    scale; the VLM's lengths count the patches and its kpos tags are
    equal."""
    cfg, params = _smoke_params(arch, dev)
    g = torch.Generator(device=dev).manual_seed(6)
    before = _lib.LAUNCHES["flash_attention"]
    if arch == "hubert-xlarge":
        batch = {"frames": torch.randn(2, 150, cfg.frontend_dim, device=dev,
                                       generator=g)}
        got = forward(params, batch, cfg)
        torch.cuda.synchronize()
        assert _lib.LAUNCHES["flash_attention"] - before == cfg.n_layers
        want = forward(params, batch, cfg, backend="ref")
    else:
        batch = {"tokens": torch.randint(0, cfg.vocab, (2, 150), device=dev,
                                         generator=g),
                 "patches": torch.randn(2, cfg.n_patches, cfg.frontend_dim,
                                        device=dev, generator=g)}
        got, gc, lengths = prefill(params, batch, cfg, 256)
        torch.cuda.synchronize()
        assert _lib.LAUNCHES["flash_attention"] - before == cfg.n_layers
        want, wc, _ = prefill(params, batch, cfg, 256, backend="ref")
        assert lengths.tolist() == [cfg.n_patches + 150] * 2
        assert torch.equal(gc["layers"]["kpos"], wc["layers"]["kpos"])
    assert _lib.LAUNCHES["flash_attention"] - before == cfg.n_layers
    assert torch.isfinite(got).all()
    assert float((got - want).abs().max() / want.abs().max()) < 2e-2


# ---------------------------------------------------------------------------
# training: the kernel refuses autograd; a train step on the card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_kernel_raises_under_grad(dev, dtype):
    """The f32 and bf16 attention kernels have no backward: handed an
    input that requires grad under grad mode they raise (directly and
    through chunked_attention's "auto" lane), launch nothing, and name
    the plain path; without grad mode the same call runs."""
    from repro_torch.models.attention import chunked_attention
    g = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn((1, 64, 4, 64), generator=g, device=dev,
                           dtype=dtype) for _ in range(3))
    qg = q.clone().requires_grad_(True)
    _lib.reset_launches()
    with pytest.raises(RuntimeError, match="backend='ref'"):
        ops.attention(qg, k, v)
    with pytest.raises(RuntimeError, match="backend='ref'"):
        chunked_attention(qg, k, v, backend="auto")
    assert _lib.LAUNCHES["flash_attention"] == 0
    with torch.no_grad():
        out = ops.attention(qg, k, v)
    assert _lib.LAUNCHES["flash_attention"] == 1 and not out.requires_grad
    # the plain path trains
    o = chunked_attention(qg, k, v, backend="ref")
    (gq,) = torch.autograd.grad(o.float().sum(), qg)
    assert torch.isfinite(gq).all()


def test_train_step_on_card_matches_cpu(dev):
    """One train step of the yi-6b smoke config at f32 activations
    (TF32 off), two microbatches, on the card against the same step on
    the CPU: the gradients (autograd at the starting parameters) within
    1e-4 of each leaf's scale, the step's loss within 1e-5 relative and
    grad norm 1e-4, and each parameter's update within 1e-3 of the
    learning rate wherever its gradient passes 1e-3 of the leaf's largest
    (an early Adam step is about lr * g / (|g| + eps), whose error is
    about lr * eps * |dg| / g^2: small where g is well above the
    gradients' rounding, up to 2 lr where the rounding can flip it).
    Elsewhere the 2.5 lr bound holds only that the update is finite: the
    gradient check above is what holds those elements."""
    import dataclasses

    from repro_torch.models import loss_fn
    from repro_torch.train import OptimizerConfig, TrainConfig
    from repro_torch.train import make_train_step
    from repro_torch.train import optimizer as opt_mod
    cfg = dataclasses.replace(get_smoke_config("yi-6b"),
                              act_dtype=torch.float32)
    tc = TrainConfig(microbatches=2, opt=OptimizerConfig(
        lr=2e-3, warmup_steps=3, total_steps=30))
    cpu = init_tree(torch.Generator().manual_seed(0), model_schema(cfg))
    card = tree_map(lambda t: t.to(dev, copy=True), cpu)
    rng = np.random.RandomState(0)
    toks = rng.randint(0, cfg.vocab, (4, 65))
    batch = {"tokens": torch.from_numpy(toks[:, :-1]),
             "labels": torch.from_numpy(toks[:, 1:])}
    grads = {}
    for where, p in (("cpu", cpu), ("cuda", card)):
        leaves = list(tree_paths(p).values())
        for t in leaves:
            t.requires_grad_(True)
        loss, _ = loss_fn(p, batch, cfg)
        grads[where] = [g.cpu() for g in torch.autograd.grad(loss, leaves)]
        for t in leaves:
            t.requires_grad_(False)
    for a, b in zip(grads["cuda"], grads["cpu"]):
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())
    before = [t.clone() for t in tree_paths(cpu).values()]
    step = make_train_step(cfg, tc)
    cpu, _, mc = step(cpu, opt_mod.init(cpu), batch)
    card, state, md = step(card, opt_mod.init(card), batch)
    assert state.step.device == card["embed"]["table"].device
    assert int(state.step) == 1
    assert abs(float(md["loss"]) - float(mc["loss"])) <= \
        1e-5 * float(mc["loss"])
    assert abs(float(md["grad_norm"]) - float(mc["grad_norm"])) <= \
        1e-4 * float(mc["grad_norm"])
    lr = float(mc["lr"])
    for a, b, p0, g in zip(tree_paths(card).values(),
                           tree_paths(cpu).values(), before, grads["cpu"]):
        assert not torch.equal(b, p0)
        clear = g.abs() > 1e-3 * g.abs().max()
        err = (a.cpu() - b).abs()
        assert float(err[clear].max()) <= 1e-3 * lr
        assert float(err.max()) <= 2.5 * lr


# ---------------------------------------------------------------------------
# the sharded training state on the card: (data 2, model 2) logical shards
# ---------------------------------------------------------------------------

def _sharded_yi(dev):
    import dataclasses

    from repro_torch.configs import batch_specs
    from repro_torch.launch import make_test_mesh
    from repro_torch.models import device_put, sharding_tree
    cfg = dataclasses.replace(get_smoke_config("yi-6b"),
                              act_dtype=torch.float32)
    mesh = make_test_mesh((2, 2), device=dev)
    params = init_tree(torch.Generator(device=dev).manual_seed(0),
                       model_schema(cfg))
    placed = tree_map(device_put, params,
                      sharding_tree(model_schema(cfg), mesh))
    specs = batch_specs(cfg, "train_4k", mesh)
    rng = np.random.RandomState(1)
    batches = []
    for _ in range(3):
        toks = torch.from_numpy(rng.randint(0, cfg.vocab, (4, 65)))
        batches.append({"tokens": toks[:, :-1], "labels": toks[:, 1:]})
    placed_batches = [{k: device_put(v.to(dev), specs[k])
                       for k, v in b.items()} for b in batches]
    return cfg, mesh, params, placed, batches, placed_batches


def test_sharded_step_on_card_matches_unsharded(dev):
    """Three FSDP steps of the yi-6b smoke config on a (2, 2) mesh of
    logical shards on the card against the unsharded step with two
    microbatches on the same halves: the loss within 1e-6 relative, the
    grad norm 1e-5, every parameter and moment within 1e-6 of its leaf's
    largest magnitude; every block on the card."""
    import dataclasses

    from repro_torch.models.params import tree_leaves
    from repro_torch.train import OptimizerConfig, TrainConfig
    from repro_torch.train import make_train_step
    from repro_torch.train import optimizer as opt_mod
    cfg, mesh, params, placed, batches, placed_batches = _sharded_yi(dev)
    tc = TrainConfig(opt=OptimizerConfig(lr=2e-3, warmup_steps=3,
                                         total_steps=30))
    step_u = make_train_step(cfg, dataclasses.replace(tc, microbatches=2))
    step_s = make_train_step(cfg, tc)
    su, ss = opt_mod.init(params), opt_mod.init(placed)
    for b, pb in zip(batches, placed_batches):
        params, su, mu = step_u(params, su, b)
        placed, ss, ms = step_s(placed, ss, pb)
        lu, ls = float(mu["loss"]), float(ms["loss"])
        gu, gs = float(mu["grad_norm"]), float(ms["grad_norm"])
        assert abs(lu - ls) <= 1e-6 * abs(lu), (lu, ls)
        assert abs(gu - gs) <= 1e-5 * abs(gu), (gu, gs)
        for tu, ts in ((params, placed), (su.m, ss.m), (su.v, ss.v)):
            for a, st in zip(tree_leaves(tu), tree_leaves(ts)):
                assert all(blk.is_cuda for blk in st.blocks())
                err = (a - st.gather()).abs().max()
                assert float(err) <= 1e-6 * float(a.abs().max())
    assert int(ss.step.gather()) == 3


def test_sharded_checkpoint_on_card_round_trips(dev, tmp_path):
    """The (2, 2) state saved as sharded leaves loads bit-equal with
    ``shardings=`` onto the (3, 1) mesh of ``elastic_mesh(["cuda:0"] *
    3, model_axis=2)`` (d_model 128 does not split by 3: replicated), and
    without them onto its own placements."""
    from repro_torch.models import NamedSharding, PartitionSpec, sharding_tree
    from repro_torch.models.params import tree_leaves
    from repro_torch.train import AdamState, elastic_mesh
    from repro_torch.train import optimizer as opt_mod
    from repro_torch.train.checkpoint import Checkpointer, _leaf_paths
    cfg, mesh, _, placed, _, _ = _sharded_yi(dev)
    state = opt_mod.init(placed)
    for t in tree_leaves(state.v):
        for blk in t.blocks():
            blk.uniform_()
    ck = Checkpointer(str(tmp_path), async_write=False)
    ck.save(1, placed, state)
    saved = {n: t.gather() for n, t in
             _leaf_paths({"params": placed, "opt_state": state})}
    mesh3 = elastic_mesh([dev] * 3, model_axis=2)
    assert mesh3.shape == {"data": 3, "model": 1}
    sh = sharding_tree(model_schema(cfg), mesh3)
    rep = NamedSharding(mesh3, PartitionSpec())
    for shardings, want_mesh in (((sh, AdamState(rep, sh, sh)), mesh3),
                                 (None, mesh)):
        step, tree = ck.load(like=(placed, state), shardings=shardings)
        assert step == 1
        for name, leaf in _leaf_paths(tree):
            assert leaf.sharding.mesh is want_mesh
            assert all(blk.is_cuda for blk in leaf.blocks())
            assert torch.equal(leaf.gather(), saved[name]), name


# ---------------------------------------------------------------------------
# the op-level cost counter (launch/op_cost.py): one charge a kernel call
# ---------------------------------------------------------------------------

def _charge_cases(dev):
    """(entry point, args, kwargs, kernel) at small shapes the kernels take,
    on ``dev``."""
    g = torch.Generator(device=dev).manual_seed(7)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev)

    def ids(lo, hi, *shape):
        return torch.randint(lo, hi, shape, generator=g, device=dev,
                             dtype=torch.int32)
    n_big, dp, n, c, w, k = 300, 32, 40, 12, 50, 10
    x, q = randn(n_big, dp), randn(16, dp)
    x2, q2 = (x * x).sum(1), (q * q).sum(1)
    cd = torch.sort(torch.rand(n, k, generator=g, device=dev), 1).values
    ci, cand_i = ids(0, n_big, n, k), ids(-1, n_big, n, 20)
    cand_d = torch.rand(n, 20, generator=g, device=dev)
    rows = torch.tensor([3, 0, -1, 17], dtype=torch.int32, device=dev)
    drop = torch.rand(n, k, generator=g, device=dev) < 0.3
    xs8, qs8 = _mirror(dev, n_big, dp, "int8", 1), _mirror(dev, 16, dp,
                                                           "int8", 2)
    xsb, qsb = _mirror(dev, n_big, dp, "bf16", 3), _mirror(dev, 16, dp,
                                                           "bf16", 4)
    jids, sids = ids(-1, n_big, n, c), ids(-1, n_big, 16, w)
    att = [randn(1, 130, h, 64).bfloat16() for h in (4, 2, 2)]
    att32 = [randn(2, 70, h, 32) for h in (4, 2, 2)]
    return {
        "knn_join_dists": (ops.knn_join_dists, (x, x2, jids, 6), {},
                           "knn_join_dists"),
        "knn_join_select": (ops.knn_join_select, (
            torch.rand(n, w, generator=g, device=dev), ids(-1, n_big, n, w),
            torch.full((n,), 0.8, device=dev), 12), {}, "knn_join_select"),
        "knn_merge": (ops.knn_merge, (cd, ci, cand_d, cand_i), {},
                      "knn_merge"),
        "knn_merge_rows": (ops.knn_merge_rows, (
            cd, ci, rows, cand_d[:4], cand_i[:4]), {}, "knn_merge_rows"),
        "knn_compact": (ops.knn_compact, (cd, ci, drop), {}, "knn_compact"),
        "knn_compact_rows": (ops.knn_compact_rows, (cd, ci, rows, drop[:4]),
                             {}, "knn_compact_rows"),
        "pairwise_sq_l2": (ops.pairwise_sq_l2, (q, x), {}, "pairwise_sq_l2"),
        "centroid_assign": (ops.centroid_assign, (q, q2, x, x2), {"t": 2},
                            "pairwise_sq_l2"),
        "knn_search_dists": (ops.knn_search_dists, (q, q2, x, x2, sids), {},
                             "knn_search_dists"),
        "knn_search_dists_q8": (ops.knn_search_dists_q8, (
            qs8.data, qs8.scale, qs8.x2, xs8.data, xs8.scale, xs8.x2, sids),
            {}, "knn_search_dists_q8"),
        "knn_search_dists_bf16": (ops.knn_search_dists_bf16, (
            qsb.data, qsb.x2, xsb.data, xsb.x2, sids), {},
            "knn_search_dists_bf16"),
        "knn_join_dists_q8": (ops.knn_join_dists_q8, (
            xs8.data, xs8.scale, xs8.x2, jids, 6), {}, "knn_join_dists_q8"),
        "knn_join_dists_bf16": (ops.knn_join_dists_bf16, (
            xsb.data, xsb.x2, jids, 6), {}, "knn_join_dists_bf16"),
        "attention_bf16": (ops.attention, tuple(att),
                           {"causal": True, "window": 50},
                           "flash_attention"),
        "attention_f32": (ops.attention, tuple(att32),
                          {"causal": True, "q_offset": 3},
                          "flash_attention"),
    }


CHARGE_CASES = (
    "attention_bf16", "attention_f32", "centroid_assign", "knn_compact",
    "knn_compact_rows", "knn_join_dists", "knn_join_dists_bf16",
    "knn_join_dists_q8", "knn_join_select", "knn_merge", "knn_merge_rows",
    "knn_search_dists", "knn_search_dists_bf16", "knn_search_dists_q8",
    "pairwise_sq_l2")


@pytest.mark.parametrize("case", CHARGE_CASES)
def test_counter_charge_on_card_equals_plain_on_cpu(dev, case):
    """Each ``ops`` entry point charges its kernel's formula once, and the
    aten ops under it nothing: on the card, where the kernel launches,
    the count equals the plain version's on CPU copies of the inputs."""
    from repro_torch.launch import op_cost
    cases = _charge_cases(dev)
    assert sorted(cases) == sorted(CHARGE_CASES)
    fn, args, kw, kernel = cases[case]
    before = dict(_lib.LAUNCHES)
    on_card = op_cost.analyze(fn, *args, **kw)
    torch.cuda.synchronize()
    assert _lib.LAUNCHES[kernel] > before[kernel]
    cpu = tuple(a.cpu() if isinstance(a, torch.Tensor) else a for a in args)
    on_cpu = op_cost.analyze(fn, *cpu, **kw)
    for cost in (on_card, on_cpu):
        assert cost.ops == 1 and dict(cost.kernels) == {kernel: 1}
    assert (on_card.flops, on_card.bytes, dict(on_card.flops_by_dtype)) == \
        (on_cpu.flops, on_cpu.bytes, dict(on_cpu.flops_by_dtype))
    assert on_card.bytes > 0
