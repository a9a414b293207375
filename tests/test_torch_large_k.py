"""The build at the large k of neighbour-graph users (t-SNE asks for k =
91 at its default perplexity of 30: C = 92 candidates at rho 0.5, a
receiver select of 2 C x C = 16928 and a polish select of k^2 = 8281),
the port against the JAX package on the CPU, on the same numpy inputs and
the JAX build's own draws.

Tolerances: ids, counts and evals exact; join distances rtol 1e-5 / atol
1e-4 (sums in another order), int8 bitwise; selects bitwise; the build's
lists slot by slot as tests/test_torch_build.py holds them; polish ids
and counts exact, distances rtol 1e-5 / atol 1e-4; the merges above a
pool of 8192 (the online store's k + k^2 = 8372 at k 91) ids and counts
exact, distances equal (a merge only copies them)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import datasets as jdatasets
from repro.core import heap as jheap
from repro.core import nn_descent as jnd
from repro.core import quantize as jq
from repro.core.layout import pad_features as jpad_features
from repro.core.recall import brute_force_knn as jbrute_force_knn
from repro.kernels import ref as jref
from repro_torch import DescentConfig, build_knn_graph, recall_at_k
from repro_torch.core import heap, nn_descent
from repro_torch.kernels import ref as tref
from test_torch_build import _jax_draws

K = 91                      # t-SNE's k at perplexity 30


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _t(a):
    a = np.asarray(a)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.view(np.uint16).astype(np.int32)).to(
            torch.int16).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("mode", ["f32", "int8", "bf16"])
@pytest.mark.parametrize("c", [92, 180])
def test_join_plain_at_large_c_matches_jax(c, mode):
    """The plain joins at C 92 (k 91) and 180 against the JAX oracles, on
    gathered rows with invalid slots, a repeated id and an all-invalid
    row; "half" of the slots new."""
    n, big_n, dp, cn = 6, 400, 64, c // 2
    rng = np.random.RandomState(c)
    x = rng.randn(big_n, dp).astype(np.float32)
    ids = rng.randint(-1, big_n, size=(n, c)).astype(np.int32)
    ids[3] = -1
    ids[1, c - 1] = ids[1, 0]
    valid = ids >= 0
    safe = np.where(valid, ids, 0)
    if mode == "f32":
        x2 = (x * x).sum(1).astype(np.float32)
        x2g = np.where(valid, x2[safe], 0.0).astype(np.float32)
        wd, wev = jref.knn_join_dists(jnp.asarray(x[safe]), jnp.asarray(x2g),
                                      jnp.asarray(ids), cn)
        td, tev = tref.knn_join_dists(_t(x), _t(x2), _t(ids), cn)
    else:
        base = jq.quantize_corpus(jnp.asarray(x), mode)
        x2g = jnp.where(jnp.asarray(valid), base.x2[safe], 0.0)
        if mode == "int8":
            wd, wev = jref.knn_join_dists_q8(base.data[safe],
                                             base.scale[safe], x2g,
                                             jnp.asarray(ids), cn)
            td, tev = tref.knn_join_dists_q8(_t(base.data), _t(base.scale),
                                             _t(base.x2), _t(ids), cn)
        else:
            wd, wev = jref.knn_join_dists_bf16(base.data[safe], x2g,
                                               jnp.asarray(ids), cn)
            td, tev = tref.knn_join_dists_bf16(_t(base.data), _t(base.x2),
                                               _t(ids), cn)
    wd, td = np.asarray(wd), td.numpy()
    np.testing.assert_array_equal(tev.numpy(), np.asarray(wev))
    np.testing.assert_array_equal(np.isinf(td), np.isinf(wd))
    if mode == "int8":
        np.testing.assert_array_equal(td, wd)
    else:
        fin = np.isfinite(wd)
        np.testing.assert_allclose(td[fin], wd[fin], rtol=1e-5, atol=1e-4)
    assert int(tev[3]) == 0 and int(tev.sum()) > 0


@pytest.mark.parametrize("w,c", [
    (16928, 273),           # k 91: the receiver select, c = merge_k
    (8281, 546),            # k 91: the polish select, c = 6k
    (64800, 540)])          # C 180: the receiver select
def test_select_plain_at_large_w_matches_jax(w, c):
    """The plain select at the streamed widths against the JAX oracle on
    rows of ties (six values), +inf pads, ids -1 and a prefilter."""
    n = 4
    rng = np.random.RandomState(w + c)
    gd = (rng.randint(0, 6, size=(n, w)) / 4.0).astype(np.float32)
    gd[rng.rand(n, w) < 0.2] = np.inf
    gi = rng.randint(-1, 99, size=(n, w)).astype(np.int32)
    kth = np.array([np.inf, 0.6, 1.1, 0.3], np.float32)
    wd, wi = jref.knn_join_select(jnp.asarray(gd), jnp.asarray(gi),
                                  jnp.asarray(kth), c)
    td, ti = tref.knn_join_select(_t(gd), _t(gi), _t(kth), c)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(td.numpy(), np.asarray(wd))


def test_build_at_k91_matches_jax():
    """A whole k = 91 build (rho 0.5: C 92, merge_k 273, receiver select
    W 16928) on 256 seeded rows, polish off, fed the JAX build's draws:
    the JAX build's recall within 0.002, the lists slot by slot, the same
    iterations, evals within 1%."""
    n = 256
    x = np.array(jdatasets.clustered(jax.random.key(11), n, 16, 8))
    _, ti = jbrute_force_knn(jnp.asarray(x), jnp.asarray(x), K)
    ti = torch.from_numpy(np.array(ti))
    jcfg = jnd.DescentConfig(k=K, polish=0, max_iters=4)
    _, jidx, jst = jnd.build_knn_graph(jnp.asarray(x), k=K, cfg=jcfg,
                                       key=jax.random.key(5))
    jidx = torch.from_numpy(np.array(jidx))
    cfg = DescentConfig(k=K, polish=0, max_iters=4)
    assert 2 * cfg.rho_k == 92 and 2 * 92 * 92 == 16928
    _, idx, st = build_knn_graph(
        x, k=K, cfg=cfg, device="cpu",
        draws=_jax_draws(jax.random.key(5), n, K, cfg.max_iters))
    r_port, r_jax = recall_at_k(idx, ti), recall_at_k(jidx, ti)
    assert abs(r_port - r_jax) <= 0.002, (r_port, r_jax)
    assert (idx == jidx).float().mean() >= 0.99
    assert st.iters == jst.iters
    assert abs(st.dist_evals - jst.dist_evals) <= 0.01 * jst.dist_evals


def _polish_case(n):
    """Gaussian rows of d 16 (dp 128) with small norms, so ids can be held
    exactly, and random k = 91 lists over them."""
    x = np.asarray(jdatasets.gaussian(jax.random.key(4), n, 16))
    xp = np.asarray(jpad_features(jnp.asarray(x)))
    x2 = (xp * xp).sum(1).astype(np.float32)
    jnl = jax.jit(jheap.init_random_with_dists, static_argnums=(2,))(
        jax.random.key(6), jnp.asarray(xp), K)
    return xp, x2, jnl


def test_polish_at_k91_matches_jax():
    """One exhaustive polish round at k 91 (W = k^2 = 8281, c = 6k = 546)
    on 128 rows (JAX's (n, k^2, dp) gather is 0.54 GB): ids, flags,
    accepted and evals exact, distances rtol 1e-5."""
    xp, x2, jnl = _polish_case(128)
    want, wu, we = jnd.polish_iteration(jnp.asarray(xp), jnp.asarray(x2),
                                        jnl, "auto")
    tnl = heap.neighbor_lists_from_numpy(*(np.asarray(a) for a in jnl))
    got, gu, ge = nn_descent.polish_iteration(_t(xp), _t(x2), tnl)
    gd, gi, gn = got.to_numpy()
    wd, wi, wn = (np.asarray(a) for a in want)
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_array_equal(gn, wn)
    np.testing.assert_array_equal(np.isinf(gd), np.isinf(wd))
    fin = np.isfinite(wd)
    np.testing.assert_allclose(gd[fin], wd[fin], rtol=1e-5, atol=1e-4)
    assert gu == int(wu) and ge == int(we)


def test_polish_chunk_by_bytes_is_one_chunk(monkeypatch):
    """A polish whose byte budget cuts its 128 rows into gathers of 8 rows
    and merges of 113 gives the one-chunk polish bit for bit; the gathers
    are the ones the budget names."""
    # the k = 20 build keeps its 2048-row chunks at dp 896 (2.9 GB)
    assert nn_descent.POLISH_CHUNK_BYTES // (4 * 20 * 20 * 896) >= 2048
    xp, x2, jnl = _polish_case(128)
    tnl = heap.neighbor_lists_from_numpy(*(np.asarray(a) for a in jnl))
    one = nn_descent.polish_iteration(_t(xp), _t(x2), tnl)
    batches = []
    bmm = torch.bmm

    def counted(a, b):
        batches.append(a.shape[0])
        return bmm(a, b)
    monkeypatch.setattr(torch, "bmm", counted)
    budget = 8 * 4 * K * K * xp.shape[1] + 5
    monkeypatch.setattr(nn_descent, "POLISH_CHUNK_BYTES", budget)
    cut = nn_descent.polish_iteration(_t(xp), _t(x2), tnl)
    assert batches == [8] * 16
    assert budget // (6 * K) ** 2 == 113      # merges of 113 and 15 rows
    for a, b in zip(one[0], cut[0]):
        assert torch.equal(a, b)
    assert one[1:] == cut[1:]


@pytest.mark.parametrize("form", ["dense", "rows"])
@pytest.mark.parametrize("c", [K * K, 12000])
def test_merge_plain_at_wide_pools_matches_jax(c, form):
    """The plain merge and row merge at the online store's pool at k 91
    (8372) and past the wide merge's shared-memory instance (12091)
    against the JAX oracles on the same rows: ties, repeated candidate
    ids, candidate ids from the list, ids -1, -0.0 / +0.0 and 3e38
    placeholders; finite slots by id and value, the JAX oracle's +inf
    slots -1 here, accepted counts exact."""
    n, k = 6, K
    rng = np.random.RandomState(c)
    cur_d = np.sort(rng.rand(n, k).astype(np.float32), axis=1)
    cur_i = rng.randint(0, 4 * c, size=(n, k)).astype(np.int32)
    cand_d = (np.round(rng.rand(n, c) * 16) / 16).astype(np.float32)
    cand_i = rng.randint(-1, 4 * c, size=(n, c)).astype(np.int32)
    cur_d[0], cand_d[0] = 0.5, 0.5                        # ties
    cand_i[1] = rng.randint(0, 8, size=c)                 # repeats
    cand_i[2] = cur_i[2, rng.randint(0, k, size=c)]       # list ids
    cand_i[3, rng.rand(c) < 0.5] = -1                     # invalid
    cand_d[4] = np.where(rng.rand(c) < 0.5, -0.0, 0.0)    # signed zeros
    cur_d[4, :10] = -0.0
    cur_d[5, k - 4:] = np.float32(3.0e38)                 # placeholders
    cand_d[5, ::3] = np.float32(3.0e38)
    if form == "dense":
        jd, ji, ju = jref.knn_merge(*(jnp.asarray(a) for a in (
            cur_d, cur_i, cand_d, cand_i)))
        td, ti, tu = tref.knn_merge(*(_t(a) for a in (cur_d, cur_i, cand_d,
                                                      cand_i)))
    else:
        big_d = np.sort(rng.rand(3 * n, k).astype(np.float32), axis=1)
        big_i = rng.randint(0, 4 * c, size=(3 * n, k)).astype(np.int32)
        rows = rng.choice(3 * n, size=n, replace=False).astype(np.int32)
        big_d[rows], big_i[rows] = cur_d, cur_i
        rows[1] = -1                                      # a padding slot
        jd, ji, ju = jref.knn_merge_rows(*(jnp.asarray(a) for a in (
            big_d, big_i, rows, cand_d, cand_i)))
        td, ti, tu = tref.knn_merge_rows(*(_t(a) for a in (
            big_d, big_i, rows, cand_d, cand_i)))
    jd, ji, ju = (np.asarray(a) for a in (jd, ji, ju))
    td, ti, tu = td.numpy(), ti.numpy(), tu.numpy()
    fin = np.isfinite(jd)
    np.testing.assert_array_equal(np.isfinite(td), fin)
    np.testing.assert_array_equal(td[fin], jd[fin])
    np.testing.assert_array_equal(ti[fin], ji[fin])
    assert (ti[~fin] == -1).all()
    np.testing.assert_array_equal(tu, ju)
    assert tu.sum() > 0
