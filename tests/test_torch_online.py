"""The port's online store (repro_torch.core.online) and its three kernels'
plain versions (knn_compact, knn_merge_rows, knn_compact_rows), against
the JAX package on the same numpy inputs, the same store state
(``store_from_numpy``) and the same draws, plus the JAX online tests' own
floors re-held on the port.

The corpus is the JAX tests' 563 x 16 ``clustered`` blob split (512 built,
51 inserted), K = 10.

Tolerances: ids, flags, counts and DescentStats (dist_evals, updates,
frontier_rows, padded_rows) exact; distances a kernel only moves exact;
computed distances within 1e-4 + 1e-5 (|a|^2 + |b|^2) (these corpora have
large norms, whose expansion cancels the digits the norms share; ROADMAP
Queue 3). The JAX merge oracle can leave a stale id beside +inf where the
kernels write -1 (ROADMAP Queue 3), so list ids are compared on finite
slots and the port's must be -1 wherever its distance is +inf."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import datasets as jdatasets
from repro.core import heap as jheap
from repro.core import nn_descent as jnd
from repro.core import online as jon
from repro.core import router as jr
from repro.core.graph_search import _draw_entries as jdraw_entries
from repro.core.graph_search import expand_frontier as jexpand_frontier
from repro.kernels import ref as jref
from repro.kernels.knn_merge import (
    knn_compact_blocked,
    knn_compact_rows_blocked,
    knn_merge_rows_blocked,
)
from repro_torch import (
    DescentConfig,
    MutableKNNStore,
    OnlineConfig,
    RouterConfig,
    brute_force_knn,
    build_knn_graph,
    ensure_router,
    expand_frontier,
    knn_delete,
    knn_insert,
    recall_at_k,
    store_from_numpy,
)
from repro_torch.core import faults, heap
from repro_torch.core.nn_descent import compact_pairs
from repro_torch.kernels import ops, ref

K = 10


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def blob():
    """The JAX tests' blob split and the JAX graph of its first 512 rows."""
    x = jdatasets.clustered(jax.random.key(3), 563, 16, 8)
    dist, idx, _ = jnd.build_knn_graph(
        x[:512], k=K, cfg=jnd.DescentConfig(k=K, rho=1.0, max_iters=15),
        key=jax.random.key(1))
    return np.asarray(x), np.asarray(dist), np.asarray(idx)


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _lists_equal(got, want):
    """(dist, idx) lists: ids equal on finite slots, -1 where +inf,
    distances exact (moved, not computed)."""
    gd, gi = (np.asarray(a) for a in got)
    wd, wi = (np.asarray(a) for a in want)
    np.testing.assert_array_equal(np.isinf(gd), np.isinf(wd))
    fin = np.isfinite(wd)
    np.testing.assert_array_equal(gi[fin], wi[fin])
    np.testing.assert_array_equal(gd[fin], wd[fin])
    assert (gi[~fin] == -1).all()


def _random_lists(rng, n, k, hi, sort=True):
    d = rng.random((n, k)).astype(np.float32)
    if sort:
        d = np.sort(d, axis=1)
    i = rng.integers(-1, hi, (n, k)).astype(np.int32)
    return d, i


# ---------------------------------------------------------------------------
# the three kernels' plain versions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,k,sort", [(37, 8, True), (40, 20, False),
                                      (9, 33, True)])
def test_compact_plain_matches_jax(n, k, sort):
    """Against ``ref.knn_compact`` and the Pallas kernel in interpret
    mode: the placeholder survives, empty slots stay empty, an unsorted
    row comes out ascending."""
    rng = np.random.default_rng(n + k)
    d, i = _random_lists(rng, n, k, 50, sort)
    d[5, -1], i[5, -1] = 3.0e38, 42         # a valid placeholder entry
    d[6, -1] = np.inf
    d[7, :] = d[7, ::-1].copy()             # a descending row
    drop = rng.random((n, k)) < 0.3
    drop[5, -1] = False
    got = ref.knn_compact(*_t(d, i, drop))
    want_ref = jref.knn_compact(*map(jnp.asarray, (d, i, drop)))
    want_krn = knn_compact_blocked(*map(jnp.asarray, (d, i, drop)), tm=16,
                                   interpret=True)
    for want in (want_ref, want_krn):
        _lists_equal(got[:2], want[:2])
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert got[1][5].eq(42).any()
    fin = torch.isfinite(got[0])
    assert (got[0][:, 1:] >= got[0][:, :-1])[fin[:, 1:]].all()


# entries the compaction orders by its contract: -0.0 tied with +0.0 (each
# read back with its stored sign), survivors at FLT_MAX and at the 3e38
# placeholder, and -inf, NaN and +inf, which never survive
F32_MAX = np.finfo(np.float32).max
EDGES = np.array([-0.0, 0.0, -0.0, F32_MAX, 3.0e38, -np.inf, np.nan, np.inf,
                  0.0], np.float32)


def _order_bits(d):
    """csrc/knn_kernels.cu's order_bits: f32 -> u32 in the same order, -0
    as +0."""
    b = np.where(d == 0, np.float32(0.0), d).astype(np.float32).view(
        np.uint32)
    return np.where(b & 0x80000000, ~b, b | 0x80000000).astype(np.uint32)


def _compact_select_emulation(d, i, drop):
    """The compaction as the CUDA kernel runs it: one row of the radix
    select with c = k, every entry keyed by ``_order_bits`` of its distance
    if it survives (not dropped, id >= 0, finite), else by +inf's bits;
    with c = k every key below +inf's wins, ranked by (key, position), and
    each winner's stored distance and id read back; freed slots (+inf,
    -1); removed = dropped entries with id >= 0."""
    n, k = d.shape
    big = _order_bits(np.array([np.inf], np.float32))[0]
    keep = ~drop & (i >= 0) & np.isfinite(d)
    key = np.where(keep, _order_bits(d), big)
    od = np.full((n, k), np.inf, np.float32)
    oi = np.full((n, k), -1, np.int32)
    for r in range(n):
        words = (key[r].astype(np.uint64) << np.uint64(32)) | np.arange(
            k, dtype=np.uint64)
        win = words[key[r] < big]
        rank = (win[None, :] < win[:, None]).sum(1)
        pos = (win & np.uint64(0xffffffff)).astype(np.int64)
        od[r, rank] = d[r, pos]
        oi[r, rank] = i[r, pos]
    removed = (drop & (i >= 0)).sum(1).astype(np.int32)
    return od, oi, removed


@pytest.mark.parametrize("n,k", [(12, 1), (20, 8), (16, 20), (9, 33),
                                 (8, 64)])
def test_compact_select_emulation_matches_jax(n, k):
    """``_compact_select_emulation`` bitwise (the sign of a zero too)
    against the port's plain version on rows that hold every EDGES entry
    (k 1 spreads them over nine rows), and against the Pallas kernel in
    interpret mode and JAX's oracle where those keep the contract. The
    Pallas kernel returns min(-0, +0) and not the stored value, so its
    zeros are compared by value; it loses a survivor at exactly FLT_MAX
    (its sentinel: an argmin ties it with the taken entries), and JAX's
    oracle keeps -inf and NaN distances beside id -1, so those rows are
    held against the port's plain version alone (ROADMAP, Reference-side
    caveats)."""
    rng = np.random.default_rng(n * k)
    d, i = _random_lists(rng, n, k, 50, sort=False)
    d[rng.random((n, k)) < 0.2] = 0.0
    drop = rng.random((n, k)) < 0.3
    for s, v in enumerate(EDGES):
        r, p = 1 + s // k, s % k
        d[r, p], i[r, p], drop[r, p] = v, 3 + s, False
    got = _compact_select_emulation(d, i, drop)
    plain = ref.knn_compact(*_t(d, i, drop))
    for g, w in zip(got, plain):
        np.testing.assert_array_equal(g, w.numpy())
    np.testing.assert_array_equal(np.signbit(got[0]),
                                  np.signbit(plain[0].numpy()))
    jargs = [jnp.asarray(a) for a in (d, i, drop)]
    krn = [np.asarray(a) for a in knn_compact_blocked(*jargs, tm=8,
                                                      interpret=True)]
    orc = [np.asarray(a) for a in jref.knn_compact(*jargs)]
    keep = ~drop & (i >= 0)
    at_max = (keep & (d == F32_MAX)).any(1)
    non_finite = (keep & ~np.isfinite(d)).any(1)
    assert at_max.any() and non_finite.any()
    for r in range(n):
        if not at_max[r]:
            np.testing.assert_array_equal(got[0][r], krn[0][r])   # -0 == 0
            np.testing.assert_array_equal(got[1][r], krn[1][r])
        if not non_finite[r]:
            for g, w in zip(got[:2], orc[:2]):
                np.testing.assert_array_equal(g[r], w[r])
            np.testing.assert_array_equal(np.signbit(got[0][r]),
                                          np.signbit(orc[0][r]))
    np.testing.assert_array_equal(got[2], krn[2].reshape(-1))
    np.testing.assert_array_equal(got[2], orc[2])


@pytest.mark.parametrize("n,k,f,c,pad", [(41, 6, 16, 9, 3), (64, 10, 8, 40, 0),
                                         (30, 20, 12, 1, 5)])
def test_merge_rows_plain_matches_jax(n, k, f, c, pad):
    """Against ``ref.knn_merge_rows`` and the Pallas row form (interpret):
    padding slots count 0, rows off the frontier pass through."""
    rng = np.random.default_rng(n * f)
    d, i = _random_lists(rng, n, k, 60)
    rows = np.full((f,), -1, np.int32)
    rows[:f - pad] = rng.choice(n, size=f - pad, replace=False)
    cd = rng.random((f, c)).astype(np.float32)
    ci = rng.integers(-1, 60, (f, c)).astype(np.int32)
    args = (d, i, rows, cd, ci)
    got = ref.knn_merge_rows(*_t(*args))
    want_ref = jref.knn_merge_rows(*map(jnp.asarray, args))
    want_krn = knn_merge_rows_blocked(*map(jnp.asarray, args), tm=8,
                                      interpret=True)
    _lists_equal(got[:2], want_krn[:2])
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want_krn[2]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want_ref[2]))
    off = np.setdiff1d(np.arange(n), rows[rows >= 0])
    np.testing.assert_array_equal(got[1].numpy()[off], i[off])
    np.testing.assert_array_equal(got[0].numpy()[off], d[off])


@pytest.mark.parametrize("n,k,f,pad,sort", [(29, 8, 12, 2, True),
                                            (50, 20, 20, 4, False)])
def test_compact_rows_plain_matches_jax(n, k, f, pad, sort):
    rng = np.random.default_rng(n + f)
    d, i = _random_lists(rng, n, k, 40, sort)
    rows = np.full((f,), -1, np.int32)
    rows[pad:] = rng.choice(n, size=f - pad, replace=False)
    drop = rng.random((f, k)) < 0.4
    args = (d, i, rows, drop)
    got = ref.knn_compact_rows(*_t(*args))
    for want in (jref.knn_compact_rows(*map(jnp.asarray, args)),
                 knn_compact_rows_blocked(*map(jnp.asarray, args), tm=8,
                                          interpret=True)):
        _lists_equal(got[:2], want[:2])
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


def test_ops_dispatch_online_kernels_on_cpu():
    """CPU tensors take the plain versions under auto, as under ref."""
    rng = np.random.default_rng(3)
    d, i = _random_lists(rng, 16, 6, 20)
    rows = np.array([3, -1, 7, 0], np.int32)
    cd, ci = rng.random((4, 5)).astype(np.float32), \
        rng.integers(-1, 20, (4, 5)).astype(np.int32)
    drop = rng.random((16, 6)) < 0.3
    for name, args in (("knn_merge_rows", (d, i, rows, cd, ci)),
                       ("knn_compact", (d, i, drop)),
                       ("knn_compact_rows", (d, i, rows, drop[:4]))):
        a = getattr(ops, name)(*_t(*args))
        b = getattr(ops, name)(*_t(*args), backend="ref")
        assert all(torch.equal(x, y) for x, y in zip(a, b))


# ---------------------------------------------------------------------------
# heap row forms, expand_frontier, compact_pairs
# ---------------------------------------------------------------------------

def _nl_pair(rng, n, k, hi):
    d, i = _random_lists(rng, n, k, hi)
    new = rng.random((n, k)) < 0.5
    return (jheap.NeighborLists(*map(jnp.asarray, (d, i, new))),
            heap.NeighborLists(*_t(d, i, new)))


def _nl_equal(got, want):
    _lists_equal(got[:2], want[:2])
    np.testing.assert_array_equal(got.new.numpy(), np.asarray(want.new))


def test_heap_merge_rows_purge_rows_purge_match_jax():
    """Lists, flags and counts of the frontier merge, the frontier purge
    and the dense purge, id for id."""
    rng = np.random.default_rng(7)
    n, k, f, c = 48, 8, 12, 11
    jnl, tnl = _nl_pair(rng, n, k, n)
    rows = np.full((f,), -1, np.int32)
    rows[:9] = np.sort(rng.choice(n, 9, replace=False))
    cd = rng.random((f, c)).astype(np.float32)
    ci = rng.integers(-1, n, (f, c)).astype(np.int32)
    jm, ju = jheap.merge_rows(jnl, *map(jnp.asarray, (rows, cd, ci)))
    tm, tu = heap.merge_rows(tnl, *_t(rows, cd, ci))
    _nl_equal(tm, jm)
    np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))
    alive = rng.random(n) < 0.7
    jp, jrm = jheap.purge_rows(jm, jnp.asarray(rows), jnp.asarray(alive))
    tp, trm = heap.purge_rows(tm, *_t(rows, alive))
    _nl_equal(tp, jp)
    np.testing.assert_array_equal(trm.numpy(), np.asarray(jrm))
    jq, jrq = jheap.purge(jm, jnp.asarray(alive))
    tq, trq = heap.purge(tm, torch.from_numpy(alive))
    _nl_equal(tq, jq)
    np.testing.assert_array_equal(trq.numpy(), np.asarray(jrq))


@pytest.mark.parametrize("hops,capacity,with_alive", [
    (1, 64, False), (2, 200, True), (2, 24, False), (3, 400, True)])
def test_expand_frontier_matches_jax(hops, capacity, with_alive):
    """Ids and mask of the h-hop closure, the truncated (overflow) case
    included: the rows nearest the seeds are kept."""
    rng = np.random.default_rng(hops * capacity)
    n, k = 300, 6
    idx = rng.integers(-1, n, (n, k)).astype(np.int32)
    seeds = np.array([5, 17, -1, 250, 17 + 1, -1], np.int32)
    alive = rng.random(n) < 0.8 if with_alive else None
    jids, jmask = jexpand_frontier(
        jnp.asarray(idx), jnp.asarray(seeds), hops=hops, capacity=capacity,
        alive=None if alive is None else jnp.asarray(alive))
    tids, tmask = expand_frontier(
        torch.from_numpy(idx), torch.from_numpy(seeds), hops=hops,
        capacity=capacity,
        alive=None if alive is None else torch.from_numpy(alive))
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))


def test_expand_frontier_overflow_prefers_near_hops():
    """The JAX test's graph: on overflow the 1-hop ring is kept."""
    idx = torch.full((10, 2), -1, dtype=torch.int32)
    idx[0] = torch.tensor([8, 9])
    idx[8] = torch.tensor([1, 2])
    idx[9] = torch.tensor([3, -1])
    ids, mask = expand_frontier(idx, torch.tensor([0], dtype=torch.int32),
                                hops=2, capacity=3)
    assert ids.tolist() == [0, 8, 9]
    assert int(mask.sum()) == 6


@pytest.mark.parametrize("m,n,c", [(200, 30, 4), (64, 8, 16)])
def test_compact_pairs_matches_jax(m, n, c):
    rng = np.random.default_rng(m)
    recv = rng.integers(-1, n, m).astype(np.int32)
    cand = rng.integers(0, 1000, m).astype(np.int32)
    dist = rng.random(m).astype(np.float32)
    dist[::6] = dist[1]                      # ties: input order decides
    jd, ji = jnd.compact_pairs(*map(jnp.asarray, (recv, cand, dist)), n, c)
    td, ti = compact_pairs(*_t(recv, cand, dist), n, c)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))


# ---------------------------------------------------------------------------
# insert and delete from the same state as the JAX package
# ---------------------------------------------------------------------------

CASES = {
    "plain": ({}, {}),
    "router": ({"router": jr.RouterConfig()}, {"router": RouterConfig()}),
    "ref": ({"backend": "ref"}, {"backend": "ref"}),
    "int8": ({"precision": "int8"}, {"precision": "int8"}),
    "small_chunk": ({"chunk": 64}, {"chunk": 64}),
}


def _port_of(js, tcfg):
    """The port's store with a JAX store's state."""
    r = js.router
    rtr = None if r is None else (r.centroids, r.c2, r.graph,
                                  tuple(r.members), r.assign, r.counts,
                                  r.stale)
    return store_from_numpy(js.x, js.x2, tuple(js.nl), js.alive, n=js.n,
                            d=js.d, cfg=tcfg, mips_m=js.mips_m,
                            qs=None if js.qs is None else tuple(js.qs),
                            router=rtr, device="cpu")


def _seed_draw(js, m, key):
    """The seed search's draw in the JAX package's knn_insert: shared
    entries, or with a router the hole fill."""
    jg = jon._grown(js, js.n + m)
    beam = max(js.cfg.beam, js.k)
    if js.router is None:
        return {"entry": np.asarray(jdraw_entries(key, jg.capacity, beam,
                                                  jg.alive))}
    t = min(4, js.router.centroids.shape[0])
    width = min(max(beam, t * js.router.members.idx.shape[1]), jg.capacity)
    return {"route_fill": np.asarray(jdraw_entries(key, jg.capacity, width,
                                                   jg.alive))}


def _stats_equal(got, want):
    for name in ("iters", "dist_evals", "updates", "frontier_rows",
                 "padded_rows"):
        assert getattr(got, name) == getattr(want, name), name


def _store_close(ts, js):
    """Lists (computed distances to tolerance), flags, alive, rows."""
    jd, ji = np.asarray(js.nl.dist), np.asarray(js.nl.idx)
    td, ti = ts.nl.dist.numpy(), ts.nl.idx.numpy()
    np.testing.assert_array_equal(np.isinf(td), np.isinf(jd))
    fin = np.isfinite(jd)
    np.testing.assert_array_equal(ti[fin], ji[fin])
    assert (ti[~fin] == -1).all()
    x2 = np.asarray(js.x2)
    tol = 1e-4 + 1e-5 * (x2[:, None] + x2[ji.clip(0)])
    assert (np.abs(td[fin] - jd[fin]) <= tol[fin]).all()
    np.testing.assert_array_equal(ts.nl.new.numpy(), np.asarray(js.nl.new))
    np.testing.assert_array_equal(ts.alive.numpy(), np.asarray(js.alive))
    np.testing.assert_array_equal(ts.x.numpy(), np.asarray(js.x))
    assert ts.n == js.n and ts.capacity == js.capacity


@pytest.mark.parametrize("case", list(CASES))
def test_insert_matches_jax(blob, case):
    """knn_insert from one state with the JAX seed draw: the same lists,
    flags, mirror, router maintenance and stats."""
    x, dist, idx = blob
    jkw, tkw = CASES[case]
    js = jon.MutableKNNStore.from_graph(jnp.asarray(x[:512]), dist, idx,
                                        cfg=jon.OnlineConfig(**jkw))
    key = jax.random.key(2)
    j2, jst = jon.knn_insert(js, jnp.asarray(x[512:]), key=key)
    t2, tst = knn_insert(_port_of(js, OnlineConfig(**tkw)), x[512:],
                         **_seed_draw(js, 51, key))
    _stats_equal(tst, jst)
    _store_close(t2, j2)
    if case == "int8":
        for a, b in zip(t2.qs, j2.qs):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    if case == "router":
        assert t2.router.stale == int(j2.router.stale) == 51
        for name in ("assign", "counts"):
            np.testing.assert_array_equal(
                getattr(t2.router, name).numpy(),
                np.asarray(getattr(j2.router, name)))
        np.testing.assert_array_equal(t2.router.members.idx.numpy(),
                                      np.asarray(j2.router.members.idx))


@pytest.mark.parametrize("case", ["plain", "dense", "small_chunk", "router"])
def test_delete_matches_jax(blob, case):
    """knn_delete from one state (after a JAX insert): the same lists,
    flags, alive mask and stats; the router's maintenance too (no
    rebuild: its drift stays under the threshold)."""
    x, dist, idx = blob
    jkw, tkw = {
        "plain": ({}, {}),
        "dense": ({"frontier": False, "chunk": 128},
                  {"frontier": False, "chunk": 128}),
        "small_chunk": ({"chunk": 64}, {"chunk": 64}),
        "router": ({"router": jr.RouterConfig(rebuild_frac=0.5)},
                   {"router": RouterConfig(rebuild_frac=0.5)}),
    }[case]
    js = jon.MutableKNNStore.from_graph(jnp.asarray(x[:512]), dist, idx,
                                        cfg=jon.OnlineConfig(**jkw))
    js, _ = jon.knn_insert(js, jnp.asarray(x[512:]), key=jax.random.key(2))
    dead = np.concatenate([np.arange(0, 563, 9), [520, 521]]).astype(
        np.int32)
    j3, jst = jon.knn_delete(js, jnp.asarray(dead))
    t3, tst = knn_delete(_port_of(js, OnlineConfig(**tkw)), dead)
    _stats_equal(tst, jst)
    _store_close(t3, j3)
    if case == "router":
        assert t3.router.stale == int(j3.router.stale)
        np.testing.assert_array_equal(t3.router.counts.numpy(),
                                      np.asarray(j3.router.counts))
        np.testing.assert_array_equal(t3.router.members.idx.numpy(),
                                      np.asarray(j3.router.members.idx))


def test_delete_reconnects_orphans_like_jax():
    """A live row whose whole neighborhood dies is re-anchored to live
    rows, as in the JAX package (same state, same lists and stats)."""
    key = jax.random.key(0)
    a = jax.random.normal(key, (96, 8))
    b = 100.0 + jax.random.normal(jax.random.fold_in(key, 1), (32, 8))
    x = jnp.concatenate([a, b])
    dist, idx, _ = jnd.build_knn_graph(
        x, k=8, cfg=jnd.DescentConfig(k=8, rho=1.0, max_iters=10),
        key=jax.random.key(1))
    js = jon.MutableKNNStore.from_graph(x, dist, idx)
    dead = np.arange(97, 128, dtype=np.int32)
    j2, jst = jon.knn_delete(js, jnp.asarray(dead))
    t2, tst = knn_delete(_port_of(js, OnlineConfig()), dead)
    _stats_equal(tst, jst)
    _store_close(t2, j2)
    nbrs = t2.nl.idx[96]
    assert (nbrs >= 0).sum() > 0
    assert t2.alive[nbrs[nbrs >= 0].long()].all()


# ---------------------------------------------------------------------------
# the JAX tests' floors, held on the port
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def port_base(blob):
    x, _, _ = blob
    dcfg = DescentConfig(k=K, rho=1.0, max_iters=15)
    g = torch.Generator().manual_seed(1)
    dist, idx, _ = build_knn_graph(x[:512], K, cfg=dcfg, generator=g,
                                   device="cpu")
    return MutableKNNStore.from_graph(x[:512], dist, idx, device="cpu")


def test_insert_recall_and_cost(blob, port_base):
    """Inserting 10% new points reaches recall >= 0.85 on the combined
    corpus at < 25% of a from-scratch build's evaluations
    (tests/test_online.py:54)."""
    x, _, _ = blob
    store, ins = knn_insert(port_base, x[512:])
    _, _, rebuild = build_knn_graph(
        x, K, cfg=DescentConfig(k=K, rho=1.0, max_iters=15),
        generator=torch.Generator().manual_seed(1), device="cpu")
    _, truth = brute_force_knn(x, x, K, device="cpu")
    r = recall_at_k(store.nl.idx[:563], truth)
    assert r >= 0.85, r
    assert ins.dist_evals < 0.25 * rebuild.dist_evals
    assert store.capacity == 1024 and store.n == 563
    assert store.live_count() == 563
    # value semantics: the old store is untouched, a second insert from it
    # gives the same result
    assert port_base.n == 512 and port_base.capacity == 512
    again, _ = knn_insert(port_base, x[512:])
    assert torch.equal(again.nl.idx, store.nl.idx)


def test_delete_never_returns_tombstoned(blob, port_base):
    x, _, _ = blob
    dead = torch.arange(0, 512, 4, dtype=torch.int32)
    store, _ = knn_delete(port_base, dead)
    store, _ = knn_insert(store, x[512:])
    lists = store.nl.idx
    assert not torch.isin(lists[lists >= 0], dead).any()
    _, got = store.search(x[:128] + 0.01, k_out=10)
    assert not torch.isin(got[got >= 0], dead).any()
    assert (got >= 0).all()


def test_delete_frontier_matches_dense(port_base):
    """The compacted frontier and the dense baseline give identical
    stores and evaluations; the frontier processes fewer rows."""
    dead = torch.cat([torch.arange(0, 40), torch.tensor([200, 201, 511])])
    out = {}
    for frontier in (True, False):
        s = dataclasses.replace(port_base, cfg=dataclasses.replace(
            port_base.cfg, frontier=frontier, chunk=128))
        out[frontier] = knn_delete(s, dead)
    (sf, stf), (sd, std) = out[True], out[False]
    assert torch.equal(sf.nl.idx, sd.nl.idx)
    assert torch.equal(sf.nl.dist, sd.nl.dist)
    assert stf.dist_evals == std.dist_evals
    assert stf.padded_rows < std.padded_rows


def test_empty_store_first_insert():
    """An empty store searches empty, and its first insert acts as a first
    build (the self-join links the batch)."""
    store = MutableKNNStore.empty(16, k=K, device="cpu")
    q = torch.randn(6, 16, generator=torch.Generator().manual_seed(0))
    _, i = store.search(q, k_out=5)
    assert (i == -1).all()
    x = np.asarray(jdatasets.clustered(jax.random.key(2), 64, 16, 4))
    store, _ = knn_insert(store, x)
    assert store.n == 64 and store.live_count() == 64
    _, idx = store.search(x[:16], k_out=1)
    assert (idx[:, 0] == torch.arange(16)).all()


def test_int8_store_round_trip():
    store = MutableKNNStore.empty(16, k=K, cfg=OnlineConfig(
        precision="int8"), device="cpu")
    x = np.asarray(jdatasets.clustered(jax.random.key(2), 48, 16, 4))
    store, _ = knn_insert(store, x)
    assert store.qs is not None and store.qs.data.shape[0] == \
        store.capacity and store.live_count() == 48
    _, idx = store.search(x[:8], k_out=1)
    assert (idx[:, 0] == torch.arange(8)).all()


def test_failed_router_rebuild_serves_stale():
    """Past the drift threshold with the rebuild injected to fail: a
    warning, the stale router keeps serving, and the next crossing
    rebuilds (tests/test_router.py:240)."""
    x = np.asarray(jdatasets.clustered(jax.random.key(30), 256, 8, 4))
    dist, idx, _ = build_knn_graph(x, 8, device="cpu")
    cfg = OnlineConfig(router=RouterConfig(n_centroids=16, sample=256,
                                           members=16, rebuild_frac=0.25))
    store = MutableKNNStore.from_graph(x, dist, idx, cfg=cfg, device="cpu")
    pts = np.tile(x[:16], (6, 1)) + 0.03
    plan = faults.FaultPlan(specs=(faults.FaultSpec(site="router.rebuild",
                                                    times=1),))
    with plan.active(), pytest.warns(RuntimeWarning, match="stale router"):
        store2, _ = knn_insert(store, pts)
    assert plan.fired("router.rebuild") == 1
    assert store2.router.stale == 96
    _, got = store2.search(x[:32], k_out=5)
    assert (got >= 0).all() and store2.alive[got.long()].all()
    store3, _ = knn_insert(store2, x[:8] + 0.01)
    assert store3.router.stale == 0
    assert int(store3.router.counts.sum()) == store3.live_count()


def test_ensure_router_attaches_once(port_base):
    store = ensure_router(port_base, RouterConfig(n_centroids=8))
    assert store.router is not None and store.cfg.router is not None
    assert ensure_router(store) is store
    assert int(store.router.counts.sum()) == store.live_count()


def test_online_entry_points_default_to_the_card(blob):
    x, dist, idx = blob
    calls = [lambda: MutableKNNStore.from_graph(x[:512], dist, idx),
             lambda: MutableKNNStore.empty(16)]
    for call in calls:
        if torch.cuda.is_available():
            assert call().x.device.type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="device='cpu'"):
                call()


def test_plain_backend_is_the_same_path(blob, port_base):
    """backend "plain" runs the auto path through the plain versions on
    any device (on the CPU, auto takes them anyway): the same store."""
    x, _, _ = blob
    plain = dataclasses.replace(port_base, cfg=dataclasses.replace(
        port_base.cfg, backend="plain"))
    dead = torch.arange(0, 563, 13)
    a, sa = knn_delete(knn_insert(port_base, x[512:])[0], dead)
    b, sb = knn_delete(knn_insert(plain, x[512:])[0], dead)
    assert torch.equal(a.nl.idx, b.nl.idx) and torch.equal(a.nl.dist,
                                                           b.nl.dist)
    assert sa == sb


def test_unknown_online_backend_raises(port_base):
    bad = dataclasses.replace(port_base, cfg=dataclasses.replace(
        port_base.cfg, backend="interpret"))
    with pytest.raises(ValueError, match="unknown backend"):
        knn_delete(bad, [1])


def test_online_config_fields_match_jax():
    names = [f.name for f in dataclasses.fields(OnlineConfig)]
    assert names == [f.name for f in dataclasses.fields(jon.OnlineConfig)]
    ours = dataclasses.asdict(OnlineConfig())
    theirs = dataclasses.asdict(jon.OnlineConfig())
    assert ours == theirs
