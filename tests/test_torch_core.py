"""The port's core modules (repro_torch/core) against the JAX package's,
on the same numpy inputs and the same random draws (the JAX draws are
computed with the JAX package's own key schedule and injected).

Lists, flags, buffers, counts and permutations are held exactly;
distances at rtol 1e-5 (sums in another order)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import datasets as jdatasets
from repro.core import heap as jheap
from repro.core import metric as jmetric
from repro.core import nn_descent as jnd
from repro.core import recall as jrecall
from repro.core import reorder as jreorder
from repro.core import selection as jselection
from repro.core.layout import pad_features as jpad_features
from repro_torch.core import heap, metric, nn_descent, recall, reorder
from repro_torch.core import selection
from repro_torch.core.layout import pad_features


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _t(a):
    return torch.from_numpy(np.array(a))


def _tnl(jnl):
    return heap.neighbor_lists_from_numpy(*(np.asarray(a) for a in jnl))


def _assert_nl(got, want, *, flags=True, rtol=1e-5):
    gd, gi, gn = got.to_numpy()
    wd, wi, wn = (np.asarray(a) for a in want)
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_array_equal(np.isinf(gd), np.isinf(wd))
    np.testing.assert_allclose(np.where(np.isinf(gd), 0, gd),
                               np.where(np.isinf(wd), 0, wd),
                               rtol=rtol, atol=1e-4 if rtol else 0)
    if flags:
        np.testing.assert_array_equal(gn, wn)


def _corpus(n, d, seed):
    """Gaussian rows with small norms: the norm expansion's cancellation
    error (about eps * |x|^2) then stays far below the gaps between
    neighbor distances, so ids can be held exactly."""
    x = np.asarray(jdatasets.gaussian(jax.random.key(seed), n, d))
    xp = np.asarray(jpad_features(jnp.asarray(x)))
    return x, xp, (xp * xp).sum(1).astype(np.float32)


_jinit = jax.jit(jheap.init_random_with_dists, static_argnums=(2,))
_jlocal_join = jax.jit(jnd.local_join_fused, static_argnames=("cfg",))


def _turbo_draws(key, n, k):
    """selection_turbo's three uniforms, by the JAX package's schedule."""
    k_acc, k_new, k_old = jax.random.split(key, 3)
    return tuple(np.array(jax.random.uniform(kk, (2 * n * k,)))
                 for kk in (k_acc, k_new, k_old))


def _random_lists(n, k, seed):
    rng = np.random.RandomState(seed)
    dist = np.sort(rng.rand(n, k).astype(np.float32), axis=1)
    idx = rng.randint(0, n, size=(n, k)).astype(np.int32)
    new = rng.rand(n, k) < 0.5
    dist[1, k // 2:] = np.inf
    idx[1, k // 2:] = -1
    new[1, k // 2:] = False
    return dist, idx, new


# ---------------------------------------------------------------------------
# heap
# ---------------------------------------------------------------------------

def test_init_random_matches_jax_with_injected_draws():
    n, k = 50, 7
    key = jax.random.key(3)
    raw = np.asarray(jax.random.randint(key, (n, k), 0, n, dtype=jnp.int32))
    _assert_nl(heap.init_random(n, k, idx=_t(raw)),
               jheap.init_random(key, n, k), rtol=0)
    _, xp, _ = _corpus(n, 9, 1)
    _assert_nl(heap.init_random_with_dists(_t(xp), k, idx=_t(raw)),
               _jinit(key, jnp.asarray(xp), k))


@pytest.mark.parametrize("n,k,c", [(40, 6, 9), (33, 10, 30)])
def test_heap_merge_matches_jax(n, k, c):
    dist, idx, new = _random_lists(n, k, n)
    rng = np.random.RandomState(c)
    cd = (np.round(rng.rand(n, c) * 8) / 8).astype(np.float32)   # ties
    ci = rng.randint(-1, n, size=(n, c)).astype(np.int32)
    ci[2, 1:] = ci[2, 0]
    ci[3, :k] = idx[3]
    jnl = jheap.NeighborLists(jnp.asarray(dist), jnp.asarray(idx),
                              jnp.asarray(new))
    want, wu = jheap.merge(jnl, jnp.asarray(cd), jnp.asarray(ci))
    got, gu = heap.merge(_tnl(jnl), _t(cd), _t(ci))
    _assert_nl(got, want, rtol=0)
    np.testing.assert_array_equal(gu.numpy(), np.asarray(wu))


def test_merge_block_matches_jax_kernel_contract():
    """merge_block (flags included) against the JAX version running the
    Pallas merge kernel in interpret mode."""
    n, k, c, start, r = 48, 8, 24, 16, 24
    dist, idx, new = _random_lists(n, k, 5)
    rng = np.random.RandomState(6)
    cd = rng.rand(r, c).astype(np.float32)
    ci = rng.randint(-1, n, size=(r, c)).astype(np.int32)
    ci[0, :k] = idx[start]
    jnl = jheap.NeighborLists(jnp.asarray(dist), jnp.asarray(idx),
                              jnp.asarray(new))
    want, wu = jheap.merge_block(jnl, start, jnp.asarray(cd),
                                 jnp.asarray(ci), backend="interpret")
    got, gu = heap.merge_block(_tnl(jnl), start, _t(cd), _t(ci))
    _assert_nl(got, want, rtol=0)
    np.testing.assert_array_equal(gu.numpy(), np.asarray(wu))


def test_merge_kernel_matches_jax():
    """heap.merge_kernel (lists, flags, accepted counts) against the JAX
    version running the Pallas merge kernel in interpret mode: exact."""
    n, k, c = 40, 8, 20
    dist, idx, new = _random_lists(n, k, 11)
    rng = np.random.RandomState(12)
    cd = (np.round(rng.rand(n, c) * 8) / 8).astype(np.float32)   # ties
    ci = rng.randint(-1, n, size=(n, c)).astype(np.int32)
    ci[2, 1:] = ci[2, 0]
    ci[3, :k] = idx[3]
    ci[4] = -1
    jnl = jheap.NeighborLists(jnp.asarray(dist), jnp.asarray(idx),
                              jnp.asarray(new))
    want, wu = jheap.merge_kernel(jnl, jnp.asarray(cd), jnp.asarray(ci),
                                  backend="interpret")
    got, gu = heap.merge_kernel(_tnl(jnl), _t(cd), _t(ci))
    _assert_nl(got, want, rtol=0)
    np.testing.assert_array_equal(gu.numpy(), np.asarray(wu))


def test_repeated_list_id_survives_merges_in_both_packages():
    """ROADMAP Queue 3: the random init draws ids with replacement, and a
    merge dedups its candidates, never the list itself, so a repeated id
    that is a true near neighbor survives every merge in both packages.
    Here a row lists id 7 twice and the merge keeps both copies."""
    dist = np.array([[0.1, 0.1, 0.5, 0.9]], np.float32)
    idx = np.array([[7, 7, 3, 5]], np.int32)
    new = np.ones((1, 4), bool)
    cd = np.array([[0.2, 0.05, 0.3]], np.float32)
    ci = np.array([[7, 2, 9]], np.int32)
    jnl = jheap.NeighborLists(jnp.asarray(dist), jnp.asarray(idx),
                              jnp.asarray(new))
    want, _ = jheap.merge_kernel(jnl, jnp.asarray(cd), jnp.asarray(ci),
                                 backend="interpret")
    got, _ = heap.merge_kernel(_tnl(jnl), _t(cd), _t(ci))
    _assert_nl(got, want, rtol=0)
    assert got.idx[0].tolist() == [2, 7, 7, 9]


def test_mark_sampled_old():
    dist, idx, new = _random_lists(10, 4, 2)
    mask = np.random.RandomState(0).rand(10, 4) < 0.5
    jnl = jheap.NeighborLists(jnp.asarray(dist), jnp.asarray(idx),
                              jnp.asarray(new))
    got = heap.mark_sampled_old(_tnl(jnl), _t(mask))
    want = jheap.mark_sampled_old(jnl, jnp.asarray(mask))
    np.testing.assert_array_equal(got.new.numpy(), np.asarray(want.new))


# ---------------------------------------------------------------------------
# selection
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,k,rho_k", [(60, 6, 6), (97, 8, 4)])
def test_selection_turbo_matches_jax_with_injected_draws(n, k, rho_k):
    dist, idx, new = _random_lists(n, k, n + k)
    jnl = jheap.NeighborLists(jnp.asarray(dist), jnp.asarray(idx),
                              jnp.asarray(new))
    key = jax.random.key(n)
    want = jselection.selection_turbo(key, jnl, rho_k)
    got = selection.selection_turbo(_tnl(jnl), rho_k,
                                    draws=_turbo_draws(key, n, k))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _heap_draws(key, n, k):
    """selection_heap's weights, by the JAX package's schedule."""
    k_w, _ = jax.random.split(key)
    return (np.array(jax.random.uniform(k_w, (2 * n * k,))),)


def _naive_draws(key, n, k):
    """selection_naive's three uniforms, by the JAX package's schedule."""
    k1, k2, k3 = jax.random.split(key, 3)
    return (np.array(jax.random.uniform(k1, (n * k,))),
            np.array(jax.random.uniform(k2, (n, 3 * k))),
            np.array(jax.random.uniform(k3, (n, 3 * k))))


_DRAWS = {"turbo": _turbo_draws, "heap": _heap_draws, "naive": _naive_draws}


@pytest.mark.parametrize("name", ["heap", "naive"])
@pytest.mark.parametrize("n,k,rho_k", [(60, 6, 6), (97, 8, 4), (40, 5, 20)])
def test_selection_variants_match_jax_with_injected_draws(name, n, k, rho_k):
    """Bitwise: the buffers (ties by the stable sorts) and the sampled
    flags (heap: the masked scatter aimed at slot 0; naive: the forward
    slots present in the sample)."""
    dist, idx, new = _random_lists(n, k, n + k)
    jnl = jheap.NeighborLists(jnp.asarray(dist), jnp.asarray(idx),
                              jnp.asarray(new))
    key = jax.random.key(n + 1)
    want = getattr(jselection, f"selection_{name}")(key, jnl, rho_k)
    got = getattr(selection, f"selection_{name}")(
        _tnl(jnl), rho_k, draws=_DRAWS[name](key, n, k))
    for g, w in zip(got, want):
        assert g.dtype == (torch.bool if w.dtype == bool else torch.int32)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("name", ["heap", "naive"])
def test_selection_variants_return_candidate_buffers(name):
    """The paper's baselines with their own draws: (n, rho_k) buffers of
    ids from each row's neighborhood (forward or reverse), valid ids first,
    no id twice in a pool but through repeated list entries, and sampled
    flags only on new forward slots."""
    n, k, rho_k = 80, 6, 4
    dist, idx, new = _random_lists(n, k, 3)
    nl = heap.neighbor_lists_from_numpy(dist, idx, new)
    c = getattr(selection, f"selection_{name}")(
        nl, rho_k, generator=torch.Generator().manual_seed(0))
    assert c.new_idx.shape == c.old_idx.shape == (n, rho_k)
    assert c.new_idx.dtype == c.old_idx.dtype == torch.int32
    hood = [set(idx[u][idx[u] >= 0]) | set(np.nonzero((idx == u).any(1))[0])
            for u in range(n)]
    for buf in (c.new_idx, c.old_idx):
        b = buf.numpy()
        valid = b >= 0
        assert not (valid[:, 1:] & ~valid[:, :-1]).any()
        for u in range(n):
            assert set(b[u][valid[u]]) <= hood[u]
    assert not (c.sampled_fwd.numpy() & ~new).any()
    assert c.sampled_fwd.any()


# ---------------------------------------------------------------------------
# incidence inversion and the fused local join
# ---------------------------------------------------------------------------

def test_invert_candidates_roundtrip_and_overflow():
    cands = _t(np.array([[2, 0, -1], [2, 2, 1], [0, -1, 0]], np.int32))
    r, s = nn_descent.invert_candidates(cands, 3, 4)
    assert r.tolist() == [[0, 2, 2, -1], [1, -1, -1, -1], [0, 1, 1, -1]]
    assert s.tolist() == [[1, 0, 2, -1], [2, -1, -1, -1], [0, 0, 1, -1]]
    r, _ = nn_descent.invert_candidates(cands, 3, 2)
    assert r[0].tolist() == [0, 2]
    # prioritized overflow keeps the nearest sources (test_knn_join.py:232)
    cands = torch.zeros((8, 1), dtype=torch.int32)
    prio = torch.arange(8, 0, -1, dtype=torch.float32).reshape(8, 1)
    r, s = nn_descent.invert_candidates(cands, 1, 4, prio=prio)
    assert sorted(r[0].tolist()) == [4, 5, 6, 7]
    assert (s[0] == 0).all()


@pytest.mark.parametrize("use_prio", [False, True])
def test_invert_candidates_matches_jax(use_prio):
    rng = np.random.RandomState(7)
    cands = rng.randint(-1, 30, size=(50, 6)).astype(np.int32)
    prio = (np.round(rng.rand(50, 6) * 4) / 4).astype(np.float32)
    prio[3] = np.inf
    jp, tp = (jnp.asarray(prio), _t(prio)) if use_prio else (None, None)
    wr, ws = jnd.invert_candidates(jnp.asarray(cands), 30, 5, prio=jp)
    gr, gs = nn_descent.invert_candidates(_t(cands), 30, 5, prio=tp)
    np.testing.assert_array_equal(gr.numpy(), np.asarray(wr))
    np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))


@pytest.mark.parametrize("n,k,chunk", [
    (150, 8, 64),     # n not a multiple of the receiver chunk
    (64, 6, 64),      # single exact chunk
    (97, 5, 256),     # chunk larger than n
])
def test_local_join_fused_matches_jax(n, k, chunk):
    """ids exact, dist rtol 1e-5, upd and evals exact; includes all-invalid
    candidate rows and C < merge_k."""
    rng = np.random.RandomState(n)
    x = rng.randn(n, 24).astype(np.float32)
    xp = np.asarray(jpad_features(jnp.asarray(x)))
    x2 = (xp * xp).sum(1).astype(np.float32)
    jnl = _jinit(jax.random.key(1), jnp.asarray(xp), k)
    cn = rng.randint(-1, n, size=(n, k)).astype(np.int32)
    co = rng.randint(-1, n, size=(n, k)).astype(np.int32)
    cn[5] = -1
    co[5] = -1
    co[6] = -1
    cfg_j = jnd.DescentConfig(k=k, join_chunk=chunk, join_src=8 * k)
    cfg_t = nn_descent.DescentConfig(k=k, join_chunk=chunk, join_src=8 * k)
    want, wu, we = _jlocal_join(
        jnp.asarray(xp), jnp.asarray(x2), jnl, jnp.asarray(cn),
        jnp.asarray(co), cfg_j)
    got, gu, ge = nn_descent.local_join_fused(
        _t(xp), _t(x2), _tnl(jnl), _t(cn), _t(co), cfg_t)
    _assert_nl(got, want)
    assert gu == int(wu)
    assert ge == int(we)


def test_nn_descent_iteration_matches_jax_with_injected_draws():
    _, xp, x2 = _corpus(300, 16, 0)
    jnl = _jinit(jax.random.key(2), jnp.asarray(xp), 8)
    key = jax.random.key(3)
    cfg_j = jnd.DescentConfig(k=8, rho=1.0, join_src=64)
    cfg_t = nn_descent.DescentConfig(k=8, rho=1.0, join_src=64)
    want, wu, we = jnd.nn_descent_iteration(key, jnp.asarray(xp),
                                            jnp.asarray(x2), jnl, cfg_j)
    got, gu, ge = nn_descent.nn_descent_iteration(
        _t(xp), _t(x2), _tnl(jnl), cfg_t, draws=_turbo_draws(key, 300, 8))
    _assert_nl(got, want)
    assert gu == int(wu)
    assert ge == int(we)


def test_polish_iteration_matches_jax():
    x = np.asarray(jdatasets.gaussian(jax.random.key(4), 256, 16))
    xp = np.asarray(jpad_features(jnp.asarray(x)))
    x2 = (xp * xp).sum(1).astype(np.float32)
    jnl = _jinit(jax.random.key(6), jnp.asarray(xp), 6)
    want, wu, we = jnd.polish_iteration(jnp.asarray(xp), jnp.asarray(x2),
                                        jnl, "auto")
    # a chunk smaller than n exercises the row-chunked distance pass
    got, gu, ge = nn_descent.polish_iteration(_t(xp), _t(x2), _tnl(jnl),
                                              chunk=100)
    _assert_nl(got, want)
    assert gu == int(wu)
    assert ge == int(we)


@pytest.mark.parametrize("field,value", [
    ("backend", "ref"), ("selection", "naive"), ("selection", "heap")])
def test_build_options_build_on_cpu(field, value):
    """The lexsort build and the heap / naive selections build on the CPU:
    full ascending lists without self loops, fp32 distances (within 1e-4 +
    1e-5 (|a|^2 + |b|^2) of fp64: the norm expansion cancels the digits
    the norms share), and test_core.py:56's recall floor on its 512-point
    blob."""
    x = np.array(jdatasets.clustered(jax.random.key(11), 512, 16, 8))
    cfg = nn_descent.DescentConfig(k=10, rho=1.0, max_iters=15,
                                   **{field: value})
    dist, idx, stats = nn_descent.build_knn_graph(
        x, k=10, cfg=cfg, generator=torch.Generator().manual_seed(5),
        device="cpu")
    assert dist.shape == idx.shape == (512, 10) and idx.dtype == torch.int32
    assert (idx >= 0).all() and (idx != torch.arange(512)[:, None]).all()
    assert (dist[:, 1:] >= dist[:, :-1]).all()
    xt = torch.from_numpy(x).double()
    d64 = ((xt[:, None] - xt[idx.long()]) ** 2).sum(-1)
    n2 = (xt * xt).sum(-1)
    tol = 1e-4 + 1e-5 * (n2[:, None] + n2[idx.long()])
    assert ((dist.double() - d64).abs() <= tol).all()
    _, ti = jrecall.brute_force_knn(jnp.asarray(x), jnp.asarray(x), 10)
    assert recall.recall_at_k(idx, _t(ti)) >= 0.9
    assert stats.iters <= cfg.max_iters and len(stats.polish_updates) == 2


def test_unknown_selection_raises():
    cfg = nn_descent.DescentConfig(k=4, selection="bogus")
    with pytest.raises(ValueError, match="unknown selection"):
        nn_descent.build_knn_graph(np.zeros((16, 3), np.float32), k=4,
                                   cfg=cfg, device="cpu")


# ---------------------------------------------------------------------------
# the lexsort path (backend="ref")
# ---------------------------------------------------------------------------

def test_pair_block_matches_jax():
    rng = np.random.RandomState(4)
    xg, yg = rng.randn(7, 5, 24), rng.randn(7, 3, 24)
    xg, yg = xg.astype(np.float32), yg.astype(np.float32)
    x2, y2 = (xg * xg).sum(-1), (yg * yg).sum(-1)
    x2[:, 0] = 0.0                                  # a masked slot
    want = jnd.pair_block(*(jnp.asarray(a) for a in (xg, x2, yg, y2)))
    got = nn_descent.pair_block(*(_t(a) for a in (xg, x2, yg, y2)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    assert (got >= 0).all()


@pytest.mark.parametrize("name", ["turbo", "heap", "naive"])
def test_ref_iteration_matches_jax_with_injected_draws(name):
    """One backend="ref" iteration, the port's against JAX's from one state
    and the JAX draws of each selection: lists, flags, updates, evals."""
    _, xp, x2 = _corpus(300, 16, 0)
    jnl = _jinit(jax.random.key(2), jnp.asarray(xp), 8)
    key = jax.random.key(3)
    kw = dict(k=8, rho=1.0, backend="ref", selection=name)
    want, wu, we = jnd.nn_descent_iteration(
        key, jnp.asarray(xp), jnp.asarray(x2), jnl, jnd.DescentConfig(**kw))
    got, gu, ge = nn_descent.nn_descent_iteration(
        _t(xp), _t(x2), _tnl(jnl), nn_descent.DescentConfig(**kw),
        draws=_DRAWS[name](key, 300, 8))
    _assert_nl(got, want)
    assert gu == int(wu)
    assert ge == int(we)


def test_ref_polish_matches_jax():
    """The "ref" polish (the full k*k row merged directly), row-chunked in
    the port, against JAX's."""
    x = np.asarray(jdatasets.gaussian(jax.random.key(4), 256, 16))
    xp = np.asarray(jpad_features(jnp.asarray(x)))
    x2 = (xp * xp).sum(1).astype(np.float32)
    jnl = _jinit(jax.random.key(6), jnp.asarray(xp), 6)
    want, wu, we = jnd.polish_iteration(jnp.asarray(xp), jnp.asarray(x2),
                                        jnl, "ref")
    got, gu, ge = nn_descent.polish_iteration(_t(xp), _t(x2), _tnl(jnl),
                                              chunk=100, full_merge=True)
    _assert_nl(got, want)
    assert gu == int(wu)
    assert ge == int(we)


@pytest.mark.parametrize("n,k,chunk", [
    (150, 8, 64),     # n not a multiple of the receiver chunk
    (64, 6, 64),      # single exact chunk
    (97, 5, 256),     # chunk larger than n
])
def test_fused_join_matches_lexsort_path(n, k, chunk):
    """tests/test_knn_join.py:162's parity in the port: the fused join
    against local_join_ref on one state, all-invalid candidate rows and C <
    merge_k included: ids exact, dist rtol 1e-5, updates and evals
    exact."""
    rng = np.random.RandomState(n)
    x = rng.randn(n, 24).astype(np.float32)
    xp = pad_features(_t(x))
    x2 = (xp * xp).sum(1)
    nl = heap.init_random_with_dists(xp, k, generator=torch.Generator()
                                     .manual_seed(1))
    cn = rng.randint(-1, n, size=(n, k)).astype(np.int32)
    co = rng.randint(-1, n, size=(n, k)).astype(np.int32)
    cn[5] = co[5] = co[6] = -1
    cfg = nn_descent.DescentConfig(k=k, join_chunk=chunk, join_src=8 * k)
    got, gu, ge = nn_descent.local_join_fused(xp, x2, nl, _t(cn), _t(co),
                                              cfg)
    want, wu, we = nn_descent.local_join_ref(xp, x2, nl, _t(cn), _t(co),
                                             cfg)
    _assert_nl(got, want.to_numpy(), flags=False)
    assert (gu, ge) == (wu, we)


@pytest.mark.parametrize("name", ["turbo", "heap", "naive"])
def test_fused_iteration_matches_ref_backend(name):
    """tests/test_knn_join.py:195 in the port, for each selection: one
    iteration fused and "ref" from one state and one generator seed; the
    lists (not the flags: a list may hold an id twice, ROADMAP Queue 3,
    and the two merges flag its copies differently), updates, evals."""
    x = np.asarray(jdatasets.clustered(jax.random.key(0), 300, 16, 4))
    xp = pad_features(_t(x))
    x2 = (xp * xp).sum(1)
    nl0 = heap.init_random_with_dists(xp, 8, generator=torch.Generator()
                                      .manual_seed(2))
    out = {}
    for backend in ("auto", "ref"):
        cfg = nn_descent.DescentConfig(k=8, rho=1.0, join_src=64,
                                       selection=name, backend=backend)
        out[backend] = nn_descent.nn_descent_iteration(
            xp, x2, nl0, cfg, generator=torch.Generator().manual_seed(3))
    (nf, uf, ef), (nr, ur, er) = out["auto"], out["ref"]
    _assert_nl(nf, nr.to_numpy(), flags=False)
    assert (uf, ef) == (ur, er)


def test_fused_polish_matches_ref_backend():
    x = np.asarray(jdatasets.gaussian(jax.random.key(4), 256, 16))
    xp = pad_features(_t(x))
    x2 = (xp * xp).sum(1)
    nl = heap.init_random_with_dists(xp, 6, generator=torch.Generator()
                                     .manual_seed(6))
    nf, uf, ef = nn_descent.polish_iteration(xp, x2, nl)
    nr, ur, er = nn_descent.polish_iteration(xp, x2, nl, full_merge=True)
    _assert_nl(nf, nr.to_numpy(), flags=False)
    assert (uf, ef) == (ur, er)


def test_ref_build_ignores_precision_and_launches_nothing(monkeypatch):
    """A quantized config builds in fp32 under "ref" (nn_descent.py:455),
    and the lexsort path reaches no kernel wrapper: the same graph as the
    f32 "ref" build."""
    from repro_torch.kernels import ops
    calls = []
    for name in ("knn_join_dists", "knn_join_select", "knn_merge",
                 "knn_join_dists_q8", "knn_join_dists_bf16",
                 "knn_search_dists"):
        fn = getattr(ops, name)
        monkeypatch.setattr(ops, name, lambda *a, _n=name, _f=fn, **kw:
                            calls.append(_n) or _f(*a, **kw))
    x = np.array(jdatasets.clustered(jax.random.key(1), 256, 16, 4))
    out = []
    for precision in ("f32", "int8"):
        cfg = nn_descent.DescentConfig(k=8, rho=1.0, backend="ref",
                                       precision=precision)
        out.append(nn_descent.build_knn_graph(
            x, k=8, cfg=cfg, generator=torch.Generator().manual_seed(0),
            device="cpu"))
    assert calls == []
    assert torch.equal(out[0][1], out[1][1])
    assert torch.equal(out[0][0], out[1][0])


# ---------------------------------------------------------------------------
# reorder, metric, layout, recall
# ---------------------------------------------------------------------------

def test_greedy_reorder_and_apply_permutation_match_jax():
    _, xp, _ = _corpus(200, 8, 2)
    jnl = _jinit(jax.random.key(9), jnp.asarray(xp), 6)
    ws, wsi = jreorder.greedy_reorder(jnl)
    gs, gsi = reorder.greedy_reorder(_tnl(jnl))
    np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))
    np.testing.assert_array_equal(gsi.numpy(), np.asarray(wsi))
    wx, wnl = jreorder.apply_permutation(jnp.asarray(xp), jnl, ws, wsi)
    gx, gnl = reorder.apply_permutation(_t(xp), _tnl(jnl), gs, gsi)
    np.testing.assert_array_equal(gx.numpy(), np.asarray(wx))
    _assert_nl(gnl, wnl, rtol=0)


@pytest.mark.parametrize("name", ["l2", "cosine", "mips"])
def test_transform_corpus_matches_jax(name):
    rng = np.random.RandomState(1)
    x = (rng.randn(20, 5) * 3).astype(np.float32)
    x[4] = 0.0                                   # a zero row
    wx, wm = jmetric.transform_corpus(jnp.asarray(x), name)
    gx, gm = metric.transform_corpus(_t(x), name)
    gx, wx = gx.numpy(), np.asarray(wx)
    np.testing.assert_allclose(gx[:, :5], wx[:, :5], rtol=1e-6, atol=1e-6)
    assert gm == pytest.approx(wm, rel=1e-6)
    if name == "mips":
        # sqrt(M^2 - |x|^2) cancels to ~0 on the longest row: compare the
        # squares, at the cancellation bound (a few ulps of M^2)
        np.testing.assert_allclose(gx[:, 5] ** 2, wx[:, 5] ** 2,
                                   atol=8 * np.finfo(np.float32).eps * wm**2)
    with pytest.raises(ValueError, match="unknown metric"):
        metric.check_metric("hamming")


@pytest.mark.parametrize("name", ["l2", "cosine", "mips"])
def test_transform_queries_matches_jax(name):
    rng = np.random.RandomState(3)
    q = (rng.randn(12, 5) * 2).astype(np.float32)
    q[2] = 0.0
    want = np.asarray(jmetric.transform_queries(jnp.asarray(q), name))
    got = metric.transform_queries(_t(q), name)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)
    assert metric.transformed_dim(5, name) == \
        jmetric.transformed_dim(5, name) == got.shape[1]
    with pytest.raises(ValueError, match="unknown metric"):
        metric.transform_queries(_t(q), "hamming")


@pytest.mark.parametrize("name", ["l2", "cosine", "mips"])
def test_similarity_from_dist_matches_jax(name):
    rng = np.random.RandomState(4)
    dist = (rng.rand(6, 4) * 3).astype(np.float32)
    dist[1, 2:] = np.inf                         # empty slots
    q2 = (rng.rand(6) * 2).astype(np.float32)
    kw = dict(mips_m=1.75)
    want = np.asarray(jmetric.similarity_from_dist(
        jnp.asarray(dist), name, q2=jnp.asarray(q2), **kw))
    got = metric.similarity_from_dist(_t(dist), name, q2=_t(q2), **kw)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    if name == "mips":
        with pytest.raises(ValueError, match="q2"):
            metric.similarity_from_dist(_t(dist), name)


@pytest.mark.parametrize("shape", [None, (50,), (3, 50)])
def test_filter_frac_matches_jax(shape):
    mask = None if shape is None else \
        np.random.RandomState(5).rand(*shape) < 0.3
    want = jmetric.filter_frac(None if mask is None else jnp.asarray(mask))
    got = metric.filter_frac(None if mask is None else _t(mask))
    assert got == pytest.approx(want, rel=1e-6)


@pytest.mark.parametrize("block", [8, 128])
def test_locality_stats_matches_jax(block):
    dist, idx, new = _random_lists(300, 6, 8)
    jnl = jheap.NeighborLists(jnp.asarray(dist), jnp.asarray(idx),
                              jnp.asarray(new))
    want = jreorder.locality_stats(jnl, block=block)
    got = reorder.locality_stats(_tnl(jnl), block=block)
    assert got.keys() == want.keys() and got["block"] == block
    for name in ("in_block_fraction", "mean_gather_spread"):
        assert got[name] == pytest.approx(want[name], rel=1e-6), name


def test_locality_stats_spread_passes_int32():
    """The float accumulation: the summed |i - j| of a 70000-row graph
    whose rows point far away passes int32; the spread is still exact."""
    n, k = 70_000, 20
    idx = (torch.arange(n)[:, None] + n // 2) % n
    nl = heap.NeighborLists(torch.zeros(n, k), idx.expand(n, k)
                            .to(torch.int32).contiguous(),
                            torch.zeros(n, k, dtype=torch.bool))
    got = reorder.locality_stats(nl)
    assert got["mean_gather_spread"] == pytest.approx(n // 2, rel=1e-6)
    assert got["in_block_fraction"] == 0.0


def test_window_cluster_purity_matches_jax():
    rng = np.random.RandomState(6)
    labels = rng.randint(0, 7, size=900).astype(np.int32)
    sigma = rng.permutation(900).astype(np.int32)
    ws, wp = jreorder.window_cluster_purity(
        jnp.asarray(labels), jnp.asarray(sigma), window=200, stride=70)
    gs, gp = reorder.window_cluster_purity(_t(labels), _t(sigma),
                                           window=200, stride=70)
    assert gs == ws
    np.testing.assert_allclose(gp, wp, rtol=1e-6)


def test_pairwise_sq_l2_diff_matches_jax():
    from repro.kernels import ref as jref
    from repro_torch.kernels import ref
    rng = np.random.RandomState(7)
    a, b = rng.randn(9, 33), rng.randn(14, 33) * 4
    a, b = a.astype(np.float32), b.astype(np.float32)
    want = np.asarray(jref.pairwise_sq_l2_diff(jnp.asarray(a),
                                               jnp.asarray(b)))
    got = ref.pairwise_sq_l2_diff(_t(a), _t(b))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    assert got.dtype == torch.float32
    # the difference form has no cancellation: exact zeros on equal rows
    assert (ref.pairwise_sq_l2_diff(_t(b), _t(b)).diagonal() == 0).all()


def test_pad_features_matches_jax():
    x = np.ones((3, 130), np.float32)
    np.testing.assert_array_equal(pad_features(_t(x)).numpy(),
                                  np.asarray(jpad_features(jnp.asarray(x))))
    assert pad_features(_t(np.ones((2, 128), np.float32))).shape == (2, 128)


def test_recall_metrics_match_jax():
    rng = np.random.RandomState(2)
    truth = np.stack([rng.permutation(40)[:5] for _ in range(30)])
    approx = truth.copy()
    approx[rng.rand(30, 5) < 0.3] = -1
    approx[:, 0] = rng.randint(0, 40, size=30)
    assert recall.recall_at_k(_t(approx), _t(truth), chunk=7) == \
        pytest.approx(jrecall.recall_at_k(jnp.asarray(approx),
                                          jnp.asarray(truth)), rel=1e-6)
    td = np.sort(rng.rand(30, 5).astype(np.float32), axis=1)
    ad = td + (rng.rand(30, 5) < 0.2) * 0.5
    ad[0, 0] = np.inf
    assert recall.distance_recall(_t(ad), _t(td)) == pytest.approx(
        jrecall.distance_recall(jnp.asarray(ad), jnp.asarray(td)), rel=1e-6)


@pytest.mark.parametrize("case", ["exclude_self", "keep_self", "queries"])
def test_brute_force_knn_matches_jax(case):
    """Exact k-NN against the JAX package's on the small-norm 2048 x 16
    corpus: ids exact, distances rtol 1e-5 (atol 1e-4 near 0)."""
    x = np.array(_corpus(2048, 16, 3)[0])
    q = x
    if case == "queries":
        q = (x[:300] + 0.05 * np.random.RandomState(0).randn(300, 16)
             ).astype(np.float32)
    excl = case == "exclude_self"
    wd, wi = jrecall.brute_force_knn(jnp.asarray(x), jnp.asarray(q), 10,
                                     exclude_self=excl)
    gd, gi = recall.brute_force_knn(x, q, 10, exclude_self=excl, chunk=500,
                                    device="cpu")
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_allclose(gd.numpy(), np.asarray(wd), rtol=1e-5,
                               atol=1e-4)
    assert gi.dtype == torch.int32
    if excl:
        assert not (gi.numpy() == np.arange(2048)[:, None]).any()


def test_brute_force_knn_exclude_self_needs_the_corpus():
    x = np.zeros((10, 3), np.float32)
    with pytest.raises(ValueError, match="exclude_self=False"):
        jrecall.brute_force_knn(jnp.asarray(x), jnp.asarray(x[:4]), 2)
    with pytest.raises(ValueError, match="exclude_self=False"):
        recall.brute_force_knn(x, x[:4], 2, device="cpu")
