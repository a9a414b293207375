"""The port's router (repro_torch.core.router) and routed seeds in
graph_search, against the JAX package on the same numpy inputs and draws.

Both packages get the same corpus; the port gets the JAX router's state
(``router_from_numpy``) or the JAX package's sample weights, and routed
searches get the JAX hole-fill draw (``route_fill``).

Tolerances: ids, assignments, counts and member lists exact; computed
distances within 1e-4 + 1e-5 (|a|^2 + |b|^2) (the norm expansion cancels
the digits the norms share on these large-norm corpora, ROADMAP Queue 3);
centroids rtol 1e-5 (Lloyd's segment sums are index_add_ in the port, in
another order than jax.ops.segment_sum)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import datasets as jdatasets
from repro.core import nn_descent as jnd
from repro.core import router as jr
from repro.core.graph_search import SearchConfig as JSearchConfig
from repro.core.graph_search import _draw_entries as jdraw_entries
from repro.core.graph_search import graph_search as jgraph_search
from repro.core.recall import brute_force_knn as jbrute
from repro.kernels import ref as jref
from repro_torch import RouterConfig, SearchConfig, graph_search
from repro_torch import brute_force_knn, recall_at_k
from repro_torch.core import router as tr
from repro_torch.core.graph_search import _seed_merge
from repro_torch.core.heap import NeighborLists
from repro_torch.kernels import ref
from repro_torch.kernels.knn_merge import MERGE_MAX_POOL


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _close(got, want, scale):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    err = np.abs(got[fin] - want[fin])
    assert (err <= 1e-4 + 1e-5 * np.asarray(scale)[fin]).all(), err.max()


def _port_router(r):
    return tr.router_from_numpy(r.centroids, r.c2, r.graph, tuple(r.members),
                                r.assign, r.counts, r.stale, device="cpu")


def _jax_router(x, rcfg, key, alive=None):
    return jr.build_router(jnp.asarray(x), cfg=rcfg, key=key,
                           alive=None if alive is None else jnp.asarray(alive))


def _cfg_pair(**kw):
    return jr.RouterConfig(**kw), RouterConfig(**kw)


# ---------------------------------------------------------------------------
# centroid assignment (the pairwise kernel plus a stable top-t)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m,c,dp,t,ties", [
    (37, 16, 128, 1, False),
    (64, 33, 256, 4, False),
    (20, 12, 128, 5, True),
])
def test_centroid_assign_plain_matches_jax(m, c, dp, t, ties):
    """The plain version returns the JAX oracle's ids (lax.top_k keeps
    the lowest index on ties; so does the port's stable sort), on repeated
    centroids too."""
    rng = np.random.default_rng(m + c)
    q = rng.standard_normal((m, dp)).astype(np.float32)
    cent = rng.standard_normal((c, dp)).astype(np.float32)
    if ties:
        cent[c // 2:] = cent[0]             # a tiny corpus pads with repeats
    q2, c2 = (q * q).sum(1), (cent * cent).sum(1)
    jd, ji = jref.centroid_assign(*map(jnp.asarray, (q, q2, cent, c2)), t)
    td, ti = ref.centroid_assign(*map(torch.from_numpy, (q, q2, cent, c2)),
                                 t)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    _close(td.numpy(), np.asarray(jd), q2[:, None] + c2[np.asarray(ji)])


def test_resolve_centroids_matches_jax():
    for live in (0, 1, 15, 300, 5000, 10 ** 7):
        for n_c in (0, 7, 64):
            jc, tc = _cfg_pair(n_centroids=n_c)
            assert tr.resolve_centroids(live, tc) == \
                jr.resolve_centroids(live, jc)


# ---------------------------------------------------------------------------
# build_router
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["plain", "tombstones", "tiny"])
def test_build_router_matches_jax(case):
    """Same corpus and sample weights: the same centroids (rtol 1e-5),
    assignments, counts, member lists and mini-graph."""
    if case == "tiny":                       # fewer rows than centroids
        x = np.asarray(jdatasets.clustered(jax.random.key(2), 12, 8, 3))
        kw = dict(n_centroids=0, sample=64, members=4, graph_k=3)
    else:
        x = np.asarray(jdatasets.clustered(jax.random.key(0), 1024, 16, 8))
        kw = dict(n_centroids=8, sample=512, members=16, graph_k=4)
    alive = None
    if case == "tombstones":
        alive = np.ones(x.shape[0], bool)
        alive[::5] = False
    jcfg, tcfg = _cfg_pair(**kw)
    key = jax.random.key(1)
    jrt = _jax_router(x, jcfg, key, alive)
    w = np.asarray(jax.random.uniform(key, (x.shape[0],)))
    trt = tr.build_router(x, cfg=tcfg, weights=w, alive=alive,
                          backend="auto", device="cpu")
    np.testing.assert_allclose(trt.centroids.numpy(),
                               np.asarray(jrt.centroids), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(trt.assign.numpy(), np.asarray(jrt.assign))
    np.testing.assert_array_equal(trt.counts.numpy(), np.asarray(jrt.counts))
    np.testing.assert_array_equal(trt.members.idx.numpy(),
                                  np.asarray(jrt.members.idx))
    x2 = (x * x).sum(1)
    mi = np.asarray(jrt.members.idx)
    _close(trt.members.dist.numpy(), np.asarray(jrt.members.dist),
           x2[mi.clip(0)] + np.asarray(jrt.c2)[:, None])
    if case != "tiny":                        # no tied centroids
        np.testing.assert_array_equal(trt.graph.numpy(),
                                      np.asarray(jrt.graph))
    assert trt.stale == 0


# ---------------------------------------------------------------------------
# route_entries, maintenance
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def routed():
    """A 512-point corpus, its JAX graph and a JAX router."""
    x = np.asarray(jdatasets.clustered(jax.random.key(4), 512, 16, 8))
    _, gidx, _ = jnd.build_knn_graph(
        jnp.asarray(x), k=10, cfg=jnd.DescentConfig(k=10, rho=1.0,
                                                    max_iters=15),
        key=jax.random.key(5))
    jcfg, _ = _cfg_pair(n_centroids=16, sample=512, members=8)
    return x, np.asarray(gidx), _jax_router(x, jcfg, jax.random.key(6))


@pytest.mark.parametrize("beam,t", [(32, 2), (8, 4), (200, 3)])
def test_route_entries_matches_jax(routed, beam, t):
    x, _, jrt = routed
    q = x[:9] + 0.01
    want = jr.route_entries(jrt, jnp.asarray(q), beam, t=t)
    got = tr.route_entries(_port_router(jrt), torch.from_numpy(q), beam, t=t)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_router_insert_and_delete_match_jax(routed):
    """Incremental maintenance from one router state: assignments,
    counts, member lists and the drift counter, id for id."""
    x, _, jrt = routed
    cap = 640
    jrt = jrt._replace(assign=jnp.concatenate(
        [jrt.assign, jnp.full((cap - 512,), -1, jnp.int32)]))
    trt = _port_router(jrt)
    ids = np.arange(512, 560, dtype=np.int32)
    q = x[:48] + 0.05
    j1 = jr.router_insert(jrt, jnp.asarray(ids), jnp.asarray(q))
    t1 = tr.router_insert(trt, torch.from_numpy(ids), torch.from_numpy(q))
    for name in ("assign", "counts"):
        np.testing.assert_array_equal(getattr(t1, name).numpy(),
                                      np.asarray(getattr(j1, name)))
    np.testing.assert_array_equal(t1.members.idx.numpy(),
                                  np.asarray(j1.members.idx))
    assert t1.stale == int(j1.stale) == 48
    alive = np.zeros(cap, bool)
    alive[:560] = True
    dead = np.concatenate([np.arange(0, 40), [515, 530]]).astype(np.int32)
    alive[dead] = False
    j2 = jr.router_delete(j1, jnp.asarray(dead), jnp.asarray(alive))
    t2 = tr.router_delete(t1, torch.from_numpy(dead),
                          torch.from_numpy(alive))
    for name in ("assign", "counts"):
        np.testing.assert_array_equal(getattr(t2, name).numpy(),
                                      np.asarray(getattr(j2, name)))
    np.testing.assert_array_equal(t2.members.idx.numpy(),
                                  np.asarray(j2.members.idx))
    np.testing.assert_array_equal(t2.members.new.numpy(),
                                  np.asarray(j2.members.new))
    assert t2.stale == int(j2.stale)
    assert int(t2.counts.sum()) == int(alive.sum())


def test_needs_rebuild_matches_jax(routed):
    _, _, jrt = routed
    jcfg, tcfg = _cfg_pair(rebuild_frac=0.25)
    trt = _port_router(jrt)
    for stale in (0, 63, 64, 65, 1000):
        for live in (0, 256, 4000):
            assert tr.needs_rebuild(trt._replace(stale=stale), live, tcfg) \
                == jr.needs_rebuild(jrt._replace(stale=jnp.int32(stale)),
                                    live, jcfg)


# ---------------------------------------------------------------------------
# routed graph_search
# ---------------------------------------------------------------------------

def _routed_search_pair(x, gidx, jrt, q, cfg_kw, alive=None, k_out=10):
    key = jax.random.key(9)
    jcfg = JSearchConfig(**cfg_kw)
    jalive = None if alive is None else jnp.asarray(alive)
    jd, ji = jgraph_search(jnp.asarray(x), jnp.asarray(gidx), jnp.asarray(q),
                           k_out=k_out, key=key, cfg=jcfg, router=jrt,
                           alive=jalive)
    n = x.shape[0]
    t = min(jcfg.router_t, jrt.centroids.shape[0])
    width = min(max(jcfg.beam, t * jrt.members.idx.shape[1]), n)
    fill = np.asarray(jdraw_entries(key, n, width, jalive))
    td, ti = graph_search(x, gidx, q, k_out=k_out, cfg=SearchConfig(**cfg_kw),
                          router=_port_router(jrt), route_fill=fill,
                          alive=alive, device="cpu")
    return (np.asarray(jd), np.asarray(ji)), (td.numpy(), ti.numpy())


@pytest.mark.parametrize("case", ["plain", "tombstones", "router_t2"])
def test_routed_graph_search_matches_jax(routed, case):
    """Routed seeds (t*m wide, holes filled from the same draw) give the
    JAX package's ids on the fused path."""
    x, gidx, jrt = routed
    q = x[::17][:24] + 0.01
    alive = None
    cfg_kw = dict(beam=16, rounds=12, expand=4, q_block=16)
    if case == "tombstones":
        alive = np.ones(512, bool)
        alive[::3] = False
    if case == "router_t2":
        cfg_kw["router_t"] = 2
    (jd, ji), (td, ti) = _routed_search_pair(x, gidx, jrt, q, cfg_kw, alive)
    fin = np.isfinite(jd)
    np.testing.assert_array_equal(ti[fin], ji[fin])
    assert (ti[~np.isfinite(td)] == -1).all()
    q2, x2 = (q * q).sum(1), (x * x).sum(1)
    _close(td, jd, q2[:, None] + x2[ji.clip(0)])
    if alive is not None:
        assert alive[ti[ti >= 0]].all()


def test_wide_routed_seeds_merge_in_slices(routed):
    """8400 seeds are wider than the pool the merge kernel holds in
    registers (8192 with the beam): the seed merge keeps what the plain
    merge keeps. Members 512 at t 4 give 2048 seeds, and the routed search
    still returns the JAX package's ids (JAX merges all seeds at once)."""
    x, gidx, _ = routed
    jcfg, _ = _cfg_pair(n_centroids=4, sample=512, members=512)
    jrt = _jax_router(x, jcfg, jax.random.key(8))
    rng = np.random.default_rng(0)
    qb, beam, e = 2, 32, 8400
    assert e > MERGE_MAX_POOL - beam              # the wide merge
    ids = rng.integers(-1, 512, (qb, e)).astype(np.int32)
    # a seed's distance is a function of its id (one query, one row), with
    # repeated ids and tied distances of distinct ids across the pool
    table = rng.random((qb, 512)).astype(np.float32)
    table[:, ::5] = table[:, 3:4]
    dd = np.take_along_axis(table, ids.clip(0), axis=1)
    empty = NeighborLists(torch.full((qb, beam), torch.inf),
                          torch.full((qb, beam), -1, dtype=torch.int32),
                          torch.zeros((qb, beam), dtype=torch.bool))
    pool = _seed_merge(empty, torch.from_numpy(dd), torch.from_numpy(ids),
                       "ref")
    wd, wi, _ = ref.knn_merge(empty.dist, empty.idx,
                              torch.where(torch.from_numpy(ids) >= 0,
                                          torch.from_numpy(dd), torch.inf),
                              torch.from_numpy(ids))
    assert torch.equal(pool.idx, wi) and torch.equal(pool.dist, wd)
    assert torch.equal(pool.new, wi >= 0)
    q = x[::40][:8] + 0.01
    cfg_kw = dict(beam=32, rounds=8, expand=4, q_block=8)
    (jd, ji), (td, ti) = _routed_search_pair(x, gidx, jrt, q, cfg_kw)
    fin = np.isfinite(jd)
    np.testing.assert_array_equal(ti[fin], ji[fin])


def test_router_off_and_ref_backend_keep_random_entries(routed):
    """cfg.router="off" and backend="ref" ignore the router."""
    x, gidx, jrt = routed
    trt = _port_router(jrt)
    q = x[:16] + 0.01
    ent = torch.randperm(512, generator=torch.Generator().manual_seed(1))[:32]
    for cfg in (SearchConfig(router="off"), SearchConfig(backend="ref")):
        g = torch.Generator().manual_seed(3)
        base = graph_search(x, gidx, q, k_out=8, cfg=cfg, device="cpu",
                            generator=g)
        g = torch.Generator().manual_seed(3)
        with_r = graph_search(x, gidx, q, k_out=8, cfg=cfg, device="cpu",
                              generator=g, router=trt)
        assert torch.equal(base[1], with_r[1])
        assert torch.equal(base[0], with_r[0])
        # an explicit entry wins over the router on every backend
        a = graph_search(x, gidx, q, k_out=8, cfg=cfg, device="cpu",
                         entry=ent)
        b = graph_search(x, gidx, q, k_out=8, cfg=cfg, device="cpu",
                         entry=ent, router=trt)
        assert torch.equal(a[1], b[1])


def test_routed_entries_beat_random_on_clusters():
    """The JAX router test's shape, cut to 24 clusters x 128 rows: with
    per-cluster exact graphs (no edge between clusters), 32 random
    entries miss many clusters, routed entries find them (the JAX test's
    floors: routed >= 0.85, random < 0.75)."""
    n_c, per, d, k = 24, 128, 16, 10
    kc, kn = jax.random.split(jax.random.key(7))
    cent = np.asarray(jax.random.normal(kc, (n_c, d))) * 12.0
    noise = np.asarray(jax.random.normal(kn, (n_c, per, d)))
    x = (cent[:, None, :] + noise).reshape(n_c * per, d).astype(np.float32)
    parts = [np.asarray(jbrute(jnp.asarray(x[c * per:(c + 1) * per]),
                               jnp.asarray(x[c * per:(c + 1) * per]), k)[1])
             + c * per for c in range(n_c)]
    gidx = np.concatenate(parts).astype(np.int32)
    q = x[::32] + 0.01
    _, ti = brute_force_knn(x, q, k, exclude_self=False, device="cpu")
    cfg = SearchConfig(beam=32, rounds=24, expand=4)
    g = torch.Generator().manual_seed(11)
    _, ri = graph_search(x, gidx, q, k_out=10, cfg=cfg, generator=g,
                         device="cpu")
    router = tr.build_router(x, cfg=RouterConfig(n_centroids=96, iters=6),
                             device="cpu")
    g = torch.Generator().manual_seed(11)
    _, si = graph_search(x, gidx, q, k_out=10, cfg=cfg, generator=g,
                         router=router, device="cpu")
    rnd, rtd = recall_at_k(ri, ti), recall_at_k(si, ti)
    assert rnd < 0.75, rnd
    assert rtd >= 0.85 and rtd > rnd, (rtd, rnd)


def test_build_router_defaults_to_the_card():
    x = np.zeros((16, 8), np.float32)
    if torch.cuda.is_available():
        assert tr.build_router(x).centroids.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tr.build_router(x)


def test_router_config_fields_match_jax():
    assert [f.name for f in dataclasses.fields(RouterConfig)] == \
        [f.name for f in dataclasses.fields(jr.RouterConfig)]
    assert dataclasses.asdict(RouterConfig()) == \
        dataclasses.asdict(jr.RouterConfig())
