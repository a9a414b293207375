"""The port's sharded serving layer (repro_torch.core.distributed) against
the JAX package (repro.core.distributed) on the same inputs and draws.

The JAX side runs once, in a forked interpreter with 4 forced CPU devices
(``conftest.run_with_devices``): the cluster-aligned 1024 x 16 corpus of
tests/test_distributed.py's routed test at P = 4, its per-shard graphs
and router, each shard's entry draw (``_draw_entries(fold_in(key, p),
...)``), and the outputs and stats of the replicated, routed, dead-shard,
int8 and cosine dispatches, ``exact_knn_sharded`` and ``fetch_rows_a2a``
(in a ``shard_map``), written to one ``.npz``. The port runs the same
inputs on ``ShardMesh.on(4, device="cpu")`` with the JAX draws injected
(``entries=``, ``route_fill=``). P = 1 is held in-process against the
JAX function on the main process's single-device mesh.

Tolerances: distances within 1e-4 + 1e-5 (|q|^2 + |x|^2), the repo's
limit for the norm expansion on large-norm rows (ROADMAP, Queue 3: this
corpus's |x|^2 is about 1000); ids exact but where two ids lie at the
same distance to that limit (checked in fp64, counted); stats equal; fetched rows and masks bitwise; the breakers'
``stats()`` equal at every step of a seeded trace.
"""
import contextlib
import json
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import run_with_devices
from repro.core import distributed as jdist
from repro.core import faults as jfaults
from repro.core.graph_search import SearchConfig as JSearchConfig
from repro.core.graph_search import _draw_entries as jdraw
from repro_torch import DescentConfig, SearchConfig, build_knn_graph
from repro_torch.core import distributed as tdist
from repro_torch.core import faults as tfaults
from repro_torch.core.router import router_from_numpy
from repro_torch.serve.scheduler import (
    RetrievalScheduler,
    SchedulerConfig,
)

P, N, D, K_OUT, KEY = 4, 1024, 16, 10, 2
N_LOCAL = N // P
FETCH_M, FETCH_CAP = 64, 12
SCFG = dict(beam=32, rounds=24, expand=4)

_CHILD = """
import json
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as Ps
from repro.core import DescentConfig, RouterConfig, SearchConfig, metric
from repro.core.distributed import (exact_knn_sharded, fetch_rows_a2a,
                                    graph_search_sharded, shard_map)
from repro.core.faults import FaultPlan, FaultSpec
from repro.core.graph_search import _draw_entries
from repro.core.nn_descent import build_knn_graph
from repro.core.router import build_router

P, n, d, k_out = {P}, {N}, {D}, {K_OUT}
n_local = n // P
mesh = jax.make_mesh((P,), ('data',))
# cluster-aligned rows: shard s holds one tight cluster
cent = jax.random.normal(jax.random.key(0), (P, d)) * 8.0
noise = jax.random.normal(jax.random.key(1), (P, n_local, d)) * 0.5
x = (cent[:, None, :] + noise).reshape(n, d).astype(jnp.float32)
cfg = DescentConfig(k=10, rho=1.0, max_iters=10, reorder=False)
gidx = jnp.concatenate([
    build_knn_graph(x[s*n_local:(s+1)*n_local], k=10, cfg=cfg,
                    key=jax.random.key(s))[1] for s in range(P)])
router = build_router(x, cfg=RouterConfig(n_centroids=32, sample=1024),
                      key=jax.random.key(7))
q = x[::8] + 0.01
scfg = SearchConfig(**{SCFG})
key = jax.random.key({KEY})
e_w = min(scfg.beam, n_local)
out = dict(x=x, gidx=gidx, q=q, centroids=router.centroids, c2=router.c2,
           graph=router.graph, m_dist=router.members.dist,
           m_idx=router.members.idx, m_new=router.members.new,
           assign=router.assign, counts=router.counts,
           stale=router.stale)
out['entries'] = np.stack([np.asarray(_draw_entries(
    jax.random.fold_in(key, p), n_local, scfg.beam, None))
    for p in range(P)])
out['fill'] = np.stack([np.asarray(_draw_entries(
    jax.random.fold_in(key, p), n_local, e_w, None)) for p in range(P)])
stats = {{}}

def run(name, xx=x, c=scfg, **kw):
    dd, ii, st = graph_search_sharded(mesh, xx, gidx, q, k_out=k_out,
                                      cfg=c, key=key, with_stats=True, **kw)
    out[name + '_d'], out[name + '_i'] = dd, ii
    stats[name] = st

dead = FaultPlan(specs=(FaultSpec(site='shard.dead', arg=1),))
run('rep')
run('routed', router=router, route_p=2)
run('routed_cap', router=router, route_p=2, route_cap=40)
with dead.active():
    run('dead_rep')
with dead.active():
    run('dead_routed', router=router, route_p=2)
run('int8', c=SearchConfig(**{SCFG}, precision='int8'))
xc, _ = metric.transform_corpus(x, 'cosine')
out['xc'] = xc
run('cosine', xx=xc, c=SearchConfig(**{SCFG}, metric='cosine'))
out['exact_d'], out['exact_i'] = exact_knn_sharded(mesh, x, 10)

ids = np.random.default_rng(5).integers(-1, n, (P, {FETCH_M}))
ids = jnp.asarray(ids, jnp.int32)
fetch = shard_map(
    lambda xl, il: fetch_rows_a2a(xl, il[0], axis='data', P_=P,
                                  n_local=n_local, cap={FETCH_CAP}),
    mesh=mesh, in_specs=(Ps('data', None), Ps('data', None)),
    out_specs=(Ps('data', None), Ps('data')), check_vma=False)
rows, ok = fetch(x, ids)
out.update(fetch_ids=ids, fetch_rows=rows, fetch_ok=ok)
np.savez(OUT_PATH, **{{k: np.asarray(v) for k, v in out.items()}})
print('STATS ' + json.dumps(stats))
"""


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The JAX package's P = 4 run: (arrays, stats)."""
    path = str(tmp_path_factory.mktemp("sharded") / "ref.npz")
    code = f"OUT_PATH = {path!r}\n" + _CHILD.format(
        P=P, N=N, D=D, K_OUT=K_OUT, KEY=KEY, SCFG=SCFG, FETCH_M=FETCH_M,
        FETCH_CAP=FETCH_CAP)
    out = run_with_devices(code, n=P, timeout=300)
    line = [ln for ln in out.splitlines() if ln.startswith("STATS ")][-1]
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    return arrays, json.loads(line[len("STATS "):])


@pytest.fixture(scope="module")
def mesh():
    return tdist.ShardMesh.on(P, device="cpu")


def _router(a):
    return router_from_numpy(a["centroids"], a["c2"], a["graph"],
                             (a["m_dist"], a["m_idx"], a["m_new"]),
                             a["assign"], a["counts"], a["stale"],
                             device="cpu")


def _port(a, mesh, x=None, cfg=None, **kw):
    return tdist.graph_search_sharded(
        mesh, a["x"] if x is None else x, a["gidx"], a["q"], k_out=K_OUT,
        cfg=cfg or SearchConfig(**SCFG), with_stats=True,
        entries=a["entries"], route_fill=a["fill"], **kw)


def _same_up_to_ties(got_d, got_i, want_d, want_i, x, q):
    """Distances within 1e-4 + 1e-5 (|q|^2 + |x|^2) (the norm expansion
    cancels the digits the norms share, so two fp32 sums in another order
    differ by about eps * |q||x|); ids equal but where both ids lie at the
    same distance from the query to that tolerance (recomputed in fp64).
    Returns the count of such tied positions that differ."""
    got_d, got_i = np.asarray(got_d), np.asarray(got_i)
    want_d, want_i = np.asarray(want_d), np.asarray(want_i)
    np.testing.assert_array_equal(got_i < 0, want_i < 0)
    x, q = np.asarray(x, np.float64), np.asarray(q, np.float64)
    x2, q2 = (x * x).sum(1), (q * q).sum(1)
    tol = 1e-4 + 1e-5 * (q2[:, None] + x2[np.maximum(want_i, 0)])
    fin = np.isfinite(want_d)
    np.testing.assert_array_equal(fin, np.isfinite(got_d))
    assert (np.abs(got_d[fin] - want_d[fin]) <= tol[fin]).all()
    rows, cols = np.nonzero(got_i != want_i)
    for r, c in zip(rows, cols):
        dg = ((x[got_i[r, c]] - q[r]) ** 2).sum()
        dw = ((x[want_i[r, c]] - q[r]) ** 2).sum()
        assert abs(dg - dw) <= tol[r, c], (r, c, dg, dw)
    return len(rows)


def _ties_ok(n_diff, shape):
    assert n_diff <= 0.01 * np.prod(shape), n_diff


@pytest.mark.parametrize("name", ["rep", "routed", "routed_cap", "dead_rep",
                                  "dead_routed", "int8", "cosine"])
def test_dispatch_matches_jax(ref, mesh, name):
    """Every dispatch, on the JAX package's corpus, graphs, router and
    draws: the same ids and fp32 distances, the same stats."""
    a, stats = ref
    kw, x = {}, a["x"]
    if name.endswith("routed") or name == "routed_cap":
        kw.update(router=_router(a), route_p=2)
    if name == "routed_cap":
        kw.update(route_cap=40)
    cfg = SearchConfig(**SCFG)
    if name == "int8":
        cfg = SearchConfig(**SCFG, precision="int8")
    if name == "cosine":
        cfg = SearchConfig(**SCFG, metric="cosine")
        x = a["xc"]
    plan = tfaults.FaultPlan(specs=(tfaults.FaultSpec(site="shard.dead",
                                                      arg=1),))
    if name.startswith("dead"):
        with plan.active():
            d, i, st = _port(a, mesh, x=x, cfg=cfg, **kw)
        assert not (i.numpy() // N_LOCAL == 1).any()
    else:
        d, i, st = _port(a, mesh, x=x, cfg=cfg, **kw)
    assert st == stats[name]
    qt = a["q"]
    if name == "cosine":
        qt = qt / np.linalg.norm(qt, axis=1, keepdims=True)
    _ties_ok(_same_up_to_ties(d, i, a[name + "_d"], a[name + "_i"], x, qt),
             i.shape)


def test_routed_keeps_the_reference_pins(ref, mesh):
    """tests/test_distributed.py's routed pins on the port at P = 4:
    fan-out 2, nothing dropped, routed recall > 0.9 and >= 0.95 overlap
    with the replicated dispatch."""
    from repro_torch import brute_force_knn, recall_at_k
    a, _ = ref
    _, ri, _ = _port(a, mesh)
    _, i, st = _port(a, mesh, router=_router(a), route_p=2)
    assert st["fanout"] == 2 and st["shards"] == P
    assert st["dropped_queries"] == 0
    assert st["searched_queries"] == st["routed_queries"]
    ra, rb = ri.numpy(), i.numpy()
    inter = np.mean([len(set(ra[r]) & set(rb[r])) / K_OUT
                     for r in range(ra.shape[0])])
    assert inter >= 0.95, inter
    _, ti = brute_force_knn(a["x"], a["q"], K_OUT, exclude_self=False,
                            device="cpu")
    assert recall_at_k(i, ti) > 0.9


def test_dead_replicated_is_the_survivors_merge(ref, mesh):
    """A dead shard's lists are masked out: the dispatch equals the
    dispatch that never had the shard's lists, i.e. the stable merge of
    the three survivors' direct searches."""
    from repro_torch import graph_search
    a, _ = ref
    d, i, st = _port(a, mesh, dead_shards=[1])
    assert st["degraded_shards"] == [1] and st["cover_frac"] == 0.75
    parts_d, parts_i = [], []
    for p in (0, 2, 3):
        sl = slice(p * N_LOCAL, (p + 1) * N_LOCAL)
        pd, pi = graph_search(a["x"][sl], a["gidx"][sl], a["q"], k_out=K_OUT,
                              entry=a["entries"][p],
                              cfg=SearchConfig(**SCFG), device="cpu")
        parts_d.append(pd)
        parts_i.append(torch.where(pi >= 0, pi + p * N_LOCAL, -1))
    md, order = torch.sort(torch.cat(parts_d, 1), dim=1, stable=True)
    mi = torch.gather(torch.cat(parts_i, 1), 1, order)
    assert torch.equal(d, md[:, :K_OUT]) and torch.equal(i, mi[:, :K_OUT])


def test_exact_knn_sharded_matches_jax(ref, mesh):
    a, _ = ref
    d, i = tdist.exact_knn_sharded(mesh, a["x"], 10)
    _ties_ok(_same_up_to_ties(d, i, a["exact_d"], a["exact_i"], a["x"],
                              a["x"]), i.shape)


def test_fetch_rows_a2a_matches_jax(ref, mesh):
    """Rows and masks bitwise; ``ok`` is exactly the in-bucket, non-
    negative ids, and the rows are x[ids] there."""
    a, _ = ref
    xs = mesh.split(a["x"])
    ids = a["fetch_ids"]
    rows, ok = tdist.fetch_rows_a2a(mesh, xs, list(ids), cap=FETCH_CAP)
    rows, ok = torch.cat(rows).numpy(), torch.cat(ok).numpy()
    np.testing.assert_array_equal(rows, a["fetch_rows"])
    np.testing.assert_array_equal(ok, a["fetch_ok"])
    assert 0 < ok.sum() < (ids >= 0).sum()          # some buckets overflow
    flat = ids.reshape(-1)
    np.testing.assert_array_equal(rows[ok], a["x"][flat[ok]])
    assert not rows[~ok].any()


@pytest.mark.parametrize("poison", [False, True])
def test_single_shard_matches_jax_in_process(ref, poison):
    """P = 1 against JAX's graph_search_sharded on the main process's
    one-device mesh, on shard 0's rows and graph (a NaN query row is
    sanitized to (+inf, -1) by both); global ids in the graph raise in
    both."""
    a, _ = ref
    x, g = a["x"][:N_LOCAL], a["gidx"][:N_LOCAL]
    q = a["q"].copy()
    if poison:
        q[3] = np.nan
    jmesh = jax.make_mesh((1,), ("data",))
    key = jax.random.key(KEY)
    ent = np.array(jdraw(jax.random.fold_in(key, 0), N_LOCAL,
                         SCFG["beam"], None))
    with pytest.warns(RuntimeWarning) if poison else contextlib.nullcontext():
        jd, ji = jdist.graph_search_sharded(
            jmesh, jnp.asarray(x), jnp.asarray(g), jnp.asarray(q),
            k_out=K_OUT, cfg=JSearchConfig(**SCFG), key=key)
    with pytest.warns(RuntimeWarning) if poison else contextlib.nullcontext():
        d, i = tdist.graph_search_sharded(
            tdist.ShardMesh.on(1, device="cpu"), x, g, q, k_out=K_OUT,
            cfg=SearchConfig(**SCFG), entries=ent[None])
    _ties_ok(_same_up_to_ties(d, i, jd, ji, x, np.nan_to_num(q)), i.shape)
    if poison:
        assert (i[3] == -1).all() and torch.isinf(d[3]).all()
    with pytest.raises(ValueError, match="n_local"):
        jdist.graph_search_sharded(jmesh, jnp.asarray(x),
                                   jnp.asarray(g) + N_LOCAL,
                                   jnp.asarray(a["q"]), key=key)
    with pytest.raises(ValueError, match="n_local"):
        tdist.graph_search_sharded(tdist.ShardMesh.on(1, device="cpu"), x,
                                   g + N_LOCAL, a["q"])


def test_single_shard_draws_what_graph_search_draws(ref):
    """Without injected draws, shard 0's generator is seeded with the
    batch key itself: one shard returns graph_search's own answer."""
    from repro_torch import graph_search
    a, _ = ref
    x, g = a["x"][:N_LOCAL], a["gidx"][:N_LOCAL]
    d, i = tdist.graph_search_sharded(tdist.ShardMesh.on(1, device="cpu"),
                                      x, g, a["q"], k_out=K_OUT,
                                      cfg=SearchConfig(**SCFG))
    wd, wi = graph_search(x, g, a["q"], k_out=K_OUT,
                          cfg=SearchConfig(**SCFG), device="cpu")
    assert torch.equal(d, wd) and torch.equal(i, wi)


def test_mesh_on_needs_a_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tdist.ShardMesh.on(4)
    with pytest.raises(RuntimeError, match="CUDA"):
        tdist.ShardMesh(["cuda:0"] * 4)
    mesh = tdist.ShardMesh.on(4, device="cpu")
    assert mesh.devices == (torch.device("cpu"),) * 4
    assert mesh.shape == {"data": 4}


# ---------------------------------------------------------------------------
# the circuit breaker, in both packages
# ---------------------------------------------------------------------------

BREAKERS = {"jax": (jdist.ShardBreaker, jdist.BreakerConfig),
            "port": (tdist.ShardBreaker, tdist.BreakerConfig)}


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_breaker_trips_and_recovers(pkg):
    ShardBreaker, BreakerConfig = BREAKERS[pkg]
    b = ShardBreaker(4, BreakerConfig(min_samples=2, probe_every=3))
    for _ in range(2):
        assert b.excluded() == []
        b.observe({0: 1.0, 1: 1.0, 2: 1.0, 3: 12.0})
    assert b.open[3] and b.stats()["trips"] == 1
    assert b.excluded() == [3]
    b.observe({0: 1.0, 1: 1.0, 2: 1.0})
    recovered = False
    for _ in range(8):
        ex = b.excluded()
        b.observe({s: 1.0 for s in range(4) if s not in ex})
        if not b.open[3]:
            recovered = True
            break
    assert recovered
    st = b.stats()
    assert st["probes"] >= 1 and st["recoveries"] == 1
    assert st["open_shards"] == []


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_breaker_unhealthy_probe_stays_open(pkg):
    ShardBreaker, BreakerConfig = BREAKERS[pkg]
    b = ShardBreaker(3, BreakerConfig(min_samples=2, probe_every=2))
    for _ in range(3):
        b.excluded()
        b.observe({0: 1.0, 1: 1.0, 2: 20.0})
    assert b.open[2]
    for _ in range(6):
        ex = b.excluded()
        lat = {s: 1.0 for s in range(3) if s not in ex}
        if 2 in lat:
            lat[2] = 20.0
        b.observe(lat)
    assert b.open[2] and b.stats()["recoveries"] == 0


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_breaker_never_excludes_all(pkg):
    ShardBreaker, BreakerConfig = BREAKERS[pkg]
    b = ShardBreaker(2, BreakerConfig(probe_every=1000))
    b.ewma = [2.0, 1.0]
    b.open = [True, True]
    assert b.excluded() == [0]


@pytest.mark.parametrize("seed", [0, 1])
def test_breaker_trace_matches_jax(seed):
    """One seeded trace of random latencies (some shards slow for a
    while, some samples missing) through both breakers: the same
    exclusions and stats() at every step."""
    rng = random.Random(seed)
    cfg = dict(alpha=0.4, trip_ratio=2.5, min_samples=2, probe_every=3,
               recover_ratio=1.5)
    bj = jdist.ShardBreaker(5, jdist.BreakerConfig(**cfg))
    bt = tdist.ShardBreaker(5, tdist.BreakerConfig(**cfg))
    slow = {}
    for step in range(300):
        if rng.random() < 0.05:
            slow[rng.randrange(5)] = rng.uniform(3.0, 30.0)
        if slow and rng.random() < 0.04:
            slow.pop(rng.choice(sorted(slow)))
        ex = bj.excluded()
        assert bt.excluded() == ex
        lat = {s: rng.uniform(0.8, 1.2) * slow.get(s, 1.0)
               for s in range(5) if s not in ex and rng.random() > 0.05}
        bj.observe(lat)
        bt.observe(lat)
        assert bt.stats() == bj.stats(), step
    assert bj.trips > 0 and bj.recoveries > 0


def _small_sharded(seed=0):
    """tests/test_scheduler.py's breaker scenario, built by the port: 256
    x 16 normal rows over 4 shards, a k 8 graph per shard."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(256, 16, generator=g)
    parts = [build_knn_graph(x[p * 64:(p + 1) * 64], 8,
                             generator=torch.Generator().manual_seed(p),
                             device="cpu")[1] for p in range(P)]
    return x, torch.cat(parts), torch.randn(8, 16, generator=g)


def test_breaker_wired_into_sharded_search():
    """shard.degrade inflates shard 2's samples until the breaker trips it
    into the degraded merge; the next dispatch reports it and returns no
    id of it (tests/test_scheduler.py:361 on the port)."""
    x, gidx, q = _small_sharded()
    mesh = tdist.ShardMesh.on(P, device="cpu")
    cfg = SearchConfig(beam=16, rounds=8, q_block=8)
    br = tdist.ShardBreaker(P, tdist.BreakerConfig(min_samples=3,
                                                   probe_every=50))
    plan = tfaults.FaultPlan(seed=0, specs=(
        tfaults.FaultSpec(site="shard.degrade", arg=(2, 40.0)),))
    with plan.active():
        for _ in range(4):
            _, _, st = tdist.graph_search_sharded(
                mesh, x, gidx, q, k_out=5, cfg=cfg, with_stats=True,
                breaker=br)
    assert br.open[2], br.stats()
    assert st["breaker"]["trips"] == 1, st
    _, i, st = tdist.graph_search_sharded(mesh, x, gidx, q, k_out=5,
                                          cfg=cfg, with_stats=True,
                                          breaker=br)
    assert 2 in st["degraded_shards"], st
    assert st["cover_frac"] == 0.75
    assert bool((i >= 0).all())
    assert not (i // 64 == 2).any()


def test_scheduler_serves_a_burst_through_the_sharded_search():
    """A RetrievalScheduler in front of graph_search_sharded with a
    breaker (the search_fn the JAX scheduler's docstring names): every
    request of a burst larger than the queue is answered or carries a
    typed rejection, and every dispatch went through the breaker."""
    x, gidx, _ = _small_sharded(1)
    mesh = tdist.ShardMesh.on(P, device="cpu")
    br = tdist.ShardBreaker(P)

    def search_fn(queries, cfg):
        return tdist.graph_search_sharded(mesh, x, gidx, queries, k_out=5,
                                          cfg=cfg, breaker=br)
    sched = RetrievalScheduler(
        search_fn, base_cfg=SearchConfig(beam=16, rounds=8, q_block=16),
        cfg=SchedulerConfig(max_queue=48, max_batch=16))
    rng = np.random.default_rng(3)
    reqs = [sched.submit(rng.standard_normal(16).astype(np.float32),
                         lane="interactive" if j % 3 else "batch")
            for j in range(64)]
    served = sched.run_until_drained()
    assert all(r.done for r in reqs)
    rejected = [r for r in reqs if r.rejection is not None]
    assert len(served) + len(rejected) == len(reqs) and rejected
    assert all(r.rejection.code for r in rejected)
    for r in served:
        assert r.idx.shape == (5,) and (r.idx >= 0).all() \
            and (r.idx < 256).all()
    assert br.dispatches == sched.dispatches > 1


def test_fault_registries_are_separate():
    """The port's FaultPlan and the JAX package's are separate registries:
    activating one leaves the other's shard sites silent."""
    plan = tfaults.FaultPlan(specs=(tfaults.FaultSpec(site="shard.dead",
                                                      arg=1),))
    with plan.active():
        assert tfaults.dead_shards(4) == [1]
        assert jfaults.dead_shards(4) == []
