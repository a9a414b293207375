"""The port's sharded build (repro_torch.core.distributed's build half)
against the JAX package's (repro.core.distributed) on the same inputs and
draws.

The JAX side runs once, in a forked interpreter with 4 forced CPU devices
(``conftest.run_with_devices``), on tests/test_distributed.py:29-48's
corpus and config at P = 4. Its ``build_knn_graph_sharded`` calls its
``shard_map``s eagerly, a minute an iteration here, so the child wraps
the function's own init body, ``nn_descent_sharded_iteration`` and
``polish_sharded_round`` each in one ``jax.jit(shard_map(...))`` and
runs the function's driver loop with them, on its key schedule. It
writes the whole build's output and stats, the draws of that key
schedule (init ids, then each iteration's five uniforms a shard), the
state around the first iteration (fetch a2a and ring) and around the
first polish round, and ``_all_to_all_route`` on a payload whose buckets
overflow, to one ``.npz``. The port runs the same inputs on
``ShardMesh.on(4, device="cpu")`` with those draws injected.

Tolerances: the route exact; a step's distances within 1e-4 + 1e-5
(|a|^2 + |b|^2) (the repo's limit for the norm expansion on large-norm
rows; this corpus's |x|^2 is about 2300), ids exact but where the two
packages' entries lie at the same distance to that limit (checked in
fp64), at most 0.1% of slots, counted and printed; evaluations exact,
updates within the count of such slots. The whole build: the
single-card build's bar (tests/test_torch_build.py:86-92) but for the
share of equal slots, which is held to the fp32 noise floor that the
test measures on the port itself instead of to 0.99
(``test_whole_build_matches_jax`` says why).
"""
import json

import jax
import numpy as np
import pytest
import torch

from conftest import run_with_devices
from repro.core import datasets as jdatasets
from repro.core import distributed as jdist
from repro.core.recall import brute_force_knn as jbrute
from repro_torch import DescentConfig, NeighborLists, recall_at_k
from repro_torch.core import (
    ShardedBuildDraws,
    ShardMesh,
    build_knn_graph_sharded,
    make_sharded_iteration,
    nn_descent_sharded_iteration,
    polish_sharded_round,
)
from repro_torch.core import datasets
from repro_torch.core import distributed as tdist

P, N, D, K = 4, 1024, 16, 10
N_LOCAL = N // P
CFG = dict(k=10, rho=1.5, max_iters=12, merge_size=60, reorder=False)
ROUTE_CAP = 100
TIE_SHARE = 0.001
# the whole build's noise floor: builds on other column orders, and the
# allowance for the floor's own sampling noise (about 51 of 10240 slots)
NOISE_ORDERS, NOISE_MARGIN = 3, 0.005

_CHILD = r'''
import functools, json
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as Ps
from repro.core import DescentConfig, datasets
from repro.core.distributed import (_all_to_all_route, _fetch_features_ring,
                                    nn_descent_sharded_iteration,
                                    polish_sharded_round, shard_map)
from repro.core.heap import NeighborLists

P, n, d, k = {P}, {N}, {D}, {K}
n_local = n // P
mesh = jax.make_mesh((P,), ('data',))
S, R = Ps('data', None), Ps()
x = datasets.clustered(jax.random.key(0), n, d, 8)
cfg = DescentConfig(**{CFG})


def sm(f, in_specs, out_specs):
    return jax.jit(shard_map(f, mesh=mesh, in_specs=in_specs,
                             out_specs=out_specs, check_vma=False))


# the bodies of build_knn_graph_sharded (distributed.py:980-1000,
# :1016-1026, :1050-1058), each jitted once
def init_body(key, x_local):
    p = jax.lax.axis_index('data')
    kk = jax.random.fold_in(key, p)
    idx = jax.random.randint(kk, (n_local, k), 0, n, dtype=jnp.int32)
    my = p * n_local + jnp.arange(n_local, dtype=jnp.int32)[:, None]
    idx = jnp.where(idx == my, (idx + 1) % n, idx)
    x_local = x_local.astype(jnp.float32)
    feats = _fetch_features_ring(x_local, idx.reshape(-1), 'data', P,
                                 n_local).reshape(n_local, k, -1)
    dist = jnp.maximum(
        jnp.sum(x_local * x_local, axis=1)[:, None]
        + jnp.sum(feats * feats, axis=-1)
        - 2.0 * jnp.einsum("nd,nkd->nk", x_local, feats), 0.0)
    order = jnp.argsort(dist, axis=1)
    return (jnp.take_along_axis(dist, order, axis=1),
            jnp.take_along_axis(idx, order, axis=1))


def iter_body(fetch, key, x_local, d_, i_, n_):
    x_local = x_local.astype(jnp.float32)
    x2_local = jnp.sum(x_local * x_local, axis=1)
    kk = jax.random.fold_in(key, jax.lax.axis_index('data'))
    nl2, upd, ev = nn_descent_sharded_iteration(
        kk, x_local, x2_local, NeighborLists(d_, i_, n_ > 0), cfg,
        axis='data', P_=P, fetch=fetch)
    return (nl2.dist, nl2.idx, nl2.new.astype(jnp.int8)), upd, ev


def polish_body(x_local, d_, i_, n_):
    x_local = x_local.astype(jnp.float32)
    x2_local = jnp.sum(x_local * x_local, axis=1)
    nl2, upd, ev = polish_sharded_round(
        x_local, x2_local, NeighborLists(d_, i_, n_ > 0), axis='data',
        P_=P, merge_c=min(6 * k, k * k), backend=cfg.backend)
    return (nl2.dist, nl2.idx, nl2.new.astype(jnp.int8)), upd, ev


init_fn = sm(init_body, (R, S), (S, S))
iter_fn = {{f: sm(functools.partial(iter_body, f), (R, S, S, S, S),
                  ((S, S, S), R, R)) for f in ('a2a', 'ring')}}
polish_fn = sm(polish_body, (S, S, S, S), ((S, S, S), R, R))

# the draws of the key schedule (:982-983, then :234, :252, :260, :322)
rho_k = cfg.rho_k
m = 2 * n_local * k
cap = max(2 * rho_k * max(n_local // P, 1), 8)
m_u = n_local * (rho_k * (rho_k - 1) + 2 * rho_k * rho_k)
uni = jax.random.uniform


def iter_draws(k_it):
    per = []
    for p in range(P):
        k_acc, _, k2 = jax.random.split(jax.random.fold_in(k_it, p), 3)
        k_r1, k_r2, k3 = jax.random.split(k2, 3)
        k_u, _ = jax.random.split(k3)
        per.append([uni(k_acc, (m,)), uni(k_r1, (m,)), uni(k_r2, (m,)),
                    uni(jax.random.fold_in(k3, rho_k), (P * cap,)),
                    uni(k_u, (m_u,))])
    return [np.stack([np.asarray(t[i]) for t in per]) for i in range(5)]


key = jax.random.key(0)
out = {{'x': x, 'init_draws': np.stack([np.asarray(jax.random.randint(
    jax.random.fold_in(key, p), (n_local, k), 0, n, dtype=jnp.int32))
    for p in range(P)])}}
stats = {{}}
dist0, idx0 = init_fn(key, x)
new0 = jnp.ones_like(idx0, dtype=jnp.int8)
out.update(init_d=dist0, init_i=idx0)
k_first = jax.random.split(key)[1]
for f in ('a2a', 'ring'):
    (d_, i_, nf), upd, ev = iter_fn[f](k_first, x, dist0, idx0, new0)
    out.update({{f'it1_{{f}}_d': d_, f'it1_{{f}}_i': i_,
                 f'it1_{{f}}_new': nf}})
    stats[f'it1_{{f}}'] = [int(upd), int(ev)]

# the driver loop of :1028-1067
nl = (dist0, idx0, new0)
total_ev = 0
for it in range(cfg.max_iters):
    key, k_it = jax.random.split(key)
    for i, t in enumerate(iter_draws(k_it)):
        out[f'draw{{it}}_{{i}}'] = t
    (d_, i_, nf), upd, ev = iter_fn['a2a'](k_it, x, *nl)
    nl = (d_, i_, nf)
    total_ev += int(ev)
    if int(upd) <= cfg.delta * n * k:
        break
polish_updates = []
for r in range(cfg.polish):
    if r == 0:
        out.update(pre_polish_d=nl[0], pre_polish_i=nl[1],
                   pre_polish_new=nl[2])
    (d_, i_, nf), upd_p, ev_p = polish_fn(x, *nl)
    nl = (d_, i_, nf)
    if r == 0:
        out.update(polish1_d=d_, polish1_i=i_, polish1_new=nf)
        stats['polish1'] = [int(upd_p), int(ev_p)]
    total_ev += int(ev_p)
    polish_updates.append(int(upd_p))
out.update(final_d=nl[0], final_i=nl[1])
stats['build'] = {{'iters': it + 1, 'dist_evals': total_ev,
                   'polish_updates': polish_updates}}

# _all_to_all_route on a skewed payload: some buckets overflow
MR, W = 512, 3
rng = np.random.default_rng(3)
pay = rng.integers(-3, 1000, (P * MR, W)).astype(np.int32)
dest = rng.choice(P, P * MR, p=[0.5, 0.3, 0.15, 0.05]).astype(np.int32)
mask = rng.random(P * MR) < 0.8
rkey = jax.random.key(9)
route = sm(lambda kr, pl, ms, ds: _all_to_all_route(
    pl, ms, ds, P, {ROUTE_CAP}, 'data',
    jax.random.fold_in(kr, jax.lax.axis_index('data'))),
    (R, S, Ps('data'), Ps('data')), S)
out.update(route_pay=pay, route_dest=dest, route_mask=mask,
           route_out=route(rkey, pay, mask, dest),
           route_rnd=np.stack([np.asarray(uni(jax.random.fold_in(rkey, p),
                                                (MR,))) for p in range(P)]))
np.savez(OUT_PATH, **{{kk: np.asarray(v) for kk, v in out.items()}})
print('STATS ' + json.dumps(stats))
'''


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The JAX package's P = 4 run: (arrays, stats)."""
    path = str(tmp_path_factory.mktemp("sharded_build") / "ref.npz")
    code = f"OUT_PATH = {path!r}\n" + _CHILD.format(
        P=P, N=N, D=D, K=K, CFG=CFG, ROUTE_CAP=ROUTE_CAP)
    out = run_with_devices(code, n=P, timeout=600)
    line = [ln for ln in out.splitlines() if ln.startswith("STATS ")][-1]
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    return arrays, json.loads(line[len("STATS "):])


@pytest.fixture(scope="module")
def mesh():
    return ShardMesh.on(P, device="cpu")


def _draws(a, iters):
    """The JAX schedule's draws: ShardedBuildDraws, torch tensors."""
    t = torch.from_numpy
    return ShardedBuildDraws(t(a["init_draws"]), [
        [tuple(t(a[f"draw{it}_{i}"][p]) for i in range(5))
         for p in range(P)] for it in range(iters)])


def _shards(a, prefix, mesh):
    """Per-shard NeighborLists of the saved global state ``prefix``."""
    new = a.get(prefix + "_new")
    new = np.ones(a[prefix + "_i"].shape, bool) if new is None else new > 0
    cols = [mesh.split(torch.from_numpy(np.asarray(v)))
            for v in (a[prefix + "_d"], a[prefix + "_i"], new)]
    return [NeighborLists(*(c[p] for c in cols)) for p in range(P)]


def _blocks(a, mesh):
    xs = [b.contiguous() for b in mesh.split(torch.from_numpy(a["x"]))]
    return xs, [(b * b).sum(1) for b in xs]


def _lists_match(got, want_d, want_i, x, what):
    """Distances within 1e-4 + 1e-5 (|a|^2 + |b|^2); ids equal but where
    both packages' entries lie at the same distance from the row to that
    tolerance (recomputed in fp64), at most TIE_SHARE of the slots.
    Returns the count of such slots."""
    got_d, got_i = np.asarray(got[0]), np.asarray(got[1])
    x = np.asarray(x, np.float64)
    x2 = (x * x).sum(1)
    rows = np.arange(x.shape[0])[:, None]
    tol = 1e-4 + 1e-5 * (x2[rows] + x2[np.maximum(want_i, 0)])
    np.testing.assert_array_equal(got_i < 0, want_i < 0)
    fin = np.isfinite(want_d)
    np.testing.assert_array_equal(fin, np.isfinite(got_d))
    assert (np.abs(got_d[fin] - want_d[fin]) <= tol[fin]).all(), what
    r, c = np.nonzero(got_i != want_i)
    dg = ((x[got_i[r, c]] - x[r]) ** 2).sum(1)
    dw = ((x[want_i[r, c]] - x[r]) ** 2).sum(1)
    assert (np.abs(dg - dw) <= tol[r, c]).all(), what
    assert (np.abs(dg - got_d[r, c]) <= tol[r, c]).all(), what
    print(f"{what}: {len(r)} of {got_i.size} slots differ at ties")
    assert len(r) <= TIE_SHARE * got_i.size, (what, len(r))
    return len(r)


def _flags_match(got, want_i, want_new):
    """Flags equal wherever the ids are."""
    same = np.asarray(got.idx) == want_i
    np.testing.assert_array_equal(np.asarray(got.new)[same],
                                  (want_new > 0)[same])


def test_all_to_all_route_matches_jax(ref, mesh):
    """Skewed destinations, 80% of the rows masked in, cap 100: the two
    heavy buckets overflow; the received rows equal JAX's, slot for
    slot."""
    a, _ = ref
    m = a["route_pay"].shape[0] // P
    sl = [slice(p * m, (p + 1) * m) for p in range(P)]
    t = torch.from_numpy
    got = tdist._all_to_all_route(
        mesh, [t(a["route_pay"][s]) for s in sl],
        [t(a["route_mask"][s]) for s in sl],
        [t(a["route_dest"][s]) for s in sl], ROUTE_CAP,
        [t(a["route_rnd"][p]) for p in range(P)])
    want = a["route_out"].reshape(P, P * ROUTE_CAP, -1)
    for p in range(P):
        np.testing.assert_array_equal(got[p].numpy(), want[p])
    # some buckets overflowed, some did not
    counts = np.array([[((a["route_dest"][s] == q) & a["route_mask"][s])
                        .sum() for q in range(P)] for s in sl])
    assert (counts > ROUTE_CAP).any() and (counts < ROUTE_CAP).any()


def test_init_matches_jax(ref, mesh):
    """The init body on the JAX draws: the same sorted lists."""
    a, _ = ref
    xs, x2s = _blocks(a, mesh)
    got = tdist._lists_on(mesh, tdist._init_lists(
        mesh, xs, x2s, K, 0, torch.from_numpy(a["init_draws"])))
    _lists_match(got, a["init_d"], a["init_i"], a["x"], "init")
    assert bool(got.new.all())


@pytest.mark.parametrize("fetch", ["a2a", "ring"])
def test_first_iteration_matches_jax(ref, mesh, fetch):
    """One iteration from the JAX init with the JAX draws: the same lists
    and flags up to ties, the same evaluations."""
    a, stats = ref
    xs, x2s = _blocks(a, mesh)
    out, upd, ev = nn_descent_sharded_iteration(
        mesh, xs, x2s, _shards(a, "init", mesh), DescentConfig(**CFG),
        fetch=fetch, draws=_draws(a, 1).iters[0])
    got = tdist._lists_on(mesh, out)
    ties = _lists_match(got, a[f"it1_{fetch}_d"], a[f"it1_{fetch}_i"],
                        a["x"], f"iteration ({fetch})")
    _flags_match(got, a[f"it1_{fetch}_i"], a[f"it1_{fetch}_new"])
    want_upd, want_ev = stats[f"it1_{fetch}"]
    assert int(ev) == want_ev
    assert abs(int(upd) - want_upd) <= ties, (int(upd), want_upd)


def test_polish_round_matches_jax(ref, mesh, monkeypatch):
    """The first polish round from JAX's state before it: the same lists
    and flags up to ties, the same evaluations. The candidate rows come
    100 rows' worth at a time, so a shard's 256 rows take three chunks."""
    a, stats = ref
    xs, x2s = _blocks(a, mesh)
    monkeypatch.setattr(tdist, "_POLISH_CHUNK_BYTES", 100 * K * K * D * 4)
    out, upd, ev = polish_sharded_round(
        mesh, xs, x2s, _shards(a, "pre_polish", mesh), merge_c=min(6 * K,
                                                                    K * K))
    got = tdist._lists_on(mesh, out)
    ties = _lists_match(got, a["polish1_d"], a["polish1_i"], a["x"],
                        "polish")
    _flags_match(got, a["polish1_i"], a["polish1_new"])
    want_upd, want_ev = stats["polish1"]
    assert int(ev) == want_ev
    assert abs(int(upd) - want_upd) <= ties, (int(upd), want_upd)


def _truth(x):
    return torch.from_numpy(np.array(jbrute(jax.numpy.asarray(x),
                                            jax.numpy.asarray(x), K)[1]))


def test_whole_build_matches_jax(ref, mesh):
    """The whole build on the JAX draws: recall within 0.002, the same
    iterations and dist_evals within 1% (the single-card build's bar,
    tests/test_torch_build.py:86-92); the share of equal slots held to
    this corpus's fp32 noise floor, not to that bar's 0.99. Every step
    agrees but at a few near-ties (the tests above: as many as two
    builds of the port itself differ by), yet the sharded compaction
    keys its draws by the position a row received in its route bucket,
    so one acceptance that a near-tie flips moves every later row of that
    bucket onto another draw, and a few flips in the first iterations
    spread. The floor is measured here: the port builds again on the same
    draws with the corpus's columns in NOISE_ORDERS other orders (the
    same distances, their fp32 sums in another order), and the share of
    slots each such build has equal to the first is read; the port and
    JAX must agree on at least the lowest of them less NOISE_MARGIN,
    which allows for the floor's own sampling noise."""
    a, stats = ref
    st_j = stats["build"]
    cfg, draws = DescentConfig(**CFG), _draws(a, st_j["iters"])
    dist, idx, st = build_knn_graph_sharded(mesh, a["x"], K, cfg=cfg,
                                            draws=draws)
    ti = _truth(a["x"])
    r_port = recall_at_k(idx, ti)
    r_jax = recall_at_k(torch.from_numpy(a["final_i"]), ti)
    same = (idx.numpy() == a["final_i"]).mean()
    floor = []
    for s in range(NOISE_ORDERS):
        cols = np.random.default_rng(s).permutation(D)
        _, i_s, _ = build_knn_graph_sharded(
            mesh, np.ascontiguousarray(a["x"][:, cols]), K, cfg=cfg,
            draws=draws)
        floor.append(float((i_s == idx).float().mean()))
    print("whole build", r_port, r_jax, same, st, st_j, "noise floor",
          floor)
    assert same >= min(floor) - NOISE_MARGIN, (same, floor)
    assert abs(r_port - r_jax) <= 0.002, (r_port, r_jax)
    assert st["iters"] == st_j["iters"]
    assert abs(st["dist_evals"] - st_j["dist_evals"]) <= \
        0.01 * st_j["dist_evals"]
    assert dist.dtype == torch.float32 and idx.dtype == torch.int32


@pytest.mark.parametrize("shards", [4, 1])
def test_own_draws_hold_the_reference_pin(shards):
    """tests/test_distributed.py:46's pin (recall > 0.93) on the port's
    own generators, at P = 4 and at P = 1; the same key gives the same
    graph."""
    x = np.array(jdatasets.clustered(jax.random.key(0), N, D, 8))
    mesh = ShardMesh.on(shards, device="cpu")
    cfg = DescentConfig(**CFG)
    d1, i1, st = build_knn_graph_sharded(mesh, x, K, cfg=cfg, key=3)
    r = recall_at_k(i1, _truth(x))
    print("own draws", shards, r, st)
    assert r > 0.93, (r, st)
    d2, i2, _ = build_knn_graph_sharded(mesh, x, K, cfg=cfg, key=3)
    assert torch.equal(i1, i2) and torch.equal(d1, d2)


@pytest.mark.parametrize("span", [128, 600])
def test_lean_fetch_equals_fetch_rows_a2a(mesh, span):
    """The polish's fetch without buckets (_plan_fetch, then _fetch_chunk
    for each chunk of ``span`` ids): rows and masks bit-equal to
    fetch_rows_a2a's on random ids (-1 included) with a cap some buckets
    overflow, in five chunks (the last one shorter) and in one."""
    x = datasets.gaussian(N, D, seed=2)
    xs = mesh.split(x)
    g = torch.Generator().manual_seed(4)
    ids = [torch.randint(-1, N, (600,), generator=g, dtype=torch.int32)
           for _ in range(P)]
    want_rows, want_ok = tdist.fetch_rows_a2a(mesh, xs, ids, cap=150)
    plans = tdist._plan_fetch(mesh, N_LOCAL, ids, cap=150, span=span)
    overflow = 0
    for p in range(P):
        chunks = len(plans[p].bounds) - 1
        assert chunks == -(-600 // span)
        rows = torch.cat([tdist._fetch_chunk(mesh, xs, plans, p, c)
                          for c in range(chunks)])
        assert torch.equal(plans[p].ok, want_ok[p])
        assert torch.equal(rows.view(torch.int32),
                           want_rows[p].view(torch.int32))
        owner = ids[p][ids[p] >= 0].long() // N_LOCAL
        overflow += int((torch.bincount(owner.clamp(max=P - 1),
                                        minlength=P) > 150).sum())
    assert 0 < overflow < P * P


def test_make_sharded_iteration_matches_jax(ref, mesh):
    """make_sharded_iteration's cost model equals the JAX function's at
    P = 1 (its lowering only; nothing is compiled); its step is one
    nn_descent_sharded_iteration with DescentConfig(k, rho,
    reorder=False) on the global lists, bit for bit."""
    jmesh = jax.make_mesh((1,), ("data",))
    for n, d, k, rho in ((512, 16, 10, 1.0), (1024, 24, 20, 0.5)):
        _, want = jdist.make_sharded_iteration_lowerable(
            jmesh, n=n, d=d, k=k, rho=rho)
        _, got = make_sharded_iteration(ShardMesh.on(1, device="cpu"), n=n,
                                        d=d, k=k, rho=rho)
        assert got == want
    a, _ = ref
    step, _ = make_sharded_iteration(mesh, n=N, d=D, k=K, rho=1.5,
                                     fetch="ring")
    draws = _draws(a, 1).iters[0]
    got, upd, ev = step(torch.from_numpy(a["x"]), tdist._lists_on(
        mesh, _shards(a, "init", mesh)), draws=draws)
    xs, x2s = _blocks(a, mesh)
    out, wupd, wev = nn_descent_sharded_iteration(
        mesh, xs, x2s, _shards(a, "init", mesh),
        DescentConfig(k=K, rho=1.5, reorder=False), fetch="ring",
        draws=draws)
    want = tdist._lists_on(mesh, out)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert int(upd) == int(wupd) and int(ev) == int(wev)
    with pytest.raises(ValueError):
        step(torch.from_numpy(a["x"][:N // 2]), got)


def test_sharded_build_stays_on_its_devices():
    """ShardMesh.on(4) is the card: without one the build raises instead
    of falling back to the CPU; with one it returns CUDA tensors."""
    x = datasets.clustered(256, 8, 4)
    cfg = DescentConfig(k=5, rho=1.0, max_iters=2, reorder=False)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            build_knn_graph_sharded(ShardMesh.on(4), x, 5, cfg=cfg)
        return
    d, i, _ = build_knn_graph_sharded(ShardMesh.on(4), x, 5, cfg=cfg)
    assert d.is_cuda and i.is_cuda
