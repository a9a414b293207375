"""The port's snapshots (repro_torch.core.persist, KNNDatastore.snapshot /
restore) against the JAX package's, both ways, and the JAX persistence
tests (tests/test_persist.py, its two scheduler cases too) re-held on the
port, and the growable kNN-LM datastore's snapshots both ways.

Cross-restore: one store state, made by the port (a build, one insert
and one delete, so that grown rows and tombstones are present, with a
router) at f32, int8 and bf16, is handed to both packages (the JAX store
from the same arrays); each snapshots it and the other restores it. Every
array comes back bitwise (dtype, shape and bytes), and the manifests are
equal but for ``time``. A restored store searches with the JAX search's
own entries and returns its ids; distances within 1e-5 relative."""
import dataclasses
import json
import os
import subprocess
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import online as jon
from repro.core import persist as jpersist
from repro.core.graph_search import _draw_entries as jdraw_entries
from repro.core.heap import NeighborLists as JNeighborLists
from repro.core.quantize import QuantizedStore as JQuantizedStore
from repro.core.router import Router as JRouter
from repro.core.router import RouterConfig as JRouterConfig
from repro.serve.knn_lm import KNNDatastore as JKNNDatastore
from repro.serve.knn_lm import MutableKNNDatastore as JMutable
from repro_torch import (
    DescentConfig,
    MutableKNNStore,
    OnlineConfig,
    RouterConfig,
    knn_delete,
    knn_insert,
)
from repro_torch.core import persist
from repro_torch.core.faults import FaultPlan, FaultSpec, InjectedFault
from repro_torch.serve import (
    ContinuousBatcher,
    KNNDatastore,
    MutableKNNDatastore,
    Request,
    knn_logits,
)

D, K = 8, 6
RCFG = dict(n_centroids=8, sample=256, members=16, iters=2)
PRECISIONS = ("f32", "int8", "bf16")
_BF16 = np.dtype(jnp.bfloat16)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _rows(n, seed):
    return np.random.RandomState(seed).randn(n, D).astype(np.float32)


def _build(precision="int8", router=True, n=256):
    x = _rows(n, 0)
    cfg = OnlineConfig(precision=precision,
                       router=RouterConfig(**RCFG) if router else None)
    store, _ = MutableKNNStore.build(
        x, K, cfg=cfg, descent=DescentConfig(k=K, rho=1.0, max_iters=6),
        generator=torch.Generator().manual_seed(1), device="cpu")
    return store


def _mutate(store):
    """Tombstones and streamed rows, so a snapshot carries online state."""
    store, _ = knn_delete(store, torch.arange(5))
    store, _ = knn_insert(store, _rows(7, 2),
                          generator=torch.Generator().manual_seed(3))
    return store


_STATES = {}


def _state(precision):
    """The cross-restore state at ``precision`` (built once per module)."""
    if precision not in _STATES:
        _STATES[precision] = _mutate(_build(precision))
    return _STATES[precision]


def _values(store):
    return torch.arange(store.capacity, dtype=torch.int32) * 3 + 1


# -- arrays, bitwise ---------------------------------------------------------

def _raw(a):
    """(dtype name, shape, bytes) of a tensor, JAX array or numpy array;
    bf16 by its bits."""
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.bfloat16:
            a = a.view(torch.int16).numpy().view(_BF16)
        else:
            a = a.numpy()
    a = np.asarray(a)
    return str(a.dtype), a.shape, a.tobytes()


def _store_arrays(s):
    """A store's arrays by snapshot name (either package's store)."""
    out = {"x": s.x, "x2": s.x2, "nl_dist": s.nl.dist, "nl_idx": s.nl.idx,
           "nl_new": s.nl.new, "alive": s.alive}
    if s.qs is not None:
        out.update(qs_data=s.qs.data, qs_scale=s.qs.scale, qs_x2=s.qs.x2)
    r = s.router
    if r is not None:
        out.update(router_centroids=r.centroids, router_c2=r.c2,
                   router_graph=r.graph, router_assign=r.assign,
                   router_counts=r.counts,
                   router_stale=np.asarray(r.stale, np.int32),
                   router_members_dist=r.members.dist,
                   router_members_idx=r.members.idx,
                   router_members_new=r.members.new)
    return out


def _assert_arrays_equal(got: dict, want: dict):
    assert got.keys() == want.keys()
    for name in want:
        g, w = _raw(got[name]), _raw(want[name])
        assert g[:2] == w[:2], (name, g[:2], w[:2])
        assert g[2] == w[2], name


def _assert_stores_equal(a, b):
    _assert_arrays_equal(_store_arrays(a), _store_arrays(b))
    assert (a.n, a.d, a.cfg, a.mips_m) == (b.n, b.d, b.cfg, b.mips_m)
    if a.router is not None:
        assert isinstance(b.router.stale, int) \
            and a.router.stale == b.router.stale


# -- the JAX twin of a port state --------------------------------------------

def _j(t):
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.view(torch.int16).numpy().view(_BF16))
    return jnp.asarray(t.numpy())


def _jax_cfg(cfg):
    echo = dataclasses.asdict(cfg)
    echo["backend"] = {"plain": "interpret"}.get(cfg.backend, cfg.backend)
    rd = echo.pop("router")
    return jon.OnlineConfig(
        **echo, router=None if rd is None else JRouterConfig(**rd))


def _jax_router(r):
    if r is None:
        return None
    return JRouter(centroids=_j(r.centroids), c2=_j(r.c2), graph=_j(r.graph),
                   members=JNeighborLists(*(_j(t) for t in r.members)),
                   assign=_j(r.assign), counts=_j(r.counts),
                   stale=jnp.asarray(r.stale, jnp.int32))


def _jax_of(ts):
    """The JAX package's store holding the port store's state."""
    return jon.MutableKNNStore(
        x=_j(ts.x), x2=_j(ts.x2),
        nl=JNeighborLists(*(_j(t) for t in ts.nl)), alive=_j(ts.alive),
        n=ts.n, d=ts.d, cfg=_jax_cfg(ts.cfg),
        qs=None if ts.qs is None else JQuantizedStore(
            *(_j(t) for t in ts.qs)),
        router=_jax_router(ts.router), mips_m=ts.mips_m)


def _manifest(step_dir):
    with open(os.path.join(step_dir, "manifest.json")) as f:
        m = json.load(f)
    m.pop("time")
    return m


def _jax_search_and_fill(js, q, key):
    """The JAX store's search and the draw it seeds from: the hole fill of
    its routed seeds (graph_search.py:402-425)."""
    jd, ji = js.search(jnp.asarray(q), k_out=K, key=key)
    t = min(4, js.router.centroids.shape[0])
    width = min(max(32, t * js.router.members.idx.shape[1]), js.capacity)
    fill = np.array(jdraw_entries(key, js.capacity, width, js.alive))
    return np.asarray(jd), np.asarray(ji), fill


# ---------------------------------------------------------------------------
# cross-restore, both ways
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("precision", PRECISIONS)
def test_jax_snapshot_restores_into_port(tmp_path, precision):
    """repro writes, repro_torch restores (device="cpu"): every array and
    the values bitwise; then the restored store, on the plain path,
    searches with the JAX search's own seed draw and returns its ids."""
    ts = _state(precision)
    js = _jax_of(ts)
    jpersist.snapshot_store(js, str(tmp_path), 7,
                            values=_j(_values(ts)))
    r = persist.restore_store(str(tmp_path), device="cpu")
    assert r.step == 7 and r.fallback_from == () and r.fp32_loader is None
    _assert_stores_equal(r.store, ts)
    _assert_arrays_equal({"values": r.values}, {"values": _values(ts)})
    if precision == "bf16":
        assert r.store.qs.data.dtype == torch.bfloat16
    q = _rows(16, 4)
    jd, ji, fill = _jax_search_and_fill(js, q, jax.random.key(5))
    plain = dataclasses.replace(r.store, cfg=dataclasses.replace(
        r.store.cfg, backend="plain"))
    td, ti = plain.search(q, k_out=K, route_fill=fill)
    np.testing.assert_array_equal(ti.numpy(), ji)
    np.testing.assert_allclose(td.numpy(), jd, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("precision", PRECISIONS)
def test_port_snapshot_restores_into_jax(tmp_path, precision):
    """repro_torch writes, repro restores: every array bitwise, and the
    manifest equals the JAX package's for the same state but ``time``
    (bfloat16 named, router_stale of shape [], the backend echo)."""
    ts = _state(precision)
    js = _jax_of(ts)
    ours = persist.snapshot_store(ts, str(tmp_path / "port"), 7,
                                  values=_values(ts))
    theirs = jpersist.snapshot_store(js, str(tmp_path / "jax"), 7,
                                     values=_j(_values(ts)))
    r = jpersist.restore_store(str(tmp_path / "port"))
    _assert_arrays_equal(_store_arrays(r.store), _store_arrays(ts))
    _assert_arrays_equal({"values": r.values}, {"values": _values(ts)})
    assert (r.store.n, r.store.d, r.store.mips_m) == (ts.n, ts.d, ts.mips_m)
    assert r.store.cfg == js.cfg
    assert _manifest(ours) == _manifest(theirs)
    m = _manifest(ours)
    assert m["arrays"]["router_stale"] == {
        "file": "router_stale.npy", "shape": [], "dtype": "int32"}
    if precision != "f32":
        assert m["arrays"]["qs_data"]["dtype"] == {
            "int8": "int8", "bf16": "bfloat16"}[precision]
    # the files themselves: the same dtypes and bytes as JAX's
    for name, info in m["arrays"].items():
        a = np.load(os.path.join(ours, info["file"]))
        b = np.load(os.path.join(theirs, info["file"]))
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), name


@pytest.mark.parametrize("backend,echo", [("plain", "interpret"),
                                          ("ref", "ref"), ("auto", "auto")])
def test_config_echo_names_the_jax_backends(tmp_path, backend, echo):
    """The port's "plain" is JAX's "interpret" on disk; each package reads
    the other's name back as its own."""
    ts = _state("f32")
    ts = dataclasses.replace(ts, cfg=dataclasses.replace(ts.cfg,
                                                         backend=backend))
    step_dir = persist.snapshot_store(ts, str(tmp_path), 1)
    assert _manifest(step_dir)["config"]["backend"] == echo
    assert jpersist.restore_store(str(tmp_path)).store.cfg.backend == echo
    assert persist.restore_store(str(tmp_path), device="cpu").store.cfg \
        == ts.cfg


def test_config_echo_pallas_reads_as_auto_and_unknown_refuses(tmp_path):
    js = _jax_of(_state("f32"))
    js = dataclasses.replace(js, cfg=dataclasses.replace(js.cfg,
                                                         backend="pallas"))
    jpersist.snapshot_store(js, str(tmp_path), 1)
    r = persist.restore_store(str(tmp_path), device="cpu")
    assert r.store.cfg.backend == "auto"
    js = dataclasses.replace(js, cfg=dataclasses.replace(js.cfg,
                                                         backend="tpu9"))
    jpersist.snapshot_store(js, str(tmp_path), 2)
    with pytest.raises(persist.SnapshotError, match="tpu9"):
        persist.restore_store(str(tmp_path), step=2, device="cpu")


def _port_datastore():
    keys = _rows(128, 0)
    vals = np.random.RandomState(1).randint(0, 16, size=128).astype(np.int32)
    return KNNDatastore.build(
        keys, vals, k=K, cfg=DescentConfig(k=K, rho=1.0, max_iters=6),
        precision="int8", router=RouterConfig(**{**RCFG, "sample": 128}),
        generator=torch.Generator().manual_seed(2), device="cpu")


def _ds_arrays(ds):
    out = {"keys": ds.keys, "values": ds.values, "graph_idx": ds.graph_idx,
           "qs_data": ds.qstore.data, "qs_scale": ds.qstore.scale,
           "qs_x2": ds.qstore.x2}
    r = ds.router
    out.update(router_centroids=r.centroids, router_c2=r.c2,
               router_graph=r.graph, router_assign=r.assign,
               router_counts=r.counts,
               router_stale=np.asarray(r.stale, np.int32),
               router_members_dist=r.members.dist,
               router_members_idx=r.members.idx,
               router_members_new=r.members.new)
    return out


def test_datastore_cross_restore_both_ways(tmp_path):
    """KNNDatastore: the port's snapshot restores into repro and repro's
    into the port, every array bitwise; the manifests are equal but
    ``time`` and ``build_stats``; the restored datastore's knn_logits are
    the saved one's, bitwise."""
    ds = _port_datastore()
    ours = ds.snapshot(str(tmp_path / "port"), step=3)
    jr = JKNNDatastore.restore(str(tmp_path / "port"))
    _assert_arrays_equal(_ds_arrays(jr), _ds_arrays(ds))
    assert jr.build_stats["restored_step"] == 3
    jds = JKNNDatastore(
        keys=_j(ds.keys), values=_j(ds.values), graph_idx=_j(ds.graph_idx),
        build_stats={"iters": 1}, qstore=JQuantizedStore(
            *(_j(t) for t in ds.qstore)),
        router=_jax_router(ds.router), metric=ds.metric, mips_m=ds.mips_m)
    theirs = jds.snapshot(str(tmp_path / "jax"), step=3)
    tr = KNNDatastore.restore(str(tmp_path / "jax"), device="cpu")
    _assert_arrays_equal(_ds_arrays(tr), _ds_arrays(ds))
    assert tr.build_stats == {"iters": 1, "restored_step": 3}
    mo, mj = _manifest(ours), _manifest(theirs)
    mo.pop("build_stats")
    mj.pop("build_stats")
    assert mo == mj
    q = torch.from_numpy(_rows(8, 9))
    entry = torch.arange(0, 128, 4, dtype=torch.int32)
    want = knn_logits(ds, q, 16, k=4, entry=entry)
    got = knn_logits(tr, q, 16, k=4, entry=entry)
    assert torch.equal(got, want)


def test_restore_needs_a_card_unless_asked(tmp_path):
    persist.snapshot_store(_state("f32"), str(tmp_path / "s"), 1)
    _port_datastore().snapshot(str(tmp_path / "d"))
    calls = [lambda: persist.restore_store(str(tmp_path / "s")),
             lambda: KNNDatastore.restore(str(tmp_path / "d"))]
    for call in calls:
        if torch.cuda.is_available():
            continue
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def test_persistence_imports_no_jax_or_ml_dtypes(tmp_path):
    """The card's machine has neither JAX nor ml_dtypes: a fresh process
    writes and reads a bf16 snapshot with the port alone."""
    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src")
    code = (
        "import sys, torch; from repro_torch.core import persist; "
        "from repro_torch.core.quantize import quantize_corpus; "
        "qs = quantize_corpus(torch.randn(8, 32), 'bf16'); "
        "a = {'qs_data': qs.data, 'qs_scale': qs.scale, 'qs_x2': qs.x2}; "
        f"persist.write_snapshot({str(tmp_path)!r}, 1, a, {{}}); "
        f"_, b, m = persist.read_snapshot({str(tmp_path)!r}); "
        "assert m['arrays']['qs_data']['dtype'] == 'bfloat16'; "
        "bad = [k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'repro', 'ml_dtypes')]; assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                   env=dict(os.environ, PYTHONPATH=src))


def test_async_capture_is_the_store_at_save(tmp_path, monkeypatch):
    """SnapshotWriter.save captures on the caller's thread: an insert and
    a delete that run while the write is in flight (the write is held
    until they finish) never reach the snapshot."""
    store = _state("int8")
    before = {k: v.clone() if isinstance(v, torch.Tensor) else v
              for k, v in _store_arrays(store).items()}
    started, proceed = threading.Event(), threading.Event()
    host = persist._host

    def held(name, arr):
        started.set()
        assert proceed.wait(60)
        return host(name, arr)

    monkeypatch.setattr(persist, "_host", held)
    w = persist.SnapshotWriter(str(tmp_path), keep=0)
    w.save(store, 1, values=_values(store))
    assert started.wait(60)
    after, _ = knn_insert(store, _rows(9, 6),
                          generator=torch.Generator().manual_seed(7))
    after, _ = knn_delete(after, torch.arange(20, 30))
    proceed.set()
    w.wait()
    r = persist.restore_store(str(tmp_path), device="cpu")
    _assert_arrays_equal(_store_arrays(r.store), before)
    assert (r.store.n, r.store.cfg) == (store.n, store.cfg)
    assert after.n > store.n


# ---------------------------------------------------------------------------
# tests/test_persist.py, on the port
# ---------------------------------------------------------------------------

def _search_bits(store, k_out=K):
    d, i = store.search(_rows(16, 4), k_out=k_out,
                        generator=torch.Generator().manual_seed(5))
    return d.numpy().view(np.int32), i.numpy()


def test_round_trip_bit_identical(tmp_path):
    store = _state("int8")
    step_dir = persist.snapshot_store(store, str(tmp_path), store.n,
                                      values=_values(store))
    assert os.path.exists(os.path.join(step_dir, "COMMIT"))
    r = persist.restore_store(str(tmp_path), device="cpu")
    _assert_stores_equal(r.store, store)
    assert torch.equal(r.values, _values(store))
    assert r.manifest["tombstones"] == 5
    b1, i1 = _search_bits(store)
    b2, i2 = _search_bits(r.store)
    assert (i1 == i2).all() and (b1 == b2).all()


def test_partial_dir_without_commit_marker_is_invisible(tmp_path):
    persist.snapshot_store(_build(router=False), str(tmp_path), 10)
    partial = tmp_path / "step_00000020"
    partial.mkdir()
    np.save(partial / "x.npy", np.zeros((4, 4), np.float32))
    (partial / "manifest.json").write_text("{}")
    assert persist.list_snapshots(str(tmp_path)) == [10]
    assert persist.latest_snapshot(str(tmp_path)) == 10
    assert persist.restore_store(str(tmp_path), device="cpu").step == 10
    with pytest.raises(persist.SnapshotError, match="COMMIT"):
        persist.read_snapshot(str(tmp_path), 20)


def test_no_committed_snapshot_raises(tmp_path):
    with pytest.raises(persist.SnapshotError, match="no committed"):
        persist.read_snapshot(str(tmp_path))


def test_truncated_array_file_names_the_file(tmp_path):
    step_dir = persist.snapshot_store(_build(router=False), str(tmp_path), 0)
    with open(os.path.join(step_dir, "x.npy"), "r+b") as f:
        f.truncate(40)      # mid-header: np.load fails outright
    with pytest.raises(persist.SnapshotError, match="x.npy"):
        persist.read_snapshot(str(tmp_path))


def test_short_array_file_names_the_file(tmp_path):
    step_dir = persist.snapshot_store(_build(router=False), str(tmp_path), 0)
    # loadable but the wrong shape: refused, the file named
    np.save(os.path.join(step_dir, "nl_idx.npy"), np.zeros((2, 2), np.int32))
    with pytest.raises(persist.SnapshotError, match="nl_idx.npy"):
        persist.read_snapshot(str(tmp_path))


def test_format_version_mismatch_refuses(tmp_path):
    step_dir = persist.snapshot_store(_build(router=False), str(tmp_path), 0)
    mf = os.path.join(step_dir, "manifest.json")
    with open(mf) as f:
        manifest = json.load(f)
    manifest["format_version"] = persist.FORMAT_VERSION + 1
    with open(mf, "w") as f:
        json.dump(manifest, f)
    with pytest.raises(persist.SnapshotError, match="format version"):
        persist.read_snapshot(str(tmp_path))


def test_mutate_after_restore_parity(tmp_path):
    """A restored store takes inserts and deletes (router and mirror
    maintenance included) exactly as the store that was saved."""
    store = _state("int8")
    persist.snapshot_store(store, str(tmp_path), 1)
    r = persist.restore_store(str(tmp_path), device="cpu").store
    extra = _rows(9, 6)
    a, sa = knn_insert(store, extra,
                       generator=torch.Generator().manual_seed(7))
    b, sb = knn_insert(r, extra, generator=torch.Generator().manual_seed(7))
    a, _ = knn_delete(a, torch.arange(20, 30))
    b, _ = knn_delete(b, torch.arange(20, 30))
    _assert_stores_equal(a, b)
    assert sa == sb
    b1, i1 = _search_bits(a)
    b2, i2 = _search_bits(b)
    assert (i1 == i2).all() and (b1 == b2).all()


def test_bf16_mirror_round_trips(tmp_path):
    """npy cannot describe bfloat16: the bits go to disk as uint16 and the
    manifest names the logical dtype."""
    store = _build(precision="bf16", router=False)
    step_dir = persist.snapshot_store(store, str(tmp_path), 0)
    assert np.load(os.path.join(step_dir, "qs_data.npy")).dtype == np.uint16
    r = persist.restore_store(str(tmp_path), device="cpu").store
    assert r.qs.data.dtype == torch.bfloat16
    assert torch.equal(r.qs.data.view(torch.int16),
                       store.qs.data.view(torch.int16))


def test_snapshot_writer_async_and_retention(tmp_path):
    store = _build(router=False)
    w = persist.SnapshotWriter(str(tmp_path), keep=2)
    for step in (1, 2, 3):
        w.save(store, step, values=_values(store), wait=False)
    w.wait()
    assert persist.list_snapshots(str(tmp_path)) == [2, 3]
    _assert_stores_equal(persist.restore_store(str(tmp_path),
                                               device="cpu").store, store)


def test_failed_rewrite_keeps_committed_same_step(tmp_path):
    """A failed rewrite of a committed step leaves the committed copy as it
    was."""
    store = _build(router=False)
    persist.snapshot_store(store, str(tmp_path), 5)
    plan = FaultPlan(specs=(FaultSpec(site="persist.write"),))
    with plan.active(), pytest.raises(InjectedFault):
        persist.snapshot_store(_mutate(store), str(tmp_path), 5)
    assert persist.list_snapshots(str(tmp_path)) == [5]
    r = persist.restore_store(str(tmp_path), device="cpu").store
    _assert_stores_equal(r, store)
    b1, i1 = _search_bits(store)
    b2, i2 = _search_bits(r)
    assert (i1 == i2).all() and (b1 == b2).all()


def test_rewrite_same_step_replaces_atomically(tmp_path):
    store = _build(router=False)
    persist.snapshot_store(store, str(tmp_path), 5)
    store2 = _mutate(store)
    persist.snapshot_store(store2, str(tmp_path), 5)
    assert persist.list_snapshots(str(tmp_path)) == [5]
    _assert_stores_equal(persist.restore_store(str(tmp_path),
                                               device="cpu").store, store2)
    assert [d for d in os.listdir(str(tmp_path))
            if d.endswith((".tmp", ".old"))] == []


def test_snapshot_writer_surfaces_background_errors(tmp_path):
    blocker = tmp_path / "snaps"
    blocker.write_text("not a directory")    # makedirs will raise
    w = persist.SnapshotWriter(str(blocker))
    w.save(_build(router=False), 1, wait=False)
    with pytest.raises(OSError):
        w.wait()
    assert w.poll() is None                  # reported once


def test_quantized_first_restore(tmp_path):
    """Searches run on the dequantized mirror at once; after the fp32 rows
    land, the store and its results are the exact restore's."""
    store = _state("int8")
    persist.snapshot_store(store, str(tmp_path), 1)
    exact = persist.restore_store(str(tmp_path), device="cpu").store
    qf = persist.restore_store(str(tmp_path), quantized_first=True,
                               device="cpu")
    assert qf.fp32_loader is not None
    w = store.qs.data.shape[1]
    assert torch.equal(qf.store.x[:, :w], store.qs.data.float()
                       * store.qs.scale[:, None])
    assert (qf.store.x[:, w:] == 0).all()
    assert torch.equal(qf.store.x2, store.qs.x2)
    _, ids = _search_bits(qf.store)
    assert (ids >= 0).all() and store.alive[torch.from_numpy(ids).long()
                                            ].all()
    done = qf.fp32_loader.apply(qf.store)
    _assert_stores_equal(exact, done)
    b1, i1 = _search_bits(exact)
    b2, i2 = _search_bits(done)
    assert (i1 == i2).all() and (b1 == b2).all()


def test_quantized_first_requires_mirror(tmp_path):
    persist.snapshot_store(_build(precision="f32", router=False),
                           str(tmp_path), 0)
    with pytest.raises(persist.SnapshotError, match="quantized mirror"):
        persist.restore_store(str(tmp_path), quantized_first=True,
                              device="cpu")


def test_static_datastore_round_trip(tmp_path):
    ds = _port_datastore()
    ds.snapshot(str(tmp_path))
    ds2 = KNNDatastore.restore(str(tmp_path), device="cpu")
    _assert_arrays_equal(_ds_arrays(ds2), _ds_arrays(ds))
    assert ds2.build_stats["restored_step"] == 0
    assert (ds2.metric, ds2.mips_m) == (ds.metric, ds.mips_m)
    # a mutable-store snapshot is not a static-datastore snapshot
    with pytest.raises(persist.SnapshotError, match="kind"):
        arrays, meta = persist.capture_store(_build(router=False))
        persist.rebuild_datastore(arrays, {"kind": "mutable_store", **meta},
                                  device="cpu")


# ---------------------------------------------------------------------------
# the growable datastore's snapshots, and the batcher's
# ---------------------------------------------------------------------------

def _mutable(precision="int8"):
    """A datastore over the cross-restore state: rows, tombstones, a
    router, and values aligned with the store's capacity."""
    store = _state(precision)
    return MutableKNNDatastore(store=store, values=_values(store),
                               build_stats={})


def test_mutable_datastore_snapshots_both_ways(tmp_path):
    """The port's datastore snapshot restores into repro's
    MutableKNNDatastore with every array and the values bitwise, and
    repro's snapshot of the same state restores into the port's."""
    ds = _mutable()
    ours = ds.snapshot(str(tmp_path / "port"))
    assert persist.latest_snapshot(str(tmp_path / "port")) == ds.store.n
    jr = JMutable.restore(str(tmp_path / "port"))
    _assert_arrays_equal(_store_arrays(jr.store), _store_arrays(ds.store))
    _assert_arrays_equal({"v": jr.values}, {"v": ds.values})
    assert jr.build_stats["restored_step"] == ds.store.n
    JMutable(store=_jax_of(ds.store), values=_j(ds.values),
             build_stats={}).snapshot(str(tmp_path / "jax"), step=4)
    tr = MutableKNNDatastore.restore(str(tmp_path / "jax"), device="cpu")
    _assert_stores_equal(tr.store, ds.store)
    assert torch.equal(tr.values, ds.values)
    assert tr.build_stats == {"restored_step": 4,
                              "live": ds.store.live_count(),
                              "tombstones": 5}
    mo, mj = _manifest(ours), _manifest(
        os.path.join(str(tmp_path / "jax"), os.listdir(tmp_path / "jax")[0]))
    assert (mo.pop("step"), mj.pop("step")) == (ds.store.n, 4)
    assert mo == mj


def test_mutable_datastore_quantized_first_then_fp32(tmp_path):
    """quantized_first serves from the mirror at once; finish_fp32 gives
    the exact datastore, bit for bit, and is a no-op afterwards."""
    ds = _mutable("int8")
    ds.snapshot(str(tmp_path))
    qf = MutableKNNDatastore.restore(str(tmp_path), quantized_first=True,
                                     device="cpu")
    assert qf.fp32_loader is not None and torch.equal(qf.values, ds.values)
    _, ids = _search_bits(qf.store)
    assert ds.store.alive[torch.from_numpy(ids).long()].all()
    done = qf.finish_fp32()
    assert done.fp32_loader is None and done.finish_fp32() is done
    _assert_stores_equal(done.store, ds.store)
    b1, i1 = _search_bits(ds.store)
    b2, i2 = _search_bits(done.store)
    assert (i1 == i2).all() and (b1 == b2).all()


def _one_hot_lm(vocab=16):
    """tests/test_persist.py:297-303's LM, on torch tensors."""
    def prefill_fn(toks):
        return torch.ones((1, vocab)), None, toks.shape[1]

    def step_fn(cache, toks, lengths):
        lg = torch.nn.functional.one_hot(
            ((toks[:, 0] * 3 + lengths) % vocab).long(), vocab) * 4.0
        return lg.float(), cache
    return prefill_fn, step_fn


def _lm_datastore(tmp_path, vocab=16, dk=8):
    rng = np.random.RandomState(0)
    ds = MutableKNNDatastore.build(
        rng.randn(64, dk).astype(np.float32),
        rng.randint(0, vocab, size=64).astype(np.int32), k=8,
        generator=torch.Generator().manual_seed(2), device="cpu")
    ds.snapshot(str(tmp_path))
    proj = torch.from_numpy(np.random.RandomState(5).randn(
        vocab, dk).astype(np.float32))
    return ds, proj


def _lm_batcher(tmp_path, proj, **kw):
    prefill_fn, step_fn = _one_hot_lm()
    return ContinuousBatcher(
        2, step_fn, prefill_fn, lambda c, i, o, length: c,
        knn_capture=lambda lg: lg @ proj, knn_chunk=8,
        knn_snapshot_dir=str(tmp_path), device="cpu", **kw)


def test_scheduler_cold_start_and_drain_snapshot(tmp_path):
    """tests/test_persist.py:286 on the port: with no store passed, the
    batcher restores from the newest committed snapshot; run() leaves a
    drain snapshot carrying the streamed inserts for the next cold
    start."""
    ds, proj = _lm_datastore(tmp_path)
    b = _lm_batcher(tmp_path, proj, knn_snapshot_every=8)
    assert b.knn_store is not None
    assert b.knn_store.build_stats["restored_step"] == ds.store.n
    _assert_stores_equal(ds.store, b.knn_store.store)
    for r in range(3):
        b.submit(Request(rid=r, prompt=np.array([1, 2, 3], np.int32),
                         max_new=8))
    b.run(None)
    assert b.knn_store.store.n == ds.store.n + 21
    assert persist.latest_snapshot(str(tmp_path)) == ds.store.n + 21
    b2 = _lm_batcher(tmp_path, proj)
    _assert_stores_equal(b.knn_store.store, b2.knn_store.store)
    assert torch.equal(b.knn_store.values, b2.knn_store.values)


def test_drain_snapshot_survives_failed_periodic_write(tmp_path):
    """tests/test_persist.py:329 on the port: a periodic background
    snapshot that fails for good does not abort the drain's; the drain
    commits and the stale error is a warning."""
    _, proj = _lm_datastore(tmp_path)
    b = _lm_batcher(tmp_path, proj, knn_snapshot_every=16)
    for r in range(3):
        b.submit(Request(rid=r, prompt=np.array([1, 2, 3], np.int32),
                         max_new=8))
    # 21 streamed rows: ONE periodic snapshot (at 16 rows), whose write
    # fails 3 times (past the 2 retries); the drain's write is clean
    plan = FaultPlan(specs=(FaultSpec(site="persist.write", times=3),))
    with plan.active(), pytest.warns(RuntimeWarning, match="supersedes"):
        b.run(None)
    assert plan.fired("persist.write") == 3
    assert persist.latest_snapshot(str(tmp_path)) == b.knn_store.store.n
    b2 = _lm_batcher(tmp_path, proj)
    _assert_stores_equal(b.knn_store.store, b2.knn_store.store)


def test_drain_failure_reraises_after_failed_periodic_write(tmp_path):
    """When the drain's write fails too, it raises, and the earlier
    periodic failure is reported beside it."""
    _, proj = _lm_datastore(tmp_path)
    b = _lm_batcher(tmp_path, proj, knn_snapshot_every=16)
    for r in range(3):
        b.submit(Request(rid=r, prompt=np.array([1, 2, 3], np.int32),
                         max_new=8))
    plan = FaultPlan(specs=(FaultSpec(site="persist.write"),))
    with plan.active(), pytest.warns(RuntimeWarning, match="already"), \
            pytest.raises(InjectedFault):
        b.run(None)
    assert persist.latest_snapshot(str(tmp_path)) == 64
