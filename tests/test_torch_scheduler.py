"""The port's retrieval scheduler (repro_torch.serve.RetrievalScheduler)
and the batcher's decode-time datastore growth (ContinuousBatcher's
``knn_*`` arguments) against the JAX package's, plus the JAX scheduler
tests (tests/test_scheduler.py, but the four circuit-breaker cases, which
need core/distributed.py) re-held on the port.

Parity: the same queries, virtual clock and FaultPlan seed through both
schedulers give the same dispatches ((nq, SearchConfig) in order), the
same ``stats()`` and the same rejections by qid and code; the result
cache's keys are byte-equal; a real search behind both (one graph, one
shared entry) gives the same ids. The batchers, fed one fake LM, append
the same (key, value) chunks; with real datastores and the JAX package's
insert draws injected (``knn_insert_draws``) their stores end close (ids,
flags, rows exact; distances within 1e-4 + 1e-5 (|a|^2 + |b|^2)) and
their values equal; a JAX drain snapshot cold-starts the port's batcher
bit for bit."""
import dataclasses
import threading
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import datasets as jdatasets
from repro.core import faults as jfaults
from repro.core import nn_descent as jnd
from repro.core import persist as jpersist
from repro.core.graph_search import SearchConfig as JSearchConfig
from repro.core.graph_search import graph_search as jgraph_search
from repro.serve.knn_lm import MutableKNNDatastore as JDatastore
from repro.serve.scheduler import ContinuousBatcher as JBatcher
from repro.serve.scheduler import Request as JRequest
from repro.serve.scheduler import RetrievalScheduler as JScheduler
from repro.serve.scheduler import SchedulerConfig as JSchedulerConfig
from repro_torch import OnlineConfig, SearchConfig, graph_search
from repro_torch.core import faults, persist
from repro_torch.core.faults import FaultPlan, FaultSpec
from repro_torch.core.graph_search import q_block_bucket
from repro_torch.serve import (
    ContinuousBatcher,
    LaneQueue,
    MutableKNNDatastore,
    QueryRequest,
    Request,
    RetrievalScheduler,
    SchedulerConfig,
)
from test_torch_online import _port_of, _seed_draw


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _req(qid, lane="interactive", deadline_ms=None):
    return QueryRequest(qid=qid, query=np.zeros(4, np.float32), lane=lane,
                        deadline_ms=deadline_ms)


# ---------------------------------------------------------------------------
# tests/test_scheduler.py, on the port
# ---------------------------------------------------------------------------

def test_lane_priority_and_fifo():
    q = LaneQueue()
    b0, i0, b1, i1 = (_req(0, "batch"), _req(1), _req(2, "batch"), _req(3))
    for r in (b0, i0, b1, i1):
        assert q.push(r, 0.0) is None
    assert [q.pop(0.0).qid for _ in range(4)] == [1, 3, 0, 2]
    assert q.pop(0.0) is None


def test_bounded_queue_at_exactly_capacity():
    q = LaneQueue(max_queue=3)
    for r in [_req(i) for i in range(3)]:
        assert q.push(r, 0.0) is None
    assert len(q) == 3 and q.admitted == 3 and q.shed == 0
    over = _req(99)
    rej = q.push(over, 0.0)
    assert rej is not None and rej.code == "queue-full"
    assert over.rejection is rej
    assert len(q) == 3 and q.shed == 1
    q.pop(0.0)
    assert q.push(_req(100), 0.0) is None


def test_drop_oldest_batch_policy():
    q = LaneQueue(max_queue=2, shed_policy="drop-oldest-batch")
    old, newer = _req(0, "batch"), _req(1, "batch")
    q.push(old, 0.0), q.push(newer, 0.0)
    assert q.push(_req(2), 0.0) is None
    assert old.rejection is not None and old.rejection.code == "shed-oldest"
    assert len(q) == 2 and q.shed == 1
    q.pop(0.0), q.pop(0.0)
    q.push(_req(3), 0.0), q.push(_req(4), 0.0)
    rej = q.push(_req(5), 0.0)
    assert rej is not None and rej.code == "queue-full"
    assert len(q) == 2


def test_deadline_expired_at_admission():
    q = LaneQueue()
    rej = q.push(_req(0, deadline_ms=0.0), 10.0)
    assert rej is not None and rej.code == "expired-at-admission"
    assert len(q) == 0 and q.expired == 1


def test_deadline_expired_in_queue():
    q = LaneQueue()
    r = _req(0, deadline_ms=50.0)
    assert q.push(r, 0.0) is None
    assert q.pop(0.061) is None
    assert r.rejection is not None and r.rejection.code == "expired-in-queue"
    assert q.expired == 1
    r2 = _req(1)
    q.push(r2, 0.0)
    assert q.pop(1e9) is r2


def _capture_search(captured):
    def search_fn(qs, cfg):
        assert isinstance(qs, torch.Tensor) and qs.dtype == torch.float32
        captured.append((int(qs.shape[0]), cfg))
        m = qs.shape[0]
        return torch.zeros((m, 4)), torch.arange(
            4, dtype=torch.int32).repeat(m, 1)
    return search_fn


def test_scheduler_serves_and_submit_after_drain():
    captured = []
    clk = [0.0]
    s = RetrievalScheduler(_capture_search(captured),
                           cfg=SchedulerConfig(max_queue=16),
                           clock=lambda: clk[0])
    for _ in range(5):
        s.submit(np.zeros(4, np.float32))
    served = s.run_until_drained()
    assert len(served) == 5 and all(r.done for r in served)
    assert all(r.idx is not None and r.rejection is None for r in served)
    r = s.submit(np.ones(4, np.float32), lane="batch")
    assert r.rejection is None
    assert s.run_until_drained() == [r] and r.done
    st = s.stats()
    assert st["admitted"] == 6 and st["served"] == 6 and st["shed"] == 0
    assert len(st["latency_ms"]["interactive"]) == 5


def test_lane_pure_batches_and_bucketed_block():
    captured = []
    s = RetrievalScheduler(_capture_search(captured),
                           base_cfg=SearchConfig(q_block=256),
                           cfg=SchedulerConfig(max_queue=64, max_batch=32))
    for _ in range(7):
        s.submit(np.zeros(4, np.float32), lane="interactive")
    for _ in range(3):
        s.submit(np.zeros(4, np.float32), lane="batch")
    s.run_until_drained()
    assert [nq for nq, _ in captured] == [7, 3]
    assert q_block_bucket(7, captured[0][1]) == 8
    assert q_block_bucket(3, captured[1][1]) == 4


def test_deadline_propagates_into_round_budget():
    captured = []
    clk = [0.0]
    s = RetrievalScheduler(_capture_search(captured),
                           base_cfg=SearchConfig(q_block=4),
                           cfg=SchedulerConfig(max_queue=64, max_batch=8),
                           clock=lambda: clk[0])
    assert s.base_cfg.max_rounds_deadline == 0.0
    for _ in range(8):
        s.submit(np.zeros(4, np.float32), deadline_ms=100.0)
    s.pump()
    (nq, cfg), = captured
    assert nq == 8
    assert cfg.max_rounds_deadline == pytest.approx(0.05)
    captured.clear()
    s.submit(np.zeros(4, np.float32), deadline_ms=None)
    s.pump()
    assert captured[0][1].max_rounds_deadline == 0.0


def test_sched_stall_expires_queued_deadlines():
    def one_run():
        s = RetrievalScheduler(_capture_search([]),
                               cfg=SchedulerConfig(max_queue=16),
                               clock=lambda: 0.0)
        plan = FaultPlan(seed=3, specs=(
            FaultSpec(site="sched.stall", arg=0.2, times=1),))
        with plan.active():
            rs = [s.submit(np.zeros(4, np.float32), deadline_ms=50.0)
                  for _ in range(4)]
            served = s.run_until_drained()
        return rs, served, s.stats()

    rs, served, st = one_run()
    assert served == [] and st["expired"] == 4
    assert all(r.rejection is not None
               and r.rejection.code == "expired-in-queue" for r in rs)
    rs2, _, st2 = one_run()
    assert [r.rejection.code for r in rs2] == [r.rejection.code for r in rs]
    assert st2["expired"] == st["expired"]


def test_seeded_burst_shed_determinism():
    def one_run():
        s = RetrievalScheduler(_capture_search([]),
                               cfg=SchedulerConfig(max_queue=4),
                               clock=lambda: 0.0)
        plan = FaultPlan(seed=7, specs=(
            FaultSpec(site="sched.burst", arg=9, times=1),))
        with plan.active():
            s.submit(np.zeros(4, np.float32))
        served = s.run_until_drained()
        st = s.stats()
        assert st["admitted"] + st["shed"] + st["expired"] == 10
        assert st["admitted"] == len(served) == 4
        return st

    st1, st2 = one_run(), one_run()
    assert st1["shed"] == st2["shed"] == 6
    assert st1 == st2


def test_truncated_drain_is_typed():
    s = RetrievalScheduler(_capture_search([]),
                           cfg=SchedulerConfig(max_queue=16, max_batch=1))
    rs = [s.submit(np.zeros(4, np.float32)) for _ in range(3)]
    with pytest.warns(RuntimeWarning, match="truncated"):
        served = s.run_until_drained(max_pumps=1)
    assert len(served) == 1
    assert all(r.rejection is not None and r.rejection.code == "truncated"
               for r in rs if r not in served)
    assert len(s.queue) == 0


def _fake_batcher(n_slots=2, **kw):
    v = 8

    def step_fn(cache, tokens, lengths):
        return torch.zeros((tokens.shape[0], v)), cache

    def prefill_fn(prompt):
        return torch.zeros((1, v)), None, prompt.shape[1]

    return ContinuousBatcher(n_slots, step_fn, prefill_fn,
                             lambda cache, i, one, length: cache, **kw)


def _lm_req(rid, **kw):
    return Request(rid=rid, prompt=np.zeros(4, np.int32), max_new=3, **kw)


def test_batcher_bounded_queue_and_deadlines():
    clk = [0.0]
    bat = _fake_batcher(n_slots=1, max_queue=2, clock=lambda: clk[0])
    a, b, c = _lm_req(0), _lm_req(1), _lm_req(2)
    assert bat.submit(a) is None and bat.submit(b) is None
    rej = bat.submit(c)
    assert rej is not None and rej.code == "queue-full"
    assert c.rejection is rej
    bat.run({})
    d = _lm_req(3, deadline_ms=10.0)
    clk[0] = 1.0
    assert bat.submit(d) is None
    clk[0] = 2.0
    bat.run({})
    assert a.done and b.done and not d.done
    assert d.rejection is not None and d.rejection.code == "expired-in-queue"


def test_batcher_max_steps_marks_truncated():
    bat = _fake_batcher(n_slots=1)
    rs = [_lm_req(i) for i in range(4)]
    for r in rs:
        bat.submit(r)
    with pytest.warns(RuntimeWarning, match="truncated"):
        bat.run({}, max_steps=2)
    assert any(r.truncated for r in rs)
    assert all(r.done or r.truncated for r in rs)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        bat.run({})
    assert all(r.done for r in rs)


def test_batcher_submit_after_drain():
    bat = _fake_batcher(n_slots=2)
    first = _lm_req(0)
    bat.submit(first)
    bat.run({})
    assert first.done
    second = _lm_req(1)
    assert bat.submit(second) is None
    bat.run({})
    assert second.done


def test_q_block_bucket_ladder():
    cfg = SearchConfig(q_block=256)
    assert [q_block_bucket(n, cfg) for n in (1, 7, 8, 9, 300)] == \
        [1, 8, 8, 16, 256]
    assert q_block_bucket(7, SearchConfig(q_block=256,
                                          fixed_block=True)) == 256


# ---------------------------------------------------------------------------
# the two schedulers side by side
# ---------------------------------------------------------------------------

def _recording(captured, torch_side: bool, k=4):
    def search_fn(qs, cfg):
        qs = np.asarray(qs)
        captured.append((qs.shape[0], dataclasses.asdict(cfg),
                         qs.tobytes()))
        m = qs.shape[0]
        # answers that depend on the queries, so the cache is exercised
        d = np.abs(qs[:, :k]).astype(np.float32)
        i = (np.arange(k, dtype=np.int32)[None, :]
             + (qs[:, :1] > 0).astype(np.int32))
        if torch_side:
            return torch.from_numpy(d), torch.from_numpy(i)
        return jnp.asarray(d), jnp.asarray(i)
    return search_fn


SCENARIOS = {
    "reject_new": dict(max_queue=12, shed_policy="reject-new", max_batch=6,
                       result_cache=0),
    "drop_oldest": dict(max_queue=12, shed_policy="drop-oldest-batch",
                        max_batch=5, result_cache=0),
    "cache": dict(max_queue=64, shed_policy="reject-new", max_batch=8,
                  result_cache=16),
}


def _drive(cls_sched, cls_cfg, cfg_search, plan, fmod, torch_side, kw,
           seed):
    """Seeded arrivals on a virtual clock: mixed lanes and deadlines, a
    pump every few arrivals, repeated queries (so the cache hits)."""
    rng = np.random.RandomState(seed)
    pool = rng.randn(10, 6).astype(np.float32)
    clk = [0.0]
    captured = []
    s = cls_sched(_recording(captured, torch_side), base_cfg=cfg_search,
                  cfg=cls_cfg(**kw), clock=lambda: clk[0])
    reqs, served = [], []
    fmod.activate(plan)
    try:
        for t in range(60):
            clk[0] += 0.004
            lane = "batch" if rng.rand() < 0.4 else "interactive"
            dl = [None, 15.0, 60.0][rng.randint(3)]
            reqs.append(s.submit(pool[rng.randint(10)], lane=lane,
                                 deadline_ms=dl))
            if t % 3 == 2:
                served.extend(s.pump())
        served.extend(s.run_until_drained())
    finally:
        fmod.deactivate()
    rejected = sorted((r.qid, r.rejection.code) for r in reqs
                      if r.rejection is not None)
    answers = [(r.qid, r.injected, r.dist.tobytes(), r.idx.tobytes())
               for r in served]
    hits = [(r.qid, r.idx.tobytes()) for r in reqs
            if r.rejection is None and r not in served and r.done]
    return captured, s.stats(), rejected, answers, hits, plan.fired()


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_scheduler_matches_jax(name):
    """One traffic script, one clock, one FaultPlan seed (sched.burst and
    sched.stall at probability): the same dispatches, stats, rejections,
    answers and cache hits in both packages."""
    kw = SCENARIOS[name]
    specs = dict(burst=dict(site="sched.burst", prob=0.15, arg=3),
                 stall=dict(site="sched.stall", prob=0.2, arg=0.02))
    got = _drive(RetrievalScheduler, SchedulerConfig,
                 SearchConfig(q_block=4), FaultPlan(seed=5, specs=tuple(
                     FaultSpec(**v) for v in specs.values())),
                 faults, True, kw, seed=list(SCENARIOS).index(name))
    want = _drive(JScheduler, JSchedulerConfig, JSearchConfig(q_block=4),
                  jfaults.FaultPlan(seed=5, specs=tuple(
                      jfaults.FaultSpec(**v) for v in specs.values())),
                  jfaults, False, kw, seed=list(SCENARIOS).index(name))
    for g, w, what in zip(got, want, ("dispatches", "stats", "rejections",
                                      "answers", "cache hits", "fired")):
        assert g == w, what
    assert got[5] > 0 and got[2]        # faults fired, something refused
    if name == "cache":
        assert got[1]["cache_hits"] > 0


def test_cache_key_bytes_match_jax():
    rng = np.random.RandomState(0)
    qs = [rng.randn(16).astype(np.float32) * s for s in (1e-3, 1.0, 3e3)]
    qs += [np.zeros(16, np.float32), np.full(16, 0.5, np.float32),
           # exact halves: round half to even
           np.array([127.0, 0.5, 1.5, 2.5, -0.5, -1.5], np.float32),
           np.array([], np.float32), rng.randn(8).astype(np.float64)]
    for q in qs:
        assert RetrievalScheduler._cache_key(q) == \
            JScheduler._cache_key(q)


def test_real_search_behind_both_schedulers():
    """Closures over each package's graph_search on one JAX-built graph
    with one shared entry: the scheduler's answers carry the same ids."""
    x = np.array(jdatasets.clustered(jax.random.key(11), 512, 16, 8))
    _, gidx, _ = jnd.build_knn_graph(
        jnp.asarray(x), k=10, cfg=jnd.DescentConfig(k=10, rho=1.0,
                                                    max_iters=15),
        key=jax.random.key(5))
    gidx = np.array(gidx)
    entry = np.random.RandomState(1).permutation(512)[:32].astype(np.int32)
    q = x[:40] + 0.01 * np.random.RandomState(2).randn(40, 16).astype(
        np.float32)

    def tsearch(qs, cfg):
        return graph_search(x, gidx, qs, k_out=10, entry=entry, cfg=cfg,
                            device="cpu")

    def jsearch(qs, cfg):
        return jgraph_search(jnp.asarray(x), jnp.asarray(gidx), qs,
                             k_out=10, entry=jnp.asarray(entry), cfg=cfg)

    out = []
    for cls, cfgc, sc, fn in (
            (RetrievalScheduler, SchedulerConfig, SearchConfig, tsearch),
            (JScheduler, JSchedulerConfig, JSearchConfig, jsearch)):
        s = cls(fn, base_cfg=sc(beam=32, rounds=24, expand=4, q_block=16),
                cfg=cfgc(max_queue=64, max_batch=12), clock=lambda: 0.0)
        for i in range(40):
            s.submit(q[i], lane="batch" if i % 3 else "interactive")
        served = sorted(s.run_until_drained(), key=lambda r: r.qid)
        out.append(np.stack([r.idx for r in served]))
    np.testing.assert_array_equal(*out)


# ---------------------------------------------------------------------------
# the batchers' datastore growth side by side
# ---------------------------------------------------------------------------

VOCAB, DK = 16, 8


def _proj():
    return np.asarray(jax.random.normal(jax.random.key(5), (VOCAB, DK)))


def _jax_lm():
    """tests/test_persist.py:297-303's one-hot LM."""
    def prefill_fn(toks):
        return jnp.ones((1, VOCAB)), None, toks.shape[1]

    def step_fn(cache, toks, lengths):
        lg = jax.nn.one_hot((toks[:, 0] * 3 + lengths) % VOCAB,
                            VOCAB) * 4.0
        return lg, cache
    return prefill_fn, step_fn


def _port_lm():
    def prefill_fn(toks):
        return torch.ones((1, VOCAB)), None, toks.shape[1]

    def step_fn(cache, toks, lengths):
        lg = torch.nn.functional.one_hot(
            ((toks[:, 0] * 3 + lengths) % VOCAB).long(), VOCAB) * 4.0
        return lg.float(), cache
    return prefill_fn, step_fn


def _requests(cls, n=3, max_new=8):
    return [cls(rid=r, prompt=np.array([1, 2, 3], np.int32), max_new=max_new)
            for r in range(n)]


class _JRecording:
    def __init__(self):
        self.log = []

    def append(self, keys, values, **kw):
        self.log.append((np.asarray(keys), np.asarray(values)))
        return self, None


class _TRecording(_JRecording):
    def append(self, keys, values, **kw):
        assert isinstance(kw["generator"], torch.Generator)
        self.log.append((keys.numpy(), values.numpy()))
        return self, None


@pytest.mark.parametrize("chunk", [8, 5])
def test_batcher_appends_the_jax_sequence(chunk):
    """Recording datastores: the same (keys, values) chunks in the same
    order and sizes, slots in order, the tail flushed when the stream
    drains (step-driven, no run())."""
    proj = _proj()
    jds, tds = _JRecording(), _TRecording()
    jp, js = _jax_lm()
    jb = JBatcher(2, js, jp, lambda c, i, o, length: c, knn_store=jds,
                  knn_capture=lambda lg: lg @ jnp.asarray(proj),
                  knn_chunk=chunk)
    tp, ts = _port_lm()
    tb = ContinuousBatcher(2, ts, tp, lambda c, i, o, length: c,
                           knn_store=tds,
                           knn_capture=lambda lg: lg @ torch.tensor(proj),
                           knn_chunk=chunk)
    for b, cls in ((jb, JRequest), (tb, Request)):
        for r in _requests(cls):
            b.submit(r)
        ran = True
        while ran:
            _, ran = b.step(None)
    assert [k.shape[0] for k, _ in tds.log] == \
        [k.shape[0] for k, _ in jds.log]
    assert sum(k.shape[0] for k, _ in tds.log) == 21
    for (tk, tv), (jk, jv) in zip(tds.log, jds.log):
        np.testing.assert_allclose(tk, jk, rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(tv, jv)


class _JLogged(JDatastore):
    """A JAX datastore that keeps the store each append starts from and
    the key it draws with (the draws the port is fed)."""

    def append(self, keys, values, *, key=None):
        self.build_stats.setdefault("log", []).append((self.store, key))
        return super().append(keys, values, key=key)


def _jax_start():
    keys0 = jax.random.normal(jax.random.key(0), (60, DK))
    vals0 = jax.random.randint(jax.random.key(1), (60,), 0, VOCAB)
    return JDatastore.build(keys0, vals0, k=8, key=jax.random.key(2))


def _port_twin(jds):
    return MutableKNNDatastore(
        store=_port_of(jds.store, OnlineConfig()),
        values=torch.from_numpy(np.array(jds.values)), build_stats={})


def _run_pair(jds, tds, **kw):
    proj = _proj()
    log = []
    jds = _JLogged(store=jds.store, values=jds.values, build_stats={"log": log})
    jp, js = _jax_lm()
    jb = JBatcher(2, js, jp, lambda c, i, o, length: c, knn_store=jds,
                  knn_capture=lambda lg: lg @ jnp.asarray(proj),
                  knn_chunk=8, **kw)
    for r in _requests(JRequest):
        jb.submit(r)
    jb.run(None)
    steps = []

    def draws(step, m):
        store, key = log[len(steps)]
        steps.append((step, m))
        assert key is not None
        return _seed_draw(store, m, key)

    tp, ts = _port_lm()
    tb = ContinuousBatcher(2, ts, tp, lambda c, i, o, length: c,
                           knn_store=tds,
                           knn_capture=lambda lg: lg @ torch.tensor(proj),
                           knn_chunk=8, knn_insert_draws=draws, **kw)
    for r in _requests(Request):
        tb.submit(r)
    tb.run(None)
    assert len(steps) == len(log) == 3          # chunks 8, 8 and a 5 tail
    return jb, tb


def _store_close_up_to_ties(ts, js):
    """``_store_close``, but the one-hot LM's keys repeat (16 distinct
    rows), so a list may hold two copies of a row at distance 0 and at
    the norm expansion's 1.5e-5 in either order: ids and flags are
    compared by id within runs of distances equal to that tolerance."""
    jd, ji = np.asarray(js.nl.dist), np.asarray(js.nl.idx)
    jn = np.asarray(js.nl.new)
    td, ti, tn = ts.nl.dist.numpy(), ts.nl.idx.numpy(), ts.nl.new.numpy()
    np.testing.assert_array_equal(np.isinf(td), np.isinf(jd))
    x2 = np.asarray(js.x2)
    tol = 1e-4 + 1e-5 * (x2[:, None] + x2[ji.clip(0)])
    fin = np.isfinite(jd)
    assert (np.abs(td[fin] - jd[fin]) <= tol[fin]).all()
    for r in np.nonzero(((ti != ji) | (tn != jn)).any(1))[0]:
        for s in np.nonzero(fin[r])[0]:
            tied = np.abs(jd[r] - jd[r, s]) <= tol[r, s]
            got = sorted(zip(ti[r][tied], tn[r][tied]))
            assert got == sorted(zip(ji[r][tied], jn[r][tied])), r
    np.testing.assert_array_equal(ts.alive.numpy(), np.asarray(js.alive))
    np.testing.assert_array_equal(ts.x.numpy(), np.asarray(js.x))
    assert ts.n == js.n and ts.capacity == js.capacity


def test_batcher_grows_a_datastore_like_jax():
    """Real datastores from one state, the JAX insert draws injected: the
    final stores close (up to tied duplicates), the values equal,
    capacity doubled (60 + 21 rows pass 64)."""
    jds = _jax_start()
    jb, tb = _run_pair(jds, _port_twin(jds))
    js, ts = jb.knn_store.store, tb.knn_store.store
    assert ts.n == js.n == 81 and ts.capacity == 128
    _store_close_up_to_ties(ts, js)
    np.testing.assert_array_equal(tb.knn_store.values.numpy(),
                                  np.asarray(jb.knn_store.values))


def test_jax_drain_snapshot_cold_starts_the_port_batcher(tmp_path):
    """A JAX batcher's drain snapshot restores into a port batcher (no
    store given) bit for bit: every array, values, n."""
    from test_torch_persist import _assert_arrays_equal, _store_arrays
    jds = _jax_start()
    proj = _proj()
    jp, js = _jax_lm()
    jb = JBatcher(2, js, jp, lambda c, i, o, length: c, knn_store=jds,
                  knn_capture=lambda lg: lg @ jnp.asarray(proj),
                  knn_chunk=8, knn_snapshot_dir=str(tmp_path))
    for r in _requests(JRequest):
        jb.submit(r)
    jb.run(None)
    assert jpersist.latest_snapshot(str(tmp_path)) == 81
    tp, ts = _port_lm()
    tb = ContinuousBatcher(2, ts, tp, lambda c, i, o, length: c,
                           knn_capture=lambda lg: lg, knn_chunk=8,
                           knn_snapshot_dir=str(tmp_path), device="cpu")
    got = tb.knn_store
    assert got.build_stats["restored_step"] == 81
    _assert_arrays_equal(_store_arrays(got.store),
                         _store_arrays(jb.knn_store.store))
    assert got.values.dtype == torch.int32
    np.testing.assert_array_equal(got.values.numpy(),
                                  np.asarray(jb.knn_store.values))


def test_batcher_cold_start_needs_a_card_unless_asked(tmp_path,
                                                      monkeypatch):
    ds = _port_twin(_jax_start())
    ds.snapshot(str(tmp_path))
    tp, ts = _port_lm()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ContinuousBatcher(2, ts, tp, lambda c, i, o, length: c,
                          knn_snapshot_dir=str(tmp_path))


def test_periodic_snapshot_is_its_own_step(tmp_path, monkeypatch):
    """The batcher's periodic async snapshot is held mid-write while the
    next chunk is appended: it restores at its own step with its own
    values, none of the rows inserted after it."""
    from test_torch_persist import _assert_arrays_equal, _store_arrays
    ds = _port_twin(_jax_start())
    started, proceed = threading.Event(), threading.Event()
    host = persist._host
    held = [True]

    def slow(name, arr):
        if held[0]:
            started.set()
            assert proceed.wait(60)
        return host(name, arr)

    monkeypatch.setattr(persist, "_host", slow)
    states = []

    class Logged(MutableKNNDatastore):
        def append(self, keys, values, **kw):
            out = super().append(keys, values, **kw)
            states.append(out[0])
            if len(states) == 2:        # the chunk after the snapshot
                assert started.wait(60)
                proceed.set()
                held[0] = False
            return out

    tp, ts = _port_lm()
    tb = ContinuousBatcher(
        2, ts, tp, lambda c, i, o, length: c,
        knn_store=Logged(store=ds.store, values=ds.values, build_stats={}),
        knn_capture=lambda lg: lg @ torch.tensor(_proj()), knn_chunk=8,
        knn_snapshot_dir=str(tmp_path), knn_snapshot_every=8, device="cpu")
    for r in _requests(Request):
        tb.submit(r)
    tb.run(None)
    first = states[0]
    r = persist.restore_store(str(tmp_path), step=first.store.n,
                              device="cpu")
    assert r.store.n == 68
    _assert_arrays_equal(_store_arrays(r.store), _store_arrays(first.store))
    assert torch.equal(r.values, first.values)
    assert not r.values[68:].any() and states[1].values[68:76].any()
    assert persist.latest_snapshot(str(tmp_path)) == 81


def test_batcher_replaces_the_store_config_without_a_rebuild():
    """knn_frontier_chunk / knn_q_block replace OnlineConfig.chunk /
    q_block and knn_router attaches a router (True: the default
    RouterConfig; an existing router is kept), all on the same rows and
    lists: nothing is rebuilt."""
    from repro_torch import RouterConfig
    ds = _port_twin(_jax_start())
    tp, ts = _port_lm()

    def batcher(store, **kw):
        return ContinuousBatcher(2, ts, tp, lambda c, i, o, length: c,
                                 knn_store=store, **kw)
    b = batcher(ds, knn_frontier_chunk=32, knn_q_block=16, knn_router=True)
    st = b.knn_store.store
    assert (st.cfg.chunk, st.cfg.q_block) == (32, 16)
    assert st.cfg.router == RouterConfig() and st.router is not None
    assert st.x is ds.store.x and st.nl.idx is ds.store.nl.idx
    assert ds.store.router is None and ds.store.cfg.chunk == 1024
    again = batcher(b.knn_store, knn_router=RouterConfig(n_centroids=3))
    assert again.knn_store.store.router is st.router
    plain = batcher(ds)
    assert plain.knn_store is ds
