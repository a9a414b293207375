"""The port's serving slice (repro_torch.serve, repro_torch.launch.serve)
against the JAX package's, with JAX's weights carried over by
``params_from_numpy`` and the same numpy prompts, plus the JAX serving
tests' own pins on the port.

Tolerances: logits and caches within 1e-4 of their scale (max |ref|) at
f32 activations and caches, 2e-2 at the default bf16 (tests/test_serve.py
:53's limit); decode-equals-forward within 2e-2 and the multi-token and
ring cases within 3e-2 of the scale, as tests/test_serve.py:33-116 holds
JAX's; greedy tokens, kpos tags, rejections and retrieval ids exactly;
kNN log-probabilities rtol/atol 1e-5.
"""
import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget_smoke
from repro.core.graph_search import _draw_entries
from repro.models import init_tree as jinit_tree
from repro.models import model_schema as jmodel_schema
from repro.serve import ContinuousBatcher as JBatcher
from repro.serve import KNNDatastore as JDatastore
from repro.serve import LaneQueue as JLaneQueue
from repro.serve import MutableKNNDatastore as JMutable
from repro.serve import Request as JRequest
from repro.serve import init_cache as jinit_cache
from repro.serve import interpolate as jinterpolate
from repro.serve import knn_logits as jknn_logits
from repro.serve import prefill as jprefill
from repro.serve import serve_step as jserve_step
from repro_torch import DescentConfig, OnlineConfig
from repro_torch.configs import get_smoke_config
from repro_torch.launch import serve as launch_serve
from repro_torch.models import forward, params_from_numpy
from repro_torch.models.params import tree_paths
from repro_torch.serve import (
    ContinuousBatcher,
    KNNDatastore,
    LaneQueue,
    MutableKNNDatastore,
    Request,
    init_cache,
    interpolate,
    knn_logits,
    prefill,
    serve_step,
)

ARCH = "yi-6b"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _cfgs(act="f32", **change):
    tcfg, jcfg = get_smoke_config(ARCH), jget_smoke(ARCH)
    if act == "f32":
        tcfg = dataclasses.replace(tcfg, act_dtype=torch.float32,
                                   cache_dtype=torch.float32)
        jcfg = dataclasses.replace(jcfg, act_dtype=jnp.float32,
                                   cache_dtype=jnp.float32)
    return (dataclasses.replace(tcfg, **change),
            dataclasses.replace(jcfg, **change))


def _weights(jcfg):
    jp = jinit_tree(jax.random.key(0), jmodel_schema(jcfg))
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


def _rel_err(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-9))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


# ---------------------------------------------------------------------------
# prefill / decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("act", ["f32", "bf16"])
def test_prefill_and_step_match_jax(act):
    """Logits and every cache leaf after prefill(32) + one decode step."""
    tcfg, jcfg = _cfgs(act)
    jp, tp = _weights(jcfg)
    b, seq, s = 2, 33, 64
    toks = np.random.RandomState(1).randint(0, tcfg.vocab, size=(b, seq))
    jl, jc, jlen = jprefill(jp, {"tokens": jnp.asarray(toks[:, :-1])}, jcfg,
                            s)
    tl, tc, tlen = prefill(tp, {"tokens": torch.from_numpy(toks[:, :-1])},
                           tcfg, s)
    tol = 1e-4 if act == "f32" else 2e-2
    assert _rel_err(_np(tl), _np(jl)) < tol
    assert np.array_equal(tlen.numpy(), np.asarray(jlen))
    jg, jc = jserve_step(jp, jc, jnp.asarray(toks[:, -1:]), jlen, jcfg)
    tg, tc = serve_step(tp, tc, torch.from_numpy(toks[:, -1:]), tlen, tcfg)
    assert tg.dtype == torch.float32 and tuple(tg.shape) == (b, tcfg.vocab)
    assert _rel_err(_np(tg), _np(jg)) < tol
    want, got = tree_paths(jax.tree.map(np.asarray, jc)), tree_paths(tc)
    assert sorted(got) == sorted(want)
    for path, arr in want.items():
        assert tuple(got[path].shape) == arr.shape
        if path.endswith("kpos"):
            np.testing.assert_array_equal(got[path].numpy(), arr)
        else:
            assert _rel_err(_np(got[path]), arr.astype(np.float32)) < tol


def test_decode_matches_forward():
    """prefill(L-1) + decode(1) logits == full forward's last position."""
    tcfg, _ = _cfgs()
    _, tp = _weights(_cfgs()[1])
    b, seq, s = 2, 33, 64
    toks = torch.from_numpy(
        np.random.RandomState(1).randint(0, tcfg.vocab, size=(b, seq)))
    full = forward(tp, {"tokens": toks}, tcfg)
    _, cache, lengths = prefill(tp, {"tokens": toks[:, :-1]}, tcfg, s)
    got, _ = serve_step(tp, cache, toks[:, -1:], lengths, tcfg)
    assert _rel_err(got.numpy(), full[:, -1].numpy()) < 2e-2


def test_multi_token_decode_consistency():
    """Decoding 4 tokens step by step == forward on the extended seq."""
    tcfg, _ = _cfgs()
    _, tp = _weights(_cfgs()[1])
    l0, t, s = 17, 4, 64
    toks = torch.from_numpy(
        np.random.RandomState(2).randint(0, tcfg.vocab, size=(1, l0 + t)))
    full = forward(tp, {"tokens": toks}, tcfg)
    _, cache, lengths = prefill(tp, {"tokens": toks[:, :l0]}, tcfg, s)
    outs = []
    for i in range(t):
        lg, cache = serve_step(tp, cache, toks[:, l0 + i:l0 + i + 1],
                               lengths, tcfg)
        lengths = lengths + 1
        outs.append(lg)
    got = torch.stack(outs, dim=1)
    assert _rel_err(got.numpy(), full[:, l0:l0 + t].numpy()) < 3e-2


def test_ring_cache_window_equivalence():
    """All-local layers (window 16) decoding past the window with a ring
    cache of exactly ``window`` slots: the port's last logits match its
    own forward and JAX's serve loop."""
    tcfg, jcfg = _cfgs(window=16, layer_pattern="local")
    jp, tp = _weights(jcfg)
    total, l0, s = 16 + 24, 16, 16
    toks = np.random.RandomState(4).randint(0, tcfg.vocab, size=(1, total))
    full = forward(tp, {"tokens": torch.from_numpy(toks)}, tcfg)
    _, tc, tlen = prefill(tp, {"tokens": torch.from_numpy(toks[:, :l0])},
                          tcfg, s)
    _, jc, jlen = jprefill(jp, {"tokens": jnp.asarray(toks[:, :l0])}, jcfg,
                          s)
    assert tuple(tc["layers"]["k"].shape[1:3]) == (1, 16)
    step = jax.jit(lambda p, c, tk, ln: jserve_step(p, c, tk, ln, jcfg))
    for i in range(l0, total):
        tg, tc = serve_step(tp, tc, torch.from_numpy(toks[:, i:i + 1]),
                            tlen, tcfg)
        jg, jc = step(jp, jc, jnp.asarray(toks[:, i:i + 1]), jlen)
        tlen, jlen = tlen + 1, jlen + 1
    assert _rel_err(tg.numpy(), full[:, -1].numpy()) < 3e-2
    assert _rel_err(tg.numpy(), np.asarray(jg)) < 1e-4
    np.testing.assert_array_equal(tc["layers"]["kpos"].numpy(),
                                  np.asarray(jc["layers"]["kpos"]))


# ---------------------------------------------------------------------------
# continuous batching
# ---------------------------------------------------------------------------

def test_continuous_batcher_matches_jax_token_for_token():
    """3 slots, 5 requests of 8-token prompts, 5 new tokens each, greedy,
    at f32: the port's server path gives JAX's tokens."""
    tcfg, jcfg = _cfgs()
    jp, tp = _weights(jcfg)
    b, s = 3, 64
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, tcfg.vocab, size=8).astype(np.int32)
               for _ in range(5)]

    step_jit = jax.jit(lambda p, c, t, l: jserve_step(p, c, t, l, jcfg))
    prefill_jit = jax.jit(
        lambda p, bt: jprefill(p, bt, jcfg, s, last_only=True))

    def step_fn(cache, tokens, lengths):
        return step_jit(jp, cache, tokens, lengths)

    def prefill_fn(prompt):
        lg, c1, _ = prefill_jit(jp, {"tokens": jnp.asarray(prompt)})
        return lg, c1, prompt.shape[1]

    def write_slot(cache, i, one, length):
        return jax.tree.map(lambda big, o: big.at[:, i].set(o[:, 0]),
                            cache, one)

    jbat = JBatcher(b, step_fn, prefill_fn, write_slot)
    jreqs = [JRequest(rid=r, prompt=p, max_new=5)
             for r, p in enumerate(prompts)]
    for r in jreqs:
        jbat.submit(r)
    jbat.run(jinit_cache(jcfg, b, s))

    treqs, stats = launch_serve.serve_requests(
        tp, tcfg, prompts, slots=b, max_len=s, max_new=5)
    assert all(r.done and len(r.out) == 5 for r in treqs)
    assert [r.out for r in treqs] == [[int(t) for t in r.out]
                                      for r in jreqs]
    assert stats["decode_steps"] == jbat.steps
    assert stats["tokens"] == 25 and stats["decode_tokens"] == 20
    assert len(stats["prefill_s"]) == len(stats["ttft_s"]) == 5
    assert stats["max_memory_allocated"] is None


def _scenario_priority(q, mk):
    rs = [mk(0, "batch"), mk(1), mk(2, "batch"), mk(3)]
    pushed = [q.push(r, 0.0) for r in rs]
    return pushed, [q.pop(0.0).rid for _ in range(4)] + [q.pop(0.0)]


def _scenario_capacity(q, mk):
    out = [q.push(mk(i), 0.0) for i in range(4)]
    q.pop(0.0)
    out.append(q.push(mk(9), 0.0))
    return [None if r is None else r.code for r in out], (len(q), q.shed)


def _scenario_drop_oldest(q, mk):
    old, newer, inter = mk(0, "batch"), mk(1, "batch"), mk(2)
    codes = [q.push(r, 0.0) for r in (old, newer, inter)]
    q.pop(0.0), q.pop(0.0)
    a, b, c = mk(3), mk(4), mk(5)
    codes += [q.push(r, 0.0) for r in (a, b, c)]
    return ([None if r is None else r.code for r in codes],
            old.rejection.code, len(q), q.shed)


def _scenario_deadlines(q, mk):
    r0 = mk(0, deadline_ms=0.0)
    at_admission = q.push(r0, 10.0).code
    r1 = mk(1, deadline_ms=50.0)
    q.push(r1, 0.0)
    gone = q.pop(0.061)
    r2 = mk(2)
    q.push(r2, 0.0)
    return at_admission, gone, r1.rejection.code, q.pop(1e9).rid, q.expired


SCENARIOS = {
    "priority_and_fifo": (dict(), _scenario_priority),
    "bounded_at_capacity": (dict(max_queue=3), _scenario_capacity),
    "drop_oldest_batch": (dict(max_queue=2,
                               shed_policy="drop-oldest-batch"),
                          _scenario_drop_oldest),
    "deadlines": (dict(), _scenario_deadlines),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_lane_queue_matches_jax(name):
    """The same scripted pushes and pops through both packages'
    LaneQueue: the same admissions, pop order, typed rejections and
    counters."""
    kw, scenario = SCENARIOS[name]

    def maker(cls):
        def mk(rid, lane="interactive", deadline_ms=None):
            return cls(rid=rid, prompt=np.zeros(4, np.int32), lane=lane,
                       deadline_ms=deadline_ms)
        return mk

    def codes(x):
        if isinstance(x, (list, tuple)):
            return [codes(e) for e in x]
        return x.code if hasattr(x, "code") else x

    assert codes(scenario(LaneQueue(**kw), maker(Request))) == \
        codes(scenario(JLaneQueue(**kw), maker(JRequest)))


def _fake_batcher(n_slots=2, **kw):
    v = 8

    def step_fn(cache, tokens, lengths):
        return torch.zeros((tokens.shape[0], v)), cache

    def prefill_fn(prompt):
        return torch.zeros((1, v)), None, prompt.shape[1]

    def write_slot(cache, i, one, length):
        return cache

    return ContinuousBatcher(n_slots, step_fn, prefill_fn, write_slot, **kw)


def _lm_req(rid, **kw):
    return Request(rid=rid, prompt=np.zeros(4, np.int32), max_new=3, **kw)


def test_batcher_bounded_queue_and_deadlines():
    clk = [0.0]
    bat = _fake_batcher(n_slots=1, max_queue=2, clock=lambda: clk[0])
    a, b, c = _lm_req(0), _lm_req(1), _lm_req(2)
    assert bat.submit(a) is None and bat.submit(b) is None
    rej = bat.submit(c)
    assert rej is not None and rej.code == "queue-full"
    bat.run({})
    d = _lm_req(3, deadline_ms=10.0)
    clk[0] = 1.0
    assert bat.submit(d) is None
    clk[0] = 2.0
    bat.run({})
    assert a.done and b.done and not d.done
    assert d.rejection.code == "expired-in-queue"


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


def test_batcher_grows_its_knn_store_on_cpu():
    """A batcher with a CPU datastore: every decode step's (key, token)
    pair of each active slot lands in the store once the stream drains,
    with the sampled tokens as values, in capture order."""
    rng = np.random.RandomState(3)
    ds = MutableKNNDatastore.build(
        rng.randn(40, 8).astype(np.float32), np.arange(40, dtype=np.int32),
        k=6, cfg=DescentConfig(k=6, rho=1.0, max_iters=6), device="cpu",
        generator=torch.Generator().manual_seed(0))
    proj = torch.from_numpy(rng.randn(8, 8).astype(np.float32))
    toks = []

    def step_fn(cache, tokens, lengths):
        lg = torch.nn.functional.one_hot(
            ((tokens[:, 0] * 5 + lengths) % 8).long(), 8).float()
        return lg, cache

    bat = _fake_batcher(n_slots=2, knn_store=ds,
                        knn_capture=lambda lg: lg @ proj, knn_chunk=4)
    bat.step_fn = step_fn
    reqs = [_lm_req(i) for i in range(3)]
    for r in reqs:
        bat.submit(r)
    bat.run({})
    assert all(r.done for r in reqs)
    st = bat.knn_store.store
    assert st.n == 40 + 3 * 2 and st.live_count() == 46
    got = bat.knn_store.values[40:46].tolist()
    # slots 0 and 1 step together (requests 0, 1), then request 2 alone
    want = [reqs[0].out[1], reqs[1].out[1], reqs[0].out[2], reqs[1].out[2],
            reqs[2].out[1], reqs[2].out[2]]
    assert got == want
    assert st.nl.idx[40:46].ge(0).all()


def test_serve_exports_cover_the_jax_package():
    """repro_torch.serve exports every name of repro.serve's __all__ but
    the two that wait for the mesh."""
    import repro.serve
    import repro_torch.serve
    want = set(repro.serve.__all__) - {"abstract_cache", "cache_shardings"}
    assert want <= set(repro_torch.serve.__all__), \
        want - set(repro_torch.serve.__all__)
    assert all(hasattr(repro_torch.serve, n)
               for n in repro_torch.serve.__all__)


# ---------------------------------------------------------------------------
# the growable datastore
# ---------------------------------------------------------------------------

def _jax_datastore():
    keys = jax.random.normal(jax.random.key(0), (60, 8))
    vals = jax.random.randint(jax.random.key(1), (60,), 0, 32)
    return JMutable.build(keys, vals, k=8, key=jax.random.key(2))


def _port_twin(jds):
    from test_torch_online import _port_of
    return MutableKNNDatastore(
        store=_port_of(jds.store, OnlineConfig()),
        values=torch.from_numpy(np.array(jds.values)), build_stats={})


def test_mutable_datastore_matches_jax():
    """From one state, with the JAX insert draws injected: an append that
    doubles the capacity (60 + 9 rows pass 64), a delete, then knn_logits
    with the same entries. Stores close, values equal, log-probabilities
    within 1e-5."""
    from test_torch_online import _seed_draw, _store_close
    jds = _jax_datastore()
    tds = _port_twin(jds)
    extra = np.array(jax.random.normal(jax.random.key(3), (9, 8)))
    ev = np.arange(9, dtype=np.int32) + 20
    key = jax.random.key(4)
    draw = _seed_draw(jds.store, 9, key)
    jds2, jst = jds.append(jnp.asarray(extra), jnp.asarray(ev), key=key)
    tds2, tst = tds.append(torch.from_numpy(extra), torch.from_numpy(ev),
                           **draw)
    assert tst.dist_evals == jst.dist_evals
    assert tds2.store.capacity == jds2.store.capacity == 128
    assert tds.values.shape[0] == 64        # the old datastore is untouched
    dead = np.array([1, 5, 61, 66], np.int32)
    jds3, _ = jds2.delete(jnp.asarray(dead))
    tds3, _ = tds2.delete(torch.from_numpy(dead))
    _store_close(tds3.store, jds3.store)
    np.testing.assert_array_equal(tds3.values.numpy(),
                                  np.asarray(jds3.values))
    assert tds3.values[60:69].tolist() == ev.tolist()
    q = extra + 0.01
    skey = jax.random.key(6)
    want = np.asarray(jknn_logits(jds3, jnp.asarray(q), 32, k=4, key=skey))
    entry = torch.tensor(np.asarray(_draw_entries(
        skey, jds3.store.capacity, 32, jds3.store.alive)))
    got = knn_logits(tds3, torch.from_numpy(q), 32, k=4, entry=entry)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    ids = tds3.store.search(torch.from_numpy(q), k_out=4, entry=entry)[1]
    assert not np.isin(ids.numpy(), dead).any()


# ---------------------------------------------------------------------------
# kNN-LM
# ---------------------------------------------------------------------------

def test_knn_logits_and_interpolate_match_jax():
    """The same keys, values, graph and entries: the same retrieval and
    log-probabilities, and the same interpolation."""
    rng = np.random.RandomState(0)
    n, d, vocab, nq = 512, 16, 64, 24
    keys = rng.randn(n, d).astype(np.float32)
    vals = rng.randint(0, vocab, size=n).astype(np.int32)
    jds = JDatastore.build(jnp.asarray(keys), jnp.asarray(vals), k=8)
    tds = KNNDatastore(keys=torch.tensor(np.asarray(jds.keys)),
                       values=torch.tensor(np.asarray(jds.values)),
                       graph_idx=torch.tensor(np.asarray(jds.graph_idx)),
                       build_stats={})
    q = keys[:nq] + 0.05 * rng.randn(nq, d).astype(np.float32)
    key = jax.random.key(11)
    want = np.asarray(jknn_logits(jds, jnp.asarray(q), vocab, k=8, key=key))
    entry = torch.tensor(np.asarray(_draw_entries(key, n, 32, None)))
    got = knn_logits(tds, torch.from_numpy(q), vocab, k=8, entry=entry)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    lm = rng.randn(nq, vocab).astype(np.float32)
    np.testing.assert_allclose(
        interpolate(torch.from_numpy(lm), got, lam=0.25).numpy(),
        np.asarray(jinterpolate(jnp.asarray(lm), jnp.asarray(want),
                                lam=0.25)), rtol=1e-5, atol=1e-5)


def test_knn_datastore_snapshots_serve_across_packages(tmp_path):
    """A JAX datastore's snapshot, restored by the port (device="cpu"),
    answers knn_logits as the JAX datastore does on the same entries; the
    port's snapshot of it restores into repro with the same bits, so JAX
    answers as before."""
    rng = np.random.RandomState(1)
    n, d, vocab, nq = 512, 16, 64, 24
    keys = rng.randn(n, d).astype(np.float32)
    vals = rng.randint(0, vocab, size=n).astype(np.int32)
    jds = JDatastore.build(jnp.asarray(keys), jnp.asarray(vals), k=8)
    jds.snapshot(str(tmp_path / "jax"), step=2)
    tds = KNNDatastore.restore(str(tmp_path / "jax"), device="cpu")
    assert tds.build_stats["restored_step"] == 2
    q = keys[:nq] + 0.05 * rng.randn(nq, d).astype(np.float32)
    key = jax.random.key(12)
    want = np.asarray(jknn_logits(jds, jnp.asarray(q), vocab, k=8, key=key))
    entry = torch.tensor(np.asarray(_draw_entries(key, n, 32, None)))
    got = knn_logits(tds, torch.from_numpy(q), vocab, k=8, entry=entry)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    tds.snapshot(str(tmp_path / "port"), step=3)
    back = JDatastore.restore(str(tmp_path / "port"))
    for name in ("keys", "values", "graph_idx"):
        a, b = np.asarray(getattr(back, name)), np.asarray(getattr(jds, name))
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), name
    np.testing.assert_array_equal(
        np.asarray(jknn_logits(back, jnp.asarray(q), vocab, k=8, key=key)),
        want)


def test_knn_lm_retrieval_shifts_distribution():
    """kNN interpolation must move mass toward retrieved tokens."""
    rng = np.random.RandomState(0)
    n, d, vocab = 512, 16, 64
    keys = torch.from_numpy(rng.randn(n, d).astype(np.float32))
    vals = torch.full((n,), 7, dtype=torch.int32)
    ds = KNNDatastore.build(keys, vals, k=8, device="cpu")
    assert tuple(ds.graph_idx.shape) == (n, 8)
    knl = knn_logits(ds, keys[:4] + 0.01, vocab, k=4)
    lm = torch.zeros((4, vocab))
    assert (torch.argmax(interpolate(lm, knl, lam=0.5), -1) == 7).all()
    lm[:, 3] = 5.0
    assert (torch.argmax(interpolate(lm, knl, lam=1e-6), -1) == 3).all()


# ---------------------------------------------------------------------------
# the CLI and the device rule
# ---------------------------------------------------------------------------

def test_serve_cli_smoke_on_cpu(capsys):
    stats = launch_serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                               "--requests", "3", "--max-new", "4"])
    out = capsys.readouterr().out
    assert "served 3 requests, 12 tokens in" in out
    assert "decode steps" in out
    assert stats["tokens"] == 12


def test_entry_points_need_a_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_smoke_config(ARCH)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_cache(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        params_from_numpy({"a": np.zeros(2)})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch_serve.main(["--arch", ARCH, "--smoke"])
