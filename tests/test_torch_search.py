"""The port's query path (repro_torch.graph_search) against the JAX
package's, on the same corpus, the same JAX-built graph and the same
entry points, plus the JAX search tests' own pins on the port.

Tolerances: ids exact; distances rtol 1e-5 with atol 1e-4 (the norm
expansion's cancellation near 0 differs by the order of the sums). The
JAX reference merge may leave a stale id beside +inf where the merge
kernel writes -1 (ROADMAP Queue 3), so ids are compared on finite slots
and the port's ids must be -1 exactly where its distance is +inf."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import datasets as jdatasets
from repro.core import metric as jmetric
from repro.core import nn_descent as jnd
from repro.core.graph_search import SearchConfig as JSearchConfig
from repro.core.graph_search import graph_search as jgraph_search
from repro.core.graph_search import q_block_bucket as jq_block_bucket
from repro_torch import SearchConfig, brute_force_knn, graph_search
from repro_torch import recall_at_k
from repro_torch.core.graph_search import (
    _batch_key,
    _draw_entries,
    q_block_bucket,
)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def gauss():
    """Small-norm corpus and its JAX-built graph (test_core.py:170)."""
    x = np.array(jdatasets.gaussian(jax.random.key(3), 2048, 16))
    cfg = jnd.DescentConfig(k=20, rho=1.5, max_iters=15, merge_size=120)
    _, gidx, _ = jnd.build_knn_graph(jnp.asarray(x), k=20, cfg=cfg)
    return x, np.array(gidx)


@pytest.fixture(scope="module")
def seeded512():
    """The seeded 512-point regression graph of tests/test_search.py:73."""
    x = np.array(jdatasets.clustered(jax.random.key(11), 512, 16, 8))
    cfg = jnd.DescentConfig(k=10, rho=1.0, max_iters=15)
    _, gidx, _ = jnd.build_knn_graph(jnp.asarray(x), k=10, cfg=cfg,
                                     key=jax.random.key(5))
    return x, np.array(gidx)


def _search(x, gidx, q, **kw):
    d, i = graph_search(x, gidx, q, device="cpu", **kw)
    return d.numpy(), i.numpy()


def _jsearch(x, gidx, q, **kw):
    kw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
          for k, v in kw.items()}
    d, i = jgraph_search(jnp.asarray(x), jnp.asarray(gidx), jnp.asarray(q),
                         **kw)
    return np.asarray(d), np.asarray(i)


def _assert_same(got, want):
    (gd, gi), (wd, wi) = got, want
    fin = np.isfinite(wd) & (wd < 1e38)
    np.testing.assert_array_equal(np.isfinite(gd) & (gd < 1e38), fin)
    np.testing.assert_array_equal(gi[fin], wi[fin])
    assert (gi[~fin] == -1).all()
    np.testing.assert_allclose(gd[fin], wd[fin], rtol=1e-5, atol=1e-4)


def _invariants(d, i, alive=None):
    fin = np.isfinite(d) & (d < 1e38)
    assert ((i >= 0) == fin).all()
    dpad = np.where(fin, d, np.float32(3.0e38))
    assert (np.diff(dpad, axis=1) >= 0).all()
    for r in range(i.shape[0]):
        v = i[r][i[r] >= 0]
        assert len(set(v.tolist())) == len(v)
    if alive is not None:
        assert alive[i[i >= 0]].all()


# ---------------------------------------------------------------------------
# the fused path and the greedy oracle against the JAX package
# ---------------------------------------------------------------------------

def _case(name, x, nq, rng):
    """(corpus, queries, kwargs) of one parity case; every random input
    comes from numpy and goes to both packages."""
    n, d = x.shape
    q = (x[:nq] + 0.05 * rng.randn(nq, d)).astype(np.float32)
    shared = rng.choice(n, 32, replace=False).astype(np.int32)
    kw = {"entry": shared}
    if name == "per_query_holes":
        ent = rng.randint(0, n, size=(nq, 24)).astype(np.int32)
        ent[rng.rand(nq, 24) < 0.25] = -1
        kw["entry"] = ent
    elif name == "alive":
        kw["alive"] = rng.rand(n) < 0.85
    elif name == "filter_shared":
        kw["filter_ids"] = rng.rand(n) < 0.7
    elif name == "filter_per_query":
        filt = rng.rand(nq, n) < 0.7
        # admitted entries only: a hole would be refilled from each
        # package's own random draw, which the two cannot share
        kw["entry"] = np.stack([
            rng.choice(np.flatnonzero(f), 24, replace=False) for f in filt
        ]).astype(np.int32)
        kw["filter_ids"] = filt
    elif name in ("cosine", "mips"):
        x = np.array(jmetric.transform_corpus(jnp.asarray(x), name)[0])
    return x, q, kw


CASES = ["shared", "per_query_holes", "alive", "filter_shared",
         "filter_per_query", "cosine", "mips"]


@pytest.mark.parametrize("name", CASES)
def test_fused_search_matches_jax(gauss, name):
    """The port's fused path through the plain versions against JAX's
    fused path (its jnp oracles on the CPU), same graph, same entries."""
    x, gidx = gauss
    rng = np.random.RandomState(CASES.index(name))
    xc, q, kw = _case(name, x, 48, rng)
    metric = name if name in ("cosine", "mips") else "l2"
    cfg_t = SearchConfig(beam=32, rounds=24, expand=4, q_block=16,
                         metric=metric)
    cfg_j = JSearchConfig(beam=32, rounds=24, expand=4, q_block=16,
                          metric=metric)
    got = _search(xc, gidx, q, k_out=10, cfg=cfg_t, **kw)
    want = _jsearch(xc, gidx, q, k_out=10, cfg=cfg_j, **kw)
    _assert_same(got, want)
    alive = kw.get("alive", kw.get("filter_ids"))
    if alive is not None and alive.ndim == 1:
        _invariants(*got, alive=alive)
    if name == "filter_per_query":
        gi = got[1]
        for r in range(gi.shape[0]):
            assert kw["filter_ids"][r][gi[r][gi[r] >= 0]].all()


@pytest.mark.parametrize("name", ["shared", "per_query_holes", "alive",
                                  "filter_per_query"])
def test_ref_oracle_matches_jax(gauss, name):
    """The greedy one-node-per-round oracle against JAX's
    ``_graph_search_ref``: ids exact."""
    x, gidx = gauss
    rng = np.random.RandomState(10 + CASES.index(name))
    xc, q, kw = _case(name, x, 24, rng)
    got = _search(xc, gidx, q, k_out=10,
                  cfg=SearchConfig(beam=32, rounds=24, backend="ref"), **kw)
    want = _jsearch(xc, gidx, q, k_out=10,
                    cfg=JSearchConfig(beam=32, rounds=24, backend="ref"),
                    **kw)
    np.testing.assert_array_equal(got[1], want[1])
    fin = want[1] >= 0
    np.testing.assert_allclose(got[0][fin], want[0][fin], rtol=1e-5,
                               atol=1e-4)


# ---------------------------------------------------------------------------
# the JAX search tests' pins, on the port
# ---------------------------------------------------------------------------

def _truth(x, q, k):
    return brute_force_knn(x, q, k, exclude_self=False, device="cpu")[1]


def test_fused_matches_ref_recall(seeded512):
    """tests/test_search.py:163: same budget, the fused path keeps the
    greedy oracle's recall within 0.02."""
    x, gidx = seeded512
    q = x[:128] + 0.01
    ti = _truth(x, q, 10)
    rs = {}
    for backend in ("auto", "ref"):
        g = torch.Generator().manual_seed(3)
        _, gi = graph_search(x, gidx, q, k_out=10, generator=g, device="cpu",
                             cfg=SearchConfig(beam=32, rounds=24, expand=4,
                                              backend=backend))
        rs[backend] = recall_at_k(gi, ti)
    assert rs["auto"] >= rs["ref"] - 0.02, rs


def test_fused_search_seeded_recall_pin(seeded512):
    """tests/test_search.py:178: >= 0.97 on the seeded 512-point graph,
    with the port's own seeded entry draw; deterministic given it."""
    x, gidx = seeded512
    q = x[:256] + 0.01
    ti = _truth(x, q, 10)
    cfg = SearchConfig(beam=32, rounds=24, expand=4)
    outs = []
    for _ in range(2):
        g = torch.Generator().manual_seed(2)
        _, i = graph_search(x, gidx, q, k_out=10, generator=g, cfg=cfg,
                            device="cpu")
        outs.append(i)
    r = recall_at_k(outs[0], ti)
    assert r >= 0.97, r
    assert torch.equal(outs[0], outs[1])


@pytest.mark.parametrize("nq,cfg", [
    (37, SearchConfig(beam=16, rounds=16, expand=4, q_block=16)),
    (8, SearchConfig(beam=8, rounds=12, expand=4, q_block=8)),
    (5, SearchConfig(beam=4, rounds=2, expand=8, q_block=4)),
])
def test_fused_search_odd_shapes(seeded512, nq, cfg):
    """tests/test_search.py:96: ascending, unique ids, -1 exactly at +inf,
    and the pool always fills."""
    x, gidx = seeded512
    d, i = _search(x, gidx, x[:nq] + 0.01, k_out=4, cfg=cfg,
                   generator=torch.Generator().manual_seed(0))
    assert d.shape == (nq, 4) and i.shape == (nq, 4)
    _invariants(d, i)
    assert (i >= 0).mean() == 1.0


def test_fixed_block_matches_bucketed(seeded512):
    x, gidx = seeded512
    q = x[:7] + 0.01
    outs = {}
    for fixed in (False, True):
        cfg = SearchConfig(beam=16, rounds=12, expand=3, q_block=64,
                           fixed_block=fixed)
        assert q_block_bucket(7, cfg) == (64 if fixed else 8)
        outs[fixed] = _search(x, gidx, q, k_out=5, cfg=cfg,
                              generator=torch.Generator().manual_seed(4))
    np.testing.assert_array_equal(outs[False][1], outs[True][1])
    np.testing.assert_allclose(outs[False][0], outs[True][0], rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("backend", ["auto", "ref"])
def test_empty_corpus_and_empty_batch(seeded512, backend):
    cfg = SearchConfig(backend=backend)
    d, i = _search(np.zeros((0, 16), np.float32),
                   np.zeros((0, 10), np.int32), np.ones((7, 16), np.float32),
                   k_out=5, cfg=cfg)
    assert d.shape == (7, 5) and (i == -1).all() and np.isinf(d).all()
    x, gidx = seeded512
    d, i = _search(x, gidx, x[:0], k_out=5, cfg=cfg)
    assert d.shape == (0, 5) and i.shape == (0, 5)


@pytest.mark.parametrize("backend", ["auto", "ref"])
def test_all_dead_returns_empty(seeded512, backend):
    """Every slot empty: -1 ids, at +inf (fused) or the oracle's 3e38."""
    x, gidx = seeded512
    d, i = _search(x, gidx, x[:5], k_out=5,
                   alive=np.zeros(x.shape[0], bool),
                   cfg=SearchConfig(beam=8, rounds=4, backend=backend))
    assert (i == -1).all()
    assert (np.isinf(d) if backend == "auto" else d >= 3.0e38).all()


def test_admission_sanitizes_poisoned_rows(seeded512):
    x, gidx = seeded512
    q = np.array(x[:16], np.float32)
    bad = q.copy()
    bad[0, 0] = np.nan
    bad[3, :] = np.inf
    with pytest.warns(RuntimeWarning, match="sanitized 2"):
        d, i = _search(x, gidx, bad, k_out=5,
                       generator=torch.Generator().manual_seed(3))
    assert (i[0] == -1).all() and (i[3] == -1).all()
    assert np.isinf(d[0]).all() and np.isinf(d[3]).all()
    ok = [r for r in range(16) if r not in (0, 3)]
    assert np.isfinite(d[ok]).all()
    _invariants(d[ok], i[ok])


def test_admission_strict_rejects_and_dim_mismatch_always(seeded512):
    x, gidx = seeded512
    bad = np.array(x[:8], np.float32)
    bad[2, 1] = np.inf
    with pytest.raises(ValueError, match="non-finite"):
        _search(x, gidx, bad, k_out=5, cfg=SearchConfig(strict=True))
    wide = np.ones((4, x.shape[1] + 1), np.float32)
    for cfg in (SearchConfig(strict=False), SearchConfig(strict=True)):
        with pytest.raises(ValueError, match="feature dim"):
            _search(x, gidx, wide, k_out=5, cfg=cfg)


def test_deadline_degrades_not_crashes(seeded512):
    """tests/test_search.py:307: an expired slice cuts every block after
    the first to one round — results stay valid; a generous slice changes
    nothing."""
    x, gidx = seeded512
    q = x[:64] + 0.01

    def run(deadline):
        cfg = SearchConfig(beam=16, rounds=24, q_block=16,
                           max_rounds_deadline=deadline)
        return _search(x, gidx, q, k_out=5, cfg=cfg,
                       generator=torch.Generator().manual_seed(2))
    d, i = run(1e-9)
    assert i.shape == (64, 5) and (i >= 0).all()
    _invariants(d, i)
    d0, i0 = run(0.0)
    d1, i1 = run(60.0)
    np.testing.assert_array_equal(i0, i1)
    np.testing.assert_array_equal(d0, d1)


def test_batch_key_distinguishes_permuted_batches():
    rng = np.random.RandomState(3)
    q = torch.from_numpy(rng.randn(8, 16).astype(np.float32))
    qp = q[torch.from_numpy(rng.permutation(8))]
    k1, k2 = _batch_key(q), _batch_key(qp)
    assert k1 != k2
    assert k1 == _batch_key(q.clone())
    e1 = _draw_entries(torch.Generator().manual_seed(k1), 512, 16, None)
    e2 = _draw_entries(torch.Generator().manual_seed(k2), 512, 16, None)
    assert not torch.equal(e1, e2)


def test_draw_entries_no_duplicates():
    g = torch.Generator().manual_seed(5)
    e = _draw_entries(g, 64, 32, None).numpy()
    assert e.shape == (32,) and len(set(e.tolist())) == 32
    assert ((e >= 0) & (e < 64)).all()
    alive = torch.arange(64) % 2 == 0
    ea = _draw_entries(g, 64, 32, alive).numpy()
    assert len(set(ea.tolist())) == 32 and (ea % 2 == 0).all()
    small = _draw_entries(g, 8, 32, None).numpy()
    assert small.shape == (8,) and len(set(small.tolist())) == 8


def test_q_block_bucket_matches_jax():
    for fixed in (False, True):
        cfg_t = SearchConfig(q_block=512, fixed_block=fixed)
        cfg_j = JSearchConfig(q_block=512, fixed_block=fixed)
        got = [q_block_bucket(nq, cfg_t) for nq in range(1101)]
        want = [jq_block_bucket(nq, cfg_j) for nq in range(1101)]
        assert got == want
    assert SearchConfig(rounds=48, expand=6).n_rounds == 8


# ---------------------------------------------------------------------------
# device, options not ported
# ---------------------------------------------------------------------------

def test_search_and_truth_default_to_the_card(seeded512):
    """Without ``device`` both run on CUDA; with no card they raise
    instead of running on the CPU."""
    x, gidx = seeded512
    calls = [lambda: graph_search(x, gidx, x[:4], k_out=3),
             lambda: brute_force_knn(x, x, 3)]
    for call in calls:
        if torch.cuda.is_available():
            assert call()[1].device.type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="device='cpu'"):
                call()


@pytest.mark.parametrize("kw,match", [
    ({"cfg": SearchConfig(precision="fp8")}, "unknown quantization mode"),
    ({"cfg": SearchConfig(backend="interpret")}, "unknown backend"),
    ({"cfg": SearchConfig(backend="pallas")}, "unknown backend"),
])
def test_unported_search_options_raise(seeded512, kw, match):
    x, gidx = seeded512
    err = ValueError if "unknown" in match else NotImplementedError
    with pytest.raises(err, match=match):
        _search(x, gidx, x[:4], k_out=3, **kw)
