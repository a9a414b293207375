"""The online store at t-SNE's k = 91 (scikit-learn's TSNE at perplexity
30): knn_insert's refinement and knn_delete's refill merge k + k^2 = 8372
candidates a row, past the 8192 pool the merge kernel holds in registers.
The port's plain versions against the JAX package's online store on the
CPU, from one store state (an exact k = 91 graph of a small clustered
blob, so no build runs) and on JAX's own draws, as
tests/test_torch_online.py holds them at k 10.

The JAX merge oracle masks repeated candidates with a (rows, c, c)
compare, about 69 MB a row at c = 8281, so the frontier chunk is 16 rows
and the blob 120 + 12 rows.

Tolerances: alive masks and DescentStats exact; computed distances
within 1e-4 + 1e-5 (|a|^2 + |b|^2); list ids on finite slots
(tests/test_torch_online.py's module docstring says why), exact after a
delete (both start from the JAX store's state). After an insert, whose
distances the two packages compute in another order, two entries of a
list may trade places where their distances lie within that tolerance
of each other (a near-tie: 25.361816 here against 25.362793 there beside
25.362219 on this large-norm blob), so the inserted lists are held entry
by entry as sets with each id's distance and flag, and a swapped pair to
that tolerance."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import datasets as jdatasets
from repro.core import online as jon
from repro_torch import OnlineConfig, knn_delete, knn_insert
from test_torch_online import _port_of, _seed_draw, _stats_equal, _store_close

K = 91
N_BASE, N_NEW, CHUNK = 120, 12, 16


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def k91():
    """The blob, its exact k = 91 graph on the first N_BASE rows, the JAX
    store from it, and that store after JAX's insert of the rest (key 2)."""
    x = np.array(jdatasets.clustered(jax.random.key(5), N_BASE + N_NEW, 16,
                                     4))
    base = x[:N_BASE].astype(np.float64)
    d = ((base[:, None] - base[None]) ** 2).sum(-1)
    np.fill_diagonal(d, np.inf)
    idx = np.argsort(d, axis=1, kind="stable")[:, :K].astype(np.int32)
    dist = np.take_along_axis(d, idx, axis=1).astype(np.float32)
    js = jon.MutableKNNStore.from_graph(jnp.asarray(x[:N_BASE]), dist, idx,
                                        cfg=jon.OnlineConfig(chunk=CHUNK))
    key = jax.random.key(2)
    j2, jst = jon.knn_insert(js, jnp.asarray(x[N_BASE:]), key=key)
    return x, js, key, j2, jst


def _lists_close_up_to_near_ties(ts, js):
    """Each row's list holds the same ids with the same flags, each id's
    distance within 1e-4 + 1e-5 (|a|^2 + |b|^2); where the two orders
    differ, the entries that trade places lie within that tolerance of
    each other. Alive masks, rows and capacity equal."""
    jd, ji = np.asarray(js.nl.dist), np.asarray(js.nl.idx)
    jf = np.asarray(js.nl.new)
    td, ti, tf = ts.nl.dist.numpy(), ts.nl.idx.numpy(), ts.nl.new.numpy()
    x2 = np.asarray(js.x2)
    np.testing.assert_array_equal(np.isinf(td), np.isinf(jd))
    fin = np.isfinite(jd)
    assert (ti[~fin] == -1).all()
    swaps = 0
    for r in range(jd.shape[0]):
        f = fin[r]
        assert sorted(ti[r, f]) == sorted(ji[r, f]), r
        tol = 1e-4 + 1e-5 * (x2[r] + x2[ji[r, f]])
        at = {int(i): (d, fl) for i, d, fl in zip(ti[r, f], td[r, f],
                                                  tf[r, f])}
        for i, d, fl, t in zip(ji[r, f], jd[r, f], jf[r, f], tol):
            assert abs(at[int(i)][0] - d) <= t and at[int(i)][1] == fl
        moved = ti[r, f] != ji[r, f]
        assert (np.abs(td[r, f] - jd[r, f]) <= tol)[moved].all(), r
        swaps += int(moved.sum())
    np.testing.assert_array_equal(ts.alive.numpy(), np.asarray(js.alive))
    assert ts.n == js.n and ts.capacity == js.capacity
    return swaps


def test_insert_at_k91_matches_jax(k91):
    """knn_insert of 12 rows at k 91 (refinement merges of c = 8281) from
    one state with the JAX seed draw: the same lists (up to near-ties),
    flags and stats."""
    x, js, key, j2, jst = k91
    t2, tst = knn_insert(_port_of(js, OnlineConfig(chunk=CHUNK)),
                         x[N_BASE:], **_seed_draw(js, N_NEW, key))
    _stats_equal(tst, jst)
    assert _lists_close_up_to_near_ties(t2, j2) <= 4
    np.testing.assert_array_equal(t2.x.numpy(), np.asarray(j2.x))
    assert int(t2.nl.idx[N_BASE:N_BASE + N_NEW].ge(0).sum()) == N_NEW * K


def test_delete_at_k91_matches_jax(k91):
    """knn_delete of 10 rows at k 91 (refill merges of c = 8281, chunks of
    16 rows) after JAX's insert: the same lists, flags, alive mask and
    stats, and no deleted id left in a live list."""
    x, _, _, j2, _ = k91
    dead = np.arange(3, N_BASE + N_NEW, 13).astype(np.int32)
    j3, jst = jon.knn_delete(j2, jnp.asarray(dead))
    t3, tst = knn_delete(_port_of(j2, OnlineConfig(chunk=CHUNK)), dead)
    _stats_equal(tst, jst)
    _store_close(t3, j3)
    live = t3.alive[:t3.n]
    ids = t3.nl.idx[:t3.n][live]
    assert not torch.isin(ids[ids >= 0], torch.from_numpy(dead)).any()
