"""The port's whole build slice (repro_torch.build_knn_graph) against the
JAX package's, and its package boundary.

The parity build feeds the port the JAX corpus and the JAX build's own
random draws (its key schedule replayed here), so the two builds differ
only by the order of floating-point sums."""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import datasets as jdatasets
from repro.core import nn_descent as jnd
from repro.core.recall import brute_force_knn
from repro_torch import (
    BuildDraws,
    DescentConfig,
    build_knn_graph,
    neighbor_lists_from_numpy,
    recall_at_k,
)
from repro_torch.core import datasets

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _selection_draws(k_it, n, k, selection):
    """One iteration's draws of repro's selection (selection.py:106-114
    turbo, :139-140 heap, :176-189 naive)."""
    if selection == "heap":
        k_w, _ = jax.random.split(k_it)
        shapes = [(k_w, (2 * n * k,))]
    elif selection == "naive":
        k1, k2, k3 = jax.random.split(k_it, 3)
        shapes = [(k1, (n * k,)), (k2, (n, 3 * k)), (k3, (n, 3 * k))]
    else:
        shapes = [(s, (2 * n * k,)) for s in jax.random.split(k_it, 3)]
    return tuple(torch.from_numpy(np.array(jax.random.uniform(s, shape)))
                 for s, shape in shapes)


def _jax_draws(key, n, k, iters, selection="turbo"):
    """The draws of repro's build_knn_graph for ``key``
    (nn_descent.py:461,469; heap.py:30)."""
    k_init, key = jax.random.split(key)
    init = np.array(jax.random.randint(k_init, (n, k), 0, n,
                                       dtype=jnp.int32))
    its = []
    for _ in range(iters):
        key, k_it = jax.random.split(key)
        its.append(_selection_draws(k_it, n, k, selection))
    return BuildDraws(torch.from_numpy(init), its)


def test_build_parity_with_jax_on_seeded_512():
    """The 512-point regression of test_knn_join.py:218: same corpus, same
    draws. The port holds the JAX build's quality pin and agrees with it
    slot by slot."""
    x = np.array(jdatasets.clustered(jax.random.key(11), 512, 16, 8))
    _, ti = brute_force_knn(jnp.asarray(x), jnp.asarray(x), 10)
    ti = np.array(ti)
    jcfg = jnd.DescentConfig(k=10, rho=1.0, max_iters=15)
    _, jidx, jstats = jnd.build_knn_graph(jnp.asarray(x), k=10, cfg=jcfg,
                                          key=jax.random.key(5))
    jidx = np.array(jidx)
    cfg = DescentConfig(k=10, rho=1.0, max_iters=15)
    _, idx, stats = build_knn_graph(
        x, k=10, cfg=cfg, device="cpu",
        draws=_jax_draws(jax.random.key(5), 512, 10, cfg.max_iters))
    idx = idx.numpy()
    r_port = recall_at_k(torch.from_numpy(idx), torch.from_numpy(ti))
    r_jax = recall_at_k(torch.from_numpy(jidx), torch.from_numpy(ti))
    assert r_port >= 0.993, r_port
    assert abs(r_port - r_jax) <= 0.002, (r_port, r_jax)
    assert (idx == jidx).mean() >= 0.99
    assert abs(stats.dist_evals - jstats.dist_evals) <= \
        0.01 * jstats.dist_evals
    assert stats.reordered and jstats.reordered


@pytest.mark.parametrize("option", [{"backend": "ref"},
                                    {"selection": "heap"},
                                    {"selection": "naive"}],
                         ids=["ref", "heap", "naive"])
def test_build_options_parity_with_jax_on_seeded_512(option):
    """The lexsort build and the heap / naive selections on the 512-point
    regression, fed the JAX build's own draws: the JAX build's recall
    within 0.002, test_core.py:56's floor, slot-by-slot agreement."""
    x = np.array(jdatasets.clustered(jax.random.key(11), 512, 16, 8))
    _, ti = brute_force_knn(jnp.asarray(x), jnp.asarray(x), 10)
    ti = torch.from_numpy(np.array(ti))
    jcfg = jnd.DescentConfig(k=10, rho=1.0, max_iters=15, **option)
    _, jidx, jstats = jnd.build_knn_graph(jnp.asarray(x), k=10, cfg=jcfg,
                                          key=jax.random.key(5))
    jidx = torch.from_numpy(np.array(jidx))
    cfg = DescentConfig(k=10, rho=1.0, max_iters=15, **option)
    _, idx, stats = build_knn_graph(
        x, k=10, cfg=cfg, device="cpu", draws=_jax_draws(
            jax.random.key(5), 512, 10, cfg.max_iters, cfg.selection))
    r_port, r_jax = recall_at_k(idx, ti), recall_at_k(jidx, ti)
    assert r_port >= 0.9, r_port
    assert abs(r_port - r_jax) <= 0.002, (r_port, r_jax)
    assert (idx == jidx).float().mean() >= 0.99
    assert stats.iters == jstats.iters
    assert abs(stats.dist_evals - jstats.dist_evals) <= \
        0.01 * jstats.dist_evals


def test_build_recall_with_own_generator():
    """test_core.py:51-57's floor, with the port's own corpus and draws."""
    x = datasets.clustered(2048, 16, 8, seed=0)
    g = torch.Generator().manual_seed(1)
    cfg = DescentConfig(k=20, rho=1.0, max_iters=15)
    dist, idx, stats = build_knn_graph(x, k=20, cfg=cfg, generator=g,
                                       device="cpu")
    d = torch.cdist(x, x).square()
    d.fill_diagonal_(torch.inf)                  # self excluded by index
    ti = d.topk(20, largest=False).indices
    assert recall_at_k(idx, ti) > 0.95
    assert (dist[:, 1:] >= dist[:, :-1]).all()
    assert stats.iters <= cfg.max_iters and len(stats.polish_updates) == 2


def test_selection_variants_equivalent_quality():
    """test_core.py:80-92 on the port's own corpus and draws: naive, heap
    and turbo within 0.06 of each other, each above 0.90."""
    x = datasets.clustered(2048, 16, 8, seed=0)
    d = torch.cdist(x, x).square()
    d.fill_diagonal_(torch.inf)
    ti = d.topk(20, largest=False).indices
    recalls = {}
    for sel in ("naive", "heap", "turbo"):
        cfg = DescentConfig(k=20, rho=1.0, max_iters=10, selection=sel,
                            reorder=False)
        _, idx, _ = build_knn_graph(x, k=20, cfg=cfg, generator=torch
                                    .Generator().manual_seed(2),
                                    device="cpu")
        recalls[sel] = recall_at_k(idx, ti)
    assert min(recalls.values()) > 0.90, recalls
    assert max(recalls.values()) - min(recalls.values()) < 0.06, recalls


def test_neighbor_lists_roundtrip():
    rng = np.random.RandomState(0)
    d = np.sort(rng.rand(6, 3).astype(np.float32), axis=1)
    i = rng.randint(-1, 6, size=(6, 3)).astype(np.int32)
    f = rng.rand(6, 3) < 0.5
    nl = neighbor_lists_from_numpy(d, i, f)
    assert (nl.dist.dtype, nl.idx.dtype, nl.new.dtype) == (
        torch.float32, torch.int32, torch.bool)
    for got, want in zip(nl.to_numpy(), (d, i, f)):
        np.testing.assert_array_equal(got, want)


def test_package_imports_no_jax():
    code = ("import sys, repro_torch, repro_torch.core, repro_torch.kernels;"
            "import repro_torch.kernels.ops, repro_torch.core.datasets;"
            "import repro_torch.core.graph_search, repro_torch.core.recall;"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or "
            "m.startswith('repro.')];"
            "assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=SRC)
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   timeout=120)


def test_public_names_cover_the_jax_package():
    """repro_torch.core exports every name of repro.core's __all__, and
    repro_torch every name of repro's."""
    import repro
    import repro.core
    import repro_torch
    import repro_torch.core
    for theirs, ours in ((repro.core, repro_torch.core),
                         (repro, repro_torch)):
        assert set(theirs.__all__) <= set(ours.__all__), \
            set(theirs.__all__) - set(ours.__all__)
        assert all(hasattr(ours, n) for n in ours.__all__)


def test_build_defaults_to_the_card():
    """Without ``device`` the build runs on CUDA; with no card it raises
    instead of running on the CPU."""
    x = np.random.RandomState(0).randn(64, 4).astype(np.float32)
    if torch.cuda.is_available():
        _, idx, _ = build_knn_graph(x, k=4)
        assert idx.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build_knn_graph(x, k=4)
