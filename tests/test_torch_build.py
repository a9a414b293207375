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


def _jax_draws(key, n, k, iters):
    """The draws of repro's build_knn_graph for ``key``
    (nn_descent.py:461,469; heap.py:30; selection.py:106-114)."""
    k_init, key = jax.random.split(key)
    init = np.array(jax.random.randint(k_init, (n, k), 0, n,
                                       dtype=jnp.int32))
    its = []
    for _ in range(iters):
        key, k_it = jax.random.split(key)
        subs = jax.random.split(k_it, 3)
        its.append(tuple(torch.from_numpy(np.array(
            jax.random.uniform(s, (2 * n * k,)))) for s in subs))
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
