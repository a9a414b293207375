"""Semantic data ordering: the paper's greedy reorder (§3.2) applied at
the corpus level (src/repro/data/ordering.py).

Build a K-NN graph over per-example embeddings with the port's
NN-Descent (its join, select and merge kernels on a card), run the
greedy clustering heuristic to get the locality permutation sigma, and
traverse the corpus in sigma-order: consecutive training batches then
draw from nearby regions of embedding space, turning data-space locality
into stream-space locality for the retrieval datastore or embedding
cache.

The build's randomness is a ``torch.Generator`` or the injected
``draws`` (a ``BuildDraws``, e.g. the JAX build's own), where JAX takes
a key: torch generators cannot reproduce JAX's threefry draws.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.device import resolve_device
from repro_torch.core.heap import NeighborLists
from repro_torch.core.nn_descent import BuildDraws, DescentConfig, build_knn_graph
from repro_torch.core.reorder import greedy_reorder, locality_stats


def semantic_order(
    embeddings,                # (n_docs, d) example embeddings
    *,
    k: int = 10,
    generator: torch.Generator | None = None,
    draws: BuildDraws | None = None,
    cfg: DescentConfig | None = None,
    device=None,
) -> tuple[np.ndarray, dict]:
    """Returns (order (n,) int32 numpy: position -> doc id, stats: the
    build's iterations and distance evaluations, and the graph's in-block
    fraction before and after the reorder). Runs on ``device``, "cuda"
    unless the caller asks otherwise (raises without a card)."""
    device = resolve_device(device, "semantic_order")
    cfg = cfg or DescentConfig(k=k, rho=1.0, max_iters=8, reorder=False)
    dist, idx, st = build_knn_graph(embeddings, k=k, cfg=cfg,
                                    generator=generator, device=device,
                                    draws=draws)
    order, locality = order_from_graph(dist, idx)
    return order, {"build_iters": st.iters, "dist_evals": st.dist_evals,
                   **locality}


def order_from_graph(dist: torch.Tensor, idx: torch.Tensor
                     ) -> tuple[np.ndarray, dict]:
    """The greedy reorder of a built (n, k) graph -> (order (n,) int32
    numpy: position -> doc id, the graph's in-block fraction before and
    after the reorder)."""
    nl = NeighborLists(dist, idx, torch.zeros_like(idx, dtype=torch.bool))
    before = locality_stats(nl)
    sigma, sigma_inv = greedy_reorder(nl)
    # the reordered graph's locality (for reporting): ids through sigma
    n = idx.shape[0]
    si = sigma_inv.long()
    idx_r = torch.where(idx >= 0, sigma[idx.clamp(0, n - 1).long()],
                        -1)[si]
    after = locality_stats(
        NeighborLists(dist[si], idx_r, torch.zeros_like(idx_r,
                                                        dtype=torch.bool)))
    return sigma_inv.cpu().numpy(), {   # position p reads doc order[p]
        "in_block_before": before["in_block_fraction"],
        "in_block_after": after["in_block_fraction"]}


def mean_pool_embeddings(token_batches, d_proj: int = 64,
                         vocab: int | None = None,
                         seed: int = 0) -> torch.Tensor:
    """Cheap example embeddings for ordering when no model is in hand:
    a random-projection bag of tokens (deterministic; the numpy
    projection and mean of the JAX package, bit for bit). token_batches:
    (n, L) int array. Returns (n, d_proj) float32 on the CPU."""
    toks = np.asarray(token_batches)
    n, L = toks.shape
    v = int(vocab if vocab is not None else toks.max() + 1)
    rng = np.random.RandomState(seed)
    proj = rng.normal(0, 1 / np.sqrt(d_proj), size=(v, d_proj)).astype(
        np.float32)
    out = proj[toks.reshape(-1)].reshape(n, L, d_proj).mean(axis=1)
    return torch.from_numpy(out)
