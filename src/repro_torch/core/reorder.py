"""Greedy reordering heuristic — paper §3.2, Algorithm 1 (chain form: the
neighbors of the node currently AT position i are tried for position i+1;
see the JAX package's ``core/reorder.py`` for why).

sigma maps node id -> memory position; sigma_inv maps position -> node id.
For each position i, in ascending distance order over the neighbors t of
the node at position i:
    if sigma(t) <  i+1: already well placed, try the next neighbor
    if sigma(t) == i+1: done for this i
    if sigma(t) >  i+1: swap t into position i+1, done for this i

The pass is an inherently sequential chase of up to n*k steps. The JAX
package runs it as an on-device ``fori_loop``; here it runs on the host
over a CPU copy of the ids, one core, as the paper runs it. The
permutation is then applied once to the points and the graph state.
``locality_stats`` and ``window_cluster_purity`` measure what it bought.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.heap import NeighborLists


def greedy_reorder(nl: NeighborLists) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (sigma, sigma_inv), each (n,) int32 on ``nl``'s device."""
    n, _ = nl.idx.shape
    adj = nl.idx.cpu().numpy().tolist()
    sigma = list(range(n))
    sigma_inv = list(range(n))
    for i in range(n - 1):
        nxt = i + 1
        for t in adj[sigma_inv[i]]:
            if t < 0:
                continue
            st = sigma[t]
            if st < nxt:
                continue
            if st > nxt:
                u = sigma_inv[nxt]
                sigma[t] = nxt
                sigma[u] = st
                sigma_inv[nxt] = t
                sigma_inv[st] = u
            break
    dev = nl.idx.device
    return (torch.as_tensor(np.asarray(sigma, np.int32), device=dev),
            torch.as_tensor(np.asarray(sigma_inv, np.int32), device=dev))


def apply_permutation(
    x: torch.Tensor, nl: NeighborLists, sigma: torch.Tensor,
    sigma_inv: torch.Tensor,
) -> tuple[torch.Tensor, NeighborLists]:
    """Permute points + graph state into the new memory order. Row at new
    position p holds old node sigma_inv[p]; neighbor ids are rewritten
    through sigma so the graph stays consistent."""
    n = x.shape[0]
    inv = sigma_inv.long()
    idx = nl.idx[inv]
    idx = torch.where(idx >= 0, sigma[idx.clamp(0, n - 1).long()], -1)
    return x[inv], NeighborLists(nl.dist[inv], idx, nl.new[inv])


def locality_stats(nl: NeighborLists, block: int = 128) -> dict:
    """The cache-miss stand-in: the fraction of graph edges whose two ends
    fall in the same ``block`` of rows, and the mean |i - j| gather spread
    (summed in float: the sum of |i - j| passes int32 past about 1e5
    rows)."""
    n, k = nl.idx.shape
    rows = torch.arange(n, device=nl.idx.device)[:, None].expand(n, k)
    idx = nl.idx.long()
    valid = idx >= 0
    same = torch.div(rows, block, rounding_mode="floor") == torch.div(
        idx, block, rounding_mode="floor")
    edges = max(int(valid.sum()), 1)
    spread = torch.where(valid, (rows - idx).abs(), 0).float().sum()
    return {
        "in_block_fraction": float(int((same & valid).sum()) / edges),
        "mean_gather_spread": float(spread / edges),
        "block": block,
    }


def window_cluster_purity(labels, sigma, window: int = 2000,
                          stride: int = 200):
    """Paper Fig. 4: per-window dominant-cluster fraction along the
    reordered axis. ``labels`` (n,) int cluster ids; ``sigma`` node ->
    position. Returns (window starts, purities)."""
    labels = torch.as_tensor(labels).long()
    sigma = torch.as_tensor(sigma, device=labels.device).long()
    n = labels.shape[0]
    order = torch.zeros_like(labels)
    order[sigma] = labels
    n_clusters = int(labels.max()) + 1
    starts = list(range(0, n - window + 1, stride))
    purities = [float(torch.bincount(order[s:s + window],
                                     minlength=n_clusters).max() / window)
                for s in starts]
    return starts, purities
