"""Recall metrics (paper §2: recall measures how close the approximate
K-NNG is to the true one). The exact k-NN (``brute_force_knn``) comes with
the ``pairwise_sq_l2`` kernel in a later slice."""
from __future__ import annotations

import torch


def recall_at_k(approx_idx: torch.Tensor, true_idx: torch.Tensor, *,
                chunk: int = 8192) -> float:
    """|approx ∩ true| / k averaged over rows (chunked over rows)."""
    hits = 0
    for s in range(0, approx_idx.shape[0], chunk):
        a = approx_idx[s:s + chunk]
        hit = (a[:, :, None] == true_idx[s:s + chunk, None, :]).any(-1)
        hits += int((hit & (a >= 0)).sum())
    return hits / (true_idx.shape[0] * true_idx.shape[1])


def distance_recall(approx_dist: torch.Tensor, true_dist: torch.Tensor,
                    eps: float = 1e-6) -> float:
    """Tie-tolerant recall: an approx neighbor counts if its distance is
    within eps of the true k-th distance (handles duplicate points)."""
    kth = true_dist[:, -1][:, None]
    ok = (approx_dist <= kth * (1 + eps) + eps) & torch.isfinite(approx_dist)
    return float((ok.sum(dim=1) / true_dist.shape[1]).mean())
