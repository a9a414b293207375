"""Ground truth and recall metrics (paper §2: recall measures how close the
approximate K-NNG is to the true one)."""
from __future__ import annotations

import torch

from repro_torch.core.device import resolve_device
from repro_torch.kernels import ops


def brute_force_knn(
    x,
    queries,
    k: int,
    *,
    chunk: int = 1024,
    backend: str = "auto",
    exclude_self: bool = True,
    device=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact k-NN of ``queries`` against corpus ``x`` (squared l2).

    Chunked over queries through the pairwise distance kernel
    (``ops.pairwise_sq_l2``); each (chunk, n) tile is reduced by
    ``torch.topk``. Returns (dist (q, k) f32, idx (q, k) i32) ascending.
    ``exclude_self`` requires that the queries ARE the corpus (row i of
    the queries is row i of the corpus); self is excluded by index, since
    the norm expansion's self-distance carries cancellation error and a
    threshold would also drop true duplicates. Pass exclude_self=False for
    a separate query set. Runs on ``device``, "cuda" unless the caller
    asks otherwise; with no card present that raises."""
    device = resolve_device(device, "brute_force_knn")
    x = torch.as_tensor(x, dtype=torch.float32, device=device).contiguous()
    queries = torch.as_tensor(queries, dtype=torch.float32,
                              device=device).contiguous()
    nq, n = queries.shape[0], x.shape[0]
    if exclude_self and nq != n:
        raise ValueError(
            "exclude_self=True assumes queries IS the corpus "
            f"(row-aligned); got {nq} queries vs {n} corpus rows — pass "
            "exclude_self=False")
    dist = torch.empty((nq, k), dtype=torch.float32, device=device)
    idx = torch.empty((nq, k), dtype=torch.int32, device=device)
    for s in range(0, nq, chunk):
        d = ops.pairwise_sq_l2(queries[s:s + chunk], x, backend=backend)
        if exclude_self:
            r = torch.arange(d.shape[0], device=device)
            d[r, s + r] = torch.inf
        dd, ii = torch.topk(d, k, dim=1, largest=False)
        dist[s:s + chunk] = dd
        idx[s:s + chunk] = ii.to(torch.int32)
    return dist, idx


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
