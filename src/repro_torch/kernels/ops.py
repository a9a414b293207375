"""Dispatch of the port's kernels, by the device of the tensors.

* A tensor on the CPU goes to the plain version in ``ref.py``.
* A tensor on a CUDA device goes to the hand-written kernel, or the call
  raises: there is no fallback to the plain version on a card.
* ``backend="ref"`` forces the plain version on any device. Tests and the
  comparison phase of ``chip_smoke.py`` use it.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import flash_attention_cuda
from repro_torch.kernels.knn_join import (
    knn_join_dists_cuda,
    knn_join_select_cuda,
)
from repro_torch.kernels.knn_merge import (
    knn_compact_cuda,
    knn_compact_rows_cuda,
    knn_merge_cuda,
    knn_merge_rows_cuda,
)
from repro_torch.kernels.knn_search import knn_search_dists_cuda
from repro_torch.kernels.l2_blocked import pairwise_sq_l2_cuda
from repro_torch.kernels.l2_quant import (
    knn_join_dists_bf16_cuda,
    knn_join_dists_q8_cuda,
    knn_search_dists_bf16_cuda,
    knn_search_dists_q8_cuda,
)

BACKENDS = ("auto", "ref")


def _plain(t: torch.Tensor, backend: str) -> bool:
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected {BACKENDS}")
    return backend == "ref" or t.device.type == "cpu"


def knn_join_dists(x, x2, ids, cn: int, *, backend: str = "auto"):
    """(N, dp) rows, (N,) norms, (n, C) ids -> (n, C, C) pair distances,
    (n,) valid unordered pair counts."""
    if _plain(x, backend):
        return ref.knn_join_dists(x, x2, ids, cn)
    return knn_join_dists_cuda(x, x2, ids, cn)


def knn_join_select(gd, gi, kth, c: int, *, backend: str = "auto"):
    """(n, W) dists/ids, (n,) kth -> best c per row, (+inf, -1) fill."""
    if _plain(gd, backend):
        return ref.knn_join_select(gd, gi, kth, c)
    return knn_join_select_cuda(gd, gi, kth, c)


def knn_merge(cur_dist, cur_idx, cand_dist, cand_idx, *,
              backend: str = "auto"):
    """Merge (n, c) candidates into sorted (n, k) lists -> (dist, idx,
    accepted)."""
    if _plain(cur_dist, backend):
        return ref.knn_merge(cur_dist, cur_idx, cand_dist, cand_idx)
    return knn_merge_cuda(cur_dist, cur_idx, cand_dist, cand_idx)


def knn_merge_rows(cur_dist, cur_idx, rows, cand_dist, cand_idx, *,
                   backend: str = "auto"):
    """Merge (f, c) candidates into list rows ``rows`` (f,) (-1 = padding)
    -> full (n, k) copies of the lists, (f,) accepted (0 on padding)."""
    if _plain(cur_dist, backend):
        return ref.knn_merge_rows(cur_dist, cur_idx, rows, cand_dist,
                                  cand_idx)
    return knn_merge_rows_cuda(cur_dist, cur_idx, rows, cand_dist, cand_idx)


def knn_compact(cur_dist, cur_idx, drop, *, backend: str = "auto"):
    """Drop the (n, k) masked entries; survivors packed ascending, freed
    slots (+inf, -1) -> (dist, idx, removed (n,))."""
    if _plain(cur_dist, backend):
        return ref.knn_compact(cur_dist, cur_idx, drop)
    return knn_compact_cuda(cur_dist, cur_idx, drop)


def knn_compact_rows(cur_dist, cur_idx, rows, drop, *, backend: str = "auto"):
    """``knn_compact`` of list rows ``rows`` (f,) under the (f, k) mask ->
    full (n, k) copies of the lists, (f,) removed (0 on padding)."""
    if _plain(cur_dist, backend):
        return ref.knn_compact_rows(cur_dist, cur_idx, rows, drop)
    return knn_compact_rows_cuda(cur_dist, cur_idx, rows, drop)


def pairwise_sq_l2(a, b, *, backend: str = "auto"):
    """(M, D) x (N, D) -> (M, N) squared l2, clamped at 0."""
    if _plain(a, backend):
        return ref.pairwise_sq_l2(a, b)
    return pairwise_sq_l2_cuda(a, b)


def centroid_assign(q, q2, cent, c2, *, t: int = 1, backend: str = "auto"):
    """Top-``t`` nearest centroids per row: (m, dp) x (c, dp) -> (dist (m,
    t) ascending, idx (m, t) i32), ties to the lowest centroid id. The
    tile is the ``pairwise_sq_l2`` kernel (its plain version for CPU
    tensors, which takes the cached norms); the top-t is a stable sort."""
    if _plain(q, backend):
        return ref.centroid_assign(q, q2, cent, c2, t)
    return ref.top_t(pairwise_sq_l2_cuda(q.contiguous(), cent.contiguous()),
                     t)


def knn_search_dists(q, q2, x, x2, ids, *, backend: str = "auto"):
    """(nq, dp) queries and norms against the (N, dp) rows named by (nq, W)
    ids -> (nq, W) squared l2, +inf where the id is invalid."""
    if _plain(q, backend):
        return ref.knn_search_dists(q, q2, x, x2, ids)
    return knn_search_dists_cuda(q, q2, x, x2, ids)


def knn_search_dists_q8(qq, qscale, q2, data, scale, x2, ids, *,
                        backend: str = "auto"):
    """(nq, w) int8 queries with their scales and norms against the int8
    mirror rows named by (nq, W) ids -> (nq, W) quantized squared l2,
    +inf where the id is invalid."""
    if _plain(qq, backend):
        return ref.knn_search_dists_q8(qq, qscale, q2, data, scale, x2, ids)
    return knn_search_dists_q8_cuda(qq, qscale, q2, data, scale, x2, ids)


def knn_search_dists_bf16(q, q2, data, x2, ids, *, backend: str = "auto"):
    """The bf16 twin of ``knn_search_dists_q8`` (no scales)."""
    if _plain(q, backend):
        return ref.knn_search_dists_bf16(q, q2, data, x2, ids)
    return knn_search_dists_bf16_cuda(q, q2, data, x2, ids)


def knn_join_dists_q8(data, scale, x2, ids, cn: int, *,
                      backend: str = "auto"):
    """int8 mirror (N, w) with scales and norms, (n, C) ids -> (n, C, C)
    quantized pair distances, (n,) valid unordered pair counts."""
    if _plain(data, backend):
        return ref.knn_join_dists_q8(data, scale, x2, ids, cn)
    return knn_join_dists_q8_cuda(data, scale, x2, ids, cn)


def knn_join_dists_bf16(data, x2, ids, cn: int, *, backend: str = "auto"):
    """The bf16 twin of ``knn_join_dists_q8`` (no scales)."""
    if _plain(data, backend):
        return ref.knn_join_dists_bf16(data, x2, ids, cn)
    return knn_join_dists_bf16_cuda(data, x2, ids, cn)


def attention(q, k, v, *, causal: bool = True, window: int | None = None,
              softcap: float | None = None, scale: float | None = None,
              q_offset: int = 0, backend: str = "auto"):
    """q (B, Lq, H, Dq), k (B, Lk, Hkv, Dq), v (B, Lk, Hkv, Dv) -> (B, Lq,
    H, Dv) in q's dtype: online-softmax attention, fp32 inside, causal /
    window / softcap masks from positions (q[0] at ``q_offset``), GQA
    folded. The kernel writes 0 on rows that see no key; the plain version
    gives NaN there, as JAX's oracle does."""
    if _plain(q, backend):
        return ref.attention(q, k, v, causal=causal, window=window,
                             softcap=softcap, scale=scale, q_offset=q_offset)
    return flash_attention_cuda(q, k, v, causal=causal, window=window,
                                softcap=softcap, scale=scale,
                                q_offset=q_offset)
