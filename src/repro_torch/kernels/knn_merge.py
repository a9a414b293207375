"""Wrapper of the bounded neighbor-list merge's CUDA kernel.

``knn_merge_cuda`` replaces ``knn_merge_blocked`` (src/repro/kernels/
knn_merge.py:156, body ``_merge_kernel`` :30). Bound on this card: bytes
(8 per list and candidate entry in, 8 per list entry out); the dedup's
compares stay in shared memory. One warp per row stages its pool in shared
memory and runs k rounds of a strided scan plus a shuffle argmin, stopping
at the first sentinel. Same checks, allocation, stream and launch count as
the join wrappers (kernels/knn_join.py).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _lib
from repro_torch.kernels.knn_join import _check

MERGE_MAX_POOL = 1536    # kMergeMaxPool in csrc/knn_kernels.cu


def knn_merge_cuda(
    cur_dist: torch.Tensor, cur_idx: torch.Tensor,
    cand_dist: torch.Tensor, cand_idx: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(n, k) f32/i32 lists + (n, c) f32/i32 candidates -> (n, k) f32,
    (n, k) i32, (n,) i32 accepted counts."""
    dev = cur_dist.device
    _check(cur_dist, "cur_dist", torch.float32, 2, dev)
    _check(cur_idx, "cur_idx", torch.int32, 2, dev)
    _check(cand_dist, "cand_dist", torch.float32, 2, dev)
    _check(cand_idx, "cand_idx", torch.int32, 2, dev)
    n, k = cur_dist.shape
    c = cand_dist.shape[1]
    if cur_idx.shape != (n, k) or cand_idx.shape != (n, c) \
            or cand_dist.shape[0] != n:
        raise ValueError("list and candidate shapes disagree")
    if k < 1 or k + c > MERGE_MAX_POOL:
        raise ValueError(f"need 1 <= k and k + c <= {MERGE_MAX_POOL}; "
                         f"got k={k}, c={c}")
    od = torch.empty((n, k), dtype=torch.float32, device=dev)
    oi = torch.empty((n, k), dtype=torch.int32, device=dev)
    upd = torch.empty((n,), dtype=torch.int32, device=dev)
    if n == 0:
        return od, oi, upd
    code = _lib.lib().knn_merge_launch(
        cur_dist.data_ptr(), cur_idx.data_ptr(), cand_dist.data_ptr(),
        cand_idx.data_ptr(), od.data_ptr(), oi.data_ptr(), upd.data_ptr(),
        n, k, c, torch.cuda.current_stream(dev).cuda_stream)
    _lib.check(code, "knn_merge")
    _lib.LAUNCHES["knn_merge"] += 1
    return od, oi, upd
