"""Wrapper of the query-time candidate distance CUDA kernel.

``knn_search_dists_cuda`` replaces ``knn_search_dists_blocked``
(src/repro/kernels/knn_search.py:66, body ``_search_dists_kernel`` :47).
The TPU kernel takes the candidate rows gathered beforehand, (nq, W, dp);
this one takes the ids and the base rows and gathers them itself, so the
copy (about 190 MB per round at q_block 512, W 120, dp 784) is never made.
Bound on this card: bytes (one row of dp floats per valid candidate).
The kernel (``csrc/search_tile.cuh``, shared with the quantized tiles)
runs a block per query with the query row in registers and each warp's
candidate ids and norms loaded before its first row, so no row waits on
its id; rows stream with 16-byte loads and invalid ids are skipped.
Same checks, allocation, stream and launch count as the join wrappers
(kernels/knn_join.py).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _lib
from repro_torch.kernels.knn_join import _check

SEARCH_MAX_DP = 12288    # kSearchMaxRowBytes / 4 in csrc/search_tile.cuh


def knn_search_dists_cuda(
    q: torch.Tensor, q2: torch.Tensor, x: torch.Tensor, x2: torch.Tensor,
    ids: torch.Tensor,
) -> torch.Tensor:
    """(nq, dp) f32 queries, (nq,) f32 norms, (N, dp) f32 base rows, (N,)
    f32 norms, (nq, W) i32 ids -> (nq, W) f32; ids outside [0, N) give
    +inf."""
    dev = q.device
    _check(q, "q", torch.float32, 2, dev)
    _check(q2, "q2", torch.float32, 1, dev)
    _check(x, "x", torch.float32, 2, dev)
    _check(x2, "x2", torch.float32, 1, dev)
    _check(ids, "ids", torch.int32, 2, dev)
    nq, dp = q.shape
    big_n = x.shape[0]
    w = ids.shape[1]
    if x.shape[1] != dp or q2.shape[0] != nq or x2.shape[0] != big_n \
            or ids.shape[0] != nq:
        raise ValueError(f"shapes disagree: q {tuple(q.shape)}, q2 "
                         f"{tuple(q2.shape)}, x {tuple(x.shape)}, x2 "
                         f"{tuple(x2.shape)}, ids {tuple(ids.shape)}")
    if dp > SEARCH_MAX_DP:
        raise ValueError(f"dp={dp} exceeds the kernel's {SEARCH_MAX_DP}")
    od = torch.empty((nq, w), dtype=torch.float32, device=dev)
    if nq == 0 or w == 0:
        return od
    code = _lib.lib().knn_search_dists_launch(
        q.data_ptr(), q2.data_ptr(), x.data_ptr(), x2.data_ptr(),
        ids.data_ptr(), od.data_ptr(), big_n, nq, w, dp,
        torch.cuda.current_stream(dev).cuda_stream)
    _lib.check(code, "knn_search_dists")
    _lib.LAUNCHES["knn_search_dists"] += 1
    return od
