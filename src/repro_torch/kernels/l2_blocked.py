"""Wrapper of the pairwise squared-l2 CUDA kernel.

``pairwise_sq_l2_cuda`` replaces ``pairwise_sq_l2_blocked``
(src/repro/kernels/l2_blocked.py:63, body ``_l2_kernel`` :38). Bound on
this card: fp32 operations (2*M*N*D against M*N*4 bytes written). The
tile streams both operands k-major: the launch first copies them, with a
small transpose kernel, into (D, M) and (D, N) scratch allocated here,
rows padded to a multiple of 4 floats (the pad is never read into a
stored output), which takes any 4-byte offset or D. A block owns a 128 x
128 output tile and walks the features in chunks of 32 through a ring of
three shared-memory stages filled by asynchronous copies, keeping an 8 x 8
micro-tile of sums per thread in registers; the norms are summed from the
same stages. A grid of at most one tile per SM (the router's few
centroids) splits the features among more blocks, whose partial sums a
second small kernel adds, in split order, in scratch allocated here.
Ragged edges are masked in the kernel. Same checks,
allocation, stream and launch count as the join wrappers
(kernels/knn_join.py); one count covers the copies and the tile.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _lib
from repro_torch.kernels.knn_join import _check


def pairwise_sq_l2_cuda(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, D) f32 x (N, D) f32 -> (M, N) f32 squared l2, clamped at 0."""
    dev = a.device
    _check(a, "a", torch.float32, 2, dev)
    _check(b, "b", torch.float32, 2, dev)
    m, d = a.shape
    n = b.shape[0]
    if b.shape[1] != d:
        raise ValueError(f"feature dims differ: a {tuple(a.shape)}, "
                         f"b {tuple(b.shape)}")
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    if m == 0 or n == 0:
        return out
    lda, ldb = -(-m // 4) * 4, -(-n // 4) * 4
    at = torch.empty((d, lda), dtype=torch.float32, device=dev)
    bt = torch.empty((d, ldb), dtype=torch.float32, device=dev)
    splits = _lib.lib().pairwise_sq_l2_splits(m, n, d)
    ws = torch.empty((splits * (m * n + m + n) if splits > 1 else 0,),
                     dtype=torch.float32, device=dev)
    code = _lib.lib().pairwise_sq_l2_launch(
        a.data_ptr(), b.data_ptr(), at.data_ptr(), bt.data_ptr(),
        out.data_ptr(), ws.data_ptr(), m, n, d, lda, ldb, splits,
        torch.cuda.current_stream(dev).cuda_stream)
    _lib.check(code, "pairwise_sq_l2")
    _lib.LAUNCHES["pairwise_sq_l2"] += 1
    return out
