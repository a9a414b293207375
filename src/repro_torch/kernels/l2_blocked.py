"""Wrapper of the pairwise squared-l2 CUDA kernel.

``pairwise_sq_l2_cuda`` replaces ``pairwise_sq_l2_blocked``
(src/repro/kernels/l2_blocked.py:63, body ``_l2_kernel`` :38). Bound on
this card: fp32 operations (2*M*N*D against M*N*4 bytes written). A block
owns a 128 x 128 output tile, stages 16-feature chunks of both operands in
shared memory and keeps an 8 x 8 micro-tile of sums per thread in
registers; the norms are summed from the same tiles. Ragged edges are
masked in the kernel, so nothing is padded here. Same checks, allocation,
stream and launch count as the join wrappers (kernels/knn_join.py).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _lib
from repro_torch.kernels.knn_join import _check

L2_MAX_ROWS = 65535 * 128    # grid rows of 128-row tiles (csrc kL2BM)


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
    if m > L2_MAX_ROWS:
        raise ValueError(f"M={m} exceeds the kernel's {L2_MAX_ROWS} rows")
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    if m == 0 or n == 0:
        return out
    code = _lib.lib().pairwise_sq_l2_launch(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, d,
        torch.cuda.current_stream(dev).cuda_stream)
    _lib.check(code, "pairwise_sq_l2")
    _lib.LAUNCHES["pairwise_sq_l2"] += 1
    return out
