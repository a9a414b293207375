"""Wrapper of the LM stack's attention CUDA kernel.

``flash_attention_cuda`` replaces ``flash_attention``
(src/repro/kernels/flash_attention.py:86, body ``_flash_kernel`` :30). It
is also what the model's ``chunked_attention`` (models/attention.py) runs
on a card, so it takes the union of the Pallas kernel's and
``_flash_block``'s options: a caller's ``scale``, a v head width that
differs from q's, and ragged Lq / Lk (the Pallas kernel refuses lengths
that are not tile multiples; this one masks the tails by position).
Bound on this card: operations (4 * Dh per visible (q, k) pair). One block
per (b*h, 64 query rows) stages fp32 k / v tiles in shared memory and
skips the kv tiles that no row of its tile can see (csrc/
attention_kernels.cu). It checks device, dtype, shape and contiguity,
allocates the output with ``torch.empty``, launches on the current stream,
raises on a non-zero launch code, and counts its launches in
``_lib.LAUNCHES``.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _lib
from repro_torch.kernels.knn_join import _check

ATTN_MAX_D = 256         # kAttnMaxD in csrc/attention_kernels.cu
DTYPES = (torch.float32, torch.bfloat16)


def flash_attention_cuda(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    causal: bool = True, window: int | None = None,
    softcap: float | None = None, scale: float | None = None,
    q_offset: int = 0,
) -> torch.Tensor:
    """q (B, Lq, H, Dq), k (B, Lk, Hkv, Dq), v (B, Lk, Hkv, Dv), all f32 or
    all bf16 and contiguous -> (B, Lq, H, Dv) in that dtype; rows that see
    no key are 0. ``window`` None is no window; ``scale`` None is
    1/sqrt(Dq)."""
    dev = q.device
    if q.dtype not in DTYPES:
        raise TypeError(f"q must be one of {DTYPES}; got {q.dtype}")
    _check(q, "q", q.dtype, 4, dev)
    _check(k, "k", q.dtype, 4, dev)
    _check(v, "v", q.dtype, 4, dev)
    b, lq, h, dq = q.shape
    _, lk, hkv, dv = v.shape
    if k.shape[:3] != (b, lk, hkv) or k.shape[3] != dq \
            or hkv < 1 or h % hkv:
        raise ValueError(f"shapes disagree: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    for name, d in (("Dq", dq), ("Dv", dv)):
        if not (4 <= d <= ATTN_MAX_D and d % 4 == 0):
            raise ValueError(f"{name}={d} must be a multiple of 4 in "
                             f"[4, {ATTN_MAX_D}]")
    if b * h > 65535:
        raise ValueError(f"B*H={b * h} exceeds the grid's 65535")
    if softcap is not None and softcap <= 0:
        raise ValueError(f"softcap must be positive; got {softcap}")
    o = torch.empty((b, lq, h, dv), dtype=q.dtype, device=dev)
    if lq == 0:
        return o
    scale = 1.0 / math.sqrt(dq) if scale is None else float(scale)
    code = _lib.lib().flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        b, lq, lk, h, hkv, dq, dv, scale,
        0.0 if softcap is None else float(softcap), int(causal),
        -1 if window is None else int(window), int(q_offset),
        int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(dev).cuda_stream)
    _lib.check(code, "flash_attention")
    _lib.LAUNCHES["flash_attention"] += 1
    return o
