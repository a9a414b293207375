"""Wrapper of the LM stack's attention CUDA kernels.

``flash_attention_cuda`` replaces ``flash_attention``
(src/repro/kernels/flash_attention.py:86, body ``_flash_kernel`` :30). It
is also what the model's ``chunked_attention`` (models/attention.py) runs
on a card, so it takes the union of the Pallas kernel's and
``_flash_block``'s options: a caller's ``scale``, a v head width that
differs from q's, and ragged Lq / Lk (the Pallas kernel refuses lengths
that are not tile multiples; this one masks the tails by position).
Bound on this card: operations (4 * Dh per visible (q, k) pair). It
dispatches by dtype, one kernel each (no fallback from one to the other):

* f32 (the exact path, "fp32 means fp32"): csrc/attention_kernels.cu,
  fp32 FMAs on the CUDA cores, 8 x 8 logits and outputs per thread: one
  128-thread block per (b*h, 64 query rows; 32 above Dh 128), two blocks
  to an SM, k and v streamed through a 2-stage cp.async ring in slices,
  the heaviest causal tiles first; Dq and Dv multiples of 4 up to 256.
* bf16: csrc/attention_sm90.cu, wgmma on the tensor cores fed by TMA: one
  block per (b*h, 128 query rows), a producer warp keeping (k, v) tiles in
  flight, P rounded to bf16 for the second product; Dq and Dv multiples of
  16 up to 256.

Both skip the kv tiles no row of a query tile can see. Neither has a
backward, so the wrapper raises ``RuntimeError`` when autograd would
record the call (grad mode on and an input that requires grad) rather
than return an output that silently cuts the gradient: training runs the
plain chunked attention (``models.attention.chunked_attention(...,
backend="ref")``, as ``models.model.loss_fn`` does). The wrapper checks
device, dtype, shape, contiguity and 16-byte alignment (both kernels copy
16 bytes at a time), allocates the output with
``torch.empty``, launches on the current stream, raises on a non-zero
launch code, and counts the launches of both in
``_lib.LAUNCHES["flash_attention"]``.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _lib
from repro_torch.kernels.knn_join import _check

ATTN_MAX_D = 256         # kAttnMaxD / kMaxD in csrc/attention_*.cu
DTYPES = (torch.float32, torch.bfloat16)
# the head widths each kernel takes come in multiples of this: the f32
# kernel reads float4s, the bf16 kernel's wgmma steps over 16 of Dq
D_QUANTUM = {torch.float32: 4, torch.bfloat16: 16}


def flash_attention_cuda(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    causal: bool = True, window: int | None = None,
    softcap: float | None = None, scale: float | None = None,
    q_offset: int = 0,
) -> torch.Tensor:
    """q (B, Lq, H, Dq), k (B, Lk, Hkv, Dq), v (B, Lk, Hkv, Dv), all f32 or
    all bf16 and contiguous -> (B, Lq, H, Dv) in that dtype; rows that see
    no key are 0. ``window`` None is no window; ``scale`` None is
    1/sqrt(Dq). Raises under autograd (see the module docstring)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(
            "flash_attention_cuda has no backward: an input requires grad "
            "under grad mode. Run the plain attention under autograd: "
            "chunked_attention(..., backend='ref') or ops.attention(..., "
            "backend='ref')")
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
    quantum = D_QUANTUM[q.dtype]
    for name, d in (("Dq", dq), ("Dv", dv)):
        if not (quantum <= d <= ATTN_MAX_D and d % quantum == 0):
            raise ValueError(f"{name}={d} must be a multiple of {quantum} in "
                             f"[{quantum}, {ATTN_MAX_D}] at {q.dtype}")
    if softcap is not None and softcap <= 0:
        raise ValueError(f"softcap must be positive; got {softcap}")
    o = torch.empty((b, lq, h, dv), dtype=q.dtype, device=dev)
    if lq == 0:
        return o
    scale = 1.0 / math.sqrt(dq) if scale is None else float(scale)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            b, lq, lk, h, hkv, dq, dv, scale,
            0.0 if softcap is None else float(softcap), int(causal),
            -1 if window is None else int(window), int(q_offset))
    stream = torch.cuda.current_stream(dev).cuda_stream
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16 and t.numel():
            raise ValueError(f"{name} must be 16-byte aligned")
    if q.dtype == torch.bfloat16:
        code = _lib.lib().flash_attention_sm90_launch(*args, stream)
    else:
        code = _lib.lib().flash_attention_launch(*args, stream)
    _lib.check(code, "flash_attention")
    _lib.LAUNCHES["flash_attention"] += 1
    return o
