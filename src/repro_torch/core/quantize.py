"""Quantized corpus mirror for the two-stage distance path.

Storing the corpus in int8 or bf16 makes the candidate-scoring tiles 2-4x
lighter in bytes per row. The contract everywhere is **two-stage**:
candidate *scoring* runs on the quantized rows (kernels/l2_quant.py), and
whatever is returned is re-ranked with the exact fp32 kernel first, so
quantization can cost a sliver of recall (a true neighbor missing from the
candidate pool) but never a wrong distance.

int8 is symmetric per row (``quantize_sym_int8``; ``block`` gives per
feature-block scales); bf16 keeps no scales. A ``QuantizedStore`` holds the
stored rows, the per-row dequant scales and the squared norms OF THE
STORED values, so that the norm expansion ``q2 + c2 - 2 s_q s_c (q . c)``
is self-consistent: the quantized distance of a row to itself is exactly 0.

Rounding matches the JAX package bit for bit: fp32 division by the scale,
``torch.round`` (half to even, as ``jnp.round``), clamp to [-127, 127];
``.to(torch.bfloat16)`` rounds to nearest even, as JAX does.

``update_rows`` and ``grow`` keep a mirror row-aligned with a mutable
store (scatter-quantize in place, grow with quantized fill rows).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.layout import ceil_to

_EPS = 1e-30     # scale floor: all-zero rows dequantize to zero, not NaN
MIRROR_QUANTUM = 32


def mirror_width(d: int, dp: int) -> int:
    """Feature width of the quantized mirror of an (n, dp) fp32 array whose
    logical dim is ``d``: the logical dims padded to a 32-column quantum,
    never wider than ``dp``. Columns d..dp are zero padding, which adds
    nothing to any distance. (The JAX package uses 128 on a TPU, whose int8
    tiles are 128 lanes wide, and 32 elsewhere; on the H100 a 32-column
    int8 row is two 16-byte loads.)"""
    return min(dp, ceil_to(max(d, 1), MIRROR_QUANTUM))


def quantize_sym_int8(x: torch.Tensor, *, block: int | None = None):
    """Symmetric int8 quantization of (n, d) rows in feature-axis blocks:
    (q (n, d) int8, scale (n, d/block) f32) with scale = max|x| / 127 per
    block, floored at 1e-30. ``block=None`` is one block per row."""
    x = x.to(torch.float32)
    n, d = x.shape
    if block is None:
        block = d
    if d % block:
        raise ValueError(f"block {block} does not divide feature dim {d}")
    xb = x.reshape(n, d // block, block)
    scale = (xb.abs().amax(dim=2) / 127.0).clamp_min(_EPS)
    q = torch.round(xb / scale[:, :, None]).clamp(-127, 127)
    return q.reshape(n, d).to(torch.int8), scale


class QuantizedStore(NamedTuple):
    """Quantized mirror of a feature array. ``data``'s dtype is the mode:
    int8 rows with per-row f32 scales, or bf16 rows with all-ones scales
    (kept so both modes share one epilogue formula). ``x2`` holds the
    squared norms of the STORED rows, not of the fp32 originals."""

    data: torch.Tensor    # (cap, w) int8 | bfloat16 stored rows
    scale: torch.Tensor   # (cap,) f32 per-row dequant scale (ones: bf16)
    x2: torch.Tensor      # (cap,) f32 squared norms of the stored rows

    @property
    def mode(self) -> str:
        return "int8" if self.data.dtype == torch.int8 else "bf16"


def quantize_corpus(x: torch.Tensor, mode: str,
                    width: int | None = None) -> QuantizedStore:
    """Quantize feature rows (n, dp) into a QuantizedStore on x's device.
    ``width`` (see ``mirror_width``) keeps only the leading ``width``
    columns; the columns dropped must be zero on rows whose distances
    matter (true of layout.pad_features padding)."""
    x = x.to(torch.float32)
    if width is not None and width < x.shape[1]:
        x = x[:, :width]
    if mode == "int8":
        q, scale = quantize_sym_int8(x)
        scale = scale[:, 0]
        qf = q.to(torch.float32)
        x2 = (scale * scale) * (qf * qf).sum(dim=1)
        return QuantizedStore(q.contiguous(), scale.contiguous(), x2)
    if mode == "bf16":
        b = x.to(torch.bfloat16)
        bf = b.to(torch.float32)
        return QuantizedStore(
            b.contiguous(),
            torch.ones((x.shape[0],), dtype=torch.float32, device=x.device),
            (bf * bf).sum(dim=1))
    raise ValueError(f"unknown quantization mode {mode!r} (int8 | bf16)")


def dequantize(qs: QuantizedStore) -> torch.Tensor:
    """Stored rows back to f32: the values the quantized kernels see."""
    return qs.data.to(torch.float32) * qs.scale[:, None]


def update_rows(qs: QuantizedStore, rows: torch.Tensor,
                x_new: torch.Tensor) -> QuantizedStore:
    """Scatter-quantize ``x_new`` (m, dp) into a copy of the store at
    ``rows`` (m,), at the mirror's width; rows outside [0, cap) (-1:
    padding) are dropped."""
    upd = quantize_corpus(x_new, qs.mode, width=qs.data.shape[1])
    rows = torch.as_tensor(rows, device=qs.data.device).long()
    keep = (rows >= 0) & (rows < qs.data.shape[0])
    tgt = rows[keep]
    out = QuantizedStore(qs.data.clone(), qs.scale.clone(), qs.x2.clone())
    out.data[tgt] = upd.data[keep]
    out.scale[tgt] = upd.scale[keep]
    out.x2[tgt] = upd.x2[keep]
    return out


def grow(qs: QuantizedStore, new_cap: int, fill: float) -> QuantizedStore:
    """Pad to ``new_cap`` rows holding the quantized form of the fp32
    store's ``fill`` coordinates (far-away rows, masked everywhere)."""
    cap, w = qs.data.shape
    if new_cap <= cap:
        return qs
    pad = quantize_corpus(
        torch.full((new_cap - cap, w), fill, dtype=torch.float32,
                   device=qs.data.device), qs.mode)
    return QuantizedStore(torch.cat([qs.data, pad.data]),
                          torch.cat([qs.scale, pad.scale]),
                          torch.cat([qs.x2, pad.x2]))
