"""Gradient compression building blocks (src/repro/train/compression.py),
both with error feedback so the quantization noise is carried instead of
lost:

  * the int8 error-feedback accumulator: gradient-accumulation buffers
    held in int8 + per-block fp32 scales, the residual re-applied at the
    next microbatch;
  * ``compressed_psum``: a cross-replica gradient sum in which each
    shard's contribution (grad + residual) is quantized to int8 with
    per-block scales and dequantized, the shard keeping what int8 could
    not carry as its next residual. The wire payload would be the int8
    tensor (1 B an element + 4 B a block against 4 B an element:
    ``compression_ratio``); the sum itself is of the dequantized blocks.
    The port's ``ShardMesh`` runs every shard from one host, so this
    takes each shard's gradient and residual as lists (as
    ``fetch_rows_a2a`` takes each shard's block) and sums through
    ``ShardMesh.psum``.

Quantization: symmetric per-block int8 over the flattened tensor (block =
``block`` consecutive elements), scale = max|x| / 127, the shared
quantizer of core/quantize.py applied per row of the (n_blocks, block)
buffer.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.quantize import quantize_sym_int8

BLOCK = 256


def _pad_flat(x: torch.Tensor, block: int) -> tuple[torch.Tensor, int]:
    flat = x.reshape(-1)
    pad = (-flat.shape[0]) % block
    if pad:
        flat = F.pad(flat, (0, pad))
    return flat, pad


def quantize_int8(x: torch.Tensor, block: int = BLOCK):
    """x (any shape) -> (q int8 (nb, block), scales f32 (nb, 1), meta)."""
    flat, pad = _pad_flat(x.to(torch.float32), block)
    q, scale = quantize_sym_int8(flat.reshape(-1, block))
    return q, scale, (tuple(x.shape), pad)


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor, meta
                    ) -> torch.Tensor:
    shape, pad = meta
    flat = (q.to(torch.float32) * scale).reshape(-1)
    if pad:
        flat = flat[:-pad]
    return flat.reshape(shape)


def ef_accumulate(acc_q, acc_scale, residual, grad, block: int = BLOCK):
    """Error-feedback int8 accumulation: acc += grad, acc stored int8.

    Returns (new_acc_q, new_acc_scale, new_residual). acc reconstruction =
    dequant(acc_q, acc_scale); residual carries what int8 couldn't.
    """
    meta = (tuple(grad.shape), (-grad.numel()) % block)
    acc = dequantize_int8(acc_q, acc_scale, meta) if acc_q is not None \
        else 0.0
    target = acc + grad.to(torch.float32) + residual
    q, s, _ = quantize_int8(target, block)
    recon = dequantize_int8(q, s, meta)
    return q, s, target - recon


def compressed_psum(mesh, grads, residuals, block: int = BLOCK):
    """Error-feedback int8 all-reduce over the mesh's shards: ``grads``
    and ``residuals`` hold one tensor per shard (on its device). Returns
    (the sum of the shards' dequantized contributions, on devices[0] as
    ``ShardMesh.psum`` gives it; the new residuals, one per shard)."""
    if len(grads) != mesh.size or len(residuals) != mesh.size:
        raise ValueError(f"{len(grads)} gradients and {len(residuals)} "
                         f"residuals for {mesh.size} shards")
    recons, new_residuals = [], []
    for g, r in zip(grads, residuals):
        target = g.to(torch.float32) + r
        q, s, meta = quantize_int8(target, block)
        recon = dequantize_int8(q, s, meta)
        recons.append(recon)
        new_residuals.append(target - recon)
    return mesh.psum(recons), new_residuals


def compression_ratio(x_bytes: int, block: int = BLOCK) -> float:
    """Wire bytes ratio of int8+scales vs f32."""
    elems = x_bytes / 4
    comp = elems * 1 + (elems / block) * 4
    return comp / x_bytes
