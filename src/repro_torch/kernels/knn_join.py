"""Wrappers of the fused local join's two CUDA kernels.

* ``knn_join_dists_cuda`` replaces ``knn_join_dists_blocked``
  (src/repro/kernels/knn_join.py:82, body ``_join_dists_kernel`` :49). It
  takes the ids and the base rows and gathers in-kernel, so the (n, C, dp)
  gathered copy the TPU kernel takes as input (n*C*dp*4 bytes, 5 GB on the
  card at 70000 x 896, C = 20) is never made. Bound on this card: fp32
  operations (the 190 dot products of 896 it computes per row at C = 20),
  fed from shared memory; one block per row computes the rows' Gram on
  register-tiled 4 x 4 tiles of its upper triangle, the features split
  over 8 lanes (4 or 2 above C 40) and summed by shuffles, the rows
  gathered by ``cp.async`` into a 3-stage ring (any dp). Above C 64 one
  block of 256 threads a row compacts the row's valid slots (new first),
  gathers each once and computes only the cross terms the mask can keep
  (new x valid, 8 x 8 tiles of 8 lanes each); where the row's rows and
  cross terms do not fit a block's shared memory (C about 320 with half
  the slots new), the same kernel stages 96 rows a round and writes the
  distances straight out, its slot maps in a scratch allocated here, a
  slice for each block of a grid of at most ``JOIN_SCRATCH_BLOCKS_PER_SM``
  blocks an SM that walks the rows.
* ``knn_join_select_cuda`` replaces ``knn_join_select_blocked``
  (knn_join.py:152, body ``_join_select_kernel`` :125). Bound: bytes (8 in
  per entry, 8 out per winner). A radix select, not a sort of the row: one
  warp per row up to a padded W of 1024 (one block of 256 threads above),
  the row read once into registers (above a padded 8192, a block of 256
  threads per row reads the row once into shared memory as 32-bit keys,
  up to 110 KB of keys and winners; wider rows are streamed from device
  memory once a pass, and the winners' words go to a scratch of (n, cap)
  words where more than ``SELECT_SMEM_WORDS`` of them could win); unless
  every survivor of the prefilter wins, four 8-bit histogram passes find
  the c-th smallest key,
  and only the c winners are sorted by (distance bits, position), so ties
  keep the lowest position.

Both check device, dtype, shape and contiguity, allocate their outputs
with ``torch.empty``, launch on the current stream, raise on a non-zero
launch code, and count their launches in ``_lib.LAUNCHES``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _lib

SELECT_SMEM_WORDS = 8192  # kStreamSmemWords in csrc/knn_kernels.cu
JOIN_SCRATCH_BLOCKS_PER_SM = 2   # the wide join's grid where it needs scratch


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int,
           device: torch.device) -> None:
    if t.device != device or t.device.type != "cuda":
        raise ValueError(f"{name} must lie on {device}, a CUDA device; "
                         f"got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}; got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dims; got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def knn_join_dists_cuda(
    x: torch.Tensor, x2: torch.Tensor, ids: torch.Tensor, cn: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """(N, dp) f32, (N,) f32, (n, C) i32 -> (n, C, C) f32, (n,) i32.
    Ids outside [0, N) are invalid slots."""
    dev = x.device
    _check(x, "x", torch.float32, 2, dev)
    _check(x2, "x2", torch.float32, 1, dev)
    _check(ids, "ids", torch.int32, 2, dev)
    big_n, dp = x.shape
    n, c = ids.shape
    if x2.shape[0] != big_n:
        raise ValueError(f"x2 has {x2.shape[0]} rows, x has {big_n}")
    if c < 1:
        raise ValueError(f"C must be >= 1; got {c}")
    od = torch.empty((n, c, c), dtype=torch.float32, device=dev)
    ev = torch.empty((n,), dtype=torch.int32, device=dev)
    if n == 0:
        return od, ev
    # the wide kernel's panels: a slice of slot maps for each block of a
    # grid that walks the rows
    per = _lib.lib().knn_join_scratch_bytes(c, int(cn))
    scratch, blocks = None, 0
    if per:
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        blocks = min(n, JOIN_SCRATCH_BLOCKS_PER_SM * sms)
        scratch = torch.empty((blocks * per,), dtype=torch.uint8, device=dev)
    code = _lib.lib().knn_join_dists_launch(
        x.data_ptr(), x2.data_ptr(), ids.data_ptr(), od.data_ptr(),
        ev.data_ptr(), None if scratch is None else scratch.data_ptr(),
        blocks, big_n, n, c, dp, int(cn),
        torch.cuda.current_stream(dev).cuda_stream)
    _lib.check(code, "knn_join_dists")
    _lib.LAUNCHES["knn_join_dists"] += 1
    return od, ev


def knn_join_select_cuda(
    gd: torch.Tensor, gi: torch.Tensor, kth: torch.Tensor, c: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """(n, W) f32, (n, W) i32, (n,) f32 -> (n, c) f32, (n, c) i32."""
    dev = gd.device
    _check(gd, "gd", torch.float32, 2, dev)
    _check(gi, "gi", torch.int32, 2, dev)
    _check(kth, "kth", torch.float32, 1, dev)
    n, w = gd.shape
    if gi.shape != gd.shape or kth.shape[0] != n:
        raise ValueError(f"shapes disagree: gd {tuple(gd.shape)}, "
                         f"gi {tuple(gi.shape)}, kth {tuple(kth.shape)}")
    if c < 1:
        raise ValueError(f"c must be >= 1; got {c}")
    od = torch.empty((n, c), dtype=torch.float32, device=dev)
    oi = torch.empty((n, c), dtype=torch.int32, device=dev)
    if n == 0:
        return od, oi
    # the winners' sort: the next power of two of min(c, W) words a row
    cap = 1 << max(min(c, w) - 1, 0).bit_length()
    scratch = (torch.empty((n, cap), dtype=torch.int64, device=dev)
               if cap > SELECT_SMEM_WORDS else None)
    code = _lib.lib().knn_join_select_launch(
        gd.data_ptr(), gi.data_ptr(), kth.data_ptr(), od.data_ptr(),
        oi.data_ptr(), None if scratch is None else scratch.data_ptr(), n, w,
        int(c), torch.cuda.current_stream(dev).cuda_stream)
    _lib.check(code, "knn_join_select")
    _lib.LAUNCHES["knn_join_select"] += 1
    return od, oi
