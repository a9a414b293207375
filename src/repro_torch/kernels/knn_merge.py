"""Wrappers of the bounded neighbor-list kernels (csrc/knn_kernels.cu).

* ``knn_merge_cuda`` replaces ``knn_merge_blocked`` (src/repro/kernels/
  knn_merge.py:156, body ``_merge_kernel`` :30);
* ``knn_compact_cuda`` replaces ``knn_compact_blocked`` (:108, body
  ``_compact_kernel`` :72), the tombstone purge;
* ``knn_merge_rows_cuda`` / ``knn_compact_rows_cuda`` replace
  ``knn_merge_rows_blocked`` / ``knn_compact_rows_blocked`` (:210, :237),
  the online store's frontier forms. The kernel reads the listed rows of
  the full (n, k) lists itself and writes them into a copy of the lists
  made here (one device copy of (n, k): the store keeps the JAX package's
  value semantics), so no gather or scatter runs around it. ``rows`` must
  be unique, as in JAX; that is not checked.

Bound on this card: bytes (8 per list and candidate entry in, 8 per list
entry out, 1 per drop flag). A merge is one row of the join select's radix
select over the pool [list | candidates], a warp per row up to a pool of
128 and a block above, after a dedup through a shared-memory hash table of
the pool's ids; above a pool of ``MERGE_MAX_POOL`` (the widest a block
holds in registers) a block holds the row's pool, table and keys in shared
memory (the online store's k + k^2 = 8372 at k 91) or, past what it holds,
in a scratch allocated here, a slice for each block of a grid that walks
the rows: any pool runs, in one launch. A compaction is one row of the
same select with c = k and the keep mask as its prefilter, through the
same dispatch. Same checks, allocation, stream and launch count as the
join wrappers (kernels/knn_join.py).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _lib
from repro_torch.kernels.knn_join import _check

MERGE_MAX_POOL = 8192    # kMergeMaxPool: the widest pool in registers
COMPACT_MAX_K = 8192     # kSelectMaxPadded: the widest row in registers
SCRATCH_BLOCKS_PER_SM = 4   # the wide merge's grid where it needs scratch


def _merge_scratch(dev: torch.device, k: int, c: int, rows: int):
    """(scratch or None, blocks): the wide merge's per-block memory past
    what shared memory holds, for a grid of at most SCRATCH_BLOCKS_PER_SM
    blocks an SM that walks ``rows`` rows."""
    per = _lib.lib().knn_merge_scratch_bytes(k, c)
    if per == 0:
        return None, 0
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    blocks = min(rows, SCRATCH_BLOCKS_PER_SM * sms)
    return torch.empty((blocks * per,), dtype=torch.uint8, device=dev), blocks


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
    if k < 1:
        raise ValueError(f"need 1 <= k; got k={k}")
    od = torch.empty((n, k), dtype=torch.float32, device=dev)
    oi = torch.empty((n, k), dtype=torch.int32, device=dev)
    upd = torch.empty((n,), dtype=torch.int32, device=dev)
    if n == 0:
        return od, oi, upd
    scratch, blocks = _merge_scratch(dev, k, c, n)
    code = _lib.lib().knn_merge_launch(
        cur_dist.data_ptr(), cur_idx.data_ptr(), cand_dist.data_ptr(),
        cand_idx.data_ptr(), od.data_ptr(), oi.data_ptr(), upd.data_ptr(),
        None if scratch is None else scratch.data_ptr(), blocks,
        n, k, c, torch.cuda.current_stream(dev).cuda_stream)
    _lib.check(code, "knn_merge")
    _lib.LAUNCHES["knn_merge"] += 1
    return od, oi, upd


def _check_lists(cur_dist, cur_idx):
    dev = cur_dist.device
    _check(cur_dist, "cur_dist", torch.float32, 2, dev)
    _check(cur_idx, "cur_idx", torch.int32, 2, dev)
    if cur_idx.shape != cur_dist.shape:
        raise ValueError("list shapes disagree")
    n, k = cur_dist.shape
    return dev, n, k


def _check_rows(rows, dev, f: int) -> None:
    _check(rows, "rows", torch.int32, 1, dev)
    if rows.shape[0] != f:
        raise ValueError("rows and the per-row inputs disagree")


def knn_merge_rows_cuda(
    cur_dist: torch.Tensor, cur_idx: torch.Tensor, rows: torch.Tensor,
    cand_dist: torch.Tensor, cand_idx: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(n, k) lists, (f,) i32 rows (-1 pad), (f, c) candidates -> (n, k)
    f32 / i32 copies with the listed rows merged, (f,) i32 accepted."""
    dev, n, k = _check_lists(cur_dist, cur_idx)
    _check(cand_dist, "cand_dist", torch.float32, 2, dev)
    _check(cand_idx, "cand_idx", torch.int32, 2, dev)
    f, c = cand_dist.shape
    _check_rows(rows, dev, f)
    if cand_idx.shape != (f, c):
        raise ValueError("candidate shapes disagree")
    if k < 1:
        raise ValueError(f"need 1 <= k; got k={k}")
    od, oi = cur_dist.clone(), cur_idx.clone()
    upd = torch.zeros((f,), dtype=torch.int32, device=dev)
    if f == 0:
        return od, oi, upd
    scratch, blocks = _merge_scratch(dev, k, c, f)
    code = _lib.lib().knn_merge_rows_launch(
        cur_dist.data_ptr(), cur_idx.data_ptr(), rows.data_ptr(),
        cand_dist.data_ptr(), cand_idx.data_ptr(), od.data_ptr(),
        oi.data_ptr(), upd.data_ptr(),
        None if scratch is None else scratch.data_ptr(), blocks, n, f, k, c,
        torch.cuda.current_stream(dev).cuda_stream)
    _lib.check(code, "knn_merge_rows")
    _lib.LAUNCHES["knn_merge_rows"] += 1
    return od, oi, upd


def knn_compact_cuda(
    cur_dist: torch.Tensor, cur_idx: torch.Tensor, drop: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(n, k) f32 / i32 lists, (n, k) bool drop mask -> (n, k) f32, (n, k)
    i32, (n,) i32 removed counts."""
    dev, n, k = _check_lists(cur_dist, cur_idx)
    _check(drop, "drop", torch.bool, 2, dev)
    if drop.shape != (n, k):
        raise ValueError("drop and list shapes disagree")
    if k > COMPACT_MAX_K:
        raise ValueError(f"need k <= {COMPACT_MAX_K}; got k={k}")
    od = torch.empty((n, k), dtype=torch.float32, device=dev)
    oi = torch.empty((n, k), dtype=torch.int32, device=dev)
    removed = torch.empty((n,), dtype=torch.int32, device=dev)
    if n == 0 or k == 0:
        return od, oi, removed.zero_()
    code = _lib.lib().knn_compact_launch(
        cur_dist.data_ptr(), cur_idx.data_ptr(), drop.data_ptr(),
        od.data_ptr(), oi.data_ptr(), removed.data_ptr(), n, k,
        torch.cuda.current_stream(dev).cuda_stream)
    _lib.check(code, "knn_compact")
    _lib.LAUNCHES["knn_compact"] += 1
    return od, oi, removed


def knn_compact_rows_cuda(
    cur_dist: torch.Tensor, cur_idx: torch.Tensor, rows: torch.Tensor,
    drop: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(n, k) lists, (f,) i32 rows (-1 pad), (f, k) bool drop mask -> (n,
    k) f32 / i32 copies with the listed rows compacted, (f,) i32 removed."""
    dev, n, k = _check_lists(cur_dist, cur_idx)
    _check(drop, "drop", torch.bool, 2, dev)
    f = drop.shape[0]
    _check_rows(rows, dev, f)
    if drop.shape[1] != k:
        raise ValueError("drop and list shapes disagree")
    if k > COMPACT_MAX_K:
        raise ValueError(f"need k <= {COMPACT_MAX_K}; got k={k}")
    od, oi = cur_dist.clone(), cur_idx.clone()
    removed = torch.zeros((f,), dtype=torch.int32, device=dev)
    if f == 0 or k == 0:
        return od, oi, removed
    code = _lib.lib().knn_compact_rows_launch(
        cur_dist.data_ptr(), cur_idx.data_ptr(), rows.data_ptr(),
        drop.data_ptr(), od.data_ptr(), oi.data_ptr(), removed.data_ptr(),
        n, f, k, torch.cuda.current_stream(dev).cuda_stream)
    _lib.check(code, "knn_compact_rows")
    _lib.LAUNCHES["knn_compact_rows"] += 1
    return od, oi, removed
