"""Wrappers of the quantized scoring tiles' four CUDA kernels
(``csrc/quant_kernels.cu``), the first stage of the two-stage path.

* ``knn_search_dists_q8_cuda`` replaces ``knn_search_dists_q8_blocked``
  (src/repro/kernels/l2_quant.py:92) and ``knn_search_dists_bf16_cuda``
  replaces ``knn_search_dists_bf16_blocked`` (:137): the int8 and bf16
  twins of ``knn_search_dists``.
* ``knn_join_dists_q8_cuda`` replaces ``knn_join_dists_q8_blocked`` (:241)
  and ``knn_join_dists_bf16_cuda`` replaces ``knn_join_dists_bf16_blocked``
  (:279): the int8 and bf16 twins of ``knn_join_dists``.

Like the fp32 tiles they take the ids and the base mirror (data, scale,
x2 of core/quantize.py) and gather the rows in-kernel; an id outside
[0, N) is an invalid slot. Bound on this card: bytes (one quantized row
per valid candidate). Both search tiles are instances of the fp32 tile's
body (``csrc/search_tile.cuh``; int8: ``__dp4a`` int32 sums, bitwise
equal to the plain version); both joins run their Gram on the tensor cores
(``mma.sync``, s8 -> s32 and bf16 -> f32, one warp per row; above C 64
one warp per (set, set) piece of a row, sets of at most 32 slots), the
int8 one bitwise equal to its plain version. The kernels read rows in 16-byte
chunks, so each wrapper also requires the rows to start on 16-byte
boundaries: a row of a multiple of 16 bytes (16 int8 or 8 bf16 values;
the mirror's 32-column quantum gives that) in a tensor whose storage is
16-byte aligned. Every wrapper
checks device, dtype, shape, contiguity and that alignment and raises on
failure, allocates its outputs with ``torch.empty``, launches on the
current stream, raises on a non-zero launch code, and counts its launches
in ``_lib.LAUNCHES``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _lib
from repro_torch.kernels.knn_join import _check

SEARCH_MAX_ROW_BYTES = 48 * 1024   # kSearchMaxRowBytes in search_tile.cuh


def _check_rows(t: torch.Tensor, name: str) -> None:
    row_bytes = t.shape[1] * t.element_size()
    if row_bytes % 16 or t.data_ptr() % 16:
        raise ValueError(
            f"{name} rows must start on 16-byte boundaries: a row of a "
            f"multiple of 16 bytes in 16-byte aligned storage; got "
            f"{row_bytes}-byte rows at offset {t.data_ptr() % 16}")


def _check_search(q, x, ids, q_norms, x_norms, dtype):
    dev = q.device
    _check(q, "q", dtype, 2, dev)
    _check(x, "data", dtype, 2, dev)
    _check(ids, "ids", torch.int32, 2, dev)
    for name, t in (*q_norms, *x_norms):
        _check(t, name, torch.float32, 1, dev)
    nq, w = q.shape
    big_n = x.shape[0]
    if x.shape[1] != w or ids.shape[0] != nq \
            or any(t.shape[0] != nq for _, t in q_norms) \
            or any(t.shape[0] != big_n for _, t in x_norms):
        raise ValueError(
            f"shapes disagree: q {tuple(q.shape)}, data {tuple(x.shape)}, "
            f"ids {tuple(ids.shape)}, "
            + ", ".join(f"{n} {tuple(t.shape)}" for n, t in
                        (*q_norms, *x_norms)))
    if w * q.element_size() > SEARCH_MAX_ROW_BYTES:
        raise ValueError(f"rows of {w * q.element_size()} bytes exceed the "
                         f"kernel's {SEARCH_MAX_ROW_BYTES}")
    _check_rows(q, "q")
    _check_rows(x, "data")
    return nq, w, big_n, ids.shape[1]


def knn_search_dists_q8_cuda(
    qq: torch.Tensor, qscale: torch.Tensor, q2: torch.Tensor,
    data: torch.Tensor, scale: torch.Tensor, x2: torch.Tensor,
    ids: torch.Tensor,
) -> torch.Tensor:
    """(nq, w) i8 queries, (nq,) f32 scales and norms, (N, w) i8 mirror,
    (N,) f32 scales and norms, (nq, W) i32 ids -> (nq, W) f32."""
    nq, w, big_n, nw = _check_search(
        qq, data, ids, (("qscale", qscale), ("q2", q2)),
        (("scale", scale), ("x2", x2)), torch.int8)
    od = torch.empty((nq, nw), dtype=torch.float32, device=qq.device)
    if nq == 0 or nw == 0:
        return od
    code = _lib.lib().knn_search_dists_q8_launch(
        qq.data_ptr(), qscale.data_ptr(), q2.data_ptr(), data.data_ptr(),
        scale.data_ptr(), x2.data_ptr(), ids.data_ptr(), od.data_ptr(),
        big_n, nq, nw, w, torch.cuda.current_stream(qq.device).cuda_stream)
    _lib.check(code, "knn_search_dists_q8")
    _lib.LAUNCHES["knn_search_dists_q8"] += 1
    return od


def knn_search_dists_bf16_cuda(
    q: torch.Tensor, q2: torch.Tensor, data: torch.Tensor, x2: torch.Tensor,
    ids: torch.Tensor,
) -> torch.Tensor:
    """(nq, w) bf16 queries, (nq,) f32 norms, (N, w) bf16 mirror, (N,) f32
    norms, (nq, W) i32 ids -> (nq, W) f32."""
    nq, w, big_n, nw = _check_search(q, data, ids, (("q2", q2),),
                                     (("x2", x2),), torch.bfloat16)
    od = torch.empty((nq, nw), dtype=torch.float32, device=q.device)
    if nq == 0 or nw == 0:
        return od
    code = _lib.lib().knn_search_dists_bf16_launch(
        q.data_ptr(), q2.data_ptr(), data.data_ptr(), x2.data_ptr(),
        ids.data_ptr(), od.data_ptr(), big_n, nq, nw, w,
        torch.cuda.current_stream(q.device).cuda_stream)
    _lib.check(code, "knn_search_dists_bf16")
    _lib.LAUNCHES["knn_search_dists_bf16"] += 1
    return od


def _check_join(data, ids, norms, dtype):
    dev = data.device
    _check(data, "data", dtype, 2, dev)
    _check(ids, "ids", torch.int32, 2, dev)
    for name, t in norms:
        _check(t, name, torch.float32, 1, dev)
    big_n = data.shape[0]
    if any(t.shape[0] != big_n for _, t in norms):
        raise ValueError(f"data has {big_n} rows; " + ", ".join(
            f"{n} has {t.shape[0]}" for n, t in norms))
    n, c = ids.shape
    if c < 1:
        raise ValueError(f"C must be >= 1; got {c}")
    _check_rows(data, "data")
    od = torch.empty((n, c, c), dtype=torch.float32, device=dev)
    ev = torch.empty((n,), dtype=torch.int32, device=dev)
    return od, ev


def knn_join_dists_q8_cuda(
    data: torch.Tensor, scale: torch.Tensor, x2: torch.Tensor,
    ids: torch.Tensor, cn: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(N, w) i8 mirror, (N,) f32 scales and norms, (n, C) i32 ids ->
    (n, C, C) f32, (n,) i32."""
    od, ev = _check_join(data, ids, (("scale", scale), ("x2", x2)),
                         torch.int8)
    n, c = ids.shape
    if n == 0:
        return od, ev
    code = _lib.lib().knn_join_dists_q8_launch(
        data.data_ptr(), scale.data_ptr(), x2.data_ptr(), ids.data_ptr(),
        od.data_ptr(), ev.data_ptr(), data.shape[0], n, c, data.shape[1],
        int(cn), torch.cuda.current_stream(data.device).cuda_stream)
    _lib.check(code, "knn_join_dists_q8")
    _lib.LAUNCHES["knn_join_dists_q8"] += 1
    return od, ev


def knn_join_dists_bf16_cuda(
    data: torch.Tensor, x2: torch.Tensor, ids: torch.Tensor, cn: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(N, w) bf16 mirror, (N,) f32 norms, (n, C) i32 ids -> (n, C, C)
    f32, (n,) i32."""
    od, ev = _check_join(data, ids, (("x2", x2),), torch.bfloat16)
    n, c = ids.shape
    if n == 0:
        return od, ev
    code = _lib.lib().knn_join_dists_bf16_launch(
        data.data_ptr(), x2.data_ptr(), ids.data_ptr(), od.data_ptr(),
        ev.data_ptr(), data.shape[0], n, c, data.shape[1], int(cn),
        torch.cuda.current_stream(data.device).cuda_stream)
    _lib.check(code, "knn_join_dists_bf16")
    _lib.LAUNCHES["knn_join_dists_bf16"] += 1
    return od, ev
