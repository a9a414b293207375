"""Dispatch of the port's kernels, by the device of the tensors.

* A tensor on the CPU goes to the plain version in ``ref.py``.
* A tensor on a CUDA device goes to the hand-written kernel, or the call
  raises: there is no fallback to the plain version on a card.
* ``backend="ref"`` forces the plain version on any device. Tests and the
  comparison phase of ``chip_smoke.py`` use it.
* A tensor on "meta" (the dry-run, ``launch/dryrun.py``) stands for the
  card: nothing runs there, and the plain version gives the output's
  shapes.

Under the op-level cost counter (``launch/op_cost.py``, reached through
``core/cost.py``) each call charges its kernel's cost formula, a
function of its shapes alone (the ``_*_cost`` functions below), and the
aten ops under it, the plain version's or the wrapper's, are charged
nothing: a call costs the same on the CPU, on the card and on "meta".
These are not ``chip_smoke.py``'s kernel bounds, which count what the
call's data needs and a shape cannot tell. Where they differ:

* the joins: every (C, C) pair of each row's tile and every gathered
  row here; the valid unordered pairs and the corpus read once there;
* the search tiles: every (nq, W) candidate row here; the valid
  candidates' products and each distinct row read once there;
* ``pairwise_sq_l2``: 2 m n d here; the norms' 2 (m + n) d added there;
* the select, merge, compaction and row forms: their bytes only here
  (the row forms' padded rows included); their compares added there,
  and the row forms' valid rows only.

The attention's formula is the same in both.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import flash_attention_cuda
from repro_torch.kernels.knn_join import (
    knn_join_dists_cuda,
    knn_join_select_cuda,
)
from repro_torch.kernels.knn_merge import (
    knn_compact_cuda,
    knn_compact_rows_cuda,
    knn_merge_cuda,
    knn_merge_rows_cuda,
)
from repro_torch.kernels.knn_search import knn_search_dists_cuda
from repro_torch.kernels.l2_blocked import pairwise_sq_l2_cuda
from repro_torch.kernels.l2_quant import (
    knn_join_dists_bf16_cuda,
    knn_join_dists_q8_cuda,
    knn_search_dists_bf16_cuda,
    knn_search_dists_q8_cuda,
)
from repro_torch.core import cost

BACKENDS = ("auto", "ref")


def _plain(t: torch.Tensor, backend: str) -> bool:
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected {BACKENDS}")
    return backend == "ref" or t.device.type == "cpu"


def _contiguous(out):
    if isinstance(out, torch.Tensor):
        return out.contiguous()
    return type(out)(_contiguous(o) for o in out)


def _call(name: str, t: torch.Tensor, backend: str, plain, kernel, formula,
          meta=None):
    """``plain()`` where ``_plain`` says so, else ``kernel()``. On "meta"
    (but with ``backend="ref"``) ``meta()``, by default the plain
    version's outputs laid out as the kernel's (contiguous), so the ops
    after the call see the card's strides. Under the cost counter,
    ``formula()`` (flops, bytes, dtype class) is charged once and the
    call's own ops nothing (``core/cost.py``)."""
    use_plain = _plain(t, backend)

    def run():
        if t.device.type == "meta" and not use_plain:
            return meta() if meta is not None else _contiguous(plain())
        return plain() if use_plain else kernel()
    return cost.kernel_call(name, formula, run)


# -- the kernels' cost formulas: (flops, bytes, dtype class of the flops)

def _join_cost(rows, ids, extra: int, dtype: str):
    """A join of (n, C) ids over (N, w) rows of ``rows``' dtype: the
    (n, C, C) Gram, 2 w a pair; each gathered row read once with its
    ``extra`` bytes (norm, scale), the ids, the distances and counts
    written."""
    n, c = ids.shape
    w = rows.shape[1]
    return (2 * w * n * c * c,
            n * c * (w * rows.element_size() + extra + 4)
            + 4 * n * c * c + 4 * n, dtype)


def _search_cost(q, ids, row_bytes: int, dtype: str):
    """(nq, W) candidates at width w: 2 w a candidate; each candidate row
    (``row_bytes`` with its norm / scale) and each query read once, the
    ids read and the distances written."""
    nq, w_ = ids.shape
    return (2 * q.shape[1] * nq * w_,
            (nq * w_ + nq) * row_bytes + 8 * nq * w_, dtype)


def _select_cost(gd, c: int):
    n, w = gd.shape
    return 0, 8 * n * w + 4 * n + 8 * n * c, "fp32"


def _merge_cost(cd, cand):
    n, k = cd.shape
    return 0, 16 * n * k + 8 * cand.shape[0] * cand.shape[1] + 4 * n, "fp32"


def _rows_cost(cd, rows, per_row: int):
    """A row form: the (n, k) lists read and written whole, and
    ``per_row`` bytes for each of the (f,) rows."""
    n, k = cd.shape
    return 0, 16 * n * k + rows.shape[0] * per_row, "fp32"


def _pairwise_cost(a, b, out_bytes: int = 0):
    (m, d), n = a.shape, b.shape[0]
    return 2 * m * n * d, 4 * (m * d + n * d + m * n) + out_bytes, "fp32"


def visible_pairs(lq: int, lk: int, causal=True, window=None,
                  q_offset: int = 0) -> int:
    """The (q, k) pairs the attention's masks leave visible, from the
    positions alone (q[0] at ``q_offset``)."""
    qpos = np.arange(lq, dtype=np.int64) + q_offset
    hi = np.minimum(qpos, lk - 1) if causal else np.full(lq, lk - 1)
    lo = np.maximum(qpos - window + 1, 0) if window is not None \
        else np.zeros(lq, dtype=np.int64)
    return int(np.clip(hi - lo + 1, 0, None).sum())


def _attention_cost(q, k, v, causal, window, q_offset):
    """2 (Dq + Dv) a visible (q, k) pair and head; q, k, v read once and
    the output written once."""
    b, lq, h, dq = q.shape
    dv = v.shape[3]
    pairs = visible_pairs(lq, k.shape[1], causal, window, q_offset)
    size = q.element_size()
    return (2 * (dq + dv) * pairs * b * h,
            (q.numel() + k.numel() + v.numel() + b * lq * h * dv) * size,
            cost.dtype_class(q.dtype))


def knn_join_dists(x, x2, ids, cn: int, *, backend: str = "auto"):
    """(N, dp) rows, (N,) norms, (n, C) ids -> (n, C, C) pair distances,
    (n,) valid unordered pair counts."""
    return _call("knn_join_dists", x, backend,
                 lambda: ref.knn_join_dists(x, x2, ids, cn),
                 lambda: knn_join_dists_cuda(x, x2, ids, cn),
                 lambda: _join_cost(x, ids, 4, "fp32"))


def knn_join_select(gd, gi, kth, c: int, *, backend: str = "auto"):
    """(n, W) dists/ids, (n,) kth -> best c per row, (+inf, -1) fill."""
    return _call("knn_join_select", gd, backend,
                 lambda: ref.knn_join_select(gd, gi, kth, c),
                 lambda: knn_join_select_cuda(gd, gi, kth, c),
                 lambda: _select_cost(gd, c))


def knn_merge(cur_dist, cur_idx, cand_dist, cand_idx, *,
              backend: str = "auto"):
    """Merge (n, c) candidates into sorted (n, k) lists -> (dist, idx,
    accepted)."""
    return _call("knn_merge", cur_dist, backend,
                 lambda: ref.knn_merge(cur_dist, cur_idx, cand_dist,
                                       cand_idx),
                 lambda: knn_merge_cuda(cur_dist, cur_idx, cand_dist,
                                        cand_idx),
                 lambda: _merge_cost(cur_dist, cand_dist))


def knn_merge_rows(cur_dist, cur_idx, rows, cand_dist, cand_idx, *,
                   backend: str = "auto"):
    """Merge (f, c) candidates into list rows ``rows`` (f,) (-1 = padding)
    -> full (n, k) copies of the lists, (f,) accepted (0 on padding)."""
    return _call("knn_merge_rows", cur_dist, backend,
                 lambda: ref.knn_merge_rows(cur_dist, cur_idx, rows,
                                            cand_dist, cand_idx),
                 lambda: knn_merge_rows_cuda(cur_dist, cur_idx, rows,
                                             cand_dist, cand_idx),
                 lambda: _rows_cost(cur_dist, rows,
                                    8 * cand_dist.shape[1] + 8))


def knn_compact(cur_dist, cur_idx, drop, *, backend: str = "auto"):
    """Drop the (n, k) masked entries; survivors packed ascending, freed
    slots (+inf, -1) -> (dist, idx, removed (n,))."""
    n, k = cur_dist.shape
    return _call("knn_compact", cur_dist, backend,
                 lambda: ref.knn_compact(cur_dist, cur_idx, drop),
                 lambda: knn_compact_cuda(cur_dist, cur_idx, drop),
                 lambda: (0, 17 * n * k + 4 * n, "fp32"))


def knn_compact_rows(cur_dist, cur_idx, rows, drop, *, backend: str = "auto"):
    """``knn_compact`` of list rows ``rows`` (f,) under the (f, k) mask ->
    full (n, k) copies of the lists, (f,) removed (0 on padding)."""
    return _call("knn_compact_rows", cur_dist, backend,
                 lambda: ref.knn_compact_rows(cur_dist, cur_idx, rows, drop),
                 lambda: knn_compact_rows_cuda(cur_dist, cur_idx, rows,
                                               drop),
                 lambda: _rows_cost(cur_dist, rows, drop.shape[1] + 8))


def pairwise_sq_l2(a, b, *, backend: str = "auto"):
    """(M, D) x (N, D) -> (M, N) squared l2, clamped at 0."""
    return _call("pairwise_sq_l2", a, backend,
                 lambda: ref.pairwise_sq_l2(a, b),
                 lambda: pairwise_sq_l2_cuda(a, b),
                 lambda: _pairwise_cost(a, b))


def centroid_assign(q, q2, cent, c2, *, t: int = 1, backend: str = "auto"):
    """Top-``t`` nearest centroids per row: (m, dp) x (c, dp) -> (dist (m,
    t) ascending, idx (m, t) i32), ties to the lowest centroid id. The
    tile is the ``pairwise_sq_l2`` kernel (its plain version for CPU
    tensors, which takes the cached norms); the top-t is a stable sort."""
    return _call("pairwise_sq_l2", q, backend,
                 lambda: ref.centroid_assign(q, q2, cent, c2, t),
                 lambda: ref.top_t(pairwise_sq_l2_cuda(
                     q.contiguous(), cent.contiguous()), t),
                 lambda: _pairwise_cost(q, cent, 8 * q.shape[0] * t),
                 meta=lambda: ref.top_t(ref.pairwise_sq_l2(q, cent), t))


def knn_search_dists(q, q2, x, x2, ids, *, backend: str = "auto"):
    """(nq, dp) queries and norms against the (N, dp) rows named by (nq, W)
    ids -> (nq, W) squared l2, +inf where the id is invalid."""
    return _call("knn_search_dists", q, backend,
                 lambda: ref.knn_search_dists(q, q2, x, x2, ids),
                 lambda: knn_search_dists_cuda(q, q2, x, x2, ids),
                 lambda: _search_cost(q, ids, 4 * (q.shape[1] + 1), "fp32"))


def knn_search_dists_q8(qq, qscale, q2, data, scale, x2, ids, *,
                        backend: str = "auto"):
    """(nq, w) int8 queries with their scales and norms against the int8
    mirror rows named by (nq, W) ids -> (nq, W) quantized squared l2,
    +inf where the id is invalid."""
    return _call("knn_search_dists_q8", qq, backend,
                 lambda: ref.knn_search_dists_q8(qq, qscale, q2, data, scale,
                                                 x2, ids),
                 lambda: knn_search_dists_q8_cuda(qq, qscale, q2, data,
                                                  scale, x2, ids),
                 lambda: _search_cost(qq, ids, qq.shape[1] + 8, "int8"))


def knn_search_dists_bf16(q, q2, data, x2, ids, *, backend: str = "auto"):
    """The bf16 twin of ``knn_search_dists_q8`` (no scales)."""
    return _call("knn_search_dists_bf16", q, backend,
                 lambda: ref.knn_search_dists_bf16(q, q2, data, x2, ids),
                 lambda: knn_search_dists_bf16_cuda(q, q2, data, x2, ids),
                 lambda: _search_cost(q, ids, 2 * q.shape[1] + 4, "bf16"))


def knn_join_dists_q8(data, scale, x2, ids, cn: int, *,
                      backend: str = "auto"):
    """int8 mirror (N, w) with scales and norms, (n, C) ids -> (n, C, C)
    quantized pair distances, (n,) valid unordered pair counts."""
    return _call("knn_join_dists_q8", data, backend,
                 lambda: ref.knn_join_dists_q8(data, scale, x2, ids, cn),
                 lambda: knn_join_dists_q8_cuda(data, scale, x2, ids, cn),
                 lambda: _join_cost(data, ids, 8, "int8"))


def knn_join_dists_bf16(data, x2, ids, cn: int, *, backend: str = "auto"):
    """The bf16 twin of ``knn_join_dists_q8`` (no scales)."""
    return _call("knn_join_dists_bf16", data, backend,
                 lambda: ref.knn_join_dists_bf16(data, x2, ids, cn),
                 lambda: knn_join_dists_bf16_cuda(data, x2, ids, cn),
                 lambda: _join_cost(data, ids, 4, "bf16"))


def attention(q, k, v, *, causal: bool = True, window: int | None = None,
              softcap: float | None = None, scale: float | None = None,
              q_offset: int = 0, backend: str = "auto"):
    """q (B, Lq, H, Dq), k (B, Lk, Hkv, Dq), v (B, Lk, Hkv, Dv) -> (B, Lq,
    H, Dv) in q's dtype: online-softmax attention, fp32 inside, causal /
    window / softcap masks from positions (q[0] at ``q_offset``), GQA
    folded. The kernel writes 0 on rows that see no key; the plain version
    gives NaN there, as JAX's oracle does."""
    kw = dict(causal=causal, window=window, softcap=softcap, scale=scale,
              q_offset=q_offset)
    return _call("flash_attention", q, backend,
                 lambda: ref.attention(q, k, v, **kw),
                 lambda: flash_attention_cuda(q, k, v, **kw),
                 lambda: _attention_cost(q, k, v, causal, window, q_offset))
