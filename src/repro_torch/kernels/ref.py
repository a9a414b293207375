"""Plain PyTorch versions of the port's thirteen kernels, and the
difference-form oracle ``pairwise_sq_l2_diff``.

Each function computes exactly what its CUDA kernel in ``csrc/*.cu``
computes. The CPU tests hold them against the JAX package's oracles, and
``chip_smoke.py`` holds the kernels against them on the card. The wrappers in
``ops.py`` reach them only for tensors that lie on the CPU (or when a caller
asks for ``backend="ref"``).
"""
from __future__ import annotations

import math

import torch

BIG = float(torch.finfo(torch.float32).max)


def _join_ok(ids: torch.Tensor, cn: int) -> torch.Tensor:
    """Join validity: at least one "new" endpoint, distinct slots, both
    occupied, distinct node ids. (n, C) -> (n, C, C) bool."""
    c = ids.shape[1]
    slot = torch.arange(c, device=ids.device)
    ok = (slot[:, None] < cn) | (slot[None, :] < cn)
    ok &= slot[:, None] != slot[None, :]
    ok = ok[None]
    ok = ok & (ids[:, :, None] >= 0) & (ids[:, None, :] >= 0)
    ok &= ids[:, :, None] != ids[:, None, :]
    return ok


def knn_join_dists(
    x: torch.Tensor,     # (N, dp) f32 feature-padded points
    x2: torch.Tensor,    # (N,) f32 squared norms
    ids: torch.Tensor,   # (n, C) i32 candidate ids, -1 = invalid slot
    cn: int,             # width of the "new" candidate prefix
) -> tuple[torch.Tensor, torch.Tensor]:
    """Local-join pair-distance tensor. Gathers the candidate rows itself:
    id -1 is a zero row with a zero norm. Returns (dists (n, C, C) f32 with
    +inf on invalid pairs, evals (n,) i32 — valid unordered pairs)."""
    valid = ids >= 0
    safe = torch.where(valid, ids, 0).long()
    xg = x[safe].masked_fill_(~valid[:, :, None], 0.0)   # one (n, C, dp) copy
    x2g = torch.where(valid, x2[safe], 0.0)
    ab = torch.bmm(xg, xg.transpose(1, 2))
    dd = x2g[:, :, None] + x2g[:, None, :] - 2.0 * ab
    ok = _join_ok(ids, cn)
    out = torch.where(ok, dd.clamp_min(0.0), torch.inf)
    evals = (ok.sum(dim=(1, 2)) // 2).to(torch.int32)
    return out, evals


def knn_join_select(
    gd: torch.Tensor,    # (n, W) f32 gathered incoming pair distances
    gi: torch.Tensor,    # (n, W) i32 their candidate ids, -1 pad
    kth: torch.Tensor,   # (n,) f32 receiver k-th distance (prefilter)
    c: int,              # output width
) -> tuple[torch.Tensor, torch.Tensor]:
    """Entries with ``gi >= 0 & gd < kth`` survive; the c smallest, ties
    to the lowest input position, come back as (dist (n, c) ascending,
    idx (n, c)) with (+inf, -1) fill. A stable sort, not ``topk``, whose
    order among ties is unspecified."""
    n, w = gd.shape
    pool = torch.where((gi >= 0) & (gd < kth[:, None]), gd, BIG)
    if c > w:
        pool = torch.cat([pool, pool.new_full((n, c - w), BIG)], dim=1)
        gi = torch.cat([gi, gi.new_full((n, c - w), -1)], dim=1)
    d, pos = torch.sort(pool, dim=1, stable=True)
    d, pos = d[:, :c], pos[:, :c]
    i = torch.gather(gi, 1, pos)
    keep = d < BIG
    return torch.where(keep, d, torch.inf), torch.where(keep, i, -1)


def candidate_dups(cur_idx: torch.Tensor,
                   cand_idx: torch.Tensor) -> torch.Tensor:
    """(n, c) mask of candidates a merge drops: id < 0, already in the
    row's list, or a repeat of an EARLIER candidate (by position). The
    repeats come from a stable sort of each row's ids (equal ids keep
    their position order, so every copy after the first is a repeat):
    O(n c) memory, where an all-pairs compare would take (n, c, c), 27 GB
    at the online store's c = k^2 = 8281 over 400 rows."""
    dup = (cand_idx[:, :, None] == cur_idx[:, None, :]).any(-1)
    srt, order = torch.sort(cand_idx, dim=1, stable=True)
    rep = torch.zeros_like(srt, dtype=torch.bool)
    rep[:, 1:] = srt[:, 1:] == srt[:, :-1]
    earlier = torch.zeros_like(rep).scatter_(1, order, rep)
    return dup | earlier | (cand_idx < 0)


def knn_merge(
    cur_dist: torch.Tensor,   # (n, k) f32 ascending, +inf = empty
    cur_idx: torch.Tensor,    # (n, k) i32, -1 = empty
    cand_dist: torch.Tensor,  # (n, c) f32
    cand_idx: torch.Tensor,   # (n, c) i32, -1 = invalid
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Merge candidates into sorted k-lists, the merge kernel's contract:
    a candidate is dropped if its id is < 0, sits in the row's list, or
    repeats an EARLIER candidate (by position). The k smallest of
    [current | candidates] win, ties to the lowest pool position; a slot
    at the sentinel comes out (+inf, -1). Returns (dist, idx, accepted
    (n,) i32 — candidate picks below the sentinel)."""
    k = cur_dist.shape[1]
    pool_d = torch.cat([
        torch.where(torch.isinf(cur_dist), BIG, cur_dist),
        torch.where(candidate_dups(cur_idx, cand_idx), BIG, cand_dist),
    ], dim=1)
    pool_i = torch.cat([cur_idx, cand_idx], dim=1)
    d, pos = torch.sort(pool_d, dim=1, stable=True)
    d, pos = d[:, :k], pos[:, :k]
    i = torch.gather(pool_i, 1, pos)
    keep = d < BIG
    accepted = ((pos >= k) & keep).sum(dim=1).to(torch.int32)
    return torch.where(keep, d, torch.inf), torch.where(keep, i, -1), accepted


def knn_compact(
    cur_dist: torch.Tensor,   # (n, k) f32, +inf = empty (any order)
    cur_idx: torch.Tensor,    # (n, k) i32, -1 = empty
    drop: torch.Tensor,       # (n, k) bool: entries to remove
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Drop masked entries: the survivors (not dropped, id >= 0, finite
    distance; valid entries at the 3e38 placeholder survive) packed to the
    front ascending, ties in input order, freed slots (+inf, -1). Returns
    (dist, idx, removed (n,) i32 — dropped entries with id >= 0)."""
    valid = cur_idx >= 0
    removed = (drop & valid).sum(dim=1).to(torch.int32)
    keep = ~drop & valid & torch.isfinite(cur_dist)
    d, order = torch.sort(torch.where(keep, cur_dist, torch.inf), dim=1,
                          stable=True)
    i = torch.gather(cur_idx, 1, order)
    fin = torch.isfinite(d)
    return d, torch.where(fin, i, -1), removed


def set_rows(t: torch.Tensor, rows: torch.Tensor,
             sub: torch.Tensor) -> torch.Tensor:
    """A copy of ``t`` with row ``rows[j]`` set to ``sub[j]``; slots with
    rows[j] < 0 write nothing (they land in a spare row that is cut off:
    JAX's mode="drop" scatter, with no host sync)."""
    n = t.shape[0]
    out = torch.cat([t, t[:1]])
    out[torch.where(rows >= 0, rows, n).long()] = sub
    return out[:n]


def _row_form(cur_dist, cur_idx, rows, fn, *args):
    """Apply ``fn`` to the listed rows (-1 = padding; unique ids) of a copy
    of the (n, k) lists; (dist, idx, per-slot count, 0 on padding)."""
    ok = rows >= 0
    safe = torch.where(ok, rows, 0).long()
    sd, si, cnt = fn(cur_dist[safe], cur_idx[safe], *args)
    return (set_rows(cur_dist, rows, sd), set_rows(cur_idx, rows, si),
            torch.where(ok, cnt, 0))


def knn_merge_rows(
    cur_dist: torch.Tensor,   # (n, k) f32 ascending
    cur_idx: torch.Tensor,    # (n, k) i32
    rows: torch.Tensor,       # (f,) i32 unique row ids, -1 = padding
    cand_dist: torch.Tensor,  # (f, c) f32
    cand_idx: torch.Tensor,   # (f, c) i32, -1 = invalid
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``knn_merge`` of each frontier slot's candidates into list row
    ``rows[slot]``. Returns full (n, k) copies (rows not listed unchanged)
    and the (f,) accepted counts, 0 on padding slots."""
    return _row_form(cur_dist, cur_idx, rows, knn_merge, cand_dist, cand_idx)


def knn_compact_rows(
    cur_dist: torch.Tensor,   # (n, k) f32, +inf = empty
    cur_idx: torch.Tensor,    # (n, k) i32, -1 = empty
    rows: torch.Tensor,       # (f,) i32 unique row ids, -1 = padding
    drop: torch.Tensor,       # (f, k) bool, frontier-local
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``knn_compact`` of list row ``rows[slot]`` under ``drop[slot]``.
    Returns full (n, k) copies and the (f,) removed counts, 0 on padding
    slots."""
    return _row_form(cur_dist, cur_idx, rows, knn_compact, drop)


def centroid_assign(
    q: torch.Tensor,      # (m, dp) f32 rows
    q2: torch.Tensor,     # (m,) f32 their squared norms
    cent: torch.Tensor,   # (c, dp) f32 centroids
    c2: torch.Tensor,     # (c,) f32 centroid squared norms
    t: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-``t`` nearest centroids per row from one norm-expansion tile:
    (dist (m, t) ascending, idx (m, t) i32). A stable sort, so ties go to
    the lowest centroid id (``torch.topk`` leaves their order open, and a
    tiny corpus's router repeats centroids)."""
    d = (q2[:, None] + c2[None, :] - 2.0 * (q @ cent.T)).clamp_min(0.0)
    return top_t(d, t)


def top_t(d: torch.Tensor, t: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The ``t`` smallest entries of each row of ``d``, ascending, ties to
    the lowest column: (dist, idx i32)."""
    dd, ii = torch.sort(d, dim=1, stable=True)
    return dd[:, :t], ii[:, :t].to(torch.int32)


def pairwise_sq_l2_diff(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The direct difference form, sum((a - b)^2): the paper's FMA ladder
    and the most faithful oracle (no cancellation), O(M*N*D) memory.
    (M, D), (N, D) -> (M, N) f32. No kernel uses it."""
    diff = a.float()[:, None, :] - b.float()[None, :, :]
    return (diff * diff).sum(dim=-1)


def pairwise_sq_l2(
    a: torch.Tensor,     # (M, D) f32
    b: torch.Tensor,     # (N, D) f32
) -> torch.Tensor:
    """Pairwise squared l2 by the norm expansion, |a|^2 + |b|^2 - 2 a.b^T,
    clamped at 0 (the cancellation guard). (M, N) f32."""
    a2 = (a * a).sum(dim=-1)
    b2 = (b * b).sum(dim=-1)
    out = a2[:, None] + b2[None, :] - 2.0 * (a @ b.T)
    return out.clamp_min(0.0)


def knn_search_dists(
    q: torch.Tensor,     # (nq, dp) f32 query rows
    q2: torch.Tensor,    # (nq,) f32 query squared norms
    x: torch.Tensor,     # (N, dp) f32 base rows
    x2: torch.Tensor,    # (N,) f32 base squared norms
    ids: torch.Tensor,   # (nq, W) i32 candidate ids, -1 = invalid
) -> torch.Tensor:
    """Query-time candidate distances: per query, squared l2 to each of its
    W candidates, q2 + c2 - 2 q.c clamped at 0. Gathers the candidate rows
    itself; an id outside [0, N) (-1: empty slot, dead or filtered row)
    comes out +inf. (nq, W) f32."""
    valid = (ids >= 0) & (ids < x.shape[0])
    safe = torch.where(valid, ids, 0).long()
    ab = torch.bmm(x[safe], q[:, :, None])[:, :, 0]
    dd = q2[:, None] + x2[safe] - 2.0 * ab
    return torch.where(valid, dd.clamp_min(0.0), torch.inf)


# ---------------------------------------------------------------------------
# quantized scoring tiles (the two-stage path's first stage). Each takes
# the ids and the base mirror (data, scale, x2) of core/quantize.py and
# gathers the rows itself; an id outside [0, N) is an invalid slot. The
# int8 cross terms are integers: they are summed in float64, exact for any
# width the kernels' int32 sums take, then rounded to f32 as the kernels'
# (float) conversion does. The epilogue keeps the JAX oracles' order of
# operations: (q2 + c2) - (2 * (s_q * s_c)) * ab, clamped at 0.
# ---------------------------------------------------------------------------

def _gather_ok(ids: torch.Tensor, big_n: int):
    valid = (ids >= 0) & (ids < big_n)
    return valid, torch.where(valid, ids, 0).long()


def _int_dots(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched int8 products a @ b^T, exact, as f32."""
    return torch.bmm(a.to(torch.float64), b.to(torch.float64).transpose(
        1, 2)).to(torch.float32)


def knn_search_dists_q8(
    qq: torch.Tensor,      # (nq, w) i8 quantized query rows
    qscale: torch.Tensor,  # (nq,) f32 query scales
    q2: torch.Tensor,      # (nq,) f32 quantized-query squared norms
    data: torch.Tensor,    # (N, w) i8 base mirror rows
    scale: torch.Tensor,   # (N,) f32 base scales
    x2: torch.Tensor,      # (N,) f32 base squared norms (stored rows)
    ids: torch.Tensor,     # (nq, W) i32 candidate ids, -1 = invalid
) -> torch.Tensor:
    """int8 candidate distances with the scales in the epilogue: (nq, W)
    f32, +inf where the id is invalid."""
    valid, safe = _gather_ok(ids, data.shape[0])
    ab = _int_dots(data[safe], qq[:, None, :])[:, :, 0]
    dd = (q2[:, None] + x2[safe]) - (2.0 * (qscale[:, None] * scale[safe])) \
        * ab
    return torch.where(valid, dd.clamp_min(0.0), torch.inf)


def knn_search_dists_bf16(
    q: torch.Tensor,       # (nq, w) bf16 query rows
    q2: torch.Tensor,      # (nq,) f32 squared norms of the bf16 queries
    data: torch.Tensor,    # (N, w) bf16 base mirror rows
    x2: torch.Tensor,      # (N,) f32 squared norms of the bf16 rows
    ids: torch.Tensor,     # (nq, W) i32 candidate ids, -1 = invalid
) -> torch.Tensor:
    """bf16 candidate distances, f32 sums (the fp32 version on the
    bf16-rounded rows): (nq, W) f32, +inf where the id is invalid."""
    valid, safe = _gather_ok(ids, data.shape[0])
    ab = torch.bmm(data[safe].to(torch.float32),
                   q.to(torch.float32)[:, :, None])[:, :, 0]
    dd = (q2[:, None] + x2[safe]) - 2.0 * ab
    return torch.where(valid, dd.clamp_min(0.0), torch.inf)


def knn_join_dists_q8(
    data: torch.Tensor,    # (N, w) i8 mirror rows
    scale: torch.Tensor,   # (N,) f32 scales
    x2: torch.Tensor,      # (N,) f32 squared norms of the stored rows
    ids: torch.Tensor,     # (n, C) i32 candidate ids, -1 = invalid slot
    cn: int,               # width of the "new" candidate prefix
) -> tuple[torch.Tensor, torch.Tensor]:
    """int8 local-join pair distances: (n, C, C) f32 with +inf on pairs
    the join mask refuses, and evals (n,) i32, as ``knn_join_dists``."""
    valid, safe = _gather_ok(ids, data.shape[0])
    xg = data[safe]
    sg = scale[safe]
    x2g = torch.where(valid, x2[safe], 0.0)
    ab = _int_dots(xg, xg)
    dd = (x2g[:, :, None] + x2g[:, None, :]) \
        - (2.0 * (sg[:, :, None] * sg[:, None, :])) * ab
    ok = _join_ok(torch.where(valid, ids, -1), cn)
    out = torch.where(ok, dd.clamp_min(0.0), torch.inf)
    return out, (ok.sum(dim=(1, 2)) // 2).to(torch.int32)


def knn_join_dists_bf16(
    data: torch.Tensor,    # (N, w) bf16 mirror rows
    x2: torch.Tensor,      # (N,) f32 squared norms of the bf16 rows
    ids: torch.Tensor,     # (n, C) i32 candidate ids, -1 = invalid slot
    cn: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """bf16 local-join pair distances, f32 sums: the fp32 version on the
    bf16-rounded rows."""
    valid, safe = _gather_ok(ids, data.shape[0])
    xg = torch.where(valid[:, :, None], data[safe].to(torch.float32), 0.0)
    x2g = torch.where(valid, x2[safe], 0.0)
    ab = torch.bmm(xg, xg.transpose(1, 2))
    dd = (x2g[:, :, None] + x2g[:, None, :]) - 2.0 * ab
    ok = _join_ok(torch.where(valid, ids, -1), cn)
    out = torch.where(ok, dd.clamp_min(0.0), torch.inf)
    return out, (ok.sum(dim=(1, 2)) // 2).to(torch.int32)


# ---------------------------------------------------------------------------
# Attention (the LM stack's kernel)
# ---------------------------------------------------------------------------

def attention(
    q: torch.Tensor,             # (B, Lq, H, Dq)
    k: torch.Tensor,             # (B, Lk, Hkv, Dq)
    v: torch.Tensor,             # (B, Lk, Hkv, Dv)
    *,
    causal: bool = True,
    window: int | None = None,
    softcap: float | None = None,
    scale: float | None = None,
    q_offset: int = 0,
) -> torch.Tensor:
    """Multi-head attention with GQA, sliding window and softcap, in fp32,
    out in q's dtype (src/repro/kernels/ref.py:350). ``q_offset`` is the
    absolute position of q[0]; ``scale`` defaults to 1/sqrt(Dq). A row
    that sees no key comes out NaN (softmax over all -inf), as in JAX;
    the kernel writes 0 there."""
    b, lq, h, dq = q.shape
    lk, hkv = k.shape[1], k.shape[2]
    rep = h // hkv
    kr = k.repeat_interleave(rep, dim=2)
    vr = v.repeat_interleave(rep, dim=2)
    scale = 1.0 / math.sqrt(dq) if scale is None else scale
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), kr.float()) * scale
    if softcap is not None:
        logits = softcap * torch.tanh(logits / softcap)
    qpos = torch.arange(lq, device=q.device) + q_offset
    kpos = torch.arange(lk, device=q.device)
    mask = torch.ones((lq, lk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window is not None:
        mask &= kpos[None, :] > qpos[:, None] - window
    logits = logits.masked_fill(~mask[None, None], -torch.inf)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, vr.float())
    return out.to(q.dtype)
