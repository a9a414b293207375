"""Bounded, sorted neighbor lists (paper §3.1 removes real heaps).

Per node, k slots of (distance ascending, id), with (inf, -1) for empty
slots, plus a "new" flag per slot for NN-Descent's incremental search.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.kernels import ops, ref

PLACEHOLDER = 3.0e38   # unevaluated init distance: below the merge sentinel


class NeighborLists(NamedTuple):
    dist: torch.Tensor   # (n, k) f32, ascending, inf = empty
    idx: torch.Tensor    # (n, k) i32, -1 = empty
    new: torch.Tensor    # (n, k) bool — not yet used in a join

    def to_numpy(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        return (self.dist.cpu().numpy(), self.idx.cpu().numpy(),
                self.new.cpu().numpy())


def neighbor_lists_from_numpy(dist, idx, new, device=None) -> NeighborLists:
    """Lists from numpy arrays (for instance a JAX ``NeighborLists``
    converted with ``np.asarray``). The arrays are copied."""
    return NeighborLists(
        torch.as_tensor(np.array(dist, np.float32), device=device),
        torch.as_tensor(np.array(idx, np.int32), device=device),
        torch.as_tensor(np.array(new, bool), device=device),
    )


def init_random(
    n: int, k: int, *, idx: torch.Tensor | None = None,
    generator: torch.Generator | None = None, device=None,
) -> NeighborLists:
    """Uniform random init (paper §2), distances unevaluated (the
    placeholder; all slots new). ``idx`` injects the raw (n, k) draws in
    [0, n); otherwise they come from ``generator``. Self-loops are bumped
    to the next id (mod n) either way."""
    if idx is None:
        idx = torch.randint(0, n, (n, k), generator=generator,
                            device=device, dtype=torch.int32)
    idx = torch.as_tensor(idx, dtype=torch.int32, device=device)
    rows = torch.arange(n, dtype=torch.int32, device=idx.device)[:, None]
    idx = torch.where(idx == rows, (idx + 1) % n, idx)
    dist = torch.full((n, k), PLACEHOLDER, dtype=torch.float32,
                      device=idx.device)
    new = torch.ones((n, k), dtype=torch.bool, device=idx.device)
    return NeighborLists(dist, idx, new)


def init_random_with_dists(
    x: torch.Tensor, k: int, *, idx: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
) -> NeighborLists:
    """Random init with true distances evaluated and each row sorted."""
    n = x.shape[0]
    nl = init_random(n, k, idx=idx, generator=generator, device=x.device)
    d = _gather_distances(x, nl.idx)
    d, order = torch.sort(d, dim=1, stable=True)
    return NeighborLists(d, torch.gather(nl.idx, 1, order),
                         torch.ones_like(nl.new))


def _gather_distances(
    x: torch.Tensor, idx: torch.Tensor, *, chunk: int = 4096
) -> torch.Tensor:
    """d(x[i], x[idx[i, j]]) for all i, j — norm-expansion form, chunked
    over rows so the gathered (rows, k, d) block stays small."""
    xf = x.float()
    x2 = (xf * xf).sum(dim=1)
    out = torch.empty(idx.shape, dtype=torch.float32, device=x.device)
    for s in range(0, x.shape[0], chunk):
        ii = idx[s:s + chunk].long()
        ab = torch.bmm(xf[ii], xf[s:s + chunk, :, None])[:, :, 0]
        out[s:s + chunk] = x2[s:s + chunk, None] + x2[ii] - 2.0 * ab
    return out.clamp_min(0.0)


def merge(
    nl: NeighborLists, cand_dist: torch.Tensor, cand_idx: torch.Tensor,
    cand_new: bool = True,
) -> tuple[NeighborLists, torch.Tensor]:
    """Plain merge of candidate (dist, id) pairs into the lists (the
    polish's merge). Returns (lists, per-node accepted count). Accepted
    slots get the ``new`` flag; surviving slots keep theirs."""
    k = nl.dist.shape[1]
    all_idx = torch.cat([nl.idx, cand_idx], dim=1)
    all_flag = torch.cat(
        [nl.new, torch.full(cand_idx.shape, cand_new, dtype=torch.bool,
                            device=cand_idx.device)], dim=1)
    dup = ref.candidate_dups(nl.idx, cand_idx)
    all_dist = torch.cat(
        [nl.dist, torch.where(dup, torch.inf, cand_dist)], dim=1)
    srt, order = torch.sort(all_dist, dim=1, stable=True)
    order = order[:, :k]
    new_dist = srt[:, :k]
    new_idx = torch.gather(all_idx, 1, order)
    new_flag = torch.gather(all_flag, 1, order)
    accepted = (order >= k) & torch.isfinite(new_dist)
    return (NeighborLists(new_dist, new_idx, new_flag),
            accepted.sum(dim=1).to(torch.int32))


def merge_kernel(
    nl: NeighborLists, cand_dist: torch.Tensor, cand_idx: torch.Tensor, *,
    backend: str = "auto",
) -> tuple[NeighborLists, torch.Tensor]:
    """Merge (n, c) candidates into the lists through the merge kernel.
    Flags are recomputed: a slot that was already in the old list keeps its
    flag, an accepted candidate comes in new, an empty slot is not new.
    Returns (lists, (n,) accepted counts)."""
    md, mi, upd = ops.knn_merge(nl.dist, nl.idx, cand_dist, cand_idx,
                                backend=backend)
    was_old = (mi[:, :, None] == nl.idx[:, None, :]).any(-1)
    flag = torch.where(was_old, _lookup_flags(nl, mi), True) & (mi >= 0)
    return NeighborLists(md, mi, flag), upd


def _lookup_flags(nl: NeighborLists, ids: torch.Tensor) -> torch.Tensor:
    hit = ids[:, :, None] == nl.idx[:, None, :]
    return (hit & nl.new[:, None, :]).any(-1)


def merge_block(
    nl: NeighborLists, start: int, cand_dist: torch.Tensor,
    cand_idx: torch.Tensor, *, backend: str = "auto",
) -> tuple[NeighborLists, torch.Tensor]:
    """Merge (R, c) candidates into the contiguous row block [start,
    start+R) through the merge kernel. Unlike the JAX version, which
    returns new arrays, this writes the block IN PLACE into ``nl``'s
    tensors (and returns ``nl``): the fused join owns padded copies of
    the lists. Returns (lists, (R,) accepted counts)."""
    end = start + cand_dist.shape[0]
    old = NeighborLists(nl.dist[start:end], nl.idx[start:end],
                        nl.new[start:end])
    out, upd = merge_kernel(old, cand_dist, cand_idx, backend=backend)
    nl.dist[start:end] = out.dist
    nl.idx[start:end] = out.idx
    nl.new[start:end] = out.new
    return nl, upd


def merge_rows(
    nl: NeighborLists, rows: torch.Tensor, cand_dist: torch.Tensor,
    cand_idx: torch.Tensor, *, backend: str = "auto",
) -> tuple[NeighborLists, torch.Tensor]:
    """Frontier merge: (f, c) candidates into list rows ``rows`` (f,) only
    (-1 = padding; ids unique), through ``ops.knn_merge_rows``. The flag
    bookkeeping runs on the gathered (f, k) sub-lists, so it costs O(f).
    Returns (lists, (f,) accepted counts)."""
    ok = rows >= 0
    safe = torch.where(ok, rows, 0).long()
    old = NeighborLists(nl.dist[safe], nl.idx[safe], nl.new[safe])
    new_dist, new_idx, upd = ops.knn_merge_rows(
        nl.dist, nl.idx, rows.to(torch.int32).contiguous(),
        cand_dist.contiguous(), cand_idx.to(torch.int32).contiguous(),
        backend=backend)
    sub_i = new_idx[safe]
    was_old = (sub_i[:, :, None] == old.idx[:, None, :]).any(-1)
    flag = torch.where(was_old, _lookup_flags(old, sub_i), True) \
        & (sub_i >= 0)
    return NeighborLists(new_dist, new_idx,
                         ref.set_rows(nl.new, rows, flag)), upd


def purge_rows(
    nl: NeighborLists, rows: torch.Tensor, alive: torch.Tensor, *,
    backend: str = "auto",
) -> tuple[NeighborLists, torch.Tensor]:
    """Frontier purge: drop dead-target edges from list rows ``rows`` only,
    and empty the lists of rows that are dead themselves, through
    ``ops.knn_compact_rows``. Survivors stay sorted and packed; freed
    slots become (inf, -1, False). Returns (lists, (f,) removed counts)."""
    n = alive.shape[0]
    ok = rows >= 0
    safe = torch.where(ok, rows, 0).long()
    sub_i = nl.idx[safe]
    valid = sub_i >= 0
    drop = valid & ~alive[sub_i.clamp(0, n - 1).long()]
    drop |= valid & ~alive[safe][:, None]            # dead row: clear it
    new_dist, new_idx, removed = ops.knn_compact_rows(
        nl.dist, nl.idx, rows.to(torch.int32).contiguous(),
        drop.contiguous(), backend=backend)
    sub_new = new_idx[safe]
    flag = _lookup_flags(NeighborLists(nl.dist[safe], sub_i, nl.new[safe]),
                         sub_new) & (sub_new >= 0)
    return NeighborLists(new_dist, new_idx,
                         ref.set_rows(nl.new, rows, flag)), removed


def purge(
    nl: NeighborLists, alive: torch.Tensor, *, backend: str = "auto"
) -> tuple[NeighborLists, torch.Tensor]:
    """Remove every edge that points at a dead row (``alive[idx]`` False),
    through ``ops.knn_compact``. Survivors stay sorted and packed; freed
    slots become (inf, -1, False). Returns (lists, (n,) removed counts)."""
    n = alive.shape[0]
    valid = nl.idx >= 0
    drop = valid & ~alive[nl.idx.clamp(0, n - 1).long()]
    new_dist, new_idx, removed = ops.knn_compact(
        nl.dist.contiguous(), nl.idx.contiguous(), drop.contiguous(),
        backend=backend)
    flag = _lookup_flags(nl, new_idx) & (new_idx >= 0)
    return NeighborLists(new_dist, new_idx, flag), removed


def mark_sampled_old(nl: NeighborLists,
                     sampled_mask: torch.Tensor) -> NeighborLists:
    """Clear the 'new' flag of forward slots sampled this round."""
    return nl._replace(new=nl.new & ~sampled_mask)
