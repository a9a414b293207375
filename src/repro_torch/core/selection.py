"""Selection step — paper §3.1, heap-free "turbosampling".

Per NN-Descent iteration, every node u needs a bounded sample of its
neighborhood N(u) = adj(u) ∪ adj⁻¹(u), split into "new" and "old" pools.
Reverse degrees come from one bincount over the edge list; each directed
(receiver, candidate) incidence is accepted by an independent Bernoulli
with probability rho*k/|N(u)|; accepted incidences are compacted into
fixed (n, C) buffers by one (receiver, random) sort.

The uniform draws can be injected (``draws``), so that the tests can feed
the JAX package's threefry draws; otherwise they come from ``generator``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.heap import NeighborLists


class Candidates(NamedTuple):
    new_idx: torch.Tensor      # (n, c_new) i32, -1 = empty
    old_idx: torch.Tensor      # (n, c_old) i32, -1 = empty
    sampled_fwd: torch.Tensor  # (n, k) bool: forward new slots sampled


def _incidences(nl: NeighborLists):
    """All directed (receiver, candidate, is_new, valid, is_forward)
    incidences, flattened to (2*n*k,): the n*k forward ones first (u
    receives its adjacency), then the reverse ones (adj(u) receives u)."""
    n, k = nl.idx.shape
    rows = torch.arange(n, dtype=torch.int32, device=nl.idx.device)
    fwd_recv = rows[:, None].expand(n, k).reshape(-1)
    valid = (nl.idx >= 0).reshape(-1)
    fwd_cand = torch.where(nl.idx >= 0, nl.idx, 0).reshape(-1)
    is_new = nl.new.reshape(-1)
    recv = torch.cat([fwd_recv, fwd_cand])
    cand = torch.cat([fwd_cand, fwd_recv])
    new = torch.cat([is_new, is_new])
    val = torch.cat([valid, valid])
    is_fwd = torch.cat([torch.ones_like(valid), torch.zeros_like(valid)])
    return recv, cand, new, val, is_fwd


def lexsort_order(minor: torch.Tensor, major: torch.Tensor) -> torch.Tensor:
    """``jnp.lexsort((minor, major))``: sort by ``major``, ties by
    ``minor``, remaining ties by position — two stable sorts."""
    o1 = torch.sort(minor, stable=True).indices
    return o1[torch.sort(major[o1], stable=True).indices]


def _compact(recv, cand, accept, rnd, n: int, c: int) -> torch.Tensor:
    """Compact accepted (receiver, candidate) incidences into an (n, c)
    buffer: sort by (receiver, random), keep the first c per receiver."""
    key_recv = torch.where(accept, recv, n)
    order = lexsort_order(rnd, key_recv)
    recv_s = key_recv[order]
    cand_s = cand[order]
    first = torch.searchsorted(
        recv_s, torch.arange(n + 1, dtype=recv_s.dtype, device=recv.device))
    pos = torch.arange(recv_s.shape[0], device=recv.device) \
        - first[recv_s.clamp(0, n)]
    keep = (recv_s < n) & (pos < c)          # JAX's mode="drop" writes
    out = torch.full((n, c), -1, dtype=torch.int32, device=recv.device)
    out[recv_s[keep].long(), pos[keep]] = cand_s[keep]
    return out


def selection_turbo(
    nl: NeighborLists, rho_k: int, *,
    draws: tuple[torch.Tensor, torch.Tensor, torch.Tensor] | None = None,
    generator: torch.Generator | None = None,
) -> Candidates:
    """Heap-free turbosampling (paper C2). rho_k = max candidates per pool.
    ``draws`` = (u, rnd_new, rnd_old), each (2*n*k,) uniform in [0, 1):
    the accept test and the two compaction sort keys."""
    n, k = nl.idx.shape
    dev = nl.idx.device
    recv, cand, is_new, valid, is_fwd = _incidences(nl)
    deg_new = torch.bincount(recv[valid & is_new], minlength=n)
    deg_old = torch.bincount(recv[valid & ~is_new], minlength=n)
    p_new = torch.clamp(rho_k / deg_new.clamp_min(1), max=1.0)[recv]
    p_old = torch.clamp(rho_k / deg_old.clamp_min(1), max=1.0)[recv]
    if draws is None:
        u, rnd_new, rnd_old = (
            torch.rand(recv.shape, generator=generator, device=dev)
            for _ in range(3))
    else:
        u, rnd_new, rnd_old = (torch.as_tensor(t, dtype=torch.float32,
                                               device=dev) for t in draws)
    acc_new = valid & is_new & (u < p_new)
    acc_old = valid & ~is_new & (u < p_old)
    new_buf = _compact(recv, cand, acc_new, rnd_new, n, rho_k)
    old_buf = _compact(recv, cand, acc_old, rnd_old, n, rho_k)
    # forward new slots that were accepted are "joined": clear their flag
    # (forward incidence i is slot i, so no scatter is needed)
    sampled_fwd = (acc_new & is_fwd)[: n * k].reshape(n, k)
    return Candidates(new_buf, old_buf, sampled_fwd)


def selection_heap(*args, **kwargs):
    raise NotImplementedError(
        "selection='heap' is not ported yet (ROADMAP.md, Queue 1: the "
        "heap/naive selection slice)")


def selection_naive(*args, **kwargs):
    raise NotImplementedError(
        "selection='naive' is not ported yet (ROADMAP.md, Queue 1: the "
        "heap/naive selection slice)")
