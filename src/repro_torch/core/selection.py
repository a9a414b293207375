"""Selection step — paper §3.1, heap-free "turbosampling".

Per NN-Descent iteration, every node u needs a bounded sample of its
neighborhood N(u) = adj(u) ∪ adj⁻¹(u), split into "new" and "old" pools.
Reverse degrees come from one bincount over the edge list; each directed
(receiver, candidate) incidence is accepted by an independent Bernoulli
with probability rho*k/|N(u)|; accepted incidences are compacted into
fixed (n, C) buffers by one (receiver, random) sort.

The paper's two baselines sit beside it: ``selection_heap`` (PyNNDescent's
fused one-pass selection: the rho_k smallest of one random weight per
incidence) and ``selection_naive`` (three passes: reverse, union, sample).

The uniform draws can be injected (``draws``, each selection its own
form), so that the tests can feed the JAX package's threefry draws;
otherwise they come from ``generator``.
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


def _uniforms(draws, shapes, generator, dev):
    """The injected draws as float32 tensors on ``dev``, or fresh uniforms
    of ``shapes`` from ``generator``."""
    if draws is None:
        return tuple(torch.rand(s, generator=generator, device=dev)
                     for s in shapes)
    return tuple(torch.as_tensor(t, dtype=torch.float32, device=dev)
                 for t in draws)


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
    u, rnd_new, rnd_old = _uniforms(draws, [recv.shape] * 3, generator,
                                    dev)
    acc_new = valid & is_new & (u < p_new)
    acc_old = valid & ~is_new & (u < p_old)
    new_buf = _compact(recv, cand, acc_new, rnd_new, n, rho_k)
    old_buf = _compact(recv, cand, acc_old, rnd_old, n, rho_k)
    # forward new slots that were accepted are "joined": clear their flag
    # (forward incidence i is slot i, so no scatter is needed)
    sampled_fwd = (acc_new & is_fwd)[: n * k].reshape(n, k)
    return Candidates(new_buf, old_buf, sampled_fwd)


def selection_heap(
    nl: NeighborLists, rho_k: int, *,
    draws: tuple[torch.Tensor] | None = None,
    generator: torch.Generator | None = None,
) -> Candidates:
    """PyNNDescent-style fused selection (paper C1): one uniform weight per
    incidence, the rho_k smallest weights per receiver and pool kept by
    the same compaction. ``draws`` = (w,), w (2*n*k,) uniform in [0, 1).
    A forward new slot counts as sampled when its weight is under the
    turbo acceptance probability rho_k / deg, as the JAX package marks it."""
    n, k = nl.idx.shape
    recv, cand, is_new, valid, is_fwd = _incidences(nl)
    (w,) = _uniforms(draws, [recv.shape], generator, nl.idx.device)
    new_buf = _compact(recv, cand, valid & is_new, w, n, rho_k)
    old_buf = _compact(recv, cand, valid & ~is_new, w, n, rho_k)
    deg_new = torch.bincount(recv[valid & is_new], minlength=n)
    p = torch.clamp(rho_k / deg_new.clamp_min(1), max=1.0)[recv]
    acc = valid & is_new & (w < p)
    return Candidates(new_buf, old_buf, (acc & is_fwd)[: n * k].reshape(n, k))


def selection_naive(
    nl: NeighborLists, rho_k: int, *,
    draws: tuple[torch.Tensor, torch.Tensor, torch.Tensor] | None = None,
    generator: torch.Generator | None = None,
) -> Candidates:
    """The paper's baseline: three passes with materialized intermediates.
    Pass 1 compacts the reverse adjacency into a bounded (n, 2k) buffer;
    pass 2 unions it with the forward lists, (n, 3k) with per-slot new
    flags; pass 3 keeps rho_k per pool by a stable sort of random weights.
    ``draws`` = (rev_rnd (n*k,), u_new (n, 3k), u_old (n, 3k)), uniform in
    [0, 1)."""
    n, k = nl.idx.shape
    r_max = 2 * k
    recv, cand, is_new, valid, _ = _incidences(nl)
    half = n * k
    rev_recv, rev_cand, rev_valid = recv[half:], cand[half:], valid[half:]
    rev_rnd, u_new, u_old = _uniforms(
        draws, [(half,), (n, 3 * k), (n, 3 * k)], generator, nl.idx.device)
    rev_buf = _compact(rev_recv, rev_cand, rev_valid, rev_rnd, n, r_max)
    rev_new_buf = _compact(rev_recv, rev_cand, rev_valid & is_new[half:],
                           rev_rnd, n, r_max)
    union_idx = torch.cat([nl.idx, rev_buf], dim=1)              # (n, 3k)
    in_rev_new = (rev_buf[:, :, None] == rev_new_buf[:, None, :]).any(-1)
    union_new = torch.cat([nl.new, in_rev_new], dim=1)
    valid_u = union_idx >= 0

    def sample(mask, u):
        ww = torch.where(mask, u, torch.inf)
        ws, order = torch.sort(ww, dim=1, stable=True)
        got = torch.gather(union_idx, 1, order[:, :rho_k])
        return torch.where(ws[:, :rho_k] < torch.inf, got, -1)

    new_buf = sample(valid_u & union_new, u_new)
    old_buf = sample(valid_u & ~union_new, u_old)
    # flag clearing as turbo's: the forward slots present in the sample
    sampled = (nl.idx[:, :, None] == new_buf[:, None, :]).any(-1) & nl.new
    return Candidates(new_buf, old_buf, sampled)


SELECTIONS = {"turbo": selection_turbo, "heap": selection_heap,
              "naive": selection_naive}
