"""NN-Descent (Dong et al., WWW'11) with the paper's optimizations
(turbosampling selection, blocked distance evaluation, greedy memory
reordering), on PyTorch with the build's CUDA kernels.

One iteration:
  1. selection (core/selection.py): bounded new/old candidate buffers,
     by turbosampling or the paper's heap / naive baselines;
  2. fused local join (``local_join_fused``): the per-row pair tensor from
     the ``knn_join_dists`` kernel; one stable sort of the n*C candidate
     incidences tells every receiver which (row, slot) positions list it
     (``invert_candidates``); each receiver gathers its incoming distance
     rows and the ``knn_join_select`` kernel reduces them to the best
     merge_k under the k-th-distance prefilter; receivers are contiguous
     rows, so the merge is a chunked block merge (heap.merge_block);
  3. convergence: stop when accepted updates <= delta * n * k.

``build_knn_graph`` runs iterations from Python; the greedy reorder (§3.2)
permutes the points between iterations 1 and 2, and two exhaustive polish
rounds finish the build.

``precision`` "int8" or "bf16" makes the build two-stage: the sampled
joins score pairs on a quantized mirror of the corpus (core/quantize.py)
through the ``knn_join_dists_q8`` / ``_bf16`` kernels; then
``rerank_lists`` recomputes every list's distances in fp32
(``knn_search_dists``) and the fp32 polish rounds finish, so the graph
returned never carries a quantized distance.

``backend="ref"`` keeps the seed implementation as the fused path's parity
oracle: every (new x new, new x old) pair of every row is scored by
``pair_block`` and flattened into an O(n*C^2) (receiver, candidate, dist)
list, prefiltered against the receiver's k-th distance, grouped by one
global (receiver, dist) lexsort (``compact_pairs``) and merged by
``heap.merge``; its polish merges the full k*k row, and it builds in fp32
whatever ``precision`` says. It runs no kernel. ``backend="plain"`` runs
the fused path through the kernels' plain versions on any device.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Sequence

import torch

from repro_torch.core import heap, quantize, selection
from repro_torch.core import metric as metric_mod
from repro_torch.core.device import resolve_device
from repro_torch.core.heap import NeighborLists
from repro_torch.core.layout import pad_features
from repro_torch.core.quantize import QuantizedStore
from repro_torch.core.reorder import apply_permutation, greedy_reorder
from repro_torch.kernels import ops

BACKENDS = ("auto", "plain", "ref")
PRECISIONS = ("f32", "bf16", "int8")
# a polish chunk's (rows, k*k, dp) f32 gather, and its merge's (rows, c,
# c) dedup mask, at most this many bytes
POLISH_CHUNK_BYTES = 1 << 32


@dataclasses.dataclass(frozen=True)
class DescentConfig:
    k: int = 20
    rho: float = 0.5           # sample rate: rho*k candidates per pool
    max_iters: int = 12
    delta: float = 0.001       # stop when updates < delta*n*k (paper §2)
    merge_size: int = 0        # merge buffer per node (0 = 3*k)
    selection: str = "turbo"   # turbo | heap | naive (paper's 3 tiers)
    reorder: bool = True       # paper §3.2 greedy reordering
    reorder_after: int = 1     # run reorder after this iteration
    polish: int = 2            # terminal exhaustive local-join rounds
    backend: str = "auto"      # auto: the fused path, kernels on a card,
                               # plain versions on the CPU; plain: the
                               # fused path through the plain versions
                               # anywhere; ref: the lexsort compact_pairs
                               # oracle path, no kernel
    block_k: int = 512         # kept for parity with the JAX config
    fetch: str = "a2a"         # a2a | ring: the sharded build's
                               # feature fetch (core/distributed.py)
    join_chunk: int = 2048     # fused join: receiver rows per chunk
    join_src: int = 0          # per-receiver incidence buffer (0 = 2*C)
    metric: str = "l2"         # l2 | cosine | mips (core/metric.py)
    precision: str = "f32"     # f32 | bf16 | int8: the sampled joins'
                               # scoring dtype (two-stage build); "ref"
                               # ignores it and builds in fp32

    @property
    def rho_k(self) -> int:
        return max(1, int(round(self.rho * self.k)))

    @property
    def merge_k(self) -> int:
        return self.merge_size or 3 * self.k


@dataclasses.dataclass
class DescentStats:
    iters: int = 0
    dist_evals: int = 0
    updates: tuple = ()
    polish_updates: tuple = ()
    reordered: bool = False
    frontier_rows: int = 0
    padded_rows: int = 0

    def flops(self, d: int) -> int:
        """Paper §2 cost model: d subs + d mults + (d-1) adds per eval."""
        return self.dist_evals * (3 * d - 1)


class BuildDraws(NamedTuple):
    """Injected randomness of a build: the raw (n, k) init ids in [0, n),
    and per sampled iteration the draws of the configured selection: turbo
    (u, rnd_new, rnd_old), each (2*n*k,); heap (w,), (2*n*k,); naive
    (rev_rnd (n*k,), u_new (n, 3k), u_old (n, 3k))."""
    init: torch.Tensor
    iters: Sequence[tuple[torch.Tensor, ...]]


def _ops_backend(cfg: DescentConfig) -> str:
    if cfg.backend not in BACKENDS:
        raise ValueError(f"unknown backend {cfg.backend!r}; expected "
                         f"{BACKENDS}")
    if cfg.precision not in PRECISIONS:
        raise ValueError(f"unknown precision {cfg.precision!r}; expected "
                         f"{PRECISIONS}")
    if cfg.selection not in selection.SELECTIONS:
        raise ValueError(f"unknown selection {cfg.selection!r}; expected "
                         f"{tuple(selection.SELECTIONS)}")
    return "auto" if cfg.backend == "auto" else "ref"


def pair_block(xg: torch.Tensor, x2g: torch.Tensor, yg: torch.Tensor,
               y2g: torch.Tensor) -> torch.Tensor:
    """Batched norm-expansion distances: (n, a, d) x (n, b, d) ->
    (n, a, b), clamped at 0."""
    ab = torch.bmm(xg, yg.transpose(1, 2))
    return (x2g[:, :, None] + y2g[:, None, :] - 2.0 * ab).clamp_min(0.0)


def compact_pairs(
    recv: torch.Tensor, cand: torch.Tensor, dist: torch.Tensor, n: int,
    c: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Group flat (receiver, candidate, dist) updates into (n, c) buffers
    holding each receiver's c smallest distances, ascending, ties by input
    position; receivers < 0 are dropped, empty slots are (+inf, -1).
    Returns (dist (n, c) f32, idx (n, c) i32). The router's member lists
    and the orphan reconnection use it (their per-receiver in-degree is
    unbounded, so a bounded incidence buffer could drop the closest)."""
    dev = recv.device
    key_recv = torch.where(recv >= 0, recv, n)
    order = selection.lexsort_order(dist, key_recv)
    recv_s = key_recv[order]
    first = torch.searchsorted(
        recv_s, torch.arange(n + 1, dtype=recv_s.dtype, device=dev))
    pos = torch.arange(recv_s.shape[0], device=dev) \
        - first[recv_s.clamp(0, n).long()]
    keep = (recv_s < n) & (pos < c)          # JAX's mode="drop" writes
    out_i = torch.full((n, c), -1, dtype=torch.int32, device=dev)
    out_d = torch.full((n, c), torch.inf, dtype=torch.float32, device=dev)
    tgt = (recv_s[keep].long(), pos[keep])
    out_i[tgt] = cand[order][keep].to(torch.int32)
    out_d[tgt] = dist[order][keep].to(torch.float32)
    return out_d, out_i


def invert_candidates(
    cands: torch.Tensor, n_univ: int, src_cap: int,
    prio: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Invert (row -> candidate) incidences: for every candidate id in
    [0, n_univ), the (row, slot) positions that list it, compacted into
    (n_univ, src_cap) buffers with a -1 tail. On overflow, ``prio`` (same
    shape as ``cands``) keeps the lowest-priority incidences; without it,
    the smallest (row, slot)."""
    nr, c = cands.shape
    dev = cands.device
    flat = cands.reshape(-1)
    key = torch.where(flat >= 0, flat, n_univ)
    if prio is None:
        order = torch.sort(key, stable=True).indices
    else:
        order = selection.lexsort_order(prio.reshape(-1), key)
    rs = key[order]
    first = torch.searchsorted(
        rs, torch.arange(n_univ + 1, dtype=rs.dtype, device=dev))
    pos = torch.arange(nr * c, device=dev) - first[rs.clamp(0, n_univ).long()]
    keep = (rs < n_univ) & (pos < src_cap)   # JAX's mode="drop" writes
    rows_of = torch.full((n_univ, src_cap), -1, dtype=torch.int32,
                         device=dev)
    slot_of = torch.full_like(rows_of, -1)
    tgt = (rs[keep].long(), pos[keep])
    rows_of[tgt] = (order[keep] // c).to(torch.int32)
    slot_of[tgt] = (order[keep] % c).to(torch.int32)
    return rows_of, slot_of


def local_join_fused(
    x: torch.Tensor,       # (n, dp) feature-padded points
    x2: torch.Tensor,      # (n,) squared norms
    nl: NeighborLists,
    cn: torch.Tensor,      # (n, Cn) new candidates
    co: torch.Tensor,      # (n, Co) old candidates
    cfg: DescentConfig,
    qs: QuantizedStore | None = None,   # quantized mirror of x
) -> tuple[NeighborLists, int, int]:
    """Fused local join + update routing: pair-distance kernel ->
    incidence inversion -> per-receiver gather + prefiltered top-merge_k
    select kernel -> chunked block merge. Returns (nl, accepted, evals).
    With ``qs`` and a quantized ``cfg.precision``, the pair tensor is
    scored on the mirror by the int8 / bf16 kernel."""
    backend = _ops_backend(cfg)
    n, k = nl.idx.shape
    cands = torch.cat([cn, co], dim=1)                 # (n, C)
    c_all = cands.shape[1]
    ids = torch.where(cands >= 0, cands, -1).to(torch.int32).contiguous()
    if cfg.precision == "int8" and qs is not None:
        dists, ev = ops.knn_join_dists_q8(qs.data, qs.scale, qs.x2, ids,
                                          cn.shape[1], backend=backend)
    elif cfg.precision == "bf16" and qs is not None:
        dists, ev = ops.knn_join_dists_bf16(qs.data, qs.x2, ids,
                                            cn.shape[1], backend=backend)
    else:
        dists, ev = ops.knn_join_dists(x, x2, ids, cn.shape[1],
                                       backend=backend)   # (n, C, C), (n,)

    kth = nl.dist[:, -1].contiguous()
    s_cap = cfg.join_src or 2 * c_all
    # overflow priority: the best distance an incidence can offer
    inc_prio = dists.min(dim=2).values
    rows_of, slot_of = invert_candidates(cands, n, s_cap, prio=inc_prio)

    # receiver chunks: pad to a chunk multiple so every merge is a full
    # in-bounds block (padding rows have no incidences)
    r = min(cfg.join_chunk, ((n + 7) // 8) * 8)
    npad = ((n + r - 1) // r) * r
    pad = npad - n
    rows_of = torch.nn.functional.pad(rows_of, (0, 0, 0, pad), value=-1)
    slot_of = torch.nn.functional.pad(slot_of, (0, 0, 0, pad), value=-1)
    kth_p = torch.nn.functional.pad(kth, (0, pad))
    nl_p = NeighborLists(
        torch.nn.functional.pad(nl.dist, (0, 0, 0, pad), value=torch.inf),
        torch.nn.functional.pad(nl.idx, (0, 0, 0, pad), value=-1),
        torch.nn.functional.pad(nl.new, (0, 0, 0, pad), value=False),
    )
    d_flat = dists.reshape(n * c_all, c_all)
    upd = torch.zeros((), dtype=torch.int64, device=x.device)
    for j in range(npad // r):
        sl = rows_of[j * r:(j + 1) * r]
        so = slot_of[j * r:(j + 1) * r]
        ok = sl >= 0
        lin = torch.where(ok, sl * c_all + so, 0).long()
        gd = torch.where(ok[:, :, None], d_flat[lin], torch.inf)
        gi = torch.where(ok[:, :, None], ids[torch.where(ok, sl, 0).long()],
                         -1)
        cd, ci = ops.knn_join_select(
            gd.reshape(r, s_cap * c_all), gi.reshape(r, s_cap * c_all),
            kth_p[j * r:(j + 1) * r], cfg.merge_k, backend=backend)
        nl_p, u = heap.merge_block(nl_p, j * r, cd, ci, backend=backend)
        upd += u.sum()
    nl = NeighborLists(nl_p.dist[:n], nl_p.idx[:n], nl_p.new[:n])
    return nl, int(upd), int(ev.sum())


def local_join_ref(
    x: torch.Tensor,       # (n, dp) feature-padded points
    x2: torch.Tensor,      # (n,) squared norms
    nl: NeighborLists,
    cn: torch.Tensor,      # (n, Cn) new candidates
    co: torch.Tensor,      # (n, Co) old candidates
    cfg: DescentConfig,
) -> tuple[NeighborLists, int, int]:
    """The lexsort local join (``backend="ref"``): every unordered new x
    new and every new x old pair of a row, scored by ``pair_block`` and
    routed to both ends as one flat (receiver, candidate, dist) list;
    pairs that do not beat the receiver's k-th distance are dropped, the
    rest grouped by ``compact_pairs`` at merge_k and merged by
    ``heap.merge``. Returns (nl, accepted, evals)."""
    n = nl.idx.shape[0]
    sn = torch.where(cn >= 0, cn, 0).long()
    so = torch.where(co >= 0, co, 0).long()
    a, b, dd, ok, evals = join_pairs(
        cn, co, x[sn], torch.where(cn >= 0, x2[sn], 0.0), x[so],
        torch.where(co >= 0, x2[so], 0.0))
    # receiver-side prefilter: only pairs beating the receiver's k-th
    # distance can change the graph
    kth = nl.dist[:, -1]
    ok &= dd < kth[torch.where(ok, a, 0).long()]
    cand_d, cand_i = compact_pairs(torch.where(ok, a, -1), b, dd, n,
                                   cfg.merge_k)
    nl, upd = heap.merge(nl, cand_d, cand_i, cand_new=True)
    return nl, int(upd.sum()), int(evals)


def join_pairs(
    cn: torch.Tensor,      # (n, Cn) new candidates, -1 = empty
    co: torch.Tensor,      # (n, Co) old candidates
    xg_n: torch.Tensor,    # (n, Cn, d) their rows
    x2_n: torch.Tensor,    # (n, Cn) their squared norms
    xg_o: torch.Tensor,    # (n, Co, d)
    x2_o: torch.Tensor,    # (n, Co)
) -> tuple[torch.Tensor, ...]:
    """The pairs of a row's candidate buffers, scored by ``pair_block``:
    every unordered new x new pair (i < j) and every new x old pair, each
    in both directions, flattened row by row as [a_nn, b_nn, a_no, b_no].
    Returns (a, b, dd, ok, evals): receivers, candidates, distances, the
    pairs of two valid distinct ids, and their count in one direction."""
    n = cn.shape[0]
    vn, vo = cn >= 0, co >= 0
    d_nn = pair_block(xg_n, x2_n, xg_n, x2_n)        # (n, Cn, Cn)
    d_no = pair_block(xg_n, x2_n, xg_o, x2_o)        # (n, Cn, Co)
    cn_b, co_b = cn.shape[1], co.shape[1]
    iu0, iu1 = torch.triu_indices(cn_b, cn_b, offset=1, device=cn.device)
    # new x new: unordered pairs i < j, both directions
    a_nn, b_nn = cn[:, iu0], cn[:, iu1]
    dd_nn = d_nn[:, iu0, iu1]
    ok_nn = vn[:, iu0] & vn[:, iu1] & (a_nn != b_nn)
    # new x old: every pair, both directions
    a_no = cn[:, :, None].expand(n, cn_b, co_b).reshape(n, -1)
    b_no = co[:, None, :].expand(n, cn_b, co_b).reshape(n, -1)
    dd_no = d_no.reshape(n, -1)
    ok_no = (vn[:, :, None] & vo[:, None, :]).reshape(n, -1) & (a_no != b_no)

    a = torch.cat([a_nn, b_nn, a_no, b_no], dim=1).reshape(-1)
    b = torch.cat([b_nn, a_nn, b_no, a_no], dim=1).reshape(-1)
    dd = torch.cat([dd_nn, dd_nn, dd_no, dd_no], dim=1).reshape(-1)
    ok = torch.cat([ok_nn, ok_nn, ok_no, ok_no], dim=1).reshape(-1)
    return a, b, dd, ok, ok_nn.sum() + ok_no.sum()


def nn_descent_iteration(
    x: torch.Tensor,       # (n, dp) feature-padded
    x2: torch.Tensor,      # (n,) squared norms
    nl: NeighborLists,
    cfg: DescentConfig,
    *,
    draws: tuple[torch.Tensor, ...] | None = None,
    generator: torch.Generator | None = None,
    qs: QuantizedStore | None = None,   # quantized mirror (precision)
) -> tuple[NeighborLists, int, int]:
    """One sampled iteration: selection (``cfg.selection``, fed ``draws``
    in that selection's form), flag clearing, then the fused join, or
    with ``backend="ref"`` the lexsort join. Returns (nl, accepted,
    evals)."""
    _ops_backend(cfg)
    cands = selection.SELECTIONS[cfg.selection](
        nl, cfg.rho_k, draws=draws, generator=generator)
    nl = heap.mark_sampled_old(nl, cands.sampled_fwd)
    if cfg.backend == "ref":
        return local_join_ref(x, x2, nl, cands.new_idx, cands.old_idx, cfg)
    return local_join_fused(x, x2, nl, cands.new_idx, cands.old_idx, cfg,
                            qs)


def polish_iteration(
    x: torch.Tensor,       # (n, dp) feature-padded
    x2: torch.Tensor,      # (n,) squared norms
    nl: NeighborLists,
    backend: str = "auto",
    *,
    chunk: int = 2048,
    full_merge: bool = False,
) -> tuple[NeighborLists, int, int]:
    """One exhaustive local-join round: every node joins against ALL k*k
    of its neighbors-of-neighbors (forward direction). The k*k candidate
    row is reduced by the ``knn_join_select`` kernel (k-th prefilter +
    best 6k) before the plain merge; ``full_merge`` (the "ref" build)
    merges the full row directly instead. The JAX version gathers x[nb]
    as one (n, k*k, dp) array; on the card that would need n*k*k*dp*4
    bytes (100 GB at 70000 x 400 x 896), so this one computes the
    distances, and the full merge, ``chunk`` rows at a time, with the
    same results; fewer where a chunk's (chunk, k*k, dp) f32 gather would
    pass ``POLISH_CHUNK_BYTES`` (2048 rows at k 20 and dp 896, 2.9 GB;
    144 at k 91, 4.3 GB). The merge's dedup mask is (rows, c, c) bools
    (c = 6k): it runs on row chunks of at most ``POLISH_CHUNK_BYTES`` too
    (one chunk at k 20; 14407 rows at k 91, where the whole mask would be
    21 GB at 70000 rows). ``backend`` is an ops backend (auto | ref). Returns
    (nl, accepted, evals)."""
    n, k = nl.idx.shape
    chunk = max(1, min(chunk, POLISH_CHUNK_BYTES
                       // (4 * k * k * x.shape[1] or 1)))
    ni = nl.idx
    nbl = ni.clamp(0, n - 1).long()
    nb = ni[nbl].reshape(n, k * k)
    rows = torch.arange(n, dtype=torch.int32, device=ni.device)[:, None]
    src_ok = (ni >= 0)[:, :, None].expand(n, k, k).reshape(n, k * k)
    ok = src_ok & (nb >= 0) & (nb != rows)
    nbc = nb.clamp(0, n - 1).long()
    dd = torch.empty((n, k * k), dtype=torch.float32, device=x.device)
    for s in range(0, n, chunk):
        ii = nbc[s:s + chunk]
        ab = torch.bmm(x[ii], x[s:s + chunk, :, None])[:, :, 0]
        dd[s:s + chunk] = x2[s:s + chunk, None] + x2[ii] - 2.0 * ab
    dd = torch.where(ok, dd.clamp_min(0.0), torch.inf)
    evals = int(ok.sum())
    ci = torch.where(ok, nb, -1)
    if full_merge:
        cd, step = dd, chunk
    else:
        cd, ci = ops.knn_join_select(
            dd, ci.contiguous(), nl.dist[:, -1].contiguous(),
            min(6 * k, k * k), backend=backend)
        step = max(1, POLISH_CHUNK_BYTES // cd.shape[1] ** 2)
    parts = [heap.merge(NeighborLists(*(t[s:s + step] for t in nl)),
                        cd[s:s + step], ci[s:s + step])
             for s in range(0, n, step)]
    nl = NeighborLists(*(torch.cat([p[0][f] for p in parts])
                         for f in range(3)))
    return nl, sum(int(p[1].sum()) for p in parts), evals


def rerank_lists(
    x: torch.Tensor,       # (n, dp) feature-padded
    x2: torch.Tensor,      # (n,) squared norms
    nl: NeighborLists,
    backend: str = "auto",
) -> NeighborLists:
    """Exact fp32 re-rank of every list: d(row, idx) recomputed by one
    (n, k) ``knn_search_dists`` tile, each row re-sorted by a stable sort
    (+inf, the empty slots, last). The second stage of a quantized build.
    ``backend`` is an ops backend (auto | ref). Cost: n*k evaluations."""
    dd = ops.knn_search_dists(x, x2, x, x2, nl.idx.contiguous(),
                              backend=backend)        # (n, k)
    dd, order = torch.sort(dd, dim=1, stable=True)
    return NeighborLists(dd, torch.gather(nl.idx, 1, order),
                         torch.gather(nl.new, 1, order))


def build_knn_graph(
    x,
    k: int = 20,
    *,
    cfg: DescentConfig | None = None,
    generator: torch.Generator | None = None,
    device=None,
    draws: BuildDraws | None = None,
    callback: Callable | None = None,
):
    """Build an approximate K-NN graph of x (n, d).

    Runs on ``device``, "cuda" unless the caller asks otherwise; with no
    card present that raises. Returns (dist (n, k) f32 ascending, idx
    (n, k) i32 in ORIGINAL ids, stats). Deterministic given ``generator``
    (a ``torch.Generator`` on ``device``; a fresh one seeded 0 if None) or
    given ``draws``, which replaces every random draw."""
    cfg = cfg or DescentConfig(k=k)
    if cfg.k != k:
        cfg = dataclasses.replace(cfg, k=k)
    backend = _ops_backend(cfg)
    device = resolve_device(device, "build_knn_graph")
    if generator is None and draws is None:
        generator = torch.Generator(device=device).manual_seed(0)
    x = torch.as_tensor(x, dtype=torch.float32, device=device)
    n = x.shape[0]
    x, _ = metric_mod.transform_corpus(x, cfg.metric)
    xp = pad_features(x).contiguous()
    x2 = (xp * xp).sum(dim=1)

    # two-stage quantized build: the sampled joins score on a mirror at
    # its own width (the fp32 layout's zero padding dropped); rerank_lists
    # and the fp32 polish rounds restore exact distances ("ref", the
    # lexsort oracle, is always fp32)
    quant = cfg.precision != "f32" and cfg.backend != "ref"
    qs = (quantize.quantize_corpus(
        xp, cfg.precision, width=quantize.mirror_width(x.shape[1],
                                                       xp.shape[1]))
        if quant else None)

    nl = heap.init_random_with_dists(
        xp, cfg.k, idx=None if draws is None else draws.init,
        generator=generator)
    stats = DescentStats(dist_evals=n * cfg.k)
    perm = torch.arange(n, dtype=torch.int32, device=device)

    updates = []
    for it in range(cfg.max_iters):
        it_draws = None if draws is None else draws.iters[it]
        nl, upd, ev = nn_descent_iteration(xp, x2, nl, cfg, draws=it_draws,
                                           generator=generator, qs=qs)
        stats.dist_evals += ev
        updates.append(upd)
        stats.iters = it + 1
        if callback is not None:
            callback(it, upd, nl)
        if cfg.reorder and it + 1 == cfg.reorder_after:
            sigma, sigma_inv = greedy_reorder(nl)
            xp, nl = apply_permutation(xp, nl, sigma, sigma_inv)
            x2 = x2[sigma_inv.long()]
            perm = perm[sigma_inv.long()]
            if quant:       # per-row quantization permutes exactly
                si = sigma_inv.long()
                qs = QuantizedStore(qs.data[si], qs.scale[si], qs.x2[si])
            stats.reordered = True
        if upd <= cfg.delta * n * cfg.k:
            break
    stats.updates = tuple(updates)

    # stage two of a quantized build: the surviving lists re-ranked in
    # fp32, so the polish merges against exact distances
    if quant:
        nl = rerank_lists(xp, x2, nl, backend)
        stats.dist_evals += n * cfg.k

    polish_updates = []
    for _ in range(cfg.polish):
        nl, upd_p, ev_p = polish_iteration(
            xp, x2, nl, backend, full_merge=cfg.backend == "ref")
        polish_updates.append(upd_p)
        stats.dist_evals += ev_p
    stats.polish_updates = tuple(polish_updates)

    # map back to original ids: row r describes original node perm[r]
    pl = perm.long()
    dist = torch.zeros_like(nl.dist)
    dist[pl] = nl.dist
    idx = torch.full_like(nl.idx, -1)
    idx[pl] = torch.where(nl.idx >= 0, perm[nl.idx.clamp(0, n - 1).long()],
                          -1)
    return dist, idx, stats
