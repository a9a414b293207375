"""Online K-NN graph updates: insert and delete without a full rebuild.

  * ``knn_insert(store, new_points)`` seeds each new point by a graph search
    over the existing graph, then refines it by a localized NN-Descent: a
    few friend-of-a-friend rounds that join each new point against its
    neighbors' neighbors, with the reverse edges routed to the rows they
    improve (``_route_reverse``: invert the incidences, gather, prefiltered
    top-c through ``knn_join_select``).
  * ``knn_delete(store, ids)`` tombstones rows (``alive``), purges the dead
    ids out of every affected list with the ``knn_compact_rows`` kernel
    and refills the holes from the surviving neighbors' lists (one
    friend-of-a-friend round).
  * ``MutableKNNStore`` holds capacity-doubling padded arrays (rows, their
    squared norms, neighbor lists, the alive mask, an optional quantized
    mirror and router).

Every update step runs on an explicit, compacted frontier of affected row
ids, in padded chunks of ``OnlineConfig.chunk`` rows: the merge and
compaction kernels (``ops.knn_merge_rows`` / ``knn_compact_rows``) read and
write the listed rows of the full lists themselves, so the distance and
list work scales with the frontier, not the store. What stays O(n) per
update is integer mask bookkeeping and, on the card, the one device copy of
the (n, k) lists each row kernel makes: the store keeps the JAX package's
value semantics (an update returns a new store; the old one stays valid).

Both entry points return a ``DescentStats`` whose ``dist_evals`` counts (an
upper bound on) the distance evaluations, and whose ``frontier_rows`` /
``padded_rows`` record how many rows the update touched.

The randomness is injectable for the tests: ``knn_insert`` takes the seed
search's ``entry`` (or, with a router, ``route_fill``), and ``from_graph``
takes the router's sample weights; otherwise
draws come from ``torch.Generator``s (seeded 0 for an insert, 29 for a
router, as the JAX package seeds its keys).
"""
from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import torch

from repro_torch.core import faults, heap, quantize
from repro_torch.core import metric as metric_mod
from repro_torch.core.device import resolve_device
from repro_torch.core.graph_search import (
    SearchConfig,
    expand_frontier,
    graph_search,
)
from repro_torch.core.heap import NeighborLists
from repro_torch.core.layout import ceil_to, pad_features
from repro_torch.core.nn_descent import (
    DescentConfig,
    DescentStats,
    build_knn_graph,
    compact_pairs,
    invert_candidates,
)
from repro_torch.core.quantize import QuantizedStore
from repro_torch.core.router import (
    Router,
    RouterConfig,
    build_router,
    needs_rebuild,
    router_delete,
    router_from_numpy,
    router_insert,
)
from repro_torch.kernels import ops

_FILL = 1e6   # coordinate fill for unallocated rows
BACKENDS = ("auto", "plain", "ref")


@dataclasses.dataclass(frozen=True)
class OnlineConfig:
    beam: int = 32            # seeding graph-search pool width
    seed_rounds: int = 24     # seeding graph-search expansion budget
    seed_expand: int = 4      # fused search: pool nodes expanded per round
    q_block: int = 256        # fused search: queries per block
    refine_rounds: int = 2    # localized friend-of-a-friend rounds
    self_join: bool = True    # all-pairs join within the inserted batch
    self_join_max: int = 512  # skip the O(m^2) self-join beyond this m
    merge_mult: int = 2       # reverse-merge buffer = merge_mult * k
    backend: str = "auto"     # auto: the kernels (plain versions for CPU
                              # tensors) and the fused seed search; plain:
                              # the same path through the plain versions
                              # on any device (JAX's "interpret"); ref: the
                              # plain versions and the greedy seed search
    chunk: int = 1024         # frontier chunk: padded row-id buffers are
                              # rounded up to a multiple of this, and the
                              # delete path processes one chunk at a time
    frontier: bool = True     # False = dense baseline: every allocated row
                              # goes on the delete frontier
    frontier_mult: int = 4    # insert reverse-frontier cap, in units of m*k
    route_src: int = 0        # reverse routing's per-receiver incidence
                              # buffer (0 = 2*merge_mult*k)
    metric: str = "l2"        # l2 | cosine | mips: rows are stored in the
                              # metric's l2-equivalent form
    precision: str = "f32"    # f32 | bf16 | int8: the quantized mirror the
                              # seed search and store.search score on
    router: RouterConfig | None = None
                              # coarse routing layer (core/router.py): seeds
                              # every search, maintained on insert/delete,
                              # rebuilt lazily past the drift threshold


def _backend(cfg: OnlineConfig) -> str:
    """The ops backend (auto | ref) of the store's configuration."""
    if cfg.backend not in BACKENDS:
        raise ValueError(f"unknown backend {cfg.backend!r}; expected "
                         f"{BACKENDS}")
    return "auto" if cfg.backend == "auto" else "ref"


@dataclasses.dataclass(frozen=True)
class MutableKNNStore:
    """Growable K-NN graph store. Rows [0, n) are allocated; ``alive``
    marks the live ones (False = tombstoned or unallocated)."""

    x: torch.Tensor       # (cap, dp) feature-padded rows, stored in
                          # cfg.metric's l2-equivalent form
    x2: torch.Tensor      # (cap,) squared norms
    nl: NeighborLists     # (cap, k) bounded neighbor lists
    alive: torch.Tensor   # (cap,) bool
    n: int                # allocation high-water mark
    d: int                # logical raw feature dim (mips stores d+1)
    cfg: OnlineConfig
    qs: QuantizedStore | None = None   # quantized mirror (precision != f32)
    router: Router | None = None       # coarse routing layer
    mips_m: float = 0.0   # mips augmentation bound M

    @property
    def capacity(self) -> int:
        return self.x.shape[0]

    @property
    def k(self) -> int:
        return self.nl.idx.shape[1]

    @property
    def graph_idx(self) -> torch.Tensor:
        return self.nl.idx

    def live_count(self) -> int:
        return int(self.alive.sum())

    @classmethod
    def from_graph(cls, x, dist, idx, *, cfg: OnlineConfig | None = None,
                   device=None, router_weights=None) -> "MutableKNNStore":
        """Wrap an offline ``build_knn_graph`` result (original ids). ``x``
        is the raw corpus: cfg.metric's reduction is applied here, as the
        build applied it. A configured router is built with
        ``router_weights`` (its (cap,) sample weights) or a generator
        seeded 29. Runs on ``device``, "cuda" unless the caller asks
        otherwise."""
        cfg = cfg or OnlineConfig()
        backend = _backend(cfg)
        device = resolve_device(device, "MutableKNNStore.from_graph")
        x = torch.as_tensor(x, dtype=torch.float32, device=device)
        dist = torch.as_tensor(dist, dtype=torch.float32, device=device)
        idx = torch.as_tensor(idx, dtype=torch.int32, device=device)
        n, d = x.shape
        xt, mips_m = metric_mod.transform_corpus(x, cfg.metric)
        xp = pad_features(xt)
        cap = _next_capacity(n)
        k = idx.shape[1]
        xs = torch.full((cap, xp.shape[1]), _FILL, device=device)
        xs[:n] = xp
        nl = NeighborLists(
            torch.full((cap, k), torch.inf, device=device),
            torch.full((cap, k), -1, dtype=torch.int32, device=device),
            torch.zeros((cap, k), dtype=torch.bool, device=device))
        nl.dist[:n] = dist
        nl.idx[:n] = idx
        alive = torch.zeros((cap,), dtype=torch.bool, device=device)
        alive[:n] = True
        x2 = (xs * xs).sum(dim=1)
        qs = None
        if cfg.precision != "f32":
            qs = quantize.quantize_corpus(
                xs, cfg.precision,
                width=quantize.mirror_width(xt.shape[1], xs.shape[1]))
        router = None
        if cfg.router is not None:
            router = build_router(xs, cfg=cfg.router, weights=router_weights,
                                  alive=alive, x2=x2, backend=backend,
                                  device=device)
        return cls(x=xs, x2=x2, nl=nl, alive=alive, n=n, d=d, cfg=cfg, qs=qs,
                   router=router, mips_m=mips_m)

    @classmethod
    def empty(cls, d: int, *, k: int = 20, cfg: OnlineConfig | None = None,
              device=None) -> "MutableKNNStore":
        """A store with no rows: every search answers empty (+inf, -1) and
        the first ``knn_insert`` acts as a first build (every seed misses,
        so the batch self-join links the graph). A configured router
        attaches through ``ensure_router`` once rows exist; under mips the
        first insert sets ``mips_m``."""
        cfg = cfg or OnlineConfig()
        _backend(cfg)
        device = resolve_device(device, "MutableKNNStore.empty")
        d_t = metric_mod.transformed_dim(d, cfg.metric)
        dp = ceil_to(d_t, 128)
        x = torch.full((8, dp), _FILL, device=device)
        store = cls(
            x=x,
            x2=torch.full((8,), dp * _FILL * _FILL, device=device),
            nl=NeighborLists(
                torch.full((8, k), torch.inf, device=device),
                torch.full((8, k), -1, dtype=torch.int32, device=device),
                torch.zeros((8, k), dtype=torch.bool, device=device)),
            alive=torch.zeros((8,), dtype=torch.bool, device=device),
            n=0, d=d, cfg=cfg)
        if cfg.precision != "f32":
            store = dataclasses.replace(store, qs=quantize.quantize_corpus(
                x, cfg.precision, width=quantize.mirror_width(d_t, dp)))
        return store

    @classmethod
    def build(cls, x, k: int = 20, *, cfg: OnlineConfig | None = None,
              descent: DescentConfig | None = None,
              generator: torch.Generator | None = None,
              device=None) -> tuple["MutableKNNStore", DescentStats]:
        """Offline build (``build_knn_graph``, default ``DescentConfig(k,
        rho=1.0, max_iters=15)``, cfg.metric carried over) and wrap.
        Returns (store, build stats)."""
        cfg = cfg or OnlineConfig()
        dcfg = descent or DescentConfig(k=k, rho=1.0, max_iters=15)
        if dcfg.k != k:
            dcfg = dataclasses.replace(dcfg, k=k)
        if dcfg.metric != cfg.metric:
            dcfg = dataclasses.replace(dcfg, metric=cfg.metric)
        dist, idx, stats = build_knn_graph(x, k=k, cfg=dcfg,
                                           generator=generator, device=device)
        return cls.from_graph(x, dist, idx, cfg=cfg,
                              device=dist.device), stats

    def search(self, queries, *, k_out: int = 10, beam: int = 32,
               rounds: int = 24, generator: torch.Generator | None = None,
               cfg: SearchConfig | None = None, filter_ids=None,
               entry=None, route_fill=None):
        """Batched query path (``graph_search``) that never returns a
        tombstoned or unallocated row. Queries are raw rows (``store.d``
        features); distances come back in the store's transformed space.
        ``cfg`` overrides the SearchConfig built from the arguments and the
        store's knobs; its metric is always the store's. ``filter_ids``
        (rows,) or (q, rows), sized to ``n`` or the capacity (shorter masks
        are padded with False), hides rows like tombstones."""
        if cfg is None:
            cfg = SearchConfig(
                beam=beam, rounds=rounds, expand=self.cfg.seed_expand,
                q_block=self.cfg.q_block, backend=self.cfg.backend,
                precision=self.cfg.precision)
        if cfg.metric != self.cfg.metric:
            cfg = dataclasses.replace(cfg, metric=self.cfg.metric)
        dev = self.x.device
        if filter_ids is not None:
            filter_ids = torch.as_tensor(filter_ids, dtype=torch.bool,
                                         device=dev)
            short = self.capacity - filter_ids.shape[-1]
            if short > 0:
                filter_ids = torch.nn.functional.pad(filter_ids, (0, short),
                                                     value=False)
        q = _pad_to(metric_mod.transform_queries(
            torch.as_tensor(queries, dtype=torch.float32, device=dev),
            self.cfg.metric), self.x.shape[1])
        return graph_search(
            self.x, self.nl.idx, q, k_out=k_out, generator=generator,
            alive=self.alive, x2=self.x2, cfg=cfg, qstore=self.qs,
            router=self.router, filter_ids=filter_ids, device=dev,
            entry=entry, route_fill=route_fill)


def store_from_numpy(x, x2, nl, alive, *, n: int, d: int, cfg: OnlineConfig,
                     mips_m: float = 0.0, qs=None, router=None,
                     device=None) -> MutableKNNStore:
    """A store with the state of a JAX ``MutableKNNStore`` handed over as
    numpy arrays: ``x`` (cap, dp), ``x2``, ``nl`` = (dist, idx, new),
    ``alive``; ``qs`` = (data, scale, x2) of the mirror (bf16 data as a
    bfloat16 or uint16 array of the bits); ``router`` = (centroids, c2,
    graph, (member dist, idx, new), assign, counts, stale). The arrays are
    copied. ``cfg`` is the port's ``OnlineConfig`` of the same values."""
    device = resolve_device(device, "store_from_numpy")

    def t(a, dtype):
        return torch.as_tensor(np.array(a), dtype=dtype, device=device)

    if qs is not None:
        data = np.array(qs[0])
        if data.dtype != np.int8:    # bf16: move the bits
            data = torch.from_numpy(data.view(np.uint16).astype(
                np.int16)).view(torch.bfloat16).to(device)
        else:
            data = torch.as_tensor(data, device=device)
        qs = QuantizedStore(data.contiguous(), t(qs[1], torch.float32),
                            t(qs[2], torch.float32))
    if router is not None:
        router = router_from_numpy(*router, device=device)
    return MutableKNNStore(
        x=t(x, torch.float32).contiguous(), x2=t(x2, torch.float32),
        nl=NeighborLists(t(nl[0], torch.float32), t(nl[1], torch.int32),
                         t(nl[2], torch.bool)),
        alive=t(alive, torch.bool), n=int(n), d=int(d), cfg=cfg, qs=qs,
        router=router, mips_m=float(mips_m))


def _next_capacity(n: int) -> int:
    cap = 8
    while cap < n:
        cap *= 2
    return cap


def _ceil_chunk(f: int, chunk: int, cap: int) -> int:
    """Round a frontier size up to whole padded chunks, capped at cap."""
    return min(cap, ((max(f, 1) + chunk - 1) // chunk) * chunk)


def _pad_to(x: torch.Tensor, dp: int) -> torch.Tensor:
    xp = pad_features(x.to(torch.float32))
    if xp.shape[1] != dp:
        raise ValueError(
            f"feature dim {x.shape[1]} pads to {xp.shape[1]}, store has {dp}")
    return xp.contiguous()


def _grown(store: MutableKNNStore, need: int) -> MutableKNNStore:
    """Double the capacity until ``need`` rows fit: rows, norms, lists,
    alive mask, the quantized mirror and the router's assignments grow
    together."""
    cap = store.capacity
    if need <= cap:
        return store
    new_cap = cap
    while new_cap < need:
        new_cap *= 2
    pad = new_cap - cap
    dp = store.x.shape[1]
    dev = store.x.device

    def grow(t, value, dtype=None):
        tail = torch.full((pad, *t.shape[1:]), value,
                          dtype=dtype or t.dtype, device=dev)
        return torch.cat([t, tail])

    router = store.router
    if router is not None:
        router = router._replace(assign=grow(router.assign, -1))
    return dataclasses.replace(
        store,
        qs=None if store.qs is None else quantize.grow(store.qs, new_cap,
                                                       _FILL),
        router=router,
        x=grow(store.x, _FILL),
        x2=grow(store.x2, dp * _FILL * _FILL),
        nl=NeighborLists(grow(store.nl.dist, torch.inf),
                         grow(store.nl.idx, -1), grow(store.nl.new, False)),
        alive=grow(store.alive, False),
    )


def _frontier_slots(fids: torch.Tensor, recv: torch.Tensor) -> torch.Tensor:
    """Receiver row ids -> their slots in the frontier buffer ``fids``
    (ascending, -1 tail); receivers not on the frontier map to -1."""
    big = torch.iinfo(torch.int32).max
    fs = torch.where(fids >= 0, fids, big).contiguous()
    slot = torch.searchsorted(fs, recv.contiguous())
    slot_c = slot.clamp(0, fids.shape[0] - 1)
    hit = (recv >= 0) & (fs[slot_c] == recv)
    return torch.where(hit, slot_c.to(torch.int32), -1)


def _route_reverse(nl: NeighborLists, fids: torch.Tensor, recv: torch.Tensor,
                   dd: torch.Tensor, src_ids: torch.Tensor, c: int,
                   s_cap: int, backend: str, prefilter: bool):
    """Reverse-edge routing: each frontier receiver inverts its incoming
    incidences (``recv`` (m, w) receiver ids of source rows ``src_ids``,
    distances ``dd``), gathers them, and ``knn_join_select`` keeps the best
    ``c`` under the receiver's k-th distance (``prefilter``). Returns (f, c)
    candidate buffers aligned with ``fids``, for ``heap.merge_rows``."""
    f = fids.shape[0]
    m, w = recv.shape
    lrecv = _frontier_slots(fids, recv.reshape(-1)).reshape(m, w)
    # on overflow keep each receiver's closest incoming edges
    rows_of, slot_of = invert_candidates(lrecv, f, s_cap, prio=dd)
    ok = rows_of >= 0
    lin = torch.where(ok, rows_of * w + slot_of, 0).long()
    gd = torch.where(ok, dd.reshape(-1)[lin], torch.inf)
    gi = torch.where(ok, src_ids[torch.where(ok, rows_of, 0).long()], -1)
    if prefilter:
        safe = torch.where(fids >= 0, fids, 0).long()
        kth = torch.where(fids >= 0, nl.dist[safe, -1], 0.0)
    else:
        kth = torch.full((f,), torch.inf, device=fids.device)
    return ops.knn_join_select(gd.contiguous(), gi.to(torch.int32).contiguous(),
                               kth.contiguous(), c, backend=backend)


# ---------------------------------------------------------------------------
# insert
# ---------------------------------------------------------------------------


def _insert_stitch(x, x2, nl: NeighborLists, alive, q, ids, seed_d, seed_i,
                   cfg: OnlineConfig):
    """Stitch m new rows into (copies of) the store's arrays and run the
    localized refinement. The reverse-edge repair runs on compacted
    frontiers: the 1-hop closure of the new rows for the seed edges, the
    2-hop closure (truncated to ``frontier_mult*m*k`` rows) per round.

    Returns (x, x2, nl, alive, evals, per-round accepted, frontier rows,
    padded rows); the counters are 0-dim tensors."""
    backend = _backend(cfg)
    cap, k = nl.idx.shape
    m = ids.shape[0]
    c = cfg.merge_mult * k
    chunk = max(1, min(cfg.chunk, cap))
    dev = q.device
    q2 = (q * q).sum(dim=1)
    rows = ids.long()

    x, x2, alive = x.clone(), x2.clone(), alive.clone()
    x[rows] = q
    x2[rows] = q2
    alive[rows] = True
    seed_ok = seed_i >= 0
    seed_d = torch.where(seed_ok, seed_d, torch.inf)
    seed_i = torch.where(seed_ok, seed_i, -1).to(torch.int32)
    nl = NeighborLists(nl.dist.clone(), nl.idx.clone(), nl.new.clone())
    nl.dist[rows] = seed_d
    nl.idx[rows] = seed_i
    nl.new[rows] = seed_ok

    zero = torch.zeros((), dtype=torch.int64, device=dev)
    evals, f_rows, p_rows = zero, zero, zero

    # the seed edges reversed: each new point is a candidate of the rows
    # that seeded it. Those receivers sit on the 1-hop closure of the new
    # rows, which fits in m*(k+1) frontier slots: no truncation.
    f_seed = _ceil_chunk(min(cap, m * (k + 1)), chunk, cap)
    s_cap = cfg.route_src or 2 * c
    fids, _ = expand_frontier(nl.idx, ids, hops=1, capacity=f_seed)
    cd, ci = _route_reverse(nl, fids, seed_i, seed_d, ids, c, s_cap,
                            backend, prefilter=False)
    nl, upd0 = heap.merge_rows(nl, fids, cd, ci, backend=backend)
    upds = [upd0.sum()]
    f_rows = f_rows + (fids >= 0).sum()
    p_rows = p_rows + f_seed

    # all-pairs join within the batch (a plain product, as in the JAX
    # package: a streamed batch is often self-similar, and the seed search
    # sees only the rows already stored)
    if cfg.self_join and 1 < m <= cfg.self_join_max:
        d_qq = q2[:, None] + q2[None, :] - 2.0 * (q @ q.T)
        off = ~torch.eye(m, dtype=torch.bool, device=dev)
        d_qq = torch.where(off, d_qq.clamp_min(0.0), torch.inf)
        cand = torch.where(off, ids[None, :].expand(m, m), -1)
        nl, upd_sj = heap.merge_rows(nl, ids, d_qq, cand, backend=backend)
        evals = evals + m * (m - 1) // 2
        upds[-1] = upds[-1] + upd_sj.sum()
        f_rows = f_rows + m
        p_rows = p_rows + m

    # localized NN-Descent: friend-of-a-friend rounds over the frontier
    f_rev = _ceil_chunk(min(cap, cfg.frontier_mult * m * k), chunk, cap)
    for _ in range(cfg.refine_rounds):
        ni = nl.idx[rows]                                    # (m, k)
        cand = nl.idx[ni.clamp(0, cap - 1).long()].reshape(m, k * k)
        # this round's reverse receivers sit on the 2-hop closure
        fids_r, _ = expand_frontier(nl.idx, ids, hops=2, capacity=f_rev,
                                    alive=alive)
        src_ok = (ni >= 0)[:, :, None].expand(m, k, k).reshape(m, k * k)
        ok = (src_ok & (cand >= 0) & alive[cand.clamp(0, cap - 1).long()]
              & (cand != ids[:, None]))
        ok &= ~(cand[:, :, None] == ni[:, None, :]).any(-1)  # linked already
        cand = torch.where(ok, cand, -1).contiguous()
        # q2 + x2[cand] - 2 q.x, clamped at 0, +inf on -1: the search tile
        # gathers the candidate rows itself
        dd = ops.knn_search_dists(q, q2, x, x2, cand, backend=backend)
        evals = evals + ok.sum()
        # forward: candidates into the new rows' lists
        nl, upd_f = heap.merge_rows(nl, ids, dd, cand, backend=backend)
        # reverse: the new point is a candidate of every touched row it
        # beats (the receiver's k-th prefilter, inside the select kernel)
        cd, ci = _route_reverse(nl, fids_r, cand, dd, ids, c, s_cap,
                                backend, prefilter=True)
        nl, upd_r = heap.merge_rows(nl, fids_r, cd, ci, backend=backend)
        upds.append(upd_f.sum() + upd_r.sum())
        f_rows = f_rows + m + (fids_r >= 0).sum()
        p_rows = p_rows + m + f_rev
    return x, x2, nl, alive, evals, torch.stack(upds), f_rows, p_rows


def knn_insert(store: MutableKNNStore, new_points, *,
               generator: torch.Generator | None = None, entry=None,
               route_fill=None) -> tuple[MutableKNNStore, DescentStats]:
    """Insert ``new_points`` (m, d), raw rows (the store's metric reduction
    is applied here; under mips a store that started empty takes its bound
    from this batch). Deterministic given ``generator`` (on the store's
    device; a fresh one seeded 0 if None), which draws the seed search's
    entries and, when a router rebuild is due, its sample. ``entry``
    ((beam,) ids) or, with a router, ``route_fill`` ((t*m,) ids) replaces
    the seed search's draw.

    Returns (store, stats); ``stats.dist_evals`` is an upper bound (the
    seed search's term is the analytic beam + rounds*k per point, the
    refinement's is exact)."""
    cfg = store.cfg
    backend = _backend(cfg)
    k = store.k
    dev = store.x.device
    new_points = torch.as_tensor(new_points, dtype=torch.float32, device=dev)
    m = int(new_points.shape[0])
    if m == 0:
        return store, DescentStats(iters=0, dist_evals=0)
    if new_points.shape[1] != store.d:
        raise ValueError(f"new points have dim {new_points.shape[1]}, store "
                         f"has {store.d}")
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    mips_m = store.mips_m
    if cfg.metric == "mips" and store.n == 0 and mips_m == 0.0:
        mips_m = metric_mod.mips_max_norm(new_points)
        store = dataclasses.replace(store, mips_m=mips_m)
    new_t, _ = metric_mod.transform_corpus(
        new_points, cfg.metric,
        mips_m=mips_m if cfg.metric == "mips" else None)
    q = _pad_to(new_t, store.x.shape[1])
    store = _grown(store, store.n + m)
    ids = torch.arange(store.n, store.n + m, dtype=torch.int32, device=dev)

    beam = max(cfg.beam, k)
    scfg = SearchConfig(
        beam=beam, rounds=cfg.seed_rounds, expand=cfg.seed_expand,
        q_block=cfg.q_block, backend=cfg.backend, precision=cfg.precision,
        metric=cfg.metric)
    seed_d, seed_i = graph_search(
        store.x, store.nl.idx, q, k_out=k, generator=generator,
        alive=store.alive, x2=store.x2, cfg=scfg, qstore=store.qs,
        router=store.router, entry=entry, route_fill=route_fill, device=dev)
    # the analytic bound: beam entry distances plus k per expanded node
    # (the fused path expands seed_expand nodes a round, so the budget
    # rounds up to whole rounds; ref expands exactly seed_rounds); a
    # quantized seed search re-ranks its pool in fp32, beam more
    quant = scfg.precision != "f32" and scfg.backend != "ref"
    seed_evals = m * ((2 if quant else 1) * beam
                      + (cfg.seed_rounds if cfg.backend == "ref"
                         else scfg.n_rounds * cfg.seed_expand) * k)

    x, x2, nl, alive, evals, upds, f_rows, p_rows = _insert_stitch(
        store.x, store.x2, store.nl, store.alive, q, ids, seed_d, seed_i,
        cfg)
    qs = store.qs if store.qs is None else quantize.update_rows(store.qs,
                                                                ids, q)
    router = store.router
    if router is not None:
        router = router_insert(router, ids, q, backend=backend)
        router = _maybe_rebuild_router(router, x, x2, alive, cfg, generator)
    counts = torch.cat([torch.stack([evals, f_rows, p_rows]),
                        upds.to(torch.int64)]).tolist()     # one sync
    stats = DescentStats(
        iters=cfg.refine_rounds, dist_evals=seed_evals + counts[0],
        updates=tuple(counts[3:]), frontier_rows=counts[1],
        padded_rows=counts[2])
    return dataclasses.replace(store, x=x, x2=x2, nl=nl, alive=alive,
                               n=store.n + m, qs=qs, router=router), stats


def _maybe_rebuild_router(router: Router, x, x2, alive, cfg: OnlineConfig,
                          generator: torch.Generator | None) -> Router:
    """Lazy drift rebuild: past the drift threshold the centroids are refit.
    A rebuild that cannot run (an injected fault at ``router.rebuild``, an
    I/O error, or the card out of memory) warns and keeps serving the
    stale router, which is still a correct entry-point heuristic; the next
    mutation past the threshold tries again. Any other error, a kernel's
    included, propagates."""
    rcfg = cfg.router or RouterConfig()
    if needs_rebuild(router, int(alive.sum()), rcfg):
        try:
            faults.maybe_raise("router.rebuild")
            return build_router(x, cfg=rcfg, generator=generator,
                                alive=alive, x2=x2, backend=_backend(cfg),
                                device=x.device)
        except (OSError, torch.cuda.OutOfMemoryError) as e:
            warnings.warn(f"router rebuild failed ({e}); serving continues "
                          "from the stale router", RuntimeWarning,
                          stacklevel=2)
    return router


def ensure_router(store: MutableKNNStore, rcfg: RouterConfig | None = None,
                  *, generator: torch.Generator | None = None
                  ) -> MutableKNNStore:
    """Attach a router to a store that has none (idempotent). It clusters
    the store's transformed rows, so it is right under any metric. The
    sample draws from ``generator`` (seeded 29 if None)."""
    if store.router is not None:
        return store
    rcfg = rcfg or store.cfg.router or RouterConfig()
    return dataclasses.replace(
        store, cfg=dataclasses.replace(store.cfg, router=rcfg),
        router=build_router(store.x, cfg=rcfg, generator=generator,
                            alive=store.alive, x2=store.x2,
                            backend=_backend(store.cfg),
                            device=store.x.device))


# ---------------------------------------------------------------------------
# delete
# ---------------------------------------------------------------------------


def _delete_need(idx: torch.Tensor, alive: torch.Tensor) -> torch.Tensor:
    """Rows to compact after a tombstone: rows that list a dead id, and
    dead rows that still hold a list. One O(n*k) integer scan."""
    cap = alive.shape[0]
    valid = idx >= 0
    dead_tgt = valid & ~alive[idx.clamp(0, cap - 1).long()]
    return dead_tgt.any(dim=1) | (valid.any(dim=1) & ~alive)


def _refill_chunk(x, x2, nl: NeighborLists, idx0, alive, rows, removed,
                  backend: str):
    """Refill one padded chunk of affected rows from their surviving
    neighbors' lists (one friend-of-a-friend round). Candidates come from
    the post-purge snapshot ``idx0``, so the order of the chunks cannot
    change the result. Returns (nl, evals, accepted, orphans), counters as
    0-dim tensors."""
    cap, k = nl.idx.shape
    f = rows.shape[0]
    ok_row = rows >= 0
    safe = torch.where(ok_row, rows, 0).long()
    refill = ok_row & alive[safe] & (removed > 0)
    ni = idx0[safe]                                          # (f, k)
    nb = idx0[ni.clamp(0, cap - 1).long()].reshape(f, k * k)
    src_ok = (ni >= 0)[:, :, None].expand(f, k, k).reshape(f, k * k)
    ok = (refill[:, None] & src_ok & (nb >= 0)
          & alive[nb.clamp(0, cap - 1).long()] & (nb != safe[:, None]))
    ok &= ~(nb[:, :, None] == ni[:, None, :]).any(-1)
    cand = torch.where(ok, nb, -1).contiguous()
    dd = ops.knn_search_dists(x[safe], x2[safe], x, x2, cand,
                              backend=backend)
    nl, upd = heap.merge_rows(nl, rows, dd, cand, backend=backend)
    orphan = ok_row & alive[safe] & ~(nl.idx[safe] >= 0).any(dim=1)
    return nl, ok.sum(), upd.sum(), orphan.sum()


def _reconnect_orphans(x, x2, nl: NeighborLists, alive, merge_c: int):
    """Re-anchor orphans (live rows whose whole neighborhood died, so there
    is nothing to refill from) to the k lowest live non-orphan rows, both
    ways. Rare, so a dense pass with plain merges; the reverse edges keep
    ``compact_pairs`` (every orphan targets the same k anchors, so the
    in-degree is unbounded). Returns (nl, evals, accepted)."""
    cap, k = nl.idx.shape
    dev = x.device
    rows = torch.arange(cap, dtype=torch.int32, device=dev)
    orphan = alive & ~(nl.idx >= 0).any(dim=1)
    score = torch.where(alive & ~orphan, (cap - rows).to(torch.float32), -1.0)
    anchors = torch.sort(score, descending=True, stable=True).indices[:k]
    ok2 = (orphan[:, None] & alive[anchors][None, :]
           & ~orphan[anchors][None, :] & (anchors[None, :] != rows[:, None]))
    # a plain product, as in the JAX package (TF32 off on a card)
    dd2 = x2[:, None] + x2[anchors][None, :] - 2.0 * (x @ x[anchors].T)
    dd2 = torch.where(ok2, dd2.clamp_min(0.0), torch.inf)
    anc = torch.where(ok2, anchors.to(torch.int32)[None, :].expand(cap, k),
                      -1)
    nl, upd2 = heap.merge(nl, dd2, anc)
    src = rows[:, None].expand(cap, k).reshape(-1)
    cd, ci = compact_pairs(anc.reshape(-1), src, dd2.reshape(-1), cap,
                           merge_c)
    nl, upd3 = heap.merge(nl, cd, ci)
    return nl, ok2.sum(), upd2.sum() + upd3.sum()


def knn_delete(store: MutableKNNStore,
               ids) -> tuple[MutableKNNStore, DescentStats]:
    """Tombstone ``ids`` and patch every list that pointed at them. Deleted
    rows are never returned by ``store.search`` and never re-enter a list;
    their slots are not reused.

    The purge and the refill run over the compacted frontier of affected
    rows (rows listing a dead id, and the dead rows themselves), in
    ``cfg.chunk``-row padded chunks; ``cfg.frontier=False`` processes every
    allocated row instead (the dense baseline, same result). A router is
    maintained first, and refit (from a generator seeded by the batch
    size) when its drift passes the threshold."""
    cfg = store.cfg
    backend = _backend(cfg)
    dev = store.x.device
    ids = torch.as_tensor(ids, dtype=torch.int32, device=dev).reshape(-1)
    alive = store.alive.clone()
    alive[ids.long()] = False
    cap = store.capacity
    chunk = max(1, min(cfg.chunk, cap))

    router = store.router
    if router is not None:
        router = router_delete(router, ids, alive, backend=backend)
        router = _maybe_rebuild_router(
            router, store.x, store.x2, alive, cfg,
            torch.Generator(device=dev).manual_seed((31 << 32)
                                                    + ids.shape[0]))

    if cfg.frontier:
        need = torch.nonzero(_delete_need(store.nl.idx, alive))[:, 0]
        f = need.shape[0]                                 # one host sync
        if f == 0:
            return (dataclasses.replace(store, alive=alive, router=router),
                    DescentStats(iters=0, dist_evals=0, frontier_rows=0,
                                 padded_rows=0))
        n_chunks = (f + chunk - 1) // chunk
        fids = torch.nn.functional.pad(need.to(torch.int32),
                                       (0, n_chunks * chunk - f), value=-1)
    else:
        f = store.n
        n_chunks = (f + chunk - 1) // chunk
        ar = torch.arange(n_chunks * chunk, dtype=torch.int32, device=dev)
        fids = torch.where(ar < f, ar, -1)

    nl = store.nl
    removed = []
    for j in range(n_chunks):
        nl, rm = heap.purge_rows(nl, fids[j * chunk:(j + 1) * chunk], alive,
                                 backend=backend)
        removed.append(rm)

    idx0 = nl.idx      # post-purge snapshot: every refill chunk reads it
    evals, upd, orphans = [], [], []
    for j in range(n_chunks):
        nl, ev, up, orp = _refill_chunk(
            store.x, store.x2, nl, idx0, alive,
            fids[j * chunk:(j + 1) * chunk], removed[j], backend)
        evals.append(ev)
        upd.append(up)
        orphans.append(orp)
    evals, upd = torch.stack(evals).sum(), torch.stack(upd).sum()
    if int(torch.stack(orphans).sum()) > 0:
        nl, ev2, up2 = _reconnect_orphans(store.x, store.x2, nl, alive,
                                          cfg.merge_mult * store.k)
        evals, upd = evals + ev2, upd + up2
    evals, upd = torch.stack([evals, upd]).tolist()
    stats = DescentStats(iters=1, dist_evals=evals, updates=(upd,),
                         frontier_rows=f, padded_rows=n_chunks * chunk)
    return dataclasses.replace(store, nl=nl, alive=alive,
                               router=router), stats
