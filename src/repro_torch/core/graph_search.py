"""Query-time search over a built K-NN graph — fused, batched, blocked.

Given the NN-Descent graph, answer nearest-neighbor queries by beam search
restricted to the graph (NSW/NSG-style, fixed shapes). Three backends
behind ``SearchConfig.backend``:

  * **auto** — the fused path through the kernels on a card (their plain
    versions for tensors on the CPU). Queries run in blocks of
    ``q_block``; each round expands the top-``expand`` unexpanded pool
    nodes of every query in the block at once (``ops.knn_join_select``
    with kth = +inf picks them), scores the E*k neighbors of those nodes
    in one (q_block, E*k) tile (``ops.knn_search_dists``, which gathers
    the rows itself), reduces the tile under the pool's k-th distance to
    the best ``select_c`` (``ops.knn_join_select``), and merges them into
    the pool (``heap.merge_kernel`` / ``ops.knn_merge``, dedup by id) with
    the NeighborLists ``new`` flag reused as "not yet expanded". The loop
    stops after ceil(rounds/expand) rounds, or earlier when no query of
    the block has an unexpanded pool entry left (one host sync a round).
  * **plain** — the same fused path through the plain versions, on any
    device (a reference search on the card).
  * **ref** — the one-node-per-round greedy loop, the parity oracle, with
    the batch dimension written out and full stable sorts.

``rounds`` is the expansion budget (pool nodes expanded per query) under
every backend. Entry points: ``entry`` (e,) shared or (q, e) per query
(-1 = hole); without it, a draw uniform over live (and filter-admitted)
rows from ``generator``, or from a generator seeded by the batch's
content (``_batch_key``). The metric rides core/metric.py's input-side
reductions: the corpus handed in must already be transformed; queries are
transformed here. ``filter_ids`` (n,) is folded into ``alive``; (q, n)
masks candidates per query, so a filtered-out id can never surface.

``precision`` "int8" or "bf16" makes the fused search two-stage: the
query block is quantized once at the corpus mirror's width (a cached
``qstore`` of the same mode, or one quantized here), seeds and every round
score on the mirror (``ops.knn_search_dists_q8`` / ``_bf16``; shared seeds
by one plain matrix product of the codes), and the final pool is re-ranked
with the fp32 ``knn_search_dists`` before ``knn_join_select`` picks k_out,
so a returned distance is always fp32. ``backend="ref"`` ignores
precision.

With a ``router`` (core/router.py) and ``cfg.router`` not "off", the fused
path seeds every query with the members of its top-``router_t`` centroids
(t*m of them, IVF-style); dead or missing members are filled from a random
draw. The seeds go into the pool in one merge, whatever their width.
``expand_frontier`` is the online store's update frontier
(core/online.py).
"""
from __future__ import annotations

import dataclasses
import time
import warnings

import torch

from repro_torch.core import heap, quantize
from repro_torch.core import metric as metric_mod
from repro_torch.core.device import resolve_device
from repro_torch.core.heap import NeighborLists
from repro_torch.core.quantize import QuantizedStore
from repro_torch.kernels import ops

_BIG = 3.0e38    # the greedy oracle's empty-slot distance (the fused path
                 # uses +inf, as the JAX package does)
BACKENDS = ("auto", "plain", "ref")


@dataclasses.dataclass(frozen=True)
class SearchConfig:
    beam: int = 32          # pool width per query
    rounds: int = 24        # expansion budget: pool nodes expanded/query
    expand: int = 4         # E: nodes expanded per round (fused path)
    q_block: int = 256      # queries per fused block
    backend: str = "auto"   # auto: kernels on a card, plain versions on
                            # the CPU; plain: plain versions anywhere;
                            # ref: the greedy one-node-per-round oracle
    select_c: int = 0       # candidate width handed to the pool merge
                            # (0 = beam)
    precision: str = "f32"  # f32 | bf16 | int8: candidate-scoring dtype
    metric: str = "l2"      # l2 | cosine | mips (core/metric.py); the
                            # corpus must be pre-transformed
    router: str = "auto"    # "off" ignores a router handed in (random
                            # entries); otherwise the fused path seeds
                            # from it
    router_t: int = 4       # centroids probed per query (routed seeds)
    strict: bool = False    # True rejects a batch with NaN/Inf rows;
                            # False zeroes them and returns (+inf, -1)
                            # for them with a RuntimeWarning
    max_rounds_deadline: float = 0.0
                            # per-q_block time slice in seconds; 0 = off.
                            # Once the batch has spent its cumulative
                            # slice, the remaining blocks run one fused
                            # round (rounds=expand): degraded recall,
                            # never a stall
    fixed_block: bool = False
                            # True pads every batch to the full q_block;
                            # False runs it at its q_block_bucket step

    @property
    def n_rounds(self) -> int:
        """Fused sequential depth: ceil(rounds / expand)."""
        return max(1, -(-self.rounds // self.expand))


def q_block_bucket(nq: int, cfg: SearchConfig) -> int:
    """The query-block shape a batch of ``nq`` queries runs at: the next
    power of two, capped at ``cfg.q_block`` (``cfg.fixed_block`` pins the
    full block)."""
    if cfg.fixed_block or nq <= 0:
        return max(1, cfg.q_block)
    return max(1, min(cfg.q_block, 1 << (nq - 1).bit_length()))


def _check_cfg(cfg: SearchConfig) -> None:
    if cfg.backend not in BACKENDS:
        raise ValueError(f"unknown backend {cfg.backend!r}; expected "
                         f"{BACKENDS}")


def expand_frontier(
    graph_idx: torch.Tensor,   # (n, k) neighbor ids, -1 = empty
    seeds: torch.Tensor,       # (s,) seed row ids, -1 = padding
    *,
    hops: int = 1,
    capacity: int,
    alive: torch.Tensor | None = None,   # (n,) bool: rows to keep
) -> tuple[torch.Tensor, torch.Tensor]:
    """The h-hop outbound closure of ``seeds`` over the graph, compacted
    into a padded id buffer: the online store's update frontier.

    Returns (ids (capacity,) i32 ascending with a -1 tail, mask (n,) bool).
    When the closure exceeds ``capacity`` the rows nearest the seeds
    (fewest hops, then lowest id) are kept; the mask is exact either way.
    Pure topology: O(n*k) integer work and no distance. The hop counts are
    a scatter-min into a buffer with one extra slot, n, where padding and
    empty slots land (JAX's mode="drop")."""
    n = graph_idx.shape[0]
    dev = graph_idx.device
    hop = torch.full((n + 1,), hops + 1, dtype=torch.int32, device=dev)

    def reach(tgt: torch.Tensor, h: int) -> None:
        tgt = torch.where((tgt >= 0) & (tgt < n), tgt, n).reshape(-1).long()
        hop.scatter_reduce_(0, tgt, torch.full_like(tgt, h,
                                                    dtype=torch.int32),
                            "amin")

    reach(seeds, 0)
    for h in range(1, hops + 1):
        reach(torch.where(hop[:n, None] < h, graph_idx, -1), h)
    hop = hop[:n]
    mask = hop <= hops
    if alive is not None:
        mask &= alive
    big = torch.iinfo(torch.int32).max
    kcap = min(capacity, n)
    # (hop, id) packed into one int32 key: (hops + 2) * n stays far inside
    # int32 for every store size the port supports
    score = torch.where(
        mask, hop * n + torch.arange(n, dtype=torch.int32, device=dev), big)
    sel = torch.sort(score).values[:kcap]
    ids = torch.sort(torch.where(sel < big, sel % n, n)).values
    ids = torch.where(ids < n, ids, -1).to(torch.int32)
    if kcap < capacity:
        ids = torch.cat([ids, ids.new_full((capacity - kcap,), -1)])
    return ids, mask


# ---------------------------------------------------------------------------
# entry-point seeding
# ---------------------------------------------------------------------------


def _batch_key(queries: torch.Tensor) -> int:
    """A 64-bit seed from the batch's content: the bits of the plain
    feature sum and of a position-weighted sum (bounded cos weights, so
    the positional term survives f32 accumulation). A permuted batch
    shares the first half but not the second. Deterministic on one device;
    it does not reproduce the JAX package's key."""
    flat = queries.float().reshape(-1)
    pos = torch.arange(flat.shape[0], dtype=torch.float32,
                       device=flat.device)
    sums = torch.stack([flat.sum(), (flat * torch.cos(pos * 1.6180339)).sum()])
    h1, h2 = (int(v) & 0xFFFFFFFF for v in sums.view(torch.int32).tolist())
    return (h1 << 32) | h2


def _draw_entries(generator: torch.Generator, n: int, beam: int,
                  alive: torch.Tensor | None) -> torch.Tensor:
    """min(beam, n) entries, uniform over live rows, WITHOUT replacement:
    the top-k of one uniform weight per row (dead rows weigh -1)."""
    w = torch.rand(n, generator=generator, device=generator.device)
    if alive is not None:
        w = torch.where(alive, w, -1.0)
    return torch.topk(w, min(beam, n)).indices.to(torch.int32)


def _generator(generator, queries: torch.Tensor) -> torch.Generator:
    if generator is not None:
        return generator
    return torch.Generator(device=queries.device).manual_seed(
        _batch_key(queries))


# ---------------------------------------------------------------------------
# public dispatcher
# ---------------------------------------------------------------------------


def _admit_queries(queries: torch.Tensor, d: int, strict: bool):
    """Admission at the search boundary: one non-finite distance poisons
    every merge it touches. Returns (queries, bad_rows (q,) bool or None).
    ``strict`` rejects non-finite rows; a feature-dim mismatch always
    rejects."""
    if queries.shape[0] == 0:
        return queries, None
    if queries.dim() != 2 or queries.shape[1] != d:
        raise ValueError(
            f"query batch has shape {tuple(queries.shape)}; corpus rows "
            f"have feature dim {d} — rejecting the batch at admission")
    finite = torch.isfinite(queries).all(dim=1)
    n_bad = int((~finite).sum())
    if n_bad == 0:
        return queries, None
    if strict:
        raise ValueError(
            f"query batch contains {n_bad} non-finite row(s) (NaN/Inf) — "
            "rejected (SearchConfig.strict=True)")
    warnings.warn(
        f"sanitized {n_bad} non-finite query row(s); their results are "
        "empty (+inf/-1)", RuntimeWarning, stacklevel=3)
    return torch.where(finite[:, None], queries, 0.0), ~finite


def _mask_bad_rows(dist, idx, bad_rows):
    """Overwrite sanitized rows' outputs with the empty-slot sentinel."""
    if bad_rows is None:
        return dist, idx
    return (torch.where(bad_rows[:, None], torch.inf, dist),
            torch.where(bad_rows[:, None], -1, idx))


def graph_search(
    x,                     # (n, d) corpus (feature-padded ok)
    graph_idx,             # (n, k) neighbor ids
    queries,               # (q, d)
    *,
    k_out: int = 10,
    beam: int = 32,
    rounds: int = 24,
    entry=None,            # (e,) shared or (q, e) per-query entry ids
    generator: torch.Generator | None = None,
    alive=None,            # (n,) bool — tombstone mask
    x2=None,               # (n,) cached squared norms
    cfg: SearchConfig | None = None,
    qstore: QuantizedStore | None = None,   # cached quantized corpus
    router=None,           # core.router.Router: routed seeds
    filter_ids=None,       # (n,) shared or (q, n) per-query bool mask
    device=None,
    route_fill=None,       # (t*m,) ids filling routed holes (else drawn)
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (dist (q, k_out) f32, idx (q, k_out) i32) ascending; empty
    slots are (+inf, -1).

    ``cfg`` wins over the legacy ``beam``/``rounds`` arguments. Dead rows
    (``alive`` False) and filtered rows are never seeded, expanded or
    returned. Without ``entry``, entries are drawn from ``generator`` (on
    ``device``), or from one seeded by the batch's content. With a
    quantized ``cfg.precision``, ``qstore`` is the corpus mirror to score
    on; one of another mode, or none, is quantized here from ``x``. With a
    ``router`` (and no ``entry``), the fused path seeds from it; its holes
    take ``route_fill`` or a draw from ``generator``. Runs
    on ``device``, "cuda" unless the caller asks otherwise; with no card
    present that raises."""
    if cfg is None:
        cfg = SearchConfig(beam=beam, rounds=rounds)
    _check_cfg(cfg)
    device = resolve_device(device, "graph_search")

    def on_dev(t, dtype):
        return None if t is None else torch.as_tensor(t, dtype=dtype,
                                                       device=device)

    x = on_dev(x, torch.float32).contiguous()
    graph_idx = on_dev(graph_idx, torch.int32)
    queries = on_dev(queries, torch.float32)
    entry, alive = on_dev(entry, torch.int32), on_dev(alive, torch.bool)
    x2, filter_ids = on_dev(x2, torch.float32), on_dev(filter_ids, torch.bool)

    narrow = queries.dim() == 2 and queries.shape[1] < x.shape[1]
    if cfg.metric != "mips" or narrow:
        # a mips batch at the corpus width was transformed by its caller
        queries = metric_mod.transform_queries(queries, cfg.metric)
    if cfg.metric == "mips" and narrow:
        # the augmented coordinate is 0, so the rest is feature padding
        queries = torch.nn.functional.pad(
            queries, (0, x.shape[1] - queries.shape[1]))
    queries, bad_rows = _admit_queries(queries, x.shape[1], cfg.strict)
    queries = queries.contiguous()
    nq = queries.shape[0]
    n = graph_idx.shape[0]
    filt = None
    if filter_ids is not None:
        if filter_ids.shape[-1] != n:
            raise ValueError(f"filter_ids covers {filter_ids.shape[-1]} "
                             f"rows; the graph has {n}")
        if filter_ids.dim() == 1:
            # a shared predicate is a tombstone mask for this call
            alive = filter_ids if alive is None else alive & filter_ids
        else:
            filt = filter_ids
    if n == 0:
        # empty corpus: every query gets the empty result
        return (torch.full((nq, k_out), torch.inf, device=device),
                torch.full((nq, k_out), -1, dtype=torch.int32,
                           device=device))
    if x2 is None:
        x2 = (x * x).sum(dim=1)
    x2 = x2.contiguous()
    ops_backend = "ref" if cfg.backend == "plain" else "auto"
    if entry is None and router is not None and cfg.router != "off" \
            and cfg.backend != "ref" and nq > 0:
        entry = _routed_entries(router, queries, n, alive, cfg, ops_backend,
                                route_fill, generator)
    elif entry is None:
        generator = _generator(generator, queries)
        entry = _draw_entries(generator, n, cfg.beam, alive)
    if filt is not None:
        # per-query predicates need per-query entries: broadcast shared
        # seeds, drop the seeds a query's filter rejects, and refill the
        # holes from a draw over each query's admitted live rows (the
        # same sampling without replacement as _draw_entries)
        if entry.dim() == 1:
            entry = entry[None, :].expand(nq, -1)
        fok = torch.gather(filt, 1, entry.clamp(0, n - 1).long())
        entry = torch.where((entry >= 0) & fok, entry, -1)
        generator = _generator(generator, queries)
        w = torch.rand(n, generator=generator, device=generator.device)
        if alive is not None:
            w = torch.where(alive, w, -1.0)
        fd, fent = torch.topk(torch.where(filt, w[None, :], -1.0),
                              min(entry.shape[1], n), dim=1)
        fent = torch.where(fd >= 0.0, fent, -1).to(torch.int32)
        if fent.shape[1] < entry.shape[1]:
            fent = torch.nn.functional.pad(
                fent, (0, entry.shape[1] - fent.shape[1]), value=-1)
        entry = torch.where(entry >= 0, entry, fent)

    if cfg.precision == "f32" or cfg.backend == "ref":
        qstore = None
    elif qstore is None or qstore.mode != cfg.precision:
        # a mirror of the other mode would be scored as raw codes by the
        # wrong kernel: quantize afresh
        qstore = quantize.quantize_corpus(x, cfg.precision)
    else:
        qstore = QuantizedStore(*(t.to(device).contiguous() for t in qstore))

    if cfg.backend == "ref":
        rd, ri = _graph_search_ref(
            x, x2, graph_idx, queries, entry, alive, filt,
            k_out=k_out, beam=cfg.beam, rounds=cfg.rounds)
        return _mask_bad_rows(rd, ri, bad_rows)

    # fused path: pad the batch to whole blocks of its bucket, run the
    # block search per block, slice the pad off
    if nq == 0:
        return (torch.zeros((0, k_out), device=device),
                torch.full((0, k_out), -1, dtype=torch.int32,
                           device=device))
    qb = q_block_bucket(nq, cfg)
    pad = (-nq) % qb
    qp = torch.nn.functional.pad(queries, (0, 0, 0, pad))
    q2 = (qp * qp).sum(dim=1)
    if entry.dim() == 2:     # per-query seeds ride along with their block
        entry = torch.nn.functional.pad(entry, (0, 0, 0, pad), value=-1)
    if filt is not None:     # pad queries admit everything (sliced off)
        filt = torch.nn.functional.pad(filt, (0, 0, 0, pad), value=True)
    # deadline: once the batch has spent its cumulative per-block slice,
    # the remaining blocks run one fused round (rounds = expand)
    deadline = cfg.max_rounds_deadline
    cut_cfg = dataclasses.replace(cfg, rounds=cfg.expand)
    t0 = time.monotonic()
    outs_d, outs_i = [], []
    for bi, s in enumerate(range(0, nq + pad, qb)):
        bcfg = cfg
        if deadline > 0.0 and bi > 0 \
                and time.monotonic() - t0 > deadline * bi:
            bcfg = cut_cfg
        ent_b = entry if entry.dim() == 1 else entry[s:s + qb]
        od, oi = _search_block(
            x, x2, graph_idx, qp[s:s + qb], q2[s:s + qb], ent_b, alive,
            None if filt is None else filt[s:s + qb], qstore,
            k_out=k_out, cfg=bcfg, backend=ops_backend)
        if deadline > 0.0 and od.is_cuda:
            torch.cuda.synchronize(od.device)
        outs_d.append(od)
        outs_i.append(oi)
    out_d = torch.cat(outs_d)[:nq]
    out_i = torch.cat(outs_i)[:nq]
    return _mask_bad_rows(out_d, out_i, bad_rows)


def _routed_entries(router, queries, n, alive, cfg, backend, fill,
                    generator) -> torch.Tensor:
    """(q, width) routed seeds: the full member lists of each query's top-t
    centroids (width = t*m, at least beam, at most n; wider probing costs
    one wider seed tile, never a wider traversal), dead members dropped,
    holes filled from ``fill`` or a draw of ``width`` live rows."""
    from repro_torch.core.router import route_entries
    t = min(cfg.router_t, router.centroids.shape[0])
    width = min(max(cfg.beam, t * router.members.idx.shape[1]), n)
    ent = route_entries(router, queries, width, t=cfg.router_t,
                        backend=backend)
    if alive is not None:
        ent = torch.where(
            (ent >= 0) & alive[ent.clamp(0, n - 1).long()], ent, -1)
    if fill is None:
        fill = _draw_entries(_generator(generator, queries), n, width, alive)
    fill = torch.as_tensor(fill, dtype=torch.int32, device=ent.device)
    return torch.where(ent >= 0, ent, fill[None, :])


def _seed_merge(pool: NeighborLists, ed: torch.Tensor, eids: torch.Tensor,
                backend: str) -> NeighborLists:
    """Merge the (qb, e) seeds into the empty pool, in one merge."""
    ed = torch.where(eids >= 0, ed, torch.inf)
    pool, _ = heap.merge_kernel(pool, ed.contiguous(), eids.contiguous(),
                                backend=backend)
    return pool


# ---------------------------------------------------------------------------
# fused batched multi-expansion search
# ---------------------------------------------------------------------------


def _search_block(
    x: torch.Tensor,          # (n, dp) f32 corpus
    x2: torch.Tensor,         # (n,) corpus squared norms
    graph_idx: torch.Tensor,  # (n, k) i32
    q: torch.Tensor,          # (qb, dp) f32 query block
    q2: torch.Tensor,         # (qb,) query squared norms
    entry: torch.Tensor,      # (e,) shared or (qb, e) per-query entry ids
    alive: torch.Tensor | None,
    filt: torch.Tensor | None,   # (qb, n) per-query predicate mask
    qstore: QuantizedStore | None,   # corpus mirror (quantized precision)
    *,
    k_out: int,
    cfg: SearchConfig,
    backend: str,             # ops backend: auto | ref
) -> tuple[torch.Tensor, torch.Tensor]:
    """One query block of the fused search (see the module docstring).
    ``filt`` masks candidates exactly like ``alive``, per query row."""
    n, k = graph_idx.shape
    qb = q.shape[0]
    beam, e = cfg.beam, cfg.expand
    c_sel = cfg.select_c or beam
    dev = q.device

    # quantized scoring: the query block is quantized once, at the
    # mirror's width, and the whole traversal (seeds, tiles, the pool's
    # k-th prefilter) runs on quantized distances; the pool is re-ranked
    # in fp32 after the rounds
    quant = qstore is not None
    if quant:
        qq = quantize.quantize_corpus(q, qstore.mode,
                                      width=qstore.data.shape[1])

    def tile(ids):            # (qb, m) candidate ids -> (qb, m) distances
        if not quant:
            return ops.knn_search_dists(q, q2, x, x2, ids, backend=backend)
        if qstore.mode == "int8":
            return ops.knn_search_dists_q8(
                qq.data, qq.scale, qq.x2, qstore.data, qstore.scale,
                qstore.x2, ids, backend=backend)
        return ops.knn_search_dists_bf16(qq.data, qq.x2, qstore.data,
                                         qstore.x2, ids, backend=backend)

    # seed the pool: every entry's distance, then one bounded merge
    # (dedups repeated entries, drops dead ones)
    ent = entry.clamp(0, n - 1).long()
    if entry.dim() == 2:
        # per-query seeds go through the search tile: -1 holes come back
        # +inf and vanish in the merge
        eids = entry
        if alive is not None:
            eids = torch.where(alive[ent], eids, -1)
        if filt is not None:
            eids = torch.where(torch.gather(filt, 1, ent), eids, -1)
        eids = eids.contiguous()
        ed = tile(eids)
    else:
        # shared seeds: one plain matrix product (outside any kernel in
        # the JAX package as well); on the mirror, of the codes (exact:
        # integers, or bf16 values, summed in f32)
        if quant:
            ab = qq.data.to(torch.float32) @ qstore.data[ent].to(
                torch.float32).T
            ab = (qq.scale[:, None] * qstore.scale[ent][None, :]) * ab
            ed = (qq.x2[:, None] + qstore.x2[ent][None, :]
                  - 2.0 * ab).clamp_min(0.0)
        else:
            ed = (q2[:, None] + x2[ent][None, :]
                  - 2.0 * (q @ x[ent].T)).clamp_min(0.0)
        eids = entry if alive is None else torch.where(alive[ent], entry, -1)
        eids = eids[None, :].expand(qb, -1)
    pool = NeighborLists(
        torch.full((qb, beam), torch.inf, device=dev),
        torch.full((qb, beam), -1, dtype=torch.int32, device=dev),
        torch.zeros((qb, beam), dtype=torch.bool, device=dev),  # unexpanded
    )
    pool = _seed_merge(pool, ed, eids, backend)

    inf_q = torch.full((qb,), torch.inf, device=dev)
    slot_iota = torch.arange(beam, dtype=torch.int32, device=dev)[None, :]
    r = 0
    # early-out: every pool entry of every query already expanded
    while r < cfg.n_rounds and bool((pool.new & (pool.idx >= 0)).any()):
        # top-E unexpanded pool slots per query
        _, ss = ops.knn_join_select(
            pool.dist, torch.where(pool.new & (pool.idx >= 0), slot_iota, -1),
            inf_q, e, backend=backend)                  # (qb, E), -1 fill
        can = ss >= 0
        nodes = torch.where(
            can, torch.gather(pool.idx, 1, ss.clamp_min(0).long()), -1)
        # mark expanded (slot -1 names no slot)
        taken = (slot_iota[:, :, None] == ss[:, None, :]).any(-1)
        pool = pool._replace(new=pool.new & ~taken)
        # the expanded nodes' neighbors, masked, as one (qb, E*k) tile
        nbrs = graph_idx[nodes.clamp(0, n - 1).long()]  # (qb, E, k)
        safe = nbrs.clamp(0, n - 1).long()
        ok = can[:, :, None] & (nbrs >= 0)
        if alive is not None:
            ok &= alive[safe]
        if filt is not None:
            ok &= torch.gather(filt, 1, safe.reshape(qb, -1)).reshape(
                ok.shape)
        cand = torch.where(ok, nbrs, -1).reshape(qb, -1)
        dd = tile(cand)
        # pool-k-th prefilter + top-C, then the bounded merge (dedup by
        # id; accepted slots come in unexpanded)
        cd, ci = ops.knn_join_select(dd, cand, pool.dist[:, -1].contiguous(),
                                     c_sel, backend=backend)
        pool, _ = heap.merge_kernel(pool, cd, ci, backend=backend)
        r += 1
    if quant:
        # stage two: the pool re-ranked with the fp32 tile; quantization
        # decided membership, never a returned distance or order
        dex = ops.knn_search_dists(q, q2, x, x2, pool.idx.contiguous(),
                                   backend=backend)
        return ops.knn_join_select(dex, pool.idx.contiguous(), inf_q, k_out,
                                   backend=backend)
    return pool.dist[:, :k_out], pool.idx[:, :k_out]


# ---------------------------------------------------------------------------
# reference greedy loop (parity oracle)
# ---------------------------------------------------------------------------


def _graph_search_ref(
    x: torch.Tensor,          # (n, dp) f32
    x2: torch.Tensor,         # (n,) corpus squared norms
    graph_idx: torch.Tensor,  # (n, k)
    queries: torch.Tensor,    # (q, dp) f32
    entry: torch.Tensor,      # (e,) shared or (q, e) per-query entry ids
    alive: torch.Tensor | None,
    filt: torch.Tensor | None,   # (q, n) per-query predicate mask
    *,
    k_out: int,
    beam: int,
    rounds: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The one-node-per-round greedy search, the fused path's parity
    oracle: every round expands each query's best unexpanded pool entry,
    merges its neighbors, dedups by id (a stable sort by id keeps the
    earliest, pool-first occurrence) and keeps the best ``beam`` by a
    stable sort. Empty slots sit at ``_BIG``."""
    n, k = graph_idx.shape
    nq = queries.shape[0]
    dev = queries.device
    if entry.dim() == 1:
        entry = entry[None, :].expand(nq, -1)
    q2 = (queries * queries).sum(dim=1)
    rows = torch.arange(nq, device=dev)[:, None]

    def q_dist(ids):                                   # (q, m) clipped ids
        ab = torch.bmm(x[ids], queries[:, :, None])[:, :, 0]
        return (x2[ids] - 2.0 * ab + q2[:, None]).clamp_min(0.0)

    def admitted(ids):                                 # (q, m) clipped ids
        ok = torch.ones_like(ids, dtype=torch.bool)
        if alive is not None:
            ok &= alive[ids]
        if filt is not None:
            ok &= torch.gather(filt, 1, ids)
        return ok

    e = entry.shape[1]
    ve = entry >= 0
    ent = entry.clamp(0, n - 1).long()
    pool_i = torch.full((nq, beam), -1, dtype=torch.int32, device=dev)
    pool_d = torch.full((nq, beam), _BIG, device=dev)
    pool_e = torch.zeros((nq, beam), dtype=torch.bool, device=dev)
    pool_i[:, :e] = torch.where(ve, entry, -1)
    pool_d[:, :e] = torch.where(ve, q_dist(ent), _BIG)
    shut = (pool_i >= 0) & ~admitted(pool_i.clamp(0, n - 1).long())
    pool_d = torch.where(shut, _BIG, pool_d)

    for _ in range(rounds):
        score = torch.where(pool_e | (pool_i < 0), _BIG, pool_d)
        b = torch.argmin(score, dim=1, keepdim=True)   # first of the ties
        node = torch.gather(pool_i, 1, b)
        can = torch.gather(score, 1, b) < _BIG
        pool_e[rows, b] = True
        nbrs = graph_idx[node[:, 0].clamp(0, n - 1).long()]   # (q, k)
        safe = nbrs.clamp(0, n - 1).long()
        nb_ok = (nbrs >= 0) & can & admitted(safe)
        nd = torch.where(nb_ok, q_dist(safe), _BIG)
        all_i = torch.cat([pool_i, torch.where(nb_ok, nbrs, -1)], dim=1)
        all_d = torch.cat([pool_d, nd], dim=1)
        all_e = torch.cat([pool_e, torch.zeros_like(nb_ok)], dim=1)
        # dedup: a stable sort by id puts the earliest occurrence first
        sid = torch.argsort(all_i, dim=1, stable=True)
        si = torch.gather(all_i, 1, sid)
        adj = torch.cat([torch.zeros_like(si[:, :1], dtype=torch.bool),
                         si[:, 1:] == si[:, :-1]], dim=1)
        dup = torch.zeros_like(adj).scatter(1, sid, adj) & (all_i >= 0)
        all_d = torch.where(dup | (all_i < 0), _BIG, all_d)
        order = torch.argsort(all_d, dim=1, stable=True)[:, :beam]
        pool_d = torch.gather(all_d, 1, order)
        pool_i = torch.gather(all_i, 1, order)
        pool_e = torch.gather(all_e, 1, order)

    out_d, out_i = pool_d[:, :k_out], pool_i[:, :k_out]
    # dead and hole entries survive in the pool at _BIG; never surface them
    return out_d, torch.where(out_d >= _BIG, -1, out_i)
