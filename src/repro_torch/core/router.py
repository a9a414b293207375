"""Coarse routing layer: centroids, member lists and a centroid mini-graph
for hierarchical entry points.

Uniform random entries strand the fused beam far from the query on a large
corpus. The router is a small k-means centroid set fitted on a live
subsample, per-centroid member lists (the nearest corpus rows of each
centroid) and an exact k-NN graph over the centroids. ``route_entries``
turns a query batch into per-query seeds (the members of the query's top-t
centroids), which ``graph_search`` uses instead of random draws. The online
store keeps the router up to date on insert and delete (assignments,
counts, member lists) and refits it lazily once the accumulated drift
passes ``rebuild_frac`` of the live count.

Distance work goes through the port's kernels: ``ops.centroid_assign``
(the ``pairwise_sq_l2`` kernel plus a stable top-t), ``brute_force_knn``
for the mini-graph and ``heap.purge`` (``knn_compact``) for deletes.
Lloyd's products are plain matrix products (TF32 off on a card), and its
segment sums are ``index_add_``: fp32 sums in another order than
``jax.ops.segment_sum``, so centroids agree with the JAX package's to
about 1e-6 relative, not bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import heap
from repro_torch.core.device import resolve_device
from repro_torch.core.nn_descent import compact_pairs
from repro_torch.core.recall import brute_force_knn
from repro_torch.kernels import ops


@dataclasses.dataclass(frozen=True)
class RouterConfig:
    """Routing-layer knobs (frozen: nested in OnlineConfig)."""
    n_centroids: int = 0       # 0 = auto: ~sqrt(live), clipped to [16, 1024]
    iters: int = 8             # Lloyd iterations (on the subsample)
    sample: int = 32768        # subsample size for the Lloyd fit
    members: int = 32          # member-list width per centroid
    graph_k: int = 8           # centroid mini-graph degree
    top_t: int = 4             # centroids probed per query at search time
    rebuild_frac: float = 0.25  # stale/live ratio that triggers a rebuild


class Router(NamedTuple):
    centroids: torch.Tensor      # (c, dp) f32, feature-padded like the store
    c2: torch.Tensor             # (c,) squared norms
    graph: torch.Tensor          # (c, g) i32 centroid mini-graph, -1 padded
    members: heap.NeighborLists  # (c, m) nearest corpus rows per centroid
    assign: torch.Tensor         # (cap,) i32 centroid per row, -1 = dead
    counts: torch.Tensor         # (c,) i32 live members per centroid
    stale: int                   # mutations since the last full build


def router_from_numpy(centroids, c2, graph, members, assign, counts, stale,
                      device) -> Router:
    """A Router from numpy arrays (a JAX ``Router``'s fields, with
    ``members`` the (dist, idx, new) of its member lists). Copies."""
    def t(a, dtype):
        return torch.as_tensor(np.array(a), dtype=dtype, device=device)

    return Router(
        centroids=t(centroids, torch.float32).contiguous(),
        c2=t(c2, torch.float32), graph=t(graph, torch.int32),
        members=heap.NeighborLists(t(members[0], torch.float32),
                                   t(members[1], torch.int32),
                                   t(members[2], torch.bool)),
        assign=t(assign, torch.int32), counts=t(counts, torch.int32),
        stale=int(np.asarray(stale)))


def resolve_centroids(live: int, cfg: RouterConfig) -> int:
    if cfg.n_centroids > 0:
        return min(cfg.n_centroids, max(live, 1))
    return int(min(1024, max(16, round(max(live, 1) ** 0.5))))


def _lloyd(xs: torch.Tensor, c: int, iters: int) -> torch.Tensor:
    """Lloyd's k-means on the sampled rows, from the first c of them.
    Empty clusters keep their previous centroid."""
    cent = xs[:c]
    xs2 = (xs * xs).sum(dim=1)
    ones = torch.ones((xs.shape[0],), dtype=torch.float32, device=xs.device)
    for _ in range(iters):
        d = (xs2[:, None] + (cent * cent).sum(dim=1)[None, :]
             - 2.0 * (xs @ cent.T)).clamp_min(0.0)
        a = torch.argmin(d, dim=1)                   # first of the ties
        sums = torch.zeros_like(cent).index_add_(0, a, xs)
        cnt = torch.zeros((c,), dtype=torch.float32,
                          device=xs.device).index_add_(0, a, ones)
        cent = torch.where(cnt[:, None] > 0,
                           sums / cnt.clamp_min(1.0)[:, None], cent)
    return cent


def _assign_all(x, x2, cent, c2, *, chunk: int = 4096,
                backend: str = "auto"):
    """Nearest centroid of every row, ``chunk`` rows per distance tile.
    Returns ((cap,) dist, (cap,) i32 idx)."""
    ds, ids = [], []
    for s in range(0, x.shape[0], chunk):
        d, i = ops.centroid_assign(x[s:s + chunk], x2[s:s + chunk], cent,
                                   c2, t=1, backend=backend)
        ds.append(d[:, 0])
        ids.append(i[:, 0])
    return torch.cat(ds), torch.cat(ids)


def build_router(
    x,
    *,
    cfg: RouterConfig | None = None,
    generator: torch.Generator | None = None,
    weights=None,
    alive=None,
    x2=None,
    backend: str = "auto",
    device=None,
) -> Router:
    """Fit centroids on a live subsample, assign every live row, compact
    per-centroid member lists and build the exact centroid mini-graph.

    The subsample is the ``sample`` live rows of largest weight (one
    uniform draw per row from ``generator``, a fresh one seeded 29 if
    None, or the (cap,) ``weights`` injected); ties go to the lower row,
    as ``jax.lax.top_k`` does. ``backend`` is an ops backend (auto | ref).
    Runs on ``device``, "cuda" unless the caller asks otherwise."""
    cfg = cfg or RouterConfig()
    device = resolve_device(device, "build_router")
    x = torch.as_tensor(x, dtype=torch.float32, device=device).contiguous()
    cap = x.shape[0]
    x2 = (x * x).sum(dim=1) if x2 is None else \
        torch.as_tensor(x2, dtype=torch.float32, device=device)
    if alive is not None:
        alive = torch.as_tensor(alive, dtype=torch.bool, device=device)
    live = cap if alive is None else int(alive.sum())
    c = resolve_centroids(live, cfg)

    s = min(cfg.sample, cap)
    if weights is None:
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(29)
        weights = torch.rand(cap, generator=generator, device=device)
    w = torch.as_tensor(weights, dtype=torch.float32, device=device)
    if alive is not None:
        w = torch.where(alive, w, -1.0)
    wv, order = torch.sort(w, descending=True, stable=True)
    wv, sample_ids = wv[:s], order[:s]
    sample_ids = torch.where(wv > 0.0, sample_ids, sample_ids[0])
    cent = _lloyd(x[sample_ids], min(c, s), cfg.iters)
    if cent.shape[0] < c:      # degenerate tiny corpus: pad with repeats
        cent = torch.cat([cent, cent[:1].expand(c - cent.shape[0], -1)])
    cent = cent.contiguous()
    c2 = (cent * cent).sum(dim=1)

    d_assign, assign = _assign_all(x, x2, cent, c2, backend=backend)
    if alive is not None:
        assign = torch.where(alive, assign, -1)
        d_assign = torch.where(alive, d_assign, torch.inf)
    counts = torch.zeros((c,), dtype=torch.int32, device=device).index_add_(
        0, assign.clamp(0, c - 1).long(), (assign >= 0).to(torch.int32))

    m = min(cfg.members, cap)
    md, mi = compact_pairs(
        assign, torch.arange(cap, dtype=torch.int32, device=device),
        d_assign, c, m)
    members = heap.NeighborLists(md, mi, torch.zeros_like(mi,
                                                          dtype=torch.bool))

    g = min(cfg.graph_k, c - 1)
    if g > 0:
        gd, gi = brute_force_knn(cent, cent, g, backend=backend,
                                 device=device)
        graph = torch.where(torch.isfinite(gd), gi, -1).to(torch.int32)
    else:
        graph = torch.full((c, 1), -1, dtype=torch.int32, device=device)
    return Router(centroids=cent, c2=c2, graph=graph, members=members,
                  assign=assign.to(torch.int32), counts=counts, stale=0)


def top_centroids(router: Router, queries: torch.Tensor, t: int, *,
                  backend: str = "auto"):
    """The top-t nearest centroids per query, exact (one distance tile: c
    is small by construction). Returns (dist (q, t), idx (q, t) i32)."""
    q = queries.to(torch.float32).contiguous()
    t = min(t, router.centroids.shape[0])
    return ops.centroid_assign(q, (q * q).sum(dim=1), router.centroids,
                               router.c2, t=t, backend=backend)


def route_entries(router: Router, queries: torch.Tensor, beam: int, *,
                  t: int = 4, backend: str = "auto") -> torch.Tensor:
    """Per-query seeds: the member rows of the query's top-t centroids,
    nearest-member-major (every probed centroid contributes its closest
    members first), cut or -1-padded to ``beam``. (q, beam) i32, -1 =
    hole."""
    _, top = top_centroids(router, queries, t, backend=backend)   # (q, t)
    mem = router.members.idx[top.long()]                          # (q, t, m)
    ent = mem.transpose(1, 2).reshape(queries.shape[0], -1)
    if ent.shape[1] >= beam:
        ent = ent[:, :beam]
    else:
        ent = torch.nn.functional.pad(ent, (0, beam - ent.shape[1]),
                                      value=-1)
    return ent.to(torch.int32)


def router_insert(router: Router, ids: torch.Tensor, q: torch.Tensor, *,
                  backend: str = "auto") -> Router:
    """Insert maintenance: assign each new row to its nearest centroid,
    bump the counts and merge the rows into that centroid's member list
    (grouped by ``compact_pairs``; several rows may share a centroid, so
    the plain dense merge is used: c is small)."""
    q = q.to(torch.float32).contiguous()
    d, ci = ops.centroid_assign(q, (q * q).sum(dim=1), router.centroids,
                                router.c2, t=1, backend=backend)
    ci0, d0 = ci[:, 0], d[:, 0]
    ids = ids.to(torch.int32)
    ok = (ids >= 0) & (ids < router.assign.shape[0])
    assign = router.assign.clone()
    assign[ids[ok].long()] = ci0[ok]
    c = router.centroids.shape[0]
    counts = router.counts.clone().index_add_(
        0, ci0.long(), torch.ones_like(ci0))
    w = max(1, min(router.members.idx.shape[1], int(ids.shape[0])))
    cd, cid = compact_pairs(ci0, ids, d0, c, w)
    members, _ = heap.merge(router.members, cd, cid, False)
    return router._replace(assign=assign, counts=counts, members=members,
                           stale=router.stale + int(ids.shape[0]))


def router_delete(router: Router, ids: torch.Tensor, alive: torch.Tensor,
                  *, backend: str = "auto") -> Router:
    """Delete maintenance: release the rows' assignments, decrement the
    counts and purge dead rows from the member lists (``heap.purge``,
    the ``knn_compact`` kernel)."""
    ids = ids.long()
    old = router.assign[ids]
    valid = old >= 0
    counts = router.counts.clone().index_add_(
        0, torch.where(valid, old, 0).long(), -valid.to(torch.int32))
    assign = router.assign.clone()
    assign[ids] = -1
    members, _ = heap.purge(router.members, alive, backend=backend)
    return router._replace(assign=assign, counts=counts, members=members,
                           stale=router.stale + int(ids.shape[0]))


def needs_rebuild(router: Router, live: int, cfg: RouterConfig) -> bool:
    """Lazy rebuild policy: drift past ``rebuild_frac`` of the live count
    means the centroids no longer describe the data."""
    return int(router.stale) > cfg.rebuild_frac * max(int(live), 1)
