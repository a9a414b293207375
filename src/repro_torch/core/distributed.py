"""Sharded serving and the sharded build: the corpus's rows split over P
shards, each with a K-NN subgraph over its own rows answered as one
global top-k, or one global K-NN graph built by NN-Descent over them.

Single controller, as in the JAX package: one host call drives every
shard. A ``ShardMesh`` names the P torch devices the shards live on
(repeats allowed: ``["cuda:0"] * 4`` is four logical shards on one card;
on a machine with P cards, shard p can sit on ``cuda:p``); it may have
more than one named axis, as the (data, model) meshes of the sharded
training state do (models/sharding.py, launch/mesh.py). Its small
collectives (``all_gather``, the ring ``ppermute``, ``all_to_all``,
``psum``) are ``.to(device)`` moves between shards: a view or a copy on
one device, a peer copy between cards. No ``torch.distributed`` process
group is involved. Global ids are ``shard * n_local + row``.

  * ``graph_search_sharded`` — every shard runs ``graph_search`` on its
    block and the per-shard lists are merged into the global top-k:
    replicated (every query searches every shard), or routed (a router
    over the global corpus picks ``route_p`` shards per query). Dead
    shards (``dead_shards``, a ``FaultPlan``, a ``ShardBreaker``) drop
    out of the merge instead of failing the dispatch.
  * ``exact_knn_sharded`` — blocked brute force: each block passes every
    shard once around the ring; each step scores one (n_local, n_local)
    tile (``ops.pairwise_sq_l2``) and folds its top-k into the running
    lists (``ops.knn_merge``).
  * ``fetch_rows_a2a`` — request-routed row fetch: ids bucketed by owner,
    one all_to_all of ids and one of rows; ``_plan_fetch`` and
    ``_fetch_chunk``, the same rows and mask gathered from the owners
    without the padded buckets, a chunk of ids at a time.
  * ``build_knn_graph_sharded`` — NN-Descent over the row blocks: random
    lists by the feature ring (``ppermute``), sampled iterations
    (``nn_descent_sharded_iteration``: incidences and pair updates routed
    to their receivers' owners by ``_all_to_all_route``, candidate rows
    by ``fetch_rows_a2a`` or the ring, each receiver's best merge_k by
    the select kernel), then exhaustive polish rounds
    (``polish_sharded_round``).

Randomness: torch cannot reproduce ``jax.random.fold_in(key, p)``, so the
per-shard draws are injectable (``entries=``, ``route_fill=``,
``draws=``); without them shard p draws from a generator seeded
``_shard_seed(key, p)`` (the build folds its stage into ``key`` first).
"""
from __future__ import annotations

import dataclasses
import time
from typing import NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.core import faults, heap, selection
from repro_torch.core import metric as metric_mod
from repro_torch.core.device import resolve_device
from repro_torch.core.graph_search import (
    SearchConfig,
    _admit_queries,
    _batch_key,
    _draw_entries,
    _mask_bad_rows,
    graph_search,
)
from repro_torch.core.heap import NeighborLists
from repro_torch.core.nn_descent import (
    DescentConfig,
    _ops_backend,
    invert_candidates,
    join_pairs,
)
from repro_torch.core import cost
from repro_torch.kernels import ops

_MASK64 = (1 << 64) - 1
_GOLDEN = 0x9E3779B97F4A7C15


class ShardMesh:
    """A mesh of logical shards over named axes. ``devices`` nests one
    level per name in ``axis``: a flat list and one name (the default,
    "data") make the 1-D mesh of the sharded search and build, where
    ``devices[p]`` holds shard p's rows; ``[["cuda:0"] * 2] * 2`` with
    ``("data", "model")`` makes a 2 x 2 mesh (``grid`` builds one on a
    single device). ``shape`` is the ordered {name: size}, ``size`` their
    product; ``devices`` lists the shards in row-major order, and
    ``coords`` / ``device_at`` map a position to its coordinates and
    back. Outputs of the sharded entry points land on ``devices[0]``.

    The collectives (``split``, ``all_gather``, ``ppermute``,
    ``all_to_all``, ``psum``) run over one axis: on a 1-D mesh its own;
    on an N-D mesh the ``axis=`` they are given, over the shards along it
    whose other coordinates are 0 (``line``), and with none they
    raise. Under the cost counter (launch/op_cost.py) each collective
    is counted where it is called, with a participant's payload, and one
    along ``pod`` as cross-node."""

    def __init__(self, devices, axis="data"):
        names = (axis,) if isinstance(axis, str) else tuple(axis)
        grid = np.array(devices, dtype=object)
        if grid.size == 0:
            raise ValueError("a ShardMesh needs at least one device")
        if grid.ndim != len(names) or len(set(names)) != len(names):
            raise ValueError(f"devices of shape {grid.shape} do not match "
                             f"the distinct axis names {names}")
        devices = tuple(torch.device(d) for d in grid.reshape(-1))
        if any(d.type == "cuda" for d in devices) \
                and not torch.cuda.is_available():
            raise RuntimeError("ShardMesh names a CUDA device and none is "
                               "available")
        self.devices = devices
        self.axes = names
        self._dims = grid.shape

    @classmethod
    def on(cls, n_shards: int, device=None, axis: str = "data"):
        """``n_shards`` logical shards on one device: the card unless the
        caller names another device; with no card present that raises."""
        if n_shards < 1:
            raise ValueError("n_shards must be >= 1")
        return cls([resolve_device(device, "ShardMesh.on")] * n_shards, axis)

    @classmethod
    def grid(cls, shape: dict, device=None):
        """A mesh of ``shape`` ({name: size}, in order) with every shard on
        one device: the card unless the caller names another ("meta"
        gives placements with no storage); with no card present that
        raises."""
        if not shape or min(shape.values()) < 1:
            raise ValueError(f"mesh shape {shape} needs sizes >= 1")
        dev = resolve_device(device, "ShardMesh.grid")
        devices = np.empty(tuple(shape.values()), dtype=object)
        devices.fill(dev)
        return cls(devices, tuple(shape))

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axes, self._dims))

    def coords(self, p: int) -> dict:
        """{name: coordinate} of the shard at row-major position p."""
        return dict(zip(self.axes,
                        (int(c) for c in np.unravel_index(p, self._dims))))

    def device_at(self, coords: dict) -> torch.device:
        return self.devices[int(np.ravel_multi_index(
            tuple(coords[a] for a in self.axes), self._dims))]

    def line(self, axis: str | None = None) -> tuple:
        """The devices the collectives run over: this 1-D mesh's, or on an
        N-D mesh those along ``axis`` whose other coordinates are 0."""
        if axis is None:
            if len(self.axes) > 1:
                raise ValueError(f"a collective on the {len(self.axes)}-D "
                                 f"mesh {self.shape} needs an axis")
            return self.devices
        if axis not in self.axes:
            raise ValueError(f"{axis!r} is not an axis of {self.shape}")
        at = dict.fromkeys(self.axes, 0)
        return tuple(self.device_at({**at, axis: c})
                     for c in range(self.shape[axis]))

    def split(self, x, dtype=None, *, axis: str | None = None) -> list:
        """Row blocks of the global ``x`` (n, ...), block p on the p-th
        device of ``line(axis)``; n must divide by their count."""
        devices = self.line(axis)
        x = torch.as_tensor(x, dtype=dtype)
        n = x.shape[0]
        if n % len(devices):
            raise ValueError(f"{n} rows do not split over {len(devices)} "
                             "shards")
        n_local = n // len(devices)
        return [x[p * n_local:(p + 1) * n_local].to(d)
                for p, d in enumerate(devices)]

    def _count(self, kind: str, payload: torch.Tensor, axis) -> None:
        cost.collective(kind, payload.numel() * payload.element_size(),
                        cross_pod=axis == "pod")

    def all_gather(self, parts, *, axis: str | None = None) -> torch.Tensor:
        """(P, ...) stack of the per-shard tensors, on the line's first
        device."""
        first = self.line(axis)[0]
        out = torch.stack([t.to(first) for t in parts])
        self._count("all-gather", out, axis)
        return out

    def ppermute(self, blocks, *, axis: str | None = None) -> list:
        """The ring step: shard p receives shard p-1's block."""
        self._count("collective-permute", blocks[0], axis)
        return [blocks[p - 1].to(d) for p, d in enumerate(self.line(axis))]

    def all_to_all(self, buckets, *, axis: str | None = None) -> list:
        """buckets[p] (P, ...): row q goes to shard q. Returns got with
        got[q][p] = buckets[p][q], on the line's q-th device."""
        self._count("all-to-all", buckets[0], axis)
        return [torch.stack([b[q].to(d) for b in buckets])
                for q, d in enumerate(self.line(axis))]

    def psum(self, parts, *, axis: str | None = None) -> torch.Tensor:
        """Sum of the per-shard tensors, on the line's first device."""
        first = self.line(axis)[0]
        self._count("all-reduce", parts[0], axis)
        return torch.stack([t.to(first) for t in parts]).sum(dim=0)


def _shard_seed(key: int, p: int) -> int:
    """Shard p's generator seed: ``key`` itself for shard 0 (so one shard
    draws what ``graph_search`` draws from the same key), a Weyl step of
    the golden ratio further for each next shard."""
    return (key + p * _GOLDEN) & _MASK64


def _shard_generator(key: int, p: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(_shard_seed(key, p))


def _lowest(d: torch.Tensor, i: torch.Tensor, k: int, backend: str):
    """The k smallest of (q, W) lists, ties to the lowest position (as
    ``jax.lax.top_k`` keeps them); id -1 and +inf entries come back as
    (+inf, -1). The select kernel with no prefilter."""
    kth = torch.full((d.shape[0],), torch.inf, device=d.device)
    return ops.knn_join_select(d.contiguous(), i.contiguous(), kth, k,
                               backend=backend)


def exact_knn_sharded(mesh: ShardMesh, x, k: int, *, axis: str = "data"):
    """Exact k-NN over the rows of ``x`` (n, d) split over the mesh's P
    shards (self excluded by id). Each of P ring steps scores every
    shard's block against the block passing it (``ops.pairwise_sq_l2``),
    masks the shard's own ids, takes the tile's k smallest (``topk``, then
    a stable order by distance and position: ids equal the JAX package's
    but where a tie straddles the k-th place) and folds them into the
    running lists (``ops.knn_merge``). Returns (dist (n, k), idx (n, k) i32
    global ids) on devices[0]."""
    P = mesh.shape[axis]
    blocks = mesh.split(x, torch.float32)
    n_local = blocks[0].shape[0]
    if not 0 < k < n_local:
        raise ValueError(f"k={k} needs 0 < k < n_local={n_local}")
    blocks = [b.contiguous() for b in blocks]
    nl_d = [torch.full((n_local, k), torch.inf, device=b.device)
            for b in blocks]
    nl_i = [torch.full((n_local, k), -1, dtype=torch.int32, device=b.device)
            for b in blocks]
    passing = list(blocks)
    for s in range(P):
        for p, mine in enumerate(blocks):
            owner = (p - s) % P
            dist = ops.pairwise_sq_l2(mine, passing[p])
            if owner == p:
                dist.fill_diagonal_(torch.inf)
            val, col = torch.topk(dist, k, dim=1, largest=False)
            col, o = torch.sort(col, dim=1)
            val = torch.gather(val, 1, o)
            val, o = torch.sort(val, dim=1, stable=True)
            cand_i = (owner * n_local + torch.gather(col, 1, o)).to(
                torch.int32)
            nl_d[p], nl_i[p], _ = ops.knn_merge(
                nl_d[p], nl_i[p], val.contiguous(), cand_i.contiguous())
            del dist
        passing = mesh.ppermute(passing)
    return (torch.cat([t.to(mesh.devices[0]) for t in nl_d]),
            torch.cat([t.to(mesh.devices[0]) for t in nl_i]))


def _bucket_slots(ids: torch.Tensor, P: int, n_local: int, cap: int):
    """Where ``fetch_rows_a2a`` puts each of one shard's global ``ids``
    (m,): its owner (P for id -1), its slot in the owner's bucket (its
    rank among the ids of that owner, by position) and whether that slot
    is below ``cap``, each (m,) in the ids' order; then the ids' order by
    owner (stable) and each owner's first place in it, (P + 1,). Integers
    only, so a caller can gather the rows without the buckets."""
    m = ids.shape[0]
    dev = ids.device
    owner = torch.where(ids >= 0, (ids // n_local).clamp(0, P - 1), P)
    owner_s, order = torch.sort(owner, stable=True)
    first = torch.searchsorted(
        owner_s, torch.arange(P + 1, dtype=owner_s.dtype, device=dev))
    slot = torch.empty(m, dtype=torch.int64, device=dev)
    slot[order] = torch.arange(m, device=dev) - first[owner_s.long()]
    return owner, slot, (owner < P) & (slot < cap), order, first


def fetch_rows_a2a(mesh: ShardMesh, x_local, ids, *, cap: int):
    """Request-routed row fetch. ``x_local[p]`` (n_local, d) is shard p's
    block and ``ids[p]`` (m,) the global ids it needs (-1 = none). Each
    shard buckets its ids by owner (stable by position, ``cap`` per
    owner), one all_to_all sends the ids, the owners gather the rows, one
    all_to_all returns them to the same bucket slots. An id past its
    bucket's ``cap`` is dropped. Returns (rows, ok): per shard (m, d) rows
    (zero where not fetched) and an (m,) mask, false for overflow and id
    -1, each on its shard's device."""
    P = mesh.size
    n_local = x_local[0].shape[0]
    reqs, slots = [], []
    for p, dev in enumerate(mesh.devices):
        idp = torch.as_tensor(ids[p], dtype=torch.int32, device=dev)
        owner, slot, in_bucket, _, _ = _bucket_slots(idp, P, n_local, cap)
        # out-of-bucket writes land in one spare slot (JAX's mode="drop")
        flat = torch.where(in_bucket, owner.long() * cap + slot, P * cap)
        req = torch.full((P * cap + 1,), -1, dtype=torch.int32, device=dev)
        req.scatter_(0, flat, idp)
        reqs.append(req[:P * cap].view(P, cap))
        slots.append((owner, slot, in_bucket))
    rows = []
    for p, got in enumerate(mesh.all_to_all(reqs)):
        loc = got - p * n_local                       # requested from p
        here = (loc >= 0) & (loc < n_local)
        r = x_local[p][loc.clamp(0, n_local - 1).long()]
        rows.append(torch.where(here[..., None], r, torch.zeros_like(r)))
    out_rows, out_ok = [], []
    for p, back in enumerate(mesh.all_to_all(rows)):
        owner, slot, in_bucket = slots[p]
        fetched = back[owner.clamp(0, P - 1).long(), slot.clamp(0, cap - 1)]
        out_rows.append(torch.where(in_bucket[:, None], fetched,
                                    torch.zeros_like(fetched)))
        out_ok.append(in_bucket)
    return out_rows, out_ok


class _FetchPlan(NamedTuple):
    """One shard's share of ``_plan_fetch``: ``ok`` (m,) is
    ``fetch_rows_a2a``'s mask; ``loc`` and ``order`` (m,) are the ids'
    rows on their owners and the ids' positions, both in the owner order;
    owner q's in-bucket ids of chunk c are
    ``order[bounds[c][q]:bounds[c + 1][q]]``."""
    ok: torch.Tensor
    loc: torch.Tensor
    order: torch.Tensor
    bounds: list
    span: int


def _plan_fetch(mesh: ShardMesh, n_local: int, ids, *, cap: int,
               span: int) -> list:
    """``fetch_rows_a2a`` without its padded buckets, for each shard's
    global ``ids[p]`` (m,) in [-1, P * n_local) taken ``span`` at a time.
    The ids get the same bucket slots (``_bucket_slots``): the in-bucket
    ids of owner q are the first ``cap`` of q's run in the owner order,
    and each chunk of ``span`` ids holds one contiguous piece of every
    run. One host read of the pieces' bounds, for all shards; then
    ``_fetch_chunk`` gathers a chunk's rows, each owner's piece in one
    gather. Returns one ``_FetchPlan`` a shard."""
    P = mesh.size
    plans, tables = [], []
    for p, dev in enumerate(mesh.devices):
        idp = torch.as_tensor(ids[p], dtype=torch.int32, device=dev)
        m = idp.shape[0]
        chunks = max(-(-m // span), 1)
        owner, _, ok, order, first = _bucket_slots(idp, P, n_local, cap)
        # each owner's ids a chunk, then before each chunk (P, chunks + 1)
        hist = torch.bincount(
            owner.long() * chunks + torch.arange(m, device=dev) // span,
            minlength=(P + 1) * chunks)[:P * chunks].view(P, chunks)
        before = torch.cat([torch.zeros_like(hist[:, :1]),
                            hist.cumsum(1)], dim=1)
        tables.append((first[:P, None] + before.clamp_max(cap)).T
                      .reshape(-1).to(mesh.devices[0]))
        plans.append((ok, (idp - owner * n_local)[order].long(), order,
                      chunks))
    flat = torch.cat(tables).tolist()
    out, at = [], 0
    for ok, loc, order, chunks in plans:
        out.append(_FetchPlan(ok, loc, order, [
            flat[at + r * P:at + (r + 1) * P] for r in range(chunks + 1)],
            span))
        at += (chunks + 1) * P
    return out


def _fetch_chunk(mesh: ShardMesh, x_local, plans, p: int, c: int):
    """Rows of chunk c of shard p's planned ids (``_plan_fetch``), (span,
    d) (the last chunk shorter) on devices[p]: ``x_local[owner][row]``
    where the id is in its bucket, 0 elsewhere; equal to those rows of
    ``fetch_rows_a2a``'s result, bit for bit."""
    f = plans[p]
    dev = mesh.devices[p]
    s = c * f.span
    out = torch.zeros((min(f.span, f.ok.shape[0] - s), x_local[0].shape[1]),
                      dtype=x_local[0].dtype, device=dev)
    for q, dq in enumerate(mesh.devices):
        a, b = f.bounds[c][q], f.bounds[c + 1][q]
        if a < b:
            rows = x_local[q].index_select(0, f.loc[a:b].to(dq))
            out.index_copy_(0, f.order[a:b] - s, rows.to(dev))
    return out


def _fetch_features_ring(mesh: ShardMesh, x_local, ids) -> list:
    """Rows of global ``ids[p]`` (m,) (clipped to [0, n)) for every shard
    by the feature ring: each block passes every shard once, and a shard
    keeps the rows of its ids that the passing block owns."""
    P = mesh.size
    n_local = x_local[0].shape[0]
    out = [torch.zeros((i.shape[0], b.shape[1]), dtype=b.dtype,
                       device=b.device) for i, b in zip(ids, x_local)]
    passing = list(x_local)
    for s in range(P):
        for p in range(P):
            local = ids[p] - ((p - s) % P) * n_local
            hit = (local >= 0) & (local < n_local)
            rows = passing[p][local.clamp(0, n_local - 1).long()]
            out[p] = torch.where(hit[:, None], rows, out[p])
        if s < P - 1:
            passing = mesh.ppermute(passing)
    return out


def _all_to_all_route(mesh: ShardMesh, payload, mask, dest, cap: int,
                      rnd) -> list:
    """Route the rows of each shard's ``payload[p]`` (m, w) int32 to shard
    ``dest[p]`` (m,) where ``mask[p]``. A shard sorts its rows by (dest,
    ``rnd[p]``) (ties by position, ``jnp.lexsort``'s order) and fills one
    bucket of ``cap`` rows per destination; rows past ``cap`` are dropped.
    Returns per shard the (P*cap, w) rows it received, sender-major, with
    -1 in every column of an empty row."""
    P = mesh.size
    buckets = []
    for p, dev in enumerate(mesh.devices):
        m, w = payload[p].shape
        dst = torch.where(mask[p], dest[p], P)
        order = selection.lexsort_order(rnd[p], dst)
        dest_s = dst[order]
        first = torch.searchsorted(
            dest_s, torch.arange(P + 1, dtype=dest_s.dtype, device=dev))
        pos = torch.arange(m, device=dev) - first[dest_s.long()]
        keep = (dest_s < P) & (pos < cap)
        # dropped rows land in one spare row (JAX's mode="drop")
        flat = torch.where(keep, dest_s.long() * cap + pos, P * cap)
        b = torch.full((P * cap + 1, w), -1, dtype=payload[p].dtype,
                       device=dev)
        b[flat] = payload[p][order]
        buckets.append(b[:P * cap].view(P, cap, w))
    return [g.reshape(P * cap, -1) for g in mesh.all_to_all(buckets)]


@dataclasses.dataclass(frozen=True)
class BreakerConfig:
    """Knobs for the per-shard latency circuit breaker."""
    alpha: float = 0.3        # EWMA weight of the newest latency sample
    trip_ratio: float = 3.0   # open when ewma > ratio * median(others)
    min_samples: int = 3      # samples before a shard is allowed to trip
    probe_every: int = 4      # while open, probe every N dispatches
    recover_ratio: float = 1.5
    #                         # a half-open probe closes the breaker when
    #                         # its sample <= ratio * median(others)


class ShardBreaker:
    """Per-shard latency circuit breaker for ``graph_search_sharded``.

    A chronically slow shard drags every dispatch's tail while adding
    nothing a survivor could not. The breaker keeps a latency EWMA per
    shard; when a shard's EWMA exceeds ``trip_ratio`` x the median of the
    other closed shards' EWMAs (a scale-free trip), the breaker OPENS and
    the shard joins the dead shards' degraded merge. While open, every
    ``probe_every``-th dispatch is a HALF-OPEN probe: the shard is let
    through once, and a healthy sample (<= ``recover_ratio`` x the
    others' median) closes the breaker and restarts its EWMA.

    Clock-free: it folds the samples handed to :meth:`observe` and never
    reads the time itself, so tests drive it with synthetic numbers and
    the ``shard.degrade`` fault site inflates real samples. One
    :meth:`excluded` and one :meth:`observe` per dispatch;
    ``graph_search_sharded(breaker=...)`` does both. It never excludes
    every shard: with all breakers open the lowest-EWMA shard serves.
    """

    def __init__(self, n_shards: int, cfg: BreakerConfig | None = None):
        if n_shards < 1:
            raise ValueError("n_shards must be >= 1")
        self.n_shards = n_shards
        self.cfg = cfg or BreakerConfig()
        self.ewma: list = [None] * n_shards
        self.samples = [0] * n_shards
        self.open = [False] * n_shards
        self._opened_at = [0] * n_shards    # dispatch counter at open
        self._probing: set = set()          # half-open this dispatch
        self.dispatches = 0
        self.trips = 0
        self.probes = 0
        self.recoveries = 0

    def _median_others(self, shard: int):
        vals = sorted(
            e for s, e in enumerate(self.ewma)
            if s != shard and e is not None and not self.open[s]
        )
        if not vals:
            return None
        return vals[len(vals) // 2]

    def excluded(self) -> list:
        """Shards to treat as dead for the NEXT dispatch (advances the
        dispatch counter; open shards due for their half-open probe are
        let through and remembered as probing)."""
        self.dispatches += 1
        self._probing = set()
        out = []
        for s in range(self.n_shards):
            if not self.open[s]:
                continue
            age = self.dispatches - self._opened_at[s]
            if age > 0 and age % max(1, self.cfg.probe_every) == 0:
                self._probing.add(s)        # half-open: let one through
                self.probes += 1
            else:
                out.append(s)
        if len(out) == self.n_shards:       # never exclude every shard
            best = min(out, key=lambda s: self.ewma[s] or 0.0)
            out.remove(best)
        return out

    def observe(self, latencies) -> None:
        """Fold per-shard latency samples (seconds) of the dispatch that
        :meth:`excluded` opened: ``latencies`` {shard: seconds}, excluded
        shards absent. Closed shards update their EWMA and may trip;
        probing shards close on a healthy sample and re-arm the probe
        timer otherwise."""
        a = self.cfg.alpha
        for s, lat in dict(latencies).items():
            s = int(s)
            if not 0 <= s < self.n_shards:
                continue
            lat = float(lat)
            prev = self.ewma[s]
            self.ewma[s] = lat if prev is None else (1 - a) * prev + a * lat
            self.samples[s] += 1
            med = self._median_others(s)
            if self.open[s]:
                if s in self._probing and med is not None \
                        and lat <= self.cfg.recover_ratio * med:
                    self.open[s] = False
                    self.recoveries += 1
                    # forget the degraded EWMA: the shard comes back on
                    # probation with its healthy probe sample
                    self.ewma[s] = lat
                    self.samples[s] = 1
                else:
                    self._opened_at[s] = self.dispatches
            elif (self.samples[s] >= self.cfg.min_samples
                  and med is not None
                  and self.ewma[s] > self.cfg.trip_ratio * med):
                self.open[s] = True
                self._opened_at[s] = self.dispatches
                self.trips += 1
        self._probing = set()

    def stats(self) -> dict:
        return {
            "dispatches": self.dispatches,
            "open_shards": [s for s in range(self.n_shards)
                            if self.open[s]],
            "ewma": [None if e is None else float(e) for e in self.ewma],
            "trips": self.trips,
            "probes": self.probes,
            "recoveries": self.recoveries,
        }


def _breaker_feed(breaker: ShardBreaker, dt: float, P: int, dead) -> None:
    """Charge one dispatch's wall time to every live shard (a one-call
    dispatch has no per-shard clock; uniform samples move every EWMA
    alike), scale it by the active plan's ``shard.degrade`` factors, and
    fold the samples into the breaker. Deployments with per-shard RPC
    timings call ``breaker.observe`` with those instead."""
    dead = set(dead)
    lat = {s: dt for s in range(P) if s not in dead}
    for s, f in faults.degrade_factors(P).items():
        if s in lat:
            lat[s] *= f
    breaker.observe(lat)


def graph_search_sharded(
    mesh: ShardMesh,
    x,                      # (n, d) corpus, split by rows over the mesh
    graph_idx,              # (n, k) per-shard subgraph, LOCAL neighbor ids
    queries,                # (q, d) query batch, seen by every shard
    *,
    k_out: int = 10,
    cfg: SearchConfig | None = None,
    key: int | None = None,
    axis: str = "data",
    router=None,            # core.router.Router over the GLOBAL corpus
    route_p: int = 0,       # shards searched per query (0 = all)
    route_cap: int = 0,     # per-shard routed-query buffer (0 = auto)
    with_stats: bool = False,
    dead_shards=None,       # shard indices known unavailable; merged with
    #                         the active FaultPlan's shard.dead / .slow
    breaker: ShardBreaker | None = None,
    entries=None,           # (P, e) or (P, q, e) replicated entry ids
    route_fill=None,        # (P, e_w) routed hole fill, local ids
):
    """Sharded search. Rows of ``x`` are split over the mesh's P shards;
    shard p's subgraph (rows p*n_local onward of ``graph_idx``) holds
    LOCAL ids. Each shard runs ``graph_search`` on its block; its hits
    are lifted to global ids (``p * n_local + i``).

    **Replicated** (``route_p=0`` or no ``router``): every query searches
    every live shard; the (q, P*k_out) shard-major lists are merged into
    the k_out best, ties to the lowest position.

    **Routed** (``router`` over the global corpus and 0 < route_p < P):
    a centroid's shard is the majority shard of its member rows (first on
    ties); a query's affinity for a shard is its least distance to one of
    the shard's centroids (+inf for a shard with none); its top
    ``route_p`` shards search it, each from a compacted buffer of at most
    ``route_cap`` queries (default ~4x the balanced load), seeded with the
    router's member rows on that shard (holes from a shard-local draw).
    Each query merges only its ``route_p`` lists; a query past a shard's
    buffer loses that shard's list (counted in ``dropped_queries``).

    **Degraded**: shards in ``dead_shards``, marked by the active
    ``FaultPlan`` or excluded by ``breaker`` drop out: replicated, their
    lists are masked before the merge; routed, their affinity goes to
    +inf before the top-``route_p`` pick. The port does not search a dead
    shard at all (its lists are masked either way). All shards dead
    answers every query (+inf, -1).

    ``cfg.precision`` rides into each shard's search (each quantizes its
    own rows; the re-ranked distances are fp32). ``cfg.metric``: the
    corpus must be transformed already; the queries are transformed here.
    Admission (NaN / Inf rows, ``cfg.strict``) runs here once.

    Draws: ``entries`` replaces each shard's replicated entry draw,
    ``route_fill`` the routed hole fill. Without them shard p draws
    ``_draw_entries`` (beam, or min(beam, n_local) for the fill) from a
    generator on its device seeded ``_shard_seed(key, p)``, where ``key``
    is a 64-bit seed and defaults to ``_batch_key`` of the admitted
    queries; one shard therefore draws what ``graph_search`` draws.

    ``breaker``: its open shards join the dead ones for this dispatch,
    and the dispatch's wall time (``time.monotonic``, ended by a
    synchronise of the output's device) is charged to every live shard
    (``_breaker_feed``).

    Returns (dist (q, k_out), idx (q, k_out) global ids) on devices[0],
    plus a stats dict (fanout, shards, routed / searched / dropped
    queries, degraded_shards, cover_frac, breaker) with ``with_stats``."""
    cfg = cfg or SearchConfig()
    P = mesh.shape[axis]
    dev0 = mesh.devices[0]
    x = torch.as_tensor(x, dtype=torch.float32)
    graph_idx = torch.as_tensor(graph_idx, dtype=torch.int32)
    queries = torch.as_tensor(queries, dtype=torch.float32, device=dev0)
    # the query-side metric transform runs once here; each shard's search
    # repeats it, as the JAX package's does (normalizing twice, padding
    # a mips batch already at the corpus width never)
    if cfg.metric == "cosine":
        queries = metric_mod.normalize_rows(queries)
    elif cfg.metric == "mips" and queries.dim() == 2 \
            and queries.shape[1] < x.shape[1]:
        queries = torch.nn.functional.pad(
            queries, (0, x.shape[1] - queries.shape[1]))
    else:
        metric_mod.check_metric(cfg.metric)
    queries, bad_rows = _admit_queries(queries, x.shape[1], cfg.strict)
    queries = queries.contiguous()
    key = _batch_key(queries) if key is None else int(key)
    n = x.shape[0]
    if n % P:
        raise ValueError(f"{n} rows do not split over {P} shards")
    n_local = n // P
    dead_set = {int(s) for s in (dead_shards or ())
                if 0 <= int(s) < P} | set(faults.dead_shards(P))
    if breaker is not None:
        # one excluded()/observe() pair per dispatch: open shards join
        # the degraded merge exactly like dead ones
        dead_set |= set(breaker.excluded())
    dead = sorted(dead_set)
    live = [p not in dead_set for p in range(P)]
    # shard-LOCAL ids are the contract: global ids would be clipped into
    # garbage adjacency inside a shard's search
    if int(graph_idx.max()) >= n_local:
        raise ValueError(
            f"graph_idx holds ids >= n_local ({n_local}): "
            "graph_search_sharded expects shard-LOCAL neighbor ids (each "
            "shard's subgraph over its own rows), not global ids — "
            "subtract each shard's base (shard * n_local) and drop "
            "cross-shard edges first")
    backend = "ref" if cfg.backend in ("plain", "ref") else "auto"
    xs, gs = mesh.split(x), mesh.split(graph_idx)
    q_n = queries.shape[0]

    def search(p, q, ent):
        d, i = graph_search(xs[p], gs[p], q, k_out=k_out, entry=ent,
                            cfg=cfg, device=mesh.devices[p])
        return d, torch.where(i >= 0, p * n_local + i, -1)

    routed = router is not None and 0 < route_p < P
    if not routed:
        t0 = time.monotonic()
        ds, is_ = [], []
        for p, dev in enumerate(mesh.devices):
            if not live[p]:
                ds.append(torch.full((q_n, k_out), torch.inf, device=dev0))
                is_.append(torch.full((q_n, k_out), -1, dtype=torch.int32,
                                      device=dev0))
                continue
            if entries is not None:
                ent = torch.as_tensor(entries[p], dtype=torch.int32,
                                      device=dev)
            else:
                ent = _draw_entries(_shard_generator(key, p, dev), n_local,
                                    cfg.beam, None)
            d, i = search(p, queries.to(dev), ent)
            ds.append(d)
            is_.append(i)
        alld = mesh.all_gather(ds).transpose(0, 1).reshape(q_n, -1)
        alli = mesh.all_gather(is_).transpose(0, 1).reshape(q_n, -1)
        out_d, out_i = _lowest(alld, alli, k_out, backend)
        if breaker is not None:
            if out_d.is_cuda:
                torch.cuda.synchronize(out_d.device)
            _breaker_feed(breaker, time.monotonic() - t0, P, dead)
        out_d, out_i = _mask_bad_rows(out_d, out_i, bad_rows)
        if with_stats:
            n_live = P - len(dead)
            stats = {
                "fanout": P, "shards": P,
                "routed_queries": q_n * n_live,
                "searched_queries": q_n * n_live, "dropped_queries": 0,
                "degraded_shards": dead,
                "cover_frac": n_live / P,
            }
            if breaker is not None:
                stats["breaker"] = breaker.stats()
            return out_d, out_i, stats
        return out_d, out_i

    # ---- routed: the routing tile on devices[0], then a compacted
    # per-shard search and each query's partial merge
    live_mask = torch.tensor(live, device=dev0)
    dqc = ops.pairwise_sq_l2(queries, router.centroids.to(dev0).contiguous(),
                             backend=backend)                    # (q, c)
    mem = router.members.idx.to(dev0)                            # (c, m)
    ms = torch.where(mem >= 0, mem // n_local, -1)
    votes = (ms[:, :, None] == torch.arange(P, device=dev0)).sum(1)
    shard_of = torch.argmax(votes, dim=1)          # first on ties, (c,)
    aff = torch.full((q_n, P), torch.inf, device=dev0).scatter_reduce_(
        1, shard_of[None, :].expand(q_n, -1), dqc, "amin")      # (q, P)
    # cover_frac reads the PRE-reroute set (the shards a query wanted);
    # dead shards' +inf affinity then moves them out of the picked set
    want_shards = torch.sort(aff, dim=1, stable=True)[1][:, :route_p]
    aff = torch.where(live_mask[None, :], aff, torch.inf)
    top_shards = torch.sort(aff, dim=1, stable=True)[1][:, :route_p]
    t = min(cfg.router_t, router.centroids.shape[0])
    top_cent = torch.sort(dqc, dim=1, stable=True)[1][:, :t]     # (q, t)
    # per-query entry candidates, nearest-member-major (global ids)
    entg = mem[top_cent].transpose(1, 2).reshape(q_n, -1)        # (q, t*m)
    e_w = min(cfg.beam, n_local)
    cap_q = route_cap or min(q_n, max(32, -((-4 * q_n * route_p) // P)))
    cap_q = min(cap_q, q_n)
    w = entg.shape[1]

    t0 = time.monotonic()
    ds, is_, gp, searched, routed_q = [], [], [], [], []
    for p, dev in enumerate(mesh.devices):
        base = p * n_local
        if not live[p]:
            # a dead shard searches nothing; its buffer never merges
            ds.append(torch.full((cap_q, k_out), torch.inf, device=dev0))
            is_.append(torch.full((cap_q, k_out), -1, dtype=torch.int32,
                                  device=dev0))
            gp.append(torch.full((q_n,), -1, dtype=torch.int64, device=dev0))
            continue
        tsh, eg, q = top_shards.to(dev), entg.to(dev), queries.to(dev)
        mine = (tsh == p).any(dim=1)                             # (q,)
        # the first cap_q routed queries in order, -1 fill (JAX's
        # nonzero(size=cap_q, fill_value=-1)); unique keys, no host sync
        ar_q = torch.arange(q_n, device=dev)
        first = torch.sort(torch.where(mine, ar_q, q_n + ar_q))[1][:cap_q]
        qids = torch.where(mine[first], first, -1)
        ok_q = qids >= 0
        safe_q = torch.where(ok_q, qids, 0)
        # this shard's slice of the routed entries, local ids, the valid
        # ones moved to the front in order
        egs = eg[safe_q]
        egl = egs - base
        ve = ok_q[:, None] & (egs >= 0) & (egl >= 0) & (egl < n_local)
        ar = torch.arange(w, device=dev)[None, :]
        order = torch.sort(torch.where(ve, ar, w + ar), dim=1)[1]
        ent = torch.gather(torch.where(ve, egl, -1), 1, order)
        if w >= e_w:
            ent = ent[:, :e_w]
        else:
            ent = torch.nn.functional.pad(ent, (0, e_w - w), value=-1)
        # holes take a shard-local draw without replacement
        if route_fill is not None:
            rnd = torch.as_tensor(route_fill[p], dtype=torch.int32,
                                  device=dev)
        else:
            rnd = _draw_entries(_shard_generator(key, p, dev), n_local, e_w,
                                None)
        ent = torch.where(ent >= 0, ent, rnd[None, :]).to(torch.int32)
        d, gi = search(p, q[safe_q], ent)
        gi = torch.where(ok_q[:, None], gi, -1)
        d = torch.where(gi >= 0, d, torch.inf)
        # query id -> its slot in this shard's buffer (one spare slot
        # takes the writes JAX drops)
        gpos = torch.full((q_n + 1,), -1, dtype=torch.int64, device=dev)
        gpos[torch.where(ok_q, qids, q_n)] = torch.arange(cap_q, device=dev)
        ds.append(d)
        is_.append(gi)
        gp.append(gpos[:q_n])
        searched.append(ok_q.sum())
        routed_q.append(mine.sum())
    ds, is_, gp = mesh.all_gather(ds), mesh.all_gather(is_), \
        mesh.all_gather(gp)
    # partial merge: each query folds only its route_p shard lists
    pp = gp[top_shards, torch.arange(q_n, device=dev0)[:, None]]  # (q, p)
    ppc = pp.clamp(0, cap_q - 1)
    cd = ds[top_shards, ppc]                               # (q, p, k_out)
    ci = is_[top_shards, ppc]
    hit = (pp >= 0)[:, :, None] & (ci >= 0) \
        & live_mask[top_shards][:, :, None]
    cd = torch.where(hit, cd, torch.inf).reshape(q_n, -1)
    ci = torch.where(hit, ci, -1).reshape(q_n, -1)
    out_d, out_i = _lowest(cd, ci, k_out, backend)
    if breaker is not None:
        if out_d.is_cuda:
            torch.cuda.synchronize(out_d.device)
        _breaker_feed(breaker, time.monotonic() - t0, P, dead)
    out_d, out_i = _mask_bad_rows(out_d, out_i, bad_rows)
    if with_stats:
        n_routed = int(mesh.psum(routed_q)) if routed_q else 0
        n_searched = int(mesh.psum(searched)) if searched else 0
        stats = {
            "fanout": route_p, "shards": P,
            "routed_queries": n_routed,
            "searched_queries": n_searched,
            "dropped_queries": n_routed - n_searched,
            "degraded_shards": dead,
            "cover_frac": float(live_mask[want_shards].float().mean()),
        }
        if breaker is not None:
            stats["breaker"] = breaker.stats()
        return out_d, out_i, stats
    return out_d, out_i


# ---------------------------------------------------------------------------
# the sharded build: NN-Descent over the mesh's row blocks
# ---------------------------------------------------------------------------

FETCHES = ("a2a", "ring")
# the candidate rows the polish gathers at once, a shard
_POLISH_CHUNK_BYTES = 1 << 30
_STAGE = 0xD1B54A32D192ED03


def _stage_key(key: int, stage: int) -> int:
    """The key of one stage of a sharded build: stage 0 (the init) is
    ``key`` itself, sampled iteration t is stage t + 1, each an odd Weyl
    step further (mod 2^64)."""
    return (key + stage * _STAGE) & _MASK64


class ShardedBuildDraws(NamedTuple):
    """Injected randomness of a sharded build. ``init``: (P, n_local, k)
    raw ids in [0, n), shard p's initial lists before self-loops are
    bumped. ``iters[t][p]``: shard p's uniforms in [0, 1) for sampled
    iteration t, in the order it draws them: ``u`` (2*n_local*k,), the
    accept test; the new and the old incidence routes' sort keys, each
    (2*n_local*k,); the compaction's sort key (P*cap,), shared by both
    pools; the update route's sort key, one per pair (n_local * pairs a
    row,)."""
    init: torch.Tensor
    iters: Sequence[Sequence[tuple]]


def _lists_on(mesh: ShardMesh, nl) -> NeighborLists:
    """Per-shard lists as one (n, k) ``NeighborLists`` on devices[0]."""
    dev0 = mesh.devices[0]
    return NeighborLists(*(torch.cat([t[f].to(dev0) for t in nl])
                           for f in range(3)))


def _init_lists(mesh: ShardMesh, xs, x2s, k: int, key: int, init) -> list:
    """Each shard's random initial lists: k ids drawn in [0, n) (a self
    id bumped to the next, mod n), their rows by the feature ring,
    distances by the norm expansion clamped at 0, each row stably sorted;
    every slot new."""
    P = mesh.size
    n_local = xs[0].shape[0]
    n = P * n_local
    ids = []
    for p, dev in enumerate(mesh.devices):
        if init is None:
            raw = torch.randint(0, n, (n_local, k), dtype=torch.int32,
                                generator=_shard_generator(key, p, dev),
                                device=dev)
        else:
            raw = torch.as_tensor(init[p], dtype=torch.int32, device=dev)
        my = p * n_local + torch.arange(n_local, dtype=torch.int32,
                                        device=dev)[:, None]
        ids.append(torch.where(raw == my, (raw + 1) % n, raw))
    feats = _fetch_features_ring(mesh, xs, [i.reshape(-1) for i in ids])
    out = []
    for p in range(P):
        f = feats[p].view(n_local, k, -1)
        dist = (x2s[p][:, None] + (f * f).sum(-1)
                - 2.0 * torch.bmm(f, xs[p][:, :, None])[:, :, 0])
        dist, order = torch.sort(dist.clamp_min(0.0), dim=1, stable=True)
        out.append(NeighborLists(dist, torch.gather(ids[p], 1, order),
                                 torch.ones_like(order, dtype=torch.bool)))
    return out


def nn_descent_sharded_iteration(
    mesh: ShardMesh,
    x_local,                # [P] (n_local, d) f32 blocks
    x2_local,               # [P] (n_local,) squared norms
    nl,                     # [P] NeighborLists: local rows, GLOBAL ids
    cfg: DescentConfig,
    *,
    fetch: str = "a2a",     # a2a (request-routed) | ring (the baseline)
    key: int = 0,
    draws=None,             # [P] tuples of ShardedBuildDraws.iters[t]
):
    """One sharded NN-Descent iteration, one host call over the mesh.

    Each shard samples the incidences of its lists (forward: its rows
    receive their neighbors; reverse: the neighbors receive its rows),
    accepting each with probability rho_k / |N|, where |N| is k plus the
    count of this shard's new incidences that a local receiver receives,
    and 2k for a remote receiver. Accepted incidences go to their receiver's owner
    (``_all_to_all_route``, ``cap`` a destination), and each shard
    compacts what it received into (n_local, rho_k) new and old buffers
    (one sort key for both). The accepted forward slots lose their new
    flag. The candidates' rows come by ``fetch_rows_a2a`` (candidates it
    drops become -1) or by the ring; every new x new and new x old pair
    of a row is scored (``join_pairs``) and routed, both directions, to
    the receiver's owner; each shard inverts what it received into
    per-receiver buffers of ``cfg.join_src or 8 * merge_k`` (the nearest
    kept on overflow), reduces each to its best merge_k
    (``ops.knn_join_select``: the kernel on a card) and merges them with
    ``heap.merge``. Returns (lists, updates, evals), the counts summed
    over the shards as 0-d tensors on devices[0], not read back here.

    Draws: ``draws[p]`` replaces shard p's five uniforms
    (``ShardedBuildDraws``); without it shard p draws them from a
    generator on its device seeded ``_shard_seed(key, p)``."""
    if fetch not in FETCHES:
        raise ValueError(f"unknown fetch {fetch!r}; expected {FETCHES}")
    backend = _ops_backend(cfg)
    P = mesh.size
    devs = mesh.devices
    n_local, k = nl[0].idx.shape
    rho_k, half = cfg.rho_k, n_local * k
    gens = None if draws is not None else [
        _shard_generator(key, p, d) for p, d in enumerate(devs)]

    def uniform(p, i, size):
        if draws is not None:
            return torch.as_tensor(draws[p][i], dtype=torch.float32,
                                   device=devs[p])
        return torch.rand(size, generator=gens[p], device=devs[p])

    # -- selection on the local receivers; remote ones are routed
    cap = max(2 * rho_k * max(n_local // P, 1), 8)
    pay, dest, acc_new, acc_old, keys_new, keys_old, lists = \
        [], [], [], [], [], [], []
    for p, dev in enumerate(devs):
        base = p * n_local
        recv, cand, is_new, valid, _ = selection._incidences(nl[p])
        recv = torch.cat([base + recv[:half], recv[half:]])   # global ids
        cand = torch.cat([cand[:half], base + cand[half:]])
        own = recv - base
        local = (own >= 0) & (own < n_local)
        deg_new = k + torch.zeros(n_local + 1, dtype=torch.int32,
                                  device=dev).index_add_(
            0, torch.where(local, own, n_local).long(),
            (valid & is_new).to(torch.int32))[:n_local]
        p_new = torch.clamp(rho_k / deg_new.clamp_min(1), max=1.0)
        p_edge = torch.where(local, p_new[own.clamp(0, n_local - 1).long()],
                             rho_k / (2.0 * k))
        hit = valid & (uniform(p, 0, recv.shape) < p_edge)
        acc_new.append(hit & is_new)
        acc_old.append(hit & ~is_new)
        # the forward slots sampled this round are joined: not new now
        lists.append(heap.mark_sampled_old(
            nl[p], acc_new[p][:half].reshape(n_local, k)))
        pay.append(torch.stack([recv, cand], dim=1))
        dest.append(recv // n_local)
        keys_new.append(uniform(p, 1, recv.shape))
        keys_old.append(uniform(p, 2, recv.shape))
    got_new = _all_to_all_route(mesh, pay, acc_new, dest, cap, keys_new)
    got_old = _all_to_all_route(mesh, pay, acc_old, dest, cap, keys_old)

    cands = []
    for p in range(P):
        rnd = uniform(p, 3, (P * cap,))

        def compact(got):
            r = got[:, 0]
            ok = r >= 0
            return selection._compact(torch.where(ok, r - p * n_local, -1),
                                      got[:, 1], ok, rnd, n_local, rho_k)
        cands.append((compact(got_new[p]), compact(got_old[p])))

    # -- the candidates' rows, and every pair of each row scored
    flat = [torch.cat([cn.reshape(-1), co.reshape(-1)]) for cn, co in cands]
    if fetch == "a2a":
        feats, fok = fetch_rows_a2a(
            mesh, x_local, flat, cap=max(2 * flat[0].shape[0] // P, 16))
        cands = [(torch.where(ok[:cn.numel()].view_as(cn), cn, -1),
                  torch.where(ok[cn.numel():].view_as(co), co, -1))
                 for (cn, co), ok in zip(cands, fok)]
    else:
        feats = _fetch_features_ring(
            mesh, x_local, [f.clamp(0, P * n_local - 1) for f in flat])
    pay, ok_pairs, dest, keys, evals = [], [], [], [], []
    for p in range(P):
        cn, co = cands[p]
        xg_n = feats[p][:cn.numel()].view(n_local, cn.shape[1], -1)
        xg_o = feats[p][cn.numel():].view(n_local, co.shape[1], -1)
        a, b, dd, ok, ev = join_pairs(cn, co, xg_n, (xg_n * xg_n).sum(-1),
                                      xg_o, (xg_o * xg_o).sum(-1))
        # the distance rides in the int32 payload as its bits
        pay.append(torch.stack([a, b, dd.view(torch.int32)], dim=1))
        ok_pairs.append(ok)
        dest.append(a // n_local)
        keys.append(uniform(p, 4, a.shape))
        evals.append(ev)
    del feats, xg_n, xg_o

    # -- updates to the receivers' owners: invert, select, merge
    cap_u = max(4 * cfg.merge_k * max(n_local // P, 1), 8)
    s_cap = cfg.join_src or 8 * cfg.merge_k
    got = _all_to_all_route(mesh, pay, ok_pairs, dest, cap_u, keys)
    del pay
    out, upds = [], []
    for p, dev in enumerate(devs):
        r = got[p][:, 0]
        ok = r >= 0
        dd = torch.where(ok, got[p][:, 2].contiguous().view(torch.float32),
                         torch.inf)
        rows_of, _ = invert_candidates(
            torch.where(ok, r - p * n_local, -1)[:, None], n_local, s_cap,
            prio=dd[:, None])
        ok_r = rows_of >= 0
        safe = torch.where(ok_r, rows_of, 0).long()
        gd = torch.where(ok_r, dd[safe], torch.inf)
        gi = torch.where(ok_r, got[p][:, 1][safe], -1)
        cd, ci = ops.knn_join_select(
            gd, gi, torch.full((n_local,), torch.inf, device=dev),
            cfg.merge_k, backend=backend)
        merged, upd = heap.merge(lists[p], cd, ci, cand_new=True)
        out.append(merged)
        upds.append(upd.sum())
    return out, mesh.psum(upds), mesh.psum(evals)


def polish_sharded_round(
    mesh: ShardMesh,
    x_local,                # [P] (n_local, d) f32 blocks
    x2_local,               # [P] (n_local,) squared norms
    nl,                     # [P] NeighborLists: local rows, GLOBAL ids
    *,
    merge_c: int,           # select width before the merge (<= k*k)
    backend: str = "auto",  # ops backend (auto | ref)
):
    """One sharded exhaustive polish round: every row joins all k*k of its
    neighbors-of-neighbors. The neighbors' lists come by
    ``fetch_rows_a2a`` (a list it drops masks its k candidates); the
    candidates' rows are given ``fetch_rows_a2a``'s bucket slots (``cap``
    4*n_local*k*k / P; a candidate past its bucket is dropped) but come
    without the padded buckets (``_plan_fetch``), the rows of at most
    ``_POLISH_CHUNK_BYTES`` of candidates at a time: at 17500 rows a
    shard, k 20 and d 784 the buckets would hold 88 GB an owner, where
    the rows a shard needs are 22 GB. Each k*k row is reduced by
    ``ops.knn_join_select`` (k-th prefilter, best ``merge_c``) and merged
    by ``heap.merge``. Returns (lists, updates, evals), the counts summed
    over the shards as 0-d tensors on devices[0]."""
    P = mesh.size
    n_local, k = nl[0].idx.shape
    kk = k * k
    ni = [t.idx for t in nl]
    lists, ok_l = fetch_rows_a2a(mesh, ni, [i.reshape(-1) for i in ni],
                                 cap=max(4 * n_local * k // P, 16))
    rows = max(_POLISH_CHUNK_BYTES // (kk * x_local[0].shape[1]
                                       * x_local[0].element_size()), 1)
    plans = _plan_fetch(mesh, n_local, [t.reshape(-1) for t in lists],
                        cap=max(4 * n_local * kk // P, 16), span=rows * kk)
    out, upds, evals = [], [], []
    for p, dev in enumerate(mesh.devices):
        nb = lists[p].view(n_local, kk)
        src_ok = ((ni[p] >= 0) & ok_l[p].view(n_local, k))[:, :, None] \
            .expand(n_local, k, k).reshape(n_local, kk)
        my = p * n_local + torch.arange(n_local, dtype=torch.int32,
                                        device=dev)
        ok = src_ok & (nb >= 0) & plans[p].ok.view(n_local, kk) \
            & (nb != my[:, None])
        dd = torch.empty((n_local, kk), dtype=torch.float32, device=dev)
        for c, s in enumerate(range(0, n_local, rows)):
            e = min(s + rows, n_local)
            f = _fetch_chunk(mesh, x_local, plans, p, c).view(e - s, kk, -1)
            ab = torch.bmm(f, x_local[p][s:e, :, None])[:, :, 0]
            dd[s:e] = x2_local[p][s:e, None] + (f * f).sum(-1) - 2.0 * ab
            del f
        dd = torch.where(ok, dd.clamp_min(0.0), torch.inf)
        cd, ci = ops.knn_join_select(
            dd, torch.where(ok, nb, -1), nl[p].dist[:, -1].contiguous(),
            merge_c, backend=backend)
        merged, upd = heap.merge(nl[p], cd, ci)
        out.append(merged)
        upds.append(upd.sum())
        evals.append(ok.sum())
    return out, mesh.psum(upds), mesh.psum(evals)


def make_sharded_iteration(mesh: ShardMesh, *, n: int, d: int, k: int,
                           rho: float = 1.0, fetch: str = "a2a"):
    """One sharded iteration at fixed shapes, and the paper's cost model
    of its distance evaluations. Returns (step, model_flops):
    ``step(x, nl, draws=None, key=0)`` runs ``nn_descent_sharded_iteration``
    with ``DescentConfig(k=k, rho=rho, reorder=False)`` on x (n, d) and
    global lists nl (n, k), returning (lists on devices[0], updates,
    evals); ``model_flops = n * (rho_k (rho_k - 1) / 2 + rho_k^2) * 2d``
    (every new x new and new x old pair of a row, 2d operations each in
    the norm expansion's product)."""
    P = mesh.size
    if n % P:
        raise ValueError(f"{n} rows do not split over {P} shards")
    cfg = DescentConfig(k=k, rho=rho, reorder=False)

    def step(x, nl, draws=None, key: int = 0):
        x = torch.as_tensor(x, dtype=torch.float32)
        if tuple(x.shape) != (n, d) or tuple(nl.idx.shape) != (n, k):
            raise ValueError(f"step runs at x ({n}, {d}) and lists ({n}, "
                             f"{k}); got {tuple(x.shape)}, "
                             f"{tuple(nl.idx.shape)}")
        xs = [b.contiguous() for b in mesh.split(x)]
        cols = [mesh.split(t) for t in nl]
        parts = [NeighborLists(*(c[p] for c in cols)) for p in range(P)]
        out, upd, ev = nn_descent_sharded_iteration(
            mesh, xs, [(b * b).sum(1) for b in xs], parts, cfg,
            fetch=fetch, key=key, draws=draws)
        return _lists_on(mesh, out), upd, ev

    rho_k = cfg.rho_k
    return step, n * (rho_k * (rho_k - 1) / 2 + rho_k * rho_k) * 2.0 * d


def build_knn_graph_sharded(
    mesh: ShardMesh,
    x,                      # (n, d) corpus, split by rows over the mesh
    k: int = 20,
    *,
    cfg: DescentConfig | None = None,
    key: int | None = None,
    axis: str = "data",
    draws: ShardedBuildDraws | None = None,
):
    """Sharded NN-Descent over the rows of ``x`` split over the mesh's P
    shards: random initial lists (``_init_lists``), up to
    ``cfg.max_iters`` sampled iterations (``nn_descent_sharded_iteration``
    with ``cfg.fetch``), stopping once an iteration's updates are at most
    ``cfg.delta * n * k``, then ``cfg.polish`` exhaustive rounds
    (``polish_sharded_round``, merge_c = min(6k, k^2)). As in the JAX
    package, ``cfg.reorder``, ``selection``, ``metric`` and ``precision``
    are not read: the build is turbosampling, l2, fp32. ``cfg.backend``
    picks the select's kernel (auto) or its plain version (plain, ref).
    Every block lives on its shard's device; nothing moves to the CPU
    unless the mesh names it. The counts are read back once an iteration
    (the convergence test) and once a polish round.

    Draws: ``draws`` (``ShardedBuildDraws``) replaces every random draw.
    Without it, with ``key`` a 64-bit int seed (default 0), shard p draws
    its initial ids from a generator on its device seeded
    ``_shard_seed(key, p)``, and sampled iteration t from one seeded
    ``_shard_seed((key + (t + 1) * 0xD1B54A32D192ED03) mod 2^64, p)``.

    Returns (dist (n, k) f32 ascending, idx (n, k) i32 global ids, stats
    {"iters", "dist_evals", "polish_updates"}) on devices[0];
    ``dist_evals`` counts the iterations' and polish rounds' pairs."""
    cfg = cfg or DescentConfig(k=k, reorder=False)
    backend = _ops_backend(cfg)
    key = 0 if key is None else int(key)
    P = mesh.shape[axis]
    xs = [b.contiguous() for b in mesh.split(x, torch.float32)]
    n = P * xs[0].shape[0]
    x2s = [(b * b).sum(1) for b in xs]
    nl = _init_lists(mesh, xs, x2s, k, key,
                     None if draws is None else draws.init)
    total_ev, iters = 0, 0
    for it in range(cfg.max_iters):
        nl, upd, ev = nn_descent_sharded_iteration(
            mesh, xs, x2s, nl, cfg, fetch=cfg.fetch,
            key=_stage_key(key, it + 1),
            draws=None if draws is None else draws.iters[it])
        upd, ev = torch.stack([upd, ev]).tolist()
        total_ev += ev
        iters = it + 1
        if upd <= cfg.delta * n * k:
            break
    polish_updates = []
    for _ in range(cfg.polish):
        nl, upd, ev = polish_sharded_round(
            mesh, xs, x2s, nl, merge_c=min(6 * k, k * k), backend=backend)
        upd, ev = torch.stack([upd, ev]).tolist()
        total_ev += ev
        polish_updates.append(upd)
    out = _lists_on(mesh, nl)
    return out.dist, out.idx, {"iters": iters, "dist_evals": total_ev,
                               "polish_updates": tuple(polish_updates)}
