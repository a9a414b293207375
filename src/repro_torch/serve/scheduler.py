"""Serving schedulers: continuous LM batching and overload-robust
retrieval dispatch (src/repro/serve/scheduler.py).

``ContinuousBatcher`` drives a fixed pool of decode slots; requests join
as slots free up, and every ``serve_step`` advances ALL active slots one
token. The decode step keeps B = n_slots; inactive slots carry a dummy
token and their outputs are ignored. With a kNN-LM datastore
(``knn_store``, serve/knn_lm.MutableKNNDatastore) it captures each
step's (key, sampled token) pairs, inserts them in fixed-size chunks,
snapshots the datastore periodically and at drain, and cold-starts from
the newest snapshot.

Both schedulers share the overload machinery below:

  * :class:`LaneQueue` — a bounded two-lane (interactive / batch) FIFO
    with strict interactive priority, per-request deadlines and explicit
    shedding: every request that will not be served carries a typed
    :class:`Rejection`.
  * :class:`RetrievalScheduler` — the kNN-serving admission layer: it
    pulls lane-pure batches off the queue, propagates each batch's
    tightest remaining deadline into ``SearchConfig.max_rounds_deadline``
    (the search's per-block round-budget cut) and runs the batch at its
    ``q_block_bucket`` size, so a 7-query interactive burst runs in the
    8-block rather than padding to the full batch block. Overload is
    scripted through the ``sched.burst`` / ``sched.stall`` fault sites
    (core/faults.py), so shedding and expiry are testable without
    wall-clock flakiness.
"""
from __future__ import annotations

import collections
import dataclasses
import math
import time
import warnings
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core import faults
from repro_torch.core.graph_search import SearchConfig, q_block_bucket

LANES = ("interactive", "batch")    # pop order = priority order


@dataclasses.dataclass(frozen=True)
class Rejection:
    """Typed verdict attached to every request the scheduler will not
    serve — the no-silent-drops contract. Codes:

      expired-at-admission  deadline already spent when submitted
      expired-in-queue      deadline passed while waiting for a slot
      queue-full            bounded queue at capacity (reject-new)
      shed-oldest           evicted as oldest batch request to admit a
                            newer one (drop-oldest-batch)
      truncated             scheduler stopped (max_steps) before this
                            request ran
    """
    code: str
    detail: str = ""


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray              # (L,) int32
    max_new: int = 32
    out: list = dataclasses.field(default_factory=list)
    done: bool = False
    # overload-control fields (defaults: unbounded queue, no deadline,
    # nothing sheds)
    lane: str = "interactive"
    deadline_ms: float | None = None
    submitted_at: float | None = None
    rejection: Rejection | None = None
    truncated: bool = False


def _deadline_at(req) -> float | None:
    """Absolute expiry time on the scheduler clock, or None (no deadline
    or unknown submit time — such requests never expire)."""
    if req.deadline_ms is None or req.submitted_at is None:
        return None
    return req.submitted_at + req.deadline_ms / 1e3


class LaneQueue:
    """Bounded two-lane FIFO with typed shedding.

    Interactive requests always pop before batch requests (strict
    priority). ``max_queue`` bounds the TOTAL depth across both lanes
    (None = unbounded). At capacity, ``shed_policy`` decides who pays:

      reject-new        the incoming request is refused (queue-full)
      drop-oldest-batch the oldest queued batch request is evicted
                        (shed-oldest) to admit the newcomer; with no
                        batch request to evict it degrades to reject-new

    Every push/pop takes the current scheduler-clock reading so deadline
    expiry is checked at both boundaries; ``now=None`` skips the checks.
    Counters ``admitted`` / ``shed`` / ``expired`` and :meth:`depth` are
    the queue-side stats.
    """

    def __init__(self, max_queue: int | None = None,
                 shed_policy: str = "reject-new"):
        if shed_policy not in ("reject-new", "drop-oldest-batch"):
            raise ValueError(f"unknown shed_policy {shed_policy!r}")
        if max_queue is not None and max_queue < 1:
            raise ValueError("max_queue must be >= 1 (or None)")
        self.max_queue = max_queue
        self.shed_policy = shed_policy
        self.lanes = {lane: collections.deque() for lane in LANES}
        self.admitted = 0
        self.shed = 0
        self.expired = 0

    def __len__(self) -> int:
        return sum(len(q) for q in self.lanes.values())

    def __iter__(self):
        for lane in LANES:
            yield from self.lanes[lane]

    def depth(self) -> dict:
        return {lane: len(q) for lane, q in self.lanes.items()}

    def push(self, req, now: float | None = None) -> Rejection | None:
        """Admit ``req`` (returns None) or refuse it (returns the
        Rejection, also stored on ``req.rejection``)."""
        lane = req.lane or "interactive"
        if lane not in self.lanes:
            raise ValueError(f"unknown lane {lane!r}")
        if now is not None and req.submitted_at is None:
            req.submitted_at = now
        exp = _deadline_at(req)
        if now is not None and exp is not None and now >= exp:
            self.expired += 1
            req.rejection = Rejection(
                "expired-at-admission",
                f"deadline_ms={req.deadline_ms} already spent at submit")
            return req.rejection
        if self.max_queue is not None and len(self) >= self.max_queue:
            self.shed += 1
            if self.shed_policy == "drop-oldest-batch" \
                    and self.lanes["batch"]:
                victim = self.lanes["batch"].popleft()
                victim.rejection = Rejection(
                    "shed-oldest",
                    "evicted as oldest batch request at capacity "
                    f"{self.max_queue}")
            else:
                req.rejection = Rejection(
                    "queue-full", f"queue at capacity {self.max_queue}")
                return req.rejection
        self.lanes[lane].append(req)
        self.admitted += 1
        return None

    def pop(self, now: float | None = None, lane: str | None = None):
        """Next serviceable request (interactive first), or None.
        Requests whose deadline passed while queued are expired in place
        (typed rejection) and skipped. ``lane`` restricts to one lane."""
        for ln in LANES if lane is None else (lane,):
            q = self.lanes[ln]
            while q:
                req = q.popleft()
                exp = _deadline_at(req)
                if now is not None and exp is not None and now >= exp:
                    self.expired += 1
                    req.rejection = Rejection(
                        "expired-in-queue",
                        f"deadline_ms={req.deadline_ms} passed while "
                        "queued")
                    continue
                return req
        return None


@dataclasses.dataclass
class QueryRequest:
    """One retrieval request in the RetrievalScheduler.

    Terminal states are mutually exclusive and always explicit: either
    results land in ``dist``/``idx`` (served) or ``rejection`` is set
    (shed / expired / truncated). ``injected`` marks ``sched.burst``
    copies, so tests can tell scripted overload from real traffic.
    """
    qid: int
    query: np.ndarray               # (d,) float
    lane: str = "interactive"
    deadline_ms: float | None = None
    submitted_at: float | None = None
    finished_at: float | None = None
    dist: np.ndarray | None = None  # (k_out,) on completion
    idx: np.ndarray | None = None   # (k_out,) on completion
    rejection: Rejection | None = None
    injected: bool = False

    @property
    def done(self) -> bool:
        return self.idx is not None or self.rejection is not None

    @property
    def latency_ms(self) -> float | None:
        if self.finished_at is None or self.submitted_at is None:
            return None
        return (self.finished_at - self.submitted_at) * 1e3


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    """Admission and backpressure knobs for :class:`RetrievalScheduler`."""
    max_queue: int = 256            # total bound across both lanes
    shed_policy: str = "reject-new"     # or "drop-oldest-batch"
    max_batch: int = 64             # requests per dispatch (per pump)
    default_deadline_ms: float | None = None
    #                               # applied when submit() passes None
    min_deadline_s: float = 1e-3    # floor for the propagated budget cut
    result_cache: int = 0           # LRU result-cache capacity, in
    #                               # entries (0 = off), keyed on the
    #                               # int8-quantized query bytes: queries
    #                               # with the same int8 image are answered
    #                               # at admission without a dispatch. The
    #                               # owner MUST invalidate it on every
    #                               # corpus mutation (invalidate_cache).


class RetrievalScheduler:
    """Admission control and deadline propagation for kNN retrieval.

    ``search_fn(queries (m, d) float32 CPU tensor, cfg: SearchConfig) ->
    (dist, idx)`` is the underlying search, typically a closure over
    ``graph_search`` or ``MutableKNNStore.search`` that moves the queries
    to its store's device. The scheduler owns WHEN it runs and with WHAT
    config:

      * :meth:`submit` runs admission through the bounded two-lane
        :class:`LaneQueue`; every refused request carries a typed
        :class:`Rejection` (never a silent drop).
      * :meth:`pump` pops one LANE-PURE batch (the interactive lane
        first) of at most ``cfg.max_batch`` requests and dispatches it
        once, so a small interactive burst runs alone at its
        ``q_block_bucket`` size instead of padding to the batch block.
      * Deadline propagation: the batch's TIGHTEST remaining deadline,
        divided by the number of search blocks the batch will occupy,
        becomes ``SearchConfig.max_rounds_deadline``, the search's
        per-block time slice that cuts late blocks to one round.
      * Result cache (``SchedulerConfig.result_cache`` > 0): an LRU of
        recent (query -> dist / idx) results keyed on the query's
        int8-quantized bytes (``quantize_sym_int8``'s per-row scheme).
        Hits are answered AT ADMISSION (no queue slot, no dispatch,
        counted in ``cache_hits``). Deadline-cut dispatches never
        populate it. The scheduler cannot see the corpus behind
        ``search_fn``: the OWNER must call :meth:`invalidate_cache` after
        every store mutation (insert / delete / restore).

    The scheduler is metric- and filter-agnostic: ``base_cfg.metric``
    rides through to the search closure, and per-tenant ``filter_ids``
    belong INSIDE ``search_fn`` (one scheduler per visibility domain:
    cache keys carry no filter identity).

    Fault sites (core/faults.py): ``sched.burst`` amplifies one submit
    into N injected copies; ``sched.stall`` advances the scheduler's
    clock at the next pump (a GC pause or slow kernel), so queued-deadline
    expiry is scriptable. The clock is injectable (``clock=``).
    """

    def __init__(self, search_fn: Callable, *,
                 base_cfg: SearchConfig | None = None,
                 cfg: SchedulerConfig | None = None,
                 clock: Callable[[], float] = time.monotonic):
        self.search_fn = search_fn
        self.base_cfg = base_cfg or SearchConfig()
        self.cfg = cfg or SchedulerConfig()
        self.queue = LaneQueue(self.cfg.max_queue, self.cfg.shed_policy)
        self._clock = clock
        self._stall = 0.0           # sched.stall virtual-clock offset
        self._next_qid = 0
        self.dispatches = 0
        self.served = 0
        self.latency_ms = {lane: [] for lane in LANES}
        # int8-quantized query bytes -> (dist, idx) numpy copies
        self._cache: collections.OrderedDict = collections.OrderedDict()
        self.cache_hits = 0

    def now(self) -> float:
        return self._clock() + self._stall

    @staticmethod
    def _cache_key(q: np.ndarray) -> bytes:
        """int8 image of the query (scale = max|q| / 127, rounded half to
        even) and the scale's float32 bytes: a collision needs the same
        quantized direction AND magnitude."""
        q = np.asarray(q, np.float32).reshape(-1)
        s = max(float(np.max(np.abs(q))) / 127.0, 1e-30) \
            if q.size else 1e-30
        qi = np.clip(np.round(q / s), -127, 127).astype(np.int8)
        return qi.tobytes() + np.float32(s).tobytes()

    def invalidate_cache(self) -> None:
        """Drop every cached result. Call after ANY mutation of the corpus
        behind ``search_fn`` (insert / delete / restore /
        re-quantization)."""
        self._cache.clear()

    def submit(self, query, *, lane: str = "interactive",
               deadline_ms: float | None = None,
               qid: int | None = None) -> QueryRequest:
        """Admit one query. Returns its QueryRequest: check
        ``.rejection`` for an admission-time refusal. A result-cache hit
        is answered here: the request comes back ``done`` with the cached
        dist / idx and never takes a queue slot. An active ``sched.burst``
        spec submits ``arg`` (default 8) injected copies behind it."""
        if deadline_ms is None:
            deadline_ms = self.cfg.default_deadline_ms
        q = np.asarray(query)
        if qid is None:
            qid = self._next_qid
        self._next_qid = max(self._next_qid, qid) + 1
        req = QueryRequest(qid=qid, query=q, lane=lane,
                           deadline_ms=deadline_ms)
        if self.cfg.result_cache > 0:
            ck = self._cache_key(q)
            hit = self._cache.get(ck)
            if hit is not None:
                self._cache.move_to_end(ck)
                now = self.now()
                req.submitted_at = now
                req.dist, req.idx = hit[0].copy(), hit[1].copy()
                req.finished_at = now
                self.cache_hits += 1
                self.latency_ms[lane].append(0.0)
                return req
        self.queue.push(req, self.now())
        spec = faults.fire("sched.burst")
        if spec is not None:
            n = int(spec.arg) if spec.arg is not None else 8
            for _ in range(max(0, n)):
                copy = QueryRequest(
                    qid=self._next_qid, query=q, lane=lane,
                    deadline_ms=deadline_ms, injected=True)
                self._next_qid += 1
                self.queue.push(copy, self.now())
        return req

    def pump(self) -> list:
        """Dispatch one lane-pure batch. Returns the served requests ([]
        when nothing was serviceable). Full-budget dispatches populate
        the result cache; deadline-cut ones do not."""
        spec = faults.fire("sched.stall")
        if spec is not None:
            self._stall += float(spec.arg) if spec.arg is not None \
                else 0.05
        now = self.now()
        first = self.queue.pop(now)
        if first is None:
            return []
        batch = [first]
        while len(batch) < self.cfg.max_batch:
            nxt = self.queue.pop(now, lane=first.lane)
            if nxt is None:
                break
            batch.append(nxt)
        scfg = self.base_cfg
        nq = len(batch)
        n_blocks = max(1, math.ceil(nq / q_block_bucket(nq, scfg)))
        rem = [_deadline_at(r) - now for r in batch
               if _deadline_at(r) is not None]
        if rem:
            slice_s = max(min(rem), self.cfg.min_deadline_s) / n_blocks
            scfg = dataclasses.replace(scfg, max_rounds_deadline=slice_s)
        queries = torch.from_numpy(np.stack(
            [np.asarray(r.query, np.float32) for r in batch]))
        dist, idx = self.search_fn(queries, scfg)
        dist, idx = _host(dist), _host(idx)
        end = self.now()
        for j, r in enumerate(batch):
            r.dist, r.idx, r.finished_at = dist[j], idx[j], end
            if r.latency_ms is not None:
                self.latency_ms[r.lane].append(r.latency_ms)
            if self.cfg.result_cache > 0 and not rem:
                self._cache[self._cache_key(r.query)] = (
                    dist[j].copy(), idx[j].copy())
        while len(self._cache) > self.cfg.result_cache:
            self._cache.popitem(last=False)
        self.dispatches += 1
        self.served += nq
        return batch

    def run_until_drained(self, *, max_pumps: int = 10_000) -> list:
        """Pump until the queue is empty; returns every served request.
        Exhausting ``max_pumps`` marks the leftovers truncated (typed
        rejection) and warns. The scheduler stays usable afterwards."""
        served = []
        pumps = 0
        while len(self.queue) and pumps < max_pumps:
            served.extend(self.pump())
            pumps += 1
        leftover = [r for r in self.queue]
        if leftover:
            for r in leftover:
                r.rejection = Rejection(
                    "truncated",
                    f"run_until_drained(max_pumps={max_pumps}) exhausted")
            for q in self.queue.lanes.values():
                q.clear()
            warnings.warn(
                f"run_until_drained(max_pumps={max_pumps}) exhausted "
                f"with {len(leftover)} request(s) still queued; marked "
                "truncated", RuntimeWarning, stacklevel=2)
        return served

    def stats(self) -> dict:
        q = self.queue
        return {
            "depth": q.depth(),
            "admitted": q.admitted,
            "shed": q.shed,
            "expired": q.expired,
            "served": self.served,
            "dispatches": self.dispatches,
            "cache_hits": self.cache_hits,
            "cache_size": len(self._cache),
            "latency_ms": {lane: list(v)
                           for lane, v in self.latency_ms.items()},
        }


@dataclasses.dataclass
class SlotState:
    active: bool = False
    rid: int = -1
    remaining: int = 0


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class ContinuousBatcher:
    """Drives serve_step over a slot pool.

    prefill_fn(tokens (1, L) int32 numpy) -> (last_logits (1, V),
                                              cache_for_one, L)
    step_fn(cache, tokens (B, 1), lengths (B,)) -> (logits (B, V), cache);
        tokens and lengths are int32 CPU tensors, the step moves them
    write_slot(cache, slot_idx, one_cache, length) -> cache
    sampler(logits) -> token ids (default: greedy argmax)

    Online kNN-LM datastore growth (``knn_store``, a
    ``MutableKNNDatastore``): ``knn_capture(logits) -> (B, d)`` keys give
    each active slot's (key, sampled token) pair, in slot order; full
    ``knn_chunk`` batches are inserted during ``step`` and the tail when
    the stream drains. Each insert draws from a generator on the store's
    device seeded by (17, ``steps``); ``knn_insert_draws(steps, m) ->
    dict`` (``entry`` / ``route_fill``) replaces the seed search's draw.
    ``knn_frontier_chunk`` / ``knn_q_block`` replace the store's
    ``OnlineConfig.chunk`` / ``q_block`` and ``knn_router`` attaches a
    router (True = the default ``RouterConfig``), without a rebuild.
    With ``knn_snapshot_dir`` and no store, the batcher cold-starts from
    the newest committed snapshot onto ``device`` (the card unless the
    caller asks otherwise); every ``knn_snapshot_every`` captured rows an
    async snapshot is written, and ``run`` ends with a drain snapshot.
    """

    def __init__(self, n_slots: int, step_fn: Callable,
                 prefill_fn: Callable, write_slot: Callable,
                 sampler: Callable | None = None, *,
                 knn_store: Any | None = None,
                 knn_capture: Callable | None = None,
                 knn_chunk: int = 64,
                 knn_frontier_chunk: int | None = None,
                 knn_q_block: int | None = None,
                 knn_router: Any | None = None,
                 knn_snapshot_dir: str | None = None,
                 knn_snapshot_every: int = 0,
                 knn_snapshot_keep: int = 3,
                 knn_insert_draws: Callable | None = None,
                 max_queue: int | None = None,
                 shed_policy: str = "reject-new",
                 clock: Callable[[], float] = time.monotonic,
                 device=None):
        self.n_slots = n_slots
        self.step_fn = step_fn
        self.prefill_fn = prefill_fn
        self.write_slot = write_slot
        self.sampler = sampler or (lambda logits: torch.argmax(logits, -1))
        # persistence (core/persist.py): a cold start from the newest
        # committed snapshot instead of a rebuild, and checkpoints of the
        # streamed inserts by an async writer off the decode path
        self._knn_writer = None
        self._knn_snapshot_every = int(knn_snapshot_every)
        self._knn_rows_inserted = 0
        self._knn_rows_at_snap = 0
        if knn_snapshot_dir is not None:
            from repro_torch.core import persist
            if knn_store is None \
                    and persist.latest_snapshot(knn_snapshot_dir) is not None:
                from repro_torch.serve.knn_lm import MutableKNNDatastore
                knn_store = MutableKNNDatastore.restore(knn_snapshot_dir,
                                                        device=device)
            self._knn_writer = persist.SnapshotWriter(
                knn_snapshot_dir, keep=knn_snapshot_keep)
        if knn_store is not None and hasattr(knn_store, "store"):
            store_cfg = knn_store.store.cfg
            if knn_frontier_chunk is not None:
                store_cfg = dataclasses.replace(store_cfg,
                                                chunk=knn_frontier_chunk)
            if knn_q_block is not None:
                store_cfg = dataclasses.replace(store_cfg,
                                                q_block=knn_q_block)
            if store_cfg is not knn_store.store.cfg:
                knn_store = dataclasses.replace(
                    knn_store,
                    store=dataclasses.replace(knn_store.store,
                                              cfg=store_cfg))
            if knn_router is not None:
                from repro_torch.core.online import ensure_router
                rcfg = None if knn_router is True else knn_router
                knn_store = dataclasses.replace(
                    knn_store, store=ensure_router(knn_store.store, rcfg))
        self.slots = [SlotState() for _ in range(n_slots)]
        self.queue = LaneQueue(max_queue, shed_policy)
        self.clock = clock
        self.live: dict[int, Request] = {}
        self.tokens = np.zeros((n_slots, 1), np.int32)
        self.lengths = np.zeros((n_slots,), np.int32)
        self.steps = 0
        self.knn_store = knn_store
        self.knn_capture = knn_capture
        self.knn_chunk = knn_chunk
        self.knn_insert_draws = knn_insert_draws
        # captured keys wait as (rows, d) blocks in capture order, on the
        # capture's device; their tokens as host ints
        self._knn_keys: list[torch.Tensor] = []
        self._knn_vals: list[int] = []

    def submit(self, req: Request) -> Rejection | None:
        """Queue a request. Returns None when admitted, or the typed
        Rejection (also stored on ``req.rejection``) when the bounded
        queue refuses it."""
        return self.queue.push(req, self.clock())

    def _admit(self, cache):
        for i, s in enumerate(self.slots):
            if s.active:
                continue
            req = self.queue.pop(self.clock())
            if req is None:
                break
            logits, one_cache, plen = self.prefill_fn(req.prompt[None, :])
            cache = self.write_slot(cache, i, one_cache, plen)
            first = int(self.sampler(logits[0]))
            req.out.append(first)
            self.tokens[i, 0] = first
            self.lengths[i] = plen
            self.slots[i] = SlotState(True, req.rid, req.max_new - 1)
            self.live[req.rid] = req
        return cache

    def step(self, cache):
        """One decode step for every active slot; returns the cache and
        whether a step ran."""
        cache = self._admit(cache)
        if not any(s.active for s in self.slots):
            return cache, False
        logits, cache = self.step_fn(
            cache, torch.from_numpy(self.tokens.copy()),
            torch.from_numpy(self.lengths.copy()))
        nxt = _host(self.sampler(logits))
        if self.knn_store is not None and self.knn_capture is not None:
            keys = torch.as_tensor(self.knn_capture(logits))
            act = [i for i, s in enumerate(self.slots) if s.active]
            self._knn_keys.append(keys if len(act) == keys.shape[0]
                                  else keys[act])
            self._knn_vals.extend(int(nxt[i]) for i in act)
            self._flush_knn()
        for i, s in enumerate(self.slots):
            if not s.active:
                continue
            self.lengths[i] += 1
            tok = int(nxt[i])
            self.tokens[i, 0] = tok
            req = self.live[s.rid]
            req.out.append(tok)
            s.remaining -= 1
            if s.remaining <= 0:
                req.done = True
                del self.live[s.rid]
                self.slots[i] = SlotState()
        self.steps += 1
        if self.knn_store is not None and not self.live and not self.queue:
            # stream drained: flush the sub-chunk tail, so callers that
            # drive step() themselves lose nothing
            self._flush_knn(final=True)
        return cache, True

    def flush_knn(self):
        """Flush any buffered (key, token) pairs into the datastore."""
        if self.knn_store is not None:
            self._flush_knn(final=True)

    def _flush_knn(self, final: bool = False):
        """Insert buffered pairs in ``knn_chunk``-sized batches; a
        ``final`` flush takes the remainder as one smaller batch."""
        while len(self._knn_vals) >= self.knn_chunk:
            self._knn_insert(self.knn_chunk)
        if final and self._knn_vals:
            self._knn_insert(len(self._knn_vals))

    def _knn_insert(self, m: int):
        keys = torch.cat(self._knn_keys) if len(self._knn_keys) > 1 \
            else self._knn_keys[0]
        self._knn_keys = [keys[m:]] if keys.shape[0] > m else []
        vb = torch.tensor(self._knn_vals[:m], dtype=torch.int32)
        del self._knn_vals[:m]
        draws = {} if self.knn_insert_draws is None \
            else self.knn_insert_draws(self.steps, m)
        dev = self.knn_store.store.x.device \
            if hasattr(self.knn_store, "store") else keys.device
        gen = torch.Generator(device=dev).manual_seed((17 << 32)
                                                      + self.steps)
        self.knn_store, _ = self.knn_store.append(keys[:m], vb,
                                                  generator=gen, **draws)
        self._knn_rows_inserted += m
        if (self._knn_writer is not None and self._knn_snapshot_every > 0
                and (self._knn_rows_inserted - self._knn_rows_at_snap
                     >= self._knn_snapshot_every)):
            self.snapshot_knn(wait=False)

    def snapshot_knn(self, *, wait: bool = True):
        """Snapshot the datastore now (step = its allocation high-water
        mark). ``wait=False`` hands the copy and the write to the async
        writer; the capture is consistent either way (``append`` writes
        new tensors, never the captured ones)."""
        if self._knn_writer is None or self.knn_store is None:
            return
        self._knn_writer.save(
            self.knn_store.store, self.knn_store.store.n,
            values=self.knn_store.values, wait=wait)
        self._knn_rows_at_snap = self._knn_rows_inserted

    def run(self, cache, *, max_steps: int = 10_000):
        while (len(self.queue) or self.live) and self.steps < max_steps:
            cache, _ = self.step(cache)
        leftover = len(self.queue) + len(self.live)
        if leftover:
            # max_steps exhausted with work outstanding: mark every
            # queued/live request truncated (partial output stays in
            # ``req.out``) instead of returning as if nothing happened
            for req in list(self.live.values()):
                req.truncated = True
            for req in self.queue:
                req.truncated = True
            warnings.warn(
                f"run(max_steps={max_steps}) exhausted with {leftover} "
                "request(s) unfinished; marked truncated",
                RuntimeWarning, stacklevel=2)
        if self.knn_store is not None:
            self._flush_knn(final=True)
            if self._knn_writer is not None:
                # drain checkpoint: the next cold start resumes from the
                # full stream. A pending error from an earlier PERIODIC
                # write must not abort it (the drain supersedes what that
                # write would have saved): it is a warning once the drain
                # commits, and re-raised only if the drain fails too.
                periodic_err = self._knn_writer.poll()
                try:
                    self.snapshot_knn(wait=True)
                except Exception:
                    if periodic_err is not None:
                        warnings.warn(
                            "periodic background snapshot had already "
                            f"failed before the drain: {periodic_err}",
                            RuntimeWarning, stacklevel=2)
                    raise
                if periodic_err is not None:
                    warnings.warn(
                        "a periodic background snapshot failed "
                        f"({periodic_err}); the drain snapshot committed "
                        "and supersedes it", RuntimeWarning, stacklevel=2)
        return cache
