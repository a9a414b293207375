"""Continuous LM batching with overload-robust admission
(src/repro/serve/scheduler.py, the LM half).

``ContinuousBatcher`` drives a fixed pool of decode slots; requests join
as slots free up, and every ``serve_step`` advances ALL active slots one
token. The decode step keeps B = n_slots; inactive slots carry a dummy
token and their outputs are ignored.

:class:`LaneQueue` is the bounded two-lane (interactive / batch) FIFO with
strict interactive priority, per-request deadlines and explicit shedding:
every request that will not be served carries a typed :class:`Rejection`.

Not ported yet: the retrieval half (``RetrievalScheduler``,
``QueryRequest``, ``SchedulerConfig``) and the batcher's online kNN-LM
datastore growth (``knn_store`` / ``knn_capture``) and its snapshots,
which wait for ``MutableKNNDatastore`` (ROADMAP.md, Queue 1, item 5).
"""
from __future__ import annotations

import collections
import dataclasses
import time
import warnings
from typing import Callable

import numpy as np
import torch

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
    """

    def __init__(self, n_slots: int, step_fn: Callable,
                 prefill_fn: Callable, write_slot: Callable,
                 sampler: Callable | None = None, *,
                 max_queue: int | None = None,
                 shed_policy: str = "reject-new",
                 clock: Callable[[], float] = time.monotonic,
                 **knn):
        if knn:
            raise NotImplementedError(
                f"{sorted(knn)}: the batcher's online kNN-LM datastore "
                "(knn_store, knn_capture and its snapshots) is not ported "
                "yet: ROADMAP.md, Queue 1, item 5")
        self.n_slots = n_slots
        self.step_fn = step_fn
        self.prefill_fn = prefill_fn
        self.write_slot = write_slot
        self.sampler = sampler or (lambda logits: torch.argmax(logits, -1))
        self.slots = [SlotState() for _ in range(n_slots)]
        self.queue = LaneQueue(max_queue, shed_policy)
        self.clock = clock
        self.live: dict[int, Request] = {}
        self.tokens = np.zeros((n_slots, 1), np.int32)
        self.lengths = np.zeros((n_slots,), np.int32)
        self.steps = 0

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
        return cache, True

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
        return cache
