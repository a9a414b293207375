"""Deterministic, seedable fault injection (a copy of the JAX package's
stdlib-only module: the port imports nothing of it).

A ``FaultPlan`` is a seeded registry of ``FaultSpec`` entries keyed by
site; an injectable site calls ``fire`` (or ``maybe_raise``) at its
boundary. With no plan active, ``fire`` is one ``is None`` test.

Sites the port consults so far:

  * ``persist.write``  — raise ``InjectedFault`` inside
    ``core/persist.write_snapshot`` before the COMMIT marker lands, so
    the staged snapshot is never committed;
  * ``persist.torn``   — truncate one array file of a committed snapshot
    (``arg`` = a filename substring, default the first ``.npy``): a torn
    page that the COMMIT ordering cannot catch;
  * ``persist.rename`` — fail the quarantine rename in ``restore_store``'s
    fallback;
  * ``router.rebuild`` — fail the lazy router rebuild in
    ``core/online._maybe_rebuild_router`` (the store keeps serving the
    stale router);
  * ``sched.burst``   — amplify one ``RetrievalScheduler.submit`` into
    ``arg`` (default 8) injected copies (serve/scheduler.py);
  * ``sched.stall``   — advance the retrieval scheduler's clock by ``arg``
    seconds (default 0.05) at the next ``pump``;
  * ``shard.dead`` / ``shard.slow`` (``dead_shards``) and
    ``shard.degrade`` (``degrade_factors``) — read by the sharded search
    (``core/distributed.graph_search_sharded``).

``poison_batch`` manufactures the adversarial query batches (NaN, Inf,
a wrong feature dim) that the search's admission checks must catch.

A spec with ``prob < 1.0`` draws from a per-site ``random.Random`` seeded
by ``(plan.seed, site)``, so two runs of one plan see the same schedule;
``times`` / ``after`` gate on a per-site event counter.
"""
from __future__ import annotations

import contextlib
import random
import threading
from dataclasses import dataclass, field


class InjectedFault(OSError):
    """Raised by an injected fault site (an ``OSError``, so code that
    retries transient I/O errors exercises its real retry path)."""


@dataclass(frozen=True)
class FaultSpec:
    """One scripted fault: ``site``, a site-specific ``mode``, a per-event
    trigger probability ``prob``, at most ``times`` triggers (None =
    unlimited) after skipping the first ``after`` events, and a
    site-specific ``arg``."""
    site: str
    mode: str = "error"
    prob: float = 1.0
    times: int | None = None
    after: int = 0
    arg: object = None


@dataclass
class FaultPlan:
    """A seeded set of fault specs plus per-site trigger accounting."""
    seed: int = 0
    specs: tuple = ()
    _counts: dict = field(default_factory=dict, repr=False)
    _fired: dict = field(default_factory=dict, repr=False)
    _rngs: dict = field(default_factory=dict, repr=False)
    _lock: threading.Lock = field(default_factory=threading.Lock,
                                  repr=False)

    def check(self, site: str):
        """The triggering FaultSpec for this event at ``site``, or None.
        Advances the per-site event counter either way."""
        with self._lock:
            event = self._counts.get(site, 0)
            self._counts[site] = event + 1
            for i, spec in enumerate(self.specs):
                if spec.site != site or event < spec.after:
                    continue
                key = (site, i)
                if spec.times is not None and \
                        self._fired.get(key, 0) >= spec.times:
                    continue
                if spec.prob < 1.0:
                    rng = self._rngs.get(site)
                    if rng is None:
                        rng = random.Random((self.seed, site).__repr__())
                        self._rngs[site] = rng
                    if rng.random() >= spec.prob:
                        continue
                self._fired[key] = self._fired.get(key, 0) + 1
                return spec
        return None

    def fired(self, site: str | None = None) -> int:
        """How many injections triggered (at ``site``, or anywhere)."""
        with self._lock:
            return sum(n for (s, _), n in self._fired.items()
                       if site is None or s == site)

    @contextlib.contextmanager
    def active(self):
        """Install this plan for the duration of the block."""
        activate(self)
        try:
            yield self
        finally:
            deactivate()


# The active plan: module-level so every site pays one ``is None`` test
# when no plan is installed.
_PLAN: FaultPlan | None = None


def activate(plan: FaultPlan) -> None:
    global _PLAN
    _PLAN = plan


def deactivate() -> None:
    global _PLAN
    _PLAN = None


def fire(site: str):
    """Consult the active plan at an injection site: the triggering
    ``FaultSpec``, or None."""
    if _PLAN is None:
        return None
    return _PLAN.check(site)


def maybe_raise(site: str) -> None:
    """``fire``, raising ``InjectedFault`` when it triggers."""
    if fire(site) is not None:
        raise InjectedFault(f"injected fault at {site}")


def dead_shards(n_shards: int) -> list:
    """The shard indices the active plan marks dead or slow (a shard past
    its timeout degrades like a dead one), sorted, in [0, n_shards); []
    with no plan."""
    if _PLAN is None:
        return []
    out = set()
    for site in ("shard.dead", "shard.slow"):
        spec = fire(site)
        if spec is None:
            continue
        arg = spec.arg
        for i in arg if isinstance(arg, (list, tuple)) else [arg]:
            if i is not None and 0 <= int(i) < n_shards:
                out.add(int(i))
    return sorted(out)


def degrade_factors(n_shards: int) -> dict:
    """Per-shard latency factors from the active plan's ``shard.degrade``
    spec: ``arg`` a shard index (factor 10), a ``(shard, factor)`` pair,
    or a list of either. {} with no plan or when the spec does not fire
    this event."""
    if _PLAN is None:
        return {}
    spec = fire("shard.degrade")
    if spec is None:
        return {}
    arg = spec.arg
    if isinstance(arg, tuple) and len(arg) == 2 \
            and isinstance(arg[1], float):
        items = [arg]                     # one bare (shard, factor) pair
    elif isinstance(arg, (list, tuple)):
        items = list(arg)
    else:
        items = [arg]
    out = {}
    for it in items:
        if isinstance(it, (list, tuple)):
            s, f = int(it[0]), float(it[1])
        else:
            s, f = int(it), 10.0
        if 0 <= s < n_shards:
            out[s] = f
    return out


def poison_batch(queries, mode: str):
    """An adversarial copy of a clean query batch, a float32 tensor on the
    batch's device: "nan" poisons the first eighth of the rows (at least
    one) with NaN in column 0, "inf" fills them with +Inf / -Inf in
    alternate columns, "dim" appends a feature column. Imports torch
    lazily, so the module stays stdlib-only otherwise."""
    import torch
    q = torch.as_tensor(queries, dtype=torch.float32).clone()
    if mode == "dim":
        return torch.cat([q, q[:, :1]], dim=1)
    bad = max(1, q.shape[0] // 8)
    if mode == "nan":
        q[:bad, 0] = torch.nan
    elif mode == "inf":
        q[:bad, ::2] = torch.inf
        q[:bad, 1::2] = -torch.inf
    else:
        raise ValueError(f"unknown poison mode {mode!r}")
    return q
