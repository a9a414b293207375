"""Deterministic, seedable fault injection, the part the online store
uses (a copy of the JAX package's stdlib-only module: the port imports
nothing of it).

A ``FaultPlan`` is a seeded registry of ``FaultSpec`` entries keyed by
site; an injectable site calls ``fire`` (or ``maybe_raise``) at its
boundary. With no plan active, ``fire`` is one ``is None`` test.

Sites the port consults so far:

  * ``router.rebuild`` — fail the lazy router rebuild in
    ``core/online._maybe_rebuild_router`` (the store keeps serving the
    stale router).

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
