"""Fault-tolerance policy (src/repro/train/fault.py): NaN rollback, a
restart budget, a straggler watchdog, elastic re-meshing.

The train step already refuses to apply a non-finite update (loop.py's
NaN guard); this layer handles the persistent failure modes:

  * ``FaultPolicy`` counts consecutive skipped steps; after
    ``max_consecutive_skips`` it rolls params and optimizer state back to
    the last checkpoint (loaded onto the params' devices, placed leaves
    onto their own mesh) and the loop moves on past the poisonous
    batches. After ``max_restarts`` rollbacks in all it raises.
  * ``StragglerWatchdog`` keeps an EWMA of step wall time; steps slower
    than ``threshold`` x the EWMA are counted and logged.
  * ``elastic_mesh`` builds the largest (data, model) mesh of the live
    devices that keeps the model axis, so losing a shard re-forms a
    smaller data axis; ``Checkpointer.load(shardings=)`` reshards into
    it.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any

import torch

from repro_torch.core.device import resolve_device
from repro_torch.core.distributed import ShardMesh


@dataclasses.dataclass
class FaultPolicy:
    checkpointer: Any                 # train.checkpoint.Checkpointer
    max_consecutive_skips: int = 3
    max_restarts: int = 10
    last_good_step: int = 0
    _consecutive: int = 0
    _restarts: int = 0

    def after_step(self, step: int, params, opt_state, metrics):
        """Returns (params, opt_state, rolled_back: bool)."""
        skipped = bool(metrics.get("skipped", 0))
        if not skipped:
            self._consecutive = 0
            self.last_good_step = step + 1
            return params, opt_state, False
        self._consecutive += 1
        if self._consecutive < self.max_consecutive_skips:
            return params, opt_state, False
        # persistent failure: roll back
        self._restarts += 1
        self._consecutive = 0
        if self._restarts > self.max_restarts:
            raise RuntimeError(
                f"training unstable: {self._restarts} rollbacks "
                f"(step {step}); refusing to continue")
        ck_step = self.checkpointer.latest_step()
        if ck_step is None:
            raise RuntimeError("NaN streak before any checkpoint exists")
        self.checkpointer.wait()
        _, tree = self.checkpointer.load(
            ck_step, like={"params": params, "opt_state": opt_state})
        self.last_good_step = ck_step
        return tree["params"], tree["opt_state"], True


@dataclasses.dataclass
class StragglerWatchdog:
    threshold: float = 2.0            # x EWMA
    alpha: float = 0.1
    ewma: float | None = None
    stragglers: int = 0
    events: list = dataclasses.field(default_factory=list)
    _t_last: float | None = None

    def step_start(self):
        self._t_last = time.time()

    def step_end(self, step: int) -> bool:
        dt = time.time() - self._t_last
        slow = False
        if self.ewma is not None and dt > self.threshold * self.ewma:
            self.stragglers += 1
            self.events.append({"step": step, "dt": dt, "ewma": self.ewma})
            slow = True
            # a straggler should not poison the baseline
            self.ewma = self.ewma * (1 - self.alpha / 4) + dt * self.alpha / 4
        else:
            self.ewma = dt if self.ewma is None else (
                self.ewma * (1 - self.alpha) + dt * self.alpha)
        return slow


def elastic_mesh(devices=None, *, model_axis: int = 16,
                 axis_names=("data", "model")) -> ShardMesh:
    """Largest (data, model) mesh from the live devices (repeats allowed:
    ``["cuda:0"] * 3`` is three live logical shards), preserving the model
    axis (the parameters' layout survives); the data axis shrinks to fit.
    By default the card's devices; with no card that raises."""
    if devices is None:
        resolve_device(None, "elastic_mesh")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = list(devices)
    n = len(devices)
    model = min(model_axis, n)
    while n % model:
        model -= 1
    data = n // model
    return ShardMesh([devices[r * model:(r + 1) * model]
                      for r in range(data)], axis_names)
