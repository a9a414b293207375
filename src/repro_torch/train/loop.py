"""Training step + loop (src/repro/train/loop.py).

``make_train_step`` builds train_step(params, opt_state, batch) ->
(params, opt_state, metrics):

  * microbatch gradient accumulation over splits of the batch's axis 0,
    the gradients summed in fp32 as ``acc + g / m`` and the loss as
    ``loss_acc + loss / m``, the other metrics averaged (JAX's
    ``lax.scan``);
  * the remat policy comes from the model config (models/transformer.py);
  * global-norm clip + AdamW (optimizer.py), applied in place;
  * NaN guard: a non-finite loss or grad norm writes nothing (params and
    the whole optimizer state, ``step`` included, stay as they were) and
    sets ``skipped`` (fault.py's rollback handles repeated failures).

The loop's final save skips a step already on disk: one its cadence has
just saved, or the checkpoint a rollback has just loaded. The
parameters are the caller's tensors: autograd is switched on for them
while the gradients are taken, and the update writes into them. The
batch's tensors move to the parameters' device. ``TrainLoop`` adds
checkpointing, fault recovery and throughput accounting around the step.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import torch

from repro_torch.models.model import loss_fn
from repro_torch.models.params import tree_leaves
from repro_torch.train import optimizer as opt_mod
from repro_torch.train.optimizer import AdamState, OptimizerConfig


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    microbatches: int = 1
    nan_guard: bool = True
    opt: OptimizerConfig = OptimizerConfig()


def _value_and_grad(params, batch, cfg):
    """(loss, metrics, grads as a list in ``tree_leaves`` order); a leaf
    the loss does not reach gets zeros, as JAX gives."""
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    try:
        with torch.enable_grad():
            loss, metrics = loss_fn(params, batch, cfg)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    finally:
        for p in leaves:
            p.requires_grad_(False)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads


def make_train_step(cfg, tc: TrainConfig) -> Callable:
    """Returns train_step(params, opt_state, batch) -> (p, s, metrics)."""

    def compute_grads(params, batch):
        if tc.microbatches <= 1:
            _, metrics, grads = _value_and_grad(params, batch, cfg)
            return grads, metrics

        m = tc.microbatches
        acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for p in tree_leaves(params)]
        loss_acc, ms = 0.0, []
        for i in range(m):
            def split(x):
                b = x.shape[0]
                assert b % m == 0, (b, m)
                return x[i * (b // m):(i + 1) * (b // m)]
            loss, metrics, grads = _value_and_grad(
                params, {k: split(v) for k, v in batch.items()}, cfg)
            for a, g in zip(acc, grads):
                a.add_(g.float() / m)
            del grads
            loss_acc = loss_acc + loss / m
            ms.append(metrics)
        metrics = {k: torch.stack([x[k] for x in ms]).float().mean()
                   for k in ms[0]}
        metrics["loss"] = loss_acc
        return acc, metrics

    def train_step(params, opt_state: AdamState, batch):
        dev = tree_leaves(params)[0].device
        batch = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
        grads, metrics = compute_grads(params, batch)
        guard = torch.isfinite(metrics["loss"]) if tc.nan_guard else None
        params, opt_state, om = opt_mod.apply(
            tc.opt, params, opt_state, grads, guard=guard)
        del grads
        ok = om.pop("ok", None)
        metrics.update(om)
        if ok is not None:
            metrics["skipped"] = (~ok).to(torch.int32)
        return params, opt_state, metrics

    return train_step


@dataclasses.dataclass
class TrainLoop:
    """The Python-side loop: checkpoint cadence, fault policy, throughput."""
    cfg: Any
    tc: TrainConfig
    step_fn: Callable
    checkpointer: Any = None       # train.checkpoint.Checkpointer
    fault: Any = None              # train.fault.FaultPolicy
    log_every: int = 10

    def run(self, params, opt_state, batches, *, start_step: int = 0,
            callback: Callable | None = None):
        history = []
        step = start_step
        saved = None                   # the step of the last save
        t0 = time.time()
        for batch in batches:
            params, opt_state, metrics = self.step_fn(
                params, opt_state, batch)
            if self.fault is not None:
                params, opt_state, rolled = self.fault.after_step(
                    step, params, opt_state, metrics)
                if rolled:
                    # the state is the checkpoint's: saved at that step
                    step = saved = self.fault.last_good_step
                    continue
            step += 1
            if self.checkpointer is not None and \
                    self.checkpointer.maybe_save(step, params, opt_state):
                saved = step
            if step % self.log_every == 0 or not history:
                m = {k: float(v) for k, v in metrics.items()}
                m["step"] = step
                m["steps_per_s"] = (
                    (step - start_step) / max(time.time() - t0, 1e-9))
                history.append(m)
                if callback:
                    callback(m)
        if self.checkpointer is not None:
            # a step already saved is not written twice (JAX's loop writes
            # it again, and the rename onto the committed directory fails)
            if saved == step:
                self.checkpointer.wait()
            else:
                self.checkpointer.save(step, params, opt_state, wait=True)
        return params, opt_state, history
