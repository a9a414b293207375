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

Placed parameters (``ShardedTensor``s on a (data, model) mesh, e.g. by
``sharding_tree``) make the step FSDP's (ZeRO-3), following its inputs'
placements as JAX's jitted step follows theirs, and a placement never
changes the objective: every leaf is gathered once before the forward;
the batch (placed by ``batch_specs``) is split into microbatches as the
unsharded step splits it, and each microbatch at the row boundaries of
its data groups, the distinct row blocks of the batch's placement (a
batch the placement replicates is one group, computed once, not once a
shard); each piece's mean loss is weighted by its share of its
microbatch's valid labels (labels >= 0), so the loss is the
microbatch's nll sum over its valid labels, as JAX's, and ``tokens``
counts the microbatch whole; the gradients are summed in that fixed
order, and each shard's block of the sum is its gradient (the
reduce-scatter); AdamW updates each block in place (optimizer.py), and
the step returns the same placements. With a data axis of 2,
``microbatches=1`` and the valid labels split evenly, each half weighs
1/2 and the arithmetic is the unsharded step's ``microbatches=2`` on
the same halves; the grad norm sums its squares block by block, in
fp64, so both clip by the same scale. The tensor-parallel compute over
``model`` that JAX gets from XLA's partitioner is not reproduced: the
logical shards share one card, where it cannot pay; the placement is
what is kept.

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

from repro_torch.core import cost
from repro_torch.models.model import loss_fn
from repro_torch.models.params import tree_leaves, tree_map
from repro_torch.models.sharding import ShardedTensor, scatter_view
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


def _data_groups(batch: dict, dev) -> tuple:
    """A placed batch whole on ``dev``, and the row bounds of its data
    groups: its placement's distinct row blocks, in order; a batch with
    no placement, or one its placement replicates, is one group."""
    rows = {(idx[0].start, idx[0].stop) for v in batch.values()
            if isinstance(v, ShardedTensor) for idx, _ in v.unique_blocks()}
    full = {k: (v.gather(dev) if isinstance(v, ShardedTensor)
                else torch.as_tensor(v).to(dev)) for k, v in batch.items()}
    b = next(iter(full.values())).shape[0]
    if len(rows) <= 1:
        return full, [(0, b)]
    if (None, None) in rows:
        raise ValueError(f"a batch placed with mixed row blocks: {rows}")
    return full, sorted(rows)


def _pieces(full: dict, groups: list, m: int) -> list:
    """``full``'s ``m`` microbatches along axis 0, each cut at the data
    groups' row bounds: (piece, divisor, microbatch) with the piece's
    mean loss and gradients divided by ``m * max(N, 1) / n`` (n valid
    labels in the piece, N in its microbatch; a piece with none divides
    by inf). One group gives each microbatch whole, divided by m."""
    b = next(iter(full.values())).shape[0]
    assert b % m == 0, (b, m)
    size, out = b // m, []
    for i in range(m):
        lo, hi = i * size, (i + 1) * size
        cuts = [(max(lo, a), min(hi, e)) for a, e in groups
                if max(lo, a) < min(hi, e)]
        valid = [(full["labels"][a:e] >= 0).sum() for a, e in cuts]
        total = torch.clamp_min(sum(valid), 1).double() * m
        for (a, e), n in zip(cuts, valid):
            out.append(({k: v[a:e] for k, v in full.items()},
                        (total / n.double()).float(), i))
    return out


def make_train_step(cfg, tc: TrainConfig) -> Callable:
    """Returns train_step(params, opt_state, batch) -> (p, s, metrics).
    Placed parameters take the FSDP step (the module docstring)."""

    def compute_grads(params, pieces):
        """Gradients of the loss over ``pieces``, (piece, divisor,
        microbatch) triples (the batch's microbatches, or their cuts at
        the data groups), accumulated in their order as ``g / divisor``;
        each microbatch's metrics pool its pieces', and the step's
        average its microbatches' (JAX's mean over its scan)."""
        if len(pieces) == 1:
            _, metrics, grads = _value_and_grad(params, pieces[0][0], cfg)
            return grads, metrics

        acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for p in tree_leaves(params)]
        loss_acc, tokens, correct = 0.0, {}, {}
        for piece, div, i in pieces:
            # pieces of one shape cost the same: on "meta" the cost
            # counter counts the first and replays it (core/cost.py)
            key = ("value_and_grad", id(cfg),
                   tuple((k, tuple(v.shape)) for k, v in piece.items()))
            loss, metrics, grads = cost.repeated(
                key, _value_and_grad, params, piece, cfg)
            for a, g in zip(acc, grads):
                a.add_(g.float() / div)
            del grads
            loss_acc = loss_acc + loss / div
            n = metrics["tokens"]
            tokens[i] = tokens.get(i, 0) + n
            correct[i] = correct.get(i, 0) + torch.round(
                metrics["accuracy"] * torch.clamp_min(n, 1)).long()
        metrics = {
            "tokens": torch.stack(list(tokens.values())).float().mean(),
            "accuracy": torch.stack([
                correct[i] / torch.clamp_min(tokens[i], 1)
                for i in tokens]).float().mean(),
            "loss": loss_acc}
        return acc, metrics

    def update(params, opt_state, grads, metrics):
        guard = torch.isfinite(metrics["loss"]) if tc.nan_guard else None
        params, opt_state, om = opt_mod.apply(
            tc.opt, params, opt_state, grads, guard=guard)
        ok = om.pop("ok", None)
        metrics.update(om)
        if ok is not None:
            metrics["skipped"] = (~ok).to(torch.int32)
        return params, opt_state, metrics

    def sharded_step(params, opt_state: AdamState, batch):
        leaves = tree_leaves(params)
        dev = leaves[0].blocks()[0].device
        full = tree_map(lambda p: p.gather(), params)     # the all-gather
        pieces = _pieces(*_data_groups(batch, dev), tc.microbatches)
        grads, metrics = compute_grads(full, pieces)
        del full
        grads = [scatter_view(g, p.sharding)              # reduce-scatter
                 for g, p in zip(grads, leaves)]
        return update(params, opt_state, grads, metrics)

    def train_step(params, opt_state: AdamState, batch):
        if isinstance(tree_leaves(params)[0], ShardedTensor):
            return sharded_step(params, opt_state, batch)
        dev = tree_leaves(params)[0].device
        batch = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
        b = next(iter(batch.values())).shape[0]
        grads, metrics = compute_grads(
            params, _pieces(batch, [(0, b)], tc.microbatches))
        return update(params, opt_state, grads, metrics)

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
