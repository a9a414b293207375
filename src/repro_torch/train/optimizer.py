"""AdamW with global-norm clipping and LR schedules
(src/repro/train/optimizer.py), over the port's nested-dict parameter
trees.

The arithmetic is JAX's, in fp32 and in its order (but the grad norm's
fp64 sum, below): the bias corrections from the incremented step, the
learning rate from the step before it, weight decay decoupled and
applied to the fp32 parameter. ``step`` is a
0-d int32 tensor on the parameters' device, so the schedule needs no
host sync.

``apply`` updates the parameters and the moments IN PLACE, leaf by leaf
(JAX returns new trees): at full width a second whole copy of params, m
and v would not fit beside them. With ``guard`` (a 0-d bool tensor: the
loss is finite) every write is ``torch.where(ok, new, old)``, ``ok``
being the guard and a finite grad norm, both known before the first
write: a skipped step leaves params and the whole state, ``step``
included, as they were.

Placed leaves (``ShardedTensor``s, models/sharding.py) are JAX's ZeRO by
sharding (src/repro/train/optimizer.py:1-5): ``init`` places each moment
like its parameter and ``step`` replicated (``PartitionSpec()``), and
``apply`` updates each block in place, the gradients placed like the
parameters. ``global_norm`` reads each distinct block once, so a leaf
replicated over an axis (a norm scale, a head count that does not split)
counts its elements once, and sums the squares in fp64, so the clip
scale does not depend on the blocking; the guard's ``ok`` is one
decision for the whole state. ``abstract_init`` is the state as "meta"
tensors.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch

from repro_torch.core import cost
from repro_torch.models.params import tree_leaves, tree_map
from repro_torch.models.sharding import (
    NamedSharding,
    PartitionSpec,
    ShardedTensor,
    device_put,
)


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    schedule: str = "cosine"       # cosine | linear | constant


class AdamState(NamedTuple):
    step: torch.Tensor             # () int32
    m: Any                         # tree like params
    v: Any


def _blocks(x) -> list:
    """What an in-place update writes: a placed leaf's blocks, or the
    tensor itself."""
    return x.blocks() if isinstance(x, ShardedTensor) else [x]


def init(params) -> AdamState:
    first = tree_leaves(params)[0]
    if isinstance(first, ShardedTensor):
        step = device_put(torch.zeros((), dtype=torch.int32),
                          NamedSharding(first.sharding.mesh, PartitionSpec()))

        def zeros(p):
            return p.map_blocks(torch.zeros_like)
    else:
        step = torch.zeros((), dtype=torch.int32, device=first.device)
        zeros = torch.zeros_like
    return AdamState(step, tree_map(zeros, params), tree_map(zeros, params))


def abstract_init(params_abs) -> AdamState:
    """The state of ``params_abs`` (an ``abstract_tree``) as meta tensors."""
    z = tree_map(lambda a: torch.empty(a.shape, dtype=a.dtype,
                                       device="meta"), params_abs)
    return AdamState(torch.empty((), dtype=torch.int32, device="meta"), z, z)


def learning_rate(cfg: OptimizerConfig, step) -> torch.Tensor:
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp_max((step + 1) / max(cfg.warmup_steps, 1), 1.0)
    if cfg.schedule == "constant":
        decay = 1.0
    else:
        t = torch.clamp((step - cfg.warmup_steps)
                        / max(cfg.total_steps - cfg.warmup_steps, 1),
                        0.0, 1.0)
        if cfg.schedule == "linear":
            decay = 1.0 - (1.0 - cfg.min_lr_ratio) * t
        else:
            decay = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
                1 + torch.cos(math.pi * t))
    return cfg.lr * warm * decay


def _leaves(tree) -> list:
    """A tree's leaves; a list is taken as the leaves already (the train
    step's gradients, in ``tree_leaves`` order)."""
    return tree if isinstance(tree, list) else tree_leaves(tree)


# elements a piece of a leaf's fp64 sum of squares (a 512 MB copy)
_NORM_PIECE = 1 << 26


def _sum_sq(x) -> torch.Tensor:
    """The sum of the squares of ``x``'s elements, each distinct block of
    a placed leaf once, in fp64: each square of an fp32 (or bf16) value
    is exact there, so the sum hardly depends on how the leaf is blocked
    or ordered."""
    blocks = [b for _, b in x.unique_blocks()] \
        if isinstance(x, ShardedTensor) else [x]
    total = torch.zeros((), dtype=torch.float64, device=blocks[0].device)
    for b in blocks:
        # blocks of one shape cost the same: on "meta" the cost counter
        # counts the first and replays it (core/cost.py)
        cost.repeated(("sum_sq", tuple(b.shape), b.stride(), b.dtype),
                         _add_sq, total, b)
    return total


def _add_sq(total: torch.Tensor, b: torch.Tensor) -> None:
    for piece in b.reshape(-1).split(_NORM_PIECE):
        d = piece.to(device=total.device, dtype=torch.float64)
        total += torch.dot(d, d)


def global_norm(tree) -> torch.Tensor:
    """fp32 norm of the fp64 sum of every element's square (JAX sums in
    fp32): a sharded state and its unsharded twin clip by the same scale,
    where a last-bit difference would reach every element's update, and
    Adam's normalization magnifies it wherever a gradient is near eps."""
    sums = [_sum_sq(x) for x in _leaves(tree)]
    total = torch.sum(torch.stack([t.to(sums[0].device) for t in sums]))
    return torch.sqrt(total).to(torch.float32)


def clip_by_global_norm(tree, max_norm: float):
    norm = global_norm(tree)
    scale = torch.clamp_max(max_norm / torch.clamp_min(norm, 1e-12), 1.0)
    return tree_map(lambda g: (g * scale).to(g.dtype), tree), norm


@torch.no_grad()
def apply(
    cfg: OptimizerConfig,
    params,
    state: AdamState,
    grads,
    *,
    guard: torch.Tensor | None = None,
) -> tuple[Any, AdamState, dict]:
    """One AdamW update, in place. ``grads`` is a tree like ``params`` or
    the list of its leaves in ``tree_leaves`` order, each placed like its
    parameter when the parameters are placed. Returns (params, state,
    metrics): the same trees, updated, and {"grad_norm", "lr"} (with
    ``guard``, also "ok": whether the update was written)."""
    gnorm = global_norm(grads)
    scale = None
    if cfg.grad_clip:
        scale = torch.clamp_max(
            cfg.grad_clip / torch.clamp_min(gnorm, 1e-12), 1.0)
    ok = None if guard is None else guard & torch.isfinite(gnorm)
    step_blocks = _blocks(state.step)
    step = step_blocks[0] + 1
    lr = learning_rate(cfg, step_blocks[0])
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1.0 - b1 ** step.to(torch.float32)
    bc2 = 1.0 - b2 ** step.to(torch.float32)

    def write(dst, new):
        dst.copy_(new if ok is None else torch.where(ok.to(dst.device), new,
                                                     dst))

    def on(t, dev):        # a scalar on a block's device (a no-op on one)
        return t if t is None or t.device == dev else t.to(dev)

    def update(pb, mb, vb, gb):
        dev = pb.device
        gb = gb.float()
        if scale is not None:
            gb = gb * on(scale, dev)
        m_new = b1 * mb + (1 - b1) * gb
        v_new = b2 * vb + (1 - b2) * gb * gb
        delta = (m_new / on(bc1, dev)) / (
            torch.sqrt(v_new / on(bc2, dev)) + cfg.eps) \
            + cfg.weight_decay * pb.float()
        write(pb, (pb.float() - on(lr, dev) * delta).to(pb.dtype))
        write(mb, m_new.to(mb.dtype))
        write(vb, v_new.to(vb.dtype))

    for p, m, v, g in zip(tree_leaves(params), tree_leaves(state.m),
                          tree_leaves(state.v), _leaves(grads)):
        if isinstance(p, ShardedTensor) and (
                not isinstance(g, ShardedTensor)
                or g.sharding.spec != p.sharding.spec):
            raise ValueError("a placed parameter needs its gradient placed "
                             f"like it ({p.sharding.spec})")
        for pb, mb, vb, gb in zip(_blocks(p), _blocks(m), _blocks(v),
                                  _blocks(g)):
            # blocks of one shape cost the same (as ``_sum_sq``'s)
            key = ("adam", tuple(pb.shape),
                   *((t.dtype, t.stride()) for t in (pb, mb, vb, gb)))
            cost.repeated(key, update, pb, mb, vb, gb)
    for sb in step_blocks:
        write(sb, on(step, sb.device))
    metrics = {"grad_norm": gnorm, "lr": lr}
    if ok is not None:
        metrics["ok"] = ok
    return params, state, metrics
