"""AdamW with global-norm clipping and LR schedules
(src/repro/train/optimizer.py), over the port's nested-dict parameter
trees.

The arithmetic is JAX's, in fp32 and in its order: the bias corrections
from the incremented step, the learning rate from the step before it,
weight decay decoupled and applied to the fp32 parameter. ``step`` is a
0-d int32 tensor on the parameters' device, so the schedule needs no
host sync.

``apply`` updates the parameters and the moments IN PLACE, leaf by leaf
(JAX returns new trees): at full width a second whole copy of params, m
and v would not fit beside them. With ``guard`` (a 0-d bool tensor: the
loss is finite) every write is ``torch.where(ok, new, old)``, ``ok``
being the guard and a finite grad norm, both known before the first
write: a skipped step leaves params and the whole state, ``step``
included, as they were.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch

from repro_torch.models.params import tree_leaves, tree_map


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


def init(params) -> AdamState:
    dev = tree_leaves(params)[0].device
    return AdamState(torch.zeros((), dtype=torch.int32, device=dev),
                     tree_map(torch.zeros_like, params),
                     tree_map(torch.zeros_like, params))


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


def global_norm(tree) -> torch.Tensor:
    leaves = [torch.sum(torch.square(x.float())) for x in _leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


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
    the list of its leaves in ``tree_leaves`` order. Returns (params,
    state, metrics): the same trees, updated, and {"grad_norm", "lr"}
    (with ``guard``, also "ok": whether the update was written)."""
    gnorm = global_norm(grads)
    scale = None
    if cfg.grad_clip:
        scale = torch.clamp_max(
            cfg.grad_clip / torch.clamp_min(gnorm, 1e-12), 1.0)
    ok = None if guard is None else guard & torch.isfinite(gnorm)
    step = state.step + 1
    lr = learning_rate(cfg, state.step)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1.0 - b1 ** step.to(torch.float32)
    bc2 = 1.0 - b2 ** step.to(torch.float32)

    def write(dst, new):
        dst.copy_(new if ok is None else torch.where(ok, new, dst))

    for p, m, v, g in zip(tree_leaves(params), tree_leaves(state.m),
                          tree_leaves(state.v), _leaves(grads)):
        g = g.float()
        if scale is not None:
            g = g * scale
        m_new = b1 * m + (1 - b1) * g
        v_new = b2 * v + (1 - b2) * g * g
        delta = (m_new / bc1) / (torch.sqrt(v_new / bc2) + cfg.eps) \
            + cfg.weight_decay * p.float()
        write(p, (p.float() - lr * delta).to(p.dtype))
        write(m, m_new.to(m.dtype))
        write(v, v_new.to(v.dtype))
    write(state.step, step)
    metrics = {"grad_norm": gnorm, "lr": lr}
    if ok is not None:
        metrics["ok"] = ok
    return params, state, metrics
