"""Parameter schema system (src/repro/models/params.py).

A model is declared once as a nested dict of ``ParamDef`` leaves (shape,
logical axes, initializer). From that schema come:

  * ``init_tree``         — materialized parameters, drawn from a
                            ``torch.Generator`` on the target device
  * ``abstract_tree``     — tensors on the "meta" device, the
                            counterpart of JAX's ShapeDtypeStructs:
                            shapes and dtypes with no storage
  * ``sharding_tree`` / ``spec_tree`` — a NamedSharding / PartitionSpec
                            per leaf from the logical rules
                            (models/sharding.py)
  * ``count_params`` / ``bytes_params``
  * ``params_from_numpy`` — a parameter tree of the JAX package (numpy
                            leaves, the layer ``stack`` axis included)
                            carried into the port's tensors, so that both
                            packages compute with the same weights
  * ``cast_matrices``     — the weight matrices cast once to the
                            activation dtype (JAX casts them at every use;
                            the numbers are the same)

The layer stack keeps JAX's leading ``stack`` axis; the port's per-layer
loops index it (a view, no copy). The front ends' ``frontend`` subtree
is carried like any other (its matrices cast, its biases kept fp32).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch

from repro_torch.core.device import resolve_device
from repro_torch.models.sharding import (
    ShardingRules,
    logical_sharding,
    logical_to_spec,
)


@dataclasses.dataclass(frozen=True)
class ParamDef:
    """One parameter: shape, logical axes (same arity), init spec."""
    shape: tuple
    logical: tuple
    init: str = "normal"        # normal | zeros | ones | embed | neg
    scale: float | None = None  # stddev; None = 1/sqrt(fan_in)
    dtype: Any = torch.float32

    def __post_init__(self):
        if len(self.shape) != len(self.logical):
            raise ValueError(f"shape {self.shape} and logical axes "
                             f"{self.logical} differ in arity")


def _is_def(x) -> bool:
    return isinstance(x, ParamDef)


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts (and over the matching leaves
    of ``rest``), keys in sorted order as jax.tree does."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_paths(tree, prefix: str = "") -> dict:
    """{"a/b/c": leaf} over the nested dicts."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(tree_paths(tree[k], f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def _fan_in(shape: tuple) -> int:
    # convention: last axis is the output axis for 2D+; fan_in = product of
    # the rest (the stack axis included, as in the JAX schema)
    if len(shape) <= 1:
        return max(shape[0] if shape else 1, 1)
    return max(int(np.prod(shape[:-1])), 1)


def init_leaf(generator: torch.Generator, d: ParamDef) -> torch.Tensor:
    dev = generator.device
    if d.init == "zeros":
        return torch.zeros(d.shape, dtype=d.dtype, device=dev)
    if d.init == "ones":
        return torch.ones(d.shape, dtype=d.dtype, device=dev)
    if d.init == "neg":
        return torch.full(d.shape, -1, dtype=d.dtype, device=dev)
    if d.init == "embed":
        s = d.scale if d.scale is not None else 1.0
    else:
        s = d.scale if d.scale is not None \
            else 1.0 / math.sqrt(_fan_in(d.shape))
    x = torch.randn(d.shape, generator=generator, device=dev,
                    dtype=torch.float32)
    return x.mul_(s).to(d.dtype)


def init_tree(generator: torch.Generator, schema) -> dict:
    """Materialize ``schema`` on the generator's device, one draw per
    random leaf in sorted-key order. The draws are torch's, not JAX's:
    tests that compare the packages carry JAX's weights over with
    ``params_from_numpy``."""
    return tree_map(lambda d: init_leaf(generator, d), schema)


def abstract_tree(schema) -> dict:
    return tree_map(lambda d: torch.empty(d.shape, dtype=d.dtype,
                                          device="meta"), schema)


def sharding_tree(schema, mesh, rules: ShardingRules | None = None) -> dict:
    return tree_map(
        lambda d: logical_sharding(d.logical, mesh, dims=d.shape,
                                   rules=rules), schema)


def spec_tree(schema, mesh, rules: ShardingRules | None = None) -> dict:
    """PartitionSpec tree. ``mesh`` may be anything with a ``.shape``
    mapping (no devices are needed for a spec)."""
    return tree_map(
        lambda d: logical_to_spec(d.logical, mesh, dims=d.shape,
                                  rules=rules), schema)


def count_params(schema) -> int:
    return sum(int(np.prod(d.shape)) for d in tree_leaves(schema))


def bytes_params(schema) -> int:
    return sum(int(np.prod(d.shape)) * d.dtype.itemsize
               for d in tree_leaves(schema))


def _tensor_from_numpy(a, device: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":     # a JAX bf16 array: carry the bits
        t = torch.from_numpy(a.view(np.uint16).astype(np.int16))
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)   # a writable copy


def params_from_numpy(tree, device=None) -> dict:
    """A tree of numpy arrays (a JAX parameter or cache tree passed through
    ``np.asarray``) as tensors on ``device`` ("cuda" unless the caller asks
    for another), same nesting, names, shapes and dtypes."""
    device = resolve_device(device, "params_from_numpy")
    return tree_map(lambda a: _tensor_from_numpy(a, device), tree)


def is_matrix(d: ParamDef) -> bool:
    """A weight matrix: two or more axes besides the layer stack."""
    return sum(ax != "stack" for ax in d.logical) >= 2


def cast_matrices(params: dict, schema, dtype) -> dict:
    """The weight matrices (``is_matrix``) cast once to ``dtype``; norm
    scales and biases keep theirs. The model casts every weight to the
    activation dtype where it is used, as JAX does; after this that cast
    is a no-op, so a full-width decode step reads bf16 weights instead of
    casting 24 GB of fp32 ones."""
    return tree_map(lambda p, d: p.to(dtype) if is_matrix(d) else p,
                    params, schema)
