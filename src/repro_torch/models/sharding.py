"""Logical-axis sharding rules (src/repro/models/sharding.py) and the
placement of tensors on a ``ShardMesh`` by them.

Every parameter / activation axis in the model stack carries a LOGICAL
name; the rules map logical names onto the axes of the production
meshes (launch/mesh.py):

    single-pod:  (data=16, model=16)
    multi-pod:   (pod=2, data=16, model=16)

    batch                 -> ('pod', 'data')   (DP over pods and data axis)
    vocab/heads/d_ff/...  -> 'model'           (TP)
    d_model on params     -> 'data'            (FSDP: ZeRO-3 style)
    kv_seq (decode cache) -> 'data'            (long-context sequence shard)
    experts               -> 'model'           (EP when divisible)

A rule maps a logical axis to a priority list of mesh axes; the first
candidate present in the mesh, not yet used by an earlier axis of the
same tensor, and dividing the dimension is chosen (so a 14-head
attention falls back to unsharded heads instead of failing).

``device_put(x, sharding)`` is ``jax.device_put``'s counterpart: it
returns a ``ShardedTensor`` whose blocks sit on the devices of their
mesh positions. The port's meshes are logical shards (``["cuda:0"] * 4``
is four shards on one card), so the blocks that replicas of one index
share on one device are ONE tensor: a replicated leaf costs its size
once, and an in-place update writes it once. ``addressable_shards``
lists every mesh position's (index, block) in row-major order, replicas
repeating the block, as JAX lists them.

``shard_act`` is the identity, as JAX's is outside a mesh context: the
port's sharded train step computes each data shard's rows whole, with
the parameters gathered (train/loop.py), so there is no activation
layout to constrain, and the model code carries no ``shard_act`` calls.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.core import cost

# logical axis -> candidate mesh axes, in priority order. A tuple entry
# means "all of these together" (e.g. batch over pod AND data).
DEFAULT_RULES: dict[str, tuple] = {
    "batch": (("pod", "data"),),
    "batch_nopod": (("data",),),
    "seq": (),                      # activations: sequence unsharded (train)
    "seq_act": (("model",),),       # sequence parallel (JAX's constraints)
    "kv_seq": (("data",), ("model",)),   # decode KV cache sequence axis;
                                    # falls to model when data is taken by
                                    # batch and kv_heads can't use model
    "vocab": (("model",),),
    "heads": (("model",),),
    "kv_heads": (("model",),),
    "d_ff": (("model",),),
    "d_model": (("data",),),        # params only (FSDP axis)
    "d_model_act": (),              # activations: d_model replicated
    "experts": (("model",),),
    "expert_cap": (("data", "model"), ("data",)),  # MoE capacity axis:
                                    # both axes when EP is unavailable
    "ssm_state": (),
    "ssm_heads": (("model",),),
    "conv_k": (),
    "frontend": (),
    "lora": (),
    "stack": (),                    # the layer stack axis: never sharded
    None: (),
}


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    rules: tuple = tuple(DEFAULT_RULES.items())

    def as_dict(self) -> dict:
        return dict(self.rules)


class PartitionSpec(tuple):
    """``jax.sharding.PartitionSpec``'s counterpart: one entry a tensor
    dimension, each None (replicated), a mesh axis name, or a tuple of
    names (sharded over their product, the first the major)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


def _pick_axes(
    logical: str | None,
    dim: int | None,
    mesh,
    rules: dict[str, tuple],
    used: set | None = None,
) -> tuple[str, ...] | None:
    """Choose mesh axes for one logical axis (None = replicate). A
    candidate is skipped when any of its axes is already ``used`` by an
    earlier logical axis of the same value, so priority lists fall
    through (e.g. kv_seq: data taken by batch -> model)."""
    for cand in rules.get(logical, ()):
        axes = cand if isinstance(cand, tuple) else (cand,)
        axes = tuple(a for a in axes if a in mesh.shape)
        if not axes:
            continue
        if used is not None and any(a in used for a in axes):
            continue
        total = 1
        for a in axes:
            total *= mesh.shape[a]
        if dim is None or dim % total == 0:
            return axes
    return None


def logical_to_spec(
    logical_axes: Sequence[str | None],
    mesh,
    *,
    dims: Sequence[int] | None = None,
    rules: ShardingRules | None = None,
) -> PartitionSpec:
    """Map a tuple of logical axis names to a PartitionSpec for ``mesh``
    (anything with a ``.shape`` mapping of axis names to sizes).

    ``dims`` (optional) enables divisibility fallback: a logical axis whose
    size does not divide by its mesh-axis product is replicated instead.
    A mesh axis is used at most once (first logical axis wins).
    """
    rd = (rules or ShardingRules()).as_dict()
    used: set[str] = set()
    out = []
    for i, name in enumerate(logical_axes):
        dim = None if dims is None else dims[i]
        axes = _pick_axes(name, dim, mesh, rd, used)
        if axes is None:
            out.append(None)
        else:
            used.update(axes)
            out.append(axes[0] if len(axes) == 1 else axes)
    return PartitionSpec(*out)


def _entry_axes(entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A ``PartitionSpec`` over a ``ShardMesh``: where each block of a
    tensor of a given shape lives. Two are equal on the same mesh object
    with equal specs."""
    mesh: object
    spec: PartitionSpec

    def __post_init__(self):
        axes = [a for e in self.spec for a in _entry_axes(e)]
        if len(set(axes)) != len(axes) or \
                any(a not in self.mesh.shape for a in axes):
            raise ValueError(f"spec {self.spec} does not fit the mesh "
                             f"{self.mesh.shape}")

    def _parts(self, shape) -> list:
        """(entry's axes, number of blocks) for each dimension."""
        shape = tuple(shape)
        if len(self.spec) > len(shape):
            raise ValueError(f"spec {self.spec} has more entries than the "
                             f"shape {shape} has dimensions")
        entries = tuple(self.spec) + (None,) * (len(shape) - len(self.spec))
        out = []
        for n, e in zip(shape, entries):
            axes = _entry_axes(e)
            parts = int(np.prod([self.mesh.shape[a] for a in axes]))
            if n % parts:
                raise ValueError(f"dimension {n} of {shape} does not split "
                                 f"over {axes} ({parts} blocks)")
            out.append((axes, parts))
        return out

    def shard_shape(self, shape) -> tuple:
        return tuple(n // parts for n, (_, parts)
                     in zip(tuple(shape), self._parts(shape)))

    def indices(self, shape) -> list:
        """The block index (a tuple of slices) of each mesh position, in
        row-major order: ``slice(None)`` on a dimension in one block, as
        JAX's ``addressable_shards`` give them."""
        parts = self._parts(shape)
        out = []
        for p in range(self.mesh.size):
            at = self.mesh.coords(p)
            idx = []
            for n, (axes, count) in zip(tuple(shape), parts):
                if count == 1:
                    idx.append(slice(None))
                    continue
                pos = 0
                for a in axes:
                    pos = pos * self.mesh.shape[a] + at[a]
                step = n // count
                idx.append(slice(pos * step, (pos + 1) * step))
            out.append(tuple(idx))
        return out


def _index_key(index) -> tuple:
    return tuple((s.start, s.stop) for s in index)


class Shard(NamedTuple):
    index: tuple                   # of slices, as JAX's Shard.index
    data: torch.Tensor


class ShardedTensor:
    """A global tensor placed by a ``NamedSharding``: ``shape``, ``dtype``,
    ``sharding``; ``addressable_shards`` and ``gather``. Made by
    ``device_put`` (or ``map_blocks`` of another); one tensor a distinct
    (index, device)."""

    def __init__(self, shape, dtype, sharding: NamedSharding, blocks: dict):
        self.shape = torch.Size(shape)
        self.dtype = dtype
        self.sharding = sharding
        self._blocks = blocks        # (index key, device) -> tensor
        self._where = [(idx, (_index_key(idx), dev)) for idx, dev in zip(
            sharding.indices(shape), sharding.mesh.devices)]

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def addressable_shards(self) -> list:
        return [Shard(idx, self._blocks[key]) for idx, key in self._where]

    def blocks(self) -> list:
        """Each distinct (index, device)'s block once, in the order of
        their first mesh position: what an in-place update writes."""
        return list(self._blocks.values())

    def unique_blocks(self) -> list:
        """(index, block), each distinct index once (its first device's
        copy): what a reduction over the tensor's elements reads."""
        seen, out = set(), []
        for idx, key in self._where:
            if key[0] not in seen:
                seen.add(key[0])
                out.append((idx, self._blocks[key]))
        return out

    def map_blocks(self, fn) -> "ShardedTensor":
        """A tensor of the same placement, ``fn`` of each block (zeros for
        the moments); the new blocks' dtype is the first one's."""
        blocks = {k: fn(b) for k, b in self._blocks.items()}
        return ShardedTensor(self.shape, next(iter(blocks.values())).dtype,
                             self.sharding, blocks)

    def gather(self, device=None) -> torch.Tensor:
        """The whole tensor, bit for bit, on ``device`` (default: the
        mesh's first device). Under the cost counter, a tensor split into
        blocks counts as an all-gather of its whole bytes (cross-node
        where it is split over ``pod``)."""
        _count_collective("all-gather", self.shape, self.dtype,
                          self.sharding)
        first = self.unique_blocks()[0][1]
        out = torch.empty(self.shape, dtype=self.dtype,
                          device=device or first.device)
        for idx, b in self.unique_blocks():
            out[idx] = b
        return out

    def __repr__(self) -> str:
        return (f"ShardedTensor(shape={tuple(self.shape)}, dtype={self.dtype}"
                f", spec={self.sharding.spec}, mesh={self.sharding.mesh.shape})")


def _on_device(t: torch.Tensor, dev: torch.device) -> bool:
    """Whether ``t`` lies on ``dev`` ("cuda" with no index: the current
    card)."""
    if t.device.type != dev.type:
        return False
    if dev.index is None and dev.type == "cuda":
        return t.device.index == torch.cuda.current_device()
    return dev.index is None or t.device.index == dev.index


def _place(x: torch.Tensor, sharding: NamedSharding, copy: bool):
    blocks = {}
    for idx, dev in zip(sharding.indices(x.shape), sharding.mesh.devices):
        key = (_index_key(idx), dev)
        if key not in blocks:
            b = x[idx]
            if copy or not _on_device(b, dev):
                b = torch.empty(b.shape, dtype=b.dtype, device=dev).copy_(b)
            blocks[key] = b
    return ShardedTensor(x.shape, x.dtype, sharding, blocks)


def device_put(x, sharding: NamedSharding) -> ShardedTensor:
    """``jax.device_put(x, sharding)``: ``x`` (a tensor or an array)
    placed block by block on the devices of the sharding's mesh. The
    blocks are copies: updating them never writes into ``x``."""
    return _place(torch.as_tensor(x), sharding, copy=True)


def _count_collective(kind, shape, dtype, sharding: NamedSharding) -> None:
    """Count ``kind`` over the whole tensor's bytes when the sharding
    splits it, cross-node when ``pod`` is among its axes."""
    axes = {a for e in sharding.spec for a in _entry_axes(e)}
    if axes:
        cost.collective(kind, int(np.prod(shape)) * dtype.itemsize,
                        cross_pod="pod" in axes)


def scatter_view(x: torch.Tensor, sharding: NamedSharding) -> ShardedTensor:
    """``x`` placed by ``sharding`` with each block a view of ``x`` where
    it lies on the block's device (a copy elsewhere): a reduce-scatter's
    output when ``x`` is the reduced sum. Under the cost counter it
    counts as a reduce-scatter of ``x`` where the sharding splits it, and
    as an all-reduce where it replicates ``x`` over a mesh of more than
    one shard (every data group holds a part of the sum); cross-node
    when the mesh has a ``pod`` axis (the batch spans it)."""
    if sharding.mesh.size > 1:
        split = any(_entry_axes(e) for e in sharding.spec)
        cost.collective("reduce-scatter" if split else "all-reduce",
                        x.numel() * x.element_size(),
                        cross_pod="pod" in sharding.mesh.shape)
    return _place(x, sharding, copy=False)


def logical_sharding(
    logical_axes: Sequence[str | None],
    mesh,
    *,
    dims: Sequence[int] | None = None,
    rules: ShardingRules | None = None,
) -> NamedSharding:
    return NamedSharding(
        mesh, logical_to_spec(logical_axes, mesh, dims=dims, rules=rules))


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(
        isinstance(e, (str, type(None))) for e in x)


def tree_logical_to_sharding(schema_axes, schema_shapes, mesh, rules=None):
    """Map a tree (nested dicts) of logical-axes tuples and the matching
    tree of shapes to a tree of NamedShardings."""
    if isinstance(schema_axes, dict):
        return {k: tree_logical_to_sharding(schema_axes[k], schema_shapes[k],
                                            mesh, rules)
                for k in sorted(schema_axes)}
    if not _is_axes(schema_axes):
        raise TypeError(f"not a tuple of logical axes: {schema_axes!r}")
    return logical_sharding(schema_axes, mesh, dims=schema_shapes,
                            rules=rules)


# ---------------------------------------------------------------------------
# Activation sharding constraints: ``activation_mesh`` takes JAX's
# arguments and installs nothing, since ``shard_act`` is the identity
# under it and outside it (the module docstring says why).
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def activation_mesh(mesh, rules: ShardingRules | None = None):
    yield


def shard_act(x: torch.Tensor, logical: Sequence[str | None]) -> torch.Tensor:
    return x
