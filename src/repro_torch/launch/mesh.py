"""Meshes (src/repro/launch/mesh.py), as ``ShardMesh``es of logical shards:

    single-pod:  (data=16, model=16)        = 256 shards
    multi-pod:   (pod=2, data=16, model=16) = 512 shards

On ``device="meta"`` a mesh gives placements and shard shapes with no
storage (``sharding_tree``, ``batch_specs``, ``cache_shardings``); on
the card its shards share ``cuda:0``. JAX's TPU v5e constants are not
carried: the port's roofline reads H100 peaks.
"""
from __future__ import annotations

from repro_torch.core.distributed import ShardMesh


def make_production_mesh(*, multi_pod: bool = False,
                         device=None) -> ShardMesh:
    shape = {"pod": 2, "data": 16, "model": 16} if multi_pod \
        else {"data": 16, "model": 16}
    return ShardMesh.grid(shape, device=device)


def make_test_mesh(shape=(2, 2), axes=("data", "model"),
                   device=None) -> ShardMesh:
    """A small mesh for tests: ``shape`` over ``axes``, on one device."""
    return ShardMesh.grid(dict(zip(axes, shape)), device=device)
