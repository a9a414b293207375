"""The cost hooks of the port's lower layers: where ``kernels.ops``, the
``ShardMesh`` collectives, the ``ShardedTensor`` placements and the
train step report to the op-level cost counter (``launch/op_cost.py``)
while one is counting. With none counting every hook is a plain call.

This module imports nothing of the port, so any layer may import it; the
counter itself (its dispatch mode, ``Cost``, the tallies) lives in
``launch/op_cost.py`` and installs itself here with ``installed``.
"""
from __future__ import annotations

import contextlib

import torch

_ACTIVE: list = []


def dtype_class(dtype: torch.dtype) -> str:
    """The peak a product in ``dtype`` runs at: "bf16" (bf16, fp16),
    "int8" (int8, uint8) or "fp32" (the rest)."""
    if dtype in (torch.bfloat16, torch.float16):
        return "bf16"
    if dtype in (torch.int8, torch.uint8):
        return "int8"
    return "fp32"


def active():
    """The counter now counting, or None."""
    return _ACTIVE[-1] if _ACTIVE else None


@contextlib.contextmanager
def installed(counter):
    """Make ``counter`` the one the hooks report to inside the block."""
    _ACTIVE.append(counter)
    try:
        yield counter
    finally:
        _ACTIVE.pop()


def kernel_call(name: str, formula, run):
    """``run()``, a ``kernels.ops`` entry point's work. While counting,
    the call is charged ``formula()`` (flops, bytes, dtype class of the
    flops) once and the ops under ``run`` nothing."""
    c = active()
    if c is None:
        return run()
    c.charge(name, *formula())
    with c.quiet():
        return run()


def collective(kind: str, payload: int, *, cross_pod: bool = False) -> None:
    """One collective of ``kind`` ("all-gather", "all-reduce", ...) with a
    participant's ``payload`` bytes; ``cross_pod`` when its group spans
    the ``pod`` axis."""
    c = active()
    if c is not None:
        c.collective(kind, payload, cross_pod=cross_pod)


def repeated(key, fn, *args):
    """``fn(*args)``; while counting on "meta", a later call with the same
    ``key`` replays the first one's cost instead of running again."""
    c = active()
    return fn(*args) if c is None else c.repeated(key, fn, *args)
