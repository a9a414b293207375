"""Op-level cost counter: the port's counterpart of
``src/repro/launch/hlo_cost.py``.

JAX reads its costs from compiled HLO; the port runs eagerly and has no
HLO, so this counter watches the aten ops a call dispatches (a
``TorchDispatchMode``) and the port's own hooks:

  flops       — contraction FLOPs of ``mm`` / ``bmm`` / ``addmm`` /
                ``baddbmm`` / convolutions (``torch.utils.flop_counter``'s
                formulas: 2 m n k a product, as ``hlo_cost``'s dots), kept
                by the dtype class they run in (``bf16``: bf16 and fp16;
                ``fp32``: fp32 and fp64; ``int8``); elementwise ops add no
                FLOPs, as in ``hlo_cost``
  bytes       — operand + output bytes of every aten op that is not a view
                (a view, reshape, slice, expand or ``as_strided`` moves
                nothing): eager's real traffic, since eager fuses nothing.
                A gather (``index``, ``gather``, ``index_select``,
                ``embedding``) reads what it writes, 2x its output, and a
                scatter (``index_put_``, ``index_copy_``, ``scatter_``,
                ``index_add_``) writes its update, 2x the update, as
                ``hlo_cost`` charges them; ``copy_`` reads its source and
                writes its target; ``fill_`` / ``zero_`` and the factories
                write their output; ``empty*`` moves nothing
  collectives — ``counts``, ``bytes_by_kind``, ``total_bytes`` and
                ``dcn_bytes`` with ``hlo_cost``'s ``_COLL_FACTORS``, from
                the ``ShardMesh`` collectives and the ``ShardedTensor``
                gathers and reduce-scatters, where they are called (a group
                along the ``pod`` axis is cross-node: ``dcn_bytes``)
  kernels     — a hand-written kernel launches through ``ctypes``, which
                no dispatch mode sees: each ``kernels.ops`` entry point
                charges its kernel's formula (``charge``) and its plain
                version's aten ops, or the wrapper's, under it are charged
                nothing (``quiet``). The count does not depend on what
                implements the call: on the CPU, on the card and on "meta"
                it is the same.

The lower layers reach the counter through ``core/cost.py``'s hooks
(``kernel_call``, ``collective``, ``repeated``), which call the methods
of the same names here while a counter is installed.

Per-site tallies (flops, bytes, ops) keep, for ``attr``, the port's
function that issued each op: the innermost ``repro_torch`` frame
outside the counter, its hooks and ``kernels.ops`` (a kernel's charge
lands at the caller of its entry point; a checkpoint's recompute is
marked so), or ``backward:<node>`` for the autograd engine's ops.

``repeated(key, fn, *args)`` counts a call that repeats with identical
shapes once and replays its cost (on "meta" only, where nothing is
computed: the train step's microbatches and data groups), the port's
counterpart of ``hlo_cost``'s while-loop trip counts. A live-bytes
tracker follows every new storage an op makes (freed through weakref
finalizers on the storage) and keeps the peak: an estimate of the
call's memory above its arguments.
"""
from __future__ import annotations

import contextlib
import dataclasses
import sys
import weakref
from collections import defaultdict

import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.core import cost as hooks
from repro_torch.core.cost import dtype_class

aten = torch.ops.aten

_COLL_FACTORS = {
    # (bytes factor on payload, which payload: 'out' or 'in'), hlo_cost's
    "all-gather": (1.0, "out"),
    "all-reduce": (2.0, "in"),          # ring RS + AG
    "reduce-scatter": (1.0, "in"),
    "all-to-all": (1.0, "in"),
    "collective-permute": (1.0, "in"),
    "ragged-all-to-all": (1.0, "in"),
}

_PRODUCTS = {aten.mm, aten.addmm, aten.bmm, aten.baddbmm,
             aten.convolution, aten._convolution, aten.convolution_backward}
_GATHERS = {aten.index, aten.gather, aten.index_select, aten.embedding,
            aten.take}
_SCATTERS = {aten.index_put_, aten.index_put, aten._index_put_impl_,
             aten.index_copy_, aten.index_copy, aten.scatter_, aten.scatter,
             aten.index_add_, aten.index_add, aten.scatter_add_,
             aten.scatter_add}
_WRITES = {aten.fill_, aten.zero_}
_FREE = {aten.empty, aten.empty_like, aten.empty_strided, aten.new_empty,
         aten.new_empty_strided, aten.detach, aten.lift_fresh,
         aten._unsafe_view, aten.alias, aten.set_, aten.resize_,
         aten._local_scalar_dense, aten.is_nonzero, aten.record_stream}

_PACKAGE = "repro_torch."
_NOT_SITES = {__name__, hooks.__name__, "repro_torch.kernels.ops"}


@dataclasses.dataclass
class CollectiveStats:
    """JAX's ``roofline.CollectiveStats``, from the counter (JAX parses it
    out of HLO text with ``parse_collectives``)."""
    counts: dict
    bytes_by_kind: dict
    total_bytes: float          # per-participant traffic proxy
    dcn_bytes: float = 0.0

    def as_dict(self):
        return {"counts": self.counts, "bytes": self.bytes_by_kind,
                "total_bytes": self.total_bytes, "dcn_bytes": self.dcn_bytes}


@dataclasses.dataclass
class Cost:
    """``hlo_cost.Cost``'s fields (``flops``, ``bytes``, ``coll_bytes``,
    ``dcn_bytes``, ``coll_bytes_by_kind``, ``coll_counts``) and the
    port's: ``flops_by_dtype``, ``ops`` (aten ops counted), ``kernels``
    (charges by entry point), ``sites`` ({site: [flops, bytes, ops]}),
    ``peak_bytes`` (the live-bytes tracker's peak) and ``alloc_bytes``
    (every new storage's bytes, none freed: a bound with no liveness)."""
    flops: int = 0
    bytes: int = 0
    coll_bytes: float = 0.0
    dcn_bytes: float = 0.0
    coll_bytes_by_kind: dict = dataclasses.field(
        default_factory=lambda: defaultdict(float))
    coll_counts: dict = dataclasses.field(
        default_factory=lambda: defaultdict(int))
    flops_by_dtype: dict = dataclasses.field(
        default_factory=lambda: defaultdict(int))
    ops: int = 0
    kernels: dict = dataclasses.field(
        default_factory=lambda: defaultdict(int))
    sites: dict = dataclasses.field(
        default_factory=lambda: defaultdict(lambda: [0, 0, 0]))
    peak_bytes: int = 0
    alloc_bytes: int = 0

    def add(self, other: "Cost", mult=1):
        self.flops += other.flops * mult
        self.alloc_bytes += other.alloc_bytes * mult
        self.bytes += other.bytes * mult
        self.coll_bytes += other.coll_bytes * mult
        self.dcn_bytes += other.dcn_bytes * mult
        self.ops += other.ops * mult
        for src, dst in ((other.coll_bytes_by_kind, self.coll_bytes_by_kind),
                         (other.coll_counts, self.coll_counts),
                         (other.flops_by_dtype, self.flops_by_dtype),
                         (other.kernels, self.kernels)):
            for k, v in src.items():
                dst[k] += v * mult
        for k, v in other.sites.items():
            s = self.sites[k]
            for i in range(3):
                s[i] += v[i] * mult

    def copy(self) -> "Cost":
        c = Cost(peak_bytes=self.peak_bytes)
        c.add(self)
        return c

    def minus(self, other: "Cost") -> "Cost":
        c = self.copy()
        c.add(other, -1)
        c.peak_bytes = self.peak_bytes
        return c

    def collectives(self) -> CollectiveStats:
        return CollectiveStats(dict(self.coll_counts),
                               dict(self.coll_bytes_by_kind),
                               self.coll_bytes, self.dcn_bytes)

    def totals(self) -> dict:
        """The scalar and by-kind figures (no sites), for records."""
        return {"flops": self.flops, "bytes": self.bytes,
                "flops_by_dtype": dict(self.flops_by_dtype),
                "coll_bytes": self.coll_bytes, "dcn_bytes": self.dcn_bytes,
                "coll_counts": dict(self.coll_counts),
                "coll_bytes_by_kind": dict(self.coll_bytes_by_kind),
                "ops": self.ops, "kernels": dict(self.kernels),
                "peak_bytes": self.peak_bytes,
                "alloc_bytes": self.alloc_bytes}


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for t in tree:
            yield from _tensors(t)
    elif isinstance(tree, dict):
        for t in tree.values():
            yield from _tensors(t)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _site() -> str:
    """The innermost frame of the port outside ``_NOT_SITES``, marked
    " (recompute)" inside the autograd engine (a checkpoint's forward run
    again); ``backward:<node>`` for the engine's own ops, whose newest
    Python frame is ``torch.autograd``'s (or which run on the engine's
    device thread, with none)."""
    node = torch._C._current_autograd_node()
    f = sys._getframe(1)
    while f is not None:
        name = f.f_globals.get("__name__", "")
        if name.startswith(_PACKAGE) and name not in _NOT_SITES:
            site = f"{name[len(_PACKAGE):]}:{f.f_code.co_name}"
            return site if node is None else f"{site} (recompute)"
        if node is not None and name == "torch.autograd":
            break
        f = f.f_back
    return f"backward:{node.name()}" if node is not None else "other"


class OpCounter(TorchDispatchMode):
    """The counter; use ``counting()`` (or ``analyze``) to run one."""

    def __init__(self):
        super().__init__()
        self.cost = Cost()
        self._quiet = 0
        self._memo: dict = {}
        self._live: dict = {}            # storage cdata -> bytes
        self._live_bytes = 0

    # -- aten ops
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not self._quiet:
            self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out):
        packet = func.overloadpacket
        if func.is_view or packet in _FREE:
            return
        ins = list(_tensors((args, kwargs)))
        outs = list(_tensors(out))
        flops, cls = 0, None
        if packet in _PRODUCTS:
            flops = int(flop_registry[packet](*args, **kwargs, out_val=out))
            cls = dtype_class(ins[0].dtype)
        if packet in _GATHERS:
            moved = 2 * sum(map(_nbytes, outs))
        elif packet in _SCATTERS:
            upd = args[2] if packet in (aten.index_put_, aten.index_put,
                                        aten._index_put_impl_) \
                else args[-1] if isinstance(args[-1], torch.Tensor) \
                else ins[-1]
            moved = 2 * _nbytes(upd)
        elif packet is aten.copy_:
            moved = _nbytes(args[0]) + _nbytes(args[1])
        elif packet in _WRITES or not ins:
            moved = sum(map(_nbytes, outs))
        else:
            moved = sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
        c = self.cost
        c.flops += flops
        if cls is not None:
            c.flops_by_dtype[cls] += flops
        c.bytes += moved
        c.ops += 1
        s = c.sites[_site()]
        s[0] += flops
        s[1] += moved
        s[2] += 1
        self._track(ins, outs)

    # -- the live-bytes tracker
    def _track(self, ins, outs):
        if not outs:
            return
        seen = {StorageWeakRef(t.untyped_storage()).cdata for t in ins}
        for t in outs:
            st = t.untyped_storage()
            key = StorageWeakRef(st).cdata
            if key in seen or key in self._live:
                continue
            seen.add(key)
            n = st.nbytes()
            self._live[key] = n
            self._live_bytes += n
            self.cost.alloc_bytes += n
            weakref.finalize(st, self._free, key)
            if self._live_bytes > self.cost.peak_bytes:
                self.cost.peak_bytes = self._live_bytes

    def _free(self, key):
        n = self._live.pop(key, 0)
        self._live_bytes -= n

    # -- the port's hooks
    def charge(self, name: str, flops: int = 0, nbytes: int = 0,
               dtype: str = "fp32"):
        """A kernel entry point's formula: ``flops`` in the dtype class
        ``dtype`` and ``nbytes`` moved, as one op at the caller's site."""
        c = self.cost
        c.flops += flops
        if flops:
            c.flops_by_dtype[dtype] += flops
        c.bytes += nbytes
        c.ops += 1
        c.kernels[name] += 1
        s = c.sites[_site()]
        s[0] += flops
        s[1] += nbytes
        s[2] += 1

    def collective(self, kind: str, payload: float, *, cross_pod=False):
        """One collective of ``kind`` whose payload (the output's bytes for
        an all-gather, the input's otherwise, a participant's) is
        ``payload``, times ``_COLL_FACTORS``."""
        factor, _ = _COLL_FACTORS[kind]
        b = factor * payload
        c = self.cost
        c.coll_bytes += b
        c.coll_counts[kind] += 1
        c.coll_bytes_by_kind[kind] += b
        if cross_pod:
            c.dcn_bytes += b

    @contextlib.contextmanager
    def quiet(self):
        """Ops under it are charged nothing (a kernel's charge covers
        them); the tracker still sees their outputs."""
        self._quiet += 1
        try:
            yield
        finally:
            self._quiet -= 1

    def repeated(self, key, fn, *args):
        """``fn(*args)``, counted once a ``key`` on "meta": a later call
        with the same key adds the first call's cost again and returns
        new tensors of its outputs' shapes (nothing is computed on
        "meta"). Anywhere else it is ``fn(*args)``."""
        if not _on_meta(args):
            return fn(*args)
        hit = self._memo.get(key)
        if hit is not None:
            cost, template = hit
            self.cost.add(cost)
            with self.quiet():
                out = _like(template)
            self._track([], list(_tensors(out)))
            return out
        before = self.cost.copy()
        out = fn(*args)
        with self.quiet():
            self._memo[key] = (self.cost.minus(before), _like(out))
        return out


@contextlib.contextmanager
def counting():
    """Count every op in the block; yields the ``OpCounter`` (its
    ``cost`` is final when the block ends)."""
    counter = OpCounter()
    with hooks.installed(counter), counter:
        yield counter


def analyze(fn, *args, **kwargs) -> Cost:
    """The cost of ``fn(*args, **kwargs)``."""
    with counting() as c:
        fn(*args, **kwargs)
    return c.cost


def _on_meta(tree) -> bool:
    ts = list(_tensors(tree))
    return bool(ts) and all(t.device.type == "meta" for t in ts)


def _like(tree):
    """``tree`` with each tensor replaced by a new one of its shape."""
    if isinstance(tree, torch.Tensor):
        return torch.empty_like(tree)
    if isinstance(tree, (list, tuple)):
        return type(tree)(_like(t) for t in tree)
    if isinstance(tree, dict):
        return {k: _like(v) for k, v in tree.items()}
    return tree
