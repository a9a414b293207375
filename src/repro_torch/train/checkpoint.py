"""Checkpointing: per-host npz files + manifest, atomic rename, async
background writes, automatic resume (src/repro/train/checkpoint.py),
in the JAX package's format, so that a checkpoint written by either
package loads in the other.

Layout (step 1200, 2 hosts):
    ckpt_dir/
      step_00001200/
        manifest.json            # step, config hash, leaf index
        host_00000.npz           # this host's leaves
        host_00001.npz
      latest -> step_00001200    # symlink, updated after the commit

Leaves are named by their tree paths as JAX names them
(``params/stack/layers/attn/wq``, ``opt_state/m/...``,
``opt_state/step``: dict keys and ``AdamState``'s field names). A tensor
is a "full" leaf; a ``ShardedTensor`` on a mesh of more than one shard
is a "sharded" leaf, as JAX writes one (its ``shape``, ``dtype`` and
each shard's ``slices``, ``[start, stop]`` a dimension, null where the
dimension is whole; payloads ``name@@i`` in ``addressable_shards``
order, replicas included; the replicated 0-d ``opt_state/step`` has
empty slice lists). JAX decides by the number of distinct devices; the
port's shards may share one card, so it decides by the mesh's shard
count. ``load`` assembles sharded leaves into the global array and,
with ``shardings=``, places each leaf by its sharding (the elastic
reshard onto another mesh), else by its ``like`` leaf's placement, so
the fault policy's rollback returns the state on its own mesh (JAX's
``load`` without ``shardings`` returns unplaced arrays). Crash safety: writes go to ``step_X.tmp`` and are renamed
into place once every file is written; a partial directory is never
visible under its final name, and ``latest_step`` ignores unrenamed temp
dirs. ``save`` copies every leaf to host memory on the caller's thread
before the writer thread starts, so the train loop's in-place updates
after it returns never reach the file. ``config_hash`` is JAX's function,
but the port's config reprs name torch dtypes, so its hashes differ from
JAX's (no load checks them).
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import shutil
import threading
import time
from typing import Any

import numpy as np
import torch

from repro_torch.core.device import process_grid, resolve_device
from repro_torch.models.sharding import ShardedTensor, device_put


def _leaf_paths(tree, prefix: str = "") -> list[tuple[str, Any]]:
    """(name, leaf) in JAX's flattening order: dict keys sorted,
    NamedTuple fields in order, named by key and field name."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in _leaf_paths(tree[k], f"{prefix}{k}/")]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [kv for f in tree._fields
                for kv in _leaf_paths(getattr(tree, f), f"{prefix}{f}/")]
    return [(prefix[:-1], tree)]


def _rebuild(tree, leaves):
    """``tree``'s structure with ``leaves`` (an iterator, in
    ``_leaf_paths`` order) in place of its leaves."""
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], leaves) for k in sorted(tree)}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_rebuild(getattr(tree, f), leaves)
                            for f in tree._fields))
    return next(leaves)


def _to_host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            raise TypeError("checkpoint leaves need a numpy dtype; got "
                            "bfloat16")
        host = leaf.detach().cpu().numpy()
        # a CPU tensor's array shares its memory: copy it
        return host.copy() if leaf.device.type == "cpu" else host
    return np.array(leaf)


def _host_leaf(leaf) -> tuple:
    """(kind, shape, dtype, data) as JAX's ``save`` gathers them: a
    sharded leaf's (index, host array) a shard, replicas sharing one host
    copy; else the whole array."""
    if isinstance(leaf, ShardedTensor):
        if leaf.sharding.mesh.size > 1:
            copies: dict[int, np.ndarray] = {}
            shards = []
            for idx, data in leaf.addressable_shards:
                if id(data) not in copies:
                    copies[id(data)] = _to_host(data)
                shards.append((idx, copies[id(data)]))
            return ("sharded", tuple(leaf.shape), shards[0][1].dtype.name,
                    shards)
        leaf = leaf.gather()
    return ("full", None, None, _to_host(leaf))


def config_hash(cfg) -> str:
    return hashlib.sha1(repr(cfg).encode()).hexdigest()[:12]


@dataclasses.dataclass
class Checkpointer:
    directory: str
    every: int = 100
    keep: int = 3
    async_write: bool = True
    cfg_hash: str = ""

    def __post_init__(self):
        os.makedirs(self.directory, exist_ok=True)
        self._thread: threading.Thread | None = None
        self._error: Exception | None = None

    # ------------------------------------------------------------------ save
    def maybe_save(self, step: int, params, opt_state) -> bool:
        if self.every and step % self.every == 0:
            self.save(step, params, opt_state)
            return True
        return False

    def save(self, step: int, params, opt_state, *, wait: bool = False):
        self.wait()                     # one outstanding write at a time
        if self._error:
            raise self._error
        tree = {"params": params, "opt_state": opt_state}
        # host copies on the caller's thread: the loop updates the
        # device tensors in place once this returns
        host_data = {name: _host_leaf(leaf)
                     for name, leaf in _leaf_paths(tree)}

        def write():
            tmp = os.path.join(self.directory, f"step_{step:08d}.tmp")
            final = os.path.join(self.directory, f"step_{step:08d}")
            os.makedirs(tmp, exist_ok=True)
            payload = {}
            index = {}
            for name, (kind, shape, dtype, data) in host_data.items():
                if kind == "full":
                    payload[name] = data
                    index[name] = {"kind": "full"}
                else:
                    for i, (_, arr) in enumerate(data):
                        payload[f"{name}@@{i}"] = arr
                    index[name] = {
                        "kind": "sharded",
                        "shape": list(shape),
                        "dtype": dtype,
                        "slices": [
                            [[sl.start, sl.stop] for sl in idx]
                            for idx, _ in data
                        ],
                    }
            rank, world = process_grid()
            np.savez(os.path.join(tmp, f"host_{rank:05d}.npz"), **payload)
            manifest = {
                "step": step,
                "cfg_hash": self.cfg_hash,
                "n_hosts": world,
                "index": index,
                "time": time.time(),
            }
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            os.replace(tmp, final)        # atomic commit
            link = os.path.join(self.directory, "latest")
            tmp_link = link + ".tmp"
            try:
                if os.path.lexists(tmp_link):
                    os.unlink(tmp_link)
                os.symlink(os.path.basename(final), tmp_link)
                os.replace(tmp_link, link)
            except OSError:
                pass
            self._gc()

        if self.async_write and not wait:
            def run():
                try:
                    write()
                except Exception as e:        # surfaced on next save/wait
                    self._error = e
            self._thread = threading.Thread(target=run, daemon=True)
            self._thread.start()
        else:
            write()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error:
            err, self._error = self._error, None
            raise err

    def _gc(self):
        steps = sorted(self._list_steps())
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(
                os.path.join(self.directory, f"step_{s:08d}"),
                ignore_errors=True)

    # ------------------------------------------------------------------ load
    def _list_steps(self) -> list[int]:
        out = []
        for d in os.listdir(self.directory):
            if d.startswith("step_") and not d.endswith(".tmp"):
                man = os.path.join(self.directory, d, "manifest.json")
                if os.path.exists(man):
                    out.append(int(d.split("_")[1]))
        return out

    def latest_step(self) -> int | None:
        steps = self._list_steps()
        return max(steps) if steps else None

    def load(self, step: int | None = None, *, like=None, shardings=None,
             device=None):
        """Load {'params','opt_state'}: (step, {name: numpy array}) with no
        ``like``; with ``like`` (a tree of tensors, ShardedTensors or meta
        tensors, or a (params, opt_state) pair) its structure filled with
        the saved leaves, bit for bit: placed by ``shardings`` (the same
        structure of NamedShardings) when given, else a placed ``like``
        leaf by its own sharding, else a tensor on ``device`` (default:
        the ``like`` leaf's own device; "cuda" for a meta leaf). (None,
        None) when there is no checkpoint."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return None, None
        d = os.path.join(self.directory, f"step_{step:08d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        buf: dict[str, np.ndarray] = {}
        for fn in sorted(os.listdir(d)):
            if fn.endswith(".npz"):
                with np.load(os.path.join(d, fn)) as z:
                    for k in z.files:
                        buf[k] = z[k]
        full: dict[str, np.ndarray] = {}
        for name, info in manifest["index"].items():
            if info["kind"] == "full":
                full[name] = buf[name]
            else:
                arr = np.zeros(info["shape"], dtype=info["dtype"])
                i = 0
                while f"{name}@@{i}" in buf:
                    sl = tuple(
                        slice(a, b) for a, b in info["slices"][i])
                    arr[sl] = buf[f"{name}@@{i}"]
                    i += 1
                full[name] = arr

        if like is None:
            return step, full
        tree = {"params": like[0], "opt_state": like[1]} \
            if isinstance(like, tuple) else like
        named = _leaf_paths(tree)
        if shardings is not None:
            sh_tree = {"params": shardings[0], "opt_state": shardings[1]} \
                if isinstance(shardings, tuple) else shardings
            placements = [s for _, s in _leaf_paths(sh_tree)]
        else:
            placements = [ref.sharding if isinstance(ref, ShardedTensor)
                          else None for _, ref in named]
        leaves = []
        for (name, ref), sh in zip(named, placements):
            t = torch.from_numpy(full[name])
            if sh is not None:
                leaves.append(device_put(t, sh))
                continue
            if device is not None:
                dev = device
            elif isinstance(ref, torch.Tensor) and ref.device.type != "meta":
                dev = ref.device
            elif isinstance(ref, torch.Tensor):   # an abstract leaf
                dev = resolve_device(None, "Checkpointer.load")
            else:
                dev = "cpu"
            leaves.append(t.to(dev))
        return step, _rebuild(tree, iter(leaves))
