"""Datastore persistence: versioned snapshot and restore of the online
store, so that a restart never pays for the graph build again.

A snapshot holds the whole ``MutableKNNStore`` (rows, norms, neighbor
lists, tombstone mask, the quantized mirror and the router) or a static
kNN-LM ``KNNDatastore``, and a restore gives it back bit for bit. The
on-disk format is the JAX package's (``repro/core/persist.py``), byte for
byte, so a snapshot written by either package restores into the other::

    snap_dir/
      step_00004096/
        manifest.json        # format version, shapes / dtypes, config
                             # echo, live / tombstone counts
        x.npy  x2.npy  nl_dist.npy  nl_idx.npy  nl_new.npy  alive.npy
        qs_data.npy  qs_scale.npy  qs_x2.npy        # precision != f32
        router_centroids.npy ... router_stale.npy   # router attached
        values.npy                                  # datastore values
        COMMIT               # written (and fsynced) LAST

Every array is written under the dtype the JAX package writes (float32,
int32, bool; the mirror int8 or bfloat16). numpy has no bfloat16, so a
bf16 mirror is stored as its uint16 bits with ``"bfloat16"`` in the
manifest; the port moves the bits into a ``torch.bfloat16`` tensor.
``Router.stale`` is a 0-d int32 array. The config echo names the JAX
package's backends: the port's ``plain`` is written as ``interpret`` and
read back as ``plain``; ``pallas`` reads as ``auto``.

Crash safety: the arrays and the manifest are staged into
``step_XXXXXXXX.tmp``, the ``COMMIT`` marker is fsynced last, and the
staged directory is renamed into place (a committed predecessor of the
same step is moved aside first and dropped after). A directory without
the marker is invisible to ``latest_snapshot``. Reads validate every array
against the manifest (shape and logical dtype) and refuse a format
version they do not know. ``restore_store`` with no step falls back
newest-first past snapshots that fail validation, quarantining each by
rename (never deleting it).

``SnapshotWriter`` takes a capture on the caller's thread (references to
the store's tensors: an update builds new tensors and never writes into
the old ones) and copies it to the host and to disk on a background
thread, so inserts go on while it writes. Its errors surface on the next
``save`` / ``wait``; ``poll`` returns them.

The quantized-first cold start (``restore_store(quantized_first=True)``)
reads the mirror and the lists first and serves at once with ``x`` the
dequantized mirror (distances quantized-accurate); ``Fp32Loader`` reads the
exact rows on a background thread and ``apply`` swaps them in.

Restores run on ``device`` ("cuda" unless the caller asks otherwise; with
no card present that raises).
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import threading
import time
import warnings
from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.core import faults
from repro_torch.core.device import resolve_device
from repro_torch.core.heap import NeighborLists
from repro_torch.core.online import (
    MutableKNNStore,
    OnlineConfig,
    store_from_numpy,
)
from repro_torch.core.quantize import QuantizedStore, dequantize
from repro_torch.core.router import Router, RouterConfig, router_from_numpy

FORMAT_VERSION = 1

_COMMIT = "COMMIT"
_MANIFEST = "manifest.json"
_BF16 = "bfloat16"
# the dtype the JAX package writes each array under (the mirror's data is
# int8 or bfloat16, by its mode)
_DTYPES = {
    **dict.fromkeys(("x", "x2", "nl_dist", "qs_scale", "qs_x2", "keys",
                     "router_centroids", "router_c2",
                     "router_members_dist"), np.float32),
    **dict.fromkeys(("nl_idx", "graph_idx", "values", "router_graph",
                     "router_assign", "router_counts", "router_stale",
                     "router_members_idx"), np.int32),
    **dict.fromkeys(("nl_new", "alive", "router_members_new"), np.bool_),
}
# the config echo's backend names: JAX's -> the port's, and back
_BACKEND_IN = {"auto": "auto", "pallas": "auto", "interpret": "plain",
               "ref": "ref", "plain": "plain"}
_BACKEND_OUT = {"auto": "auto", "plain": "interpret", "ref": "ref"}


class SnapshotError(RuntimeError):
    """A snapshot could not be read: missing, partial, corrupted, or a
    format this build refuses to reinterpret."""


# ---------------------------------------------------------------------------
# low-level snapshot format: named arrays + manifest + commit marker
# ---------------------------------------------------------------------------


def _step_dir(directory: str, step: int) -> str:
    return os.path.join(directory, f"step_{step:08d}")


def _host(name: str, arr) -> tuple[np.ndarray, str]:
    """An array of a capture on the host under the JAX package's dtype:
    (array to save, logical dtype name). A bf16 tensor comes back as its
    uint16 bits; an integer cast that would change a value raises."""
    if isinstance(arr, torch.Tensor):
        arr = arr.detach()
        if arr.dtype == torch.bfloat16:
            return arr.view(torch.int16).cpu().numpy().view(np.uint16), _BF16
        arr = arr.cpu().numpy()
    a = np.asarray(arr)
    want = _DTYPES.get(name)
    if want is not None and a.dtype != want:
        b = a.astype(want)
        if a.dtype.kind in "iub" and not np.array_equal(b, a):
            raise ValueError(f"snapshot array {name!r} does not fit "
                             f"{np.dtype(want)}")
        a = b
    return a, str(a.dtype)


def write_snapshot(directory: str, step: int, arrays: dict, meta: dict,
                   *, keep: int = 0) -> str:
    """Write one snapshot: one ``.npy`` per array and ``manifest.json``,
    staged, then the fsynced ``COMMIT`` marker last and the rename into
    place. ``arrays`` may hold tensors on any device (copied to the host
    here), numpy arrays or Python scalars. ``keep`` > 0 drops all but the
    newest ``keep`` committed snapshots. Returns the step directory."""
    os.makedirs(directory, exist_ok=True)
    final = _step_dir(directory, step)
    # stage into a sibling (its .tmp suffix keeps it invisible to
    # list_snapshots) and swap it in only once our COMMIT is on disk, so a
    # failed rewrite of a committed step leaves the committed copy as it was
    tmp = final + ".tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    faults.maybe_raise("persist.write")
    index = {}
    for name, arr in arrays.items():
        a, logical = _host(name, arr)
        np.save(os.path.join(tmp, name + ".npy"), a)
        index[name] = {"file": name + ".npy", "shape": list(a.shape),
                       "dtype": logical}
    manifest = {
        "format_version": FORMAT_VERSION,
        "step": step,
        "time": time.time(),
        "arrays": index,
        **meta,
    }
    with open(os.path.join(tmp, _MANIFEST), "w") as f:
        json.dump(manifest, f, indent=2)
        f.flush()
        os.fsync(f.fileno())
    with open(os.path.join(tmp, _COMMIT), "w") as f:
        f.write("ok\n")
        f.flush()
        os.fsync(f.fileno())
    old = None
    if os.path.isdir(final):
        # move the predecessor aside, swap the staged dir in, then drop
        # it: at every instant one committed copy of this step exists
        old = final + ".old"
        shutil.rmtree(old, ignore_errors=True)
        os.rename(final, old)
    os.rename(tmp, final)
    if old is not None:
        shutil.rmtree(old, ignore_errors=True)
    _tear(final)
    if keep:
        gc_snapshots(directory, keep)
    return final


def _tear(final: str) -> None:
    """``persist.torn``: truncate one array file of the committed snapshot
    to half (the first ``.npy`` whose name contains the spec's ``arg``), a
    torn page that only read-side validation can catch. No-op unless a
    fault plan scripts it."""
    spec = faults.fire("persist.torn")
    if spec is None:
        return
    pat = spec.arg if isinstance(spec.arg, str) else ""
    for fn in sorted(os.listdir(final)):
        if fn.endswith(".npy") and pat in fn:
            fp = os.path.join(final, fn)
            with open(fp, "r+b") as f:
                f.truncate(max(os.path.getsize(fp) // 2, 1))
            return


def list_snapshots(directory: str) -> list[int]:
    """Committed snapshot steps, ascending; directories without the
    commit marker or the manifest are ignored."""
    if not os.path.isdir(directory):
        return []
    out = []
    for d in os.listdir(directory):
        if not d.startswith("step_"):
            continue
        p = os.path.join(directory, d)
        if not (os.path.exists(os.path.join(p, _COMMIT))
                and os.path.exists(os.path.join(p, _MANIFEST))):
            continue
        try:
            out.append(int(d.split("_", 1)[1]))
        except ValueError:
            continue
    return sorted(out)


def latest_snapshot(directory: str) -> int | None:
    """Newest committed step in ``directory`` (None when there is none)."""
    steps = list_snapshots(directory)
    return steps[-1] if steps else None


def gc_snapshots(directory: str, keep: int) -> None:
    """Drop all but the newest ``keep`` committed snapshots."""
    for s in list_snapshots(directory)[:-keep] if keep else []:
        shutil.rmtree(_step_dir(directory, s), ignore_errors=True)


def read_snapshot(directory: str, step: int | None = None, *,
                  only: set | None = None,
                  skip: set | frozenset = frozenset()):
    """Read one committed snapshot (the newest when ``step`` is None);
    ``only`` / ``skip`` select arrays by name. Returns (step, {name:
    np.ndarray}, manifest); a bf16 array comes back as its uint16 bits
    (the manifest's dtype says ``"bfloat16"``).

    Raises ``SnapshotError`` when no committed snapshot exists, the format
    version is not this build's, or an array file is unreadable or
    disagrees with the manifest's shape or dtype (the file is named)."""
    if step is None:
        step = latest_snapshot(directory)
        if step is None:
            raise SnapshotError(
                f"no committed snapshot under {directory!r} (directories "
                f"without a {_COMMIT} marker are ignored)")
    d = _step_dir(directory, step)
    if not os.path.exists(os.path.join(d, _COMMIT)):
        raise SnapshotError(f"snapshot {d} has no {_COMMIT} marker — "
                            "partial write, refusing to load")
    try:
        with open(os.path.join(d, _MANIFEST)) as f:
            manifest = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        raise SnapshotError(f"unreadable manifest {d}/{_MANIFEST}: {e}") \
            from e
    ver = manifest.get("format_version")
    if ver != FORMAT_VERSION:
        raise SnapshotError(
            f"snapshot {d} has format version {ver!r}; this build reads "
            f"version {FORMAT_VERSION} — refusing to reinterpret its bytes")
    arrays = {}
    for name, info in manifest["arrays"].items():
        if (only is not None and name not in only) or name in skip:
            continue
        fp = os.path.join(d, info["file"])
        try:
            a = np.load(fp)
        except Exception as e:
            raise SnapshotError(f"corrupt snapshot array {fp}: {e}") from e
        logical = _BF16 if info["dtype"] == _BF16 and a.dtype == np.uint16 \
            else str(a.dtype)
        if list(a.shape) != list(info["shape"]) or logical != info["dtype"]:
            raise SnapshotError(
                f"snapshot array {fp} holds {logical}{a.shape}, manifest "
                f"says {info['dtype']}{tuple(info['shape'])} — truncated "
                "or corrupted file")
        arrays[name] = a
    return step, arrays, manifest


# ---------------------------------------------------------------------------
# MutableKNNStore capture / rebuild
# ---------------------------------------------------------------------------

_ROUTER_FIELDS = ("centroids", "c2", "graph", "assign", "counts", "stale")


def _cfg_echo(cfg: OnlineConfig) -> dict:
    echo = dataclasses.asdict(cfg)          # RouterConfig nests as a dict
    echo["backend"] = _BACKEND_OUT[cfg.backend]
    return echo


def _cfg_from_echo(echo: dict) -> OnlineConfig:
    echo = dict(echo)
    backend = echo.get("backend", "auto")
    if backend not in _BACKEND_IN:
        raise SnapshotError(f"snapshot config echo names backend "
                            f"{backend!r}, which this build does not know")
    echo["backend"] = _BACKEND_IN[backend]
    rd = echo.pop("router", None)
    # filter to known fields: format_version gates real layout changes,
    # this keeps a same-version echo robust to knob additions
    ofields = {f.name for f in dataclasses.fields(OnlineConfig)}
    rfields = {f.name for f in dataclasses.fields(RouterConfig)}
    router = None if rd is None else RouterConfig(
        **{k: v for k, v in rd.items() if k in rfields})
    return OnlineConfig(**{k: v for k, v in echo.items() if k in ofields},
                        router=router)


def _capture_mirror_router(arrays: dict, qs, router) -> None:
    if qs is not None:
        arrays["qs_data"] = qs.data
        arrays["qs_scale"] = qs.scale
        arrays["qs_x2"] = qs.x2
    if router is not None:
        for f in _ROUTER_FIELDS:
            arrays[f"router_{f}"] = getattr(router, f)
        arrays["router_members_dist"] = router.members.dist
        arrays["router_members_idx"] = router.members.idx
        arrays["router_members_new"] = router.members.new


def capture_store(store: MutableKNNStore, *, values=None):
    """Flatten a store (and an optional row-aligned ``values`` array, the
    kNN-LM datastore's token ids) into (arrays, manifest meta). The arrays
    are the store's own tensors: an update never writes into them, so
    holding them is a consistent capture."""
    arrays = {
        "x": store.x,
        "x2": store.x2,
        "nl_dist": store.nl.dist,
        "nl_idx": store.nl.idx,
        "nl_new": store.nl.new,
        "alive": store.alive,
    }
    _capture_mirror_router(arrays, store.qs, store.router)
    if values is not None:
        arrays["values"] = values
    live = int(store.alive.sum())
    meta = {
        "kind": "mutable_store",
        "n": int(store.n),
        "d": int(store.d),
        "dp": int(store.x.shape[1]),
        "k": int(store.k),
        "capacity": int(store.capacity),
        "live": live,
        "tombstones": int(store.n) - live,
        "precision": store.cfg.precision,
        # rows are stored in the metric's transformed space: the metric
        # is echoed top-level and validated on restore; mips_m is the
        # augmentation bound later inserts must share
        "metric": store.cfg.metric,
        "mips_m": float(store.mips_m),
        "has_qs": store.qs is not None,
        "has_router": store.router is not None,
        "config": _cfg_echo(store.cfg),
    }
    return arrays, meta


def _tensor(arrays: dict, manifest: dict, name: str, device):
    """One array of a read snapshot as a tensor on ``device`` (bf16 bits
    moved into a ``torch.bfloat16`` tensor)."""
    a = arrays[name]
    if manifest["arrays"][name]["dtype"] == _BF16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(
            device).contiguous()
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _rebuild_qs(arrays: dict, manifest: dict, device) -> QuantizedStore:
    return QuantizedStore(*(_tensor(arrays, manifest, f"qs_{f}", device)
                            for f in ("data", "scale", "x2")))


def _router_parts(arrays: dict):
    """A snapshot's router arrays in ``router_from_numpy``'s order."""
    return (arrays["router_centroids"], arrays["router_c2"],
            arrays["router_graph"],
            tuple(arrays[f"router_members_{f}"]
                  for f in ("dist", "idx", "new")),
            arrays["router_assign"], arrays["router_counts"],
            arrays["router_stale"])


def _rebuild_router(arrays: dict, device) -> Router | None:
    if "router_centroids" not in arrays:
        return None
    return router_from_numpy(*_router_parts(arrays), device=device)


def _metric_meta(manifest: dict, cfg: OnlineConfig) -> float:
    """Validate the top-level metric echo against the config echo and
    return the mips bound (snapshots without the keys are l2)."""
    met = manifest.get("metric", "l2")
    if met != cfg.metric:
        raise SnapshotError(
            f"snapshot metric echo {met!r} disagrees with its config "
            f"echo {cfg.metric!r} — refusing to serve transformed rows "
            "under the wrong metric")
    return float(manifest.get("mips_m", 0.0))


def _values(arrays: dict, device):
    return None if "values" not in arrays else torch.from_numpy(
        arrays["values"]).to(device)


def rebuild_store(arrays: dict, manifest: dict, *, device=None):
    """Inverse of ``capture_store``, through ``store_from_numpy``: (store,
    values or None) on ``device``. The metric echo is validated and the
    mips bound restored."""
    device = resolve_device(device, "rebuild_store")
    cfg = _cfg_from_echo(manifest["config"])
    qs = None
    if "qs_data" in arrays:
        qs = (arrays["qs_data"], arrays["qs_scale"], arrays["qs_x2"])
    router = _router_parts(arrays) if "router_centroids" in arrays else None
    store = store_from_numpy(
        arrays["x"], arrays["x2"],
        (arrays["nl_dist"], arrays["nl_idx"], arrays["nl_new"]),
        arrays["alive"], n=int(manifest["n"]), d=int(manifest["d"]),
        cfg=cfg, mips_m=_metric_meta(manifest, cfg), qs=qs, router=router,
        device=device)
    return store, _values(arrays, device)


def snapshot_store(store: MutableKNNStore, directory: str, step: int, *,
                   values=None, keep: int = 0) -> str:
    """One synchronous snapshot (``SnapshotWriter`` overlaps the write
    with inserts). Returns the step directory."""
    arrays, meta = capture_store(store, values=values)
    return write_snapshot(directory, step, arrays, meta, keep=keep)


class Fp32Loader:
    """The quantized-first cold start's background read of the exact rows:
    started by ``restore_store(quantized_first=True)``; ``apply`` waits for
    the read, then swaps the exact ``x`` / ``x2`` into the store, on the
    store's device."""

    def __init__(self, directory: str, step: int):
        self._directory = directory
        self._step = step
        self._arrays: dict | None = None
        self._error: Exception | None = None
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        try:
            _, self._arrays, _ = read_snapshot(
                self._directory, self._step, only={"x", "x2"})
        except Exception as e:          # surfaced by apply()
            self._error = e

    @property
    def done(self) -> bool:
        return not self._thread.is_alive()

    def apply(self, store: MutableKNNStore) -> MutableKNNStore:
        self._thread.join()
        if self._error is not None:
            raise self._error
        dev = store.x.device
        return dataclasses.replace(
            store, x=torch.from_numpy(self._arrays["x"]).to(dev),
            x2=torch.from_numpy(self._arrays["x2"]).to(dev))


class Restored(NamedTuple):
    store: MutableKNNStore
    values: Any                 # row-aligned values tensor or None
    step: int
    manifest: dict
    fp32_loader: Fp32Loader | None   # quantized-first restores only
    fallback_from: tuple = ()   # newer committed steps that failed
    #                             validation and were quarantined


def _quarantine(directory: str, step: int, err: Exception) -> None:
    """Move a committed but unreadable snapshot aside by rename, never
    delete it (its bytes are the only evidence). A failed rename only
    warns: the fallback goes on either way."""
    src = _step_dir(directory, step)
    dst = src + ".bad"
    i = 0
    while os.path.exists(dst):
        i += 1
        dst = src + f".bad{i}"
    try:
        faults.maybe_raise("persist.rename")
        os.rename(src, dst)
        warnings.warn(
            f"snapshot step {step} failed validation ({err}); "
            f"quarantined to {dst}", RuntimeWarning, stacklevel=3)
    except OSError as rename_err:
        warnings.warn(
            f"snapshot step {step} failed validation ({err}) and could "
            f"not be quarantined ({rename_err}); falling back anyway",
            RuntimeWarning, stacklevel=3)


def restore_store(directory: str, step: int | None = None, *,
                  quantized_first: bool = False, device=None) -> Restored:
    """Restore a ``MutableKNNStore`` snapshot onto ``device`` (the newest
    committed step when ``step`` is None).

    With ``step`` None, a newest snapshot that fails validation (a torn
    array file, a corrupt manifest, an unknown format) is quarantined and
    the next older committed step tried, newest first, until one loads;
    the skipped steps are in ``Restored.fallback_from``. An explicit
    ``step`` fails hard.

    ``quantized_first=True`` reads only the mirror, the lists and masks
    before the store is usable: its ``x`` holds the dequantized mirror
    rows (zero-padded to the serving width) and ``x2`` the mirror's
    norms, so searches run at once with quantized-accurate distances;
    ``fp32_loader.apply(store)`` swaps the exact rows in. It needs a
    snapshot with a quantized mirror."""
    device = resolve_device(device, "restore_store")
    skip = {"x", "x2"} if quantized_first else frozenset()
    if step is not None:
        payload = read_snapshot(directory, step, skip=skip)
        return _rebuild_restored(directory, payload, quantized_first, device)
    steps = list_snapshots(directory)
    if not steps:
        raise SnapshotError(
            f"no committed snapshot under {directory!r} (directories "
            f"without a {_COMMIT} marker are ignored)")
    skipped = []
    last_err: SnapshotError | None = None
    for s in reversed(steps):
        # only the read falls back: a snapshot whose bytes are intact but
        # do not match the request (kind, no mirror) raises through
        try:
            payload = read_snapshot(directory, s, skip=skip)
        except SnapshotError as e:
            last_err = e
            _quarantine(directory, s, e)
            skipped.append(s)
            continue
        restored = _rebuild_restored(directory, payload, quantized_first,
                                     device)
        if skipped:
            restored = restored._replace(fallback_from=tuple(skipped))
        return restored
    raise SnapshotError(
        f"every committed snapshot under {directory!r} failed validation "
        f"(steps {list(reversed(steps))})") from last_err


def _rebuild_restored(directory: str, payload: tuple, quantized_first: bool,
                      device) -> Restored:
    step, arrays, manifest = payload
    if manifest.get("kind") != "mutable_store":
        raise SnapshotError(f"snapshot kind {manifest.get('kind')!r} is "
                            "not a mutable_store snapshot")
    if not quantized_first:
        store, values = rebuild_store(arrays, manifest, device=device)
        return Restored(store, values, step, manifest, None)
    if "qs_data" not in arrays:
        raise SnapshotError(
            "quantized-first restore needs a quantized mirror in the "
            f"snapshot, but step {step} under {directory!r} has none "
            "(store built with precision='f32')")
    qs = _rebuild_qs(arrays, manifest, device)
    cap, w = qs.data.shape
    x = torch.zeros((cap, int(manifest["dp"])), dtype=torch.float32,
                    device=device)
    x[:, :w] = dequantize(qs)        # what the quantized kernels see
    cfg = _cfg_from_echo(manifest["config"])
    store = MutableKNNStore(
        x=x, x2=qs.x2,               # the norms of the dequantized rows
        nl=NeighborLists(*(_tensor(arrays, manifest, f"nl_{f}", device)
                           for f in ("dist", "idx", "new"))),
        alive=_tensor(arrays, manifest, "alive", device),
        n=int(manifest["n"]), d=int(manifest["d"]), cfg=cfg, qs=qs,
        router=_rebuild_router(arrays, device),
        mips_m=_metric_meta(manifest, cfg))
    return Restored(store, _values(arrays, device), step, manifest,
                    Fp32Loader(directory, step))


# ---------------------------------------------------------------------------
# KNNDatastore (static) capture / rebuild: same format, its own kind
# ---------------------------------------------------------------------------


def capture_datastore(ds):
    """Flatten a static kNN-LM datastore (``keys``, ``values``,
    ``graph_idx``, optional ``qstore`` / ``router``) into (arrays, meta):
    ``KNNDatastore.snapshot``'s body."""
    arrays = {"keys": ds.keys, "values": ds.values,
              "graph_idx": ds.graph_idx}
    qstore = getattr(ds, "qstore", None)
    router = getattr(ds, "router", None)
    _capture_mirror_router(arrays, qstore, router)
    meta = {
        "kind": "knn_datastore",
        "n": int(ds.keys.shape[0]),
        "d": int(ds.keys.shape[1]),
        "k": int(ds.graph_idx.shape[1]),
        "has_qs": qstore is not None,
        "has_router": router is not None,
        # keys are stored transformed: a restore serves them under the
        # same metric
        "metric": getattr(ds, "metric", "l2"),
        "mips_m": float(getattr(ds, "mips_m", 0.0)),
        "build_stats": {k: v for k, v in
                        getattr(ds, "build_stats", {}).items()
                        if isinstance(v, (int, float, str, bool))},
    }
    return arrays, meta


def rebuild_datastore(arrays: dict, manifest: dict, *, device=None) -> dict:
    """Inverse of ``capture_datastore``: the constructor arguments of a
    ``KNNDatastore`` on ``device`` (but ``build_stats``, which the caller
    stamps)."""
    if manifest.get("kind") != "knn_datastore":
        raise SnapshotError(f"snapshot kind {manifest.get('kind')!r} is "
                            "not a knn_datastore snapshot")
    device = resolve_device(device, "rebuild_datastore")
    return {
        "keys": _tensor(arrays, manifest, "keys", device),
        "values": _tensor(arrays, manifest, "values", device),
        "graph_idx": _tensor(arrays, manifest, "graph_idx", device),
        "qstore": (_rebuild_qs(arrays, manifest, device)
                   if "qs_data" in arrays else None),
        "router": _rebuild_router(arrays, device),
        "metric": manifest.get("metric", "l2"),
        "mips_m": float(manifest.get("mips_m", 0.0)),
    }


# ---------------------------------------------------------------------------
# async writer
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SnapshotWriter:
    """Snapshots that run beside streaming inserts.

    ``save`` captures the store on the caller's thread (references to its
    tensors, not a copy) and hands the copy to the host and the write to a
    background thread. One write is in flight at a time: a second ``save``
    first joins the previous one and re-raises its error. ``keep`` keeps
    the newest N committed snapshots. An ``OSError`` (an injected
    ``persist.write`` fault too) is retried ``retries`` times with a
    doubling backoff from ``backoff_s`` (capped at 1 s) before it
    surfaces; a failed attempt leaves only its staging directory, which
    the next attempt clears."""

    directory: str
    keep: int = 3
    async_write: bool = True
    retries: int = 2
    backoff_s: float = 0.05

    def __post_init__(self):
        self._thread: threading.Thread | None = None
        self._error: Exception | None = None

    def save(self, store: MutableKNNStore, step: int, *, values=None,
             wait: bool = False) -> None:
        self.wait()                      # one outstanding write at a time
        arrays, meta = capture_store(store, values=values)

        def write():
            delay = self.backoff_s
            for attempt in range(self.retries + 1):
                try:
                    return write_snapshot(self.directory, step, arrays,
                                          meta, keep=self.keep)
                except OSError:
                    if attempt == self.retries:
                        raise
                    time.sleep(delay)
                    delay = min(delay * 2.0, 1.0)

        if self.async_write and not wait:
            def run():
                try:
                    write()
                except Exception as e:   # surfaced on next save/wait
                    self._error = e
            self._thread = threading.Thread(target=run, daemon=True)
            self._thread.start()
        else:
            write()

    def wait(self) -> None:
        """Join the in-flight write; re-raise its error, if any."""
        err = self.poll()
        if err is not None:
            raise err

    def poll(self) -> Exception | None:
        """Join the in-flight write and return its error (None when clean)
        instead of raising it."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        err, self._error = self._error, None
        return err
