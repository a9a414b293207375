"""Build and load the kernel library (every ``csrc/*.cu``).

Each source is compiled at first use by its own ``nvcc`` for ``sm_90a``,
all started together, and the objects are linked into one shared library
with a plain C interface, under ``<repo>/build/repro_torch/
libknn_kernels_<hash of the sources and csrc/common.cuh>.so``, and
loaded with ``ctypes``. Nothing here runs at import: the CPU tests import
every module on a machine with no ``nvcc``.

Launch counters live here too: each wrapper adds one to its kernel's count
where it launches it, and nowhere else, so a run can show that the main
path went through the kernels. The device function of kernel ``name`` is
``<name>_kernel``, or a name that contains it: ``flash_attention`` has two,
``flash_attention_kernel`` (f32) and ``flash_attention_kernel_sm90``
(bf16), reported apart as ``flash_attention`` and ``flash_attention_sm90``;
``pairwise_sq_l2`` launches ``pairwise_sq_l2_kernel_k_major`` (its
operands' k-major copies) before ``pairwise_sq_l2_kernel``, and after it,
on a grid split over the features, ``pairwise_sq_l2_kernel_split_sum``;
they are reported as ``pairwise_sq_l2_k_major`` and
``pairwise_sq_l2_split_sum``. The joins above C 64 launch
``<name>_kernel_wide``, the select above a padded W of 8192
``knn_join_select_kernel_resident`` or, past what a block holds,
``knn_join_select_kernel_stream``, and the merges above a pool of 8192
``knn_merge_kernel_wide`` and ``knn_merge_rows_kernel_wide``: each is
reported with its suffix after the kernel's name.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = tuple(sorted(CSRC.glob("*.cu")))
HEADERS = tuple(sorted(CSRC.glob("*.cuh")))
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

KERNELS = ("knn_join_dists", "knn_join_select", "knn_merge",
           "pairwise_sq_l2", "knn_search_dists",
           "knn_search_dists_q8", "knn_search_dists_bf16",
           "knn_join_dists_q8", "knn_join_dists_bf16",
           "knn_compact", "knn_merge_rows", "knn_compact_rows",
           "flash_attention")
LAUNCHES: dict[str, int] = dict.fromkeys(KERNELS, 0)
# device functions reported under their own name (substring -> name)
VARIANTS = {"flash_attention_kernel_sm90": "flash_attention_sm90",
            "knn_join_dists_kernel_wide": "knn_join_dists_wide",
            "knn_join_dists_q8_kernel_wide": "knn_join_dists_q8_wide",
            "knn_join_dists_bf16_kernel_wide": "knn_join_dists_bf16_wide",
            "knn_join_select_kernel_stream": "knn_join_select_stream",
            "knn_join_select_kernel_resident": "knn_join_select_resident",
            "knn_merge_kernel_wide": "knn_merge_wide",
            "knn_merge_rows_kernel_wide": "knn_merge_rows_wide",
            "pairwise_sq_l2_kernel_k_major": "pairwise_sq_l2_k_major",
            "pairwise_sq_l2_kernel_split_sum": "pairwise_sq_l2_split_sum"}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    # x, x2, ids, od, ev, scratch (or NULL), scratch blocks, N, n, C, dp,
    # cn, stream; and the scratch bytes a block of the wide join needs
    "knn_join_dists_launch": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                              _I, _P],
    "knn_join_scratch_bytes": [_I, _I],
    # gd, gi, kth, od, oi, scratch (or NULL), n, W, c, stream
    "knn_join_select_launch": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    # cd, ci, qd, qi, od, oi, upd, scratch (or NULL), scratch blocks, n,
    # k, c, stream; and the scratch bytes a block of the wide merge needs
    "knn_merge_launch": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                         _P],
    "knn_merge_scratch_bytes": [_I, _I],
    # a, b, at, bt (k-major scratch), out, ws (split scratch), M, N, D,
    # lda, ldb, splits, stream; and the split count for (M, N, D)
    "pairwise_sq_l2_launch": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                              _I, _P],
    "pairwise_sq_l2_splits": [_I, _I, _I],
    # q, q2, x, x2, ids, od, N, nq, W, dp, stream
    "knn_search_dists_launch": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    # qq, qscale, q2, data, scale, x2, ids, od, N, nq, W, w, stream
    "knn_search_dists_q8_launch": [_P, _P, _P, _P, _P, _P, _P, _P,
                                   _I, _I, _I, _I, _P],
    # q, q2, data, x2, ids, od, N, nq, W, w, stream
    "knn_search_dists_bf16_launch": [_P, _P, _P, _P, _P, _P,
                                     _I, _I, _I, _I, _P],
    # data, scale, x2, ids, od, ev, N, n, C, w, cn, stream
    "knn_join_dists_q8_launch": [_P, _P, _P, _P, _P, _P,
                                 _I, _I, _I, _I, _I, _P],
    # data, x2, ids, od, ev, N, n, C, w, cn, stream
    "knn_join_dists_bf16_launch": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                   _P],
    # cd, ci, drop, od, oi, removed, n, k, stream
    "knn_compact_launch": [_P, _P, _P, _P, _P, _P, _I, _I, _P],
    # cd, ci, rows, qd, qi, od, oi, upd, scratch (or NULL), scratch
    # blocks, n, f, k, c, stream
    "knn_merge_rows_launch": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                              _I, _I, _I, _I, _P],
    # cd, ci, rows, drop, od, oi, removed, n, f, k, stream
    "knn_compact_rows_launch": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    # q, k, v, o, B, Lq, Lk, H, Hkv, Dq, Dv, scale, softcap, causal, window,
    # q_offset, stream (f32, then bf16)
    "flash_attention_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                               _F, _F, _I, _I, _I, _P],
    "flash_attention_sm90_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                    _I, _F, _F, _I, _I, _I, _P],
}

_RESTYPES = {"knn_merge_scratch_bytes": ctypes.c_int64,
             "knn_join_scratch_bytes": ctypes.c_int64}

_lib: ctypes.CDLL | None = None
build_info: dict = {}


def reset_launches() -> None:
    for name in KERNELS:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                       f"{CSRC} at first use and need the CUDA toolkit")


def library_path() -> Path:
    h = hashlib.sha256()
    for src in (*SOURCES, *HEADERS):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libknn_kernels_{h.hexdigest()[:16]}.so"


def report_name(mangled: str) -> str:
    """The kernel (or variant) name of a device function."""
    for sub, name in VARIANTS.items():
        if sub in mangled:
            return name
    return next((k for k in KERNELS if f"{k}_kernel" in mangled), mangled)


def _parse_ptxas(log: str) -> dict:
    """Registers and shared memory per kernel from ``-Xptxas -v``: under
    the kernel's name (its last template instance) and, for a template,
    also under ``name<its integer arguments>``."""
    out: dict[str, dict] = {}
    current: list[str] = []
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = report_name(m.group(1))
            args = re.findall(r"Li(\d+)E", m.group(1))
            current = [name] + ([f"{name}<{','.join(args)}>"] if args else [])
            for key in current:
                out[key] = {}
            continue
        m = re.search(r"Used (\d+) registers", line)
        s = re.search(r"(\d+) bytes smem", line)
        spill = re.search(r"(\d+) bytes spill stores", line)
        for key in current:
            if m:
                out[key]["registers"] = int(m.group(1))
                out[key]["static_smem_bytes"] = int(s.group(1)) if s else 0
            if spill:
                out[key]["spill_store_bytes"] = int(spill.group(1))
    return out


def sass_functions(path: Path, opcode: str) -> dict[str, int]:
    """For each device function in the library's SASS (``cuobjdump
    -sass``): how many of its instructions are ``opcode`` (e.g. ``HGMMA``,
    ``HMMA``). Keyed by ``report_name`` and template arguments, as
    ``_parse_ptxas``."""
    tool = Path(_nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(tool), "-sass", str(path)], check=True,
                          capture_output=True, text=True).stdout
    out: dict[str, int] = {}
    for part in sass.split("Function : ")[1:]:
        mangled = part.split(None, 1)[0]
        args = re.findall(r"Li(\d+)E", mangled)
        key = report_name(mangled) + (f"<{','.join(args)}>" if args else "")
        out[key] = out.get(key, 0) + len(re.findall(rf"\b{opcode}\b", part))
    return out


def _run_all(cmds: list[list[str]]) -> str:
    """Run the commands in parallel; their joined output, or raise."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for cmd, p, out in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}): "
                               f"{' '.join(cmd)}\n{out}")
    return "".join(outs)


def build(force: bool = False) -> Path:
    """Compile the sources unless their library exists (or ``force``).
    Records the compile time and the ptxas report in ``build_info``."""
    path = library_path()
    if path.exists() and not force:
        return path
    path.parent.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=path.parent) as tmp:
        objs = [str(Path(tmp) / f"{src.stem}.o") for src in SOURCES]
        compiles = [[nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)]
                    for src, obj in zip(SOURCES, objs)]
        log = _run_all(compiles)
        so = str(Path(tmp) / path.name)
        link = [nvcc, "-shared", "-o", so, *objs]
        _run_all([link])
        os.replace(so, path)           # atomic: concurrent builds agree
    seconds = time.perf_counter() - t0
    build_info.update(
        seconds=seconds, path=str(path),
        commands=[" ".join(c) for c in (*compiles, link)],
        kernels=_parse_ptxas(log),
        # ptxas's info notes that it serialised wgmma (C7510-C7520)
        performance_notes=[ln.strip() for ln in log.splitlines()
                           if "Performance Loss" in ln],
    )
    return path


def lib() -> ctypes.CDLL:
    """The loaded library, built first if needed."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = _RESTYPES.get(name, ctypes.c_int)
        handle.knn_error_string.argtypes = [ctypes.c_int]
        handle.knn_error_string.restype = ctypes.c_char_p
        _lib = handle
    return _lib


def check(code: int, name: str) -> None:
    if code != 0:
        msg = lib().knn_error_string(code).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {code} ({msg})")
