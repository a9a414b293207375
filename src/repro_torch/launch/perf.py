"""Perf hill-climb runner (src/repro/launch/perf.py): count named
VARIANTS of the chosen cells with the dry-run (launch/dryrun.py) and
write results/perf_torch/<cell>__<variant>.json.

    PYTHONPATH=src python -m repro_torch.launch.perf --cell mamba --variant baseline
    PYTHONPATH=src python -m repro_torch.launch.perf --cell moe --all
    PYTHONPATH=src python -m repro_torch.launch.perf --cell knn --variant ring --knn-n 131072

Cells:
  knn    = knn-build x knn_1m_256    (the paper's workload; a real
           device, the card unless --device names another; one card does
           not hold its full n as 256 logical shards, and --knn-n cuts
           the corpus, which the record's ``reduced`` and the printed
           line show)
  mamba  = mamba2-130m x train_4k
  moe    = deepseek-v2-lite x train_4k
  gemma  = gemma2-27b x train_4k

JAX's ``lower_knn_variant`` subtracts an all-to-all "CPU artifact" (XLA's
CPU backend splits each all_to_all into P slice fusions); the port's
counter counts the ``ShardMesh.all_to_all`` it runs, which has no such
artefact, so there is no correction.
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import os
import time

from repro_torch.configs import get_config
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.report import cut_note

OUT_DIR = "results/perf_torch"


def lower_train_variant(arch: str, shape: str, cfg_overrides: dict,
                        microbatches: int = 4):
    cfg = get_config(arch)
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    mesh = make_production_mesh(device="meta")
    return dryrun._lower_train(cfg, shape, mesh, microbatches)


def lower_knn_variant(fetch: str, n: int | None = None, device="cuda"):
    """knn_1m_256 (``n`` cuts its corpus) with ``fetch`` "a2a" or
    "ring", on ``device``."""
    rec = dryrun._lower_knn_cell("knn_1m_256", False, fetch=fetch, n=n,
                                 device=device)
    rec.pop("mesh_chips")
    return rec


VARIANTS = {
    # the knn variants take the device (``run``)
    "knn": {
        "ring": functools.partial(lower_knn_variant, "ring"),
        "a2a": functools.partial(lower_knn_variant, "a2a"),
    },
    "mamba": {
        "baseline": lambda: lower_train_variant(
            "mamba2-130m", "train_4k", {}),
        "bf16_intra": lambda: lower_train_variant(
            "mamba2-130m", "train_4k", {"ssm_intra_dtype": "bf16"}),
        "chunk128": lambda: lower_train_variant(
            "mamba2-130m", "train_4k", {"ssm_chunk": 128}),
        "bf16_chunk128": lambda: lower_train_variant(
            "mamba2-130m", "train_4k",
            {"ssm_intra_dtype": "bf16", "ssm_chunk": 128}),
        "bf16str_chunk128": lambda: lower_train_variant(
            "mamba2-130m", "train_4k",
            {"ssm_intra_dtype": "bf16", "ssm_chunk": 128}),
        "mb8_bf16_c128": lambda: lower_train_variant(
            "mamba2-130m", "train_4k",
            {"ssm_intra_dtype": "bf16", "ssm_chunk": 128},
            microbatches=8),
    },
    "moe": {
        "baseline": lambda: lower_train_variant(
            "deepseek-v2-lite-16b", "train_4k",
            {"attn_head_constraint": False}),
        "headshard": lambda: lower_train_variant(
            "deepseek-v2-lite-16b", "train_4k",
            {"attn_head_constraint": True}),
        "headshard_mb2": lambda: lower_train_variant(
            "deepseek-v2-lite-16b", "train_4k",
            {"attn_head_constraint": True}, microbatches=2),
        "headshard_tri": lambda: lower_train_variant(
            "deepseek-v2-lite-16b", "train_4k",
            {"attn_head_constraint": True, "triangle_schedule": True}),
        # triangle only engages when cq == ckv (chunk grid must be square)
        "headshard_tri512": lambda: lower_train_variant(
            "deepseek-v2-lite-16b", "train_4k",
            {"attn_head_constraint": True, "triangle_schedule": True,
             "attn_chunk_kv": 512}),
    },
    "gemma": {
        "baseline": lambda: lower_train_variant(
            "gemma2-27b", "train_4k", {"attn_head_constraint": False}),
        "headshard": lambda: lower_train_variant(
            "gemma2-27b", "train_4k", {"attn_head_constraint": True}),
        "headshard_tri": lambda: lower_train_variant(
            "gemma2-27b", "train_4k",
            {"attn_head_constraint": True, "triangle_schedule": True,
             "attn_chunk_kv": 512}),
        "headshard_mb2": lambda: lower_train_variant(
            "gemma2-27b", "train_4k",
            {"attn_head_constraint": True}, microbatches=2),
    },
}


def run(cell: str, variant: str, device="cuda", knn_n: int | None = None):
    """One variant's record; the knn cell's on ``device``, its corpus cut
    to ``knn_n`` rows when given."""
    fn = VARIANTS[cell][variant]
    return fn(n=knn_n, device=device) if cell == "knn" else fn()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", required=True, choices=sorted(VARIANTS))
    ap.add_argument("--variant")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=OUT_DIR)
    ap.add_argument("--device", default="cuda",
                    help="the knn cell's device (the LM cells run on meta)")
    ap.add_argument("--knn-n", type=int, default=None,
                    help="cut the knn cell's corpus to this many rows")
    args = ap.parse_args()
    os.makedirs(args.out, exist_ok=True)
    todo = sorted(VARIANTS[args.cell]) if args.all else [args.variant]
    for v in todo:
        path = os.path.join(args.out, f"{args.cell}__{v}.json")
        if os.path.exists(path):
            print(f"skip {v} (exists)")
            continue
        t0 = time.time()
        rec = run(args.cell, v, args.device, args.knn_n)
        rec.update({"cell": args.cell, "variant": v,
                    "compile_s": round(time.time() - t0, 1)})
        with open(path, "w") as f:
            json.dump(rec, f, indent=2, default=str)
        r = rec["roofline"]
        print(f"[{args.cell}:{v}{cut_note(rec)}] "
              f"bneck={r['bottleneck']} "
              f"t_c={r['t_compute_s']:.3e} t_m={r['t_memory_s']:.3e} "
              f"t_coll={r['t_collective_s']:.3e} "
              f"rl_frac={r['roofline_fraction']:.4f}", flush=True)


if __name__ == "__main__":
    main()
