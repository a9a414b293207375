"""Aggregate the dry-run's records (results/dryrun_torch/*.json) into the
dry-run, roofline and collective markdown tables
(src/repro/launch/report.py), memory held to the H100's 80 GB; a
knn-build cell counted on a cut corpus says so beside its shape.

    PYTHONPATH=src python -m repro_torch.launch.report results/dryrun_torch
"""
from __future__ import annotations

import glob
import json
import os
import sys


def load(outdir: str) -> list[dict]:
    rows = []
    for f in sorted(glob.glob(os.path.join(outdir, "*.json"))):
        with open(f) as fh:
            rows.append(json.load(fh))
    return rows


def cut_note(rec) -> str:
    """" (n cut 1048576->131072)" for a knn-build record counted on a cut
    corpus, else ""."""
    n = rec.get("reduced", {}).get("n")
    return f" (n cut {n[0]}->{n[1]})" if n else ""


def fmt_e(x):
    return f"{x:.2e}"


def dryrun_table(rows: list[dict]) -> str:
    out = ["| arch | shape | mesh | status | chips | resident GiB | "
           "no-liveness upper GiB | fits 80G (res/upper) | compile s |",
           "|---|---|---|---|---|---|---|---|---|"]
    for r in sorted(rows, key=lambda r: (r["arch"], r["shape"], r["mesh"])):
        if r["status"] == "ok":
            m = r["memory"]
            out.append(
                f"| {r['arch']} | {r['shape']}{cut_note(r)} | {r['mesh']} "
                f"| ok | "
                f"{r['chips']} | {m['resident_bytes']/2**30:.2f} | "
                f"{m['upper_bytes']/2**30:.2f} | "
                f"{'yes' if m['fits_80g_resident'] else 'NO'}/"
                f"{'yes' if m['fits_80g'] else 'no'} | {r['compile_s']} |")
        else:
            out.append(
                f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
                f"{r['status']}: {r.get('reason', r.get('returncode'))} "
                f"| - | - | - | - | - |")
    return "\n".join(out)


def roofline_table(rows: list[dict], mesh: str = "single") -> str:
    out = ["| arch | shape | t_compute s | t_memory s | t_coll s | "
           "bottleneck | MODEL_FLOPS | useful ratio | roofline frac |",
           "|---|---|---|---|---|---|---|---|---|"]
    for r in sorted(rows, key=lambda r: (r["arch"], r["shape"])):
        if r["status"] != "ok" or r["mesh"] != mesh:
            continue
        rl = r["roofline"]
        out.append(
            f"| {r['arch']} | {r['shape']}{cut_note(r)} | "
            f"{fmt_e(rl['t_compute_s'])} | "
            f"{fmt_e(rl['t_memory_s'])} | {fmt_e(rl['t_collective_s'])} | "
            f"{rl['bottleneck']} | {fmt_e(rl['model_flops'])} | "
            f"{rl['useful_flops_ratio']:.2f} | "
            f"{rl['roofline_fraction']:.4f} |")
    return "\n".join(out)


def collectives_summary(rows: list[dict]) -> str:
    out = ["| arch | shape | mesh | collective bytes/chip | DCN bytes | "
           "top kinds |",
           "|---|---|---|---|---|---|"]
    for r in sorted(rows, key=lambda r: (r["arch"], r["shape"], r["mesh"])):
        if r["status"] != "ok":
            continue
        c = r["collectives"]
        kinds = sorted(c["bytes"].items(), key=lambda kv: -kv[1])[:2]
        ks = ", ".join(f"{k} {fmt_e(v)}" for k, v in kinds)
        out.append(
            f"| {r['arch']} | {r['shape']}{cut_note(r)} | {r['mesh']} | "
            f"{fmt_e(c['total_bytes'])} | {fmt_e(c.get('dcn_bytes', 0))} | "
            f"{ks} |")
    return "\n".join(out)


def report(rows: list[dict]) -> str:
    ok = [r for r in rows if r["status"] == "ok"]
    skip = [r for r in rows if r["status"] == "skip"]
    err = [r for r in rows if r["status"] not in ("ok", "skip")]
    return "\n".join([
        f"## Dry-run summary: {len(ok)} counted, {len(skip)} documented "
        f"skips, {len(err)} errors\n",
        "### Dry-run\n", dryrun_table(rows),
        "\n### Roofline (single-pod, 256 chips)\n",
        roofline_table(rows, "single"),
        "\n### Multi-pod deltas (512 chips)\n",
        roofline_table(rows, "multi"),
        "\n### Collective traffic\n", collectives_summary(ok)])


def main():
    outdir = sys.argv[1] if len(sys.argv) > 1 else "results/dryrun_torch"
    print(report(load(outdir)))


if __name__ == "__main__":
    main()
