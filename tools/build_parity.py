"""The k = 20 builds of two trees on the same draws, bit for bit.

Builds ``chip_smoke.py``'s path 1 graph (``build_knn_graph(k=20)`` on
``mnist_like(70000, 784)``, generator seed 0) at f32, int8 and bf16 (paths
1, 4 and 5) on one CUDA card, with the package imported from ``--src``,
and saves each graph's distances and ids, its stats and the launches of
each kernel to ``--out``. It also times the build's join (70000 x 20, dp
896) and receiver select (2048 x 800, c 60) at those shapes on seeded
inputs: one call's device time, ``--reps`` calls captured in a CUDA graph
and replayed between two CUDA events. ``--compare A B`` holds two saved
files against each other: distances and ids bitwise, the same stats and
launches; it prints the kernel times side by side. Unpack the other tree
under a directory that git ignores and run parent, change, change,
parent::

    python3 tools/build_parity.py --src build/parent/src --out build/p1.pt
    python3 tools/build_parity.py --src src --out build/c1.pt
    python3 tools/build_parity.py --src src --out build/c2.pt
    python3 tools/build_parity.py --src build/parent/src --out build/p2.pt
    python3 tools/build_parity.py --compare build/p1.pt build/c1.pt

Prints one JSON line per tree (or comparison) and the card's name and
power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

PRECISIONS = ("f32", "int8", "bf16")


def time_ms(fn, reps: int) -> float:
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def build(args) -> dict:
    sys.path.insert(0, str(Path(args.src).resolve()))
    import torch
    from repro_torch import DescentConfig, build_knn_graph
    from repro_torch.core import datasets
    from repro_torch.core.device import pin_fp32
    from repro_torch.core.layout import pad_features
    from repro_torch.kernels import _lib, ops
    pin_fp32()
    dev = torch.device("cuda")
    x = datasets.mnist_like(70000, 784, seed=0, device=dev)
    out = {"src": args.src, "graphs": {}, "ms": {}}
    for prec in PRECISIONS:
        _lib.reset_launches()
        dist, idx, st = build_knn_graph(
            x, k=20, cfg=DescentConfig(k=20, precision=prec),
            generator=torch.Generator(device=dev).manual_seed(0))
        out["graphs"][prec] = {
            "dist": dist.cpu(), "idx": idx.cpu(),
            "stats": [st.iters, list(st.updates), list(st.polish_updates),
                      st.dist_evals],
            "launches": {k: v for k, v in _lib.LAUNCHES.items() if v}}
    g = torch.Generator(device=dev).manual_seed(1)
    xp = pad_features(x).contiguous()
    x2 = (xp * xp).sum(1)
    ids = torch.randint(-1, 70000, (70000, 20), generator=g, device=dev,
                        dtype=torch.int32)
    out["ms"]["join 70000 x 20, dp 896"] = time_ms(
        lambda: ops.knn_join_dists(xp, x2, ids, 10), args.reps)
    gd = torch.rand(2048, 800, generator=g, device=dev)
    gi = torch.randint(-1, 70000, (2048, 800), generator=g, device=dev,
                       dtype=torch.int32)
    kth = torch.full((2048,), 0.5, device=dev)
    out["ms"]["select 2048 x 800, c 60"] = time_ms(
        lambda: ops.knn_join_select(gd, gi, kth, 60), args.reps)
    torch.save(out, args.out)
    return {"src": args.src, "ms": out["ms"],
            "stats": {p: v["stats"] for p, v in out["graphs"].items()}}


def compare(a_path: str, b_path: str) -> dict:
    import torch
    a, b = torch.load(a_path), torch.load(b_path)
    res = {"a": a["src"], "b": b["src"], "ms": {"a": a["ms"], "b": b["ms"]}}
    for prec in PRECISIONS:
        ga, gb = a["graphs"][prec], b["graphs"][prec]
        same = {
            "dist_bitwise": torch.equal(ga["dist"].view(torch.int32),
                                        gb["dist"].view(torch.int32)),
            "idx": torch.equal(ga["idx"], gb["idx"]),
            "stats": ga["stats"] == gb["stats"],
            "launches": ga["launches"] == gb["launches"]}
        res[prec] = same
        if not all(same.values()):
            raise AssertionError(f"{prec}: the trees' graphs differ: {same}")
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default="src")
    ap.add_argument("--out", default="build/build_parity.pt")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--compare", nargs=2, metavar=("A", "B"))
    args = ap.parse_args()
    if args.compare:
        print(json.dumps(compare(*args.compare)), flush=True)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("build_parity: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    print(json.dumps(build(args)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
