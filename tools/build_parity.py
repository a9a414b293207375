"""The k = 20 builds of two trees on the same draws, bit for bit.

Builds ``chip_smoke.py``'s path 1 graph (``build_knn_graph(k=20)`` on
``mnist_like(70000, 784)``, generator seed 0) at f32, int8 and bf16 (paths
1, 4 and 5) on one CUDA card, with the package imported from ``--src``,
and saves each graph's distances and ids, its stats and the launches of
each kernel to ``--out``. It also times the build's join (70000 x 20, dp
896) and receiver select (2048 x 800, c 60) at those shapes on seeded
inputs: one call's device time, ``--reps`` calls captured in a CUDA graph
and replayed between two CUDA events. It also times, on seeded inputs,
the k = 91 kernels at path 22's shapes (the fp32 join at
70000 x 92, dp 896, cn 46: row 1d; the selects at 2048 x 16928, c 273 and
70000 x 8281, c 546: rows 2m, 2n) and path 23's (the row merge of 500
rows at c 8281 into 70000 x 91 lists: row 6e; the dense merge of 2048
rows: row 3d; a tree whose merge refuses the pool records "refused"). The
join is timed on four id sets that split its loss: each slot valid with
probability 0.57 (about path 22's 1031 valid pairs a row) or all valid,
ids drawn from the whole corpus or from a window of 2048 rows (whose
gathers stay in L2). ``--compare A B`` holds two saved
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
    out["ms"].update(large_k_ms(args, dev, xp, x2))
    torch.save(out, args.out)
    return {"src": args.src, "ms": out["ms"],
            "stats": {p: v["stats"] for p, v in out["graphs"].items()}}


def large_k_ms(args, dev, xp, x2) -> dict:
    """Device ms of the k = 91 kernels at paths 22's and 23's shapes on
    seeded inputs; "refused" where the tree's wrapper refuses the call."""
    import torch
    from repro_torch.kernels import ops
    g = torch.Generator(device=dev).manual_seed(2)
    big_n, reps = xp.shape[0], max(2, args.reps // 4)
    ms = {}

    def timed(key, fn, r=reps):
        try:
            ms[key] = time_ms(fn, r)
        except ValueError as err:          # a wrapper's refusal
            ms[key] = f"refused: {err}"
    for valid in (0.57, 1.0):
        for span in (big_n, 2048):
            ids = torch.randint(0, span, (big_n, 92), generator=g,
                                device=dev, dtype=torch.int32)
            ids[torch.rand(big_n, 92, generator=g, device=dev) > valid] = -1
            timed(f"join 70000 x 92, dp 896, cn 46, valid {valid}, ids in "
                  f"{span} rows", lambda i=ids: ops.knn_join_dists(
                      xp, x2, i, 46), 2)
            del ids
    for n, w, c, th in ((2048, 16928, 273, 0.3), (70000, 8281, 546, 2.0)):
        gd = torch.rand(n, w, generator=g, device=dev)
        gi = torch.randint(-1, big_n, (n, w), generator=g, device=dev,
                           dtype=torch.int32)
        kth = torch.full((n,), th, device=dev)
        timed(f"select {n} x {w}, c {c}",
              lambda: ops.knn_join_select(gd, gi, kth, c))
        del gd, gi
    k, c = 91, 91 * 91
    cd = torch.rand(big_n, k, generator=g, device=dev).sort(1).values
    ci = torch.randint(0, big_n, (big_n, k), generator=g, device=dev,
                       dtype=torch.int32)
    for f in (500, 2048):
        qd = torch.rand(f, c, generator=g, device=dev)
        qi = torch.randint(-1, big_n, (f, c), generator=g, device=dev,
                           dtype=torch.int32)
        rows = torch.randperm(big_n, generator=g, device=dev)[:f].to(
            torch.int32)
        timed(f"merge_rows {f} of 70000 x 91, c {c}",
              lambda: ops.knn_merge_rows(cd, ci, rows, qd, qi))
        timed(f"merge {f} x 91, c {c}",
              lambda: ops.knn_merge(cd[:f].contiguous(), ci[:f].contiguous(),
                                    qd, qi))
    return ms


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
