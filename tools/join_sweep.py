"""Device time of the quantized joins over the candidate count C.

Times ``knn_join_dists_q8`` and ``knn_join_dists_bf16`` (``repro_torch.
kernels.ops``) on one CUDA card at the default build's corpus shape (70000
rows, w 800) with random candidate ids, one id in 20 invalid and half the
candidates new, for each C of ``--cs``. Each reading is one call's device
time: ``--reps`` calls captured in a CUDA graph and replayed between two
CUDA events. Every kernel is first held against its plain version on the
first 256 rows (int8 bitwise, bf16 within 1e-4 + 1e-5 (x2_s + x2_t)).

The package is imported from ``--src``, so two trees can be compared on
one card: unpack the other tree under a directory that git ignores and
run parent, change, change, parent::

    python3 tools/join_sweep.py --src build/parent/src --label parent
    python3 tools/join_sweep.py --src src --label change

Prints one JSON line per (mode, C) and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path


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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default="src")
    ap.add_argument("--label", default="")
    ap.add_argument("--cs", default="20,28,40,48,64")
    ap.add_argument("--n", type=int, default=70000)
    ap.add_argument("--width", type=int, default=800)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.src).resolve()))
    import torch
    if not torch.cuda.is_available():
        print("join_sweep: no CUDA card", file=sys.stderr)
        return 1
    from repro_torch.core.quantize import quantize_corpus
    from repro_torch.kernels import ops
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(args.seed)
    x = 3.0 * torch.randn(args.n, args.width, generator=g, device=dev)
    ok = True
    for mode in ("int8", "bf16"):
        xs = quantize_corpus(x, mode)
        for c in (int(s) for s in args.cs.split(",")):
            ids = torch.randint(0, args.n, (args.n, c), generator=g,
                                device=dev, dtype=torch.int32)
            drop = torch.rand(args.n, c, generator=g, device=dev) < 0.05
            ids[drop] = -1
            cn = c // 2
            if mode == "int8":
                name = "knn_join_dists_q8"
                call = lambda i, b: ops.knn_join_dists_q8(  # noqa: E731
                    xs.data, xs.scale, xs.x2, i, cn, backend=b)
            else:
                name = "knn_join_dists_bf16"
                call = lambda i, b: ops.knn_join_dists_bf16(  # noqa: E731
                    xs.data, xs.x2, i, cn, backend=b)
            (gd, gev), (wd, wev) = call(ids[:256], "auto"), \
                call(ids[:256], "ref")
            if mode == "int8":
                agree = bool(torch.equal(gd, wd))
            else:
                sub = ids[:256]
                x2g = torch.where(sub >= 0, xs.x2[sub.clamp(min=0).long()],
                                  0.0)
                tol = 1e-4 + 1e-5 * (x2g[:, :, None] + x2g[:, None, :])
                fin = torch.isfinite(wd)
                agree = bool(torch.equal(torch.isinf(gd), torch.isinf(wd))
                             and ((gd - wd).abs()[fin] <= tol[fin]).all())
            agree = agree and bool(torch.equal(gev, wev))
            ok = ok and agree
            ms = [time_ms(lambda: call(ids, "auto"), args.reps)
                  for _ in range(args.repeats)]
            print(json.dumps({"label": args.label, "kernel": name, "C": c,
                              "n": args.n, "width": args.width,
                              "agrees": agree, "ms": ms}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
