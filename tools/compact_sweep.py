"""Device time of the online store's two compactions at chip_smoke.py's
recorded shapes, so that two trees can be compared on one card.

``knn_compact`` (``repro_torch.kernels.ops``) purges tombstoned entries
from (n, k) neighbor lists; ``knn_compact_rows`` does it for the listed
rows of the full lists and returns copies of them. chip_smoke.py's online
path gives them (245, 32), the router's member lists (its purge in
``knn_delete``), and 1024 listed rows of (131072, 20), the store's lists
(the delete's frontier). Here both are made from ``--seed``: ascending
random distances, ids in [0, n) with a share of empty slots (-1, +inf),
and a drop mask that marks ``--drop`` of the entries (chip_smoke.py's
online path deletes 7000 of 70000 rows, a tenth). Each call is first held
against its plain version (bitwise), then timed: ``--reps`` calls captured
in a CUDA graph and replayed between two CUDA events, ``--repeats``
readings. The package is imported from ``--src``; unpack the other tree
under a directory that git ignores and run parent, change, change,
parent:

    python3 tools/compact_sweep.py --src build/parent/src --label parent
    python3 tools/compact_sweep.py --label change

Prints the card's name and power limit, then one JSON line per call: its
shape, survivors, and the readings in ms (for the row form also those of
the (n, k) copy alone, the part of its time the kernel does not spend).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

# (name, n, k, listed rows or None): chip_smoke.py's recorded calls
CALLS = (("knn_compact", 245, 32, None),
         ("knn_compact_rows", 131072, 20, 1024))


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


def lists(n: int, k: int, f: int | None, drop_share: float, g, dev):
    """(n, k) ascending lists with empty slots, and the drop mask of the
    call ((n, k), or (f, k) for f listed rows, with the rows)."""
    import torch
    d = torch.rand(n, k, generator=g, device=dev).sort(dim=1).values
    i = torch.randint(0, n, (n, k), generator=g, device=dev,
                      dtype=torch.int32)
    empty = torch.rand(n, k, generator=g, device=dev) < 0.02
    d = torch.where(empty, torch.inf, d)
    i = torch.where(empty, -1, i)
    rows = None if f is None else torch.randperm(
        n, generator=g, device=dev)[:f].to(torch.int32)
    drop = torch.rand(n if f is None else f, k, generator=g,
                      device=dev) < drop_share
    return d, i, rows, drop


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default="src")
    ap.add_argument("--label", default="")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--drop", type=float, default=0.1)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.src).resolve()))
    import torch
    if not torch.cuda.is_available():
        print("compact_sweep: no CUDA card", file=sys.stderr)
        return 1
    from repro_torch.kernels import ops
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    g = torch.Generator(device=dev).manual_seed(args.seed)
    ok = True
    for name, n, k, f in CALLS:
        d, i, rows, drop = lists(n, k, f, args.drop, g, dev)
        call_args = (d, i, drop) if rows is None else (d, i, rows, drop)
        fn = getattr(ops, name)
        got, want = fn(*call_args), fn(*call_args, backend="ref")
        good = all(torch.equal(a, b) for a, b in zip(got, want))
        ok = ok and good
        sub_d, sub_i = (d, i) if rows is None else (d[rows.long()],
                                                    i[rows.long()])
        keep = ~drop & (sub_i >= 0) & torch.isfinite(sub_d)
        line = {"label": args.label, "name": name, "n": n, "k": k,
                "rows": f, "survivors": int(keep.sum()), "agrees": good,
                "ms": [time_ms(lambda: fn(*call_args), args.reps)
                       for _ in range(args.repeats)]}
        if rows is not None:
            line["copy_ms"] = [time_ms(lambda: (d.clone(), i.clone()),
                                       args.reps)
                               for _ in range(args.repeats)]
        print(json.dumps(line), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
