"""Where the sharded build drops work, and the graph's recall, at
chip_smoke.py's path 14 shape: ``build_knn_graph_sharded`` over P logical
shards on one card, ``mnist_like(70000, 784)`` (seed 0, path 1's corpus),
``DescentConfig(k=20, reorder=False)``, key 50 (path 14's). The build runs
as the package has it; the script wraps helpers of
``repro_torch.core.distributed`` only to count, for every sampled
iteration and polish round:

  * ``route``: the incidence routes (``_all_to_all_route``, payload width
    2, ``cap`` rows a destination): rows sent, and rows past their
    destination's cap (dropped);
  * ``update``: the update route (width 3, ``cap_u``): the same;
  * ``invert``: the receivers' buffers (``invert_candidates``, ``s_cap``
    = 8 merge_k updates a receiver row): updates received, and updates
    past a row's buffer (the farthest dropped);
  * ``fetch``: the row fetches (``fetch_rows_a2a`` of the candidates or
    of the polish's lists, ``_plan_fetch`` of the polish's rows): ids
    asked (>= 0), and ids past their bucket.

The counts read the card back at every call, so the timings here are not
the build's. Each ``--shards`` value is one build; recall@20 is against
the exact graph (``brute_force_knn``). Prints the card's name and power
limit, then one JSON line a build:

    python3 tools/sharded_drops.py [--shards 4 2 1] [--n 70000]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shards", type=int, nargs="+", default=[4, 2, 1])
    ap.add_argument("--n", type=int, default=70_000)
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1]
                                         / "src"))
    args = ap.parse_args()
    sys.path.insert(0, args.src)
    import torch

    import repro_torch as rt
    from repro_torch.core import datasets
    from repro_torch.core import distributed as tdist
    from repro_torch.core.device import pin_fp32

    pin_fp32()
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0], flush=True)
    dev = torch.device("cuda")
    x = datasets.mnist_like(args.n, 784, seed=0, device=dev)
    _, truth = rt.brute_force_knn(x, x, 20, chunk=4096, device=dev)

    counts = defaultdict(lambda: defaultdict(int))
    phase = ["init"]

    def add(kind, sent, dropped):
        c = counts[phase[0]]
        c[kind + "_sent"] += int(sent)
        c[kind + "_dropped"] += int(dropped)

    route, invert = tdist._all_to_all_route, tdist.invert_candidates
    fetch, plan = tdist.fetch_rows_a2a, tdist._plan_fetch
    iterate, polish = (tdist.nn_descent_sharded_iteration,
                       tdist.polish_sharded_round)

    def counted_route(mesh, payload, mask, dest, cap, rnd):
        P = mesh.size
        for pay, m, d in zip(payload, mask, dest):
            per = torch.bincount(torch.where(m, d, P).long(),
                                 minlength=P + 1)[:P]
            add("route" if pay.shape[1] == 2 else "update", per.sum(),
                (per - cap).clamp_min(0).sum())
        return route(mesh, payload, mask, dest, cap, rnd)

    def counted_invert(cands, n_univ, src_cap, prio=None):
        c = cands.reshape(-1)
        per = torch.bincount(c[c >= 0].long(), minlength=n_univ)
        add("invert", per.sum(), (per - src_cap).clamp_min(0).sum())
        return invert(cands, n_univ, src_cap, prio)

    def counted_fetch(mesh, x_local, ids, *, cap):
        rows, ok = fetch(mesh, x_local, ids, cap=cap)
        for i, o in zip(ids, ok):
            add("fetch", (i >= 0).sum(), (i >= 0).sum() - o.sum())
        return rows, ok

    def counted_plan(mesh, n_local, ids, *, cap, span):
        plans = plan(mesh, n_local, ids, cap=cap, span=span)
        for i, f in zip(ids, plans):
            add("fetch", (i >= 0).sum(), (i >= 0).sum() - f.ok.sum())
        return plans

    def counted_iterate(*a, **kw):
        phase[0] = f"iter{sum(p.startswith('iter') for p in counts)}"
        out = iterate(*a, **kw)
        counts[phase[0]]["updates"] = int(out[1])
        return out

    def counted_polish(*a, **kw):
        phase[0] = f"polish{sum(p.startswith('polish') for p in counts)}"
        out = polish(*a, **kw)
        counts[phase[0]]["updates"] = int(out[1])
        return out

    tdist._all_to_all_route = counted_route
    tdist.invert_candidates = counted_invert
    tdist.fetch_rows_a2a = counted_fetch
    tdist._plan_fetch = counted_plan
    tdist.nn_descent_sharded_iteration = counted_iterate
    tdist.polish_sharded_round = counted_polish

    cfg = rt.DescentConfig(k=20, reorder=False)
    for shards in args.shards:
        counts.clear()
        phase[0] = "init"
        mesh = tdist.ShardMesh(["cuda:0"] * shards)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        _, idx, st = tdist.build_knn_graph_sharded(mesh, x, 20, cfg=cfg,
                                                   key=50)
        torch.cuda.synchronize()
        print(json.dumps({
            "shards": shards, "n": args.n, "cfg": "DescentConfig(k=20, "
            "reorder=False)", "key": 50, **st,
            "recall_at_20": rt.recall_at_k(idx, truth),
            "counted_wall_s": time.perf_counter() - t0,
            "max_memory_allocated": torch.cuda.max_memory_allocated(),
            "phases": {p: dict(c) for p, c in counts.items()}}),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
