"""Device time of the search tiles round by round, on a graph search's own
tiles.

``knn_search_dists`` (fp32), ``knn_search_dists_bf16`` and
``knn_search_dists_q8`` (int8; ``repro_torch.kernels.ops``) score one
(512, 120) tile of candidate ids a round. How many rows the queries of a
block share, and how many slots are valid, change from round to round,
and so does the tile's time. Two steps:

``--record FILE`` builds ``mnist_like(70000, 784)`` (seed 0) and its k-20
graph through the kernels, as chip_smoke.py's build does, and searches the
first block of chip_smoke.py's queries (the corpus's first 512 rows plus
0.01 N(0, 1), seed 4) with its ``SearchConfig(beam=32, rounds=48,
expand=6, q_block=512)`` at f32, bf16 and int8; it saves every round's
tile (query rows, their norms and int8 scales, the ids) to FILE.

``--tiles FILE`` times each recorded tile with the package imported from
``--src``, so two trees can be compared on one card (unpack the other tree
under a directory that git ignores and run parent, change, change,
parent); then one tile of uniform random ids at the same shape, where no
two slots share a row. ``--precisions`` picks the tiles (default all
three). The corpus and its bf16 and int8 mirrors are made again from the
seed (and checked against the recorded checksum). Each reading is one
call's device time: ``--reps`` calls captured in a CUDA graph and replayed
between two CUDA events, ``--repeats`` readings. Every tile is first held
against its plain version (+inf exactly, else within 1e-4 + 1e-5 (q2 +
c2); int8 bitwise).

    python3 tools/search_sweep.py --record build/search_tiles.pt
    python3 tools/search_sweep.py --tiles build/search_tiles.pt \\
        --src build/parent/src --label parent
    python3 tools/search_sweep.py --tiles build/search_tiles.pt --label change

Prints the card's name and power limit, then one JSON line per tile: the
round, valid candidates, distinct rows, the sum over groups of 16
consecutive queries of their distinct rows (what a tile that read a row
once per group would read), and the readings in ms.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

N, DIM, SEED, GROUP = 70_000, 784, 0, 16
N_QUERIES = 10_000        # chip_smoke.py's search: its first block
# precision -> the tile's entry point in kernels/ops.py
TILES = {"f32": "knn_search_dists", "bf16": "knn_search_dists_bf16",
         "int8": "knn_search_dists_q8"}


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


def corpus(dev):
    from repro_torch.core import datasets
    return datasets.mnist_like(N, DIM, seed=SEED, device=dev)


def record(path: Path, dev) -> None:
    import torch

    from repro_torch import (DescentConfig, SearchConfig, build_knn_graph,
                             graph_search)
    from repro_torch.kernels import ops
    x = corpus(dev)
    _, idx, _ = build_knn_graph(
        x, k=20, cfg=DescentConfig(k=20),
        generator=torch.Generator(device=dev).manual_seed(SEED))
    g = torch.Generator(device=dev).manual_seed(SEED + 4)
    q = (x[:N_QUERIES] + 0.01 * torch.randn(N_QUERIES, DIM, generator=g,
                                            device=dev))[:512]
    tiles = {}
    for prec, name in TILES.items():
        real, calls = getattr(ops, name), []
        n_q = 3 if prec == "int8" else 2      # the query side's tensors

        def rec(*args, **kw):
            if args[-1].shape[1] == 120:      # the rounds, not a re-rank
                calls.append((*(a.cpu() for a in args[:n_q]),
                              args[-1].cpu()))
            return real(*args, **kw)
        setattr(ops, name, rec)
        try:
            graph_search(x, idx, q, k_out=10, cfg=SearchConfig(
                beam=32, rounds=48, expand=6, q_block=512, precision=prec))
        finally:
            setattr(ops, name, real)
        tiles[prec] = calls
    torch.save({"checksum": float(x.double().sum()), "tiles": tiles}, path)
    print(json.dumps({"recorded": {p: len(c) for p, c in tiles.items()}}))


def sharing(ids, big_n: int) -> dict:
    import torch
    valid = (ids >= 0) & (ids < big_n)
    group = sum(int(torch.unique(ids[s:s + GROUP][valid[s:s + GROUP]])
                    .numel()) for s in range(0, ids.shape[0], GROUP))
    return {"valid_candidates": int(valid.sum()),
            "distinct_rows": int(torch.unique(ids[valid]).numel()),
            "group_distinct_rows": group}


def agrees(got, want, q2, x2, ids, exact: bool) -> bool:
    import torch
    if exact:
        return torch.equal(got, want)
    fin = torch.isfinite(want)
    tol = 1e-4 + 1e-5 * (q2[:, None] + x2[ids.clamp(0, x2.shape[0] - 1)
                                          .long()])
    return bool(torch.equal(torch.isinf(got), torch.isinf(want))
                and ((got - want).abs()[fin] <= tol[fin]).all())


def base_args(prec: str, x) -> tuple:
    """The corpus side of a tile's arguments: rows, (int8) scales, norms."""
    from repro_torch.core.quantize import quantize_corpus
    if prec == "f32":
        return x, (x * x).sum(1)
    xs = quantize_corpus(x, prec)
    return (xs.data, xs.scale, xs.x2) if prec == "int8" \
        else (xs.data, xs.x2)


def sweep(path: Path, dev, args) -> bool:
    import torch

    from repro_torch.kernels import ops
    saved = torch.load(path)
    x = corpus(dev)
    if abs(float(x.double().sum()) - saved["checksum"]) > 1e-6 * abs(
            saved["checksum"]):
        raise RuntimeError("the corpus differs from the recorded one")
    g = torch.Generator(device=dev).manual_seed(SEED + 7)
    rand = torch.randint(0, N, (512, 120), generator=g, device=dev,
                         dtype=torch.int32)
    ok = True
    for prec in args.precisions.split(","):
        fn = getattr(ops, TILES[prec])
        base = base_args(prec, x)
        calls = saved["tiles"][prec]
        rows = [(f"round {r + 1}", [a.to(dev) for a in c[:-1]],
                 c[-1].to(dev)) for r, c in enumerate(calls)]
        rows.append(("random ids", rows[0][1], rand))
        for label, qa, ids in rows:
            call = lambda b: fn(*qa, *base, ids,  # noqa: E731
                                backend=b)
            good = agrees(call("auto"), call("ref"), qa[-1], base[-1], ids,
                          prec == "int8")
            ok = ok and good
            ms = [time_ms(lambda: call("auto"), args.reps)
                  for _ in range(args.repeats)]
            print(json.dumps({"label": args.label, "precision": prec,
                              "tile": label, **sharing(ids, N),
                              "agrees": good, "ms": ms}), flush=True)
    return ok


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--record", type=Path)
    ap.add_argument("--tiles", type=Path)
    ap.add_argument("--src", default="src")
    ap.add_argument("--label", default="")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--precisions", default=",".join(TILES))
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.src).resolve()))
    import torch
    if not torch.cuda.is_available():
        print("search_sweep: no CUDA card", file=sys.stderr)
        return 1
    from repro_torch.core.device import pin_fp32
    pin_fp32()
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    if args.record:
        record(args.record, dev)
        return 0
    if not args.tiles:
        ap.error("give --record FILE or --tiles FILE")
    return 0 if sweep(args.tiles, dev, args) else 1


if __name__ == "__main__":
    sys.exit(main())
