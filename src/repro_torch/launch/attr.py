"""Byte attribution (src/repro/launch/attr.py): which sites dominate the
memory term of a ``perf`` variant, from the op-level counter's per-site
tallies (launch/op_cost.py) in place of JAX's HLO op sites. A site is
the port's function that issued the op (``backward:<node>`` in the
autograd engine); its multiplier is how many ops it ran, the dry-run's
replayed pieces and extrapolated layers included.

    PYTHONPATH=src python -m repro_torch.launch.attr --cell mamba --variant baseline
    PYTHONPATH=src python -m repro_torch.launch.attr --cell knn --variant a2a --knn-n 131072
"""
from __future__ import annotations

import argparse

from repro_torch.launch import dryrun


def attribute(cost, top: int = 25) -> list:
    """The ``top`` sites by bytes: (bytes, site, ops, flops)."""
    rows = [(b, site, n, f) for site, (f, b, n) in cost.sites.items()
            if b > 0]
    rows.sort(reverse=True)
    return rows[:top]


def capture(variant) -> object:
    """Run ``variant`` (a callable that makes a dry-run record, as a
    ``perf`` variant) and return the cost its record was made from."""
    captured = {}
    orig = dryrun._finish

    def keep(cost, *args, **kwargs):
        captured["cost"] = cost
        return orig(cost, *args, **kwargs)

    dryrun._finish = keep
    try:
        variant()
    finally:
        dryrun._finish = orig
    return captured["cost"]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", required=True)
    ap.add_argument("--variant", required=True)
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--device", default="cuda",
                    help="the knn cell's device (the LM cells run on meta)")
    ap.add_argument("--knn-n", type=int, default=None,
                    help="cut the knn cell's corpus to this many rows")
    args = ap.parse_args()
    from repro_torch.launch import perf
    cost = capture(lambda: perf.run(args.cell, args.variant, args.device,
                                    args.knn_n))
    rows = attribute(cost, args.top)
    tot = sum(r[0] for r in rows)
    print(f"top-{args.top} byte sites (sum {tot:.3e} of {cost.bytes:.3e}):")
    for b, site, n, f in rows:
        print(f"{b:10.3e}  x{n:<8d} {site[:80]}  flops {f:.3e}")


if __name__ == "__main__":
    main()
