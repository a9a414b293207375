"""Dry-run (src/repro/launch/dryrun.py): count every (arch x shape x mesh)
cell on the production mesh with "meta" tensors (no storage, nothing
computed, no card), and reckon its roofline on the H100.

JAX lowers and compiles each cell on 512 forced host devices and reads
XLA's HLO. The port has no HLO: it runs the cell's entry point on "meta"
under the op-level cost counter (``launch/op_cost.py``), whose kernel
calls charge their kernels' formulas (``kernels/ops.py``): the count a
cell gives on "meta" is the count the same call gives on the card.

Loop-awareness, the counterpart of ``hlo_cost``'s trip counts, keeps
full-size cells affordable: repeated identical work is counted once and
multiplied.

  * depth: the config cut to one, two and three repeats of the segment
    it repeats (the uniform stack's layers, gemma2's local / global
    pairs, the MoE stack's MoE layers after its first-k dense ones,
    zamba2's segments of 6 mamba layers and the shared block, its tail
    kept) is counted, and the count extrapolated to its depth along the
    quadratic through the three (``extrapolate`` says why a train step's
    is not linear); exact wherever the cost is that polynomial of the
    depth (the tests hold it to the full count on smoke configs), which
    the optimizer's grad-norm pieces of 2^26 elements break by a few
    bytes a piece at full size;
  * the train step's microbatches and its data groups' cuts of each:
    the FSDP step (train/loop.py) runs its pieces through
    ``core.cost.repeated``, which counts the first of a shape and replays
    it.

A record has JAX's keys: kind, memory, roofline, collectives, params,
active_params, chips, status, compile_s (the seconds the count took).
XLA's ``xla_cost_analysis_raw`` has no counterpart. Memory a chip:
``resident_bytes`` is the largest shard's arguments plus outputs less
the donated ones, exact from the shard shapes; ``peak_bytes`` adds the
live-bytes tracker's peak (an estimate), ``fits_80g`` and
``fits_80g_resident`` hold them to the card's 80 GB. The roofline's
flops and bytes a chip are the counted work over the chips: the port
runs the mesh's logical shards on one device, each data group's cut
whole, so this is an even split it does not realise itself.

The paper's workload is the pseudo-arch ``knn-build``: one sharded
NN-Descent iteration (``make_sharded_iteration``, the mesh flattened
into one ``data`` axis, as JAX's ``make_sharded_iteration_lowerable``
does). Its compactions have data-dependent shapes and it syncs, so it
cannot run on "meta": it runs on a real device, the card unless
``--device`` names another, and the record says which.

Usage (records under results/dryrun_torch/):
  python -m repro_torch.launch.dryrun --arch yi-6b --shape train_4k
  python -m repro_torch.launch.dryrun --arch yi-6b --shape decode_32k --multi-pod
  python -m repro_torch.launch.dryrun --sweep --out results/dryrun_torch
  python -m repro_torch.launch.dryrun --arch knn-build --shape knn_1m_256 \
      --knn-n 131072

One card does not hold a knn-build cell at its full n (its 256 or 512
logical shards' buffers on one device): ``--knn-n`` cuts the corpus,
and the record's ``reduced``, its summary line and the report say so.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from repro_torch.configs import (
    SHAPES,
    batch_specs,
    get_config,
    input_specs,
    list_archs,
)
from repro_torch.launch import op_cost
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.report import cut_note
from repro_torch.launch.roofline import (
    HBM_PER_CHIP,
    model_flops_step,
    roofline_from_cost,
)
from repro_torch.models import (
    abstract_tree,
    active_param_count,
    device_put,
    logical_sharding,
    model_schema,
    param_count,
    sharding_tree,
)
from repro_torch.models.params import tree_leaves, tree_map
from repro_torch.serve import decode as serve_decode
from repro_torch.train import TrainConfig, make_train_step
from repro_torch.train import optimizer as opt_mod

KNN_SHAPES = {
    # (n points, dim, k): paper-representative K-NN graph builds
    "knn_1m_256": (1 << 20, 256, 20),
    "knn_16m_64": (1 << 24, 64, 20),
}
OUT_DIR = "results/dryrun_torch"


def _serve_cfg(cfg):
    """Inference deployments run bf16 params (halves HBM)."""
    return dataclasses.replace(cfg, param_dtype=torch.bfloat16)


def _train_cfg(cfg):
    return dataclasses.replace(cfg, remat="full")


def _shape(shape):
    return SHAPES[shape] if isinstance(shape, str) else shape


# ---------------------------------------------------------------------------
# depth: count one, two and three repeats, extrapolate
# ---------------------------------------------------------------------------

def depth_cut(cfg):
    """(repeats, cut): the repeats of the segment the dry-run varies, and
    ``cut(r)``, the config with ``r`` of them (the rest of the stack
    kept)."""
    if cfg.family == "hybrid":
        rem = cfg.n_layers % cfg.attn_every
        reps, layers = cfg.n_layers // cfg.attn_every, \
            lambda r: r * cfg.attn_every + rem
    elif cfg.family == "moe" or cfg.n_experts:
        k = cfg.first_k_dense
        reps, layers = cfg.n_layers - k, lambda r: k + r
    elif cfg.layer_pattern == "local_global":
        reps, layers = cfg.n_layers // 2, lambda r: 2 * r
    else:
        reps, layers = cfg.n_layers, lambda r: r
    return reps, lambda r: dataclasses.replace(cfg, n_layers=layers(r))


def extrapolate(c1: op_cost.Cost, c2: op_cost.Cost, c3: op_cost.Cost,
                reps: int):
    """C(reps) from the counts at one, two and three repeats, as the
    quadratic through them: C(1) + (reps - 1) D1 + (reps - 1)(reps - 2)/2
    D2, D1 = C(2) - C(1), D2 = C(3) - 2 C(2) + C(1), exact in integers.
    Forward and serving costs are linear in the depth (D2 = 0); a train
    step's are not: each layer's view of a stacked parameter has a
    backward (``SelectBackward``) that writes a zero tensor of the whole
    stack and the engine adds it into the stack's gradient, bytes that
    grow with the depth at every layer. The peak follows the same
    polynomial (an estimate)."""
    a, b = reps - 1, (reps - 1) * (reps - 2) // 2
    out = c1.copy()
    for c, w in ((c2, a - 2 * b), (c1, -a + b), (c3, b)):
        out.add(c, w)
    out.peak_bytes = (c1.peak_bytes + a * (c2.peak_bytes - c1.peak_bytes)
                      + b * (c3.peak_bytes - 2 * c2.peak_bytes
                             + c1.peak_bytes))
    return out


def count_depth(cfg, count, *, full: bool = False):
    """``count(cfg)`` at the config's depth: directly when ``full`` or
    when it repeats its segment three times or less, else extrapolated
    from the cuts to one, two and three repeats. Returns (cost, depth
    fields)."""
    reps, cut = depth_cut(cfg)
    if full or reps <= 3:
        return count(cfg), {"repeats": reps, "extrapolated": False}
    return extrapolate(count(cut(1)), count(cut(2)), count(cut(3)), reps), {
        "repeats": reps, "extrapolated": True,
        "counted_layers": [cut(r).n_layers for r in (1, 2, 3)]}


# ---------------------------------------------------------------------------
# the counts of the three kinds of cell
# ---------------------------------------------------------------------------

def _placed(tree, shardings):
    return tree_map(device_put, tree, shardings)


def count_train(cfg, shape, mesh, microbatches: int) -> op_cost.Cost:
    """One train step of ``cfg`` at ``shape``: FSDP over ``mesh`` (None:
    the unsharded step), on meta tensors."""
    s = _shape(shape)
    schema = model_schema(cfg)
    params = abstract_tree(schema)
    batch = input_specs(cfg, s)
    if mesh is not None:
        params = _placed(params, sharding_tree(schema, mesh))
        batch = _placed(batch, batch_specs(cfg, s, mesh))
        state = opt_mod.init(params)
    else:
        state = opt_mod.abstract_init(params)
    step = make_train_step(cfg, TrainConfig(microbatches=microbatches))
    return op_cost.analyze(step, params, state, batch)


def count_prefill(cfg, shape) -> op_cost.Cost:
    s = _shape(shape)
    params = abstract_tree(model_schema(cfg))
    batch = input_specs(cfg, s)
    return op_cost.analyze(lambda: serve_decode.prefill(
        params, batch, cfg, s.seq_len, last_only=True))


def count_decode(cfg, shape) -> op_cost.Cost:
    s = _shape(shape)
    params = abstract_tree(model_schema(cfg))
    cache = serve_decode.abstract_cache(cfg, s.global_batch, s.seq_len)
    batch = input_specs(cfg, s)
    return op_cost.analyze(serve_decode.serve_step, params, cache,
                           batch["tokens"], batch["lengths"], cfg)


# ---------------------------------------------------------------------------
# memory a chip, from the shard shapes
# ---------------------------------------------------------------------------

def shard_bytes(tree, shardings) -> int:
    """Bytes of one shard of every leaf of ``tree`` (tensors or shapes'
    stand-ins) placed by ``shardings``: what each mesh position holds."""
    return sum(int(np.prod(sh.shard_shape(t.shape))) * t.element_size()
               for t, sh in zip(tree_leaves(tree), tree_leaves(shardings)))


def _batched(mesh, shape, dtype, logical):
    """Bytes a shard of an output of ``shape`` placed by ``logical``."""
    t = torch.empty(shape, dtype=dtype, device="meta")
    return shard_bytes(t, logical_sharding(logical, mesh, dims=shape))


def _groups(sharding, shape) -> int:
    """The row blocks a sharding cuts axis 0 of ``shape`` into."""
    return shape[0] // sharding.shard_shape(shape)[0]


def memory(args: int, outputs: int, alias: int, cost: op_cost.Cost,
           groups: int) -> dict:
    """JAX's memory fields a chip. ``temp_bytes``: the live-bytes
    tracker's peak of the storages the counted call made, over
    ``groups``, the data groups whose work one counted call ran whole
    (an estimate, where JAX's is the compiler's buffer assignment);
    ``allocator_peak_bytes``: the arguments plus it; the conservative
    peak (``upper_bytes``, the report's) adds it to the resident bytes,
    the outputs held beside every temporary."""
    resident = args + outputs - alias
    temp = cost.peak_bytes // groups
    mem = {
        "argument_bytes": args,
        "output_bytes": outputs,
        "temp_bytes": temp,
        "alias_bytes": alias,
        "allocator_peak_bytes": args + temp,
        "resident_bytes": resident,
        "conservative_peak_bytes": resident + temp,
        "upper_bytes": resident + temp,
        "peak_bytes": max(args + temp, resident),
        "peak_is_estimate": True,
    }
    mem["fits_80g"] = mem["peak_bytes"] <= HBM_PER_CHIP
    mem["fits_80g_resident"] = resident <= HBM_PER_CHIP
    return mem


def _finish(cost, chips: int, kind: str, model_flops: float,
            mem: dict) -> dict:
    rl = roofline_from_cost(cost, chips, model_flops)
    return {
        "kind": kind, "memory": mem, "roofline": rl.as_dict(),
        "collectives": {
            "counts": dict(cost.coll_counts),
            "bytes": dict(cost.coll_bytes_by_kind),
            "total_bytes": cost.coll_bytes,
            "dcn_bytes": cost.dcn_bytes,
        },
        "counter": {k: v for k, v in cost.totals().items()
                    if k in ("flops", "bytes", "flops_by_dtype", "ops",
                             "kernels", "peak_bytes", "alloc_bytes")},
    }


# ---------------------------------------------------------------------------
# the cells
# ---------------------------------------------------------------------------

def _lower_train(cfg, shape, mesh, microbatches):
    cfg = _train_cfg(cfg)
    s = _shape(shape)
    cost, depth = count_depth(
        cfg, lambda c: count_train(c, s, mesh, microbatches))
    schema = model_schema(cfg)
    params = abstract_tree(schema)
    p_bytes = shard_bytes(params, sharding_tree(schema, mesh))
    batch = input_specs(cfg, s)
    b_bytes = shard_bytes(batch, batch_specs(cfg, s, mesh))
    state = 2 * p_bytes + 4                  # m, v like params; step
    rec = _finish(cost, mesh.size, "train", model_flops_step(
        "train", cfg, s.seq_len, s.global_batch, active_param_count(cfg)),
        memory(p_bytes + state + b_bytes, p_bytes + state, p_bytes + state,
               cost, 1))
    rec["microbatches"] = microbatches
    rec["depth"] = depth
    return rec


def _lower_prefill(cfg, shape, mesh):
    cfg = _serve_cfg(cfg)
    s = _shape(shape)
    B, S = s.global_batch, s.seq_len
    cost, depth = count_depth(cfg, lambda c: count_prefill(c, s))
    schema = model_schema(cfg)
    args = shard_bytes(abstract_tree(schema), sharding_tree(schema, mesh))
    bsp = batch_specs(cfg, s, mesh)
    batch = input_specs(cfg, s)
    args += shard_bytes(batch, bsp)
    out = shard_bytes(serve_decode.abstract_cache(cfg, B, S),
                      serve_decode.cache_shardings(cfg, B, S, mesh))
    out += _batched(mesh, (B, cfg.vocab), torch.float32, ("batch", "vocab"))
    out += _batched(mesh, (B,), torch.int32, ("batch",))
    first = next(iter(batch))
    rec = _finish(cost, mesh.size, "prefill", model_flops_step(
        "prefill", cfg, S, B, active_param_count(cfg)),
        memory(args, out, 0, cost,
               _groups(bsp[first], tuple(batch[first].shape))))
    rec["depth"] = depth
    return rec


def _lower_decode(cfg, shape, mesh):
    cfg = _serve_cfg(cfg)
    s = _shape(shape)
    B, S = s.global_batch, s.seq_len
    cost, depth = count_depth(cfg, lambda c: count_decode(c, s))
    schema = model_schema(cfg)
    p_bytes = shard_bytes(abstract_tree(schema), sharding_tree(schema, mesh))
    c_bytes = shard_bytes(serve_decode.abstract_cache(cfg, B, S),
                          serve_decode.cache_shardings(cfg, B, S, mesh))
    bsp = batch_specs(cfg, s, mesh)
    batch = input_specs(cfg, s)
    args = p_bytes + c_bytes + shard_bytes(batch, bsp)
    out = c_bytes + _batched(mesh, (B, cfg.vocab), torch.float32,
                             ("batch", "vocab"))
    rec = _finish(cost, mesh.size, "decode", model_flops_step(
        "decode", cfg, S, B, active_param_count(cfg)),
        memory(args, out, c_bytes, cost,
               _groups(bsp["tokens"], tuple(batch["tokens"].shape))))
    rec["depth"] = depth
    return rec


def knn_inputs(mesh, n: int, d: int, k: int, *, seed: int = 0):
    """A corpus (n, d) drawn from ``seed`` on the mesh's device and its
    random initial lists (n, k), as the sharded build makes them."""
    from repro_torch.core.distributed import _init_lists, _lists_on
    dev = mesh.devices[0]
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((n, d), generator=g, device=dev)
    xs = [b.contiguous() for b in mesh.split(x)]
    lists = _init_lists(mesh, xs, [(b * b).sum(1) for b in xs], k, seed,
                        None)
    return x, _lists_on(mesh, lists)


def _lower_knn_cell(shape, multi_pod: bool, *, device="cuda", n=None,
                    shards=None, fetch="a2a"):
    """One sharded NN-Descent iteration over the production mesh's chips
    flattened into one ``data`` axis (``shards`` of them unless given),
    on ``device``; ``n`` cuts the corpus."""
    from repro_torch.core.distributed import ShardMesh, make_sharded_iteration
    if torch.device(device).type == "meta":
        raise ValueError("the knn-build cells cannot run on meta: the "
                         "iteration's compactions have shapes that depend "
                         "on the data, and it syncs; give a real device "
                         "(--device cuda, or cpu at a small n)")
    n_full, d, k = KNN_SHAPES[shape]
    n = n or n_full
    chips = 512 if multi_pod else 256
    P = shards or chips
    mesh = ShardMesh.on(P, device=device)
    step, model_flops = make_sharded_iteration(mesh, n=n, d=d, k=k,
                                               fetch=fetch)
    x, nl = knn_inputs(mesh, n, d, k)
    cost = op_cost.analyze(step, x, nl)
    if multi_pod:
        # every group spans all P shards of both pods
        cost.dcn_bytes = cost.coll_bytes
    rows = n // P
    args = rows * d * 4 + rows * k * 9       # x block, lists (f32, i32, bool)
    # per chip: the P shards' work, run on one device, over P
    rec = _finish(cost, P, "knn", model_flops, memory(
        args, rows * k * 9, 0, cost, P))
    rec.update(device=str(mesh.devices[0]), n=n, d=d, k=k, shards=P,
               fetch=fetch, reduced={"n": [n_full, n]} if n != n_full
               else {}, mesh_chips=chips)
    return rec


def lower_cell(arch: str, shape: str, multi_pod: bool, *,
               microbatches: int = 4, extra_cfg: dict | None = None,
               device="cuda", knn_n=None, knn_shards=None):
    """Count one cell; returns the result record dict. The LM cells run
    on "meta"; ``device`` is the knn-build cells' (the card unless named;
    ``knn_n`` / ``knn_shards`` cut their corpus and shard count)."""
    t0 = time.time()
    mesh_kind = "multi" if multi_pod else "single"
    if arch == "knn-build":
        rec = _lower_knn_cell(shape, multi_pod, device=device, n=knn_n,
                              shards=knn_shards)
        chips = rec.pop("mesh_chips")
    else:
        cfg = get_config(arch)
        if extra_cfg:
            cfg = dataclasses.replace(cfg, **extra_cfg)
        if not cfg.supports(shape):
            reason = cfg.skip_reason(shape)
            return {"arch": arch, "shape": shape, "mesh": mesh_kind,
                    "status": "skip", "reason": reason,
                    "skip_reason": reason}
        mesh = make_production_mesh(multi_pod=multi_pod, device="meta")
        chips = mesh.size
        kind = SHAPES[shape].kind
        if kind == "train":
            rec = _lower_train(cfg, shape, mesh, microbatches)
        elif kind == "prefill":
            rec = _lower_prefill(cfg, shape, mesh)
        else:
            rec = _lower_decode(cfg, shape, mesh)
        rec["params"] = param_count(cfg)
        rec["active_params"] = active_param_count(cfg)
        rec["device"] = "meta"
    rec.update({
        "arch": arch, "shape": shape, "mesh": mesh_kind,
        "chips": chips, "status": "ok",
        "compile_s": round(time.time() - t0, 1),
    })
    return rec


def _print_rec(rec):
    print(json.dumps(rec, indent=2, default=str))
    if rec.get("status") == "ok":
        print(summary_line(rec), file=sys.stderr)


def summary_line(rec) -> str:
    r = rec["roofline"]
    m = rec["memory"]
    return (f"[{rec['arch']} x {rec['shape']}{cut_note(rec)} x "
            f"{rec['mesh']}] "
            f"bottleneck={r['bottleneck']} "
            f"t=(c {r['t_compute_s']:.2e}, m {r['t_memory_s']:.2e}, "
            f"coll {r['t_collective_s']:.2e})s "
            f"useful={r['useful_flops_ratio']:.2f} "
            f"roofline_frac={r['roofline_fraction']:.3f} "
            f"peak_mem={m['peak_bytes']/2**30:.2f}GiB "
            f"fits80G={m['fits_80g']}")


def all_cells():
    cells = []
    for arch in list_archs():
        for shape in SHAPES:
            cells.append((arch, shape))
    for shape in KNN_SHAPES:
        cells.append(("knn-build", shape))
    return cells


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--microbatches", type=int, default=4)
    ap.add_argument("--timeout", type=int, default=1800)
    ap.add_argument("--device", default="cuda",
                    help="the knn-build cells' device (the LM cells run "
                         "on meta)")
    ap.add_argument("--knn-n", type=int, default=None,
                    help="cut a knn-build cell's corpus to this many rows "
                         "(one card does not hold a full cell's 256 "
                         "logical shards)")
    args = ap.parse_args()

    if args.sweep:
        outdir = args.out or OUT_DIR
        os.makedirs(outdir, exist_ok=True)
        for arch, shape in all_cells():
            for mesh_kind in ("single", "multi"):
                path = os.path.join(outdir,
                                    f"{arch}__{shape}__{mesh_kind}.json")
                if os.path.exists(path):
                    continue
                cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                       "--arch", arch, "--shape", shape, "--out", path,
                       "--microbatches", str(args.microbatches),
                       "--device", args.device]
                if args.knn_n:
                    cmd += ["--knn-n", str(args.knn_n)]
                if mesh_kind == "multi":
                    cmd.append("--multi-pod")
                print(f"=== {arch} x {shape} x {mesh_kind}", flush=True)
                try:
                    rc = subprocess.run(cmd, timeout=args.timeout).returncode
                except subprocess.TimeoutExpired:
                    rc = "timeout"
                if rc:
                    with open(path, "w") as f:
                        json.dump({"arch": arch, "shape": shape,
                                   "mesh": mesh_kind, "status": "error",
                                   "returncode": rc}, f)
        return

    rec = lower_cell(args.arch, args.shape, args.multi_pod,
                     microbatches=args.microbatches, device=args.device,
                     knn_n=args.knn_n)
    _print_rec(rec)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rec, f, indent=2, default=str)


if __name__ == "__main__":
    main()
