"""Training launcher CLI (src/repro/launch/train.py).

    CK=$(mktemp -d "${TMPDIR:-/tmp}/ck.XXXX")
    PYTHONPATH=src python -m repro_torch.launch.train --arch yi-6b --smoke \\
        --device cpu --steps 100 --batch 8 --seq 256 --ckpt-dir "$CK" \\
        --resume auto

Wires config -> schema -> parameters -> data pipeline -> train loop with
checkpointing and the fault policy, on the CUDA card unless ``--device``
names another. There are no published weights in the repository: the
parameters are drawn through the schema from a ``torch.Generator``
seeded 0 on the device (JAX's CLI draws from ``key(0)``, which torch
cannot reproduce; ``models.params_from_numpy`` carries JAX's parameters
over where the two must match). Parameters stay in their schema dtype
(fp32), as JAX trains them.
"""
from __future__ import annotations

import argparse
import json

import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.device import resolve_device
from repro_torch.data import DataConfig, TokenPipeline
from repro_torch.models import init_tree, model_schema, param_count
from repro_torch.train import (
    OptimizerConfig,
    TrainConfig,
    TrainLoop,
    make_train_step,
)
from repro_torch.train import optimizer as opt_mod
from repro_torch.train.checkpoint import Checkpointer, config_hash
from repro_torch.train.fault import FaultPolicy, StragglerWatchdog


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", default=None, choices=[None, "auto"])
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    device = resolve_device(args.device, "repro_torch.launch.train")
    print(f"arch={cfg.arch} params={param_count(cfg):,}")

    dc = DataConfig(seq_len=args.seq, global_batch=args.batch,
                    vocab=cfg.vocab)
    pipe = TokenPipeline(dc)

    gen = torch.Generator(device=device).manual_seed(0)
    params = init_tree(gen, model_schema(cfg))
    opt_state = opt_mod.init(params)

    tc = TrainConfig(
        microbatches=args.microbatches,
        opt=OptimizerConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 1),
                            total_steps=args.steps),
    )
    step_fn = make_train_step(cfg, tc)

    ck = None
    fault = None
    start_step = 0
    if args.ckpt_dir:
        ck = Checkpointer(args.ckpt_dir, every=args.ckpt_every,
                          cfg_hash=config_hash(cfg))
        fault = FaultPolicy(ck)
        if args.resume == "auto" and ck.latest_step() is not None:
            start_step, tree = ck.load(
                like={"params": params, "opt_state": opt_state})
            params, opt_state = tree["params"], tree["opt_state"]
            print(f"resumed from step {start_step}")

    dog = StragglerWatchdog()

    def log(m):
        print(json.dumps({k: round(v, 5) if isinstance(v, float) else v
                          for k, v in m.items()}))

    loop = TrainLoop(cfg, tc, step_fn, checkpointer=ck, fault=fault,
                     log_every=args.log_every)

    def batches():
        n = 0
        for b in pipe:
            if n >= args.steps - start_step:
                return
            dog.step_start()
            yield b
            n += 1

    params, opt_state, hist = loop.run(
        params, opt_state, batches(), start_step=start_step, callback=log)
    print(f"done: {len(hist)} logs, final loss "
          f"{hist[-1]['loss'] if hist else float('nan'):.4f}")
    return params, opt_state, hist


if __name__ == "__main__":
    main()
