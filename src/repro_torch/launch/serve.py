"""Serving launcher CLI: continuous-batched decode over seeded weights,
with an optional kNN-LM datastore built over the port's graph
(src/repro/launch/serve.py).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b \\
        --smoke --device cpu --requests 8 --max-new 16 --knn

``--arch`` is any registered architecture: of the dense family yi-6b,
gemma2-27b (local / global layer pairs: a ring cache of ``window`` slots
on each local layer, a linear one of ``--max-len`` on each global one),
starcoder2-3b (a ring cache on every layer) or codeqwen1.5-7b; of the
MoE family deepseek-v2-lite-16b (MLA: a latent cache of 512 + 64 values
a token and layer, read by the weight-absorbed decode; one dense layer,
then 64 routed experts top-6 with 2 shared ones) or granite-moe-3b-a800m
(GQA, 40 experts top-8, renormalised gates); of the SSM / hybrid family
mamba2-130m (24 Mamba-2 layers, attention-free: a conv tail and an f32
state a layer, O(1) in the sequence) or zamba2-1.2b (38 Mamba-2 layers in
segments of 6, each followed by one shared attention + GLU block with a
per-invocation LoRA delta, whose 6 invocations keep linear KV caches of
``--max-len``); of the vision front end internvl2-1b, on text-only
prompts (a ``Request`` carries no patches, as in the JAX CLI; a prefill
with patches is ``serve.decode.prefill``'s). The encoder-only
hubert-xlarge has no decode and is refused, as the JAX CLI refuses it.

Runs on the CUDA card unless ``--device`` names another. There are no
published weights in the repository, so the parameters are drawn from
seed 0 (as the JAX CLI's ``key(0)``) through the schema and their
matrices cast once to the activation dtype
(``models.params.cast_matrices``). ``serve_requests`` is
the code path the CLI and ``chip_smoke.py`` share.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.device import resolve_device
from repro_torch.models import cast_matrices, init_tree, model_schema
from repro_torch.serve import (
    ContinuousBatcher,
    KNNDatastore,
    Request,
    init_cache,
    prefill,
    serve_step,
    write_slot,
)


def load_params(cfg, device) -> dict:
    """Parameters drawn from seed 0 on ``device``, matrices in the
    activation dtype."""
    schema = model_schema(cfg)
    gen = torch.Generator(device=device).manual_seed(0)
    return cast_matrices(init_tree(gen, schema), schema, cfg.act_dtype)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve_requests(params, cfg, prompts, *, slots: int, max_len: int,
                   max_new: int) -> tuple[list, dict]:
    """Serve ``prompts`` (a list of (L,) int32 arrays, all submitted at
    once) through a ``ContinuousBatcher`` of ``slots`` decode slots over a
    ``max_len`` cache on the parameters' device. Returns the requests and
    the run's stats: wall time, prefill seconds and time to first token per
    request (in admission order, which is submission order here), decode
    steps, seconds and tokens per second, and peak device memory on a
    card (None elsewhere). Host clocks, each read after a device
    synchronise."""
    dev = params["embed"]["table"].device
    prefill_s, first_at, step_s = [], [], []

    def prefill_fn(prompt):
        _sync(dev)
        t0 = time.perf_counter()
        logits, one, _ = prefill(
            params, {"tokens": torch.from_numpy(prompt).to(dev)}, cfg,
            max_len, last_only=True)
        _sync(dev)
        t1 = time.perf_counter()
        prefill_s.append(t1 - t0)
        first_at.append(t1)
        return logits, one, prompt.shape[1]

    def step_fn(cache, tokens, lengths):
        t0 = time.perf_counter()
        logits, cache = serve_step(params, cache, tokens.to(dev),
                                   lengths.to(dev), cfg)
        _sync(dev)
        step_s.append(time.perf_counter() - t0)
        return logits, cache

    reqs = [Request(rid=i, prompt=np.asarray(p, np.int32), max_new=max_new)
            for i, p in enumerate(prompts)]
    bat = ContinuousBatcher(slots, step_fn, prefill_fn, write_slot)
    for r in reqs:
        bat.submit(r)
    cache = init_cache(cfg, slots, max_len, device=dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    _sync(dev)
    t0 = time.perf_counter()
    bat.run(cache)
    _sync(dev)
    wall = time.perf_counter() - t0
    decode_tokens = sum(len(r.out) - 1 for r in reqs)
    decode_s = sum(step_s)
    stats = {
        "requests": len(reqs),
        "tokens": sum(len(r.out) for r in reqs),
        "wall_s": wall,
        "prefill_s": prefill_s,
        "ttft_s": [t - t0 for t in first_at],
        "decode_steps": bat.steps,
        "decode_s": decode_s,
        "decode_tokens": decode_tokens,
        "decode_tokens_per_s": decode_tokens / decode_s if decode_s else None,
        "max_memory_allocated": (torch.cuda.max_memory_allocated(dev)
                                 if dev.type == "cuda" else None),
    }
    return reqs, stats


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--knn", action="store_true")
    ap.add_argument("--knn-lambda", type=float, default=0.25,
                    help="parsed as the JAX CLI does; the sampler is "
                         "greedy over the LM logits in both")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if cfg.encoder_only:
        raise SystemExit(f"{cfg.arch} is encoder-only: no decode serving")
    device = resolve_device(args.device, "repro_torch.launch.serve")
    params = load_params(cfg, device)

    if args.knn:
        n = 2048
        gen = torch.Generator(device=device).manual_seed(7)
        keys = torch.randn((n, cfg.d_model), generator=gen, device=device)
        vals = torch.randint(0, cfg.vocab, (n,), generator=gen,
                             device=device)
        ds = KNNDatastore.build(keys, vals, k=8, device=device)
        print(f"knn datastore built: {ds.build_stats}")

    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, cfg.vocab, size=args.prompt_len)
               .astype(np.int32) for _ in range(args.requests)]
    _, stats = serve_requests(params, cfg, prompts, slots=args.slots,
                              max_len=args.max_len, max_new=args.max_new)
    dt = stats["wall_s"]
    total_toks = args.requests * args.max_new
    print(f"served {args.requests} requests, {total_toks} tokens in "
          f"{dt:.2f}s ({total_toks/dt:.1f} tok/s), "
          f"{stats['decode_steps']} decode steps")
    return stats


if __name__ == "__main__":
    main()
