"""Serving: prefill and single-token decode with batched caches
(src/repro/serve/decode.py), for the dense, MoE, SSM and hybrid families
and internvl2's vision prefix: a prefill of ``{"tokens", "patches"}``
caches the patch positions first (patch 0 at position 0), its
``lengths`` count them, and decode runs on tokens. The encoder (hubert)
has no decode: ``model.forward`` is its entry point.

The cache tree mirrors the parameter stack (``transformer.stacked``):
{"layers": {"k", "v", "kpos"}}, gemma2's {"pairs": {"local": {...},
"global": {...}}}, the MoE stack's {"dense_layers": ..., "layers": ...},
mamba2's {"layers": {"conv", "state"}}, or zamba2's {"segments": {"conv",
"state"}, "shared": {"k", "v", "kpos"}, "tail": {"conv", "state"}}, with
the stack axis in front and batch at axis 1, as in JAX (zamba2's
``segments`` carry two stack axes, (n_seg, attn_every), so batch is at
axis 2; its ``shared`` cache is stacked over the invocations):

  * GQA linear cache  (n, B, max_len, Hkv, Dh) + kpos tags
  * GQA ring cache    (n, B, window,  Hkv, Dh) — local-window layers
    (all-local stacks, gemma2's local half) store only ``window``
    entries, placed at position % window.
  * MLA latent cache  (n, B, max_len, kv_lora_rank) + (n, B, max_len,
    qk_rope_dim) + kpos tags — deepseek-v2's latent and shared rope key
    only, read by the weight-absorbed decode; always linear.
  * SSM cache         conv tail (n, B, K-1, conv_dim) + state (n, B, H,
    P, N) f32: O(1) in the sequence.

``abstract_cache`` gives the cache as "meta" tensors (no storage) and
``cache_shardings`` its NamedShardings on a mesh (models/sharding.py).
``serve_step`` updates the cache IN PLACE and returns it (JAX returns an
updated copy); per-layer loops (``transformer.stack_layers``) take the
place of ``lax.scan``.
"""
from __future__ import annotations

import torch

from repro_torch.core.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.model import embed_inputs, output_logits
from repro_torch.models.params import (
    abstract_tree,
    init_tree,
    sharding_tree,
    tree_map,
)
from repro_torch.models.transformer import (
    apply_norm,
    finish_block,
    shared_lora,
    stack_layers,
    stack_trees,
    stacked,
)


def cache_schema(cfg, batch: int, max_len: int) -> dict:
    def block(window, kind):
        if kind == "mamba":
            return ssm_mod.mamba_cache_schema(cfg, batch)
        if cfg.use_mla:
            return attn.mla_cache_schema(cfg, batch, max_len)
        return attn.gqa_cache_schema(cfg, batch, max_len, window=window)
    return stacked(cfg, block)


def init_cache(cfg, batch: int, max_len: int, device=None) -> dict:
    """An empty cache on ``device`` ("cuda" unless the caller asks for
    another): zeros, and kpos -1 (empty)."""
    device = resolve_device(device, "init_cache")
    return init_tree(torch.Generator(device=device).manual_seed(0),
                     cache_schema(cfg, batch, max_len))


def abstract_cache(cfg, batch: int, max_len: int) -> dict:
    return abstract_tree(cache_schema(cfg, batch, max_len))


def cache_shardings(cfg, batch: int, max_len: int, mesh, rules=None):
    return sharding_tree(cache_schema(cfg, batch, max_len), mesh, rules)


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def _attn_block_decode(p, x, c, lengths, cfg, *, window=None, ffn="dense"):
    h = apply_norm(p["norm1"], x, cfg)
    if cfg.use_mla:
        a, c2 = attn.mla_decode(p["attn"], h, c, lengths, cfg)
    else:
        a, c2 = attn.gqa_decode(p["attn"], h, c, lengths, cfg, window=window)
    return finish_block(p, x, a, cfg, ffn), c2


def _mamba_block_decode(p, x, c, cfg):
    h = apply_norm(p["norm"], x, cfg)
    y, c2 = ssm_mod.mamba_decode(p["mixer"], h, c, cfg)
    return x + cfg.residual_multiplier * y, c2


def _block_decode(p, x, c, lengths, cfg, window, kind):
    if kind == "mamba":
        return _mamba_block_decode(p, x, c, cfg)
    if kind == "shared":
        return _attn_block_decode(p["block"], shared_lora(p, x), c, lengths,
                                  cfg)
    return _attn_block_decode(p, x, c, lengths, cfg, window=window, ffn=kind)


def decode_hidden(params, cache, tokens, lengths, cfg):
    """``serve_step`` up to the output head: (B, 1) tokens at positions
    ``lengths`` (B,) -> (the last layer's hidden state (B, 1, d_model),
    cache), the cache updated in place. The kNN-LM's keys live in this
    space (``run_stack``'s output); ``output_logits`` of it is the step's
    logits."""
    dev = params["embed"]["table"].device
    lengths = torch.as_tensor(lengths, device=dev)
    x = embed_inputs(params, {"tokens": tokens}, cfg)
    for p, c, window, kind in stack_layers(params["stack"], cfg, cache):
        x, _ = _block_decode(p, x, c, lengths, cfg, window, kind)
    return x, cache


def serve_step(params, cache, tokens, lengths, cfg):
    """(B, 1) tokens at positions ``lengths`` (B,) -> (logits (B, vocab)
    fp32, cache), the cache updated in place."""
    x, cache = decode_hidden(params, cache, tokens, lengths, cfg)
    return output_logits(params, x, cfg)[:, 0], cache


# ---------------------------------------------------------------------------
# prefill: full-sequence forward that seeds the cache
# ---------------------------------------------------------------------------

def _seed_gqa(cfg, k, v, max_len, window):
    """A {k, v, kpos} cache from prefill (B, L, Hkv, Dh) tensors."""
    b, seq = k.shape[0], k.shape[1]
    s = min(window, max_len) if window is not None else max_len
    dt = cfg.cache_dtype
    dev = k.device
    kc = torch.zeros((b, s, *k.shape[2:]), dtype=dt, device=dev)
    vc = torch.zeros((b, s, *v.shape[2:]), dtype=dt, device=dev)
    kp = torch.full((b, s), -1, dtype=torch.int32, device=dev)
    if s >= seq:
        kc[:, :seq] = k.to(dt)
        vc[:, :seq] = v.to(dt)
        kp[:, :seq] = torch.arange(seq, dtype=torch.int32, device=dev)
    else:
        # ring: keep the last S positions, placed at their slot pos % S
        pos = torch.arange(seq - s, seq, device=dev)
        slot = pos % s
        kc[:, slot] = k[:, seq - s:].to(dt)
        vc[:, slot] = v[:, seq - s:].to(dt)
        kp[:, slot] = pos.to(torch.int32)
    return {"k": kc, "v": vc, "kpos": kp}


def _seed_mla(cfg, ckv, krope, max_len):
    """A linear {ckv, krope, kpos} cache from prefill (B, L, r) and
    (B, L, dr) tensors."""
    b, seq = ckv.shape[0], ckv.shape[1]
    dt = cfg.cache_dtype
    dev = ckv.device
    ck = torch.zeros((b, max_len, ckv.shape[2]), dtype=dt, device=dev)
    kr = torch.zeros((b, max_len, krope.shape[2]), dtype=dt, device=dev)
    kp = torch.full((b, max_len), -1, dtype=torch.int32, device=dev)
    ck[:, :seq] = ckv.to(dt)
    kr[:, :seq] = krope.to(dt)
    kp[:, :seq] = torch.arange(seq, dtype=torch.int32, device=dev)
    return {"ckv": ck, "krope": kr, "kpos": kp}


def _attn_block_prefill(p, x, cfg, max_len, *, window=None, ffn="dense",
                        backend="auto"):
    h = apply_norm(p["norm1"], x, cfg)
    if cfg.use_mla:
        a, (ckv, krope) = attn.mla_attention(
            p["attn"], h, cfg, triangle=cfg.triangle_schedule,
            return_latent=True, backend=backend)
        c = _seed_mla(cfg, ckv, krope, max_len)
    else:
        a, (k, v) = attn.gqa_attention(p["attn"], h, cfg, window=window,
                                       triangle=cfg.triangle_schedule,
                                       return_kv=True, backend=backend)
        c = _seed_gqa(cfg, k, v, max_len, window)
    return finish_block(p, x, a, cfg, ffn), c


def _mamba_block_prefill(p, x, cfg):
    h = apply_norm(p["norm"], x, cfg)
    y, c = ssm_mod.mamba_block(p["mixer"], h, cfg, return_cache=True)
    return x + cfg.residual_multiplier * y, c


def _block_prefill(p, x, cfg, max_len, window, kind, backend):
    if kind == "mamba":
        return _mamba_block_prefill(p, x, cfg)
    if kind == "shared":
        return _attn_block_prefill(p["block"], shared_lora(p, x), cfg,
                                   max_len, backend=backend)
    return _attn_block_prefill(p, x, cfg, max_len, window=window, ffn=kind,
                               backend=backend)


def prefill(params, batch, cfg, max_len: int, *, last_only: bool = False,
            backend: str = "auto"):
    """Full-sequence prefill. Returns (logits, cache, lengths); logits are
    (B, L, V), or (B, V) for the new-token sampling position when
    ``last_only`` (serving never makes the (B, L, V) tensor). ``backend``
    "ref" runs the plain attention on a card (the kernel's yardstick)."""
    x = embed_inputs(params, batch, cfg)
    b, seq = x.shape[0], x.shape[1]
    caches = []
    for p, _, window, kind in stack_layers(params["stack"], cfg):
        x, c = _block_prefill(p, x, cfg, max_len, window, kind, backend)
        caches.append(c)
    cache = stack_trees(caches, cfg)
    if last_only:
        logits = output_logits(params, x[:, -1:], cfg)[:, 0]
    else:
        logits = output_logits(params, x, cfg)
    lengths = torch.full((b,), seq, dtype=torch.int32, device=x.device)
    return logits, cache, lengths


def write_slot(cache: dict, i: int, one_cache: dict, length: int) -> dict:
    """Copy a one-request cache (batch 1, from ``prefill``) into slot ``i``
    of the batched cache, in place, leaving every other slot as it was.
    Batch is at axis 2 of zamba2's ``segments`` leaves (two stack axes in
    front) and at axis 1 of every other leaf. Returns the cache."""
    for key in cache:
        axis = 2 if key == "segments" else 1
        tree_map(lambda big, one: big.select(axis, i).copy_(
            one.select(axis, 0)), cache[key], one_cache[key])
    return cache
