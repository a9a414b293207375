"""Block composition and the layer stacks (src/repro/models/transformer.py):
the uniform stack (every layer one attention block, global or
all-``local`` sliding window, under ``{"layers": ...}``), gemma2's
local/global alternation (``{"pairs": {"local", "global"}}``, a local
layer of ``cfg.window`` then a global one), the MoE stack
(``{"dense_layers": ...}``, ``first_k_dense`` layers with a dense FFN of
``dense_d_ff``, then ``{"layers": ...}`` with the MoE FFN; granite has no
dense layers, so no ``dense_layers`` key), mamba2's stack of Mamba-2
blocks (``{"layers": ...}``), and zamba2's hybrid: segments of
``attn_every`` mamba layers (``{"segments": ...}``, two stack axes), each
followed by ONE shared attention + GLU block (``{"shared": {"block",
"lora_a", "lora_b"}}``: the block's weights are the same at every
invocation, its LoRA delta is indexed by the invocation), then a mamba
tail (``{"tail": ...}``) when ``attn_every`` does not divide
``n_layers``. Attention is MLA where ``cfg.use_mla`` (deepseek-v2), else
GQA, bidirectional in the encoder (hubert: ``cfg.encoder_only``); the
audio and vision front ends run the uniform stack behind their
embeddings (``model.embed_inputs``). Parameters keep JAX's leading
``stack`` axes and tree paths; a Python loop over the layers
(``stack_layers``) takes the place of ``lax.scan`` (the port runs
eagerly, so there is nothing to keep small). Under autograd,
``cfg.remat`` rematerialises each layer as JAX's ``_remat`` does each
scan body: "full" keeps only a layer's inputs (``torch.utils.checkpoint``),
"dots" also keeps its unbatched matrix products' outputs (selective
checkpointing, JAX's ``checkpoint_dots_with_no_batch_dims``).
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (
    glu,
    glu_schema,
    layernorm,
    layernorm_schema,
    mlp,
    mlp_schema,
    rmsnorm,
    rmsnorm_schema,
)
from repro_torch.models.params import ParamDef, tree_map

# ---------------------------------------------------------------------------
# schema utilities
# ---------------------------------------------------------------------------

def stack_schema(schema, n: int):
    """Prepend a layer ('stack') axis to every ParamDef leaf."""
    return tree_map(
        lambda d: ParamDef((n, *d.shape), ("stack", *d.logical), d.init,
                           d.scale, d.dtype),
        schema)


def layer(stacked: dict, i: int) -> dict:
    """Layer ``i`` of a stacked tree (views, no copy)."""
    return tree_map(lambda t: t[i], stacked)


def norm_schema(cfg):
    if cfg.norm == "layernorm":
        return layernorm_schema(cfg.d_model, cfg.param_dtype)
    return rmsnorm_schema(cfg.d_model, cfg.param_dtype)


def apply_norm(p, x, cfg):
    if cfg.norm == "layernorm":
        return layernorm(p, x, eps=cfg.norm_eps)
    return rmsnorm(p, x, eps=cfg.norm_eps,
                   scale_plus_one=cfg.norm_scale_plus_one)


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def ffn_schema(cfg, *, d_ff: int | None = None):
    f = d_ff or cfg.d_ff
    if cfg.mlp_type == "mlp":
        return mlp_schema(cfg.d_model, f, bias=cfg.mlp_bias,
                          dtype=cfg.param_dtype)
    return glu_schema(cfg.d_model, f, dtype=cfg.param_dtype)


def apply_ffn(p, x, cfg):
    if cfg.mlp_type == "mlp":
        return mlp(p, x, act=cfg.act)
    return glu(p, x, act=cfg.act)


def attn_block_schema(cfg, *, ffn: str = "dense"):
    """One attention block: MLA or GQA, and the FFN ``ffn`` ("dense",
    "dense_first": the first-k-dense width ``dense_d_ff``, or "moe")."""
    s = {
        "norm1": norm_schema(cfg),
        "attn": attn.mla_schema(cfg) if cfg.use_mla else attn.gqa_schema(cfg),
        "norm2": norm_schema(cfg),
    }
    if ffn == "moe":
        s["ffn"] = moe_mod.moe_schema(cfg)
    elif ffn == "dense_first":
        s["ffn"] = ffn_schema(cfg, d_ff=cfg.dense_d_ff)
    else:
        s["ffn"] = ffn_schema(cfg)
    if cfg.post_norms:
        s["norm_post_attn"] = norm_schema(cfg)
        s["norm_post_ffn"] = norm_schema(cfg)
    return s


def finish_block(p, x, a, cfg, ffn: str = "dense"):
    """An attention block after its attention output ``a``: the post-norm,
    the residual, then the FFN half, MoE or dense (the dense ones differ
    only in their width, which the parameters carry). Prefill and decode
    share it."""
    if cfg.post_norms:
        a = apply_norm(p["norm_post_attn"], a, cfg)
    x = x + cfg.residual_multiplier * a
    h = apply_norm(p["norm2"], x, cfg)
    m = moe_mod.moe_ffn(p["ffn"], h, cfg) if ffn == "moe" \
        else apply_ffn(p["ffn"], h, cfg)
    if cfg.post_norms:
        m = apply_norm(p["norm_post_ffn"], m, cfg)
    return x + cfg.residual_multiplier * m


def attn_block(p, x, cfg, *, window=None, encoder=False, ffn="dense",
               positions=None, backend="auto"):
    h = apply_norm(p["norm1"], x, cfg)
    if cfg.use_mla:
        a = attn.mla_attention(p["attn"], h, cfg, positions=positions,
                               triangle=cfg.triangle_schedule,
                               backend=backend)
    else:
        a = attn.gqa_attention(p["attn"], h, cfg, window=window,
                               positions=positions, encoder=encoder,
                               triangle=cfg.triangle_schedule,
                               backend=backend)
    return finish_block(p, x, a, cfg, ffn)


def mamba_block_schema(cfg):
    return {"norm": norm_schema(cfg), "mixer": ssm_mod.mamba_schema(cfg)}


def mamba_block(p, x, cfg):
    h = apply_norm(p["norm"], x, cfg)
    return x + cfg.residual_multiplier * ssm_mod.mamba_block(
        p["mixer"], h, cfg)


# --- zamba2's shared block: GQA attention + GLU with per-invocation LoRA

def shared_block_schema(cfg):
    d, r = cfg.d_model, cfg.shared_lora_rank
    n_inv = cfg.n_layers // cfg.attn_every
    dt = cfg.param_dtype
    return {
        "block": attn_block_schema(cfg),
        # per-invocation LoRA deltas on the block's input (stacked over
        # the invocations)
        "lora_a": ParamDef((n_inv, d, r), ("stack", "d_model", "lora"),
                           dtype=dt, scale=0.02),
        "lora_b": ParamDef((n_inv, r, d), ("stack", "lora", "d_model"),
                           "zeros", dtype=dt),
    }


def shared_lora(p, x):
    """The invocation's LoRA delta added to the shared block's input;
    ``p`` is one invocation's view (``stack_layers``). Prefill, decode and
    ``run_stack`` apply it before the block."""
    return x + (x @ p["lora_a"].to(x.dtype)) @ p["lora_b"].to(x.dtype)


def shared_block(p, x, cfg, backend="auto"):
    return attn_block(p["block"], shared_lora(p, x), cfg, backend=backend)


# ---------------------------------------------------------------------------
# the stack
# ---------------------------------------------------------------------------

class Block(NamedTuple):
    """One kind of layer in a segment: its tree path, attention window,
    kind ("dense", "dense_first", "moe": an attention block with that
    FFN; "mamba"; "shared": zamba2's shared block), and ``inner``: the
    layers of that kind a repeat runs on a second stack axis (zamba2's
    segments of ``attn_every``), None for one layer."""
    path: tuple
    window: int | None = None
    kind: str = "dense"
    inner: int | None = None


def _segments(cfg) -> list:
    """The stack as ordered segments ``(repeats, blocks)``: each repeat
    runs ``blocks``, a list of ``Block``, in order. The uniform stack is
    one segment of one kind (``{"layers": ...}``); gemma2 one segment of
    (local, global) pairs (``{"pairs": {"local", "global"}}``); the MoE
    stack ``first_k_dense`` layers of ``dense_layers`` (kind
    "dense_first"), then the rest of ``layers`` (kind "moe"); mamba2 one
    segment of mamba layers; zamba2 ``n_layers // attn_every`` repeats of
    (``attn_every`` mamba layers, the shared block), then the remaining
    mamba layers of ``tail``; as JAX lays them out."""
    if cfg.family == "ssm":
        return [(cfg.n_layers, [Block(("layers",), kind="mamba")])]
    if cfg.family == "hybrid":
        n_seg = cfg.n_layers // cfg.attn_every
        rem = cfg.n_layers - n_seg * cfg.attn_every
        segs = [(n_seg, [Block(("segments",), kind="mamba",
                               inner=cfg.attn_every),
                         Block(("shared",), kind="shared")])]
        return segs + ([(rem, [Block(("tail",), kind="mamba")])] if rem
                       else [])
    if cfg.family == "moe" or cfg.n_experts:
        k = cfg.first_k_dense
        segs = [(k, [Block(("dense_layers",), kind="dense_first")])] if k \
            else []
        return segs + [(cfg.n_layers - k, [Block(("layers",), kind="moe")])]
    if cfg.layer_pattern == "local_global":
        assert cfg.n_layers % 2 == 0
        return [(cfg.n_layers // 2, [Block(("pairs", "local"), cfg.window),
                                     Block(("pairs", "global"))])]
    window = cfg.window if cfg.layer_pattern == "local" else None
    return [(cfg.n_layers, [Block(("layers",), window)])]


def attention_layers(cfg) -> int:
    """The attention blocks a forward runs: every layer of the attention
    families, each shared-block invocation of the hybrid, none in mamba2."""
    return sum(n * (b.inner or 1) for n, blocks in _segments(cfg)
               for b in blocks if b.kind != "mamba")


def _nest(items) -> dict:
    """{path: subtree} pairs -> one nested dict."""
    out: dict = {}
    for path, subtree in items:
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = subtree
    return out


def _at(tree: dict, path: tuple) -> dict:
    for key in path:
        tree = tree[key]
    return tree


def stacked(cfg, block) -> dict:
    """The layer-stacked tree of ``block(window, kind)``, one per layer,
    in ``_segments``' layout (an inner stack axis where the kind has one,
    then the repeats'). Parameters and decode caches share it; the shared
    block's parameters are the one exception (``stack_schema_for``)."""
    items = []
    for n, blocks in _segments(cfg):
        for b in blocks:
            tree = block(b.window, b.kind)
            if b.inner is not None:
                tree = stack_schema(tree, b.inner)
            items.append((b.path, stack_schema(tree, n)))
    return _nest(items)


def _views(tree, i: int, inner: int | None) -> list:
    """Repeat ``i``'s layers of a stacked tree (views, no copy)."""
    t = layer(tree, i)
    return [t] if inner is None else [layer(t, j) for j in range(inner)]


def stack_layers(stack: dict, cfg, cache: dict | None = None):
    """Yield (params, cache, window, kind) of each layer in stack order,
    views of the stacked trees (``cache`` None: None for each). The
    shared block's params are invocation i's: the one block with the
    i-th LoRA delta."""
    for n, blocks in _segments(cfg):
        for i in range(n):
            for b in blocks:
                p = _at(stack, b.path)
                if b.kind == "shared":
                    ps = [{"block": p["block"], "lora_a": p["lora_a"][i],
                           "lora_b": p["lora_b"][i]}]
                else:
                    ps = _views(p, i, b.inner)
                cs = [None] * len(ps) if cache is None \
                    else _views(_at(cache, b.path), i, b.inner)
                for pl, cl in zip(ps, cs):
                    yield pl, cl, b.window, b.kind


def stack_trees(per_layer: list, cfg) -> dict:
    """Per-layer trees in stack order -> the stacked tree of ``stacked``'s
    layout (new stack axes in front of every leaf)."""
    def stack(trees):
        return tree_map(lambda *ts: torch.stack(ts), *trees)

    items, off = [], 0
    for n, blocks in _segments(cfg):
        widths = [b.inner or 1 for b in blocks]
        per_repeat = sum(widths)
        seg = per_layer[off:off + n * per_repeat]
        off += n * per_repeat
        start = 0
        for b, w in zip(blocks, widths):
            reps = [seg[r * per_repeat + start:r * per_repeat + start + w]
                    for r in range(n)]
            start += w
            items.append((b.path, stack([t[0] if b.inner is None
                                         else stack(t) for t in reps])))
    assert off == len(per_layer)
    return _nest(items)


def block_schema(cfg, kind: str):
    """One layer's parameters: a mamba block, or an attention block with
    the FFN ``kind`` names (the shared block's: dense)."""
    if kind == "mamba":
        return mamba_block_schema(cfg)
    return attn_block_schema(cfg, ffn="dense" if kind == "shared" else kind)


def stack_schema_for(cfg) -> dict:
    s = stacked(cfg, lambda window, kind: block_schema(cfg, kind))
    if cfg.family == "hybrid":
        # one block for every invocation, a LoRA delta per invocation
        s["shared"] = shared_block_schema(cfg)
    return s


# the products "dots" keeps: unbatched matmuls (a 3-D activation times a
# weight reaches the dispatcher as one mm)
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _DOTS \
        else CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn, cfg):
    """``fn`` (one layer) under ``cfg.remat`` when autograd records it."""
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return fn
    if cfg.remat == "full":
        return functools.partial(checkpoint, fn, use_reentrant=False)
    if cfg.remat == "dots":
        return functools.partial(
            checkpoint, fn, use_reentrant=False, context_fn=functools.partial(
                create_selective_checkpoint_contexts, _dots_policy))
    raise ValueError(f"unknown remat {cfg.remat!r}; expected none, full or "
                     "dots")


def _layer(p, x, cfg, window, kind, positions, backend):
    """One layer of ``stack_layers`` on the full sequence."""
    if kind == "mamba":
        return mamba_block(p, x, cfg)
    if kind == "shared":
        return shared_block(p, x, cfg, backend)
    return attn_block(p, x, cfg, window=window, encoder=cfg.encoder_only,
                      ffn=kind, positions=positions, backend=backend)


def run_stack(params: dict, x, cfg, *, positions=None, backend="auto"):
    """Full-sequence forward through the layer stack (train/prefill);
    bidirectional attention where ``cfg.encoder_only``. ``backend`` "ref"
    runs the plain attention on a card (the kernel's yardstick)."""
    for p, _, window, kind in stack_layers(params, cfg):
        layer_fn = functools.partial(_layer, p, cfg=cfg, window=window,
                                     kind=kind, positions=positions,
                                     backend=backend)
        x = _remat(layer_fn, cfg)(x)
    return x
