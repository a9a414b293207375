"""Block composition and the layer stacks (src/repro/models/transformer.py):
the uniform stack (every layer one attention block, global or
all-``local`` sliding window, under ``{"layers": ...}``), gemma2's
local/global alternation (``{"pairs": {"local", "global"}}``, a local
layer of ``cfg.window`` then a global one), and the MoE stack
(``{"dense_layers": ...}``, ``first_k_dense`` layers with a dense FFN of
``dense_d_ff``, then ``{"layers": ...}`` with the MoE FFN; granite has no
dense layers, so no ``dense_layers`` key). Attention is MLA where
``cfg.use_mla`` (deepseek-v2), else GQA. Parameters keep JAX's leading
``stack`` axis and tree paths; a Python loop over the layers
(``stack_layers``) takes the place of ``lax.scan`` (the port runs
eagerly, so there is nothing to keep small).

zamba2's mamba segments with a shared block and mamba2's stack wait for
their family: ROADMAP.md, Queue 1, item 7.
"""
from __future__ import annotations

import torch

from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
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

_FAMILIES = "the port serves the dense and MoE families (global, local, " \
            "local_global or first-k-dense + MoE layers, GQA or MLA); " \
            "{what} is not ported yet: ROADMAP.md, Queue 1, item 7"


def check_ported(cfg) -> None:
    """Raise for an architecture outside the ported families."""
    what = None
    if cfg.family in ("ssm", "hybrid"):
        what = f"the {cfg.family} family"
    elif cfg.frontend != "none":
        what = f"the {cfg.frontend} front end"
    if what is not None:
        raise NotImplementedError(_FAMILIES.format(what=what))


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
    check_ported(cfg)
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
               positions=None):
    h = apply_norm(p["norm1"], x, cfg)
    if cfg.use_mla:
        a = attn.mla_attention(p["attn"], h, cfg, positions=positions,
                               triangle=cfg.triangle_schedule)
    else:
        a = attn.gqa_attention(p["attn"], h, cfg, window=window,
                               positions=positions, encoder=encoder,
                               triangle=cfg.triangle_schedule)
    return finish_block(p, x, a, cfg, ffn)


# ---------------------------------------------------------------------------
# the stack
# ---------------------------------------------------------------------------

def _segments(cfg) -> list:
    """The stack as ordered segments ``(repeats, kinds)``: each repeat
    runs ``kinds``, a list of (tree path, window, ffn kind), in order.
    The uniform stack is one segment of one kind (``{"layers": ...}``);
    gemma2 one segment of (local, global) pairs (``{"pairs": {"local",
    "global"}}``); the MoE stack ``first_k_dense`` layers of
    ``dense_layers`` (ffn "dense_first"), then the rest of ``layers``
    (ffn "moe"), as JAX lays them out."""
    if cfg.family == "moe" or cfg.n_experts:
        k = cfg.first_k_dense
        segs = [(k, [(("dense_layers",), None, "dense_first")])] if k else []
        return segs + [(cfg.n_layers - k, [(("layers",), None, "moe")])]
    if cfg.layer_pattern == "local_global":
        assert cfg.n_layers % 2 == 0
        return [(cfg.n_layers // 2, [(("pairs", "local"), cfg.window, "dense"),
                                     (("pairs", "global"), None, "dense")])]
    window = cfg.window if cfg.layer_pattern == "local" else None
    return [(cfg.n_layers, [(("layers",), window, "dense")])]


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
    """The layer-stacked tree of ``block(window, ffn)``, one per layer, in
    ``_segments``' layout. Parameters and decode caches share it."""
    check_ported(cfg)
    return _nest((path, stack_schema(block(window, ffn), n))
                 for n, kinds in _segments(cfg)
                 for path, window, ffn in kinds)


def stack_layers(stack: dict, cfg, cache: dict | None = None):
    """Yield (params, cache, window, ffn) of each layer in stack order,
    views of the stacked trees (``cache`` None: None for each)."""
    check_ported(cfg)
    for n, kinds in _segments(cfg):
        for i in range(n):
            for path, window, ffn in kinds:
                yield (layer(_at(stack, path), i),
                       None if cache is None else layer(_at(cache, path), i),
                       window, ffn)


def stack_trees(per_layer: list, cfg) -> dict:
    """Per-layer trees in stack order -> the stacked tree of ``stacked``'s
    layout (a new stack axis in front of every leaf)."""
    items, off = [], 0
    for n, kinds in _segments(cfg):
        seg = per_layer[off:off + n * len(kinds)]
        off += n * len(kinds)
        items += [(path, tree_map(lambda *ts: torch.stack(ts),
                                  *seg[j::len(kinds)]))
                  for j, (path, _, _) in enumerate(kinds)]
    assert off == len(per_layer)
    return _nest(items)


def stack_schema_for(cfg) -> dict:
    return stacked(cfg, lambda window, ffn: attn_block_schema(cfg, ffn=ffn))


def run_stack(params: dict, x, cfg, *, positions=None):
    """Full-sequence forward through the layer stack (train/prefill)."""
    for p, _, window, ffn in stack_layers(params, cfg):
        x = attn_block(p, x, cfg, window=window, encoder=cfg.encoder_only,
                       ffn=ffn, positions=positions)
    return x
