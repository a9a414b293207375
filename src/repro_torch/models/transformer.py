"""Block composition and the layer stacks (src/repro/models/transformer.py),
for the dense family: the uniform stack (every layer one attention block,
global or all-``local`` sliding window, under ``{"layers": ...}``) and
gemma2's local/global alternation (``{"pairs": {"local", "global"}}``, a
local layer of ``cfg.window`` then a global one). Parameters keep JAX's
leading ``stack`` axis and tree paths; a Python loop over the layers
(``stack_layers``) takes the place of ``lax.scan`` (the port runs
eagerly, so there is nothing to keep small).

The other heterogeneous stacks (deepseek's first-k-dense + MoE, zamba2's
mamba segments with a shared block, mamba2) wait for their families:
ROADMAP.md, Queue 1, item 7.
"""
from __future__ import annotations

import torch

from repro_torch.models import attention as attn
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

_FAMILIES = "the port serves the dense family (global, local or " \
            "local_global layers); {what} is not ported yet: ROADMAP.md, " \
            "Queue 1, item 7"


def check_dense(cfg) -> None:
    """Raise for an architecture outside the ported dense family."""
    what = None
    if cfg.family in ("ssm", "hybrid"):
        what = f"the {cfg.family} family"
    elif cfg.family == "moe" or cfg.n_experts:
        what = "the MoE family"
    elif cfg.use_mla:
        what = "MLA attention"
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


def attn_block_schema(cfg):
    check_dense(cfg)
    s = {
        "norm1": norm_schema(cfg),
        "attn": attn.gqa_schema(cfg),
        "norm2": norm_schema(cfg),
        "ffn": ffn_schema(cfg),
    }
    if cfg.post_norms:
        s["norm_post_attn"] = norm_schema(cfg)
        s["norm_post_ffn"] = norm_schema(cfg)
    return s


def attn_block(p, x, cfg, *, window=None, encoder=False, positions=None):
    h = apply_norm(p["norm1"], x, cfg)
    a = attn.gqa_attention(p["attn"], h, cfg, window=window,
                           positions=positions, encoder=encoder,
                           triangle=cfg.triangle_schedule)
    if cfg.post_norms:
        a = apply_norm(p["norm_post_attn"], a, cfg)
    x = x + cfg.residual_multiplier * a
    h = apply_norm(p["norm2"], x, cfg)
    m = apply_ffn(p["ffn"], h, cfg)
    if cfg.post_norms:
        m = apply_norm(p["norm_post_ffn"], m, cfg)
    return x + cfg.residual_multiplier * m


# ---------------------------------------------------------------------------
# the stack
# ---------------------------------------------------------------------------

def _kinds(cfg) -> tuple[list, int]:
    """The kinds of layer the stack repeats, as (tree path, window) in the
    order one repeat runs them, and the number of repeats: the uniform
    stack ``{"layers": ...}``, or gemma2's ``{"pairs": {"local",
    "global"}}`` (a local layer of ``cfg.window``, then a global one)."""
    if cfg.layer_pattern == "local_global":
        assert cfg.n_layers % 2 == 0
        return ([(("pairs", "local"), cfg.window),
                 (("pairs", "global"), None)], cfg.n_layers // 2)
    window = cfg.window if cfg.layer_pattern == "local" else None
    return [(("layers",), window)], cfg.n_layers


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
    """The layer-stacked tree of ``block(window)``, one per layer, in
    ``_kinds``' layout. Parameters and decode caches share it."""
    check_dense(cfg)
    kinds, n = _kinds(cfg)
    return _nest((path, stack_schema(block(window), n))
                 for path, window in kinds)


def stack_layers(stack: dict, cfg, cache: dict | None = None):
    """Yield (params, cache, window) of each layer in stack order, views
    of the stacked trees (``cache`` None: None for each)."""
    check_dense(cfg)
    kinds, n = _kinds(cfg)
    for i in range(n):
        for path, window in kinds:
            yield (layer(_at(stack, path), i),
                   None if cache is None else layer(_at(cache, path), i),
                   window)


def stack_trees(per_layer: list, cfg) -> dict:
    """Per-layer trees in stack order -> the stacked tree of ``stacked``'s
    layout (a new stack axis in front of every leaf)."""
    kinds, n = _kinds(cfg)
    assert len(per_layer) == n * len(kinds)
    return _nest((path, tree_map(lambda *ts: torch.stack(ts),
                                 *per_layer[j::len(kinds)]))
                 for j, (path, _) in enumerate(kinds))


def stack_schema_for(cfg) -> dict:
    return stacked(cfg, lambda window: attn_block_schema(cfg))


def run_stack(params: dict, x, cfg, *, positions=None):
    """Full-sequence forward through the layer stack (train/prefill)."""
    for p, _, window in stack_layers(params, cfg):
        x = attn_block(p, x, cfg, window=window, encoder=cfg.encoder_only,
                       positions=positions)
    return x
