"""Block composition and the layer stack (src/repro/models/transformer.py),
for the dense uniform stack: every layer one attention block, global or
all-``local`` (sliding window). Parameters keep JAX's leading ``stack``
axis; a Python loop over the layers takes the place of ``lax.scan`` (the
port runs eagerly, so there is nothing to keep small).

The heterogeneous stacks (gemma2's local/global pairs, deepseek's
first-k-dense + MoE, zamba2's mamba segments with a shared block, mamba2)
wait for their families: ROADMAP.md, Queue 1, item 8.
"""
from __future__ import annotations

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

_FAMILIES = "the port serves the dense uniform stack (global or local " \
            "layers); {what} is not ported yet: ROADMAP.md, Queue 1, item 8"


def check_dense(cfg) -> None:
    """Raise for an architecture outside the ported dense family."""
    what = None
    if cfg.family in ("ssm", "hybrid"):
        what = f"the {cfg.family} family"
    elif cfg.family == "moe" or cfg.n_experts:
        what = "the MoE family"
    elif cfg.use_mla:
        what = "MLA attention"
    elif cfg.layer_pattern == "local_global":
        what = "the local_global layer pattern"
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

def stack_schema_for(cfg) -> dict:
    check_dense(cfg)
    return {"layers": stack_schema(attn_block_schema(cfg), cfg.n_layers)}


def run_stack(params: dict, x, cfg, *, positions=None):
    """Full-sequence forward through the layer stack (train/prefill)."""
    check_dense(cfg)
    window = cfg.window if cfg.layer_pattern == "local" else None
    for i in range(cfg.n_layers):
        x = attn_block(layer(params["layers"], i), x, cfg, window=window,
                       encoder=cfg.encoder_only, positions=positions)
    return x
