"""Mixture-of-Experts layer (deepseek-v2-lite, granite-moe), from
src/repro/models/moe.py, in the same dense, capacity-bounded form:

  1. router logits (T, E) in the activation dtype, then fp32; softmax or
     sigmoid scores; each token's top-k experts and gate weights
     (renormalised with ``moe_norm_topk``, times ``moe_routed_scale``).
  2. per-expert candidate scores (E, T): the token's gate if it chose the
     expert, else -inf.
  3. each expert's top-C tokens by gate (score-priority capacity: tokens
     beyond C are dropped, lowest gate first; C = ceil(T*k/E * factor)
     rounded up to 128 and never above T).
  4. gather -> (E, C, D), batched expert GLU, each slot weighted by its
     gate, combined back per token.

Two choices keep the port's answers equal to JAX's and repeatable:

  * ``lax.top_k`` keeps the lower index among equal values. ``torch.topk``
    does not promise an order among ties, so both top-k's here are a
    stable descending sort and its first k (``_top_k``).
  * Each token's expert outputs are added in ascending expert order
    through a (T, k) table of its slots (``_combine``), never by an atomic
    ``index_add_``: the same step gives the same bits on a card, so
    greedy decoding repeats.

The expert products are plain batched matmuls, as JAX's are plain einsums
(the JAX package has no Pallas kernel here). The routing stays
differentiable through the gate values (sorts and a scatter of maxima,
no detach), so ``models.model.loss_fn`` trains the router as JAX's
does. ``aux_load_balance_loss`` is the Switch-style auxiliary, standalone
as in JAX: neither package's ``loss_fn`` calls it.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.params import ParamDef


def moe_schema(cfg) -> dict:
    d, f, e = cfg.d_model, cfg.moe_d_ff, cfg.n_experts
    dt = cfg.param_dtype
    s = {
        "router": ParamDef((d, e), ("d_model", "experts"), dtype=dt,
                           scale=0.02),
        "gate": ParamDef((e, d, f), ("experts", "d_model", "d_ff"), dtype=dt),
        "up": ParamDef((e, d, f), ("experts", "d_model", "d_ff"), dtype=dt),
        "down": ParamDef((e, f, d), ("experts", "d_ff", "d_model"), dtype=dt),
    }
    if cfg.n_shared_experts:
        fs = cfg.moe_d_ff * cfg.n_shared_experts
        s["shared"] = {
            "gate": ParamDef((d, fs), ("d_model", "d_ff"), dtype=dt),
            "up": ParamDef((d, fs), ("d_model", "d_ff"), dtype=dt),
            "down": ParamDef((fs, d), ("d_ff", "d_model"), dtype=dt),
        }
    return s


def moe_capacity(cfg, n_tokens: int) -> int:
    c = math.ceil(n_tokens * cfg.moe_top_k / cfg.n_experts
                  * cfg.moe_capacity_factor)
    c = max(int(-(-c // 128) * 128), 128)      # round up to 128, as JAX
    return min(c, n_tokens)                    # never exceed the token count


def _top_k(x: torch.Tensor, k: int):
    """``lax.top_k`` over the last axis: the k largest, descending, the
    lower index first among equal values."""
    val, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return val[..., :k], idx[..., :k]


def route(p: dict, xf: torch.Tensor, cfg):
    """(T, D) tokens -> (top_idx (T, K), top_c_val, top_c_idx, slot_ok),
    the last three (E, C): each token's experts, and each expert's kept
    tokens and their gates, as JAX's ``moe_ffn`` picks them (slot_ok
    False where the expert had fewer than C picks)."""
    t = xf.shape[0]
    logits = (xf @ p["router"].to(xf.dtype)).float()         # (T, E)
    if cfg.moe_score == "sigmoid":
        scores = torch.sigmoid(logits)
    else:
        scores = torch.softmax(logits, dim=-1)
    top_val, top_idx = _top_k(scores, cfg.moe_top_k)         # (T, K)
    if cfg.moe_norm_topk:
        top_val = top_val / torch.clamp_min(
            top_val.sum(dim=-1, keepdim=True), 1e-20)
    top_val = top_val * cfg.moe_routed_scale
    # selected-gate matrix (T, E): the gate where chosen, else 0 (JAX's
    # .at[].max over zeros)
    sel = torch.zeros_like(scores).scatter_reduce(
        1, top_idx, top_val, reduce="amax", include_self=True)
    score_e = torch.where(sel > 0, sel, -math.inf).T         # (E, T)
    top_c_val, top_c_idx = _top_k(score_e, moe_capacity(cfg, t))
    return top_idx, top_c_val, top_c_idx, torch.isfinite(top_c_val)


def _combine(ye: torch.Tensor, tok: torch.Tensor, experts: torch.Tensor
             ) -> torch.Tensor:
    """(E, C, D) slot outputs, their (E, C) tokens (T where the slot is
    empty) and each token's (T, K) chosen experts -> (T, D): each token's
    kept slots added in ascending expert order (JAX's scatter-add order),
    in ye's dtype, a dropped choice adding a zero row."""
    e, c, d = ye.shape
    t = experts.shape[0]
    # slot[e, tok]: the slot expert e kept that token in; column t takes
    # the empty slots' writes and is never read
    slot = torch.full((e, t + 1), e * c, dtype=torch.long, device=ye.device)
    slot.scatter_(1, tok, torch.arange(e * c, device=ye.device).view(e, c))
    table = slot[experts.sort(dim=1).values,
                 torch.arange(t, device=ye.device)[:, None]]      # (T, K)
    rows = torch.cat([ye.reshape(e * c, d), ye.new_zeros((1, d))])
    out = torch.zeros((t, d), dtype=ye.dtype, device=ye.device)
    for j in range(experts.shape[1]):
        out = out + rows[table[:, j]]
    return out


def moe_ffn(p: dict, x: torch.Tensor, cfg) -> torch.Tensor:
    """x: (B, L, D) -> (B, L, D)."""
    b, seq, d = x.shape
    t = b * seq
    xf = x.reshape(t, d)
    top_idx, top_c_val, top_c_idx, slot_ok = route(p, xf, cfg)

    xe = xf[top_c_idx]                                       # (E, C, D)
    g = torch.bmm(xe, p["gate"].to(x.dtype))
    u = torch.bmm(xe, p["up"].to(x.dtype))
    a = F.silu(g.float()).to(x.dtype) * u
    ye = torch.bmm(a, p["down"].to(x.dtype))
    ye = ye * torch.where(slot_ok, top_c_val, 0.0)[..., None].to(x.dtype)
    out = _combine(ye, torch.where(slot_ok, top_c_idx, t), top_idx)

    if "shared" in p:
        g = xf @ p["shared"]["gate"].to(x.dtype)
        u = xf @ p["shared"]["up"].to(x.dtype)
        out = out + (F.silu(g.float()).to(x.dtype) * u) \
            @ p["shared"]["down"].to(x.dtype)
    return out.reshape(b, seq, d)


def aux_load_balance_loss(logits: torch.Tensor, top_idx: torch.Tensor,
                          cfg) -> torch.Tensor:
    """Switch-style load-balance auxiliary (f_i * P_i) of (T, E) router
    logits and the (T, K) chosen experts; optional in training. The
    expert counts are exact (``bincount``), so no atomic order shows."""
    _, e = logits.shape
    probs = torch.softmax(logits.float(), dim=-1)
    frac = torch.bincount(top_idx.reshape(-1).long(), minlength=e).float()
    frac = frac / torch.clamp_min(frac.sum(), 1.0)
    return e * torch.sum(frac * probs.mean(dim=0))
