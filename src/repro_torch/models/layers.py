"""Layer primitives (src/repro/models/layers.py).

Each primitive comes as a (schema builder, apply function) pair; schema
builders return nested dicts of ParamDef (see params.py), apply functions
take the materialized tensors with the same structure.

Activations are computed in ``cfg.act_dtype`` (bf16 at scale) with fp32
for norms, rope, softmax and logits; every weight is cast to the
activation dtype where it is used, as in JAX (``params.cast_matrices``
makes that cast a no-op for the matrices).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.params import ParamDef

# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rmsnorm_schema(d: int, dtype=torch.float32) -> dict:
    return {"scale": ParamDef((d,), ("d_model",), "ones", dtype=dtype)}


def rmsnorm(p: dict, x: torch.Tensor, *, eps: float = 1e-6,
            scale_plus_one: bool = False) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    w = p["scale"].float()
    if scale_plus_one:           # gemma convention: weight stored as (w-1)
        w = w + 1.0
    return (y * w).to(x.dtype)


def layernorm_schema(d: int, dtype=torch.float32) -> dict:
    return {
        "scale": ParamDef((d,), ("d_model",), "ones", dtype=dtype),
        "bias": ParamDef((d,), ("d_model",), "zeros", dtype=dtype),
    }


def layernorm(p: dict, x: torch.Tensor, *, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, correction=0)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * p["scale"].float() + p["bias"].float()).to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary position embedding
# ---------------------------------------------------------------------------

def rope_frequencies(d_head: int, theta: float = 10_000.0,
                     device=None) -> torch.Tensor:
    """Inverse frequencies (d_head/2,) f32."""
    e = torch.arange(0, d_head, 2, dtype=torch.float32, device=device)
    return 1.0 / (theta ** (e / d_head))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, *,
               theta: float = 10_000.0) -> torch.Tensor:
    """x: (..., L, H, Dh); positions: broadcastable to (..., L) integers.

    Half-split convention (llama/qwen/gemma): rotate [x1, x2] halves, in
    fp32, out in x's dtype.
    """
    dh = x.shape[-1]
    inv = rope_frequencies(dh, theta, device=x.device)        # (Dh/2,)
    ang = positions[..., :, None].float() * inv                # (..., L, Dh/2)
    cos = torch.cos(ang)[..., None, :]                         # (..., L, 1, Dh/2)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Dense / embedding
# ---------------------------------------------------------------------------

def dense_schema(d_in: int, d_out: int, logical: tuple,
                 *, bias: bool = False, dtype=torch.float32,
                 init: str = "normal", scale: float | None = None) -> dict:
    s = {"w": ParamDef((d_in, d_out), logical, init, scale, dtype)}
    if bias:
        s["b"] = ParamDef((d_out,), (logical[-1],), "zeros", dtype=dtype)
    return s


def dense(p: dict, x: torch.Tensor) -> torch.Tensor:
    y = x @ p["w"].to(x.dtype)
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


def embed_schema(vocab: int, d: int, dtype=torch.float32) -> dict:
    return {"table": ParamDef((vocab, d), ("vocab", "d_model"), "embed",
                              0.02, dtype)}


def embed(p: dict, tokens: torch.Tensor,
          dtype=torch.bfloat16) -> torch.Tensor:
    return p["table"].to(dtype)[tokens.long()]


def matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (..., d) @ w (v, d).T with fp32 products, sums and result, the
    operands as given (JAX's preferred_element_type=float32: a bf16 x bf16
    product is exact in fp32, so widening both first is the same
    number)."""
    return x.float() @ w.float().T


# ---------------------------------------------------------------------------
# MLP (GLU family) — llama/qwen/gemma style gate+up / down
# ---------------------------------------------------------------------------

def glu_schema(d: int, d_ff: int, dtype=torch.float32) -> dict:
    return {
        "gate": ParamDef((d, d_ff), ("d_model", "d_ff"), dtype=dtype),
        "up": ParamDef((d, d_ff), ("d_model", "d_ff"), dtype=dtype),
        "down": ParamDef((d_ff, d), ("d_ff", "d_model"), dtype=dtype),
    }


def _act(h: torch.Tensor, act: str) -> torch.Tensor:
    if act == "silu":
        return F.silu(h.float()).to(h.dtype)
    if act == "gelu":
        return F.gelu(h.float(), approximate="tanh").to(h.dtype)
    raise ValueError(act)


def glu(p: dict, x: torch.Tensor, *, act: str = "silu") -> torch.Tensor:
    g = x @ p["gate"].to(x.dtype)
    u = x @ p["up"].to(x.dtype)
    return (_act(g, act) * u) @ p["down"].to(x.dtype)


def mlp_schema(d: int, d_ff: int, *, bias: bool = False,
               dtype=torch.float32) -> dict:
    """Plain 2-layer MLP (starcoder2, hubert)."""
    return {
        "up": dense_schema(d, d_ff, ("d_model", "d_ff"), bias=bias,
                           dtype=dtype),
        "down": dense_schema(d_ff, d, ("d_ff", "d_model"), bias=bias,
                             dtype=dtype),
    }


def mlp(p: dict, x: torch.Tensor, *, act: str = "gelu") -> torch.Tensor:
    h = dense(p["up"], x)
    h = _act(h, "gelu" if act == "gelu" else "silu")
    return dense(p["down"], h)


# ---------------------------------------------------------------------------
# Misc
# ---------------------------------------------------------------------------

def softcap(x: torch.Tensor, cap: float | None) -> torch.Tensor:
    if cap is None:
        return x
    return (cap * torch.tanh(x.float() / cap)).to(x.dtype)
