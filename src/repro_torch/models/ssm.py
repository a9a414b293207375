"""Mamba-2 / SSD blocks (src/repro/models/ssm.py): mamba2-130m's layers
and zamba2's mamba segments.

State-space duality (SSD, arXiv:2405.21060), chunked: the sequence is
split into chunks of Q tokens; within a chunk the token mixing is the
quadratic masked-decay form (batched matrix products), and across chunks
a (B, H, P, N) state is carried by a linear recurrence. A Python loop
over the chunks takes the place of JAX's ``lax.scan``, as
``transformer.stack_layers`` does over layers. JAX computes the scan with
einsums outside any Pallas kernel, so the port's is plain PyTorch too.

Per head h with decay a_t = dt_t * A_h (A_h < 0):
    h_t = exp(a_t) h_{t-1} + dt_t * B_t x_t^T,   y_t = C_t h_t + D_h x_t

The projections are split (wz / wx / wB / wC / wdt) as in JAX; the
depthwise conv is causal, with a (kernel - 1)-token tail in the decode
cache beside the state, so the cache is O(1) in the sequence.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import rmsnorm
from repro_torch.models.params import ParamDef


def mamba_schema(cfg) -> dict:
    d = cfg.d_model
    H, P, N, G = cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state, cfg.ssm_groups
    kern = cfg.ssm_conv_kernel
    conv_dim = H * P + 2 * G * N
    dt = cfg.param_dtype
    return {
        "wz": ParamDef((d, H, P), ("d_model", "ssm_heads", None), dtype=dt),
        "wx": ParamDef((d, H, P), ("d_model", "ssm_heads", None), dtype=dt),
        "wB": ParamDef((d, G, N), ("d_model", None, None), dtype=dt),
        "wC": ParamDef((d, G, N), ("d_model", None, None), dtype=dt),
        "wdt": ParamDef((d, H), ("d_model", "ssm_heads"), dtype=dt),
        "conv_w": ParamDef((kern, conv_dim), ("conv_k", None), dtype=dt,
                           scale=0.3),
        "conv_b": ParamDef((conv_dim,), (None,), "zeros", dtype=dt),
        "A_log": ParamDef((H,), ("ssm_heads",), "ones", dtype=torch.float32),
        "D": ParamDef((H,), ("ssm_heads",), "ones", dtype=torch.float32),
        "dt_bias": ParamDef((H,), ("ssm_heads",), "zeros",
                            dtype=torch.float32),
        "norm": ParamDef((H * P,), ("d_ff",), "ones", dtype=dt),
        "out": ParamDef((H, P, d), ("ssm_heads", None, "d_model"), dtype=dt),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv. x: (B, L, C); w: (K, C); left-pad K-1. The
    taps are added one after another in x's dtype, as JAX adds them (at
    bf16 every add rounds)."""
    K, L = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, K - 1, 0))
    out = torch.zeros_like(x)
    for i in range(K):
        out = out + xp[:, i:i + L] * w[i].to(x.dtype)
    return out + b.to(x.dtype)


def ssd_scan(
    x: torch.Tensor,      # (B, L, H, P)
    dt: torch.Tensor,     # (B, L, H) f32, positive
    A: torch.Tensor,      # (H,) f32, negative
    Bm: torch.Tensor,     # (B, L, G, N)
    Cm: torch.Tensor,     # (B, L, G, N)
    *,
    chunk: int,
    h0: torch.Tensor | None = None,   # (B, H, P, N) initial state
    return_state: bool = False,
    intra_dtype=torch.float32,        # bf16: CB and the scores in bf16
):
    """Chunked SSD -> y (B, L, H, P) in x's dtype (and the last state
    (B, H, P, N) f32 with ``return_state``). L is padded with zeros to a
    multiple of ``chunk``: dt 0 makes a padded step the identity on the
    state. Group g serves heads [g * H/G, (g + 1) * H/G) (JAX's
    ``jnp.repeat``)."""
    b, seq, h, p = x.shape
    g, n = Bm.shape[2], Bm.shape[3]
    hpg = h // g
    pad = (-seq) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, 0, 0, pad))
    q = chunk
    dt = dt.float()
    state = (torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
             if h0 is None else h0.float())
    tri = torch.ones((q, q), dtype=torch.bool, device=x.device).tril()
    f32 = torch.float32
    ys = []
    for s in range(0, seq + pad, q):
        x_c, dt_c = x[:, s:s + q], dt[:, s:s + q]
        B_h = Bm[:, s:s + q].repeat_interleave(hpg, dim=2)   # (B, Q, H, N)
        C_h = Cm[:, s:s + q].repeat_interleave(hpg, dim=2)
        cum = torch.cumsum(dt_c * A, dim=1)       # (B, Q, H) inclusive
        cum_t = cum.transpose(1, 2)               # (B, H, Q)
        a_sum = cum_t[:, :, -1]                   # (B, H)

        # intra-chunk: quadratic, masked decay; CB and the scores in
        # intra_dtype, y accumulated in f32
        cb = torch.einsum("bqhn,bkhn->bhqk", C_h.to(intra_dtype),
                          B_h.to(intra_dtype))
        # mask the ARGUMENT, not the exp: upper-triangle differences are
        # positive and their exp overflows
        darg = cum_t[:, :, :, None] - cum_t[:, :, None, :]
        ldec = torch.exp(torch.where(tri, darg, -1e30))
        scores = cb * ldec.to(intra_dtype)
        scores = scores * dt_c.transpose(1, 2)[:, :, None, :].to(
            intra_dtype)                                        # dt_j
        y_intra = torch.einsum("bhqk,bkhp->bqhp", scores.to(f32),
                               x_c.to(intra_dtype).to(f32))

        # inter-chunk: the carried state's contribution, then its update
        y_inter = torch.einsum("bqhn,bhpn->bqhp", C_h.to(f32), state) \
            * torch.exp(cum)[..., None]
        decay_end = torch.exp(a_sum[:, None, :] - cum)      # (B, Q, H)
        wB = B_h.to(f32) * (dt_c * decay_end)[..., None]
        state_c = torch.einsum("bqhn,bqhp->bhpn", wB, x_c.to(f32))
        state = torch.exp(a_sum)[:, :, None, None] * state + state_c
        ys.append((y_intra + y_inter).to(x.dtype))
    y = torch.cat(ys, dim=1)[:, :seq]
    if return_state:
        return y, state
    return y


def in_proj(p: dict, x: torch.Tensor, cfg):
    """The block's input projections of x (B, L, d), in x's dtype: z
    (B, L, H * P), the conv's input (B, L, H * P + 2 * G * N: x, B, C
    side by side) and dt's raw projection (B, L, H)."""
    d = x.shape[-1]
    H, P, N, G = cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state, cfg.ssm_groups
    dt = x.dtype
    z = x @ p["wz"].to(dt).reshape(d, H * P)
    conv_in = torch.cat([x @ p["wx"].to(dt).reshape(d, H * P),
                         x @ p["wB"].to(dt).reshape(d, G * N),
                         x @ p["wC"].to(dt).reshape(d, G * N)], dim=-1)
    return z, conv_in, x @ p["wdt"].to(dt)


def _split(conv_out: torch.Tensor, cfg):
    """(..., conv_dim) -> x (..., H, P), B (..., G, N), C (..., G, N)."""
    H, P, N, G = cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state, cfg.ssm_groups
    lead = conv_out.shape[:-1]
    return (conv_out[..., :H * P].reshape(*lead, H, P),
            conv_out[..., H * P:H * P + G * N].reshape(*lead, G, N),
            conv_out[..., H * P + G * N:].reshape(*lead, G, N))


def _gated_out(p: dict, y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """The gated RMSNorm (rmsnorm's default eps, not the config's) and the
    out-projection: y (B, L, H, P), z (B, L, H * P) -> (B, L, d)."""
    b, seq, h, pd = y.shape
    g = y.reshape(b, seq, h * pd) * F.silu(z.float()).to(y.dtype)
    g = rmsnorm({"scale": p["norm"]}, g)
    return g @ p["out"].to(y.dtype).reshape(h * pd, -1)


def mamba_block(p: dict, x: torch.Tensor, cfg, *, return_cache: bool = False):
    """The full Mamba-2 block (prefill). x: (B, L, d) -> (B, L, d); with
    ``return_cache`` also its decode cache: the conv's input of the last
    K-1 tokens (left-padded with zeros when L < K-1) and the last state."""
    seq = x.shape[1]
    z, conv_in, dt_raw = in_proj(p, x, cfg)
    conv_out = F.silu(_causal_conv(conv_in, p["conv_w"], p["conv_b"])
                      .float()).to(x.dtype)
    xc, Bc, Cc = _split(conv_out, cfg)
    dt = F.softplus(dt_raw.float() + p["dt_bias"].float())
    A = -torch.exp(p["A_log"].float())
    intra = torch.bfloat16 if cfg.ssm_intra_dtype == "bf16" \
        else torch.float32
    y, h_last = ssd_scan(xc, dt, A, Bc, Cc, chunk=cfg.ssm_chunk,
                         return_state=True, intra_dtype=intra)
    y = y + xc * p["D"].to(x.dtype)[:, None]
    out = _gated_out(p, y, z)
    if return_cache:
        k1 = cfg.ssm_conv_kernel - 1
        tail = conv_in[:, seq - k1:] if seq >= k1 \
            else F.pad(conv_in, (0, 0, k1 - seq, 0))
        return out, {"conv": tail, "state": h_last}
    return out


def mamba_cache_schema(cfg, batch: int) -> dict:
    H, P, N, G = cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state, cfg.ssm_groups
    conv_dim = H * P + 2 * G * N
    return {
        "conv": ParamDef((batch, cfg.ssm_conv_kernel - 1, conv_dim),
                         ("batch", None, None), "zeros",
                         dtype=cfg.cache_dtype),
        "state": ParamDef((batch, H, P, N),
                          ("batch", "ssm_heads", None, "ssm_state"),
                          "zeros", dtype=torch.float32),
    }


def mamba_decode(p: dict, x: torch.Tensor, cache: dict, cfg):
    """One recurrent step. x: (B, 1, d) -> ((B, 1, d), cache): the conv
    tail rolled by one token and the state advanced, both IN PLACE."""
    H, G = cfg.ssm_heads, cfg.ssm_groups
    z, conv_in, dt_raw = in_proj(p, x, cfg)
    hist = torch.cat([cache["conv"].to(x.dtype), conv_in], dim=1)
    conv_out = torch.einsum("bkc,kc->bc", hist, p["conv_w"].to(x.dtype)) \
        + p["conv_b"].to(x.dtype)
    conv_out = F.silu(conv_out.float()).to(x.dtype)
    xc, Bc, Cc = _split(conv_out, cfg)          # (B, H, P), (B, G, N) x 2
    B_h = Bc.repeat_interleave(H // G, dim=1).float()          # (B, H, N)
    C_h = Cc.repeat_interleave(H // G, dim=1).float()

    dt = F.softplus(dt_raw[:, 0].float() + p["dt_bias"].float())  # (B, H)
    A = -torch.exp(p["A_log"].float())
    decay = torch.exp(dt * A)
    upd = dt[..., None, None] * xc.float()[..., None] * B_h[:, :, None, :]
    h_new = decay[..., None, None] * cache["state"] + upd
    y = torch.einsum("bhpn,bhn->bhp", h_new, C_h)
    y = y.to(x.dtype) + xc * p["D"].to(x.dtype)[:, None]
    out = _gated_out(p, y[:, None], z)
    cache["conv"].copy_(hist[:, 1:])
    cache["state"].copy_(h_new)
    return out, cache
