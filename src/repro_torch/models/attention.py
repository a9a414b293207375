"""Attention (src/repro/models/attention.py): GQA for the dense family
and granite (yi, and the layouts codeqwen / starcoder2 / gemma2 /
granite share), and deepseek-v2's MLA (multi-head latent attention), with
decode against batched, position-tagged caches.

Train/prefill attention is ``chunked_attention``. On a card it runs the
hand-written kernel (``kernels.ops.attention``, csrc/attention_kernels.cu):
the Pallas kernel's Hopper counterpart, which masks ragged tails by
position and skips the kv tiles no row of a query tile can see, so the
triangular causal schedule and the banded window slicing become tile
skips inside the kernel. On the CPU, or with ``backend="ref"``, it runs
the plain chunked online softmax with JAX's ``cq`` / ``ckv`` chunking,
padding, triangle and banding. The kernel has no backward (its wrapper
raises under autograd), so training runs the plain scan; there, as JAX
wraps each kv step in ``jax.checkpoint``, each (q chunk, kv chunk) update
runs under ``torch.utils.checkpoint`` when autograd records it: the
backward recomputes a block's (B, H, cq, ckv) probabilities instead of
keeping them. Decode attention is plain torch on every
device, as JAX computes it with einsums outside any Pallas kernel.

MLA's prefill expands the latent to per-head keys and values and runs
the same ``chunked_attention`` (Dq = nope + rope = 192, Dv = 128 at
deepseek's width); its decode is the weight-absorbed form over a cache of
the latent and the shared rope key only, plain torch as in JAX.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels import ops
from repro_torch.models.layers import apply_rope, rmsnorm, rmsnorm_schema
from repro_torch.models.params import ParamDef

_NEG = -2.0e30


# ---------------------------------------------------------------------------
# Chunked flash core (plain torch; on a card: the kernel)
# ---------------------------------------------------------------------------

def _flash_block(q, k, v, m, l, acc, qpos, kpos, *, causal, window,
                 softcap_v, scale, encoder):
    """One (q_chunk x kv_chunk) online-softmax update.

    q: (B, cq, H, Dq)  k: (B, ck, Hkv, Dq)  v: (B, ck, Hkv, Dv)
    m/l: (B, H, cq, 1); acc: (B, H, cq, Dv). qpos (cq,), kpos (ck,)
    absolute positions, kpos < 0 on padding.
    """
    b, cq, h, dh = q.shape
    dv = v.shape[-1]
    ck, hkv = k.shape[1], k.shape[2]
    rep = h // hkv
    qg = q.reshape(b, cq, hkv, rep, dh)
    logits = torch.einsum("bqgrd,bkgd->bgrqk", qg.float(), k.float()
                          ).reshape(b, h, cq, ck) * scale
    if softcap_v is not None:
        logits = softcap_v * torch.tanh(logits / softcap_v)
    mask = torch.ones((cq, ck), dtype=torch.bool, device=q.device)
    if not encoder and causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window is not None:
        mask &= kpos[None, :] > qpos[:, None] - window
    mask &= (kpos >= 0)[None, :]
    logits = torch.where(mask, logits, _NEG)

    m_cur = logits.amax(dim=-1, keepdim=True)
    m_new = torch.maximum(m, m_cur)
    alpha = torch.exp(m - m_new)
    p = torch.exp(logits - m_new)
    p = torch.where(mask, p, 0.0)
    l_new = l * alpha + p.sum(dim=-1, keepdim=True)
    pv = torch.einsum("bgrqk,bkgd->bqgrd", p.reshape(b, hkv, rep, cq, ck),
                      v.float()).reshape(b, cq, h, dv).transpose(1, 2)
    return m_new, l_new, acc * alpha + pv


def _pad_seq(t: torch.Tensor, n: int) -> torch.Tensor:
    return F.pad(t, (0, 0, 0, 0, 0, n)) if n else t


def chunked_attention(
    q: torch.Tensor,           # (B, Lq, H, Dq)
    k: torch.Tensor,           # (B, Lk, Hkv, Dq)
    v: torch.Tensor,           # (B, Lk, Hkv, Dv)
    *,
    causal: bool = True,
    window: int | None = None,
    softcap: float | None = None,
    scale: float | None = None,
    q_offset: int = 0,
    cq: int = 512,
    ckv: int = 1024,
    encoder: bool = False,
    triangle: bool = False,
    backend: str = "auto",
) -> torch.Tensor:
    """Online-softmax attention -> (B, Lq, H, Dv) in q's dtype; rows that
    see no key are 0. ``backend`` "auto" runs the kernel on a card and the
    plain chunked scan on the CPU; "ref" the plain scan anywhere."""
    if not ops._plain(q, backend):
        return ops.attention(
            q.contiguous(), k.contiguous(), v.contiguous(),
            causal=causal and not encoder, window=window, softcap=softcap,
            scale=scale, q_offset=q_offset)
    b, lq, h, dh = q.shape
    dv = v.shape[-1]
    lk = k.shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(dh)
    cq = min(cq, lq)
    ckv = min(ckv, lk)
    # pad sequences to chunk multiples (kpos < 0 marks padding)
    pq, pk = (-lq) % cq, (-lk) % ckv
    q, k, v = _pad_seq(q, pq), _pad_seq(k, pk), _pad_seq(v, pk)
    nq, nk = (lq + pq) // cq, (lk + pk) // ckv
    ar = torch.arange(lk + pk, device=q.device)
    kpos_all = torch.where(ar < lk, ar, -1)
    kw = dict(causal=causal, window=window, softcap_v=softcap, scale=scale,
              encoder=encoder)
    block = _flash_block
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        # flash-backward memory model: recompute each block's probabilities
        def block(*args, **kw):
            return checkpoint(_flash_block, *args, use_reentrant=False, **kw)

    banded = window is not None and not encoder
    if banded:
        # q chunk jq sees keys in [end - window - cq + 1, end]; slice a
        # static (window + cq) band, rounded up to ckv multiples
        band = ((window + cq + ckv - 1) // ckv + 1) * ckv
        width = min(band, nk * ckv)
    tri = triangle and causal and not encoder and q_offset == 0 \
        and lq == lk and cq == ckv

    outs = []
    for jq in range(nq):
        qj = q[:, jq * cq:(jq + 1) * cq]
        qpos = q_offset + jq * cq + torch.arange(cq, device=q.device)
        m = torch.full((b, h, cq, 1), _NEG, device=q.device)
        l = torch.zeros((b, h, cq, 1), device=q.device)
        acc = torch.zeros((b, h, cq, dv), device=q.device)
        if banded:
            start = (q_offset + jq * cq + cq - 1 - window) // ckv * ckv
            start = min(max(start, 0), max(nk * ckv - band, 0))
            for jk in range(width // ckv):
                s = start + jk * ckv
                m, l, acc = block(
                    qj, k[:, s:s + ckv], v[:, s:s + ckv], m, l, acc, qpos,
                    kpos_all[s:s + ckv], **kw)
        else:
            # triangular schedule: q chunk jq only visits jk <= jq
            for jk in range(jq + 1 if tri else nk):
                s = jk * ckv
                m, l, acc = block(
                    qj, k[:, s:s + ckv], v[:, s:s + ckv], m, l, acc, qpos,
                    kpos_all[s:s + ckv], **kw)
        out = torch.where(l > 0, acc / torch.where(l > 0, l, 1.0), 0.0)
        outs.append(out.transpose(1, 2))        # (B, cq, H, Dv)
    return torch.cat(outs, dim=1)[:, :lq].to(q.dtype)


def decode_attention(
    q: torch.Tensor,           # (B, 1, H, Dh)
    k_cache: torch.Tensor,     # (B, S, Hkv, Dh)
    v_cache: torch.Tensor,     # (B, S, Hkv, Dh)
    kpos: torch.Tensor,        # (B, S) absolute position per slot, -1 empty
    pos: torch.Tensor,         # (B,) position of the new token
    *,
    window: int | None = None,
    softcap: float | None = None,
    scale: float | None = None,
) -> torch.Tensor:
    """Single-token attention against a position-tagged KV cache (ring or
    linear: the per-slot positions make the masks independent of the slot
    order). Products of cache-dtype operands with fp32 sums, p rounded to
    the cache dtype before p.v, as JAX does."""
    b, _, h, dh = q.shape
    s, hkv = k_cache.shape[1], k_cache.shape[2]
    rep = h // hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(dh)
    qg = q.reshape(b, 1, hkv, rep, dh).to(k_cache.dtype)
    logits = torch.einsum("bqgrd,bkgd->bgrqk", qg.float(), k_cache.float()
                          ).reshape(b, h, 1, s) * scale
    if softcap is not None:
        logits = softcap * torch.tanh(logits / softcap)
    mask = (kpos >= 0) & (kpos <= pos[:, None])
    if window is not None:
        mask &= kpos > (pos[:, None] - window)
    logits = torch.where(mask[:, None, None, :], logits, _NEG)
    p = torch.softmax(logits, dim=-1)
    pr = p.reshape(b, hkv, rep, 1, s).to(v_cache.dtype)
    out = torch.einsum("bgrqk,bkgd->bqgrd", pr.float(), v_cache.float()
                       ).reshape(b, 1, h * dh)
    return out.to(q.dtype).reshape(b, 1, h, dh)


# ---------------------------------------------------------------------------
# GQA attention block (yi, codeqwen, starcoder2, gemma2, ...)
# ---------------------------------------------------------------------------

def gqa_schema(cfg) -> dict:
    d, h, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    dt = cfg.param_dtype
    s = {
        "wq": ParamDef((d, h, dh), ("d_model", "heads", None), dtype=dt),
        "wk": ParamDef((d, hkv, dh), ("d_model", "kv_heads", None), dtype=dt),
        "wv": ParamDef((d, hkv, dh), ("d_model", "kv_heads", None), dtype=dt),
        "wo": ParamDef((h, dh, d), ("heads", None, "d_model"), dtype=dt),
    }
    if cfg.attn_bias:
        s["bq"] = ParamDef((h, dh), ("heads", None), "zeros", dtype=dt)
        s["bk"] = ParamDef((hkv, dh), ("kv_heads", None), "zeros", dtype=dt)
        s["bv"] = ParamDef((hkv, dh), ("kv_heads", None), "zeros", dtype=dt)
    if cfg.attn_out_bias:
        s["bo"] = ParamDef((d,), ("d_model",), "zeros", dtype=dt)
    return s


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(B, L, d) x (d, h, k) -> (B, L, h, k)."""
    d, h, kk = w.shape
    return (x @ w.to(x.dtype).reshape(d, h * kk)).unflatten(-1, (h, kk))


def _qkv(p, x, cfg):
    q, k, v = _proj(x, p["wq"]), _proj(x, p["wk"]), _proj(x, p["wv"])
    if "bq" in p:
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    return q, k, v


def _out(p, o, x_dtype):
    h, dh, d = p["wo"].shape
    y = o.to(x_dtype).flatten(-2) @ p["wo"].to(x_dtype).reshape(h * dh, d)
    if "bo" in p:
        y = y + p["bo"].to(x_dtype)
    return y


def gqa_attention(
    p: dict,
    x: torch.Tensor,           # (B, L, d)
    cfg,
    *,
    window: int | None = None,
    positions: torch.Tensor | None = None,
    encoder: bool = False,
    triangle: bool = False,
    return_kv: bool = False,
    backend: str = "auto",
):
    """Train/prefill attention (full sequence). ``return_kv`` also gives
    the rope-applied (k, v) so serve/decode.py can seed its cache."""
    _, seq, _ = x.shape
    q, k, v = _qkv(p, x, cfg)
    pos = positions if positions is not None \
        else torch.arange(seq, device=x.device)
    if cfg.rope:
        q = apply_rope(q, pos, theta=cfg.rope_theta)
        k = apply_rope(k, pos, theta=cfg.rope_theta)
    o = chunked_attention(
        q, k, v, causal=not encoder, window=window,
        softcap=cfg.attn_softcap, scale=cfg.attn_scale,
        cq=cfg.attn_chunk_q, ckv=cfg.attn_chunk_kv, encoder=encoder,
        triangle=triangle, backend=backend,
    )
    out = _out(p, o, x.dtype)
    if return_kv:
        return out, (k, v)
    return out


def gqa_decode(
    p: dict,
    x: torch.Tensor,           # (B, 1, d)
    cache: dict,               # {"k","v": (B,S,Hkv,Dh), "kpos": (B,S)}
    lengths: torch.Tensor,     # (B,) length BEFORE this token (= its pos)
    cfg,
    *,
    window: int | None = None,
) -> tuple[torch.Tensor, dict]:
    """One token per row. Writes the new k, v and position into the cache
    IN PLACE (JAX returns an updated copy; the port's cache tensors are
    views of the layer-stacked cache, so the write lands there) and
    returns (output, cache)."""
    b = x.shape[0]
    s = cache["k"].shape[1]
    q, k, v = _qkv(p, x, cfg)
    lengths = lengths.long()
    if cfg.rope:
        q = apply_rope(q, lengths[:, None], theta=cfg.rope_theta)
        k = apply_rope(k, lengths[:, None], theta=cfg.rope_theta)
    bidx = torch.arange(b, device=x.device)
    slot = lengths % s                  # ring write (S = window for local)
    cache["k"][bidx, slot] = k[:, 0].to(cache["k"].dtype)
    cache["v"][bidx, slot] = v[:, 0].to(cache["v"].dtype)
    cache["kpos"][bidx, slot] = lengths.to(cache["kpos"].dtype)
    o = decode_attention(
        q, cache["k"], cache["v"], cache["kpos"], lengths, window=window,
        softcap=cfg.attn_softcap, scale=cfg.attn_scale,
    )
    return _out(p, o, x.dtype), cache


def gqa_cache_schema(cfg, batch: int, max_len: int,
                     window: int | None = None) -> dict:
    dt = cfg.cache_dtype
    s = min(window, max_len) if window is not None else max_len
    shape = (batch, s, cfg.n_kv_heads, cfg.d_head)
    ax = ("batch", "kv_seq", "kv_heads", None)
    return {"k": ParamDef(shape, ax, "zeros", dtype=dt),
            "v": ParamDef(shape, ax, "zeros", dtype=dt),
            "kpos": ParamDef((batch, s), ("batch", "kv_seq"), "neg",
                             dtype=torch.int32)}


# ---------------------------------------------------------------------------
# MLA — deepseek-v2 multi-head latent attention
# ---------------------------------------------------------------------------

def mla_schema(cfg) -> dict:
    d, h = cfg.d_model, cfg.n_heads
    r, dr = cfg.kv_lora_rank, cfg.qk_rope_dim
    dn, dv = cfg.qk_nope_dim, cfg.v_head_dim
    dt = cfg.param_dtype
    return {
        # q: full-rank projection (v2-lite has q_lora_rank = None)
        "wq": ParamDef((d, h, dn + dr), ("d_model", "heads", None), dtype=dt),
        # kv: joint down-projection to latent + shared rope key
        "wkv_a": ParamDef((d, r + dr), ("d_model", None), dtype=dt),
        "kv_norm": rmsnorm_schema(r, dt)["scale"],
        # up-projection latent -> per-head nope-key and value
        "wkv_b": ParamDef((r, h, dn + dv), (None, "heads", None), dtype=dt),
        "wo": ParamDef((h, dv, d), ("heads", None, "d_model"), dtype=dt),
    }


def _latent(p, x, cfg, pos):
    """(B, L, d) -> the normalised latent c_kv (B, L, r) and the
    rope-applied shared key (B, L, 1, dr). ``kv_norm`` is rmsnorm at its
    own defaults (eps 1e-6, no +1), as JAX applies it."""
    r = cfg.kv_lora_rank
    kv = x @ p["wkv_a"].to(x.dtype)                     # (B, L, r + dr)
    c_kv = rmsnorm({"scale": p["kv_norm"]}, kv[..., :r])
    k_rope = apply_rope(kv[..., r:][:, :, None, :], pos,
                        theta=cfg.rope_theta)
    return c_kv, k_rope


def _mla_q(p, x, cfg, pos):
    """(q_nope, rope-applied q_rope), each (B, L, H, .)."""
    dn = cfg.qk_nope_dim
    q = _proj(x, p["wq"])
    return q[..., :dn], apply_rope(q[..., dn:], pos, theta=cfg.rope_theta)


def _mla_qkv(p, x, cfg, pos):
    """Expanded (train/prefill) form: per-head K/V materialised; k is
    [k_nope, k_rope broadcast over heads], contiguous (B, L, H, dn + dr)."""
    dn, dr = cfg.qk_nope_dim, cfg.qk_rope_dim
    q_nope, q_rope = _mla_q(p, x, cfg, pos)
    c_kv, k_rope = _latent(p, x, cfg, pos)
    kvu = _proj(c_kv, p["wkv_b"])                       # (B, L, H, dn + dv)
    k_nope, v = kvu[..., :dn], kvu[..., dn:]
    k = torch.cat([k_nope, k_rope.expand(*k_nope.shape[:3], dr)], dim=-1)
    qf = torch.cat([q_nope, q_rope], dim=-1)
    return qf, k, v, c_kv, k_rope[:, :, 0]


def mla_attention(p: dict, x: torch.Tensor, cfg, *,
                  positions: torch.Tensor | None = None,
                  triangle: bool = False, return_latent: bool = False,
                  backend: str = "auto"):
    """Train/prefill MLA over the full sequence, causal, at scale
    1/sqrt(dn + dr). ``return_latent`` also gives (c_kv (B, L, r), the
    rope-applied shared key (B, L, dr)) to seed the decode cache."""
    _, seq, _ = x.shape
    pos = positions if positions is not None \
        else torch.arange(seq, device=x.device)
    q, k, v, c_kv, k_rope = _mla_qkv(p, x, cfg, pos)
    scale = 1.0 / math.sqrt(cfg.qk_nope_dim + cfg.qk_rope_dim)
    o = chunked_attention(
        q, k, v, causal=True, scale=scale, cq=cfg.attn_chunk_q,
        ckv=cfg.attn_chunk_kv, triangle=triangle, backend=backend)
    out = _out(p, o, x.dtype)
    if return_latent:
        return out, (c_kv, k_rope)
    return out


def mla_decode(
    p: dict,
    x: torch.Tensor,           # (B, 1, d)
    cache: dict,               # {"ckv": (B,S,r), "krope": (B,S,dr), "kpos"}
    lengths: torch.Tensor,     # (B,) length BEFORE this token (= its pos)
    cfg,
) -> tuple[torch.Tensor, dict]:
    """Weight-absorbed decode: the cache stores only the latent (r) and
    the shared rope key (dr) per token.

    score(h) = q_nope(h) @ W_UK(h)^T @ c_kv^T  +  q_rope(h) @ k_rope^T
    out(h)   = softmax @ c_kv @ W_UV(h)

    As JAX: q_lat and the probabilities cast to the cache dtype, their
    products with the cache summed in fp32. Writes the latent, the rope
    key and the position in place at ``lengths`` (a linear cache) and
    returns (output, cache)."""
    b = x.shape[0]
    dn = cfg.qk_nope_dim
    lengths = lengths.long()
    pos = lengths[:, None]
    q_nope, q_rope = _mla_q(p, x, cfg, pos)
    c_kv, k_rope = _latent(p, x, cfg, pos)
    bidx = torch.arange(b, device=x.device)
    ckv, kr, kp = cache["ckv"], cache["krope"], cache["kpos"]
    ckv[bidx, lengths] = c_kv[:, 0].to(ckv.dtype)
    kr[bidx, lengths] = k_rope[:, 0, 0].to(kr.dtype)
    kp[bidx, lengths] = lengths.to(kp.dtype)

    wkv_b = p["wkv_b"].to(x.dtype)
    # absorb: q' = q_nope @ W_UK^T -> latent space, (B, H, r)
    q_lat = torch.einsum("bhk,rhk->bhr", q_nope[:, 0], wkv_b[..., :dn])
    ckv_f = ckv.float()
    s_lat = torch.bmm(q_lat.to(ckv.dtype).float(), ckv_f.transpose(1, 2))
    s_rope = torch.bmm(q_rope[:, 0].to(kr.dtype).float(),
                       kr.float().transpose(1, 2))       # (B, H, S)
    scale = 1.0 / math.sqrt(dn + cfg.qk_rope_dim)
    logits = (s_lat + s_rope) * scale
    mask = (kp >= 0) & (kp <= lengths[:, None])
    logits = torch.where(mask[:, None, :], logits, _NEG)
    pr = torch.softmax(logits, dim=-1)
    o_lat = torch.bmm(pr.to(ckv.dtype).float(), ckv_f).to(x.dtype)
    o = torch.einsum("bhr,rhv->bhv", o_lat, wkv_b[..., dn:])  # (B, H, dv)
    return _out(p, o[:, None], x.dtype), cache


def mla_cache_schema(cfg, batch: int, max_len: int) -> dict:
    dt = cfg.cache_dtype
    return {
        "ckv": ParamDef((batch, max_len, cfg.kv_lora_rank),
                        ("batch", "kv_seq", None), "zeros", dtype=dt),
        "krope": ParamDef((batch, max_len, cfg.qk_rope_dim),
                          ("batch", "kv_seq", None), "zeros", dtype=dt),
        "kpos": ParamDef((batch, max_len), ("batch", "kv_seq"), "neg",
                         dtype=torch.int32),
    }
