"""Top-level LM: embedding and the modality front ends, layer stack,
final norm, output head, loss (src/repro/models/model.py), for every family
of the JAX package: the token-input dense, MoE, SSM (mamba2) and hybrid
(zamba2) families, hubert's audio encoder (precomputed frames through
one biased dense, no token table read) and internvl2's vision prefix
(patches through a two-layer projector, prefixed to the tokens), and
the parameter counts (``active_param_count``: the MoE's per-token
share; every parameter of the other families, zamba2's shared block
counted once). ``loss_fn`` is the training objective; the FSDP step over
parameters placed on a mesh (models/sharding.py) calls it on each data
group's rows with the parameters gathered (train/loop.py).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models import transformer
from repro_torch.models.layers import (
    dense,
    dense_schema,
    embed_schema,
    matmul_f32,
    softcap,
)
from repro_torch.models.params import ParamDef, count_params
from repro_torch.models.transformer import apply_norm, norm_schema


def model_schema(cfg) -> dict:
    dt = cfg.param_dtype
    s: dict = {
        "embed": embed_schema(cfg.vocab, cfg.d_model, dt),
        "stack": transformer.stack_schema_for(cfg),
        "final_norm": norm_schema(cfg),
    }
    if not cfg.tie_embeddings:
        s["lm_head"] = {
            "w": ParamDef((cfg.vocab, cfg.d_model), ("vocab", "d_model"),
                          dtype=dt)
        }
    if cfg.frontend == "audio":
        s["frontend"] = dense_schema(
            cfg.frontend_dim, cfg.d_model, ("frontend", "d_model"),
            bias=True, dtype=dt)
    elif cfg.frontend == "vision":
        # 2-layer MLP projector (internvl's mlp1)
        s["frontend"] = {
            "fc1": dense_schema(cfg.frontend_dim, cfg.d_model,
                                ("frontend", "d_model"), bias=True, dtype=dt),
            "fc2": dense_schema(cfg.d_model, cfg.d_model,
                                ("d_model", None), bias=True, dtype=dt),
        }
    return s


def embed_inputs(params: dict, batch: dict, cfg) -> torch.Tensor:
    """Token / frame / patch embedding -> (B, L', d) activations in
    ``cfg.act_dtype``. Audio: ``batch["frames"]`` (B, T, frontend_dim)
    through the front end's dense, in place of the tokens. Vision: where
    the batch has ``patches`` (B, n_patches, frontend_dim), fc1, tanh-GELU
    in f32, fc2, prefixed to the tokens' embeddings (patch 0 is position
    0); a text-only batch is embedded as tokens alone. Frames and patches
    are moved to the parameters' device and cast to the activation
    dtype."""
    dt = cfg.act_dtype
    table = params["embed"]["table"]
    if cfg.frontend == "audio":
        frames = torch.as_tensor(batch["frames"], device=table.device)
        return dense(params["frontend"], frames.to(dt))
    tokens = torch.as_tensor(batch["tokens"], device=table.device).long()
    x = table.to(dt)[tokens]
    if cfg.embed_scale is not None:
        x = x * torch.tensor(cfg.embed_scale, dtype=dt)
    if cfg.embedding_multiplier != 1.0:
        x = x * torch.tensor(cfg.embedding_multiplier, dtype=dt)
    if cfg.frontend == "vision" and "patches" in batch:
        fe = params["frontend"]
        p = torch.as_tensor(batch["patches"], device=table.device).to(dt)
        p = dense(fe["fc1"], p)
        p = F.gelu(p.float(), approximate="tanh").to(dt)
        p = dense(fe["fc2"], p)
        x = torch.cat([p, x], dim=1)             # patches prefix the text
    return x


def output_logits(params: dict, x: torch.Tensor, cfg) -> torch.Tensor:
    """Final norm and the output head -> fp32 logits (products of
    act-dtype operands, summed in fp32, as JAX's
    preferred_element_type=float32; a plain bf16 matmul would round the
    logits to bf16)."""
    x = apply_norm(params["final_norm"], x, cfg)
    w = params["embed"]["table"] if cfg.tie_embeddings \
        else params["lm_head"]["w"]
    logits = matmul_f32(x, w.to(x.dtype))
    if cfg.logits_scaling != 1.0:
        logits = logits / cfg.logits_scaling
    return softcap(logits, cfg.final_softcap)


def forward(params: dict, batch: dict, cfg, *,
            backend: str = "auto") -> torch.Tensor:
    """Full-sequence forward -> fp32 logits (B, L', vocab); the encoder's
    only entry point. ``backend`` "ref" runs the plain attention on a
    card (the kernel's yardstick), as ``serve.decode.prefill`` takes it."""
    x = embed_inputs(params, batch, cfg)
    x = transformer.run_stack(params["stack"], x, cfg, backend=backend)
    return output_logits(params, x, cfg)


def _xent_terms(params, x, labels, cfg):
    """CE pieces for (B, Lc, d) states: (nll_sum, n_tokens, n_correct)."""
    logits = output_logits(params, x, cfg)
    mask = labels >= 0
    tgt = labels.clamp(0, cfg.vocab - 1)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, tgt[..., None])[..., 0]
    nll = torch.sum((logz - gold) * mask)
    correct = torch.sum((logits.argmax(-1) == tgt) & mask)
    return nll, mask.sum(), correct


def loss_fn(params: dict, batch: dict, cfg) -> tuple[torch.Tensor, dict]:
    """Next-token (or masked-unit, for the encoder) cross entropy ->
    (loss, {"loss", "tokens", "accuracy"}), 0-d tensors on the
    parameters' device.

    labels < 0 are masked (vlm patch positions, padding); a vision batch
    with patches scores the text positions only. The stack runs the
    plain chunked attention (``backend="ref"``) on every device, as the
    JAX training path runs its jnp attention: the attention kernel has no
    backward. When the sequence exceeds ``cfg.loss_chunk`` (and divides
    by it), the CE runs chunk by chunk, each chunk under
    ``torch.utils.checkpoint`` as JAX's is under ``jax.checkpoint``: the
    (B, L, vocab) fp32 logits never materialise, and the backward
    recomputes each chunk's logits from the final hidden states.
    """
    x = embed_inputs(params, batch, cfg)
    x = transformer.run_stack(params["stack"], x, cfg, backend="ref")
    if cfg.frontend == "vision" and "patches" in batch:
        x = x[:, cfg.n_patches:, :]              # text positions only
    labels = torch.as_tensor(batch["labels"], device=x.device).long()
    _, seq, _ = x.shape

    ck = cfg.loss_chunk
    if ck and seq > ck and seq % ck == 0:
        def chunk(xc, lc):
            return _xent_terms(params, xc, lc, cfg)
        nll, n_tok, correct = 0.0, 0, 0
        for s in range(0, seq, ck):
            terms = checkpoint(chunk, x[:, s:s + ck], labels[:, s:s + ck],
                               use_reentrant=False)
            nll, n_tok, correct = (nll + terms[0], n_tok + terms[1],
                                   correct + terms[2])
    else:
        nll, n_tok, correct = _xent_terms(params, x, labels, cfg)

    denom = torch.clamp_min(n_tok, 1)
    loss = nll / denom
    metrics = {
        "loss": loss,
        "tokens": n_tok,
        "accuracy": correct / denom,
    }
    return loss, metrics


def param_count(cfg) -> int:
    return count_params(model_schema(cfg))


def active_param_count(cfg) -> int:
    """Active-per-token params (MoE: shared + top_k routed only) — the
    N_active of the roofline MODEL_FLOPS = 6*N_active*D."""
    if not cfg.n_experts:
        return param_count(cfg)
    total = param_count(cfg)
    expert_p = 3 * cfg.d_model * cfg.moe_d_ff
    inactive = (cfg.n_experts - cfg.moe_top_k) * expert_p * (
        cfg.n_layers - cfg.first_k_dense)
    return total - inactive
