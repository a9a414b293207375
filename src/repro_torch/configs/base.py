"""Config system: one ``ModelConfig`` per architecture (exact published
values), the input-shape sets and the registry (src/repro/configs/base.py,
kept as a copy: the port imports nothing of the JAX package).

Shapes (LM family: seq_len x global_batch):
    train_4k     4_096 x 256   -> train step
    prefill_32k  32_768 x 32   -> prefill (encoder fwd for encoder-only)
    decode_32k   32_768 x 128  -> serve_step (1 token, 32k KV cache)
    long_500k    524_288 x 1   -> serve_step; sub-quadratic attention only

All ten architectures of the JAX package register (the dense family:
yi-6b, gemma2-27b, starcoder2-3b, codeqwen1.5-7b; the MoE family:
deepseek-v2-lite-16b with MLA, granite-moe-3b-a800m; the SSM / hybrid
family: mamba2-130m, zamba2-1.2b; the front ends: hubert-xlarge's audio
frames, internvl2-1b's vision patches). ``input_specs`` gives a cell's
model inputs as "meta" tensors (shapes and dtypes, no storage: JAX's
ShapeDtypeStructs) and ``batch_specs`` their NamedShardings on a mesh.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str               # train | prefill | decode


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch: str
    family: str                     # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    vocab: int
    # --- attention
    n_heads: int = 0
    n_kv_heads: int = 0
    d_head: int = 0
    rope: bool = True
    rope_theta: float = 10_000.0
    attn_bias: bool = False
    attn_out_bias: bool = False
    attn_softcap: float | None = None
    attn_scale: float | None = None          # None = 1/sqrt(d_head)
    window: int | None = None                # sliding window size
    layer_pattern: str = "global"            # global | local_global | local
    encoder_only: bool = False
    # --- mlp
    d_ff: int = 0
    mlp_type: str = "glu"                    # glu | mlp
    act: str = "silu"
    mlp_bias: bool = False
    # --- norm / embedding
    norm: str = "rmsnorm"                    # rmsnorm | layernorm
    norm_eps: float = 1e-6
    norm_scale_plus_one: bool = False        # gemma (1 + w) convention
    post_norms: bool = False                 # gemma2 sandwich norms
    tie_embeddings: bool = False
    embed_scale: float | None = None         # gemma: sqrt(d_model)
    final_softcap: float | None = None
    logits_scaling: float = 1.0              # granite: divide logits
    embedding_multiplier: float = 1.0
    residual_multiplier: float = 1.0
    # --- MoE
    n_experts: int = 0
    moe_top_k: int = 0
    moe_d_ff: int = 0
    n_shared_experts: int = 0
    moe_score: str = "softmax"               # softmax | sigmoid
    moe_norm_topk: bool = False
    moe_routed_scale: float = 1.0
    moe_capacity_factor: float = 1.25
    first_k_dense: int = 0
    dense_d_ff: int = 0                      # d_ff of the first-k dense layers
    # --- MLA (deepseek-v2)
    use_mla: bool = False
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0
    # --- SSM (mamba2 / zamba2)
    ssm_heads: int = 0
    ssm_headdim: int = 0
    ssm_state: int = 0
    ssm_groups: int = 1
    ssm_conv_kernel: int = 4
    ssm_chunk: int = 256
    ssm_intra_dtype: str = "f32"             # bf16 intra-chunk SSD
    attn_every: int = 0                      # zamba2: shared block cadence
    shared_lora_rank: int = 0
    # --- modality frontend
    frontend: str = "none"                   # none | audio | vision
    frontend_dim: int = 0
    n_patches: int = 0
    # --- dtypes / execution
    param_dtype: Any = torch.float32
    act_dtype: Any = torch.bfloat16
    cache_dtype: Any = torch.bfloat16
    attn_chunk_q: int = 512
    attn_chunk_kv: int = 1024
    loss_chunk: int = 2048                   # CE seq-chunking (0 = full)
    remat: str = "none"                      # none | full | dots
    scan_layers: bool = True
    triangle_schedule: bool = False          # triangular causal chunks
    attn_head_constraint: bool = True        # a layout hint JAX gives
                                             # XLA; the port computes
                                             # heads whole
    # --- shape applicability overrides
    max_train_seq: int = 1 << 20

    # ----- derived / helpers
    def layer_window(self, layer: int) -> int | None:
        if self.layer_pattern == "local":
            return self.window
        if self.layer_pattern == "local_global":
            return self.window if layer % 2 == 0 else None
        return None

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def subquadratic(self) -> bool:
        """Can this arch run long_500k? (bounded per-token state)"""
        if self.family in ("ssm", "hybrid"):
            return True
        return self.layer_pattern in ("local", "local_global") and \
            self.window is not None

    def supports(self, shape: str) -> bool:
        s = SHAPES[shape]
        if s.kind == "decode" and self.encoder_only:
            return False
        if shape == "long_500k" and not self.subquadratic:
            return False
        return True

    def skip_reason(self, shape: str) -> str | None:
        if self.supports(shape):
            return None
        if SHAPES[shape].kind == "decode" and self.encoder_only:
            return "encoder-only arch has no decode step"
        return "pure full-attention arch: 500k decode cache is out of scope"


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: dict[str, ModelConfig] = {}
_SMOKE: dict[str, ModelConfig] = {}
# the config modules, one per architecture
_PORTED = ("yi_6b", "gemma2_27b", "starcoder2_3b", "codeqwen15_7b",
           "deepseek_v2_lite", "granite_moe_3b", "mamba2_130m",
           "zamba2_1p2b", "hubert_xlarge", "internvl2_1b")


def register(cfg: ModelConfig, smoke: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.arch] = cfg
    _SMOKE[cfg.arch] = smoke
    return cfg


def get_config(arch: str) -> ModelConfig:
    _ensure_loaded()
    return _REGISTRY[arch]


def get_smoke_config(arch: str) -> ModelConfig:
    _ensure_loaded()
    return _SMOKE[arch]


def list_archs() -> list[str]:
    _ensure_loaded()
    return sorted(_REGISTRY)


def _ensure_loaded():
    if _REGISTRY:
        return
    import importlib
    for mod in _PORTED:
        importlib.import_module(f"repro_torch.configs.{mod}")


# ---------------------------------------------------------------------------
# input_specs: a cell's inputs as meta tensors (no allocation)
# ---------------------------------------------------------------------------

def input_specs(cfg: ModelConfig, shape) -> dict:
    """Abstract model inputs for one (arch, shape) cell, on the "meta"
    device. ``shape`` is a name of ``SHAPES`` or a ``ShapeSpec`` (the
    dry-run's tests count cells cut to a few tokens).

    train:   {"tokens", "labels"} (+ modality extras)
    prefill: {"tokens"} (+ extras)
    decode:  {"tokens" (B,1), "lengths" (B,)}; the cache's specs come from
             serve.decode.abstract_cache (they are serve_step state, not
             data).
    """
    s = SHAPES[shape] if isinstance(shape, str) else shape
    B, L = s.global_batch, s.seq_len

    def spec(shp, dtype=torch.int32):
        return torch.empty(shp, dtype=dtype, device="meta")

    if s.kind == "train":
        batch: dict = {"tokens": spec((B, L)), "labels": spec((B, L))}
    elif s.kind == "prefill":
        batch = {"tokens": spec((B, L))}
    else:  # decode
        batch = {"tokens": spec((B, 1)), "lengths": spec((B,))}

    if cfg.frontend == "audio":
        # precomputed frame embeddings replace the token stream
        if s.kind in ("train", "prefill"):
            batch.pop("tokens")
            batch["frames"] = spec((B, L, cfg.frontend_dim), torch.float32)
    elif cfg.frontend == "vision" and s.kind in ("train", "prefill"):
        batch["patches"] = spec((B, cfg.n_patches, cfg.frontend_dim),
                                torch.float32)
    return batch


def batch_specs(cfg: ModelConfig, shape, mesh) -> dict:
    """NamedShardings matching input_specs (batch axis -> (pod, data))."""
    from repro_torch.models.sharding import logical_sharding
    out = {}
    for name, spec in input_specs(cfg, shape).items():
        logical = ["batch"] + [None] * (spec.ndim - 1)
        out[name] = logical_sharding(logical, mesh, dims=tuple(spec.shape))
    return out
