"""internvl2-1b [arXiv:2404.16821; hf OpenGVLab/InternVL2-1B] — VLM.

Text backbone = Qwen2-0.5B: 24L d_model=896 14H (GQA kv=2, d_head=64)
d_ff=4864 vocab=151655, QKV bias, RoPE theta=1e6, tied embeddings.
The InternViT vision tower is a stub, as in the JAX package: callers pass
precomputed patch embeddings (B, 256, 1024); the model owns the two-layer
MLP projector (1024 -> d_model -> d_model) and prefixes the projected
patches to the token sequence (``model.embed_inputs``). The smoke config
keeps an odd head group (7 / 1) on purpose.
A value-for-value copy of src/repro/configs/internvl2_1b.py.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        arch="internvl2-1b",
        family="vlm",
        n_layers=24,
        d_model=896,
        n_heads=14,
        n_kv_heads=2,
        d_head=64,
        d_ff=4864,
        vocab=151_655,
        rope_theta=1_000_000.0,
        attn_bias=True,
        tie_embeddings=True,
        frontend="vision",
        frontend_dim=1024,
        n_patches=256,
    ),
    smoke=ModelConfig(
        arch="internvl2-1b",
        family="vlm",
        n_layers=2,
        d_model=128,
        n_heads=7,                     # keep the awkward head count
        n_kv_heads=1,
        d_head=16,
        d_ff=256,
        vocab=512,
        rope_theta=1_000_000.0,
        attn_bias=True,
        tie_embeddings=True,
        frontend="vision",
        frontend_dim=64,
        n_patches=16,
        attn_chunk_q=64,
        attn_chunk_kv=64,
    ),
)
