"""yi-6b — llama-architecture GQA decoder [arXiv:2403.04652; hf 01-ai/Yi-6B].

32L d_model=4096 32H (GQA kv=4, d_head=128) d_ff=11008 vocab=64000,
RMSNorm + SwiGLU, RoPE theta=5e6, untied embeddings, no biases.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        arch="yi-6b",
        family="dense",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=4,
        d_head=128,
        d_ff=11008,
        vocab=64000,
        rope_theta=5_000_000.0,
        norm_eps=1e-5,
    ),
    smoke=ModelConfig(
        arch="yi-6b",
        family="dense",
        n_layers=2,
        d_model=128,
        n_heads=8,
        n_kv_heads=2,
        d_head=16,
        d_ff=256,
        vocab=512,
        rope_theta=5_000_000.0,
        norm_eps=1e-5,
        attn_chunk_q=64,
        attn_chunk_kv=64,
    ),
)
