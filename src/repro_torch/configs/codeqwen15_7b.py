"""codeqwen1.5-7b [hf Qwen/CodeQwen1.5-7B] — qwen1.5 architecture.

32L d_model=4096 32H (kv=32 i.e. MHA per the assignment) d_ff=13440
vocab=92416, SwiGLU, RoPE theta=1e6, QKV biases (qwen signature), untied.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        arch="codeqwen1.5-7b",
        family="dense",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=32,
        d_head=128,
        d_ff=13440,
        vocab=92416,
        rope_theta=1_000_000.0,
        attn_bias=True,
        norm_eps=1e-6,
    ),
    smoke=ModelConfig(
        arch="codeqwen1.5-7b",
        family="dense",
        n_layers=2,
        d_model=128,
        n_heads=8,
        n_kv_heads=8,
        d_head=16,
        d_ff=256,
        vocab=512,
        rope_theta=1_000_000.0,
        attn_bias=True,
        attn_chunk_q=64,
        attn_chunk_kv=64,
    ),
)
