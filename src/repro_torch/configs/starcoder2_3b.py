"""starcoder2-3b [arXiv:2402.19173; hf bigcode/starcoder2-3b].

30L d_model=3072 24H (GQA kv=2, d_head=128) d_ff=12288 vocab=49152.
LayerNorm, plain gelu MLP, biases everywhere, RoPE theta~1e6, tied
embeddings, sliding-window attention (4096) on ALL layers — which makes
its decode state window-bounded, so the long_500k cell runs (DESIGN.md).
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        arch="starcoder2-3b",
        family="dense",
        n_layers=30,
        d_model=3072,
        n_heads=24,
        n_kv_heads=2,
        d_head=128,
        d_ff=12288,
        vocab=49152,
        rope_theta=999_999.44,
        attn_bias=True,
        attn_out_bias=True,
        mlp_type="mlp",
        act="gelu",
        mlp_bias=True,
        norm="layernorm",
        norm_eps=1e-5,
        tie_embeddings=True,
        window=4096,
        layer_pattern="local",
    ),
    smoke=ModelConfig(
        arch="starcoder2-3b",
        family="dense",
        n_layers=2,
        d_model=128,
        n_heads=8,
        n_kv_heads=2,
        d_head=16,
        d_ff=256,
        vocab=512,
        rope_theta=999_999.44,
        attn_bias=True,
        attn_out_bias=True,
        mlp_type="mlp",
        act="gelu",
        mlp_bias=True,
        norm="layernorm",
        norm_eps=1e-5,
        tie_embeddings=True,
        window=64,
        layer_pattern="local",
        attn_chunk_q=64,
        attn_chunk_kv=64,
    ),
)
