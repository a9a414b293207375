"""hubert-xlarge [arXiv:2106.07447] — encoder-only audio transformer.

48L d_model=1280 16H (MHA, d_head=80) d_ff=5120 vocab=504
(masked-prediction units). The conv waveform front end is a stub, as in
the JAX package: callers pass precomputed frame embeddings (B, T, 512),
which one biased linear layer projects to d_model (``model.embed_inputs``).
Encoder-only: bidirectional attention, no rope, no decode. LayerNorm +
GELU MLP + biases (wav2vec2 family).
A value-for-value copy of src/repro/configs/hubert_xlarge.py.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        arch="hubert-xlarge",
        family="audio",
        n_layers=48,
        d_model=1280,
        n_heads=16,
        n_kv_heads=16,
        d_head=80,
        d_ff=5120,
        vocab=504,
        rope=False,
        attn_bias=True,
        attn_out_bias=True,
        mlp_type="mlp",
        act="gelu",
        mlp_bias=True,
        norm="layernorm",
        norm_eps=1e-5,
        encoder_only=True,
        frontend="audio",
        frontend_dim=512,
    ),
    smoke=ModelConfig(
        arch="hubert-xlarge",
        family="audio",
        n_layers=2,
        d_model=128,
        n_heads=8,
        n_kv_heads=8,
        d_head=16,
        d_ff=256,
        vocab=64,
        rope=False,
        attn_bias=True,
        attn_out_bias=True,
        mlp_type="mlp",
        act="gelu",
        mlp_bias=True,
        norm="layernorm",
        norm_eps=1e-5,
        encoder_only=True,
        frontend="audio",
        frontend_dim=32,
        attn_chunk_q=64,
        attn_chunk_kv=64,
    ),
)
