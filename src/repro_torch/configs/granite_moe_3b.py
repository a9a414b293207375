"""granite-moe-3b-a800m [hf ibm-granite/granite-3.0-3b-a800m-base].

32L d_model=1536 24H (GQA kv=8, d_head=64) vocab=49155.
MoE: 40 experts top-8, expert d_ff=512, no shared experts, top-k weights
renormalized. Granite signature scalar multipliers: embedding 12.0,
residual 0.22, attention_multiplier 1/128, logits_scaling 6.0. Tied
embeddings. A value-for-value copy of src/repro/configs/granite_moe_3b.py
(the 40-expert spec).
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        arch="granite-moe-3b-a800m",
        family="moe",
        n_layers=32,
        d_model=1536,
        n_heads=24,
        n_kv_heads=8,
        d_head=64,
        d_ff=512,
        vocab=49155,
        attn_scale=1.0 / 128.0,        # attention_multiplier
        n_experts=40,
        moe_top_k=8,
        moe_d_ff=512,
        moe_norm_topk=True,
        tie_embeddings=True,
        embedding_multiplier=12.0,
        residual_multiplier=0.22,
        logits_scaling=6.0,
        norm_eps=1e-6,
    ),
    smoke=ModelConfig(
        arch="granite-moe-3b-a800m",
        family="moe",
        n_layers=2,
        d_model=128,
        n_heads=8,
        n_kv_heads=4,
        d_head=16,
        d_ff=64,
        vocab=512,
        attn_scale=1.0 / 16.0,
        n_experts=10,
        moe_top_k=2,
        moe_d_ff=64,
        moe_norm_topk=True,
        tie_embeddings=True,
        embedding_multiplier=12.0,
        residual_multiplier=0.22,
        logits_scaling=6.0,
        attn_chunk_q=64,
        attn_chunk_kv=64,
    ),
)
