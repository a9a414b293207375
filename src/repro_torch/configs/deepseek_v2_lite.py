"""deepseek-v2-lite-16b [arXiv:2405.04434; hf deepseek-ai/DeepSeek-V2-Lite].

27L d_model=2048, MLA: 16 heads, kv_lora_rank=512, qk_nope=128, qk_rope=64,
v_head=128 (decode caches ONLY the 512+64 latent per token — the paper's
KV-memory contribution). MoE: 64 routed experts (expert d_ff=1408) top-6 +
2 shared experts, first layer dense (d_ff=10944). vocab=102400. A
value-for-value copy of src/repro/configs/deepseek_v2_lite.py (V2-Lite's
64 routed experts, as the hf config has them).
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        arch="deepseek-v2-lite-16b",
        family="moe",
        n_layers=27,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        d_head=128,
        d_ff=1408,                     # routed expert width (assignment)
        vocab=102_400,
        use_mla=True,
        kv_lora_rank=512,
        qk_nope_dim=128,
        qk_rope_dim=64,
        v_head_dim=128,
        n_experts=64,
        moe_top_k=6,
        moe_d_ff=1408,
        n_shared_experts=2,
        moe_score="softmax",
        moe_norm_topk=False,
        first_k_dense=1,
        dense_d_ff=10944,
    ),
    smoke=ModelConfig(
        arch="deepseek-v2-lite-16b",
        family="moe",
        n_layers=3,
        d_model=128,
        n_heads=4,
        n_kv_heads=4,
        d_head=32,
        d_ff=64,
        vocab=512,
        use_mla=True,
        kv_lora_rank=64,
        qk_nope_dim=32,
        qk_rope_dim=16,
        v_head_dim=32,
        n_experts=8,
        moe_top_k=2,
        moe_d_ff=64,
        n_shared_experts=2,
        moe_score="softmax",
        moe_norm_topk=False,
        first_k_dense=1,
        dense_d_ff=256,
        attn_chunk_q=64,
        attn_chunk_kv=64,
    ),
)
