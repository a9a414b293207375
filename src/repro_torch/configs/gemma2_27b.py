"""gemma2-27b [arXiv:2408.00118; hf google/gemma-2-27b].

46L d_model=4608 32H (GQA kv=16, d_head=128) d_ff=36864 vocab=256000.
Alternating local(4096)/global attention (even layers local), logit
softcapping (attn 50, final 30), GeGLU, sandwich (pre+post) RMSNorm with
the gemma (1+w) convention, tied embeddings scaled by sqrt(d_model),
query scale 1/sqrt(query_pre_attn_scalar=144).
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        arch="gemma2-27b",
        family="dense",
        n_layers=46,
        d_model=4608,
        n_heads=32,
        n_kv_heads=16,
        d_head=128,
        d_ff=36864,
        vocab=256_000,
        act="gelu",
        attn_softcap=50.0,
        final_softcap=30.0,
        attn_scale=144.0 ** -0.5,       # query_pre_attn_scalar = 4608/32
        window=4096,
        layer_pattern="local_global",
        norm_scale_plus_one=True,
        post_norms=True,
        tie_embeddings=True,
        embed_scale=4608.0 ** 0.5,
    ),
    smoke=ModelConfig(
        arch="gemma2-27b",
        family="dense",
        n_layers=4,
        d_model=128,
        n_heads=8,
        n_kv_heads=4,
        d_head=16,
        d_ff=256,
        vocab=512,
        act="gelu",
        attn_softcap=50.0,
        final_softcap=30.0,
        attn_scale=16.0 ** -0.5,
        window=64,
        layer_pattern="local_global",
        norm_scale_plus_one=True,
        post_norms=True,
        tie_embeddings=True,
        embed_scale=128.0 ** 0.5,
        attn_chunk_q=64,
        attn_chunk_kv=64,
    ),
)
