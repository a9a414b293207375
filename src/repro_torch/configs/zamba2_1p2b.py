"""zamba2-1.2b [arXiv:2411.15242; hf Zyphra/Zamba2-1.2B] — hybrid.

38 Mamba-2 layers (d_model=2048, d_inner=4096, headdim=64 -> 64 ssm heads,
state=64) with ONE shared attention+MLP block invoked every 6th layer
(weights shared across its invocations, per-invocation LoRA deltas,
rank 128). Shared block: 32H MHA (kv=32 per the assignment), d_ff=8192.
vocab=32000.

Simplification kept from the JAX package: the published model
concatenates the original embedding to the shared-block input (2*d_model);
we attend over d_model and fold the difference into the LoRA deltas.
A value-for-value copy of src/repro/configs/zamba2_1p2b.py.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        arch="zamba2-1.2b",
        family="hybrid",
        n_layers=38,
        d_model=2048,
        n_heads=32,
        n_kv_heads=32,
        d_head=64,
        d_ff=8192,
        vocab=32000,
        ssm_heads=64,
        ssm_headdim=64,
        ssm_state=64,
        ssm_groups=1,
        ssm_conv_kernel=4,
        attn_every=6,
        shared_lora_rank=128,
        tie_embeddings=True,
    ),
    smoke=ModelConfig(
        arch="zamba2-1.2b",
        family="hybrid",
        n_layers=7,
        d_model=128,
        n_heads=8,
        n_kv_heads=8,
        d_head=16,
        d_ff=256,
        vocab=512,
        ssm_heads=8,
        ssm_headdim=16,
        ssm_state=16,
        ssm_groups=1,
        ssm_conv_kernel=4,
        ssm_chunk=32,
        attn_every=3,
        shared_lora_rank=8,
        tie_embeddings=True,
        attn_chunk_q=64,
        attn_chunk_kv=64,
    ),
)
