"""mamba2-130m [arXiv:2405.21060; hf state-spaces/mamba2-130m] — pure SSM.

24L d_model=768, attention-free. d_inner = 2*768 = 1536, headdim=64 ->
24 SSD heads, state=128, 1 group, conv kernel 4. vocab=50280 (gpt-neox
tokenizer padded), tied embeddings. SSD chunk 256 (intra-chunk quadratic
+ inter-chunk linear recurrence — models/ssm.py).
A value-for-value copy of src/repro/configs/mamba2_130m.py.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        arch="mamba2-130m",
        family="ssm",
        n_layers=24,
        d_model=768,
        vocab=50280,
        rope=False,
        ssm_heads=24,
        ssm_headdim=64,
        ssm_state=128,
        ssm_groups=1,
        ssm_conv_kernel=4,
        ssm_chunk=256,
        tie_embeddings=True,
        norm_eps=1e-5,
    ),
    smoke=ModelConfig(
        arch="mamba2-130m",
        family="ssm",
        n_layers=2,
        d_model=128,
        vocab=512,
        rope=False,
        ssm_heads=8,
        ssm_headdim=16,
        ssm_state=16,
        ssm_groups=1,
        ssm_conv_kernel=4,
        ssm_chunk=32,
        tie_embeddings=True,
        norm_eps=1e-5,
    ),
)
