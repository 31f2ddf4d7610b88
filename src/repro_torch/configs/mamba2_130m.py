"""mamba2-130m [ssm] — 24L d_model=768, attn-free, vocab=50280, ssm_state=128.

SSD (state-space duality) [arXiv:2405.21060; unverified].
d_inner = 2*768 = 1536, headdim 64 -> 24 SSD heads.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="mamba2-130m", family="ssm",
    num_layers=24, d_model=768, num_heads=0, num_kv_heads=0, head_dim=0,
    d_ff=0, vocab_size=50280, ssm_state=128, ssm_headdim=64, ssm_expand=2,
    tie_embeddings=True,
))
