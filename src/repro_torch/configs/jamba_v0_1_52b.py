"""jamba-v0.1-52b [hybrid] — 32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=65536, MoE 16e top-2.

Mamba+attn 1:7 interleave, MoE [arXiv:2403.19887; hf].
One attention layer per 8 (attn_period=8, offset 4), MoE FFN every 2nd layer,
mamba d_state=16 (Jamba uses Mamba-1 state size; we run our SSD block with N=16).
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="jamba-v0.1-52b", family="hybrid",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8, head_dim=128,
    d_ff=14336, vocab_size=65536, num_experts=16, experts_per_token=2, moe_every=2,
    ssm_state=16, ssm_headdim=64, ssm_expand=2, attn_period=8, attn_offset=4,
))
