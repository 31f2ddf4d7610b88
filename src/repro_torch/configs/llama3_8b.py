"""llama3-8b [dense] — 32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=128256.

GQA with 128k vocab [arXiv:2407.21783; unverified].
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="llama3-8b", family="dense",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8, head_dim=128,
    d_ff=14336, vocab_size=128256, rope_theta=500000.0,
))
