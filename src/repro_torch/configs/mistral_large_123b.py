"""mistral-large-123b [dense] — 88L d_model=12288 96H (GQA kv=8) d_ff=28672 vocab=32768.

[hf:mistralai/Mistral-Large-Instruct-2407; unverified]
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="mistral-large-123b", family="dense",
    num_layers=88, d_model=12288, num_heads=96, num_kv_heads=8, head_dim=128,
    d_ff=28672, vocab_size=32768, rope_theta=1000000.0,
))
