"""qwen2.5-3b [dense] — 36L d_model=2048 16H (GQA kv=2) d_ff=11008 vocab=151936.

GQA, QKV bias [hf:Qwen/Qwen2.5-0.5B; hf].
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen2.5-3b", family="dense",
    num_layers=36, d_model=2048, num_heads=16, num_kv_heads=2, head_dim=128,
    d_ff=11008, vocab_size=151936, qkv_bias=True, rope_theta=1000000.0,
))
