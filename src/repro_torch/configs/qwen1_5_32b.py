"""qwen1.5-32b [dense] — 64L d_model=5120 40H (GQA kv=40, i.e. MHA) d_ff=27392 vocab=152064.

QKV bias [hf:Qwen/Qwen1.5-0.5B; hf].  NOTE: 40 heads do not divide the model=16
mesh axis; the sharding rules fall back to replicated attention + TP FFN (DESIGN.md §5).
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen1.5-32b", family="dense",
    num_layers=64, d_model=5120, num_heads=40, num_kv_heads=40, head_dim=128,
    d_ff=27392, vocab_size=152064, qkv_bias=True,
    # MHA (kv=40) makes the 32k-decode KV cache 21.5 GB/device even perfectly
    # sharded; fp8 KV-cache quantization (standard for MHA long-context
    # serving) brings it inside HBM.
    cache_dtype="float8_e4m3fn",
))
