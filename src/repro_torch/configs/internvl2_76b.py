"""internvl2-76b [vlm] — 80L d_model=8192 64H (GQA kv=8) d_ff=28672 vocab=128256.

InternViT + InternLM2 [arXiv:2404.16821; unverified].  ViT frontend STUBBED:
input_specs() provides precomputed patch embeddings (num_patches x d_model) that the
backbone concatenates with text-token embeddings.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="internvl2-76b", family="vlm",
    num_layers=80, d_model=8192, num_heads=64, num_kv_heads=8, head_dim=128,
    d_ff=28672, vocab_size=128256, num_patches=256,
))
