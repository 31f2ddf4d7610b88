"""granite-moe-3b-a800m [moe] — 32L d_model=1536 24H (GQA kv=8) d_ff=512 vocab=49155, MoE 40e top-8.

[hf:ibm-granite/granite-3.0-1b-a400m-base; hf].  The structured assignment line says
"MoE 40e top-8" while its free-text comment says 32 experts; we follow the structured
field (40 experts).  40 experts do not divide model=16 -> per-expert TP over d_ff
(512/16 = 32 per shard) instead of EP (DESIGN.md §5).
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="granite-moe-3b-a800m", family="moe",
    num_layers=32, d_model=1536, num_heads=24, num_kv_heads=8, head_dim=64,
    d_ff=512, vocab_size=49155, num_experts=40, experts_per_token=8,
))
