"""whisper-small [audio] — enc-dec, 12L d_model=768 12H d_ff=3072 vocab=51865.

Conv frontend STUBBED: input_specs() provides precomputed frame embeddings
(num_frames x d_model) [arXiv:2212.04356; unverified].  12 heads do not divide
model=16 -> replicated-attention fallback.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="whisper-small", family="encdec",
    num_layers=12, d_model=768, num_heads=12, num_kv_heads=12, head_dim=64,
    d_ff=3072, vocab_size=51865, encoder_layers=12, num_frames=1500,
    rope_theta=0.0,  # whisper: absolute (sinusoidal) positions, no RoPE
))
