"""Config system: model configs, input shapes and the registry.

The port of ``repro/configs/base.py``.  Every architecture registers a
``ModelConfig`` here (one module per arch under ``repro_torch.configs``),
with the reference's fields, values and derived properties; ``torch_dtype``
stands in for the reference's JAX dtype property.  Input shapes are the
four LM shape cells; :func:`iter_cells` enumerates the ``(arch, shape)``
cells.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

# ---------------------------------------------------------------------------
# Model configs
# ---------------------------------------------------------------------------

FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec", "vlm")

# the types a config names (``dtype``, ``cache_dtype``), by their numpy /
# JAX names
TORCH_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
    "float8_e4m3fn": torch.float8_e4m3fn,
}


def torch_dtype(name: str) -> torch.dtype:
    """The torch type of a config's type name."""
    if name not in TORCH_DTYPES:
        raise ValueError(f"no torch type for {name!r}; known: "
                         f"{sorted(TORCH_DTYPES)}")
    return TORCH_DTYPES[name]


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    # --- MoE ---
    num_experts: int = 0
    experts_per_token: int = 0
    moe_every: int = 1          # MoE FFN every k-th layer (jamba: 2); dense otherwise
    # --- SSM (mamba2 SSD) ---
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256        # SSD chunk length (the "MVL" of the state scan)
    # --- hybrid (jamba) ---
    attn_period: int = 0        # one attention layer per `attn_period` layers; 0 = n/a
    attn_offset: int = 4
    # --- enc-dec (whisper) ---
    encoder_layers: int = 0
    num_frames: int = 0         # stubbed conv frontend output length
    # --- VLM ---
    num_patches: int = 0        # stubbed ViT frontend output length
    # --- numerics / training ---
    dtype: str = "bfloat16"
    cache_dtype: str = "bfloat16"   # KV-cache storage (fp8 for MHA long-ctx)
    remat: bool = True
    scan_layers: bool = True
    # Layers with different shapes scanned per-period for hybrids.

    @property
    def torch_dtype(self) -> torch.dtype:
        return torch_dtype(self.dtype)

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to a multiple of 128 so the vocab dim TP-shards
        (granite 49155 / whisper 51865 / mamba2 50280 are not divisible by the
        model axis; unsharded logits cost 12 GB/device for granite train).
        Labels are always < vocab_size; pad logits only dilute the softmax."""
        return -(-self.vocab_size // 128) * 128

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_nheads(self) -> int:
        return self.d_inner // self.ssm_headdim

    @property
    def attn_layers(self) -> int:
        if self.family == "hybrid":
            return self.num_layers // self.attn_period
        if self.family == "ssm":
            return 0
        return self.num_layers

    @property
    def is_subquadratic(self) -> bool:
        """True when the arch can decode 500k-token contexts (SSM / hybrid)."""
        return self.family in ("ssm", "hybrid")

    def scaled(self, **overrides) -> "ModelConfig":
        return dataclasses.replace(self, **overrides)

    def smoke(self) -> "ModelConfig":
        """Reduced same-family config for CPU smoke tests."""
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            num_layers=max(2, self.attn_period or 2) if self.family == "hybrid" else 2,
            d_model=64,
            num_heads=4,
            num_kv_heads=2 if self.num_kv_heads < self.num_heads else 4,
            head_dim=16,
            d_ff=128,
            vocab_size=256,
            num_experts=min(self.num_experts, 4),
            experts_per_token=min(self.experts_per_token, 2),
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_headdim=16,
            ssm_chunk=8,
            encoder_layers=2 if self.encoder_layers else 0,
            num_frames=16 if self.num_frames else 0,
            num_patches=8 if self.num_patches else 0,
            dtype="float32",
            cache_dtype="float32",
            remat=False,
        )


# ---------------------------------------------------------------------------
# Input shape cells
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}


def shape_applicable(cfg: ModelConfig, shape: InputShape) -> tuple[bool, str]:
    """Whether a shape cell applies to an arch (per DESIGN.md §5 skips)."""
    if shape.name == "long_500k" and not cfg.is_subquadratic:
        return False, "long_500k needs sub-quadratic attention; %s is full-attention" % cfg.name
    return True, ""


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    assert cfg.family in FAMILIES, cfg.family
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        _load_all()
    return _REGISTRY[name]


def list_configs() -> list[str]:
    _load_all()
    return sorted(_REGISTRY)


ARCH_IDS = (
    "llama3-8b",
    "mistral-large-123b",
    "qwen1.5-32b",
    "qwen2.5-3b",
    "whisper-small",
    "mamba2-130m",
    "dbrx-132b",
    "granite-moe-3b-a800m",
    "internvl2-76b",
    "jamba-v0.1-52b",
)

_MODULES = (
    "llama3_8b", "mistral_large_123b", "qwen1_5_32b", "qwen2_5_3b",
    "whisper_small", "mamba2_130m", "dbrx_132b", "granite_moe_3b_a800m",
    "internvl2_76b", "jamba_v0_1_52b",
)


def _load_all() -> None:
    import importlib
    for m in _MODULES:
        importlib.import_module(f"repro_torch.configs.{m}")


def iter_cells():
    """Yield (ModelConfig, InputShape, applicable, reason) for the 40 cells."""
    _load_all()
    for arch in ARCH_IDS:
        cfg = _REGISTRY[arch]
        for shape in SHAPES.values():
            ok, why = shape_applicable(cfg, shape)
            yield cfg, shape, ok, why
