"""Three-term roofline model of a step on H100s (the paper's VAO analysis,
generalized).

The port of ``repro/core/roofline.py``.  The paper predicts vector-engine
speedups from instruction counts alone (VAO speedup, §4.1); for a sharded
step the first-order model is the three-term roofline of the per-device
program, counted by the dry run (``launch/dryrun.py`` through
``core/op_analysis.py``):

    compute    = FLOPs / peak FLOP/s              (per device)
    memory     = HBM bytes / HBM bandwidth        (per device)
    collective = collective bytes / link rate     (per device)

The dominant term is the bottleneck; step time >= max(terms); the
"roofline fraction" is useful_model_flops_time / max(terms).

``Chip`` is one NVIDIA H100 SXM5 80 GB, from NVIDIA's H100 data sheet
(dense rates, no sparsity, at the 700 W limit): 989 TFLOP/s bf16 on the
tensor cores, 3.35 TB/s of HBM3, NVLink 4 at 900 GB/s both ways (450 GB/s
each way; one direction's rate is the collective term's, as the reference
takes one link's), 80 GB.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class Chip:
    name: str = "h100-sxm5-80gb"
    peak_flops: float = 989e12      # bf16 FLOP/s, dense
    hbm_bw: float = 3.35e12         # bytes/s
    ici_bw: float = 450e9           # bytes/s, NVLink 4, one direction
    hbm_bytes: float = 80e9         # capacity


H100 = Chip()


@dataclass
class Roofline:
    flops: float                # per-device flops
    hbm_bytes: float            # per-device bytes accessed
    ici_bytes: float            # per-device collective bytes
    model_flops: float          # useful (6ND-style) flops, GLOBAL
    chips: int
    chip: Chip = H100

    @property
    def t_compute(self) -> float:
        return self.flops / self.chip.peak_flops

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / self.chip.hbm_bw

    @property
    def t_collective(self) -> float:
        return self.ici_bytes / self.chip.ici_bw

    @property
    def bound(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def t_bound(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_ratio(self) -> float:
        """MODEL_FLOPS / (global counted flops): how much of the counted
        compute is useful."""
        total = self.flops * self.chips
        return self.model_flops / total if total else 0.0

    @property
    def mfu_bound(self) -> float:
        """Roofline fraction: useful-flops time / bound time (per device)."""
        t_useful = self.model_flops / self.chips / self.chip.peak_flops
        return t_useful / self.t_bound if self.t_bound else 0.0

    def row(self) -> dict:
        return {
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bound": self.bound,
            "useful_ratio": self.useful_ratio,
            "roofline_fraction": self.mfu_bound,
        }


def model_flops(cfg, shape) -> float:
    """Useful FLOPs: 6·N·D train, 2·N·D inference (N = active params)."""
    n = active_params(cfg)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    # decode: one token per sequence
    return 2.0 * n * shape.global_batch


def _attn_params(cfg) -> float:
    d, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    return d * H * hd * 2 + d * KV * hd * 2


def _ssd_params(cfg) -> float:
    D, DI, N, H = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_nheads
    return D * DI * 2 + 2 * D * N + D * H + DI * D + (DI + 2 * N) * 4


def active_params(cfg) -> float:
    """Parameters touched per token (MoE counts top-k experts only)."""
    d = cfg.d_model
    emb = cfg.vocab_size * d * (1 if cfg.tie_embeddings else 2)
    if cfg.family == "dense" or cfg.family == "vlm":
        per = _attn_params(cfg) + 3 * d * cfg.d_ff
        return emb + cfg.num_layers * per
    if cfg.family == "moe":
        per = _attn_params(cfg) + 3 * d * cfg.d_ff * cfg.experts_per_token
        return emb + cfg.num_layers * per
    if cfg.family == "ssm":
        return emb + cfg.num_layers * _ssd_params(cfg)
    if cfg.family == "hybrid":
        from repro_torch.models.hybrid import layout
        total = 0.0
        for mixer, ffn in layout(cfg):
            total += _attn_params(cfg) if mixer == "attn" else _ssd_params(cfg)
            total += 3 * d * cfg.d_ff * (cfg.experts_per_token if ffn == "moe" else 1)
        return emb + (cfg.num_layers // cfg.attn_period) * total
    if cfg.family == "encdec":
        enc = cfg.encoder_layers * (_attn_params(cfg) + 3 * d * cfg.d_ff)
        dec = cfg.num_layers * (2 * _attn_params(cfg) + 3 * d * cfg.d_ff)
        return emb + enc + dec
    raise ValueError(cfg.family)


def total_params(cfg) -> float:
    """All parameters (MoE counts every expert)."""
    if cfg.family == "moe":
        d = cfg.d_model
        per = _attn_params(cfg) + 3 * d * cfg.d_ff * cfg.num_experts
        emb = cfg.vocab_size * d * (1 if cfg.tie_embeddings else 2)
        return emb + cfg.num_layers * per
    if cfg.family == "hybrid":
        from repro_torch.models.hybrid import layout
        d = cfg.d_model
        emb = cfg.vocab_size * d
        total = 0.0
        for mixer, ffn in layout(cfg):
            total += _attn_params(cfg) if mixer == "attn" else _ssd_params(cfg)
            total += 3 * d * cfg.d_ff * (cfg.num_experts if ffn == "moe" else 1)
        return emb + (cfg.num_layers // cfg.attn_period) * total
    return active_params(cfg)
