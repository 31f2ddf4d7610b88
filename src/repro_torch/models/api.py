"""Unified model API: build(cfg) -> Model with init / loss / prefill / decode.

The port of ``repro/models/api.py``.  Every architecture is reachable
through this one interface; the server never special-cases a family beyond
the input signature differences that ``input_specs`` captures.  Where the
reference returns ``jax.ShapeDtypeStruct``s, the port returns meta tensors
(``device="meta"``: a shape and a type, no storage).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import encdec, hybrid, moe, ssm, transformer, vlm

_FAMILY = {
    "dense": transformer,
    "moe": moe,
    "ssm": ssm,
    "hybrid": hybrid,
    "encdec": encdec,
    "vlm": vlm,
}


@dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    mod: Any

    # ---- parameters -------------------------------------------------------
    def defs(self):
        return self.mod.model_defs(self.cfg)

    def init(self, generator: torch.Generator):
        """Parameters drawn from ``generator``, on its device."""
        return L.init_params(self.defs(), generator, self.cfg.torch_dtype)

    def param_structs(self):
        return L.param_structs(self.defs(), self.cfg.torch_dtype)

    def param_logical(self):
        return L.param_logical(self.defs())

    # ---- training ---------------------------------------------------------
    def loss(self, params, batch):
        return self.mod.loss_fn(params, batch, self.cfg)

    # ---- serving ----------------------------------------------------------
    def prefill(self, params, batch, max_seq):
        cfg = self.cfg
        if cfg.family == "encdec":
            return self.mod.prefill(params, batch["frames"], batch["tokens"],
                                    cfg, max_seq)
        if cfg.family == "vlm":
            return self.mod.prefill(params, batch["patches"],
                                    batch["tokens"], cfg, max_seq)
        return self.mod.prefill(params, batch["tokens"], cfg, max_seq)

    def decode_step(self, params, cache, tokens, pos):
        """One token a slot at position ``pos`` (an int); the cache is
        updated in place and returned."""
        return self.mod.decode_step(params, cache, tokens, pos, self.cfg)

    def init_cache(self, batch, max_seq, device=None):
        return self.mod.init_cache(self.cfg, batch, max_seq,
                                   self.cfg.torch_dtype, device)

    def cache_logical(self):
        return self.mod.cache_logical(self.cfg)

    def cache_structs(self, batch, max_seq):
        return self.init_cache(batch, max_seq, device="meta")


def build(cfg: ModelConfig) -> Model:
    return Model(cfg, _FAMILY[cfg.family])


# ---------------------------------------------------------------------------
# Input specs (meta-tensor stand-ins; never allocate)
# ---------------------------------------------------------------------------

def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: InputShape) -> dict:
    """Stand-ins for every model input of the given shape cell."""
    B, S = shape.global_batch, shape.seq_len
    tok = lambda s: _meta((B, s), torch.int32)
    dt = cfg.torch_dtype
    if shape.kind == "train":
        batch = {"tokens": tok(S), "labels": tok(S)}
        if cfg.family == "encdec":
            batch["frames"] = _meta((B, cfg.num_frames, cfg.d_model), dt)
        if cfg.family == "vlm":
            P = cfg.num_patches
            batch = {"tokens": tok(S - P), "labels": tok(S - P),
                     "patches": _meta((B, P, cfg.d_model), dt)}
        return batch
    if shape.kind == "prefill":
        batch = {"tokens": tok(S)}
        if cfg.family == "encdec":
            batch["frames"] = _meta((B, cfg.num_frames, cfg.d_model), dt)
        if cfg.family == "vlm":
            P = cfg.num_patches
            batch = {"tokens": tok(S - P),
                     "patches": _meta((B, P, cfg.d_model), dt)}
        return batch
    if shape.kind == "decode":
        return {"tokens": tok(1)}
    raise ValueError(shape.kind)


def batch_logical(cfg: ModelConfig, shape: InputShape) -> dict:
    """Logical axes for the input batch (data-parallel over batch dim)."""
    specs = input_specs(cfg, shape)
    out = {}
    for k, v in specs.items():
        if k in ("tokens", "labels"):
            out[k] = ("batch", None)
        elif k in ("frames", "patches"):
            out[k] = ("batch", None, None)
        else:
            out[k] = tuple([None] * len(v.shape))
    return out
