"""Deterministic, seekable synthetic token pipeline.

The port of ``repro/data/pipeline.py``.  Fault tolerance requires the data
stream to be a pure function of (seed, step): after a restart the loop
resumes at the checkpointed step and sees exactly the tokens it would have
seen, with no iterator state to persist.  Sequences follow a Zipf-ish
marginal with short-range correlations so losses move during the example
runs.

``batch_at`` draws on the host with numpy, as the reference does, so its
tokens and labels equal the reference's bit for bit; they go to the
caller's device as int32 tensors.  ``extra_inputs`` (the stub frames and
patches) draws from a ``torch.Generator`` seeded from ``(seed + 1,
step)``: the bits are torch's, not ``jax.random``'s.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch import _device


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0


def batch_at(cfg: DataConfig, step: int, device=None) -> dict:
    """Batch for ``step``, deterministically (host-side numpy; cheap), as
    int32 tensors on ``device`` (default: the CUDA device)."""
    dev = _device.resolve(device)
    rng = np.random.default_rng(np.random.SeedSequence([cfg.seed, step]))
    B, S, V = cfg.global_batch, cfg.seq_len, cfg.vocab_size
    # zipf-ish marginal over the vocab
    ranks = rng.zipf(1.3, size=(B, S + 1)).astype(np.int64)
    base = (ranks - 1) % V
    # short-range structure: every 4th token repeats an earlier one
    rep = np.roll(base, 3, axis=1)
    mask = (np.arange(S + 1)[None, :] % 4) == 0
    toks = np.where(mask, rep, base).astype(np.int32)
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    return {"tokens": put(toks[:, :-1]), "labels": put(toks[:, 1:])}


def _generator(seed: int, step: int, device) -> torch.Generator:
    """A generator on ``device`` seeded from ``(seed, step)``."""
    s = np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(s))


def extra_inputs(cfg_model, batch_size: int, seed: int, step: int,
                 device=None) -> dict:
    """Stub modality inputs (frames / patches) for the encdec / vlm
    families: standard normals in float32 rounded to the model's type,
    from a generator seeded from ``(seed + 1, step)`` on ``device``."""
    n = {"encdec": cfg_model.num_frames,
         "vlm": cfg_model.num_patches}.get(cfg_model.family)
    if n is None:
        return {}
    dev = _device.resolve(device)
    x = torch.randn(batch_size, n, cfg_model.d_model,
                    generator=_generator(seed + 1, step, dev), device=dev)
    key = "frames" if cfg_model.family == "encdec" else "patches"
    return {key: x.to(cfg_model.torch_dtype)}


def batches(cfg: DataConfig, start_step: int = 0, device=None):
    step = start_step
    while True:
        yield step, batch_at(cfg, step, device)
        step += 1
