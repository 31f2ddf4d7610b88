"""Token sequences drawn from a seed.

A frozen copy of ``repro_torch/data/pipeline.py``'s ``batch_at`` (as of
the commit that added this benchmark): a Zipf-like marginal over the
vocabulary (exponent 1.3), every 4th token repeating the one 3 before it.
Kept here so that a change to the program's data pipeline does not change
the benchmark's inputs.
"""
from __future__ import annotations

import numpy as np


def rows(seed: int, index: int, batch: int, length: int, vocab: int,
         zipf_a: float = 1.3, lag: int = 3, every: int = 4) -> np.ndarray:
    """[batch, length] int32 token ids, a pure function of (seed, index)."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, index]))
    ranks = rng.zipf(zipf_a, size=(batch, length)).astype(np.int64)
    base = (ranks - 1) % vocab
    rep = np.roll(base, lag, axis=1)
    mask = (np.arange(length)[None, :] % every) == 0
    return np.where(mask, rep, base).astype(np.int32)


def train_batch(seed: int, step: int, batch: int, seq: int, vocab: int,
                **shape) -> tuple[np.ndarray, np.ndarray]:
    """(tokens, labels), each [batch, seq]: ``batch_at``'s next-token pair
    of one drawn row of ``seq + 1`` tokens."""
    t = rows(seed, step, batch, seq + 1, vocab, **shape)
    return np.ascontiguousarray(t[:, :-1]), np.ascontiguousarray(t[:, 1:])
