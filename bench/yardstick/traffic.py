"""The one generator of every traffic mix: it reads a mix's parameters
(``bench/traffic/<mix>.json``) and draws its inputs from the run's seed.

Kinds of mix (``kind``):

- ``train``: ``batches`` batches of ``batch`` x ``seq`` tokens and their
  next-token labels (``yardstick.tokens``), all different, handed to the
  step in turn (the first ``batches`` again after the last).
- ``prefill_waves``: closed-loop waves of ``wave`` prompts, each request
  asking for ``new_tokens`` tokens.  Prompt lengths follow the mix's
  distribution; to give every seed the same work, one cycle of
  ``cycle_waves`` waves holds the distribution's quantiles at
  ``(i + 0.5) / n`` (n the cycle's prompts), grouped into waves once by the
  mix's fixed ``layout_seed``; every run takes the cycle's waves in that
  order, cycle after cycle, so any prefix of the waves is the same work
  for every seed.  The seed orders the prompts inside each wave (which
  pads them to its longest either way) and draws every prompt's tokens.
  Set-up draws ``waves`` waves (a whole number of cycles); a window takes
  them in turn and, past the last, from the first again: the same
  lengths, cycle after cycle, and the same work (no cache keeps a prompt).
"""
from __future__ import annotations

import math
from statistics import NormalDist

import numpy as np

from yardstick import tokens


def quantile_lengths(spec: dict, n: int) -> np.ndarray:
    """``n`` lengths at the distribution's quantiles ``(i + 0.5) / n``,
    clipped to [min, max]."""
    if spec["dist"] != "lognormal":
        raise ValueError(f"no length distribution {spec['dist']!r}")
    nd = NormalDist()
    out = [spec["median"] * math.exp(spec["sigma"] * nd.inv_cdf((i + 0.5) / n))
           for i in range(n)]
    return np.clip(np.rint(out), spec["min"], spec["max"]).astype(np.int64)


def wave_layout(mix: dict) -> np.ndarray:
    """[cycle_waves, wave] prompt lengths: the cycle's quantiles grouped
    into waves by the mix's fixed ``layout_seed``."""
    w, c = mix["wave"], mix["cycle_waves"]
    lengths = quantile_lengths(mix["length"], w * c)
    perm = np.random.default_rng(mix["layout_seed"]).permutation(w * c)
    return lengths[perm].reshape(c, w)


def wave_lengths(mix: dict, seed: int, k: int) -> list[int]:
    """The prompt lengths of a run's wave ``k``."""
    layout = wave_layout(mix)
    w = layout[k % len(layout)]
    perm = np.random.default_rng(np.random.SeedSequence([seed, 3, k])).permutation(len(w))
    return [int(x) for x in w[perm]]


def wave_prompts(mix: dict, seed: int, k: int, vocab: int) -> list[np.ndarray]:
    """The prompts (int32 token ids) of a run's wave ``k``; ``k < 0`` are
    set-up waves, drawn apart from the window's."""
    lengths = wave_lengths(mix, seed, k) if k >= 0 else warmup_lengths(mix, seed)
    S = max(lengths)
    rows = tokens.rows(seed, (1 << 30) + k, len(lengths), S, vocab,
                       **mix.get("tokens", {}))
    return [np.ascontiguousarray(rows[i, :n]) for i, n in enumerate(lengths)]


def window_waves(mix: dict, seed: int, vocab: int) -> list[list[np.ndarray]]:
    """The ``waves`` waves set-up draws; a window's wave ``k`` is
    ``[k % waves]``, of the lengths of ``wave_lengths(mix, seed, k)``."""
    if mix["waves"] % mix["cycle_waves"]:
        raise ValueError("a mix's 'waves' is a whole number of cycles")
    return [wave_prompts(mix, seed, k, vocab) for k in range(mix["waves"])]


def warmup_lengths(mix: dict, seed: int) -> list[int]:
    """The set-up wave: the mix's longest prompt and a window wave's
    others, so the largest shape the window meets is met once before it."""
    w = wave_lengths(mix, seed, 0)
    return [mix["length"]["max"]] + w[1:]


def train_batches(mix: dict, seed: int, vocab: int):
    """[(tokens, labels)] int32 arrays [batch, seq], all different."""
    return [tokens.train_batch(seed, i, mix["batch"], mix["seq"], vocab,
                               **mix.get("tokens", {}))
            for i in range(mix["batches"])]
