"""Plain PyTorch versions of the suite's data-parallel kernels.

The port of ``repro/kernels/ref.py``: each function is the semantic ground
truth its hand-written kernel must reproduce.  This slice carries
Black-Scholes (``repro/kernels/ref.py:19-27``).
"""
from __future__ import annotations

import torch

SQRT2 = 1.4142135623730951


def _cndf(x):
    return 0.5 * (1.0 + torch.erf(x / SQRT2))


def blackscholes(spot, strike, rate, vol, time, is_call):
    """Black-Scholes option pricing (PARSEC blackscholes ROI)."""
    sqrt_t = torch.sqrt(time)
    d1 = (torch.log(spot / strike) + (rate + 0.5 * vol * vol) * time) \
        / (vol * sqrt_t)
    d2 = d1 - vol * sqrt_t
    call = spot * _cndf(d1) - strike * torch.exp(-rate * time) * _cndf(d2)
    put = strike * torch.exp(-rate * time) * _cndf(-d2) - spot * _cndf(-d1)
    return torch.where(is_call != 0, call, put)
