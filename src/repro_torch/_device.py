"""Device selection shared by every entry point of the port.

Entry points run on the CUDA device unless the caller asks for the CPU.
There is no silent fallback: asking for CUDA on a host without a card
raises, so a CPU run is always one the caller chose.
"""
from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    """``None`` means the CUDA device; raise if it is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch path")
    return dev
