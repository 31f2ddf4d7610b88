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


def launch(entry, t: torch.Tensor, *args) -> int:
    """``entry(*args, stream)`` for a C entry point that launches on
    ``stream``: the raw handle of the current stream of ``t``'s device,
    which is made the current device first only where it is not.  Both
    ``torch.cuda.current_stream()`` (a Stream object a call) and entering
    ``torch.cuda.device`` cost ~3-5 us of host time a call on the H100's
    host, as much as a small kernel's device time."""
    index = t.get_device()
    if index == torch._C._cuda_getDevice():
        return entry(*args, torch._C._cuda_getCurrentRawStream(index))
    with torch.cuda.device(index):
        return entry(*args, torch._C._cuda_getCurrentRawStream(index))
