"""Public wrappers of the suite's kernels.

The port of ``repro/kernels/ops.py``.  Where the reference picks Pallas
interpret mode off-TPU, the port picks by device: tensors already on a
device stay there (CUDA tensors launch the kernel, CPU tensors take the
plain version); anything else is moved to ``device``, which defaults to
the CUDA device and raises if there is none.
"""
from __future__ import annotations

import torch

from repro_torch import _device
from repro_torch.kernels import blackscholes as _bs


def _as_tensor(x, dtype, device):
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(x, dtype=dtype, device=_device.resolve(device))


def blackscholes(spot, strike, rate, vol, time, is_call, *, device=None):
    """Black-Scholes call/put prices of N options (float32 ``[N]``)."""
    f32 = torch.float32
    args = [_as_tensor(x, f32, device) for x in (spot, strike, rate, vol, time)]
    args.append(_as_tensor(is_call, torch.int32, device))
    return _bs.blackscholes(*args)
