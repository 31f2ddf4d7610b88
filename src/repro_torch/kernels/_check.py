"""Operand checks shared by the kernel wrappers.

A kernel takes contiguous tensors of fixed types and ranks on one device;
the wrapper raises ``ValueError`` on anything else before a pointer reaches
native code.
"""
from __future__ import annotations

import torch

INT32_MAX = 2 ** 31 - 1


def tensor(kernel: str, name: str, t, dtypes, ndim: int, device=None) -> None:
    """Check one operand: a tensor of one of ``dtypes`` with ``ndim``
    dimensions, contiguous, on ``device`` when one is given."""
    if not isinstance(t, torch.Tensor):
        raise ValueError(f"{kernel}: {name} must be a tensor, "
                         f"got {type(t).__name__}")
    if t.dtype not in dtypes:
        want = " or ".join(str(d) for d in dtypes)
        raise ValueError(f"{kernel}: {name} must be {want}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{kernel}: {name} must be {ndim}-D, "
                         f"got shape {tuple(t.shape)}")
    if device is not None and t.device != device:
        raise ValueError(f"{kernel}: {name} on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{kernel}: {name} must be contiguous")


def device_kind(kernel: str, t: torch.Tensor) -> str:
    """``"cpu"`` (the plain version) or ``"cuda"`` (the kernel)."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{kernel}: unsupported device {t.device}")
    return t.device.type


def aligned(kernel: str, name: str, t: torch.Tensor, nbytes: int) -> None:
    """Vector loads of ``nbytes`` need the data pointer aligned to them."""
    if t.data_ptr() % nbytes:
        raise ValueError(f"{kernel}: {name} data must be {nbytes}-byte "
                         "aligned")
