"""The card a run measures on, and what a run may not have loaded."""
from __future__ import annotations

import subprocess
import sys

import torch

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def loaded_forbidden(names=None) -> list[str]:
    """Top-level names (the part before the first dot, compared whole) of
    the loaded modules, or of ``names``, that a run must not hold: JAX and
    the JAX package."""
    tops = {n.split(".", 1)[0] for n in list(sys.modules if names is None
                                             else names)}
    return sorted(tops.intersection(FORBIDDEN))


def require_cards(n: int) -> torch.device:
    """The first CUDA device, where at least ``n`` are present; else the
    run ends without a result."""
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the benchmark measures on the card "
                         "and has no CPU fallback")
    if torch.cuda.device_count() < n:
        raise SystemExit(f"the cell needs {n} CUDA devices; "
                         f"{torch.cuda.device_count()} present")
    return torch.device("cuda", 0)


def smi() -> dict:
    """The card's power limit (W) and SM clock (MHz) from nvidia-smi, or
    an empty dict where it cannot be read."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--id=0", "--query-gpu=power.limit,clocks.sm",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=20).stdout.strip().splitlines()[0]
        limit, clock = (x.strip() for x in out.split(","))
        return {"power_limit_w": float(limit), "sm_clock_mhz": float(clock)}
    except (OSError, IndexError, ValueError, subprocess.SubprocessError):
        return {}


def describe(device: torch.device, count: int, peak_bytes: int,
             before: dict, after: dict) -> dict:
    """The result's ``device`` object: the card, the cards used, the peak
    memory, and nvidia-smi's readings before and after the window."""
    out = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": count, "memory_peak_bytes": int(peak_bytes)}
    for k, v in before.items():
        out[k + "_before"] = v
    for k, v in after.items():
        out[k + "_after"] = v
    return out
