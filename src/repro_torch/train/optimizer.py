"""AdamW optimizer + LR schedule, in PyTorch.

The port of ``repro/train/optimizer.py``: the same formulas in the same
float32 arithmetic.  Parameters, gradients and moments are dicts of float32
tensors (the reference's pytrees of one level); the step count, the
learning rate and the bias corrections are float32 device tensors, so a
training loop never waits for the device (no ``.item()`` in a step), and
``b1 ** step`` rounds in float32 as the reference's does.  Global-norm
clipping and decoupled weight decay included.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

import torch


@dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1


class OptState(NamedTuple):
    step: torch.Tensor     # int32 scalar on the parameters' device
    mu: dict
    nu: dict


def lr_at(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup to ``cfg.lr``, then a cosine decay to
    ``min_lr_frac * lr`` at ``total_steps`` (float32 tensor)."""
    step = step.to(torch.float32)
    warm = step / max(cfg.warmup_steps, 1)
    prog = (step - cfg.warmup_steps) / max(cfg.total_steps
                                           - cfg.warmup_steps, 1)
    prog = torch.clamp(prog, 0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def init(params: dict) -> OptState:
    """Zero moments beside ``params`` and step 0."""
    any_p = next(iter(params.values()))
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device)
    return OptState(
        step=torch.zeros((), dtype=torch.int32, device=any_p.device),
        mu={k: zeros(p) for k, p in params.items()},
        nu={k: zeros(p) for k, p in params.items()})


def global_norm(tree: dict) -> torch.Tensor:
    """The L2 norm over every leaf, summed in the reference's leaf order
    (a dict's keys sorted, as ``jax.tree.leaves`` flattens it)."""
    sq = sum(torch.sum(torch.square(tree[k].to(torch.float32)))
             for k in sorted(tree))
    return torch.sqrt(sq)


def apply(cfg: OptConfig, params: dict, grads: dict, state: OptState):
    """Returns (new_params, new_state, metrics)."""
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    step = state.step + 1
    lr = lr_at(cfg, step)
    stepf = step.to(torch.float32)
    b1c = 1 - torch.pow(cfg.b1, stepf)
    b2c = 1 - torch.pow(cfg.b2, stepf)

    new_p, new_m, new_v = {}, {}, {}
    for k, p in params.items():
        g = grads[k].to(torch.float32) * scale
        m = cfg.b1 * state.mu[k] + (1 - cfg.b1) * g
        v = cfg.b2 * state.nu[k] + (1 - cfg.b2) * g * g
        mhat = m / b1c
        vhat = v / b2c
        delta = (mhat / (torch.sqrt(vhat) + cfg.eps)
                 + cfg.weight_decay * p.to(torch.float32))
        new_p[k] = (p.to(torch.float32) - lr * delta).to(p.dtype)
        new_m[k], new_v[k] = m, v
    metrics = {"grad_norm": gnorm, "lr": lr}
    return new_p, OptState(step, new_m, new_v), metrics
