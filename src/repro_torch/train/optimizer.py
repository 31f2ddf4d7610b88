"""AdamW optimizer + LR schedule, in PyTorch.

The port of ``repro/train/optimizer.py``: the same formulas in the same
float32 arithmetic.  Parameters, gradients and moments are nested dicts of
tensors (the reference's pytrees of dicts; the moments float32, the
parameters in their own type), walked in the reference's leaf order
(sorted keys); the step count, the learning rate and the bias corrections
are float32 device tensors, so a training loop never waits for the device
(no ``.item()`` in a step), and ``b1 ** step`` rounds in float32 as the
reference's does.  Global-norm clipping and decoupled weight decay
included.  ``apply_`` is ``apply`` writing into the parameters and moments
it was given, leaf by leaf: the reference's train step donates them
(``donate_argnums``), and a full-width model has no room for a second copy.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

import torch

from repro_torch.models.layers import tree_leaves, tree_map


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
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device)
    return OptState(
        step=torch.zeros((), dtype=torch.int32,
                         device=tree_leaves(params)[0].device),
        mu=tree_map(zeros, params), nu=tree_map(zeros, params))


def global_norm(tree: dict) -> torch.Tensor:
    """The L2 norm over every leaf, summed in the reference's leaf order
    (a dict's keys sorted, as ``jax.tree.leaves`` flattens it)."""
    sq = sum(torch.sum(torch.square(x.to(torch.float32)))
             for x in tree_leaves(tree))
    return torch.sqrt(sq)


def _prepare(cfg: OptConfig, grads: dict, state: OptState, gnorm=None):
    """The step's scalars: (metrics, update of one leaf, new step);
    ``gnorm`` the gradient's global norm where the caller has it (a
    sharded step: the norm of the whole gradient, not of this rank's
    shards)."""
    if gnorm is None:
        gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    step = state.step + 1
    lr = lr_at(cfg, step)
    stepf = step.to(torch.float32)
    b1c = 1 - torch.pow(cfg.b1, stepf)
    b2c = 1 - torch.pow(cfg.b2, stepf)

    def update(p, g, m, v):
        g = g.to(torch.float32) * scale
        m = cfg.b1 * m + (1 - cfg.b1) * g
        v = cfg.b2 * v + (1 - cfg.b2) * g * g
        mhat = m / b1c
        vhat = v / b2c
        delta = (mhat / (torch.sqrt(vhat) + cfg.eps)
                 + cfg.weight_decay * p.to(torch.float32))
        return (p.to(torch.float32) - lr * delta).to(p.dtype), m, v

    return {"grad_norm": gnorm, "lr": lr}, update, step


def apply(cfg: OptConfig, params: dict, grads: dict, state: OptState):
    """Returns (new_params, new_state, metrics)."""
    metrics, update, step = _prepare(cfg, grads, state)
    new = tree_map(update, params, grads, state.mu, state.nu)
    pick = lambda i: tree_map(lambda t: t[i], new)
    return pick(0), OptState(step, pick(1), pick(2)), metrics


# the most elements ``apply_`` updates at once: a stacked leaf of a
# full-width model (qwen2.5-3b's 36 x 2,048 x 11,008) would otherwise hold
# ~8 float32 temporaries of 3.2 GB each
APPLY_CHUNK = 1 << 26


class PartialUpdateError(Exception):
    """``apply_`` failed after it had written part of the step: the
    parameters and moments hold some leaves of the new step and some of
    the old, so the step cannot be run again on them.  Not a
    ``RuntimeError`` (which the training loop retries): restore a
    checkpoint instead."""


def apply_(cfg: OptConfig, params: dict, grads: dict, state: OptState,
           gnorm=None):
    """``apply`` with the new values written into ``params``, ``state.mu``
    and ``state.nu`` (the same elementwise arithmetic, on slices of the
    leading axis of at most ``APPLY_CHUNK`` elements at a time).  Returns
    (params, new_state, metrics).  A failure before the first write (an
    out-of-memory error in the first slice, say) leaves every tensor as it
    was and is raised as it came; one after it is raised as
    ``PartialUpdateError``.  ``gnorm``: the gradient's global norm where the
    caller computed it (a sharded step, whose ``grads`` are shards)."""
    metrics, update, step = (_prepare(cfg, grads, state) if gnorm is None
                             else _prepare(cfg, grads, state, gnorm))
    written = False
    try:
        with torch.no_grad():
            for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                                  tree_leaves(state.mu),
                                  tree_leaves(state.nu)):
                rows = p.shape[0] if p.ndim else 1
                per = max(1, min(rows,
                                 APPLY_CHUNK // max(1, p.numel() // rows)))
                for i in range(0, rows, per):
                    part = ((lambda t: t[i:i + per]) if p.ndim
                            else (lambda t: t))
                    new_p, new_m, new_v = update(part(p), part(g), part(m),
                                                 part(v))
                    written = True
                    part(p).copy_(new_p)
                    part(m).copy_(new_m)
                    part(v).copy_(new_v)
    except RuntimeError as e:
        if not written:
            raise
        raise PartialUpdateError(
            "the optimizer step failed after writing part of the "
            "parameters and moments; restore a checkpoint") from e
    return params, OptState(step, state.mu, state.nu), metrics
