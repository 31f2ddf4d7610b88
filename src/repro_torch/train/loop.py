"""Fault-tolerant training loop: checkpoint/restart, retry, straggler hooks.

The port of ``repro/train/loop.py``.  ``train`` resumes from the newest
valid checkpoint, saves every ``ckpt_every`` steps and at the last, retries
a failed step with exponential backoff (the single-host stand-in for
preemption recovery), and logs each step's wall time with a deadline-based
straggler monitor (at fleet scale the monitor feeds the scheduler; here it
counts).  A failure is a ``RuntimeError``: a CUDA out-of-memory error is
one, so it is retried like any other and raised again once the retries are
spent.  Only a failure raised before the optimizer writes is retried: the
step updates the parameters and moments in place (the reference donates
them), so one that fails after a first write raises
``optimizer.PartialUpdateError``, which the loop does not catch (the
reference's donated buffers are gone after a failed step too), and the
``float(loss)`` that waits for a step runs after the retried block.  The
checkpoint layout is mesh-independent (``train/checkpoint``), so a restart
may use another device or another mesh: under a mesh the initial or
restored state is laid out by the step's shardings (the batch is drawn
whole on every rank and the step takes its rows).

Fresh parameters are ``model.init`` from a ``torch.Generator`` seeded 0 on
the device; a resume restores the checkpoint onto the device without
drawing them.  A step's time is taken around the step and the
``float(loss)`` that waits for it.
"""
from __future__ import annotations

import os
import tempfile
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch import _device
from repro_torch.data import pipeline as dpipe
from repro_torch.distributed import sharding as shd
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import optimizer as opt_mod
from repro_torch.train import trainstep


@dataclass
class LoopConfig:
    total_steps: int = 100
    ckpt_every: int = 50
    ckpt_dir: str = field(default_factory=lambda: os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    max_retries: int = 3
    retry_backoff_s: float = 1.0
    straggler_deadline_factor: float = 3.0
    log_every: int = 10


@dataclass
class LoopState:
    step: int = 0
    losses: list = field(default_factory=list)
    step_times: list = field(default_factory=list)
    restarts: int = 0
    straggler_events: int = 0


def train(model, shape, mesh=None, opt_cfg=None,
          loop_cfg: LoopConfig | None = None, data_seed: int = 0,
          fail_injector=None, device=None) -> LoopState:
    """Run (or resume) training on ``device`` (default: the CUDA device);
    returns the loop state."""
    dev = _device.resolve(device)
    loop_cfg = loop_cfg or LoopConfig()
    cfg = model.cfg
    opt_cfg = opt_cfg or opt_mod.OptConfig(total_steps=loop_cfg.total_steps)
    step_fn, in_sh, _, _ = trainstep.build_train_step(model, shape, mesh,
                                                      opt_cfg=opt_cfg)
    dcfg = dpipe.DataConfig(cfg.vocab_size, shape.seq_len,
                            shape.global_batch, seed=data_seed)
    state = LoopState()

    # ---- init or resume ---------------------------------------------------
    last = ckpt.latest_step(loop_cfg.ckpt_dir)
    if last is None:
        params = model.init(torch.Generator(device=dev).manual_seed(0))
        opt_state = opt_mod.init(params)
        if in_sh is not None:
            params = shd.place_tree(params, in_sh[0])
            opt_state = shd.place_tree(opt_state, in_sh[1])
    else:
        structs = model.param_structs()
        sh = ({"params": in_sh[0], "opt": in_sh[1]} if in_sh is not None
              else None)
        params, opt_state, manifest = ckpt.restore(
            loop_cfg.ckpt_dir, last, structs, opt_mod.init(structs),
            device=dev, shardings=sh)
        state.step = manifest["step"]
        state.restarts += 1

    median_t = None
    while state.step < loop_cfg.total_steps:
        step = state.step
        batch = dpipe.batch_at(dcfg, step, dev)
        batch.update(dpipe.extra_inputs(cfg, shape.global_batch, data_seed,
                                        step, dev))
        if cfg.family == "vlm":
            P = cfg.num_patches
            batch["tokens"] = batch["tokens"][:, :shape.seq_len - P]
            batch["labels"] = batch["labels"][:, :shape.seq_len - P]

        for attempt in range(loop_cfg.max_retries + 1):
            try:
                if fail_injector is not None:
                    fail_injector(step, attempt)
                t0 = time.time()
                params, opt_state, metrics = step_fn(params, opt_state,
                                                     batch)
                break
            except RuntimeError:
                if attempt >= loop_cfg.max_retries:
                    raise
            # past the handler: the failed attempt's frames are released
            # before the wait
            time.sleep(loop_cfg.retry_backoff_s * (2 ** attempt))
            state.restarts += 1
        # the step's work is queued and the optimizer's writes with it: a
        # failure surfacing here is past the point of a retry
        loss = float(metrics["loss"])
        dt = time.time() - t0

        state.losses.append(loss)
        state.step_times.append(dt)
        if median_t and dt > loop_cfg.straggler_deadline_factor * median_t:
            state.straggler_events += 1  # fleet: report host to the scheduler
        if len(state.step_times) >= 5:
            median_t = float(np.median(state.step_times[-20:]))
        state.step += 1
        if state.step % loop_cfg.log_every == 0:
            print(f"step {state.step}: loss={loss:.4f} "
                  f"gnorm={float(metrics['grad_norm']):.3f} {dt*1e3:.0f}ms")
        if state.step % loop_cfg.ckpt_every == 0 \
                or state.step == loop_cfg.total_steps:
            ckpt.save(loop_cfg.ckpt_dir, state.step, params, opt_state,
                      extra={"loss": loss})
    return state
