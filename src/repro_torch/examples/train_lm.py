"""End-to-end LM training example.

    PYTHONPATH=src python -m repro_torch.examples.train_lm [--full] \\
        [--steps N] [--device cpu]

The port of ``examples/train_lm.py``: a ~10M-parameter llama-style model
(lm-10m) for 60 steps by default, ``--full`` the ~100M-parameter one
(lm-100m) for 300 steps, both through the real trainer (step builder,
checkpoint / restart, seekable data, straggler and retry logic), and the
assert that the loss falls.  The default device is the CUDA device;
``--device cpu`` runs the plain PyTorch path.  A ``--ckpt`` directory that
holds a checkpoint is resumed from.
"""
from __future__ import annotations

import argparse
import os
import tempfile

from repro_torch import _device
from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.models import build
from repro_torch.models import layers as L
from repro_torch.train.loop import LoopConfig, train


def small_cfg():
    # ~10M params
    return ModelConfig(
        name="lm-10m", family="dense", num_layers=4, d_model=256, num_heads=8,
        num_kv_heads=4, head_dim=32, d_ff=1024, vocab_size=8192,
        dtype="float32", remat=False)


def full_cfg():
    # ~100M params (GPT-2-medium-ish)
    return ModelConfig(
        name="lm-100m", family="dense", num_layers=12, d_model=768,
        num_heads=12, num_kv_heads=12, head_dim=64, d_ff=3072,
        vocab_size=32768, dtype="float32", remat=False)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--ckpt", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_lm_ckpt"))
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)

    dev = _device.resolve(args.device)
    cfg = full_cfg() if args.full else small_cfg()
    steps = args.steps or (300 if args.full else 60)
    model = build(cfg)
    n_params = sum(t.numel() for t in L.tree_leaves(model.param_structs()))
    print(f"== {cfg.name}: {n_params/1e6:.1f}M params, {steps} steps ==")

    shape = InputShape("train", seq_len=256 if args.full else 128,
                       global_batch=8, kind="train")
    state = train(model, shape, mesh=None,
                  loop_cfg=LoopConfig(total_steps=steps,
                                      ckpt_every=max(steps // 3, 1),
                                      ckpt_dir=args.ckpt, log_every=10),
                  device=dev)
    print(f"final loss {state.losses[-1]:.4f} "
          f"(start {state.losses[0]:.4f}); "
          f"median step "
          f"{sorted(state.step_times)[len(state.step_times)//2]*1e3:.0f} ms;"
          f" restarts={state.restarts} stragglers={state.straggler_events}"
          f" on {dev}")
    assert state.losses[-1] < state.losses[0], "did not learn"
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
