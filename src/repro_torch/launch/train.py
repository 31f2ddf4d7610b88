"""Training launcher.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b \\
        --smoke [--steps N] [--device cpu]

The port of ``repro/launch/train.py``: the loop of ``repro_torch.train``
(checkpoint / restart / retry) on one device.  ``--smoke`` trains the
reduced config on a batch of 8 x 32 tokens.  Without it the config trains
at its published widths on ``--shape``'s batch, with ``mesh=None``: one
card holds a qwen2.5-3b step at a few sequences of 4,096 tokens, but not
``train_4k``'s 1,048,576-token batch, which needs the sharded trainer
(``distributed/``, not ported yet).  The default device is the CUDA
device; ``--device cpu`` runs the plain PyTorch path.
"""
from __future__ import annotations

import argparse
import os
import tempfile

from repro_torch import _device
from repro_torch.configs import SHAPES, get_config
from repro_torch.configs.base import InputShape
from repro_torch.models import build
from repro_torch.train.loop import LoopConfig, train


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced config, 8 x 32 tokens a step")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--ckpt", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_ckpt"))
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)

    dev = _device.resolve(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
        shape = InputShape("smoke", 32, 8, "train")
    else:
        shape = SHAPES[args.shape]
    model = build(cfg)
    state = train(model, shape, None,
                  loop_cfg=LoopConfig(total_steps=args.steps,
                                      ckpt_every=max(args.steps // 4, 1),
                                      ckpt_dir=args.ckpt),
                  device=dev)
    print(f"done: {state.step} steps, final loss {state.losses[-1]:.4f}, "
          f"restarts {state.restarts} on {dev}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
