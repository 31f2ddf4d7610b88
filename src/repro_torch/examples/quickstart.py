"""Quickstart: build an assigned architecture, train a few steps, serve it.

    PYTHONPATH=src python -m repro_torch.examples.quickstart \\
        [--arch llama3-8b] [--steps 12] [--device cpu]

The port of ``examples/quickstart.py``: the reduced (smoke) config trained
for ``--steps`` steps on the synthetic pipeline (batch 8 x 32 tokens),
then freshly initialized weights (seed 0) served greedily through
``serve.engine.serve_batch``, two prompts, 8 new tokens, ``max_seq`` 32;
whisper's frames and InternVL2's patches are standard normals from seed 5.
The default device is the CUDA device; ``--device cpu`` runs the plain
PyTorch path.
"""
from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np
import torch

from repro_torch import _device
from repro_torch.configs import get_config
from repro_torch.configs.base import InputShape
from repro_torch.models import build
from repro_torch.serve.engine import serve_batch
from repro_torch.train.loop import LoopConfig, train


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--steps", type=int, default=12)
    ap.add_argument("--ckpt", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_quickstart_ckpt"))
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)

    dev = _device.resolve(args.device)
    cfg = get_config(args.arch).smoke()
    model = build(cfg)
    print(f"== {args.arch} (reduced: d={cfg.d_model}, "
          f"L={cfg.num_layers}) ==")

    # --- train a few steps on the synthetic pipeline -------------------------
    shape = InputShape("quickstart", seq_len=32, global_batch=8,
                       kind="train")
    state = train(model, shape, mesh=None,
                  loop_cfg=LoopConfig(total_steps=args.steps,
                                      ckpt_every=args.steps,
                                      ckpt_dir=args.ckpt, log_every=4),
                  device=dev)
    print(f"loss: {state.losses[0]:.3f} -> {state.losses[-1]:.3f}")

    # --- serve it -------------------------------------------------------------
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    prompts = [np.arange(6, dtype=np.int32),
               np.arange(10, 14, dtype=np.int32)]
    extra = None
    n = {"encdec": cfg.num_frames, "vlm": cfg.num_patches}.get(cfg.family)
    if n is not None:
        g = torch.Generator(device=dev).manual_seed(5)
        x = torch.randn(2, n, cfg.d_model, generator=g, device=dev)
        extra = {"frames" if cfg.family == "encdec" else "patches": x}
    outs = serve_batch(model, params, prompts, max_new_tokens=8,
                       max_seq=32, extra=extra)
    for p, o in zip(prompts, outs):
        print("prompt", p.tolist(), "->", o)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
