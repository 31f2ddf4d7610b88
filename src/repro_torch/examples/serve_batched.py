"""Batched serving with continuous batching.

    PYTHONPATH=src python -m repro_torch.examples.serve_batched \\
        [--arch qwen2.5-3b] [--device cpu]

The port of ``examples/serve_batched.py``: the smoke config, 9 requests of
3-8 seeded tokens with budgets of 4-9 new tokens, batch 4, ``max_seq``
48.  The default device is the CUDA device; ``--device cpu`` runs the
plain PyTorch path.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import _device
from repro_torch.configs import get_config
from repro_torch.models import build
from repro_torch.serve.engine import Request, ServeEngine


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--requests", type=int, default=9)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)

    dev = _device.resolve(args.device)
    cfg = get_config(args.arch).smoke()
    model = build(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    eng = ServeEngine(model, params, batch_size=4, max_seq=48)
    rng = np.random.default_rng(0)
    for i in range(args.requests):
        plen = int(rng.integers(3, 9))
        eng.submit(Request(uid=i, prompt=rng.integers(
            0, cfg.vocab_size, size=plen).astype(np.int32),
            max_new_tokens=int(rng.integers(4, 10))))
    t0 = time.time()
    done = eng.run()
    dt = time.time() - t0
    total = sum(len(r.out_tokens) for r in done)
    print(f"served {len(done)} requests, {total} tokens in {dt:.1f}s "
          f"({total / dt:.1f} tok/s, smoke config on {dev})")
    for r in done[:4]:
        print(f"  req {r.uid}: prompt {r.prompt.tolist()} -> {r.out_tokens}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
