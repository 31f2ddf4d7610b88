"""Serving launcher: continuous batching of seeded requests.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b --smoke
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-3b \\
        --smoke --device cpu

The port of ``repro/launch/serve.py``, with its flags and defaults (batch
4, 8 requests of 3-9 seeded tokens, 8 new tokens, ``max_seq`` 64).  The
weights are drawn from seed 0 on the device, the stub frames / patches of
whisper and InternVL2 from seed 1.  ``--smoke`` serves the reduced
config.  The default device is the CUDA device (the model's attention on
the port's kernels); without one the launcher raises; ``--device cpu``
runs the plain PyTorch path.  The reference shards its serving over the
production mesh without ``--smoke``; in the port the prefill and decode
step builders of ``repro_torch.train.trainstep`` carry that mesh (a
``torchrun`` world, ``launch.mesh``), and this launcher serves on one
device.
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


def stub_inputs(cfg, batch_size: int, device, seed: int = 1):
    """The stubbed frontends' inputs: whisper's frame embeddings or
    InternVL2's patch embeddings, ``[batch, n, d_model]`` float32 from
    ``seed``; None for the other families."""
    n = {"encdec": cfg.num_frames, "vlm": cfg.num_patches}.get(cfg.family)
    if n is None:
        return None
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(batch_size, n, cfg.d_model, generator=g, device=device)
    return {"frames" if cfg.family == "encdec" else "patches": x}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch-size", type=int, default=4)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new-tokens", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)

    dev = _device.resolve(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    model = build(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    extra = stub_inputs(cfg, args.batch_size, dev)
    engine = ServeEngine(model, params, args.batch_size, max_seq=64,
                         extra=extra)
    rng = np.random.default_rng(0)
    for i in range(args.requests):
        engine.submit(Request(
            uid=i,
            prompt=rng.integers(0, cfg.vocab_size,
                                rng.integers(3, 10)).astype(np.int32),
            max_new_tokens=args.max_new_tokens))
    t0 = time.time()
    done = engine.run()
    tok = sum(len(r.out_tokens) for r in done)
    print(f"{len(done)} requests, {tok} tokens, "
          f"{tok / (time.time() - t0):.1f} tok/s on {dev}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
