#!/usr/bin/env python3
"""``chip_smoke.py``'s phase 14, the trainer, alone on one CUDA card.

    python3 scripts/trainer_phase.py   # from the root

Builds the libraries the trainer's path runs (flash attention and its
backward kernel, flash decoding, the segment sum) and runs
``chip_smoke.trainer_phase``: qwen2.5-3b whole in bfloat16 (three steps
of B 2 x S 4,096, then one of two microbatches), the step's time split,
flash attention and its backward kernel at the training shape, the
embedding gradient's segment sum, the kernel route's gradients against
the plain route's, and the loop (train_lm and its resume, the retry,
quickstart, the launcher).  Prints the card's name and power limit first
and the phase's launches, rows and steps as one JSON line last (the
parameters phase 15 starts from are left out).  Exits nonzero where
phase 14 fails.
"""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    sys.stdout.reconfigure(line_buffering=True)
    import torch
    if not torch.cuda.is_available():
        print("trainer_phase: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch import _build
    from repro_torch.kernels import decode_attention as da_mod
    from repro_torch.kernels import flash_attention as fa_mod
    from repro_torch.kernels import ref
    print(cs.nvidia_smi("name,power.limit"))
    t0 = time.perf_counter()
    _build.build_all(("flash_attention", "flash_attention_bwd",
                      "decode_attention", "segment_sum"))
    print(f"build {time.perf_counter() - t0:.1f} s")
    clock = float(cs.nvidia_smi("clocks.max.sm").split()[0]) * 1e6
    out = cs.trainer_phase(torch, ref, fa_mod, da_mod, torch.device("cuda"),
                           clock)
    del out["after"]
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
