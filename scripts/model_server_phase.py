#!/usr/bin/env python3
"""``chip_smoke.py``'s phase 13, the model server, alone on one CUDA card.

    python3 scripts/model_server_phase.py   # from the root

Builds the two attention libraries (flash attention, flash decoding) and
runs ``chip_smoke.model_server_phase``: llama3-8b whole in bfloat16
through ``ServeEngine`` (the launcher's defaults, then the long-prompt
round), the nine other configs at their published widths, the kernel
route against the plain route, and the two kernels at the long round's
shapes.  Prints the card's name and power limit first and the phase's
launches and kernel rows as one JSON line last.  Exits nonzero where
phase 13 fails.
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
        print("model_server_phase: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch import _build
    from repro_torch.kernels import decode_attention as da_mod
    from repro_torch.kernels import flash_attention as fa_mod
    from repro_torch.kernels import ref
    print(cs.nvidia_smi("name,power.limit"))
    t0 = time.perf_counter()
    _build.load("flash_attention")
    _build.load("decode_attention")
    print(f"build {time.perf_counter() - t0:.1f} s")
    clock = float(cs.nvidia_smi("clocks.max.sm").split()[0]) * 1e6
    torch.backends.cuda.matmul.allow_tf32 = False
    out = cs.model_server_phase(torch, ref, fa_mod, da_mod,
                                torch.device("cuda"), clock)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
