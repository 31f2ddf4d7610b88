#!/usr/bin/env python3
"""Where a llama3-8b decode step's time goes, on one CUDA card.

    python3 scripts/decode_step_profile.py   # from the root

llama3-8b whole in bfloat16 (weights from seed 0 on the card), a prefill
of 4 x 9 seeded tokens into a 64-position cache, then twelve decode steps
each timed on the host clock to a synchronize, one step's host issue time
(the call's return, no synchronize), and three steps under
``torch.profiler`` (CPU and CUDA activities): the table of operators and
kernels by device time, and by host time (each footer's totals are the
three steps' device and host times; ``cudaLaunchKernel``'s count is the
launches).  Prints the
card's name and power limit, torch's and CUDA's versions first.
"""
from __future__ import annotations

import statistics
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
        print("decode_step_profile: no CUDA device", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.models import build
    print(cs.nvidia_smi("name,power.limit"), torch.__version__,
          torch.version.cuda)
    cfg = get_config("llama3-8b")
    model = build(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    g = torch.Generator(device="cuda").manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (4, 9), generator=g,
                         device="cuda", dtype=torch.int32)
    logits, cache = model.prefill(params, {"tokens": toks}, 64)
    tok = torch.argmax(logits[:, -1], -1)[:, None].to(torch.int32)
    times = []
    for t in range(12):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.decode_step(params, cache, tok, 9 + t)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    print("decode step ms", [f"{x:.2f}" for x in times], "median",
          f"{statistics.median(times):.2f}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model.decode_step(params, cache, tok, 30)
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    print(f"one step: host issue {(t1 - t0) * 1e3:.2f} ms, to the "
          f"synchronize {(time.perf_counter() - t0) * 1e3:.2f} ms")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for t in range(3):
            model.decode_step(params, cache, tok, 31 + t)
        torch.cuda.synchronize()
    ka = prof.key_averages()
    key = ("self_device_time_total"
           if hasattr(ka[0], "self_device_time_total")
           else "self_cuda_time_total")
    # each table's footer gives the device time of the 3 steps ("Self CUDA
    # time total") and the host's
    print(ka.table(sort_by=key, row_limit=25))
    print(ka.table(sort_by="self_cpu_time_total", row_limit=20))
    return 0


if __name__ == "__main__":
    sys.exit(main())
