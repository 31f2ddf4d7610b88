#!/usr/bin/env python3
"""Time the engine scan's collect build of one tree on the card.

    python3 scripts/collect_path_timing.py [--src DIR] [--label NAME]

``DIR`` is a tree's ``src`` directory (default: this repository's); its
``repro_torch`` is imported and its ``csrc/engine_scan.cu`` built into that
tree's own ``build/``.  To compare two trees on one card, unpack the other
into a git-ignored directory (``git archive``) and run this script once per
tree in one chip call, in turns (parent, change, change, parent).

Prints, each line led by ``NAME``:

* the build's ptxas lines of the scan's two instantiations;
* the study's 168 lanes (the seven RiVec apps x Table 10, longest lane
  31,520 records): the collect call (``engine_scan.scan_collect``: its
  pre-pass, the zeroed timeline and its scan) and the default call
  (``engine_scan.scan``), device ms from CUDA events (median of 10 samples
  of 3 calls), timed in turns, and cycles a step at the max SM clock;
* the profiler's path (``chip_smoke.py`` phase 9: ``telemetry --smoke
  --scorecard`` and ``module_stress``), twice (cold bodies, then warm):
  each collect call's device time with its T, their sum and median, the
  path's wall time and the host split of one
  ``engine.simulate(collect_stats=True)``.
"""
from __future__ import annotations

import argparse
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the src directory of the tree to time")
    ap.add_argument("--label", default="this tree")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("collect_path_timing: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.src).resolve()))
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs
    from repro_torch import _build
    from repro_torch.configs import vector_engine as ve
    from repro_torch.core import engine as eng
    from repro_torch.core import suite, tracegen
    from repro_torch.kernels import engine_scan
    label = args.label
    dev = torch.device("cuda")
    clock_hz = float(cs.nvidia_smi("clocks.max.sm").split()[0]) * 1e6
    print(f"{label}: {cs.nvidia_smi('name,power.limit')}; src "
          f"{Path(engine_scan.__file__).resolve().parents[2]}")
    report = _build.build_all(("engine_scan",))
    for kind, entry in (("default", "engine_scan_kernelILb0E"),
                        ("collect", "engine_scan_kernelILb1E")):
        print(f"{label}: {kind} build: "
              f"{cs.entry_lines(report, 'engine_scan', entry)}")

    pairs = [(a, c) for a in tracegen.RIVEC_APPS for c in ve.TABLE10]
    inp = suite.scan_inputs(pairs, device=dev)
    T = int(inp.n_steps.max())
    calls = {"collect": lambda: engine_scan.scan_collect(*inp.args()),
             "default": lambda: engine_scan.scan(*inp.args())}
    ms = {name: [] for name in calls}
    for name in list(calls) + list(calls)[::-1]:
        ms[name].append(cs.cuda_ms(torch, calls[name], reps=10, per=3))
    for name, v in ms.items():
        m = statistics.median(v)
        print(f"{label}: 168-lane {name} call "
              f"{' / '.join(f'{x:.4f}' for x in v)} ms in turns "
              f"({m * 1e-3 * clock_hz / T:.1f} cycles a step at "
              f"{clock_hz / 1e6:.0f} MHz, T_max {T})")
    # first in a fresh process (cold bodies), then as chip_smoke.py's phase
    # 9 meets it, after the study built them
    cs.profiler_phase(torch, eng, engine_scan, dev, label=f"{label} cold")
    cs.profiler_phase(torch, eng, engine_scan, dev, label=f"{label} warm")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
