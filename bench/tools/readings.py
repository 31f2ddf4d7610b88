"""Readings that set a cell's limits (never run by the benchmark's runs).

    python3 bench/tools/readings.py --workload <cell> --seeds <n> ... \\
        [--seconds 2] [--control-seeds <n> ...]

For each of ``--seeds``: one run of the cell in this process (set-up, a
short window, the check), its compared numbers printed as a JSON line
(``{"seed", "numbers"}``): the sound program's readings, the lower ends
of the limits.  For each of ``--control-seeds``: the control, the plain
reference computed with every product's operands in float8 e4m3 put in the
program's place, compared with the float32 reference by the same numbers
(``"control"``); for a training cell also the fault of half of each batch
left out, the mean taken over the rest (``"half_batch"``).  The control
and the faults are read at the cell's own sizes on the card.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT / "bench"))
sys.path.insert(0, str(ROOT / "src"))

import importlib  # noqa: E402

import torch  # noqa: E402

from yardstick import device as D, manifest, timer, traffic  # noqa: E402
from yardstick.main import Run, free  # noqa: E402


def emit(**kw):
    print(json.dumps(kw), flush=True)


def train_control(run, cell):
    from yardstick.kinds import train as K
    a, mix = cell.config["program"], cell.traffic
    from repro_torch.configs.base import torch_dtype
    dtype = torch_dtype(a["dtype"])
    host = traffic.train_batches(dict(mix, batches=mix["checked_steps"]),
                                 run.seed, a["vocab_size"])
    ref = K.reference_readings(run, a, mix, host, dtype)
    ctl = K.reference_readings(run, a, mix, host, dtype, mode="fp8")
    half = K.reference_readings(run, a, mix, host, dtype, half=True)
    return {"control": K.compare(ctl, ref), "half_batch": K.compare(half, ref)}


def serve_control(run, cell):
    from yardstick.kinds import prefill_waves as K
    a, mix = cell.config["program"], cell.traffic
    from repro_torch.configs.base import torch_dtype
    dtype = torch_dtype(a["dtype"])
    V = a["vocab_size"]
    cycle = [traffic.wave_prompts(mix, run.seed, k, V)
             for k in range(mix["cycle_waves"])]
    waves = [cycle[i] for i in K.checked_waves(
        [list(map(len, w)) for w in cycle], run.seed, mix["checked_waves"])]
    ref = K.reference_logits(run, a, waves, dtype)
    ctl = K.reference_logits(run, a, waves, dtype, mode="fp8")
    sample = [(w, [int(x) for x in c.argmax(-1)], c) for w, c in zip(waves, ctl)]
    return {"control": K.compare(sample, ref)}


def control(run, cell) -> dict:
    """The control's numbers (and a training cell's half-batch fault's) on
    ``run``'s seed and device."""
    return (train_control if cell.traffic["kind"] == "train"
            else serve_control)(run, cell)


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    args = p.parse_args()
    cell = manifest.load_cell(ROOT, args.workload)
    dev = D.require_cards(cell.workload["chips"])
    kind = importlib.import_module(f"yardstick.kinds.{cell.traffic['kind']}")
    for seed in args.seeds:
        t0 = time.perf_counter()
        run = Run(cell, seed, args.seconds, False, dev, t0, timer.Spans(dev))
        out = kind.run(run)
        free(dev)
        emit(seed=seed, numbers=out.numbers, failed=out.failed,
             attempted=out.attempted, seconds=time.perf_counter() - t0)
    for seed in args.control_seeds:
        run = Run(cell, seed, args.seconds, False, dev, time.perf_counter(),
                  timer.Spans(dev))
        emit(seed=seed, **control(run, cell))
        free(dev)
    torch.cuda.synchronize()


if __name__ == "__main__":
    main()
