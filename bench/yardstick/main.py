"""One run of one cell: set-up, the measured window, the check, the line.

``python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace
<0|1>``.  With ``--trace 0`` the line's metrics are the cell's end-to-end
metrics; with ``--trace 1`` the window runs under ``torch.profiler`` with
the per-layer metrics' spans on, and the line holds the per-layer metrics
(each read by its reader, ``bench/metrics/<name>.py``; one that finds
nothing to read is left out), ``device.busy_s`` / ``window_s`` and the
``breakdown``.  Every run checks what its window produced against the
plain reference and prints each compared number beside its limit, last on
standard error and last in the line (``checks``).
"""
from __future__ import annotations

import argparse
import gc
import importlib
import json
import sys
from dataclasses import dataclass, field
from pathlib import Path

import torch

from yardstick import checks, device as D, manifest, timer


@dataclass
class Run:
    cell: manifest.Cell
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t_start: float
    spans: timer.Spans


@dataclass
class Record:
    """What a per-layer reader reads: the configuration's widths, the
    trace, the spans, the harness's counters and its counts of the work the
    traced window did."""
    arch: dict
    trace: timer.Trace | None
    spans: timer.Spans
    counters: dict = field(default_factory=dict)
    work: dict = field(default_factory=dict)


@dataclass
class Outcome:
    attempted: int
    failed: int
    end_to_end: dict
    numbers: dict
    peak_bytes: int
    record: Record
    smi_before: dict
    smi_after: dict


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def free(device: torch.device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


def main(argv=None, *, t_start: float, root: Path, device=None,
         cell: manifest.Cell | None = None, held=()) -> int:
    """Runs the cell; prints the result line; returns the exit code.
    ``device``, ``cell`` and ``held`` are for the CPU tests (a cell of
    small widths on the host, in a test process that may already hold JAX
    from other tests: the modules ``held`` are not the run's); a run on
    the card leaves them unset."""
    args = parse(argv)
    if cell is None:
        cell = manifest.load_cell(root, args.workload)
    if device is None:
        device = D.require_cards(cell.workload["chips"])
    kind = importlib.import_module(f"yardstick.kinds.{cell.traffic['kind']}")
    run = Run(cell, args.seed, args.seconds, bool(args.trace), device,
              t_start, timer.Spans(device))
    readers = []
    if run.trace:
        for m in cell.per_layer():
            mod = manifest.load_reader(root, m["name"])
            if hasattr(mod, "install"):
                mod.install(run.spans)
            readers.append((m, mod))
    out: Outcome = kind.run(run)
    free(device)
    found = D.loaded_forbidden(set(sys.modules) - set(held))
    if found:
        print(f"the run loaded {found}: the benchmark runs the port alone",
              file=sys.stderr)
        return 3
    ok, table = checks.judge(out.numbers, cell.limits)
    correct = ok and out.failed == 0 and out.attempted > 0
    dev = D.describe(device, 1, out.peak_bytes, out.smi_before, out.smi_after)
    line = {"correct": correct, "attempted": out.attempted,
            "failed": out.failed}
    if run.trace:
        metrics = {}
        for m, mod in readers:
            v = mod.read(out.record)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        tr = out.record.trace
        dev["busy_s"] = tr.busy_s
        dev["window_s"] = tr.window_s
        line["metrics"] = metrics
        line["device"] = dev
        line["breakdown"] = {"device_ops": tr.top_ops,
                             "idle_gaps": tr.idle_by_host}
    else:
        line["metrics"] = {m["name"]: {"value": float(out.end_to_end[m["name"]]),
                                       "unit": m["unit"]}
                           for m in cell.end_to_end()}
        line["device"] = dev
    line["checks"] = table
    checks.report(table, checks.readings(out.numbers, cell.limits))
    print(json.dumps(line), flush=True)
    return 0
