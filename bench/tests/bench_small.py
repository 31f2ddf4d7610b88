"""Small cells for the CPU tests: a cell of ``BENCHMARK.json`` at tiny
widths in float32 with a tiny traffic mix, run through the harness on the
host (the harness's look for a card skipped)."""
from __future__ import annotations

import contextlib
import copy
import io
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT / "bench", ROOT / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

import torch  # noqa: E402

from yardstick import manifest  # noqa: E402
from yardstick.main import main  # noqa: E402

SEED = 4000000123          # more than 32 signed bits hold

# the tests run in several workers at once: few threads each
torch.set_num_threads(2)


def tiny_program(program: dict) -> dict:
    p = copy.deepcopy(program)
    moe = p.get("num_experts", 0) > 0
    p.update(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
             head_dim=16, d_ff=32 if moe else 128, vocab_size=300,
             dtype="float32", cache_dtype="float32", remat=False)
    if moe:
        p.update(num_experts=4, experts_per_token=2)
    return p


def tiny_mix(mix: dict) -> dict:
    m = copy.deepcopy(mix)
    if m["kind"] == "train":
        m.update(batch=2, seq=32, batches=6)
    else:
        m.update(max_seq=64, waves=16, cycle_waves=8,
                 length=dict(m["length"], median=20, min=4, max=48))
    return m


def small_cell(workload: str, root: Path = ROOT, limits=None):
    """The cell ``workload`` at tiny widths; its limits are the cell's own
    unless ``limits`` is given."""
    cell = manifest.load_cell(root, workload)
    cfg = copy.deepcopy(cell.config)
    cfg["program"] = tiny_program(cfg["program"])
    return manifest.Cell(cell.root, cell.manifest, cell.workload, cfg,
                         tiny_mix(cell.traffic),
                         cell.limits if limits is None else limits)


def run_small(workload: str, *, seconds: float = 1.0, trace: int = 0,
              seed: int = SEED, root: Path = ROOT, cell=None, limits=None,
              device: str = "cpu"):
    """(exit code, the result line as a dict or None, standard error)."""
    if cell is None:
        cell = small_cell(workload, root, limits)
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(["--workload", workload, "--seed", str(seed), "--seconds",
                   str(seconds), "--trace", str(trace)],
                  t_start=time.perf_counter(), root=root,
                  device=torch.device(device), cell=cell,
                  held=set(sys.modules))
    lines = [x for x in out.getvalue().splitlines() if x.startswith("{")]
    return rc, (json.loads(lines[-1]) if lines else None), err.getvalue()


def workloads(kind: str | None = None, root: Path = ROOT) -> list[str]:
    man = manifest.load_manifest(root)
    out = []
    for w in man["workloads"]:
        if kind is None:
            out.append(w["name"])
            continue
        mix = json.loads((root / "bench" / "traffic" /
                          f"{w['traffic']}.json").read_text())
        if mix["kind"] == kind:
            out.append(w["name"])
    return out
