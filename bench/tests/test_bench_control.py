"""The control comes out as not correct: the plain reference computed with
every product's operands in float8 e4m3, put in the program's place, read
by the cell's own comparison against the float32 reference and judged by
the cell's own limits (at tiny widths here; at the cell's size on the card
by ``bench/tools/readings.py --control-seeds``)."""
import sys
import time

import pytest
import torch

from bench_small import ROOT, small_cell, workloads
from yardstick import checks, timer
from yardstick.main import Run

sys.path.insert(0, str(ROOT / "bench" / "tools"))
import readings  # noqa: E402

CPU = torch.device("cpu")


@pytest.mark.parametrize("seed", [11, 4000000123, 2 ** 33 + 1])
@pytest.mark.parametrize("cell", workloads())
def test_the_control_fails_the_cells_limits(cell, seed):
    sc = small_cell(cell)
    run = Run(sc, seed, 0.1, False, CPU, time.perf_counter(), timer.Spans(CPU))
    got = readings.control(run, sc)
    ok, table = checks.judge(got["control"], sc.limits)
    assert not ok, table
    if "half_batch" in got:
        ok, table = checks.judge(got["half_batch"], sc.limits)
        assert not ok, table
