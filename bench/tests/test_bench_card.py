"""On the card: a whole run of each cell at tiny widths through the
port's kernels (the first call builds them), correct, with the flash
kernels in its trace.  Skips on a host without a card; there, a run
exits without a result."""
import subprocess
import sys

import pytest
import torch

from bench_small import ROOT, run_small, workloads


@pytest.mark.cuda
@pytest.mark.parametrize("cell", workloads())
def test_a_tiny_run_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels run on the card")
    rc, line, err = run_small(cell, trace=1, device="cuda")
    assert rc == 0 and line["correct"] is True, err
    assert line["device"]["platform"] == "gpu"
    assert any(k.startswith("flash_fwd_roofline") for k in line["metrics"])


def test_without_a_card_a_run_exits_with_no_result():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    out = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", workloads()[0],
         "--seed", "2200000001", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert out.returncode != 0
    assert "{" not in out.stdout
    assert "no CUDA device" in out.stderr
