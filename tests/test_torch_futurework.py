"""Port parity: ``repro_torch.futurework_study`` against
``benchmarks/futurework_study.py``, and ``repro_torch.vector_engine_study``
against ``examples/vector_engine_study.py``.

The variant x app ratios are held to the reference's at rel <= 1e-6 (the
engine's standing bar, ROADMAP Queue 3) on the apps the reference builds:
it cannot lower decode_attention's and ssd_scan's kernel specs (JAX 0.9's
``'jit'`` primitive), so for those two the oracle is the committed golden
table (their baseline cell, MVL 64 x 4 lanes, at the golden table's rtol
1e-2) and each ratio's sanity.
"""
import json
import os
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "examples"))

from benchmarks import futurework_study as ref_fw  # noqa: E402
from repro_torch import futurework_study as fw  # noqa: E402
from repro_torch import vector_engine_study as ves  # noqa: E402
from repro_torch.core import suite, tracegen  # noqa: E402

JIT_APPS = ("decode_attention", "ssd_scan")
CAVEAT = ("the reference cannot lower this app's kernel spec (JAX 0.9's "
          "'jit' primitive, ROADMAP Queue 3): the golden table is the "
          "oracle")


@pytest.fixture(scope="module")
def table():
    return fw.study(device="cpu")


def test_variants_are_the_reference_s():
    assert fw.VARIANTS == ref_fw.VARIANTS
    assert vars(fw.BASE) == vars(ref_fw.BASE)


def test_ratios_match_reference(table):
    apps = [a for a in tracegen.APPS if a not in JIT_APPS]
    want = ref_fw.study(apps=apps)
    assert list(table) == list(want)
    for name, row in want.items():
        for app, w in row.items():
            g = table[name][app]
            assert abs(g - w) <= 1e-6 * abs(w), (name, app, g, w)


@pytest.mark.parametrize("app", JIT_APPS)
def test_caveat_apps_against_the_golden_table(table, app):
    golden = json.loads((ROOT / "tests" / "golden_sweep.json").read_text())
    base = suite.speedup(app, fw.BASE, device="cpu")
    want = golden[app][f"{fw.BASE.mvl}x{fw.BASE.lanes}"]
    assert abs(base - want) <= 1e-2 * abs(want), CAVEAT
    assert table["baseline(in-order,ring,1rp,1mp)"][app] == 1.0, CAVEAT
    for name, row in table.items():
        assert np.isfinite(row[app]) and row[app] > 0, (name, CAVEAT)
    assert table["all_upgrades"][app] >= 0.999, CAVEAT


def test_main_quick_prints_the_reference_table(capsys):
    assert fw.main(["--quick", "--device", "cpu"]) == 0
    got = capsys.readouterr().out
    assert ref_fw.main(["--quick"]) == 0
    assert got == capsys.readouterr().out


def test_vector_engine_study_matches_the_reference_example(capsys):
    """One app, line for line against the reference's example (which runs
    the apps it can lower: blackscholes here)."""
    import vector_engine_study as ref_ves
    assert ves.main(["--app", "blackscholes", "--device", "cpu"]) == 0
    got = capsys.readouterr().out
    argv = sys.argv
    try:
        sys.argv = ["vector_engine_study.py", "--app", "blackscholes"]
        ref_ves.main()
    finally:
        sys.argv = argv
    assert got == capsys.readouterr().out


def test_vector_engine_study_runs_end_to_end(capsys):
    """Every app x the 24 configs (one batch) and the LLC study."""
    assert ves.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    for app in tracegen.APPS:
        assert f"=== {app} (" in out
    assert out.count("  MVL=") == 6 * len(tracegen.APPS)
    assert "=== swaptions LLC study (paper Fig 10) ===" in out
    nums = [float(x) for ln in out.splitlines() if ln.startswith("  MVL=")
            for x in ln.split()[2:]]
    assert len(nums) == 24 * len(tracegen.APPS)
    assert all(np.isfinite(nums)) and min(nums) > 0
