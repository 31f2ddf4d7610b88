"""Port parity: the ML half of the paper's study and the ``:asm`` variants.

With the three ML apps (flash attention, flash decoding, the SSD scan) and
the ten ``"<app>:asm"`` RVV-corpus variants ported, the port's
``suite.sweep_all`` over the golden table's 20 names x Table 10 reproduces
all 480 cells of ``tests/golden_sweep.json`` at the reference's rtol 1e-2
(``scripts/gen_golden_sweep.py``).  This file checks the 312 cells the
earlier slices could not reach (3 ML apps + 10 ``:asm`` variants, 24 each);
``tests/test_torch_suite.py`` checks the RiVec 168.  One sweep, on the CPU
engine, serves every test here.  ``sweep_all()`` with no app list sweeps
the ten apps, as the reference's does.
"""
import json
import os

import numpy as np
import pytest

from repro.core import tracegen as ref_tg
from repro.core import workloads_ml as ref_ml
from repro_torch.configs import vector_engine as ve
from repro_torch.core import suite, tracegen, workloads_ml

GOLDEN = os.path.join(os.path.dirname(__file__), "golden_sweep.json")
GOLDEN_RTOL = 1e-2          # scripts/gen_golden_sweep.py:RTOL
ML_APPS = ("decode_attention", "flash_attention", "ssd_scan")
NEW_NAMES = ML_APPS + tracegen.ASM_APPS


@pytest.fixture(scope="module")
def study():
    """The golden table's 20 names x Table 10 through the port: 480 cells in
    one engine scan."""
    return suite.sweep_all(sorted(tracegen.APPS) + list(tracegen.ASM_APPS),
                           device="cpu")


@pytest.fixture(scope="module")
def golden():
    with open(GOLDEN) as f:
        return json.load(f)


def test_golden_table_names(golden):
    assert sorted(golden) == sorted([*tracegen.APPS, *tracegen.ASM_APPS])
    assert len(NEW_NAMES) == 13 and len(golden) == 20


@pytest.mark.parametrize("name", NEW_NAMES)
def test_golden_sweep_cells(study, golden, name):
    """All 24 Table-10 cells of each new name against the golden table at
    rtol 1e-2."""
    assert [(c.mvl, c.lanes) for c in ve.TABLE10] == list(study[name])
    for (m, l), s in study[name].items():
        want = golden[name][f"{m}x{l}"]
        assert np.isfinite(s)
        assert abs(s - want) <= GOLDEN_RTOL * abs(want), (name, m, l, s, want)


def test_sweep_all_defaults_to_the_ten_apps(study):
    """The reference's default (``repro/core/suite.py:148``): every app of
    the registry, in sorted order, not only the RiVec seven."""
    one = suite.sweep_all(mvls=(8, 256), lanes=(2,), device="cpu")
    assert list(one) == sorted(tracegen.APPS) == sorted(ref_tg.APPS)
    for app, cells in one.items():
        assert cells == {k: study[app][k] for k in ((8, 2), (256, 2))}


def test_flash_attention_counts_match_reference():
    """The ML counts are derived from the lowered chunk trace; the reference
    can still lower flash attention on JAX 0.9 (the other two specs raise
    there, ROADMAP Queue 3, and their counts feed the golden cells above)."""
    for mvl in (8, 64, 256):
        mine = tracegen.APPS["flash_attention"].counts(mvl)
        ref = ref_tg.APPS["flash_attention"].counts(mvl)
        assert mine.__dict__ == ref.__dict__
        assert tracegen.APPS["flash_attention"].chunks(mvl) == \
            ref_tg.APPS["flash_attention"].chunks(mvl)
    assert dict(tracegen.APPS["flash_attention"].mix.items()) == \
        dict(ref_tg.APPS["flash_attention"].mix.items())
    assert workloads_ml.NOTES == ref_ml.NOTES
