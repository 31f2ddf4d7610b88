"""Port parity: the Table-2 module-stress cross-check
(``repro_torch.module_stress``, the port of ``benchmarks/module_stress.py``)
with the engine on the CPU.

The differential derivation (static shares, busy fractions, the mshrs=1
slowdown) and the mechanistic one (the collect build's module fractions at
the Table-2 config and at mshrs=1) agree for ten of ten apps, and the
mechanistic rows equal the reference's ``telemetry.profile_app`` rows
(module fractions within 1e-5, the same top bottleneck) for the eight apps
whose bodies the reference builds on this JAX (its tracegen raises the
``'jit'`` FrontendError for decode_attention and ssd_scan, ROADMAP Queue 3).
"""
import pytest

from repro.core import engine as ref_eng
from repro.core import telemetry as ref_tel
from repro_torch import module_stress as ms
from repro_torch.core import tracegen

CPU = "cpu"
APPS = list(tracegen.APPS)
REF_APPS = [a for a in APPS if a not in ("decode_attention", "ssd_scan")]


@pytest.fixture(scope="module")
def rows():
    return ms.shares_all(APPS, device=CPU), ms.mechanistic_all(APPS,
                                                               device=CPU)


def test_checkmark_matrix_consistent(rows):
    assert ms.checkmarks(rows[0])


def test_mechanistic_and_differential_agree_for_all_ten(rows):
    diff, mech = rows
    assert len(diff) == len(mech) == 10
    assert ms.check_consistency(diff, mech) == []


def test_main_reports_consistent(rows, monkeypatch, capsys):
    """``main`` prints both tables and ends on the CONSISTENT line (the
    derivations are the fixture's, computed once)."""
    monkeypatch.setattr(ms, "shares_all", lambda apps, device=None: rows[0])
    monkeypatch.setattr(ms, "mechanistic_all",
                        lambda apps, device=None: rows[1])
    assert ms.main(["--device", CPU]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-1] == "mechanistic <-> differential: CONSISTENT (10/10 apps)"
    assert "Table-2 checkmark matrix: CONSISTENT" in lines


def test_main_reports_a_mismatch(rows, monkeypatch, capsys):
    """A broken derivation fails loudly: exit 1, the mismatch printed."""
    diff = {a: dict(r) for a, r in rows[0].items()}
    diff["blackscholes"]["manip_share"] = 0.5
    monkeypatch.setattr(ms, "shares_all", lambda apps, device=None: diff)
    monkeypatch.setattr(ms, "mechanistic_all",
                        lambda apps, device=None: rows[1])
    assert ms.main(["--device", CPU]) == 1
    out = capsys.readouterr().out
    assert "MISMATCH" in out and "blackscholes: interconnect" in out


@pytest.mark.parametrize("app", REF_APPS)
def test_mechanistic_rows_equal_the_reference(rows, app):
    mech = rows[1][app]
    for key, kw in (("default", {}), ("mshr1", {"mshrs": 1})):
        want = ref_tel.profile_app(
            app, ref_eng.VectorEngineConfig(mvl=64, lanes=4, **kw), tiles=16)
        got = mech[key]
        assert got["top"] == want["top"], (app, key)
        for m, v in want["modules"].items():
            assert abs(got["modules"][m] - v) <= 1e-5, (app, key, m)
        assert got["config"] == want["config"]
