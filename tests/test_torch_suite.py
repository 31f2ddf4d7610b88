"""Port parity: the scalar baseline, the suite and the paper's study.

The port runs with ``device="cpu"`` (the plain PyTorch scan).  Bars:
scalar-pipeline results bitwise equal to the reference (the six-step fold
is the same float32 arithmetic, uncontracted on both sides); speedups
within rel 1e-6 of the live reference (its jitted engine step contracts
some ``a + b * c`` into FMAs, see ``test_torch_engine.py``); the 168 RiVec
cells of ``tests/golden_sweep.json`` at the reference's own rtol 1e-2
(``scripts/gen_golden_sweep.py``); the 11 §5 anchors in their bands.
"""
import dataclasses
import json
import os

import pytest

from repro.core import characterize as ref_ch
from repro.core import engine as ref_eng
from repro.core import scalar_pipeline as ref_sp
from repro.core import suite as ref_suite
from repro.core import tracegen as ref_tg
from repro.core.anchors import ANCHORS as REF_ANCHORS
from repro_torch.configs import vector_engine as ve
from repro_torch.core import anchors, characterize, engine as eng
from repro_torch.core import scalar_pipeline as sp
from repro_torch.core import suite, tracegen

GOLDEN = os.path.join(os.path.dirname(__file__), "golden_sweep.json")
GOLDEN_RTOL = 1e-2          # scripts/gen_golden_sweep.py:RTOL
APPS = tracegen.RIVEC_APPS
CORES = [dict(), dict(issue_width=1), dict(fusion=True),
         dict(issue_width=3, fusion=True, branch_miss_penalty=2.0)]


@pytest.fixture(scope="module")
def study():
    """The paper's RiVec study through the port: 7 apps x Table 10 (168
    cells; the ML apps and ``:asm`` variants: ``test_torch_study_ml.py``)."""
    return suite.sweep_all(APPS, device="cpu")


# ------------------------------------------------------------ scalar baseline

@pytest.mark.parametrize("kw", CORES, ids=lambda kw: str(sorted(kw)))
def test_scalar_runtime_matches_reference_bitwise(kw):
    for app in APPS:
        c, rc = eng.VectorEngineConfig(**kw), ref_eng.VectorEngineConfig(**kw)
        assert sp.scalar_runtime_ns(app, c) == ref_sp.scalar_runtime_ns(app, rc)
        assert sp.scalar_events(app, c) == ref_sp.scalar_events(app, rc)
        assert (sp.segments_for(app) == ref_sp.segments_for(app)).all()


def test_scalar_batch_equals_sequential_bitwise():
    cfgs = [eng.VectorEngineConfig(issue_width=1 + i % 3,
                                   branch_miss_penalty=float(4 + 2 * (i % 4)),
                                   fusion=bool(i % 2))
            for i in range(len(APPS))]
    assert sp.scalar_runtime_ns_batch(list(APPS), cfgs) == \
        [sp.scalar_runtime_ns(a, c) for a, c in zip(APPS, cfgs)]


# ------------------------------------------------------------ characterization

@pytest.mark.parametrize("app", APPS)
def test_characterization_matches_reference_and_paper(app):
    """Rows equal the reference's exactly; every published cell within the
    reference's bars (tests/test_characterize.py: 1.1%, canneal 8%)."""
    assert characterize.table(app) == ref_ch.table(app)
    assert characterize.compare_to_paper(app) == ref_ch.compare_to_paper(app)
    tol = 0.08 if app == "canneal" else 0.011
    for row in characterize.compare_to_paper(app):
        for k, v in row.items():
            if k.startswith("err"):
                assert v <= tol, (app, row["mvl"], k, v)


# ------------------------------------------------------------ suite arithmetic

def test_vector_runtime_derivation_matches_reference_bitwise():
    """The host-side derivation keeps numpy's float32 promotion."""
    for app in APPS:
        for kw in (dict(mvl=8, lanes=1), dict(mvl=256, lanes=4, issue_width=1),
                   dict(mvl=128, lanes=2, scalar_freq_ghz=3.0)):
            c, rc = eng.VectorEngineConfig(**kw), ref_eng.VectorEngineConfig(**kw)
            body = tracegen.body_for(app, suite.effective_mvl(app, c), c)
            rbody = ref_tg.body_for(app, ref_suite.effective_mvl(app, rc), rc)
            for per_chunk in (123.456, 7.0, 1e4 / 3):
                assert suite.vector_runtime_from_per_chunk(
                    app, c, body, per_chunk) == \
                    ref_suite.vector_runtime_from_per_chunk(
                        app, rc, rbody, per_chunk)


def test_speedups_match_live_reference():
    """Speedups (and utilizations) of five apps x knob variants against the
    live reference, rel <= 1e-6."""
    kws = [dict(mvl=8, lanes=1), dict(mvl=64, lanes=4, ooo_issue=True),
           dict(mvl=256, lanes=8, interconnect="crossbar", l2_kb=1024),
           dict(mvl=16, lanes=2, mshrs=1, issue_width=1),
           dict(mvl=128, lanes=8, fusion=True, queue_entries=8)]
    apps = ("canneal", "jacobi-2d", "pathfinder", "streamcluster", "swaptions")
    pairs = [(a, kw) for a in apps for kw in kws]
    got = suite.speedup_util_batch(
        [(a, eng.VectorEngineConfig(**kw)) for a, kw in pairs], device="cpu")
    want = ref_suite.speedup_util_batch(
        [(a, ref_eng.VectorEngineConfig(**kw)) for a, kw in pairs])
    for (a, kw), g, w in zip(pairs, got, want):
        for k in w:
            assert abs(g[k] - w[k]) <= 1e-6 * abs(w[k]), (a, kw, k, g[k], w[k])
    plain = suite.speedup_batch(
        [(a, eng.VectorEngineConfig(**kw)) for a, kw in pairs], device="cpu")
    assert plain == [r["speedup"] for r in got]


# ------------------------------------------------------------ the study

@pytest.mark.parametrize("app", APPS)
def test_golden_sweep_cells(study, app):
    """All 24 Table-10 cells of each RiVec app against the golden table at
    rtol 1e-2 (observed: within its 6-decimal rounding)."""
    golden = json.load(open(GOLDEN))[app]
    assert len(study[app]) == 24
    for (m, l), s in study[app].items():
        want = golden[f"{m}x{l}"]
        assert abs(s - want) <= GOLDEN_RTOL * abs(want), (app, m, l, s, want)


@pytest.mark.parametrize("app,mvl,lanes,target,kind", anchors.ANCHORS)
def test_anchor_in_band(study, app, mvl, lanes, target, kind):
    got = study[app][(mvl, lanes)]
    if kind == "eq":
        assert anchors.EQ_LO <= got / target <= anchors.EQ_HI, (app, got)
    else:
        assert got <= target * anchors.LT_SLACK, (app, got)


def test_anchor_table_matches_reference():
    assert anchors.ANCHORS == REF_ANCHORS


def test_study_entry_points_agree(study):
    """sweep / speedup / sweep_all give one cell the same value, bitwise,
    and the Table-10 grid is the study's grid."""
    assert [(c.mvl, c.lanes) for c in ve.TABLE10] == list(study["jacobi-2d"])
    one = suite.sweep("jacobi-2d", mvls=(8, 256), lanes=(1,), device="cpu")
    assert one[(8, 1)] == study["jacobi-2d"][(8, 1)]
    assert one[(256, 1)] == study["jacobi-2d"][(256, 1)]
    assert suite.speedup("pathfinder", eng.VectorEngineConfig(mvl=8, lanes=1),
                         device="cpu") == study["pathfinder"][(8, 1)]
    assert all(dataclasses.replace(c, l2_kb=1024) == c2 for c, c2 in
               zip(ve.TABLE10, ve.TABLE10_L2_1MB))
    assert all(c.mshrs == 1 for c in ve.TABLE10_MSHR1)


def test_scan_inputs_are_the_launch_speedup_batch_makes():
    """``scan_inputs`` packs the operands ``steady_state_time_batch`` runs:
    the scan over them gives the same steady-state times, bitwise."""
    pairs = [("swaptions", eng.VectorEngineConfig(mvl=8, lanes=2)),
             ("blackscholes:asm", eng.VectorEngineConfig(mvl=64, lanes=4))]
    out = eng._run(suite.scan_inputs(pairs, device="cpu"))
    got = [(float(out[0, b]) - float(out[5, b])) / 24
           for b in range(len(pairs))]
    bodies = [tracegen.body_for(a, suite.effective_mvl(a, c), c)
              for a, c in pairs]
    assert got == eng.steady_state_time_batch(
        bodies, [c for _, c in pairs], device="cpu")


def test_clear_caches_gives_a_cold_run_with_the_same_answers():
    """After ``clear_caches`` bodies and scalar baselines are built anew
    (fresh objects) and the sweep's answers are bitwise unchanged."""
    warm = suite.sweep("swaptions", mvls=(8, 64), lanes=(2,), device="cpu")
    cfg = eng.VectorEngineConfig(mvl=8, lanes=2)
    body = tracegen.body_for("swaptions", 8, cfg)
    suite.clear_caches()
    assert sp._runtime_cached.cache_info().currsize == 0
    assert tracegen.body_for("swaptions", 8, cfg) is not body
    suite.clear_caches()
    assert suite.sweep("swaptions", mvls=(8, 64), lanes=(2,),
                       device="cpu") == warm


def test_readme_quickstart_claims():
    """A narrower scalar core raises blackscholes' speedup; a 1 MB LLC
    helps the memory-bound streamcluster."""
    cfg = eng.VectorEngineConfig(mvl=64, lanes=4)
    narrow = eng.VectorEngineConfig(mvl=64, lanes=4, issue_width=1)
    big = eng.VectorEngineConfig(mvl=64, lanes=4, l2_kb=1024)
    bs, bs_narrow, sc, sc_big = suite.speedup_batch(
        [("blackscholes", cfg), ("blackscholes", narrow),
         ("streamcluster", cfg), ("streamcluster", big)], device="cpu")
    assert bs_narrow > bs and sc_big > sc
