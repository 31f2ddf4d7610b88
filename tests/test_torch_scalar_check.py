"""Port parity: the scalar-scorecard gate and the sweep driver.

``scalar_pipeline.scalar_cycles`` is held to the reference's exactly, as
``tests/test_torch_suite.py`` holds ``scalar_runtime_ns`` and
``scalar_events``; ``scalar_pipeline.main(["--check"])`` runs the
reference's four gates (the 11 anchors, batched == sequential bitwise,
knob monotonicity, the CPI floor) on the CPU engine and must pass, and
fail where the fold is broken.  ``repro_torch.study`` prints
``benchmarks/run.py``'s sweep and steady-state rows; its steady-state
values are held to the reference's ``steady_state_time_batch`` on the same
bodies at rel <= 1e-6 (the standing FMA finding, ROADMAP Queue 3).
"""
import jax.numpy as jnp
import pytest

from repro.core import engine as ref_eng
from repro.core import frontend as ref_fe
from repro.core import isa as ref_isa
from repro.core import scalar_pipeline as ref_sp
from repro_torch import study
from repro_torch.core import engine as eng
from repro_torch.core import scalar_pipeline as sp
from repro_torch.core import suite, tracegen

APPS = sorted(tracegen.APPS)
KNOBS = [dict(issue_width=1), dict(issue_width=4, fusion=True),
         dict(branch_miss_penalty=20.0, scalar_freq_ghz=1.5)]


def reference_cycles(app, kw):
    """The reference's ``scalar_cycles``, or, where it raises on JAX 0.9's
    ``'jit'`` primitive (its counts of decode_attention and ssd_scan lower
    their kernel specs, ROADMAP Queue 3), the reference's own fold over the
    port's segments; with a label naming which."""
    rcfg = ref_eng.VectorEngineConfig(**kw)
    try:
        return ref_sp.scalar_cycles(app, rcfg), "the reference's scalar_cycles"
    except ref_fe.FrontendError as e:
        assert "'jit'" in str(e), e            # only the known fault
    cyc, _ = ref_sp._pipeline_jit(
        jnp.asarray(sp.segments_for(app)),
        tuple(jnp.asarray(p) for p in ref_sp.cfg_scalar_params(rcfg)))
    return float(cyc), ("the reference's fold over the port's segments (its "
                        "own counts raise on JAX 0.9's 'jit' primitive)")


@pytest.mark.parametrize("app", APPS)
def test_scalar_cycles_match_reference_exactly(app):
    for kw in [dict()] + KNOBS:
        want, oracle = reference_cycles(app, kw)
        assert sp.scalar_cycles(app, eng.VectorEngineConfig(**kw)) == want, \
            f"{app} {kw}: differs from {oracle}"
    if app not in ("decode_attention", "ssd_scan"):
        assert (sp.segments_for(app) == ref_sp.segments_for(app)).all()


def test_scalar_cycles_are_the_runtime_at_the_clock():
    for app in APPS:
        cfg = eng.VectorEngineConfig(scalar_freq_ghz=2.0)
        assert sp.scalar_cycles(app, cfg) / 2.0 == \
            sp.scalar_runtime_ns(app, cfg)


def test_check_gate_passes_on_the_cpu_engine(capsys):
    assert sp.main(["--check", "--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "== anchors ==" and len(out) == 15
    assert sum(ln.endswith(" ok") for ln in out[1:12]) == 11
    assert out[-1] == "scalar-scorecard: PASS"


def test_check_gate_fails_where_the_fold_breaks_monotonicity(monkeypatch,
                                                             capsys):
    """A fold that ignores the issue width: one-wide no slower than
    two-wide, so the gate lists the apps and exits 1."""
    fold = sp.fold

    def flat(seg, params):
        params = params.clone()
        params[:, 0] = 2.0
        return fold(seg, params)

    monkeypatch.setattr(sp, "fold", flat)
    sp._runtime_cached.cache_clear()
    try:
        assert sp.main(["--check", "--device", "cpu"]) == 1
    finally:
        sp._runtime_cached.cache_clear()
    last = capsys.readouterr().out.splitlines()[-1]
    assert last.startswith("FAILURES:") and "monotonicity" in last


def test_check_without_flag_prints_help(capsys):
    assert sp.main([]) == 0
    assert "--check" in capsys.readouterr().out


def test_study_quick_prints_run_py_rows(capsys, tmp_path):
    """``--quick`` prints run.py's smoke list, group by group in run.py's
    order, and writes its sections to ``--bench-json``."""
    bench = tmp_path / "bench.json"
    assert study.main(["--quick", "--device", "cpu", "--bench-json",
                       str(bench), "--timeline",
                       str(tmp_path / "timeline.json")]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "name,us_per_call,derived"
    assert lines[-1] == f"# wrote {bench}"
    names = [ln.split(",")[0] for ln in lines[1:-1]]
    prefixes = ("table_characterization_", "vao_speedup_", "fig_scalability_",
                "fig10_", "sweep_llc_", "sweep_mshr_", "frontend_crossval_",
                "rvv_", "codegen_", "steady_state_", "scalar_", "profile_",
                "sweep_quick_")
    group = lambda n: next(p for p in prefixes if n.startswith(p))
    order = []
    for n in names:
        if not order or order[-1] != group(n):
            order.append(group(n))
    assert order == ["table_characterization_", "vao_speedup_"] * 7 + [
        "fig_scalability_", "fig10_", "sweep_llc_", "sweep_mshr_",
        "frontend_crossval_", "rvv_", "codegen_", "steady_state_",
        "scalar_", "profile_", "sweep_quick_"]
    assert [n for n in names if n.startswith("steady_state_")] == \
        [f"steady_state_{a}_mvl64_l4" for a in study.NAMES]
    assert names[-3:] == ["sweep_quick_8cfg_batched",
                          "sweep_quick_8cfg_sequential",
                          "sweep_quick_batched_speedup"]
    assert len(study.NAMES) == 20
    assert lines[-2].endswith("|max_rel_diff=0.00e+00")
    import json
    assert {"frontend_crossval", "rvv", "codegen", "steady_state_ns",
            "scalar", "profile", "sweep"} <= set(json.loads(
                bench.read_text()))


def test_study_steady_state_matches_reference_engine():
    """The sweep driver's steady-state rows against the reference engine
    on the same loop bodies (the port's bodies, which the frontend and
    decoder tests hold fingerprint-equal to the reference's)."""
    rows = study.steady_state(device="cpu")
    cfg = study.STEADY_CFG
    bodies = [tracegen.body_for(a, suite.effective_mvl(a, cfg), cfg)
              for a in study.NAMES]
    rcfg = ref_eng.VectorEngineConfig(mvl=64, lanes=4)
    want = ref_eng.steady_state_time_batch(
        [ref_isa.Trace(**vars(b)) for b in bodies], [rcfg] * len(bodies),
        with_util=True)
    for name, got, ref in zip(study.NAMES, rows, want):
        for key in ("steady_ns", "lane_util", "vmu_util"):
            assert abs(got[key] - ref[key]) <= 1e-6 * max(abs(ref[key]),
                                                          1e-30), (name, key)
