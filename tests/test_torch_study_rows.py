"""Port parity: ``repro_torch.study``'s row groups against
``benchmarks/run.py``'s: the characterization, the Fig 4-10, LLC and MSHR
sweeps, the scalar rows and the profile rows.

Each group's rows carry the reference's names in the reference's order,
and the numbers behind them are held to the reference's at rel <= 1e-6
(the engine's standing bar against the reference, ROADMAP Queue 3), read
unrounded from the calls the groups make.  The reference cannot lower
decode_attention's and ssd_scan's kernel specs (JAX 0.9's ``'jit'``
primitive), so its scalar and profile groups raise; their other apps are
compared with the reference's own functions, and for those two apps the
oracles are the reference's fold over the port's segments (scalar) and the
event-sum identity (profile), each named in its assertion.
"""
import hashlib
import json
import sys
from pathlib import Path

import jax.numpy as jnp
import pytest

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "benchmarks"))

import run as ref_run  # noqa: E402
from repro.core import characterize as ref_ch  # noqa: E402
from repro.core import engine as ref_eng  # noqa: E402
from repro.core import scalar_pipeline as ref_sp  # noqa: E402
from repro.core import suite as ref_suite  # noqa: E402
from repro.core import telemetry as ref_tel  # noqa: E402
from repro.core import tracegen as ref_tg  # noqa: E402
from repro.core.anchors import ANCHORS  # noqa: E402
from repro_torch import study  # noqa: E402
from repro_torch.core import characterize as ch  # noqa: E402
from repro_torch.core import scalar_pipeline as sp  # noqa: E402
from repro_torch.core import suite, tracegen  # noqa: E402

JIT_APPS = ("decode_attention", "ssd_scan")


def rel_close(got, want, rel=1e-6):
    return abs(got - want) <= rel * max(abs(want), 1e-30)


def recorded(monkeypatch, module, name):
    """Wrap ``module.name`` so every call's arguments and result are kept."""
    calls = []
    fn = getattr(module, name)

    def rec(*a, **kw):
        out = fn(*a, **kw)
        calls.append((a, kw, out))
        return out

    monkeypatch.setattr(module, name, rec)
    return calls


def test_characterization_rows_match_reference():
    got = study.table_3_to_9_characterization()
    want = ref_run.table_3_to_9_characterization()
    assert [r[0] for r in got] == [r[0] for r in want]
    assert [r[2] for r in got] == [r[2] for r in want]
    for app in ch.PAPER_TABLES:
        for g, w in zip(ch.compare_to_paper(app), ref_ch.compare_to_paper(app)):
            assert g.keys() == w.keys()
            for k, v in w.items():
                assert g[k] == v if isinstance(v, str) else rel_close(g[k], v)
        assert rel_close(ch.characterize(app, 8).vao_speedup,
                         ref_ch.characterize(app, 8).vao_speedup)


@pytest.mark.parametrize("group", ["figures_4_to_10_scalability",
                                   "sweep_llc", "sweep_mshr"])
def test_sweep_rows_match_reference(monkeypatch, group):
    """The same pairs in one ``speedup_batch`` each, the same rows; the
    speedups unrounded within rel 1e-6."""
    got_calls = recorded(monkeypatch, suite, "speedup_batch")
    want_calls = recorded(monkeypatch, ref_suite, "speedup_batch")
    got = getattr(study, group)(device="cpu")
    want = getattr(ref_run, group)()
    assert [r[0] for r in got] == [r[0] for r in want]
    assert [r[2] for r in got] == [r[2] for r in want]
    assert len(got_calls) == len(want_calls) == 1
    (g_pairs,), _, g_vals = got_calls[0]
    (w_pairs,), _, w_vals = want_calls[0]
    assert [(a, c.label()) for a, c in g_pairs] == \
        [(a, c.label()) for a, c in w_pairs]
    assert all(rel_close(g, w) for g, w in zip(g_vals, w_vals))


def _reference_scalar_ns(app):
    """The reference's scalar runtime (ns) and cycles of ``app``, or for the
    caveat apps the reference's fold over the port's segments."""
    if app not in JIT_APPS:
        return ref_sp.scalar_runtime_ns(app), ref_sp.scalar_cycles(app)
    params = ref_sp.cfg_scalar_params(None)
    cyc, _ = ref_sp._pipeline_jit(jnp.asarray(sp.segments_for(app)),
                                  tuple(jnp.asarray(p) for p in params))
    return float(cyc) / float(params[3]), float(cyc)


def test_scalar_rows_match_reference():
    rows = study.scalar_rows(device="cpu")
    names = [r[0] for r in rows]
    want_names = ([f"scalar_baseline_{a}" for a in sorted(study._OLD_SCALAR_NS)]
                  + [f"scalar_anchor_{a}_mvl{m}_l{l}"
                     for a, m, l, _, _ in ANCHORS]
                  + ["scalar_scorecard_wallclock"])
    assert names == want_names
    assert study._OLD_SCALAR_NS == ref_run._OLD_SCALAR_NS
    bench = study._BENCH["scalar"]
    for app in sorted(study._OLD_SCALAR_NS):
        want_ns, want_cyc = _reference_scalar_ns(app)
        oracle = ("the reference's fold over the port's segments (its own "
                  "counts raise on JAX 0.9's 'jit' primitive, ROADMAP "
                  "Queue 3)" if app in JIT_APPS else "the reference")
        assert rel_close(bench[app]["new_ns"], want_ns), (app, oracle)
        if app not in JIT_APPS:
            prof = ref_tg.scalar_profile_for(app)
            n = ref_tg.app_for(app).counts(8).scalar_code_total \
                * prof.roi_instr_fraction
            assert rel_close(bench[app]["cpi"], want_cyc / n), app
    for app, mvl, lanes, target, kind in ANCHORS:
        got = bench["anchors"][f"{app}@{mvl}x{lanes}"]
        want = ref_suite.speedup(app, ref_eng.VectorEngineConfig(mvl=mvl,
                                                                 lanes=lanes))
        assert rel_close(got["model"], want), (app, mvl, lanes)
        assert (got["paper"], got["kind"]) == (target, kind)
    assert rows[-1][2] == f"{len(ANCHORS)}_anchors"


@pytest.fixture(scope="module")
def profile(tmp_path_factory):
    path = tmp_path_factory.mktemp("profile") / "timeline.json"
    from repro_torch.kernels import engine_scan
    before = engine_scan.scan_collect.launches
    rows = study.profile_rows(quick=True, timeline_path=str(path),
                              device="cpu")
    return rows, dict(study._BENCH["profile"]), path, before


def test_profile_rows_match_reference(profile):
    """``top`` and the module fractions equal to the reference's scorecard
    on the eight apps it builds (fractions within 1e-6), the event-sum
    identity within 1e-4 on all ten."""
    rows, bench, path, _ = profile
    apps = sorted(tracegen.APPS)
    names = [r[0] for r in rows]
    assert names == [f"profile_{a}_mvl64_l4" for a in apps] + [
        "profile_timeline_blackscholes"]
    cfg = ref_eng.VectorEngineConfig(mvl=64, lanes=4)
    want = {r["app"]: r for r in ref_tel.scorecard(
        apps=[a for a in apps if a not in JIT_APPS], cfgs=[cfg]).rows}
    got = {r["app"]: r for r in bench["scorecard"]["rows"]}
    for app in apps:
        g = got[app]
        assert g["identity_rel_err"] <= 1e-4, (app, g["identity_rel_err"])
        if app in JIT_APPS:
            # the event-sum identity is the oracle: the reference cannot
            # lower the app's kernel spec (JAX 0.9's 'jit', ROADMAP Queue 3)
            assert abs(sum(g["stalls"].values()) - g["time"]) \
                <= 1e-4 * g["time"], (app, "event-sum identity")
            continue
        w = want[app]
        assert g["top"] == w["top"], app
        assert g["modules"].keys() == w["modules"].keys()
        for m, v in w["modules"].items():
            assert abs(g["modules"][m] - v) <= 1e-6, (app, m)
        assert rel_close(g["time"], w["time"]), app
    for r in rows[:-1]:
        assert float(r[2].rsplit("ident_err=", 1)[1]) <= 1e-4, r


def test_profile_timeline_and_launches(profile):
    rows, bench, path, before = profile
    doc = json.loads(path.read_text())
    cfg = ref_eng.VectorEngineConfig(mvl=64, lanes=4)
    body = ref_tg.body_for("blackscholes",
                           ref_suite.effective_mvl("blackscholes", cfg), cfg)
    want = ref_tel.chrome_trace(body.tile(2), cfg, label="blackscholes")
    assert len(doc["traceEvents"]) == len(want["traceEvents"])
    assert rows[-1][2] == f"{len(want['traceEvents'])}events|{path}"
    assert bench["timeline"] == str(path)
    # the collect build's launches stand where run.py has its jit cache;
    # a CPU run launches nothing
    assert "jit_cache" not in bench and bench["collect_launches"] == 0


def _sha(path):
    return hashlib.sha256(path.read_bytes()).hexdigest()


def test_profile_run_leaves_the_reference_files_alone(monkeypatch, tmp_path,
                                                      capsys):
    """``--profile --quick`` with the default paths (moved under a
    temporary ``results/``) writes the port's own files and leaves
    ``BENCH_pr10.json`` and ``examples/timeline_blackscholes.json`` byte
    for byte as they were."""
    protected = [ROOT / "BENCH_pr10.json",
                 ROOT / "examples" / "timeline_blackscholes.json"]
    for default in (study.BENCH_JSON, study.TIMELINE):
        assert default.parent == ROOT / "results"
        assert default not in protected
    before = [_sha(p) for p in protected]
    monkeypatch.setattr(study, "BENCH_JSON", tmp_path / "results" /
                        study.BENCH_JSON.name)
    monkeypatch.setattr(study, "TIMELINE", tmp_path / "results" /
                        study.TIMELINE.name)
    (tmp_path / "results").mkdir()
    (tmp_path / "results" / study.BENCH_JSON.name).write_text(
        json.dumps({"earlier": 1}))
    assert study.main(["--profile", "--quick", "--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "name,us_per_call,derived"
    assert out[-2].startswith("profile_timeline_blackscholes,")
    merged = json.loads((tmp_path / "results" /
                         study.BENCH_JSON.name).read_text())
    assert merged["earlier"] == 1 and "profile" in merged
    assert (tmp_path / "results" / study.TIMELINE.name).exists()
    assert [_sha(p) for p in protected] == before
