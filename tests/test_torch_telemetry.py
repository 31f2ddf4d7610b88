"""Port parity: the profiler (``engine.simulate(collect_stats=True)`` and
``repro_torch.core.telemetry``), with the engine on the CPU.

The collect build's plain version (``engine_scan.scan_plain(...,
collect=True)``) against the default path and the reference:

* its timing metrics bitwise equal to the default path's, on seeded random
  traces and configs;
* the event-sum identity (``sum(stalls) == time`` within 1e-4 relative) on
  all ten apps at the reference's two configs;
* against the reference's ``simulate(collect_stats=True)`` on the same
  trace: every stall within 1e-6 x ``time``, ``occ_lane_fu`` and the
  timeline within 1e-6 relative, and every record's ``cause`` equal (a
  differing cause would mean an FMA tie: the count and the first records
  are shown).  The reference builds eight of the apps' bodies on this JAX;
  for decode_attention and ssd_scan (the ``'jit'`` caveat, ROADMAP Queue
  3) the trace both run is the reference's decoded RVV corpus body, and
  the port's own lowered body is held to the identity;
* ``module_fractions``, ``top_bottleneck``, ``LatencyHistogram`` and
  ``chrome_trace`` equal to the reference's.
"""
import json

import numpy as np
import pytest

try:  # hypothesis is optional (requirements-dev.txt)
    from hypothesis import given, settings, strategies as st
except ImportError:  # pragma: no cover
    from repro.testing.hypothesis_shim import given, settings, strategies as st

from repro.core import engine as ref_eng
from repro.core import rvv as ref_rvv
from repro.core import suite as ref_suite
from repro.core import telemetry as ref_tel
from repro.core import tracegen as ref_tg
from repro_torch import interop
from repro_torch.core import engine as eng
from repro_torch.core import isa, suite, telemetry, tracegen
from test_torch_engine import pair

CPU = "cpu"
CFGS = {"ref": dict(mvl=64, lanes=4),
        "corner": dict(mvl=256, lanes=8, ooo_issue=True,
                       interconnect="crossbar")}
JIT_APPS = ("decode_attention", "ssd_scan")
TILES = 6


def _ref_body(app, rcfg):
    """The trace the reference can build: its tracegen body, or for the
    two 'jit' apps its decoded RVV corpus body."""
    eff = ref_suite.effective_mvl(app, rcfg)
    if app in JIT_APPS:
        return ref_rvv.asm_body(app, eff, rcfg)
    return ref_tg.body_for(app, eff, rcfg)


@pytest.fixture(scope="module")
def profiles():
    """Per (app, config): the port's profile of its own body, and the
    port's and the reference's profiles of the reference's body, each
    tiled TILES times (computed once for the module)."""
    out = {}
    for app in sorted(tracegen.APPS):
        for name, kw in CFGS.items():
            cfg, rcfg = eng.VectorEngineConfig(**kw), ref_eng.VectorEngineConfig(**kw)
            own = tracegen.body_for(app, suite.effective_mvl(app, cfg), cfg)
            rbody = _ref_body(app, rcfg).tile(TILES)
            pbody = interop.trace_from_numpy(vars(rbody))
            p = out[app, name] = {
                "port": eng.simulate(pbody, cfg, collect_stats=True,
                                     device=CPU),
                "ref": ref_eng.simulate(rbody, rcfg, collect_stats=True),
                "base": eng.simulate(pbody, cfg, device=CPU),
            }
            # the port's own body is the reference's but for the two
            # 'jit' apps (lowered through torch.fx, not decoded)
            own = own.tile(TILES)
            p["own"] = p["port"] if isa.trace_fingerprint(own) == \
                isa.trace_fingerprint(pbody) else eng.simulate(
                    own, cfg, collect_stats=True, device=CPU)
    return out


# --------------------------------------------------------------------------
# the default path is untouched
# --------------------------------------------------------------------------
@settings(max_examples=8, deadline=None, derandomize=True)
@given(st.integers(min_value=0, max_value=10 ** 9))
def test_collect_stats_timing_bitwise(seed):
    """The collect build's timings are the default path's, bit for bit, on
    random traces and configs; and its stalls match the reference's."""
    rt, rc, tr, cfg = pair(seed % 100_000)
    base = eng.simulate(tr, cfg, device=CPU)
    prof = eng.simulate(tr, cfg, collect_stats=True, device=CPU)
    for k, v in base.items():
        assert prof[k] == v, (k, v, prof[k])
    ref = ref_eng.simulate(rt, rc, collect_stats=True)
    _assert_matches_reference(prof, ref, f"seed {seed}")


@pytest.mark.parametrize("app", sorted(tracegen.APPS))
@pytest.mark.parametrize("cfg", sorted(CFGS))
def test_collect_timing_bitwise_on_apps(profiles, app, cfg):
    p = profiles[app, cfg]
    for k, v in p["base"].items():
        assert p["port"][k] == v, (k, v, p["port"][k])


# --------------------------------------------------------------------------
# the event-sum identity, all ten apps
# --------------------------------------------------------------------------
@pytest.mark.parametrize("app", sorted(tracegen.APPS))
@pytest.mark.parametrize("cfg", sorted(CFGS))
@pytest.mark.parametrize("body", ["own", "port"])
def test_event_sum_identity(profiles, app, cfg, body):
    """sum(stalls) == time within 1e-4 relative, every stall >= 0: on the
    port's own body and on the reference's (for the two 'jit' apps, the
    decoded corpus body)."""
    prof = profiles[app, cfg][body]
    total = sum(prof["stalls"].values())
    assert abs(total - prof["time"]) <= 1e-4 * prof["time"], (
        app, cfg, body, total, prof["time"])
    assert all(v >= 0.0 for v in prof["stalls"].values())


def test_records_timeline_sane():
    cfg = eng.VectorEngineConfig(mvl=64, lanes=4)
    body = tracegen.body_for("blackscholes", 64, cfg)
    prof = eng.simulate(body.tile(4), cfg, collect_stats=True, device=CPU)
    rec = prof["records"]
    n = len(body.tile(4))
    assert all(rec[k].shape == (n,) and rec[k].dtype == np.float32
               for k in ("start", "issue", "complete"))
    assert rec["cause"].dtype == np.int32
    assert np.all(rec["issue"] <= rec["complete"] + 1e-6)
    assert np.all(rec["complete"] <= prof["time"] + 1e-6)
    assert rec["cause"].min() >= 0 and rec["cause"].max() < eng.N_STALL


# --------------------------------------------------------------------------
# against the reference's simulate(collect_stats=True)
# --------------------------------------------------------------------------
def _assert_matches_reference(got, want, what):
    t = want["time"]
    assert abs(got["time"] - t) <= 1e-6 * t, (what, got["time"], t)
    bad = {k: (got["stalls"][k], v) for k, v in want["stalls"].items()
           if abs(got["stalls"][k] - v) > 1e-6 * t}
    assert not bad, f"{what}: stalls off by more than 1e-6 x time: {bad}"
    for g, w in zip(got["occ_lane_fu"], want["occ_lane_fu"]):
        assert abs(g - w) <= 1e-6 * abs(w), (what, got["occ_lane_fu"],
                                             want["occ_lane_fu"])
    for k in ("start", "issue", "complete"):
        g, w = got["records"][k], want["records"][k]
        assert g.shape == w.shape
        off = np.abs(g.astype(np.float64) - w) > 1e-6 * np.abs(w)
        assert not off.any(), (what, k, int(off.sum()),
                               np.flatnonzero(off)[:5])
    flips = np.flatnonzero(got["records"]["cause"] != want["records"]["cause"])
    assert flips.size == 0, (
        f"{what}: {flips.size} records with another cause (an FMA tie?), "
        f"first {flips[:10].tolist()}: port "
        f"{got['records']['cause'][flips[:10]].tolist()} vs reference "
        f"{want['records']['cause'][flips[:10]].tolist()}")


@pytest.mark.parametrize("app", sorted(tracegen.APPS))
@pytest.mark.parametrize("cfg", sorted(CFGS))
def test_stalls_match_the_reference(profiles, app, cfg):
    """The same trace through both profilers (for decode_attention and
    ssd_scan the reference's decoded corpus body: its tracegen raises the
    'jit' FrontendError on this JAX)."""
    p = profiles[app, cfg]
    _assert_matches_reference(p["port"], p["ref"], f"{app} @ {cfg}")


def test_dep_scalar_attribution_matches_table2(profiles):
    """Coupling cycles (dep_scalar) surface for exactly the scalar-
    communication apps of the paper's Table 2, on the port's own bodies
    (all ten apps)."""
    scalar_comm = {"canneal", "particlefilter", "streamcluster",
                   "flash_attention", "decode_attention"}
    for app in sorted(tracegen.APPS):
        has = profiles[app, "ref"]["own"]["stalls"]["dep_scalar"] > 0
        assert has == (app in scalar_comm), app


# --------------------------------------------------------------------------
# telemetry layer: schema, rollup, scorecard, timeline, histogram
# --------------------------------------------------------------------------
def test_schema_envelope():
    row = telemetry.snapshot_row("x.y", a=1)
    assert row == ref_tel.snapshot_row("x.y", a=1)
    assert telemetry.SCHEMA == ref_tel.SCHEMA
    assert telemetry.MODULES == ref_tel.MODULES
    assert telemetry._KIND_TO_MODULE == ref_tel._KIND_TO_MODULE


@pytest.mark.parametrize("app", sorted(tracegen.APPS))
def test_module_fractions_and_top_equal_the_reference(profiles, app):
    """The rollup of the same stalls gives the reference's fractions and
    top bottleneck bit for bit."""
    for cfg in CFGS:
        prof = profiles[app, cfg]["port"]
        mods = telemetry.module_fractions(prof["stalls"], prof["time"])
        assert mods == ref_tel.module_fractions(prof["stalls"], prof["time"])
        assert telemetry.top_bottleneck(mods) == ref_tel.top_bottleneck(mods)
    tie = {m: 0.25 for m in telemetry.MODULES}
    assert telemetry.top_bottleneck(tie) == ref_tel.top_bottleneck(tie)


def test_profile_app_rows():
    cfg = eng.VectorEngineConfig(mvl=64, lanes=4)
    for app in ("blackscholes", "canneal"):
        r = telemetry.profile_app(app, cfg, tiles=4, device=CPU)
        assert r["kind"] == "engine.profile"
        assert abs(sum(r["modules"].values()) - 1.0) < 1e-3
        assert r["top"] in telemetry.MODULES
        assert r["identity_rel_err"] < 1e-4
        ref = ref_tel.profile_app(app, ref_eng.VectorEngineConfig(mvl=64,
                                                                  lanes=4),
                                  tiles=4)
        assert set(r) == set(ref) and r["top"] == ref["top"]
        assert r["config"] == ref["config"]


def test_scorecard_roundtrip():
    rep = telemetry.scorecard(apps=["jacobi-2d", "pathfinder"],
                              cfgs=[eng.VectorEngineConfig(mvl=64, lanes=4)],
                              tiles=4, device=CPU)
    doc = json.loads(rep.to_json())
    assert doc["schema"] == telemetry.SCHEMA and len(doc["rows"]) == 2
    assert "pathfinder" in rep.table()
    assert set(rep.by_app()) == {"jacobi-2d", "pathfinder"}


def test_chrome_trace_equals_the_reference(tmp_path):
    """Same trace, same config: the same document (events, spans, causes),
    every time within 1e-6 relative."""
    rcfg = ref_eng.VectorEngineConfig(mvl=64, lanes=4)
    cfg = eng.VectorEngineConfig(mvl=64, lanes=4)
    rbody = ref_tg.body_for("jacobi-2d", 64, rcfg).tile(2)
    path = tmp_path / "timeline.json"
    doc = telemetry.write_chrome_trace(
        str(path), interop.trace_from_numpy(vars(rbody)), cfg,
        label="jacobi-2d", device=CPU)
    assert json.loads(path.read_text()) == json.loads(json.dumps(doc))
    want = ref_tel.chrome_trace(rbody, rcfg, label="jacobi-2d")
    assert len(doc["traceEvents"]) == len(want["traceEvents"])
    for g, w in zip(doc["traceEvents"], want["traceEvents"]):
        assert {k: v for k, v in g.items() if k not in ("ts", "dur")} == \
            {k: v for k, v in w.items() if k not in ("ts", "dur")}
        for k in ("ts", "dur"):
            if k in w:
                assert abs(g[k] - w[k]) <= 1e-6 * max(abs(w[k]), 1.0)
    spans = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    assert spans and any(e["name"].startswith("stall:") for e in spans)
    assert all(e["ts"] >= 0 and e["dur"] >= 0 and e["tid"] in (0, 1, 2)
               for e in spans)


def test_latency_histogram_equals_the_reference():
    mine, ref = telemetry.LatencyHistogram(), ref_tel.LatencyHistogram()
    for v in (2e-6, 5e-5, 1e-3, 1e-3, 2.0, 1e-9, 1e6):
        mine.add(v)
        ref.add(v)
    assert np.array_equal(mine.counts, ref.counts)
    assert np.array_equal(mine.edges, ref.edges)
    for q in (0.0, 0.5, 0.99, 0.999, 1.0):
        assert mine.percentile(q) == ref.percentile(q)
    assert mine.to_dict() == ref.to_dict()
    snap = mine.snapshot()
    mine.add(1e-2)
    delta = mine.since(snap)
    assert delta.count == 1
    assert abs(delta.percentile(0.5) - 1e-2) / 1e-2 < 0.2


def test_timeline_cli(tmp_path):
    out = tmp_path / "t.json"
    assert telemetry.main(["--timeline", "pathfinder", "-o", str(out),
                           "--device", CPU]) == 0
    doc = json.loads(out.read_text())
    assert doc["otherData"]["schema"] == telemetry.SCHEMA
