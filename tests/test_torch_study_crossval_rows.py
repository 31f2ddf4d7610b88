"""Port parity: ``repro_torch.study``'s frontend, rvv and codegen row
groups against ``benchmarks/run.py``'s, at ``--quick`` sizes.

The rows carry the reference's names in the reference's order; their
numbers, read unrounded from the calls the groups make, are held to the
reference's at rel <= 1e-6 (the engine's standing bar, ROADMAP Queue 3)
and their verdicts to the reference's.  The reference cannot lower the
kernel specs of decode_attention, ssd_scan, jacobi-2d and pathfinder (JAX
0.9's ``'jit'`` primitive), so each of its three groups raises whole; its
functions are run over the apps they take, and for the others the oracle
is the reference's committed RVV corpus (``src/repro/asm``, emitted by its
code generator and decoded by its decoder, fingerprint-equal to its
lowering) or the committed golden table, named in each assertion.
"""
import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "benchmarks"))

import run as ref_run  # noqa: E402
from repro.core import codegen as ref_cg  # noqa: E402
from repro.core import crossval as ref_cv  # noqa: E402
from repro.core import engine as ref_eng  # noqa: E402
from repro.core import frontend as ref_fe  # noqa: E402
from repro.core import isa as ref_isa  # noqa: E402
from repro.core import rvv as ref_rvv  # noqa: E402
from repro.core import suite as ref_suite  # noqa: E402
from repro.core import tracegen as ref_tg  # noqa: E402
from repro_torch import study  # noqa: E402
from repro_torch.core import engine as eng  # noqa: E402
from repro_torch.core import frontend as fe  # noqa: E402
from repro_torch.core import isa, rvv, suite, tracegen  # noqa: E402

# the apps whose kernel specs the reference cannot lower
SPEC_APPS = ("decode_attention", "jacobi-2d", "pathfinder", "ssd_scan")
CAVEAT = ("the reference cannot lower this app's kernel spec (JAX 0.9's "
          "'jit' primitive, ROADMAP Queue 3)")
QUICK_CFGS = [(64, 4), (16, 2)]


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


def test_reference_groups_fail_only_on_the_caveat():
    for group in (ref_run.frontend_crossval,
                  lambda: ref_run.rvv_rows(quick=True),
                  lambda: ref_run.codegen_rows(quick=True)):
        with pytest.raises(ref_fe.FrontendError, match="'jit'"):
            group()


def test_frontend_rows_match_reference(monkeypatch):
    """The reference's cross-validation with its lowering where it can
    lower, else with its committed corpus decoded (the corpus decodes to
    its lowering, fingerprint-equal): the steady-state times the errors
    compare within rel 1e-6."""
    calls = recorded(monkeypatch, fe, "cross_validate_all")
    rows = study.frontend_crossval(device="cpu")
    (reports,) = [c[2] for c in calls]
    cfgs = [ref_eng.VectorEngineConfig(mvl=m, lanes=l) for m, l in QUICK_CFGS]

    def derive(app, eff, cfg):
        if app in SPEC_APPS:
            trace = ref_rvv.asm_body(app, eff, cfg)
            regs = ref_isa.trace_registers(trace)
            return trace, regs, regs
        low = ref_fe.derived_body(app, eff, cfg)
        return low.trace, low.regs_used, low.max_live

    want = ref_cv.cross_validate(derive, list(ref_tg.RIVEC_APPS), cfgs)
    assert [r[0] for r in rows] == [f"frontend_crossval_{r.app}"
                                    for r in want]
    for row, g, w in zip(rows, reports, want):
        assert (g.app, g.cfg_label) == (w.app, w.cfg_label)
        # the two steady-state times the error compares, each within rel
        # 1e-6 (the error itself is their difference)
        assert rel_close(g.time_hand, w.time_hand), (g.app, g.cfg_label)
        assert rel_close(g.time_derived, w.time_derived), (g.app, g.cfg_label)
        assert row[2] == (f"time_err={g.time_rel_err:.4f}|"
                          f"{'ok' if g.ok else 'FAIL'}")
        if g.app in SPEC_APPS:
            assert g.ok, (g.app, CAVEAT)
        else:
            assert g.ok == w.ok, g.app


def test_rvv_rows_match_reference(monkeypatch):
    calls = recorded(monkeypatch, rvv, "cross_validate_all")
    sweeps = recorded(monkeypatch, suite, "sweep_all")
    rows = study.rvv_rows(quick=True, device="cpu")
    corpus = [a for a in sorted(tracegen.APPS) if tracegen.APPS[a].asm]
    cfg = ref_eng.VectorEngineConfig(mvl=64, lanes=4)
    # decode rows: the reference's decoder on the same corpus
    want_decode = []
    for app in corpus:
        d = ref_rvv.decode_app(app, ref_suite.effective_mvl(app, cfg), cfg)
        want_decode.append((f"rvv_decode_{app}",
                            f"{len(d.trace)}entries|chunks={d.chunks:g}"))
    assert [(r[0], r[2]) for r in rows[:len(corpus)]] == want_decode
    # cross-validation rows: the reference's where its hand-coded body
    # exists, else its decoded corpus as the hand body (the ML apps' hand
    # bodies are their lowering, which the corpus decodes to)
    (reports,) = [c[2] for c in calls]
    cfgs = [ref_eng.VectorEngineConfig(mvl=m, lanes=l) for m, l in QUICK_CFGS]
    lowerable = [a for a in corpus if a not in ("decode_attention",
                                                "ssd_scan")]
    want = {(r.app, r.cfg_label): r
            for r in ref_rvv.cross_validate_all(apps=lowerable, cfgs=cfgs)}
    xrows = rows[len(corpus):-1]
    assert [r[0] for r in xrows] == [f"rvv_crossval_{a}_{c.label()}"
                                     for c in cfgs for a in corpus]
    for row, g in zip(xrows, reports):
        assert row[2] == (f"time_err={g.time_rel_err:.4f}|"
                          f"{'bitwise' if g.fingerprint_eq else 'mix-exact'}"
                          f"|{'ok' if g.ok else 'FAIL'}")
        w = want.get((g.app, g.cfg_label))
        if w is None:
            m, l = (int(x) for x in g.cfg_label[3:].split("_l"))
            rcfg = ref_eng.VectorEngineConfig(mvl=m, lanes=l)
            cfg = eng.VectorEngineConfig(mvl=m, lanes=l)
            eff = ref_suite.effective_mvl(g.app, rcfg)
            body = tracegen.body_for(g.app, suite.effective_mvl(g.app, cfg),
                                     cfg)
            assert isa.trace_fingerprint(body) == ref_isa.trace_fingerprint(
                ref_rvv.asm_body(g.app, eff, rcfg)), (g.app, CAVEAT)
            assert g.fingerprint_eq and g.ok and g.time_rel_err == 0.0, \
                (g.app, CAVEAT)
            continue
        assert (g.fingerprint_eq, g.ok) == (w.fingerprint_eq, w.ok), g.app
        assert rel_close(g.time_hand, w.time_hand), g.app
        assert rel_close(g.time_derived, w.time_derived), g.app
    # the :asm sweep against the hand-coded suite: the reference's cells
    # where it builds them, the golden table's for the ML apps it cannot
    (asm_tab, hand_tab) = [c[2] for c in sweeps]
    golden = json.loads((ROOT / "tests" / "golden_sweep.json").read_text())
    worst = 0.0
    for app in corpus:
        for (m, l), got_hand in hand_tab[app].items():
            got_asm = asm_tab[f"{app}:asm"][(m, l)]
            if app in ("decode_attention", "ssd_scan"):
                w_asm, w_hand = (golden[f"{app}:asm"][f"{m}x{l}"],
                                 golden[app][f"{m}x{l}"])
                assert abs(got_asm - w_asm) <= 1e-2 * w_asm, (app, CAVEAT)
                assert abs(got_hand - w_hand) <= 1e-2 * w_hand, (app, CAVEAT)
            else:
                c = ref_eng.VectorEngineConfig(mvl=m, lanes=l)
                assert rel_close(got_hand, ref_suite.speedup(app, c)), app
                assert rel_close(got_asm, ref_suite.speedup(f"{app}:asm", c)), \
                    app
            worst = max(worst, abs(got_asm - got_hand) / got_hand)
    assert rows[-1][0] == "rvv_asm_sweep_parity"
    assert rows[-1][2] == f"max_rel_diff={worst:.2e}|cells=60"


def test_codegen_rows_match_reference(monkeypatch):
    """Emit line counts and round trips: the reference's own where it can
    lower the app, else its committed corpus (its code generator's output:
    the port's text must equal it below the header, and the reference's
    decode of it must be fingerprint-equal to the port's lowering at both
    MVLs)."""
    rows = study.codegen_rows(quick=True)
    apps = [a for a in sorted(tracegen.APPS)
            if tracegen.APPS[a].kernel is not None]
    emit = {r[0][len("codegen_emit_"):]: r[2] for r in rows
            if r[0].startswith("codegen_emit_")}
    assert list(emit) == apps
    trips = [r for r in rows if r[0].startswith("codegen_roundtrip_")]
    assert [r[0] for r in trips] == [f"codegen_roundtrip_{a}_mvl{m}"
                                     for a in apps for m in (8, 256)]
    assert all(r[2] == "bitwise|ok" for r in trips)
    for app in apps:
        if app in SPEC_APPS:
            corpus = (ROOT / "src" / "repro" / "asm" /
                      ref_tg.APPS[app].asm).read_text().splitlines()
            assert emit[app] == f"{len(corpus)}lines", (app, CAVEAT)
            for m in (8, 256):
                rcfg = ref_eng.VectorEngineConfig(mvl=m, lanes=4)
                cfg = eng.VectorEngineConfig(mvl=m, lanes=4)
                want = ref_rvv.asm_body(
                    app, ref_suite.effective_mvl(app, rcfg), rcfg)
                got = fe.derived_body(app, suite.effective_mvl(app, cfg),
                                      cfg).trace
                assert isa.trace_fingerprint(got) == \
                    ref_isa.trace_fingerprint(want), (app, m, CAVEAT)
            continue
        text = ref_cg.emit_app(app)
        assert emit[app] == f"{len(text.splitlines())}lines", app
        for r in ref_cv.round_trip_app(app, text=text, mvls=(8, 256)):
            assert r.fingerprint_eq and r.ok, (app, r.mvl)
