"""Frontend-agnostic cross-validation: derived traces vs hand-coded bodies.

Every non-hand trace frontend — the torch.fx lowering (``core.frontend``)
and the RVV assembly decoder (``core.rvv``) — must reproduce the
hand-coded characterization bodies in ``tracegen`` before its apps are
trusted in sweeps.  This module is the one shared contract, the port of
``repro/core/crossval.py``, with the code generator's round trip
(``round_trip_all``: ``core.codegen``'s assembly decoded back by
``core.rvv`` and held to the torch.fx lowering):

| property | tolerance |
|---|---|
| instruction-kind histogram | exact |
| FU histogram over ``VARITH`` | exact |
| memory-pattern histogram over loads/stores | exact |
| summed vector length (element work) | exact |
| total scalar count + ``dep_scalar`` count | exact |
| register pressure | fits the 32-reg file, within ±16 of hand-coded |
| steady-state time (per config) | within ``TIME_RTOL`` (5%) |

A frontend plugs in with a single callable ``derive(app, eff_mvl, cfg) ->
(trace, regs_used, max_live)``; the timing comparison for every (app, cfg)
pair runs as one ``steady_state_time_batch`` call (one engine scan
launch), on the CUDA device unless ``device="cpu"`` is passed.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.core import isa

N_LOGICAL_REGS = 32   # the engine's register-ready scoreboard size
TIME_RTOL = 0.05      # steady-state-time tolerance
REGS_ATOL = 16        # |derived regs - hand regs| tolerance


@dataclass
class CrossValReport:
    app: str
    kinds_ok: bool       # instruction-kind histogram: exact
    fu_ok: bool          # FU histogram over VARITH: exact
    pattern_ok: bool     # memory-pattern histogram over loads/stores: exact
    elems_ok: bool       # summed vector length (element work): exact
    scalar_ok: bool      # total scalar_count and dep_scalar count: exact
    pressure_ok: bool    # fits the register file, close to hand-coded
    hand_regs: int
    derived_regs: int
    time_hand: float = 0.0
    time_derived: float = 0.0
    cfg_label: str = ""
    fingerprint_eq: bool = False   # trace bitwise-identical to hand-coded

    @property
    def time_rel_err(self) -> float:
        return abs(self.time_derived - self.time_hand) / max(self.time_hand,
                                                             1e-9)

    @property
    def ok(self) -> bool:
        return (self.kinds_ok and self.fu_ok and self.pattern_ok
                and self.elems_ok and self.scalar_ok and self.pressure_ok
                and self.time_rel_err <= TIME_RTOL)


def static_report(app_name: str, hand: isa.Trace, derived: isa.Trace,
                  regs_used: int, max_live: int,
                  cfg_label: str = "") -> CrossValReport:
    """The static half of the contract (everything but timing)."""
    d = derived
    vmask = lambda t: t.kind != isa.SCALAR_BLOCK
    memmask = lambda t: (t.kind == isa.VLOAD) | (t.kind == isa.VSTORE)
    kinds_ok = bool(np.array_equal(isa.kind_histogram(hand),
                                   isa.kind_histogram(d)))
    fu_ok = bool(np.array_equal(
        np.bincount(hand.fu[hand.kind == isa.VARITH], minlength=4),
        np.bincount(d.fu[d.kind == isa.VARITH], minlength=4)))
    pattern_ok = bool(np.array_equal(
        np.bincount(hand.mem_pattern[memmask(hand)], minlength=3),
        np.bincount(d.mem_pattern[memmask(d)], minlength=3)))
    elems_ok = int(hand.vl[vmask(hand)].sum()) == int(d.vl[vmask(d)].sum())
    scalar_ok = (int(hand.scalar_count.sum()) == int(d.scalar_count.sum())
                 and int(hand.dep_scalar.sum()) == int(d.dep_scalar.sum()))
    hand_regs = isa.trace_registers(hand)
    pressure_ok = (max_live <= N_LOGICAL_REGS
                   and abs(regs_used - hand_regs) <= REGS_ATOL)
    fp_eq = (len(hand) == len(d)
             and isa.trace_fingerprint(hand) == isa.trace_fingerprint(d))
    return CrossValReport(app_name, kinds_ok, fu_ok, pattern_ok, elems_ok,
                          scalar_ok, pressure_ok, hand_regs, regs_used,
                          cfg_label=cfg_label, fingerprint_eq=fp_eq)


def cross_validate(derive, apps, cfgs, device=None) -> list[CrossValReport]:
    """Derived-vs-hand-coded contract for ``apps`` x ``cfgs``.

    ``derive(app, eff_mvl, cfg)`` returns the frontend's
    ``(trace, regs_used, max_live)`` for one loop-body chunk.  The timing
    comparison for every (app, cfg) pair runs as one batch.
    """
    from repro_torch.core import engine as eng
    from repro_torch.core import suite, tracegen
    reports, bodies, pair_cfgs = [], [], []
    for cfg in cfgs:
        for app in apps:
            eff = suite.effective_mvl(app, cfg)
            hand = tracegen.body_for(app, eff, cfg)
            trace, regs_used, max_live = derive(app, eff, cfg)
            reports.append(static_report(app, hand, trace, regs_used,
                                         max_live, cfg_label=cfg.label()))
            bodies += [hand, trace]
            pair_cfgs += [cfg, cfg]
    times = eng.steady_state_time_batch(bodies, pair_cfgs, device=device)
    for r, i in zip(reports, range(0, len(times), 2)):
        r.time_hand, r.time_derived = times[i], times[i + 1]
    return reports


@dataclass
class RoundTripReport:
    """One emit→decode round trip: the codegen-emitted assembly decoded at
    one configuration vs the direct torch.fx lowering of the same kernel."""
    app: str
    mvl: int
    fingerprint_eq: bool     # decoded body bitwise-equal to the lowering
    chunks_eq: bool          # decoder trip count == characterized closed form
    valid: bool              # isa.validate_trace clean (prologue defs live)
    problems: list

    @property
    def ok(self) -> bool:
        return self.fingerprint_eq and self.chunks_eq and self.valid


def round_trip_app(app_name: str, text: str | None = None,
                   mvls=None) -> list[RoundTripReport]:
    """Round-trip one app: emit (or take ``text``), decode at every MVL,
    and hold the decoded chunk body to the direct torch.fx lowering —
    fingerprint-equal trace, bitwise-equal chunk count, clean invariants."""
    from repro_torch.core import codegen, engine as eng, frontend, rvv, suite
    from repro_torch.core import tracegen
    if text is None:
        text = codegen.emit_app(app_name)
    if mvls is None:
        mvls = rvv.CHECK_MVLS
    app = tracegen.app_for(app_name)
    out = []
    for m in mvls:
        cfg = eng.VectorEngineConfig(mvl=m, lanes=4)
        eff = suite.effective_mvl(app.name, cfg)
        problems: list[str] = []
        d = rvv.decode(text, eff, cfg, path=f"<emit:{app.name}>")
        want = frontend.derived_body(app.name, eff, cfg).trace
        fp_eq = (len(d.trace) == len(want)
                 and isa.trace_fingerprint(d.trace)
                 == isa.trace_fingerprint(want))
        if not fp_eq:
            problems.append("decoded body != torch.fx lowering")
        chunks_eq = d.chunks == float(app.chunks(eff))
        if not chunks_eq:
            problems.append(f"chunks {d.chunks!r} != "
                            f"{float(app.chunks(eff))!r}")
        invariants = d.validate()
        problems += invariants
        out.append(RoundTripReport(app.name, m, fp_eq, chunks_eq,
                                   not invariants, problems))
    return out


def round_trip_all(apps=None, mvls=None) -> list[RoundTripReport]:
    """The codegen-roundtrip contract over every app with a torch
    ``kernel=`` spec (``python -m repro_torch.core.codegen --check-all``)."""
    from repro_torch.core import tracegen
    if apps is None:
        apps = [a for a in sorted(tracegen.APPS)
                if tracegen.APPS[a].kernel is not None]
    reports = []
    for app in apps:
        reports += round_trip_app(app, mvls=mvls)
    return reports


def print_round_trips(reports: list[RoundTripReport], title: str) -> bool:
    """Render the round-trip gate table; returns the overall verdict."""
    print(f"{'app':16s} {'mvl':>4s} {'fingerprint':>12s} {'chunks':>7s} "
          f"{'valid':>6s}  ok")
    ok = True
    for r in reports:
        ok &= r.ok
        print(f"{r.app:16s} {r.mvl:4d} {str(r.fingerprint_eq):>12s} "
              f"{str(r.chunks_eq):>7s} {str(r.valid):>6s}  "
              f"{'ok' if r.ok else 'FAIL: ' + '; '.join(r.problems)}")
    print(f"\n{title}:", "ROUND-TRIPS" if ok else "MISMATCH")
    return ok


def print_reports(reports: list[CrossValReport], title: str) -> bool:
    """Render the gate table; returns the overall verdict."""
    print(f"{'app':16s} {'config':>14s} {'kinds':>6s} {'fu':>4s} {'mem':>4s} "
          f"{'elems':>6s} {'scalar':>7s} {'regs h/d':>9s} {'time err':>9s}  ok")
    ok = True
    for r in reports:
        ok &= r.ok
        print(f"{r.app:16s} {r.cfg_label:>14s} {str(r.kinds_ok):>6s} "
              f"{str(r.fu_ok):>4s} {str(r.pattern_ok):>4s} "
              f"{str(r.elems_ok):>6s} {str(r.scalar_ok):>7s} "
              f"{r.hand_regs:4d}/{r.derived_regs:<4d} "
              f"{r.time_rel_err:8.2%}  {'ok' if r.ok else 'FAIL'}")
    print(f"\n{title}:", "CONSISTENT" if ok else "MISMATCH")
    return ok
