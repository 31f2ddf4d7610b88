"""Calibrate the scalar-pipeline model against the paper's §5 anchors.

    python -m repro_torch.calibrate [--device cuda|cpu]
    python -m repro_torch.calibrate --scorecard [--device cuda|cpu]

The port of ``benchmarks/calibrate.py``.  The event-based scalar model
(``repro_torch.core.scalar_pipeline``) has one fitted parameter an app,
``mem_stall_cyc`` (the mean scalar-load stall beyond the pipelined L1 hit),
plus particlefilter's ``roi_instr_fraction`` correction; everything else
is fixed (``docs/calibration.md``).

The fit (default) solves both in closed form:

* an "eq"-anchored app's scalar-runtime target is the geomean over its
  anchors of ``paper_speedup x modeled_vector_runtime``; cycles are linear
  in ``mem_stall_cyc`` (slope: the load count), so the fit is one
  division, clipped to [0, 40] cycles;
* particlefilter publishes only "never beats scalar" bounds: its
  ``mem_stall_cyc`` is fixed at 4.0 and the ROI correction is solved
  instead (cycles are linear in ``roi_instr_fraction``), for a speedup of
  0.95 x its tightest "lt" bound;
* the three ML apps have no anchors: their targets are the frozen
  modeled baselines ``ML_TARGET_NS``.

It prints the ``ScalarProfile`` values to put in
``tracegen.SCALAR_PROFILES`` and ``max |fit - committed|``: the committed
values are a fixed point of the fit when it is under 0.05, and the command
exits 1 where they are not.

``--scorecard`` prints the 11 anchors with their relative errors, the
per-app event breakdown, the residual-error budget and the scorecard's
wall time, and exits 1 if an anchor is out of its band.

The cycle split goes through the port's ``scalar_pipeline.fold``; the
vector runtimes run on the CUDA device unless ``--device cpu`` is given.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.core import engine as eng
from repro_torch.core import scalar_pipeline as sp
from repro_torch.core import suite, tracegen
from repro_torch.core.anchors import ANCHORS, EQ_HI, EQ_LO, LT_SLACK

# particlefilter's gather-bound load stall is fixed, not fitted (its anchors
# are bounds, not targets: they pin the ROI correction instead)
PF_MEM_STALL = 4.0
# target speedup at particlefilter's tightest "lt" bound: just under it
PF_LT_MARGIN = 0.95

# The frozen modeled scalar baselines of the anchor-less ML apps (ns): the
# retired multiplier model's values, kept so the ML numbers stay continuous
# across the scalar model's replacement (the reference's constants).
ML_TARGET_NS = {
    "flash_attention": 3.0424e10,
    "decode_attention": 1.7848e9,
    "ssd_scan": 2.4750e8,
}

MEM_STALL_LO, MEM_STALL_HI = 0.0, 40.0


def _cycles_split(app: str) -> tuple[float, float, float]:
    """(cycles at mem_stall 0, load count, committed roi): cycles are
    linear in both fitted parameters, ``cyc = roi_scale x (cyc0 + n_load x
    ms)``, the segment counts already holding the committed roi."""
    seg = sp.segments_for(app)
    n_load = float(seg[4, 0])
    seg0 = seg.copy()
    seg0[4, 5] = 0.0
    cyc0, _ = sp.fold(torch.from_numpy(seg0)[None],
                      torch.tensor([sp.cfg_scalar_params(None)],
                                   dtype=torch.float32))
    roi = tracegen.scalar_profile_for(app).roi_instr_fraction
    return float(cyc0[0]), n_load, roi


def _anchor_targets(device=None) -> dict:
    """Each app's scalar-runtime target (ns): the geomean over its "eq"
    anchors of ``paper_speedup x modeled_vector_runtime``; for an app with
    only "lt" anchors, ``PF_LT_MARGIN x`` the tightest bound."""
    eq, lt = {}, {}
    for app, mvl, lanes, target, kind in ANCHORS:
        cfg = eng.VectorEngineConfig(mvl=mvl, lanes=lanes)
        v = suite.vector_runtime_ns(app, cfg, device=device)
        (eq if kind == "eq" else lt).setdefault(app, []).append(target * v)
    out = {a: float(np.exp(np.mean(np.log(ts)))) for a, ts in eq.items()}
    for a, ts in lt.items():
        if a not in out:
            out[a] = PF_LT_MARGIN * min(ts)
    out.update(ML_TARGET_NS)
    return out


def fit(device=None) -> dict:
    """Every app's fitted parameters in closed form:
    ``{app: (mem_stall_cyc, roi_instr_fraction)}``."""
    freq = eng.VectorEngineConfig().scalar_freq_ghz
    fitted = {}
    for app, target_ns in sorted(_anchor_targets(device).items()):
        target_cyc = target_ns * freq
        cyc0, n_load, roi = _cycles_split(app)
        if app == "particlefilter":
            # the stall fixed; roi solved (cycles are linear in it):
            # target = (roi / roi_now) x (cyc0 + n_load x PF_MEM_STALL)
            cyc_roi1 = (cyc0 + n_load * PF_MEM_STALL) / roi
            fitted[app] = (PF_MEM_STALL, target_cyc / cyc_roi1)
        else:
            ms = (target_cyc - cyc0) / n_load
            fitted[app] = (float(np.clip(ms, MEM_STALL_LO, MEM_STALL_HI)),
                           1.0)
    return fitted


def drift(fitted: dict) -> float:
    """``max |fit - committed|`` over both parameters of every app."""
    return max(max(abs(ms - p.mem_stall_cyc), abs(roi - p.roi_instr_fraction))
               for app, (ms, roi) in fitted.items()
               for p in (tracegen.scalar_profile_for(app),))


def print_fit(fitted: dict) -> float:
    """Print the fit beside the committed values; returns the drift."""
    print("fitted ScalarProfile parameters (paste into "
          "tracegen.SCALAR_PROFILES):")
    print(f"  {'app':16s} {'mem_stall_cyc':>13s} {'roi_frac':>9s} "
          f"{'committed':>21s}")
    for app, (ms, roi) in sorted(fitted.items()):
        prof = tracegen.scalar_profile_for(app)
        print(f"  {app:16s} {ms:13.2f} {roi:9.4f} "
              f"  ({prof.mem_stall_cyc:6.2f}, {prof.roi_instr_fraction:.4f})")
    d = drift(fitted)
    verdict = ("fixed point: committed values reproduce the fit" if d < 0.05
               else "STALE — update tracegen.SCALAR_PROFILES")
    print(f"max |fit - committed| = {d:.3g} ({verdict})")
    return d


def scorecard(device=None) -> int:
    """The accuracy scorecard: the anchors and their relative errors, the
    event breakdown, the residual budget, the wall time.  Returns an exit
    code (1 if an anchor is out of its band)."""
    t0 = time.perf_counter()
    rows = []
    for app, mvl, lanes, target, kind in ANCHORS:
        cfg = eng.VectorEngineConfig(mvl=mvl, lanes=lanes)
        rows.append((app, mvl, lanes, target, kind,
                     suite.speedup(app, cfg, device=device)))
    wall = time.perf_counter() - t0

    print("== anchor scorecard (11 paper §5 points) ==")
    print(f"  {'app':16s} {'cfg':>9s} {'model':>6s} {'paper':>6s} "
          f"{'rel-err':>8s}  verdict")
    misses = 0
    for app, mvl, lanes, target, kind, got in rows:
        rel = got / target - 1.0
        if kind == "eq":
            ok = EQ_LO <= got / target <= EQ_HI
            verdict = "ok" if ok else "MISS"
        else:
            ok = got <= target * LT_SLACK
            verdict = "ok (bound)" if ok else "MISS"
        misses += not ok
        print(f"  {app:16s} mvl={mvl:3d}x{lanes} {got:6.2f} {target:6.2f} "
              f"{rel:+8.1%}  [{kind}] {verdict}")
    eq_errs = [abs(np.log(got / target))
               for app, _, _, target, kind, got in rows if kind == "eq"]
    print(f"  geomean |log-err| over eq anchors: "
          f"{float(np.exp(np.mean(eq_errs))) - 1.0:.1%}")

    print("\n== per-app event breakdown (cycles per ROI instruction) ==")
    print(f"  {'app':16s} {'issue':>6s} {'raw':>6s} {'struct':>6s} "
          f"{'bmiss':>6s} {'mem':>6s} {'CPI':>6s}")
    bmp = eng.VectorEngineConfig().branch_miss_penalty
    for app in sorted(tracegen.APPS):
        ev = sp.scalar_events(app)
        prof = tracegen.scalar_profile_for(app)
        n = tracegen.app_for(app).counts(8).scalar_code_total \
            * prof.roi_instr_fraction
        parts = (ev["issue"], ev["raw"], ev["struct"], ev["bmiss"] * bmp,
                 ev["mem"])
        print(f"  {app:16s} " + " ".join(f"{p / n:6.3f}" for p in parts)
              + f" {sum(parts) / n:6.3f}")

    print("\n== residual-error budget ==")
    print(f"  eq anchors: model/paper within [{EQ_LO}, {EQ_HI}] — covers "
          "figure read-off error, the fitted mem_stall_cyc's one-knob "
          "coarseness, and vector-side abstraction (no OoO scalar window).")
    print("  lt anchors: hard bounds (paper's qualitative claims), "
          "no tolerance.")
    pf = tracegen.scalar_profile_for("particlefilter")
    n_pf = tracegen.app_for("particlefilter").counts(8).scalar_code_total \
        * pf.roi_instr_fraction
    print(f"  particlefilter ROI correction: roi_instr_fraction = "
          f"{pf.roi_instr_fraction:.4f} — the named term for the Table-6 "
          "(instruction counts) vs Figure-7 (timed ROI) accounting "
          "difference; replaces the retired 0.104 multiplier "
          f"(implied CPI {sp.scalar_cycles('particlefilter') / n_pf:.2f}, "
          "physical).")
    print("  ML workloads: no paper anchors; baselines are modeled "
          "(frozen pre-PR-9 continuity targets), excluded from the anchor "
          "budget.")
    print(f"\nscorecard wall-clock: {wall:.2f} s ({len(rows)} anchors)")
    return 1 if misses else 0


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(prog="python -m repro_torch.calibrate",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--scorecard", action="store_true",
                    help="print the anchor scorecard instead of fitting")
    ap.add_argument("--device", default=None,
                    help="engine device (default: the CUDA device; 'cpu' "
                         "runs the plain PyTorch scan)")
    args = ap.parse_args(argv)
    if args.scorecard:
        return scorecard(device=args.device)
    return 0 if print_fit(fit(device=args.device)) < 0.05 else 1


if __name__ == "__main__":
    raise SystemExit(main())
