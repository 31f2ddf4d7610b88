"""Event-based dual-issue in-order scalar-pipeline model (paper §3.1).

The port of ``repro/core/scalar_pipeline.py``: the speedup baseline, a
2 GHz dual-issue in-order scalar core, scored per instruction class.  The
dynamic instruction stream of an app's scalar ROI is summarized into six
class segments (simple / mul / div / trans / load / branch) from its
published counts, FU mix and ``ScalarProfile``; a fold over the six rows
accumulates the per-event-kind cycles and counts:

  * ``issue``  — issue slots (1/issue_width per instruction; macro-op
                 fusion removes one slot per fused pair)
  * ``raw``    — RAW stalls, ``raw_frac x (lat - 1)`` per instruction
  * ``struct`` — structural stalls on the unpipelined divider
  * ``bmiss`` / ``bhit`` — branch events; a miss costs the penalty
  * ``mem``    — scalar load stalls beyond the pipelined L1 hit

The reference folds with ``lax.scan``; six steps need no kernel, so the
port folds with plain torch ops on the host, a batch dimension written out
for ``scalar_runtime_ns_batch``.  The float32 operand order is the
reference's, and the results agree bitwise (``tests/test_torch_suite.py``).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.core import tracegen

EVENT_KINDS = ("issue", "raw", "struct", "bmiss", "bhit", "mem", "fused")
SEG_CLASSES = ("simple", "mul", "div", "trans", "load", "branch")

# FIXED architectural latencies (scalar-core cycles; not fitted).
OP_LATENCY = np.array([1.0, 4.0, 20.0, 24.0, 4.0, 1.0], np.float32)

# FIXED: back-to-back occupancy rate of the single unpipelined divider.
DIV_STRUCT_RATE = 0.25

_COLS = ("count", "lat", "raw_frac", "fusible", "bmiss_rate", "mem_stall",
         "is_branch", "struct_frac")
N_COLS = len(_COLS)


def segments_for(app_name: str) -> np.ndarray:
    """The (6, 8) event-segment array of one app's scalar-version ROI:
    counts computed in float64, stored in a float32 array."""
    app = tracegen.app_for(app_name)
    prof = tracegen.scalar_profile_for(app_name)
    counts = app.counts(8)               # element ops at MVL=8 (min overhead)
    n = counts.scalar_code_total * prof.roi_instr_fraction
    work = counts.vector_ops * prof.roi_instr_fraction
    n_branch = prof.branch_frac * n
    n_load = prof.load_frac * n
    n_mul = work * app.mix.get("mul", 0.0)
    n_div = work * app.mix.get("div", 0.0)
    n_trans = work * app.mix.get("trans", 0.0)
    n_simple = max(n - n_branch - n_load - n_mul - n_div - n_trans, 0.0)
    seg = np.zeros((len(SEG_CLASSES), N_COLS), np.float32)
    seg[:, 0] = (n_simple, n_mul, n_div, n_trans, n_load, n_branch)
    seg[:, 1] = OP_LATENCY
    seg[:, 2] = prof.raw_frac
    seg[0, 3] = prof.fusible_frac        # fusion pairs are simple-class
    seg[5, 4] = prof.branch_miss_rate
    seg[4, 5] = prof.mem_stall_cyc
    seg[5, 6] = 1.0
    seg[2, 7] = DIV_STRUCT_RATE
    return seg


def cfg_scalar_params(cfg=None) -> tuple:
    """``(issue_width, branch_miss_penalty, fusion, scalar_freq_ghz)`` of a
    config as np.float32 scalars; ``None`` is the Table-10 default core."""
    if cfg is None:
        from repro_torch.core import engine as eng
        cfg = eng.VectorEngineConfig()
    return (np.float32(cfg.issue_width), np.float32(cfg.branch_miss_penalty),
            np.float32(1.0 if cfg.fusion else 0.0),
            np.float32(cfg.scalar_freq_ghz))


def fold(seg: torch.Tensor, params: torch.Tensor):
    """Fold ``[B, 6, 8]`` segments under ``[B, 4]`` core parameters into
    (total cycles ``[B]``, per-kind accumulators ``[B, 7]``)."""
    issue_w, bmp, fusion_f = params[:, 0], params[:, 1], params[:, 2]
    cyc = torch.zeros(seg.shape[0], dtype=torch.float32)
    ev = torch.zeros(seg.shape[0], len(EVENT_KINDS), dtype=torch.float32)
    for k in range(seg.shape[1]):
        count, lat, raw, fusible, bmr, mem, is_br, struct = seg[:, k].unbind(1)
        fused = count * fusible * fusion_f        # fused pairs: 1 slot each
        slots = (count - fused) / issue_w
        stall_lat = torch.clamp_min(lat - 1.0, 0.0)
        raw_st = count * raw * stall_lat
        struct_st = count * struct * stall_lat
        n_miss = count * bmr
        bmiss_st = n_miss * bmp
        n_hit = count * is_br - n_miss
        mem_st = count * mem
        cyc = cyc + slots + raw_st + struct_st + bmiss_st + mem_st
        ev = ev + torch.stack([slots, raw_st, struct_st, n_miss, n_hit,
                               mem_st, fused], 1)
    return cyc, ev


def _fold_one(app_name: str, params: tuple):
    seg = torch.from_numpy(segments_for(app_name))[None]
    cyc, ev = fold(seg, torch.tensor([params], dtype=torch.float32))
    return cyc[0], ev[0]


def scalar_cycles(app_name: str, cfg=None) -> float:
    """Total modeled scalar-core cycles of the app's scalar-version ROI."""
    return float(_fold_one(app_name, cfg_scalar_params(cfg))[0])


def scalar_events(app_name: str, cfg=None) -> dict:
    """Per-event-kind accumulators (cycles for stall kinds, counts for
    ``bmiss``/``bhit``/``fused``)."""
    ev = _fold_one(app_name, cfg_scalar_params(cfg))[1]
    return dict(zip(EVENT_KINDS, (float(v) for v in ev)))


@functools.lru_cache(maxsize=None)
def _runtime_cached(app_name: str, params: tuple) -> float:
    return float(_fold_one(app_name, params)[0]) / float(params[3])


def scalar_runtime_ns(app_name: str, cfg=None) -> float:
    """Modeled scalar-version runtime (ns) on the config's scalar core,
    memoized per (app, scalar-core knobs)."""
    return _runtime_cached(app_name, cfg_scalar_params(cfg))


def scalar_runtime_ns_batch(apps, cfgs) -> list[float]:
    """``scalar_runtime_ns`` for N (app, config) pairs in one batched fold;
    bitwise equal to the sequential path."""
    if len(apps) != len(cfgs):
        raise ValueError(f"{len(apps)} apps vs {len(cfgs)} configs")
    if not apps:
        return []
    segs = torch.from_numpy(np.stack([segments_for(a) for a in apps]))
    cols = [cfg_scalar_params(c) for c in cfgs]
    cyc, _ = fold(segs, torch.tensor(cols, dtype=torch.float32))
    return [float(c) / float(p[3]) for c, p in zip(cyc.numpy(), cols)]


# --------------------------------------------------------------------------
# --check: the scalar-scorecard gate
# --------------------------------------------------------------------------

def main(argv=None) -> int:
    import argparse

    from repro_torch.core import engine as eng
    from repro_torch.core import suite

    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.core.scalar_pipeline",
        description=__doc__.splitlines()[0])
    ap.add_argument("--check", action="store_true",
                    help="verify the §5 anchors, batched-vs-sequential "
                         "bitwise equivalence and knob monotonicity "
                         "(the scalar-scorecard gate)")
    ap.add_argument("--device", default=None,
                    help="engine device for the anchors' speedups (default: "
                         "the CUDA device; 'cpu' runs the plain PyTorch "
                         "scan)")
    args = ap.parse_args(argv)
    if not args.check:
        ap.print_help()
        return 0

    failures = []
    # 1. all 11 paper §5 anchors within the documented tolerance
    from repro_torch.core.anchors import ANCHORS, EQ_LO, EQ_HI, LT_SLACK
    print("== anchors ==")
    for app, mvl, lanes, target, kind in ANCHORS:
        cfg = eng.VectorEngineConfig(mvl=mvl, lanes=lanes)
        got = suite.speedup(app, cfg, device=args.device)
        if kind == "eq":
            ok = EQ_LO <= got / target <= EQ_HI
        else:
            ok = got <= target * LT_SLACK
        mark = "ok" if ok else "MISS"
        print(f"  {app:16s} mvl={mvl:3d} L={lanes} model={got:5.2f} "
              f"paper={target:5.2f} [{kind}] {mark}")
        if not ok:
            failures.append(f"anchor {app}@{mvl}x{lanes}")

    # 2. batched == sequential, bitwise
    apps = sorted(tracegen.APPS)
    cfgs = [eng.VectorEngineConfig(issue_width=1 + i % 3,
                                   branch_miss_penalty=float(4 + 2 * (i % 4)),
                                   fusion=bool(i % 2))
            for i in range(len(apps))]
    batched = scalar_runtime_ns_batch(apps, cfgs)
    seq = [scalar_runtime_ns(a, c) for a, c in zip(apps, cfgs)]
    if batched == seq:
        print("== batched-vs-sequential: bitwise-equal "
              f"({len(apps)} pairs) ==")
    else:
        failures.append("batched != sequential")

    # 3. knob monotonicity + physical-CPI floor on every app
    for a in apps:
        t1 = scalar_runtime_ns(a, eng.VectorEngineConfig(issue_width=1))
        t2 = scalar_runtime_ns(a)
        t4 = scalar_runtime_ns(a, eng.VectorEngineConfig(issue_width=4))
        bp = scalar_runtime_ns(
            a, eng.VectorEngineConfig(branch_miss_penalty=20.0))
        fu = scalar_runtime_ns(a, eng.VectorEngineConfig(fusion=True))
        if not (t1 > t2 >= t4 and bp > t2 and fu < t2):
            failures.append(f"monotonicity {a}")
        prof = tracegen.scalar_profile_for(a)
        counts = tracegen.app_for(a).counts(8)
        n_roi = counts.scalar_code_total * prof.roi_instr_fraction
        cpi = scalar_cycles(a) / n_roi
        if cpi < 0.5:
            failures.append(f"non-physical CPI {a}: {cpi:.3f}")
    if not any(f.startswith(("monotonicity", "non-physical"))
               for f in failures):
        print("== knob monotonicity + CPI floor: ok "
              f"({len(apps)} apps) ==")

    if failures:
        print("FAILURES:", ", ".join(failures))
        return 1
    print("scalar-scorecard: PASS")
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
