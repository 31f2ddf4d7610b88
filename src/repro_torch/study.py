"""The port's study driver: ``benchmarks/run.py``'s row groups.

    python -m repro_torch.study [--device cuda|cpu] [--quick]
    python -m repro_torch.study --scalar | --rvv | --profile [--quick]
    python -m repro_torch.study --dse [--quick] [--dse-cache PATH]

Prints ``name,us_per_call,derived`` rows, as ``benchmarks/run.py`` does,
with its row names, order and ``derived`` formats, one function a row
group:

- ``table_3_to_9_characterization``: each app's instruction counts against
  the paper's Tables 3-9 (``max_err``) and its VAO speedup;
- ``figures_4_to_10_scalability``, ``sweep_llc``, ``sweep_mshr``: the
  Fig 4-10 grid with the Fig-10 LLC pair, the LLC grid and the MSHR
  saturation study, each one ``suite.speedup_batch`` call (one engine scan
  launch);
- ``frontend_crossval``, ``rvv_rows``, ``codegen_rows``: the torch.fx
  frontend and the RVV decoder against the hand-coded bodies, the decode
  times, the ``:asm`` sweep's parity, and the code generator's emit times
  and round trips;
- ``steady_state_table``: each name's steady-state loop-body time at MVL
  64 x 4 lanes with the lane and VMU utilization (the golden table's 20
  names: the RiVec seven, the three ML apps and the ten ``:asm``
  variants);
- ``scalar_rows``: each app's scalar baseline against the pre-event-model
  one (``_OLD_SCALAR_NS``), the 11 anchors and the scorecard's wall time;
- ``profile_rows``: the telemetry scorecard (the top bottleneck, the
  module fractions and the event-sum identity error a row) and a Chrome
  trace of blackscholes, written to ``results/timeline_blackscholes.json``
  at the repository root (``--timeline``; never ``examples/``).  The
  reference's ``jit_cache`` field has no counterpart (nothing is compiled
  per shape): its place holds ``collect_launches``, the collect build's
  launches (``engine_scan.scan_collect.launches``) over the group;
- ``kernel_microbench``: the suite's kernels through
  ``repro_torch.kernels.ops`` at run.py's shapes, inputs from numpy with a
  fixed seed, each timed by CUDA events around 3 calls after a warm one
  (on the CPU, the plain versions on the host clock).  The Pallas tiling
  arguments (``rows_per_block``, ``bq``, ``bk``) have no counterpart: the
  CUDA kernels take any size, so they are dropped;
- ``sweep_wallclock``: the batched ``suite.sweep_all`` (one launch)
  against the sequential per-cell ``suite.speedup`` (one launch a cell),
  wall time each and the worst relative difference (``max_rel_diff``),
  which in the port is 0; full: the 20 names x Table 10 (480 cells),
  ``--quick``: run.py's two apps x MVL (8, 64) x lanes (1, 8).  The
  ``jit_cache`` field is left out, as above;
- ``dse_study`` (``--dse``): the design-space exploration of ``SPACE_FULL``
  (1,536 configs) over all ten apps, or with ``--quick`` ``SPACE_QUICK``
  (384) over ``SPACE_PRESET_APPS["quick"]``, through the persistent result
  cache ``--dse-cache`` (default ``results/dse_cache.jsonl`` at the
  repository root, the reference's file: the keys are the same): one row
  ``dse_<space>_<n>cfg_<k>apps`` with the cells simulated, the hit rate and
  the frontier fingerprint, then ``dse_frontier_<app>`` per app.  A repeat
  run with the same cache reports ``hit_rate=1.000`` and the same
  ``frontier_fp``.

Without a flag it runs run.py's full list, with ``--quick`` its smoke list
(no kernel microbenchmarks, the small sweep), with ``--scalar``, ``--rvv``
or ``--profile`` that group alone.  run.py's ``roofline_table``,
``surrogate_rows`` and ``serve_rows`` have no counterpart yet: they come
with the port of the surrogate search, the simulation service and the
system seed (ROADMAP Queue 1, items 2-4).

The machine-readable sections (run.py's ``_BENCH``) are merged into
``--bench-json`` (default ``results/bench_torch.json`` at the repository
root), as run.py merges: an existing file's other sections stay.  It
never writes ``BENCH_*.json``.

The engine and the kernels run on the CUDA device unless ``--device cpu``
is given.
"""
from __future__ import annotations

import json
import os
import time
from pathlib import Path

import numpy as np

from repro_torch.core import engine as eng
from repro_torch.core import suite, tracegen

NAMES = tuple(sorted(tracegen.APPS)) + tracegen.ASM_APPS
QUICK = (("blackscholes", "ssd_scan"), (8, 64), (1, 8))
FULL = (NAMES, (8, 16, 32, 64, 128, 256), (1, 2, 4, 8))
RESULTS = Path(__file__).resolve().parents[2] / "results"
BENCH_JSON = RESULTS / "bench_torch.json"
TIMELINE = RESULTS / "timeline_blackscholes.json"

# the machine-readable sections collected while the driver runs; main()
# merges them into --bench-json
_BENCH: dict = {}


def table_3_to_9_characterization() -> list[tuple]:
    """Each app's instruction counts against the paper's Tables 3-9."""
    from repro_torch.core import characterize as ch
    rows = []
    for app in ch.PAPER_TABLES:
        t0 = time.perf_counter()
        errs = ch.compare_to_paper(app)
        us = (time.perf_counter() - t0) * 1e6
        worst = max(v for r in errs for k, v in r.items()
                    if k.startswith("err"))
        rows.append((f"table_characterization_{app}", us,
                     f"max_err={worst:.4f}"))
        vao = ch.characterize(app, 8).vao_speedup
        rows.append((f"vao_speedup_{app}", 0.0, f"{vao:.3f}"))
    return rows


FIG_APPS = ("blackscholes", "canneal", "jacobi-2d", "particlefilter",
            "pathfinder", "streamcluster", "swaptions")


def figures_4_to_10_scalability(device=None) -> list[tuple]:
    """The Figures 4-10 grid, with Fig 10's swaptions LLC pair in the same
    batch: one ``speedup_batch`` call."""
    pairs = [(app, eng.VectorEngineConfig(mvl=mvl, lanes=lanes))
             for app in FIG_APPS for mvl in (8, 64, 256) for lanes in (1, 8)]
    pairs += [("swaptions", eng.VectorEngineConfig(mvl=256, lanes=8,
                                                   l2_kb=l2))
              for l2 in (256, 1024)]
    t0 = time.perf_counter()
    speedups = suite.speedup_batch(pairs, device=device)
    us_each = (time.perf_counter() - t0) * 1e6 / len(pairs)
    rows = []
    for (app, cfg), s in zip(pairs[:-2], speedups[:-2]):
        rows.append((f"fig_scalability_{app}_mvl{cfg.mvl}_l{cfg.lanes}",
                     us_each, f"speedup={s:.2f}"))
    for (app, cfg), s in zip(pairs[-2:], speedups[-2:]):
        rows.append((f"fig10_swaptions_l2_{cfg.l2_kb}kb", us_each,
                     f"speedup={s:.2f}"))
    return rows


def sweep_llc(device=None) -> list[tuple]:
    """Fig 10 as a batched study: the LLC grid {256 KB, 1 MB} for the
    memory-stressed apps against a compute-bound control, one batch."""
    apps = ("streamcluster", "canneal", "swaptions", "blackscholes")
    pairs = [(a, eng.VectorEngineConfig(mvl=mvl, lanes=8, l2_kb=l2))
             for a in apps for l2 in (256, 1024) for mvl in (64, 256)]
    t0 = time.perf_counter()
    vals = suite.speedup_batch(pairs, device=device)
    us_each = (time.perf_counter() - t0) * 1e6 / len(pairs)
    return [(f"sweep_llc_{a}_{c.label()}", us_each, f"speedup={s:.2f}")
            for (a, c), s in zip(pairs, vals)]


def sweep_mshr(device=None) -> list[tuple]:
    """MSHR saturation: one MSHR serializes the indexed (gather) misses;
    canneal degrades, the unit-stride apps stay within noise."""
    apps = ("canneal", "blackscholes", "jacobi-2d")
    pairs = [(a, eng.VectorEngineConfig(mvl=64, lanes=4, mshrs=m))
             for a in apps for m in (1, 4, 16)]
    t0 = time.perf_counter()
    vals = suite.speedup_batch(pairs, device=device)
    us_each = (time.perf_counter() - t0) * 1e6 / len(pairs)
    return [(f"sweep_mshr_{a}_{c.label()}", us_each, f"speedup={s:.2f}")
            for (a, c), s in zip(pairs, vals)]


def frontend_crossval(device=None) -> list[tuple]:
    """The torch.fx frontend against the hand-coded bodies: the static
    mixes exactly, the steady-state time within 5 %."""
    from repro_torch.core import frontend as fe
    t0 = time.perf_counter()
    reports = fe.cross_validate_all(device=device)
    us_each = (time.perf_counter() - t0) * 1e6 / len(reports)
    _BENCH["frontend_crossval"] = {
        "all_ok": all(r.ok for r in reports),
        "worst_time_rel_err": max(r.time_rel_err for r in reports),
        "apps": sorted({r.app for r in reports}),
    }
    return [(f"frontend_crossval_{r.app}", us_each,
             f"time_err={r.time_rel_err:.4f}|{'ok' if r.ok else 'FAIL'}")
            for r in reports]


def rvv_rows(quick: bool = False, device=None) -> list[tuple]:
    """The RVV decoder: each corpus app's decode time, the decoded bodies
    against the hand-coded ones (``--quick``: at MVL 64 x 4 and 16 x 2;
    full: every MVL of ``rvv.CHECK_MVLS``), and the ``:asm`` sweep against
    the hand-coded suite."""
    from repro_torch.core import rvv
    rows = []
    cfg = eng.VectorEngineConfig(mvl=64, lanes=4)
    corpus = [a for a in sorted(tracegen.APPS) if tracegen.APPS[a].asm]
    rvv._DECODE_CACHE.clear()
    t0 = time.perf_counter()
    for app in corpus:
        ta = time.perf_counter()
        d = rvv.decode_app(app, suite.effective_mvl(app, cfg), cfg)
        us = (time.perf_counter() - ta) * 1e6
        rows.append((f"rvv_decode_{app}", us,
                     f"{len(d.trace)}entries|chunks={d.chunks:g}"))
    decode_wall = time.perf_counter() - t0
    cfgs = [cfg, eng.VectorEngineConfig(mvl=16, lanes=2)] if quick else None
    t0 = time.perf_counter()
    reports = rvv.cross_validate_all(cfgs=cfgs, device=device)
    crossval_wall = time.perf_counter() - t0
    worst = max(r.time_rel_err for r in reports)
    for r in reports:
        rows.append((f"rvv_crossval_{r.app}_{r.cfg_label}", 0.0,
                     f"time_err={r.time_rel_err:.4f}"
                     f"|{'bitwise' if r.fingerprint_eq else 'mix-exact'}"
                     f"|{'ok' if r.ok else 'FAIL'}"))
    t0 = time.perf_counter()
    asm_tab = suite.sweep_all(tracegen.ASM_APPS, mvls=(8, 64, 256),
                              lanes=(1, 8), device=device)
    hand_tab = suite.sweep_all(corpus, mvls=(8, 64, 256), lanes=(1, 8),
                               device=device)
    sweep_wall = time.perf_counter() - t0
    worst_sweep = max(
        abs(asm_tab[f"{a}:asm"][k] - hand_tab[a][k]) / hand_tab[a][k]
        for a in corpus for k in hand_tab[a])
    rows.append(("rvv_asm_sweep_parity", sweep_wall * 1e6,
                 f"max_rel_diff={worst_sweep:.2e}|cells="
                 f"{sum(len(v) for v in asm_tab.values())}"))
    _BENCH["rvv"] = {
        "decode_wall_s": decode_wall,
        "crossval_wall_s": crossval_wall,
        "all_ok": all(r.ok for r in reports),
        "worst_time_rel_err": worst,
        "n_reports": len(reports),
        "n_bitwise_identical": sum(r.fingerprint_eq for r in reports),
        "asm_sweep_max_rel_diff": worst_sweep,
    }
    return rows


def codegen_rows(quick: bool = False) -> list[tuple]:
    """The code generator: each app's emit time, and the emit-decode round
    trips against the direct lowering (``--quick``: at MVL 8 and 256;
    full: every MVL of ``rvv.CHECK_MVLS``).  Host only."""
    from repro_torch.core import codegen, crossval
    rows = []
    apps = [a for a in sorted(tracegen.APPS)
            if tracegen.APPS[a].kernel is not None]
    texts = {}
    for app in apps:
        t0 = time.perf_counter()
        texts[app] = codegen.emit_app(app)
        us = (time.perf_counter() - t0) * 1e6
        rows.append((f"codegen_emit_{app}", us,
                     f"{len(texts[app].splitlines())}lines"))
    mvls = (8, 256) if quick else None
    t0 = time.perf_counter()
    reports = []
    for app in apps:
        reports += crossval.round_trip_app(app, text=texts[app], mvls=mvls)
    wall = time.perf_counter() - t0
    for r in reports:
        rows.append((f"codegen_roundtrip_{r.app}_mvl{r.mvl}", 0.0,
                     f"{'bitwise' if r.fingerprint_eq else 'DIVERGED'}"
                     f"|{'ok' if r.ok else 'FAIL'}"))
    _BENCH["codegen"] = {
        "roundtrip_wall_s": wall,
        "all_ok": all(r.ok for r in reports),
        "n_reports": len(reports),
        "n_bitwise": sum(r.fingerprint_eq for r in reports),
        "emitted_lines": {a: len(t.splitlines()) for a, t in texts.items()},
    }
    return rows


# The pre-event-model scalar baselines (ns), frozen so the scalar rows
# report the drift across the model's replacement (run.py's copy).
_OLD_SCALAR_NS = {
    "blackscholes": 7.857e9, "canneal": 6.160e9, "jacobi-2d": 7.835e9,
    "particlefilter": 2.172e9, "pathfinder": 7.115e9,
    "streamcluster": 3.999e10, "swaptions": 2.669e10,
    "flash_attention": 3.042e10, "decode_attention": 1.785e9,
    "ssd_scan": 2.475e8,
}


def scalar_rows(device=None) -> list[tuple]:
    """The scalar baseline: each app's runtime against the old model's,
    its CPI, the 11 anchors' relative errors and the scorecard's wall
    time."""
    from repro_torch.core import scalar_pipeline as sp
    from repro_torch.core.anchors import ANCHORS
    rows = []
    bench = _BENCH.setdefault("scalar", {})
    for app in sorted(_OLD_SCALAR_NS):
        t0 = time.perf_counter()
        new = sp.scalar_runtime_ns(app)
        us = (time.perf_counter() - t0) * 1e6
        old = _OLD_SCALAR_NS[app]
        prof = tracegen.scalar_profile_for(app)
        n = tracegen.app_for(app).counts(8).scalar_code_total \
            * prof.roi_instr_fraction
        cpi = sp.scalar_cycles(app) / n
        rows.append((f"scalar_baseline_{app}", us,
                     f"old={old:.4g}ns|new={new:.4g}ns|"
                     f"ratio={new / old:.4f}|cpi={cpi:.3f}"))
        bench[app] = {"old_ns": old, "new_ns": new, "cpi": cpi}
    t0 = time.perf_counter()
    anchor_rows = []
    for app, mvl, lanes, target, kind in ANCHORS:
        cfg = eng.VectorEngineConfig(mvl=mvl, lanes=lanes)
        got = suite.speedup(app, cfg, device=device)
        anchor_rows.append((f"scalar_anchor_{app}_mvl{mvl}_l{lanes}", 0.0,
                            f"model={got:.3f}|paper={target:.3f}|"
                            f"rel_err={got / target - 1.0:+.3f}|{kind}"))
        bench.setdefault("anchors", {})[f"{app}@{mvl}x{lanes}"] = {
            "model": got, "paper": target, "kind": kind}
    wall = time.perf_counter() - t0
    rows += anchor_rows
    rows.append(("scalar_scorecard_wallclock", wall * 1e6,
                 f"{len(anchor_rows)}_anchors"))
    bench["scorecard_wallclock_s"] = wall
    return rows


def profile_rows(quick: bool = False, timeline_path=None,
                 device=None) -> list[tuple]:
    """The profiler's rows: the per-app telemetry scorecard at MVL 64 x 4
    (plus the out-of-order crossbar corner in full mode), each row the top
    bottleneck module, the module fractions and the event-sum identity
    error, and a Chrome-trace timeline of blackscholes at
    ``timeline_path`` (default ``results/timeline_blackscholes.json``).
    Where run.py records the jit cache's size, the port records the
    collect build's launches over the group (``collect_launches``)."""
    from repro_torch.core import telemetry
    from repro_torch.kernels import engine_scan
    cfgs = [eng.VectorEngineConfig(mvl=64, lanes=4)]
    if not quick:
        cfgs.append(eng.VectorEngineConfig(mvl=256, lanes=8, ooo_issue=True,
                                           interconnect="crossbar"))
    launches0 = engine_scan.scan_collect.launches
    t0 = time.perf_counter()
    rep = telemetry.scorecard(cfgs=cfgs, device=device)
    wall = time.perf_counter() - t0
    us_each = wall * 1e6 / len(rep.rows)
    worst_ident = max(r["identity_rel_err"] for r in rep.rows)
    rows = []
    for r in rep.rows:
        fracs = "|".join(f"{m}={r['modules'][m]:.3f}"
                         for m in telemetry.MODULES)
        rows.append((f"profile_{r['app']}_{r['config']}", us_each,
                     f"top={r['top']}|{fracs}"
                     f"|ident_err={r['identity_rel_err']:.1e}"))
    path = Path(timeline_path) if timeline_path else TIMELINE
    path.parent.mkdir(parents=True, exist_ok=True)
    app, cfg = "blackscholes", cfgs[0]
    body = tracegen.body_for(app, suite.effective_mvl(app, cfg), cfg)
    doc = telemetry.write_chrome_trace(str(path), body.tile(2), cfg,
                                       label=app, device=device)
    rows.append(("profile_timeline_blackscholes", 0.0,
                 f"{len(doc['traceEvents'])}events"
                 f"|{os.path.normpath(path)}"))
    _BENCH["profile"] = {
        "scorecard": rep.to_dict(), "wall_s": wall,
        "worst_identity_rel_err": worst_ident,
        "timeline": os.path.normpath(path),
        "collect_launches": engine_scan.scan_collect.launches - launches0,
    }
    return rows


def _time_us(fn, *args, device, reps: int = 3) -> float:
    """Microseconds a call of ``fn(*args)`` after a warm call: CUDA events
    around ``reps`` calls on the card, the host clock on the CPU."""
    import torch
    fn(*args)
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn(*args)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) * 1e3 / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        fn(*args)
    return (time.perf_counter() - t0) * 1e6 / reps


def kernel_inputs(seed: int = 0) -> dict:
    """run.py's microbenchmark operands, drawn from numpy with ``seed``
    (its shapes and ranges; the values are not JAX's)."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    n = 16384
    uni = lambda lo, hi, shape: rng.uniform(lo, hi, shape).astype(f32)
    normal = lambda *shape: rng.standard_normal(shape).astype(f32)
    x = normal(1, 512, 4, 16)
    bm = normal(1, 512, 32)
    return {
        "blackscholes": (uni(10, 100, n), uni(10, 100, n),
                         np.full(n, 0.05, f32), uni(0.1, 0.6, n),
                         uni(0.2, 2.0, n),
                         (rng.uniform(size=n) > 0.5).astype(np.int32)),
        "jacobi2d": (normal(258, 512),),
        "pathfinder": (uni(0, 1, (64, 512)),),
        "streamcluster": (normal(1024, 128), normal(512, 128)),
        "swaptions": (uni(1e-5, 1 - 1e-5, n),),
        "canneal": (rng.integers(0, 1000, (1024, 2)).astype(f32),
                    rng.integers(-1, 1024, (512, 24)).astype(np.int32),
                    rng.integers(0, 1000, (512, 2)).astype(f32),
                    rng.integers(0, 1000, (512, 2)).astype(f32)),
        "particlefilter": (np.sort(uni(0, 1, 8192)), uni(0, 1, 1024)),
        "flash_attention": (normal(1, 512, 4, 64),),
        "ssd_scan": (x, np.log1p(np.exp(normal(1, 512, 4))).astype(f32),
                     -np.exp(normal(4) * 0.3).astype(f32), bm, bm),
    }


def kernel_microbench(device=None) -> list[tuple]:
    """The suite's kernels through ``kernels.ops`` at run.py's shapes."""
    import torch
    from repro_torch import _device
    from repro_torch.kernels import ops
    dev = _device.resolve(device)
    inp = {k: tuple(torch.from_numpy(a).to(dev) for a in v)
           for k, v in kernel_inputs().items()}
    t = lambda fn, *a: _time_us(fn, *a, device=dev)
    rows = []
    n = inp["blackscholes"][0].numel()
    us = t(ops.blackscholes, *inp["blackscholes"])
    rows.append(("kernel_blackscholes", us, f"{n / us:.1f}Mopt_s"))
    a = inp["jacobi2d"][0]
    us = t(ops.jacobi2d_step, a)
    rows.append(("kernel_jacobi2d", us, f"{a.numel() / us:.0f}Melem_s"))
    us = t(ops.pathfinder, *inp["pathfinder"])
    rows.append(("kernel_pathfinder", us, ""))
    p, c = inp["streamcluster"]
    us = t(ops.streamcluster_dist, p, c)
    gf = 2 * p.shape[0] * c.shape[0] * 128 / us / 1e3
    rows.append(("kernel_streamcluster_dist", us, f"{gf:.2f}GFLOP_s"))
    us = t(ops.cum_normal_inv, *inp["swaptions"])
    rows.append(("kernel_swaptions_cni", us, ""))
    us = t(ops.canneal_swap_cost, *inp["canneal"])
    rows.append(("kernel_canneal_swapcost", us, ""))
    us = t(ops.particlefilter_findindex, *inp["particlefilter"])
    rows.append(("kernel_pf_findindex", us, ""))
    q = inp["flash_attention"][0]
    us = t(lambda q: ops.flash_attention(q, q, q), q)
    rows.append(("kernel_flash_attention", us, ""))
    us = t(lambda *a: ops.ssd_scan(*a, chunk=128), *inp["ssd_scan"])
    rows.append(("kernel_ssd_scan", us, ""))
    return rows



def sweep_wallclock(quick: bool = False, device=None) -> list[tuple]:
    """The batched sweep against the sequential per-cell path."""
    apps, mvls, lanes = QUICK if quick else FULL
    n = len(apps) * len(mvls) * len(lanes)
    t0 = time.perf_counter()
    batched = suite.sweep_all(apps, mvls=mvls, lanes=lanes, device=device)
    t_batched = time.perf_counter() - t0
    t0 = time.perf_counter()
    seq = {a: {(m, l): suite.speedup(a, eng.VectorEngineConfig(mvl=m,
                                                               lanes=l),
                                     device=device)
               for m in mvls for l in lanes} for a in apps}
    t_seq = time.perf_counter() - t0
    worst = max(abs(batched[a][k] - seq[a][k]) / seq[a][k]
                for a in apps for k in seq[a])
    label = "quick" if quick else "full"
    _BENCH["sweep"] = {
        "mode": label, "n_cells": n, "apps": list(apps),
        "wall_s_batched": t_batched, "wall_s_sequential": t_seq,
        "batched_speedup": t_seq / t_batched, "max_rel_diff": worst,
    }
    return [
        (f"sweep_{label}_{n}cfg_batched", t_batched * 1e6,
         f"wall_s={t_batched:.2f}"),
        (f"sweep_{label}_{n}cfg_sequential", t_seq * 1e6,
         f"wall_s={t_seq:.2f}"),
        (f"sweep_{label}_batched_speedup", 0.0,
         f"{t_seq / t_batched:.1f}x|max_rel_diff={worst:.2e}"),
    ]


STEADY_CFG = eng.VectorEngineConfig(mvl=64, lanes=4)


def steady_state(names=NAMES, device=None) -> list[dict]:
    """Each name's ``{"steady_ns", "lane_util", "vmu_util"}`` at
    ``STEADY_CFG``, all names in one engine scan."""
    cfg = STEADY_CFG
    bodies = [tracegen.body_for(a, suite.effective_mvl(a, cfg), cfg)
              for a in names]
    return eng.steady_state_time_batch(bodies, [cfg] * len(names),
                                       with_util=True, device=device)


def steady_state_table(names=NAMES, device=None) -> list[tuple]:
    """Each name's steady-state loop-body time at the reference config."""
    cfg = STEADY_CFG
    for a in names:     # build the bodies outside the timed call
        tracegen.body_for(a, suite.effective_mvl(a, cfg), cfg)
    t0 = time.perf_counter()
    rows = steady_state(names, device)
    us_each = (time.perf_counter() - t0) * 1e6 / len(names)
    _BENCH["steady_state_ns"] = {a: r["steady_ns"]
                                 for a, r in zip(names, rows)}
    _BENCH["steady_state_util"] = {
        a: {"lane_util": r["lane_util"], "vmu_util": r["vmu_util"]}
        for a, r in zip(names, rows)}
    _BENCH["steady_state_config"] = cfg.label()
    return [(f"steady_state_{a}_{cfg.label()}", us_each,
             f"{r['steady_ns']:.1f}ns|lane_util={r['lane_util']:.3f}"
             f"|vmu_util={r['vmu_util']:.3f}")
            for a, r in zip(names, rows)]


DSE_CACHE = Path(__file__).resolve().parents[2] / "results" / "dse_cache.jsonl"


def dse_study(quick: bool = False, cache_path=DSE_CACHE,
              budget_kb: float = 512.0, device=None) -> list[tuple]:
    """``benchmarks/run.py``'s DSE rows through the port: the space's
    exploration through the cache at ``cache_path``, reduced to per-app
    Pareto frontiers and the best config under ``budget_kb``."""
    from repro_torch.configs import vector_engine as vcfg
    from repro_torch.core import dse
    space = vcfg.SPACE_QUICK if quick else vcfg.SPACE_FULL
    apps = vcfg.SPACE_PRESET_APPS["quick" if quick else "full"]
    cache = dse.ResultCache(str(cache_path) if cache_path else None)
    t0 = time.perf_counter()
    res = dse.explore(space, apps, cache=cache, device=device)
    wall = time.perf_counter() - t0
    frontiers = res.frontiers()
    fp = dse._frontier_fingerprint(res)
    _BENCH["dse"] = {
        "space": res.space, "n_configs": res.n_configs,
        "apps": list(res.apps), "n_cells": len(res.records),
        "wall_s": wall, "cache": res.stats,
        "cache_path": str(cache_path) if cache_path else None,
        "frontier_fingerprint": fp,
        "frontiers": dse.frontier_summary(res, budgets=(256.0, budget_kb,
                                                        1024.0)),
    }
    rows = [(f"dse_{res.space}_{res.n_configs}cfg_{len(res.apps)}apps",
             wall * 1e6,
             f"wall_s={wall:.2f}|simulated={res.stats['simulated']}"
             f"|hit_rate={res.stats['hit_rate']:.3f}"
             f"|devices={res.stats['devices']}|frontier_fp={fp}")]
    by_app = res.by_app()
    for app in res.apps:
        best = dse.best_under_budget(by_app[app], budget_kb)
        rows.append((f"dse_frontier_{app}", 0.0,
                     f"{len(frontiers[app])}pts|best{budget_kb:g}kb="
                     f"{best.label if best else 'none'}"))
    return rows


def row_groups(args) -> list[tuple]:
    """``(name, rows function)`` of each row group a command line runs, in
    run.py's order."""
    dev, quick = args.device, args.quick
    if args.dse:
        return [("dse", lambda: dse_study(
            quick=quick, cache_path=args.dse_cache,
            budget_kb=args.dse_budget_kb, device=dev))]
    profile = ("profile", lambda: profile_rows(
        quick=quick, timeline_path=args.timeline, device=dev))
    rvv = ("rvv", lambda: rvv_rows(quick=quick, device=dev))
    scalar = ("scalar", lambda: scalar_rows(device=dev))
    if args.profile:
        return [profile]
    if args.rvv:
        return [rvv]
    if args.scalar:
        return [scalar]
    groups = [("characterization", table_3_to_9_characterization),
              ("scalability", lambda: figures_4_to_10_scalability(device=dev)),
              ("llc", lambda: sweep_llc(device=dev)),
              ("mshr", lambda: sweep_mshr(device=dev)),
              ("frontend", lambda: frontend_crossval(device=dev)), rvv,
              ("codegen", lambda: codegen_rows(quick=quick)),
              ("steady_state", lambda: steady_state_table(device=dev)),
              scalar, profile]
    if not quick:
        groups.append(("kernels", lambda: kernel_microbench(device=dev)))
    groups.append(("sweep", lambda: sweep_wallclock(quick=quick,
                                                    device=dev)))
    return groups


def write_bench(path) -> None:
    """Merge this run's sections into the JSON file at ``path``: an
    existing file's other sections stay (run.py's merge)."""
    path = Path(path)
    merged = {}
    if path.exists():
        try:
            merged = json.loads(path.read_text())
        except (OSError, ValueError):
            merged = {}
    merged.update(_BENCH)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(merged, indent=1, sort_keys=True) + "\n")


def parse_args(argv=None):
    import argparse
    ap = argparse.ArgumentParser(prog="python -m repro_torch.study",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="run.py's smoke list: no kernel microbenchmarks, "
                         "the quick rvv / codegen / profile groups and the "
                         "small sweep (two apps x MVL (8, 64) x lanes (1, "
                         "8)); with --dse SPACE_QUICK x 3 apps")
    ap.add_argument("--device", default=None,
                    help="engine and kernel device (default: the CUDA "
                         "device; 'cpu' runs the plain PyTorch versions)")
    ap.add_argument("--dse", action="store_true",
                    help="the DSE rows only: SPACE_FULL x 10 apps (with "
                         "--quick SPACE_QUICK x 3) through --dse-cache")
    ap.add_argument("--scalar", action="store_true",
                    help="the scalar-baseline rows only")
    ap.add_argument("--rvv", action="store_true",
                    help="the RVV decoder rows only")
    ap.add_argument("--profile", action="store_true",
                    help="the profiler's rows only (scorecard and the "
                         "blackscholes timeline)")
    ap.add_argument("--dse-cache", default=str(DSE_CACHE),
                    help="persistent DSE result cache (JSONL)")
    ap.add_argument("--dse-budget-kb", type=float, default=512.0)
    ap.add_argument("--timeline", default=str(TIMELINE),
                    help="where the profile rows write the blackscholes "
                         "Chrome trace")
    ap.add_argument("--bench-json", default=str(BENCH_JSON),
                    help="the machine-readable sections, merged into this "
                         "file")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    _BENCH.clear()
    print("name,us_per_call,derived")
    for _, group in row_groups(args):
        for name, us, derived in group():
            print(f"{name},{us:.1f},{derived}")
    write_bench(args.bench_json)
    print(f"# wrote {os.path.normpath(args.bench_json)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
