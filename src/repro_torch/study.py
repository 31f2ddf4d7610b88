"""The port's sweep driver: ``benchmarks/run.py``'s sweep and DSE rows.

    python -m repro_torch.study [--device cuda|cpu] [--quick]
    python -m repro_torch.study --dse [--quick] [--dse-cache PATH]

Prints ``name,us_per_call,derived`` rows, as ``benchmarks/run.py`` does,
for two of its studies, over the golden table's 20 names (the RiVec seven,
the three ML apps and the ten ``"<app>:asm"`` variants):

- ``sweep_wallclock``: the batched ``suite.sweep_all`` (one engine scan
  launch) against the sequential per-cell ``suite.speedup`` (one launch a
  cell), wall time each and the worst relative difference
  (``max_rel_diff``), which in the port is 0: a lane's scan does not read
  another's.  The full run is the 20 names x Table 10 (480 cells);
  ``--quick`` is run.py's two apps x MVL (8, 64) x lanes (1, 8).  The
  reference's ``jit_cache`` field has no counterpart (nothing is
  compiled per shape) and is left out.
- ``steady_state_table``: each name's steady-state loop-body time at MVL
  64 x 4 lanes, with the lane and VMU utilization over the measurement
  window, from one ``steady_state_time_batch`` call.

With ``--dse`` it prints ``benchmarks/run.py --dse``'s rows instead
(``dse_study``): the design-space exploration of ``SPACE_FULL`` (1,536
configs) over all ten apps, or with ``--quick`` ``SPACE_QUICK`` (384) over
``SPACE_PRESET_APPS["quick"]``, through the persistent result cache
``--dse-cache`` (default ``results/dse_cache.jsonl`` at the repository
root, the reference's file: the keys are the same): one row
``dse_<space>_<n>cfg_<k>apps`` with the cells simulated, the hit rate and
the frontier fingerprint, then ``dse_frontier_<app>`` per app.  A repeat
run with the same cache reports ``hit_rate=1.000`` and the same
``frontier_fp``.

The engine runs on the CUDA device unless ``--device cpu`` is given.
Only ``--dse`` writes to disk (its cache).
"""
from __future__ import annotations

import time
from pathlib import Path

from repro_torch.core import engine as eng
from repro_torch.core import suite, tracegen

NAMES = tuple(sorted(tracegen.APPS)) + tracegen.ASM_APPS
QUICK = (("blackscholes", "ssd_scan"), (8, 64), (1, 8))
FULL = (NAMES, (8, 16, 32, 64, 128, 256), (1, 2, 4, 8))


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


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(prog="python -m repro_torch.study",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="run.py's quick sweep: two apps x MVL (8, 64) x "
                         "lanes (1, 8)")
    ap.add_argument("--device", default=None,
                    help="engine device (default: the CUDA device; 'cpu' "
                         "runs the plain PyTorch scan)")
    ap.add_argument("--dse", action="store_true",
                    help="the DSE rows only: SPACE_FULL x 10 apps (with "
                         "--quick SPACE_QUICK x 3) through --dse-cache")
    ap.add_argument("--dse-cache", default=str(DSE_CACHE),
                    help="persistent DSE result cache (JSONL)")
    ap.add_argument("--dse-budget-kb", type=float, default=512.0)
    args = ap.parse_args(argv)
    print("name,us_per_call,derived")
    if args.dse:
        studies = (dse_study(quick=args.quick, cache_path=args.dse_cache,
                             budget_kb=args.dse_budget_kb,
                             device=args.device),)
    else:
        studies = (steady_state_table(device=args.device),
                   sweep_wallclock(quick=args.quick, device=args.device))
    for rows in studies:
        for name, us, derived in rows:
            print(f"{name},{us:.1f},{derived}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
