"""Serving benchmark: the simulation service under Poisson arrivals.

The port of ``benchmarks/serve_bench.py``.  Drives
``repro_torch.serve.sim_service.SimService`` with a seeded Poisson request
stream (apps x sampled DSE configs) in realtime — sleeping out the true
inter-arrival gaps — and reports the acceptance quantities: sustained
throughput (requests/sec), p50/p99 latency, cache hit / coalesce / shed
counts and steady-state rebuilds (``engine.jit_cache_size``), then repeats
the identical stream against the persisted cache, which must answer >= 99 %
of requests as hits with bitwise-identical times.

Standalone: ``python -m repro_torch.serve_bench [--quick] [--cache PATH]
[--device cpu]``; ``python -m repro_torch.study --serve`` embeds the same
study in its ``--bench-json``.  The engine runs on the CUDA device unless
``device="cpu"`` is given.
"""
from __future__ import annotations

import time


def _workload(quick: bool, seed: int):
    from repro_torch.configs import vector_engine as vcfg
    from repro_torch.serve.sim_service import poisson_arrivals
    if quick:
        apps = ("blackscholes", "canneal")
        cfgs = tuple(vcfg.SPACE_SMOKE.sample(16, seed=seed + 1))
        n, rate = 96, 400.0
    else:
        # the full stream mixes hand-coded, torch.fx-derived and RVV-assembly
        # trace sources — the service must coalesce across all of them
        apps = ("blackscholes", "canneal", "ssd_scan", "pathfinder:asm")
        cfgs = tuple(vcfg.SPACE_QUICK.sample(32, seed=seed + 1))
        n, rate = 400, 200.0
    return poisson_arrivals(n, rate, apps, cfgs, seed=seed), apps, cfgs, rate


def serve_study(quick: bool = False, cache_path: str | None = None,
                seed: int = 0, realtime: bool = True,
                max_batch: int = 16, device=None):
    """Run the two-pass serving study; returns (csv rows, bench-json dict).
    Beside the reference's keys the dict holds ``device`` and ``builds``:
    the build count (``engine.jit_cache_size``) before and after prewarm
    and after the repeat pass."""
    from repro_torch.core import dse
    from repro_torch.core import engine as eng
    from repro_torch.serve.sim_service import SimService, run_workload

    arrivals, apps, cfgs, rate = _workload(quick, seed)
    svc = SimService(cache=dse.ResultCache(cache_path), max_batch=max_batch,
                     device=device)
    builds = {"before_prewarm": eng.jit_cache_size()}
    t0 = time.perf_counter()
    n_warmed = svc.prewarm()
    prewarm_s = time.perf_counter() - t0
    builds["after_prewarm"] = eng.jit_cache_size()
    rep1 = run_workload(svc, arrivals, realtime=realtime)

    # repeat pass: fresh service, cache re-read from disk when persistent
    svc2 = SimService(cache=dse.ResultCache(cache_path) if cache_path
                      else svc.cache, max_batch=max_batch, device=device)
    rep2 = run_workload(svc2, arrivals, realtime=realtime)
    builds["after_repeat"] = eng.jit_cache_size()
    r1 = sorted(rep1.results, key=lambda r: r.uid)
    r2 = sorted(rep2.results, key=lambda r: r.uid)
    bitwise = (len(r1) == len(r2) and
               all(a.steady_ns == b.steady_ns and a.app == b.app
                   for a, b in zip(r1, r2)))
    ok = (rep1.recompiles == 0 and rep2.hit_fraction >= 0.99 and bitwise
          and rep1.shed == 0)

    label = "quick" if quick else "full"
    rows = [
        (f"serve_{label}_throughput", rep1.wall_s * 1e6,
         f"{rep1.throughput_rps:.1f}req_s|n={rep1.n}|rate={rate:g}Hz"),
        (f"serve_{label}_latency", 0.0,
         f"p50={rep1.p50_ms:.2f}ms|p99={rep1.p99_ms:.2f}ms"
         f"|mean={rep1.mean_ms:.2f}ms"),
        (f"serve_{label}_batching", 0.0,
         f"dispatched={rep1.dispatched}|coalesced={rep1.coalesced}"
         f"|batches={rep1.batches}|recompiles={rep1.recompiles}"
         f"|prewarmed={n_warmed}"),
        (f"serve_{label}_repeat", rep2.wall_s * 1e6,
         f"hit_fraction={rep2.hit_fraction:.3f}"
         f"|throughput={rep2.throughput_rps:.1f}req_s"
         f"|{'bitwise' if bitwise else 'DIVERGED'}"
         f"|{'ok' if ok else 'FAIL'}"),
    ]
    bench = {
        "mode": label, "n": len(arrivals), "rate_hz": rate,
        "apps": list(apps), "n_configs": len(cfgs), "seed": seed,
        "realtime": realtime, "max_batch": max_batch,
        "prewarm_s": prewarm_s, "prewarmed_buckets": n_warmed,
        "pass1": rep1.to_dict(), "repeat": rep2.to_dict(),
        "bitwise_repeat": bitwise, "ok": ok,
        "cache_path": cache_path, "device": str(svc.device),
        "builds": builds,
    }
    return rows, bench


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(prog="python -m repro_torch.serve_bench",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--cache", default=None, help="JSONL ResultCache path")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--no-realtime", action="store_true",
                    help="replay arrivals back-to-back (deterministic/fast)")
    ap.add_argument("--device", default=None,
                    help="engine device (default: the CUDA device; 'cpu' "
                         "runs the plain PyTorch scan)")
    args = ap.parse_args(argv)
    rows, bench = serve_study(quick=args.quick, cache_path=args.cache,
                              seed=args.seed,
                              realtime=not args.no_realtime,
                              device=args.device)
    print("name,us_per_call,derived")
    for name, us, derived in rows:
        print(f"{name},{us:.1f},{derived}")
    return 0 if bench["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
