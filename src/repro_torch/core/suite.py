"""RiVec suite timing API: end-to-end modeled runtimes and speedups (§5).

The port of ``repro/core/suite.py``.  ``speedup(app, cfg)`` is the paper's
Figures 4-10 quantity: scalar runtime / vectorized runtime on a given
vector-engine configuration.  The scalar side is the event-based pipeline
model (``core.scalar_pipeline``, host arithmetic); the vector side is
``chunks x steady-state(loop body)`` from the engine scan, which runs on
the CUDA device unless ``device="cpu"`` is passed.

The host-side derivation (``vector_runtime_from_per_chunk``) keeps the
reference's numpy scalar types, so its float32 promotion and rounding are
the reference's.
"""
from __future__ import annotations

from repro_torch import _device
from repro_torch.core import engine as eng
from repro_torch.core import scalar_pipeline as _sp
from repro_torch.core import tracegen


def effective_mvl(app_name: str, cfg: eng.VectorEngineConfig) -> int:
    """The MVL a body actually runs at: the configured MVL clamped to the
    app's largest requested VL (body and chunk count both use it)."""
    return min(cfg.mvl, tracegen.app_for(app_name).max_vl)


def scalar_runtime_ns(app_name: str,
                      cfg: eng.VectorEngineConfig | None = None) -> float:
    """Modeled scalar-version runtime (ns) on the config's scalar core."""
    return _sp.scalar_runtime_ns(app_name, cfg)


def vector_runtime_from_per_chunk(app_name: str, cfg: eng.VectorEngineConfig,
                                  body, per_chunk: float) -> float:
    """Whole-app modeled vector runtime from one steady per-chunk time:
    ``chunks x per_chunk`` plus the residual (non-amortized) scalar work.

    ``eng.SCALAR_CYCLES[0]`` is an ``np.float32``, so under numpy 2's
    promotion the sum is a float32, exactly as in the reference.
    """
    app = tracegen.app_for(app_name)
    mvl = effective_mvl(app_name, cfg)
    chunks = tracegen.chunks_for(app_name, mvl, cfg)
    counts = app.counts(mvl)
    per_chunk_scalar = sum(r for r in body.scalar_count)
    residual = max(counts.scalar_instrs - per_chunk_scalar * chunks, 0.0)
    res_scale = 1.0 / (cfg.scalar_freq_ghz * cfg.issue_width)
    return float(chunks * per_chunk
                 + residual * eng.SCALAR_CYCLES[0] * res_scale)


def vector_runtime_ns(app_name: str, cfg: eng.VectorEngineConfig,
                      device=None) -> float:
    body = tracegen.body_for(app_name, effective_mvl(app_name, cfg), cfg)
    per_chunk = eng.steady_state_time(body, cfg, device=device)
    return vector_runtime_from_per_chunk(app_name, cfg, body, per_chunk)


def speedup(app_name: str, cfg: eng.VectorEngineConfig, device=None) -> float:
    return (scalar_runtime_ns(app_name, cfg)
            / vector_runtime_ns(app_name, cfg, device=device))


def clear_caches() -> None:
    """Forget the memoized loop bodies (hand-coded, lowered and decoded)
    and scalar baselines, so the next call builds them anew as a fresh
    process would."""
    from repro_torch.core import dse, frontend, rvv, workloads_ml
    tracegen._BODY_CACHE.clear()
    dse._BODY_FPS.clear()
    dse._CFG_FPS.clear()
    workloads_ml._TRACE_CACHE.clear()
    frontend._DERIVED_CACHE.clear()
    rvv._DECODE_CACHE.clear()
    _sp._runtime_cached.cache_clear()


def _bodies(pairs):
    return [tracegen.body_for(a, effective_mvl(a, c), c) for a, c in pairs]


def scan_inputs(pairs: list[tuple[str, eng.VectorEngineConfig]],
                warmup: int = 8, measure: int = 24,
                device=None) -> eng.ScanInputs:
    """The engine scan's operands for N (app, config) pairs, packed as
    ``speedup_batch`` packs them (for timing or checking that one launch)."""
    return eng.pack_steady_state(_bodies(pairs), [c for _, c in pairs],
                                 warmup, measure, _device.resolve(device))


def speedup_batch(pairs: list[tuple[str, eng.VectorEngineConfig]],
                  device=None) -> list[float]:
    """Speedups for N (app, config) pairs: one engine scan launch for all
    of them, the scalar side memoized per (app, scalar knobs)."""
    bodies = _bodies(pairs)
    per_chunk = eng.steady_state_time_batch(bodies, [c for _, c in pairs],
                                            device=device)
    return [scalar_runtime_ns(a, c) / vector_runtime_from_per_chunk(a, c, b, pc)
            for (a, c), b, pc in zip(pairs, bodies, per_chunk)]


def speedup_util_batch(pairs: list[tuple[str, eng.VectorEngineConfig]],
                       device=None) -> list[dict]:
    """``speedup_batch`` plus the lane/VMU utilization over the steady-state
    window, read from the same scan: rows ``{"speedup", "lane_util",
    "vmu_util"}`` with speedups bitwise equal to ``speedup_batch``."""
    bodies = _bodies(pairs)
    rows = eng.steady_state_time_batch(bodies, [c for _, c in pairs],
                                       with_util=True, device=device)
    return [{
        "speedup": scalar_runtime_ns(a, c) / vector_runtime_from_per_chunk(
            a, c, b, r["steady_ns"]),
        "lane_util": r["lane_util"],
        "vmu_util": r["vmu_util"],
    } for (a, c), b, r in zip(pairs, bodies, rows)]


def sweep(app_name: str, mvls=(8, 16, 32, 64, 128, 256), lanes=(1, 2, 4, 8),
          utilization: bool = False, device=None, **overrides) -> dict:
    """The paper's 24-configuration sweep (Table 10) of one app, batched;
    ``{(mvl, lanes): speedup}`` (or utilization rows)."""
    grid = [(m, l) for m in mvls for l in lanes]
    pairs = [(app_name, eng.VectorEngineConfig(mvl=m, lanes=l, **overrides))
             for m, l in grid]
    run = speedup_util_batch if utilization else speedup_batch
    return dict(zip(grid, run(pairs, device=device)))


def sweep_all(apps=None, mvls=(8, 16, 32, 64, 128, 256), lanes=(1, 2, 4, 8),
              utilization: bool = False, device=None, **overrides) -> dict:
    """The paper's study — every app (default: all ten, as the reference's)
    x the 24-config grid — in one scan launch."""
    apps = list(apps) if apps is not None else sorted(tracegen.APPS)
    grid = [(m, l) for m in mvls for l in lanes]
    pairs = [(a, eng.VectorEngineConfig(mvl=m, lanes=l, **overrides))
             for a in apps for m, l in grid]
    run = speedup_util_batch if utilization else speedup_batch
    flat = run(pairs, device=device)
    return {a: dict(zip(grid, flat[i * len(grid):(i + 1) * len(grid)]))
            for i, a in enumerate(apps)}


def dse_explore(space, apps=None, cache=None, warmup: int = 8,
                measure: int = 24, device=None):
    """Design-space exploration over the suite: evaluate ``apps`` (default:
    all 10) on every config of ``space`` in one engine scan launch, deduped
    through ``cache`` — ``repro_torch.core.dse.explore``.  Returns a
    ``dse.DseResult``; ``.frontiers()`` gives the per-app Pareto frontier
    (runtime vs. area proxy)."""
    from repro_torch.core import dse
    return dse.explore(space, apps=apps, cache=cache, warmup=warmup,
                       measure=measure, device=device)


def dse_best_under_budget(space, budget_kb: float, apps=None, cache=None,
                          device=None) -> dict:
    """Per-app "best config under an area budget": the fastest explored
    config whose ``dse.area_proxy_kb`` fits ``budget_kb`` (``None`` when
    nothing fits)."""
    from repro_torch.core import dse
    res = dse.explore(space, apps=apps, cache=cache, device=device)
    return {a: dse.best_under_budget(recs, budget_kb)
            for a, recs in res.by_app().items()}
