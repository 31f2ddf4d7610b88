"""Surrogate-guided design search: million-point spaces, exact-only answers.

The port of ``repro/core/search.py``.  ``repro_torch.core.dse`` explores
exhaustively — every (app, config) cell hits the engine (or its cache).
That tops out around ``SPACE_FULL`` (1536 configs).  This module searches
spaces orders of magnitude larger (``SPACE_HUGE``, 1,244,160 configs;
anything a mixed-radix ``DesignSpace`` can address) by splitting the work:

1. **Score** every candidate with the learned surrogate
   (``repro_torch.core.surrogate.SpaceScorer``) — microseconds per point,
   fixed-shape batches on the device.  Spaces up to ``exhaustive_limit``
   are scored wholesale; larger ones run a deterministic evolutionary
   loop (random proposals + one-knob mutations of the current elite,
   per-app near-frontier archives).
2. **Prune** to the predicted near-Pareto band (:func:`_survivors`):
   candidates whose predicted runtime is within ``1+eps`` of the best
   prediction at their area or below, capped at ``max_resim_per_app``.
3. **Re-simulate the survivors exactly** through ``dse.explore`` and the
   shared ``ResultCache`` — the SAME dispatch/keying path the exhaustive
   sweeps use — and take the Pareto frontier of those *exact* records.

The exactness guarantee is structural: frontiers are built from
``dse.DseRecord``s produced by ``dse.explore``, never from predictions — a
surrogate number cannot appear in a reported result, only fail to nominate a
candidate (which costs recall, measured by :func:`frontier_recall`, never
correctness).  Determinism: same (space, apps, trained model, seed) ->
bitwise-identical frontiers (``frontier_fingerprint``); the ``--smoke`` CLI
is the CI gate for both properties:

    python -m repro_torch.core.search --smoke [--device cpu]

The scorer and the exact re-simulation run on the CUDA device unless
``device="cpu"`` is given (the model's device must be the same).
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass

import numpy as np

from repro_torch.core import dse
from repro_torch.core import surrogate as surro


# --------------------------------------------------------------------------
# results
# --------------------------------------------------------------------------

@dataclass
class SearchResult:
    """A surrogate-guided search: exact records + frontiers + accounting.

    ``records``/``frontiers`` hold ``dse.DseRecord``s from the exact engine
    path only.  ``stats`` carries the search economics: candidates scored,
    survivors re-simulated, cache behavior of the re-simulation.
    """
    space: str
    apps: tuple
    records: dict          # app -> [DseRecord], exact, resim order
    frontiers: dict        # app -> [DseRecord], Pareto of `records[app]`
    stats: dict


def frontier_fingerprint(res: SearchResult) -> str:
    """Hash of every frontier's exact float values — same recipe as
    ``dse._frontier_fingerprint``, the bitwise-repeatability contract."""
    h = hashlib.sha1()
    for app in res.apps:
        for r in res.frontiers[app]:
            h.update(f"{app}|{r.label}|{r.runtime_ns!r}|{r.area_kb!r}"
                     .encode())
    return h.hexdigest()[:16]


def frontier_recall(found, truth) -> float:
    """Fraction of ``truth`` frontier points weakly dominated by some
    ``found`` record (<= in both runtime and area).  The acceptance metric:
    1.0 means the search recovered (or beat) every exhaustive-truth point.

    >>> from types import SimpleNamespace as R
    >>> truth = [R(runtime_ns=10.0, area_kb=5.0), R(runtime_ns=20.0, area_kb=1.0)]
    >>> frontier_recall([R(runtime_ns=10.0, area_kb=5.0)], truth)
    0.5
    >>> frontier_recall([R(runtime_ns=9.0, area_kb=1.0)], truth)
    1.0
    """
    if not truth:
        return 1.0
    if not found:
        return 0.0
    fr = np.asarray([f.runtime_ns for f in found])
    fa = np.asarray([f.area_kb for f in found])
    hit = sum(1 for t in truth
              if bool(np.any((fr <= t.runtime_ns) & (fa <= t.area_kb))))
    return hit / len(truth)


# --------------------------------------------------------------------------
# predicted near-frontier selection
# --------------------------------------------------------------------------

def _survivors(idx, pred, area, eps: float, cap: int,
               depth: int = 3) -> np.ndarray:
    """Indices (ascending) of candidates on or near the *predicted* Pareto
    frontier: sort by (area, pred), take the running best prediction at or
    below each area, and keep points within ``1+eps`` of it.

    When more than ``cap`` qualify, the band is split into ``cap // depth``
    contiguous strata along the area-sorted order and each stratum keeps its
    ``depth`` closest-to-frontier candidates (smallest pred/best ratio, ties
    by flat index).  Two deliberate properties:

    * *Coverage* — stratifying, rather than globally keeping the smallest
      ratios, spreads survivors across the whole area range; a global
      top-``cap`` collapses onto whichever region is densest and leaves the
      rest of the frontier unexplored.
    * *Redundancy* — ``depth`` per-stratum picks, not one: the surrogate's
      few-percent noise regularly puts a slightly-slower config a hair below
      the true best, and the second/third nominee is what lets the exact
      re-simulation recover the real frontier point.

    Pure numpy, deterministic.

    >>> idx = np.array([0, 1, 2, 3])
    >>> pred = np.array([10.0, 11.0, 30.0, 5.0])
    >>> area = np.array([1.0, 1.0, 2.0, 3.0])
    >>> _survivors(idx, pred, area, eps=0.15, cap=10).tolist()
    [0, 1, 3]
    >>> _survivors(idx, pred, area, eps=0.15, cap=2).tolist()  # ratio ties
    [0, 3]
    """
    idx = np.asarray(idx)
    pred = np.asarray(pred, np.float64)
    area = np.asarray(area, np.float64)
    order = np.lexsort((idx, pred, area))        # area asc, then pred, then id
    best = np.minimum.accumulate(pred[order])    # best pred at <= this area
    ratio = pred[order] / best
    band = np.nonzero(ratio <= 1.0 + eps)[0]
    if len(band) > cap:
        take = min(depth, cap)
        picks = []
        for stratum in np.array_split(band, max(1, cap // take)):
            if len(stratum):
                k = np.lexsort((idx[order][stratum], ratio[stratum]))
                picks.extend(stratum[k[:take]])
        band = np.sort(np.asarray(picks))
    return np.sort(idx[order][band])


# --------------------------------------------------------------------------
# candidate generation (the > exhaustive_limit path)
# --------------------------------------------------------------------------

def _decode(idx, radices) -> np.ndarray:
    """Flat indices -> axis digits, mixed radix, last axis fastest (the
    ``DesignSpace.config_at`` rule)."""
    digits = np.empty((len(idx), len(radices)), np.int64)
    rem = np.asarray(idx, np.int64).copy()
    for a in range(len(radices) - 1, -1, -1):
        rem, digits[:, a] = np.divmod(rem, radices[a])
    return digits


def _encode(digits, radices) -> np.ndarray:
    out = np.zeros(len(digits), np.int64)
    for a in range(len(radices)):
        out = out * radices[a] + digits[:, a]
    return out


def _mutate(rng, elite_idx, radices, n: int) -> np.ndarray:
    """``n`` one-knob mutations of elites: pick an elite, pick an axis,
    replace that digit with a uniform choice."""
    if len(elite_idx) == 0 or n <= 0:
        return np.empty(0, np.int64)
    base = elite_idx[rng.randint(len(elite_idx), size=n)]
    digits = _decode(base, radices)
    axis = rng.randint(len(radices), size=n)
    new = np.array([rng.randint(radices[a]) for a in axis], np.int64)
    digits[np.arange(n), axis] = new
    return _encode(digits, radices)


def _neighbors(idx, radices) -> np.ndarray:
    """The complete one-knob neighborhood of ``idx``: every config reachable
    by changing exactly one axis digit.  Deterministic (sorted, unique).

    >>> _neighbors(np.array([0]), [2, 3]).tolist()   # (0,0) -> one-knob flips
    [1, 2, 3]
    """
    idx = np.asarray(idx, np.int64)
    if len(idx) == 0:
        return np.empty(0, np.int64)
    digits = _decode(idx, radices)
    out = []
    for a, r in enumerate(radices):
        for v in range(r):
            mask = digits[:, a] != v
            if mask.any():
                d = digits[mask].copy()
                d[:, a] = v
                out.append(_encode(d, radices))
    return np.unique(np.concatenate(out)) if out else np.empty(0, np.int64)


# --------------------------------------------------------------------------
# the search
# --------------------------------------------------------------------------

def search(space, apps, model, cache: dse.ResultCache | None = None,
           seed: int = 0, eps: float = 0.2, max_resim_per_app: int = 480,
           refine_rounds: int = 2, exhaustive_limit: int = 1 << 21,
           rounds: int = 8, pop: int = 1 << 16, warmup: int = 8,
           measure: int = 24, device=None) -> SearchResult:
    """Surrogate-guided exploration of ``space`` for ``apps``.

    Spaces up to ``exhaustive_limit`` points are surrogate-scored wholesale
    (``SPACE_HUGE``'s 1.24M points is ten fixed-shape batches per app);
    larger spaces run ``rounds`` of a deterministic evolutionary loop
    (``pop`` fresh uniform proposals + one-knob mutations of the per-app
    near-frontier archive each round).  Either way, at most
    ``max_resim_per_app`` predicted near-Pareto survivors per app are then
    evaluated EXACTLY via ``dse.explore`` through ``cache``, followed by
    ``refine_rounds`` of exact one-knob local search around the running
    exact frontier (the surrogate nominates the region, refinement walks
    the last knobs); the reported frontier is the Pareto set of those
    exact records.

    Deterministic in (space, apps, model parameters, seed): repeat calls
    produce bitwise-identical frontiers, simulated or cached.  ``device``
    (default: the CUDA device) runs the exact re-simulation; the model
    scores on its own device, which must be the same.
    """
    import time as _time

    from repro_torch import _device
    from repro_torch.core import telemetry
    dev = _device.resolve(device)
    if model.device.type != dev.type:
        raise ValueError(f"the model's parameters are on {model.device}, "
                         f"the search runs on {dev}")
    apps = tuple(apps)
    cache = cache if cache is not None else dse.ResultCache()
    total = space.size()
    radices = [len(c) for _, c in space.axes]
    scorers = {app: surro.SpaceScorer(model, space, app) for app in apps}
    _t0 = _time.perf_counter()

    per_app_idx: dict[str, np.ndarray] = {}
    n_scored = 0
    if total <= exhaustive_limit:
        all_idx = np.arange(total, dtype=np.int64)
        for app in apps:
            pred, area = scorers[app].score(all_idx)
            n_scored += total
            per_app_idx[app] = _survivors(all_idx, pred, area, eps,
                                          max_resim_per_app)
        mode = "exhaustive-score"
    else:
        rng = np.random.RandomState(seed)
        seen = np.empty(0, np.int64)
        # archives: per-app (idx, pred, area) of the near-frontier so far
        arch = {app: (np.empty(0, np.int64), np.empty(0), np.empty(0))
                for app in apps}
        arch_cap = max(4 * max_resim_per_app, 64)
        for _ in range(rounds):
            fresh = rng.randint(total, size=pop).astype(np.int64)
            muts = [_mutate(rng, arch[app][0], radices, pop // 4)
                    for app in apps]
            cand = np.unique(np.concatenate([fresh, *muts]))
            cand = np.setdiff1d(cand, seen, assume_unique=True)
            if len(cand) == 0:
                continue
            seen = np.union1d(seen, cand)
            for app in apps:
                pred, area = scorers[app].score(cand)
                n_scored += len(cand)
                ai, ap, aa = arch[app]
                ci = np.concatenate([ai, cand])
                cp = np.concatenate([ap, pred.astype(np.float64)])
                ca = np.concatenate([aa, area.astype(np.float64)])
                keep = _survivors(ci, cp, ca, eps, arch_cap)
                # re-gather by flat index (ci unique: archive ∩ cand = ∅)
                lut = {int(i): k for k, i in enumerate(ci)}
                sel = np.asarray([lut[int(i)] for i in keep], np.int64)
                arch[app] = (ci[sel], cp[sel], ca[sel])
        for app in apps:
            ai, ap, aa = arch[app]
            per_app_idx[app] = _survivors(ai, ap, aa, eps, max_resim_per_app)
        mode = "evolutionary"

    # Exact re-simulation of the survivors — the only numbers we report —
    # followed by `refine_rounds` of exact local search: the complete
    # one-knob neighborhood of the current exact frontier is re-simulated
    # and the frontier recomputed.  The surrogate nominates the region;
    # refinement walks the last knob or two to the true local optimum,
    # closing the few-percent gaps that surrogate noise (winner's curse:
    # the predicted-best of thousands of near-ties is the most
    # *under*-predicted, not the fastest) leaves behind.
    _t_score = _time.perf_counter()
    records: dict[str, list] = {}
    frontiers: dict[str, list] = {}
    resim_stats: dict[str, dict] = {}
    _t_resim = _t_refine = 0.0
    for app in apps:
        _ta = _time.perf_counter()
        seen_idx = np.unique(per_app_idx[app].astype(np.int64))
        cfgs = [space.config_at(int(i)) for i in seen_idx]
        idx_of = {c: int(i) for c, i in zip(cfgs, seen_idx)}
        res = dse.explore(cfgs, apps=(app,), cache=cache,
                          warmup=warmup, measure=measure, device=dev)
        recs = list(res.records)
        simulated = res.stats["simulated"]
        frontier = dse.pareto_frontier(recs)
        refined = 0
        _tb = _time.perf_counter()
        _t_resim += _tb - _ta
        for _ in range(refine_rounds):
            f_idx = np.asarray(sorted(idx_of[r.cfg] for r in frontier),
                               np.int64)
            nbrs = np.setdiff1d(_neighbors(f_idx, radices), seen_idx,
                                assume_unique=True)
            if len(nbrs) == 0:
                break
            ncfgs = [space.config_at(int(i)) for i in nbrs]
            idx_of.update({c: int(i) for c, i in zip(ncfgs, nbrs)})
            r2 = dse.explore(ncfgs, apps=(app,), cache=cache,
                             warmup=warmup, measure=measure, device=dev)
            recs.extend(r2.records)
            simulated += r2.stats["simulated"]
            refined += len(nbrs)
            seen_idx = np.union1d(seen_idx, nbrs)
            new_frontier = dse.pareto_frontier(recs)
            converged = ([(r.label, r.runtime_ns) for r in new_frontier]
                         == [(r.label, r.runtime_ns) for r in frontier])
            frontier = new_frontier
            if converged:
                break
        records[app] = recs
        frontiers[app] = frontier
        resim_stats[app] = {"resim": int(len(seen_idx)), "refined": refined,
                            "simulated": simulated}
        _t_refine += _time.perf_counter() - _tb
    phases = [
        telemetry.snapshot_row("search.phase", phase="score",
                               wall_s=_t_score - _t0, mode=mode,
                               n_scored=n_scored),
        telemetry.snapshot_row("search.phase", phase="resim",
                               wall_s=_t_resim,
                               simulated=sum(r["simulated"]
                                             for r in resim_stats.values())),
        telemetry.snapshot_row("search.phase", phase="refine",
                               wall_s=_t_refine,
                               refined=sum(r["refined"]
                                           for r in resim_stats.values())),
    ]
    stats = {
        "mode": mode,
        "space_size": total,
        "n_scored": n_scored,
        "eps": eps,
        "max_resim_per_app": max_resim_per_app,
        "refine_rounds": refine_rounds,
        "resim": resim_stats,
        "phases": phases,
    }
    return SearchResult(space=space.name, apps=apps, records=records,
                        frontiers=frontiers, stats=stats)


# --------------------------------------------------------------------------
# CLI / CI smoke gate
# --------------------------------------------------------------------------

def _verify_exact(res: SearchResult, cache: dse.ResultCache,
                  warmup: int = 8, measure: int = 24) -> int:
    """Assert every frontier record is backed by an exact engine result in
    ``cache`` and that its runtime re-derives bitwise from the cached
    steady-state time.  Returns the number of points checked."""
    from repro_torch.core import suite
    checked = 0
    for app in res.apps:
        for r in res.frontiers[app]:
            body, key = dse.cell_key(app, r.cfg, warmup, measure)
            steady = cache._mem.get(key)
            if steady is None:
                raise AssertionError(f"frontier point not in cache: {key}")
            if steady != r.steady_ns:
                raise AssertionError((app, r.label, "steady_ns"))
            rt = suite.vector_runtime_from_per_chunk(app, r.cfg, body, steady)
            if rt != r.runtime_ns:
                raise AssertionError((app, r.label, "runtime_ns"))
            checked += 1
    return checked


def main(argv=None) -> int:
    import argparse
    import time
    from repro_torch.configs import vector_engine as vcfg
    ap = argparse.ArgumentParser(prog="python -m repro_torch.core.search",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--space", default="10k", choices=("10k", "huge"))
    ap.add_argument("--train-space", default="smoke",
                    choices=("smoke", "quick", "full"))
    ap.add_argument("--apps", default="blackscholes,canneal")
    ap.add_argument("--cache", default=None, help="JSONL cache path")
    ap.add_argument("--steps", type=int, default=800)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--smoke", action="store_true",
                    help="CI gate: train on a 64-point explore, search the "
                         "18k-point space, assert every frontier point is "
                         "exact-verified and repeat runs (both scoring "
                         "modes) are bitwise-identical")
    ap.add_argument("--device", default=None,
                    help="engine and surrogate device (default: the CUDA "
                         "device; 'cpu' runs the plain PyTorch versions)")
    args = ap.parse_args(argv)
    dev = args.device
    apps = tuple(args.apps.split(","))
    train_space = {"smoke": vcfg.SPACE_SMOKE, "quick": vcfg.SPACE_QUICK,
                   "full": vcfg.SPACE_FULL}[args.train_space]
    space = {"10k": vcfg.SPACE_10K, "huge": vcfg.SPACE_HUGE}[args.space]

    cache = dse.ResultCache(args.cache)
    t0 = time.perf_counter()
    dse.explore(train_space, apps, cache=cache, device=dev)
    rows = cache.export_training_rows(apps, train_space)
    t_label = time.perf_counter() - t0
    t0 = time.perf_counter()
    model = surro.fit(rows, steps=args.steps, seed=args.seed, device=dev)
    t_fit = time.perf_counter() - t0
    print(f"train: {len(rows)} rows from {train_space.name} in {t_label:.2f}s"
          f", fit {t_fit:.2f}s (final_loss={model.meta['final_loss']:.2e})")

    t0 = time.perf_counter()
    res = search(space, apps, model, cache=cache, seed=args.seed,
                 device=dev)
    t_search = time.perf_counter() - t0
    n = _verify_exact(res, cache)
    print(f"search: {space.name} ({res.stats['space_size']:,} configs) "
          f"mode={res.stats['mode']} scored={res.stats['n_scored']:,} "
          f"in {t_search:.2f}s; {n} frontier points exact-verified")
    for app in res.apps:
        rs = res.stats["resim"][app]
        print(f"  {app:16s} frontier={len(res.frontiers[app]):3d} pts  "
              f"resim={rs['resim']} (simulated={rs['simulated']})")
    card = surro.scorecard(model, rows)
    print(f"  fit-set scorecard: p50={card['rel_err_p50']:.1%} "
          f"p90={card['rel_err_p90']:.1%} max={card['rel_err_max']:.1%} "
          f"spearman={card['spearman_all']:.4f}")
    if not args.smoke:
        return 0

    fp1 = frontier_fingerprint(res)
    res2 = search(space, apps, model, cache=cache, seed=args.seed,
                  device=dev)
    fp2 = frontier_fingerprint(res2)
    _verify_exact(res2, cache)
    # the evolutionary path must hold the same determinism contract
    evo = [search(space, apps, model, cache=cache, seed=args.seed,
                  exhaustive_limit=0, rounds=3, pop=4096, device=dev)
           for _ in range(2)]
    for e in evo:
        _verify_exact(e, cache)
    fpe1, fpe2 = (frontier_fingerprint(e) for e in evo)
    ok = fp1 == fp2 and fpe1 == fpe2
    print(f"repeat: exhaustive {'bitwise-identical' if fp1 == fp2 else 'DIVERGED'}"
          f" ({fp1}); evolutionary "
          f"{'bitwise-identical' if fpe1 == fpe2 else 'DIVERGED'} ({fpe1}) "
          f"-> {'ok' if ok else 'FAIL'}")
    return 0 if ok else 1


if __name__ == "__main__":
    # delegate to the canonical module object: the spaces in
    # repro_torch.configs carry repro_torch.core.dse.DesignSpace instances
    from repro_torch.core import search as _canonical
    raise SystemExit(_canonical.main())
