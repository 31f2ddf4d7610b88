"""Design-space exploration: many-config Pareto sweeps over the vector engine.

The port of ``repro/core/dse.py``.  The paper's purpose is letting a
designer trade off MVL x lanes x memory hierarchy across usage scenarios
(§1, §5); this module turns the batched engine into that tool:

* :class:`DesignSpace` — a declarative space over every live
  ``VectorEngineConfig`` knob (choices per field), enumerable to the full
  cartesian product or deterministically sampled.
* :func:`explore` — evaluates ``apps x configs`` through
  ``engine.steady_state_time_batch``: every cache miss of a sweep is one
  lane of ONE engine scan launch (the reference shards the config axis
  over local devices instead).  Every dispatch is deduped through a
  persistent on-disk :class:`ResultCache` keyed by ``(model fingerprint,
  trace fingerprint, config fingerprint, warmup/measure)`` — so a repeat
  sweep is pure cache lookups and two configs that induce the same
  clamped body + timing parameters are simulated once.  The keys are the
  reference's character for character, so each package reads the other's
  cache files.
* :func:`pareto_frontier` / :func:`best_under_budget` — reductions over the
  records: per-app steady-state-runtime vs. area-proxy frontiers and
  "fastest config under an area budget" reports.

The area proxy (:func:`area_proxy_kb`) is a first-order silicon-cost model
in KB-of-SRAM equivalents: the VRF dominates a vector engine's area
(``phys_regs x mvl x 8B``, §3.2.2), each lane adds a datapath slice, and the
caches/queues contribute their capacity (the LLC discounted — it is shared
with the scalar core).  It is a *ranking* proxy for frontier shape.

Determinism contract: same space + same apps -> byte-identical records and
frontiers, whether results come from simulation or from the cache (values
round-trip through JSON at full ``repr`` precision).

    python -m repro_torch.core.dse --space smoke --smoke [--device cpu]

runs the double-run gate (the second pass through a fresh cache object must
be all hits with a bitwise-identical frontier).  The engine runs on the
CUDA device unless ``device="cpu"`` is given.
"""
from __future__ import annotations

import hashlib
import itertools
import json
import os
import time
import warnings
from dataclasses import dataclass, fields

import numpy as np
import torch

try:
    import fcntl
except ImportError:          # non-POSIX: advisory locking degrades to none
    fcntl = None

from repro_torch import _device
from repro_torch.core import engine as eng
from repro_torch.core import isa, tracegen

_CFG_FIELDS = {f.name: f for f in fields(eng.VectorEngineConfig)}


# --------------------------------------------------------------------------
# the declarative space
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class DesignSpace:
    """A declarative config space: ordered ``(field, choices)`` axes over
    ``VectorEngineConfig`` fields; every unlisted knob keeps its Table-10
    default.  Axis order fixes enumeration order (last axis fastest), which
    fixes record order, which makes whole sweeps reproducible byte-for-byte.

    >>> sp = DesignSpace.of("demo", mvl=(8, 64), lanes=(1, 4), mshrs=(1, 16))
    >>> sp.size()
    8
    >>> [ (c.mvl, c.lanes, c.mshrs) for c in sp.configs()[:3] ]
    [(8, 1, 1), (8, 1, 16), (8, 4, 1)]
    """
    name: str
    axes: tuple  # ((field_name, (choice, ...)), ...)

    def __post_init__(self):
        for name, choices in self.axes:
            if name not in _CFG_FIELDS:
                raise ValueError(f"unknown VectorEngineConfig field {name!r}")
            if not choices:
                raise ValueError(f"axis {name!r} has no choices")

    @staticmethod
    def of(name: str, **axes) -> "DesignSpace":
        return DesignSpace(name, tuple((k, tuple(v))
                                       for k, v in axes.items()))

    def size(self) -> int:
        n = 1
        for _, choices in self.axes:
            n *= len(choices)
        return n

    def config_at(self, index: int) -> eng.VectorEngineConfig:
        """Decode a flat index (mixed radix, last axis fastest) to a config."""
        if not 0 <= index < self.size():
            raise IndexError(index)
        kv = {}
        for name, choices in reversed(self.axes):
            index, r = divmod(index, len(choices))
            kv[name] = choices[r]
        return eng.VectorEngineConfig(**kv)

    def configs(self) -> list:
        """The full cartesian product, enumeration order."""
        names = [n for n, _ in self.axes]
        return [eng.VectorEngineConfig(**dict(zip(names, combo)))
                for combo in itertools.product(
                    *(choices for _, choices in self.axes))]

    def sample(self, n: int, seed: int = 0) -> list:
        """``n`` distinct configs, deterministic in ``seed`` (sorted flat
        indices from ``np.random.RandomState(seed)``, as the reference draws
        them, so a sample equals the reference's for the same seed).

        ``n`` must not exceed ``size()``; ``n == size()`` returns the full
        enumeration.

        >>> sp = DesignSpace.of("demo", mvl=(8, 64), lanes=(1, 4))
        >>> sp.sample(4) == sp.configs()
        True
        >>> sp.sample(5)
        Traceback (most recent call last):
            ...
        ValueError: sample(5) from 'demo' with only 4 configs
        """
        total = self.size()
        if n > total:
            raise ValueError(
                f"sample({n}) from {self.name!r} with only {total} configs")
        if n == total:
            return self.configs()
        idx = np.sort(np.random.RandomState(seed).choice(
            total, size=n, replace=False))
        return [self.config_at(int(i)) for i in idx]


# --------------------------------------------------------------------------
# the area/cost proxy
# --------------------------------------------------------------------------

# Per-lane datapath slice (ALU + FPU pipe + lane slice of the interconnect)
# in KB-of-SRAM equivalents; queue/ROB/MSHR entries are a fraction of a KB.
LANE_AREA_KB = 4.0
ENTRY_AREA_KB = 1.0 / 32.0
L2_SHARED_FRACTION = 1.0 / 8.0   # the LLC is shared with the scalar core


def area_proxy_kb(cfg: eng.VectorEngineConfig) -> float:
    """First-order area/cost proxy (KB-of-SRAM equivalents): VRF
    ``phys_regs x mvl x 8 B`` (§3.2.2), a datapath slice a lane, the
    private L1, the LLC at its shared fraction, and queue/ROB/MSHR entries.

    >>> small = area_proxy_kb(eng.VectorEngineConfig(mvl=8, lanes=1))
    >>> big = area_proxy_kb(eng.VectorEngineConfig(mvl=256, lanes=8))
    >>> small < big
    True
    """
    vrf_kb = cfg.phys_regs * cfg.mvl * 8.0 / 1024.0
    return float(
        vrf_kb
        + LANE_AREA_KB * cfg.lanes
        + cfg.l1_kb
        + L2_SHARED_FRACTION * cfg.l2_kb
        + ENTRY_AREA_KB * (cfg.rob_entries + 2 * cfg.queue_entries
                           + cfg.mshrs))


# --------------------------------------------------------------------------
# the persistent result cache
# --------------------------------------------------------------------------

class ResultCache:
    """Persistent on-disk memo of steady-state times, JSONL append-only.

    Key: ``{model_fp}|{trace_fp}|{config_fp}|w{warmup}m{measure}`` — the
    calibration hash (``engine.model_fingerprint``), the trace content hash
    (``isa.trace_fingerprint``) and the timing-parameter hash
    (``engine.config_fingerprint``), each equal to the reference's for the
    same input.  A hit can never cross workloads, calibrations or
    timing-relevant knobs, while configs aliasing to the same body + params
    (e.g. MVL above an app's ``max_vl`` cap) dedup to one lane.

    Values are floats serialized by ``json`` at full precision, so a cached
    sweep reproduces the simulated one byte-for-byte.  ``path=None`` gives a
    process-local (in-memory) cache.

    Robustness:

    * loading tolerates malformed lines — a process killed mid-append leaves
      at most one truncated trailing record, which is skipped with a warning
      (``corrupt_lines`` counts them);
    * ``flush`` writes all pending records as ONE ``O_APPEND`` write under an
      advisory ``flock``, so concurrent writers never interleave partial
      lines.
    """

    def __init__(self, path: str | None = None):
        self.path = path
        self._mem: dict[str, float] = {}
        self._pending: list[tuple[str, float]] = []
        self.hits = 0
        self.misses = 0
        self.corrupt_lines = 0
        if path and os.path.exists(path):
            with open(path) as f:
                for lineno, line in enumerate(f, 1):
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        rec = json.loads(line)
                        self._mem[rec["k"]] = float(rec["v"])
                    except (json.JSONDecodeError, KeyError, TypeError,
                            ValueError):
                        self.corrupt_lines += 1
                        warnings.warn(
                            f"ResultCache: skipping malformed line {lineno} "
                            f"of {path} (truncated write?)", stacklevel=2)

    def __len__(self) -> int:
        return len(self._mem)

    @staticmethod
    def key(body: isa.Trace, cfg: eng.VectorEngineConfig,
            warmup: int, measure: int) -> str:
        return (f"{eng.model_fingerprint()}|{isa.trace_fingerprint(body)}|"
                f"{eng.config_fingerprint(cfg)}|w{warmup}m{measure}")

    def get(self, key: str):
        v = self._mem.get(key)
        if v is None:
            self.misses += 1
        else:
            self.hits += 1
        return v

    def put(self, key: str, value: float) -> None:
        if key not in self._mem:
            self._mem[key] = float(value)
            self._pending.append((key, float(value)))

    def flush(self) -> None:
        """Append new entries to disk (no-op for in-memory caches): one
        payload, one ``write`` on an ``O_APPEND`` descriptor under an
        exclusive ``flock``, after terminating a crashed writer's
        unterminated trailing line."""
        if self.path and self._pending:
            d = os.path.dirname(self.path)
            if d:
                os.makedirs(d, exist_ok=True)
            payload = "".join(json.dumps({"k": k, "v": v}) + "\n"
                              for k, v in self._pending).encode()
            fd = os.open(self.path,
                         os.O_RDWR | os.O_CREAT | os.O_APPEND, 0o644)
            try:
                if fcntl is not None:
                    fcntl.flock(fd, fcntl.LOCK_EX)
                size = os.fstat(fd).st_size
                if size and os.pread(fd, 1, size - 1) != b"\n":
                    payload = b"\n" + payload
                os.write(fd, payload)
            finally:
                if fcntl is not None:
                    fcntl.flock(fd, fcntl.LOCK_UN)
                os.close(fd)
        self._pending.clear()

    @property
    def hit_rate(self) -> float:
        n = self.hits + self.misses
        return self.hits / n if n else 0.0

    def records(self):
        """Iterate the cached ``(key, steady_ns)`` pairs, insertion order
        (disk order first, then in-run puts); a pure read that does not
        count toward hit/miss statistics."""
        yield from self._mem.items()

    def export_training_rows(self, apps, configs, warmup: int = 8,
                             measure: int = 24) -> list:
        """Join cached steady-state times back to explicit (app, config)
        cells without simulating anything: every cell's key is recomputed
        (``cell_key``: body and fingerprints, no engine launch) and looked
        up; cells absent from the cache are skipped.  One dict per labeled
        cell::

            {"app", "label", "cfg", "key", "steady_ns",   # the cached value
             "runtime_ns", "speedup", "area_kb"}          # derived, exact

        with the derivation :func:`explore` uses, so ``runtime_ns`` equals
        the ``DseRecord``'s bit for bit."""
        from repro_torch.core import suite
        cfgs = (configs.configs() if isinstance(configs, DesignSpace)
                else list(configs))
        model_fp = eng.model_fingerprint()
        rows = []
        for app in apps:
            for cfg in cfgs:
                body, key = cell_key(app, cfg, warmup, measure,
                                     model_fp=model_fp)
                v = self._mem.get(key)   # pure read: no hit/miss accounting
                if v is None:
                    continue
                runtime = suite.vector_runtime_from_per_chunk(app, cfg, body,
                                                              v)
                rows.append({
                    "app": app, "label": cfg.label(), "cfg": cfg, "key": key,
                    "steady_ns": v, "runtime_ns": runtime,
                    "speedup": suite.scalar_runtime_ns(app, cfg) / runtime,
                    "area_kb": area_proxy_kb(cfg),
                })
        return rows


# --------------------------------------------------------------------------
# cell keying — the contract shared by explore() and the serve layer
# --------------------------------------------------------------------------

# Every body consumes cfg only through cfg.mvl (the clamp), so bodies and
# their fingerprints memoize on (app, eff_mvl, cfg.mvl); config
# fingerprints memoize on the frozen config itself.
_BODY_FPS: dict[tuple, tuple] = {}
_CFG_FPS: dict = {}


def cell_body(app: str, cfg: eng.VectorEngineConfig) -> tuple:
    """Memoized ``(body, trace_fingerprint)`` for one (app, config) cell."""
    from repro_torch.core import suite
    eff = suite.effective_mvl(app, cfg)
    bkey = (app, eff, cfg.mvl)
    ent = _BODY_FPS.get(bkey)
    if ent is None:
        body = tracegen.body_for(app, eff, cfg)
        ent = _BODY_FPS[bkey] = (body, isa.trace_fingerprint(body))
    return ent


def config_fp(cfg: eng.VectorEngineConfig) -> str:
    """Memoized ``engine.config_fingerprint`` (cfg is frozen/hashable)."""
    fp = _CFG_FPS.get(cfg)
    if fp is None:
        fp = _CFG_FPS[cfg] = eng.config_fingerprint(cfg)
    return fp


def cell_key(app: str, cfg: eng.VectorEngineConfig, warmup: int = 8,
             measure: int = 24, model_fp: str | None = None) -> tuple:
    """``(body, cache key)`` for one (app, config) cell — the keying
    contract of :func:`explore`, equal to ``ResultCache.key`` and to the
    reference's key for the same cell.  ``model_fp`` may be passed to
    amortize ``model_fingerprint()`` over a loop."""
    body, trace_fp = cell_body(app, cfg)
    mfp = model_fp if model_fp is not None else eng.model_fingerprint()
    return body, f"{mfp}|{trace_fp}|{config_fp(cfg)}|w{warmup}m{measure}"


# --------------------------------------------------------------------------
# exploration
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class DseRecord:
    """One evaluated (app, config) cell."""
    app: str
    label: str
    cfg: eng.VectorEngineConfig
    steady_ns: float      # steady-state time of one loop body
    runtime_ns: float     # modeled whole-app vector runtime
    speedup: float        # vs. the scalar-pipeline model on cfg's scalar core
    area_kb: float        # area_proxy_kb(cfg)


@dataclass
class DseResult:
    """An exploration: the flat records plus dispatch/cache accounting."""
    space: str
    apps: tuple
    n_configs: int
    records: list         # [DseRecord], apps-major, enumeration order
    stats: dict           # lookups / simulated / hit_rate / ...

    def by_app(self) -> dict:
        out: dict[str, list] = {a: [] for a in self.apps}
        for r in self.records:
            out[r.app].append(r)
        return out

    def frontiers(self) -> dict:
        """Per-app Pareto frontier (minimize runtime_ns and area_kb)."""
        return {a: pareto_frontier(recs) for a, recs in self.by_app().items()}


def explore(space, apps=None, cache: ResultCache | None = None,
            warmup: int = 8, measure: int = 24, device=None) -> DseResult:
    """Evaluate every app on every config of ``space`` (a
    :class:`DesignSpace` or an explicit config list); the cache misses
    (deduped within the run) go to the engine as one scan launch.

    The steady-state loop-body time is cached per ``(body, timing
    params)``; whole-app runtime, speedup and area are recomputed per
    record, so cached and simulated sweeps agree bitwise.  ``stats`` holds
    the lookups, hits, in-run dedup, the lanes simulated, the hit rate,
    the device count and one ``telemetry.snapshot_row`` per phase (key,
    dispatch, derive) with its wall time.
    """
    from repro_torch.core import suite, telemetry
    dev = _device.resolve(device)
    cfgs = space.configs() if isinstance(space, DesignSpace) else list(space)
    name = space.name if isinstance(space, DesignSpace) else f"list{len(cfgs)}"
    apps = tuple(sorted(tracegen.APPS)) if apps is None else tuple(apps)
    cache = cache if cache is not None else ResultCache()

    h0, m0 = cache.hits, cache.misses
    model_fp = eng.model_fingerprint()
    t_key0 = time.perf_counter()
    cells = []                       # (app, cfg, body, key)
    need: dict[str, tuple] = {}      # first (body, cfg) per missing key
    for app in apps:
        for cfg in cfgs:
            body, key = cell_key(app, cfg, warmup, measure,
                                 model_fp=model_fp)
            cells.append((app, cfg, body, key))
            if cache.get(key) is None and key not in need:
                need[key] = (body, cfg)
    t_key1 = t_disp1 = time.perf_counter()
    if need:
        times = eng.steady_state_time_batch(
            [b for b, _ in need.values()], [c for _, c in need.values()],
            warmup=warmup, measure=measure, device=dev)
        for key, t in zip(need, times):
            cache.put(key, t)
        cache.flush()
        t_disp1 = time.perf_counter()

    records = []
    for app, cfg, body, key in cells:
        per_chunk = cache._mem[key]
        runtime = suite.vector_runtime_from_per_chunk(app, cfg, body,
                                                      per_chunk)
        records.append(DseRecord(
            app=app, label=cfg.label(), cfg=cfg, steady_ns=per_chunk,
            runtime_ns=runtime,
            speedup=suite.scalar_runtime_ns(app, cfg) / runtime,
            area_kb=area_proxy_kb(cfg)))
    t_derive1 = time.perf_counter()
    lookups = (cache.hits - h0) + (cache.misses - m0)
    phases = [
        telemetry.snapshot_row("dse.phase", phase="key", wall_s=t_key1 - t_key0,
                               cells=len(cells), misses=len(need)),
        telemetry.snapshot_row("dse.phase", phase="dispatch",
                               wall_s=t_disp1 - t_key1, simulated=len(need)),
        telemetry.snapshot_row("dse.phase", phase="derive",
                               wall_s=t_derive1 - t_disp1,
                               records=len(records)),
    ]
    stats = {
        "lookups": lookups,
        "disk_or_prior_hits": cache.hits - h0,
        "in_run_dedup": (cache.misses - m0) - len(need),
        "simulated": len(need),
        "hit_rate": (lookups - len(need)) / lookups if lookups else 0.0,
        "devices": _device_count(dev),
        "phases": phases,
    }
    return DseResult(space=name, apps=apps, n_configs=len(cfgs),
                     records=records, stats=stats)


def _device_count(dev: torch.device) -> int:
    """The CUDA devices of the host for a CUDA sweep, 1 on the CPU."""
    return torch.cuda.device_count() if dev.type == "cuda" else 1


# --------------------------------------------------------------------------
# reductions: Pareto frontiers + budget reports
# --------------------------------------------------------------------------

def pareto_frontier(records) -> list:
    """Non-dominated subset, minimizing ``(runtime_ns, area_kb)``, sorted
    by runtime; ties resolve by ``(runtime, area, label)`` so the frontier
    is a pure function of the record values."""
    out = []
    best_area = float("inf")
    for r in sorted(records, key=lambda r: (r.runtime_ns, r.area_kb, r.label)):
        if r.area_kb < best_area:
            out.append(r)
            best_area = r.area_kb
    return out


def best_under_budget(records, budget_kb: float):
    """The fastest record whose area proxy fits the budget (None if none)."""
    ok = [r for r in records if r.area_kb <= budget_kb]
    return min(ok, key=lambda r: (r.runtime_ns, r.area_kb, r.label),
               default=None)


def frontier_summary(result: DseResult, budgets=(256.0, 512.0, 1024.0)) -> dict:
    """JSON-able digest: per-app frontier points + best-under-budget table."""
    out = {}
    by_app = result.by_app()
    for app, frontier in result.frontiers().items():
        recs = by_app[app]
        out[app] = {
            "frontier": [{"label": r.label, "runtime_ns": r.runtime_ns,
                          "area_kb": r.area_kb, "speedup": r.speedup}
                         for r in frontier],
            "best_under_budget_kb": {
                f"{b:g}": (lambda r: r.label if r else None)(
                    best_under_budget(recs, b)) for b in budgets},
        }
    return out


# --------------------------------------------------------------------------
# CLI / smoke gate
# --------------------------------------------------------------------------

def _frontier_fingerprint(result: DseResult) -> str:
    """Hash of every frontier's exact float values (bitwise contract)."""
    h = hashlib.sha1()
    frontiers = result.frontiers()
    for app in result.apps:
        for r in frontiers[app]:
            h.update(f"{app}|{r.label}|{r.runtime_ns!r}|{r.area_kb!r}"
                     .encode())
    return h.hexdigest()[:16]


def main(argv=None) -> int:
    import argparse
    from repro_torch.configs import vector_engine as vcfg
    ap = argparse.ArgumentParser(prog="python -m repro_torch.core.dse",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--space", default="smoke",
                    choices=("smoke", "quick", "full"))
    ap.add_argument("--apps", default=None,
                    help="comma-separated app subset (default: space preset)")
    ap.add_argument("--cache", default=None, help="JSONL cache path")
    ap.add_argument("--budget-kb", type=float, default=512.0)
    ap.add_argument("--smoke", action="store_true",
                    help="explore twice through the same cache; the second "
                         "pass must be 100%% hits with a bitwise-identical "
                         "frontier")
    ap.add_argument("--device", default=None,
                    help="engine device (default: the CUDA device; 'cpu' "
                         "runs the plain PyTorch scan)")
    args = ap.parse_args(argv)
    space = {"smoke": vcfg.SPACE_SMOKE, "quick": vcfg.SPACE_QUICK,
             "full": vcfg.SPACE_FULL}[args.space]
    apps = (tuple(args.apps.split(",")) if args.apps
            else vcfg.SPACE_PRESET_APPS[args.space])

    cache = ResultCache(args.cache)
    t0 = time.perf_counter()
    res = explore(space, apps, cache=cache, device=args.device)
    wall = time.perf_counter() - t0
    apps = res.apps
    print(f"space={space.name} ({res.n_configs} configs) x {len(apps)} apps "
          f"-> {len(res.records)} cells in {wall:.2f}s on "
          f"{res.stats['devices']} device(s); "
          f"simulated={res.stats['simulated']} "
          f"hit_rate={res.stats['hit_rate']:.1%}")
    for app, frontier in sorted(res.frontiers().items()):
        best = best_under_budget(res.by_app()[app], args.budget_kb)
        print(f"  {app:16s} frontier={len(frontier):3d} pts   "
              f"best<= {args.budget_kb:g}KB: "
              f"{best.label if best else '(none fits)'}")
    if not args.smoke:
        return 0

    fp1 = _frontier_fingerprint(res)
    t0 = time.perf_counter()
    # a fresh cache object re-reads the JSONL from disk (the persistence
    # claim); without a path the warm in-memory cache is the subject
    res2 = explore(space, apps,
                   cache=ResultCache(args.cache) if args.cache else cache,
                   device=args.device)
    wall2 = time.perf_counter() - t0
    fp2 = _frontier_fingerprint(res2)
    ok = (res2.stats["hit_rate"] == 1.0 and res2.stats["simulated"] == 0
          and fp1 == fp2)
    print(f"repeat pass: {wall2:.2f}s hit_rate={res2.stats['hit_rate']:.1%} "
          f"frontier {'bitwise-identical' if fp1 == fp2 else 'DIVERGED'} "
          f"-> {'ok' if ok else 'FAIL'}")
    return 0 if ok else 1


if __name__ == "__main__":
    # delegate to the canonical module object: the spaces in
    # repro_torch.configs carry repro_torch.core.dse.DesignSpace instances
    from repro_torch.core import dse as _canonical
    raise SystemExit(_canonical.main())
