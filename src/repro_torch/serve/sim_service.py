"""Simulation-as-a-service: async batched serving of simulation requests.

The port of ``repro/serve/sim_service.py``: treat simulation requests the
way a production inference server treats user queries.  A :class:`SimService` accepts a stream of
``(app | "app:asm" | kernel-trace, config)`` requests and answers them
through three tiers:

* **hit path** — the request's cell key (``dse.cell_key``: the same
  ``model|trace|config|warmup/measure`` fingerprint the DSE sweeps use) is
  already in the :class:`~repro_torch.core.dse.ResultCache`; the answer is
  returned immediately, no device dispatch.
* **coalesced** — an identical cell is already queued cold; the request
  rides that dispatch (one simulation, N answers).  Configs that alias to
  the same clamped body + timing parameters (e.g. ``mvl`` above an app's
  ``max_vl``) coalesce for free because they share a key.
* **batched** — cold requests queue until ``max_batch`` of them are waiting
  or the oldest has waited ``max_wait_s``; the batch goes to
  ``engine.steady_state_time_batch`` — one launch of the engine scan, the
  same path every sweep uses — so a service answer is bitwise the sweep
  answer.  The port compiles nothing per batch size: the scan's library is
  built once and loaded once (``engine.jit_cache_size`` counts both), and
  :meth:`SimService.prewarm` runs one dispatch at each power-of-two batch
  size up to ``max_batch`` so the library is loaded and the allocator holds
  those sizes before the first request; after it serving never rebuilds.

Robustness contract: the queue is bounded (``max_queue`` waiting requests);
on overflow the service degrades gracefully — ``overflow="serialize"``
dispatches the backlog inline (latency, not loss), ``overflow="shed"``
rejects the request with a ``source="shed"`` answer.  Every dispatch is
synchronous, so no path can deadlock.  Cache writes go through the
crash-safe locked single-write ``ResultCache.flush`` after every batch.

Observability: every answer is a :class:`SimResult` carrying arrival /
completion stamps and latency; :func:`run_workload` drives a (seeded,
deterministic) Poisson arrival stream through the service — in realtime
mode sleeping out the true inter-arrival gaps — and reduces the records to
p50/p99 latency, sustained throughput, hit/coalesce/shed counts and
recompile deltas (:class:`ServeReport`).

``python -m repro_torch.serve.sim_service --smoke [--device cpu]`` is the
CI gate: a short Poisson run must finish with zero post-prewarm rebuilds,
and a repeat pass against the persisted cache must answer >= 99 % of
requests from the cache with bitwise-identical times.  The engine runs on
the CUDA device unless ``device="cpu"`` is given; without a card the
service raises, it does not fall back to the CPU.
"""
from __future__ import annotations

import itertools
import threading
import time
from dataclasses import dataclass, field

import numpy as np

from repro_torch import _device
from repro_torch.core import dse
from repro_torch.core import engine as eng
from repro_torch.core import isa, suite, telemetry, tracegen


# --------------------------------------------------------------------------
# request / result records
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class SimRequest:
    """One simulation request: an app name (``"canneal"``, ``"canneal:asm"``)
    or a raw ``isa.Trace`` loop body (a *kernel* request), plus the engine
    config to time it on."""
    uid: int
    app: object                 # str | isa.Trace
    cfg: eng.VectorEngineConfig
    t_arrival: float


@dataclass(frozen=True)
class SimResult:
    """One answered request, with its latency record.

    ``source`` is the serving tier: ``"cache"`` (hit, no dispatch),
    ``"batched"`` (first rider of a cold dispatch), ``"coalesced"`` (rode an
    already-queued identical cell) or ``"shed"`` (rejected on overflow;
    ``steady_ns`` is NaN).  For kernel (raw-trace) requests the whole-app
    quantities ``runtime_ns``/``speedup`` are NaN — there is no chunk count
    or scalar baseline to derive them from.
    """
    uid: int
    app: str
    label: str
    steady_ns: float
    runtime_ns: float
    speedup: float
    source: str
    t_arrival: float
    t_done: float
    latency_s: float
    batch_id: int | None = None


@dataclass
class _PendingCell:
    """One cold cell awaiting dispatch, with every request riding it."""
    key: str
    body: isa.Trace
    cfg: eng.VectorEngineConfig
    reqs: list = field(default_factory=list)
    t_enqueue: float = 0.0


# --------------------------------------------------------------------------
# the service
# --------------------------------------------------------------------------

class SimService:
    """Async batched request serving over the vector-engine timing model.

    Single-object, thread-safe (an RLock serializes submit/flush), and
    synchronous at the dispatch boundary: ``submit`` returns immediately
    with a :class:`SimResult` for hits/sheds and ``None`` for queued cold
    requests, whose results arrive in :attr:`completed` (and by uid via
    :meth:`result_for`) when their batch dispatches — on :meth:`flush`,
    :meth:`drain`, or automatically when the batch fills.
    """

    def __init__(self, cache: dse.ResultCache | None = None,
                 max_batch: int = 32, max_wait_s: float = 0.05,
                 max_queue: int = 128, overflow: str = "serialize",
                 warmup: int = 8, measure: int = 24,
                 clock=time.perf_counter, snapshot_every: int = 0,
                 device=None):
        if overflow not in ("serialize", "shed"):
            raise ValueError(f"overflow={overflow!r}: 'serialize' or 'shed'")
        if max_batch < 1 or max_queue < 1:
            raise ValueError("max_batch and max_queue must be >= 1")
        self.device = _device.resolve(device)
        self.cache = cache if cache is not None else dse.ResultCache()
        self.max_batch = max_batch
        self.max_wait_s = max_wait_s
        self.max_queue = max_queue
        self.overflow = overflow
        self.warmup = warmup
        self.measure = measure
        self.clock = clock
        self.completed: list[SimResult] = []
        self.shed: list[SimResult] = []
        self._results: dict[int, SimResult] = {}
        self._pending: dict[str, _PendingCell] = {}   # insertion-ordered
        self._waiting = 0                             # riders across cells
        self._uid = itertools.count()
        self._lock = threading.RLock()
        self._model_fp = eng.model_fingerprint()
        # observability counters
        self.n_requests = 0
        self.n_hits = 0
        self.n_coalesced = 0
        self.n_dispatched = 0     # unique cells simulated
        self.n_shed = 0
        self.n_serialized = 0     # overflow-forced inline flushes
        self.n_batches = 0
        self.recompiles = 0       # build-count growth across dispatches
        # bounded log-spaced latency histogram: percentiles (incl. p99.9)
        # without retaining per-request records; plus optional periodic
        # stats snapshots (telemetry.SCHEMA rows) every N completions
        self.lat_hist = telemetry.LatencyHistogram()
        self.snapshot_every = snapshot_every
        self.snapshots: list[dict] = []

    # ---- keying ----------------------------------------------------------

    def _cell(self, app, cfg):
        """(display name, body, cache key) for a request payload."""
        if isinstance(app, isa.Trace):
            fp = isa.trace_fingerprint(app)
            key = (f"{self._model_fp}|{fp}|{dse.config_fp(cfg)}"
                   f"|w{self.warmup}m{self.measure}")
            return f"kernel:{fp[:8]}", app, key
        body, key = dse.cell_key(app, cfg, self.warmup, self.measure,
                                 model_fp=self._model_fp)
        return app, body, key

    # ---- submission ------------------------------------------------------

    def submit(self, app, cfg: eng.VectorEngineConfig,
               now: float | None = None):
        """Submit one request.  Returns the :class:`SimResult` when it can be
        answered synchronously (cache hit, or shed on overflow), else
        ``None`` — the result lands in :attr:`completed` at dispatch."""
        with self._lock:
            now = self.clock() if now is None else now
            req = SimRequest(next(self._uid), app, cfg, now)
            self.n_requests += 1
            name, body, key = self._cell(app, cfg)
            per_chunk = self.cache.get(key)
            if per_chunk is not None:
                return self._complete(req, name, body, per_chunk, "cache",
                                      self.clock(), None)
            cell = self._pending.get(key)
            if cell is not None:                      # coalesce onto it
                cell.reqs.append((req, name))
                self._waiting += 1
                self.n_coalesced += 1
                return None
            if self._waiting >= self.max_queue:       # bounded queue
                if self.overflow == "shed":
                    self.n_shed += 1
                    res = SimResult(
                        uid=req.uid, app=name, label=cfg.label(),
                        steady_ns=float("nan"), runtime_ns=float("nan"),
                        speedup=float("nan"), source="shed",
                        t_arrival=req.t_arrival, t_done=now, latency_s=0.0)
                    self.shed.append(res)
                    self._results[req.uid] = res
                    return res
                self.n_serialized += 1                # serialize: drain now
                self.flush()
            self._pending[key] = _PendingCell(key, body, cfg,
                                              reqs=[(req, name)],
                                              t_enqueue=now)
            self._waiting += 1
            if len(self._pending) >= self.max_batch:
                self.flush()
            return None

    # ---- batching / dispatch --------------------------------------------

    def pending_requests(self) -> int:
        return self._waiting

    def batch_ready(self) -> bool:
        return len(self._pending) >= self.max_batch

    def next_deadline(self) -> float | None:
        """Absolute clock time at which the oldest pending cell times out
        (the per-batch timeout), or None when nothing is queued."""
        with self._lock:
            if not self._pending:
                return None
            head = next(iter(self._pending.values()))
            return head.t_enqueue + self.max_wait_s

    def flush(self, now: float | None = None) -> int:
        """Dispatch every pending cell in ``max_batch``-sized batches, one
        engine scan launch each.  Returns cells dispatched."""
        with self._lock:
            done = 0
            while self._pending:
                keys = list(itertools.islice(iter(self._pending),
                                             self.max_batch))
                batch = [self._pending.pop(k) for k in keys]
                jc0 = eng.jit_cache_size()
                times = eng.steady_state_time_batch(
                    [c.body for c in batch], [c.cfg for c in batch],
                    warmup=self.warmup, measure=self.measure,
                    device=self.device)
                self.recompiles += eng.jit_cache_size() - jc0
                self.n_batches += 1
                batch_id = self.n_batches
                t_done = self.clock()
                for cell, t in zip(batch, times):
                    self.cache.put(cell.key, float(t))
                    self.n_dispatched += 1
                    done += 1
                    for i, (req, name) in enumerate(cell.reqs):
                        self._complete(req, name, cell.body, float(t),
                                       "batched" if i == 0 else "coalesced",
                                       t_done, batch_id)
                        self._waiting -= 1
                self.cache.flush()        # crash-safe persist per batch
            return done

    def drain(self) -> None:
        """Dispatch until nothing is pending (never blocks on anything but
        the dispatches themselves — cannot deadlock)."""
        self.flush()

    def prewarm(self) -> int:
        """One dispatch at every power-of-two batch size from 8 up to
        ``max_batch`` rounded up (``engine.batch_bucket``), so the scan's
        library is built and loaded and the allocator holds those sizes
        before serving.  Returns the number of sizes warmed (the
        reference's bucket count)."""
        with self._lock:
            cfg = eng.VectorEngineConfig(mvl=8, lanes=1)
            body = tracegen.body_for("blackscholes",
                                     suite.effective_mvl("blackscholes", cfg),
                                     cfg)
            buckets, b = [], 8
            while b <= eng.batch_bucket(self.max_batch):
                buckets.append(b)
                b *= 2
            for b in buckets:
                eng.steady_state_time_batch([body] * b, [cfg] * b,
                                            warmup=self.warmup,
                                            measure=self.measure,
                                            device=self.device)
            return len(buckets)

    # ---- completion ------------------------------------------------------

    def _complete(self, req: SimRequest, name: str, body, per_chunk: float,
                  source: str, t_done: float, batch_id):
        if isinstance(req.app, isa.Trace):
            runtime = speedup = float("nan")
        else:
            runtime = suite.vector_runtime_from_per_chunk(
                name, req.cfg, body, per_chunk)
            speedup = suite.scalar_runtime_ns(name, req.cfg) / runtime
        if source == "cache":
            self.n_hits += 1
        res = SimResult(
            uid=req.uid, app=name, label=req.cfg.label(),
            steady_ns=per_chunk, runtime_ns=runtime, speedup=speedup,
            source=source, t_arrival=req.t_arrival, t_done=t_done,
            latency_s=max(t_done - req.t_arrival, 0.0), batch_id=batch_id)
        self.completed.append(res)
        self._results[req.uid] = res
        self.lat_hist.add(res.latency_s)
        if self.snapshot_every and not len(self.completed) % self.snapshot_every:
            self.snapshots.append(telemetry.snapshot_row(
                "serve.snapshot", t=t_done, **self.stats()))
        return res

    def result_for(self, uid: int) -> SimResult | None:
        return self._results.get(uid)

    def stats(self) -> dict:
        """Counter snapshot (JSON-able), including the bounded latency
        histogram with its p50/p99/p99.9 estimates."""
        return {
            "requests": self.n_requests, "hits": self.n_hits,
            "coalesced": self.n_coalesced, "dispatched": self.n_dispatched,
            "shed": self.n_shed, "serialized": self.n_serialized,
            "batches": self.n_batches, "recompiles": self.recompiles,
            "pending": self._waiting,
            "hit_fraction": self.n_hits / self.n_requests
            if self.n_requests else 0.0,
            "cache_entries": len(self.cache),
            "latency": self.lat_hist.to_dict(),
        }


# --------------------------------------------------------------------------
# workloads: deterministic Poisson arrival streams
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class Arrival:
    t: float                    # offset from workload start (s)
    app: str
    cfg: eng.VectorEngineConfig


def poisson_arrivals(n: int, rate_hz: float, apps, cfgs,
                     seed: int = 0) -> list[Arrival]:
    """``n`` requests with exponential inter-arrival gaps at ``rate_hz``,
    apps and configs drawn uniformly — fully deterministic in ``seed``, so a
    repeat pass re-issues the identical request stream (the >= 99 %-hits
    acceptance check).

    >>> a = poisson_arrivals(4, 100.0, ("blackscholes",),
    ...                      (eng.VectorEngineConfig(),), seed=7)
    >>> a == poisson_arrivals(4, 100.0, ("blackscholes",),
    ...                       (eng.VectorEngineConfig(),), seed=7)
    True
    >>> [x.t for x in a] == sorted(x.t for x in a)
    True
    """
    apps = tuple(apps)
    cfgs = tuple(cfgs)
    rng = np.random.RandomState(seed)
    ts = np.cumsum(rng.exponential(1.0 / rate_hz, size=n))
    ia = rng.randint(0, len(apps), size=n)
    ic = rng.randint(0, len(cfgs), size=n)
    return [Arrival(float(t), apps[a], cfgs[c])
            for t, a, c in zip(ts, ia, ic)]


@dataclass
class ServeReport:
    """One workload run through the service, reduced to the serving metrics
    the acceptance criteria name."""
    n: int
    wall_s: float
    throughput_rps: float       # sustained completed-requests/sec
    p50_ms: float
    p99_ms: float
    p999_ms: float              # from the bounded histogram, not raw records
    mean_ms: float
    hits: int
    coalesced: int
    dispatched: int
    batches: int
    shed: int
    recompiles: int
    hit_fraction: float
    latency_hist: dict          # telemetry.LatencyHistogram row (this run)
    results: list               # [SimResult] in completion order

    def to_dict(self) -> dict:
        d = {k: getattr(self, k) for k in (
            "n", "wall_s", "throughput_rps", "p50_ms", "p99_ms", "p999_ms",
            "mean_ms", "hits", "coalesced", "dispatched", "batches", "shed",
            "recompiles", "hit_fraction", "latency_hist")}
        return d


def run_workload(service: SimService, arrivals, realtime: bool = False
                 ) -> ServeReport:
    """Drive an arrival stream through the service.

    ``realtime=True`` sleeps out the true inter-arrival gaps and fires the
    per-batch timeout at its wall-clock deadline, so latency percentiles are
    honest queueing + dispatch measurements (each request's arrival stamp is
    its *scheduled* time — time the service spends busy counts against it).
    ``realtime=False`` submits back-to-back (batches still cut at
    ``max_batch``) for deterministic, fast CI runs.
    """
    arrivals = list(arrivals)
    n0 = len(service.completed)
    s0 = service.stats()
    h0 = service.lat_hist.snapshot()
    t0 = service.clock()
    if realtime:
        for a in arrivals:
            target = t0 + a.t
            while True:
                dl = service.next_deadline()
                nxt = target if dl is None else min(target, dl)
                now = service.clock()
                if now < nxt:
                    time.sleep(nxt - now)
                    now = service.clock()
                if dl is not None and dl <= target and now >= dl:
                    service.flush(now=now)    # per-batch timeout fired
                    continue
                break
            service.submit(a.app, a.cfg, now=target)
    else:
        for a in arrivals:
            service.submit(a.app, a.cfg)
    service.drain()
    wall = service.clock() - t0
    s1 = service.stats()
    results = service.completed[n0:]
    lat = np.array([r.latency_s for r in results]) if results else np.zeros(1)
    hist = service.lat_hist.since(h0)   # just this run's completions
    n_done = len(results)
    return ServeReport(
        n=len(arrivals), wall_s=wall,
        throughput_rps=n_done / wall if wall > 0 else float("inf"),
        p50_ms=float(np.percentile(lat, 50)) * 1e3,
        p99_ms=float(np.percentile(lat, 99)) * 1e3,
        p999_ms=hist.percentile(0.999) * 1e3,
        mean_ms=float(lat.mean()) * 1e3,
        hits=s1["hits"] - s0["hits"],
        coalesced=s1["coalesced"] - s0["coalesced"],
        dispatched=s1["dispatched"] - s0["dispatched"],
        batches=s1["batches"] - s0["batches"],
        shed=s1["shed"] - s0["shed"],
        recompiles=s1["recompiles"] - s0["recompiles"],
        hit_fraction=(s1["hits"] - s0["hits"]) / max(len(arrivals), 1),
        latency_hist=hist.to_dict(),
        results=results)


# --------------------------------------------------------------------------
# CLI / smoke gate
# --------------------------------------------------------------------------

def _default_workload(n: int, rate_hz: float, seed: int, apps=None):
    from repro_torch.configs import vector_engine as vcfg
    apps = tuple(apps) if apps else ("blackscholes", "canneal")
    cfgs = tuple(vcfg.SPACE_SMOKE.sample(8, seed=seed + 1))
    return poisson_arrivals(n, rate_hz, apps, cfgs, seed=seed)


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(prog="python -m repro_torch.serve.sim_service",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--cache", default=None, help="JSONL ResultCache path")
    ap.add_argument("--n", type=int, default=48)
    ap.add_argument("--rate", type=float, default=400.0,
                    help="Poisson arrival rate (requests/sec)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--apps", default=None,
                    help="comma-separated app subset")
    ap.add_argument("--max-batch", type=int, default=16)
    ap.add_argument("--realtime", action="store_true",
                    help="sleep out true inter-arrival gaps (honest latency)")
    ap.add_argument("--smoke", action="store_true",
                    help="CI gate: prewarmed Poisson run must not recompile; "
                         "a repeat pass against the persisted cache must be "
                         ">=99%% hits with bitwise-identical times")
    ap.add_argument("--device", default=None,
                    help="engine device (default: the CUDA device; 'cpu' "
                         "runs the plain PyTorch scan)")
    args = ap.parse_args(argv)
    apps = tuple(args.apps.split(",")) if args.apps else None
    arrivals = _default_workload(args.n, args.rate, args.seed, apps)

    svc = SimService(cache=dse.ResultCache(args.cache),
                     max_batch=args.max_batch, device=args.device)
    svc.prewarm()
    rep = run_workload(svc, arrivals, realtime=args.realtime)
    print(f"pass 1: {rep.n} requests in {rep.wall_s:.2f}s "
          f"({rep.throughput_rps:.1f} req/s) p50={rep.p50_ms:.2f}ms "
          f"p99={rep.p99_ms:.2f}ms hits={rep.hits} "
          f"coalesced={rep.coalesced} dispatched={rep.dispatched} "
          f"batches={rep.batches} recompiles={rep.recompiles}")
    if not args.smoke:
        return 0

    # repeat pass: a fresh service + a fresh cache object (re-read from disk
    # when --cache was given — the persistence claim)
    svc2 = SimService(cache=dse.ResultCache(args.cache) if args.cache
                      else svc.cache, max_batch=args.max_batch,
                      device=args.device)
    rep2 = run_workload(svc2, arrivals, realtime=False)
    by_uid1 = sorted(rep.results, key=lambda r: r.uid)
    by_uid2 = sorted(rep2.results, key=lambda r: r.uid)
    bitwise = all(a.steady_ns == b.steady_ns and a.app == b.app
                  for a, b in zip(by_uid1, by_uid2))
    ok_recompiles = rep.recompiles == 0
    ok_hits = rep2.hit_fraction >= 0.99
    print(f"pass 2: hit_fraction={rep2.hit_fraction:.1%} "
          f"dispatched={rep2.dispatched} "
          f"times {'bitwise-identical' if bitwise else 'DIVERGED'}; "
          f"pass-1 steady-state recompiles={rep.recompiles} "
          f"-> {'ok' if ok_recompiles and ok_hits and bitwise else 'FAIL'}")
    return 0 if (ok_recompiles and ok_hits and bitwise) else 1


if __name__ == "__main__":
    # delegate to the canonical module object (its SimService and the
    # spaces' configs are repro_torch's)
    from repro_torch.serve import sim_service as _canonical
    raise SystemExit(_canonical.main())
