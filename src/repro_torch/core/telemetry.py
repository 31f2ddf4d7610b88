"""Unified telemetry: cycle attribution, timelines, latency histograms.

The port of ``repro/core/telemetry.py``.  Three consumers share the schema
defined here (``SCHEMA`` rows produced by :func:`snapshot_row`):

* **Engine profiling** — ``engine.simulate(..., collect_stats=True)`` (the
  collect build of the scan kernel on the card) returns per-cause cycle
  counters (``engine.STALL_KINDS``) whose sum reconstructs ``time`` (the
  event-sum identity, enforced by ``--smoke``).  This module rolls them up
  into per-module fractions (:func:`module_fractions`), a per-app x
  per-config scorecard (:func:`scorecard` -> :class:`ProfileReport`) and a
  Chrome Trace Event Format timeline (:func:`chrome_trace`) loadable in
  ``chrome://tracing`` / https://ui.perfetto.dev.
* **Serving** — a bounded, log-spaced :class:`LatencyHistogram` and
  periodic ``snapshot_row`` stats.
* **DSE** — ``repro_torch.core.dse.explore`` logs per-phase wall-clock and
  cache-counter rows in the same shape.

The module-stress classification here is the *mechanistic* twin of the
differential (knob-ablation) matrix of ``repro_torch.module_stress``, which
cross-checks the two.

    python -m repro_torch.core.telemetry --smoke [--device cpu]

The engine runs on the CUDA device unless ``device="cpu"`` is given.

>>> h = LatencyHistogram()
>>> for ms in (1.0, 2.0, 100.0): h.add(ms / 1e3)
>>> h.count
3
>>> 0.5e-3 < h.percentile(0.5) < 4e-3
True
>>> module_of("exec_mem")
'memory'
"""
from __future__ import annotations

import json
import math
from dataclasses import dataclass, field

import numpy as np

from repro_torch.core import engine as eng
from repro_torch.core import isa

SCHEMA = "repro.telemetry/v1"


def snapshot_row(kind: str, **payload) -> dict:
    """One telemetry row: the shared envelope every subsystem emits."""
    return {"schema": SCHEMA, "kind": kind, **payload}


# --------------------------------------------------------------------------
# module rollup: STALL_KINDS -> the paper's stressed-module classification
# --------------------------------------------------------------------------
# §5's Table-8-style taxonomy: which hardware module an app leans on.
#   lanes        — arithmetic FU execution + waiting for a busy lane FU
#   memory       — VMU execution (cache/MSHR/DRAM cycles), VMU busy wait,
#                  memory-queue backpressure
#   interconnect — slides / reductions crossing the lane fabric (the
#                  differential matrix's "manip"; the vfirst/vpopc
#                  mask->scalar path is scalar *communication*)
#   scalar       — residual scalar blocks, the scalar pipe carrying vector
#                  instructions, dep_scalar coupling round-trips, dispatch
#                  gating, and the vfirst/vpopc mask->scalar delivery
#   frontend     — structural sizing: ROB / rename / arith-queue fulls and
#                  the in-order issue gate
#   hazard       — RAW waits on vector register operands
MODULES: dict[str, tuple[str, ...]] = {
    "lanes": ("lane_wait", "exec_simple", "exec_mul", "exec_div",
              "exec_trans", "exec_move"),
    "memory": ("vmu_wait", "mq_full", "exec_mem"),
    "interconnect": ("exec_interconnect",),
    "scalar": ("scalar_work", "dep_scalar", "dispatch", "exec_mask"),
    "frontend": ("rob_full", "phys_full", "aq_full", "inorder"),
    "hazard": ("raw",),
}
_KIND_TO_MODULE = {k: m for m, ks in MODULES.items() for k in ks}
if set(_KIND_TO_MODULE) != set(eng.STALL_KINDS):
    raise AssertionError("telemetry.MODULES must cover engine.STALL_KINDS "
                         "exactly")

FU_NAMES = ("simple", "mul", "div", "trans")


def module_of(stall_kind: str) -> str:
    """The hardware module a stall/exec cause rolls up into."""
    return _KIND_TO_MODULE[stall_kind]


def module_fractions(stalls: dict[str, float], time: float) -> dict[str, float]:
    """Fraction of total runtime attributed to each module (sums to ~1)."""
    t = max(time, 1e-12)
    out = {m: 0.0 for m in MODULES}
    for k, v in stalls.items():
        out[_KIND_TO_MODULE[k]] += v / t
    return out


def top_bottleneck(modules: dict[str, float]) -> str:
    """The dominant module; ties break toward the MODULES declaration order."""
    order = list(MODULES)
    return max(modules, key=lambda m: (modules[m], -order.index(m)))


# --------------------------------------------------------------------------
# per-app profiling scorecard
# --------------------------------------------------------------------------
def profile_app(app_name: str, cfg: eng.VectorEngineConfig,
                tiles: int = 8, device=None) -> dict:
    """Mechanistic profile of one (app, config) cell: simulate ``tiles``
    loop-body iterations with ``collect_stats`` and roll the attribution up
    into the scorecard row schema."""
    from repro_torch.core import suite, tracegen
    mvl = suite.effective_mvl(app_name, cfg)
    body = tracegen.body_for(app_name, mvl, cfg)
    prof = eng.simulate(body.tile(tiles), cfg, collect_stats=True,
                        device=device)
    time = prof["time"]
    stalls = prof["stalls"]
    mods = module_fractions(stalls, time)
    ident = abs(sum(stalls.values()) - time) / max(time, 1.0)
    t = max(time, 1e-12)
    return snapshot_row(
        "engine.profile",
        app=app_name, config=cfg.label(), tiles=tiles, time=time,
        stalls=stalls, modules=mods, top=top_bottleneck(mods),
        fu_occupancy={n: o / t for n, o in
                      zip(FU_NAMES, prof["occ_lane_fu"])},
        lane_busy_frac=prof["lane_busy"] / t,
        vmu_busy_frac=prof["vmu_busy"] / t,
        identity_rel_err=ident,
    )


@dataclass
class ProfileReport:
    """Per-app x per-config module-stress scorecard."""
    rows: list = field(default_factory=list)
    schema: str = SCHEMA

    def by_app(self) -> dict[str, list]:
        out: dict[str, list] = {}
        for r in self.rows:
            out.setdefault(r["app"], []).append(r)
        return out

    def to_dict(self) -> dict:
        return {"schema": self.schema, "kind": "engine.scorecard",
                "rows": self.rows}

    def to_json(self, **kw) -> str:
        return json.dumps(self.to_dict(), **kw)

    def table(self) -> str:
        """Human-readable scorecard (one line per row)."""
        lines = [f"{'app':16s} {'config':24s} {'top':12s} "
                 + " ".join(f"{m:>6s}" for m in MODULES)]
        for r in self.rows:
            lines.append(
                f"{r['app']:16s} {r['config']:24s} {r['top']:12s} "
                + " ".join(f"{r['modules'][m]:6.3f}" for m in MODULES))
        return "\n".join(lines)


def scorecard(apps=None, cfgs=None, tiles: int = 8,
              device=None) -> ProfileReport:
    """Profile every app x config cell mechanistically."""
    from repro_torch.core import tracegen
    if apps is None:
        apps = sorted(tracegen.APPS)
    if cfgs is None:
        cfgs = [eng.VectorEngineConfig(mvl=64, lanes=4)]
    return ProfileReport(rows=[profile_app(a, c, tiles=tiles, device=device)
                               for a in apps for c in cfgs])


# --------------------------------------------------------------------------
# Chrome Trace Event Format / Perfetto timeline
# --------------------------------------------------------------------------
_TRACK_SCALAR, _TRACK_LANES, _TRACK_VMU = 0, 1, 2
_TRACK_NAMES = {_TRACK_SCALAR: "scalar pipe", _TRACK_LANES: "vector lanes",
                _TRACK_VMU: "VMU"}


def chrome_trace(trace: isa.Trace, cfg: eng.VectorEngineConfig,
                 label: str = "trace", device=None) -> dict:
    """One trace's instruction timeline in Chrome Trace Event Format.

    Three tracks (scalar pipe / vector lanes / VMU), one complete-event span
    per record from issue to completion, preceded by a ``stall:<cause>``
    span when the record waited visibly.  1 engine cycle is rendered as
    1 µs (``ts``/``dur`` are in µs in the format; the engine clock is
    1 GHz, so displayed µs = simulated µs x 1000).
    """
    prof = eng.simulate(trace, cfg, collect_stats=True, device=device)
    rec = prof["records"]
    kind = np.asarray(trace.kind)
    vl = np.asarray(trace.vl)
    fu = np.asarray(trace.fu)
    s_count = np.asarray(trace.scalar_count)
    events = [
        {"name": "process_name", "ph": "M", "pid": 0,
         "args": {"name": f"{label} @ {cfg.label()}"}},
    ] + [
        {"name": "thread_name", "ph": "M", "pid": 0, "tid": tid,
         "args": {"name": name}} for tid, name in _TRACK_NAMES.items()
    ]
    for i in range(len(kind)):
        k = int(kind[i])
        if k == isa.NOP:
            continue
        start = float(rec["start"][i])
        mid = float(rec["issue"][i])
        end = float(rec["complete"][i])
        cause = eng.STALL_KINDS[int(rec["cause"][i])]
        if k == isa.SCALAR_BLOCK:
            tid = _TRACK_SCALAR
            name = f"scalar x{int(s_count[i])} ({FU_NAMES[int(fu[i])]})"
        else:
            tid = _TRACK_VMU if k in (isa.VLOAD, isa.VSTORE) else _TRACK_LANES
            name = f"{isa.KIND_NAMES[k]} vl={int(vl[i])}"
            if k == isa.VARITH:
                name += f" ({FU_NAMES[int(fu[i])]})"
        if mid > start:
            events.append({"name": f"stall:{cause}", "cat": "stall",
                           "ph": "X", "ts": start, "dur": mid - start,
                           "pid": 0, "tid": tid,
                           "args": {"record": i, "cause": cause}})
        if end > mid:
            events.append({"name": name, "cat": "exec", "ph": "X",
                           "ts": mid, "dur": end - mid, "pid": 0, "tid": tid,
                           "args": {"record": i}})
    return {
        "traceEvents": events,
        "displayTimeUnit": "ns",
        "otherData": snapshot_row("engine.timeline", label=label,
                                  config=cfg.label(), time=prof["time"],
                                  stalls=prof["stalls"]),
    }


def write_chrome_trace(path: str, trace: isa.Trace,
                       cfg: eng.VectorEngineConfig,
                       label: str = "trace", device=None) -> dict:
    doc = chrome_trace(trace, cfg, label=label, device=device)
    with open(path, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
        f.write("\n")
    return doc


# --------------------------------------------------------------------------
# bounded log-spaced latency histogram (serving telemetry)
# --------------------------------------------------------------------------
class LatencyHistogram:
    """Fixed log-spaced latency buckets: percentiles without retaining every
    per-request latency record.  Default geometry spans 1 µs .. 100 s at 8
    buckets/decade (65 edges, 66 counters incl. under/overflow) — bounded
    memory no matter how many requests it absorbs."""

    def __init__(self, lo_s: float = 1e-6, hi_s: float = 1e2,
                 per_decade: int = 8, counts=None):
        self.lo_s, self.hi_s, self.per_decade = lo_s, hi_s, per_decade
        n = int(round(math.log10(hi_s / lo_s) * per_decade)) + 1
        self.edges = lo_s * (10.0 ** (np.arange(n) / per_decade))
        self.counts = (np.zeros(n + 1, np.int64) if counts is None
                       else np.asarray(counts, np.int64).copy())

    def add(self, seconds: float) -> None:
        self.counts[int(np.searchsorted(self.edges, seconds, "right"))] += 1

    @property
    def count(self) -> int:
        return int(self.counts.sum())

    def snapshot(self) -> np.ndarray:
        return self.counts.copy()

    def since(self, snapshot) -> "LatencyHistogram":
        """The histogram of everything added after ``snapshot`` was taken."""
        return LatencyHistogram(self.lo_s, self.hi_s, self.per_decade,
                                counts=self.counts - np.asarray(snapshot))

    def percentile(self, q: float) -> float:
        """q-quantile (q in [0,1]), geometrically interpolated within its
        bucket; under/overflow clamp to the histogram bounds."""
        total = self.count
        if total == 0:
            return 0.0
        target = q * total
        cum = np.cumsum(self.counts)
        b = int(np.searchsorted(cum, target, "left"))
        if b == 0:
            return self.lo_s
        if b >= len(self.edges):
            return self.hi_s
        lo, hi = self.edges[b - 1], self.edges[b]
        prev = cum[b - 1]
        frac = (target - prev) / max(self.counts[b], 1)
        return float(lo * (hi / lo) ** min(max(frac, 0.0), 1.0))

    def to_dict(self) -> dict:
        """Sparse row form: only non-empty buckets are materialized."""
        nz = np.nonzero(self.counts)[0]
        return snapshot_row(
            "latency.hist", unit="s", lo_s=self.lo_s, hi_s=self.hi_s,
            per_decade=self.per_decade, count=self.count,
            buckets={int(i): int(self.counts[i]) for i in nz},
            p50_s=self.percentile(0.50), p99_s=self.percentile(0.99),
            p999_s=self.percentile(0.999))


# --------------------------------------------------------------------------
# smoke gate
# --------------------------------------------------------------------------
SMOKE_CFGS = (eng.VectorEngineConfig(mvl=64, lanes=4),
              eng.VectorEngineConfig(mvl=256, lanes=8, ooo_issue=True,
                                     interconnect="crossbar"))


def _smoke(device=None) -> int:
    """The profiler's gate; returns the number of failures.

    1) every app x ``SMOKE_CFGS``, each body tiled 6 times: the collect
       timings bitwise equal to the default path's, and the event-sum
       identity within 1e-4 relative;
    2) a valid Chrome trace for ``blackscholes``;
    3) the histogram's percentiles.
    """
    from repro_torch.core import suite, tracegen
    failures = 0
    apps = sorted(tracegen.APPS)

    worst = 0.0
    for app in apps:
        for cfg in SMOKE_CFGS:
            body = tracegen.body_for(app, suite.effective_mvl(app, cfg), cfg)
            tr = body.tile(6)
            base = eng.simulate(tr, cfg, device=device)
            prof = eng.simulate(tr, cfg, collect_stats=True, device=device)
            for k, v in base.items():
                if prof[k] != v:
                    print(f"FAIL bitwise: {app} {cfg.label()} {k}: "
                          f"{v} != {prof[k]}")
                    failures += 1
            rel = abs(sum(prof["stalls"].values()) - prof["time"]) \
                / max(prof["time"], 1.0)
            worst = max(worst, rel)
            if rel > 1e-4:
                print(f"FAIL identity: {app} {cfg.label()} rel_err={rel:.2e}")
                failures += 1
    print(f"identity: {len(apps)} apps x {len(SMOKE_CFGS)} cfgs, worst rel "
          f"err {worst:.2e}")

    cfg = SMOKE_CFGS[0]
    body = tracegen.body_for("blackscholes",
                             suite.effective_mvl("blackscholes", cfg), cfg)
    doc = json.loads(json.dumps(chrome_trace(body.tile(2), cfg,
                                             label="blackscholes",
                                             device=device)))
    spans = [e for e in doc["traceEvents"] if e.get("ph") == "X"]
    ok = (bool(spans)
          and all({"name", "ts", "dur", "pid", "tid"} <= set(e) for e in spans)
          and all(math.isfinite(e["ts"]) and e["dur"] >= 0 for e in spans)
          and doc["otherData"]["schema"] == SCHEMA)
    if not ok:
        print("FAIL timeline: invalid Chrome-trace document")
        failures += 1
    print(f"timeline: {len(spans)} spans, valid JSON")

    h = LatencyHistogram()
    for ms in range(1, 101):
        h.add(ms / 1e3)
    p50, p99 = h.percentile(0.5), h.percentile(0.99)
    if not (0.03 < p50 < 0.08 and 0.08 < p99 <= 0.11 and h.count == 100):
        print(f"FAIL histogram: p50={p50} p99={p99} n={h.count}")
        failures += 1
    print(f"histogram: n={h.count} p50={p50 * 1e3:.1f}ms p99={p99 * 1e3:.1f}ms")
    return failures


def main(argv=None) -> int:
    import argparse
    p = argparse.ArgumentParser(prog="python -m repro_torch.core.telemetry",
                                description=__doc__.splitlines()[0])
    p.add_argument("--smoke", action="store_true",
                   help="attribution identity + bitwise default + timeline")
    p.add_argument("--scorecard", action="store_true",
                   help="print the 10-app module-stress scorecard")
    p.add_argument("--timeline", metavar="APP",
                   help="write a Chrome-trace timeline for one app")
    p.add_argument("-o", "--out", default="timeline.json")
    p.add_argument("--mvl", type=int, default=64)
    p.add_argument("--lanes", type=int, default=4)
    p.add_argument("--device", default=None,
                   help="engine device (default: the CUDA device; 'cpu' "
                        "runs the plain PyTorch scan)")
    args = p.parse_args(argv)
    rc = 0
    if args.smoke:
        rc = _smoke(args.device)
        print("profile-smoke:", "PASS" if rc == 0 else f"{rc} failure(s)")
    if args.scorecard:
        print(scorecard(device=args.device).table())
    if args.timeline:
        from repro_torch.core import suite, tracegen
        cfg = eng.VectorEngineConfig(mvl=args.mvl, lanes=args.lanes)
        body = tracegen.body_for(
            args.timeline, suite.effective_mvl(args.timeline, cfg), cfg)
        doc = write_chrome_trace(args.out, body.tile(2), cfg,
                                 label=args.timeline, device=args.device)
        print(f"wrote {args.out}: {len(doc['traceEvents'])} events, "
              f"{doc['otherData']['time']:.1f} cycles")
    return 0 if rc == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
