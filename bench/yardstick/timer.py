"""Every clock the benchmark reads: the host's clock, CUDA events around
calls into the program (spans), and the profiler's device trace.

- ``now()``: the host's monotonic clock, in seconds.
- ``Spans``: CUDA events recorded around calls of a program function that
  ``wrap`` replaces on its module while ``active`` (the host's clock on a
  CPU tensor's device, where there are no events); ``seconds(name)`` after
  a synchronize.
- ``Stages``: set-up's stages on the host's clock.
- ``Marks``: CUDA events recorded after units of work (steps), read as
  device seconds from a start event; ``rate`` the window's work over its
  length.
- ``Window``: the measured window of a run, around its work: the
  profiler over it when traced (with the spans on), the ``WINDOW`` label,
  the card's clocks before and after, a wait for the device at its close,
  and the peak memory.
- ``read_trace``: the kernels, copies and sets the device ran inside the
  profiler's window (the span the harness labels ``WINDOW``), with the busy
  time (their union), the window's length, the device operations that took
  most time and the idle gaps by what the host was doing.
"""
from __future__ import annotations

import time
from collections import defaultdict
from dataclasses import dataclass, field

import numpy as np
import torch

WINDOW = "bench.window"


def now() -> float:
    return time.perf_counter()


class Spans:
    """Timed calls of wrapped program functions, by span name."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.active = False
        self.records: dict[str, list] = defaultdict(list)

    def wrap(self, module, attr: str, name: str) -> None:
        orig = getattr(module, attr)
        spans = self

        def timed(*args, **kwargs):
            if not spans.active:
                return orig(*args, **kwargs)
            if spans.cuda:
                s = torch.cuda.Event(enable_timing=True)
                e = torch.cuda.Event(enable_timing=True)
                s.record()
                out = orig(*args, **kwargs)
                e.record()
                spans.records[name].append((s, e))
            else:
                t0 = now()
                out = orig(*args, **kwargs)
                spans.records[name].append((t0, now()))
            return out

        timed.__wrapped__ = orig
        setattr(module, attr, timed)

    def seconds(self, name: str) -> list[float]:
        """Each call's seconds (after the device has finished them)."""
        if self.cuda:
            return [s.elapsed_time(e) / 1e3 for s, e in self.records[name]]
        return [e - s for s, e in self.records[name]]


class Marks:
    """Device times of points in the stream, from a start mark."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.start = self._mark()
        self.points: list = []

    def _mark(self):
        if self.cuda:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            return e
        return now()

    def mark(self) -> None:
        self.points.append(self._mark())

    def seconds(self) -> list[float]:
        """Each mark's seconds after the start (after a synchronize)."""
        if self.cuda:
            return [self.start.elapsed_time(p) / 1e3 for p in self.points]
        return [p - self.start for p in self.points]


class Stages:
    """Set-up's stages on the host's clock, each closed by a wait for the
    device, printed as one line on standard error."""

    def __init__(self, device: torch.device, t_start: float):
        self.device, self.last, self.parts = device, t_start, []

    def mark(self, name: str) -> None:
        synchronize(self.device)
        t = now()
        self.parts.append(f"{name} {t - self.last:.2f}")
        self.last = t

    def report(self, out) -> None:
        print("set-up stages (s): " + ", ".join(self.parts), file=out)


def rate(amounts: list, ends: list) -> float:
    """Work over time for a window that starts at 0 and closes at the last
    of ``ends`` (each unit of work's end): all its work over all its
    time."""
    return sum(amounts) / max(ends)


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Window:
    """``with Window(device, spans, traced, smi) as w:`` around a run's
    measured work.  On entry ``smi()`` is read (``smi_before``), then the
    profiler starts if ``traced`` (and the spans are switched on), then the
    ``WINDOW`` label opens.  On exit the device is waited for, the label
    and the profiler close, ``smi()`` is read again (``smi_after``), and
    ``trace`` (the read profile, or None) and ``peak_bytes`` (the device's
    peak allocation since the process began) are set."""

    def __init__(self, device: torch.device, spans: Spans, traced: bool,
                 smi=dict):
        self.device, self.spans, self.traced, self.smi = device, spans, traced, smi
        self.trace: Trace | None = None
        self.peak_bytes = 0

    def __enter__(self) -> "Window":
        self.smi_before = self.smi()
        self._prof = None
        if self.traced:
            self._prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA])
            self._prof.__enter__()
            self.spans.active = True
        self._label = torch.profiler.record_function(WINDOW)
        self._label.__enter__()
        return self

    def __exit__(self, *exc) -> bool:
        synchronize(self.device)
        self._label.__exit__(*exc)
        self.spans.active = False
        if self._prof is not None:
            self._prof.__exit__(*exc)
            if exc[0] is None:
                self.trace = read_trace(self._prof)
            self._prof = None
        self.smi_after = self.smi()
        if self.device.type == "cuda":
            self.peak_bytes = torch.cuda.max_memory_allocated(self.device)
        return False


@dataclass
class Trace:
    window_s: float
    busy_s: float
    kernels: dict = field(default_factory=dict)   # name -> [seconds, calls]
    idle_by_host: list = field(default_factory=list)
    top_ops: list = field(default_factory=list)


def short_name(name: str) -> str:
    """A kernel's function name without its return type, template
    arguments and parameters."""
    n = name.replace("(anonymous namespace)::", "")
    for pre in ("void ", "__global__ "):
        if n.startswith(pre):
            n = n[len(pre):]
    depth, out = 0, []
    for ch in n:
        if ch in "<(":
            if depth == 0 and ch == "(":
                break
            depth += 1
        elif ch in ">)":
            depth -= 1
        elif depth == 0:
            out.append(ch)
    s = "".join(out).strip() or name
    return s[:96]


def _union(iv: np.ndarray) -> np.ndarray:
    """The union of intervals [n, 2] (sorted by start) as disjoint ones."""
    if len(iv) == 0:
        return iv
    merged = [list(iv[0])]
    for s, e in iv[1:]:
        if s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1][1] = e
        else:
            merged.append([s, e])
    return np.asarray(merged, dtype=np.int64)


def read_trace(prof, top: int = 10) -> Trace:
    """The device's work inside the ``WINDOW`` span of a finished
    ``torch.profiler.profile`` over CPU and CUDA activity."""
    events = prof.profiler.kineto_results.events()
    cpu, dev = [], []
    w0 = w1 = None
    for e in events:
        name = e.name()
        s, d = e.start_ns(), e.duration_ns()
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            # the device's own work; not the host's labels mirrored on its
            # timeline (user annotations)
            if not e.is_user_annotation() and name != WINDOW:
                dev.append((name, s, s + d))
        else:
            if name == WINDOW:
                w0, w1 = s, s + d
            cpu.append((name, s, s + d))
    if w0 is None:
        raise RuntimeError(f"the trace holds no {WINDOW!r} span")
    dev = [(n, max(s, w0), min(e, w1)) for n, s, e in dev if e > w0 and s < w1]
    kernels: dict = {}
    for n, s, e in dev:
        k = kernels.setdefault(short_name(n), [0.0, 0])
        k[0] += (e - s) / 1e9
        k[1] += 1
    iv = np.asarray(sorted((s, e) for _, s, e in dev), dtype=np.int64)
    busy = _union(iv.reshape(-1, 2))
    busy_ns = int((busy[:, 1] - busy[:, 0]).sum()) if len(busy) else 0
    # idle gaps: before the first, between, and after the last busy span
    edges = [w0] + [x for b in busy for x in b] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    idle = _attribute(gaps, cpu)
    ops = sorted(((n, v[0]) for n, v in kernels.items()), key=lambda x: -x[1])
    return Trace(window_s=(w1 - w0) / 1e9, busy_s=busy_ns / 1e9,
                 kernels=kernels, idle_by_host=idle[:top],
                 top_ops=[[n, s] for n, s in ops[:top]])


def _attribute(gaps, cpu) -> list:
    """Idle seconds summed by the innermost host operation running at each
    gap's midpoint (the latest-started one that spans it), longest first."""
    cpu = sorted((s, e, n) for n, s, e in cpu if n != WINDOW)
    starts = np.asarray([c[0] for c in cpu], dtype=np.int64)
    by: dict = defaultdict(float)
    for g0, g1 in gaps:
        m = (g0 + g1) // 2
        i = int(np.searchsorted(starts, m, side="right")) - 1
        label = "host outside any operation"
        for j in range(i, max(i - 64, -1), -1):
            if cpu[j][1] >= m:
                label = cpu[j][2]
                break
        by[label] += (g1 - g0) / 1e9
    return [[n, s] for n, s in sorted(by.items(), key=lambda x: -x[1])]
