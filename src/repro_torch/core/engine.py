"""Cycle-level decoupled vector-engine timing model (paper §3), in PyTorch.

The port of ``repro/core/engine.py``.  The timing model is the same
list-scheduler recurrence: every instruction's issue time is the max over
its structural and data constraints (scalar-core frontier, ROB / rename /
issue-queue slots, operand readiness, FU availability, the in-order gate),
and its completion feeds those resources forward.  Ring buffers give ROB /
physical-register / issue-queue occupancy exactly.

Where the reference runs the step under ``lax.scan`` vmapped over configs,
the port writes the batch out: every (trace, config) pair is one *lane* of
one call to ``kernels.engine_scan.scan`` — on a CUDA device one thread per
lane of a hand-written kernel, on the CPU the plain PyTorch step loop.
There are no jit buckets and no chunked dispatch: a batch is one launch,
and ``engine_scan.scan.launches`` counts the launches.

``steady_state_time_batch`` checkpoints the scan at the end of the warmup
tiles directly (the reference pads the warmup with NOPs to a chunk
boundary; NOPs are timing-neutral, so both read the same carry).

Entry points run on the CUDA device unless ``device="cpu"`` is passed.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass, fields

import numpy as np
import torch

from repro_torch import _device
from repro_torch.core import isa
from repro_torch.core import memory
from repro_torch.kernels import engine_scan

MAX_RING = 64  # static ring-buffer capacity (>= max rob/queue/phys-in-flight)


@dataclass(frozen=True)
class VectorEngineConfig:
    """Every knob of Table 10 (and §3.2) is a field here."""
    mvl: int = 256                 # max vector length, 64-bit elements
    lanes: int = 8
    phys_regs: int = 40            # >= 32 architectural
    rob_entries: int = 64
    queue_entries: int = 16        # per queue (arith / memory)
    ooo_issue: bool = False
    vrf_read_ports: int = 1
    vrf_line_bits: int = 512
    interconnect: str = "ring"     # "ring" | "crossbar"
    mem_ports: int = 1
    cache_line_bits: int = 512
    lat_l1: float = 4.0
    lat_l2: float = 12.0
    lat_dram: float = 100.0
    mshrs: int = 16
    l1_kb: int = 32
    l2_kb: int = 256
    dram_bw_bytes_cycle: float = memory.DRAM_BW_BYTES_PER_CYCLE
    scalar_freq_ghz: float = 2.0
    vector_freq_ghz: float = 1.0
    issue_width: int = 2
    branch_miss_penalty: float = 6.0
    fusion: bool = False
    dispatch_latency: float = 5.0  # scalar commit -> vector engine dispatch

    def __post_init__(self):
        """The scan's occupancy rings hold MAX_RING entries; a capacity
        beyond that would wrap and corrupt every timing, so reject it."""
        for name, cap in (("rob_entries", self.rob_entries),
                          ("queue_entries", self.queue_entries),
                          ("phys_regs - 32", self.phys_regs - 32)):
            if cap > MAX_RING:
                raise ValueError(
                    f"{name}={cap} exceeds the engine ring capacity "
                    f"MAX_RING={MAX_RING}; raise engine.MAX_RING to model it")
        if self.phys_regs < 33:
            raise ValueError(
                f"phys_regs={self.phys_regs}: need >= 33 (32 architectural "
                "+ at least one rename register)")

    def label(self) -> str:
        """Result key: ``mvl{m}_l{l}`` plus one suffix per knob that differs
        from the Table-10 defaults; float knobs that ``%g`` would alias fall
        back to full-precision ``repr``."""
        s = f"mvl{self.mvl}_l{self.lanes}"
        for f in fields(self):
            v = getattr(self, f.name)
            if f.name in ("mvl", "lanes") or v == f.default:
                continue
            if f.name == "ooo_issue":
                s += "_ooo"
            elif f.name == "fusion":
                s += "_fusion"
            elif f.name == "interconnect":
                s += f"_{v}"
            else:
                r = f"{v:g}"
                if isinstance(v, float) and float(r) != v:
                    r = repr(v)
                s += f"_{f.name}{r}"
        return s


# Calibrated latency classes (the reference's calibration, bitwise: the
# model fingerprint below proves it).  Scalar: effective dependent-chain
# cycles per instruction at 2 GHz.  Vector: FU pipe depth (start-up) and
# per-element throughput cost in cycles/element/lane.
SCALAR_CYCLES = np.array([1.1, 3.0, 20.0, 24.0], np.float32)   # per FU class
VEC_PIPE_DEPTH = np.array([2.0, 4.0, 8.0, 8.0], np.float32)
VEC_ELEM_CYCLES = np.array([1.0, 1.0, 2.0, 2.0], np.float32)

# Scalar-pipeline knob deltas for residual scalar blocks (exactly zero at
# the Table-10 defaults).
SC_BLOCK_BRANCH_FRAC = 0.12    # branches per residual scalar instruction
SC_BLOCK_BMISS_RATE = 0.08     # mispredict rate of those branches
DEFAULT_BRANCH_MISS_PENALTY = 6.0
FUSION_SIMPLE_SAVE = 0.15      # simple-class cycles removed by macro-op fusion

# Every stall/execution cause the collect build of the scan attributes
# cycles to, in accumulator order (the reference's; ``kernels/engine_scan``
# documents the attribution).
STALL_KINDS = engine_scan.STALL_KINDS
N_STALL = engine_scan.N_STALL

# The kernel's calibration operand: one source of truth for both versions.
CONSTS = np.concatenate([SCALAR_CYCLES, VEC_PIPE_DEPTH, VEC_ELEM_CYCLES,
                         np.array([memory.DRAM_MLP, memory.PREFETCH_DEPTH],
                                  np.float32)])

METRICS = ("time", "t_scalar", "t_last_commit", "lane_busy", "vmu_busy")


def _cfg_params_np(cfg: VectorEngineConfig) -> tuple:
    """Per-config parameter vector (np scalars), computed as the reference
    computes it: float64 host arithmetic, then one cast to float32."""
    freq_ratio = cfg.vector_freq_ghz / cfg.scalar_freq_ghz
    scalar_scale = freq_ratio / cfg.issue_width
    bmiss_extra = (SC_BLOCK_BRANCH_FRAC * SC_BLOCK_BMISS_RATE
                   * (cfg.branch_miss_penalty - DEFAULT_BRANCH_MISS_PENALTY)
                   * freq_ratio)
    fuse_save = FUSION_SIMPLE_SAVE if cfg.fusion else 0.0
    return (
        np.float32(cfg.lanes), np.int32(cfg.phys_regs - 32),
        np.int32(cfg.rob_entries), np.int32(cfg.queue_entries),
        np.float32(cfg.vrf_read_ports), np.float32(cfg.cache_line_bits / 64),
        np.float32(cfg.mem_ports), np.float32(cfg.lat_l1),
        np.float32(cfg.lat_l2), np.float32(cfg.lat_dram),
        np.float32(scalar_scale), np.float32(cfg.dispatch_latency),
        np.float32(1.0 if cfg.ooo_issue else 0.0),
        np.float32(1.0 if cfg.interconnect == "ring" else 0.0),
        np.float32(cfg.l1_kb), np.float32(cfg.l2_kb), np.float32(cfg.mshrs),
        np.float32(memory.dram_line_cycles(cfg.cache_line_bits,
                                           cfg.dram_bw_bytes_cycle)),
        np.float32(bmiss_extra), np.float32(fuse_save),
    )


# Same version as the reference: the recurrence is the reference's.
MODEL_VERSION = 2


def model_fingerprint() -> str:
    """Hash of the calibration state (latency classes + memory constants);
    equal to the reference's iff every constant is bitwise identical."""
    h = hashlib.sha1()
    h.update(f"v{MODEL_VERSION}".encode())
    for a in (SCALAR_CYCLES, VEC_PIPE_DEPTH, VEC_ELEM_CYCLES):
        h.update(np.asarray(a).tobytes())
    for c in (memory.DRAM_BW_BYTES_PER_CYCLE, memory.DRAM_MLP,
              memory.PREFETCH_DEPTH):
        h.update(np.float32(c).tobytes())
    return h.hexdigest()[:8]


def config_fingerprint(cfg: VectorEngineConfig) -> str:
    """Hash of everything about a config the timing model consumes (the
    parameter vector); equal to the reference's for the same fields."""
    h = hashlib.sha1()
    for p in _cfg_params_np(cfg):
        h.update(np.asarray(p).tobytes())
    return h.hexdigest()[:16]


@dataclass
class ScanInputs:
    """The operands of one ``engine_scan.scan`` call (see that module)."""
    xi: torch.Tensor
    xf: torch.Tensor
    params: torch.Tensor
    consts: torch.Tensor
    period: torch.Tensor
    n_steps: torch.Tensor
    ckpt: torch.Tensor

    def args(self) -> tuple:
        return (self.xi, self.xf, self.params, self.consts, self.period,
                self.n_steps, self.ckpt)


def _validate_fields(xi: np.ndarray) -> None:
    """The kernel indexes its tables with these fields unchecked."""
    kind, fu = xi[0], xi[2]
    regs = xi[4:7]
    if kind.size and (kind.min() < isa.SCALAR_BLOCK or kind.max() > isa.NOP):
        raise ValueError("trace kind outside the ISA's kinds")
    if fu.size and (fu.min() < 0 or fu.max() >= isa.N_FU_CLASSES):
        raise ValueError("trace fu outside the FU classes")
    if regs.size and (regs.min() < -1 or regs.max() >= isa.N_ARCH_REGS):
        raise ValueError("trace register index outside [-1, 32)")


def pack(traces, cfgs, n_steps, ckpt, device) -> ScanInputs:
    """Lay B (trace, config) lanes out as scan operands on ``device``.

    Lane ``b`` stores ``traces[b]`` once (time-major, NOP-padded to the
    longest) and runs ``n_steps[b]`` records of it, tiled."""
    periods = [len(t) for t in traces]
    P = max(max(periods), 1)
    stacked = isa.stack_traces(list(traces), P)
    xi = np.stack([getattr(stacked, f).astype(np.int32)
                   for f in engine_scan.INT_FIELDS])            # [10, B, P]
    _validate_fields(xi)
    xi = np.ascontiguousarray(xi.transpose(0, 2, 1))            # [10, P, B]
    xf = np.ascontiguousarray(stacked.footprint_kb.T, dtype=np.float32)
    params = np.array([_cfg_params_np(c) for c in cfgs], np.float32)
    lane = lambda v: torch.as_tensor(np.asarray(v, np.int32), device=device)
    return ScanInputs(
        xi=torch.from_numpy(xi).to(device), xf=torch.from_numpy(xf).to(device),
        params=torch.from_numpy(params).to(device),
        consts=torch.from_numpy(CONSTS.copy()).to(device),
        period=lane([max(p, 1) for p in periods]), n_steps=lane(n_steps),
        ckpt=lane(ckpt))


def _broadcast_pairs(traces, cfgs, noun: str = "traces"):
    """Pair up the two argument lists, broadcasting a length-1 list."""
    traces = list(traces)
    cfgs = list(cfgs)
    if len(traces) == 1 and len(cfgs) > 1:
        traces = traces * len(cfgs)
    if len(cfgs) == 1 and len(traces) > 1:
        cfgs = cfgs * len(traces)
    if len(traces) != len(cfgs):
        raise ValueError(f"{len(traces)} {noun} vs {len(cfgs)} configs")
    return traces, cfgs


def _run(inputs: ScanInputs) -> np.ndarray:
    return engine_scan.scan(*inputs.args()).cpu().numpy()


def simulate_batch(traces, cfgs, device=None) -> list[dict]:
    """N (trace, config) pairs, one scan launch; a length-1 list broadcasts
    against the other.  Rows arrive in input order, each the five metrics
    (vector-engine cycles = ns) as Python floats."""
    traces, cfgs = _broadcast_pairs(traces, cfgs)
    if not traces:
        return []
    dev = _device.resolve(device)
    lens = [len(t) for t in traces]
    out = _run(pack(traces, cfgs, lens, [0] * len(traces), dev))
    return [{k: float(out[j, b]) for j, k in enumerate(METRICS)}
            for b in range(len(traces))]


def simulate(trace: isa.Trace, cfg: VectorEngineConfig,
             collect_stats: bool = False, device=None) -> dict:
    """Run the timing model on one trace; times in vector-engine cycles.

    With ``collect_stats=True`` the collect build of the scan runs instead
    (``engine_scan.scan_collect``: the same step arithmetic, so the timing
    metrics are bitwise the default's) and the result also carries:

    * ``stalls``: ``{cause: cycles}`` over ``STALL_KINDS``, summing to
      ``time`` (the event-sum identity);
    * ``occ_lane_fu``: lane-busy cycles per arithmetic FU class;
    * ``records``: per-record ``start`` / ``issue`` / ``complete`` numpy
      float32 arrays and the int32 ``cause`` index (the timeline's
      feedstock, ``repro_torch.core.telemetry``).
    """
    if not collect_stats:
        return simulate_batch([trace], [cfg], device=device)[0]
    dev = _device.resolve(device)
    inp = pack([trace], [cfg], [len(trace)], [0], dev)
    out, acc, rec = engine_scan.scan_collect(*inp.args())
    out, acc = out.cpu().numpy(), acc.cpu().numpy()
    res = {k: float(out[j, 0]) for j, k in enumerate(METRICS)}
    res["stalls"] = {k: float(v) for k, v in zip(STALL_KINDS, acc[:N_STALL, 0])}
    res["occ_lane_fu"] = [float(v) for v in acc[N_STALL:, 0]]
    res["records"] = {k: v[:, 0].cpu().numpy()
                      for k, v in engine_scan.records(rec).items()}
    return res


def steady_state_time_batch(bodies, cfgs, warmup: int = 8, measure: int = 24,
                            with_util: bool = False, device=None) -> list:
    """Marginal steady-state time of each (loop body, config) pair: one scan
    of ``warmup + measure`` tiles per lane, the warmup time read from the
    checkpoint after the warmup tiles, all lanes in one launch.

    With ``with_util`` each entry is ``{"steady_ns", "lane_util",
    "vmu_util"}``, utilizations marginal over the measurement window."""
    bodies, cfgs = _broadcast_pairs(bodies, cfgs, noun="bodies")
    if not bodies:
        return []
    dev = _device.resolve(device)
    out = _run(pack_steady_state(bodies, cfgs, warmup, measure, dev))
    res: list = []
    for b in range(len(bodies)):
        time, lane_busy, vmu_busy = (float(out[j, b]) for j in (0, 3, 4))
        t1, lane1, vmu1 = (float(out[j, b]) for j in (5, 6, 7))
        steady = (time - t1) / measure
        if not with_util:
            res.append(steady)
            continue
        wall = max(time - t1, 1e-9)
        res.append({"steady_ns": steady,
                    "lane_util": (lane_busy - lane1) / wall,
                    "vmu_util": (vmu_busy - vmu1) / wall})
    return res


def pack_steady_state(bodies, cfgs, warmup, measure, device) -> ScanInputs:
    """The scan operands of ``steady_state_time_batch``: each body stored
    once, run for ``warmup + measure`` tiles, checkpointed after warmup."""
    lens = [len(b) for b in bodies]
    return pack(bodies, cfgs, [(warmup + measure) * n for n in lens],
                [warmup * n for n in lens], device)


def steady_state_time(body: isa.Trace, cfg: VectorEngineConfig,
                      warmup: int = 8, measure: int = 24,
                      device=None) -> float:
    """Marginal steady-state time of one loop body (warmup removed)."""
    return steady_state_time_batch([body], [cfg], warmup, measure,
                                   device=device)[0]


def jit_cache_size() -> int:
    """The reference's recompile count, in the port: the CUDA libraries
    this process built with nvcc or loaded (``_build.builds``).  The port
    compiles nothing per shape, batch size or trace length: each source is
    built once (or found built) and loaded once, so after a path's first
    call the count no longer grows.  The CPU path builds nothing and
    leaves it 0."""
    from repro_torch import _build
    return _build.builds()


def batch_bucket(n: int) -> int:
    """The power-of-two batch size (>= 8) a batch of ``n`` pairs rounds up
    to: the reference's jit key of the batched path.  The port's scan takes
    any batch in one launch, so it is no compile key here; the simulation
    service uses it to pick the batch sizes it prewarms."""
    b = 8
    while b < n:
        b *= 2
    return b


def scalar_time(trace: isa.Trace, cfg: VectorEngineConfig) -> float:
    """Latency-weighted scalar-core time for a pure-scalar trace (ns), with
    the knob deltas the scan applies to residual scalar blocks (host numpy,
    as in the reference)."""
    freq_ratio = cfg.vector_freq_ghz / cfg.scalar_freq_ghz
    scale = freq_ratio / cfg.issue_width
    bmiss_extra = (SC_BLOCK_BRANCH_FRAC * SC_BLOCK_BMISS_RATE
                   * (cfg.branch_miss_penalty - DEFAULT_BRANCH_MISS_PENALTY)
                   * freq_ratio)
    fuse_save = FUSION_SIMPLE_SAVE if cfg.fusion else 0.0
    mask = trace.kind == isa.SCALAR_BLOCK
    fu = trace.fu[mask]
    eff = SCALAR_CYCLES[fu] * (1.0 - fuse_save * (fu == 0))
    return float(np.sum(trace.scalar_count[mask] * eff * scale
                        + trace.scalar_count[mask] * bmiss_extra))
