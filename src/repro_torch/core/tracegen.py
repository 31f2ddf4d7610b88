"""RiVec suite models: instruction-count closed forms + timing trace bodies.

The port of ``repro/core/tracegen.py`` for the seven RiVec apps.  Every
application encodes two things:

1. ``counts(mvl)`` — a closed-form instruction-count model whose constants
   are fitted to the paper's published Tables 3-9 (provenance in comments).

2. ``body(mvl, cfg)`` — a representative loop-body trace (``isa.Trace``) for
   the cycle-level engine.  Per-chunk scalar overhead and the arithmetic
   class mix drive the timing reproduction of §5; memory accesses carry
   per-stream working-set footprints that ``core.memory`` turns into miss
   behaviour at simulation time.

Host-side numpy, as in the reference: the bodies are bitwise the
reference's (``tests/test_torch_isa.py`` compares their fingerprints).
Each RiVec app also carries a ``kernel=`` spec written in torch and lowered
by ``core.frontend`` (cross-validated against the hand-coded body), and an
``asm=`` entry of the RVV corpus decoded by ``core.rvv`` (the ``"<app>:asm"``
variant).  The three ML apps of ``core.workloads_ml`` register here too, so
the suite sees one app registry of ten apps and twenty names.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable

import torch

from repro_torch.core import frontend as fe
from repro_torch.core import isa
from repro_torch.core.isa import (FU_MUL, FU_SIMPLE, MEM_INDEXED, Trace,
                                  scalar_block, varith, vload, vmask_scalar,
                                  vmove, vreduce, vslide, vstore)


@dataclass
class Counts:
    """One MVL configuration's instruction-level characterization."""
    scalar_code_total: float       # scalar-version instructions (ROI)
    scalar_instrs: float           # remaining scalar instrs, vectorized code
    vector_mem: float
    vector_arith: float
    vector_manip: float = 0.0      # slides / element manipulation
    vector_ops: float = 0.0        # element operations performed

    @property
    def total_vector(self):
        return self.vector_mem + self.vector_arith + self.vector_manip

    @property
    def total_instrs(self):
        return self.scalar_instrs + self.total_vector


@dataclass(frozen=True)
class ScalarProfile:
    """Per-app scalar-code profile driving the event-based scalar-pipeline
    baseline (``core.scalar_pipeline``), replacing the retired
    ``SCALAR_BASELINE_MULT`` magic multipliers.

    ``branch_frac``/``load_frac`` are dynamic-instruction fractions of the
    scalar-version ROI; ``raw_frac`` is the dependency density (probability
    an instruction stalls on an in-flight producer's remaining latency);
    ``fusible_frac`` is the fraction of simple-class instructions leading a
    fusible pair (macro-op fusion, off by default).  ``mem_stall_cyc`` — the
    average extra scalar-core cycles per load beyond the pipelined L1 hit —
    is the ONE per-app fitted parameter (``benchmarks/calibrate.py``),
    bounded to the physical range [0, 40].  ``roi_instr_fraction`` is a
    named published-count correction: the fraction of the app's published
    scalar-instruction total that falls inside the published timing ROI
    (1.0 for every app except particlefilter — see docs/calibration.md).
    """
    branch_frac: float
    branch_miss_rate: float
    load_frac: float
    raw_frac: float
    fusible_frac: float
    mem_stall_cyc: float
    roi_instr_fraction: float = 1.0


@dataclass
class App:
    name: str
    counts: Callable[[int], Counts]
    body: Callable[[int, "object"], Trace]   # (mvl, cfg) -> one-chunk trace
    chunks: Callable[[int], float]           # loop bodies executed at this MVL
    mix: dict                                # arith class mix fractions
    init_scalar: float = 0.0                 # non-ROI init instructions
    max_vl: int = 10 ** 9                    # app's largest requested VL
    notes: str = ""
    # torch.fx-frontend chunk spec: (mvl, cfg) -> list of frontend segments.
    # For the RiVec apps it is cross-validated against `body` (same kind/FU/
    # pattern mix, same element and scalar work, steady-state time within
    # frontend.TIME_RTOL); for frontend-only workloads it IS the body.
    kernel: Callable[[int, "object"], list] = None
    # RVV assembly corpus entry (filename under src/repro_torch/asm): the
    # third trace source, decoded by core.rvv and cross-validated against
    # `body` exactly like `kernel` (python -m repro_torch.core.rvv
    # --check-all)
    asm: str = None


def _arith_seq(n, mix, vl, start_reg=4):
    """n vector arith instructions with a rotating register dependency chain
    (the canonical ``isa.fu_sequence`` order, shared with the frontend's
    ``chain_ops``)."""
    return isa.TraceBuilder().arith_chain(n, mix, vl, start_reg).records


# ===========================================================================
# Blackscholes (Table 3).  PARSEC large: 65,536 options x 100 runs =
# 6,553,600 option evaluations.  Derivation from the published table:
#   mem elems / option  = 22,118,400 * 8 / 6,553,600 = 27.0
#   arith elems / option = 220,364,800 * 8 / 6,553,600 = 269.0
#   vector_ops = 296 * options = 1,939,865,600 (matches, all MVLs)
#   scalar(mvl) = s0 + s1 * chunks, fit on (MVL=8, MVL=256):
#     s1 = (484,635,928-291,279,149)/(819,200-25,600) = 243.65
#     s0 = 291,279,149 - 25,600*243.65 = 285,041,709
#   (predicts 310.0M @MVL=64 vs published 312.2M: 0.7%)
# ===========================================================================

_BS_UNITS = 6_553_600
_BS_OPTIONS = 65_536                   # unique options (x 100 runs = UNITS)
_BS_MEM_PER = 27
_BS_ARITH_PER = 269
_BS_S1 = 243.65
_BS_S0 = 285_041_709
_BS_MIX = {"simple": 0.58, "mul": 0.36, "div": 0.04, "trans": 0.02}
# memory streams: the option arrays (27 doubles/option) are re-swept on each
# of the 100 runs, so the reuse distance is the full option data set
_BS_FOOTPRINT_KB = _BS_OPTIONS * _BS_MEM_PER * 8 / 1024   # ~13.8 MB


def _bs_counts(mvl):
    chunks = _BS_UNITS / mvl
    return Counts(
        scalar_code_total=4_316_765_131,
        scalar_instrs=_BS_S0 + _BS_S1 * chunks,
        vector_mem=_BS_MEM_PER * chunks,
        vector_arith=_BS_ARITH_PER * chunks,
        vector_ops=296 * _BS_UNITS,
    )


def _bs_body(mvl, cfg):
    vl = min(mvl, cfg.mvl) if cfg else mvl
    recs = [scalar_block(_BS_S1)]
    for i in range(_BS_MEM_PER - 5):
        recs.append(vload(vl, dst=i % 4, footprint_kb=_BS_FOOTPRINT_KB))
    recs += _arith_seq(_BS_ARITH_PER, _BS_MIX, vl)
    for i in range(5):
        recs.append(vstore(vl, src1=4 + i, footprint_kb=_BS_FOOTPRINT_KB))
    return Trace.from_records(recs)


def _bs_kernel(mvl, cfg):
    """Frontend spec: 22 option streams in, the characterized 269-op
    pricing chain, 5 result streams out."""
    vl = min(mvl, cfg.mvl) if cfg else mvl
    ins = tuple(fe.Stream(f"opt{i}", _BS_FOOTPRINT_KB)
                for i in range(_BS_MEM_PER - 5))
    outs = tuple(fe.Stream(f"price{i}", _BS_FOOTPRINT_KB) for i in range(5))

    def fn(*streams):
        win = fe.chain_ops(_BS_ARITH_PER, _BS_MIX, seeds=(1.0, 2.0), vl=vl)
        return tuple(win[:5])

    return [fe.ScalarWork(_BS_S1), fe.KernelBody(fn, vl, ins=ins, outs=outs)]


# ===========================================================================
# Jacobi-2D (Table 5).  PolyBench large, 4,000 iterations.
#   chunks@8 = 13,056,000 (65,280,000 mem / 5 per chunk)
#   per chunk: 5 mem (4 loads + 1 store), 19.906 arith, 4.977 slides
#   vector_ops = 3,121,152,000 + 4000*mvl   (the per-iteration vsetconst)
#   scalar fit: s1 = 87.16/chunk, s0 = 137,308,272
#     (predicts 279.62M @MVL=64 vs published 279.60M: 0.006%)
# ===========================================================================

_J2_CHUNK8 = 13_056_000
_J2_MEM_PER, _J2_ARITH_PER, _J2_MANIP_PER = 5, 19.906, 4.977
_J2_S0, _J2_S1 = 137_308_272, 87.16
_J2_MIX = {"simple": 0.6, "mul": 0.4}
# grid points per sweep = chunks/iter x 8 elems; the stencil re-reads the
# A/B grids once per iteration, so the stream footprint is both grids
_J2_GRID_KB = 2 * (_J2_CHUNK8 / 4000 * 8) * 8 / 1024      # ~408 KB


def _j2_counts(mvl):
    chunks = _J2_CHUNK8 * 8 / mvl
    return Counts(
        scalar_code_total=4_797_698_032,
        scalar_instrs=_J2_S0 + _J2_S1 * chunks,
        vector_mem=_J2_MEM_PER * chunks,
        vector_arith=_J2_ARITH_PER * chunks,
        vector_manip=_J2_MANIP_PER * chunks,
        vector_ops=3_121_152_000 + 4000 * mvl,
    )


def _j2_body(mvl, cfg):
    vl = min(mvl, cfg.mvl) if cfg else mvl
    recs = [scalar_block(_J2_S1)]
    for i in range(4):
        recs.append(vload(vl, dst=i, footprint_kb=_J2_GRID_KB))
    recs.append(vslide(vl, src1=0, dst=4))
    recs.append(vslide(vl, src1=0, dst=5))
    recs += _arith_seq(20, _J2_MIX, vl, start_reg=6)
    recs.append(vslide(vl, src1=6, dst=20))
    recs.append(vslide(vl, src1=7, dst=21))
    recs.append(vslide(vl, src1=8, dst=22))
    recs.append(vstore(vl, src1=20, footprint_kb=_J2_GRID_KB))
    return Trace.from_records(recs)


def _j2_kernel(mvl, cfg):
    """Frontend spec: the rolls lower to VSLIDEs, the stencil update to the
    characterized 20-op chain."""
    vl = min(mvl, cfg.mvl) if cfg else mvl
    ins = tuple(fe.Stream(f"grid{i}", _J2_GRID_KB) for i in range(4))

    def fn(a, b, c, d):
        up = torch.roll(a, 1)      # noqa: F841 neighbour slides: traced
        down = torch.roll(a, -1)   # noqa: F841 (and timed) though unused
        win = fe.chain_ops(20, _J2_MIX, seeds=(0.2,), vl=vl)
        s1 = torch.roll(win[0], 1)
        s2 = torch.roll(win[1], 1)   # noqa: F841 boundary-fixup slides: traced
        s3 = torch.roll(win[2], 1)   # noqa: F841 (and timed) though unstored
        return s1

    return [fe.ScalarWork(_J2_S1),
            fe.KernelBody(fn, vl, ins=ins,
                          outs=(fe.Stream("grid_out", _J2_GRID_KB),))]


# ===========================================================================
# Particle Filter (Table 6).  vfirst/vpopc mask ops -> scalar-core stalls.
#   arith instr fit: A/mvl + a0, A = 12,359,078,569, a0 = 657,519
#   mem   instr fit: M/mvl + m0, M = 12,861,315,  m0 = 33
#   ops fit: 12,371,423,928 + 659,566*mvl
#   scalar fit: s0 = 1,139,468,117, s1K = 1.845e10 (s = s0 + s1K/mvl)
#     (predicts 1,427.8M @64 vs published 1,423.6M: 0.3%)
# ===========================================================================

_PF_MIX = {"simple": 0.50, "mul": 0.30, "div": 0.05, "trans": 0.15}
# particle state arrays (positions/weights, ~100k particles of 8-B doubles)
_PF_STATE_KB = 781.0


def _pf_counts(mvl):
    return Counts(
        scalar_code_total=20_232_505_095,
        scalar_instrs=1_139_468_117 + 1.845e10 / mvl,
        vector_mem=12_861_315 / mvl + 33,
        vector_arith=12_359_078_569 / mvl + 657_519,
        vector_ops=12_371_423_928 + 659_566 * mvl,
    )


def _pf_chunks(mvl):
    # one "chunk" = one guess-update inner iteration over MVL particles
    return 12_359_078_569 / mvl / 960  # ~960 arith per chunk body


def _pf_body(mvl, cfg):
    vl = min(mvl, cfg.mvl) if cfg else mvl
    recs = [vload(vl, dst=0, footprint_kb=_PF_STATE_KB)]
    # Box-Muller + motion model: log/cos/sqrt heavy
    recs += _arith_seq(760, _PF_MIX, vl)
    # sequential-search (guess update): every inner iteration compares, runs
    # vfirst.m/vpopc.m and hands the result to the scalar core, which decides
    # how to continue — the §5.4 serialization that erases all speedup
    for _ in range(16):
        recs += _arith_seq(11, {"simple": 1.0}, vl)
        recs.append(vmask_scalar(vl, src1=5))
        recs.append(vmask_scalar(vl, src1=6))
        recs.append(scalar_block(84, dep_scalar=True))
    return Trace.from_records(recs)


def _pf_kernel(mvl, cfg):
    """Frontend spec: the Box-Muller/motion chain from the graph; the
    vfirst/vpopc round trips of the guess update are declared RawRecords
    (no torch analogue) followed by the dependent scalar decision."""
    vl = min(mvl, cfg.mvl) if cfg else mvl

    def motion(state):
        fe.chain_ops(760, _PF_MIX, seeds=(0.5,), vl=vl)
        return state

    def search():
        return fe.chain_ops(11, {"simple": 1.0}, seeds=(0.5,), vl=vl)[0]

    segs = [fe.KernelBody(motion, vl,
                          ins=(fe.Stream("particles", _PF_STATE_KB),))]
    for _ in range(16):
        segs.append(fe.KernelBody(search, vl))
        segs.append(fe.RawRecords((vmask_scalar(vl, src1=5),
                                   vmask_scalar(vl, src1=6))))
        segs.append(fe.ScalarWork(84, dep_scalar=True))
    return segs


# ===========================================================================
# Pathfinder (Table 7).  26% element-manipulation instructions.
#   chunks@8 = 20,054,016; per chunk: 5 mem, 6 arith, 4 slides (5:6:4 of 15)
#   vector_ops = 2,406,481,920 (constant)
#   scalar fit: s0 = 268,401,305, s1 = 38.33
#     (predicts 364.49M @64 vs published 364.49M: 0.002%)
# ===========================================================================

_PATH_CHUNK8 = 20_054_016
_PATH_S0, _PATH_S1 = 268_401_305, 38.33
# one 100k-column row of 8-B path costs; the result row is re-read on the
# next row pass, the wall is streamed once (cold: footprint = whole wall)
_PATH_ROW_KB = 100_000 * 8 / 1024                          # ~781 KB
_PATH_WALL_KB = _PATH_CHUNK8 * 8 * 8 / 1024                # cold stream


def _path_counts(mvl):
    chunks = _PATH_CHUNK8 * 8 / mvl
    return Counts(
        scalar_code_total=6_213_455_512,
        scalar_instrs=_PATH_S0 + _PATH_S1 * chunks,
        vector_mem=5 * chunks,
        vector_arith=6 * chunks,
        vector_manip=4 * chunks,
        vector_ops=2_406_481_920,
    )


def _path_body(mvl, cfg):
    vl = min(mvl, cfg.mvl) if cfg else mvl
    recs = [scalar_block(_PATH_S1)]
    recs.append(vload(vl, dst=0, footprint_kb=_PATH_WALL_KB))
    recs.append(vload(vl, dst=1, footprint_kb=_PATH_ROW_KB))
    recs.append(vload(vl, dst=2, footprint_kb=_PATH_ROW_KB))
    recs.append(vslide(vl, src1=1, dst=3))
    recs.append(vslide(vl, src1=1, dst=4))
    # min(left, center, right) + add weight
    recs.append(varith(vl, FU_SIMPLE, src1=3, src2=1, dst=5))
    recs.append(varith(vl, FU_SIMPLE, src1=5, src2=4, dst=6))
    recs.append(varith(vl, FU_SIMPLE, src1=6, src2=0, dst=7))
    recs.append(varith(vl, FU_SIMPLE, src1=7, src2=2, dst=8))
    recs.append(vslide(vl, src1=8, dst=9))
    recs.append(vslide(vl, src1=8, dst=10))
    recs.append(varith(vl, FU_SIMPLE, src1=9, src2=10, dst=11))
    recs.append(varith(vl, FU_SIMPLE, src1=11, src2=8, dst=12))
    recs.append(vload(vl, dst=13, footprint_kb=_PATH_ROW_KB))
    recs.append(vstore(vl, src1=12, footprint_kb=_PATH_ROW_KB))
    return Trace.from_records(recs)


def _path_kernel(mvl, cfg):
    """Frontend spec: the real min-propagation dataflow — slides and arith
    derive from the graph with true operand dependencies on the loads (the
    hand-coded body reads the same registers).  The next row's block is
    fetched while the result is stored (software pipelining, as the
    hand-coded body orders it)."""
    vl = min(mvl, cfg.mvl) if cfg else mvl
    ins = (fe.Stream("wall", _PATH_WALL_KB),
           fe.Stream("row", _PATH_ROW_KB),
           fe.Stream("row_prev", _PATH_ROW_KB))

    def fn(wall, row, row_prev):
        left = torch.roll(row, 1)
        right = torch.roll(row, -1)
        m1 = torch.minimum(left, row)
        m2 = torch.minimum(m1, right)
        c1 = m2 + wall
        c2 = c1 + row_prev
        s3 = torch.roll(c2, 1)
        s4 = torch.roll(c2, -1)
        m3 = torch.minimum(s3, s4)
        m4 = torch.minimum(m3, c2)
        return m4

    return [fe.ScalarWork(_PATH_S1),
            fe.KernelBody(fn, vl, ins=ins, outs=("cost",)),
            fe.KernelBody(lambda nxt, cost: cost, vl,
                          ins=(fe.Stream("row_next", _PATH_ROW_KB), "cost"),
                          outs=(fe.Stream("row_out", _PATH_ROW_KB),))]


# ===========================================================================
# Streamcluster (Table 8).  Memory-bound; dist() = loads + mul-sub + reduce.
#   calls = 59,533,158 (mem@128); dims = 128 (large input)
#   per call: ceil(128/mvl) chunks of (1 load + 1 arith) + 2 full-MVL arith
#   ops = 15,240,488,448 + 2*calls*mvl   (exact on all three published MVLs)
#   scalar fit: s0 = 1,944,277,308, s1 = 2.50/chunk
#     (predicts 2,241.9M @64 vs published 2,241.9M: 0.001%)
# ===========================================================================

_SC_CALLS = 59_533_158
_SC_DIMS = 128
_SC_MIX = {"simple": 0.5, "mul": 0.5}
# active set of a dist() call sequence: the candidate-center block plus the
# current window of streaming points (the full point set is ~60 MB, but the
# centers are re-read every call — this is the reuse distance that matters,
# and it is the lever of the Fig-10 LLC study: 256 KB spills it, 1 MB holds)
_SC_WSET_KB = 768.0


def _sc_counts(mvl):
    per_call = math.ceil(_SC_DIMS / mvl)
    chunks = _SC_CALLS * per_call
    return Counts(
        scalar_code_total=36_068_326_139,
        scalar_instrs=1_944_277_308 + 2.50 * chunks,
        vector_mem=chunks,
        vector_arith=chunks + 2 * _SC_CALLS,
        vector_ops=2 * _SC_DIMS * _SC_CALLS + 2 * _SC_CALLS * mvl,
    )


def _sc_chunks(mvl):
    return float(_SC_CALLS)  # one body = one dist() call


def _sc_body(mvl, cfg):
    vl_eff = min(mvl, _SC_DIMS, cfg.mvl if cfg else mvl)
    iters = math.ceil(_SC_DIMS / vl_eff)
    recs = []
    # streaming distance computation: L2-resident at best (memory bound)
    for i in range(iters):
        recs.append(scalar_block(2.5))
        recs.append(vload(vl_eff, dst=i % 8, footprint_kb=_SC_WSET_KB))
        recs.append(varith(vl_eff, FU_MUL, src1=i % 8, src2=8, dst=9 + i % 8))
    # the reduction runs at the requested VL (<= 128 dims), not the raw MVL
    recs.append(vreduce(vl_eff, src1=9, dst=20, fu=FU_SIMPLE))
    recs.append(vmask_scalar(vl_eff, src1=20))
    # the scalar core evaluates the center-opening cost before the next call
    recs.append(scalar_block(30, dep_scalar=True))
    return Trace.from_records(recs)


def _sc_kernel(mvl, cfg):
    """Frontend spec: each dist() sub-block is load + multiply with a real
    load->arith dependency (like the hand-coded body), chained through a
    named carry into the final reduction."""
    vl_eff = min(mvl, _SC_DIMS, cfg.mvl if cfg else mvl)
    iters = math.ceil(_SC_DIMS / vl_eff)
    segs = []
    for i in range(iters):
        segs.append(fe.ScalarWork(2.5))
        if i == 0:
            seg_fn, seg_ins = (lambda x: x * x), \
                (fe.Stream("block0", _SC_WSET_KB),)
        else:
            seg_fn, seg_ins = (lambda x, acc: acc * x), \
                (fe.Stream(f"block{i}", _SC_WSET_KB), "acc")
        segs.append(fe.KernelBody(seg_fn, vl_eff, ins=seg_ins, outs=("acc",)))
    segs.append(fe.KernelBody(lambda acc: torch.sum(acc), vl_eff,
                              ins=("acc",)))
    segs.append(fe.RawRecords((vmask_scalar(vl_eff, src1=20),)))
    segs.append(fe.ScalarWork(30, dep_scalar=True))
    return segs


# ===========================================================================
# Swaptions (Table 9).  HJM Monte-Carlo; RanUnif/serialB/CumNormalInv.
#   elems = 17,314,316,288 (constant over MVL); instr = elems/mvl
#   mem fraction = 370,323,456 / 2,164,289,536 = 0.17110
#   body = 29 instr (5 mem + 24 arith); chunks = instr/29
#   scalar fit: s0 = 266,357,033, s1 = 52.35/chunk
#     (predicts 754.7M @64 vs published 751.9M: 0.4%)
# ===========================================================================

_SW_ELEMS = 17_314_316_288
_SW_MIX = {"simple": 0.50, "mul": 0.35, "div": 0.05, "trans": 0.10}


def _sw_counts(mvl):
    instr = _SW_ELEMS / mvl
    return Counts(
        scalar_code_total=26_846_776_223,
        scalar_instrs=266_357_033 + 52.35 * instr / 29,
        vector_mem=0.17110 * instr,
        vector_arith=(1 - 0.17110) * instr,
        vector_ops=_SW_ELEMS,
    )


def _sw_chunks(mvl):
    return _SW_ELEMS / mvl / 29


def _sw_footprint_kb(vl):
    """Fig-10 lever: the HJM working set grows with the block size (=VL) —
    ~350 vectors of VL doubles live across the HJM path state (calibrated to
    the paper's stated observation: a 256 KB L2 degrades from MVL=128 up, a
    1 MB L2 holds through MVL=256).  At small VL it fits the L1 (22 KB at
    MVL=8); at MVL=128 it is 350 KB (spills 256 KB, fits 1 MB) and at
    MVL=256 it is 700 KB — the analytic model in core.memory turns the
    footprint into the observed degradation."""
    return vl * 8 * 350 / 1024


def _sw_body(mvl, cfg):
    vl = min(mvl, cfg.mvl) if cfg else mvl
    fp = _sw_footprint_kb(vl)
    recs = [scalar_block(52.35)]
    for i in range(4):
        recs.append(vload(vl, dst=i, footprint_kb=fp))
    recs += _arith_seq(24, _SW_MIX, vl)
    recs.append(vstore(vl, src1=10, footprint_kb=fp))
    return Trace.from_records(recs)


def _sw_kernel(mvl, cfg):
    """Frontend spec: HJM path-state streams with the VL-scaled footprint
    (the Fig-10 lever), characterized 24-op chain.  The chain runs over an
    8-wide rotating window (not the default 16) so each result is consumed
    again within a few ops, matching the hand-coded body's rotating-register
    chain density — the small-MVL steady-state time is startup-latency bound
    and sensitive to exactly this."""
    vl = min(mvl, cfg.mvl) if cfg else mvl
    fp = _sw_footprint_kb(vl)
    ins = tuple(fe.Stream(f"hjm{i}", fp) for i in range(4))

    def fn(*streams):
        return fe.chain_ops(24, _SW_MIX, seeds=(1.5,), vl=vl, window=8)[6]

    return [fe.ScalarWork(52.35),
            fe.KernelBody(fn, vl, ins=ins, outs=(fe.Stream("path", fp),))]


# ===========================================================================
# Canneal (Table 4).  Irregular DLP, short vectors (fan-in/out <= 22),
# indexed memory, reduction + scalar decision per swap, move/spill overhead
# proportional to MVL.
#   N_swaps = 1,920,000 (PARSEC large: 15,000 moves x 128 temperature steps)
#   requested-VL instrs (MVL>=32): 210,116,186 (= 271,044,357 - 60,928,171
#     full-MVL moves/spills, from the ops-vs-MVL slope 60.93e6/element)
#   E[fan] = 10.15 (avg requested VL); iteration multipliers fitted:
#     E[ceil(f/8)] = 1.395, E[ceil(f/16)] = 1.003  (published @8/@16 counts)
#   per extra iteration: 99.4 scalar instructions (consistent across @8/@16)
# ===========================================================================

_CA_N = 1_920_000
_CA_REQ = 210_116_186
_CA_MOVES = 60_928_171
_CA_MIX = {"simple": 1.0}
# hot slice of the netlist the random swap walk actually revisits between
# reuses (~3 MB of a far larger netlist): indexed loads miss both caches at
# 256 KB, and a 1 MB LLC captures a third of it — the memory.py model turns
# this into the canneal LLC sensitivity
_CA_HOT_KB = 3072.0
# fan-out distribution (fitted to E[f]=10.15, P(f>8)=.395, P(f>16)=.003)
_CA_FAN = {6: 0.18, 8: 0.422, 12: 0.15, 14: 0.12, 16: 0.125, 20: 0.003}


def _ca_iter_mult(mvl):
    return sum(p * math.ceil(f / mvl) for f, p in _CA_FAN.items())


# Empirical iteration multipliers fitted per published column (Table 4):
# memory instructions repeat per extra iteration more than arithmetic does
# (the two indexed loads run every iteration; arithmetic shrinks with the
# remaining VL), and MVL=8 spills run at effective VL 5.28, not 8.
_CA_MEM_BASE = 37_269_628
_CA_ARITH_REQ = 172_846_558            # 233,774,729 - moves
_CA_MEM_MULT = {8: 1.6069, 16: 1.00436}
_CA_ARITH_MULT = {8: 1.3489, 16: 1.00251}
_CA_REQ_OPS = 2_128_669_087            # = ops@32 - 32*moves
_CA_MOVES_VL = {8: 5.277}


def _ca_counts(mvl):
    mem_mult = _CA_MEM_MULT.get(mvl, _ca_iter_mult(mvl) if mvl < 8 else 1.0)
    ar_mult = _CA_ARITH_MULT.get(mvl, 1.0)
    mem = _CA_MEM_BASE * mem_mult
    arith = _CA_ARITH_REQ * ar_mult
    extra_iter = (_ca_iter_mult(mvl) - 1.0) * 2 * _CA_N
    moves_vl = _CA_MOVES_VL.get(mvl, mvl)
    return Counts(
        scalar_code_total=5_239_983_271,
        scalar_instrs=3_217_635_854 + 99.4 * extra_iter,
        vector_mem=mem,
        vector_arith=arith + _CA_MOVES,   # moves/spills counted as arith-class
        # requested element work is MVL-independent (2.13e9); moves/spills
        # execute at full MVL (the paper's large-MVL slowdown culprit, §5.2)
        vector_ops=_CA_REQ_OPS + _CA_MOVES * moves_vl,
    )


def _ca_chunks(mvl):
    return float(_CA_N)


def _ca_body(mvl, cfg):
    vl_req = 12  # representative fan size (E[f] ~ 10.15, use 12)
    vl = min(vl_req, mvl, cfg.mvl if cfg else mvl)
    iters = math.ceil(vl_req / vl)
    # moves/spills execute at the configured MVL regardless of the requested
    # VL (§4.1.2 — the large-MVL slowdown culprit), so they key off cfg.mvl
    # even when the suite clamps the body to the app's max requested VL
    mvl_eff = cfg.mvl if cfg else mvl
    recs = []
    for _ in range(2):  # two picked nodes
        # moves of the coordinate arguments (full MVL, §4.1.2)
        for i in range(int(round(_CA_MOVES / _CA_N / 2))):
            recs.append(vmove(mvl_eff, src1=i % 4, dst=8 + i % 4))
        for it in range(iters):
            recs.append(scalar_block(99.4 if it else 12))
            # pseudo-random netlist walk: indexed loads mostly miss to DRAM
            recs.append(vload(vl, dst=0, footprint_kb=_CA_HOT_KB,
                              pattern=MEM_INDEXED))
            recs.append(vload(vl, dst=1, footprint_kb=_CA_HOT_KB,
                              pattern=MEM_INDEXED))
            recs += _arith_seq(22, _CA_MIX, vl)
        recs.append(vreduce(vl, src1=6, dst=20))
        recs.append(vmask_scalar(vl, src1=20))
        # the scalar core computes the final routing cost + swap decision
        # before the next pair is dispatched (§4.1.2 "intensive communication")
        recs.append(scalar_block(820, dep_scalar=True))
    return Trace.from_records(recs)


def _ca_kernel(mvl, cfg):
    """Frontend spec: indexed netlist streams and the fan-in cost chain
    derive from the graph; the full-MVL argument moves/spills are declared
    RawRecords (ABI artifacts, no torch analogue), and the swap decision is
    a dependent ScalarWork after the reduction hands its result over."""
    vl_req = 12
    vl = min(vl_req, mvl, cfg.mvl if cfg else mvl)
    iters = math.ceil(vl_req / vl)
    mvl_eff = cfg.mvl if cfg else mvl
    n_mv = int(round(_CA_MOVES / _CA_N / 2))

    def walk_fn(a, b):
        return fe.chain_ops(22, _CA_MIX, seeds=(1.0,), vl=vl)[0]

    segs = []
    for _ in range(2):  # two picked nodes
        segs.append(fe.RawRecords(tuple(
            vmove(mvl_eff, src1=i % 4, dst=8 + i % 4) for i in range(n_mv))))
        for it in range(iters):
            segs.append(fe.ScalarWork(99.4 if it else 12))
            segs.append(fe.KernelBody(
                walk_fn, vl,
                ins=(fe.Stream("net_a", _CA_HOT_KB, pattern=MEM_INDEXED),
                     fe.Stream("net_b", _CA_HOT_KB, pattern=MEM_INDEXED)),
                outs=("cost",)))
        segs.append(fe.KernelBody(lambda cost: torch.sum(cost), vl,
                                  ins=("cost",)))
        segs.append(fe.RawRecords((vmask_scalar(vl, src1=20),)))
        segs.append(fe.ScalarWork(820, dep_scalar=True))
    return segs


# ===========================================================================

APPS = {
    "blackscholes": App("blackscholes", _bs_counts, _bs_body,
                        lambda mvl: _BS_UNITS / mvl, _BS_MIX,
                        init_scalar=573_256_509, kernel=_bs_kernel,
                        asm="blackscholes.s",
                        notes="regular DLP; PDE pricing; Table 3 / Fig 4"),
    "canneal": App("canneal", _ca_counts, _ca_body, _ca_chunks, _CA_MIX,
                   max_vl=22, kernel=_ca_kernel, asm="canneal.s",
                   notes="irregular DLP; indexed loads; Table 4 / Fig 5"),
    "jacobi-2d": App("jacobi-2d", _j2_counts, _j2_body,
                     lambda mvl: _J2_CHUNK8 * 8 / mvl, _J2_MIX,
                     kernel=_j2_kernel, asm="jacobi2d.s",
                     notes="stencil; slides stress interconnect; Table 5 / Fig 6"),
    "particlefilter": App("particlefilter", _pf_counts, _pf_body, _pf_chunks,
                          _PF_MIX, kernel=_pf_kernel, asm="particlefilter.s",
                          notes="mask ops stall scalar core; Table 6 / Fig 7"),
    "pathfinder": App("pathfinder", _path_counts, _path_body,
                      lambda mvl: _PATH_CHUNK8 * 8 / mvl, {"simple": 1.0},
                      kernel=_path_kernel, asm="pathfinder.s",
                      notes="26% element-manip instrs; Table 7 / Fig 8"),
    "streamcluster": App("streamcluster", _sc_counts, _sc_body, _sc_chunks,
                         _SC_MIX, max_vl=_SC_DIMS, kernel=_sc_kernel,
                         asm="streamcluster.s",
                         notes="memory bound; reduction/call; Table 8 / Fig 9"),
    "swaptions": App("swaptions", _sw_counts, _sw_body, _sw_chunks, _SW_MIX,
                     kernel=_sw_kernel, asm="swaptions.s",
                     notes="HJM Monte-Carlo; LLC sensitivity; Table 9 / Fig 10"),
}

# The paper's RiVec suite: both frontends exist and must cross-validate
# (core.frontend.cross_validate_all).
RIVEC_APPS = tuple(sorted(APPS))

# ---------------------------------------------------------------------------
# trace-source variants: "<app>:asm" names the same app with its loop body
# decoded from the RVV assembly corpus (src/repro_torch/asm, core.rvv)
# instead of the hand-coded `body`.  The suite resolves names through
# `app_for`/`body_for`/`chunks_for`, so asm-sourced apps ride `sweep_all`
# and the golden table unchanged.
# ---------------------------------------------------------------------------

ASM_SUFFIX = ":asm"


def split_variant(app_name: str) -> tuple[str, str]:
    """``"canneal:asm" -> ("canneal", "asm")``; plain names are "hand"."""
    if app_name.endswith(ASM_SUFFIX):
        return app_name[:-len(ASM_SUFFIX)], "asm"
    return app_name, "hand"


def app_for(app_name: str) -> App:
    """The registry entry backing a (possibly variant-suffixed) app name."""
    return APPS[split_variant(app_name)[0]]


def chunks_for(app_name: str, mvl: int, cfg=None) -> float:
    """Loop-body executions at this MVL.  For ``:asm`` variants the count is
    *derived from the decoded kernel* (its AVL / loop counter), not the
    closed form — the two agree to ~1e-8 (the .s AVLs are the rounded
    characterized totals)."""
    base, source = split_variant(app_name)
    if source == "asm":
        from repro_torch.core import rvv
        return rvv.asm_chunks(base, mvl, cfg)
    return APPS[base].chunks(mvl)


# Frontend-only ML workloads (no hand-coded bodies: the lowered kernel IS
# the body) — registered here so the suite sees one app registry.
from repro_torch.core import workloads_ml as _ml  # noqa: E402  (needs App/Counts)
APPS.update(_ml.make_apps(App, Counts))


# ---------------------------------------------------------------------------
# Scalar-pipeline profiles (core.scalar_pipeline): the per-app scalar
# -code event profile the dual-issue in-order baseline model consumes.
# branch/load/raw/fusible fractions are hand-set from each app's code
# character (commented); mem_stall_cyc is the one FITTED parameter per app
# (benchmarks/calibrate.py solves it closed-form against the §5 anchors and
# prints this table).  particlefilter additionally carries the named
# roi_instr_fraction correction (docs/calibration.md).
# ---------------------------------------------------------------------------

SCALAR_PROFILES = {
    # straight-line FP pricing; few, predictable branches; streams 13.8 MB
    # of option data -> most scalar loads miss the LLC (large mem stall)
    "blackscholes": ScalarProfile(branch_frac=0.10, branch_miss_rate=0.06,
                                  load_frac=0.22, raw_frac=0.35,
                                  fusible_frac=0.30, mem_stall_cyc=11.03),
    # pointer-chasing netlist walk: branchy, mispredict-prone, indexed loads
    # over a ~3 MB hot set that misses both caches
    "canneal": ScalarProfile(branch_frac=0.18, branch_miss_rate=0.12,
                             load_frac=0.28, raw_frac=0.30,
                             fusible_frac=0.20, mem_stall_cyc=5.25),
    # tight stencil loops: highly predictable branches, grid streams spill L1
    "jacobi-2d": ScalarProfile(branch_frac=0.08, branch_miss_rate=0.03,
                               load_frac=0.30, raw_frac=0.30,
                               fusible_frac=0.30, mem_stall_cyc=7.49),
    # Box-Muller/transcendental-heavy with a data-dependent sequential
    # search; the ROI correction is the named published-count term (§5.4)
    "particlefilter": ScalarProfile(branch_frac=0.14, branch_miss_rate=0.10,
                                    load_frac=0.22, raw_frac=0.35,
                                    fusible_frac=0.25, mem_stall_cyc=4.0,
                                    roi_instr_fraction=0.0763),
    # min-propagation: compare/branch dense, row arrays mostly L2-resident
    "pathfinder": ScalarProfile(branch_frac=0.16, branch_miss_rate=0.10,
                                load_frac=0.25, raw_frac=0.35,
                                fusible_frac=0.30, mem_stall_cyc=5.73),
    # dist() call chain over a spilling working set: memory-bound scalar too
    "streamcluster": ScalarProfile(branch_frac=0.12, branch_miss_rate=0.08,
                                   load_frac=0.28, raw_frac=0.30,
                                   fusible_frac=0.25, mem_stall_cyc=4.31),
    # HJM Monte-Carlo: compute-bound, small working set at scalar block sizes
    "swaptions": ScalarProfile(branch_frac=0.10, branch_miss_rate=0.06,
                               load_frac=0.20, raw_frac=0.30,
                               fusible_frac=0.30, mem_stall_cyc=1.43),
    # ML workloads (no paper anchors): profiles modeled, mem_stall set for
    # continuity with the previously modeled baselines (docs/calibration.md)
    "flash_attention": ScalarProfile(branch_frac=0.06, branch_miss_rate=0.04,
                                     load_frac=0.25, raw_frac=0.30,
                                     fusible_frac=0.30, mem_stall_cyc=1.90),
    # scalar core is itself DRAM-bound streaming the multi-MB KV cache
    "decode_attention": ScalarProfile(branch_frac=0.06, branch_miss_rate=0.04,
                                      load_frac=0.28, raw_frac=0.30,
                                      fusible_frac=0.30, mem_stall_cyc=17.87),
    "ssd_scan": ScalarProfile(branch_frac=0.08, branch_miss_rate=0.05,
                              load_frac=0.25, raw_frac=0.30,
                              fusible_frac=0.30, mem_stall_cyc=0.68),
}


def scalar_profile_for(app_name: str) -> ScalarProfile:
    """The scalar profile backing a (possibly variant-suffixed) app name —
    trace-source variants share the base app's scalar code."""
    return SCALAR_PROFILES[split_variant(app_name)[0]]


# Bodies are pure functions of (mvl, cfg) and VectorEngineConfig is frozen
# and hashable, so they are cached on the config itself.
_BODY_CACHE: dict = {}


def body_for(app_name: str, mvl: int, cfg=None) -> Trace:
    """Cached loop-body trace for a (possibly variant-suffixed) app name:
    ``APPS[name].body(mvl, cfg)``, or the decoded RVV corpus body for
    ``"<name>:asm"`` (callers must not mutate)."""
    key = (app_name, mvl, cfg)
    out = _BODY_CACHE.get(key)
    if out is None:
        base, source = split_variant(app_name)
        if source == "asm":
            from repro_torch.core import rvv
            out = rvv.asm_body(base, mvl, cfg)
        else:
            out = APPS[base].body(mvl, cfg)
        _BODY_CACHE[key] = out
    return out


# The asm-sourced suite variant (rides sweep_all and the golden table):
# every app whose corpus entry exists — the RiVec seven plus the three ML
# workloads.
ASM_APPS = tuple(f"{a}{ASM_SUFFIX}" for a in sorted(APPS) if APPS[a].asm)
