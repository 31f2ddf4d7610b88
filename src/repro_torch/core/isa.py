"""Vector IR: the trace format consumed by the engine timing model.

The port keeps the reference's trace IR as it is: host-side numpy
struct-of-arrays, same field names, dtypes and record constructors, so a
trace fingerprint means the same thing in both packages.  Only the engine
(``repro_torch.core.engine``) moves the fields onto a torch device.

A trace is a struct-of-arrays (one entry per instruction, program order).
Scalar instructions are run-length compressed into ``SCALAR_BLOCK`` entries
(the paper's tables count them individually; the timing model only needs the
latency-weighted block cost).  This mirrors the paper's gem5 model boundary:
vector instructions are handed to the decoupled engine at scalar commit
(§3.1), so wrong-path effects never reach the vector engine.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

# instruction kinds
SCALAR_BLOCK = 0   # `scalar_count` scalar instructions of class `fu_class`
VARITH = 1
VLOAD = 2
VSTORE = 3
VSLIDE = 4         # slide1up/slide1down: lane interconnect, distance 1
VREDUCE = 5        # reduction via binary operator tree across lanes
VMASK_SCALAR = 6   # vfirst.m / vpopc.m: writes a scalar register
VMOVE = 7          # whole-register moves / spill code (VL = MVL)
NOP = 8            # explicit padding entry: provably timing-neutral

KIND_NAMES = {
    SCALAR_BLOCK: "scalar", VARITH: "arith", VLOAD: "load", VSTORE: "store",
    VSLIDE: "slide", VREDUCE: "reduce", VMASK_SCALAR: "mask2s", VMOVE: "move",
    NOP: "nop",
}

# functional-unit classes (latency class of the operation)
FU_SIMPLE = 0      # add/sub/logic/compare/min/max
FU_MUL = 1         # mul / fused multiply-add
FU_DIV = 2         # div / sqrt
FU_TRANS = 3       # log / exp / cos (transcendental)
N_FU_CLASSES = 4

# memory access patterns
MEM_UNIT = 0
MEM_STRIDED = 1
MEM_INDEXED = 2


@dataclass
class Trace:
    """Struct-of-arrays instruction trace (host numpy arrays)."""
    kind: np.ndarray           # int32 [N]
    vl: np.ndarray             # int32 [N] vector length (elements)
    fu: np.ndarray             # int32 [N] FU class
    n_src: np.ndarray          # int32 [N] vector source operands (VRF reads)
    src1: np.ndarray           # int32 [N] logical reg or -1
    src2: np.ndarray
    dst: np.ndarray            # int32 [N] logical dest reg or -1
    mem_pattern: np.ndarray    # int32 [N] MEM_* for loads/stores
    footprint_kb: np.ndarray   # f32 [N] working-set footprint (KB) of the
                               #   stream this access belongs to; miss
                               #   probabilities are derived from it by
                               #   core.memory at simulation time
    scalar_count: np.ndarray   # int32 [N] for SCALAR_BLOCK
    dep_scalar: np.ndarray     # bool [N] consumes the engine's scalar result

    def __len__(self):
        return len(self.kind)

    @staticmethod
    def from_records(recs: list[dict]) -> "Trace":
        n = len(recs)
        get = lambda k, d=0: np.asarray([r.get(k, d) for r in recs])
        return Trace(
            kind=get("kind").astype(np.int32),
            vl=get("vl", 0).astype(np.int32),
            fu=get("fu", FU_SIMPLE).astype(np.int32),
            n_src=get("n_src", 2).astype(np.int32),
            src1=get("src1", -1).astype(np.int32),
            src2=get("src2", -1).astype(np.int32),
            dst=get("dst", -1).astype(np.int32),
            mem_pattern=get("mem_pattern", MEM_UNIT).astype(np.int32),
            footprint_kb=get("footprint_kb", 0.0).astype(np.float32),
            scalar_count=get("scalar_count", 0).astype(np.int32),
            dep_scalar=get("dep_scalar", False).astype(bool),
        )

    def tile(self, n: int) -> "Trace":
        """Repeat the trace n times (steady-state loop bodies)."""
        return Trace(**{k: np.tile(getattr(self, k), n)
                        for k in self.__dataclass_fields__})

    def concat(self, other: "Trace") -> "Trace":
        return Trace(**{k: np.concatenate([getattr(self, k), getattr(other, k)])
                        for k in self.__dataclass_fields__})

    def pad_to(self, n: int) -> "Trace":
        """Append NOP entries until the trace has exactly n instructions.

        NOPs take the scalar path with scalar_count=0 and dep_scalar=False, so
        they advance no clock and touch no engine resource: padding the tail
        of a trace never changes the simulated time (tests/test_torch_engine
        asserts this bitwise).
        """
        if n < len(self):
            raise ValueError(f"pad_to({n}) on trace of length {len(self)}")
        if n == len(self):
            return self
        return self.concat(nop_trace(n - len(self)))


def nop_trace(n: int) -> Trace:
    """A trace of n timing-neutral padding entries."""
    i32 = lambda v: np.full(n, v, np.int32)
    return Trace(
        kind=i32(NOP), vl=i32(0), fu=i32(FU_SIMPLE), n_src=i32(0),
        src1=i32(-1), src2=i32(-1), dst=i32(-1), mem_pattern=i32(MEM_UNIT),
        footprint_kb=np.zeros(n, np.float32),
        scalar_count=i32(0), dep_scalar=np.zeros(n, bool),
    )


def stack_traces(traces: list["Trace"], length: int | None = None) -> Trace:
    """Pad every trace to a common length and stack along a new batch axis.

    Returns a Trace whose fields are [B, L] arrays; the engine transposes
    them to the time-major [L, B] layout its scan reads.
    """
    if length is None:
        length = max(len(t) for t in traces)
    padded = [t.pad_to(length) for t in traces]
    return Trace(**{k: np.stack([getattr(t, k) for t in padded])
                    for k in Trace.__dataclass_fields__})


def mix_counts(n: int, mix: dict) -> dict:
    """Split n arithmetic instructions into FU classes by an app mix.

    The rounding residue lands on FU_SIMPLE, so the counts always sum to n.
    """
    out = {}
    acc = 0
    classes = [FU_SIMPLE, FU_MUL, FU_DIV, FU_TRANS]
    fracs = [mix.get(c, 0.0) for c in ("simple", "mul", "div", "trans")]
    for cls, f in zip(classes, fracs):
        k = int(round(n * f))
        out[cls] = k
        acc += k
    out[FU_SIMPLE] += n - acc
    return out


def fu_sequence(n: int, mix: dict) -> list:
    """The canonical shuffled FU-class sequence for n arithmetic instructions.

    The hand-coded ``tracegen`` bodies draw from this one generator, so a
    body's FU order is a pure function of (n, mix).
    """
    cm = mix_counts(n, mix)
    seq = []
    for cls, k in cm.items():
        seq += [cls] * k
    rng = np.random.RandomState(0)
    rng.shuffle(seq)
    return seq


class TraceBuilder:
    """Incremental builder for instruction traces.

    The hand-coded ``tracegen`` loop bodies append records through it.
    Methods return ``self`` for chaining; ``build()`` finalizes a ``Trace``.
    """

    def __init__(self):
        self._recs: list[dict] = []

    def __len__(self) -> int:
        return len(self._recs)

    @property
    def records(self) -> list[dict]:
        return self._recs

    def scalar(self, count, fu: int = FU_SIMPLE,
               dep_scalar: bool = False) -> "TraceBuilder":
        self._recs.append(scalar_block(count, fu=fu, dep_scalar=dep_scalar))
        return self

    def arith(self, vl, fu=FU_SIMPLE, n_src=2, src1=0, src2=1,
              dst=2) -> "TraceBuilder":
        self._recs.append(varith(vl, fu=fu, n_src=n_src, src1=src1,
                                 src2=src2, dst=dst))
        return self

    def arith_chain(self, n, mix, vl, start_reg: int = 4,
                    window: int = 16) -> "TraceBuilder":
        """n arith instructions with a rotating register dependency window."""
        for i, cls in enumerate(fu_sequence(n, mix)):
            self.arith(vl, fu=cls,
                       src1=start_reg + ((i + 5) % window),
                       src2=start_reg + ((i + 11) % window),
                       dst=start_reg + (i % window))
        return self

    def load(self, vl, dst=0, pattern=MEM_UNIT,
             footprint_kb=64.0) -> "TraceBuilder":
        self._recs.append(vload(vl, dst=dst, pattern=pattern,
                                footprint_kb=footprint_kb))
        return self

    def store(self, vl, src1=0, pattern=MEM_UNIT,
              footprint_kb=64.0) -> "TraceBuilder":
        self._recs.append(vstore(vl, src1=src1, pattern=pattern,
                                 footprint_kb=footprint_kb))
        return self

    def slide(self, vl, src1=0, dst=1) -> "TraceBuilder":
        self._recs.append(vslide(vl, src1=src1, dst=dst))
        return self

    def reduce(self, vl, src1=0, dst=1, fu=FU_SIMPLE) -> "TraceBuilder":
        self._recs.append(vreduce(vl, src1=src1, dst=dst, fu=fu))
        return self

    def mask_to_scalar(self, vl, src1=0) -> "TraceBuilder":
        self._recs.append(vmask_scalar(vl, src1=src1))
        return self

    def move(self, vl, src1=0, dst=1) -> "TraceBuilder":
        self._recs.append(vmove(vl, src1=src1, dst=dst))
        return self

    def raw(self, rec: dict) -> "TraceBuilder":
        self._recs.append(dict(rec))
        return self

    def extend(self, recs) -> "TraceBuilder":
        self._recs.extend(recs)
        return self

    def build(self) -> Trace:
        return Trace.from_records(self._recs)


def trace_fingerprint(trace: Trace) -> str:
    """Content hash of a trace (all fields, program order).  Two traces
    share a fingerprint iff every instruction field is bitwise identical;
    the hash equals the JAX package's for the same trace."""
    import hashlib
    h = hashlib.sha1()
    for name in Trace.__dataclass_fields__:
        a = np.ascontiguousarray(getattr(trace, name))
        h.update(name.encode())
        h.update(str(a.dtype).encode())
        h.update(a.tobytes())
    return h.hexdigest()[:16]


def trace_records(trace: Trace) -> list[dict]:
    """The inverse of ``Trace.from_records``: one plain dict per instruction.

    Every field is materialized as a Python scalar (no numpy types), so
    ``Trace.from_records(trace_records(t))`` reproduces ``t`` bitwise —
    the record view the RVV code generator walks when spelling a trace
    back out as assembly.
    """
    return [
        dict(kind=int(trace.kind[i]), vl=int(trace.vl[i]),
             fu=int(trace.fu[i]), n_src=int(trace.n_src[i]),
             src1=int(trace.src1[i]), src2=int(trace.src2[i]),
             dst=int(trace.dst[i]), mem_pattern=int(trace.mem_pattern[i]),
             footprint_kb=float(trace.footprint_kb[i]),
             scalar_count=int(trace.scalar_count[i]),
             dep_scalar=bool(trace.dep_scalar[i]))
        for i in range(len(trace))
    ]


def trace_registers(trace: Trace) -> int:
    """Number of distinct logical vector registers a trace touches — the
    register-pressure figure the cross-validation contract compares."""
    regs = np.concatenate([trace.src1, trace.src2, trace.dst])
    return int(np.unique(regs[regs >= 0]).size)


def kind_histogram(trace: Trace) -> np.ndarray:
    """Instruction-kind histogram (len 9, indexed by the KIND constants)."""
    return np.bincount(trace.kind, minlength=NOP + 1)


N_ARCH_REGS = 32   # architectural vector registers (the scoreboard size)


def validate_trace(trace: Trace, mvl: int | None = None,
                   predefined=()) -> list[str]:
    """Structural invariants a decoder-produced trace must satisfy.

    Returns a list of problem strings (empty == valid):

    * every register index in ``[0, N_ARCH_REGS)``,
    * ``vl <= mvl`` on every vector entry (when ``mvl`` is given),
    * no vector source register read before its first write — registers in
      ``predefined`` (e.g. a decoded kernel's prologue definitions) count as
      written at entry.

    The hand-coded ``tracegen`` bodies intentionally do *not* satisfy the
    dangling-source rule (their windows model registers carried across
    chunk iterations), so this is a decoder contract, not a global
    ``Trace`` one.
    """
    problems: list[str] = []
    regs = np.stack([trace.src1, trace.src2, trace.dst])
    bad = (regs >= N_ARCH_REGS) | ((regs < 0) & (regs != -1))
    if bad.any():
        problems.append(f"register index out of [0,{N_ARCH_REGS}): "
                        f"{sorted(set(regs[bad].tolist()))}")
    vec = trace.kind != SCALAR_BLOCK
    if mvl is not None and (trace.vl[vec] > mvl).any():
        problems.append(
            f"vl exceeds mvl={mvl}: max {int(trace.vl[vec].max())}")
    written = set(int(r) for r in predefined)
    for i in range(len(trace)):
        if not vec[i]:
            continue
        srcs = [int(trace.src1[i]), int(trace.src2[i])]
        for s in srcs[:max(int(trace.n_src[i]), 0)]:
            if s >= 0 and s not in written:
                problems.append(f"instr {i}: src v{s} read before first write")
        if int(trace.dst[i]) >= 0:
            written.add(int(trace.dst[i]))
    return problems


def scalar_block(count: int, fu: int = FU_SIMPLE, dep_scalar: bool = False) -> dict:
    return dict(kind=SCALAR_BLOCK, scalar_count=int(round(count)), fu=fu,
                dep_scalar=dep_scalar)


def varith(vl, fu=FU_SIMPLE, n_src=2, src1=0, src2=1, dst=2) -> dict:
    return dict(kind=VARITH, vl=vl, fu=fu, n_src=n_src, src1=src1, src2=src2, dst=dst)


def vload(vl, dst=0, pattern=MEM_UNIT, footprint_kb=64.0) -> dict:
    return dict(kind=VLOAD, vl=vl, dst=dst, mem_pattern=pattern, n_src=0,
                footprint_kb=footprint_kb)


def vstore(vl, src1=0, pattern=MEM_UNIT, footprint_kb=64.0) -> dict:
    return dict(kind=VSTORE, vl=vl, src1=src1, dst=-1, mem_pattern=pattern,
                n_src=1, footprint_kb=footprint_kb)


def vslide(vl, src1=0, dst=1) -> dict:
    return dict(kind=VSLIDE, vl=vl, src1=src1, dst=dst, n_src=1)


def vreduce(vl, src1=0, dst=1, fu=FU_SIMPLE) -> dict:
    return dict(kind=VREDUCE, vl=vl, src1=src1, dst=dst, n_src=1, fu=fu)


def vmask_scalar(vl, src1=0) -> dict:
    return dict(kind=VMASK_SCALAR, vl=vl, src1=src1, dst=-1, n_src=1)


def vmove(vl, src1=0, dst=1) -> dict:
    return dict(kind=VMOVE, vl=vl, src1=src1, dst=dst, n_src=1)


def nop() -> dict:
    return dict(kind=NOP, n_src=0, src1=-1, src2=-1, dst=-1)
