"""torch.fx → vector-IR trace frontend: lower torch kernel bodies to traces.

The suite's second trace source, the port of ``repro/core/frontend.py``.
The hand-coded bodies in ``core.tracegen`` describe each application's loop
body as an explicit instruction list; this module derives the same
``isa.Trace`` mechanically from a *traced torch function* — one MVL-chunk
worth of the kernel's work — so any torch-expressible kernel becomes a
simulatable benchmark:

1. the chunk function is traced to an aten-level ``torch.fx`` graph
   (``make_fx`` on fake float32 vectors of length ``vl``: every op is
   recorded, factory calls and dead values included, and each node's
   ``meta["val"]`` carries its shape),
2. every graph node is mapped to vector IR (the table below),
3. logical vector registers are assigned by live range (linear scan over
   the 32-register file the engine scoreboard models),
4. loads/stores come from declared :class:`Stream` block specs, carrying
   the stream's ``footprint_kb`` and access pattern so the analytic memory
   model (``core.memory``) works unchanged.

Op → IR mapping (the reference's jaxpr table, keyed by aten op names):

=====================================  =====================================
aten op                                vector IR
=====================================  =====================================
add/sub/minimum/maximum/compare/where  ``VARITH`` @ ``FU_SIMPLE``
mul / pow by an integer                ``VARITH`` @ ``FU_MUL``
div / sqrt / rsqrt / remainder         ``VARITH`` @ ``FU_DIV``
exp / log / erf / tanh / sin / pow     ``VARITH`` @ ``FU_TRANS``
sum / amax / amin / max / min / prod   ``VREDUCE`` (result stays vector-
(whole-tensor)                         register resident, RVV ``vfred*``)
any / all / argmax / argmin            ``VMASK_SCALAR`` (``vfirst``/``vpopc``
                                       class: result goes to the scalar core)
roll / cat / constant_pad_nd / flip    ``VSLIDE`` (lane interconnect)
cumsum/cumprod/cummax/cummin           ``ceil(log2(vl))`` × (``VSLIDE`` +
                                       ``VARITH``) — the RVV prefix ladder
index / gather / index_select          ``VLOAD`` @ ``MEM_INDEXED``
declared :class:`Stream` in/outs       ``VLOAD``/``VSTORE`` with the
                                       stream's pattern and footprint
rank-0 ops                             coalesced ``SCALAR_BLOCK``; marked
                                       ``dep_scalar`` when they consume a
                                       vector-engine result (reduction /
                                       mask / element extract)
full/arange/view/slice/select/...      free (register-view bookkeeping)
=====================================  =====================================

A spec written in torch traces in the order its ops run, which is the
order of the reference's jaxpr for the same spec: the lowering is
fingerprint-equal to the reference's (``tests/test_torch_frontend.py``).
Constructs with no torch-level analogue — whole-register spill moves and
the ``vfirst.m``/``vpopc.m`` mask round trips — are declared explicitly in
the kernel spec (:class:`RawRecords`), and bulk scalar bookkeeping is
declared as :class:`ScalarWork`; everything vectorizable is derived from
the graph.

``cross_validate_all`` keeps the two frontends honest: for every RiVec app
with a ``kernel=`` spec, the derived body must match the hand-coded one
exactly on instruction-kind mix, FU mix, memory-pattern mix, element counts
and scalar work, stay within the register file, and agree on steady-state
time within ``TIME_RTOL`` (5%).  ``python -m repro_torch.core.frontend``
runs the gate.
"""
from __future__ import annotations

import heapq
import math
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from repro_torch.core import crossval, isa


class FrontendError(Exception):
    """A kernel uses an op (or a value shape) the frontend can't map."""


# --------------------------------------------------------------------------
# op classification tables (aten op names)
# --------------------------------------------------------------------------

_S, _M, _D, _T = isa.FU_SIMPLE, isa.FU_MUL, isa.FU_DIV, isa.FU_TRANS

FU_OF_OP = {
    "add": _S, "sub": _S, "rsub": _S, "maximum": _S, "minimum": _S,
    "neg": _S, "abs": _S, "bitwise_and": _S, "bitwise_or": _S,
    "bitwise_xor": _S, "bitwise_not": _S, "logical_and": _S,
    "logical_or": _S, "logical_xor": _S, "logical_not": _S, "gt": _S,
    "lt": _S, "ge": _S, "le": _S, "eq": _S, "ne": _S, "where": _S,
    "sign": _S, "floor": _S, "ceil": _S, "round": _S, "clamp": _S,
    "clamp_min": _S, "clamp_max": _S, "isfinite": _S, "bitwise_left_shift": _S,
    "bitwise_right_shift": _S,
    "mul": _M, "square": _M,
    "div": _D, "sqrt": _D, "rsqrt": _D, "remainder": _D, "fmod": _D,
    "exp": _T, "exp2": _T, "log": _T, "log2": _T, "log1p": _T, "expm1": _T,
    "erf": _T, "erfc": _T, "erfinv": _T, "sin": _T, "cos": _T, "tan": _T,
    "asin": _T, "acos": _T, "atan": _T, "atan2": _T, "sinh": _T, "cosh": _T,
    "tanh": _T, "sigmoid": _T, "pow": _T,
}

REDUCE_FU = {"sum": _S, "amax": _S, "amin": _S, "max": _S, "min": _S,
             "prod": _M}

MASK_OPS = ("any", "all", "argmax", "argmin")

CUMULATIVE_FU = {"cumsum": _S, "cummax": _S, "cummin": _S, "cumprod": _M,
                 "logcumsumexp": _T}

SLIDE_OPS = ("roll", "cat", "constant_pad_nd", "flip")

GATHER_OPS = ("index", "gather", "index_select")

# register-view / layout bookkeeping and factories: free at the IR level
SKIP_OPS = ("_to_copy", "clone", "view", "_unsafe_view", "reshape",
            "expand", "unsqueeze", "squeeze", "slice", "select", "t",
            "transpose", "permute", "alias", "detach", "lift_fresh_copy",
            "copy", "arange", "full", "full_like", "scalar_tensor", "zeros",
            "zeros_like", "ones", "ones_like", "empty", "empty_like")

# the contract constants live in the shared cross-validation harness
N_LOGICAL_REGS = crossval.N_LOGICAL_REGS
TIME_RTOL = crossval.TIME_RTOL


# --------------------------------------------------------------------------
# kernel specs: streams + segments
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class Stream:
    """A declared memory stream (the frontend's block spec): name, working-set
    footprint between reuses (KB, feeds the analytic memory model), and
    access pattern."""
    name: str
    footprint_kb: float
    pattern: int = isa.MEM_UNIT


@dataclass(frozen=True)
class KernelBody:
    """A traced-torch segment of a chunk: ``fn`` is traced at vector length
    ``vl``; ``ins`` are :class:`Stream` block specs (lowered to ``VLOAD``)
    or names of values produced by earlier segments; ``outs`` pair the fn's
    return values with :class:`Stream` specs (lowered to ``VSTORE``), names
    (kept live for later segments), or ``None`` (dropped).

    ``lazy_loads=False`` fetches every declared block up front (block-spec
    semantics); ``True`` issues each load at first use (RVV streaming
    codegen) — required when a segment declares more streams than the
    register file holds."""
    fn: Callable
    vl: int
    ins: tuple = ()
    outs: tuple = ()
    lazy_loads: bool = False


@dataclass(frozen=True)
class ScalarWork:
    """Declared scalar-core bookkeeping (loop/addressing overhead): the
    per-chunk instruction counts come from the app characterization, not
    from the graph."""
    count: float
    fu: int = isa.FU_SIMPLE
    dep_scalar: bool = False


@dataclass(frozen=True)
class RawRecords:
    """Escape hatch for IR constructs with no torch analogue (spill moves,
    ``vfirst``/``vpopc`` mask round trips): explicit record dicts."""
    records: tuple


# --------------------------------------------------------------------------
# the characterized arithmetic chain (shared sequence with tracegen)
# --------------------------------------------------------------------------

def chain_ops(n: int, mix: dict, seeds=(1.0,), vl: int = 8,
              window: int = 16) -> list:
    """Apply ``n`` arithmetic ops in the canonical characterized sequence
    (``isa.fu_sequence`` — the same FU mix and shuffle the hand-coded bodies
    use) over a rotating dependency window of tensors; returns the final
    window.

    Float seeds become dependency-free immediates (``torch.full`` splats),
    mirroring the hand-coded bodies' constant-ready rotating registers;
    tensor seeds (e.g. loaded stream values) create real operand
    dependencies.
    """
    vals = [torch.full((vl,), float(s), dtype=torch.float32)
            if isinstance(s, (int, float)) else s for s in seeds]
    if not vals:
        raise FrontendError("chain_ops needs at least one seed")
    win = [vals[i % len(vals)] for i in range(window)]
    extra = list(vals[window:])
    for i, cls in enumerate(isa.fu_sequence(n, mix)):
        a = win[(i + 5) % window]
        b = extra.pop(0) if (extra and cls != isa.FU_TRANS) \
            else win[(i + 11) % window]
        if cls == isa.FU_SIMPLE:
            r = a + b
        elif cls == isa.FU_MUL:
            r = a * b
        elif cls == isa.FU_DIV:
            r = a / b
        else:
            r = torch.exp(a)
        win[i % window] = r
    return win


# --------------------------------------------------------------------------
# phase 1: walk segments/graphs into a linear vop list
# --------------------------------------------------------------------------

@dataclass
class _Val:
    """Abstract value during the walk: a vector register candidate ('vec',
    with a token), a scalar-core value ('sca'), or an immediate ('imm').
    ``hot`` marks scalar values produced by the vector engine — their scalar
    consumers become ``dep_scalar`` blocks."""
    kind: str
    tok: int = -1
    hot: bool = False


_IMM = _Val("imm")


def _op_name(node) -> str:
    target = node.target
    packet = getattr(target, "overloadpacket", None)
    return packet.__name__ if packet is not None else getattr(
        target, "__name__", str(target))


def _shape(node) -> tuple:
    val = node.meta.get("val")
    if isinstance(val, (tuple, list)):
        val = val[0]
    return tuple(getattr(val, "shape", ()))


def _node_args(node) -> list:
    """The node's positional operands in order, lists flattened (``cat``'s
    tensor list, ``index``'s index list)."""
    out = []
    for a in node.args:
        if isinstance(a, (list, tuple)):
            out.extend(a)
        else:
            out.append(a)
    return out


def _trace(fn, n_args: int, vl: int):
    """The aten-level graph of ``fn`` on ``n_args`` float32 ``[vl]``
    vectors.  Fake tensors carry the shapes without computing values (2-3x
    faster to trace than real ones)."""
    from torch.fx.experimental.proxy_tensor import make_fx
    example = [torch.zeros(vl, dtype=torch.float32) for _ in range(n_args)]
    return make_fx(fn, tracing_mode="fake")(*example).graph


class _Walker:
    def __init__(self):
        self.ops: list[dict] = []
        self.n_tok = 0
        self.env: dict[str, int] = {}
        self.stream_of_tok: dict[int, Stream] = {}
        self._pending = None           # coalescing SCALAR_BLOCK
        self._lazy: dict[int, dict] = {}

    def tok(self) -> int:
        self.n_tok += 1
        return self.n_tok - 1

    # -- record emission ----------------------------------------------------
    def _flush(self):
        if self._pending is not None:
            self.ops.append(self._pending)
            self._pending = None

    def scalar_eqn(self, dep: bool):
        if self._pending is None:
            self._pending = {"op": "scalar", "count": 0, "fu": isa.FU_SIMPLE,
                             "dep": False}
        self._pending["count"] += 1
        self._pending["dep"] |= dep

    def emit(self, op: dict):
        """Append a vector op (flushing any pending scalar block first)."""
        self._flush()
        self.ops.append(op)

    def use(self, val: _Val) -> int:
        """Resolve a vec value to its token, materializing a lazy load."""
        pend = self._lazy.pop(val.tok, None)
        if pend is not None:
            self.emit(pend)
        return val.tok

    # -- graph walk ---------------------------------------------------------
    def walk(self, graph, valmap: dict):
        for node in graph.nodes:
            if node.op in ("placeholder", "output"):
                continue
            if node.op == "get_attr":
                valmap[node] = _IMM
                continue
            if node.op != "call_function":
                raise FrontendError(f"unsupported graph node {node.op!r}")
            name = _op_name(node)
            invals = [self._resolve(a, valmap) for a in _node_args(node)]
            oshape = _shape(node)
            onelem = int(np.prod(oshape)) if oshape else 1
            vecs = [v for v in invals if v.kind == "vec"]

            if name == "getitem":
                valmap[node] = invals[0]
            elif name in SKIP_OPS:
                valmap[node] = self._skip_val(invals, oshape)
            elif name in CUMULATIVE_FU:
                valmap[node] = self._cumulative(name, invals, onelem)
            elif name in REDUCE_FU:
                in_elems = int(np.prod(_shape(node.args[0])))
                t = self.tok()
                self.emit({"op": "reduce", "vl": in_elems,
                           "fu": REDUCE_FU[name],
                           "src": self.use(vecs[0]) if vecs else None,
                           "out": t})
                # result stays vector-register resident (RVV vfred*) but is
                # hot: a scalar consumer needs the engine's scalar result
                valmap[node] = _Val("vec", t, hot=True)
            elif name in MASK_OPS:
                in_elems = int(np.prod(_shape(node.args[0])))
                self.emit({"op": "mask", "vl": in_elems,
                           "src": self.use(vecs[0]) if vecs else None})
                valmap[node] = _Val("sca", hot=True)
            elif name in GATHER_OPS:
                stream = self.stream_of_tok.get(
                    invals[0].tok if invals[0].kind == "vec" else -1)
                fp = stream.footprint_kb if stream else 64.0
                idx = next((v for v in invals[1:] if v.kind == "vec"), _IMM)
                t = self.tok()
                self.emit({"op": "load", "vl": onelem, "out": t,
                           "stream": Stream("gather", fp, isa.MEM_INDEXED),
                           "idx": self.use(idx) if idx.kind == "vec" else None})
                valmap[node] = _Val("vec", t)
            elif name in SLIDE_OPS:
                t = self.tok()
                self.emit({"op": "slide", "vl": onelem,
                           "src": self.use(vecs[0]) if vecs else None,
                           "out": t})
                valmap[node] = _Val("vec", t)
            elif name in FU_OF_OP:
                fu = FU_OF_OP[name]
                if name == "pow" and isinstance(node.args[1], int):
                    fu = _M                    # integer power: multiplies
                if not oshape:  # rank-0: runs on the scalar core
                    dep = any(v.hot or v.kind == "vec" for v in invals)
                    self.scalar_eqn(dep)
                    valmap[node] = _Val("sca", hot=dep)
                else:
                    t = self.tok()
                    srcs = [self.use(v) for v in vecs]
                    self.emit({"op": "arith", "vl": onelem, "fu": fu,
                               "srcs": srcs, "out": t, "n_src": len(srcs)})
                    valmap[node] = _Val("vec", t)
            else:
                raise FrontendError(
                    f"no vector-IR mapping for op {name!r} "
                    f"(see frontend.FU_OF_OP and friends)")

    def _resolve(self, a, valmap) -> _Val:
        if not isinstance(a, torch.fx.Node):
            return _IMM                # python scalar / dtype / shape literal
        try:
            return valmap[a]
        except KeyError:
            raise FrontendError(f"unbound graph value {a}") from None

    def _skip_val(self, invals, oshape) -> _Val:
        vecs = [v for v in invals if v.kind == "vec"]
        if vecs and not oshape:
            # element extract (vector -> scalar): a vfmv.f.s-class transfer
            return _Val("sca", hot=True)
        if vecs:
            return vecs[0]           # register view, aliases the operand
        if any(v.kind == "sca" for v in invals):
            return _Val("sca", hot=any(v.hot for v in invals))
        return _IMM

    def _cumulative(self, name, invals, nelem) -> _Val:
        """RVV prefix ladder: ceil(log2(vl)) rounds of slide + op."""
        cur = invals[0]
        rounds = max(1, int(math.ceil(math.log2(max(nelem, 2)))))
        for _ in range(rounds):
            ts = self.tok()
            self.emit({"op": "slide", "vl": nelem,
                       "src": self.use(cur) if cur.kind == "vec" else None,
                       "out": ts})
            ta = self.tok()
            srcs = ([self.use(cur)] if cur.kind == "vec" else []) + [ts]
            self.emit({"op": "arith", "vl": nelem, "fu": CUMULATIVE_FU[name],
                       "srcs": srcs, "out": ta, "n_src": len(srcs)})
            cur = _Val("vec", ta)
        return cur

    # -- segments -----------------------------------------------------------
    def segment(self, seg):
        if isinstance(seg, ScalarWork):
            self._flush()
            self.ops.append({"op": "scalar", "count": seg.count, "fu": seg.fu,
                             "dep": seg.dep_scalar})
        elif isinstance(seg, RawRecords):
            self._flush()
            for rec in seg.records:
                self.ops.append({"op": "raw", "rec": dict(rec)})
        elif isinstance(seg, KernelBody):
            self._kernel_body(seg)
        else:
            raise FrontendError(f"unknown segment type {type(seg).__name__}")

    def _kernel_body(self, seg: KernelBody):
        vals = []
        for s in seg.ins:
            if isinstance(s, Stream):
                t = self.tok()
                self.stream_of_tok[t] = s
                op = {"op": "load", "vl": seg.vl, "stream": s, "out": t,
                      "idx": None}
                if seg.lazy_loads:
                    self._lazy[t] = op
                else:
                    self.emit(op)
                vals.append(_Val("vec", t))
            else:
                if s not in self.env:
                    raise FrontendError(f"segment input {s!r} not produced "
                                        "by an earlier segment")
                vals.append(_Val("vec", self.env[s]))
        graph = _trace(seg.fn, len(vals), seg.vl)
        placeholders = [n for n in graph.nodes if n.op == "placeholder"]
        valmap = dict(zip(placeholders, vals))
        self.walk(graph, valmap)
        out_node = next(n for n in graph.nodes if n.op == "output")
        ret = out_node.args[0]
        ret = list(ret) if isinstance(ret, (list, tuple)) else [ret]
        outvals = [self._resolve(v, valmap) for v in ret]
        # any block not yet fetched is still loaded (block-spec semantics)
        for t in list(self._lazy):
            self.emit(self._lazy.pop(t))
        if seg.outs and len(seg.outs) > len(outvals):
            raise FrontendError(
                f"{len(seg.outs)} outs declared, fn returned {len(outvals)}")
        for spec, val in zip(seg.outs, outvals):
            if spec is None:
                continue
            if isinstance(spec, Stream):
                if val.kind != "vec":
                    raise FrontendError(
                        f"store {spec.name!r} needs a vector value")
                elems = next((o.get("vl") for o in reversed(self.ops)
                              if o.get("out") == val.tok), seg.vl)
                self.emit({"op": "store", "vl": elems, "stream": spec,
                           "src": self.use(val)})
            else:
                if val.kind != "vec":
                    raise FrontendError(
                        f"named out {spec!r} needs a vector value")
                self.env[spec] = val.tok
        self._flush()


# --------------------------------------------------------------------------
# phase 2: live-range register allocation + record emission
# --------------------------------------------------------------------------

def _op_uses(op: dict) -> list[int]:
    if op["op"] == "arith":
        return list(op["srcs"])
    if op["op"] in ("slide", "reduce", "mask"):
        return [op["src"]] if op["src"] is not None else []
    if op["op"] == "load":
        return [op["idx"]] if op.get("idx") is not None else []
    if op["op"] == "store":
        return [op["src"]]
    return []


@dataclass
class Lowered:
    """A lowered chunk: the trace plus the allocator's pressure figures."""
    trace: isa.Trace
    max_live: int        # peak simultaneously-live logical registers
    regs_used: int       # distinct registers touched (cf. isa.trace_registers)


def _needs_idx_reg(op: dict) -> bool:
    """Does this vop carry an indexed stream access with no explicit index
    vector?  Real RVV spells these ``vluxei*``/``vsuxei*``, whose index
    vector is an architectural register source — the lowered trace reserves
    the top register for it so the decoded assembly round-trips bitwise."""
    if op["op"] == "load":
        return (op["stream"].pattern == isa.MEM_INDEXED
                and op.get("idx") is None)
    if op["op"] == "store":
        return op["stream"].pattern == isa.MEM_INDEXED
    return False


def lower(segments, n_regs: int = N_LOGICAL_REGS) -> Lowered:
    """Lower a kernel spec (list of segments) to a trace.

    Registers are assigned by live range: a linear scan over the vop list
    allocates the lowest free register at each definition and frees it after
    the value's last use; exceeding ``n_regs`` simultaneously-live values is
    a :class:`FrontendError` (the spec must spill explicitly, as canneal's
    ``RawRecords`` moves do).

    Indexed stream accesses (``MEM_INDEXED`` loads without an explicit
    gather index, and every indexed store) consume an implicit index vector:
    the allocator reserves the highest register (``n_regs - 1``) for it and
    records it as a source operand — exactly what ``vluxei64.v``/
    ``vsuxei64.v`` decode to, so the RVV round trip is bitwise.
    """
    w = _Walker()
    for seg in segments:
        w.segment(seg)
    w._flush()
    ops = w.ops

    last: dict[int, int] = {}
    for i, op in enumerate(ops):
        for t in _op_uses(op):
            last[t] = i

    idx_reg = n_regs - 1 if any(_needs_idx_reg(op) for op in ops) else -1
    free = [r for r in range(n_regs) if r != idx_reg]
    heapq.heapify(free)
    reg: dict[int, int] = {}
    max_live = 0
    used: set[int] = set()
    if idx_reg >= 0:
        used.add(idx_reg)
    b = isa.TraceBuilder()
    for i, op in enumerate(ops):
        sregs = []
        for t in _op_uses(op):
            if t not in reg:
                raise FrontendError("value used before definition")
            sregs.append(reg[t])
        for t in set(_op_uses(op)):
            if last[t] == i:
                heapq.heappush(free, reg.pop(t))
        dreg = -1
        t = op.get("out")
        if t is not None:
            if not free:
                raise FrontendError(
                    f"register pressure exceeds {n_regs} logical registers")
            dreg = heapq.heappop(free)
            reg[t] = dreg
            used.add(dreg)
            max_live = max(max_live, n_regs - len(free))
            if last.get(t, -1) <= i:        # dead value: reg recycles
                heapq.heappush(free, reg.pop(t))
        _emit_record(b, op, sregs, dreg, idx_reg)
    return Lowered(b.build(), max_live, len(used))


def _emit_record(b: isa.TraceBuilder, op: dict, sregs: list, dreg: int,
                 idx_reg: int = -1):
    kind = op["op"]
    if kind == "scalar":
        b.scalar(op["count"], fu=op["fu"], dep_scalar=op["dep"])
    elif kind == "raw":
        b.raw(op["rec"])
    elif kind == "load":
        s = op["stream"]
        rec = isa.vload(op["vl"], dst=dreg, pattern=s.pattern,
                        footprint_kb=s.footprint_kb)
        if sregs:                            # gather: consumes an index vector
            rec.update(n_src=1, src1=sregs[0])
        elif s.pattern == isa.MEM_INDEXED:   # implicit vluxei* index vector
            rec.update(n_src=1, src1=idx_reg)
        b.raw(rec)
    elif kind == "store":
        s = op["stream"]
        rec = isa.vstore(op["vl"], src1=sregs[0], pattern=s.pattern,
                         footprint_kb=s.footprint_kb)
        if s.pattern == isa.MEM_INDEXED:     # implicit vsuxei* index vector
            rec.update(n_src=2, src2=idx_reg)
        b.raw(rec)
    elif kind == "arith":
        b.arith(op["vl"], fu=op["fu"], n_src=op["n_src"],
                src1=sregs[0] if sregs else -1,
                src2=sregs[1] if len(sregs) > 1 else -1, dst=dreg)
    elif kind == "slide":
        b.slide(op["vl"], src1=sregs[0] if sregs else -1, dst=dreg)
    elif kind == "reduce":
        b.reduce(op["vl"], src1=sregs[0] if sregs else -1, dst=dreg,
                 fu=op["fu"])
    elif kind == "mask":
        b.mask_to_scalar(op["vl"], src1=sregs[0] if sregs else -1)
    else:  # pragma: no cover
        raise FrontendError(f"unknown vop {kind!r}")


def lower_trace(segments, n_regs: int = N_LOGICAL_REGS) -> isa.Trace:
    return lower(segments, n_regs=n_regs).trace


# --------------------------------------------------------------------------
# derived bodies + cross-validation against the hand-coded frontend
# --------------------------------------------------------------------------

_DERIVED_CACHE: dict = {}


def derived_body(app_name: str, mvl: int, cfg=None) -> Lowered:
    """Lower ``APPS[app_name].kernel(mvl, cfg)`` (cached, like body_for)."""
    from repro_torch.core import tracegen
    key = (app_name, mvl, cfg)
    out = _DERIVED_CACHE.get(key)
    if out is None:
        spec = tracegen.APPS[app_name].kernel
        if spec is None:
            raise FrontendError(f"{app_name} has no kernel= spec")
        out = _DERIVED_CACHE[key] = lower(spec(mvl, cfg))
    return out


def trace_mix(trace: isa.Trace) -> dict:
    """FU-class fractions of a trace's VARITH instructions (an App.mix)."""
    fus = trace.fu[trace.kind == isa.VARITH]
    n = max(len(fus), 1)
    names = {_S: "simple", _M: "mul", _D: "div", _T: "trans"}
    return {names[c]: float(np.sum(fus == c)) / n for c in names}


CrossValReport = crossval.CrossValReport


def cross_validate_all(apps=None, cfgs=None,
                       device=None) -> list[CrossValReport]:
    """Derived-vs-hand-coded contract for every app with both frontends;
    the timing comparison for every (app, cfg) pair runs as one batch."""
    from repro_torch.core import engine as eng
    from repro_torch.core import tracegen
    if apps is None:
        apps = list(tracegen.RIVEC_APPS)
    if cfgs is None:
        cfgs = [eng.VectorEngineConfig(mvl=64, lanes=4),
                eng.VectorEngineConfig(mvl=16, lanes=2)]

    def derive(app, eff, cfg):
        low = derived_body(app, eff, cfg)
        return low.trace, low.regs_used, low.max_live

    return crossval.cross_validate(derive, apps, cfgs, device=device)


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.core.frontend",
        description="Cross-validate the torch.fx lowering of every RiVec "
                    "kernel= spec against its hand-coded body.")
    ap.add_argument("--device", default=None,
                    help="engine device (default: the CUDA device; 'cpu' "
                         "runs the plain PyTorch scan)")
    args = ap.parse_args(argv)
    ok = crossval.print_reports(cross_validate_all(device=args.device),
                                "frontend cross-validation")
    return 0 if ok else 1


if __name__ == "__main__":
    # delegate to the canonical module object: specs built by tracegen carry
    # repro_torch.core.frontend segment classes, not __main__ ones
    from repro_torch.core import frontend as _canonical
    raise SystemExit(_canonical.main())
