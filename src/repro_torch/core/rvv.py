"""RVV v1.0 assembly frontend: decode RISC-V Vector streams into vector IR.

The suite's third trace source, next to the hand-coded ``tracegen`` bodies
and the torch.fx frontend (``core.frontend``): a parser/decoder for RVV
v1.0 assembly text (GNU ``as`` syntax, as emitted by ``gcc -S`` or written
by hand) that lowers an instruction stream to an ``isa.Trace`` — the layer
that lets the simulator consume kernels the way the RiVec suite itself
ships, as RVV assembly.

The decoder is a small *abstract interpreter* over the instruction stream:

* **``vsetvli``/``vsetivli`` are executed**, not pattern-matched:
  ``VL = min(AVL, VLMAX)`` with ``VLMAX = VLEN/SEW * LMUL`` (``VLEN`` is the
  configured ``mvl`` in 64-bit elements), so the same ``.s`` file decodes
  to the right vector lengths at any hardware MVL.
* **Scalar registers carry abstract values** (known constants, ``la``
  symbols, or unknown).  Instructions that produce a *known* value —
  ``li``/``la``, induction updates, pointer bumps, trip counters — are
  loop/address bookkeeping: the abstract machine folds them away, because
  the characterized per-chunk scalar blocks in a kernel carry that overhead
  explicitly (as ``.rept`` filler on registers the machine cannot track).
  Scalar instructions over *unknown* values are the modeled scalar work:
  consecutive ones coalesce into ``SCALAR_BLOCK`` entries, and a block that
  reads a register written by ``vcpop.m``/``vfirst.m``/``vfmv.f.s`` (a
  vector-engine scalar result) is marked ``dep_scalar`` — the §4.1.4 stall.
* **Branches on known values are executed**, which is what expands a
  strip-mine loop: ``vsetvli t0, a0 … sub a0, a0, t0; bgtz a0, loop`` runs
  once per chunk with the exact per-iteration VL.  A loop whose head is
  marked with the ``.chunk`` directive is recognized as the kernel's
  steady-state chunk loop: its body is emitted once and the trip count
  (``ceil(AVL/VL)`` for strip-mine, the counter value for counted loops) is
  returned as the app's fractional chunk count instead of expanding
  millions of iterations.
* **Register usage is validated** against the 32-register file with LMUL
  register-group aliasing (a group's base must be LMUL-aligned and the
  whole group in range; reads require every physical register of the group
  to have been written).  ``isa.validate_trace`` re-checks the emitted
  trace independently (the fuzz tier in ``tests/test_rvv.py`` gates it).

Instruction-family → IR mapping (``docs/architecture.md`` has the table):

====================================  =====================================
RVV assembly                          vector IR
====================================  =====================================
``vle{8,16,32,64}.v`` / ``vse*.v``    ``VLOAD``/``VSTORE`` @ ``MEM_UNIT``
``vlse*.v`` / ``vsse*.v``             ``MEM_STRIDED``
``vluxei*/vloxei*/vsuxei*/vsoxei*``   ``MEM_INDEXED`` (index vector is a
                                      register source)
``vadd/vsub/vmin/vmax/vmseq/…``       ``VARITH`` @ ``FU_SIMPLE``
``vmul/vfmul/vfmacc/vmacc/…``         ``VARITH`` @ ``FU_MUL``
``vdiv/vfdiv/vfsqrt/vfrec7/…``        ``VARITH`` @ ``FU_DIV``
``vfexp/vflog/vfpow/… .v(v)``         ``VARITH`` @ ``FU_TRANS`` (pseudo-
                                      calls: vendor vector-libm lowering)
``vredsum/vfredosum/vfredusum/…``     ``VREDUCE``
``vslide1up/down``, ``vslideup/…``,   ``VSLIDE`` (lane interconnect)
``vrgather``, ``vcompress``
``vfirst.m`` / ``vcpop.m/vpopc.m``    ``VMASK_SCALAR`` (dest scalar reg
                                      becomes *hot*)
``vmv.v.*``, ``vmv<n>r.v``            ``VMOVE`` (whole-register moves run
                                      at ``n × VLEN/SEW`` elements
                                      regardless of VL — §4.1.2 spills)
``vmv.x.s`` / ``vfmv.f.s``            free transfer, dest scalar is hot
masking (trailing ``v0.t``)           one extra VRF read (``n_src += 1``)
scalar instructions                   coalesced ``SCALAR_BLOCK``
====================================  =====================================

Memory footprints come from ``.stream`` directives (``.stream name expr``,
where ``expr`` may reference ``vl``): a load/store whose address register
was ``la``-bound to a stream symbol carries that stream's working-set
footprint into the analytic memory model.  Approximations are documented
inline: the IR has two register-dependency slots, so FMAs keep the vector
multiplicand + accumulator; reductions keep the vector operand.

``asm_body``/``asm_chunks`` expose the per-app corpus
(``src/repro_torch/asm/*.s``) as a trace source cross-validated against the
hand-coded bodies (``cross_validate_all``; ``python -m
repro_torch.core.rvv --check-all`` runs the gate); ``python -m
repro_torch.core.rvv kernel.s`` decodes and simulates an arbitrary kernel.

The port of ``repro/core/rvv.py``, pure Python and unchanged in what it
decodes; the corpus is the port's own copy under ``src/repro_torch/asm``
(``tests/test_torch_rvv.py`` holds it byte-equal to the reference's).
"""
from __future__ import annotations

import ast
import os
import re
from dataclasses import dataclass

from repro_torch.core import crossval, isa


class RvvError(Exception):
    """The stream uses a construct the decoder can't map (loud, like
    ``frontend.FrontendError``) or is ill-formed RVV."""


MAX_STEPS = 500_000   # abstract-interpreter fuel (per decode)

_S, _M, _D, _T = isa.FU_SIMPLE, isa.FU_MUL, isa.FU_DIV, isa.FU_TRANS

# --------------------------------------------------------------------------
# register names
# --------------------------------------------------------------------------

_X_ABI = ("zero ra sp gp tp t0 t1 t2 s0 s1 a0 a1 a2 a3 a4 a5 a6 a7 "
          "s2 s3 s4 s5 s6 s7 s8 s9 s10 s11 t3 t4 t5 t6").split()
_XREGS = {f"x{i}": i for i in range(32)}
_XREGS.update({n: i for i, n in enumerate(_X_ABI)})
_XREGS["fp"] = 8
_F_ABI = ("ft0 ft1 ft2 ft3 ft4 ft5 ft6 ft7 fs0 fs1 fa0 fa1 fa2 fa3 fa4 fa5 "
          "fa6 fa7 fs2 fs3 fs4 fs5 fs6 fs7 fs8 fs9 fs10 fs11 ft8 ft9 ft10 "
          "ft11").split()
_FREGS = {f"f{i}": i for i in range(32)}
_FREGS.update({n: i for i, n in enumerate(_F_ABI)})


def _xreg(tok: str):
    return _XREGS.get(tok)


def _freg(tok: str):
    return _FREGS.get(tok)


_VREG_RE = re.compile(r"^v([0-9]|[12][0-9]|3[01])$")


def _vreg(tok: str):
    m = _VREG_RE.match(tok)
    return int(m.group(1)) if m else None


def _imm(tok: str):
    try:
        return int(tok, 0)
    except ValueError:
        return None


_ADDR_RE = re.compile(r"^(-?\w*)\((\w+)\)$")

# --------------------------------------------------------------------------
# instruction classification tables
# --------------------------------------------------------------------------

VARITH_FU = {
    # simple: add/sub/logic/compare/min/max/merge/mask-logic
    "vadd": _S, "vsub": _S, "vrsub": _S, "vand": _S, "vor": _S, "vxor": _S,
    "vmin": _S, "vminu": _S, "vmax": _S, "vmaxu": _S, "vsll": _S,
    "vsrl": _S, "vsra": _S, "vmseq": _S, "vmsne": _S, "vmslt": _S,
    "vmsltu": _S, "vmsle": _S, "vmsleu": _S, "vmsgt": _S, "vmsgtu": _S,
    "vmsge": _S, "vmsgeu": _S, "vfadd": _S, "vfsub": _S, "vfrsub": _S,
    "vfmin": _S, "vfmax": _S, "vfabs": _S, "vfneg": _S, "vfsgnj": _S,
    "vfsgnjn": _S, "vfsgnjx": _S, "vmfeq": _S, "vmfne": _S, "vmflt": _S,
    "vmfle": _S, "vmfgt": _S, "vmfge": _S, "vmerge": _S, "vfmerge": _S,
    "vfclass": _S, "vid": _S, "viota": _S, "vmand": _S, "vmor": _S,
    "vmxor": _S, "vmnand": _S, "vmnor": _S, "vmxnor": _S, "vmandn": _S,
    "vmorn": _S, "vmnot": _S, "vmset": _S, "vmclr": _S, "vmmv": _S,
    # mul / fma
    "vmul": _M, "vmulh": _M, "vmulhu": _M, "vmulhsu": _M, "vfmul": _M,
    "vmacc": _M, "vnmsac": _M, "vmadd": _M, "vnmsub": _M, "vfmacc": _M,
    "vfnmacc": _M, "vfmsac": _M, "vfnmsac": _M, "vfmadd": _M,
    "vfnmadd": _M, "vfmsub": _M, "vfnmsub": _M,
    # div / sqrt
    "vdiv": _D, "vdivu": _D, "vrem": _D, "vremu": _D, "vfdiv": _D,
    "vfrdiv": _D, "vfsqrt": _D, "vfrsqrt7": _D, "vfrec7": _D,
    # transcendental pseudo-calls (vendor vector-libm lowering; RVV has no
    # hardware transcendentals — these stand for the intrinsic call sites)
    "vfexp": _T, "vflog": _T, "vfsin": _T, "vfcos": _T, "vftan": _T,
    "vfpow": _T, "vftanh": _T, "vferf": _T,
}

# FMA group: reads the accumulator vd in addition to its operands
FMA_MNEMOS = frozenset(
    "vmacc vnmsac vmadd vnmsub vfmacc vfnmacc vfmsac vfnmsac vfmadd "
    "vfnmadd vfmsub vfnmsub".split())

# mask-register operands are always a single v-register regardless of LMUL
# (RVV v1.0 §4.5/§15): comparisons write one, mask-logical ops read and
# write one, viota.m reads one
CMP_MNEMOS = frozenset(
    "vmseq vmsne vmslt vmsltu vmsle vmsleu vmsgt vmsgtu vmsge vmsgeu "
    "vmfeq vmfne vmflt vmfle vmfgt vmfge".split())
MASK_LOGICAL_MNEMOS = frozenset(
    "vmand vmor vmxor vmnand vmnor vmxnor vmandn vmorn vmnot vmset vmclr "
    "vmmv".split())

REDUCE_MNEMOS = frozenset(
    "vredsum vredmax vredmaxu vredmin vredminu vredand vredor vredxor "
    "vfredosum vfredusum vfredsum vfredmax vfredmin".split())

SLIDE_MNEMOS = frozenset(
    "vslideup vslidedown vslide1up vslide1down vfslide1up vfslide1down "
    "vrgather vrgatherei16 vcompress".split())

MASK_SCALAR_MNEMOS = frozenset(("vfirst", "vcpop", "vpopc"))

# vle64 / vse8: unit-stride; vlse/vsse: strided; vluxei/vloxei (+ store
# forms): indexed — exactly the three patterns the IR distinguishes
_MEM_RE = re.compile(r"^v([ls])(s|[uo]x)?ei?(8|16|32|64)$")
_MEM_PATTERN = {None: isa.MEM_UNIT, "s": isa.MEM_STRIDED,
                "ux": isa.MEM_INDEXED, "ox": isa.MEM_INDEXED}

# scalar mnemonics the abstract machine understands (3-operand ALU, 2-op
# immediates, moves, loads/stores, branches); anything else scalar-looking
# is rejected loudly
_SC_ALU3 = frozenset(
    "add sub mul mulh mulhu mulhsu mulw div divu rem remu and or xor sll "
    "srl sra slt sltu addw subw sllw srlw sraw sh1add sh2add sh3add min "
    "max minu maxu".split())
_SC_ALUI = frozenset(
    "addi andi ori xori slli srli srai slti sltiu addiw slliw srliw "
    "sraiw".split())
_SC_UNARY = frozenset("mv neg not seqz snez sltz sgtz sext.w zext.b "
                      "zext.h zext.w".split())
_SC_LOAD = frozenset("lb lh lw ld lbu lhu lwu".split())
_SC_STORE = frozenset("sb sh sw sd".split())
_SC_FLOAD = frozenset(("flw", "fld"))
_SC_FSTORE = frozenset(("fsw", "fsd"))
_BRANCH2 = frozenset("beq bne blt bge bltu bgeu bgt ble bgtu bleu".split())
_BRANCH1 = frozenset("beqz bnez blez bgez bltz bgtz".split())

# immediate/word ALU forms -> base op (for abstract evaluation)
_ALUI_BASE = {"addi": "add", "andi": "and", "ori": "or", "xori": "xor",
              "slli": "sll", "srli": "srl", "srai": "sra", "slti": "slt",
              "sltiu": "sltu", "addiw": "addw", "slliw": "sllw",
              "srliw": "srlw", "sraiw": "sraw"}

_SC_FU = {"mul": _M, "mulh": _M, "mulhu": _M, "mulhsu": _M, "mulw": _M,
          "div": _D, "divu": _D, "rem": _D, "remu": _D}
_F_FU = {"fmul": _M, "fmadd": _M, "fmsub": _M, "fnmadd": _M, "fnmsub": _M,
         "fdiv": _D, "fsqrt": _D}

# --------------------------------------------------------------------------
# parsing
# --------------------------------------------------------------------------


@dataclass
class _Stmt:
    mnemo: str
    ops: list
    line: int
    text: str


@dataclass
class _Program:
    stmts: list
    labels: dict            # name -> stmt index
    streams: dict           # name -> footprint expression (may use `vl`)
    chunk_ip: int | None    # stmt index the `.chunk` directive marks


def _safe_eval(expr: str, vl: int) -> float:
    """Evaluate a `.stream` footprint expression (numbers, `vl`, + - * / and
    parentheses only)."""
    def ev2(node):
        if isinstance(node, ast.Expression):
            return ev2(node.body)
        if isinstance(node, ast.Constant) and isinstance(node.value,
                                                         (int, float)):
            return node.value
        if isinstance(node, ast.Name) and node.id == "vl":
            return vl
        if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub):
            return -ev2(node.operand)
        if isinstance(node, ast.BinOp):
            a, b = ev2(node.left), ev2(node.right)
            if isinstance(node.op, ast.Add):
                return a + b
            if isinstance(node.op, ast.Sub):
                return a - b
            if isinstance(node.op, ast.Mult):
                return a * b
            if isinstance(node.op, ast.Div):
                return a / b
        raise RvvError(f"unsupported term in stream expression {expr!r}")
    try:
        return float(ev2(ast.parse(expr, mode="eval")))
    except RvvError:
        raise
    except Exception as e:
        raise RvvError(f"bad stream expression {expr!r}: {e}") from None


def parse(text: str) -> _Program:
    """Assemble the text into statements, resolving labels, ``.stream``
    declarations, ``.rept``/``.endr`` expansion and the ``.chunk`` marker."""
    stmts: list[_Stmt] = []
    labels: dict[str, int] = {}
    streams: dict[str, str] = {}
    chunk_ip = None
    rept: list[tuple[int, list]] = []   # (count, collected raw lines) stack

    def add_line(raw: str, lineno: int):
        nonlocal chunk_ip
        line = raw.split("#", 1)[0].strip()
        if not line:
            return
        while True:                      # peel leading labels
            m = re.match(r"^([A-Za-z_.$][\w.$]*):\s*(.*)$", line)
            if not m:
                break
            labels[m.group(1)] = len(stmts)
            line = m.group(2).strip()
            if not line:
                return
        if line.startswith("."):
            parts = line.split()
            d = parts[0]
            if d == ".stream":
                if len(parts) < 3:
                    raise RvvError(f"line {lineno}: .stream needs "
                                   "<name> <footprint_kb expr>")
                streams[parts[1]] = "".join(parts[2:])
            elif d == ".chunk":
                if chunk_ip is not None:
                    raise RvvError(f"line {lineno}: duplicate .chunk")
                chunk_ip = len(stmts)
            elif d in (".rept", ".endr"):
                raise RvvError(f"line {lineno}: unbalanced {d}")
            # all other directives (.text/.globl/.align/...) are layout-only
            return
        mnemo, _, rest = line.partition(" ")
        ops = [o.strip() for o in rest.split(",")] if rest.strip() else []
        stmts.append(_Stmt(mnemo.strip(), ops, lineno, line))

    def feed(raw: str, lineno: int):
        stripped = raw.split("#", 1)[0].strip()
        if stripped.startswith(".rept"):
            n = _imm(stripped.split()[1]) if len(stripped.split()) > 1 else None
            if n is None or n < 0:
                raise RvvError(f"line {lineno}: bad .rept count")
            rept.append((n, []))
            return
        if stripped == ".endr":
            if not rept:
                raise RvvError(f"line {lineno}: .endr without .rept")
            n, body = rept.pop()
            for _ in range(n):
                for b_raw, b_no in body:
                    feed_expanded(b_raw, b_no)
            return
        if rept:
            rept[-1][1].append((raw, lineno))
            return
        add_line(raw, lineno)

    def feed_expanded(raw: str, lineno: int):
        # bodies of .rept may not define labels or nest further .rept
        stripped = raw.split("#", 1)[0].strip()
        if stripped.startswith(".rept") or stripped == ".endr" \
                or re.match(r"^[A-Za-z_.$][\w.$]*:", stripped):
            raise RvvError(f"line {lineno}: labels/.rept inside .rept body")
        add_line(raw, lineno)

    for i, raw in enumerate(text.splitlines(), start=1):
        feed(raw, i)
    if rept:
        raise RvvError(".rept without matching .endr")
    # a chunk marker at the very end of the file marks nothing
    if chunk_ip is not None and chunk_ip >= len(stmts):
        raise RvvError(".chunk marks no instruction")
    return _Program(stmts, labels, streams, chunk_ip)


# --------------------------------------------------------------------------
# the decoded result
# --------------------------------------------------------------------------

@dataclass
class Decoded:
    """One decoded kernel: the steady-state chunk body, its trip count, and
    the prologue (setup before the ``.chunk`` marker — register window
    initialization, stream binding; excluded from the body so chunk tiling
    matches the hand-coded bodies' steady-state semantics)."""
    trace: isa.Trace
    chunks: float
    prologue: isa.Trace
    vlmax: int
    whole_reg_elems: int
    prologue_defs: frozenset
    mnemonics: dict
    vl_cap: int = 0       # largest legal element count the stream could
                          # produce (VLMAX over executed vtypes, plus
                          # whole-register moves, which scale with 64/SEW)
    path: str = ""

    @property
    def full_trace(self) -> isa.Trace:
        return self.prologue.concat(self.trace)

    def validate(self, mvl: int | None = None) -> list[str]:
        """``isa.validate_trace`` over the body, with prologue defs live."""
        if mvl is None:
            mvl = max(self.vl_cap, self.vlmax, self.whole_reg_elems)
        return isa.validate_trace(self.trace, mvl,
                                  predefined=self.prologue_defs)


# --------------------------------------------------------------------------
# the abstract machine
# --------------------------------------------------------------------------

_UNKNOWN = None


class _Machine:
    def __init__(self, prog: _Program, vlmax: int, whole_reg: int,
                 expand: bool, avl: int | None):
        self.prog = prog
        self.vlen_bits = vlmax * 64          # hardware VLEN
        self.whole_reg = whole_reg           # elements per whole-reg move
        self.expand = expand
        self.x: list = [_UNKNOWN] * 32       # known ints / ('sym', s, off)
        self.x[0] = 0
        self.f: list = [_UNKNOWN] * 32
        self.hot_x: set[int] = set()
        self.hot_f: set[int] = set()
        self.vdef: set[int] = set()
        self.sew = 64
        self.lmul_num, self.lmul_den = 1, 1
        self.vl: int | None = None           # no vsetvli executed yet
        self.recs: list[dict] = []
        self._pend: dict | None = None
        self.mnemonics: dict[str, int] = {}
        self.chunks = 1.0
        self.vl_cap = 0
        self.prologue_len = 0
        self.prologue_defs: frozenset = frozenset()
        self.in_chunk = False
        self.chunk_done = False
        self.chunk_snap: list | None = None
        if avl is not None:
            self.x[_XREGS["a0"]] = int(avl)

    # ---- record emission ---------------------------------------------------
    def _flush(self):
        if self._pend is not None:
            self.recs.append(isa.scalar_block(self._pend["count"],
                                              fu=self._pend["fu"],
                                              dep_scalar=self._pend["dep"]))
            self._pend = None

    def emit_scalar(self, fu: int, dep: bool):
        if self._pend is not None and self._pend["fu"] != fu:
            self._flush()
        if self._pend is None:
            self._pend = {"count": 0, "fu": fu, "dep": False}
        self._pend["count"] += 1
        self._pend["dep"] |= dep

    def emit(self, rec: dict):
        self._flush()
        self.recs.append(rec)

    # ---- vector-register group bookkeeping ---------------------------------
    def _group(self, base: int, st: _Stmt, nregs: int | None = None) -> range:
        n = nregs if nregs is not None else max(self.lmul_num, 1)
        if self.lmul_den == 1 and n > 1 and base % n:
            raise RvvError(f"line {st.line}: v{base} is not aligned to the "
                           f"LMUL={n} register group ({st.text!r})")
        if base + n > 32:
            raise RvvError(f"line {st.line}: register group v{base}..v"
                           f"{base + n - 1} exceeds the 32-register file "
                           f"({st.text!r})")
        return range(base, base + n)

    def vread(self, base: int, st: _Stmt, nregs: int | None = None):
        for r in self._group(base, st, nregs):
            if r not in self.vdef:
                raise RvvError(f"line {st.line}: v{r} read before any write "
                               f"({st.text!r})")

    def vwrite(self, base: int, st: _Stmt, nregs: int | None = None):
        self.vdef.update(self._group(base, st, nregs))

    def need_vl(self, st: _Stmt) -> int:
        if self.vl is None:
            raise RvvError(f"line {st.line}: vector instruction before any "
                           f"vsetvli ({st.text!r})")
        return self.vl

    # ---- operand helpers ---------------------------------------------------
    def xval(self, tok: str, st: _Stmt):
        r = _xreg(tok)
        if r is None:
            raise RvvError(f"line {st.line}: expected scalar register, got "
                           f"{tok!r} ({st.text!r})")
        return self.x[r]

    def stream_of(self, addr_tok: str, st: _Stmt):
        """Footprint (KB) of the stream an address register is bound to."""
        m = _ADDR_RE.match(addr_tok)
        if not m or _xreg(m.group(2)) is None:
            raise RvvError(f"line {st.line}: expected address operand like "
                           f"(a0), got {addr_tok!r}")
        v = self.x[_xreg(m.group(2))]
        if isinstance(v, tuple) and v[0] == "sym" \
                and v[1] in self.prog.streams:
            return _safe_eval(self.prog.streams[v[1]], self.need_vl(st))
        return 64.0   # unbound address: the frontend's default footprint

    # ---- vsetvli ----------------------------------------------------------
    def _vtype(self, toks: list, st: _Stmt):
        for t in toks:
            t = t.strip()
            if re.match(r"^e(8|16|32|64)$", t):
                self.sew = int(t[1:])
            elif re.match(r"^m[1248]$", t):
                self.lmul_num, self.lmul_den = int(t[1:]), 1
            elif re.match(r"^mf[248]$", t):
                self.lmul_num, self.lmul_den = 1, int(t[2:])
            elif t in ("ta", "tu", "ma", "mu"):
                pass
            else:
                raise RvvError(f"line {st.line}: bad vtype token {t!r}")

    def vlmax(self) -> int:
        return max((self.vlen_bits // self.sew) * self.lmul_num
                   // self.lmul_den, 1)

    def do_vset(self, st: _Stmt):
        if st.mnemo == "vsetvl":
            raise RvvError(f"line {st.line}: vsetvl (vtype from register) "
                           "is not decodable; use vsetvli/vsetivli")
        if len(st.ops) < 3:
            raise RvvError(f"line {st.line}: {st.mnemo} needs rd, avl, vtype")
        rd = _xreg(st.ops[0])
        if rd is None:
            raise RvvError(f"line {st.line}: bad rd {st.ops[0]!r}")
        self._vtype(st.ops[2:], st)
        if st.mnemo == "vsetivli":
            avl = _imm(st.ops[1])
            if avl is None:
                raise RvvError(f"line {st.line}: vsetivli needs an "
                               "immediate AVL")
        else:
            rs1 = _xreg(st.ops[1])
            if rs1 is None:
                raise RvvError(f"line {st.line}: bad AVL register "
                               f"{st.ops[1]!r}")
            if rs1 == 0:
                # vsetvli rd, x0: VLMAX request (rd!=x0) / vtype-only change
                avl = self.vlmax() if rd != 0 else (self.vl or self.vlmax())
            else:
                avl = self.x[rs1]
                if not isinstance(avl, int):
                    raise RvvError(
                        f"line {st.line}: AVL register {st.ops[1]} has no "
                        "known value — initialize it (li) or pass --avl")
        self.vl = min(avl, self.vlmax())
        self.vl_cap = max(self.vl_cap, self.vlmax())
        if rd != 0:
            self.x[rd] = self.vl
            self.hot_x.discard(rd)

    # ---- vector instructions ----------------------------------------------
    def _mask_suffix(self, ops: list, st: _Stmt,
                     bare_v0: bool = False) -> tuple[list, int]:
        """Strip a trailing ``v0.t`` mask operand (one extra VRF read).
        ``bare_v0`` additionally strips a trailing bare ``v0`` — only the
        vmerge/vadc family spells its always-on mask that way."""
        last = ops[-1] if ops else ""
        if len(ops) > 1 and (last == "v0.t" or (bare_v0 and last == "v0")):
            self.vread(0, st, nregs=1)
            return ops[:-1], 1
        return ops, 0

    def do_vector(self, st: _Stmt) -> bool:
        """Decode one vector instruction; returns False if ``st`` is not a
        vector instruction."""
        mnemo = st.mnemo
        if "." not in mnemo:
            return False
        base, suffix = mnemo.split(".", 1)
        if not base.startswith("v"):
            return False
        vl = None

        # ---- memory -------------------------------------------------------
        m = _MEM_RE.match(base)
        if m and suffix == "v":
            vl = self.need_vl(st)
            is_load = m.group(1) == "l"
            pattern = _MEM_PATTERN[m.group(2)]
            ops, extra = self._mask_suffix(st.ops, st)
            if len(ops) < 2:
                raise RvvError(f"line {st.line}: {mnemo} needs vd, (rs1)")
            vd = _vreg(ops[0])
            if vd is None:
                raise RvvError(f"line {st.line}: bad vector register "
                               f"{ops[0]!r}")
            fp = self.stream_of(ops[1], st)
            idx = None
            if pattern == isa.MEM_INDEXED:
                if len(ops) < 3 or _vreg(ops[2]) is None:
                    raise RvvError(f"line {st.line}: {mnemo} needs an index "
                                   "vector operand")
                idx = _vreg(ops[2])
                self.vread(idx, st)
            elif pattern == isa.MEM_STRIDED:
                if len(ops) < 3 or _xreg(ops[2]) is None:
                    raise RvvError(f"line {st.line}: {mnemo} needs a stride "
                                   "register operand")
            if is_load:
                rec = isa.vload(vl, dst=vd, pattern=pattern, footprint_kb=fp)
                if idx is not None:
                    rec.update(n_src=1 + extra, src1=idx)
                elif extra:
                    rec.update(n_src=extra)
                self.vwrite(vd, st)
            else:
                self.vread(vd, st)
                rec = isa.vstore(vl, src1=vd, pattern=pattern,
                                 footprint_kb=fp)
                rec.update(n_src=1 + extra + (1 if idx is not None else 0))
                if idx is not None:
                    rec.update(src2=idx)
            self.emit(rec)
            return True

        # ---- vset ---------------------------------------------------------
        if base in ("vsetvli", "vsetivli", "vsetvl"):
            return False    # handled by the caller (no '.' in mnemonic)

        # ---- whole-register moves ----------------------------------------
        wm = re.match(r"^vmv([1248])r$", base)
        if wm and suffix == "v":
            n = int(wm.group(1))
            vd, vs = _vreg(st.ops[0]), _vreg(st.ops[1])
            if vd is None or vs is None:
                raise RvvError(f"line {st.line}: bad operands ({st.text!r})")
            if vd % n or vs % n:
                raise RvvError(f"line {st.line}: vmv{n}r.v registers must "
                               f"be {n}-aligned")
            self.vread(vs, st, nregs=n)
            self.vwrite(vd, st, nregs=n)
            # whole-register moves ignore VL: n x VLEN/SEW elements (the
            # §4.1.2 full-MVL spill cost)
            elems = n * (self.whole_reg * 64 // self.sew)
            self.vl_cap = max(self.vl_cap, elems)
            self.emit(isa.vmove(elems, src1=vs, dst=vd))
            return True

        # ---- vmv family ---------------------------------------------------
        if base in ("vmv", "vfmv"):
            vl = self.need_vl(st)
            if suffix in ("v.v",):
                vd, vs = _vreg(st.ops[0]), _vreg(st.ops[1])
                self.vread(vs, st)
                self.vwrite(vd, st)
                self.emit(isa.vmove(vl, src1=vs, dst=vd))
            elif suffix in ("v.x", "v.i", "v.f"):
                vd = _vreg(st.ops[0])
                self.vwrite(vd, st)
                rec = isa.vmove(vl, src1=-1, dst=vd)
                rec.update(n_src=0)
                self.emit(rec)
            elif suffix in ("s.x", "s.f"):
                vd = _vreg(st.ops[0])
                self.vwrite(vd, st, nregs=1)
                rec = isa.vmove(1, src1=-1, dst=vd)
                rec.update(n_src=0)
                self.emit(rec)
            elif suffix in ("x.s", "f.s"):
                # element extract to the scalar core: free transfer, but the
                # destination is hot (a dependent scalar block must wait)
                vs = _vreg(st.ops[1])
                self.vread(vs, st, nregs=1)
                if suffix == "x.s":
                    rd = _xreg(st.ops[0])
                    self.x[rd] = _UNKNOWN
                    self.hot_x.add(rd)
                else:
                    rd = _freg(st.ops[0])
                    self.f[rd] = _UNKNOWN
                    self.hot_f.add(rd)
            else:
                raise RvvError(f"line {st.line}: unsupported move "
                               f"{mnemo!r}")
            return True

        # ---- mask -> scalar (vfirst/vcpop) --------------------------------
        if base in MASK_SCALAR_MNEMOS and suffix == "m":
            vl = self.need_vl(st)
            rd, vs = _xreg(st.ops[0]), _vreg(st.ops[1])
            if rd is None or vs is None:
                raise RvvError(f"line {st.line}: {mnemo} needs rd, vs")
            self.vread(vs, st, nregs=1)
            self.emit(isa.vmask_scalar(vl, src1=vs))
            self.x[rd] = _UNKNOWN
            self.hot_x.add(rd)
            return True

        # ---- reductions ---------------------------------------------------
        if base in REDUCE_MNEMOS and suffix == "vs":
            vl = self.need_vl(st)
            ops, _ = self._mask_suffix(st.ops, st)
            vd, vs2, vs1 = (_vreg(ops[0]), _vreg(ops[1]),
                            _vreg(ops[2]) if len(ops) > 2 else None)
            if vd is None or vs2 is None:
                raise RvvError(f"line {st.line}: {mnemo} needs vd, vs2, vs1")
            self.vread(vs2, st)
            if vs1 is not None:
                self.vread(vs1, st, nregs=1)
            self.vwrite(vd, st, nregs=1)
            # IR reductions carry one register dependency: the vector
            # operand (the scalar seed vs1 is almost always loop-invariant)
            self.emit(isa.vreduce(vl, src1=vs2, dst=vd, fu=_S))
            return True

        # ---- slides / register gathers ------------------------------------
        if base in SLIDE_MNEMOS:
            vl = self.need_vl(st)
            ops, extra = self._mask_suffix(st.ops, st)
            vd, vs2 = _vreg(ops[0]), _vreg(ops[1])
            if vd is None or vs2 is None:
                raise RvvError(f"line {st.line}: {mnemo} needs vd, vs2")
            self.vread(vs2, st)
            rec = isa.vslide(vl, src1=vs2, dst=vd)
            vs1 = _vreg(ops[2]) if len(ops) > 2 else None
            if vs1 is not None:          # vrgather.vv / vcompress.vm index
                # vcompress's selector is a mask: one register at any LMUL
                self.vread(vs1, st,
                           nregs=1 if base == "vcompress" else None)
                rec.update(n_src=2 + extra, src2=vs1)
            elif extra:
                rec.update(n_src=1 + extra)
            self.vwrite(vd, st)
            self.emit(rec)
            return True

        # ---- arithmetic ---------------------------------------------------
        if base in VARITH_FU:
            vl = self.need_vl(st)
            fu = VARITH_FU[base]
            ops, extra = self._mask_suffix(
                st.ops, st, bare_v0=suffix in ("vvm", "vxm", "vim"))
            vd = _vreg(ops[0])
            if vd is None:
                raise RvvError(f"line {st.line}: bad destination "
                               f"{ops[0]!r} ({st.text!r})")
            # mask registers are single registers whatever the LMUL
            src_n = 1 if base in MASK_LOGICAL_MNEMOS \
                or base == "viota" else None
            dst_n = 1 if base in MASK_LOGICAL_MNEMOS \
                or base in CMP_MNEMOS else None
            vsrcs = [v for v in (_vreg(o) for o in ops[1:]) if v is not None]
            for v in vsrcs:
                self.vread(v, st, nregs=src_n)
            if base in FMA_MNEMOS:
                # vd is also read (accumulator).  The IR has two dependency
                # slots: keep the (last) vector operand and the accumulator.
                self.vread(vd, st)
                src1 = vsrcs[-1] if vsrcs else -1
                src2 = vd
                n_src = 1 + len(vsrcs) + extra
            else:
                src1 = vsrcs[0] if vsrcs else -1
                src2 = vsrcs[1] if len(vsrcs) > 1 else -1
                n_src = len(vsrcs) + extra
            self.vwrite(vd, st, nregs=dst_n)
            self.emit(isa.varith(vl, fu=fu, n_src=n_src, src1=src1,
                                 src2=src2, dst=vd))
            return True

        if base.startswith("v"):
            raise RvvError(f"line {st.line}: no vector-IR mapping for "
                           f"{mnemo!r} (see rvv.VARITH_FU and friends)")
        return False

    # ---- scalar instructions ----------------------------------------------
    def _sc_read(self, tok: str, st: _Stmt):
        """(value, hot) of a scalar operand (x-reg, f-reg or immediate)."""
        r = _xreg(tok)
        if r is not None:
            return self.x[r], r in self.hot_x
        fr = _freg(tok)
        if fr is not None:
            return self.f[fr], fr in self.hot_f
        v = _imm(tok)
        if v is not None:
            return v, False
        m = _ADDR_RE.match(tok)
        if m is not None and _xreg(m.group(2)) is not None:
            return _UNKNOWN, _xreg(m.group(2)) in self.hot_x
        # anything else (a typo'd register, a %lo() relocation, ...) must
        # not silently become a foldable symbol value
        raise RvvError(f"line {st.line}: unknown scalar operand {tok!r} "
                       f"({st.text!r})")

    def _sc_write(self, tok: str, value, hot: bool, st: _Stmt):
        r = _xreg(tok)
        if r is not None:
            if r != 0:
                self.x[r] = value
                (self.hot_x.add if hot else self.hot_x.discard)(r)
            return
        fr = _freg(tok)
        if fr is not None:
            self.f[fr] = value
            (self.hot_f.add if hot else self.hot_f.discard)(fr)
            return
        raise RvvError(f"line {st.line}: bad destination {tok!r} "
                       f"({st.text!r})")

    def do_scalar(self, st: _Stmt):
        """Abstract-interpret one scalar instruction.  Instructions whose
        result the machine can track (constants, symbols, induction
        arithmetic) are loop/address bookkeeping and fold away; the rest
        are the modeled scalar work and coalesce into SCALAR_BLOCKs."""
        m, ops = st.mnemo, st.ops
        val = _UNKNOWN
        base = _ALUI_BASE.get(m, m)

        def binop(a, b):
            if isinstance(a, int) and isinstance(b, int):
                return {"add": a + b, "sub": a - b, "mul": a * b,
                        "and": a & b, "or": a | b, "xor": a ^ b,
                        "sll": a << (b & 63), "srl": a >> (b & 63),
                        "sra": a >> (b & 63),
                        "sh1add": (a << 1) + b, "sh2add": (a << 2) + b,
                        "sh3add": (a << 3) + b,
                        "slt": int(a < b), "sltu": int(a < b),
                        "min": min(a, b), "max": max(a, b),
                        "minu": min(a, b), "maxu": max(a, b),
                        "addw": a + b, "subw": a - b, "mulw": a * b,
                        "sllw": a << (b & 31), "srlw": a >> (b & 31),
                        "sraw": a >> (b & 31),
                        }.get(base)
            if isinstance(a, tuple) and a[0] == "sym" and isinstance(b, int):
                if base in ("add", "addw"):
                    return ("sym", a[1], a[2] + b)
                if base in ("sub", "subw"):
                    return ("sym", a[1], a[2] - b)
            if isinstance(b, tuple) and b[0] == "sym" and isinstance(a, int) \
                    and base in ("add", "addw"):
                return ("sym", b[1], b[2] + a)
            return _UNKNOWN

        hot = False
        if m == "li":
            v = _imm(ops[1])
            if v is None:
                raise RvvError(f"line {st.line}: bad li immediate")
            self._sc_write(ops[0], v, False, st)
            return
        if m in ("la", "lla"):
            self._sc_write(ops[0], ("sym", ops[1], 0), False, st)
            return
        if m == "lui":
            v = _imm(ops[1])
            self._sc_write(ops[0], (v << 12) if v is not None else _UNKNOWN,
                           False, st)
            return
        if m == "nop":
            return
        if m in _SC_UNARY:
            a, hot = self._sc_read(ops[1], st)
            if m == "mv" or m.startswith(("sext", "zext")):
                val = a
            elif m == "neg" and isinstance(a, int):
                val = -a
            elif m == "not" and isinstance(a, int):
                val = ~a
            elif m in ("seqz", "snez", "sltz", "sgtz") and isinstance(a, int):
                val = int({"seqz": a == 0, "snez": a != 0,
                           "sltz": a < 0, "sgtz": a > 0}[m])
            self._sc_write(ops[0], val, hot and val is _UNKNOWN, st)
            if val is _UNKNOWN:
                self.emit_scalar(_S, hot)
            return
        if m in _SC_ALU3 or m in _SC_ALUI:
            a, h1 = self._sc_read(ops[1], st)
            b, h2 = self._sc_read(ops[2], st)
            val = binop(a, b)
            hot = h1 or h2
            self._sc_write(ops[0], val, hot and val is _UNKNOWN, st)
            if val is _UNKNOWN:
                self.emit_scalar(_SC_FU.get(m, _S), hot)
            return
        if m in _SC_LOAD or m in _SC_FLOAD:
            _, hot = self._sc_read(ops[1], st)
            self._sc_write(ops[0], _UNKNOWN, hot, st)
            self.emit_scalar(_S, hot)
            return
        if m in _SC_STORE or m in _SC_FSTORE:
            _, h1 = self._sc_read(ops[0], st)
            _, h2 = self._sc_read(ops[1], st)
            self.emit_scalar(_S, h1 or h2)
            return
        if m.startswith("f") and "." in m:
            fbase = m.split(".", 1)[0]
            hot = any(self._sc_read(o, st)[1] for o in ops[1:])
            self._sc_write(ops[0], _UNKNOWN, hot, st)
            self.emit_scalar(_F_FU.get(fbase, _S), hot)
            return
        if m.startswith("csr"):
            if ops:
                self._sc_write(ops[0], _UNKNOWN, False, st)
            self.emit_scalar(_S, False)
            return
        if m in ("call", "tail", "jalr"):
            raise RvvError(
                f"line {st.line}: external call {st.text!r} is not "
                "decodable — transcendental math must use the vf* "
                "pseudo-instructions (vfexp.v / vflog.v / vfpow.vv / ...)")
        raise RvvError(f"line {st.line}: unsupported mnemonic {m!r} "
                       f"({st.text!r})")


def _branch_taken(m: str, a, b, st: _Stmt) -> bool:
    for v in (a, b):
        if not isinstance(v, int):
            raise RvvError(
                f"line {st.line}: branch on unknown value ({st.text!r}) — "
                "the decoder executes control flow, so loop bounds must be "
                "known (li) or the loop marked .chunk")
    return {"beq": a == b, "bne": a != b, "blt": a < b, "bge": a >= b,
            "bltu": a < b, "bgeu": a >= b, "bgt": a > b, "ble": a <= b,
            "bgtu": a > b, "bleu": a <= b}[m]


# --------------------------------------------------------------------------
# the decode driver
# --------------------------------------------------------------------------

def decode(text: str, mvl: int = 256, cfg=None, *, expand: bool = False,
           avl: int | None = None, path: str = "<string>") -> Decoded:
    """Decode RVV assembly text to a :class:`Decoded` chunk.

    ``mvl`` is the hardware MVL in 64-bit elements (``VLEN = mvl*64`` bits);
    with ``cfg`` (a ``VectorEngineConfig``) the effective VLEN is
    ``min(mvl, cfg.mvl)`` and whole-register moves run at ``cfg.mvl``
    elements (the §4.1.2 semantics the hand-coded canneal body models).
    ``expand=True`` ignores any ``.chunk`` marker and concretely expands
    every loop (exact tail VLs) — the mode the strip-mine invariance test
    uses; the default emits the marked steady-state loop once and returns
    its trip count in ``chunks``.
    """
    prog = parse(text)
    vlmax = min(mvl, cfg.mvl) if cfg is not None else mvl
    whole = cfg.mvl if cfg is not None else mvl
    mach = _Machine(prog, vlmax, whole, expand, avl)
    chunk_ip = None if expand else prog.chunk_ip

    ip, fuel = 0, MAX_STEPS
    n = len(prog.stmts)
    while ip < n:
        if ip == chunk_ip and not mach.in_chunk and not mach.chunk_done:
            mach._flush()
            mach.in_chunk = True
            mach.prologue_len = len(mach.recs)
            mach.prologue_defs = frozenset(mach.vdef)
            mach.chunk_snap = list(mach.x)
        fuel -= 1
        if fuel <= 0:
            raise RvvError(
                f"{path}: decode exceeded {MAX_STEPS} steps — mark the "
                "steady-state loop with .chunk or reduce the AVL")
        st = prog.stmts[ip]
        m = st.mnemo
        mach.mnemonics[m] = mach.mnemonics.get(m, 0) + 1

        # control flow ------------------------------------------------------
        if m in ("ret", "ebreak", "unimp"):
            break
        if m == "jr" and st.ops and st.ops[0] == "ra":
            break
        if m in ("j", "jal"):
            tgt = st.ops[-1]
            if tgt not in prog.labels:
                raise RvvError(f"line {st.line}: unknown label {tgt!r}")
            ip = prog.labels[tgt]
            continue
        if m in _BRANCH1 or m in _BRANCH2:
            if m in _BRANCH1:
                base = "b" + m[1:-1]          # beqz -> beq vs zero
                a, _ = mach._sc_read(st.ops[0], st)
                b = 0
                tgt = st.ops[1]
                creg = _xreg(st.ops[0])
            else:
                base = m
                a, _ = mach._sc_read(st.ops[0], st)
                b, _ = mach._sc_read(st.ops[1], st)
                tgt = st.ops[2]
                creg = _xreg(st.ops[0])
            if tgt not in prog.labels:
                raise RvvError(f"line {st.line}: unknown label {tgt!r}")
            tgt_ip = prog.labels[tgt]
            if (mach.in_chunk and tgt_ip == chunk_ip):
                # the steady-state chunk loop closes here: emit one body,
                # derive the trip count from the counter's affine step
                mach._flush()
                c0 = mach.chunk_snap[creg] if creg is not None else None
                c1 = mach.x[creg] if creg is not None else None
                if not (isinstance(c0, int) and isinstance(c1, int)
                        and c0 > c1):
                    raise RvvError(
                        f"line {st.line}: cannot derive the chunk trip "
                        "count — the .chunk loop must close on a counter "
                        f"decremented by a known step ({st.text!r})")
                d = c0 - c1
                if m in ("bnez", "bne") and c0 % d:
                    raise RvvError(
                        f"line {st.line}: bnez-closed .chunk loop needs "
                        f"AVL divisible by the step (AVL={c0}, step={d}); "
                        "close with bgtz for strip-mine tails")
                mach.chunks = c0 / d
                mach.in_chunk = False
                mach.chunk_done = True
                mach.x[creg] = 0
                ip += 1
                continue
            taken = _branch_taken(base, a, b, st)
            ip = tgt_ip if taken else ip + 1
            continue

        # vsetvli -------------------------------------------------------------
        if m in ("vsetvli", "vsetivli", "vsetvl"):
            mach.do_vset(st)
            ip += 1
            continue

        # vector / scalar -----------------------------------------------------
        if not mach.do_vector(st):
            mach.do_scalar(st)
        ip += 1

    mach._flush()
    if mach.in_chunk:
        raise RvvError(f"{path}: .chunk loop never closed (no backward "
                       "branch to the marker)")
    body = isa.Trace.from_records(mach.recs[mach.prologue_len:])
    prologue = isa.Trace.from_records(mach.recs[:mach.prologue_len])
    return Decoded(trace=body, chunks=mach.chunks, prologue=prologue,
                   vlmax=vlmax, whole_reg_elems=whole,
                   prologue_defs=mach.prologue_defs,
                   mnemonics=mach.mnemonics, vl_cap=mach.vl_cap, path=path)


def decode_file(path: str, mvl: int = 256, cfg=None, **kw) -> Decoded:
    with open(path) as f:
        return decode(f.read(), mvl, cfg, path=path, **kw)


# --------------------------------------------------------------------------
# the RiVec assembly corpus as a trace source (suite `:asm` variant)
# --------------------------------------------------------------------------

ASM_DIR = os.path.join(os.path.dirname(__file__), os.pardir, "asm")

_DECODE_CACHE: dict = {}


def decode_app(app_name: str, mvl: int, cfg=None) -> Decoded:
    """Decode ``src/repro_torch/asm/<app>.s`` at (mvl, cfg), cached like
    ``tracegen.body_for``."""
    from repro_torch.core import tracegen
    app = tracegen.app_for(app_name)
    if not app.asm:
        raise RvvError(f"{app.name} has no asm= corpus entry")
    vlmax = min(mvl, cfg.mvl) if cfg is not None else mvl
    whole = cfg.mvl if cfg is not None else mvl
    key = (app.name, vlmax, whole)
    out = _DECODE_CACHE.get(key)
    if out is None:
        path = os.path.join(ASM_DIR, app.asm)
        out = _DECODE_CACHE[key] = decode_file(path, mvl, cfg)
    return out


def asm_body(app_name: str, mvl: int, cfg=None) -> isa.Trace:
    """The decoded chunk body — the ``:asm`` analogue of ``body_for``."""
    return decode_app(app_name, mvl, cfg).trace


def asm_chunks(app_name: str, mvl: int, cfg=None) -> float:
    """Chunk count derived from the ``.s`` file's own AVL / loop counter
    (``ceil``-free fractional count, like ``App.chunks``)."""
    return decode_app(app_name, mvl, cfg).chunks


CHECK_MVLS = (8, 16, 32, 64, 128, 256)


def cross_validate_all(apps=None, cfgs=None, device=None) -> list:
    """Decoded-vs-hand-coded contract (core.crossval) for every app
    with an ``asm=`` corpus entry, at every MVL of the paper grid."""
    from repro_torch.core import engine as eng
    from repro_torch.core import tracegen
    if apps is None:
        apps = [a for a in sorted(tracegen.APPS) if tracegen.APPS[a].asm]
    if cfgs is None:
        cfgs = [eng.VectorEngineConfig(mvl=m, lanes=4) for m in CHECK_MVLS]

    def derive(app, eff, cfg):
        d = decode_app(app, eff, cfg)
        regs = isa.trace_registers(d.trace)
        return d.trace, regs, regs

    return crossval.cross_validate(derive, apps, cfgs, device=device)


def check_all(verbose: bool = True, device=None) -> bool:
    """The ``--check-all`` gate: static mixes exact + steady-state
    time within tolerance at every MVL, plus decoder-derived chunk counts
    against the characterized closed forms and body validation."""
    from repro_torch.core import engine as eng
    from repro_torch.core import suite, tracegen
    reports = cross_validate_all(device=device)
    ok = crossval.print_reports(reports, "rvv cross-validation") \
        if verbose else all(r.ok for r in reports)
    for app in [a for a in sorted(tracegen.APPS) if tracegen.APPS[a].asm]:
        for m in CHECK_MVLS:
            cfg = eng.VectorEngineConfig(mvl=m, lanes=4)
            eff = suite.effective_mvl(app, cfg)
            d = decode_app(app, eff, cfg)
            want = tracegen.APPS[app].chunks(eff)
            rel = abs(d.chunks - want) / want
            problems = d.validate()
            if rel > 1e-6 or problems:
                ok = False
                if verbose:
                    print(f"{app}@mvl{m}: chunks {d.chunks} vs {want} "
                          f"(rel {rel:.2e}); validate: {problems}")
    if verbose:
        print("rvv chunk counts + body invariants:",
              "ok" if ok else "PROBLEMS")
    return ok


# --------------------------------------------------------------------------
# CLI
# --------------------------------------------------------------------------

def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.core.rvv",
        description="Decode an RVV v1.0 assembly kernel into the vector IR "
                    "and simulate it, or run the corpus cross-validation "
                    "gate (--check-all).")
    ap.add_argument("file", nargs="?", help="RVV assembly file (.s)")
    ap.add_argument("--check-all", action="store_true",
                    help="cross-validate the src/repro_torch/asm corpus against "
                         "the hand-coded tracegen bodies at every MVL in "
                         f"{CHECK_MVLS}")
    ap.add_argument("--mvl", type=int, default=64,
                    help="hardware MVL in 64-bit elements (default 64)")
    ap.add_argument("--lanes", type=int, default=4)
    ap.add_argument("--avl", type=int, default=None,
                    help="initial a0 (application vector length) for "
                         "kernels that take AVL as an argument")
    ap.add_argument("--device", default=None,
                    help="engine device (default: the CUDA device; "
                         "'cpu' runs the plain PyTorch scan)")
    ap.add_argument("--expand", action="store_true",
                    help="ignore .chunk and expand every loop concretely")
    args = ap.parse_args(argv)

    if args.check_all:
        return 0 if check_all(device=args.device) else 1
    if not args.file:
        ap.error("need an assembly file or --check-all")

    from repro_torch.core import engine as eng
    cfg = eng.VectorEngineConfig(mvl=args.mvl, lanes=args.lanes)
    d = decode_file(args.file, args.mvl, cfg, expand=args.expand,
                    avl=args.avl)
    tr, pro = d.trace, d.prologue
    print(f"{args.file}: decoded at mvl={args.mvl} lanes={args.lanes} "
          f"(VLMAX={d.vlmax})")
    print(f"  prologue: {len(pro)} IR entries; chunk body: {len(tr)} "
          f"entries x {d.chunks:g} chunks")
    hist = {isa.KIND_NAMES[k]: int(c)
            for k, c in enumerate(isa.kind_histogram(tr)) if c}
    print(f"  body kinds: {hist}")
    print(f"  vector registers touched: {isa.trace_registers(tr)}; "
          f"element work/chunk: {int(tr.vl[tr.kind != isa.SCALAR_BLOCK].sum())}")
    problems = d.validate()
    print(f"  invariants: {'ok' if not problems else problems}")
    per_chunk = eng.steady_state_time(tr, cfg, device=args.device)
    total = eng.simulate(d.full_trace, cfg, device=args.device)["time"]
    print(f"  steady-state time/chunk: {per_chunk:.1f} cycles; "
          f"modeled kernel time: {d.chunks * per_chunk:.0f} cycles "
          f"(one-pass decode+sim of the decoded stream: {total:.0f})")
    return 0 if not problems else 1


if __name__ == "__main__":
    raise SystemExit(main())

