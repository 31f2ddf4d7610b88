"""RVV v1.0 code generator: torch.fx-lowered kernels back out as assembly.

The port of ``repro/core/codegen.py``, and the inverse of
``repro_torch.core.rvv``: any kernel the torch.fx frontend
(``repro_torch.core.frontend``) accepts is emitted as GNU-``as`` RVV v1.0
assembly — ``vsetvli`` strip-mine structure with exact fractional trip counts,
``.chunk``/``.stream`` directives carrying the chunk count and stream
footprints into the memory model, and every IR construct spelled with the
instruction the decoder maps back to the identical record:

==============================  ===========================================
vector IR record                emitted RVV v1.0
==============================  ===========================================
``VARITH`` @ SIMPLE/MUL/DIV     ``vfadd/vfmul/vfdiv`` ``.vv``/``.vf`` by
                                operand count (``vid.v`` for a 0-source
                                SIMPLE op)
``VARITH`` @ TRANS              ``vfexp.v`` / ``vfpow.vv`` pseudo-calls
``VREDUCE``                     ``vfredusum.vs``
``VSLIDE``                      ``vslide1down.vx``
``VMASK_SCALAR``                ``vcpop.m``
``VMOVE``                       ``vmv.v.v`` at VL, ``vmv<n>r.v`` for
                                whole-register (``n x cfg.mvl``-element)
                                spill moves, ``vmv.v.i`` for splats
``VLOAD``/``VSTORE``            ``vle64/vlse64/vluxei64`` (+ store forms),
                                address registers ``la``-bound to
                                ``.stream`` footprint symbols
``SCALAR_BLOCK``                ``.rept`` filler over untracked registers
                                (``add``/``mul``/``div`` by FU class; a
                                ``dep_scalar`` block reads the hot
                                ``vcpop.m`` result)
==============================  ===========================================

Because one ``.s`` file must decode correctly at *every* hardware MVL, the
emitted kernel opens with ``vsetvli t0, zero`` (``t0`` = VLMAX = the
effective MVL) and dispatches on the known ``t0`` to a per-VL body — the
decoder executes known-value branches, so exactly one body is decoded per
configuration and an un-dispatched VL falls into a loud ``call abort``.
The single ``.chunk`` loop closes on a ``bgtz`` counter whose initial value
and step are the exact ``float.as_integer_ratio`` of the app's fractional
chunk count, so the decoder-derived trip count is *bitwise* the closed form.

The correctness contract is the round trip (``crossval.round_trip_all``,
``python -m repro_torch.core.codegen --check-all``): for every app
carrying a ``kernel=`` spec and every MVL in ``rvv.CHECK_MVLS``,
``rvv.decode(emit_app(app))`` must fingerprint-equal the direct torch.fx
lowering, reproduce its chunk count bitwise, and pass
``isa.validate_trace``.

>>> from repro_torch.core import codegen, frontend, isa, rvv
>>> spec = lambda vl, cfg: [frontend.KernelBody(
...     fn=lambda x, y: x * 2.0 + y, vl=vl,
...     ins=(frontend.Stream("x", 32.0), frontend.Stream("y", 32.0)),
...     outs=(frontend.Stream("out", 32.0),))]
>>> text = codegen.emit_kernel(spec, "saxpy", avl=4096, mvls=(8, 64))
>>> d = rvv.decode(text, 64)
>>> d.trace.vl.tolist()
[64, 64, 64, 64, 64]
>>> isa.trace_fingerprint(d.trace) == isa.trace_fingerprint(
...     frontend.lower(spec(64, None)).trace)
True
>>> d.chunks        # 4096 elements strip-mined at VL=64
64.0
"""
from __future__ import annotations

import re

from repro_torch.core import isa

_S, _M, _D, _T = isa.FU_SIMPLE, isa.FU_MUL, isa.FU_DIV, isa.FU_TRANS


class CodegenError(Exception):
    """The trace uses a record shape no RVV spelling decodes back to
    (loud, like ``frontend.FrontendError`` / ``rvv.RvvError``)."""


# scalar-register conventions of the emitted kernels (disjoint by role, so
# the decoder's abstract machine never confuses bookkeeping with work):
#   t0      VLMAX probe / per-VL dispatch key      (known value)
#   t1      dispatch comparand                     (known value)
#   t2      vsetvli AVL staging                    (known value)
#   t3      stride operand of vlse/vsse            (untracked, never read)
#   t5      scalar operand of vslide1down.vx       (untracked, never read)
#   t6      vcpop.m destination                    (hot, never read)
#   a3/a4   chunk counter / step                   (known values)
#   a5      stream address staging (la-bound)      (symbol value)
#   s3      hot scalar seed (prologue vcpop.m)     (read by dep blocks)
#   s4      dep-block sink                         (hot, never read)
#   s5/s6   plain scalar-filler registers          (untracked, never hot)

_SCALAR_SPELL = {
    (False, _S): "add s5, s5, s6",
    (False, _M): "mul s5, s5, s6",
    (False, _D): "div s5, s5, s6",
    (True, _S): "add s4, s5, s3",
    (True, _M): "mul s4, s5, s3",
    (True, _D): "div s4, s5, s3",
}

_ARITH_VV = {_S: "vfadd.vv", _M: "vfmul.vv", _D: "vfdiv.vv", _T: "vfpow.vv"}
_ARITH_VF = {_S: "vfadd.vf", _M: "vfmul.vf", _D: "vfdiv.vf"}

_LOAD_OP = {isa.MEM_UNIT: "vle64.v", isa.MEM_STRIDED: "vlse64.v",
            isa.MEM_INDEXED: "vluxei64.v"}
_STORE_OP = {isa.MEM_UNIT: "vse64.v", isa.MEM_STRIDED: "vsse64.v",
             isa.MEM_INDEXED: "vsuxei64.v"}


def _vector_reads(rec: dict) -> list[int]:
    """Registers the decoder's def-before-use check reads for this record."""
    k, n = rec["kind"], rec["n_src"]
    out = []
    if k == isa.VARITH:
        if n >= 1 and rec["src1"] >= 0:
            out.append(rec["src1"])
        if n >= 2 and rec["src2"] >= 0:
            out.append(rec["src2"])
    elif k == isa.VLOAD:
        if n >= 1 and rec["src1"] >= 0:
            out.append(rec["src1"])
    elif k == isa.VSTORE:
        if rec["src1"] >= 0:
            out.append(rec["src1"])
        if n >= 2 and rec["src2"] >= 0:
            out.append(rec["src2"])
    elif k in (isa.VSLIDE, isa.VREDUCE, isa.VMASK_SCALAR, isa.VMOVE):
        if rec["src1"] >= 0 and n >= 1:
            out.append(rec["src1"])
    return out


def _predefined_regs(recs: list[dict]) -> set[int]:
    """Vector registers a body reads before its first write — the emitter
    initializes these in the prologue (cf. ``Decoded.prologue_defs``)."""
    written: set[int] = set()
    need: set[int] = set()
    for rec in recs:
        if rec["kind"] == isa.SCALAR_BLOCK:
            continue
        for r in _vector_reads(rec):
            if r not in written:
                need.add(r)
        if rec["dst"] >= 0:
            written.add(rec["dst"])
    return need


def _index_regs(recs: list[dict]) -> set[int]:
    """Index-vector registers of indexed loads/stores (spelled ``vid.v``
    in the prologue instead of a zero splat)."""
    out: set[int] = set()
    for rec in recs:
        if rec["mem_pattern"] != isa.MEM_INDEXED:
            continue
        if rec["kind"] == isa.VLOAD and rec["src1"] >= 0:
            out.add(rec["src1"])
        elif rec["kind"] == isa.VSTORE and rec["src2"] >= 0:
            out.add(rec["src2"])
    return out


class _Emitter:
    """Emission state for one kernel: lines, stream-symbol pool, VL."""

    def __init__(self):
        self.lines: list[str] = []
        self.syms: dict[str, str] = {}    # repr(footprint) -> symbol

    def op(self, text: str):
        self.lines.append(f"    {text}")

    def label(self, name: str):
        self.lines.append(f"{name}:")

    def sym_of(self, footprint_kb: float) -> str:
        key = repr(float(footprint_kb))
        sym = self.syms.get(key)
        if sym is None:
            sym = self.syms[key] = f"fp{len(self.syms)}"
        return sym


def _emit_body(e: _Emitter, recs: list[dict], eff: int, whole: int):
    """Emit one per-VL chunk body; entry VL is ``eff`` (the prologue's
    ``vsetvli t0, zero`` result)."""
    vl = eff
    prev_scalar_fu = None

    def ensure_vl(want: int, rec: dict):
        nonlocal vl
        if want > eff:
            raise CodegenError(
                f"record {rec} needs VL={want} > VLMAX={eff}; only "
                "whole-register moves may exceed the effective MVL")
        if want != vl:
            e.op(f"li t2, {want}")
            e.op("vsetvli zero, t2, e64, m1")
            vl = want

    for rec in recs:
        k = rec["kind"]
        if k == isa.SCALAR_BLOCK:
            fu, count, dep = rec["fu"], rec["scalar_count"], rec["dep_scalar"]
            if count < 1:
                raise CodegenError(f"empty SCALAR_BLOCK (count={count})")
            if fu == prev_scalar_fu:
                raise CodegenError(
                    "adjacent same-FU scalar blocks would coalesce into one "
                    "on decode and cannot round-trip")
            spell = _SCALAR_SPELL.get((dep, fu))
            if spell is None:
                raise CodegenError(
                    f"no scalar spelling for FU class {fu} (RISC-V has no "
                    "scalar transcendental instruction)")
            prev_scalar_fu = fu
            e.op(f".rept {count}")
            e.op(spell)
            e.op(".endr")
            continue
        prev_scalar_fu = None

        if k == isa.VARITH:
            fu, n = rec["fu"], rec["n_src"]
            d, a, b = rec["dst"], rec["src1"], rec["src2"]
            if d < 0 or n > 2 or (n >= 1 and a < 0) or (n >= 2 and b < 0):
                raise CodegenError(f"unencodable VARITH record {rec}")
            ensure_vl(rec["vl"], rec)
            if n == 2:
                e.op(f"{_ARITH_VV[fu]} v{d}, v{a}, v{b}")
            elif n == 1:
                if fu == _T:
                    e.op(f"vfexp.v v{d}, v{a}")
                else:
                    e.op(f"{_ARITH_VF[fu]} v{d}, v{a}, ft0")
            else:
                if fu == _S:
                    e.op(f"vid.v v{d}")
                elif fu == _T:
                    e.op(f"vfexp.v v{d}, ft0")
                else:
                    e.op(f"{_ARITH_VF[fu]} v{d}, ft0, ft1")
        elif k in (isa.VLOAD, isa.VSTORE):
            pat, n = rec["mem_pattern"], rec["n_src"]
            ensure_vl(rec["vl"], rec)
            e.op(f"la a5, {e.sym_of(rec['footprint_kb'])}")
            if k == isa.VLOAD:
                d = rec["dst"]
                if d < 0:
                    raise CodegenError(f"VLOAD without destination: {rec}")
                if pat == isa.MEM_INDEXED:
                    if n != 1 or rec["src1"] < 0:
                        raise CodegenError(
                            f"indexed VLOAD needs n_src=1 + an index "
                            f"register: {rec}")
                    e.op(f"vluxei64.v v{d}, (a5), v{rec['src1']}")
                elif n != 0:
                    raise CodegenError(f"{_LOAD_OP[pat]} decodes to "
                                       f"n_src=0, record has {n}: {rec}")
                elif pat == isa.MEM_STRIDED:
                    e.op(f"vlse64.v v{d}, (a5), t3")
                else:
                    e.op(f"vle64.v v{d}, (a5)")
            else:
                s = rec["src1"]
                if s < 0:
                    raise CodegenError(f"VSTORE without source: {rec}")
                if pat == isa.MEM_INDEXED:
                    if n != 2 or rec["src2"] < 0:
                        raise CodegenError(
                            f"indexed VSTORE needs n_src=2 + an index "
                            f"register: {rec}")
                    e.op(f"vsuxei64.v v{s}, (a5), v{rec['src2']}")
                elif n != 1:
                    raise CodegenError(f"{_STORE_OP[pat]} decodes to "
                                       f"n_src=1, record has {n}: {rec}")
                elif pat == isa.MEM_STRIDED:
                    e.op(f"vsse64.v v{s}, (a5), t3")
                else:
                    e.op(f"vse64.v v{s}, (a5)")
        elif k == isa.VSLIDE:
            if rec["dst"] < 0 or rec["src1"] < 0 or rec["n_src"] != 1:
                raise CodegenError(f"unencodable VSLIDE record {rec}")
            ensure_vl(rec["vl"], rec)
            e.op(f"vslide1down.vx v{rec['dst']}, v{rec['src1']}, t5")
        elif k == isa.VREDUCE:
            if rec["fu"] != _S:
                raise CodegenError(
                    f"VREDUCE at FU class {rec['fu']} cannot round-trip: "
                    "RVV vred* always decodes to FU_SIMPLE")
            if rec["dst"] < 0 or rec["src1"] < 0 or rec["n_src"] != 1:
                raise CodegenError(f"unencodable VREDUCE record {rec}")
            ensure_vl(rec["vl"], rec)
            e.op(f"vfredusum.vs v{rec['dst']}, v{rec['src1']}, "
                 f"v{rec['src1']}")
        elif k == isa.VMASK_SCALAR:
            if rec["src1"] < 0 or rec["n_src"] != 1:
                raise CodegenError(f"unencodable VMASK_SCALAR record {rec}")
            ensure_vl(rec["vl"], rec)
            e.op(f"vcpop.m t6, v{rec['src1']}")
        elif k == isa.VMOVE:
            n, d, a = rec["n_src"], rec["dst"], rec["src1"]
            if d < 0:
                raise CodegenError(f"VMOVE without destination: {rec}")
            if n == 0:
                ensure_vl(rec["vl"], rec)
                e.op(f"vmv.v.i v{d}, 0")
            elif n == 1 and a >= 0:
                q, r = divmod(rec["vl"], whole)
                if r == 0 and q in (1, 2, 4, 8):
                    if d % q or a % q:
                        raise CodegenError(
                            f"vmv{q}r.v needs {q}-aligned registers: {rec}")
                    e.op(f"vmv{q}r.v v{d}, v{a}")
                else:
                    ensure_vl(rec["vl"], rec)
                    e.op(f"vmv.v.v v{d}, v{a}")
            else:
                raise CodegenError(f"unencodable VMOVE record {rec}")
        elif k == isa.NOP:
            raise CodegenError("NOP padding entries have no RVV spelling")
        else:
            raise CodegenError(f"unknown record kind {k}")


def emit(name: str, bodies: dict[int, list[dict]],
         chunks: dict[int, float], wholes: dict[int, int]) -> str:
    """Emit one kernel: ``bodies[eff]`` is the per-chunk record list at
    effective MVL ``eff``, ``chunks[eff]`` its fractional trip count, and
    ``wholes[eff]`` the whole-register move size (``cfg.mvl``) the body was
    derived at.  Returns the full ``.s`` text.
    """
    if not bodies:
        raise CodegenError("no bodies to emit")
    if set(bodies) != set(chunks) or set(bodies) != set(wholes):
        raise CodegenError("bodies/chunks/wholes must cover the same VLs")
    label = re.sub(r"\W", "_", name)
    effs = sorted(bodies)
    e = _Emitter()

    predefs = sorted(set().union(*(_predefined_regs(b)
                                   for b in bodies.values())))
    idx_regs = set().union(*(_index_regs(b) for b in bodies.values()))
    any_dep = any(rec["kind"] == isa.SCALAR_BLOCK and rec["dep_scalar"]
                  for b in bodies.values() for rec in b)

    e.label(label)
    e.op("vsetvli t0, zero, e64, m1")
    for r in predefs:
        e.op(f"vid.v v{r}" if r in idx_regs else f"vmv.v.i v{r}, 0")
    if any_dep:
        # bootstrap the hot scalar the dep_scalar filler blocks read
        if 0 not in predefs:
            e.op("vmv.v.i v0, 0")
        e.op("vcpop.m s3, v0")
    for eff in effs:
        e.op(f"li t1, {eff}")
        e.op(f"beq t0, t1, cfg_{eff}")
    e.op("j vl_bad")
    for eff in effs:
        num, den = float(chunks[eff]).as_integer_ratio()
        if num <= 0 or den <= 0:
            raise CodegenError(f"chunk count {chunks[eff]} at VL={eff} is "
                               "not positive")
        e.label(f"cfg_{eff}")
        e.op(f"li a3, {num}")
        e.op(f"li a4, {den}")
        e.op("j cfg_done")
    e.label("vl_bad")
    e.op("call abort")
    e.label("cfg_done")
    e.lines.append("    .chunk")
    e.label("loop")
    for eff in effs:
        e.op(f"li t1, {eff}")
        e.op(f"beq t0, t1, body_{eff}")
    e.op("j vl_bad")
    for eff in effs:
        e.label(f"body_{eff}")
        _emit_body(e, bodies[eff], eff, wholes[eff])
        e.op("j close")
    e.label("close")
    e.op("sub a3, a3, a4")
    e.op("bgtz a3, loop")
    e.op("ret")

    mvl_note = "/".join(str(v) for v in effs)
    head = [
        f"# {name}: RVV v1.0 kernel emitted by repro_torch.core.codegen "
        "-- do not edit.",
        "# Decodes (repro_torch.core.rvv) to the torch.fx-lowered trace, "
        "bitwise, at",
        f"# every effective MVL in {{{mvl_note}}}; the .chunk loop's bgtz",
        "# counter encodes the exact fractional trip count.",
        "    .text",
        f"    .globl {label}",
    ]
    head += [f"    .stream {sym} {key}" for key, sym in e.syms.items()]
    return "\n".join(head + e.lines) + "\n"


# --------------------------------------------------------------------------
# kernel-spec / app entry points
# --------------------------------------------------------------------------

def _grouped(mvls, eff_of) -> dict[int, int]:
    """Map each distinct effective MVL to the largest ``cfg.mvl`` that
    produces it (the representative configuration a body is derived at —
    the one where whole-register and VL-sized moves are distinguishable)."""
    groups: dict[int, int] = {}
    for m in mvls:
        eff = eff_of(m)
        groups[eff] = max(groups.get(eff, 0), m)
    return groups


def emit_kernel(spec, name: str, avl: int, mvls=None,
                max_vl: int | None = None) -> str:
    """Emit a frontend kernel spec (``spec(mvl, cfg) -> segments``, like
    ``App.kernel``) strip-mining ``avl`` total elements; the chunk count at
    each effective MVL is ``avl / eff``."""
    from repro_torch.core import engine as eng
    from repro_torch.core import frontend, rvv
    if mvls is None:
        mvls = rvv.CHECK_MVLS
    groups = _grouped(mvls, lambda m: min(m, max_vl) if max_vl else m)
    bodies, chunks, wholes = {}, {}, {}
    for eff, repr_mvl in groups.items():
        cfg = eng.VectorEngineConfig(mvl=repr_mvl, lanes=4)
        bodies[eff] = isa.trace_records(frontend.lower(spec(eff, cfg)).trace)
        chunks[eff] = avl / eff
        wholes[eff] = repr_mvl
    return emit(name, bodies, chunks, wholes)


def emit_app(app_name: str) -> str:
    """Emit ``src/repro_torch/asm``-corpus assembly for one registered app
    from its torch ``kernel=`` spec: per-VL bodies for every effective MVL the
    ``rvv.CHECK_MVLS`` grid produces, chunk counts from the app's
    characterized closed form."""
    from repro_torch.core import engine as eng
    from repro_torch.core import frontend, rvv, suite, tracegen
    app = tracegen.app_for(app_name)
    if app.kernel is None:
        raise CodegenError(f"{app.name} has no kernel= spec to emit from")
    groups = _grouped(
        rvv.CHECK_MVLS,
        lambda m: suite.effective_mvl(app.name,
                                      eng.VectorEngineConfig(mvl=m)))
    bodies, chunks, wholes = {}, {}, {}
    for eff, repr_mvl in groups.items():
        cfg = eng.VectorEngineConfig(mvl=repr_mvl, lanes=4)
        low = frontend.derived_body(app.name, eff, cfg)
        bodies[eff] = isa.trace_records(low.trace)
        chunks[eff] = float(app.chunks(eff))
        wholes[eff] = repr_mvl
    return emit(app.name, bodies, chunks, wholes)


# --------------------------------------------------------------------------
# CLI: the codegen-roundtrip gate
# --------------------------------------------------------------------------

def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.core.codegen",
        description="Emit RVV v1.0 assembly from a registered app's torch "
                    "kernel spec, or run the emit->decode round-trip gate "
                    "(--check-all).")
    ap.add_argument("app", nargs="?",
                    help="app name to emit (assembly on stdout)")
    ap.add_argument("--check-all", action="store_true",
                    help="round-trip every app with a kernel= spec at every "
                         "MVL (the codegen-roundtrip gate)")
    args = ap.parse_args(argv)
    if args.check_all:
        from repro_torch.core import crossval
        return 0 if crossval.print_round_trips(crossval.round_trip_all(),
                                               "codegen round trip") else 1
    if not args.app:
        ap.error("need an app name or --check-all")
    print(emit_app(args.app), end="")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
