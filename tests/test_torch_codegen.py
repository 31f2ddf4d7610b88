"""Port parity: the RVV code generator and its round trip.

``isa.trace_records`` is held to the reference's record view and to its
bitwise inverse ``Trace.from_records``; the port's ``codegen.emit`` and
the reference's give the same text after the 4-line header (which names
each package's own modules) on identical record lists; ``emit_app``
reproduces the committed corpus (``src/repro_torch/asm``, byte-equal to
the reference's) after the header for all ten apps; the emit -> decode
round trip holds at every MVL of ``rvv.CHECK_MVLS``; the emitter refuses
what no RVV spelling decodes back to, as the reference's does
(``tests/test_codegen.py``).

The reference's live lowering raises on JAX 0.9's ``'jit'`` primitive for
the jacobi-2d, pathfinder, decode_attention and ssd_scan specs (ROADMAP
Queue 3): where it does, the oracle of ``emit_app`` is the committed
corpus, the reference's code generator's own emission of that lowering,
and the assertion message says so.
"""
from pathlib import Path

import pytest

from repro.core import codegen as ref_cg
from repro.core import frontend as ref_fe
from repro.core import isa as ref_isa
from repro_torch.core import codegen, crossval, engine as eng
from repro_torch.core import frontend, isa, rvv, suite, tracegen

ROOT = Path(__file__).resolve().parents[1]
APPS = sorted(tracegen.APPS)
HEADER = 4     # comment lines naming the emitting package's modules


def after_header(text: str) -> list[str]:
    return text.splitlines()[HEADER:]


def committed(app: str) -> str:
    return (ROOT / "src" / "repro_torch" / "asm"
            / tracegen.APPS[app].asm).read_text()


@pytest.mark.parametrize("app", ["blackscholes", "canneal", "ssd_scan",
                                 "decode_attention"])
def test_trace_records_match_reference_and_round_trip(app):
    cfg = eng.VectorEngineConfig(mvl=64, lanes=4)
    for name in (app, app + ":asm"):
        t = tracegen.body_for(name, suite.effective_mvl(name, cfg), cfg)
        recs = isa.trace_records(t)
        assert recs == ref_isa.trace_records(ref_isa.Trace(**vars(t)))
        assert all(type(v) in (int, float, bool) for r in recs
                   for v in r.values())
        back = isa.Trace.from_records(recs)
        for field in isa.Trace.__dataclass_fields__:
            a, b = getattr(back, field), getattr(t, field)
            assert a.dtype == b.dtype and (a == b).all(), (name, field)
        assert isa.trace_fingerprint(back) == isa.trace_fingerprint(t)


def port_bodies(app):
    """The per-VL record lists, chunk counts and whole-register sizes
    ``emit_app`` builds, from the port's torch.fx lowering."""
    groups = codegen._grouped(rvv.CHECK_MVLS, lambda m: suite.effective_mvl(
        app, eng.VectorEngineConfig(mvl=m)))
    bodies, chunks, wholes = {}, {}, {}
    for eff, mvl in groups.items():
        low = frontend.derived_body(
            app, eff, eng.VectorEngineConfig(mvl=mvl, lanes=4))
        bodies[eff] = isa.trace_records(low.trace)
        chunks[eff] = float(tracegen.APPS[app].chunks(eff))
        wholes[eff] = mvl
    return bodies, chunks, wholes


@pytest.mark.parametrize("app", APPS)
def test_emit_matches_reference_emitter(app):
    """The two emitters on the same record lists: equal after the header,
    and each header names its own package."""
    bodies, chunks, wholes = port_bodies(app)
    mine = codegen.emit(app, bodies, chunks, wholes)
    ref = ref_cg.emit(app, bodies, chunks, wholes)
    assert after_header(mine) == after_header(ref)
    assert "repro_torch.core.codegen" in mine.splitlines()[0]
    assert "torch.fx" in mine.splitlines()[1]
    assert mine.endswith("\n") and ref.endswith("\n")


@pytest.mark.parametrize("app", APPS)
def test_emit_app_matches_the_corpus(app):
    """``emit_app`` against the reference's ``emit_app`` where its live
    lowering runs on JAX 0.9, and against the committed corpus always."""
    text = codegen.emit_app(app)
    assert after_header(text) == after_header(committed(app)), \
        f"{app}: emit_app differs from the committed corpus"
    try:
        ref = ref_cg.emit_app(app)
    except ref_fe.FrontendError as e:
        assert "'jit'" in str(e), e            # only the known fault
        assert app in ("jacobi-2d", "pathfinder", "decode_attention",
                       "ssd_scan"), \
            f"{app}: the reference's lowering raised ({e})"
        return
    assert after_header(text) == after_header(ref), \
        f"{app}: emit_app differs from the reference's live emission"
    assert ref == committed(app)


@pytest.mark.parametrize("app", APPS)
def test_round_trip_at_every_mvl(app):
    reports = crossval.round_trip_app(app, text=committed(app))
    assert [r.mvl for r in reports] == list(rvv.CHECK_MVLS)
    bad = [(r.mvl, r.problems) for r in reports if not r.ok]
    assert not bad, (app, bad)


def test_check_all_gate(capsys):
    """``python -m repro_torch.core.codegen --check-all``: 10 apps x 6 MVLs,
    60 of 60 round trips."""
    assert codegen.main(["--check-all"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[-1] == "codegen round trip: ROUND-TRIPS"
    assert sum(ln.rstrip().endswith(" ok") for ln in out[1:]) == 60


def test_cli_prints_one_app(capsys):
    assert codegen.main(["swaptions"]) == 0
    assert after_header(capsys.readouterr().out) == \
        after_header(committed("swaptions"))


def test_emit_kernel_round_trips_a_torch_spec():
    """The module's doctest: a torch saxpy spec emitted at two MVLs and
    decoded back fingerprint-equal to its lowering."""
    spec = lambda vl, cfg: [frontend.KernelBody(
        fn=lambda x, y: x * 2.0 + y, vl=vl,
        ins=(frontend.Stream("x", 32.0), frontend.Stream("y", 32.0)),
        outs=(frontend.Stream("out", 32.0),))]
    text = codegen.emit_kernel(spec, "saxpy", avl=4096, mvls=(8, 64))
    d = rvv.decode(text, 64)
    assert d.trace.vl.tolist() == [64] * 5 and d.chunks == 64.0
    assert isa.trace_fingerprint(d.trace) == isa.trace_fingerprint(
        frontend.lower(spec(64, None)).trace)


def test_emitter_rejects_unspellable_records():
    """The reference's loud-error contract (``tests/test_codegen.py``)."""
    def mk(**kw):
        rec = dict(kind=isa.VARITH, vl=8, fu=isa.FU_SIMPLE, n_src=2,
                   src1=1, src2=2, dst=3, mem_pattern=0,
                   footprint_kb=0.0, scalar_count=0, dep_scalar=False)
        rec.update(kw)
        return rec
    emit1 = lambda recs: codegen.emit("t", {8: recs}, {8: 1.0}, {8: 8})
    with pytest.raises(codegen.CodegenError, match="no scalar spelling"):
        emit1([mk(kind=isa.SCALAR_BLOCK, vl=0, fu=isa.FU_TRANS, n_src=0,
                  src1=-1, src2=-1, dst=-1, scalar_count=4)])
    with pytest.raises(codegen.CodegenError, match="coalesce"):
        emit1([mk(kind=isa.SCALAR_BLOCK, vl=0, n_src=0, src1=-1, src2=-1,
                  dst=-1, scalar_count=4),
               mk(kind=isa.SCALAR_BLOCK, vl=0, n_src=0, src1=-1, src2=-1,
                  dst=-1, scalar_count=4)])
    with pytest.raises(codegen.CodegenError, match="FU_SIMPLE"):
        emit1([mk(), mk(kind=isa.VREDUCE, fu=isa.FU_MUL, n_src=1, src1=3,
                        src2=-1, dst=4)])
    with pytest.raises(codegen.CodegenError, match="NOP"):
        emit1([mk(), mk(kind=isa.NOP, vl=0, n_src=0, src1=-1, src2=-1,
                        dst=-1)])
    with pytest.raises(codegen.CodegenError, match="no bodies"):
        codegen.emit("t", {}, {}, {})
