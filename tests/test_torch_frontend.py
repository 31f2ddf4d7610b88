"""Port parity: the torch.fx frontend against the reference's jaxpr frontend.

Each app's ``kernel=`` spec, written in torch, is lowered through
``repro_torch.core.frontend`` and held fingerprint-equal to the reference's
lowering of its JAX spec (with the same register pressure), for the seven
RiVec apps and the three ML apps at the 6 MVLs of the paper's grid.  On
JAX 0.9 the reference's walker does not know the ``jit`` call primitive
(ROADMAP Queue 3), so its live lowering raises for the four specs that call
``jnp.roll``/``jnp.where``/``jnp.cumsum`` (jacobi-2d, pathfinder,
decode_attention, ssd_scan); those are held against the reference's decoded
RVV corpus instead — the code generator's emission of that same lowering,
which round-trips it bitwise — and the assertion message says which
reference was used.  The committed golden rows of the ML apps are checked
in ``tests/test_torch_study_ml.py``.
"""
import pytest
import torch

from repro.core import engine as ref_eng
from repro.core import frontend as ref_fe
from repro.core import isa as ref_isa
from repro.core import rvv as ref_rvv
from repro.core import tracegen as ref_tg
from repro_torch.core import engine as eng
from repro_torch.core import frontend as fe
from repro_torch.core import isa, suite, tracegen

APPS = sorted(tracegen.APPS)
MVLS = (8, 16, 32, 64, 128, 256)


def reference_body(app, eff, mvl):
    """The reference's lowering of ``app`` at (eff, mvl x 4 lanes), or —
    where its live walker raises on JAX 0.9's ``jit`` primitive — its
    decoded corpus body; with a label naming which."""
    rcfg = ref_eng.VectorEngineConfig(mvl=mvl, lanes=4)
    try:
        low = ref_fe.lower(ref_tg.APPS[app].kernel(eff, rcfg))
    except ref_fe.FrontendError as e:
        assert "'jit'" in str(e), e            # only the known fault
        return (ref_rvv.asm_body(app, eff, rcfg), None,
                "the reference's decoded RVV corpus (its live jaxpr lowering "
                "raises on JAX 0.9's 'jit' primitive, ROADMAP Queue 3)")
    return low.trace, (low.max_live, low.regs_used), \
        "the reference's live jaxpr lowering"


def test_registry_holds_the_reference_apps():
    assert APPS == sorted(ref_tg.APPS) and len(APPS) == 10
    assert tracegen.RIVEC_APPS == ref_tg.RIVEC_APPS
    assert tracegen.ASM_APPS == ref_tg.ASM_APPS
    for app in APPS:
        mine, ref = tracegen.APPS[app], ref_tg.APPS[app]
        assert (mine.asm, mine.max_vl, mine.init_scalar, mine.notes) == \
            (ref.asm, ref.max_vl, ref.init_scalar, ref.notes)
        assert mine.kernel is not None
        assert tracegen.SCALAR_PROFILES[app].__dict__ == \
            ref_tg.SCALAR_PROFILES[app].__dict__
    assert tracegen.split_variant("canneal:asm") == ("canneal", "asm")
    assert tracegen.split_variant("canneal") == ("canneal", "hand")


@pytest.mark.parametrize("app", APPS)
def test_lowering_is_fingerprint_equal_to_reference(app):
    for mvl in MVLS:
        cfg = eng.VectorEngineConfig(mvl=mvl, lanes=4)
        eff = suite.effective_mvl(app, cfg)
        got = fe.lower(tracegen.APPS[app].kernel(eff, cfg))
        want, pressure, source = reference_body(app, eff, mvl)
        assert len(got.trace) == len(want) and \
            isa.trace_fingerprint(got.trace) == \
            ref_isa.trace_fingerprint(want), \
            f"{app}@mvl{mvl}: torch.fx lowering differs from {source}"
        if pressure is not None:
            assert (got.max_live, got.regs_used) == pressure, (app, mvl)
        assert isa.trace_registers(got.trace) <= fe.N_LOGICAL_REGS


@pytest.mark.parametrize("app", ["flash_attention", "decode_attention",
                                 "ssd_scan"])
def test_ml_bodies_are_the_lowering(app):
    """An ML app's body is its lowered chunk, whatever the config: the spec
    depends on (mvl, cfg) only through vl = min(mvl, cfg.mvl)."""
    for mvl, cmvl in ((64, 64), (256, 16), (8, 128)):
        cfg = eng.VectorEngineConfig(mvl=cmvl, lanes=2)
        body = tracegen.body_for(app, mvl, cfg)
        low = fe.lower_trace(tracegen.APPS[app].kernel(mvl, cfg))
        assert isa.trace_fingerprint(body) == isa.trace_fingerprint(low)


def test_crossval_bar_for_all_ten_apps(capsys):
    """The contract of ``python -m repro_torch.core.frontend`` (the
    reference's CONSISTENT bar) over all ten apps: kind/FU/pattern/element/
    scalar mixes exact, register pressure in bounds, steady-state time
    within 5% of the body, on the CPU engine."""
    reports = fe.cross_validate_all(apps=APPS, device="cpu")
    assert len(reports) == 20
    bad = [(r.app, r.cfg_label, r.time_rel_err) for r in reports if not r.ok]
    assert not bad
    assert fe.main(["--device", "cpu"]) == 0
    assert "frontend cross-validation: CONSISTENT" in capsys.readouterr().out


def test_op_table_classes():
    """Elementwise ops by FU class, integer powers as multiplies, whole
    reductions, the cumsum ladder, slides, gathers and scalar blocks."""
    def fn(a, b):
        c = torch.minimum(a, b) * a          # simple, mul
        d = torch.sqrt(c) / b                # div, div
        e = torch.exp(d) + c ** 2            # trans, mul (integer pow), simple
        f = torch.cumsum(e, 0)               # 3 x (slide + simple) at vl 8
        g = torch.roll(f, 1)                 # slide
        h = a[b.long()]                      # indexed load
        s = torch.sum(g) * 2.0               # reduce, then a scalar op
        return h + s
    tr = fe.lower_trace([fe.KernelBody(fn, 8, ins=(fe.Stream("a", 4.0),
                                                   fe.Stream("b", 4.0)))])
    kinds = [isa.KIND_NAMES[k] for k in tr.kind]
    assert kinds.count(isa.KIND_NAMES[isa.VSLIDE]) == 4
    assert kinds.count(isa.KIND_NAMES[isa.VREDUCE]) == 1
    arith_fu = [int(f) for k, f in zip(tr.kind, tr.fu) if k == isa.VARITH]
    assert arith_fu == [0, 1, 2, 2, 3, 1, 0, 0, 0, 0, 0]
    loads = tr.mem_pattern[tr.kind == isa.VLOAD]
    assert sorted(loads.tolist()) == [isa.MEM_UNIT, isa.MEM_UNIT,
                                      isa.MEM_INDEXED]
    sc = tr.kind == isa.SCALAR_BLOCK
    assert int(tr.scalar_count[sc].sum()) == 1 and bool(tr.dep_scalar[sc][0])


def test_unmapped_ops_and_pressure_raise():
    with pytest.raises(fe.FrontendError, match="no vector-IR mapping"):
        fe.lower([fe.KernelBody(lambda a: torch.sort(a).values, 8,
                                ins=(fe.Stream("a", 1.0),))])
    streams = tuple(fe.Stream(f"s{i}", 1.0) for i in range(40))
    with pytest.raises(fe.FrontendError, match="register pressure"):
        fe.lower([fe.KernelBody(lambda *xs: sum(xs), 8, ins=streams)])
    with pytest.raises(fe.FrontendError, match="not produced"):
        fe.lower([fe.KernelBody(lambda a: a, 8, ins=("missing",))])
