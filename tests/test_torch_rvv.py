"""Port parity: the RVV v1.0 decoder and its assembly corpus.

``repro_torch.core.rvv`` is the reference decoder with the port's imports,
reading the port's own copy of the corpus (``src/repro_torch/asm``).  The
copy is byte-equal to ``src/repro/asm``; every decoded chunk body is
fingerprint-equal to the reference's for the 10 apps at the 6 MVLs of the
paper's grid, and every chunk count within 1e-6 of it.  The decoded-vs-
hand-coded contract (``core.crossval``) and the chunk-count check of
``python -m repro_torch.core.rvv --check-all`` pass on the CPU engine.
"""
import os

import pytest

from repro.core import engine as ref_eng
from repro.core import isa as ref_isa
from repro.core import rvv as ref_rvv
from repro_torch.core import engine as eng
from repro_torch.core import isa, rvv, suite, tracegen

APPS = sorted(a for a in tracegen.APPS if tracegen.APPS[a].asm)
MVLS = rvv.CHECK_MVLS


def test_corpus_copy_is_byte_equal():
    names = sorted(os.listdir(ref_rvv.ASM_DIR))
    assert names == sorted(os.listdir(rvv.ASM_DIR))
    assert names == sorted(tracegen.APPS[a].asm for a in APPS)
    assert len(APPS) == 10 and rvv.CHECK_MVLS == ref_rvv.CHECK_MVLS
    for name in names:
        with open(os.path.join(rvv.ASM_DIR, name), "rb") as f, \
                open(os.path.join(ref_rvv.ASM_DIR, name), "rb") as g:
            assert f.read() == g.read(), name


@pytest.mark.parametrize("app", APPS)
def test_decoded_bodies_and_chunks_match_reference(app):
    for mvl in MVLS:
        cfg = eng.VectorEngineConfig(mvl=mvl, lanes=4)
        rcfg = ref_eng.VectorEngineConfig(mvl=mvl, lanes=4)
        eff = suite.effective_mvl(app, cfg)
        got, want = rvv.decode_app(app, eff, cfg), \
            ref_rvv.decode_app(app, eff, rcfg)
        assert len(got.trace) == len(want.trace)
        assert isa.trace_fingerprint(got.trace) == \
            ref_isa.trace_fingerprint(want.trace), (app, mvl)
        assert isa.trace_fingerprint(got.prologue) == \
            ref_isa.trace_fingerprint(want.prologue), (app, mvl)
        assert abs(got.chunks - want.chunks) <= 1e-6 * abs(want.chunks)
        assert got.validate() == want.validate() == []
        # the suite's ":asm" variant routes through the decoder
        assert isa.trace_fingerprint(tracegen.body_for(f"{app}:asm", eff,
                                                       cfg)) == \
            isa.trace_fingerprint(got.trace)
        assert tracegen.chunks_for(f"{app}:asm", eff, cfg) == got.chunks


def test_check_all_gate_passes_on_the_cpu_engine(capsys):
    """Static mixes exact and steady-state time within 5% of the bodies for
    the 10 apps x 6 MVLs, chunk counts within 1e-6 of the closed forms."""
    assert rvv.check_all(verbose=True, device="cpu")
    out = capsys.readouterr().out
    assert "rvv cross-validation: CONSISTENT" in out
    assert "rvv chunk counts + body invariants: ok" in out


def test_decoder_rejects_what_the_reference_rejects():
    bad = "vsetvli t0, a0, e64, m1\nvle64.v v33, (a1)\n"
    with pytest.raises(rvv.RvvError):
        rvv.decode(bad, 64)
    with pytest.raises(ref_rvv.RvvError):
        ref_rvv.decode(bad, 64)
