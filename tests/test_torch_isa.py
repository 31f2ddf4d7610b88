"""Port parity: the trace IR, the RiVec bodies and the import guard.

The port (``repro_torch``) keeps the reference's host-side trace IR and
hand-coded loop bodies; every check here is exact (fingerprints are
content hashes of every field).
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

from repro.core import isa as ref_isa
from repro.core import rvv as ref_rvv
from repro.core import tracegen as ref_tg
from repro_torch import interop
from repro_torch.core import isa, tracegen

MVLS = (8, 16, 32, 64, 128, 256)
ROOT = os.path.join(os.path.dirname(__file__), "..")
SRC = os.path.join(ROOT, "src")


def _port(trace) -> isa.Trace:
    return interop.trace_from_numpy(vars(trace))


@pytest.mark.parametrize("app", ref_tg.RIVEC_APPS)
def test_body_fingerprints_equal_every_mvl(app):
    """Bodies are bitwise the reference's at every MVL, with and without a
    config (exact: fingerprint equality)."""
    from repro.core import engine as ref_eng
    from repro_torch.core import engine as eng
    for mvl in MVLS:
        got = tracegen.body_for(app, mvl)
        want = ref_tg.body_for(app, mvl)
        assert isa.trace_fingerprint(got) == ref_isa.trace_fingerprint(want)
        for lanes in (1, 8):
            c_ref = ref_eng.VectorEngineConfig(mvl=mvl, lanes=lanes)
            c = eng.VectorEngineConfig(mvl=mvl, lanes=lanes)
            assert isa.trace_fingerprint(tracegen.body_for(app, mvl, c)) == \
                ref_isa.trace_fingerprint(ref_tg.body_for(app, mvl, c_ref))


def test_registry_matches_reference():
    assert tracegen.RIVEC_APPS == ref_tg.RIVEC_APPS
    for app in tracegen.RIVEC_APPS:
        mine, ref = tracegen.APPS[app], ref_tg.APPS[app]
        assert (mine.mix, mine.max_vl, mine.init_scalar) == \
            (ref.mix, ref.max_vl, ref.init_scalar)
        assert tracegen.SCALAR_PROFILES[app].__dict__ == \
            ref_tg.SCALAR_PROFILES[app].__dict__
        for mvl in MVLS:
            # closed forms: exact float equality
            assert dataclasses.asdict(mine.counts(mvl)) == \
                dataclasses.asdict(ref.counts(mvl))
            assert tracegen.chunks_for(app, mvl) == ref_tg.chunks_for(app, mvl)


FORMERLY_UNPORTED = ["flash_attention", "ssd_scan", "blackscholes:asm"]


@pytest.mark.parametrize("name", FORMERLY_UNPORTED)
def test_unported_apps_raise_clearly(name):
    """A name outside the registry raises KeyError naming it, also when it
    is a near miss of a registered one (the ML apps and the ``:asm``
    variants now resolve)."""
    for bad in (f"{name}-x", "no-such-app"):
        with pytest.raises(KeyError, match=bad.split(":")[0]):
            tracegen.body_for(bad, 64)


@pytest.mark.parametrize("name", FORMERLY_UNPORTED)
def test_former_unported_names_resolve_to_reference_bodies(name):
    """The names the first slices did not carry resolve to the reference's
    bodies (the ML lowering, the decoded corpus).  The reference's live
    lowering of ssd_scan raises on JAX 0.9 (ROADMAP Queue 3), so it is held
    against the decoded corpus."""
    want = (ref_rvv.asm_body("ssd_scan", 64) if name == "ssd_scan"
            else ref_tg.body_for(name, 64))
    assert isa.trace_fingerprint(tracegen.body_for(name, 64)) == \
        ref_isa.trace_fingerprint(want)


def test_trace_ops_match_reference():
    """tile / pad_to / concat / stack_traces / nop_trace produce bitwise
    the reference's traces."""
    want = ref_tg.body_for("jacobi-2d", 64)
    got = _port(want)
    fp, rfp = isa.trace_fingerprint, ref_isa.trace_fingerprint
    assert fp(got.tile(3)) == rfp(want.tile(3))
    assert fp(got.pad_to(len(got) + 5)) == rfp(want.pad_to(len(want) + 5))
    assert fp(got.concat(got)) == rfp(want.concat(want))
    assert fp(isa.nop_trace(7)) == rfp(ref_isa.nop_trace(7))
    st, rst = isa.stack_traces([got, got.tile(2)]), \
        ref_isa.stack_traces([want, want.tile(2)])
    for f in isa.Trace.__dataclass_fields__:
        np.testing.assert_array_equal(getattr(st, f), getattr(rst, f))
    with pytest.raises(ValueError):
        got.pad_to(len(got) - 1)


def test_validate_trace_and_builder_match_reference():
    recs = [dict(kind=isa.VARITH, vl=300, src1=3, src2=40, dst=1)]
    assert isa.validate_trace(isa.Trace.from_records(recs), mvl=256) == \
        ref_isa.validate_trace(ref_isa.Trace.from_records(recs), mvl=256)
    b, rb = isa.TraceBuilder(), ref_isa.TraceBuilder()
    for x in (b, rb):
        x.scalar(12, dep_scalar=True).arith_chain(30, {"simple": 0.5,
                                                       "mul": 0.5}, 64)
        x.load(64, pattern=isa.MEM_INDEXED, footprint_kb=8.0).reduce(64)
        x.mask_to_scalar(64).move(64).slide(64).store(64)
    assert isa.trace_fingerprint(b.build()) == \
        ref_isa.trace_fingerprint(rb.build())


def test_interop_checks_dtypes_and_lengths():
    fields = dict(vars(ref_tg.body_for("pathfinder", 8)))
    bad = dict(fields, vl=fields["vl"].astype(np.int64))
    with pytest.raises(ValueError, match="dtype"):
        interop.trace_from_numpy(bad)
    with pytest.raises(ValueError, match="unequal"):
        interop.trace_from_numpy(dict(fields, kind=fields["kind"][:-1]))
    with pytest.raises(ValueError, match="missing"):
        interop.trace_from_numpy({k: v for k, v in fields.items()
                                  if k != "fu"})


def test_port_imports_neither_jax_nor_repro():
    """Importing every module of the port, and chip_smoke.py, pulls in no
    JAX and nothing of the reference package (a fresh interpreter, so this
    file's own imports do not count); no source line names them either."""
    code = """
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.')]
for n in names:
    importlib.import_module(n)
sys.path.insert(0, sys.argv[1])
importlib.import_module('chip_smoke')
bad = sorted(m for m in sys.modules
             if m == 'jax' or m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))
assert len(names) >= 15, names
assert not bad, bad
print(len(names))
"""
    env = dict(os.environ, PYTHONPATH=SRC)
    r = subprocess.run([sys.executable, "-c", code, ROOT], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    files = [os.path.join(ROOT, "chip_smoke.py")] + [
        os.path.join(d, f) for d, _, fs in os.walk(os.path.join(SRC, "repro_torch"))
        for f in fs if f.endswith(".py")]
    for path in files:
        for line in open(path):
            s = line.strip()
            assert not s.startswith(("import jax", "from jax", "import repro.",
                                     "import repro ", "from repro.",
                                     "from repro ")), (path, s)
