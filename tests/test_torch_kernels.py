"""Port parity: the kernel modules and their wrappers.

On the CPU each wrapper takes its kernel's plain PyTorch version, and only
because the tensors lie on the CPU; the plain versions are held against the
reference (Black-Scholes against the Pallas kernel in interpret mode, at
``tests/test_kernels.py``'s 3e-5).  The CUDA kernels themselves are held
against their plain versions on the card by ``tests/test_torch_cuda.py``.
"""
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro_torch.core import engine as eng
from repro_torch.core import suite, tracegen
from repro_torch.kernels import blackscholes as bs_mod
from repro_torch.kernels import engine_scan, ops, ref


def bs_inputs(n: int, seed: int = 0):
    """Seeded option arrays (numpy), the ranges of tests/test_kernels.py."""
    rng = np.random.RandomState(seed)
    f32 = np.float32
    return [rng.uniform(10, 100, n).astype(f32),
            rng.uniform(10, 100, n).astype(f32),
            np.full(n, 0.05, f32),
            rng.uniform(0.1, 0.6, n).astype(f32),
            rng.uniform(0.2, 2.0, n).astype(f32),
            (rng.uniform(size=n) > 0.5).astype(np.int32)]


@pytest.mark.parametrize("n", [2048, 8192])
def test_blackscholes_plain_matches_pallas_interpret(n):
    args = bs_inputs(n, seed=n)
    want = np.asarray(ref_ops.blackscholes(*args, block=512, interpret=True))
    got = ops.blackscholes(*(torch.from_numpy(a) for a in args))
    np.testing.assert_allclose(got.numpy(), want, rtol=3e-5, atol=3e-5)
    got_cpu = ops.blackscholes(*args, device="cpu")
    assert torch.equal(got, got_cpu)


def test_blackscholes_wrapper_takes_plain_path_on_cpu_only():
    args = [torch.from_numpy(a) for a in bs_inputs(100)]
    before = bs_mod.blackscholes.launches
    assert torch.equal(bs_mod.blackscholes(*args), ref.blackscholes(*args))
    assert bs_mod.blackscholes.launches == before   # no kernel launched


@pytest.mark.parametrize("bad", ["float64", "shape", "is_call_dtype", "2d",
                                 "strided"])
def test_blackscholes_wrapper_rejects_bad_inputs(bad):
    args = [torch.from_numpy(a) for a in bs_inputs(64)]
    if bad == "float64":
        args[0] = args[0].double()
    elif bad == "shape":
        args[1] = args[1][:32]
    elif bad == "is_call_dtype":
        args[5] = args[5].float()
    elif bad == "2d":
        args = [a.reshape(8, 8) for a in args]
    else:
        args = [a[::2] for a in args]
    with pytest.raises(ValueError):
        bs_mod.blackscholes(*args)


def _study_inputs(device, apps=("jacobi-2d", "pathfinder"), lanes=(1, 8)):
    cfgs = [eng.VectorEngineConfig(mvl=m, lanes=l)
            for m in (8, 256) for l in lanes]
    pairs = [(a, c) for a in apps for c in cfgs]
    bodies = [tracegen.body_for(a, suite.effective_mvl(a, c), c)
              for a, c in pairs]
    return eng.pack_steady_state(bodies, [c for _, c in pairs], 3, 4, device)


def test_engine_scan_wrapper_takes_plain_path_on_cpu_only():
    inp = _study_inputs("cpu")
    before = engine_scan.scan.launches
    out = engine_scan.scan(*inp.args())
    assert torch.equal(out, engine_scan.scan_plain(*inp.args()))
    assert engine_scan.scan.launches == before
    assert out.shape == (len(engine_scan.OUT_FIELDS), inp.xf.shape[1])
    assert torch.isfinite(out).all()


def test_engine_scan_wrapper_checks_operands():
    inp = _study_inputs("cpu")
    args = list(inp.args())
    with pytest.raises(ValueError, match="params"):
        engine_scan.scan(args[0], args[1], args[2].double(), *args[3:])
    with pytest.raises(ValueError, match="xi"):
        engine_scan.scan(args[0][:, :-1], *args[1:])
    with pytest.raises(ValueError, match="contiguous"):
        engine_scan.scan(args[0], args[1], args[2].t().contiguous().t(),
                         *args[3:])


def test_engine_scan_prepass_plain_word_layout():
    """The pre-pass's records: the scalar-clock add is the block's cost for
    a scalar record and SCALAR_CYCLES[0] x scalar_scale for a vector one;
    the word's flags and slot fields decode to the trace's kinds and
    registers (ZERO_SLOT for an absent source, DUMMY_SLOT for no vector
    dst)."""
    from repro_torch.core import isa
    inp = _study_inputs("cpu", apps=("streamcluster", "particlefilter"))
    xi, xf, params, consts = inp.args()[:4]
    rec_f, w = engine_scan.prepass_plain(xi, xf, params, consts)
    F, M, _ = engine_scan._record_terms(xi, xf, params, consts)
    kind, src1, dst = xi[0], xi[4], xi[6]
    scalar = (kind == isa.SCALAR_BLOCK) | (kind == isa.NOP)
    assert rec_f.shape == (*xf.shape, 4) and w.dtype == torch.int32
    assert torch.equal(rec_f[..., 0][scalar], F[..., 0][scalar])
    sv = (consts[0] * params[:, 10]).expand_as(xf)
    assert torch.equal(rec_f[..., 0][~scalar], sv[~scalar])
    assert torch.equal(rec_f[..., 3], F[..., 1] + F[..., 2])
    assert torch.equal((w & engine_scan.F_VEC) != 0, ~scalar)
    mem = (kind == isa.VLOAD) | (kind == isa.VSTORE)
    assert torch.equal((w & engine_scan.F_MEM) != 0, mem)
    assert torch.equal((w & engine_scan.F_ARITH) != 0, ~scalar & ~mem)
    slot1, slot_d = (w >> 7) & 0xff, (w >> 23) & 0xff
    assert torch.equal(slot1, torch.where(src1 >= 0, src1,
                                          engine_scan.ZERO_SLOT))
    assert torch.equal(slot_d, torch.where(~scalar & (dst >= 0), dst,
                                           engine_scan.DUMMY_SLOT))


def test_engine_scan_kernels_take_cuda_tensors_only():
    """The two kernels' wrappers refuse CPU operands (``scan`` takes the
    plain version for them instead)."""
    inp = _study_inputs("cpu")
    xi, xf, params, consts, period, n, ck = inp.args()
    with pytest.raises(ValueError, match="CUDA"):
        engine_scan.prepass(xi, xf, params, consts)
    rec_f, rec_w = engine_scan.prepass_plain(xi, xf, params, consts)
    with pytest.raises(ValueError, match="CUDA"):
        engine_scan.steps(rec_f, rec_w, params, period, n, ck)
