"""Port parity: the operand types five wrappers widen to their float32
kernels (canneal, the particle filter, pathfinder, Jacobi-2D's one sweep,
Black-Scholes and swaptions).

On the CPU each wrapper widens the same way it does on the card and then
takes its kernel's plain version, only because the tensors lie on the CPU;
the seeded numpy inputs, rounded to the 16-bit type by torch and by JAX
alike (both round to nearest even), go through ``repro.kernels.ops`` with
``interpret=True``.  Bars:

- bit for bit where widening is exact and the reference compares or adds
  in the wider type: the particle filter and pathfinder;
- canneal's 1e-6 (``tests/test_kernels.py:70``);
- where the result is 16 bits, the reference's float32 bar plus one unit
  of the 16-bit output (its epsilon, as rtol and atol): the port computes
  in float32 and rounds once, so it lands within one unit of the float32
  answer.  Jacobi-2D's reference on a float16 grid adds its five terms in
  float16 and still lands within that bar.  Black-Scholes' and swaptions'
  references round every step of their chains in the 16-bit type (up to
  0.75 off the float64 price in bfloat16, and inf in float16 swaptions where
  ``1 - u`` rounds to 0): there the port is held at that bar to the
  reference's kernel on the same 16-bit values widened to float32, and is
  shown no farther from the float64 truth than the reference's own 16-bit
  result, with the 16-bit output type the reference returns.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro_torch.kernels import blackscholes as bs_mod
from repro_torch.kernels import canneal as ca_mod
from repro_torch.kernels import jacobi2d as j2_mod
from repro_torch.kernels import ops
from repro_torch.kernels import particlefilter as pf_mod
from repro_torch.kernels import pathfinder as path_mod
from repro_torch.kernels import swaptions as sw_mod

TYPES = {"bfloat16": (torch.bfloat16, jnp.bfloat16),
         "float16": (torch.float16, jnp.float16),
         "float32": (torch.float32, jnp.float32),
         "int32": (torch.int32, jnp.int32),
         "int16": (torch.int16, jnp.int16)}


def both(a, name):
    """The numpy array ``a`` as a torch CPU tensor and a JAX array of the
    type ``name``."""
    t, j = TYPES[name]
    return torch.from_numpy(a).to(t), jnp.asarray(a).astype(j)


def as_f32(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32)) \
        if not isinstance(x, torch.Tensor) else x.float().numpy()


def unit(name):
    return float(torch.finfo(TYPES[name][0]).eps)


@pytest.mark.parametrize("locs_type,cand_type", [
    ("bfloat16", "bfloat16"), ("float16", "float16"), ("int32", "int32"),
    ("int32", "float32"), ("float32", "bfloat16")])
def test_canneal_widens_coordinates(locs_type, cand_type):
    """The reference's kernel widens locs and the candidates to float32
    (repro/kernels/canneal.py:19,25-26); float32 costs either way, 1e-6."""
    rng = np.random.RandomState(7)
    N, B, F = 300, 128, 12
    locs = rng.randint(0, 1000, (N, 2)).astype(np.float32)
    fan = rng.randint(-1, N, (B, F)).astype(np.int32)
    ca, cb = (rng.randint(0, 1000, (B, 2)).astype(np.float32)
              for _ in "ab")
    (tl, jl), (ta, ja), (tb, jb) = (both(locs, locs_type),
                                    both(ca, cand_type), both(cb, cand_type))
    want = ref_ops.canneal_swap_cost(jl, jnp.asarray(fan), ja, jb, block=64,
                                     interpret=True)
    before = ca_mod.swap_cost.launches
    got = ca_mod.swap_cost(tl, torch.from_numpy(fan), ta, tb)
    assert ca_mod.swap_cost.launches == before       # the plain version
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)


@pytest.mark.parametrize("cdf_type,u_type", [
    ("bfloat16", "bfloat16"), ("float16", "float16"),
    ("float32", "bfloat16"), ("bfloat16", "float32"),
    ("float16", "bfloat16")])
def test_find_index_widens_exactly(cdf_type, u_type):
    """16-bit CDFs and queries, and pairs of two float types: the reference
    compares in the wider type, which widening reproduces exactly (ties
    of the rounded CDF included); int32 out, bit for bit."""
    rng = np.random.RandomState(3)
    cdf = np.sort(rng.uniform(size=2048).astype(np.float32))
    u = rng.uniform(size=256).astype(np.float32)
    (tc, jc), (tu, ju) = both(cdf, cdf_type), both(u, u_type)
    want = np.asarray(ref_ops.particlefilter_findindex(jc, ju, interpret=True))
    got = pf_mod.find_index(tc, tu)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(got, ops.particlefilter_findindex(tc, tu))


@pytest.mark.parametrize("dtype", ["bfloat16", "float16", "int16"])
def test_pathfinder_widens_exactly(dtype):
    """The reference widens each row to float32 (pathfinder.py:23): exact
    for these types, so bit for bit, float32 out."""
    rng = np.random.RandomState(11)
    w = (rng.randint(0, 10, (24, 300)) if dtype == "int16"
         else rng.uniform(0, 10, (24, 300))).astype(np.float32)
    tw, jw = both(w, dtype)
    want = np.asarray(ref_ops.pathfinder(jw, interpret=True))
    before = path_mod.pathfinder.launches
    got = path_mod.pathfinder(tw)
    assert path_mod.pathfinder.launches == before
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("shape,rpb", [((66, 128), 64), ((34, 40), 32)])
def test_jacobi2d_step_float16(shape, rpb):
    """A float16 grid, float16 out: 1e-6 plus one unit of float16 against
    the Pallas kernel, which adds in float16; and numpy's float16 kept by
    ``ops``."""
    a = np.random.RandomState(shape[0]).standard_normal(shape).astype(
        np.float32)
    ta, ja = both(a, "float16")
    want = np.asarray(ref_ops.jacobi2d_step(ja, rows_per_block=rpb,
                                            interpret=True)).astype(np.float32)
    got = j2_mod.jacobi2d_step(ta)
    assert got.dtype == torch.float16
    tol = 1e-6 + unit("float16")
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)
    assert torch.equal(ops.jacobi2d_step(ta.numpy(), device="cpu"), got)


def bs_inputs(n, seed):
    rng = np.random.RandomState(seed)
    cols = [rng.uniform(lo, hi, n).astype(np.float32)
            for lo, hi in ((10, 100), (10, 100), (0.01, 0.1), (0.05, 0.65),
                           (0.1, 2.0))]
    return cols, rng.uniform(size=n) > 0.5


def bs_float64(cols, calls):
    """PARSEC's formula in float64 on the host."""
    from math import erf
    s, k, r, v, t = (c.astype(np.float64) for c in cols)
    cndf = np.vectorize(lambda x: 0.5 * (1 + erf(x / np.sqrt(2))))
    d1 = (np.log(s / k) + (r + 0.5 * v * v) * t) / (v * np.sqrt(t))
    d2 = d1 - v * np.sqrt(t)
    call = s * cndf(d1) - k * np.exp(-r * t) * cndf(d2)
    put = k * np.exp(-r * t) * cndf(-d2) - s * cndf(-d1)
    return np.where(calls, call, put)


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_blackscholes_16bit(dtype):
    cols, calls = bs_inputs(2048, 5)
    pairs = [both(c, dtype) for c in cols]
    got = bs_mod.blackscholes(*(t for t, _ in pairs),
                              torch.from_numpy(calls.astype(np.int32)))
    assert got.dtype == TYPES[dtype][0]
    # the reference's kernel on the same 16-bit values widened to float32
    widened = ref_ops.blackscholes(*(j.astype(jnp.float32) for _, j in pairs),
                                   jnp.asarray(calls.astype(np.int32)),
                                   interpret=True)
    want = as_f32(widened.astype(TYPES[dtype][1]))
    tol = 3e-5 + unit(dtype)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)
    # the reference on the 16-bit operands themselves, every step rounded
    # to the type: its result is that type and no closer to float64
    ref16 = ref_ops.blackscholes(*(j for _, j in pairs), jnp.asarray(calls),
                                 interpret=True)
    assert ref16.dtype == TYPES[dtype][1]
    truth = bs_float64([as_f32(j) for _, j in pairs], calls)
    port_err = np.abs(got.double().numpy() - truth).max()
    ref_err = np.abs(as_f32(ref16).astype(np.float64) - truth).max()
    assert port_err <= ref_err, (port_err, ref_err)


def test_blackscholes_boolean_is_call():
    """A boolean is_call, which the reference's ``!= 0`` takes: 3e-5
    against the reference given the same booleans, and bit for bit the
    port's price with is_call as int32 0/1."""
    cols, calls = bs_inputs(2048, 6)
    want = ref_ops.blackscholes(*(jnp.asarray(c) for c in cols),
                                jnp.asarray(calls), interpret=True)
    f32 = [torch.from_numpy(c) for c in cols]
    got = bs_mod.blackscholes(*f32, torch.from_numpy(calls))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=3e-5,
                               atol=3e-5)
    assert torch.equal(
        got, bs_mod.blackscholes(*f32,
                                 torch.from_numpy(calls.astype(np.int32))))


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_cum_normal_inv_16bit(dtype):
    u = np.random.RandomState(9).uniform(1e-5, 1 - 1e-5, 4096).astype(
        np.float32)
    tu, ju = both(u, dtype)
    got = sw_mod.cum_normal_inv(tu)
    assert got.dtype == TYPES[dtype][0]
    widened = ref_ops.cum_normal_inv(ju.astype(jnp.float32), block=1024,
                                     interpret=True)
    want = as_f32(widened.astype(TYPES[dtype][1]))
    eps = unit(dtype)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=1e-5 + eps,
                               atol=1e-6 + eps)
    ref16 = ref_ops.cum_normal_inv(ju, block=1024, interpret=True)
    assert ref16.dtype == TYPES[dtype][1]
    from scipy.special import ndtri
    truth = ndtri(as_f32(ju).astype(np.float64))
    finite = np.isfinite(truth)
    port_err = np.abs(got.double().numpy() - truth)[finite].max()
    ref_err = np.abs(as_f32(ref16).astype(np.float64) - truth)[finite].max()
    assert np.isfinite(got.float().numpy()).all()
    assert port_err <= ref_err, (port_err, ref_err)
