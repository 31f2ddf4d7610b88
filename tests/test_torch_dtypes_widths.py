"""Port parity: the input types and head widths the reference computes.

The reference runs JAX with 64-bit types off, widens every kernel input to
float32 inside the kernel and takes any head width.  The same seeded numpy
inputs go through ``repro.kernels.ops`` (the Pallas kernels in interpret
mode on the CPU) and through ``repro_torch.kernels.ops(..., device="cpu")``
(each wrapper's plain version, because the tensors lie on the CPU); the
output type must be the reference's and the values agree at the kernel's
bar from ``tests/test_kernels.py``: 2e-4 for float32 attention, decoding
and streamcluster, 2e-2 for 16-bit attention, 1e-2 for 16-bit
streamcluster, 1e-6 for float32 Jacobi-2D, 4e-3 for the SSD scan.  A
16-bit output rounds float32 sums taken in different orders, so where the
reference's float32 bar applies to a 16-bit result the type's epsilon is
added (one unit in the last place).  bfloat16 Jacobi-2D: the port sums in
float32 and rounds once, the Pallas kernel adds in bfloat16, two units
apart at most on [0, 1) data; held at the 16-bit streamcluster bar, 1e-2.
The CUDA kernels for these types and widths are held against the same
plain versions on the card by ``tests/test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro_torch.kernels import decode_attention as da_mod
from repro_torch.kernels import flash_attention as fa_mod
from repro_torch.kernels import ops
from repro_torch.kernels import ssd_scan as ssd_mod

JDT = {"float16": jnp.float16, "bfloat16": jnp.bfloat16,
       "float32": jnp.float32}


def normal(shape, seed, scale=1.0):
    return (np.random.RandomState(seed).standard_normal(shape)
            * scale).astype(np.float64)


def ssd_inputs(b, S, H, P, N, seed):
    """``tests/test_kernels.py``'s draws, in float64 numpy."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, S, H, P)) * 0.5,
            np.log1p(np.exp(rng.standard_normal((b, S, H)))),
            -np.exp(rng.standard_normal(H) * 0.3),
            rng.standard_normal((b, S, N)) * 0.5,
            rng.standard_normal((b, S, N)) * 0.5)


def close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(jnp.asarray(want, jnp.float32)),
                               rtol=tol, atol=tol)


# ---- numpy float64 arrays: float32 inside and out, as JAX makes them ----

def test_float64_arrays_streamcluster():
    p, c = normal((40, 24), 1), normal((33, 24), 2)
    want = ref_ops.streamcluster_dist(p, c, bm=8, bn=11, interpret=True)
    got = ops.streamcluster_dist(p, c, device="cpu")
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    close(got, want, 2e-4)


def test_float64_arrays_pathfinder():
    wall = np.random.RandomState(3).uniform(0, 10, (17, 50))
    want = ref_ops.pathfinder(wall, interpret=True)
    got = ops.pathfinder(wall, device="cpu")
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    close(got, want, 1e-6)


def test_int64_arrays_pathfinder():
    """numpy's default integers: int32 inside, as JAX makes them."""
    wall = np.random.RandomState(4).randint(0, 10, (17, 50))
    assert wall.dtype == np.int64
    want = ref_ops.pathfinder(wall, interpret=True)
    got = ops.pathfinder(wall, device="cpu")
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    close(got, want, 1e-6)


def test_float64_arrays_flash_attention():
    q, k, v = (normal((2, 128, 2, 32), s) for s in (4, 5, 6))
    want = ref_ops.flash_attention(q, k, v, bq=64, bk=64, interpret=True)
    got = ops.flash_attention(q, k, v, device="cpu")
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    close(got, want, 2e-4)


def test_float64_arrays_ssd_scan():
    args = ssd_inputs(2, 128, 3, 16, 32, 7)
    want = ref_ops.ssd_scan(*args, chunk=64, interpret=True)
    got = ops.ssd_scan(*args, chunk=64, device="cpu")
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    close(got, want, 4e-3)


def test_float64_arrays_decode_attention():
    q, k, v = normal((2, 3, 32), 8), normal((2, 64, 3, 32), 9), \
        normal((2, 64, 3, 32), 10)
    lens = np.array([17, 64], np.int32)
    want = ref_ops.decode_attention(q, k, v, lens, bk=32, interpret=True)
    got = ops.decode_attention(q, k, v, lens, device="cpu")
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    close(got, want, 2e-4)


# ---- 16-bit inputs: computed in float32, returned in the reference's type

@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_float16(causal):
    arrs = [normal((2, 128, 2, 64), s).astype(np.float32) for s in (11, 12,
                                                                     13)]
    want = ref_ops.flash_attention(*(jnp.asarray(a, jnp.float16)
                                     for a in arrs),
                                   bq=64, bk=64, causal=causal,
                                   interpret=True)
    got = ops.flash_attention(*(torch.from_numpy(a).half() for a in arrs),
                              causal=causal)
    assert got.dtype == torch.float16 and want.dtype == jnp.float16
    close(got, want, 2e-2)


@pytest.mark.parametrize("q_type,kv_type", [
    ("bfloat16", "bfloat16"), ("float16", "float16"),
    ("float32", "bfloat16"), ("bfloat16", "float32")])
def test_decode_attention_16bit(q_type, kv_type):
    """A 16-bit query and cache, and each mixed with float32: the output
    has q's type."""
    q = normal((3, 4, 64), 14).astype(np.float32)
    k, v = (normal((3, 128, 4, 64), s).astype(np.float32) for s in (15, 16))
    lens = np.array([0, 50, 128], np.int32)
    want = ref_ops.decode_attention(jnp.asarray(q, JDT[q_type]),
                                    jnp.asarray(k, JDT[kv_type]),
                                    jnp.asarray(v, JDT[kv_type]), lens,
                                    bk=64, interpret=True)
    tq, tkv = getattr(torch, q_type), getattr(torch, kv_type)
    got = ops.decode_attention(torch.from_numpy(q).to(tq),
                               torch.from_numpy(k).to(tkv),
                               torch.from_numpy(v).to(tkv),
                               torch.from_numpy(lens))
    assert got.dtype == tq and want.dtype == JDT[q_type]
    close(got, want, 2e-4 + torch.finfo(tq).eps)


def test_streamcluster_float16():
    p, c = (normal(s, seed).astype(np.float32)
            for s, seed in (((64, 32), 17), ((48, 32), 18)))
    want = ref_ops.streamcluster_dist(jnp.asarray(p, jnp.float16),
                                      jnp.asarray(c, jnp.float16), bm=32,
                                      bn=16, interpret=True)
    got = ops.streamcluster_dist(torch.from_numpy(p).half(),
                                 torch.from_numpy(c).half())
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    close(got, want, 1e-2)


@pytest.mark.parametrize("shape", [(66, 128), (130, 40)])
def test_jacobi2d_bfloat16(shape):
    a = np.random.RandomState(shape[1]).uniform(size=shape).astype(
        np.float32)
    want = ref_ops.jacobi2d_step(jnp.asarray(a, jnp.bfloat16),
                                 rows_per_block=64 if shape[0] == 66 else 32,
                                 interpret=True)
    got = ops.jacobi2d_step(torch.from_numpy(a).bfloat16())
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    close(got, want, 1e-2)
    # the boundary is held exactly
    edge = torch.from_numpy(a).bfloat16()
    assert torch.equal(got[0], edge[0]) and torch.equal(got[:, -1],
                                                        edge[:, -1])


# ---- head widths past 128 ------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("D", [256, 160, 640, 1100])
def test_flash_attention_wide_heads(dtype, D):
    """Float32 at 129..256 columns takes the 3xTF32 kernel's D-256
    instantiation and past 256 its sliced kernel; the 16-bit types the
    wgmma kernel's D-256 instantiation, and past 512 its sliced kernel
    (D 640: two slices of 5 panels, Q resident; D 1,100: three of 6, Q
    streamed)."""
    arrs = [normal((1, 128, 2, D), s).astype(np.float32) for s in (19, 20,
                                                                    21)]
    want = ref_ops.flash_attention(*(jnp.asarray(a, JDT[dtype])
                                     for a in arrs),
                                   bq=64, bk=64, interpret=True)
    q, k, v = (torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs)
    if dtype == "float32":
        route = ("3xtf32_256/cp.async16" if D <= 256 else
                 "3xtf32_sliced/cp.async16")
    else:
        route = ("wgmma256/tma" if D <= 256 else
                 "wgmma_sliced/tma" if D % 8 == 0 else
                 "wgmma_sliced/cp.async")
    assert fa_mod.path(q, k, v) == route
    got = ops.flash_attention(q, k, v)
    assert got.dtype == q.dtype and got.shape == q.shape
    close(got, want, 2e-4 if dtype == "float32" else 2e-2)


def test_decode_attention_head_width_256():
    q = normal((2, 2, 256), 22).astype(np.float32)
    k, v = (normal((2, 96, 2, 256), s).astype(np.float32) for s in (23, 24))
    lens = np.array([96, 31], np.int32)
    assert da_mod.plan(2, 96, 2, 256, 4, True, 132).pieces == 1
    want = ref_ops.decode_attention(q, k, v, lens, bk=32, interpret=True)
    got = ops.decode_attention(q, k, v, lens, device="cpu")
    assert got.dtype == torch.float32 and got.shape == (2, 2, 256)
    close(got, want, 2e-4)


@pytest.mark.parametrize("P", [256, 192])
def test_ssd_scan_head_width_past_128(P):
    """The card splits such a head into P-slices of <= 128 columns; the CPU
    and the card take the same calls (the wrapper no longer refuses P >
    128 on the card)."""
    args = [a.astype(np.float32) for a in ssd_inputs(1, 128, 2, P, 16, P)]
    want = ref_ops.ssd_scan(*args, chunk=64, interpret=True)
    got = ops.ssd_scan(*args, chunk=64, device="cpu")
    assert got.dtype == torch.float32 and got.shape == args[0].shape
    close(got, want, 4e-3)
    assert not hasattr(ssd_mod, "MAX_P")
