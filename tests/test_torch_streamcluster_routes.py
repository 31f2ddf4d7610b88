"""Port parity: streamcluster's routes on the tensor cores.

On the card ``streamcluster_dist`` takes the route ``path`` names: 16-bit
operands on ``wgmma``, float32 as 3xTF32 on ``wgmma`` (panels by TMA where
rows are 16-byte aligned, else by plain loads).  The route is chosen on the
host and checked here.  The float32 kernel's arithmetic is mirrored in
torch: each operand split into two TF32 values by masks (``csrc/tf32.cuh``:
``split_tf32``), three products a product with float32 sums, 8 columns of
D a step.  The mirror is held against float64 distances at the reference's
2e-4 (where plain TF32 misses it), and against the reference's own
``streamcluster_dist`` (the Pallas kernel in interpret mode).  The kernel
is held against the plain version on the card by
``tests/test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import ref
from repro_torch.kernels import streamcluster as sc_mod

MASK = -8192   # 0xffffe000 as int32: a TF32 value's 10 mantissa bits kept


def tf32(x):
    """``x`` truncated to TF32 (the low 13 mantissa bits cleared)."""
    return (x.view(torch.int32) & MASK).view(torch.float32)


def split(x):
    """x ~ big + small, each TF32, as split_tf32 does."""
    big = tf32(x)
    return big, tf32(x - big)


def mirror_3xtf32(p, c, three=True):
    """The float32 kernel's distances in torch: p.c as 3xTF32 (small x big,
    big x small, big x big) over 8-column steps of D with float32 sums,
    the norms in float32, max(|p|^2 + |c|^2 - 2 p.c, 0).  ``three=False``
    is plain TF32 (big x big only)."""
    pb, ps = split(p)
    cb, cs = split(c)
    pc = torch.zeros(p.shape[0], c.shape[0])
    for k in range(0, p.shape[1], 8):
        s = slice(k, k + 8)
        if three:
            pc = pc + ps[:, s] @ cb[:, s].T
            pc = pc + pb[:, s] @ cs[:, s].T
        pc = pc + pb[:, s] @ cb[:, s].T
    p2 = (p * p).sum(-1, keepdim=True)
    c2 = (c * c).sum(-1)
    return torch.clamp_min(p2 + c2[None, :] - 2.0 * pc, 0.0)


def exact(p, c):
    p, c = p.double(), c.double()
    return ((p[:, None, :] - c[None]) ** 2).sum(-1)


def uniform(shape, seed):
    return torch.from_numpy(np.random.RandomState(seed).uniform(
        size=shape).astype(np.float32))


def test_split_keeps_float32s_accuracy():
    x = torch.from_numpy(np.random.RandomState(0).standard_normal(
        10_000).astype(np.float32))
    big, small = split(x)
    assert torch.equal(tf32(big), big) and torch.equal(tf32(small), small)
    rest = (x.double() - big.double() - small.double()).abs()
    assert bool((rest <= 2.0 ** -20 * x.double().abs()).all())


@pytest.mark.parametrize("m,n,d", [(37, 29, 136), (128, 64, 128),
                                   (5, 130, 8), (64, 33, 200)])
def test_3xtf32_mirror_meets_2e4_where_tf32_misses(m, n, d):
    """PARSEC's points lie in [0, 1): at D 128 a distance is ~21 and p.c
    ~32; TF32's 10 mantissa bits put p.c ~1e-2 off, the split's three
    products within float32's rounding."""
    p, c = uniform((m, d), m + d), uniform((n, d), n + d + 1)
    want = exact(p, c)
    got = mirror_3xtf32(p, c)
    torch.testing.assert_close(got.double(), want, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(got, ref.streamcluster_dist(p, c), rtol=2e-4,
                               atol=2e-4)
    if d >= 128:
        plain_tf32 = mirror_3xtf32(p, c, three=False).double()
        assert not torch.allclose(plain_tf32, want, rtol=2e-4, atol=2e-4)


def test_3xtf32_mirror_matches_the_pallas_kernel():
    """The reference's own kernel (interpret mode) at its test's shape."""
    rng = np.random.RandomState(7)
    p = rng.standard_normal((256, 64)).astype(np.float32)
    c = rng.standard_normal((128, 64)).astype(np.float32)
    want = np.asarray(jops.streamcluster_dist(jnp.asarray(p), jnp.asarray(c),
                                              bm=128, bn=128,
                                              interpret=True))
    got = mirror_3xtf32(torch.from_numpy(p), torch.from_numpy(c))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)


def offset_view(shape, dtype, elems):
    """A contiguous ``shape`` tensor starting ``elems`` elements into a
    fresh buffer (its base then aligned to that many elements at most)."""
    n = shape[0] * shape[1]
    return torch.zeros(n + elems, dtype=dtype)[elems:].view(shape)


@pytest.mark.parametrize("dtype,d,offset,want", [
    (torch.float32, 128, 0, "3xtf32/tma"),          # PARSEC simlarge
    (torch.float32, 130, 0, "3xtf32/ld"),           # rows 8-byte aligned
    (torch.float32, 128, 1, "3xtf32/ld"),           # a base off 16 bytes
    (torch.float32, 128, 4, "3xtf32/tma"),          # 16 bytes in
    (torch.bfloat16, 128, 0, "wgmma/tma"),
    (torch.float16, 136, 0, "wgmma/tma"),
    (torch.bfloat16, 200, 0, "wgmma/tma"),
    (torch.bfloat16, 100, 0, "wgmma/ld"),           # rows 8-byte aligned
    (torch.float16, 127, 0, "wgmma/ld"),
    (torch.float16, 128, 1, "wgmma/ld"),            # a base off 16 bytes
    (torch.bfloat16, 64, 8, "wgmma/tma")])          # 16 bytes in
def test_path(dtype, d, offset, want):
    p = offset_view((70, d), dtype, offset)
    c = torch.zeros(30, d, dtype=dtype)
    assert sc_mod.path(p, c) == want
    assert sc_mod.COUNTERS[want] in ("launches", "ld_launches",
                                     "tf32_launches")


def test_each_route_has_its_counter():
    """Every route is counted apart: the 16-bit TMA route by ``launches``
    (the main path's), plain loads and float32 by their own."""
    assert set(sc_mod.COUNTERS) == set(sc_mod.LOADS)
    assert {sc_mod.COUNTERS[k] for k in ("wgmma/tma", "wgmma/ld",
                                         "3xtf32/tma")} == \
        {"launches", "ld_launches", "tf32_launches"}


def test_cpu_operands_take_the_plain_version_and_launch_nothing():
    p, c = uniform((40, 12), 1), uniform((9, 12), 2)
    before = {k: getattr(sc_mod.streamcluster_dist, k)
              for k in set(sc_mod.COUNTERS.values())}
    got = sc_mod.streamcluster_dist(p, c)
    assert torch.equal(got, ref.streamcluster_dist(p, c))
    assert before == {k: getattr(sc_mod.streamcluster_dist, k)
                      for k in before}
    z = sc_mod.streamcluster_dist(torch.zeros(4, 0), torch.zeros(3, 0))
    assert z.shape == (4, 3) and not z.any()
