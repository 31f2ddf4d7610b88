"""Port parity: the swaptions, streamcluster, canneal and particle-filter
kernels.

On the CPU each ``repro_torch.kernels.ops`` wrapper takes its kernel's
plain PyTorch version, and only because the tensors lie on the CPU.  The
same seeded numpy inputs go through ``repro.kernels.ops`` with
``interpret=True`` (the Pallas kernels on the CPU), at the sizes and bars of
``tests/test_kernels.py``.  The CUDA kernels themselves are held against
their plain versions on the card by ``tests/test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro.kernels import ref as jref
from repro_torch.kernels import canneal as ca_mod
from repro_torch.kernels import ops, ref
from repro_torch.kernels import particlefilter as pf_mod
from repro_torch.kernels import streamcluster as sc_mod
from repro_torch.kernels import swaptions as sw_mod


def sw_input(n, seed):
    rng = np.random.RandomState(seed)
    return rng.uniform(1e-5, 1 - 1e-5, n).astype(np.float32)


def sc_inputs(m, n, d, seed):
    rng = np.random.RandomState(seed)
    return (rng.standard_normal((m, d)).astype(np.float32),
            rng.standard_normal((n, d)).astype(np.float32))


def ca_inputs(N, B, F, seed):
    """The ranges of tests/test_kernels.py: integer coordinates in
    [0, 1000), fan indices in [-1, N) with -1 as padding."""
    rng = np.random.RandomState(seed)
    return (rng.randint(0, 1000, (N, 2)).astype(np.float32),
            rng.randint(-1, N, (B, F)).astype(np.int32),
            rng.randint(0, 1000, (B, 2)).astype(np.float32),
            rng.randint(0, 1000, (B, 2)).astype(np.float32))


def pf_inputs(n, m, seed):
    rng = np.random.RandomState(seed)
    return (np.sort(rng.uniform(size=n).astype(np.float32)),
            rng.uniform(size=m).astype(np.float32))


@pytest.mark.parametrize("n", [2048, 8192])
def test_cum_normal_inv_matches_pallas_interpret(n):
    u = sw_input(n, seed=n)
    want = np.asarray(ref_ops.cum_normal_inv(u, block=1024, interpret=True))
    got = ops.cum_normal_inv(torch.from_numpy(u))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    assert torch.equal(got, ops.cum_normal_inv(u, device="cpu"))
    # the inverse of the normal CDF: cndf(x) ~= u, the reference's own check
    back = 0.5 * (1 + torch.erf(got.double() / np.sqrt(2)))
    np.testing.assert_allclose(back.numpy(), u, atol=5e-4)


@pytest.mark.parametrize("m,n,d,bm,bn", [(256, 128, 64, 128, 128),
                                         (512, 256, 128, 256, 256)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_streamcluster_dist_matches_pallas_interpret(m, n, d, bm, bn, dtype):
    """bfloat16 inputs are the same float32 arrays cast on both sides."""
    p, c = sc_inputs(m, n, d, seed=m + d)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = getattr(torch, dtype)
    want = np.asarray(ref_ops.streamcluster_dist(
        jnp.asarray(p).astype(jdt), jnp.asarray(c).astype(jdt), bm=bm, bn=bn,
        interpret=True))
    got = ops.streamcluster_dist(torch.from_numpy(p).to(tdt),
                                 torch.from_numpy(c).to(tdt))
    assert got.dtype == torch.float32 and got.shape == (m, n)
    tol = 1e-2 if dtype == "bfloat16" else 2e-4
    np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol)


@pytest.mark.parametrize("N,B,F", [(512, 256, 24), (1024, 512, 8)])
def test_canneal_swap_cost_matches_pallas_interpret(N, B, F):
    args = ca_inputs(N, B, F, seed=N + F)
    wa, wb = ref_ops.canneal_swap_cost(*args, interpret=True)
    ga, gb = ops.canneal_swap_cost(*(torch.from_numpy(a) for a in args))
    np.testing.assert_allclose(ga.numpy(), np.asarray(wa), rtol=1e-6)
    np.testing.assert_allclose(gb.numpy(), np.asarray(wb), rtol=1e-6)


def test_canneal_clamps_out_of_range_indices_as_the_reference():
    """An index >= N reads row N-1, in the reference's plain version and its
    Pallas kernel alike, and in the port."""
    locs, fan, ca, cb = ca_inputs(1024, 256, 24, seed=7)
    fan[0, 0], fan[3, 5], fan[9, 23] = 5000, 1024, 2 ** 31 - 1
    want = [np.asarray(w) for w in ref_ops.canneal_swap_cost(
        locs, fan, ca, cb, interpret=True)]
    plain = [np.asarray(w) for w in jref.canneal_swap_cost(
        *(jnp.asarray(a) for a in (locs, fan, ca, cb)))]
    got = ops.canneal_swap_cost(locs, fan, ca, cb, device="cpu")
    clamped = fan.copy()
    clamped[clamped >= 1024] = 1023
    at_last = ops.canneal_swap_cost(locs, clamped, ca, cb, device="cpu")
    for w, p, g, c in zip(want, plain, got, at_last):
        np.testing.assert_array_equal(w, p)
        np.testing.assert_array_equal(g.numpy(), w)
        assert torch.equal(g, c)


@pytest.mark.parametrize("n,m", [(4096, 512), (2048, 256)])
def test_particlefilter_findindex_matches_pallas_interpret(n, m):
    cdf, u = pf_inputs(n, m, seed=n + m)
    want = np.asarray(ref_ops.particlefilter_findindex(cdf, u,
                                                       interpret=True))
    got = ops.particlefilter_findindex(torch.from_numpy(cdf),
                                       torch.from_numpy(u))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_particlefilter_counts_on_a_cdf_that_is_not_monotone():
    """A count, not a binary search: equal to the reference on any input,
    across more queries than one chunk of the plain version."""
    rng = np.random.RandomState(3)
    cdf = rng.uniform(size=2048).astype(np.float32)
    u = rng.uniform(size=ref.FINDINDEX_CHUNK + 512).astype(np.float32)
    want = np.asarray(ref_ops.particlefilter_findindex(cdf, u, bu=512,
                                                       interpret=True))
    got = ops.particlefilter_findindex(cdf, u, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)


def _cpu_calls():
    """Each kernel wrapper with small CPU operands."""
    sw = torch.from_numpy(sw_input(100, 0))
    sc = [torch.from_numpy(a) for a in sc_inputs(20, 12, 8, 0)]
    ca = [torch.from_numpy(a) for a in ca_inputs(64, 30, 5, 0)]
    pf = [torch.from_numpy(a) for a in pf_inputs(100, 40, 0)]
    return [(sw_mod.cum_normal_inv, (sw,), ref.cum_normal_inv),
            (sc_mod.streamcluster_dist, sc, ref.streamcluster_dist),
            (ca_mod.swap_cost, ca, ref.canneal_swap_cost),
            (pf_mod.find_index, pf, ref.particlefilter_findindex)]


@pytest.mark.parametrize("k", range(4))
def test_wrappers_take_plain_path_on_cpu_only(k):
    fn, args, plain = _cpu_calls()[k]
    before = fn.launches
    got, want = fn(*args), plain(*args)
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        assert torch.equal(g, w)
    assert fn.launches == before                  # no kernel launched


def _bad_calls():
    """(wrapper, operands) pairs each of which must raise ValueError."""
    sw = torch.from_numpy(sw_input(64, 0))
    p, c = (torch.from_numpy(a) for a in sc_inputs(16, 8, 4, 0))
    locs, fan, ca, cb = (torch.from_numpy(a) for a in ca_inputs(32, 16, 4, 0))
    cdf, u = (torch.from_numpy(a) for a in pf_inputs(64, 16, 0))
    meta = torch.device("meta")
    return {
        "sw_dtype": (sw_mod.cum_normal_inv, (sw.double(),)),
        "sw_shape": (sw_mod.cum_normal_inv, (sw.reshape(8, 8),)),
        "sw_stride": (sw_mod.cum_normal_inv, (sw[::2],)),
        "sw_device": (sw_mod.cum_normal_inv, (sw.to(meta),)),
        "sc_shape": (sc_mod.streamcluster_dist, (p, c[:, :3].contiguous())),
        "sc_stride": (sc_mod.streamcluster_dist, (p.t(), c)),
        "sc_device": (sc_mod.streamcluster_dist, (p, c.to(meta))),
        "ca_dtype": (ca_mod.swap_cost, (locs, fan.long(), ca, cb)),
        "ca_shape": (ca_mod.swap_cost, (locs, fan, ca[:8], cb)),
        "ca_locs": (ca_mod.swap_cost, (locs[:, :1].contiguous(), fan, ca, cb)),
        "ca_empty": (ca_mod.swap_cost, (locs[:0], fan, ca, cb)),
        "ca_stride": (ca_mod.swap_cost, (locs, fan[:, ::2], ca, cb)),
        "ca_device": (ca_mod.swap_cost, (locs, fan, ca.to(meta), cb)),
        "pf_dtype": (pf_mod.find_index, (cdf.double(), u)),
        "pf_shape": (pf_mod.find_index, (cdf, u.reshape(4, 4))),
        "pf_stride": (pf_mod.find_index, (cdf[::2], u)),
        "pf_device": (pf_mod.find_index, (cdf.to(meta), u.to(meta))),
    }


@pytest.mark.parametrize("bad", sorted(_bad_calls()))
def test_wrappers_reject_bad_operands(bad):
    fn, args = _bad_calls()[bad]
    with pytest.raises(ValueError):
        fn(*args)
