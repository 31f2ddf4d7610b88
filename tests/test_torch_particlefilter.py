"""Port parity: the particle filter's find-index on the inputs its edges
hold, and the identity its search path rests on.

The CUDA kernel computes ``min(count(cdf < u), N - 1)`` on every float32
input, by a search where the CDF passes ``cdf[i] <= cdf[i+1]`` (checked on
the card) and by the count otherwise.  On the CPU the wrapper takes the
plain version, ``ref.particlefilter_findindex`` (the count).  Here:

- a property test: on every array that passes the check, a lower-bound
  search laid out as the kernel's (a sample of every ``stride``-th entry,
  then the window it leaves) equals the plain count, clamped to N - 1, for
  any query, with ±0.0, ±inf and NaN among the values;
- the plain version against the reference's Pallas kernel in interpret
  mode (tile sizes dividing M and N, as ``test_torch_suite_kernels.py``
  runs it) on each edge case, bit for bit.

The kernels themselves are held against the plain version on the card by
``tests/test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.kernels import ops as ref_ops
from repro.kernels import ref as jref
from repro_torch.kernels import ops, ref

SPECIALS = [-np.inf, -1.0, -0.0, 0.0, 0.5, 1.0, np.inf, np.nan]
F32 = st.floats(width=32, allow_nan=False)


def passes_check(cdf: np.ndarray) -> bool:
    """The check kernel's test: every adjacent pair non-decreasing (a NaN
    fails it)."""
    return bool(np.all(cdf[:-1] <= cdf[1:]))


def sampled_lower_bound(cdf: np.ndarray, q: float, stride: int) -> int:
    """The kernel's search path for one query: the first i with !(cdf[i] <
    q), found first among every ``stride``-th entry, then in the window of
    entries the sample leaves; clamped to N - 1."""
    n = cdf.shape[0]
    sample = cdf[::stride]
    k = 0
    while k < sample.shape[0] and sample[k] < q:
        k += 1
    if k == 0:
        count = 0
    else:
        count, hi = (k - 1) * stride + 1, min(k * stride, n)
        while count < hi and cdf[count] < q:
            count += 1
    return min(count, n - 1)


@settings(max_examples=300, deadline=None, derandomize=True)
@given(values=st.lists(st.one_of(st.sampled_from(SPECIALS[:-1]), F32),
                       min_size=1, max_size=200),
       queries=st.lists(st.one_of(st.sampled_from(SPECIALS), F32),
                        min_size=1, max_size=40),
       stride=st.sampled_from([1, 2, 3, 64]),
       lone_nan=st.booleans())
def test_search_equals_the_count_on_every_array_that_passes_the_check(
        values, queries, stride, lone_nan):
    """Sorted (stably, so -0.0 and 0.0 keep their drawn order) arrays of
    specials and float32 values, and the one-entry NaN array (no pair, so
    it passes too)."""
    cdf = np.sort(np.array(values, np.float32), kind="stable")
    if lone_nan:
        cdf = np.array([np.nan], np.float32)
    assert passes_check(cdf)
    u = np.array(queries, np.float32)
    want = ref.particlefilter_findindex(torch.from_numpy(cdf),
                                        torch.from_numpy(u)).numpy()
    got = [sampled_lower_bound(cdf, q, stride) for q in u]
    np.testing.assert_array_equal(got, want)


def test_the_check_fails_where_the_count_and_the_search_differ():
    """Off the check's domain the two differ, so the kernel must count
    there: an unsorted CDF, and a NaN between two entries."""
    for cdf, q in ((np.array([0.0, 1.0, 0.5], np.float32), 0.6),
                   (np.array([0.0, np.nan, 1.0, 2.0], np.float32), 1.5)):
        assert not passes_check(cdf)
        u = torch.tensor([q], dtype=torch.float32)
        count = int(ref.particlefilter_findindex(torch.from_numpy(cdf), u))
        assert count != sampled_lower_bound(cdf, q, 1)


def edge_cases():
    """(cdf, u) of each edge the kernel's two paths must agree on."""
    f = lambda *a: np.array(a, np.float32)
    rng = np.random.RandomState(18)
    ragged = np.sort(rng.uniform(size=1000).astype(np.float32))
    return {
        "ties": (f(0, .25, .25, .5, .5, .5, .75, 1),
                 f(0, .25, .5, .75, 1, .3, .5, .25)),
        "signed-zeros": (f(-1, -0.0, 0.0, -0.0, 0.0, 1),
                         f(0.0, -0.0, 1e-30, -1e-30, -1, 1)),
        "infinities": (f(-np.inf, -np.inf, 0, 1, np.inf, np.inf),
                       f(-np.inf, np.inf, 0.5, 1, 1e38)),
        "nan-in-cdf": (f(0, 0.5, np.nan, 1), f(0, 0.25, 0.75, 2)),
        "nan-queries": (f(0, 0.5, 1), f(np.nan, 0.5, np.nan, 2)),
        "one-entry": (f(0.5), f(0, 0.5, 1, np.nan)),
        "one-query": (ragged, f(0.3)),
        "above-the-last": (f(0, 0.5, 1), f(1.5, 2, np.inf, 1)),
        "ragged": (ragged, rng.uniform(-0.1, 1.1, 37).astype(np.float32)),
    }


@pytest.mark.parametrize("case", list(edge_cases()))
def test_plain_matches_pallas_interpret_on_the_edges(case):
    cdf, u = edge_cases()[case]
    n, m = cdf.shape[0], u.shape[0]
    bu, bc = min(256, m), min(2048, n)
    assert m % bu == 0 and n % bc == 0
    want = np.asarray(ref_ops.particlefilter_findindex(
        jnp.asarray(cdf), jnp.asarray(u), bu=bu, bc=bc, interpret=True))
    got = ops.particlefilter_findindex(cdf, u, device="cpu")
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    if passes_check(cdf):
        np.testing.assert_array_equal(
            [sampled_lower_bound(cdf, q, 2) for q in u], want)


def test_no_queries():
    """M = 0: nothing to search (the Pallas kernel's grid needs M > 0, so
    the reference's plain version is the oracle)."""
    cdf = np.array([0, 0.5, 1], np.float32)
    u = np.zeros(0, np.float32)
    got = ops.particlefilter_findindex(cdf, u, device="cpu")
    want = np.asarray(jref.particlefilter_findindex(jnp.asarray(cdf),
                                                    jnp.asarray(u)))
    assert got.dtype == torch.int32 and got.shape == (0,) == want.shape
