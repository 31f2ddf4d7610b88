"""Port parity: the operand types and head widths the port once refused.

The reference runs JAX with 64-bit types off and its Pallas kernels widen
every operand to float32 inside the kernel and take any head width, so it
computes mixed types, integer operands, 64-bit arrays and heads past 256.
The port converts such operands by the same rule in front of the kernel
(``repro_torch.kernels._promote``).  The same seeded numpy inputs go
through ``repro.kernels.ops`` (the Pallas kernels in interpret mode on the
CPU) and through ``repro_torch.kernels.ops(..., device="cpu")`` or the
kernel module's own wrapper (each takes its plain version, because the
tensors lie on the CPU).  The output type must be the reference's and the
values agree at the bars of ``tests/test_kernels.py``: 2e-4 in float32,
2e-2 for 16-bit attention, 1e-2 for 16-bit streamcluster, 4e-3 for the
SSD scan.  An integer output may be one unit off: truncating a float32 sum
rounded differently can move a value across an integer.  The CUDA side of
the same conversions is held on the card by ``tests/test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro_torch.kernels import _promote
from repro_torch.kernels import decode_attention as da_mod
from repro_torch.kernels import flash_attention as fa_mod
from repro_torch.kernels import ops
from repro_torch.kernels import ssd_scan as ssd_mod
from repro_torch.kernels import streamcluster as sc_mod

NP = {"float32": np.float32, "float64": np.float64, "int32": np.int32,
      "int64": np.int64}
JDT = {"float32": jnp.float32, "float64": jnp.float64, "int32": jnp.int32,
       "int64": jnp.int64, "bfloat16": jnp.bfloat16, "float16": jnp.float16}
TDT = {"float32": torch.float32, "float64": torch.float64,
       "int32": torch.int32, "int64": torch.int64,
       "bfloat16": torch.bfloat16, "float16": torch.float16}
# the reference's (JAX, 64-bit types off) type of each input type
NARROWED = {"float64": "float32", "int64": "int32"}


def draw(shape, seed, dtype, scale=1.0):
    """A numpy array of ``dtype`` from a seed: small integers for the
    integer types, else normals (rounded to 16 bits for a 16-bit type, kept
    as float32 numpy)."""
    rng = np.random.RandomState(seed)
    if dtype.startswith("int"):
        return rng.randint(-3, 4, shape).astype(NP[dtype])
    a = rng.standard_normal(shape) * scale
    if dtype in ("bfloat16", "float16"):
        return torch.from_numpy(a).to(TDT[dtype]).float().numpy()
    return a.astype(NP[dtype])


def to_jax(a, dtype):
    return jnp.asarray(a, JDT[NARROWED.get(dtype, dtype)])


def to_torch(a, dtype):
    return torch.from_numpy(np.ascontiguousarray(a)).to(TDT[dtype])


def close(got, want, tol):
    """Values at ``tol``; an integer output within one unit."""
    want = np.asarray(want)
    if np.issubdtype(want.dtype, np.integer):
        assert np.abs(got.numpy().astype(np.int64)
                      - want.astype(np.int64)).max() <= 1
        return
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(np.float32)),
                               rtol=tol, atol=tol)


def out_type(dtype):
    return TDT[NARROWED.get(dtype, dtype)]


# ---- the rule itself ------------------------------------------------------

@pytest.mark.parametrize("types,kept,out", [
    (("float32", "float32"), "float32", "float32"),
    (("bfloat16", "bfloat16"), "bfloat16", "bfloat16"),
    (("float64", "float64"), "float32", "float32"),
    (("bfloat16", "float32"), "float32", "bfloat16"),
    (("int32", "float16"), "float32", "int32"),
    (("int64", "int64"), "float32", "int32")])
def test_promote_narrows_then_widens_to_float32(types, kept, out):
    ts = [torch.zeros(2, 3, dtype=TDT[t]) for t in types]
    got, out_dtype = _promote.promote(ts, fa_mod.DTYPES)
    assert [t.dtype for t in got] == [TDT[kept]] * len(ts)
    assert out_dtype == TDT[out]
    assert _promote.restore(torch.tensor([2.7, -2.7]), torch.int32).tolist() \
        == [2, -2]                       # truncation toward zero


def test_promote_leaves_what_the_checks_refuse():
    """Non-tensors and complex tensors are the wrapper's checks' to name;
    a strided operand stays strided (the check refuses it)."""
    q = torch.zeros(2, 3, 4, 5)
    assert _promote.promote([q, [1.0]], fa_mod.DTYPES)[1] is None
    z = torch.zeros(2, dtype=torch.complex64)
    assert _promote.promote([z], fa_mod.DTYPES)[0][0] is z
    t = torch.zeros(4, 6, dtype=torch.float64).t()
    assert not _promote.promote([t], fa_mod.DTYPES)[0][0].is_contiguous()


# ---- flash attention ------------------------------------------------------

def fa_pair(types, D, causal, seed, S=16):
    """(reference output, port output via ops, port output via the module)
    for q, k, v of ``types``, ``[1, S, 2, D]``."""
    arrs = [draw((1, S, 2, D), seed + i, t) for i, t in enumerate(types)]
    want = ref_ops.flash_attention(
        *(to_jax(a, t) for a, t in zip(arrs, types)), bq=S, bk=S,
        causal=causal, interpret=True)
    ts = [to_torch(a, t) for a, t in zip(arrs, types)]
    counters = lambda: {n: getattr(fa_mod.flash_attention, n)
                        for n in set(fa_mod.COUNTERS.values())}
    before = counters()
    got = ops.flash_attention(*ts, causal=causal, device="cpu")
    got_mod = fa_mod.flash_attention(*ts, causal=causal)
    assert counters() == before   # the plain version: no route's launch
    return want, got, got_mod


@pytest.mark.parametrize("D", [257, 320])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_past_256_columns(D, dtype, causal):
    """fa_wide, once refused: the reference takes any D."""
    want, got, got_mod = fa_pair((dtype,) * 3, D, causal, D)
    assert got.dtype == TDT[dtype] and got.shape == (1, 16, 2, D)
    close(got, want, 2e-4 if dtype == "float32" else 2e-2)
    assert torch.equal(got, got_mod)


@pytest.mark.parametrize("types", [
    ("float32", "bfloat16", "float32"),      # fa_mixed, once refused
    ("bfloat16", "float16", "float32"),
    ("float16", "float32", "float32"),
    ("bfloat16", "bfloat16", "float16")])
@pytest.mark.parametrize("D", [64, 257])
def test_flash_attention_mixed_types(types, D):
    """Widened to float32 inside, q's type out."""
    want, got, got_mod = fa_pair(types, D, True, 7)
    assert got.dtype == TDT[types[0]] and want.dtype == JDT[types[0]]
    close(got, want, 2e-4 if types[0] == "float32" else 2e-2)
    assert torch.equal(got, got_mod)


@pytest.mark.parametrize("types", [
    ("int32", "int32", "int32"), ("int32", "float32", "bfloat16"),
    ("float32", "int32", "int32")])
@pytest.mark.parametrize("D", [16, 320])
def test_flash_attention_integer_operands(types, D):
    """Computed in float32 and truncated to q's integer type."""
    want, got, got_mod = fa_pair(types, D, True, 11)
    assert got.dtype == TDT[types[0]] and want.dtype == JDT[types[0]]
    close(got, want, 2e-4 if types[0] == "float32" else 2e-2)
    assert torch.equal(got, got_mod)


@pytest.mark.parametrize("dtype", ["float64", "int64"])
@pytest.mark.parametrize("D", [32, 257])
def test_flash_attention_64bit_tensors(dtype, D):
    """fa_dtype, once refused: a float64 or int64 tensor is narrowed, as
    the reference narrows the same numpy array."""
    want, got, got_mod = fa_pair((dtype,) * 3, D, False, 13)
    assert got.dtype == out_type(dtype)
    close(got, want, 2e-4)
    assert torch.equal(got, got_mod)


# ---- flash decoding -------------------------------------------------------

def da_pair(q_type, k_type, v_type, D, seed, S=64, lens=(0, 17, 64)):
    B, H = len(lens), 3
    q = draw((B, H, D), seed, q_type)
    k = draw((B, S, H, D), seed + 1, k_type)
    v = draw((B, S, H, D), seed + 2, v_type)
    lens = np.asarray(lens, np.int32)
    want = ref_ops.decode_attention(to_jax(q, q_type), to_jax(k, k_type),
                                    to_jax(v, v_type), lens, bk=32,
                                    interpret=True)
    tq, tk, tv = to_torch(q, q_type), to_torch(k, k_type), to_torch(v, v_type)
    before = (da_mod.decode_attention.launches,
              da_mod.decode_attention.combine_launches)
    got = ops.decode_attention(tq, tk, tv, lens, device="cpu")
    got_mod = da_mod.decode_attention(tq, tk, tv, torch.from_numpy(lens))
    assert (da_mod.decode_attention.launches,
            da_mod.decode_attention.combine_launches) == before
    return want, got, got_mod


@pytest.mark.parametrize("q_type,k_type,v_type", [
    ("float32", "float32", "float32"),
    ("bfloat16", "bfloat16", "bfloat16"),
    ("float32", "float32", "float16"),       # da_mixed, once refused
    ("bfloat16", "float16", "bfloat16"),
    ("float32", "int32", "int32"),           # da_dtype, once refused
    ("int32", "float32", "int32")])
def test_decode_attention_types_at_300_columns(q_type, k_type, v_type):
    """D 300 (once refused past 256), k and v of two types, integer caches
    and an integer query; kv_len 0 (the mean of V), 17 and S."""
    want, got, got_mod = da_pair(q_type, k_type, v_type, 300, 21)
    assert got.dtype == TDT[q_type] and want.dtype == JDT[q_type]
    eps = torch.finfo(TDT[q_type]).eps if q_type != "int32" else 0
    close(got, want, 2e-4 + eps * (q_type != "float32"))
    assert torch.equal(got, got_mod)


@pytest.mark.parametrize("dtype", ["float64", "int64"])
def test_decode_attention_64bit_tensors(dtype):
    want, got, got_mod = da_pair(dtype, dtype, dtype, 40, 23)
    assert got.dtype == out_type(dtype)
    close(got, want, 2e-4)
    assert torch.equal(got, got_mod)


# ---- streamcluster --------------------------------------------------------

def sc_pair(p_type, c_type, seed):
    p, c = draw((64, 24), seed, p_type), draw((48, 24), seed + 1, c_type)
    want = ref_ops.streamcluster_dist(to_jax(p, p_type), to_jax(c, c_type),
                                      bm=32, bn=16, interpret=True)
    tp, tc = to_torch(p, p_type), to_torch(c, c_type)
    before = sc_mod.streamcluster_dist.launches
    got = ops.streamcluster_dist(tp, tc, device="cpu")
    got_mod = sc_mod.streamcluster_dist(tp, tc)
    assert sc_mod.streamcluster_dist.launches == before
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    assert torch.equal(got, got_mod)
    return want, got


@pytest.mark.parametrize("p_type,c_type,tol", [
    ("bfloat16", "float32", 1e-2),           # sc_mixed, once refused
    ("float32", "float16", 1e-2),
    ("int32", "int32", 2e-4),
    ("int32", "float32", 2e-4),
    ("float64", "float64", 2e-4),            # sc_dtype, once refused
    ("int64", "int64", 2e-4)])
def test_streamcluster_types(p_type, c_type, tol):
    """Points and centers of two types, integer points, 64-bit tensors:
    float32 out, always."""
    want, got = sc_pair(p_type, c_type, 31)
    close(got, want, tol)


# ---- the SSD scan ---------------------------------------------------------

def ssd_arrays(seed, x_type, other="float32"):
    rng = np.random.default_rng(seed)
    b, S, H, P, N = 1, 128, 2, 16, 32
    x = (rng.integers(-3, 4, (b, S, H, P)) if x_type.startswith("int")
         else rng.standard_normal((b, S, H, P)) * 0.5).astype(NP[x_type])
    rest = (np.log1p(np.exp(rng.standard_normal((b, S, H)))),
            -np.exp(rng.standard_normal(H) * 0.3),
            rng.standard_normal((b, S, N)) * 0.5,
            rng.standard_normal((b, S, N)) * 0.5)
    return [x] + [a.astype(NP[other]) for a in rest]


@pytest.mark.parametrize("x_type,other", [
    ("int32", "float32"),                    # int-x, once refused
    ("int64", "float32"),
    ("float64", "float64"),
    ("float32", "float64")])
def test_ssd_scan_types(x_type, other):
    """Integer x (computed in float32, truncated to x's type) and 64-bit
    tensors (narrowed, on the CPU as on the card)."""
    arrs = ssd_arrays(41, x_type, other)
    types = [x_type] + [other] * 4
    want = ref_ops.ssd_scan(*(to_jax(a, t) for a, t in zip(arrs, types)),
                            chunk=64, interpret=True)
    ts = [to_torch(a, t) for a, t in zip(arrs, types)]
    before = ssd_mod.ssd_scan.launches
    got = ops.ssd_scan(*ts, chunk=64, device="cpu")
    got_mod = ssd_mod.ssd_scan(*ts, chunk=64)
    assert ssd_mod.ssd_scan.launches == before
    assert got.dtype == out_type(x_type) and got.shape == ts[0].shape
    close(got, want, 4e-3)
    assert torch.equal(got, got_mod)
