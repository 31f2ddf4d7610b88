"""Port parity: the Mamba-2 SSD oracle and the SSD scan kernel's wrapper.

The oracle ``repro_torch.models.ssm.ssd_chunked`` is held against the JAX
``repro.models.ssm._ssd_chunked`` — both ``y`` and the final state, with a
non-zero ``D_skip`` — at rtol = atol = 1e-5 where the chunk's float32 sums
allow it (chunks of up to 96 steps; the two sum in another order).  At a
128-step chunk, or under a steep decay, each of the two is up to ~2e-5 off
the float64 truth, so there both are held against a float64 recurrence
instead.  On the CPU, ``repro_torch.kernels.ops.ssd_scan`` takes its plain
version, and only because the tensors lie on the CPU; it is held against
the Pallas kernel in interpret mode at ``tests/test_kernels.py``'s shapes
and bar, 4e-3.  The CUDA kernel itself is held against its plain version on
the card by ``tests/test_torch_cuda.py``.  Inputs are drawn with numpy as
``tests/test_kernels.py`` draws them.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro.kernels import ref as jref
from repro.models.ssm import _ssd_chunked
from repro_torch.kernels import ops
from repro_torch.kernels import ssd_scan as ssd_mod
from repro_torch.models.ssm import ssd_chunked


def ssd_inputs(b, S, H, P, N, seed):
    """x, B, C: 0.5 N(0,1); dt: softplus N(0,1); A: -exp(0.3 N(0,1)); and a
    D-skip vector N(0,1)."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    x = (rng.standard_normal((b, S, H, P)) * 0.5).astype(f32)
    dt = np.log1p(np.exp(rng.standard_normal((b, S, H)))).astype(f32)
    A = (-np.exp(rng.standard_normal(H) * 0.3)).astype(f32)
    B = (rng.standard_normal((b, S, N)) * 0.5).astype(f32)
    C = (rng.standard_normal((b, S, N)) * 0.5).astype(f32)
    D = rng.standard_normal(H).astype(f32)
    return x, dt, A, B, C, D


def recurrence_f64(x, dt, A, B, C, D):
    """The SSD scan in its recurrent form, float64 numpy, step by step:
    state = exp(dt A) state + dt x (x) B, y = state C + D x."""
    b, S, H, P = x.shape
    x, dt, A, B, C, D = (a.astype(np.float64) for a in (x, dt, A, B, C, D))
    state = np.zeros((b, H, P, B.shape[-1]))
    y = np.empty_like(x)
    for t in range(S):
        state = (np.exp(dt[:, t] * A)[:, :, None, None] * state
                 + np.einsum("bhp,bn->bhpn", x[:, t] * dt[:, t, :, None],
                             B[:, t]))
        y[:, t] = np.einsum("bhpn,bn->bhp", state, C[:, t]) \
            + x[:, t] * D[None, :, None]
    return y, state


@pytest.mark.parametrize("S,chunk", [(256, 64), (96, 96), (64, 256)])
def test_oracle_matches_jax_ssd_chunked(S, chunk):
    """y and the final state, D-skip non-zero; chunk > S takes Q = S."""
    args = ssd_inputs(2, S, 4, 16, 32, S + chunk)
    want_y, want_state = _ssd_chunked(*(jnp.asarray(a) for a in args),
                                      chunk)
    got_y, got_state = ssd_chunked(*(torch.from_numpy(a) for a in args),
                                   chunk)
    assert got_y.dtype == torch.float32 and got_state.shape == (2, 4, 16, 32)
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_state.numpy(), np.asarray(want_state),
                               rtol=1e-5, atol=1e-5)


def normwise(got, truth):
    return float(np.abs(got - truth).max() / np.abs(truth).max())


@pytest.mark.parametrize("case", ["S512-chunk128", "steep-decay"])
def test_oracle_against_float64_recurrence(case):
    """Where float32 sums in two orders part by more than 1e-5 (a 128-step
    chunk; a steep decay, A = -40 |A|, whose running sums reach -1,000),
    both oracles are held against the float64 recurrence: y and the final
    state within 1e-5 of its largest value, the port's and the reference's
    alike (both measure ~1e-6).  The steep decay also shows the mask before
    the exponential (ssm.py:77-79): above the diagonal seg_t - seg_u passes
    88, where exp overflows float32 and inf * 0 would be NaN."""
    if case == "steep-decay":
        x, dt, A, B, C, D = ssd_inputs(1, 64, 2, 8, 16, 9)
        A = (-np.abs(A) * 40.0).astype(np.float32)
        seg = np.cumsum(dt[0, :, 0] * A[0])
        assert seg[0] - seg[-1] > 88.0         # exp overflows there
        args, chunk = (x, dt, A, B, C, D), 64
    else:
        args, chunk = ssd_inputs(2, 512, 4, 16, 32, 640), 128
    y64, s64 = recurrence_f64(*args)
    jy, js = (np.asarray(a) for a in
              _ssd_chunked(*(jnp.asarray(a) for a in args), chunk))
    ty, ts = (a.numpy() for a in
              ssd_chunked(*(torch.from_numpy(a) for a in args), chunk))
    assert np.isfinite(ty).all() and np.isfinite(ts).all()
    for name, got, truth in (("y", ty, y64), ("state", ts, s64),
                             ("reference y", jy, y64),
                             ("reference state", js, s64)):
        assert normwise(got, truth) <= 1e-5, (case, name,
                                              normwise(got, truth))


def test_oracle_keeps_a_bfloat16_x_type():
    args = ssd_inputs(1, 128, 2, 8, 16, 5)
    xs = [torch.from_numpy(a) for a in args]
    xs[0] = xs[0].to(torch.bfloat16)
    y, state = ssd_chunked(*xs, 64)
    assert y.dtype == torch.bfloat16 and state.dtype == torch.float32
    want, _ = ssd_chunked(xs[0].float(), *xs[1:], 64)
    torch.testing.assert_close(y.float(), want.to(torch.bfloat16).float())


@pytest.mark.parametrize("S,chunk", [(256, 64), (512, 128)])
def test_ssd_scan_matches_pallas_interpret(S, chunk):
    """tests/test_kernels.py:111-121: b 2, H 4, P 16, N 32, bar 4e-3."""
    x, dt, A, B, C, _ = ssd_inputs(2, S, 4, 16, 32, 2111 + S)
    want = ref_ops.ssd_scan(*(jnp.asarray(a) for a in (x, dt, A, B, C)),
                            chunk=chunk, interpret=True)
    before = ssd_mod.ssd_scan.launches
    got = ops.ssd_scan(x, dt, A, B, C, chunk=chunk, device="cpu")
    assert ssd_mod.ssd_scan.launches == before      # the plain version
    assert got.shape == x.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=4e-3,
                               atol=4e-3)
    # and the reference's own plain version, the jnp oracle with no D-skip
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jref.ssd_scan(
            *(jnp.asarray(a) for a in (x, dt, A, B, C)), chunk)),
        rtol=4e-3, atol=4e-3)


def test_ssd_scan_result_does_not_depend_on_the_chunk_but_by_rounding():
    """The kernel tiles by its own 64 steps; the plain version chunks at Q:
    any Q gives the same y within float32 rounding."""
    x, dt, A, B, C, _ = ssd_inputs(1, 384, 3, 16, 32, 4)
    ys = [ops.ssd_scan(x, dt, A, B, C, chunk=q, device="cpu")
          for q in (32, 64, 128, 384)]
    for y in ys[1:]:
        torch.testing.assert_close(y, ys[0], rtol=1e-4, atol=1e-4)


def test_ssd_scan_rejects_a_sequence_off_the_chunk():
    """The Pallas wrapper asserts S % Q == 0 (ssd_scan.py:63-64); the port
    raises at the same condition, on every device."""
    x, dt, A, B, C, _ = ssd_inputs(1, 96, 2, 8, 16, 1)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        ops.ssd_scan(x, dt, A, B, C, chunk=64, device="cpu")
    with pytest.raises(ValueError, match="not a multiple"):
        ssd_chunked(*(torch.from_numpy(a) for a in (x, dt, A, B, C)),
                    torch.zeros(2), 64)
    with pytest.raises(AssertionError):
        ref_ops.ssd_scan(*(jnp.asarray(a) for a in (x, dt, A, B, C)),
                         chunk=64, interpret=True)


@pytest.mark.parametrize("bad", ["dt-shape", "A-shape", "B-shape", "C-N",
                                 "x-3d"])
def test_ssd_scan_rejects_bad_operands(bad):
    x, dt, A, B, C, _ = (torch.from_numpy(a)
                         for a in ssd_inputs(1, 64, 2, 8, 16, 2))
    if bad == "dt-shape":
        dt = dt[:, :, :1].contiguous()
    elif bad == "A-shape":
        A = torch.cat([A, A])
    elif bad == "B-shape":
        B = B[:, :32].contiguous()
    elif bad == "C-N":
        C = C[..., :8].contiguous()
    else:
        x = x[0]
    with pytest.raises(ValueError, match="ssd_scan"):
        ssd_mod.ssd_scan(x, dt, A, B, C, chunk=64)
