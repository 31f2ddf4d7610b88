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


# ---- the chunk-parallel kernels' algebra ------------------------------------

def three_pass_mirror(x, dt, A, B, C, steps=64, chunk=512):
    """csrc/ssd_scan.cu's decomposition in torch float32, kept here as the
    check of its algebra: (a) each chunk's end state from zero, walked in
    tiles of ``steps``, with its sum of dt A; (b) in chunk order, the state
    each chunk starts from; (c) each chunk again from that state, tile by
    tile: y = (C B^T o exp(seg_t - seg_u), u <= t) (x dt) + exp(seg_t) C
    state, then state = exp(seg_end) state + (x dt exp(seg_end - seg))^T B.
    Returns y and the largest exponent it formed (never above 0 for A <=
    0: the decay between tiles is factored at their boundary, through the
    carried state)."""
    x, dt, A, B, C = (torch.from_numpy(a) for a in (x, dt, A, B, C))
    b, S, H, P = x.shape
    N = B.shape[-1]
    top = [-float("inf")]

    def exp(t):
        if t.numel():
            top[0] = max(top[0], float(t.max()))
        return torch.exp(t)

    def walk(c, state, emit):
        ys, total = [], torch.zeros(b, H)
        for t0 in range(c * chunk, min(S, (c + 1) * chunk), steps):
            sl = slice(t0, min(S, t0 + steps))
            d = dt[:, sl]                                      # [b, n, H]
            seg = torch.cumsum(d * A, dim=1)
            xd = x[:, sl] * d[..., None]                       # [b, n, H, P]
            Bt, Ct = B[:, sl], C[:, sl]
            if emit:
                n = d.shape[1]
                tri = torch.ones(n, n, dtype=torch.bool).tril()
                diff = seg[:, :, None, :] - seg[:, None, :, :]  # [b, t, u, H]
                decay = torch.zeros_like(diff)
                decay[:, tri] = exp(diff[:, tri])
                w = torch.einsum("btn,bun->btu", Ct, Bt)[..., None] * decay
                ys.append(torch.einsum("btuh,buhp->bthp", w, xd)
                          + exp(seg)[..., None]
                          * torch.einsum("btn,bhpn->bthp", Ct, state))
            end = seg[:, -1]                                   # [b, H]
            sd = exp(end[:, None] - seg)
            state = (torch.exp(end)[..., None, None] * state
                     + torch.einsum("buhp,bun,buh->bhpn", xd, Bt, sd))
            total = total + end
        return state, total, ys

    n_chunks = -(-S // chunk)
    zero = torch.zeros(b, H, P, N)
    own = [walk(c, zero, False)[:2] for c in range(n_chunks)]      # (a)
    starts, cur = [], zero
    for Z, total in own:                                           # (b)
        starts.append(cur)
        cur = torch.exp(total)[..., None, None] * cur + Z
    y = torch.cat([torch.cat(walk(c, starts[c], True)[2], dim=1)   # (c)
                   for c in range(n_chunks)], dim=1)
    return y.numpy(), top[0]


@pytest.mark.parametrize("S,steps,steep", [(1152, 64, False),
                                           (1152, 32, False),
                                           (576, 64, True)],
                         ids=["three-chunks", "32-step-tiles",
                              "steep-decay"])
def test_three_pass_mirror_matches_pallas_and_float64(S, steps, steep):
    """Chunks of 512 steps (the last one ragged), held against the Pallas
    kernel in interpret mode (4e-3, its chunk 64) and against the float64
    recurrence (1e-5 of its largest value); a steep decay (A = -40 |A|,
    running sums past -88, where exp(seg_u - seg_t) overflows float32)
    stays finite, and no exponent the mirror forms is positive."""
    x, dt, A, B, C, _ = ssd_inputs(2, S, 2, 8, 16, S + steps)
    if steep:
        A = (-np.abs(A) * 40.0).astype(np.float32)
        assert np.cumsum(dt[0, :64, 0] * A[0])[-1] < -88.0
    got, top = three_pass_mirror(x, dt, A, B, C, steps=steps)
    assert np.isfinite(got).all() and top <= 0.0
    want = ref_ops.ssd_scan(*(jnp.asarray(a) for a in (x, dt, A, B, C)),
                            chunk=64, interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), rtol=4e-3, atol=4e-3)
    y64, _ = recurrence_f64(x, dt, A, B, C, np.zeros(2, np.float32))
    assert normwise(got, y64) <= 1e-5, normwise(got, y64)


@pytest.mark.parametrize("S,H,P,N,want", [
    (65_536, 16, 64, 128, (32, 64, 1, 4, 128, 64, 0)),  # the suite's size
    (16_384, 16, 256, 128, (32, 64, 4, 4, 32, 64, 0)),  # P 256: four slices
    (1100, 3, 129, 40, (64, 43, 3, 2, 3, 64, 0)),       # 129: three of 43
    (600, 1, 16, 360, (32, 16, 1, 1, 2, 64, 0)),        # one head; 32 steps
    (600, 4, 1, 409, (32, 1, 1, 2, 2, 64, 0)),
    (96, 2, 128, 512, (32, 64, 2, 2, 1, 64, 256)),      # two N-panels
    (1100, 4, 64, 417, (64, 64, 1, 1, 3, 64, 216)),     # just past 416
    (96, 2, 128, 1024, (32, 64, 2, 1, 1, 64, 344)),     # 344 + 344 + 336
    (96, 1, 16, 2048, (32, 16, 1, 1, 1, 64, 688))])
def test_ssd_plan(S, H, P, N, want):
    """P-slices of at most 64 columns, equal but the last; then the first
    (tile steps, heads a block) of OUTPUT_SHAPES whose output-pass block
    fits 227 KB, and 64-step tiles for the chunk pass where its block
    fits; chunks of 512 steps.  Where no block holds the whole state, the
    fewest N-panels of a multiple of 8 columns with which one does."""
    pl = ssd_mod.plan(S, H, P, N)
    assert tuple(pl) == want
    nw = pl.panel or N
    assert ssd_mod.smem_bytes(pl.steps, pl.width, nw, pl.heads, True) \
        <= ssd_mod.MAX_SMEM
    assert ssd_mod.smem_bytes(pl.chunk_steps, pl.width, nw, 1, False) \
        <= ssd_mod.MAX_SMEM


def test_ssd_plan_refuses_nothing_the_one_block_kernel_took():
    """The one-block kernel (P-slices of at most 128 columns holding the
    state, a tile of x dt, B and C transposed and the decay block) took
    every (P, N) whose block fit 227 KB; the plan takes each of them on
    one N-panel.  A state it refused, (P 128, N 512), now takes two
    N-panels of 256, whose shares of y add up to the plain version's y
    (4e-3)."""
    def took(P, N):
        ps = -(-P // -(-P // 128))
        return 4 * (N * ps + 64 * ps + 2 * N * 65 + 64 * 65 + 256) \
            <= 232_448
    for P in (*range(1, 70), 127, 128, 129, 192, 256, 257, 512):
        for N in range(1, 420):
            if took(P, N):
                assert ssd_mod.plan(1024, 2, P, N).panel == 0
    pl = ssd_mod.plan(96, 2, 128, 512)
    assert pl.panel == 256
    x, dt, A, B, C, _ = ssd_inputs(1, 96, 2, 128, 512, 3)
    got = panel_mirror(x, dt, A, B, C, pl.panel, steps=pl.steps)
    want = ops.ssd_scan(x, dt, A, B, C, chunk=32, device="cpu")
    np.testing.assert_allclose(got, want.numpy(), rtol=4e-3, atol=4e-3)


def panel_mirror(x, dt, A, B, C, panel, steps=64, chunk=512):
    """csrc/ssd_scan.cu's N-panel route in torch float32: each panel of
    ``panel`` columns of B and C (the last ragged) runs the three passes
    on its own columns alone, which yields its share of y, (C_p B_p^T o
    decay) (x dt) + exp(seg) C_p state_p; pass (d) adds the shares in
    panel order."""
    N = B.shape[-1]
    y = None
    for n0 in range(0, N, panel):
        share, top = three_pass_mirror(x, dt, A, B[..., n0:n0 + panel],
                                       C[..., n0:n0 + panel], steps, chunk)
        assert top <= 0.0
        y = share if y is None else y + share
    return y


@pytest.mark.parametrize("N,P", [(512, 128), (1024, 128), (1024, 8)])
def test_panel_mirror_matches_float64_and_the_plain_version(N, P):
    """The N-panel algebra at the plan's own panels (N 512: two of 256; N
    1,024: 344, 344 and 336), over two 512-step chunks (the second ragged)
    and 32-step tiles: against the float64 recurrence (1e-5 of its largest
    value) and the plain version (4e-3)."""
    S, H = 576, 2
    pl = ssd_mod.plan(S, H, P, N)
    assert pl.panel and -(-N // pl.panel) > 1
    x, dt, A, B, C, _ = ssd_inputs(1, S, H, P, N, N + P)
    got = panel_mirror(x, dt, A, B, C, pl.panel, steps=pl.steps)
    assert np.isfinite(got).all()
    y64, _ = recurrence_f64(x, dt, A, B, C, np.zeros(H, np.float32))
    assert normwise(got, y64) <= 1e-5, normwise(got, y64)
    want = ops.ssd_scan(x, dt, A, B, C, chunk=64, device="cpu")
    np.testing.assert_allclose(got, want.numpy(), rtol=4e-3, atol=4e-3)
