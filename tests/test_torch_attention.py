"""Port parity: the flash-attention and flash-decoding kernels.

On the CPU each ``repro_torch.kernels.ops`` wrapper takes its kernel's
plain PyTorch version, and only because the tensors lie on the CPU.  The
same seeded numpy inputs go through ``repro.kernels.ops`` with
``interpret=True`` (the Pallas kernels on the CPU), at the shapes and bars
of ``tests/test_kernels.py``: 2e-4 in float32 and 2e-2 in bfloat16 for flash
attention, 2e-4 for decoding.  The CUDA kernels themselves are held against
their plain versions on the card by ``tests/test_torch_cuda.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro.kernels import ref as jref
from repro_torch.kernels import decode_attention as da_mod
from repro_torch.kernels import flash_attention as fa_mod
from repro_torch.kernels import ops, ref


def qkv(shape, seed):
    rng = np.random.RandomState(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


def decode_inputs(B, S, H, D, seed):
    rng = np.random.RandomState(seed)
    return (rng.standard_normal((B, H, D)).astype(np.float32),
            rng.standard_normal((B, S, H, D)).astype(np.float32),
            rng.standard_normal((B, S, H, D)).astype(np.float32))


@pytest.mark.parametrize("S,bq,bk", [(256, 128, 128), (512, 128, 256)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_matches_pallas_interpret(S, bq, bk, causal, dtype):
    """bfloat16 inputs are the same float32 arrays cast on both sides."""
    B, H, D = 2, 2, 64
    arrs = qkv((B, S, H, D), seed=S + bq + causal)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = getattr(torch, dtype)
    want = ref_ops.flash_attention(*(jnp.asarray(a).astype(jdt)
                                     for a in arrs),
                                   bq=bq, bk=bk, causal=causal,
                                   interpret=True)
    got = ops.flash_attention(*(torch.from_numpy(a).to(tdt) for a in arrs),
                              causal=causal)
    assert got.dtype == tdt and got.shape == (B, S, H, D)
    tol = 2e-2 if dtype == "bfloat16" else 2e-4
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("S,D,causal", [(100, 64, True), (37, 128, False),
                                        (1, 40, True)])
def test_flash_attention_ragged_matches_reference(S, D, causal):
    """S off every tile and D off 64, against the reference's oracle."""
    arrs = qkv((2, S, 3, D), seed=S + D)
    want = np.asarray(jref.flash_attention(*(jnp.asarray(a) for a in arrs),
                                           causal=causal))
    got = ops.flash_attention(*arrs, causal=causal, device="cpu")
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("S,bk,kv_len", [(256, 64, 100), (512, 128, 512)])
def test_decode_attention_matches_pallas_interpret(S, bk, kv_len):
    B, H, D = 2, 4, 64
    q, k, v = decode_inputs(B, S, H, D, seed=S + kv_len)
    want = np.asarray(ref_ops.decode_attention(
        q, k, v, jnp.full((B,), kv_len), bk=bk, interpret=True))
    got = ops.decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), kv_len)
    assert got.dtype == torch.float32 and got.shape == (B, H, D)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)


def test_decode_attention_per_batch_lengths_match_pallas_interpret():
    """One length per batch entry, including one past S, against the
    Pallas kernel and against the reference oracle batch by batch."""
    B, S, H, D = 4, 256, 2, 64
    q, k, v = decode_inputs(B, S, H, D, seed=11)
    lens = np.array([1, 77, 256, 300], np.int32)
    want = np.asarray(ref_ops.decode_attention(q, k, v, lens, bk=64,
                                               interpret=True))
    got = ops.decode_attention(q, k, v, torch.from_numpy(lens), device="cpu")
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)
    oracle = jax.vmap(lambda qq, kk, vv, n: jref.decode_attention(
        qq[None], kk[None], vv[None], n)[0])(q, k, v, jnp.asarray(lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(oracle), rtol=2e-4,
                               atol=2e-4)


def test_decode_attention_at_zero_length_is_the_mean_of_v():
    """kv_len = 0 masks every key with the Pallas kernel's finite -1e30, so
    each key weighs the same: the result is the mean of V over all S."""
    B, S, H, D = 2, 256, 4, 64
    q, k, v = decode_inputs(B, S, H, D, seed=5)
    want = np.asarray(ref_ops.decode_attention(q, k, v, jnp.zeros((B,)),
                                               bk=64, interpret=True))
    got = ops.decode_attention(q, k, v, 0, device="cpu").numpy()
    np.testing.assert_allclose(want, v.mean(1), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(
        got, want, rtol=2e-4, atol=2e-4,
        err_msg="at kv_len = 0 the port follows the Pallas kernel (the mean "
                "of V, from its finite NEG_INF mask), not repro/kernels/"
                "ref.py, whose -inf mask gives NaN there")
    oracle = np.asarray(jref.decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 0))
    assert np.isnan(oracle).all()


@pytest.mark.parametrize("B,S,H,D,lens", [
    (7, 1000, 2, 64, "boundaries"),      # S off the split
    (3, 100, 3, 1, (5, 100, 0)),         # one element a head
    (2, 300, 2, 1000, (299, 7)),         # pieces past 512 columns
    (4, 256, 4096 // 4, 16, (0, 1, 255, 256)),
    (1, 4096, 1, 63, (4000,))])
def test_decode_split_partials_merge_to_the_reference(B, S, H, D, lens):
    """The split-KV plan and the plain versions of its two kernels: each
    split's partial softmax, merged in split order, is the plain
    decoding's result (2e-4), kv_len 0 the mean of V; a split at or past
    kv_len is neutral."""
    rng = np.random.RandomState(B + D)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((B, H, D), (B, S, H, D), (B, S, H, D)))
    pl = da_mod.plan(B, S, H, D, 4, True, 132)
    if lens == "boundaries":
        lens = (0, 1, pl.len - 1, pl.len, pl.len + 1, S, S + 3)
    lens = torch.tensor(lens, dtype=torch.int32)
    assert pl.ns == -(-S // pl.len)
    ws = da_mod.split_plain(q, k, v, lens, pl)
    got = da_mod.combine_plain(ws, lens, pl, S, q.shape, q.dtype)
    torch.testing.assert_close(got, ref.decode_attention(q, k, v, lens),
                               rtol=2e-4, atol=2e-4)
    ml = ws[:B * pl.ns * H * 2].view(B, pl.ns, H, 2)
    for b, n in enumerate(lens.tolist()):
        n = S if n <= 0 else min(n, S)
        past = ml[b, -(-n // pl.len):]
        assert (past[..., 0] == ref.NEG_INF).all() and (past[..., 1] == 0).all()


@pytest.mark.parametrize("B,S,H,D,kv_size,aligned,want", [
    # the app's shape: 64 threads read a key position's 8 heads (1 KB of
    # bf16) as 16-byte pieces, 4 positions at once, splits of 256 keys
    # (512 from a float32 cache)
    (32, 4096, 8, 64, 2, True, (256, 16, 8, 1, 8, 8, 1)),
    (32, 4096, 8, 64, 4, True, (512, 8, 4, 1, 16, 8, 1)),
    (32, 4096, 8, 64, 2, False, (256, 16, 1, 2, 32, 8, 1)),
    (8, 4096, 8, 512, 2, True, (64, 64, 8, 2, 32, 8, 1)),
    (2, 1000, 2, 1000, 2, True, (64, 16, 8, 2, 32, 2, 2)),
    (1, 100, 1, 63, 4, True, (64, 2, 1, 2, 32, 1, 1))])
def test_decode_split_plan(B, S, H, D, kv_size, aligned, want):
    """The plan the wrapper hands the kernel: 16-byte loads where D and
    the cache's alignment allow, a head's threads a power of two <= 32,
    heads a block so that a key position's rows are one contiguous run,
    and splits that make ~4 waves of blocks on 132 SMs from a 16-bit cache
    and ~2 from a float32 one (at least 64 keys, at least the keys a block
    loads at once)."""
    pl = da_mod.plan(B, S, H, D, kv_size, aligned, 132)
    assert (pl.len, pl.ns, pl.vec, pl.nv, pl.tph, pl.hg, pl.pieces) == want
    assert pl.tph * pl.nv * pl.vec * pl.pieces >= D
    assert da_mod.THREADS % (pl.tph * pl.hg) == 0


def test_wrappers_take_plain_path_on_cpu_only():
    q, k, v = (torch.from_numpy(a) for a in qkv((1, 20, 2, 16), 0))
    qd, kd, vd = (torch.from_numpy(a) for a in decode_inputs(2, 30, 2, 16, 0))
    lens = torch.tensor([5, 30], dtype=torch.int32)
    before = fa_mod.flash_attention.launches, da_mod.decode_attention.launches
    assert torch.equal(fa_mod.flash_attention(q, k, v),
                       ref.flash_attention(q, k, v))
    assert torch.equal(da_mod.decode_attention(qd, kd, vd, lens),
                       ref.decode_attention(qd, kd, vd, lens))
    assert (fa_mod.flash_attention.launches,
            da_mod.decode_attention.launches) == before


def _view(shape, dtype, offset):
    """A contiguous tensor of ``shape`` whose data starts ``offset``
    elements into its buffer (the buffer itself 16-byte aligned or more)."""
    n = int(np.prod(shape))
    return torch.zeros(n + offset, dtype=dtype)[offset:].view(shape)


@pytest.mark.parametrize("dtype,D,offset,want", [
    (torch.bfloat16, 64, 0, "wgmma/tma"),
    (torch.bfloat16, 128, 0, "wgmma/tma"),
    (torch.bfloat16, 40, 0, "wgmma/tma"),
    (torch.bfloat16, 8, 0, "wgmma/tma"),
    (torch.bfloat16, 64, 2, "wgmma/cp.async"),     # 4-byte aligned rows
    (torch.bfloat16, 38, 0, "wgmma/cp.async"),     # 76-byte rows
    (torch.bfloat16, 37, 0, "wgmma/ld"),           # 74-byte rows
    (torch.bfloat16, 64, 1, "wgmma/ld"),           # 2-byte aligned rows
    (torch.float32, 64, 0, "3xtf32/cp.async16"),
    (torch.float32, 4, 0, "3xtf32/cp.async16"),
    (torch.float32, 64, 1, "3xtf32/cp.async4"),    # rows off 16 bytes
    (torch.float32, 37, 0, "3xtf32/cp.async4"),
    (torch.float16, 64, 0, "wgmma/tma"),
    (torch.float16, 37, 0, "wgmma/ld"),
    (torch.bfloat16, 256, 0, "wgmma256/tma"),      # the D-256 wgmma kernel
    (torch.bfloat16, 200, 0, "wgmma256/tma"),
    (torch.float16, 256, 0, "wgmma256/tma"),
    (torch.bfloat16, 130, 0, "wgmma256/cp.async"),  # 260-byte rows
    (torch.bfloat16, 256, 2, "wgmma256/cp.async"),
    (torch.bfloat16, 129, 0, "wgmma256/ld"),
    (torch.float16, 256, 1, "wgmma256/ld"),
    (torch.float32, 129, 1, "3xtf32_256/cp.async4"),   # the D-256 3xTF32
    (torch.float32, 256, 0, "3xtf32_256/cp.async16"),
    (torch.float32, 200, 0, "3xtf32_256/cp.async16"),
    (torch.float32, 130, 0, "3xtf32_256/cp.async4"),   # 520-byte rows
    (torch.float32, 257, 0, "3xtf32_sliced/cp.async4"),   # the sliced
    (torch.float32, 512, 0, "3xtf32_sliced/cp.async16"),  # 3xTF32 kernel
    (torch.float32, 512, 1, "3xtf32_sliced/cp.async4"),
    (torch.float32, 1100, 0, "3xtf32_sliced/cp.async16"),
    (torch.bfloat16, 257, 0, "wgmma512/ld"),       # the D-512 wgmma kernel
    (torch.float16, 512, 0, "wgmma512/tma"),
    (torch.bfloat16, 264, 0, "wgmma512/tma"),      # 528-byte rows
    (torch.bfloat16, 320, 2, "wgmma512/cp.async"),
    (torch.float16, 320, 1, "wgmma512/ld"),
    (torch.bfloat16, 513, 0, "wgmma_sliced/ld"),   # the sliced kernel
    (torch.float16, 513, 0, "wgmma_sliced/ld"),
    (torch.bfloat16, 640, 0, "wgmma_sliced/tma"),
    (torch.float16, 640, 2, "wgmma_sliced/cp.async"),
    (torch.bfloat16, 1100, 0, "wgmma_sliced/cp.async"),   # 2,200-byte rows
    (torch.float16, 1024, 1, "wgmma_sliced/ld"),
])
def test_flash_attention_path_by_type_width_and_alignment(dtype, D, offset,
                                                         want):
    """The wrapper's choice of load path: TMA needs 16-byte rows and
    pointers (16-bit types, D % 8 == 0), 4-byte cp.async D even, and
    float32's 16-byte cp.async D % 4 == 0; the products are on the tensor
    cores on every path, in every type and at every D."""
    q, k, v = (_view((2, 5, 3, D), dtype, offset) for _ in range(3))
    assert fa_mod.path(q, k, v) == want
    # one misaligned operand moves all three off the aligned path
    k2 = _view((2, 5, 3, D), dtype, 1)
    assert fa_mod.path(q, k2, v) == (
        want.split("/")[0] + ("/cp.async4" if dtype == torch.float32
                               else "/ld"))


def test_every_accepted_shape_maps_to_a_tensor_core_path():
    """Each (type, pointer alignment) at every D (here up to 1,100) has a
    tensor-core path whose kernel has a launch counter, and the path's
    load code is one the C entry point takes for that type."""
    c_loads = {torch.bfloat16: {0, 4, 2}, torch.float16: {0, 4, 2},
               torch.float32: {16, 4}}
    seen = set()
    for dtype in fa_mod.DTYPES:
        for D in range(1, 1101):
            for offset in (0, 1, 2, 4, 8):
                q, k, v = (_view((1, 3, 2, D), dtype, offset)
                           for _ in range(3))
                fa_mod._check_args(q, k, v)
                name = fa_mod.path(q, k, v)
                kernel = name.split("/")[0]
                assert kernel == (
                    ("3xtf32" if D <= fa_mod.MAX_D_TC else "3xtf32_256"
                     if D <= fa_mod.MAX_D_256 else "3xtf32_sliced")
                    if dtype == torch.float32 else
                    "wgmma" if D <= fa_mod.MAX_D_TC else
                    "wgmma256" if D <= fa_mod.MAX_D_256 else
                    "wgmma512" if D <= fa_mod.MAX_D_512 else "wgmma_sliced")
                assert fa_mod.LOADS[name] in c_loads[dtype]
                assert hasattr(fa_mod.flash_attention,
                               fa_mod.COUNTERS[kernel])
                seen.add(name)
    assert seen == set(fa_mod.LOADS)


@pytest.mark.parametrize("D,n,panels,q_resident", [
    (513, 2, 5, True), (576, 2, 5, True), (640, 2, 5, True),
    (700, 2, 6, True), (704, 2, 6, True),     # the widest Q kept resident
    (705, 2, 6, False), (768, 2, 6, False), (1024, 2, 8, False),
    (1100, 3, 6, False)])
def test_slice_plan(D, n, panels, q_resident):
    """The sliced kernel's plan: slices of at most 8 panels, the same
    count each where D allows (640: 2 x 5, not 8 + 2); Q's panels stay in
    shared memory up to D 704, wider each chunk of the ring carries Q's
    panels beside K's."""
    plan = fa_mod.slice_plan(D)
    assert (plan.n, plan.panels, plan.q_resident) == (n, panels, q_resident)
    # Q resident: a whole key tile a chunk, two stages; streamed: three
    # panels a chunk, at least two chunks
    assert (plan.chunk, plan.ring) == (-(-D // 64), 2) if q_resident else \
        (plan.chunk == 3 and plan.ring >= 2)


@pytest.mark.parametrize("D", [513, 600, 704, 705, 1100, 2047, 4096, 9000])
def test_slice_plan_fits_and_covers(D):
    """What the C entry point checks (flash_attention_sliced_launch): the
    slices cover D's panels, none is empty, a warpgroup holds at most 4
    panels of output, and the layout (barriers and alignment, Q when
    resident, V's two stages, the ring) fits a block's shared memory."""
    nq = -(-D // 64)
    plan = fa_mod.slice_plan(D)
    assert 1 <= plan.panels <= 8 and 2 <= plan.ring <= fa_mod.RING_MAX
    assert plan.n * plan.panels >= nq > (plan.n - 1) * plan.panels
    assert 1 <= plan.chunk <= nq
    chunk = plan.chunk * (fa_mod.PANEL_K
                          + (0 if plan.q_resident else fa_mod.PANEL_Q))
    used = (fa_mod.SMEM_FIXED + plan.q_resident * nq * fa_mod.PANEL_Q
            + 2 * plan.panels * fa_mod.PANEL_K + plan.ring * chunk)
    assert used <= fa_mod.SMEM_MAX


@pytest.mark.parametrize("D,n,panels,q_resident,chunk", [
    (257, 1, 5, True, 5), (320, 1, 5, True, 5), (512, 1, 8, True, 8),
    (576, 2, 5, True, 9),
    (640, 2, 5, True, 9), (896, 2, 7, True, 3), (897, 2, 8, False, 3),
    (1100, 3, 6, False, 3), (2048, 4, 8, False, 3)])
def test_tf32_slice_plan(D, n, panels, q_resident, chunk):
    """The float32 sliced kernel's plan: slices as the 16-bit kernel cuts
    them; Q resident to D 896, a whole key tile a chunk to D 576 (at D 512
    two stages, the layout the header counts: 219 KB); wider, Q streamed
    beside K in chunks of three panels."""
    plan = fa_mod.tf32_slice_plan(D)
    assert (plan.n, plan.panels, plan.q_resident, plan.chunk) == \
        (n, panels, q_resident, chunk)
    if D == 512:
        assert plan.ring == 2


@pytest.mark.parametrize("D", list(range(257, 2049, 37)) + [
    512, 576, 577, 640, 896, 897, 1024, 2048])
def test_tf32_slice_plan_fits_and_covers(D):
    """What the C entry point checks (flash_attention_sliced_launch, float32):
    the slices cover D's panels, none is empty, a warp holds at most 16
    n-tiles of output, the ring holds two chunks or more, and the layout
    (barriers and alignment, the partial scores, Q when resident, V's two
    stages of the slice's 16-key rows, the ring) fits a block's 227 KB."""
    nq = -(-D // 64)
    plan = fa_mod.tf32_slice_plan(D)
    assert 1 <= plan.panels <= 8 and 2 <= plan.ring <= fa_mod.RING_MAX
    assert plan.n * plan.panels >= nq > (plan.n - 1) * plan.panels
    assert 1 <= plan.chunk <= nq
    chunk = plan.chunk * (fa_mod.F32_PANEL_K
                          + (0 if plan.q_resident else fa_mod.F32_PANEL_Q))
    used = (fa_mod.F32_SMEM_FIXED + plan.q_resident * nq * fa_mod.F32_PANEL_Q
            + 2 * 16 * (64 * plan.panels + 4) * 4 + plan.ring * chunk)
    assert used <= fa_mod.SMEM_MAX
    assert fa_mod.SMEM_MAX == 232_448 and fa_mod.F32_PANEL_Q == 32 * 68 * 4


def _bad_calls():
    """(wrapper, operands) pairs each of which must raise ValueError."""
    q, k, v = (torch.from_numpy(a) for a in qkv((1, 20, 2, 16), 0))
    qd, kd, vd = (torch.from_numpy(a) for a in decode_inputs(2, 30, 2, 16, 0))
    lens = torch.tensor([5, 30], dtype=torch.int32)
    meta = torch.device("meta")
    fa, da = fa_mod.flash_attention, da_mod.decode_attention
    return {
        "fa_rank": (fa, (q[0], k[0], v[0])),
        "fa_shape": (fa, (q, k[:, :10].contiguous(), v)),
        "fa_stride": (fa, (q.transpose(1, 2), k, v)),
        "fa_device": (fa, (q, k, v.to(meta))),
        "fa_no_width": (fa, (q[..., :0], k[..., :0], v[..., :0])),
        "da_no_width": (da, (qd[..., :0], kd[..., :0], vd[..., :0], lens)),
        "da_lens_dtype": (da, (qd, kd, vd, lens.long())),
        "da_lens_shape": (da, (qd, kd, vd, lens[:1])),
        "da_shape": (da, (qd, kd[:, :, :1].contiguous(), vd, lens)),
        "da_rank": (da, (qd[0], kd, vd, lens)),
        "da_empty": (da, (qd, kd[:, :0], vd[:, :0], lens)),
        "da_stride": (da, (qd, kd, vd.transpose(1, 2), lens)),
        "da_device": (da, (qd, kd.to(meta), vd, lens)),
        "ops_da_lens": (ops.decode_attention, (qd, kd, vd, [1, 2, 3])),
    }


@pytest.mark.parametrize("bad", sorted(_bad_calls()))
def test_wrappers_reject_bad_operands(bad):
    fn, args = _bad_calls()[bad]
    with pytest.raises(ValueError):
        fn(*args)
