"""The segment sum's two-level order on the CPU (``kernels.segment_sum``).

``segment_sum_chunked`` spells out the order of the card's kernel
(``csrc/segment_sum.cu``): a row of at most ``CHUNK`` positions adds them
in position order; a longer row adds chunks of ``CHUNK`` positions, each in
position order, in chunk order.  Here it is held against the reference's
embedding gradient (``jax.vjp`` of ``repro.models.layers.embed_fwd``)
within float32 rounding, against ``segment_sum_plain`` bit for bit on rows
of at most ``CHUNK`` positions and against the two-level loop written out;
the kernel's chunk slots (two a window of ``CHUNK`` sorted positions) are
shown to hold every chunk once; ``EmbedGather``'s backward on the CPU stays
the plain version.  Inputs drawn with numpy from a seed.  The kernel
against ``segment_sum_chunked`` bit for bit: ``test_torch_cuda.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as rlayers
from repro_torch.kernels import segment_sum as ss
from repro_torch.models import layers as L


def _zipf_inputs(seed, V=400, N=3000, D=16, a=1.2):
    """Zipf-drawn indices (the hottest row far past ``CHUNK`` positions)
    and rows of magnitudes spread over six decades, so that the order of
    the adds shows in the bits."""
    rng = np.random.default_rng(seed)
    idx = np.minimum(rng.zipf(a, N) - 1, V - 1)
    rows = (rng.standard_normal((N, D))
            * 10.0 ** rng.integers(-3, 4, (N, 1))).astype(np.float32)
    return idx, rows


def _float32_bar(idx, rows, V):
    """n * 2^-24 * the sum of magnitudes of each row (n its count): the
    bound of float32 sums of n terms."""
    mag = np.zeros((V, rows.shape[1]))
    np.add.at(mag, idx, np.abs(rows.astype(np.float64)))
    n = np.bincount(idx, minlength=V)[:, None]
    return n * 2.0 ** -24 * mag


@pytest.mark.parametrize("chunk", [1, 4, ss.CHUNK])
@pytest.mark.parametrize("seed", [0, 1])
def test_chunked_is_the_references_embedding_gradient(seed, chunk):
    """The reference's gradient of its embedding gather (a float32 table,
    ``jax.vjp`` of ``embed_fwd``: a scatter-add) and the two-level order
    agree within n * 2^-24 * the sum of magnitudes, row by row."""
    V = 400
    idx, rows = _zipf_inputs(seed, V)
    tokens = idx.reshape(3, -1)
    table = np.zeros((V, rows.shape[1]), np.float32)
    _, vjp = jax.vjp(lambda t: rlayers.embed_fwd({"embedding": t},
                                                 jnp.asarray(tokens),
                                                 jnp.float32),
                     jnp.asarray(table))
    want = np.asarray(vjp(jnp.asarray(rows.reshape(3, -1, rows.shape[1])))[0])
    got = ss.segment_sum_chunked(torch.from_numpy(rows),
                                 torch.from_numpy(idx), V, torch.float32,
                                 chunk=chunk).numpy()
    assert np.all(np.abs(got.astype(np.float64) - want)
                  <= _float32_bar(idx, rows, V))


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("seed", [2, 3])
def test_rows_of_at_most_a_chunk_are_the_plain_sums_bit_for_bit(seed,
                                                                 out_dtype):
    """A row of at most ``CHUNK`` positions is summed in position order,
    as the plain version (CPU ``index_add_``) adds: the same bits, in
    float32 and rounded once to bfloat16."""
    V = 400
    idx, rows = _zipf_inputs(seed, V)
    n = np.bincount(idx, minlength=V)
    assert n.max() > 4 * ss.CHUNK and (n == 1).any()
    args = (torch.from_numpy(rows), torch.from_numpy(idx), V, out_dtype)
    got, plain = ss.segment_sum_chunked(*args), ss.segment_sum_plain(*args)
    short = torch.from_numpy(n <= ss.CHUNK)
    assert torch.equal(got[short], plain[short])


@pytest.mark.parametrize("chunk", [2, 3, ss.CHUNK])
def test_a_long_row_is_its_chunk_sums_in_chunk_order(chunk):
    """The hottest row's bits: each chunk of ``chunk`` positions summed in
    position order from 0.0, the chunk sums added in chunk order from
    0.0; float32 rounded once to bfloat16."""
    V = 400
    idx, rows = _zipf_inputs(4, V)
    hot = int(np.bincount(idx).argmax())
    pos = np.flatnonzero(idx == hot)
    assert len(pos) > 4 * chunk
    total = torch.zeros(rows.shape[1])
    for c in range(0, len(pos), chunk):
        part = torch.zeros(rows.shape[1])
        for j in pos[c:c + chunk]:
            part = part + torch.from_numpy(rows[j])
        total = total + part
    x, i = torch.from_numpy(rows), torch.from_numpy(idx)
    assert torch.equal(ss.segment_sum_chunked(x, i, V, torch.float32,
                                              chunk=chunk)[hot], total)
    assert torch.equal(ss.segment_sum_chunked(x, i, V, torch.bfloat16,
                                              chunk=chunk)[hot],
                       total.to(torch.bfloat16))


def _kernel_chunk_slots(keys, chunk):
    """The chunk starts the kernel's chunk pass finds, by its rule: window
    w of ``chunk`` sorted positions, kind 0 the run covering its first
    position (started before it), kind 1 the run covering its last
    (started inside it); a chunk starting at p in slot 2 (p // chunk) +
    (p is its run's start)."""
    N = len(keys)
    found = {}
    for w in range(-(-N // chunk)):
        lo, hi = w * chunk, min(w * chunk + chunk, N)
        for kind in (0, 1):
            key = keys[lo if kind == 0 else hi - 1]
            s = int(np.searchsorted(keys, key, "left"))
            e = int(np.searchsorted(keys, key, "right"))
            if e - s <= chunk or (kind == 0) != (s < lo):
                continue
            p = s + (lo - s + chunk - 1) // chunk * chunk if kind == 0 else s
            if p < min(hi, e):
                slot = 2 * w + kind
                assert slot not in found and slot == 2 * (p // chunk) + \
                    (p == s)
                found[slot] = p
    return sorted(found.values())


@pytest.mark.parametrize("chunk", [1, 2, 5, ss.CHUNK])
@pytest.mark.parametrize("a", [1.05, 1.5])
def test_the_kernels_chunk_slots_hold_every_chunk_once(a, chunk):
    """Every chunk start of every row longer than ``chunk`` (each row's
    first position and every ``chunk`` positions after it) is found by
    exactly one (window, kind) block of the chunk pass, in its own slot."""
    idx, _ = _zipf_inputs(5, N=2000, a=a)
    keys = np.sort(idx, kind="stable")
    counts = np.bincount(keys)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    want = sorted(int(starts[r]) + k for r in np.flatnonzero(counts > chunk)
                  for k in range(0, int(counts[r]), chunk))
    assert _kernel_chunk_slots(keys, chunk) == want


def test_no_positions_and_single_positions():
    """No rows: zeros.  Every index once: each output row is its one input
    row (0.0 + x), the plain version's bits."""
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.standard_normal((50, 8)).astype(np.float32))
    empty = ss.segment_sum_chunked(x[:0], torch.zeros(0, dtype=torch.long),
                                   7, torch.bfloat16)
    assert empty.dtype == torch.bfloat16 and not empty.any()
    idx = torch.from_numpy(rng.permutation(60)[:50])
    assert torch.equal(ss.segment_sum_chunked(x, idx, 60, torch.float32),
                       ss.segment_sum_plain(x, idx, 60, torch.float32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_embed_gather_backward_on_the_cpu_is_the_plain_sum(dtype):
    """On CPU tensors ``EmbedGather``'s backward is the plain version,
    rounded once to the table's type, whatever the rows' counts."""
    V = 400
    idx, rows = _zipf_inputs(7, V)
    w = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (V, rows.shape[1])).astype(np.float32)).to(dtype).requires_grad_()
    tokens = torch.from_numpy(idx).reshape(3, -1)
    out = L.EmbedGather.apply(w, tokens, torch.float32)
    (g,) = torch.autograd.grad(out, w, torch.from_numpy(rows).reshape(
        3, -1, rows.shape[1]))
    assert g.dtype == dtype
    assert torch.equal(g, ss.segment_sum_plain(
        torch.from_numpy(rows), torch.from_numpy(idx), V, dtype))
