"""Port parity: canneal's tile kernel (index rows staged coalesced).

On the card, ``swap_cost`` runs rows of 1 to ``MAX_F`` slots on the tile
kernel: persistent CTAs take tiles of ``TILE`` swaps in turn (CTA c the
tiles c, c + CTAs, ...), each tile's contiguous ``[TILE, F]`` index block
staged into one of two shared buffers (the words before the block's first
16-byte boundary and after its last whole chunk one by one, the chunks
between 16 bytes at a time, the block at its own offset mod 16), and one
thread a swap sums its row in slot order.  ``tiles_mirror`` runs that walk
on the CPU from a flat index buffer at a word offset (a misaligned view),
with every buffer word no copy wrote poisoned and checked unread, and sums
in float32 slot by slot as the kernel does.  It is held bit for bit
against the port's plain version and against
``repro.kernels.ops.canneal_swap_cost(interpret=True)`` (B a multiple of
256).  The kernels themselves are held against the plain version on the
card by ``tests/test_torch_cuda.py``.
"""
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro_torch.kernels import canneal as ca_mod
from repro_torch.kernels import ref

POISON = np.iinfo(np.int32).min


def stage_words(first_word, nw):
    """The kernel's copies of one tile's block of ``nw`` words starting at
    word ``first_word`` of the buffer behind ``fan_idx``: (head words,
    16-byte chunks, tail words), and the block's offset in its shared
    buffer (its word offset mod 4)."""
    m = first_word % 4
    head = min((4 - m) % 4, nw)
    body = (nw - head) // 4
    return head, body, nw - head - 4 * body, m


def tiles_mirror(locs, fan, ca, cb, ctas, offset=0):
    """The tile kernel's walk over ``fan`` [B, F] placed ``offset`` words
    into a flat buffer: (cost_a, cost_b), float32 [B]."""
    B, F = fan.shape
    T, words = ca_mod.TILE, ca_mod.tile_words(F)
    flat = np.concatenate([np.zeros(offset, np.int32), fan.reshape(-1)])
    tiles = -(-B // T)
    out = [np.full(B, np.nan, np.float32) for _ in range(2)]
    n = locs.shape[0]
    for c in range(ctas):
        bufs = [np.full(words, POISON, np.int32) for _ in range(2)]
        for it, tile in enumerate(range(c, tiles, ctas)):
            buf = bufs[it % 2]
            first = tile * T
            rows = min(T, B - first)
            nw = rows * F
            start = offset + first * F
            head, body, tail, m = stage_words(start, nw)
            assert (m + head) % 4 == 0 or body == 0   # chunks land aligned
            assert m + nw <= words
            buf[:] = POISON     # what an earlier tile left: never read
            for i in range(head):
                buf[m + i] = flat[start + i]
            for q in range(body):
                i = head + 4 * q
                buf[m + i:m + i + 4] = flat[start + i:start + i + 4]
            for i in range(head + 4 * body, nw):
                buf[m + i] = flat[start + i]
            idx = buf[m:m + nw].reshape(rows, F)
            assert (idx != POISON).all()
            valid = idx >= 0
            p = locs[np.clip(idx, 0, n - 1)]              # [rows, F, 2]
            sums = []
            for cand in (ca[first:first + rows], cb[first:first + rows]):
                d = (np.abs(p[..., 0] - cand[:, None, 0])
                     + np.abs(p[..., 1] - cand[:, None, 1]))
                s = np.zeros(rows, np.float32)
                for k in range(F):        # slot order, float32
                    s = s + np.where(valid[:, k], d[:, k], np.float32(0))
                sums.append(s)
            out[0][first:first + rows], out[1][first:first + rows] = sums
    return out


def inputs(B, F, N, seed, lo=-1):
    rng = np.random.RandomState(seed)
    locs = rng.randint(0, 1000, (N, 2)).astype(np.float32)
    fan = rng.randint(lo, N + 50, (B, F)).astype(np.int32)
    ca, cb = (rng.randint(0, 1000, (B, 2)).astype(np.float32)
              for _ in range(2))
    return locs, fan, ca, cb


def test_route_and_buffers():
    assert [ca_mod.route(F) for F in (0, 1, 22, 96, 97, 500)] == \
        ["rows", "tiles", "tiles", "tiles", "rows", "rows"]
    for F in range(1, ca_mod.MAX_F + 1):
        words = ca_mod.tile_words(F)
        assert words % 4 == 0 and words >= ca_mod.TILE * F + 3
        assert 2 * words * 4 <= 232_448          # a CTA's shared memory


@pytest.mark.parametrize("offset", range(4))
@pytest.mark.parametrize("F", [1, 3, 22, 33])
def test_stage_words_cover_the_block(offset, F):
    """Head, chunks and tail copy each word of a tile's block once, for
    every word offset of the block and tiles whose rows leave a tail."""
    for first in (0, 1, 5):
        for rows in (1, 7, 256):
            start = offset + first * 256 * F
            head, body, tail, m = stage_words(start, rows * F)
            assert head + 4 * body + tail == rows * F
            assert head < 4 and tail < 4 and m == start % 4


@pytest.mark.parametrize("B,F,ctas,offset", [
    (1, 22, 1, 0), (255, 22, 2, 1), (257, 22, 3, 2), (1_000, 33, 2, 3),
    (700, 1, 4, 0), (513, 64, 1, 37 * 64), (2_000, 9, 5, 3)])
def test_tiles_mirror_matches_plain(B, F, ctas, offset):
    """B below, at and off a multiple of the 256-swap tile; one CTA and
    several taking tiles in turn; a view 1 to 3 words into its buffer and
    one that starts mid-tile (37 rows of 64 in); padding (-1 and below)
    anywhere in a row and indices past N."""
    locs, fan, ca, cb = inputs(B, F, 500, B + F, lo=-5)
    got = tiles_mirror(locs, fan, ca, cb, ctas, offset)
    want = ref.canneal_swap_cost(*map(torch.from_numpy, (locs, fan, ca, cb)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w.numpy())


@pytest.mark.parametrize("B,F", [(256, 22), (768, 33), (512, 8)])
def test_tiles_mirror_matches_pallas(B, F):
    """At B a multiple of the Pallas kernel's 256-swap block, bit for bit
    with ``repro.kernels.ops.canneal_swap_cost`` in interpret mode."""
    locs, fan, ca, cb = inputs(B, F, 300, B * F)
    got = tiles_mirror(locs, fan, ca, cb, ctas=2, offset=1)
    want = ref_ops.canneal_swap_cost(locs, fan, ca, cb, interpret=True)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))


def test_rows_entry_takes_cuda_tensors():
    """The row kernel's own entry takes CUDA tensors only; on the CPU
    ``swap_cost`` takes the plain version and counts no launch."""
    args = [torch.from_numpy(a) for a in inputs(40, 22, 300, 7)]
    with pytest.raises(ValueError, match="CUDA"):
        ca_mod.rows(*args)
    before = ca_mod.swap_cost.launches, ca_mod.swap_cost.rows_launches
    for g, w in zip(ca_mod.swap_cost(*args), ref.canneal_swap_cost(*args)):
        assert torch.equal(g, w)
    assert (ca_mod.swap_cost.launches,
            ca_mod.swap_cost.rows_launches) == before
