"""Port parity: pathfinder's pyramid plan and walk, canneal's row plan and
walk.

On the card, ``pathfinder.pyramid`` runs a wall in
``pyramid_plan(R, C).launches`` launches of ``h`` rows: warp g owns the
window of 256 columns from ``g * middle - ghost``, 8 a lane, runs the
launch's rows over it (neighbours by shuffles, the window's two ends held
at 3.0e38) and writes its middle; only the windows that reach past the
wall's ends mask their outside columns after every row.
``pyramid_mirror`` runs that walk in torch on the CPU with NaN wherever
the walk must not look: past a window's ends, in the wall's cells outside
it, in the scratch and output rows before a launch writes them.  The
mins propagate NaN, so an output equal to the plain version shows that
no poisoned cell reached it.

``canneal.rows`` stages each tile's index rows in chunks of 32 slots
(each row segment at its own word offset mod 4: its unaligned head and
tail word by word, the words between 16 bytes at a time), each thread
reading its row back as aligned quads and picking its words by that
offset, its sums carried across chunks, eight slots of padding skipped.
``rows_mirror`` runs that walk on the CPU from a flat index buffer at a
word offset, with every staged word no copy wrote poisoned and checked
unread.  Both mirrors are held bit for bit against
the port's plain versions and the Pallas kernels in interpret mode; the
kernels themselves against the plain versions on the card by
``tests/test_torch_cuda.py``.
"""
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro_torch.kernels import canneal as ca_mod
from repro_torch.kernels import pathfinder as path_mod
from repro_torch.kernels import ref

END = float(np.float32(ref.PATH_END))
NAN = float("nan")
POISON = np.iinfo(np.int32).min
# cards: an H100 SXM, an H100 PCIe and one with 99 KB of shared memory a
# CTA (tests/test_torch_pathfinder_strips.py CARDS)
CARDS = [(132, 232_448), (114, 232_448), (78, 101_376)]


# ---- the pyramid ------------------------------------------------------------

def pyramid_mirror(wall):
    """The pyramid kernel's launches on the CPU: float32 ``[C]``."""
    R, C = wall.shape
    plan = path_mod.pyramid_plan(R, C)
    K, W = 8, plan.window
    wf = wall.float()
    bufs = {"out": torch.full((C,), NAN), "scratch": torch.full((C,), NAN)}
    src = None
    lane_col = torch.arange(W)
    for s in range(plan.launches):
        row0 = 1 + s * plan.h
        nrows = max(0, min(plan.h, R - row0))
        dst = "out" if (plan.launches - 1 - s) % 2 == 0 else "scratch"
        new = torch.full((C,), NAN)
        for g in range(plan.windows):
            col = g * plan.middle - plan.ghost + lane_col
            inside = (col >= 0) & (col < C)
            cc = col.clamp(0, C - 1)
            start = wf[0, cc] if src is None else bufs[src][cc]
            v = torch.where(inside, start, END)
            edge = not bool(inside.all())
            for i in range(nrows):
                # the wall's cells outside it: NaN (never loaded)
                w = torch.where(inside, wf[row0 + i, cc], NAN)
                # past the window's ends: NaN (the kernel's 3.0e38 there
                # must not matter)
                left = torch.cat([torch.full((1,), NAN), v[:-1]])
                right = torch.cat([v[1:], torch.full((1,), NAN)])
                n = w + torch.minimum(v, torch.minimum(left, right))
                v = torch.where(inside, n, END) if edge else n
            mid = (lane_col >= plan.ghost) & \
                (lane_col < plan.ghost + plan.middle) & inside
            new[col[mid]] = v[mid]
        assert K * 32 == W
        bufs[dst] = new
        src = dst
    return bufs["out"]


def path_wall(R, C, dtype, seed):
    rng = np.random.RandomState(seed)
    if dtype == "int32":
        return rng.randint(0, 10, (R, C)).astype(np.int32)
    return rng.uniform(0, 10, (R, C)).astype(np.float32)


@pytest.mark.parametrize("R", list(range(1, 90)) + [120, 161, 1_604])
def test_pyramid_plan_tiles_the_columns(R):
    """Middles that tile C exactly (no window without a column of it), at
    most 40 rows a launch, ghost zones of h rounded up to 4, one launch for
    every wall of at most 41 rows and ceil((R - 1) / 40) past them."""
    for C in (1, 3, 175, 176, 177, 215, 216, 217, 100_000, 100_003,
              2 ** 31 - 257):
        plan = path_mod.pyramid_plan(R, C)
        assert plan.window == 256 and 0 <= plan.h <= path_mod.PYRAMID_H
        assert plan.ghost % 4 == 0 and plan.h <= plan.ghost < plan.h + 4
        assert plan.middle == plan.window - 2 * plan.ghost > 0
        assert (plan.windows - 1) * plan.middle < C <= \
            plan.windows * plan.middle
        assert plan.launches == (1 if R <= 41 else -(-(R - 1) // 40))
        assert (plan.launches - 1) * plan.h < max(R - 1, 1) <= \
            plan.launches * plan.h or R == 1


@pytest.mark.parametrize("sms,smem", CARDS)
def test_route_takes_the_pyramid_to_two_launches(sms, smem):
    """Walls of one launch take the pyramid on every card at any width,
    walls of two (to PYRAMID_ROWS rows) to PYRAMID_COLS columns, the
    plan's launches; past them the strips where they fit."""
    for R in (1, 2, 21, 41, 42, 81):
        for C in (1_000, 100_000, 100_001, 405_504):
            rt = path_mod.route(R, C, sms, smem)
            if R > 41 and C > path_mod.PYRAMID_COLS:
                assert rt.name == "strips" or all(
                    path_mod.strips(C, h, sms, smem) is None
                    for h in path_mod.H_CHOICES), (R, C)
                continue
            assert rt.name == "pyramid", (R, C)
            assert rt.launches == path_mod.pyramid_plan(R, C).launches
            assert rt.launches <= 2
    assert path_mod.route(82, 100_000, sms, smem).name == "strips"
    assert path_mod.route(81, 100_001, sms, smem).name == "strips"


@pytest.mark.parametrize("R,C", [(1, 7), (2, 1), (3, 300), (21, 700),
                                 (22, 433), (41, 1_000), (45, 600),
                                 (81, 357), (90, 1_201)])
@pytest.mark.parametrize("dtype", ["int32", "float32"])
def test_pyramid_mirror_matches_plain(R, C, dtype):
    """One row; one launch of 1 to 40 rows; two and three launches
    through the scratch row; C within one window and across several, off
    a multiple of 4."""
    w = torch.from_numpy(path_wall(R, C, dtype, R * C))
    assert torch.equal(pyramid_mirror(w), ref.pathfinder(w))


@pytest.mark.parametrize("R", [21, 41])
@pytest.mark.parametrize("dtype", ["int32", "float32"])
def test_pyramid_mirror_matches_pallas(R, dtype):
    """The main path's 21 rows and the one-launch limit's 41, across
    several windows (C 700: four windows of 176 to 216 columns), bit for
    bit with ``repro.kernels.ops.pathfinder`` in interpret mode."""
    w = path_wall(R, 700, dtype, R)
    got = pyramid_mirror(torch.from_numpy(w))
    want = np.asarray(ref_ops.pathfinder(w, interpret=True))
    np.testing.assert_array_equal(got.numpy(), want)


def test_pyramid_mirror_special_values():
    """+inf rows and columns, -inf, NaN and values near 3e38 through the
    windows: equal to the plain version, NaN where NaN."""
    rng = np.random.RandomState(4)
    w = rng.uniform(0, 10, (30, 500)).astype(np.float32)
    w[:, 0] = np.inf
    w[11] = np.inf
    w[rng.rand(30, 500) < 0.05] = 3e38
    w[4, 333] = -np.inf
    w[20, 17] = np.nan
    t = torch.from_numpy(w)
    torch.testing.assert_close(pyramid_mirror(t), ref.pathfinder(t),
                               rtol=0, atol=0, equal_nan=True)


# ---- canneal's row kernel ---------------------------------------------------

def rows_mirror(locs, fan, ca, cb, ctas, offset=0):
    """The row kernel's walk over ``fan`` [B, F] placed ``offset`` words
    into a flat buffer, ``ctas`` CTAs taking tiles in turn: (cost_a,
    cost_b), float32 [B]."""
    B, F = fan.shape
    plan = ca_mod.rows_plan(F)
    T, CH, P = plan.tile, plan.chunk, ca_mod.ROW_PITCH
    flat = np.concatenate([np.zeros(offset, np.int32), fan.reshape(-1)])
    tiles = -(-B // T)
    out = [np.full(B, np.nan, np.float32) for _ in range(2)]
    n = locs.shape[0]
    for c in range(ctas):
        buf = np.full((T, P), POISON, np.int32)
        seq = [(tile, k) for tile in range(c, tiles, ctas)
               for k in range(plan.chunks)]
        sums = None
        for tile, k in seq:
            buf[:] = POISON      # what an earlier chunk left: never read
            first, c0 = tile * T, k * CH
            rows = min(T, B - first)
            ln = max(0, min(CH, F - c0))
            ms = []
            for r in range(rows):
                start = offset + (first + r) * F + c0
                m = start % 4
                head = min((4 - m) % 4, ln)
                body = (ln - head) // 4
                assert (m + head) % 4 == 0 or body == 0   # chunks aligned
                for i in range(head):
                    buf[r, m + i] = flat[start + i]
                for q in range(body):
                    i = head + 4 * q
                    buf[r, m + i:m + i + 4] = flat[start + i:start + i + 4]
                for i in range(head + 4 * body, ln):
                    buf[r, m + i] = flat[start + i]
                ms.append(m)
            if k == 0:
                sums = [np.zeros(rows, np.float32) for _ in range(2)]
            for r in range(rows):
                m, i_swap = ms[r], first + r
                for s in range(0, ln, 8):
                    # quads s / 4 .. s / 4 + 2 of the row, its words m + s..
                    quads = buf[r, s:s + 12]
                    idx = quads[m:m + min(8, ln - s)]
                    assert (idx != POISON).all()
                    if (idx < 0).all():
                        continue     # eight slots of padding: skipped
                    for j in idx:
                        if j < 0:
                            continue
                        p = locs[min(j, n - 1)]
                        for o, cand in enumerate((ca, cb)):
                            d = (np.abs(p[0] - cand[i_swap, 0])
                                 + np.abs(p[1] - cand[i_swap, 1]))
                            sums[o][r] = np.float32(sums[o][r] + d)
            if k == plan.chunks - 1:
                out[0][first:first + rows] = sums[0]
                out[1][first:first + rows] = sums[1]
    return out


def ca_inputs(B, F, N, seed, lo=-1, real=None):
    """Integer coordinates; indices in [lo, N + 50); with ``real``, each
    row's slots past ``real`` are padding (-1), as a net list padded to F
    slots."""
    rng = np.random.RandomState(seed)
    locs = rng.randint(0, 1000, (N, 2)).astype(np.float32)
    fan = rng.randint(lo, N + 50, (B, F)).astype(np.int32)
    if real is not None:
        fan[:, real:] = -1
    ca, cb = (rng.randint(0, 1000, (B, 2)).astype(np.float32)
              for _ in range(2))
    return locs, fan, ca, cb


@pytest.mark.parametrize("sms,smem", CARDS)
def test_rows_plan_fits_every_card(sms, smem):
    """For F from none to 2^20 (each side of a chunk's edge, the tile
    kernel's widest and past it): tiles of 256 swaps, chunks of 32 slots
    whose count covers the row (one empty chunk at F = 0), one stage of
    256 rows of 36 words within the card's shared memory a CTA (and within
    the 48 KB a kernel takes without opting in); a negative F has no
    plan."""
    assert (ca_mod.ROW_STAGES, ca_mod.ROW_SMEM) == (1, 36_864)
    assert ca_mod.ROW_SMEM <= min(smem, 48 * 1024)
    for F in (0, 1, 31, 32, 33, 95, 96, 97, 128, 129, 200, 1_000, 30_000,
              2 ** 20 - 1, 2 ** 20):
        plan = ca_mod.rows_plan(F, smem)
        assert (plan.tile, plan.chunk) == (256, 32)
        assert plan.chunks == max(1, -(-F // 32))
        assert (plan.chunks - 1) * plan.chunk < max(F, 1) <= \
            plan.chunks * plan.chunk
        assert (plan.stages, plan.smem) == (ca_mod.ROW_STAGES,
                                            ca_mod.ROW_SMEM)
    with pytest.raises(ValueError):
        ca_mod.rows_plan(-1, smem)


@pytest.mark.parametrize("B,F,ctas,offset", [
    (1, 97, 1, 0), (255, 128, 2, 1), (257, 129, 3, 2), (300, 200, 2, 3),
    (40, 1_000, 1, 1), (513, 22, 2, 0), (70, 33, 1, 2), (5, 0, 2, 0)])
def test_rows_mirror_matches_plain(B, F, ctas, offset):
    """B below, at and off a multiple of the 256-swap tile; F past the tile
    kernel's 96 with a ragged last chunk (and at 128 without), one chunk
    (22) and none (0); views 1 to 3 words into their buffers (row offsets
    that vary with F); one CTA and several; padding anywhere in a row and
    indices past N."""
    locs, fan, ca, cb = ca_inputs(B, F, 500, B + F, lo=-5)
    got = rows_mirror(locs, fan, ca, cb, ctas, offset)
    want = ref.canneal_swap_cost(*map(torch.from_numpy, (locs, fan, ca, cb)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w.numpy())


@pytest.mark.parametrize("F", [128, 200])
def test_rows_mirror_matches_pallas(F):
    """PARSEC's 22 slots padded to 128 and 200 (the main path's call and a
    ragged last chunk), at B a multiple of the Pallas kernel's 256-swap
    block: bit for bit with ``repro.kernels.ops.canneal_swap_cost`` in
    interpret mode."""
    locs, fan, ca, cb = ca_inputs(256, F, 300, F, real=22)
    got = rows_mirror(locs, fan, ca, cb, ctas=1, offset=1)
    want = ref_ops.canneal_swap_cost(locs, fan, ca, cb, interpret=True)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))
