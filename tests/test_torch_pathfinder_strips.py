"""Port parity: pathfinder's strip route (all rows in one persistent launch).

On the card, ``pathfinder`` runs a wall of more than ``PYRAMID_ROWS`` rows
(or of more than ``PYRAMID_H + 1`` rows and ``PYRAMID_COLS`` columns) on
the strip route where the strips fit: CTA g holds the columns
``[g S, (g + 1) S)``, each of its row warps a window of 256 columns, and
runs the rows in phases of ``h`` over the strip and ``h`` ghost columns a
side, the wall streaming through a ring of ``sr``-row slabs; between
phases the warps' middles meet in a shared cost row and the strips' edges
go to the neighbours through tagged edge slots.  The plan is chosen on the
host and checked here.  ``strips_mirror`` runs the kernel's schedule in
torch on the CPU (the same strips, warp windows, phases, cost rows and
edge slots by the phase's parity and tag), with NaN in every cell the
schedule must not read: wall columns outside the wall, the ends of a warp's
window, a cost-row column no warp wrote that phase, an edge slot no
neighbour wrote with the phase's tag.  It is held bit for bit against the
port's plain version and the Pallas kernel in interpret mode.  The kernel
itself is held against the plain version on the card by
``tests/test_torch_cuda.py``.
"""
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro_torch.kernels import pathfinder as path_mod
from repro_torch.kernels import ref

END = torch.tensor(ref.PATH_END, dtype=torch.float32)
NAN = float("nan")


def tmin(a, b):
    return torch.minimum(a, b)


def strips_mirror(wall, rt):
    """The strip kernel's schedule on the CPU: float32 ``[C]``."""
    R, C = wall.shape
    S, h, G = rt.strip, rt.h, rt.ctas
    V = path_mod.WARP_COLS - 2 * h
    warps = path_mod.strip_warps(S, h)
    P, E = warps * V + 2 * h, S + 2 * h
    nsteps, wf = R - 1, wall.float()
    phases = -(-nsteps // h)
    # edge slots [2][G][2 sides][h]: values and tags (zero: the memset)
    ev = torch.full((2, G, 2, h), NAN)
    tag = torch.zeros((2, G, 2, h), dtype=torch.int64)
    j = torch.arange(P)
    cta = []
    for g in range(G):
        x0 = g * S - h
        col = x0 + j
        outside = (j >= E) | (col < 0) | (col >= C)
        row0 = torch.where(outside, END, wf[0, col.clamp(0, C - 1)])
        cta.append({"x0": x0, "col": col, "outside": outside,
                    "v": [row0[q * V:q * V + 256].clone()
                          for q in range(warps)],
                    "crow": torch.full((2, P), NAN)})
    for p in range(phases):
        r0 = p * h
        rows = min(h, nsteps - r0)
        for g, c in enumerate(cta):
            if p > 0:   # the window of cost row r0: the cost row, or edges
                row = c["crow"][p & 1].clone()
                if g > 0:
                    assert (tag[p & 1, g - 1, 1] == p).all()
                    row[:h] = ev[p & 1, g - 1, 1]
                if g < G - 1:
                    assert (tag[p & 1, g + 1, 0] == p).all()
                    row[h + S:E] = ev[p & 1, g + 1, 0]
                row = torch.where(c["outside"], END, row)
                c["v"] = [row[q * V:q * V + 256].clone()
                          for q in range(warps)]
            # the slabs' wall cells: NaN wherever no copy lands
            slab = torch.full((rows, P), NAN)
            inside = ~((c["col"] < 0) | (c["col"] >= C) | (j >= E))
            cols = c["col"][inside]
            slab[:, inside] = wf[r0 + 1:r0 + 1 + rows][:, cols]
            for q in range(warps):
                win = slice(q * V, q * V + 256)
                x, out_w = c["v"][q], c["outside"][win]
                for i in range(rows):
                    # the window's ends read nothing the schedule may use
                    left = torch.cat([torch.full((1,), NAN), x[:-1]])
                    right = torch.cat([x[1:], torch.full((1,), NAN)])
                    n = slab[i, win] + tmin(x, tmin(left, right))
                    x = torch.where(out_w, END, n)
                c["v"][q] = x
        if p + 1 < phases:
            s = (p + 1) & 1
            ev[s], tag[s] = NAN, -1     # the slot's earlier phase, stale
            for g, c in enumerate(cta):
                c["crow"][s] = NAN
                for q in range(warps):
                    mid = slice(q * V + h, q * V + h + V)
                    c["crow"][s, mid] = c["v"][q][h:h + V]
                ev[s, g, 0] = c["crow"][s, h:2 * h]
                ev[s, g, 1] = c["crow"][s, S:S + h]
                tag[s, g] = p + 1
    out = torch.full((C,), NAN)
    for g, c in enumerate(cta):
        row = torch.full((P,), NAN)
        for q in range(warps):
            mid = slice(q * V + h, q * V + h + V)
            row[mid] = c["v"][q][h:h + V]
        keep = (j >= h) & (j < h + S) & ~c["outside"]
        out[c["col"][keep]] = row[keep]
    return out


def wall(R, C, dtype, seed):
    rng = np.random.RandomState(seed)
    if dtype == "int32":
        return rng.randint(0, 10, (R, C)).astype(np.int32)
    return rng.uniform(0, 10, (R, C)).astype(np.float32)


def test_route_at_rodinia_width():
    rt = path_mod.route(1_604, 100_000)
    assert rt == path_mod.Route("strips", 760, 32, 132, 2, 8)
    assert path_mod.strip_warps(rt.strip, rt.h) == 4
    assert path_mod.strip_smem(rt.strip, rt.h, rt.sr) <= path_mod.MAX_SMEM


@pytest.mark.parametrize("R", [1, 2, 21, 41])
def test_route_short_walls_take_the_pyramid(R):
    rt = path_mod.route(R, 100_000)
    assert rt.name == "pyramid"
    assert rt.launches == path_mod.pyramid_plan(R, 100_000).launches == 1


@pytest.mark.parametrize("C", [475_201, 1_000_003, 2 ** 31 - 257])
def test_route_past_the_widest_strips(C):
    assert path_mod.route(100, C) == path_mod.Route(
        "pyramid", launches=path_mod.pyramid_plan(100, C).launches)
    assert path_mod.pyramid_plan(100, C).launches == 3


# cards: an H100 SXM (the defaults), an H100 PCIe (114 SMs) and one of 78
# SMs with 99 KB of shared memory a CTA
CARDS = [(132, 232_448), (114, 232_448), (78, 101_376)]


@pytest.mark.parametrize("sms,smem", CARDS)
def test_route_strips_cover_the_columns_exactly(sms, smem):
    """For every width to the widest strips: strips of a multiple of 4
    columns, at least h, whose CTAs cover [0, C) with no empty strip, at
    most one CTA an SM and 15 row warps, the ring's slabs dividing h,
    within a CTA's shared memory; the pyramid only where no h fits."""
    rng = np.random.RandomState(0)
    widths = list(range(1, 400)) + list(rng.randint(400, 475_201, 300)) \
        + [100_000, 380_160, 380_161, 443_520, 443_521, 475_200]
    for C in widths:
        rt = path_mod.route(path_mod.PYRAMID_ROWS + 1, int(C), sms, smem)
        if rt.name == "pyramid":
            assert sms != path_mod.CTAS, C
            assert all(path_mod.strips(int(C), h, sms, smem) is None
                       for h in path_mod.H_CHOICES), C
            continue
        assert rt.strip % 4 == 0 and rt.strip >= rt.h and rt.h % 4 == 0
        assert (rt.ctas - 1) * rt.strip < C <= rt.ctas * rt.strip
        assert rt.ctas <= sms and rt.h % rt.sr == 0
        assert path_mod.strip_warps(rt.strip, rt.h) <= path_mod.MAX_WARPS
        assert path_mod.strip_smem(rt.strip, rt.h, rt.sr) <= smem
        assert rt.launches == 2


@pytest.mark.parametrize("sms,smem", CARDS)
def test_route_at_rodinia_width_on_other_cards(sms, smem):
    """Rodinia's wall takes the strip route on each card, one CTA an SM,
    and the mirror of its schedule on a narrower copy of the plan (the
    same h and slabs) equals the plain version."""
    rt = path_mod.route(1_604, 100_000, sms, smem)
    assert rt.name == "strips" and rt.ctas == sms
    assert path_mod.strip_smem(rt.strip, rt.h, rt.sr) <= smem
    w = wall(2 * rt.h + 3, 300, "int32", sms)
    small = rt._replace(strip=100, ctas=3)
    got = strips_mirror(torch.from_numpy(w), small)
    assert torch.equal(got, ref.pathfinder(torch.from_numpy(w)))


@pytest.mark.parametrize("R,C,h,ctas", [
    (1, 7, 8, 1), (2, 30, 8, 3), (9, 50, 8, 4), (26, 50, 8, 4),
    (33, 1_000, 8, 2), (40, 600, 16, 2), (45, 101, 4, 7)])
@pytest.mark.parametrize("dtype", ["int32", "float32"])
def test_strips_mirror_matches_plain_and_pallas(R, C, h, ctas, dtype):
    """One row; R - 1 short of, at and off a multiple of h; one CTA and
    several; a last strip narrower than h (50 columns over strips of 16);
    several row warps a CTA (strips of 500 and 300 columns); C off a
    multiple of the strip and of 4."""
    w = wall(R, C, dtype, R + C)
    rt = path_mod.strips(C, h, ctas)
    assert rt is not None and rt.ctas == ctas
    got = strips_mirror(torch.from_numpy(w), rt)
    assert torch.equal(got, ref.pathfinder(torch.from_numpy(w)))
    want = np.asarray(ref_ops.pathfinder(w, interpret=True))
    np.testing.assert_array_equal(got.numpy(), want)


def test_strips_mirror_special_values():
    """+inf rows and columns, -inf, NaN and values near 3e38 through the
    schedule: equal to the plain version, NaN where NaN."""
    rng = np.random.RandomState(3)
    w = rng.uniform(0, 10, (30, 70)).astype(np.float32)
    w[:, 0] = np.inf
    w[11] = np.inf
    w[rng.rand(30, 70) < 0.05] = 3e38
    w[4, 33] = -np.inf
    w[20, 17] = np.nan
    t = torch.from_numpy(w)
    got = strips_mirror(t, path_mod.strips(70, 8, 4))
    torch.testing.assert_close(got, ref.pathfinder(t), rtol=0, atol=0,
                               equal_nan=True)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(ref_ops.pathfinder(w, interpret=True)))


def test_strip_run_rejects_bad_routes():
    """The kernel's entries take CUDA walls and routes whose strips cover
    the columns; on the CPU ``pathfinder`` takes the plain version."""
    w = torch.zeros(50, 100, dtype=torch.int32)
    with pytest.raises(ValueError):
        path_mod.strip_run(w, path_mod.route(50, 100))
    with pytest.raises(ValueError):
        path_mod.pyramid(w)
    before = path_mod.pathfinder.launches + path_mod.pathfinder.pyramid_launches
    assert torch.equal(path_mod.pathfinder(w), ref.pathfinder(w))
    assert path_mod.pathfinder.launches + \
        path_mod.pathfinder.pyramid_launches == before
