"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips, with its reason, on a host without a
CUDA device.  This file imports no JAX (the card's host need not have it):

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import vector_engine as ve
from repro_torch.core import engine as eng
from repro_torch.core import isa, suite, tracegen
from repro_torch.kernels import blackscholes as bs_mod
from repro_torch.kernels import canneal as ca_mod
from repro_torch.kernels import decode_attention as da_mod
from repro_torch.kernels import _promote, engine_scan, ops, ref
from repro_torch.kernels import flash_attention as fa_mod
from repro_torch.kernels import flash_attention_bwd as fab_mod
from repro_torch.kernels import jacobi2d as j2_mod
from repro_torch.kernels import particlefilter as pf_mod
from repro_torch.kernels import pathfinder as path_mod
from repro_torch.kernels import segment_sum as ss_mod
from repro_torch.kernels import ssd_scan as ssd_mod
from repro_torch.kernels import streamcluster as sc_mod
from repro_torch.kernels import swaptions as sw_mod

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels are built with nvcc "
                    "and run only on the card")
    return torch.device("cuda")


def bs_inputs(n: int, seed: int):
    rng = np.random.RandomState(seed)
    f32 = np.float32
    return [rng.uniform(10, 100, n).astype(f32),
            rng.uniform(10, 100, n).astype(f32),
            rng.uniform(0.01, 0.1, n).astype(f32),
            rng.uniform(0.1, 0.6, n).astype(f32),
            rng.uniform(0.2, 2.0, n).astype(f32),
            (rng.uniform(size=n) > 0.5).astype(np.int32)]


@pytest.mark.parametrize("n", [1, 1000, 65_537])
def test_blackscholes_kernel_matches_plain(cuda, n):
    """Ragged sizes (the tail is masked, no tile requirement), 3e-5."""
    args = [torch.from_numpy(a).to(cuda) for a in bs_inputs(n, seed=n)]
    before = bs_mod.blackscholes.launches
    got = bs_mod.blackscholes(*args)
    assert bs_mod.blackscholes.launches == before + 1
    torch.testing.assert_close(got, ref.blackscholes(*args),
                               rtol=3e-5, atol=3e-5)


def test_engine_scan_kernel_matches_plain_bitwise(cuda):
    """Three apps x Table-10 corners, steady-state lanes: every output of
    the kernel equal to the plain version's."""
    cfgs = [eng.VectorEngineConfig(mvl=m, lanes=l, mshrs=k)
            for m in (8, 256) for l in (1, 8) for k in (1, 16)]
    pairs = [(a, c) for a in ("jacobi-2d", "canneal", "swaptions")
             for c in cfgs]
    bodies = [tracegen.body_for(a, suite.effective_mvl(a, c), c)
              for a, c in pairs]
    inp = eng.pack_steady_state(bodies, [c for _, c in pairs], 3, 4, cuda)
    before = engine_scan.scan.launches
    got = engine_scan.scan(*inp.args())
    assert engine_scan.scan.launches == before + 1
    assert torch.equal(got, engine_scan.scan_plain(*inp.args()))


def random_trace(seed: int, n_ops: int = 60):
    """A seeded random trace over every instruction kind (chip_smoke.py's
    phase-3 traces)."""
    rng = np.random.RandomState(seed)
    b = isa.TraceBuilder()
    reg = lambda: int(rng.randint(-1, 8))
    for _ in range(n_ops):
        k = rng.randint(8)
        vl = int((1, 8, 64, 200, 256)[rng.randint(5)])
        if k == 0:
            b.arith(vl, fu=int(rng.randint(4)), src1=reg(), src2=reg(),
                    dst=reg())
        elif k == 1:
            b.load(vl, dst=reg(), pattern=int(rng.randint(3)),
                   footprint_kb=float((8.0, 64.0, 2048.0)[rng.randint(3)]))
        elif k == 2:
            b.store(vl, src1=reg(), pattern=int(rng.randint(3)),
                    footprint_kb=float((8.0, 64.0, 2048.0)[rng.randint(3)]))
        elif k == 3:
            b.slide(vl, src1=reg(), dst=reg())
        elif k == 4:
            b.move(vl, src1=reg(), dst=reg())
        elif k == 5:
            b.reduce(vl, src1=reg(), dst=reg(), fu=int(rng.randint(4)))
        elif k == 6:
            b.mask_to_scalar(vl, src1=reg())
        else:
            b.scalar(int(rng.randint(1, 40)), fu=int(rng.randint(4)),
                     dep_scalar=bool(rng.randint(2)))
    return b.build()


_VARIANTS = [dict(ooo_issue=True), dict(interconnect="crossbar"),
             dict(mshrs=1), dict(l2_kb=1024),
             dict(ooo_issue=True, interconnect="crossbar", mshrs=1,
                  l2_kb=1024, queue_entries=8)]


def _scan_case(name, device):
    """The scan operands of one named case: chip_smoke.py's phase-3 sets,
    and ragged lanes (B 1, 31, 33, 481) with a lane of n_steps 0, ckpt 0,
    n_steps and half of it, bodies shorter than P (period < P) run long
    enough that the kernel's record ring wraps many times, and tiny ROB
    and queue capacities (a step reads the slot the one before wrote)."""
    import dataclasses
    if name == "short-body x Table 10":
        short = ("jacobi-2d", "pathfinder", "swaptions", "streamcluster")
        return suite.scan_inputs([(a, c) for a in short for c in ve.TABLE10],
                                 device=device)
    if name == "random traces":
        traces, cfgs = [], []
        for seed in range(40):
            base = ve.TABLE10[(7 * seed) % len(ve.TABLE10)]
            variant = _VARIANTS[seed % len(_VARIANTS)]
            cfgs.append(dataclasses.replace(base, **variant))
            traces.append(random_trace(seed))
        return eng.pack(traces, cfgs, [3 * len(t) for t in traces],
                        [len(t) for t in traces], device)
    B = int(name.split()[-1])
    traces = [random_trace(100 + k % 40, 5 + k % 50) for k in range(B)]
    if name.startswith("skewed"):
        # one long lane in each block of 32 among lanes of 0 to 3 steps:
        # the collect build's two warps run the long lane's tiles, the
        # other lanes none past their own
        n = [2000 + 7 * k if k % 32 == 5 else k % 4 for k in range(B)]
        return eng.pack(traces, [ve.TABLE10[k % len(ve.TABLE10)]
                                 for k in range(B)], n, n, device)
    cfgs = [dataclasses.replace(
        ve.TABLE10[k % len(ve.TABLE10)], rob_entries=1 + k % 4,
        queue_entries=1 + k % 3, phys_regs=33 + k % 2,
        ooo_issue=bool(k % 2)) for k in range(B)]
    n = [0 if k % 7 == 3 else 300 + (37 * k) % 200 for k in range(B)]
    ck = [0 if k % 3 == 0 else n[k] if k % 3 == 1 else n[k] // 2
          for k in range(B)]
    return eng.pack(traces, cfgs, n, ck, device)


SCAN_CASES = ["short-body x Table 10", "random traces", "ragged B 1",
              "ragged B 31", "ragged B 33", "ragged B 481"]


@pytest.mark.parametrize("case", SCAN_CASES)
def test_engine_scan_redesign_bitwise(cuda, case):
    """The pre-pass equals prepass_plain and the scan equals scan_plain,
    every output bit for bit; one launch counted a call."""
    inp = _scan_case(case, cuda)
    xi, xf, params, consts = inp.args()[:4]
    rec_f, rec_w = engine_scan.prepass(xi, xf, params, consts)
    want_f, want_w = engine_scan.prepass_plain(xi, xf, params, consts)
    assert torch.equal(rec_w, want_w)
    assert torch.equal(rec_f.view(torch.int32), want_f.view(torch.int32))
    before = engine_scan.scan.launches
    got = engine_scan.scan(*inp.args())
    assert engine_scan.scan.launches == before + 1
    assert torch.equal(got, engine_scan.scan_plain(*inp.args()))


COLLECT_CASES = SCAN_CASES[:-1] + ["ragged B 168", "skewed B 70"]


def _assert_same_bits(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("case", COLLECT_CASES)
def test_engine_scan_collect_bitwise(cuda, case):
    """The collect build against ``scan_plain(..., collect=True)``: its
    pre-pass words, the timing outputs, the STALL_KINDS accumulators, the
    lane-busy sums and the timeline, bit for bit; its timing outputs equal
    the default kernel's; one launch counted a call on its own counter."""
    inp = _scan_case(case, cuda)
    xi, xf, params, consts = inp.args()[:4]
    got_x = engine_scan.prepass(xi, xf, params, consts, collect=True)
    want_x = engine_scan.prepass_plain(xi, xf, params, consts, collect=True)
    for g, w in zip(got_x, want_x):
        _assert_same_bits(g, w)
    before, default = engine_scan.scan_collect.launches, engine_scan.scan.launches
    out, acc, rec = engine_scan.scan_collect(*inp.args())
    assert engine_scan.scan_collect.launches == before + 1
    assert engine_scan.scan.launches == default
    p_out, p_acc, p_rec = engine_scan.scan_plain(*inp.args(), collect=True)
    for g, w in ((out, p_out), (acc, p_acc), (rec, p_rec)):
        _assert_same_bits(g, w)
    _assert_same_bits(out, engine_scan.scan(*inp.args()))


def test_engine_scan_collect_without_steps(cuda):
    """Lanes that run no record: zero accumulators, an empty timeline, and
    no lanes at all."""
    inp = _scan_case("ragged B 33", cuda)
    inp.n_steps.zero_()
    inp.ckpt.zero_()
    out, acc, rec = engine_scan.scan_collect(*inp.args())
    assert rec.shape == (0, 33, 4) and not acc.any()
    _assert_same_bits(out, engine_scan.scan(*inp.args()))
    i32 = dict(dtype=torch.int32, device=cuda)
    f32 = dict(dtype=torch.float32, device=cuda)
    out, acc, rec = engine_scan.scan_collect(
        torch.zeros(10, 5, 0, **i32), torch.zeros(5, 0, **f32),
        torch.zeros(0, 20, **f32), inp.consts, *(torch.zeros(0, **i32)
                                                 for _ in range(3)))
    assert out.shape == (8, 0) and acc.shape == (23, 0)
    assert rec.shape == (0, 0, 4)


def test_simulate_collect_stats_on_the_card(cuda):
    """``simulate(collect_stats=True)`` on the card equals the CPU's, every
    stall, occupancy and record, and its timings equal the default's."""
    cfg = eng.VectorEngineConfig(mvl=64, lanes=4)
    for app in ("blackscholes", "canneal", "ssd_scan"):
        body = tracegen.body_for(app, suite.effective_mvl(app, cfg), cfg)
        tr = body.tile(3)
        got = eng.simulate(tr, cfg, collect_stats=True)
        want = eng.simulate(tr, cfg, collect_stats=True, device="cpu")
        base = eng.simulate(tr, cfg)
        assert got["stalls"] == want["stalls"]
        assert got["occ_lane_fu"] == want["occ_lane_fu"]
        for k, v in base.items():
            assert got[k] == v == want[k]
        for k, v in want["records"].items():
            assert np.array_equal(got["records"][k], v)


def test_kernel_launch_errors_raise(cuda):
    """A wrapper checks its operands before launching: a CPU operand beside
    CUDA ones is refused, never silently run on the host."""
    args = [torch.from_numpy(a).to(cuda) for a in bs_inputs(8, seed=0)]
    args[2] = args[2].cpu()
    with pytest.raises(ValueError, match="rate on cpu"):
        bs_mod.blackscholes(*args)


@pytest.mark.parametrize("n", [1, 1000, 65_537])
def test_cum_normal_inv_kernel_matches_plain(cuda, n):
    """Ragged sizes, the reference's bar rtol 1e-5 / atol 1e-6."""
    rng = np.random.RandomState(n)
    u = torch.from_numpy(rng.uniform(1e-5, 1 - 1e-5, n).astype(np.float32))
    u = u.to(cuda)
    before = sw_mod.cum_normal_inv.launches
    got = sw_mod.cum_normal_inv(u)
    assert sw_mod.cum_normal_inv.launches == before + 1
    torch.testing.assert_close(got, ref.cum_normal_inv(u), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("m,n,d", [(1, 1, 1), (1000, 129, 128),
                                   (300, 1000, 37), (65_537, 5, 16)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_streamcluster_kernel_matches_plain(cuda, m, n, d, dtype):
    """M, N and D off the 128 x 128 x 16 tiling; 2e-4 in float32 and 1e-2
    in the 16-bit types, the reference's bars."""
    rng = np.random.RandomState(m + n + d)
    tdt = getattr(torch, dtype)
    p = torch.from_numpy(rng.uniform(size=(m, d)).astype(np.float32))
    c = torch.from_numpy(rng.uniform(size=(n, d)).astype(np.float32))
    p, c = p.to(cuda, tdt), c.to(cuda, tdt)
    counter = sc_mod.COUNTERS[sc_mod.path(p, c)]
    before = getattr(sc_mod.streamcluster_dist, counter)
    got = sc_mod.streamcluster_dist(p, c)
    assert getattr(sc_mod.streamcluster_dist, counter) == before + 1
    tol = 2e-4 if dtype == "float32" else 1e-2
    torch.testing.assert_close(got, ref.streamcluster_dist(p, c), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("m", [1, 1000, 65_537])
def test_find_index_kernel_matches_plain_exactly(cuda, m):
    """A monotone CDF of 5,000 entries (not a multiple of the kernel's
    2,048-entry tile) and, for the count semantics, an unsorted one."""
    rng = np.random.RandomState(m)
    u = torch.from_numpy(rng.uniform(size=m).astype(np.float32)).to(cuda)
    raw = rng.uniform(size=5000).astype(np.float32)
    for arr, search in ((np.sort(raw), True), (raw, False)):
        cdf = torch.from_numpy(arr).to(cuda)
        before = pf_mod.find_index.launches
        got = pf_mod.find_index(cdf, u)
        assert pf_mod.find_index.launches == before + 1
        assert torch.equal(got, ref.particlefilter_findindex(cdf, u))
        assert pf_mod.searched(pf_mod.find_index.last_flags) == search


def pf_edge_cases():
    """(cdf, u) of each edge the kernel's search and count paths must
    agree on (the cases of tests/test_torch_particlefilter.py)."""
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


@pytest.mark.parametrize("case", list(pf_edge_cases()))
def test_find_index_edges_match_plain_bitwise(cuda, case):
    """Each edge bit for bit; the search path runs where every adjacent
    pair is non-decreasing, the count elsewhere (the NaN in the CDF)."""
    cdf, u = (torch.from_numpy(a).to(cuda) for a in pf_edge_cases()[case])
    got = pf_mod.find_index(cdf, u)
    assert torch.equal(got, ref.particlefilter_findindex(cdf, u))
    assert pf_mod.searched(pf_mod.find_index.last_flags) == (
        case != "nan-in-cdf")


@pytest.mark.parametrize("n,m", [(100_000, 100_000), (1_000_003, 4_099),
                                 (262_145, 70_000)])
def test_find_index_paths_by_flags(cuda, n, m):
    """Rodinia's input (the CDF of normalized weights, systematic
    resampling's sorted queries) searches; the same CDF shuffled, or with
    one NaN, counts; past 262,144 entries the sample's stride doubles.
    Bit for bit with the plain version on every path, and again on a
    repeated call."""
    rng = np.random.RandomState(n)
    w = rng.uniform(size=n)
    cdf = np.cumsum(w / w.sum()).astype(np.float32)
    q = (rng.uniform(0, 1 / m) + np.arange(m) / m).astype(np.float32)
    nan = cdf.copy()
    nan[n // 3] = np.nan
    u = torch.from_numpy(q).to(cuda)
    for arr, search in ((cdf, True), (rng.permutation(cdf), False),
                        (nan, False)):
        c = torch.from_numpy(arr).to(cuda)
        got = pf_mod.find_index(c, u)
        flags = pf_mod.find_index.last_flags
        assert flags.shape == (pf_mod.FLAG_SLOTS + m,)
        assert pf_mod.searched(flags) == search
        assert torch.equal(got, ref.particlefilter_findindex(c, u))
        assert torch.equal(pf_mod.find_index(c, u), got)


def test_find_index_without_queries(cuda):
    cdf = torch.tensor([0.0, 0.5, 1.0], device=cuda)
    before = pf_mod.find_index.launches
    got = pf_mod.find_index(cdf, torch.zeros(0, device=cuda))
    assert got.shape == (0,) and got.dtype == torch.int32
    assert pf_mod.find_index.launches == before
    assert pf_mod.find_index.last_flags is None


def canneal_args(N, b, F, seed, device, lo=-1, hi=None):
    rng = np.random.RandomState(seed)
    locs = rng.randint(0, 1000, (N, 2)).astype(np.float32)
    fan = rng.randint(lo, N + 100 if hi is None else hi,
                      (b, F)).astype(np.int32)
    cand = [rng.randint(0, 1000, (b, 2)).astype(np.float32) for _ in "ab"]
    return [torch.from_numpy(a).to(device) for a in (locs, fan, *cand)]


@pytest.mark.parametrize("b", [1, 255, 256, 257, 5_000])
@pytest.mark.parametrize("F", [1, 22, 33, 64, 96])
def test_swap_cost_tiles_ragged(cuda, b, F):
    """The tile kernel: B below, at and off a multiple of the 256-swap
    tile; F of one slot, PARSEC's 22, past one and several 8-slot chunks;
    padding (-1 and below) anywhere in a row, indices past N."""
    args = canneal_args(4_000, b, F, b + F, cuda, lo=-9)
    assert ca_mod.route(F) == "tiles"
    before = ca_mod.swap_cost.launches
    got = ca_mod.swap_cost(*args)
    assert ca_mod.swap_cost.launches == before + 1
    for g, w in zip(got, ref.canneal_swap_cost(*args)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("offset", [1, 2, 3, 37 * 22])
def test_swap_cost_tiles_misaligned_fan(cuda, offset):
    """A fan_idx view ``offset`` words into its buffer (a row slice that
    starts mid-tile at 37 * 22): the unaligned head and tail of every
    tile's block come in word by word."""
    N, b, F = 4_000, 3_001, 22
    locs, fan, ca, cb = canneal_args(N, b, F, offset, cuda)
    buf = torch.empty(b * F + offset, dtype=torch.int32, device=cuda)
    view = buf[offset:].view(b, F)
    view.copy_(fan)
    before = ca_mod.swap_cost.launches
    got = ca_mod.swap_cost(locs, view, ca, cb)
    assert ca_mod.swap_cost.launches == before + 1
    for g, w in zip(got, ref.canneal_swap_cost(locs, fan, ca, cb)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("F", [1, 8, 9, 22, 96])
def test_swap_cost_rows_entry_any_width(cuda, F):
    """The row kernel through its own entry at widths the tile kernel
    takes on the main path (one chunk of eight gathers, a ragged chunk),
    bit for bit, counted as a row launch."""
    args = canneal_args(4_000, 1_000, F, 7 * F, cuda, lo=-9)
    before = ca_mod.swap_cost.launches, ca_mod.swap_cost.rows_launches
    got = ca_mod.rows(*args)
    assert (ca_mod.swap_cost.launches,
            ca_mod.swap_cost.rows_launches) == (before[0], before[1] + 1)
    for g, w in zip(got, ref.canneal_swap_cost(*args)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("F", [0, 97, 200])
def test_swap_cost_rows_route(cuda, F):
    """Rows wider than the tile kernel stages (or none) take the row
    kernel, bit for bit."""
    args = canneal_args(4_000, 1_000, F, F, cuda)
    assert ca_mod.route(F) == "rows"
    before = ca_mod.swap_cost.rows_launches
    got = ca_mod.swap_cost(*args)
    assert ca_mod.swap_cost.rows_launches == before + 1
    for g, w in zip(got, ref.canneal_swap_cost(*args)):
        assert torch.equal(g, w)


def test_swap_cost_middle_padding_and_clamp(cuda):
    """Padding in the middle of rows and indices past N in them, by
    construction: every third slot -1 or -5, every fifth N + 7."""
    N, b, F = 1_000, 2_000, 22
    locs, fan, ca, cb = canneal_args(N, b, F, 77, cuda, lo=0, hi=N)
    fan[:, 1::3] = -1
    fan[::2, 2::3] = -5
    fan[:, 4::5] = N + 7
    got = ca_mod.swap_cost(locs, fan, ca, cb)
    for g, w in zip(got, ref.canneal_swap_cost(locs, fan, ca, cb)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("b", [1, 1000, 65_537])
def test_swap_cost_kernel_matches_plain_bitwise(cuda, b):
    """Integer coordinates make every sum exact; -1 padding and indices
    past N (clamped to N-1) included."""
    rng = np.random.RandomState(b)
    N, F = 4000, 22
    locs = rng.randint(0, 1000, (N, 2)).astype(np.float32)
    fan = rng.randint(-1, N + 100, (b, F)).astype(np.int32)
    cand = [rng.randint(0, 1000, (b, 2)).astype(np.float32) for _ in "ab"]
    args = [torch.from_numpy(a).to(cuda) for a in (locs, fan, *cand)]
    before = ca_mod.swap_cost.launches
    got = ca_mod.swap_cost(*args)
    assert ca_mod.swap_cost.launches == before + 1
    for g, w in zip(got, ref.canneal_swap_cost(*args)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("shape", [(3, 3), (2, 5), (130, 3), (1001, 67),
                                   (33, 2800)])
def test_jacobi2d_kernel_matches_plain_bitwise(cuda, shape):
    """R and C off the kernel's 32 x 32 block, C = 3 (one interior column),
    a grid with no interior; three sweeps, every one equal to the plain
    version's (-fmad=false, the plain version's order of sums)."""
    rng = np.random.RandomState(sum(shape))
    a = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    got = want = a.to(cuda)
    for _ in range(3):
        before = step_counts()
        got = j2_mod.jacobi2d_step(got)
        assert sum(step_counts()) == sum(before) + 1
        want = ref.jacobi2d(want)
        assert torch.equal(got, want)


def step_counts():
    """The one-sweep kernel's launches: (vector route, width-one route)."""
    return (j2_mod.jacobi2d_step.launches,
            j2_mod.jacobi2d_step.width1_launches)


def step_and_route(a):
    """One sweep of ``a`` and the route its launch was counted on."""
    before = step_counts()
    got = j2_mod.jacobi2d_step(a)
    after = step_counts()
    assert sum(after) == sum(before) + 1
    return got, "vector" if after[0] > before[0] else "width1"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("shape", [(40, 256), (1001, 2800), (33, 136),
                                   (17, 8), (2, 16), (300, 264)])
def test_jacobi2d_step_both_routes_bitwise(cuda, dtype, shape):
    """C a multiple of 8: the vector route on the grid itself (16 bytes a
    thread), the width-one route on the same values in a view one element
    into a buffer; each sweep bit for bit with the plain version."""
    t = getattr(torch, dtype)
    rng = np.random.RandomState(sum(shape))
    a = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(
        cuda, t)
    buf = torch.empty(a.numel() + 1, dtype=t, device=cuda)
    view = buf[1:].view(shape)
    view.copy_(a)
    assert view.data_ptr() % 16 and j2_mod.step_width(shape[1], t,
                                                      view.data_ptr()) == 1
    want = ref.jacobi2d(a)
    for grid, route in ((a, "vector"), (view, "width1")):
        got, took = step_and_route(grid)
        assert took == route and got.dtype == t
        assert torch.equal(got, want), route


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_jacobi2d_step_grids_of_one_to_four(cuda, dtype):
    """R and C of 1, 2, 3 and 4: no interior, one point of it, a strip's
    lanes mostly idle; three sweeps each, bit for bit, on the route
    ``step_width`` names."""
    t = getattr(torch, dtype)
    for R in range(1, 5):
        for C in range(1, 5):
            rng = np.random.RandomState(10 * R + C)
            got = want = torch.from_numpy(rng.standard_normal(
                (R, C)).astype(np.float32)).to(cuda, t)
            for _ in range(3):
                width = j2_mod.step_width(C, t, got.data_ptr())
                got, took = step_and_route(got)
                want = ref.jacobi2d(want)
                assert took == ("width1" if width == 1 else "vector")
                assert torch.equal(got, want), (R, C)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("C", [2804, 2802, 2801, 263, 9])
def test_jacobi2d_step_columns_off_the_vector(cuda, dtype, C):
    """C not a multiple of 8 (float32 at 2,804 still a multiple of its 4):
    the route ``step_width`` picks, three sweeps bit for bit."""
    t = getattr(torch, dtype)
    rng = np.random.RandomState(C)
    got = want = torch.from_numpy(rng.standard_normal((65, C)).astype(
        np.float32)).to(cuda, t)
    for _ in range(3):
        width = j2_mod.step_width(C, t, got.data_ptr())
        got, took = step_and_route(got)
        want = ref.jacobi2d(want)
        assert took == ("width1" if width == 1 else "vector")
        assert width == (1 if C % (16 // t.itemsize) else 16 // t.itemsize)
        assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_jacobi2d_loop_route_from_an_offset_view(cuda, dtype):
    """The loop route from a view one element into its buffer runs every
    sweep at width one; ten sweeps bit for bit."""
    t = getattr(torch, dtype)
    rng = np.random.RandomState(5)
    buf = torch.from_numpy(rng.standard_normal(97 * 64 + 1).astype(
        np.float32)).to(cuda, t)
    a = buf[1:].view(97, 64)
    assert torch.equal(j2_mod.loop(a, 10), ref.jacobi2d(a, 10))


@pytest.mark.parametrize("shape", [(3, 3), (2, 5), (130, 3), (1001, 67),
                                   (33, 2800)])
def test_jacobi2d_kernel_bfloat16_matches_plain_bitwise(cuda, shape):
    """A bfloat16 grid: widened, summed in float32 in the plain version's
    order and rounded once on the store; three sweeps, bit for bit."""
    rng = np.random.RandomState(sum(shape))
    a = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    got = want = a.to(cuda, torch.bfloat16)
    for _ in range(3):
        got = j2_mod.jacobi2d_step(got)
        want = ref.jacobi2d(want)
        assert got.dtype == torch.bfloat16
        assert torch.equal(got, want)


def path_wall(R, C, dtype, seed):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, 10, (R, C)).astype(np.int32) if dtype == "int32"
            else rng.uniform(0, 10, (R, C)).astype(np.float32))


def path_launches():
    return path_mod.pathfinder.launches + path_mod.pathfinder.pyramid_launches


def assert_same_bits(got, want):
    """Equal values, NaN where NaN (the kernels keep the plain version's
    NaN from torch.minimum)."""
    assert got.dtype == want.dtype and got.shape == want.shape
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize("R,C", [(1, 7), (2, 1), (21, 3), (45, 255),
                                 (41, 1000), (62, 100_003)])
@pytest.mark.parametrize("dtype", ["int32", "float32"])
def test_pathfinder_kernel_matches_plain_bitwise(cuda, R, C, dtype):
    """Through the plan: R from one row to 41 (the pyramid route) and
    past them (the strip route), C off the strip width down to 1; int and
    float walls; the device operations the route states."""
    w = torch.from_numpy(path_wall(R, C, dtype, R + C)).to(cuda)
    before = path_launches()
    got = path_mod.pathfinder(w)
    assert path_launches() == before + path_mod.route(R, C).launches
    assert torch.equal(got, ref.pathfinder(w))


@pytest.mark.parametrize("R,C", [(1, 7), (2, 1), (21, 3), (45, 255),
                                 (41, 1000), (62, 100_003)])
@pytest.mark.parametrize("dtype", ["int32", "float32"])
def test_pathfinder_pyramid_matches_plain_bitwise(cuda, R, C, dtype):
    """The pyramid route on its own: R across the 20-row pyramid (one row,
    one launch, a ragged last launch), C off the 216-column stride."""
    w = torch.from_numpy(path_wall(R, C, dtype, R + C)).to(cuda)
    before = path_mod.pathfinder.pyramid_launches
    got = path_mod.pyramid(w)
    assert path_mod.pathfinder.pyramid_launches == before + max(
        1, -(-(R - 1) // 20))
    assert torch.equal(got, ref.pathfinder(w))


@pytest.mark.parametrize("R", [1, 2, 20, 32, 33, 34, 65, 100])
@pytest.mark.parametrize("C", [1, 3, 31, 760, 5_001, 100_000, 100_003])
def test_pathfinder_strips_rows_and_columns(cuda, R, C):
    """The strip route: one row (wall[0] as float32), R - 1 short of, at
    and off a multiple of the 32-row phase; C within one strip, down to 1,
    off a multiple of the strip and of 4 (4-byte copies)."""
    w = torch.from_numpy(path_wall(R, C, "int32", 3 * R + C)).to(cuda)
    rt = path_mod.strips(C)
    before = path_mod.pathfinder.launches
    got = path_mod.strip_run(w, rt)
    assert path_mod.pathfinder.launches == before + 2
    assert torch.equal(got, ref.pathfinder(w))
    if R == 1:
        assert torch.equal(got, w[0].float())


@pytest.mark.parametrize("C,h,ctas", [
    (3_000, 4, 1), (3_000, 8, 1), (3_000, 16, 7), (3_000, 32, 7),
    (3_000, 16, 132), (3_000, 64, 132), (20_000, 64, 132),
    (100_000, 32, 132), (100_000, 16, 264), (100_000, 8, 264)])
@pytest.mark.parametrize("dtype", ["int32", "float32"])
def test_pathfinder_strips_any_phase_and_ctas(cuda, C, h, ctas, dtype):
    """The strip route under other rows a phase and CTA counts (one CTA;
    strips of h columns, whose two edges overlap; two CTAs an SM), 149
    row steps (a ragged last phase at each h), bit for bit."""
    R = 150
    rt = path_mod.strips(C, h, ctas)
    assert rt is not None
    assert path_mod.strips_fit(rt) >= rt.ctas
    w = torch.from_numpy(path_wall(R, C, dtype, h + ctas)).to(cuda)
    assert torch.equal(path_mod.strip_run(w, rt), ref.pathfinder(w))


def test_pathfinder_strips_misaligned_wall(cuda):
    """A wall view one element into its buffer: 4-byte copies."""
    R, C = 77, 4_000
    buf = torch.from_numpy(path_wall(1, R * C + 1, "int32", 9)[0]).to(cuda)
    w = buf[1:].view(R, C)
    assert w.data_ptr() % 16
    assert torch.equal(path_mod.pathfinder(w), ref.pathfinder(w))


def test_pathfinder_card_sizes_the_plan(cuda):
    """The plan takes the card's SMs and shared memory a CTA (``card``):
    Rodinia's strips, one CTA an SM, are all resident at once (an SM's
    occupancy times the SMs); a plan for a card of 114 SMs (an H100
    PCIe's count) runs here too, bit for bit."""
    sms, smem = path_mod.card(cuda)
    assert sms == torch.cuda.get_device_properties(cuda).multi_processor_count
    rt = path_mod.route(1_604, 100_000, sms, smem)
    assert rt.ctas == sms and path_mod.strips_fit(rt) >= rt.ctas
    w = torch.from_numpy(path_wall(150, 100_003, "int32", 114)).to(cuda)
    want = ref.pathfinder(w)
    for n in (sms, 114):
        rt = path_mod.route(*w.shape, n, smem)
        assert rt.name == "strips" and rt.ctas == n
        assert torch.equal(path_mod.strip_run(w, rt), want)


def test_pathfinder_strips_not_resident_raises(cuda):
    """More CTAs than the card holds at once: the launch fails loudly (no
    hang, no other route)."""
    rt = path_mod.strips(200_000, 64, 264)
    assert rt is not None
    assert path_mod.strips_fit(rt) < rt.ctas
    w = torch.zeros(40, 200_000, dtype=torch.int32, device=cuda)
    with pytest.raises(RuntimeError, match="cooperative|too large|CUDA"):
        path_mod.strip_run(w, rt)


@pytest.mark.parametrize("C", [380_160, 380_161, 443_521, 475_200, 475_201,
                               1_000_003])
def test_pathfinder_wide_walls(cuda, C):
    """Walls at the edges of each phase height's strips (h 32 to 380,160
    columns, 16 to 443,520, 8 to 475,200) and past the widest strips (the
    pyramid route), bit for bit."""
    R = 45
    w = torch.randint(0, 10, (R, C), dtype=torch.int32, device=cuda,
                      generator=torch.Generator(cuda).manual_seed(C))
    rt = path_mod.route(R, C)
    assert (rt.name == "pyramid") == (C > 475_200)
    before = path_launches()
    assert torch.equal(path_mod.pathfinder(w), ref.pathfinder(w))
    assert path_launches() == before + rt.launches


def test_pathfinder_widest_columns(cuda):
    """C past 2^30 (the wall's byte offsets past 32 bits), on the pyramid
    route; three rows."""
    R, C = 3, 2 ** 30 + 5
    w = torch.randint(0, 10, (R, C), dtype=torch.int32, device=cuda,
                      generator=torch.Generator(cuda).manual_seed(3))
    assert path_mod.route(R, C).name == "pyramid"
    got = path_mod.pathfinder(w)
    want = ref.pathfinder(w)
    assert torch.equal(got, want)


# the walls of the end-value fault (the Pallas kernel's 3.0e38 past both
# ends), and walls of NaN, +-inf and values near 3e38
PATH_END_WALLS = {
    "inf_column": [[float("inf")], [1.0], [1.0]],
    "inf_row": [[float("inf"), float("inf")], [1.0, 1.0]],
    "nan": [[1.0, float("nan"), 3.0, 4.0], [1.0, 2.0, 3.0, 4.0],
            [5.0, 5.0, 5.0, 5.0]],
    "near_end": [[3e38, 2.9e38, 1.0], [1e38, 3.3e38, float("-inf")],
                 [1.0, 2.0, float("inf")]],
}


@pytest.mark.parametrize("name", sorted(PATH_END_WALLS))
@pytest.mark.parametrize("route", ["strips", "pyramid"])
def test_pathfinder_ends_match_plain(cuda, name, route):
    """Both routes hold the columns past the ends at float32 3.0e38, as the
    plain version (and the Pallas kernel) do: bit for bit, NaN where
    NaN."""
    w = torch.tensor(PATH_END_WALLS[name], dtype=torch.float32, device=cuda)
    got = (path_mod.strip_run(w, path_mod.strips(w.shape[1]))
           if route == "strips" else path_mod.pyramid(w))
    want = ref.pathfinder(w)
    assert_same_bits(got, want)
    if name in ("inf_column", "inf_row"):
        assert torch.equal(got, torch.full_like(got, 3e38))


@pytest.mark.parametrize("route", ["strips", "pyramid"])
def test_pathfinder_special_values_wide(cuda, route):
    """A 5,000-column float wall with NaN, +-inf and near-3e38 cells
    scattered, and a row of +inf: bit for bit, NaN where NaN."""
    rng = np.random.RandomState(23)
    R, C = 90, 5_000
    w = rng.uniform(0, 10, (R, C)).astype(np.float32)
    for v in (np.nan, np.inf, -np.inf, 3e38, 2.99e38, 3.01e38):
        w[rng.randint(0, R, 20), rng.randint(0, C, 20)] = v
    w[40] = np.inf
    w = torch.from_numpy(w).to(cuda)
    assert path_mod.route(R, C).name == "strips"
    fn = path_mod.pathfinder if route == "strips" else path_mod.pyramid
    assert_same_bits(fn(w), ref.pathfinder(w))


def fa_inputs(B, S, H, D, dtype, device, offset=0, seed=0):
    """q, k, v [B, S, H, D] of ``dtype``, each a view ``offset`` elements
    into its own buffer (an offset moves the rows off 16-byte alignment)."""
    rng = np.random.RandomState(seed + S + D)
    n = B * S * H * D
    return [torch.from_numpy(rng.standard_normal(n + offset).astype(
        np.float32)).to(device, getattr(torch, dtype))[offset:].view(
            B, S, H, D) for _ in range(3)]


@pytest.mark.parametrize("B,S,H,D,offset", [
    *((2, S, 3, D, 0) for S in (1, 100, 257, 300, 1031)
      for D in (40, 64, 96, 128)),
    (2, 300, 3, 37, 0),      # 74-byte rows: cp.async / plain loads
    (2, 257, 3, 64, 1),      # rows off 16-byte alignment
    (1, 2048, 4, 128, 0)])   # head width 128 over sixteen 128-row tiles
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_kernel_matches_plain(cuda, B, S, H, D, offset,
                                              causal, dtype):
    """S off the 128-row tiles (several of them, with a ragged tail), D off
    and on the 64-column panels, rows that are not 16-byte aligned, every
    load path; 2e-4 in float32 and 2e-2 in bfloat16, the reference's
    bars."""
    q, k, v = fa_inputs(B, S, H, D, dtype, cuda, offset)
    before = fa_mod.flash_attention.launches
    got = fa_mod.flash_attention(q, k, v, causal=causal)
    assert fa_mod.flash_attention.launches == before + 1
    tol = 2e-2 if dtype == "bfloat16" else 2e-4
    torch.testing.assert_close(got.float(),
                               ref.flash_attention(q, k, v, causal).float(),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("B,S,H,D,offset", [
    (2, 300, 3, 64, 0), (2, 257, 3, 128, 0), (2, 300, 3, 37, 0),
    (2, 257, 3, 64, 1), (1, 2048, 4, 128, 0)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_kernel_float16_matches_plain(cuda, B, S, H, D,
                                                      offset, causal):
    """float16 on the same wgmma kernel as bfloat16 (f16 operands, f32
    sums), every load path; 2e-2, the reference's 16-bit bar."""
    q, k, v = fa_inputs(B, S, H, D, "float16", cuda, offset)
    before = fa_mod.flash_attention.launches
    got = fa_mod.flash_attention(q, k, v, causal=causal)
    assert fa_mod.flash_attention.launches == before + 1
    assert got.dtype == torch.float16
    torch.testing.assert_close(got.float(),
                               ref.flash_attention(q, k, v, causal).float(),
                               rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("S,D", [(1, 256), (100, 129), (257, 200),
                                 (1031, 256)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_flash_attention_wide_route_matches_plain(cuda, S, D, causal,
                                                  dtype):
    """Heads of 129..256 take a route of their own and its launch count
    alone: float32 the 3xTF32 kernel's D-256 instantiation, the 16-bit
    types the wgmma kernel's D-256 instantiation; S off the 64-row tiles;
    2e-4 in float32, 2e-2 in 16 bits."""
    q, k, v = fa_inputs(2, S, 3, D, dtype, cuda)
    kernel = "3xtf32_256" if dtype == "float32" else "wgmma256"
    assert fa_mod.path(q, k, v).split("/")[0] == kernel
    got = launched_once(kernel, q, k, v, causal)
    tol = 2e-4 if dtype == "float32" else 2e-2
    torch.testing.assert_close(got.float(),
                               ref.flash_attention(q, k, v, causal).float(),
                               rtol=tol, atol=tol)


def launched_once(kernel, q, k, v, causal=True):
    """Flash attention's output, asserting that the call moved the launch
    counter of ``kernel`` (a route's first part) by one and no other."""
    fa = fa_mod.flash_attention
    names = sorted(set(fa_mod.COUNTERS.values()))
    before = {n: getattr(fa, n) for n in names}
    got = fa(q, k, v, causal=causal)
    want = dict(before)
    want[fa_mod.COUNTERS[kernel]] += 1
    assert {n: getattr(fa, n) for n in names} == want
    return got


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_kernel_schedules_heads_in_groups(cuda, causal):
    """float32 at S 16,384 and D 128 holds 16.8 MB of K and V a head, so
    the kernel schedules its 3 heads as groups of 2 and 1 (40 MB of L2 a
    group); every tile of every head is still computed, at 2e-4."""
    q, k, v = fa_inputs(1, 16_384, 3, 128, "float32", cuda)
    got = fa_mod.flash_attention(q, k, v, causal=causal)
    torch.testing.assert_close(got, ref.flash_attention(q, k, v, causal),
                               rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_kernel_is_deterministic(cuda, dtype):
    """Two calls on the same operands give bitwise-equal outputs: each
    output row is summed by one block in a fixed order."""
    q, k, v = fa_inputs(2, 1031, 4, 128, dtype, cuda)
    assert torch.equal(fa_mod.flash_attention(q, k, v),
                       fa_mod.flash_attention(q, k, v))


@pytest.mark.parametrize("kv_len", [0, 1, 1000, 1005, "per-batch"])
@pytest.mark.parametrize("D", [64, 128])
def test_decode_attention_kernel_matches_plain(cuda, kv_len, D):
    """S = 1,000 (off the kernel's 64-key group), kv_len in {0, 1, S, > S}
    and one length per batch entry; 0 is the mean of V."""
    B, S, H = 3, 1000, 4
    rng = np.random.RandomState(D)
    q = torch.from_numpy(rng.standard_normal((B, H, D)).astype(np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((B, S, H, D)).astype(
        np.float32)) for _ in range(2))
    lens = (np.array([0, 613, 2000]) if kv_len == "per-batch"
            else np.full(B, kv_len))
    q, k, v = q.to(cuda), k.to(cuda), v.to(cuda)
    lens = torch.from_numpy(lens.astype(np.int32)).to(cuda)
    before = da_mod.decode_attention.launches
    got = da_mod.decode_attention(q, k, v, lens)
    assert da_mod.decode_attention.launches == before + 1
    torch.testing.assert_close(got, ref.decode_attention(q, k, v, lens),
                               rtol=2e-4, atol=2e-4)
    for b in range(B):
        if int(lens[b]) <= 0:
            torch.testing.assert_close(got[b], v[b].mean(0), rtol=2e-4,
                                       atol=2e-4)


@pytest.mark.parametrize("q_type,kv_type,D", [
    ("bfloat16", "bfloat16", 64), ("float16", "float16", 128),
    ("float32", "bfloat16", 256), ("bfloat16", "bfloat16", 256),
    ("float32", "float32", 256), ("float32", "float16", 200),
    ("float16", "float16", 37)])
def test_decode_attention_kernel_types_and_widths_match_plain(cuda, q_type,
                                                              kv_type, D):
    """16-bit caches widened in the kernel's loads, q of its own type, and
    heads up to 256 (8 elements a lane); kv_len 0, 1, S and past S.  The
    reference's 2e-4 plus one unit of a 16-bit output."""
    B, S, H = 4, 1000, 2
    rng = np.random.RandomState(D)
    tq, tkv = getattr(torch, q_type), getattr(torch, kv_type)
    q = torch.from_numpy(rng.standard_normal((B, H, D)).astype(
        np.float32)).to(cuda, tq)
    k, v = (torch.from_numpy(rng.standard_normal((B, S, H, D)).astype(
        np.float32)).to(cuda, tkv) for _ in range(2))
    lens = torch.tensor([0, 1, 1000, 1500], dtype=torch.int32, device=cuda)
    before = da_mod.decode_attention.launches
    got = da_mod.decode_attention(q, k, v, lens)
    assert da_mod.decode_attention.launches == before + 1
    assert got.dtype == tq
    tol = 2e-4 + torch.finfo(tq).eps * (tq != torch.float32)
    torch.testing.assert_close(got.float(),
                               ref.decode_attention(q, k, v, lens).float(),
                               rtol=tol, atol=tol)


def ssd_inputs(b, S, H, P, N, seed):
    """``tests/test_kernels.py``'s draws (x, B, C scaled by 0.5, dt a
    softplus of normals, A = -exp(0.3 normal)) made with numpy."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    x = (rng.standard_normal((b, S, H, P)) * 0.5).astype(f32)
    dt = np.log1p(np.exp(rng.standard_normal((b, S, H)))).astype(f32)
    A = (-np.exp(rng.standard_normal(H) * 0.3)).astype(f32)
    B = (rng.standard_normal((b, S, N)) * 0.5).astype(f32)
    C = (rng.standard_normal((b, S, N)) * 0.5).astype(f32)
    return [torch.from_numpy(a) for a in (x, dt, A, B, C)]


@pytest.mark.parametrize("S,chunk", [(64, 64), (256, 256), (512, 128),
                                     (100, 50), (100, 256), (1000, 4096)],
                         ids=["one-tile-chunk", "one-chunk", "several-chunks",
                              "ragged-tiles", "chunk>S", "chunk>S-long"])
@pytest.mark.parametrize("P,N", [(16, 32), (64, 128), (40, 200), (128, 16)])
def test_ssd_scan_kernel_matches_plain(cuda, S, chunk, P, N):
    """S equal to one chunk, several chunks and chunk > S; S off the
    kernel's 64-step tile; P and N off its 16-wide thread tiles; the
    reference's bar, 4e-3."""
    x, dt, A, B, C = (t.to(cuda) for t in ssd_inputs(2, S, 3, P, N, S + P))
    before = ssd_mod.ssd_scan.launches
    got = ssd_mod.ssd_scan(x, dt, A, B, C, chunk=chunk)
    assert ssd_mod.ssd_scan.launches == before + 1
    torch.testing.assert_close(got, ref.ssd_scan(x, dt, A, B, C, chunk),
                               rtol=4e-3, atol=4e-3)


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_ssd_scan_kernel_half_x_matches_plain(cuda, dtype):
    """x in a 16-bit type: float32 inside, y in x's type.  4e-3 is the
    reference's float32 bar; the type's epsilon added to it is a one-unit
    allowance for the 16-bit output: both sides round float32 sums taken in
    different orders to that type, so they may land one unit in the last
    place apart (a wrong kernel is off by far more)."""
    x, dt, A, B, C = (t.to(cuda) for t in ssd_inputs(2, 512, 4, 64, 128, 7))
    x = x.to(getattr(torch, dtype))
    got = ssd_mod.ssd_scan(x, dt.to(torch.bfloat16), A, B, C, chunk=128)
    want = ref.ssd_scan(x, dt.to(torch.bfloat16), A, B, C, 128)
    assert got.dtype == x.dtype
    tol = 4e-3 + torch.finfo(x.dtype).eps
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("P", [192, 256, 129])
def test_ssd_scan_kernel_wide_heads_split_into_slices(cuda, P):
    """A head past 128 columns is split into equal P-slices (192: two of
    96, 256: two of 128, 129: 65 + 64), one block each; 4e-3."""
    x, dt, A, B, C = (t.to(cuda) for t in ssd_inputs(2, 256, 3, P, 64, P))
    before = ssd_mod.ssd_scan.launches
    got = ssd_mod.ssd_scan(x, dt, A, B, C, chunk=128)
    assert ssd_mod.ssd_scan.launches == before + 1
    torch.testing.assert_close(got, ref.ssd_scan(x, dt, A, B, C, 128),
                               rtol=4e-3, atol=4e-3)


@pytest.mark.parametrize("S,H,P,N,dtype,shape", [
    (1100, 6, 64, 128, "float32", (32, 4)), (640, 3, 256, 128, "float32",
                                             (64, 2)),
    (1100, 3, 129, 40, "float32", (64, 2)), (768, 4, 64, 128, "bfloat16",
                                             (32, 4)),
    (600, 3, 16, 360, "float32", (32, 2)), (600, 1, 1, 409, "float16",
                                            (32, 1))],
    ids=["suite-head", "P256", "P129-N40", "bf16-x", "N360", "N409-f16-x"])
def test_ssd_scan_chunk_parallel_matches_plain(cuda, S, H, P, N, dtype,
                                               shape):
    """Several 512-step chunks (the three passes; the last chunk ragged),
    heads split into P-slices of at most 64 (256: four; 129: three of 43),
    up to four heads a block of the output pass (H 6: a group of four and
    one of two; H 3: two and one), 32-step tiles where N needs the room
    (360 at P 16, and 409 at P 1, the widest the one-block kernel took at
    those P), x in each type; every pass's counter moves once; 4e-3, plus
    one unit of a 16-bit output."""
    x, dt, A, B, C = (t.to(cuda) for t in ssd_inputs(2, S, H, P, N, S + N))
    x = x.to(getattr(torch, dtype))
    pl = ssd_mod.plan(S, H, P, N)
    assert (pl.chunks, pl.steps, pl.heads) == (-(-S // 512), *shape)
    assert pl.width <= 64
    counters = ("launches", "chunk_launches", "state_launches")
    before = [getattr(ssd_mod.ssd_scan, c) for c in counters]
    got = ssd_mod.ssd_scan(x, dt, A, B, C, chunk=S)
    assert [getattr(ssd_mod.ssd_scan, c) - n
            for c, n in zip(counters, before)] == [1, 1, 1]
    assert got.dtype == x.dtype
    tol = 4e-3 + (torch.finfo(x.dtype).eps if dtype != "float32" else 0)
    torch.testing.assert_close(got.float(),
                               ref.ssd_scan(x, dt, A, B, C, S).float(),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("P,N", [(64, 128), (256, 128), (1, 409)])
def test_ssd_scan_kernel_is_deterministic(cuda, P, N):
    """No atomics: two calls give the same bits."""
    x, dt, A, B, C = (t.to(cuda) for t in ssd_inputs(2, 1024, 4, P, N, 5))
    assert torch.equal(ssd_mod.ssd_scan(x, dt, A, B, C, chunk=256),
                       ssd_mod.ssd_scan(x, dt, A, B, C, chunk=256))


@pytest.mark.parametrize("T,PS,N,hg,out", [
    (32, 64, 128, 4, 1), (64, 64, 128, 1, 0), (32, 43, 40, 1, 1),
    (32, 1, 409, 2, 1), (64, 16, 360, 1, 0), (32, 64, 256, 2, 1),
    (64, 64, 344, 1, 0), (32, 16, 688, 1, 1)])
def test_ssd_scan_plan_matches_the_kernels_layout(cuda, T, PS, N, hg, out):
    """The host's shared-memory count (what ``plan`` fits) is the
    kernels'."""
    assert ssd_mod._lib().ssd_scan_smem_bytes(T, PS, N, hg, out) == \
        ssd_mod.smem_bytes(T, PS, N, hg, bool(out))


@pytest.mark.parametrize("shape", [(32, 4, 64), (64, 2, 32), (64, 1, 64),
                                   (32, 2, 32), (32, 1, 64)])
def test_ssd_scan_every_tile_shape_matches_plain(cuda, shape):
    """Each (output tile steps, heads a block, chunk-pass tile steps) the
    plan may pick, forced through the passes at the suite's head (P 64, N
    128) with H 5 (groups of four and one, two, two and one): 4e-3."""
    x, dt, A, B, C = (t.to(cuda) for t in ssd_inputs(2, 1100, 5, 64, 128,
                                                     9))
    T, hg, chunk_T = shape
    pl = ssd_mod.Plan(T, 64, 1, hg, 3, chunk_T)
    Z, seg = ssd_mod.chunk_states(x, dt, A, B, pl)
    got = ssd_mod.output_pass(x, dt, A, B, C, ssd_mod.state_pass(Z, seg), pl)
    torch.testing.assert_close(got, ref.ssd_scan(x, dt, A, B, C, 1100),
                               rtol=4e-3, atol=4e-3)


def test_ssd_scan_kernel_rejects_what_it_cannot_take(cuda):
    """A sequence off the chunk is refused, as the reference refuses it;
    a state too wide for one block, (P 128, N 512), is computed on two
    N-panels, 4e-3 against the plain version."""
    x, dt, A, B, C = (t.to(cuda) for t in ssd_inputs(1, 96, 2, 16, 32, 3))
    with pytest.raises(ValueError, match="multiple of the chunk"):
        ssd_mod.ssd_scan(x, dt, A, B, C, chunk=64)
    x, dt, A, B, C = (t.to(cuda) for t in ssd_inputs(1, 96, 2, 128, 512, 3))
    got = ssd_mod.ssd_scan(x, dt, A, B, C, chunk=32)
    torch.testing.assert_close(got, ref.ssd_scan(x, dt, A, B, C, 32),
                               rtol=4e-3, atol=4e-3)


@pytest.mark.parametrize("S,H,P,N,dtype", [
    (1100, 3, 128, 512, "float32"), (1100, 2, 128, 1024, "float32"),
    (600, 2, 8, 2048, "float32"), (768, 4, 64, 417, "bfloat16"),
    (256, 3, 128, 512, "float16"), (96, 1, 1, 5000, "float32")],
    ids=["P128-N512", "P128-N1024", "P8-N2048", "N417-bf16-x",
         "N512-f16-x-one-chunk", "P1-N5000"])
def test_ssd_scan_n_panels_match_plain(cuda, S, H, P, N, dtype):
    """States too wide for one block, split into N-panels (the last ragged
    where N is not a multiple of the panel): every pass's counter moves
    once, pass (d) adds the panels' shares; 4e-3, plus one unit of a 16-bit
    output."""
    x, dt, A, B, C = (t.to(cuda) for t in ssd_inputs(2, S, H, P, N, S + N))
    x = x.to(getattr(torch, dtype))
    pl = ssd_mod.plan(S, H, P, N)
    assert pl.panel and -(-N // pl.panel) > 1
    counters = ("launches", "chunk_launches", "state_launches",
                "panel_launches")
    before = [getattr(ssd_mod.ssd_scan, c) for c in counters]
    got = ssd_mod.ssd_scan(x, dt, A, B, C, chunk=S)
    several = int(pl.chunks > 1)
    assert [getattr(ssd_mod.ssd_scan, c) - n
            for c, n in zip(counters, before)] == [1, several, several, 1]
    assert got.dtype == x.dtype
    tol = 4e-3 + (torch.finfo(x.dtype).eps if dtype != "float32" else 0)
    torch.testing.assert_close(got.float(),
                               ref.ssd_scan(x, dt, A, B, C, S).float(),
                               rtol=tol, atol=tol)


def test_ssd_scan_n_panels_are_deterministic(cuda):
    """The panels' shares are added in one order, with no atomics: two
    calls give the same bits."""
    x, dt, A, B, C = (t.to(cuda) for t in ssd_inputs(2, 1024, 3, 128, 1024,
                                                     6))
    assert torch.equal(ssd_mod.ssd_scan(x, dt, A, B, C, chunk=256),
                       ssd_mod.ssd_scan(x, dt, A, B, C, chunk=256))


# ---- flash attention at D 129..512 on wgmma; the SIMT route's old cases --

WGMMA256_CASES = [(129, 0, "ld"), (130, 0, "cp.async"), (160, 0, "tma"),
                  (160, 2, "cp.async"), (192, 0, "tma"), (201, 0, "ld"),
                  (256, 0, "tma"), (256, 2, "cp.async"), (256, 1, "ld")]


@pytest.mark.parametrize("D,offset,load", WGMMA256_CASES)
@pytest.mark.parametrize("S", [48, 100, 1000])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_flash_attention_wgmma256_matches_plain(cuda, D, offset, load, S,
                                                causal, dtype):
    """The wgmma kernel's D-256 instantiation (48-key tiles, three stages) on
    every load path: TMA, 4-byte cp.async (D even, an offset view) and
    plain loads (D odd, or rows 2-byte aligned); D 129..192 leaves the last
    panel unloaded; S on, off and across the 48-key tiles; 2e-2."""
    q, k, v = fa_inputs(2, S, 3, D, dtype, cuda, offset)
    assert fa_mod.path(q, k, v) == f"wgmma256/{load}"
    before = fa_mod.flash_attention.wgmma256_launches
    got = fa_mod.flash_attention(q, k, v, causal=causal)
    assert fa_mod.flash_attention.wgmma256_launches == before + 1
    assert got.dtype == q.dtype
    torch.testing.assert_close(got.float(),
                               ref.flash_attention(q, k, v, causal).float(),
                               rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_flash_attention_wgmma256_is_deterministic(cuda, dtype):
    q, k, v = fa_inputs(2, 1031, 4, 256, dtype, cuda)
    assert torch.equal(fa_mod.flash_attention(q, k, v),
                       fa_mod.flash_attention(q, k, v))


# every load path, and an even (D 384, 449, 512) and an odd (257..320: 5;
# 400: 7) count of live panels, where both consumer warpgroups multiply
# the middle one
WGMMA512_CASES = [(257, 0, "ld"), (264, 0, "tma"), (320, 0, "tma"),
                  (320, 2, "cp.async"), (384, 0, "tma"), (400, 0, "tma"),
                  (449, 0, "ld"), (512, 0, "tma"), (512, 2, "cp.async"),
                  (512, 1, "ld")]


@pytest.mark.parametrize("D,offset,load", WGMMA512_CASES)
@pytest.mark.parametrize("S", [1, 100, 1031])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_flash_attention_wgmma512_matches_plain(cuda, D, offset, load, S,
                                                causal, dtype):
    """The wgmma kernel's D-512 instantiation (64 query rows a block, both
    consumer warpgroups on them, 32-key tiles in two stages) on every load
    path: TMA, 4-byte cp.async (an offset view) and plain loads (D odd, or
    rows 2-byte aligned); S on, off and across the 64-row and 32-key tiles;
    2e-2."""
    q, k, v = fa_inputs(2, S, 3, D, dtype, cuda, offset)
    assert fa_mod.path(q, k, v) == f"wgmma512/{load}"
    before = fa_mod.flash_attention.wgmma512_launches
    got = fa_mod.flash_attention(q, k, v, causal=causal)
    assert fa_mod.flash_attention.wgmma512_launches == before + 1
    assert got.dtype == q.dtype
    torch.testing.assert_close(got.float(),
                               ref.flash_attention(q, k, v, causal).float(),
                               rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_flash_attention_wgmma512_is_deterministic(cuda, dtype):
    q, k, v = fa_inputs(2, 1031, 4, 512, dtype, cuda)
    assert torch.equal(fa_mod.flash_attention(q, k, v),
                       fa_mod.flash_attention(q, k, v))


@pytest.mark.parametrize("dtype,D", [
    ("float32", 200), ("float32", 257), ("float32", 320),
    ("bfloat16", 520), ("bfloat16", 640), ("float16", 520),
    ("float16", 640)])
@pytest.mark.parametrize("S", [100, 300])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_simt_past_256_matches_plain(cuda, D, S, causal,
                                                     dtype):
    """The heads the SIMT route took before the tensor cores reached them,
    each on its route now: float32 at 200 the 3xTF32 kernel's D-256
    instantiation; float32 past 256 the 3xTF32 sliced kernel (257 and 320:
    one slice of 5 panels); the 16-bit types past 512 the wgmma sliced
    kernel (520: 5 + 4 panels; 640: 5 + 5); 2e-4 in float32, 2e-2 in 16
    bits."""
    q, k, v = fa_inputs(2, S, 3, D, dtype, cuda)
    kernel = ("3xtf32_sliced" if dtype == "float32" and D > 256 else
              "3xtf32_256" if dtype == "float32" else "wgmma_sliced")
    assert fa_mod.path(q, k, v).split("/")[0] == kernel
    got = launched_once(kernel, q, k, v, causal)
    tol = 2e-4 if dtype == "float32" else 2e-2
    torch.testing.assert_close(got.float(),
                               ref.flash_attention(q, k, v, causal).float(),
                               rtol=tol, atol=tol)


# ---- 16-bit heads past 512 on the sliced kernel; float32 at D 129..256 ----

# every load path; Q resident (513..704: 9..11 panels, an odd count of
# panels in a slice at 513, 576 and 700's second) and streamed (768,
# 1,024, 1,100), two and three slices
SLICED_CASES = [(513, 0, "ld"), (576, 0, "tma"), (576, 2, "cp.async"),
                (640, 0, "tma"), (640, 1, "ld"), (700, 0, "cp.async"),
                (768, 0, "tma"), (768, 2, "cp.async"), (1024, 0, "tma"),
                (1100, 0, "cp.async"), (1100, 1, "ld")]


@pytest.mark.parametrize("D,offset,load", SLICED_CASES)
@pytest.mark.parametrize("S", [1, 100, 300, 1031])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_flash_attention_sliced_matches_plain(cuda, D, offset, load, S,
                                              causal, dtype):
    """The sliced kernel (output slices of at most 8 panels, S over all of
    D through the ring) on every load path, with Q resident and streamed;
    S on, off and across the 64-row and 32-key tiles; its own launch
    counter and no other; 2e-2."""
    q, k, v = fa_inputs(2, S, 3, D, dtype, cuda, offset)
    assert fa_mod.path(q, k, v) == f"wgmma_sliced/{load}"
    got = launched_once("wgmma_sliced", q, k, v, causal)
    assert got.dtype == q.dtype
    torch.testing.assert_close(got.float(),
                               ref.flash_attention(q, k, v, causal).float(),
                               rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("D", [640, 1100])
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_flash_attention_sliced_is_deterministic(cuda, D, dtype):
    q, k, v = fa_inputs(2, 1031, 4, D, dtype, cuda)
    assert torch.equal(fa_mod.flash_attention(q, k, v),
                       fa_mod.flash_attention(q, k, v))


def test_flash_attention_sliced_entry_checks_the_plan(cuda):
    """The C entry point refuses a plan that leaves a slice empty, does not
    cover D or overflows shared memory, and launches the wrapper's."""
    q, k, v = fa_inputs(1, 64, 1, 640, "bfloat16", cuda)
    out = torch.empty_like(q)
    lib = fa_mod._lib()
    plan = fa_mod.slice_plan(640)
    call = lambda n, panels, chunk, ring, qres: \
        lib.flash_attention_sliced_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), 1, 64,
            1, 640, 640 ** -0.5, 1, 1, 0, n, panels, chunk, ring, qres,
            torch.cuda.current_stream().cuda_stream)
    assert call(3, 5, 10, 2, 1) != 0     # the third slice is empty
    assert call(1, 8, 10, 2, 1) != 0     # 8 of 10 panels covered
    assert call(2, 5, 10, 3, 1) != 0     # 3 stages beside Q: 242 KB
    assert call(2, 5, 11, 2, 1) != 0     # a chunk of 11 of 10 panels
    assert call(*plan[:2], plan.chunk, plan.ring, int(plan.q_resident)) == 0
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(),
                               ref.flash_attention(q, k, v, True).float(),
                               rtol=2e-2, atol=2e-2)


TF32_256_CASES = [(129, 0, "cp.async4"), (160, 0, "cp.async16"),
                  (160, 1, "cp.async4"), (200, 0, "cp.async16"),
                  (255, 0, "cp.async4"), (256, 0, "cp.async16"),
                  (256, 2, "cp.async4")]


@pytest.mark.parametrize("D,offset,load", TF32_256_CASES)
@pytest.mark.parametrize("S", [1, 100, 300, 1031])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_3xtf32_256_matches_plain(cuda, D, offset, load, S,
                                                  causal):
    """The 3xTF32 kernel's D-256 instantiation (64 query rows, two warps on
    each 16 rows holding half the columns each, 32-key tiles) on both load
    paths (16-byte cp.async, and 4-byte where D % 4 or the rows' alignment
    rule it out); D 129..192 leaves the second half's warps one to eight
    column tiles; its own launch counter and no other; 2e-4, float32's
    bar."""
    q, k, v = fa_inputs(2, S, 3, D, "float32", cuda, offset)
    assert fa_mod.path(q, k, v) == f"3xtf32_256/{load}"
    got = launched_once("3xtf32_256", q, k, v, causal)
    torch.testing.assert_close(got, ref.flash_attention(q, k, v, causal),
                               rtol=2e-4, atol=2e-4)


def test_flash_attention_3xtf32_256_is_deterministic(cuda):
    q, k, v = fa_inputs(2, 1031, 4, 256, "float32", cuda)
    assert torch.equal(fa_mod.flash_attention(q, k, v),
                       fa_mod.flash_attention(q, k, v))


# ---- float32 heads past 256 on the 3xTF32 sliced kernel -------------------

# both load paths (16-byte cp.async; 4-byte where D % 4 or an offset view
# rule it out); one slice (257..512: 5 to 8 panels, the whole key tile a
# chunk), two (640: 5 + 5; 1,100: three of 6 with Q streamed); the last
# panel part-filled (257, 1,100)
TF32_SLICED_CASES = [(257, 0, "cp.async4"), (320, 0, "cp.async16"),
                     (512, 0, "cp.async16"), (512, 1, "cp.async4"),
                     (640, 0, "cp.async16"), (1100, 0, "cp.async16"),
                     (1100, 2, "cp.async4")]


@pytest.mark.parametrize("D,offset,load", TF32_SLICED_CASES)
@pytest.mark.parametrize("S", [1, 100, 300, 1031])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_3xtf32_sliced_matches_plain(cuda, D, offset, load,
                                                     S, causal):
    """The 3xTF32 sliced kernel (32 query rows, 16-key tiles, four warps on
    each 16 rows summing their partial scores) on both load paths, with Q
    resident and streamed; S on, off and across the 32-row and 16-key
    tiles; its own launch counter and no other; 2e-4, float32's bar."""
    q, k, v = fa_inputs(2, S, 3, D, "float32", cuda, offset)
    assert fa_mod.path(q, k, v) == f"3xtf32_sliced/{load}"
    got = launched_once("3xtf32_sliced", q, k, v, causal)
    torch.testing.assert_close(got, ref.flash_attention(q, k, v, causal),
                               rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("D", [512, 1100])
def test_flash_attention_3xtf32_sliced_is_deterministic(cuda, D):
    q, k, v = fa_inputs(2, 1031, 4, D, "float32", cuda)
    assert torch.equal(fa_mod.flash_attention(q, k, v),
                       fa_mod.flash_attention(q, k, v))


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_3xtf32_sliced_matches_float64(cuda, causal):
    """D 512 against softmax attention in float64 on 64 query rows of each
    head, 2e-4."""
    q, k, v = fa_inputs(1, 1024, 2, 512, "float32", cuda)
    got = fa_mod.flash_attention(q, k, v, causal=causal).double()
    rows = torch.linspace(0, 1023, 64, device=cuda).long()
    for h in range(2):
        s = q[0, rows, h].double() @ k[0, :, h].double().T / 512 ** 0.5
        if causal:
            keys = torch.arange(1024, device=cuda)
            s = s.masked_fill(keys[None] > rows[:, None], float("-inf"))
        want = s.softmax(-1) @ v[0, :, h].double()
        torch.testing.assert_close(got[0, rows, h], want, rtol=2e-4,
                                   atol=2e-4)


def test_flash_attention_3xtf32_sliced_entry_checks_the_plan(cuda):
    """The C entry point refuses a float32 plan that leaves a slice empty,
    overflows shared memory or asks for 16-byte copies of rows off 16
    bytes, and launches the wrapper's."""
    q, k, v = fa_inputs(1, 64, 1, 512, "float32", cuda)
    out = torch.empty_like(q)
    lib = fa_mod._lib()
    plan = fa_mod.tf32_slice_plan(512)
    call = lambda n, panels, chunk, ring, qres, load=16: \
        lib.flash_attention_sliced_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), 1, 64,
            1, 512, 512 ** -0.5, 1, 0, load, n, panels, chunk, ring, qres,
            torch.cuda.current_stream().cuda_stream)
    assert call(2, 8, 8, 2, 1) != 0      # the second slice is empty
    assert call(1, 8, 8, 3, 1) != 0      # 3 stages beside Q: 258 KB
    assert call(1, 8, 8, 2, 1, load=2) != 0   # no such float32 load
    assert call(*plan[:2], plan.chunk, plan.ring, int(plan.q_resident)) == 0
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref.flash_attention(q, k, v, True),
                               rtol=2e-4, atol=2e-4)


# ---- flash decoding, split-KV ----------------------------------------------

def decode_case(B, S, H, D, q_type, kv_type, lens, device, seed=0):
    rng = np.random.RandomState(seed + S + D)
    q = torch.from_numpy(rng.standard_normal((B, H, D)).astype(
        np.float32)).to(device, getattr(torch, q_type))
    k, v = (torch.from_numpy(rng.standard_normal((B, S, H, D)).astype(
        np.float32)).to(device, getattr(torch, kv_type)) for _ in range(2))
    return q, k, v, torch.tensor(lens, dtype=torch.int32, device=device)


def check_decode(q, k, v, lens):
    """One call: both kernels launched once, the plain version at the
    reference's 2e-4 plus one unit of a 16-bit output, kv_len <= 0 the mean
    of V, and the partials of the split kernel equal to its plain
    version's where the combine reads them."""
    counters = lambda: (da_mod.decode_attention.launches,
                        da_mod.decode_attention.combine_launches)
    before = counters()
    got = da_mod.decode_attention(q, k, v, lens)
    assert counters() == (before[0] + 1, before[1] + 1)
    assert got.dtype == q.dtype and got.shape == q.shape
    tol = 2e-4 + torch.finfo(q.dtype).eps * (q.dtype != torch.float32)
    torch.testing.assert_close(got.float(),
                               ref.decode_attention(q, k, v, lens).float(),
                               rtol=tol, atol=tol)
    for b in range(q.shape[0]):
        if int(lens[b]) <= 0:
            torch.testing.assert_close(got[b].float(), v[b].float().mean(0),
                                       rtol=tol, atol=tol)
    return got


@pytest.mark.parametrize("D", [1, 63, 64, 128, 256, 257, 512, 1000])
@pytest.mark.parametrize("q_type", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("kv_type", ["float32", "bfloat16", "float16"])
def test_decode_split_kv_matches_plain(cuda, D, q_type, kv_type):
    """Every q type x cache type and widths 1..1000 (16-byte loads where D
    allows, one element a load else; pieces past 512); S = 1,000 not a
    multiple of the split; kv_len 0, 1, a split boundary and one either
    side of it, S, and past S, in one batch."""
    S, H = 1000, 2
    q, k, v, _ = decode_case(1, S, H, D, q_type, kv_type, [1], cuda)
    L = da_mod.plan_for(q, k, v).len
    lens = [0, 1, L - 1, L, L + 1, S, S + 7]
    q, k, v, lens = decode_case(len(lens), S, H, D, q_type, kv_type, lens,
                                cuda)
    assert da_mod.plan_for(q, k, v).len == L and S % L
    check_decode(q, k, v, lens)


@pytest.mark.parametrize("B,S,H,D", [(1, 4096, 1, 64), (1, 37, 1, 8),
                                     (512, 64, 8, 64), (4, 300, 1024, 16),
                                     (3, 5000, 3, 200), (70_000, 3, 1, 8)])
@pytest.mark.parametrize("kv_type", ["float32", "bfloat16"])
def test_decode_split_kv_heads_and_batches(cuda, B, S, H, D, kv_type):
    """B*H = 1, B*H = 4,096 (many batch entries, many heads: several head
    groups a key position), a head of 200 and more batch entries than a
    grid's y or z dimension holds; random lengths with a 0."""
    rng = np.random.RandomState(B + S)
    lens = rng.randint(1, S + 1, B)
    lens[0] = 0 if B > 1 else lens[0]
    q, k, v, lens = decode_case(B, S, H, D, "float32", kv_type,
                                lens.tolist(), cuda)
    check_decode(q, k, v, lens)


@pytest.mark.parametrize("D", [64, 512, 1000])
def test_decode_split_kv_partials_match_plain(cuda, D):
    """The split kernel's workspace (every split's m, l and sums, the
    neutral ones past kv_len included) against ``split_plain``, and the
    combine kernel against ``combine_plain`` on it."""
    q, k, v, lens = decode_case(4, 700, 3, D, "float32", "bfloat16",
                                [0, 5, 350, 700], cuda)
    pl = da_mod.plan_for(q, k, v)
    ws = da_mod.split(q, k, v, lens, pl)
    torch.testing.assert_close(ws, da_mod.split_plain(q, k, v, lens, pl),
                               rtol=2e-4, atol=2e-4)
    S = k.shape[1]
    out = torch.empty_like(q)
    torch.testing.assert_close(
        da_mod.combine(ws, lens, pl, S, out),
        da_mod.combine_plain(ws, lens, pl, S, q.shape, q.dtype),
        rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("kv_type", ["float32", "bfloat16"])
def test_decode_split_kv_is_deterministic(cuda, kv_type):
    """Splits merged in a fixed order: the same bits every call."""
    q, k, v, lens = decode_case(8, 3000, 4, 64, "float32", kv_type,
                                [0, 1, 100, 999, 1000, 2048, 3000, 2999],
                                cuda)
    assert torch.equal(da_mod.decode_attention(q, k, v, lens),
                       da_mod.decode_attention(q, k, v, lens))


# ---- the reference's widenings, in front of the kernels --------------------

@pytest.mark.parametrize("case", ["fa_mixed", "fa_int", "fa_f64", "fa_wide",
                                  "da_mixed", "da_int", "da_f64",
                                  "sc_mixed", "sc_int", "sc_f64",
                                  "ssd_int", "ssd_f64"])
def test_widened_operands_launch_the_kernel(cuda, case):
    """Mixed types, integers and 64-bit tensors: widened (or narrowed) by
    the wrapper, then the kernel launches (its counter moves) and matches
    the plain version of the same promoted operands, in the reference's
    output type."""
    rng = np.random.RandomState(len(case))
    f32 = lambda *shape: torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32)).to(cuda)
    ints = lambda *shape: torch.from_numpy(
        rng.randint(-3, 4, shape).astype(np.int32)).to(cuda)
    kind = case.split("_")[0]
    if kind == "fa":
        D = 320 if case == "fa_wide" else 64
        q, k, v = f32(2, 100, 3, D), f32(2, 100, 3, D), f32(2, 100, 3, D)
        args = {"fa_mixed": (q.bfloat16(), k, v.half()),
                "fa_int": (ints(2, 100, 3, D), k, ints(2, 100, 3, D)),
                "fa_f64": (q.double(), k.double(), v.double()),
                "fa_wide": (q, k.bfloat16(), v)}[case]
        fn, plain, mod = fa_mod.flash_attention, ref.flash_attention, \
            fa_mod.flash_attention
        counter = "tf32_sliced_launches" if D > 256 else "launches"
        dtypes, tol = fa_mod.DTYPES, 2e-4
    elif kind == "da":
        q, k, v = f32(3, 4, 64), f32(3, 200, 4, 64), f32(3, 200, 4, 64)
        lens = torch.tensor([0, 50, 200], dtype=torch.int32, device=cuda)
        args = {"da_mixed": (q, k.bfloat16(), v.half(), lens),
                "da_int": (ints(3, 4, 64), ints(3, 200, 4, 64), v, lens),
                "da_f64": (q.double(), k.double(), v.double(), lens)}[case]
        fn, mod, counter = da_mod.decode_attention, da_mod.decode_attention, \
            "launches"
        plain = lambda q, k, v: ref.decode_attention(q, k, v, lens)
        args, dtypes, tol = args[:3], da_mod.DTYPES, 2e-4
        fn = lambda q, k, v, f=fn: f(q, k, v, lens)
    elif kind == "sc":
        p, c = f32(300, 40), f32(100, 40)
        args = {"sc_mixed": (p.bfloat16(), c),
                "sc_int": (ints(300, 40), c),
                "sc_f64": (p.double(), c.double())}[case]
        fn, plain, mod = sc_mod.streamcluster_dist, ref.streamcluster_dist, \
            sc_mod.streamcluster_dist
        counter, dtypes, tol = "tf32_launches", sc_mod.DTYPES, 2e-4
    else:
        x, dt, A, B, C = (t.to(cuda) for t in ssd_inputs(1, 128, 2, 16, 32,
                                                         3))
        if case == "ssd_int":
            x = ints(1, 128, 2, 16)
        else:
            x, dt, A, B, C = (t.double() for t in (x, dt, A, B, C))
        args = (x,)
        fn = lambda x: ssd_mod.ssd_scan(x, dt, A, B, C, chunk=64)
        plain = lambda x: ref.ssd_scan(x, dt.float(), A.float(), B.float(),
                                       C.float(), 64)
        mod, counter, dtypes, tol = ssd_mod.ssd_scan, "launches", \
            ssd_mod.X_DTYPES, 4e-3
    before = getattr(mod, counter)
    got = fn(*args)
    assert getattr(mod, counter) == before + 1
    promoted, out_dtype = _promote.promote(args, dtypes)
    if kind == "da":   # q and the cache are promoted apart
        promoted = (_promote.promote(args[:1], dtypes)[0][0],
                    *_promote.promote(args[1:], dtypes)[0])
    want = plain(*promoted)
    if kind != "sc":
        want = _promote.restore(want, out_dtype)
    assert got.dtype == want.dtype
    if not got.dtype.is_floating_point:
        assert (got.long() - want.long()).abs().max() <= 1
    else:   # a 16-bit output: one unit of its type as well
        tol += torch.finfo(got.dtype).eps * (got.dtype != torch.float32)
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol)


# ---- the widened operand types (Queue 3, fault 4) -------------------------

def half(dtype):
    return getattr(torch, dtype)


@pytest.mark.parametrize("dtype", ["bfloat16", "float16", "int32"])
def test_swap_cost_widens_coordinates(cuda, dtype):
    """16-bit or int32 locations and candidates, widened to float32 as the
    reference's kernel widens them: bit for bit the plain version on the
    widened values (integer coordinates keep every sum exact)."""
    rng = np.random.RandomState(5)
    N, b, F = 4000, 1000, 22
    locs = torch.from_numpy(rng.randint(0, 1000, (N, 2)).astype(np.float32))
    fan = torch.from_numpy(rng.randint(-1, N, (b, F)).astype(np.int32))
    cand = [torch.from_numpy(rng.randint(0, 1000, (b, 2)).astype(np.float32))
            for _ in "ab"]
    args = [t.to(cuda, half(dtype)) for t in (locs, *cand)]
    before = ca_mod.swap_cost.launches
    got = ca_mod.swap_cost(args[0], fan.to(cuda), *args[1:])
    assert ca_mod.swap_cost.launches == before + 1
    want = ref.canneal_swap_cost(args[0].float(), fan.to(cuda),
                                 *(t.float() for t in args[1:]))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and torch.equal(g, w)


@pytest.mark.parametrize("cdf_type,u_type", [
    ("bfloat16", "bfloat16"), ("float16", "float16"),
    ("float32", "bfloat16"), ("float16", "bfloat16")])
def test_find_index_widens_exactly(cuda, cdf_type, u_type):
    """16-bit CDFs and queries, and two float types: widened exactly, so
    the kernel's int32 indices equal the plain version's on the widened
    values, on the search path (sorted) and the count path (shuffled)."""
    rng = np.random.RandomState(8)
    raw = rng.uniform(size=5000).astype(np.float32)
    u = torch.from_numpy(rng.uniform(size=1000).astype(np.float32)).to(
        cuda, half(u_type))
    for arr in (np.sort(raw), raw):
        cdf = torch.from_numpy(arr).to(cuda, half(cdf_type))
        before = pf_mod.find_index.launches
        got = pf_mod.find_index(cdf, u)
        assert pf_mod.find_index.launches == before + 1
        assert got.dtype == torch.int32
        assert torch.equal(got, ref.particlefilter_findindex(cdf.float(),
                                                             u.float()))


@pytest.mark.parametrize("dtype", ["bfloat16", "float16", "int16"])
def test_pathfinder_widens_exactly(cuda, dtype):
    rng = np.random.RandomState(12)
    w = torch.from_numpy(rng.randint(0, 10, (45, 1001)).astype(np.float32))
    w = w.to(cuda, half(dtype))
    got = path_mod.pathfinder(w)
    assert got.dtype == torch.float32
    assert torch.equal(got, ref.pathfinder(w.float()))


@pytest.mark.parametrize("shape", [(3, 3), (130, 3), (1001, 67),
                                   (33, 2800)])
def test_jacobi2d_kernel_float16_matches_plain_bitwise(cuda, shape):
    """A float16 grid on the kernel's float16 instantiation: summed in
    float32, rounded once a sweep; three sweeps, bit for bit."""
    rng = np.random.RandomState(sum(shape))
    a = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    got = want = a.to(cuda, torch.float16)
    for _ in range(3):
        got = j2_mod.jacobi2d_step(got)
        want = ref.jacobi2d(want)
        assert got.dtype == torch.float16 and torch.equal(got, want)


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_blackscholes_and_swaptions_16bit(cuda, dtype):
    """16-bit inputs, widened to the float32 kernels and rounded once to
    the inputs' type: within the float32 bars plus one unit of the 16-bit
    output of the plain version on the widened values; a boolean is_call
    prices as int32 0/1."""
    t, eps = half(dtype), torch.finfo(half(dtype)).eps
    args = [torch.from_numpy(a).to(cuda) for a in bs_inputs(65_537, 3)]
    got = bs_mod.blackscholes(*(a.to(t) for a in args[:5]), args[5])
    assert got.dtype == t
    want = ref.blackscholes(*(a.to(t).float() for a in args[:5]),
                            args[5]).to(t)
    torch.testing.assert_close(got.float(), want.float(), rtol=3e-5 + eps,
                               atol=3e-5 + eps)
    assert torch.equal(bs_mod.blackscholes(*args[:5], args[5].bool()),
                       bs_mod.blackscholes(*args))
    u = torch.from_numpy(np.random.RandomState(4).uniform(
        1e-5, 1 - 1e-5, 65_537).astype(np.float32)).to(cuda, t)
    before = sw_mod.cum_normal_inv.launches
    got = sw_mod.cum_normal_inv(u)
    assert sw_mod.cum_normal_inv.launches == before + 1
    assert got.dtype == t
    torch.testing.assert_close(got.float(),
                               ref.cum_normal_inv(u.float()).to(t).float(),
                               rtol=1e-5 + eps, atol=1e-6 + eps)


# ---- no B*H or row cap (Queue 3, fault 5) ---------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_past_65535_heads(cuda, dtype):
    """B * H = 65,536 (B 65,536, S 1, H 1, D 8): one block a head on the
    one-dimensional grid, against the plain version."""
    q, k, v = fa_inputs(65_536, 1, 1, 8, dtype, cuda)
    got = fa_mod.flash_attention(q, k, v, causal=True)
    tol = 2e-4 if dtype == "float32" else 2e-2
    torch.testing.assert_close(got.float(),
                               ref.flash_attention(q, k, v).float(),
                               rtol=tol, atol=tol)


def test_jacobi2d_past_2097120_rows(cuda):
    """R 2,097,123 x C 3: past 65,535 row blocks of 32, which now round
    again over gridDim.y; bit for bit, a sweep and a loop of sweeps."""
    rng = np.random.RandomState(21)
    a = torch.from_numpy(rng.standard_normal((2_097_123, 3)).astype(
        np.float32)).to(cuda)
    assert torch.equal(j2_mod.jacobi2d_step(a), ref.jacobi2d(a))
    assert j2_mod.route(*a.shape, a.dtype).name == "loop"
    assert torch.equal(j2_mod.jacobi2d(a, 2), ref.jacobi2d(a, 2))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_jacobi2d_vector_route_past_2097120_rows(cuda, dtype):
    """R 2,097,123 x C 8 on the vector route: 131,071 tiles of 16 rows,
    more than the CTAs' warps, which stride over them; bit for bit."""
    t = getattr(torch, dtype)
    rng = np.random.RandomState(22)
    a = torch.from_numpy(rng.standard_normal((2_097_123, 8)).astype(
        np.float32)).to(cuda, t)
    got, took = step_and_route(a)
    assert took == "vector" and torch.equal(got, ref.jacobi2d(a))


# ---- Jacobi-2D's sweeps in one cluster launch (R4) ------------------------

def largest_square(dtype):
    n = 3
    while j2_mod.route(n + 1, n + 1, dtype).name == "cluster":
        n += 1
    return n


J2_SIDES = {"float32": 618, "bfloat16": 720, "float16": 720}


@pytest.mark.parametrize("iters", [1, 2, 1000])
@pytest.mark.parametrize("side", ["3", "5", "164", "165", "largest",
                                  "past-largest"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_jacobi2d_sweeps_match_plain_bitwise(cuda, dtype, side, iters):
    """Square grids on the cluster route (3, 5, RiVec's 164, 165 and the
    widest it takes) and on the loop route just past it: ``iters`` sweeps
    equal ``iters`` sweeps of the plain version bit for bit, a 16-bit grid
    rounded every sweep; the cluster route launches once, the tiled route
    (past the cluster, two sweeps or more) once every k sweeps, the loop
    route (past the cluster, one sweep) once a sweep."""
    t = half(dtype)
    assert largest_square(t) == J2_SIDES[dtype]
    n = {"largest": J2_SIDES[dtype],
         "past-largest": J2_SIDES[dtype] + 1}.get(side) or int(side)
    rng = np.random.RandomState(n + iters)
    a = torch.from_numpy(rng.standard_normal((n, n)).astype(np.float32))
    a = a.to(cuda, t)
    rt = j2_mod.route(n, n, t, iters=iters)
    assert rt.name == ("cluster" if side != "past-largest" else
                       "tiled" if iters > 1 else "loop")
    counters = lambda: (j2_mod.jacobi2d.launches,
                        j2_mod.jacobi2d.tiled_launches,
                        j2_mod.jacobi2d.loop_launches)
    before = counters()
    got = j2_mod.jacobi2d(a, iters)
    want = ([1, 0, 0] if rt.name == "cluster" else
            [0, -(-iters // rt.k), 0] if rt.name == "tiled" else
            [0, 0, iters])
    assert [x - y for x, y in zip(counters(), before)] == want
    assert got.dtype == t and torch.equal(got, ref.jacobi2d(a, iters))


@pytest.mark.parametrize("k", [1, 2, 3, 4])
@pytest.mark.parametrize("ctas", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("shape", [(150, 164), (67, 131)])
def test_jacobi2d_cluster_sizes_match_plain_bitwise(cuda, ctas, k, shape):
    """Each cluster size the route may take (16 past the portable 8), the
    last CTAs holding fewer rows or none, and each number of sweeps
    between barriers (the halo rows updated twice over): 101 sweeps (the
    last block short of k), bit for bit."""
    rng = np.random.RandomState(ctas + k)
    a = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    a = a.to(cuda)
    before = j2_mod.jacobi2d.launches
    assert torch.equal(j2_mod.cluster(a, 101, ctas, k), ref.jacobi2d(a, 101))
    assert j2_mod.jacobi2d.launches == before + 1


def test_jacobi2d_zero_sweeps_and_ops(cuda):
    """No sweep is a copy; ``ops.jacobi2d`` takes a numpy float16 grid in
    its type onto the card."""
    a = torch.randn(40, 50, device=cuda)
    got = j2_mod.jacobi2d(a, 0)
    assert torch.equal(got, a) and got.data_ptr() != a.data_ptr()
    g = np.random.RandomState(1).standard_normal((40, 50)).astype(np.float16)
    got = ops.jacobi2d(g, 7)
    assert got.is_cuda and got.dtype == torch.float16
    assert torch.equal(got, ref.jacobi2d(torch.from_numpy(g).to(cuda), 7))


# ---- Jacobi-2D's tiled route past the cluster ------------------------------

J2_TILED_SHAPES = {"smaller-than-a-tile": (40, 50),
                   "tile-1": (95, 111), "tile": (96, 112),
                   "tile+1": (97, 113), "ragged": (300, 457),
                   "tall-narrow": (2_097_123, 3)}


@pytest.mark.parametrize("iters", ["0", "1", "k-1", "k+1", "1000"])
@pytest.mark.parametrize("shape", sorted(J2_TILED_SHAPES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_jacobi2d_tiled_matches_plain_bitwise(cuda, dtype, shape, iters):
    """The tiled kernel at the plan's tile and k, on grids smaller than a
    tile, a tile and one off it each way, ragged ones and 2,097,123 rows of
    3: ``iters`` sweeps equal the plain version's bit for bit, in
    ceil(iters / k) launches, the same bits on a second call."""
    t = half(dtype)
    rt = j2_mod.tiled_route(2_800, 2_800, t)
    R, C = J2_TILED_SHAPES[shape]
    n = {"k-1": rt.k - 1, "k+1": rt.k + 1}.get(iters) or int(iters)
    if shape == "tall-narrow" and n == 1000:
        n = 2 * rt.k + 3                      # the plain loop's own time
    rng = np.random.RandomState(R + C + n)
    a = torch.from_numpy(rng.standard_normal((R, C)).astype(np.float32))
    a = a.to(cuda, t)
    before = j2_mod.jacobi2d.tiled_launches
    got = j2_mod.tiled(a, n, rt.k, rt.tile)
    assert j2_mod.jacobi2d.tiled_launches == before + -(-n // rt.k)
    assert got.dtype == t and torch.equal(got, ref.jacobi2d(a, n))
    assert torch.equal(j2_mod.tiled(a, n, rt.k, rt.tile), got)


@pytest.mark.parametrize("k,tile,threads", [(1, (64, 64), 512),
                                            (3, (40, 100), 256),
                                            (8, (8, 8), 32),
                                            (5, (100, 30), 128)])
def test_jacobi2d_tiled_other_plans_match_plain_bitwise(cuda, k, tile,
                                                        threads):
    """Other tiles, k and CTA sizes (the variants script's), 23 sweeps of
    a 261 x 333 float32 grid."""
    rng = np.random.RandomState(k)
    a = torch.from_numpy(rng.standard_normal((261, 333)).astype(
        np.float32)).to(cuda)
    assert torch.equal(j2_mod.tiled(a, 23, k, tile, threads=threads),
                       ref.jacobi2d(a, 23))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_jacobi2d_polybench_on_the_tiled_route(cuda, dtype):
    """PolyBench EXTRALARGE through ``ops.jacobi2d``: 1,000 sweeps of
    2,800 x 2,800 in 125 launches, bit for bit."""
    t = half(dtype)
    a = torch.rand(2_800, 2_800, device=cuda, generator=torch.Generator(
        cuda).manual_seed(22)).to(t)
    assert j2_mod.route(2_800, 2_800, t, iters=1_000).name == "tiled"
    before = j2_mod.jacobi2d.tiled_launches
    got = ops.jacobi2d(a, 1_000)
    assert j2_mod.jacobi2d.tiled_launches == before + 125
    assert torch.equal(got, ref.jacobi2d(a, 1_000))


# ---- streamcluster on the tensor cores --------------------------------------

SC_MN = [(1, 1), (127, 129), (129, 127), (1_000, 4_097), (4_097, 1_000)]


@pytest.mark.parametrize("d", [8, 64, 128, 136, 200])
@pytest.mark.parametrize("mn", SC_MN, ids=lambda mn: f"{mn[0]}x{mn[1]}")
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_streamcluster_routes_match_plain(cuda, dtype, mn, d):
    """bfloat16 and float16 on wgmma (TMA), float32 on 3xTF32, ragged M and
    N around the 128 x 128 tile and D off the 64- and 32-column panels:
    within the reference's bar (2e-4 float32, 1e-2 16-bit) of the plain
    version and of float64, the route's counter moved, the same bits on a
    second call."""
    m, n = mn
    rng = np.random.RandomState(m + n + d)
    t = half(dtype)
    p = torch.from_numpy(rng.uniform(size=(m, d)).astype(np.float32))
    c = torch.from_numpy(rng.uniform(size=(n, d)).astype(np.float32))
    p, c = p.to(cuda, t), c.to(cuda, t)
    route = sc_mod.path(p, c)
    assert route == ("3xtf32/tma" if dtype == "float32"
                     else "wgmma/tma")
    counter = sc_mod.COUNTERS[route]
    before = getattr(sc_mod.streamcluster_dist, counter)
    got = sc_mod.streamcluster_dist(p, c)
    assert getattr(sc_mod.streamcluster_dist, counter) == before + 1
    tol = 2e-4 if dtype == "float32" else 1e-2
    torch.testing.assert_close(got, ref.streamcluster_dist(p, c), rtol=tol,
                               atol=tol)
    rows = slice(0, 64)
    exact = ((p[rows, None, :].double() - c[None].double()) ** 2).sum(-1)
    torch.testing.assert_close(got[rows].double(), exact, rtol=tol, atol=tol)
    assert torch.equal(sc_mod.streamcluster_dist(p, c), got)


@pytest.mark.parametrize("case", ["f32-offset", "f32-d130", "bf16-offset",
                                  "f16-d100", "bf16-d127", "f16-d1"])
def test_streamcluster_unaligned_routes_match_plain(cuda, case):
    """Operands TMA or 16-byte cp.async cannot take (a base off 16 bytes,
    rows not a multiple of 16 bytes): the plain-load and 4-byte cp.async
    routes, counted apart, within the bar of the plain version."""
    dtype, d, off = {"f32-offset": ("float32", 128, 1),
                     "f32-d130": ("float32", 130, 0),
                     "bf16-offset": ("bfloat16", 128, 3),
                     "f16-d100": ("float16", 100, 0),
                     "bf16-d127": ("bfloat16", 127, 0),
                     "f16-d1": ("float16", 1, 0)}[case]
    t = half(dtype)
    rng = np.random.RandomState(d + off)
    m, n = 300, 257
    raw = torch.from_numpy(rng.uniform(size=m * d + off).astype(np.float32))
    p = raw.to(cuda, t)[off:].view(m, d)
    c = torch.from_numpy(rng.uniform(size=(n, d)).astype(np.float32)).to(
        cuda, t)
    route = sc_mod.path(p, c)
    assert route == ("3xtf32/ld" if dtype == "float32"
                     else "wgmma/ld")
    counter = sc_mod.COUNTERS[route]
    before = getattr(sc_mod.streamcluster_dist, counter)
    got = sc_mod.streamcluster_dist(p, c)
    assert getattr(sc_mod.streamcluster_dist, counter) == before + 1
    tol = 2e-4 if dtype == "float32" else 1e-2
    torch.testing.assert_close(got, ref.streamcluster_dist(p, c), rtol=tol,
                               atol=tol)
    assert torch.equal(sc_mod.streamcluster_dist(p, c), got)



@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_streamcluster_centers_among_the_points(cuda, dtype):
    """PARSEC's centers are points of the stream, so some distances are 0
    and |p|^2 + |c|^2 ~ 43 cancels 2 p.c: every distance within the bar
    (an absolute 2e-4 there in float32) of the plain version and of
    float64, at D 128 and 200."""
    rng = np.random.RandomState(5)
    t = half(dtype)
    tol = 2e-4 if dtype == "float32" else 1e-2
    for d in (128, 200):
        pts = rng.uniform(size=(3_000, d)).astype(np.float32)
        idx = rng.choice(3_000, 700, replace=False)
        p = torch.from_numpy(pts).to(cuda, t)
        c = p[torch.from_numpy(idx).to(cuda)].contiguous()
        got = sc_mod.streamcluster_dist(p, c)
        torch.testing.assert_close(got, ref.streamcluster_dist(p, c),
                                   rtol=tol, atol=tol)
        rows = torch.from_numpy(idx[:64]).to(cuda)
        exact = ((p[rows, None].double() - c[None].double()) ** 2).sum(-1)
        torch.testing.assert_close(got[rows].double(), exact, rtol=tol,
                                   atol=tol)


# --------------------------------------------- the surrogate and the service

@pytest.fixture(scope="module")
def smoke_rows():
    """SPACE_SMOKE x the smoke apps explored on the card (one scan launch):
    the 128 training rows of the surrogate tests."""
    from repro_torch.core import dse
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the engine scan runs on the card")
    apps = ("blackscholes", "canneal")
    cache = dse.ResultCache()
    dse.explore(ve.SPACE_SMOKE, apps, cache=cache, device="cuda")
    return cache.export_training_rows(apps, ve.SPACE_SMOKE)


def test_surrogate_fit_is_bitwise_repeatable_on_the_card(cuda, smoke_rows):
    """Two fits with one seed give the same bits on the card (no
    deterministic-algorithms switch needed); another seed does not."""
    from repro_torch.core import surrogate
    m1, m2, m3 = (surrogate.fit(smoke_rows, steps=300, seed=s, device=cuda)
                  for s in (0, 0, 1))
    for k in surrogate.PARAM_NAMES:
        assert m1.params[k].is_cuda and torch.equal(m1.params[k],
                                                    m2.params[k]), k
    assert any(not torch.equal(m1.params[k], m3.params[k])
               for k in surrogate.PARAM_NAMES)
    assert not torch.backends.cuda.matmul.allow_tf32


def test_space_scorer_on_the_card_matches_the_cpu(cuda, smoke_rows):
    """The same model scored on the card and on the CPU: predictions at
    rtol 1e-5, the area at rtol 1e-6."""
    import dataclasses
    from repro_torch.core import surrogate
    model = surrogate.fit(smoke_rows, steps=300, seed=0, device=cuda)
    on_cpu = dataclasses.replace(
        model, params={k: v.cpu() for k, v in model.params.items()})
    idx = np.random.RandomState(3).randint(ve.SPACE_HUGE.size(), size=4096)
    got = surrogate.SpaceScorer(model, ve.SPACE_HUGE, "canneal").score(idx)
    want = surrogate.SpaceScorer(on_cpu, ve.SPACE_HUGE, "canneal").score(idx)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-6)


def test_build_count_grows_at_the_first_load_only(cuda):
    """``engine.jit_cache_size`` (``_build.builds``) counts a library's
    load once; loading it again, or launching it, adds nothing."""
    from repro_torch import _build
    _build.build_all(("swaptions",))
    _build._LIBS.pop("swaptions", None)      # as if never loaded here
    n0 = eng.jit_cache_size()
    _build.load("swaptions")
    assert eng.jit_cache_size() == n0 + 1 == _build.builds()
    _build.load("swaptions")
    sw_mod.cum_normal_inv(torch.rand(1000, device=cuda))
    assert eng.jit_cache_size() == n0 + 1


def test_service_on_the_card_serves_without_rebuilds(cuda):
    """After prewarm, a Poisson stream through the service on the card
    builds nothing and answers bitwise as the engine does."""
    from repro_torch.serve.sim_service import (SimService, poisson_arrivals,
                                               run_workload)
    svc = SimService(max_batch=16)
    assert svc.prewarm() == 2
    cfgs = tuple(ve.SPACE_SMOKE.sample(8, seed=1))
    rep = run_workload(svc, poisson_arrivals(
        48, 400.0, ("blackscholes", "canneal", "pathfinder:asm"), cfgs,
        seed=0))
    assert rep.recompiles == 0 and rep.shed == 0 and rep.dispatched > 0
    for r in rep.results[:8]:
        body = tracegen.body_for(r.app, suite.effective_mvl(
            r.app, _cfg_of(cfgs, r.label)), _cfg_of(cfgs, r.label))
        want = eng.steady_state_time_batch([body], [_cfg_of(cfgs, r.label)],
                                           device=cuda)[0]
        assert r.steady_ns == want


def _cfg_of(cfgs, label):
    return next(c for c in cfgs if c.label() == label)


# ---- the model server: the families on the card ----------------------------

# one smoke-width config of each family, float32
MODEL_ARCHS = ("llama3-8b", "dbrx-132b", "mamba2-130m", "jamba-v0.1-52b",
               "whisper-small", "internvl2-76b")


def _smoke_batch(cfg, B, S, seed):
    """Seeded tokens (and the stub frames / patches) on the CPU."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32))}
    if cfg.family == "encdec":
        batch["frames"] = torch.from_numpy(rng.standard_normal(
            (B, cfg.num_frames, cfg.d_model)).astype(np.float32))
    if cfg.family == "vlm":
        batch["patches"] = torch.from_numpy(rng.standard_normal(
            (B, cfg.num_patches, cfg.d_model)).astype(np.float32))
    return batch


@pytest.mark.parametrize("arch", MODEL_ARCHS)
def test_model_on_the_card_matches_the_cpu(cuda, arch):
    """The card's prefill logits, caches and three decode steps (attention
    on the flash and decoding kernels) against the CPU's plain route on the
    same weights, within 1e-4 of the largest logit magnitude (float32
    throughout: products in other orders, attention in 3xTF32)."""
    from repro_torch.configs import get_config
    from repro_torch.models import build
    from repro_torch.models import layers as L
    cfg = get_config(arch).smoke()
    model = build(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    card_params = L.tree_map(lambda t: t.to(cuda), params)
    batch = _smoke_batch(cfg, 2, 8, seed=1)
    card_batch = {k: v.to(cuda) for k, v in batch.items()}
    pos = 8 + cfg.num_patches
    fa0, da0 = fa_mod.flash_attention.launches, \
        da_mod.decode_attention.launches
    want, cache = model.prefill(params, batch, 16 + cfg.num_patches)
    got, card_cache = model.prefill(card_params, card_batch,
                                    16 + cfg.num_patches)
    pairs = [(got, want)] + [(card_cache[k], cache[k]) for k in cache]
    rng = np.random.default_rng(2)
    for t in range(3):
        tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 1))
                               .astype(np.int32))
        want, cache = model.decode_step(params, cache, tok, pos + t)
        got, card_cache = model.decode_step(card_params, card_cache,
                                            tok.to(cuda), pos + t)
        pairs.append((got, want))
    pairs += [(card_cache[k], cache[k]) for k in cache]
    bar = 1e-4 * max(float(w.abs().max()) for _, w in pairs)
    for g, w in pairs:
        assert float((g.cpu().double() - w.double()).abs().max()) <= bar
    if cfg.family != "ssm":
        assert fa_mod.flash_attention.launches > fa0
        assert da_mod.decode_attention.launches > da0


def test_serve_engine_runs_on_the_attention_kernels(cuda):
    """A continuous-batching run on the card (qwen2.5-3b smoke, 5 requests
    through 2 slots) launches the flash and decoding kernels, and each
    request gets its budget of tokens in the padded vocabulary."""
    from repro_torch.configs import get_config
    from repro_torch.models import build
    from repro_torch.serve.engine import Request, ServeEngine
    cfg = get_config("qwen2.5-3b").smoke()
    model = build(cfg)
    params = model.init(torch.Generator(device=cuda).manual_seed(0))
    fa0, da0 = fa_mod.flash_attention.launches, \
        da_mod.decode_attention.launches
    eng = ServeEngine(model, params, batch_size=2, max_seq=16)
    for i in range(5):
        eng.submit(Request(uid=i, prompt=np.arange(4, dtype=np.int32) + i,
                           max_new_tokens=3))
    done = eng.run()
    assert [len(r.out_tokens) for r in done] == [3] * 5
    assert all(0 <= t < cfg.padded_vocab for r in done for t in r.out_tokens)
    assert fa_mod.flash_attention.launches - fa0 == \
        eng.prefill_rounds * cfg.num_layers
    assert da_mod.decode_attention.launches - da0 == \
        eng.decode_steps * cfg.num_layers


# ---- the trainer -------------------------------------------------------------

def _route_grads(monkeypatch, model, params, batch):
    """(kernel route's, plain route's) loss and gradients, and the flash
    launches of each."""
    from repro_torch.models import layers as L
    from repro_torch.train import trainstep as ts
    n0 = fa_mod.flash_attention.launches
    kernel = ts.value_and_grad(model, params, batch)
    n_k = fa_mod.flash_attention.launches - n0
    with monkeypatch.context() as m:
        m.setattr(L, "FlashAttention", L.PlainAttention)
        plain = ts.value_and_grad(model, params, batch)
    return kernel, plain, n_k


# the bars of chip_smoke.py's TRAIN_PARITY: every gradient leaf within this
# share of the plain leaf's largest magnitude
GRAD_ROUTE_TOL = {torch.float32: 1e-3, torch.bfloat16: 3e-2}


@pytest.mark.parametrize("arch,dtype,S", [
    ("qwen2.5-3b", "float32", 16), ("qwen2.5-3b", "bfloat16", 16),
    ("qwen2.5-3b", "bfloat16", 2304), ("dbrx-132b", "float32", 16),
    ("jamba-v0.1-52b", "float32", 16), ("whisper-small", "float32", 16),
    ("internvl2-76b", "float32", 16)])
def test_gradient_route_matches_the_plain_route(cuda, monkeypatch, arch,
                                                dtype, S):
    """Every gradient through the kernel route (``FlashAttention``: the
    flash kernel forward, the plain VJP backward) against native autograd
    through the plain route on the same weights and batch (remat on); the
    attention weights' gradients nonzero.  S 2,304 takes the chunked plain
    route."""
    from repro_torch.configs import get_config
    from repro_torch.models import build
    from repro_torch.models import layers as L
    cfg = get_config(arch).smoke().scaled(dtype=dtype, remat=True)
    model = build(cfg)
    params = model.init(torch.Generator(device=cuda).manual_seed(0))
    batch = {k: v.to(cuda) for k, v in _smoke_batch(cfg, 2, S, 1).items()}
    batch["labels"] = batch["tokens"].roll(-1, 1)
    if "frames" in batch:
        batch["frames"] = batch["frames"].to(cfg.torch_dtype)
    if "patches" in batch:
        batch["patches"] = batch["patches"].to(cfg.torch_dtype)
    (lk, gk), (lp, gp), n_k = _route_grads(monkeypatch, model, params, batch)
    assert n_k > 0
    tol = GRAD_ROUTE_TOL[cfg.torch_dtype]
    assert abs(float(lk) - float(lp)) <= tol * abs(float(lp))
    for (a, b) in zip(L.tree_leaves(gk), L.tree_leaves(gp)):
        scale = float(b.float().abs().max())
        assert float((a.float() - b.float()).abs().max()) <= tol * scale

    def attention_grads(tree):
        if not isinstance(tree, dict):
            return []
        return [g for k, sub in tree.items() for g in (
            [sub] if k in ("wq", "wk", "wv", "bq", "bk", "bv")
            and not isinstance(sub, dict) else attention_grads(sub))]

    attn = attention_grads(gk)
    assert attn and all(float(g.float().abs().max()) > 0 for g in attn)


def test_bf16_embedding_gradient_is_summed_in_float32_on_the_card(cuda):
    """On a Zipf batch of B 2 x S 4,096 (its first token ~2,100 times) the
    bf16 embedding gradient (qwen2.5-3b smoke, plain route) stays within
    ``GRAD_ROUTE_TOL``'s bf16 bar of the float32 gradient of the same
    weights upcast: ``embed_fwd`` sums it in float32, as on the CPU."""
    from repro_torch.configs import get_config
    from repro_torch.data import pipeline as dpipe
    from repro_torch.models import build
    from repro_torch.models import layers as L
    from repro_torch.train import trainstep as ts
    cfg = get_config("qwen2.5-3b").smoke().scaled(dtype="bfloat16")
    params = build(cfg).init(torch.Generator(device=cuda).manual_seed(0))
    batch = dpipe.batch_at(dpipe.DataConfig(cfg.vocab_size, 4096, 2, 2), 0,
                           cuda)
    assert int(batch["tokens"].flatten().bincount().max()) > 2000
    g16 = ts.value_and_grad(build(cfg), params, batch)[1]
    g32 = ts.value_and_grad(build(cfg.scaled(dtype="float32")),
                            L.tree_map(lambda t: t.float(), params),
                            batch)[1]
    a, b = g16["embed"]["embedding"].float(), g32["embed"]["embedding"]
    assert float((a - b).abs().max()) \
        <= GRAD_ROUTE_TOL[torch.bfloat16] * float(b.abs().max())


def test_flash_attention_function_backward_is_the_plain_vjp(cuda):
    """Past 128 columns ``FlashAttention``'s gradients are the plain
    route's VJP from the same saved inputs (float32, D 160, the chunked
    route), counted by ``plain_vjp_calls``; its forward is the kernel's
    (the 3xTF32 D-256 instantiation), counted."""
    from repro_torch.models import layers as L
    g = torch.Generator(device=cuda).manual_seed(3)
    q, k, v, dout = (torch.randn(1, 2304, 2, 160, generator=g, device=cuda)
                     for _ in range(4))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    n0 = fa_mod.flash_attention.tf32_256_launches
    b0 = (fab_mod.flash_attention_bwd.launches,
          fab_mod.flash_attention_bwd.plain_vjp_calls)
    out = L.FlashAttention.apply(*leaves, True)
    assert fa_mod.flash_attention.tf32_256_launches == n0 + 1
    got = torch.autograd.grad(out, leaves, dout)
    assert (fab_mod.flash_attention_bwd.launches,
            fab_mod.flash_attention_bwd.plain_vjp_calls) == (b0[0], b0[1] + 1)
    plain = [t.clone().requires_grad_() for t in (q, k, v)]
    want_out = L._plain_attn(*plain, True)
    want = torch.autograd.grad(want_out, plain, dout)
    assert torch.allclose(out, want_out, rtol=1e-4, atol=1e-4)
    for a, b in zip(got, want):
        assert torch.allclose(a, b, rtol=1e-6, atol=1e-6)


# the backward kernel against its plain version on the same inputs, as a
# share of each gradient's largest magnitude.  float32: 3xTF32 products
# (each split loses under 2^-20) summed in another order than the plain
# float32 products, ~2e-5 measured at S 1,000: 1e-4.  float16 and bfloat16:
# the kernel rounds P and dS to the inputs' type for the products with dO,
# K and Q, where the plain version keeps them in float32 (2^-11 and 2^-8
# relative each), and its gradients to that type: ~1e-3 (float16) and
# ~8e-3 (bfloat16, D 16, S 200) measured: 2^-7 and 2^-5
BWD_TOL = {torch.float32: 1e-4, torch.float16: 2 ** -7,
           torch.bfloat16: 2 ** -5}


def _attention_inputs(cuda, B, S, H, D, dtype, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    return [torch.randn(B, S, H, D, generator=g, device=cuda).to(dtype)
            for _ in range(4)]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S", [48, 200, 1000])
@pytest.mark.parametrize("D", [16, 32, 64, 72, 100, 128])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_flash_attention_bwd_kernel_matches_plain(cuda, dtype, D, S, causal):
    """dq, dk, dv of the kernel (16-bit: one pass over the kept pairs in
    three launches; float32: two passes; counted once) against
    ``ref.flash_attention_bwd`` on the same inputs, output and lse, within
    ``BWD_TOL``; D 72 no multiple of 16, D 100 zero-padded to 104; the
    forward's lse output leaves its output's bits as they are."""
    dt = getattr(torch, dtype)
    q, k, v, dout = _attention_inputs(cuda, 2, S, 3, D, dt, seed=D + S)
    out, lse = fa_mod.flash_attention_lse(q, k, v, causal)
    assert torch.equal(out, fa_mod.flash_attention(q, k, v, causal))
    torch.testing.assert_close(lse, ref.flash_attention_lse(
        q, k, v, causal)[1], rtol=1e-5, atol=1e-5)
    n0 = fab_mod.flash_attention_bwd.launches
    got = fab_mod.flash_attention_bwd(q, k, v, out, lse, dout, causal)
    assert fab_mod.flash_attention_bwd.launches == n0 + 1
    want = ref.flash_attention_bwd(q, k, v, out, lse, dout, causal)
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == dt
        scale = float(b.double().abs().max())
        assert float((a.double() - b.double()).abs().max()) \
            <= BWD_TOL[dt] * scale


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_bwd_kernel_is_bitwise_repeatable(cuda, dtype):
    """Two calls give the same bits (16-bit: dQ added in ascending
    key-block order; float32: no atomics): B 2, S 2,048, H 4, D 128,
    causal."""
    dt = getattr(torch, dtype)
    q, k, v, dout = _attention_inputs(cuda, 2, 2048, 4, 128, dt, seed=5)
    out, lse = fa_mod.flash_attention_lse(q, k, v, True)
    first = fab_mod.flash_attention_bwd(q, k, v, out, lse, dout, True)
    for _ in range(2):
        again = fab_mod.flash_attention_bwd(q, k, v, out, lse, dout, True)
        assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_bwd_repeats_bitwise_across_many_blocks(cuda,
                                                                causal):
    """B 4, S 4,096, H 16, D 128 bf16: 2,048 key blocks on the card's 132
    SMs, so key blocks wait on the dQ counters of blocks started long
    before them; three calls give the same bits."""
    q, k, v, dout = _attention_inputs(cuda, 4, 4096, 16, 128,
                                      torch.bfloat16, seed=11)
    out, lse = fa_mod.flash_attention_lse(q, k, v, causal)
    first = fab_mod.flash_attention_bwd(q, k, v, out, lse, dout, causal)
    for _ in range(2):
        again = fab_mod.flash_attention_bwd(q, k, v, out, lse, dout, causal)
        assert all(torch.equal(a, b) for a, b in zip(first, again))


def test_flash_attention_function_backward_runs_the_kernel(cuda):
    """At D <= 128 ``FlashAttention``'s backward is the backward kernel
    (counted; no plain VJP), and its gradients are within ``BWD_TOL`` of
    the plain route's VJP (float32, D 32, the chunked route)."""
    from repro_torch.models import layers as L
    q, k, v, dout = _attention_inputs(cuda, 1, 2304, 2, 32, torch.float32,
                                      seed=3)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    b0 = (fab_mod.flash_attention_bwd.launches,
          fab_mod.flash_attention_bwd.plain_vjp_calls)
    got = torch.autograd.grad(L.FlashAttention.apply(*leaves, True), leaves,
                              dout)
    assert (fab_mod.flash_attention_bwd.launches,
            fab_mod.flash_attention_bwd.plain_vjp_calls) == (b0[0] + 1, b0[1])
    plain = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(L._plain_attn(*plain, True), plain, dout)
    for a, b in zip(got, want):
        assert float((a - b).abs().max()) \
            <= BWD_TOL[torch.float32] * float(b.abs().max())


def test_segment_sum_kernel_matches_plain_and_repeats(cuda):
    """The segment sum of 4,096 Zipf-drawn indices x 1,000 columns (bf16 in)
    into 50,000 rows: float32 out within float32 rounding of the float64
    sums (n * 2^-24 * the sum of magnitudes, n the row's count), the bf16
    out that float32 sum rounded once, two calls bit for bit, rows no index
    points at zero."""
    rng = np.random.default_rng(0)
    V, N, D = 50_000, 4096, 1000
    idx = torch.from_numpy(np.minimum(rng.zipf(1.2, N) - 1, V - 1)).to(cuda)
    rows = torch.randn(N, D, device=cuda).to(torch.bfloat16)
    n0 = ss_mod.segment_sum.launches
    got = ss_mod.segment_sum(rows, idx, V, torch.float32)
    again = ss_mod.segment_sum(rows, idx, V, torch.float32)
    got16 = ss_mod.segment_sum(rows, idx, V)
    assert ss_mod.segment_sum.launches == n0 + 3
    assert torch.equal(got, again)
    assert torch.equal(got16, got.to(torch.bfloat16))
    f64 = torch.zeros(V, D, dtype=torch.float64, device=cuda).index_add_(
        0, idx, rows.double())
    mag = torch.zeros(V, D, dtype=torch.float64, device=cuda).index_add_(
        0, idx, rows.double().abs())
    n = torch.bincount(idx, minlength=V).double()[:, None]
    assert bool(((got.double() - f64).abs() <= n * 2 ** -24 * mag).all())
    assert not got[n[:, 0] == 0].any()


@pytest.mark.parametrize("D", [1000, 37])
@pytest.mark.parametrize("in_dtype,out_dtype", [
    ("bfloat16", "float32"), ("bfloat16", "bfloat16"), ("float32", "float32"),
    ("float16", "float16")])
def test_segment_sum_kernel_is_the_chunked_order_bit_for_bit(cuda, in_dtype,
                                                             out_dtype, D):
    """The kernel's sums are ``segment_sum_chunked``'s bits (the two-level
    order in plain torch, on the card): a row of 1,200 positions (past 4
    chunks), Zipf-drawn rows of every count, rows of one position and
    rows of none; D 1,000 takes the kernel's 16-byte path, D 37 its
    one-element path."""
    rng = np.random.default_rng(D)
    V, N = 20_000, 4096
    idx = np.minimum(rng.zipf(1.3, N) - 1, V - 1)
    idx[rng.choice(N, 1200, replace=False)] = 7
    assert np.bincount(idx).max() > 4 * ss_mod.CHUNK
    assert (np.bincount(idx) == 1).any()
    idx = torch.from_numpy(idx).to(cuda)
    rows = torch.from_numpy((rng.standard_normal((N, D))
                             * 10.0 ** rng.integers(-3, 4, (N, 1)))
                            .astype(np.float32)).to(cuda) \
        .to(getattr(torch, in_dtype))
    odt = getattr(torch, out_dtype)
    got = ss_mod.segment_sum(rows, idx, V, odt)
    want = ss_mod.segment_sum_chunked(rows, idx, V, odt)
    assert got.dtype == odt and torch.equal(got, want)


def test_moe_and_embedding_gradients_repeat_bitwise(cuda):
    """With torch's deterministic algorithms off, two forward + backward
    passes of granite-moe (smoke widths, eight experts, top 4) give the
    same loss and every gradient leaf bit for bit:
    the combine and the dispatch gather's backward sum in slot order, the
    embedding gradient is the segment-sum kernel, the attention backward
    has no atomics."""
    from repro_torch.configs import get_config
    from repro_torch.models import build
    from repro_torch.models import layers as L
    from repro_torch.train import trainstep as ts
    assert not torch.are_deterministic_algorithms_enabled()
    cfg = get_config("granite-moe-3b-a800m").smoke().scaled(
        num_experts=8, experts_per_token=4)
    model = build(cfg)
    params = model.init(torch.Generator(device=cuda).manual_seed(0))
    batch = {k: v.to(cuda) for k, v in _smoke_batch(cfg, 4, 64, 1).items()}
    batch["labels"] = batch["tokens"].roll(-1, 1)
    n0 = (ss_mod.segment_sum.launches, fab_mod.flash_attention_bwd.launches)
    l1, g1 = ts.value_and_grad(model, params, batch)
    l2, g2 = ts.value_and_grad(model, params, batch)
    assert ss_mod.segment_sum.launches - n0[0] == 2
    assert fab_mod.flash_attention_bwd.launches - n0[1] == 2 * cfg.num_layers
    assert torch.equal(l1, l2)
    assert all(torch.equal(a, b) for a, b in zip(L.tree_leaves(g1),
                                                 L.tree_leaves(g2)))


def test_full_width_train_step_on_the_card(cuda):
    """qwen2.5-3b whole (bf16, remat) takes one step of B 2 x S 4,096
    through ``build_train_step``: a finite loss near ln(vocab) for random
    weights, a finite gradient norm, the parameters moved, 72 flash
    launches (36 forward, 36 in the recompute), the moments nonzero.
    (At step 1 the warmup's rate, 3e-6, is below a bf16 weight's ulp:
    the weights themselves may not move yet, on either side.)"""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.data import pipeline as dpipe
    from repro_torch.models import build
    from repro_torch.train import optimizer as opt
    from repro_torch.train import trainstep as ts
    torch.cuda.empty_cache()
    cfg = get_config("qwen2.5-3b")
    model = build(cfg)
    params = model.init(torch.Generator(device=cuda).manual_seed(0))
    state = opt.init(params)
    batch = dpipe.batch_at(dpipe.DataConfig(cfg.vocab_size, 4096, 2), 0,
                           cuda)
    step = ts.build_train_step(model, InputShape("t", 4096, 2, "train"))[0]
    n0 = fa_mod.flash_attention.launches
    params, state, m = step(params, state, batch)
    assert fa_mod.flash_attention.launches - n0 == 2 * cfg.num_layers
    loss = float(m["loss"])
    assert np.isfinite(loss) and np.isfinite(float(m["grad_norm"]))
    assert abs(loss - np.log(cfg.padded_vocab)) < 3.0
    assert int(state.step) == 1
    for name in ("wq", "wk", "wv", "bq", "bk", "bv"):
        mu = state.mu["blocks"]["attn"][name]
        assert bool(torch.isfinite(mu).all()) and float(mu.abs().max()) > 0
    del params, state
    torch.cuda.empty_cache()


def test_checkpoint_round_trip_of_card_tensors(cuda, tmp_path):
    """A bf16 tree on the card saved and restored onto the card bit for
    bit, and the loop resumes it."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.models import build
    from repro_torch.models import layers as L
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import optimizer as opt
    from repro_torch.train.loop import LoopConfig, train
    cfg = get_config("qwen2.5-3b").smoke().scaled(dtype="bfloat16")
    model = build(cfg)
    params = model.init(torch.Generator(device=cuda).manual_seed(0))
    ckpt.save(str(tmp_path / "ck"), 0, params, opt.init(params))
    like = model.param_structs()
    got, st, _ = ckpt.restore(str(tmp_path / "ck"), 0, like, opt.init(like),
                              device=cuda)
    for a, b in zip(L.tree_leaves(params), L.tree_leaves(got)):
        assert b.device.type == "cuda" and torch.equal(a, b)
    state = train(model, InputShape("t", 16, 4, "train"), None,
                  loop_cfg=LoopConfig(total_steps=2, ckpt_every=1,
                                      ckpt_dir=str(tmp_path / "ck")),
                  device=cuda)
    assert state.restarts == 1 and state.step == 2
    assert all(np.isfinite(state.losses))


@pytest.fixture
def nccl_mesh(cuda, tmp_path):
    """A one-rank NCCL group on the card and its (1, 1) mesh (the
    reference's single-device baseline), destroyed after the test."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1,
                            device_id=torch.device("cuda", 0))
    try:
        yield make_host_mesh(data=1, model=1)
    finally:
        dist.destroy_process_group()


def test_mesh_decode_on_the_card_equals_the_one_device_step(cuda,
                                                            nccl_mesh):
    """llama3-8b ``.smoke()`` in bf16: prefill and decode through the mesh
    branches (``collectives.flash_decode_attention`` on the split and
    combine kernels) give the bits of the mesh=None steps."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.distributed import sharding as shd
    from repro_torch.models import build
    from repro_torch.train import trainstep as ts
    cfg = get_config("llama3-8b").smoke().scaled(dtype="bfloat16",
                                                 cache_dtype="bfloat16")
    model = build(cfg)
    params = model.init(torch.Generator(device=cuda).manual_seed(0))
    shape = InputShape("d", 64, 4, "decode")
    pf0 = ts.build_prefill_step(model, shape)[0]
    dec0 = ts.build_decode_step(model, shape)[0]
    pf, (p_sh, _), _, _ = ts.build_prefill_step(model, shape, nccl_mesh)
    dec = ts.build_decode_step(model, shape, nccl_mesh)[0]
    placed = shd.place_tree(params, p_sh)
    toks = torch.randint(0, cfg.vocab_size, (4, 9), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(1)).to(cuda)
    l0, c0 = pf0(params, {"tokens": toks})
    l1, c1 = pf(placed, {"tokens": toks})
    assert torch.equal(l0, shd.full(l1))
    tok = torch.argmax(l0[:, -1], -1)[:, None].to(torch.int32)
    n0 = (da_mod.decode_attention.launches,
          da_mod.decode_attention.combine_launches)
    for pos in range(9, 13):
        a, c0 = dec0(params, c0, tok, pos)
        b, c1 = dec(placed, c1, tok, pos)
        assert torch.equal(a, shd.full(b)), pos
        tok = torch.argmax(a[:, -1], -1)[:, None].to(torch.int32)
    assert (da_mod.decode_attention.launches - n0[0],
            da_mod.decode_attention.combine_launches - n0[1]) == \
        (2 * 4 * cfg.num_layers, 2 * 4 * cfg.num_layers)


def test_mesh_train_step_on_the_card_matches_the_one_device_step(
        cuda, nccl_mesh):
    """qwen2.5-3b ``.smoke()`` in float32: a step of the sharded trainer on
    the one-rank mesh against the mesh=None step, flash attention in the
    forward and the remat recompute."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.distributed import sharding as shd
    from repro_torch.models import build
    from repro_torch.models import layers as L
    from repro_torch.train import optimizer as opt
    from repro_torch.train import trainstep as ts
    cfg = get_config("qwen2.5-3b").smoke().scaled(remat=True)
    model = build(cfg)
    shape = InputShape("t", 16, 4, "train")
    g = torch.Generator().manual_seed(2)
    batch = {k: torch.randint(0, cfg.vocab_size, (4, 16), dtype=torch.int32,
                              generator=g).to(cuda)
             for k in ("tokens", "labels")}
    fresh = lambda: model.init(torch.Generator(device=cuda).manual_seed(0))
    p0 = fresh()
    p0, s0, m0 = ts.build_train_step(model, shape)[0](p0, opt.init(p0),
                                                      batch)
    fn, (p_sh, o_sh, _), _, _ = ts.build_train_step(model, shape, nccl_mesh)
    p1 = fresh()
    s1 = shd.place_tree(opt.init(p1), o_sh)
    p1 = shd.place_tree(p1, p_sh)
    n0 = fa_mod.flash_attention.launches
    p1, s1, m1 = fn(p1, s1, batch)
    assert fa_mod.flash_attention.launches - n0 == 2 * cfg.num_layers
    assert abs(float(m0["loss"]) - float(m1["loss"])) < 1e-5
    for a, b in zip(L.tree_leaves(p0), L.tree_leaves(p1)):
        torch.testing.assert_close(shd.full(b), a, rtol=1e-5, atol=1e-6)
