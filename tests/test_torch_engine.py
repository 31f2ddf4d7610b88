"""Port parity: the timing engine (plain PyTorch path on the CPU).

Identical inputs, made from numpy seeds, go through the reference
``repro.core.engine`` (JAX on the CPU) and ``repro_torch.core.engine`` with
``device="cpu"``.  Both evaluate the same float32 expressions in the same
order, but XLA's CPU backend contracts some ``a + b * c`` of the jitted
step into one FMA (for instance ``lead + n_acc * per`` of
``memory.vector_access_cycles``), which the port, like the reference's own
eager arithmetic, rounds twice.  So against the reference the bar is
rel <= 1e-6 per metric (most lanes agree bitwise; the measured worst is
~1e-7); inside the port — batched vs sequential, NOP padding — it is
bitwise.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import engine as ref_eng
from repro.core import isa as ref_isa
from repro.core import tracegen as ref_tg
from repro_torch import interop
from repro_torch.core import engine as eng
from repro_torch.core import isa, suite, tracegen
from repro_torch.kernels import engine_scan, ops

VLS = (1, 7, 8, 64, 200, 256)
FOOTPRINTS = (0.0, 8.0, 64.0, 2048.0)


def random_ref_trace(seed: int, n_ops: int = 40) -> ref_isa.Trace:
    """A seeded random trace over every kind, built with the reference's
    builder (the port receives its arrays through ``interop``)."""
    rng = np.random.RandomState(seed)
    b = ref_isa.TraceBuilder()
    reg = lambda: int(rng.randint(-1, 8))
    for _ in range(n_ops):
        k = rng.randint(8)
        vl = int(VLS[rng.randint(len(VLS))])
        fp = float(FOOTPRINTS[rng.randint(len(FOOTPRINTS))])
        if k == 0:
            b.arith(vl, fu=int(rng.randint(4)), src1=reg(), src2=reg(),
                    dst=reg())
        elif k == 1:
            b.load(vl, dst=reg(), pattern=int(rng.randint(3)), footprint_kb=fp)
        elif k == 2:
            b.store(vl, src1=reg(), pattern=int(rng.randint(3)),
                    footprint_kb=fp)
        elif k == 3:
            b.slide(vl, src1=reg(), dst=reg())
        elif k == 4:
            b.move(vl, src1=reg(), dst=reg())
        elif k == 5:
            b.reduce(vl, src1=reg(), dst=reg(), fu=int(rng.randint(4)))
        elif k == 6:
            b.mask_to_scalar(vl, src1=reg())
        else:
            b.scalar(int(rng.randint(0, 40)), fu=int(rng.randint(4)),
                     dep_scalar=bool(rng.randint(2)))
    return b.build()


def random_cfg_fields(seed: int) -> dict:
    rng = np.random.RandomState(seed + 777)
    pick = lambda xs: xs[rng.randint(len(xs))]
    return dict(
        mvl=pick((8, 64, 256)), lanes=pick((1, 2, 3, 4, 8, 16)),
        ooo_issue=bool(rng.randint(2)),
        interconnect=pick(("ring", "crossbar")),
        queue_entries=pick((1, 8, 16, 64)), rob_entries=pick((4, 32, 64)),
        phys_regs=pick((33, 40, 96)), vrf_read_ports=pick((1, 2)),
        mem_ports=pick((1, 2)), l1_kb=pick((16, 32)),
        l2_kb=pick((256, 1024)), mshrs=pick((1, 4, 16)),
        dram_bw_bytes_cycle=pick((3.0, 4.0, 8.0)),
        issue_width=pick((1, 2, 3)), branch_miss_penalty=pick((2.0, 6.0, 20.0)),
        fusion=bool(rng.randint(2)), lat_dram=pick((100.0, 150.5)))


def assert_rows_close(got, want, rtol=1e-6):
    """Row dicts (or floats) equal key by key within ``rtol`` relative."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = (g, w) if isinstance(w, dict) else ({"v": g}, {"v": w})
        assert g.keys() == w.keys()
        for k in w:
            assert abs(g[k] - w[k]) <= rtol * abs(w[k]), (k, g[k], w[k])


def pair(seed: int, n_ops: int = 40):
    """(ref trace, ref cfg, port trace, port cfg) from one seed."""
    rt = random_ref_trace(seed, n_ops)
    rc = ref_eng.VectorEngineConfig(**random_cfg_fields(seed))
    return (rt, rc, interop.trace_from_numpy(vars(rt)),
            interop.config_from_fields(dataclasses.asdict(rc)))


# ------------------------------------------------------------ configs

CFG_CASES = [dict(), dict(mvl=64, lanes=4), dict(ooo_issue=True),
             dict(interconnect="crossbar", fusion=True),
             dict(l2_kb=1024, mshrs=1), dict(dram_bw_bytes_cycle=4.000001),
             dict(lat_dram=100.1, issue_width=1, branch_miss_penalty=20.0),
             dict(phys_regs=96, rob_entries=64, queue_entries=64)]


@pytest.mark.parametrize("kw", CFG_CASES, ids=lambda kw: str(sorted(kw)))
def test_config_label_and_fingerprints_match(kw):
    ref, mine = ref_eng.VectorEngineConfig(**kw), eng.VectorEngineConfig(**kw)
    assert mine.label() == ref.label()
    assert eng.config_fingerprint(mine) == ref_eng.config_fingerprint(ref)
    assert dataclasses.asdict(mine) == dataclasses.asdict(ref)


def test_model_fingerprint_and_constants_match():
    """The copied calibration (SCALAR_CYCLES, VEC_PIPE_DEPTH,
    VEC_ELEM_CYCLES, memory constants) is bitwise the reference's."""
    assert eng.model_fingerprint() == ref_eng.model_fingerprint()
    assert eng.STALL_KINDS == ref_eng.STALL_KINDS
    assert eng.MAX_RING == ref_eng.MAX_RING


@pytest.mark.parametrize("kw", [dict(rob_entries=65), dict(queue_entries=65),
                                dict(phys_regs=97), dict(phys_regs=32),
                                dict(phys_regs=33), dict(rob_entries=64,
                                                         phys_regs=96)])
def test_post_init_rejects_the_same_configs(kw):
    def outcome(cls):
        try:
            cls(**kw)
            return None
        except ValueError as e:
            return str(e)
    assert outcome(eng.VectorEngineConfig) == outcome(ref_eng.VectorEngineConfig)


# ------------------------------------------------------------ simulate

@pytest.mark.parametrize("seed", range(6))
def test_simulate_matches_reference(seed):
    rt, rc, t, c = pair(seed)
    assert_rows_close([eng.simulate(t, c, device="cpu")],
                      [ref_eng.simulate(rt, rc)])


def test_simulate_batch_matches_reference():
    """Ragged lengths and mixed configs in one batch (40 lanes)."""
    pairs = [pair(100 + s, n_ops=10 + 3 * s) for s in range(40)]
    want = ref_eng.simulate_batch([p[0] for p in pairs], [p[1] for p in pairs])
    got = eng.simulate_batch([p[2] for p in pairs], [p[3] for p in pairs],
                             device="cpu")
    assert_rows_close(got, want)


def test_steady_state_matches_reference():
    """App bodies and random bodies, with and without utilization."""
    cases = [("pathfinder", dict(mvl=8, lanes=1)),
             ("jacobi-2d", dict(mvl=64, lanes=4, interconnect="crossbar")),
             ("swaptions", dict(mvl=256, lanes=8, l2_kb=1024)),
             ("streamcluster", dict(mvl=128, lanes=2, ooo_issue=True)),
             ("canneal", dict(mvl=16, lanes=8, mshrs=1))]
    rb = [ref_tg.body_for(a, kw["mvl"], ref_eng.VectorEngineConfig(**kw))
          for a, kw in cases] + [random_ref_trace(s, 25) for s in range(3)]
    rc = [ref_eng.VectorEngineConfig(**kw) for _, kw in cases] + \
        [ref_eng.VectorEngineConfig(**random_cfg_fields(s)) for s in range(3)]
    bodies = [interop.trace_from_numpy(vars(b)) for b in rb]
    cfgs = [interop.config_from_fields(dataclasses.asdict(c)) for c in rc]
    for util in (False, True):
        want = ref_eng.steady_state_time_batch(rb, rc, warmup=3, measure=5,
                                               with_util=util)
        got = eng.steady_state_time_batch(bodies, cfgs, warmup=3, measure=5,
                                          with_util=util, device="cpu")
        assert_rows_close(got, want)


def test_scalar_time_matches_reference():
    for seed in range(4):
        rt, rc, t, c = pair(seed)
        assert eng.scalar_time(t, c) == ref_eng.scalar_time(rt, rc)


# ------------------------------------------------------------ inside the port

def test_batched_equals_sequential_bitwise():
    pairs = [pair(200 + s, n_ops=5 + 11 * s) for s in range(6)]
    traces, cfgs = [p[2] for p in pairs], [p[3] for p in pairs]
    batched = eng.simulate_batch(traces, cfgs, device="cpu")
    assert batched == [eng.simulate(t, c, device="cpu")
                       for t, c in zip(traces, cfgs)]
    steady = eng.steady_state_time_batch(traces, cfgs, warmup=2, measure=3,
                                         device="cpu")
    assert steady == [eng.steady_state_time(t, c, warmup=2, measure=3,
                                            device="cpu")
                      for t, c in zip(traces, cfgs)]


@pytest.mark.parametrize("seed", range(3))
def test_nop_padding_is_bitwise_neutral(seed):
    _, _, t, c = pair(300 + seed)
    base = eng.simulate(t, c, device="cpu")
    for extra in (1, 17, 130):
        assert eng.simulate(t.pad_to(len(t) + extra), c, device="cpu") == base
    assert eng.simulate(isa.nop_trace(64), c, device="cpu")["time"] == 0.0


def test_warmup_checkpoint_equals_nop_padded_warmup():
    """The port checkpoints at the end of the warmup tiles; the reference
    pads the warmup with NOPs to a chunk boundary and reads the time there.
    NOPs being timing-neutral, both give the same steady state, bitwise."""
    for app, mvl in (("jacobi-2d", 64), ("canneal", 16), ("pathfinder", 256)):
        c = eng.VectorEngineConfig(mvl=mvl, lanes=4)
        body = tracegen.body_for(app, suite.effective_mvl(app, c), c)
        warm = body.tile(8)
        padded = warm.pad_to(1024)
        t1 = eng.simulate(warm, c, device="cpu")["time"]
        t1_padded = eng.simulate(padded, c, device="cpu")["time"]
        t2 = eng.simulate(padded.concat(body.tile(24)), c, device="cpu")["time"]
        assert t1 == t1_padded
        assert eng.steady_state_time(body, c, device="cpu") == (t2 - t1) / 24


def test_plain_scan_reads_bodies_tiled():
    """A lane stores its body once and the scan tiles it: the same as the
    materialized tiled trace."""
    _, _, t, c = pair(400, n_ops=13)
    inp = eng.pack([t], [c], [5 * len(t)], [2 * len(t)], "cpu")
    out = engine_scan.scan(*inp.args())
    full = eng.simulate(t.tile(5), c, device="cpu")
    part = eng.simulate(t.tile(2), c, device="cpu")
    assert [float(v) for v in out[:5, 0]] == [full[k] for k in eng.METRICS]
    assert float(out[5, 0]) == part["time"]
    assert float(out[6, 0]) == part["lane_busy"]


def test_pack_rejects_out_of_range_fields():
    bad = isa.Trace.from_records([dict(kind=isa.VARITH, vl=8, fu=4)])
    with pytest.raises(ValueError, match="fu"):
        eng.simulate(bad, eng.VectorEngineConfig(), device="cpu")
    bad = isa.Trace.from_records([dict(kind=isa.VARITH, vl=8, dst=32)])
    with pytest.raises(ValueError, match="register"):
        eng.simulate(bad, eng.VectorEngineConfig(), device="cpu")


# ------------------------------------------------------------ device guard

def _no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")


@pytest.mark.parametrize("call", [
    lambda: eng.simulate(isa.nop_trace(4), eng.VectorEngineConfig()),
    lambda: eng.simulate_batch([isa.nop_trace(4)], [eng.VectorEngineConfig()]),
    lambda: eng.steady_state_time_batch([isa.nop_trace(4)],
                                        [eng.VectorEngineConfig()]),
    lambda: suite.speedup_batch([("jacobi-2d", eng.VectorEngineConfig())]),
    lambda: suite.sweep("jacobi-2d", mvls=(8,), lanes=(1,)),
    lambda: suite.sweep_all(["jacobi-2d"], mvls=(8,), lanes=(1,)),
    lambda: ops.blackscholes(*([np.ones(4, np.float32)] * 5),
                             np.ones(4, np.int32)),
], ids=["simulate", "simulate_batch", "steady_state_time_batch",
        "speedup_batch", "sweep", "sweep_all", "ops.blackscholes"])
def test_entry_points_refuse_cpu_unless_asked(call):
    """With no CUDA device, an entry point called without ``device="cpu"``
    raises instead of quietly running on the host."""
    _no_card()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        call()
