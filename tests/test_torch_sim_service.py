"""Port parity: the simulation service (``repro_torch.serve.sim_service``).

The thirteen cases of ``tests/test_sim_service.py``, one for one, run on
the port with the engine on the CPU (``device="cpu"``: the plain PyTorch
scan); then the cross-package contract: ``poisson_arrivals`` gives the
reference's streams, and one seeded stream replayed back to back through
the reference's service and the port's is answered by the same tiers
(each request's ``source`` and ``batch_id``), with the same hit, coalesced
and dispatched counts and steady-state times within rel 1e-6 (the
engine's standing bar against the reference, ROADMAP Queue 3).  The build
count that stands for the reference's recompiles stays 0 on the CPU path.

Every service here times its cells over 2 warmup and 4 measured tiles
(the default is 8 and 24) to keep the plain scan's step loop short; the
paths and counters under test do not depend on the scan's length.
"""
import doctest
import json
import math

import numpy as np
import pytest
import torch

from repro.configs import vector_engine as ref_vcfg
from repro.core import dse as ref_dse
from repro.core import engine as ref_eng
from repro.serve import sim_service as ref_svc
from repro_torch.configs import vector_engine as vcfg
from repro_torch.core import dse
from repro_torch.core import engine as eng
from repro_torch.core import suite, tracegen
from repro_torch.serve import sim_service
from repro_torch.serve.sim_service import (SimService, poisson_arrivals,
                                           run_workload)

CPU = "cpu"
CFG_A = eng.VectorEngineConfig(mvl=64, lanes=4)
CFG_B = eng.VectorEngineConfig(mvl=16, lanes=2, mshrs=1)
TILES = dict(warmup=2, measure=4)


def service(**kw):
    return SimService(device=CPU, **TILES, **kw)


# ----------------------------------------------------------- serving paths

def test_cold_path_is_bitwise_the_batched_engine():
    svc = service()
    svc.submit("blackscholes", CFG_A)
    svc.submit("canneal", CFG_B)
    svc.drain()
    direct = {}
    for app, cfg in (("blackscholes", CFG_A), ("canneal", CFG_B)):
        body = tracegen.body_for(app, suite.effective_mvl(app, cfg), cfg)
        direct[app] = eng.steady_state_time_batch([body], [cfg], **TILES,
                                                  device=CPU)[0]
    by_app = {r.app: r for r in svc.completed}
    assert by_app["blackscholes"].steady_ns == direct["blackscholes"]
    assert by_app["canneal"].steady_ns == direct["canneal"]
    for app, cfg in (("blackscholes", CFG_A), ("canneal", CFG_B)):
        body = tracegen.body_for(app, suite.effective_mvl(app, cfg), cfg)
        want = suite.vector_runtime_from_per_chunk(app, cfg, body,
                                                   direct[app])
        assert by_app[app].runtime_ns == want
        assert by_app[app].speedup == suite.scalar_runtime_ns(app, cfg) / want


def test_hit_path_answers_without_dispatch_and_bitwise():
    svc = service()
    svc.submit("blackscholes", CFG_A)
    svc.drain()
    cold = svc.completed[0]
    n_batches = svc.n_batches
    hit = svc.submit("blackscholes", CFG_A)
    assert hit is not None and hit.source == "cache"
    assert hit.steady_ns == cold.steady_ns
    assert hit.runtime_ns == cold.runtime_ns
    assert svc.n_batches == n_batches


def test_identical_cold_requests_coalesce_into_one_dispatch():
    svc = service()
    for _ in range(4):
        svc.submit("blackscholes", CFG_A)
    assert svc.pending_requests() == 4
    svc.drain()
    assert svc.n_dispatched == 1
    assert svc.n_coalesced == 3
    assert len({r.steady_ns for r in svc.completed}) == 1
    assert sorted(r.source for r in svc.completed) == \
        ["batched", "coalesced", "coalesced", "coalesced"]


def test_mvl_alias_configs_share_a_cell():
    svc = service()
    svc.submit("streamcluster", eng.VectorEngineConfig(mvl=128, lanes=4))
    svc.submit("streamcluster", eng.VectorEngineConfig(mvl=256, lanes=4))
    assert svc.pending_requests() == 2
    svc.drain()
    assert svc.n_dispatched == 1 and svc.n_coalesced == 1
    a, b = svc.completed
    assert a.steady_ns == b.steady_ns


def test_asm_variant_and_kernel_trace_requests():
    svc = service()
    svc.submit("pathfinder:asm", CFG_A)
    body = tracegen.body_for("blackscholes",
                             suite.effective_mvl("blackscholes", CFG_A),
                             CFG_A)
    svc.submit(body, CFG_A)
    svc.drain()
    by_src = {r.app: r for r in svc.completed}
    asm = by_src["pathfinder:asm"]
    assert asm.steady_ns > 0 and np.isfinite(asm.runtime_ns)
    (kernel,) = [r for r in svc.completed if r.app.startswith("kernel:")]
    assert kernel.steady_ns > 0
    assert math.isnan(kernel.runtime_ns) and math.isnan(kernel.speedup)
    hit = svc.submit("blackscholes", CFG_A)
    assert hit is not None and hit.source == "cache"
    assert hit.steady_ns == kernel.steady_ns


def test_batch_fills_trigger_dispatch_without_flush():
    svc = service(max_batch=2)
    svc.submit("blackscholes", CFG_A)
    assert svc.n_batches == 0
    svc.submit("canneal", CFG_A)
    assert svc.n_batches == 1 and svc.pending_requests() == 0
    assert len(svc.completed) == 2


# ----------------------------------------------------- bounded queue limits

def test_bounded_queue_shed_policy():
    svc = service(max_queue=2, overflow="shed", max_batch=64)
    apps = ["blackscholes", "canneal", "jacobi-2d", "pathfinder"]
    results = [svc.submit(a, CFG_A) for a in apps]
    assert results[0] is None and results[1] is None
    assert results[2] is not None and results[2].source == "shed"
    assert math.isnan(results[2].steady_ns)
    assert svc.n_shed == 2
    svc.drain()
    assert len(svc.completed) == 2
    assert svc.result_for(results[2].uid).source == "shed"


def test_bounded_queue_serialize_policy_never_loses_requests():
    svc = service(max_queue=2, overflow="serialize", max_batch=64)
    for a in ["blackscholes", "canneal", "jacobi-2d", "pathfinder"]:
        svc.submit(a, CFG_A)
    svc.drain()
    assert svc.n_shed == 0 and svc.n_serialized >= 1
    assert len(svc.completed) == 4
    assert svc.pending_requests() == 0


# --------------------------------------------------------------- workloads

def test_poisson_arrivals_deterministic_and_sorted():
    cfgs = (CFG_A, CFG_B)
    a = poisson_arrivals(32, 100.0, ("blackscholes", "canneal"), cfgs, seed=3)
    b = poisson_arrivals(32, 100.0, ("blackscholes", "canneal"), cfgs, seed=3)
    assert a == b
    assert [x.t for x in a] == sorted(x.t for x in a)
    assert {x.app for x in a} <= {"blackscholes", "canneal"}
    assert a != poisson_arrivals(32, 100.0, ("blackscholes", "canneal"),
                                 cfgs, seed=4)


def test_workload_repeat_pass_is_all_hits_and_bitwise(tmp_path):
    path = str(tmp_path / "serve_cache.jsonl")
    arrivals = poisson_arrivals(24, 1000.0, ("blackscholes", "canneal"),
                                (CFG_A, CFG_B), seed=0)
    svc = service(cache=dse.ResultCache(path), max_batch=8)
    rep1 = run_workload(svc, arrivals, realtime=False)
    assert rep1.hits == 0 and rep1.dispatched >= 1
    assert rep1.n == 24 and len(rep1.results) == 24
    svc2 = service(cache=dse.ResultCache(path), max_batch=8)
    rep2 = run_workload(svc2, arrivals, realtime=False)
    assert rep2.hit_fraction == 1.0 and rep2.dispatched == 0
    r1 = sorted(rep1.results, key=lambda r: r.uid)
    r2 = sorted(rep2.results, key=lambda r: r.uid)
    assert [r.steady_ns for r in r1] == [r.steady_ns for r in r2]
    assert [r.app for r in r1] == [r.app for r in r2]


def test_prewarm_covers_every_service_batch_bucket():
    svc = service(max_batch=16)
    assert svc.prewarm() == 2                   # sizes 8 and 16
    jc0 = eng.jit_cache_size()
    arrivals = poisson_arrivals(
        20, 1000.0, ("blackscholes", "canneal"),
        (CFG_A, CFG_B, eng.VectorEngineConfig(mvl=32, lanes=8)), seed=1)
    run_workload(svc, arrivals, realtime=False)
    assert eng.jit_cache_size() == jc0
    assert svc.recompiles == 0


def test_report_serializes_to_json():
    svc = service()
    arrivals = poisson_arrivals(6, 1000.0, ("blackscholes",), (CFG_A,),
                                seed=0)
    rep = run_workload(svc, arrivals, realtime=False)
    d = rep.to_dict()
    json.dumps(d)
    assert d["n"] == 6 and d["hits"] + d["coalesced"] + d["dispatched"] == 6
    assert rep.p99_ms >= rep.p50_ms >= 0.0
    json.dumps(svc.stats())


def test_invalid_service_parameters_rejected():
    with pytest.raises(ValueError):
        service(overflow="drop-oldest")
    with pytest.raises(ValueError):
        service(max_batch=0)


# --------------------------------------------------- against the reference

@pytest.mark.parametrize("seed", [0, 1, 7])
def test_poisson_arrivals_equal_the_reference(seed):
    apps = ("blackscholes", "canneal", "ssd_scan", "pathfinder:asm")
    cfgs = tuple(vcfg.SPACE_QUICK.sample(32, seed=seed + 1))
    ref_cfgs = tuple(ref_vcfg.SPACE_QUICK.sample(32, seed=seed + 1))
    got = poisson_arrivals(200, 200.0, apps, cfgs, seed=seed)
    want = ref_svc.poisson_arrivals(200, 200.0, apps, ref_cfgs, seed=seed)
    assert [(a.t, a.app, a.cfg.label()) for a in got] == \
        [(a.t, a.app, a.cfg.label()) for a in want]


def test_service_answers_as_the_reference():
    """One seeded stream back to back through both services (max_batch 8,
    a bounded queue that serializes): per-uid tier and batch equal, the
    counters equal, the times within rel 1e-6."""
    apps = ("blackscholes", "canneal")
    cfgs = tuple(vcfg.SPACE_SMOKE.sample(8, seed=1))
    ref_cfgs = tuple(ref_vcfg.SPACE_SMOKE.sample(8, seed=1))
    got = run_workload(service(max_batch=8, max_queue=12),
                       poisson_arrivals(40, 400.0, apps, cfgs, seed=0))
    want = run_workload(ref_svc.SimService(max_batch=8, max_queue=12,
                                           **TILES),
                        ref_svc.poisson_arrivals(40, 400.0, apps, ref_cfgs,
                                                 seed=0))
    g = sorted(got.results, key=lambda r: r.uid)
    w = sorted(want.results, key=lambda r: r.uid)
    assert [(r.uid, r.app, r.label, r.source, r.batch_id) for r in g] == \
        [(r.uid, r.app, r.label, r.source, r.batch_id) for r in w]
    for k in ("hits", "coalesced", "dispatched", "batches", "shed"):
        assert getattr(got, k) == getattr(want, k), k
    assert got.recompiles == 0
    for a, b in zip(g, w):
        assert abs(a.steady_ns - b.steady_ns) <= 1e-6 * b.steady_ns
        assert abs(a.runtime_ns - b.runtime_ns) <= 1e-6 * b.runtime_ns
    assert set(got.to_dict()) == set(want.to_dict())


def test_build_count_stays_zero_on_the_cpu_path():
    """``engine.jit_cache_size`` counts CUDA libraries built or loaded;
    the plain path builds none."""
    from repro_torch import _build
    before = eng.jit_cache_size()
    svc = service(max_batch=4)
    svc.prewarm()
    svc.submit("canneal", CFG_B)
    svc.drain()
    assert eng.jit_cache_size() == before == _build.builds() == 0
    assert eng.batch_bucket(1) == 8 and eng.batch_bucket(16) == 16
    assert eng.batch_bucket(17) == 32
    assert ref_eng.batch_bucket(17) == eng.batch_bucket(17)


def test_service_without_a_card_raises():
    """No fallback: the default device is the card."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device works")
    with pytest.raises(RuntimeError, match="CUDA"):
        SimService()


def test_snapshots_every_n_completions():
    svc = service(snapshot_every=2)
    for app in ("blackscholes", "canneal", "blackscholes"):
        svc.submit(app, CFG_A)
    svc.drain()
    assert len(svc.snapshots) == 1
    snap = svc.snapshots[0]
    assert snap["kind"] == "serve.snapshot" and snap["requests"] == 3
    ref = ref_svc.SimService(snapshot_every=2, cache=ref_dse.ResultCache())
    assert set(ref.stats()) == set(svc.stats())


def test_module_doctests_pass():
    assert doctest.testmod(sim_service).failed == 0
