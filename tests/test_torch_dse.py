"""Port parity: design-space exploration (``repro_torch.core.dse``).

The cases of ``tests/test_dse.py``, one for one, run on the port with the
engine on the CPU (``device="cpu"``: the plain PyTorch scan), on small
spaces; then the cross-package contract: the cache keys equal the
reference's character for character, the port reads a cache file the
reference's ``explore`` wrote without simulating anything and reduces it to
the reference's frontier fingerprint, and its own cold explore gives the
reference's steady-state times within rel 1e-6 (the port's engine against
the reference's, ``tests/test_torch_engine.py``) and the same frontier
labels.  The reference's sharded dispatch has no counterpart: the port
runs a sweep's misses as one scan launch.
"""
import dataclasses
import json
import warnings
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import pytest

from repro.configs import vector_engine as ref_vcfg
from repro.core import dse as ref_dse
from repro.core import engine as ref_eng
from repro_torch import interop
from repro_torch.configs import vector_engine as vcfg
from repro_torch.core import dse
from repro_torch.core import engine as eng
from repro_torch.core import suite, tracegen

CPU = "cpu"
GOLDEN = json.loads((Path(__file__).parent / "golden_sweep.json").read_text())
# the reference's tracegen raises FrontendError ('jit' primitive) for these
# two on this JAX (ROADMAP Queue 3); their oracle is the golden table
JIT_APPS = ("decode_attention", "ssd_scan")

SP_TINY = dse.DesignSpace.of("tiny", mvl=(16, 64), lanes=(2, 8),
                             l2_kb=(256, 1024))


def explore(space, apps, **kw):
    return dse.explore(space, apps=apps, device=CPU, **kw)


@pytest.fixture(scope="module")
def tiny():
    """SP_TINY x (blackscholes, canneal) explored once into a fresh
    in-memory cache: ``(result, cache, lanes simulated)``."""
    cache = dse.ResultCache()
    res = explore(SP_TINY, ("blackscholes", "canneal"), cache=cache)
    return res, cache, res.stats["simulated"]


# ------------------------------------------------------------- DesignSpace

def test_design_space_size_and_enumeration_order():
    sp = dse.DesignSpace.of("t", mvl=(8, 64), lanes=(1, 4), mshrs=(1, 16))
    assert sp.size() == 8
    cfgs = sp.configs()
    assert len(cfgs) == 8
    assert (cfgs[0].mvl, cfgs[0].lanes, cfgs[0].mshrs) == (8, 1, 1)
    assert (cfgs[1].mvl, cfgs[1].lanes, cfgs[1].mshrs) == (8, 1, 16)
    assert (cfgs[-1].mvl, cfgs[-1].lanes, cfgs[-1].mshrs) == (64, 4, 16)
    for i, c in enumerate(cfgs):
        assert sp.config_at(i) == c


def test_design_space_validates_fields_and_choices():
    with pytest.raises(ValueError, match="unknown"):
        dse.DesignSpace.of("bad", not_a_knob=(1, 2))
    with pytest.raises(ValueError, match="no choices"):
        dse.DesignSpace.of("bad", mvl=())
    with pytest.raises(IndexError):
        dse.DesignSpace.of("t", mvl=(8, 64)).config_at(2)


def test_design_space_sampling_is_deterministic_and_distinct():
    sp = vcfg.SPACE_FULL
    a = sp.sample(50, seed=3)
    b = sp.sample(50, seed=3)
    c = sp.sample(50, seed=4)
    assert a == b
    assert a != c
    assert len({cfg.label() for cfg in a}) == 50
    tiny = dse.DesignSpace.of("t", mvl=(8, 64))
    assert tiny.sample(2) == tiny.configs()


def test_design_space_sample_seed_pin():
    sp = dse.DesignSpace.of("pin", mvl=(8, 64, 256), lanes=(1, 4),
                            mshrs=(1, 16))
    picked = [(c.mvl, c.lanes, c.mshrs) for c in sp.sample(4, seed=7)]
    assert picked == [(8, 4, 1), (64, 1, 16), (64, 4, 16), (256, 4, 1)]
    flat = [sp.configs().index(c) for c in sp.sample(4, seed=7)]
    assert flat == sorted(flat)


@pytest.mark.parametrize("name", ["SPACE_FULL", "SPACE_10K", "SPACE_HUGE"])
@pytest.mark.parametrize("seed", [0, 7])
def test_sample_equals_the_reference(name, seed):
    """Same space, same seed: the same configs, field for field."""
    mine = getattr(vcfg, name).sample(64, seed=seed)
    ref = getattr(ref_vcfg, name).sample(64, seed=seed)
    assert [dataclasses.asdict(c) for c in mine] == \
        [dataclasses.asdict(c) for c in ref]


def test_design_space_sample_rejects_oversampling():
    tiny = dse.DesignSpace.of("t", mvl=(8, 64))
    with pytest.raises(ValueError, match="sample\\(10\\).*only 2"):
        tiny.sample(10)


def test_space_presets_have_documented_sizes():
    assert vcfg.SPACE_SMOKE.size() == 64
    assert vcfg.SPACE_QUICK.size() == 384
    assert vcfg.SPACE_FULL.size() == 1536
    assert vcfg.SPACE_10K.size() == 18_432
    assert vcfg.SPACE_HUGE.size() == 1_244_160
    assert len(vcfg.SPACE_FULL.configs()) == 1536
    assert vcfg.SPACE_PRESET_APPS == ref_vcfg.SPACE_PRESET_APPS
    assert vcfg.ASM_SUITE == ref_vcfg.ASM_SUITE


@pytest.mark.parametrize("name", ["SPACE_SMOKE", "SPACE_QUICK", "SPACE_FULL",
                                  "SPACE_10K", "SPACE_HUGE"])
def test_spaces_equal_the_reference(name):
    """Same name, axes, order and choices as the reference's."""
    mine, ref = getattr(vcfg, name), getattr(ref_vcfg, name)
    assert (mine.name, mine.axes) == (ref.name, ref.axes)


def test_table10_variants_equal_the_reference():
    for name in ("TABLE10", "TABLE10_L2_1MB", "TABLE10_MSHR1"):
        assert [dataclasses.asdict(c) for c in getattr(vcfg, name)] == \
            [dataclasses.asdict(c) for c in getattr(ref_vcfg, name)]


def test_labels_unique_over_space_full():
    cfgs = vcfg.SPACE_FULL.configs()
    labels = [c.label() for c in cfgs]
    assert len(set(labels)) == len(cfgs)
    base = eng.VectorEngineConfig(mvl=64, lanes=4, dram_bw_bytes_cycle=8.0)
    assert "dram_bw" in base.label()
    a = eng.VectorEngineConfig(dram_bw_bytes_cycle=4.0000001)
    b = eng.VectorEngineConfig(dram_bw_bytes_cycle=4.0000002)
    assert a.label() != b.label()


def test_labels_unique_over_scalar_knob_extension():
    base = vcfg.SPACE_FULL.configs()[:64]
    extended = list(base)
    for cfg in base:
        extended += [dataclasses.replace(cfg, issue_width=1),
                     dataclasses.replace(cfg, branch_miss_penalty=12.0),
                     dataclasses.replace(cfg, fusion=True)]
    labels = [c.label() for c in extended]
    assert len(set(labels)) == len(extended)
    assert "_fusion" in eng.VectorEngineConfig(fusion=True).label()


def test_config_fingerprint_distinguishes_scalar_knobs():
    base = eng.VectorEngineConfig(mvl=64, lanes=4)
    fps = {eng.config_fingerprint(base)}
    for up in (dict(issue_width=1), dict(issue_width=4),
               dict(branch_miss_penalty=12.0), dict(fusion=True)):
        fps.add(eng.config_fingerprint(dataclasses.replace(base, **up)))
    assert len(fps) == 5


def test_cache_misses_on_new_scalar_knob():
    cache = dse.ResultCache()
    sp1 = dse.DesignSpace.of("t_iw", mvl=(16,), lanes=(2,))
    r1 = explore(sp1, ("pathfinder",), cache=cache)
    assert r1.stats["simulated"] == 1
    cfg_f = dataclasses.replace(sp1.configs()[0], fusion=True)
    r2 = explore([cfg_f], ("pathfinder",), cache=cache)
    assert r2.stats["simulated"] == 1
    _, k1 = dse.cell_key("pathfinder", sp1.configs()[0], 8, 24)
    _, k2 = dse.cell_key("pathfinder", cfg_f, 8, 24)
    assert k1 != k2
    assert r2.records[0].speedup != r1.records[0].speedup


# ----------------------------------------------------------- area/cost proxy

def test_area_proxy_monotone_in_capability():
    base = eng.VectorEngineConfig(mvl=64, lanes=4)
    for up in (dict(mvl=256), dict(lanes=8), dict(phys_regs=64),
               dict(l2_kb=1024), dict(mshrs=64), dict(l1_kb=64)):
        bigger = dataclasses.replace(base, **up)
        assert dse.area_proxy_kb(bigger) > dse.area_proxy_kb(base), up


def test_area_proxy_equals_the_reference():
    for mine, ref in zip(vcfg.SPACE_HUGE.sample(256, seed=1),
                         ref_vcfg.SPACE_HUGE.sample(256, seed=1)):
        assert dse.area_proxy_kb(mine) == ref_dse.area_proxy_kb(ref)


# ------------------------------------------------------------- ResultCache

def test_result_cache_roundtrip_and_stats(tmp_path):
    path = str(tmp_path / "cache.jsonl")
    c = dse.ResultCache(path)
    assert c.get("k1") is None and c.misses == 1
    c.put("k1", 1.25)
    c.flush()
    assert c.get("k1") == 1.25 and c.hits == 1
    c2 = dse.ResultCache(path)
    assert len(c2) == 1 and c2.get("k1") == 1.25
    c2.put("k2", 3.0000000000000004)
    c2.flush()
    assert dse.ResultCache(path).get("k2") == 3.0000000000000004


def test_result_cache_skips_corrupt_trailing_line(tmp_path):
    path = str(tmp_path / "cache.jsonl")
    c = dse.ResultCache(path)
    c.put("k1", 1.5)
    c.put("k2", 2.5)
    c.flush()
    with open(path, "a") as f:
        f.write('{"k": "k3", "v": 3.')      # truncated mid-flush
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        c2 = dse.ResultCache(path)
    assert any("malformed" in str(x.message) for x in w)
    assert c2.corrupt_lines == 1
    assert len(c2) == 2
    assert c2.get("k1") == 1.5 and c2.get("k2") == 2.5
    c2.put("k4", 4.5)
    c2.flush()
    assert dse.ResultCache(path).get("k4") == 4.5


def test_result_cache_tolerates_non_record_lines(tmp_path):
    path = str(tmp_path / "cache.jsonl")
    with open(path, "w") as f:
        f.write('{"not_k": 1}\n')
        f.write('[1, 2, 3]\n')
        f.write('{"k": "good", "v": 7.0}\n')
    with warnings.catch_warnings(record=True):
        warnings.simplefilter("always")
        c = dse.ResultCache(path)
    assert c.corrupt_lines == 2 and c.get("good") == 7.0


def test_result_cache_concurrent_flush_never_interleaves(tmp_path):
    path = str(tmp_path / "cache.jsonl")
    n_writers, n_each = 8, 50

    def writer(w):
        c = dse.ResultCache(path)
        for i in range(n_each):
            c.put(f"writer{w}_rec{i}_" + "x" * 64, float(w * 1000 + i))
            if i % 7 == 0:
                c.flush()
        c.flush()

    with ThreadPoolExecutor(n_writers) as ex:
        list(ex.map(writer, range(n_writers)))

    merged = dse.ResultCache(path)
    assert merged.corrupt_lines == 0
    assert len(merged) == n_writers * n_each
    for w in range(n_writers):
        for i in range(n_each):
            assert merged.get(f"writer{w}_rec{i}_" + "x" * 64) == float(
                w * 1000 + i)


def test_result_cache_records_iterates_without_stats():
    c = dse.ResultCache()
    c.put("a", 1.0)
    c.put("b", 2.0)
    h, m = c.hits, c.misses
    assert list(c.records()) == [("a", 1.0), ("b", 2.0)]
    assert (c.hits, c.misses) == (h, m)


def test_export_training_rows_joins_cache_to_cells_bitwise(tiny):
    res, cache, sims = tiny
    rows = cache.export_training_rows(("blackscholes", "canneal"), SP_TINY)
    assert len(rows) == len(res.records) == 16
    want = {(r.app, r.label): r for r in res.records}
    for row in rows:
        rec = want[(row["app"], row["label"])]
        assert row["steady_ns"] == rec.steady_ns
        assert row["runtime_ns"] == rec.runtime_ns
        assert row["speedup"] == rec.speedup
        assert row["area_kb"] == rec.area_kb
        assert row["cfg"] == rec.cfg
    h, m = cache.hits, cache.misses
    cache.export_training_rows(("blackscholes",), SP_TINY)
    assert (cache.hits, cache.misses) == (h, m)
    assert explore(SP_TINY, ("blackscholes", "canneal"),
                   cache=cache).stats["simulated"] == 0
    assert sims == 16


def test_export_training_rows_skips_unlabeled_cells(tiny):
    _, cache, _ = tiny
    # swaptions was never explored -> no rows for it, no invention
    assert cache.export_training_rows(("swaptions",), SP_TINY) == []
    rows = cache.export_training_rows(("blackscholes",),
                                      SP_TINY.configs()[:3])
    assert len(rows) == 3


def test_cell_key_matches_result_cache_key():
    cfg = eng.VectorEngineConfig(mvl=64, lanes=4)
    body, key = dse.cell_key("blackscholes", cfg, 8, 24)
    eff = suite.effective_mvl("blackscholes", cfg)
    ref_body = tracegen.body_for("blackscholes", eff, cfg)
    assert key == dse.ResultCache.key(ref_body, cfg, 8, 24)
    assert len(body) == len(ref_body)


def test_cache_key_separates_workloads_and_configs():
    cfg = eng.VectorEngineConfig(mvl=64, lanes=4)
    b1 = tracegen.body_for("blackscholes", 64, cfg)
    b2 = tracegen.body_for("canneal", 64, cfg)
    k = dse.ResultCache.key
    assert k(b1, cfg, 8, 24) != k(b2, cfg, 8, 24)
    assert k(b1, cfg, 8, 24) != k(b1, cfg, 4, 24)
    cfg2 = eng.VectorEngineConfig(mvl=64, lanes=8)
    assert k(b1, cfg, 8, 24) != k(b1, cfg2, 8, 24)


_REF_APPS = tuple(a for a in sorted(tracegen.APPS) if a not in JIT_APPS)


@pytest.mark.parametrize("app", _REF_APPS + ("blackscholes:asm",))
def test_cell_key_equals_the_reference(app):
    """Character for character, over a SPACE_FULL sample (mvl aliases
    included), so the two packages read each other's caches."""
    for mine, ref in zip(vcfg.SPACE_FULL.sample(24, seed=5),
                         ref_vcfg.SPACE_FULL.sample(24, seed=5)):
        assert dse.cell_key(app, mine, 8, 24)[1] == \
            ref_dse.cell_key(app, ref, 8, 24)[1]
    cfg = eng.VectorEngineConfig(mvl=64, lanes=4)
    body, key = dse.cell_key(app, cfg, 4, 12)
    ref_body = interop.trace_from_numpy(vars(ref_dse.cell_body(
        app, ref_eng.VectorEngineConfig(mvl=64, lanes=4))[0]))
    assert key == dse.ResultCache.key(ref_body, cfg, 4, 12)


# ----------------------------------------------------------------- explore

def test_explore_matches_suite_speedup(tiny):
    recs = tiny[0].by_app()["blackscholes"]
    assert len(recs) == 8
    want = suite.speedup_batch([("blackscholes", r.cfg) for r in recs[:2]],
                               device=CPU)
    assert [r.speedup for r in recs[:2]] == want


def test_explore_repeat_is_bitwise_and_fully_cached(tmp_path):
    path = str(tmp_path / "c.jsonl")
    r1 = explore(SP_TINY, ("blackscholes", "canneal"),
                 cache=dse.ResultCache(path))
    assert r1.stats["simulated"] == 16 and r1.stats["hit_rate"] == 0.0
    r2 = explore(SP_TINY, ("blackscholes", "canneal"),
                 cache=dse.ResultCache(path))
    assert r2.stats["simulated"] == 0 and r2.stats["hit_rate"] == 1.0
    assert [(a.label, a.steady_ns, a.runtime_ns, a.speedup, a.area_kb)
            for a in r1.records] == \
        [(a.label, a.steady_ns, a.runtime_ns, a.speedup, a.area_kb)
         for a in r2.records]
    assert dse._frontier_fingerprint(r1) == dse._frontier_fingerprint(r2)
    assert [p["phase"] for p in r1.stats["phases"]] == ["key", "dispatch",
                                                        "derive"]
    assert r1.stats["devices"] == 1


def test_explore_dedups_mvl_aliases_within_a_run():
    """streamcluster caps at max_vl=128: mvl=128 and mvl=256 induce the
    same clamped body and timing parameters: one lane, equal records."""
    sp = dse.DesignSpace.of("alias", mvl=(128, 256), lanes=(4,))
    res = explore(sp, ("streamcluster",))
    assert res.stats["in_run_dedup"] == 1
    assert res.stats["simulated"] == 1
    r128, r256 = res.records
    assert r128.steady_ns == r256.steady_ns
    assert r128.label != r256.label


# -------------------------------------------------- reductions: Pareto etc.

def _rec(app, label, runtime, area):
    return dse.DseRecord(app=app, label=label, cfg=None, steady_ns=runtime,
                         runtime_ns=runtime, speedup=1.0, area_kb=area)


def test_pareto_frontier_drops_dominated_points():
    recs = [_rec("a", "slow_small", 10.0, 1.0),
            _rec("a", "fast_big", 1.0, 10.0),
            _rec("a", "dominated", 10.0, 10.0),
            _rec("a", "mid", 5.0, 5.0),
            _rec("a", "mid_dup", 5.0, 5.0)]
    labels = [r.label for r in dse.pareto_frontier(recs)]
    assert labels == ["fast_big", "mid", "slow_small"]


def test_best_under_budget():
    recs = [_rec("a", "fast_big", 1.0, 10.0),
            _rec("a", "mid", 5.0, 5.0),
            _rec("a", "slow_small", 10.0, 1.0)]
    assert dse.best_under_budget(recs, 100.0).label == "fast_big"
    assert dse.best_under_budget(recs, 6.0).label == "mid"
    assert dse.best_under_budget(recs, 0.5) is None


def test_explored_frontier_is_nondominated_and_summary_serializes():
    res = explore(SP_TINY, ("canneal",))
    frontier = res.frontiers()["canneal"]
    assert frontier
    for i, r in enumerate(frontier):
        for s in frontier[i + 1:]:
            assert s.runtime_ns >= r.runtime_ns and s.area_kb < r.area_kb
        for other in res.records:
            assert not (other.runtime_ns < r.runtime_ns
                        and other.area_kb < r.area_kb
                        and other.app == r.app)
    js = json.dumps(dse.frontier_summary(res, budgets=(256.0,)))
    assert "canneal" in js


def test_suite_entry_points(tiny):
    cache = tiny[1]
    res = suite.dse_explore(SP_TINY, apps=("blackscholes",), cache=cache,
                            device=CPU)
    assert res.n_configs == 8 and res.stats["simulated"] == 0
    best = suite.dse_best_under_budget(SP_TINY, 1e9, apps=("blackscholes",),
                                       cache=cache, device=CPU)
    assert best["blackscholes"] is not None
    assert best["blackscholes"].runtime_ns == min(
        r.runtime_ns for r in res.records)


def test_explore_needs_a_device_or_the_cpu():
    """No silent fallback: the default device is CUDA, which this host
    lacks, and asking for it raises."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dse.explore(SP_TINY, apps=("blackscholes",))


# ------------------------------------------- the reference's cache, both ways

SMOKE_APPS = vcfg.SPACE_PRESET_APPS["smoke"]


@pytest.fixture(scope="module")
def ref_smoke(tmp_path_factory):
    """The reference's explore of SPACE_SMOKE x (blackscholes, canneal),
    written to a cache file."""
    path = str(tmp_path_factory.mktemp("ref") / "cache.jsonl")
    res = ref_dse.explore(ref_vcfg.SPACE_SMOKE, SMOKE_APPS,
                          cache=ref_dse.ResultCache(path))
    return path, res


def test_port_reads_the_reference_cache(ref_smoke):
    path, ref = ref_smoke
    res = explore(vcfg.SPACE_SMOKE, SMOKE_APPS, cache=dse.ResultCache(path))
    assert res.stats["simulated"] == 0 and res.stats["hit_rate"] == 1.0
    assert dse._frontier_fingerprint(res) == ref_dse._frontier_fingerprint(ref)
    assert [(r.app, r.label, r.steady_ns, r.runtime_ns, r.area_kb)
            for r in res.records] == \
        [(r.app, r.label, r.steady_ns, r.runtime_ns, r.area_kb)
         for r in ref.records]


def test_cold_explore_equals_the_reference(ref_smoke, tmp_path):
    """The port's own sweep: every cell's steady-state time within rel 1e-6
    of the reference's (XLA contracts some a + b*c of the jitted step into
    FMAs, the port rounds twice), the same frontier labels, and a cache
    file the reference reads back without simulating."""
    _, ref = ref_smoke
    path = str(tmp_path / "port.jsonl")
    res = explore(vcfg.SPACE_SMOKE, SMOKE_APPS, cache=dse.ResultCache(path))
    assert res.stats["simulated"] == len(res.records) == 128
    for mine, want in zip(res.records, ref.records):
        assert (mine.app, mine.label) == (want.app, want.label)
        assert abs(mine.steady_ns - want.steady_ns) <= 1e-6 * want.steady_ns
        assert abs(mine.speedup - want.speedup) <= 2e-6 * want.speedup
    for app in SMOKE_APPS:
        assert [r.label for r in res.frontiers()[app]] == \
            [r.label for r in ref.frontiers()[app]]
    back = ref_dse.explore(ref_vcfg.SPACE_SMOKE, SMOKE_APPS,
                           cache=ref_dse.ResultCache(path))
    assert back.stats["simulated"] == 0
    assert ref_dse._frontier_fingerprint(back) == \
        dse._frontier_fingerprint(res)


@pytest.mark.parametrize("app", JIT_APPS)
def test_jit_apps_table10_cells_equal_the_golden_table(app):
    """The reference cannot build these bodies on this JAX ('jit' primitive,
    ROADMAP Queue 3), so the oracle is tests/golden_sweep.json: the 24
    Table-10 cells of an explore over TABLE10 at rtol 1e-2."""
    res = explore(list(vcfg.TABLE10), (app,))
    for r in res.records:
        want = GOLDEN[app][f"{r.cfg.mvl}x{r.cfg.lanes}"]
        assert abs(r.speedup - want) <= 1e-2 * want, (
            f"{app} {r.label}: {r.speedup} vs golden {want} (the reference's "
            f"'jit' caveat: golden table as the oracle)")
    assert len(res.records) == 24
