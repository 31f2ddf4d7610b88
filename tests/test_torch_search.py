"""Port parity: surrogate-guided search (``repro_torch.core.search``)
against ``repro.core.search``.

The host helpers (survivor selection, the index algebra, mutation from the
same ``RandomState``, recall) are the reference's bit for bit on seeded
inputs.  With a reference model carried across and a fresh port cache, a
search of ``SPACE_SMOKE`` x the smoke apps on the CPU nominates, refines
and reports what the reference's does: the same frontier labels, runtimes
within rel 1e-6 (the engine's standing bar against the reference, ROADMAP
Queue 3), the same re-simulated, refined and simulated counts.  Survivor
sets are compared only on this 64-point space: on ``SPACE_10K`` and larger
the two packages' predictions (~1e-7 apart) can reorder near-ties.  Then
the reference's own contract on the port's own model: bitwise repeats in
both scoring modes, recall 1.0 where refinement can reach it, records only
from ``dse.explore``, every frontier point exact-verified.
"""
import doctest
from types import SimpleNamespace as R

import numpy as np
import pytest

from repro.configs import vector_engine as ref_vcfg
from repro.core import dse as ref_dse
from repro.core import search as ref_search
from repro.core import surrogate as ref_surro
from repro_torch import interop
from repro_torch.configs import vector_engine as vcfg
from repro_torch.core import dse, search, surrogate

CPU = "cpu"
APPS = ("blackscholes", "canneal")


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """The reference's explore of SPACE_SMOKE written to a file, both
    packages' rows from it, the reference's model and its port copy, and
    the port's own model: one fit each."""
    path = str(tmp_path_factory.mktemp("search") / "cache.jsonl")
    truth_ref = ref_dse.explore(ref_vcfg.SPACE_SMOKE, APPS,
                                cache=ref_dse.ResultCache(path))
    ref_rows = ref_dse.ResultCache(path).export_training_rows(
        APPS, ref_vcfg.SPACE_SMOKE)
    ref_model = ref_surro.fit(ref_rows, steps=400, seed=0)
    carried = interop.surrogate_from_numpy(
        {k: np.asarray(v) for k, v in ref_model.params.items()},
        ref_model.feat_mean, ref_model.feat_std, ref_model.apps,
        ref_model.meta, device=CPU)
    cache = dse.ResultCache(path)
    truth = dse.explore(vcfg.SPACE_SMOKE, APPS, cache=cache, device=CPU)
    assert truth.stats["simulated"] == 0
    rows = cache.export_training_rows(APPS, vcfg.SPACE_SMOKE)
    own = surrogate.fit(rows, steps=400, seed=0, device=CPU)
    return R(path=path, truth=truth, truth_ref=truth_ref,
             ref_model=ref_model, carried=carried, cache=cache, own=own)


# ------------------------------------------------------- host helpers, bitwise

@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("cap", [4, 30, 10_000])
def test_survivors_equal_the_reference(seed, cap):
    rng = np.random.RandomState(seed)
    n = 3000
    idx = rng.permutation(n * 3)[:n]
    area = rng.randint(1, 60, size=n).astype(np.float64)     # area ties
    pred = 1e3 / area * rng.uniform(0.9, 1.6, size=n)
    pred[rng.randint(n, size=50)] = pred[0]                   # pred ties
    for eps in (0.0, 0.15, 0.5):
        got = search._survivors(idx, pred, area, eps, cap)
        want = ref_search._survivors(idx, pred, area, eps, cap)
        assert np.array_equal(got, want), (eps, cap)


def test_survivors_doc_cases():
    idx = np.array([7, 3, 9, 5])
    pred = np.array([10.0, 11.0, 30.0, 5.0])
    area = np.array([1.0, 1.0, 2.0, 3.0])
    assert search._survivors(idx, pred, area, eps=0.15, cap=10).tolist() \
        == [3, 5, 7]
    n = 1000
    got = search._survivors(np.arange(n), np.full(n, 100.0),
                            np.linspace(1.0, 10.0, n), eps=0.1, cap=30,
                            depth=3)
    assert len(got) == 30


@pytest.mark.parametrize("space", ["SPACE_10K", "SPACE_HUGE", "SPACE_FULL"])
def test_decode_encode_equal_the_reference(space):
    sp = getattr(vcfg, space)
    radices = [len(c) for _, c in sp.axes]
    idx = np.random.RandomState(5).randint(sp.size(), size=2000)
    d = search._decode(idx, radices)
    assert np.array_equal(d, ref_search._decode(idx, radices))
    assert np.array_equal(search._encode(d, radices), idx)
    assert np.array_equal(ref_search._encode(d, radices), idx)
    names = [n for n, _ in sp.axes]
    choices = [c for _, c in sp.axes]
    for k in range(0, 2000, 97):
        cfg = sp.config_at(int(idx[k]))
        for a, name in enumerate(names):
            assert getattr(cfg, name) == choices[a][d[k, a]]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mutate_equals_the_reference_from_the_same_stream(seed):
    radices = [len(c) for _, c in vcfg.SPACE_HUGE.axes]
    elite = np.random.RandomState(seed + 10).randint(
        vcfg.SPACE_HUGE.size(), size=37).astype(np.int64)
    a, b = np.random.RandomState(seed), np.random.RandomState(seed)
    for n in (0, 1, 500):
        assert np.array_equal(search._mutate(a, elite, radices, n),
                              ref_search._mutate(b, elite, radices, n))
    assert len(search._mutate(a, np.empty(0, np.int64), radices, 5)) == 0


def test_neighbors_equal_the_reference_and_are_hamming_one():
    radices = [3, 2, 2]
    for idx in (np.array([0]), np.array([0, 5, 11]), np.empty(0, np.int64)):
        assert np.array_equal(search._neighbors(idx, radices),
                              ref_search._neighbors(idx, radices))
    nbrs = search._neighbors(np.array([0]), radices)
    digits0 = search._decode(np.array([0]), radices)[0]
    assert len(nbrs) == (3 - 1) + (2 - 1) + (2 - 1)
    for n in nbrs:
        assert int((search._decode(np.array([n]), radices)[0]
                    != digits0).sum()) == 1
    big = [len(c) for _, c in vcfg.SPACE_10K.axes]
    idx = np.random.RandomState(3).randint(vcfg.SPACE_10K.size(), size=20)
    assert np.array_equal(search._neighbors(idx, big),
                          ref_search._neighbors(idx, big))


def test_frontier_recall_equals_the_reference():
    truth = [R(runtime_ns=10.0, area_kb=5.0), R(runtime_ns=20.0, area_kb=1.0)]
    cases = [[], truth, [R(runtime_ns=5.0, area_kb=0.5)],
             [R(runtime_ns=10.0, area_kb=5.0)],
             [R(runtime_ns=9.0, area_kb=1.0)]]
    for found in cases:
        for t in (truth, []):
            assert search.frontier_recall(found, t) == \
                ref_search.frontier_recall(found, t)
    assert search.frontier_recall([], truth) == 0.0
    assert search.frontier_recall(truth, []) == 1.0


def test_module_doctests_pass():
    assert doctest.testmod(search).failed == 0


# ------------------------------------- the carried model against the reference

@pytest.mark.parametrize("refine_rounds", [0, 2])
def test_search_matches_the_reference_with_its_model(trained, refine_rounds):
    """The reference's model on both sides, each package's own fresh cache
    (the port's on the CPU scan): the same survivors, refinements and
    frontiers."""
    kw = dict(seed=0, max_resim_per_app=16, refine_rounds=refine_rounds)
    want = ref_search.search(ref_vcfg.SPACE_SMOKE, APPS, trained.ref_model,
                             cache=ref_dse.ResultCache(), **kw)
    got = search.search(vcfg.SPACE_SMOKE, APPS, trained.carried,
                        cache=dse.ResultCache(), device=CPU, **kw)
    assert got.stats["mode"] == want.stats["mode"] == "exhaustive-score"
    assert got.stats["n_scored"] == want.stats["n_scored"]
    assert got.stats["resim"] == want.stats["resim"]
    for app in APPS:
        assert [r.label for r in got.records[app]] == \
            [r.label for r in want.records[app]]
        assert [r.label for r in got.frontiers[app]] == \
            [r.label for r in want.frontiers[app]], app
        for g, w in zip(got.frontiers[app], want.frontiers[app]):
            assert abs(g.runtime_ns - w.runtime_ns) <= 1e-6 * w.runtime_ns
            assert g.area_kb == w.area_kb


def test_search_phase_rows_have_the_reference_shape(trained):
    res = search.search(vcfg.SPACE_SMOKE, APPS, trained.own,
                        cache=trained.cache, seed=0, max_resim_per_app=8,
                        refine_rounds=1, device=CPU)
    ref = ref_search.search(ref_vcfg.SPACE_SMOKE, APPS, trained.ref_model,
                            cache=ref_dse.ResultCache(trained.path), seed=0,
                            max_resim_per_app=8, refine_rounds=1)
    assert set(res.stats) == set(ref.stats)
    assert [(p["kind"], p["phase"], sorted(p)) for p in res.stats["phases"]] \
        == [(p["kind"], p["phase"], sorted(p)) for p in ref.stats["phases"]]


# -------------------------------------- the reference's contract, port's model

def test_search_frontier_is_exact_and_bitwise_repeatable(trained):
    kw = dict(cache=trained.cache, seed=0, max_resim_per_app=16,
              refine_rounds=1, device=CPU)
    res1 = search.search(vcfg.SPACE_SMOKE, APPS, trained.own, **kw)
    res2 = search.search(vcfg.SPACE_SMOKE, APPS, trained.own, **kw)
    assert search.frontier_fingerprint(res1) == \
        search.frontier_fingerprint(res2)
    assert search._verify_exact(res1, trained.cache) == sum(
        len(f) for f in res1.frontiers.values())


def test_search_recovers_exhaustive_frontier_when_it_can_refine(trained):
    res = search.search(vcfg.SPACE_SMOKE, APPS, trained.own,
                        cache=trained.cache, seed=0, max_resim_per_app=16,
                        refine_rounds=2, device=CPU)
    tf = trained.truth.frontiers()
    for app in APPS:
        assert search.frontier_recall(res.frontiers[app], tf[app]) == 1.0, app
        assert res.stats["resim"][app]["resim"] <= vcfg.SPACE_SMOKE.size()
    assert res.stats["mode"] == "exhaustive-score"


def test_search_evolutionary_path_is_deterministic(trained):
    kw = dict(cache=trained.cache, seed=3, max_resim_per_app=12,
              refine_rounds=1, exhaustive_limit=0, rounds=2, pop=512,
              device=CPU)
    r1 = search.search(vcfg.SPACE_SMOKE, APPS, trained.own, **kw)
    r2 = search.search(vcfg.SPACE_SMOKE, APPS, trained.own, **kw)
    assert r1.stats["mode"] == "evolutionary"
    assert search.frontier_fingerprint(r1) == search.frontier_fingerprint(r2)
    search._verify_exact(r1, trained.cache)


def test_search_records_only_contain_exact_dse_records(trained):
    res = search.search(vcfg.SPACE_SMOKE, APPS, trained.own,
                        cache=trained.cache, seed=0, max_resim_per_app=8,
                        refine_rounds=0, device=CPU)
    for app in APPS:
        for r in res.records[app]:
            assert isinstance(r, dse.DseRecord)
            assert r.area_kb == dse.area_proxy_kb(r.cfg)
        want = dse.pareto_frontier(res.records[app])
        assert [(w.label, w.runtime_ns) for w in want] == \
            [(f.label, f.runtime_ns) for f in res.frontiers[app]]


def test_verify_exact_rejects_a_point_not_in_the_cache(trained):
    res = search.search(vcfg.SPACE_SMOKE, APPS, trained.own,
                        cache=trained.cache, seed=0, max_resim_per_app=8,
                        refine_rounds=0, device=CPU)
    with pytest.raises(AssertionError, match="not in cache"):
        search._verify_exact(res, dse.ResultCache())


def test_search_refuses_a_model_on_another_device(trained):
    with pytest.raises(ValueError, match="model"):
        search.search(vcfg.SPACE_SMOKE, APPS, trained.own,
                      device="meta")
