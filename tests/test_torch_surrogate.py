"""Port parity: the surrogate cost model (``repro_torch.core.surrogate``)
against ``repro.core.surrogate``.

The training rows come from one cache file: the reference's ``explore`` of
``SPACE_SMOKE`` x the smoke apps writes it, and both packages'
``export_training_rows`` read it (the keys are equal), so both fit and
predict on the same rows.  Held to the reference:

* the features bitwise, for every app the reference lowers at all six
  MVLs.  decode_attention and ssd_scan are left out: the reference cannot
  lower their kernel specs on this JAX (the ``'jit'`` primitive, ROADMAP
  Queue 3), which ``test_reference_cannot_lower_the_jit_apps`` pins;
* the loss and its gradients at the reference's initial parameters within
  rtol 1e-5, and 50 training steps' losses within rtol 1e-4 of the same
  loop run with the reference's ``_forward`` and optimizer under
  ``lax.scan``;
* a reference model carried across (``interop.surrogate_from_numpy``):
  predictions within rtol 1e-5, on rows and through ``SpaceScorer``
  (area within rtol 1e-6).

Then the reference's own bars (``tests/test_surrogate.py``) on the port's
own fit, on the CPU.  Gradients near zero are compared against their
tensor's scale: each element within 1e-5 of its own magnitude or of its
array's largest, whichever is larger.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import vector_engine as ref_vcfg
from repro.core import dse as ref_dse
from repro.core import engine as ref_eng
from repro.core import surrogate as ref_surro
from repro.core import tracegen as ref_tg
from repro.train import optimizer as ref_opt
from repro_torch import interop
from repro_torch.configs import vector_engine as vcfg
from repro_torch.core import characterize, dse, surrogate, tracegen
from repro_torch.core import engine as eng
from repro_torch.train import optimizer as opt

CPU = "cpu"
APPS = ("blackscholes", "canneal")
JIT_APPS = ("decode_attention", "ssd_scan")
LOWERED = tuple(a for a in sorted(tracegen.APPS) if a not in JIT_APPS) \
    + tuple(a for a in tracegen.ASM_APPS
            if a.split(":")[0] not in JIT_APPS)
MVLS = (8, 16, 32, 64, 128, 256)


@pytest.fixture(scope="module")
def labeled(tmp_path_factory):
    """``(reference rows, port rows)`` of one cache file the reference's
    explore wrote: 128 rows, the same cells in the same order."""
    path = str(tmp_path_factory.mktemp("surrogate") / "cache.jsonl")
    ref_dse.explore(ref_vcfg.SPACE_SMOKE, APPS,
                    cache=ref_dse.ResultCache(path))
    ref_rows = ref_dse.ResultCache(path).export_training_rows(
        APPS, ref_vcfg.SPACE_SMOKE)
    rows = dse.ResultCache(path).export_training_rows(APPS, vcfg.SPACE_SMOKE)
    assert len(rows) == len(ref_rows) == 128
    assert [(r["app"], r["label"], r["key"], r["runtime_ns"]) for r in rows] \
        == [(r["app"], r["label"], r["key"], r["runtime_ns"])
            for r in ref_rows]
    return ref_rows, rows


@pytest.fixture(scope="module")
def model(labeled):
    return surrogate.fit(labeled[1], steps=400, seed=0, device=CPU)


@pytest.fixture(scope="module")
def carried(labeled):
    """A reference model fitted at 150 steps and the port's copy of it."""
    ref = ref_surro.fit(labeled[0], steps=150, seed=0)
    port = interop.surrogate_from_numpy(
        {k: np.asarray(v) for k, v in ref.params.items()}, ref.feat_mean,
        ref.feat_std, ref.apps, ref.meta, device=CPU)
    return ref, port


def standardized(rows):
    """``fit``'s inputs, computed as both packages compute them."""
    X = np.stack([surrogate.row_features(r["app"], r["cfg"]) for r in rows])
    y = np.log(np.asarray([r["runtime_ns"] for r in rows], np.float32))
    Xl = np.log1p(X)
    mean, std = Xl.mean(axis=0), Xl.std(axis=0)
    std = np.where(std < 1e-6, 1.0, std)
    return np.ascontiguousarray((Xl - mean) / std), y


def close_scaled(got, want, rtol, err_msg=""):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()),
                               err_msg=err_msg)


# ----------------------------------------------------------------- features

def test_feature_names_equal_the_reference():
    assert surrogate.CONFIG_FEATURES == ref_surro.CONFIG_FEATURES
    assert surrogate.TRACE_FEATURES == ref_surro.TRACE_FEATURES
    assert surrogate.N_FEATURES == ref_surro.N_FEATURES == 53
    assert np.array_equal(surrogate.CONFIG_FEATURE_DEFAULTS,
                          ref_surro.CONFIG_FEATURE_DEFAULTS)


@pytest.mark.parametrize("i", range(8))
def test_config_features_bitwise(i):
    cfg = vcfg.SPACE_HUGE.config_at(i * 155_519)
    ref_cfg = ref_eng.VectorEngineConfig(**dataclasses.asdict(cfg))
    got = surrogate.config_features(cfg)
    assert got.dtype == np.float32
    assert np.array_equal(got, ref_surro.config_features(ref_cfg))


@pytest.mark.parametrize("app", LOWERED)
def test_trace_features_bitwise(app):
    for mvl in MVLS:
        got = surrogate.trace_features(app, mvl)
        want = ref_surro.trace_features(app, mvl)
        assert got.dtype == want.dtype == np.float32
        assert np.array_equal(got, want), (app, mvl)


@pytest.mark.parametrize("app", JIT_APPS)
def test_reference_cannot_lower_the_jit_apps(app):
    """The two apps the feature test leaves out: the reference raises on
    their kernel specs (ROADMAP Queue 3); the port's features are finite.
    Drop the app from JIT_APPS when this starts failing."""
    with pytest.raises(Exception, match="jit"):
        ref_tg.body_for(app, 64, ref_eng.VectorEngineConfig(mvl=64))
    for mvl in MVLS:
        assert np.isfinite(surrogate.trace_features(app, mvl)).all()


def test_config_features_cover_every_live_knob():
    assert set(surrogate.CONFIG_FEATURES) == {
        f.name for f in dataclasses.fields(eng.VectorEngineConfig)}
    cfg = eng.VectorEngineConfig(mvl=64, lanes=4, ooo_issue=True,
                                 interconnect="crossbar")
    f = dict(zip(surrogate.CONFIG_FEATURES, surrogate.config_features(cfg)))
    assert f["mvl"] == 64.0 and f["lanes"] == 4.0
    assert f["ooo_issue"] == 1.0 and f["interconnect"] == 0.0


def test_trace_features_memoized_and_closed_forms():
    a = surrogate.trace_features("swaptions", 64)
    assert a is surrogate.trace_features("swaptions", 64)
    feats = dict(zip(surrogate.TRACE_FEATURES, a))
    c = characterize.characterize("swaptions", 64)
    assert feats["pct_vectorization"] == pytest.approx(c.pct_vectorization)
    assert feats["avg_vl_counts"] == pytest.approx(c.avg_vl)
    f2 = dict(zip(surrogate.TRACE_FEATURES,
                  surrogate.trace_features("canneal", 256)))
    assert f2["eff_mvl"] == 22.0


def test_row_features_concatenate_config_and_trace():
    cfg = eng.VectorEngineConfig(mvl=64, lanes=4)
    row = surrogate.row_features("blackscholes", cfg)
    n = len(surrogate.CONFIG_FEATURES)
    assert row.shape == (surrogate.N_FEATURES,)
    assert np.array_equal(row[:n], surrogate.config_features(cfg))
    assert np.array_equal(row[n:],
                          surrogate.trace_features("blackscholes", 64))


# ------------------------------------------------------ training, held to ref

def test_loss_and_gradients_match_jax(labeled):
    Xn, y = standardized(labeled[1])
    p0 = ref_surro._init_params(Xn.shape[1], 64, 0)

    def ref_loss(p):
        return jnp.mean((ref_surro._forward(p, jnp.asarray(Xn)) - y) ** 2)

    want_loss, want_g = jax.value_and_grad(ref_loss)(p0)
    params = {k: torch.from_numpy(np.array(v)) for k, v in p0.items()}
    g, loss = torch.func.grad_and_value(surrogate._loss)(
        params, torch.from_numpy(Xn), torch.from_numpy(y))
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    assert set(g) == set(want_g)
    for k in g:
        close_scaled(g[k].numpy(), want_g[k], 1e-5, err_msg=k)


def test_train_losses_match_the_reference_loop(labeled):
    """50 full-batch steps from the reference's initial parameters: the
    per-step losses within rtol 1e-4 of the reference's ``fit`` loop (its
    ``_forward`` and optimizer under one jitted ``lax.scan``)."""
    Xn, y = standardized(labeled[1])
    steps = 50
    kw = dict(lr=3e-3, b1=0.9, b2=0.95, weight_decay=1e-4, clip_norm=1.0,
              warmup_steps=min(100, steps // 10 + 1), total_steps=steps,
              min_lr_frac=0.02)
    p0 = ref_surro._init_params(Xn.shape[1], 64, 0)
    Xj, yj, ref_cfg = jnp.asarray(Xn), jnp.asarray(y), ref_opt.OptConfig(**kw)

    def step(carry, _):
        p, s = carry
        loss, g = jax.value_and_grad(
            lambda q: jnp.mean((ref_surro._forward(q, Xj) - yj) ** 2))(p)
        p, s, _ = ref_opt.apply(ref_cfg, p, g, s)
        return (p, s), loss

    _, want = jax.jit(lambda p: jax.lax.scan(
        step, (p, ref_opt.init(p)), None, length=steps))(p0)
    params = {k: torch.from_numpy(np.array(v)) for k, v in p0.items()}
    _, got = surrogate._train(params, torch.from_numpy(Xn),
                              torch.from_numpy(y), opt.OptConfig(**kw),
                              steps)
    assert got.shape == (steps,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4)
    assert float(got[-1]) < float(got[0])


# ------------------------------------------- a reference model carried across

def test_carried_model_predicts_as_the_reference(carried, labeled):
    ref, port = carried
    assert port.apps == ref.apps and port.meta == ref.meta
    assert port.meta["model_fp"] == eng.model_fingerprint()
    got = port.predict_runtime_ns(labeled[1])
    want = ref.predict_runtime_ns(labeled[0])
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_carried_model_scores_the_space_as_the_reference(carried):
    ref, port = carried
    idx = np.random.RandomState(7).randint(vcfg.SPACE_10K.size(), size=4096)
    got_p, got_a = surrogate.SpaceScorer(port, vcfg.SPACE_10K,
                                         "canneal").score(idx)
    want_p, want_a = ref_surro.SpaceScorer(ref, ref_vcfg.SPACE_10K,
                                           "canneal").score(idx)
    np.testing.assert_allclose(got_p, want_p, rtol=1e-5)
    np.testing.assert_allclose(got_a, want_a, rtol=1e-6)


def test_scores_do_not_depend_on_the_call_they_ride_in(carried):
    port = carried[1]
    idx = np.random.RandomState(8).randint(vcfg.SPACE_10K.size(), size=4096)
    scorer = surrogate.SpaceScorer(port, vcfg.SPACE_10K, "blackscholes")
    whole = scorer.score(idx)
    halves = [scorer.score(idx[:1500]), scorer.score(idx[1500:])]
    for k in range(2):
        assert np.array_equal(whole[k],
                              np.concatenate([h[k] for h in halves]))


def test_surrogate_from_numpy_checks_its_arrays(carried):
    ref = carried[0]
    params = {k: np.asarray(v) for k, v in ref.params.items()}
    args = (ref.feat_mean, ref.feat_std, ref.apps, ref.meta)
    with pytest.raises(ValueError, match="w2"):
        interop.surrogate_from_numpy(
            dict(params, w2=params["w2"].astype(np.float64)), *args,
            device=CPU)
    with pytest.raises(ValueError, match="w1"):
        interop.surrogate_from_numpy(dict(params, w1=params["w1"][:-1]),
                                     *args, device=CPU)
    with pytest.raises(ValueError, match="feat_std"):
        interop.surrogate_from_numpy(params, ref.feat_mean,
                                     ref.feat_std[:-1], ref.apps, ref.meta,
                                     device=CPU)
    with pytest.raises(ValueError, match="params"):
        interop.surrogate_from_numpy({"w1": params["w1"]}, *args, device=CPU)


# ------------------------------------- the reference's bars on the port's fit

def test_fit_is_deterministic_in_seed(labeled):
    rows = labeled[1]
    m1 = surrogate.fit(rows, steps=150, seed=0, device=CPU)
    m2 = surrogate.fit(rows, steps=150, seed=0, device=CPU)
    m3 = surrogate.fit(rows, steps=150, seed=1, device=CPU)
    for k in surrogate.PARAM_NAMES:
        assert torch.equal(m1.params[k], m2.params[k]), k
    assert m1.meta["final_loss"] == m2.meta["final_loss"]
    assert any(not torch.equal(m1.params[k], m3.params[k])
               for k in surrogate.PARAM_NAMES)


def test_fit_rejects_empty_rows():
    with pytest.raises(ValueError, match="at least one"):
        surrogate.fit([], device=CPU)


def test_fit_learns_the_training_set(model, labeled):
    rows = labeled[1]
    pred = model.predict_runtime_ns(rows)
    true = np.array([r["runtime_ns"] for r in rows])
    assert np.median(np.abs(pred - true) / true) < 0.05
    assert model.meta["n_rows"] == 128
    assert model.apps == ("blackscholes", "canneal")
    assert set(model.meta) == {"n_rows", "hidden", "steps", "lr", "seed",
                               "final_loss", "model_fp"}
    assert {k: v.dtype for k, v in model.params.items()} == {
        k: torch.float32 for k in surrogate.PARAM_NAMES}


def test_dead_features_stay_bounded_out_of_distribution(model):
    assert np.all(model.feat_std >= 1e-6)
    cfgs = [eng.VectorEngineConfig(mvl=8, lanes=16, phys_regs=96,
                                   l1_kb=16, interconnect="crossbar",
                                   rob_entries=32, vrf_read_ports=2),
            eng.VectorEngineConfig(mvl=256, lanes=1, l2_kb=2048)]
    pred = model.predict_runtime_ns(
        [{"app": "blackscholes", "cfg": c} for c in cfgs])
    assert np.isfinite(pred).all() and (pred > 0).all()


def test_space_scorer_matches_row_path_and_exact_area(model):
    scorer = surrogate.SpaceScorer(model, vcfg.SPACE_10K, "blackscholes")
    idx = np.array([0, 1, 255, 4096, 18431])
    pred, area = scorer.score(idx)
    cfgs = [vcfg.SPACE_10K.config_at(int(i)) for i in idx]
    want = model.predict_runtime_ns(
        [{"app": "blackscholes", "cfg": c} for c in cfgs])
    np.testing.assert_allclose(pred, want, rtol=1e-6)
    np.testing.assert_allclose(
        area, [dse.area_proxy_kb(c) for c in cfgs], rtol=1e-6)


def test_space_scorer_handles_spaces_without_mvl_axis(model):
    sp = dse.DesignSpace.of("nomvl", lanes=(2, 8), l2_kb=(256, 1024))
    pred, area = surrogate.SpaceScorer(model, sp, "canneal").score(
        np.arange(sp.size()))
    assert pred.shape == (4,) and np.isfinite(pred).all()
    np.testing.assert_allclose(
        area, [dse.area_proxy_kb(c) for c in sp.configs()], rtol=1e-6)


def test_space_scorer_is_deterministic_across_batches(model):
    scorer = surrogate.SpaceScorer(model, vcfg.SPACE_10K, "canneal")
    full, _ = scorer.score(np.arange(2048))
    part, _ = scorer.score(np.arange(100, 200))
    assert np.array_equal(part, full[100:200])


# ---------------------------------------------------------------- scorecard

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ranks_and_spearman_equal_the_reference(seed):
    rng = np.random.RandomState(seed)
    a = rng.randint(0, 12, size=40).astype(np.float64)   # many ties
    b = a + rng.randint(0, 3, size=40)
    assert np.array_equal(surrogate._ranks(a), ref_surro._ranks(a))
    assert surrogate.spearman(a, b) == ref_surro.spearman(a, b)
    assert surrogate._ranks([10.0, 20.0, 20.0, 30.0]).tolist() == \
        [0.0, 1.5, 1.5, 3.0]
    assert surrogate.spearman([1.0, 1.0], [2.0, 2.0]) == 0.0


def test_scorecard_shape_and_holdout(model, labeled):
    rows = labeled[1]
    card = surrogate.scorecard(model, rows, holdout_app="canneal")
    ref_keys = {"n_rows", "rel_err_p50", "rel_err_p90", "rel_err_p99",
                "rel_err_max", "spearman_all", "per_app", "holdout"}
    assert set(card) == ref_keys and card["n_rows"] == 128
    assert 0.0 <= card["rel_err_p50"] <= card["rel_err_p90"] \
        <= card["rel_err_p99"] <= card["rel_err_max"]
    assert set(card["per_app"]) == {"blackscholes", "canneal"}
    assert card["holdout"]["app"] == "canneal"
    assert card["holdout"]["trained_on"] is True
    assert set(card["per_app"]["canneal"]) == {
        "n", "mean_rel_err", "worst_rel_err", "spearman", "trained_on"}


def test_scorecard_flags_truly_heldout_app(labeled):
    rows = labeled[1]
    m = surrogate.fit([r for r in rows if r["app"] == "blackscholes"],
                      steps=150, seed=0, device=CPU)
    card = surrogate.scorecard(m, rows, holdout_app="canneal")
    assert m.apps == ("blackscholes",)
    assert card["per_app"]["canneal"]["trained_on"] is False
    assert card["per_app"]["blackscholes"]["trained_on"] is True
    assert np.isfinite(card["holdout"]["mean_rel_err"])


def test_module_doctests_pass():
    import doctest
    assert doctest.testmod(surrogate).failed == 0
