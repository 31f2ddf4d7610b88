"""Port parity: AdamW with warmup and a cosine schedule
(``repro_torch.train.optimizer``) against ``repro.train.optimizer``.

Seeded numpy parameters and gradients in the surrogate's shapes (a dict of
six float32 arrays) go through both packages; the reference runs eagerly
(op by op, no fused step).  The schedule, the norm and 20 steps of the
update, with clipping active and inactive and across the warmup / cosine
boundary, agree at rtol 1e-6: each element within 1e-6 of its own
magnitude or of the largest magnitude of its array (of its tree, for the
parameters and moments), whichever is larger.
The second clause covers values formed by cancellation (``1 + cos`` near
the end of the cosine; a moment ``b1 m + (1 - b1) g`` whose two terms
nearly cancel), where one ulp of the two libraries' ``cos`` or of the
clipping scale is many ulps of the small result.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train import optimizer as ref_opt
from repro_torch.train import optimizer as opt

SHAPES = {"w1": (53, 64), "b1": (64,), "w2": (64, 64), "b2": (64,),
          "w3": (64, 1), "b3": (1,)}


def close(got, want, err_msg="", scale=None):
    want = np.asarray(want)
    scale = float(np.abs(want).max()) if scale is None else scale
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-6,
                               atol=1e-6 * scale, err_msg=err_msg)


def tree_max(t):
    return max(float(np.abs(np.asarray(v)).max()) for v in t.values())


def tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {k: (rng.standard_normal(s) * scale).astype(np.float32)
            for k, s in SHAPES.items()}


def to_torch(t):
    return {k: torch.from_numpy(np.array(v)) for k, v in t.items()}


def to_jax(t):
    return {k: jnp.asarray(v) for k, v in t.items()}


@pytest.mark.parametrize("cfg", [
    opt.OptConfig(),
    opt.OptConfig(lr=3e-3, warmup_steps=201, total_steps=2000,
                  min_lr_frac=0.02),
    opt.OptConfig(warmup_steps=0, total_steps=1),
], ids=["default", "surrogate-2000", "no-warmup"])
def test_lr_at_matches_reference(cfg):
    steps = np.arange(3001, dtype=np.int32)
    ref_cfg = ref_opt.OptConfig(**cfg.__dict__)
    want = np.asarray(ref_opt.lr_at(ref_cfg, jnp.asarray(steps)))
    got = opt.lr_at(cfg, torch.from_numpy(steps)).numpy()
    assert got.dtype == np.float32
    close(got, want)


def test_init_is_zero_moments_and_step_zero():
    params = to_torch(tree(0))
    st = opt.init(params)
    assert st.step.dtype == torch.int32 and int(st.step) == 0
    for k, p in params.items():
        assert st.mu[k].shape == p.shape and st.mu[k].dtype == torch.float32
        assert not st.mu[k].any() and not st.nu[k].any()
    ref = ref_opt.init(to_jax(tree(0)))
    assert sorted(ref.mu) == sorted(st.mu)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_global_norm_matches_reference(seed):
    t = tree(seed, scale=10.0 ** seed)
    want = float(ref_opt.global_norm(to_jax(t)))
    got = opt.global_norm(to_torch(t))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), want, rtol=1e-6)


@pytest.mark.parametrize("clip", ["active", "inactive"])
def test_apply_twenty_steps_matches_reference(clip):
    """20 steps from seeded parameters with seeded gradients a step, the
    warmup ending at step 10 of 30: parameters and both moments at rtol
    1e-6 after every step, and the metrics."""
    kw = dict(lr=3e-3, weight_decay=1e-4, warmup_steps=10, total_steps=30,
              min_lr_frac=0.02,
              clip_norm=1.0 if clip == "active" else 1e9)
    cfg, ref_cfg = opt.OptConfig(**kw), ref_opt.OptConfig(**kw)
    p0 = tree(100, scale=0.2)
    params, ref_params = to_torch(p0), to_jax(p0)
    state, ref_state = opt.init(params), ref_opt.init(ref_params)
    clipped = 0
    for i in range(20):
        g = tree(200 + i, scale=0.5)
        params, state, m = opt.apply(cfg, params, to_torch(g), state)
        ref_params, ref_state, rm = ref_opt.apply(ref_cfg, ref_params,
                                                  to_jax(g), ref_state)
        clipped += float(rm["grad_norm"]) > cfg.clip_norm
        assert int(state.step) == int(ref_state.step) == i + 1
        np.testing.assert_allclose(float(m["lr"]), float(rm["lr"]),
                                   rtol=1e-6)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(rm["grad_norm"]), rtol=1e-6)
        for got, want in ((params, ref_params), (state.mu, ref_state.mu),
                          (state.nu, ref_state.nu)):
            scale = tree_max(want)
            for k in SHAPES:
                assert got[k].dtype == torch.float32
                close(got[k].numpy(), want[k], err_msg=f"{k} step {i}",
                      scale=scale)
    assert clipped == (20 if clip == "active" else 0)


def test_apply_keeps_everything_on_tensors():
    """No host value in a step: the step, the rate and the metrics are
    tensors, so a loop on the card never waits for it."""
    params = to_torch(tree(3))
    new, st, m = opt.apply(opt.OptConfig(), params, to_torch(tree(4)),
                           opt.init(params))
    assert isinstance(st.step, torch.Tensor)
    assert all(isinstance(v, torch.Tensor) for v in m.values())
    assert set(new) == set(params)
