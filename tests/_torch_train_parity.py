"""Shared harness of the train-step parity tests: one smoke config's loss,
gradients and one ``build_train_step`` step through the reference
(``repro.train``) and the port (``repro_torch.train``) from the same
weights (``interop.model_params_from_numpy``), optimizer state and batch.

Not a test module (no ``test_`` prefix): ``test_torch_trainstep*.py``
import it, so each file holds its own families and ``--dist loadfile``
spreads them.

Tolerances: the loss within 1e-6 of the reference's (relative); each
gradient and moment leaf within 1e-4 of its largest reference magnitude
(``_torch_model_parity.TOL``: products summed in other orders); each
parameter leaf after a step within 1e-6 of its largest magnitude plus two
learning rates (AdamW's first update is ~lr x sign(g), which may flip
where a gradient is ~0 on both sides).
"""
from __future__ import annotations

import functools

import jax
import numpy as np
import torch

import _torch_model_parity as parity
from repro.train import optimizer as ref_opt
from repro.train import trainstep as ref_ts
from repro_torch.configs.base import InputShape
from repro_torch.models import layers as L
from repro_torch.train import optimizer as opt
from repro_torch.train import trainstep as ts

FAMILIES = {"dense": "qwen2.5-3b", "moe": "granite-moe-3b-a800m",
            "ssm": "mamba2-130m", "hybrid": "jamba-v0.1-52b",
            "encdec": "whisper-small", "vlm": "internvl2-76b"}
B, S = 4, 16
LOSS_RTOL = 1e-6


@functools.lru_cache(maxsize=None)
def run(arch, microbatches=1, compress=False):
    """The reference's and the port's loss, gradients and one step from
    the same weights, state and batch."""
    rm, rp, pm, pp = parity.models(arch)
    rb, pb = parity.inputs(rm.cfg, B, S, seed=1)
    shape = InputShape("t", S, B, "train")
    rl, rg = jax.jit(jax.value_and_grad(rm.loss))(rp, rb)
    pl, pg = ts.value_and_grad(pm, pp, pb)
    if microbatches == 1 and not compress:
        # the reference's step on one batch is these gradients through
        # its optimizer (its jitted step would compile the model again)
        rp2, rs2, rmet = ref_opt.apply(ref_opt.OptConfig(), rp, rg,
                                       ref_opt.init(rp))
        rmet["loss"] = rl
    else:
        rstep = jax.jit(ref_ts.build_train_step(
            rm, shape, None, opt_cfg=ref_opt.OptConfig(),
            microbatches=microbatches, compress_grads=compress)[0])
        rp2, rs2, rmet = rstep(rp, ref_opt.init(rp), rb)
    step, in_sh, out_sh, donate = ts.build_train_step(
        pm, shape, None, opt_cfg=opt.OptConfig(), microbatches=microbatches,
        compress_grads=compress)
    assert (in_sh, out_sh, donate) == (None, None, (0, 1))
    pp2, ps2, pmet = step(L.tree_map(torch.clone, pp), opt.init(pp), pb)
    return dict(loss=(float(rl), float(pl)),
                grads=(jax.tree.leaves(rg), L.tree_leaves(pg)),
                params=(jax.tree.leaves(rp2), L.tree_leaves(pp2)),
                mu=(jax.tree.leaves(rs2.mu), L.tree_leaves(ps2.mu)),
                nu=(jax.tree.leaves(rs2.nu), L.tree_leaves(ps2.nu)),
                step=(int(rs2.step), int(ps2.step)),
                metrics=({k: float(v) for k, v in rmet.items()},
                         {k: float(v) for k, v in pmet.items()}))


def assert_leaves_close(ref, got, tol, what, extra=0.0):
    assert len(ref) == len(got), what
    for i, (r, g) in enumerate(zip(ref, got)):
        r, g = parity.f64(r), parity.f64(g)
        assert r.shape == g.shape, (what, i)
        bar = tol * max(float(np.abs(r).max()), 1e-30) + extra
        err = float(np.abs(r - g).max())
        assert err <= bar, f"{what} leaf {i}: max abs err {err:.3g} > {bar:.3g}"


def check_step(res, compressed=False):
    """The step's metrics, parameters and moments against the
    reference's (``compressed``: each moment within one int8 level)."""
    rmet, pmet = res["metrics"]
    assert res["step"] == (1, 1)
    assert set(pmet) == {"loss", "grad_norm", "lr"}
    assert abs(pmet["loss"] - rmet["loss"]) <= LOSS_RTOL * abs(rmet["loss"])
    assert abs(pmet["grad_norm"] - rmet["grad_norm"]) \
        <= 1e-5 * rmet["grad_norm"]
    assert pmet["lr"] == rmet["lr"]
    assert_leaves_close(*res["params"], 1e-6, "param",
                        extra=2 * rmet["lr"])
    if not compressed:
        assert_leaves_close(*res["mu"], parity.TOL, "mu")
        assert_leaves_close(*res["nu"], parity.TOL, "nu")
        return
    # int8 compression: a gradient one ulp off a half quantum rounds to
    # the next level, so an element may differ by one quantum of its leaf
    # (amax / 127), scaled by the moments' (1 - b1) and (1 - b2) g terms
    for i, g in enumerate(res["grads"][0]):
        amax = float(np.abs(parity.f64(g)).max())
        quantum = amax / 127
        for what, one in (("mu", 0.1 * quantum),
                          ("nu", 0.05 * quantum * (2 * amax + quantum))):
            ref, got = (parity.f64(t[i]) for t in res[what])
            bar = parity.TOL * float(np.abs(ref).max()) + one
            assert float(np.abs(ref - got).max()) <= bar, (what, i)


def check_family(arch):
    """The loss and every gradient, then the step, of ``arch``."""
    res = run(arch)
    ref_loss, loss = res["loss"]
    assert abs(loss - ref_loss) <= LOSS_RTOL * abs(ref_loss)
    assert_leaves_close(*res["grads"], parity.TOL, "grad")
    assert any(float(np.abs(parity.f64(g)).max()) > 0
               for g in res["grads"][1])
    check_step(res)
