"""Shared driver of the model-parity tests: one smoke config through the
reference (``repro.models``) and the port (``repro_torch.models``) on the
reference's weights carried across (``interop.model_params_from_numpy``),
the same seeded inputs, the results as float64 numpy arrays.

Not a test module (no ``test_`` prefix): ``test_torch_models*.py`` import
it, so each file holds its own families and ``--dist loadfile`` spreads
them."""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as ref_config
from repro.models import build as ref_build
from repro_torch import interop
from repro_torch.configs import get_config as port_config
from repro_torch.models import build as port_build

# every comparison of the CPU parity tests: the largest absolute
# difference within this share of the reference's largest magnitude
# (float32 on both sides, products summed in other orders)
TOL = 1e-4
# the bfloat16 case: two units of bfloat16 (2^-7 relative) at the largest
# magnitude, a 16-bit rounding of each product and sum on either side
TOL_BF16 = 2e-2
DECODE_STEPS = 3


def f64(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.double().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32), np.float64)


def models(arch, **overrides):
    """(reference model, reference params, port model, port params) of the
    smoke config of ``arch`` with ``overrides``."""
    rcfg = ref_config(arch).smoke().scaled(**overrides)
    pcfg = port_config(arch).smoke().scaled(**overrides)
    rm, pm = ref_build(rcfg), port_build(pcfg)
    rp = rm.init(jax.random.key(0))
    pp = interop.model_params_from_numpy(
        pcfg, jax.tree.map(np.asarray, rp), device="cpu")
    return rm, rp, pm, pp


def inputs(cfg, B, S, seed):
    """Seeded tokens, labels and stub frames / patches: (reference batch,
    port batch)."""
    rng = np.random.default_rng(seed)
    host = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)),
            "labels": rng.integers(0, cfg.vocab_size, (B, S))}
    host = {k: v.astype(np.int32) for k, v in host.items()}
    if cfg.family == "encdec":
        host["frames"] = rng.standard_normal(
            (B, cfg.num_frames, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        host["patches"] = rng.standard_normal(
            (B, cfg.num_patches, cfg.d_model)).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in host.items()},
            {k: torch.from_numpy(v) for k, v in host.items()})


@functools.lru_cache(maxsize=None)
def run(arch, B=2, S=8, max_seq=32, **overrides):
    """Both packages' results on the same weights and inputs, as
    ``{name: (reference, port)}`` float64 arrays: the prefill's logits and
    cache, ``DECODE_STEPS`` decode steps fed the same seeded tokens (their
    logits, and the caches after them), the hidden states of ``forward``
    and ``loss_fn``."""
    rm, rp, pm, pp = models(arch, **dict(overrides))
    cfg = rm.cfg
    rb, pb = inputs(cfg, B, S, seed=1)
    out = {}
    serve_r = {k: v for k, v in rb.items() if k != "labels"}
    serve_p = {k: v for k, v in pb.items() if k != "labels"}
    rl, rc = rm.prefill(rp, serve_r, max_seq)
    pl, pc = pm.prefill(pp, serve_p, max_seq)
    out["prefill_logits"] = (f64(rl), f64(pl))
    for k in rc:
        out[f"prefill_cache_{k}"] = (f64(rc[k]), f64(pc[k]))
    pos = S + (cfg.num_patches if cfg.family == "vlm" else 0)
    rng = np.random.default_rng(2)
    for t in range(DECODE_STEPS):
        tok = rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
        rl, rc = rm.decode_step(rp, rc, jnp.asarray(tok), jnp.int32(pos + t))
        pl, pc = pm.decode_step(pp, pc, torch.from_numpy(tok), pos + t)
        out[f"decode{t}_logits"] = (f64(rl), f64(pl))
    for k in rc:
        out[f"decode_cache_{k}"] = (f64(rc[k]), f64(pc[k]))
    out["forward"] = (f64(_forward(rm, rp, rb)), f64(_forward(pm, pp, pb)))
    out["loss"] = (f64(rm.loss(rp, rb)), f64(pm.loss(pp, pb)))
    return out


def _forward(model, params, batch):
    """The family's ``forward`` (its hidden states; MoE families return
    the aux loss beside them)."""
    cfg = model.cfg
    if cfg.family == "encdec":
        h = model.mod.forward(params, batch["frames"], batch["tokens"], cfg)
    elif cfg.family == "vlm":
        h = model.mod.forward(params, batch["patches"], batch["tokens"], cfg)
    else:
        h = model.mod.forward(params, batch["tokens"], cfg)
    return h[0] if isinstance(h, tuple) else h


def assert_close(ref, got, tol=TOL, what=""):
    """``got`` within ``tol`` of the reference's largest magnitude."""
    assert ref.shape == got.shape, (what, ref.shape, got.shape)
    bar = tol * max(float(np.abs(ref).max()), 1e-30)
    err = float(np.abs(ref - got).max())
    assert err <= bar, f"{what}: max abs err {err:.3g} > bar {bar:.3g}"


def check(arch, kind, tol=TOL, **run_args):
    """Every result of ``run`` whose name starts with ``kind``."""
    res = run(arch, **run_args)
    names = [n for n in res if n.startswith(kind)]
    assert names, kind
    for n in names:
        assert_close(*res[n], tol=tol, what=f"{arch} {n}")
