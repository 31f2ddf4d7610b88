"""What crosses over from the JAX package: traces, configs, calibration,
the surrogate's weights, the model families' weights.

The simulator itself has no weights.  The state the two packages share is
the trace records a workload is lowered to and the engine configuration a
study sweeps; the calibration constants are copied, and
``engine.model_fingerprint()`` equal to the reference's proves the copy
bitwise.  The one model with weights is the surrogate cost model
(``core.surrogate``): its MLP parameters and standardization statistics
carry across by name (``surrogate_from_numpy``), and so do the model
families' parameter trees (``model_params_from_numpy``) and the trainer's
optimizer state (``opt_state_from_numpy``: the reference's ``OptState``
step and float32 moments, so both trainers start a step from one state).
These helpers take the reference's plain data (numpy arrays, a dict of
config fields) without importing it.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import isa
from repro_torch.core.engine import VectorEngineConfig

_DTYPES = {name: (np.float32 if name == "footprint_kb"
                  else bool if name == "dep_scalar" else np.int32)
           for name in isa.Trace.__dataclass_fields__}


def trace_from_numpy(fields: dict) -> isa.Trace:
    """A port ``Trace`` from the reference ``Trace``'s field arrays
    (``{name: array}``, e.g. ``vars(ref_trace)``); dtypes are checked, not
    converted, so the fingerprint carries over unchanged."""
    missing = set(_DTYPES) - set(fields)
    if missing:
        raise ValueError(f"trace fields missing: {sorted(missing)}")
    out = {}
    for name, dtype in _DTYPES.items():
        a = np.asarray(fields[name])
        if a.dtype != np.dtype(dtype):
            raise ValueError(f"trace field {name}: dtype {a.dtype}, "
                             f"want {np.dtype(dtype)}")
        out[name] = a
    lens = {len(a) for a in out.values()}
    if len(lens) != 1:
        raise ValueError(f"trace fields of unequal lengths {sorted(lens)}")
    return isa.Trace(**out)


def config_from_fields(d: dict) -> VectorEngineConfig:
    """A port config from ``dataclasses.asdict`` of a reference config
    (the same field names; ``__post_init__`` applies the same checks)."""
    return VectorEngineConfig(**d)


def surrogate_from_numpy(params: dict, feat_mean, feat_std, apps, meta,
                         device=None):
    """A port ``Surrogate`` from a reference ``Surrogate``'s fields:
    ``params`` as ``{k: np.asarray(v)}`` of its parameters (``w1``...``b3``),
    its ``feat_mean`` / ``feat_std``, ``apps`` and ``meta``.  Every array
    must be float32 of the reference's shapes (``N_FEATURES`` inputs, one
    hidden width, one output); the parameters go to ``device`` (default:
    the CUDA device) unchanged."""
    import torch
    from repro_torch import _device
    from repro_torch.core import surrogate
    dev = _device.resolve(device)
    names = set(surrogate.PARAM_NAMES)
    if set(params) != names:
        raise ValueError(f"surrogate params {sorted(params)}, want "
                         f"{sorted(names)}")
    F = surrogate.N_FEATURES
    w1 = np.asarray(params["w1"])
    if w1.ndim != 2 or w1.shape[0] != F:
        raise ValueError(f"surrogate w1 of shape {w1.shape}, want ({F}, H)")
    H = w1.shape[1]
    shapes = {"w1": (F, H), "b1": (H,), "w2": (H, H), "b2": (H,),
              "w3": (H, 1), "b3": (1,), "feat_mean": (F,), "feat_std": (F,)}
    arrays = dict(params, feat_mean=feat_mean, feat_std=feat_std)
    out = {}
    for name, shape in shapes.items():
        a = np.asarray(arrays[name])
        if a.dtype != np.float32 or a.shape != shape:
            raise ValueError(f"surrogate {name}: {a.dtype} {a.shape}, want "
                             f"float32 {shape}")
        out[name] = a
    return surrogate.Surrogate(
        feat_mean=out["feat_mean"].copy(), feat_std=out["feat_std"].copy(),
        params={k: torch.from_numpy(out[k].copy()).to(dev)
                for k in surrogate.PARAM_NAMES},
        apps=tuple(apps), meta=dict(meta))


def model_params_from_numpy(cfg, tree: dict, device=None) -> dict:
    """The port's parameter tree of ``cfg``'s model from the reference's
    (``init`` of ``repro.models.build(cfg)``, as nested dicts of numpy
    arrays: ``jax.tree.map(np.asarray, params)``).  Every name, shape and
    type is checked against the port's ``defs``: each leaf must have the
    shape of its ``PD`` and the config's ``dtype`` (bfloat16 and float8
    arrays keep their ml_dtypes type names); anything else raises
    ``ValueError``.  The arrays go to ``device`` (default: the CUDA device)
    bit for bit."""
    import torch
    from repro_torch import _device
    from repro_torch.configs.base import torch_dtype
    from repro_torch.models import build
    from repro_torch.models.layers import PD
    dev = _device.resolve(device)
    want = torch_dtype(cfg.dtype)

    def convert(defs, sub, path):
        if isinstance(defs, PD):
            a = np.asarray(sub)
            if a.dtype.name != cfg.dtype:
                raise ValueError(f"model param {path}: dtype {a.dtype.name}, "
                                 f"want {cfg.dtype}")
            if a.shape != tuple(defs.shape):
                raise ValueError(f"model param {path}: shape {a.shape}, "
                                 f"want {tuple(defs.shape)}")
            a = np.ascontiguousarray(a)
            if a.dtype.name in ("float32", "float16"):
                t = torch.from_numpy(a.copy())
            else:  # bfloat16 / float8: the bits through an unsigned view
                bits = {1: np.uint8, 2: np.uint16}[a.dtype.itemsize]
                t = torch.from_numpy(a.view(bits).copy()).view(want)
            return t.to(dev)
        if not isinstance(sub, dict) or set(sub) != set(defs):
            have = sorted(sub) if isinstance(sub, dict) else type(sub).__name__
            raise ValueError(f"model params at {path or '/'}: {have}, want "
                             f"{sorted(defs)}")
        return {k: convert(defs[k], sub[k], f"{path}/{k}")
                for k in sorted(defs)}

    return convert(build(cfg).defs(), tree, "")


def opt_state_from_numpy(step, mu: dict, nu: dict, device=None):
    """The port's ``train.optimizer.OptState`` from the reference's
    ``OptState`` fields: ``step`` (an int or an int32 scalar) and the
    moments as nested dicts of float32 numpy arrays
    (``jax.tree.map(np.asarray, state.mu)``).  Both trees must have the
    same names and shapes and be float32, else ``ValueError``; the arrays
    go to ``device`` (default: the CUDA device) bit for bit."""
    import torch
    from repro_torch import _device
    from repro_torch.train.optimizer import OptState
    dev = _device.resolve(device)

    def convert(m, v, path):
        if isinstance(m, dict) or isinstance(v, dict):
            if not (isinstance(m, dict) and isinstance(v, dict)
                    and set(m) == set(v)):
                raise ValueError(f"optimizer moments differ at {path or '/'}")
            out = [convert(m[k], v[k], f"{path}/{k}") for k in sorted(m)]
            return ({k: o[0] for k, o in zip(sorted(m), out)},
                    {k: o[1] for k, o in zip(sorted(m), out)})
        a, b = np.asarray(m), np.asarray(v)
        if a.dtype != np.float32 or b.dtype != np.float32 \
                or a.shape != b.shape:
            raise ValueError(f"optimizer moments at {path}: {a.dtype} "
                             f"{a.shape} and {b.dtype} {b.shape}, want "
                             "float32 of one shape")
        return (torch.from_numpy(a.copy()).to(dev),
                torch.from_numpy(b.copy()).to(dev))

    mu_t, nu_t = convert(mu, nu, "")
    return OptState(step=torch.tensor(int(step), dtype=torch.int32,
                                      device=dev), mu=mu_t, nu=nu_t)
