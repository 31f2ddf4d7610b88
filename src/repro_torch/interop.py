"""What crosses over from the JAX package: traces, configs, calibration.

The simulator has no weights.  The state the two packages share is the
trace records a workload is lowered to and the engine configuration a
study sweeps; the calibration constants are copied, and
``engine.model_fingerprint()`` equal to the reference's proves the copy
bitwise.  These helpers take the reference's plain data (numpy arrays, a
dict of config fields) without importing it.
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
