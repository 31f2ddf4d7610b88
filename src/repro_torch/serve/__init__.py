"""Serving layers: LLM continuous batching (``engine``) and
simulation-as-a-service over the vector-engine timing model
(``sim_service``).

Submodules are imported lazily, as the reference's are, so ``python -m
repro_torch.serve.sim_service`` does not import the module it is executing
twice, and importing one layer does not pay for the other.
"""
_EXPORTS = {
    "Request": "engine", "ServeEngine": "engine", "serve_batch": "engine",
    "Arrival": "sim_service", "ServeReport": "sim_service",
    "SimRequest": "sim_service", "SimResult": "sim_service",
    "SimService": "sim_service", "poisson_arrivals": "sim_service",
    "run_workload": "sim_service",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(
            f"module 'repro_torch.serve' has no attribute {name!r}")
    import importlib
    return getattr(importlib.import_module(f"repro_torch.serve.{mod}"), name)
