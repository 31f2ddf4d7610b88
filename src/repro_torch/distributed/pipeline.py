"""GPipe-style pipeline parallelism over the ``pod`` axis (multi-pod mesh).

The port of ``repro/distributed/pipeline.py``.  The default multi-pod
configuration treats ``pod`` as extra data parallelism; this module is the
alternative: each pod owns a part of the layer stack and microbatches
stream through a ring.  The schedule runs ``M + stages - 1`` ticks; at
tick ``t`` stage 0 takes microbatch ``t``, every stage applies its layers
to what it holds, the last stage emits microbatch ``t - (stages - 1)``,
and each stage hands its result to the next (``collectives.ppermute``,
``batch_isend_irecv`` on the pod group).  Bubbles are
``(stages - 1) / ticks`` as usual.  At the end the outputs, which live on
the last stage, are summed over the ranks (an ``all_reduce``: the others
contribute zeros), as the reference's ``psum``.  The schedule is a
forward one (the hand-offs carry no gradient), as the reference's test
runs it.
"""
from __future__ import annotations

import torch

from repro_torch.distributed import collectives as C
from repro_torch.distributed import sharding as shd
from repro_torch.models.layers import tree_map


def pipeline_apply(fn_stage, params_stages, x_micro, mesh, *, stages: int):
    """Run ``x_micro`` ``[M, ...]`` microbatches through ``stages``
    pipeline stages.  ``fn_stage(stage_params, x) -> x``.
    ``params_stages`` has a leading ``[stages]`` dim sharded over "pod"
    (DTensors, or whole tensors every rank holds); each pod applies its
    stage and passes activations to the next pod between ticks.  Returns
    ``[M, ...]`` on every rank."""
    M = x_micro.shape[0]
    ticks = M + stages - 1
    group = mesh.group("pod")
    ax = mesh.coord("pod")
    ring = [(i, (i + 1) % stages) for i in range(stages)]
    mine = tree_map(
        lambda p: (shd.local(p) if shd.is_dtensor(p)
                   else shd.Sharding(mesh, ("pod",)).local(p))[0],
        params_stages)
    out = torch.zeros_like(x_micro)
    state = torch.zeros_like(x_micro[0])
    for t in range(ticks):
        # stage 0 ingests microbatch t (if in range); the others use what
        # arrived over the ring last tick
        inject = x_micro[min(t, M - 1)] if ax == 0 else state
        y = fn_stage(mine, inject)
        if ax == stages - 1 and t >= stages - 1:
            out[t - (stages - 1)] = y
        state = C.ppermute(y, group, ring)
    return C.psum(out, group)
