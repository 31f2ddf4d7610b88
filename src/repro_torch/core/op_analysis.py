"""Per-device FLOPs / HBM bytes / collective bytes of a step, for the
roofline.

The counterpart of ``repro/core/hlo_analysis.py``.  PyTorch has no HLO, so
this counts the ATen operations the per-device program issues, under a
``TorchDispatchMode`` (``OpCounter``) around the step: the same rules as
the reference's analyzer, applied to the operations instead of HLO
instructions:

  * FLOPs: ``2*|out|*K`` for products (``mm``, ``addmm``, ``bmm``,
    ``baddbmm``; K the contracted extent; a convolution ``2*|out|*K`` with
    K its window times input channels a group), ``|out|`` for elementwise
    operations (the ``pointwise`` tag but ``clone``, a copy as XLA's
    ``copy``, which the reference counts as bytes only; a type conversion
    too, XLA's ``convert``), ``|in|`` for reductions (each reduce of a
    softmax and its elementwise steps counted the same way:
    ``SOFTMAX_COUNTS``).
  * HBM bytes: each operation's operand and result bytes.  Eager PyTorch
    fuses nothing, so every operation is a memory boundary (the reference
    counts at fusion boundaries); views read and write nothing.
  * Collective bytes: the reference's ring model (``_ici_bytes``,
    ``hlo_analysis.py:245``) on the collectives the port issues
    (``c10d`` all-reduce, all-gather, reduce-scatter, all-to-all,
    send / recv), each over its process group's size.

The counter must sit below DTensor: a DTensor operation is computed once
on global shapes to propagate its sharding and again on the local shards,
so an operation on DTensors is not counted (the mode declines it and
DTensor's own dispatch runs), and the sharded steps compute on local
tensors.  Outputs' bytes are also tracked while they live: ``peak_bytes``
is the most the counted operations' results held at once (an estimate of
the step's live activations; a result freed by the step is dropped when
its tensor is).

This is a structural count of the per-device program, not a wall-clock
measurement.  ``analyze(counter)`` returns the reference's keys:
``flops``, ``hbm_bytes``, ``ici_bytes``, ``by_op``,
``static_collective_count``.
"""
from __future__ import annotations

import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

aten = torch.ops.aten

# the reference's collective names by the operation that issues them:
# torch.distributed's c10d ops and the functional ones DTensor issues (a
# send / recv pair is one collective-permute, counted at the send)
COLLECTIVES = {
    "allreduce_": "all-reduce", "all_reduce": "all-reduce",
    "_allgather_base_": "all-gather", "all_gather_into_tensor": "all-gather",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor": "reduce-scatter",
    "alltoall_base_": "all-to-all", "all_to_all_single": "all-to-all",
    "send": "collective-permute", "recv_": None,
}

DOTS = {aten.mm.default, aten.addmm.default, aten.bmm.default,
        aten.baddbmm.default}

# softmax and its relatives as the reduces and elementwise steps XLA lowers
# them to, counted per input element: max, subtract, exp, sum, divide (log
# softmax: max, subtract, exp, sum, log-subtract); backwards: multiply, sum,
# subtract, multiply (log: exp, multiply, sum, subtract)
SOFTMAX_COUNTS = {
    aten._softmax.default: 5, aten._log_softmax.default: 5,
    aten._softmax_backward_data.default: 4,
    aten._log_softmax_backward_data.default: 4,
}

REDUCTIONS = {aten.sum.dim_IntList, aten.sum.default, aten.mean.dim,
              aten.mean.default, aten.amax.default, aten.amin.default,
              aten.max.dim, aten.min.dim, aten.max.default,
              aten.logsumexp.default, aten.argmax.default,
              aten.topk.default, aten.cumsum.default, aten.prod.dim_int,
              aten.var_mean.correction, aten.linalg_vector_norm.default}


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) else 0


def _numel(t) -> int:
    return t.numel() if isinstance(t, torch.Tensor) else 0


def _ici_bytes(op, payload, operand, gsize) -> float:
    """The reference's ring model of a collective's bytes a device."""
    frac = (gsize - 1) / max(gsize, 1)
    if op == "all-reduce":
        return 2.0 * payload * frac
    if op == "all-gather":
        return payload * frac
    if op == "reduce-scatter":
        return max(payload, operand) * frac
    if op in ("all-to-all", "ragged-all-to-all"):
        return payload * frac
    return float(payload)


def _group_size(args) -> int:
    """The size of the process group a collective's arguments name (a
    c10d op's boxed ProcessGroup, the first script object, or a functional
    collective's group name)."""
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group
    for a in tree_leaves(args):
        if isinstance(a, torch.ScriptObject):
            return dist.ProcessGroup.unbox(a).size()
        if isinstance(a, str):
            return _resolve_process_group(a).size()
    raise ValueError("a collective without a process group")


def _is_view(func) -> bool:
    return func.is_view or func in (aten.detach.default, aten.alias.default)


class OpCounter(TorchDispatchMode):
    """Counts the FLOPs, HBM bytes and collective bytes of the ATen
    operations on plain tensors dispatched while it is entered."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.hbm_bytes = 0.0
        self.ici_bytes = 0.0
        self.by_op: dict = {}
        self.collectives = 0
        self.live_bytes = 0
        self.peak_bytes = 0

    def _track(self, out) -> None:
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor) and t._base is None:
                n = _nbytes(t)
                self.live_bytes += n
                self.peak_bytes = max(self.peak_bytes, self.live_bytes)
                weakref.finalize(t, self._free, n)

    def _free(self, n: int) -> None:
        self.live_bytes -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        ins = [t for t in tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        name = func._schema.name.split("::")[-1]
        if func.namespace in ("c10d", "_c10d_functional") \
                and name in COLLECTIVES:
            self._collective(name, args, ins, outs)
            return out
        self._flops(func, args, ins, outs)
        if not _is_view(func) and func not in (
                aten.empty.memory_format, aten.empty_strided.default,
                aten.empty_like.default):
            self.hbm_bytes += sum(map(_nbytes, ins)) + sum(map(_nbytes,
                                                              outs))
            if not func._schema.is_mutable:
                self._track(out)
        return out

    def _collective(self, name, args, ins, outs) -> None:
        op = COLLECTIVES[name]
        if op is None:
            return
        if name in ("allreduce_", "all_reduce", "send"):
            payload = operand = sum(map(_nbytes, ins))
        elif name.endswith("_"):       # c10d's (output, input, group, ...)
            payload, operand = _nbytes(ins[0]), _nbytes(ins[1])
        else:                          # functional: input in, result out
            payload, operand = sum(map(_nbytes, outs)), sum(map(_nbytes,
                                                                ins))
        b = _ici_bytes(op, payload, operand, _group_size(args))
        self.ici_bytes += b
        self.by_op[op] = self.by_op.get(op, 0.0) + b
        self.collectives += 1
        self.hbm_bytes += payload + operand

    def _flops(self, func, args, ins, outs) -> None:
        out_n = sum(map(_numel, outs))
        if func in DOTS:
            a = args[1] if func in (aten.addmm.default,
                                    aten.baddbmm.default) else args[0]
            self.flops += 2.0 * out_n * a.shape[-1]
        elif func is aten.convolution.default:
            w = args[1]
            self.flops += 2.0 * out_n * (w.numel() // w.shape[0])
        elif func in SOFTMAX_COUNTS:
            self.flops += SOFTMAX_COUNTS[func] * _numel(ins[0])
        elif func in REDUCTIONS:
            self.flops += max(_numel(ins[0]), out_n)
        elif (torch.Tag.pointwise in func.tags
              and func not in (aten.clone.default, aten.clone.out)) or (
                func is aten._to_copy.default and ins
                and outs and ins[0].dtype != outs[0].dtype):
            self.flops += out_n


def analyze(counter: OpCounter) -> dict:
    """The reference's ``hlo_analysis.analyze`` keys from a counter."""
    return {
        "flops": counter.flops,
        "hbm_bytes": counter.hbm_bytes,
        "ici_bytes": counter.ici_bytes,
        "by_op": dict(counter.by_op),
        "static_collective_count": counter.collectives,
    }
