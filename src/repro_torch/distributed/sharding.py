"""Logical-axis sharding rules with divisibility-aware fallback, and the
port's counterpart of GSPMD.

The port of ``repro/distributed/sharding.py``.  Model code annotates every
parameter / activation with a tuple of *logical axis* names.
:func:`logical_to_spec` resolves them against a mesh through the rule
table, dropping any mesh axis that does not evenly divide its dimension;
it is pure Python and returns the reference's ``PartitionSpec`` entries as
a tuple (None, an axis name, or a tuple of names).

PyTorch has no sharding propagation, so the reference's two ways of
sharding map like this:

- **State placement** (GSPMD's in/out shardings) is DTensor:
  ``named_sharding`` gives a ``Sharding`` whose ``placements`` are
  ``Shard(dim)`` on the mesh axes the spec names and ``Replicate()``
  elsewhere; ``Sharding.place`` lays a whole tensor out as a DTensor (each
  rank keeps its own slice, no communication); ``constraint``
  ``redistribute``s a DTensor to a spec.
- **Compute** runs on local tensors, as a ``shard_map`` body does.  A step
  builder (``trainstep``) installs the mesh with ``use_mesh(mesh,
  batch_axes)``: the activations are this rank's slice of the batch, split
  over ``batch_axes``.  The dense layers run data-parallel on that slice
  with whole weights: ``gather`` (``layers.fsdp_gather``, a layer at a
  time) all-gathers a weight's shards, and its backward sums the weight's
  gradient over every rank and keeps this rank's shard (a reduce-scatter),
  the FSDP / ZeRO-3 schedule (the MoE's expert weights are gathered over
  the fsdp axes only and stay sharded over "model", as the reference's
  ``shard_map`` takes them).  Without propagation the port does not
  partition the dense products over the model axis as GSPMD does (tensor
  parallelism); train and prefill steps split the batch over the model
  axis too where it divides, so a device's share of the work is GSPMD's
  (``tests/test_torch_roofline.py`` holds the per-device FLOPs to the
  reference's HLO).  The ``shard_map`` bodies (the MoE's expert
  parallelism, the flash decode over a sequence-sharded cache, the
  pipeline) keep the reference's explicit partitions and collectives
  (``collectives``): each takes its own shards from the step's layout,
  so the reference's ``compat_shard_map`` has no counterpart here.  A
  plain local tensor is already in the step's layout, so ``constraint``
  leaves it as it is, and the gradients arrive in their shards from the
  gather's backward, where the reference constrains them with
  ``tree_constraint``.

Without a mesh every function here is an identity, as in the reference.
"""
from __future__ import annotations

from typing import Mapping, Optional, Sequence

import torch

from repro_torch.distributed import collectives as C

# Default logical->mesh rules.  "fsdp" and "tp" are *roles* resolved per mesh:
#   single pod : fsdp=("data",)      tp=("model",)
#   multi-pod  : fsdp=("pod","data") tp=("model",)   (pod as extra DP/FSDP dim)
LOGICAL_RULES: dict[str, Optional[str]] = {
    # parameters
    "embed": "fsdp",         # d_model dim of weights: FSDP-sharded
    "heads": "tp",
    "kv_heads": "tp",
    "qkv": "tp",             # fused qkv output dim
    "ff": "tp",
    "vocab": "tp",
    "expert": "ep",          # expert axis (EP); falls back per-expert TP via "expert_ff"
    "expert_ff": "tp",
    "moe_cap": "dp_tp",      # MoE capacity dim: data axis (+ model when EP unused)
    "ssm_heads": "tp",
    "ssm_inner": "tp",
    "ssm_state": None,
    "layers": None,
    "stack": None,
    # activations
    "batch": "dp",
    "seq": None,
    "seq_sp": "tp",          # sequence-parallel activations between blocks
    "seq_kv": "tp",          # KV-cache sequence dim for long-context decode
    "act_embed": None,
    "frames": None,
}


def mesh_roles(mesh) -> dict[str, tuple[str, ...]]:
    names = mesh.axis_names
    multi = "pod" in names
    dp = ("pod", "data") if multi else ("data",)
    return {
        "dp": dp,
        "fsdp": dp,
        "tp": ("model",),
        "ep": ("model",),
        "dp_tp": dp + ("model",),
    }


def _axis_size(mesh, axes: tuple[str, ...]) -> int:
    n = 1
    for a in axes:
        n *= mesh.shape[a]
    return n


def logical_to_spec(
    logical: Sequence[Optional[str]],
    shape: Sequence[int],
    mesh,
    rules: Optional[Mapping[str, Optional[str]]] = None,
) -> tuple:
    """Resolve logical axis names to PartitionSpec entries, honoring
    divisibility.  ``mesh`` needs only ``axis_names`` and ``shape``."""
    rules = dict(LOGICAL_RULES, **(rules or {}))
    roles = mesh_roles(mesh)
    used: set[str] = set()
    spec: list = []
    assert len(logical) == len(shape), (logical, shape)
    for name, dim in zip(logical, shape):
        role = rules.get(name) if name else None
        if role is None:
            spec.append(None)
            continue
        axes = roles[role]
        # never map the same mesh axis to two tensor dims
        axes = tuple(a for a in axes if a not in used)
        if not axes or dim % _axis_size(mesh, axes) != 0:
            # try a suffix that still divides (e.g. drop "pod" but keep "data")
            while axes and dim % _axis_size(mesh, axes) != 0:
                axes = axes[1:]
            if not axes:
                spec.append(None)
                continue
        used.update(axes)
        spec.append(axes[0] if len(axes) == 1 else tuple(axes))
    while spec and spec[-1] is None:
        spec.pop()
    return tuple(spec)


def _entry_axes(entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


# ---------------------------------------------------------------------------
# placements: the counterpart of NamedSharding
# ---------------------------------------------------------------------------

class Sharding:
    """A spec on a mesh (the reference's ``NamedSharding``)."""

    def __init__(self, mesh, spec: tuple):
        self.mesh, self.spec = mesh, tuple(spec)

    def __repr__(self) -> str:
        return f"Sharding({self.spec})"

    @property
    def placements(self) -> tuple:
        """DTensor placements, one a mesh axis."""
        from torch.distributed.tensor import Replicate, Shard
        out = []
        for a in self.mesh.axis_names:
            dims = [d for d, e in enumerate(self.spec)
                    if a in _entry_axes(e)]
            out.append(Shard(dims[0]) if dims else Replicate())
        return tuple(out)

    def spec_axes(self) -> tuple:
        """Every mesh axis the spec names."""
        return tuple(a for e in self.spec for a in _entry_axes(e))

    def spec_dim(self, axis: str):
        """The tensor dim sharded over ``axis``, or None."""
        for d, e in enumerate(self.spec):
            if axis in _entry_axes(e):
                return d
        return None

    def without(self, axis: str) -> tuple:
        """The spec with ``axis`` dropped (replicated over it)."""
        out = []
        for e in self.spec:
            rest = tuple(a for a in _entry_axes(e) if a != axis)
            out.append(None if not rest else rest[0] if len(rest) == 1
                       else rest)
        return tuple(out)

    def local(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's slice of a whole tensor (a view)."""
        for d, e in enumerate(self.spec):
            axes = _entry_axes(e)
            if axes:
                n = self.mesh.size(axes)
                step = full.shape[d] // n
                full = full.narrow(d, self.mesh.coord(axes) * step, step)
        return full

    def place(self, full: torch.Tensor):
        """A DTensor of ``full`` laid out by this sharding, no
        communication: this rank's slice copied to its own storage, or
        ``full`` itself where the slice is all of it (a mesh of one rank:
        no second copy of a full-width model)."""
        part = self.local(full)
        if part.numel() != full.numel():
            part = part.clone(memory_format=torch.contiguous_format)
        return self.from_local(part, full.shape)

    def from_local(self, local: torch.Tensor, shape):
        """A DTensor of global ``shape`` from this rank's slice."""
        from torch.distributed.tensor import DTensor
        stride = torch.empty(shape, device="meta").stride()
        return DTensor.from_local(local, self.mesh.device_mesh,
                                  self.placements, run_check=False,
                                  shape=torch.Size(shape), stride=stride)


def named_sharding(logical, shape, mesh, rules=None) -> Sharding:
    return Sharding(mesh, logical_to_spec(logical, shape, mesh, rules))


def _is_logical_leaf(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None)))
                                        for e in x)


def _map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts / tuples of tensors, tuples
    of logical names being leaves (sorted dict keys, as jax walks them)."""
    if isinstance(tree, dict):
        return {k: _map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)) and not _is_logical_leaf(tree):
        parts = [_map(fn, *xs) for xs in zip(tree, *rest)]
        return type(tree)(*parts) if hasattr(tree, "_fields") \
            else type(tree)(parts)
    return fn(tree, *rest)


def tree_shardings(logical_tree, shape_tree, mesh, rules=None):
    """A tree of ``Sharding`` from a tree of logical-axis tuples and a tree
    of tensors (meta or real) of the same structure."""
    return _map(lambda lg, t: named_sharding(lg, t.shape, mesh, rules),
                logical_tree, shape_tree)


def place_tree(tree, shardings):
    """Every leaf of ``tree`` laid out as a DTensor by its ``Sharding``."""
    return _map(lambda t, s: s.place(t), tree, shardings)


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def local(x):
    """A DTensor's local shard; any other tensor as it is."""
    return x.to_local() if is_dtensor(x) else x


def full(x):
    """A DTensor gathered whole; any other tensor as it is."""
    return x.full_tensor() if is_dtensor(x) else x


# ---------------------------------------------------------------------------
# active-mesh context
# ---------------------------------------------------------------------------
# Model code calls constraint(x, logical) without threading a mesh through
# every layer; the step builders install the mesh (and the batch layout of
# the local activations) here.  With no mesh active constraints are a no-op.

_ACTIVE: list = [(None, (), False)]


class use_mesh:
    """Context manager installing the active mesh.  ``batch_axes`` are the
    mesh axes the local activations' batch dim is split over (``()``: each
    rank holds the whole batch, as a direct caller of a layer passes it);
    ``kv_sharded`` says that the KV caches a decode step hands its layers
    are this rank's rows of a sequence sharded over "model"."""

    def __init__(self, mesh, batch_axes: tuple = (), kv_sharded=False):
        self.state = ((mesh, tuple(batch_axes), kv_sharded)
                      if mesh is not None else (None, (), False))

    def __enter__(self):
        _ACTIVE.append(self.state)
        return self.state[0]

    def __exit__(self, *exc):
        _ACTIVE.pop()


def active_mesh():
    return _ACTIVE[-1][0]


def active_batch_axes() -> tuple:
    return _ACTIVE[-1][1]


def active_kv_sharded() -> bool:
    return _ACTIVE[-1][2]


def constraint(x, logical, mesh=None, rules=None):
    """A DTensor redistributed to the spec of ``logical``; a local tensor
    (already in the step's layout) or no mesh: ``x`` as it is."""
    mesh = mesh or active_mesh()
    if mesh is None or not is_dtensor(x):
        return x
    return x.redistribute(mesh.device_mesh, named_sharding(
        logical, x.shape, mesh, rules).placements)


# ---------------------------------------------------------------------------
# the FSDP gather
# ---------------------------------------------------------------------------

class _Gather(torch.autograd.Function):
    """A weight's shards all-gathered over the spec's axes but ``keep``;
    the backward sums the gradient over every rank that holds the same
    gathered tensor and keeps this rank's shard of it (``collectives``
    issues nothing over an axis of one rank)."""

    @staticmethod
    def forward(ctx, x, mesh, spec, keep):
        ctx.mesh, ctx.spec, ctx.keep = mesh, spec, keep
        for d, e in enumerate(spec):
            for a in reversed(_entry_axes(e)):
                if a not in keep:
                    x = C._all_gather(x, d, mesh.group(a))
        return x

    @staticmethod
    def backward(ctx, g):
        mesh, spec, keep = ctx.mesh, ctx.spec, ctx.keep
        sharded = [a for e in spec for a in _entry_axes(e)]
        rest = tuple(a for a in mesh.axis_names if a not in sharded)
        g = g.contiguous()
        if rest:
            g = C._all_reduce_(g.clone(), mesh.group(rest))
        for d, e in enumerate(spec):
            for a in _entry_axes(e):
                if a not in keep:
                    g = C._reduce_scatter(g, d, mesh.group(a))
        return g, None, None, None


def gather(x: torch.Tensor, logical, shape, mesh, keep: tuple = ()):
    """The whole of a weight of global ``shape`` from this rank's shard
    ``x`` (laid out by ``logical``), but still sharded over the mesh axes
    ``keep``; differentiable (``_Gather``).  With no gradient to carry and
    no axis of more than one rank to gather, ``x`` itself (a decode step's
    host time is a layer's weights' calls)."""
    spec = _spec(tuple(logical), tuple(shape), mesh)
    if not x.requires_grad and all(
            mesh.shape[a] == 1 or a in keep
            for e in spec for a in _entry_axes(e)):
        return x
    return _Gather.apply(x, mesh, spec, tuple(keep))


def _spec(logical: tuple, shape: tuple, mesh) -> tuple:
    """``logical_to_spec`` with the default rules, memoized on the mesh
    (a step resolves every weight's spec every call)."""
    key = (logical, shape)
    if key not in mesh.specs:
        mesh.specs[key] = logical_to_spec(logical, shape, mesh)
    return mesh.specs[key]
