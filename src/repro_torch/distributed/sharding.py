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
  batch_axes, tp=...)``: the activations are this rank's slice of the
  batch, split over the data axes (the reference's "batch" rule), and
  ``tp`` says how the dense products are split over "model".  ``gather``
  (``layers.fsdp_gather``, a layer at a time) all-gathers a weight's
  shards over the axes it does not keep, and its backward sums the
  weight's gradient over every rank and keeps this rank's shard (a
  reduce-scatter), the FSDP / ZeRO-3 schedule.  Every step keeps the
  "model" shards of the tensor-parallel axes ("heads", "kv_heads", "qkv",
  "ff", "vocab", "ssm_heads", "ssm_inner"), as the reference's
  ``fsdp_gather`` drops only "embed": each rank computes its part of every
  projection, MLP, SSD mixer and unembedding product, as GSPMD partitions
  them (``TensorParallel``, ``tensor_parallel``; the column-parallel
  products' row-parallel partners end in a sum over "model").  Where a dim
  does not divide the model axis the rule leaves it whole and its product
  runs replicated, as in the reference.

  - a **serve step** (prefill, decode) holds the residual whole on every
    model rank: a row-parallel product ends in
    ``collectives.row_parallel_sum`` (an all-reduce);
  - a **train step** also takes the reference's sequence parallelism
    (``TensorParallel.seq``, its ``("batch", "seq_sp", None)`` constraint
    between blocks): where the sequence divides the model axis the
    residual is this rank's slice of it, a block's normed input is
    all-gathered on the sequence before its column-parallel products, and
    each row-parallel product ends in a reduce-scatter onto the sequence
    (``collectives.reduce_scatter``);
  - the MoE's expert weights stay sharded over "model" in both (the
    experts under expert parallelism, their d_ff under expert-TP), as the
    reference's ``shard_map`` takes them.

  The ``shard_map`` bodies (the MoE's expert parallelism, the flash decode
  over a sequence-sharded cache, the pipeline) keep the reference's
  explicit partitions and collectives (``collectives``): each takes its
  own shards from the step's layout, so the reference's
  ``compat_shard_map`` has no counterpart here.  A plain local tensor is
  already in the step's layout, so ``constraint`` leaves it as it is, and
  the gradients arrive in their shards from the gather's backward, where
  the reference constrains them with ``tree_constraint``.

Without a mesh every function here is an identity, as in the reference.
"""
from __future__ import annotations

from typing import Mapping, NamedTuple, Optional, Sequence

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
# tensor parallelism of the dense products
# ---------------------------------------------------------------------------

# the logical axes whose "model" shards a step keeps (the reference's "tp"
# rule on the dense weights)
TP_AXES = frozenset(("heads", "kv_heads", "qkv", "ff", "vocab", "ssm_heads",
                     "ssm_inner"))
# the logical axes of the MoE's expert weights (moe.moe_defs)
EXPERT_AXES = frozenset(("expert", "expert_ff"))


class TensorParallel(NamedTuple):
    """How a step splits the dense products over "model" (``n`` ranks;
    this one ``rank`` of ``group``): which products are split, from the
    rule's own divisibility fallback on each weight's dim.

    - ``heads`` / ``kv_heads``: wq's and wo's (wk's and wv's) "heads"
      dims are split: the projections are column-parallel, wo row-parallel;
    - ``whole_heads`` / ``whole_kv_heads``: a rank's columns are whole
      heads (the head count divides ``n``), so it attends with its own q
      heads (and kv heads); else the columns are all-gathered and a rank
      attends with the heads its columns fall in;
    - ``ff``: the MLP's d_ff (w1 / w3 column-, w2 row-parallel);
    - ``vocab``: the padded vocabulary (a vocab-parallel lookup, logits
      vocab-sharded, a vocab-parallel cross-entropy);
    - ``ssm_inner``: the SSD mixer's d_inner (wz / wx column-, wo
      row-parallel, the gated norm's sum of squares added over "model"), a
      rank computing the SSD heads its columns fall in;
    - ``ssm_heads``: those are whole heads (the SSD head count divides
      ``n``): wdt, dt_bias, A_log and D_skip are this rank's heads, else
      whole and the rank picks its heads from them;
    - ``seq``: the residual between blocks is this rank's slice of the
      sequence (a train step's sequence parallelism, where the sequence
      divides ``n``); else it is whole on every model rank."""
    n: int
    rank: int
    group: object
    heads: bool
    kv_heads: bool
    whole_heads: bool
    whole_kv_heads: bool
    ff: bool
    vocab: bool
    ssm_inner: bool
    ssm_heads: bool
    seq: bool


def tensor_parallel(cfg, mesh, seq_len: Optional[int] = None
                    ) -> Optional[TensorParallel]:
    """The split of ``cfg``'s dense products on ``mesh``; with
    ``seq_len`` (a train step's residual length) the sequence split too,
    where it divides the model axis.  None where "model" has one rank
    (there the split is the identity, and the steps run the one-device
    code)."""
    n = mesh.size("model") if "model" in mesh.axis_names else 1
    if n == 1:
        return None
    d, hd = cfg.d_model, cfg.head_dim
    H, KV = cfg.num_heads, cfg.num_kv_heads

    def split(logical, shape):
        return "model" in named_sharding(logical, shape, mesh).spec_axes()

    heads = split(("embed", "heads"), (d, H * hd))
    kv = split(("embed", "kv_heads"), (d, KV * hd))
    ssm_inner = split(("embed", "ssm_inner"), (d, cfg.d_inner))
    return TensorParallel(
        n=n, rank=mesh.coord("model"), group=mesh.group("model"),
        heads=heads, kv_heads=kv, whole_heads=heads and H % n == 0,
        whole_kv_heads=kv and KV % n == 0,
        ff=split(("embed", "ff"), (d, cfg.d_ff)),
        vocab=split(("vocab", "embed"), (cfg.padded_vocab, d)),
        ssm_inner=ssm_inner,
        ssm_heads=ssm_inner and split(("embed", "ssm_heads"),
                                      (d, cfg.ssm_nheads)),
        seq=seq_len is not None and seq_len % n == 0)


def kept_axes(logical, tp: Optional[TensorParallel]) -> tuple:
    """The mesh axes a weight laid out by ``logical`` keeps its shards
    over when a step gathers it: "model" for the MoE's expert weights and,
    under tensor parallelism, for the dense products' TP axes; none
    else."""
    names = set(logical)
    if EXPERT_AXES & names or (tp is not None and TP_AXES & names):
        return ("model",)
    return ()


# ---------------------------------------------------------------------------
# active-mesh context
# ---------------------------------------------------------------------------
# Model code calls constraint(x, logical) without threading a mesh through
# every layer; the step builders install the mesh (and the layout of the
# local activations) here.  With no mesh active constraints are a no-op.

class _State(NamedTuple):
    mesh: object
    batch_axes: tuple
    kv_sharded: bool
    tp: Optional[TensorParallel]


_ACTIVE: list = [_State(None, (), False, None)]


class _Push:
    """Context manager installing an active state."""

    def __init__(self, state: _State):
        self.state = state

    def __enter__(self):
        _ACTIVE.append(self.state)
        return self.state.mesh

    def __exit__(self, *exc):
        _ACTIVE.pop()


class use_mesh(_Push):
    """Context manager installing the active mesh.  ``batch_axes`` are the
    mesh axes the local activations' batch dim is split over (``()``: each
    rank holds the whole batch, as a direct caller of a layer passes it);
    ``kv_sharded`` says that the KV caches a decode step hands its layers
    are this rank's rows of a sequence sharded over "model"; ``tp`` (a
    step's ``tensor_parallel``) that the layers' dense weights are this
    rank's "model" shards of the TP axes, or None (whole weights)."""

    def __init__(self, mesh, batch_axes: tuple = (), kv_sharded=False,
                 tp: Optional[TensorParallel] = None):
        super().__init__(_State(mesh, tuple(batch_axes), kv_sharded, tp)
                         if mesh is not None else _ACTIVE[0])


def whole_sequence() -> _Push:
    """The active state with the residual whole on every model rank
    (``TensorParallel.seq`` off), for a part of a train step whose
    sequence the step does not split: Whisper's encoder, whose frames the
    decoder's cross-attention takes whole, and a VLM's text embeddings and
    logits, which sit beside the patches' positions.  Entered inside a
    layer body, so that remat's recompute runs under it too."""
    st = _ACTIVE[-1]
    if st.tp is not None and st.tp.seq:
        st = st._replace(tp=st.tp._replace(seq=False))
    return _Push(st)


def active_mesh():
    return _ACTIVE[-1].mesh


def active_batch_axes() -> tuple:
    return _ACTIVE[-1].batch_axes


def active_kv_sharded() -> bool:
    return _ACTIVE[-1].kv_sharded


def active_tp() -> Optional[TensorParallel]:
    """The active step's ``TensorParallel``, or None."""
    return _ACTIVE[-1].tp


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
