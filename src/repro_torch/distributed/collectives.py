"""Collectives of the mesh path, and the manual flash-decode collective.

The port of ``repro/distributed/collectives.py``, plus the named-axis
collectives a ``shard_map`` body calls in the reference, each on the
process group of a mesh axis (``Mesh.group``) and differentiable, with the
exact adjoint as its backward (the objective of a sharded step is the sum
of every rank's loss, ``trainstep``):

- ``psum`` -> ``all_reduce(SUM)`` (backward: ``all_reduce(SUM)``);
- ``pmean`` -> ``all_reduce(SUM)`` then a division;
- ``all_gather`` (tiled, along a dim) -> ``all_gather_into_tensor``
  (backward: a reduce-scatter);
- ``all_to_all`` (tiled) -> ``all_to_all_single`` (backward: the reverse
  all-to-all);
- ``ppermute`` -> ``batch_isend_irecv``.

Tensor parallelism (``sharding.TensorParallel``) takes these over the
"model" group, on local tensors:

- ``row_parallel_sum``, the all-reduce of a row-parallel product's partial
  sums (after wo, the MLP's w2, the SSD mixer's wo and the vocab-parallel
  lookup) where the residual is whole on every model rank (a serve step,
  or a train step whose sequence does not divide the model axis), and
  ``psum`` of the gated norm's sums of squares and of the vocab-parallel
  cross-entropy's sums;
- ``all_gather`` of a projection's heads (q's for the flash decode, which
  takes q whole, or columns that are not whole heads);
- the sequence-parallel pair of a train step: ``all_gather`` on the
  sequence (dim 1) of a block's normed input before its column-parallel
  products (backward: a reduce-scatter), and ``reduce_scatter`` of a
  row-parallel product's partial sums onto the sequence (backward: an
  all-gather).

The reference's GSPMD all-reduces where the residual is whole too: a
decode step's residual (one position) does not divide the model axis, so
its ``("batch", "seq_sp", None)`` constraint leaves it replicated.  Each
issues only ``all_reduce``, ``all_gather_into_tensor`` or
``reduce_scatter_tensor``, which gloo also runs on a CUDA tensor (its
reduce-scatter an all-reduce and a slice, below).  The cross-entropy's row
maxima are taken by an all-gather, not an all-reduce MAX.

``all_gather`` and the helpers that the FSDP gather and the flash decode's
merge call (``_all_gather``, ``_reduce_scatter``, ``_all_reduce_``) issue
nothing over a group of one rank, where each is the identity (a mesh of
one rank moves no weight and no workspace); ``psum``, ``all_to_all`` and
``ppermute`` always issue theirs.  The gloo backend has no
reduce-scatter of a tensor on every build: there the reduce-scatter is an
all-reduce and this rank's slice.

``flash_decode_attention``: single-token decode against a KV cache whose
*sequence* dim is sharded over the model axis.  Each shard writes the new
K/V into its own rows when ``pos`` falls in its range (``pos`` is a host
int in the port, so the guard is a host test, no device read), runs the
flash-decoding split kernel (row 5, ``kernels/decode_attention.py``) over
its rows, and the ranks' partial softmaxes ``(m, l, acc)`` are merged: one
all-gather of the split workspaces over the model axis, then the combine
kernel over every rank's splits in global split order, so every rank gets
the same bits (where the reference merges with ``pmax`` and ``psum``).  A shard whose rows all lie past ``pos`` writes the neutral
partials ``(-1e30, 0, 0)`` itself (the split kernel reads a length of 0 as
"the mean of V").  The combine counts a split's first position as its index
times the plan's length, which is a shard's true offset only when the
shard is a whole number of splits; so the combine is told every split is
valid, and the splits past ``pos`` weigh ``exp(-1e30 - m) = 0`` (at one
rank this is the mesh=None call's merge: the neutral splits add zeros).
On CPU tensors the two kernels' plain versions run.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from repro_torch.kernels import decode_attention as _da
from repro_torch.kernels import ref as _ref

# a CPU caller's stand-in for the card's SM count in the decoding plan
_CPU_SMS = 132


def _gloo(group) -> bool:
    return dist.get_backend(group) == "gloo"


def _all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    n = dist.get_world_size(group)
    if n == 1:
        return x
    x = x.movedim(dim, 0).contiguous()
    out = torch.empty((n * x.shape[0],) + x.shape[1:], dtype=x.dtype,
                      device=x.device)
    dist.all_gather_into_tensor(out, x, group=group)
    return out.movedim(0, dim)


def _all_reduce_(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over ``group`` in place."""
    if dist.get_world_size(group) > 1:
        dist.all_reduce(x, group=group)
    return x


def _reduce_scatter(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    n = dist.get_world_size(group)
    if n == 1:
        return x
    src = x
    x = x.movedim(dim, 0).contiguous()
    if _gloo(group):
        if x.data_ptr() == src.data_ptr():    # summed in place: not src
            x = x.clone()
        dist.all_reduce(x, group=group)
        out = x.chunk(n)[dist.get_group_rank(group, dist.get_rank())]
        return out.movedim(0, dim).contiguous()
    out = torch.empty((x.shape[0] // n,) + x.shape[1:], dtype=x.dtype,
                      device=x.device)
    dist.reduce_scatter_tensor(out, x, group=group)
    return out.movedim(0, dim)


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.dim, ctx.group), None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _reduce_scatter(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.dim, ctx.group), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.contiguous()
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        out = torch.empty_like(g)
        dist.all_to_all_single(out, g, group=ctx.group)
        return out, None


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``group``."""
    return _AllReduce.apply(x, group)


def pmean(x: torch.Tensor, group) -> torch.Tensor:
    return psum(x, group) / dist.get_world_size(group)


def all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim`` in group-rank order (a
    tiled all-gather)."""
    return _AllGather.apply(x, dim, group)


def reduce_scatter(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The ranks' ``x`` summed, and this rank's one of the group's equal
    chunks of the sum along ``dim`` (a tiled reduce-scatter; backward: the
    all-gather)."""
    return _ReduceScatter.apply(x, dim, group)


def row_parallel_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The partial sums ``x`` of a row-parallel product (this rank's rows
    of the weight times its columns of the input) added over ``group``:
    in place where autograd records nothing on ``x`` (the product's own
    result), else ``psum``."""
    if torch.is_grad_enabled() and x.requires_grad:
        return psum(x, group)
    return _all_reduce_(x, group)


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """A tiled all-to-all on dim 0: the i-th of the group's equal chunks of
    ``x`` goes to rank i, and the result holds the chunks received, in
    rank order."""
    return _AllToAll.apply(x, group)


def ppermute(x: torch.Tensor, group, perm) -> torch.Tensor:
    """``x`` sent along ``perm``'s (source, destination) pairs of group
    ranks; a rank that receives nothing gets zeros (no gradient)."""
    me = dist.get_group_rank(group, dist.get_rank())
    x = x.detach().contiguous()
    out = torch.zeros_like(x)
    ops = []
    for src, dst in perm:
        if src == me:
            ops.append(dist.P2POp(dist.isend, x,
                                  dist.get_global_rank(group, dst), group))
        if dst == me:
            ops.append(dist.P2POp(dist.irecv, out,
                                  dist.get_global_rank(group, src), group))
    for w in dist.batch_isend_irecv(ops) if ops else ():
        w.wait()
    return out


# ---------------------------------------------------------------------------
# flash decode over a sequence-sharded cache
# ---------------------------------------------------------------------------

def _dp_axes(mesh, batch):
    axes = dict(zip(mesh.axis_names, mesh.devices.shape))
    dp = tuple(a for a in ("pod", "data") if a in axes)
    while dp:
        n = 1
        for a in dp:
            n *= axes[a]
        if batch % n == 0:
            break
        dp = dp[1:]
    return dp


def applicable(mesh, batch, seq, num_heads, num_kv_heads) -> bool:
    if mesh is None:
        return False
    axes = dict(zip(mesh.axis_names, mesh.devices.shape))
    ep = axes.get("model", 1)
    return seq % ep == 0


def _plan(q, ck, cv) -> _da.Plan:
    """The kernels' plan; for their plain versions (a CPU or meta tensor)
    splits of at most the shard's rows: the kernel's least split is a
    thread step, but it reads no row past S, and the plain split computes
    every row of its splits."""
    if q.is_cuda:
        return _da.plan_for(q, ck, cv)
    B, S, H, D = ck.shape
    pl = _da.plan(B, S, H, D, ck.element_size(), True, _CPU_SMS)
    n = min(pl.len, S)
    return dataclasses.replace(pl, len=n, ns=-(-S // n))


def flash_decode_attention(q, cache_k, cache_v, k_new, v_new, pos: int,
                           mesh, heads=None):
    """Local shards: q ``[B,1,H,hd]`` (this rank's batch, every head);
    cache ``[B,S_l,KV,hd]`` (this rank's rows of the sequence, which is
    sharded over "model"); k/v_new ``[B,1,KV,hd]``; ``pos`` an int;
    ``heads`` (first, count) the heads whose output is wanted (a
    tensor-parallel rank's), every head when None: only those are merged.
    Writes k/v_new into the cache in place when ``pos`` is in this shard;
    returns (out ``[B,1,count,hd]`` in q's type, cache_k, cache_v)."""
    B, Sl, KV, hd = cache_k.shape
    H = q.shape[2]
    group = mesh.group("model")
    ep = mesh.size("model")
    start = mesh.coord("model") * Sl
    if start <= pos < start + Sl:
        cache_k[:, pos - start] = k_new[:, 0].to(cache_k.dtype)
        cache_v[:, pos - start] = v_new[:, 0].to(cache_v.dtype)
    kk = cache_k.to(q.dtype)
    vv = cache_v.to(q.dtype)
    if H // KV > 1:
        kk = torch.repeat_interleave(kk, H // KV, dim=-2)
        vv = torch.repeat_interleave(vv, H // KV, dim=-2)
    q1, kk, vv = q[:, 0].contiguous(), kk.contiguous(), vv.contiguous()
    pl = _plan(q1, kk, vv)
    n_loc = min(max(pos + 1 - start, 0), Sl)
    if n_loc == 0:             # every row past pos: the neutral partials
        ws = torch.zeros(B * pl.ns * H * (hd + 2), dtype=torch.float32,
                         device=q.device)
        ws[:B * pl.ns * H * 2].view(B, pl.ns, H, 2)[..., 0] = _ref.NEG_INF
    else:
        lens = torch.full((B,), n_loc, dtype=torch.int32, device=q.device)
        split = _da.split if q.is_cuda else _da.split_plain
        ws = split(q1, kk, vv, lens, pl)
    # every rank's workspace in one all-gather, the wanted heads of its
    # splits then put in global split order (rank-major within each batch
    # entry)
    lo, nh = heads or (0, H)
    n_ml = B * pl.ns * H * 2
    every = _all_gather(ws, 0, group).view(ep, -1)
    ml = every[:, :n_ml].reshape(ep, B, pl.ns, H, 2)[..., lo:lo + nh, :]
    acc = every[:, n_ml:].reshape(ep, B, pl.ns, H, hd)[..., lo:lo + nh, :]
    ws = torch.cat([ml.transpose(0, 1).flatten(),
                    acc.transpose(0, 1).flatten()])
    glob = dataclasses.replace(pl, ns=ep * pl.ns)
    S_all = glob.ns * glob.len           # every split valid (docstring)
    lens = torch.full((B,), S_all, dtype=torch.int32, device=q.device)
    if q.is_cuda:
        out = _da.combine(ws, lens, glob, S_all,
                          q1.new_empty((B, nh, hd)))
    else:
        out = _da.combine_plain(ws, lens, glob, S_all, (B, nh, hd),
                                q.dtype)
    return out[:, None], cache_k, cache_v
