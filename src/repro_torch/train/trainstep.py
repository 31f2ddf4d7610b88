"""Train / serve step builders.

The port of ``repro/train/trainstep.py``.  On one device (``mesh=None``)
``build_train_step`` returns ``(step_fn, None, None, (0, 1))`` as the
reference does without a mesh.  ``step_fn(params, opt_state, batch)``
returns ``(params, opt_state, {"loss", "grad_norm", "lr"})``; the metrics
stay tensors on the device.  Gradients come from ``torch.autograd.grad``
over the parameter tree's leaves in the reference's order (sorted keys),
in each parameter's type.  Gradient accumulation (microbatching) splits
the batch's leading axis into ``microbatches`` parts, adds their gradients
in float32, divides by the count and takes the mean of the losses (the
reference's ``lax.scan``).  ``compress_grads`` passes the gradients
through the int8 quantize / dequantize of ``distributed.compression``
before the optimizer.

The reference donates the parameters and the optimizer state
(``donate_argnums`` ``(0, 1)``); so does the port: the step writes the new
values into the tensors it was given (``optimizer.apply_``), and a caller
keeps no other use of them.  A step that fails before the optimizer's
first write leaves them as they were and may be run again; one that fails
after it raises ``optimizer.PartialUpdateError``.

Under a mesh (``launch.mesh``) the builders return the reference's
``(fn, in_shardings, out_shardings, donate)``, the shardings trees of
``sharding.Sharding`` (``param_shardings``, ``opt_shardings``,
``batch_shardings``); the parameters and moments of a train step are
DTensors laid out by them (``Sharding.place``, ``place_tree``): the step
writes into their shards; a batch, and a prefill's or decode's
parameters and cache, may also be whole tensors, laid out at each call.
Each rank computes on its local tensors (``distributed/sharding.py``).
Every step splits the batch over the data axes only (``batch_axes``, the
reference's "batch" rule) and the dense products over "model"
(``sharding.tensor_parallel``, the reference's "tp" rule): the weights
keep their "model" shards of the TP axes (``layers.fsdp_gather`` gathers
a layer's data shards at a time, the step the others, ``_live``), and the
logits of a serve step come out of it as this rank's slice of the
vocabulary.  A train step also splits the residual between blocks over
the sequence where it divides the model axis (``TensorParallel.seq``, the
reference's ``("batch", "seq_sp", None)`` constraint) and takes a
vocab-parallel cross-entropy.  The objective is the mean of the ranks'
losses: each rank differentiates its loss over the world size, every
collective's backward is its adjoint, and a weight's gradient arrives
summed into its shard, inside each microbatch (the reference's
``constrain``).  ``optimizer.apply_`` updates the local shards in place,
with the global gradient norm (``_global_norm``: each shard's squares over
its replicas, summed over the mesh).  At one rank on "model" the split is
the identity and the steps run the one-device layers.  A decode step keeps the cache as placed: its
sequence over "model" where it divides, so each layer takes
``collectives.flash_decode_attention``, else its kv heads over "model"
where they divide, which are the kv heads of this rank's q heads; the
SSD states' heads over "model" where they divide, which are this rank's
SSD heads, and the conv states gathered for the step and written back.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.distributed import collectives as C
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.compression import compress_decompress
from repro_torch.launch.mesh import Mesh
from repro_torch.models import api as mapi
from repro_torch.models.layers import tree_leaves, tree_map
from repro_torch.train import optimizer as opt


def _check_mesh(mesh) -> None:
    """A mesh is None or a ``launch.mesh.Mesh``; any other (a JAX mesh, say)
    is refused."""
    if mesh is not None and not isinstance(mesh, Mesh):
        raise NotImplementedError(
            f"a mesh of type {type(mesh).__name__}: the step builders take "
            "a repro_torch.launch.mesh.Mesh (a torch.distributed "
            "DeviceMesh, make_host_mesh / make_production_mesh) or None")


def batch_shardings(cfg, shape, mesh):
    specs = mapi.input_specs(cfg, shape)
    logical = mapi.batch_logical(cfg, shape)
    return {k: shd.named_sharding(logical[k], specs[k].shape, mesh)
            for k in specs}


def opt_structs(param_structs):
    f32 = lambda t: torch.empty(t.shape, dtype=torch.float32, device="meta")
    return opt.OptState(
        step=torch.empty((), dtype=torch.int32, device="meta"),
        mu=tree_map(f32, param_structs), nu=tree_map(f32, param_structs))


def param_shardings(model, mesh):
    return shd.tree_shardings(model.param_logical(), model.param_structs(),
                              mesh)


def opt_shardings(model, mesh):
    ps = param_shardings(model, mesh)
    return opt.OptState(step=shd.named_sharding((), (), mesh), mu=ps, nu=ps)


def batch_axes(mesh, batch: int) -> tuple:
    """The mesh axes a step splits the batch's rows over: the data axes
    that divide it (the reference's "batch" rule)."""
    return C._dp_axes(mesh, batch)


def _residual_len(batch) -> int:
    """The length of a train batch's residual sequence: its tokens, after
    the patches where it has them (a VLM's combined sequence)."""
    n = batch["tokens"].shape[1]
    return n + batch["patches"].shape[1] if "patches" in batch else n


def _local_batch(batch, shardings, axes, mesh) -> dict:
    """This rank's rows of each batch leaf (placed as ``shardings``, or
    whole), split over ``axes``."""
    out = {}
    for k, x in batch.items():
        if not shd.is_dtensor(x):
            x = shardings[k].place(x)
        x = x.to_local()
        extra = tuple(a for a in axes if a not in shardings[k].spec_axes())
        if extra:
            x = shd.Sharding(mesh, (extra,)).local(x)
        out[k] = x
    return out


def _live(model, params, shardings, mesh, grad: bool, tp=None):
    """(leaves, tree) for a step on this rank: each parameter's local
    shard (a fresh autograd leaf when ``grad``); in the tree the stacked
    layers' shards as they are (``layers.fsdp_gather`` gathers a layer at
    a time) and every other weight gathered, whole or, under the tensor
    parallelism ``tp``, but for its "model" shard of a TP axis."""
    leaves = []

    def one(p, lg, sh):
        if not shd.is_dtensor(p):
            p = sh.place(p)
        x = p.to_local()
        x = x.detach().requires_grad_() if grad else x
        leaves.append(x)
        if lg and lg[0] == "layers":
            return x
        return shd.gather(x, lg, tuple(p.shape), mesh,
                          keep=shd.kept_axes(lg, tp))

    live = tree_map(one, params, model.param_logical(), shardings)
    return leaves, live


def _global_norm(grads, shardings, mesh) -> torch.Tensor:
    """The L2 norm of the whole gradient from this rank's shards: each
    shard's sum of squares over the ranks that hold the same shard, summed
    in leaf order, then over the mesh."""
    world = mesh.size()
    sq = sum(torch.sum(torch.square(g.float()))
             / (world // mesh.size(sh.spec_axes()))
             for g, sh in zip(tree_leaves(grads), tree_leaves(shardings)))
    dist.all_reduce(sq, group=mesh.group())
    return torch.sqrt(sq)


def default_microbatches(cfg: ModelConfig, shape: InputShape, mesh) -> int:
    """Split the global batch so per-microbatch activations fit ~10 GB a
    device (the reference's fit from its dry runs: peak activation temp
    ~= 77 bytes x tokens a device x d_model for a rematted step; MoE
    dispatch buffers scale with the top-k slots).  Must divide the
    per-device batch.  ``mesh`` is anything with ``axis_names`` and
    ``devices.shape``; None (one device) gives 1."""
    if mesh is None:
        return 1
    axes = dict(zip(mesh.axis_names, mesh.devices.shape))
    n_data = axes.get("data", 1) * axes.get("pod", 1)
    per_dev_batch = max(shape.global_batch // n_data, 1)
    tokens_dev = per_dev_batch * shape.seq_len
    need = 77.0 * tokens_dev * cfg.d_model / 10e9
    if cfg.num_experts:
        need *= 1 + cfg.experts_per_token
    micro = 1
    while micro < per_dev_batch and need / micro > 1.0:
        micro *= 2
    return micro


def value_and_grad(model: mapi.Model, params, batch):
    """(loss, grads): the loss as a detached tensor and the gradient of
    every parameter, a tree of ``params``' structure in their types."""
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    it = iter(leaves)
    live = tree_map(lambda _: next(it), params)
    loss = model.loss(live, batch)
    grads = iter(torch.autograd.grad(loss, leaves))
    return loss.detach(), tree_map(lambda _: next(grads), params)


def build_train_step(model: mapi.Model, shape: InputShape, mesh=None,
                     opt_cfg: Optional[opt.OptConfig] = None,
                     microbatches: Optional[int] = None,
                     compress_grads: bool = False):
    """Returns (train_step, in_shardings, out_shardings, donate_argnums):
    ``(step_fn, None, None, (0, 1))`` on one device."""
    _check_mesh(mesh)
    opt_cfg = opt_cfg or opt.OptConfig()
    if microbatches is None:
        microbatches = default_microbatches(model.cfg, shape, mesh)
    if mesh is not None:
        return _sharded_train_step(model, shape, mesh, opt_cfg,
                                   microbatches, compress_grads)

    def train_step(params, opt_state, batch):
        if microbatches > 1:
            k = microbatches
            split = {n: x.reshape((k, x.shape[0] // k) + x.shape[1:])
                     for n, x in batch.items()}
            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            losses = []
            for i in range(k):
                loss_i, g = value_and_grad(
                    model, params, {n: x[i] for n, x in split.items()})
                for acc, gi in zip(tree_leaves(grads), tree_leaves(g)):
                    acc.add_(gi)
                del g
                losses.append(loss_i)
            for acc in tree_leaves(grads):
                acc.div_(k)
            loss = torch.stack(losses).mean()
        else:
            loss, grads = value_and_grad(model, params, batch)
        if compress_grads:
            grads = compress_decompress(grads)
        params, opt_state, metrics = opt.apply_(opt_cfg, params, grads,
                                                opt_state)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return train_step, None, None, (0, 1)


def _sharded_train_step(model, shape, mesh, opt_cfg, microbatches,
                        compress_grads):
    cfg = model.cfg
    p_sh = param_shardings(model, mesh)
    o_sh = opt_shardings(model, mesh)
    b_sh = batch_shardings(cfg, shape, mesh)
    scalar = shd.named_sharding((), (), mesh)
    world = mesh.size()

    def train_step(params, opt_state, batch):
        if not all(map(shd.is_dtensor, tree_leaves(params)
                       + tree_leaves(opt_state.mu) + [opt_state.step])):
            raise ValueError("a sharded train step updates its state's "
                             "shards in place: lay the parameters and the "
                             "optimizer state out by in_shardings first "
                             "(sharding.place_tree)")
        B = next(iter(batch.values())).shape[0]
        axes = batch_axes(mesh, B)
        local = _local_batch(batch, b_sh, axes, mesh)
        tp = shd.tensor_parallel(cfg, mesh, seq_len=_residual_len(batch))
        # the microbatches split the rows a data shard holds: as many as
        # divide them, up to the count asked for
        rows = B // mesh.size(axes)
        k = max(d for d in range(1, microbatches + 1) if rows % d == 0)
        grads, losses = None, []
        with shd.use_mesh(mesh, axes, tp=tp):
            for i in range(k):
                leaves, live = _live(model, params, p_sh, mesh, grad=True,
                                     tp=tp)
                mb = {n: x.reshape((k, x.shape[0] // k) + x.shape[1:])[i]
                      for n, x in local.items()}
                loss_i = model.loss(live, mb)
                # the mean of the ranks' losses: each rank's share; the
                # gradients arrive summed into this rank's shards
                g = torch.autograd.grad(loss_i / world, leaves)
                if k == 1:
                    grads = list(g)
                else:
                    grads = [gi.float() for gi in g] if grads is None else \
                        [a.add_(gi) for a, gi in zip(grads, g)]
                del g, live, leaves
                losses.append(loss_i.detach())
        if k > 1:
            for acc in grads:
                acc.div_(k)
        it = iter(grads)
        grads = tree_map(lambda _: next(it), params)
        loss = torch.stack(losses).mean() if k > 1 else losses[0]
        loss = C.pmean(loss, mesh.group())
        if compress_grads:
            grads = compress_decompress(grads)
        gnorm = _global_norm(grads, p_sh, mesh)
        local_state = opt.OptState(shd.local(opt_state.step),
                                   tree_map(shd.local, opt_state.mu),
                                   tree_map(shd.local, opt_state.nu))
        _, new_state, metrics = opt.apply_(
            opt_cfg, tree_map(shd.local, params), grads, local_state,
            gnorm=gnorm)
        metrics["loss"] = loss
        return params, opt.OptState(scalar.from_local(new_state.step, ()),
                                    opt_state.mu, opt_state.nu), metrics

    out_sh = (p_sh, o_sh, {"loss": scalar, "grad_norm": scalar,
                           "lr": scalar})
    return train_step, (p_sh, o_sh, b_sh), out_sh, (0, 1)


def _to_sharding(x, logical, axes, sharding, mesh, tp=None):
    """A DTensor laid out by ``sharding`` from this rank's local ``x`` of a
    step, laid out by ``logical``: its "batch" dim split over ``axes`` and,
    under the tensor parallelism ``tp``, its "vocab" dim and its
    "kv_heads" / "ssm_heads" dim where they are whole heads this rank's
    "model" shard.  A heads shard that ``sharding`` does not keep is
    all-gathered here (the redistribution would take an all-to-all, which
    gloo does not run on every device); every other change of layout is a
    local slice."""
    logical = list(logical)
    spec = [None] * x.ndim
    spec[logical.index("batch")] = axes if axes else None
    if tp is not None and tp.vocab and "vocab" in logical:
        spec[logical.index("vocab")] = "model"
    for name, mine in (("kv_heads", tp is not None and tp.whole_kv_heads),
                       ("ssm_heads", tp is not None and tp.ssm_heads)):
        if mine and name in logical:
            d = logical.index(name)
            if sharding.spec_dim("model") == d:
                spec[d] = "model"
            else:
                x = C._all_gather(x, d, tp.group)
    shape = list(x.shape)
    for d, e in enumerate(spec):
        if e:
            shape[d] *= mesh.size(e)
    dt = shd.Sharding(mesh, tuple(spec)).from_local(x, shape)
    return dt.redistribute(mesh.device_mesh, sharding.placements)


# the logical axes of a serve step's logits (the reference's constraint)
LOGITS = ("batch", None, "vocab")


def build_prefill_step(model: mapi.Model, shape: InputShape, mesh=None):
    """Returns (prefill_step, in_shardings, out_shardings, ()):
    ``prefill_step(params, batch)`` is the model's prefill to
    ``shape.seq_len`` positions, no autograd recorded; ``(fn, None, None,
    ())`` on one device."""
    _check_mesh(mesh)
    if mesh is None:
        @torch.no_grad()
        def prefill_step(params, batch):
            return model.prefill(params, batch, max_seq=shape.seq_len)

        return prefill_step, None, None, ()

    cfg = model.cfg
    tp = shd.tensor_parallel(cfg, mesh)
    p_sh = param_shardings(model, mesh)
    b_sh = batch_shardings(cfg, shape, mesh)
    c_logical = model.cache_logical()
    c_sh = shd.tree_shardings(c_logical, model.cache_structs(
        shape.global_batch, shape.seq_len), mesh)
    logits_sh = shd.named_sharding(LOGITS, (shape.global_batch, 1,
                                            cfg.padded_vocab), mesh)

    @torch.no_grad()
    def prefill_step(params, batch):
        B = next(iter(batch.values())).shape[0]
        axes = batch_axes(mesh, B)
        local = _local_batch(batch, b_sh, axes, mesh)
        _, live = _live(model, params, p_sh, mesh, grad=False, tp=tp)
        with shd.use_mesh(mesh, axes, tp=tp):
            logits, cache = model.prefill(live, local, max_seq=shape.seq_len)
        logits = _to_sharding(logits, LOGITS, axes, logits_sh, mesh, tp)
        cache = {n: _to_sharding(c, c_logical[n], axes, c_sh[n], mesh, tp)
                 for n, c in cache.items()}
        return logits, cache

    return prefill_step, (p_sh, b_sh), (logits_sh, c_sh), ()


def build_decode_step(model: mapi.Model, shape: InputShape, mesh=None):
    """Returns (decode_step, in_shardings, out_shardings, (1,)):
    ``decode_step(params, cache, tokens, pos)`` updates the cache in place
    (the reference donates it) and returns (logits, cache); ``(fn, None,
    None, (1,))`` on one device."""
    _check_mesh(mesh)
    if mesh is None:
        @torch.no_grad()
        def decode_step(params, cache, tokens, pos):
            return model.decode_step(params, cache, tokens, pos)

        return decode_step, None, None, (1,)

    cfg = model.cfg
    tp = shd.tensor_parallel(cfg, mesh)
    B = shape.global_batch
    p_sh = param_shardings(model, mesh)
    c_logical = model.cache_logical()
    c_sh = shd.tree_shardings(c_logical, model.cache_structs(B, shape.seq_len),
                              mesh)
    t_sh = shd.named_sharding(("batch", None), (B, 1), mesh)
    pos_sh = shd.named_sharding((), (), mesh)
    logits_sh = shd.named_sharding(LOGITS, (B, 1, cfg.padded_vocab), mesh)

    @torch.no_grad()
    def decode_step(params, cache, tokens, pos):
        axes = batch_axes(mesh, tokens.shape[0])
        _, live = _live(model, params, p_sh, mesh, grad=False, tp=tp)
        tok = _local_batch({"tokens": tokens}, {"tokens": t_sh}, axes,
                           mesh)["tokens"]
        # each cache leaf local: its rows of the sequence over "model"
        # (the flash decode's layout), or under tensor parallelism its kv
        # heads over "model" (this rank's q heads' own) or its SSD heads
        # (this rank's own); any other dim "model" shards gathered for the
        # step and written back after it
        local, back = {}, {}
        for n, c in cache.items():
            if not shd.is_dtensor(c):
                c = cache[n] = c_sh[n].place(c)
            d = c_sh[n].spec_dim("model")
            if d is None or c_logical[n][d] == "seq_kv" or (
                    tp is not None and tp.whole_kv_heads
                    and c_logical[n][d] == "kv_heads") or (
                    tp is not None and tp.ssm_heads
                    and c_logical[n][d] == "ssm_heads"):
                local[n] = c.to_local()
            else:
                # all-gathered by the port's collective: DTensor's
                # redistribution over gloo ends the process on a CUDA
                # tensor
                local[n] = C._all_gather(c.to_local(), d,
                                         mesh.group("model"))
                back[n] = c
        kv = "k" in c_logical and c_sh["k"].spec_dim("model") == \
            c_logical["k"].index("seq_kv")
        with shd.use_mesh(mesh, axes, kv_sharded=kv, tp=tp):
            logits, _ = model.decode_step(live, local, tok, pos)
        for n, c in back.items():
            d = c_sh[n].spec_dim("model")
            c.to_local().copy_(shd.Sharding(mesh, tuple(
                "model" if i == d else None for i in range(d + 1)))
                .local(local[n]))
        return _to_sharding(logits, LOGITS, axes, logits_sh, mesh, tp), cache

    return decode_step, (p_sh, c_sh, t_sh, pos_sh), (logits_sh, c_sh), (1,)


def decode_inputs(model: mapi.Model, shape: InputShape):
    """Meta-tensor stand-ins for decode: (cache, tokens, pos)."""
    B = shape.global_batch
    cache = model.cache_structs(B, shape.seq_len)
    tokens = torch.empty((B, 1), dtype=torch.int32, device="meta")
    pos = torch.empty((), dtype=torch.int32, device="meta")
    return cache, tokens, pos
