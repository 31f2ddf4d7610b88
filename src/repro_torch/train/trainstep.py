"""Train / serve step builders.

The port of ``repro/train/trainstep.py`` for one device (``mesh=None``):
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
after it raises ``optimizer.PartialUpdateError``.  A mesh (sharded parameters, batch and
gradients) needs the port of ``distributed/`` and raises
``NotImplementedError``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.distributed.compression import compress_decompress
from repro_torch.models import api as mapi
from repro_torch.models.layers import tree_leaves, tree_map
from repro_torch.train import optimizer as opt


def _no_mesh(mesh, what: str) -> None:
    if mesh is not None:
        raise NotImplementedError(
            f"{what} with a device mesh needs the port of the reference's "
            "distributed/ (sharding and collectives), ROADMAP Queue 1 item "
            "4.5; pass mesh=None for one device")


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
    _no_mesh(mesh, "build_train_step")
    opt_cfg = opt_cfg or opt.OptConfig()
    if microbatches is None:
        microbatches = default_microbatches(model.cfg, shape, mesh)

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


def build_prefill_step(model: mapi.Model, shape: InputShape, mesh=None):
    """Returns (prefill_step, None, None, ()): ``prefill_step(params,
    batch)`` is the model's prefill to ``shape.seq_len`` positions, no
    autograd recorded."""
    _no_mesh(mesh, "build_prefill_step")

    @torch.no_grad()
    def prefill_step(params, batch):
        return model.prefill(params, batch, max_seq=shape.seq_len)

    return prefill_step, None, None, ()


def build_decode_step(model: mapi.Model, shape: InputShape, mesh=None):
    """Returns (decode_step, None, None, (1,)): ``decode_step(params,
    cache, tokens, pos)`` updates the cache in place (the reference donates
    it) and returns (logits, cache)."""
    _no_mesh(mesh, "build_decode_step")

    @torch.no_grad()
    def decode_step(params, cache, tokens, pos):
        return model.decode_step(params, cache, tokens, pos)

    return decode_step, None, None, (1,)


def decode_inputs(model: mapi.Model, shape: InputShape):
    """Meta-tensor stand-ins for decode: (cache, tokens, pos)."""
    B = shape.global_batch
    cache = model.cache_structs(B, shape.seq_len)
    tokens = torch.empty((B, 1), dtype=torch.int32, device="meta")
    pos = torch.empty((), dtype=torch.int32, device="meta")
    return cache, tokens, pos
