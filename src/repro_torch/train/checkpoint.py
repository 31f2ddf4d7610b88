"""Checkpointing: atomic, manifest-driven, mesh-independent.

The port of ``repro/train/checkpoint.py``, with its layout: one
``leaf_%05d.npy`` per leaf of ``{"params": params, "opt": opt_state}`` in
the reference's flatten order (sorted dict keys; the ``OptState`` fields
in order), a ``manifest.json`` with the step, the ``extra`` dict and each
leaf's name, file, shape and type name, written to a temporary directory
that is renamed into place; ``latest_step`` ignores half-written ones.

16-bit leaves: the reference saves an ``ml_dtypes.bfloat16`` array, whose
``.npy`` header says ``<V2`` (two raw bytes).  The port writes the same
bytes under the same header (the leaf's bits through a ``uint16`` view)
and names the type in the manifest (``bfloat16``); ``float16`` is numpy's
own ``<f2``.  Restoring reads the bits and reinterprets them by the
manifest's type, so a checkpoint of either package restores here for
every type, and for the same tree the port's files equal the
reference's byte for byte.  (The reference's own ``restore`` cannot read
a ``<V2`` leaf back: numpy has no cast from raw bytes to bfloat16.)

Sharded state (DTensor leaves, ``distributed.sharding``): every rank calls
``save``, and rank 0 gathers one leaf at a time to its host and writes it
before the next: each rank that holds a distinct shard sends it to rank 0,
which copies it into the whole leaf on the host (``_gathered``).  No rank
holds more than its own shards and, on rank 0, one more shard on the
device; the files are those of the same tree unsharded.  ``restore(...,
shardings=...)`` lays each leaf out on the current mesh, which may differ
from the one that saved it (the reference's elastic restore).
"""
from __future__ import annotations

import itertools
import json
import os
import shutil

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.distributed import sharding as shd
from repro_torch.train.optimizer import OptState

# the manifest's type names of the tensors a training state holds (the
# parameters' types of the configs, the float32 moments, the int32 step)
_TYPE_NAMES = {torch.float32: "float32", torch.bfloat16: "bfloat16",
               torch.float16: "float16", torch.int32: "int32"}
_BY_NAME = {v: k for k, v in _TYPE_NAMES.items()}
# the types numpy holds only as raw bytes (the reference's header for
# them); their bits travel as int16
_RAW = {torch.bfloat16: "<V2"}


def _flatten_with_names(tree, path=()):
    """[(name, leaf)] in the reference's order, names as its
    ``tree_flatten_with_path`` keys joined by '/' (an ``OptState`` field
    as ``.step``, ``.mu``, ``.nu``)."""
    if isinstance(tree, OptState):
        return [x for f in tree._fields
                for x in _flatten_with_names(getattr(tree, f),
                                             path + ("." + f,))]
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _flatten_with_names(tree[k], path + (str(k),))]
    return [("/".join(path), tree)]


def _unflatten_like(tree, leaves):
    """``tree``'s structure with ``leaves`` (an iterator) in its order."""
    if isinstance(tree, OptState):
        return OptState(*(_unflatten_like(getattr(tree, f), leaves)
                          for f in tree._fields))
    if isinstance(tree, dict):
        return {k: _unflatten_like(tree[k], leaves) for k in sorted(tree)}
    return next(leaves)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu().contiguous()
    return t.view(torch.int16).numpy() if t.dtype in _RAW else t.numpy()


def _save_npy(path: str, t: torch.Tensor) -> None:
    arr = _to_numpy(t)
    if t.dtype not in _RAW:
        np.save(path, arr)
        return
    # np.save's header for the raw two bytes the reference writes
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(
            f, {"descr": _RAW[t.dtype], "fortran_order": False,
                "shape": tuple(arr.shape)})
        arr.tofile(f)


def save(ckpt_dir: str, step: int, params, opt_state,
         extra: dict | None = None) -> str:
    named = _flatten_with_names({"params": params, "opt": opt_state})
    if not any(shd.is_dtensor(leaf) for _, leaf in named):
        return _write(ckpt_dir, step, named, extra)
    # a generator: each leaf is gathered as _write reaches it
    gathered = ((n, _gathered(leaf)) for n, leaf in named)
    if dist.get_rank() == 0:
        _write(ckpt_dir, step, gathered, extra)
    else:
        for _ in gathered:
            pass
    dist.barrier()
    return os.path.join(ckpt_dir, f"step_{step:08d}")


def _gathered(leaf: torch.Tensor):
    """A leaf whole on rank 0's host (None on the other ranks).  For a
    DTensor, the rank at coordinate 0 of every axis the leaf is replicated
    over sends its shard to rank 0, one rank after another, and rank 0
    copies each into its place in the whole."""
    me = dist.get_rank()
    if not shd.is_dtensor(leaf):
        return leaf.detach().cpu() if me == 0 else None
    ranks, places = leaf.device_mesh.mesh, leaf.placements
    local = leaf.to_local().detach().contiguous()
    whole = torch.empty(leaf.shape, dtype=leaf.dtype) if me == 0 else None
    buf = torch.empty_like(local) if me == 0 else None
    for coord in itertools.product(*map(range, ranks.shape)):
        if any(c and not p.is_shard() for c, p in zip(coord, places)):
            continue                 # a replica of a shard already taken
        src = int(ranks[coord])
        if me == 0:
            if src != 0:
                dist.recv(buf, src)
            part = local if src == 0 else buf
            whole[_shard_slices(leaf.shape, places, ranks.shape, coord)] \
                .copy_(part)
        elif me == src:
            dist.send(local, 0)
    return whole


def _shard_slices(shape, placements, mesh_shape, coord) -> tuple:
    """The slices of the whole that the rank at mesh ``coord`` holds (the
    mesh axes that shard one dim split it row-major in mesh order, as
    ``Sharding.local`` takes them)."""
    out = []
    for d, size in enumerate(shape):
        axes = [i for i, p in enumerate(placements) if p.is_shard(d)]
        k, n = 0, 1
        for i in axes:
            k, n = k * mesh_shape[i] + coord[i], n * mesh_shape[i]
        out.append(slice(k * (size // n), (k + 1) * (size // n)))
    return tuple(out)


def _write(ckpt_dir: str, step: int, named, extra) -> str:
    tmp = os.path.join(ckpt_dir, f".tmp_step_{step:08d}")
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "leaves": [], "extra": extra or {}}
    for i, (name, leaf) in enumerate(named):
        fn = f"leaf_{i:05d}.npy"
        _save_npy(os.path.join(tmp, fn), leaf)
        manifest["leaves"].append({"name": name, "file": fn,
                                   "shape": list(leaf.shape),
                                   "dtype": _TYPE_NAMES[leaf.dtype]})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)  # atomic publish
    return final


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for d in os.listdir(ckpt_dir):
        if d.startswith("step_") and os.path.exists(
                os.path.join(ckpt_dir, d, "manifest.json")):
            steps.append(int(d.split("_")[1]))
    return max(steps) if steps else None


def _load_leaf(path: str, meta: dict) -> torch.Tensor:
    """A leaf's tensor on the host, in the manifest's type."""
    arr = np.load(path)
    dtype = _BY_NAME[meta["dtype"]]
    if dtype in _RAW:
        return torch.from_numpy(arr.view(np.int16)).view(dtype)
    return torch.from_numpy(arr)


def restore(ckpt_dir: str, step: int, like_params, like_opt, device=None,
            shardings=None):
    """Restore into the structure of (like_params, like_opt): each leaf in
    its like's type, on ``device`` (default: its like's; meta tensors as
    likes give the structure without holding a second copy), laid out by
    ``shardings`` (``{"params": ..., "opt": ...}`` of ``Sharding``) where
    given.  Returns (params, opt_state, manifest)."""
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    tree = {"params": like_params, "opt": like_opt}
    named = _flatten_with_names(tree)
    if len(named) != len(manifest["leaves"]):
        raise ValueError(f"checkpoint {d}: {len(manifest['leaves'])} "
                         f"leaves, the tree has {len(named)}")
    out = []
    sh = ([s for _, s in _flatten_with_names(shardings)]
          if shardings is not None else [None] * len(named))
    for meta, (name, like), s in zip(manifest["leaves"], named, sh):
        t = _load_leaf(os.path.join(d, meta["file"]), meta)
        if list(t.shape) != list(like.shape):
            raise ValueError(f"checkpoint leaf {meta['name']}: shape "
                             f"{list(t.shape)}, the tree's {name} has "
                             f"{list(like.shape)}")
        t = t.to(device=like.device if device is None else device,
                 dtype=like.dtype)
        out.append(t if s is None else s.place(t))
    restored = _unflatten_like(tree, iter(out))
    return restored["params"], restored["opt"], manifest
