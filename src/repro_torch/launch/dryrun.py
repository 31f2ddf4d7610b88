"""Multi-pod dry run: trace every (arch x shape x mesh) cell's per-device
program without a device.

The port of ``repro/launch/dryrun.py``.  The reference lowers and compiles
each cell against 512 fake XLA devices; the port runs the cell's train,
prefill or decode step (``train/trainstep.py``) once on meta tensors
(shapes and types, no storage) as rank 0 of a ``fake`` process group of
256 or 512 ranks, the production mesh (``launch.mesh``), under the op
counter (``core/op_analysis.py``): the per-device FLOPs, HBM bytes and
collective bytes for the roofline (``core/roofline.py``, H100 peaks).  The
fake group is this process's default group, set up before any mesh, as the
reference sets ``XLA_FLAGS`` before it imports JAX; so the dry run is its
own process.  On meta tensors the kernel wrappers take their plain routes,
so the count is the plain formula's, as the reference's HLO counts its
plain attention.  A decode cell decodes at the last position (every cache
row read).

Memory per device: the sharded state the step takes (``argument_bytes``:
this rank's shards of the parameters, moments and batch or cache) plus the
most the step's results held at once (``temp_bytes``, the counter's
``peak_bytes``); the donated arguments are written in place
(``alias_bytes``, as the reference's ``donate_argnums``).  ``fits_80GB``
checks ``hbm_used_bytes`` against ``roofline.Chip.hbm_bytes`` (the
reference's ``fits_16GB`` against its chip's 16 GB).  The record has the
reference's keys otherwise; ``lower_s`` is the traced step's wall time and
``compile_s`` 0 (nothing compiles), and the XLA cost-analysis keys are
absent.  Records are appended to ``results/dryrun_torch.jsonl``
(``repro_torch.roofline_report`` renders them).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-8b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--mesh single|multi|both]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2.5-3b \\
      --shape train_4k --mesh one --batch 2 --seq 4096
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback

import torch
import torch.utils._pytree as pytree

from repro_torch.configs import SHAPES, get_config, iter_cells
from repro_torch.configs.base import InputShape
from repro_torch.core import op_analysis, roofline
from repro_torch.distributed import sharding as shd
from repro_torch.launch.mesh import make_compat_mesh, make_production_mesh
from repro_torch.models import api as mapi
from repro_torch.train import trainstep

RESULTS = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "results")
# the meshes by name: (shape, axes, label)
MESHES = {"single": ((16, 16), ("data", "model"), "16x16"),
          "multi": ((2, 16, 16), ("pod", "data", "model"), "2x16x16"),
          "one": ((1, 1), ("data", "model"), "1x1")}


def init_fake(world: int) -> None:
    """This process as rank 0 of a fake group of ``world`` ranks."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def _placed_nbytes(tree) -> int:
    """This rank's bytes of the tensors in ``tree`` (DTensors: their
    shards)."""
    return sum(shd.local(t).numel() * t.element_size()
               for t in pytree.tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def _builder(model, shape, mesh, micro=None):
    """(step, args, donated argument indices)."""
    if shape.kind == "train":
        fn, in_sh, _, donate = trainstep.build_train_step(
            model, shape, mesh, microbatches=micro)
        structs = model.param_structs()
        args = (shd.place_tree(structs, in_sh[0]),
                shd.place_tree(trainstep.opt_structs(structs), in_sh[1]),
                shd.place_tree(mapi.input_specs(model.cfg, shape),
                               in_sh[2]))
    elif shape.kind == "prefill":
        fn, in_sh, _, donate = trainstep.build_prefill_step(model, shape,
                                                            mesh)
        args = (shd.place_tree(model.param_structs(), in_sh[0]),
                shd.place_tree(mapi.input_specs(model.cfg, shape),
                               in_sh[1]))
    else:
        fn, in_sh, _, donate = trainstep.build_decode_step(model, shape,
                                                           mesh)
        cache, tokens, _ = trainstep.decode_inputs(model, shape)
        args = (shd.place_tree(model.param_structs(), in_sh[0]),
                shd.place_tree(cache, in_sh[1]),
                in_sh[2].place(tokens), shape.seq_len - 1)
    return fn, args, donate


def run_cell(arch: str, shape: InputShape, mesh_name: str,
             verbose: bool = True, micro=None, overrides=None,
             tag: str = "") -> dict:
    cfg = get_config(arch)
    if overrides:
        cfg = cfg.scaled(**overrides)
    dims, axes, label = MESHES[mesh_name]
    mesh = (make_production_mesh(multi_pod=mesh_name == "multi")
            if mesh_name != "one" else make_compat_mesh(dims, axes))
    chips = mesh.size()
    model = mapi.build(cfg)
    fn, args, donate = _builder(model, shape, mesh, micro=micro)
    arg_bytes = _placed_nbytes(args)
    alias_bytes = _placed_nbytes([args[i] for i in donate])

    counter = op_analysis.OpCounter()
    t0 = time.time()
    with counter:
        out = fn(*args)
    t_trace = time.time() - t0
    a = op_analysis.analyze(counter)
    out_bytes = _placed_nbytes(out)
    mf = roofline.model_flops(cfg, shape)
    rl = roofline.Roofline(flops=a["flops"], hbm_bytes=a["hbm_bytes"],
                           ici_bytes=a["ici_bytes"], model_flops=mf,
                           chips=chips)
    hbm_used = arg_bytes + out_bytes + counter.peak_bytes - alias_bytes
    rec = {
        "arch": arch, "shape": shape.name, "tag": tag, "mesh": label,
        "chips": chips, "kind": shape.kind,
        "global_batch": shape.global_batch, "seq_len": shape.seq_len,
        "lower_s": round(t_trace, 2), "compile_s": 0.0,
        "per_device": {
            "argument_bytes": arg_bytes,
            "output_bytes": out_bytes,
            "temp_bytes": counter.peak_bytes,
            "alias_bytes": alias_bytes,
            "hbm_used_bytes": hbm_used,
            "fits_80GB": bool(hbm_used < roofline.H100.hbm_bytes),
            "flops": a["flops"],
            "hbm_bytes_accessed": a["hbm_bytes"],
            "ici_bytes": a["ici_bytes"],
            "ici_by_op": a["by_op"],
            "static_collectives": a["static_collective_count"],
        },
        "model_flops": mf,
        "roofline": rl.row(),
    }
    if verbose:
        print(f"[{arch} x {shape.name} x {label}] traced={t_trace:.1f}s "
              f"hbm={hbm_used / 2**30:.2f}GiB "
              f"fits={rec['per_device']['fits_80GB']} "
              f"flops={a['flops']:.4e} ici={a['ici_bytes']:.3e}B "
              f"bound={rl.bound} frac={rl.mfu_bound:.3f}")
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="both",
                    choices=("single", "multi", "both", "one"))
    ap.add_argument("--micro", type=int, default=None)
    ap.add_argument("--batch", type=int, default=None,
                    help="the shape's global batch instead of its own")
    ap.add_argument("--seq", type=int, default=None,
                    help="the shape's sequence length instead of its own")
    ap.add_argument("--ssm-chunk", type=int, default=None)
    ap.add_argument("--attn-chunk", type=int, default=None)
    ap.add_argument("--cache-dtype", default=None)
    ap.add_argument("--tag", default="")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=os.path.join(RESULTS,
                                                  "dryrun_torch.jsonl"))
    args = ap.parse_args(argv)

    meshes = {"single": ["single"], "multi": ["multi"],
              "both": ["single", "multi"], "one": ["one"]}[args.mesh]
    init_fake(max(math.prod(MESHES[m][0]) for m in meshes))
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)

    cells = []
    if args.all:
        for cfg, shape, ok, why in iter_cells():
            if ok:
                cells.append((cfg.name, shape))
            else:
                print(f"SKIP {cfg.name} x {shape.name}: {why}")
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        shape = SHAPES[args.shape]
        if args.batch or args.seq:
            b = args.batch or shape.global_batch
            s = args.seq or shape.seq_len
            shape = InputShape(f"{shape.kind}_b{b}_s{s}", s, b, shape.kind)
        cells = [(args.arch, shape)]

    if args.attn_chunk:
        from repro_torch.models import layers as _L
        _L.ATTN_CHUNK = args.attn_chunk
    overrides = {}
    if args.ssm_chunk:
        overrides["ssm_chunk"] = args.ssm_chunk
    if args.cache_dtype:
        overrides["cache_dtype"] = args.cache_dtype
    failures = 0
    with open(args.out, "a") as f:
        for arch, shape in cells:
            for m in meshes:
                try:
                    rec = run_cell(arch, shape, m, micro=args.micro,
                                   overrides=overrides, tag=args.tag)
                    f.write(json.dumps(rec) + "\n")
                    f.flush()
                except Exception:
                    failures += 1
                    print(f"FAILED {arch} x {shape.name} mesh={m}")
                    traceback.print_exc()
    print(f"done; {failures} failures")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
