#!/usr/bin/env python3
"""One rank of ``chip_smoke.py``'s two-rank mesh check: two processes on
one card under gloo.

    python3 scripts/mesh_two_ranks.py RANK DIR DEVICE JOB

NCCL refuses two ranks on one device, so the two ranks join a gloo group
(a file store in DIR) and compute on DEVICE (``cuda:0`` on the card,
``cpu`` for a rehearsal).  A JOB is one pair of processes: a collective of
the mesh path tried alone on a small tensor of DEVICE (``PROBES``: gloo
runs some on a CUDA tensor, refuses some, and some end the process), or
one path on the
mesh (data 1, model 2) at ``.smoke()`` widths:

- ``decode``: llama3-8b's decode step over a cache whose sequence is
  sharded over "model", the decoded position in the first shard (the
  second shard holds no valid row: trap 1) and in the second, from the
  seeded inputs of ``inputs(device)``;
- ``moe``: granite's MoE on the expert-parallel branch (4 experts, 2 a
  rank, the all-to-all over "model");
- ``pipeline``: a two-stage ``pipeline_apply`` of 4 microbatches (the
  ring hand-off by send / recv).

Each rank saves the job's results to ``DIR/rank{RANK}.pt``;
``chip_smoke.py`` runs every job at once, each in its own DIR, and holds
each path that ran against the one-rank results on the card, naming the
collectives (``USES``) that keep a path that failed on the CPU tests.
"""
from __future__ import annotations

import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
DECODE_PREFILLS = (8, 20)             # max_seq 32: shard 0, shard 1
# the collectives of the mesh path, each tried alone, and those each path
# issues: a path that fails is put down to the backend only where one of
# its collectives failed alone
PROBES = ("all_reduce", "all_gather_into_tensor", "reduce_scatter_tensor",
          "all_to_all_single", "send/recv")
USES = {"decode": ("all_gather_into_tensor",),
        "moe": ("all_to_all_single", "all_reduce"),
        "pipeline": ("send/recv", "all_reduce")}
TIMEOUT_S = 60            # the gloo group's: a rank whose peer died raises
LLAMA_SMOKE = dict(cache_dtype="float32")


def inputs(torch, device) -> dict:
    """The seeded inputs of every path (the same on every rank and in the
    one-rank comparison)."""
    from repro_torch.configs import get_config
    from repro_torch.models import build
    g = torch.Generator().manual_seed(0)
    cfg = get_config("llama3-8b").smoke().scaled(**LLAMA_SMOKE)
    llama = build(cfg)
    out = {"llama": llama.init(torch.Generator().manual_seed(0))}
    for S in DECODE_PREFILLS:
        out[f"toks{S}"] = torch.randint(0, cfg.vocab_size, (4, S),
                                        generator=g, dtype=torch.int32)
    gcfg = get_config("granite-moe-3b-a800m").smoke()
    D, E, F = gcfg.d_model, gcfg.num_experts, gcfg.d_ff
    out["moe"] = {"router": torch.randn(D, E, generator=g) * 0.1,
                  "w1": torch.randn(E, D, F, generator=g) * 0.05,
                  "w3": torch.randn(E, D, F, generator=g) * 0.05,
                  "w2": torch.randn(E, F, D, generator=g) * 0.05}
    out["moe_h"] = torch.randn(4, 8, D, generator=g)
    out["pipe_w"] = torch.randn(2, 16, 16, generator=g) * 0.5
    out["pipe_x"] = torch.randn(4, 8, 16, generator=g)
    return _to(torch, out, device)


def _to(torch, tree, device):
    if isinstance(tree, dict):
        return {k: _to(torch, v, device) for k, v in tree.items()}
    return tree.to(device)


def decode_cases(torch, model, params, x):
    """{S: (logits, cache_k, cache_v)} of the one-rank decode step at
    position S after a prefill of S tokens."""
    out = {}
    for S in DECODE_PREFILLS:
        logits, cache = model.prefill(params, {"tokens": x[f"toks{S}"]}, 32)
        tok = torch.argmax(logits[:, -1], -1)[:, None].to(torch.int32)
        logits, cache = model.decode_step(params, cache, tok, S)
        out[S] = (logits, cache["k"], cache["v"])
    return out


def _probe(torch, dist, device, group, name) -> None:
    """One collective of the mesh path on a small tensor of ``device``."""
    me = dist.get_rank()
    x = torch.arange(4.0, device=device) + me
    if name == "all_reduce":
        dist.all_reduce(x.clone(), group=group)
    elif name == "all_gather_into_tensor":
        dist.all_gather_into_tensor(torch.empty(8, device=device), x,
                                    group=group)
    elif name == "reduce_scatter_tensor":
        dist.reduce_scatter_tensor(torch.empty(2, device=device), x,
                                   group=group)
    elif name == "all_to_all_single":
        dist.all_to_all_single(torch.empty(4, device=device), x, group=group)
    else:                                          # send/recv
        for w in dist.batch_isend_irecv([
                dist.P2POp(dist.isend, x, 1 - me, group),
                dist.P2POp(dist.irecv, torch.empty(4, device=device), 1 - me,
                           group)]):
            w.wait()
    torch.cuda.synchronize() if x.is_cuda else None


def main(argv) -> int:
    rank, tmp, device, job = int(argv[1]), argv[2], argv[3], argv[4]
    sys.path.insert(0, str(ROOT / "src"))
    import datetime
    import torch
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method="file://" + os.path.join(
        tmp, "store"), rank=rank, world_size=2,
        timeout=datetime.timedelta(seconds=TIMEOUT_S))
    try:
        from repro_torch.configs import get_config
        from repro_torch.distributed import sharding as shd
        from repro_torch.distributed.pipeline import pipeline_apply
        from repro_torch.launch.mesh import make_compat_mesh
        from repro_torch.models import build
        from repro_torch.models import moe as M
        mesh = make_compat_mesh((1, 2), ("data", "model"))
        dev = torch.device(device)
        res = {}
        if job in PROBES:
            _probe(torch, dist, dev, mesh.group("model"), job)
        else:
            x = inputs(torch, dev)
            if job == "decode":
                _decode(torch, shd, build, get_config, mesh, x, res)
            elif job == "moe":
                _moe(shd, M, get_config, mesh, x, res)
            else:
                res["pipeline"] = pipeline_apply(
                    lambda p, h: torch.tanh(h @ p["w"]), {"w": x["pipe_w"]},
                    x["pipe_x"], make_compat_mesh((2,), ("pod",)),
                    stages=2).cpu()
        torch.save(res, os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()
    return 0


def _decode(torch, shd, build, get_config, mesh, x, res):
    """The decode step on this rank's shards: the stacked layers' weight
    shards (gathered a layer at a time by ``fsdp_gather``), the other
    weights whole (what the step's ``_live`` gives), the cache's rows of
    the sequence."""
    from repro_torch.models.layers import tree_map
    from repro_torch.train import trainstep
    model = build(get_config("llama3-8b").smoke().scaled(**LLAMA_SMOKE))
    live = tree_map(lambda t, lg, s: s.local(t) if lg[0] == "layers" else t,
                    x["llama"], model.param_logical(),
                    trainstep.param_shardings(model, mesh))
    rows = shd.Sharding(mesh, (None, None, "model"))
    for S in DECODE_PREFILLS:
        logits, cache = model.prefill(x["llama"], {"tokens": x[f"toks{S}"]},
                                      32)
        tok = torch.argmax(logits[:, -1], -1)[:, None].to(torch.int32)
        cache = {n: rows.local(c).clone() for n, c in cache.items()}
        with shd.use_mesh(mesh, ("data",), kv_sharded=True):
            logits, cache = model.decode_step(live, cache, tok, S)
        res[f"decode{S}"] = (logits.cpu(), cache["k"].cpu(),
                             cache["v"].cpu())


def _moe(shd, M, get_config, mesh, x, res):
    cfg = get_config("granite-moe-3b-a800m").smoke()
    with shd.use_mesh(mesh):
        out, aux = M.moe_fwd(x["moe"], x["moe_h"], cfg)
    res["moe"] = (out.cpu(), aux.cpu())


if __name__ == "__main__":
    raise SystemExit(main(sys.argv))
