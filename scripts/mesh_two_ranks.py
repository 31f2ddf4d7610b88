#!/usr/bin/env python3
"""One rank of ``chip_smoke.py``'s two-rank mesh check: two processes on
one card under gloo.

    python3 scripts/mesh_two_ranks.py RANK DIR DEVICE JOB

NCCL refuses two ranks on one device, so the two ranks join a gloo group
(a file store in DIR) and compute on DEVICE (``cuda:0`` on the card,
``cpu`` for a rehearsal), their mesh's DTensors on DEVICE's type.  A JOB is one pair of processes: a collective of
the mesh path tried alone on a small tensor of DEVICE (``PROBES``: gloo
runs some on a CUDA tensor, refuses some, and some end the process), or
one path on the
mesh (data 1, model 2) at ``.smoke()`` widths:

- ``decode``: llama3-8b's decode step (``trainstep.build_decode_step``,
  tensor-parallel: each rank its "model" shards of the dense weights) over
  a cache whose sequence is sharded over "model", the decoded position in
  the first shard (the second shard holds no valid row: trap 1) and in the
  second, from the seeded inputs of ``inputs(device)``;
- ``llama_full``: llama3-8b at full width (d_model 4,096, 32 heads, 8 kv
  heads, d_ff 14,336, the whole vocabulary) cut to ``FULL_LAYERS`` layers,
  in float32, through the step builders: a prefill of ``FULL_B`` x
  ``FULL_PROMPT`` tokens and ``FULL_STEPS`` decode steps of seeded tokens
  (``full_inputs``), held against the same steps on one rank
  (``full_one_rank``);
- ``moe``: granite's MoE on the expert-parallel branch (4 experts, 2 a
  rank, the all-to-all over "model");
- ``pipeline``: a two-stage ``pipeline_apply`` of 4 microbatches (the
  ring hand-off by send / recv).

The serve jobs count the attention kernels' launches in their steps
(flash attention in the prefill, decoding's split and combine kernels in
the decode steps) and each rank's parameter bytes (its shards) and peak
memory in them.  Each rank saves the job's results to
``DIR/rank{RANK}.pt``;
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
USES = {"decode": ("all_gather_into_tensor", "all_reduce"),
        "llama_full": ("all_gather_into_tensor", "all_reduce"),
        "moe": ("all_to_all_single", "all_reduce"),
        "pipeline": ("send/recv", "all_reduce")}
TIMEOUT_S = 60            # the gloo group's: a rank whose peer died raises
LLAMA_SMOKE = dict(cache_dtype="float32")
# the full-width job: llama3-8b's widths, depth cut, float32
FULL_LAYERS, FULL_B, FULL_PROMPT, FULL_STEPS = 2, 4, 64, 8
FULL = dict(num_layers=FULL_LAYERS, dtype="float32", cache_dtype="float32")
FULL_MAX_SEQ = FULL_PROMPT + FULL_STEPS


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


def full_inputs(torch, device):
    """(model, params, prompt tokens, the decode steps' tokens) of the
    full-width job, seeded, on ``device``."""
    from repro_torch.configs import get_config
    from repro_torch.models import build
    model = build(get_config("llama3-8b").scaled(**FULL))
    g = torch.Generator().manual_seed(1)
    V = model.cfg.vocab_size
    toks = torch.randint(0, V, (FULL_B, FULL_PROMPT), generator=g,
                         dtype=torch.int32)
    steps = torch.randint(0, V, (FULL_STEPS, FULL_B, 1), generator=g,
                          dtype=torch.int32)
    params = model.init(torch.Generator(device=device).manual_seed(0))
    return model, params, toks.to(device), steps.to(device)


def full_steps(torch, model, params, toks, steps, mesh):
    """The full-width job's prefill and decode steps through the step
    builders on ``mesh`` (None: one rank): every call's logits, stacked,
    and the cache after the last."""
    from repro_torch.configs.base import InputShape
    from repro_torch.train import trainstep
    pf = trainstep.build_prefill_step(model, InputShape(
        "p", FULL_MAX_SEQ, FULL_B, "prefill"), mesh)[0]
    dec = trainstep.build_decode_step(model, InputShape(
        "d", FULL_MAX_SEQ, FULL_B, "decode"), mesh)[0]
    logits, cache = pf(params, {"tokens": toks})
    out = [logits]
    for t in range(FULL_STEPS):
        logits, cache = dec(params, cache, steps[t], FULL_PROMPT + t)
        out.append(logits)
    return out, cache


def full_one_rank(torch, device):
    """The full-width job on one rank: (logits [calls, B, 1, V], cache)
    on the host."""
    model, params, toks, steps = full_inputs(torch, device)
    out, cache = full_steps(torch, model, params, toks, steps, None)
    return (torch.stack(out).cpu(),
            {n: c.cpu() for n, c in cache.items()})


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
        dev = torch.device(device)
        mesh = make_compat_mesh((1, 2), ("data", "model"),
                                device_type=dev.type)
        res = {}
        if job in PROBES:
            _probe(torch, dist, dev, mesh.group("model"), job)
        elif job == "llama_full":
            _llama_full(torch, shd, mesh, dev, res)
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


def _launches():
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    return {"flash_attention": fa.flash_attention.launches,
            "decode_attention": da.decode_attention.launches,
            "decode_attention_combine": da.decode_attention.combine_launches}


def _since(before: dict) -> dict:
    return {k: v - before[k] for k, v in _launches().items()}


def _param_bytes(shd, placed) -> int:
    from repro_torch.models.layers import tree_leaves
    return sum(shd.local(t).numel() * t.element_size()
               for t in tree_leaves(placed))


def _card(placed):
    from repro_torch.distributed import sharding as shd
    from repro_torch.models.layers import tree_leaves
    t = shd.local(tree_leaves(placed)[0])
    return t.device if t.is_cuda else None


def _reset_peak(torch, placed) -> None:
    """The card's peak counted from here (what is held now included)."""
    if _card(placed) is not None:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(_card(placed))


def _peak(torch, placed) -> int:
    """This process's peak bytes on the card since ``_reset_peak`` (0 on
    the CPU)."""
    dev = _card(placed)
    return torch.cuda.max_memory_allocated(dev) if dev is not None else 0


def _decode(torch, shd, build, get_config, mesh, x, res):
    """The decode step (``trainstep.build_decode_step``) on this rank's
    shards: its "model" shards of the dense weights (tensor parallelism),
    the cache's rows of the sequence; the prefill on one rank, whole.
    Results: this rank's slice of the logits' vocabulary and its rows of
    the cache."""
    from repro_torch.configs.base import InputShape
    from repro_torch.train import trainstep
    model = build(get_config("llama3-8b").smoke().scaled(**LLAMA_SMOKE))
    fn, (p_sh, c_sh, _, _), _, _ = trainstep.build_decode_step(
        model, InputShape("d", 32, 4, "decode"), mesh)
    placed = shd.place_tree(x["llama"], p_sh)
    res["param_bytes"] = _param_bytes(shd, placed)
    _reset_peak(torch, placed)
    launches = {k: 0 for k in _launches()}
    for S in DECODE_PREFILLS:
        logits, cache = model.prefill(x["llama"], {"tokens": x[f"toks{S}"]},
                                      32)
        tok = torch.argmax(logits[:, -1], -1)[:, None].to(torch.int32)
        cache = {n: c_sh[n].place(c) for n, c in cache.items()}
        before = _launches()
        logits, cache = fn(placed, cache, tok, S)
        launches = {k: launches[k] + v for k, v in _since(before).items()}
        res[f"decode{S}"] = tuple(t.to_local().cpu() for t in (
            logits, cache["k"], cache["v"]))
    res["launches"] = launches
    res["peak_bytes"] = _peak(torch, placed)


def _llama_full(torch, shd, mesh, dev, res):
    """The full-width job on this rank's shards (``full_steps`` on the
    mesh): this rank's slice of every call's logits, its rows of the
    cache, its parameter bytes and peak memory in the steps."""
    from repro_torch.train import trainstep
    model, params, toks, steps = full_inputs(torch, dev)
    placed = shd.place_tree(params, trainstep.param_shardings(model, mesh))
    del params
    res["param_bytes"] = _param_bytes(shd, placed)
    _reset_peak(torch, placed)
    before = _launches()
    out, cache = full_steps(torch, model, placed, toks, steps, mesh)
    res["launches"] = _since(before)
    res["logits"] = torch.stack([t.to_local() for t in out]).cpu()
    res["cache"] = {n: c.to_local().cpu() for n, c in cache.items()}
    res["peak_bytes"] = _peak(torch, placed)


def _moe(shd, M, get_config, mesh, x, res):
    cfg = get_config("granite-moe-3b-a800m").smoke()
    with shd.use_mesh(mesh):
        out, aux = M.moe_fwd(x["moe"], x["moe_h"], cfg)
    res["moe"] = (out.cpu(), aux.cpu())


if __name__ == "__main__":
    raise SystemExit(main(sys.argv))
