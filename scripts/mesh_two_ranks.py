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
- ``train_full``: qwen2.5-3b at full width (d_model 2,048, 16 heads, 2
  kv heads of 128, d_ff 11,008, the whole vocabulary) cut to
  ``TRAIN_LAYERS`` layers, in float32: ``TRAIN_STEPS`` train steps of
  ``TRAIN_B`` x ``TRAIN_S`` tokens from one state through
  ``trainstep.build_train_step`` (tensor-parallel, the residual split over
  the sequence, the vocab-parallel lookup and cross-entropy);
- ``mamba_full``: mamba2-130m whole (24 layers, d_model 768, 24 SSD heads
  of 64, state 128), in float32: a prefill of ``MAMBA_B`` x
  ``MAMBA_PROMPT`` tokens, ``MAMBA_DECODES`` decode steps, and
  ``TRAIN_STEPS`` train steps of ``MAMBA_B`` x ``MAMBA_TRAIN_S`` tokens,
  the SSD heads split over "model";
- ``moe``: granite's MoE on the expert-parallel branch (4 experts, 2 a
  rank, the all-to-all over "model");
- ``pipeline``: a two-stage ``pipeline_apply`` of 4 microbatches (the
  ring hand-off by send / recv).

The serve jobs count the attention kernels' launches in their steps
(flash attention in the prefill, decoding's split and combine kernels in
the decode steps), the train jobs flash attention's, its backward's and
the embedding gradient's segment sum's in theirs, each counted around the
mesh steps alone; each rank's parameter bytes (its shards) and peak memory
in them.  The train jobs hold their mesh steps to the same steps on one
rank in the same process after them (``held_to_one_rank``: the loss and
gradient norm of each step, the parameters and first moments after the
last, the logits and caches of the serve calls, each rank's shards
against the one-rank tensors' slices), at the reference's bars
(``TRAIN_BARS``).  Each rank saves the job's results to
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
        "train_full": ("all_gather_into_tensor", "all_reduce"),
        "mamba_full": ("all_gather_into_tensor", "all_reduce"),
        "moe": ("all_to_all_single", "all_reduce"),
        "pipeline": ("send/recv", "all_reduce")}
TIMEOUT_S = 180           # the gloo group's: a rank whose peer died raises
LLAMA_SMOKE = dict(cache_dtype="float32")
# the full-width job: llama3-8b's widths, depth cut, float32
FULL_LAYERS, FULL_B, FULL_PROMPT, FULL_STEPS = 2, 4, 64, 8
FULL = dict(num_layers=FULL_LAYERS, dtype="float32", cache_dtype="float32")
FULL_MAX_SEQ = FULL_PROMPT + FULL_STEPS
TRAIN_JOBS = ("train_full", "mamba_full")
# the train jobs: qwen2.5-3b's widths, depth cut, and mamba2-130m whole,
# float32, two steps from one state
TRAIN_LAYERS, TRAIN_B, TRAIN_S, TRAIN_STEPS = 2, 2, 1024, 2
TRAIN_FULL = dict(num_layers=TRAIN_LAYERS, dtype="float32")
MAMBA_FULL = dict(dtype="float32")
MAMBA_B, MAMBA_PROMPT, MAMBA_DECODES, MAMBA_TRAIN_S = 2, 256, 8, 512
# tests/test_torch_distributed.py's bars: the loss (absolute), the
# gradient norm (relative), the parameters (rtol, atol), the first moment
# (of each leaf's largest magnitude), logits, caches
TRAIN_BARS = dict(loss=5e-3, grad_norm=1e-4, param_rtol=2e-2,
                  param_atol=2e-3, mu=1e-4, logits=3e-4, cache=1e-5)
# the jobs whose bars are also read against the float32 floor of their
# scale (``_train_job``): mamba2-130m whole from its own init has logits
# in the hundreds (its tied table is drawn at scale 1.0), where two valid
# float32 orders of the same sums differ by more than the absolute bars
FLOORED = ("mamba_full",)


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
    import faulthandler
    faulthandler.enable()          # a crash in a collective names its line
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
        elif job in ("train_full", "mamba_full"):
            _train_job(torch, shd, mesh, dev, job, res)
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
    from repro_torch.kernels import flash_attention_bwd as fab
    from repro_torch.kernels import segment_sum as ss
    return {"flash_attention": fa.flash_attention.launches,
            "decode_attention": da.decode_attention.launches,
            "decode_attention_combine": da.decode_attention.combine_launches,
            "flash_attention_bwd": fab.flash_attention_bwd.launches,
            "segment_sum": ss.segment_sum.launches}


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


def train_job_inputs(torch, device, job, init_device=None):
    """(model, params, the train steps' batches, the prompt, the decode
    steps' tokens) of a train job, seeded, on ``device``; the prompt and
    decode tokens None for ``train_full``.  The weights are drawn on
    ``init_device`` (default ``device``; a generator draws other numbers on
    another device type)."""
    from repro_torch.configs import get_config
    from repro_torch.models import build
    if job == "train_full":
        model = build(get_config("qwen2.5-3b").scaled(**TRAIN_FULL))
        B, S = TRAIN_B, TRAIN_S
    else:
        model = build(get_config("mamba2-130m").scaled(**MAMBA_FULL))
        B, S = MAMBA_B, MAMBA_TRAIN_S
    V = model.cfg.vocab_size
    g = torch.Generator().manual_seed(2)
    draw = lambda *shape: torch.randint(0, V, shape, generator=g,
                                        dtype=torch.int32).to(device)
    batches = [{"tokens": draw(B, S), "labels": draw(B, S)}
               for _ in range(TRAIN_STEPS)]
    prompt = steps = None
    if job == "mamba_full":
        prompt = draw(MAMBA_B, MAMBA_PROMPT)
        steps = draw(MAMBA_DECODES, MAMBA_B, 1)
    params = model.init(torch.Generator(
        device=init_device or device).manual_seed(0))
    if init_device is not None:
        params = _to(torch, params, device)
    return model, params, batches, prompt, steps


def train_job_steps(torch, shd, job, dev, mesh, init_device=None):
    """A train job's calls through the step builders on ``mesh`` (None:
    one rank), from ``train_job_inputs``: the serve calls first
    where there is a prompt (each call's logits, the cache after the
    last), then the train steps from zero moments.  Returns {"metrics":
    [(loss, grad_norm)], "params", "mu", "logits", "cache",
    "param_bytes", "peak_bytes"}, on a mesh each tensor a DTensor; the
    peak is the card's from the placed state to the last step (0 on the
    CPU)."""
    from repro_torch.configs.base import InputShape
    from repro_torch.train import optimizer as opt
    from repro_torch.train import trainstep
    model, params, batches, prompt, steps = train_job_inputs(
        torch, dev, job, init_device)
    B, S = batches[0]["tokens"].shape
    fn, in_sh, _, _ = trainstep.build_train_step(
        model, InputShape("t", S, B, "train"), mesh, opt_cfg=opt.OptConfig(),
        microbatches=1)
    state = opt.init(params)
    if mesh is not None:                 # the whole tensors freed here
        params = shd.place_tree(params, in_sh[0])
        state = shd.place_tree(state, in_sh[1])
    out = {"logits": [], "cache": {},
           "param_bytes": _param_bytes(shd, params)}
    _reset_peak(torch, params)
    if prompt is not None:
        Bp, P = prompt.shape
        pf = trainstep.build_prefill_step(model, InputShape(
            "p", P, Bp, "prefill"), mesh)[0]
        dec = trainstep.build_decode_step(model, InputShape(
            "d", P, Bp, "decode"), mesh)[0]
        logits, cache = pf(params, {"tokens": prompt})
        out["logits"].append(logits)
        for t in range(len(steps)):
            logits, cache = dec(params, cache, steps[t], P + t)
            out["logits"].append(logits)
        out["cache"] = cache
    out["metrics"] = []
    for b in batches:
        params, state, m = fn(params, state, b)
        out["metrics"].append((float(m["loss"]), float(m["grad_norm"])))
    out["params"], out["mu"] = params, state.mu
    out["peak_bytes"] = _peak(torch, params)
    return out


def _pairs(shd, tree, prefix=""):
    """(name, this rank's shard, its "model" dim or None) of a tree of
    DTensors; (name, tensor, None) of whole tensors."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _pairs(shd, tree[k], f"{prefix}{k}/")
        return
    if shd.is_dtensor(tree):
        from torch.distributed.tensor import Shard
        dims = [p.dim for p, a in zip(tree.placements,
                                      tree.device_mesh.mesh_dim_names)
                if a == "model" and isinstance(p, Shard)]
        yield prefix[:-1], tree.to_local(), dims[0] if dims else None
    else:
        yield prefix[:-1], tree, None


def held_to_one_rank(torch, shd, got, want, rank) -> dict:
    """Each bar's worst ratio (1 is the bar) of a run ``got`` against the
    one-rank run ``want`` (``train_job_steps``), on the host: a mesh run's
    shards against the slices of the one-rank tensors they hold, a whole
    run's tensors against the whole."""
    b = TRAIN_BARS

    def host(t):
        return shd.local(t).float().cpu()

    def part(w, d):
        return host(w if d is None else w.chunk(2, dim=d)[rank])

    def worst(got_tree, want_tree, err):
        return max(float(err(host(a), part(w, d))) for (_, a, d), (_, w, _)
                   in zip(_pairs(shd, got_tree), _pairs(shd, want_tree)))

    got_m, want_m = got["metrics"], want["metrics"]
    r = {"loss": max(abs(a[0] - w[0]) for a, w in zip(got_m, want_m))
         / b["loss"],
         "grad_norm": max(abs(a[1] - w[1]) / abs(w[1])
                          for a, w in zip(got_m, want_m)) / b["grad_norm"],
         "params": worst(got["params"], want["params"], lambda a, w: (
             (a - w).abs() / (b["param_atol"] + b["param_rtol"] * w.abs()))
             .max()),
         "mu": worst(got["mu"], want["mu"], lambda a, w: (a - w).abs().max()
                     / (b["mu"] * w.abs().max().clamp_min(1e-30)))}
    if got["logits"]:
        r["logits"] = max(float((host(a) - part(
            w, -1 if shd.is_dtensor(a) else None)).abs().max())
            for a, w in zip(got["logits"], want["logits"])) / b["logits"]
        r["cache"] = worst(got["cache"], want["cache"],
                           lambda a, w: (a - w).abs().max()) / b["cache"]
    return r


def largest(torch, shd, run) -> dict:
    """The largest magnitude of a run's logits and of each cache leaf."""
    out = {"logits": max(float(shd.local(t).abs().max())
                         for t in run["logits"])} if run["logits"] else {}
    out.update({n: float(shd.local(t).abs().max())
                for n, t in run["cache"].items()})
    return out


def _train_job(torch, shd, mesh, dev, job, res):
    """A train job on this rank's shards, then on one rank in this process
    from the same seeded inputs (``held_to_one_rank``): the worst ratio of
    each bar, the steps' metrics, this rank's parameter bytes, its peak
    memory and the kernels' launches in the mesh calls.  For the jobs of
    ``FLOORED`` rank 0 also runs the one-rank calls on the host and holds
    them to the card's one-rank calls the same way (``floor``): the
    float32 spread of two valid orders of the same sums, at the job's
    scale."""
    before = _launches()
    got = train_job_steps(torch, shd, job, dev, mesh)
    res["launches"] = _since(before)
    res["peak_bytes"] = got["peak_bytes"]
    res["param_bytes"] = got["param_bytes"]
    res["metrics"] = got["metrics"]
    want = train_job_steps(torch, shd, job, dev, None)
    res["one_metrics"] = want["metrics"]
    res["largest"] = largest(torch, shd, want)
    res["worst"] = held_to_one_rank(torch, shd, got, want,
                                    mesh.coord("model"))
    if job in FLOORED and dev.type == "cuda" and mesh.coord("model") == 0:
        host = train_job_steps(torch, shd, job, torch.device("cpu"), None,
                               init_device=dev)
        res["floor"] = held_to_one_rank(torch, shd, host, want, 0)
        res["host_metrics"] = host["metrics"]


def _moe(shd, M, get_config, mesh, x, res):
    cfg = get_config("granite-moe-3b-a800m").smoke()
    with shd.use_mesh(mesh):
        out, aux = M.moe_fwd(x["moe"], x["moe_h"], cfg)
    res["moe"] = (out.cpu(), aux.cpu())


if __name__ == "__main__":
    raise SystemExit(main(sys.argv))
