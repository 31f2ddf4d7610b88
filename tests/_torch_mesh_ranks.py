"""Runs a case of the port's mesh path in gloo ranks on the CPU, one
process a rank, for the ``test_torch_*`` mesh tests.

``run(case, world, tmp, **kw)`` starts ``world`` processes of this file
(``python tests/_torch_mesh_ranks.py CASE RANK WORLD DIR KW``) that join a
gloo group through a file store in ``tmp`` (no network port), run
``CASES[case](rank, world, **kw)`` and save its dict of tensors with
``torch.save``; it returns each rank's dict.  The workers import no JAX:
their inputs come from ``.npz`` files the tests write (the reference's
oracles and the seeded inputs), named by ``kw``.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
TIMEOUT_S = 300


def run(case: str, world: int, tmp, **kw) -> list:
    import torch
    tmp = str(tmp)
    store = os.path.join(tmp, f"store_{case}_{world}")
    if os.path.exists(store):
        os.remove(store)
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep
               + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), case, str(r),
         str(world), tmp, json.dumps(kw)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT_S))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, (so, se)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} of {case}: {so}\n{se[-4000:]}"
    return [torch.load(os.path.join(tmp, f"{case}_{r}.pt"))
            for r in range(world)]


def flat(tree, prefix="") -> dict:
    """A nested dict of arrays as {"a/b": array}."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(flat(tree[k], f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: np.asarray(tree)}


def unflat(d: dict, prefix: str = "") -> dict:
    """The nested dict of the names under ``prefix`` of a flat dict."""
    out = {}
    for name, v in d.items():
        if not name.startswith(prefix):
            continue
        parts = name[len(prefix):].split("/")
        node = out
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return out


# ---------------------------------------------------------------------------
# the cases (in the rank processes)
# ---------------------------------------------------------------------------

def _mesh(shape, axes):
    from repro_torch.launch.mesh import make_compat_mesh
    return make_compat_mesh(shape, axes)


def case_moe(rank, world, npz, arch, d_ff, mesh, inputs):
    import torch
    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding as shd
    from repro_torch.models import moe as M
    cfg = get_config(arch).smoke().scaled(d_ff=d_ff)
    d = np.load(npz)
    p = {k: torch.from_numpy(d[f"{arch}/p/{k}"])
         for k in ("router", "w1", "w3", "w2")}
    out = {}
    m = _mesh(tuple(mesh), ("data", "model"))
    for name in inputs:
        h = torch.from_numpy(d[f"{arch}/h/{name}"])
        local, _ = M.moe_fwd(p, h, cfg)
        with shd.use_mesh(m):
            sharded, aux = M.moe_fwd(p, h, cfg)
        out[f"{name}/sharded"] = sharded
        out[f"{name}/local"] = local
        out[f"{name}/aux"] = aux
    return out


def case_decode(rank, world, npz, prefills):
    import torch
    from repro_torch import interop
    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.distributed import sharding as shd
    from repro_torch.models import build
    from repro_torch.train import trainstep
    cfg = get_config("llama3-8b").smoke().scaled(cache_dtype="float32")
    d = dict(np.load(npz))
    mesh = _mesh((2, 2), ("data", "model"))
    params = interop.model_params_from_numpy(
        cfg, unflat(d, "params/"), device="cpu", mesh=mesh)
    model = build(cfg)
    fn, (_, c_sh, _, _), _, _ = trainstep.build_decode_step(
        model, InputShape("d", 32, 4, "decode"), mesh)
    out = {}
    for S in prefills:
        cache = {n: c_sh[n].place(torch.from_numpy(d[f"{S}/cache/{n}"]))
                 for n in ("k", "v")}
        tok = torch.from_numpy(d[f"{S}/tok"])
        logits, cache = fn(params, cache, tok, S)
        out[f"{S}/logits"] = shd.full(logits)
        for n in ("k", "v"):
            out[f"{S}/cache/{n}"] = shd.full(cache[n])
    return out


def case_train(rank, world, npz):
    import torch
    from repro_torch import interop
    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.distributed import sharding as shd
    from repro_torch.models import build
    from repro_torch.models.layers import tree_map
    from repro_torch.train import trainstep
    cfg = get_config("qwen2.5-3b").smoke()
    d = dict(np.load(npz))
    mesh = _mesh((2, 2), ("data", "model"))
    model = build(cfg)
    shape = InputShape("tiny", 16, 8, "train")
    fn, (p_sh, o_sh, b_sh), _, _ = trainstep.build_train_step(
        model, shape, mesh, microbatches=2)
    tree = unflat(d, "params/")
    params = interop.model_params_from_numpy(cfg, tree, device="cpu",
                                             mesh=mesh)
    zeros = tree_map(lambda a: np.zeros(np.shape(a), np.float32), tree)
    state = interop.opt_state_from_numpy(0, zeros, zeros, device="cpu",
                                         shardings=o_sh)
    batch = {k: b_sh[k].place(torch.from_numpy(d[f"batch/{k}"]))
             for k in ("tokens", "labels")}
    params, state, m = fn(params, state, batch)
    out = {f"params/{name}": shd.full(t) for name, t in _named(params)}
    out["loss"] = m["loss"]
    out["grad_norm"] = m["grad_norm"]
    out.update({f"mu/{name}": shd.full(t) for name, t in _named(state.mu)})
    return out


def _named(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _named(tree[k], f"{prefix}{k}/")
    else:
        yield prefix[:-1], tree


def case_pipeline(rank, world, npz):
    import torch
    from repro_torch.distributed.pipeline import pipeline_apply
    d = np.load(npz)
    mesh = _mesh((2,), ("pod",))
    fn_stage = lambda p, x: torch.tanh(x @ p["w"])
    got = pipeline_apply(fn_stage, {"w": torch.from_numpy(d["w"])},
                         torch.from_numpy(d["x"]), mesh, stages=2)
    return {"out": got}


def _state(npz, arch, mesh):
    """The parameters and optimizer state of an ``.npz`` (``params/``,
    ``mu/``, ``nu/``, ``step``), laid out on ``mesh``."""
    from repro_torch import interop
    from repro_torch.configs import get_config
    from repro_torch.models import build
    from repro_torch.train import trainstep
    cfg = get_config(arch).smoke()
    d = dict(np.load(npz))
    params = interop.model_params_from_numpy(cfg, unflat(d, "params/"),
                                             device="cpu", mesh=mesh)
    state = interop.opt_state_from_numpy(
        int(d["step"]), unflat(d, "mu/"), unflat(d, "nu/"), device="cpu",
        shardings=trainstep.opt_shardings(build(cfg), mesh))
    return params, state


def case_ckpt(rank, world, npz, arch, save_mesh, restore_mesh, ckpt_dir):
    """Save on one mesh, restore on another: each leaf gathered whole."""
    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding as shd
    from repro_torch.models import build
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import trainstep
    params, state = _state(npz, arch, _mesh(tuple(save_mesh),
                                            ("data", "model")))
    ckpt.save(ckpt_dir, 3, params, state, extra={"loss": 1.5})
    mesh = _mesh(tuple(restore_mesh), ("data", "model"))
    model = build(get_config(arch).smoke())
    structs = model.param_structs()
    sh = {"params": trainstep.param_shardings(model, mesh),
          "opt": trainstep.opt_shardings(model, mesh)}
    p, s, _ = ckpt.restore(ckpt_dir, 3, structs,
                           trainstep.opt_structs(structs), device="cpu",
                           shardings=sh)
    out = {f"params/{n}": shd.full(t) for n, t in _named(p)}
    out.update({f"mu/{n}": shd.full(t) for n, t in _named(s.mu)})
    out["step"] = shd.full(s.step)
    # each restored shard is the slice of its sharding
    for (n, t), (_, x) in zip(_named(p), _named(sh["params"])):
        assert tuple(t.to_local().shape) == tuple(
            x.local(t.full_tensor()).shape), n
    return out


def case_loop(rank, world, arch, mesh, ckpt_dir, stop):
    """The loop under a mesh: to ``stop`` steps, then resumed to 4."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.models import build
    from repro_torch.train import loop
    from repro_torch.train import optimizer as opt
    m = _mesh(tuple(mesh), ("data", "model"))
    model = build(get_config(arch).smoke())
    losses = []
    for total in ((stop, 4) if stop else (4,)):
        st = loop.train(model, InputShape("t", 16, 4, "train"), m,
                        opt_cfg=opt.OptConfig(total_steps=4),
                        loop_cfg=loop.LoopConfig(total_steps=total,
                                                 ckpt_every=2,
                                                 ckpt_dir=ckpt_dir,
                                                 log_every=100),
                        data_seed=3, device="cpu")
        losses += st.losses
    return {"losses": torch.tensor(losses, dtype=torch.float64),
            "restarts": torch.tensor(st.restarts)}


def case_families(rank, world, archs, mesh):
    """Each family's prefill, two decode steps and a train step on
    ``mesh`` and on one device (this rank's own), from the same weights
    and inputs: {arch/what: (mesh, one device)}."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.data import pipeline as dpipe
    from repro_torch.distributed import sharding as shd
    from repro_torch.models import build
    from repro_torch.models.layers import tree_map
    from repro_torch.train import optimizer as opt
    from repro_torch.train import trainstep
    m = _mesh(tuple(mesh), ("data", "model"))
    out = {}
    for arch in archs:
        cfg = get_config(arch).smoke()
        model = build(cfg)
        B, S, max_seq = 2, 8, 16
        P = cfg.num_patches
        fresh = lambda: model.init(torch.Generator().manual_seed(0))
        g = torch.Generator().manual_seed(1)
        toks = torch.randint(0, cfg.vocab_size, (B, S - P), generator=g,
                             dtype=torch.int32)
        batch = {"tokens": toks,
                 **dpipe.extra_inputs(cfg, B, 0, 0, device="cpu")}
        pshape = InputShape("p", max_seq, B, "prefill")
        dshape = InputShape("d", max_seq, B, "decode")
        for name, mm in (("mesh", m), ("one", None)):
            params = fresh()
            pf, in_sh, _, _ = trainstep.build_prefill_step(model, pshape, mm)
            dec = trainstep.build_decode_step(model, dshape, mm)[0]
            if mm is not None:
                params = shd.place_tree(params, in_sh[0])
            logits, cache = pf(params, batch)
            res = [shd.full(logits)]
            tok = torch.argmax(shd.full(logits)[:, -1], -1)[:, None] \
                .to(torch.int32)
            for t in range(2):
                logits, cache = dec(params, cache, tok, S + t)
                res.append(shd.full(logits))
            res += [shd.full(c) for _, c in _named(cache)]
            out[f"{arch}/n_serve"] = torch.tensor(len(res))
            tshape = InputShape("t", S, B, "train")
            fn, in_sh, _, _ = trainstep.build_train_step(
                model, tshape, mm, microbatches=1)
            params = fresh()
            state = opt.init(params)
            tb = {"tokens": toks, "labels": toks,
                  **dpipe.extra_inputs(cfg, B, 0, 0, device="cpu")}
            if mm is not None:
                params = shd.place_tree(params, in_sh[0])
                state = shd.place_tree(state, in_sh[1])
            params, state, met = fn(params, state, tb)
            res += [met["loss"], met["grad_norm"]]
            res += [shd.full(t) for _, t in _named(params)]
            for i, r in enumerate(res):
                out[f"{arch}/{i}/{name}"] = r
    return out


def case_moe_train(rank, world, mesh, d_ff, aux_weight):
    """granite's smoke train step on ``mesh`` and on one device from the
    same weights and batch, the load-balance loss weighed by
    ``aux_weight``: the loss, the gradient norm and the first moments
    after the step, and the shapes of the expert weights the MoE's
    ``shard_map`` body was handed on the mesh."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.distributed import sharding as shd
    from repro_torch.models import build
    from repro_torch.models import moe as M
    from repro_torch.train import optimizer as opt
    from repro_torch.train import trainstep
    cfg = get_config("granite-moe-3b-a800m").smoke().scaled(d_ff=d_ff)
    model = build(cfg)
    M.loss_fn.__defaults__ = (aux_weight,)
    m = _mesh(tuple(mesh), ("data", "model"))
    toks = torch.randint(0, cfg.vocab_size, (4, 8), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(1))
    seen = []
    body = M._moe_sharded
    M._moe_sharded = lambda p, *a: seen.append(
        [tuple(p[n].shape) for n in ("w1", "w3", "w2")]) or body(p, *a)
    out = {}
    for name, mm in (("mesh", m), ("one", None)):
        fn, in_sh, _, _ = trainstep.build_train_step(
            model, InputShape("t", 8, 4, "train"), mm, microbatches=1)
        params = model.init(torch.Generator().manual_seed(0))
        state = opt.init(params)
        if mm is not None:
            params = shd.place_tree(params, in_sh[0])
            state = shd.place_tree(state, in_sh[1])
        params, state, met = fn(params, state,
                                {"tokens": toks, "labels": toks})
        out[f"{name}/loss"] = met["loss"]
        out[f"{name}/grad_norm"] = met["grad_norm"]
        out.update({f"{name}/mu/{n}": shd.full(t)
                    for n, t in _named(state.mu)})
    out["expert_shapes"] = torch.tensor(seen[0])
    out["moe_calls"] = torch.tensor(len(seen))
    return out


def case_tp(rank, world, npz, cases):
    """The serve steps under tensor parallelism, each case
    ``(name, arch, overrides, mesh, max_seq, positions)`` from the
    ``.npz``'s reference weights, tokens and prefill cache: the prefill's
    logits and cache, and a decode step at each position from the
    reference's prefill cache; with the shapes of the weights the layers
    were handed in the decode steps (``{name}/held/{leaf}``)."""
    import torch
    from repro_torch import interop
    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.distributed import sharding as shd
    from repro_torch.models import build
    from repro_torch.models import layers as L
    from repro_torch.train import trainstep
    d = dict(np.load(npz))
    held = {}

    def spy(fn, leaves):
        def wrapped(p, *a, **k):
            if shd.active_tp() is not None:
                held.update({n: tuple(p[n].shape) for n in leaves if n in p})
            return fn(p, *a, **k)
        return wrapped

    L.attention_decode = spy(L.attention_decode, ("wq", "wk", "wo"))
    L.mlp_fwd = spy(L.mlp_fwd, ("w1", "w2", "w3"))
    L.embed_fwd = spy(L.embed_fwd, ("embedding",))
    L.unembed_fwd = spy(L.unembed_fwd, ("unembed",))
    out = {}
    for name, arch, overrides, shape, max_seq, positions in cases:
        cfg = get_config(arch).smoke().scaled(**overrides)
        model = build(cfg)
        mesh = _mesh(tuple(shape), ("data", "model"))
        params = interop.model_params_from_numpy(
            cfg, unflat(d, f"{name}/params/"), device="cpu", mesh=mesh)
        toks = torch.from_numpy(d[f"{name}/toks"])
        B = toks.shape[0]
        pf = trainstep.build_prefill_step(
            model, InputShape("p", max_seq, B, "prefill"), mesh)[0]
        dec, (_, c_sh, _, _), _, _ = trainstep.build_decode_step(
            model, InputShape("d", max_seq, B, "decode"), mesh)
        logits, cache = pf(params, {"tokens": toks})
        out[f"{name}/prefill/logits"] = shd.full(logits)
        for n, c in cache.items():
            out[f"{name}/prefill/cache/{n}"] = shd.full(c)
        tok = torch.from_numpy(d[f"{name}/tok"])
        for pos in positions:
            held.clear()
            cache = {n: c_sh[n].place(torch.from_numpy(
                d[f"{name}/cache/{n}"])) for n in c_sh}
            logits, cache = dec(params, cache, tok, pos)
            out[f"{name}/{pos}/logits"] = shd.full(logits)
            for n, c in cache.items():
                out[f"{name}/{pos}/cache/{n}"] = shd.full(c)
        for n, s in held.items():
            out[f"{name}/held/{n}"] = torch.tensor(s)
    return out


def case_tp_train(rank, world, npz, cases):
    """The train step under tensor parallelism, each case ``(name, arch,
    overrides, mesh, (B, S), serve)`` from the ``.npz``'s reference
    weights and batch: one step from zero moments (the parameters, first
    moments, loss and gradient norm after it), with the shapes of the
    weights and of the residual the layers were handed in it
    (``{name}/held/...``); where ``serve`` is a list of positions also the
    prefill of the batch's tokens and a decode step at each position from
    the reference's prefill cache."""
    import torch
    from repro_torch import interop
    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.distributed import sharding as shd
    from repro_torch.models import build
    from repro_torch.models import layers as L
    from repro_torch.models import ssm as SSM
    from repro_torch.models.layers import tree_map
    from repro_torch.train import trainstep
    d = dict(np.load(npz))
    held = {}

    def spy(mod, fn_name, leaves, arg=1):
        fn = getattr(mod, fn_name)

        def wrapped(p, *a, **k):
            if shd.active_tp() is not None and torch.is_grad_enabled():
                held.update({n: tuple(p[n].shape) for n in leaves if n in p})
                held[f"{fn_name}/h"] = tuple(a[arg - 1].shape)
            return fn(p, *a, **k)
        setattr(mod, fn_name, wrapped)

    spy(L, "attention_fwd", ("wq", "wk", "wo"))
    spy(L, "mlp_fwd", ("w1", "w2", "w3"))
    spy(L, "embed_fwd", ("embedding",))
    spy(SSM, "ssd_block_fwd", ("wz", "wx", "wdt", "wo", "gate_norm"))
    out = {}
    for name, arch, overrides, shape, (B, S), serve in cases:
        cfg = get_config(arch).smoke().scaled(**overrides)
        model = build(cfg)
        mesh = _mesh(tuple(shape), ("data", "model"))
        tree = unflat(d, f"{name}/params/")
        fn, (p_sh, o_sh, b_sh), _, _ = trainstep.build_train_step(
            model, InputShape("t", S, B, "train"), mesh, microbatches=1)
        params = interop.model_params_from_numpy(cfg, tree, device="cpu",
                                                 mesh=mesh)
        zeros = tree_map(lambda a: np.zeros(np.shape(a), np.float32), tree)
        state = interop.opt_state_from_numpy(0, zeros, zeros, device="cpu",
                                             shardings=o_sh)
        batch = {k: b_sh[k].place(torch.from_numpy(d[f"{name}/batch/{k}"]))
                 for k in ("tokens", "labels")}
        held.clear()
        params, state, m = fn(params, state, batch)
        out.update({f"{name}/params/{n}": shd.full(t)
                    for n, t in _named(params)})
        out.update({f"{name}/mu/{n}": shd.full(t)
                    for n, t in _named(state.mu)})
        out[f"{name}/loss"] = m["loss"]
        out[f"{name}/grad_norm"] = m["grad_norm"]
        for n, s in held.items():
            out[f"{name}/held/{n}"] = torch.tensor(s)
        if not serve:
            continue
        params = interop.model_params_from_numpy(cfg, tree, device="cpu",
                                                 mesh=mesh)
        toks = torch.from_numpy(d[f"{name}/batch/tokens"])
        pf = trainstep.build_prefill_step(
            model, InputShape("p", S, B, "prefill"), mesh)[0]
        dec, (_, c_sh, _, _), _, _ = trainstep.build_decode_step(
            model, InputShape("d", S, B, "decode"), mesh)
        logits, cache = pf(params, {"tokens": toks})
        out[f"{name}/prefill/logits"] = shd.full(logits)
        for n, c in cache.items():
            out[f"{name}/prefill/cache/{n}"] = shd.full(c)
        tok = torch.from_numpy(d[f"{name}/tok"])
        for pos in serve:
            cache = {n: c_sh[n].place(torch.from_numpy(
                d[f"{name}/cache/{n}"])) for n in c_sh}
            logits, cache = dec(params, cache, tok, pos)
            out[f"{name}/{pos}/logits"] = shd.full(logits)
            for n, c in cache.items():
                out[f"{name}/{pos}/cache/{n}"] = shd.full(c)
    return out


CASES = {"tp": case_tp, "tp_train": case_tp_train,
         "families": case_families, "moe_train": case_moe_train, "moe": case_moe, "decode": case_decode, "train": case_train,
         "pipeline": case_pipeline, "ckpt": case_ckpt, "loop": case_loop}


def _main(argv) -> int:
    import torch
    import torch.distributed as dist
    case, rank, world, tmp, kw = argv[1], int(argv[2]), int(argv[3]), \
        argv[4], json.loads(argv[5])
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method="file://" + os.path.join(
            tmp, f"store_{case}_{world}"), rank=rank, world_size=world)
    try:
        out = CASES[case](rank, world, **kw)
        torch.save({k: v.detach().clone() for k, v in out.items()},
                   os.path.join(tmp, f"{case}_{rank}.pt"))
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.path.insert(0, SRC)
    raise SystemExit(_main(sys.argv))
