"""Training: the program's one-device train step over the mix's batches.

Set-up builds the step (``trainstep.build_train_step``) with the model,
the benchmark's weights and AdamW's state, and drives it through the mix's
first ``checked_steps`` batches: those steps are warm-up and the checked
steps at once.  The window then hands the same step the next batches in
turn, with no wait on the device inside it (each step's end is marked by a
CUDA event), until ``--seconds`` have passed on the host's clock; the
window closes when the last step handed in has ended on the device.
``train_tokens_per_s`` is the tokens of every step of the window over the
window's length on the device's clock.

The check: the plain reference (``bench/reference/train.py``) runs the
checked steps from the same weights on the same batches, and the run
compares each step's loss (``loss_gap``), each leaf's norm of the first
gradient as the optimizer took it (``grad_gap``; the program's from its
first moment after step 1, divided by ``1 - b1``), and each leaf's norm of
the parameters' change over the checked steps (``change_gap``; the
program's read before the window's first step).
"""
from __future__ import annotations

import math
import sys

import torch

from yardstick import checks, counts, timer, traffic, weights as W
from yardstick import device as D
from yardstick.main import Outcome, Record, free


def _layout_matches(params, structs, path=()):
    if isinstance(structs, dict):
        if not isinstance(params, dict) or sorted(params) != sorted(structs):
            raise RuntimeError(f"parameter tree differs from the program's "
                               f"at {'.'.join(path) or 'root'}")
        for k in structs:
            _layout_matches(params[k], structs[k], path + (k,))
    elif tuple(params.shape) != tuple(structs.shape):
        raise RuntimeError(f"{'.'.join(path)}: {tuple(params.shape)} where "
                           f"the program has {tuple(structs.shape)}")


def _leaves(tree, prefix=()):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _leaves(tree[k], prefix + (k,))
        else:
            yield prefix + (k,), tree[k]


def change_norms(a, tree, seed, device, dtype) -> dict:
    """Each leaf's norm of ``tree`` less the weights drawn from ``seed``."""
    out = {}
    for i, spec in enumerate(W.leaf_specs(a)):
        p0 = W.draw_leaf(spec, i, seed, device, dtype)
        out.update(checks.slice_norms(
            spec[0], W.get(tree, spec[0]).float() - p0.float()))
        del p0
    return out


def run(r) -> Outcome:
    stages = timer.Stages(r.device, r.t_start)
    stages.mark("python, torch, harness, device")
    from repro_torch.configs.base import InputShape, ModelConfig
    from repro_torch.models import api as mapi
    from repro_torch.train import optimizer as opt
    from repro_torch.train import trainstep
    stages.mark("program imports")

    a, mix, dev = r.cell.config["program"], r.cell.traffic, r.device
    cfg = ModelConfig(**a)
    model = mapi.build(cfg)
    B, S = mix["batch"], mix["seq"]
    params = W.draw(a, r.seed, dev, cfg.torch_dtype)
    stages.mark("weights")
    _layout_matches(params, model.param_structs())
    ocfg = opt.OptConfig(**mix["optimizer"])
    state = opt.init(params)
    step = trainstep.build_train_step(
        model, InputShape("bench", S, B, "train"), None, opt_cfg=ocfg,
        microbatches=mix.get("microbatches", 1))[0]
    host = traffic.train_batches(mix, r.seed, a["vocab_size"])
    batches = [{"tokens": torch.from_numpy(t).to(dev),
                "labels": torch.from_numpy(y).to(dev)} for t, y in host]
    stages.mark("optimizer state, step, batches")
    n_checked = mix["checked_steps"]
    losses, grad1 = [], {}
    for i in range(n_checked):
        params, state, m = step(params, state, batches[i])
        losses.append(m["loss"])
        stages.mark(f"step {i + 1}")
        if i == 0:
            for p, mu in _leaves(state.mu):
                grad1.update({k: v / (1 - ocfg.b1) for k, v in
                              checks.slice_norms(p, mu).items()})
    change = change_norms(a, params, r.seed, dev, cfg.torch_dtype)
    stages.mark("norms")
    stages.report(sys.stderr)

    # ---- the window ----
    with timer.Window(dev, r.spans, r.trace,
                      D.smi if dev.type == "cuda" else dict) as win:
        setup_s = timer.now() - r.t_start
        marks = timer.Marks(dev)
        t0 = timer.now()
        k, window_losses = n_checked, []
        while timer.now() - t0 < r.seconds:
            params, state, m = step(params, state, batches[k % len(batches)])
            marks.mark()
            window_losses.append(m["loss"])
            k += 1
    ends = marks.seconds()
    print(f"window: {len(ends)} steps in {ends[-1]:.4f} s; ends (s) "
          f"{[round(e, 4) for e in ends]}", file=sys.stderr)
    wl = torch.stack(window_losses).tolist()
    failed = sum(1 for x in wl if not math.isfinite(x))
    prog_losses = torch.stack(losses).tolist()
    grad1, change = checks.as_floats(grad1), checks.as_floats(change)
    record = Record(a, win.trace, r.spans, work={
        "steps": len(ends), "tokens": B * S,
        "step_flops": counts.train_step_flops(a, B, S),
        "flash_fwd_call": counts.flash_fwd_call(a, [S] * B),
        "flash_bwd_call": counts.flash_bwd_call(a, [S] * B)})
    del step, params, state, batches, m, window_losses, losses, marks
    free(dev)
    numbers = compare((prog_losses, grad1, change), reference_readings(
        r, a, mix, host[:n_checked], cfg.torch_dtype))
    e2e = {"train_tokens_per_s": timer.rate([B * S] * len(ends), ends),
           "setup_s": setup_s}
    return Outcome(len(ends), failed, e2e, numbers, win.peak_bytes, record,
                   win.smi_before, win.smi_after)


def reference_readings(r, a, mix, host_batches, dtype, mode: str = "fp32",
                       half: bool = False):
    """(losses, first-gradient norms, change norms) of the plain reference's
    checked steps (``mode`` ``fp32``, or the control's ``fp8``) from the
    seed's weights; ``half`` leaves out the second half of each batch (a
    fault the check has to catch)."""
    from reference import model as RM
    from reference import train as RT
    RM.no_tf32()
    dev = r.device
    tree = W.draw(a, r.seed, dev, dtype)
    cut = (lambda x: x[:x.shape[0] // 2]) if half else (lambda x: x)
    batches = [(cut(torch.from_numpy(t)).to(dev), cut(torch.from_numpy(y)).to(dev))
               for t, y in host_batches]
    grad1 = {}

    def on_leaf(s, p, g):
        if s == 1:
            grad1.update(checks.slice_norms(p, g))

    t_ref = timer.now()
    losses = RT.train(tree, batches, a, mix["optimizer"], RM.Prec(mode),
                      steps=len(batches), on_leaf=on_leaf)
    change = checks.as_floats(change_norms(a, tree, r.seed, dev, dtype))
    grad1 = checks.as_floats(grad1)
    del tree
    free(dev)
    print(f"reference ({mode}{', half batch' if half else ''}): "
          f"{timer.now() - t_ref:.1f} s", file=sys.stderr)
    return losses, grad1, change


def compare(prog, ref) -> dict:
    """The numbers compared: the program's readings (losses, first-gradient
    norms, change norms) against the reference's."""
    (pl, pg, pc), (rl, rg, rc) = prog, ref
    grad_gap, g_leaf = checks.leaf_gap(pg, rg, rg)
    change_gap, c_leaf = checks.leaf_gap(pc, rc, rg)
    print(f"losses: {pl} against {rl}; worst leaves: gradient {g_leaf} "
          f"({pg.get(g_leaf)} against {rg.get(g_leaf)}), change {c_leaf} "
          f"({pc.get(c_leaf)} against {rc.get(c_leaf)})", file=sys.stderr)
    return {"loss_gap": checks.rel_gaps(pl, rl), "grad_gap": grad_gap,
            "change_gap": change_gap}
