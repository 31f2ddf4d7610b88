"""Prefill-only serving: closed-loop waves through ``ServeEngine``.

Set-up draws the weights, builds ``ServeEngine(model, params, batch_size,
max_seq)`` over a thin proxy of the model (it counts the positions handed
to ``model.prefill`` and keeps each call's last-position logits), and runs
one set-up wave holding the mix's longest prompt.  In the window each wave's
requests are submitted together and ``run()`` drains them; the next wave
is submitted when it returns.  A request is timed from its submission to
the return of the ``run()`` that delivered it, which in prefill-only
traffic is its time to first token.  Waves are submitted until
``--seconds`` have passed; the window closes when the last one returns.
``serve_tokens_per_s`` is the prompt tokens (unpadded) and generated tokens
of every request of the window over the window's length;
``request_latency_p95_s`` is the 95th percentile (nearest rank) over all
of them.

The check: a sample of the delivered waves, drawn from the seed and always
holding the wave of the longest delivered prompt, is run through the plain
reference (``bench/reference/model.py``): each wave's prompts left-padded
with token 0 to its longest, as the engine pads them, and the last
position's logits.  ``logit_err`` is the largest gap between the
program's logits and the reference's over a request's row, over the row's
root mean square; ``token_gap`` the largest amount by which a served
token's reference logit lies below the reference's best.
"""
from __future__ import annotations

import math
import sys

import numpy as np
import torch

from yardstick import checks, counts, timer, traffic, weights as W
from yardstick import device as D
from yardstick.main import Outcome, Record, free


class Proxy:
    """The model, as ``ServeEngine`` sees it, with the prefill's positions
    counted and its last-position logits kept while ``recording``."""

    def __init__(self, model):
        self.model = model
        self.cfg = model.cfg
        self.recording = False
        self.logits: list = []
        self.positions = 0

    def prefill(self, params, batch, max_seq):
        logits, cache = self.model.prefill(params, batch, max_seq)
        if self.recording:
            self.positions += batch["tokens"].numel()
            self.logits.append(logits)
        return logits, cache

    def decode_step(self, params, cache, tokens, pos):
        return self.model.decode_step(params, cache, tokens, pos)


def p95(values) -> float:
    """The 95th percentile by nearest rank."""
    v = sorted(values)
    return v[max(0, math.ceil(0.95 * len(v)) - 1)]


def run(r) -> Outcome:
    stages = timer.Stages(r.device, r.t_start)
    stages.mark("python, torch, harness, device")
    from repro_torch.configs.base import ModelConfig
    from repro_torch.models import api as mapi
    from repro_torch.serve.engine import Request, ServeEngine
    stages.mark("program imports")

    a, mix, dev = r.cell.config["program"], r.cell.traffic, r.device
    cfg = ModelConfig(**a)
    model = mapi.build(cfg)
    params = W.draw(a, r.seed, dev, cfg.torch_dtype)
    stages.mark("weights")
    proxy = Proxy(model)
    eng = ServeEngine(proxy, params, batch_size=mix["wave"],
                      max_seq=mix["max_seq"])
    V = a["vocab_size"]
    waves = traffic.window_waves(mix, r.seed, V)
    stages.mark("engine, traffic")
    uid = 0

    def one_wave(prompts):
        nonlocal uid
        reqs = [Request(uid + i, p, max_new_tokens=mix["new_tokens"])
                for i, p in enumerate(prompts)]
        uid += len(reqs)
        for q in reqs:
            eng.submit(q)
        eng.run()
        return reqs

    one_wave(traffic.wave_prompts(mix, r.seed, -1, V))
    eng.finished.clear()
    stages.mark("set-up wave")
    stages.report(sys.stderr)

    # ---- the window ----
    proxy.recording = True
    with timer.Window(dev, r.spans, r.trace,
                      D.smi if dev.type == "cuda" else dict) as win:
        setup_s = timer.now() - r.t_start
        t0 = timer.now()
        done = []           # (wave index, submitted, returned, requests)
        k = 0
        while timer.now() - t0 < r.seconds:
            t_sub = timer.now()
            reqs = one_wave(waves[k % len(waves)])
            done.append((k, t_sub - t0, timer.now() - t0, reqs))
            k += 1
    proxy.recording = False

    if len(proxy.logits) != len(done):
        raise RuntimeError(f"{len(proxy.logits)} prefill calls for "
                           f"{len(done)} waves: a wave is one prefill")
    print(f"window: {len(done)} waves in {done[-1][2]:.4f} s",
          file=sys.stderr)
    reqs = [q for w in done for q in w[3]]
    failed = sum(1 for q in reqs
                 if not q.done or len(q.out_tokens) != mix["new_tokens"])
    served = [sum(len(q.prompt) + len(q.out_tokens) for q in w[3])
              for w in done]
    lat = [w[2] - w[1] for w in done for _ in w[3]]
    L = a["num_layers"]
    all_lengths = [[len(q.prompt) for q in w[3]] for w in done]
    fwd = [counts.flash_fwd_call(a, n) for n in all_lengths]
    record = Record(a, win.trace, r.spans, counters={
        "prefill_positions": proxy.positions,
        "prefill_real_positions": sum(map(sum, all_lengths))}, work={
        "waves": len(done),
        "model_flops": sum(counts.prefill_flops(a, n) for n in all_lengths),
        "flash_fwd": (L * sum(f for f, _ in fwd), L * sum(b for _, b in fwd))})

    pick = checked_waves([[len(q.prompt) for q in w[3]] for w in done],
                         r.seed, mix["checked_waves"])
    sample = [([q.prompt for q in done[i][3]],
               [q.out_tokens[0] if q.out_tokens else -1 for q in done[i][3]],
               proxy.logits[done[i][0]][:, -1].float().cpu())
              for i in pick]
    e2e = {"serve_tokens_per_s": timer.rate(served, [w[2] for w in done]),
           "request_latency_p95_s": p95(lat), "setup_s": setup_s}
    del eng, proxy, params, model, waves, done, reqs
    free(dev)
    numbers = compare(sample, reference_logits(
        r, a, [prompts for prompts, _, _ in sample], cfg.torch_dtype))
    return Outcome(len(lat), failed, e2e, numbers, win.peak_bytes, record,
                   win.smi_before, win.smi_after)


def checked_waves(lengths: list[list[int]], seed: int, count: int) -> list[int]:
    """The waves the check compares, of waves with prompts of ``lengths``:
    the (first) wave of the longest prompt, then others in an order drawn
    from the seed, ``count`` in all."""
    longest = max(range(len(lengths)), key=lambda i: max(lengths[i]))
    rng = np.random.default_rng(np.random.SeedSequence([seed, 5]))
    rest = [int(i) for i in rng.permutation(len(lengths)) if i != longest]
    return [longest] + rest[:count - 1]


def left_padded(prompts, device) -> torch.Tensor:
    """[B, S] of the prompts left-padded with token 0 to the longest."""
    S = max(len(p) for p in prompts)
    out = np.zeros((len(prompts), S), np.int64)
    for i, p in enumerate(prompts):
        out[i, S - len(p):] = p
    return torch.from_numpy(out).to(device)


def reference_logits(r, a, waves, dtype, mode: str = "fp32") -> list:
    """The plain reference's last-position logits [B, V] (on the host) of
    each wave's prompts, left-padded as the engine pads them."""
    from reference import model as RM
    RM.no_tf32()
    dev = r.device
    t_ref = timer.now()
    tree = W.draw(a, r.seed, dev, dtype)
    out = [RM.last_logits(tree, left_padded(prompts, dev), a,
                          RM.Prec(mode)).cpu() for prompts in waves]
    del tree
    free(dev)
    print(f"reference ({mode}): {timer.now() - t_ref:.1f} s for "
          f"{sum(len(w) for w in waves)} requests in {len(waves)} waves "
          f"(longest prompt {max(len(p) for w in waves for p in w)})",
          file=sys.stderr)
    return out


def compare(sample, ref) -> dict:
    """The served side ([(prompts, served tokens, logits [B, V])]) against
    the reference's logits: widest readings over the requests,
    ``logit_err``, the largest gap over a request's row over the row's root
    mean square; ``kl``, the reference's distribution's divergence from the
    served one (nats); ``token_gap``, the amount by which a served token's
    reference logit lies below the reference's best; and ``kl_mean``, the
    mean over the requests of each one's divergence."""
    out = {"logit_err": 0.0, "kl": 0.0, "token_gap": 0.0}
    kls = []
    for (prompts, served, prog), q_all in zip(sample, ref):
        for i in range(len(prompts)):
            q, p = q_all[i].double(), prog[i].double()
            rms = float(q.pow(2).mean().sqrt())
            d = p - q
            t = served[i]
            lq, lp = torch.log_softmax(q, -1), torch.log_softmax(p, -1)
            got = {"logit_err": float(d.abs().max()) / rms,
                   "kl": float((lq.exp() * (lq - lp)).sum()),
                   "token_gap": (float(q.max() - q[t]) if 0 <= t < len(q)
                                 else float("inf"))}
            kls.append(got["kl"])
            for k, v in got.items():
                out[k] = checks.worst(out[k], v)
    out["kl_mean"] = sum(kls) / len(kls)
    top = sorted(kls, reverse=True)[:3]
    print(f"kl by request: mean {out['kl_mean']!r}, median "
          f"{sorted(kls)[len(kls) // 2]!r}, widest three {top}", file=sys.stderr)
    return out
