"""Batched serving engine: continuous-batching prefill/decode driver.

The port of ``repro/serve/engine.py``.  Requests queue up; the engine
prefills prompts into KV-cache slots, then decodes the batch in lock-step,
retiring each sequence as soon as it reaches its own token budget and
backfilling its slot from the queue (continuous batching at retire
granularity).  The round structure is the reference's: each round
re-prefills the active set (prompt plus the tokens generated so far),
left-padded with token 0 to the longest, dead slots padded with the first
prompt; decoding starts at ``pos = S`` (``S + num_patches`` for the VLM);
greedy argmax over the padded vocabulary.  The device is the parameters':
on the card the model's attention runs the port's flash-attention and
flash-decoding kernels.

The same retire-and-backfill structure drives the simulation service
(``repro_torch.serve.sim_service``).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.models import layers as L


@dataclass
class Request:
    uid: int
    prompt: np.ndarray          # [S] int32
    max_new_tokens: int = 16
    out_tokens: list = field(default_factory=list)
    done: bool = False


def params_device(params) -> torch.device:
    """The device the parameters live on (the first leaf's)."""
    return L.tree_leaves(params)[0].device


def _left_padded(prompts, device) -> torch.Tensor:
    """[B, S] int32 of the prompts left-padded with token 0."""
    S = max(len(p) for p in prompts)
    toks = np.zeros((len(prompts), S), np.int32)
    for i, p in enumerate(prompts):
        toks[i, S - len(p):] = p                  # left-pad
    return torch.from_numpy(toks).to(device)


def _greedy(logits) -> torch.Tensor:
    """[B, 1] int32 argmax of the last position's logits."""
    return torch.argmax(logits[:, -1], -1)[:, None].to(torch.int32)


def _start_pos(model, S: int) -> int:
    return S if model.cfg.family != "vlm" else S + model.cfg.num_patches


def serve_batch(model, params, prompts, max_new_tokens: int, max_seq: int,
                extra: dict | None = None) -> list[list[int]]:
    """Greedy batched generation."""
    toks = _left_padded(prompts, params_device(params))
    batch = {"tokens": toks}
    if extra:
        batch.update(extra)
    logits, cache = model.prefill(params, batch, max_seq)
    tok = _greedy(logits)
    outs = [[] for _ in prompts]
    pos = _start_pos(model, toks.shape[1])
    for t in range(max_new_tokens):
        for i, x in enumerate(tok[:, 0].tolist()):
            outs[i].append(x)
        if t == max_new_tokens - 1:
            break
        logits, cache = model.decode_step(params, cache, tok, pos + t)
        tok = _greedy(logits)
    return outs


class ServeEngine:
    """Continuous batching over the prefill/decode model API.

    ``run()`` keeps up to ``batch_size`` active slots.  A sequence retires
    the moment it reaches its *own* ``max_new_tokens`` and its slot is
    backfilled from the FIFO queue, so no slot ever decodes past its
    budget.

    Because ``decode_step`` advances all slots at one shared position, a
    backfill round re-prefills the active set (each prompt plus the tokens
    it has generated so far): prompt processing is a single batched pass,
    so a round costs one prefill + ``min(remaining budgets)`` decode steps.
    Dead slots (when fewer than ``batch_size`` sequences are active) are
    shape padding only; their outputs are never read.  ``decode_steps`` /
    ``prefill_rounds`` expose the work actually done.
    """

    def __init__(self, model, params, batch_size: int, max_seq: int,
                 extra: dict | None = None):
        self.model = model
        self.params = params
        self.B = batch_size
        self.max_seq = max_seq
        self.extra = extra
        self.queue: list[Request] = []
        self.finished: list[Request] = []
        self.decode_steps = 0
        self.prefill_rounds = 0
        self.device = params_device(params)

    def submit(self, req: Request):
        self.queue.append(req)

    def _retire(self, active: list[Request]) -> None:
        for r in [r for r in active
                  if len(r.out_tokens) >= r.max_new_tokens]:
            r.done = True
            self.finished.append(r)
            active.remove(r)

    def _round(self, active: list[Request]) -> None:
        """One continuous-batching round: prefill prompt+generated for every
        active slot, then decode until the first slot exhausts its budget."""
        prompts = [np.concatenate([np.asarray(r.prompt, np.int32),
                                   np.asarray(r.out_tokens, np.int32)])
                   for r in active]
        steps = min(r.max_new_tokens - len(r.out_tokens) for r in active)
        padded = prompts + [prompts[0]] * (self.B - len(prompts))
        toks = _left_padded(padded, self.device)
        batch = {"tokens": toks}
        if self.extra:
            batch.update(self.extra)
        logits, cache = self.model.prefill(self.params, batch, self.max_seq)
        self.prefill_rounds += 1
        tok = _greedy(logits)
        pos = _start_pos(self.model, toks.shape[1])
        for t in range(steps):
            got = tok[:, 0].tolist()
            for i, r in enumerate(active):
                r.out_tokens.append(got[i])
            if t == steps - 1:
                break
            logits, cache = self.model.decode_step(self.params, cache, tok,
                                                   pos + t)
            self.decode_steps += 1
            tok = _greedy(logits)

    def run(self) -> list[Request]:
        active: list[Request] = []
        while self.queue or active:
            while self.queue and len(active) < self.B:   # backfill FIFO
                active.append(self.queue.pop(0))
            self._retire(active)          # handles max_new_tokens == 0 too
            if not active:
                continue
            self._round(active)
            self._retire(active)
        return self.finished
