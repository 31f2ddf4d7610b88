"""Three training steps of the plain reference: the loss, its gradient
through every layer, and AdamW.

The loss is the mean next-token cross-entropy over the padded vocabulary
(plus 0.01 x the layers' mean load-balance term for a mixture of experts).
The gradient is taken layer by layer: a forward that keeps each block's
input, the head's gradient in blocks of rows, then each block recomputed
under autograd from its input, last to first, and the embedding's gradient
summed into the table.  AdamW is the program's formulas (written again
here): the gradient clipped to a global norm, the moments in float32, bias
corrections, decoupled weight decay, a linear warmup then a cosine decay;
the parameters are kept in the configuration's type between steps (each
step's float32 result rounded once), as the configuration states them.
"""
from __future__ import annotations

import math

import torch

from reference import model as M

AUX_WEIGHT = 0.01


def _leaf_paths(tree, prefix=()):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _leaf_paths(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _leaf(x):
    """A float32 copy of ``x`` that autograd records on."""
    return x.detach().to(torch.float32, copy=True).requires_grad_()


def loss_and_grads(tree, tokens, labels, a, prec, rows=1024):
    """(loss, grads): grads a tree of float32 tensors beside ``tree``."""
    eps = a.get("norm_eps", 1e-5)
    L = a["num_layers"]
    B, S = tokens.shape
    T = B * S
    moe = a.get("num_experts", 0) > 0
    saved = []
    with torch.no_grad():
        h = M.embed(tree, tokens)
        auxes = []
        for i in range(L):
            saved.append(h)
            h, aux = M.block(M.layer_params(tree["blocks"], i), h, a, prec)
            auxes.append(aux)
    out = {}
    hN = h.detach().requires_grad_()
    gn = _leaf(tree["final_norm"])
    tied = "unembed" not in tree["embed"]
    U = _leaf(tree["embed"]["embedding"] if tied else tree["embed"]["unembed"])
    flat_h = hN.reshape(T, -1)
    flat_y = labels.reshape(T).long()
    total = torch.zeros((), device=h.device)
    for r0 in range(0, T, rows):
        with torch.enable_grad():
            x = M.rmsnorm(flat_h[r0:r0 + rows], gn, eps)
            logits = prec.mm(x, U.T if tied else U)
            nll = torch.logsumexp(logits, -1) - logits.gather(
                1, flat_y[r0:r0 + rows, None])[:, 0]
            part = nll.sum() / T
            part.backward()
        total += part.detach()
    out[("final_norm",)] = gn.grad
    g_embed_head = U.grad if tied else None      # [V, D], the table's
    if not tied:
        out[("embed", "unembed")] = U.grad
    g = hN.grad
    del hN, gn, U
    blocks = {}
    for i in reversed(range(L)):
        x = saved[i].requires_grad_()
        lp_src = M.layer_params(tree["blocks"], i)
        leaves = [(p, _leaf(v)) for p, v in _leaf_paths(lp_src)]
        lp: dict = {}
        for p, v in leaves:
            d = lp
            for k in p[:-1]:
                d = d.setdefault(k, {})
            d[p[-1]] = v
        with torch.enable_grad():
            y, aux = M.block(lp, x, a, prec)
            if moe:
                torch.autograd.backward([y, aux],
                                        [g, torch.tensor(AUX_WEIGHT / L,
                                                         device=y.device)])
            else:
                y.backward(g)
        for p, v in leaves:
            if p not in blocks:
                blocks[p] = torch.empty((L,) + tuple(v.shape),
                                        dtype=torch.float32, device=v.device)
            blocks[p][i].copy_(v.grad)
        g = x.grad
        saved[i] = None
        del leaves, lp, y, aux, x
    for p, stacked in blocks.items():
        out[("blocks",) + p] = stacked
    table = torch.zeros_like(M.f32(tree["embed"]["embedding"]))
    table.index_add_(0, tokens.reshape(-1).long(), g.reshape(T, -1))
    if g_embed_head is not None:
        table += g_embed_head
    out[("embed", "embedding")] = table
    loss = total
    if moe:
        loss = loss + AUX_WEIGHT * torch.stack(auxes).mean()
    tree_g: dict = {}
    for p, v in out.items():
        d = tree_g
        for k in p[:-1]:
            d = d.setdefault(k, {})
        d[p[-1]] = v
    return loss, tree_g


def lr_at(o: dict, step: int) -> float:
    """Linear warmup to ``lr``, then a cosine decay to ``min_lr_frac`` of
    it at ``total_steps``."""
    if step < o["warmup_steps"]:
        return o["lr"] * step / max(o["warmup_steps"], 1)
    prog = (step - o["warmup_steps"]) / max(o["total_steps"]
                                            - o["warmup_steps"], 1)
    prog = min(max(prog, 0.0), 1.0)
    return o["lr"] * (o["min_lr_frac"] + (1 - o["min_lr_frac"]) * 0.5
                      * (1 + math.cos(math.pi * prog)))


# the most elements updated at once (a float32 temporary of 256 MB)
CHUNK = 1 << 26


def adamw_step(tree, grads, mu, nu, step: int, o: dict, on_leaf=None):
    """One AdamW step in place, leaf by leaf in slices of the leading axis;
    each leaf's gradient is dropped from ``grads`` once used.
    ``on_leaf(path, g)`` sees each leaf's gradient as the optimizer takes
    it (clipped)."""
    paths = [p for p, _ in _leaf_paths(tree)]
    gnorm = math.sqrt(sum(float(torch.linalg.vector_norm(_get(grads, p))) ** 2
                          for p in paths))
    scale = min(o["clip_norm"] / max(gnorm, 1e-9), 1.0)
    lr = lr_at(o, step)
    b1c = 1 - o["b1"] ** step
    b2c = 1 - o["b2"] ** step
    with torch.no_grad():
        for p in paths:
            parent = grads
            for k in p[:-1]:
                parent = parent[k]
            g_all = parent.pop(p[-1])
            g_all.mul_(scale)
            if on_leaf is not None:
                on_leaf(p, g_all)
            w_all, m_all, v_all = _get(tree, p), _get(mu, p), _get(nu, p)
            rows = w_all.shape[0] if w_all.ndim else 1
            per = max(1, min(rows, CHUNK // max(1, w_all.numel() // rows)))
            for r0 in range(0, rows, per):
                sl = (lambda t: t[r0:r0 + per]) if w_all.ndim else (lambda t: t)
                g, w, m, v = sl(g_all), sl(w_all), sl(m_all), sl(v_all)
                m.mul_(o["b1"]).add_(g, alpha=1 - o["b1"])
                v.mul_(o["b2"]).addcmul_(g, g, value=1 - o["b2"])
                w32 = M.f32(w)
                delta = (m / b1c) / (torch.sqrt(v / b2c) + o["eps"]) \
                    + o["weight_decay"] * w32
                w.copy_((w32 - lr * delta).to(w.dtype))
            del g_all


def zeros_like_tree(tree):
    return {k: (zeros_like_tree(v) if isinstance(v, dict)
                else torch.zeros(v.shape, dtype=torch.float32,
                                 device=v.device))
            for k, v in tree.items()}


def train(tree, batches, a, o: dict, prec, steps: int = 3, on_leaf=None):
    """``steps`` steps from ``tree`` (updated in place) on ``batches``
    [(tokens, labels)]; returns the losses.  ``on_leaf(step, path, g)``
    sees each leaf's clipped gradient."""
    mu, nu = zeros_like_tree(tree), zeros_like_tree(tree)
    losses = []
    for k in range(steps):
        tokens, labels = batches[k]
        loss, grads = loss_and_grads(tree, tokens, labels, a, prec)
        losses.append(float(loss))
        adamw_step(tree, grads, mu, nu, k + 1, o,
                   None if on_leaf is None
                   else (lambda p, g, s=k + 1: on_leaf(s, p, g)))
        del grads
    return losses
