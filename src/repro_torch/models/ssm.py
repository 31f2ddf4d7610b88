"""Mamba-2 SSD (state-space duality) core: the chunked scan in plain PyTorch.

The port of ``repro/models/ssm.py:51`` (``_ssd_chunked``): quadratic,
attention-like work *within* a chunk and a linear state recurrence *across*
chunks (arXiv:2405.21060 §6), so nothing quadratic in S is ever formed.  It
is the oracle of the SSD scan kernel (``kernels/ssd_scan.py``) through
``kernels/ref.py:ssd_scan``, and the SSD core a Mamba-2 block reuses.

Two choices keep it usable at the suite's size (B 8, S 65,536, H 16, P 64,
N 128): the decay is masked *before* the exponential (above the diagonal
``seg_t - seg_u`` is positive and could overflow to ``inf``; ``inf * 0`` is
NaN), and the intra-chunk product contracts ``(C·Bᵀ) ∘ decay`` over the
chunk first, as the Pallas kernel does, instead of forming the 5-D
``[B, Q, Q, H, P]`` product a three-operand einsum can build (2.1 GB per
chunk at that size).
"""
from __future__ import annotations

import torch


def ssd_chunked(x, dt, A, Bm, Cm, D_skip, chunk: int):
    """SSD core.  x ``[B,S,H,P]``; dt ``[B,S,H]``; A ``[H]``; Bm/Cm
    ``[B,S,N]``; D_skip ``[H]``.

    Returns y ``[B,S,H,P]`` in x's type and the final state ``[B,H,P,N]``
    in float32.  Every input is widened to float32.  ``Q = min(chunk, S)``
    and ``S % Q`` must be 0.
    """
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    Q = min(chunk, S)
    if Q < 1 or S % Q:
        raise ValueError(f"ssd_chunked: S = {S} is not a multiple of the "
                         f"chunk length Q = min({chunk}, S)")
    nc = S // Q
    f32 = torch.float32
    dev = x.device

    dA = dt.to(f32) * A.to(f32)                               # [B,S,H] (negative)
    xd = x.to(f32) * dt.to(f32)[..., None]                    # dt-weighted input
    Bf, Cf = Bm.to(f32), Cm.to(f32)
    tri = torch.tril(torch.ones(Q, Q, dtype=torch.bool, device=dev))

    state = torch.zeros(Bsz, H, P, N, dtype=f32, device=dev)
    ys = []
    for c in range(nc):
        sl = slice(c * Q, (c + 1) * Q)
        xq, Bq, Cq = xd[:, sl], Bf[:, sl], Cf[:, sl]          # [B,Q,H,P], [B,Q,N]
        seg = torch.cumsum(dA[:, sl], dim=1)                  # [B,Q,H]
        # intra-chunk: scores[t,u] = (C_t.B_u) * exp(seg_t - seg_u) for u<=t
        diff = seg[:, :, None] - seg[:, None, :, :]           # [B,Q,Q,H]
        diff = diff.masked_fill(~tri[None, :, :, None], float("-inf"))
        decay = torch.exp(diff)                               # mask pre-exp
        cb = torch.einsum("btn,bun->btu", Cq, Bq)             # [B,Q,Q]
        w = cb[..., None] * decay                             # [B,Q,Q,H]
        y_intra = torch.einsum("btuh,buhp->bthp", w, xq)
        # contribution of the carried-in state: exp(seg_t) * C_t . state
        y_state = torch.einsum("btn,bhpn->bthp", Cq, state) \
            * torch.exp(seg)[..., None]
        # chunk end state: exp(seg_Q) * state + sum_u exp(seg_Q-seg_u) B_u x_u
        tot = seg[:, -1]                                      # [B,H]
        sdecay = torch.exp(tot[:, None] - seg)                # [B,Q,H]
        state = (torch.exp(tot)[:, :, None, None] * state
                 + torch.einsum("bun,buhp->bhpn", Bq,
                                xq * sdecay[..., None]))
        ys.append(y_intra + y_state)
    y = torch.cat(ys, dim=1)
    y = y + x.to(f32) * D_skip.to(f32)[None, None, :, None]
    return y.to(x.dtype), state
