"""Plain PyTorch versions of the suite's data-parallel kernels.

The port of ``repro/kernels/ref.py``: each function is the semantic ground
truth its hand-written kernel must reproduce, with the reference's operand
order, ``where``/``clip`` order and float32 arithmetic.  Every entry is
carried: Black-Scholes (``repro/kernels/ref.py:19-27``),
Jacobi-2D and pathfinder (``:29-45``), the swaptions, streamcluster,
canneal and particle-filter kernels (``:48-106``), flash attention and
flash decoding (``:109-126``) and the SSD scan (``:131-137``).
"""
from __future__ import annotations

import contextlib

import torch

SQRT2 = 1.4142135623730951

# Moro (1995) rational approximation of the inverse cumulative normal, as
# used by PARSEC swaptions' CumNormalInv.
MORO_A = (2.50662823884, -18.61500062529, 41.39119773534, -25.44106049637)
MORO_B = (-8.47351093090, 23.08336743743, -21.06224101826, 3.13082909833)
MORO_C = (0.3374754822726147, 0.9761690190917186, 0.1607979714918209,
          0.0276438810333863, 0.0038405729373609, 0.0003951896511919,
          0.0000321767881768, 0.0000002888167364, 0.0000003960315187)

# The finite mask value of the Pallas attention kernels
# (``repro/kernels/decode_attention.py:16``): a fully masked row averages V
# instead of turning into NaN.
NEG_INF = -1e30

# Queries per step of the plain particle-filter search: the [chunk, N]
# comparison at N = 100,000 particles stays near 100 MB.
FINDINDEX_CHUNK = 1024


def _cndf(x):
    return 0.5 * (1.0 + torch.erf(x / SQRT2))


def blackscholes(spot, strike, rate, vol, time, is_call):
    """Black-Scholes option pricing (PARSEC blackscholes ROI)."""
    sqrt_t = torch.sqrt(time)
    d1 = (torch.log(spot / strike) + (rate + 0.5 * vol * vol) * time) \
        / (vol * sqrt_t)
    d2 = d1 - vol * sqrt_t
    call = spot * _cndf(d1) - strike * torch.exp(-rate * time) * _cndf(d2)
    put = strike * torch.exp(-rate * time) * _cndf(-d2) - spot * _cndf(-d1)
    return torch.where(is_call != 0, call, put)


def cum_normal_inv(u):
    """Swaptions CumNormalInv (Moro's algorithm), elementwise on float32."""
    A, B, C = MORO_A, MORO_B, MORO_C
    x = u - 0.5
    r_c = x * x
    num = x * (A[0] + r_c * (A[1] + r_c * (A[2] + r_c * A[3])))
    den = 1.0 + r_c * (B[0] + r_c * (B[1] + r_c * (B[2] + r_c * B[3])))
    central = num / den
    rr = torch.where(x > 0, 1.0 - u, u)
    rr = torch.clamp(rr, 1e-12, 0.5)
    z = torch.log(-torch.log(rr))
    tail = (C[0] + z * (C[1] + z * (C[2] + z * (C[3] + z * (C[4] + z * (
        C[5] + z * (C[6] + z * (C[7] + z * C[8]))))))))
    tail = torch.where(x > 0, tail, -tail)
    return torch.where(torch.abs(x) < 0.42, central, tail)


@contextlib.contextmanager
def _full_float32_matmul():
    """Float32 products in full float32: TF32 keeps ~3 decimal digits, too
    few for the 2e-4 bar of the streamcluster distances."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def streamcluster_dist(points, centers):
    """Pairwise squared euclidean distances [M,D]x[N,D] -> [M,N] float32."""
    p = points.float()
    c = centers.float()
    p2 = torch.sum(p * p, -1, keepdim=True)
    c2 = torch.sum(c * c, -1)
    with _full_float32_matmul():
        pc = p @ c.T
    return torch.clamp_min(p2 + c2[None, :] - 2.0 * pc, 0.0)


def canneal_swap_cost(locs, fan_idx, cand_a, cand_b):
    """Canneal swap_cost: manhattan routing cost of each element's fan
    against two candidate locations.

    locs [N,2]; fan_idx [B,F] (entries < 0 are padding; entries >= N read
    row N-1, as the reference's gather clamps); cand_a/b [B,2].
    Returns (cost_a [B], cost_b [B]).
    """
    valid = fan_idx >= 0
    idx = fan_idx.clamp(0, locs.shape[0] - 1).long()
    fl = locs.float()[idx]                                      # [B,F,2]
    da = torch.abs(fl - cand_a[:, None, :].float()).sum(-1)
    db = torch.abs(fl - cand_b[:, None, :].float()).sum(-1)
    va = torch.where(valid, da, 0.0).sum(-1)
    vb = torch.where(valid, db, 0.0).sum(-1)
    return va, vb


def particlefilter_findindex(cdf, u):
    """Rodinia particle filter guess-update: for each u_j, ``count(cdf <
    u_j)`` clamped to N-1 (the first index with cdf >= u_j on a monotone
    CDF; the vfirst.m/vpopc.m pattern).  Queries go ``FINDINDEX_CHUNK`` at
    a time, so the [M,N] comparison is never built whole."""
    out = torch.empty(u.shape[0], dtype=torch.int32, device=u.device)
    for s in range(0, u.shape[0], FINDINDEX_CHUNK):
        q = u[s:s + FINDINDEX_CHUNK]
        counts = torch.sum(cdf[None, :] < q[:, None], dim=1)
        out[s:s + FINDINDEX_CHUNK] = torch.clamp_max(counts, cdf.shape[0] - 1)
    return out


def jacobi2d(a, iters=1):
    """5-point Jacobi relaxation; boundary rows/cols held fixed.  A grid
    with no interior (R < 3 or C < 3) comes back as a copy.  A 16-bit grid
    is summed in float32 and rounded once, on the store."""
    for _ in range(iters):
        w = a.float()
        interior = 0.2 * (w[1:-1, 1:-1] + w[1:-1, :-2] + w[1:-1, 2:]
                          + w[:-2, 1:-1] + w[2:, 1:-1])
        a = a.clone()
        a[1:-1, 1:-1] = interior
    return a


# The value past both ends of a pathfinder cost row: the Pallas kernel's
# ``_INF`` (``repro/kernels/pathfinder.py:17``), 3.0e38 as a float32.
PATH_END = 3.0e38


def pathfinder(wall):
    """Rodinia pathfinder: min-cost path, row by row (dynamic programming).
    One row at a time on the wall's device; no ``[R, C]`` intermediate.

    Follows the Pallas kernel, which ``repro.kernels.ops.pathfinder``
    reaches: the columns past both ends hold ``PATH_END`` (float32 3.0e38)
    in every row.  ``repro.kernels.ref.pathfinder`` pads with ``inf``
    instead, so the two part where a cost and both its neighbours reach
    3e38 (a column of ``inf`` beside an end: Pallas ``3e38``, ``ref``
    ``inf``).  The min propagates NaN, as ``torch.minimum`` does."""
    cost = wall[0].float()
    end = torch.full((1,), PATH_END, device=wall.device)
    for i in range(1, wall.shape[0]):
        left = torch.cat([end, cost[:-1]])
        right = torch.cat([cost[1:], end])
        cost = wall[i].float() + torch.minimum(cost,
                                               torch.minimum(left, right))
    return cost


def flash_attention(q, k, v, causal=True):
    """Exact softmax attention. q/k/v [B,S,H,D] -> [B,S,H,D].  The scores
    are formed in q's type and the probabilities cast back to it before the
    product with V, as the reference does (why bf16 is held at 2e-2)."""
    scale = q.shape[-1] ** -0.5
    with _full_float32_matmul():
        s = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
        if causal:
            S = q.shape[1]
            mask = torch.tril(torch.ones(S, S, dtype=torch.bool,
                                         device=q.device))
            s = torch.where(mask[None, None], s, float("-inf"))
        a = torch.softmax(s, dim=-1)
        return torch.einsum("bhqk,bkhd->bqhd", a.to(q.dtype), v)


def decode_attention(q, k, v, kv_len):
    """Single-token attention vs a cache.  q [B,H,D], k/v [B,S,H,D],
    ``kv_len`` an int or int32 ``[B]``.  Keys at ``ki >= kv_len`` are masked
    with the finite ``NEG_INF`` of the Pallas kernel, not ``-inf``: at
    ``kv_len <= 0`` every key is masked alike and the result is the mean of
    V over all S positions, where ``repro/kernels/ref.py`` gives NaN.  q,
    k and v are widened to float32, as the Pallas kernel widens them, and
    the result has q's type."""
    B, S = k.shape[:2]
    lens = torch.as_tensor(kv_len, dtype=torch.int32, device=k.device)
    lens = lens.reshape(-1).expand(B)
    scale = q.shape[-1] ** -0.5
    qf, kf, vf = (t.float() for t in (q, k, v))
    with _full_float32_matmul():
        s = torch.einsum("bhd,bkhd->bhk", qf, kf) * scale
        mask = torch.arange(S, device=k.device)[None, None] \
            < lens[:, None, None]
        s = torch.where(mask, s, NEG_INF)
        a = torch.softmax(s, dim=-1)
        return torch.einsum("bhk,bkhd->bhd", a, vf).to(q.dtype)


def ssd_scan(x, dt, A, B, C, chunk):
    """Mamba-2 SSD scan, the oracle ``models/ssm.py:ssd_chunked`` with no
    D-skip (``repro/kernels/ref.py:131``).  x [b,S,H,P]; dt [b,S,H]; A [H];
    B/C [b,S,N] -> y [b,S,H,P] in x's type; float32 products in full
    float32."""
    from repro_torch.models.ssm import ssd_chunked
    with _full_float32_matmul():
        y, _ = ssd_chunked(x, dt, A, B, C,
                           torch.zeros(x.shape[2], device=x.device), chunk)
    return y
