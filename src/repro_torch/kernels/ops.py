"""Public wrappers of the suite's kernels.

The port of ``repro/kernels/ops.py``.  Where the reference picks Pallas
interpret mode off-TPU, the port picks by device: tensors already on a
device stay there (CUDA tensors launch the kernel, CPU tensors take the
plain version); anything else is moved to ``device``, which defaults to
the CUDA device and raises if there is none.  The Pallas block sizes have
no counterpart: the CUDA kernels take any size.
"""
from __future__ import annotations

import torch

from repro_torch import _device
from repro_torch.kernels import _promote
from repro_torch.kernels import blackscholes as _bs
from repro_torch.kernels import canneal as _ca
from repro_torch.kernels import decode_attention as _da
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import jacobi2d as _j2
from repro_torch.kernels import particlefilter as _pf
from repro_torch.kernels import pathfinder as _path
from repro_torch.kernels import ssd_scan as _ssd
from repro_torch.kernels import streamcluster as _sc
from repro_torch.kernels import swaptions as _sw


def _as_tensor(x, dtype, device):
    """``x`` itself if it is a tensor, else a new tensor on ``device``.
    ``dtype=None`` keeps the array's own type, but a 64-bit one becomes its
    32-bit counterpart (float64 float32, int64 int32), as the reference's
    JAX (64-bit types off) makes it."""
    if isinstance(x, torch.Tensor):
        return x
    t = torch.as_tensor(x, dtype=dtype)
    if dtype is None:
        t = _promote.narrow(t)
    return t.to(_device.resolve(device))


def blackscholes(spot, strike, rate, vol, time, is_call, *, device=None):
    """Black-Scholes call/put prices of N options, ``[N]`` in ``spot``'s
    type (arrays become float32; bfloat16 and float16 tensors are priced
    in float32 and rounded back; ``is_call`` int32 or boolean)."""
    f32 = torch.float32
    args = [_as_tensor(x, f32, device) for x in (spot, strike, rate, vol, time)]
    args.append(_as_tensor(is_call, torch.int32, device))
    return _bs.blackscholes(*args)


def cum_normal_inv(u, *, device=None):
    """Swaptions' inverse normal CDF (Moro) of uniforms ``u`` ``[N]``, in
    their type (an array becomes float32; a 16-bit tensor is computed in
    float32 and rounded back)."""
    return _sw.cum_normal_inv(_as_tensor(u, torch.float32, device))


def _grid(a, device):
    """A Jacobi-2D grid: a tensor as it is, an array in its own float type
    (float16 kept, float64 narrowed) and anything else as float32."""
    t = _as_tensor(a, None, device)
    return t if isinstance(a, torch.Tensor) or t.is_floating_point() \
        else t.float()


def jacobi2d_step(a, *, device=None):
    """One 5-point Jacobi sweep of a float32, bfloat16 or float16 ``[R, C]``
    grid (boundary rows and columns held), into a new tensor of its
    type."""
    return _j2.jacobi2d_step(_grid(a, device))


def jacobi2d(a, iters=1, *, device=None):
    """``iters`` 5-point Jacobi sweeps of a float32, bfloat16 or float16
    ``[R, C]`` grid, into a new tensor of its type, rounded to it at the end
    of every sweep (the reference's ``ref.jacobi2d(a, iters)``): one launch
    where the grid fits a thread-block cluster's shared memory, else one
    launch every few sweeps on tiles in shared memory, or one a sweep
    (``jacobi2d.route``)."""
    return _j2.jacobi2d(_grid(a, device), iters)


def pathfinder(wall, *, device=None):
    """The last min-cost row, float32 ``[C]``, of a wall ``[R, C]`` of
    int32 or float32 (bfloat16, float16 and int16 widened, exactly)."""
    return _path.pathfinder(_as_tensor(wall, None, device))


def streamcluster_dist(points, centers, *, device=None):
    """Squared distances, float32 ``[M,N]``, of points ``[M,D]`` to centers
    ``[N,D]`` (float32, bfloat16 or float16 of one type; others in
    float32, by the reference's rule)."""
    return _sc.streamcluster_dist(_as_tensor(points, None, device),
                                  _as_tensor(centers, None, device))


def canneal_swap_cost(locs, fan_idx, cand_a, cand_b, *, device=None):
    """Canneal's routing cost of each swap's fan against two candidates:
    ``(cost_a, cost_b)``, float32 ``[B]`` each (bfloat16, float16 or int32
    coordinate tensors widened to float32, as the reference widens
    them)."""
    f32 = torch.float32
    return _ca.swap_cost(_as_tensor(locs, f32, device),
                         _as_tensor(fan_idx, torch.int32, device),
                         _as_tensor(cand_a, f32, device),
                         _as_tensor(cand_b, f32, device))


def particlefilter_findindex(cdf, u, *, device=None):
    """For each query ``u_j``, ``count(cdf < u_j)`` clamped to N-1 (int32
    ``[M]``): the first index with ``cdf >= u_j`` on a monotone CDF
    (bfloat16 and float16 tensors widened to float32, exactly)."""
    f32 = torch.float32
    return _pf.find_index(_as_tensor(cdf, f32, device),
                          _as_tensor(u, f32, device))


def flash_attention(q, k, v, *, causal=True, device=None):
    """Softmax attention over q, k, v ``[B,S,H,D]``, causal or not; the
    output has q's type.  float32, bfloat16 and float16 operands of one
    type run as they are, others in float32 (the reference's rule); any
    D."""
    return _fa.flash_attention(_as_tensor(q, None, device),
                               _as_tensor(k, None, device),
                               _as_tensor(v, None, device), causal=causal)


def decode_attention(q, k, v, kv_len, *, device=None):
    """One query token per batch, q ``[B,H,D]``, against a cache k, v
    ``[B,S,H,D]`` (each float32, bfloat16 or float16; other types in
    float32, by the reference's rule; any D): ``[B,H,D]`` in q's type.
    ``kv_len`` is an int or int32 ``[B]``, broadcast to ``[B]`` as the
    reference does; at ``kv_len <= 0`` the result is the mean of V (the
    Pallas kernel's finite mask)."""
    q, k, v = (_as_tensor(x, None, device) for x in (q, k, v))
    lens = torch.as_tensor(kv_len, dtype=torch.int32, device=q.device)
    lens = lens.reshape(-1)
    if lens.numel() not in (1, k.shape[0]):
        raise ValueError(f"decode_attention: kv_len has {lens.numel()} "
                         f"entries for B = {k.shape[0]}")
    lens = lens.expand(k.shape[0]).contiguous()
    return _da.decode_attention(q, k, v, lens)


def ssd_scan(x, dt, A, B, C, *, chunk=256, device=None):
    """Mamba-2 SSD chunk scan: x ``[b,S,H,P]``, dt ``[b,S,H]``, A ``[H]``,
    B/C ``[b,S,N]`` -> y ``[b,S,H,P]`` in x's type (D-skip and gating
    outside).  ``S`` must be a multiple of ``min(chunk, S)``."""
    x = _as_tensor(x, None, device)
    dt, A, B, C = (_as_tensor(t, None, x.device) for t in (dt, A, B, C))
    return _ssd.ssd_scan(x, dt, A, B, C, chunk=chunk)
