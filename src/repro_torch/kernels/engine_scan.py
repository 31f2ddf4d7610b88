"""The vector-engine timing recurrence over B lanes: CUDA kernels + plain
version.

Replaces ``repro/core/engine.py:198-338`` (``_make_step`` with
``collect=False``, run under ``lax.scan`` and vmapped over configs, with
``repro/core/memory.py:150-165`` inlined).  One lane is one (trace, config)
pair.  On the card (``csrc/engine_scan.cu``) a call is two launches: a
pre-pass, one thread per (record row, lane), turns the trace tables into
one 20-byte record per (row, lane) (``prepass``: the carry-free terms of
``_record_terms`` and the flag bits); then the scan gives each lane one
thread, streams its records through shared memory and runs the whole scan
(``steps``).  ``scan`` runs both and counts one launch a call.

Inputs (all on one device, contiguous):

* ``xi``: int32 ``[10, P, B]`` — the integer trace fields in ``INT_FIELDS``
  order, time-major (``xi[f, r, b]``), so a warp's lanes read neighbouring
  words of one record row;
* ``xf``: float32 ``[P, B]`` — ``footprint_kb``;
* ``params``: float32 ``[B, 20]`` — ``engine._cfg_params_np`` per lane (its
  three int32 entries are small integers, exact in float32);
* ``consts``: float32 ``[14]`` — ``SCALAR_CYCLES``, ``VEC_PIPE_DEPTH``,
  ``VEC_ELEM_CYCLES``, ``DRAM_MLP``, ``PREFETCH_DEPTH``;
* ``period``, ``n_steps``, ``ckpt``: int32 ``[B]``.  Lane ``b`` runs
  ``n_steps[b]`` records, reading row ``r % period[b]`` at step ``r`` (a
  loop body stored once and tiled by the scan), and checkpoints
  ``(time, lane_busy, vmu_busy)`` after ``ckpt[b]`` records.

Output: float32 ``[8, B]`` in ``OUT_FIELDS`` order — the reference's five
``_metrics`` values, then the checkpoint.

Bound on an H100: the scan is latency-bound.  Each lane is one serial chain
of ``n_steps`` dependent steps, and a study has a few hundred lanes where
the card holds ~270k threads, so neither bytes (the record table is a few
MB, L2-resident) nor operations come near their peaks; the bound is
``max(n_steps)`` times the dependent float operations of one step at the
FP32 latency.  The kernel's step is longer than that chain: one warp a
scheduler issues its ~110 instructions (``csrc/engine_scan.cu``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import _build
from repro_torch.core import isa, memory

INT_FIELDS = ("kind", "vl", "fu", "n_src", "src1", "src2", "dst",
              "mem_pattern", "scalar_count", "dep_scalar")
N_PARAMS = 20
N_CONSTS = 14
OUT_FIELDS = ("time", "t_scalar", "t_last_commit", "lane_busy", "vmu_busy",
              "ck_time", "ck_lane_busy", "ck_vmu_busy")
MAX_RING = 64
N_REGS = 32

# bool table columns of the plain version (carry-independent per record)
_M_DEP, _M_SCALAR, _M_MEM, _M_SRC, _M_WREG, _M_RES, _M_RING = 0, 1, 2, 3, 5, 6, 7
# the four ring-write masks (rob, phys, arith queue, memory queue) are
# columns _M_RING.._M_RING+3: vec, vec, vec & ~mem, vec & mem

# the flag bits of the pre-pass's record word (csrc/engine_scan.cu); the
# state slots read for src1 and src2 (the register, or ZERO_SLOT when
# absent) and written for dst (the register of a vector instruction, else
# DUMMY_SLOT) follow from bits 7, 15 and 23, each times 128 (the byte
# offset of the slot's row in the kernel's shared memory)
F_DEP, F_VEC, F_MEM, F_ARITH, F_RES = 1, 2, 4, 8, 16
ZERO_SLOT, DUMMY_SLOT = N_REGS, N_REGS + 1


def _check_args(xi, xf, params, consts, *lanes):
    """The trace tables, and the three lane vectors ``period, n_steps,
    ckpt`` where they are given."""
    P, B = xf.shape if xf.dim() == 2 else (-1, -1)
    want = ((xi, torch.int32, (len(INT_FIELDS), P, B)),
            (xf, torch.float32, (P, B)),
            (params, torch.float32, (B, N_PARAMS)),
            (consts, torch.float32, (N_CONSTS,)),
            *((t, torch.int32, (B,)) for t in lanes))
    for name, (t, dtype, shape) in zip(
            ("xi", "xf", "params", "consts", "period", "n_steps", "ckpt"),
            want):
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"engine_scan: {name} must be {dtype} {shape}, "
                             f"got {t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"engine_scan: {name} must be contiguous")
        if t.device != xf.device:
            raise ValueError(f"engine_scan: {name} on {t.device}, "
                             f"xf on {xf.device}")


def _record_terms(xi, xf, params, consts):
    """Everything a step needs that does not depend on the carry, for every
    record row and lane at once (``[P, B]``), with the reference step's
    float32 operand order."""
    kind, vl, fu, n_src, src1, src2, dst, mpat, s_count, dep = xi.unbind(0)
    fu = fu.long()
    (lanes, phys_extra, rob_entries, q_entries, read_ports, line_elems,
     mem_ports, lat_l1, lat_l2, lat_dram, scalar_scale, dispatch_lat,
     ooo_f, ring_f, l1_kb, l2_kb, mshrs_f, dram_line_cyc,
     bmiss_extra, fuse_save) = params.unbind(1)
    sc_cost, pipe_depth, elem_cost = consts[0:4], consts[4:8], consts[8:12]
    f32 = torch.float32

    vlf = vl.to(f32)
    is_scalar = (kind == isa.SCALAR_BLOCK) | (kind == isa.NOP)
    s_cf = s_count.to(f32)
    eff_cost = sc_cost[fu] * (1.0 - fuse_save * (fu == 0).to(f32))
    sc_time = s_cf * eff_cost * scalar_scale + s_cf * bmiss_extra

    is_mem = (kind == isa.VLOAD) | (kind == isa.VSTORE)
    startup = pipe_depth[fu] + torch.ceil(n_src.to(f32) / read_ports)
    per_lane = torch.ceil(vlf / lanes)
    hops = torch.where(ring_f > 0, lanes - 1.0,
                       torch.ceil(torch.log2(torch.clamp_min(lanes, 2.0))))
    exec_mem = memory.vector_access_cycles(
        vlf, mpat, xf, line_elems, l1_kb, l2_kb, mshrs_f,
        lat_l1, lat_l2, lat_dram, dram_line_cyc, mem_ports)
    exec_c = torch.zeros_like(vlf)
    for k, v in ((isa.VARITH, per_lane * elem_cost[fu]),
                 (isa.VLOAD, exec_mem), (isa.VSTORE, exec_mem),
                 (isa.VSLIDE, per_lane + 1.0),
                 (isa.VREDUCE, per_lane + hops + pipe_depth[fu]),
                 (isa.VMASK_SCALAR, per_lane + hops),
                 (isa.VMOVE, per_lane)):
        exec_c = torch.where(kind == k, v, exec_c)
    busy = startup + exec_c
    lane_add = torch.where(is_scalar | is_mem, 0.0, busy)
    vmu_add = torch.where(is_mem, busy, 0.0)

    vec = ~is_scalar
    res = vec & ((kind == isa.VMASK_SCALAR) | (kind == isa.VREDUCE))
    F = torch.stack([sc_time, startup, exec_c, lane_add, vmu_add], -1)
    M = torch.stack([dep != 0, is_scalar, is_mem, src1 >= 0, src2 >= 0,
                     vec & (dst >= 0), res, vec, vec, vec & ~is_mem,
                     vec & is_mem], -1)
    I = torch.stack([src1.clamp_min(0), src2.clamp_min(0), dst.clamp_min(0)],
                    -1).long()
    return F, M, I


def scan_plain(xi, xf, params, consts, period, n_steps, ckpt):
    """The plain PyTorch version: the reference step, one record at a time,
    vectorized over the B lanes.  Lanes past their ``n_steps`` read an
    appended NOP row (timing-neutral), so one loop serves ragged lanes."""
    _check_args(xi, xf, params, consts, period, n_steps, ckpt)
    dev = xf.device
    P, B = xf.shape
    out = torch.zeros(len(OUT_FIELDS), B, dtype=torch.float32, device=dev)
    if B == 0:
        return out
    F, M, I = _record_terms(xi, xf, params, consts)
    # row P is the NOP row: a scalar record with no work
    nop_m = torch.zeros(1, B, M.shape[-1], dtype=torch.bool, device=dev)
    nop_m[..., _M_SCALAR] = True
    Ff = torch.cat([F, F.new_zeros(1, B, F.shape[-1])]).reshape(-1, F.shape[-1])
    Mf = torch.cat([M, nop_m]).reshape(-1, M.shape[-1])
    If = torch.cat([I, I.new_zeros(1, B, I.shape[-1])]).reshape(-1, I.shape[-1])

    T = int(n_steps.max())
    steps = torch.arange(T, device=dev)[:, None]
    rows = torch.where(steps < n_steps.long(), steps % period.long().clamp_min(1), P)
    flat = rows * B + torch.arange(B, device=dev)          # [T, B]

    caps = params[:, [2, 1, 3, 3]].long()                  # rob, phys, aq, mq
    sv_add = consts[0] * params[:, 10]                     # sc_cost[0] * scalar_scale
    dispatch_lat = params[:, 11]
    ooo = params[:, 12] > 0

    z = lambda: torch.zeros(B, dtype=torch.float32, device=dev)
    reg = torch.zeros(B, N_REGS, dtype=torch.float32, device=dev)
    rings = torch.zeros(B, 4, MAX_RING, dtype=torch.float32, device=dev)
    cnt = torch.zeros(B, 4, dtype=torch.long, device=dev)
    t_scalar, lane_free, vmu_free, last_aq, last_mq = z(), z(), z(), z(), z()
    last_commit, scalar_res, busy_lane, busy_vmu = z(), z(), z(), z()
    ck = ckpt.long()
    ck_at = set(ckpt.tolist())
    ck_time, ck_lane, ck_vmu = z(), z(), z()

    for r in range(T):
        idx = flat[r]
        f = Ff.index_select(0, idx)
        m = Mf.index_select(0, idx)
        i = If.index_select(0, idx)
        sc_time, startup, exec_c, lane_add, vmu_add = f.unbind(1)
        dep, is_scalar, is_mem = m[:, _M_DEP], m[:, _M_SCALAR], m[:, _M_MEM]
        wmask = m[:, _M_RING:_M_RING + 4]
        vec, vec_arith, vec_mem = wmask[:, 0], wmask[:, 2], wmask[:, 3]

        # scalar block
        t_wait = torch.where(dep, torch.maximum(t_scalar, scalar_res), t_scalar)
        t_scalar_s = t_wait + sc_time
        # vector instruction: ring reads, guarded before the index is used
        t_scalar_v = t_scalar + sv_add
        slots = rings.gather(2, ((cnt - caps) % MAX_RING)[:, :, None])[:, :, 0]
        slots = torch.where(cnt >= caps, slots, 0.0)
        q_slot = torch.where(is_mem, slots[:, 3], slots[:, 2])
        dispatch = torch.maximum(
            torch.maximum(t_scalar_v + dispatch_lat, slots[:, 0]),
            torch.maximum(slots[:, 1], q_slot))
        rr = torch.where(m[:, _M_SRC:_M_SRC + 2], reg.gather(1, i[:, 0:2]), 0.0)
        ops_ready = torch.maximum(rr[:, 0], rr[:, 1])
        fu_free = torch.where(is_mem, vmu_free, lane_free)
        inorder = torch.where(is_mem, last_mq, last_aq)
        issue = torch.maximum(torch.maximum(dispatch, ops_ready), fu_free)
        issue = torch.where(ooo, issue, torch.maximum(issue, inorder))
        complete = issue + startup + exec_c
        commit = torch.maximum(complete, last_commit)

        # merge
        t_scalar = torch.where(is_scalar, t_scalar_s, t_scalar_v)
        d = i[:, 2:3]
        reg.scatter_(1, d, torch.where(m[:, _M_WREG:_M_WREG + 1],
                                       complete[:, None], reg.gather(1, d)))
        w = (cnt % MAX_RING)[:, :, None]
        new = torch.stack([commit, commit, issue, issue], 1)[:, :, None]
        rings.scatter_(2, w, torch.where(wmask[:, :, None], new,
                                         rings.gather(2, w)))
        cnt += wmask
        lane_free = torch.where(vec_arith, complete, lane_free)
        vmu_free = torch.where(vec_mem, complete, vmu_free)
        last_aq = torch.where(vec_arith, issue, last_aq)
        last_mq = torch.where(vec_mem, issue, last_mq)
        last_commit = torch.where(vec, commit, last_commit)
        scalar_res = torch.where(m[:, _M_RES], complete, scalar_res)
        busy_lane = busy_lane + lane_add
        busy_vmu = busy_vmu + vmu_add

        if r + 1 in ck_at:
            hit = ck == r + 1
            ck_time = torch.where(hit, torch.maximum(t_scalar, last_commit),
                                  ck_time)
            ck_lane = torch.where(hit, busy_lane, ck_lane)
            ck_vmu = torch.where(hit, busy_vmu, ck_vmu)

    out[:] = torch.stack([torch.maximum(t_scalar, last_commit), t_scalar,
                          last_commit, busy_lane, busy_vmu,
                          ck_time, ck_lane, ck_vmu])
    return out


def prepass_plain(xi, xf, params, consts):
    """The pre-pass's records from ``_record_terms``: float32 ``[P, B, 4]``
    (the scalar-clock add — the block's cost for a scalar record, the issue
    cost ``SCALAR_CYCLES[0] * scalar_scale`` for a vector one — start-up,
    execute cycles, their sum) and the int32 ``[P, B]`` word of flag bits
    and state slots.  The kernel's pre-pass equals it bit for bit."""
    _check_args(xi, xf, params, consts)
    F, M, _ = _record_terms(xi, xf, params, consts)
    sc_time, startup, exec_c = F[..., 0], F[..., 1], F[..., 2]
    sv_add = consts[0] * params[:, 10]
    rec_f = torch.stack([torch.where(M[..., _M_SCALAR], sc_time, sv_add),
                         startup, exec_c, startup + exec_c], -1)
    src1, src2, dst = xi[4], xi[5], xi[6]
    vec = ~M[..., _M_SCALAR]
    w = torch.zeros_like(src1)
    for bit, m in ((F_DEP, M[..., _M_DEP] & M[..., _M_SCALAR]), (F_VEC, vec),
                   (F_MEM, M[..., _M_MEM] & vec),
                   (F_ARITH, vec & ~M[..., _M_MEM]), (F_RES, M[..., _M_RES])):
        w |= m.to(torch.int32) * bit
    w |= torch.where(src1 >= 0, src1 & 31, ZERO_SLOT) << 7
    w |= torch.where(src2 >= 0, src2 & 31, ZERO_SLOT) << 15
    w |= torch.where(M[..., _M_WREG], dst & 31, DUMMY_SLOT) << 23
    return rec_f.contiguous(), w.contiguous()


def _lib():
    lib = _build.load("engine_scan")
    if not getattr(lib, "_repro_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.engine_prepass_launch.argtypes = [p, p, p, p, p, p, i, i, p]
        lib.engine_prepass_launch.restype = ctypes.c_int
        lib.engine_steps_launch.argtypes = [p, p, p, p, p, p, p, i, p]
        lib.engine_steps_launch.restype = ctypes.c_int
        lib._repro_typed = True
    return lib


def _cuda_device(xf):
    if xf.device.type != "cuda":
        raise ValueError(f"engine_scan: the kernels take CUDA tensors, got "
                         f"{xf.device}")


def prepass(xi, xf, params, consts):
    """The pre-pass kernel alone: ``(rec_f, rec_w)`` as ``prepass_plain``
    gives them, for CUDA operands."""
    _check_args(xi, xf, params, consts)
    _cuda_device(xf)
    P, B = xf.shape
    rec_f = torch.empty(P, B, 4, dtype=torch.float32, device=xf.device)
    rec_w = torch.empty(P, B, dtype=torch.int32, device=xf.device)
    lib = _lib()
    with torch.cuda.device(xf.device):
        code = lib.engine_prepass_launch(
            xi.data_ptr(), xf.data_ptr(), params.data_ptr(), consts.data_ptr(),
            rec_f.data_ptr(), rec_w.data_ptr(), P, B,
            torch.cuda.current_stream().cuda_stream)
    _build.check(lib, code, "engine_scan prepass")
    return rec_f, rec_w


def steps(rec_f, rec_w, params, period, n_steps, ckpt):
    """The scan kernel alone over the pre-pass's records: float32 ``[8, B]``
    for CUDA operands."""
    _cuda_device(rec_f)
    P, B = rec_w.shape if rec_w.dim() == 2 else (-1, -1)
    want = ((rec_f, torch.float32, (P, B, 4)), (rec_w, torch.int32, (P, B)),
            (params, torch.float32, (B, N_PARAMS)),
            *((t, torch.int32, (B,)) for t in (period, n_steps, ckpt)))
    for name, (t, dtype, shape) in zip(
            ("rec_f", "rec_w", "params", "period", "n_steps", "ckpt"), want):
        if t.dtype != dtype or tuple(t.shape) != shape \
                or not t.is_contiguous() or t.device != rec_f.device:
            raise ValueError(f"engine_scan: {name} must be contiguous "
                             f"{dtype} {shape} on {rec_f.device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    out = torch.empty(len(OUT_FIELDS), B, dtype=torch.float32,
                      device=rec_f.device)
    if B == 0:
        return out
    lib = _lib()
    with torch.cuda.device(rec_f.device):
        code = lib.engine_steps_launch(
            rec_f.data_ptr(), rec_w.data_ptr(), params.data_ptr(),
            period.data_ptr(), n_steps.data_ptr(), ckpt.data_ptr(),
            out.data_ptr(), B, torch.cuda.current_stream().cuda_stream)
    _build.check(lib, code, "engine_scan")
    return out


def scan(xi, xf, params, consts, period, n_steps, ckpt):
    """Run the scan where the tensors lie: the two CUDA kernels for CUDA
    tensors (raising on any launch error), the plain version for CPU
    tensors."""
    _check_args(xi, xf, params, consts, period, n_steps, ckpt)
    if xf.device.type == "cpu":
        return scan_plain(xi, xf, params, consts, period, n_steps, ckpt)
    if xf.device.type != "cuda":
        raise ValueError(f"engine_scan: unsupported device {xf.device}")
    if xf.shape[1] == 0:
        return torch.empty(len(OUT_FIELDS), 0, dtype=torch.float32,
                           device=xf.device)
    out = steps(*prepass(xi, xf, params, consts), params, period, n_steps,
                ckpt)
    scan.launches += 1
    return out


scan.launches = 0
