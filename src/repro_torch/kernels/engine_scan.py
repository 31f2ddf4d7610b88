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

The collect build (``scan_collect``: ``prepass(..., collect=True)`` and
``steps_collect``) replaces ``repro/core/engine.py:435`` (``_profile_core``,
``_make_step(collect=True)`` under ``lax.scan``): the same template of the
same kernels, instantiated with the cycle attribution, which adds the
``STALL_KINDS`` accumulators, the lane-busy cycles per FU class and a
per-record timeline (``scan_plain(..., collect=True)`` documents the
outputs).  It counts its own launches (``scan_collect.launches``).

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

# The causes the collect build attributes cycles to, in accumulator order
# (the reference's ``engine.STALL_KINDS``).  The attribution is a frontier
# decomposition: the completion frontier F = max(t_scalar, last_commit) is
# monotone, and each step's advance is split into the wait that delayed
# issue (the binding constraint of the issue equation), the execution
# visible beyond the frontier (the executing module) and scalar work, so
# the accumulators sum to ``time`` up to float32 association.
STALL_KINDS = (
    "scalar_work", "dep_scalar", "dispatch", "rob_full", "phys_full",
    "aq_full", "mq_full", "raw", "lane_wait", "vmu_wait", "inorder",
    "exec_simple", "exec_mul", "exec_div", "exec_trans",
    "exec_interconnect", "exec_mask", "exec_move", "exec_mem",
)
N_STALL = len(STALL_KINDS)
_S = {k: i for i, k in enumerate(STALL_KINDS)}
# a vector record's execution class, as an offset from exec_simple: the FU
# class for an arithmetic record, then these
X_INTERCONNECT, X_MASK, X_MOVE, X_MEM = 4, 5, 6, 7
N_OCC = 4          # lane-busy cycles per arithmetic FU class

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
    I = torch.stack([src1.clamp_min(0), src2.clamp_min(0), dst.clamp_min(0),
                     exec_class(kind, fu), fu], -1).long()
    return F, M, I


def exec_class(kind, fu):
    """A vector record's execution class (its ``exec_*`` accumulator less
    ``exec_simple``), as the reference's ``exec_idx`` selects it: memory,
    then slides and reductions, vfirst/vpopc, moves, else the FU class."""
    x = fu.to(torch.int32)
    for v, k in ((X_MOVE, kind == isa.VMOVE),
                 (X_MASK, kind == isa.VMASK_SCALAR),
                 (X_INTERCONNECT, (kind == isa.VSLIDE) | (kind == isa.VREDUCE)),
                 (X_MEM, (kind == isa.VLOAD) | (kind == isa.VSTORE))):
        x = torch.where(k, v, x)
    return x


def scan_plain(xi, xf, params, consts, period, n_steps, ckpt,
               collect: bool = False):
    """The plain PyTorch version: the reference step, one record at a time,
    vectorized over the B lanes.  Lanes past their ``n_steps`` read an
    appended NOP row (timing-neutral), so one loop serves ragged lanes.

    With ``collect`` the loop also keeps what the reference's cycle
    attribution (``_make_step(collect=True)``) reads, ``_attribute`` runs
    it after the loop, and the call returns ``(out, acc, rec)``: ``out`` as without it, ``acc`` float32 ``[N_STALL + N_OCC, B]``
    (the ``STALL_KINDS`` accumulators, then the lane-busy cycles per FU
    class) and ``rec`` float32 ``[T, B, 4]`` (``T = max(n_steps)``): each
    record's start, issue and completion times and, in the last word's
    bits, its int32 cause (``records``); entries past a lane's ``n_steps``
    are 0."""
    _check_args(xi, xf, params, consts, period, n_steps, ckpt)
    dev = xf.device
    P, B = xf.shape
    out = torch.zeros(len(OUT_FIELDS), B, dtype=torch.float32, device=dev)
    T = int(n_steps.max()) if B else 0
    if collect:
        acc = torch.zeros(N_STALL + N_OCC, B, dtype=torch.float32, device=dev)
        rec = torch.zeros(T, B, 4, dtype=torch.float32, device=dev)
    if B == 0:
        return (out, acc, rec) if collect else out
    F, M, I = _record_terms(xi, xf, params, consts)
    # row P is the NOP row: a scalar record with no work
    nop_m = torch.zeros(1, B, M.shape[-1], dtype=torch.bool, device=dev)
    nop_m[..., _M_SCALAR] = True
    Ff = torch.cat([F, F.new_zeros(1, B, F.shape[-1])]).reshape(-1, F.shape[-1])
    Mf = torch.cat([M, nop_m]).reshape(-1, M.shape[-1])
    If = torch.cat([I, I.new_zeros(1, B, I.shape[-1])]).reshape(-1, I.shape[-1])

    steps = torch.arange(T, device=dev)[:, None]
    live = steps < n_steps.long()                           # [T, B]
    rows = torch.where(live, steps % period.long().clamp_min(1), P)
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
    hist = torch.empty(T if collect else 0, 13, B, dtype=torch.float32,
                       device=dev)

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

        if collect:
            # what the attribution reads, kept for after the loop (it
            # feeds nothing back into the recurrence)
            hist[r] = torch.stack((t_scalar, last_commit, t_wait, t_scalar_s,
                                   t_scalar_v, issue, complete, slots[:, 0],
                                   slots[:, 1], q_slot, ops_ready, fu_free,
                                   inorder))

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
    if not collect:
        return out
    _attribute(hist, Ff, Mf, If, flat, ooo, acc, rec)
    rec[~live] = 0.0
    return out, acc, rec


def _attribute(hist, Ff, Mf, If, flat, ooo, acc, rec, chunk: int = 4096):
    """The reference's cycle attribution (``_make_step(collect=True)``),
    term for term, over every step at once from ``scan_plain``'s per-step
    values ``hist`` [T, 13, B]; the accumulators then add each step's
    delta in step order, as the scan does.  Each delta vector starts at
    zero and adds into its slots in the reference's order (a dep block's
    two terms meet in one slot before the accumulator add)."""
    T, _, B = hist.shape
    dev = hist.device
    clip = lambda x: torch.clamp_min(x, 0.0)
    total = torch.zeros(B, N_STALL + N_OCC, dtype=torch.float32, device=dev)
    for c0 in range(0, T, chunk):
        (t_scalar, last_commit, t_wait, t_scalar_s, t_scalar_v, issue,
         complete, rob_slot, phys_slot, q_slot, ops_ready, fu_free,
         inorder) = hist[c0:c0 + chunk].unbind(1)               # [t, B]
        idx = flat[c0:c0 + chunk]
        m, i = Mf[idx], If[idx]
        dep, is_scalar, is_mem = m[..., _M_DEP], m[..., _M_SCALAR], m[..., _M_MEM]
        lane_add = Ff[idx][..., 3]

        f_old = torch.maximum(t_scalar, last_commit)
        dep_vis = clip(t_wait - f_old)
        work_vis = clip(t_scalar_s - torch.maximum(t_wait, f_old))
        sc_idx = torch.where(dep, _S["dep_scalar"], _S["scalar_work"])
        # the binding constraint, lowest precedence first
        cause = torch.full_like(sc_idx, _S["dispatch"])
        for hit, k in ((~ooo & (issue == inorder), _S["inorder"]),
                       (issue == fu_free, torch.where(
                           is_mem, _S["vmu_wait"], _S["lane_wait"])),
                       (issue == ops_ready, _S["raw"]),
                       (issue == q_slot, torch.where(
                           is_mem, _S["mq_full"], _S["aq_full"])),
                       (issue == phys_slot, _S["phys_full"]),
                       (issue == rob_slot, _S["rob_full"])):
            cause = torch.where(hit, k, cause)
        exec_idx = _S["exec_simple"] + i[..., 3]
        wait_vis = clip(issue - f_old)
        exec_vis = clip(complete - torch.maximum(issue, f_old))
        tail_vis = clip(t_scalar_v - torch.maximum(complete, f_old))

        sc_delta = torch.zeros(*dep.shape, N_STALL, dtype=torch.float32,
                               device=dev)
        sc_delta[..., _S["dep_scalar"]] += dep_vis
        sc_delta.scatter_add_(-1, sc_idx[..., None], work_vis[..., None])
        vec_delta = torch.zeros_like(sc_delta)
        vec_delta.scatter_add_(-1, cause[..., None], wait_vis[..., None])
        vec_delta.scatter_add_(-1, exec_idx[..., None], exec_vis[..., None])
        vec_delta[..., _S["scalar_work"]] += tail_vis
        occ_delta = torch.zeros(*dep.shape, N_OCC, dtype=torch.float32,
                                device=dev)
        occ_delta.scatter_add_(-1, i[..., 4:5], lane_add[..., None])
        delta = torch.cat([torch.where(is_scalar[..., None], sc_delta,
                                       vec_delta), occ_delta], -1)
        for d in delta:
            total = total + d

        part = rec[c0:c0 + chunk]
        part[..., 0] = torch.where(is_scalar, t_scalar, t_scalar_v)
        part[..., 1] = torch.where(is_scalar, t_wait, issue)
        part[..., 2] = torch.where(is_scalar, t_scalar_s, complete)
        part.view(torch.int32)[..., 3] = torch.where(
            is_scalar, sc_idx, cause).to(torch.int32)
    acc[:] = total.T


def records(rec) -> dict:
    """The per-record timeline of lane ``rec[:, b]`` (or of every lane, for
    ``rec`` ``[T, B, 4]``): ``start`` / ``issue`` / ``complete`` float32
    and ``cause`` int32 (an index into ``STALL_KINDS``), as views."""
    return {"start": rec[..., 0], "issue": rec[..., 1],
            "complete": rec[..., 2],
            "cause": rec.view(torch.int32)[..., 3]}


def prepass_plain(xi, xf, params, consts, collect: bool = False):
    """The pre-pass's records from ``_record_terms``: float32 ``[P, B, 4]``
    (the scalar-clock add — the block's cost for a scalar record, the issue
    cost ``SCALAR_CYCLES[0] * scalar_scale`` for a vector one — start-up,
    execute cycles, their sum) and the int32 ``[P, B]`` word of flag bits
    and state slots; with ``collect`` also the collect build's int32
    ``[P, B]`` word, the execution class (bits 0-3) and the FU class (bits
    4-5).  The kernel's pre-pass equals it bit for bit."""
    _check_args(xi, xf, params, consts)
    F, M, I = _record_terms(xi, xf, params, consts)
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
    if not collect:
        return rec_f.contiguous(), w.contiguous()
    x = (I[..., 3] | I[..., 4] << 4).to(torch.int32)
    return rec_f.contiguous(), w.contiguous(), x.contiguous()


def _lib():
    lib = _build.load("engine_scan")
    if not getattr(lib, "_repro_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.engine_prepass_launch.argtypes = [p, p, p, p, p, p, i, i, p]
        lib.engine_prepass_launch.restype = ctypes.c_int
        lib.engine_steps_launch.argtypes = [p, p, p, p, p, p, p, i, p]
        lib.engine_steps_launch.restype = ctypes.c_int
        lib.engine_prepass_collect_launch.argtypes = [p, p, p, p, p, p, p,
                                                      i, i, p]
        lib.engine_prepass_collect_launch.restype = ctypes.c_int
        lib.engine_steps_collect_launch.argtypes = [p, p, p, p, p, p, p, p,
                                                    p, p, i, p]
        lib.engine_steps_collect_launch.restype = ctypes.c_int
        lib._repro_typed = True
    return lib


def _cuda_device(xf):
    if xf.device.type != "cuda":
        raise ValueError(f"engine_scan: the kernels take CUDA tensors, got "
                         f"{xf.device}")


def prepass(xi, xf, params, consts, collect: bool = False):
    """The pre-pass kernel alone: ``(rec_f, rec_w)``, or with ``collect``
    the collect build's ``(rec_f, rec_w, rec_x)``, as ``prepass_plain``
    gives them, for CUDA operands."""
    _check_args(xi, xf, params, consts)
    _cuda_device(xf)
    P, B = xf.shape
    rec_f = torch.empty(P, B, 4, dtype=torch.float32, device=xf.device)
    rec_w = torch.empty(P, B, dtype=torch.int32, device=xf.device)
    lib = _lib()
    args = (xi.data_ptr(), xf.data_ptr(), params.data_ptr(),
            consts.data_ptr(), rec_f.data_ptr(), rec_w.data_ptr())
    with torch.cuda.device(xf.device):
        stream = torch.cuda.current_stream().cuda_stream
        if collect:
            rec_x = torch.empty(P, B, dtype=torch.int32, device=xf.device)
            code = lib.engine_prepass_collect_launch(
                *args, rec_x.data_ptr(), P, B, stream)
        else:
            code = lib.engine_prepass_launch(*args, P, B, stream)
    _build.check(lib, code, "engine_scan prepass")
    return (rec_f, rec_w, rec_x) if collect else (rec_f, rec_w)


def _check_records(rec_f, rec_w, params, period, n_steps, ckpt, *rec_x):
    _cuda_device(rec_f)
    P, B = rec_w.shape if rec_w.dim() == 2 else (-1, -1)
    want = ((rec_f, torch.float32, (P, B, 4)), (rec_w, torch.int32, (P, B)),
            (params, torch.float32, (B, N_PARAMS)),
            *((t, torch.int32, (B,)) for t in (period, n_steps, ckpt)),
            *((t, torch.int32, (P, B)) for t in rec_x))
    for name, (t, dtype, shape) in zip(
            ("rec_f", "rec_w", "params", "period", "n_steps", "ckpt",
             "rec_x"), want):
        if t.dtype != dtype or tuple(t.shape) != shape \
                or not t.is_contiguous() or t.device != rec_f.device:
            raise ValueError(f"engine_scan: {name} must be contiguous "
                             f"{dtype} {shape} on {rec_f.device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    return B


def steps(rec_f, rec_w, params, period, n_steps, ckpt):
    """The scan kernel alone over the pre-pass's records: float32 ``[8, B]``
    for CUDA operands."""
    B = _check_records(rec_f, rec_w, params, period, n_steps, ckpt)
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


def steps_collect(rec_f, rec_w, rec_x, params, period, n_steps, ckpt):
    """The collect build's scan kernel alone over its pre-pass's records:
    ``(out, acc, rec)`` as ``scan_plain(..., collect=True)`` gives them,
    for CUDA operands."""
    B = _check_records(rec_f, rec_w, params, period, n_steps, ckpt, rec_x)
    dev = rec_f.device
    out = torch.empty(len(OUT_FIELDS), B, dtype=torch.float32, device=dev)
    acc = torch.empty(N_STALL + N_OCC, B, dtype=torch.float32, device=dev)
    T = int(n_steps.max()) if B else 0
    # the kernel writes each lane's first n_steps rows; the rest stay 0
    rec = torch.zeros(T, B, 4, dtype=torch.float32, device=dev)
    if B == 0:
        return out, acc, rec
    lib = _lib()
    with torch.cuda.device(dev):
        code = lib.engine_steps_collect_launch(
            rec_f.data_ptr(), rec_w.data_ptr(), rec_x.data_ptr(),
            params.data_ptr(), period.data_ptr(), n_steps.data_ptr(),
            ckpt.data_ptr(), out.data_ptr(), acc.data_ptr(), rec.data_ptr(),
            B, torch.cuda.current_stream().cuda_stream)
    _build.check(lib, code, "engine_scan collect")
    return out, acc, rec


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


def scan_collect(xi, xf, params, consts, period, n_steps, ckpt):
    """The scan with the cycle attribution where the tensors lie: the
    collect build's two CUDA kernels for CUDA tensors (raising on any
    launch error), ``scan_plain(..., collect=True)`` for CPU tensors.
    Returns ``(out, acc, rec)`` (see ``scan_plain``); ``out`` equals
    ``scan``'s bit for bit.  Counts one launch a call."""
    _check_args(xi, xf, params, consts, period, n_steps, ckpt)
    if xf.device.type == "cpu":
        return scan_plain(xi, xf, params, consts, period, n_steps, ckpt,
                          collect=True)
    if xf.device.type != "cuda":
        raise ValueError(f"engine_scan: unsupported device {xf.device}")
    if xf.shape[1] == 0:
        z = lambda *shape: torch.zeros(shape, dtype=torch.float32,
                                       device=xf.device)
        return z(len(OUT_FIELDS), 0), z(N_STALL + N_OCC, 0), z(0, 0, 4)
    out = steps_collect(*prepass(xi, xf, params, consts, collect=True),
                        params, period, n_steps, ckpt)
    scan_collect.launches += 1
    return out


scan_collect.launches = 0
