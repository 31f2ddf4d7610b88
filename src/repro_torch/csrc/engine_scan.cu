// The vector-engine timing recurrence for Hopper (sm_90a), plain C interface.
//
// Replaces repro/core/engine.py:198-338 (_make_step, collect=False, under
// lax.scan, vmapped over configs) with repro/core/memory.py:150-165 inlined.
// One lane is one (trace, config) pair.  Layouts of the operands are
// documented in repro_torch/kernels/engine_scan.py.
//
// Two kernels, launched back to back on one stream:
//
//  1. The pre-pass, one thread per (record row, lane): everything a step
//     needs that does not depend on the carry, as the plain version's
//     _record_terms computes it, in the same float32 operand order --
//     the scalar-clock add (the block's cost for a scalar record, the
//     issue cost for a vector one), start-up, execute cycles and their sum,
//     plus one int32 word of flag bits and the state slots the record reads
//     and writes.  It is written time-major, rec[row][lane] as a float4 and
//     an int, so a step reads 20 bytes.  Every division, ceil, the switch
//     on the kind and vector_access_cycles live here, fully parallel over
//     P x B (~165k threads at the study's 985 x 168).
//  2. The scan, one thread per lane, 32 lanes a block.  Each thread copies
//     its own lane's records with cp.async into a ring of STAGES tiles of
//     K records in shared memory, TILES_AHEAD tiles ahead of the step that
//     reads them, so a step never waits on L2.  The step has no branch on
//     the record: the scalar and vector updates are selects on the flag
//     bits, as the plain version's masks are.
//
// The carry of a lane is the 32-entry register scoreboard, three 64-entry
// occupancy rings (ROB, arithmetic queue, memory queue) and a dozen scalar
// clocks and counters.  The physical-register ring of the reference is
// written with the ROB's values at the ROB's count on every vector record,
// so it is the ROB ring read at another capacity and is not stored.
// Scoreboard and rings live in shared memory, column per thread:
// st[slot][lane], so a warp's 32 threads always hit 32 distinct banks.  An
// absent source reads a slot that stays 0 and an absent dst writes a slot
// nothing reads, so register reads and writes need no test; slots, counts
// and capacities are kept as byte offsets into the thread's column.
//
// What bounds a step now.  A lane is one serial chain of n_steps steps and
// a study has a few hundred lanes (a few warps on as many SMs), so the time
// is max(n_steps) x one step.  The shared-memory reads a step needs (its
// two source registers and three ring slots) are issued one step ahead,
// before the previous step's stores, and the previous step's results are
// forwarded into them where it wrote the same slot; so the dependent chain
// of a step is a forwarding select, the fmax tree of the issue time and the
// two adds of the completion time (~7 dependent float operations, ~30
// cycles).  What sets the step's length is its instruction count: one warp
// a scheduler issues at most one instruction a cycle, and a step is ~100
// instructions of its own (flag decoding, slot offsets, five loads and
// three stores, the forwarding compares and selects, the carry's selects)
// plus ~14 a record for the cp.async stream (a tile's wait and copies)
// -- ~158 cycles a step on an H100 (PERF.md).
//
// The collect build (engine_scan_kernel<true>, with the pre-pass's
// engine_prepass_kernel<true>) replaces repro/core/engine.py:435
// _profile_core: _make_step(collect=True) under lax.scan, the cycle
// attribution of engine.simulate(collect_stats=True).  It is the same
// template as the default build, instantiated with COLLECT, so the two
// recurrences cannot drift; every collect-only line sits under
// `if constexpr (COLLECT)` and the default instantiation compiles to the
// kernel it was.  What it adds to a step:
//  * a third record word from the pre-pass (rec_x: the record's execution
//    class and FU class; the flag word has no room for them), streamed
//    through the same cp.async ring;
//  * the frontier F = max(t_scalar, last_commit) before the step and the
//    visible pieces of the step's advance (dep / work for a scalar block;
//    wait / exec / tail for a vector instruction), in the reference's
//    float32 operations;
//  * the wait's cause: the candidates the issue time is the max of (the
//    ROB, rename and queue slots, operand readiness, the FU, the in-order
//    gate) compared with it in the reference's precedence, read before
//    this step's stores overwrite the forwarded slots;
//  * 19 STALL_KINDS accumulators and 4 lane-busy sums per FU class:
//    scalar_work and dep_scalar, which most steps touch, in registers; the
//    wait causes, execution classes and FU sums in rows of this thread's
//    column of shared memory, each range with a dummy row a record without
//    such a term adds to.  A step reads its three rows together and writes
//    them back (they never coincide) -- one read-modify-write a touched
//    slot, where predicated adds into 23 registers cost 420 cycles a step
//    against 285 (scripts/engine_scan_variants.py --collect).  Adding the
//    reference's zeros to the untouched slots changes no bit, so they are
//    not touched;
//  * one 16-byte streaming store a record, rec[step][lane] = (start,
//    issue, complete, cause bits): a warp's 32 lanes store 512
//    neighbouring bytes.
// It is bound like the default build (one serial chain a lane, the step's
// instructions issued by one warp a scheduler) plus the timeline's bytes
// (16 B a record), which at the study's 1.1 M records is ~5 us of the
// card's 3.35 TB/s: the extra instructions of a step are its cost.
//
// Bitwise parity with the plain version (and so with the reference's step):
//  * FMA contraction.  Build with -fmad=false: every a*b+c is two
//    roundings.  Float literals carry the f suffix; division is IEEE
//    (nvcc's default; never --use_fast_math).  busy = startup + exec_c is
//    summed in the pre-pass, complete = (issue + startup) + exec_c in the
//    step, in the reference's order.
//  * Selects for masks.  A scalar record adds 0.0f to the busy sums, as the
//    plain version does; fmaxf(t, -inf) is t; max is exact, so the fmax
//    trees are regrouped freely (no value is NaN or -0: every clock is a
//    sum of non-negative terms).
//  * Ring index.  The reference reads ring[jnp.mod(count - capacity, 64)]
//    only when count >= capacity, else 0.  Here the index is the floor mod
//    (a mask), unguarded: while count < capacity (<= 64) that slot has not
//    been written yet and holds its initial 0.
//  * exec_c picks the first true kind (all kinds are distinct, so the
//    chain of selects is jnp.select); an unknown kind executes for 0
//    cycles, as in the plain version (the host refuses such kinds).
//  * ceil(log2(lanes)).  Computed exactly from frexpf; the reference's
//    log2 is exact for the integer lane counts the configs take.
//  * float64 parameters.  dram_line_cycles and scalar_scale arrive already
//    computed in float64 on the host and cast once, as the reference does.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int WARP = 32;
constexpr int MAX_RING = 64;
constexpr int N_REGS = 32;
constexpr int N_PARAMS = 20;
constexpr int N_FIELDS = 10;

// state slots of a lane: the scoreboard, a slot that stays 0 (read for an
// absent source), a slot nothing reads (written for an absent dst), then
// the ROB, arithmetic-queue and memory-queue rings
constexpr int ZERO = N_REGS, DUMMY = N_REGS + 1;
constexpr int ROB0 = N_REGS + 2, AQ0 = ROB0 + MAX_RING, MQ0 = AQ0 + MAX_RING;
constexpr int N_SLOTS = MQ0 + MAX_RING;

// the record ring: STAGES tiles of K records a lane; the tile a step reads
// next was requested TILES_AHEAD tiles earlier
constexpr int K = 8, STAGES = 4, TILES_AHEAD = STAGES - 1;

// isa kinds
constexpr int SCALAR_BLOCK = 0, VARITH = 1, VLOAD = 2, VSTORE = 3, VSLIDE = 4,
              VREDUCE = 5, VMASK_SCALAR = 6, VMOVE = 7, NOP = 8;
constexpr int MEM_UNIT = 0, MEM_INDEXED = 2;

// the collect build's accumulators, in STALL_KINDS order; a vector
// record's execution class is an offset from S_EXEC (the FU class for an
// arithmetic record, then X_*)
constexpr int S_SCALAR_WORK = 0, S_DEP_SCALAR = 1, S_DISPATCH = 2,
              S_ROB_FULL = 3, S_PHYS_FULL = 4, S_AQ_FULL = 5, S_MQ_FULL = 6,
              S_RAW = 7, S_LANE_WAIT = 8, S_VMU_WAIT = 9, S_INORDER = 10,
              S_EXEC = 11, N_STALL = 19, N_OCC = 4;
constexpr int X_INTERCONNECT = 4, X_MASK = 5, X_MOVE = 6, X_MEM = 7;
// the collect build's accumulator rows in shared memory: the wait causes
// (S_DISPATCH..S_INORDER), the execution classes, the FU sums, each range
// followed by its dummy row
constexpr int A_WAIT = 0, A_WAIT_NONE = A_WAIT + S_EXEC - S_DISPATCH;
constexpr int A_EXEC = A_WAIT_NONE + 1, A_EXEC_NONE = A_EXEC + N_STALL - S_EXEC;
constexpr int A_OCC = A_EXEC_NONE + 1, A_OCC_NONE = A_OCC + N_OCC;
constexpr int ACC_ROWS = A_OCC_NONE + 1;

// A record's int32 word: flag bits, then the state slots it reads (src1,
// src2: the register, or ZERO when absent) and writes (dst: the register
// of a vector instruction, else DUMMY), each as slot x 128, the byte offset
// of its row of st[slot][lane], 8 bits a slot from bit 7, 15 and 23.
constexpr int F_DEP = 1;     // a scalar block that waits for a vector result
constexpr int F_VEC = 2;     // a vector instruction (not SCALAR_BLOCK / NOP)
constexpr int F_MEM = 4;     // a vector load or store
constexpr int F_ARITH = 8;   // a vector instruction of the lanes (not memory)
constexpr int F_RES = 16;    // hands its result to the scalar core
constexpr int ROW = WARP * (int)sizeof(float);   // bytes of one slot row
constexpr int SLOT_BITS = 0xff * ROW;            // one slot field, in place
constexpr int RING_MASK = (MAX_RING - 1) * ROW;  // a ring index, in bytes

__device__ __forceinline__ float pick4(const float* c, int i) {
  return i == 0 ? c[0] : i == 1 ? c[1] : i == 2 ? c[2] : c[3];
}

__device__ __forceinline__ float ceil_log2(float x) {
  int e;
  const float m = frexpf(x, &e);  // x = m * 2^e, m in [0.5, 1)
  return (float)(m == 0.5f ? e - 1 : e);
}

// memory.vector_access_cycles, operand for operand
__device__ __forceinline__ float vector_access_cycles(
    float vlf, int pattern, float fp_kb, float line_elems, float l1_kb,
    float l2_kb, float mshrs, float lat_l1, float lat_l2, float lat_dram,
    float line_cyc, float mem_ports, float dram_mlp, float prefetch_depth) {
  const float fpm = fmaxf(fp_kb, 1e-6f);
  const float r1 = fminf(l1_kb / fpm, 1.0f);
  const float r2 = fminf(l2_kb / fpm, 1.0f);
  const float m1 = 1.0f - r1;
  const float m2 = fminf(fmaxf((1.0f - r2) / fmaxf(m1, 1e-6f), 0.0f), 1.0f);
  const float ovl = pattern == MEM_INDEXED ? fminf(mshrs, dram_mlp)
                                           : prefetch_depth;
  const float lead = lat_l1 + (m1 * lat_l2 + m1 * m2 * lat_dram) / ovl;
  const float port = 1.0f / mem_ports;
  const float l2 = m1 * lat_l2 / ovl;
  const float dram = m1 * m2 * fmaxf(lat_dram / ovl, line_cyc);
  const float per = fmaxf(port, fmaxf(l2, dram));
  const float n_acc = pattern == MEM_UNIT ? ceilf(vlf / line_elems) : vlf;
  return lead + n_acc * per;
}

// ---- 1. the pre-pass ---------------------------------------------------------

// COLLECT also writes rec_x: the execution class (bits 0-3) and the FU
// class (bits 4-5) of the record.
template <bool COLLECT>
__global__ void __launch_bounds__(256)
engine_prepass_kernel(const int32_t* __restrict__ xi,
                      const float* __restrict__ xf,
                      const float* __restrict__ params,
                      const float* __restrict__ consts,
                      float4* __restrict__ rec_f, int32_t* __restrict__ rec_w,
                      int32_t* __restrict__ rec_x, long long PB, int B) {
  const long long o = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= PB) return;
  const int b = (int)(o % B);
  int f[N_FIELDS];
#pragma unroll
  for (int i = 0; i < N_FIELDS; ++i) f[i] = __ldg(xi + i * PB + o);
  const int kind = f[0], vl = f[1], fu = f[2], n_src = f[3], src1 = f[4],
            src2 = f[5], dst = f[6], mpat = f[7], s_count = f[8], dep = f[9];
  const float fp_kb = __ldg(xf + o);

  const float* p = params + (long long)b * N_PARAMS;
  const float lanes = p[0];
  const float read_ports = p[4], line_elems = p[5], mem_ports = p[6];
  const float lat_l1 = p[7], lat_l2 = p[8], lat_dram = p[9];
  const float scalar_scale = p[10];
  const float ring_f = p[13], l1_kb = p[14], l2_kb = p[15], mshrs = p[16];
  const float line_cyc = p[17], bmiss_extra = p[18], fuse_save = p[19];
  float sc[4], pd[4], ec[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    sc[i] = consts[i];
    pd[i] = consts[4 + i];
    ec[i] = consts[8 + i];
  }
  const float dram_mlp = consts[12], prefetch_depth = consts[13];

  const bool is_scalar = kind == SCALAR_BLOCK || kind == NOP;
  const bool is_mem = kind == VLOAD || kind == VSTORE;
  // scalar block: per-class cost with the fusion / mispredict deltas
  const float s_cf = (float)s_count;
  const float fz = fu == 0 ? 1.0f : 0.0f;
  const float eff_cost = pick4(sc, fu) * (1.0f - fuse_save * fz);
  const float sc_time = s_cf * eff_cost * scalar_scale + s_cf * bmiss_extra;
  // vector instruction: start-up is pipe depth + VRF read-port
  // serialization (§3.2.4), then the kind's execute cycles
  const float startup = pick4(pd, fu) + ceilf((float)n_src / read_ports);
  const float vlf = (float)vl;
  const float per_lane = ceilf(vlf / lanes);
  const float hops =
      ring_f > 0.0f ? lanes - 1.0f : ceil_log2(fmaxf(lanes, 2.0f));
  float exec_c = 0.0f;
  switch (kind) {
    case VARITH: exec_c = per_lane * pick4(ec, fu); break;
    case VLOAD:
    case VSTORE:
      exec_c = vector_access_cycles(vlf, mpat, fp_kb, line_elems, l1_kb,
                                    l2_kb, mshrs, lat_l1, lat_l2, lat_dram,
                                    line_cyc, mem_ports, dram_mlp,
                                    prefetch_depth);
      break;
    case VSLIDE: exec_c = per_lane + 1.0f; break;
    case VREDUCE: exec_c = per_lane + hops + pick4(pd, fu); break;
    case VMASK_SCALAR: exec_c = per_lane + hops; break;
    case VMOVE: exec_c = per_lane; break;
    default: break;
  }
  const float sv_add = sc[0] * scalar_scale;

  const bool vec = !is_scalar;
  int w = 0;
  if (is_scalar && dep != 0) w |= F_DEP;
  if (vec) w |= F_VEC;
  if (vec && is_mem) w |= F_MEM;
  if (vec && !is_mem) w |= F_ARITH;
  if (vec && (kind == VMASK_SCALAR || kind == VREDUCE)) w |= F_RES;
  w |= (src1 >= 0 ? src1 & 31 : ZERO) << 7 |
       (src2 >= 0 ? src2 & 31 : ZERO) << 15 |
       (vec && dst >= 0 ? dst & 31 : DUMMY) << 23;

  rec_f[o] = make_float4(is_scalar ? sc_time : sv_add, startup, exec_c,
                         startup + exec_c);
  rec_w[o] = w;
  if constexpr (COLLECT) {
    // the reference's exec_idx: memory, slides and reductions,
    // vfirst/vpopc, moves, else the FU class
    const int x = is_mem ? X_MEM
                  : kind == VSLIDE || kind == VREDUCE ? X_INTERCONNECT
                  : kind == VMASK_SCALAR ? X_MASK
                  : kind == VMOVE ? X_MOVE : fu;
    rec_x[o] = x | fu << 4;
  }
}

// ---- 2. the scan ---------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// N-byte cp.async of one piece of this thread's own record
template <int N>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  if constexpr (N == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                     smem_u32(dst)),
                 "l"(src)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;" ::"r"(
                     smem_u32(dst)),
                 "l"(src), "n"(N)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// A float at byte offset `off` of this thread's column of st.
__device__ __forceinline__ float& at(char* col, int off) {
  return *reinterpret_cast<float*>(col + off);
}

// This lane's record stream: the ring of STAGES x K records (this thread's
// column of it: ring row i at f[i * WARP], w[i * WARP], and for the collect
// build x[i * WARP]) and the row of the next record to request.
struct Stream {
  float4* f;
  int32_t* w;
  const float4* src_f;   // the lane's next record in rec_f / rec_w
  const int32_t* src_w;
  int pos, per;
  long long stride;      // B: one row of rec_f / rec_w
  int32_t* x;            // the collect build's rec_x ring and source
  const int32_t* src_x;
};

// Request tile `tile` (steps tile * K ..) in the lane's loop order; one
// commit group a tile.  Rows past n_steps are copied too (they are valid
// rows of the lane's body and are never read), so there is no branch.
template <bool COLLECT>
__device__ __forceinline__ void fetch_tile(Stream& s, int tile) {
  const int s0 = (tile % STAGES) * K;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    cp_async<16>(s.f + (s0 + k) * WARP, s.src_f);
    cp_async<4>(s.w + (s0 + k) * WARP, s.src_w);
    if constexpr (COLLECT) cp_async<4>(s.x + (s0 + k) * WARP, s.src_x);
    const bool wrap = ++s.pos == s.per;
    const long long step = wrap ? -(s.per - 1) * s.stride : s.stride;
    s.pos = wrap ? 0 : s.pos;
    s.src_f += step;
    s.src_w += step;
    if constexpr (COLLECT) s.src_x += step;
  }
  cp_async_commit();
}

// The dynamic shared memory: the record ring, a float4 and an int32 a
// record, and for the collect build the rec_x word and the accumulator rows.
template <bool COLLECT>
constexpr int ring_bytes() {
  return STAGES * K * WARP *
             (int)(sizeof(float4) + sizeof(int32_t) * (COLLECT ? 2 : 1)) +
         (COLLECT ? ACC_ROWS * WARP * (int)sizeof(float) : 0);
}

// COLLECT also takes rec_x and writes acc [N_STALL + N_OCC, B] and
// rec [n_steps, B] float4 (only rows below the lane's n_steps).
template <bool COLLECT>
__global__ void __launch_bounds__(WARP)
engine_scan_kernel(const float4* __restrict__ rec_f,
                   const int32_t* __restrict__ rec_w,
                   const float* __restrict__ params,
                   const int32_t* __restrict__ period,
                   const int32_t* __restrict__ n_steps,
                   const int32_t* __restrict__ ckpt, float* __restrict__ out,
                   int B, const int32_t* __restrict__ rec_x,
                   float* __restrict__ acc_out,
                   float4* __restrict__ rec_out) {
  __shared__ float st[N_SLOTS][WARP];
  extern __shared__ float4 ring_raw[];
  const int t = threadIdx.x;
  const int b = blockIdx.x * WARP + t;
  if (b >= B) return;  // no block-wide barrier below: safe to leave early
  char* col = reinterpret_cast<char*>(&st[0][t]);
  for (int s = 0; s < N_SLOTS; ++s) st[s][t] = 0.0f;

  const float* p = params + (size_t)b * N_PARAMS;
  const int phys_cap = (int)p[1] * ROW, rob_cap = (int)p[2] * ROW,
            q_cap = (int)p[3] * ROW;   // capacities, in ring bytes
  const float dispatch_lat = p[11];
  const bool ooo = p[12] > 0.0f;

  const int T = n_steps[b], ck = ckpt[b];
  // vector, arithmetic, memory allocations so far, in ring bytes
  int nv = 0, na = 0, nm = 0;
  float t_scalar = 0.0f, lane_free = 0.0f, vmu_free = 0.0f, last_aq = 0.0f,
        last_mq = 0.0f, last_commit = 0.0f, scalar_res = 0.0f,
        busy_lane = 0.0f, busy_vmu = 0.0f;
  float ck_time = 0.0f, ck_lane = 0.0f, ck_vmu = 0.0f;
  // the collect build's accumulators (two registers and this thread's
  // column of the rows A_*) and its record pointer
  int32_t* ring_w = reinterpret_cast<int32_t*>(ring_raw + STAGES * K * WARP);
  float acc_work = 0.0f, acc_dep = 0.0f;
  float* acc_rows =
      reinterpret_cast<float*>(ring_w + 2 * STAGES * K * WARP) + t;
  if constexpr (COLLECT)
    for (int k = 0; k < ACC_ROWS; ++k) acc_rows[k * WARP] = 0.0f;
  float4* rec_o = rec_out + b;
  if (T > 0) {   // a lane with no steps reads no record (P may be 0)
    Stream in{ring_raw + t, ring_w + t, rec_f + b, rec_w + b,
              0, max(period[b], 1), B,
              COLLECT ? ring_w + STAGES * K * WARP + t : nullptr,
              COLLECT ? rec_x + b : nullptr};
    for (int j = 0; j < TILES_AHEAD; ++j) fetch_tile<COLLECT>(in, j);

    // the current record and the five state reads it needs, read before
    // the previous step's stores and forwarded (all zero at step 0)
    cp_async_wait<TILES_AHEAD - 1>();  // tile 0 has landed
    float4 xf = in.f[0];
    int xw = in.w[0];
    int xx = COLLECT ? in.x[0] : 0;
    float r1 = 0.0f, r2 = 0.0f, rob_slot = 0.0f, phys_slot = 0.0f,
          q_slot = 0.0f;

    // one step: record r (xf, xw) with its state reads; reads record r + 1
    // (ring row rn) and its state reads before this step's stores
    auto step = [&](int r, int rn) {
      const bool vec = xw & F_VEC, mem = xw & F_MEM, arith = xw & F_ARITH;

      // ---- the next record and its state reads, before this step's stores
      const float4 nf = in.f[rn * WARP];
      const int nw = in.w[rn * WARP];
      const int nx = COLLECT ? in.x[rn * WARP] : 0;
      const int nv2 = nv + (xw & F_VEC) * (ROW / F_VEC);
      const int na2 = na + (xw & F_ARITH) * (ROW / F_ARITH);
      const int nm2 = nm + (xw & F_MEM) * (ROW / F_MEM);
      const bool nmem = nw & F_MEM;
      const int ns1 = nw & (SLOT_BITS), ns2 = (nw >> 8) & SLOT_BITS;
      // a ring slot read before its first write holds 0, as the
      // reference's guarded read gives while count < capacity (<= 64)
      const int i_rob = ROB0 * ROW + ((nv2 - rob_cap) & RING_MASK);
      const int i_phys = ROB0 * ROW + ((nv2 - phys_cap) & RING_MASK);
      const int i_q = nmem ? MQ0 * ROW + ((nm2 - q_cap) & RING_MASK)
                           : AQ0 * ROW + ((na2 - q_cap) & RING_MASK);
      const float l_r1 = at(col, ns1), l_r2 = at(col, ns2);
      const float l_rob = at(col, i_rob), l_phys = at(col, i_phys),
                  l_q = at(col, i_q);

      // ---- this step: scalar clock, then the vector instruction's times
      const float t_new =
          fmaxf(t_scalar, (xw & F_DEP) ? scalar_res : -INFINITY) + xf.x;
      const float dispatch = fmaxf(fmaxf(t_new + dispatch_lat, rob_slot),
                                   fmaxf(phys_slot, q_slot));
      const float inorder = ooo ? -INFINITY : (mem ? last_mq : last_aq);
      const float fu_free = mem ? vmu_free : lane_free;
      const float issue =
          fmaxf(fmaxf(dispatch, inorder), fmaxf(fmaxf(r1, r2), fu_free));
      const float complete = (issue + xf.y) + xf.z;
      const float commit = fmaxf(complete, last_commit);

      // ---- the collect build: attribute the frontier's advance
      if constexpr (COLLECT) {
        const bool dep = xw & F_DEP;
        const float f_old = fmaxf(t_scalar, last_commit);
        const float t_wait = fmaxf(t_scalar, dep ? scalar_res : -INFINITY);
        // a scalar block (t_new = its end): the wait on a vector result
        // and the work beyond the frontier, one sum into one slot
        const float dep_vis = fmaxf(t_wait - f_old, 0.0f);
        const float work_vis = fmaxf(t_new - fmaxf(t_wait, f_old), 0.0f);
        const float sc_vis = dep_vis + work_vis;
        // a vector instruction (t_new = its scalar commit): the wait
        // before issue, the execution and the scalar pipe beyond it
        const float wait_vis = fmaxf(issue - f_old, 0.0f);
        const float exec_vis = fmaxf(complete - fmaxf(issue, f_old), 0.0f);
        const float tail_vis = fmaxf(t_new - fmaxf(complete, f_old), 0.0f);
        // the binding constraint, lowest precedence first
        int cause = issue == inorder ? S_INORDER : S_DISPATCH;
        cause = issue == fu_free ? (mem ? S_VMU_WAIT : S_LANE_WAIT) : cause;
        cause = issue == fmaxf(r1, r2) ? S_RAW : cause;
        cause = issue == q_slot ? (mem ? S_MQ_FULL : S_AQ_FULL) : cause;
        cause = issue == phys_slot ? S_PHYS_FULL : cause;
        cause = issue == rob_slot ? S_ROB_FULL : cause;
        acc_work = acc_work + (vec ? tail_vis : dep ? 0.0f : sc_vis);
        if (dep) acc_dep = acc_dep + sc_vis;
        // the three rows (a scalar record's are the dummies) read together,
        // then written back: they never coincide
        float* const aw =
            acc_rows + (vec ? A_WAIT + cause - S_DISPATCH : A_WAIT_NONE) * WARP;
        float* const ae =
            acc_rows + (vec ? A_EXEC + (xx & 15) : A_EXEC_NONE) * WARP;
        float* const ao =
            acc_rows + (arith ? A_OCC + (xx >> 4) : A_OCC_NONE) * WARP;
        const float w0 = *aw, e0 = *ae, o0 = *ao;
        *aw = w0 + wait_vis;
        *ae = e0 + exec_vis;
        *ao = o0 + xf.w;
        const int rec_cause = vec ? cause : dep ? S_DEP_SCALAR : S_SCALAR_WORK;
        __stcs(rec_o, make_float4(vec ? t_new : t_scalar,
                                  vec ? issue : t_wait,
                                  vec ? complete : t_new,
                                  __int_as_float(rec_cause)));
        rec_o += B;
      }

      // ---- stores, and the same values forwarded into the next reads
      const int w_reg = (xw >> 16) & SLOT_BITS;   // DUMMY without a dst
      const int w_rob = ROB0 * ROW + (nv & RING_MASK);
      const int w_q = mem ? MQ0 * ROW + (nm & RING_MASK)
                          : AQ0 * ROW + (na & RING_MASK);
      at(col, w_reg) = complete;
      if (vec) {
        at(col, w_rob) = commit;
        at(col, w_q) = issue;
      }
      r1 = ns1 == w_reg ? complete : l_r1;
      r2 = ns2 == w_reg ? complete : l_r2;
      rob_slot = vec && i_rob == w_rob ? commit : l_rob;
      phys_slot = vec && i_phys == w_rob ? commit : l_phys;
      q_slot = vec && i_q == w_q ? issue : l_q;

      // ---- the carry
      t_scalar = t_new;
      lane_free = arith ? complete : lane_free;
      vmu_free = mem ? complete : vmu_free;
      last_aq = arith ? issue : last_aq;
      last_mq = mem ? issue : last_mq;
      last_commit = vec ? commit : last_commit;
      scalar_res = (xw & F_RES) ? complete : scalar_res;
      busy_lane = busy_lane + (arith ? xf.w : 0.0f);
      busy_vmu = busy_vmu + (mem ? xf.w : 0.0f);
      nv = nv2;
      na = na2;
      nm = nm2;
      xf = nf;
      xw = nw;
      if constexpr (COLLECT) xx = nx;
      if (r + 1 == ck) {
        ck_time = fmaxf(t_scalar, last_commit);
        ck_lane = busy_lane;
        ck_vmu = busy_vmu;
      }
    };

    for (int j = 0; j * K < T; ++j) {
      // tiles <= j + 1 have landed (the last step of tile j reads the
      // first record of j + 1); the stage of tile j - 1 is free for j + 3
      cp_async_wait<TILES_AHEAD - 2>();
      fetch_tile<COLLECT>(in, j + TILES_AHEAD);
      const int r0 = j * K, s1 = (j % STAGES) * K + 1;
      if (r0 + K <= T) {   // a whole tile: no end test a step
#pragma unroll
        for (int k = 0; k < K; ++k) step(r0 + k, (s1 + k) % (STAGES * K));
      } else {
        for (int k = 0; r0 + k < T; ++k)
          step(r0 + k, (s1 + k) % (STAGES * K));
      }
    }
    cp_async_wait<0>();  // no copy outlives the block
  }
  out[0 * B + b] = fmaxf(t_scalar, last_commit);
  out[1 * B + b] = t_scalar;
  out[2 * B + b] = last_commit;
  out[3 * B + b] = busy_lane;
  out[4 * B + b] = busy_vmu;
  out[5 * B + b] = ck_time;
  out[6 * B + b] = ck_lane;
  out[7 * B + b] = ck_vmu;
  if constexpr (COLLECT) {
    acc_out[S_SCALAR_WORK * B + b] = acc_work;
    acc_out[S_DEP_SCALAR * B + b] = acc_dep;
    for (int k = S_DISPATCH; k < S_EXEC; ++k)
      acc_out[k * B + b] = acc_rows[(A_WAIT + k - S_DISPATCH) * WARP];
    for (int k = S_EXEC; k < N_STALL; ++k)
      acc_out[k * B + b] = acc_rows[(A_EXEC + k - S_EXEC) * WARP];
    for (int k = 0; k < N_OCC; ++k)
      acc_out[(N_STALL + k) * B + b] = acc_rows[(A_OCC + k) * WARP];
  }
}

template <bool COLLECT>
int prepass_launch(const int32_t* xi, const float* xf, const float* params,
                   const float* consts, void* rec_f, int32_t* rec_w,
                   int32_t* rec_x, int P, int B, void* stream) {
  const long long PB = (long long)P * B;
  if (PB == 0) return 0;
  const long long blocks = (PB + 255) / 256;
  engine_prepass_kernel<COLLECT><<<(unsigned)blocks, 256, 0,
                                   static_cast<cudaStream_t>(stream)>>>(
      xi, xf, params, consts, static_cast<float4*>(rec_f), rec_w, rec_x, PB,
      B);
  return static_cast<int>(cudaGetLastError());
}

template <bool COLLECT>
int steps_launch(const void* rec_f, const int32_t* rec_w,
                 const int32_t* rec_x, const float* params,
                 const int32_t* period, const int32_t* n_steps,
                 const int32_t* ckpt, float* out, float* acc, void* rec,
                 int B, void* stream) {
  constexpr int bytes = ring_bytes<COLLECT>();
  const cudaError_t err = cudaFuncSetAttribute(
      engine_scan_kernel<COLLECT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (B + WARP - 1) / WARP;
  engine_scan_kernel<COLLECT><<<blocks, WARP, bytes,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(rec_f), rec_w, params, period, n_steps, ckpt,
      out, B, rec_x, acc, static_cast<float4*>(rec));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The pre-pass: rec_f float4 [P, B], rec_w int32 [P, B] from the trace
// tables.  Launches on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int engine_prepass_launch(const int32_t* xi, const float* xf,
                                     const float* params, const float* consts,
                                     void* rec_f, int32_t* rec_w, int P,
                                     int B, void* stream) {
  return prepass_launch<false>(xi, xf, params, consts, rec_f, rec_w, nullptr,
                               P, B, stream);
}

// The collect build's pre-pass: also rec_x int32 [P, B].
extern "C" int engine_prepass_collect_launch(
    const int32_t* xi, const float* xf, const float* params,
    const float* consts, void* rec_f, int32_t* rec_w, int32_t* rec_x, int P,
    int B, void* stream) {
  return prepass_launch<true>(xi, xf, params, consts, rec_f, rec_w, rec_x, P,
                              B, stream);
}

// The scan over the pre-pass's records into out float32 [8, B].  Launches
// on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int engine_steps_launch(const void* rec_f, const int32_t* rec_w,
                                   const float* params, const int32_t* period,
                                   const int32_t* n_steps,
                                   const int32_t* ckpt, float* out, int B,
                                   void* stream) {
  return steps_launch<false>(rec_f, rec_w, nullptr, params, period, n_steps,
                             ckpt, out, nullptr, nullptr, B, stream);
}

// The collect build's scan: also acc float32 [23, B] (the 19 STALL_KINDS
// accumulators, then the lane-busy cycles per FU class) and rec float4
// [T, B] (rows below each lane's n_steps written; the caller zeroes the
// rest).
extern "C" int engine_steps_collect_launch(
    const void* rec_f, const int32_t* rec_w, const int32_t* rec_x,
    const float* params, const int32_t* period, const int32_t* n_steps,
    const int32_t* ckpt, float* out, float* acc, void* rec, int B,
    void* stream) {
  return steps_launch<true>(rec_f, rec_w, rec_x, params, period, n_steps,
                            ckpt, out, acc, rec, B, stream);
}
