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
// kernel it was.  None of the attribution feeds back into the recurrence,
// and a study's block is one warp on one of an SM's four schedulers, so
// the collect build takes the attribution off the recurrence's warp (warp
// specialization: three warps a block of 32 lanes, on three schedulers,
// thread t of each on lane t):
//  * warp 0, the producer, runs the default step and adds only the step's
//    records, two 16-byte shared stores into a ring of C_TILES tiles of K
//    steps: (t_new, issue, complete, the record's flag word) and the issue
//    time's candidates it holds (the ROB, rename and queue slots it read
//    and max(r1, r2), read before this step's stores overwrite the
//    forwarded slots);
//  * warps 1 and 2, the consumers, read the ring behind it in step order,
//    each with its own copies of the producer's carry that the records
//    give (t_scalar, last_commit, scalar_res: the same float32 operations
//    on the same values, so the same bits), the frontier
//    F = max(t_scalar, last_commit) before a step and the visible pieces of
//    the step's advance (dep / work for a scalar block; wait / exec / tail
//    for a vector instruction).  Warp 1 finds the wait's cause -- the
//    binding candidate in the reference's precedence, the FU and in-order
//    candidates from its copies of lane_free, vmu_free, last_aq and
//    last_mq -- adds the nine wait causes and makes the timeline's
//    streaming store, rec[step][lane] = (start, issue, complete, cause),
//    512 neighbouring bytes a warp; warp 2 adds scalar_work, dep_scalar,
//    the eight execution classes and the 4 lane-busy sums per FU class,
//    the record's classes (rec_x) and busy term (rec_f.w) streamed by
//    cp.async from the pre-pass's records into its own stage.  Each slot's
//    sum is a register and gets one select-add a step in step order;
//    adding the reference's zeros to the untouched slots changes no bit,
//    so they are not touched.  The consumers' steps are a loop that is not
//    unrolled: the SM's instruction cache is shared, and unrolled consumers
//    made the producer's warp wait on it (scripts/engine_scan_variants.py
//    --collect, PERF.md).
//  * The hand-off is a tile at a time on named barriers, one pair a ring
//    slot: the producer arrives on FULL(s) after its tile's records and,
//    C_TILES tiles later, syncs on EMPTY(s) before it writes the slot again;
//    the consumers sync on FULL(s) and arrive on EMPTY(s) when they are
//    done with a tile the producer will write again.  Every thread of the
//    three warps runs the block's longest lane's tiles (a lane past B or
//    past its own n_steps runs no step in them), so every barrier sees all
//    three warps.
// Its producer is bound like the default build (one serial chain a lane,
// the step's instructions issued by one warp a scheduler), plus the two
// stores; the timeline's bytes (16 B a record, ~5 us at the study's 1.1 M
// records at 3.35 TB/s) and the consumers' work run beside it.
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
// the collect build's record ring between its two warps: C_TILES tiles of
// K records a lane; the named barriers FULL(s) and EMPTY(s) of ring slot s
// (barrier 0 is __syncthreads'), each counted by both warps
constexpr int C_TILES = 4, BAR_FULL = 1, BAR_EMPTY = BAR_FULL + C_TILES;
constexpr int C_THREADS = 3 * WARP;
// the stage of class words and busy terms of the collect build's third
// warp: X_STAGES tiles, requested X_STAGES - 1 tiles ahead
constexpr int X_STAGES = 3;

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

// Named barrier `id` of `n` threads: wait for the others, or only arrive.
// The forms without .aligned: a warp's threads may reach them apart (after
// steps of lanes of different lengths).
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("barrier.sync %0, %1;" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("barrier.arrive %0, %1;" ::"r"(id), "r"(n) : "memory");
}

// This lane's record stream: the ring of STAGES x K records (this thread's
// column of it: ring row i at f[i * WARP], w[i * WARP]) and the row of the
// next record to request.
struct Stream {
  float4* f;
  int32_t* w;
  const float4* src_f;   // the lane's next record in rec_f / rec_w
  const int32_t* src_w;
  int pos, per;
  long long stride;      // B: one row of rec_f / rec_w
};

// Request tile `tile` (steps tile * K ..) in the lane's loop order; one
// commit group a tile.  Rows past n_steps are copied too (they are valid
// rows of the lane's body and are never read), so there is no branch.
__device__ __forceinline__ void fetch_tile(Stream& s, int tile) {
  const int s0 = (tile % STAGES) * K;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    cp_async<16>(s.f + (s0 + k) * WARP, s.src_f);
    cp_async<4>(s.w + (s0 + k) * WARP, s.src_w);
    const bool wrap = ++s.pos == s.per;
    const long long step = wrap ? -(s.per - 1) * s.stride : s.stride;
    s.pos = wrap ? 0 : s.pos;
    s.src_f += step;
    s.src_w += step;
  }
  cp_async_commit();
}

// The dynamic shared memory: the record ring, a float4 and an int32 a
// record; for the collect build then the ring of records between its warps
// (two float4s a step) and its third warp's stage of class words and busy
// terms.
template <bool COLLECT>
constexpr int ring_bytes() {
  return STAGES * K * WARP * (int)(sizeof(float4) + sizeof(int32_t)) +
         (COLLECT ? 2 * C_TILES * K * WARP * (int)sizeof(float4) +
                        X_STAGES * 2 * K * WARP * (int)sizeof(int32_t)
                  : 0);
}

// The collect build's consumer warps (warps 1 and 2): the cycle
// attribution of lane b from the producer's records, in step order, for
// the block's `tiles` tiles.  A step's records are two float4s in the ring
// `ring` (this thread's column): (t_new, issue, complete, the record's flag
// word) and, C_TILES * K rows on, the issue time's candidates the producer
// holds (the ROB, rename and queue slots it read, max(r1, r2)).  Each warp
// keeps its own copy of the producer's carry that the records give (the
// same float32 operations on the same values, so the same bits) and the
// frontier F = max(t_scalar, last_commit) before a step.  ROLE 0 (warp 1)
// finds the wait's cause -- the binding candidate in the reference's
// precedence, the FU and in-order candidates from its copies of lane_free,
// vmu_free, last_aq and last_mq -- adds the wait causes and writes the
// timeline, rec [n_steps, B] float4 (only rows below the lane's n_steps);
// ROLE 1 (warp 2) adds scalar_work, dep_scalar, the execution classes and
// the FU sums, with the record's class word (rec_x) and busy term
// (rec_f.w) copied by cp.async from the pre-pass's records into `stage`
// (this thread's column of X_STAGES tiles of K pairs), two tiles ahead.
// Each writes its slots of acc [N_STALL + N_OCC, B].  The sums are
// registers and every add is a select (no branch), each slot its own
// chain.  A step is a loop iteration (the loop is not unrolled: three
// warps' unrolled loops outgrow what the SM's instruction cache keeps, and
// the recurrence's warp then waits on it, scripts/engine_scan_variants.py
// --collect), the next step's words read from shared memory a step ahead.
template <int ROLE>
__device__ __forceinline__ void attribute_lane(
    const float4* ring, int32_t* stage, const float* __restrict__ params,
    const float4* __restrict__ rec_f, const int32_t* __restrict__ rec_x,
    const int32_t* __restrict__ period, int b, int bp, int T, int tiles,
    int B, float* __restrict__ acc_out, float4* __restrict__ rec_out) {
  // this warp's slots: ROLE 0 the wait causes (S_DISPATCH..); ROLE 1
  // scalar_work and dep_scalar, then S_EXEC.. (the execution classes and
  // the FU sums)
  constexpr int NX = N_STALL + N_OCC - S_EXEC;
  constexpr int NA = ROLE == 0 ? S_EXEC - S_DISPATCH : S_DISPATCH + NX;
  float acc[NA];
#pragma unroll
  for (int k = 0; k < NA; ++k) acc[k] = 0.0f;
  float t_scalar = 0.0f, last_commit = 0.0f, scalar_res = 0.0f;
  float lane_free = 0.0f, vmu_free = 0.0f, last_aq = 0.0f, last_mq = 0.0f;
  const bool ooo = params[(size_t)bp * N_PARAMS + 12] > 0.0f;
  float4* rec_o = rec_out + b;
  // ROLE 1: the lane's pre-pass rows in its loop order (row r % period at
  // step r; a lane past B reads lane B - 1's, a lane without steps row 0),
  // a tile's class words then its busy terms into stage slot tile % X_STAGES
  const int per = max(period[bp], 1);
  const float4* src_f = rec_f + bp;
  const int32_t* src_x = rec_x + bp;
  int pos = 0;
  auto fetch = [&](int tile) {
    int32_t* dst = stage + (tile % X_STAGES) * 2 * K * WARP;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      cp_async<4>(dst + k * WARP, src_x);
      cp_async<4>(dst + (K + k) * WARP, &src_f->w);
      const bool wrap = ++pos == per;
      const long long d = wrap ? -(long long)(per - 1) * B : B;
      pos = wrap ? 0 : pos;
      src_f += d;
      src_x += d;
    }
    cp_async_commit();
  };

  auto step = [&](float4 ra, float4 rb, int xx, float busy) {
    const int xw = __float_as_int(ra.w);
    const bool vec = xw & F_VEC, dep = xw & F_DEP, mem = xw & F_MEM,
               arith = xw & F_ARITH, res = xw & F_RES;
    const float t_new = ra.x, issue = ra.y, complete = ra.z;
    const float f_old = fmaxf(t_scalar, last_commit);
    const float t_wait = fmaxf(t_scalar, dep ? scalar_res : -INFINITY);
    if constexpr (ROLE == 0) {
      // the binding constraint, lowest precedence first
      const float inorder = ooo ? -INFINITY : (mem ? last_mq : last_aq);
      const float fu_free = mem ? vmu_free : lane_free;
      int cause = issue == inorder ? S_INORDER : S_DISPATCH;
      cause = issue == fu_free ? (mem ? S_VMU_WAIT : S_LANE_WAIT) : cause;
      cause = issue == rb.w ? S_RAW : cause;
      cause = issue == rb.z ? (mem ? S_MQ_FULL : S_AQ_FULL) : cause;
      cause = issue == rb.y ? S_PHYS_FULL : cause;
      cause = issue == rb.x ? S_ROB_FULL : cause;
      // a vector instruction: the wait before issue
      const float wait_vis = fmaxf(issue - f_old, 0.0f);
      const int wait_k = vec ? cause - S_DISPATCH : -1;
#pragma unroll
      for (int k = 0; k < NA; ++k)
        acc[k] = wait_k == k ? acc[k] + wait_vis : acc[k];
      const int rec_cause = vec ? cause : dep ? S_DEP_SCALAR : S_SCALAR_WORK;
      __stcs(rec_o, make_float4(vec ? t_new : t_scalar, vec ? issue : t_wait,
                                vec ? complete : t_new,
                                __int_as_float(rec_cause)));
      rec_o += B;
      lane_free = arith ? complete : lane_free;
      vmu_free = mem ? complete : vmu_free;
      last_aq = arith ? issue : last_aq;
      last_mq = mem ? issue : last_mq;
    } else {
      // a scalar block (t_new = its end): the wait on a vector result and
      // the work beyond the frontier, one sum into one slot
      const float dep_vis = fmaxf(t_wait - f_old, 0.0f);
      const float work_vis = fmaxf(t_new - fmaxf(t_wait, f_old), 0.0f);
      const float sc_vis = dep_vis + work_vis;
      // a vector instruction (t_new = its scalar commit): the execution
      // and the scalar pipe beyond it, and the lanes' busy cycles of an
      // arithmetic record's FU class
      const float exec_vis = fmaxf(complete - fmaxf(issue, f_old), 0.0f);
      const float tail_vis = fmaxf(t_new - fmaxf(complete, f_old), 0.0f);
      acc[0] = acc[0] + (vec ? tail_vis : dep ? 0.0f : sc_vis);
      acc[1] = dep ? acc[1] + sc_vis : acc[1];
      const int exec_k = vec ? S_DISPATCH + (xx & 15) : -1;
      const int occ_k = arith ? S_DISPATCH + N_STALL - S_EXEC + (xx >> 4) : -1;
#pragma unroll
      for (int k = S_DISPATCH; k < S_DISPATCH + N_STALL - S_EXEC; ++k)
        acc[k] = exec_k == k ? acc[k] + exec_vis : acc[k];
#pragma unroll
      for (int k = S_DISPATCH + N_STALL - S_EXEC; k < NA; ++k)
        acc[k] = occ_k == k ? acc[k] + busy : acc[k];
    }
    // the producer's carry, from the same values
    t_scalar = t_new;
    last_commit = vec ? fmaxf(complete, last_commit) : last_commit;
    scalar_res = res ? complete : scalar_res;
  };

  if constexpr (ROLE == 1) {
    for (int j = 0; j < X_STAGES - 1; ++j)
      if (j < tiles) fetch(j); else cp_async_commit();
  }
  for (int j = 0; j < tiles; ++j) {
    const int n = min(max(T - j * K, 0), K);
    const int* sx = stage + (j % X_STAGES) * 2 * K * WARP;
    if constexpr (ROLE == 1) {
      // tile j's group has landed; tile j + X_STAGES - 1 is requested
      if (j + X_STAGES - 1 < tiles) fetch(j + X_STAGES - 1);
      else cp_async_commit();
      cp_async_wait<X_STAGES - 1>();
    }
    const int slot = j % C_TILES;
    bar_sync(BAR_FULL + slot, C_THREADS);
    const float4* ra = ring + slot * K * WARP;
    const float4* rb = ra + C_TILES * K * WARP;
    // step k's words, read one step ahead (the last read past the tile
    // is of a word of the ring that is not used)
    const float4 none = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    float4 r = ra[0], q = ROLE == 0 ? rb[0] : none;
    int x = ROLE == 1 ? sx[0] : 0;
    float w = ROLE == 1 ? __int_as_float(sx[K * WARP]) : 0.0f;
#pragma unroll 1
    for (int k = 0; k < n; ++k) {
      const int kn = (k + 1) % K;
      const float4 rn = ra[kn * WARP];
      const float4 qn = ROLE == 0 ? rb[kn * WARP] : none;
      const int xn = ROLE == 1 ? sx[kn * WARP] : 0;
      const float wn = ROLE == 1 ? __int_as_float(sx[(K + kn) * WARP]) : 0.0f;
      step(r, q, x, w);
      r = rn;
      q = qn;
      x = xn;
      w = wn;
    }
    // free the slot where the producer writes it again
    if (j + C_TILES < tiles) bar_arrive(BAR_EMPTY + slot, C_THREADS);
  }
  if constexpr (ROLE == 1) cp_async_wait<0>();  // no copy outlives the block
  if (b < B) {
#pragma unroll
    for (int k = 0; k < NA; ++k) {
      const int slot = ROLE == 0 ? S_DISPATCH + k
                       : k < S_DISPATCH ? k : S_EXEC + k - S_DISPATCH;
      acc_out[slot * B + b] = acc[k];
    }
  }
}

// COLLECT also takes rec_x and writes acc [N_STALL + N_OCC, B] and
// rec [n_steps, B] float4 (only rows below the lane's n_steps): warp 0 runs
// the recurrence, warp 1 attribute_lane.
template <bool COLLECT>
__global__ void __launch_bounds__(COLLECT ? C_THREADS : WARP)
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
  const int t = COLLECT ? threadIdx.x % WARP : threadIdx.x;
  const int b = blockIdx.x * WARP + t;
  int32_t* ring_w = reinterpret_cast<int32_t*>(ring_raw + STAGES * K * WARP);
  // the collect build: a lane past B keeps its thread for the barriers
  // (it reads lane B - 1's parameters and runs no step); both warps run
  // the block's longest lane's tiles, and the ring between them follows
  // the record ring
  const int bp = COLLECT ? min(b, B - 1) : b;
  int tiles = 0;
  float4* c_ring = nullptr;
  if constexpr (COLLECT) {
    c_ring = reinterpret_cast<float4*>(ring_w + STAGES * K * WARP);
    const int T = b < B ? n_steps[bp] : 0;
    tiles = (__reduce_max_sync(0xffffffffu, T) + K - 1) / K;
    int32_t* const stage =
        reinterpret_cast<int32_t*>(c_ring + 2 * C_TILES * K * WARP) + t;
    if (threadIdx.x >= 2 * WARP) {
      attribute_lane<1>(c_ring + t, stage, params, rec_f, rec_x, period, b,
                        bp, T, tiles, B, acc_out, rec_out);
      return;
    }
    if (threadIdx.x >= WARP) {
      attribute_lane<0>(c_ring + t, stage, params, rec_f, rec_x, period, b,
                        bp, T, tiles, B, acc_out, rec_out);
      return;
    }
  } else {
    if (b >= B) return;  // no block-wide barrier below: safe to leave early
  }
  char* col = reinterpret_cast<char*>(&st[0][t]);
  for (int s = 0; s < N_SLOTS; ++s) st[s][t] = 0.0f;

  const float* p = params + (size_t)bp * N_PARAMS;
  const int phys_cap = (int)p[1] * ROW, rob_cap = (int)p[2] * ROW,
            q_cap = (int)p[3] * ROW;   // capacities, in ring bytes
  const float dispatch_lat = p[11];
  const bool ooo = p[12] > 0.0f;

  const int T = COLLECT && b >= B ? 0 : n_steps[bp], ck = ckpt[bp];
  // the steps the loop runs: the lane's, or for the collect build the
  // block's tiles (a lane runs none past its own T)
  const int T_loop = COLLECT ? tiles * K : T;
  // vector, arithmetic, memory allocations so far, in ring bytes
  int nv = 0, na = 0, nm = 0;
  float t_scalar = 0.0f, lane_free = 0.0f, vmu_free = 0.0f, last_aq = 0.0f,
        last_mq = 0.0f, last_commit = 0.0f, scalar_res = 0.0f,
        busy_lane = 0.0f, busy_vmu = 0.0f;
  float ck_time = 0.0f, ck_lane = 0.0f, ck_vmu = 0.0f;
  if (T_loop > 0) {   // a lane with no steps reads no record (P may be 0)
    Stream in{ring_raw + t, ring_w + t, rec_f + bp, rec_w + bp,
              0, max(period[bp], 1), B};
    // the collect build's lanes without steps copy nothing (their commit
    // groups are empty)
    const bool fetch = !COLLECT || T > 0;
    for (int j = 0; j < TILES_AHEAD; ++j)
      if (fetch) fetch_tile(in, j); else cp_async_commit();

    // the current record and the five state reads it needs, read before
    // the previous step's stores and forwarded (all zero at step 0)
    cp_async_wait<TILES_AHEAD - 1>();  // tile 0 has landed
    float4 xf = in.f[0];
    int xw = in.w[0];
    float r1 = 0.0f, r2 = 0.0f, rob_slot = 0.0f, phys_slot = 0.0f,
          q_slot = 0.0f;
    // the collect build's next record in the ring between the warps
    float4* c_rec = nullptr;

    // one step: record r (xf, xw) with its state reads; reads record r + 1
    // (ring row rn) and its state reads before this step's stores
    auto step = [&](int r, int rn) {
      const bool vec = xw & F_VEC, mem = xw & F_MEM, arith = xw & F_ARITH;

      // ---- the next record and its state reads, before this step's stores
      const float4 nf = in.f[rn * WARP];
      const int nw = in.w[rn * WARP];
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

      // ---- the collect build: the step's records for the consumer warps,
      // its times and flag word, and the issue time's candidates read
      // before this step's stores overwrite the forwarded slots
      if constexpr (COLLECT) {
        *c_rec = make_float4(t_new, issue, complete, __int_as_float(xw));
        c_rec[C_TILES * K * WARP] =
            make_float4(rob_slot, phys_slot, q_slot, fmaxf(r1, r2));
        c_rec += WARP;
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
      if (r + 1 == ck) {
        ck_time = fmaxf(t_scalar, last_commit);
        ck_lane = busy_lane;
        ck_vmu = busy_vmu;
      }
    };

    for (int j = 0; j * K < T_loop; ++j) {
      // tiles <= j + 1 have landed (the last step of tile j reads the
      // first record of j + 1); the stage of tile j - 1 is free for j + 3
      cp_async_wait<TILES_AHEAD - 2>();
      if (fetch) fetch_tile(in, j + TILES_AHEAD); else cp_async_commit();
      if constexpr (COLLECT) {
        // the consumer is done with this ring slot's last tile
        if (j >= C_TILES) bar_sync(BAR_EMPTY + j % C_TILES, C_THREADS);
        c_rec = c_ring + (j % C_TILES) * K * WARP + t;
      }
      const int r0 = j * K, s1 = (j % STAGES) * K + 1;
      if (r0 + K <= T) {   // a whole tile: no end test a step
#pragma unroll
        for (int k = 0; k < K; ++k) step(r0 + k, (s1 + k) % (STAGES * K));
      } else {
        for (int k = 0; r0 + k < T; ++k)
          step(r0 + k, (s1 + k) % (STAGES * K));
      }
      if constexpr (COLLECT) bar_arrive(BAR_FULL + j % C_TILES, C_THREADS);
    }
    cp_async_wait<0>();  // no copy outlives the block
  }
  if (COLLECT && b >= B) return;
  out[0 * B + b] = fmaxf(t_scalar, last_commit);
  out[1 * B + b] = t_scalar;
  out[2 * B + b] = last_commit;
  out[3 * B + b] = busy_lane;
  out[4 * B + b] = busy_vmu;
  out[5 * B + b] = ck_time;
  out[6 * B + b] = ck_lane;
  out[7 * B + b] = ck_vmu;
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
  engine_scan_kernel<COLLECT><<<blocks, COLLECT ? C_THREADS : WARP, bytes,
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
