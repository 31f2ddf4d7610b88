// The vector-engine timing recurrence for Hopper (sm_90a), plain C interface.
//
// Replaces repro/core/engine.py:198-338 (_make_step, collect=False, under
// lax.scan, vmapped over configs) with repro/core/memory.py:150-165 inlined.
// One thread is one lane = one (trace, config) pair, and runs that lane's
// whole scan in this one launch.  Layouts are documented in
// repro_torch/kernels/engine_scan.py.
//
// Design.  The carry of a lane is the 32-entry register scoreboard, four
// 64-entry occupancy rings (ROB, physical registers, arithmetic queue,
// memory queue) and a dozen scalar clocks and counters.  Scoreboard and
// rings (288 floats) live in shared memory, column per thread:
// st[slot][lane], one warp per block, 36,864 B static.  A thread touches
// only its own column, so the 32 threads of a warp always hit 32 distinct
// banks.  The trace is read time-major ([field][row][lane]) and the next
// record is loaded before the current one is processed, so the loads
// overlap the step's dependent arithmetic.
//
// Bound on an H100: latency.  A lane is one serial chain of n_steps
// dependent steps and a study has a few hundred lanes, so the time is
// max(n_steps) x the critical-path latency of one step, not bytes or
// operations.
//
// Where this goes wrong, and what the code does about it:
//  * Ring index.  The reference reads ring[jnp.mod(count - capacity, 64)]
//    only when count >= capacity; jnp.mod is a floor mod, C's % truncates.
//    The read is guarded first, and inside the guard count - capacity >= 0,
//    where the two agree.
//  * jnp.select order.  exec_c picks the first true kind (all kinds are
//    distinct, so the switch is the same select); SCALAR_BLOCK and NOP take
//    the scalar branch, where complete/startup would be masked out anyway.
//  * FMA contraction.  Build with -fmad=false: every a*b+c is two
//    roundings, as in the reference.  Float literals carry the f suffix;
//    division is IEEE (nvcc's default; never --use_fast_math).
//  * ceil(log2(lanes)).  Computed exactly from frexpf; the reference's
//    log2 is exact for the integer lane counts the configs take.
//  * float64 parameters.  dram_line_cycles and scalar_scale arrive already
//    computed in float64 on the host and cast once, as the reference does.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARP = 32;
constexpr int MAX_RING = 64;
constexpr int N_REGS = 32;
constexpr int N_SLOTS = N_REGS + 4 * MAX_RING;
constexpr int N_PARAMS = 20;

// isa kinds
constexpr int SCALAR_BLOCK = 0, VARITH = 1, VLOAD = 2, VSTORE = 3, VSLIDE = 4,
              VREDUCE = 5, VMASK_SCALAR = 6, VMOVE = 7, NOP = 8;
constexpr int MEM_UNIT = 0, MEM_INDEXED = 2;
// rings
constexpr int ROB = 0, PHYS = 1, AQ = 2, MQ = 3;

struct Rec {
  int kind, vl, fu, n_src, src1, src2, dst, mpat, s_count, dep;
  float fp_kb;
};

__device__ __forceinline__ Rec load_rec(const int32_t* __restrict__ xi,
                                        const float* __restrict__ xf,
                                        size_t field_stride, size_t o) {
  Rec r;
  r.kind = __ldg(xi + 0 * field_stride + o);
  r.vl = __ldg(xi + 1 * field_stride + o);
  r.fu = __ldg(xi + 2 * field_stride + o);
  r.n_src = __ldg(xi + 3 * field_stride + o);
  r.src1 = __ldg(xi + 4 * field_stride + o);
  r.src2 = __ldg(xi + 5 * field_stride + o);
  r.dst = __ldg(xi + 6 * field_stride + o);
  r.mpat = __ldg(xi + 7 * field_stride + o);
  r.s_count = __ldg(xi + 8 * field_stride + o);
  r.dep = __ldg(xi + 9 * field_stride + o);
  r.fp_kb = __ldg(xf + o);
  return r;
}

__device__ __forceinline__ float pick4(const float* c, int i) {
  // a select chain keeps the per-class constants in registers
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

__global__ void __launch_bounds__(WARP)
engine_scan_kernel(const int32_t* __restrict__ xi, const float* __restrict__ xf,
                   const float* __restrict__ params,
                   const float* __restrict__ consts,
                   const int32_t* __restrict__ period,
                   const int32_t* __restrict__ n_steps,
                   const int32_t* __restrict__ ckpt, float* __restrict__ out,
                   int P, int B) {
  __shared__ float st[N_SLOTS][WARP];
  const int t = threadIdx.x;
  const int b = blockIdx.x * WARP + t;
  if (b >= B) return;  // no block-wide barrier below: safe to leave early
  for (int s = 0; s < N_SLOTS; ++s) st[s][t] = 0.0f;
#define REG(i) st[(i)][t]
#define RING(k, i) st[N_REGS + (k) * MAX_RING + (i)][t]

  const float* p = params + (size_t)b * N_PARAMS;
  const float lanes = p[0];
  const int phys_extra = (int)p[1], rob_entries = (int)p[2],
            q_entries = (int)p[3];
  const float read_ports = p[4], line_elems = p[5], mem_ports = p[6];
  const float lat_l1 = p[7], lat_l2 = p[8], lat_dram = p[9];
  const float scalar_scale = p[10], dispatch_lat = p[11];
  const bool ooo = p[12] > 0.0f;
  const float ring_f = p[13], l1_kb = p[14], l2_kb = p[15], mshrs = p[16];
  const float line_cyc = p[17], bmiss_extra = p[18], fuse_save = p[19];
  float sc[4], pd[4], ec[4];
  for (int i = 0; i < 4; ++i) {
    sc[i] = consts[i];
    pd[i] = consts[4 + i];
    ec[i] = consts[8 + i];
  }
  const float dram_mlp = consts[12], prefetch_depth = consts[13];
  const float sv_add = sc[0] * scalar_scale;
  const float hops =
      ring_f > 0.0f ? lanes - 1.0f : ceil_log2(fmaxf(lanes, 2.0f));

  int n_rob = 0, n_phys = 0, n_aq = 0, n_mq = 0;
  float t_scalar = 0.0f, lane_free = 0.0f, vmu_free = 0.0f, last_aq = 0.0f,
        last_mq = 0.0f, last_commit = 0.0f, scalar_res = 0.0f,
        busy_lane = 0.0f, busy_vmu = 0.0f;
  float ck_time = 0.0f, ck_lane = 0.0f, ck_vmu = 0.0f;

  const int T = n_steps[b], per = period[b], ck = ckpt[b];
  const size_t fs = (size_t)P * B;
  Rec cur{};
  if (T > 0) cur = load_rec(xi, xf, fs, (size_t)b);
  int pos = per > 1 ? 1 : 0;  // row of the next record
  for (int r = 0; r < T; ++r) {
    Rec nxt = cur;
    if (r + 1 < T) {
      nxt = load_rec(xi, xf, fs, (size_t)pos * B + b);
      if (++pos == per) pos = 0;
    }
    const Rec& x = cur;

    if (x.kind == SCALAR_BLOCK || x.kind == NOP) {
      // scalar block: per-class cost with the fusion / mispredict deltas
      const float t_wait = x.dep ? fmaxf(t_scalar, scalar_res) : t_scalar;
      const float s_cf = (float)x.s_count;
      const float fz = x.fu == 0 ? 1.0f : 0.0f;
      const float eff_cost = pick4(sc, x.fu) * (1.0f - fuse_save * fz);
      const float sc_time = s_cf * eff_cost * scalar_scale + s_cf * bmiss_extra;
      t_scalar = t_wait + sc_time;
    } else {
      const bool is_mem = x.kind == VLOAD || x.kind == VSTORE;
      const float t_scalar_v = t_scalar + sv_add;
      // guarded ring reads: the slot frees when the entry written
      // `capacity` allocations ago commits (issues, for the queues)
      const float rob_slot =
          n_rob >= rob_entries ? RING(ROB, (n_rob - rob_entries) % MAX_RING)
                               : 0.0f;
      const float phys_slot =
          n_phys >= phys_extra ? RING(PHYS, (n_phys - phys_extra) % MAX_RING)
                               : 0.0f;
      const int q = is_mem ? MQ : AQ;
      const int n_q = is_mem ? n_mq : n_aq;
      const float q_slot =
          n_q >= q_entries ? RING(q, (n_q - q_entries) % MAX_RING) : 0.0f;
      const float dispatch = fmaxf(fmaxf(t_scalar_v + dispatch_lat, rob_slot),
                                   fmaxf(phys_slot, q_slot));
      const float r1 = x.src1 >= 0 ? REG(x.src1) : 0.0f;
      const float r2 = x.src2 >= 0 ? REG(x.src2) : 0.0f;
      const float ops_ready = fmaxf(r1, r2);
      const float fu_free = is_mem ? vmu_free : lane_free;
      const float inorder = is_mem ? last_mq : last_aq;
      float issue = fmaxf(fmaxf(dispatch, ops_ready), fu_free);
      if (!ooo) issue = fmaxf(issue, inorder);

      // start-up: pipe depth + VRF read-port serialization (§3.2.4)
      const float startup = pick4(pd, x.fu) + ceilf((float)x.n_src / read_ports);
      const float vlf = (float)x.vl;
      const float per_lane = ceilf(vlf / lanes);
      float exec_c;
      switch (x.kind) {
        case VARITH: exec_c = per_lane * pick4(ec, x.fu); break;
        case VLOAD:
        case VSTORE:
          exec_c = vector_access_cycles(vlf, x.mpat, x.fp_kb, line_elems,
                                        l1_kb, l2_kb, mshrs, lat_l1, lat_l2,
                                        lat_dram, line_cyc, mem_ports,
                                        dram_mlp, prefetch_depth);
          break;
        case VSLIDE: exec_c = per_lane + 1.0f; break;
        case VREDUCE: exec_c = per_lane + hops + pick4(pd, x.fu); break;
        case VMASK_SCALAR: exec_c = per_lane + hops; break;
        default: exec_c = per_lane; break;  // VMOVE (kinds checked on host)
      }
      const float complete = issue + startup + exec_c;
      const float commit = fmaxf(complete, last_commit);

      t_scalar = t_scalar_v;
      if (x.dst >= 0) REG(x.dst) = complete;
      RING(ROB, n_rob % MAX_RING) = commit;
      ++n_rob;
      RING(PHYS, n_phys % MAX_RING) = commit;
      ++n_phys;
      RING(q, n_q % MAX_RING) = issue;
      if (is_mem) {
        ++n_mq;
        vmu_free = complete;
        last_mq = issue;
        busy_vmu = busy_vmu + (startup + exec_c);
      } else {
        ++n_aq;
        lane_free = complete;
        last_aq = issue;
        busy_lane = busy_lane + (startup + exec_c);
      }
      last_commit = commit;
      // vfirst/vpopc and reductions hand their result to the scalar core
      if (x.kind == VMASK_SCALAR || x.kind == VREDUCE) scalar_res = complete;
    }
    if (r + 1 == ck) {
      ck_time = fmaxf(t_scalar, last_commit);
      ck_lane = busy_lane;
      ck_vmu = busy_vmu;
    }
    cur = nxt;
  }
#undef REG
#undef RING
  out[0 * B + b] = fmaxf(t_scalar, last_commit);
  out[1 * B + b] = t_scalar;
  out[2 * B + b] = last_commit;
  out[3 * B + b] = busy_lane;
  out[4 * B + b] = busy_vmu;
  out[5 * B + b] = ck_time;
  out[6 * B + b] = ck_lane;
  out[7 * B + b] = ck_vmu;
}

}  // namespace

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Launches on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int engine_scan_launch(const int32_t* xi, const float* xf,
                                  const float* params, const float* consts,
                                  const int32_t* period, const int32_t* n_steps,
                                  const int32_t* ckpt, float* out, int P, int B,
                                  void* stream) {
  const int blocks = (B + WARP - 1) / WARP;
  engine_scan_kernel<<<blocks, WARP, 0, static_cast<cudaStream_t>(stream)>>>(
      xi, xf, params, consts, period, n_steps, ckpt, out, P, B);
  return static_cast<int>(cudaGetLastError());
}
