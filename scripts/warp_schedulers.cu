// Which warps of a block share warp 0's scheduler (issue port) on the card.
//
//     nvcc -gencode arch=compute_90a,code=sm_90a -O3 -o build/warp_schedulers \
//         scripts/warp_schedulers.cu && build/warp_schedulers
//
// One block on one SM: warp 0 and one other warp w each run the same
// issue-bound loop (8 independent multiply-add chains); the line prints
// warp 0's cycles for each w.  A warp on a scheduler of its own leaves warp
// 0's time as it is alone (w = 0); a warp on warp 0's scheduler doubles it.
// It also prints each warp's %warpid (its slot on the SM) for blocks of 3
// and 4 warps.  The engine scan's collect build puts its consumer warps
// beside the recurrence's (csrc/engine_scan.cu), relying on warps 1-3 of a
// block issuing on schedulers other than warp 0's.
#include <cstdio>
#include <cuda_runtime.h>

constexpr int ITERS = 20000;

__global__ void issue_bound(int busy, float* out, long long* cycles,
                            unsigned* slot) {
  const int w = threadIdx.x / 32;
  float a[8];
  for (int i = 0; i < 8; ++i) a[i] = threadIdx.x + i;
  __syncthreads();
  const long long t0 = clock64();
  if (w == 0 || w == busy) {
    for (int i = 0; i < ITERS; ++i) {
#pragma unroll
      for (int j = 0; j < 8; ++j) a[j] = a[j] * 0.999f + 1.0f;
    }
  }
  const long long t1 = clock64();
  float s = 0.0f;
  for (int i = 0; i < 8; ++i) s += a[i];
  out[threadIdx.x] = s;
  if (threadIdx.x % 32 == 0) {
    cycles[w] = t1 - t0;
    asm volatile("mov.u32 %0, %%warpid;" : "=r"(slot[w]));
  }
}

int main() {
  float* out;
  long long* cycles;
  unsigned* slot;
  cudaMalloc(&out, 1024 * sizeof(float));
  cudaMalloc(&cycles, 32 * sizeof(long long));
  cudaMalloc(&slot, 32 * sizeof(unsigned));
  for (int warps : {2, 3, 4, 8}) {
    printf("%d warps a block, warp 0's cycles with warp w busy too:", warps);
    unsigned h_slot[32];
    for (int w = 0; w < warps; ++w) {
      issue_bound<<<1, warps * 32>>>(w, out, cycles, slot);
      long long h[32];
      cudaMemcpy(h, cycles, sizeof(h), cudaMemcpyDeviceToHost);
      cudaMemcpy(h_slot, slot, sizeof(h_slot), cudaMemcpyDeviceToHost);
      printf(" w=%d: %lld", w, h[0]);
    }
    printf("; %%warpid of warps 0..%d:", warps - 1);
    for (int w = 0; w < warps; ++w) printf(" %u", h_slot[w]);
    printf("\n");
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) {
    printf("CUDA error: %s\n", cudaGetErrorString(err));
    return 1;
  }
  return 0;
}
