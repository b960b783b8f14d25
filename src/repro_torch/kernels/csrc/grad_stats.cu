// Per-row gradient statistics (eq. 3 handshake) for sm_90a.
//
// Replaces the Pallas kernel src/repro/kernels/grad_stats.py::grad_stats
// (_kernel): out[r] = (sum_d g[r,d], sum_d g[r,d]^2) in f32, rows [R, D] ->
// [R, 2].
//
// The Pallas kernel walks D as a sequential grid and carries the [U, 2] sum
// in one revisited output block (grad_stats.py:25-33).  Hopper's blocks run
// in parallel and in no order, so nothing can be carried from one block to
// the next.  This kernel gives each row its own block instead: the block's
// threads stride over the row with coalesced reads, keep (s1, s2) in f32
// registers, and finish with a warp-shuffle tree and one pass over the
// per-warp partials in shared memory.  The reduction order is fixed by the
// launch shape, so the result is deterministic and needs no atomics and no
// second pass.  On the sweep's main path R = S*U rows (40 at the Fig. 3
// shape) of D = 50 890: 40 blocks on 132 SMs, enough for a pass that is
// bound by bytes (R*D elements read once over 3.35 TB/s) and, at this size,
// by launch latency.  Splitting long rows over several blocks is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
grad_stats_kernel(const T* __restrict__ grads,  // [R, D]
                  float* __restrict__ out,      // [R, 2]
                  int64_t d_n) {
  __shared__ float part1[WARPS];
  __shared__ float part2[WARPS];
  const T* g = grads + (int64_t)blockIdx.x * d_n;
  float s1 = 0.0f, s2 = 0.0f;
  for (int64_t d = threadIdx.x; d < d_n; d += THREADS) {
    const float x = to_f32(g[d]);
    s1 += x;
    s2 = fmaf(x, x, s2);
  }
  for (int off = 16; off > 0; off >>= 1) {
    s1 += __shfl_down_sync(0xffffffffu, s1, off);
    s2 += __shfl_down_sync(0xffffffffu, s2, off);
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    part1[warp] = s1;
    part2[warp] = s2;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float t1 = 0.0f, t2 = 0.0f;
    for (int i = 0; i < WARPS; ++i) {
      t1 += part1[i];
      t2 += part2[i];
    }
    out[2 * (int64_t)blockIdx.x] = t1;
    out[2 * (int64_t)blockIdx.x + 1] = t2;
  }
}

constexpr int F32 = 0;
constexpr int BF16 = 1;

}  // namespace

extern "C" {

// grads [R, D] (dtype code 0 = f32, 1 = bf16) -> out [R, 2] f32.  Returns
// cudaGetLastError() after the launch.
int grad_stats(const void* grads, void* out, int64_t r_n, int64_t d_n,
               int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((unsigned)r_n);
  if (dtype == F32) {
    grad_stats_kernel<float><<<grid, THREADS, 0, st>>>(
        static_cast<const float*>(grads), static_cast<float*>(out), d_n);
  } else if (dtype == BF16) {
    grad_stats_kernel<__nv_bfloat16><<<grid, THREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(grads), static_cast<float*>(out),
        d_n);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // extern "C"
