// Fused FLOA over-the-air combine (+ optional PS update) for sm_90a.
//
// Replaces the Pallas kernels of src/repro/kernels/floa_aggregate.py:
//   _batched_step_kernel (floa_step_batched)      -> floa_step_batched below
//   _batched_kernel      (floa_aggregate_batched) -> floa_aggregate_batched
//   _kernel              (floa_aggregate)         -> the same launch, S = 1
//
//   gagg[s,d]  = sum_u c[s,u] * G[s,u,d] + bias[s] + eps[s] * z[s,d]
//   w_new[s,d] = w[s,d] - alpha[s] * gagg[s,d]          (UPDATE only)
//
// What bounds it on an H100: bytes.  Each G entry is read once and used in
// one multiply-add (2 flops per 4 or 2 bytes), far below the card's
// ~20 flop/byte f32 ridge, so the floor is (S*U*D + 2-3*S*D) elements over
// 3.35 TB/s.  The Pallas kernel tiles D by 2048 and keeps a [U, 2048] slab in
// VMEM; Hopper has no such scratch to fill, so the design here is the plain
// streaming one: grid (ceil(D / BLOCK_D), S), one column d per thread, the
// lane's U coefficients staged once per block in shared memory, and the
// worker loop reading G[s, u, d] so that a warp touches 32 neighbouring
// columns of one row (coalesced 128-byte lines for f32).  The ragged edge
// d >= D is masked here; the wrappers never pad D.  Accumulation is f32 for
// f32 and bf16 inputs alike; with UPDATE the new weights are computed from
// the f32 aggregate, as the Pallas body does (floa_aggregate.py:161-163).
// Vectorised 16-byte loads, TMA and fusing into the gradient epilogue are
// left for later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCK_D = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <bool UPDATE, typename TG, typename TW>
__global__ void __launch_bounds__(BLOCK_D)
floa_combine_kernel(const float* __restrict__ coeffs,  // [S, U]
                    const TG* __restrict__ grads,      // [S, U, D]
                    const TG* __restrict__ noise,      // [S, D]
                    const float* __restrict__ bias,    // [S]
                    const float* __restrict__ eps,     // [S]
                    const float* __restrict__ alpha,   // [S] (UPDATE)
                    const TW* __restrict__ w,          // [S, D] (UPDATE)
                    TW* __restrict__ w_out,            // [S, D] (UPDATE)
                    TG* __restrict__ g_out,            // [S, D]
                    int u_n, int64_t d_n) {
  extern __shared__ float c_sh[];  // this lane's U coefficients
  const int s = blockIdx.y;
  for (int u = threadIdx.x; u < u_n; u += blockDim.x) {
    c_sh[u] = coeffs[(int64_t)s * u_n + u];
  }
  __syncthreads();

  const int64_t d = (int64_t)blockIdx.x * BLOCK_D + threadIdx.x;
  if (d >= d_n) return;  // ragged edge: masked, never padded

  const TG* g = grads + (int64_t)s * u_n * d_n + d;
  float acc = 0.0f;
  for (int u = 0; u < u_n; ++u) {
    acc = fmaf(c_sh[u], to_f32(g[(int64_t)u * d_n]), acc);
  }
  const int64_t row = (int64_t)s * d_n + d;
  const float gagg = acc + bias[s] + eps[s] * to_f32(noise[row]);
  g_out[row] = from_f32<TG>(gagg);
  if constexpr (UPDATE) {
    w_out[row] = from_f32<TW>(to_f32(w[row]) - alpha[s] * gagg);
  }
}

// dtype codes shared with kernels/floa_aggregate.py
constexpr int F32 = 0;
constexpr int BF16 = 1;

template <bool UPDATE, typename TG, typename TW>
cudaError_t launch(const void* coeffs, const void* grads, const void* noise,
                   const void* bias, const void* eps, const void* alpha,
                   const void* w, void* w_out, void* g_out, int s_n, int u_n,
                   int64_t d_n, cudaStream_t stream) {
  const dim3 grid((unsigned)((d_n + BLOCK_D - 1) / BLOCK_D), (unsigned)s_n);
  const size_t smem = sizeof(float) * (size_t)u_n;
  floa_combine_kernel<UPDATE, TG, TW><<<grid, BLOCK_D, smem, stream>>>(
      static_cast<const float*>(coeffs), static_cast<const TG*>(grads),
      static_cast<const TG*>(noise), static_cast<const float*>(bias),
      static_cast<const float*>(eps), static_cast<const float*>(alpha),
      static_cast<const TW*>(w), static_cast<TW*>(w_out),
      static_cast<TG*>(g_out), u_n, d_n);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Combine only: g_out[S, D].  Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for an unsupported dtype code).
int floa_aggregate_batched(const void* coeffs, const void* grads,
                           const void* noise, const void* bias,
                           const void* eps, void* g_out, int s_n, int u_n,
                           int64_t d_n, int g_dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (g_dtype == F32)
    return launch<false, float, float>(coeffs, grads, noise, bias, eps,
                                       nullptr, nullptr, nullptr, g_out, s_n,
                                       u_n, d_n, st);
  if (g_dtype == BF16)
    return launch<false, __nv_bfloat16, __nv_bfloat16>(
        coeffs, grads, noise, bias, eps, nullptr, nullptr, nullptr, g_out,
        s_n, u_n, d_n, st);
  return cudaErrorInvalidValue;
}

// Fused combine + PS update: (w_out[S, D] in w's dtype, g_out[S, D] in G's).
int floa_step_batched(const void* w, const void* coeffs, const void* grads,
                      const void* noise, const void* bias, const void* eps,
                      const void* alpha, void* w_out, void* g_out, int s_n,
                      int u_n, int64_t d_n, int g_dtype, int w_dtype,
                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (g_dtype == F32 && w_dtype == F32)
    return launch<true, float, float>(coeffs, grads, noise, bias, eps, alpha,
                                      w, w_out, g_out, s_n, u_n, d_n, st);
  if (g_dtype == F32 && w_dtype == BF16)
    return launch<true, float, __nv_bfloat16>(coeffs, grads, noise, bias, eps,
                                              alpha, w, w_out, g_out, s_n,
                                              u_n, d_n, st);
  if (g_dtype == BF16 && w_dtype == F32)
    return launch<true, __nv_bfloat16, float>(coeffs, grads, noise, bias, eps,
                                              alpha, w, w_out, g_out, s_n,
                                              u_n, d_n, st);
  if (g_dtype == BF16 && w_dtype == BF16)
    return launch<true, __nv_bfloat16, __nv_bfloat16>(
        coeffs, grads, noise, bias, eps, alpha, w, w_out, g_out, s_n, u_n,
        d_n, st);
  return cudaErrorInvalidValue;
}

}  // extern "C"
