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
// VMEM; Hopper has no such scratch to fill, so the kernel streams G.  At the
// paper's shapes (S = 1-4 lanes of U = 10, D = 50 890: 2-11 MB, warm in L2)
// memory latency bounds it before bandwidth does, so the design puts every
// load a lane needs into one round trip to memory.
//
// Layout: a block of 8 warps is KU worker slices x (8 / KU) column groups.
// A warp's 32 lanes take 32 neighbouring vectors of V columns (a warp reads
// 32 * V * sizeof(T) contiguous bytes of one row per load) and walk the
// warp's fixed slice of the workers, [k*U/KU, (k+1)*U/KU), with one f32
// accumulator per column.  The coefficients are read beside their G rows
// (one address a warp, a broadcast; no staging, no barrier), and the
// epilogue's noise and weights before the worker loop, so that their loads
// share the loop's round trip.  Two instances of the worker loop:
//   - FU > 0, U known at compile time (f32, U <= MAX_FIXED_U, KU = 1): all
//     U loads of a lane go out at once, unpredicated.  This is the paper's
//     U = 10 path, at every lane count S of the sweeps.
//   - FU = 0, a runtime loop with UNROLL loads in flight, at most 64
//     registers (four blocks an SM).  With KU > 1 the slices' partial sums
//     meet in shared memory and are added in warp order, and the slice-0
//     warp runs the epilogue (bias, noise, update) once: one lane of U =
//     1000 (the worker grid) splits U four ways to fill the card.
// `kernels/floa_aggregate.py::combine_plan` picks (V, KU) per shape.
//
// Alignment rule: V is one vector width for every row of G (all U rows of
// a column share it), so the plan takes the widest V of 16, 8, 4 or 2
// bytes that divides D and every pointer's alignment (D = 50 890 is
// 2 x 25 445: f32 rows are 8-byte aligned, so V = 2).  The entry points
// refuse a V that D or a pointer does not allow.  D is then a whole number
// of vectors and the ragged edge is masked per vector; the wrappers never
// pad.  Accumulation is f32 for f32 and bf16 inputs alike (bf16 widened
// exactly from its bits); with UPDATE the new weights come from the f32
// aggregate, as the Pallas body does (floa_aggregate.py:161-163), as
// w - (alpha * gagg) rounded twice (`__fmul_rn`, `__fsub_rn`: never
// contracted into an FMA), the update the two-step route and the plain
// version compute, so the fused flat-state update equals the tree state's
// bit for bit under strict_numerics.  The order of every sum is fixed by
// (S, U, D, V, KU): bit-equal results across calls and graph replays, no
// atomics.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_FIXED_U = 16;  // kernels/floa_aggregate.py::MAX_FIXED_U

// V elements of T (V * sizeof(T) = 2, 4, 8 or 16 bytes) as 32-bit words.
template <int B>
__device__ __forceinline__ void load_words(const void* p, uint32_t* w) {
  if constexpr (B == 16) {
    const uint4 q = __ldg(static_cast<const uint4*>(p));
    w[0] = q.x, w[1] = q.y, w[2] = q.z, w[3] = q.w;
  } else if constexpr (B == 8) {
    const uint2 q = __ldg(static_cast<const uint2*>(p));
    w[0] = q.x, w[1] = q.y;
  } else if constexpr (B == 4) {
    w[0] = __ldg(static_cast<const unsigned int*>(p));
  } else {
    w[0] = __ldg(static_cast<const unsigned short*>(p));
  }
}

template <int B>
__device__ __forceinline__ void store_words(void* p, const uint32_t* w) {
  if constexpr (B == 16) {
    *static_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  } else if constexpr (B == 8) {
    *static_cast<uint2*>(p) = make_uint2(w[0], w[1]);
  } else if constexpr (B == 4) {
    *static_cast<unsigned int*>(p) = w[0];
  } else {
    *static_cast<unsigned short*>(p) = (unsigned short)w[0];
  }
}

template <typename T, int V>
__device__ __forceinline__ void load_f32(const T* p, float* x) {
  constexpr int B = sizeof(T) * V;
  uint32_t w[(B + 3) / 4];
  load_words<B>(p, w);
#pragma unroll
  for (int j = 0; j < V; ++j) {
    if constexpr (sizeof(T) == 4) {
      x[j] = __uint_as_float(w[j]);
    } else {  // bf16: the high half of an f32, exactly
      x[j] = __uint_as_float(j % 2 ? w[j / 2] & 0xffff0000u : w[j / 2] << 16);
    }
  }
}

template <typename T, int V>
__device__ __forceinline__ void store_f32(T* p, const float* x) {
  constexpr int B = sizeof(T) * V;
  uint32_t w[(B + 3) / 4] = {};
#pragma unroll
  for (int j = 0; j < V; ++j) {
    if constexpr (sizeof(T) == 4) {
      w[j] = __float_as_uint(x[j]);
    } else {
      const uint32_t h = __bfloat16_as_ushort(__float2bfloat16(x[j]));
      w[j / 2] |= h << (16 * (j % 2));
    }
  }
  store_words<B>(p, w);
}

// FU > 0: U = FU workers known at compile time (f32, U <= MAX_FIXED_U,
// KU = 1): the lane sends all FU loads of G at once, unpredicated.
// FU = 0: a runtime worker loop, UNROLL loads in flight, capped at 64
// registers so that four blocks fit an SM.
template <bool UPDATE, typename TG, typename TW, int V, int FU>
__global__ void __launch_bounds__(THREADS, FU > 0 ? 1 : 4)
floa_combine_kernel(const float* __restrict__ coeffs,  // [S, U]
                    const TG* __restrict__ grads,      // [S, U, D]
                    const TG* __restrict__ noise,      // [S, D]
                    const float* __restrict__ bias,    // [S]
                    const float* __restrict__ eps,     // [S]
                    const float* __restrict__ alpha,   // [S] (UPDATE)
                    const TW* __restrict__ w,          // [S, D] (UPDATE)
                    TW* __restrict__ w_out,            // [S, D] (UPDATE)
                    TG* __restrict__ g_out,            // [S, D]
                    int u_n, int64_t d_n, int ku) {
  // G loads in flight per lane in the runtime loop: 16 to 32 bytes
  constexpr int UNROLL = V >= 8 ? 2 : (V >= 4 ? 4 : 8);
  __shared__ float part[THREADS * V];  // the slices' partial sums (KU > 1)
  const int s = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int grp = warp / ku, k = warp % ku;  // column group, worker slice
  const int64_t n_vec = d_n / V;
  const int64_t vi = ((int64_t)blockIdx.x * (WARPS / ku) + grp) * 32 + lane;
  const bool live = vi < n_vec;  // the ragged edge, masked per vector
  const int64_t row = (int64_t)s * d_n + vi * V;

  // The epilogue's inputs first, so that their loads share the workers'
  // round trip to memory instead of following it.
  const float b = bias[s], e = eps[s];
  const float a = UPDATE ? alpha[s] : 0.0f;
  float z[V], wv[V];
  if (live && k == 0) {
    load_f32<TG, V>(noise + row, z);
    if constexpr (UPDATE) load_f32<TW, V>(w + row, wv);
  }

  const int u0 = (int)((int64_t)k * u_n / ku);
  const int u1 = (int)((int64_t)(k + 1) * u_n / ku);
  const float* c = coeffs + (int64_t)s * u_n;
  float acc[V];
#pragma unroll
  for (int j = 0; j < V; ++j) acc[j] = 0.0f;
  if (live && FU > 0) {
    const TG* g = grads + (int64_t)s * FU * d_n + vi * V;
    float x[FU > 0 ? FU : 1][V];
#pragma unroll
    for (int i = 0; i < FU; ++i) load_f32<TG, V>(g + (int64_t)i * d_n, x[i]);
#pragma unroll
    for (int i = 0; i < FU; ++i) {
      const float cu = __ldg(c + i);
#pragma unroll
      for (int j = 0; j < V; ++j) acc[j] = fmaf(cu, x[i][j], acc[j]);
    }
  } else if (live) {
    const TG* g = grads + ((int64_t)s * u_n + u0) * d_n + vi * V;
    for (int u = u0; u < u1; u += UNROLL) {
      float x[UNROLL][V], cu[UNROLL];
#pragma unroll
      for (int i = 0; i < UNROLL; ++i) {
        if (u + i < u1) {
          cu[i] = __ldg(c + u + i);  // one address a warp: a broadcast
          load_f32<TG, V>(g + (int64_t)(u - u0 + i) * d_n, x[i]);
        }
      }
#pragma unroll
      for (int i = 0; i < UNROLL; ++i) {
        if (u + i < u1) {
#pragma unroll
          for (int j = 0; j < V; ++j) acc[j] = fmaf(cu[i], x[i][j], acc[j]);
        }
      }
    }
  }
  if (ku > 1) {  // uniform over the block
#pragma unroll
    for (int j = 0; j < V; ++j) part[(warp * 32 + lane) * V + j] = acc[j];
    __syncthreads();
    if (k != 0) return;
    for (int kk = 1; kk < ku; ++kk) {
#pragma unroll
      for (int j = 0; j < V; ++j)
        acc[j] += part[((warp + kk) * 32 + lane) * V + j];
    }
  }
  if (!live) return;

  float gagg[V];
#pragma unroll
  for (int j = 0; j < V; ++j) gagg[j] = acc[j] + b + e * z[j];
  store_f32<TG, V>(g_out + row, gagg);
  if constexpr (UPDATE) {
#pragma unroll
    for (int j = 0; j < V; ++j)
      wv[j] = __fsub_rn(wv[j], __fmul_rn(a, gagg[j]));
    store_f32<TW, V>(w_out + row, wv);
  }
}

// dtype codes shared with kernels/floa_aggregate.py
constexpr int F32 = 0;
constexpr int BF16 = 1;

bool aligned(const void* p, size_t bytes) {
  return p == nullptr || reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

template <bool UPDATE, typename TG, typename TW, int V, int FU>
cudaError_t launch_v(const void* coeffs, const void* grads, const void* noise,
                     const void* bias, const void* eps, const void* alpha,
                     const void* w, void* w_out, void* g_out, int s_n,
                     int u_n, int64_t d_n, int ku, cudaStream_t stream) {
  const int64_t per_block = (int64_t)(WARPS / ku) * 32;  // vectors
  const int64_t n_vec = d_n / V;
  const dim3 grid((unsigned)((n_vec + per_block - 1) / per_block),
                  (unsigned)s_n);
  floa_combine_kernel<UPDATE, TG, TW, V, FU>
      <<<grid, THREADS, 0, stream>>>(
          static_cast<const float*>(coeffs), static_cast<const TG*>(grads),
          static_cast<const TG*>(noise), static_cast<const float*>(bias),
          static_cast<const float*>(eps), static_cast<const float*>(alpha),
          static_cast<const TW*>(w), static_cast<TW*>(w_out),
          static_cast<TG*>(g_out), u_n, d_n, ku);
  return cudaGetLastError();
}

// The instance for V: f32 with U <= MAX_FIXED_U and KU = 1 takes the
// compile-time U, the rest the runtime worker loop.
template <bool UPDATE, typename TG, typename TW, int V>
cudaError_t launch_u(const void* coeffs, const void* grads, const void* noise,
                     const void* bias, const void* eps, const void* alpha,
                     const void* w, void* w_out, void* g_out, int s_n,
                     int u_n, int64_t d_n, int ku, cudaStream_t stream) {
#define FLOA_LAUNCH_U(N)                                                     \
  launch_v<UPDATE, TG, TW, V, N>(coeffs, grads, noise, bias, eps, alpha, w,  \
                                 w_out, g_out, s_n, u_n, d_n, ku, stream)
  if constexpr (sizeof(TG) == 4 && sizeof(TW) == 4) {
    static_assert(MAX_FIXED_U == 16, "the cases below");
    if (ku == 1) {
      switch (u_n) {
        case 1: return FLOA_LAUNCH_U(1);
        case 2: return FLOA_LAUNCH_U(2);
        case 3: return FLOA_LAUNCH_U(3);
        case 4: return FLOA_LAUNCH_U(4);
        case 5: return FLOA_LAUNCH_U(5);
        case 6: return FLOA_LAUNCH_U(6);
        case 7: return FLOA_LAUNCH_U(7);
        case 8: return FLOA_LAUNCH_U(8);
        case 9: return FLOA_LAUNCH_U(9);
        case 10: return FLOA_LAUNCH_U(10);
        case 11: return FLOA_LAUNCH_U(11);
        case 12: return FLOA_LAUNCH_U(12);
        case 13: return FLOA_LAUNCH_U(13);
        case 14: return FLOA_LAUNCH_U(14);
        case 15: return FLOA_LAUNCH_U(15);
        case 16: return FLOA_LAUNCH_U(16);
        default: break;
      }
    }
  }
  return FLOA_LAUNCH_U(0);
#undef FLOA_LAUNCH_U
}

// Checks the plan (V columns a lane, KU worker slices) against the shape
// and the pointers, then launches the instance for V.
template <bool UPDATE, typename TG, typename TW>
cudaError_t launch(const void* coeffs, const void* grads, const void* noise,
                   const void* bias, const void* eps, const void* alpha,
                   const void* w, void* w_out, void* g_out, int s_n, int u_n,
                   int64_t d_n, int vec, int ku, cudaStream_t stream) {
  if (!(ku == 1 || ku == 2 || ku == 4 || ku == 8) || s_n < 1 || u_n < 1 ||
      d_n < 1)
    return cudaErrorInvalidValue;
  if (!(vec == 1 || vec == 2 || vec == 4 || vec == 8) || d_n % vec != 0 ||
      vec * sizeof(TG) > 16 || vec * sizeof(TW) > 16)
    return cudaErrorInvalidValue;
  const size_t bg = vec * sizeof(TG), bw = vec * sizeof(TW);
  if (!aligned(grads, bg) || !aligned(noise, bg) || !aligned(g_out, bg) ||
      !aligned(w, bw) || !aligned(w_out, bw))
    return cudaErrorMisalignedAddress;
#define FLOA_LAUNCH(V)                                                       \
  launch_u<UPDATE, TG, TW, V>(coeffs, grads, noise, bias, eps, alpha, w,     \
                              w_out, g_out, s_n, u_n, d_n, ku, stream)
  switch (vec) {
    case 1:
      return FLOA_LAUNCH(1);
    case 2:
      return FLOA_LAUNCH(2);
    case 4:
      return FLOA_LAUNCH(4);
    default:
      if constexpr (sizeof(TG) == 2 && sizeof(TW) == 2) return FLOA_LAUNCH(8);
      return cudaErrorInvalidValue;
  }
#undef FLOA_LAUNCH
}

}  // namespace

extern "C" {

// Combine only: g_out[S, D], with V = vec columns a lane and KU = ku worker
// slices a block (kernels/floa_aggregate.py::combine_plan).  Returns
// cudaGetLastError() after the launch, cudaErrorInvalidValue for an
// unsupported dtype code or plan, cudaErrorMisalignedAddress for a pointer
// the plan's vectors do not fit.
int floa_aggregate_batched(const void* coeffs, const void* grads,
                           const void* noise, const void* bias,
                           const void* eps, void* g_out, int s_n, int u_n,
                           int64_t d_n, int g_dtype, int vec, int ku,
                           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (g_dtype == F32)
    return launch<false, float, float>(coeffs, grads, noise, bias, eps,
                                       nullptr, nullptr, nullptr, g_out, s_n,
                                       u_n, d_n, vec, ku, st);
  if (g_dtype == BF16)
    return launch<false, __nv_bfloat16, __nv_bfloat16>(
        coeffs, grads, noise, bias, eps, nullptr, nullptr, nullptr, g_out,
        s_n, u_n, d_n, vec, ku, st);
  return cudaErrorInvalidValue;
}

// Fused combine + PS update: (w_out[S, D] in w's dtype, g_out[S, D] in G's).
int floa_step_batched(const void* w, const void* coeffs, const void* grads,
                      const void* noise, const void* bias, const void* eps,
                      const void* alpha, void* w_out, void* g_out, int s_n,
                      int u_n, int64_t d_n, int g_dtype, int w_dtype, int vec,
                      int ku, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FLOA_STEP(TG, TW)                                                    \
  launch<true, TG, TW>(coeffs, grads, noise, bias, eps, alpha, w, w_out,     \
                       g_out, s_n, u_n, d_n, vec, ku, st)
  if (g_dtype == F32 && w_dtype == F32) return FLOA_STEP(float, float);
  if (g_dtype == F32 && w_dtype == BF16) return FLOA_STEP(float, __nv_bfloat16);
  if (g_dtype == BF16 && w_dtype == F32) return FLOA_STEP(__nv_bfloat16, float);
  if (g_dtype == BF16 && w_dtype == BF16)
    return FLOA_STEP(__nv_bfloat16, __nv_bfloat16);
#undef FLOA_STEP
  return cudaErrorInvalidValue;
}

}  // extern "C"
