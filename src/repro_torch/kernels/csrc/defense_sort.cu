// Coordinate sorts over the worker axis for the digital screening defenses
// (coordinate median and trimmed mean), sm_90a.  Both take a [S, U, D] slab,
// row-major, and write it back sorted ascending along U, lane by lane:
//
//   sort_columns          U <= 32, an unrolled odd-even transposition network
//                         in registers.  Replaces the Pallas kernel
//                         src/repro/kernels/defense_sort.py::_sort_columns_core
//                         (body _kernel, network _odd_even_sort).
//   sort_columns_bitonic  larger U: a bitonic network in shared memory, U
//                         padded with +inf to a power of two.  Replaces
//                         _sort_columns_bitonic_core (body _bitonic_kernel,
//                         stages _bitonic_stages).
//
// The Pallas kernels are [U, D] and get their lane axis from vmap; here the
// lane is the grid's y dimension, so one launch sorts a whole lane group.
//
// Both networks are min/max compare-exchanges, computed in f32 and written
// back in the input dtype: on finite inputs the output equals a sort exactly
// (a column's multiset of values is kept; ties keep values, not identity).
// NaN ordering is out of contract, as in the reference.
//
// What bounds them on an H100.
//   Odd-even: bytes.  Each element is read once and written once (2 S U D
//   elements over 3.35 TB/s); the U(U-1)/2 min/max pairs per column sit in
//   registers.  One thread owns one column (s, d): consecutive threads take
//   consecutive d, so each of the U row loads of a warp is one coalesced
//   128-byte line (f32).  U is a template parameter (a switch over 1..32),
//   so the network unrolls at compile time as the TPU network unrolls at
//   trace time, and the U values never leave registers.
//   Bitonic: the shared-memory traffic of the log2(U_pad)(log2(U_pad)+1)/2
//   stages, each reading and writing every element of the [U_pad, T] tile
//   once, not device memory.  A block owns T consecutive columns of one lane:
//   it loads [U_pad, T] into dynamic shared memory (rows >= U are +inf, so
//   they sort to the bottom and are never written back), runs the stages
//   with a __syncthreads() between them, and writes the first U rows back.
//   A row of the tile is T contiguous elements of device memory: T >= 8 f32
//   keeps every row load a whole 32-byte sector, T = 4 (U_pad = 8192) half
//   of one.  The wrapper picks T (kernels/defense_sort.py::bitonic_tile_d)
//   so the tile fits the 227 KB a block can have on Hopper, which caps
//   U_pad at 8192 (T = 4, 128 KB).
// The ragged D edge is masked in both kernels; the wrappers never pad.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int ODD_EVEN_BLOCK = 256;
constexpr int BITONIC_THREADS = 512;
// The opt-in dynamic shared memory of one block on Hopper (227 KB); the
// wrapper's SMEM_BYTES.
constexpr int MAX_DYNAMIC_SMEM = 232448;

// dtype codes shared with kernels/_build.py::DTYPE_CODES
constexpr int F32 = 0;
constexpr int BF16 = 1;

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

template <int U, typename T>
__global__ void __launch_bounds__(ODD_EVEN_BLOCK)
odd_even_kernel(const T* __restrict__ x, T* __restrict__ out, int64_t d_n) {
  const int64_t d = (int64_t)blockIdx.x * ODD_EVEN_BLOCK + threadIdx.x;
  if (d >= d_n) return;  // ragged edge: masked, never padded
  const int64_t col = (int64_t)blockIdx.y * U * d_n + d;
  float v[U];
#pragma unroll
  for (int u = 0; u < U; ++u) v[u] = to_f32(x[col + (int64_t)u * d_n]);
  // U passes of adjacent compare-exchanges, even pairs then odd pairs,
  // alternating: the transposition-sort bound, as in _odd_even_sort.
#pragma unroll
  for (int p = 0; p < U; ++p) {
#pragma unroll
    for (int i = p & 1; i + 1 < U; i += 2) {
      const float lo = fminf(v[i], v[i + 1]);
      const float hi = fmaxf(v[i], v[i + 1]);
      v[i] = lo;
      v[i + 1] = hi;
    }
  }
#pragma unroll
  for (int u = 0; u < U; ++u) out[col + (int64_t)u * d_n] = from_f32<T>(v[u]);
}

template <typename T>
__global__ void __launch_bounds__(BITONIC_THREADS)
bitonic_kernel(const T* __restrict__ x, T* __restrict__ out, int u_n,
               int log_u_pad, int log_tile, int64_t d_n) {
  extern __shared__ float tile_sh[];  // [U_pad, T] row-major, f32
  const int tile = 1 << log_tile;
  const int u_pad = 1 << log_u_pad;
  const int n = u_pad << log_tile;
  const int64_t d0 = (int64_t)blockIdx.x * tile;
  const int64_t lane = (int64_t)blockIdx.y * u_n * d_n;
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const int u = e >> log_tile;
    const int64_t d = d0 + (e & (tile - 1));
    tile_sh[e] = (u < u_n && d < d_n) ? to_f32(x[lane + (int64_t)u * d_n + d])
                                      : INFINITY;
  }
  __syncthreads();
  // Stage (k, j) pairs row i with row i + j for every i whose bit j is clear;
  // the pair sorts ascending when bit k of i is clear, descending otherwise.
  // Pair p of a stage: column p mod T, and its q = p / T-th such row i
  // (q with a 0 inserted at bit log2(j)).
  const int pairs = n >> 1;
  for (int k = 2; k <= u_pad; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int p = threadIdx.x; p < pairs; p += blockDim.x) {
        const int c = p & (tile - 1);
        const int q = p >> log_tile;
        const int i = ((q & ~(j - 1)) << 1) | (q & (j - 1));
        const int a_at = (i << log_tile) + c;
        const int b_at = ((i | j) << log_tile) + c;
        const float a = tile_sh[a_at];
        const float b = tile_sh[b_at];
        const float lo = fminf(a, b);
        const float hi = fmaxf(a, b);
        const bool ascending = (i & k) == 0;
        tile_sh[a_at] = ascending ? lo : hi;
        tile_sh[b_at] = ascending ? hi : lo;
      }
      __syncthreads();
    }
  }
  const int n_out = u_n << log_tile;  // the +inf rows are never written back
  for (int e = threadIdx.x; e < n_out; e += blockDim.x) {
    const int u = e >> log_tile;
    const int64_t d = d0 + (e & (tile - 1));
    if (d < d_n) out[lane + (int64_t)u * d_n + d] = from_f32<T>(tile_sh[e]);
  }
}

template <typename T>
cudaError_t launch_odd_even(const void* x, void* out, int s_n, int u_n,
                            int64_t d_n, cudaStream_t st) {
  const dim3 grid((unsigned)((d_n + ODD_EVEN_BLOCK - 1) / ODD_EVEN_BLOCK),
                  (unsigned)s_n);
  const T* xi = static_cast<const T*>(x);
  T* o = static_cast<T*>(out);
  switch (u_n) {
#define SORT_CASE(U)                                                \
  case U:                                                           \
    odd_even_kernel<U, T><<<grid, ODD_EVEN_BLOCK, 0, st>>>(xi, o, d_n); \
    break;
    SORT_CASE(1) SORT_CASE(2) SORT_CASE(3) SORT_CASE(4)
    SORT_CASE(5) SORT_CASE(6) SORT_CASE(7) SORT_CASE(8)
    SORT_CASE(9) SORT_CASE(10) SORT_CASE(11) SORT_CASE(12)
    SORT_CASE(13) SORT_CASE(14) SORT_CASE(15) SORT_CASE(16)
    SORT_CASE(17) SORT_CASE(18) SORT_CASE(19) SORT_CASE(20)
    SORT_CASE(21) SORT_CASE(22) SORT_CASE(23) SORT_CASE(24)
    SORT_CASE(25) SORT_CASE(26) SORT_CASE(27) SORT_CASE(28)
    SORT_CASE(29) SORT_CASE(30) SORT_CASE(31) SORT_CASE(32)
#undef SORT_CASE
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bitonic(const void* x, void* out, int s_n, int u_n,
                           int log_u_pad, int log_tile, int64_t d_n,
                           cudaStream_t st) {
  const size_t smem = sizeof(float) * ((size_t)1 << (log_u_pad + log_tile));
  if (smem > (size_t)MAX_DYNAMIC_SMEM) return cudaErrorInvalidValue;
  // Above 48 KB a block gets dynamic shared memory only on request.  The
  // request is made once per process, for the whole opt-in budget, so no
  // launch (and no CUDA-graph capture of one) calls the attribute API.
  static const cudaError_t attr = cudaFuncSetAttribute(
      bitonic_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      MAX_DYNAMIC_SMEM);
  if (attr != cudaSuccess) return attr;
  const int64_t tile = (int64_t)1 << log_tile;
  const dim3 grid((unsigned)((d_n + tile - 1) / tile), (unsigned)s_n);
  bitonic_kernel<T><<<grid, BITONIC_THREADS, smem, st>>>(
      static_cast<const T*>(x), static_cast<T*>(out), u_n, log_u_pad,
      log_tile, d_n);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// [S, U, D] -> [S, U, D] sorted along U, 1 <= U <= 32.  Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for an
// unsupported U or dtype code).
int sort_columns(const void* x, void* out, int s_n, int u_n, int64_t d_n,
                 int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == F32) return launch_odd_even<float>(x, out, s_n, u_n, d_n, st);
  if (dtype == BF16)
    return launch_odd_even<__nv_bfloat16>(x, out, s_n, u_n, d_n, st);
  return cudaErrorInvalidValue;
}

// [S, U, D] -> [S, U, D] sorted along U by the bitonic network over
// U_pad = 2^log_u_pad >= U rows and tiles of T = 2^log_tile columns.
int sort_columns_bitonic(const void* x, void* out, int s_n, int u_n,
                         int log_u_pad, int log_tile, int64_t d_n, int dtype,
                         void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == F32)
    return launch_bitonic<float>(x, out, s_n, u_n, log_u_pad, log_tile, d_n,
                                 st);
  if (dtype == BF16)
    return launch_bitonic<__nv_bfloat16>(x, out, s_n, u_n, log_u_pad,
                                         log_tile, d_n, st);
  return cudaErrorInvalidValue;
}

}  // extern "C"
