// Coordinate sorts over the worker axis for the digital screening defenses
// (coordinate median and trimmed mean), sm_90a.  Both take a [S, U, D] slab,
// row-major, and write it back sorted ascending along U, lane by lane:
//
//   sort_columns          U <= 32, an unrolled odd-even transposition network
//                         in registers.  Replaces the Pallas kernel
//                         src/repro/kernels/defense_sort.py::_sort_columns_core
//                         (body _kernel, network _odd_even_sort).
//   sort_columns_bitonic  larger U: a bitonic network over U padded with
//                         +inf to a power of two, in registers.  Replaces
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
//   Bitonic: the network's issue slots.  U_pad = 2^L rows take L(L+1)/2
//   stages of U_pad/2 compare-exchanges per column (55 stages at U = 1000,
//   ~0.2 ms of min/max issue for [1000, 50 890] against 0.12 ms of bytes).
//   A first kernel ran every stage through a [U_pad, T] shared-memory tile
//   with a __syncthreads() between stages, one 128 KB block per SM; this
//   one keeps the values in registers:
//   - staging: a block owns C columns of one lane.  It reads the [U, C]
//     tile with row-coalesced loads (C contiguous values per row, rows past
//     U are +inf and are never written back) into shared memory stored
//     column by column, one float of pad per 32 so that a warp reading 32
//     values of a column at stride 1 or 32 hits 32 banks; it writes the
//     first U rows back through the same tile.
//   - the network: every thread owns VALS = 32 values of one column, so a
//     column takes TC = U_pad / 32 threads (2 at U_pad = 64, a warp at
//     1024, 8 warps at 8192) and a block of 256 threads C = 256 / TC
//     columns (small U_pad packs several columns into one warp).  Stage
//     (K, b) pairs index i with i ^ 2^b and sorts the pair ascending when
//     bit K of i is clear.  Which 5 of the L index bits a thread's 32
//     registers hold is a window [w, w + 5): i = t_low | e << w | t_high
//     << (w + 5).  A stage whose bit b lies in the window is 16 register
//     compare-exchanges with compile-time indices; when b leaves it, the
//     thread stores its 32 values to the column in shared memory and reads
//     back the window [b - 4, b + 1) (one store and one load per value, no
//     bank conflicts, a __syncwarp, or a __syncthreads when a column spans
//     warps).  No stage goes through shuffles: a shuffle stage issues one
//     SHFL per value on the same pipe as a window move's loads and stores,
//     and one move serves up to five stages (PERF.md §6 weighs the two by
//     count; not measured).  Level k's direction
//     (descending where bit k of i is set) is folded into the values:
//     while level k runs, those values are held negated (exact in f32), so
//     every stage is 16 plain ascending min/max pairs; moving to the next
//     level negates the values whose bits k and k + 1 differ.  The
//     schedule of windows is computed at compile time from L (a template
//     parameter, 6..13).
//   - occupancy: 256 threads, at most 64 registers a thread and ~34 KB of
//     shared memory a block (U_pad * 33/32 * 4 bytes, the whole block's
//     values), so four blocks share an SM and one block's loads overlap
//     another's network.
//     U_pad = 8192 is one block per column: 130 blocks at D = 130.
// The ragged D edge is masked in both kernels; the wrappers never pad.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int ODD_EVEN_BLOCK = 256;
// The bitonic plan.  kernels/defense_sort.py::bitonic_plan states it for
// the launch and its tests; sort_columns_bitonic refuses a plan that
// differs from Bitonic<L>.
constexpr int SORT_THREADS = 256;  // threads per block
constexpr int VALS = 32;           // values per thread
constexpr int WIN = 5;             // log2(VALS): index bits in registers

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

// The network over U_pad = 2^L rows: C columns of TC threads per block,
// column stride CS floats (U_pad values, one pad per 32, and an offset
// that keeps the staging tile's row stores and the window transposes free
// of bank conflicts).
template <int L>
struct Bitonic {
  static constexpr int UPAD = 1 << L;
  static constexpr int TC = UPAD / VALS;
  static constexpr int C = SORT_THREADS / TC;
  static constexpr int CS = UPAD + UPAD / 32 +
                            (L == 10 ? 4 : L == 11 ? 8 : L == 12 ? 16 : 0);
  static constexpr int STAGES = L * (L + 1) / 2;
  static_assert(L >= 6 && L <= 13, "U_pad from 64 to 8192");
};

struct Stage {
  int k, b, w;  // level (merges runs of 2^k), pair bit, register window
};

// Stage s of the L-bit network, in order: level k = 1..L, bit b = k-1..0.
// A thread's registers hold index bits [w, w + WIN); the window stays while
// b lies in it and otherwise moves to end at b (or to [0, WIN)).
__host__ __device__ constexpr Stage stage_at(int L, int s) {
  int w = 0, n = 0;
  for (int k = 1; k <= L; ++k) {
    for (int b = k - 1; b >= 0; --b) {
      if (b < w || b >= w + WIN) w = b >= WIN - 1 ? b - (WIN - 1) : 0;
      if (n == s) return Stage{k, b, w};
      ++n;
    }
  }
  return Stage{L, 0, 0};
}

// Level k's domain: while level k runs, the value of index i is held
// negated when bit k of i is set (k < L).  A pair of level k shares bit k,
// so sorting it ascending in the domain sorts it ascending or descending
// as the bitonic network asks, and no stage needs a direction.  mask(k) is
// that bit, 0 for the true values (k = 0) and for the last level (k = L).
__host__ __device__ constexpr int domain_mask(int L, int k) {
  return k >= 1 && k < L ? 1 << k : 0;
}

// Move the values from level K's domain into level K + 1's: negate index i
// where bit K and bit K + 1 of i differ in the masks.  Level K ends on bit
// 0, so the window is [0, WIN): i = t << WIN | e, a compile-time sign per e
// times one per thread.
template <int L, int K>
__device__ __forceinline__ void next_domain(float (&v)[VALS], int t) {
  constexpr int M = domain_mask(L, K) ^ domain_mask(L, K + 1);
  constexpr int TM = M >> WIN;
  if constexpr (TM == 0) {
#pragma unroll
    for (int e = 0; e < VALS; ++e)
      if (__popc(e & M) & 1) v[e] = -v[e];
  } else {
    const float s = __popc(t & TM) & 1 ? -1.0f : 1.0f;
#pragma unroll
    for (int e = 0; e < VALS; ++e) v[e] *= __popc(e & M) & 1 ? -s : s;
  }
}

template <int L>
__device__ __forceinline__ void column_sync() {
  if constexpr (Bitonic<L>::TC <= 32) {
    __syncwarp();
  } else {
    __syncthreads();
  }
}

// Thread t's 32 values in window W: value e is index t_low | e << W |
// t_high << (W + WIN), at offset i + i / 32 of its column.  The fields are
// disjoint bits, so the offset splits into a thread part and a
// compile-time part per e.
template <int W>
__device__ __forceinline__ float* window_base(float* col, int t) {
  const int base = (t & ((1 << W) - 1)) | ((t >> W) << (W + WIN));
  return col + base + (base >> 5);
}

template <int W>
__device__ __forceinline__ void store_window(const float (&v)[VALS],
                                             float* col, int t) {
  float* p = window_base<W>(col, t);
#pragma unroll
  for (int e = 0; e < VALS; ++e) {
    const int i = e << W;
    p[i + (i >> 5)] = v[e];
  }
}

template <int W>
__device__ __forceinline__ void load_window(float (&v)[VALS], float* col,
                                            int t) {
  const float* p = window_base<W>(col, t);
#pragma unroll
  for (int e = 0; e < VALS; ++e) {
    const int i = e << W;
    v[e] = p[i + (i >> 5)];
  }
}

// Stage bit B in window W: 16 ascending compare-exchanges of registers e
// and e | 2^(B - W) (ascending in the level's domain).
template <int B, int W>
__device__ __forceinline__ void stage(float (&v)[VALS]) {
  constexpr int M = 1 << (B - W);
#pragma unroll
  for (int e = 0; e < VALS; ++e) {
    if (e & M) continue;
    const float a = v[e], b = v[e | M];
    v[e] = fminf(a, b);
    v[e | M] = fmaxf(a, b);
  }
}

template <int L, int S>
__device__ __forceinline__ void network(float (&v)[VALS], float* col,
                                        int t) {
  constexpr Stage cur = stage_at(L, S);
  if constexpr (S > 0) {
    constexpr Stage prev = stage_at(L, S - 1);
    if constexpr (cur.k != prev.k) {
      static_assert(prev.w == 0, "a level ends on bit 0, in window 0");
      next_domain<L, prev.k>(v, t);
    }
    if constexpr (cur.w != prev.w) {
      // move to the new window through the column in shared memory
      column_sync<L>();
      store_window<prev.w>(v, col, t);
      column_sync<L>();
      load_window<cur.w>(v, col, t);
    }
  }
  stage<cur.b, cur.w>(v);
  if constexpr (S + 1 < Bitonic<L>::STAGES) network<L, S + 1>(v, col, t);
}

// Four blocks per SM, at most 64 registers a thread (32 hold the values);
// three at U_pad = 8192, whose column spans the block (85 registers).
template <int L, typename T>
__global__ void __launch_bounds__(SORT_THREADS, L == 13 ? 3 : 4)
bitonic_kernel(const T* __restrict__ x, T* __restrict__ out, int u_n,
               int64_t d_n) {
  using B = Bitonic<L>;
  constexpr int ROWS = SORT_THREADS / B::C;  // tile rows per pass
  __shared__ float tile[B::C * B::CS];       // C columns, column-contiguous
  // staging: thread (row r, column c) of each pass; C contiguous values per
  // row, so the loads are row-coalesced.  Rows past U and columns past the
  // ragged D edge are +inf; the same threads write the first U rows back.
  const int c = threadIdx.x % B::C;
  const int r = threadIdx.x / B::C;
  const bool in_d = (int64_t)blockIdx.x * B::C + c < d_n;
  const int64_t at = (int64_t)blockIdx.y * u_n * d_n +
                     (int64_t)blockIdx.x * B::C + c + (int64_t)r * d_n;
  const int64_t step = (int64_t)ROWS * d_n;
  float* mine = tile + c * B::CS + r + (r >> 5);
#pragma unroll
  for (int i = 0; i < B::UPAD / ROWS; ++i) {
    const int u = r + i * ROWS;  // ROWS is a multiple of 32 or divides it
    mine[i * ROWS + ((u >> 5) - (r >> 5))] =
        (in_d && u < u_n) ? to_f32(x[at + i * step]) : INFINITY;
  }
  __syncthreads();
  float* col = tile + (threadIdx.x / B::TC) * B::CS;
  const int t = threadIdx.x % B::TC;
  float v[VALS];
  load_window<0>(v, col, t);
  next_domain<L, 0>(v, t);  // into level 1's domain
  network<L, 0>(v, col, t);
  constexpr Stage last = stage_at(L, B::STAGES - 1);  // level L: true values
  column_sync<L>();
  store_window<last.w>(v, col, t);
  __syncthreads();
  if (in_d) {
#pragma unroll
    for (int i = 0; i < B::UPAD / ROWS; ++i) {
      const int u = r + i * ROWS;
      if (u < u_n)
        out[at + i * step] =
            from_f32<T>(mine[i * ROWS + ((u >> 5) - (r >> 5))]);
    }
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

// The caller's plan (cols columns and smem_bytes of shared memory per
// block) must be Bitonic<L>'s.
template <typename T>
cudaError_t launch_bitonic(const void* x, void* out, int s_n, int u_n,
                           int log_u_pad, int cols, int smem_bytes,
                           int64_t d_n, cudaStream_t st) {
  const T* xi = static_cast<const T*>(x);
  T* o = static_cast<T*>(out);
  switch (log_u_pad) {
#define BITONIC_CASE(L)                                                  \
  case L: {                                                              \
    using B = Bitonic<L>;                                                \
    if (cols != B::C || smem_bytes != (int)sizeof(float) * B::C * B::CS) \
      return cudaErrorInvalidValue;                                      \
    const dim3 grid((unsigned)((d_n + cols - 1) / cols), (unsigned)s_n); \
    bitonic_kernel<L, T><<<grid, SORT_THREADS, 0, st>>>(xi, o, u_n, d_n); \
    break;                                                               \
  }
    BITONIC_CASE(6) BITONIC_CASE(7) BITONIC_CASE(8) BITONIC_CASE(9)
    BITONIC_CASE(10) BITONIC_CASE(11) BITONIC_CASE(12) BITONIC_CASE(13)
#undef BITONIC_CASE
    default:
      return cudaErrorInvalidValue;
  }
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
// U_pad = 2^log_u_pad rows, U <= U_pad, 6 <= log_u_pad <= 13, with the
// plan of kernels/defense_sort.py::bitonic_plan: cols columns and
// smem_bytes of shared memory per block (cudaErrorInvalidValue if they
// are not the compiled instance's).
int sort_columns_bitonic(const void* x, void* out, int s_n, int u_n,
                         int log_u_pad, int cols, int smem_bytes,
                         int64_t d_n, int dtype, void* stream) {
  if (u_n < 1 || u_n > (1 << 13) || (int64_t)u_n > ((int64_t)1 << log_u_pad))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == F32)
    return launch_bitonic<float>(x, out, s_n, u_n, log_u_pad, cols,
                                 smem_bytes, d_n, st);
  if (dtype == BF16)
    return launch_bitonic<__nv_bfloat16>(x, out, s_n, u_n, log_u_pad, cols,
                                         smem_bytes, d_n, st);
  return cudaErrorInvalidValue;
}

}  // extern "C"
