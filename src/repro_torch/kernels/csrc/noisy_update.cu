// The train step's per-leaf update with its noise drawn in registers, and
// the init's truncated-normal fill, for sm_90a.
//
// Replaces no Pallas kernel.  The reference's update
// (src/repro/launch/steps.py:222-236: x = g + shift, x += scale * z in g's
// dtype, p - alpha x in f32, z = jax.random.normal(fold_in(k_z, i)) drawn
// shard-locally by partitionable threefry) is fused by XLA; the port's
// plain version (`launch/steps.py::_noisy_sgd`) makes ~6 f32 passes a
// chunk and, before this kernel, drew z at the leaf's whole shape on every
// rank.  `noisy_sgd_kernel` reads p and g once and writes the new p once;
// z never exists in device memory.
//
// Bound: bytes, p + g + out (6 bytes an element in bf16) over 3.35 TB/s,
// against ~40 integer and f32 operations an element (a Philox4x32-10 call
// of 98 integer operations serves 4 elements; Box-Muller ~8 an element;
// the update 5), which at 67 TFLOP/s takes a third of the bytes' time.
// Design: a thread takes one q = j / 4 of a row of the part: one Philox
// call, four normals, and the (up to) four elements of the row whose
// global index falls in [4q, 4q + 4).  A row of the part is a contiguous
// run of the leaf once whole inner dims are merged (csrc/philox.cuh::
// Part), so for a leaf split on its first dim the whole part is one row.
// Rows go over grid.y, a row's groups of 4 over grid.x, both strided.
// A simple kernel: no vector loads, so a misaligned row costs nothing
// extra and the elements of a group are loaded one at a time.
//
// Modes: 0 no noise, 1 z given (a contiguous f32 tensor of the part's
// shape, the replayed draws), 2 z drawn from the stream.
//
// `counter_trunc_normal_kernel` fills a part of a leaf with the init's
// truncated normal times 1/sqrt(fan_in), in the leaf's dtype (purpose 1);
// bound by its writes' bytes.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

constexpr int F32 = 0;
constexpr int BF16 = 1;
constexpr int THREADS = 256;
constexpr long long MAX_BLOCKS = 4096;

__device__ __forceinline__ float load(const float* x, long long i) {
  return x[i];
}
__device__ __forceinline__ float load(const __nv_bfloat16* x, long long i) {
  return __bfloat162float(x[i]);
}
__device__ __forceinline__ void store(float* x, long long i, float v) {
  x[i] = v;
}
__device__ __forceinline__ void store(__nv_bfloat16* x, long long i, float v) {
  x[i] = __float2bfloat16_rn(v);
}
// v rounded to T, back in f32
__device__ __forceinline__ float round_to(float v, const float*) { return v; }
__device__ __forceinline__ float round_to(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <typename T, int MODE>
__global__ void __launch_bounds__(THREADS)
noisy_sgd_kernel(T* __restrict__ out, const T* __restrict__ p,
                 const T* __restrict__ g, const T* __restrict__ shift,
                 const float* __restrict__ scale, const float* __restrict__ z,
                 float alpha, uint2 key, uint32_t leaf, ctr::Part part,
                 long long rows) {
  const T* tag = nullptr;
  const float sh = load(shift, 0);
  const float sc = MODE == 0 ? 0.0f : scale[0];
  const long long n = part.len[part.nd - 1];
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long r = blockIdx.y; r < rows; r += gridDim.y) {
    const long long js = ctr::row_start(part, r);
    const long long q0 = js >> 2, q1 = (js + n - 1) >> 2;
    const long long base = r * n - js;   // element index of global j: base + j
    for (long long q = q0 + static_cast<long long>(blockIdx.x) * blockDim.x +
                       threadIdx.x;
         q <= q1; q += step) {
      float zz[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (MODE == 2) ctr::normals4(ctr::draw_bits(q, leaf, ctr::NOISE, key),
                                   zz);
#pragma unroll
      for (int lane = 0; lane < 4; ++lane) {
        const long long j = 4 * q + lane;
        if (j < js || j >= js + n) continue;
        const long long e = base + j;
        float x = round_to(__fadd_rn(load(g, e), sh), tag);
        if (MODE != 0) {
          const float zv = MODE == 1 ? z[e] : zz[lane];
          x = round_to(__fadd_rn(x, round_to(__fmul_rn(sc, zv), tag)), tag);
        }
        store(out, e, __fsub_rn(load(p, e), __fmul_rn(alpha, x)));
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
counter_trunc_normal_kernel(T* __restrict__ out, float scale, float lo,
                            float width, uint2 key, uint32_t leaf,
                            ctr::Part part, long long rows) {
  const long long n = part.len[part.nd - 1];
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long r = blockIdx.y; r < rows; r += gridDim.y) {
    const long long js = ctr::row_start(part, r);
    const long long q0 = js >> 2, q1 = (js + n - 1) >> 2;
    const long long base = r * n - js;
    for (long long q = q0 + static_cast<long long>(blockIdx.x) * blockDim.x +
                       threadIdx.x;
         q <= q1; q += step) {
      const uint4 x = ctr::draw_bits(q, leaf, ctr::INIT, key);
      const uint32_t bits[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
      for (int lane = 0; lane < 4; ++lane) {
        const long long j = 4 * q + lane;
        if (j < js || j >= js + n) continue;
        store(out, base + j,
              __fmul_rn(ctr::trunc_normal(bits[lane], lo, width), scale));
      }
    }
  }
}

// The part from the wrapper's collapsed geometry; false if it does not fit.
bool make_part(int nd, const int64_t* stride, const int64_t* off,
               const int64_t* len, ctr::Part* part, long long* rows) {
  if (nd < 1 || nd > ctr::MAX_DIMS) return false;
  part->nd = nd;
  long long r = 1;
  for (int k = 0; k < ctr::MAX_DIMS; ++k) {
    part->stride[k] = k < nd ? stride[k] : 0;
    part->off[k] = k < nd ? off[k] : 0;
    part->len[k] = k < nd ? len[k] : 1;
    if (k < nd && len[k] < 1) return false;
    if (k < nd - 1) r *= len[k];
  }
  *rows = r;
  return true;
}

// Rows over grid.y, groups of 4 over grid.x: about MAX_BLOCKS blocks.
dim3 grid_of(long long rows, long long n) {
  const long long groups = n / 4 + 2;
  long long bx = (groups + THREADS - 1) / THREADS;
  if (bx > MAX_BLOCKS) bx = MAX_BLOCKS;
  long long by = MAX_BLOCKS / bx;
  if (by < 1) by = 1;
  if (by > rows) by = rows;
  if (by > 65535) by = 65535;
  return dim3(static_cast<unsigned>(bx), static_cast<unsigned>(by));
}

template <typename T>
int launch_sgd(void* out, const void* p, const void* g, const void* shift,
               const void* scale, const void* z, float alpha, int mode,
               uint2 key, uint32_t leaf, const ctr::Part& part,
               long long rows, cudaStream_t st) {
  const dim3 grid = grid_of(rows, part.len[part.nd - 1]);
  T* o = static_cast<T*>(out);
  const T* pp = static_cast<const T*>(p);
  const T* gg = static_cast<const T*>(g);
  const T* sh = static_cast<const T*>(shift);
  const float* sc = static_cast<const float*>(scale);
  const float* zz = static_cast<const float*>(z);
  if (mode == 0)
    noisy_sgd_kernel<T, 0><<<grid, THREADS, 0, st>>>(o, pp, gg, sh, sc, zz,
                                                     alpha, key, leaf, part,
                                                     rows);
  else if (mode == 1)
    noisy_sgd_kernel<T, 1><<<grid, THREADS, 0, st>>>(o, pp, gg, sh, sc, zz,
                                                     alpha, key, leaf, part,
                                                     rows);
  else
    noisy_sgd_kernel<T, 2><<<grid, THREADS, 0, st>>>(o, pp, gg, sh, sc, zz,
                                                     alpha, key, leaf, part,
                                                     rows);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// out = p - alpha (g + shift + scale z) with the reference's roundings, for
// one part of one leaf (p, g, out contiguous in the part's row-major order;
// dtype code 0 = f32, 1 = bf16; shift a one-element tensor in that dtype,
// scale one f32, both on the device).  mode 0: no z; 1: z a contiguous f32
// tensor of the part's shape; 2: z drawn from the stream (key, leaf,
// purpose 0) at the part's global indices.  The part: nd collapsed dims of
// the leaf's whole row-major strides, the part's offsets and lengths.
// Returns the launch's error code.
int noisy_sgd(void* out, const void* p, const void* g, const void* shift,
              const void* scale, const void* z, float alpha, int mode,
              uint32_t key_lo, uint32_t key_hi, uint32_t leaf, int nd,
              const int64_t* stride, const int64_t* off, const int64_t* len,
              int dtype, void* stream) {
  ctr::Part part;
  long long rows = 0;
  if (!make_part(nd, stride, off, len, &part, &rows) || mode < 0 ||
      mode > 2)
    return cudaErrorInvalidValue;
  const uint2 key = make_uint2(key_lo, key_hi);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == F32)
    return launch_sgd<float>(out, p, g, shift, scale, z, alpha, mode, key,
                             leaf, part, rows, st);
  if (dtype == BF16)
    return launch_sgd<__nv_bfloat16>(out, p, g, shift, scale, z, alpha, mode,
                                     key, leaf, part, rows, st);
  return cudaErrorInvalidValue;
}

// out (the part, contiguous, dtype code 0 = f32, 1 = bf16) = the init's
// truncated normal (key, leaf, purpose 1) at the part's global indices,
// times scale; lo and width the uniform's range (csrc/philox.cuh).
int counter_trunc_normal(void* out, float scale, float lo, float width,
                         uint32_t key_lo, uint32_t key_hi, uint32_t leaf,
                         int nd, const int64_t* stride, const int64_t* off,
                         const int64_t* len, int dtype, void* stream) {
  ctr::Part part;
  long long rows = 0;
  if (!make_part(nd, stride, off, len, &part, &rows))
    return cudaErrorInvalidValue;
  const uint2 key = make_uint2(key_lo, key_hi);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid = grid_of(rows, part.len[nd - 1]);
  if (dtype == F32)
    counter_trunc_normal_kernel<float><<<grid, THREADS, 0, st>>>(
        static_cast<float*>(out), scale, lo, width, key, leaf, part, rows);
  else if (dtype == BF16)
    counter_trunc_normal_kernel<__nv_bfloat16><<<grid, THREADS, 0, st>>>(
        static_cast<__nv_bfloat16*>(out), scale, lo, width, key, leaf, part,
        rows);
  else
    return cudaErrorInvalidValue;
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
