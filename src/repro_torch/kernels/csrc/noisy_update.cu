// The train step's per-leaf update with its noise drawn in registers, and
// the init's truncated-normal fill, for sm_90a.
//
// Replaces no Pallas kernel.  The reference's update
// (src/repro/launch/steps.py:222-236: x = g + shift, x += scale * z in g's
// dtype, p - alpha x in f32, z = jax.random.normal(fold_in(k_z, i)) drawn
// shard-locally by partitionable threefry) is fused by XLA; the port's
// plain version (`launch/steps.py::_noisy_sgd`) makes ~6 f32 passes a
// chunk.  `noisy_sgd_kernel` reads p and g once and writes the new p once;
// z never exists in device memory.
//
// Bound: bytes, p + g + out (6 bytes an element in bf16) over 3.35 TB/s,
// and the issue rate: a Philox4x32-10 call (10 rounds of two 32 x 32 -> 64
// products and two three-way xors) serves 4 elements, Box-Muller's logf,
// sqrtf, cosf and sinf a pair, the update's roundings an element; about
// as many SM clocks as the bytes take (`tools/sass_mix.py` counts them from
// the SASS).  `counter_trunc_normal_kernel` (erfinvf an element) is bound
// by its issue rate, not by its writes' bytes.
//
// Design: the part (contiguous, rows of len[nd - 1] elements in its own
// row-major order, each row a run of consecutive global indices once whole
// inner dims are merged: csrc/philox.cuh::Part) is cut into flat tiles of
// TILE elements, walked by a grid-stride loop of as many blocks as fit the
// SMs at once.  A thread takes UNROLL slots of VEC = 8 consecutive
// elements of a tile.  A slot inside one row whose global indices start at
// a multiple of 4 is two whole Philox groups: one 16-byte load of p and of
// g (two each in f32), two Philox calls, eight normals, one 16-byte
// streaming store (two in f32), no bound checks.  Any other slot (a row's
// head or tail, a row that starts off a multiple of 4, a slot across rows,
// pointers not 16-byte aligned) takes the per-group code of the simple
// kernel this replaced (`group`), clipped to the slot's run of each row.
// A part of many rows: the tile's first row advances by whole rows from
// one tile to the next, and a thread finds its slot's row with one
// multiply; the row's global-minus-storage offset is linear in the row
// for a part of two merged dims (a leaf split on one dim), else the block
// fills a shared table of the rows a tile spans (`ctr::row_start`, whose
// only divisions are those of the dims inside the outermost).  A row of 64
// elements no longer idles a block.  Every element takes the same
// arithmetic, rounding for rounding, as in the simple kernel, so the bits
// are the same.
//
// Modes: 0 no noise, 1 z given (a contiguous f32 tensor of the part's
// shape, the replayed draws), 2 z drawn from the stream, under the key the
// kernel reads from device memory (the step's seed tensor), so that a
// launch captured in a CUDA graph draws the replay's noise.
//
// `counter_trunc_normal_kernel` fills a part of a leaf with the init's
// truncated normal times 1/sqrt(fan_in), in the leaf's dtype (purpose 1),
// by the same walk.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

constexpr int F32 = 0;
constexpr int BF16 = 1;
constexpr int THREADS = 256;
constexpr int VEC = 8;                         // a slot: two Philox groups
constexpr int UNROLL = 2;                      // slots a thread a tile
constexpr int TILE = THREADS * VEC * UNROLL;   // elements a tile

// A launch's walk over the part's storage, from the host.
struct Walk {
  long long total;       // the part's elements
  long long n;           // a row's elements
  long long rows;
  long long tiles;
  long long delta;       // row 0's global index minus storage index
  long long dstep;       // two dims: that offset's step from row to row
  long long step_rows;   // gridDim.x * TILE as whole rows ...
  long long step_pos;    // ... and the rest
  uint32_t magic;        // ceil(2^32 / n) for 1 < n < TILE, else 0
  int table;             // row-table entries a tile (0: one row, or
                         // offsets linear in the row)
  bool fast;             // 16-byte aligned pointers (and, one row, a
                         // global start at a multiple of 4)
};

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
// a and b rounded to T, back in f32: bf16 in one pack, whose halves are
// the two values' top 16 bits
__device__ __forceinline__ void round2(float& a, float& b, const float*) {}
__device__ __forceinline__ void round2(float& a, float& b,
                                       const __nv_bfloat16*) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const uint32_t w = *reinterpret_cast<const uint32_t*>(&h);
  a = __uint_as_float(w << 16);
  b = __uint_as_float(w & 0xFFFF0000u);
}

// 16 bytes read once: the read-only path, no L1 allocation
__device__ __forceinline__ uint4 load16(const void* ptr) {
  uint4 v;
  asm("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(ptr));
  return v;
}
__device__ __forceinline__ void store16(void* ptr, uint4 v) {
  __stcs(static_cast<uint4*>(ptr), v);
}
// eight consecutive elements in f32 from their 16-byte words, and back
template <typename T>
__device__ __forceinline__ void unpack8(const uint4* w, float v[8]);
template <>
__device__ __forceinline__ void unpack8<float>(const uint4* w, float v[8]) {
  const uint32_t u[8] = {w[0].x, w[0].y, w[0].z, w[0].w,
                         w[1].x, w[1].y, w[1].z, w[1].w};
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = __uint_as_float(u[i]);
}
template <>
__device__ __forceinline__ void unpack8<__nv_bfloat16>(const uint4* w,
                                                       float v[8]) {
  const uint32_t u[4] = {w[0].x, w[0].y, w[0].z, w[0].w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {   // bf16 -> f32 is the 16 bits on top
    v[2 * i] = __uint_as_float(u[i] << 16);
    v[2 * i + 1] = __uint_as_float(u[i] & 0xFFFF0000u);
  }
}
__device__ __forceinline__ void store8(float* x, const float v[8]) {
  store16(x, make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]),
                        __float_as_uint(v[2]), __float_as_uint(v[3])));
  store16(x + 4, make_uint4(__float_as_uint(v[4]), __float_as_uint(v[5]),
                            __float_as_uint(v[6]), __float_as_uint(v[7])));
}
__device__ __forceinline__ void store8(__nv_bfloat16* x, const float v[8]) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    w[i] = *reinterpret_cast<const uint32_t*>(&h);
  }
  store16(x, make_uint4(w[0], w[1], w[2], w[3]));
}

// The update of one leaf's part: out = p - alpha (g + shift + scale z).
template <typename T, int MODE>
struct Sgd {
  static constexpr int WORDS = VEC * sizeof(T) / 16;   // 16-byte words
  T* out;
  const T* p;
  const T* g;
  const float* z;
  float sh, sc, alpha;
  ctr::Keys keys;
  uint32_t leaf;

  // The (up to) four elements of group q whose global index j lies in
  // [jlo, jhi), at element base + j: the simple kernel's per-group code.
  __device__ __forceinline__ void group(long long q, long long jlo,
                                        long long jhi, long long base) const {
    const T* tag = nullptr;
    float zz[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (MODE == 2)
      ctr::normals4(ctr::draw_bits(q, leaf, ctr::NOISE, keys), zz);
#pragma unroll
    for (int lane = 0; lane < 4; ++lane) {
      const long long j = 4 * q + lane;
      if (j < jlo || j >= jhi) continue;
      const long long e = base + j;
      float x = round_to(__fadd_rn(load(g, e), sh), tag);
      if (MODE != 0) {
        const float zv = MODE == 1 ? z[e] : zz[lane];
        x = round_to(__fadd_rn(x, round_to(__fmul_rn(sc, zv), tag)), tag);
      }
      store(out, e, __fsub_rn(load(p, e), __fmul_rn(alpha, x)));
    }
  }

  // Elements e0 .. e0 + 7, global indices 4 q0 .. 4 q0 + 7: the same
  // arithmetic, two elements a pack.
  __device__ __forceinline__ void vector(long long e0, long long q0) const {
    const T* tag = nullptr;
    uint4 pw[WORDS], gw[WORDS];
#pragma unroll
    for (int c = 0; c < WORDS; ++c) {
      pw[c] = load16(p + e0 + c * (VEC / WORDS));
      gw[c] = load16(g + e0 + c * (VEC / WORDS));
    }
    float pv[8], gv[8], zz[8], o[8];
    unpack8<T>(pw, pv);
    unpack8<T>(gw, gv);
    if (MODE == 1) {
      const uint4 zw[2] = {load16(z + e0), load16(z + e0 + 4)};
      unpack8<float>(zw, zz);
    }
    if (MODE == 2) {
      ctr::normals4(ctr::draw_bits(q0, leaf, ctr::NOISE, keys), zz);
      ctr::normals4(ctr::draw_bits(q0 + 1, leaf, ctr::NOISE, keys), zz + 4);
    }
#pragma unroll
    for (int i = 0; i < 8; i += 2) {
      float x0 = __fadd_rn(gv[i], sh), x1 = __fadd_rn(gv[i + 1], sh);
      round2(x0, x1, tag);
      if (MODE != 0) {
        float s0 = __fmul_rn(sc, zz[i]), s1 = __fmul_rn(sc, zz[i + 1]);
        round2(s0, s1, tag);
        x0 = __fadd_rn(x0, s0);
        x1 = __fadd_rn(x1, s1);
        round2(x0, x1, tag);
      }
      o[i] = __fsub_rn(pv[i], __fmul_rn(alpha, x0));
      o[i + 1] = __fsub_rn(pv[i + 1], __fmul_rn(alpha, x1));
    }
    store8(out + e0, o);
  }
};

// The init's fill: out = the truncated normal times scale.
template <typename T>
struct Trunc {
  T* out;
  float scale, lo, width;
  ctr::Keys keys;
  uint32_t leaf;

  __device__ __forceinline__ void group(long long q, long long jlo,
                                        long long jhi, long long base) const {
    const uint4 x = ctr::draw_bits(q, leaf, ctr::INIT, keys);
    const uint32_t bits[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int lane = 0; lane < 4; ++lane) {
      const long long j = 4 * q + lane;
      if (j < jlo || j >= jhi) continue;
      store(out, base + j,
            __fmul_rn(ctr::trunc_normal(bits[lane], lo, width), scale));
    }
  }

  __device__ __forceinline__ void vector(long long e0, long long q0) const {
    const uint4 a = ctr::draw_bits(q0, leaf, ctr::INIT, keys);
    const uint4 b = ctr::draw_bits(q0 + 1, leaf, ctr::INIT, keys);
    const uint32_t bits[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
    float o[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      o[i] = __fmul_rn(ctr::trunc_normal(bits[i], lo, width), scale);
    store8(out + e0, o);
  }
};

// Storage [a, b) of one row whose global index is storage + delta, group
// by group.
template <class Op>
__device__ __forceinline__ void run(const Op& op, long long a, long long b,
                                    long long delta) {
  const long long ja = a + delta, jb = b + delta;
  for (long long q = ja >> 2; q <= (jb - 1) >> 2; ++q)
    op.group(q, ja, jb, -delta);
}

// Slot u of tile t: its first element.
__device__ __forceinline__ long long slot(long long t, int u) {
  return t * TILE + static_cast<long long>(u * THREADS + threadIdx.x) * VEC;
}

// A part of one row: every slot's global index is its storage + delta.
template <class Op>
__device__ __forceinline__ void walk_row(const Op& op, const Walk& w) {
  for (long long t = blockIdx.x; t < w.tiles; t += gridDim.x) {
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long e0 = slot(t, u);
      if (e0 >= w.total) break;
      if (w.fast && e0 + VEC <= w.total)
        op.vector(e0, (e0 + w.delta) >> 2);
      else
        run(op, e0, e0 + VEC < w.total ? e0 + VEC : w.total, w.delta);
    }
  }
}

// A part of many rows.  LINEAR (two merged dims): row r's global-minus-
// storage offset is delta + r dstep; else from a shared table the block
// fills a tile at a time.
template <bool LINEAR, class Op>
__device__ __forceinline__ void walk_rows(const Op& op, const Walk& w,
                                          const ctr::Part& part,
                                          long long* table) {
  const long long n = w.n;
  long long r0 = static_cast<long long>(blockIdx.x) * TILE / n;
  long long pos0 = static_cast<long long>(blockIdx.x) * TILE - r0 * n;
  for (long long t = blockIdx.x; t < w.tiles; t += gridDim.x) {
    const long long t0 = t * TILE;
    if (!LINEAR) {
      __syncthreads();   // the last tile's slots have read the table
      for (int k = threadIdx.x; k < w.table; k += THREADS)
        if (r0 + k < w.rows)
          table[k] = ctr::row_start(part, r0 + k) - (r0 + k) * n;
      __syncthreads();
    }
    const long long d0 = LINEAR ? w.delta + r0 * w.dstep : 0;
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int off = (u * THREADS + threadIdx.x) * VEC;
      const long long e0 = t0 + off;
      if (e0 >= w.total) break;
      // the slot's row, k rows past the tile's first, and its offset in
      // it: pos0 + off < n + TILE, so one compare when n >= TILE, else a
      // 32-bit quotient
      int k;
      long long pos;
      if (n >= TILE) {
        const long long local = pos0 + off;
        k = local >= n;
        pos = k ? local - n : local;
      } else {
        const uint32_t local = static_cast<uint32_t>(pos0) + off;
        const uint32_t n32 = static_cast<uint32_t>(n);
        k = static_cast<int>(w.magic ? __umulhi(local, w.magic) : local);
        pos = local - static_cast<uint32_t>(k) * n32;
      }
      long long delta = LINEAR ? d0 + k * w.dstep : table[k];
      if (w.fast && pos + VEC <= n && (delta & 3) == 0) {
        op.vector(e0, (e0 + delta) >> 2);
        continue;
      }
      const long long e1 = e0 + VEC < w.total ? e0 + VEC : w.total;
      for (long long a = e0, end = e0 - pos + n; a < e1; end += n) {
        const long long stop = e1 < end ? e1 : end;
        run(op, a, stop, delta);
        a = stop;
        if (a < e1) delta = LINEAR ? delta + w.dstep : table[++k];
      }
    }
    r0 += w.step_rows;
    pos0 += w.step_pos;
    if (pos0 >= n) {
      pos0 -= n;
      ++r0;
    }
  }
}

template <class Op>
__device__ __forceinline__ void walk(const Op& op, const Walk& w,
                                     const ctr::Part& part, long long* table) {
  if (w.rows == 1)
    walk_row(op, w);
  else if (w.table == 0)
    walk_rows<true>(op, w, part, table);
  else
    walk_rows<false>(op, w, part, table);
}

template <typename T, int MODE>
__global__ void __launch_bounds__(THREADS)
noisy_sgd_kernel(T* __restrict__ out, const T* __restrict__ p,
                 const T* __restrict__ g, const T* __restrict__ shift,
                 const float* __restrict__ scale, const float* __restrict__ z,
                 float alpha, const uint32_t* __restrict__ key, uint32_t leaf,
                 ctr::Part part, Walk w) {
  // the key's two words from device memory (the seed's int64, little
  // endian: lo32, hi32), read only where z is drawn
  const uint2 k = MODE == 2 ? make_uint2(key[0], key[1]) : make_uint2(0u, 0u);
  const Sgd<T, MODE> op{out, p, g, z, load(shift, 0),
                        MODE == 0 ? 0.0f : scale[0], alpha,
                        ctr::round_keys(k), leaf};
  extern __shared__ long long table[];
  walk(op, w, part, table);
}

// At most 32 registers (8 blocks an SM): ptxas gives the fill 54-64
// otherwise, and the cap's spills cost less than the warps lost (0.738
// against 0.789 ms at qwen3-4b's embedding on an H100 80GB HBM3 at 700 W,
// tools/noisy_update_yardstick.py).
template <typename T>
__global__ void __launch_bounds__(THREADS, 8)
counter_trunc_normal_kernel(T* __restrict__ out, float scale, float lo,
                            float width, uint2 key, uint32_t leaf,
                            ctr::Part part, Walk w) {
  const Trunc<T> op{out, scale, lo, width, ctr::round_keys(key), leaf};
  extern __shared__ long long table[];
  walk(op, w, part, table);
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

bool aligned16(const void* ptr) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

// The walk of a launch of `kernel` over `part`, with as many blocks as fit
// the SMs at once (at most one a tile); *smem the row table's bytes.
template <class K>
Walk plan(K kernel, const ctr::Part& part, long long rows, bool aligned,
          unsigned* blocks, size_t* smem) {
  Walk w;
  w.n = part.len[part.nd - 1];
  w.rows = rows;
  w.total = rows * w.n;
  w.tiles = (w.total + TILE - 1) / TILE;
  // a table only where row starts are not linear in the row (3+ dims)
  const long long table = 2 + (TILE - 2) / w.n;
  w.table = rows == 1 || part.nd == 2
                ? 0
                : static_cast<int>(table < rows ? table : rows);
  *smem = static_cast<size_t>(w.table) * sizeof(long long);
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS,
                                                *smem);
  long long b = static_cast<long long>(per_sm > 0 ? per_sm : 1) *
                (sms > 0 ? sms : 1);
  if (b > w.tiles) b = w.tiles;
  *blocks = static_cast<unsigned>(b);
  const long long stride = b * TILE;
  w.step_rows = stride / w.n;
  w.step_pos = stride % w.n;
  // row 0's global-minus-storage offset, and (two dims) its step a row
  w.delta = ctr::row_start(part, 0);
  w.dstep = part.nd == 2 ? part.stride[0] - w.n : 0;
  w.magic = w.n > 1 && w.n < TILE
                ? static_cast<uint32_t>(((1ull << 32) + w.n - 1) / w.n)
                : 0u;
  w.fast = aligned && (rows > 1 || (w.delta & 3) == 0);
  return w;
}

template <typename T, int MODE>
int launch_sgd_mode(void* out, const void* p, const void* g,
                    const void* shift, const void* scale, const void* z,
                    float alpha, const void* key, uint32_t leaf,
                    const ctr::Part& part, long long rows, cudaStream_t st) {
  auto kernel = noisy_sgd_kernel<T, MODE>;
  const bool aligned = aligned16(out) && aligned16(p) && aligned16(g) &&
                       (MODE != 1 || aligned16(z));
  unsigned blocks = 0;
  size_t smem = 0;
  const Walk w =
      plan(kernel, part, rows, aligned, &blocks, &smem);
  kernel<<<blocks, THREADS, smem, st>>>(
      static_cast<T*>(out), static_cast<const T*>(p),
      static_cast<const T*>(g), static_cast<const T*>(shift),
      static_cast<const float*>(scale), static_cast<const float*>(z), alpha,
      static_cast<const uint32_t*>(key), leaf, part, w);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_sgd(void* out, const void* p, const void* g, const void* shift,
               const void* scale, const void* z, float alpha, int mode,
               const void* key, uint32_t leaf, const ctr::Part& part,
               long long rows, cudaStream_t st) {
  if (mode == 0)
    return launch_sgd_mode<T, 0>(out, p, g, shift, scale, z, alpha, key,
                                 leaf, part, rows, st);
  if (mode == 1)
    return launch_sgd_mode<T, 1>(out, p, g, shift, scale, z, alpha, key,
                                 leaf, part, rows, st);
  return launch_sgd_mode<T, 2>(out, p, g, shift, scale, z, alpha, key, leaf,
                               part, rows, st);
}

template <typename T>
int launch_trunc(void* out, float scale, float lo, float width, uint2 key,
                 uint32_t leaf, const ctr::Part& part, long long rows,
                 cudaStream_t st) {
  auto kernel = counter_trunc_normal_kernel<T>;
  unsigned blocks = 0;
  size_t smem = 0;
  const Walk w =
      plan(kernel, part, rows, aligned16(out), &blocks, &smem);
  kernel<<<blocks, THREADS, smem, st>>>(static_cast<T*>(out), scale, lo,
                                        width, key, leaf, part, w);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// out = p - alpha (g + shift + scale z) with the reference's roundings, for
// one part of one leaf (p, g, out contiguous in the part's row-major order;
// dtype code 0 = f32, 1 = bf16; shift a one-element tensor in that dtype,
// scale one f32, both on the device).  mode 0: no z; 1: z a contiguous f32
// tensor of the part's shape; 2: z drawn from the stream (key, leaf,
// purpose 0) at the part's global indices, the key the two 32-bit words
// (lo, hi) at `key` in device memory (the seed's int64; unread in modes 0
// and 1), so a captured launch draws under whatever seed the tensor holds
// at replay.  The part: nd collapsed dims of the leaf's whole row-major
// strides, the part's offsets and lengths.  Returns the launch's error
// code.
int noisy_sgd(void* out, const void* p, const void* g, const void* shift,
              const void* scale, const void* z, float alpha, int mode,
              const void* key, uint32_t leaf, int nd, const int64_t* stride,
              const int64_t* off, const int64_t* len, int dtype,
              void* stream) {
  ctr::Part part;
  long long rows = 0;
  if (!make_part(nd, stride, off, len, &part, &rows) || mode < 0 ||
      mode > 2 || (mode == 2 && key == nullptr))
    return cudaErrorInvalidValue;
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
  if (dtype == F32)
    return launch_trunc<float>(out, scale, lo, width, key, leaf, part, rows,
                               st);
  if (dtype == BF16)
    return launch_trunc<__nv_bfloat16>(out, scale, lo, width, key, leaf,
                                       part, rows, st);
  return cudaErrorInvalidValue;
}

}  // extern "C"
