// GQA flash-decoding for sm_90a: one query token per batch row against an
// S-long KV cache.
//
// Replaces the Pallas kernel src/repro/kernels/decode_attention.py::
// decode_attention (_kernel): for query head h of batch row b, with KV head
// h / G (G = H / KV, the reference's q.reshape(kvh, g, dh)),
//
//   s_j = q[b,h] . k[b,j,h/G] / sqrt(dh)   for cache positions j <= pos
//   out[b,h] = sum_j softmax(s)_j v[b,j,h/G]
//
// with the softmax kept online in f32 (running max m, sum l, acc[dh]) and
// the output acc / max(l, 1e-30) cast to q's dtype.  q [B, H, dh], k/v
// [B, S, KV, dh], pos a 0-d int32 on the device, out [B, H, dh].
//
// Bound: bytes.  The function reads K and V up to pos once, 2 * B * (pos+1)
// * KV * dh elements (1.07 GB at B = 8, S = 32768, KV = 8, dh = 128, bf16),
// and does about 4 f32 operations per byte read (q.k and p.v, G = 4 query
// heads per KV row), so 3.35 TB/s and not the 67 TFLOP/s of f32 arithmetic
// sets its least time.  A first kernel need not reach that bound: wgmma and
// TMA pipelines come in a later revision.
//
// The Pallas kernel walks S as a sequential grid axis and carries (m, l,
// acc) in VMEM from one S tile to the next (decode_attention.py:33-37).
// Hopper's blocks run in parallel and in no order, so this kernel splits S
// instead (split-K, the reference's decode_local_partial + combine_partials
// rules, attention.py:252-258):
//
//   pass 1  grid (B * KV * ceil(G / GB), n_split).  A block owns one (batch
//           row, KV head, group of up to GB = 4 query heads) and one chunk
//           of the valid positions [0, min(pos + 1, S)).  It loads its query
//           rows once into registers and streams its K/V chunk with 16-byte
//           loads, neighbouring threads on neighbouring dh elements (a
//           bf16 K row of dh = 128 is 256 bytes: 16 lanes).  Each row group
//           of dh / VEC lanes walks every RG-th key, UNROLL keys at a time
//           (all UNROLL K and V loads issued before any arithmetic), keeping
//           its own (m, l, acc); the row groups merge in shared memory and
//           the block writes one partial (m, l, acc[dh]) per head in f32.
//   pass 2  grid (B * H): m* = max_i m_i, l = sum_i l_i e^{m_i - m*}, acc =
//           sum_i acc_i e^{m_i - m*}, out = acc / max(l, 1e-30).  With one
//           split, pass 1 writes the output itself and pass 2 is not run.
//
// The chunks are cut from pos, which the kernel reads on the device: keys
// above pos are never loaded, the work is balanced over the positions that
// count, and the decode step needs no host sync (a CUDA graph can capture
// it).  A block whose chunk is empty writes the neutral partial (m = -1e30,
// l = 0, acc = 0), which the combine weighs by e^{-1e30 - m*} = 0.  The
// ragged S edge is the chunk's end; nothing is padded.  The wrapper picks
// n_split so that the grid fills whole waves of resident blocks, from the
// occupancy that decode_attention_occupancy reports.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int GB = 4;        // query heads per block
constexpr int UNROLL = 4;    // keys per row group per iteration
constexpr float NEG = -1e30f;

template <typename T>
struct Vec;  // 16 bytes of T
template <>
struct Vec<float> {
  using type = float4;
  static constexpr int N = 4;
};
template <>
struct Vec<__nv_bfloat16> {
  using type = uint4;
  static constexpr int N = 8;
};

__device__ __forceinline__ void unpack(const float4& r, float* x) {
  x[0] = r.x;
  x[1] = r.y;
  x[2] = r.z;
  x[3] = r.w;
}

__device__ __forceinline__ void unpack(const uint4& r, float* x) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(p[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <typename T, int DH>
__global__ void __launch_bounds__(THREADS)
decode_partial_kernel(const T* __restrict__ q,        // [B, H, DH]
                      const T* __restrict__ k,        // [B, S, KV, DH]
                      const T* __restrict__ v,        // [B, S, KV, DH]
                      const int* __restrict__ pos_ptr,
                      T* __restrict__ out,            // [B, H, DH]
                      float* __restrict__ ws_m,       // [B, H, n_split]
                      float* __restrict__ ws_l,       // [B, H, n_split]
                      float* __restrict__ ws_acc,     // [B, H, n_split, DH]
                      int s_len, int kvh, int g, int hgroups, int n_split) {
  using V = Vec<T>;
  constexpr int VEC = V::N;
  constexpr int LPK = DH / VEC;         // lanes per key row
  constexpr int RG = THREADS / LPK;     // row groups per block
  static_assert(LPK <= 32 && 32 % LPK == 0, "a key row must fit one warp");

  __shared__ float sm_m[RG][GB];
  __shared__ float sm_l[RG][GB];
  __shared__ float sm_acc[RG][GB][DH];

  const int hg = blockIdx.x % hgroups;
  const int kv = (blockIdx.x / hgroups) % kvh;
  const int b = blockIdx.x / (hgroups * kvh);
  const int split = blockIdx.y;
  const int heads = kvh * g;
  const int h0 = kv * g + hg * GB;
  const int gcount = min(GB, g - hg * GB);
  const int row = threadIdx.x / LPK;
  const int d0 = (threadIdx.x % LPK) * VEC;

  // this block's chunk of the valid positions [0, min(pos + 1, S))
  const int pos = *pos_ptr;
  const int valid = pos < 0 ? 0 : (pos >= s_len ? s_len : pos + 1);
  const int chunk = (valid + n_split - 1) / n_split;
  const int start = split * chunk;
  const int end = min(start + chunk, valid);

  const float scale = 1.0f / sqrtf((float)DH);
  float qf[GB][VEC];
#pragma unroll
  for (int gi = 0; gi < GB; ++gi) {
    if (gi < gcount) {
      const T* qp = q + ((int64_t)b * heads + h0 + gi) * DH + d0;
      unpack(*reinterpret_cast<const typename V::type*>(qp), qf[gi]);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) qf[gi][e] = 0.0f;
    }
  }

  float m[GB], l[GB], acc[GB][VEC];
#pragma unroll
  for (int gi = 0; gi < GB; ++gi) {
    m[gi] = NEG;
    l[gi] = 0.0f;
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[gi][e] = 0.0f;
  }

  const int64_t key_stride = (int64_t)kvh * DH;  // elements between keys
  const int64_t off0 = ((int64_t)b * s_len * kvh + kv) * DH + d0;
  const T* kb = k + off0;
  const T* vb = v + off0;

  // The loop bound is the block's, so every lane of a warp takes part in
  // the shuffles; a row group's keys past `end` are not loaded and weigh 0.
  for (int base = start + row; base - row < end; base += RG * UNROLL) {
    typename V::type kr[UNROLL], vr[UNROLL];
    bool ok[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int j = base + u * RG;
      ok[u] = j < end;
      if (ok[u]) {
        kr[u] = *reinterpret_cast<const typename V::type*>(kb + j * key_stride);
        vr[u] = *reinterpret_cast<const typename V::type*>(vb + j * key_stride);
      } else {
        kr[u] = {};
        vr[u] = {};
      }
    }
    float sc[UNROLL][GB];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      float kf[VEC];
      unpack(kr[u], kf);
#pragma unroll
      for (int gi = 0; gi < GB; ++gi) {
        float dot = 0.0f;
#pragma unroll
        for (int e = 0; e < VEC; ++e) dot = fmaf(qf[gi][e], kf[e], dot);
        sc[u][gi] = dot;
      }
    }
    // sum over the LPK lanes of each key row (aligned groups of a warp)
#pragma unroll
    for (int off = LPK / 2; off > 0; off >>= 1) {
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
#pragma unroll
        for (int gi = 0; gi < GB; ++gi)
          sc[u][gi] += __shfl_xor_sync(0xffffffffu, sc[u][gi], off);
      }
    }
    // online softmax: sc becomes the weight p of each key (0 past `end`)
#pragma unroll
    for (int gi = 0; gi < GB; ++gi) {
      float mt = NEG;
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        sc[u][gi] *= scale;
        if (ok[u]) mt = fmaxf(mt, sc[u][gi]);
      }
      const float m_new = fmaxf(m[gi], mt);
      const float corr = expf(m[gi] - m_new);
      m[gi] = m_new;
      float psum = 0.0f;
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        sc[u][gi] = ok[u] ? expf(sc[u][gi] - m_new) : 0.0f;
        psum += sc[u][gi];
      }
      l[gi] = fmaf(l[gi], corr, psum);
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[gi][e] *= corr;
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      float vf[VEC];
      unpack(vr[u], vf);
#pragma unroll
      for (int gi = 0; gi < GB; ++gi) {
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          acc[gi][e] = fmaf(sc[u][gi], vf[e], acc[gi][e]);
      }
    }
  }

  // merge the row groups' states
  if (d0 == 0) {
#pragma unroll
    for (int gi = 0; gi < GB; ++gi) {
      sm_m[row][gi] = m[gi];
      sm_l[row][gi] = l[gi];
    }
  }
#pragma unroll
  for (int gi = 0; gi < GB; ++gi) {
#pragma unroll
    for (int e = 0; e < VEC; ++e) sm_acc[row][gi][d0 + e] = acc[gi][e];
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < gcount * DH; idx += THREADS) {
    const int gi = idx / DH;
    const int d = idx % DH;
    float mx = NEG;
#pragma unroll
    for (int r = 0; r < RG; ++r) mx = fmaxf(mx, sm_m[r][gi]);
    float lsum = 0.0f, a = 0.0f;
#pragma unroll
    for (int r = 0; r < RG; ++r) {
      const float w = expf(sm_m[r][gi] - mx);
      lsum = fmaf(sm_l[r][gi], w, lsum);
      a = fmaf(sm_acc[r][gi][d], w, a);
    }
    const int64_t bh = (int64_t)b * heads + h0 + gi;
    if (n_split == 1) {
      store(out + bh * DH + d, a / fmaxf(lsum, 1e-30f));
    } else {
      const int64_t o = bh * n_split + split;
      ws_acc[o * DH + d] = a;
      if (d == 0) {
        ws_m[o] = mx;
        ws_l[o] = lsum;
      }
    }
  }
}

template <typename T>
__global__ void decode_combine_kernel(const float* __restrict__ ws_m,
                                      const float* __restrict__ ws_l,
                                      const float* __restrict__ ws_acc,
                                      T* __restrict__ out, int dh,
                                      int n_split) {
  const int64_t bh = blockIdx.x;
  const int d = threadIdx.x;
  const float* m = ws_m + bh * n_split;
  const float* l = ws_l + bh * n_split;
  const float* acc = ws_acc + bh * n_split * dh + d;
  float mx = NEG;
  for (int i = 0; i < n_split; ++i) mx = fmaxf(mx, m[i]);
  float lsum = 0.0f, a = 0.0f;
  for (int i = 0; i < n_split; ++i) {
    const float w = expf(m[i] - mx);
    lsum = fmaf(l[i], w, lsum);
    a = fmaf(acc[(int64_t)i * dh], w, a);
  }
  store(out + bh * dh + d, a / fmaxf(lsum, 1e-30f));
}

constexpr int F32 = 0;
constexpr int BF16 = 1;

template <typename T, int DH>
int launch(const void* q, const void* k, const void* v, const void* pos,
           void* out, void* ws, int b, int h, int kvh, int s_len,
           int n_split, cudaStream_t st) {
  const int g = h / kvh;
  const int hgroups = (g + GB - 1) / GB;
  const int64_t bhn = (int64_t)b * h * n_split;
  float* ws_m = static_cast<float*>(ws);
  float* ws_l = ws_m + bhn;
  float* ws_acc = ws_l + bhn;
  const dim3 grid((unsigned)(b * kvh * hgroups), (unsigned)n_split);
  decode_partial_kernel<T, DH><<<grid, THREADS, 0, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(pos),
      static_cast<T*>(out), ws_m, ws_l, ws_acc, s_len, kvh, g, hgroups,
      n_split);
  if (n_split > 1) {
    decode_combine_kernel<T><<<(unsigned)(b * h), DH, 0, st>>>(
        ws_m, ws_l, ws_acc, static_cast<T*>(out), DH, n_split);
  }
  return cudaGetLastError();
}

template <typename T>
int launch_dh(int dh, const void* q, const void* k, const void* v,
              const void* pos, void* out, void* ws, int b, int h, int kvh,
              int s_len, int n_split, cudaStream_t st) {
  switch (dh) {
    case 32:
      return launch<T, 32>(q, k, v, pos, out, ws, b, h, kvh, s_len, n_split,
                           st);
    case 64:
      return launch<T, 64>(q, k, v, pos, out, ws, b, h, kvh, s_len, n_split,
                           st);
    case 128:
      return launch<T, 128>(q, k, v, pos, out, ws, b, h, kvh, s_len,
                            n_split, st);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
int occupancy_dh(int dh) {
  int blocks = 0;
  cudaError_t err = cudaErrorInvalidValue;
  switch (dh) {
    case 32:
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, decode_partial_kernel<T, 32>, THREADS, 0);
      break;
    case 64:
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, decode_partial_kernel<T, 64>, THREADS, 0);
      break;
    case 128:
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, decode_partial_kernel<T, 128>, THREADS, 0);
      break;
  }
  return err == cudaSuccess ? blocks : -1;
}

}  // namespace

extern "C" {

// q [B, H, dh], k/v [B, S, KV, dh] (dtype code 0 = f32, 1 = bf16; every
// pointer 16-byte aligned), pos -> one int32 on the device, out [B, H, dh];
// ws: 2 * B * H * n_split + B * H * n_split * dh floats when n_split > 1
// (unused otherwise).  Returns cudaGetLastError() after the launches.
int decode_attention(const void* q, const void* k, const void* v,
                     const void* pos, void* out, void* ws, int b, int h,
                     int kvh, int s_len, int dh, int n_split, int dtype,
                     void* stream) {
  if (b < 1 || kvh < 1 || h % kvh != 0 || s_len < 1 || n_split < 1 ||
      n_split > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == F32)
    return launch_dh<float>(dh, q, k, v, pos, out, ws, b, h, kvh, s_len,
                            n_split, st);
  if (dtype == BF16)
    return launch_dh<__nv_bfloat16>(dh, q, k, v, pos, out, ws, b, h, kvh,
                                    s_len, n_split, st);
  return cudaErrorInvalidValue;
}

// Resident pass-1 blocks per SM for (dh, dtype), or -1 on error.
int decode_attention_occupancy(int dh, int dtype) {
  if (dtype == F32) return occupancy_dh<float>(dh);
  if (dtype == BF16) return occupancy_dh<__nv_bfloat16>(dh);
  return -1;
}

}  // extern "C"
