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
// and does 2 G multiply-adds per element read (q.k and p.v), so 3.35 TB/s
// sets its least time; the arithmetic is ~1 % of the card's bf16 tensor
// rate.  What keeps a kernel off that bound is bytes in flight: the card
// needs ~3-4 MB of loads outstanding (3.35 TB/s times ~1 us of latency),
// ~25-30 KB per SM, whatever the warps are computing meanwhile.
//
// The Pallas kernel walks S as a sequential grid axis and carries (m, l,
// acc) in VMEM from one S tile to the next (decode_attention.py:33-37).
// Hopper's blocks run in parallel and in no order, so this kernel splits S
// instead (split-K, the reference's decode_local_partial + combine_partials
// rules, attention.py:252-258):
//
//   pass 1  grid (B * KV * ceil(G / GB), n_split).  A block owns one (batch
//           row, KV head, group of up to GB query heads) and one chunk of
//           the valid positions [0, min(pos + 1, S)), and writes one
//           partial (m, l, acc[dh]) per head in f32.
//   pass 2  grid (B * H): m* = max_i m_i, l = sum_i l_i e^{m_i - m*}, acc =
//           sum_i acc_i e^{m_i - m*}, out = acc / max(l, 1e-30).  With one
//           split, pass 1 writes the output itself and pass 2 is not run.
//
// bf16 pass 1 (decode_mma_kernel): GB = 8, so all G <= 8 query heads of a
// KV head share one read of its K/V (qwen3-4b has G = 4; G = 6 and 8 no
// longer read K/V twice).  Four warps stream the chunk through a ring of
// NSTAGE = 3 shared-memory stages of TK = 64 keys of K and V, filled with
// cp.async.cg 16-byte copies (commit_group / wait_group), so two stages
// (64 KB at dh = 128) are in flight per block while the warps compute on
// the third: the bytes in flight are set by the ring, not by registers.
// Rows are XOR-swizzled by 16-byte chunk, so ldmatrix reads them without
// bank conflicts.  Each warp owns 16 keys of a stage:
//   S  = K . q^T   mma.sync m16n8k16 bf16 (keys as M, the 8 heads as N,
//                  dh as K), f32 accumulate; q^T stays in registers;
//   online softmax in f32 registers (exp2 of log2-scaled scores; the max
//                  over the 16 keys is 3 shuffles per head);
//   O += V^T . P   mma.sync m16n8k8 tf32 (dh as M, keys as K, heads as N):
//                  V (ldmatrix.trans) widened exactly from bf16 to tf32,
//                  P rounded to tf32 (10-bit mantissa; the JAX oracle and
//                  the plain version round it to bf16, the Pallas kernel
//                  keeps it in f32).  The [key, head] -> [head, key]
//                  transpose of P from the first product's accumulator to
//                  the second's B operand is two movmatrix per 8 keys.
// The four warps' (m, l, O) merge through shared memory at the end.
// Keys past the chunk's end (pos, or the cache's end) are never read:
// their ring rows are zero-filled by cp.async with src-size 0, and their
// scores are masked, so NaN above pos cannot reach O through 0 * NaN.
//
// f32 pass 1 (decode_f32_kernel, the parity route): CUDA-core arithmetic
// in f32 (TF32 would break its 1e-5 tolerance), GB = 4 heads per block,
// 16-byte loads, UNROLL keys per row group in flight, shuffle reductions.
// A key row is spread over DH / VEC lanes of one warp, VEC = 4 floats a
// lane up to dh = 128 and 8 (two 16-byte loads) at dh = 256, so a row
// never straddles two warps.
//
// Head dim 256 (recurrentgemma-9b's local attention, MQA with G = 16) is
// one more instance of both kernels.  The bf16 ring is then NSTAGE * 2 *
// TK * DH * 2 = 192 KB of dynamic shared memory, under Hopper's 227 KB
// opt-in, so one block fits an SM; its two stages in flight (128 KB) are
// still four times the bytes an SM needs in flight.  O takes 64 f32
// registers a thread and q^T 32.  G = 16 takes two head groups of GB = 8,
// so a KV head's K/V are read twice (ROADMAP.md Queue 2 item 7).
//
// The chunks are cut from pos, which the kernel reads on the device: keys
// above pos are never loaded, the work is balanced over the positions that
// count, and the decode step needs no host sync (a CUDA graph can capture
// it).  A block whose chunk is empty writes the neutral partial (m = -1e30,
// l = 0, acc = 0), which the combine weighs by e^{-1e30 - m*} = 0.  The
// wrapper picks n_split so that the grid fills about one wave of resident
// blocks, from the occupancy that decode_attention_occupancy reports, and
// keeps a short cache in one pass (a second pass costs a launch).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// ---------------------------------------------------------------- f32 ----

constexpr int THREADS = 128;
constexpr int GB_F32 = 4;    // query heads per block
constexpr int UNROLL = 4;    // keys per row group per iteration

template <int DH>
__global__ void __launch_bounds__(THREADS)
decode_f32_kernel(const float* __restrict__ q,        // [B, H, DH]
                  const float* __restrict__ k,        // [B, S, KV, DH]
                  const float* __restrict__ v,        // [B, S, KV, DH]
                  const int* __restrict__ pos_ptr,
                  float* __restrict__ out,            // [B, H, DH]
                  float* __restrict__ ws_m,           // [B, H, n_split]
                  float* __restrict__ ws_l,           // [B, H, n_split]
                  float* __restrict__ ws_acc,         // [B, H, n_split, DH]
                  int s_len, int kvh, int g, int hgroups, int n_split) {
  constexpr int GB = GB_F32;
  constexpr int VEC = DH > 128 ? DH / 32 : 4;   // floats a lane loads
  constexpr int NV = VEC / 4;           // 16-byte loads a lane
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
#pragma unroll
    for (int n = 0; n < NV; ++n) {
      float4 r = make_float4(0.f, 0.f, 0.f, 0.f);
      if (gi < gcount)
        r = *reinterpret_cast<const float4*>(
            q + ((int64_t)b * heads + h0 + gi) * DH + d0 + 4 * n);
      qf[gi][4 * n] = r.x;
      qf[gi][4 * n + 1] = r.y;
      qf[gi][4 * n + 2] = r.z;
      qf[gi][4 * n + 3] = r.w;
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
  const float* kb = k + off0;
  const float* vb = v + off0;

  // The loop bound is the block's, so every lane of a warp takes part in
  // the shuffles; a row group's keys past `end` are not loaded and weigh 0.
  for (int base = start + row; base - row < end; base += RG * UNROLL) {
    float4 kr[UNROLL][NV], vr[UNROLL][NV];
    bool ok[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int j = base + u * RG;
      ok[u] = j < end;
#pragma unroll
      for (int n = 0; n < NV; ++n) {
        if (ok[u]) {
          kr[u][n] = *reinterpret_cast<const float4*>(kb + j * key_stride +
                                                      4 * n);
          vr[u][n] = *reinterpret_cast<const float4*>(vb + j * key_stride +
                                                      4 * n);
        } else {
          kr[u][n] = make_float4(0.f, 0.f, 0.f, 0.f);
          vr[u][n] = kr[u][n];
        }
      }
    }
    float sc[UNROLL][GB];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      float kf[VEC];
#pragma unroll
      for (int n = 0; n < NV; ++n) {
        kf[4 * n] = kr[u][n].x;
        kf[4 * n + 1] = kr[u][n].y;
        kf[4 * n + 2] = kr[u][n].z;
        kf[4 * n + 3] = kr[u][n].w;
      }
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
#pragma unroll
      for (int n = 0; n < NV; ++n) {
        vf[4 * n] = vr[u][n].x;
        vf[4 * n + 1] = vr[u][n].y;
        vf[4 * n + 2] = vr[u][n].z;
        vf[4 * n + 3] = vr[u][n].w;
      }
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
      out[bh * DH + d] = a / fmaxf(lsum, 1e-30f);
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

// --------------------------------------------------------------- bf16 ----

constexpr int MMA_WARPS = 4;
constexpr int MMA_THREADS = 32 * MMA_WARPS;
constexpr int GB_MMA = 8;      // query heads per block: the mma's N
constexpr int TK = 64;         // keys per ring stage, 16 per warp
constexpr int NSTAGE = 3;      // ring depth: NSTAGE - 1 stages in flight

// Dynamic shared memory of decode_mma_kernel<DH>: the ring's K and V tiles
// (the warps' merge reuses it).
template <int DH>
constexpr int mma_smem_bytes() {
  return NSTAGE * 2 * TK * DH * 2;
}

// Element offset of 16-byte chunk c of ring row r.  The chunk index is
// XOR-swizzled with the row, so the 8 rows an ldmatrix reads at one
// logical chunk fall in 8 different bank groups (rows of 64 bytes at
// dh = 32 pair up within a 128-byte line, hence the shift).
template <int DH>
__device__ __forceinline__ int ring_offset(int r, int c) {
  constexpr int CPR = DH / 8;
  const int sw = CPR >= 8 ? (r & 7) : ((r >> 1) & (CPR - 1));
  return r * DH + ((c ^ sw) << 3);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src,
                                            int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ uint32_t movmatrix_trans(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n"
               : "=r"(y)
               : "r"(x));
  return y;
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t y;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(y) : "f"(x));
  return y;
}

// d += a (16x16, row) . b (16x8, col); bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a (16x8, row) . b (8x8, col); tf32 in, f32 accumulate
__device__ __forceinline__ void mma_tf32(float (&d)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// P[key][head] for 8 keys, held as an mma accumulator (lane (g, t): key g,
// heads 2t and 2t + 1: p0, p1), transposed exactly into the tf32 B operand
// of m16n8k8 (lane (g, t): head g, keys 2t -> b0 and 2t + 1 -> b1; the
// product's k order is keys 0, 2, 4, 6, 1, 3, 5, 7, which V's A operand
// follows).  movmatrix moves 16-bit halves, so the high and the low halves
// of the tf32 words travel separately.
__device__ __forceinline__ void p_to_b(float p0, float p1, uint32_t& b0,
                                       uint32_t& b1) {
  const uint32_t x0 = to_tf32(p0), x1 = to_tf32(p1);
  const uint32_t hi = movmatrix_trans((x1 & 0xffff0000u) | (x0 >> 16));
  const uint32_t lo = movmatrix_trans((x1 << 16) | (x0 & 0xffffu));
  b0 = (hi << 16) | (lo & 0xffffu);
  b1 = (hi & 0xffff0000u) | (lo >> 16);
}

template <int DH>
__global__ void __launch_bounds__(MMA_THREADS)
decode_mma_kernel(const __nv_bfloat16* __restrict__ q,   // [B, H, DH]
                  const __nv_bfloat16* __restrict__ k,   // [B, S, KV, DH]
                  const __nv_bfloat16* __restrict__ v,   // [B, S, KV, DH]
                  const int* __restrict__ pos_ptr,
                  __nv_bfloat16* __restrict__ out,       // [B, H, DH]
                  float* __restrict__ ws_m,              // [B, H, n_split]
                  float* __restrict__ ws_l,              // [B, H, n_split]
                  float* __restrict__ ws_acc,            // [B, H, n_split, DH]
                  int s_len, int kvh, int g, int hgroups, int n_split) {
  constexpr int CPR = DH / 8;          // 16-byte chunks per key row
  constexpr int TILE = TK * DH;        // elements of one K (or V) stage
  constexpr int KSTEPS = DH / 16;      // k-steps of S = K q^T
  constexpr int MTILES = DH / 16;      // 16-row tiles of O = V^T P
  static_assert(TK == 16 * MMA_WARPS, "one 16-key slice per warp");
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem_raw);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gq = lane >> 2;   // mma groupID
  const int tq = lane & 3;    // mma thread in group

  const int hg = blockIdx.x % hgroups;
  const int kv = (blockIdx.x / hgroups) % kvh;
  const int b = blockIdx.x / (hgroups * kvh);
  const int split = blockIdx.y;
  const int heads = kvh * g;
  const int h0 = kv * g + hg * GB_MMA;
  const int gcount = min(GB_MMA, g - hg * GB_MMA);

  // this block's chunk of the valid positions [0, min(pos + 1, S)), cut in
  // multiples of 16 keys (one warp's slice)
  const int pos = *pos_ptr;
  const int valid = pos < 0 ? 0 : (pos >= s_len ? s_len : pos + 1);
  const int chunk = ((valid + n_split - 1) / n_split + 15) & ~15;
  const int start = min(split * chunk, valid);
  const int end = min(start + chunk, valid);
  const int ntiles = (end - start + TK - 1) / TK;

  const int64_t key_stride = (int64_t)kvh * DH;  // elements between keys
  const int64_t off0 = ((int64_t)b * s_len * kvh + kv) * DH;
  const __nv_bfloat16* kb = k + off0;
  const __nv_bfloat16* vb = v + off0;

  // stage `tile` of the chunk into ring slot `slot`; rows past `end` are
  // zero-filled without a read (src-size 0, from a valid address)
  auto load_tile = [&](int tile, int slot) {
    const int kbase = start + tile * TK;
    const uint32_t ks = smem_u32(ring + slot * 2 * TILE);
    const uint32_t vs = ks + TILE * 2;
#pragma unroll
    for (int i = 0; i < TK * CPR / MMA_THREADS; ++i) {
      const int idx = tid + i * MMA_THREADS;
      const int r = idx / CPR;
      const int c = idx % CPR;
      const int key = kbase + r;
      const bool in = key < end;
      const int64_t src = (in ? key : start) * key_stride + c * 8;
      const uint32_t dst = ring_offset<DH>(r, c) * 2;
      cp_async_16(ks + dst, kb + src, in ? 16 : 0);
      cp_async_16(vs + dst, vb + src, in ? 16 : 0);
    }
  };

  // q^T as the B operand of S = K q^T: lane (g, t) holds head g, dh
  // 2t, 2t+1 (+8) of each 16-wide k-step; heads past gcount are 0
  uint32_t qb[KSTEPS][2];
  {
    const uint32_t* qrow = reinterpret_cast<const uint32_t*>(
        q + ((int64_t)b * heads + h0 + gq) * DH);
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      qb[kk][0] = gq < gcount ? qrow[kk * 8 + tq] : 0u;
      qb[kk][1] = gq < gcount ? qrow[kk * 8 + 4 + tq] : 0u;
    }
  }

  // per lane: heads 2t and 2t+1 (h = 0, 1); m in log2 units, l a partial
  // sum over this lane's keys, o[i] the accumulator of dh rows 16i + g and
  // 16i + g + 8 (o[i][h] and o[i][2 + h])
  const float qk_scale = LOG2E / sqrtf((float)DH);
  float m[2] = {NEG, NEG};
  float l[2] = {0.0f, 0.0f};
  float o[MTILES][4];
#pragma unroll
  for (int i = 0; i < MTILES; ++i)
    o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.0f;

  // ldmatrix row addresses (bytes within a stage), per lane: for K (A of
  // S, non-transposed) matrix mi = lane / 8 covers keys +8 (mi & 1) and
  // chunk +(mi >> 1); for V (A of O, transposed) keys +8 (mi >> 1) and
  // chunk +(mi & 1)
  const int mi = lane >> 3;
  const int k_row = warp * 16 + (lane & 7) + ((mi & 1) << 3);
  const int v_row = warp * 16 + (lane & 7) + ((mi >> 1) << 3);

#pragma unroll
  for (int s = 0; s < NSTAGE - 1; ++s) {
    if (s < ntiles) load_tile(s, s);
    cp_async_commit();
  }

  for (int tile = 0; tile < ntiles; ++tile) {
    cp_async_wait<NSTAGE - 2>();
    __syncthreads();  // tile landed for every thread; tile - 1's slot free
    if (tile + NSTAGE - 1 < ntiles)
      load_tile(tile + NSTAGE - 1, (tile + NSTAGE - 1) % NSTAGE);
    cp_async_commit();

    const int key0 = start + tile * TK + warp * 16;
    if (key0 >= end) continue;  // warp-uniform: this slice is past the end
    const uint32_t ks = smem_u32(ring + (tile % NSTAGE) * 2 * TILE);
    const uint32_t vs = ks + TILE * 2;

    // S = K q^T: lane (g, t) gets keys g, g + 8 x heads 2t, 2t + 1
    float sc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      uint32_t a[4];
      ldmatrix_x4(a, ks + ring_offset<DH>(k_row, 2 * kk + (mi >> 1)) * 2);
      mma_bf16(sc, a, qb[kk][0], qb[kk][1]);
    }

    // online softmax per head over the warp's 16 keys
    const bool ok0 = key0 + gq < end;
    const bool ok1 = key0 + gq + 8 < end;
    float p[4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float x0 = sc[h] * qk_scale;
      const float x1 = sc[2 + h] * qk_scale;
      float mt = fmaxf(ok0 ? x0 : NEG, ok1 ? x1 : NEG);
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 4));
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 8));
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 16));
      const float m_new = fmaxf(m[h], mt);
      const float corr = exp2f(m[h] - m_new);
      m[h] = m_new;
      p[h] = ok0 ? exp2f(x0 - m_new) : 0.0f;
      p[2 + h] = ok1 ? exp2f(x1 - m_new) : 0.0f;
      l[h] = fmaf(l[h], corr, p[h] + p[2 + h]);
#pragma unroll
      for (int i = 0; i < MTILES; ++i) {
        o[i][h] *= corr;
        o[i][2 + h] *= corr;
      }
    }

    // P as two tf32 B operands: keys 0-7 and keys 8-15 of the slice
    uint32_t pb[2][2];
    p_to_b(p[0], p[1], pb[0][0], pb[0][1]);
    p_to_b(p[2], p[3], pb[1][0], pb[1][1]);

    // O += V^T P: per 16 dh rows one ldmatrix.x4.trans gives both 8-key
    // groups; lane (g, t) holds V[key 2t, 2t+1][dh g (+8)] as bf16 pairs
#pragma unroll
    for (int i = 0; i < MTILES; ++i) {
      uint32_t x[4];
      ldmatrix_x4_trans(x, vs + ring_offset<DH>(v_row, 2 * i + (mi & 1)) * 2);
#pragma unroll
      for (int kg = 0; kg < 2; ++kg) {
        const uint32_t lo_d = x[2 * kg], hi_d = x[2 * kg + 1];
        mma_tf32(o[i], lo_d << 16, hi_d << 16, lo_d & 0xffff0000u,
                 hi_d & 0xffff0000u, pb[kg][0], pb[kg][1]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: merge the warps through it

  float* sm_m = reinterpret_cast<float*>(smem_raw);        // [WARPS][8]
  float* sm_l = sm_m + MMA_WARPS * GB_MMA;                  // [WARPS][8]
  float* sm_o = sm_l + MMA_WARPS * GB_MMA;                  // [WARPS][8][DH]
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float ls = l[h];
    ls += __shfl_xor_sync(0xffffffffu, ls, 4);
    ls += __shfl_xor_sync(0xffffffffu, ls, 8);
    ls += __shfl_xor_sync(0xffffffffu, ls, 16);
    const int hd = 2 * tq + h;
    if (gq == 0) {
      sm_m[warp * GB_MMA + hd] = m[h];
      sm_l[warp * GB_MMA + hd] = ls;
    }
    float* orow = sm_o + (warp * GB_MMA + hd) * DH;
#pragma unroll
    for (int i = 0; i < MTILES; ++i) {
      orow[16 * i + gq] = o[i][h];
      orow[16 * i + gq + 8] = o[i][2 + h];
    }
  }
  __syncthreads();
  for (int idx = tid; idx < gcount * DH; idx += MMA_THREADS) {
    const int hd = idx / DH;
    const int d = idx % DH;
    float mx = NEG;
#pragma unroll
    for (int w = 0; w < MMA_WARPS; ++w) mx = fmaxf(mx, sm_m[w * GB_MMA + hd]);
    float lsum = 0.0f, a = 0.0f;
#pragma unroll
    for (int w = 0; w < MMA_WARPS; ++w) {
      const float wt = exp2f(sm_m[w * GB_MMA + hd] - mx);
      lsum = fmaf(sm_l[w * GB_MMA + hd], wt, lsum);
      a = fmaf(sm_o[(w * GB_MMA + hd) * DH + d], wt, a);
    }
    const int64_t bh = (int64_t)b * heads + h0 + hd;
    if (n_split == 1) {
      out[bh * DH + d] = __float2bfloat16(a / fmaxf(lsum, 1e-30f));
    } else {
      const int64_t o_at = bh * n_split + split;
      ws_acc[o_at * DH + d] = a;
      if (d == 0) {
        ws_m[o_at] = mx == NEG ? NEG : mx * LN2;  // natural-log units
        ws_l[o_at] = lsum;
      }
    }
  }
}

// --------------------------------------------------------- combine ----

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
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

// ---------------------------------------------------------- launch ----

constexpr int F32 = 0;
constexpr int BF16 = 1;

// A block above 48 KB of dynamic shared memory needs the attribute.  Set
// once per process and instance (before the first occupancy query or
// launch), so no launch, and no CUDA-graph capture of one, calls it.
template <int DH>
cudaError_t mma_attr() {
  static const cudaError_t err = cudaFuncSetAttribute(
      decode_mma_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      mma_smem_bytes<DH>());
  return err;
}

template <typename T, int DH>
int launch(const void* q, const void* k, const void* v, const void* pos,
           void* out, void* ws, int b, int h, int kvh, int s_len,
           int n_split, cudaStream_t st) {
  const int g = h / kvh;
  constexpr bool mma = sizeof(T) == 2;
  constexpr int gb = mma ? GB_MMA : GB_F32;
  const int hgroups = (g + gb - 1) / gb;
  const int64_t bhn = (int64_t)b * h * n_split;
  float* ws_m = static_cast<float*>(ws);
  float* ws_l = ws_m + bhn;
  float* ws_acc = ws_l + bhn;
  const dim3 grid((unsigned)(b * kvh * hgroups), (unsigned)n_split);
  if constexpr (mma) {
    const cudaError_t attr = mma_attr<DH>();
    if (attr != cudaSuccess) return attr;
    decode_mma_kernel<DH><<<grid, MMA_THREADS, mma_smem_bytes<DH>(), st>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const int*>(pos),
        static_cast<T*>(out), ws_m, ws_l, ws_acc, s_len, kvh, g, hgroups,
        n_split);
  } else {
    decode_f32_kernel<DH><<<grid, THREADS, 0, st>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const int*>(pos),
        static_cast<T*>(out), ws_m, ws_l, ws_acc, s_len, kvh, g, hgroups,
        n_split);
  }
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
    case 256:
      return launch<T, 256>(q, k, v, pos, out, ws, b, h, kvh, s_len,
                            n_split, st);
    default:
      return cudaErrorInvalidValue;
  }
}

template <int DH>
int occupancy(int dtype) {
  int blocks = 0;
  cudaError_t err;
  if (dtype == BF16) {
    err = mma_attr<DH>();
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, decode_mma_kernel<DH>, MMA_THREADS, mma_smem_bytes<DH>());
  } else {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, decode_f32_kernel<DH>, THREADS, 0);
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
  if (dtype != F32 && dtype != BF16) return -1;
  switch (dh) {
    case 32:
      return occupancy<32>(dtype);
    case 64:
      return occupancy<64>(dtype);
    case 128:
      return occupancy<128>(dtype);
    case 256:
      return occupancy<256>(dtype);
    default:
      return -1;
  }
}

}  // extern "C"
