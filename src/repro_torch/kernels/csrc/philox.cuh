// Counter-based draws by global index: the device half of
// `kernels/philox.py`, shared by csrc/noisy_update.cu and
// csrc/philox_check.cu.
//
// The reference draws with `jax_threefry_partitionable` on, so each value
// is a function of (key, global index) whatever the layout, and a shard
// draws only its own elements.  The port does the same with Philox4x32-10
// (Random123's rounds, the bits of curand's `curand_Philox4x32_10`):
//
//   key     = the 64-bit stream seed as (lo32, hi32)
//   counter = (q lo32, q hi32, leaf index, purpose), q = j / 4, where j is
//             the element's row-major index in the leaf's whole shape
//   lane    = j % 4 picks one of the four outputs
//
// A uniform is u = ((x >> 9) + 0.5) * 2^-23: exact in f32 and inside
// (0, 1), formed from the exponent (`uniform`).  A normal is Box-Muller
// on the lane pairs (0, 1) and (2, 3): r = sqrt(-2 ln u_a), then
// (r cos 2 pi u_b, r sin 2 pi u_b).  The truncated
// normal of the init is torch.nn.init.trunc_normal_'s transform on
// [-2, 2]: u spread over [2 Phi(-2) - 1, 2 Phi(2) - 1], erfinv, times
// sqrt 2, clamped.  Every product and sum is written with an explicit
// rounding intrinsic, so nvcc contracts none of them into an FMA: the
// plain version's bits differ from these only through logf, cosf, sinf
// and erfinvf (a few f32 ulps).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace ctr {

constexpr uint32_t PHILOX_M0 = 0xD2511F53u;
constexpr uint32_t PHILOX_M1 = 0xCD9E8D57u;
constexpr uint32_t PHILOX_W0 = 0x9E3779B9u;
constexpr uint32_t PHILOX_W1 = 0xBB67AE85u;
constexpr float TWO_PI = 6.28318548202514648f;   // f32(2 pi)
constexpr float SQRT2 = 1.41421353816986084f;    // f32(sqrt 2)
constexpr float ONE_LESS_HALF_STEP = 0.999999940395355224609375f;  // 1 - 2^-24
constexpr uint32_t NOISE = 0;   // purpose word: the train step's noise
constexpr uint32_t INIT = 1;    // purpose word: the weights' init
constexpr int MAX_DIMS = 8;

// The ten round keys of Philox4x32-10: the key bumped (W0, W1) between
// rounds.  The same for every call under one key, so a kernel forms them
// once, outside its loops.
struct Keys {
  uint32_t x[10], y[10];
};

__device__ __forceinline__ Keys round_keys(uint2 k) {
  Keys r;
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    r.x[i] = k.x + static_cast<uint32_t>(i) * PHILOX_W0;
    r.y[i] = k.y + static_cast<uint32_t>(i) * PHILOX_W1;
  }
  return r;
}

// Philox4x32-10: ten rounds under the round keys.
__device__ __forceinline__ uint4 philox4x32_10(uint4 c, const Keys& k) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t hi0 = __umulhi(PHILOX_M0, c.x), lo0 = PHILOX_M0 * c.x;
    const uint32_t hi1 = __umulhi(PHILOX_M1, c.z), lo1 = PHILOX_M1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ k.x[r], lo1, hi0 ^ c.w ^ k.y[r], lo0);
  }
  return c;
}

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
  return philox4x32_10(c, round_keys(k));
}

__device__ __forceinline__ uint4 draw_bits(long long q, uint32_t leaf,
                                           uint32_t purpose,
                                           const Keys& keys) {
  const unsigned long long uq = static_cast<unsigned long long>(q);
  return philox4x32_10(make_uint4(static_cast<uint32_t>(uq),
                                  static_cast<uint32_t>(uq >> 32), leaf,
                                  purpose), keys);
}

// u = ((x >> 9) + 0.5) 2^-23 as (1 + m 2^-23) - (1 - 2^-24), m = x >> 9:
// the first is m under the exponent of 1, both are exact, and so is their
// difference (Sterbenz's lemma), so the bits are those of converting m,
// adding 0.5 and scaling, in one integer add and one f32 subtraction
// (tests/test_torch_draws.py pins the identity over all 2^23 m).
__device__ __forceinline__ float uniform(uint32_t x) {
  return __fsub_rn(__uint_as_float(0x3F800000u + (x >> 9)),
                   ONE_LESS_HALF_STEP);
}

// The four normals of one Philox output, lane by lane.
__device__ __forceinline__ void normals4(uint4 x, float z[4]) {
  const float r01 = sqrtf(__fmul_rn(-2.0f, logf(uniform(x.x))));
  const float t01 = __fmul_rn(TWO_PI, uniform(x.y));
  const float r23 = sqrtf(__fmul_rn(-2.0f, logf(uniform(x.z))));
  const float t23 = __fmul_rn(TWO_PI, uniform(x.w));
  z[0] = __fmul_rn(r01, cosf(t01));
  z[1] = __fmul_rn(r01, sinf(t01));
  z[2] = __fmul_rn(r23, cosf(t23));
  z[3] = __fmul_rn(r23, sinf(t23));
}

// The truncated normal on [-2, 2] of one uniform's bits: u spread over
// [lo, lo + width] (lo = 2 Phi(-2) - 1, width = 2 Phi(2) - 1 - lo, the
// wrapper's f32 constants), erfinv, times sqrt 2, clamped.
__device__ __forceinline__ float trunc_normal(uint32_t x, float lo,
                                              float width) {
  const float v = __fadd_rn(__fmul_rn(uniform(x), width), lo);
  const float t = __fmul_rn(erfinvf(v), SQRT2);
  return fminf(fmaxf(t, -2.0f), 2.0f);
}

// A part of a leaf: a box of `len` elements a dim starting at `off`, in a
// whole shape of row-major `stride`s, with whole inner dims already merged
// (`kernels/philox.py::collapse`).  Its elements are stored contiguously in
// the part's own row-major order: rows of len[nd - 1] elements.
struct Part {
  int nd;
  long long stride[MAX_DIMS];
  long long off[MAX_DIMS];
  long long len[MAX_DIMS];
};

// The global index of the first element of the part's row r (r < the
// part's rows, so the outermost dim takes r whole: a part of two merged
// dims divides nothing).
__host__ __device__ __forceinline__ long long row_start(const Part& part,
                                                        long long r) {
  long long j = part.off[part.nd - 1];
#pragma unroll
  for (int k = MAX_DIMS - 2; k >= 0; --k) {
    if (k < part.nd - 1) {
      const long long i = k == 0 ? r : r % part.len[k];
      if (k) r /= part.len[k];
      j += (part.off[k] + i) * part.stride[k];
    }
  }
  return j;
}

}  // namespace ctr
