// A yardstick for csrc/philox.cuh, never on the main path: the raw
// Philox4x32-10 outputs of given (counter, key) pairs, from the port's
// device function or from the CUDA toolkit's `curand_Philox4x32_10`
// (curand_kernel.h, device-side, header only), so that `chip_smoke.py`
// holds the two bitwise and against Random123's known answers.
#include <cuda_runtime.h>
#include <curand_kernel.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

__global__ void philox_raw_kernel(const uint32_t* __restrict__ ctr4,
                                  const uint32_t* __restrict__ key2,
                                  uint32_t* __restrict__ out4, long long n,
                                  int use_curand) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < n; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const uint4 c = make_uint4(ctr4[4 * i], ctr4[4 * i + 1], ctr4[4 * i + 2],
                               ctr4[4 * i + 3]);
    const uint2 k = make_uint2(key2[2 * i], key2[2 * i + 1]);
    const uint4 x = use_curand ? curand_Philox4x32_10(c, k)
                               : ctr::philox4x32_10(c, k);
    out4[4 * i] = x.x;
    out4[4 * i + 1] = x.y;
    out4[4 * i + 2] = x.z;
    out4[4 * i + 3] = x.w;
  }
}

}  // namespace

extern "C" {

// ctr [n, 4] and key [n, 2] uint32 -> out [n, 4] uint32: the port's
// Philox (use_curand 0) or curand's (1).  Returns the launch's error code.
int philox_raw(const void* ctr, const void* key, void* out, int64_t n,
               int use_curand, void* stream) {
  if (n < 1) return cudaErrorInvalidValue;
  long long blocks = (n + 255) / 256;
  if (blocks > 4096) blocks = 4096;
  philox_raw_kernel<<<static_cast<unsigned>(blocks), 256, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(ctr), static_cast<const uint32_t*>(key),
      static_cast<uint32_t*>(out), n, use_curand);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
