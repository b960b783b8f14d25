// Per-row gradient statistics (eq. 3 handshake) for sm_90a.
//
// Replaces the Pallas kernel src/repro/kernels/grad_stats.py::grad_stats
// (_kernel): out[r] = (sum_d g[r,d], sum_d g[r,d]^2) in f32, rows [R, D] ->
// [R, 2].
//
// The Pallas kernel walks D as a sequential grid and carries the [U, 2] sum
// in one revisited output block (grad_stats.py:25-33).  Hopper's blocks run
// in parallel and in no order, so nothing carries from one block to the
// next.  What bounds the pass is bytes: R*D elements read once (one add and
// one FMA each, far below the card's ridge).  To reach that bound the card
// needs enough loads in flight, and the sweep's row counts are small (10 to
// 40 rows of D = 50 890 on the paper's grids, 1000 on the U = 1000 grid), so
// one block a row left most of the 132 SMs idle.
//
// Design: a row is split over the C blocks of one thread-block cluster
// (C = 1, 2, 4, 8 or 16; `kernels/grad_stats.py::cluster_size` picks C from
// R, D and the SM count, C = 1 at R = 1000).  Block `rank` of a row's
// cluster reduces its share of the row's 16-byte vectors with UNROLL
// independent 16-byte loads in flight per thread, keeps (s1, s2) in f32
// registers, and folds them by fixed warp-shuffle trees (the lanes, then
// the block's 8 warp sums in warp 0).  It then writes its pair into the
// rank-0 block's shared memory through distributed shared memory; after
// `cluster.sync()` rank 0 adds the C pairs by a fixed tree in rank order.
// No atomics, no scratch, no second launch: the sum's order depends only on
// (R, D, C, the row's alignment), so results are bit-equal across calls
// and CUDA-graph replays.  A cluster is not free: each doubling of C adds
// set-up and a longer sync, so the plan splits only as far as about 1.5
// blocks an SM.
//
// Alignment rule.  A row starts wherever the caller's view puts it (D may be
// odd, and a contiguous view may carry a storage offset), so each row peels
// its own head: the elements before its first 16-byte boundary (fewer than V
// = 16 / sizeof(T)), and its tail after the last whole vector.  Rank 0's
// first threads add the head and the tail; every 16-byte load is aligned.
// `kernels/grad_stats.py::row_chunks` mirrors this split on the host.
//
// The fixed-order route (`segment_parts_kernel` and `segment_fold_kernel`,
// the sweep's strict_numerics stats over the leaf segments of a slab).  The
// cluster kernel's order depends on R (through C) and on where each row
// starts (the peel), so the same row summed inside two different slabs
// (the grouped and the switch dispatch, the tree and the flat state) may
// round differently.  This route's order depends on the leaf sizes alone.
// Each segment is cut into parts of PART_ELEMS elements at fixed offsets
// from the segment's start; one block a (row, part) sums element j of its
// part into thread j % SEG_THREADS in increasing j, then by the fixed
// trees, and writes a pair to scratch; a second launch, one block a row,
// folds each segment's pairs in part order and the segments in leaf order,
// both from 0.  What bounds it is bytes, as above; one block a row would
// leave most SMs idle at the sweep's 10-60 rows, while a block a part puts
// R * n_parts blocks in flight (5 840 at the LM lane's 16 rows).
// Rows start at any element (a leaf offset is arbitrary, D is odd), so each
// thread loads its elements one at a time, all of them in flight before the
// first add: the order is fixed by the element index, never by the address.
// One call, every leaf, two launches, no atomics.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_CLUSTER = 16;  // non-portable on sm_90, opted in below
constexpr int UNROLL = 4;  // 16-byte loads in flight a thread (grad_stats.py)

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ void add(float x, float& s1, float& s2) {
  s1 += x;
  s2 = fmaf(x, x, s2);
}

// The 16 bytes of q as f32 (4 floats, or 8 bf16 widened exactly).
__device__ __forceinline__ void add16(uint4 q, const float*, float& s1,
                                      float& s2) {
  add(__uint_as_float(q.x), s1, s2);
  add(__uint_as_float(q.y), s1, s2);
  add(__uint_as_float(q.z), s1, s2);
  add(__uint_as_float(q.w), s1, s2);
}
__device__ __forceinline__ void add16(uint4 q, const __nv_bfloat16*,
                                      float& s1, float& s2) {
  const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    add(__uint_as_float(w[i] << 16), s1, s2);
    add(__uint_as_float(w[i] & 0xffff0000u), s1, s2);
  }
}

// Lane 0 gets the sum of lanes [0, n) of the warp (n a power of two, the
// other lanes zero), by a fixed shuffle tree.
__device__ __forceinline__ void tree(float& s1, float& s2, int n) {
  for (int off = n / 2; off > 0; off >>= 1) {
    s1 += __shfl_down_sync(0xffffffffu, s1, off);
    s2 += __shfl_down_sync(0xffffffffu, s2, off);
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
grad_stats_kernel(const T* __restrict__ grads,  // [R, D]
                  float* __restrict__ out,      // [R, 2]
                  int64_t d_n) {
  constexpr int V = 16 / sizeof(T);
  __shared__ float warp_part[2][WARPS];
  __shared__ float rank_part[2][MAX_CLUSTER];  // rank 0's: one pair a block
  cg::cluster_group cluster = cg::this_cluster();
  const int c_n = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int64_t row = blockIdx.x / c_n;
  const T* g = grads + row * d_n;

  // this row's head, whole vectors and tail (row_chunks on the host)
  const int mis = (int)((reinterpret_cast<uintptr_t>(g) & 15) / sizeof(T));
  const int64_t head = mis == 0 ? 0 : (V - mis < d_n ? V - mis : d_n);
  const int64_t n_vec = (d_n - head) / V;
  const int64_t tail0 = head + n_vec * V;
  const int64_t per = (n_vec + c_n - 1) / c_n;
  const int64_t v0 = rank * per < n_vec ? rank * per : n_vec;
  const int64_t v1 = v0 + per < n_vec ? v0 + per : n_vec;
  const uint4* gv = reinterpret_cast<const uint4*>(g + head);

  float s1 = 0.0f, s2 = 0.0f;
  for (int64_t i = v0 + threadIdx.x; i < v1; i += THREADS * UNROLL) {
    uint4 q[UNROLL];
#pragma unroll
    for (int k = 0; k < UNROLL; ++k) {
      const int64_t j = i + (int64_t)k * THREADS;
      q[k] = j < v1 ? __ldg(gv + j) : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int k = 0; k < UNROLL; ++k) add16(q[k], g, s1, s2);
  }
  if (rank == 0) {
    const int t = threadIdx.x;
    if (t < head) add(to_f32(g[t]), s1, s2);
    if (t >= V && tail0 + (t - V) < d_n) {
      add(to_f32(g[tail0 + t - V]), s1, s2);
    }
  }

  // warps, then the block's warps, then the cluster's blocks: fixed trees
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  tree(s1, s2, 32);
  if (lane == 0) {
    warp_part[0][warp] = s1;
    warp_part[1][warp] = s2;
  }
  __syncthreads();
  if (warp == 0) {
    s1 = lane < WARPS ? warp_part[0][lane] : 0.0f;
    s2 = lane < WARPS ? warp_part[1][lane] : 0.0f;
    tree(s1, s2, WARPS);
    if (c_n > 1 && lane == 0) {
      float* dst = cluster.map_shared_rank(&rank_part[0][0], 0);
      dst[rank] = s1;
      dst[MAX_CLUSTER + rank] = s2;
    }
  }
  if (c_n > 1) {  // uniform over the cluster
    cluster.sync();  // the pairs are in rank 0's shared memory
    if (rank != 0 || warp != 0) return;
    s1 = lane < c_n ? rank_part[0][lane] : 0.0f;
    s2 = lane < c_n ? rank_part[1][lane] : 0.0f;
    tree(s1, s2, MAX_CLUSTER);
  } else if (warp != 0) {
    return;
  }
  if (lane == 0) {
    out[2 * row] = s1;
    out[2 * row + 1] = s2;
  }
}

// ---- the strict route: leaf-segment statistics in a fixed order ----
//
// One call covers every leaf segment of [R, D] rows: `segment_parts_kernel`
// sums each (row, part) of the work list into a partial pair, then
// `segment_fold_kernel` folds a row's pairs.  The work list depends on the
// leaf sizes alone (`kernels/grad_stats.py::work_list` builds it): segment s
// of n_s elements is cut into ceil(n_s / PART_ELEMS) parts of PART_ELEMS
// elements (the last shorter), each part at a fixed element range of its
// segment.  The table is [item start (n_items), item length (n_items),
// segment's first item (n_seg + 1)], int64, starts counted from the row's
// first element.
constexpr int SEG_THREADS = 256;
constexpr int SEG_WARPS = SEG_THREADS / 32;
constexpr int PART_ELEMS = 8192;                      // grad_stats.py
constexpr int PART_SLOTS = PART_ELEMS / SEG_THREADS;  // elements a thread
constexpr int FOLD_THREADS = 128;
constexpr int MAX_FOLD_PAIRS = 16384;  // items + segments of one call

// One block a (row, part).  Element j of the part (j < m <= PART_ELEMS)
// goes to thread j % SEG_THREADS, slot j / SEG_THREADS, added in increasing
// slot; then the lanes' and the warps' fixed shuffle trees.  So the pair
// depends on the part's elements alone, never on R, the row stride or the
// address.  Each thread loads its PART_SLOTS elements straight from memory,
// all in flight before the first add.
template <typename T>
__global__ void __launch_bounds__(SEG_THREADS)
segment_parts_kernel(const T* __restrict__ rows,     // [R, stride]
                     float* __restrict__ parts,      // [R, n_items, 2]
                     const int64_t* __restrict__ table,
                     int64_t n_items, int64_t stride) {
  __shared__ float warp_part[2][SEG_WARPS];
  const int64_t row = blockIdx.x / n_items;
  const int64_t item = blockIdx.x - row * n_items;
  const int m = (int)table[n_items + item];
  const T* g = rows + row * stride + table[item];
  const int t = threadIdx.x;
  float s1 = 0.0f, s2 = 0.0f;
  float x[PART_SLOTS];
#pragma unroll
  for (int k = 0; k < PART_SLOTS; ++k) {
    const int j = t + k * SEG_THREADS;
    x[k] = j < m ? to_f32(g[j]) : 0.0f;
  }
#pragma unroll
  for (int k = 0; k < PART_SLOTS; ++k)
    if (t + k * SEG_THREADS < m) add(x[k], s1, s2);

  const int warp = t / 32, lane = t % 32;
  tree(s1, s2, 32);
  if (lane == 0) {
    warp_part[0][warp] = s1;
    warp_part[1][warp] = s2;
  }
  __syncthreads();
  if (warp != 0) return;
  s1 = lane < SEG_WARPS ? warp_part[0][lane] : 0.0f;
  s2 = lane < SEG_WARPS ? warp_part[1][lane] : 0.0f;
  tree(s1, s2, SEG_WARPS);
  if (lane == 0) {
    float* p = parts + 2 * blockIdx.x;   // = 2 * (row * n_items + item)
    p[0] = s1;
    p[1] = s2;
  }
}

// One block a row: the row's (n_items) pairs staged in shared memory, then
// thread s folds segment s's parts in part order from 0 (threads take
// segments s, s + FOLD_THREADS, ...), and thread 0 folds the segment sums
// in leaf order from 0: out[row] = sum_s (sum_p part[s, p]), each sum a
// left fold.  No atomics, nothing carried between calls.
__global__ void __launch_bounds__(FOLD_THREADS)
segment_fold_kernel(const float* __restrict__ parts,  // [R, n_items, 2]
                    float* __restrict__ out,          // [R, 2]
                    const int64_t* __restrict__ table, int64_t n_items,
                    int64_t n_seg) {
  extern __shared__ float pairs[];   // [n_items + n_seg][2]
  const float* src = parts + (int64_t)blockIdx.x * n_items * 2;
  for (int64_t i = threadIdx.x; i < 2 * n_items; i += FOLD_THREADS)
    pairs[i] = src[i];
  __syncthreads();
  const int64_t* first = table + 2 * n_items;
  float* seg = pairs + 2 * n_items;
  for (int64_t s = threadIdx.x; s < n_seg; s += FOLD_THREADS) {
    float a = 0.0f, b = 0.0f;
    for (int64_t p = first[s]; p < first[s + 1]; ++p) {
      a += pairs[2 * p];
      b += pairs[2 * p + 1];
    }
    seg[2 * s] = a;
    seg[2 * s + 1] = b;
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  float a = 0.0f, b = 0.0f;
  for (int64_t s = 0; s < n_seg; ++s) {
    a += seg[2 * s];
    b += seg[2 * s + 1];
  }
  out[2 * blockIdx.x] = a;
  out[2 * blockIdx.x + 1] = b;
}

template <typename T>
cudaError_t launch_segments(const void* rows, void* out, void* parts,
                            int64_t r_n, int64_t stride, const void* table,
                            int64_t n_items, int64_t n_seg, cudaStream_t st) {
  static bool fold_smem = false;
  const size_t smem = (size_t)(n_items + n_seg) * 2 * sizeof(float);
  if (!fold_smem) {
    cudaError_t err = cudaFuncSetAttribute(
        segment_fold_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        MAX_FOLD_PAIRS * 2 * (int)sizeof(float));
    if (err != cudaSuccess) return err;
    fold_smem = true;
  }
  const int64_t* tab = static_cast<const int64_t*>(table);
  segment_parts_kernel<T><<<(unsigned)(r_n * n_items), SEG_THREADS, 0,
                            st>>>(
      static_cast<const T*>(rows), static_cast<float*>(parts), tab, n_items,
      stride);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  segment_fold_kernel<<<(unsigned)r_n, FOLD_THREADS, smem, st>>>(
      static_cast<const float*>(parts), static_cast<float*>(out), tab,
      n_items, n_seg);
  return cudaGetLastError();
}

constexpr int F32 = 0;
constexpr int BF16 = 1;

cudaLaunchConfig_t config(int64_t blocks, int c, cudaStream_t st,
                          cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = st;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = (unsigned)c;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <typename T>
cudaError_t allow_cluster(int c) {
  if (c <= 8) return cudaSuccess;
  return cudaFuncSetAttribute(grad_stats_kernel<T>,
                              cudaFuncAttributeNonPortableClusterSizeAllowed,
                              1);
}

template <typename T>
cudaError_t launch(const void* grads, void* out, int64_t r_n, int64_t d_n,
                   int c, cudaStream_t st) {
  cudaError_t err = allow_cluster<T>(c);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = config(r_n * c, c, st, &attr);
  err = cudaLaunchKernelEx(&cfg, grad_stats_kernel<T>,
                           static_cast<const T*>(grads),
                           static_cast<float*>(out), d_n);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// Largest C in {16, 8, 4, 2} of which at least one cluster fits the card
// (cudaOccupancyMaxActiveClusters), else 1.
template <typename T>
int max_cluster() {
  for (int c = MAX_CLUSTER; c > 1; c /= 2) {
    if (allow_cluster<T>(c) != cudaSuccess) {
      cudaGetLastError();
      continue;
    }
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = config(c, c, nullptr, &attr);
    int n = 0;
    if (cudaOccupancyMaxActiveClusters(&n, grad_stats_kernel<T>, &cfg) ==
            cudaSuccess && n > 0)
      return c;
    cudaGetLastError();  // a refused query leaves no error for the launch
  }
  return 1;
}

bool valid_cluster(int c) {
  return c == 1 || c == 2 || c == 4 || c == 8 || c == MAX_CLUSTER;
}

}  // namespace

extern "C" {

// grads [R, D] (dtype code 0 = f32, 1 = bf16) -> out [R, 2] f32, each row
// split over a cluster of `cluster` blocks (1, 2, 4, 8 or 16).  Returns the
// launch's error code (cudaErrorInvalidValue for a bad dtype or cluster
// size; a cluster the card cannot schedule fails the launch).
int grad_stats(const void* grads, void* out, int64_t r_n, int64_t d_n,
               int dtype, int cluster, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!valid_cluster(cluster) || r_n < 1 || d_n < 1 ||
      r_n * cluster > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  if (dtype == F32) return launch<float>(grads, out, r_n, d_n, cluster, st);
  if (dtype == BF16)
    return launch<__nv_bfloat16>(grads, out, r_n, d_n, cluster, st);
  return cudaErrorInvalidValue;
}

// rows: R rows, row r at rows + r * stride elements, each the leaf
// segments of the work list `table` (see segment_parts_kernel; n_items
// parts of n_seg segments) -> out [R, 2] f32, each segment's (sum, sum of
// squares) folded in leaf order; `parts` is [R, n_items, 2] f32 scratch.
// Two launches on `stream`.  Returns the first error code.
int grad_stats_segments(const void* rows, void* out, void* parts, int64_t r_n,
                        int64_t stride, const void* table, int64_t n_items,
                        int64_t n_seg, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (r_n < 1 || n_items < 1 || n_seg < 1 || stride < 1 ||
      r_n * n_items > 0x7fffffffLL || n_items + n_seg > MAX_FOLD_PAIRS)
    return cudaErrorInvalidValue;
  if (dtype == F32)
    return launch_segments<float>(rows, out, parts, r_n, stride, table,
                                  n_items, n_seg, st);
  if (dtype == BF16)
    return launch_segments<__nv_bfloat16>(rows, out, parts, r_n, stride,
                                          table, n_items, n_seg, st);
  return cudaErrorInvalidValue;
}

// The largest cluster size the kernel can run at on the current card, or a
// negative value for a bad dtype code.
int grad_stats_max_cluster(int dtype) {
  if (dtype == F32) return max_cluster<float>();
  if (dtype == BF16) return max_cluster<__nv_bfloat16>();
  return -1;
}

}  // extern "C"
