// Warp-per-row passes over a synapse table, shared by spike_deliver and the
// fused superstep kernels.
//
// One warp walks one target row of an [N, K] int32 source table, lanes
// streaming `src` with the streaming hint `__ldcs` (16-byte loads, two in
// flight per lane, when K % 4 == 0 and the row is 16-byte aligned). A
// visitor decides per synapse what to add into the warp's shared
// accumulator; the warp then adds the accumulator into the row's `fut`
// columns once, and only if any synapse of the row added something. The
// plain versions add a +0.0 contribution to every row instead; the two
// differ only on a -0.0 in `fut`, which the engines never hold (rings start
// at +0.0, and exact sums that cancel give +0.0).
//
// Order of the adds: shared-memory atomics add in no fixed order. The sum is
// exact all the same, because weights lie on the 1/256 grid and every partial
// sum stays below 2^15 in magnitude, so each f32 add is exact.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

constexpr int kWarps = 32;               // warps per block
constexpr int kThreads = 32 * kWarps;
constexpr size_t kMaxSmem = 232448;      // per-block limit on sm_90
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ bool bit_set(const uint32_t* mask, int64_t b) {
  return (mask[b >> 5] >> (b & 31)) & 1u;
}

// visit(src_value, column) for every synapse of one row; lanes split the row.
template <bool kVec, typename Visit>
__device__ __forceinline__ void stream_row(const int32_t* __restrict__ src,
                                           int k, int lane, Visit& visit) {
  if (kVec) {
    const int4* s4 = reinterpret_cast<const int4*>(src);
    const int k4 = k >> 2;
    for (int c = lane; c < k4; c += 64) {
      const bool two = c + 32 < k4;
      const int4 a = __ldcs(s4 + c);
      int4 b = a;
      if (two) b = __ldcs(s4 + c + 32);
      visit(a.x, 4 * c); visit(a.y, 4 * c + 1);
      visit(a.z, 4 * c + 2); visit(a.w, 4 * c + 3);
      if (two) {
        const int cb = 4 * (c + 32);
        visit(b.x, cb); visit(b.y, cb + 1);
        visit(b.z, cb + 2); visit(b.w, cb + 3);
      }
    }
  } else {
#pragma unroll 4
    for (int c = lane; c < k; c += 32) visit(__ldcs(src + c), c);
  }
}

// Accumulate one row's deposits in acc[width] (this warp's shared slice) and
// add them into out[0, width). `visit(s, c, acc)` returns whether it added.
template <bool kVec, typename Visit>
__device__ __forceinline__ void deposit_row(const int32_t* __restrict__ src_row,
                                            int k, int lane, float* acc,
                                            int width, float* out,
                                            const Visit& visit) {
  for (int x = lane; x < width; x += 32) acc[x] = 0.0f;
  __syncwarp();
  bool hit = false;
  auto each = [&](int s, int c) { hit |= visit(s, c, acc); };
  stream_row<kVec>(src_row, k, lane, each);
  __syncwarp();
  if (__any_sync(kFull, hit))
    for (int x = lane; x < width; x += 32) out[x] = __fadd_rn(out[x], acc[x]);
}

// Dynamic shared memory of a row kernel: the bitmask (when it fits)
// followed by kWarps accumulators of `width` floats.
struct SmemPlan {
  size_t bytes;
  bool mask_in_smem;
};

__host__ inline SmemPlan plan_smem(int64_t mask_words, int width) {
  const size_t acc_bytes = sizeof(float) * kWarps * (size_t)width;
  const size_t mask_bytes = 16 * (size_t)((mask_words + 3) / 4);
  const bool in_smem = mask_bytes + acc_bytes <= kMaxSmem;
  return {acc_bytes + (in_smem ? mask_bytes : 0), in_smem};
}

// Copy mask_words of a bitmask (16-byte aligned, whole 16-byte units) into
// shared memory through L2 (`__ldcg`: the mask may have been written during
// this launch, so L1 could be stale); returns where the accumulators start.
__device__ __forceinline__ float* stage_mask(uint4* smem, const uint32_t* mask_g,
                                             int64_t mask_words, bool in_smem,
                                             const uint32_t** mask) {
  if (!in_smem) {
    *mask = mask_g;
    return reinterpret_cast<float*>(smem);
  }
  const int64_t n4 = (mask_words + 3) / 4;
  const uint4* g4 = reinterpret_cast<const uint4*>(mask_g);
  for (int64_t i = threadIdx.x; i < n4; i += blockDim.x) smem[i] = __ldcg(g4 + i);
  __syncthreads();
  *mask = reinterpret_cast<const uint32_t*>(smem);
  return reinterpret_cast<float*>(smem + n4);
}

// Give `kernel` `smem` bytes of dynamic shared memory and return in *blocks
// how many of its kThreads-thread blocks the device holds at once
// (occupancy x SMs): the grid of a persistent kernel.
template <typename Kernel>
static cudaError_t co_resident_blocks(Kernel kernel, size_t smem, int64_t* blocks) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem)) !=
      cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *blocks = (int64_t)sms * per_sm;
  return cudaSuccess;
}
