// Event-driven delivery: scatter the outgoing synapses of fired-source id
// packets straight into the ring,
//     ring[off(r) + tgt[row, k], (t0 + step(r) + d[row, k]) % R] += w[row, k]
// for every packet entry (r, i) whose id is a real source (row = its table
// row) and every k whose target is real. Packets are [rows, S] int32: one row
// per cycle of a window (inter pathway: global ids, off = 0, step = r) or one
// row per area (intra pathway: ids within the area, row = r * area_rows + id,
// off = r * area_rows, step = 0).
//
// Replaces the JAX package's event scatter `event_deliver_block`
// (src/repro/kernels/ops.py), plain jnp with no Pallas kernel. That version
// has static shapes: it gathers and scatters every entry of the s_max-sized
// packets (at the paper's per-area size ~88% of them padding) and
// neutralizes padding ids and -1 table entries by adding +0.0 into ring row
// 0. As atomics those adds would queue on a handful of addresses. This kernel
// skips them instead: rings never hold -0.0, so a skipped +0.0 add is
// bitwise the same.
//
// Bound on an H100: memory. Only the fired sources' rows are read (tgt i32,
// w f32, d int8 or int32 as stored: 9 B per synapse with int8 delays), and
// every delivered synapse is one f32 reduction into a random ring address,
// one 32-byte sector read and written by the L2. The design: groups of 1-8
// warps walk the packet entries with a grid stride, a group an entry at a
// time; a padding entry costs its group one broadcast load of its id; a
// fired source's group streams its contiguous K_out row, threads on
// neighbouring columns (the streaming hint `__ldcs`), and issues
// `atomicAdd`s whose result is unused, which compile to fire-and-forget
// reductions (RED). The group size follows the packet's size: one warp per
// entry left one cycle's intra packets (1,104 entries, ~130 of them fired
// sources, at the paper's size) latency-bound, 2.9x slower than 8 warps per
// entry, while the window's inter packets (11,040 entries) ran 1.3x faster
// with one warp per entry than with eight (PERF_ARCHIVE.md).
//
// Order of the adds: atomics add in no fixed order. The sum is exact all the
// same, because weights lie on the 1/256 grid and every partial sum stays
// far below 2^15 in magnitude, so each f32 add is exact.

#include <cuda_runtime.h>
#include <stdint.h>

constexpr int kThreads = 256;  // threads per block

// A group of `group` threads (1, 2, 4 or 8 warps) serves one packet entry at
// a time; the block's groups walk the entries with a grid stride.
template <typename DelayT>
__global__ void __launch_bounds__(kThreads) event_deliver_kernel(
    const int32_t* __restrict__ ids, const int32_t* __restrict__ tgt,
    const float* __restrict__ w, const DelayT* __restrict__ d,
    float* __restrict__ ring, int64_t n_entries, int s_max, int k, int ring_len,
    int t0_mod, int64_t n_src, int64_t n_tgt, int64_t area_rows, int group) {
  const int groups = kThreads / group;
  const int lane = threadIdx.x % group;
  for (int64_t e = (int64_t)blockIdx.x * groups + threadIdx.x / group; e < n_entries;
       e += (int64_t)gridDim.x * groups) {
    const int32_t id = __ldg(ids + e);
    if (id < 0 || id >= n_src) continue;  // packet padding
    const int64_t r = e / s_max;
    int64_t src_row = id, tgt_off = 0;
    int step = (int)r;
    if (area_rows > 0) {
      src_row = r * area_rows + id;
      tgt_off = r * area_rows;
      step = 0;
    }
    const int64_t base = src_row * (int64_t)k;
    const int t = t0_mod + step;
    for (int c = lane; c < k; c += group) {
      const int32_t target = __ldcs(tgt + base + c);
      if (target < 0 || target >= n_tgt) continue;  // table padding
      const int slot = (t + (int)d[base + c]) % ring_len;
      atomicAdd(ring + (tgt_off + target) * (int64_t)ring_len + slot, __ldcs(w + base + c));
    }
  }
}

// Warps per entry: as many (up to 8) as fit the entries' groups into two
// waves of resident warps. Most entries are padding, whose groups finish at
// once.
template <typename DelayT>
static int launch(const void* ids, const void* tgt, const void* w, const void* d,
                  void* ring, int64_t rows, int s_max, int k, int ring_len,
                  int t0_mod, int64_t n_src, int64_t n_tgt, int64_t area_rows,
                  void* stream) {
  const int64_t n_entries = rows * (int64_t)s_max;
  if (n_entries <= 0 || k <= 0 || ring_len <= 0) return 0;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, event_deliver_kernel<DelayT>, kThreads, 0);
  if (err != cudaSuccess) return (int)err;
  const int64_t resident_warps = (int64_t)sms * per_sm * (kThreads / 32);
  int wpe = 8;
  while (wpe > 1 && n_entries * wpe > 2 * resident_warps) wpe /= 2;
  const int64_t groups = kThreads / (32 * wpe);
  // At most one wave of blocks; each group walks the entries with a stride.
  int64_t blocks = (int64_t)sms * per_sm;
  if (blocks > (n_entries + groups - 1) / groups) blocks = (n_entries + groups - 1) / groups;
  event_deliver_kernel<DelayT><<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)ids, (const int32_t*)tgt, (const float*)w, (const DelayT*)d,
      (float*)ring, n_entries, s_max, k, ring_len, t0_mod, n_src, n_tgt, area_rows,
      32 * wpe);
  return (int)cudaGetLastError();
}

extern "C" int event_deliver_i8_launch(
    const void* ids, const void* tgt, const void* w, const void* d, void* ring,
    int64_t rows, int s_max, int k, int ring_len, int t0_mod, int64_t n_src,
    int64_t n_tgt, int64_t area_rows, void* stream) {
  return launch<int8_t>(ids, tgt, w, d, ring, rows, s_max, k, ring_len, t0_mod,
                        n_src, n_tgt, area_rows, stream);
}

extern "C" int event_deliver_i32_launch(
    const void* ids, const void* tgt, const void* w, const void* d, void* ring,
    int64_t rows, int s_max, int k, int ring_len, int t0_mod, int64_t n_src,
    int64_t n_tgt, int64_t area_rows, void* stream) {
  return launch<int32_t>(ids, tgt, w, d, ring, rows, s_max, k, ring_len, t0_mod,
                         n_src, n_tgt, area_rows, stream);
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
