// One fused D-cycle ignore-and-fire window over [A, n] neurons (N = A * n):
// for s in [0, D):
//     spike     = countdown == 0 && alive
//     countdown = spike ? interval - 1 : countdown - 1
//     fut[r, s + delay] += w           for every intra synapse of row r
//                                      whose source spiked in cycle s
// with delays outside [steps_lo, steps_lo + r_span) ignored.
//
// Replaces the Pallas TPU kernel `superstep_iaf_pallas`
// (src/repro/kernels/cycle.py), which makes D masked passes over an area's
// intra tables. Ignore-and-fire emits independently of its input, so the
// whole window's spikes are known before any deposit, and one pass over
// `src` serves all D cycles:
//   (a) `iaf_spikes` runs the D cycles of every neuron (one thread each) and
//       writes the [D, N] spikes, the final countdown, a per-source D-bit
//       pattern (bit s: spiked in cycle s) and a bitmask of the sources that
//       spiked at all in the window (1 bit per neuron: 65 KB for 520,000);
//   (b) `iaf_deposit` streams `src` once per window, one warp per target
//       row, and adds `w` at column s + delay for every set bit s of the
//       pattern of each synapse whose source spiked.
//
// Bound on an H100: memory. `src` (4 B/synapse) is read in full, 6.24 GB at
// the paper's per-area size, 1.86 ms at 3.35 TB/s; `w`, `delay` and the
// pattern are needed only where the source spiked.
//
// Superseded design: each lane visited its synapses in order and, on a
// hit, walked a chain of dependent loads (`delay`, a branch on the window,
// `w`, the pattern) before its next synapse. At ~5% of sources firing some
// lane of a warp hits at most visit slots, so the warps ran round trips to
// memory one after another: 6.2-6.5 ms on the H100, 33% of the bound,
// moving its bytes at ~1.1 TB/s. Its "one pass over the tables" held for
// `src` only.
//
// This design takes the hit path out of the stream:
//   * the stream: lane 0 of each warp keeps its rows' `src` in flight in
//     2-KB chunks with 1-D bulk copies (cp.async.bulk, completion on one
//     mbarrier per stage) into a 2-stage ring in shared memory: 2 KB ahead
//     per warp, 64 KB per SM. Fewer, larger copies streamed faster than
//     more, smaller ones (1 KB x 4 stages, 512 B x 8). Bulk copies need
//     16-byte sizes and addresses; rows with K % 4 != 0 or an unaligned
//     `src` take ordinary streaming loads (`__ldcs`) in the same kernel
//     (kBulk = false), with the same hit path;
//   * the filter: each lane tests eight synapses against the `any` bitmask
//     in shared memory (no global load; eight independent loads), then the
//     warp votes once; only if some lane hit does it compact the hits with
//     `__ballot_sync` / `__popc` into a 64-entry queue in shared memory
//     (column, source);
//   * the hit path: when the queue holds 32 hits, or the row ends, each lane
//     takes one hit and loads its `delay`, `w` and pattern together, with no
//     branch between them (a delay outside the window clears the pattern),
//     then adds into the warp's accumulator with shared-memory atomics. One
//     round trip to memory serves 32 hits.
// Shared memory per block (32 warps, one block per SM): 4,624 B per warp
// (ring, barriers, queue) + the accumulators (width floats per warp) + the
// bitmask when it fits (up to ~635,000 neurons at width 39), else the
// bitmask is read through L2, which is much slower.
//
// What bounds it now: the per-warp work of the filter, not the hit path's
// latency (issuing the hit loads one drain ahead gained nothing) and not
// bytes in flight (16 or 8 warps with larger rings were slower); and at
// ~5% firing the sparse `w` and `delay` reads, which move whole DRAM
// bursts (all measured on the H100).
//
// A row's `fut` columns are written only if some synapse of the row had a
// firing source and a delay inside the window (the +0.0 rule of
// deposit.cuh). Sums are exact in any order (weights on the 1/256 grid).

#include "deposit.cuh"
#include "mbarrier.cuh"

__global__ void iaf_spikes(const int32_t* __restrict__ countdown,
                           const int32_t* __restrict__ interval,
                           const uint8_t* __restrict__ alive,
                           int32_t* __restrict__ countdown_out,
                           uint8_t* __restrict__ spikes,
                           uint32_t* __restrict__ pattern,
                           uint32_t* __restrict__ any_mask, int64_t n_rows,
                           int d_win) {
  const int lane = threadIdx.x & 31;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  // Warp-aligned rows, so each ballot fills one whole bitmask word.
  for (int64_t base = (int64_t)blockIdx.x * blockDim.x + (threadIdx.x & ~31);
       base < n_rows; base += stride) {
    const int64_t r = base + lane;
    uint32_t pat = 0;
    if (r < n_rows) {
      int32_t cd = countdown[r];
      const int32_t iv = interval[r];
      const bool al = alive[r] != 0;
      for (int s = 0; s < d_win; ++s) {
        const bool spk = cd == 0 && al;
        // int32 arithmetic that wraps, as the reference's does.
        cd = spk ? (int32_t)((uint32_t)iv - 1u) : (int32_t)((uint32_t)cd - 1u);
        spikes[s * n_rows + r] = spk ? 1 : 0;
        pat |= (uint32_t)spk << s;
      }
      countdown_out[r] = cd;
      pattern[r] = pat;
    }
    const uint32_t word = __ballot_sync(kFull, pat != 0);
    if (lane == 0) any_mask[base >> 5] = word;
  }
}

constexpr int kChunk = 512;   // synapses per ring stage: 2 KB of src
constexpr int kStages = 2;    // ring stages per warp
constexpr int kQueue = 64;    // hit queue entries per warp (a power of two)

// One warp's shared memory; a multiple of 16 bytes, so every ring stage
// stays 16-byte aligned for the bulk copies.
struct alignas(16) WarpSmem {
  int32_t ring[kStages][kChunk];
  uint64_t bar[kStages];
  int32_t q_col[kQueue];      // column of the hit within its row
  uint32_t q_src[kQueue];     // its source, a global neuron index
};
static_assert(sizeof(WarpSmem) % 16 == 0, "ring stages must stay 16-byte aligned");

// Copy `bytes` (a multiple of 16, both addresses 16-byte aligned) from
// global to shared memory; the barrier's phase completes when they land.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  mbar_expect_tx(bar, bytes);
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes),
        "r"(smem_u32(bar))
      : "memory");
}

// One warp's pass over its rows: the filter, the queue and the hit path.
template <typename DelayT>
struct RowPass {
  const uint32_t* any;      // sources that spiked in the window
  const uint32_t* pattern;  // [N] D-bit spike pattern per source
  WarpSmem& ws;
  float* acc;               // this warp's accumulator, `width` floats
  int lane, steps_lo, r_span, width;
  int head = 0, count = 0;  // the queue (warp-uniform)
  bool hit = false;         // this lane deposited into the current row

  // G synapses per lane: lane-local tests against the bitmask first (G
  // independent shared-memory loads), then one warp vote; only if some lane
  // hit does the warp queue its hits, one ballot per synapse slot.
  // `b[q]` is the source of column `col[q]`; an invalid slot holds a source
  // that lies in range.
  template <int G>
  __device__ __forceinline__ void offer(const bool (&valid)[G], const int (&col)[G],
                                        const uint32_t (&b)[G], const float* w,
                                        const DelayT* delay) {
    bool f[G], any_f = false;
#pragma unroll
    for (int q = 0; q < G; ++q) {
      f[q] = ((any[b[q] >> 5] >> (b[q] & 31)) & 1u) && valid[q];
      any_f |= f[q];
    }
    if (!__any_sync(kFull, any_f)) return;
#pragma unroll
    for (int q = 0; q < G; ++q) push(f[q], col[q], b[q], w, delay);
  }

  // Queue this lane's synapse if it fired; drain once 32 hits are queued.
  __device__ __forceinline__ void push(bool fired, int col, uint32_t b, const float* w,
                                       const DelayT* delay) {
    const uint32_t ballot = __ballot_sync(kFull, fired);
    if (!ballot) return;
    if (fired) {
      const int e = (head + count + __popc(ballot & ((1u << lane) - 1u))) & (kQueue - 1);
      ws.q_col[e] = col;
      ws.q_src[e] = b;
    }
    count += __popc(ballot);
    if (count >= 32) drain(32, w, delay);
  }

  // Each of the first m lanes takes one queued hit of the current row and
  // loads its delay, weight and pattern together; a delay outside the
  // window clears the pattern.
  __device__ __forceinline__ void drain(int m, const float* w, const DelayT* delay) {
    __syncwarp();
    if (lane < m) {
      const int e = (head + lane) & (kQueue - 1);
      const int c = ws.q_col[e];
      const int j = (int)delay[c] - steps_lo;
      const float wc = w[c];
      const uint32_t pat = pattern[ws.q_src[e]];
      const bool inside = (unsigned)j < (unsigned)r_span;
      hit |= inside;
      // acc[x] is column steps_lo + x of the row: cycle q lands at q + j.
      for (uint32_t p = inside ? pat : 0u; p; p &= p - 1)
        atomicAdd(acc + (__ffs(p) - 1) + j, wc);
    }
    head = (head + m) & (kQueue - 1);
    count -= m;
    __syncwarp();  // the entries are read before new hits overwrite them
  }

  // The row's last synapse was offered: drain the queue, add the
  // accumulator into the row's columns if anything landed, reset.
  __device__ __forceinline__ void end_row(const float* w, const DelayT* delay, float* out) {
    while (count > 0) drain(count < 32 ? count : 32, w, delay);
    if (__any_sync(kFull, hit))
      for (int x = lane; x < width; x += 32) out[x] = __fadd_rn(out[x], acc[x]);
    for (int x = lane; x < width; x += 32) acc[x] = 0.0f;
    hit = false;
    __syncwarp();
  }
};

// One block of 32 warps per SM (the ring and queues take most of shared
// memory), 64 registers a thread. Warp g of the grid owns rows g, g + G, ...
template <typename DelayT, bool kBulk>
__global__ void __launch_bounds__(kThreads, 1) iaf_deposit(
    const uint32_t* __restrict__ any_g, const uint32_t* __restrict__ pattern,
    const int32_t* __restrict__ src, const float* __restrict__ w,
    const DelayT* __restrict__ delay, float* __restrict__ fut, int64_t n_rows,
    int64_t n, int k, int fut_width, int steps_lo, int r_span, int width,
    bool mask_in_smem) {
  extern __shared__ uint4 smem[];
  const uint32_t* any;
  WarpSmem* warps = reinterpret_cast<WarpSmem*>(
      stage_mask(smem, any_g, (n_rows + 31) / 32, mask_in_smem, &any));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  WarpSmem& ws = warps[warp];
  float* acc = reinterpret_cast<float*>(warps + kWarps) + warp * width;
  for (int x = lane; x < width; x += 32) acc[x] = 0.0f;
  RowPass<DelayT> pass{any, pattern, ws, acc, lane, steps_lo, r_span, width};

  const int64_t first = (int64_t)blockIdx.x * kWarps + warp;
  const int64_t step = (int64_t)gridDim.x * kWarps;
  if constexpr (kBulk) {
    const int per_row = (k + kChunk - 1) / kChunk;  // chunks per row
    // The loader's position: chunk `ld_j` of row `ld_r`, the `ld`-th chunk.
    int64_t ld_r = first, ld = 0;
    int ld_j = 0;
    auto load_next = [&]() {
      if (ld_r >= n_rows) return;
      const int c0 = ld_j * kChunk;
      const int len = k - c0 < kChunk ? k - c0 : kChunk;
      const int s = (int)(ld % kStages);
      bulk_load(ws.ring[s], src + ld_r * k + c0, 4u * (uint32_t)len, &ws.bar[s]);
      ++ld;
      if (++ld_j == per_row) ld_j = 0, ld_r += step;
    };
    if (lane == 0) {
      for (int s = 0; s < kStages; ++s) mbar_init(&ws.bar[s], 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      for (int s = 0; s < kStages - 1; ++s) load_next();
    }
    __syncwarp();
    int64_t g = 0;  // chunks consumed
    for (int64_t r = first; r < n_rows; r += step) {
      const int64_t base = r * (int64_t)k;
      const uint32_t off = (uint32_t)((r / n) * n);  // the row's area: its sources
      for (int j = 0; j < per_row; ++j, ++g) {
        // Stage (g - 1) % kStages was read by every lane before the
        // __syncwarp that ended the previous chunk; refill it.
        if (lane == 0) {
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          load_next();
        }
        const int s = (int)(g % kStages);
        mbar_wait(&ws.bar[s], (uint32_t)((g / kStages) & 1));
        const int c0 = j * kChunk;
        const int len4 = (k - c0 < kChunk ? k - c0 : kChunk) >> 2;
        const int4* chunk = reinterpret_cast<const int4*>(ws.ring[s]);
        for (int i0 = 0; i0 < len4; i0 += 64) {
          // Two 16-byte loads from the stage per lane: eight synapses.
          bool valid[8];
          int col[8];
          uint32_t b[8];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int i = i0 + 32 * h + lane;
            const bool ok = i < len4;
            const int4 v = ok ? chunk[i] : make_int4(0, 0, 0, 0);
            const int vs[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              valid[4 * h + q] = ok;
              col[4 * h + q] = c0 + 4 * i + q;
              b[4 * h + q] = off + vs[q];
            }
          }
          pass.offer(valid, col, b, w + base, delay + base);
        }
        __syncwarp();
      }
      pass.end_row(w + base, delay + base, fut + r * (int64_t)fut_width + steps_lo);
    }
  } else {
    for (int64_t r = first; r < n_rows; r += step) {
      const int64_t base = r * (int64_t)k;
      const uint32_t off = (uint32_t)((r / n) * n);
      const int32_t* row = src + base;
      for (int c0 = 0; c0 < k; c0 += 128) {
        // Four loads in flight per lane before any test.
        bool valid[4];
        int col[4];
        uint32_t b[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          col[q] = c0 + 32 * q + lane;
          valid[q] = col[q] < k;
          b[q] = off + (valid[q] ? __ldcs(row + col[q]) : 0);
        }
        pass.offer(valid, col, b, w + base, delay + base);
      }
      pass.end_row(w + base, delay + base, fut + r * (int64_t)fut_width + steps_lo);
    }
  }
}

// Dynamic shared memory of `iaf_deposit`: the warps' rings and queues, the
// accumulators, and the bitmask in front of them when everything fits.
static SmemPlan plan_deposit_smem(int64_t mask_words, int width) {
  const size_t warp_bytes = kWarps * (sizeof(WarpSmem) + sizeof(float) * (size_t)width);
  const size_t mask_bytes = 16 * (size_t)((mask_words + 3) / 4);
  const bool in_smem = mask_bytes + warp_bytes <= kMaxSmem;
  return {warp_bytes + (in_smem ? mask_bytes : 0), in_smem};
}

template <typename DelayT, bool kBulk>
static int launch_deposit(const uint32_t* any, const uint32_t* pattern,
                          const void* src, const void* w, const void* delay,
                          void* fut, int64_t n_rows, int64_t n, int k,
                          int fut_width, int steps_lo, int r_span, int d_win,
                          cudaStream_t stream) {
  auto kernel = iaf_deposit<DelayT, kBulk>;
  const int width = d_win - 1 + r_span;
  const SmemPlan plan = plan_deposit_smem((n_rows + 31) / 32, width);
  if (plan.bytes > kMaxSmem) return (int)cudaErrorInvalidValue;
  int64_t blocks = 0;
  const cudaError_t err = co_resident_blocks(kernel, plan.bytes, &blocks);
  if (err != cudaSuccess) return (int)err;
  if (blocks > (n_rows + kWarps - 1) / kWarps) blocks = (n_rows + kWarps - 1) / kWarps;
  kernel<<<(unsigned)blocks, kThreads, plan.bytes, stream>>>(
      any, pattern, (const int32_t*)src, (const float*)w, (const DelayT*)delay,
      (float*)fut, n_rows, n, k, fut_width, steps_lo, r_span, width,
      plan.mask_in_smem);
  return (int)cudaGetLastError();
}

// `any_mask` is scratch of ceil(N / 128) * 4 uint32 words, `pattern` of N.
extern "C" int superstep_iaf_launch(
    const void* countdown, const void* interval, const void* alive,
    void* countdown_out, void* fut, const void* src, const void* w,
    const void* delay, int delay_bytes, void* spikes, void* pattern,
    void* any_mask, int64_t n_areas, int64_t n, int k, int fut_width, int d_win,
    int steps_lo, int r_span, void* stream_ptr) {
  const int64_t n_rows = n_areas * n;
  if (n_rows <= 0 || d_win <= 0) return 0;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  iaf_spikes<<<(unsigned)((n_rows + 255) / 256), 256, 0, stream>>>(
      (const int32_t*)countdown, (const int32_t*)interval, (const uint8_t*)alive,
      (int32_t*)countdown_out, (uint8_t*)spikes, (uint32_t*)pattern,
      (uint32_t*)any_mask, n_rows, d_win);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || r_span <= 0 || k <= 0) return (int)err;
  const uint32_t* any = (const uint32_t*)any_mask;
  const uint32_t* pat = (const uint32_t*)pattern;
  const bool bulk = k % 4 == 0 && ((uintptr_t)src & 15) == 0;
  if (delay_bytes == 1)
    return bulk ? launch_deposit<int8_t, true>(any, pat, src, w, delay, fut, n_rows, n, k,
                                               fut_width, steps_lo, r_span, d_win, stream)
                : launch_deposit<int8_t, false>(any, pat, src, w, delay, fut, n_rows, n, k,
                                                fut_width, steps_lo, r_span, d_win, stream);
  return bulk ? launch_deposit<int32_t, true>(any, pat, src, w, delay, fut, n_rows, n, k,
                                              fut_width, steps_lo, r_span, d_win, stream)
              : launch_deposit<int32_t, false>(any, pat, src, w, delay, fut, n_rows, n, k,
                                               fut_width, steps_lo, r_span, d_win, stream);
}

// `iaf_deposit`'s dynamic shared memory for an n_rows-neuron network, and
// whether that holds the bitmask (1) or the bitmask is read through L2 (0).
extern "C" int superstep_iaf_smem_bytes(int64_t n_rows, int d_win, int r_span) {
  return (int)plan_deposit_smem((n_rows + 31) / 32, d_win - 1 + r_span).bytes;
}

extern "C" int superstep_iaf_mask_in_smem(int64_t n_rows, int d_win, int r_span) {
  return plan_deposit_smem((n_rows + 31) / 32, d_win - 1 + r_span).mask_in_smem ? 1 : 0;
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
