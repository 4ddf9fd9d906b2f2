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
// whole window's spikes are known before any deposit, and one pass over the
// tables serves all D cycles:
//   (a) `iaf_spikes` runs the D cycles of every neuron (one thread each) and
//       writes the [D, N] spikes, the final countdown, a per-source D-bit
//       pattern (bit s: spiked in cycle s) and a bitmask of the sources that
//       spiked at all in the window (1 bit per neuron: 65 KB for 520,000);
//   (b) `iaf_deposit` streams `src` once per window, one warp per target row
//       (deposit.cuh), with the "any" bitmask in shared memory. Only a
//       synapse whose source spiked reads its pattern, `w` and `delay`, and
//       adds `w` at column s + delay for every set bit s of the pattern.
// This does the work of the Pallas kernel's D masked passes with one tenth of
// the table reads at D = 10.
//
// Bound on an H100: memory. `src` (4 B/synapse) is read once per window,
// 6.24 GB at the paper's per-area size, ~1.9 ms at 3.35 TB/s; the active
// synapses' `w`/`delay`/pattern, the state and `fut` add little.

#include "deposit.cuh"

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

template <typename DelayT>
struct IafVisit {
  const uint32_t* any;       // sources that spiked in the window
  const uint32_t* pattern;   // [N] D-bit spike pattern per source
  const float* w;            // row base
  const DelayT* delay;       // row base
  int64_t off;               // area * n: the row's sources
  int steps_lo, r_span;

  __device__ __forceinline__ bool operator()(int s, int c, float* acc) const {
    const int64_t b = off + s;
    if (!bit_set(any, b)) return false;
    const int j = (int)delay[c] - steps_lo;
    if (j < 0 || j >= r_span) return false;
    const float wc = w[c];
    // acc[x] is column steps_lo + x of the row: cycle q lands at q + j.
    for (uint32_t pat = pattern[b]; pat; pat &= pat - 1)
      atomicAdd(acc + (__ffs(pat) - 1) + j, wc);
    return true;
  }
};

// Two blocks per SM, 32 registers a thread, as spike_deliver.
template <typename DelayT, bool kVec>
__global__ void __launch_bounds__(kThreads, 2) iaf_deposit(
    const uint32_t* __restrict__ any_g, const uint32_t* __restrict__ pattern,
    const int32_t* __restrict__ src, const float* __restrict__ w,
    const DelayT* __restrict__ delay, float* __restrict__ fut, int64_t n_rows,
    int64_t n, int k, int fut_width, int steps_lo, int r_span, int width,
    bool mask_in_smem) {
  extern __shared__ uint4 smem[];
  const uint32_t* any;
  float* acc = stage_mask(smem, any_g, (n_rows + 31) / 32, mask_in_smem, &any) +
               (threadIdx.x >> 5) * width;
  const int lane = threadIdx.x & 31;
  for (int64_t r = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5); r < n_rows;
       r += (int64_t)gridDim.x * kWarps) {
    const int64_t base = r * (int64_t)k;
    const IafVisit<DelayT> visit{any, pattern, w + base, delay + base, (r / n) * n,
                                 steps_lo, r_span};
    deposit_row<kVec>(src + base, k, lane, acc, width,
                      fut + r * (int64_t)fut_width + steps_lo, visit);
  }
}

template <typename DelayT, bool kVec>
static int launch_deposit(const uint32_t* any, const uint32_t* pattern,
                          const void* src, const void* w, const void* delay,
                          void* fut, int64_t n_rows, int64_t n, int k,
                          int fut_width, int steps_lo, int r_span, int d_win,
                          cudaStream_t stream) {
  auto kernel = iaf_deposit<DelayT, kVec>;
  const int width = d_win - 1 + r_span;
  const SmemPlan plan = plan_smem((n_rows + 31) / 32, width);
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
  const bool vec = k % 4 == 0 && ((uintptr_t)src & 15) == 0;
  if (delay_bytes == 1)
    return vec ? launch_deposit<int8_t, true>(any, pat, src, w, delay, fut, n_rows, n, k,
                                              fut_width, steps_lo, r_span, d_win, stream)
               : launch_deposit<int8_t, false>(any, pat, src, w, delay, fut, n_rows, n, k,
                                               fut_width, steps_lo, r_span, d_win, stream);
  return vec ? launch_deposit<int32_t, true>(any, pat, src, w, delay, fut, n_rows, n, k,
                                             fut_width, steps_lo, r_span, d_win, stream)
             : launch_deposit<int32_t, false>(any, pat, src, w, delay, fut, n_rows, n, k,
                                              fut_width, steps_lo, r_span, d_win, stream);
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
