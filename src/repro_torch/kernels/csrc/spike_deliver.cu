// Delay-resolved spike delivery:
//     contrib[n, j] = sum_k w[n,k] * spk[off(n) + src[n,k]] * [delay[n,k] == steps_lo + j]
// for j < r_span, where off(n) = (n / rows_per_area) * src_stride lets the
// intra pathway index its per-area source vectors without a lifted copy of
// `src` (the inter pathway passes src_stride = 0: its ids are global).
//
// Replaces the Pallas TPU kernel `spike_deliver_pallas`
// (src/repro/kernels/spike_deliver.py, body `delay_resolved_contrib`). That
// kernel makes r_span masked passes over K, O(N * K * r_span) work that suits
// the TPU's vector unit; here it would be 30-91x wasted work. This kernel
// makes one pass over K and scatters each active synapse into its slot.
//
// Bound on an H100: memory. The tables are 9 B/synapse (src i32, w f32,
// delay i8), 14 GB per pathway at the paper's per-area size, far beyond the
// 50 MB L2. Only `src` has to be read in full; `w` and `delay` are needed
// only where the source spiked, a small fraction of synapses at biological
// rates. The design:
//   * `pack_spikes` turns the f32 spike vector into a bitmask of nonzero
//     entries (1 bit per neuron: 65 KB for 520,000 neurons);
//   * `spike_deliver_kernel` is persistent (two 1024-thread blocks per SM).
//     Each block copies the bitmask into shared memory once, where a warp's
//     32 random lookups cost a few bank conflicts, not 32 cache lines as
//     gathers from L1/L2 do. A bitmask too large for shared memory is read
//     from device memory instead;
//   * one warp per target row; lanes stream `src` with 16-byte loads (when
//     K % 4 == 0 and the table is 16-byte aligned) and the streaming hint
//     `__ldcs`, two loads in flight per lane;
//   * a synapse whose bit is set loads its spike value, `w` and `delay` (int8
//     read as stored) and adds w * spike into its warp's shared accumulator
//     acc[r_span] (at most 91 floats at the paper's delays); the warp then
//     writes its row of `contrib` once.
//
// Order of the adds: shared-memory atomics add in no fixed order. The sum is
// exact all the same, because weights lie on the 1/256 grid and every partial
// sum stays below 2^15 in magnitude, so each f32 add is exact.

#include "deposit.cuh"

__global__ void pack_spikes(const float* __restrict__ spikes,
                            uint32_t* __restrict__ mask, int64_t n_src) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const bool on = i < n_src && spikes[i] != 0.0f;
  const uint32_t word = __ballot_sync(0xffffffffu, on);
  if ((threadIdx.x & 31) == 0 && i < n_src) mask[i >> 5] = word;
}

template <typename DelayT>
struct Row {
  const uint32_t* mask;
  const float* spikes;  // already offset by off(n)
  const float* w;       // row base
  const DelayT* delay;  // row base
  float* acc;
  int mask_off;         // off(n), for the bitmask
  int steps_lo, r_span;

  __device__ __forceinline__ void operator()(int s, int c) const {
    if (bit_set(mask, mask_off + s)) {
      const int j = (int)delay[c] - steps_lo;
      if (j >= 0 && j < r_span) atomicAdd(acc + j, __fmul_rn(w[c], spikes[s]));
    }
  }
};

// Two blocks per SM cap the kernel at 32 registers, so 64 warps per SM
// hide the dependent loads (src -> bitmask -> w, delay); left to itself the
// compiler took 58 registers, one block per SM, and was slower (PERF.md).
template <typename DelayT, bool kVec>
__global__ void __launch_bounds__(kThreads, 2) spike_deliver_kernel(
    const uint32_t* __restrict__ mask_g, const float* __restrict__ spikes,
    const int32_t* __restrict__ src, const float* __restrict__ w,
    const DelayT* __restrict__ delay, float* __restrict__ out, int64_t n_rows,
    int k, int steps_lo, int r_span, int64_t rows_per_area, int64_t src_stride,
    int n_words, bool mask_in_smem) {
  extern __shared__ uint4 smem[];
  const uint32_t* mask;
  float* acc = stage_mask(smem, mask_g, n_words, mask_in_smem, &mask) +
               (threadIdx.x >> 5) * r_span;
  const int lane = threadIdx.x & 31;
  for (int64_t row = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5); row < n_rows;
       row += (int64_t)gridDim.x * kWarps) {
    for (int j = lane; j < r_span; j += 32) acc[j] = 0.0f;
    __syncwarp();
    const int64_t base = row * (int64_t)k;
    const int64_t off = (row / rows_per_area) * src_stride;
    Row<DelayT> r{mask, spikes + off, w + base, delay + base, acc,
                  (int)off, steps_lo, r_span};
    stream_row<kVec>(src + base, k, lane, r);
    __syncwarp();
    float* o = out + row * (int64_t)r_span;
    for (int j = lane; j < r_span; j += 32) o[j] = acc[j];
  }
}

template <typename DelayT, bool kVec>
static int launch_rows(const uint32_t* mask, const void* spikes, const void* src,
                       const void* w, const void* delay, void* out,
                       int64_t n_rows, int k, int steps_lo, int r_span,
                       int64_t rows_per_area, int64_t src_stride, int n_words,
                       cudaStream_t stream) {
  auto kernel = spike_deliver_kernel<DelayT, kVec>;
  const SmemPlan plan = plan_smem(n_words, r_span);
  int64_t blocks = 0;
  const cudaError_t err = co_resident_blocks(kernel, plan.bytes, &blocks);
  if (err != cudaSuccess) return (int)err;
  if (blocks > (n_rows + kWarps - 1) / kWarps) blocks = (n_rows + kWarps - 1) / kWarps;
  kernel<<<(unsigned)blocks, kThreads, plan.bytes, stream>>>(
      mask, (const float*)spikes, (const int32_t*)src, (const float*)w,
      (const DelayT*)delay, (float*)out, n_rows, k, steps_lo, r_span,
      rows_per_area, src_stride, n_words, plan.mask_in_smem);
  return (int)cudaGetLastError();
}

// `mask` is scratch of ceil(n_src / 128) * 4 uint32 words, 16-byte aligned.
template <typename DelayT>
static int launch(const void* spikes, int64_t n_src, void* mask, const void* src,
                  const void* w, const void* delay, void* out, int64_t n_rows,
                  int k, int steps_lo, int r_span, int64_t rows_per_area,
                  int64_t src_stride, void* stream_ptr) {
  if (n_rows <= 0 || r_span <= 0) return 0;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const int n_words = (int)((n_src + 31) / 32);
  pack_spikes<<<(unsigned)((n_src + 255) / 256), 256, 0, stream>>>(
      (const float*)spikes, (uint32_t*)mask, n_src);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const bool vec = k % 4 == 0 && ((uintptr_t)src & 15) == 0;
  return vec ? launch_rows<DelayT, true>((const uint32_t*)mask, spikes, src, w,
                                         delay, out, n_rows, k, steps_lo,
                                         r_span, rows_per_area, src_stride,
                                         n_words, stream)
             : launch_rows<DelayT, false>((const uint32_t*)mask, spikes, src, w,
                                          delay, out, n_rows, k, steps_lo,
                                          r_span, rows_per_area, src_stride,
                                          n_words, stream);
}

extern "C" int spike_deliver_i8_launch(
    const void* spikes, int64_t n_src, void* mask, const void* src,
    const void* w, const void* delay, void* out, int64_t n_rows, int k,
    int steps_lo, int r_span, int64_t rows_per_area, int64_t src_stride,
    void* stream) {
  return launch<int8_t>(spikes, n_src, mask, src, w, delay, out, n_rows, k,
                        steps_lo, r_span, rows_per_area, src_stride, stream);
}

extern "C" int spike_deliver_i32_launch(
    const void* spikes, int64_t n_src, void* mask, const void* src,
    const void* w, const void* delay, void* out, int64_t n_rows, int k,
    int steps_lo, int r_span, int64_t rows_per_area, int64_t src_stride,
    void* stream) {
  return launch<int32_t>(spikes, n_src, mask, src, w, delay, out, n_rows, k,
                         steps_lo, r_span, rows_per_area, src_stride, stream);
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
