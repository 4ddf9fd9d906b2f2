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

#include <cuda_runtime.h>
#include <stdint.h>

constexpr int kWarps = 32;               // warps per block
constexpr int kThreads = 32 * kWarps;
constexpr size_t kMaxSmem = 232448;      // per-block limit on sm_90

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

  __device__ __forceinline__ void visit(int s, int c) const {
    const int b = mask_off + s;
    if ((mask[b >> 5] >> (b & 31)) & 1u) {
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
  extern __shared__ uint4 smem_raw[];
  uint32_t* smem = reinterpret_cast<uint32_t*>(smem_raw);
  const uint32_t* mask = mask_g;
  float* acc_all = reinterpret_cast<float*>(smem);
  if (mask_in_smem) {
    const int n4 = (n_words + 3) / 4;
    const uint4* g4 = reinterpret_cast<const uint4*>(mask_g);
    for (int i = threadIdx.x; i < n4; i += kThreads) smem_raw[i] = g4[i];
    __syncthreads();
    mask = smem;
    acc_all = reinterpret_cast<float*>(smem + 4 * n4);
  }
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* acc = acc_all + warp * r_span;
  for (int64_t row = (int64_t)blockIdx.x * kWarps + warp; row < n_rows;
       row += (int64_t)gridDim.x * kWarps) {
    for (int j = lane; j < r_span; j += 32) acc[j] = 0.0f;
    __syncwarp();
    const int64_t base = row * (int64_t)k;
    const int64_t off = (row / rows_per_area) * src_stride;
    const Row<DelayT> r{mask, spikes + off, w + base, delay + base, acc,
                        (int)off, steps_lo, r_span};
    if (kVec) {
      const int4* s4 = reinterpret_cast<const int4*>(src + base);
      const int k4 = k >> 2;
      for (int c = lane; c < k4; c += 64) {
        const bool two = c + 32 < k4;
        const int4 a = __ldcs(s4 + c);
        int4 b = a;
        if (two) b = __ldcs(s4 + c + 32);
        r.visit(a.x, 4 * c); r.visit(a.y, 4 * c + 1);
        r.visit(a.z, 4 * c + 2); r.visit(a.w, 4 * c + 3);
        if (two) {
          const int cb = 4 * (c + 32);
          r.visit(b.x, cb); r.visit(b.y, cb + 1);
          r.visit(b.z, cb + 2); r.visit(b.w, cb + 3);
        }
      }
    } else {
#pragma unroll 4
      for (int c = lane; c < k; c += 32) r.visit(__ldcs(src + base + c), c);
    }
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
  const size_t acc_bytes = sizeof(float) * kWarps * (size_t)r_span;
  const size_t mask_bytes = 16 * (size_t)((n_words + 3) / 4);
  const bool in_smem = mask_bytes + acc_bytes <= kMaxSmem;
  const size_t smem = acc_bytes + (in_smem ? mask_bytes : 0);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem)) !=
      cudaSuccess)
    return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  int64_t blocks = (n_rows + kWarps - 1) / kWarps;
  if (blocks > (int64_t)sms * per_sm) blocks = (int64_t)sms * per_sm;
  kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(
      mask, (const float*)spikes, (const int32_t*)src, (const float*)w,
      (const DelayT*)delay, (float*)out, n_rows, k, steps_lo, r_span,
      rows_per_area, src_stride, n_words, in_smem);
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
