// One fused D-cycle LIF window over [A, n] neurons (N = A * n rows):
// for s in [0, D):
//     drive  = (counter_uniform(seed, t0 + s, gid) < p) * w_ext
//     state, spike = lif_step(state, fut[:, s] + drive)
//     fut[r, s + delay] += w           for every intra synapse of row r
//                                      whose source spiked in cycle s
// with delays outside [steps_lo, steps_lo + r_span) ignored.
//
// Replaces the Pallas TPU kernel `superstep_lif_pallas`
// (src/repro/kernels/cycle.py). That kernel keeps one whole area in one
// program; at the paper's per-area size an area's live buffer alone is
// 20.8 MB (130,000 x 40 columns x 4 B), ~90x a block's shared memory. Here
// the window is one persistent, cooperative launch over the whole network:
//   * every warp owns a fixed set of 32-row chunks for all D cycles. Its
//     lanes take the LIF step of the chunk's 32 neurons and `__ballot_sync`
//     writes the chunk's spikes into this cycle's bitmask word (D bitmasks of
//     N bits, each padded to 128 bytes so no cache line spans two cycles);
//   * the same warp then deposits into each of its rows, one row at a time,
//     streaming the row of `src` (deposit.cuh). Only the owning warp ever
//     touches a row's `fut`, and a deposit of cycle s lands in columns
//     > s (steps_lo >= 1) or in column s after it was read, so the only
//     grid-wide dependency is "cycle s's bitmask is complete" before "any
//     row reads it": one grid barrier per cycle, D per window;
//   * after each barrier every block copies cycle s's bitmask into shared
//     memory (65 KB for 520,000 neurons), as spike_deliver does;
//   * an area in which no neuron spiked in cycle s deposits nothing, so its
//     rows skip the pass over `src` (a per-cycle, per-area flag).
// The grid is every co-resident block (occupancy x SMs) and is launched with
// `cudaLaunchCooperativeKernel`, which refuses a grid that cannot be
// co-resident instead of deadlocking; the barrier itself is a monotone
// arrival counter (no relocatable device code needed).
//
// Bound on an H100: memory. Each cycle in which an area spiked streams that
// area's rows of `src` (4 B/synapse): 10 x 6.24 GB per window at the paper's
// per-area size when every area spikes every cycle, ~18.6 ms at 3.35 TB/s.
// State, drive, `fut` (W columns) and the active synapses' `w`/`delay` add
// little. `fut` (83 MB at 4 x 130,000 x 40) and the tables stay in device
// memory.

#include "deposit.cuh"
#include "neuron.cuh"

struct LifArgs {
  const float* v;            // [N] state in
  const float* i_syn;
  const int32_t* refrac;
  const float* drive_p;      // [N] per-cycle drive probability
  const int32_t* gids;       // [N] global ids (drive counter)
  const uint8_t* alive;      // [N] bool
  float* v_out;              // [N] state out (also the state between cycles)
  float* i_out;
  int32_t* refrac_out;
  float* fut;                // [N, W] live window, updated in place
  const int32_t* src;        // [N, K] source index within the area
  const float* w;            // [N, K]
  const void* delay;         // [N, K] int8 or int32
  uint8_t* spikes;           // [D, N] bool
  uint32_t* masks;           // [D, mask_stride] spike bitmasks
  int32_t* flags;            // [D, A] zeroed: an area spiked in cycle s
  unsigned int* arrived;     // [1] zeroed: grid barrier arrivals
  int64_t n;                 // neurons per area
  int64_t n_rows;            // N = A * n
  int64_t mask_stride;       // words per bitmask, a multiple of 32
  int64_t t0;
  int n_areas, k, fut_width, d_win, steps_lo, r_span;
  uint32_t seed;
  LifParams p;
  float w_ext;
  bool mask_in_smem;
};

// Every block arrives once per barrier; barrier number `round` (1, 2, ...)
// releases when all gridDim.x blocks have arrived `round` times. Needs all
// blocks co-resident, which the cooperative launch guarantees.
__device__ __forceinline__ void grid_barrier(unsigned int* arrived, unsigned int round) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(arrived, 1u);
    const unsigned int target = round * gridDim.x;
    while (*(volatile unsigned int*)arrived < target) __nanosleep(100);
    __threadfence();
  }
  __syncthreads();
}

template <typename DelayT>
struct LifVisit {
  const uint32_t* mask;  // this cycle's bitmask
  const float* w;        // row base
  const DelayT* delay;   // row base
  int64_t off;           // area * n: the row's sources in the bitmask
  int steps_lo, r_span;
  bool in_smem;          // else the bitmask is read from device memory

  __device__ __forceinline__ bool operator()(int s, int c, float* acc) const {
    const int64_t b = off + s;
    // Written during this launch: read through L2, never a stale L1 line.
    const uint32_t word = in_smem ? mask[b >> 5] : __ldcg(mask + (b >> 5));
    if (!((word >> (b & 31)) & 1u)) return false;
    const int j = (int)delay[c] - steps_lo;
    if (j < 0 || j >= r_span) return false;
    atomicAdd(acc + j, w[c]);
    return true;
  }
};

template <typename DelayT, bool kVec>
__global__ void __launch_bounds__(kThreads, 2) superstep_lif_kernel(const LifArgs a) {
  extern __shared__ uint4 smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t n_warps = (int64_t)gridDim.x * kWarps;
  const int64_t first = (int64_t)blockIdx.x * kWarps + warp;
  const int64_t n_chunks = (a.n_rows + 31) / 32;
  const int64_t n_words = n_chunks;
  const uint32_t seed_mix = splitmix32(a.seed);
  const DelayT* delay = static_cast<const DelayT*>(a.delay);
  const int64_t W = a.fut_width;
  const bool deposit = a.r_span > 0 && a.k > 0;

  for (int s = 0; s < a.d_win; ++s) {
    // Update: the LIF step of every owned neuron, one chunk per ballot.
    uint32_t* mask_s = a.masks + s * a.mask_stride;
    for (int64_t c = first; c < n_chunks; c += n_warps) {
      const int64_t r = c * 32 + lane;
      bool spike = false;
      if (r < a.n_rows) {
        float v = s == 0 ? a.v[r] : a.v_out[r];
        float i = s == 0 ? a.i_syn[r] : a.i_out[r];
        int32_t refrac = s == 0 ? a.refrac[r] : a.refrac_out[r];
        const float u = counter_uniform(seed_mix, (uint32_t)(a.t0 + s), (uint32_t)a.gids[r]);
        const float drive = __fmul_rn(u < a.drive_p[r] ? 1.0f : 0.0f, a.w_ext);
        const float i_in = __fadd_rn(a.fut[r * W + s], drive);
        spike = lif_step(v, i, refrac, i_in, a.alive[r] != 0, a.p);
        a.v_out[r] = v;
        a.i_out[r] = i;
        a.refrac_out[r] = refrac;
        a.spikes[s * a.n_rows + r] = spike ? 1 : 0;
        if (spike) a.flags[s * a.n_areas + r / a.n] = 1;
      }
      const uint32_t word = __ballot_sync(kFull, spike);
      if (lane == 0) mask_s[c] = word;
    }
    if (!deposit) continue;
    grid_barrier(a.arrived, (unsigned int)(s + 1));

    // Deposit: every owned row against cycle s's complete bitmask.
    const uint32_t* mask;
    float* acc = stage_mask(smem, mask_s, n_words, a.mask_in_smem, &mask) + warp * a.r_span;
    for (int64_t c = first; c < n_chunks; c += n_warps) {
      const int64_t r_end = c * 32 + 32 < a.n_rows ? c * 32 + 32 : a.n_rows;
      for (int64_t r = c * 32; r < r_end; ++r) {
        const int64_t area = r / a.n;
        if (__ldcg(a.flags + s * a.n_areas + area) == 0) continue;
        const int64_t base = r * (int64_t)a.k;
        const LifVisit<DelayT> visit{mask, a.w + base, delay + base, area * a.n,
                                     a.steps_lo, a.r_span, a.mask_in_smem};
        deposit_row<kVec>(a.src + base, a.k, lane, acc, a.r_span,
                          a.fut + r * W + s + a.steps_lo, visit);
      }
    }
    // The lanes that read fut[:, s + 1] next see this cycle's deposits.
    __syncwarp();
  }
}

template <typename DelayT, bool kVec>
static int launch(LifArgs a, cudaStream_t stream) {
  auto kernel = superstep_lif_kernel<DelayT, kVec>;
  const SmemPlan plan = plan_smem((a.n_rows + 31) / 32, a.r_span);
  a.mask_in_smem = plan.mask_in_smem;
  int dev = 0, coop = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev)) != cudaSuccess)
    return (int)err;
  if (!coop) return (int)cudaErrorNotSupported;
  int64_t blocks = 0;
  if ((err = co_resident_blocks(kernel, plan.bytes, &blocks)) != cudaSuccess) return (int)err;
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel((const void*)kernel, dim3((unsigned)blocks),
                                    dim3(kThreads), args, plan.bytes, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

extern "C" int superstep_lif_launch(
    const void* v, const void* i_syn, const void* refrac, const void* drive_p,
    const void* gids, const void* alive, void* v_out, void* i_out,
    void* refrac_out, void* fut, const void* src, const void* w,
    const void* delay, int delay_bytes, void* spikes, void* masks, void* flags,
    void* arrived, int64_t n_areas, int64_t n, int k, int fut_width, int d_win,
    int steps_lo, int r_span, int64_t t0, uint32_t seed, float p11, float p21,
    float p22, float v_th, float v_reset, int t_ref_steps, float w_ext,
    int64_t mask_stride, void* stream_ptr) {
  if (n_areas <= 0 || n <= 0 || d_win <= 0) return 0;
  LifArgs a{};
  a.v = (const float*)v;
  a.i_syn = (const float*)i_syn;
  a.refrac = (const int32_t*)refrac;
  a.drive_p = (const float*)drive_p;
  a.gids = (const int32_t*)gids;
  a.alive = (const uint8_t*)alive;
  a.v_out = (float*)v_out;
  a.i_out = (float*)i_out;
  a.refrac_out = (int32_t*)refrac_out;
  a.fut = (float*)fut;
  a.src = (const int32_t*)src;
  a.w = (const float*)w;
  a.delay = delay;
  a.spikes = (uint8_t*)spikes;
  a.masks = (uint32_t*)masks;
  a.flags = (int32_t*)flags;
  a.arrived = (unsigned int*)arrived;
  a.n = n;
  a.n_rows = n_areas * n;
  a.mask_stride = mask_stride;
  a.t0 = t0;
  a.n_areas = (int)n_areas;
  a.k = k;
  a.fut_width = fut_width;
  a.d_win = d_win;
  a.steps_lo = steps_lo;
  a.r_span = r_span;
  a.seed = seed;
  a.p = LifParams{p11, p21, p22, v_th, v_reset, (int32_t)t_ref_steps};
  a.w_ext = w_ext;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const bool vec = k % 4 == 0 && ((uintptr_t)src & 15) == 0;
  if (delay_bytes == 1)
    return vec ? launch<int8_t, true>(a, stream) : launch<int8_t, false>(a, stream);
  return vec ? launch<int32_t, true>(a, stream) : launch<int32_t, false>(a, stream);
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
