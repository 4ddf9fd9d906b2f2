// One exact-propagator iaf_psc_exp step over flat [N] neuron state.
//
// Replaces the Pallas TPU kernel `lif_update_pallas`
// (src/repro/kernels/lif_update.py, body `lif_step_math`).
//
// Exactness: the propagator is exactly the jitted reference's two fused
// multiply-adds (`lif_step` in neuron.cuh, compiled with -fmad=false).
//
// Bound on an H100: memory. Per neuron it reads v, i (f32), refrac (i32),
// i_in (f32), alive (1 B) and writes v, i, refrac and the spike byte:
// 30 B/neuron, a handful of flops; 15.6 MB and 4.7 us at N = 520,000. At
// that size the pass is one round of loads and stores, so what bounds it
// is how few instructions and requests carry those bytes and how soon the
// grid is on the card.
//
// The design: four neurons per thread, 16-byte loads and stores for v,
// i_syn, i_in, refrac and their outputs, 4-byte ones for alive and the
// spike bytes (a quarter of the memory instructions); a grid of at most one
// wave (132 SMs x resident blocks) striding over N. A scalar tail takes the
// last N % 4 neurons, and the whole of N when a pointer is not aligned for
// the wide accesses (16 bytes, 4 for the byte arrays). Nothing is staged in
// shared memory because no value is read twice.

#include "neuron.cuh"

__device__ __forceinline__ uint32_t step_byte(float& v, float& i, int32_t& r, float i_in,
                                              uint32_t alive4, int q, const LifParams& p) {
  const bool spike = lif_step(v, i, r, i_in, ((alive4 >> (8 * q)) & 0xffu) != 0, p);
  return (spike ? 1u : 0u) << (8 * q);
}

__global__ void __launch_bounds__(256) lif_update_kernel(
    const float* __restrict__ v, const float* __restrict__ i_syn,
    const int32_t* __restrict__ refrac, const float* __restrict__ i_in,
    const uint8_t* __restrict__ alive,
    float* __restrict__ v_out, float* __restrict__ i_out,
    int32_t* __restrict__ refrac_out, uint8_t* __restrict__ spike_out,
    int64_t n, int64_t n4, const LifParams p) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  for (int64_t q = tid; q < n4; q += stride) {
    float4 vq = reinterpret_cast<const float4*>(v)[q];
    float4 iq = reinterpret_cast<const float4*>(i_syn)[q];
    int4 rq = reinterpret_cast<const int4*>(refrac)[q];
    const float4 inq = reinterpret_cast<const float4*>(i_in)[q];
    const uint32_t al = reinterpret_cast<const uint32_t*>(alive)[q];
    uint32_t spikes = step_byte(vq.x, iq.x, rq.x, inq.x, al, 0, p);
    spikes |= step_byte(vq.y, iq.y, rq.y, inq.y, al, 1, p);
    spikes |= step_byte(vq.z, iq.z, rq.z, inq.z, al, 2, p);
    spikes |= step_byte(vq.w, iq.w, rq.w, inq.w, al, 3, p);
    reinterpret_cast<float4*>(v_out)[q] = vq;
    reinterpret_cast<float4*>(i_out)[q] = iq;
    reinterpret_cast<int4*>(refrac_out)[q] = rq;
    reinterpret_cast<uint32_t*>(spike_out)[q] = spikes;
  }
  for (int64_t k = 4 * n4 + tid; k < n; k += stride) {
    float vk = v[k];
    float ik = i_syn[k];
    int32_t rk = refrac[k];
    const bool spike = lif_step(vk, ik, rk, i_in[k], alive[k] != 0, p);
    v_out[k] = vk;
    i_out[k] = ik;
    refrac_out[k] = rk;
    spike_out[k] = spike ? 1 : 0;
  }
}

static bool aligned(const void* p, uintptr_t bytes) {
  return ((uintptr_t)p & (bytes - 1)) == 0;
}

extern "C" int lif_update_launch(
    const void* v, const void* i_syn, const void* refrac, const void* i_in,
    const void* alive, void* v_out, void* i_out, void* refrac_out,
    void* spike_out, int64_t n, float p11, float p21, float p22, float v_th,
    float v_reset, int t_ref_steps, void* stream) {
  if (n <= 0) return 0;
  const bool wide = aligned(v, 16) && aligned(i_syn, 16) && aligned(refrac, 16) &&
                    aligned(i_in, 16) && aligned(v_out, 16) && aligned(i_out, 16) &&
                    aligned(refrac_out, 16) && aligned(alive, 4) && aligned(spike_out, 4);
  const int64_t n4 = wide ? n / 4 : 0;
  const int threads = 256;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, lif_update_kernel, threads, 0);
  if (err != cudaSuccess) return (int)err;
  // One thread per quad (or per neuron on the scalar path), at most one wave.
  const int64_t items = wide ? n4 + n % 4 : n;
  int64_t blocks = (items + threads - 1) / threads;
  if (blocks > (int64_t)sms * per_sm) blocks = (int64_t)sms * per_sm;
  lif_update_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)v, (const float*)i_syn, (const int32_t*)refrac,
      (const float*)i_in, (const uint8_t*)alive, (float*)v_out, (float*)i_out,
      (int32_t*)refrac_out, (uint8_t*)spike_out, n, n4,
      LifParams{p11, p21, p22, v_th, v_reset, (int32_t)t_ref_steps});
  return (int)cudaGetLastError();
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
