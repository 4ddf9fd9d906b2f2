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
// 30 B/neuron, a handful of flops. One thread per neuron, neighbouring
// threads on neighbouring addresses, no padding: the grid-stride loop masks
// the ragged edge itself. Nothing is staged in shared memory because no
// value is read twice.

#include "neuron.cuh"

__global__ void lif_update_kernel(
    const float* __restrict__ v, const float* __restrict__ i_syn,
    const int32_t* __restrict__ refrac, const float* __restrict__ i_in,
    const uint8_t* __restrict__ alive,
    float* __restrict__ v_out, float* __restrict__ i_out,
    int32_t* __restrict__ refrac_out, uint8_t* __restrict__ spike_out,
    int64_t n, const LifParams p) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t k = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; k < n;
       k += stride) {
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

extern "C" int lif_update_launch(
    const void* v, const void* i_syn, const void* refrac, const void* i_in,
    const void* alive, void* v_out, void* i_out, void* refrac_out,
    void* spike_out, int64_t n, float p11, float p21, float p22, float v_th,
    float v_reset, int t_ref_steps, void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  int64_t blocks = (n + threads - 1) / threads;
  if (blocks > 132 * 64) blocks = 132 * 64;  // grid-stride beyond 64 blocks/SM
  lif_update_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)v, (const float*)i_syn, (const int32_t*)refrac,
      (const float*)i_in, (const uint8_t*)alive, (float*)v_out, (float*)i_out,
      (int32_t*)refrac_out, (uint8_t*)spike_out, n,
      LifParams{p11, p21, p22, v_th, v_reset, (int32_t)t_ref_steps});
  return (int)cudaGetLastError();
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
