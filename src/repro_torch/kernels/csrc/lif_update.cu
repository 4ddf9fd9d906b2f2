// One exact-propagator iaf_psc_exp step over flat [N] neuron state.
//
// Replaces the Pallas TPU kernel `lif_update_pallas`
// (src/repro/kernels/lif_update.py, body `lif_step_math`).
//
// Exactness: the JAX reference is jitted, and XLA contracts the propagator
// into exactly two fused multiply-adds:
//     i' = fma(i, p11, i_in)
//     v' = fma(v, p22, round_f32(i * p21))
// The other order, fma(i, p21, v * p22), disagrees in many lanes. The
// intrinsics pin these two FMAs and this file is compiled with
// -fmad=false, so nothing else is contracted. The parameters arrive as f32,
// the rounding JAX applies to its weakly typed Python floats.
//
// Bound on an H100: memory. Per neuron it reads v, i (f32), refrac (i32),
// i_in (f32), alive (1 B) and writes v, i, refrac and the spike byte:
// 30 B/neuron, a handful of flops. One thread per neuron, neighbouring
// threads on neighbouring addresses, no padding: the grid-stride loop masks
// the ragged edge itself. Nothing is staged in shared memory because no
// value is read twice.

#include <cuda_runtime.h>
#include <stdint.h>

__global__ void lif_update_kernel(
    const float* __restrict__ v, const float* __restrict__ i_syn,
    const int32_t* __restrict__ refrac, const float* __restrict__ i_in,
    const uint8_t* __restrict__ alive,
    float* __restrict__ v_out, float* __restrict__ i_out,
    int32_t* __restrict__ refrac_out, uint8_t* __restrict__ spike_out,
    int64_t n, float p11, float p21, float p22, float v_th, float v_reset,
    int32_t t_ref_steps) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t k = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; k < n;
       k += stride) {
    const float vk = v[k];
    const float ik = i_syn[k];
    const int32_t rk = refrac[k];
    const bool refractory = rk > 0;
    const float i_new = __fmaf_rn(ik, p11, i_in[k]);
    const float v_prop = __fmaf_rn(vk, p22, __fmul_rn(ik, p21));
    const float v_new = refractory ? v_reset : v_prop;
    const bool spike = (v_new >= v_th) && (alive[k] != 0) && !refractory;
    v_out[k] = spike ? v_reset : v_new;
    i_out[k] = i_new;
    refrac_out[k] = spike ? t_ref_steps : (rk > 1 ? rk - 1 : 0);
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
      (int32_t*)refrac_out, (uint8_t*)spike_out, n, p11, p21, p22, v_th,
      v_reset, (int32_t)t_ref_steps);
  return (int)cudaGetLastError();
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
