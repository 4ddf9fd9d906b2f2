// Device math shared by the neuron kernels: the exact-propagator LIF step
// and the counter-based uniform draw of the external Poisson drive.
//
// Exactness: the JAX reference is jitted, and XLA contracts the propagator
// into exactly two fused multiply-adds:
//     i' = fma(i, p11, i_in)
//     v' = fma(v, p22, round_f32(i * p21))
// The other order, fma(i, p21, v * p22), disagrees in many lanes. The
// intrinsics pin these two FMAs and every source is compiled with
// -fmad=false, so nothing else is contracted. The parameters arrive as f32,
// the rounding JAX applies to its weakly typed Python floats.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

struct LifParams {
  float p11, p21, p22, v_th, v_reset;
  int32_t t_ref_steps;
};

// One step of neuron state (v, i, refrac) under input i_in; returns the spike.
__device__ __forceinline__ bool lif_step(float& v, float& i, int32_t& refrac,
                                         float i_in, bool alive,
                                         const LifParams& p) {
  const bool refractory = refrac > 0;
  const float i_new = __fmaf_rn(i, p.p11, i_in);
  const float v_prop = __fmaf_rn(v, p.p22, __fmul_rn(i, p.p21));
  const float v_new = refractory ? p.v_reset : v_prop;
  const bool spike = (v_new >= p.v_th) && alive && !refractory;
  v = spike ? p.v_reset : v_new;
  i = i_new;
  refrac = spike ? p.t_ref_steps : (refrac > 1 ? refrac - 1 : 0);
  return spike;
}

__device__ __forceinline__ uint32_t splitmix32(uint32_t x) {
  x += 0x9E3779B9u;
  x = (x ^ (x >> 16)) * 0x21F0AAADu;
  x = (x ^ (x >> 15)) * 0x735A2D97u;
  return x ^ (x >> 15);
}

// counter_uniform(seed, t, gid) of repro_torch.core.neuron, with
// seed_mix = splitmix32(seed): uniform [0, 1) f32 from uint32 arithmetic.
__device__ __forceinline__ float counter_uniform(uint32_t seed_mix, uint32_t t,
                                                 uint32_t gid) {
  return __fmul_rn(__uint2float_rn(splitmix32(splitmix32(seed_mix + gid) + t)),
                   0x1p-32f);
}
