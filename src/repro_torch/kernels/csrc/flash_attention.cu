// Causal (optionally sliding-window) GQA attention with an online softmax.
//
// Replaces the Pallas TPU kernel `flash_attention_pallas`
// (src/repro/kernels/flash_attention.py, body `_kernel`).
//
// Semantics, as the TPU kernel: q [B, Sq, H, Dh], k and v [B, Sk, Hkv, Dh],
// head h reads KV head h / G (G = H / Hkv); a key is valid for a query when
// d = q_pos - k_pos >= 0, (window <= 0 or d < window) and k_pos < k_len.
// Logits are dot(q, k) * Dh^-0.5 in f32, masked ones are set to -1e30, the
// running max starts at -1e30, and the output is acc / max(l, 1e-30) cast
// to q's dtype. A row with no valid key therefore gets the mean of v over
// all Sk keys, as the TPU kernel computes it.
//
// Layout: q, k and v are read where they lie (no [B, Hkv, G, S, Dh]
// transpose). One CTA per (q-tile, KV head, batch). A q-tile is 64 rows of
// the flattened (q position, head-in-group) space of one KV head, so all G
// query heads of the KV head share each K/V tile staged in shared memory,
// whatever G is (7 for qwen2 does not divide a warp; the tile simply spans
// ~64/G positions). 256 threads as 16 x 16: thread (ty, tx) owns rows
// 4ty..4ty+3 and, for S = QK^T, keys 4tx..4tx+3 of the 64-key tile; for
// O += PV, output columns tx + 16c (c < Dh/16, so Dh = 80 needs no power
// of two). The f32 accumulator of a row is thus spread over the 16 threads
// of a half-warp; the row max and sum are reduced with shuffles among them.
//
// Skipped tiles: a K/V tile that is masked for every row of the CTA (above
// the diagonal, before the window, at or past k_len) is not visited. Once a
// row has seen a valid key its running max m is finite and such a tile adds
// exp(-1e30 - m) = 0; what a masked tile adds before the first valid one is
// multiplied by corr = exp(-1e30 - m_valid) = 0 when a valid key arrives.
// Only a row with no valid key at all depends on the masked tiles; a CTA
// that holds such a row visits every tile.
//
// Bound on an H100: operations. The qwen2-0.5b shape (B 2, S 4096, H 14,
// Dh 64) needs ~60 GFLOP for ~34 MB of q, k, v and o. This first version
// runs on the f32 CUDA cores (no mma / wgmma, no TMA): per 64 x 64 tile a
// thread does 16 x Dh FMAs for S and 16 x Dh for PV from register
// micro-tiles fed by 16-byte shared-memory loads, so its floor is the f32
// CUDA-core rate (~0.9 ms for that shape), not the bf16 tensor-core one.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 64;      // (q position, head) rows per CTA
constexpr int kKeys = 64;      // keys per K/V tile
constexpr int kThreads = 256;  // 16 x 16
constexpr int kStride = 68;    // row stride of the transposed tiles: 64 + 4,
                               // 16-byte aligned for float4 loads
constexpr float kNeg = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

template <int DH>
constexpr size_t smem_bytes() {
  // qt [DH][kStride] + kt [DH][kStride] + vs [kKeys][DH] + pt [kKeys][kStride]
  return sizeof(float) * (size_t)(2 * DH * kStride + kKeys * DH + kKeys * kStride);
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int sq, int sk,
                       int h, int hkv, int window, int k_len, float scale) {
  constexpr int C = DH / 16;  // output columns per thread
  extern __shared__ float4 smem4[];
  float* qt = reinterpret_cast<float*>(smem4);  // [DH][kStride], q transposed
  float* kt = qt + DH * kStride;                // [DH][kStride], k transposed
  float* vs = kt + DH * kStride;                // [kKeys][DH]
  float* pt = vs + kKeys * DH;                  // [kKeys][kStride], p transposed
  __shared__ int s_lo, s_hi, s_empty;

  const int g = h / hkv;
  const int64_t rows_total = (int64_t)sq * g;
  const int64_t tile = (int64_t)gridDim.x - 1 - blockIdx.x;  // latest (heaviest) first
  const int64_t row0 = tile * kRows;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;

  // Element offset of row r of this tile in q / o: (b, q_pos, head, 0).
  auto row_offset = [&](int64_t row) {
    const int64_t pos = row / g, head = (int64_t)kvh * g + row % g;
    return ((int64_t)b * sq + pos) * h * DH + head * DH;
  };

  if (tid == 0) {
    s_lo = 0x7fffffff;
    s_hi = -1;
    s_empty = 0;
  }
  for (int i = tid; i < kRows * DH; i += kThreads) {
    const int r = i / DH, d = i % DH;
    const int64_t row = row0 + r;
    qt[d * kStride + r] = row < rows_total ? to_f32(q[row_offset(row) + d]) : 0.f;
  }
  __syncthreads();
  if (tid < kRows && row0 + tid < rows_total) {
    // Valid keys of this row: [lo, hi].
    const int pos = (int)((row0 + tid) / g);
    const int hi = min(pos, min(k_len, sk) - 1);
    const int lo = window > 0 ? max(0, pos - window + 1) : 0;
    if (lo > hi) {
      atomicOr(&s_empty, 1);
    } else {
      atomicMin(&s_lo, lo);
      atomicMax(&s_hi, hi);
    }
  }
  __syncthreads();
  const int n_key_tiles = (sk + kKeys - 1) / kKeys;
  const int t_begin = s_empty ? 0 : s_lo / kKeys;
  const int t_end = s_empty ? n_key_tiles : s_hi / kKeys + 1;

  float m[4], l[4], acc[4][C];
  int pos[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
    pos[i] = (int)((row0 + 4 * ty + i) / g);
#pragma unroll
    for (int c = 0; c < C; ++c) acc[i][c] = 0.f;
  }

  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * kKeys;
    for (int i = tid; i < kKeys * DH; i += kThreads) {
      const int j = i / DH, d = i % DH;
      float kx = 0.f, vx = 0.f;
      if (k0 + j < sk) {
        const int64_t off = (((int64_t)b * sk + k0 + j) * hkv + kvh) * DH + d;
        kx = to_f32(k[off]);
        vx = to_f32(v[off]);
      }
      kt[d * kStride + j] = kx;
      vs[j * DH + d] = vx;
    }
    __syncthreads();

    // S = Q K^T for rows 4ty.. and keys 4tx.. of the tile.
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DH; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(qt + d * kStride + 4 * ty);
      const float4 bk = *reinterpret_cast<const float4*>(kt + d * kStride + 4 * tx);
      const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {bk.x, bk.y, bk.z, bk.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
    }

    // Mask, online softmax; p goes to shared memory for PV.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = kNeg;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + 4 * tx + j;
        const int d = pos[i] - kpos;
        const bool valid = d >= 0 && (window <= 0 || d < window) && kpos < k_len;
        // A key past Sk does not exist: it must add nothing even to a row
        // with no valid key, so it gets -inf (p = 0), not -1e30 (p = 1).
        s[i][j] = kpos >= sk ? -INFINITY : (valid ? s[i][j] * scale : kNeg);
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        pt[(4 * tx + j) * kStride + 4 * ty + i] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < C; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

    // O += P V for rows 4ty.. and columns tx + 16c.
#pragma unroll 4
    for (int j = 0; j < kKeys; ++j) {
      const float4 p = *reinterpret_cast<const float4*>(pt + j * kStride + 4 * ty);
      const float pv[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float vx = vs[j * DH + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(pv[i], vx, acc[i][c]);
      }
    }
    __syncthreads();  // the next tile overwrites kt, vs and pt
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t row = row0 + 4 * ty + i;
    if (row >= rows_total) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* out = o + row_offset(row);
#pragma unroll
    for (int c = 0; c < C; ++c) store(out + tx + 16 * c, acc[i][c] / denom);
  }
}

template <typename T, int DH>
int launch(const void* q, const void* k, const void* v, void* o, int b, int sq, int sk,
           int h, int hkv, int window, int k_len, cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<DH>();
  static bool attribute_set = false;
  if (!attribute_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (err != cudaSuccess) return (int)err;
    attribute_set = true;
  }
  const int64_t rows = (int64_t)sq * (h / hkv);
  const dim3 grid((unsigned)((rows + kRows - 1) / kRows), (unsigned)hkv, (unsigned)b);
  flash_attention_kernel<T, DH><<<grid, kThreads, bytes, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, sq, sk, h, hkv, window, k_len,
      1.0f / sqrtf((float)DH));
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dh(const void* q, const void* k, const void* v, void* o, int b, int sq, int sk,
              int h, int hkv, int dh, int window, int k_len, cudaStream_t stream) {
  switch (dh) {
    case 16: return launch<T, 16>(q, k, v, o, b, sq, sk, h, hkv, window, k_len, stream);
    case 32: return launch<T, 32>(q, k, v, o, b, sq, sk, h, hkv, window, k_len, stream);
    case 64: return launch<T, 64>(q, k, v, o, b, sq, sk, h, hkv, window, k_len, stream);
    case 80: return launch<T, 80>(q, k, v, o, b, sq, sk, h, hkv, window, k_len, stream);
    case 128: return launch<T, 128>(q, k, v, o, b, sq, sk, h, hkv, window, k_len, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 = launched).
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, int dtype, int b, int sq,
    int sk, int h, int hkv, int dh, int window, int k_len, void* stream) {
  if (b <= 0 || sq <= 0 || sk <= 0) return 0;
  if (hkv <= 0 || h % hkv != 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return launch_dh<float>(q, k, v, o, b, sq, sk, h, hkv, dh, window, k_len, s);
  if (dtype == 1)
    return launch_dh<__nv_bfloat16>(q, k, v, o, b, sq, sk, h, hkv, dh, window, k_len, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
