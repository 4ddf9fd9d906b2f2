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
// transpose). One CTA per (q-tile, KV head, batch). A q-tile is a run of
// rows of the flattened (q position, head-in-group) space of one KV head, so
// all G query heads of the KV head share each K/V tile staged in shared
// memory, whatever G is (7 for qwen2 does not divide a warp; the tile simply
// spans rows / G positions).
//
// Skipped tiles: a K/V tile that is masked for every row of the CTA (above
// the diagonal, before the window, at or past k_len) is not visited. Once a
// row has seen a valid key its running max m is finite and such a tile adds
// exp(-1e30 - m) = 0; what a masked tile adds before the first valid one is
// multiplied by corr = exp(-1e30 - m_valid) = 0 when a valid key arrives.
// Only a row with no valid key at all depends on the masked tiles; a CTA
// that holds such a row visits every tile. Tiles are visited in key order;
// the CTAs of the latest (heaviest) q-tiles are launched first.
//
// Two routes, chosen by dtype:
//
// * float32: `flash_attention_kernel`, on the f32 CUDA cores. 64-row
//   q-tiles, 64-key tiles, 256 threads as 16 x 16: thread (ty, tx) owns rows
//   4ty..4ty+3 and, for S = QK^T, keys 4tx..4tx+3; for O += PV, output
//   columns tx + 16c. Its floor is the f32 CUDA-core rate (67 TFLOP/s); the
//   tensor cores would round the inputs (TF32 or bf16) and miss the f32 bar.
//
// * bfloat16: `flash_attention_tc`, on the tensor cores (wgmma + TMA,
//   sm_90a). 128-row q-tiles, 384 threads: warpgroups 0 and 1 each own 64
//   rows and compute; one warp of warpgroup 2 loads. setmaxnreg moves the
//   registers to the two computing warpgroups (232 each, 40 for the loader).
//   - Q is loaded once per CTA with 16-byte loads into the 128-byte-swizzled
//     wgmma layout (its rows are not a uniform stride when G < H, so a TMA
//     box does not fit it). K and V tiles of KB keys are loaded by TMA
//     through a 4-D tensor map over [B, Sk, Hkv, Dh] (128-byte swizzle) into
//     a ring of 4 stages with full/empty mbarriers; keys past Sk arrive as
//     zeros and get the logit -inf.
//   - Each computing warpgroup runs a two-step software pipeline: step i
//     issues S_i = Q K_i^T and then O += P_{i-1} V_{i-1}, waits for S_i
//     only, and runs the softmax of S_i while the tensor cores do PV_{i-1}.
//   - S = QK^T: wgmma m64n64k16 from shared memory, f32 accumulators. The
//     mask is applied only on tiles that straddle the diagonal, the window
//     edge, k_len or Sk; the online softmax runs in f32 on the accumulator
//     layout, row max and sum by quad shuffles, in log2 units (the scale is
//     log2(e) * Dh^-0.5) with the special-function unit's ex2.approx: its
//     error, a few f32 ulps, is far under the bf16 bar.
//   - O += PV: the TPU kernel keeps P in f32. A textbook tensor-core kernel
//     rounds P to bf16 once, which puts ~11% of the outputs of this
//     repository's tests outside one bf16 ulp of the f32 result (up to 75
//     ulps; tests/test_torch_flash_attention.py pins it). So P is split into
//     two bf16 terms, P_hi = bf16(P) and P_lo = bf16(P - P_hi), each turned
//     in registers into the A operand of wgmma m64n64k16 (B = V from shared
//     memory, MN-major through the transpose flag), both into the same f32
//     O. The tensor cores then do 1.5x the work the data needs (QK^T once,
//     PV twice).
//   - Head dims: a 128-byte swizzle atom holds 64 bf16 columns, so Dh is
//     laid out in 64-column chunks, padded with zeros (the tensor map's
//     out-of-bounds fill for K and V, the loader for Q): Dh 16 and 32 take
//     one chunk, 80 and 128 two. QK^T runs only the Dh / 16 k-steps that hold
//     data; PV runs the whole 64-column chunks, so Dh 80 does 128/80 of its
//     PV work (16 and 32: 4x and 2x; 64 and 128: none wasted). KB = 128 keys
//     for one chunk, 64 for two (the registers of S and O).
//   - Epilogue: O / max(l, 1e-30), rounded to bf16 once, stored from
//     registers to [B, Sq, H, Dh].
//
// Bound on an H100: operations. The qwen2-0.5b shape (B 2, S 4096, H 14,
// Hkv 2, Dh 64) needs 60.1 GFLOP for ~34 MB of q, k, v and o: 0.0608 ms at
// 989 TFLOP/s bf16. With the split, the tensor cores do ~90 GFLOP, so this
// kernel's own floor is ~0.091 ms. Besides the tensor cores, the softmax
// and the split keep the CUDA cores and the special-function unit busy
// (per thread and 128-key tile: 64 ex2, 64 conversions to bf16). Every CTA
// reads the K/V tiles its rows need from L2 (~0.5 GB per launch at that
// shape); the 4-stage TMA ring hides the latency.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mbarrier.cuh"

namespace {

constexpr float kNeg = -1e30f;
constexpr int kDriverError = 100000;  // error codes above it are CUresults

// cudaFuncSetAttribute is per device: set it once on each device a kernel
// launches on.
template <auto Kernel>
int allow_smem(size_t bytes) {
  constexpr int kMaxDevices = 64;
  static bool done[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (!done[dev]) {
    err = cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)bytes);
    if (err != cudaSuccess) return (int)err;
    done[dev] = true;
  }
  return 0;
}

// ---------------------------------------------------------------------------
// float32: the CUDA-core kernel.

constexpr int kRows = 64;      // (q position, head) rows per CTA
constexpr int kKeys = 64;      // keys per K/V tile
constexpr int kThreads = 256;  // 16 x 16
constexpr int kStride = 68;    // row stride of the transposed tiles: 64 + 4,
                               // 16-byte aligned for float4 loads

template <int DH>
constexpr size_t smem_bytes() {
  // qt [DH][kStride] + kt [DH][kStride] + vs [kKeys][DH] + pt [kKeys][kStride]
  return sizeof(float) * (size_t)(2 * DH * kStride + kKeys * DH + kKeys * kStride);
}

template <int DH>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ o, int sq, int sk,
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
    qt[d * kStride + r] = row < rows_total ? q[row_offset(row) + d] : 0.f;
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
        kx = k[off];
        vx = v[off];
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
    float* out = o + row_offset(row);
#pragma unroll
    for (int c = 0; c < C; ++c) out[tx + 16 * c] = acc[i][c] / denom;
  }
}

template <int DH>
int launch_f32(const void* q, const void* k, const void* v, void* o, int b, int sq, int sk,
               int h, int hkv, int window, int k_len, cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<DH>();
  const int err = allow_smem<flash_attention_kernel<DH>>(bytes);
  if (err) return err;
  const int64_t rows = (int64_t)sq * (h / hkv);
  const dim3 grid((unsigned)((rows + kRows - 1) / kRows), (unsigned)hkv, (unsigned)b);
  flash_attention_kernel<DH><<<grid, kThreads, bytes, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, sq, sk, h, hkv, window,
      k_len, 1.0f / sqrtf((float)DH));
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bfloat16: the tensor-core kernel.

namespace tc {

constexpr int kConsumers = 2;                     // computing warpgroups, 64 rows each
constexpr int kRows = 64 * kConsumers;            // rows per CTA
constexpr int kThreads = 128 * (kConsumers + 1);  // the last warpgroup loads
constexpr int kLoadRegs = 40;                     // setmaxnreg: 2 x 128 x 232 +
constexpr int kComputeRegs = 232;                 // 128 x 40 <= 65,536 registers
constexpr int kStages = 4;     // K/V ring
constexpr int kAtom = 64;      // bf16 columns of one 128-byte swizzle atom
constexpr float kLog2e = 1.4426950408889634f;

template <int DH>
struct Cfg {
  static constexpr int NC = (DH + kAtom - 1) / kAtom;  // 64-column chunks of Dh
  static constexpr int KB = NC == 1 ? 128 : 64;         // keys per tile
  static constexpr int SH = KB / 64;                    // 64-key parts of S
  static constexpr int KS = DH / 16;                    // k-steps of QK^T
  static constexpr uint32_t Q_CHUNK = kRows * 128;      // bytes of one Q chunk
  static constexpr uint32_t KV_CHUNK = KB * 128;        // bytes of one K or V chunk
  static constexpr uint32_t STAGE = 2 * NC * KV_CHUNK;  // K chunks, then V chunks
  static constexpr uint32_t BARS = NC * Q_CHUNK + kStages * STAGE;
  static constexpr size_t SMEM = BARS + 2 * kStages * sizeof(uint64_t) + 1024;  // + alignment
};

// wgmma shared-memory descriptor of a 128-byte-swizzled operand: 8-row
// groups 1024 bytes apart (SBO). LBO is the distance between 64-column
// chunks of an MN-major operand, unused by these n64 products.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo) {
  return (uint64_t)((addr >> 4) & 0x3FFF) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of accumulator registers
// across the asynchronous wgmma.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D[64 x 64] (+)= A[64 x 16] B[16 x 64], A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x 64] += A[64 x 16] B[16 x 64], A from registers, B MN-major in
// shared memory (transpose flag set).
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// 2^x on the special-function unit (-inf and -1e30 give 0, 0 gives 1).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// S = Q K^T for this warpgroup's 64 rows, in 64-key parts (issued, not
// awaited). K-major operands advance 32 bytes per k-step inside a 64-column
// chunk.
template <int DH>
__device__ __forceinline__ void issue_s(float (&sc)[Cfg<DH>::SH][32], uint32_t s_q, int wg,
                                        uint32_t k_base) {
  using C = Cfg<DH>;
#pragma unroll
  for (int ks = 0; ks < C::KS; ++ks) {
    const uint32_t kofs = (ks / 4) * C::KV_CHUNK + (ks % 4) * 32;
    const uint64_t da =
        desc_sw128(s_q + (ks / 4) * C::Q_CHUNK + wg * 64 * 128 + (ks % 4) * 32, 16);
#pragma unroll
    for (int hh = 0; hh < C::SH; ++hh)
      wgmma_ss(sc[hh], da, desc_sw128(k_base + kofs + hh * 64 * 128, 16), ks > 0);
  }
}

// O += P_hi V + P_lo V (issued, not awaited); V's rows are keys, 16 keys
// = 2048 bytes.
template <int DH>
__device__ __forceinline__ void issue_pv(float (&acc)[Cfg<DH>::NC][32],
                                         const uint32_t (&p_hi)[Cfg<DH>::KB / 16][4],
                                         const uint32_t (&p_lo)[Cfg<DH>::KB / 16][4],
                                         uint32_t v_base) {
  using C = Cfg<DH>;
#pragma unroll
  for (int c = 0; c < C::NC; ++c)
#pragma unroll
    for (int kk = 0; kk < C::KB / 16; ++kk) {
      const uint64_t dv = desc_sw128(v_base + c * C::KV_CHUNK + kk * 2048, 1024);
      wgmma_rs(acc[c], p_hi[kk], dv);
      wgmma_rs(acc[c], p_lo[kk], dv);
    }
}

// The rows' state of the online softmax: this thread's two rows (gq and
// gq + 8 of its warp), their running max and their share of l.
struct Rows {
  int pa, pb, cq;
  float m_a = kNeg, m_b = kNeg, l_a = 0.f, l_b = 0.f;
};

// Logits in log2 units, the mask only where the tile needs it, and the
// online softmax over the quad that shares a row: S becomes P in place, and
// corr is what O must be multiplied by. Element j of part hh: row gq (+8 for
// j % 4 >= 2), key 64 hh + 8 (j / 4) + 2 cq + j % 2.
template <int SH>
__device__ __forceinline__ void softmax(float (&sc)[SH][32], Rows& r, bool inside, int k0,
                                        int window, int k_len, int sk, float scale_log2,
                                        float& corr_a, float& corr_b) {
  if (inside) {
#pragma unroll
    for (int hh = 0; hh < SH; ++hh)
#pragma unroll
      for (int j = 0; j < 32; ++j) sc[hh][j] *= scale_log2;
  } else {
#pragma unroll
    for (int hh = 0; hh < SH; ++hh)
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int kpos = k0 + hh * 64 + (j / 4) * 8 + 2 * r.cq + (j % 2);
        const int d = ((j % 4) < 2 ? r.pa : r.pb) - kpos;
        const bool valid = d >= 0 && (window <= 0 || d < window) && kpos < k_len;
        sc[hh][j] = kpos >= sk ? -INFINITY : (valid ? sc[hh][j] * scale_log2 : kNeg);
      }
  }
  float mx_a = kNeg, mx_b = kNeg;
#pragma unroll
  for (int hh = 0; hh < SH; ++hh)
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      if ((j % 4) < 2) mx_a = fmaxf(mx_a, sc[hh][j]);
      else mx_b = fmaxf(mx_b, sc[hh][j]);
    }
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
    mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
  }
  const float mn_a = fmaxf(r.m_a, mx_a), mn_b = fmaxf(r.m_b, mx_b);
  corr_a = ex2(r.m_a - mn_a);
  corr_b = ex2(r.m_b - mn_b);
  r.m_a = mn_a;
  r.m_b = mn_b;
  float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
  for (int hh = 0; hh < SH; ++hh)
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const bool row_a = (j % 4) < 2;
      const float p = ex2(sc[hh][j] - (row_a ? mn_a : mn_b));
      sc[hh][j] = p;
      if (row_a) sum_a += p;
      else sum_b += p;
    }
  r.l_a = r.l_a * corr_a + sum_a;
  r.l_b = r.l_b * corr_b + sum_b;
}

// P = P_hi + P_lo, two bf16 A fragments per 16 keys: the accumulator layout
// of keys 16kk.. is the A-operand layout of that k-step.
template <int SH>
__device__ __forceinline__ void split_p(const float (&sc)[SH][32], uint32_t (&p_hi)[SH * 4][4],
                                        uint32_t (&p_lo)[SH * 4][4]) {
#pragma unroll
  for (int kk = 0; kk < SH * 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float x0 = sc[kk / 4][(kk % 4) * 8 + 2 * r];
      const float x1 = sc[kk / 4][(kk % 4) * 8 + 2 * r + 1];
      const __nv_bfloat162 hi = __floats2bfloat162_rn(x0, x1);
      const float2 hf = __bfloat1622float2(hi);
      p_hi[kk][r] = bits(hi);
      p_lo[kk][r] = bits(__floats2bfloat162_rn(x0 - hf.x, x1 - hf.y));
    }
}

template <int NC>
__device__ __forceinline__ void rescale(float (&acc)[NC][32], float corr_a, float corr_b) {
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int j = 0; j < 32; ++j) acc[c][j] *= (j % 4) < 2 ? corr_a : corr_b;
}

template <int DH>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_tc(const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v,
                   const __nv_bfloat16* __restrict__ q, __nv_bfloat16* __restrict__ o, int sq,
                   int sk, int h, int hkv, int window, int k_len, float scale_log2) {
  using C = Cfg<DH>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  uint8_t* smem = smem_raw + (((raw + 1023u) & ~1023u) - raw);  // swizzle atoms: 1024-aligned
  const uint32_t s_q = smem_u32(smem);                         // Q chunks [128 rows][64]
  const uint32_t s_kv = s_q + C::NC * C::Q_CHUNK;              // stages
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::BARS);
  uint64_t* empty = full + kStages;

  const int g = h / hkv;
  const int64_t rows_total = (int64_t)sq * g;
  const int64_t row0 = ((int64_t)gridDim.x - 1 - blockIdx.x) * kRows;  // heaviest first
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int kl = min(k_len, sk);
  // The valid keys [lo, hi] of a row grow with its position, and a row with
  // none (lo > hi) lies above every row that has some: the CTA's tile range
  // follows from its first and last positions.
  auto lo_of = [&](int p) { return window > 0 ? max(0, p - window + 1) : 0; };
  auto hi_of = [&](int p) { return min(p, kl - 1); };
  const int p_first = (int)(row0 / g);
  const int64_t row_end = row0 + kRows < rows_total ? row0 + kRows : rows_total;
  const int p_last = (int)((row_end - 1) / g);
  const bool any_empty = lo_of(p_last) > hi_of(p_last);
  const int t_begin = any_empty ? 0 : lo_of(p_first) / C::KB;
  const int t_end = any_empty ? (sk + C::KB - 1) / C::KB : hi_of(p_last) / C::KB + 1;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 128 * kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    // The loader: one thread keeps the ring full.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kLoadRegs) : "memory");
    if (threadIdx.x == 128 * kConsumers) {
      for (int t = t_begin, i = 0; t < t_end; ++t, ++i) {
        const int s = i % kStages;
        mbar_wait(&empty[s], ((i / kStages) & 1) ^ 1);
        mbar_expect_tx(&full[s], C::STAGE);
        const uint32_t dst = s_kv + s * C::STAGE;
#pragma unroll
        for (int c = 0; c < C::NC; ++c) {
          tma_load_4d(dst + c * C::KV_CHUNK, &tm_k, &full[s], c * kAtom, kvh, t * C::KB, b);
          tma_load_4d(dst + (C::NC + c) * C::KV_CHUNK, &tm_v, &full[s], c * kAtom, kvh,
                      t * C::KB, b);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kComputeRegs) : "memory");
    const int tid = threadIdx.x & 127, warp = tid / 32, lane = tid & 31;
    const int gq = lane / 4, cq = lane % 4;  // accumulator row (and +8), column pair
    const int64_t wrow0 = row0 + wg * 64;

    // Q: this warpgroup's 64 rows, 16 bytes a thread, swizzled; zeros past
    // Dh and past the last row.
    for (int i = tid; i < 64 * C::NC * 8; i += 128) {
      const int r = i / (C::NC * 8), ch = i % (C::NC * 8);
      const int64_t row = wrow0 + r;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (ch * 8 < DH && row < rows_total) {
        const int64_t pos = row / g, head = (int64_t)kvh * g + row % g;
        val = *reinterpret_cast<const uint4*>(q + ((int64_t)b * sq + pos) * h * DH +
                                              head * DH + ch * 8);
      }
      const int rc = wg * 64 + r;
      *reinterpret_cast<uint4*>(smem + (ch / 8) * C::Q_CHUNK + rc * 128 +
                                (((ch % 8) ^ (rc % 8)) * 16)) = val;
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // visible to wgmma
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");

    // This thread's two rows, and the warpgroup's position range: a tile
    // wholly inside every row's valid keys needs no mask.
    const int64_t ra = wrow0 + warp * 16 + gq, rb = ra + 8;
    Rows rows;
    rows.pa = (int)(ra / g);
    rows.pb = (int)(rb / g);
    rows.cq = cq;
    const int64_t wrow_last = wrow0 + 63 < rows_total ? wrow0 + 63 : rows_total - 1;
    const bool has_rows = wrow0 <= wrow_last;
    const int hi_min = min((int)(wrow0 / g), kl - 1);
    const int lo_max = (int)(wrow_last / g) - window + 1;

    float acc[C::NC][32];
#pragma unroll
    for (int c = 0; c < C::NC; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[c][i] = 0.f;

    // Software pipeline: step i issues S_i = Q K_i^T and then O += P_{i-1}
    // V_{i-1}, waits for S_i only, and runs the softmax of S_i while the
    // tensor cores do PV_{i-1}. Stage i - 1 is released once PV_{i-1} is in.
    // The first S and the last PV are peeled off, so that no branch inside
    // the loop decides which products are in flight.
    float sc[C::SH][32];
    uint32_t p_hi[C::KB / 16][4], p_lo[C::KB / 16][4];
    float corr_a, corr_b;
    auto inside = [&](int k0) {  // the tile lies inside every row's valid keys
      return has_rows && k0 + C::KB - 1 <= hi_min && (window <= 0 || k0 >= lo_max);
    };
    const int n = t_end - t_begin;
    if (n > 0) {
      mbar_wait(&full[0], 0);
      wgmma_fence();
      issue_s<DH>(sc, s_q, wg, s_kv);
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int hh = 0; hh < C::SH; ++hh) fence_regs(sc[hh]);
      const int k0 = t_begin * C::KB;
      softmax(sc, rows, inside(k0), k0, window, k_len, sk, scale_log2, corr_a, corr_b);
      split_p(sc, p_hi, p_lo);
    }
    for (int i = 1; i < n; ++i) {
      const int s = i % kStages, s_prev = (i - 1) % kStages;
      const int k0 = (t_begin + i) * C::KB;
      mbar_wait(&full[s], (i / kStages) & 1);
#pragma unroll
      for (int hh = 0; hh < C::SH; ++hh) fence_regs(sc[hh]);
#pragma unroll
      for (int c = 0; c < C::NC; ++c) fence_regs(acc[c]);
      wgmma_fence();
      issue_s<DH>(sc, s_q, wg, s_kv + s * C::STAGE);
      wgmma_commit();
      issue_pv<DH>(acc, p_hi, p_lo, s_kv + s_prev * C::STAGE + C::NC * C::KV_CHUNK);
      wgmma_commit();
      wgmma_wait<1>();  // S_i is in
#pragma unroll
      for (int hh = 0; hh < C::SH; ++hh) fence_regs(sc[hh]);
      softmax(sc, rows, inside(k0), k0, window, k_len, sk, scale_log2, corr_a, corr_b);
      wgmma_wait<0>();  // PV_{i-1} is in: O and the P fragments are free
#pragma unroll
      for (int c = 0; c < C::NC; ++c) fence_regs(acc[c]);
      mbar_arrive(&empty[s_prev]);
      rescale(acc, corr_a, corr_b);
      split_p(sc, p_hi, p_lo);
    }
    if (n > 0) {
      const int s_last = (n - 1) % kStages;
#pragma unroll
      for (int c = 0; c < C::NC; ++c) fence_regs(acc[c]);
      wgmma_fence();
      issue_pv<DH>(acc, p_hi, p_lo, s_kv + s_last * C::STAGE + C::NC * C::KV_CHUNK);
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int c = 0; c < C::NC; ++c) fence_regs(acc[c]);
      mbar_arrive(&empty[s_last]);
    }

    // Epilogue: the row's l over its quad; O / max(l, 1e-30) as bf16.
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      rows.l_a += __shfl_xor_sync(0xffffffffu, rows.l_a, off);
      rows.l_b += __shfl_xor_sync(0xffffffffu, rows.l_b, off);
    }
    const float den_a = fmaxf(rows.l_a, 1e-30f), den_b = fmaxf(rows.l_b, 1e-30f);
    auto out_row = [&](int64_t row) {
      const int64_t pos = row / g, head = (int64_t)kvh * g + row % g;
      return o + ((int64_t)b * sq + pos) * h * DH + head * DH;
    };
    __nv_bfloat16* out_a = out_row(ra);
    __nv_bfloat16* out_b = out_row(rb);
#pragma unroll
    for (int c = 0; c < C::NC; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = c * kAtom + j * 8 + 2 * cq;
        if (col >= DH) continue;
        if (ra < rows_total)
          *reinterpret_cast<__nv_bfloat162*>(out_a + col) =
              __floats2bfloat162_rn(acc[c][4 * j] / den_a, acc[c][4 * j + 1] / den_a);
        if (rb < rows_total)
          *reinterpret_cast<__nv_bfloat162*>(out_b + col) =
              __floats2bfloat162_rn(acc[c][4 * j + 2] / den_b, acc[c][4 * j + 3] / den_b);
      }
  }
}

// A 4-D tensor map over k or v [B, Sk, Hkv, Dh] (innermost first), boxes of
// 64 columns x 1 head x KB keys x 1 batch, 128-byte swizzle, zero fill.
int tensor_map(CUtensorMap* map, const void* ptr, int b, int sk, int hkv, int dh, int kb) {
  const cuuint64_t dims[4] = {(cuuint64_t)dh, (cuuint64_t)hkv, (cuuint64_t)sk, (cuuint64_t)b};
  const cuuint64_t strides[3] = {(cuuint64_t)dh * 2, (cuuint64_t)hkv * dh * 2,
                                 (cuuint64_t)sk * hkv * dh * 2};
  const cuuint32_t box[4] = {(cuuint32_t)kAtom, 1, (cuuint32_t)kb, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = cuTensorMapEncodeTiled(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides, box,
      unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kDriverError + (int)r;
}

template <int DH>
int launch(const void* q, const void* k, const void* v, void* o, int b, int sq, int sk, int h,
           int hkv, int window, int k_len, cudaStream_t stream) {
  using C = Cfg<DH>;
  int err = allow_smem<flash_attention_tc<DH>>(C::SMEM);
  if (err) return err;
  CUtensorMap tm_k, tm_v;
  if ((err = tensor_map(&tm_k, k, b, sk, hkv, DH, C::KB))) return err;
  if ((err = tensor_map(&tm_v, v, b, sk, hkv, DH, C::KB))) return err;
  const int64_t rows = (int64_t)sq * (h / hkv);
  const dim3 grid((unsigned)((rows + kRows - 1) / kRows), (unsigned)hkv, (unsigned)b);
  flash_attention_tc<DH><<<grid, kThreads, C::SMEM, stream>>>(
      tm_k, tm_v, (const __nv_bfloat16*)q, (__nv_bfloat16*)o, sq, sk, h, hkv, window, k_len,
      kLog2e / sqrtf((float)DH));
  return (int)cudaGetLastError();
}

}  // namespace tc

}  // namespace

// dtype: 0 = float32 (CUDA cores), 1 = bfloat16 (tensor cores). Returns a
// cudaError_t (0 = launched), or kDriverError + a CUresult.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, int dtype, int b, int sq,
    int sk, int h, int hkv, int dh, int window, int k_len, void* stream) {
  if (b <= 0 || sq <= 0 || sk <= 0) return 0;
  if (hkv <= 0 || h % hkv != 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    switch (dh) {
      case 16: return launch_f32<16>(q, k, v, o, b, sq, sk, h, hkv, window, k_len, s);
      case 32: return launch_f32<32>(q, k, v, o, b, sq, sk, h, hkv, window, k_len, s);
      case 64: return launch_f32<64>(q, k, v, o, b, sq, sk, h, hkv, window, k_len, s);
      case 80: return launch_f32<80>(q, k, v, o, b, sq, sk, h, hkv, window, k_len, s);
      case 128: return launch_f32<128>(q, k, v, o, b, sq, sk, h, hkv, window, k_len, s);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  // TMA and the 16-byte Q loads need 16-byte aligned bases.
  if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)o) % 16)
    return (int)cudaErrorMisalignedAddress;
  switch (dh) {
    case 16: return tc::launch<16>(q, k, v, o, b, sq, sk, h, hkv, window, k_len, s);
    case 32: return tc::launch<32>(q, k, v, o, b, sq, sk, h, hkv, window, k_len, s);
    case 64: return tc::launch<64>(q, k, v, o, b, sq, sk, h, hkv, window, k_len, s);
    case 80: return tc::launch<80>(q, k, v, o, b, sq, sk, h, hkv, window, k_len, s);
    case 128: return tc::launch<128>(q, k, v, o, b, sq, sk, h, hkv, window, k_len, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Dynamic shared memory of one CTA of the route for dtype and dh (0: none).
extern "C" int flash_attention_smem_bytes(int dtype, int dh) {
  switch (dtype * 1000 + dh) {
    case 16: return (int)smem_bytes<16>();
    case 32: return (int)smem_bytes<32>();
    case 64: return (int)smem_bytes<64>();
    case 80: return (int)smem_bytes<80>();
    case 128: return (int)smem_bytes<128>();
    case 1016: return (int)tc::Cfg<16>::SMEM;
    case 1032: return (int)tc::Cfg<32>::SMEM;
    case 1064: return (int)tc::Cfg<64>::SMEM;
    case 1080: return (int)tc::Cfg<80>::SMEM;
    case 1128: return (int)tc::Cfg<128>::SMEM;
    default: return 0;
  }
}

extern "C" const char* error_string(int err) {
  if (err >= kDriverError) {
    const char* msg = nullptr;
    cuGetErrorString((CUresult)(err - kDriverError), &msg);
    return msg ? msg : "unknown CUDA driver error";
  }
  return cudaGetErrorString((cudaError_t)err);
}
