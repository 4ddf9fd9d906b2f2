// Event-driven delivery: scatter the outgoing synapses of fired-source id
// packets straight into the ring,
//     ring[off(r) + tgt[row, k], (t0 + step(r) + d[row, k]) % R] += w[row, k]
// for every packet entry (r, i) whose id is a real source (row = its table
// row) and every k whose target is real. Packets are [rows, S] int32: one row
// per cycle of a window (inter pathway: global ids, off = 0, step = r) or one
// row per area (intra pathway: ids within the area, row = r * area_rows + id,
// off = r * area_rows, step = 0).
//
// Replaces the JAX package's event scatter `event_deliver_block`
// (src/repro/kernels/ops.py), plain jnp with no Pallas kernel. That version
// has static shapes: it gathers and scatters every entry of the s_max-sized
// packets (at the paper's per-area size ~88% of them padding) and
// neutralizes padding ids and -1 table entries by adding +0.0 into ring row
// 0. As atomics those adds would queue on a handful of addresses. This kernel
// skips them instead: rings never hold -0.0, so a skipped +0.0 add is
// bitwise the same.
//
// Precondition: every outgoing row is ascending as unsigned 32-bit values,
// i.e. its real targets ascend and its -1 padding sits at the end. The
// port's build (`build_network(outgoing=True)`, `add_outgoing_tables`) gives
// that by construction, in the JAX package's stable-argsort order, and
// `network_from_numpy` refuses outgoing tables that break it. The kernel
// relies on it: a row's targets within any range of ring rows form one
// contiguous segment of the row.
//
// Bound on an H100: each delivered synapse is one f32 reduction (RED) into
// the ring, an [N, R] f32 array several times the 50 MB L2 at the paper's
// size (229 MB). Reductions into random rows of the whole ring miss the L2,
// and each miss is a read-modify-write of DRAM: at ~70 Hz (~16 adds per
// 32-byte sector a window) the DRAM moved each sector once per add. So the
// kernel has two regimes, chosen on the device from a sample of the packet
// (the same in every block): the real entries times K_out against the
// ring's 32-byte sectors.
//
// Dense packets (from 1 add a sector, 1/4 for per-area packets; see
// kDenseEighthsCycles) are sliced: the ring's
// rows are cut into slices of 1/kL2Share of the L2 (cudaDevAttrL2CacheSize;
// on an H100 a quarter beat a half, an eighth and a sixteenth), and the
// work is handed out slice-major by an atomic ticket over (slice, chunk of
// kChunk packet entries, part), kWarps tickets a block at a time (one
// atomic a round, since every block contends for the counter). No more
// blocks take part than hold two slices' tickets, so the adds in flight
// stay within about two slices, whose sectors stay in the L2 while they
// receive their adds: each is fetched from and written back to DRAM about
// once per launch. The bound is then the tables' bytes and the touched
// sectors once, or the L2's rate of reductions, whichever is larger.
// Four lanes serve one (entry, slice) segment, so a warp serves the 8
// entries of its ticket at once; each lane reads one 32-byte sector of the
// row's targets (8 of them, with their weights and delays) a step, the next
// step's loads in flight while it reduces, the 4 lanes of a group a 128-byte
// line. `wpe` warps (1-8) split a segment in interleaved steps, the fewest
// that give a slice's real segments half the regime's warps. A padding
// entry costs its group one load of its id per slice. A segment starts where
// the previous slice's segment of the same entry ended: the group that finds
// that end leaves the position in a per-entry cursor in scratch; a group
// whose cursor is not the row's first position at or above the slice (the
// previous slice's group has not got there yet, or it is left from an
// earlier launch) finds the start by a 32-way search of the row. A
// segment ends at the first target at or above the slice (padding -1 is the
// largest unsigned value). The vector loads need tgt and w 32-byte aligned
// and d 8-byte (int8) or 32-byte (int32) aligned; the wrapper checks. The
// step that crosses the end of the tables is read element by element.
//
// Sparse packets (the paper's 2.5 Hz) put about one add on a touched
// sector, and slicing has nothing to keep in the L2: warps stream whole rows
// (`deliver_unsliced`). Both regimes stream the tables with `__ldcs`, and
// their `atomicAdd`s, whose result is unused, compile to fire-and-forget
// reductions (RED). A development build may force either regime
// (-DEVENT_DELIVER_REGIME=1 sliced, 2 unsliced), so that both can be timed
// on one packet; chip_smoke.py does that to place kDenseEighths*.
//
// Order of the adds: atomics add in no fixed order. The sum is exact all the
// same, because weights lie on the 1/256 grid and every partial sum stays
// far below 2^15 in magnitude, so each f32 add is exact.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#ifndef EVENT_DELIVER_REGIME
#define EVENT_DELIVER_REGIME 0  // 0: chosen per packet; 1: sliced; 2: unsliced
#endif

constexpr int kThreads = 256;            // threads per block
// Blocks an SM at the least (80 registers a thread): the unsliced walk is
// latency-bound and needs the warps; at 87 registers, two blocks an SM,
// it took 37% longer at 2.5 Hz on an H100.
constexpr int kMinBlocks = 3;
constexpr int kWarps = kThreads / 32;
constexpr int kGroup = 4;                // lanes per packet entry
constexpr int kChunk = 32 / kGroup;      // packet entries per ticket
constexpr int kVec = 8;                  // positions a lane reads a step
constexpr int kStep = kGroup * kVec;     // positions a group reads a step
constexpr int kL2Share = 4;              // a slice's ring bytes: 1/kL2Share of the L2
constexpr int kSample = 1024;            // packet entries a block reads to judge the packet
constexpr int kSectorFloats = 8;         // ring values in a 32-byte sector
// Adds a ring sector, in eighths, from which a packet is sliced: where the
// two regimes cross on an H100 (chip_smoke.py's regime lines), ~0.95 adds
// for per-cycle packets, whose entries reach every slice, and ~0.3 for
// per-area ones, whose entries reach only their area's slices, so that
// slicing costs them less.
constexpr int kDenseEighthsCycles = 8;
constexpr int kDenseEighthsAreas = 2;
constexpr unsigned kFull = 0xffffffffu;

struct Work {
  const int32_t* ids;
  const int32_t* tgt;
  const float* w;
  const void* d;
  float* ring;
  // [0]: ticket counter; [1]: sliced blocks done; [2 + e]: entry e's
  // cursor. Kept between launches: the counters start and end at zero.
  unsigned long long* scratch;
  int64_t n_entries, rows, n_src, n_tgt, area_rows;
  int64_t n_elems;           // elements of each table: its rows times k
  int64_t n_rows, slice_rows, n_slices;
  int64_t chunks_per_slice;  // sliced: the packet chunks a slice visits
  int64_t segments;          // sliced: the slices an entry's targets reach, at most
  int s_max, k, ring_len, t0_mod;
  // EVENT_DELIVER_REGIME, read at run time: a forced build compiles both
  // regimes, with the registers and occupancy of the production build.
  int regime;
};

// Packet entry e's source `id`: its table row, the offset of its targets'
// ring rows, and its cycle within the window.
struct Source {
  int64_t row, off;
  int step;
};

__device__ __forceinline__ Source source_of(const Work& a, int64_t e, int32_t id) {
  const int64_t r = e / a.s_max;
  if (a.area_rows > 0) return {r * a.area_rows + id, r * a.area_rows, 0};
  return {id, 0, (int)r};
}

// The packet's real entries, estimated from kSample evenly spaced entries:
// the same in every block, so every block decides alike.
__device__ int64_t real_entries(const Work& a) {
  __shared__ int real;
  if (threadIdx.x == 0) real = 0;
  __syncthreads();
  int mine = 0;
  for (int i = threadIdx.x; i < kSample; i += kThreads) {
    const int32_t id = __ldg(a.ids + (int64_t)i * a.n_entries / kSample);
    mine += id >= 0 && id < a.n_src;
  }
  atomicAdd(&real, mine);
  __syncthreads();
  return (real * a.n_entries + kSample - 1) / kSample;
}

// Whether a packet of `real` real entries puts kDenseEighths* / 8 adds on
// each 32-byte ring sector, on average: then it is sliced.
__device__ __forceinline__ bool dense(const Work& a, int64_t real) {
  if (a.regime != 0) return a.regime == 1;
  const int eighths = a.area_rows > 0 ? kDenseEighthsAreas : kDenseEighthsCycles;
  return real * a.k * kSectorFloats * 8 >= eighths * a.n_rows * a.ring_len;
}

// A packet that puts fewer adds on each 32-byte ring sector, on average,
// gains nothing from slicing. Unsliced, `wpe` warps serve an entry,
// each 32 consecutive targets a step over the whole row, and the warps walk
// the (entry, warp) pairs with a grid stride; a padding entry costs its
// warps a load of its id. `wpe`: as many (up to 8) as fit the real entries
// into half the resident warps. Rows that fill that half stream their REDs
// at DRAM's read-modify-write rate, and splitting them only adds warps (at
// the paper's 2.5 Hz, a window's inter packets: 1,300 rows, 12% slower with
// 2 warps a row than with 1); fewer rows are latency-bound and gain from
// more warps each (one cycle's intra packets: 130 rows, 8 warps a row).
template <typename DelayT>
__device__ void deliver_unsliced(const Work& a, int64_t real) {
  const int lane = threadIdx.x % 32;
  const int64_t warps = (int64_t)gridDim.x * kWarps;
  int wpe = 8;
  while (wpe > 1 && 2 * real * wpe > warps) wpe /= 2;
  for (int64_t t = (int64_t)blockIdx.x * kWarps + threadIdx.x / 32; t < a.n_entries * wpe;
       t += warps) {
    const int64_t e = t / wpe;
    const int32_t id = __ldg(a.ids + e);
    if (id < 0 || id >= a.n_src) continue;  // packet padding
    const Source src = source_of(a, e, id);
    const int64_t base = src.row * (int64_t)a.k;
    const int time = a.t0_mod + src.step;
#pragma unroll 4
    for (int c = 32 * (int)(t % wpe) + lane; c < a.k; c += 32 * wpe) {
      const uint32_t target = (uint32_t)__ldcs(a.tgt + base + c);
      if (target >= (uint32_t)a.n_tgt) continue;  // table padding
      const int slot = (time + (int)((const DelayT*)a.d)[base + c]) % a.ring_len;
      atomicAdd(a.ring + (src.off + (int64_t)target) * a.ring_len + slot,
                __ldcs(a.w + base + c));
    }
  }
}

// Eight consecutive values from an aligned address, streamed.
__device__ __forceinline__ void load8(const int32_t* p, int (&v)[kVec]) {
  const int4 a = __ldcs(reinterpret_cast<const int4*>(p));
  const int4 b = __ldcs(reinterpret_cast<const int4*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load8(const float* p, float (&v)[kVec]) {
  const float4 a = __ldcs(reinterpret_cast<const float4*>(p));
  const float4 b = __ldcs(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load8(const int8_t* p, int (&v)[kVec]) {
  const uint2 x = __ldcs(reinterpret_cast<const uint2*>(p));
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[i] = (int)(int8_t)(x.x >> (8 * i));
    v[4 + i] = (int)(int8_t)(x.y >> (8 * i));
  }
}

// The kVec positions from p0 of the row at `base`: tgt, w and d. Vector
// loads, except for the step that crosses the end of the tables, which reads
// only the row's positions below k.
template <typename DelayT>
__device__ __forceinline__ void load_step(const Work& a, int64_t base, int p0,
                                          int (&tg)[kVec], float (&wv)[kVec],
                                          int (&dv)[kVec]) {
  if (base + p0 + kVec <= a.n_elems) {
    load8(a.tgt + base + p0, tg);
    load8(a.w + base + p0, wv);
    load8((const DelayT*)a.d + base + p0, dv);
    return;
  }
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    const bool in = p0 + i < a.k;
    tg[i] = in ? __ldcs(a.tgt + base + p0 + i) : -1;
    wv[i] = in ? __ldcs(a.w + base + p0 + i) : 0.0f;
    dv[i] = in ? (int)((const DelayT*)a.d)[base + p0 + i] : 0;
  }
}

// First position p in [0, k) with (uint32)row[p] >= v, or k, in a row
// ascending as unsigned. The group's 4 lanes probe 8 positions each a
// round, spread over the range, and keep the gap that holds the answer (3
// rounds for 3,000 targets).
__device__ int lower_bound_group(const int32_t* row, int k, uint32_t v, int sub,
                                 unsigned gmask) {
  int lo = 0, hi = k;
  for (;;) {
    const int step = hi - lo > kStep ? (hi - lo + kStep - 1) / kStep : 1;
    int below = 0;
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      const int p = lo + (kVec * sub + i) * step;
      below += p < hi && (uint32_t)__ldg(row + p) < v;
    }
#pragma unroll
    for (int o = 1; o < kGroup; o *= 2) below += __shfl_xor_sync(gmask, below, o);
    // `below` counts the probes below v: a prefix of them.
    if (step == 1 || below == 0) return lo + below;
    const int next_hi = min(hi, lo + below * step);
    lo += (below - 1) * step + 1;
    hi = next_hi;
  }
}

// The adds of entry e (source id) into ring rows [lo_row, hi_row), a
// slice, by the group of 4 lanes whose lane within the group is `sub`: part q
// of wpe, kStep positions a step. `cursor` is the entry's cursor as its
// ticket found it: any value.
template <typename DelayT>
__device__ __forceinline__ void deliver_segment(const Work& a, int64_t e, int32_t id,
                                                unsigned long long cursor,
                                                int64_t lo_row, int64_t hi_row, int q,
                                                int wpe, int sub, unsigned gmask) {
  const Source src = source_of(a, e, id);
  const int64_t llo = max(lo_row - src.off, (int64_t)0);
  const int64_t lhi = min(hi_row - src.off, a.n_tgt);
  if (llo >= lhi) return;  // the slice holds none of this entry's targets
  const int64_t base = src.row * (int64_t)a.k;
  const int32_t* row = a.tgt + base;
  int start = 0;
  if (llo > 0) {
    // The cursor is the segment's start if it is the row's first position
    // at or above llo (the row ascends, so there is one such position).
    const uint32_t c = (uint32_t)cursor;
    const bool at = c <= (uint32_t)a.k && (c == 0 || (uint32_t)__ldg(row + c - 1) < llo) &&
                    (c == (uint32_t)a.k || (uint32_t)__ldg(row + c) >= llo);
    start = at ? (int)c : lower_bound_group(row, a.k, (uint32_t)llo, sub, gmask);
  }
  const uint32_t hi = (uint32_t)lhi;
  const int t = a.t0_mod + src.step;
  // Steps from the position at or before `start` that is 8-aligned in the
  // flat tables; positions before `start` (of this row or the one before)
  // are read and skipped.
  const int first = (int)(((base + start) & ~(int64_t)(kVec - 1)) - base);
  int blk = first + kStep * q;
  int ntg[kVec], ndv[kVec];  // the next step's values, loaded a step ahead
  float nwv[kVec];
  {
    const int p0 = blk + kVec * sub;
    if (p0 < a.k) load_step<DelayT>(a, base, p0, ntg, nwv, ndv);
  }
  for (;; blk += kStep * wpe) {
    const int p0 = blk + kVec * sub;
    int tg[kVec], dv[kVec];
    float wv[kVec];
    const bool loads = p0 < a.k;
#pragma unroll
    for (int i = 0; i < kVec; ++i) { tg[i] = ntg[i]; dv[i] = ndv[i]; wv[i] = nwv[i]; }
    {
      const int np0 = p0 + kStep * wpe;
      if (np0 < a.k) load_step<DelayT>(a, base, np0, ntg, nwv, ndv);
    }
    int out = INT_MAX;  // the first position of the lane, from `start`, past the slice
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      const int p = p0 + i;
      const uint32_t target = loads && p < a.k ? (uint32_t)tg[i] : 0xffffffffu;
      if (p < start) continue;
      if (target < hi) {  // >= llo: the row ascends from `start`
        const int slot = (t + dv[i]) % a.ring_len;
        atomicAdd(a.ring + (src.off + (int64_t)target) * a.ring_len + slot, wv[i]);
      } else if (out == INT_MAX) {
        out = p;
      }
    }
    const unsigned outs = __ballot_sync(gmask, out != INT_MAX);
    if (outs == 0) continue;
    // The group's first position past the slice is its lowest such lane's:
    // the segment's end, unless the step opens with it and the step before
    // belongs to another part (then the target before decides).
    if ((threadIdx.x % 32) == __ffs(outs) - 1) {
      bool end_here = wpe == 1 || out > blk || blk <= start;
      if (!end_here && blk <= a.k) end_here = (uint32_t)__ldg(row + blk - 1) < hi;
      if (end_here)
        __stcg(a.scratch + 2 + e, (unsigned long long)(uint32_t)out);
    }
    return;
  }
}

template <typename DelayT>
__global__ void __launch_bounds__(kThreads, kMinBlocks) event_deliver_kernel(const Work a) {
  const int64_t real = real_entries(a);
  if (!dense(a, real)) {
    deliver_unsliced<DelayT>(a, real);
    return;
  }
  // Sliced. Two blocks an SM take part (on an H100 faster than three, at
  // every density). Parts per segment: the fewest (up to 8) that give a
  // slice's real segments, kChunk of them to a warp, half of those warps,
  // so that a slice's segments are served at once; no more blocks take
  // part than hold two slices' tickets, so the adds in flight stay within
  // about two slices.
  const int64_t blocks = max((int64_t)1, (int64_t)gridDim.x * (kMinBlocks - 1) / kMinBlocks);
  if (blockIdx.x >= blocks) return;
  const int64_t warps = blocks * kWarps;
  const int64_t slice_segments = real * a.segments / a.n_slices;
  int wpe = 1;
  while (wpe < 8 && 2 * slice_segments * wpe < kChunk * warps) wpe *= 2;
  const int64_t per_slice = a.chunks_per_slice * wpe;
  const int64_t active = min(blocks, (2 * per_slice + kWarps - 1) / kWarps);
  if (blockIdx.x >= active) return;
  const unsigned long long n_tickets = a.n_slices * per_slice;
  const int lane = threadIdx.x % 32;
  // The block takes the next kWarps tickets at once, a warp each: one
  // atomic a round for the block (the counter is contended by every block).
  __shared__ unsigned long long base[2];
  for (int round = 0;; ++round) {
    if (threadIdx.x == 0) base[round & 1] = atomicAdd(a.scratch, (unsigned long long)kWarps);
    __syncthreads();
    const unsigned long long ticket = base[round & 1] + threadIdx.x / 32;
    if (base[round & 1] >= n_tickets) {
      // Every block draws past the end once and then leaves; the last one
      // out zeroes the counters for the next launch.
      if (threadIdx.x == 0 &&
          atomicAdd(a.scratch + 1, 1ull) + 1 == (unsigned long long)active) {
        a.scratch[0] = 0;
        a.scratch[1] = 0;
      }
      return;
    }
    if (ticket >= n_tickets) continue;
    const int j = (int)(ticket / per_slice);
    const int64_t rem = (int64_t)(ticket % per_slice);
    const int64_t lo_row = (int64_t)j * a.slice_rows;
    const int64_t hi_row = min(a.n_rows, lo_row + a.slice_rows);
    // Per-area packets: only the rows of the areas the slice overlaps.
    int64_t e_lo = 0, e_hi = a.n_entries;
    if (a.area_rows > 0) {
      e_lo = lo_row / a.area_rows * a.s_max;
      e_hi = min(a.rows, (hi_row + a.area_rows - 1) / a.area_rows) * a.s_max;
    }
    // Group g of the warp's 4-lane groups serves entry g of its chunk.
    const int64_t e = (e_lo / kChunk + rem / wpe) * kChunk + lane / kGroup;
    if (e >= e_hi) continue;
    const int32_t id = __ldg(a.ids + e);
    if (id < 0 || id >= a.n_src) continue;  // packet padding
    deliver_segment<DelayT>(a, e, id, __ldcg(a.scratch + 2 + e), lo_row, hi_row,
                            (int)(rem % wpe), wpe, lane % kGroup,
                            (kFull >> (32 - kGroup)) << (lane / kGroup * kGroup));
  }
}

static int64_t least(int64_t x, int64_t y) { return x < y ? x : y; }

// Ring rows per slice: 1/kL2Share of the L2's bytes, at least one row.
static int slice_rows(int ring_len, int64_t* out) {
  int dev = 0, l2 = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&l2, cudaDevAttrL2CacheSize, dev);
  if (err != cudaSuccess) return (int)err;
  const int64_t rows = (int64_t)l2 / kL2Share / ((int64_t)ring_len * 4);
  *out = rows > 0 ? rows : 1;
  return 0;
}

template <typename DelayT>
static int launch(const void* ids, const void* tgt, const void* w, const void* d,
                  void* ring, void* scratch, int64_t rows, int s_max, int k,
                  int ring_len, int t0_mod, int64_t n_src, int64_t n_tgt,
                  int64_t area_rows, void* stream) {
  Work a{(const int32_t*)ids, (const int32_t*)tgt, (const float*)w, d, (float*)ring,
         (unsigned long long*)scratch};
  a.n_entries = rows * (int64_t)s_max;
  a.rows = rows;
  a.n_src = n_src;
  a.n_tgt = n_tgt;
  a.area_rows = area_rows;
  a.n_rows = area_rows > 0 ? rows * area_rows : n_tgt;
  a.n_elems = (area_rows > 0 ? rows * area_rows : n_src) * (int64_t)k;
  a.s_max = s_max;
  a.k = k;
  a.ring_len = ring_len;
  a.t0_mod = t0_mod;
  a.regime = EVENT_DELIVER_REGIME;
  if (a.n_entries <= 0 || k <= 0 || ring_len <= 0 || a.n_rows <= 0) return 0;
  int err = slice_rows(ring_len, &a.slice_rows);
  if (err) return err;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t cerr = cudaGetDevice(&dev);
  if (cerr == cudaSuccess)
    cerr = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (cerr == cudaSuccess)
    cerr = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, event_deliver_kernel<DelayT>, kThreads, 0);
  if (cerr != cudaSuccess) return (int)cerr;
  a.n_slices = (a.n_rows + a.slice_rows - 1) / a.slice_rows;
  // Chunks a slice visits and slices an entry's targets reach: all of them
  // for per-cycle packets; per-area packets, only the chunks of the areas a
  // slice overlaps (at most ceil(slice / area) + 1 of them), and only the
  // slices that overlap an entry's area.
  a.chunks_per_slice = (a.n_entries + kChunk - 1) / kChunk;
  a.segments = a.n_slices;
  if (area_rows > 0) {
    const int64_t areas = least(rows, (a.slice_rows + area_rows - 1) / area_rows + 1);
    a.chunks_per_slice = least(a.chunks_per_slice, (areas * s_max + kChunk - 1) / kChunk + 1);
    a.segments = least(a.n_slices, (area_rows + a.slice_rows - 1) / a.slice_rows + 1);
  }
  // One persistent wave; the kernel chooses its regime and warps per entry
  // from a sample of the packet.
  const int64_t blocks = (int64_t)sms * per_sm;
  event_deliver_kernel<DelayT><<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

extern "C" int event_deliver_i8_launch(
    const void* ids, const void* tgt, const void* w, const void* d, void* ring,
    void* scratch, int64_t rows, int s_max, int k, int ring_len, int t0_mod,
    int64_t n_src, int64_t n_tgt, int64_t area_rows, void* stream) {
  return launch<int8_t>(ids, tgt, w, d, ring, scratch, rows, s_max, k, ring_len, t0_mod,
                        n_src, n_tgt, area_rows, stream);
}

extern "C" int event_deliver_i32_launch(
    const void* ids, const void* tgt, const void* w, const void* d, void* ring,
    void* scratch, int64_t rows, int s_max, int k, int ring_len, int t0_mod,
    int64_t n_src, int64_t n_tgt, int64_t area_rows, void* stream) {
  return launch<int32_t>(ids, tgt, w, d, ring, scratch, rows, s_max, k, ring_len, t0_mod,
                         n_src, n_tgt, area_rows, stream);
}

// Ring rows per slice on the current device for rings of `ring_len` slots
// (written to *out); returns a CUDA error code.
extern "C" int event_deliver_slice_rows(int ring_len, int64_t* out) {
  return slice_rows(ring_len, out);
}

// The yardstick of the kernel's reductions: `adds` f32 REDs per thread of
// `threads`, each at a pseudo-random position of buf[0, n) (neighbouring
// lanes on distinct sectors, as in the scatter). Into a buffer that fits the
// L2 this times the L2's reduction rate; into a larger one, DRAM's
// read-modify-write.
__global__ void red_probe_kernel(float* buf, int64_t n, int adds) {
  uint32_t x = (blockIdx.x * blockDim.x + threadIdx.x) * 2654435761u;
  for (int i = 0; i < adds; ++i) {
    x = x * 1664525u + 1013904223u;
    atomicAdd(buf + (int64_t)(((uint64_t)x * (uint64_t)n) >> 32), 1.0f);
  }
}

extern "C" int event_deliver_red_probe(void* buf, int64_t n, int adds, int64_t threads,
                                       void* stream) {
  if (n <= 0 || n > 0xffffffffll || adds <= 0 || threads <= 0) return 0;
  const int64_t blocks = (threads + kThreads - 1) / kThreads;
  red_probe_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (float*)buf, n, adds);
  return (int)cudaGetLastError();
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
