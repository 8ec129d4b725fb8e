// Block pack, block scatter and the one-pass row compaction for Hopper
// (sm_90a).
//
// Replaces, in ice_halo_sim_tpu/core/pallas_ops.py:
//   K1 _pack_one_block (:245)        stable in-block compaction
//   K6 pack_valid_blocks (:301)      K1 per 4096-row block with the key carried,
//                                    one or two payload columns, any threshold
//   K5 pack_payload_blocks (:365)    K1 per 4096-row block, key as mask only
//   K3 scatter_blocks_multi (:436)   forward-overwrite block scatter + marker tail
//   K3' scatter_blocks (:549) with _scatter_vmem (:104) / _scatter_hbm (:147)
//   P2 scripts/probe_pallas_scatter.py (:121), the scatter at one payload
// and, in ice_halo_sim_tpu/core/accum.py, compact_valid (:326): K6 followed by
// one K3' per column, here one kernel.
//
// What the TPU kernels compute, not how: the butterfly routing, the
// ALIGN/SUP windows and rolls and the VMEM/HBM output split exist only for
// Mosaic and VMEM and are gone. All three kernels are bound by memory
// bandwidth: each moves every row it needs once and computes little.
//
// Pack (pack_blocks_kernel): one thread block per row block walks it in
// 1024-row tiles; a warp ballot ranks the valid rows of each warp, a
// 32-entry scan ranks the warps, so valid rows land in their original order
// (stable) at their rank, and the block's tail is written as (key
// 0xFFFFFFFF, payload 0).
//
// Scatter (scatter_tiles_kernel), the forward-overwrite contract: out[p] =
// vals[g][p - start[g]] for the last g with start[g] <= p when p - start[g]
// < blk, else 0 (start nondecreasing; equal starts, wide gaps and starts at
// or past out_len allowed); then channel 0 takes the marker tail
// ((p - t0) << shift) | low_or over [t0, t0 + tlen). Thread blocks run in
// no order, so the later-overwrites rule becomes ownership: block g owns the
// output window [start[g], start[g + 1]) and nothing else. Each thread block
// owns one tile of output rows (2048, 1024 or 512: the largest that still
// gives every multiprocessor about five tiles): two warps find the blocks
// around the tile (a 32-way search, about three dependent loads where a
// binary search per element took eleven), the blocks starting inside the
// tile mark their first row in shared memory (the last of equal starts
// wins), and a max-scan over the tile gives every row its owner. Then each
// of the 256 threads moves its rows of every column (up to 8 columns in one
// launch, the rows' loads all issued before their stores; neighbouring
// threads on neighbouring rows), reading row p - start[g] of block g, or the
// row that the optional in-block permutation perm[g, p - start[g]] names,
// and writing zero past the block's window. Every output element is written
// once: no memset, no atomics, the same bits on every run; the work grows
// with the output rows, not with the blocks.
//
// Compaction (compact_rows_kernel), compact_valid's contract: the rows
// whose key is not 0xFFFFFFFF in their original order, then up to 4096 rows
// past the last block's first kept row (key 0xFFFFFFFF, payload 0: that
// block's packed tail), then zeros, cut to `keep`; and the number of kept
// rows. One pass: each thread block of 1024 threads takes a 4096-row tile
// (one fold block) from an atomic counter, loads its keys and payloads with
// one 16-byte load per thread and column, ranks the kept rows by a block
// scan of the threads' counts, and learns the rows kept before it by a
// decoupled look-back over the tiles' published
// counts (one 64-bit word per tile: a flag and a count; integer sums, so
// the same bits on every run). Each kept row is then written once, at its
// final place, with its columns. Extra thread blocks, taking ids after
// every tile's, wait for the last tile's total and write the tail and the
// zeros. The rows are read once and the kept rows written once; the K6 slab
// between the pack and the scatter is gone. What holds it back is the
// look-back: a tile holds its rows until the tiles before it have counted,
// so fewer loads are in flight than in a kernel with no order between its
// blocks (K6 moves its bytes at a higher rate).
//
// Every entry point returns cudaGetLastError() after its launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kPackThreads = 1024;

__global__ void __launch_bounds__(kPackThreads)
pack_blocks_kernel(const uint32_t* __restrict__ key,
                   const uint32_t* __restrict__ c0,
                   const uint32_t* __restrict__ c1,
                   const uint32_t* __restrict__ c2, int ncols,
                   uint32_t thresh, int block, uint32_t* __restrict__ key_out,
                   uint32_t* __restrict__ o0, uint32_t* __restrict__ o1,
                   uint32_t* __restrict__ o2, int32_t* __restrict__ counts) {
  __shared__ int warp_off[32];
  __shared__ int tile_total;
  const long long g0 = (long long)blockIdx.x * block;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  int base = 0;
  for (int tile = 0; tile < block; tile += kPackThreads) {
    const long long row = g0 + tile + tid;
    const uint32_t k = key[row];
    const bool v = k < thresh;
    const unsigned bal = __ballot_sync(kFull, v);
    const int lrank = __popc(bal & ((1u << lane) - 1u));
    if (lane == 0) warp_off[warp] = __popc(bal);
    __syncthreads();
    if (warp == 0) {
      const int c = warp_off[lane];
      int incl = c;
      for (int off = 1; off < 32; off <<= 1) {
        const int n = __shfl_up_sync(kFull, incl, off);
        if (lane >= off) incl += n;
      }
      warp_off[lane] = incl - c;
      if (lane == 31) tile_total = incl;
    }
    __syncthreads();
    if (v) {
      const long long dst = g0 + base + warp_off[warp] + lrank;
      if (key_out) key_out[dst] = k;
      if (ncols > 0) o0[dst] = c0[row];
      if (ncols > 1) o1[dst] = c1[row];
      if (ncols > 2) o2[dst] = c2[row];
    }
    base += tile_total;
    __syncthreads();
  }
  for (int r = base + tid; r < block; r += kPackThreads) {
    const long long dst = g0 + r;
    if (key_out) key_out[dst] = 0xFFFFFFFFu;
    if (ncols > 0) o0[dst] = 0u;
    if (ncols > 1) o1[dst] = 0u;
    if (ncols > 2) o2[dst] = 0u;
  }
  if (tid == 0) counts[blockIdx.x] = base;
}

// ---------------------------------------------------------------------------
// Block scatter
// ---------------------------------------------------------------------------

constexpr int kMaxCols = 8;
constexpr int kScatterThreads = 256;
constexpr int kScatterWarps = kScatterThreads / 32;

struct ScatterArgs {
  const uint32_t* v[kMaxCols];  // [G * blk] each
  uint32_t* o[kMaxCols];        // [out_len] each
  const int32_t* perm;          // [G, blk] row inside the block, or null
  const int32_t* start;         // [G], nondecreasing
  int n_blocks, blk;
  long long out_len;
  int has_tail, shift;
  long long t0, tlen;
  uint32_t low_or;
};

// The number of g in [0, n) with start[g] <= x (le) or start[g] < x (!le),
// for a nondecreasing start: every lane of one warp calls it; each step
// probes 32 evenly spaced entries and keeps the gap where the predicate
// turns false (about log32(n) dependent loads).
__device__ int warp_count(const int32_t* __restrict__ start, int n, long long x, bool le) {
  const int lane = threadIdx.x & 31;
  int lo = 0, hi = n;  // the count lies in [lo, hi]
  while (lo < hi) {
    const int step = (hi - lo + 31) >> 5;
    const int idx = lo + lane * step;
    bool pred = false;
    if (idx < hi) {
      const long long s = __ldg(start + idx);
      pred = le ? s <= x : s < x;
    }
    const int c = __popc(__ballot_sync(kFull, pred));  // a prefix of the lanes
    if (c == 0) return lo;
    if (step == 1) return lo + c;
    const int nlo = lo + (c - 1) * step + 1;
    hi = min(lo + c * step, hi);
    lo = nlo;
  }
  return lo;
}

template <int NC, int kScatterItems>
__global__ void __launch_bounds__(kScatterThreads)
scatter_tiles_kernel(const ScatterArgs a) {
  constexpr int kScatterTile = kScatterThreads * kScatterItems;
  __shared__ int owner[kScatterTile];
  __shared__ int s_g0, s_g1;
  __shared__ int s_warp[kScatterWarps];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long p0 = (long long)blockIdx.x * kScatterTile;
  const long long p1 = min(p0 + kScatterTile, a.out_len);
  const int n = (int)(p1 - p0);

  // g0: the block that owns the tile's first row (-1: none); the blocks
  // g0 < g < g1 start inside the tile.
  if (warp == 0) {
    const int c = warp_count(a.start, a.n_blocks, p0, true);
    if (lane == 0) s_g0 = c - 1;
  } else if (warp == 1) {
    const int c = warp_count(a.start, a.n_blocks, p1, false);
    if (lane == 0) s_g1 = c;
  }
  for (int i = tid; i < kScatterTile; i += kScatterThreads) owner[i] = -1;
  __syncthreads();
  const int g0 = s_g0, g1 = s_g1;
  if (tid == 0) owner[0] = g0;
  for (int g = g0 + 1 + tid; g < g1; g += kScatterThreads) {
    const int s = __ldg(a.start + g);
    if (g + 1 == g1 || __ldg(a.start + g + 1) != s) owner[(int)(s - p0)] = g;
  }
  __syncthreads();

  // Max-scan of the marks over the tile (owners grow with the row): each
  // thread its consecutive entries, then the warps, then across warps.
  int v[kScatterItems];
#pragma unroll
  for (int j = 0; j < kScatterItems; ++j) v[j] = owner[tid * kScatterItems + j];
#pragma unroll
  for (int j = 1; j < kScatterItems; ++j) v[j] = max(v[j], v[j - 1]);
  int incl = v[kScatterItems - 1];
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int m = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl = max(incl, m);
  }
  if (lane == 31) s_warp[warp] = incl;
  int excl = __shfl_up_sync(kFull, incl, 1);
  if (lane == 0) excl = -1;
  __syncthreads();
  for (int w = 0; w < warp; ++w) excl = max(excl, s_warp[w]);
#pragma unroll
  for (int j = 0; j < kScatterItems; ++j) v[j] = max(v[j], excl);
#pragma unroll
  for (int j = 0; j < kScatterItems; ++j) owner[tid * kScatterItems + j] = v[j];
  __syncthreads();

  // Each thread's rows tid, tid + 256, ...: neighbouring threads on
  // neighbouring rows. src < 0: the row is zero.
  long long src[kScatterItems];
#pragma unroll
  for (int k = 0; k < kScatterItems; ++k) {
    const int i = tid + k * kScatterThreads;
    src[k] = -1;
    if (i < n) {
      const int g = owner[i];
      if (g >= 0) {
        const long long off = p0 + i - (long long)__ldg(a.start + g);
        if (off < a.blk) {
          const long long row = (long long)g * a.blk;
          src[k] = row + (a.perm ? (long long)__ldg(a.perm + row + off) : off);
        }
      }
    }
  }
  uint32_t val[NC][kScatterItems];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
#pragma unroll
    for (int k = 0; k < kScatterItems; ++k)
      val[c][k] = src[k] >= 0 ? __ldg(a.v[c] + src[k]) : 0u;
  }
  if (a.has_tail) {
#pragma unroll
    for (int k = 0; k < kScatterItems; ++k) {
      const long long p = p0 + tid + k * kScatterThreads;
      if (p >= a.t0 && p < a.t0 + a.tlen)
        val[0][k] = ((uint32_t)(p - a.t0) << a.shift) | a.low_or;
    }
  }
#pragma unroll
  for (int c = 0; c < NC; ++c) {
#pragma unroll
    for (int k = 0; k < kScatterItems; ++k) {
      const int i = tid + k * kScatterThreads;
      if (i < n) a.o[c][p0 + i] = val[c][k];
    }
  }
}

// The largest tile (2048, 1024 or 512 rows) that still gives every
// multiprocessor about five tiles: long outputs keep the per-tile search and
// scan rare, short ones keep the card full.
template <int NC>
void launch_scatter(const ScatterArgs& a, int n_sm, cudaStream_t stream) {
  const long long want = 5LL * n_sm;
  const long long t8 = (a.out_len + 8 * kScatterThreads - 1) / (8 * kScatterThreads);
  const long long t4 = (a.out_len + 4 * kScatterThreads - 1) / (4 * kScatterThreads);
  const long long t2 = (a.out_len + 2 * kScatterThreads - 1) / (2 * kScatterThreads);
  if (t8 >= want)
    scatter_tiles_kernel<NC, 8><<<(unsigned)t8, kScatterThreads, 0, stream>>>(a);
  else if (t4 >= want)
    scatter_tiles_kernel<NC, 4><<<(unsigned)t4, kScatterThreads, 0, stream>>>(a);
  else
    scatter_tiles_kernel<NC, 2><<<(unsigned)t2, kScatterThreads, 0, stream>>>(a);
}

// ---------------------------------------------------------------------------
// One-pass compaction
// ---------------------------------------------------------------------------

constexpr int kMaxPayloads = 3;
constexpr int kCompactThreads = 1024;
constexpr int kCompactItems = 4;
constexpr int kCompactTile = kCompactThreads * kCompactItems;  // the fold's 4096-row block
constexpr int kCompactWarps = kCompactThreads / 32;
constexpr int kFillRows = 16384;  // tail and zero rows per extra thread block
constexpr unsigned long long kAggReady = 1ull << 32;     // a tile's own count
constexpr unsigned long long kPrefixReady = 2ull << 32;  // the count up to its end
constexpr unsigned long long kFinReady = 1ull << 63;

struct CompactArgs {
  const uint32_t* key;               // [n_rows]
  const uint32_t* v[kMaxPayloads];   // [n_rows] each
  uint32_t* key_out;                 // [keep]
  uint32_t* o[kMaxPayloads];         // [keep] each
  long long n_rows, keep;
  int n_tiles, vec;
  // Zeroed by the caller. [0]: the tile counter; [1]: the last tile's
  // (kFinReady | its count << 32 | the total); [2]: the total (the
  // caller's n_valid); [3 + t]: tile t's flag and count.
  unsigned long long* state;
};

__device__ __forceinline__ void load_rows(const uint32_t* __restrict__ p, long long r0,
                                          long long n, bool vec, uint32_t fill,
                                          uint32_t (&x)[kCompactItems]) {
  if (vec) {
    const uint4 a = *reinterpret_cast<const uint4*>(p + r0);
    x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  } else {
#pragma unroll
    for (int j = 0; j < kCompactItems; ++j) x[j] = r0 + j < n ? p[r0 + j] : fill;
  }
}

template <int NC>
__global__ void __launch_bounds__(kCompactThreads)
compact_rows_kernel(const CompactArgs a) {
  __shared__ int s_tile;
  __shared__ int s_warp[kCompactWarps];
  __shared__ long long s_prefix;
  __shared__ unsigned long long s_fin;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  volatile unsigned long long* fin = a.state + 1;
  volatile unsigned long long* status = a.state + 3;
  if (tid == 0) s_tile = (int)atomicAdd(reinterpret_cast<unsigned int*>(a.state), 1u);
  __syncthreads();
  const int tile = s_tile;

  if (tile >= a.n_tiles) {
    // Tail and zeros: rows [total, keep) of this block's span. Every tile
    // already has its id, so the last one is running.
    const long long f0 = (long long)(tile - a.n_tiles) * kFillRows;
    const long long f1 = min(f0 + kFillRows, a.keep);
    if (tid == 0) {
      unsigned long long w = kFinReady;  // no tile: no kept row, no tail
      if (a.n_tiles > 0) {
        do { w = *fin; } while (!(w & kFinReady));
      }
      s_fin = w;
    }
    __syncthreads();
    const long long total = (long long)(s_fin & 0xFFFFFFFFull);
    const long long last = (long long)((s_fin >> 32) & 0x7FFFFFFFull);
    const long long tail_end = a.n_tiles > 0 ? total - last + kCompactTile : 0;
    for (long long p = max(f0, total) + tid; p < f1; p += kCompactThreads) {
      a.key_out[p] = p < tail_end ? 0xFFFFFFFFu : 0u;
#pragma unroll
      for (int c = 0; c < NC; ++c) a.o[c][p] = 0u;
    }
    return;
  }

  const long long r0 = (long long)tile * kCompactTile + (long long)tid * kCompactItems;
  const bool vec = a.vec && r0 + kCompactItems <= a.n_rows;
  uint32_t k[kCompactItems];
  uint32_t v[NC][kCompactItems];
  load_rows(a.key, r0, a.n_rows, vec, 0xFFFFFFFFu, k);
#pragma unroll
  for (int c = 0; c < NC; ++c) load_rows(a.v[c], r0, a.n_rows, vec, 0u, v[c]);
  unsigned live = 0;
#pragma unroll
  for (int j = 0; j < kCompactItems; ++j) live |= (unsigned)(k[j] != 0xFFFFFFFFu) << j;
  const int cnt = __popc(live);

  // The threads' counts: scanned in the warp, then the warps' totals.
  int incl = cnt;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int m = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += m;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int t = lane < kCompactWarps ? s_warp[lane] : 0;
    int ti = t;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int m = __shfl_up_sync(kFull, ti, off);
      if (lane >= off) ti += m;
    }
    __syncwarp();
    if (lane < kCompactWarps) s_warp[lane] = ti - t;
    const int agg = __shfl_sync(kFull, ti, 31);

    // The kept rows of the tiles before: look back over their words, 32 at
    // a time, to the nearest one that holds its count up to its end.
    long long prefix = 0;
    if (tile == 0) {
      if (lane == 0) status[0] = kPrefixReady | (unsigned long long)agg;
    } else {
      if (lane == 0) status[tile] = kAggReady | (unsigned long long)agg;
      for (int j = tile - 1;; j -= 32) {
        const int idx = j - lane;
        unsigned long long w = kPrefixReady;  // before tile 0: nothing kept
        if (idx >= 0) {
          do { w = status[idx]; } while ((w >> 32) == 0);
        }
        const unsigned inc = __ballot_sync(kFull, (w >> 32) == 2);
        const int stop = inc ? __ffs(inc) - 1 : 31;
        long long add = lane <= stop ? (long long)(w & 0xFFFFFFFFull) : 0;
#pragma unroll
        for (int off = 16; off; off >>= 1) add += __shfl_down_sync(kFull, add, off);
        prefix += __shfl_sync(kFull, add, 0);
        if (inc) break;
      }
      if (lane == 0) status[tile] = kPrefixReady | (unsigned long long)(prefix + agg);
    }
    if (lane == 0) {
      s_prefix = prefix;
      if (tile == a.n_tiles - 1) {
        const unsigned long long total = (unsigned long long)(prefix + agg);
        a.state[2] = total;
        *fin = kFinReady | ((unsigned long long)agg << 32) | total;
      }
    }
  }
  __syncthreads();

  long long r = s_prefix + s_warp[warp] + incl - cnt;
#pragma unroll
  for (int j = 0; j < kCompactItems; ++j) {
    if (live >> j & 1u) {
      if (r < a.keep) {
        a.key_out[r] = k[j];
#pragma unroll
        for (int c = 0; c < NC; ++c) a.o[c][r] = v[c][j];
      }
      ++r;
    }
  }
}

template <int NC>
void launch_compact(const CompactArgs& a, cudaStream_t stream) {
  const long long fills = (a.keep + kFillRows - 1) / kFillRows;
  const long long grid = a.n_tiles + fills;
  if (grid > 0)
    compact_rows_kernel<NC><<<(unsigned)grid, kCompactThreads, 0, stream>>>(a);
}

}  // namespace

extern "C" int iht_pack_blocks(const void* key, const void* c0, const void* c1,
                               const void* c2, int ncols, uint32_t thresh,
                               int n_blocks, int block, void* key_out,
                               void* o0, void* o1, void* o2, void* counts,
                               void* stream) {
  if (n_blocks > 0) {
    pack_blocks_kernel<<<n_blocks, kPackThreads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)key, (const uint32_t*)c0, (const uint32_t*)c1,
        (const uint32_t*)c2, ncols, thresh, block, (uint32_t*)key_out,
        (uint32_t*)o0, (uint32_t*)o1, (uint32_t*)o2, (int32_t*)counts);
  }
  return (int)cudaGetLastError();
}

// vals, outs: host arrays of nvals (1..8) device pointers; perm may be null.
extern "C" int iht_scatter_blocks(void* const* vals, int nvals, const void* perm,
                                  const void* start, int n_blocks, int blk,
                                  long long out_len, void* const* outs,
                                  int has_tail, long long t0, long long tlen,
                                  int shift, uint32_t low_or, void* stream) {
  if (nvals < 1 || nvals > kMaxCols) return (int)cudaErrorInvalidValue;
  ScatterArgs a{};
  for (int c = 0; c < nvals; ++c) {
    a.v[c] = (const uint32_t*)vals[c];
    a.o[c] = (uint32_t*)outs[c];
  }
  a.perm = (const int32_t*)perm;
  a.start = (const int32_t*)start;
  a.n_blocks = n_blocks;
  a.blk = blk;
  a.out_len = out_len;
  a.has_tail = has_tail;
  a.shift = shift;
  a.t0 = t0;
  a.tlen = tlen;
  a.low_or = low_or;
  // The grid is sized by the multiprocessors of the current device (the
  // caller makes the tensors' device current), looked up on every call.
  int device = 0, n_sm = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
  if (out_len > 0) {
    const cudaStream_t s = (cudaStream_t)stream;
    switch (nvals) {
      case 1: launch_scatter<1>(a, n_sm, s); break;
      case 2: launch_scatter<2>(a, n_sm, s); break;
      case 3: launch_scatter<3>(a, n_sm, s); break;
      case 4: launch_scatter<4>(a, n_sm, s); break;
      case 5: launch_scatter<5>(a, n_sm, s); break;
      case 6: launch_scatter<6>(a, n_sm, s); break;
      case 7: launch_scatter<7>(a, n_sm, s); break;
      default: launch_scatter<8>(a, n_sm, s); break;
    }
  }
  return (int)cudaGetLastError();
}

// cols, outs: host arrays of ncols (1..3) device pointers; state: zeroed
// int64 [3 + ceil(n_rows / 4096)].
extern "C" int iht_compact_rows(const void* key, void* const* cols, int ncols,
                                long long n_rows, long long keep, void* key_out,
                                void* const* outs, void* state, int vec, void* stream) {
  if (ncols < 1 || ncols > kMaxPayloads) return (int)cudaErrorInvalidValue;
  CompactArgs a{};
  a.key = (const uint32_t*)key;
  for (int c = 0; c < ncols; ++c) {
    a.v[c] = (const uint32_t*)cols[c];
    a.o[c] = (uint32_t*)outs[c];
  }
  a.key_out = (uint32_t*)key_out;
  a.n_rows = n_rows;
  a.keep = keep;
  a.n_tiles = (int)((n_rows + kCompactTile - 1) / kCompactTile);
  a.vec = vec;
  a.state = (unsigned long long*)state;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (ncols) {
    case 1: launch_compact<1>(a, s); break;
    case 2: launch_compact<2>(a, s); break;
    default: launch_compact<3>(a, s); break;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* iht_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
