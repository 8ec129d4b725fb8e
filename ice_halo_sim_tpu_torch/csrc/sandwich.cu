// The sandwich fold for Hopper (sm_90a): a deterministic scatter-add into
// shared memory.
//
// Replaces, in ice_halo_sim_tpu/core/pallas_sandwich.py and scripts/:
//   K7 _kernel_lane (:143, pallas_call :283)   layout "lane"
//   K8 _kernel (:77, pallas_call :314)         layout "sublane", the A/B form
//   P1 scripts/probe_sandwich.py (:44, pallas_call :90)   K8 with an iota list
//
// The function (p = chunk * 128 + lo, list cl[0..NC), C channels):
//   out[k, c*128 + lo] = tile[k, c*128 + lo]
//       + sum_r [pix_r // 128 == cl[k]] * bf16(tbl[wl_r, c] * w_r) * [pix_r % 128 == lo]
//   matched[r] = 1 iff pix_r // 128 is in cl
// with // the floor division (a dead row, pix -1, has chunk -1), a negative
// list id matching nothing, the product tbl * w rounded to bf16 (or split into
// two bf16 terms when `precise`), and the sum taken in float32. The bf16
// rounding is part of what the TPU kernels compute and is kept.
//
// Bound: bytes. A row is read once (12 B: pix, w, wl) and its `matched` flag
// written (4 B); the tile is read and written once. The adds are 2 float32
// operations per listed row and channel, far below the memory's rate.
//
// Why not the tensor cores. The TPU has no atomics and used its matrix unit
// as the scatter: a one-hot product of 2 * rows * NC * C * 128 operations
// where the scatter needs 2 * rows * C. On this card that product's ceiling
// at the tensor cores' 989e12 bf16 op/s is 0.83 ms over the six launches of a
// steady ms-sandwich batch, 3.7 times index_add_ (0.22 ms) on the same rows
// and 37 times the bytes bound (0.022 ms) (an H100 80GB HBM3 at 700 W; the
// ceiling computed from the launches' listed rows and NC). No product
// version can win, so both kernels add into a tile held in shared memory.
//
// K7 (lane), output-stationary. The grid is (row splits, slices of S list
// entries), S = 384 / C: the block's [S, C*128] float32 part of the tile
// (192 KB) lives in dynamic shared memory. The block sorts its slice's ids
// (with their list positions) in shared memory, then streams the rows of its
// split 1024 at a time (16-byte loads, four rows a thread, the next rows'
// loads in flight meanwhile); a row's slot is a binary search of the sorted
// slice, and only the rows in the slice go on, in row order, into the slab
// that is added to the tile when full. Every row is read once per slice.
//
// K8 (sublane), row-stationary. The rows are first grouped by slice: the
// whole list is sorted once (one block), a count pass finds each row's list
// position and counts the rows per (tile of 1024 rows, slice), a scan turns
// the counts into offsets, and a stable scatter writes each listed row's
// (slot, lo), w and wl in slice order. The accumulating grid is (splits of a
// slice's rows, slices): each block reads only its slice's rows, once. P1 is
// K8 with slot = chunk (no list, no sort). K8 pays about 52 bytes per row
// for the grouping against K7's 12 per row and slice: it should win where a
// list has many slices.
//
// Inside a block the adds are a reduction by key over each staged slab of
// 1024 rows: a stable block radix sort of the rows by cell (CUB's
// BlockRadixSort, a building block inside this kernel), a segmented scan of
// their values in that order (CUB's BlockScan), and one add of each cell's
// sum to the tile by the thread holding the cell's last row. A hot pixel
// costs no more than any other: its rows are summed by the scan's tree, not
// one by one, and no two threads write one cell.
//
// The order of every add is fixed, so the bits are the same run after run:
//   - a slab holds the split's rows in row order (K7: the split's rows; K8:
//     the stable grouping keeps row order inside a slice), the sort is
//     stable, the scan's tree depends only on the positions, and the slabs
//     are added one after another;
//   - the splits' partial tiles are added to the tile in split order by
//     sandwich_reduce_kernel (a single split writes the tile directly);
//   - the grouping counts and ranks rows with warp votes and a block-wide
//     cursor, never with atomics.
// `matched` needs no reduction: a row's chunk is in at most one slice, whose
// block writes the 1 (the wrapper zeroes the vector).
//
// No fallback: every entry point returns the first CUDA error of its
// launches (the shared-memory attribute included) and the wrapper raises.

#include <climits>
#include <cstdint>
#include <cub/block/block_radix_sort.cuh>
#include <cub/block/block_scan.cuh>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kNlo = 128;          // pixels per chunk
constexpr int kCells = 384;        // slots * channels a block holds: S = kCells / C
constexpr int kThreads = 256;
constexpr int kSlab = 1024;        // rows staged per step, four per thread
constexpr int kMaxPool = 128;      // wavelength-pool entries
constexpr int kPadId = -0x40000000;
constexpr int kNone = 0xFFFF;      // the staged key of a row outside the block's slice
constexpr int kKeyBits = 16;       // slot * 128 + lo < 384 * 128 <= kNone
constexpr int kPlaceBits = 10;     // a row's place in the slab
static_assert(kSlab == 1 << kPlaceBits && kCells * kNlo <= kNone, "slab key layout");
constexpr int kGroupTile = 1024;   // K8: rows per counting block
constexpr int kMaxSlices = 64;     // K8: slices of the list
constexpr int kMaxSorted = 8192;   // K8: list entries the one-block sort takes
constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ constexpr int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

__device__ __forceinline__ uint16_t bf16_bits(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float bf16_float(uint16_t b) {
  return __bfloat162float(__ushort_as_bfloat16(b));
}

// Bitonic sort of n (a power of two) (key, value) pairs in shared memory,
// ascending by key, by all threads of the block; nothing to do where the keys
// are in order already (the engine's lists are sorted).
__device__ void sort_pairs(int* keys, int* vals, int n) {
  bool ordered = true;
  for (int i = threadIdx.x; i + 1 < n; i += blockDim.x) ordered &= keys[i] <= keys[i + 1];
  if (__syncthreads_and(ordered)) return;
  for (int k = 2; k <= n; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < n; i += blockDim.x) {
        const int ixj = i ^ j;
        if (ixj > i) {
          const bool up = (i & k) == 0;
          const int a = keys[i], b = keys[ixj];
          if ((a > b) == up) {
            keys[i] = b;
            keys[ixj] = a;
            const int t = vals[i];
            vals[i] = vals[ixj];
            vals[ixj] = t;
          }
        }
      }
      __syncthreads();
    }
  }
}

// The value beside `x` in n sorted keys, or -1 if x is not among them.
__device__ __forceinline__ int lookup(const int* keys, const int* vals, int n, int x) {
  int lo = 0;
  for (int half = n >> 1; half > 0; half >>= 1)
    if (keys[lo + half - 1] < x) lo += half;
  return keys[lo] == x ? vals[lo] : -1;
}

// A list id as the kernels compare it: negative ids become the pad id,
// which no row's chunk (at least -2^24) equals.
__device__ __forceinline__ int list_id(int id) { return id < 0 ? kPadId : id; }

// The block's staged rows: key[i] = slot * 128 + lo, or kNone, and the row's
// value per channel, val[c * kSlab + i]: the bf16 term, or the sum of the two
// bf16 terms when precise (one float32 rounding at most).
template <int kC>
struct Slab {
  int key[kSlab];
  float val[kC * kSlab];
};

template <int kC, int kTerms>
__device__ __forceinline__ void stage_value(Slab<kC>& s, int i, int key, const float* tbl_s,
                                            int k_pool, float w, int l) {
  s.key[i] = key;
  if (key == kNone) return;
#pragma unroll
  for (int c = 0; c < kC; ++c) {
    const float v = (unsigned)l < (unsigned)k_pool ? tbl_s[l * kC + c] * w : 0.0f;
    const float hi = bf16_float(bf16_bits(v));
    s.val[c * kSlab + i] = kTerms == 2 ? hi + bf16_float(bf16_bits(v - hi)) : hi;
  }
}

// A segment of equal cells in the sorted slab: its head flag and running sum.
template <int kC>
struct SegVal {
  int head;
  float v[kC];
};

template <int kC>
struct SegSum {
  __device__ __forceinline__ SegVal<kC> operator()(const SegVal<kC>& a,
                                                  const SegVal<kC>& b) const {
    SegVal<kC> r;
    r.head = a.head | b.head;
#pragma unroll
    for (int c = 0; c < kC; ++c) r.v[c] = b.head ? b.v[c] : a.v[c] + b.v[c];
    return r;
  }
};

constexpr int kItems = kSlab / kThreads;   // staged rows per thread

template <int kC>
struct SlabWork {
  using Sort = cub::BlockRadixSort<unsigned, kThreads, kItems>;
  using Scan = cub::BlockScan<SegVal<kC>, kThreads>;
  using Count = cub::BlockScan<int, kThreads>;   // K7: places of the slice's rows in the slab
  union Temp {
    typename Sort::TempStorage sort;
    typename Scan::TempStorage scan;
    typename Count::TempStorage count;
  };
};

// Add the staged rows to the block's tile [S, C*128] as a reduction by key:
// a stable sort of the slab by cell (equal cells keep row order), a
// segmented scan of the values in that order, and one add per cell, by the
// thread that holds the cell's last row. Each cell takes one add per slab,
// so no two threads write one cell, and the order of every add is fixed.
template <int kC>
__device__ __forceinline__ void add_slab(float* tile_s, Slab<kC>& s,
                                         typename SlabWork<kC>::Temp& tmp) {
  const int t = threadIdx.x;
  // One word per row: the cell above the row's place in the slab, so that a
  // sort of the cell bits alone also carries the place.
  unsigned word[kItems], key[kItems];
  int idx[kItems];
#pragma unroll
  for (int q = 0; q < kItems; ++q)
    word[q] = ((unsigned)s.key[kItems * t + q] << kPlaceBits) | (unsigned)(kItems * t + q);
  typename SlabWork<kC>::Sort(tmp.sort).Sort(word, kPlaceBits, kPlaceBits + kKeyBits);
  __syncthreads();
#pragma unroll
  for (int q = 0; q < kItems; ++q) {
    key[q] = word[q] >> kPlaceBits;
    idx[q] = (int)(word[q] & (kSlab - 1));
    s.key[kItems * t + q] = (int)key[q];
  }
  __syncthreads();
  SegVal<kC> x[kItems];
#pragma unroll
  for (int q = 0; q < kItems; ++q) {
    const int i = kItems * t + q;
    x[q].head = i == 0 || s.key[i - 1] != (int)key[q];
#pragma unroll
    for (int c = 0; c < kC; ++c) x[q].v[c] = key[q] == kNone ? 0.0f : s.val[c * kSlab + idx[q]];
  }
  typename SlabWork<kC>::Scan(tmp.scan).InclusiveScan(x, x, SegSum<kC>());
#pragma unroll
  for (int q = 0; q < kItems; ++q) {
    const int i = kItems * t + q;
    if (key[q] == kNone || (i + 1 < kSlab && s.key[i + 1] == (int)key[q])) continue;
    float* cell = tile_s + (key[q] >> 7) * (kC * kNlo) + (key[q] & (kNlo - 1));
#pragma unroll
    for (int c = 0; c < kC; ++c) cell[c * kNlo] += x[q].v[c];
  }
}

struct Pass {
  const float* tbl;       // [k_pool, C]
  int nc;
  int k_pool;
  int nc_pad;
  const float* tile_in;   // [nc, C*128] or null
  float* partial;         // [splits, nc_pad, C*128]
  float* out;             // [nc, C*128]
};

template <int kC>
__device__ __forceinline__ void load_table(const Pass& a, float* tbl_s) {
  for (int i = threadIdx.x; i < a.k_pool * kC; i += kThreads) tbl_s[i] = a.tbl[i];
}

template <int kC>
__device__ __forceinline__ void zero_tile(float* tile_s) {
  float4* t4 = reinterpret_cast<float4*>(tile_s);
  for (int i = threadIdx.x; i < kCells * kNlo / 4; i += kThreads)
    t4[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

// The block's slice [m0, m0 + S) of the tile: into partial[split], or with
// one split straight into out (tile_in + 0 + part, the reduce kernel's sum).
template <int kC>
__device__ __forceinline__ void write_tile(const Pass& a, const float* tile_s, int m0) {
  constexpr int kS = kCells / kC, kCW = kC * kNlo;
  const int split = blockIdx.x;
  if (gridDim.x == 1) {
    const int rows = min(kS, a.nc - m0);
    for (int i = threadIdx.x; i < rows * kCW; i += kThreads) {
      const long long g = (long long)m0 * kCW + i;
      const float s = 0.0f + tile_s[i];
      a.out[g] = a.tile_in != nullptr ? a.tile_in[g] + s : s;
    }
    return;
  }
  float4* dst = reinterpret_cast<float4*>(a.partial + ((long long)split * a.nc_pad + m0) * kCW);
  const float4* src = reinterpret_cast<const float4*>(tile_s);
  for (int i = threadIdx.x; i < kS * kCW / 4; i += kThreads) dst[i] = src[i];
}

// A K7 or K8 block's dynamic shared memory: its tile slice, the staged
// slab, the sort's and scan's storage, the sorted slice of the list (K7) and
// the basis table.
template <int kC>
struct BlockSmem {
  static constexpr int kSort = pow2_at_least(kCells / kC);
  static constexpr size_t kTemp = (sizeof(typename SlabWork<kC>::Temp) + 15) / 16 * 16;
  static constexpr size_t kBytes = sizeof(float) * kCells * kNlo + sizeof(Slab<kC>) + kTemp +
                                   sizeof(int) * 2 * kSort + sizeof(float) * kMaxPool * kC;
  float* tile;
  Slab<kC>* slab;
  typename SlabWork<kC>::Temp* tmp;
  int* ids;
  int* pos;
  float* tbl;
  __device__ explicit BlockSmem(unsigned char* p) {
    tile = reinterpret_cast<float*>(p);
    p += sizeof(float) * kCells * kNlo;
    slab = reinterpret_cast<Slab<kC>*>(p);
    p += sizeof(Slab<kC>);
    tmp = reinterpret_cast<typename SlabWork<kC>::Temp*>(p);
    p += kTemp;
    ids = reinterpret_cast<int*>(p);
    pos = ids + kSort;
    tbl = reinterpret_cast<float*>(pos + kSort);
  }
};
static_assert(BlockSmem<3>::kBytes <= 232448 && BlockSmem<1>::kBytes <= 232448,
              "a block's shared memory exceeds the H100's 227 KB");

// --------------------------------------------------------------------------
// K7: output-stationary, every row read once per slice
// --------------------------------------------------------------------------

struct LaneRows {
  const int32_t* pix;
  const float* w;
  const int32_t* wl;
  const int32_t* list;    // [nc]
  long long n_rows;
  long long rows_per_split;
  int32_t* matched;       // [n_rows] zeroed
};

// Rows r0 .. r0 + 3 (16-byte loads where all four lie before r_end: split
// starts are multiples of four rows).
__device__ __forceinline__ void load_rows(const LaneRows& rows, long long r0, long long r_end,
                                          int (&p)[4], float (&w)[4], int (&l)[4]) {
  if (r0 + 3 < r_end) {
    const int4 p4 = *reinterpret_cast<const int4*>(rows.pix + r0);
    const float4 w4 = *reinterpret_cast<const float4*>(rows.w + r0);
    const int4 l4 = *reinterpret_cast<const int4*>(rows.wl + r0);
    p[0] = p4.x; p[1] = p4.y; p[2] = p4.z; p[3] = p4.w;
    w[0] = w4.x; w[1] = w4.y; w[2] = w4.z; w[3] = w4.w;
    l[0] = l4.x; l[1] = l4.y; l[2] = l4.z; l[3] = l4.w;
    return;
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const bool in = r0 + q < r_end;
    p[q] = in ? rows.pix[r0 + q] : -1;
    w[q] = in ? rows.w[r0 + q] : 0.0f;
    l[q] = in ? rows.wl[r0 + q] : 0;
  }
}

// Add the first `fill` staged rows (the rest padded out) to the tile.
template <int kC>
__device__ __forceinline__ void flush_slab(const BlockSmem<kC>& sm, int fill) {
  for (int i = fill + threadIdx.x; i < kSlab; i += kThreads) sm.slab->key[i] = kNone;
  __syncthreads();
  add_slab<kC>(sm.tile, *sm.slab, *sm.tmp);
  __syncthreads();
}

template <int kC, int kTerms>
__global__ void __launch_bounds__(kThreads, 1)
    sandwich_lane_kernel(const LaneRows rows, const Pass a) {
  static_assert(kItems == 4, "K7 stages four rows a thread");
  constexpr int kS = kCells / kC, kSort = BlockSmem<kC>::kSort;
  extern __shared__ __align__(16) unsigned char smem[];
  const BlockSmem<kC> sm(smem);

  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * kS;
  for (int i = tid; i < kSort; i += kThreads) {
    const int k = m0 + i;
    sm.ids[i] = (i < kS && k < a.nc) ? list_id(rows.list[k]) : INT_MAX;
    sm.pos[i] = i;
  }
  load_table<kC>(a, sm.tbl);
  zero_tile<kC>(sm.tile);
  __syncthreads();
  sort_pairs(sm.ids, sm.pos, kSort);

  // The rows of the slice fill the slab in row order, 1024 rows of the
  // split at a time; a full slab is added to the tile and emptied.
  const long long r_begin = (long long)blockIdx.x * rows.rows_per_split;
  const long long r_end = min(rows.n_rows, r_begin + rows.rows_per_split);
  int p[4], l[4], pn[4], ln[4];
  float w[4], wn[4];
  load_rows(rows, r_begin + 4 * tid, r_end, pn, wn, ln);
  int fill = 0;
  for (long long base = r_begin; base < r_end; base += kSlab) {
    const long long r0 = base + 4 * tid;
#pragma unroll
    for (int q = 0; q < 4; ++q) { p[q] = pn[q]; w[q] = wn[q]; l[q] = ln[q]; }
    load_rows(rows, r0 + kSlab, r_end, pn, wn, ln);   // the next rows, in flight meanwhile
    int slot[4], mine = 0, before, total;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      slot[q] = r0 + q < r_end ? lookup(sm.ids, sm.pos, kSort, p[q] >> 7) : -1;
      if (slot[q] >= 0) rows.matched[r0 + q] = 1;
      mine += slot[q] >= 0;
    }
    typename SlabWork<kC>::Count(sm.tmp->count).ExclusiveSum(mine, before, total);
    if (fill + total > kSlab) {   // the same for the whole block
      flush_slab<kC>(sm, fill);
      fill = 0;
    }
    int at = fill + before;
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (slot[q] >= 0)
        stage_value<kC, kTerms>(*sm.slab, at++, slot[q] * kNlo + (p[q] & (kNlo - 1)), sm.tbl,
                                a.k_pool, w[q], l[q]);
    fill += total;
    __syncthreads();
  }
  if (fill > 0) flush_slab<kC>(sm, fill);
  write_tile<kC>(a, sm.tile, m0);
}

// --------------------------------------------------------------------------
// K8 and P1: group the rows by slice, then each block adds its slice's rows
// --------------------------------------------------------------------------

// The whole list, sorted by id with the list positions beside (one block).
__global__ void sandwich_sort_list_kernel(const int32_t* __restrict__ list, int nc, int n2,
                                          int* __restrict__ ids_out, int* __restrict__ pos_out) {
  extern __shared__ int sort_smem[];
  int* ids = sort_smem;
  int* pos = sort_smem + n2;
  for (int i = threadIdx.x; i < n2; i += blockDim.x) {
    ids[i] = i < nc ? list_id(list[i]) : INT_MAX;
    pos[i] = i;
  }
  __syncthreads();
  sort_pairs(ids, pos, n2);
  for (int i = threadIdx.x; i < n2; i += blockDim.x) {
    ids_out[i] = ids[i];
    pos_out[i] = pos[i];
  }
}

// One round of kThreads rows of a tile, one per thread in row order: the
// row's position among the tile's rows of its slice s (-1: none), from the
// running per-slice cursor, which then moves past the round's rows. Warp
// votes and a fixed sum over the warps in order: no atomics, so the
// positions keep row order inside each slice.
__device__ __forceinline__ int rank_round(int s, int n_slices, int* wcnt, int* cursor) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned peers = __match_any_sync(kFull, s);
  const int rank = __popc(peers & ((1u << lane) - 1u));
  if (s >= 0 && rank == 0) wcnt[warp * kMaxSlices + s] = __popc(peers);
  __syncthreads();
  int pos = -1;
  if (s >= 0) {
    pos = cursor[s] + rank;
    for (int w2 = 0; w2 < warp; ++w2) pos += wcnt[w2 * kMaxSlices + s];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n_slices; i += kThreads) {
    int t = 0;
    for (int w2 = 0; w2 < kThreads / 32; ++w2) {
      t += wcnt[w2 * kMaxSlices + i];
      wcnt[w2 * kMaxSlices + i] = 0;
    }
    cursor[i] += t;
  }
  __syncthreads();
  return pos;
}

struct Group {
  const int32_t* pix;
  const float* w;
  const int32_t* wl;
  long long n_rows;
  const int* ids;      // [n2] sorted list ids (K8), or null (P1: slot = chunk)
  const int* pos;      // [n2] their list positions
  int n2;
  int nc;
  int slice;           // S
  int n_slices;
  int n_tiles;
  int* slotlo;         // [n_rows] list position << 7 | lo, or -1
  int* counts;         // [n_slices * n_tiles + 1] counts, then offsets
  int32_t* matched;    // [n_rows] zeroed, or null
  int* gkey;           // [n_rows] the listed rows in slice order: slot << 7 | lo
  float* gw;           //          their weights
  int* gwl;            //          their pool indices
};

__device__ __forceinline__ void init_cursor(int n_slices, int* wcnt, int* cursor) {
  for (int i = threadIdx.x; i < (kThreads / 32) * kMaxSlices; i += kThreads) wcnt[i] = 0;
  for (int i = threadIdx.x; i < n_slices; i += kThreads) cursor[i] = 0;
  __syncthreads();
}

// Per row its list position (written to slotlo, and matched), per tile the
// rows of each slice.
__global__ void __launch_bounds__(kThreads) sandwich_group_count_kernel(const Group g) {
  __shared__ int wcnt[(kThreads / 32) * kMaxSlices];
  __shared__ int cursor[kMaxSlices];
  extern __shared__ int list_smem[];   // the sorted list (K8), searched for every row
  int* ids = list_smem;
  int* pos = list_smem + g.n2;
  if (g.ids != nullptr)
    for (int i = threadIdx.x; i < g.n2; i += kThreads) {
      ids[i] = g.ids[i];
      pos[i] = g.pos[i];
    }
  init_cursor(g.n_slices, wcnt, cursor);
  const long long t0 = (long long)blockIdx.x * kGroupTile;
  for (int q = 0; q < kGroupTile; q += kThreads) {
    const long long r = t0 + q + threadIdx.x;
    int s = -1;
    if (r < g.n_rows) {
      const int p = g.pix[r], chunk = p >> 7;
      int k;
      if (g.ids == nullptr)
        k = (chunk >= 0 && chunk < g.nc) ? chunk : -1;
      else
        k = lookup(ids, pos, g.n2, chunk);
      g.slotlo[r] = k >= 0 ? (k << 7) | (p & (kNlo - 1)) : -1;
      if (k >= 0) {
        s = k / g.slice;
        if (g.matched != nullptr) g.matched[r] = 1;
      }
    }
    rank_round(s, g.n_slices, wcnt, cursor);
  }
  for (int i = threadIdx.x; i < g.n_slices; i += kThreads)
    g.counts[i * g.n_tiles + blockIdx.x] = cursor[i];
}

// counts[0..m) into exclusive offsets in place, counts[m] = the total (one
// block of 1024 threads).
__global__ void sandwich_group_scan_kernel(int* counts, int m) {
  __shared__ int part[1024];
  const int tid = threadIdx.x;
  const int per = (m + 1023) / 1024;
  const int begin = min(m, tid * per), end = min(m, begin + per);
  int s = 0;
  for (int i = begin; i < end; ++i) s += counts[i];
  part[tid] = s;
  __syncthreads();
  for (int off = 1; off < 1024; off <<= 1) {
    const int v = tid >= off ? part[tid - off] : 0;
    __syncthreads();
    part[tid] += v;
    __syncthreads();
  }
  int run = part[tid] - s;
  for (int i = begin; i < end; ++i) {
    const int c = counts[i];
    counts[i] = run;
    run += c;
  }
  if (tid == 1023) counts[m] = part[1023];
}

// The stable scatter: each listed row's (slot, lo), weight and pool index at
// its slice's offset for this tile plus its rank in the tile.
__global__ void __launch_bounds__(kThreads) sandwich_group_scatter_kernel(const Group g) {
  __shared__ int wcnt[(kThreads / 32) * kMaxSlices];
  __shared__ int cursor[kMaxSlices];
  init_cursor(g.n_slices, wcnt, cursor);
  const long long t0 = (long long)blockIdx.x * kGroupTile;
  for (int q = 0; q < kGroupTile; q += kThreads) {
    const long long r = t0 + q + threadIdx.x;
    const int kl = r < g.n_rows ? g.slotlo[r] : -1;
    const int k = kl >> 7;
    const int s = kl >= 0 ? k / g.slice : -1;
    const int rank = rank_round(s, g.n_slices, wcnt, cursor);
    if (s >= 0) {
      const long long at = (long long)g.counts[s * g.n_tiles + blockIdx.x] + rank;
      g.gkey[at] = ((k - s * g.slice) << 7) | (kl & (kNlo - 1));
      g.gw[at] = g.w[r];
      g.gwl[at] = g.wl[r];
    }
  }
}

struct Grouped {
  const int* key;
  const float* w;
  const int* wl;
  const int* offsets;   // the scanned counts: slice s starts at offsets[s * n_tiles]
  int n_tiles;
};

// K8 proper: block (split j, slice s) adds the j-th of n_split equal parts
// of slice s's grouped rows into its tile.
template <int kC, int kTerms>
__global__ void __launch_bounds__(kThreads, 1)
    sandwich_sublane_kernel(const Grouped g, const Pass a) {
  constexpr int kS = kCells / kC;
  extern __shared__ __align__(16) unsigned char smem[];
  const BlockSmem<kC> sm(smem);

  const int s = blockIdx.y;
  const long long start = g.offsets[s * g.n_tiles], end = g.offsets[(s + 1) * g.n_tiles];
  const long long len = end - start;
  const long long a0 = start + len * blockIdx.x / gridDim.x;
  const long long a1 = start + len * (blockIdx.x + 1) / gridDim.x;
  load_table<kC>(a, sm.tbl);
  zero_tile<kC>(sm.tile);
  __syncthreads();
  // Row i of a slab is base + q * kThreads + threadIdx.x: the slab holds
  // the rows in order, which the sort keeps. The next slab's rows are loaded
  // while this one is added.
  int key[kItems], l[kItems];
  float w[kItems];
  auto load = [&](long long base) {
#pragma unroll
    for (int q = 0; q < kItems; ++q) {
      const long long r = base + q * kThreads + threadIdx.x;
      const bool in = r < a1;
      key[q] = in ? g.key[r] : kNone;
      w[q] = in ? g.w[r] : 0.0f;
      l[q] = in ? g.wl[r] : 0;
    }
  };
  load(a0);
  for (long long base = a0; base < a1; base += kSlab) {
#pragma unroll
    for (int q = 0; q < kItems; ++q)
      stage_value<kC, kTerms>(*sm.slab, q * kThreads + threadIdx.x, key[q], sm.tbl, a.k_pool,
                              w[q], l[q]);
    load(base + kSlab);
    __syncthreads();
    add_slab<kC>(sm.tile, *sm.slab, *sm.tmp);
    __syncthreads();
  }
  write_tile<kC>(a, sm.tile, s * kS);
}

// out = tile_in + partial[0] + partial[1] + ..., in that order.
__global__ void sandwich_reduce_kernel(const float* __restrict__ tile_in,
                                       const float* __restrict__ partial, int n_split,
                                       int nc, int nc_pad, int cw, float* __restrict__ out) {
  const long long total = (long long)nc * cw;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long split = (long long)nc_pad * cw;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < total; i += stride) {
    float s = 0.0f;
    for (int k = 0; k < n_split; ++k) s += partial[k * split + i];
    out[i] = tile_in != nullptr ? tile_in[i] + s : s;
  }
}

// --------------------------------------------------------------------------
// Launches
// --------------------------------------------------------------------------

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

cudaError_t reduce(const Pass& a, int c_out, int n_split, cudaStream_t stream) {
  if (n_split == 1) return cudaSuccess;   // the blocks wrote the tile
  const int cw = c_out * kNlo;
  const long long want = ((long long)a.nc * cw + 255) / 256;
  const int grid = (int)(want < 132LL * 8 ? want : 132LL * 8);
  sandwich_reduce_kernel<<<grid, 256, 0, stream>>>(a.tile_in, a.partial, n_split, a.nc,
                                                   a.nc_pad, cw, a.out);
  return cudaGetLastError();
}

bool pass_ok(const Pass& a, int c_out, int n_split) {
  return (c_out == 1 || c_out == 3) && a.k_pool >= 1 && a.k_pool <= kMaxPool && a.nc >= 1 &&
         a.nc_pad >= a.nc && a.nc_pad % (kCells / c_out) == 0 && n_split >= 1;
}

template <int kC, int kTerms>
cudaError_t launch_lane(const LaneRows& rows, const Pass& a, int n_split, cudaStream_t stream) {
  constexpr size_t smem = BlockSmem<kC>::kBytes;
  cudaError_t err = allow_smem(sandwich_lane_kernel<kC, kTerms>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(n_split, a.nc_pad / (kCells / kC));
  sandwich_lane_kernel<kC, kTerms><<<grid, kThreads, smem, stream>>>(rows, a);
  return cudaGetLastError();
}

template <int kC, int kTerms>
cudaError_t launch_sublane(const Grouped& g, const Pass& a, int n_split, cudaStream_t stream) {
  constexpr size_t smem = BlockSmem<kC>::kBytes;
  cudaError_t err = allow_smem(sandwich_sublane_kernel<kC, kTerms>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(n_split, a.nc_pad / (kCells / kC));
  sandwich_sublane_kernel<kC, kTerms><<<grid, kThreads, smem, stream>>>(g, a);
  return cudaGetLastError();
}

long long round4(long long n) { return (n + 3) / 4 * 4; }

// K8 and P1 (list null): group, add, reduce. The scratch holds, in ints and
// each part rounded up to 4: the sorted list ids and positions (2 * n2), the
// rows' list positions (N), the counts (slices * tiles + 1) and the grouped
// key, weight and pool index (3 * N).
cudaError_t run_sublane(const int32_t* pix, const float* w, const int32_t* wl,
                        const int32_t* list, long long n_rows, int c_out, int precise,
                        int n_split, const Pass& a, int32_t* matched, int* scratch,
                        long long scratch_ints, cudaStream_t stream) {
  const int slice = kCells / c_out;
  const int n_slices = a.nc_pad / slice;
  const long long n_tiles = (n_rows + kGroupTile - 1) / kGroupTile;
  const int n2 = pow2_at_least(a.nc);
  if (!pass_ok(a, c_out, n_split) || n_rows < 1 || n_slices > kMaxSlices ||
      (list != nullptr && a.nc > kMaxSorted) || n_tiles * n_slices >= INT_MAX / 2 ||
      n_rows >= INT_MAX / 2)
    return cudaErrorInvalidValue;
  const long long m = n_tiles * n_slices;
  const long long need = 2 * round4(n2) + 4 * round4(n_rows) + round4(m + 1);
  if (scratch_ints < need) return cudaErrorInvalidValue;
  Group g{pix, w, wl, n_rows, nullptr, nullptr, n2, a.nc, slice, n_slices, (int)n_tiles,
          nullptr, nullptr, matched, nullptr, nullptr, nullptr};
  int* at = scratch;
  int* ids = at; at += round4(n2);
  int* pos = at; at += round4(n2);
  g.slotlo = at; at += round4(n_rows);
  g.counts = at; at += round4(m + 1);
  g.gkey = at; at += round4(n_rows);
  g.gw = reinterpret_cast<float*>(at); at += round4(n_rows);
  g.gwl = at;
  cudaError_t err;
  if (list != nullptr) {
    const size_t smem = sizeof(int) * 2 * n2;
    if ((err = allow_smem(sandwich_sort_list_kernel, smem)) != cudaSuccess) return err;
    sandwich_sort_list_kernel<<<1, 1024, smem, stream>>>(list, a.nc, n2, ids, pos);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    g.ids = ids;
    g.pos = pos;
  }
  const size_t list_bytes = list != nullptr ? sizeof(int) * 2 * n2 : 0;
  if ((err = allow_smem(sandwich_group_count_kernel, list_bytes)) != cudaSuccess) return err;
  sandwich_group_count_kernel<<<(unsigned)n_tiles, kThreads, list_bytes, stream>>>(g);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  sandwich_group_scan_kernel<<<1, 1024, 0, stream>>>(g.counts, (int)m);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  sandwich_group_scatter_kernel<<<(unsigned)n_tiles, kThreads, 0, stream>>>(g);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const Grouped gr{g.gkey, g.gw, g.gwl, g.counts, (int)n_tiles};
  if (c_out == 3)
    err = precise ? launch_sublane<3, 2>(gr, a, n_split, stream)
                  : launch_sublane<3, 1>(gr, a, n_split, stream);
  else
    err = precise ? launch_sublane<1, 2>(gr, a, n_split, stream)
                  : launch_sublane<1, 1>(gr, a, n_split, stream);
  if (err != cudaSuccess) return err;
  return reduce(a, c_out, n_split, stream);
}

}  // namespace

// K7: output-stationary, each block a slice of the list over a split of rows.
extern "C" int iht_sandwich_lane(const void* pix, const void* w, const void* wl,
                                 const void* tbl, const void* list, long long n_rows, int nc,
                                 int c_out, int k_pool, int precise, int n_split,
                                 long long rows_per_split, int nc_pad, const void* tile_in,
                                 void* partial, void* matched, void* out, void* stream) {
  const Pass a{(const float*)tbl, nc, k_pool, nc_pad, (const float*)tile_in, (float*)partial,
               (float*)out};
  const LaneRows rows{(const int32_t*)pix, (const float*)w, (const int32_t*)wl,
                      (const int32_t*)list, n_rows, rows_per_split, (int32_t*)matched};
  if (!pass_ok(a, c_out, n_split) || n_rows < 1 || rows_per_split < 1 || rows_per_split % 4 ||
      (long long)n_split * rows_per_split < n_rows)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  if (c_out == 3)
    err = precise ? launch_lane<3, 2>(rows, a, n_split, s) : launch_lane<3, 1>(rows, a, n_split, s);
  else
    err = precise ? launch_lane<1, 2>(rows, a, n_split, s) : launch_lane<1, 1>(rows, a, n_split, s);
  if (err == cudaSuccess) err = reduce(a, c_out, n_split, s);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// K8: the rows grouped by slice first, then each block reads its slice's rows once.
extern "C" int iht_sandwich_sublane(const void* pix, const void* w, const void* wl,
                                    const void* tbl, const void* list, long long n_rows,
                                    int nc, int c_out, int k_pool, int precise, int n_split,
                                    int nc_pad, const void* tile_in, void* partial,
                                    void* matched, void* out, void* scratch,
                                    long long scratch_ints, void* stream) {
  const Pass a{(const float*)tbl, nc, k_pool, nc_pad, (const float*)tile_in, (float*)partial,
               (float*)out};
  const cudaError_t err = run_sublane(
      (const int32_t*)pix, (const float*)w, (const int32_t*)wl, (const int32_t*)list, n_rows,
      c_out, precise, n_split, a, (int32_t*)matched, (int*)scratch, scratch_ints,
      (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// P1: K8 with the list 0, 1, ..., nc - 1 (slot = chunk); no tile or matched.
extern "C" int iht_sandwich_iota(const void* pix, const void* w, const void* wl,
                                 const void* tbl, long long n_rows, int nc, int c_out,
                                 int k_pool, int n_split, int nc_pad, void* partial, void* out,
                                 void* scratch, long long scratch_ints, void* stream) {
  const Pass a{(const float*)tbl, nc, k_pool, nc_pad, nullptr, (float*)partial, (float*)out};
  const cudaError_t err = run_sublane((const int32_t*)pix, (const float*)w, (const int32_t*)wl,
                                      nullptr, n_rows, c_out, 0, n_split, a, nullptr,
                                      (int*)scratch, scratch_ints, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The dynamic shared memory of a K7 or K8 block, in bytes.
extern "C" long long iht_sandwich_smem(int c_out, int precise) {
  (void)precise;   // the staged value is one float either way
  return (long long)(c_out == 3 ? BlockSmem<3>::kBytes : BlockSmem<1>::kBytes);
}
