// Stable LSD radix sort of (u32 key, 32-bit payload) pairs over the key's
// bits [0, end_bit), for Hopper (sm_90a): the spectral folds' sort.
//
// Replaces no Pallas kernel. The JAX package sorts the fold's rows with
// XLA's lax.sort(..., num_keys=1) (ice_halo_sim_tpu/core/accum.py); the port
// sorted one int64 per row with torch.sort (the key in the high word, the
// weight's bits in the low word), which cub sorts over all 64 bits with an
// int64 index payload that nothing reads: eight digit passes of 32 B a row,
// and a dozen elementwise kernels to pack and unpack. Here only the key's
// own bits order the rows and the weight rides along: ceil(end_bit / 8)
// passes of 16 B a row (key and payload, read and written), after one 4 B
// read of the keys that counts every pass's digits.
//
// Bound: memory (16 B a row a pass), but at the fold's sizes (1-3 M rows)
// the passes are held by the ranking's instructions and the look-back's
// round trips; PERF.md has the measurements. Two kernels:
//   histogram (one launch): four blocks per multiprocessor read the keys
//     with 16-byte loads and count each pass's digits in shared memory (a
//     warp whose lanes share a digit, as the fold's P marker rows share
//     their low digit, adds them with one atomic), then add their nonzero
//     counts into [passes][256] global counts. Integer counts: exact in any
//     order.
//   onesweep (one launch a pass): a block takes its tile of 3072 rows from
//     an atomic counter (so every earlier tile is already running) and loads
//     it warp-striped (row = warp * 384 + item * 32 + lane, all loads issued
//     before any is used). It counts the tile's digits and publishes the
//     counts at once, issues the loads of the nearest 4 earlier tiles'
//     words, and ranks the items by digit in the warp-striped order, which
//     is the rows' order: per item, a ballot match finds the lanes with the
//     same digit, and one shared atomic per digit group into the warp's own
//     counts gives the group's first rank, so equal digits keep their input
//     order (stable). It stages keys and payloads in shared memory in their
//     sorted order within the tile, then takes each digit's global offset by
//     that decoupled look-back, 4 tiles a step down to the nearest inclusive
//     word (flag and count in one 32-bit word; integer sums, so the result
//     does not depend on timing; tile 0 starts from the histogram's
//     exclusive sums), and writes the tile out, consecutive threads on
//     consecutive rows of a digit's run.
// Passes ping-pong between the output pair and a second pair; the input is
// read, never written. Digits are ceil(end_bit / passes) or one bit fewer
// wide, the lowest first. The result is the stable sort by the masked key:
// the same bits on every run.
//
// Every entry point returns cudaGetLastError() after its launches.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 12;
constexpr int kTile = kThreads * kItems;  // rows a onesweep block sorts
constexpr int kWarpRows = 32 * kItems;
constexpr int kMaxBits = 8;
constexpr int kRadix = 1 << kMaxBits;     // digit counts kept per pass
constexpr int kMaxPasses = 4;
constexpr int kHistItems = 4;             // keys a histogram thread loads at once
constexpr int kLook = 4;                  // earlier tiles a look-back step reads
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr unsigned kAgg = 1u << 30;       // the tile's own count
constexpr unsigned kIncl = 2u << 30;      // the count of this tile and every earlier one
constexpr unsigned kValue = kAgg - 1;
// State words before the look-back words: the counts, the tile counters.
constexpr long long kHead = kMaxPasses * kRadix + kMaxPasses;

static_assert(kThreads == kRadix, "one thread per digit");

struct Plan {
  int passes;
  int shift[kMaxPasses];
  int bits[kMaxPasses];
};

Plan make_plan(int end_bit) {
  Plan p{};
  p.passes = (end_bit + kMaxBits - 1) / kMaxBits;
  const int base = end_bit / p.passes, extra = end_bit % p.passes;
  for (int i = 0, s = 0; i < p.passes; ++i) {
    p.bits[i] = base + (i < extra);
    p.shift[i] = s;
    s += p.bits[i];
  }
  return p;
}

// The lanes whose `bits`-bit digit equals this lane's (bits is warp-uniform).
__device__ __forceinline__ unsigned match_digit(unsigned d, int bits) {
  unsigned m = kFull;
#pragma unroll
  for (int b = 0; b < kMaxBits; ++b) {
    if (b < bits) {
      const bool set = (d >> b) & 1u;
      const unsigned v = __ballot_sync(kFull, set);
      m &= set ? v : ~v;
    }
  }
  return m;
}

// Adds one to counts[d] for each lane that is `in`: a warp whose lanes all
// share d (as the fold's P marker rows share their low digit) adds them
// with one atomic.
__device__ __forceinline__ void count_digit(unsigned d, bool in, int lane, unsigned* counts) {
  const unsigned live = __ballot_sync(kFull, in);
  const unsigned d0 = __shfl_sync(kFull, d, 0);
  if (__all_sync(kFull, !in || d == d0)) {
    if (lane == 0 && live) atomicAdd(&counts[d0], (unsigned)__popc(live));
  } else if (in) {
    atomicAdd(&counts[d], 1u);
  }
}

__global__ void __launch_bounds__(kThreads)
radix_histogram_kernel(const uint32_t* __restrict__ keys, long long M, Plan plan,
                       unsigned* __restrict__ hist) {
  __shared__ unsigned s_hist[kMaxPasses][kRadix];
  const int tid = threadIdx.x, lane = tid & 31;
  for (int i = tid; i < kMaxPasses * kRadix; i += kThreads) (&s_hist[0][0])[i] = 0;
  __syncthreads();
  const bool vec = (reinterpret_cast<uintptr_t>(keys) & 15) == 0;
  const long long step = (long long)kThreads * kHistItems;
  for (long long base = blockIdx.x * step; base < M; base += gridDim.x * step) {
    const long long r0 = base + (long long)tid * kHistItems;
    uint32_t k[kHistItems];
    if (vec && r0 + kHistItems <= M) {
      const uint4 v = *reinterpret_cast<const uint4*>(keys + r0);
      k[0] = v.x; k[1] = v.y; k[2] = v.z; k[3] = v.w;
    } else {
#pragma unroll
      for (int j = 0; j < kHistItems; ++j) k[j] = r0 + j < M ? keys[r0 + j] : 0u;
    }
#pragma unroll
    for (int j = 0; j < kHistItems; ++j) {
#pragma unroll
      for (int p = 0; p < kMaxPasses; ++p) {
        if (p >= plan.passes) break;
        count_digit((k[j] >> plan.shift[p]) & ((1u << plan.bits[p]) - 1), r0 + j < M, lane,
                    s_hist[p]);
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int p = 0; p < kMaxPasses; ++p) {
    if (p >= plan.passes) break;
    if (tid < (1 << plan.bits[p]) && s_hist[p][tid])
      atomicAdd(hist + p * kRadix + tid, s_hist[p][tid]);
  }
}

// Exclusive sum over the block of one value a thread; every thread calls it.
__device__ __forceinline__ unsigned block_exclusive(unsigned v, unsigned* s_tmp) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned x = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const unsigned y = __shfl_up_sync(kFull, x, off);
    if (lane >= off) x += y;
  }
  if (lane == 31) s_tmp[warp] = x;
  __syncthreads();
  unsigned before = 0;
  for (int q = 0; q < warp; ++q) before += s_tmp[q];
  __syncthreads();  // s_tmp is free again
  return before + x - v;
}

__device__ __forceinline__ unsigned load_word(const unsigned* p) {
  return *reinterpret_cast<const volatile unsigned*>(p);
}

__device__ __forceinline__ void store_word(unsigned* p, unsigned v) {
  *reinterpret_cast<volatile unsigned*>(p) = v;
}

__global__ void __launch_bounds__(kThreads)
radix_onesweep_kernel(const uint32_t* __restrict__ kin, const uint32_t* __restrict__ vin,
                      uint32_t* __restrict__ kout, uint32_t* __restrict__ vout, long long M,
                      int shift, int bits, const unsigned* __restrict__ hist,
                      unsigned* status, unsigned* counter) {
  __shared__ uint32_t s_key[kTile];
  __shared__ uint32_t s_val[kTile];
  __shared__ unsigned s_warp[kWarps][kRadix];  // per warp: digit counts, then offsets
  __shared__ unsigned s_count[kRadix];         // the tile's count of each digit
  __shared__ unsigned s_first[kRadix];         // a digit's first place in the sorted tile
  __shared__ int s_dst[kRadix];                // a digit's first global row less s_first
  __shared__ unsigned s_tmp[kWarps];
  __shared__ int s_tile;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned radix = 1u << bits, mask = radix - 1;
  if (tid == 0) s_tile = (int)atomicAdd(counter, 1u);
  for (int i = tid; i < kWarps * kRadix; i += kThreads) (&s_warp[0][0])[i] = 0;
  s_count[tid] = 0;
  __syncthreads();
  const int tile = s_tile;
  // Rows past M take the last digit and the last places of the last tile,
  // behind every row of it, and are not written.
  const long long r0 = (long long)tile * kTile + warp * kWarpRows + lane;
  uint32_t k[kItems], v[kItems];
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const long long r = r0 + j * 32;
    k[j] = r < M ? kin[r] : 0xFFFFFFFFu;
    v[j] = r < M ? vin[r] : 0u;
  }

  // The tile's count of each digit, published before the ranking, so that
  // the later tiles' look-back finds it early.
#pragma unroll
  for (int j = 0; j < kItems; ++j) count_digit((k[j] >> shift) & mask, true, lane, s_count);
  __syncthreads();
  // Thread d publishes digit d's count and loads the nearest kLook earlier
  // tiles' words, read after the ranking.
  const unsigned d = tid;
  const unsigned count = d < radix ? s_count[d] : 0u;
  unsigned w[kLook];
#pragma unroll
  for (int q = 0; q < kLook; ++q) w[q] = 0;
  if (d < radix && tile > 0) {
    store_word(status + (long long)tile * kRadix + d, kAgg | count);
#pragma unroll
    for (int q = 0; q < kLook; ++q)
      if (tile - 1 - q >= 0) w[q] = load_word(status + (long long)(tile - 1 - q) * kRadix + d);
  }

  // An item's rank among the warp's items of its digit: the count of its
  // digit in the warp's earlier rounds, then the equal lanes below it.
  const unsigned below = (1u << lane) - 1;
  unsigned rank[kItems];
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const unsigned dj = (k[j] >> shift) & mask;
    const unsigned peers = match_digit(dj, bits);
    const int leader = __ffs(peers) - 1;
    unsigned old = 0;
    if (lane == leader) old = atomicAdd(&s_warp[warp][dj], (unsigned)__popc(peers));
    rank[j] = __shfl_sync(kFull, old, leader) + __popc(peers & below);
  }
  __syncthreads();

  // Thread d: digit d's count per warp into the warps' offsets; the digits'
  // first places in the sorted tile; for tile 0 the histogram's exclusive
  // sums, where every digit's global rows start.
  if (d < radix) {
    unsigned sum = 0;
    for (int i = 0; i < kWarps; ++i) {
      const unsigned c = s_warp[i][d];
      s_warp[i][d] = sum;
      sum += c;
    }
  }
  const unsigned first = block_exclusive(count, s_tmp);
  s_first[d] = first;
  unsigned before = 0;
  if (tile == 0) before = block_exclusive(d < radix ? hist[d] : 0u, s_tmp);
  __syncthreads();

  // The tile in its sorted order in shared memory, while the look-back's
  // first loads are in flight.
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const unsigned dj = (k[j] >> shift) & mask;
    const unsigned at = s_first[dj] + s_warp[warp][dj] + rank[j];
    s_key[at] = k[j];
    s_val[at] = v[j];
  }

  // Digit d's first global row: the earlier tiles' words, kLook at a time
  // (independent loads), added from the nearest back to the first inclusive
  // one.
  if (d < radix) {
    bool found = tile == 0;
    for (long long hi = (long long)tile - 1; !found && hi >= 0; hi -= kLook) {
      if (hi != tile - 1) {
#pragma unroll
        for (int q = 0; q < kLook; ++q)
          w[q] = hi - q >= 0 ? load_word(status + (hi - q) * kRadix + d) : 0u;
      }
#pragma unroll
      for (int q = 0; q < kLook; ++q) {
        if (found || hi - q < 0) break;
        while (!(w[q] & (kAgg | kIncl))) w[q] = load_word(status + (hi - q) * kRadix + d);
        before += w[q] & kValue;
        found = (w[q] & kIncl) != 0;
      }
    }
    store_word(status + (long long)tile * kRadix + d, kIncl | (before + count));
    s_dst[d] = (int)before - (int)first;
  }
  __syncthreads();

  // Out, consecutive threads on consecutive rows of a digit's run.
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int i = j * kThreads + tid;
    const uint32_t key = s_key[i];
    const long long dst = (long long)s_dst[(key >> shift) & mask] + i;
    if (dst < M) {
      kout[dst] = key;
      vout[dst] = s_val[i];
    }
  }
}

}  // namespace

// Sorts M (key, payload) pairs by key bits [0, end_bit), stably, into
// (k_out, v_out) in `passes` digit passes (ceil(end_bit / 8): the caller's
// count, checked). k_alt / v_alt: M words each, unused (may be null) with
// one pass; state: 4 * 256 + 4 + passes * ceil(M / 3072) * 256 zeroed words.
extern "C" int iht_radix_sort_pairs(const void* keys, const void* vals, long long M,
                                    int end_bit, int passes, void* k_out, void* v_out,
                                    void* k_alt, void* v_alt, void* state,
                                    long long state_words, void* stream) {
  const long long n_tiles = (M + kTile - 1) / kTile;
  if (end_bit < 1 || end_bit > 32 || passes != make_plan(end_bit).passes || M < 0 ||
      M + kTile >= (long long)kAgg || state_words < kHead + passes * n_tiles * kRadix)
    return (int)cudaErrorInvalidValue;
  if (M == 0) return (int)cudaGetLastError();
  const Plan plan = make_plan(end_bit);
  if (plan.passes > 1 && (!k_alt || !v_alt)) return (int)cudaErrorInvalidValue;
  unsigned* hist = static_cast<unsigned*>(state);
  unsigned* counters = hist + kMaxPasses * kRadix;
  unsigned* status = hist + kHead;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return (int)cudaGetLastError();
  const long long need = (M + (long long)kThreads * kHistItems - 1) / ((long long)kThreads * kHistItems);
  const long long hist_blocks = need < 4LL * sms ? need : 4LL * sms;
  radix_histogram_kernel<<<(unsigned)hist_blocks, kThreads, 0, s>>>(
      static_cast<const uint32_t*>(keys), M, plan, hist);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const uint32_t* kin = static_cast<const uint32_t*>(keys);
  const uint32_t* vin = static_cast<const uint32_t*>(vals);
  for (int p = 0; p < plan.passes; ++p) {
    const bool last_pair = (plan.passes - 1 - p) % 2 == 0;
    uint32_t* ko = static_cast<uint32_t*>(last_pair ? k_out : k_alt);
    uint32_t* vo = static_cast<uint32_t*>(last_pair ? v_out : v_alt);
    radix_onesweep_kernel<<<(unsigned)n_tiles, kThreads, 0, s>>>(
        kin, vin, ko, vo, M, plan.shift[p], plan.bits[p], hist + p * kRadix,
        status + p * n_tiles * kRadix, counters + p);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    kin = ko;
    vin = vo;
  }
  return (int)cudaGetLastError();
}
