// Fused basis expansion + segmented inclusive scan for Hopper (sm_90a), in
// one pass over the rows, with the marker extraction folded in.
//
// Replaces K4, ice_halo_sim_tpu/core/pallas_scan.py: fused_scan_call (:252)
// and its kernel _scan_kernel (:144), and on the spectral folds the marker
// extraction after it, ice_halo_sim_tpu/core/accum.py: _marker_extract
// (pallas_ops.pack_payload_blocks + scatter_blocks_multi). Over the sorted
// fold rows:
//   chan[c][i] = tbl[(key >> 1) & (K-1)][c] * w        (float32 product)
//   run[c][i]  = inclusive sum of chan[c] over the run of equal key >> shift
//                that row i belongs to, carried across the whole array
// and one of two outputs:
//   per row:  out[c][i] = run[c][i]; key2[i] = key >> shift at marker rows
//             (low bits 2K-1), else 0xFFFFFFFF (optional);
//   extract:  img[pix][c] = run[c][i] at each marker row i whose pixel
//             pix = key >> shift is < P. Every pixel has one marker, the last
//             row of its run, so its run value is the pixel's total and every
//             store has its own address (img is zeroed by the caller); this
//             is what the TPU's pack + block scatter of the markers computes.
//
// The TPU kernel carries the run sum across its sequential grid in VMEM
// scratch. Here tiles of 2048 rows run in no order, so the carry comes from
// the tiles before: each block takes its tile id from an atomic counter (so
// every earlier tile is already running), reduces its tile, publishes the
// tile's aggregate (does a run start in the tile; the sum from its last run
// start, or its first row, to its end), and then one warp looks back over
// the predecessors' aggregates down to the tile that holds the run's first
// row and adds them in a fixed order (a tree over each window of 32 tiles,
// windows from the nearest back). No predecessor's running prefix is used,
// so the result does not depend on timing: the same inputs give the same
// bits on every run, with no atomics on values. Sums are float64, rounded
// once to float32 at the output, as the plain version does.
//
// Bound: memory. Each thread loads its 8 consecutive rows as two 16-byte
// loads of keys and two of weights (neighbouring threads on neighbouring
// addresses, all issued before any is used), gets its neighbour's key by a
// shuffle, and scans inside the block by warp shuffles and one level across
// warps. Keys and weights are read once (8 B a row); the extract writes 12 B
// per pixel, the per-row form 16 B per row. The [K, 3] table lives in shared
// memory (rows of a run carry different wavelengths).
//
// Every entry point returns cudaGetLastError() after its launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 8;
constexpr int kTile = kThreads * kItems;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xFFFFFFFFu;

struct Agg {
  int f;             // a run starts in the span
  double s0, s1, s2; // sum from the span's last run start (or its first row)
};

// a, then b.
__device__ __forceinline__ Agg combine(const Agg& a, const Agg& b) {
  if (b.f) return b;
  return Agg{a.f, a.s0 + b.s0, a.s1 + b.s1, a.s2 + b.s2};
}

__device__ __forceinline__ Agg shfl_up(const Agg& x, int off) {
  return Agg{__shfl_up_sync(kFull, x.f, off), __shfl_up_sync(kFull, x.s0, off),
             __shfl_up_sync(kFull, x.s1, off), __shfl_up_sync(kFull, x.s2, off)};
}

template <bool kExtract>
__global__ void __launch_bounds__(kThreads)
scan_kernel(const uint32_t* __restrict__ sk, const float* __restrict__ sw,
            const float* __restrict__ tbl, int K, int shift, long long M,
            int* __restrict__ state, double* __restrict__ agg,
            float* __restrict__ c0, float* __restrict__ c1, float* __restrict__ c2,
            uint32_t* __restrict__ key2, float* __restrict__ img, int P) {
  extern __shared__ float stbl[];
  __shared__ int s_tile, s_need;
  __shared__ Agg s_warp[kWarps];
  __shared__ double s_carry[3];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // state[0]: the tile counter; state[1 + t]: tile t's aggregate is
  // published (1: no run starts in the tile, 2: one does). Zeroed per call.
  int* ctr = state;
  volatile int* status = state + 1;
  if (tid == 0) s_tile = atomicAdd(ctr, 1);
  for (int i = tid; i < 3 * K; i += kThreads) stbl[i] = tbl[i];
  __syncthreads();
  const int tile = s_tile;
  const long long r0 = (long long)tile * kTile + (long long)tid * kItems;

  uint32_t k[kItems];
  float w[kItems];
  const bool vec =
      r0 + kItems <= M &&
      ((reinterpret_cast<uintptr_t>(sk) | reinterpret_cast<uintptr_t>(sw)) & 15) == 0;
  if (vec) {
    const uint4 ka = *reinterpret_cast<const uint4*>(sk + r0);
    const uint4 kb = *reinterpret_cast<const uint4*>(sk + r0 + 4);
    const float4 wa = *reinterpret_cast<const float4*>(sw + r0);
    const float4 wb = *reinterpret_cast<const float4*>(sw + r0 + 4);
    k[0] = ka.x; k[1] = ka.y; k[2] = ka.z; k[3] = ka.w;
    k[4] = kb.x; k[5] = kb.y; k[6] = kb.z; k[7] = kb.w;
    w[0] = wa.x; w[1] = wa.y; w[2] = wa.z; w[3] = wa.w;
    w[4] = wb.x; w[5] = wb.y; w[6] = wb.z; w[7] = wb.w;
  } else {
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const bool in = r0 + j < M;
      k[j] = in ? sk[r0 + j] : 0xFFFFFFFFu;
      w[j] = in ? sw[r0 + j] : 0.0f;
    }
  }
  // The key before this thread's first row: the previous lane's last key,
  // or for lane 0 a load (row 0 starts a run whatever it is compared with).
  uint32_t kprev = __shfl_up_sync(kFull, k[kItems - 1], 1);
  if (lane == 0) kprev = (r0 > 0 && r0 <= M) ? sk[r0 - 1] : ~k[0];

  const int kmask = K - 1;
  unsigned flags = 0;
  Agg a{0, 0.0, 0.0, 0.0};
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const uint32_t before = j == 0 ? kprev : k[j - 1];
    const bool f = r0 + j < M && (r0 + j == 0 || (k[j] >> shift) != (before >> shift));
    flags |= (unsigned)f << j;
    const int wl = (int)((k[j] >> 1) & (uint32_t)kmask);
    const double v0 = (double)(stbl[3 * wl] * w[j]);
    const double v1 = (double)(stbl[3 * wl + 1] * w[j]);
    const double v2 = (double)(stbl[3 * wl + 2] * w[j]);
    if (r0 + j >= M) continue;
    if (f) a = Agg{1, v0, v1, v2};
    else { a.s0 += v0; a.s1 += v1; a.s2 += v2; }
  }

  // Inclusive scan in the warp, then the warps' totals in order.
  Agg x = a;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const Agg y = shfl_up(x, off);
    if (lane >= off) x = combine(y, x);
  }
  Agg excl = shfl_up(x, 1);
  if (lane == 0) excl = Agg{0, 0.0, 0.0, 0.0};
  if (lane == 31) s_warp[warp] = x;
  if (tid == 0) s_need = tile > 0 && !(flags & 1u);
  __syncthreads();
  Agg before{0, 0.0, 0.0, 0.0};
  for (int q = 0; q < warp; ++q) before = combine(before, s_warp[q]);
  excl = combine(before, excl);

  if (tid == 0) {
    Agg tot{0, 0.0, 0.0, 0.0};
    for (int q = 0; q < kWarps; ++q) tot = combine(tot, s_warp[q]);
    agg[3 * (long long)tile] = tot.s0;
    agg[3 * (long long)tile + 1] = tot.s1;
    agg[3 * (long long)tile + 2] = tot.s2;
    __threadfence();
    status[tile] = tot.f ? 2 : 1;
  }

  // The carry into the tile's first run: the predecessors' aggregates back
  // to the nearest tile in which a run starts (tile 0 always has one).
  if (warp == 0 && s_need) {
    double t0 = 0.0, t1 = 0.0, t2 = 0.0;
    for (int hi = tile - 1;; hi -= 32) {
      const int p = hi - lane;
      int st = 2;
      if (p >= 0) {
        do { st = status[p]; } while (st == 0);
      }
      __threadfence();
      const unsigned starts = __ballot_sync(kFull, st == 2);
      const int stop = starts ? __ffs(starts) - 1 : 31;
      double a0 = 0.0, a1 = 0.0, a2 = 0.0;
      if (p >= 0 && lane <= stop) {
        a0 = __ldcg(agg + 3 * (long long)p);
        a1 = __ldcg(agg + 3 * (long long)p + 1);
        a2 = __ldcg(agg + 3 * (long long)p + 2);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        a0 += __shfl_down_sync(kFull, a0, off);
        a1 += __shfl_down_sync(kFull, a1, off);
        a2 += __shfl_down_sync(kFull, a2, off);
      }
      t0 += a0; t1 += a1; t2 += a2;
      if (starts) break;
    }
    if (lane == 0) {
      s_carry[0] = t0; s_carry[1] = t1; s_carry[2] = t2;
    }
  }
  __syncthreads();
  double run0, run1, run2;
  if (excl.f) {
    run0 = excl.s0; run1 = excl.s1; run2 = excl.s2;
  } else if (s_need) {
    run0 = s_carry[0] + excl.s0; run1 = s_carry[1] + excl.s1; run2 = s_carry[2] + excl.s2;
  } else {
    run0 = excl.s0; run1 = excl.s1; run2 = excl.s2;
  }

  const uint32_t mmask = (uint32_t)(2 * K - 1);
  float o0[kItems], o1[kItems], o2[kItems];
  uint32_t o3[kItems];
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int wl = (int)((k[j] >> 1) & (uint32_t)kmask);
    const double v0 = (double)(stbl[3 * wl] * w[j]);
    const double v1 = (double)(stbl[3 * wl + 1] * w[j]);
    const double v2 = (double)(stbl[3 * wl + 2] * w[j]);
    if ((flags >> j) & 1u) {
      run0 = v0; run1 = v1; run2 = v2;
    } else {
      run0 += v0; run1 += v1; run2 += v2;
    }
    o0[j] = (float)run0; o1[j] = (float)run1; o2[j] = (float)run2;
    const bool marker = (k[j] & mmask) == mmask;
    o3[j] = marker ? (k[j] >> shift) : 0xFFFFFFFFu;
    if (kExtract && marker && r0 + j < M && (k[j] >> shift) < (uint32_t)P) {
      float* dst = img + 3 * (long long)(k[j] >> shift);
      dst[0] = o0[j]; dst[1] = o1[j]; dst[2] = o2[j];
    }
  }
  if (kExtract) return;
  const bool vec_out = r0 + kItems <= M &&
      ((reinterpret_cast<uintptr_t>(c0) | reinterpret_cast<uintptr_t>(c1) |
        reinterpret_cast<uintptr_t>(c2) | reinterpret_cast<uintptr_t>(key2)) & 15) == 0;
  if (vec_out) {
    *reinterpret_cast<float4*>(c0 + r0) = make_float4(o0[0], o0[1], o0[2], o0[3]);
    *reinterpret_cast<float4*>(c0 + r0 + 4) = make_float4(o0[4], o0[5], o0[6], o0[7]);
    *reinterpret_cast<float4*>(c1 + r0) = make_float4(o1[0], o1[1], o1[2], o1[3]);
    *reinterpret_cast<float4*>(c1 + r0 + 4) = make_float4(o1[4], o1[5], o1[6], o1[7]);
    *reinterpret_cast<float4*>(c2 + r0) = make_float4(o2[0], o2[1], o2[2], o2[3]);
    *reinterpret_cast<float4*>(c2 + r0 + 4) = make_float4(o2[4], o2[5], o2[6], o2[7]);
    if (key2) {
      *reinterpret_cast<uint4*>(key2 + r0) = make_uint4(o3[0], o3[1], o3[2], o3[3]);
      *reinterpret_cast<uint4*>(key2 + r0 + 4) = make_uint4(o3[4], o3[5], o3[6], o3[7]);
    }
  } else {
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      if (r0 + j >= M) break;
      c0[r0 + j] = o0[j]; c1[r0 + j] = o1[j]; c2[r0 + j] = o2[j];
      if (key2) key2[r0 + j] = o3[j];
    }
  }
}

template <bool kExtract>
void launch(const void* sk, const void* sw, const void* tbl, int K, int shift, long long M,
            void* state, void* agg, void* c0, void* c1, void* c2, void* key2, void* img,
            int P, void* stream) {
  const long long n_tiles = (M + kTile - 1) / kTile;
  const size_t smem = (size_t)3 * K * sizeof(float);
  if (smem > 40 * 1024 &&
      cudaFuncSetAttribute(scan_kernel<kExtract>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem) != cudaSuccess)
    return;
  scan_kernel<kExtract><<<(unsigned)n_tiles, kThreads, smem, (cudaStream_t)stream>>>(
      (const uint32_t*)sk, (const float*)sw, (const float*)tbl, K, shift, M, (int*)state,
      (double*)agg, (float*)c0, (float*)c1, (float*)c2, (uint32_t*)key2, (float*)img, P);
}

}  // namespace

// Per-row form: out[c][i] and, when key2 is not null, the marker key.
// state: int32 [n_tiles + 1] zeroed; agg: float64 [3 * n_tiles].
extern "C" int iht_fused_scan(const void* sk, const void* sw, const void* tbl, int K,
                              int shift, long long M, void* c0, void* c1, void* c2,
                              void* key2, void* state, void* agg, void* stream) {
  if (M <= 0) return (int)cudaGetLastError();
  if ((M + kTile - 1) / kTile > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  launch<false>(sk, sw, tbl, K, shift, M, state, agg, c0, c1, c2, key2, nullptr, 0, stream);
  return (int)cudaGetLastError();
}

// Extract form: each marker row's run value into img [P, 3] (zeroed).
extern "C" int iht_fused_scan_extract(const void* sk, const void* sw, const void* tbl,
                                      int K, int shift, long long M, void* img, int P,
                                      void* state, void* agg, void* stream) {
  if (M <= 0) return (int)cudaGetLastError();
  if ((M + kTile - 1) / kTile > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  launch<true>(sk, sw, tbl, K, shift, M, state, agg, nullptr, nullptr, nullptr, nullptr, img,
               P, stream);
  return (int)cudaGetLastError();
}
