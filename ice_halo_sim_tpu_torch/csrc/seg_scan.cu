// Fused basis expansion + segmented inclusive scan for Hopper (sm_90a).
//
// Replaces K4, ice_halo_sim_tpu/core/pallas_scan.py: fused_scan_call (:252)
// and its kernel _scan_kernel (:144). Over the sorted fold rows:
//   chan[c][i] = tbl[(key >> 1) & (K-1)][c] * w        (float32 product)
//   out[c][i]  = inclusive sum of chan[c] over the run of equal key >> shift
//                that row i belongs to, carried across the whole array
//   key2[i]    = key >> shift at marker rows (low bits all ones), else
//                0xFFFFFFFF                              (optional)
//
// The TPU kernel carries the run sum across its sequential grid in VMEM
// scratch and builds the scan from lane/sublane rolls. Thread blocks here
// run in no order, so the scan is three passes over 4096-row tiles:
//   1. each tile's segmented aggregate (flag: a run starts in the tile;
//      value: the sum from the tile's last run start to its end);
//   2. one block scans the tile aggregates into each tile's carry-in;
//   3. each tile rescans with its carry-in and writes the outputs.
// Sums are kept in float64 and rounded once to float32 at the output, so
// the result is within an ulp of the exact run sum whatever the order; the
// TPU kernel sums in float32 (its tolerance against this is the summation
// order). The [K, 3] table lives in shared memory, not __constant__: rows
// of a run carry different wavelengths, and divergent __constant__ reads
// serialize. Bound: memory bandwidth (key and weight read twice, three
// float outputs and key2 written once).
//
// Every entry point returns cudaGetLastError() after its last launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 16;
constexpr int kTile = kThreads * kItems;
constexpr int kCarryThreads = 1024;

struct Agg {
  int f;
  double s0, s1, s2;
};

__device__ __forceinline__ Agg combine(const Agg& a, const Agg& b) {
  Agg r;
  r.f = a.f | b.f;
  if (b.f) {
    r.s0 = b.s0; r.s1 = b.s1; r.s2 = b.s2;
  } else {
    r.s0 = a.s0 + b.s0; r.s1 = a.s1 + b.s1; r.s2 = a.s2 + b.s2;
  }
  return r;
}

// Inclusive (segmented) scan of one Agg per thread, in thread order.
template <int N>
__device__ Agg block_scan(Agg v, int* sf, double* s0, double* s1, double* s2) {
  const int tid = threadIdx.x;
  sf[tid] = v.f; s0[tid] = v.s0; s1[tid] = v.s1; s2[tid] = v.s2;
  __syncthreads();
  for (int off = 1; off < N; off <<= 1) {
    Agg left;
    const bool has = tid >= off;
    if (has) {
      left.f = sf[tid - off]; left.s0 = s0[tid - off];
      left.s1 = s1[tid - off]; left.s2 = s2[tid - off];
    }
    __syncthreads();
    if (has) {
      v = combine(left, v);
      sf[tid] = v.f; s0[tid] = v.s0; s1[tid] = v.s1; s2[tid] = v.s2;
    }
    __syncthreads();
  }
  return v;
}

__device__ __forceinline__ void load_row(const uint32_t* sk, const float* sw,
                                         const float* tbl, int kmask, int shift,
                                         long long i, int& flag, float& a,
                                         float& b, float& c) {
  const uint32_t k = sk[i];
  const uint32_t pix = k >> shift;
  flag = (i == 0) ? 1 : (pix != (sk[i - 1] >> shift));
  const int wl = (int)((k >> 1) & (uint32_t)kmask);
  const float w = sw[i];
  a = tbl[3 * wl] * w;
  b = tbl[3 * wl + 1] * w;
  c = tbl[3 * wl + 2] * w;
}

// This thread's segmented aggregate over its kItems rows.
__device__ Agg thread_agg(const uint32_t* sk, const float* sw, const float* tbl,
                          int kmask, int shift, long long M, long long i0) {
  Agg r{0, 0.0, 0.0, 0.0};
  for (int j = 0; j < kItems; ++j) {
    const long long i = i0 + j;
    if (i >= M) break;
    int f; float a, b, c;
    load_row(sk, sw, tbl, kmask, shift, i, f, a, b, c);
    if (f) {
      r.f = 1; r.s0 = a; r.s1 = b; r.s2 = c;
    } else {
      r.s0 += a; r.s1 += b; r.s2 += c;
    }
  }
  return r;
}

__device__ void load_tbl(float* stbl, const float* tbl, int K) {
  for (int i = threadIdx.x; i < 3 * K; i += blockDim.x) stbl[i] = tbl[i];
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
tile_reduce_kernel(const uint32_t* __restrict__ sk, const float* __restrict__ sw,
                   const float* __restrict__ tbl, int K, int shift, long long M,
                   double* __restrict__ agg) {
  extern __shared__ float stbl[];
  __shared__ int sf[kThreads];
  __shared__ double s0[kThreads], s1[kThreads], s2[kThreads];
  load_tbl(stbl, tbl, K);
  const long long i0 = (long long)blockIdx.x * kTile + (long long)threadIdx.x * kItems;
  Agg v = thread_agg(sk, sw, stbl, K - 1, shift, M, i0);
  v = block_scan<kThreads>(v, sf, s0, s1, s2);
  if (threadIdx.x == kThreads - 1) {
    double* o = agg + 4 * (long long)blockIdx.x;
    o[0] = v.f; o[1] = v.s0; o[2] = v.s1; o[3] = v.s2;
  }
}

__global__ void __launch_bounds__(kCarryThreads)
tile_carry_kernel(const double* __restrict__ agg, int n_tiles,
                  double* __restrict__ carry) {
  __shared__ int sf[kCarryThreads];
  __shared__ double s0[kCarryThreads], s1[kCarryThreads], s2[kCarryThreads];
  __shared__ Agg run_sh;
  if (threadIdx.x == 0) run_sh = Agg{0, 0.0, 0.0, 0.0};
  __syncthreads();
  for (int base = 0; base < n_tiles; base += kCarryThreads) {
    const int t = base + threadIdx.x;
    Agg v{0, 0.0, 0.0, 0.0};
    if (t < n_tiles) {
      const double* a = agg + 4 * (long long)t;
      v = Agg{a[0] != 0.0, a[1], a[2], a[3]};
    }
    const Agg own = v;
    const Agg run = run_sh;
    v = block_scan<kCarryThreads>(v, sf, s0, s1, s2);
    // exclusive prefix of tile t = run (+) (inclusive scan without own)
    Agg excl;
    if (threadIdx.x == 0) {
      excl = run;
    } else {
      Agg prev{sf[threadIdx.x - 1], s0[threadIdx.x - 1], s1[threadIdx.x - 1],
               s2[threadIdx.x - 1]};
      excl = combine(run, prev);
    }
    (void)own;
    if (t < n_tiles) {
      double* o = carry + 3 * (long long)t;
      o[0] = excl.s0; o[1] = excl.s1; o[2] = excl.s2;
    }
    __syncthreads();
    if (threadIdx.x == kCarryThreads - 1) run_sh = combine(run, v);
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kThreads)
tile_apply_kernel(const uint32_t* __restrict__ sk, const float* __restrict__ sw,
                  const float* __restrict__ tbl, int K, int shift, long long M,
                  const double* __restrict__ carry, float* __restrict__ c0,
                  float* __restrict__ c1, float* __restrict__ c2,
                  uint32_t* __restrict__ key2) {
  extern __shared__ float stbl[];
  __shared__ int sf[kThreads];
  __shared__ double s0[kThreads], s1[kThreads], s2[kThreads];
  load_tbl(stbl, tbl, K);
  const int tid = threadIdx.x;
  const long long i0 = (long long)blockIdx.x * kTile + (long long)tid * kItems;
  const Agg own = thread_agg(sk, sw, stbl, K - 1, shift, M, i0);
  block_scan<kThreads>(own, sf, s0, s1, s2);
  const double* tc = carry + 3 * (long long)blockIdx.x;
  Agg run{0, tc[0], tc[1], tc[2]};
  if (tid > 0) {
    Agg prev{sf[tid - 1], s0[tid - 1], s1[tid - 1], s2[tid - 1]};
    run = combine(run, prev);
  }
  const uint32_t mmask = (uint32_t)(2 * K - 1);
  double r0 = run.s0, r1 = run.s1, r2 = run.s2;
  for (int j = 0; j < kItems; ++j) {
    const long long i = i0 + j;
    if (i >= M) break;
    int f; float a, b, c;
    load_row(sk, sw, stbl, K - 1, shift, i, f, a, b, c);
    if (f) {
      r0 = a; r1 = b; r2 = c;
    } else {
      r0 += a; r1 += b; r2 += c;
    }
    c0[i] = (float)r0;
    c1[i] = (float)r1;
    c2[i] = (float)r2;
    if (key2) {
      const uint32_t k = sk[i];
      key2[i] = ((k & mmask) == mmask) ? (k >> shift) : 0xFFFFFFFFu;
    }
  }
}

}  // namespace

extern "C" int iht_fused_scan(const void* sk, const void* sw, const void* tbl,
                              int K, int shift, long long M, void* c0, void* c1,
                              void* c2, void* key2, void* agg, void* carry,
                              void* stream) {
  if (M <= 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  const int n_tiles = (int)((M + kTile - 1) / kTile);
  const size_t smem = (size_t)3 * K * sizeof(float);
  tile_reduce_kernel<<<n_tiles, kThreads, smem, st>>>(
      (const uint32_t*)sk, (const float*)sw, (const float*)tbl, K, shift, M,
      (double*)agg);
  int err = (int)cudaGetLastError();
  if (err) return err;
  tile_carry_kernel<<<1, kCarryThreads, 0, st>>>((const double*)agg, n_tiles,
                                                 (double*)carry);
  err = (int)cudaGetLastError();
  if (err) return err;
  tile_apply_kernel<<<n_tiles, kThreads, smem, st>>>(
      (const uint32_t*)sk, (const float*)sw, (const float*)tbl, K, shift, M,
      (const double*)carry, (float*)c0, (float*)c1, (float*)c2,
      (uint32_t*)key2);
  return (int)cudaGetLastError();
}
