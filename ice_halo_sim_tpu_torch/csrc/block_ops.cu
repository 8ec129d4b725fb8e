// Block pack and block scatter for Hopper (sm_90a).
//
// Replaces, in ice_halo_sim_tpu/core/pallas_ops.py:
//   K1 _pack_one_block (:245)        stable in-block compaction
//   K6 pack_valid_blocks (:301)      K1 per 4096-row block with the key carried,
//                                    one or two payload columns, any threshold
//   K5 pack_payload_blocks (:365)    K1 per 4096-row block, key as mask only
//   K3 scatter_blocks_multi (:436)   forward-overwrite block scatter + marker tail
//   K3' scatter_blocks (:549) with _scatter_vmem (:104) / _scatter_hbm (:147)
//
// What the TPU kernels compute, not how: the butterfly routing, the
// ALIGN/SUP windows and rolls and the VMEM/HBM output split exist only for
// Mosaic and VMEM and are gone.
//
// Pack: one thread block per row block walks it in 1024-row tiles; a warp
// ballot ranks the valid rows of each warp, a 32-entry scan ranks the
// warps, so valid rows land in their original order (stable) at their
// rank, and the block's tail is written as (key 0xFFFFFFFF, payload 0).
// Bound: memory bandwidth (one read of key + payloads, one write).
//
// Scatter: thread blocks run in no order, so "later blocks overwrite
// earlier ones" cannot be used. Each output element is a gather instead:
// g = last block with start[g] <= p (binary search on the nondecreasing
// start vector); out[p] = vals[g][p - start[g]] if p - start[g] < blk,
// else 0. That is bit-equal to the forward-overwrite definition (a block's
// window ends no later than any later block's). The marker tail
// ((p - t0) << shift) | low_or is then written into channel 0 over
// [t0, t0 + tlen). Bound: memory bandwidth (one write per output, one
// read per covered output).
//
// Every entry point returns cudaGetLastError() after its launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

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
    const unsigned bal = __ballot_sync(0xffffffffu, v);
    const int lrank = __popc(bal & ((1u << lane) - 1u));
    if (lane == 0) warp_off[warp] = __popc(bal);
    __syncthreads();
    if (warp == 0) {
      const int c = warp_off[lane];
      int incl = c;
      for (int off = 1; off < 32; off <<= 1) {
        const int n = __shfl_up_sync(0xffffffffu, incl, off);
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

__global__ void scatter_blocks_kernel(
    const uint32_t* __restrict__ v0, const uint32_t* __restrict__ v1,
    const uint32_t* __restrict__ v2, int nvals,
    const int32_t* __restrict__ start, int n_blocks, int blk,
    long long out_len, uint32_t* __restrict__ o0, uint32_t* __restrict__ o1,
    uint32_t* __restrict__ o2, int has_tail, long long t0, long long tlen,
    int shift, uint32_t low_or) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       p < out_len; p += stride) {
    int lo = 0, hi = n_blocks;  // first g with start[g] > p
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if ((long long)__ldg(start + mid) <= p) lo = mid + 1; else hi = mid;
    }
    const int g = lo - 1;
    uint32_t a = 0u, b = 0u, c = 0u;
    if (g >= 0) {
      const long long off = p - (long long)__ldg(start + g);
      if (off < blk) {
        const long long src = (long long)g * blk + off;
        a = v0[src];
        if (nvals > 1) b = v1[src];
        if (nvals > 2) c = v2[src];
      }
    }
    if (has_tail && p >= t0 && p < t0 + tlen)
      a = ((uint32_t)(p - t0) << shift) | low_or;
    o0[p] = a;
    if (nvals > 1) o1[p] = b;
    if (nvals > 2) o2[p] = c;
  }
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

extern "C" int iht_scatter_blocks(const void* v0, const void* v1, const void* v2,
                                  int nvals, const void* start, int n_blocks,
                                  int blk, long long out_len, void* o0, void* o1,
                                  void* o2, int has_tail, long long t0,
                                  long long tlen, int shift, uint32_t low_or,
                                  void* stream) {
  if (out_len > 0) {
    const int threads = 256;
    long long want = (out_len + threads - 1) / threads;
    const int grid = (int)(want < 132LL * 64 ? want : 132LL * 64);
    scatter_blocks_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)v0, (const uint32_t*)v1, (const uint32_t*)v2, nvals,
        (const int32_t*)start, n_blocks, blk, out_len, (uint32_t*)o0,
        (uint32_t*)o1, (uint32_t*)o2, has_tail, t0, tlen, shift, low_or);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* iht_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
