// The sandwich fold for Hopper (sm_90a): scatter-add as a one-hot product on
// the tensor cores.
//
// Replaces, in ice_halo_sim_tpu/core/pallas_sandwich.py and scripts/:
//   K7 _kernel_lane (:143, pallas_call :283)   A @ B^T, rows in lanes
//   K8 _kernel (:77, pallas_call :314)         A @ B, the second factor untransposed
//   P1 scripts/probe_sandwich.py (:44, pallas_call :90)   K8 with an iota list
//
// The function (p = chunk * 128 + lo, list cl[0..NC), C channels):
//   out[k, c*128 + lo] = tile[k, c*128 + lo]
//       + sum_r [pix_r // 128 == cl[k]] * bf16(tbl[wl_r, c] * w_r) * [pix_r % 128 == lo]
//   matched[r] = 1 iff pix_r // 128 is in cl
// with // the floor division (a dead row, pix -1, has chunk -1), a negative
// list id matching nothing, the product tbl * w rounded to bf16 (or split into
// two bf16 terms when `precise`), and the sum taken in float32.
//
// What is kept from the TPU kernels is that function. Their 2048-row grid
// step, the 256-chunk sub-loop, the [1, N] / [N, 1] relayouts and the tile
// that stays in fast memory across a sequential grid exist for Mosaic and
// VMEM and are gone. Here:
//   - thread blocks run in no order, and a [256, 384] float32 tile is larger
//     than a block's shared memory and registers. The grid is (row splits,
//     64-entry slices of the list); each block sums its [64, C*128] part over
//     its rows in registers and writes it to partial[split]; a second kernel
//     adds the partials to the tile in split order, so the result does not
//     depend on the schedule;
//   - a row's list slot is found once, in integers, while the block stages
//     256 rows in shared memory (slot, lo and the bf16 values as bf16 pairs).
//     `matched` falls out of it: a row matches in at most one slice, whose
//     block writes the 1 (the wrapper zeroes the vector);
//   - 16-row steps in which no row hit the block's slice are skipped.
// K7 (lane): every warp builds its mma.sync m16n8k16 fragments in registers
// from the staged pairs: the chunk one-hot is one bf16x2 compare per
// register, the second factor one compare per 8 columns (shared by the
// channels) and one multiply; the B operand's "col" fragment is the
// transposed second factor. K8 (sublane): both factors are written out in
// shared memory, the second one row-major [rows, C*128] as the TPU kernel's
// bmat, and multiplied with nvcuda::wmma; between steps only the poked
// entries are cleared. P1 is K8's kernel with slot = chunk - first entry.
//
// Bound: operations. The dense one-hot product is 2 * N * NC * C * 128 bf16
// operations on the tensor cores (twice that when precise) against 12 bytes
// read per row.
//
// The tensor cores' float32 accumulation is not a sequential IEEE sum, so a
// tile entry agrees with the plain version to a tolerance, `matched` bit for
// bit. Every entry point returns cudaGetLastError() after its launches.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace {

constexpr int kNlo = 128;          // pixels per chunk
constexpr int kBM = 64;            // list entries per thread block
constexpr int kThreads = 256;
constexpr int kSlab = 256;         // rows staged per step, one per thread
constexpr int kMaxPool = 128;      // wavelength-pool entries
constexpr int kPadId = -0x40000000;

struct Rows {
  const int32_t* pix;
  const float* w;
  const int32_t* wl;
  const float* tbl;     // [k_pool, C]
  const int32_t* list;  // [nc], unused by the iota form
  long long n_rows;
  int nc;
  int k_pool;
  long long rows_per_split;
  float* partial;       // [splits, nc_pad, C*128]
  int nc_pad;
  int32_t* matched;     // [n_rows] zeroed, or null
};

__device__ __forceinline__ uint16_t bf16_bits(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

__device__ __forceinline__ uint32_t eq2(uint32_t a, uint32_t b) {
  const __nv_bfloat162 r = __heq2(*reinterpret_cast<const __nv_bfloat162*>(&a),
                                  *reinterpret_cast<const __nv_bfloat162*>(&b));
  return *reinterpret_cast<const uint32_t*>(&r);
}

__device__ __forceinline__ uint32_t mul2(uint32_t a, uint32_t b) {
  const __nv_bfloat162 r = __hmul2(*reinterpret_cast<const __nv_bfloat162*>(&a),
                                   *reinterpret_cast<const __nv_bfloat162*>(&b));
  return *reinterpret_cast<const uint32_t*>(&r);
}

__device__ __forceinline__ uint32_t pair_of(int i) {
  const uint32_t b = bf16_bits((float)i);
  return b | (b << 16);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The block's slice of the list (negative and past-the-end ids match
// nothing) and the basis table, into shared memory.
template <int kC>
__device__ __forceinline__ void load_tables(const Rows& a, int m0, int* list_s,
                                            float* tbl_s) {
  const int tid = threadIdx.x;
  if (tid < kBM) {
    const int k = m0 + tid;
    const int id = (a.list != nullptr && k < a.nc) ? a.list[k] : -1;
    list_s[tid] = id < 0 ? kPadId : id;
  }
  for (int i = tid; i < a.k_pool * kC; i += kThreads) tbl_s[i] = a.tbl[i];
}

// One row: its slot in the block's slice (-1: none), lo, and the float32
// products tbl[wl, c] * w.
template <int kC, bool kIota>
__device__ __forceinline__ void stage_row(const Rows& a, long long r, long long r_end,
                                          int m0, const int* list_s, const float* tbl_s,
                                          int p, float ww, int l, int& slot, int& lo,
                                          float (&v)[kC]) {
  slot = -1;
  lo = 0;
#pragma unroll
  for (int c = 0; c < kC; ++c) v[c] = 0.0f;
  if (r >= r_end) return;
  const int chunk = p >> 7;  // floor division by 128
  lo = p & (kNlo - 1);
  if (kIota) {
    const int d = chunk - m0;
    if (d >= 0 && d < kBM && chunk < a.nc) slot = d;
  } else {
#pragma unroll
    for (int i = 0; i < kBM; ++i)
      if (list_s[i] == chunk) slot = i;
  }
  if ((unsigned)l < (unsigned)a.k_pool) {
#pragma unroll
    for (int c = 0; c < kC; ++c) v[c] = tbl_s[l * kC + c] * ww;
  }
  if (slot >= 0 && a.matched != nullptr) a.matched[r] = 1;
}

// --------------------------------------------------------------------------
// K7: fragments built in registers, mma.sync m16n8k16
// --------------------------------------------------------------------------

template <int kC, bool kPrecise>
__global__ void __launch_bounds__(kThreads, 1) sandwich_lane_kernel(const Rows a) {
  constexpr int kTerms = kPrecise ? 2 : 1;
  constexpr int kWords = 2 + kC * kTerms;  // per row pair: slots, los, values
  constexpr int kMT = 2;                   // 16-entry tiles per warp (2 warps over 64)
  constexpr int kJ = 4;                    // 8-column tiles per warp and channel
  __shared__ uint32_t rec_s[(kSlab / 2) * kWords];
  __shared__ int list_s[kBM];
  __shared__ float tbl_s[kMaxPool * kC];
  __shared__ uint32_t hit_s[kSlab / 16];

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int wm = warp & 1, wn = warp >> 1;  // the warp's 32 entries, its 32 lo values
  const int m0 = blockIdx.y * kBM;
  load_tables<kC>(a, m0, list_s, tbl_s);
  __syncthreads();

  uint32_t mrow[kMT][2], ncol[kJ];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
    mrow[mt][0] = pair_of(wm * 32 + mt * 16 + gid);
    mrow[mt][1] = pair_of(wm * 32 + mt * 16 + gid + 8);
  }
#pragma unroll
  for (int j = 0; j < kJ; ++j) ncol[j] = pair_of(wn * 32 + j * 8 + gid);

  float acc[kMT][kC * kJ][4];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int n = 0; n < kC * kJ; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][n][i] = 0.0f;

  const long long r_begin = (long long)blockIdx.x * a.rows_per_split;
  const long long r_end = min(a.n_rows, r_begin + a.rows_per_split);
  uint16_t* rec16 = reinterpret_cast<uint16_t*>(rec_s);
  const int q = tid >> 1, h = tid & 1;

  // The next slab's row is loaded while this one is multiplied.
  long long r = r_begin + tid;
  int p = -1, l = 0;
  float ww = 0.0f;
  if (r < r_end) { p = a.pix[r]; ww = a.w[r]; l = a.wl[r]; }
  for (long long base = r_begin; base < r_end; base += kSlab) {
    int slot, lo;
    float v[kC];
    stage_row<kC, false>(a, r, r_end, m0, list_s, tbl_s, p, ww, l, slot, lo, v);
    rec16[(q * kWords + 0) * 2 + h] = bf16_bits((float)slot);
    rec16[(q * kWords + 1) * 2 + h] = bf16_bits((float)lo);
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      const __nv_bfloat16 hi = __float2bfloat16_rn(v[c]);
      rec16[(q * kWords + 2 + c) * 2 + h] = __bfloat16_as_ushort(hi);
      if (kPrecise)
        rec16[(q * kWords + 2 + kC + c) * 2 + h] = bf16_bits(v[c] - __bfloat162float(hi));
    }
    const unsigned bal = __ballot_sync(0xffffffffu, slot >= 0);
    if (lane == 0) {
      hit_s[2 * warp] = bal & 0xFFFFu;
      hit_s[2 * warp + 1] = bal >> 16;
    }
    r += kSlab;
    p = -1; ww = 0.0f; l = 0;
    if (r < r_end) { p = a.pix[r]; ww = a.w[r]; l = a.wl[r]; }
    __syncthreads();

#pragma unroll 1
    for (int j = 0; j < kSlab / 16; ++j) {
      if (hit_s[j] == 0u) continue;  // the same for the whole block
      // Rows 16j + 2*tig + {0, 1} and the same + 8: the k indices of this
      // thread's A and B fragment registers.
      const uint32_t* r0 = rec_s + (8 * j + tig) * kWords;
      const uint32_t* r1 = r0 + 4 * kWords;
      const uint32_t s0 = r0[0], s1 = r1[0], l0 = r0[1], l1 = r1[1];
      uint32_t af[kMT][4];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        af[mt][0] = eq2(s0, mrow[mt][0]);
        af[mt][1] = eq2(s0, mrow[mt][1]);
        af[mt][2] = eq2(s1, mrow[mt][0]);
        af[mt][3] = eq2(s1, mrow[mt][1]);
      }
      uint32_t e0[kJ], e1[kJ];
#pragma unroll
      for (int jj = 0; jj < kJ; ++jj) {
        e0[jj] = eq2(l0, ncol[jj]);
        e1[jj] = eq2(l1, ncol[jj]);
      }
#pragma unroll
      for (int t = 0; t < kTerms; ++t)
#pragma unroll
        for (int c = 0; c < kC; ++c) {
          const uint32_t v0 = r0[2 + t * kC + c], v1 = r1[2 + t * kC + c];
#pragma unroll
          for (int jj = 0; jj < kJ; ++jj) {
            const uint32_t b0 = mul2(e0[jj], v0), b1 = mul2(e1[jj], v1);
#pragma unroll
            for (int mt = 0; mt < kMT; ++mt) mma_bf16(acc[mt][c * kJ + jj], af[mt], b0, b1);
          }
        }
    }
    __syncthreads();
  }

  // C fragment: rows gid and gid + 8, columns 2*tig and 2*tig + 1.
  float* out = a.partial + ((long long)blockIdx.x * a.nc_pad + m0) * (kC * kNlo);
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int c = 0; c < kC; ++c)
#pragma unroll
      for (int jj = 0; jj < kJ; ++jj) {
        const int row = wm * 32 + mt * 16 + gid;
        const int col = c * kNlo + wn * 32 + jj * 8 + 2 * tig;
        const float (&d)[4] = acc[mt][c * kJ + jj];
        *reinterpret_cast<float2*>(out + (long long)row * (kC * kNlo) + col) =
            make_float2(d[0], d[1]);
        *reinterpret_cast<float2*>(out + (long long)(row + 8) * (kC * kNlo) + col) =
            make_float2(d[2], d[3]);
      }
}

// --------------------------------------------------------------------------
// K8 and P1: both factors in shared memory, nvcuda::wmma
// --------------------------------------------------------------------------

template <int kC, bool kPrecise, bool kIota>
__global__ void __launch_bounds__(kThreads, 1) sandwich_sublane_kernel(const Rows a) {
  using namespace nvcuda;
  constexpr int kTerms = kPrecise ? 2 : 1;
  constexpr int kKS = 32;            // rows per product step
  constexpr int kBN = kC * kNlo;
  constexpr int kLda = kKS + 8;      // padded leading dimensions (bf16 elements)
  constexpr int kLdb = kBN + 8;
  constexpr int kMT = 2;             // 16-entry tiles per warp
  constexpr int kWN = kBN / 4;       // columns per warp
  constexpr int kNT = kWN / 16;
  __shared__ __align__(32) __nv_bfloat16 a_s[kBM * kLda];   // [entry][row] one-hot
  __shared__ __align__(32) __nv_bfloat16 b_s[kKS * kLdb];   // [row][c*128 + lo]
  __shared__ int slot_s[kSlab];
  __shared__ int lo_s[kSlab];
  __shared__ __nv_bfloat16 v_s[kTerms][kC][kSlab];
  __shared__ int list_s[kBM];
  __shared__ float tbl_s[kMaxPool * kC];
  __shared__ uint32_t hit_s[kSlab / kKS];

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 1, wn = warp >> 1;
  const int m0 = blockIdx.y * kBM;
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.0f), one = __float2bfloat16_rn(1.0f);
  load_tables<kC>(a, m0, list_s, tbl_s);
  for (int i = tid; i < kBM * kLda; i += kThreads) a_s[i] = zero;
  for (int i = tid; i < kKS * kLdb; i += kThreads) b_s[i] = zero;
  __syncthreads();

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kMT][kNT];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) wmma::fill_fragment(acc[mt][nt], 0.0f);

  const long long r_begin = (long long)blockIdx.x * a.rows_per_split;
  const long long r_end = min(a.n_rows, r_begin + a.rows_per_split);
  const int pk = tid % kKS, pc = tid / kKS;  // the (row, channel) this thread pokes

  for (long long base = r_begin; base < r_end; base += kSlab) {
    const long long r = base + tid;
    int p = -1, l = 0;
    float ww = 0.0f;
    if (r < r_end) { p = a.pix[r]; ww = a.w[r]; l = a.wl[r]; }
    int slot, lo;
    float v[kC];
    stage_row<kC, kIota>(a, r, r_end, m0, list_s, tbl_s, p, ww, l, slot, lo, v);
    slot_s[tid] = slot;
    lo_s[tid] = lo;
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      const __nv_bfloat16 hi = __float2bfloat16_rn(v[c]);
      v_s[0][c][tid] = hi;
      if (kPrecise) v_s[kTerms - 1][c][tid] = __float2bfloat16_rn(v[c] - __bfloat162float(hi));
    }
    const unsigned bal = __ballot_sync(0xffffffffu, slot >= 0);
    if (lane == 0) hit_s[warp] = bal;  // kKS == 32: one product step per staging warp
    __syncthreads();

#pragma unroll 1
    for (int ss = 0; ss < kSlab / kKS; ++ss) {
      if (hit_s[ss] == 0u) continue;  // the same for the whole block
      const int k = ss * kKS + pk;
      const int sl = tid < kKS ? slot_s[k] : -1;
      if (sl >= 0) a_s[sl * kLda + pk] = one;
      const int bidx = pk * kLdb + pc * kNlo + (pc < kC ? lo_s[k] : 0);
#pragma unroll
      for (int t = 0; t < kTerms; ++t) {
        if (pc < kC) b_s[bidx] = v_s[t][pc][k];
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < kKS / 16; ++kk) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> af[kMT];
#pragma unroll
          for (int mt = 0; mt < kMT; ++mt)
            wmma::load_matrix_sync(af[mt], a_s + (wm * 32 + mt * 16) * kLda + kk * 16, kLda);
#pragma unroll
          for (int nt = 0; nt < kNT; ++nt) {
            wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bf;
            wmma::load_matrix_sync(bf, b_s + kk * 16 * kLdb + wn * kWN + nt * 16, kLdb);
#pragma unroll
            for (int mt = 0; mt < kMT; ++mt)
              wmma::mma_sync(acc[mt][nt], af[mt], bf, acc[mt][nt]);
          }
        }
        __syncthreads();
      }
      // Clear what this thread poked; nobody else writes these entries.
      if (sl >= 0) a_s[sl * kLda + pk] = zero;
      if (pc < kC) b_s[bidx] = zero;
    }
    __syncthreads();
  }

  float* out = a.partial + ((long long)blockIdx.x * a.nc_pad + m0) * kBN;
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
      wmma::store_matrix_sync(out + (long long)(wm * 32 + mt * 16) * kBN + wn * kWN + nt * 16,
                              acc[mt][nt], kBN, wmma::mem_row_major);
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

enum Form { kLane = 0, kSublane = 1, kIotaForm = 2 };

template <int kC, bool kPrecise>
cudaError_t launch_product(int form, const Rows& a, dim3 grid, cudaStream_t stream) {
  if (form == kLane)
    sandwich_lane_kernel<kC, kPrecise><<<grid, kThreads, 0, stream>>>(a);
  else if (form == kSublane)
    sandwich_sublane_kernel<kC, kPrecise, false><<<grid, kThreads, 0, stream>>>(a);
  else
    sandwich_sublane_kernel<kC, kPrecise, true><<<grid, kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

cudaError_t launch_form(int form, const Rows& a, int c_out, int precise, int n_split,
                        cudaStream_t stream) {
  if (a.k_pool < 1 || a.k_pool > kMaxPool || a.nc < 1 || a.nc_pad % kBM || a.nc_pad < a.nc ||
      n_split < 1 || a.rows_per_split < 1)
    return cudaErrorInvalidValue;
  const dim3 grid(n_split, a.nc_pad / kBM);
  if (c_out == 3) return precise ? launch_product<3, true>(form, a, grid, stream)
                                 : launch_product<3, false>(form, a, grid, stream);
  if (c_out == 1) return precise ? launch_product<1, true>(form, a, grid, stream)
                                 : launch_product<1, false>(form, a, grid, stream);
  return cudaErrorInvalidValue;
}

// One product launch and the ordered sum of its partials.
cudaError_t run_form(int form, const void* pix, const void* w, const void* wl,
                     const void* tbl, const void* list, long long n_rows, int nc, int c_out,
                     int k_pool, int precise, int n_split, long long rows_per_split,
                     int nc_pad, const void* tile_in, void* partial, void* matched, void* out,
                     void* stream) {
  const Rows a{(const int32_t*)pix, (const float*)w, (const int32_t*)wl, (const float*)tbl,
               (const int32_t*)list, n_rows, nc, k_pool, rows_per_split, (float*)partial,
               nc_pad, (int32_t*)matched};
  const cudaError_t err = launch_form(form, a, c_out, precise, n_split, (cudaStream_t)stream);
  if (err != cudaSuccess) return err;
  const int cw = c_out * kNlo;
  const long long want = ((long long)nc * cw + 255) / 256;
  const int grid = (int)(want < 132LL * 8 ? want : 132LL * 8);
  sandwich_reduce_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(
      (const float*)tile_in, (const float*)partial, n_split, nc, nc_pad, cw, (float*)out);
  return cudaGetLastError();
}

}  // namespace

// K7: fragments in registers, mma.sync.
extern "C" int iht_sandwich_lane(const void* pix, const void* w, const void* wl,
                                 const void* tbl, const void* list, long long n_rows, int nc,
                                 int c_out, int k_pool, int precise, int n_split,
                                 long long rows_per_split, int nc_pad, const void* tile_in,
                                 void* partial, void* matched, void* out, void* stream) {
  const cudaError_t err = run_form(kLane, pix, w, wl, tbl, list, n_rows, nc, c_out, k_pool,
                                   precise, n_split, rows_per_split, nc_pad, tile_in, partial,
                                   matched, out, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// K8: both factors in shared memory, the second one untransposed, wmma.
extern "C" int iht_sandwich_sublane(const void* pix, const void* w, const void* wl,
                                    const void* tbl, const void* list, long long n_rows,
                                    int nc, int c_out, int k_pool, int precise, int n_split,
                                    long long rows_per_split, int nc_pad, const void* tile_in,
                                    void* partial, void* matched, void* out, void* stream) {
  const cudaError_t err = run_form(kSublane, pix, w, wl, tbl, list, n_rows, nc, c_out, k_pool,
                                   precise, n_split, rows_per_split, nc_pad, tile_in, partial,
                                   matched, out, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// P1: K8's kernel with the list 0, 1, ..., nc - 1; no list, tile or matched.
extern "C" int iht_sandwich_iota(const void* pix, const void* w, const void* wl,
                                 const void* tbl, long long n_rows, int nc, int c_out,
                                 int k_pool, int n_split, long long rows_per_split, int nc_pad,
                                 void* partial, void* out, void* stream) {
  const cudaError_t err = run_form(kIotaForm, pix, w, wl, tbl, nullptr, n_rows, nc, c_out,
                                   k_pool, 0, n_split, rows_per_split, nc_pad, nullptr, partial,
                                   nullptr, out, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
