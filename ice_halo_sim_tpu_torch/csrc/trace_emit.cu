// Trace-and-emit kernel for Hopper (sm_90a), one thread per ray, with the
// in-block pack of its rows inside.
//
// Replaces K2 and K2b, ice_halo_sim_tpu/core/pallas_trace.py:
// make_trace_emit (:299), kernel body (:318-601), in its static-geometry
// (K == 1) mode and in its blocked-pool mode (:382-399: per-batch ptbl/ttbl
// inputs, one sampled crystal shape per 128 rays), together with the pack
// of each 2048-ray block that the TPU kernel does in VMEM
// (_pack_one_block, :588). Per ray: counter-PCG streams with the 64-bit
// epoch mix -> wavelength and SPD weight -> sun-cap direction ->
// orientation -> entry-triangle CDF -> entry Fresnel -> bounce loop over the
// face planes (slab min-t, Fresnel split, TIR) for max_hits - 1 bounces ->
// probability gate and Russian-roulette emit floor -> lens projection
// (linear, fisheye equal-area / orthographic, their dual forms with the
// overlap pass, globe) -> spectral key pack.
//
// The TPU kernel selects every table value with one-hot where-chains
// (_sel_const/_sel_many: Mosaic has no gathers), reads a pooled shape as a
// lane broadcast of its table row, and packs each block with a butterfly.
// Here the plan's tables (face table, entry triangles, SPD pool or discrete
// spectrum, latitude LUT) are copied into shared memory once per thread
// block and indexed directly. A thread block is 128 threads and the pool's
// geom clock is 128, so in blocked-pool mode ONE THREAD BLOCK TRACES EXACTLY
// ONE SHAPE: it copies its own row of ptbl (NF x 5 floats) and ttbl (NF x 4
// x 13 floats) over the face and triangle sections of the shared table.
// Every face slot and triangle row of a pooled shape stays (absent faces
// masked by their `present` column, dead triangles adding a zero cross_half
// to the CDF), as in the TPU kernel.
//
// The pack. One 2048-ray block of the JAX layout is one thread-block
// cluster of 16 blocks of 128 rays (fewer when the batch is smaller). Each
// block stages its rays' rows in shared memory (per render, slot h, pass and
// ray), up to kMaxEntries (slot, render, pass) entries at a time. To place
// them, a block counts its live rows per entry with warp ballots, publishes
// the counts, and after a cluster barrier reads the other blocks' counts
// through distributed shared memory. Each live row is then written once, at
// its final place in the JAX order: per render, slot-major (slot h, main
// pass before overlap pass), then ray; the tail of the block's rows_block
// is (0xFFFFFFFF, 0) and counts[r][g] holds the live rows. No uncompacted
// slab goes through device memory and no pack kernel follows. With the
// main paths' max_hits and renders every entry fits at once: one exchange
// per block.
//
// Stats (dropped weight, traced segments, landed weight per render) go to
// per-thread-block partials that the wrapper sums.
//
// The batch's 64-bit ray base is read from device memory (two u32 words,
// low then high), not passed by value: a CUDA graph copies a launch's
// arguments when it is captured, so a base passed by value would replay the
// same rays every batch, while the words in memory are rewritten on the
// device before each launch (engine/simulator.py). Every thread loads the
// same two words once, through the read-only cache.
//
// The kernel is a template on the face-slot count NF (8 prism, 20 with a
// pyramid): the per-ray plane distances are NF registers.
//
// Arithmetic follows the JAX order operation by operation and is built
// with --fmad=false, so it rounds as the plain PyTorch twin does. A sine and
// cosine of one angle come from one sincosf. Bound: arithmetic and special
// functions (about 30 transcendental calls and, per ray, some 20 operations
// per face and bounce plus 16 per entry triangle); the rows are written
// once, 8 bytes each.
//
// Every entry point returns cudaGetLastError() after its launch.

#include <cstdint>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "trace_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxR = 4;
constexpr int kMaxF = 20;     // face slots of the pyramid layout
constexpr int kThreads = 128;  // == the pool's geom clock
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCta = 16;   // blocks of a cluster: 2048 rays
constexpr int kMaxEntries = 32;  // (slot, render, pass) entries staged at once
constexpr float GLOBE_CAMERA_D = 4.0f;

constexpr uint32_t NONCE_WL = 0x9E3779B9u;
constexpr uint32_t NONCE_ORIENT = 0xC2B2AE35u;
constexpr uint32_t NONCE_SUN = 0x27D4EB2Fu;
constexpr uint32_t NONCE_ENTRY = 0x165667B1u;
constexpr uint32_t NONCE_GATE = 0xD3A2646Cu;
constexpr uint32_t NONCE_EMIT = 0x94D049BBu;
constexpr uint32_t LAYER_NONCE = 0xA5A5u;

constexpr float PI_F = 3.14159265358979323846f;
constexpr float HALF_PI_F = 1.57079632679489661923f;
constexpr float TWO_PI_F = 6.28318530717958647692f;
constexpr float SLAB_EPS = 1e-5f;

}  // namespace

// Host-built plan; the layout is mirrored by TraceParams in
// ice_halo_sim_tpu_torch/core/trace_emit.py.
struct TraceParams {
  long long slab_off[kMaxR];  // element offset of each render's [G, rows_block]
  uint32_t seed;
  int32_t n_active, batch, nr, h, k_pool, wl_discrete, n_wl;
  float prob, emit_cut;
  int32_t emit_mode;  // 0 off, 1 Russian roulette, 2 drop
  float c_cap, a0, a1, a2, b0, b1, b2, c0, c1;
  int32_t lat_path;
  float lat_mean, lat_std;
  int32_t az_type;
  float az_mean, az_std;
  int32_t roll_type;
  float roll_mean, roll_std;
  float lut_t0, lut_dt, lut_tspan0, lut_span, lut_c_first, lut_c_last;
  int32_t lut_n, lut_has_span;
  int32_t nf, n_tris;  // face slots (8 or 20); triangle rows of the table
  int32_t pool;        // 1: blocked-pool mode (block b reads row b of ptbl/ttbl)
  int32_t n_renders;
  int32_t lens[kMaxR], width[kMaxR], height[kMaxR], rows_block[kMaxR];
  int32_t visible[kMaxR];  // 0 upper, 1 lower, 2 full (single-lens family)
  float r_scale[kMaxR], max_abs_dz[kMaxR];
  float scale[kMaxR], shift_x[kMaxR], shift_y[kMaxR];
  float rot[kMaxR][9];     // camera rotation, row-major
  int32_t off_planes, off_tris, off_spd, off_wl, off_wlw, off_cdf, off_flip;
  int32_t n_ftab;
  // Per-render constants of the projection, computed on the host as the
  // kernel would (double, then float): W / 2, H / 2, and of the dual lenses
  // short_res / 2, H / 2, W / 2 -+ short_res / 2.
  float half_w[kMaxR], half_h[kMaxR];
  float dual_r[kMaxR], dual_cy[kMaxR], dual_cxu[kMaxR], dual_cxl[kMaxR];
  int32_t passes[kMaxR];  // 2 with the overlap pass, else 1
  int32_t rp_off[kMaxR];  // first (render, pass) index of each render
  int32_t rp;             // (render, pass) pairs: sum of passes
  int32_t hg;             // slots staged at once (hg * rp <= kMaxEntries)
  int32_t ncta;           // blocks per 2048-ray block (the cluster size)
  int32_t key_shift;      // log2(2K)
  int32_t grid_blocks;    // thread blocks of the launch: G * ncta
};

namespace {

__device__ __forceinline__ float gaussian(uint32_t seed, uint32_t idx, uint32_t slot) {
  const float u1 = fmaxf(uniform(seed, idx, slot), 1e-7f);
  const float u2 = uniform(seed, idx, slot + 1u);
  return sqrtf(-2.0f * logf(u1)) * cosf(TWO_PI_F * u2);
}

// rng.sample_dist for a DistType code (0 none, 1 uniform, 2/5 gauss,
// 3 zigzag, 4 laplacian).
__device__ float sample_dist(uint32_t seed, uint32_t idx, uint32_t slot, int type,
                             float center, float spread) {
  switch (type) {
    case 1: return (uniform(seed, idx, slot) - 0.5f) * spread + center;
    case 2:
    case 5: return gaussian(seed, idx, slot) * spread + center;
    case 3: {
      const float u = uniform(seed, idx, slot);
      return fabsf(spread * sinf(u * TWO_PI_F) + center);
    }
    case 4: {
      const float u = uniform(seed, idx, slot);
      const float sgn = (u < 0.5f) ? -1.0f : 1.0f;
      const float arg = fmaxf(1.0f - 2.0f * fabsf(u - 0.5f), 1e-30f);
      return center - spread * sgn * logf(arg);
    }
    default: return center;
  }
}

__device__ __forceinline__ float ice_n(float wl) {
  const float um = wl / 1e3f;
  const float um2 = um * um;
  const float b1 = (float)0.701777, b2 = (float)1.091144;
  const float c1 = (float)(0.884400 * 1e-2), c2 = (float)(0.796950 * 1e2);
  const float n_sq = 1.0f + b1 / (1.0f - c1 / um2) + b2 / (1.0f - c2 / um2);
  const float n = sqrtf(fmaxf(n_sq, 1.0f));
  return (wl < 350.0f || wl > 900.0f) ? 1.0f : n;
}

__device__ __forceinline__ int in_bounds(int px, int py, bool valid, int W, int H) {
  return (valid && px >= 0 && px < W && py >= 0 && py < H) ? py * W + px : -1;
}

// Equal-area / orthographic fisheye forward of a direction with z = zc.
__device__ __forceinline__ void fisheye_xy(bool equal_area, float dx, float dy, float dz,
                                           float r_scale, float& x, float& y) {
  if (equal_area) {
    const float zc = fminf(fmaxf(dz, (float)(-1.0 + 1e-6)), 1.0f);
    const float k = r_scale / sqrtf(1.0f + zc);
    x = k * dx;
    y = k * dy;
  } else {
    x = r_scale * dx;
    y = r_scale * dy;
  }
}

// Dual-fisheye pixel of sky direction (sx, sy, +-z_hemi) on one hemisphere.
__device__ __forceinline__ int dual_pixel(const TraceParams& p, int r, float sx, float sy,
                                          float zh, bool upper, bool valid) {
  float x, y;
  fisheye_xy(p.lens[r] == 4, sx, sy, zh, p.r_scale[r], x, y);
  const float rr = p.dual_r[r];
  const float fx = upper ? (-y) * rr + p.dual_cxu[r] : y * rr + p.dual_cxl[r];
  const float fy = x * rr + p.dual_cy[r];
  return in_bounds((int)floorf(fx + 0.5f), (int)floorf(fy + 0.5f), valid, p.width[r],
                   p.height[r]);
}

// Single-lens family (0 linear, 1 fisheye equal-area, 8 fisheye
// orthographic) and globe (10): flattened pixel of exit direction
// (ex, ey, ez), or -1.
__device__ __forceinline__ int single_pixel(const TraceParams& p, int r, float ex,
                                            float ey, float ez) {
  const int lens = p.lens[r], W = p.width[r], H = p.height[r];
  const float* m = p.rot[r];
  // Camera frame c = R^T (-w).
  const float cx = -(m[0] * ex + m[3] * ey + m[6] * ez);
  const float cy = -(m[1] * ex + m[4] * ey + m[7] * ez);
  const float cz = -(m[2] * ex + m[5] * ey + m[8] * ez);
  bool valid;
  float x, y;
  if (lens == 10) {
    // Valid rays have cz in [-1, -1/D): their denominator is positive. An
    // invalid ray's quotient may be inf; `valid` masks its pixel.
    valid = cz < (float)(-1.0 / GLOBE_CAMERA_D);
    const float denom = GLOBE_CAMERA_D + cz;
    x = -cx / denom;
    y = cy / denom;
  } else {
    valid = true;
    if (p.visible[r] == 0) valid = ez <= 0.0f;
    else if (p.visible[r] == 1) valid = ez >= 0.0f;
    valid = valid && cz > 0.0f;
    if (lens == 0) {
      // An invalid ray divides by 1, never by a non-positive cz.
      const float safe_cz = cz > 0.0f ? cz : 1.0f;
      x = cx / safe_cz;
      y = cy / safe_cz;
    } else {
      fisheye_xy(lens == 1, cx, cy, cz, 1.0f, x, y);
      if (lens == 8) valid = valid && cz >= 0.0f;
    }
    x = -x;  // screen handedness
  }
  const float fx = x * p.scale[r] + p.half_w[r] + 0.5f + p.shift_x[r];
  const float fy = y * p.scale[r] + p.half_h[r] + 0.5f + p.shift_y[r];
  return in_bounds((int)floorf(fx), (int)floorf(fy), valid, W, H);
}

__device__ __forceinline__ uint32_t pack_key(int pix, float w, uint32_t wl_idx,
                                             int P, int K, int shift, float& wz) {
  const bool valid = pix >= 0 && pix < P && w > 0.0f;
  wz = valid ? w : 0.0f;
  return valid ? (((uint32_t)pix << shift) | ((wl_idx & (uint32_t)(K - 1)) << 1))
               : 0xFFFFFFFFu;
}

struct RayState {
  float dropped;
  float landed[kMaxR];
  int segs;
};

// The staged rows of this block: entry e (slot within the group, render,
// pass), thread t at [e * kThreads + t].
struct Stage {
  uint32_t* key;
  float* w;
};

// Slot h's rows of this ray into the stage (entries (h % hg) * rp + ...).
__device__ void emit_slot(const TraceParams& p, int h, float ex, float ey, float ez,
                          float w_raw, uint32_t ray_idx, uint32_t gate_seed,
                          uint32_t rr_seed, uint32_t wl_idx, const Stage& sg,
                          RayState& st) {
  if (w_raw > 0.0f) st.segs = h + 1;
  float acc_w = w_raw;
  if (p.prob > 0.0f) {
    const float ug = uniform(gate_seed, ray_idx, 100u + (uint32_t)h);
    acc_w = (ug >= p.prob) ? w_raw : 0.0f;
  }
  if (p.emit_mode != 0) {
    const float cut = p.emit_cut;
    const bool tiny = acc_w > 0.0f && acc_w < cut;
    float new_w;
    if (p.emit_mode == 1) {
      const float urr = uniform(rr_seed, ray_idx, (uint32_t)h);
      new_w = tiny ? ((urr * cut < acc_w) ? cut : 0.0f) : acc_w;
    } else {
      new_w = tiny ? 0.0f : acc_w;
    }
    st.dropped += acc_w - new_w;
    acc_w = new_w;
  }
  const float sx = -ex, sy = -ey, sz = -ez;
  const bool upper = sz >= 0.0f;
  const float zh = fabsf(sz);
  const int e0 = (h % p.hg) * p.rp;
  for (int r = 0; r < p.n_renders; ++r) {
    const int P = p.width[r] * p.height[r];
    const bool dual = p.lens[r] == 4 || p.lens[r] == 9;
    const int main_pix = dual ? dual_pixel(p, r, sx, sy, zh, upper, true)
                              : single_pixel(p, r, ex, ey, ez);
    const bool main_ok = main_pix >= 0 && acc_w > 0.0f;
    float wz;
    const uint32_t key = pack_key(main_ok ? main_pix : -1, main_ok ? acc_w : 0.0f,
                                  wl_idx, P, p.k_pool, p.key_shift, wz);
    st.landed[r] += wz;
    const int e = (e0 + p.rp_off[r]) * kThreads + threadIdx.x;
    sg.key[e] = key;
    sg.w[e] = wz;
    if (p.passes[r] == 2) {
      const bool band = fabsf(sz) < p.max_abs_dz[r];
      const int ov = dual_pixel(p, r, sx, sy, -zh, !upper, band);
      const bool ov_ok = ov >= 0 && acc_w > 0.0f;
      float wo;
      const uint32_t kov = pack_key(ov_ok ? ov : -1, ov_ok ? acc_w : 0.0f, wl_idx,
                                    P, p.k_pool, p.key_shift, wo);
      sg.key[e + kThreads] = kov;
      sg.w[e + kThreads] = wo;
    }
  }
}

// Shared state of the pack, beside the stage.
struct PackShared {
  int wcnt[kMaxEntries][kWarps];     // live rows per entry and warp
  int cnt[2][kMaxEntries];           // per entry, this block's (read by the cluster)
  int start[kMaxEntries];            // per entry, where this block's rows begin
  int tot[kMaxEntries];              // per entry, the cluster's live rows
  int run[kMaxR];                    // per render, rows placed by earlier groups
};

// Place the staged entries of slots [h0, h0 + nh) at their final rows (see
// the file comment); `parity` alternates the published counts between
// groups. Every thread of every block of the cluster calls it together.
__device__ void flush(const TraceParams& p, const Stage& sg, PackShared& ps, int nh,
                      int parity, int g, cg::cluster_group& cluster,
                      uint32_t* __restrict__ keys, float* __restrict__ wts) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_ent = nh * p.rp;
  __syncthreads();
  for (int e = 0; e < n_ent; ++e) {
    const unsigned b = __ballot_sync(0xFFFFFFFFu, sg.key[e * kThreads + tid] != 0xFFFFFFFFu);
    if (lane == 0) ps.wcnt[e][warp] = __popc(b);
  }
  __syncthreads();
  if (tid < n_ent) {
    int c = 0;
    for (int q = 0; q < kWarps; ++q) c += ps.wcnt[tid][q];
    ps.cnt[parity][tid] = c;
  }
  cluster.sync();
  const int rank = (int)cluster.block_rank();
  if (tid < n_ent) {
    int c[kMaxCta];
#pragma unroll
    for (int q = 0; q < kMaxCta; ++q)
      c[q] = q < p.ncta ? *cluster.map_shared_rank(&ps.cnt[parity][tid], q) : 0;
    int before = 0, tot = 0;
#pragma unroll
    for (int q = 0; q < kMaxCta; ++q) {
      before += q < rank ? c[q] : 0;
      tot += c[q];
    }
    ps.start[tid] = before;
    ps.tot[tid] = tot;
  }
  __syncthreads();
  if (tid == 0) {
    // Entries in order: slot within the group, then render, then pass; a
    // render's entries are its slots in the JAX order.
    for (int hl = 0; hl < nh; ++hl) {
      for (int r = 0; r < p.n_renders; ++r) {
        for (int q = 0; q < p.passes[r]; ++q) {
          const int e = hl * p.rp + p.rp_off[r] + q;
          ps.start[e] += ps.run[r];
          ps.run[r] += ps.tot[e];
        }
      }
    }
  }
  __syncthreads();
  const unsigned lt = (1u << lane) - 1u;
  for (int hl = 0; hl < nh; ++hl) {
    for (int r = 0; r < p.n_renders; ++r) {
      const long long base = p.slab_off[r] + (long long)g * p.rows_block[r];
      for (int q = 0; q < p.passes[r]; ++q) {
        const int e = hl * p.rp + p.rp_off[r] + q;
        const uint32_t k = sg.key[e * kThreads + tid];
        const bool live = k != 0xFFFFFFFFu;
        const unsigned b = __ballot_sync(0xFFFFFFFFu, live);
        if (live) {
          int pos = ps.start[e] + __popc(b & lt);
          for (int w = 0; w < warp; ++w) pos += ps.wcnt[e][w];
          keys[base + pos] = k;
          wts[base + pos] = sg.w[e * kThreads + tid];
        }
      }
    }
  }
  __syncthreads();
}

// Blocks per multiprocessor: what the registers allow (ptxas -v: 80 a
// thread at NF = 20, 64 at NF = 8). Without the minimum ptxas takes 96
// registers at NF = 20 (5 blocks) and spills at NF = 8; on an H100 both
// kernels then run 6-7% slower.
template <int NF>
__global__ void __launch_bounds__(kThreads, NF == 8 ? 8 : 6)
trace_emit_kernel(const TraceParams p, const uint32_t* __restrict__ base,
                  const float* __restrict__ ftab,
                  const float* __restrict__ ptbl, const float* __restrict__ ttbl,
                  uint32_t* __restrict__ keys, float* __restrict__ wts,
                  int32_t* __restrict__ counts, float* __restrict__ fpart,
                  int32_t* __restrict__ spart) {
  static_assert(NF <= kMaxF, "face slots");
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ float tab[];
  __shared__ float red_f[kMaxR + 1][kThreads];
  __shared__ int red_s[kThreads];
  __shared__ PackShared ps;
  const int tid = threadIdx.x;
  // Dynamic shared memory: the table (n_ftab floats, rounded up to 4), then
  // the stage's keys and weights (hg * rp entries each).
  const int tab_words = (p.n_ftab + 3) & ~3;
  const Stage sg{reinterpret_cast<uint32_t*>(tab + tab_words),
                 tab + tab_words + p.hg * p.rp * kThreads};
  for (int i = tid; i < p.n_ftab; i += kThreads) tab[i] = ftab[i];
  if (p.pool) {
    // This block's shape: row blockIdx.x of the pool tables (a block is
    // 128 rays, the geom clock, so every ray of the block shares it).
    __syncthreads();
    const float* prow = ptbl + (size_t)blockIdx.x * (NF * 5);
    const float* trow = ttbl + (size_t)blockIdx.x * (p.n_tris * 13);
    for (int i = tid; i < NF * 5; i += kThreads) tab[p.off_planes + i] = prow[i];
    for (int i = tid; i < p.n_tris * 13; i += kThreads) tab[p.off_tris + i] = trow[i];
  }
  if (tid < kMaxR) ps.run[tid] = 0;
  __syncthreads();

  RayState st;
  st.dropped = 0.0f;
  st.segs = 0;
  for (int r = 0; r < kMaxR; ++r) st.landed[r] = 0.0f;

  // Every thread runs the ray code, so that all of them reach the pack's
  // barriers; a thread past the block's rays traces a ray of weight 0.
  const int g = blockIdx.x / p.ncta;
  const int ray = (int)cluster.block_rank() * kThreads + tid;
  const bool active = ray < p.nr;
  const int t = g * p.nr + ray;
  const int K = p.k_pool;
  const uint32_t base_lo = __ldg(base), base_hi = __ldg(base + 1);
  const uint32_t ray_idx = base_lo + (uint32_t)t;
  const uint32_t hi = base_hi + (ray_idx < base_lo ? 1u : 0u);
  const uint32_t seed_vec = (hi == 0u) ? p.seed : (p.seed ^ pcg_hash(hi));

  float wl, w0;
  uint32_t wl_idx;
  if (!p.wl_discrete) {
    const uint32_t wseed = seed_vec ^ NONCE_WL ^ 0x6A09E667u;
    const float uwl = uniform(wseed, ray_idx, 0u);
    wl = 380.0f + uwl * 400.0f;
    int wi = (int)(uwl * (float)K);
    wi = wi < K - 1 ? wi : K - 1;
    wl_idx = (uint32_t)wi;
    w0 = tab[p.off_spd + wi];
  } else {
    wl_idx = ray_idx & (uint32_t)(p.n_wl - 1);
    wl = tab[p.off_wl + wl_idx];
    w0 = tab[p.off_wlw + wl_idx];
  }
  const float n_ior = ice_n(wl);
  w0 = (active && t < p.n_active) ? w0 : 0.0f;

  // Sun-cap direction (slots 0-1).
  const uint32_t sseed = seed_vec ^ NONCE_SUN;
  const float us = uniform(sseed, ray_idx, 0u);
  const float xs = us + (1.0f - us) * p.c_cap;
  const float rs = sqrtf(fmaxf(1.0f - xs * xs, 0.0f));
  const float phs = uniform(sseed, ray_idx, 1u) * TWO_PI_F;
  float sin_phs, cos_phs;
  sincosf(phs, &sin_phs, &cos_phs);
  const float ys = cos_phs * rs;
  const float zs = sin_phs * rs;
  const float wx = p.a0 * xs - p.a1 * ys - p.a2 * zs;
  const float wy = p.b0 * xs + p.b1 * ys - p.b2 * zs;
  const float wzd = p.c0 * xs + p.c1 * zs;

  // Orientation (slots 0-9 of the orientation stream).
  const uint32_t layer_seed = seed_vec ^ LAYER_NONCE;
  const uint32_t oseed = layer_seed ^ NONCE_ORIENT;
  float cb, sb, lon;
  bool flip = false;
  if (p.lat_path == 0) {
    float u_fs = uniform(oseed, ray_idx, 0u) * 2.0f - 1.0f;
    u_fs = fminf(fmaxf(u_fs, -1.0f), 1.0f);
    cb = u_fs;
    sb = -sqrtf(fmaxf(1.0f - u_fs * u_fs, 0.0f));
    lon = uniform(oseed, ray_idx, 1u) * TWO_PI_F;
  } else {
    float phi;
    if (p.lat_path == 1) {
      phi = p.lat_mean;
    } else if (p.lat_path == 3) {
      const float raw = sample_dist(oseed, ray_idx, 2u, 5, p.lat_mean, p.lat_std);
      float theta = HALF_PI_F - raw;
      float rem = fmodf(theta, TWO_PI_F);
      if (rem != 0.0f && rem < 0.0f) rem = rem + TWO_PI_F;
      theta = rem;
      flip = theta > PI_F;
      theta = flip ? TWO_PI_F - theta : theta;
      phi = HALF_PI_F - theta;
    } else {
      const float* cdf = tab + p.off_cdf;
      float xi = uniform(oseed, ray_idx, 4u);
      xi = fminf(fmaxf(xi, p.lut_c_first), p.lut_c_last);
      int lo_cnt = 0;
      float c0v = -3.0e38f, c1v = 3.0e38f;
      for (int j = 0; j < p.lut_n; ++j) {
        const float cv = cdf[j];
        const bool cmp = cv <= xi;
        lo_cnt += cmp ? 1 : 0;
        if (j < p.lut_n - 1 && cmp) c0v = cv;
        if (!cmp && c1v >= 3.0e38f) c1v = cv;
      }
      c1v = fminf(c1v, p.lut_c_last);
      int lo = lo_cnt - 1;
      lo = lo < 0 ? 0 : (lo > p.lut_n - 2 ? p.lut_n - 2 : lo);
      const float denom = c1v - c0v;
      const float wlut = denom > 0.0f ? (xi - c0v) / denom : 0.0f;
      const float colat = p.lut_t0 + ((float)lo + wlut) * p.lut_dt;
      float tt = 0.0f;
      if (p.lut_has_span) tt = (colat - p.lut_tspan0) / p.lut_span;
      int fb = (int)(tt * (float)(p.lut_n - 1));
      fb = fb < 0 ? 0 : (fb > p.lut_n - 2 ? p.lut_n - 2 : fb);
      const float flip_p = tab[p.off_flip + fb];
      phi = HALF_PI_F - colat;
      flip = uniform(oseed, ray_idx, 5u) < flip_p;
    }
    const float b = phi - PI_F / 2.0f;
    sincosf(b, &sb, &cb);
    lon = sample_dist(oseed, ray_idx, 6u, p.az_type, p.az_mean, p.az_std);
  }
  float roll = sample_dist(oseed, ray_idx, 8u, p.roll_type, p.roll_mean, p.roll_std);
  if (flip) {
    lon = lon + PI_F;
    roll = roll + PI_F;
  }
  const float a = lon - PI_F;
  float ca, sa, cc, sc;
  sincosf(a, &sa, &ca);
  sincosf(roll, &sc, &cc);
  const float r00 = ca * cb * cc - sa * sc, r01 = -ca * cb * sc - sa * cc,
              r02 = ca * sb;
  const float r10 = sa * cb * cc + ca * sc, r11 = -sa * cb * sc + ca * cc,
              r12 = sa * sb;
  const float r20 = -sb * cc, r21 = sb * sc, r22 = cb;
  const float dx = r00 * wx + r10 * wy + r20 * wzd;
  const float dy = r01 * wx + r11 * wy + r21 * wzd;
  const float dz = r02 * wx + r12 * wy + r22 * wzd;

  // Entry-face sampling over the fan-triangle table (slots 10-12).
  const float* tris = tab + p.off_tris;
  const uint32_t eseed = layer_seed ^ NONCE_ENTRY;
  float total = 0.0f;
  for (int i = 0; i < p.n_tris; ++i) {
    const float* tr = tris + 13 * i;
    total = total + fmaxf(-(tr[0] * dx + tr[1] * dy + tr[2] * dz), 0.0f);
  }
  const bool entry_ok = total > 0.0f;
  const float target = uniform(eseed, ray_idx, 10u) * total;
  float cdf_acc = 0.0f;
  int sel = 0;
  for (int i = 0; i < p.n_tris; ++i) {
    const float* tr = tris + 13 * i;
    cdf_acc = cdf_acc + fmaxf(-(tr[0] * dx + tr[1] * dy + tr[2] * dz), 0.0f);
    sel += (cdf_acc <= target) ? 1 : 0;
  }
  sel = sel > p.n_tris - 1 ? p.n_tris - 1 : sel;
  float u = uniform(eseed, ray_idx, 11u);
  float v = uniform(eseed, ray_idx, 12u);
  if (u + v > 1.0f) {
    u = 1.0f - u;
    v = 1.0f - v;
  }
  const float* ts = tris + 13 * sel;
  const float px0 = ts[3] + u * ts[6] + v * ts[9];
  const float py0 = ts[4] + u * ts[7] + v * ts[10];
  const float pz0 = ts[5] + u * ts[8] + v * ts[11];
  const int f0 = (int)(ts[12] + 0.5f);
  const float w = entry_ok ? w0 : 0.0f;

  // Face table, indexed by slot: nx, ny, nz, d, present.
  const float* pl = tab + p.off_planes;
  const int f0c = f0 < 0 ? 0 : (f0 > NF - 1 ? NF - 1 : f0);
  const float n0x = pl[5 * f0c], n0y = pl[5 * f0c + 1], n0z = pl[5 * f0c + 2];
  const Split s0 = fresnel(dx, dy, dz, n0x, n0y, n0z, w, n_ior);
  const float e0x = r00 * s0.rx + r01 * s0.ry + r02 * s0.rz;
  const float e0y = r10 * s0.rx + r11 * s0.ry + r12 * s0.rz;
  const float e0z = r20 * s0.rx + r21 * s0.ry + r22 * s0.rz;
  const float exit0_w = entry_ok ? s0.wr : 0.0f;

  float dists[NF];
#pragma unroll
  for (int i = 0; i < NF; ++i) {
    dists[i] = px0 * pl[5 * i] + py0 * pl[5 * i + 1] + pz0 * pl[5 * i + 2] +
               pl[5 * i + 3];
  }

  const uint32_t gate_seed = layer_seed ^ NONCE_GATE;
  const uint32_t rr_seed = layer_seed ^ NONCE_EMIT;
  float cx = s0.tx, cy = s0.ty, cz = s0.tz, cw = s0.wt;
  int prev_f = f0;
  // Slot 0 is the entry reflection; slot h > 0 the exit after bounce h. One
  // call site each for the emit and the flush keeps the kernel's code small.
  for (int h = 0; h < p.h; ++h) {
    float ex = e0x, ey = e0y, ez = e0z, emit_w = exit0_w;
    if (h > 0) {
      float t_best = 1e30f;
      int fi = 0;
#pragma unroll
      for (int i = 0; i < NF; ++i) {
        const float denom = cx * pl[5 * i] + cy * pl[5 * i + 1] + cz * pl[5 * i + 2];
        const float t_f = -dists[i] / (fabsf(denom) > 1e-30f ? denom : 1e-30f);
        const bool cand = denom > SLAB_EPS && prev_f != i && pl[5 * i + 4] > 0.5f;
        const float t_m = cand ? t_f : 1e30f;
        if (t_m < t_best) {
          fi = i;
          t_best = t_m;
        }
      }
      const bool found = t_best < 5e29f && t_best > -SLAB_EPS;
      const bool alive = found && cw > 0.0f;
      const float nfx = pl[5 * fi], nfy = pl[5 * fi + 1], nfz = pl[5 * fi + 2];
      if (alive) {
        // The same denominators as above, recomputed rather than held.
#pragma unroll
        for (int i = 0; i < NF; ++i) {
          const float denom = cx * pl[5 * i] + cy * pl[5 * i + 1] + cz * pl[5 * i + 2];
          dists[i] = dists[i] + t_best * denom;
        }
      }
      const Split sp = fresnel(cx, cy, cz, nfx, nfy, nfz, cw, n_ior);
      const float cos_exit = sp.tx * nfx + sp.ty * nfy + sp.tz * nfz;
      const bool emit_ok = alive && !sp.tir && cos_exit > 0.0f;
      emit_w = emit_ok ? sp.wt : 0.0f;
      ex = r00 * sp.tx + r01 * sp.ty + r02 * sp.tz;
      ey = r10 * sp.tx + r11 * sp.ty + r12 * sp.tz;
      ez = r20 * sp.tx + r21 * sp.ty + r22 * sp.tz;
      if (alive) {
        cx = sp.rx; cy = sp.ry; cz = sp.rz;
        cw = sp.wr;
        prev_f = fi;
      } else {
        cw = 0.0f;
      }
    }
    emit_slot(p, h, ex, ey, ez, emit_w, ray_idx, gate_seed, rr_seed, wl_idx, sg, st);
    if (h % p.hg == p.hg - 1 || h == p.h - 1)
      flush(p, sg, ps, h % p.hg + 1, (h / p.hg) & 1, g, cluster, keys, wts);
  }

  // The tail of each render's block, past its live rows, shared among the
  // cluster's blocks; the live count.
  const int rank = (int)cluster.block_rank();
  for (int r = 0; r < p.n_renders; ++r) {
    const long long base = p.slab_off[r] + (long long)g * p.rows_block[r];
    for (int row = ps.run[r] + rank * kThreads + tid; row < p.rows_block[r];
         row += p.ncta * kThreads) {
      keys[base + row] = 0xFFFFFFFFu;
      wts[base + row] = 0.0f;
    }
    if (rank == 0 && tid == 0) counts[r * (p.grid_blocks / p.ncta) + g] = ps.run[r];
  }

  // Per-thread-block partial stats, reduced in a fixed order.
  red_f[0][tid] = st.dropped;
  for (int r = 0; r < kMaxR; ++r) red_f[r + 1][tid] = st.landed[r];
  red_s[tid] = st.segs;
  __syncthreads();
  for (int off = kThreads / 2; off > 0; off >>= 1) {
    if (tid < off) {
      for (int r = 0; r <= kMaxR; ++r) red_f[r][tid] += red_f[r][tid + off];
      red_s[tid] += red_s[tid + off];
    }
    __syncthreads();
  }
  if (tid == 0) {
    for (int r = 0; r <= p.n_renders; ++r)
      fpart[(long long)blockIdx.x * (p.n_renders + 1) + r] = red_f[r][0];
    spart[blockIdx.x] = red_s[0];
  }
  // No block leaves while another may still read its counts.
  cluster.sync();
}

}  // namespace

namespace {

// Launch for the plan's face-slot count as clusters of p.ncta blocks; the
// caller reads the launch error.
template <int NF>
void launch_nf(const TraceParams& p, const void* base, const void* ftab, const void* ptbl,
               const void* ttbl, void* keys, void* wts, void* counts, void* fpart,
               void* spart, void* stream) {
  auto kernel = trace_emit_kernel<NF>;
  const size_t smem = (size_t)(((p.n_ftab + 3) & ~3) + 2 * p.hg * p.rp * kThreads) * 4;
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem) != cudaSuccess)
    return;
  if (p.ncta > 8 &&
      cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1) !=
          cudaSuccess)
    return;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)p.grid_blocks, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)p.ncta;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaLaunchKernelEx(&cfg, kernel, p, (const uint32_t*)base, (const float*)ftab,
                     (const float*)ptbl, (const float*)ttbl, (uint32_t*)keys, (float*)wts,
                     (int32_t*)counts, (float*)fpart, (int32_t*)spart);
}

bool plan_ok(const TraceParams& p) {
  return (p.nf == 8 || p.nf == kMaxF) && p.ncta >= 1 && p.ncta <= kMaxCta &&
         p.ncta * kThreads >= p.nr && p.rp >= 1 && p.hg >= 1 &&
         p.hg * p.rp <= kMaxEntries && p.grid_blocks % p.ncta == 0;
}

void launch_trace(const TraceParams& p, const void* base, const void* ftab, const void* ptbl,
                  const void* ttbl, void* keys, void* wts, void* counts, void* fpart,
                  void* spart, void* stream) {
  if (p.nf == 8)
    launch_nf<8>(p, base, ftab, ptbl, ttbl, keys, wts, counts, fpart, spart, stream);
  else
    launch_nf<kMaxF>(p, base, ftab, ptbl, ttbl, keys, wts, counts, fpart, spart, stream);
}

}  // namespace

// Static-geometry mode (K2): the face and triangle tables are in ftab. base:
// the ray base's two u32 words (low, high) in device memory.
extern "C" int iht_trace_emit(const void* params, const void* base, const void* ftab,
                              void* keys, void* wts, void* counts, void* fpart,
                              void* spart, void* stream) {
  const TraceParams& p = *(const TraceParams*)params;
  if (p.pool || !plan_ok(p)) return (int)cudaErrorInvalidValue;
  launch_trace(p, base, ftab, nullptr, nullptr, keys, wts, counts, fpart, spart, stream);
  return (int)cudaGetLastError();
}

// Blocked-pool mode (K2b): block b traces the shape in row b of ptbl
// [batch / 128, nf * 5] and ttbl [batch / 128, n_tris * 13].
extern "C" int iht_trace_emit_pool(const void* params, const void* base,
                                   const void* ftab, const void* ptbl, const void* ttbl,
                                   void* keys, void* wts, void* counts, void* fpart,
                                   void* spart, void* stream) {
  const TraceParams& p = *(const TraceParams*)params;
  if (!p.pool || p.nr % kThreads || !plan_ok(p)) return (int)cudaErrorInvalidValue;
  launch_trace(p, base, ftab, ptbl, ttbl, keys, wts, counts, fpart, spart, stream);
  return (int)cudaGetLastError();
}
