// Trace-and-emit kernel for Hopper (sm_90a), one thread per ray.
//
// Replaces K2 and K2b, ice_halo_sim_tpu/core/pallas_trace.py:
// make_trace_emit (:299), kernel body (:318-601), in its static-geometry
// (K == 1) mode and in its blocked-pool mode (:382-399: per-batch ptbl/ttbl
// inputs, one sampled crystal shape per 128 rays). Per ray: counter-PCG
// streams with the 64-bit epoch mix -> wavelength and SPD weight -> sun-cap
// direction -> orientation -> entry-triangle CDF -> entry Fresnel -> bounce
// loop over the face planes (slab min-t, Fresnel split, TIR) for
// max_hits - 1 bounces -> probability gate and Russian-roulette emit floor
// -> lens projection (linear, fisheye equal-area / orthographic, their dual
// forms with the overlap pass, globe) -> spectral key pack.
//
// The TPU kernel selects every table value with one-hot where-chains
// (_sel_const/_sel_many: Mosaic has no gathers), reads a pooled shape as a
// lane broadcast of its table row, and packs each 2048-ray block in VMEM
// with a butterfly. Here the plan's tables (face table, entry triangles,
// SPD pool or discrete spectrum, latitude LUT) are copied into shared
// memory once per thread block and indexed directly. A thread block is 128
// threads and the pool's geom clock is 128, so in blocked-pool mode ONE
// THREAD BLOCK TRACES EXACTLY ONE SHAPE: it copies its own row of ptbl
// (NF x 5 floats) and ttbl (NF x 4 x 13 floats; 4.6 KB for a pyramid) over
// the face and triangle sections of the shared table, and the ray code is
// the same in both modes. Every face slot and triangle row of a pooled
// shape stays (absent faces masked by their `present` column, dead
// triangles adding a zero cross_half to the CDF), as in the TPU kernel.
// The rows go UNCOMPACTED to a scratch slab in the JAX slab order (per
// 2048-ray block: slot-major; main pass then overlap pass; ray within that;
// padded with key 0xFFFFFFFF, weight 0). The pack kernel (block_ops.cu, K1)
// then compacts each slab stably, which gives the JAX kernel's counts and
// order. Stats (dropped weight, traced segments, landed weight per render)
// go to per-thread-block partials that the wrapper sums.
//
// The kernel is a template on the face-slot count NF (8 prism, 20 with a
// pyramid): the per-ray plane distances are NF registers.
//
// Arithmetic follows the JAX order operation by operation and is built
// with --fmad=false, so it rounds as the plain PyTorch twin does.
// Bound: arithmetic and special functions (about 30 transcendental calls
// and, per ray, some 20 operations per face and bounce plus 16 per entry
// triangle); the slab writes are 8 bytes per row.
//
// Every entry point returns cudaGetLastError() after its launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxR = 4;
constexpr int kMaxF = 20;    // face slots of the pyramid layout
constexpr int kThreads = 128;  // == the pool's geom clock
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
  long long slab_off[kMaxR];  // element offset of each render's slab
  uint32_t seed, base_lo, base_hi;
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
};

namespace {

__device__ __forceinline__ uint32_t pcg_hash(uint32_t x) {
  x = x * 747796405u + 2891336453u;
  x = ((x >> ((x >> 28u) + 4u)) ^ x) * 277803737u;
  return (x >> 22u) ^ x;
}

__device__ __forceinline__ float u01(uint32_t h) {
  return (float)(h >> 8u) * (1.0f / 16777216.0f);
}

__device__ __forceinline__ float uniform(uint32_t seed, uint32_t idx, uint32_t slot) {
  return u01(pcg_hash(seed ^ pcg_hash(idx * 1000003u + slot)));
}

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

struct Split {
  float rx, ry, rz, tx, ty, tz, wr, wt;
  bool tir;
};

__device__ __forceinline__ Split fresnel(float dx, float dy, float dz, float nx,
                                         float ny, float nz, float w, float n_ior) {
  Split s;
  const float cos_t = dx * nx + dy * ny + dz * nz;
  const float rr = (cos_t > 0.0f) ? n_ior : 1.0f / n_ior;
  const float cos_sq = cos_t * cos_t;
  const float delta = (1.0f - rr * rr) / fmaxf(cos_sq, 1e-20f) + rr * rr;
  s.tir = delta <= 0.0f;
  const float ds = s.tir ? 1.0f : fmaxf(delta, 0.0f);
  float ratio = 1.0f;
  if (!s.tir) {
    const float d_sqrt = sqrtf(ds);
    const float rs = (rr - d_sqrt) / (rr + d_sqrt);
    const float rp = (1.0f - rr * d_sqrt) / (1.0f + rr * d_sqrt);
    ratio = 0.5f * (rs * rs + rp * rp);
  }
  s.wr = ratio * w;
  s.wt = s.tir ? 0.0f : w - s.wr;
  const float two_ct = 2.0f * cos_t;
  s.rx = dx - two_ct * nx;
  s.ry = dy - two_ct * ny;
  s.rz = dz - two_ct * nz;
  const float k = (rr - sqrtf(ds)) * cos_t;
  s.tx = s.tir ? s.rx : rr * dx - k * nx;
  s.ty = s.tir ? s.ry : rr * dy - k * ny;
  s.tz = s.tir ? s.rz : rr * dz - k * nz;
  return s;
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
__device__ __forceinline__ void dual_pixel(int lens, float sx, float sy, float zh,
                                           float r_scale, bool upper, int W, int H,
                                           int& px, int& py) {
  float x, y;
  fisheye_xy(lens == 4, sx, sy, zh, r_scale, x, y);
  const int short_res = (W / 2 < H) ? W / 2 : H;
  const float r = (float)(short_res / 2.0);
  const float cy = (float)(H / 2.0);
  const float cx_u = (float)(W / 2.0 - short_res / 2.0);
  const float cx_l = (float)(W / 2.0 + short_res / 2.0);
  const float fx = upper ? (-y) * r + cx_u : y * r + cx_l;
  const float fy = x * r + cy;
  px = (int)floorf(fx + 0.5f);
  py = (int)floorf(fy + 0.5f);
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
  const float fx = x * p.scale[r] + (float)(W / 2.0) + 0.5f + p.shift_x[r];
  const float fy = y * p.scale[r] + (float)(H / 2.0) + 0.5f + p.shift_y[r];
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

__device__ void emit_slot(const TraceParams& p, int h, float ex, float ey, float ez,
                          float w_raw, uint32_t ray_idx, uint32_t gate_seed,
                          uint32_t rr_seed, uint32_t wl_idx, int g, int ray,
                          int shift, uint32_t* keys, float* wts, RayState& st) {
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
  for (int r = 0; r < p.n_renders; ++r) {
    const int W = p.width[r], H = p.height[r], P = W * H;
    const int passes = p.max_abs_dz[r] > 0.0f ? 2 : 1;
    const long long base = p.slab_off[r] + (long long)g * p.rows_block[r];
    const bool dual = p.lens[r] == 4 || p.lens[r] == 9;
    int px, py, main_pix;
    if (dual) {
      dual_pixel(p.lens[r], sx, sy, zh, p.r_scale[r], upper, W, H, px, py);
      main_pix = in_bounds(px, py, true, W, H);
    } else {
      main_pix = single_pixel(p, r, ex, ey, ez);
    }
    const bool main_ok = main_pix >= 0 && acc_w > 0.0f;
    float wz;
    const uint32_t key = pack_key(main_ok ? main_pix : -1, main_ok ? acc_w : 0.0f,
                                  wl_idx, P, p.k_pool, shift, wz);
    st.landed[r] += wz;
    long long row = base + (long long)(h * passes) * p.nr + ray;
    keys[row] = key;
    wts[row] = wz;
    if (passes == 2) {
      dual_pixel(p.lens[r], sx, sy, -zh, p.r_scale[r], !upper, W, H, px, py);
      const bool band = fabsf(sz) < p.max_abs_dz[r];
      const int ov = in_bounds(px, py, band, W, H);
      const bool ov_ok = ov >= 0 && acc_w > 0.0f;
      float wo;
      const uint32_t kov = pack_key(ov_ok ? ov : -1, ov_ok ? acc_w : 0.0f, wl_idx,
                                    P, p.k_pool, shift, wo);
      row += p.nr;
      keys[row] = kov;
      wts[row] = wo;
    }
  }
}

template <int NF>
__global__ void __launch_bounds__(kThreads)
trace_emit_kernel(const TraceParams p, const float* __restrict__ ftab,
                  const float* __restrict__ ptbl, const float* __restrict__ ttbl,
                  uint32_t* __restrict__ keys, float* __restrict__ wts,
                  float* __restrict__ fpart, int32_t* __restrict__ spart) {
  static_assert(NF <= kMaxF, "face slots");
  extern __shared__ float tab[];
  __shared__ float red_f[kMaxR + 1][kThreads];
  __shared__ int red_s[kThreads];
  for (int i = threadIdx.x; i < p.n_ftab; i += blockDim.x) tab[i] = ftab[i];
  if (p.pool) {
    // This block's shape: row blockIdx.x of the pool tables (blockDim.x ==
    // the geom clock, so every ray of the block shares it).
    __syncthreads();
    const float* prow = ptbl + (size_t)blockIdx.x * (NF * 5);
    const float* trow = ttbl + (size_t)blockIdx.x * (p.n_tris * 13);
    for (int i = threadIdx.x; i < NF * 5; i += blockDim.x) tab[p.off_planes + i] = prow[i];
    for (int i = threadIdx.x; i < p.n_tris * 13; i += blockDim.x)
      tab[p.off_tris + i] = trow[i];
  }
  __syncthreads();

  RayState st;
  st.dropped = 0.0f;
  st.segs = 0;
  for (int r = 0; r < kMaxR; ++r) st.landed[r] = 0.0f;

  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t < p.batch) {
    const int g = t / p.nr;
    const int ray = t - g * p.nr;
    const int K = p.k_pool;
    const int shift = 31 - __clz(2 * K);  // log2(2K)
    const uint32_t ray_idx = p.base_lo + (uint32_t)t;
    const uint32_t hi = p.base_hi + (ray_idx < p.base_lo ? 1u : 0u);
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
    w0 = (t < p.n_active) ? w0 : 0.0f;

    // Sun-cap direction (slots 0-1).
    const uint32_t sseed = seed_vec ^ NONCE_SUN;
    const float us = uniform(sseed, ray_idx, 0u);
    const float xs = us + (1.0f - us) * p.c_cap;
    const float rs = sqrtf(fmaxf(1.0f - xs * xs, 0.0f));
    const float phs = uniform(sseed, ray_idx, 1u) * TWO_PI_F;
    const float ys = cosf(phs) * rs;
    const float zs = sinf(phs) * rs;
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
      cb = cosf(b);
      sb = sinf(b);
      lon = sample_dist(oseed, ray_idx, 6u, p.az_type, p.az_mean, p.az_std);
    }
    float roll = sample_dist(oseed, ray_idx, 8u, p.roll_type, p.roll_mean, p.roll_std);
    if (flip) {
      lon = lon + PI_F;
      roll = roll + PI_F;
    }
    const float a = lon - PI_F;
    const float ca = cosf(a), sa = sinf(a), cc = cosf(roll), sc = sinf(roll);
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

    float dists[NF], denoms[NF];
#pragma unroll
    for (int i = 0; i < NF; ++i) {
      denoms[i] = 0.0f;
      dists[i] = px0 * pl[5 * i] + py0 * pl[5 * i + 1] + pz0 * pl[5 * i + 2] +
                 pl[5 * i + 3];
    }

    const uint32_t gate_seed = layer_seed ^ NONCE_GATE;
    const uint32_t rr_seed = layer_seed ^ NONCE_EMIT;
    emit_slot(p, 0, e0x, e0y, e0z, exit0_w, ray_idx, gate_seed, rr_seed, wl_idx, g,
              ray, shift, keys, wts, st);

    float cx = s0.tx, cy = s0.ty, cz = s0.tz, cw = s0.wt;
    int prev_f = f0;
    for (int h = 1; h < p.h; ++h) {
      float t_best = 1e30f;
      int fi = 0;
#pragma unroll
      for (int i = 0; i < NF; ++i) {
        const float denom = cx * pl[5 * i] + cy * pl[5 * i + 1] + cz * pl[5 * i + 2];
        denoms[i] = denom;
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
#pragma unroll
        for (int i = 0; i < NF; ++i) dists[i] = dists[i] + t_best * denoms[i];
      }
      const Split sp = fresnel(cx, cy, cz, nfx, nfy, nfz, cw, n_ior);
      const float cos_exit = sp.tx * nfx + sp.ty * nfy + sp.tz * nfz;
      const bool emit_ok = alive && !sp.tir && cos_exit > 0.0f;
      const float emit_w = emit_ok ? sp.wt : 0.0f;
      const float ex = r00 * sp.tx + r01 * sp.ty + r02 * sp.tz;
      const float ey = r10 * sp.tx + r11 * sp.ty + r12 * sp.tz;
      const float ez = r20 * sp.tx + r21 * sp.ty + r22 * sp.tz;
      emit_slot(p, h, ex, ey, ez, emit_w, ray_idx, gate_seed, rr_seed, wl_idx, g, ray,
                shift, keys, wts, st);
      if (alive) {
        cx = sp.rx; cy = sp.ry; cz = sp.rz;
        cw = sp.wr;
        prev_f = fi;
      } else {
        cw = 0.0f;
      }
    }

    // Slab padding rows past H * passes * nr.
    for (int r = 0; r < p.n_renders; ++r) {
      const int passes = p.max_abs_dz[r] > 0.0f ? 2 : 1;
      const long long base = p.slab_off[r] + (long long)g * p.rows_block[r];
      for (int row = p.h * passes * p.nr + ray; row < p.rows_block[r]; row += p.nr) {
        keys[base + row] = 0xFFFFFFFFu;
        wts[base + row] = 0.0f;
      }
    }
  }

  // Per-thread-block partial stats, reduced in a fixed order.
  red_f[0][threadIdx.x] = st.dropped;
  for (int r = 0; r < kMaxR; ++r) red_f[r + 1][threadIdx.x] = st.landed[r];
  red_s[threadIdx.x] = st.segs;
  __syncthreads();
  for (int off = kThreads / 2; off > 0; off >>= 1) {
    if (threadIdx.x < off) {
      for (int r = 0; r <= kMaxR; ++r)
        red_f[r][threadIdx.x] += red_f[r][threadIdx.x + off];
      red_s[threadIdx.x] += red_s[threadIdx.x + off];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    for (int r = 0; r <= p.n_renders; ++r)
      fpart[(long long)blockIdx.x * (p.n_renders + 1) + r] = red_f[r][0];
    spart[blockIdx.x] = red_s[0];
  }
}

}  // namespace

namespace {

// Launch for the plan's face-slot count; the caller reads the launch error.
void launch_trace(const TraceParams& p, const void* ftab, const void* ptbl,
                  const void* ttbl, void* keys, void* wts, void* fpart, void* spart,
                  void* stream) {
  const int grid = (p.batch + kThreads - 1) / kThreads;
  const size_t smem = (size_t)p.n_ftab * sizeof(float);
  auto kernel = p.nf == 8 ? trace_emit_kernel<8> : trace_emit_kernel<kMaxF>;
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  }
  kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      p, (const float*)ftab, (const float*)ptbl, (const float*)ttbl, (uint32_t*)keys,
      (float*)wts, (float*)fpart, (int32_t*)spart);
}

}  // namespace

// Static-geometry mode (K2): the face and triangle tables are in ftab.
extern "C" int iht_trace_emit(const void* params, const void* ftab, void* keys,
                              void* wts, void* fpart, void* spart, void* stream) {
  const TraceParams& p = *(const TraceParams*)params;
  if (p.pool || (p.nf != 8 && p.nf != kMaxF)) return (int)cudaErrorInvalidValue;
  launch_trace(p, ftab, nullptr, nullptr, keys, wts, fpart, spart, stream);
  return (int)cudaGetLastError();
}

// Blocked-pool mode (K2b): block b traces the shape in row b of ptbl
// [batch / 128, nf * 5] and ttbl [batch / 128, n_tris * 13].
extern "C" int iht_trace_emit_pool(const void* params, const void* ftab,
                                   const void* ptbl, const void* ttbl, void* keys,
                                   void* wts, void* fpart, void* spart, void* stream) {
  const TraceParams& p = *(const TraceParams*)params;
  if (!p.pool || (p.nf != 8 && p.nf != kMaxF)) return (int)cudaErrorInvalidValue;
  launch_trace(p, ftab, ptbl, ttbl, keys, wts, fpart, spart, stream);
  return (int)cudaGetLastError();
}
