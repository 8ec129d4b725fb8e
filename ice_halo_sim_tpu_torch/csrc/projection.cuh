// Lens projection of exit directions, shared by the trace kernel
// (trace_emit.cu, K2 and K2b) and the layer trace's emit mode
// (trace_layer.cu): the forward maps of core/projection.py
// project_components for the six lenses of projection.SUPPORTED_LENSES
// (linear, fisheye equal-area and orthographic, their dual forms, globe),
// in its float32 operation order. Both sources are built with
// --fmad=false, so a pixel is the plain function's, bit for bit.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxR = 4;  // renders a launch projects into
constexpr float GLOBE_CAMERA_D = 4.0f;

}  // namespace

// Per-render constants of the projection, built on the host by
// core/projection.py render_consts (mirrored there by RenderConsts): the
// plan's fields as float32, and W / 2, H / 2 and of the dual lenses
// short_res / 2, H / 2, W / 2 -+ short_res / 2, computed as the kernel
// would (double, then float).
struct Renders {
  int32_t n;
  int32_t lens[kMaxR], width[kMaxR], height[kMaxR];
  int32_t visible[kMaxR];  // 0 upper, 1 lower, 2 full (single-lens family)
  float r_scale[kMaxR], max_abs_dz[kMaxR];
  float scale[kMaxR], shift_x[kMaxR], shift_y[kMaxR];
  float rot[kMaxR][9];     // camera rotation, row-major
  float half_w[kMaxR], half_h[kMaxR];
  float dual_r[kMaxR], dual_cy[kMaxR], dual_cxu[kMaxR], dual_cxl[kMaxR];
  int32_t passes[kMaxR];   // 2 with the overlap pass, else 1
};

namespace {

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
__device__ __forceinline__ int dual_pixel(const Renders& p, int r, float sx, float sy,
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
__device__ __forceinline__ int single_pixel(const Renders& p, int r, float ex,
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

// Render r's main pixel of exit direction (ex, ey, ez) and, with the
// overlap pass, its overlap pixel (-1 without: the pass is not written).
__device__ __forceinline__ void project_exit(const Renders& p, int r, float ex, float ey,
                                             float ez, int& main_pix, int& ov_pix) {
  const float sx = -ex, sy = -ey, sz = -ez;
  const bool upper = sz >= 0.0f;
  const float zh = fabsf(sz);
  const bool dual = p.lens[r] == 4 || p.lens[r] == 9;
  main_pix = dual ? dual_pixel(p, r, sx, sy, zh, upper, true) : single_pixel(p, r, ex, ey, ez);
  ov_pix = -1;
  if (p.passes[r] == 2) {
    const bool band = fabsf(sz) < p.max_abs_dz[r];
    ov_pix = dual_pixel(p, r, sx, sy, -zh, !upper, band);
  }
}

}  // namespace
