// Device helpers shared by the trace kernels (trace_emit.cu, trace_layer.cu):
// the counter-PCG stream of core/rng.py and the Fresnel split of
// core/trace_soa.py (_fresnel_split_soa), in their float32 operation order.
// Both sources are built with --fmad=false, so every multiply and add rounds
// as the plain PyTorch twins round them.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

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

}  // namespace
