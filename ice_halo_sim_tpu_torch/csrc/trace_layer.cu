// Layer-trace kernel KL for Hopper (sm_90a): the render mode of the general
// path's layer trace, core/trace_soa.py trace_layer_soa, one thread per lane.
//
// Replaces no TPU kernel. The JAX package's general trace is XLA, not
// Pallas (ice_halo_sim_tpu/core/trace_soa.py), and its plain port runs each
// bounce as some 19 elementwise operations over [NF, B] tensors and 70 over
// [B], every one of them reading and writing device memory. KL keeps a
// lane's whole state in registers: the entry-triangle CDF and draw
// (slots 10-12 of the entry stream), the entry Fresnel split, the NF plane
// distances and the max_hits - 1 bounces (slab min-t over the face slots,
// Fresnel split, TIR, emit gate).
//
// Bound: bytes. A lane reads 72 B once (seed and ray index as int64, the
// world direction, weight, refractive index and 9 rotation components as
// float32) and writes 20 B per exit slot (dx, dy, dz, w, path) and its
// entry flag; its arithmetic, about 1000 float32 operations, is under the
// card's 20 operations a byte. So the design moves each byte once: inputs
// are read at the lane's index (a warp reads 32 neighbouring words), the
// exits are written slot-major [H, B] (a warp's stores of one slot are
// contiguous), and no intermediate goes to device memory. The pool tables
// are tiny: with one shared shape (no per-lane row index) every block
// stages them in shared memory; with several, each lane reads its own row
// (lane_pool_rows' mapping, passed as an int64 [B] row index) through the
// caches, where the blocked assignment makes neighbouring lanes share it.
//
// Same bits as trace_layer_soa on the card: the build has no contraction
// (--fmad=false), and every multiply, add, IEEE division and square root is
// taken in the plain function's order (the rotations as written, the CDF a
// running sum in triangle order, the Fresnel split of trace_common.cuh).
// The face argmin keeps torch.min's rule for finite values: ties and the
// no-candidate case (every slot at 1e30) go to the lowest face slot. Every
// lane is traced, zero-weight ones included, as the plain function traces
// them.
//
// The kernel is a template on the face-slot count NF (8 prism, 20 with a
// pyramid): the plane distances are NF registers. The entry point returns
// cudaGetLastError() after its launch.

#include <cstdint>
#include <cuda_runtime.h>

#include "trace_common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr uint32_t NONCE_ENTRY = 0x165667B1u;
constexpr float SLAB_EPS = 1e-5f;
constexpr float BIG = 1e30f;

}  // namespace

// One call's pointers and sizes; mirrored by _LayerArgs in
// ice_halo_sim_tpu_torch/core/trace_soa.py. Passed by value, so a captured
// CUDA graph keeps them.
struct LayerArgs {
  const long long* seed;     // [B] u32 values held in int64
  const long long* ray_idx;  // [B]
  const float* d[3];         // world direction, [B] each
  const float* w0;           // [B]
  const float* n_ior;        // [B]
  const float* rot[9];       // rotation components, row-major, [B] each
  const long long* rows;     // [B] pool row of each lane; null: one shared shape
  const float* plane_n;      // [K, NF, 3]
  const float* plane_d;      // [K, NF]
  const uint8_t* present;    // [K, NF] bool
  const int32_t* face_num;   // [K, NF]
  const float* tri_ch;       // [K, T, 3] cross_half
  const float* tri_v0;       // [K, T, 3]
  const float* tri_e1;       // [K, T, 3]
  const float* tri_e2;       // [K, T, 3]
  const int32_t* tri_face;   // [K, T]
  float* out_d[3];           // [H, B] exit directions
  float* out_w;              // [H, B]
  int32_t* out_path;         // [H, B]
  uint8_t* entry_ok;         // [B] bool
  long long b;
  int32_t h, nf, t;
};

namespace {

// A shape's tables, in shared memory (one shared shape) or at the lane's
// row in device memory.
struct Shape {
  const float *pn, *pd, *ch, *v0, *e1, *e2;
  const int32_t *fnum, *tface;
  const uint8_t* pres;
};

// Words of the staged shape: planes (4 NF floats), triangles (12 T floats),
// face numbers and triangle faces (NF + T ints), then the NF present bytes.
int stage_words(int nf, int t) {
  return 5 * nf + 13 * t + (nf + 3) / 4;
}

template <int NF>
__device__ Shape stage_shared(const LayerArgs& a, float* sm) {
  const int T = a.t;
  Shape s;
  float* pn = sm;
  float* pd = pn + 3 * NF;
  float* ch = pd + NF;
  float* v0 = ch + 3 * T;
  float* e1 = v0 + 3 * T;
  float* e2 = e1 + 3 * T;
  int32_t* fnum = reinterpret_cast<int32_t*>(e2 + 3 * T);
  int32_t* tface = fnum + NF;
  uint8_t* pres = reinterpret_cast<uint8_t*>(tface + T);
  for (int j = threadIdx.x; j < 3 * NF; j += kThreads) pn[j] = a.plane_n[j];
  for (int j = threadIdx.x; j < NF; j += kThreads) {
    pd[j] = a.plane_d[j];
    fnum[j] = a.face_num[j];
    pres[j] = a.present[j];
  }
  for (int j = threadIdx.x; j < 3 * T; j += kThreads) {
    ch[j] = a.tri_ch[j];
    v0[j] = a.tri_v0[j];
    e1[j] = a.tri_e1[j];
    e2[j] = a.tri_e2[j];
  }
  for (int j = threadIdx.x; j < T; j += kThreads) tface[j] = a.tri_face[j];
  __syncthreads();
  s.pn = pn; s.pd = pd; s.ch = ch; s.v0 = v0; s.e1 = e1; s.e2 = e2;
  s.fnum = fnum; s.tface = tface; s.pres = pres;
  return s;
}

template <int NF>
__device__ Shape shape_row(const LayerArgs& a, long long row) {
  const long long T = a.t;
  Shape s;
  s.pn = a.plane_n + row * NF * 3;
  s.pd = a.plane_d + row * NF;
  s.pres = a.present + row * NF;
  s.fnum = a.face_num + row * NF;
  s.ch = a.tri_ch + row * T * 3;
  s.v0 = a.tri_v0 + row * T * 3;
  s.e1 = a.tri_e1 + row * T * 3;
  s.e2 = a.tri_e2 + row * T * 3;
  s.tface = a.tri_face + row * T;
  return s;
}

template <int NF>
__global__ void __launch_bounds__(kThreads) trace_layer_kernel(const LayerArgs a) {
  extern __shared__ float sm[];
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  Shape g;
  if (a.rows == nullptr) {
    g = stage_shared<NF>(a, sm);  // every thread of the block, then a barrier
    if (i >= a.b) return;
  } else {
    if (i >= a.b) return;
    g = shape_row<NF>(a, a.rows[i]);
  }
  const int T = a.t;
  const long long B = a.b;
  const uint32_t idx = (uint32_t)a.ray_idx[i];
  const uint32_t eseed = (uint32_t)a.seed[i] ^ NONCE_ENTRY;
  const float wx = a.d[0][i], wy = a.d[1][i], wz = a.d[2][i];
  const float r00 = a.rot[0][i], r01 = a.rot[1][i], r02 = a.rot[2][i];
  const float r10 = a.rot[3][i], r11 = a.rot[4][i], r12 = a.rot[5][i];
  const float r20 = a.rot[6][i], r21 = a.rot[7][i], r22 = a.rot[8][i];
  const float n_ior = a.n_ior[i];
  // rot_apply_inv: crystal = R^T world.
  const float dx = r00 * wx + r10 * wy + r20 * wz;
  const float dy = r01 * wx + r11 * wy + r21 * wz;
  const float dz = r02 * wx + r12 * wy + r22 * wz;

  // Entry triangle (slots 10-12): the CDF is a running sum in triangle
  // order, taken twice (its total first, then the count at or under the
  // target) rather than held.
  float total = 0.0f;
  for (int t = 0; t < T; ++t) {
    const float* c = g.ch + 3 * t;
    total = total + fmaxf(-(c[0] * dx + c[1] * dy + c[2] * dz), 0.0f);
  }
  const bool entry_ok = total > 0.0f;
  const float target = uniform(eseed, idx, 10u) * total;
  float run = 0.0f;
  int sel = 0;
  for (int t = 0; t < T; ++t) {
    const float* c = g.ch + 3 * t;
    run = run + fmaxf(-(c[0] * dx + c[1] * dy + c[2] * dz), 0.0f);
    sel += (run <= target) ? 1 : 0;
  }
  sel = sel < T - 1 ? sel : T - 1;
  float u = uniform(eseed, idx, 11u);
  float v = uniform(eseed, idx, 12u);
  if (u + v > 1.0f) {
    u = 1.0f - u;
    v = 1.0f - v;
  }
  const float* tv0 = g.v0 + 3 * sel;
  const float* te1 = g.e1 + 3 * sel;
  const float* te2 = g.e2 + 3 * sel;
  const float px = tv0[0] + u * te1[0] + v * te2[0];
  const float py = tv0[1] + u * te1[1] + v * te2[1];
  const float pz = tv0[2] + u * te1[2] + v * te2[2];
  int f0 = g.tface[sel];
  f0 = f0 < 0 ? 0 : (f0 > NF - 1 ? NF - 1 : f0);
  const float w = entry_ok ? a.w0[i] : 0.0f;

  // Entry Fresnel (air -> ice): the reflected child exits as slot 0.
  const Split s0 = fresnel(dx, dy, dz, g.pn[3 * f0], g.pn[3 * f0 + 1], g.pn[3 * f0 + 2], w,
                           n_ior);
  a.out_d[0][i] = r00 * s0.rx + r01 * s0.ry + r02 * s0.rz;
  a.out_d[1][i] = r10 * s0.rx + r11 * s0.ry + r12 * s0.rz;
  a.out_d[2][i] = r20 * s0.rx + r21 * s0.ry + r22 * s0.rz;
  a.out_w[i] = entry_ok ? s0.wr : 0.0f;
  a.out_path[i] = g.fnum[f0];
  a.entry_ok[i] = entry_ok ? 1 : 0;

  float dist[NF];
#pragma unroll
  for (int f = 0; f < NF; ++f)
    dist[f] = px * g.pn[3 * f] + py * g.pn[3 * f + 1] + pz * g.pn[3 * f + 2] + g.pd[f];

  float cx = s0.tx, cy = s0.ty, cz = s0.tz, cw = s0.wt;
  int prev_f = f0;
  for (int h = 1; h < a.h; ++h) {
    float t_best = BIG;
    int fi = 0;
#pragma unroll
    for (int f = 0; f < NF; ++f) {
      const float denom = cx * g.pn[3 * f] + cy * g.pn[3 * f + 1] + cz * g.pn[3 * f + 2];
      const float t_f = -dist[f] / (fabsf(denom) > 1e-30f ? denom : 1e-30f);
      const bool cand = denom > SLAB_EPS && g.pres[f] && f != prev_f;
      const float t_m = cand ? t_f : BIG;
      if (t_m < t_best) {
        fi = f;
        t_best = t_m;
      }
    }
    const bool found = t_best < 5e29f && t_best > -SLAB_EPS;
    const bool alive = found && cw > 0.0f;
    const float nfx = g.pn[3 * fi], nfy = g.pn[3 * fi + 1], nfz = g.pn[3 * fi + 2];
    if (alive) {
      // The same denominators as above, recomputed rather than held.
#pragma unroll
      for (int f = 0; f < NF; ++f) {
        const float denom = cx * g.pn[3 * f] + cy * g.pn[3 * f + 1] + cz * g.pn[3 * f + 2];
        dist[f] = dist[f] + t_best * denom;
      }
    }
    const Split sp = fresnel(cx, cy, cz, nfx, nfy, nfz, cw, n_ior);
    const float cos_exit = sp.tx * nfx + sp.ty * nfy + sp.tz * nfz;
    const bool emit_ok = alive && !sp.tir && cos_exit > 0.0f;
    const long long o = h * B + i;
    a.out_d[0][o] = r00 * sp.tx + r01 * sp.ty + r02 * sp.tz;
    a.out_d[1][o] = r10 * sp.tx + r11 * sp.ty + r12 * sp.tz;
    a.out_d[2][o] = r20 * sp.tx + r21 * sp.ty + r22 * sp.tz;
    a.out_w[o] = emit_ok ? sp.wt : 0.0f;
    a.out_path[o] = alive ? g.fnum[fi] : 0;
    if (alive) {
      cx = sp.rx; cy = sp.ry; cz = sp.rz;
      cw = sp.wr;
      prev_f = fi;
    } else {
      cw = 0.0f;
    }
  }
}

template <int NF>
void launch_nf(const LayerArgs& a, cudaStream_t stream) {
  const unsigned grid = (unsigned)((a.b + kThreads - 1) / kThreads);
  const size_t smem = a.rows == nullptr ? (size_t)stage_words(NF, a.t) * 4 : 0;
  trace_layer_kernel<NF><<<grid, kThreads, smem, stream>>>(a);
}

}  // namespace

// One launch over the call's B lanes. Returns cudaErrorInvalidValue for a
// face-slot count other than 8 or 20, or a shared shape too large for the
// default 48 KB of shared memory (no shape of the port comes near it).
extern "C" int iht_trace_layer(const void* args, void* stream) {
  const LayerArgs& a = *(const LayerArgs*)args;
  if ((a.nf != 8 && a.nf != 20) || a.t < 1 || a.h < 1 || a.b < 1 ||
      (size_t)stage_words(a.nf, a.t) * 4 > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  if (a.nf == 8)
    launch_nf<8>(a, (cudaStream_t)stream);
  else
    launch_nf<20>(a, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}
