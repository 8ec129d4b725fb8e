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
// The emit mode (iht_trace_layer_emit) runs the layer's epilogue in the
// same thread, after each exit slot is traced: the probability gate
// (stream 100 + h of the layer seed ^ NONCE_GATE), the emit floor on the
// accumulated weight (cut = the batch's mean initial weight, read from
// device memory, times the floor fraction; Russian roulette on stream h
// of the layer seed ^ NONCE_EMIT), the slot cap in slot order (a lane's
// live exits go to rows 0, 1, ... of its column, those past the cap are
// dropped; with the cap at max_hits each slot keeps its own row) and the
// projection into every render (projection.cuh, K2's). It writes per
// (render, pass) the pixel and weight of each kept row [rows, B], -1 and 0
// past the lane's live rows; per lane the deepest live raw exit slot and
// the dropped mass (the floor's net change and the cap's drop, a float32
// running sum in slot order); and, on a layer that is not the last, the
// continuation's inputs [H, B] (exit directions and the continuing
// weight). No path, no entry flag. Its plain twin is
// core/trace_soa.py layer_epilogue after trace_layer_soa, bit for bit.
//
// The kernel is a template on the face-slot count NF (8 prism, 20 with a
// pyramid): the plane distances are NF registers. The entry points return
// cudaGetLastError() after their launch.

#include <cstdint>
#include <cuda_runtime.h>

#include "projection.cuh"
#include "trace_common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr uint32_t NONCE_ENTRY = 0x165667B1u;
constexpr uint32_t NONCE_GATE = 0xD3A2646Cu;
constexpr uint32_t NONCE_EMIT = 0x94D049BBu;
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

// The emit mode's arguments; mirrored by _EmitArgs in
// ice_halo_sim_tpu_torch/core/trace_soa.py.
struct EmitArgs {
  const float* w_scale;  // [] the batch's mean initial weight
  int32_t* out_pix[2 * kMaxR];  // [rows, B] per (render, pass)
  float* out_w[2 * kMaxR];      // [rows, B]
  int32_t* out_seg;      // [B] deepest live raw exit slot + 1 (0: none)
  float* out_drop;       // [B] dropped mass
  float prob, emit_frac;
  int32_t emit_mode;     // 0 off, 1 Russian roulette, 2 drop
  int32_t last;          // 1: the last layer (no continuation written)
  int32_t cap;           // rows a lane keeps (< h: live-first compaction)
  Renders ren;
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

// The render mode's writes: slot-major exits [H, B] and the entry flag.
struct RenderOut {
  const LayerArgs& a;
  long long i;

  __device__ __forceinline__ void entry(bool ok) { a.entry_ok[i] = ok ? 1 : 0; }

  __device__ __forceinline__ void exit(int h, float ex, float ey, float ez, float w,
                                       int32_t path) {
    const long long o = h * a.b + i;
    a.out_d[0][o] = ex;
    a.out_d[1][o] = ey;
    a.out_d[2][o] = ez;
    a.out_w[o] = w;
    a.out_path[o] = path;
  }

  __device__ __forceinline__ void finish() {}
};

// The emit mode's epilogue of one lane (see the file comment).
struct EmitOut {
  const LayerArgs& a;
  const EmitArgs& e;
  long long i;
  uint32_t idx, gate_seed, rr_seed;
  float cut;
  float drop = 0.0f;
  int rank = 0, seg = 0;

  __device__ __forceinline__ void entry(bool) {}

  // Row `row` of every (render, pass) column: the pixels of the exit
  // direction, or -1 and 0 where the weight is 0.
  __device__ __forceinline__ void put(int row, float ex, float ey, float ez, float w) {
    const long long o = row * a.b + i;
    int rp = 0;
    for (int r = 0; r < e.ren.n; ++r) {
      int main_pix = -1, ov = -1;
      if (w > 0.0f) project_exit(e.ren, r, ex, ey, ez, main_pix, ov);
      const bool main_ok = main_pix >= 0 && w > 0.0f;
      e.out_pix[rp][o] = main_ok ? main_pix : -1;
      e.out_w[rp][o] = main_ok ? w : 0.0f;
      ++rp;
      if (e.ren.passes[r] == 2) {
        const bool ov_ok = ov >= 0 && w > 0.0f;
        e.out_pix[rp][o] = ov_ok ? ov : -1;
        e.out_w[rp][o] = ov_ok ? w : 0.0f;
        ++rp;
      }
    }
  }

  __device__ __forceinline__ void exit(int h, float ex, float ey, float ez, float w_raw,
                                       int32_t) {
    if (w_raw > 0.0f) seg = h + 1;
    float acc = w_raw;
    bool cont = false;
    if (e.prob > 0.0f) {
      const float u = uniform(gate_seed, idx, 100u + (uint32_t)h);
      if (e.last) {
        acc = (u >= e.prob) ? w_raw : 0.0f;
      } else {
        cont = u < e.prob && w_raw > 0.0f;
        acc = cont ? 0.0f : w_raw;
      }
    }
    if (!e.last) {
      const long long o = h * a.b + i;
      a.out_d[0][o] = ex;
      a.out_d[1][o] = ey;
      a.out_d[2][o] = ez;
      a.out_w[o] = cont ? w_raw : 0.0f;
    }
    if (e.emit_mode != 0) {
      const bool tiny = acc > 0.0f && acc < cut;
      float nw;
      if (e.emit_mode == 1) {
        const float urr = uniform(rr_seed, idx, (uint32_t)h);
        nw = tiny ? ((urr * cut < acc) ? cut : 0.0f) : acc;
      } else {
        nw = tiny ? 0.0f : acc;
      }
      drop = drop + (acc - nw);
      acc = nw;
    }
    const bool live = acc > 0.0f;
    if (e.cap < a.h) {
      const bool kept = live && rank < e.cap;
      drop = drop + ((live && !kept) ? acc : 0.0f);
      if (kept) put(rank, ex, ey, ez, acc);
      rank += live ? 1 : 0;
    } else {
      put(h, ex, ey, ez, acc);
    }
  }

  __device__ __forceinline__ void finish() {
    if (e.cap < a.h)
      for (int row = rank; row < e.cap; ++row) put(row, 0.0f, 0.0f, 0.0f, 0.0f);
    e.out_seg[i] = seg;
    e.out_drop[i] = drop;
  }
};

// One lane's trace; `out` takes its entry flag and each exit slot in order.
template <int NF, class Out>
__device__ __forceinline__ void trace_lane(const LayerArgs& a, const Shape& g, long long i,
                                           Out& out) {
  const int T = a.t;
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
  out.entry(entry_ok);
  out.exit(0, r00 * s0.rx + r01 * s0.ry + r02 * s0.rz, r10 * s0.rx + r11 * s0.ry + r12 * s0.rz,
           r20 * s0.rx + r21 * s0.ry + r22 * s0.rz, entry_ok ? s0.wr : 0.0f, g.fnum[f0]);

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
    out.exit(h, r00 * sp.tx + r01 * sp.ty + r02 * sp.tz, r10 * sp.tx + r11 * sp.ty + r12 * sp.tz,
             r20 * sp.tx + r21 * sp.ty + r22 * sp.tz, emit_ok ? sp.wt : 0.0f,
             alive ? g.fnum[fi] : 0);
    if (alive) {
      cx = sp.rx; cy = sp.ry; cz = sp.rz;
      cw = sp.wr;
      prev_f = fi;
    } else {
      cw = 0.0f;
    }
  }
  out.finish();
}

// The lane's shape: staged in shared memory by every thread of the block
// (then a barrier) for one shared shape, else its own pool row. False for
// a thread past the last lane.
template <int NF>
__device__ __forceinline__ bool lane_shape(const LayerArgs& a, float* sm, long long i,
                                           Shape& g) {
  if (a.rows == nullptr) {
    g = stage_shared<NF>(a, sm);
    return i < a.b;
  }
  if (i >= a.b) return false;
  g = shape_row<NF>(a, a.rows[i]);
  return true;
}

template <int NF>
__global__ void __launch_bounds__(kThreads) trace_layer_kernel(
    const __grid_constant__ LayerArgs a) {
  extern __shared__ float sm[];
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  Shape g;
  if (!lane_shape<NF>(a, sm, i, g)) return;
  RenderOut out{a, i};
  trace_lane<NF>(a, g, i, out);
}

template <int NF>
__global__ void __launch_bounds__(kThreads) trace_layer_emit_kernel(
    const __grid_constant__ LayerArgs a, const __grid_constant__ EmitArgs e) {
  extern __shared__ float sm[];
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  Shape g;
  if (!lane_shape<NF>(a, sm, i, g)) return;
  const uint32_t seed = (uint32_t)a.seed[i];
  EmitOut out{a, e, i, (uint32_t)a.ray_idx[i], seed ^ NONCE_GATE, seed ^ NONCE_EMIT,
              e.emit_mode != 0 ? *e.w_scale * e.emit_frac : 0.0f};
  trace_lane<NF>(a, g, i, out);
}

template <int NF>
void launch_nf(const LayerArgs& a, const EmitArgs* e, cudaStream_t stream) {
  const unsigned grid = (unsigned)((a.b + kThreads - 1) / kThreads);
  const size_t smem = a.rows == nullptr ? (size_t)stage_words(NF, a.t) * 4 : 0;
  if (e == nullptr)
    trace_layer_kernel<NF><<<grid, kThreads, smem, stream>>>(a);
  else
    trace_layer_emit_kernel<NF><<<grid, kThreads, smem, stream>>>(a, *e);
}

bool layer_args_ok(const LayerArgs& a) {
  return (a.nf == 8 || a.nf == 20) && a.t >= 1 && a.h >= 1 && a.b >= 1 &&
         (size_t)stage_words(a.nf, a.t) * 4 <= 48 * 1024;
}

}  // namespace

// One launch over the call's B lanes. Returns cudaErrorInvalidValue for a
// face-slot count other than 8 or 20, or a shared shape too large for the
// default 48 KB of shared memory (no shape of the port comes near it).
extern "C" int iht_trace_layer(const void* args, void* stream) {
  const LayerArgs& a = *(const LayerArgs*)args;
  if (!layer_args_ok(a)) return (int)cudaErrorInvalidValue;
  if (a.nf == 8)
    launch_nf<8>(a, nullptr, (cudaStream_t)stream);
  else
    launch_nf<20>(a, nullptr, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

// The emit mode: one launch over the call's B lanes. Refuses what
// iht_trace_layer refuses, and a cap outside 1..h or a render count
// outside 1..kMaxR.
extern "C" int iht_trace_layer_emit(const void* args, const void* emit, void* stream) {
  const LayerArgs& a = *(const LayerArgs*)args;
  const EmitArgs& e = *(const EmitArgs*)emit;
  if (!layer_args_ok(a) || e.cap < 1 || e.cap > a.h || e.ren.n < 1 || e.ren.n > kMaxR)
    return (int)cudaErrorInvalidValue;
  if (a.nf == 8)
    launch_nf<8>(a, &e, (cudaStream_t)stream);
  else
    launch_nf<20>(a, &e, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}
