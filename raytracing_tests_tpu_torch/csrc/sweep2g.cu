// Grouped nearest-hit sweep over rotated ellipsoids and cuboids for a batch of
// rays, for Hopper (sm_90a).
//
// Replaces the TPU kernel raytracing_tests_tpu/kernels/sweep2g.py::
// _sweep2g_nearest_kernel (launched by _sweep2g): the occlusion-grade nearest
// (t, obj) per ray over the generic tables, whose body (rt::nearest_hit_g) is
// the one the persistent path tracer runs per tree node.
//
// What bounds it on this card: operations.  A ray moves 32 bytes in and 8
// bytes out, and tests every row of every group whose slab (behind its
// super-group's slab) the ray enters: about 20 fp32 operations for a censused
// sphere row, about 60 for a y-rotated cuboid, over 100 for a fully rotated
// ellipsoid with its divisions.  So nothing is staged: one thread per ray,
// rays in SoA rows so a warp's loads coalesce, tables read through the
// read-only path where a warp walking one group shares each row's load.  The
// TPU version skips a group only when no lane of a 2048-ray block enters it
// and packs (t, id) into one integer key to halve its reductions; here each
// thread skips for itself and keeps the full t.
//
// Four instantiations: static and MOTION, each also as EDGE, which adds the
// silhouette candidate of the gradient path (generic_edge).  The TPU kernel's
// with_edge variant gives up its packed key and census shortcuts to compute
// it; here the nearest (t, obj) of both is rt::nearest_hit_g's.
#include "rt_common.cuh"

namespace {

// Silhouette candidate of one ray (replaces the TPU kernel's with_edge
// metric, kernels/sweep2g.py:689-714): the VALID row with the least
// |e|^2 - (e.f)^2 / |f|^2 - 1, the squared distance from the row's centre to
// the ray's line in the row's unit space less 1 (e = R^T (o - c + omt dp) /
// scale, f = R^T d / scale), among the rows with e.f < 0 (centre ahead) and
// |f|^2 > 1e-30.  EVERY row of the main table takes part (the TPU kernel sees
// only the groups its 2048-ray block entered, a schedule this port does not
// carry); a strict < in row order keeps the lowest row on a tie; -1 when
// there is no candidate.  A ray with d = 0 has none (|f|^2 = 0) and skips the
// loop.  One thread per ray: the lanes of a warp read the same row at once.
template <bool MOTION>
__device__ __forceinline__ int generic_edge(const rt::Tables& T, float ox, float oy,
                                            float oz, float dx, float dy, float dz,
                                            float omt) {
  float best = rt::BIG_T;
  int edge = -1;
  if (dx == 0.0f && dy == 0.0f && dz == 0.0f) return edge;
  const int n_rows = T.n_groups * T.gr;
  for (int r = 0; r < n_rows; ++r) {
    const float* row = T.otab + (size_t)r * rt::GO_COLS;
    const float4 p = rt::ld4(row);      // px py pz type
    const float4 m = rt::ld4(row + 4);  // dpx dpy dpz valid
    if (!(m.w > 0.0f)) continue;
    const float4 s = rt::ld4(row + 8);  // sx sy sz ri
    float rx = ox - p.x, ry = oy - p.y, rz = oz - p.z;
    if (MOTION) {
      rx = rx + omt * m.x;
      ry = ry + omt * m.y;
      rz = rz + omt * m.z;
    }
    const float4 ra = rt::ld4(row + rt::GO_R00);      // R00 R01 R02 R10
    const float4 rb = rt::ld4(row + rt::GO_R00 + 4);  // R11 R12 R20 R21
    const float r22 = __ldg(row + rt::GO_R00 + 8);
    const float ex = (ra.x * rx + ra.w * ry + rb.z * rz) / s.x;
    const float ey = (ra.y * rx + rb.x * ry + rb.w * rz) / s.y;
    const float ez = (ra.z * rx + rb.y * ry + r22 * rz) / s.z;
    const float fx = (ra.x * dx + ra.w * dy + rb.z * dz) / s.x;
    const float fy = (ra.y * dx + rb.x * dy + rb.w * dz) / s.y;
    const float fz = (ra.z * dx + rb.y * dy + r22 * dz) / s.z;
    const float a = fx * fx + fy * fy + fz * fz;
    const float hb = ex * fx + ey * fy + ez * fz;
    const float cc = ex * ex + ey * ey + ez * ez;
    const float me = cc - hb * hb * (1.0f / fmaxf(a, 1e-30f)) - 1.0f;
    if (hb < 0.0f && a > 1e-30f && me < best) {
      best = me;
      edge = r;
    }
  }
  return edge;
}

template <bool MOTION, bool EDGE>
__global__ void __launch_bounds__(256) sweep2g_kernel(
    rt::Tables T, const float* __restrict__ rays, int B,
    float* __restrict__ t_out, int* __restrict__ obj_out, int* __restrict__ edge_out,
    unsigned long long* __restrict__ stats) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  const size_t s = (size_t)B;
  const float ox = rays[i], oy = rays[s + i], oz = rays[2 * s + i];
  const float dx = rays[3 * s + i], dy = rays[4 * s + i], dz = rays[5 * s + i];
  const float omt = rays[6 * s + i], tlim = rays[7 * s + i];
  const bool live = (dx * dx + dy * dy + dz * dz) > 0.5f;  // dead rays carry d = 0

  float t_best;
  int obj;
  unsigned counts[rt::GC_LEN] = {0, 0, 0};
  rt::nearest_hit_g<MOTION>(T, ox, oy, oz, dx, dy, dz, omt, live, tlim, t_best,
                            obj, stats != nullptr ? counts : nullptr);
  t_out[i] = t_best;
  obj_out[i] = obj;
  if constexpr (EDGE) edge_out[i] = generic_edge<MOTION>(T, ox, oy, oz, dx, dy, dz, omt);
  if (stats != nullptr) {
    for (int k = 0; k < rt::GC_LEN; ++k)
      if (counts[k]) atomicAdd(stats + k, (unsigned long long)counts[k]);
  }
}

}  // namespace

// rays: (8, B) rows ox oy oz dx dy dz omt tlim; t_out, obj_out: (B,), a miss
// gives obj = -1 and t = min(3e38, tlim); edge_out: (B,) int32 or null, the
// silhouette candidate (EDGE instantiation); stats: null, or uint64[3] that gains
// slab tests and the live rows tested in sphere-kind groups and in groups of
// another kind (measurement only).  Launches on `stream`, does not synchronise, returns
// cudaGetLastError().
extern "C" int rt_sweep2g(const void* otab, const void* gaabb, int n_groups,
                          int gr, int n_pgroups, int probe_gr, int n_sgroups,
                          int has_motion, const void* rays, int B, void* t_out,
                          void* obj_out, void* edge_out, void* stats, void* stream) {
  if (B <= 0) return 0;
  rt::Tables T;
  T.otab = static_cast<const float*>(otab);
  T.ftab = nullptr;
  T.gaabb = static_cast<const float*>(gaabb);
  T.n_groups = n_groups;
  T.gr = gr;
  T.n_pgroups = n_pgroups;
  T.probe_gr = probe_gr;
  T.n_sgroups = n_sgroups;
  const int threads = 256;
  const int blocks = (B + threads - 1) / threads;
  const float* r = static_cast<const float*>(rays);
  float* t = static_cast<float*>(t_out);
  int* o = static_cast<int*>(obj_out);
  unsigned long long* st = static_cast<unsigned long long*>(stats);
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  int* eo = static_cast<int*>(edge_out);
  const auto kernel = has_motion ? (eo != nullptr ? sweep2g_kernel<true, true>
                                                  : sweep2g_kernel<true, false>)
                                 : (eo != nullptr ? sweep2g_kernel<false, true>
                                                  : sweep2g_kernel<false, false>);
  RT_LAUNCH(kernel, blocks, threads, cs, T, r, B, t, o, eo, st);
  return static_cast<int>(cudaGetLastError());
}
