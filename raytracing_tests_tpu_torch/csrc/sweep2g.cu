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
// Four instantiations: static and MOTION, each also as EDGE
// (sweep2g_edge_kernel), which adds the silhouette candidate of the gradient
// path (generic_edge).  The TPU kernel's with_edge variant gives up its packed
// key and census shortcuts to compute it; here the nearest (t, obj) of both is
// rt::nearest_hit_g's, and the candidate comes from the exact per-block cull
// of edge_cull.cuh: a ray evaluates the metric only on the rows of blocks
// whose bound does not lie above its best, warp by warp.
#include "edge_cull.cuh"

namespace {

// The silhouette metric of one row (replaces the TPU kernel's with_edge
// metric, kernels/sweep2g.py:689-714): |e|^2 - (e.f)^2 / |f|^2 - 1, the
// squared distance from the row's centre to the ray's line in the row's unit
// space less 1 (e = R^T (o - c + omt dp) / scale, f = R^T d / scale).  The row
// is a candidate when it is VALID, e.f < 0 (centre ahead) and |f|^2 > 1e-30.
template <bool MOTION>
__device__ __forceinline__ bool generic_metric(const float* row, float ox, float oy,
                                               float oz, float dx, float dy, float dz,
                                               float omt, float& me) {
  const float4 p = rt::ld4(row);      // px py pz type
  const float4 m = rt::ld4(row + 4);  // dpx dpy dpz valid
  if (!(m.w > 0.0f)) return false;
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
  me = cc - hb * hb * (1.0f / fmaxf(a, 1e-30f)) - 1.0f;
  return hb < 0.0f && a > 1e-30f;
}

// Silhouette candidate of one ray: the candidate row of least metric over
// EVERY row of the main table, the lowest row on a tie, -1 when there is none
// (sweep2g_edge_plain; the TPU kernel sees only the groups its 2048-ray block
// entered, a schedule this port does not carry).  A ray with d = 0 has none
// (|f|^2 = 0).  Every lane of the warp calls it: `in` is false past B.
// Seeded with the nearest-hit winner `obj`; the entries' bound is
// edge_cull.cuh's bound: mu hl^2 - 1 less the rounding margins, and +inf
// for an entry whose every centre lies behind the ray.
template <bool MOTION>
__device__ __forceinline__ int generic_edge(const rt::Tables& T,
                                            const float* __restrict__ eblk, int n_super,
                                            bool in, int obj, float ox, float oy, float oz,
                                            float dx, float dy, float dz, float omt,
                                            rt::EdgeCounts& ec) {
  const bool active = in && !(dx == 0.0f && dy == 0.0f && dz == 0.0f);
  const bool hit = obj >= 0;
  rt::EdgeBest best = {rt::BIG_T, -1};
  if (__ballot_sync(rt::WARP_FULL, active && hit)) ++ec.slots;  // the seed's row iteration
  if (active && hit) {
    float me;
    if (generic_metric<MOTION>(T.otab + (size_t)obj * rt::GO_COLS, ox, oy, oz, dx, dy, dz,
                               omt, me))
      best.offer(me, obj);
    ++ec.rows_hit;
  }
  const float dd = dx * dx + dy * dy + dz * dz;
  const float inv_dd = 1.0f / dd;
  const float dn = rt::root(dd) * rt::EB_UP;  // at least |d|
  const bool cull = !MOTION || (omt >= 0.0f && omt <= 1.0f);
  auto bound = [&](const float* e) -> float {
    if (!cull) return -INFINITY;
    const float4 ball = rt::ld4(e), k = rt::ld4(e + rt::EB_MU);  // k: mu errk rho tau
    const rt::BallLine b = rt::ball_line(ball, ox, oy, oz, dx, dy, dz, inv_dd);
    const float vb = b.vn + ball.w;
    const float lr = vb + 2.0f * __ldg(e + rt::EB_DPMAX);
    if (-b.vd > dn * (ball.w + k.z * vb + k.w * lr + rt::EB_SLACK * b.vn))
      return INFINITY;  // every centre behind the ray
    const float m = k.x * b.hl * b.hl * rt::EB_DOWN;
    return m - 1.0f - rt::EB_EPS_G * k.y * lr * lr - rt::EB_EPS_F * (1.0f + m);
  };
  auto visit = [&](int b, bool mine) {
    const float4 w = rt::ld4(eblk + (size_t)b * rt::EB_COLS + rt::EB_ROW0);
    const int row0 = (int)w.x, n = (int)w.y;
    for (int k = 0; k < n; ++k) {
      if (mine) {
        float me;
        if (generic_metric<MOTION>(T.otab + (size_t)(row0 + k) * rt::GO_COLS, ox, oy, oz,
                                   dx, dy, dz, omt, me))
          best.offer(me, row0 + k);
        ++(hit ? ec.rows_hit : ec.rows_miss);
      }
      ++ec.slots;
    }
  };
  rt::edge_walk(eblk, n_super, active, best, bound, visit, ec);
  return best.row;
}

constexpr int THREADS = 256;
// Resident blocks per SM the EDGE instantiations are compiled for: ptxas
// gives them 58 and 60 registers and no spill (PERF.md).
constexpr int EDGE_MIN_BLOCKS = 2;

template <bool MOTION>
__global__ void __launch_bounds__(THREADS) sweep2g_kernel(
    rt::Tables T, const float* __restrict__ rays, int B,
    float* __restrict__ t_out, int* __restrict__ obj_out,
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
  if (stats != nullptr) {
    for (int k = 0; k < rt::GC_LEN; ++k)
      if (counts[k]) atomicAdd(stats + k, (unsigned long long)counts[k]);
  }
}

// Work counters of the EDGE instantiations after the GC_* ones (measurement
// only): EdgeCounts' four.
enum { EC_BOUNDS = rt::GC_LEN, EC_ROWS_HIT, EC_ROWS_MISS, EC_SLOTS, EC_LEN };

// The EDGE instantiation: every lane reaches every warp-wide operation, lanes
// past B with a dead ray, storing nothing.
template <bool MOTION>
__global__ void __launch_bounds__(THREADS, EDGE_MIN_BLOCKS) sweep2g_edge_kernel(
    rt::Tables T, const float* __restrict__ eblk, int n_super, const float* __restrict__ rays,
    int B, float* __restrict__ t_out, int* __restrict__ obj_out, int* __restrict__ edge_out,
    unsigned long long* __restrict__ stats) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool in = i < B;
  const size_t s = (size_t)B;
  float ox = 0.0f, oy = 0.0f, oz = 0.0f, dx = 0.0f, dy = 0.0f, dz = 0.0f;
  float omt = 0.0f, tlim = 0.0f;
  if (in) {
    ox = rays[i];
    oy = rays[s + i];
    oz = rays[2 * s + i];
    dx = rays[3 * s + i];
    dy = rays[4 * s + i];
    dz = rays[5 * s + i];
    omt = rays[6 * s + i];
    tlim = rays[7 * s + i];
  }
  const bool live = in && (dx * dx + dy * dy + dz * dz) > 0.5f;  // dead rays carry d = 0

  float t_best;
  int obj;
  unsigned counts[rt::GC_LEN] = {0, 0, 0};
  rt::nearest_hit_g<MOTION>(T, ox, oy, oz, dx, dy, dz, omt, live, tlim, t_best,
                            obj, stats != nullptr ? counts : nullptr);
  rt::EdgeCounts ec = {};
  const int edge = generic_edge<MOTION>(T, eblk, n_super, in, obj, ox, oy, oz, dx, dy, dz,
                                        omt, ec);
  if (stats != nullptr) {
    const unsigned long long v[EC_LEN] = {counts[0], counts[1], counts[2], ec.bounds,
                                          ec.rows_hit, ec.rows_miss, ec.slots};
    const int lane = threadIdx.x & 31;
    for (int k = 0; k < EC_LEN; ++k) {
      const unsigned long long sum = rt::warp_total(v[k]);
      if (lane == 0 && sum) atomicAdd(stats + k, sum);
    }
  }
  if (!in) return;  // after the last warp-wide operation
  t_out[i] = t_best;
  obj_out[i] = obj;
  edge_out[i] = edge;
}

}  // namespace

// rays: (8, B) rows ox oy oz dx dy dz omt tlim; t_out, obj_out: (B,), a miss
// gives obj = -1 and t = min(3e38, tlim); edge_out: (B,) int32 or null, the
// silhouette candidate (EDGE instantiation), which then reads eblk: the
// accel's block table (EB_COLS wide, n_super super-blocks first),
// kernels/edge_cull.py::block_table;
// stats: null, or uint64[3] (uint64[7] with edge_out) that gains slab tests
// and the live rows tested in sphere-kind groups and in groups of another
// kind, then the EC_* counters (measurement only).  Launches on `stream`,
// does not synchronise, returns cudaGetLastError().
extern "C" int rt_sweep2g(const void* otab, const void* gaabb, int n_groups,
                          int gr, int n_pgroups, int probe_gr, int n_sgroups,
                          int has_motion, const void* rays, int B, void* t_out,
                          void* obj_out, void* edge_out, const void* eblk, int n_super,
                          void* stats, void* stream) {
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
  const int blocks = (B + THREADS - 1) / THREADS;
  const float* r = static_cast<const float*>(rays);
  float* t = static_cast<float*>(t_out);
  int* o = static_cast<int*>(obj_out);
  unsigned long long* st = static_cast<unsigned long long*>(stats);
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  int* eo = static_cast<int*>(edge_out);
  if (eo != nullptr) {
    const float* eb = static_cast<const float*>(eblk);
    const auto kernel = has_motion ? sweep2g_edge_kernel<true> : sweep2g_edge_kernel<false>;
    RT_LAUNCH(kernel, blocks, THREADS, cs, T, eb, n_super, r, B, t, o, eo, st);
  } else {
    const auto kernel = has_motion ? sweep2g_kernel<true> : sweep2g_kernel<false>;
    RT_LAUNCH(kernel, blocks, THREADS, cs, T, r, B, t, o, st);
  }
  return static_cast<int>(cudaGetLastError());
}
