// Grouped nearest-hit sweep over rotated ellipsoids and cuboids for a batch of
// rays, for Hopper (sm_90a).
//
// Replaces the TPU kernel raytracing_tests_tpu/kernels/sweep2g.py:838
// (_sweep2g, the pallas_call of _sweep2g_nearest_kernel): the occlusion-grade
// nearest (t, obj) per ray over the generic tables, and with with_edge the
// silhouette candidate of the gradient path.
//
// What bounds it on this card: operations, as its counters (GC_*) name them.
// A ray moves 32 bytes in and 8 out, but slab-tests every super-group and
// group box its walk reaches (about 26 fp32 operations each) and tests every
// live row of every group it enters: about 20 for a censused sphere row, 48
// for an unrotated or y-rotated cuboid, over 100 for a fully rotated ellipsoid
// with its divisions.  The rays of a warp enter different groups, so a walk of
// one thread per ray issues the rows of the UNION of its lanes' groups while
// the lanes that did not enter one idle.  Here the warp takes every group
// step together (rt::warp_nearest_hit_g, warp_sweep.cuh, the walk of the
// persistent path tracer's generic instantiations): per lane where at least
// `coop_min` of its lanes entered the group, row-parallel for one entered lane
// after another where fewer did; rows past a group's last live row
// (`live_rows`, from the wrapper) are never read.  Every schedule gives the
// same (t, obj) bit for bit under -fmad=false, and coop_min = 1 is the walk
// of one thread per ray.  Rays and outputs are SoA rows so a warp's loads and
// stores coalesce; the tables are read through the read-only path.  Every
// lane reaches every warp-wide operation: lanes past B take part as dead rays
// (d = 0) and store nothing.  The TPU version skips a group only when no lane
// of a 2048-ray block enters it and packs (t, id) into one integer key; here
// a warp skips it, and the full t is kept.
//
// Four instantiations: static and MOTION, each also as EDGE
// (sweep2g_edge_kernel), which adds the silhouette candidate of the gradient
// path (generic_edge).  The TPU kernel's with_edge variant gives up its packed
// key and census shortcuts to compute it; here the nearest (t, obj) of both is
// the same warp sweep's, and the candidate comes from the exact per-block cull
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

// Work counters (measurement only): slab tests, and the live rows the walk of
// one thread per ray tests, in sphere-kind groups and in groups of another
// kind (the same in every schedule); 32 x the row iterations the warps issued
// (SIMT efficiency = (GC_SPHERE_ROWS + GC_OTHER_ROWS) / GC_SLOTS) and their
// row-parallel group visits.  The EDGE instantiations add EdgeCounts' four.
enum { GC_SLAB = 0, GC_SPHERE_ROWS, GC_OTHER_ROWS, GC_SLOTS, GC_COOP, GC_LEN };
enum { EC_BOUNDS = GC_LEN, EC_ROWS_HIT, EC_ROWS_MISS, EC_SLOTS, EC_LEN };

// Threads per block, and the resident blocks per SM each instantiation is
// compiled for: ptxas gives the nearest-hit ones 62 and 64 registers, static
// EDGE 64 and moving EDGE 72, none of them a spill (PERF.md: the nearest-hit
// ones took 72 at 3 blocks and ran slower and spill at 5; static EDGE took 72
// at 2 and ran slower; moving EDGE spills at 4).
constexpr int THREADS = 256;
constexpr int MIN_BLOCKS = 4;
template <bool MOTION>
constexpr int EDGE_MIN_BLOCKS = MOTION ? 2 : 4;

// One lane's ray; a lane past B gets a dead one (d = 0, live = false).
struct Ray {
  float ox, oy, oz, dx, dy, dz, omt, tlim;
  bool live;
};

__device__ __forceinline__ Ray load_ray(const float* __restrict__ rays, int B, int i) {
  Ray r = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, false};
  if (i < B) {
    const size_t s = (size_t)B;
    r.ox = rays[i];
    r.oy = rays[s + i];
    r.oz = rays[2 * s + i];
    r.dx = rays[3 * s + i];
    r.dy = rays[4 * s + i];
    r.dz = rays[5 * s + i];
    r.omt = rays[6 * s + i];
    r.tlim = rays[7 * s + i];
    r.live = (r.dx * r.dx + r.dy * r.dy + r.dz * r.dz) > 0.5f;  // dead rays carry d = 0
  }
  return r;
}

// The warp's sums of the N counters `v`, one atomic per warp and counter.
template <int N>
__device__ __forceinline__ void add_stats(unsigned long long* stats,
                                          const unsigned long long (&v)[N], int lane) {
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const unsigned long long sum = rt::warp_total(v[k]);
    if (lane == 0 && sum) atomicAdd(stats + k, sum);
  }
}

template <bool MOTION>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS) sweep2g_kernel(
    rt::Tables T, const int* __restrict__ live_rows, int coop_min,
    const float* __restrict__ rays, int B, float* __restrict__ t_out,
    int* __restrict__ obj_out, unsigned long long* __restrict__ stats) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const Ray r = load_ray(rays, B, i);
  float t_best;
  int obj;
  rt::WarpCounts wc = {};
  rt::warp_nearest_hit_g<MOTION>(T, live_rows, coop_min, lane, r.ox, r.oy, r.oz, r.dx, r.dy,
                                 r.dz, r.omt, r.live, r.tlim, t_best, obj, wc);
  if (stats != nullptr) {
    const unsigned long long v[GC_LEN] = {wc.slab, wc.tests, wc.other, wc.slots, wc.coop};
    add_stats(stats, v, lane);
  }
  if (i >= B) return;  // after the last warp-wide operation
  t_out[i] = t_best;
  obj_out[i] = obj;
}

// The EDGE instantiation: the same sweep, then the silhouette walk.
template <bool MOTION>
__global__ void __launch_bounds__(THREADS, EDGE_MIN_BLOCKS<MOTION>) sweep2g_edge_kernel(
    rt::Tables T, const int* __restrict__ live_rows, int coop_min,
    const float* __restrict__ eblk, int n_super, const float* __restrict__ rays, int B,
    float* __restrict__ t_out, int* __restrict__ obj_out, int* __restrict__ edge_out,
    unsigned long long* __restrict__ stats) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const bool in = i < B;
  const Ray r = load_ray(rays, B, i);
  float t_best;
  int obj;
  rt::WarpCounts wc = {};
  rt::warp_nearest_hit_g<MOTION>(T, live_rows, coop_min, lane, r.ox, r.oy, r.oz, r.dx, r.dy,
                                 r.dz, r.omt, r.live, r.tlim, t_best, obj, wc);
  if (stats != nullptr) {  // now, so that no counter of the sweep lives through the walk
    const unsigned long long v[GC_LEN] = {wc.slab, wc.tests, wc.other, wc.slots, wc.coop};
    add_stats(stats, v, lane);
  }
  rt::EdgeCounts ec = {};
  const int edge = generic_edge<MOTION>(T, eblk, n_super, in, obj, r.ox, r.oy, r.oz, r.dx,
                                        r.dy, r.dz, r.omt, ec);
  if (stats != nullptr) {
    const unsigned long long v[EC_LEN - GC_LEN] = {ec.bounds, ec.rows_hit, ec.rows_miss,
                                                   ec.slots};
    add_stats(stats + GC_LEN, v, lane);
  }
  if (!in) return;  // after the last warp-wide operation
  t_out[i] = t_best;
  obj_out[i] = obj;
  edge_out[i] = edge;
}

}  // namespace

// rays: (8, B) rows ox oy oz dx dy dz omt tlim; t_out, obj_out: (B,), a miss
// gives obj = -1 and t = min(3e38, tlim); live_rows: (n_groups,) int32, each
// main group's last live row + 1; coop_min: a group that fewer lanes of a
// warp entered is swept row-parallel (1 never, 33 always); edge_out: (B,)
// int32 or null, the silhouette candidate (EDGE instantiation), which then
// reads eblk: the accel's block table (EB_COLS wide, n_super super-blocks
// first), kernels/edge_cull.py::block_table; stats: null, or uint64[GC_LEN]
// (uint64[EC_LEN] with edge_out) that gains the work counters (measurement
// only).  Launches on `stream`, does not synchronise, returns
// cudaGetLastError().
extern "C" int rt_sweep2g(const void* otab, const void* gaabb, const void* live_rows,
                          int n_groups, int gr, int n_pgroups, int probe_gr, int n_sgroups,
                          int has_motion, int coop_min, const void* rays, int B, void* t_out,
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
  const int* live = static_cast<const int*>(live_rows);
  const float* r = static_cast<const float*>(rays);
  float* t = static_cast<float*>(t_out);
  int* o = static_cast<int*>(obj_out);
  unsigned long long* st = static_cast<unsigned long long*>(stats);
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  int* eo = static_cast<int*>(edge_out);
  if (eo != nullptr) {
    const float* eb = static_cast<const float*>(eblk);
    const auto kernel = has_motion ? sweep2g_edge_kernel<true> : sweep2g_edge_kernel<false>;
    RT_LAUNCH(kernel, blocks, THREADS, cs, T, live, coop_min, eb, n_super, r, B, t, o, eo,
              st);
  } else {
    const auto kernel = has_motion ? sweep2g_kernel<true> : sweep2g_kernel<false>;
    RT_LAUNCH(kernel, blocks, THREADS, cs, T, live, coop_min, r, B, t, o, st);
  }
  return static_cast<int>(cudaGetLastError());
}
