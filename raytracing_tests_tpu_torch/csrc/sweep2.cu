// Grouped nearest-hit sphere sweep over a batch of rays, for Hopper (sm_90a).
//
// Replaces the TPU kernel raytracing_tests_tpu/kernels/sweep2.py::
// _sweep2_kernel (launched by _sweep2): nearest (t, obj) per ray and,
// optionally, the 16-row hit block (refined t, surrounding RI, normal,
// material row, original object id).
//
// What bounds it on this card: operations.  A ray moves 32 bytes in and at
// most 72 bytes out, but tests every sphere of every group its slab test
// admits (~10 fp32 operations each), and the rays of a warp admit different
// groups.  So a warp sweeps every group together (warp_sweep.cuh): per lane
// where at least `coop_min` of its lanes entered the group, row-parallel for
// one entered lane after another where fewer did; rows past a group's last
// live row are never read.  The surrounding refractive index of the hit
// block is probed the same way, row-parallel for each ray that needs it.
// Rays and outputs are SoA rows so a warp's loads and stores coalesce; the
// scene tables (a few tens of KB) are read through the read-only path.  Every
// lane reaches every warp-wide operation: lanes past B take part with a dead
// ray and store nothing.  The TPU version's one-hot matrix gather, bf16 table
// splits and packed (t, id) key have no counterpart: the winner's row is an
// indexed load.
//
// Four instantiations: static scenes (8-float object rows) and moving ones
// (MOTION: 12-float rows, each centre shifted by the ray's omt * dp in the
// sweep, the refine and the probe), each also as EDGE: the nearest (t, obj)
// and the silhouette candidate of the gradient path (sphere_edge) instead of
// the hit block.  The host function picks by `has_motion` and `edge_out`.
#include "warp_sweep.cuh"

namespace {

// Silhouette candidate of one live ray (replaces the TPU kernel's with_edge
// branch, kernels/sweep2.py:357-369): the row with the least
// (c_q - nb^2) * rinv2, i.e. (h/r)^2 - 1 with h the distance from the row's
// centre to the ray's line, among the rows whose centre lies ahead (nb > 0),
// in the group-anchored frame of the sweep (the same nb and c_q as
// sphere_row_t).  EVERY row of the main table takes part, dead and padding
// rows too (K1 = BIG_T, rinv2 = 1e-30: a metric of about 3e8): the TPU kernel
// sees only the groups its 2048-ray block entered, a schedule this port does
// not carry, so the candidate is defined over the whole table.  A strict <
// in row order keeps the lowest row on a tie; -1 when no row lies ahead.  One
// thread per ray: the lanes of a warp read the same row at once.
template <bool MOTION>
__device__ __forceinline__ int sphere_edge(const rt::Tables& T, float ox, float oy,
                                           float oz, float dx, float dy, float dz,
                                           float omt) {
  constexpr int COLS = MOTION ? rt::OT_COLS_MOTION : rt::OT_COLS;
  float best = rt::BIG_T;
  int edge = -1;
  for (int g = 0; g < T.n_groups; ++g) {
    const float* ga = T.gaabb + g * rt::GA_COLS;
    const float sx = ox - __ldg(ga + 6), sy = oy - __ldg(ga + 7), sz = oz - __ldg(ga + 8);
    const float od = sx * dx + sy * dy + sz * dz;
    const float oo = sx * sx + sy * sy + sz * sz;
    const float* rows = T.otab + (size_t)g * T.gr * COLS;
    for (int r = 0; r < T.gr; ++r) {
      const float* row = rows + r * COLS;
      const float4 c = rt::ld4(row);      // cx cy cz k1
      const float4 k = rt::ld4(row + 4);  // ri rinv2 k2 k3
      const float DC = c.x * dx + c.y * dy + c.z * dz;
      const float OC = c.x * sx + c.y * sy + c.z * sz;
      float nb = DC - od;
      float c_q = oo + c.w - 2.0f * OC;
      if (MOTION) {
        const float4 m = rt::ld4(row + 8);  // dpx dpy dpz 0
        const float DDP = m.x * dx + m.y * dy + m.z * dz;
        const float ODP = m.x * sx + m.y * sy + m.z * sz;
        nb = nb - omt * DDP;
        c_q = c_q + omt * (2.0f * ODP - k.z) + (omt * omt) * k.w;
      }
      if (nb > 0.0f) {
        const float me = (c_q - nb * nb) * k.y;
        if (me < best) {
          best = me;
          edge = g * T.gr + r;
        }
      }
    }
  }
  return edge;
}

// Work counters (measurement only): gr per group a ray entered; the rows each
// ray's own walk tested (to its groups' last live rows), 32 x the row
// iterations the warps issued (SIMT efficiency = SW_ROW_TESTS /
// SW_LANE_SLOTS) and their row-parallel group visits.
enum { SW_TESTS = 0, SW_ROW_TESTS, SW_LANE_SLOTS, SW_COOP_VISITS, SW_LEN };

// Threads per block, and the resident blocks per SM the kernel is compiled
// for: with 3, ptxas gives both instantiations 61 and 77 registers and no
// spill; unbounded it took 48 and 64 with spills, and ran slower (PERF.md).
constexpr int THREADS = 256;
constexpr int MIN_BLOCKS = 3;

template <bool MOTION, bool EDGE>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS) sweep2_kernel(
    rt::Tables T, const int* __restrict__ live_rows, int coop_min,
    const float* __restrict__ rays, int B, float* __restrict__ t_out,
    int* __restrict__ obj_out, float* __restrict__ rows_out, int with_ri,
    int* __restrict__ edge_out, unsigned long long* __restrict__ stats) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x & 31;
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
    omt = MOTION ? rays[6 * s + i] : 0.0f;
    tlim = rays[7 * s + i];
  }
  const bool live = in && (dx * dx + dy * dy + dz * dz) > 0.5f;  // dead rays carry d = 0

  float t_best;
  int obj;
  rt::WarpCounts wc = {};
  rt::warp_nearest_hit<MOTION>(T, live_rows, coop_min, lane, ox, oy, oz, dx, dy, dz, omt,
                               live, tlim, t_best, obj, wc);
  if (stats != nullptr) {
    const unsigned long long v[SW_LEN] = {wc.tests, wc.rows, wc.slots, wc.coop};
#pragma unroll
    for (int k = 0; k < SW_LEN; ++k) {
      const unsigned long long sum = rt::warp_total(v[k]);
      if (lane == 0 && sum) atomicAdd(stats + k, sum);
    }
  }
  const bool hit = obj >= 0;
  if (in) obj_out[i] = obj;
  if constexpr (EDGE) {  // no hit block: the host refuses rows_out with edge_out
    if (in) {
      t_out[i] = hit ? t_best : rt::BIG_T;
      edge_out[i] = live ? sphere_edge<MOTION>(T, ox, oy, oz, dx, dy, dz, omt) : -1;
    }
    return;
  }
  if (rows_out == nullptr) {
    if (in) t_out[i] = hit ? t_best : rt::BIG_T;
    return;
  }

  float row[rt::FT_COLS];
#pragma unroll
  for (int k = 0; k < rt::FT_COLS; ++k) row[k] = 0.0f;
  if (hit) {
    const float* src = T.ftab + (size_t)obj * rt::FT_COLS;
#pragma unroll
    for (int k = 0; k < rt::FT_COLS / 4; ++k) {
      const float4 v = rt::ld4(src + 4 * k);
      row[4 * k] = v.x;
      row[4 * k + 1] = v.y;
      row[4 * k + 2] = v.z;
      row[4 * k + 3] = v.w;
    }
  }
  const rt::Refined R =
      rt::winner_refine<MOTION>(row, ox, oy, oz, dx, dy, dz, omt, t_best, hit);
  const float t_fin = hit ? R.t : rt::BIG_T;
  // Only dielectric winners and interior hits consume the surrounding RI
  // downstream; every other ray reads the neutral 1.
  const bool need =
      with_ri && hit &&
      ((R.nx * dx + R.ny * dy + R.nz * dz) > 0.0f || row[rt::FT_REFR] > 0.002f);
  const float sur_ri =
      rt::warp_ri_probe<MOTION>(T, coop_min, lane, need, R.px + 1e-3f * R.nx,
                                R.py + 1e-3f * R.ny, R.pz + 1e-3f * R.nz, omt);
  if (!in) return;  // after the last warp-wide operation
  t_out[i] = t_fin;
  float* o = rows_out + i;
  o[rt::V_T * s] = t_fin;
  o[rt::V_RI * s] = sur_ri;
  o[rt::V_NX * s] = R.nx;
  o[rt::V_NY * s] = R.ny;
  o[rt::V_NZ * s] = R.nz;
  o[rt::V_CR * s] = row[rt::FT_CR];
  o[rt::V_CG * s] = row[rt::FT_CG];
  o[rt::V_CB * s] = row[rt::FT_CB];
  o[rt::V_MRI * s] = row[rt::FT_MRI];
  o[rt::V_REFR * s] = row[rt::FT_REFR];
  o[rt::V_REFL * s] = row[rt::FT_REFL];
  o[rt::V_SRFR * s] = row[rt::FT_SRFR];
  o[rt::V_SRFL * s] = row[rt::FT_SRFL];
  o[rt::V_TEX * s] = row[rt::FT_TEX];
  o[rt::V_EMIS * s] = row[rt::FT_EMIS];
  o[rt::V_OBJ * s] = row[rt::FT_OBJ];
}

}  // namespace

// rays: (8, B) rows ox oy oz dx dy dz omt tlim; t_out, obj_out: (B,);
// rows_out: (16, B) or null; edge_out: (B,) int32 or null, the silhouette
// candidate (EDGE instantiation; rows_out must then be null);
// live_rows: (n_groups,) int32, each main group's
// last live row + 1; coop_min: a group that fewer lanes of a warp entered is
// swept row-parallel (1 never, 33 always); stats: null, or uint64[SW_LEN]
// that gains the work counters (measurement only).  `has_motion` says that
// the otab rows are 12 wide and picks the MOTION instantiation.  Launches on
// `stream`, does not synchronise, returns cudaGetLastError().
extern "C" int rt_sweep2(const void* otab, const void* ftab, const void* gaabb,
                         const void* live_rows, int n_groups, int gr, int n_pgroups,
                         int probe_gr, int has_motion, int coop_min, const void* rays,
                         int B, void* t_out, void* obj_out, void* rows_out, int with_ri,
                         void* edge_out, void* stats, void* stream) {
  if (B <= 0) return 0;
  if (edge_out != nullptr && rows_out != nullptr) return static_cast<int>(cudaErrorInvalidValue);
  rt::Tables T;
  T.otab = static_cast<const float*>(otab);
  T.ftab = static_cast<const float*>(ftab);
  T.gaabb = static_cast<const float*>(gaabb);
  T.n_groups = n_groups;
  T.gr = gr;
  T.n_pgroups = n_pgroups;
  T.probe_gr = probe_gr;
  T.n_sgroups = 0;
  const int blocks = (B + THREADS - 1) / THREADS;
  const int* live = static_cast<const int*>(live_rows);
  const float* r = static_cast<const float*>(rays);
  float* t = static_cast<float*>(t_out);
  int* o = static_cast<int*>(obj_out);
  float* ro = static_cast<float*>(rows_out);
  unsigned long long* st = static_cast<unsigned long long*>(stats);
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  int* eo = static_cast<int*>(edge_out);
  const auto kernel = has_motion ? (eo != nullptr ? sweep2_kernel<true, true>
                                                  : sweep2_kernel<true, false>)
                                 : (eo != nullptr ? sweep2_kernel<false, true>
                                                  : sweep2_kernel<false, false>);
  RT_LAUNCH(kernel, blocks, THREADS, cs, T, live, coop_min, r, B, t, o, ro, with_ri, eo, st);
  return static_cast<int>(cudaGetLastError());
}
