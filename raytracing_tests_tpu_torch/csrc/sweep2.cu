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
// Two instantiations: static scenes (8-float object rows) and moving ones
// (MOTION: 12-float rows, each centre shifted by the ray's omt * dp in the
// sweep, the refine and the probe); the host function picks by `has_motion`.
#include "warp_sweep.cuh"

namespace {

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

template <bool MOTION>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS) sweep2_kernel(
    rt::Tables T, const int* __restrict__ live_rows, int coop_min,
    const float* __restrict__ rays, int B, float* __restrict__ t_out,
    int* __restrict__ obj_out, float* __restrict__ rows_out, int with_ri,
    unsigned long long* __restrict__ stats) {
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
// rows_out: (16, B) or null; live_rows: (n_groups,) int32, each main group's
// last live row + 1; coop_min: a group that fewer lanes of a warp entered is
// swept row-parallel (1 never, 33 always); stats: null, or uint64[SW_LEN]
// that gains the work counters (measurement only).  `has_motion` says that
// the otab rows are 12 wide and picks the MOTION instantiation.  Launches on
// `stream`, does not synchronise, returns cudaGetLastError().
extern "C" int rt_sweep2(const void* otab, const void* ftab, const void* gaabb,
                         const void* live_rows, int n_groups, int gr, int n_pgroups,
                         int probe_gr, int has_motion, int coop_min, const void* rays,
                         int B, void* t_out, void* obj_out, void* rows_out, int with_ri,
                         void* stats, void* stream) {
  if (B <= 0) return 0;
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
  if (has_motion)
    RT_LAUNCH(sweep2_kernel<true>, blocks, THREADS, cs, T, live, coop_min, r, B, t, o, ro,
              with_ri, st);
  else
    RT_LAUNCH(sweep2_kernel<false>, blocks, THREADS, cs, T, live, coop_min, r, B, t, o, ro,
              with_ri, st);
  return static_cast<int>(cudaGetLastError());
}
