// Grouped nearest-hit sphere sweep over a batch of rays, for Hopper (sm_90a).
//
// Replaces the TPU kernel raytracing_tests_tpu/kernels/sweep2.py::
// _sweep2_kernel (launched by _sweep2): nearest (t, obj) per ray and,
// optionally, the 16-row hit block (refined t, surrounding RI, normal,
// material row, original object id).
//
// What bounds it on this card: operations.  A ray moves 32 bytes in and at
// most 72 bytes out, but tests every sphere of every group its slab test
// admits (~10 fp32 operations each).  The design therefore spends nothing on
// memory staging: one thread per ray, rays and outputs in SoA rows so a warp's
// loads and stores coalesce, and the scene tables (a few tens of KB) read
// through the read-only path, where a warp walking the same group gets one
// broadcast load per row.  The TPU version's one-hot matrix gather, bf16 table
// splits and packed (t, id) key have no counterpart: the winner's row is an
// indexed load.
//
// Two instantiations: static scenes (8-float object rows) and moving ones
// (MOTION: 12-float rows, each centre shifted by the ray's omt * dp in the
// sweep, the refine and the probe); the host function picks by `has_motion`.
#include "rt_common.cuh"

namespace {

template <bool MOTION>
__global__ void __launch_bounds__(256) sweep2_kernel(
    rt::Tables T, const float* __restrict__ rays, int B,
    float* __restrict__ t_out, int* __restrict__ obj_out,
    float* __restrict__ rows_out, int with_ri,
    unsigned long long* __restrict__ stats) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  const size_t s = (size_t)B;
  const float ox = rays[i], oy = rays[s + i], oz = rays[2 * s + i];
  const float dx = rays[3 * s + i], dy = rays[4 * s + i], dz = rays[5 * s + i];
  const float omt = MOTION ? rays[6 * s + i] : 0.0f;
  const float tlim = rays[7 * s + i];
  const bool live = (dx * dx + dy * dy + dz * dz) > 0.5f;  // dead rays carry d = 0

  float t_best;
  int obj;
  unsigned tests = 0;
  rt::nearest_hit<MOTION>(T, ox, oy, oz, dx, dy, dz, omt, live, tlim, t_best,
                          obj, tests);
  if (stats != nullptr) atomicAdd(stats, (unsigned long long)tests);
  const bool hit = obj >= 0;
  obj_out[i] = obj;
  if (rows_out == nullptr) {
    t_out[i] = hit ? t_best : rt::BIG_T;
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
  t_out[i] = t_fin;
  // Only dielectric winners and interior hits consume the surrounding RI
  // downstream; every other ray reads the neutral 1.
  const bool need =
      with_ri && hit &&
      ((R.nx * dx + R.ny * dy + R.nz * dz) > 0.0f || row[rt::FT_REFR] > 0.002f);
  const float sur_ri =
      need ? rt::ri_probe<MOTION>(T, R.px + 1e-3f * R.nx, R.py + 1e-3f * R.ny,
                                  R.pz + 1e-3f * R.nz, omt)
           : 1.0f;
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
// rows_out: (16, B) or null; stats: null, or uint64[1] that gains the number
// of sphere quadratics solved (measurement only).  `has_motion` says that the
// otab rows are 12 wide and picks the MOTION instantiation.  Launches on
// `stream`, does not synchronise, returns cudaGetLastError().
extern "C" int rt_sweep2(const void* otab, const void* ftab, const void* gaabb,
                         int n_groups, int gr, int n_pgroups, int probe_gr,
                         int has_motion, const void* rays, int B, void* t_out,
                         void* obj_out,
                         void* rows_out, int with_ri, void* stats,
                         void* stream) {
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
  const int threads = 256;
  const int blocks = (B + threads - 1) / threads;
  const float* r = static_cast<const float*>(rays);
  float* t = static_cast<float*>(t_out);
  int* o = static_cast<int*>(obj_out);
  float* ro = static_cast<float*>(rows_out);
  unsigned long long* st = static_cast<unsigned long long*>(stats);
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  if (has_motion)
    RT_LAUNCH(sweep2_kernel<true>, blocks, threads, cs, T, r, B, t, o, ro, with_ri, st);
  else
    RT_LAUNCH(sweep2_kernel<false>, blocks, threads, cs, T, r, B, t, o, ro, with_ri, st);
  return static_cast<int>(cudaGetLastError());
}
