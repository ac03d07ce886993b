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
#include "rt_common.cuh"

namespace {

template <bool MOTION>
__global__ void __launch_bounds__(256) sweep2g_kernel(
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

}  // namespace

// rays: (8, B) rows ox oy oz dx dy dz omt tlim; t_out, obj_out: (B,), a miss
// gives obj = -1 and t = min(3e38, tlim); stats: null, or uint64[3] that gains
// slab tests and the live rows tested in sphere-kind groups and in groups of
// another kind (measurement only).  Launches on `stream`, does not synchronise, returns
// cudaGetLastError().
extern "C" int rt_sweep2g(const void* otab, const void* gaabb, int n_groups,
                          int gr, int n_pgroups, int probe_gr, int n_sgroups,
                          int has_motion, const void* rays, int B, void* t_out,
                          void* obj_out, void* stats, void* stream) {
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
  if (has_motion)
    RT_LAUNCH(sweep2g_kernel<true>, blocks, threads, cs, T, r, B, t, o, st);
  else
    RT_LAUNCH(sweep2g_kernel<false>, blocks, threads, cs, T, r, B, t, o, st);
  return static_cast<int>(cudaGetLastError());
}
