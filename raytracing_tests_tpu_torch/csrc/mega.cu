// One fused trace-and-shade step over a chunk of lanes, for Hopper (sm_90a).
//
// Replaces the TPU kernel raytracing_tests_tpu/kernels/mega.py::_mega_kernel
// (launched by mega_step): for every lane of a (16, C) pool of ray records the
// nearest hit over the grouped sphere tables, the winner's row, the exact
// re-solve, the surrounding refractive index, the In-Next-Week shading and both
// children as pool records.  The lane-aligned drain (ops/megalanes.py) calls
// it once per iteration and keeps every record at its lane.
//
// What bounds it on this card: a lane reads 11 floats and writes 42 whatever
// it does (212 bytes), and a live lane tests the spheres of every group its
// slab test admits, so bytes and operations are of one size on a fully live
// chunk and bytes bind once most lanes are dead.  The design is therefore the
// plain one: one thread per lane over a flat grid (a step is one node per
// lane, so there is nothing to persist), the pool kept in planes (rows, C) so
// that every load and store of a warp is one contiguous segment, the tables
// read through the read-only path.  A lane that is inactive or dead skips the
// sweep and the shading but still writes all 42 outputs of its column: the
// drain adds the colour rows without a mask.  The TPU version's (1, L) planes,
// scratch references, packed (t, id) key and one-hot gather have no
// counterpart.
//
// Two instantiations, static and MOTION (12-float object rows, centres
// shifted by the lane's omt * dp); the host function picks by `has_motion`.
#include "rt_common.cuh"

namespace {

constexpr int POOL_ROWS = 16;
constexpr int MISC_ROWS = 8;
// Pool record rows.
enum { P_OX = 0, P_OY, P_OZ, P_DX, P_DY, P_DZ, P_OMT, P_TLIM, P_CONTRIB, P_BOUNCED };

// Host-side parameter vectors (kernels/mega.py fills them).
enum { IP_SPP = 0, IP_HAS_DIEL, IP_NGROUPS, IP_GR, IP_NPGROUPS, IP_PROBE_GR,
       IP_MOTION, IP_LEN };
enum { FP_TMAX = 0, FP_GOLDEN, FP_SUN_N, FP_SUN_NMB, FP_SUN_DENOM, FP_MAX_BOUNCES,
       FP_BG_BOTTOM, FP_BG_TOP = FP_BG_BOTTOM + 3, FP_LEN = FP_BG_TOP + 3 };

// Work counters (measurement only): live lanes, sphere quadratics solved,
// lanes that hit, lanes whose surrounding RI was probed.
enum { MS_LIVE = 0, MS_TESTS, MS_HITS, MS_PROBES, MS_LEN };

struct MegaParams {
  int spp;
  float t_max, golden;
  float bg_bottom[3], bg_top[3];
  rt::ShadeStatics shade;
};

__device__ __forceinline__ void write_child(float* __restrict__ out, size_t s,
                                            const rt::Child& c, float omt,
                                            float t_max, float bounced1) {
  out[P_OX * s] = c.ox;
  out[P_OY * s] = c.oy;
  out[P_OZ * s] = c.oz;
  out[P_DX * s] = c.dx;
  out[P_DY * s] = c.dy;
  out[P_DZ * s] = c.dz;
  out[P_OMT * s] = omt;
  out[P_TLIM * s] = t_max;
  out[P_CONTRIB * s] = c.contrib;
  out[P_BOUNCED * s] = bounced1;
#pragma unroll
  for (int r = P_BOUNCED + 1; r < POOL_ROWS; ++r) out[r * s] = 0.0f;
}

template <bool MOTION>
__global__ void __launch_bounds__(256) mega_kernel(
    rt::Tables T, MegaParams P, const float* __restrict__ pool,
    const int* __restrict__ lane, int C, float* __restrict__ misc,
    float* __restrict__ refr, float* __restrict__ refl,
    int* __restrict__ rlane, int* __restrict__ llane,
    unsigned long long* __restrict__ stats) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= C) return;
  const size_t s = (size_t)C;
  const float* rec = pool + i;
  const float ox = rec[P_OX * s], oy = rec[P_OY * s], oz = rec[P_OZ * s];
  const float dx = rec[P_DX * s], dy = rec[P_DY * s], dz = rec[P_DZ * s];
  const float omt = rec[P_OMT * s], tlim = rec[P_TLIM * s];
  const float contrib = rec[P_CONTRIB * s], bounced = rec[P_BOUNCED * s];
  const int ln = lane[i];
  const bool active = ln >= 0;
  // dead rays carry d = 0 (a padding lane, or a lane that was never started)
  const bool live = active && (dx * dx + dy * dy + dz * dz) > 0.5f;

  float t_best;
  int obj;
  unsigned tests = 0;
  rt::nearest_hit<MOTION>(T, ox, oy, oz, dx, dy, dz, omt, live, tlim, t_best,
                          obj, tests);

  float add_r = 0.0f, add_g = 0.0f, add_b = 0.0f, hit_t = P.t_max;
  bool sp_refr = false, sp_refl = false, probed = false;
  // A lane that hits nothing spawns nothing: its children carry a dead ray.
  rt::Child cr = {}, cl = {};
  if (obj >= 0) {
    // The sunflower angle of the lane's sample, as ray generation takes it.
    const float sidx = (float)(ln - (ln / P.spp) * P.spp);
    const float th = P.golden * sidx;
    const rt::Shade sh = rt::shade_hit<false, MOTION>(
        T, P.shade, obj, t_best, ox, oy, oz, dx, dy, dz, omt, contrib, bounced,
        sidx, cosf(th), sinf(th));
    add_r = sh.add_r;
    add_g = sh.add_g;
    add_b = sh.add_b;
    hit_t = sh.hit_t;
    sp_refr = sh.spawn_refr;
    sp_refl = sh.spawn_refl;
    probed = sh.probed;
    cr = sh.refr;
    cl = sh.refl;
  } else if (active) {
    // Miss (a dead active lane too): contribution times the sky gradient.
    const float tt = (dy + 1.0f) * 0.5f;
    add_r = contrib * ((1.0f - tt) * P.bg_bottom[0] + tt * P.bg_top[0]);
    add_g = contrib * ((1.0f - tt) * P.bg_bottom[1] + tt * P.bg_top[1]);
    add_b = contrib * ((1.0f - tt) * P.bg_bottom[2] + tt * P.bg_top[2]);
  }

  float* m = misc + i;
  m[0 * s] = add_r;
  m[1 * s] = add_g;
  m[2 * s] = add_b;
  m[3 * s] = hit_t;
#pragma unroll
  for (int r = 4; r < MISC_ROWS; ++r) m[r * s] = 0.0f;
  const float bounced1 = bounced + 1.0f;
  write_child(refr + i, s, cr, omt, P.t_max, bounced1);
  write_child(refl + i, s, cl, omt, P.t_max, bounced1);
  rlane[i] = sp_refr ? ln : -1;
  llane[i] = sp_refl ? ln : -1;

  if (stats != nullptr) {
    if (live) atomicAdd(stats + MS_LIVE, 1ull);
    if (tests) atomicAdd(stats + MS_TESTS, (unsigned long long)tests);
    if (obj >= 0) atomicAdd(stats + MS_HITS, 1ull);
    if (probed) atomicAdd(stats + MS_PROBES, 1ull);
  }
}

}  // namespace

// pool: (16, C) float32 ray records (rows ox oy oz dx dy dz omt tlim contrib
// bounced, 6 spare); lane: (C,) int32, negative = inactive.  Outputs: misc
// (8, C) = add_r add_g add_b hit_t 0 0 0 0; refr, refl: (16, C) child records;
// rlane, llane: (C,) int32, the lane id where that child spawns, else -1.
// stats: null, or uint64[4] that gains live lanes, sphere quadratics solved,
// hits and probed lanes (measurement only).  ip / fp: HOST parameter vectors
// (IP_* / FP_* above); ip[IP_MOTION] says that the otab rows are 12 wide and
// picks the MOTION instantiation.  Launches on `stream`, does not synchronise,
// returns cudaGetLastError().
extern "C" int rt_mega_step(const void* otab, const void* ftab,
                            const void* gaabb, const int* ip, const float* fp,
                            const void* pool, const void* lane, int C,
                            void* misc, void* refr, void* refl, void* rlane,
                            void* llane, void* stats, void* stream) {
  if (C <= 0) return 0;
  if (ip[IP_SPP] < 1) return (int)cudaErrorInvalidValue;
  rt::Tables T;
  T.otab = static_cast<const float*>(otab);
  T.ftab = static_cast<const float*>(ftab);
  T.gaabb = static_cast<const float*>(gaabb);
  T.n_groups = ip[IP_NGROUPS];
  T.gr = ip[IP_GR];
  T.n_pgroups = ip[IP_NPGROUPS];
  T.probe_gr = ip[IP_PROBE_GR];
  T.n_sgroups = 0;

  MegaParams P;
  P.spp = ip[IP_SPP];
  P.t_max = fp[FP_TMAX];
  P.golden = fp[FP_GOLDEN];
  for (int c = 0; c < 3; ++c) {
    P.bg_bottom[c] = fp[FP_BG_BOTTOM + c];
    P.bg_top[c] = fp[FP_BG_TOP + c];
  }
  P.shade.sun.n = fp[FP_SUN_N];
  P.shade.sun.n_minus_b = fp[FP_SUN_NMB];
  P.shade.sun.denom = fp[FP_SUN_DENOM];
  P.shade.max_bounces = fp[FP_MAX_BOUNCES];
  P.shade.has_dielectrics = ip[IP_HAS_DIEL];

  const int threads = 256;
  const int blocks = (C + threads - 1) / threads;
  const float* pl = static_cast<const float*>(pool);
  const int* ln = static_cast<const int*>(lane);
  float* mi = static_cast<float*>(misc);
  float* rr = static_cast<float*>(refr);
  float* rl = static_cast<float*>(refl);
  int* rln = static_cast<int*>(rlane);
  int* lln = static_cast<int*>(llane);
  unsigned long long* st = static_cast<unsigned long long*>(stats);
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  if (ip[IP_MOTION])
    RT_LAUNCH(mega_kernel<true>, blocks, threads, cs, T, P, pl, ln, C, mi, rr, rl,
              rln, lln, st);
  else
    RT_LAUNCH(mega_kernel<false>, blocks, threads, cs, T, P, pl, ln, C, mi, rr, rl,
              rln, lln, st);
  return static_cast<int>(cudaGetLastError());
}
