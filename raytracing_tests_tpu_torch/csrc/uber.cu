// Persistent whole-frame path tracer for Hopper (sm_90a).
//
// Replaces the TPU kernel raytracing_tests_tpu/kernels/uber.py::_uber_kernel
// (launched by _uber_call), in twenty-four instantiations chosen by the host
// function: sphere-mode scenes (anchored sphere quadratic over the
// sweep2 tables) and generic scenes (rotated ellipsoids and cuboids over the
// sweep2g tables, with super-group culling and per-group kinds), each static
// or with motion blur (every centre shifted by omt * dp, omt = 1 - s / spp of
// the primary's sample), each under one of three shadings (SH_*):
// In-Next-Week ('bvh'); 'bvh' with emissive lights (a shadow ray per light
// from every hit, through the same warp sweep, scales its contribution; a hit
// on an emissive object paints the sample white and ends its tree); and the
// Shirley materials (per-ray medium RI, Schlick shift, fibonacci scatter);
// each untextured or with cube-sphere atlas textures (TEX: a textured
// winner's albedo times a bilinear sample of its atlas at the cube-sphere UV
// of its unit-space hit position, rt_common.cuh::texture_albedo).  Mode,
// motion, shading and textures are template parameters, so the static 'bvh'
// sphere instantiation carries none of the other code's registers.  This
// source builds the twelve untextured instantiations; uber_tex.cu builds it
// again with RT_UBER_TEX = 1 for the twelve textured ones, a library of their
// own, so that both compile in parallel.
// The camera is a perspective lens with up to 7 focus distances (sample s
// focuses at the (s % K)-th), optionally jittered per sample on the aa_grid
// supersampling grid (a table of spp screen offsets), or orthographic:
// branches on launch-uniform parameters, taken once per primary.
// Per primary p (pixel p / spp,
// sample p % spp) generate the camera ray, then walk its ray tree with a LIFO
// stack of Q records (o3, d3, contribution, bounce count, and under materials
// shading the medium RI and its parent's) under a budget of `pops` nodes, one
// child continuing in place and the other waiting on the stack: reflection in
// place under 'bvh', refraction under materials shading.  Output: one float4
// (r, g, b, primary t) per primary in p-linear order, plus frame counters.
//
// What bounds it on this card: operations.  A primary writes 16 bytes and
// reads nothing but the scene tables, while every tree node tests the spheres
// of each group its slab test admits.  The cost that can be lost is lane
// occupancy, twice over.  Trees are 1 to `pops` nodes long, so a
// thread-per-primary loop would idle most of a warp behind its longest tree:
// the design is one thread per ray TREE in a single persistent loop, where a
// thread whose tree ends takes the next primary at the top of the same loop
// (one warp-aggregated atomic hands consecutive primaries to the lanes that
// need one).  And lanes walk different groups: a warp whose lanes each solve
// the rows of their own groups issues the rows of the union while the other
// lanes idle.  So the whole warp takes every node step together, lanes
// without a tree included, and sweeps each group either per lane (many lanes
// entered it) or row-parallel for one entered lane after another
// (warp_sweep.cuh; `coop_min` picks); so do the shadow rays.  The stacks live
// in a global scratch buffer the wrapper sizes for the threads the launch
// keeps resident (rt_uber_threads), Q records each, laid out slot-major and
// thread-minor: field k of slot q of thread i at ((q * REC + k) * stride + i),
// so the stores of a warp that push into the same slot coalesce.  Any Q fits.
// The TPU version's rounds, lane rotation and staged flush are scheduling for
// a vector core and have no counterpart.
#include "warp_sweep.cuh"

#ifndef RT_UBER_TEX
#define RT_UBER_TEX 0  // this library's instantiations: untextured
#endif

namespace {

// Shadings (kernels/uber.py::SHADING_CODE).
enum { SH_BVH = 0, SH_LIGHTS = 1, SH_MATERIALS = 2 };

// Camera vector layout (kernels/uber.py::pack_camera).
enum {
  CAM_PX = 0, CAM_PY, CAM_PZ, CAM_DX, CAM_DY, CAM_DZ,
  CAM_RX, CAM_RY, CAM_RZ, CAM_UX, CAM_UY, CAM_UZ,
  CAM_SD, CAM_AP, CAM_FD, CAM_STRIDE, CAM_ROW0, CAM_PAD /* ortho height */,
  CAM_FD2 /* focus distances 2..7 */, CAM_LEN = 24,
  // an orthographic camera's tail: right / |right| and up / |up|
  CAM_RNX = CAM_FD2, CAM_UNX = CAM_FD2 + 3
};

// Host-side parameter vectors (kernels/uber.py fills them).
// IP_COOP_MIN: a group that fewer lanes of a warp entered is swept
// row-parallel (warp_sweep.cuh); 1 never, 33 always.
// IP_SHADING: SH_*; IP_NLIGHTS: rows of the lights table (SH_LIGHTS).
// IP_NFOCUS: focus distances (1..7); IP_ORTHO: orthographic camera;
// IP_TEX_*: the atlas stack's T, H, W6 (textured instantiations).
enum { IP_W = 0, IP_H /* unused: 1/H comes in fp */, IP_SPP, IP_Q, IP_POPS, IP_HAS_DIEL, IP_NGROUPS, IP_GR,
       IP_NPGROUPS, IP_PROBE_GR, IP_GENERIC, IP_NSGROUPS, IP_MOTION, IP_COOP_MIN,
       IP_SHADING, IP_NLIGHTS, IP_NFOCUS, IP_ORTHO, IP_TEX_T, IP_TEX_H, IP_TEX_W6, IP_LEN };
enum { FP_TMAX = 0, FP_GOLDEN, FP_INV_W, FP_INV_H, FP_ASPECT,
       FP_SUN_N, FP_SUN_NMB, FP_SUN_DENOM, FP_SUN_INV_DENOM, FP_MAX_BOUNCES,
       FP_BG_BOTTOM, FP_BG_TOP = FP_BG_BOTTOM + 3, FP_INV_SPP = FP_BG_TOP + 3,
       FP_INV_NLIGHTS, FP_LEN };

// Frame counters (device, zeroed by the wrapper before each launch).
// ST_SPHERE_TESTS: sphere quadratics solved; the next three only in generic
// mode: slab tests, live rows tested in groups of another kind, nodes that hit.
// The last three measure the warp sweeps (rt::WarpCounts): rows each lane's
// own walk needed, 32 x the row iterations the warps issued (SIMT efficiency =
// ST_ROW_TESTS / ST_LANE_SLOTS), group visits served row-parallel; then the
// shadow rays swept (SH_LIGHTS; their rows are in the counters before), and
// the atlas samples taken (textured instantiations: shaded hits on a winner
// with a texture index).
enum { ST_NEXT = 0, ST_RAYS, ST_DROPPED, ST_SPHERE_TESTS, ST_SLAB_TESTS,
       ST_OTHER_TESTS, ST_HITS, ST_ROW_TESTS, ST_LANE_SLOTS, ST_COOP_VISITS,
       ST_SHADOW_RAYS, ST_TEX_SAMPLES, ST_LEN };

struct UberParams {
  int W, spp, Q, pops, coop_min, n_lights;
  unsigned long long B_total;
  unsigned long long stack_stride;  // threads the stack buffer holds
  float t_max, golden, inv_W, inv_H, aspect, sun_inv_denom, inv_spp, inv_n_lights;
  float bg_bottom[3], bg_top[3];
  rt::ShadeStatics shade;
};

// The camera's variants: aa, the aa_grid screen offset (x, y) of each sample,
// or null; the focus distances; an orthographic camera.  A kernel parameter
// of its own, as the atlas is: added to UberParams, they changed the
// register allocation of three untextured instantiations (PERF.md).
struct CameraVariants {
  const float* aa;
  int n_focus, ortho;
};

// A ray of the tree; medium and parent (the RIs of the medium it travels in
// and of its parent's) are read under materials shading only.
struct Ray {
  float ox, oy, oz, dx, dy, dz, contrib, bounced, medium, parent;
};

// Primary ray of global index p: perspective screen direction from the
// unnormalised right/up basis, then the sunflower thin-lens pivot about the
// focal point (focus distance the (s % K)-th of K).  With an aa table the
// screen point moves by the sample's jitter first; an orthographic camera
// instead starts a ray parallel to the view direction from the view-plane
// lattice (no lens).  Also returns cos/sin(GOLDEN_ANGLE * s), reused by the
// scatter cones of the whole tree, and the sample index s itself (the tree's
// time is s / spp).
__device__ __forceinline__ Ray raygen(const UberParams& P, const CameraVariants& V,
                                      const float* __restrict__ cam,
                                      unsigned long long p, float& sidx,
                                      float& cth, float& sth) {
  const unsigned long long pix = p / (unsigned)P.spp;
  const int s_i = (int)(p - pix * (unsigned)P.spp);
  const float sf = (float)s_i;
  const int ix = (int)(pix % (unsigned)P.W);
  const int iyi = (int)(pix / (unsigned)P.W);
  const float iy = (float)iyi * __ldg(cam + CAM_STRIDE) + __ldg(cam + CAM_ROW0);
  float pxs = ((float)ix * P.inv_W - 0.5f) * P.aspect;
  float pys = iy * P.inv_H - 0.5f;
  if (V.aa != nullptr) {
    pxs = pxs + __ldg(V.aa + 2 * s_i);
    pys = pys + __ldg(V.aa + 2 * s_i + 1);
  }
  Ray ray;
  ray.contrib = 1.0f;
  ray.bounced = 0.0f;
  ray.medium = 1.0f;
  ray.parent = 1.0f;
  sidx = sf;
  if (V.ortho) {
    // origin pos + h (pxs r / |r| + pys u / |u|), the unit vectors packed by
    // the host (normalised by division)
    const float sxh = pxs * __ldg(cam + CAM_PAD), syh = pys * __ldg(cam + CAM_PAD);
    ray.ox = __ldg(cam + CAM_PX) + sxh * __ldg(cam + CAM_RNX) + syh * __ldg(cam + CAM_UNX);
    ray.oy = __ldg(cam + CAM_PY) + sxh * __ldg(cam + CAM_RNX + 1) + syh * __ldg(cam + CAM_UNX + 1);
    ray.oz = __ldg(cam + CAM_PZ) + sxh * __ldg(cam + CAM_RNX + 2) + syh * __ldg(cam + CAM_UNX + 2);
    ray.dx = __ldg(cam + CAM_DX);
    ray.dy = __ldg(cam + CAM_DY);
    ray.dz = __ldg(cam + CAM_DZ);
    const float th = P.golden * sf;
    cth = cosf(th);
    sth = sinf(th);
    return ray;
  }
  const float sd = __ldg(cam + CAM_SD);
  float bdx = __ldg(cam + CAM_DX) * sd + __ldg(cam + CAM_RX) * pxs + __ldg(cam + CAM_UX) * pys;
  float bdy = __ldg(cam + CAM_DY) * sd + __ldg(cam + CAM_RY) * pxs + __ldg(cam + CAM_UY) * pys;
  float bdz = __ldg(cam + CAM_DZ) * sd + __ldg(cam + CAM_RZ) * pxs + __ldg(cam + CAM_UZ) * pys;
  const float binv = rsqrtf(fmaxf(bdx * bdx + bdy * bdy + bdz * bdz, 1e-30f));
  bdx *= binv;
  bdy *= binv;
  bdz *= binv;

  // sunflower_disc(s, spp, aperture)
  const rt::Sunflower& S = P.shade.sun;
  const float half_ap = __ldg(cam + CAM_AP) * 0.5f;
  float r = sf > S.n_minus_b
                ? half_ap
                : half_ap * sqrtf(fmaxf(sf - 0.5f, 0.0f) * P.sun_inv_denom);
  if (sf == 0.0f) r = 0.0f;
  const float th = P.golden * sf;
  cth = cosf(th);
  sth = sinf(th);
  const float offx = r * cth, offy = r * sth;
  // cross(base, up) and cross(that, base)
  const float rrx = -bdz, rry = 0.0f, rrz = bdx;
  const float rux = rry * bdz - rrz * bdy;
  const float ruy = rrz * bdx - rrx * bdz;
  const float ruz = rrx * bdy - rry * bdx;

  float fd = __ldg(cam + CAM_FD);
  if (V.n_focus > 1) {
    const int k = s_i % V.n_focus;
    if (k > 0) fd = __ldg(cam + CAM_FD2 + k - 1);
  }
  const float cpx = __ldg(cam + CAM_PX), cpy = __ldg(cam + CAM_PY), cpz = __ldg(cam + CAM_PZ);
  const float tipx = cpx + bdx + rrx * offx + rux * offy;
  const float tipy = cpy + bdy + rry * offx + ruy * offy;
  const float tipz = cpz + bdz + rrz * offx + ruz * offy;
  float ddx = cpx + bdx * fd - tipx;
  float ddy = cpy + bdy * fd - tipy;
  float ddz = cpz + bdz * fd - tipz;
  const float dinv = rsqrtf(fmaxf(ddx * ddx + ddy * ddy + ddz * ddz, 1e-30f));
  ddx *= dinv;
  ddy *= dinv;
  ddz *= dinv;
  ray.ox = tipx - ddx;
  ray.oy = tipy - ddy;
  ray.oz = tipz - ddz;
  ray.dx = ddx;
  ray.dy = ddy;
  ray.dz = ddz;
  return ray;
}

// Resident blocks of 128 threads per SM each instantiation is compiled for,
// and with them its register budget: 6 (80 registers) for spheres, 5 (96) for
// generic primitives.  Unbounded, ptxas takes 91 and 94-108 registers, fits
// one block fewer per SM and runs slower; a tighter bound spills (PERF.md).
// The lights and materials instantiations take MIN_BLOCKS_LIGHTS and
// MIN_BLOCKS_MATERIALS (sphere, generic), the fastest of 3 to 8 on their
// frames (chip_k1.py --bounds, PERF.md): generic lights 6 (80 registers and
// 136 B of spill beat 96 registers at 5), sphere lights 5, sphere materials 6;
// generic materials, on no frame, takes the generic 'bvh' bound.  Of the
// textured instantiations the static sphere 'bvh' one, which the texturing
// frames run, takes MIN_BLOCKS_TEX_SPHERE (chip_k1.py --bounds); the others
// take their untextured twin's bound.
constexpr int MIN_BLOCKS_SPHERE = 6;
constexpr int MIN_BLOCKS_GENERIC = 5;
constexpr int MIN_BLOCKS_LIGHTS[2] = {5, 6};
constexpr int MIN_BLOCKS_MATERIALS[2] = {6, 5};
constexpr int MIN_BLOCKS_TEX_SPHERE = 6;

template <bool GENERIC, int SHADING, bool TEX>
constexpr int min_blocks() {
  return TEX && !GENERIC && SHADING == SH_BVH ? MIN_BLOCKS_TEX_SPHERE
         : SHADING == SH_LIGHTS    ? MIN_BLOCKS_LIGHTS[GENERIC]
         : SHADING == SH_MATERIALS ? MIN_BLOCKS_MATERIALS[GENERIC]
         : GENERIC                 ? MIN_BLOCKS_GENERIC
                                   : MIN_BLOCKS_SPHERE;
}

constexpr int THREADS = 128;

// live_rows: (n_groups,) int32, each main group's last live row + 1.
// lights: (n_lights, 8) float32 (SH_LIGHTS only).  stack: the scratch of
// P.stack_stride threads x Q records of REC floats.
template <bool GENERIC, bool MOTION, int SHADING, bool TEX>
__global__ void __launch_bounds__(THREADS, min_blocks<GENERIC, SHADING, TEX>())
uber_kernel(rt::Tables T, UberParams P, CameraVariants V, rt::Atlas atlas,
            const float* __restrict__ cam, const int* __restrict__ live_rows,
            const float* __restrict__ lights, float* __restrict__ stack,
            float4* __restrict__ out, unsigned long long* __restrict__ stats) {
  constexpr bool MAT = SHADING == SH_MATERIALS;
  constexpr bool LIGHTS = SHADING == SH_LIGHTS;
  constexpr int REC = MAT ? 10 : 8;  // floats per stacked record
  const unsigned FULL = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const size_t stride = P.stack_stride;
  float* const my_stack = stack + (size_t)blockIdx.x * blockDim.x + threadIdx.x;

  bool act = false, exhausted = false;
  Ray cur = {};
  unsigned long long p = 0;
  float sidx = 0.0f, cth = 1.0f, sth = 0.0f;
  float omt = 0.0f;  // 1 - time_ratio of the tree; read by MOTION only
  float acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f, acc_t = P.t_max;
  int qs = 0, cnt = 0;
  unsigned n_rays = 0, n_drop = 0, n_hits = 0;  // this thread's; n_hits: generic only
  unsigned n_shadow = 0;                         // SH_LIGHTS only
  unsigned n_tex = 0;                            // TEX only
  rt::WarpCounts wc = {};

  for (;;) {
    // ---- lanes whose tree ended take the next primaries ------------------
    const bool want = !act && !exhausted;
    const unsigned need = __ballot_sync(FULL, want);
    if (need) {
      const int leader = __ffs(need) - 1;
      unsigned long long base = 0;
      if (lane == leader)
        base = atomicAdd(&stats[ST_NEXT], (unsigned long long)__popc(need));
      base = __shfl_sync(FULL, base, leader);
      if (want) {
        const unsigned long long pp = base + __popc(need & ((1u << lane) - 1u));
        if (pp >= P.B_total) {
          exhausted = true;
        } else {
          p = pp;
          cur = raygen(P, V, cam, p, sidx, cth, sth);
          if (MOTION) omt = 1.0f - sidx / (float)P.spp;
          acc_r = acc_g = acc_b = 0.0f;
          acc_t = P.t_max;
          qs = 0;
          cnt = 0;
          act = true;
        }
      }
    }
    if (__all_sync(FULL, !act)) break;

    // ---- trace one node: every lane of the warp sweeps together ----------
    const bool live =
        act && (cur.dx * cur.dx + cur.dy * cur.dy + cur.dz * cur.dz) > 0.5f;
    float t_best;
    int obj;
    if constexpr (GENERIC)
      rt::warp_nearest_hit_g<MOTION>(T, live_rows, P.coop_min, lane, cur.ox, cur.oy,
                                     cur.oz, cur.dx, cur.dy, cur.dz, omt, live,
                                     P.t_max, t_best, obj, wc);
    else
      rt::warp_nearest_hit<MOTION>(T, live_rows, P.coop_min, lane, cur.ox, cur.oy,
                                   cur.oz, cur.dx, cur.dy, cur.dz, omt, live,
                                   P.t_max, t_best, obj, wc);

    // ---- lights: refine the hit, then every lane sweeps its shadow rays --
    bool white = false;  // the node hit an emissive object
    float lit = 1.0f;    // share of the lights its hit sees
    rt::RefinedT<TEX> R = {};
    if constexpr (LIGHTS) {
      constexpr int COLS = GENERIC ? rt::GFT_COLS : rt::FT_COLS;
      bool did_hit = false;
      if (act && obj >= 0) {
        R = rt::refine_hit<GENERIC, MOTION, TEX>(T, obj, t_best, cur.ox, cur.oy, cur.oz,
                                                 cur.dx, cur.dy, cur.dz, omt);
        white = __ldg(T.ftab + (size_t)obj * COLS + rt::FT_EMIS) > 0.5f;
        did_hit = !white;
      }
      lit = rt::warp_shadow_factor<GENERIC, MOTION>(
          T, live_rows, P.coop_min, lane, lights, P.n_lights, P.inv_n_lights, did_hit, R,
          omt, sidx * P.inv_spp, wc, n_shadow);
    }
    if (!act) continue;  // a lane without a tree only served rows

    // ---- shade it ---------------------------------------------------------
    if (GENERIC && obj >= 0) n_hits += 1;

    float add_r, add_g, add_b, hit_t;
    bool sp_refr = false, sp_refl = false;
    rt::Child refr = {}, refl = {};
    float refr_medium = 1.0f, refr_parent = 1.0f;  // materials only
    if (obj >= 0) {
      if constexpr (MAT) {
        const rt::MatShade sh = rt::shade_materials<GENERIC, MOTION, TEX>(
            T, P.shade, obj, t_best, cur.ox, cur.oy, cur.oz, cur.dx, cur.dy, cur.dz, omt,
            cur.contrib, cur.bounced, cur.medium, cur.parent, sidx, cth, sth, atlas);
        add_r = sh.add_r;
        add_g = sh.add_g;
        add_b = sh.add_b;
        hit_t = sh.hit_t;
        sp_refr = sh.spawn_refr;
        sp_refl = sh.spawn_refl;
        refr = sh.refr;
        refl = sh.refl;
        refr_medium = sh.refr_medium;
        refr_parent = sh.refr_parent;
      } else if constexpr (LIGHTS) {
        if (white) {
          add_r = add_g = add_b = 0.0f;
          hit_t = R.t;
        } else {
          const rt::Shade sh = rt::shade_hit<GENERIC, MOTION, false, true, TEX>(
              T, P.shade, obj, t_best, cur.ox, cur.oy, cur.oz, cur.dx, cur.dy, cur.dz,
              omt, cur.contrib * lit, cur.bounced, sidx, cth, sth, &R, 1.0f, atlas);
          add_r = sh.add_r;
          add_g = sh.add_g;
          add_b = sh.add_b;
          hit_t = sh.hit_t;
          sp_refr = sh.spawn_refr;
          sp_refl = sh.spawn_refl;
          refr = sh.refr;
          refl = sh.refl;
        }
      } else {
        const rt::Shade sh = rt::shade_hit<GENERIC, MOTION, false, false, TEX>(
            T, P.shade, obj, t_best, cur.ox, cur.oy, cur.oz, cur.dx, cur.dy,
            cur.dz, omt, cur.contrib, cur.bounced, sidx, cth, sth, nullptr, 1.0f, atlas);
        add_r = sh.add_r;
        add_g = sh.add_g;
        add_b = sh.add_b;
        hit_t = sh.hit_t;
        sp_refr = sh.spawn_refr;
        sp_refl = sh.spawn_refl;
        refr = sh.refr;
        refl = sh.refl;
      }
    } else {
      // Miss: contribution times the sky gradient (black with lights), depth t_max.
      const float tt = (cur.dy + 1.0f) * 0.5f;
      add_r = cur.contrib * ((1.0f - tt) * P.bg_bottom[0] + tt * P.bg_top[0]);
      add_g = cur.contrib * ((1.0f - tt) * P.bg_bottom[1] + tt * P.bg_top[1]);
      add_b = cur.contrib * ((1.0f - tt) * P.bg_bottom[2] + tt * P.bg_top[2]);
      hit_t = P.t_max;
    }
    if constexpr (TEX) {
      constexpr int COLS = GENERIC ? rt::GFT_COLS : rt::FT_COLS;
      if (obj >= 0 && !white && __ldg(T.ftab + (size_t)obj * COLS + rt::FT_TEX) > 0.5f)
        n_tex += 1;
    }
    if (cur.bounced == 0.0f) acc_t = hit_t;  // primary hit distance
    acc_r += add_r;
    acc_g += add_g;
    acc_b += add_b;
    if (LIGHTS && white) acc_r = acc_g = acc_b = 1.0f;  // the sample is white
    n_rays += 1;  // every processed node counts, misses included

    // ---- children: one in place, the other on the stack -------------------
    // 'bvh': reflection in place, refraction stacked; materials: refraction
    // in place, reflection stacked (it keeps the node's own media).
    const rt::Child& inplace = MAT ? refr : refl;
    const rt::Child& queued = MAT ? refl : refr;
    const bool sp_in = MAT ? sp_refr : sp_refl;
    const bool sp_q = MAT ? sp_refl : sp_refr;
    const float bounced1 = cur.bounced + 1.0f;
    const bool push = sp_refl && sp_refr;
    const bool canq = qs < P.Q;
    if (push && canq) {
      float* rec = my_stack + (size_t)qs * REC * stride;
      rec[0] = queued.ox;
      rec[stride] = queued.oy;
      rec[2 * stride] = queued.oz;
      rec[3 * stride] = queued.dx;
      rec[4 * stride] = queued.dy;
      rec[5 * stride] = queued.dz;
      rec[6 * stride] = queued.contrib;
      rec[7 * stride] = bounced1;
      if constexpr (MAT) {
        rec[8 * stride] = cur.medium;
        rec[9 * stride] = cur.parent;
      }
      qs += 1;
    }
    // On overflow the stacked-preference child survives and the in-place one
    // is dropped; the drop is counted.
    const bool overflow = push && !canq;
    if (overflow) n_drop += 1;
    // Per-primary node budget, and the emissive abort: the tree dies and
    // stacked siblings are dropped.
    cnt += 1;
    const bool kill = cnt >= P.pops || (LIGHTS && white);
    if (kill) {
      qs = 0;
      act = false;
    } else if (sp_in && !overflow) {
      cur.ox = inplace.ox;
      cur.oy = inplace.oy;
      cur.oz = inplace.oz;
      cur.dx = inplace.dx;
      cur.dy = inplace.dy;
      cur.dz = inplace.dz;
      cur.contrib = inplace.contrib;
      cur.bounced = bounced1;
      if constexpr (MAT) {
        cur.medium = refr_medium;
        cur.parent = refr_parent;
      }
    } else if (sp_q) {
      cur.ox = queued.ox;
      cur.oy = queued.oy;
      cur.oz = queued.oz;
      cur.dx = queued.dx;
      cur.dy = queued.dy;
      cur.dz = queued.dz;
      cur.contrib = queued.contrib;
      cur.bounced = bounced1;
    } else if (qs > 0) {
      qs -= 1;
      const float* rec = my_stack + (size_t)qs * REC * stride;
      cur.ox = rec[0];
      cur.oy = rec[stride];
      cur.oz = rec[2 * stride];
      cur.dx = rec[3 * stride];
      cur.dy = rec[4 * stride];
      cur.dz = rec[5 * stride];
      cur.contrib = rec[6 * stride];
      cur.bounced = rec[7 * stride];
      if constexpr (MAT) {
        cur.medium = rec[8 * stride];
        cur.parent = rec[9 * stride];
      }
    } else {
      act = false;
    }
    if (!act) out[p] = make_float4(acc_r, acc_g, acc_b, acc_t);
  }

  // ---- frame counters: warp reduce, one atomic per warp and counter ------
  unsigned long long rays = n_rays, drop = n_drop, n_tests = wc.tests, n_rows = wc.rows,
                     n_slots = wc.slots, n_coop = wc.coop;
  for (int off = 16; off > 0; off >>= 1) {
    rays += __shfl_down_sync(FULL, rays, off);
    drop += __shfl_down_sync(FULL, drop, off);
    n_tests += __shfl_down_sync(FULL, n_tests, off);
    n_rows += __shfl_down_sync(FULL, n_rows, off);
    n_slots += __shfl_down_sync(FULL, n_slots, off);
    n_coop += __shfl_down_sync(FULL, n_coop, off);
  }
  if (lane == 0) {
    atomicAdd(&stats[ST_RAYS], rays);
    atomicAdd(&stats[ST_DROPPED], drop);
    atomicAdd(&stats[ST_SPHERE_TESTS], n_tests);
    atomicAdd(&stats[ST_ROW_TESTS], n_rows);
    atomicAdd(&stats[ST_LANE_SLOTS], n_slots);
    atomicAdd(&stats[ST_COOP_VISITS], n_coop);
  }
  if constexpr (GENERIC) {
    unsigned long long n_slab = wc.slab, n_other = wc.other, hits = n_hits;
    for (int off = 16; off > 0; off >>= 1) {
      n_slab += __shfl_down_sync(FULL, n_slab, off);
      n_other += __shfl_down_sync(FULL, n_other, off);
      hits += __shfl_down_sync(FULL, hits, off);
    }
    if (lane == 0) {
      atomicAdd(&stats[ST_SLAB_TESTS], n_slab);
      atomicAdd(&stats[ST_OTHER_TESTS], n_other);
      atomicAdd(&stats[ST_HITS], hits);
    }
  }
  if constexpr (LIGHTS) {
    unsigned long long shadow = n_shadow;
    for (int off = 16; off > 0; off >>= 1) shadow += __shfl_down_sync(FULL, shadow, off);
    if (lane == 0) atomicAdd(&stats[ST_SHADOW_RAYS], shadow);
  }
  if constexpr (TEX) {
    unsigned long long samples = n_tex;
    for (int off = 16; off > 0; off >>= 1) samples += __shfl_down_sync(FULL, samples, off);
    if (lane == 0) atomicAdd(&stats[ST_TEX_SAMPLES], samples);
  }
}

// Everything one launch needs, as the host function received it.
struct Launch {
  rt::Tables T;
  UberParams P;
  CameraVariants V;
  rt::Atlas atlas;
  const float* cam;
  const int* live_rows;
  const float* lights;
  float* stack;
  float4* out;
  unsigned long long* stats;
  cudaStream_t stream;
};

// Fill the card once: as many resident blocks as it holds, no more than the
// frame has primaries for -> the blocks, or a negative CUDA error code.
template <bool GENERIC, bool MOTION, int SHADING, bool TEX>
long long resident_blocks(unsigned long long B_total) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return -(long long)e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return -(long long)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, uber_kernel<GENERIC, MOTION, SHADING, TEX>, THREADS, 0);
  if (e != cudaSuccess) return -(long long)e;
  if (per_sm < 1) per_sm = 1;
  long long blocks = (long long)sms * per_sm;
  const long long needed = ((long long)B_total + THREADS - 1) / THREADS;
  return blocks > needed ? needed : blocks;
}

// With L: launch on as many of those blocks as the stack buffer holds
// (L->P.stack_stride threads) -> cudaGetLastError().  Without: the threads a
// launch keeps resident, for the wrapper to size the stack buffer by.
template <bool GENERIC, bool MOTION, int SHADING, bool TEX>
long long run(const Launch* L, unsigned long long B_total) {
  long long blocks = resident_blocks<GENERIC, MOTION, SHADING, TEX>(B_total);
  if (blocks < 0) return blocks;
  if (L == nullptr) return blocks * THREADS;
  const long long fit = (long long)L->P.stack_stride / THREADS;
  if (fit < 1) return (long long)cudaErrorInvalidValue;
  if (blocks > fit) blocks = fit;
  const auto kernel = uber_kernel<GENERIC, MOTION, SHADING, TEX>;
  RT_LAUNCH(kernel, (int)blocks, THREADS, L->stream, L->T, L->P, L->V, L->atlas, L->cam,
            L->live_rows, L->lights, L->stack, L->out, L->stats);
  return static_cast<long long>(cudaGetLastError());
}

// The instantiation ip selects, among this library's (TEX = RT_UBER_TEX).
long long dispatch(const int* ip, const Launch* L, unsigned long long B_total) {
  constexpr bool TEX = RT_UBER_TEX != 0;
  const int g = ip[IP_GENERIC] ? 1 : 0, m = ip[IP_MOTION] ? 1 : 0, sh = ip[IP_SHADING];
  if (sh < SH_BVH || sh > SH_MATERIALS) return -(long long)cudaErrorInvalidValue;
  switch ((g * 2 + m) * 3 + sh) {
    case 0: return run<false, false, SH_BVH, TEX>(L, B_total);
    case 1: return run<false, false, SH_LIGHTS, TEX>(L, B_total);
    case 2: return run<false, false, SH_MATERIALS, TEX>(L, B_total);
    case 3: return run<false, true, SH_BVH, TEX>(L, B_total);
    case 4: return run<false, true, SH_LIGHTS, TEX>(L, B_total);
    case 5: return run<false, true, SH_MATERIALS, TEX>(L, B_total);
    case 6: return run<true, false, SH_BVH, TEX>(L, B_total);
    case 7: return run<true, false, SH_LIGHTS, TEX>(L, B_total);
    case 8: return run<true, false, SH_MATERIALS, TEX>(L, B_total);
    case 9: return run<true, true, SH_BVH, TEX>(L, B_total);
    case 10: return run<true, true, SH_LIGHTS, TEX>(L, B_total);
    default: return run<true, true, SH_MATERIALS, TEX>(L, B_total);
  }
}

}  // namespace

// The threads a launch of the instantiation ip selects keeps resident for a
// frame of B_total primaries (the stack buffer holds Q records for each), or
// a negative CUDA error code.
extern "C" long long rt_uber_threads(const int* ip, long long B_total) {
  if (B_total <= 0) return 0;
  return dispatch(ip, nullptr, (unsigned long long)B_total);
}

// out: (B_total, 4) float32; stats: uint64[ST_LEN], zeroed by the caller;
// cam: device (24,) float32; live_rows: device (n_groups,) int32, each main
// group's last live row + 1; lights: device (n_lights, 8) float32 under
// SH_LIGHTS, else unused; atlas: device (T, H, W6) float4 texels
// (kernels/texture.py::pack_atlas) for this library's textured
// instantiations, null for the untextured ones; aa: device (spp, 2) float32
// aa_grid screen offsets of each sample (kernels/uber.py::aa_table), or null;
// stack: device float32 scratch of stack_threads x Q x REC (8, or 10 under
// SH_MATERIALS) floats, stack_threads at least one block (rt_uber_threads
// gives what a launch uses); ip / fp: HOST parameter vectors (IP_* / FP_*
// above); ip[IP_GENERIC], ip[IP_MOTION] and ip[IP_SHADING] pick the
// instantiation, and with it the layout the three tables must have.
// Launches on `stream`, does not synchronise, returns cudaGetLastError().
extern "C" int rt_uber_render(const void* otab, const void* ftab,
                              const void* gaabb, const void* live_rows,
                              const void* cam, const void* lights, const void* atlas,
                              const void* aa, const int* ip, const float* fp,
                              long long B_total, void* out, void* stats, void* stack,
                              long long stack_threads, void* stream) {
  if (B_total <= 0) return 0;
  if (ip[IP_Q] < 0 || stack == nullptr || stack_threads < 1)
    return (int)cudaErrorInvalidValue;
  if (ip[IP_SHADING] == SH_LIGHTS && (ip[IP_NLIGHTS] < 1 || lights == nullptr))
    return (int)cudaErrorInvalidValue;
  if ((atlas != nullptr) != (RT_UBER_TEX != 0) || ip[IP_NFOCUS] < 1 || ip[IP_NFOCUS] > 7)
    return (int)cudaErrorInvalidValue;
  if (atlas != nullptr && (ip[IP_TEX_T] < 1 || ip[IP_TEX_H] < 1 || ip[IP_TEX_W6] < 1))
    return (int)cudaErrorInvalidValue;
  Launch L;
  L.T.otab = static_cast<const float*>(otab);
  L.T.ftab = static_cast<const float*>(ftab);
  L.T.gaabb = static_cast<const float*>(gaabb);
  L.T.n_groups = ip[IP_NGROUPS];
  L.T.gr = ip[IP_GR];
  L.T.n_pgroups = ip[IP_NPGROUPS];
  L.T.probe_gr = ip[IP_PROBE_GR];
  L.T.n_sgroups = ip[IP_NSGROUPS];

  UberParams& P = L.P;
  P.W = ip[IP_W];
  P.spp = ip[IP_SPP];
  P.Q = ip[IP_Q];
  P.pops = ip[IP_POPS];
  P.coop_min = ip[IP_COOP_MIN];
  P.n_lights = ip[IP_SHADING] == SH_LIGHTS ? ip[IP_NLIGHTS] : 0;
  L.V.aa = static_cast<const float*>(aa);
  L.V.n_focus = ip[IP_NFOCUS];
  L.V.ortho = ip[IP_ORTHO];
  L.atlas.texels = static_cast<const float4*>(atlas);
  L.atlas.T = ip[IP_TEX_T];
  L.atlas.H = ip[IP_TEX_H];
  L.atlas.W6 = ip[IP_TEX_W6];
  P.B_total = (unsigned long long)B_total;
  P.stack_stride = (unsigned long long)stack_threads;
  P.t_max = fp[FP_TMAX];
  P.golden = fp[FP_GOLDEN];
  P.inv_W = fp[FP_INV_W];
  P.inv_H = fp[FP_INV_H];
  P.aspect = fp[FP_ASPECT];
  P.sun_inv_denom = fp[FP_SUN_INV_DENOM];
  P.inv_spp = fp[FP_INV_SPP];
  P.inv_n_lights = fp[FP_INV_NLIGHTS];
  for (int c = 0; c < 3; ++c) {
    P.bg_bottom[c] = fp[FP_BG_BOTTOM + c];
    P.bg_top[c] = fp[FP_BG_TOP + c];
  }
  P.shade.sun.n = fp[FP_SUN_N];
  P.shade.sun.n_minus_b = fp[FP_SUN_NMB];
  P.shade.sun.denom = fp[FP_SUN_DENOM];
  P.shade.max_bounces = fp[FP_MAX_BOUNCES];
  P.shade.has_dielectrics = ip[IP_HAS_DIEL];

  L.cam = static_cast<const float*>(cam);
  L.live_rows = static_cast<const int*>(live_rows);
  L.lights = static_cast<const float*>(lights);
  L.stack = static_cast<float*>(stack);
  L.out = static_cast<float4*>(out);
  L.stats = static_cast<unsigned long long*>(stats);
  L.stream = static_cast<cudaStream_t>(stream);
  const long long code = dispatch(ip, &L, P.B_total);
  return (int)(code < 0 ? -code : code);
}
