// Warp-cooperative sweeps, shared by the persistent path tracer (uber.cu),
// the sphere sweep (sweep2.cu), the generic sweep (sweep2g.cu) and the
// chunked megakernel (mega.cu).
//
// A walk of one thread per ray, in which each lane enters the groups its own
// slab test admits and solves every row of each, makes a warp issue the rows
// of the UNION of its lanes' groups while the lanes that did not enter idle.
// Here the whole warp takes every group step together:
//
//   - each live lane does its own slab test against its own t_best;
//     m = ballot(entered);
//   - popc(m) >= coop_min: the lanes in m run the per-lane row loop (the
//     per-thread schedule);
//   - otherwise the group is swept ROW-PARALLEL, once for each lane L in m:
//     L's ray constants are broadcast, every lane of the warp (entered or
//     not, live or not) evaluates rows lane, lane + W, ... with exactly the
//     per-lane expression, two warp reductions take the lexicographic
//     minimum of (t, row), and L keeps it if it is below its t_best.
//
// Both modes give the same (t_best, obj) bit for bit under -fmad=false: the
// per-pair arithmetic is the same expression on the same operands, and the
// lowest row that reaches the minimum is what the sequential strict-< scan
// keeps.  The surrounding-RI probe (warp_ri_probe) is row-parallel in the
// same way and sums in row order.  Every lane must call these functions
// together (full-mask ballots and shuffles): a lane with no ray enters with
// live = false and serves rows.
//
// Rows past a group's last live row (live_rows[g], from the wrapper) are
// never read: dead rows cannot win, so the bound changes no result.  The ray's
// own reciprocals (1/dx, 1/dy, 1/dz of the generic unrotated and y-rotated
// cuboid rows) are computed once per node: the same IEEE division of the same
// operand as per row.
#pragma once

#include "rt_common.cuh"

// Lanes of a warp.  host_shim.h sets 1: there a warp is one lane and the row
// stride is 1, so the host rehearsal runs both modes through the same code.
#ifndef RT_WARP_LANES
#define RT_WARP_LANES 32
#endif

namespace rt {

constexpr unsigned WARP_FULL = 0xffffffffu;

// Work counters of the warp sweeps (measurement only), one thread's share of
// a launch (32 bits hold it; the kernels sum them in 64).  `tests`: sphere
// quadratics (sphere mode: gr per entered group; generic mode: live
// sphere-kind rows); `other`: generic live rows of other kinds; `slab`:
// generic slab tests; `rows`: rows up to the live bound of each group a lane
// entered (the rows its own walk needs); `slots`: RT_WARP_LANES x the row
// iterations the warp issued, and `coop`: group visits served row-parallel,
// both added by lane 0 only (one add per warp and group).
struct WarpCounts {
  unsigned tests, other, slab, rows, slots, coop;
};

// Lexicographic minimum of (t, row) over the warp: the smaller t, and on a
// tie the lower row.  A lane with no candidate holds (its start t, -1), which
// as unsigned loses every tie.  Every t here is positive (a start t_best > 0,
// or a candidate below it), and the bits of a positive float order as the
// float does: two warp reductions, the least t and then the least row that
// holds it (a 5-step shuffle butterfly measured slower: PERF.md).
__device__ __forceinline__ void warp_argmin(float& t, int& row) {
  const unsigned tbits = __reduce_min_sync(WARP_FULL, __float_as_uint(t));
  row = (int)__reduce_min_sync(WARP_FULL,
                               __float_as_uint(t) == tbits ? (unsigned)row : 0xffffffffu);
  t = __uint_as_float(tbits);
}

// Row iterations a row-parallel pass over n rows issues.
__device__ __forceinline__ unsigned coop_iters(int n) {
  return (unsigned)((n + RT_WARP_LANES - 1) / RT_WARP_LANES);
}

// One sphere row in the group-anchored frame (s = o - anchor, od = s.d,
// oo = s.s): its t, or -1 where the quadratic has no root in front.  Row
// centres are relative to the group anchor (rt_common.cuh), so the
// quadratic is pre-expanded: -b/2 = C.d - s.d, c = s.s + K1 - 2 C.s.
template <bool MOTION>
__device__ __forceinline__ float sphere_row_t(const float* row, float sx, float sy,
                                              float sz, float dx, float dy, float dz,
                                              float od, float oo, float omt) {
  const float4 c = ld4(row);  // cx cy cz k1
  const float DC = c.x * dx + c.y * dy + c.z * dz;
  const float OC = c.x * sx + c.y * sy + c.z * sz;
  float nb = DC - od;  // = -half_b
  float c_q = oo + c.w - 2.0f * OC;
  if (MOTION) {
    const float4 k = ld4(row + 4);  // ri rinv2 k2 k3
    const float4 m = ld4(row + 8);  // dpx dpy dpz 0
    const float DDP = m.x * dx + m.y * dy + m.z * dz;
    const float ODP = m.x * sx + m.y * sy + m.z * sz;
    nb = nb - omt * DDP;
    c_q = c_q + omt * (2.0f * ODP - k.z) + (omt * omt) * k.w;
  }
  const float disc = nb * nb - c_q;
  if (!(disc > 0.0f)) return -1.0f;
  const float sq = sqrtf(disc);
  const float tn = nb - sq;  // near root (a == 1)
  return tn > 0.0f ? tn : nb + sq;
}

// Nearest hit over the grouped sphere tables: groups in table order
// (near-first from the camera), each behind the lane's own slab test against
// its current best t, a group's spheres solved around its anchor; ties keep
// the lower row.  obj = -1 and t_best = min(BIG_T, tlim) on a miss or a dead
// ray.  Warp-cooperative as the file comment says; `wc.tests` gains gr per
// group the lane entered (the sphere quadratics of the per-lane walk).
template <bool MOTION>
__device__ __forceinline__ void warp_nearest_hit(
    const Tables& T, const int* __restrict__ live_rows, int coop_min, int lane,
    float ox, float oy, float oz, float dx, float dy, float dz, float omt,
    bool live, float tlim, float& t_best, int& obj, WarpCounts& wc) {
  constexpr int COLS = MOTION ? OT_COLS_MOTION : OT_COLS;
  t_best = fminf(BIG_T, tlim);
  obj = -1;
  if (__ballot_sync(WARP_FULL, live) == 0u) return;
  const float eps = 1e-12f;
  const float ix = 1.0f / (fabsf(dx) < eps ? eps : dx);
  const float iy = 1.0f / (fabsf(dy) < eps ? eps : dy);
  const float iz = 1.0f / (fabsf(dz) < eps ? eps : dz);
  for (int g = 0; g < T.n_groups; ++g) {
    const float* ga = T.gaabb + g * GA_COLS;
    const float4 a0 = ld4(ga);      // lo.x lo.y lo.z hi.x
    const float4 a1 = ld4(ga + 4);  // hi.y hi.z an.x an.y
    bool entered = false;
    if (live) {
      const float u1 = (a0.x - ox) * ix, w1 = (a0.w - ox) * ix;
      const float u2 = (a0.y - oy) * iy, w2 = (a1.x - oy) * iy;
      const float u3 = (a0.z - oz) * iz, w3 = (a1.y - oz) * iz;
      const float tmin = fmaxf(fmaxf(fminf(u1, w1), fminf(u2, w2)), fminf(u3, w3));
      const float tmax = fminf(fminf(fmaxf(u1, w1), fmaxf(u2, w2)), fmaxf(u3, w3));
      entered = (tmax > tmin) && (tmax > 0.0f) && (tmin < t_best);
    }
    const unsigned m = __ballot_sync(WARP_FULL, entered);
    if (m == 0u) continue;
    const int n = __ldg(live_rows + g);
    const int row0 = g * T.gr;
    const float* rows = T.otab + (size_t)row0 * COLS;
    // Shift the ray into the group-anchored frame.
    const float sx = ox - a1.z, sy = oy - a1.w, sz = oz - __ldg(ga + 8);
    const float od = sx * dx + sy * dy + sz * dz;
    const float oo = sx * sx + sy * sy + sz * sz;
    if (entered) {
      wc.tests += (unsigned)T.gr;
      wc.rows += (unsigned)n;
    }
    if (__popc(m) >= coop_min) {
      if (lane == 0) wc.slots += RT_WARP_LANES * (unsigned)n;
      if (entered) {
        for (int r = 0; r < n; ++r) {
          const float t = sphere_row_t<MOTION>(rows + r * COLS, sx, sy, sz, dx, dy, dz,
                                               od, oo, omt);
          if (t > 0.0f && t < t_best) {
            t_best = t;
            obj = row0 + r;
          }
        }
      }
      continue;
    }
    if (lane == 0) {
      wc.coop += 1;
      wc.slots += RT_WARP_LANES * coop_iters(n) * (unsigned)__popc(m);
    }
    for (unsigned mm = m; mm != 0u; mm &= mm - 1u) {
      const int L = __ffs(mm) - 1;
      const float lsx = __shfl_sync(WARP_FULL, sx, L);
      const float lsy = __shfl_sync(WARP_FULL, sy, L);
      const float lsz = __shfl_sync(WARP_FULL, sz, L);
      const float ldx = __shfl_sync(WARP_FULL, dx, L);
      const float ldy = __shfl_sync(WARP_FULL, dy, L);
      const float ldz = __shfl_sync(WARP_FULL, dz, L);
      const float lod = __shfl_sync(WARP_FULL, od, L);
      const float loo = __shfl_sync(WARP_FULL, oo, L);
      const float lomt = MOTION ? __shfl_sync(WARP_FULL, omt, L) : 0.0f;
      float bt = __shfl_sync(WARP_FULL, t_best, L);
      int br = -1;
      for (int r = lane; r < n; r += RT_WARP_LANES) {
        const float t = sphere_row_t<MOTION>(rows + r * COLS, lsx, lsy, lsz, ldx, ldy, ldz,
                                             lod, loo, lomt);
        if (t > 0.0f && t < bt) {
          bt = t;
          br = r;
        }
      }
      warp_argmin(bt, br);
      if (lane == L && br >= 0) {
        t_best = bt;
        obj = row0 + br;
      }
    }
  }
}

// The ray's own reciprocals, hoisted out of the cuboid rows.
struct RayRcp {
  float x, y, z;
};

// Cuboid t from the local origin and the reciprocals of the local direction:
// rt::cub_t_inf after its three divisions.
__device__ __forceinline__ float cub_t_rcp(float lox, float loy, float loz, float i1,
                                           float i2, float i3, float sx, float sy,
                                           float sz) {
  const float u1 = (-0.5f * sx - lox) * i1, w1 = (0.5f * sx - lox) * i1;
  const float u2 = (-0.5f * sy - loy) * i2, w2 = (0.5f * sy - loy) * i2;
  const float u3 = (-0.5f * sz - loz) * i3, w3 = (0.5f * sz - loz) * i3;
  if (u1 != u1 || w1 != w1 || u2 != u2 || w2 != w2 || u3 != u3 || w3 != w3)
    return BIG_T;
  return slab_t(u1, w1, u2, w2, u3, w3);
}

// One generic row's candidate t by its group's kind, or BIG_T for a dead row
// or a miss; `live_rows_of_kind` gains 1 for a live row.  Candidates use the
// cheapest exact form the group's census allows (the plain version's,
// kernels/sweep2g.py::_group_candidates), with 1/d taken from `rcp`; the
// winner is re-solved in the dense intersector's form by winner_refine_g.
template <bool MOTION>
__device__ __forceinline__ float generic_row_t(const float* row, int kind, float ox,
                                               float oy, float oz, float dx, float dy,
                                               float dz, RayRcp rcp, float omt,
                                               unsigned& live_rows_of_kind) {
  const float4 p = ld4(row);      // px py pz type
  const float4 m = ld4(row + 4);  // dpx dpy dpz valid
  if (!(m.w > 0.0f)) return BIG_T;  // dead and padding rows
  live_rows_of_kind += 1;
  const float4 s = ld4(row + 8);  // sx sy sz ri
  float rx = ox - p.x, ry = oy - p.y, rz = oz - p.z;
  if (MOTION) {
    rx = rx + omt * m.x;
    ry = ry + omt * m.y;
    rz = rz + omt * m.z;
  }
  if (kind == GK_SPHERE) {
    // Isotropic sphere, unit direction: the world-frame quadratic, a = 1.
    const float hb = rx * dx + ry * dy + rz * dz;
    const float cq = rx * rx + ry * ry + rz * rz - s.x * s.x;
    const float disc = hb * hb - cq;
    if (!(disc > 0.0f)) return BIG_T;
    const float sq = sqrtf(disc);
    const float t0 = -hb - sq, t1 = -hb + sq;
    const float t_e = t0 < 0.0f ? t1 : t0;
    return t_e > 0.0f ? t_e : BIG_T;
  }
  if (kind == GK_AXIS) return cub_t_rcp(rx, ry, rz, rcp.x, rcp.y, rcp.z, s.x, s.y, s.z);
  if (kind == GK_YROT) {
    // Rotation about y: four live matrix entries; the local dy is the ray's.
    const float r0 = __ldg(row + GO_R00), r2 = __ldg(row + GO_R00 + 2);
    const float r6 = __ldg(row + GO_R00 + 6), r8 = __ldg(row + GO_R00 + 8);
    const float ldx = r0 * dx + r6 * dz, ldz = r2 * dx + r8 * dz;
    return cub_t_rcp(r0 * rx + r6 * rz, ry, r2 * rx + r8 * rz, 1.0f / ldx, rcp.y,
                     1.0f / ldz, s.x, s.y, s.z);
  }
  const float4 ra = ld4(row + GO_R00);      // R00 R01 R02 R10
  const float4 rb = ld4(row + GO_R00 + 4);  // R11 R12 R20 R21
  const float r22 = __ldg(row + GO_R00 + 8);
  // local = R^T rel: column dot products
  const float lox = ra.x * rx + ra.w * ry + rb.z * rz;
  const float loy = ra.y * rx + rb.x * ry + rb.w * rz;
  const float loz = ra.z * rx + rb.y * ry + r22 * rz;
  const float ldx = ra.x * dx + ra.w * dy + rb.z * dz;
  const float ldy = ra.y * dx + rb.x * dy + rb.w * dz;
  const float ldz = ra.z * dx + rb.y * dy + r22 * dz;
  if (kind == GK_ELL) return ell_t_div(lox, loy, loz, ldx, ldy, ldz, s.x, s.y, s.z);
  if (kind == GK_CUB) return cub_t_inf(lox, loy, loz, ldx, ldy, ldz, s.x, s.y, s.z);
  return p.w == ELLIPSOID ? ell_t_div(lox, loy, loz, ldx, ldy, ldz, s.x, s.y, s.z)
                          : cub_t_div(lox, loy, loz, ldx, ldy, ldz, s.x, s.y, s.z);
}

// Grouped nearest-hit sweep over the generic tables: super-group slab, group
// slab, then the group's rows, in table order; every slab test is the lane's
// own, against its own current best t, and the cooperative step applies per
// main group.  obj = -1 and t_best = min(BIG_T, tlim) on a miss or a dead
// ray (d = 0).  `wc.slab` gains the lane's slab tests, `wc.tests` /
// `wc.other` the live rows its own walk tests in sphere-kind groups / groups
// of another kind (dead and padding rows are not counted).
template <bool MOTION>
__device__ __forceinline__ void warp_nearest_hit_g(
    const Tables& T, const int* __restrict__ live_rows, int coop_min, int lane,
    float ox, float oy, float oz, float dx, float dy, float dz, float omt,
    bool live, float tlim, float& t_best, int& obj, WarpCounts& wc) {
  t_best = fminf(BIG_T, tlim);
  obj = -1;
  if (__ballot_sync(WARP_FULL, live) == 0u) return;
  const float eps = 1e-12f;
  const float ix = 1.0f / (fabsf(dx) < eps ? eps : dx);
  const float iy = 1.0f / (fabsf(dy) < eps ? eps : dy);
  const float iz = 1.0f / (fabsf(dz) < eps ? eps : dz);
  const RayRcp rcp = {1.0f / dx, 1.0f / dy, 1.0f / dz};
  const int n_super = T.n_sgroups > 0 ? T.n_sgroups : 1;
  const float* sga = T.gaabb + (size_t)(T.n_groups + T.n_pgroups) * GA_COLS;
  for (int s = 0; s < n_super; ++s) {
    int g0 = 0, g1 = T.n_groups;
    bool in_super = live;
    if (T.n_sgroups > 0) {
      if (live) {
        wc.slab += 1;
        in_super = slab_hit(sga + s * GA_COLS, ox, oy, oz, ix, iy, iz, t_best);
      }
      if (__ballot_sync(WARP_FULL, in_super) == 0u) continue;
      g0 = s * SG;
      g1 = g0 + SG < T.n_groups ? g0 + SG : T.n_groups;
    }
    for (int g = g0; g < g1; ++g) {
      const float* ga = T.gaabb + g * GA_COLS;
      bool entered = false;
      if (in_super) {
        wc.slab += 1;
        entered = slab_hit(ga, ox, oy, oz, ix, iy, iz, t_best);
      }
      const unsigned m = __ballot_sync(WARP_FULL, entered);
      if (m == 0u) continue;
      const int kind = (int)__ldg(ga + 6);
      const int n = __ldg(live_rows + g);
      const int row0 = g * T.gr;
      const float* rows = T.otab + (size_t)row0 * GO_COLS;
      unsigned n_live = 0;  // live rows this lane tested, by the group's kind
      if (entered) wc.rows += (unsigned)n;
      if (__popc(m) >= coop_min) {
        if (lane == 0) wc.slots += RT_WARP_LANES * (unsigned)n;
        if (entered) {
          for (int r = 0; r < n; ++r) {
            const float tc = generic_row_t<MOTION>(rows + r * GO_COLS, kind, ox, oy, oz,
                                                   dx, dy, dz, rcp, omt, n_live);
            if (tc < t_best) {  // ties keep the lower row
              t_best = tc;
              obj = row0 + r;
            }
          }
        }
      } else {
        if (lane == 0) {
          wc.coop += 1;
          wc.slots += RT_WARP_LANES * coop_iters(n) * (unsigned)__popc(m);
        }
        for (unsigned mm = m; mm != 0u; mm &= mm - 1u) {
          const int L = __ffs(mm) - 1;
          const float lox = __shfl_sync(WARP_FULL, ox, L);
          const float loy = __shfl_sync(WARP_FULL, oy, L);
          const float loz = __shfl_sync(WARP_FULL, oz, L);
          const float ldx = __shfl_sync(WARP_FULL, dx, L);
          const float ldy = __shfl_sync(WARP_FULL, dy, L);
          const float ldz = __shfl_sync(WARP_FULL, dz, L);
          const RayRcp lrcp = {__shfl_sync(WARP_FULL, rcp.x, L),
                               __shfl_sync(WARP_FULL, rcp.y, L),
                               __shfl_sync(WARP_FULL, rcp.z, L)};
          const float lomt = MOTION ? __shfl_sync(WARP_FULL, omt, L) : 0.0f;
          float bt = __shfl_sync(WARP_FULL, t_best, L);
          int br = -1;
          for (int r = lane; r < n; r += RT_WARP_LANES) {
            const float tc = generic_row_t<MOTION>(rows + r * GO_COLS, kind, lox, loy, loz,
                                                   ldx, ldy, ldz, lrcp, lomt, n_live);
            if (tc < bt) {
              bt = tc;
              br = r;
            }
          }
          warp_argmin(bt, br);
          if (lane == L && br >= 0) {
            t_best = bt;
            obj = row0 + br;
          }
        }
      }
      if (kind == GK_SPHERE)
        wc.tests += n_live;
      else
        wc.other += n_live;
    }
  }
}

// Emissive lights (kernels/mega.py::_shadow_factor_k): the share of the
// n_lights lights visible from a hit point R (outward normal) of every lane
// with `did_hit`.  For each light (rows of kernels/uber.py::pack_lights:
// bb_min xyz, bb_max xyz, diagonal, 0, read through the read-only path) one
// shadow ray leaves R + 1e-4 n toward the point bb_min + (bb_max - bb_min) *
// sratio of the light's box (sratio = the sample's s / spp), limited to the
// distance to the box's centre plus its diagonal, and swept through the same
// warp sweep as the node's own ray; the light counts where the nearest
// occluder is emissive.  The direction is normalised by division: a
// reciprocal square root moves the last ulp, which flips the visibility of
// rays that graze the light's box.  Every lane of the warp must call this
// together; a lane without `did_hit` sweeps a dead ray (live = false, d = 0).
// `n_shadow` gains the shadow rays this lane swept.
template <bool GENERIC, bool MOTION>
__device__ __forceinline__ float warp_shadow_factor(
    const Tables& T, const int* __restrict__ live_rows, int coop_min, int lane,
    const float* __restrict__ lights, int n_lights, float inv_n_lights, bool did_hit,
    const Refined& R, float omt, float sratio, WarpCounts& wc, unsigned& n_shadow) {
  constexpr int COLS = GENERIC ? GFT_COLS : FT_COLS;
  const float sox = R.px + 1e-4f * R.nx;
  const float soy = R.py + 1e-4f * R.ny;
  const float soz = R.pz + 1e-4f * R.nz;
  float lit = 0.0f;
  for (int l = 0; l < n_lights; ++l) {
    const float* L = lights + l * 8;
    const float4 a = ld4(L);      // bb_min xyz, bb_max x
    const float4 b = ld4(L + 4);  // bb_max yz, diagonal, 0
    float ddx = a.x + (a.w - a.x) * sratio - sox;
    float ddy = a.y + (b.x - a.y) * sratio - soy;
    float ddz = a.z + (b.y - a.z) * sratio - soz;
    const float dn = sqrtf(fmaxf(ddx * ddx + ddy * ddy + ddz * ddz, 1e-38f));
    ddx = did_hit ? ddx / dn : 0.0f;
    ddy = did_hit ? ddy / dn : 0.0f;
    ddz = did_hit ? ddz / dn : 0.0f;
    const float ex = (a.x + a.w) * 0.5f - sox;
    const float ey = (a.y + b.x) * 0.5f - soy;
    const float ez = (a.z + b.y) * 0.5f - soz;
    const float tlim = sqrtf(fmaxf(ex * ex + ey * ey + ez * ez, 0.0f)) + b.z;
    float t_s;
    int obj_s;
    if constexpr (GENERIC)
      warp_nearest_hit_g<MOTION>(T, live_rows, coop_min, lane, sox, soy, soz, ddx, ddy, ddz,
                                 omt, did_hit, tlim, t_s, obj_s, wc);
    else
      warp_nearest_hit<MOTION>(T, live_rows, coop_min, lane, sox, soy, soz, ddx, ddy, ddz,
                               omt, did_hit, tlim, t_s, obj_s, wc);
    if (obj_s >= 0 && __ldg(T.ftab + (size_t)obj_s * COLS + FT_EMIS) > 0.5f) lit += 1.0f;
    n_shadow += did_hit ? 1u : 0u;
  }
  return lit * inv_n_lights;
}

// Sum of a per-thread count over the warp, in lane 0 (the others get partial
// sums); every lane must call it together.
__device__ __forceinline__ unsigned long long warp_total(unsigned long long v) {
  for (int off = RT_WARP_LANES / 2; off > 0; off >>= 1) v += __shfl_down_sync(WARP_FULL, v, off);
  return v;
}

// Warp-cooperative rt::ri_probe<MOTION>: the surrounding refractive index at
// the point (qx, qy, qz) of every lane with `need`.  Where at least
// `coop_min` lanes need it, each runs ri_probe's own loop (the warp issues
// the table once for all of them).  Where fewer do, they are served one after
// another ROW-PARALLEL: the lane's point is broadcast, every lane of the warp
// tests rows lane, lane + W, ... of the probe table with ri_probe's
// expression (the row's group anchor, qq, lhs), a ballot per W rows names
// the rows that contain the point, and their RIs are added in ascending row
// order.  Either way acc, cnt and the mean are the sequential loop's bit for
// bit.  Probe groups are not culled by their boxes: the reference does not
// cull them, and a point that rounding puts inside near a box's face would
// answer differently.  A lane without `need` gets 1.
template <bool MOTION>
__device__ __forceinline__ float warp_ri_probe(const Tables& T, int coop_min, int lane,
                                               bool need, float qx, float qy, float qz,
                                               float omt) {
  constexpr int COLS = MOTION ? OT_COLS_MOTION : OT_COLS;
  float sur_ri = 1.0f;
  const unsigned m = __ballot_sync(WARP_FULL, need);
  if (m == 0u) return sur_ri;
  if (__popc(m) >= coop_min) return need ? ri_probe<MOTION>(T, qx, qy, qz, omt) : sur_ri;
  const int n_rows = T.n_pgroups * T.probe_gr;
  const float* rows = T.otab + (size_t)T.n_groups * T.gr * COLS;
  const float* pga = T.gaabb + (size_t)T.n_groups * GA_COLS;
  for (unsigned mm = m; mm != 0u; mm &= mm - 1u) {
    const int L = __ffs(mm) - 1;
    const float lx = __shfl_sync(WARP_FULL, qx, L);
    const float ly = __shfl_sync(WARP_FULL, qy, L);
    const float lz = __shfl_sync(WARP_FULL, qz, L);
    const float lomt = MOTION ? __shfl_sync(WARP_FULL, omt, L) : 0.0f;
    float acc = 0.0f, cnt = 0.0f;
    for (int r0 = 0; r0 < n_rows; r0 += RT_WARP_LANES) {
      const int r = r0 + lane;
      bool inside = false;
      float ri = 0.0f;
      if (r < n_rows) {
        const float* ga = pga + (r / T.probe_gr) * GA_COLS;
        const float ux = lx - __ldg(ga + 6);
        const float uy = ly - __ldg(ga + 7);
        const float uz = lz - __ldg(ga + 8);
        const float qq = ux * ux + uy * uy + uz * uz;
        const float* row = rows + (size_t)r * COLS;
        const float4 c = ld4(row);
        const float QC = c.x * ux + c.y * uy + c.z * uz;
        float lhs = qq + c.w - 2.0f * QC;
        if (MOTION) {
          const float4 k = ld4(row + 4);  // ri rinv2 k2 k3
          const float4 mv = ld4(row + 8);  // dpx dpy dpz 0
          const float QDP = mv.x * ux + mv.y * uy + mv.z * uz;
          lhs = lhs + lomt * (2.0f * QDP - k.z) + (lomt * lomt) * k.w;
        }
        inside = lhs <= 0.0f;
        ri = __ldg(row + 4);
      }
      // The same sum on every lane; only L keeps it.
      for (unsigned in = __ballot_sync(WARP_FULL, inside); in != 0u; in &= in - 1u) {
        acc += __shfl_sync(WARP_FULL, ri, __ffs(in) - 1);
        cnt += 1.0f;
      }
    }
    if (lane == L) sur_ri = acc > 1.0f ? acc / fmaxf(cnt, 1.0f) : 1.0f;
  }
  return sur_ri;
}

}  // namespace rt
