// Device functions shared by the kernels: group slab test, winner re-solve,
// surrounding-refractive-index probe, cone deviation and the In-Next-Week
// shading model, the fibonacci-hemisphere scatter and the Shirley-materials
// shading model, cube-sphere atlas texturing, and the generic primitives'
// row tests.  One thread owns one ray; everything here is scalar per-thread
// code (the warp-cooperative sweeps are in warp_sweep.cuh).
//
// Table layouts (row-major float32, built by kernels/sweep2.py::make_accel2):
//   otab  (n_pad + n_probe_rows, 8): cx cy cz k1 | ri rinv2 k2 k3
//         centres are relative to the row's GROUP ANCHOR, k1 = |c|^2 - r^2
//         (3e38 on dead rows, which kills both the quadratic and containment)
//         a moving accel's rows are 12 wide: ... | dpx dpy dpz 0, with
//         k2 = 2 c.dp and k3 = |dp|^2; the centre at a ray's time is
//         c - omt * dp, omt = 1 - time_ratio.  MOTION picks the row width and
//         the motion terms at compile time, so the static instantiations carry
//         neither.
//   ftab  (n_pad, 20): the winner's material row, columns FT_* below
//   gaabb (n_groups + n_pgroups, 12): lo xyz, hi xyz, anchor xyz, 0 0 0
// The main rows come first; the dielectric-only probe rows / probe groups
// trail them.
//
// No fast-math: reciprocal and rsqrt approximations flip grazing visibility.
// rsqrtf appears only where the reference arithmetic uses rsqrt.
#pragma once

#ifndef RT_HOST_REHEARSAL
#include <cuda_runtime.h>
#endif
#include <math.h>

#include <type_traits>

// The one launch form of every kernel here.  host_shim.h defines it as a plain
// loop, so the same sources compile as host C++ for a rehearsal on the CPU.
#ifndef RT_LAUNCH
#define RT_LAUNCH(kernel, blocks, threads, stream, ...) \
  kernel<<<(blocks), (threads), 0, (stream)>>>(__VA_ARGS__)
#endif
// ... with `smem` bytes of dynamic shared memory, which a kernel names with
// RT_DYNAMIC_SHARED.
#ifndef RT_LAUNCH_SMEM
#define RT_LAUNCH_SMEM(kernel, blocks, threads, smem, stream, ...) \
  kernel<<<(blocks), (threads), (smem), (stream)>>>(__VA_ARGS__)
#endif
#ifndef RT_DYNAMIC_SHARED
#define RT_DYNAMIC_SHARED(type, name) extern __shared__ __align__(16) type name[]
#endif

namespace rt {

constexpr float BIG_T = 3.0e38f;
constexpr int OT_COLS = 8;
constexpr int OT_COLS_MOTION = 12;
constexpr int FT_COLS = 20;
constexpr int GA_COLS = 12;

enum {
  FT_CX = 0, FT_CY, FT_CZ, FT_RINV, FT_DPX, FT_DPY, FT_DPZ,
  FT_CR, FT_CG, FT_CB, FT_MRI, FT_REFR, FT_REFL, FT_SRFR, FT_SRFL,
  FT_TEX, FT_EMIS, FT_OBJ, FT_R2
};

enum {
  V_T = 0, V_RI, V_NX, V_NY, V_NZ, V_CR, V_CG, V_CB, V_MRI,
  V_REFR, V_REFL, V_SRFR, V_SRFL, V_TEX, V_EMIS, V_OBJ, V_ROWS
};

struct Tables {
  const float* otab;
  const float* ftab;
  const float* gaabb;
  int n_groups;   // main sweep groups
  int gr;         // rows per main group
  int n_pgroups;  // trailing probe groups
  int probe_gr;   // rows per probe group
  int n_sgroups;  // generic tables: super-group rows after the probe groups
};

__device__ __forceinline__ float4 ld4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

struct Refined {
  float t, px, py, pz, nx, ny, nz;
};
// ... and with the unit-space hit position that cube-sphere texturing maps
// (the normal for spheres): the textured instantiations refine into this one,
// the untextured ones compile as if it did not exist.
struct RefinedTex : Refined {
  float lpx, lpy, lpz;
};
template <bool TEX>
using RefinedT = std::conditional_t<TEX, RefinedTex, Refined>;

// Re-solve the winner's quadratic directly in its own frame (rel = o - c) and
// derive the hit point and outward normal.  The group-anchored sweep t carries
// an absolute error larger than the 1e-4 surface offset children spawn from.
// `row` is the winner's ftab row; on a miss pass a zero row and hit = false.
template <bool MOTION>
__device__ __forceinline__ Refined winner_refine(
    const float* row, float ox, float oy, float oz, float dx, float dy,
    float dz, float omt, float t_best, bool hit) {
  float cex = row[FT_CX], cey = row[FT_CY], cez = row[FT_CZ];
  if (MOTION) {
    cex = cex - omt * row[FT_DPX];
    cey = cey - omt * row[FT_DPY];
    cez = cez - omt * row[FT_DPZ];
  }
  const float rex = ox - cex, rey = oy - cey, rez = oz - cez;
  const float hb = rex * dx + rey * dy + rez * dz;
  const float cq = rex * rex + rey * rey + rez * rez - row[FT_R2];
  const float disc = hb * hb - cq;
  const float sqw = sqrtf(fmaxf(disc, 0.0f));
  const float tn = -hb - sqw, tf = -hb + sqw;
  const float t_ref = tn > 0.0f ? tn : tf;
  if (hit && disc > 0.0f && t_ref > 0.0f) t_best = t_ref;
  const float t_safe = hit ? t_best : 1.0f;
  Refined R;
  R.t = t_best;
  R.px = ox + t_safe * dx;
  R.py = oy + t_safe * dy;
  R.pz = oz + t_safe * dz;
  const float rinv = row[FT_RINV];
  R.nx = (R.px - cex) * rinv;
  R.ny = (R.py - cey) * rinv;
  R.nz = (R.pz - cez) * rinv;
  return R;
}

// Surrounding refractive index at point q: mean RI of the containing
// dielectric spheres (sum > 1), else 1.  Loops the trailing probe sub-table;
// same anchored expansion as the sweep (r^2 cancels: inside <=> lhs <= 0).
template <bool MOTION>
__device__ __forceinline__ float ri_probe(const Tables& T, float qx, float qy,
                                          float qz, float omt) {
  constexpr int COLS = MOTION ? OT_COLS_MOTION : OT_COLS;
  float acc = 0.0f, cnt = 0.0f;
  const float* rows = T.otab + (size_t)T.n_groups * T.gr * COLS;
  for (int g = 0; g < T.n_pgroups; ++g) {
    const float* ga = T.gaabb + (T.n_groups + g) * GA_COLS;
    const float ux = qx - __ldg(ga + 6);
    const float uy = qy - __ldg(ga + 7);
    const float uz = qz - __ldg(ga + 8);
    const float qq = ux * ux + uy * uy + uz * uz;
    for (int r = 0; r < T.probe_gr; ++r) {
      const float* row = rows + (size_t)(g * T.probe_gr + r) * COLS;
      const float4 c = ld4(row);
      const float QC = c.x * ux + c.y * uy + c.z * uz;
      float lhs = qq + c.w - 2.0f * QC;
      if (MOTION) {
        const float4 k = ld4(row + 4);  // ri rinv2 k2 k3
        const float4 m = ld4(row + 8);  // dpx dpy dpz 0
        const float QDP = m.x * ux + m.y * uy + m.z * uz;
        lhs = lhs + omt * (2.0f * QDP - k.z) + (omt * omt) * k.w;
      }
      if (lhs <= 0.0f) {
        acc += __ldg(row + 4);
        cnt += 1.0f;
      }
    }
  }
  return acc > 1.0f ? acc / fmaxf(cnt, 1.0f) : 1.0f;
}

// ---------------------------------------------------------------------------
// Generic primitives: rotated ellipsoids and cuboids.
//
// Table layouts (row-major float32, built by kernels/sweep2g.py::make_accel2g):
//   otab  (n_pad + n_probe_rows, 32): px py pz type | dpx dpy dpz valid |
//         sx sy sz ri | R00..R22 (12..20, local -> world, row-major) |
//         M00..M22 (21..29, the fused frame diag(1/s) R^T) | 0 0
//         dead rows carry valid = 0 and scale 1
//   ftab  (n_pad, 32): the sphere ftab's columns 0..18, then R00..R22 (19..27),
//         sx sy sz (28..30), type (31)
//   gaabb (n_groups + n_pgroups + n_sgroups, 12): lo xyz, hi xyz, then on the
//         main rows the group's kind code (GK_*); super-group s is the union
//         of main groups [s*SG, (s+1)*SG)
// ---------------------------------------------------------------------------

constexpr int GO_COLS = 32;
constexpr int GFT_COLS = 32;
constexpr int SG = 8;  // main groups per super-group
constexpr float ELLIPSOID = 1.0f;
constexpr float CUBOID = 2.0f;

enum {
  GO_PX = 0, GO_PY, GO_PZ, GO_TYPE, GO_DPX, GO_DPY, GO_DPZ, GO_VALID,
  GO_SX, GO_SY, GO_SZ, GO_RI, GO_R00 = 12, GO_M00 = 21
};
enum { GFT_R00 = 19, GFT_SX = 28, GFT_SY, GFT_SZ, GFT_TYPE };
// Per-group census of the accel build (gaabb column 6).
enum { GK_MIXED = 0, GK_ELL, GK_CUB, GK_SPHERE, GK_AXIS, GK_YROT };

// Ellipsoid t in the divide-by-scale form of the dense intersector: local ray
// over scale, unit-sphere quadratic, near root unless behind the origin.
__device__ __forceinline__ float ell_t_div(float lox, float loy, float loz,
                                           float ldx, float ldy, float ldz,
                                           float sx, float sy, float sz) {
  const float ex = lox / sx, ey = loy / sy, ez = loz / sz;
  const float fx = ldx / sx, fy = ldy / sy, fz = ldz / sz;
  const float a = fx * fx + fy * fy + fz * fz;
  const float half_b = ex * fx + ey * fy + ez * fz;
  const float c = ex * ex + ey * ey + ez * ez - 1.0f;
  const float disc = half_b * half_b - a * c;
  if (!(disc > 0.0f && a > 1e-30f)) return BIG_T;
  const float sq = sqrtf(disc);
  const float t0 = (-half_b - sq) / a;
  const float t1 = (-half_b + sq) / a;
  const float t_e = (t0 > t1 || t0 < 0.0f) ? t1 : t0;
  return t_e > 0.0f ? t_e : BIG_T;
}

// The slab interval of three axes -> entry t (exit t from inside), or BIG_T.
__device__ __forceinline__ float slab_t(float u1, float w1, float u2, float w2,
                                        float u3, float w3) {
  const float tmin = fmaxf(fmaxf(fminf(u1, w1), fminf(u2, w2)), fminf(u3, w3));
  const float tmax = fminf(fminf(fmaxf(u1, w1), fmaxf(u2, w2)), fmaxf(u3, w3));
  if (!(tmax > tmin)) return BIG_T;
  const float t_c = tmin > 0.0f ? tmin : tmax;
  return t_c > 0.0f ? t_c : BIG_T;
}

__device__ __forceinline__ float safe_inv(float d) {
  const float eps = 1e-12f;
  return 1.0f / (fabsf(d) < eps ? (d >= 0.0f ? eps : -eps) : d);
}

// Cuboid t with the safe inverse (a zero direction component becomes +-1e-12).
__device__ __forceinline__ float cub_t_div(float lox, float loy, float loz,
                                           float ldx, float ldy, float ldz,
                                           float sx, float sy, float sz) {
  const float i1 = safe_inv(ldx), i2 = safe_inv(ldy), i3 = safe_inv(ldz);
  return slab_t((-0.5f * sx - lox) * i1, (0.5f * sx - lox) * i1,
                (-0.5f * sy - loy) * i2, (0.5f * sy - loy) * i2,
                (-0.5f * sz - loz) * i3, (0.5f * sz - loz) * i3);
}

// Cuboid t with the bare reciprocal: 1/0 = +-inf gives the exact slab of a
// parallel ray.  An origin exactly on a slab plane of a parallel ray gives
// 0 * inf = NaN, which the plain version's minimum/maximum carry into a miss;
// fminf/fmaxf would drop it, so it is tested for here.
__device__ __forceinline__ float cub_t_inf(float lox, float loy, float loz,
                                           float ldx, float ldy, float ldz,
                                           float sx, float sy, float sz) {
  const float i1 = 1.0f / ldx, i2 = 1.0f / ldy, i3 = 1.0f / ldz;
  const float u1 = (-0.5f * sx - lox) * i1, w1 = (0.5f * sx - lox) * i1;
  const float u2 = (-0.5f * sy - loy) * i2, w2 = (0.5f * sy - loy) * i2;
  const float u3 = (-0.5f * sz - loz) * i3, w3 = (0.5f * sz - loz) * i3;
  if (u1 != u1 || w1 != w1 || u2 != u2 || w2 != w2 || u3 != u3 || w3 != w3)
    return BIG_T;
  return slab_t(u1, w1, u2, w2, u3, w3);
}

// Group (or super-group) slab test against the current best t.
__device__ __forceinline__ bool slab_hit(const float* ga, float ox, float oy,
                                         float oz, float ix, float iy,
                                         float iz, float t_best) {
  const float4 a0 = ld4(ga);      // lo.x lo.y lo.z hi.x
  const float4 a1 = ld4(ga + 4);  // hi.y hi.z kind 0
  const float u1 = (a0.x - ox) * ix, w1 = (a0.w - ox) * ix;
  const float u2 = (a0.y - oy) * iy, w2 = (a1.x - oy) * iy;
  const float u3 = (a0.z - oz) * iz, w3 = (a1.y - oz) * iz;
  const float tmin = fmaxf(fmaxf(fminf(u1, w1), fminf(u2, w2)), fminf(u3, w3));
  const float tmax = fminf(fminf(fmaxf(u1, w1), fmaxf(u2, w2)), fmaxf(u3, w3));
  return (tmax > tmin) && (tmax > 0.0f) && (tmin < t_best);
}

struct RefinedG {
  float t, px, py, pz, nx, ny, nz, lpx, lpy, lpz;
};

// Re-solve the winner from its ftab row in the dense intersector's form
// (rotate by R^T, divide by scale, both primitive tests selected by type) and
// derive the hit point, the world normal and the unit-space hit position.
template <bool MOTION>
__device__ __forceinline__ RefinedG winner_refine_g(
    const float* row, float ox, float oy, float oz, float dx, float dy,
    float dz, float omt, float t_best, bool hit) {
  float cex = row[FT_CX], cey = row[FT_CY], cez = row[FT_CZ];
  if (MOTION) {
    cex = cex - omt * row[FT_DPX];
    cey = cey - omt * row[FT_DPY];
    cez = cez - omt * row[FT_DPZ];
  }
  const float rex = ox - cex, rey = oy - cey, rez = oz - cez;
  const float* r = row + GFT_R00;
  const float lox = r[0] * rex + r[3] * rey + r[6] * rez;
  const float loy = r[1] * rex + r[4] * rey + r[7] * rez;
  const float loz = r[2] * rex + r[5] * rey + r[8] * rez;
  const float ldx = r[0] * dx + r[3] * dy + r[6] * dz;
  const float ldy = r[1] * dx + r[4] * dy + r[7] * dz;
  const float ldz = r[2] * dx + r[5] * dy + r[8] * dz;
  const float sx = row[GFT_SX], sy = row[GFT_SY], sz = row[GFT_SZ];
  const bool is_ell = row[GFT_TYPE] == ELLIPSOID;
  RefinedG R;
  float t_safe = 1.0f;
  if (hit) {
    const float t_ref = is_ell
                            ? ell_t_div(lox, loy, loz, ldx, ldy, ldz, sx, sy, sz)
                            : cub_t_div(lox, loy, loz, ldx, ldy, ldz, sx, sy, sz);
    if (t_ref < BIG_T) t_best = t_ref;
    t_safe = t_best;
  }
  R.t = t_best;
  const float plx = lox + t_safe * ldx;
  const float ply = loy + t_safe * ldy;
  const float plz = loz + t_safe * ldz;
  float nlx, nly, nlz;
  if (is_ell) {
    // gradient of |p / s|^2, normalised by division and sqrt
    const float gx = plx / (sx * sx), gy = ply / (sy * sy), gz = plz / (sz * sz);
    const float gn = sqrtf(fmaxf(gx * gx + gy * gy + gz * gz, 1e-38f));
    nlx = gx / gn;
    nly = gy / gn;
    nlz = gz / gn;
  } else {
    // axis of the nearest face, scanned +x -x +y -y +z -z, first strict minimum
    float best = fabsf(plx - 0.5f * sx);
    nlx = 1.0f, nly = 0.0f, nlz = 0.0f;
    float dist = fabsf(plx + 0.5f * sx);
    if (dist < best) { best = dist; nlx = -1.0f; nly = 0.0f; nlz = 0.0f; }
    dist = fabsf(ply - 0.5f * sy);
    if (dist < best) { best = dist; nlx = 0.0f; nly = 1.0f; nlz = 0.0f; }
    dist = fabsf(ply + 0.5f * sy);
    if (dist < best) { best = dist; nlx = 0.0f; nly = -1.0f; nlz = 0.0f; }
    dist = fabsf(plz - 0.5f * sz);
    if (dist < best) { best = dist; nlx = 0.0f; nly = 0.0f; nlz = 1.0f; }
    dist = fabsf(plz + 0.5f * sz);
    if (dist < best) { best = dist; nlx = 0.0f; nly = 0.0f; nlz = -1.0f; }
  }
  // world normal = R n_local
  R.nx = r[0] * nlx + r[1] * nly + r[2] * nlz;
  R.ny = r[3] * nlx + r[4] * nly + r[5] * nlz;
  R.nz = r[6] * nlx + r[7] * nly + r[8] * nlz;
  R.px = ox + t_safe * dx;
  R.py = oy + t_safe * dy;
  R.pz = oz + t_safe * dz;
  R.lpx = plx / (sx > 0.0f ? sx : 1.0f);
  R.lpy = ply / (sy > 0.0f ? sy : 1.0f);
  R.lpz = plz / (sz > 0.0f ? sz : 1.0f);
  return R;
}

// Surrounding refractive index at point q over the trailing probe rows of the
// generic otab: point-in-primitive in the fused unit space e = M (q - c).
template <bool MOTION>
__device__ __forceinline__ float ri_probe_g(const Tables& T, float qx, float qy,
                                            float qz, float omt) {
  float acc = 0.0f, cnt = 0.0f;
  const float* rows = T.otab + (size_t)T.n_groups * T.gr * GO_COLS;
  const int n_rows = T.n_pgroups * T.probe_gr;
  for (int i = 0; i < n_rows; ++i) {
    const float* row = rows + (size_t)i * GO_COLS;
    const float4 p = ld4(row);  // px py pz type
    if (!(__ldg(row + GO_VALID) > 0.0f)) continue;
    float rx = qx - p.x, ry = qy - p.y, rz = qz - p.z;
    if (MOTION) {
      rx = rx + omt * __ldg(row + GO_DPX);
      ry = ry + omt * __ldg(row + GO_DPY);
      rz = rz + omt * __ldg(row + GO_DPZ);
    }
    const float* m = row + GO_M00;
    const float ex = __ldg(m) * rx + __ldg(m + 1) * ry + __ldg(m + 2) * rz;
    const float ey = __ldg(m + 3) * rx + __ldg(m + 4) * ry + __ldg(m + 5) * rz;
    const float ez = __ldg(m + 6) * rx + __ldg(m + 7) * ry + __ldg(m + 8) * rz;
    bool inside;
    if (p.w == ELLIPSOID)
      inside = ex * ex + ey * ey + ez * ez <= 1.0f;
    else
      inside = p.w == CUBOID && fabsf(ex) <= 0.5f && fabsf(ey) <= 0.5f &&
               fabsf(ez) <= 0.5f;
    if (inside) {
      acc += __ldg(row + GO_RI);
      cnt += 1.0f;
    }
  }
  return acc > 1.0f ? acc / fmaxf(cnt, 1.0f) : 1.0f;
}

// Static sunflower constants of a frame (functions of spp, computed on the
// host so both sides round alike).
struct Sunflower {
  float n;          // spp
  float n_minus_b;  // spp - round(2 sqrt(spp))
  float denom;      // spp - (b + 1) / 2, or 1 when that is <= 0
};

// Deterministic scatter of unit direction d within a cone of tan_theta: a
// sunflower offset in the plane of cross(d, up) and cross(that, d), scaled by
// the reference's fixed 0.1.  (cth, sth) = cos/sin(GOLDEN_ANGLE * sidx),
// computed once per primary.
__device__ __forceinline__ void deviate(float& dx, float& dy, float& dz,
                                        float sidx, const Sunflower& S,
                                        float tan_theta, float cth,
                                        float sth) {
  float r = sidx > S.n_minus_b
                ? tan_theta
                : tan_theta * sqrtf(fmaxf(sidx - 0.5f, 0.0f) / S.denom);
  if (sidx == 0.0f) r = 0.0f;
  const float offx = r * cth, offy = r * sth;
  const float rx = -dz, ry = 0.0f, rz = dx;  // cross(d, up)
  const float ux = ry * dz - rz * dy;        // cross(right, d)
  const float uy = rz * dx - rx * dz;
  const float uz = rx * dy - ry * dx;
  const float vx = dx + 0.1f * (offx * rx + offy * ux);
  const float vy = dy + 0.1f * (offx * ry + offy * uy);
  const float vz = dz + 0.1f * (offx * rz + offy * uz);
  const float inv = rsqrtf(fmaxf(vx * vx + vy * vy + vz * vz, 1e-38f));
  dx = vx * inv;
  dy = vy * inv;
  dz = vz * inv;
}

struct Child {
  float ox, oy, oz, dx, dy, dz, contrib;
};

struct Shade {
  float add_r, add_g, add_b, hit_t;
  Child refr, refl;
  bool spawn_refr, spawn_refl;
  bool probed;  // the surrounding RI was probed (measurement only)
};

struct ShadeStatics {
  Sunflower sun;
  float max_bounces;  // as float: compared with the float bounce count
  int has_dielectrics;
};

// The winner's ftab row, in registers.
template <bool GENERIC>
__device__ __forceinline__ void load_row(const Tables& T, int obj,
                                         float (&rowv)[GENERIC ? GFT_COLS : FT_COLS]) {
  constexpr int COLS = GENERIC ? GFT_COLS : FT_COLS;
  const float* row = T.ftab + (size_t)obj * COLS;
#pragma unroll
  for (int i = 0; i < COLS / 4; ++i) {
    const float4 v = ld4(row + 4 * i);
    rowv[4 * i] = v.x;
    rowv[4 * i + 1] = v.y;
    rowv[4 * i + 2] = v.z;
    rowv[4 * i + 3] = v.w;
  }
}

// The hit node's refine from its winner's row: sphere (winner_refine) or
// rotated ellipsoid / cuboid (winner_refine_g); with TEX also the unit-space
// hit position.
template <bool GENERIC, bool MOTION, bool TEX = false>
__device__ __forceinline__ RefinedT<TEX> refine_row(const float* rowv, float ox, float oy,
                                                    float oz, float dx, float dy, float dz,
                                                    float omt, float t_sweep) {
  if constexpr (GENERIC) {
    const RefinedG G =
        winner_refine_g<MOTION>(rowv, ox, oy, oz, dx, dy, dz, omt, t_sweep, true);
    RefinedT<TEX> R;
    R.t = G.t;
    R.px = G.px;
    R.py = G.py;
    R.pz = G.pz;
    R.nx = G.nx;
    R.ny = G.ny;
    R.nz = G.nz;
    if constexpr (TEX) {
      R.lpx = G.lpx;
      R.lpy = G.lpy;
      R.lpz = G.lpz;
    }
    return R;
  } else if constexpr (TEX) {
    RefinedTex R;
    static_cast<Refined&>(R) =
        winner_refine<MOTION>(rowv, ox, oy, oz, dx, dy, dz, omt, t_sweep, true);
    R.lpx = R.nx;
    R.lpy = R.ny;
    R.lpz = R.nz;
    return R;
  } else {
    return winner_refine<MOTION>(rowv, ox, oy, oz, dx, dy, dz, omt, t_sweep, true);
  }
}

// load_row then refine_row: what a caller needs before shading, e.g. to aim
// shadow rays from the hit point.
template <bool GENERIC, bool MOTION, bool TEX = false>
__device__ __forceinline__ RefinedT<TEX> refine_hit(const Tables& T, int obj, float t_sweep,
                                                    float ox, float oy, float oz, float dx,
                                                    float dy, float dz, float omt) {
  float rowv[GENERIC ? GFT_COLS : FT_COLS];
  load_row<GENERIC>(T, obj, rowv);
  return refine_row<GENERIC, MOTION, TEX>(rowv, ox, oy, oz, dx, dy, dz, omt, t_sweep);
}

// The scene's atlas stack as kernels/texture.py::pack_atlas lays it out:
// T atlases of H x W6 texels, each texel 16 bytes (r, g, b, 0), row-major.
struct Atlas {
  const float4* texels;
  int T, H, W6;
};

// The albedo (cr, cg, cb) of a winner with texture index ti_f (its FT_TEX)
// times scene/textures.py::sample_atlas at cube_sphere_uv of the unit-space
// hit position (lx, ly, lz), where ti_f is above 0; unchanged elsewhere.  The
// same arithmetic as the plain version, rounding for rounding: the face
// turns on strict comparisons, so the projection divides by the dominant
// component (no reciprocal), and the bilinear weights stay f32 (the
// hardware's linear filter would round them to 8 fractional bits).  The four
// corners are direct 16-byte loads through the read-only path; the atlas of a
// scene is a few MB and stays in L2.
__device__ __forceinline__ void texture_albedo(const Atlas& A, float ti_f, float lx, float ly,
                                               float lz, float& cr, float& cg, float& cb) {
  const int ti = (int)(ti_f + 0.5f);
  if (ti <= 0) return;
  // Face: start with +-x, then y then z win strict-greater comparisons.  The
  // face direction's dot with the position is its dominant component, signed.
  int face = lx > 0.0f ? 1 : 3;
  float denom = lx > 0.0f ? lx : -lx;
  const float ay = fabsf(ly);
  float dom = fabsf(lx);
  if (ay > dom) {
    face = ly > 0.0f ? 0 : 5;
    denom = ly > 0.0f ? ly : -ly;
  }
  dom = fmaxf(dom, ay);
  if (fabsf(lz) > dom) {
    face = lz > 0.0f ? 2 : 4;
    denom = lz > 0.0f ? lz : -lz;
  }
  const float dsafe = fabsf(denom) > 1e-12f ? denom : 1.0f;
  const float px = (lx / dsafe) * 0.5f + 0.5f;
  const float py = (ly / dsafe) * 0.5f + 0.5f;
  const float pz = (lz / dsafe) * 0.5f + 0.5f;
  // Per-face texcoord table: u = [px, 1-py, px, pz, 1-py, pz],
  // v = [1-pz, 1-pz, py, py, 1-px, 1-px].
  const float u = face == 0 || face == 2 ? px : face == 3 || face == 5 ? pz : 1.0f - py;
  const float v = face <= 1 ? 1.0f - pz : face <= 3 ? py : 1.0f - px;

  const float au = ((float)face + fminf(fmaxf(u, 0.0f), 1.0f)) / 6.0f;
  const float av = fminf(fmaxf(v, 0.0f), 1.0f);
  const float fx = au * (float)A.W6 - 0.5f;
  const float fy = av * (float)A.H - 0.5f;
  const int xf = (int)floorf(fx), yf = (int)floorf(fy);
  const int x0 = xf < 0 ? 0 : xf < A.W6 ? xf : A.W6 - 1;
  const int y0 = yf < 0 ? 0 : yf < A.H ? yf : A.H - 1;
  const int x1 = x0 + 1 < A.W6 ? x0 + 1 : A.W6 - 1;
  const int y1 = y0 + 1 < A.H ? y0 + 1 : A.H - 1;
  const float wx = fminf(fmaxf(fx - (float)x0, 0.0f), 1.0f);
  const float wy = fminf(fmaxf(fy - (float)y0, 0.0f), 1.0f);
  const float4* at = A.texels + (size_t)(ti < A.T ? ti : A.T - 1) * A.H * A.W6;
  const float4 c00 = __ldg(at + (size_t)y0 * A.W6 + x0);
  const float4 c01 = __ldg(at + (size_t)y0 * A.W6 + x1);
  const float4 c10 = __ldg(at + (size_t)y1 * A.W6 + x0);
  const float4 c11 = __ldg(at + (size_t)y1 * A.W6 + x1);
  const float owx = 1.0f - wx, owy = 1.0f - wy;
  cr = cr * ((c00.x * owx + c01.x * wx) * owy + (c10.x * owx + c11.x * wx) * wy);
  cg = cg * ((c00.y * owx + c01.y * wx) * owy + (c10.y * owx + c11.y * wx) * wy);
  cb = cb * ((c00.z * owx + c01.z * wx) * owy + (c10.z * owx + c11.z * wx) * wy);
}

// In-Next-Week shading of one HIT node: refine the winner, probe
// the surrounding RI where a refraction consumes it, add contrib_post *
// albedo, and build the refract / reflect children.  GENERIC picks the
// tables' layout and the refine and probe of rotated ellipsoids and cuboids at
// compile time, MOTION the moving centres of both; everything after them is
// shared.  With GIVEN_RI the caller has refined the winner (*given) and probed
// the surrounding RI where this function would (given_ri): a warp probes
// together, which this per-lane function cannot.  With GIVEN_REFINE the
// caller has refined the winner (*given) and this function probes.  Under
// emissive lights the caller passes the contribution already scaled by the
// share of lights the hit sees.  With TEX the albedo of a textured winner is
// textured from `atlas` (texture_albedo).
template <bool GENERIC, bool MOTION, bool GIVEN_RI = false, bool GIVEN_REFINE = false,
          bool TEX = false>
__device__ __forceinline__ Shade shade_hit(
    const Tables& T, const ShadeStatics& S, int obj, float t_sweep, float ox,
    float oy, float oz, float dx, float dy, float dz, float omt, float contrib,
    float bounced, float sidx, float cth, float sth, const RefinedT<TEX>* given = nullptr,
    float given_ri = 1.0f, Atlas atlas = {}) {
  constexpr int COLS = GENERIC ? GFT_COLS : FT_COLS;
  float rowv[COLS];
  load_row<GENERIC>(T, obj, rowv);
  RefinedT<TEX> R;
  if constexpr (GIVEN_RI || GIVEN_REFINE)
    R = *given;
  else
    R = refine_row<GENERIC, MOTION, TEX>(rowv, ox, oy, oz, dx, dy, dz, omt, t_sweep);
  const float nx = R.nx, ny = R.ny, nz = R.nz;
  const float mat_ri = rowv[FT_MRI], refrv = rowv[FT_REFR];
  const float reflv = rowv[FT_REFL], srfr = rowv[FT_SRFR];
  const float srfl = rowv[FT_SRFL];

  const float ndotd = nx * dx + ny * dy + nz * dz;
  const bool inner = ndotd > 0.0f;

  // Only dielectric winners and interior hits consume the surrounding RI.
  float sur_ri = 1.0f;
  const bool probe =
      S.has_dielectrics && T.n_pgroups > 0 && (inner || refrv > 0.002f);
  if constexpr (GIVEN_RI) {
    sur_ri = given_ri;
  } else if (probe) {
    const float qx = R.px + 1e-3f * nx, qy = R.py + 1e-3f * ny;
    const float qz = R.pz + 1e-3f * nz;
    if constexpr (GENERIC)
      sur_ri = ri_probe_g<MOTION>(T, qx, qy, qz, omt);
    else
      sur_ri = ri_probe<MOTION>(T, qx, qy, qz, omt);
  }

  const float bounced1 = bounced + 1.0f;
  const bool can_spawn = ((reflv > 0.002f) || (refrv > 0.002f)) &&
                         (contrib > 0.01f) && (bounced1 < S.max_bounces);

  // Mirror direction (also the inner total-internal-reflection child).
  const float mrx = dx - 2.0f * ndotd * nx;
  const float mry = dy - 2.0f * ndotd * ny;
  const float mrz = dz - 2.0f * ndotd * nz;

  Shade out;
  out.probed = probe;
  float cdx, cdy, cdz, clx, cly, clz;
  if (inner) {
    // Flip the normal, eta = mat/sur; total internal reflection mirrors.
    const float eta_i = mat_ri / fmaxf(sur_ri, 1e-6f);
    const float cos_ii = ndotd;
    const float k_i = 1.0f - eta_i * eta_i * (1.0f - cos_ii * cos_ii);
    const float sqk_i = sqrtf(fmaxf(k_i, 0.0f));
    const float f = eta_i * cos_ii - sqk_i;
    cdx = eta_i * dx - f * nx;
    cdy = eta_i * dy - f * ny;
    cdz = eta_i * dz - f * nz;
    const bool tir = k_i <= 0.0f;
    out.spawn_refr = can_spawn && !tir;
    out.spawn_refl = can_spawn && tir;
    clx = mrx;
    cly = mry;
    clz = mrz;
  } else {
    // Outer reflection: mirror + cone deviation.
    const float rinv = rsqrtf(fmaxf(mrx * mrx + mry * mry + mrz * mrz, 1e-38f));
    clx = mrx * rinv;
    cly = mry * rinv;
    clz = mrz * rinv;
    if (srfl > 0.001f) deviate(clx, cly, clz, sidx, S.sun, srfl, cth, sth);
    // Outer refraction: eta = sur/mat.
    const float eta_o = sur_ri / fmaxf(mat_ri, 1e-6f);
    const float cos_i = -ndotd;
    const float k_o = 1.0f - eta_o * eta_o * (1.0f - cos_i * cos_i);
    const float sqk_o = sqrtf(fmaxf(k_o, 0.0f));
    const float f = eta_o * cos_i - sqk_o;
    cdx = eta_o * dx + f * nx;
    cdy = eta_o * dy + f * ny;
    cdz = eta_o * dz + f * nz;
    const float finv = rsqrtf(fmaxf(cdx * cdx + cdy * cdy + cdz * cdz, 1e-38f));
    cdx *= finv;
    cdy *= finv;
    cdz *= finv;
    if (srfr > 0.001f && k_o > 0.0f)
      deviate(cdx, cdy, cdz, sidx, S.sun, srfr, cth, sth);
    out.spawn_refr = can_spawn && (k_o > 0.0f) && (refrv > 0.002f);
    out.spawn_refl = can_spawn && (reflv > 0.002f);
  }

  // Outward-facing normal; children start 1e-4 either side of the surface.
  const float nox = inner ? -nx : nx;
  const float noy = inner ? -ny : ny;
  const float noz = inner ? -nz : nz;

  // Children inherit the undamped contribution; the node's own absorption
  // term is damped by half of what was forwarded.
  const float fwd = (out.spawn_refr ? refrv : 0.0f) + (out.spawn_refl ? reflv : 0.0f);
  const float contrib_post = contrib * (1.0f - 0.5f * fwd);
  float cr = rowv[FT_CR], cg = rowv[FT_CG], cb = rowv[FT_CB];
  if constexpr (TEX) texture_albedo(atlas, rowv[FT_TEX], R.lpx, R.lpy, R.lpz, cr, cg, cb);
  out.add_r = contrib_post * cr;
  out.add_g = contrib_post * cg;
  out.add_b = contrib_post * cb;
  out.hit_t = R.t;

  out.refr.ox = R.px - 1e-4f * nox;
  out.refr.oy = R.py - 1e-4f * noy;
  out.refr.oz = R.pz - 1e-4f * noz;
  out.refr.dx = cdx;
  out.refr.dy = cdy;
  out.refr.dz = cdz;
  out.refr.contrib = contrib * refrv;
  out.refl.ox = R.px + 1e-4f * nox;
  out.refl.oy = R.py + 1e-4f * noy;
  out.refl.oz = R.pz + 1e-4f * noz;
  out.refl.dx = clx;
  out.refl.dy = cly;
  out.refl.dz = clz;
  out.refl.contrib = contrib * reflv;
  return out;
}

// v / sqrt(max(|v|^2, eps)), the sum in x, y, z order (the reference's
// normalize: a division, not a reciprocal square root).
__device__ __forceinline__ void norm3(float& x, float& y, float& z, float eps) {
  const float n = sqrtf(fmaxf(x * x + y * y + z * z, eps));
  x = x / n;
  y = y / n;
  z = z / n;
}

// Deterministic scatter of the unit direction f on a fibonacci sphere of
// radius s centred at its tip (sampling.fibonacci_hemisphere): the sample's
// point at height y = 1 - sidx / y_den (y_den = max(spp - 1, 1)) and angle
// GOLDEN_ANGLE * sidx, whose (cth, sth) raygen computed once per primary.
__device__ __forceinline__ void fibonacci_hemisphere(float& fx, float& fy, float& fz,
                                                     float sidx, float y_den, float s,
                                                     float cth, float sth) {
  float y = 1.0f - sidx / y_den;
  const float radius = sqrtf(fmaxf(1.0f - y * y, 0.0f));
  float x = cth * radius, z = sth * radius;
  x = x * s;
  y = y * s;
  z = z * s;
  // z_cap = normalize(cross(up, f)) with up = (0, 1, 0); x_cap = cross(f, z_cap)
  float zcx = fz, zcy = 0.0f, zcz = -fx;
  norm3(zcx, zcy, zcz, 1e-20f);
  float xcx = fy * zcz - fz * zcy, xcy = fz * zcx - fx * zcz, xcz = fx * zcy - fy * zcx;
  norm3(xcx, xcy, xcz, 1e-20f);
  float px = fx + x * xcx + y * fx + z * zcx;
  float py = fy + x * xcy + y * fy + z * zcy;
  float pz = fz + x * xcz + y * fz + z * zcz;
  norm3(px, py, pz, 1e-38f);
  fx = px;
  fy = py;
  fz = pz;
}

struct MatShade {
  float add_r, add_g, add_b, hit_t;
  Child refr, refl;
  float refr_medium, refr_parent;  // the reflection keeps the node's own media
  bool spawn_refr, spawn_refl;
};

// Shirley-materials shading of one HIT node (kernels/mega.py::
// _shade_materials_k): the node travels in a medium of RI `medium` whose
// parent's RI is `parent`; an inner hit refracts toward the parent, an outer
// one toward the material.  Schlick shifts contribution from refraction to
// reflection on outer hits; total internal reflection turns the refraction
// into a contribution-1 reflection along the mirror direction.  The
// reflection is lifted off grazing angles and scattered on the fibonacci
// hemisphere, the refraction scattered likewise.  Local term contrib^2 *
// albedo; no surrounding-RI probe, no contribution cutoff (a child spawns
// wherever its contribution is above 0), no forward damping.  TEX as in
// shade_hit.
template <bool GENERIC, bool MOTION, bool TEX = false>
__device__ __forceinline__ MatShade shade_materials(
    const Tables& T, const ShadeStatics& S, int obj, float t_sweep, float ox, float oy,
    float oz, float dx, float dy, float dz, float omt, float contrib, float bounced,
    float medium, float parent, float sidx, float cth, float sth,
    Atlas atlas = {}) {
  constexpr int COLS = GENERIC ? GFT_COLS : FT_COLS;
  float rowv[COLS];
  load_row<GENERIC>(T, obj, rowv);
  const RefinedT<TEX> R =
      refine_row<GENERIC, MOTION, TEX>(rowv, ox, oy, oz, dx, dy, dz, omt, t_sweep);
  const float nx = R.nx, ny = R.ny, nz = R.nz;
  const float refrv = rowv[FT_REFR], reflv = rowv[FT_REFL];
  const float srfr = rowv[FT_SRFR], srfl = rowv[FT_SRFL];

  const float cos_t = nx * dx + ny * dy + nz * dz;
  const bool inner = cos_t > 0.0f;
  const float sin_t = sqrtf(fmaxf(1.0f - cos_t * cos_t, 0.0f));
  const float target = inner ? parent : rowv[FT_MRI];
  const float ratio = medium / fmaxf(target, 1e-6f);
  const float rs = ratio * sin_t;
  const bool tir = rs > 1.0f;

  // Schlick shift from refraction to reflection on outer hits.
  float r0 = (1.0f - ratio) / (1.0f + ratio);
  r0 = r0 * r0;
  const float om = 1.0f - fminf(fmaxf(-cos_t, 0.0f), 1.0f);
  const float schl = r0 + (1.0f - r0) * om * om * om * om * om;
  const float shift = inner ? 0.0f : refrv * schl;
  const float refr_c = refrv - shift;
  const float refl_c = tir ? 1.0f : (inner ? 0.0f : reflv + shift);

  // Reflection: the mirror direction, lifted to a minimum elevation set by the
  // scatter on outer hits, then scattered (the mirror itself on inner TIR).
  const float inx = inner ? -nx : nx, iny = inner ? -ny : ny, inz = inner ? -nz : nz;
  const float mrx = dx - 2.0f * cos_t * nx;
  const float mry = dy - 2.0f * cos_t * ny;
  const float mrz = dz - 2.0f * cos_t * nz;
  float ax = iny * dz - inz * dy, ay = inz * dx - inx * dz, az = inx * dy - iny * dx;
  norm3(ax, ay, az, 1e-20f);
  float bx = ay * inz - az * iny, by = az * inx - ax * inz, bz = ax * iny - ay * inx;
  norm3(bx, by, bz, 1e-20f);
  const float s = inner ? srfr : srfl;
  const float inv = 1.0f / sqrtf(1.0f + s * s);
  const float lx = s * inv * inx + inv * bx;
  const float ly = s * inv * iny + inv * by;
  const float lz = s * inv * inz + inv * bz;
  const bool lift = (mrx * inx + mry * iny + mrz * inz) <= (lx * inx + ly * iny + lz * inz);
  const bool use_lift = lift && !inner;
  const float rbx = use_lift ? lx : mrx, rby = use_lift ? ly : mry, rbz = use_lift ? lz : mrz;
  const float y_den = fmaxf(S.sun.n - 1.0f, 1.0f);
  float rdx = rbx, rdy = rby, rdz = rbz;
  fibonacci_hemisphere(rdx, rdy, rdz, sidx, y_den, srfl, cth, sth);
  if (tir && inner) {
    rdx = rbx;
    rdy = rby;
    rdz = rbz;
  }
  const float bounced1 = bounced + 1.0f;
  const bool depth_ok = bounced1 < S.max_bounces;

  // Refraction (n2 = -n_in, the side the refraction leaves by).
  const float n2x = -inx, n2y = -iny, n2z = -inz;
  const float xcx = dx - n2x * cos_t, xcy = dy - n2y * cos_t, xcz = dz - n2z * cos_t;
  const float sq = sqrtf(fmaxf(1.0f - rs * rs, 0.0f));
  float fdx = rs * n2x + sq * xcx, fdy = rs * n2y + sq * xcy, fdz = rs * n2z + sq * xcz;
  norm3(fdx, fdy, fdz, 1e-20f);
  fibonacci_hemisphere(fdx, fdy, fdz, sidx, y_den, srfr, cth, sth);

  MatShade out;
  out.spawn_refl = depth_ok && (!inner || tir) && (contrib * refl_c > 0.0f);
  out.spawn_refr = depth_ok && !tir && (contrib * refr_c > 0.0f);
  const float hc = contrib * contrib;
  float cr = rowv[FT_CR], cg = rowv[FT_CG], cb = rowv[FT_CB];
  if constexpr (TEX) texture_albedo(atlas, rowv[FT_TEX], R.lpx, R.lpy, R.lpz, cr, cg, cb);
  out.add_r = hc * cr;
  out.add_g = hc * cg;
  out.add_b = hc * cb;
  out.hit_t = R.t;
  out.refr.ox = R.px + 1e-4f * n2x;
  out.refr.oy = R.py + 1e-4f * n2y;
  out.refr.oz = R.pz + 1e-4f * n2z;
  out.refr.dx = fdx;
  out.refr.dy = fdy;
  out.refr.dz = fdz;
  out.refr.contrib = contrib * refr_c;
  out.refr_medium = target;
  out.refr_parent = inner ? 1.0f : medium;  // beyond the tracked depth: air
  out.refl.ox = R.px - 1e-4f * n2x;
  out.refl.oy = R.py - 1e-4f * n2y;
  out.refl.oz = R.pz - 1e-4f * n2z;
  out.refl.dx = rdx;
  out.refl.dy = rdy;
  out.refl.dz = rdz;
  out.refl.contrib = contrib * refl_c;
  return out;
}

}  // namespace rt
