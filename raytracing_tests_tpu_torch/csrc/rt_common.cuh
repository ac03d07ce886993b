// Device functions shared by the sphere sweep (sweep2.cu) and the persistent
// path tracer (uber.cu): group slab test, anchored sphere quadratic, winner
// re-solve, surrounding-refractive-index probe, cone deviation and the
// In-Next-Week shading model.  One thread owns one ray; everything here is
// scalar per-thread code.
//
// Table layouts (row-major float32, built by kernels/sweep2.py::make_accel2):
//   otab  (n_pad + n_probe_rows, 8): cx cy cz k1 | ri rinv2 0 0
//         centres are relative to the row's GROUP ANCHOR, k1 = |c|^2 - r^2
//         (3e38 on dead rows, which kills both the quadratic and containment)
//   ftab  (n_pad, 20): the winner's material row, columns FT_* below
//   gaabb (n_groups + n_pgroups, 12): lo xyz, hi xyz, anchor xyz, 0 0 0
// The main rows come first; the dielectric-only probe rows / probe groups
// trail them.
//
// No fast-math: reciprocal and rsqrt approximations flip grazing visibility.
// rsqrtf appears only where the reference arithmetic uses rsqrt.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace rt {

constexpr float BIG_T = 3.0e38f;
constexpr int OT_COLS = 8;
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
};

__device__ __forceinline__ float4 ld4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

// Grouped nearest-hit sweep: groups are visited in table order (near-first
// from the camera), each behind the thread's own slab test against its current
// best t; a group's spheres are solved around the group anchor.  Ties keep the
// lower row.  Returns obj = -1 (and t_best = min(BIG_T, tlim)) on a miss or a
// dead ray.  `tests` is increased by the number of sphere quadratics solved
// (the data-dependent work, for the roofline bound).
__device__ __forceinline__ void nearest_hit(
    const Tables& T, float ox, float oy, float oz, float dx, float dy,
    float dz, bool live, float tlim, float& t_best, int& obj,
    unsigned& tests) {
  t_best = fminf(BIG_T, tlim);
  obj = -1;
  if (!live) return;
  const float eps = 1e-12f;
  const float ix = 1.0f / (fabsf(dx) < eps ? eps : dx);
  const float iy = 1.0f / (fabsf(dy) < eps ? eps : dy);
  const float iz = 1.0f / (fabsf(dz) < eps ? eps : dz);
  for (int g = 0; g < T.n_groups; ++g) {
    const float* ga = T.gaabb + g * GA_COLS;
    const float4 a0 = ld4(ga);      // lo.x lo.y lo.z hi.x
    const float4 a1 = ld4(ga + 4);  // hi.y hi.z an.x an.y
    const float4 a2 = ld4(ga + 8);  // an.z 0 0 0
    const float u1 = (a0.x - ox) * ix, w1 = (a0.w - ox) * ix;
    const float u2 = (a0.y - oy) * iy, w2 = (a1.x - oy) * iy;
    const float u3 = (a0.z - oz) * iz, w3 = (a1.y - oz) * iz;
    const float tmin = fmaxf(fmaxf(fminf(u1, w1), fminf(u2, w2)), fminf(u3, w3));
    const float tmax = fminf(fminf(fmaxf(u1, w1), fmaxf(u2, w2)), fmaxf(u3, w3));
    if (!((tmax > tmin) && (tmax > 0.0f) && (tmin < t_best))) continue;
    // Shift the ray into the group-anchored frame.
    const float sx = ox - a1.z, sy = oy - a1.w, sz = oz - a2.x;
    const float od = sx * dx + sy * dy + sz * dz;
    const float oo = sx * sx + sy * sy + sz * sz;
    const int row0 = g * T.gr;
    tests += (unsigned)T.gr;
    const float* rows = T.otab + (size_t)row0 * OT_COLS;
    for (int r = 0; r < T.gr; ++r) {
      const float4 c = ld4(rows + r * OT_COLS);  // cx cy cz k1
      const float DC = c.x * dx + c.y * dy + c.z * dz;
      const float OC = c.x * sx + c.y * sy + c.z * sz;
      const float nb = DC - od;  // = -half_b
      const float c_q = oo + c.w - 2.0f * OC;
      const float disc = nb * nb - c_q;
      if (disc > 0.0f) {
        const float sq = sqrtf(disc);
        const float tn = nb - sq;  // near root (a == 1)
        const float t = tn > 0.0f ? tn : nb + sq;
        if (t > 0.0f && t < t_best) {
          t_best = t;
          obj = row0 + r;
        }
      }
    }
  }
}

struct Refined {
  float t, px, py, pz, nx, ny, nz;
};

// Re-solve the winner's quadratic directly in its own frame (rel = o - c) and
// derive the hit point and outward normal.  The group-anchored sweep t carries
// an absolute error larger than the 1e-4 surface offset children spawn from.
// `row` is the winner's ftab row; on a miss pass a zero row and hit = false.
__device__ __forceinline__ Refined winner_refine(
    const float* row, float ox, float oy, float oz, float dx, float dy,
    float dz, float t_best, bool hit) {
  const float cex = row[FT_CX], cey = row[FT_CY], cez = row[FT_CZ];
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
__device__ __forceinline__ float ri_probe(const Tables& T, float qx, float qy,
                                          float qz) {
  float acc = 0.0f, cnt = 0.0f;
  const float* rows = T.otab + (size_t)T.n_groups * T.gr * OT_COLS;
  for (int g = 0; g < T.n_pgroups; ++g) {
    const float* ga = T.gaabb + (T.n_groups + g) * GA_COLS;
    const float ux = qx - __ldg(ga + 6);
    const float uy = qy - __ldg(ga + 7);
    const float uz = qz - __ldg(ga + 8);
    const float qq = ux * ux + uy * uy + uz * uz;
    for (int r = 0; r < T.probe_gr; ++r) {
      const float* row = rows + (size_t)(g * T.probe_gr + r) * OT_COLS;
      const float4 c = ld4(row);
      const float QC = c.x * ux + c.y * uy + c.z * uz;
      const float lhs = qq + c.w - 2.0f * QC;
      if (lhs <= 0.0f) {
        acc += __ldg(row + 4);
        cnt += 1.0f;
      }
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
};

struct ShadeStatics {
  Sunflower sun;
  float max_bounces;  // as float: compared with the float bounce count
  int has_dielectrics;
};

// In-Next-Week shading of one HIT node (sphere mode, no lights, no texture):
// refine the winner, probe the surrounding RI where a refraction consumes it,
// add contrib_post * albedo, and build the refract / reflect children.
__device__ __forceinline__ Shade shade_hit(
    const Tables& T, const ShadeStatics& S, int obj, float t_sweep, float ox,
    float oy, float oz, float dx, float dy, float dz, float contrib,
    float bounced, float sidx, float cth, float sth) {
  const float* row = T.ftab + (size_t)obj * FT_COLS;
  float rowv[FT_COLS];
#pragma unroll
  for (int i = 0; i < FT_COLS / 4; ++i) {
    const float4 v = ld4(row + 4 * i);
    rowv[4 * i] = v.x;
    rowv[4 * i + 1] = v.y;
    rowv[4 * i + 2] = v.z;
    rowv[4 * i + 3] = v.w;
  }
  const Refined R = winner_refine(rowv, ox, oy, oz, dx, dy, dz, t_sweep, true);
  const float nx = R.nx, ny = R.ny, nz = R.nz;
  const float mat_ri = rowv[FT_MRI], refrv = rowv[FT_REFR];
  const float reflv = rowv[FT_REFL], srfr = rowv[FT_SRFR];
  const float srfl = rowv[FT_SRFL];

  const float ndotd = nx * dx + ny * dy + nz * dz;
  const bool inner = ndotd > 0.0f;

  // Only dielectric winners and interior hits consume the surrounding RI.
  float sur_ri = 1.0f;
  if (S.has_dielectrics && T.n_pgroups > 0 && (inner || refrv > 0.002f))
    sur_ri = ri_probe(T, R.px + 1e-3f * nx, R.py + 1e-3f * ny,
                      R.pz + 1e-3f * nz);

  const float bounced1 = bounced + 1.0f;
  const bool can_spawn = ((reflv > 0.002f) || (refrv > 0.002f)) &&
                         (contrib > 0.01f) && (bounced1 < S.max_bounces);

  // Mirror direction (also the inner total-internal-reflection child).
  const float mrx = dx - 2.0f * ndotd * nx;
  const float mry = dy - 2.0f * ndotd * ny;
  const float mrz = dz - 2.0f * ndotd * nz;

  Shade out;
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
  out.add_r = contrib_post * rowv[FT_CR];
  out.add_g = contrib_post * rowv[FT_CG];
  out.add_b = contrib_post * rowv[FT_CB];
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

}  // namespace rt
