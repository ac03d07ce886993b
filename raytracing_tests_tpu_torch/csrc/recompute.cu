// The gradient path's closed-form recompute of each lane's hit on its winner,
// with its reverse-mode and its forward-mode derivative, for Hopper (sm_90a).
//
// Replaces no TPU kernel: it is the counterpart of the XLA fusion of the JAX
// package's recompute after the winner's gathers,
// raytracing_tests_tpu/diff/fastpath.py:141-210 (the rotation into the
// object's frame, geometry.ray_primitive_t, the soft coverage, the normal and
// the local position), which no pallas_call stands behind.  The port ran it
// as some hundred PyTorch elementwise kernels a pop and their autograd
// backward (kernels/recompute.py::winner_recompute_plain).
//
// The function, per lane (B of them), from the ray (o, d, time ratio tr),
// whether it hit, and its winner's gathered row (position, delta_position,
// rotation R (R[j][i] at 3 j + i, local -> world), scale s, type):
//   rel = (o - position) + (1 - tr) delta_position, lo = R^T rel, ld = R^T d;
//   t = ray_primitive_t(lo, ld, s, type) (core/geometry.py:38-81);
//   with soft > 0 the coverage alpha of the silhouette (isotropic in world
//   space for spheres, in the local unit frame for generic scenes), 0 where
//   the lane did not hit, and t_cl where t is not below 2.9e38;
//   t = 1 where the lane did not hit; p = lo + t ld;
//   normal = R primitive_normal(p, s, type), local_pos = p / s.
// Every operation is the plain version's, in its order: the sums over a
// vector's three components add (x0 + x2) + x1, as PyTorch's CUDA reduction
// over a contiguous last dimension of three does; R^T v adds
// (R0i v0 + R1i v1) + R2i v2, as its reduction over a middle dimension does;
// the mean multiplies the sum by 1/3.  So the -fmad=false build equals the
// plain version on the card.
//
// The forward and the tangent share one source of the math: `recompute`
// and `core` are templates on the scalar, a float (recompute_kernel, the
// forward) or a dual number (value and tangent; recompute_jvp_kernel,
// forward-mode AD, the whole function seeded with the inputs' tangents).
// recompute_grad_kernel is reverse-mode AD: it recomputes the forward in
// registers from the saved inputs (no per-lane intermediate is saved), runs
// the core's adjoint by hand (`core_grad`, in reverse order of `core`), and
// differentiates the rotations and the affine map to rel around it in
// closed form.  Both derivatives follow autograd's rules: torch.where passes
// the selected branch's; maximum and minimum split a tie evenly, as do the
// slab's amax and amin and the soft cuboid's amax(|q|); abs has none at 0;
// clamp_min passes all of it at or above its bound; the cuboid normal, its
// face the first strict minimum, is a constant.
//
// Built with -fmad=false in every build (kernels/_build.py SOURCE_FLAGS), so
// the default build equals the plain version too: the ground sphere's
// quadratic (radius 1000) and grazing hits turn a fused a*b+c into another
// branch, and with it the gradient step's loss moved by 3.7 %.
//
// What bounds them on this card: bytes (some 140 B a lane in and out for
// the forward, some 240 B for the backward, against a few hundred
// operations a lane).  None synchronises or reads on the host: each runs
// inside a gradient band's captured CUDA graph.
#include "rt_common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int GRAD_THREADS = 128;  // the backward's blocks
constexpr int ELLIPSOID = 1;
constexpr int CUBOID = 2;

struct Dual {
  float v, d;
};

__device__ __forceinline__ float val(float x) { return x; }
__device__ __forceinline__ float val(Dual x) { return x.v; }

template <class T>
__device__ __forceinline__ T cst(float x);
template <>
__device__ __forceinline__ float cst<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ Dual cst<Dual>(float x) {
  return Dual{x, 0.0f};
}

__device__ __forceinline__ Dual operator+(Dual a, Dual b) { return {a.v + b.v, a.d + b.d}; }
__device__ __forceinline__ Dual operator-(Dual a, Dual b) { return {a.v - b.v, a.d - b.d}; }
__device__ __forceinline__ Dual operator-(Dual a) { return {-a.v, -a.d}; }
__device__ __forceinline__ Dual operator*(Dual a, Dual b) {
  return {a.v * b.v, a.d * b.v + a.v * b.d};
}
__device__ __forceinline__ Dual operator/(Dual a, Dual b) {
  const float q = a.v / b.v;
  return {q, (a.d - q * b.d) / b.v};
}
__device__ __forceinline__ Dual operator+(Dual a, float b) { return {a.v + b, a.d}; }
__device__ __forceinline__ Dual operator-(Dual a, float b) { return {a.v - b, a.d}; }
__device__ __forceinline__ Dual operator-(float a, Dual b) { return {a - b.v, -b.d}; }
__device__ __forceinline__ Dual operator*(Dual a, float b) { return {a.v * b, a.d * b}; }
__device__ __forceinline__ Dual operator*(float a, Dual b) { return {a * b.v, a * b.d}; }
__device__ __forceinline__ Dual operator/(float a, Dual b) {
  const float q = a / b.v;
  return {q, -(q * b.d) / b.v};
}

__device__ __forceinline__ float tsqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ Dual tsqrt(Dual x) {
  const float r = sqrtf(x.v);
  return {r, x.d / (2.0f * r)};
}
__device__ __forceinline__ float texp(float x) { return expf(x); }
__device__ __forceinline__ Dual texp(Dual x) {
  const float e = expf(x.v);
  return {e, x.d * e};
}
__device__ __forceinline__ float tlog(float x) { return logf(x); }
__device__ __forceinline__ Dual tlog(Dual x) { return {logf(x.v), x.d / x.v}; }
__device__ __forceinline__ float tsigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }
__device__ __forceinline__ Dual tsigmoid(Dual x) {
  const float y = tsigmoid(x.v);
  return {y, x.d * ((1.0f - y) * y)};
}
__device__ __forceinline__ float tabs(float x) { return fabsf(x); }
__device__ __forceinline__ Dual tabs(Dual x) {
  return {fabsf(x.v), x.v > 0.0f ? x.d : (x.v < 0.0f ? -x.d : 0.0f)};
}

// torch.maximum / torch.minimum: NaN wins; a tie splits the tangent evenly.
__device__ __forceinline__ float fmaximum(float a, float b) {
  return a != a ? a : (b != b ? b : (a > b ? a : b));
}
__device__ __forceinline__ float fminimum(float a, float b) {
  return a != a ? a : (b != b ? b : (a < b ? a : b));
}
__device__ __forceinline__ float tmaximum(float a, float b) { return fmaximum(a, b); }
__device__ __forceinline__ float tminimum(float a, float b) { return fminimum(a, b); }
__device__ __forceinline__ Dual tmaximum(Dual a, Dual b) {
  return {fmaximum(a.v, b.v), a.v > b.v ? a.d : (a.v < b.v ? b.d : 0.5f * (a.d + b.d))};
}
__device__ __forceinline__ Dual tminimum(Dual a, Dual b) {
  return {fminimum(a.v, b.v), a.v < b.v ? a.d : (a.v > b.v ? b.d : 0.5f * (a.d + b.d))};
}
// torch.clamp_min(x, lo): all of the tangent at or above the bound.
__device__ __forceinline__ float tclamp_min(float x, float lo) { return fmaximum(x, lo); }
__device__ __forceinline__ Dual tclamp_min(Dual x, float lo) {
  return {fmaximum(x.v, lo), x.v >= lo ? x.d : 0.0f};
}

// torch.amax / torch.amin over three entries: a tie shares the tangent
// evenly among the tied entries.
__device__ __forceinline__ float amax3(const float x[3]) {
  return fmaximum(fmaximum(x[0], x[1]), x[2]);
}
__device__ __forceinline__ float amin3(const float x[3]) {
  return fminimum(fminimum(x[0], x[1]), x[2]);
}
__device__ __forceinline__ Dual tied_mean(const Dual x[3], float m) {
  float d = 0.0f, n = 0.0f;
  for (int i = 0; i < 3; ++i) {
    if (x[i].v == m) {
      d += x[i].d;
      n += 1.0f;
    }
  }
  return {m, n > 0.0f ? d / n : 0.0f};
}
__device__ __forceinline__ Dual amax3(const Dual x[3]) {
  const float v[3] = {x[0].v, x[1].v, x[2].v};
  return tied_mean(x, amax3(v));
}
__device__ __forceinline__ Dual amin3(const Dual x[3]) {
  const float v[3] = {x[0].v, x[1].v, x[2].v};
  return tied_mean(x, amin3(v));
}

template <class T>
__device__ __forceinline__ T sel(bool c, T a, T b) {
  return c ? a : b;
}

// torch.sum over a contiguous last dimension of three: (x0 + x2) + x1.
template <class T>
__device__ __forceinline__ T dot3(const T a[3], const T b[3]) {
  return (a[0] * b[0] + a[2] * b[2]) + a[1] * b[1];
}
// R^T v (linalg.apply_rotation_t: the sum over the middle dimension).
template <class T>
__device__ __forceinline__ void rot_t(const T R[9], const T v[3], T out[3]) {
  for (int i = 0; i < 3; ++i) out[i] = (R[i] * v[0] + R[3 + i] * v[1]) + R[6 + i] * v[2];
}
// R v (linalg.apply_rotation: the sum over the last dimension).
template <class T>
__device__ __forceinline__ void rot(const T R[9], const T v[3], T out[3]) {
  for (int i = 0; i < 3; ++i) out[i] = (R[3 * i] * v[0] + R[3 * i + 2] * v[2]) + R[3 * i + 1] * v[1];
}

// geometry.ray_ellipsoid_t on the local ray.
template <class T>
__device__ __forceinline__ T ellipsoid_t(const T lo[3], const T ld[3], const T s[3]) {
  T eo[3], ed[3];
  for (int i = 0; i < 3; ++i) {
    eo[i] = lo[i] / s[i];
    ed[i] = ld[i] / s[i];
  }
  const T hb = dot3(eo, ed);
  const T ea = dot3(ed, ed);
  const T ec = dot3(eo, eo) - 1.0f;
  const T disc = hb * hb - ea * ec;
  const bool ok = val(disc) > 0.0f && val(ea) > 1e-30f;
  const T sq = tsqrt(sel(ok, disc, cst<T>(1.0f)));
  const T as = sel(ok, ea, cst<T>(1.0f));
  const T t0 = (-hb - sq) / as;
  const T t1 = (-hb + sq) / as;
  const T t = sel(val(t0) > val(t1) || val(t0) < 0.0f, t1, t0);
  return sel(ok && val(t) > 0.0f, t, cst<T>(-1.0f));
}

// geometry.ray_cuboid_t on the local ray (the slab test, _safe_inv's clamp).
template <class T>
__device__ __forceinline__ T cuboid_t(const T lo[3], const T ld[3], const T s[3]) {
  T near[3], far[3];
  for (int i = 0; i < 3; ++i) {
    const float dv = val(ld[i]);
    const T dsafe = fabsf(dv) < 1e-12f ? cst<T>(dv >= 0.0f ? 1e-12f : -1e-12f) : ld[i];
    const T inv = 1.0f / dsafe;
    const T u1 = ((-s[i]) * 0.5f - lo[i]) * inv;
    const T u2 = (s[i] * 0.5f - lo[i]) * inv;
    near[i] = tminimum(u1, u2);
    far[i] = tmaximum(u1, u2);
  }
  const T tmin = amax3(near);
  const T tmax = amin3(far);
  const T t = sel(val(tmax) > val(tmin), sel(val(tmin) > 0.0f, tmin, tmax), cst<T>(-1.0f));
  return sel(val(t) > 0.0f, t, cst<T>(-1.0f));
}

// geometry.cuboid_normal: the axis of the nearest face, the first strict
// minimum of the six distances (+x, -x, +y, -y, +z, -z); a constant.
__device__ __forceinline__ void cuboid_normal(const float p[3], const float s[3], float n[3]) {
  float dist[6];
  for (int i = 0; i < 3; ++i) {
    dist[2 * i] = fabsf(p[i] - s[i] * 0.5f);
    dist[2 * i + 1] = fabsf(p[i] + s[i] * 0.5f);
  }
  float mn = dist[0];
  for (int k = 1; k < 6; ++k) mn = fminimum(mn, dist[k]);
  int face = 6;
  for (int k = 5; k >= 0; --k) {
    if (dist[k] == mn) face = k;
  }
  const float sign = face % 2 == 0 ? 1.0f : -1.0f;
  for (int i = 0; i < 3; ++i) n[i] = (i == face / 2 ? 1.0f : 0.0f) * sign;
}

// The recompute in the object's frame: the local ray (lo, ld), the scale s
// and, for the isotropic coverage of spheres, the world rel and d -> t, the
// local normal nl, local_pos lp and (soft > 0) alpha.
template <class T>
__device__ __forceinline__ void core(const T lo[3], const T ld[3], const T s[3], const T rel[3],
                                     const T dw[3], int type, bool hit, float soft, bool spheres,
                                     T& t, T nl[3], T lp[3], T& alpha) {
  t = cst<T>(-1.0f);  // ray_primitive_t: both branches evaluated, one selected
  if (type == ELLIPSOID) {
    t = ellipsoid_t(lo, ld, s);
  } else if (type == CUBOID) {
    t = cuboid_t(lo, ld, s);
  }
  if (soft > 0.0f) {
    T tcl, cover;
    if (spheres) {
      const T a = tmaximum(dot3(dw, dw), cst<T>(1e-20f));
      const T hb = dot3(rel, dw);
      tcl = -hb / a;
      const T h2 = dot3(rel, rel) - hb * hb / a;
      const T h = tsqrt(tmaximum(h2, cst<T>(1e-20f)));
      const T band = soft * tmaximum(tabs(tcl), cst<T>(1e-3f));
      cover = tsigmoid(-(h - s[0]) / band);
    } else {
      T ss[3], los[3], lds[3], q[3], aq[3];
      for (int i = 0; i < 3; ++i) {
        ss[i] = tmaximum(s[i], cst<T>(1e-20f));
        los[i] = lo[i] / ss[i];
        lds[i] = ld[i] / ss[i];
      }
      const T a = tmaximum(dot3(lds, lds), cst<T>(1e-20f));
      const T hb = dot3(los, lds);
      tcl = -hb / a;
      for (int i = 0; i < 3; ++i) {
        q[i] = los[i] + tcl * lds[i];
        aq[i] = tabs(q[i]);
      }
      const T over = type == ELLIPSOID ? tsqrt(tmaximum(dot3(q, q), cst<T>(1e-20f))) - 1.0f
                                       : 2.0f * (amax3(aq) - 0.5f);
      const T r_geo = texp(((tlog(ss[0]) + tlog(ss[2])) + tlog(ss[1])) * (1.0f / 3.0f));
      const T band = soft * tmaximum(tabs(tcl), cst<T>(1e-3f));
      cover = tsigmoid(-(over * r_geo) / band);
    }
    alpha = sel(hit, cover, cst<T>(0.0f));
    t = sel(val(t) < 2.9e38f, t, tcl);  // always t: MISS_T is -1 (see kernels/recompute.py)
  }
  t = sel(hit, t, cst<T>(1.0f));
  T p[3];
  for (int i = 0; i < 3; ++i) p[i] = lo[i] + t * ld[i];
  if (type == ELLIPSOID) {  // linalg.normalize(p / s^2), eps 0
    T v[3];
    for (int i = 0; i < 3; ++i) v[i] = p[i] / (s[i] * s[i]);
    const T nn = tsqrt(tclamp_min(dot3(v, v), (float)1e-38));
    for (int i = 0; i < 3; ++i) nl[i] = v[i] / nn;
  } else {
    const float pv[3] = {val(p[0]), val(p[1]), val(p[2])};
    const float sv[3] = {val(s[0]), val(s[1]), val(s[2])};
    float face[3];
    cuboid_normal(pv, sv, face);
    for (int i = 0; i < 3; ++i) nl[i] = cst<T>(face[i]);
  }
  for (int i = 0; i < 3; ++i) lp[i] = p[i] / s[i];
}

// The whole recompute: world ray and gathered row -> t, the world normal n,
// local_pos lp and (soft > 0) alpha.
template <class T>
__device__ __forceinline__ void recompute(const T o[3], const T d[3], T tr, const T pos[3],
                                          const T dpos[3], const T R[9], const T s[3], int type,
                                          bool hit, float soft, bool spheres, T& t, T n[3],
                                          T lp[3], T& alpha) {
  const T omt = 1.0f - tr;
  T rel[3], lo[3], ld[3], nl[3];
  for (int c = 0; c < 3; ++c) rel[c] = (o[c] - pos[c]) + omt * dpos[c];
  rot_t(R, rel, lo);
  rot_t(R, d, ld);
  core(lo, ld, s, rel, d, type, hit, soft, spheres, t, nl, lp, alpha);
  rot(R, nl, n);
}

// The gradient reaching x of max(x, c) (torch.maximum with a constant c):
// all of it above c, half at a tie.
__device__ __forceinline__ float max_adj(float x, float c, float g) {
  return x > c ? g : (x < c ? 0.0f : 0.5f * g);
}

// The gradient reaching each of three entries of their max (min: ``min``)
// ``m``: shared evenly among the tied ones.
__device__ __forceinline__ void tied_adj(const float x[3], float m, float g, float out[3]) {
  const float n = (float)((x[0] == m) + (x[1] == m) + (x[2] == m));
  for (int i = 0; i < 3; ++i) out[i] = x[i] == m ? g / n : 0.0f;
}

// The core's reverse mode: the forward recomputed in registers, then its
// adjoint in reverse order, each rule autograd's (the selected branch of a
// where; maximum, minimum, amax and amin split a tie evenly; abs has no
// gradient at 0; clamp_min passes all of it at or above its bound; the
// cuboid normal is a constant).  x: the core's inputs lo, ld, s, rel, d
// (15); gt, gnl, glp, ga: the gradients of t, the local normal, local_pos
// and alpha -> g: the inputs' gradients (15, added), nl: the local normal.
__device__ void core_grad(const float x[15], int type, bool hit, float soft, bool spheres,
                          float gt, const float gnl[3], const float glp[3], float ga, float g[15],
                          float nl[3]) {
  const float* lo = x;
  const float* ld = x + 3;
  const float* s = x + 6;
  const float* rel = x + 9;
  const float* dw = x + 12;
  float* g_lo = g;
  float* g_ld = g + 3;
  float* g_s = g + 6;
  float* g_rel = g + 9;
  float* g_dw = g + 12;

  // ---- forward, every intermediate kept --------------------------------
  // ellipsoid
  float eo[3], ed[3], hb = 0.0f, ea = 0.0f, ec = 0.0f, disc = 0.0f, sq = 1.0f, as = 1.0f;
  float t0 = 0.0f, t1 = 0.0f;
  bool ok = false, use1 = false;
  // cuboid
  float inv[3], u1[3], u2[3], near[3], far[3], tmin = 0.0f, tmax = 0.0f;
  bool clamped[3];
  float t = -1.0f;
  bool t_live = false;  // does t take a gradient (not the constant -1)?
  if (type == ELLIPSOID) {
    for (int i = 0; i < 3; ++i) {
      eo[i] = lo[i] / s[i];
      ed[i] = ld[i] / s[i];
    }
    hb = dot3(eo, ed);
    ea = dot3(ed, ed);
    ec = dot3(eo, eo) - 1.0f;
    disc = hb * hb - ea * ec;
    ok = disc > 0.0f && ea > 1e-30f;
    sq = sqrtf(ok ? disc : 1.0f);
    as = ok ? ea : 1.0f;
    t0 = (-hb - sq) / as;
    t1 = (-hb + sq) / as;
    use1 = t0 > t1 || t0 < 0.0f;
    const float te = use1 ? t1 : t0;
    t_live = ok && te > 0.0f;
    t = t_live ? te : -1.0f;
  } else if (type == CUBOID) {
    for (int i = 0; i < 3; ++i) {
      clamped[i] = fabsf(ld[i]) < 1e-12f;
      const float dsafe = clamped[i] ? (ld[i] >= 0.0f ? 1e-12f : -1e-12f) : ld[i];
      inv[i] = 1.0f / dsafe;
      u1[i] = ((-s[i]) * 0.5f - lo[i]) * inv[i];
      u2[i] = (s[i] * 0.5f - lo[i]) * inv[i];
      near[i] = fminimum(u1[i], u2[i]);
      far[i] = fmaximum(u1[i], u2[i]);
    }
    tmin = amax3(near);
    tmax = amin3(far);
    const float tc = tmax > tmin ? (tmin > 0.0f ? tmin : tmax) : -1.0f;
    t_live = tc > 0.0f;
    t = t_live ? tc : -1.0f;
  }
  // the soft coverage
  float a0 = 0.0f, a = 1.0f, hb2 = 0.0f, tcl = 0.0f, atc = 0.0f, bm = 0.0f, band = 1.0f;
  float zx = 0.0f, cover = 0.0f;
  float rr = 0.0f, h2 = 0.0f, h = 0.0f;                                    // spheres
  float ss[3], los[3], lds[3], q[3], aq[3], qq = 0.0f, hell = 0.0f, hcub = 0.0f;  // generic
  float over = 0.0f, r_geo = 0.0f;
  bool real = true;
  if (soft > 0.0f) {
    if (spheres) {
      a0 = dot3(dw, dw);
      a = fmaximum(a0, 1e-20f);
      hb2 = dot3(rel, dw);
      tcl = -hb2 / a;
      rr = dot3(rel, rel);
      h2 = rr - hb2 * hb2 / a;
      h = sqrtf(fmaximum(h2, 1e-20f));
      atc = fabsf(tcl);
      bm = fmaximum(atc, 1e-3f);
      band = soft * bm;
      zx = h - s[0];
      cover = tsigmoid(-zx / band);
    } else {
      for (int i = 0; i < 3; ++i) {
        ss[i] = fmaximum(s[i], 1e-20f);
        los[i] = lo[i] / ss[i];
        lds[i] = ld[i] / ss[i];
      }
      a0 = dot3(lds, lds);
      a = fmaximum(a0, 1e-20f);
      hb2 = dot3(los, lds);
      tcl = -hb2 / a;
      for (int i = 0; i < 3; ++i) {
        q[i] = los[i] + tcl * lds[i];
        aq[i] = fabsf(q[i]);
      }
      if (type == ELLIPSOID) {
        qq = dot3(q, q);
        hell = sqrtf(fmaximum(qq, 1e-20f));
        over = hell - 1.0f;
      } else {
        hcub = amax3(aq);
        over = 2.0f * (hcub - 0.5f);
      }
      r_geo = expf(((logf(ss[0]) + logf(ss[2])) + logf(ss[1])) * (1.0f / 3.0f));
      atc = fabsf(tcl);
      bm = fmaximum(atc, 1e-3f);
      band = soft * bm;
      zx = over * r_geo;
      cover = tsigmoid(-zx / band);
    }
    real = t < 2.9e38f;
    t = real ? t : tcl;
  }
  const float tt = hit ? t : 1.0f;
  float p[3], v[3], s2[3], n2 = 0.0f, nn = 1.0f;
  for (int i = 0; i < 3; ++i) p[i] = lo[i] + tt * ld[i];
  if (type == ELLIPSOID) {
    for (int i = 0; i < 3; ++i) {
      s2[i] = s[i] * s[i];
      v[i] = p[i] / s2[i];
    }
    n2 = dot3(v, v);
    nn = sqrtf(fmaximum(n2, (float)1e-38));
    for (int i = 0; i < 3; ++i) nl[i] = v[i] / nn;
  } else {
    cuboid_normal(p, s, nl);
  }

  // ---- adjoint -----------------------------------------------------------
  for (int k = 0; k < 15; ++k) g[k] = 0.0f;
  float gp[3];
  // local_pos = p / s
  for (int i = 0; i < 3; ++i) {
    gp[i] = glp[i] / s[i];
    g_s[i] -= glp[i] * (p[i] / s[i]) / s[i];
  }
  if (type == ELLIPSOID) {  // nl = v / nn, nn = sqrt(clamp_min(v . v)), v = p / s^2
    float gv[3], gnn = 0.0f;
    for (int i = 0; i < 3; ++i) {
      gv[i] = gnl[i] / nn;
      gnn -= gnl[i] * nl[i] / nn;
    }
    const float gn2 = n2 >= (float)1e-38 ? gnn / (2.0f * nn) : 0.0f;
    for (int i = 0; i < 3; ++i) {
      gv[i] += 2.0f * v[i] * gn2;
      gp[i] += gv[i] / s2[i];
      g_s[i] -= 2.0f * s[i] * (gv[i] * v[i] / s2[i]);
    }
  }
  // p = lo + t ld
  float g_tt = gt;
  for (int i = 0; i < 3; ++i) {
    g_lo[i] += gp[i];
    g_ld[i] += tt * gp[i];
    g_tt += gp[i] * ld[i];
  }
  const float g_t = hit ? g_tt : 0.0f;  // t = hit ? t : 1
  float g_prim = g_t, g_tcl = 0.0f;
  if (soft > 0.0f) {
    g_prim = real ? g_t : 0.0f;
    g_tcl = real ? 0.0f : g_t;
    const float g_cover = hit ? ga : 0.0f;
    const float gz = g_cover * ((1.0f - cover) * cover);  // cover = sigmoid(-zx / band)
    const float g_zx = -gz / band;
    const float g_band = gz * zx / (band * band);
    g_tcl += (tcl > 0.0f ? 1.0f : (tcl < 0.0f ? -1.0f : 0.0f))
             * max_adj(atc, 1e-3f, soft * g_band);
    float g_hb2 = 0.0f, g_a = 0.0f;
    if (spheres) {  // zx = h - s0, h = sqrt(max(h2)), h2 = rr - hb2^2 / a
      const float g_h2 = max_adj(h2, 1e-20f, g_zx / (2.0f * h));
      g_s[0] -= g_zx;
      g_hb2 = -g_h2 * 2.0f * hb2 / a - g_tcl / a;
      g_a = g_h2 * hb2 * hb2 / (a * a) + g_tcl * hb2 / (a * a);
      for (int i = 0; i < 3; ++i) g_rel[i] += 2.0f * rel[i] * g_h2 + dw[i] * g_hb2;
      const float g_a0 = max_adj(a0, 1e-20f, g_a);
      for (int i = 0; i < 3; ++i) g_dw[i] += rel[i] * g_hb2 + 2.0f * dw[i] * g_a0;
    } else {  // zx = over r_geo
      const float g_over = g_zx * r_geo;
      const float g_lsum = g_zx * over * r_geo * (1.0f / 3.0f);
      float g_q[3], g_ss[3];
      if (type == ELLIPSOID) {
        const float g_qq = max_adj(qq, 1e-20f, g_over / (2.0f * hell));
        for (int i = 0; i < 3; ++i) g_q[i] = 2.0f * q[i] * g_qq;
      } else {
        float g_aq[3];
        tied_adj(aq, hcub, 2.0f * g_over, g_aq);
        for (int i = 0; i < 3; ++i) {
          g_q[i] = (q[i] > 0.0f ? 1.0f : (q[i] < 0.0f ? -1.0f : 0.0f)) * g_aq[i];
        }
      }
      float g_los[3], g_lds[3];
      for (int i = 0; i < 3; ++i) {  // q = los + tcl lds
        g_los[i] = g_q[i];
        g_lds[i] = tcl * g_q[i];
        g_tcl += g_q[i] * lds[i];
      }
      g_hb2 = -g_tcl / a;
      g_a = g_tcl * hb2 / (a * a);
      const float g_a0 = max_adj(a0, 1e-20f, g_a);
      for (int i = 0; i < 3; ++i) {
        g_los[i] += lds[i] * g_hb2;
        g_lds[i] += los[i] * g_hb2 + 2.0f * lds[i] * g_a0;
        g_lo[i] += g_los[i] / ss[i];
        g_ld[i] += g_lds[i] / ss[i];
        g_ss[i] = g_lsum / ss[i] - (g_los[i] * los[i] + g_lds[i] * lds[i]) / ss[i];
        g_s[i] += max_adj(s[i], 1e-20f, g_ss[i]);
      }
    }
  }
  if (!t_live) return;  // t is the constant -1: nothing reaches the primitive's test
  if (type == ELLIPSOID) {
    const float g_t0 = use1 ? 0.0f : g_prim, g_t1 = use1 ? g_prim : 0.0f;
    const float g_hb = -(g_t0 + g_t1) / as;
    const float g_sq = (g_t1 - g_t0) / as;
    const float g_as = -(g_t0 * t0 + g_t1 * t1) / as;
    const float g_disc = g_sq / (2.0f * sq);  // ok: t is live
    const float g_ea = g_as - ec * g_disc;
    const float g_ec = -ea * g_disc;
    const float g_hbt = g_hb + 2.0f * hb * g_disc;
    for (int i = 0; i < 3; ++i) {
      const float g_eo = 2.0f * eo[i] * g_ec + ed[i] * g_hbt;
      const float g_ed = 2.0f * ed[i] * g_ea + eo[i] * g_hbt;
      g_lo[i] += g_eo / s[i];
      g_ld[i] += g_ed / s[i];
      g_s[i] -= (g_eo * eo[i] + g_ed * ed[i]) / s[i];
    }
  } else {  // the cuboid's slab test
    const bool entry = tmin > 0.0f;
    float g_near[3], g_far[3];
    tied_adj(near, tmin, entry ? g_prim : 0.0f, g_near);
    tied_adj(far, tmax, entry ? 0.0f : g_prim, g_far);
    for (int i = 0; i < 3; ++i) {
      // near = minimum(u1, u2), far = maximum(u1, u2)
      const float g_u1 = (u1[i] < u2[i] ? g_near[i] : u1[i] > u2[i] ? 0.0f : 0.5f * g_near[i])
                         + (u1[i] > u2[i] ? g_far[i] : u1[i] < u2[i] ? 0.0f : 0.5f * g_far[i]);
      const float g_u2 = (u2[i] < u1[i] ? g_near[i] : u2[i] > u1[i] ? 0.0f : 0.5f * g_near[i])
                         + (u2[i] > u1[i] ? g_far[i] : u2[i] < u1[i] ? 0.0f : 0.5f * g_far[i]);
      const float bmin = (-s[i]) * 0.5f, bmax = s[i] * 0.5f;
      g_lo[i] -= (g_u1 + g_u2) * inv[i];
      g_s[i] += 0.5f * (g_u2 - g_u1) * inv[i];
      const float g_inv = g_u1 * (bmin - lo[i]) + g_u2 * (bmax - lo[i]);
      if (!clamped[i]) g_ld[i] -= g_inv * inv[i] * inv[i];
    }
  }
}

// The per-lane inputs (a field's pointer may be null where it has no
// tangent or gradient: zero).
enum { I_O, I_D, I_TR, I_POS, I_DPOS, I_ROT, I_SCALE, N_IN };
// the outputs: t, normal, local_pos, alpha
enum { O_T, O_N, O_LP, O_A, N_OUT };

struct Args {
  const float* in[N_IN];     // the float inputs, (B, width)
  const unsigned char* hit;  // (B,) bool
  const int* type;           // (B,) int32
  const float* tan_in[N_IN];  // recompute_jvp: the inputs' tangents, null: 0
  const float* grad_out[N_OUT];  // recompute_grad: the outputs' gradients, null: 0
  float* out[N_OUT];             // the outputs (forward) or their tangents (jvp)
  float* grad_in[N_IN];          // recompute_grad: the inputs' gradients, null: not wanted
  long long B;
  float soft;
  int spheres;
};

template <class T>
__device__ __forceinline__ void load(const float* p, long long b, int w, T* x) {
  for (int k = 0; k < w; ++k) x[k] = cst<T>(p[b * w + k]);
}

__device__ __forceinline__ void load_dual(const float* p, const float* tp, long long b, int w,
                                          Dual* x) {
  for (int k = 0; k < w; ++k) x[k] = Dual{p[b * w + k], tp ? tp[b * w + k] : 0.0f};
}

__device__ __forceinline__ void store(float* p, long long b, int w, const float* x) {
  if (p) {
    for (int k = 0; k < w; ++k) p[b * w + k] = x[k];
  }
}

__global__ void __launch_bounds__(THREADS) recompute_kernel(Args a) {
  const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= a.B) return;
  float o[3], d[3], tr, pos[3], dpos[3], R[9], s[3];
  load(a.in[I_O], b, 3, o);
  load(a.in[I_D], b, 3, d);
  load(a.in[I_TR], b, 1, &tr);
  load(a.in[I_POS], b, 3, pos);
  load(a.in[I_DPOS], b, 3, dpos);
  load(a.in[I_ROT], b, 9, R);
  load(a.in[I_SCALE], b, 3, s);
  float t, n[3], lp[3], alpha = 0.0f;
  recompute(o, d, tr, pos, dpos, R, s, a.type[b], a.hit[b] != 0, a.soft, a.spheres != 0, t, n,
            lp, alpha);
  store(a.out[O_T], b, 1, &t);
  store(a.out[O_N], b, 3, n);
  store(a.out[O_LP], b, 3, lp);
  store(a.out[O_A], b, 1, &alpha);
}

__global__ void __launch_bounds__(THREADS) recompute_jvp_kernel(Args a) {
  const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= a.B) return;
  Dual o[3], d[3], tr, pos[3], dpos[3], R[9], s[3];
  load_dual(a.in[I_O], a.tan_in[I_O], b, 3, o);
  load_dual(a.in[I_D], a.tan_in[I_D], b, 3, d);
  load_dual(a.in[I_TR], a.tan_in[I_TR], b, 1, &tr);
  load_dual(a.in[I_POS], a.tan_in[I_POS], b, 3, pos);
  load_dual(a.in[I_DPOS], a.tan_in[I_DPOS], b, 3, dpos);
  load_dual(a.in[I_ROT], a.tan_in[I_ROT], b, 9, R);
  load_dual(a.in[I_SCALE], a.tan_in[I_SCALE], b, 3, s);
  Dual t, n[3], lp[3], alpha = cst<Dual>(0.0f);
  recompute(o, d, tr, pos, dpos, R, s, a.type[b], a.hit[b] != 0, a.soft, a.spheres != 0, t, n,
            lp, alpha);
  const float tt = t.d, tn[3] = {n[0].d, n[1].d, n[2].d}, tlp[3] = {lp[0].d, lp[1].d, lp[2].d},
              ta = alpha.d;
  store(a.out[O_T], b, 1, &tt);
  store(a.out[O_N], b, 3, tn);
  store(a.out[O_LP], b, 3, tlp);
  store(a.out[O_A], b, 1, &ta);
}

// The core's inputs as core_grad takes them: lo, ld, s, rel and d (rel and
// d reach the core directly only for soft spheres).
constexpr int CORE_IN = 15;

// Blocks of GRAD_THREADS, four resident an SM (16 warps, at most 128
// registers).  A build of the same code at 130 registers kept one
// block of 256 an SM and took 0.0543 ms against 0.0378 at the grad frame's
// first pop on an H100; blocks of 128 took less time than blocks of 256 at
// the same warps (chip_queue_ab.py --only backward_pops).
__global__ void __launch_bounds__(GRAD_THREADS, 4) recompute_grad_kernel(Args a) {
  const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= a.B) return;
  float o[3], d[3], tr, pos[3], dpos[3], R[9], s[3];
  load(a.in[I_O], b, 3, o);
  load(a.in[I_D], b, 3, d);
  load(a.in[I_TR], b, 1, &tr);
  load(a.in[I_POS], b, 3, pos);
  load(a.in[I_DPOS], b, 3, dpos);
  load(a.in[I_ROT], b, 9, R);
  load(a.in[I_SCALE], b, 3, s);
  float gt = 0.0f, gn[3] = {0.0f, 0.0f, 0.0f}, glp[3] = {0.0f, 0.0f, 0.0f}, ga = 0.0f;
  if (a.grad_out[O_T]) load(a.grad_out[O_T], b, 1, &gt);
  if (a.grad_out[O_N]) load(a.grad_out[O_N], b, 3, gn);
  if (a.grad_out[O_LP]) load(a.grad_out[O_LP], b, 3, glp);
  if (a.grad_out[O_A]) load(a.grad_out[O_A], b, 1, &ga);
  const int type = a.type[b];
  const bool hit = a.hit[b] != 0, spheres = a.spheres != 0;

  // the forward to the core's inputs, as recompute computes it
  const float omt = 1.0f - tr;
  float x[CORE_IN];  // lo, ld, s, rel, d
  float* rel = x + 9;
  for (int c = 0; c < 3; ++c) {
    rel[c] = (o[c] - pos[c]) + omt * dpos[c];
    x[12 + c] = d[c];
    x[6 + c] = s[c];
  }
  rot_t(R, rel, x);
  rot_t(R, d, x + 3);
  // normal = R nl: the local normal's gradient is R^T gn
  float gnl[3];
  rot_t(R, gn, gnl);

  // the core's reverse mode
  float g[CORE_IN], nl[3];
  core_grad(x, type, hit, a.soft, spheres, gt, gnl, glp, ga, g, nl);

  // around the core: lo = R^T rel, ld = R^T d, normal = R nl
  float g_rel[3], g_d[3], g_R[9];
  for (int j = 0; j < 3; ++j) {
    g_rel[j] = (R[3 * j] * g[0] + R[3 * j + 1] * g[1] + R[3 * j + 2] * g[2]) + g[9 + j];
    g_d[j] = (R[3 * j] * g[3] + R[3 * j + 1] * g[4] + R[3 * j + 2] * g[5]) + g[12 + j];
    for (int i = 0; i < 3; ++i) {
      g_R[3 * j + i] = (rel[j] * g[i] + d[j] * g[3 + i]) + gn[j] * nl[i];
    }
  }
  // rel = (o - position) + (1 - tr) delta_position
  float g_pos[3], g_dpos[3];
  float g_tr = 0.0f;
  for (int c = 0; c < 3; ++c) {
    g_pos[c] = -g_rel[c];
    g_dpos[c] = omt * g_rel[c];
    g_tr -= dpos[c] * g_rel[c];
  }
  store(a.grad_in[I_O], b, 3, g_rel);
  store(a.grad_in[I_D], b, 3, g_d);
  store(a.grad_in[I_TR], b, 1, &g_tr);
  store(a.grad_in[I_POS], b, 3, g_pos);
  store(a.grad_in[I_DPOS], b, 3, g_dpos);
  store(a.grad_in[I_ROT], b, 9, g_R);
  store(a.grad_in[I_SCALE], b, 3, g + 6);
}

Args args_of(const void* const* in, const void* hit, const void* type, long long B, float soft,
             int spheres) {
  Args a = {};
  for (int k = 0; k < N_IN; ++k) a.in[k] = static_cast<const float*>(in[k]);
  a.hit = static_cast<const unsigned char*>(hit);
  a.type = static_cast<const int*>(type);
  a.B = B;
  a.soft = soft;
  a.spheres = spheres;
  return a;
}

inline int blocks_of(long long B) { return (int)((B + THREADS - 1) / THREADS); }

}  // namespace

// The recompute of B lanes: in[7] the float inputs o, d (B, 3), time_ratio
// (B,), position, delta_position (B, 3), rotation (B, 3, 3), scale (B, 3);
// hit (B,) bool; obj_type (B,) int32; into out[4]: t (B,), normal, local_pos
// (B, 3) and alpha (B,) (null where soft is 0).  spheres: 1 for the
// isotropic coverage (sphere scenes), 0 for the local unit frame's.  Every
// array contiguous, as CUDA device pointers (host pointers in the host
// rehearsal).  Launches on `stream`, does not synchronise, returns
// cudaGetLastError().
extern "C" int rt_winner_recompute(const void* const* in, const void* hit, const void* obj_type,
                                   void* const* out, long long B, float soft, int spheres,
                                   void* stream) {
  if (B < 0) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  Args a = args_of(in, hit, obj_type, B, soft, spheres);
  for (int k = 0; k < N_OUT; ++k) a.out[k] = static_cast<float*>(out[k]);
  RT_LAUNCH(recompute_kernel, blocks_of(B), THREADS, static_cast<cudaStream_t>(stream), a);
  return static_cast<int>(cudaGetLastError());
}

// Forward-mode AD: tangents[7] the float inputs' tangents (each as its
// input, null: 0) -> out[4] the outputs' tangents (alpha's null where soft
// is 0).  The other arguments as rt_winner_recompute's.
extern "C" int rt_winner_recompute_jvp(const void* const* in, const void* hit,
                                       const void* obj_type, const void* const* tangents,
                                       void* const* out, long long B, float soft, int spheres,
                                       void* stream) {
  if (B < 0) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  Args a = args_of(in, hit, obj_type, B, soft, spheres);
  for (int k = 0; k < N_IN; ++k) a.tan_in[k] = static_cast<const float*>(tangents[k]);
  for (int k = 0; k < N_OUT; ++k) a.out[k] = static_cast<float*>(out[k]);
  RT_LAUNCH(recompute_jvp_kernel, blocks_of(B), THREADS, static_cast<cudaStream_t>(stream), a);
  return static_cast<int>(cudaGetLastError());
}

// Reverse-mode AD: grads[4] the outputs' gradients (each as its output,
// null: 0) -> grad_in[7] the float inputs' gradients (each as its input,
// written in full; null: not wanted).  The other arguments as
// rt_winner_recompute's.
extern "C" int rt_winner_recompute_grad(const void* const* in, const void* hit,
                                        const void* obj_type, const void* const* grads,
                                        void* const* grad_in, long long B, float soft,
                                        int spheres, void* stream) {
  if (B < 0) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  Args a = args_of(in, hit, obj_type, B, soft, spheres);
  for (int k = 0; k < N_OUT; ++k) a.grad_out[k] = static_cast<const float*>(grads[k]);
  for (int k = 0; k < N_IN; ++k) a.grad_in[k] = static_cast<float*>(grad_in[k]);
  RT_LAUNCH(recompute_grad_kernel, (int)((B + GRAD_THREADS - 1) / GRAD_THREADS), GRAD_THREADS,
            static_cast<cudaStream_t>(stream), a);
  return static_cast<int>(cudaGetLastError());
}
