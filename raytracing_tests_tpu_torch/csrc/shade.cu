// The "bvh" shading of the queue renderers, one thread a lane, with its
// reverse-mode and its forward-mode derivative, for Hopper (sm_90a).
//
// Replaces no TPU kernel: it is the counterpart of the XLA fusion of the JAX
// package's shading, raytracing_tests_tpu/ops/render.py:410-591 (shade_rays,
// its "bvh" branch :519-591), which no pallas_call stands behind.  The port
// ran it as some two hundred PyTorch elementwise kernels a pop and their
// autograd backward (kernels/shade.py::shade_bvh_plain).
//
// The function, per lane (B of them), from the popped ray (o, d, contrib,
// bounced, active, sample index), its hit (hit, t, normal), the surrounding
// RI and the winner's material (colour, RI, refractivity, reflectivity,
// scatters), the soft-edge coverage alpha (the gradient path's soft edges)
// and, where the scene has lights, the winner's emissive flag and the share
// of lights its hit sees (lit):
//   the sky (black with lights) added where the lane missed, the soft blend,
//   the emissive abort and the light factor, bounced + 1, can_spawn; the
//   outer mirror direction normalised and deviated within its scatter cone
//   (sampling.deviate_within_cone, sunflower_disc inside it), the outer
//   refraction safe-normalised and deviated; the inner refraction and its
//   total-internal reflection; the spawn masks, the children's origins
//   1e-4 either side of the surface, directions and contributions; the
//   0.5-forward damping and the local term contrib * colour.
// Every operation is the plain version's, in its order and rounding: the
// sums over a vector's three components add (x0 + x2) + x1, as PyTorch's
// CUDA reduction over a contiguous last dimension of three does; a cross
// product's components round as PyTorch's CUDA cross kernel rounds them
// (`cross`); comparisons with a Python number compare with its float;
// sinf, cosf and sqrtf are the functions PyTorch's CUDA sin, cos and sqrt
// call.  So the -fmad=false build equals the plain version on the card.
//
// The forward and the tangent share one source of the math: `shade` and
// the helpers it calls are templates on the scalar, a float (shade_kernel,
// the forward) or a dual number (value and tangent; shade_jvp_kernel,
// forward-mode AD seeded with the inputs' tangents).  shade_grad_kernel is
// reverse-mode AD written by hand: it recomputes the forward in registers
// from the saved inputs (no per-lane intermediate is saved) and runs each
// step's adjoint in reverse order (`*_adj`).  Both follow autograd's rules:
// torch.where passes the selected branch's derivative, clamp_min all of it
// at or above its bound, and the comparisons, the masks, the sample index,
// bounced and lit are constants.
//
// Built with -fmad=false in every build (kernels/_build.py SOURCE_FLAGS):
// the children's directions feed the next pop's sweep, where a last ulp
// turns a grazing lane, and a fused a*b+c in the recompute (csrc/recompute.cu)
// moved the gradient step's loss by 3.7 %.
//
// What bounds them on this card: bytes (some 100 B a lane in and 80 B out
// for the forward, against a few hundred operations a lane).  None
// synchronises or reads on the host: each runs inside a gradient band's
// captured CUDA graph and the work queue's.
#include "rt_common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int GRAD_THREADS = 128;  // the backward's blocks
// sampling.GOLDEN_ANGLE: float32(PI) * (3 - sqrt(float32(5))), in float32
constexpr float GOLDEN = 2.39996314f;

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

__device__ __forceinline__ float tsqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ Dual tsqrt(Dual x) {
  const float r = sqrtf(x.v);
  return {r, x.d / (2.0f * r)};
}
// torch.clamp_min(x, lo): all of the tangent at or above the bound.
__device__ __forceinline__ float tclamp_min(float x, float lo) {
  return x != x ? x : (x > lo ? x : lo);
}
__device__ __forceinline__ Dual tclamp_min(Dual x, float lo) {
  return {tclamp_min(x.v, lo), x.v >= lo ? x.d : 0.0f};
}
// a * b + c rounded once (fmaf), and its tangent
__device__ __forceinline__ float tfma(float a, float b, float c) { return __fmaf_rn(a, b, c); }
__device__ __forceinline__ Dual tfma(Dual a, Dual b, Dual c) {
  return {__fmaf_rn(a.v, b.v, c.v), a.d * b.v + a.v * b.d + c.d};
}

// torch.sum over a contiguous last dimension of three: (x0 + x2) + x1.
template <class T>
__device__ __forceinline__ T dot3(const T a[3], const T b[3]) {
  const T p0 = a[0] * b[0], p1 = a[1] * b[1], p2 = a[2] * b[2];
  return (p0 + p2) + p1;
}

// One component a*b - c*d of torch.linalg.cross, rounded as its CUDA kernel
// (aten/src/ATen/native/cuda/CrossKernel.cu, nvcc's default contraction)
// rounds it: fma(a, b, -(c*d)), found on an H100 on 200 000 seeded rows.
template <class T>
__device__ __forceinline__ T cross_term(T a, T b, T c, T d) {
  return tfma(a, b, -(c * d));
}

template <class T>
__device__ __forceinline__ void cross(const T a[3], const T b[3], T out[3]) {
  out[0] = cross_term(a[1], b[2], a[2], b[1]);
  out[1] = cross_term(a[2], b[0], a[0], b[2]);
  out[2] = cross_term(a[0], b[1], a[1], b[0]);
}

// linalg.normalize(v, eps): v / sqrt(clamp_min(v . v, max(eps, 1e-38))).
template <class T>
__device__ __forceinline__ void normalize(T v[3], float eps) {
  const T s = tsqrt(tclamp_min(dot3(v, v), eps));
  for (int k = 0; k < 3; ++k) v[k] = v[k] / s;
}

// linalg.safe_normalize(v): v / sqrt(v . v) where v . v > 1e-20, else 0.
template <class T>
__device__ __forceinline__ void safe_normalize(T v[3]) {
  const T n2 = dot3(v, v);
  const bool ok = val(n2) > (float)1e-20;
  const T s = tsqrt(tclamp_min(n2, (float)1e-20));
  for (int k = 0; k < 3; ++k) v[k] = ok ? v[k] / s : cst<T>(0.0f);
}

// linalg.reflect(d, n) = d - 2 (d . n) n.
template <class T>
__device__ __forceinline__ void reflect(const T d[3], const T n[3], T out[3]) {
  const T k = dot3(d, n) * 2.0f;
  for (int i = 0; i < 3; ++i) out[i] = d[i] - k * n[i];
}

// linalg.refract(d, n, eta): 0 on total internal reflection (k < 0), the
// root only where k > 0.
template <class T>
__device__ __forceinline__ void refract(const T d[3], const T n[3], T eta, T out[3]) {
  const T cos_i = -dot3(d, n);
  const T k = 1.0f - (eta * eta) * (1.0f - cos_i * cos_i);
  const bool tir = val(k) < 0.0f;
  const T sk = val(k) > 0.0f ? tsqrt(k) : cst<T>(0.0f);
  const T w = eta * cos_i - sk;
  for (int i = 0; i < 3; ++i) out[i] = tir ? cst<T>(0.0f) : eta * d[i] + w * n[i];
}

// The sunflower lattice's constants of spp (sampling.sunflower_disc): n,
// n - b with b = round(2 sqrt(n)), and the radius's denominator.
struct Sun {
  float n, n_minus_b, denom;
};

__device__ __forceinline__ Sun sun_of(int spp) {
  Sun s;
  s.n = (float)spp;
  const float b = rintf(sqrtf(s.n) * 2.0f);
  s.n_minus_b = s.n - b;
  const float denom = s.n - (b + 1.0f) * 0.5f;
  s.denom = denom > 0.0f ? denom : 1.0f;
  return s;
}

// sunflower_disc's radius over its half aperture at sample i: 1 on the rim,
// sqrt(max(i - 0.5, 0) / denom) inside; and whether i is 0 (the centre).
__device__ __forceinline__ float sun_factor(float i, const Sun& s, bool& rim) {
  rim = i > s.n_minus_b;
  return rim ? 1.0f : sqrtf(tclamp_min(i - 0.5f, 0.0f) / s.denom);
}

// sampling.deviate_within_cone(dir, i, spp, tan) in place: a sunflower
// offset of diameter 2 tan in the plane of right = cross(dir, up) and
// up2 = cross(right, dir), scaled by 0.1, normalised.
template <class T>
__device__ __forceinline__ void deviate(T dir[3], float i, const Sun& s, T tan) {
  const T half_ap = (tan * 2.0f) * 0.5f;
  bool rim;
  const float f = sun_factor(i, s, rim);
  const T r = rim ? half_ap : half_ap * f;
  const float theta = i * GOLDEN;
  T off0 = r * cosf(theta), off1 = r * sinf(theta);
  if (i == 0.0f) off0 = off1 = cst<T>(0.0f);
  const T up[3] = {cst<T>(0.0f), cst<T>(1.0f), cst<T>(0.0f)};
  T right[3], up2[3];
  cross(dir, up, right);
  cross(right, dir, up2);
  T v[3];
  for (int k = 0; k < 3; ++k) v[k] = dir[k] + (off0 * right[k] + off1 * up2[k]) * 0.1f;
  normalize(v, (float)1e-38);
  for (int k = 0; k < 3; ++k) dir[k] = v[k];
}

// The per-lane float inputs (a pointer may be null where it has no tangent
// or gradient, or where the input is absent: alpha without soft edges).
enum { I_O, I_D, I_C, I_T, I_N, I_SRI, I_MC, I_MRI, I_RFR, I_RFL, I_SRFR, I_SRFL, I_A, N_IN };
__device__ constexpr int IN_W[N_IN] = {3, 3, 1, 1, 3, 1, 3, 1, 1, 1, 1, 1, 1};
// the float outputs
enum { O_ADD, O_RFR_O, O_RFR_D, O_RFR_C, O_RFL_O, O_RFL_D, O_RFL_C, O_HIT_T, N_OUT };
__device__ constexpr int OUT_W[N_OUT] = {3, 3, 3, 1, 3, 3, 1, 1};
// the mask outputs
enum { M_WHITE, M_DID_HIT, M_MISSED, M_SPAWN_RFR, M_SPAWN_RFL, N_MASK };

template <class T>
struct In {
  T o[3], d[3], c, t, n[3], sri, mc[3], mri, rfr, rfl, srfr, srfl, a;
};

template <class T>
struct Out {
  T add[3], refr_o[3], refr_d[3], refr_c, refl_o[3], refl_d[3], refl_c, hit_t;
};

// What a lane holds besides its float inputs (constants of the gradient).
struct Lane {
  float sidx, lit;
  int bounced;
  bool active, hit, emissive;
};

struct Statics {
  int spp, max_bounces, soft, lights;
  float t_max, bot[3], top[3];
};

struct Masks {
  bool m[N_MASK];
  int bounced;
};

// The shading of one lane (kernels/shade.py::shade_bvh_plain, step for
// step).
template <class T>
__device__ __forceinline__ void shade(const In<T>& x, const Lane& L, const Statics& s, Out<T>& y,
                                      Masks& f) {
  bool did_hit = L.hit && L.active;
  const bool missed = L.active && !L.hit;
  T bg[3];
  if (s.lights) {
    for (int k = 0; k < 3; ++k) bg[k] = cst<T>(0.0f);
  } else {
    const T tb = (x.d[1] + 1.0f) * 0.5f;
    for (int k = 0; k < 3; ++k) bg[k] = (1.0f - tb) * s.bot[k] + tb * s.top[k];
  }
  T add[3];
  for (int k = 0; k < 3; ++k) add[k] = missed ? x.c * bg[k] : cst<T>(0.0f);
  T c = x.c;
  if (s.soft) {  // the soft-edge blend: (1 - alpha) of the sky through
    const T q = c * (1.0f - x.a);
    for (int k = 0; k < 3; ++k) add[k] = add[k] + (did_hit ? q * bg[k] : cst<T>(0.0f));
    c = did_hit ? c * x.a : c;
  }
  T hp[3];
  for (int k = 0; k < 3; ++k) hp[k] = x.o[k] + x.t * x.d[k];
  const bool inner = val(dot3(x.n, x.d)) > 0.0f;
  bool white = false;
  if (s.lights) {  // the emissive abort and the light factor
    white = did_hit && L.emissive;
    did_hit = did_hit && !white;
    c = did_hit ? c * L.lit : c;
  }
  const int bounced1 = L.bounced + 1;
  const bool can_spawn = ((val(x.rfl) > (float)0.002) || (val(x.rfr) > (float)0.002)) &&
                         val(c) > (float)0.01 && bounced1 < s.max_bounces && did_hit;
  const Sun sun = sun_of(s.spp);

  // outer hit: the mirror and the refraction, each deviated within its cone
  T lo[3], ro[3];
  reflect(x.d, x.n, lo);
  normalize(lo, (float)1e-20);
  if (val(x.srfl) > (float)0.001) deviate(lo, L.sidx, sun, x.srfl);
  refract(x.d, x.n, x.sri / x.mri, ro);
  safe_normalize(ro);
  const bool live = val(dot3(ro, ro)) > (float)0.1;
  if (val(x.srfr) > (float)0.001 && live) deviate(ro, L.sidx, sun, x.srfr);
  if (!(val(x.rfl) > (float)0.002)) lo[0] = lo[1] = lo[2] = cst<T>(0.0f);
  if (!(val(x.rfr) > (float)0.002)) ro[0] = ro[1] = ro[2] = cst<T>(0.0f);

  // inner hit: the flipped normal, the refraction, the mirror on TIR
  T nin[3], ri[3], li[3];
  for (int k = 0; k < 3; ++k) nin[k] = -x.n[k];
  refract(x.d, nin, x.mri / x.sri, ri);
  if (val(dot3(ri, ri)) < (float)0.1) {
    reflect(x.d, nin, li);
  } else {
    li[0] = li[1] = li[2] = cst<T>(0.0f);
  }

  for (int k = 0; k < 3; ++k) {
    y.refr_d[k] = inner ? ri[k] : ro[k];
    y.refl_d[k] = inner ? li[k] : lo[k];
  }
  const bool spawn_refr = can_spawn && val(dot3(y.refr_d, y.refr_d)) > (float)0.1;
  const bool spawn_refl = can_spawn && val(dot3(y.refl_d, y.refl_d)) > (float)0.1;
  y.refr_c = c * x.rfr;
  y.refl_c = c * x.rfl;
  const T fwd = (spawn_refr ? x.rfr : cst<T>(0.0f)) + (spawn_refl ? x.rfl : cst<T>(0.0f));
  const T c2 = c * (1.0f - fwd * 0.5f);
  for (int k = 0; k < 3; ++k) {
    y.add[k] = add[k] + (did_hit ? c2 * x.mc[k] : cst<T>(0.0f));
    const T nout = inner ? nin[k] : x.n[k];
    y.refr_o[k] = hp[k] - nout * (float)1e-4;
    y.refl_o[k] = hp[k] + nout * (float)1e-4;
  }
  y.hit_t = L.hit ? x.t : cst<T>(s.t_max);
  f.m[M_WHITE] = white;
  f.m[M_DID_HIT] = did_hit;
  f.m[M_MISSED] = missed;
  f.m[M_SPAWN_RFR] = spawn_refr;
  f.m[M_SPAWN_RFL] = spawn_refl;
  f.bounced = bounced1;
}

// ---- the adjoints, each step's in reverse order ----------------------------
// Each takes the step's inputs (the forward is recomputed from them) and the
// gradient of its output, and adds the gradients of its inputs.

// cross(a, b): a gets b x g, b gets g x a (autograd's linalg_cross rule).
__device__ __forceinline__ void cross_adj(const float a[3], const float b[3], const float g[3],
                                          float ga[3], float gb[3]) {
  float u[3], w[3];
  cross(b, g, u);
  cross(g, a, w);
  for (int k = 0; k < 3; ++k) {
    ga[k] += u[k];
    gb[k] += w[k];
  }
}

// v / s with s = sqrt(clamp_min(v . v, eps)).
__device__ __forceinline__ void normalize_adj(const float v[3], float eps, const float g[3],
                                              float gv[3]) {
  const float n2 = dot3(v, v);
  const float s = sqrtf(tclamp_min(n2, eps));
  float gs = 0.0f;
  for (int k = 0; k < 3; ++k) {
    gv[k] += g[k] / s;
    gs -= g[k] * ((v[k] / s) / s);
  }
  const float gn2 = n2 >= eps ? gs / (2.0f * s) : 0.0f;
  for (int k = 0; k < 3; ++k) gv[k] += 2.0f * v[k] * gn2;
}

__device__ __forceinline__ void safe_normalize_adj(const float v[3], const float g[3],
                                                   float gv[3]) {
  if (dot3(v, v) > (float)1e-20) normalize_adj(v, (float)1e-20, g, gv);
}

__device__ __forceinline__ void reflect_adj(const float d[3], const float n[3], const float g[3],
                                            float gd[3], float gn[3]) {
  const float k = dot3(d, n) * 2.0f;
  const float gk = -dot3(g, n);
  const float gs = 2.0f * gk;
  for (int i = 0; i < 3; ++i) {
    gd[i] += g[i] + gs * n[i];
    gn[i] += -k * g[i] + gs * d[i];
  }
}

__device__ __forceinline__ void refract_adj(const float d[3], const float n[3], float eta,
                                            const float g[3], float gd[3], float gn[3],
                                            float& geta) {
  const float cos_i = -dot3(d, n);
  const float u = 1.0f - cos_i * cos_i;
  const float ee = eta * eta;
  const float k = 1.0f - ee * u;
  if (k < 0.0f) return;  // the zero of total internal reflection
  const float sk = k > 0.0f ? sqrtf(k) : 0.0f;
  const float w = eta * cos_i - sk;
  const float gw = dot3(g, n);
  float gcos = gw * eta;
  geta += dot3(g, d) + gw * cos_i;
  const float gk = k > 0.0f ? -gw / (2.0f * sk) : 0.0f;
  geta += 2.0f * eta * (-gk * u);
  gcos += 2.0f * cos_i * (gk * ee);
  for (int i = 0; i < 3; ++i) {
    gd[i] += eta * g[i] - gcos * n[i];
    gn[i] += w * g[i] - gcos * d[i];
  }
}

// deviate(dir, i, spp, tan) from its input dir: dir and tan get theirs.
__device__ __forceinline__ void deviate_adj(const float dir[3], float i, const Sun& s, float tan,
                                            const float g[3], float gdir[3], float& gtan) {
  const float half_ap = (tan * 2.0f) * 0.5f;
  bool rim;
  const float f = sun_factor(i, s, rim);
  const float r = rim ? half_ap : half_ap * f;
  const float theta = i * GOLDEN;
  const float cth = cosf(theta), sth = sinf(theta);
  float off0 = r * cth, off1 = r * sth;
  if (i == 0.0f) off0 = off1 = 0.0f;
  const float up[3] = {0.0f, 1.0f, 0.0f};
  float right[3], up2[3], v[3];
  cross(dir, up, right);
  cross(right, dir, up2);
  for (int k = 0; k < 3; ++k) v[k] = dir[k] + (off0 * right[k] + off1 * up2[k]) * 0.1f;
  float gv[3] = {0.0f, 0.0f, 0.0f};
  normalize_adj(v, (float)1e-38, g, gv);
  float gw[3], gright[3], gup2[3], gup[3] = {0.0f, 0.0f, 0.0f};
  for (int k = 0; k < 3; ++k) {
    gdir[k] += gv[k];
    gw[k] = gv[k] * 0.1f;
    gright[k] = off0 * gw[k];
    gup2[k] = off1 * gw[k];
  }
  const float goff0 = dot3(gw, right), goff1 = dot3(gw, up2);
  cross_adj(right, dir, gup2, gright, gdir);
  cross_adj(dir, up, gright, gdir, gup);
  if (i != 0.0f) {
    const float gr = goff0 * cth + goff1 * sth;
    const float ghalf = rim ? gr : gr * f;
    gtan += (ghalf * 0.5f) * 2.0f;
  }
}

struct Args {
  const float* in[N_IN];      // the float inputs, (B, width); alpha null without soft edges
  const float* sidx;          // (B,) the sample index
  const float* lit;           // (B,) the share of lights seen (null without lights)
  const int* bounced;         // (B,) int32
  const unsigned char* active;    // (B,) bool
  const unsigned char* hit;       // (B,) bool
  const unsigned char* emissive;  // (B,) bool (null without lights)
  const float* tan_in[N_IN];      // shade_jvp: the inputs' tangents, null: 0
  const float* grad_out[N_OUT];   // shade_grad: the outputs' gradients, null: 0
  float* out[N_OUT];              // the outputs (forward) or their tangents (jvp)
  unsigned char* mask_out[N_MASK];  // the forward's masks
  int* bounced_out;                 // the forward's bounced + 1
  float* grad_in[N_IN];             // shade_grad: the inputs' gradients, null: not wanted
  long long B;
  Statics s;
};

template <class T>
__device__ __forceinline__ void load(const float* p, const float* tp, long long b, int w, T* x);
template <>
__device__ __forceinline__ void load<float>(const float* p, const float*, long long b, int w,
                                            float* x) {
  for (int k = 0; k < w; ++k) x[k] = p ? p[b * w + k] : 0.0f;
}
template <>
__device__ __forceinline__ void load<Dual>(const float* p, const float* tp, long long b, int w,
                                           Dual* x) {
  for (int k = 0; k < w; ++k) x[k] = Dual{p ? p[b * w + k] : 0.0f, tp ? tp[b * w + k] : 0.0f};
}

template <class T>
__device__ __forceinline__ void load_in(const Args& a, long long b, In<T>& x) {
  T* dst[N_IN] = {x.o, x.d, &x.c, &x.t, x.n, &x.sri, x.mc, &x.mri, &x.rfr, &x.rfl, &x.srfr,
                  &x.srfl, &x.a};
#pragma unroll
  for (int k = 0; k < N_IN; ++k) load<T>(a.in[k], a.tan_in[k], b, IN_W[k], dst[k]);
}

__device__ __forceinline__ Lane load_lane(const Args& a, long long b) {
  Lane L;
  L.sidx = a.sidx[b];
  L.lit = a.lit ? a.lit[b] : 1.0f;
  L.bounced = a.bounced[b];
  L.active = a.active[b] != 0;
  L.hit = a.hit[b] != 0;
  L.emissive = a.emissive ? a.emissive[b] != 0 : false;
  return L;
}

__device__ __forceinline__ void store(float* p, long long b, int w, const float* x) {
  if (p) {
    for (int k = 0; k < w; ++k) p[b * w + k] = x[k];
  }
}

template <class T>
__device__ __forceinline__ void outputs_of(const Out<T>& y, const T* dst[N_OUT]) {
  dst[O_ADD] = y.add;
  dst[O_RFR_O] = y.refr_o;
  dst[O_RFR_D] = y.refr_d;
  dst[O_RFR_C] = &y.refr_c;
  dst[O_RFL_O] = y.refl_o;
  dst[O_RFL_D] = y.refl_d;
  dst[O_RFL_C] = &y.refl_c;
  dst[O_HIT_T] = &y.hit_t;
}

__global__ void __launch_bounds__(THREADS) shade_kernel(Args a) {
  const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= a.B) return;
  In<float> x;
  load_in(a, b, x);
  Out<float> y;
  Masks f;
  shade(x, load_lane(a, b), a.s, y, f);
  const float* src[N_OUT];
  outputs_of(y, src);
#pragma unroll
  for (int k = 0; k < N_OUT; ++k) store(a.out[k], b, OUT_W[k], src[k]);
  for (int k = 0; k < N_MASK; ++k) a.mask_out[k][b] = f.m[k] ? 1 : 0;
  a.bounced_out[b] = f.bounced;
}

__global__ void __launch_bounds__(THREADS) shade_jvp_kernel(Args a) {
  const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= a.B) return;
  In<Dual> x;
  load_in(a, b, x);
  Out<Dual> y;
  Masks f;
  shade(x, load_lane(a, b), a.s, y, f);
  const Dual* src[N_OUT];
  outputs_of(y, src);
#pragma unroll
  for (int k = 0; k < N_OUT; ++k) {
    float t[3];
    for (int i = 0; i < OUT_W[k]; ++i) t[i] = src[k][i].d;
    store(a.out[k], b, OUT_W[k], t);
  }
}

// The reverse mode: the forward recomputed in registers, then every step's
// adjoint in reverse order.  Blocks of GRAD_THREADS, five resident an SM
// (20 warps, at most 102 registers) where blocks of 256 at 104 registers
// kept 16: more warps hide more of each lane's chain of dependent arithmetic
// (chip_queue_ab.py --only backward_pops).
__global__ void __launch_bounds__(GRAD_THREADS, 5) shade_grad_kernel(Args a) {
  const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= a.B) return;
  const Statics& s = a.s;
  In<float> x;
  load_in(a, b, x);
  const Lane L = load_lane(a, b);
  float g_add[3], g_rfr_o[3], g_rfr_d[3], g_rfr_c, g_rfl_o[3], g_rfl_d[3], g_rfl_c, g_hit_t;
  {
    float* dst[N_OUT] = {g_add, g_rfr_o, g_rfr_d, &g_rfr_c, g_rfl_o, g_rfl_d, &g_rfl_c, &g_hit_t};
#pragma unroll
    for (int k = 0; k < N_OUT; ++k) load<float>(a.grad_out[k], nullptr, b, OUT_W[k], dst[k]);
  }

  // ---- the forward, every value the adjoint reads -------------------------
  const bool hit0 = L.hit && L.active, missed = L.active && !L.hit;
  float bg[3] = {0.0f, 0.0f, 0.0f};
  if (!s.lights) {
    const float tb = (x.d[1] + 1.0f) * 0.5f;
    for (int k = 0; k < 3; ++k) bg[k] = (1.0f - tb) * s.bot[k] + tb * s.top[k];
  }
  float c = x.c;  // the contribution after the soft blend and the light factor
  if (s.soft) c = hit0 ? c * x.a : c;
  const bool inner = dot3(x.n, x.d) > 0.0f;
  bool did_hit = hit0;
  if (s.lights) {
    did_hit = did_hit && !L.emissive;
    c = did_hit ? c * L.lit : c;
  }
  const bool can_spawn = (x.rfl > (float)0.002 || x.rfr > (float)0.002) && c > (float)0.01 &&
                         L.bounced + 1 < s.max_bounces && did_hit;
  const Sun sun = sun_of(s.spp);
  const bool keep_l = x.rfl > (float)0.002, keep_r = x.rfr > (float)0.002;
  float lo0[3], lo1[3], rf[3], ro1[3], ro[3], lo[3];
  reflect(x.d, x.n, lo0);
  for (int k = 0; k < 3; ++k) lo1[k] = lo0[k];
  normalize(lo1, (float)1e-20);
  for (int k = 0; k < 3; ++k) lo[k] = lo1[k];
  const bool dev_l = x.srfl > (float)0.001;
  if (dev_l) deviate(lo, L.sidx, sun, x.srfl);
  const float eta_o = x.sri / x.mri;
  refract(x.d, x.n, eta_o, rf);
  for (int k = 0; k < 3; ++k) ro1[k] = rf[k];
  safe_normalize(ro1);
  for (int k = 0; k < 3; ++k) ro[k] = ro1[k];
  const bool dev_r = x.srfr > (float)0.001 && dot3(ro1, ro1) > (float)0.1;
  if (dev_r) deviate(ro, L.sidx, sun, x.srfr);
  if (!keep_l) lo[0] = lo[1] = lo[2] = 0.0f;
  if (!keep_r) ro[0] = ro[1] = ro[2] = 0.0f;
  float nin[3], ri[3], li[3] = {0.0f, 0.0f, 0.0f};
  for (int k = 0; k < 3; ++k) nin[k] = -x.n[k];
  const float eta_i = x.mri / x.sri;
  refract(x.d, nin, eta_i, ri);
  const bool tir = dot3(ri, ri) < (float)0.1;
  if (tir) reflect(x.d, nin, li);
  float rdr[3], rdl[3];
  for (int k = 0; k < 3; ++k) {
    rdr[k] = inner ? ri[k] : ro[k];
    rdl[k] = inner ? li[k] : lo[k];
  }
  const bool spawn_refr = can_spawn && dot3(rdr, rdr) > (float)0.1;
  const bool spawn_refl = can_spawn && dot3(rdl, rdl) > (float)0.1;
  const float fwd = (spawn_refr ? x.rfr : 0.0f) + (spawn_refl ? x.rfl : 0.0f);
  const float damp = 1.0f - fwd * 0.5f;
  const float c2 = c * damp;

  // ---- the adjoint -----------------------------------------------------------
  float g_o[3] = {0.0f, 0.0f, 0.0f}, g_d[3] = {0.0f, 0.0f, 0.0f}, g_n[3] = {0.0f, 0.0f, 0.0f};
  float g_mc[3] = {0.0f, 0.0f, 0.0f}, g_hp[3];
  float g_c = 0.0f, g_c0 = 0.0f, g_t = 0.0f, g_sri = 0.0f, g_mri = 0.0f, g_rfr = 0.0f;
  float g_rfl = 0.0f, g_srfr = 0.0f, g_srfl = 0.0f, g_a = 0.0f;
  // hit_t = hit ? t : t_max
  if (L.hit) g_t += g_hit_t;
  // the children's origins: hp -/+ 1e-4 nout, nout = inner ? -n : n
  for (int k = 0; k < 3; ++k) {
    g_hp[k] = g_rfr_o[k] + g_rfl_o[k];
    const float g_nout = g_rfl_o[k] * (float)1e-4 - g_rfr_o[k] * (float)1e-4;
    g_n[k] += inner ? -g_nout : g_nout;
  }
  // the local term: add += did_hit ? c2 mc : 0; c2 = c (1 - 0.5 fwd)
  if (did_hit) {
    const float g_c2 = dot3(g_add, x.mc);
    for (int k = 0; k < 3; ++k) g_mc[k] = c2 * g_add[k];
    g_c += g_c2 * damp;
    const float g_fwd = -(g_c2 * c) * 0.5f;
    if (spawn_refr) g_rfr += g_fwd;
    if (spawn_refl) g_rfl += g_fwd;
  }
  // the children's contributions
  g_c += g_rfr_c * x.rfr + g_rfl_c * x.rfl;
  g_rfr += g_rfr_c * c;
  g_rfl += g_rfl_c * c;
  // the directions: the inner branch's or the outer's
  if (inner) {
    float g_nin[3] = {0.0f, 0.0f, 0.0f}, g_eta = 0.0f;
    if (tir) reflect_adj(x.d, nin, g_rfl_d, g_d, g_nin);
    refract_adj(x.d, nin, eta_i, g_rfr_d, g_d, g_nin, g_eta);
    for (int k = 0; k < 3; ++k) g_n[k] -= g_nin[k];
    g_mri += g_eta / x.sri;
    g_sri -= g_eta * (eta_i / x.sri);
  } else {
    float g_ro1[3] = {0.0f, 0.0f, 0.0f}, g_rf[3] = {0.0f, 0.0f, 0.0f};
    float g_lo1[3] = {0.0f, 0.0f, 0.0f}, g_lo0[3] = {0.0f, 0.0f, 0.0f}, g_eta = 0.0f;
    if (keep_r) {
      if (dev_r) {
        deviate_adj(ro1, L.sidx, sun, x.srfr, g_rfr_d, g_ro1, g_srfr);
      } else {
        for (int k = 0; k < 3; ++k) g_ro1[k] = g_rfr_d[k];
      }
    }
    safe_normalize_adj(rf, g_ro1, g_rf);
    refract_adj(x.d, x.n, eta_o, g_rf, g_d, g_n, g_eta);
    g_sri += g_eta / x.mri;
    g_mri -= g_eta * (eta_o / x.mri);
    if (keep_l) {
      if (dev_l) {
        deviate_adj(lo1, L.sidx, sun, x.srfl, g_rfl_d, g_lo1, g_srfl);
      } else {
        for (int k = 0; k < 3; ++k) g_lo1[k] = g_rfl_d[k];
      }
    }
    normalize_adj(lo0, (float)1e-20, g_lo1, g_lo0);
    reflect_adj(x.d, x.n, g_lo0, g_d, g_n);
  }
  // the light factor: c = did_hit ? c lit : c
  if (s.lights && did_hit) g_c *= L.lit;
  // the hit point: hp = o + t d
  for (int k = 0; k < 3; ++k) {
    g_o[k] += g_hp[k];
    g_d[k] += x.t * g_hp[k];
  }
  g_t += dot3(g_hp, x.d);
  float g_bg[3] = {0.0f, 0.0f, 0.0f};
  if (s.soft) {
    // c = hit0 ? c0 alpha : c0; add += hit0 ? c0 (1 - alpha) bg : 0
    if (hit0) {
      g_c0 += g_c * x.a;
      g_a += g_c * x.c;
      const float q = x.c * (1.0f - x.a), g_q = dot3(g_add, bg);
      for (int k = 0; k < 3; ++k) g_bg[k] += q * g_add[k];
      g_c0 += g_q * (1.0f - x.a);
      g_a -= g_q * x.c;
    } else {
      g_c0 += g_c;
    }
  } else {
    g_c0 += g_c;
  }
  // the sky where the lane missed: add = missed ? c0 bg : 0
  if (missed) {
    g_c0 += dot3(g_add, bg);
    for (int k = 0; k < 3; ++k) g_bg[k] += x.c * g_add[k];
  }
  if (!s.lights) {  // bg = (1 - tb) bot + tb top, tb = (d_y + 1) / 2
    float g_tb = 0.0f;
    for (int k = 0; k < 3; ++k) g_tb += g_bg[k] * s.top[k] - g_bg[k] * s.bot[k];
    g_d[1] += g_tb * 0.5f;
  }
  store(a.grad_in[I_O], b, 3, g_o);
  store(a.grad_in[I_D], b, 3, g_d);
  store(a.grad_in[I_C], b, 1, &g_c0);
  store(a.grad_in[I_T], b, 1, &g_t);
  store(a.grad_in[I_N], b, 3, g_n);
  store(a.grad_in[I_SRI], b, 1, &g_sri);
  store(a.grad_in[I_MC], b, 3, g_mc);
  store(a.grad_in[I_MRI], b, 1, &g_mri);
  store(a.grad_in[I_RFR], b, 1, &g_rfr);
  store(a.grad_in[I_RFL], b, 1, &g_rfl);
  store(a.grad_in[I_SRFR], b, 1, &g_srfr);
  store(a.grad_in[I_SRFL], b, 1, &g_srfl);
  store(a.grad_in[I_A], b, 1, &g_a);
}

Args args_of(const void* const* in, const void* const* other, long long B, const int* ints,
             const float* floats) {
  Args a = {};
  for (int k = 0; k < N_IN; ++k) a.in[k] = static_cast<const float*>(in[k]);
  a.sidx = static_cast<const float*>(other[0]);
  a.lit = static_cast<const float*>(other[1]);
  a.bounced = static_cast<const int*>(other[2]);
  a.active = static_cast<const unsigned char*>(other[3]);
  a.hit = static_cast<const unsigned char*>(other[4]);
  a.emissive = static_cast<const unsigned char*>(other[5]);
  a.B = B;
  a.s.spp = ints[0];
  a.s.max_bounces = ints[1];
  a.s.soft = a.in[I_A] != nullptr;
  a.s.lights = a.lit != nullptr;
  a.s.t_max = floats[0];
  for (int k = 0; k < 3; ++k) {
    a.s.bot[k] = floats[1 + k];
    a.s.top[k] = floats[4 + k];
  }
  return a;
}

inline int blocks_of(long long B) { return (int)((B + THREADS - 1) / THREADS); }

}  // namespace

// The shading of B lanes: in[13] the float inputs o, d (B, 3), contrib, t
// (B,), normal (B, 3), sur_ri (B,), mat_color (B, 3), mat_ri,
// refractivity, reflectivity, scat_rfr, scat_rfl and soft_alpha (B,; null
// without soft edges); other[6]: sample_idx (B,) float, lit (B,) float
// (null without lights), bounced (B,) int32, active, hit and emissive (B,)
// bool (emissive null without lights); into out[8]: add_color, refr_o,
// refr_d (B, 3), refr_contrib (B,), refl_o, refl_d (B, 3), refl_contrib,
// hit_t (B,), masks[5]: set_white, did_hit, missed, refr_mask, refl_mask (B,)
// bool, and bounced_out (B,) int32.  ints[2] = spp, max_bounces;
// floats[7] = t_max, the sky's bottom and top colours (host memory).
// Every array contiguous, as CUDA device pointers (host pointers in the
// host rehearsal).  Launches on `stream`, does not synchronise, returns
// cudaGetLastError().
extern "C" int rt_shade_bvh(const void* const* in, const void* const* other, void* const* out,
                            void* const* masks, void* bounced_out, long long B, const int* ints,
                            const float* floats, void* stream) {
  if (B < 0) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  Args a = args_of(in, other, B, ints, floats);
  for (int k = 0; k < N_OUT; ++k) a.out[k] = static_cast<float*>(out[k]);
  for (int k = 0; k < N_MASK; ++k) a.mask_out[k] = static_cast<unsigned char*>(masks[k]);
  a.bounced_out = static_cast<int*>(bounced_out);
  RT_LAUNCH(shade_kernel, blocks_of(B), THREADS, static_cast<cudaStream_t>(stream), a);
  return static_cast<int>(cudaGetLastError());
}

// Forward-mode AD: tangents[13] the float inputs' tangents (each as its
// input, null: 0) -> out[8] the float outputs' tangents.  The other
// arguments as rt_shade_bvh's.
extern "C" int rt_shade_bvh_jvp(const void* const* in, const void* const* other,
                                const void* const* tangents, void* const* out, long long B,
                                const int* ints, const float* floats, void* stream) {
  if (B < 0) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  Args a = args_of(in, other, B, ints, floats);
  for (int k = 0; k < N_IN; ++k) a.tan_in[k] = static_cast<const float*>(tangents[k]);
  for (int k = 0; k < N_OUT; ++k) a.out[k] = static_cast<float*>(out[k]);
  RT_LAUNCH(shade_jvp_kernel, blocks_of(B), THREADS, static_cast<cudaStream_t>(stream), a);
  return static_cast<int>(cudaGetLastError());
}

// Reverse-mode AD: grads[8] the float outputs' gradients (each as its
// output, null: 0) -> grad_in[13] the float inputs' gradients (each as its
// input, written in full; null: not wanted).  The other arguments as
// rt_shade_bvh's.
extern "C" int rt_shade_bvh_grad(const void* const* in, const void* const* other,
                                 const void* const* grads, void* const* grad_in, long long B,
                                 const int* ints, const float* floats, void* stream) {
  if (B < 0) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  Args a = args_of(in, other, B, ints, floats);
  for (int k = 0; k < N_OUT; ++k) a.grad_out[k] = static_cast<const float*>(grads[k]);
  for (int k = 0; k < N_IN; ++k) a.grad_in[k] = static_cast<float*>(grad_in[k]);
  RT_LAUNCH(shade_grad_kernel, (int)((B + GRAD_THREADS - 1) / GRAD_THREADS), GRAD_THREADS,
            static_cast<cudaStream_t>(stream), a);
  return static_cast<int>(cudaGetLastError());
}
