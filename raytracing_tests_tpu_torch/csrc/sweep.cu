// First-generation sweeps over one scene table, for Hopper (sm_90a): the dense
// nearest hit, the dense nearest hit fused with the surrounding refractive
// index, the refractive-index containment sum, and the two-level grouped sweep.
//
// Replaces the TPU kernels of raytracing_tests_tpu/kernels/sweep.py:
// _nearest_kernel, _nearest_ri_kernel and _ri_kernel (launched by _run_sweep)
// and _grouped_nearest_ri_kernel (launched by sweep_grouped), in both modes:
// 'spheres' (world-space quadratic) and 'generic' (rotate by R^T, divide by
// scale, ellipsoid quadratic or cuboid slab by type, the dense intersector's
// arithmetic throughout).  The motion terms (1 - time_ratio) * delta_position
// are carried.
//
// What bounds them on this card: operations.  A ray moves 32 bytes in and 8 to
// 12 out and tests every row of the table (dense) or of every group whose box
// it enters (grouped): about 30 fp32 operations for a sphere row, over 100 for
// a generic row.  One thread per ray, rays in SoA rows so a warp's loads
// coalesce; the table is row-major with 16-byte-aligned rows, so the row all
// threads of a warp read at one step is one broadcast load per 16 bytes.  The
// TPU versions keep the table in scalar memory and broadcast a row against a
// 4096-ray block, skipping a group only when no ray of the block enters it;
// here each thread tests its own box and skips for itself.
#include "rt_common.cuh"

namespace {

using rt::BIG_T;

constexpr int S_COLS = 12;  // cx cy cz r2 | dpx dpy dpz valid | ri 0 0 0
constexpr int G_COLS = 24;  // px py pz r00 | r01 r02 r10 r11 | r12 r20 r21 r22 |
                            // sx sy sz dpx | dpy dpz type valid | ri 0 0 0
constexpr int GA8 = 8;      // group box row: lo xyz, hi xyz, 0 0
enum { MODE_SPHERES = 0, MODE_GENERIC = 1 };
// Work counters (measurement only): live rows tested by the hit pass and by
// the RI pass; dead and padding rows are not counted.
enum { SC_ROWS = 0, SC_RI_ROWS, SC_LEN };

struct Ray {
  float ox, oy, oz, dx, dy, dz, omt, tlim;
};

__device__ __forceinline__ Ray load_ray(const float* __restrict__ rays, int B, int i) {
  const size_t s = (size_t)B;
  Ray r;
  r.ox = rays[i];
  r.oy = rays[s + i];
  r.oz = rays[2 * s + i];
  r.dx = rays[3 * s + i];
  r.dy = rays[4 * s + i];
  r.dz = rays[5 * s + i];
  r.omt = rays[6 * s + i];
  r.tlim = rays[7 * s + i];
  return r;
}

// Nearest positive t of the sphere around the (motion-shifted) relative
// origin; a = |d|^2 (clamped), inv_a = 1 / a.
__device__ __forceinline__ float sphere_root(float rx, float ry, float rz,
                                             const Ray& R, float r2, float a,
                                             float inv_a, float valid) {
  const float half_b = rx * R.dx + ry * R.dy + rz * R.dz;
  const float c = rx * rx + ry * ry + rz * rz - r2;
  const float disc = half_b * half_b - a * c;
  if (!(disc > 0.0f && valid > 0.0f)) return BIG_T;
  const float sq = sqrtf(disc);
  const float t0 = (-half_b - sq) * inv_a;
  const float t1 = (-half_b + sq) * inv_a;
  const float t = (t0 > t1 || t0 < 0.0f) ? t1 : t0;
  return t > 0.0f ? t : BIG_T;
}

// Dense-sweep form: the shift is added to the relative origin.
__device__ __forceinline__ float sphere_t(const float* row, const Ray& R,
                                          float a, float inv_a) {
  const float4 c = rt::ld4(row);      // cx cy cz r2
  const float4 m = rt::ld4(row + 4);  // dpx dpy dpz valid
  const float rx = R.ox - c.x + R.omt * m.x;
  const float ry = R.oy - c.y + R.omt * m.y;
  const float rz = R.oz - c.z + R.omt * m.z;
  return sphere_root(rx, ry, rz, R, c.w, a, inv_a, m.w);
}

// Fused / grouped form: the centre is shifted first, and returned for the
// refractive-index query point.
__device__ __forceinline__ float sphere_t_centre(const float* row, const Ray& R,
                                                 float a, float inv_a, float& cx,
                                                 float& cy, float& cz) {
  const float4 c = rt::ld4(row);
  const float4 m = rt::ld4(row + 4);
  cx = c.x - R.omt * m.x;
  cy = c.y - R.omt * m.y;
  cz = c.z - R.omt * m.z;
  return sphere_root(R.ox - cx, R.oy - cy, R.oz - cz, R, c.w, a, inv_a, m.w);
}

// Generic row: R^T transform, then the primitive test of the row's type.
__device__ __forceinline__ float generic_t(const float* row, const Ray& R) {
  const float4 e = rt::ld4(row + 16);  // dpy dpz type valid
  if (!(e.w > 0.0f)) return BIG_T;
  const float4 a = rt::ld4(row);       // px py pz r00
  const float4 b = rt::ld4(row + 4);   // r01 r02 r10 r11
  const float4 c = rt::ld4(row + 8);   // r12 r20 r21 r22
  const float4 d = rt::ld4(row + 12);  // sx sy sz dpx
  const float rx = R.ox - a.x + R.omt * d.w;
  const float ry = R.oy - a.y + R.omt * e.x;
  const float rz = R.oz - a.z + R.omt * e.y;
  const float lox = a.w * rx + b.z * ry + c.y * rz;
  const float loy = b.x * rx + b.w * ry + c.z * rz;
  const float loz = b.y * rx + c.x * ry + c.w * rz;
  const float ldx = a.w * R.dx + b.z * R.dy + c.y * R.dz;
  const float ldy = b.x * R.dx + b.w * R.dy + c.z * R.dz;
  const float ldz = b.y * R.dx + c.x * R.dy + c.w * R.dz;
  if (e.z == rt::ELLIPSOID)
    return rt::ell_t_div(lox, loy, loz, ldx, ldy, ldz, d.x, d.y, d.z);
  if (e.z == rt::CUBOID)
    return rt::cub_t_div(lox, loy, loz, ldx, ldy, ldz, d.x, d.y, d.z);
  return BIG_T;
}

// Is the (motion-shifted) point inside the row's primitive?  Also gives the
// row's refractive index.
template <int MODE>
__device__ __forceinline__ bool contains(const float* row, float qx, float qy,
                                         float qz, float omt, float& ri) {
  if (MODE == MODE_SPHERES) {
    const float4 c = rt::ld4(row);
    const float4 m = rt::ld4(row + 4);
    ri = __ldg(row + 8);
    const float rx = qx - c.x + omt * m.x;
    const float ry = qy - c.y + omt * m.y;
    const float rz = qz - c.z + omt * m.z;
    return (rx * rx + ry * ry + rz * rz <= c.w) && (m.w > 0.0f);
  }
  const float4 e = rt::ld4(row + 16);
  ri = __ldg(row + 20);
  if (!(e.w > 0.0f)) return false;
  const float4 a = rt::ld4(row);
  const float4 b = rt::ld4(row + 4);
  const float4 c = rt::ld4(row + 8);
  const float4 d = rt::ld4(row + 12);
  const float rx = qx - a.x + omt * d.w;
  const float ry = qy - a.y + omt * e.x;
  const float rz = qz - a.z + omt * e.y;
  const float lox = (a.w * rx + b.z * ry + c.y * rz) / d.x;
  const float loy = (b.x * rx + b.w * ry + c.z * rz) / d.y;
  const float loz = (b.y * rx + c.x * ry + c.w * rz) / d.z;
  if (e.z == rt::ELLIPSOID) return lox * lox + loy * loy + loz * loz <= 1.0f;
  if (e.z == rt::CUBOID)
    return fabsf(lox) <= 0.5f && fabsf(loy) <= 0.5f && fabsf(loz) <= 0.5f;
  return false;
}

__device__ __forceinline__ float mean_ri(float acc, float cnt) {
  return acc > 1.0f ? acc / fmaxf(cnt, 1.0f) : 1.0f;
}

// The query point of the fused sweeps: 1e-3 along unit(hit - centre).
__device__ __forceinline__ void ri_query_point(const Ray& R, float t, float bcx,
                                               float bcy, float bcz, float& qx,
                                               float& qy, float& qz) {
  const float px = R.ox + t * R.dx, py = R.oy + t * R.dy, pz = R.oz + t * R.dz;
  const float nx = px - bcx, ny = py - bcy, nz = pz - bcz;
  const float inv_n = rsqrtf(fmaxf(nx * nx + ny * ny + nz * nz, 1e-30f));
  qx = px + 1e-3f * nx * inv_n;
  qy = py + 1e-3f * ny * inv_n;
  qz = pz + 1e-3f * nz * inv_n;
}

// ---- dense nearest hit ----------------------------------------------------
template <int MODE>
__global__ void __launch_bounds__(256) nearest_kernel(
    const float* __restrict__ table, int n_obj, const float* __restrict__ rays,
    int B, float* __restrict__ t_out, int* __restrict__ obj_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  const Ray R = load_ray(rays, B, i);
  const float a = fmaxf(R.dx * R.dx + R.dy * R.dy + R.dz * R.dz, 1e-30f);
  const float inv_a = 1.0f / a;
  float t_best = fminf(BIG_T, R.tlim);
  int obj = -1;
  for (int k = 0; k < n_obj; ++k) {
    const float t = MODE == MODE_SPHERES
                        ? sphere_t(table + (size_t)k * S_COLS, R, a, inv_a)
                        : generic_t(table + (size_t)k * G_COLS, R);
    if (t < t_best) {
      t_best = t;
      obj = k;
    }
  }
  t_out[i] = t_best;
  obj_out[i] = obj;
}

// ---- dense nearest hit + surrounding RI (sphere mode) -----------------------
__global__ void __launch_bounds__(256) nearest_ri_kernel(
    const float* __restrict__ table, int n_obj, const float* __restrict__ rays,
    int B, float* __restrict__ t_out, int* __restrict__ obj_out,
    float* __restrict__ ri_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  const Ray R = load_ray(rays, B, i);
  const float a = fmaxf(R.dx * R.dx + R.dy * R.dy + R.dz * R.dz, 1e-30f);
  const float inv_a = 1.0f / a;
  float t_best = fminf(BIG_T, R.tlim);
  int obj = -1;
  float bcx = 0.0f, bcy = 0.0f, bcz = 0.0f;
  for (int k = 0; k < n_obj; ++k) {
    float cx, cy, cz;
    const float t = sphere_t_centre(table + (size_t)k * S_COLS, R, a, inv_a, cx, cy, cz);
    if (t < t_best) {
      t_best = t;
      obj = k;
      bcx = cx;
      bcy = cy;
      bcz = cz;
    }
  }
  float qx, qy, qz;
  ri_query_point(R, t_best, bcx, bcy, bcz, qx, qy, qz);
  float acc = 0.0f, cnt = 0.0f;
  for (int k = 0; k < n_obj; ++k) {
    float ri;
    if (contains<MODE_SPHERES>(table + (size_t)k * S_COLS, qx, qy, qz, R.omt, ri)) {
      acc += ri;
      cnt += 1.0f;
    }
  }
  t_out[i] = t_best;
  obj_out[i] = obj;
  ri_out[i] = mean_ri(acc, cnt);
}

// ---- surrounding RI at given points -----------------------------------------
// Containers of refractive index exactly 1 are air and do not count.
template <int MODE>
__global__ void __launch_bounds__(256) ri_kernel(
    const float* __restrict__ table, int n_obj, const float* __restrict__ pts,
    int B, float* __restrict__ ri_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  const size_t s = (size_t)B;
  const float qx = pts[i], qy = pts[s + i], qz = pts[2 * s + i];
  const float omt = pts[3 * s + i];
  constexpr int COLS = MODE == MODE_SPHERES ? S_COLS : G_COLS;
  float acc = 0.0f, cnt = 0.0f;
  for (int k = 0; k < n_obj; ++k) {
    float ri;
    if (contains<MODE>(table + (size_t)k * COLS, qx, qy, qz, omt, ri) && ri != 1.0f) {
      acc += ri;
      cnt += 1.0f;
    }
  }
  ri_out[i] = mean_ri(acc, cnt);
}

// ---- two-level grouped sweep -------------------------------------------------
// Objects are Morton-ordered into groups of `group` rows behind per-group
// boxes; the fused RI pass (sphere mode) visits only groups whose box holds
// the query point.
template <int MODE, bool WITH_RI>
__global__ void __launch_bounds__(256) grouped_kernel(
    const float* __restrict__ table, const float* __restrict__ gaabb,
    int n_groups, int group, const float* __restrict__ rays, int B,
    float* __restrict__ t_out, int* __restrict__ obj_out,
    float* __restrict__ ri_out, unsigned long long* __restrict__ stats) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  const Ray R = load_ray(rays, B, i);
  const float a = fmaxf(R.dx * R.dx + R.dy * R.dy + R.dz * R.dz, 1e-30f);
  const float inv_a = 1.0f / a;
  const float ix = rt::safe_inv(R.dx), iy = rt::safe_inv(R.dy), iz = rt::safe_inv(R.dz);
  constexpr int COLS = MODE == MODE_SPHERES ? S_COLS : G_COLS;
  constexpr int VALID_COL = MODE == MODE_SPHERES ? 7 : 19;
  float t_best = fminf(BIG_T, R.tlim);
  int obj = -1;
  float bcx = 0.0f, bcy = 0.0f, bcz = 0.0f;
  unsigned n_rows = 0, n_ri_rows = 0;
  for (int g = 0; g < n_groups; ++g) {
    const float4 b0 = rt::ld4(gaabb + g * GA8);      // lo.x lo.y lo.z hi.x
    const float4 b1 = rt::ld4(gaabb + g * GA8 + 4);  // hi.y hi.z 0 0
    const float u1 = (b0.x - R.ox) * ix, w1 = (b0.w - R.ox) * ix;
    const float u2 = (b0.y - R.oy) * iy, w2 = (b1.x - R.oy) * iy;
    const float u3 = (b0.z - R.oz) * iz, w3 = (b1.y - R.oz) * iz;
    const float tmin = fmaxf(fmaxf(fminf(u1, w1), fminf(u2, w2)), fminf(u3, w3));
    const float tmax = fminf(fminf(fmaxf(u1, w1), fmaxf(u2, w2)), fmaxf(u3, w3));
    if (!((tmax > tmin) && (tmin < t_best))) continue;
    for (int j = 0; j < group; ++j) {
      const int k = g * group + j;
      const float* row = table + (size_t)k * COLS;
      if (stats != nullptr && __ldg(row + VALID_COL) > 0.0f) n_rows += 1;
      float t, cx = 0.0f, cy = 0.0f, cz = 0.0f;
      if (MODE == MODE_SPHERES)
        t = sphere_t_centre(row, R, a, inv_a, cx, cy, cz);
      else
        t = generic_t(row, R);
      if (t < t_best) {
        t_best = t;
        obj = k;
        bcx = cx;
        bcy = cy;
        bcz = cz;
      }
    }
  }
  t_out[i] = t_best;
  obj_out[i] = obj;
  float ri_res = 1.0f;
  if (WITH_RI) {
    float qx, qy, qz;
    ri_query_point(R, t_best, bcx, bcy, bcz, qx, qy, qz);
    float acc = 0.0f, cnt = 0.0f;
    for (int g = 0; g < n_groups; ++g) {
      const float4 b0 = rt::ld4(gaabb + g * GA8);
      const float4 b1 = rt::ld4(gaabb + g * GA8 + 4);
      const bool in_box = qx >= b0.x && qx <= b0.w && qy >= b0.y && qy <= b1.x &&
                          qz >= b0.z && qz <= b1.y;
      if (!in_box) continue;
      for (int j = 0; j < group; ++j) {
        float ri;
        const float* row = table + (size_t)(g * group + j) * S_COLS;
        if (stats != nullptr && __ldg(row + VALID_COL) > 0.0f) n_ri_rows += 1;
        if (contains<MODE_SPHERES>(row, qx, qy, qz, R.omt, ri)) {
          acc += ri;
          cnt += 1.0f;
        }
      }
    }
    ri_res = mean_ri(acc, cnt);
  }
  ri_out[i] = ri_res;
  if (stats != nullptr) {
    atomicAdd(stats + SC_ROWS, (unsigned long long)n_rows);
    if (WITH_RI) atomicAdd(stats + SC_RI_ROWS, (unsigned long long)n_ri_rows);
  }
}

inline int grid_for(int B, int threads) { return (B + threads - 1) / threads; }

}  // namespace

// Common conventions of the four entry points: `table` is (n_obj, 12) in mode
// 0 (spheres) or (n_obj, 24) in mode 1 (generic); `rays` is (8, B) rows ox oy
// oz dx dy dz omt tlim with omt = 1 - time_ratio; outputs are (B,); a miss
// gives obj = -1 and t = min(3e38, tlim).  Each launches on `stream`, does not
// synchronise and returns cudaGetLastError().

extern "C" int rt_sweep_nearest(const void* table, int n_obj, int mode,
                                const void* rays, int B, void* t_out,
                                void* obj_out, void* stream) {
  if (B <= 0) return 0;
  const float* tb = static_cast<const float*>(table);
  const float* r = static_cast<const float*>(rays);
  float* t = static_cast<float*>(t_out);
  int* o = static_cast<int*>(obj_out);
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  const int threads = 256, blocks = grid_for(B, threads);
  if (mode == MODE_SPHERES)
    RT_LAUNCH(nearest_kernel<MODE_SPHERES>, blocks, threads, cs, tb, n_obj, r, B, t, o);
  else
    RT_LAUNCH(nearest_kernel<MODE_GENERIC>, blocks, threads, cs, tb, n_obj, r, B, t, o);
  return static_cast<int>(cudaGetLastError());
}

// Sphere mode only; ri_out gains the surrounding refractive index 1e-3 outside
// the hit point (all rows count, as in the grouped sweep's fused pass).
extern "C" int rt_sweep_nearest_ri(const void* table, int n_obj,
                                   const void* rays, int B, void* t_out,
                                   void* obj_out, void* ri_out, void* stream) {
  if (B <= 0) return 0;
  const int threads = 256, blocks = grid_for(B, threads);
  RT_LAUNCH(nearest_ri_kernel, blocks, threads, static_cast<cudaStream_t>(stream),
            static_cast<const float*>(table), n_obj,
            static_cast<const float*>(rays), B, static_cast<float*>(t_out),
            static_cast<int*>(obj_out), static_cast<float*>(ri_out));
  return static_cast<int>(cudaGetLastError());
}

// pts: (4, B) rows px py pz omt; ri_out: mean refractive index of the
// containing rows whose index is not 1, when their sum exceeds 1, else 1.
extern "C" int rt_sweep_ri(const void* table, int n_obj, int mode,
                           const void* pts, int B, void* ri_out, void* stream) {
  if (B <= 0) return 0;
  const float* tb = static_cast<const float*>(table);
  const float* p = static_cast<const float*>(pts);
  float* ri = static_cast<float*>(ri_out);
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  const int threads = 256, blocks = grid_for(B, threads);
  if (mode == MODE_SPHERES)
    RT_LAUNCH(ri_kernel<MODE_SPHERES>, blocks, threads, cs, tb, n_obj, p, B, ri);
  else
    RT_LAUNCH(ri_kernel<MODE_GENERIC>, blocks, threads, cs, tb, n_obj, p, B, ri);
  return static_cast<int>(cudaGetLastError());
}

// gaabb: (n_groups, 8) rows lo xyz, hi xyz; the table holds n_groups * group
// rows.  with_ri (sphere mode only) fuses the refractive-index pass, else
// ri_out is 1.  stats: null, or uint64[2] that gains the live rows tested by
// the hit pass and by the RI pass (measurement only).
extern "C" int rt_sweep_grouped(const void* table, const void* gaabb,
                                int n_groups, int group, int mode, int with_ri,
                                const void* rays, int B, void* t_out,
                                void* obj_out, void* ri_out, void* stats,
                                void* stream) {
  if (B <= 0) return 0;
  if (with_ri && mode != MODE_SPHERES) return (int)cudaErrorInvalidValue;
  const float* tb = static_cast<const float*>(table);
  const float* ga = static_cast<const float*>(gaabb);
  const float* r = static_cast<const float*>(rays);
  float* t = static_cast<float*>(t_out);
  int* o = static_cast<int*>(obj_out);
  float* ri = static_cast<float*>(ri_out);
  unsigned long long* st = static_cast<unsigned long long*>(stats);
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  const int threads = 256, blocks = grid_for(B, threads);
  auto k = grouped_kernel<MODE_SPHERES, false>;
  if (mode == MODE_GENERIC)
    k = grouped_kernel<MODE_GENERIC, false>;
  else if (with_ri)
    k = grouped_kernel<MODE_SPHERES, true>;
  RT_LAUNCH(k, blocks, threads, cs, tb, ga, n_groups, group, r, B, t, o, ri, st);
  return static_cast<int>(cudaGetLastError());
}
