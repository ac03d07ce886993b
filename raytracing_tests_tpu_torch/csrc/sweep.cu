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
// a generic row.  Rays in SoA rows so a warp's loads coalesce; the table is
// row-major with 16-byte-aligned rows.  The TPU versions keep the table in
// scalar memory and broadcast a row against a 4096-ray block, skipping a group
// only when no ray of the block enters it.
//
//   - The dense nearest hit and the RI sum (nearest_kernel, ri_kernel): one
//     thread per ray reads every row through the read-only path.
//   - The fused dense sweep (nearest_ri_kernel): the block stages the table in
//     shared memory (cp.async, whole or in two alternating stages) and reads
//     rows as broadcasts; K lanes share a ray (the wrapper picks K so that a
//     small batch still fills the card), each taking rows j = sub (mod K).
//   - The grouped sweep (grouped_kernel) runs on the warp sweep of
//     warp_sweep.cuh: each lane tests its own box, a group that at least
//     coop_min lanes entered is walked per lane, one that fewer entered is
//     swept row-parallel for each of them; rows past the group's last live row
//     are never read.  Its fused RI pass is row-parallel in the same way and
//     sums in row order.
// Every schedule gives the per-thread loop's outputs bit for bit (-fmad=false):
// the per-row expression is the same, the (t, row) minimum keeps the lowest row
// of the least t as the strict-< scan does, and every RI sum is taken in
// ascending row order.
#include "rt_common.cuh"
#include "warp_sweep.cuh"

namespace {

using rt::BIG_T;

constexpr int S_COLS = 12;  // cx cy cz r2 | dpx dpy dpz valid | ri 0 0 0
constexpr int G_COLS = 24;  // px py pz r00 | r01 r02 r10 r11 | r12 r20 r21 r22 |
                            // sx sy sz dpx | dpy dpz type valid | ri 0 0 0
constexpr int GA8 = 8;      // group box row: lo xyz, hi xyz, 0 0
enum { MODE_SPHERES = 0, MODE_GENERIC = 1 };
// Work counters of the grouped sweep (measurement only): live rows tested by
// the hit pass and by the RI pass (dead and padding rows are not counted); the
// hit pass's lane slots and row-parallel group visits; the same for the RI
// pass.  SIMT efficiency = rows / slots.
enum { SC_ROWS = 0, SC_RI_ROWS, SC_SLOTS, SC_COOP, SC_RI_SLOTS, SC_RI_COOP, SC_LEN };

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
// `c`, `m`: the row's first two 16-byte words (cx cy cz r2 | dpx dpy dpz valid).
__device__ __forceinline__ float sphere_t_shifted(float4 c, float4 m, const Ray& R,
                                                  float a, float inv_a, float& cx,
                                                  float& cy, float& cz) {
  cx = c.x - R.omt * m.x;
  cy = c.y - R.omt * m.y;
  cz = c.z - R.omt * m.z;
  return sphere_root(R.ox - cx, R.oy - cy, R.oz - cz, R, c.w, a, inv_a, m.w);
}

__device__ __forceinline__ float sphere_t_centre(const float* row, const Ray& R,
                                                 float a, float inv_a, float& cx,
                                                 float& cy, float& cz) {
  return sphere_t_shifted(rt::ld4(row), rt::ld4(row + 4), R, a, inv_a, cx, cy, cz);
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
// The block stages the table in shared memory and K lanes (K | 32) share a
// ray, lane `sub` taking rows j = sub (mod K).  A table of at most
// NRI_WHOLE_ROWS rows is staged once and read by both passes; a longer one
// streams through two stages of NRI_STAGE_ROWS rows (the next stage's copy in
// flight while the current one is read), once per pass.
constexpr int NRI_THREADS = 256;
constexpr int NRI_WHOLE_ROWS = 512;  // 24 KiB
constexpr int NRI_STAGE_ROWS = 256;  // two stages: 24 KiB

__device__ __forceinline__ int imin(int x, int y) { return x < y ? x : y; }

// 16 bytes from global to shared memory without passing through registers
// (cp.async); the host rehearsal copies directly.
__device__ __forceinline__ void copy16(float4* dst, const float4* src) {
#ifdef RT_HOST_REHEARSAL
  *dst = *src;
#else
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(__cvta_generic_to_global(src)));
#endif
}

// Waits until at most N of this thread's committed copy groups are in flight.
template <int N>
__device__ __forceinline__ void copies_wait() {
#ifndef RT_HOST_REHEARSAL
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
#endif
}

// The block copies n_rows sphere rows from `src` to `dst` as one copy group.
__device__ __forceinline__ void stage_rows(float* dst, const float* src, int n_rows) {
  const int n16 = n_rows * (S_COLS / 4);
  float4* d = reinterpret_cast<float4*>(dst);
  const float4* s = reinterpret_cast<const float4*>(src);
  for (int q = threadIdx.x; q < n16; q += blockDim.x) copy16(d + q, s + q);
#ifndef RT_HOST_REHEARSAL
  asm volatile("cp.async.commit_group;\n" ::);
#endif
}

// f(rows in shared memory, index of their first row, count) over the table:
// at once where it was staged whole, else stage by stage.  Every thread of the
// block calls it together.
template <class F>
__device__ __forceinline__ void over_rows(float* smem, const float* table, int n_obj,
                                          bool whole, F&& f) {
  if (whole) {
    f(smem, 0, n_obj);
    return;
  }
  const int n_stages = (n_obj + NRI_STAGE_ROWS - 1) / NRI_STAGE_ROWS;
  stage_rows(smem, table, NRI_STAGE_ROWS);
  for (int k = 0; k < n_stages; ++k) {
    const int base = k * NRI_STAGE_ROWS;
    if (k + 1 < n_stages) {
      const int next = base + NRI_STAGE_ROWS;
      stage_rows(smem + ((k + 1) & 1) * NRI_STAGE_ROWS * S_COLS,
                 table + (size_t)next * S_COLS, imin(n_obj - next, NRI_STAGE_ROWS));
      copies_wait<1>();
    } else {
      copies_wait<0>();
    }
    __syncthreads();
    f(smem + (k & 1) * NRI_STAGE_ROWS * S_COLS, base, imin(n_obj - base, NRI_STAGE_ROWS));
    __syncthreads();  // before the next copy overwrites this stage
  }
}

// contains<MODE_SPHERES> on a row's first two words.
__device__ __forceinline__ bool sphere_holds(float4 c, float4 m, float qx, float qy,
                                             float qz, float omt) {
  const float rx = qx - c.x + omt * m.x;
  const float ry = qy - c.y + omt * m.y;
  const float rz = qz - c.z + omt * m.z;
  return (rx * rx + ry * ry + rz * rz <= c.w) && (m.w > 0.0f);
}

template <int K>
__global__ void __launch_bounds__(NRI_THREADS) nearest_ri_kernel(
    const float* __restrict__ table, int n_obj, const float* __restrict__ rays,
    int B, float* __restrict__ t_out, int* __restrict__ obj_out,
    float* __restrict__ ri_out) {
  RT_DYNAMIC_SHARED(float4, smem4);
  float* smem = reinterpret_cast<float*>(smem4);
  const int sub = threadIdx.x % K;
  const int i = blockIdx.x * (blockDim.x / K) + threadIdx.x / K;
  const bool live = i < B;  // the others serve rows and stage the table
  const Ray R = live ? load_ray(rays, B, i) : Ray{};
  const float a = fmaxf(R.dx * R.dx + R.dy * R.dy + R.dz * R.dz, 1e-30f);
  const float inv_a = 1.0f / a;
  const bool whole = n_obj <= NRI_WHOLE_ROWS;
  if (whole) {
    stage_rows(smem, table, n_obj);
    copies_wait<0>();
    __syncthreads();
  }
  float t_best = fminf(BIG_T, R.tlim);
  int obj = -1;
  over_rows(smem, table, n_obj, whole, [&](const float* rows, int base, int n) {
    const float4* r4 = reinterpret_cast<const float4*>(rows);
#pragma unroll 4
    for (int j = sub; j < n; j += K) {
      float cx, cy, cz;
      const float t = sphere_t_shifted(r4[3 * j], r4[3 * j + 1], R, a, inv_a, cx, cy, cz);
      if (t < t_best) {
        t_best = t;
        obj = base + j;
      }
    }
  });
  // (t, row) minimum over the ray's K lanes: the lowest row of the least t.
#pragma unroll
  for (int off = K / 2; off > 0; off >>= 1) {
    const float ot = __shfl_xor_sync(rt::WARP_FULL, t_best, off);
    const int oo = __shfl_xor_sync(rt::WARP_FULL, obj, off);
    if (ot < t_best || (ot == t_best && (unsigned)oo < (unsigned)obj)) {
      t_best = ot;
      obj = oo;
    }
  }
  float bcx = 0.0f, bcy = 0.0f, bcz = 0.0f;
  if (obj >= 0) sphere_t_centre(table + (size_t)obj * S_COLS, R, a, inv_a, bcx, bcy, bcz);
  float qx, qy, qz;
  ri_query_point(R, t_best, bcx, bcy, bcz, qx, qy, qz);
  float acc = 0.0f, cnt = 0.0f;
  over_rows(smem, table, n_obj, whole, [&](const float* rows, int, int n) {
    const float4* r4 = reinterpret_cast<const float4*>(rows);
    if (K == 1) {
      for (int j = 0; j < n; ++j) {
        if (sphere_holds(r4[3 * j], r4[3 * j + 1], qx, qy, qz, R.omt)) {
          acc += rows[j * S_COLS + 8];
          cnt += 1.0f;
        }
      }
      return;
    }
    // 32 K rows at a time: lane `sub` tests rows j0 + K i + sub (bit i of its
    // mask); the ray's lanes exchange their masks and each adds the contained
    // rows' RI in ascending row order.
    const int seg = (threadIdx.x & 31) & ~(K - 1);
    for (int j0 = 0; j0 < n; j0 += 32 * K) {
      unsigned mine = 0u;
#pragma unroll 4
      for (int i = 0; i < 32; ++i) {
        const int j = j0 + K * i + sub;
        if (j < n && sphere_holds(r4[3 * j], r4[3 * j + 1], qx, qy, qz, R.omt)) mine |= 1u << i;
      }
      unsigned mask[K];
      unsigned any = 0u;
#pragma unroll
      for (int p = 0; p < K; ++p) {
        mask[p] = __shfl_sync(rt::WARP_FULL, mine, seg + p);
        any |= mask[p];
      }
      for (; any != 0u; any &= any - 1u) {
        const int i = __ffs(any) - 1;
#pragma unroll
        for (int p = 0; p < K; ++p) {
          if ((mask[p] >> i) & 1u) {
            acc += rows[(j0 + K * i + p) * S_COLS + 8];
            cnt += 1.0f;
          }
        }
      }
    }
  });
  if (!live || sub != 0) return;
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
// the query point.  The warp takes every group step together (warp_sweep.cuh):
// each live lane tests the box against its own state, and a group that fewer
// than coop_min lanes chose is swept row-parallel, once for each of them.
// live_rows[g] is group g's last live row + 1: rows past it are never read.
constexpr int G_THREADS = 256;
// Resident blocks per SM the registers must allow: 5 (48 registers, no spill,
// as the one-thread walk had), for camera rays, which enter the same groups,
// gain nothing from the warp sweep but what occupancy gives (PERF.md).
constexpr int G_MIN_BLOCKS = 5;

template <int MODE>
__device__ __forceinline__ float grouped_row_t(const float* row, const Ray& R, float a,
                                               float inv_a) {
  if (MODE == MODE_GENERIC) return generic_t(row, R);
  float cx, cy, cz;
  return sphere_t_centre(row, R, a, inv_a, cx, cy, cz);
}

// The counters of one group step of the warp (measurement only; lane 0 adds
// them, so that no counter holds a register through the sweep): the rows up
// to the live bound n for each lane in m (the rows their own walks test), the
// lane slots the warp issues (RT_WARP_LANES x its row iterations) and,
// row-parallel, one visit; into the RI pass's counters where `ri`.
__device__ __forceinline__ void count_step(unsigned long long* stats, bool ri, unsigned m,
                                           int n, bool coop) {
  const unsigned k = (unsigned)__popc(m);
  atomicAdd(stats + (ri ? SC_RI_ROWS : SC_ROWS), (unsigned long long)(k * (unsigned)n));
  atomicAdd(stats + (ri ? SC_RI_SLOTS : SC_SLOTS),
            (unsigned long long)RT_WARP_LANES * (coop ? rt::coop_iters(n) * k : (unsigned)n));
  if (coop) atomicAdd(stats + (ri ? SC_RI_COOP : SC_COOP), 1ull);
}

template <int MODE, bool WITH_RI>
__global__ void __launch_bounds__(G_THREADS, G_MIN_BLOCKS) grouped_kernel(
    const float* __restrict__ table, const float* __restrict__ gaabb,
    const int* __restrict__ live_rows, int n_groups, int group, int coop_min,
    const float* __restrict__ rays, int B, float* __restrict__ t_out,
    int* __restrict__ obj_out, float* __restrict__ ri_out,
    unsigned long long* __restrict__ stats) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x & (RT_WARP_LANES - 1);
  const bool live = i < B;  // the others serve rows
  if (__ballot_sync(rt::WARP_FULL, live) == 0u) return;
  // Each lane's ray, also in shared memory: a lane that serves another's rows
  // reads that ray there and takes its own back afterwards, so that the two
  // never hold registers together.
  __shared__ Ray parked[G_THREADS];
  Ray R = live ? load_ray(rays, B, i) : Ray{};
  parked[threadIdx.x] = R;
  __syncwarp();
  const float a = fmaxf(R.dx * R.dx + R.dy * R.dy + R.dz * R.dz, 1e-30f);
  const float inv_a = 1.0f / a;
  const float ix = rt::safe_inv(R.dx), iy = rt::safe_inv(R.dy), iz = rt::safe_inv(R.dz);
  constexpr int COLS = MODE == MODE_SPHERES ? S_COLS : G_COLS;
  float t_best = fminf(BIG_T, R.tlim);
  int obj = -1;
  for (int g = 0; g < n_groups; ++g) {
    bool entered = false;
    if (live) {
      const float4 b0 = rt::ld4(gaabb + g * GA8);      // lo.x lo.y lo.z hi.x
      const float4 b1 = rt::ld4(gaabb + g * GA8 + 4);  // hi.y hi.z 0 0
      const float u1 = (b0.x - R.ox) * ix, w1 = (b0.w - R.ox) * ix;
      const float u2 = (b0.y - R.oy) * iy, w2 = (b1.x - R.oy) * iy;
      const float u3 = (b0.z - R.oz) * iz, w3 = (b1.y - R.oz) * iz;
      const float tmin = fmaxf(fmaxf(fminf(u1, w1), fminf(u2, w2)), fminf(u3, w3));
      const float tmax = fminf(fminf(fmaxf(u1, w1), fmaxf(u2, w2)), fmaxf(u3, w3));
      entered = (tmax > tmin) && (tmin < t_best);
    }
    const unsigned m = __ballot_sync(rt::WARP_FULL, entered);
    if (m == 0u) continue;
    const int n = __ldg(live_rows + g);
    const int row0 = g * group;
    const float* rows = table + (size_t)row0 * COLS;
    const bool coop = __popc(m) < coop_min;
    if (stats != nullptr && lane == 0)
      count_step(stats, false, m, n, coop);
    if (!coop) {
      if (entered) {
        for (int r = 0; r < n; ++r) {
          const float t = grouped_row_t<MODE>(rows + (size_t)r * COLS, R, a, inv_a);
          if (t < t_best) {
            t_best = t;
            obj = row0 + r;
          }
        }
      }
      continue;
    }
    for (unsigned mm = m; mm != 0u; mm &= mm - 1u) {
      const int L = __ffs(mm) - 1;
      const Ray LR = parked[threadIdx.x - lane + L];
      const float la = MODE == MODE_SPHERES ? __shfl_sync(rt::WARP_FULL, a, L) : 0.0f;
      const float linv = MODE == MODE_SPHERES ? __shfl_sync(rt::WARP_FULL, inv_a, L) : 0.0f;
      float bt = __shfl_sync(rt::WARP_FULL, t_best, L);
      int br = -1;
      for (int r = lane; r < n; r += RT_WARP_LANES) {
        const float t = grouped_row_t<MODE>(rows + (size_t)r * COLS, LR, la, linv);
        if (t < bt) {
          bt = t;
          br = r;
        }
      }
      rt::warp_argmin(bt, br);
      if (lane == L && br >= 0) {
        t_best = bt;
        obj = row0 + br;
      }
    }
    R = parked[threadIdx.x];
  }
  float ri_res = 1.0f;
  if (WITH_RI) {
    // the winner's shifted centre, by the expression of its own test
    float bcx = 0.0f, bcy = 0.0f, bcz = 0.0f;
    if (obj >= 0) sphere_t_centre(table + (size_t)obj * S_COLS, R, a, inv_a, bcx, bcy, bcz);
    float qx, qy, qz;
    ri_query_point(R, t_best, bcx, bcy, bcz, qx, qy, qz);
    float acc = 0.0f, cnt = 0.0f;
    for (int g = 0; g < n_groups; ++g) {
      bool in_box = false;
      if (live) {
        const float4 b0 = rt::ld4(gaabb + g * GA8);
        const float4 b1 = rt::ld4(gaabb + g * GA8 + 4);
        in_box = qx >= b0.x && qx <= b0.w && qy >= b0.y && qy <= b1.x && qz >= b0.z &&
                 qz <= b1.y;
      }
      const unsigned m = __ballot_sync(rt::WARP_FULL, in_box);
      if (m == 0u) continue;
      const int n = __ldg(live_rows + g);
      const float* rows = table + (size_t)g * group * S_COLS;
      const bool coop = __popc(m) < coop_min;
      if (stats != nullptr && lane == 0)
        count_step(stats, true, m, n, coop);
      if (!coop) {
        if (in_box) {
          for (int r = 0; r < n; ++r) {
            float ri;
            if (contains<MODE_SPHERES>(rows + (size_t)r * S_COLS, qx, qy, qz, R.omt, ri)) {
              acc += ri;
              cnt += 1.0f;
            }
          }
        }
        continue;
      }
      for (unsigned mm = m; mm != 0u; mm &= mm - 1u) {
        const int L = __ffs(mm) - 1;
        const float lx = __shfl_sync(rt::WARP_FULL, qx, L);
        const float ly = __shfl_sync(rt::WARP_FULL, qy, L);
        const float lz = __shfl_sync(rt::WARP_FULL, qz, L);
        const float lomt = __shfl_sync(rt::WARP_FULL, R.omt, L);
        // L's running sums, carried on every lane in step; only L keeps them
        float lacc = __shfl_sync(rt::WARP_FULL, acc, L);
        float lcnt = __shfl_sync(rt::WARP_FULL, cnt, L);
        for (int r0 = 0; r0 < n; r0 += RT_WARP_LANES) {
          const int r = r0 + lane;
          bool inside = false;
          float ri = 0.0f;
          if (r < n) inside = contains<MODE_SPHERES>(rows + (size_t)r * S_COLS, lx, ly, lz, lomt, ri);
          for (unsigned in = __ballot_sync(rt::WARP_FULL, inside); in != 0u; in &= in - 1u) {
            lacc += __shfl_sync(rt::WARP_FULL, ri, __ffs(in) - 1);
            lcnt += 1.0f;
          }
        }
        if (lane == L) {
          acc = lacc;
          cnt = lcnt;
        }
      }
    }
    ri_res = mean_ri(acc, cnt);
  }
  if (!live) return;  // after the last warp-wide operation
  t_out[i] = t_best;
  obj_out[i] = obj;
  ri_out[i] = ri_res;
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
// split: lanes per ray, 1, 2, 4 or 8 (at most RT_WARP_LANES).
extern "C" int rt_sweep_nearest_ri(const void* table, int n_obj, int split,
                                   const void* rays, int B, void* t_out,
                                   void* obj_out, void* ri_out, void* stream) {
  if (B <= 0) return 0;
  if (split > RT_WARP_LANES || (split != 1 && split != 2 && split != 4 && split != 8))
    return (int)cudaErrorInvalidValue;
  const float* tb = static_cast<const float*>(table);
  const float* r = static_cast<const float*>(rays);
  float* t = static_cast<float*>(t_out);
  int* o = static_cast<int*>(obj_out);
  float* ri = static_cast<float*>(ri_out);
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  const int blocks = grid_for(B, NRI_THREADS / split);
  const size_t smem = sizeof(float) * S_COLS *
                      (n_obj <= NRI_WHOLE_ROWS ? n_obj : 2 * NRI_STAGE_ROWS);
  auto k = nearest_ri_kernel<1>;
  if (split == 2) k = nearest_ri_kernel<2>;
  if (split == 4) k = nearest_ri_kernel<4>;
  if (split == 8) k = nearest_ri_kernel<8>;
  RT_LAUNCH_SMEM(k, blocks, NRI_THREADS, smem, cs, tb, n_obj, r, B, t, o, ri);
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
// rows.  live_rows: (n_groups,) int32, each group's last live row + 1.  coop_min: a group that fewer lanes of a warp chose
// is swept row-parallel (1 never, 33 always).  with_ri (sphere mode only)
// fuses the refractive-index pass, else ri_out is 1.  stats: null, or
// uint64[SC_LEN] that gains the work counters (measurement only).
extern "C" int rt_sweep_grouped(const void* table, const void* gaabb, const void* live_rows,
                                int n_groups, int group, int mode, int with_ri, int coop_min,
                                const void* rays, int B, void* t_out, void* obj_out,
                                void* ri_out, void* stats, void* stream) {
  if (B <= 0) return 0;
  if (with_ri && mode != MODE_SPHERES) return (int)cudaErrorInvalidValue;
  const float* tb = static_cast<const float*>(table);
  const float* ga = static_cast<const float*>(gaabb);
  const int* live = static_cast<const int*>(live_rows);
  const float* r = static_cast<const float*>(rays);
  float* t = static_cast<float*>(t_out);
  int* o = static_cast<int*>(obj_out);
  float* ri = static_cast<float*>(ri_out);
  unsigned long long* st = static_cast<unsigned long long*>(stats);
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  const int blocks = grid_for(B, G_THREADS);
  auto k = grouped_kernel<MODE_SPHERES, false>;
  if (mode == MODE_GENERIC)
    k = grouped_kernel<MODE_GENERIC, false>;
  else if (with_ri)
    k = grouped_kernel<MODE_SPHERES, true>;
  RT_LAUNCH(k, blocks, G_THREADS, cs, tb, ga, live, n_groups, group, coop_min, r, B, t, o, ri,
            st);
  return static_cast<int>(cudaGetLastError());
}
