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
// What bounds them on this card: operations, one instruction at a time a lane.
// A ray moves 32 bytes in and 8 to 12 out and tests every row of the table
// (dense) or of every group whose box it enters (grouped): about 30 fp32
// operations for a sphere row; a generic row's two rotations and six to eight
// IEEE divisions (no fast-math) are some 130 instructions.  Rays in SoA rows
// so a warp's loads coalesce; the table is row-major with 16-byte-aligned
// rows.  The TPU versions keep the table in scalar memory and broadcast a row
// against a 4096-ray block, skipping a group only when no ray of the block
// enters it.
//
//   - The dense sweeps (nearest_kernel, nearest_ri_kernel, ri_kernel): the
//     block stages what its rows are read from in shared memory (cp.async,
//     whole or in two alternating stages, over_rows) and reads it as
//     broadcasts; K lanes share a ray or a point (the wrapper picks K so that
//     a small batch still fills the card), lane `sub` taking rows
//     j = sub (mod K), and the (t, row) minimum or the RI masks are exchanged
//     by shuffles.
//   - The generic nearest hit culls exactly: each (ray, row) pair first meets
//     a division-free test against the row's bounding sphere (the host's
//     bounds table, staged in place of the 96-byte rows, which the pairs that
//     pass read through the read-only path); the margin (cull_margin_note
//     below) makes it reject only rows whose full test gives BIG_T or a t at
//     or beyond the ray's best.  Sphere rows keep their 20-operation test.
//   - The RI sum walks only the rows that can count (valid, RI not 1: the
//     host's compacted list, in row order); a generic row's point test is
//     behind the same bounding sphere.
//   - The grouped sweep (grouped_kernel) runs on the warp sweep of
//     warp_sweep.cuh: each lane tests its own box, a group that at least
//     coop_min lanes entered is walked per lane, one that fewer entered is
//     swept row-parallel for each of them; rows past the group's last live row
//     are never read.  Its fused RI pass is row-parallel in the same way and
//     sums in row order.
// Every schedule and split gives the per-thread loop's outputs bit for bit
// (-fmad=false): the per-row expression is the same, a culled row is one the
// loop could not have taken, the (t, row) minimum keeps the lowest row of the
// least t as the strict-< scan does, and every RI sum is taken in ascending
// row order.
#include "rt_common.cuh"
#include "warp_sweep.cuh"

namespace {

using rt::BIG_T;

constexpr int S_COLS = 12;  // cx cy cz r2 | dpx dpy dpz valid | ri 0 0 0
constexpr int G_COLS = 24;  // px py pz r00 | r01 r02 r10 r11 | r12 r20 r21 r22 |
                            // sx sy sz dpx | dpy dpz type valid | ri 0 0 0
constexpr int GA8 = 8;      // group box row: lo xyz, hi xyz, 0 0
constexpr int B_COLS = 8;   // bounding sphere of a generic row: px py pz q |
                            // dpx dpy dpz mu (nearest hit) or ri (RI sum)
enum { MODE_SPHERES = 0, MODE_GENERIC = 1 };
// Work counters of the dense sweeps (measurement only): rows pre-tested (the
// (live ray or point, row) pairs visited), rows fully tested (those that
// passed the bounding-sphere test; every visited row where the sphere test is
// the whole test) and the lane slots of the full tests (RT_WARP_LANES for
// every step in which a lane of the warp tested a row fully).  SIMT
// efficiency of the full tests = rows fully tested / slots.
enum { DC_PRE = 0, DC_FULL, DC_SLOTS, DC_LEN };
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
// `c`, `m`: the row's first two 16-byte words (cx cy cz r2 | dpx dpy dpz valid).
__device__ __forceinline__ float sphere_t(float4 c, float4 m, const Ray& R,
                                          float a, float inv_a) {
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

// Generic row, from the relative origin r = o - p + omt * dp: R^T transform,
// then the primitive test of the row's type.
__device__ __forceinline__ float generic_t_rel(const float* row, float rx, float ry,
                                               float rz, const Ray& R) {
  const float4 e = rt::ld4(row + 16);  // dpy dpz type valid
  if (!(e.w > 0.0f)) return BIG_T;
  const float4 a = rt::ld4(row);       // px py pz r00
  const float4 b = rt::ld4(row + 4);   // r01 r02 r10 r11
  const float4 c = rt::ld4(row + 8);   // r12 r20 r21 r22
  const float4 d = rt::ld4(row + 12);  // sx sy sz dpx
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

__device__ __forceinline__ float generic_t(const float* row, const Ray& R) {
  const float4 e = rt::ld4(row + 16);  // dpy dpz type valid
  if (!(e.w > 0.0f)) return BIG_T;
  const float4 a = rt::ld4(row);       // px py pz r00
  const float4 d = rt::ld4(row + 12);  // sx sy sz dpx
  return generic_t_rel(row, R.ox - a.x + R.omt * d.w, R.oy - a.y + R.omt * e.x,
                       R.oz - a.z + R.omt * e.y, R);
}

// Is the point, at r = q - p + omt * dp from the row's position, inside the
// row's generic primitive?
__device__ __forceinline__ bool contains_g_rel(const float* row, float rx, float ry,
                                               float rz) {
  const float4 e = rt::ld4(row + 16);
  if (!(e.w > 0.0f)) return false;
  const float4 a = rt::ld4(row);
  const float4 b = rt::ld4(row + 4);
  const float4 c = rt::ld4(row + 8);
  const float4 d = rt::ld4(row + 12);
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

// ---- staging for the dense sweeps -------------------------------------------
// The block stages the rows its lanes read in shared memory: a table of at most
// Staged<W>::WHOLE rows of W floats once, a longer one through two stages of
// Staged<W>::STAGE rows (the next stage's copy in flight while the current one
// is read), once per pass.  24 KiB a block either way.
constexpr int DS_THREADS = 256;
constexpr int DS_STAGE_BYTES = 12288;

template <int W>
struct Staged {
  static constexpr int STAGE = DS_STAGE_BYTES / (4 * W);  // 256 sphere rows, 384 bounds
  static constexpr int WHOLE = 2 * STAGE;
  static size_t bytes(int n_rows) {
    return sizeof(float) * W * (n_rows <= WHOLE ? n_rows : 2 * STAGE);
  }
};

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

// The block copies n_rows rows of W floats from `src` to `dst` as one copy
// group.
template <int W>
__device__ __forceinline__ void stage_rows(float* dst, const float* src, int n_rows) {
  const int n16 = n_rows * (W / 4);
  float4* d = reinterpret_cast<float4*>(dst);
  const float4* s = reinterpret_cast<const float4*>(src);
  for (int q = threadIdx.x; q < n16; q += blockDim.x) copy16(d + q, s + q);
#ifndef RT_HOST_REHEARSAL
  asm volatile("cp.async.commit_group;\n" ::);
#endif
}

// Stages a table of at most Staged<W>::WHOLE rows whole, before the passes;
// -> whether it did.  Every thread of the block calls it together.
template <int W>
__device__ __forceinline__ bool stage_whole(float* smem, const float* src, int n_rows) {
  if (n_rows > Staged<W>::WHOLE) return false;
  stage_rows<W>(smem, src, n_rows);
  copies_wait<0>();
  __syncthreads();
  return true;
}

// f(rows in shared memory, index of their first row, count) over the table:
// at once where it was staged whole, else stage by stage.  Every thread of the
// block calls it together.
template <int W, class F>
__device__ __forceinline__ void over_rows(float* smem, const float* table, int n_obj,
                                          bool whole, F&& f) {
  if (whole) {
    f(smem, 0, n_obj);
    return;
  }
  constexpr int STAGE = Staged<W>::STAGE;
  const int n_stages = (n_obj + STAGE - 1) / STAGE;
  stage_rows<W>(smem, table, STAGE);
  for (int k = 0; k < n_stages; ++k) {
    const int base = k * STAGE;
    if (k + 1 < n_stages) {
      const int next = base + STAGE;
      stage_rows<W>(smem + ((k + 1) & 1) * STAGE * W, table + (size_t)next * W,
                    imin(n_obj - next, STAGE));
      copies_wait<1>();
    } else {
      copies_wait<0>();
    }
    __syncthreads();
    f(smem + (k & 1) * STAGE * W, base, imin(n_obj - base, STAGE));
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

// The same on a sphere row in global memory, with its refractive index.
__device__ __forceinline__ bool contains_sphere(const float* row, float qx, float qy,
                                                float qz, float omt, float& ri) {
  ri = __ldg(row + 8);
  return sphere_holds(rt::ld4(row), rt::ld4(row + 4), qx, qy, qz, omt);
}

// (t, row) minimum over the K lanes of a ray: the lowest row of the least t.
template <int K>
__device__ __forceinline__ void split_argmin(float& t_best, int& obj) {
#pragma unroll
  for (int off = K / 2; off > 0; off >>= 1) {
    const float ot = __shfl_xor_sync(rt::WARP_FULL, t_best, off);
    const int oo = __shfl_xor_sync(rt::WARP_FULL, obj, off);
    if (ot < t_best || (ot == t_best && (unsigned)oo < (unsigned)obj)) {
      t_best = ot;
      obj = oo;
    }
  }
}

// The dense sweeps' counters: each thread's, summed per warp, added by lane 0.
struct DenseCounts {
  unsigned pre = 0, full = 0, slots = 0;
  // One step of the warp: this lane pre-tested `visits` rows and tested
  // `fully` of them fully, one after another, as the warp's other lanes did
  // theirs.  Every lane of the warp calls it together.
  __device__ __forceinline__ void chunk(unsigned visits, unsigned fully) {
    pre += visits;
    full += fully;
    slots += RT_WARP_LANES * __reduce_max_sync(rt::WARP_FULL, fully);
  }
  __device__ __forceinline__ void flush(unsigned long long* stats) const {
    const unsigned p = __reduce_add_sync(rt::WARP_FULL, pre);
    const unsigned f = __reduce_add_sync(rt::WARP_FULL, full);
    if ((threadIdx.x & (RT_WARP_LANES - 1)) != 0) return;
    atomicAdd(stats + DC_PRE, (unsigned long long)p);
    atomicAdd(stats + DC_FULL, (unsigned long long)f);
    atomicAdd(stats + DC_SLOTS, (unsigned long long)slots);  // the same on every lane
  }
};

// The rows of the chunk at j0 that lane `sub` visits.
template <int K>
__device__ __forceinline__ unsigned chunk_rows(int j0, int sub, int n) {
  const int left = n - j0 - sub;
  return left <= 0 ? 0u : (unsigned)imin(32, (left + K - 1) / K);
}

// The culled sweeps take the staged rows 32 K at a time: lane `sub` pre-tests
// rows j0 + K b + sub, b = 0 .. 31 (bit b of the mask), in a loop unrolled
// U times with no branch where the chunk is whole (the last one runs to its
// own end), then tests the rows of its set bits fully, in ascending order.
// U = 32 for the generic bounds (8 was 9-12 % slower); 8 for sphere rows,
// whose RI sum spilled at K = 4 fully unrolled.
template <int K, int U, class P>
__device__ __forceinline__ unsigned chunk_mask(int j0, int sub, int n, P&& pass) {
  unsigned m = 0u;
  if (j0 + 32 * K <= n) {
#pragma unroll (U)
    for (int b = 0; b < 32; ++b)
      if (pass(j0 + K * b + sub)) m |= 1u << b;
  } else {
    const int nb = (int)chunk_rows<K>(j0, sub, n);
    for (int b = 0; b < nb; ++b)
      if (pass(j0 + K * b + sub)) m |= 1u << b;
  }
  return m;
}

// ---- dense nearest hit ----------------------------------------------------
// cull_margin_note.  The generic sweep's pre-test rejects row k for a ray only
// where generic_t of the row gives BIG_T or a t >= t_best, so that the strict-<
// scan over the rows that pass gives the dense scan's (t, obj) bit for bit.
// The host's bounds row holds q = (rb (1 + 2^-9))^2 (1 + 2^-16 kappa) and
// mu = min(2^-15 kappa^3, 1), where rb = max|s| (ellipsoid) or |s| / 2 (cuboid)
// over sigma_min(R) bounds the primitive around p - omt dp, and
// kappa = (max|s| / min|s|) (sigma_max(R) / sigma_min(R)) is the condition of
// the local map diag(1/s) R^T (rows with sigma_min(R) < 1/2 or a zero scale
// are never culled: q = inf; dead rows always: q = -inf).  With
// r = o - p + omt dp, the very floats generic_t_rel is given, the pre-test
// rejects where the ray's half-line t >= 0 stays outside the sphere of radius
// rho about 0, rho^2 = q + mu |r|^2 + 2^-56 t_best^2, by the float test
// c2 = |r|^2 - rho^2 > 0 and (r.d >= 0 or (r.d)^2 < |d|^2 c2).  Why no row that
// generic_t could report below t_best is rejected (eps = 2^-24):
//  - generic_t's rotations, divisions and sums commit relative errors of a
//    few eps each.  Carried back to world space through diag(1/s) R^T, the
//    line its quadratic or slabs saw lies within c eps (1 + kappa) kappa^2 |r|^2
//    (squared distance, c < 60 counting every rounding) of the exact line
//    through r along d, and a reported hit with the origin outside the
//    primitive at a parameter t > 0 needs the exact half-line to come within
//    rb (1 + c' eps kappa) of the centre: both far inside mu |r|^2 and the
//    2^-8 and 2^-16 kappa of q (a margin of ten or more).
//  - The cuboid's safe inverse turns a direction component below 1e-12 into
//    +-1e-12: its slabs then see a ray that leaves the true one by at most
//    3.5e-12 t / sigma_min(R), so a hit at t < t_best lies within
//    rb + 7e-12 t_best of the centre; (a + b)^2 <= a^2 (1 + 2^-10) + 1025 b^2
//    puts that under q + 2^-56 t_best^2.  A dead ray (d = 0) is such a ray:
//    its test reduces to |r| against rho.
//  - The pre-test's own roundings shift c2 by a few eps |r|^2 and rho^2, far
//    inside the same margins; a t_best of 3e38 makes rho infinite (no cull).
// A stale t_best (a lane's, above the ray's final best) only widens rho.
// `w` = 2^-56 t_best^2, taken once a chunk (a t_best from before the chunk
// only widens rho).
__device__ __forceinline__ bool may_hit(float4 c, float4 m, const Ray& R, float dd,
                                        float w) {
  const float rx = R.ox - c.x + R.omt * m.x;
  const float ry = R.oy - c.y + R.omt * m.y;
  const float rz = R.oz - c.z + R.omt * m.z;
  const float rr = rx * rx + ry * ry + rz * rz;
  const float b = rx * R.dx + ry * R.dy + rz * R.dz;
  const float c2 = rr - (c.w + m.w * rr + w);
  return !(c2 > 0.0f && (b >= 0.0f || b * b < dd * c2));
}

// K lanes a ray (K | 32), lane `sub` taking rows j = sub (mod K) of the staged
// rows: the sphere rows themselves, or the generic rows' bounds, whose passing
// rows are read from `table` in global memory.
template <int MODE, int K>
__global__ void __launch_bounds__(DS_THREADS) nearest_kernel(
    const float* __restrict__ table, const float* __restrict__ bounds, int n_obj,
    const float* __restrict__ rays, int B, float* __restrict__ t_out,
    int* __restrict__ obj_out, unsigned long long* __restrict__ stats) {
  RT_DYNAMIC_SHARED(float4, smem4);
  float* smem = reinterpret_cast<float*>(smem4);
  constexpr int W = MODE == MODE_SPHERES ? S_COLS : B_COLS;
  const float* src = MODE == MODE_SPHERES ? table : bounds;
  const int sub = threadIdx.x % K;
  const int i = blockIdx.x * (blockDim.x / K) + threadIdx.x / K;
  const bool live = i < B;  // the others stage rows and take the warp's steps
  const Ray R = live ? load_ray(rays, B, i) : Ray{};
  const float dd = R.dx * R.dx + R.dy * R.dy + R.dz * R.dz;
  const float a = fmaxf(dd, 1e-30f);
  const float inv_a = 1.0f / a;
  const bool whole = stage_whole<W>(smem, src, n_obj);
  float t_best = fminf(BIG_T, R.tlim);
  int obj = -1;
  DenseCounts n;
  over_rows<W>(smem, src, n_obj, whole, [&](const float* rows, int base, int cnt) {
    const float4* r4 = reinterpret_cast<const float4*>(rows);
    if (MODE == MODE_SPHERES) {
      for (int j0 = 0; j0 < cnt; j0 += K) {  // the warp's steps, the same on every lane
        const int j = j0 + sub;
        const bool visit = live && j < cnt;
        if (visit) {
          const float t = sphere_t(r4[3 * j], r4[3 * j + 1], R, a, inv_a);
          if (t < t_best) {
            t_best = t;
            obj = base + j;
          }
        }
        if (stats != nullptr) n.chunk(visit, visit);
      }
      return;
    }
    for (int j0 = 0; j0 < cnt; j0 += 32 * K) {  // the same on every lane
      const float w = 0x1p-56f * (t_best * t_best);
      unsigned pass = 0u;
      if (live)
        pass = chunk_mask<K, 32>(j0, sub, cnt, [&](int j) {
          return may_hit(r4[2 * j], r4[2 * j + 1], R, dd, w);
        });
      if (stats != nullptr) n.chunk(live ? chunk_rows<K>(j0, sub, cnt) : 0u, __popc(pass));
      for (; pass != 0u; pass &= pass - 1u) {
        const int j = j0 + K * (__ffs(pass) - 1) + sub;
        const float4 c = r4[2 * j], m = r4[2 * j + 1];
        const float t = generic_t_rel(table + (size_t)(base + j) * G_COLS,
                                      R.ox - c.x + R.omt * m.x, R.oy - c.y + R.omt * m.y,
                                      R.oz - c.z + R.omt * m.z, R);
        if (t < t_best) {
          t_best = t;
          obj = base + j;
        }
      }
    }
  });
  split_argmin<K>(t_best, obj);
  if (stats != nullptr) n.flush(stats);
  if (!live || sub != 0) return;
  t_out[i] = t_best;
  obj_out[i] = obj;
}

// ---- dense nearest hit + surrounding RI (sphere mode) -----------------------
// The staging and split of the dense sweeps; both passes read the sphere rows.
template <int K>
__global__ void __launch_bounds__(DS_THREADS) nearest_ri_kernel(
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
  const bool whole = stage_whole<S_COLS>(smem, table, n_obj);
  float t_best = fminf(BIG_T, R.tlim);
  int obj = -1;
  over_rows<S_COLS>(smem, table, n_obj, whole, [&](const float* rows, int base, int n) {
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
  split_argmin<K>(t_best, obj);
  float bcx = 0.0f, bcy = 0.0f, bcz = 0.0f;
  if (obj >= 0) sphere_t_centre(table + (size_t)obj * S_COLS, R, a, inv_a, bcx, bcy, bcz);
  float qx, qy, qz;
  ri_query_point(R, t_best, bcx, bcy, bcz, qx, qy, qz);
  float acc = 0.0f, cnt = 0.0f;
  over_rows<S_COLS>(smem, table, n_obj, whole, [&](const float* rows, int, int n) {
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
// Containers of refractive index exactly 1 are air and do not count, nor do
// dead rows: the kernel walks the host's list of the others, in row order.
// Sphere mode stages those rows themselves (their test is the whole test);
// generic mode stages their bounds (px py pz q | dpx dpy dpz ri, q as the
// nearest hit's) and tests a point inside the bounding sphere against the row,
// read from `table` at index[k].  A point the full test calls inside lies
// within rb (1 + c eps kappa) of the centre (cull_margin_note, with no line:
// c < 10), under q's 2^-8 and 2^-16 kappa, so |r|^2 > q rejects only rows that
// do not contain it.
//
// K lanes a point: lane `sub` tests rows j0 + K i + sub (bit i of its mask) of
// every 32 K; the point's lanes OR their masks and, for each set bit in turn,
// read each other's bit by a shuffle among the point's K lanes alone, so that
// each adds the contained rows' RI in ascending row order (no lane keeps K
// masks: the K = 8 generic instantiation spilled so).
template <int MODE, int K>
__global__ void __launch_bounds__(DS_THREADS) ri_kernel(
    const float* __restrict__ table, const int* __restrict__ index,
    const float* __restrict__ staged, int n_rows, const float* __restrict__ pts, int B,
    float* __restrict__ ri_out, unsigned long long* __restrict__ stats) {
  RT_DYNAMIC_SHARED(float4, smem4);
  float* smem = reinterpret_cast<float*>(smem4);
  constexpr int W = MODE == MODE_SPHERES ? S_COLS : B_COLS;
  constexpr int RI = MODE == MODE_SPHERES ? 8 : 7;  // the staged row's RI column
  const int sub = threadIdx.x % K;
  const int i = blockIdx.x * (blockDim.x / K) + threadIdx.x / K;
  const bool live = i < B;
  const size_t s = (size_t)B;
  const float qx = live ? pts[i] : 0.0f, qy = live ? pts[s + i] : 0.0f;
  const float qz = live ? pts[2 * s + i] : 0.0f, omt = live ? pts[3 * s + i] : 0.0f;
  const bool whole = stage_whole<W>(smem, staged, n_rows);
  float acc = 0.0f, cnt = 0.0f;
  DenseCounts n;
  over_rows<W>(smem, staged, n_rows, whole, [&](const float* rows, int base, int cnt_rows) {
    const float4* r4 = reinterpret_cast<const float4*>(rows);
    const int seg = (threadIdx.x & (RT_WARP_LANES - 1)) & ~(K - 1);
    const unsigned seg_mask = K == 32 ? rt::WARP_FULL : ((1u << K) - 1u) << seg;
    for (int j0 = 0; j0 < cnt_rows; j0 += 32 * K) {  // the same on every lane
      unsigned mine = 0u, fully = 0u;
      if (live && MODE == MODE_SPHERES) {
        mine = chunk_mask<K, 8>(j0, sub, cnt_rows, [&](int j) {
          return sphere_holds(r4[3 * j], r4[3 * j + 1], qx, qy, qz, omt);
        });
        fully = chunk_rows<K>(j0, sub, cnt_rows);
      } else if (live) {
        unsigned near = chunk_mask<K, 32>(j0, sub, cnt_rows, [&](int j) {
          const float4 c = r4[2 * j], m = r4[2 * j + 1];
          const float rx = qx - c.x + omt * m.x;
          const float ry = qy - c.y + omt * m.y;
          const float rz = qz - c.z + omt * m.z;
          return !(rx * rx + ry * ry + rz * rz > c.w);
        });
        fully = __popc(near);
        for (; near != 0u; near &= near - 1u) {
          const int b = __ffs(near) - 1, j = j0 + K * b + sub;
          const float4 c = r4[2 * j], m = r4[2 * j + 1];
          if (contains_g_rel(table + (size_t)index[base + j] * G_COLS, qx - c.x + omt * m.x,
                             qy - c.y + omt * m.y, qz - c.z + omt * m.z))
            mine |= 1u << b;
        }
      }
      if (stats != nullptr) n.chunk(live ? chunk_rows<K>(j0, sub, cnt_rows) : 0u, fully);
      unsigned any = mine;
#pragma unroll
      for (int off = K / 2; off > 0; off >>= 1) any |= __shfl_xor_sync(rt::WARP_FULL, any, off);
      for (; any != 0u; any &= any - 1u) {  // the same on the point's K lanes
        const int b = __ffs(any) - 1;
        for (int p = 0; p < K; ++p) {
          const unsigned m = K == 1 ? mine : __shfl_sync(seg_mask, mine, seg + p);
          if ((m >> b) & 1u) {
            acc += rows[(j0 + K * b + p) * W + RI];
            cnt += 1.0f;
          }
        }
      }
    }
  });
  if (stats != nullptr) n.flush(stats);
  if (!live || sub != 0) return;
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
            if (contains_sphere(rows + (size_t)r * S_COLS, qx, qy, qz, R.omt, ri)) {
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
          if (r < n) inside = contains_sphere(rows + (size_t)r * S_COLS, lx, ly, lz, lomt, ri);
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

inline bool split_ok(int split) {
  return split <= RT_WARP_LANES && (split == 1 || split == 2 || split == 4 || split == 8);
}

template <int MODE>
int launch_nearest(const float* tb, const float* bd, int n_obj, int split, const float* r,
                   int B, float* t, int* o, unsigned long long* st, cudaStream_t cs) {
  auto k = nearest_kernel<MODE, 1>;
  if (split == 2) k = nearest_kernel<MODE, 2>;
  if (split == 4) k = nearest_kernel<MODE, 4>;
  if (split == 8) k = nearest_kernel<MODE, 8>;
  const size_t smem = Staged<MODE == MODE_SPHERES ? S_COLS : B_COLS>::bytes(n_obj);
  RT_LAUNCH_SMEM(k, grid_for(B, DS_THREADS / split), DS_THREADS, smem, cs, tb, bd, n_obj, r, B,
                 t, o, st);
  return static_cast<int>(cudaGetLastError());
}

template <int MODE>
int launch_ri(const float* tb, const int* idx, const float* sg, int n_rows, int split,
              const float* p, int B, float* ri, unsigned long long* st, cudaStream_t cs) {
  auto k = ri_kernel<MODE, 1>;
  if (split == 2) k = ri_kernel<MODE, 2>;
  if (split == 4) k = ri_kernel<MODE, 4>;
  if (split == 8) k = ri_kernel<MODE, 8>;
  const size_t smem = Staged<MODE == MODE_SPHERES ? S_COLS : B_COLS>::bytes(n_rows);
  RT_LAUNCH_SMEM(k, grid_for(B, DS_THREADS / split), DS_THREADS, smem, cs, tb, idx, sg, n_rows,
                 p, B, ri, st);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Common conventions of the four entry points: `table` is (n_obj, 12) in mode
// 0 (spheres) or (n_obj, 24) in mode 1 (generic); `rays` is (8, B) rows ox oy
// oz dx dy dz omt tlim with omt = 1 - time_ratio; outputs are (B,); a miss
// gives obj = -1 and t = min(3e38, tlim).  `split`: lanes per ray or point of
// the dense sweeps, 1, 2, 4 or 8 (at most RT_WARP_LANES).  `stats`: null, or
// uint64[DC_LEN] (dense sweeps) / uint64[SC_LEN] (grouped) that gains the work
// counters (measurement only).  Each launches on `stream`, does not
// synchronise and returns cudaGetLastError().

// bounds: generic mode, (n_obj, 8) rows px py pz q | dpx dpy dpz mu, the
// pre-test's bounding spheres (kernels/sweep.py::dense_bounds); unused in
// sphere mode.
extern "C" int rt_sweep_nearest(const void* table, int n_obj, int mode, const void* bounds,
                                int split, const void* rays, int B, void* t_out,
                                void* obj_out, void* stats, void* stream) {
  if (B <= 0) return 0;
  if (!split_ok(split) || (mode == MODE_GENERIC && bounds == nullptr))
    return (int)cudaErrorInvalidValue;
  const float* tb = static_cast<const float*>(table);
  const float* bd = static_cast<const float*>(bounds);
  const float* r = static_cast<const float*>(rays);
  float* t = static_cast<float*>(t_out);
  int* o = static_cast<int*>(obj_out);
  unsigned long long* st = static_cast<unsigned long long*>(stats);
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  if (mode == MODE_SPHERES)
    return launch_nearest<MODE_SPHERES>(tb, bd, n_obj, split, r, B, t, o, st, cs);
  return launch_nearest<MODE_GENERIC>(tb, bd, n_obj, split, r, B, t, o, st, cs);
}

// Sphere mode only; ri_out gains the surrounding refractive index 1e-3 outside
// the hit point (all rows count, as in the grouped sweep's fused pass).
extern "C" int rt_sweep_nearest_ri(const void* table, int n_obj, int split,
                                   const void* rays, int B, void* t_out,
                                   void* obj_out, void* ri_out, void* stream) {
  if (B <= 0) return 0;
  if (!split_ok(split)) return (int)cudaErrorInvalidValue;
  const float* tb = static_cast<const float*>(table);
  const float* r = static_cast<const float*>(rays);
  float* t = static_cast<float*>(t_out);
  int* o = static_cast<int*>(obj_out);
  float* ri = static_cast<float*>(ri_out);
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  const int blocks = grid_for(B, DS_THREADS / split);
  const size_t smem = Staged<S_COLS>::bytes(n_obj);
  auto k = nearest_ri_kernel<1>;
  if (split == 2) k = nearest_ri_kernel<2>;
  if (split == 4) k = nearest_ri_kernel<4>;
  if (split == 8) k = nearest_ri_kernel<8>;
  RT_LAUNCH_SMEM(k, blocks, DS_THREADS, smem, cs, tb, n_obj, r, B, t, o, ri);
  return static_cast<int>(cudaGetLastError());
}

// pts: (4, B) rows px py pz omt; ri_out: mean refractive index of the
// containing rows whose index is not 1, when their sum exceeds 1, else 1.
// The rows that can count (kernels/sweep.py::ri_rows): `index` (n_rows,)
// int32, their rows of `table` in ascending order, and `staged`, (n_rows, 12)
// copies of those rows in sphere mode, (n_rows, 8) bounds px py pz q | dpx
// dpy dpz ri in generic mode.
extern "C" int rt_sweep_ri(const void* table, int n_obj, int mode, const void* index,
                           const void* staged, int n_rows, int split, const void* pts,
                           int B, void* ri_out, void* stats, void* stream) {
  if (B <= 0) return 0;
  if (!split_ok(split) || n_rows > n_obj) return (int)cudaErrorInvalidValue;
  const float* tb = static_cast<const float*>(table);
  const int* idx = static_cast<const int*>(index);
  const float* sg = static_cast<const float*>(staged);
  const float* p = static_cast<const float*>(pts);
  float* ri = static_cast<float*>(ri_out);
  unsigned long long* st = static_cast<unsigned long long*>(stats);
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  if (mode == MODE_SPHERES)
    return launch_ri<MODE_SPHERES>(tb, idx, sg, n_rows, split, p, B, ri, st, cs);
  return launch_ri<MODE_GENERIC>(tb, idx, sg, n_rows, split, p, B, ri, st, cs);
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
