// The gradient path's surrounding-refractive-index containment sum and its
// backward, for Hopper (sm_90a).
//
// Replaces no TPU kernel: it is the counterpart of the XLA fusion of the JAX
// package's dense containment sum, raytracing_tests_tpu/ops/intersect.py:86-105
// (`surrounding_refractive_index`), which the gradient path reaches for the
// lanes that read the surrounding RI (raytracing_tests_tpu/ops/render.py:324-329)
// and which no pallas_call stands behind.  XLA reduces it without writing the
// (points, rows, 3) intermediates; the port's PyTorch route wrote them all
// (some 25 kernels over (slots, N, 3) and (slots, N) tensors a pop).
//
// The function: for each point p (S of them) at time ratio tr, the mean RI of
// the rows that contain it, are valid and whose RI is not 1, where their sum
// exceeds 1, else 1.  A row contains p where its local point
//   rel = (p - position) + (1 - tr) delta_position,
//   local_i = ((R[0][i] rel_0 + R[1][i] rel_1) + R[2][i] rel_2) / scale_i
// lies in the unit primitive: (l0 l0 + l1 l1) + l2 l2 <= 1 for an ellipsoid,
// every |l_i| <= 0.5 for a cuboid (core/geometry.py:126-133).  The contained
// rows' RI is added in ascending row order, as the plain version
// (kernels/ri_sum.py::ri_sum_plain) and K4's sums add it.
//
// ri_sum_kernel: K lanes a point (K = 1, 2, 4, 8, by the point count: enough
// lanes to fill the card).  The block stages the rows in shared memory, TILE
// at a time (any N), each row's fields and its liveness folded into one
// 20-float record; lane `sub` of a point tests rows j0 + K b + sub (bit b of
// its mask) of every 32 K; the point's lanes OR their masks and, for each
// set bit in turn, read each other's bit by a shuffle among the point's K
// lanes, so that each adds the contained rows' RI in ascending row order
// (the pattern of K4's ri_kernel, csrc/sweep.cu).  It writes the mean and,
// for the backward, the point's count where its sum exceeded 1 (else 0):
// (S,) each, never (S, N).
//
// ri_sum_grad_kernel: the backward with respect to the RI alone (containment
// is a boolean).  Each point whose sum exceeded 1 gives v = g / count to
// every row that contains it; the kernel recomputes the containment with the
// same __device__ function as the forward, so the two agree bit for bit.  A
// warp's lanes test the same K rows at a time (the lanes with the same
// `sub`), so the lanes of a row are known without __match_any_sync: for each
// row any lane of the warp found, a tree of shuffles sums the lanes of that
// row and one lane adds the sum.  In the tile mode it adds into an (N,)
// float tile in shared memory, and the block then adds each row it touched
// into global memory, one global atomic a (block, row); where 4 N bytes
// exceed the caller's shared-memory budget it adds straight into global
// memory (the global mode, the same kernel).  The sums run in another order
// than the plain version's (float32 atomics, whose order varies from run to
// run).
//
// ri_sum_kernel<K, true> is the forward-mode tangent (counted as
// ri_sum_jvp): the same walk with each row's RI tangent staged in place of
// its RI (the containment, and so the rows, as the forward's), added in
// ascending row order and divided by the forward's count where it is above
// 0, else 0.  The tangent of the mean is the mean of the contained rows'
// tangents: containment is a boolean and the count a constant.
//
// No kernel here synchronises with the host or reads on it: each runs inside
// a gradient band's captured CUDA graph.
//
// What bounds both on this card: operations.  Each (point, row) test is some
// 30 float operations and three divisions; at the gradient path's deepest
// pops (26 624 - 33 792 points x 488 rows) that is about 1e7 tests, some
// 5 us at 67 TFLOP/s, while the bytes (the points, the rows, the outputs)
// are under 1 MB.  The design keeps every intermediate in registers, the
// rows in shared memory, and the card full with K lanes a point.
#include "rt_common.cuh"

#ifndef RT_WARP_LANES
#define RT_WARP_LANES 32
#endif

namespace {

constexpr int THREADS = 256;
constexpr int TILE = 256;  // rows staged at a time
constexpr int ROW = 20;    // px py pz | dpx dpy dpz | R00 .. R22 | sx sy sz | type ri
enum { R_POS = 0, R_DPOS = 3, R_ROT = 6, R_SCALE = 15, R_TYPE = 18, R_RI = 19 };
constexpr unsigned FULL = 0xffffffffu;
constexpr float ELLIPSOID = 1.0f;
constexpr float CUBOID = 2.0f;

struct RiArgs {
  const float* point;       // (S, 3)
  const float* time_ratio;  // (S,)
  const float* position;    // (N, 3)
  const float* delta;       // (N, 3)
  const float* rotation;    // (N, 3, 3), R[j][i] at 9 n + 3 j + i
  const float* scale;       // (N, 3)
  const int* obj_type;      // (N,)
  const unsigned char* valid;  // (N,) bool
  const float* ri;          // (N,)
  const float* add;         // (N,) what a contained row adds: its RI, or its RI's tangent
  long long S;
  int N;
};

// Rows [base, base + n) into `rows`, one thread a row.  The type is 0 where
// the row cannot contain a point (invalid, RI 1, neither primitive).
__device__ __forceinline__ void stage_rows(const RiArgs& a, float* rows, int base, int n) {
  for (int k = threadIdx.x; k < n; k += blockDim.x) {
    const int r = base + k;
    float* out = rows + k * ROW;
    for (int c = 0; c < 3; ++c) {
      out[R_POS + c] = a.position[3 * r + c];
      out[R_DPOS + c] = a.delta[3 * r + c];
      out[R_SCALE + c] = a.scale[3 * r + c];
    }
    for (int c = 0; c < 9; ++c) out[R_ROT + c] = a.rotation[9 * r + c];
    const float ri = a.ri[r];
    const int t = a.obj_type[r];
    const bool live = a.valid[r] != 0 && ri != 1.0f && (t == 1 || t == 2);
    out[R_TYPE] = live ? (float)t : 0.0f;
    out[R_RI] = a.add[r];
  }
}

// Does the staged row contain the point (px, py, pz) at omt = 1 - tr?  Term
// by term as the plain version computes it.
__device__ __forceinline__ bool row_contains(const float* r, float px, float py, float pz,
                                             float omt) {
  const float type = r[R_TYPE];
  if (type == 0.0f) return false;
  const float rx = (px - r[R_POS]) + omt * r[R_DPOS];
  const float ry = (py - r[R_POS + 1]) + omt * r[R_DPOS + 1];
  const float rz = (pz - r[R_POS + 2]) + omt * r[R_DPOS + 2];
  const float* R = r + R_ROT;
  const float lx = ((R[0] * rx + R[3] * ry) + R[6] * rz) / r[R_SCALE];
  const float ly = ((R[1] * rx + R[4] * ry) + R[7] * rz) / r[R_SCALE + 1];
  const float lz = ((R[2] * rx + R[5] * ry) + R[8] * rz) / r[R_SCALE + 2];
  if (type == ELLIPSOID) return (lx * lx + ly * ly) + lz * lz <= 1.0f;
  return type == CUBOID && fabsf(lx) <= 0.5f && fabsf(ly) <= 0.5f && fabsf(lz) <= 0.5f;
}

// Bit b: does the point contain row j0 + K b + sub of the n staged?
template <int K>
__device__ __forceinline__ unsigned chunk_mask(const float* rows, int j0, int sub, int n, float px,
                                               float py, float pz, float omt) {
  unsigned mine = 0u;
  for (int b = 0; b < 32; ++b) {
    const int j = j0 + K * b + sub;
    if (j >= n) break;
    if (row_contains(rows + j * ROW, px, py, pz, omt)) mine |= 1u << b;
  }
  return mine;
}

struct Point {
  long long i;
  bool live;
  float x, y, z, omt;
};

template <int K>
__device__ __forceinline__ Point point_of(const RiArgs& a) {
  Point q;
  q.i = (long long)blockIdx.x * (blockDim.x / K) + threadIdx.x / K;
  q.live = q.i < a.S;
  q.x = q.live ? a.point[3 * q.i] : 0.0f;
  q.y = q.live ? a.point[3 * q.i + 1] : 0.0f;
  q.z = q.live ? a.point[3 * q.i + 2] : 0.0f;
  q.omt = q.live ? 1.0f - a.time_ratio[q.i] : 0.0f;
  return q;
}

// TANGENT: the rows add a.add (the RI's tangent) and den_out is read (the
// forward's count), not written.
template <int K, bool TANGENT>
__global__ void __launch_bounds__(THREADS) ri_sum_kernel(RiArgs a, float* __restrict__ ri_out,
                                                          int* __restrict__ den_out) {
  __shared__ float rows[TILE * ROW];
  const int sub = threadIdx.x % K;
  const int seg = (threadIdx.x & (RT_WARP_LANES - 1)) & ~(K - 1);
  const unsigned seg_mask = K == 32 ? FULL : ((1u << K) - 1u) << seg;
  const Point q = point_of<K>(a);
  float acc = 0.0f, cnt = 0.0f;
  for (int base = 0; base < a.N; base += TILE) {  // the same on every thread of the block
    const int n = a.N - base < TILE ? a.N - base : TILE;
    __syncthreads();
    stage_rows(a, rows, base, n);
    __syncthreads();
    for (int j0 = 0; j0 < n; j0 += 32 * K) {
      const unsigned mine = q.live ? chunk_mask<K>(rows, j0, sub, n, q.x, q.y, q.z, q.omt) : 0u;
      unsigned any = mine;
#pragma unroll
      for (int off = K / 2; off > 0; off >>= 1) any |= __shfl_xor_sync(FULL, any, off);
      for (; any != 0u; any &= any - 1u) {  // the same on the point's K lanes
        const int b = __ffs(any) - 1;
        for (int p = 0; p < K; ++p) {
          const unsigned m = K == 1 ? mine : __shfl_sync(seg_mask, mine, seg + p);
          if ((m >> b) & 1u) {
            acc += rows[(j0 + K * b + p) * ROW + R_RI];
            cnt += 1.0f;
          }
        }
      }
    }
  }
  if (!q.live || sub != 0) return;
  if (TANGENT) {
    const int dn = den_out[q.i];
    ri_out[q.i] = dn > 0 ? acc / (float)dn : 0.0f;
  } else {
    ri_out[q.i] = acc > 1.0f ? acc / fmaxf(cnt, 1.0f) : 1.0f;
    den_out[q.i] = acc > 1.0f ? (int)cnt : 0;
  }
}

template <int K>
__global__ void __launch_bounds__(THREADS) ri_sum_grad_kernel(RiArgs a, const float* __restrict__ g,
                                                               const int* __restrict__ den,
                                                               float* __restrict__ grad_ri,
                                                               int shared) {
  __shared__ float rows[TILE * ROW];
  RT_DYNAMIC_SHARED(float, tile);  // (N,) in the tile mode
  if (shared) {
    for (int k = threadIdx.x; k < a.N; k += blockDim.x) tile[k] = 0.0f;
  }
  const int sub = threadIdx.x % K;
  const unsigned lane = threadIdx.x & (RT_WARP_LANES - 1);
  const Point q = point_of<K>(a);
  const int d = q.live ? den[q.i] : 0;
  // the point's share of its gradient: what autograd gives each contained row
  const float v = d > 0 ? g[q.i] / (float)d : 0.0f;
  const bool gives = v != 0.0f;  // a zero adds nothing (NaN does)
  for (int base = 0; base < a.N; base += TILE) {
    const int n = a.N - base < TILE ? a.N - base : TILE;
    __syncthreads();
    stage_rows(a, rows, base, n);
    __syncthreads();
    for (int j0 = 0; j0 < n; j0 += 32 * K) {
      const unsigned mine = gives ? chunk_mask<K>(rows, j0, sub, n, q.x, q.y, q.z, q.omt) : 0u;
      unsigned any = mine;  // over the warp
#pragma unroll
      for (int off = RT_WARP_LANES / 2; off > 0; off >>= 1) {
        any |= __shfl_xor_sync(FULL, any, off);
      }
      for (; any != 0u; any &= any - 1u) {  // the same on every lane of the warp
        const int b = __ffs(any) - 1;
        float x = (mine >> b) & 1u ? v : 0.0f;
        // sum over the lanes with this lane's `sub` (rows j0 + K b + sub)
#pragma unroll
        for (int off = K; off < RT_WARP_LANES; off <<= 1) x += __shfl_xor_sync(FULL, x, off);
        if (lane < (unsigned)K && x != 0.0f) {
          const int row = base + j0 + K * b + (int)lane;
          if (shared) {
            atomicAdd(&tile[row], x);
          } else {
            atomicAdd(&grad_ri[row], x);
          }
        }
      }
    }
  }
  if (shared) {
    __syncthreads();
    for (int k = threadIdx.x; k < a.N; k += blockDim.x) {
      if (tile[k] != 0.0f) atomicAdd(&grad_ri[k], tile[k]);  // the rows the block touched
    }
  }
}

// The launch of K lanes a point: S K threads, THREADS a block.
inline int blocks_of(long long S, int K) { return (int)((S * K + THREADS - 1) / THREADS); }

inline RiArgs args_of(const void* point, const void* time_ratio, const void* position,
                      const void* delta, const void* rotation, const void* scale,
                      const void* obj_type, const void* valid, const void* ri, long long S,
                      int N) {
  RiArgs a;
  a.point = static_cast<const float*>(point);
  a.time_ratio = static_cast<const float*>(time_ratio);
  a.position = static_cast<const float*>(position);
  a.delta = static_cast<const float*>(delta);
  a.rotation = static_cast<const float*>(rotation);
  a.scale = static_cast<const float*>(scale);
  a.obj_type = static_cast<const int*>(obj_type);
  a.valid = static_cast<const unsigned char*>(valid);
  a.ri = static_cast<const float*>(ri);
  a.add = a.ri;
  a.S = S;
  a.N = N;
  return a;
}

// ri_sum_kernel<K, TANGENT> for the K of the launch (1, 2, 4 or 8).
template <bool TANGENT>
int launch_sum(const RiArgs& a, int K, float* out, int* dn, cudaStream_t st) {
  void (*k)(RiArgs, float*, int*) = K == 1   ? ri_sum_kernel<1, TANGENT>
                                    : K == 2 ? ri_sum_kernel<2, TANGENT>
                                    : K == 4 ? ri_sum_kernel<4, TANGENT>
                                             : ri_sum_kernel<8, TANGENT>;
  RT_LAUNCH(k, blocks_of(a.S, K), THREADS, st, a, out, dn);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The mean surrounding RI of S points (point (S, 3), time_ratio (S,)) over
// the scene's N rows (position, delta_position, scale (N, 3), rotation
// (N, 3, 3), obj_type (N,) int32, valid (N,) bool, refractive_index (N,)),
// into ri_out (S,) float32 and den_out (S,) int32 (the count of contained
// rows where their sum exceeded 1, else 0), K lanes a point (1, 2, 4 or 8);
// every array contiguous, as CUDA device pointers (host pointers in the host
// rehearsal).  Launches on `stream`, does not synchronise, returns
// cudaGetLastError().
extern "C" int rt_ri_sum(const void* point, const void* time_ratio, const void* position,
                         const void* delta, const void* rotation, const void* scale,
                         const void* obj_type, const void* valid, const void* ri, long long S,
                         int N, int K, void* ri_out, void* den_out, void* stream) {
  if (S < 0 || N < 0 || (K != 1 && K != 2 && K != 4 && K != 8)) return (int)cudaErrorInvalidValue;
  if (S == 0) return 0;
  const RiArgs a = args_of(point, time_ratio, position, delta, rotation, scale, obj_type, valid,
                           ri, S, N);
  float* out = static_cast<float*>(ri_out);
  int* dn = static_cast<int*>(den_out);
  return launch_sum<false>(a, K, out, dn, static_cast<cudaStream_t>(stream));
}

// The tangent of rt_ri_sum's output for the rows' RI tangent `tangent` (N,)
// float32, given the forward's den_out `den` (S,): into t_out (S,) float32,
// the contained rows' tangents added in row order over den where den > 0,
// else 0.  The other arguments as rt_ri_sum's.  Launches on `stream`, does
// not synchronise, returns cudaGetLastError().
extern "C" int rt_ri_sum_jvp(const void* point, const void* time_ratio, const void* position,
                             const void* delta, const void* rotation, const void* scale,
                             const void* obj_type, const void* valid, const void* ri, long long S,
                             int N, int K, const void* tangent, const void* den, void* t_out,
                             void* stream) {
  if (S < 0 || N < 0 || (K != 1 && K != 2 && K != 4 && K != 8)) return (int)cudaErrorInvalidValue;
  if (S == 0) return 0;
  RiArgs a = args_of(point, time_ratio, position, delta, rotation, scale, obj_type, valid, ri, S,
                     N);
  a.add = static_cast<const float*>(tangent);
  float* out = static_cast<float*>(t_out);
  int* dn = static_cast<int*>(const_cast<void*>(den));  // read only: TANGENT writes no count
  return launch_sum<true>(a, K, out, dn, static_cast<cudaStream_t>(stream));
}

// grad_ri (N,) float32 += the gradient of rt_ri_sum's output with respect
// to the rows' RI, given the output's gradient g (S,) and the forward's
// den_out (S,); grad_ri must be zeroed first.  The tile mode runs where its
// 4 N bytes of shared memory are at most `smem_budget`, else the global
// mode; `*mode` gets 1 for the tile, 0 for global.  The other arguments as
// rt_ri_sum's.  Launches on `stream`, does not synchronise, returns
// cudaGetLastError().
extern "C" int rt_ri_sum_grad(const void* point, const void* time_ratio, const void* position,
                              const void* delta, const void* rotation, const void* scale,
                              const void* obj_type, const void* valid, const void* ri,
                              long long S, int N, int K, const void* g, const void* den,
                              long long smem_budget, int* mode, void* grad_ri, void* stream) {
  if (S < 0 || N < 0 || (K != 1 && K != 2 && K != 4 && K != 8)) return (int)cudaErrorInvalidValue;
  const long long bytes = 4LL * N;
  const int shared = bytes <= smem_budget ? 1 : 0;
  if (mode) *mode = shared;
  if (S == 0 || N == 0) return 0;
  const RiArgs a = args_of(point, time_ratio, position, delta, rotation, scale, obj_type, valid,
                           ri, S, N);
  const float* gp = static_cast<const float*>(g);
  const int* dp = static_cast<const int*>(den);
  float* out = static_cast<float*>(grad_ri);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = blocks_of(S, K);
  const size_t smem = shared ? (size_t)bytes : 0;
  switch (K) {
    case 1: RT_LAUNCH_SMEM(ri_sum_grad_kernel<1>, blocks, THREADS, smem, st, a, gp, dp, out, shared); break;
    case 2: RT_LAUNCH_SMEM(ri_sum_grad_kernel<2>, blocks, THREADS, smem, st, a, gp, dp, out, shared); break;
    case 4: RT_LAUNCH_SMEM(ri_sum_grad_kernel<4>, blocks, THREADS, smem, st, a, gp, dp, out, shared); break;
    default: RT_LAUNCH_SMEM(ri_sum_grad_kernel<8>, blocks, THREADS, smem, st, a, gp, dp, out, shared); break;
  }
  return static_cast<int>(cudaGetLastError());
}
