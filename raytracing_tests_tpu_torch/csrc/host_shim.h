// Host stand-ins for the few CUDA names the kernels use, so that the .cu
// sources compile as plain C++ (g++ -x c++ -include host_shim.h) and run on
// CPU buffers.  This is a rehearsal of the sources' logic, layouts and
// argument order where there is no GPU; it says nothing about the GPU build.
//
// A launch runs its threads one after another, each as a warp of one lane
// (threadIdx.x = 0, blockDim.x = 1, blockIdx.x = the flat thread index,
// gridDim.x = the flat thread count): the ballots and shuffles see only their
// own lane, and a persistent kernel's first thread takes all the work.  A
// cooperative launch runs the whole grid up to its grid barrier, then the
// whole grid after it (RT_GRID_PHASE), so a kernel keeps nothing but global
// memory across the barrier.
#pragma once
#define RT_HOST_REHEARSAL 1
#define RT_WARP_LANES 1  // a warp of one lane: row stride 1

#include <math.h>
#include <stddef.h>
#include <string.h>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __grid_constant__
#define __shared__ static  // one warp of one lane runs at a time

struct float4 {
  float x, y, z, w;
};
inline float4 make_float4(float x, float y, float z, float w) {
  return float4{x, y, z, w};
}

struct RtIdx {
  unsigned x, y, z;
};
static RtIdx blockIdx, blockDim, threadIdx, gridDim;

template <class V>
inline V __ldg(const V* p) {
  return *p;
}
template <class V>
inline V __ldcg(const V* p) {
  return *p;
}
template <class V>
inline void __stcg(V* p, V v) {
  *p = v;
}
inline unsigned __ballot_sync(unsigned, int pred) { return pred ? 1u : 0u; }
inline int __all_sync(unsigned, int pred) { return pred; }
template <class V>
inline V __shfl_sync(unsigned, V v, int) {
  return v;
}
template <class V>
inline V __shfl_down_sync(unsigned, V, int) {
  return V(0);  // no lane beyond the first
}
template <class V>
inline V __shfl_xor_sync(unsigned, V v, int) {
  return v;
}
template <class V>
inline unsigned __match_any_sync(unsigned, V) {
  return 1u;  // the lane's own bit: a warp of one lane
}
inline unsigned __reduce_min_sync(unsigned, unsigned v) { return v; }
inline unsigned __reduce_add_sync(unsigned, unsigned v) { return v; }
inline unsigned __reduce_max_sync(unsigned, unsigned v) { return v; }
inline void __syncwarp(unsigned = 0xffffffffu) {}
inline void __syncthreads() {}
inline unsigned __float_as_uint(float x) {
  unsigned u;
  memcpy(&u, &x, sizeof u);
  return u;
}
inline float __uint_as_float(unsigned u) {
  float x;
  memcpy(&x, &u, sizeof x);
  return x;
}
inline int __ffs(unsigned v) { return __builtin_ffs((int)v); }
inline int __popc(unsigned v) { return __builtin_popcount(v); }
inline float rsqrtf(float x) { return 1.0f / sqrtf(x); }
inline float __fmaf_rn(float a, float b, float c) { return fmaf(a, b, c); }
template <class V>
inline V atomicAdd(V* p, V v) {
  const V old = *p;
  *p += v;
  return old;
}
template <class V>
inline V atomicOr(V* p, V v) {
  const V old = *p;
  *p |= v;
  return old;
}
template <class V>
inline V atomicMax(V* p, V v) {
  const V old = *p;
  if (v > old) *p = v;
  return old;
}

typedef int cudaError_t;
typedef void* cudaStream_t;
enum {
  cudaSuccess = 0,
  cudaErrorInvalidValue = 1,
  cudaErrorInvalidConfiguration = 9,
  cudaErrorCooperativeLaunchTooLarge = 82
};
enum { cudaDevAttrMultiProcessorCount = 16 };
enum { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
template <class K>
inline int cudaFuncSetAttribute(K, int, int) {
  return 0;
}
inline int cudaGetLastError() { return 0; }
inline int cudaMemsetAsync(void* p, int v, size_t n, cudaStream_t) {
  memset(p, v, n);
  return 0;
}
inline int cudaGetDevice(int* d) {
  *d = 0;
  return 0;
}
inline int cudaDeviceGetAttribute(int* v, int, int) {
  *v = 1;
  return 0;
}
template <class K>
inline int cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, K, int, size_t) {
  *n = 1;
  return 0;
}

// A block's dynamic shared memory: one buffer, since one thread runs at a time.
// As much as a block may ask for on the card (227 KB), and more.
alignas(16) static unsigned char rt_host_shared[1 << 18];
#define RT_DYNAMIC_SHARED(type, name) type* name = reinterpret_cast<type*>(rt_host_shared)
#define RT_LAUNCH_SMEM(kernel, blocks, threads, smem, stream, ...)             \
  do {                                                                       \
    if ((size_t)(smem) > sizeof rt_host_shared) return cudaErrorInvalidValue; \
    RT_LAUNCH(kernel, blocks, threads, stream, __VA_ARGS__);                 \
  } while (0)

#define RT_LAUNCH(kernel, blocks, threads, stream, ...)                      \
  do {                                                                       \
    (void)(stream);                                                          \
    blockDim.x = 1;                                                          \
    threadIdx.x = 0;                                                         \
    const long long rt_n = (long long)(blocks) * (long long)(threads);       \
    gridDim.x = (unsigned)rt_n;                                              \
    for (long long rt_i = 0; rt_i < rt_n; ++rt_i) {                          \
      blockIdx.x = (unsigned)rt_i;                                           \
      kernel(__VA_ARGS__);                                                   \
    }                                                                        \
  } while (0)

// A cooperative launch (one argument struct) -> an error code: the grid runs
// once for each stretch between its barriers, RT_GRID_PHASE(n) true in the
// n-th run only.
static int rt_grid_phase;
constexpr int RT_GRID_PHASES = 2;  // stretches a cooperative kernel may have
#define RT_GRID_SYNC() ((void)0)
#define RT_GRID_PHASE(n) (rt_grid_phase == (n))
#define RT_LAUNCH_COOPERATIVE(kernel, blocks, threads, smem, stream, arg)             \
  ([&]() -> int {                                                                 \
    if ((size_t)(smem) > sizeof rt_host_shared) return cudaErrorInvalidValue;     \
    for (rt_grid_phase = 0; rt_grid_phase < RT_GRID_PHASES; ++rt_grid_phase) {    \
      RT_LAUNCH(kernel, blocks, threads, stream, arg);                            \
    }                                                                             \
    rt_grid_phase = 0;                                                            \
    return cudaSuccess;                                                           \
  }())
