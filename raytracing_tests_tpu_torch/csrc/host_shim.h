// Host stand-ins for the few CUDA names the kernels use, so that the .cu
// sources compile as plain C++ (g++ -x c++ -include host_shim.h) and run on
// CPU buffers.  This is a rehearsal of the sources' logic, layouts and
// argument order where there is no GPU; it says nothing about the GPU build.
//
// A launch runs its threads one after another, each as a warp of one lane
// (threadIdx.x = 0, blockDim.x = 1, blockIdx.x = the flat thread index): the
// ballots and shuffles see only their own lane, and a persistent kernel's
// first thread takes all the work.
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
static RtIdx blockIdx, blockDim, threadIdx;

template <class V>
inline V __ldg(const V* p) {
  return *p;
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
template <class V>
inline V atomicAdd(V* p, V v) {
  const V old = *p;
  *p += v;
  return old;
}

typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum { cudaDevAttrMultiProcessorCount = 16 };
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
alignas(16) static unsigned char rt_host_shared[1 << 16];
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
    for (long long rt_i = 0; rt_i < rt_n; ++rt_i) {                          \
      blockIdx.x = (unsigned)rt_i;                                           \
      kernel(__VA_ARGS__);                                                   \
    }                                                                        \
  } while (0)
