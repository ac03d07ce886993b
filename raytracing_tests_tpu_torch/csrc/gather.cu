// The gradient path's winner gather and its backward, for Hopper (sm_90a).
//
// Replaces no TPU kernel: it is the counterpart of the XLA fusion of the JAX
// package's per-lane gathers of the winner's scene rows and of their
// scatter-add transpose, raytracing_tests_tpu/diff/fastpath.py:141-145 and
// :200-208 (`scene.position[safe]` and the other fields), which no
// pallas_call stands behind.  The port's differentiable recompute
// (raytracing_tests_tpu_torch/diff/fastpath.py::intersect_diff) reads one
// packed float table (N, F) of the scene's fields, one field after another
// in column order, and one int table (N, FI) of its integer fields
// (kernels/gather.py::pack_table).
//
// winner_gather_kernel: field k of lane b is table[max(obj[b], 0), its
// columns], written into the field's own contiguous output (B, width) and
// each int column into its own (B,) output, so that the recompute's
// elementwise kernels read dense rows.  One thread a (lane, column), the
// threads ordered field by field, lane-major within a field, so a warp's
// stores are consecutive.  A copy: it equals index_select bit for bit in any
// build.
//
// winner_scatter_kernel: the backward, grad_table[max(obj[b], 0), column] +=
// the field's gradient at (b, column), for the fields that have one (the
// columns of the others stay zero).  PyTorch's index_add_ does one global
// atomic a (lane, column); on the gradient path half the lanes' winner is the
// ground sphere (row 0), so those atomics land on a few addresses and
// serialise.  Here:
//   - each warp groups its lanes by row (__match_any_sync) and sums each
//     group's columns by a tree of shuffles over the group's members in
//     lane order (five steps), so only the group's leader adds;
//   - in the tile mode a block keeps an (N, G) float tile (G: the columns
//     with a gradient) and a bitmask of the rows it touched in shared
//     memory, the leaders add into the tile with shared atomics, and the
//     block then adds the rows it touched into global memory, one global
//     atomic a (block, row, column);
//   - where the tile does not fit the caller's shared-memory budget the
//     leaders add straight into global memory (the global mode, the same
//     kernel).
// Each block takes a contiguous run of lanes (`per_block`), so its tile is
// flushed once.  The sums run in another order than index_add_'s (whose
// order is that of its atomics, which varies from run to run).
//
// What bounds both on this card: bytes.  The gather reads obj (4 B a lane)
// and writes F + FI values a lane; the tables (N (F + FI) values, 57 KB for
// N = 488) stay in L1/L2.  The backward reads obj and G values a lane and
// writes N F values, at 3.35 TB/s; the operations (one add a lane and
// column) are far below the card's rate.
#include "rt_common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr unsigned FULL = 0xffffffffu;
constexpr int GROUP_STEPS = 5;  // log2 of a warp
constexpr int MAX_FIELDS = 16;  // float fields, and int columns
constexpr int MAX_COLS = 64;    // columns of the float table

struct GatherArgs {
  const float* table;  // (N, F)
  const int* itable;   // (N, FI)
  const int* obj;      // (B,)
  float* out[MAX_FIELDS];  // field k: (B, width[k])
  int* iout[MAX_FIELDS];   // int column j: (B,)
  int width[MAX_FIELDS];   // the fields' widths, in column order; they sum to F
  long long B;
  int N, F, FI;
};

__global__ void __launch_bounds__(THREADS) winner_gather_kernel(GatherArgs a) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= a.B * (a.F + a.FI)) return;
  if (e < a.B * a.F) {
    long long at = e;  // the element within field k's output
    int k = 0, start = 0;
    while (at >= a.B * a.width[k]) {
      at -= a.B * a.width[k];
      start += a.width[k];
      ++k;
    }
    const long long b = at / a.width[k];
    const int o = a.obj[b];
    const int row = o > 0 ? o : 0;
    a.out[k][at] = a.table[(long long)row * a.F + start + (int)(at - b * a.width[k])];
  } else {
    const long long at = e - a.B * a.F;
    const int j = (int)(at / a.B);
    const long long b = at - (long long)j * a.B;
    const int o = a.obj[b];
    const int row = o > 0 ? o : 0;
    a.iout[j][b] = a.itable[(long long)row * a.FI + j];
  }
}

struct ScatterArgs {
  const float* grad[MAX_FIELDS];  // field k's gradient (B, width[k])
  int width[MAX_FIELDS];
  // the G columns with a gradient: their field, their column within it and
  // their column in the table
  int col_field[MAX_COLS], col_in_field[MAX_COLS], col_table[MAX_COLS];
  const int* obj;     // (B,)
  float* grad_table;  // (N, F), zeroed by the caller
  long long B;
  long long per_block;  // lanes a block takes, a multiple of THREADS
  int N, F, G;
  int shared;  // 1: the (N, G) tile in shared memory; 0: global atomics
};

__global__ void __launch_bounds__(THREADS) winner_scatter_kernel(ScatterArgs a) {
  RT_DYNAMIC_SHARED(float, smem);
  float* tile = smem;                                                         // (N, G)
  unsigned* touched = reinterpret_cast<unsigned*>(smem + (size_t)a.N * a.G);  // N bits
  const int words = (a.N + 31) / 32;
  if (a.shared) {
    for (int k = threadIdx.x; k < a.N * a.G; k += blockDim.x) tile[k] = 0.0f;
    for (int k = threadIdx.x; k < words; k += blockDim.x) touched[k] = 0u;
    __syncthreads();
  }

  const unsigned lane = threadIdx.x & 31u;
  const long long start = (long long)blockIdx.x * a.per_block;
  const long long end = start + a.per_block < a.B ? start + a.per_block : a.B;
  // Every thread of the block runs the same iterations (the base is
  // uniform), so every lane of a warp reaches the warp-wide calls.
  for (long long base = start; base < end; base += blockDim.x) {
    const long long i = base + threadIdx.x;
    const bool valid = i < end;
    const int row = valid ? (a.obj[i] > 0 ? a.obj[i] : 0) : -1;
    const unsigned peers = __match_any_sync(FULL, row);
    // The group's members in lane order: this lane's rank, and the members
    // 1, 2, 4, 8 and 16 places above it, whose partial sums it takes.
    const int rank = __popc(peers & ((1u << lane) - 1u));
    unsigned above = peers & ~((2u << lane) - 1u);  // lane 31: 2u << 31 == 0
    int src[GROUP_STEPS];
    int skipped = 0;
    for (int k = 0; k < GROUP_STEPS; ++k) {
      while (above && skipped < (1 << k) - 1) {
        above &= above - 1u;
        ++skipped;
      }
      src[k] = above ? __ffs(above) - 1 : -1;
    }
    const bool leader = rank == 0 && row >= 0;
    if (leader && a.shared) atomicOr(&touched[row >> 5], 1u << (row & 31));
    for (int c = 0; c < a.G; ++c) {
      const int f = a.col_field[c];
      float v = valid ? a.grad[f][i * a.width[f] + a.col_in_field[c]] : 0.0f;
      for (int k = 0; k < GROUP_STEPS; ++k) {
        const float x = __shfl_sync(FULL, v, src[k] >= 0 ? src[k] : (int)lane);
        if (src[k] >= 0 && (rank & ((2 << k) - 1)) == 0) v += x;
      }
      if (leader) {
        if (a.shared) {
          atomicAdd(&tile[row * a.G + c], v);
        } else {
          atomicAdd(&a.grad_table[(long long)row * a.F + a.col_table[c]], v);
        }
      }
    }
  }

  if (a.shared) {
    __syncthreads();
    for (int k = threadIdx.x; k < a.N * a.G; k += blockDim.x) {
      const int row = k / a.G;
      if (touched[row >> 5] & (1u << (row & 31))) {
        atomicAdd(&a.grad_table[(long long)row * a.F + a.col_table[k - row * a.G]], tile[k]);
      }
    }
  }
}

// Bytes of the backward's tile mode for N rows and G columns: the (N, G)
// tile and a bit a row.
inline long long scatter_smem(int N, int G) { return 4LL * N * G + 4LL * ((N + 31) / 32); }

// The SM count of device `dev`, read once a device: the backward is launched
// once a pop, and the attribute call costs more host time than the launch.
inline int sm_count(int dev) {
  constexpr int DEVICES = 64;
  static int sms[DEVICES] = {};
  const bool kept = dev >= 0 && dev < DEVICES;
  if (kept && sms[dev] > 0) return sms[dev];
  int n = 1;
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  n = n > 0 ? n : 1;
  if (kept) sms[dev] = n;
  return n;
}

}  // namespace

// The `fields` float fields of table (N, F) (widths `width`, in column
// order, summing to F) at the rows max(obj, 0) into outs[k] (B, width[k])
// and the FI int columns of itable (N, FI) into iouts[j] (B,); every array
// contiguous, as CUDA device pointers (host pointers in the host rehearsal).
// Launches on `stream`, does not synchronise, returns cudaGetLastError().
extern "C" int rt_winner_gather(const void* table, const void* itable, const void* obj,
                                void* const* outs, const int* width, int fields,
                                void* const* iouts, long long B, int N, int F, int FI,
                                void* stream) {
  if (fields < 0 || fields > MAX_FIELDS || FI < 0 || FI > MAX_FIELDS) {
    return (int)cudaErrorInvalidValue;
  }
  GatherArgs a;
  int cols = 0;
  for (int k = 0; k < fields; ++k) {
    if (width[k] <= 0) return (int)cudaErrorInvalidValue;
    a.out[k] = static_cast<float*>(outs[k]);
    a.width[k] = width[k];
    cols += width[k];
  }
  if (cols != F) return (int)cudaErrorInvalidValue;
  for (int j = 0; j < FI; ++j) a.iout[j] = static_cast<int*>(iouts[j]);
  if (B <= 0 || N <= 0 || F + FI == 0) return 0;
  a.table = static_cast<const float*>(table);
  a.itable = static_cast<const int*>(itable);
  a.obj = static_cast<const int*>(obj);
  a.B = B;
  a.N = N;
  a.F = F;
  a.FI = FI;
  const long long blocks = (B * (F + FI) + THREADS - 1) / THREADS;
  RT_LAUNCH(winner_gather_kernel, (int)blocks, THREADS, static_cast<cudaStream_t>(stream), a);
  return static_cast<int>(cudaGetLastError());
}

// grad_table (N, F) float32 += each field's gradient grads[k] (B, width[k])
// at the rows max(obj, 0), for the fields whose pointer is not null (widths
// in column order, summing to F); grad_table must be zeroed first and the
// other fields' columns are left as they are.  The tile mode runs where its
// shared memory (4 N G bytes and a bit a row, G the columns with a gradient)
// is at most `smem_budget` bytes, else the global mode; `*mode` gets 1 for
// the tile, 0 for global.  Launches on `stream`, does not synchronise,
// returns cudaGetLastError() (or the attribute call's error).
extern "C" int rt_winner_scatter(const void* const* grads, const int* width, int fields,
                                 const void* obj, void* grad_table, long long B, int N, int F,
                                 long long smem_budget, int* mode, void* stream) {
  if (fields < 0 || fields > MAX_FIELDS || F > MAX_COLS) return (int)cudaErrorInvalidValue;
  ScatterArgs a;
  int G = 0, cols = 0;
  for (int k = 0; k < fields; ++k) {
    if (width[k] <= 0) return (int)cudaErrorInvalidValue;
    a.grad[k] = static_cast<const float*>(grads[k]);
    a.width[k] = width[k];
    for (int j = 0; j < width[k] && a.grad[k]; ++j) {
      a.col_field[G] = k;
      a.col_in_field[G] = j;
      a.col_table[G] = cols + j;
      ++G;
    }
    cols += width[k];
  }
  if (cols != F) return (int)cudaErrorInvalidValue;
  const long long smem = scatter_smem(N, G);
  const int shared = smem <= smem_budget ? 1 : 0;
  if (mode) *mode = shared;
  if (B <= 0 || N <= 0 || G == 0) return 0;
  int dev = 0;
  cudaGetDevice(&dev);
  const int sms = sm_count(dev);
  // Two blocks an SM: few enough that each tile's flush is paid for by many
  // lanes, enough that every SM works.
  const long long want = 2LL * sms;
  long long per_block = (B + want - 1) / want;
  per_block = (per_block + THREADS - 1) / THREADS * THREADS;
  const long long blocks = (B + per_block - 1) / per_block;
  a.obj = static_cast<const int*>(obj);
  a.grad_table = static_cast<float*>(grad_table);
  a.B = B;
  a.per_block = per_block;
  a.N = N;
  a.F = F;
  a.G = G;
  a.shared = shared;
  const size_t bytes = shared ? (size_t)smem : 0;
  if (bytes > 48 * 1024) {
    // raised once a device to the most asked for so far, as the SM count is read
    static size_t allowed[64] = {};
    const bool kept = dev >= 0 && dev < 64;
    if (!kept || bytes > allowed[dev]) {
      const int err = (int)cudaFuncSetAttribute(
          winner_scatter_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
      if (err) return err;
      if (kept) allowed[dev] = bytes;
    }
  }
  RT_LAUNCH_SMEM(winner_scatter_kernel, (int)blocks, THREADS, bytes,
                 static_cast<cudaStream_t>(stream), a);
  return static_cast<int>(cudaGetLastError());
}
