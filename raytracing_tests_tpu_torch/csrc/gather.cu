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
// elementwise kernels read dense rows.  One thread a lane, a grid of
// resident blocks (1 024 threads; as many an SM as the occupancy calculator
// allows, one where the threads' registers fill the SM's file) looping over
// 32-lane chunks.  Each block first copies both tables into shared memory as they
// lie (57 KB at 488 rows, 124 KB at 1 032), 16 bytes a copy by cp.async, all
// in flight at once.  A lane reads obj once and its row from shared memory
// (half the lanes, on the ground sphere's row 0, read it as a broadcast); a
// warp writes a field of width w > 1 through a (32, w) stage in shared
// memory, so that each store instruction writes 128 contiguous bytes.  The
// field offsets come with the arguments: no division and no search over the
// widths.  A table over the shared-memory budget is read through __ldg (L1
// and L2) by the same code (STAGED = false, 512 threads a block).  A copy:
// it equals index_select bit for bit in any build.
//
// winner_scatter_kernel: the backward, grad_table[max(obj[b], 0), column] =
// the sum of the field's gradient at (b, column) over the lanes b of each
// row, for the G columns whose field has a gradient (0 in the others).  The
// sum runs in an order fixed by lane and block index, the same on every
// launch (kernels/gather.py::winner_scatter_ordered is that order in plain
// PyTorch):
//   1. Block j of the grid (one a streaming multiprocessor) takes lanes
//      [j L, (j + 1) L), L a multiple of the warp; its lanes fall into
//      chunks of a warp's 32 (one in the host rehearsal).
//   2. Within a chunk, the lanes of one row (__match_any_sync) are summed by
//      a tree over the group's members in lane order: at step k (1, 2, 4, 8,
//      16 members apart) each member of rank r = 0 mod 2^(k+1) adds the
//      partial sum of the member of rank r + 2^k.  The group's rank-0 lane
//      holds the sum.  The groups and trees are worked out once a chunk into
//      shared memory (a row and a word of shuffle sources a lane).
//   3. A block's (N, G) tile starts at 0; the chunk sums are added into it
//      chunk after chunk, in lane order.  Each warp of the block owns
//      columns (32 G threads a block), so no two threads add into one entry
//      and no atomic is needed.  The block reads its lanes in batches of up
//      to 512: obj and each field's gradient as they lie (a contiguous run
//      of the field's (B, width) rows), copied into shared memory 16 bytes
//      at a time by cp.async, the next batch's copies in flight while this
//      one is summed.  In the tile mode the tile lives in shared
//      memory and is then written to the block's slice of the scratch
//      (blocks, N, G) with plain stores; in the global mode (a tile over the
//      budget) the block adds into its slice of the scratch directly.  Both
//      modes add in the same order and give the same bits.
//   4. After a grid-wide barrier (a cooperative launch: every block resident
//      at once), each (row, column) of the output is summed over the blocks'
//      tiles in block order: `segments` runs of consecutive blocks, each
//      summed from 0 by one warp, and the runs' sums added from 0 in order.
//      That spreads the final sum over every block of the grid, a (row,
//      column) a lane in each of FINAL_TILES runs of 32 entries at once.
// Nothing is added by atomics, so the result does not depend on scheduling.
// The kernel writes every (row, column) of grad_table, so the caller need not
// zero it.
//
// What bounds both on this card: bytes.  The gather reads obj (4 B a lane)
// and the tables once and writes F + FI values a lane.  The backward reads
// obj and G values a lane and writes N F values; its scratch round trip (the
// blocks' tiles, 4.4 MB at 132 x 488 x 17, which stay in the L2 cache) is
// cost, not part of the bound.  The operations (one add a lane and column)
// are far below the card's rate.
#include "rt_common.cuh"

#ifndef RT_HOST_REHEARSAL
#include <cooperative_groups.h>
// A barrier of the whole grid of a cooperative launch (RT_LAUNCH_COOPERATIVE).
#define RT_GRID_SYNC() cooperative_groups::this_grid().sync()
// Whether the code between the n-th grid barrier and the next runs in this
// pass of the kernel: on the card, one pass runs all of it.
#define RT_GRID_PHASE(n) true
#endif

#ifndef RT_WARP_LANES
#define RT_WARP_LANES 32
#endif

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int WL = RT_WARP_LANES;  // a warp's lanes: 32, one in the host rehearsal
constexpr int GROUP_STEPS = 5;     // log2 of a warp of 32
constexpr int MAX_FIELDS = 16;     // float fields, and int columns
constexpr int MAX_COLS = 64;       // columns of the float table
constexpr int GATHER_THREADS = 1024;  // a block of the staged route
constexpr int GATHER_THREADS_LDG = 512;  // a block of the __ldg route
constexpr int SCATTER_WARPS = 32;  // at most: one a column
constexpr int MAX_CHUNKS = 16;     // chunks of a warp's lanes a batch of the backward, at most
constexpr int UNROLL = 8;          // chunks whose sums a warp works on at once
constexpr int FINAL_TILES = 4;     // runs of WL output entries a lane sums at once
constexpr long long SMEM_MAX = 232448;  // a block's shared memory on the card, at most

// 4 or 16 bytes from global to shared memory without passing through
// registers (cp.async); the host rehearsal copies directly.
__device__ __forceinline__ void copy4(void* dst, const void* src) {
#ifdef RT_HOST_REHEARSAL
  memcpy(dst, src, 4);
#else
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(__cvta_generic_to_global(src)));
#endif
}

__device__ __forceinline__ void copy16(void* dst, const void* src) {
#ifdef RT_HOST_REHEARSAL
  memcpy(dst, src, 16);
#else
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(__cvta_generic_to_global(src)));
#endif
}

// The block copies `count` 4-byte words from src to dst, 16 bytes a copy
// where both are 16-byte aligned (on the card they are: a batch starts at a
// multiple of 32 lanes), then 4 bytes a copy.
__device__ __forceinline__ void copy_run(void* dst, const void* src, int count) {
  const bool wide = ((reinterpret_cast<size_t>(dst) | reinterpret_cast<size_t>(src)) & 15) == 0;
  const int quads = wide ? count / 4 : 0;
  const char* s = static_cast<const char*>(src);
  char* d = static_cast<char*>(dst);
  for (int q = (int)threadIdx.x; q < quads; q += (int)blockDim.x) copy16(d + 16 * q, s + 16 * q);
  for (int i = 4 * quads + (int)threadIdx.x; i < count; i += (int)blockDim.x) {
    copy4(d + 4 * i, s + 4 * i);
  }
}

// Closes this thread's group of copies issued since the last.
__device__ __forceinline__ void copies_commit() {
#ifndef RT_HOST_REHEARSAL
  asm volatile("cp.async.commit_group;\n" ::);
#endif
}

// Waits until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void copies_wait() {
#ifndef RT_HOST_REHEARSAL
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
#endif
}

struct GatherArgs {
  const float* table;  // (N, F)
  const int* itable;   // (N, FI)
  const int* obj;      // (B,)
  float* out[MAX_FIELDS];  // field k: (B, width[k])
  int* iout[MAX_FIELDS];   // int column j: (B,)
  int width[MAX_FIELDS];   // the fields' widths, in column order; they sum to F
  int start[MAX_FIELDS];   // the fields' first columns
  long long B;
  int N, F, FI, fields;
  int stage_w;  // the widest field of width > 1 (the stage's columns), or 0
};

// The gather's shared memory: the tables (STAGED) and a (WL, stage_w) stage a
// warp.
inline long long gather_smem(bool staged, int N, int F, int FI, int stage_w, int warps) {
  return 4LL * (staged ? (long long)N * (F + FI) : 0) + 4LL * warps * WL * stage_w;
}

template <bool STAGED>
__global__ void __launch_bounds__(STAGED ? GATHER_THREADS : GATHER_THREADS_LDG)
    winner_gather_kernel(const __grid_constant__ GatherArgs a) {
  RT_DYNAMIC_SHARED(float, smem);
  const int warps = (int)blockDim.x / WL, warp = (int)threadIdx.x / WL;
  const int lane = (int)threadIdx.x % WL;
  const float* tab = a.table;
  const int* itab = a.itable;
  float* stage = smem + (size_t)warp * WL * a.stage_w;
  if (STAGED) {
    float* t = smem;
    int* it = reinterpret_cast<int*>(smem + (size_t)a.N * a.F);
    copy_run(t, a.table, a.N * a.F);  // as they lie, 16 bytes a copy, all in flight at once
    copy_run(it, a.itable, a.N * a.FI);
    copies_commit();
    copies_wait<0>();
    __syncthreads();
    tab = t;
    itab = it;
    stage += (size_t)a.N * (a.F + a.FI);
  }
  const long long chunks = (a.B + WL - 1) / WL;
  for (long long ch = (long long)blockIdx.x * warps + warp; ch < chunks;
       ch += (long long)gridDim.x * warps) {
    const long long base = ch * WL;
    const long long b = base + lane;
    const bool valid = b < a.B;
    const int n = a.B - base < WL ? (int)(a.B - base) : WL;  // the chunk's lanes
    int row = 0;
    if (valid) {
      const int o = __ldg(a.obj + b);
      row = o > 0 ? o : 0;
    }
    const float* src = tab + (size_t)row * a.F;
#pragma unroll
    for (int k = 0; k < MAX_FIELDS; ++k) {
      if (k >= a.fields) break;
      const int w = a.width[k], st = a.start[k];
      if (w == 1) {  // a warp's stores are 128 contiguous bytes already
        if (valid) a.out[k][b] = STAGED ? src[st] : __ldg(src + st);
        continue;
      }
      if (valid) {
        for (int j = 0; j < w; ++j) stage[lane * w + j] = STAGED ? src[st + j] : __ldg(src + st + j);
      }
      __syncwarp();
      float* o = a.out[k] + base * w;
      for (int t = lane; t < n * w; t += WL) o[t] = stage[t];
      __syncwarp();
    }
    const int* irow = itab + (size_t)row * a.FI;
#pragma unroll
    for (int j = 0; j < MAX_FIELDS; ++j) {
      if (j >= a.FI) break;
      if (valid) a.iout[j][b] = STAGED ? irow[j] : __ldg(irow + j);
    }
  }
}

struct ScatterArgs {
  const float* grad[MAX_FIELDS];  // field k's gradient (B, width[k]), or null
  int width[MAX_FIELDS];
  // the G columns with a gradient: their field and their column within it
  int col_field[MAX_COLS], col_in_field[MAX_COLS];
  int col_grad[MAX_COLS];  // each of the F table columns: its gradient column, or -1
  const int* obj;      // (B,)
  float* partial;      // (blocks, N, G): each block's tile
  float* grad_table;   // (N, F), every entry written
  long long B;
  long long per_block;  // lanes a block takes, a multiple of WL
  int N, F, G, blocks, segments;
  int batch;  // lanes a batch: a multiple of WL, at most MAX_CHUNKS WL
  int col_first[MAX_COLS];  // each gradient column: its field's first gradient column
};

// Shared memory of the backward's batches of `batch` lanes (two buffers of
// a batch's rows and gradients, and a word of shuffle sources a lane), of
// the tile mode's (N, G) tile, and of the final sum (FINAL_TILES floats a
// lane a segment).
inline long long scatter_batch_smem(int G, int batch) { return 4LL * batch * (2 * (G + 1LL) + 1); }
inline long long scatter_smem(bool shared, int N, int G, int segments, int batch) {
  const long long first = (shared ? 4LL * N * G : 0) + scatter_batch_smem(G, batch);
  const long long last = 4LL * FINAL_TILES * segments * WL;
  return first > last ? first : last;
}

// A lane's shuffle tree within its chunk's group of lanes of one row, as one
// word: bits 6k..6k+4 the lane whose partial sum it takes at step k, bit
// 6k+5 whether it adds it, bit 31 whether it holds the group's sum (its
// rank is 0 and its row a real one).
__device__ __forceinline__ unsigned tree_word(int row) {
  const unsigned lane = threadIdx.x % WL;
  const unsigned peers = __match_any_sync(FULL, row);
  // the group's members in lane order: this lane's rank, and the members 1,
  // 2, 4, 8 and 16 places above it
  const int rank = __popc(peers & ((1u << lane) - 1u));
  unsigned above = peers & ~((2u << lane) - 1u);  // lane 31: 2u << 31 == 0
  unsigned word = rank == 0 && row >= 0 ? 1u << 31 : 0u;
  int skipped = 0;
#pragma unroll
  for (int k = 0; k < GROUP_STEPS; ++k) {
    while (above && skipped < (1 << k) - 1) {
      above &= above - 1u;
      ++skipped;
    }
    const bool adds = above && (rank & ((2 << k) - 1)) == 0;
    const unsigned src = adds ? (unsigned)(__ffs(above) - 1) : lane;
    word |= (src | (adds ? 32u : 0u)) << (6 * k);
  }
  return word;
}

// The block's copies of the batch of lanes [at, end) (at most a.batch):
// obj into rows[l]; each field with a gradient, as it lies (lane-major, its
// width a lane), into v from its first gradient column times a.batch on.
__device__ __forceinline__ void issue_batch(const ScatterArgs& a, long long at, long long end,
                                            float* v, int* rows) {
  const int n = end - at < a.batch ? (int)(end - at) : a.batch;
  copy_run(rows, a.obj + at, n);
  int g0 = 0;
  for (int k = 0; k < MAX_FIELDS && g0 < a.G; ++k) {
    if (!a.grad[k]) continue;
    const int w = a.width[k];
    copy_run(v + (size_t)g0 * a.batch, a.grad[k] + at * w, n * w);
    g0 += w;
  }
}

template <bool SHARED>
__global__ void __launch_bounds__(SCATTER_WARPS * 32, 1)
    winner_scatter_kernel(const __grid_constant__ ScatterArgs a) {
  RT_DYNAMIC_SHARED(float, smem);
  const int j = (int)blockIdx.x;
  if (j >= a.blocks) return;  // only in the host rehearsal's flat grid
  const int warps = (int)blockDim.x / WL, warp = (int)threadIdx.x / WL;
  const int lane = (int)threadIdx.x % WL;
  const int NG = a.N * a.G;

  if (RT_GRID_PHASE(0)) {
    float* tile = SHARED ? smem : a.partial + (size_t)j * NG;
    const int BATCH = a.batch;
    float* vals = smem + (SHARED ? NG : 0);                            // [2][G BATCH]
    int* srows = reinterpret_cast<int*>(vals + 2 * a.G * BATCH);        // [2][BATCH]
    unsigned* sword = reinterpret_cast<unsigned*>(srows + 2 * BATCH);   // [BATCH]
    for (int k = (int)threadIdx.x; k < NG; k += (int)blockDim.x) tile[k] = 0.0f;
    const long long start = (long long)j * a.per_block;
    const long long end = start + a.per_block < a.B ? start + a.per_block : a.B;
    const int batches = (int)((end - start + BATCH - 1) / BATCH);
    // batch k + 1's copies fly while batch k is summed
    issue_batch(a, start, end, vals, srows);
    copies_commit();
    for (int k = 0; k < batches; ++k) {
      const int buf = k & 1;
      const long long at = start + (long long)k * BATCH;
      if (k + 1 < batches) {
        issue_batch(a, at + BATCH, end, vals + (buf ^ 1) * a.G * BATCH, srows + (buf ^ 1) * BATCH);
      }
      copies_commit();  // an empty group after the last batch keeps the count
      copies_wait<1>();
      __syncthreads();  // every thread's copies of batch k have landed; the tile is zeroed
      const int n = end - at < BATCH ? (int)(end - at) : BATCH;
      const int nch = (n + WL - 1) / WL;
      int* rows = srows + buf * BATCH;
      const float* v = vals + buf * a.G * BATCH;
      // each warp works out its chunks' groups and trees
      for (int c = warp; c < nch; c += warps) {
        const int l = c * WL + lane;
        int row = -1;
        if (l < n) {
          const int o = rows[l];
          row = o > 0 ? o : 0;
        }
        sword[l] = tree_word(row);
        rows[l] = row;
      }
      __syncthreads();
      // each warp adds its columns' chunk sums into the tile, chunk after
      // chunk; shared memory by index from here (no generic addresses), a
      // lane past the batch clamped to its last (its value goes unused)
      const int* srow = reinterpret_cast<const int*>(smem);
      const unsigned* sw = reinterpret_cast<const unsigned*>(smem);
      const int ro = (int)(rows - reinterpret_cast<int*>(smem));
      const int wo = (int)(sword - reinterpret_cast<unsigned*>(smem));
      for (int g = warp; g < a.G; g += warps) {
        // column c of a field of width w: lane l's value at l w + c of the field's run
        const int w = a.width[a.col_field[g]];
        const int xo = (int)(v - smem) + a.col_first[g] * BATCH + a.col_in_field[g];
        for (int c0 = 0; c0 < nch; c0 += UNROLL) {
          float x[UNROLL];
          unsigned word[UNROLL];
#pragma unroll
          for (int u = 0; u < UNROLL; ++u) {
            const int at = (c0 + u) * WL + lane;
            const int l = at < BATCH ? at : BATCH - 1;
            const float raw = smem[xo + l * w];
            const unsigned wd = sw[wo + l];
            x[u] = c0 + u < nch && at < n ? raw : 0.0f;
            word[u] = c0 + u < nch ? wd : 0u;
          }
#pragma unroll
          for (int k = 0; k < GROUP_STEPS; ++k) {
#pragma unroll
            for (int u = 0; u < UNROLL; ++u) {
              const float y = __shfl_sync(FULL, x[u], (int)((word[u] >> (6 * k)) & 31u));
              if ((word[u] >> (6 * k + 5)) & 1u) x[u] += y;
            }
          }
#pragma unroll
          for (int u = 0; u < UNROLL; ++u) {
            const int at = (c0 + u) * WL + lane;
            const size_t r = (size_t)srow[ro + (at < BATCH ? at : BATCH - 1)];
            if (word[u] >> 31) {
              if (SHARED) {
                smem[r * a.G + g] += x[u];
              } else {  // through the L2 cache, where the warp's last store went
                float* p = tile + r * a.G + g;
                __stcg(p, __ldcg(p) + x[u]);
              }
            }
            __syncwarp();  // the next chunk's sum of a row may have another lane
          }
        }
      }
      __syncthreads();  // the batch's buffers are read
    }
    if (SHARED) {
      float* p = a.partial + (size_t)j * NG;
      for (int k = (int)threadIdx.x; k < NG; k += (int)blockDim.x) p[k] = tile[k];
    }
  }

  RT_GRID_SYNC();

  if (RT_GRID_PHASE(1)) {
    // the output's entries FINAL_TILES runs of WL at a time (run t of lane l:
    // entry e0 + t WL + l); warp w sums the blocks of segments w, w + warps,
    // ... for them, and the sums wait in ssum
    float* ssum = smem;
    const int E = a.N * a.F;
    const int L = (a.blocks + a.segments - 1) / a.segments;  // blocks a segment
    const int step = a.blocks * WL * FINAL_TILES;
    for (int e0 = j * WL * FINAL_TILES; e0 < E; e0 += step) {
      const float* p[FINAL_TILES];
      bool has[FINAL_TILES];
#pragma unroll
      for (int t = 0; t < FINAL_TILES; ++t) {
        const int e = e0 + t * WL + lane;
        has[t] = false;
        p[t] = a.partial;
        if (e < E) {
          const int row = e / a.F;
          const int g = a.col_grad[e - row * a.F];
          has[t] = g >= 0;
          p[t] = a.partial + (size_t)row * a.G + (g >= 0 ? g : 0);
        }
      }
      for (int s = warp; s < a.segments; s += warps) {
        const int hi = (s + 1) * L < a.blocks ? (s + 1) * L : a.blocks;
        float sum[FINAL_TILES];
#pragma unroll
        for (int t = 0; t < FINAL_TILES; ++t) sum[t] = 0.0f;
        for (int q = s * L; q < hi; ++q) {
#pragma unroll
          for (int t = 0; t < FINAL_TILES; ++t) {
            if (has[t]) sum[t] += __ldcg(p[t] + (size_t)q * NG);
          }
        }
#pragma unroll
        for (int t = 0; t < FINAL_TILES; ++t) ssum[(s * FINAL_TILES + t) * WL + lane] = sum[t];
      }
      __syncthreads();
      if (warp == 0) {
#pragma unroll
        for (int t = 0; t < FINAL_TILES; ++t) {
          const int e = e0 + t * WL + lane;
          if (e >= E) continue;
          float acc = 0.0f;
          for (int s = 0; s < a.segments; ++s) acc += ssum[(s * FINAL_TILES + t) * WL + lane];
          a.grad_table[e] = acc;
        }
      }
      __syncthreads();
    }
  }
}

// The SM count of device `dev`, read once a device: the kernels are
// launched once a pop, and the attribute call costs more host time than the
// launch.
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

// Lets `kernel` take `bytes` of dynamic shared memory on device `dev` (above
// 48 KB it must be allowed first), raised once a device to the most asked
// for so far; and its resident blocks an SM at that size, kept for the last
// size asked for.  `kept` holds both for one kernel.
struct SmemKept {
  size_t allowed[64];
  size_t at[64];
  int per_sm[64];
};

template <class K>
int allow_smem(K kernel, int dev, size_t bytes, int threads, SmemKept& kept, int* per_sm) {
  const bool in = dev >= 0 && dev < 64;
  if (bytes > 48 * 1024 && (!in || bytes > kept.allowed[dev])) {
    const int err = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                              (int)bytes);
    if (err) return err;
    if (in) kept.allowed[dev] = bytes;
  }
  if (in && kept.per_sm[dev] > 0 && kept.at[dev] == bytes) {
    *per_sm = kept.per_sm[dev];
    return 0;
  }
  int n = 0;
  const int err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, threads, bytes);
  if (err) return err;
  if (in) {
    kept.at[dev] = bytes;
    kept.per_sm[dev] = n;
  }
  *per_sm = n;
  return 0;
}

}  // namespace

// The `fields` float fields of table (N, F) (widths `width`, in column
// order, summing to F) at the rows max(obj, 0) into outs[k] (B, width[k])
// and the FI int columns of itable (N, FI) into iouts[j] (B,); every array
// contiguous, as CUDA device pointers (host pointers in the host rehearsal).
// The tables are staged in shared memory where that takes at most
// `smem_budget` bytes, else read through __ldg; `*staged` gets 1 or 0.
// Launches on `stream`, does not synchronise, returns cudaGetLastError() (or
// the attribute call's error).
extern "C" int rt_winner_gather(const void* table, const void* itable, const void* obj,
                                void* const* outs, const int* width, int fields,
                                void* const* iouts, long long B, int N, int F, int FI,
                                void* stream, long long smem_budget, int* staged) {
  if (fields < 0 || fields > MAX_FIELDS || FI < 0 || FI > MAX_FIELDS) {
    return (int)cudaErrorInvalidValue;
  }
  GatherArgs a{};
  int cols = 0, stage_w = 0;
  for (int k = 0; k < fields; ++k) {
    if (width[k] <= 0) return (int)cudaErrorInvalidValue;
    a.out[k] = static_cast<float*>(outs[k]);
    a.width[k] = width[k];
    a.start[k] = cols;
    cols += width[k];
    if (width[k] > 1 && width[k] > stage_w) stage_w = width[k];
  }
  if (cols != F) return (int)cudaErrorInvalidValue;
  for (int j = 0; j < FI; ++j) a.iout[j] = static_cast<int*>(iouts[j]);
  const long long want = gather_smem(true, N, F, FI, stage_w, GATHER_THREADS / 32);
  const bool in_smem = want <= smem_budget;
  const int threads = in_smem ? GATHER_THREADS : GATHER_THREADS_LDG;
  const int warps = threads / 32;
  if (staged) *staged = in_smem ? 1 : 0;
  if (B <= 0 || N <= 0 || F + FI == 0) return 0;
  a.table = static_cast<const float*>(table);
  a.itable = static_cast<const int*>(itable);
  a.obj = static_cast<const int*>(obj);
  a.B = B;
  a.N = N;
  a.F = F;
  a.FI = FI;
  a.fields = fields;
  a.stage_w = stage_w;
  const size_t bytes = (size_t)gather_smem(in_smem, N, F, FI, stage_w, warps);
  int dev = 0;
  cudaGetDevice(&dev);
  static SmemKept kept[2];
  int per_sm = 0;
  const int err = in_smem ? allow_smem(winner_gather_kernel<true>, dev, bytes, threads, kept[1],
                                       &per_sm)
                          : allow_smem(winner_gather_kernel<false>, dev, bytes, threads, kept[0],
                                       &per_sm);
  if (err) return err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  long long blocks = (long long)sm_count(dev) * per_sm;
  const long long needed = ((B + WL - 1) / WL + warps - 1) / warps;
  if (blocks > needed) blocks = needed;
  if (in_smem) {
    RT_LAUNCH_SMEM(winner_gather_kernel<true>, (int)blocks, threads, bytes,
                   static_cast<cudaStream_t>(stream), a);
  } else {
    RT_LAUNCH_SMEM(winner_gather_kernel<false>, (int)blocks, threads, bytes,
                   static_cast<cudaStream_t>(stream), a);
  }
  return static_cast<int>(cudaGetLastError());
}

// grad_table (N, F) float32 = each field's gradient grads[k] (B, width[k])
// summed at the rows max(obj, 0), for the fields whose pointer is not null
// (widths in column order, summing to F), 0 in the other fields' columns;
// every entry is written.  `blocks` blocks of `per_block` lanes (a multiple
// of the warp; they cover B, none empty) each sum their lanes into their
// slice of `partial` (blocks, N, G) float32 (G: the columns with a
// gradient), which the final sum adds in `segments` runs (1 to 32).  The
// tile mode runs where its shared memory is at most `smem_budget` bytes, else
// the global mode; `*mode` gets 1 for the tile, 0 for global.  The blocks
// must all be resident at once (a cooperative launch).  Launches on `stream`,
// does not synchronise, returns cudaGetLastError() (or the error of the
// attribute call or the launch).
extern "C" int rt_winner_scatter(const void* const* grads, const int* width, int fields,
                                 const void* obj, void* grad_table, long long B, int N, int F,
                                 long long smem_budget, int* mode, void* partial, int blocks,
                                 long long per_block, int segments, void* stream) {
  if (fields < 0 || fields > MAX_FIELDS || F > MAX_COLS) return (int)cudaErrorInvalidValue;
  ScatterArgs a{};
  int G = 0, cols = 0;
  for (int k = 0; k < fields; ++k) {
    if (width[k] <= 0) return (int)cudaErrorInvalidValue;
    a.grad[k] = static_cast<const float*>(grads[k]);
    a.width[k] = width[k];
    for (int j = 0; j < width[k]; ++j) {
      a.col_grad[cols + j] = a.grad[k] ? G : -1;
      if (a.grad[k]) {
        a.col_field[G] = k;
        a.col_in_field[G] = j;
        a.col_first[G] = G - j;
        ++G;
      }
    }
    cols += width[k];
  }
  if (cols != F) return (int)cudaErrorInvalidValue;
  if (segments < 1 || segments > 32) return (int)cudaErrorInvalidValue;
  // the tile mode where its tile and batches of 4 chunks fit the budget,
  // else the global mode; then the largest batch that fits
  const bool shared = scatter_smem(true, N, G, segments, 4 * WL) <= smem_budget;
  const long long room = shared ? smem_budget : SMEM_MAX;
  int batch = MAX_CHUNKS * WL;
  while (batch > WL && scatter_smem(shared, N, G, segments, batch) > room) batch /= 2;
  if (scatter_smem(shared, N, G, segments, batch) > room) return (int)cudaErrorInvalidValue;
  if (mode) *mode = shared ? 1 : 0;
  if (B <= 0 || N <= 0 || G == 0) return 0;
  if (blocks < 1 || per_block <= 0 || per_block % WL != 0 || per_block * blocks < B ||
      per_block * (blocks - 1) >= B) {
    return (int)cudaErrorInvalidValue;
  }
  a.obj = static_cast<const int*>(obj);
  a.partial = static_cast<float*>(partial);
  a.grad_table = static_cast<float*>(grad_table);
  a.B = B;
  a.per_block = per_block;
  a.N = N;
  a.F = F;
  a.G = G;
  a.blocks = blocks;
  a.segments = segments;
  a.batch = batch;
  const int threads = 32 * (G < SCATTER_WARPS ? G : SCATTER_WARPS);  // a warp a column
  const size_t bytes = (size_t)scatter_smem(shared, N, G, segments, batch);
  int dev = 0;
  cudaGetDevice(&dev);
  static SmemKept kept[2];
  int per_sm = 0;
  const int err = shared ? allow_smem(winner_scatter_kernel<true>, dev, bytes, threads, kept[1],
                                      &per_sm)
                         : allow_smem(winner_scatter_kernel<false>, dev, bytes, threads, kept[0],
                                      &per_sm);
  if (err) return err;
#ifndef RT_HOST_REHEARSAL
  // the grid barrier needs every block resident
  if ((long long)per_sm * sm_count(dev) < blocks) return (int)cudaErrorCooperativeLaunchTooLarge;
#endif
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int code = shared ? RT_LAUNCH_COOPERATIVE(winner_scatter_kernel<true>, blocks, threads,
                                                  bytes, s, a)
                          : RT_LAUNCH_COOPERATIVE(winner_scatter_kernel<false>, blocks, threads,
                                                  bytes, s, a);
  if (code) return code;
  return static_cast<int>(cudaGetLastError());
}
