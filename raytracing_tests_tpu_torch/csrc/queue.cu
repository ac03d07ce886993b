// The queue renderer's per-lane ray queue: pop, the push of a pop's two
// children, and their backward, for Hopper (sm_90a).
//
// Replaces no TPU kernel: it is the counterpart of the XLA fusion of the JAX
// package's RayQueue.push and RayQueue.pop, raytracing_tests_tpu/ops/render.py
// :179-251 (a one-hot `where` and a one-hot sum over the Q records), which no
// pallas_call stands behind.  The port keeps each lane's Q records and a
// spill slot after them (index Q, written by a push that cannot land and read
// by no pop) slot-major, one (Q + 1, B, width) tensor a field
// (ops/render.py::RayQueue): origin (3), direction (3), contribution,
// bounced (int32) and, in a queue made with media, medium and parent_medium.
// Record s of lane b is row s * B + b of each field.
//
// queue_pop_kernel: active = size > 0; each field of the record at size - 1,
// zeros where inactive; size_out = size - active.  With `bout`, `active` and
// `size_out` null it is the tangent of a pop: the same rows of the tangent
// stacks.
//
// queue_push2_kernel: up to two children, in push order; each lane writes
// each child's record at slot `size` where its mask is set and the queue has
// room, else at the spill slot (as the plain version's index_copy does, so
// the stacks equal it bit for bit, the spill slot included), and size grows
// by the children that landed.  A set mask without room is a dropped push:
// one integer atomic a lane that drops, so the count is exact.  With
// `size_out` and `dropped` null it is the tangent of a push: the same rows of
// the tangent stacks, an absent child's tangent written as zero.
//
// queue_pop_grad_kernel: the backward of a pop, in place on the gradient of
// the stack: each active lane adds its popped values' gradient into the row
// it read.
// queue_push2_grad_kernel: the backward of a push pair: each child's gradient
// is the stack gradient's row it wrote (zero for the first child where both
// went to the spill slot, whose second write overwrote the first), and those
// rows are zeroed in place, since the stack before the push did not reach
// them.  Neither touches any other row: a step's backward is O(B), where
// autograd of index_select and index_copy passes over the whole stack.
//
// One thread a lane; each lane owns its rows, so nothing but the drop count
// is shared.  Copies, selects and one addition a value (the pop's backward,
// whose other term PyTorch's autograd adds in the same single rounding): each
// equals its plain version bit for bit in any build.
//
// What bounds them on this card: bytes.  A pop reads size (8 B), writes
// size, active and the popped values (8 + 1 + 32 B, 40 with media) and reads
// the record (32 B, 40); a push pair reads size and two masks, the children
// (2 x 32 B, 2 x 40) and writes two records and size.  The rows of one slot
// lie together, so where a warp's lanes hold as many rays the accesses
// coalesce; where they differ each field of a lane's record is its own
// sector.
#include "rt_common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int NF = 5;  // float fields: origin, direction, contribution, medium, parent_medium
__device__ __forceinline__ int width_of(int k) { return k < 2 ? 3 : 1; }

struct PopArgs {
  const float* stack[NF];  // (Q + 1, B, width); a null field is not read
  const int* bstack;       // (Q + 1, B) bounced, or null
  const long long* size;   // (B,)
  float* out[NF];          // (B, width); null: not wanted
  int* bout;               // (B,) or null
  bool* active;            // (B,) or null
  long long* size_out;     // (B,) or null
  long long B;
};

__global__ void __launch_bounds__(THREADS) queue_pop_kernel(PopArgs a) {
  const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= a.B) return;
  const long long s = a.size[b];
  const bool act = s > 0;
  const long long row = (act ? s - 1 : 0) * a.B + b;
  for (int k = 0; k < NF; ++k) {
    if (!a.out[k]) continue;
    const int w = width_of(k);
    for (int c = 0; c < w; ++c) a.out[k][b * w + c] = act ? a.stack[k][row * w + c] : 0.0f;
  }
  if (a.bout) a.bout[b] = act ? a.bstack[row] : 0;
  if (a.active) a.active[b] = act;
  if (a.size_out) a.size_out[b] = s - (act ? 1 : 0);
}

struct Child {
  const bool* mask;      // (B,)
  const float* v[NF];    // (B, width); null: `absent[k]` (the media's air, a zero tangent)
  const int* bounced;    // (B,) or null (a tangent)
};

struct PushArgs {
  float* stack[NF];  // null: the queue has no such field (or no tangent of it)
  int* bstack;       // or null
  const long long* size;
  long long* size_out;          // or null
  unsigned long long* dropped;  // () or null
  Child child[2];
  float absent[NF];
  int children;  // 1 or 2
  long long B;
  int Q;
};

__global__ void __launch_bounds__(THREADS) queue_push2_kernel(PushArgs a) {
  const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= a.B) return;
  long long s = a.size[b];
  unsigned long long drops = 0;
  for (int j = 0; j < a.children; ++j) {
    const Child& ch = a.child[j];
    const bool m = ch.mask[b];
    const bool can = m && s < a.Q;
    drops += (m && !can) ? 1 : 0;
    const long long row = (can ? s : (long long)a.Q) * a.B + b;
    for (int k = 0; k < NF; ++k) {
      if (!a.stack[k]) continue;
      const int w = width_of(k);
      for (int c = 0; c < w; ++c)
        a.stack[k][row * w + c] = ch.v[k] ? ch.v[k][b * w + c] : a.absent[k];
    }
    if (a.bstack) a.bstack[row] = ch.bounced[b];
    s += can ? 1 : 0;
  }
  if (a.size_out) a.size_out[b] = s;
  if (a.dropped && drops) atomicAdd(a.dropped, drops);
}

struct PopGradArgs {
  float* G[NF];        // (Q + 1, B, width): the stack's gradient, added to in place
  const float* g[NF];  // (B, width): the popped values' gradient; null: none
  const long long* size;
  long long B;
};

__global__ void __launch_bounds__(THREADS) queue_pop_grad_kernel(PopGradArgs a) {
  const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= a.B) return;
  const long long s = a.size[b];
  if (s <= 0) return;  // an inactive lane popped zeros: no gradient
  const long long row = (s - 1) * a.B + b;
  for (int k = 0; k < NF; ++k) {
    if (!a.G[k] || !a.g[k]) continue;
    const int w = width_of(k);
    for (int c = 0; c < w; ++c) a.G[k][row * w + c] += a.g[k][b * w + c];
  }
}

struct PushGradArgs {
  float* G[NF];           // the stack's gradient, its written rows zeroed in place
  float* out[2][NF];      // (B, width): each child's gradient; null: not wanted
  const bool* mask[2];
  const long long* size;  // before the push
  int children;
  long long B;
  int Q;
};

__global__ void __launch_bounds__(THREADS) queue_push2_grad_kernel(PushGradArgs a) {
  const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= a.B) return;
  long long s = a.size[b];
  long long row[2] = {0, 0};
  for (int j = 0; j < a.children; ++j) {
    const bool can = a.mask[j][b] && s < a.Q;
    row[j] = (can ? s : (long long)a.Q) * a.B + b;
    s += can ? 1 : 0;
  }
  const bool overwritten = a.children == 2 && row[0] == row[1];
  for (int k = 0; k < NF; ++k) {
    if (!a.G[k]) continue;
    const int w = width_of(k);
    for (int j = 0; j < a.children; ++j) {
      if (!a.out[j][k]) continue;
      for (int c = 0; c < w; ++c)
        a.out[j][k][b * w + c] = (j == 0 && overwritten) ? 0.0f : a.G[k][row[j] * w + c];
    }
    for (int j = 0; j < a.children; ++j)
      for (int c = 0; c < w; ++c) a.G[k][row[j] * w + c] = 0.0f;
  }
}

int blocks_of(long long B) { return (int)((B + THREADS - 1) / THREADS); }

}  // namespace

// Pointer arrays are host arrays of CUDA device pointers (host pointers in the
// host rehearsal), NF of them a set, in the order origin, direction,
// contribution, medium, parent_medium; a null entry is an absent field.  Each
// launches on `stream`, does not synchronise, and returns cudaGetLastError().

extern "C" int rt_queue_pop(const void* const* stack, const void* bstack, const void* size,
                            void* const* out, void* bout, void* active, void* size_out,
                            long long B, void* stream) {
  if (B <= 0) return 0;
  PopArgs a;
  for (int k = 0; k < NF; ++k) {
    a.stack[k] = static_cast<const float*>(stack[k]);
    a.out[k] = static_cast<float*>(out[k]);
    if (a.out[k] && !a.stack[k]) return (int)cudaErrorInvalidValue;
  }
  a.bstack = static_cast<const int*>(bstack);
  if (bout && !bstack) return (int)cudaErrorInvalidValue;
  a.size = static_cast<const long long*>(size);
  a.bout = static_cast<int*>(bout);
  a.active = static_cast<bool*>(active);
  a.size_out = static_cast<long long*>(size_out);
  a.B = B;
  RT_LAUNCH(queue_pop_kernel, blocks_of(B), THREADS, static_cast<cudaStream_t>(stream), a);
  return static_cast<int>(cudaGetLastError());
}

// `values` holds NF pointers a child, `masks` and `bounced` one a child
// (`bounced` entries null for a tangent); `absent` NF floats.
extern "C" int rt_queue_push2(void* const* stack, void* bstack, const void* size,
                              void* size_out, void* dropped, const void* const* masks,
                              const void* const* values, const void* const* bounced,
                              const float* absent, int children, long long B, int Q,
                              void* stream) {
  if (B <= 0) return 0;
  if (children < 1 || children > 2 || Q < 0) return (int)cudaErrorInvalidValue;
  PushArgs a;
  for (int k = 0; k < NF; ++k) {
    a.stack[k] = static_cast<float*>(stack[k]);
    a.absent[k] = absent[k];
  }
  a.bstack = static_cast<int*>(bstack);
  a.size = static_cast<const long long*>(size);
  a.size_out = static_cast<long long*>(size_out);
  a.dropped = static_cast<unsigned long long*>(dropped);
  for (int j = 0; j < 2; ++j) {
    const bool on = j < children;
    a.child[j].mask = on ? static_cast<const bool*>(masks[j]) : nullptr;
    a.child[j].bounced = on ? static_cast<const int*>(bounced[j]) : nullptr;
    for (int k = 0; k < NF; ++k)
      a.child[j].v[k] = on ? static_cast<const float*>(values[j * NF + k]) : nullptr;
    if (on && (!a.child[j].mask || (a.bstack && !a.child[j].bounced)))
      return (int)cudaErrorInvalidValue;
  }
  a.children = children;
  a.B = B;
  a.Q = Q;
  RT_LAUNCH(queue_push2_kernel, blocks_of(B), THREADS, static_cast<cudaStream_t>(stream), a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rt_queue_pop_grad(void* const* G, const void* const* g, const void* size,
                                 long long B, void* stream) {
  if (B <= 0) return 0;
  PopGradArgs a;
  for (int k = 0; k < NF; ++k) {
    a.G[k] = static_cast<float*>(G[k]);
    a.g[k] = static_cast<const float*>(g[k]);
  }
  a.size = static_cast<const long long*>(size);
  a.B = B;
  RT_LAUNCH(queue_pop_grad_kernel, blocks_of(B), THREADS, static_cast<cudaStream_t>(stream),
            a);
  return static_cast<int>(cudaGetLastError());
}

// `out` holds NF pointers a child.
extern "C" int rt_queue_push2_grad(void* const* G, void* const* out, const void* const* masks,
                                   const void* size, int children, long long B, int Q,
                                   void* stream) {
  if (B <= 0) return 0;
  if (children < 1 || children > 2 || Q < 0) return (int)cudaErrorInvalidValue;
  PushGradArgs a;
  for (int k = 0; k < NF; ++k) a.G[k] = static_cast<float*>(G[k]);
  for (int j = 0; j < 2; ++j) {
    const bool on = j < children;
    a.mask[j] = on ? static_cast<const bool*>(masks[j]) : nullptr;
    if (on && !a.mask[j]) return (int)cudaErrorInvalidValue;
    for (int k = 0; k < NF; ++k) {
      a.out[j][k] = on ? static_cast<float*>(out[j * NF + k]) : nullptr;
      if (a.out[j][k] && !a.G[k]) return (int)cudaErrorInvalidValue;
    }
  }
  a.size = static_cast<const long long*>(size);
  a.children = children;
  a.B = B;
  a.Q = Q;
  RT_LAUNCH(queue_push2_grad_kernel, blocks_of(B), THREADS,
            static_cast<cudaStream_t>(stream), a);
  return static_cast<int>(cudaGetLastError());
}
