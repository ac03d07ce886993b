// One step of the lane-aligned drain's bookkeeping, for Hopper (sm_90a).
//
// Replaces no TPU kernel: it is the counterpart of the XLA fusion of the JAX
// package's loop body, raytracing_tests_tpu/ops/megalanes.py:74-122, which
// runs between two launches of the chunked megakernel (K6, csrc/mega.cu).
// Given K6's outputs for a chunk of C lanes, one thread a lane adds the
// lane's colour, sets its primary hit distance on the chunk's first step,
// counts the ray, pushes the refraction child on the lane's own stack where
// both children spawn (or counts it dropped when the stack is full),
// continues in place with the reflection, else the refraction, else the top
// of the stack, else marks the lane dead.  It writes the lane's next record
// into `cur` and its id into `lane`, in place, for the next K6 launch: K6
// read `cur` earlier on the same stream, so no launch reads it while this one
// writes it.
//
// The chunk's iteration counter gains this step (atomicMax to step + 1, one
// atomic a warp) where any lane was live when the step began, so it counts
// what JAX's `cond` counts: a lane never comes back to life, so the steps
// that began with a live lane are the first `iterations` ones.  Stack
// overflows go to `dropped` (one atomic a warp).
//
// What bounds it on this card: bytes, about 270 B a live lane a step (lane,
// both child lane ids, three colour adds and the primary t, the ray count,
// the stack size, the chosen 16-row record in and out, a pushed or popped
// 8-row record, omt) at 3.35 TB/s; a dead lane reads its id and returns.
// Accesses are (rows, C) planes, one thread a lane, so a warp's loads and
// stores coalesce.  It does additions, selects and copies only, so it equals
// its plain version (kernels/drain.py::drain_step_plain) bit for bit in any
// build.
#include "rt_common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int POOL_ROWS = 16;
constexpr int QUEUE_ROWS = 8;  // o(3) d(3) contrib bounced
enum { P_OMT = 6, P_TLIM = 7, P_CONTRIB = 8 };
enum { M_ADD = 0, M_HIT_T = 3 };

struct DrainArgs {
  float* cur;        // (16, C) in/out: the record each lane traces next
  int* lane;         // (C,) in/out: lane ids, -1 = dead
  const float* omt;  // (C,): each lane's 1 - time_ratio, fixed for its tree
  float* queue;      // (Q, 8, C): the per-lane stacks
  int* qsize;        // (C,)
  float* color;      // (3, C)
  float* primary_t;  // (C,)
  int* rays;         // (C,)
  int* iters;        // (): steps of this chunk that began with a live lane
  unsigned long long* dropped;  // ()
  const float* misc;  // (8, C) from K6: add rgb, hit t
  const float* refr;  // (16, C)
  const float* refl;  // (16, C)
  const int* rlane;   // (C,)
  const int* llane;   // (C,)
  long long C;
  int Q;
  int step;
  float t_max;
};

__global__ void __launch_bounds__(THREADS) drain_kernel(DrainArgs a) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long C = a.C;
  const int ln = i < C ? a.lane[i] : -1;
  const bool active = ln >= 0;
  const bool has_refr = active && a.rlane[i] >= 0;
  const bool has_refl = active && a.llane[i] >= 0;
  int q = active ? a.qsize[i] : 0;
  const bool push = has_refl && has_refr;
  const bool lost = push && q >= a.Q;

  // Every lane of the warp reaches the ballots: none has returned yet.
  const unsigned live_warp = __ballot_sync(0xffffffffu, active);
  const unsigned lost_warp = __ballot_sync(0xffffffffu, lost);
  if ((threadIdx.x & 31) == 0) {
    if (live_warp) atomicMax(a.iters, a.step + 1);
    if (lost_warp) atomicAdd(a.dropped, (unsigned long long)__popc(lost_warp));
  }
  if (!active) return;

  for (int c = 0; c < 3; ++c) a.color[c * C + i] += a.misc[(M_ADD + c) * C + i];
  if (a.step == 0) a.primary_t[i] = a.misc[M_HIT_T * C + i];
  a.rays[i] += 1;

  if (push && !lost) {  // the refraction waits while the reflection goes on
    float* slot = a.queue + (long long)q * QUEUE_ROWS * C + i;
    for (int r = 0; r < 6; ++r) slot[r * C] = a.refr[r * C + i];
    slot[6 * C] = a.refr[P_CONTRIB * C + i];
    slot[7 * C] = a.refr[(P_CONTRIB + 1) * C + i];
    ++q;
  }

  float* cur = a.cur + i;
  if (has_refl || has_refr) {
    const float* child = (has_refl ? a.refl : a.refr) + i;
    for (int r = 0; r < POOL_ROWS; ++r) cur[r * C] = child[r * C];
  } else {
    // Pop the top record, else the lane dies with a dead record: zeros, its
    // omt and t_max (what the plain version's masked pop leaves).
    const bool pop = q > 0;
    float rec[QUEUE_ROWS] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    if (pop) {
      --q;
      const float* top = a.queue + (long long)q * QUEUE_ROWS * C + i;
      for (int r = 0; r < QUEUE_ROWS; ++r) rec[r] = top[r * C];
    } else {
      a.lane[i] = -1;
    }
    for (int r = 0; r < 6; ++r) cur[r * C] = rec[r];
    cur[P_OMT * C] = a.omt[i];
    cur[P_TLIM * C] = a.t_max;
    cur[P_CONTRIB * C] = rec[6];
    cur[(P_CONTRIB + 1) * C] = rec[7];
    for (int r = P_CONTRIB + 2; r < POOL_ROWS; ++r) cur[r * C] = 0.0f;
  }
  a.qsize[i] = q;
}

}  // namespace

// The arguments are the (rows, C) planes named in DrainArgs, as CUDA device
// pointers (host pointers in the host rehearsal); `iters` is one int32 and
// `dropped` one uint64, both added to.  `step` is the step's index within the
// chunk (0 sets primary_t).  Launches on `stream`, does not synchronise,
// returns cudaGetLastError().
extern "C" int rt_drain_step(void* cur, void* lane, const void* omt, void* queue, void* qsize,
                             void* color, void* primary_t, void* rays, void* iters,
                             void* dropped, const void* misc, const void* refr,
                             const void* refl, const void* rlane, const void* llane,
                             long long C, int Q, int step, float t_max, void* stream) {
  if (C <= 0) return 0;
  if (Q < 0 || step < 0) return (int)cudaErrorInvalidValue;
  DrainArgs a;
  a.cur = static_cast<float*>(cur);
  a.lane = static_cast<int*>(lane);
  a.omt = static_cast<const float*>(omt);
  a.queue = static_cast<float*>(queue);
  a.qsize = static_cast<int*>(qsize);
  a.color = static_cast<float*>(color);
  a.primary_t = static_cast<float*>(primary_t);
  a.rays = static_cast<int*>(rays);
  a.iters = static_cast<int*>(iters);
  a.dropped = static_cast<unsigned long long*>(dropped);
  a.misc = static_cast<const float*>(misc);
  a.refr = static_cast<const float*>(refr);
  a.refl = static_cast<const float*>(refl);
  a.rlane = static_cast<const int*>(rlane);
  a.llane = static_cast<const int*>(llane);
  a.C = C;
  a.Q = Q;
  a.step = step;
  a.t_max = t_max;
  const long long blocks = (C + THREADS - 1) / THREADS;
  RT_LAUNCH(drain_kernel, (int)blocks, THREADS, static_cast<cudaStream_t>(stream), a);
  return static_cast<int>(cudaGetLastError());
}
