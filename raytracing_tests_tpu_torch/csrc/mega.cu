// One fused trace-and-shade step over a chunk of lanes, for Hopper (sm_90a).
//
// Replaces the TPU kernel raytracing_tests_tpu/kernels/mega.py::_mega_kernel
// (launched by mega_step): for every lane of a (16, C) pool of ray records the
// nearest hit over the grouped sphere tables, the winner's row, the exact
// re-solve, the surrounding refractive index, the In-Next-Week shading and both
// children as pool records.  The lane-aligned drain (ops/megalanes.py) calls
// it once per iteration and keeps every record at its lane.
//
// What bounds it on this card: bytes once most lanes are dead, operations on
// a live chunk.  Every lane writes 42 floats whatever it does; a live lane
// reads its whole record and tests the spheres of every group its slab test
// admits.  Most of a frame's lane-steps are dead (a chunk's trees end at
// different depths), and a dead lane in a warp of live ones idles through
// their sweeps.  So the kernel is persistent (a grid sized by occupancy) and
// compacts: a warp claims 32-lane tiles of the chunk through an atomic
// cursor, writes the fixed outputs of each tile's inactive and dead lanes
// with coalesced stores, and appends its live lanes to a per-warp list in
// shared memory; each time the list holds 32 lanes the warp runs one DENSE
// pass over them: the warp sweep of warp_sweep.cuh, the winner's re-solve,
// the warp-cooperative surrounding-RI probe, the shading, and each lane's
// outputs written to its own column (so the order of processing changes no
// result).  The remainder is flushed at the end.  A pass's columns lie in
// tiles far apart, so its stores touch up to 32 sectors of a row where a
// tile's touch 4; staging them in shared memory to write whole tiles
// measured slower (PERF.md; likely because the staging takes the L1 that the
// tables are read through).  An inactive lane reads its lane id, omt and bounce
// count (its children carry them), a dead one its direction and contribution
// too; only a live lane reads its whole record.  The TPU version's (1, L)
// planes, scratch references, packed (t, id) key and one-hot gather have no
// counterpart.
//
// Two instantiations, static and MOTION (12-float object rows, centres
// shifted by the lane's omt * dp); the host function picks by `has_motion`.
#include "warp_sweep.cuh"

namespace {

constexpr int POOL_ROWS = 16;
constexpr int MISC_ROWS = 8;
// Pool record rows.
enum { P_OX = 0, P_OY, P_OZ, P_DX, P_DY, P_DZ, P_OMT, P_TLIM, P_CONTRIB, P_BOUNCED };

// Host-side parameter vectors (kernels/mega.py fills them).  IP_COOP_MIN: a
// group that fewer lanes of a dense pass entered is swept row-parallel
// (warp_sweep.cuh); 1 never, 33 always.
enum { IP_SPP = 0, IP_HAS_DIEL, IP_NGROUPS, IP_GR, IP_NPGROUPS, IP_PROBE_GR,
       IP_MOTION, IP_COOP_MIN, IP_LEN };
enum { FP_TMAX = 0, FP_GOLDEN, FP_SUN_N, FP_SUN_NMB, FP_SUN_DENOM, FP_MAX_BOUNCES,
       FP_BG_BOTTOM, FP_BG_TOP = FP_BG_BOTTOM + 3, FP_LEN = FP_BG_TOP + 3 };

// Work counters (measurement only): live lanes, gr per group a live lane
// entered, lanes that hit, lanes whose surrounding RI was probed, active
// lanes; the rows each lane's own walk tested (to its groups' last live
// rows), 32 x the row iterations the dense passes issued (SIMT efficiency =
// MS_ROW_TESTS / MS_LANE_SLOTS) and their row-parallel group visits; dense
// passes run (their fill = MS_LIVE / (32 x MS_PASSES)).
enum { MS_LIVE = 0, MS_TESTS, MS_HITS, MS_PROBES, MS_ACTIVE, MS_ROW_TESTS,
       MS_LANE_SLOTS, MS_COOP_VISITS, MS_PASSES, MS_LEN };

// Threads per block, and the resident blocks per SM the kernel is compiled
// for (its register budget; PERF.md).
constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int MIN_BLOCKS = 6;
// Tiles a warp claims at once.  More consecutive tiles would keep a dense
// pass's columns closer together (fewer sectors per store), but claims of 2
// to 16 tiles measured slower than 1 (PERF.md, chip_ab.py): coarser claims
// balance the warps worse.
constexpr int CLAIM = 1;

struct MegaParams {
  int spp, coop_min;
  float t_max, golden;
  float bg_bottom[3], bg_top[3];
  rt::ShadeStatics shade;
};

struct Outputs {
  float* misc;
  float* refr;
  float* refl;
  int* rlane;
  int* llane;
};

__device__ __forceinline__ void write_child(float* __restrict__ out, size_t s,
                                            const rt::Child& c, float omt,
                                            float t_max, float bounced1) {
  out[P_OX * s] = c.ox;
  out[P_OY * s] = c.oy;
  out[P_OZ * s] = c.oz;
  out[P_DX * s] = c.dx;
  out[P_DY * s] = c.dy;
  out[P_DZ * s] = c.dz;
  out[P_OMT * s] = omt;
  out[P_TLIM * s] = t_max;
  out[P_CONTRIB * s] = c.contrib;
  out[P_BOUNCED * s] = bounced1;
#pragma unroll
  for (int r = P_BOUNCED + 1; r < POOL_ROWS; ++r) out[r * s] = 0.0f;
}

// One lane's outputs: what it adds, its hit distance, both children (a dead
// ray where it hit nothing), and the lane id where each child spawns, else -1.
struct LaneOut {
  float add_r, add_g, add_b, hit_t;
  rt::Child cr, cl;
  float omt, bounced;  // the parent's, carried by both children
  int rl, ll;
};

// Column i of every output.
__device__ __forceinline__ void write_lane(const Outputs& O, size_t s, int i, float t_max,
                                           const LaneOut& o) {
  float* m = O.misc + i;
  m[0 * s] = o.add_r;
  m[1 * s] = o.add_g;
  m[2 * s] = o.add_b;
  m[3 * s] = o.hit_t;
#pragma unroll
  for (int r = 4; r < MISC_ROWS; ++r) m[r * s] = 0.0f;
  const float bounced1 = o.bounced + 1.0f;
  write_child(O.refr + i, s, o.cr, o.omt, t_max, bounced1);
  write_child(O.refl + i, s, o.cl, o.omt, t_max, bounced1);
  O.rlane[i] = o.rl;
  O.llane[i] = o.ll;
}

// contribution x the sky gradient at the direction's dy (a miss).
__device__ __forceinline__ void sky(const MegaParams& P, float contrib, float dy,
                                    float& r, float& g, float& b) {
  const float tt = (dy + 1.0f) * 0.5f;
  r = contrib * ((1.0f - tt) * P.bg_bottom[0] + tt * P.bg_top[0]);
  g = contrib * ((1.0f - tt) * P.bg_bottom[1] + tt * P.bg_top[1]);
  b = contrib * ((1.0f - tt) * P.bg_bottom[2] + tt * P.bg_top[2]);
}

// This thread's share of the work counters.
struct Tally {
  unsigned live, hits, probes, active, passes;
  rt::WarpCounts wc;
};

// One dense pass: lane `lane` traces and shades the live lane at column i
// (none where i < 0) and returns its outputs; every lane of the warp takes
// part.
template <bool MOTION>
__device__ __forceinline__ LaneOut dense_pass(const rt::Tables& T, const MegaParams& P,
                                              const int* __restrict__ live_rows,
                                              const float* __restrict__ pool,
                                              const int* __restrict__ lane_ids, size_t s,
                                              int lane, int i, Tally& tl) {
  const bool has = i >= 0;
  float ox = 0.0f, oy = 0.0f, oz = 0.0f, dx = 0.0f, dy = 0.0f, dz = 0.0f;
  float omt = 0.0f, tlim = 0.0f, contrib = 0.0f, bounced = 0.0f;
  int ln = 0;
  if (has) {
    const float* rec = pool + i;
    ox = rec[P_OX * s];
    oy = rec[P_OY * s];
    oz = rec[P_OZ * s];
    dx = rec[P_DX * s];
    dy = rec[P_DY * s];
    dz = rec[P_DZ * s];
    omt = rec[P_OMT * s];
    tlim = rec[P_TLIM * s];
    contrib = rec[P_CONTRIB * s];
    bounced = rec[P_BOUNCED * s];
    ln = lane_ids[i];
  }
  float t_best;
  int obj;
  rt::warp_nearest_hit<MOTION>(T, live_rows, P.coop_min, lane, ox, oy, oz, dx, dy, dz,
                               omt, has, tlim, t_best, obj, tl.wc);
  // The winner's re-solve and the probe point, as shade_hit takes them.
  rt::Refined R = {};
  bool need = false;
  if (obj >= 0) {
    const float* src = T.ftab + (size_t)obj * rt::FT_COLS;
    float row[rt::FT_COLS];
#pragma unroll
    for (int k = 0; k < rt::FT_COLS / 4; ++k) {
      const float4 v = rt::ld4(src + 4 * k);
      row[4 * k] = v.x;
      row[4 * k + 1] = v.y;
      row[4 * k + 2] = v.z;
      row[4 * k + 3] = v.w;
    }
    R = rt::winner_refine<MOTION>(row, ox, oy, oz, dx, dy, dz, omt, t_best, true);
    const bool inner = (R.nx * dx + R.ny * dy + R.nz * dz) > 0.0f;
    need = P.shade.has_dielectrics && T.n_pgroups > 0 && (inner || row[rt::FT_REFR] > 0.002f);
  }
  const float sur_ri =
      rt::warp_ri_probe<MOTION>(T, P.coop_min, lane, need, R.px + 1e-3f * R.nx,
                                R.py + 1e-3f * R.ny, R.pz + 1e-3f * R.nz, omt);
  // A lane that hits nothing spawns nothing: its children carry a dead ray.
  LaneOut o = {};
  o.hit_t = P.t_max;
  o.omt = omt;
  o.bounced = bounced;
  o.rl = o.ll = -1;
  if (!has) return o;  // after the last warp-wide operation
  if (obj >= 0) {
    // The sunflower angle of the lane's sample, as ray generation takes it.
    const float sidx = (float)(ln - (ln / P.spp) * P.spp);
    const float th = P.golden * sidx;
    const rt::Shade sh = rt::shade_hit<false, MOTION, true>(
        T, P.shade, obj, t_best, ox, oy, oz, dx, dy, dz, omt, contrib, bounced, sidx,
        cosf(th), sinf(th), &R, sur_ri);
    o.add_r = sh.add_r;
    o.add_g = sh.add_g;
    o.add_b = sh.add_b;
    o.hit_t = sh.hit_t;
    if (sh.spawn_refr) o.rl = ln;
    if (sh.spawn_refl) o.ll = ln;
    o.cr = sh.refr;
    o.cl = sh.refl;
    tl.hits += 1;
    tl.probes += sh.probed ? 1u : 0u;
  } else {
    sky(P, contrib, dy, o.add_r, o.add_g, o.add_b);
  }
  return o;
}

template <bool MOTION>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS) mega_kernel(
    rt::Tables T, MegaParams P, const int* __restrict__ live_rows,
    const float* __restrict__ pool, const int* __restrict__ lane_ids, int C, Outputs O,
    unsigned* __restrict__ cursor, unsigned long long* __restrict__ stats) {
  // Per warp: the columns of the live lanes waiting for a dense pass (fewer
  // than W left over and at most W from the newest tile), in a ring indexed
  // by list position (monotonic counters, the same on every lane).
  constexpr int W = RT_WARP_LANES;
  constexpr unsigned RING = 2 * W;
  __shared__ int waiting[WARPS][RING];
  const int lane = threadIdx.x & 31;
  int* cols = waiting[threadIdx.x >> 5];
  const unsigned below = (1u << lane) - 1u;  // the lanes before this one
  const size_t s = (size_t)C;
  const unsigned n_tiles = (unsigned)((C + W - 1) / W);
  unsigned l_head = 0, l_tail = 0;  // the next lane to trace, the next free slot
  unsigned next = 0, end = 0;       // the tiles claimed and not yet taken
  Tally tl = {};

  for (;;) {
    if (next == end) {
      if (lane == 0) next = atomicAdd(cursor, (unsigned)CLAIM);
      next = __shfl_sync(rt::WARP_FULL, next, 0);
      end = next + CLAIM;
    }
    const unsigned tile = next++;
    const bool more = tile < n_tiles;
    if (more) {
      // ---- one tile: fixed outputs of its inactive and dead lanes ----------
      const int i = (int)tile * W + lane;
      const bool in = i < C;
      const int ln = in ? lane_ids[i] : -1;
      const bool active = ln >= 0;
      float dx = 0.0f, dy = 0.0f, dz = 0.0f, contrib = 0.0f;
      if (active) {
        dx = pool[P_DX * s + i];
        dy = pool[P_DY * s + i];
        dz = pool[P_DZ * s + i];
        contrib = pool[P_CONTRIB * s + i];
      }
      // dead rays carry d = 0 (a padding lane, or a lane that was never started)
      const bool live = active && (dx * dx + dy * dy + dz * dz) > 0.5f;
      if (in && !live) {
        LaneOut o = {};
        if (active) sky(P, contrib, dy, o.add_r, o.add_g, o.add_b);
        o.hit_t = P.t_max;
        o.omt = pool[P_OMT * s + i];
        o.bounced = pool[P_BOUNCED * s + i];
        o.rl = o.ll = -1;
        write_lane(O, s, i, P.t_max, o);
      }
      tl.active += active ? 1u : 0u;
      tl.live += live ? 1u : 0u;
      // ---- its live lanes join the warp's list ----------------------------
      const unsigned lm = __ballot_sync(rt::WARP_FULL, live);
      if (live) cols[(l_tail + __popc(lm & below)) % RING] = i;
      l_tail += (unsigned)__popc(lm);
      __syncwarp();
      if (l_tail - l_head < (unsigned)W) continue;
    } else if (l_head == l_tail) {
      break;
    }
    // ---- a dense pass: W waiting lanes, or what is left at the end -------
    const unsigned take = l_tail - l_head < (unsigned)W ? l_tail - l_head : (unsigned)W;
    const int i = (unsigned)lane < take ? cols[(l_head + (unsigned)lane) % RING] : -1;
    l_head += take;
    __syncwarp();
    if (lane == 0) tl.passes += 1;
    const LaneOut out = dense_pass<MOTION>(T, P, live_rows, pool, lane_ids, s, lane, i, tl);
    if (i >= 0) write_lane(O, s, i, P.t_max, out);
    if (!more) break;  // the last pass took every waiting lane
  }

  // ---- work counters: warp sums, one atomic per warp and counter ----------
  if (stats == nullptr) return;
  const unsigned long long v[MS_LEN] = {tl.live,    tl.wc.tests, tl.hits,
                                        tl.probes,  tl.active,   tl.wc.rows,
                                        tl.wc.slots, tl.wc.coop, tl.passes};
#pragma unroll
  for (int k = 0; k < MS_LEN; ++k) {
    const unsigned long long sum = rt::warp_total(v[k]);
    if (lane == 0 && sum) atomicAdd(stats + k, sum);
  }
}

// Fill the card once: as many resident blocks as it holds, no more than the
// chunk has tiles for.
template <bool MOTION>
int launch_mega(const rt::Tables& T, const MegaParams& P, const int* live_rows,
                const float* pool, const int* lane_ids, int C, const Outputs& O,
                unsigned* cursor, unsigned long long* stats, cudaStream_t stream) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const auto kernel = mega_kernel<MOTION>;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, 0);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) per_sm = 1;
  long long blocks = (long long)sms * per_sm;
  const long long tiles = (C + RT_WARP_LANES - 1) / RT_WARP_LANES;
  const long long needed = (tiles + WARPS - 1) / WARPS;
  if (blocks > needed) blocks = needed;
  e = cudaMemsetAsync(cursor, 0, sizeof(unsigned), stream);
  if (e != cudaSuccess) return (int)e;
  RT_LAUNCH(kernel, (int)blocks, THREADS, stream, T, P, live_rows, pool, lane_ids, C, O,
            cursor, stats);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// pool: (16, C) float32 ray records (rows ox oy oz dx dy dz omt tlim contrib
// bounced, 6 spare); lane: (C,) int32, negative = inactive.  Outputs: misc
// (8, C) = add_r add_g add_b hit_t 0 0 0 0; refr, refl: (16, C) child records;
// rlane, llane: (C,) int32, the lane id where that child spawns, else -1.
// live_rows: (n_groups,) int32, each main group's last live row + 1; cursor:
// one uint32 of scratch (zeroed here, on the stream).  stats: null, or
// uint64[MS_LEN] that gains the work counters (measurement only).  ip / fp:
// HOST parameter vectors (IP_* / FP_* above); ip[IP_MOTION] says that the
// otab rows are 12 wide and picks the MOTION instantiation.  Launches on
// `stream`, does not synchronise, returns cudaGetLastError().
extern "C" int rt_mega_step(const void* otab, const void* ftab, const void* gaabb,
                            const void* live_rows, const int* ip, const float* fp,
                            const void* pool, const void* lane, int C, void* misc,
                            void* refr, void* refl, void* rlane, void* llane,
                            void* cursor, void* stats, void* stream) {
  if (C <= 0) return 0;
  if (ip[IP_SPP] < 1) return (int)cudaErrorInvalidValue;
  rt::Tables T;
  T.otab = static_cast<const float*>(otab);
  T.ftab = static_cast<const float*>(ftab);
  T.gaabb = static_cast<const float*>(gaabb);
  T.n_groups = ip[IP_NGROUPS];
  T.gr = ip[IP_GR];
  T.n_pgroups = ip[IP_NPGROUPS];
  T.probe_gr = ip[IP_PROBE_GR];
  T.n_sgroups = 0;

  MegaParams P;
  P.spp = ip[IP_SPP];
  P.coop_min = ip[IP_COOP_MIN];
  P.t_max = fp[FP_TMAX];
  P.golden = fp[FP_GOLDEN];
  for (int c = 0; c < 3; ++c) {
    P.bg_bottom[c] = fp[FP_BG_BOTTOM + c];
    P.bg_top[c] = fp[FP_BG_TOP + c];
  }
  P.shade.sun.n = fp[FP_SUN_N];
  P.shade.sun.n_minus_b = fp[FP_SUN_NMB];
  P.shade.sun.denom = fp[FP_SUN_DENOM];
  P.shade.max_bounces = fp[FP_MAX_BOUNCES];
  P.shade.has_dielectrics = ip[IP_HAS_DIEL];

  Outputs O;
  O.misc = static_cast<float*>(misc);
  O.refr = static_cast<float*>(refr);
  O.refl = static_cast<float*>(refl);
  O.rlane = static_cast<int*>(rlane);
  O.llane = static_cast<int*>(llane);
  const int* live = static_cast<const int*>(live_rows);
  const float* pl = static_cast<const float*>(pool);
  const int* ln = static_cast<const int*>(lane);
  unsigned* cur = static_cast<unsigned*>(cursor);
  unsigned long long* st = static_cast<unsigned long long*>(stats);
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  if (ip[IP_MOTION])
    return launch_mega<true>(T, P, live, pl, ln, C, O, cur, st, cs);
  return launch_mega<false>(T, P, live, pl, ln, C, O, cur, st, cs);
}
