// The exact per-block cull of the generic silhouette pass: sweep2g.cu's
// generic_edge (K3).
//
// The silhouette candidate of a ray is the row with the least metric among
// the rows that are candidates, the lowest row on a tie, -1 when there is
// none (the dense definition: kernels/sweep2g.py::sweep2g_edge_plain).
// Evaluating every (ray, row) pair costs about 100 issued instructions a pair
// (six divisions), so only doing fewer pairs gets near the bound.  Here the
// valid rows are cut into BLOCKS (built on the host once per accel:
// kernels/edge_cull.py::block_table): runs of at most BLOCK_ROWS consecutive
// valid rows of one group, and the runs also into SUPER-BLOCKS of at most
// SUPER_ROWS rows, each the union of whole blocks.  An entry (either kind)
// holds a ball (centre, radius) that contains the centre of every row it
// covers at every time omt in [0, 1] (the centre is p - omt dp), and the
// constants of a lower bound of the metric that every row it covers can reach
// for a given ray.  The table holds the super-blocks first, then the blocks;
// a super-block names its blocks (EB_SUB0, EB_NSUB).
//
// The walk (edge_walk), per warp, with every lane taking part:
//   0. seed: the lane's nearest-hit winner row, by the metric's own
//      expression, when that row is a candidate;
//   1. each lane picks, among the super-blocks it still needs, the one of
//      least bound; the warp visits each distinct pick once;
//   2. then every super-block in table order.
// A lane needs an entry unless its bound is STRICTLY greater than the lane's
// best metric (or it visited the super-block in 1); the warp visits a
// super-block when any lane needs it (__ballot_sync), and in it each block
// that any of those lanes needs, reading each row once through the read-only
// path (all lanes load the same address); the lanes that culled it idle
// through it.  Candidates compare as (metric, row) pairs, lexicographically,
// so any order of visits gives the dense pass's answer: a skipped entry holds
// no row with a metric at or below the lane's best, hence none that could win
// or tie.  The arithmetic of the metric on an evaluated row is the dense
// pass's, expression for expression.
//
// A bound must lie below the metric as the kernel COMPUTES it in float32
// (u = 2^-24 below), in either build (a fused a*b+c rounds once where two
// operations round twice, so the bounds on the rounding below hold for both).
// Let the line be {o + t d}, v the ball's centre less o, h the distance from
// the centre to the line, r_b the radius and hl = max(0, h - r_b), which is at
// most the distance of every centre of the entry to the line.
//
// The rows are generic primitives (unit frame e = M (o - p + omt dp),
// f = M d with M = diag(1/s) R^T): the exact metric is the squared distance
// from the origin to the line {e + t f} less 1, and M(x + t d) maps the world
// line, so it is at least sigma_min(M)^2 hl^2 - 1 (mu = the entry's least
// sigma_min^2, from the float table in double on the host).  The computed
// e and f carry an error below 18 u Lr A and 18 u |d| A (A = max 1/s_i,
// Lr = |o - p| + |dp| <= |v| + r_b + 2 |dp|), and the metric's sensitivity
// to them is 2 |e| and 2 |e|^2 / |f| per unit, |f| >= sigma_min |d|,
// |e| <= sigma_max Lr; with the roundings of a, e.f, |e|^2, the reciprocal
// and the products the error stays below 36 u K Lr^2 + u (|metric| + 1),
// K = sigma_max A + sigma_max^2 A / sigma_min + sigma_max^2 (the entry's
// largest, errk).  The bound takes 2^-16 (256 u) for the first term and
// 2^-20 for the second.  A row is a candidate only where the computed
// e.f < 0.  Exactly e.f = w^T M^T M d with w = o - centre, and with
// lambda, delta the mean and half the spread of M^T M's eigenvalues,
// w^T M^T M d >= lambda (w.d) - delta |w| |d|; the computed e.f lies within
// 36 u K Lr |d| of it (the errors of e and f above, and its own dot).  So
// no row of an entry is a candidate where, for every centre c in the ball,
// (o - c).d >= rho |o - c| |d| + tau Lr |d|, with rho the entry's largest
// delta / lambda and tau its largest 2^-16 K / lambda; that holds when
// -(v.d) >= |d| (r_b + rho (|v| + r_b) + tau (|v| + r_b + 2 |dp|)).
//
// The host builds the table in double and rounds every column to its safe
// side.  The bound's own arithmetic on the card is float32 (ball_line), with
// its error pushed to the safe side: v carries u |v| a component, the cross
// product v x d 5.3 u |v| |d|, |v x d|^2 / |d|^2 (one reciprocal of |d|^2 a
// lane) 10 u relative, and the root x rsqrtf(x) (rsqrtf: 2 ulp) halves that
// and adds 6 u, so the computed h exceeds h by at most 11 u h + 5.4 u |v|;
// hl takes 2^-19 (32 u) of each, and the final subtraction of r_b rounds by
// at most u h.  |v| (9 u) and |d| are pushed up by 2^-19, hl^2 down by 2^-19,
// and the last sum loses 2^-20 of 1 + m.  A root of 0 is not a number
// (0 x inf): hl then takes 0 (fmaxf).  The margin 2^-16 K Lr^2 carries at
// least a factor 2.8 over its derivation, which covers its own float
// rounding.  A moving ray whose omt lies outside [0, 1] is never culled (the
// ball holds the centres of that interval only).  A bound that is not a
// number never culls (the skip test is `bound > best`).
#pragma once

#include "warp_sweep.cuh"

namespace rt {

// The block table (n_entries, EB_COLS) float32, rows in table order, four
// 16-byte loads an entry: the ball, the bound's constants, the motion term,
// the walk's indices.
constexpr int EB_COLS = 16;
enum {
  EB_BCX = 0, EB_BCY, EB_BCZ,  // the ball's centre
  EB_BR,                       // its radius, rounded up
  EB_MU,                       // least sigma_min(M)^2
  EB_ERRK,                     // largest K
  EB_RHO,                      // largest rho
  EB_TAU,                      // largest tau
  EB_DPMAX,                    // largest |dp| (0 for a static accel); 9-11 unused
  EB_ROW0 = 12, EB_NROWS,      // its rows: [row0, row0 + nrows)
  EB_SUB0, EB_NSUB             // a super-block's blocks: entries [sub0, sub0 + nsub)
};

constexpr float EB_EPS_G = 1.0f / 65536.0f;  // 2^-16: the metric per unit K Lr^2
constexpr float EB_EPS_F = 1.0f / 1048576.0f;  // 2^-20: the last roundings, relative
constexpr float EB_SLACK = 1.0f / 524288.0f;  // 2^-19: the bound's own roundings
constexpr float EB_DOWN = 1.0f - EB_SLACK;
constexpr float EB_UP = 1.0f + EB_SLACK;

// The float32 geometry of a bound for the ray (o, d), inv_dd = 1 / |d|^2
// (the lane's): hl at most max(0, h - r_b), vn at least |v|, vd the computed
// v.d.
struct BallLine {
  float hl, vn, vd;
};
__device__ __forceinline__ float root(float x) { return x * rsqrtf(x); }
__device__ __forceinline__ BallLine ball_line(const float4 ball, float ox, float oy, float oz,
                                              float dx, float dy, float dz, float inv_dd) {
  const float vx = ball.x - ox, vy = ball.y - oy, vz = ball.z - oz;
  const float cx = vy * dz - vz * dy, cy = vz * dx - vx * dz, cz = vx * dy - vy * dx;
  const float h = root((cx * cx + cy * cy + cz * cz) * inv_dd);
  const float vn = root(vx * vx + vy * vy + vz * vz);
  return {fmaxf(h * EB_DOWN - EB_SLACK * vn - ball.w, 0.0f), vn * EB_UP,
          vx * dx + vy * dy + vz * dz};
}

// Work counters of the walk (measurement only), one lane's share: block
// bounds computed, rows evaluated for a ray that hit / missed (the seed
// included), and one per row iteration the warp issued (the warp's sum is
// RT_WARP_LANES x its row iterations: SIMT efficiency = rows / slots).
struct EdgeCounts {
  unsigned bounds, rows_hit, rows_miss, slots;
};

// The lane's best (metric, row); (BIG_T, -1) is "no candidate": a row at
// BIG_T or above, or with a metric that is not a number, never enters, as in
// the dense pass's strict `me < best`.
struct EdgeBest {
  float me;
  int row;
  __device__ __forceinline__ void offer(float m, int r) {
    if (m < me || (m == me && r < row)) {
      me = m;
      row = r;
    }
  }
};

// The walk of steps 1 and 2 above, over the n_super super-blocks at the
// head of the table.  `bound(entry)` is the lane's lower bound for an entry;
// `visit(b, mine)` runs the rows of block b, the lanes with `mine`
// evaluating them.  Every lane of the warp calls it; `active` says whether
// the lane has a candidate to find.  Step 1 is for lanes that the seed gave
// no candidate (a ray that missed): a winner's row is as good a start.
template <class Bound, class Visit>
__device__ __forceinline__ void edge_walk(const float* __restrict__ eblk, int n_super,
                                          bool active, EdgeBest& best, Bound bound,
                                          Visit visit, EdgeCounts& ec) {
  auto needs = [&](int e) {
    ++ec.bounds;
    return !(bound(eblk + (size_t)e * EB_COLS) > best.me);
  };
  // the blocks of super-block S that the lanes with `need` need
  auto blocks = [&](int S, bool need) {
    const float4 w = ld4(eblk + (size_t)S * EB_COLS + EB_ROW0);
    const int b0 = (int)w.z, nb = (int)w.w;
    for (int b = b0; b < b0 + nb; ++b) {
      const bool mine = need && (nb == 1 || needs(b));  // one block: the same rows
      if (__ballot_sync(WARP_FULL, mine)) visit(b, mine);
    }
  };
  int s0 = -1;
  float lb0 = 0.0f;
  if (active && best.row < 0) {
    for (int S = 0; S < n_super; ++S) {
      const float lb = bound(eblk + (size_t)S * EB_COLS);
      ++ec.bounds;
      if (!(lb > best.me) && (s0 < 0 || lb < lb0)) {
        s0 = S;
        lb0 = lb;
      }
    }
  }
  unsigned todo = __ballot_sync(WARP_FULL, s0 >= 0);
  while (todo) {
    const int S = __shfl_sync(WARP_FULL, s0, __ffs(todo) - 1);
    const bool mine = s0 == S;
    todo &= ~__ballot_sync(WARP_FULL, mine);
    blocks(S, mine);
  }
  for (int S = 0; S < n_super; ++S) {
    const bool need = active && S != s0 && needs(S);
    if (__ballot_sync(WARP_FULL, need)) blocks(S, need);
  }
}

}  // namespace rt
