"""Grouped sphere sweep: nearest hit (and hit block) for a batch of rays.

Counterpart of the JAX package's ``kernels/sweep2.py``.  OBJECTS are
Morton-sorted into groups of ``gr`` rows; per group one AABB slab test culls
the group for a ray, and the group's spheres are solved with the quadratic
pre-expanded around the group anchor:

    c_q   = |s|^2 + K1 - 2*(C . s),     K1 = |c|^2 - r^2  (BIG if dead)
    -b/2  = (C . d) - (s . d),          s = o - anchor, C = centre - anchor

The winner is then re-solved directly in its own frame, the surrounding
refractive index is probed over a dielectric-only sub-table, and the winner's
material row is read.

The kernel is hand-written CUDA (``csrc/sweep2.cu``); ``sweep2_plain`` is the
same function in plain PyTorch (dense over all spheres in the same anchored
form, with the order-independent part of the slab test as a mask).  The
wrapper ``_sweep2`` uses the plain version only for tensors that lie on the
CPU; for a CUDA tensor it launches the kernel or raises.  A warp of the kernel
sweeps each culling group per lane where at least ``COOP_MIN`` of its lanes
entered it and row-parallel where fewer did, and probes the surrounding RI
row-parallel (``csrc/warp_sweep.cuh``); rows past a group's last live row
(``live_rows``, computed once per accel) are never read.

Table layouts are row-major (a thread reads its winner's row with indexed
16-byte loads); the logical fields and the row order are the JAX package's, so
``Accel2.perm`` and the row ids mean the same thing.

Motion blur: an object's centre at a ray's time is ``c - omt * dp`` with
``omt = 1 - time_ratio`` (row 6 of the ray matrix), so a moving scene adds the
cross terms ``K2 = 2 C . dp`` and ``K3 = |dp|^2`` to the anchored quadratic.
A static accel keeps the 8-float object row (two 16-byte loads); an accel
built with ``has_motion`` carries ``dp`` in four more columns.

The silhouette instantiation (``sweep2_nearest_edge``, the JAX kernel's
``with_edge``) adds the near-miss candidate of the gradient path's soft edges
over every row of the main table (``sweep2_edge_plain`` defines it).

Directions are assumed unit; dead rays carry d = 0 and never hit.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from raytracing_tests_tpu_torch.kernels import _build
from raytracing_tests_tpu_torch.kernels._cache import TensorCache
from raytracing_tests_tpu_torch.kernels.sweep import (
    BIG_T, HitFields, _check_tensor, pack_rays, scene_has_motion, scene_mode,
)
from raytracing_tests_tpu_torch.ops.intersect import Hit
from raytracing_tests_tpu_torch.scene.types import Scene

DEFAULT_GR = 128  # objects per culling group
PROBE_GR = 8  # rows per surrounding-RI probe group (see _probe_tables)

# Object table (Np + Pp, OT_COLS) columns ("otab"): per-object sweep constants.
OT_CX, OT_CY, OT_CZ, OT_K1, OT_RI, OT_RINV2, OT_K2, OT_K3 = range(8)
OT_COLS = 8  # two 16-byte loads per row
# A moving accel's rows carry the motion delta in a third 16-byte load.
OT_DPX, OT_DPY, OT_DPZ = 8, 9, 10
OT_COLS_MOTION = 12

# Fields table (Np, FT_COLS) columns ("ftab"): read per winner.
(
    FT_CX, FT_CY, FT_CZ, FT_RINV, FT_DPX, FT_DPY, FT_DPZ,
    FT_CR, FT_CG, FT_CB, FT_MRI, FT_REFR, FT_REFL, FT_SRFR, FT_SRFL,
    FT_TEX, FT_EMIS, FT_OBJ, FT_R2,
) = range(19)
FT_COLS = 20  # five 16-byte loads per row

# Group table (G + PG, GA_COLS) columns ("gaabb"): lo xyz, hi xyz, anchor xyz.
GA_COLS = 12

# Hit-output (V_ROWS, B) row indices.
(
    V_T, V_RI, V_NX, V_NY, V_NZ, V_CR, V_CG, V_CB, V_MRI,
    V_REFR, V_REFL, V_SRFR, V_SRFL, V_TEX, V_EMIS, V_OBJ,
) = range(16)
V_ROWS = 16

_PLAIN_CHUNK = 16384  # rays per dense (rays x spheres) block of the plain version

# A culling group that fewer than this many lanes of a warp entered is swept
# row-parallel, and the surrounding RI is probed row-parallel where fewer
# lanes need it (the fastest of 1..33 on the work-queue frame, PERF.md); 1
# keeps every group per lane, 33 sweeps every group row-parallel.
# ``_build.forced_coop_min`` pins another for tests and measurement.
COOP_MIN = 8
# Work counters of csrc/sweep2.cu (SW_* there): gr per group a ray entered;
# the rows each ray's own walk tested (to its groups' last live rows), 32 x
# the row iterations the warps issued (SIMT efficiency = SW_ROW_TESTS /
# SW_LANE_SLOTS), row-parallel group visits.
SW_TESTS, SW_ROW_TESTS, SW_LANE_SLOTS, SW_COOP_VISITS, SW_LEN = range(5)


# ---------------------------------------------------------------------------
# Packing
# ---------------------------------------------------------------------------


def _sum3(v):
    return v[:, 0] + v[:, 1] + v[:, 2]


def pack_tables(scene: Scene, order, n_pad: int, anchor, valid_mask=None,
                has_motion: bool = False):
    """Morton-ordered scene -> (otab (n_pad, OT_COLS), ftab (n_pad, FT_COLS));
    with ``has_motion`` the otab is ``OT_COLS_MOTION`` wide.

    ``order`` is the sorted->original permutation; invalid and padding rows
    get K1 = BIG (kills the quadratic AND the RI containment test).
    ``anchor`` is the (n_pad, 3) per-object GROUP centre: the quadratic is
    expanded around it (c' = c - anchor), so the |c'|^2 - r^2 cancellation
    stays well-conditioned — Morton groups are spatially tight, and a huge
    isolated object anchors at ~its own centre.
    ``valid_mask`` (original-index space) additionally kills rows — used by
    the dielectric-only probe sub-table.
    """
    s = {f: getattr(scene, f)[order] for f in (
        "position", "scale", "delta_position", "color", "refractive_index",
        "refractivity", "reflectivity", "scatter_refract", "scatter_reflect",
        "texture_index", "emissive", "valid",
    )}
    if valid_mask is not None:
        s["valid"] = s["valid"] & valid_mask[order]
    dev = scene.device
    f32 = torch.float32
    n = order.shape[0]
    c = s["position"] - anchor[:n]  # group-relative centres
    r = s["scale"][:, 0]
    dp = s["delta_position"]
    valid = s["valid"]
    k1 = _sum3(c * c) - r * r
    k1 = torch.where(valid, k1, torch.full_like(k1, BIG_T))
    # Invalid rows keep a tiny-but-nonzero rinv2 (the silhouette metric of the
    # gradient path stays huge instead of collapsing to 0).
    rinv2 = torch.where(valid, 1.0 / torch.clamp_min(r * r, 1e-30),
                        torch.full_like(r, 1e-30))
    otab = torch.zeros((n_pad, OT_COLS_MOTION if has_motion else OT_COLS),
                       dtype=f32, device=dev)
    otab[:n, OT_CX:OT_CZ + 1] = c
    otab[:n, OT_K1] = k1
    otab[:n, OT_RI] = s["refractive_index"]
    otab[:n, OT_RINV2] = rinv2
    otab[:n, OT_K2] = 2.0 * _sum3(c * dp)  # c is anchor-relative here
    otab[:n, OT_K3] = _sum3(dp * dp)
    if has_motion:
        otab[:n, OT_DPX:OT_DPZ + 1] = dp
    otab[n:, OT_K1] = BIG_T  # padding rows are dead
    otab[n:, OT_RINV2] = 1e-30
    c = s["position"]  # ftab keeps ABSOLUTE centres (normal computation)

    rinv = torch.where(valid, 1.0 / torch.clamp_min(r, 1e-20), torch.zeros_like(r))
    fcols = [
        c[:, 0], c[:, 1], c[:, 2], rinv, dp[:, 0], dp[:, 1], dp[:, 2],
        s["color"][:, 0], s["color"][:, 1], s["color"][:, 2],
        s["refractive_index"], s["refractivity"], s["reflectivity"],
        s["scatter_refract"], s["scatter_reflect"],
        s["texture_index"].to(f32),
        s["emissive"].to(f32),
        order.to(f32),
        r * r,
    ]
    ftab = torch.zeros((n_pad, FT_COLS), dtype=f32, device=dev)
    ftab[:n, :len(fcols)] = torch.stack(fcols, dim=1)
    return otab, ftab


@dataclasses.dataclass
class Accel2:
    """Sphere-mode accel: Morton-grouped tables + group AABBs.

    ``otab``/``gaabb`` carry ``n_pgroups`` TRAILING dielectric-only probe
    groups (rows restricted to valid & ri != 1) after the main sweep groups —
    the surrounding-RI probe loops only over those.  ``ftab`` spans the MAIN
    rows only (its height is the winner-id space)."""

    otab: torch.Tensor  # (Np + Pp, OT_COLS), OT_COLS_MOTION with has_motion
    ftab: torch.Tensor  # (Np, FT_COLS)
    gaabb: torch.Tensor  # (G + PG, GA_COLS) rows: lo3 hi3 anchor3
    perm: torch.Tensor  # (Np,) i32 sorted -> original
    gr: int
    n_pgroups: int = 0
    has_motion: bool = False

    mode = "spheres"

    @property
    def ot_cols(self) -> int:
        return OT_COLS_MOTION if self.has_motion else OT_COLS

    @property
    def n_pad(self) -> int:
        return self.ftab.shape[0]

    @property
    def n_groups(self) -> int:
        return self.ftab.shape[0] // self.gr

    @property
    def device(self):
        return self.otab.device

    def to(self, device):
        return dataclasses.replace(
            self, otab=self.otab.to(device), ftab=self.ftab.to(device),
            gaabb=self.gaabb.to(device), perm=self.perm.to(device))


def _group_tables(lo_s, hi_s, cen, v_s, gr: int):
    """Per-group AABB + masked-median anchor -> (gaabb (G, GA_COLS), anchor_g).

    Anchor = coordinate-wise MEDIAN of the valid member centres, robust to a
    huge outlier sharing the group (the ground sphere would otherwise drag an
    AABB-centre anchor ~its radius away from every small member): dead rows
    sort to +inf and the middle VALID element is taken."""
    G = lo_s.shape[0] // gr
    glo = torch.amin(lo_s.reshape(G, gr, 3), dim=1)
    ghi = torch.amax(hi_s.reshape(G, gr, 3), dim=1)
    vg = v_s.reshape(G, gr, 1)
    cg = torch.where(vg, cen.reshape(G, gr, 3),
                     torch.full_like(cen, float("inf")).reshape(G, gr, 3))
    cg_sorted = torch.sort(cg, dim=1).values
    nv = torch.sum(vg.to(torch.int64), dim=1)  # (G, 1)
    mid = torch.clamp((nv - 1) // 2, 0, gr - 1)[:, None, :]  # (G, 1, 1)
    med = torch.gather(cg_sorted, 1, mid.expand(G, 1, 3))[:, 0]
    anchor_g = torch.where(nv > 0, med, torch.zeros_like(med))
    gaabb = torch.zeros((G, GA_COLS), dtype=torch.float32, device=lo_s.device)
    gaabb[:, 0:3] = glo
    gaabb[:, 3:6] = ghi
    gaabb[:, 6:9] = anchor_g
    return gaabb, anchor_g


def make_accel2(scene: Scene, gr: int = DEFAULT_GR, sort_origin=None,
                probe_rows=None, probe_mask=None, has_motion=None) -> Accel2:
    """Morton-order objects into groups of ``gr``; huge objects isolated
    into leading always-tested groups.

    ``sort_origin`` (e.g. the camera position) additionally orders the
    GROUPS near-to-far by closest-AABB-point distance: a near group hit
    tightens a ray's t limit before the far groups' slab tests run, so far
    groups cull away.

    ``probe_rows``: count of dielectric (ri != 1) rows, used to size the
    trailing probe sub-table (see ``Accel2``); ``None`` or negative counts on
    the scene, 0 builds no probe table.  ``probe_mask`` (bool, original index
    space) restricts the probe rows further (see ``probe_relevant_rows``).

    ``has_motion``: carry the motion columns and solve with the motion terms;
    ``None`` asks the scene.  The AABBs are motion-swept either way.

    Built on the scene's device."""
    from raytracing_tests_tpu_torch.bvh.build import morton3d

    if has_motion is None:
        has_motion = scene_has_motion(scene)
    has_motion = bool(has_motion)
    dev = scene.device
    inf = float("inf")
    lo, hi = scene.world_aabbs()
    valid = scene.valid
    v1 = valid[:, None]
    big = torch.amax(torch.where(v1, hi, torch.full_like(hi, -inf)), dim=0)
    lo_v = torch.where(v1, lo, big)
    hi_v = torch.where(v1, hi, big)
    slo = torch.amin(lo_v, dim=0)
    sext = torch.clamp_min(torch.amax(hi_v, dim=0) - slo, 1e-12)
    codes = morton3d(((lo_v + hi_v) * 0.5 - slo) / sext)
    size = torch.amax(hi_v - lo_v, dim=-1) / torch.max(sext)
    huge = (size > 0.5) & valid
    codes = torch.where(valid, codes >> 2, torch.full_like(codes, 0x3FFFFFFF))
    key = torch.where(huge, torch.zeros_like(codes), codes + 1)
    order = torch.argsort(key, stable=True)

    n = scene.capacity
    n_pad = -(-n // gr) * gr

    INF = 3.0e38
    vo = valid[order][:, None]
    lo_s = torch.where(vo, lo[order], torch.full_like(lo, INF))
    hi_s = torch.where(vo, hi[order], torch.full_like(hi, -INF))
    cen = scene.position[order]
    v_s = valid[order]
    if n_pad != n:
        pad = n_pad - n
        lo_s = torch.cat([lo_s, torch.full((pad, 3), INF, device=dev)])
        hi_s = torch.cat([hi_s, torch.full((pad, 3), -INF, device=dev)])
        cen = torch.cat([cen, torch.zeros((pad, 3), device=dev)])
        v_s = torch.cat([v_s, torch.zeros((pad,), dtype=torch.bool, device=dev)])
    gaabb, anchor_g = _group_tables(lo_s, hi_s, cen, v_s, gr)
    G = gaabb.shape[0]

    anchor = torch.repeat_interleave(anchor_g, gr, dim=0)  # (n_pad, 3) per-object
    otab, ftab = pack_tables(scene, order, n_pad, anchor, has_motion=has_motion)
    ot_cols = otab.shape[1]

    perm = order.to(torch.int32)
    if n_pad != n:
        perm = torch.cat([perm, torch.zeros((n_pad - n,), dtype=torch.int32, device=dev)])
    if sort_origin is not None:
        origin = torch.as_tensor(sort_origin, dtype=torch.float32, device=dev)
        glo, ghi = gaabb[:, 0:3], gaabb[:, 3:6]
        near = torch.minimum(torch.maximum(origin, glo), ghi)  # closest AABB point
        d2 = torch.sum((near - origin) ** 2, dim=1)  # empty groups -> inf
        gorder = torch.argsort(d2, stable=True)
        otab = otab.reshape(G, gr, ot_cols)[gorder].reshape(n_pad, ot_cols)
        ftab = ftab.reshape(G, gr, FT_COLS)[gorder].reshape(n_pad, FT_COLS)
        gaabb = gaabb[gorder]
        perm = perm.reshape(G, gr)[gorder].reshape(n_pad)

    packer = functools.partial(_pack_probe_spheres, has_motion=has_motion)
    potab, pgaabb = _probe_tables(scene, key, valid, lo, hi, probe_rows,
                                  probe_mask=probe_mask, packer=packer,
                                  ot_cols=ot_cols)
    return Accel2(
        otab=torch.cat([otab, potab]).contiguous(), ftab=ftab.contiguous(),
        gaabb=torch.cat([gaabb, pgaabb]).contiguous(), perm=perm.contiguous(),
        gr=gr, n_pgroups=pgaabb.shape[0], has_motion=has_motion)


# The probe cut's cache: the O(N^2) host matrix (a ~200 MB transient at the
# N = 4096 threshold) is not rebuilt for a scene rendered again.  Keyed on
# every tensor the cut reads, so ``scene.replace(...)`` variants, which share
# ``position``, keep entries of their own and do not evict each other.
_PROBE_CACHE = TensorCache(8)


def _probe_cache_deps(scene: Scene):
    """Every scene tensor ``probe_relevant_rows`` reads, directly or through
    ``scene_mode`` / ``world_aabbs``."""
    return (scene.position, scene.rotation, scene.scale,
            scene.delta_position, scene.obj_type, scene.valid,
            scene.refractive_index, scene.refractivity, scene.texture_index)


def probe_relevant_rows(scene: Scene, margin: float = 4e-3, cache: bool = True):
    """Boolean numpy mask of scene rows that can move the surrounding-RI probe
    off the neutral 1.0.

    The probe's consumers are exactly the rays whose winner spawns a
    refraction child: OUTER hits on refractive objects (refr > 0.002) and
    INNER hits.  The probe point sits 1e-3 OUTSIDE the (convex) winner along
    the outward normal.  Interiors are REACHABLE through refraction, so
    inner-hit surfaces belong to refractive objects or to objects whose volume
    overlaps one (a ray can exit glass inside them — and spawn offsets can hop
    the ray across any further overlap in the chain, so hosts are the
    TRANSITIVE closure of the gap <= margin adjacency seeded at refractive
    rows).  Therefore a probe row B matters only if B (ri != 1) lies within
    ``margin`` (probe offset + spawn offset + slack) of the surface of some
    HOST A != B.

    Not bit-exact: reflect children spawn 1e-4 outside their winner, which
    can be 1e-4 INSIDE a NON-host opaque neighbour — an interior reached
    without refraction that this cut ignores.  Also assumed: the camera starts
    in air (use ``cfg.probe_rows = -1`` to keep the full table otherwise).  On
    the ``iow_final_scene()`` the cut keeps 40 of 486 dielectric rows.

    Sphere scenes use exact pairwise surface gaps (shrunk by both motion
    amplitudes); generic scenes use the conservative world-AABB gap.

    Cached on the identity and version of every tensor the cut reads
    (``_probe_cache_deps``, ``kernels/_cache.py``) in a FIFO of 8 scenes; the
    caller gets a copy.  ``cache=False`` computes it and stores nothing."""
    deps = _probe_cache_deps(scene) if cache else None
    return _PROBE_CACHE.cached(deps, (margin,), lambda: _probe_cut(scene, margin)).copy()


def _probe_cut(scene: Scene, margin: float):
    """``probe_relevant_rows`` computed afresh."""
    npy = lambda x: x.detach().cpu().numpy()
    valid = npy(scene.valid)
    dmask = valid & (npy(scene.refractive_index) != 1.0)
    refr = valid & (npy(scene.refractivity) > 0.002)
    n = valid.shape[0]
    if n > 4096:  # O(N^2) host check; stay conservative at 10k+
        return dmask
    if not refr.any():
        return np.zeros_like(dmask)
    if scene_mode(scene) == "spheres":
        c = npy(scene.position)
        r = npy(scene.scale)[:, 0]
        amp = np.linalg.norm(npy(scene.delta_position), axis=1)
        d = np.linalg.norm(c[:, None] - c[None, :], axis=-1)
        gap = (d - (r[:, None] + r[None, :])
               - (amp[:, None] + amp[None, :]))
    else:
        lo, hi = scene.world_aabbs()  # already motion-swept
        lo, hi = npy(lo), npy(hi)
        sep = np.maximum(lo[:, None] - hi[None, :],
                         lo[None, :] - hi[:, None])
        gap = sep.max(axis=-1)
    np.fill_diagonal(gap, np.inf)
    gap[~valid] = np.inf
    gap[:, ~valid] = np.inf
    touch = gap <= margin  # symmetric adjacency
    hosts = refr.copy()  # transitive closure over touch
    while True:
        grown = hosts | (valid & touch[:, hosts].any(axis=1))
        if (grown == hosts).all():
            break
        hosts = grown
    near_host = touch[:, hosts].any(axis=1)
    return dmask & near_host


def _pack_probe_spheres(scene: Scene, porder, np_pad: int, anchor, dmask, dm,
                        has_motion: bool = False):
    """The sphere-mode probe rows: ``pack_tables`` with the dead rows' K1 = BIG."""
    potab = pack_tables(scene, porder, np_pad, anchor, dmask, has_motion)[0]
    potab[:, OT_K1] = torch.where(dm, potab[:, OT_K1],
                                  torch.full_like(potab[:, OT_K1], BIG_T))
    return potab


def _probe_tables(scene: Scene, key, valid, lo, hi, probe_rows,
                  probe_mask=None, packer=_pack_probe_spheres,
                  ot_cols: int = OT_COLS):
    """Dielectric-only (valid & ri != 1) probe sub-table: Morton/huge-first
    ordered rows grouped by PROBE_GR with their own AABBs + median anchors.
    Only ri != 1 rows can move the surrounding-RI result off the neutral 1.0,
    so the probe loops over this subset instead of the whole table.
    ``packer(scene, order, n_pad, anchor, valid_mask, live)`` builds the
    mode's object rows, ``ot_cols`` wide.
    Returns (potab (Pp, ot_cols), pgaabb (PG, GA_COLS))."""
    gr = PROBE_GR
    dev = scene.device
    dmask = valid & (scene.refractive_index != 1.0)
    if probe_mask is not None:  # consumer-reachability cut (probe_relevant_rows)
        dmask = dmask & torch.as_tensor(probe_mask, dtype=torch.bool, device=dev)
    if probe_rows is None or probe_rows < 0:
        probe_rows = int(dmask.sum())
    if probe_rows == 0:
        # No probe consumers: zero groups — the probe folds to the neutral 1.0.
        return (torch.zeros((0, ot_cols), device=dev),
                torch.zeros((0, GA_COLS), device=dev))
    np_pad = max(gr, -(-probe_rows // gr) * gr)
    pkey = torch.where(dmask, key, torch.full_like(key, 0xFFFFFFFF))
    porder = torch.argsort(pkey, stable=True)
    n = porder.shape[0]
    if np_pad > n:  # all-dielectric tiny scenes: repeat rows, masked dead
        porder = torch.cat([porder, torch.zeros((np_pad - n,), dtype=porder.dtype, device=dev)])
    else:
        porder = porder[:np_pad]
    live = torch.arange(np_pad, device=dev) < probe_rows
    dm = dmask[porder] & live

    INF = 3.0e38
    d1 = dm[:, None]
    lo_p = torch.where(d1, lo[porder], torch.full((np_pad, 3), INF, device=dev))
    hi_p = torch.where(d1, hi[porder], torch.full((np_pad, 3), -INF, device=dev))
    pgaabb, anchor_g = _group_tables(lo_p, hi_p, scene.position[porder], dm, gr)

    # valid_mask (ORIGINAL index space) kills the non-dielectric argsort
    # filler, and the POSITIONAL dm mask additionally kills duplicated
    # index-0 padding rows (np_pad > n) even when object 0 is dielectric.
    anchor = torch.repeat_interleave(anchor_g, gr, dim=0)
    return packer(scene, porder, np_pad, anchor, dmask, dm), pgaabb


# ---------------------------------------------------------------------------
# The plain PyTorch version
# ---------------------------------------------------------------------------


def _dot3(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def _sweep_chunk(accel: Accel2, o, d, live, tlim, omt=None, with_edge: bool = False):
    """Dense anchored nearest-hit for one chunk of rays -> (t_best, obj), and
    with ``with_edge`` the silhouette candidate ``edge`` (see
    ``sweep2_edge_plain``) as a third output.  ``omt`` (B,) = 1 - time_ratio;
    read only by a moving accel."""
    G, gr, n_pad = accel.n_groups, accel.gr, accel.n_pad
    ga = accel.gaabb[:G]
    lo, hi, an = ga[:, 0:3], ga[:, 3:6], ga[:, 6:9]
    eps = 1e-12
    inv = 1.0 / torch.where(d.abs() < eps, torch.full_like(d, eps), d)  # (B, 3)
    u = (lo[None] - o[:, None]) * inv[:, None]  # (B, G, 3)
    w = (hi[None] - o[:, None]) * inv[:, None]
    tmin = torch.amax(torch.minimum(u, w), dim=-1)
    tmax = torch.amin(torch.maximum(u, w), dim=-1)
    limit0 = torch.clamp_max(tlim, BIG_T)
    # The part of the slab test that does not depend on the visiting order.
    gmask = (tmax > tmin) & (tmax > 0.0) & (tmin < limit0[:, None]) & live[:, None]

    s = o[:, None] - an[None]  # (B, G, 3) group-anchored origins
    od = _dot3(s, d[:, None])  # (B, G)
    oo = _dot3(s, s)
    C = accel.otab[:n_pad, OT_CX:OT_CZ + 1].reshape(1, G, gr, 3)
    k1 = accel.otab[:n_pad, OT_K1].reshape(1, G, gr)
    DC = _dot3(C, d[:, None, None])  # (B, G, gr)
    OC = _dot3(C, s[:, :, None])
    nb = DC - od[:, :, None]  # = -half_b
    c_q = oo[:, :, None] + k1 - 2.0 * OC
    if accel.has_motion:
        DP = accel.otab[:n_pad, OT_DPX:OT_DPZ + 1].reshape(1, G, gr, 3)
        k2 = accel.otab[:n_pad, OT_K2].reshape(1, G, gr)
        k3 = accel.otab[:n_pad, OT_K3].reshape(1, G, gr)
        m = omt[:, None, None]
        DDP = _dot3(DP, d[:, None, None])
        ODP = _dot3(DP, s[:, :, None])
        nb = nb - m * DDP
        c_q = c_q + m * (2.0 * ODP - k2) + (m * m) * k3
    disc = nb * nb - c_q
    sq = torch.sqrt(torch.clamp_min(disc, 0.0))
    tn = nb - sq  # near root (a == 1)
    t = torch.where(tn > 0.0, tn, nb + sq)
    pred = (disc > 0.0) & (t > 0.0) & gmask[:, :, None]
    tc = torch.where(pred, t, torch.full_like(t, BIG_T)).reshape(-1, n_pad)
    t_min = torch.amin(tc, dim=1)
    rid = torch.arange(n_pad, device=tc.device).expand_as(tc)
    first = torch.amin(
        torch.where(tc == t_min[:, None], rid, torch.full_like(rid, n_pad)), dim=1)
    hit = t_min < limit0
    t_best = torch.where(hit, t_min, limit0)
    obj = torch.where(hit, first, torch.full_like(first, -1))
    if not with_edge:
        return t_best, obj.to(torch.int32)
    # Silhouette candidate: (h/r)^2 - 1 with h the distance from the centre to
    # the ray's line, over every row whose centre lies ahead of a live ray.
    rinv2 = accel.otab[:n_pad, OT_RINV2].reshape(1, G, gr)
    fwd = (nb > 0.0) & live[:, None, None]
    me = torch.where(fwd, (c_q - nb * nb) * rinv2, torch.full_like(nb, BIG_T))
    me = me.reshape(-1, n_pad)
    m_min = torch.amin(me, dim=1)
    e_first = torch.amin(
        torch.where(me == m_min[:, None], rid, torch.full_like(rid, n_pad)), dim=1)
    edge = torch.where(m_min < BIG_T, e_first, torch.full_like(e_first, -1))
    return t_best, obj.to(torch.int32), edge.to(torch.int32)


def _sweep_plain(accel: Accel2, o, d, live, tlim, omt=None, with_edge: bool = False):
    """Nearest (t_best, obj) over all rays, in chunks that bound memory, and
    ``edge`` with ``with_edge``.  Misses return obj = -1 and
    t_best = min(BIG_T, tlim)."""
    B = o.shape[0]
    if accel.has_motion and omt is None:
        raise ValueError("a moving accel needs omt = 1 - time_ratio per ray")
    if B <= _PLAIN_CHUNK:
        return _sweep_chunk(accel, o, d, live, tlim, omt, with_edge)
    parts = []
    for b0 in range(0, B, _PLAIN_CHUNK):
        sl = slice(b0, b0 + _PLAIN_CHUNK)
        parts.append(_sweep_chunk(accel, o[sl], d[sl], live[sl], tlim[sl],
                                  omt[sl] if accel.has_motion else None, with_edge))
    return tuple(torch.cat(x) for x in zip(*parts))


def _gather_rows(accel: Accel2, obj):
    """The winners' ftab rows (B, FT_COLS); misses read zeros."""
    hit = obj >= 0
    rows = accel.ftab[obj.clamp_min(0).long()]
    return torch.where(hit[:, None], rows, torch.zeros_like(rows))


def _winner_refine(rows, o, d, t_best, hit, omt=None):
    """Re-solve the winner's quadratic DIRECTLY in its own frame
    (rel = o - c, the well-conditioned form) and derive the hit normal.
    The group-anchored sweep t carries up to ~7e-3 absolute error — bigger
    than the 1e-4 surface offset children spawn from.  ``omt`` (B,), given
    for a moving accel, shifts the centre to ``c - omt * dp``.
    Returns (t_best, t_safe, p (B, 3), n (B, 3))."""
    ce = rows[:, FT_CX:FT_CZ + 1]
    if omt is not None:
        ce = ce - omt[:, None] * rows[:, FT_DPX:FT_DPZ + 1]
    re = o - ce
    hb = _dot3(re, d)
    cq = _dot3(re, re) - rows[:, FT_R2]
    disc = hb * hb - cq
    sqw = torch.sqrt(torch.clamp_min(disc, 0.0))
    tn = -hb - sqw
    tf = -hb + sqw
    t_ref = torch.where(tn > 0.0, tn, tf)
    ok = hit & (disc > 0.0) & (t_ref > 0.0)
    t_best = torch.where(ok, t_ref, t_best)
    t_safe = torch.where(hit, t_best, torch.ones_like(t_best))
    p = o + t_safe[:, None] * d
    n = (p - ce) * rows[:, FT_RINV:FT_RINV + 1]
    return t_best, t_safe, p, n


def _ri_probe(accel: Accel2, q, omt=None):
    """Surrounding-RI containment sum at probe points q (B, 3) over the
    trailing dielectric-only probe sub-table; same quadratic expansion as the
    sweep (r^2 cancels: inside <=> qq + K1 - 2 C.q <= 0, plus the motion
    terms of a moving accel at ``omt`` (B,)).  Mean RI of the containing rows
    when their sum exceeds 1, else 1."""
    if accel.n_pgroups == 0:
        return torch.ones(q.shape[0], dtype=q.dtype, device=q.device)
    rows = accel.otab[accel.n_pad:]  # (Pp, OT_COLS)
    an = accel.gaabb[accel.n_groups:, 6:9]  # (PG, 3)
    u = q[:, None] - an[None]  # (B, PG, 3) group-anchored probe points
    qq = _dot3(u, u)
    C = rows[:, OT_CX:OT_CZ + 1].reshape(1, -1, PROBE_GR, 3)
    k1 = rows[:, OT_K1].reshape(1, -1, PROBE_GR)
    ri = rows[:, OT_RI].reshape(1, -1, PROBE_GR)
    QC = _dot3(C, u[:, :, None])
    lhs = qq[:, :, None] + k1 - 2.0 * QC
    if accel.has_motion:
        DP = rows[:, OT_DPX:OT_DPZ + 1].reshape(1, -1, PROBE_GR, 3)
        k2 = rows[:, OT_K2].reshape(1, -1, PROBE_GR)
        k3 = rows[:, OT_K3].reshape(1, -1, PROBE_GR)
        m = omt[:, None, None]
        QDP = _dot3(DP, u[:, :, None])
        lhs = lhs + m * (2.0 * QDP - k2) + (m * m) * k3
    inside = lhs <= 0.0
    acc = torch.sum(torch.where(inside, ri, torch.zeros_like(ri)), dim=(1, 2))
    cnt = torch.sum(inside.to(q.dtype), dim=(1, 2))
    return torch.where(acc > 1.0, acc / torch.clamp_min(cnt, 1.0),
                       torch.ones_like(acc))


def sweep2_plain(accel: Accel2, rays, with_ri: bool, with_fields: bool):
    """Plain PyTorch version of the sweep kernel.

    ``rays``: (8, B).  Returns (t (B,), obj (B,) i32, rows (V_ROWS, B) or
    None): nearest hit over the sorted rows (obj = -1, t = BIG_T on a miss);
    with ``with_fields`` t is the refined t and ``rows`` is the hit block
    (surrounding RI probed when ``with_ri`` for the rays that need it, else
    1)."""
    o = rays[0:3].T
    d = rays[3:6].T
    tlim = rays[7]
    omt = rays[6] if accel.has_motion else None
    live = _dot3(d, d) > 0.5  # dead rays carry d = 0 (unit dirs otherwise)
    t_best, obj = _sweep_plain(accel, o, d, live, tlim, omt)
    hit = obj >= 0
    big = torch.full_like(t_best, BIG_T)
    if not with_fields:
        return torch.where(hit, t_best, big), obj, None
    rows = _gather_rows(accel, obj)
    t_best, _, p, n = _winner_refine(rows, o, d, t_best, hit, omt)
    t_out = torch.where(hit, t_best, big)
    if with_ri:
        # Only dielectric winners and interior hits consume the surrounding
        # RI downstream (refraction eta); every other ray reads the neutral 1.
        need = hit & ((_dot3(n, d) > 0.0) | (rows[:, FT_REFR] > 0.002))
        sur_ri = torch.where(need, _ri_probe(accel, p + 1e-3 * n, omt),
                             torch.ones_like(t_out))
    else:
        sur_ri = torch.ones_like(t_out)
    block = torch.stack([
        t_out, sur_ri, n[:, 0], n[:, 1], n[:, 2],
        rows[:, FT_CR], rows[:, FT_CG], rows[:, FT_CB],
        rows[:, FT_MRI], rows[:, FT_REFR], rows[:, FT_REFL],
        rows[:, FT_SRFR], rows[:, FT_SRFL], rows[:, FT_TEX],
        rows[:, FT_EMIS], rows[:, FT_OBJ],
    ])
    return t_out, obj, block


def sweep2_edge_plain(accel: Accel2, rays):
    """Plain PyTorch version of the kernel's silhouette instantiation:
    ``rays`` (8, B) -> (t (B,), obj (B,) i32, edge (B,) i32).

    ``t`` and ``obj`` are ``sweep2_plain``'s without fields.  ``edge`` is the
    near-miss candidate of the gradient path's soft edges: the row with the
    least ``(c_q - nb^2) * rinv2`` (= (h/r)^2 - 1, h the distance from its
    centre to the ray's line, in the group-anchored frame of the sweep) among
    the rows whose centre lies ahead (``nb > 0``), over EVERY row of the main
    table: the lowest row wins a tie, and -1 means that no row lies ahead or
    that the ray is dead.  Dead and padding rows take part with K1 = BIG_T and
    rinv2 = 1e-30 (a metric of about 3e8).  The JAX kernel evaluates the
    metric only in groups that some ray of its 2048-ray block entered; on the
    rows it saw, the two agree."""
    o = rays[0:3].T
    d = rays[3:6].T
    omt = rays[6] if accel.has_motion else None
    live = _dot3(d, d) > 0.5
    t_best, obj, edge = _sweep_plain(accel, o, d, live, rays[7], omt, with_edge=True)
    return torch.where(obj >= 0, t_best, torch.full_like(t_best, BIG_T)), obj, edge


# ---------------------------------------------------------------------------
# Kernel wrapper
# ---------------------------------------------------------------------------


def check_accel(accel: Accel2, device):
    """Raise unless the accel's tables are what the kernels take."""
    n_pad = accel.n_pad
    if accel.gr <= 0 or n_pad % accel.gr:
        raise ValueError(f"accel: {n_pad} rows are no multiple of gr={accel.gr}")
    f32 = torch.float32
    _check_tensor("accel.ftab", accel.ftab, f32, (n_pad, FT_COLS), device)
    _check_tensor("accel.otab", accel.otab, f32,
                  (n_pad + accel.n_pgroups * PROBE_GR, accel.ot_cols), device)
    _check_tensor("accel.gaabb", accel.gaabb, f32,
                  (accel.n_groups + accel.n_pgroups, GA_COLS), device)


def live_row_bounds(accel):
    """(n_groups,) int32 on the accel's device: each main group's last live
    row + 1 (0 for a group without one).  A row is live where the generic
    ``valid`` column is positive (``sweep2g.Accel2G``), or, in sphere mode,
    where K1 < BIG_T."""
    rows = accel.otab[:accel.n_groups * accel.gr]
    if accel.mode == "generic":
        from raytracing_tests_tpu_torch.kernels.sweep2g import GO_VALID

        live = rows[:, GO_VALID] > 0.0
    else:
        live = rows[:, OT_K1] < BIG_T
    pos = torch.arange(1, accel.gr + 1, dtype=torch.int32, device=rows.device)
    return (live.reshape(accel.n_groups, accel.gr).to(torch.int32) * pos).amax(dim=1)


def live_rows(accel):
    """``live_row_bounds(accel)``, computed once per accel: every launch of K1,
    K2, K3 and K6 on it reads the same tensor.  Kept on the accel and renewed when
    its ``otab`` is replaced or written in place."""
    key = (accel.otab.data_ptr(), accel.otab._version)
    memo = accel.__dict__.get("_live_rows")
    if memo is None or memo[0] != key:
        memo = accel.__dict__["_live_rows"] = (key, live_row_bounds(accel))
    return memo[1]


def refresh_live_rows(accel):
    """``live_rows(accel)`` after the accel's ``otab`` was written in place,
    computed into the tensor the memo already holds: a CUDA graph captured
    with a launch on this accel reads that tensor, and a replay calls no
    wrapper that would renew it."""
    memo = accel.__dict__.get("_live_rows")
    if memo is None:
        return live_rows(accel)
    memo[1].copy_(live_row_bounds(accel))
    accel.__dict__["_live_rows"] = ((accel.otab.data_ptr(), accel.otab._version), memo[1])
    return memo[1]


def _launch_sweep2(accel: Accel2, rays, with_ri: bool, with_fields: bool, stats=None,
                   with_edge: bool = False):
    """Check the arguments and launch ``csrc/sweep2.cu`` -> (t, obj, rows or
    None), or with ``with_edge`` (no fields) its silhouette instantiation ->
    (t, obj, edge)."""
    if with_edge and with_fields:
        raise ValueError("the silhouette instantiation writes no hit block")
    dev = rays.device
    if rays.dim() != 2:
        raise ValueError(f"rays: shape {tuple(rays.shape)}, expected (8, B)")
    B = rays.shape[1]
    _check_tensor("rays", rays, torch.float32, (8, B), dev)
    check_accel(accel, dev)
    if stats is not None:
        _check_tensor("stats", stats, torch.int64, (SW_LEN,), dev)
    _build.check_device(dev)
    fn = _build.load("sweep2").rt_sweep2
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, i, i, i, i, i, i, p, i, p, p, p, i, p, p, p]
        fn.restype = ctypes.c_int
    t = torch.empty((B,), dtype=torch.float32, device=dev)
    obj = torch.empty((B,), dtype=torch.int32, device=dev)
    rows = (torch.empty((V_ROWS, B), dtype=torch.float32, device=dev)
            if with_fields else None)
    edge = torch.empty((B,), dtype=torch.int32, device=dev) if with_edge else None
    code = fn(accel.otab.data_ptr(), accel.ftab.data_ptr(),
              accel.gaabb.data_ptr(), live_rows(accel).data_ptr(), accel.n_groups,
              accel.gr, accel.n_pgroups, PROBE_GR, int(accel.has_motion),
              _build.coop_min(COOP_MIN), rays.data_ptr(), B, t.data_ptr(), obj.data_ptr(),
              rows.data_ptr() if with_fields else None, int(with_ri),
              edge.data_ptr() if with_edge else None,
              stats.data_ptr() if stats is not None else None,
              _build.stream_of(dev))
    _build.check(code, "rt_sweep2")
    name = "sweep2_m" if accel.has_motion else "sweep2"
    _build.LAUNCHES[name + "_edge" if with_edge else name] += 1
    return (t, obj, edge) if with_edge else (t, obj, rows)


def _sweep2(accel: Accel2, rays, with_ri: bool, with_fields: bool, stats=None):
    """The sweep on ``rays`` (8, B) f32: (t, obj, rows or None).

    CPU tensors go through ``sweep2_plain``; CUDA tensors launch the kernel of
    ``csrc/sweep2.cu`` on the current stream (or raise), in its static or its
    motion instantiation by ``accel.has_motion`` (counted as ``sweep2`` and
    ``sweep2_m``).  ``stats``: optional zeroed int64[SW_LEN] CUDA tensor
    that gains the kernel's work counters (``SW_*``; measurement only)."""
    if rays.device.type == "cpu":
        if accel.device.type != "cpu":
            raise ValueError("rays on the CPU but accel on " + str(accel.device))
        return sweep2_plain(accel, rays, with_ri, with_fields)
    with torch.cuda.device(rays.device):
        return _launch_sweep2(accel, rays, with_ri, with_fields, stats)


def sweep2_nearest(accel: Accel2, o, d, time_ratio, t_limit):
    """(t, obj_sorted) nearest-hit sweep (occlusion-grade, no fields)."""
    t, obj, _ = _sweep2(accel, pack_rays(o, d, time_ratio, t_limit), False, False)
    return t, obj


def _sweep2_edge(accel: Accel2, rays, stats=None):
    """The silhouette sweep on ``rays`` (8, B) f32: (t, obj, edge).

    CPU tensors go through ``sweep2_edge_plain``; CUDA tensors launch the
    ``EDGE`` instantiation of ``csrc/sweep2.cu`` (or raise), static or motion
    by ``accel.has_motion`` (counted as ``sweep2_edge`` and ``sweep2_m_edge``).
    ``stats`` as for ``_sweep2``: the nearest-hit sweep's counters."""
    if rays.device.type == "cpu":
        if accel.device.type != "cpu":
            raise ValueError("rays on the CPU but accel on " + str(accel.device))
        return sweep2_edge_plain(accel, rays)
    with torch.cuda.device(rays.device):
        return _launch_sweep2(accel, rays, False, False, stats, with_edge=True)


def sweep2_nearest_edge(accel: Accel2, o, d, time_ratio, t_limit):
    """(t, obj_sorted, edge_sorted): ``sweep2_nearest`` and the near-miss
    silhouette candidate of the soft-edge gradient (``sweep2_edge_plain``)."""
    return _sweep2_edge(accel, pack_rays(o, d, time_ratio, t_limit))


def sweep2_full(accel: Accel2, o, d, time_ratio, t_limit, with_ri: bool):
    """(t, obj_sorted, hit_rows (V_ROWS, B)) full sweep with the winner's
    row (+ surrounding RI when ``with_ri``)."""
    return _sweep2(accel, pack_rays(o, d, time_ratio, t_limit), with_ri, True)


# ---------------------------------------------------------------------------
# intersect-module adapters (Hit / HitFields contract)
# ---------------------------------------------------------------------------


def _rows_to_hit(accel: Accel2, t, obj, rows):
    hit = obj >= 0
    t_safe = torch.where(hit, t, torch.ones_like(t))
    normal = torch.stack([rows[V_NX], rows[V_NY], rows[V_NZ]], dim=1)
    flds = HitFields(
        color=torch.stack([rows[V_CR], rows[V_CG], rows[V_CB]], dim=1),
        refractive_index=rows[V_MRI],
        refractivity=rows[V_REFR],
        reflectivity=rows[V_REFL],
        scatter_refract=rows[V_SRFR],
        scatter_reflect=rows[V_SRFL],
        texture_index=torch.round(rows[V_TEX]).to(torch.int32),
        emissive=rows[V_EMIS] > 0.5,
    )
    # local_pos == unit normal for isotropic spheres (p_rel / r).
    h = Hit(t=t_safe, obj=torch.round(rows[V_OBJ]).to(torch.int32), hit=hit,
            normal=normal, local_pos=normal)
    return h, flds


def intersect2_fused(accel: Accel2, scene, o, d, time_ratio, t_limit):
    """(Hit, HitFields, surrounding_ri) — everything in one kernel."""
    t, obj, rows = sweep2_full(accel, o, d, time_ratio, t_limit, with_ri=True)
    h, flds = _rows_to_hit(accel, t, obj, rows)
    return h, flds, rows[V_RI]


def intersect2_full(accel: Accel2, scene, o, d, time_ratio, t_limit):
    """(Hit, HitFields) without the RI probe (non-dielectric scenes)."""
    t, obj, rows = sweep2_full(accel, o, d, time_ratio, t_limit, with_ri=False)
    return _rows_to_hit(accel, t, obj, rows)


def intersect2(accel: Accel2, scene, o, d, time_ratio, t_limit) -> Hit:
    return intersect2_full(accel, scene, o, d, time_ratio, t_limit)[0]


def occluded_nearest_obj2(accel: Accel2, scene, o, d, time_ratio, t_limit):
    """Original-id of the nearest hit (occlusion/shadow queries)."""
    _, obj = sweep2_nearest(accel, o, d, time_ratio, t_limit)
    return torch.where(obj >= 0, accel.perm[obj.clamp_min(0).long()],
                       torch.full_like(obj, -1))
