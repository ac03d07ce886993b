"""Grouped sweep over rotated ellipsoids and cuboids (generic mode).

Counterpart of the JAX package's ``kernels/sweep2g.py``: the grouped
block-culling architecture of ``sweep2`` for the generic primitive test
(inverse rotation into the local frame, then ellipsoid quadratic or cuboid slab
by object type), so the persistent path tracer (``kernels/uber.py``) can render
rotated-cuboid scenes (the INW-01 grid family).

  - Objects are grouped TYPE-PURE: each primitive class (ellipsoid / cuboid)
    is chunked into groups of ``gr`` rows along its own Morton order, huge
    objects last within their class; partial tails are padded with dead rows.
  - A static per-group census (``gkinds``: 's' isotropic spheres, 'a' unrotated
    cuboids, 'cy' cuboids rotated about y only, 'e' ellipsoids, 'c' cuboids,
    'm' mixed) picks the cheapest exact candidate arithmetic of a group.
  - Candidates keep the dense intersector's divide-by-scale arithmetic, with a
    bare-reciprocal slab for censused cuboids; the winner is re-solved in the
    dense intersector's own form (``_winner_refine_g``).
  - Two-level culling: groups under super-groups of ``SG`` groups whose union
    boxes trail the group table (only when there are more than ``SG`` groups);
    groups are ordered near-to-far from ``sort_origin``.
  - Dielectric scenes: ``_ri_probe_g`` is the rotated point-in-primitive
    containment sum over a trailing dielectric-only sub-table, in the fused
    frame M = diag(1/scale) R^T.

The kernel is hand-written CUDA (``csrc/sweep2g.cu``, the warp sweep of
``csrc/warp_sweep.cuh``): each warp sweeps every group together, per lane where
at least ``COOP_MIN`` of its lanes entered the group, row-parallel where fewer
did, and rows past a group's last live row (``sweep2.live_rows``, computed once
per accel) are never read; every schedule gives the same result.
``sweep2g_plain`` is the same function in plain PyTorch, visiting the groups
in the same order behind the same per-ray slab tests.  The wrapper uses the plain version only for tensors that lie on the
CPU; for a CUDA tensor it launches the kernel or raises.

Tables are row-major with 16-byte-aligned rows (layouts below and in
``rt_common.cuh``); row order, ``perm`` and ``gkinds`` are the JAX package's.
Not carried over, being measures for the TPU: the packed 11-bit (t, id) key,
the bf16 field-table splits, and the ablation switches read from the
environment.

The silhouette instantiation (``sweep2g_nearest_edge``, the JAX kernel's
``with_edge``) adds the near-miss candidate of the gradient path's soft
edges: the valid row with the least unit-space line distance, over every row
of the main table (``sweep2g_edge_plain`` defines it).  Its nearest (t, obj)
is the nearest-hit sweep's: this port keeps the full t in both.  The kernel
evaluates the metric only on the rows of blocks whose lower bound does not lie
above the ray's best (the block table and bound: ``kernels/edge_cull.py``).

Directions are assumed unit; dead rays carry d = 0 and never hit.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from raytracing_tests_tpu_torch.core import geometry
from raytracing_tests_tpu_torch.kernels import _build
from raytracing_tests_tpu_torch.kernels.sweep import _cub_t_div, _ell_t_div, _slab_t, _where_big
from raytracing_tests_tpu_torch.kernels.sweep2 import (
    BIG_T, FT_CX, FT_CZ, FT_DPX, FT_DPZ, GA_COLS, PROBE_GR, _check_tensor, _dot3,
    _probe_tables, live_rows, pack_rays,
)
from raytracing_tests_tpu_torch.scene.types import Scene

SG = 8  # groups per super-group (two-level culling)
DEFAULT_GR = 64

# Generic object table (Np + Pp, GO_COLS) columns.  M is the fused frame
# matrix diag(1/scale) @ R^T (row-major); R the raw rotation (local -> world).
GO_PX, GO_PY, GO_PZ, GO_TYPE = 0, 1, 2, 3
GO_DPX, GO_DPY, GO_DPZ, GO_VALID = 4, 5, 6, 7
GO_SX, GO_SY, GO_SZ, GO_RI = 8, 9, 10, 11
GO_R00 = 12  # .. 20
GO_M00 = 21  # .. 29
GO_COLS = 32  # eight 16-byte loads per row

# Generic fields table (Np, GFT_COLS): sweep2's FT_* material columns (0..18)
# + the winner geometry of the refine: rotation, scale, type.
GFT_R00 = 19  # .. 27
GFT_SX, GFT_SY, GFT_SZ = 28, 29, 30
GFT_TYPE = 31
GFT_COLS = 32

# Column of the main gaabb rows that carries the group's kind code.
GA_KIND = 6
KIND_CODES = {"m": 0, "e": 1, "c": 2, "s": 3, "a": 4, "cy": 5}

_ELL = float(geometry.ELLIPSOID)
_CUB = float(geometry.CUBOID)

# A culling group that fewer than this many lanes of a warp entered is swept
# row-parallel, in the nearest-hit sweep and in its silhouette (EDGE) twin
# (the fastest of 1..33 over the hard generic gradient step, and summed over
# the two soft ones, PERF.md); 1 keeps every group per lane, 33 sweeps every
# group row-parallel.  ``_build.forced_coop_min`` pins another for tests and
# measurement.
COOP_MIN = 8
# Work counters of the kernel (csrc/sweep2g.cu GC_*: slab tests, the live rows
# the walk of one thread per ray tests in sphere-kind groups and in others,
# 32 x the row iterations the warps issued, their row-parallel group visits),
# and the silhouette instantiation's after them (EC_*: block bounds computed,
# rows evaluated for rays that hit / missed, 32 x the walk's row iterations).
GC_SLAB, GC_SPHERE_ROWS, GC_OTHER_ROWS, GC_SLOTS, GC_COOP, GC_LEN = range(6)
EC_BOUNDS, EC_ROWS_HIT, EC_ROWS_MISS, EC_SLOTS, EC_LEN = range(GC_LEN, GC_LEN + 5)


# ---------------------------------------------------------------------------
# Packing
# ---------------------------------------------------------------------------


def pack_tables_g(scene: Scene, order, n_pad: int, valid_mask=None, pos_live=None):
    """Ordered scene -> (otab (n_pad, GO_COLS), ftab (n_pad, GFT_COLS)).

    ``order`` is the sorted->original permutation.  ``valid_mask``
    (original-index space) additionally kills rows — used by the
    dielectric-only probe sub-table.  ``pos_live`` (positional, length of
    ``order``) kills the dead padding rows the type-pure grouping inserts
    mid-table (duplicated index-0 fillers)."""
    s = {f: getattr(scene, f)[order] for f in (
        "position", "rotation", "scale", "delta_position", "obj_type", "color",
        "refractive_index", "refractivity", "reflectivity", "scatter_refract",
        "scatter_reflect", "texture_index", "emissive", "valid",
    )}
    dev = scene.device
    f32 = torch.float32
    valid = s["valid"]
    if valid_mask is not None:
        valid = valid & valid_mask[order]
    if pos_live is not None:
        valid = valid & torch.as_tensor(pos_live, dtype=torch.bool, device=dev)
    n = order.shape[0]
    c, dp, R, sc = s["position"], s["delta_position"], s["rotation"], s["scale"]
    typ = s["obj_type"].to(f32)

    # Fused frame M = diag(1/s) @ R^T: M[i][j] = R[j][i] / s_i.  Padding and
    # invalid rows may carry zero scale: guard to keep the table finite.
    s_safe = torch.where(sc > 0.0, sc, torch.ones_like(sc))
    M = R.transpose(1, 2) / s_safe[:, :, None]
    otab = torch.zeros((n_pad, GO_COLS), dtype=f32, device=dev)
    otab[:n, GO_PX:GO_PZ + 1] = c
    otab[:n, GO_TYPE] = typ
    otab[:n, GO_DPX:GO_DPZ + 1] = dp
    otab[:n, GO_VALID] = valid.to(f32)
    otab[:n, GO_SX:GO_SZ + 1] = s_safe
    otab[:n, GO_RI] = s["refractive_index"]
    otab[:n, GO_R00:GO_R00 + 9] = R.reshape(n, 9)
    otab[:n, GO_M00:GO_M00 + 9] = M.reshape(n, 9)
    otab[n:, GO_SX:GO_SZ + 1] = 1.0  # padding rows: dead, but finite

    zero = torch.zeros(n, dtype=f32, device=dev)
    fcols = [
        c[:, 0], c[:, 1], c[:, 2],
        zero,  # FT_RINV unused in generic mode
        dp[:, 0], dp[:, 1], dp[:, 2],
        s["color"][:, 0], s["color"][:, 1], s["color"][:, 2],
        s["refractive_index"], s["refractivity"], s["reflectivity"],
        s["scatter_refract"], s["scatter_reflect"],
        s["texture_index"].to(f32), s["emissive"].to(f32), order.to(f32),
        zero,  # FT_R2 unused in generic mode
        *[R.reshape(n, 9)[:, i] for i in range(9)],
        sc[:, 0], sc[:, 1], sc[:, 2], typ,
    ]
    assert len(fcols) == GFT_COLS
    ftab = torch.zeros((n_pad, GFT_COLS), dtype=f32, device=dev)
    ftab[:n] = torch.stack(fcols, dim=1)
    return otab, ftab


@dataclasses.dataclass
class Accel2G:
    """Generic-mode accel: type-pure grouped tables + group boxes.

    ``otab``/``gaabb`` carry ``n_pgroups`` trailing dielectric-only probe
    groups after the main groups, and ``gaabb`` then ``n_sgroups`` super-group
    union boxes.  ``ftab`` spans the main rows only.  ``gkinds`` is the
    per-group type census; the kernels read it as a code in column
    ``GA_KIND`` of the main ``gaabb`` rows."""

    otab: torch.Tensor  # (Np + Pp, GO_COLS)
    ftab: torch.Tensor  # (Np, GFT_COLS)
    gaabb: torch.Tensor  # (G + PG + SGn, GA_COLS) rows: lo3 hi3 kind
    perm: torch.Tensor  # (Np,) i32 sorted -> original
    gr: int
    has_motion: bool = False
    n_pgroups: int = 0
    n_sgroups: int = 0
    gkinds: tuple = ()

    mode = "generic"

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


def _pack_probe_g(scene, porder, np_pad, anchor, dmask, dm):
    tab = pack_tables_g(scene, porder, np_pad, dmask)[0]
    tab[:, GO_VALID] = torch.where(dm, tab[:, GO_VALID], torch.zeros_like(tab[:, GO_VALID]))
    return tab


def census(otab, G: int, gr: int) -> tuple:
    """Per-group kinds of the main rows of ``otab`` (host side).

    's': every valid row an isotropic ellipsoid (rotation is irrelevant to the
    intersection of a sphere).  'a' / 'cy': every valid row a cuboid whose
    rotation is the identity / a rotation about y — the skipped matrix terms
    multiply exact zeros and ones, so both match the full transform up to the
    sign of exact zeros.  Else 'e', 'c' or 'm' by the types present."""
    tab = otab[:G * gr].detach().cpu().numpy()
    typ = tab[:, GO_TYPE].reshape(G, gr)
    vld = tab[:, GO_VALID].reshape(G, gr) > 0
    sc3 = tab[:, GO_SX:GO_SZ + 1].reshape(G, gr, 3)
    iso = (sc3[..., 0] == sc3[..., 1]) & (sc3[..., 0] == sc3[..., 2])
    rot = tab[:, GO_R00:GO_R00 + 9].reshape(G, gr, 9)
    ident = (rot == np.eye(3, dtype=np.float32).reshape(9)).all(axis=-1)
    yrot = ((rot[..., 1] == 0) & (rot[..., 3] == 0) & (rot[..., 4] == 1)
            & (rot[..., 5] == 0) & (rot[..., 7] == 0))
    kinds = []
    for g in range(G):
        v = vld[g]
        t = typ[g][v]
        has_e = bool((t == _ELL).any())
        has_c = bool((t != _ELL).any())
        if has_e and not has_c and bool(iso[g][v].all()):
            kinds.append("s")
        elif has_c and not has_e and bool(ident[g][v].all()):
            kinds.append("a")
        elif has_c and not has_e and bool(yrot[g][v].all()):
            kinds.append("cy")
        else:
            kinds.append("m" if (has_e and has_c) else ("c" if has_c else "e"))
    return tuple(kinds)


def make_accel2g(scene: Scene, gr: int = DEFAULT_GR, has_motion: bool = True,
                 sort_origin=None, probe_rows=None, probe_mask=None) -> Accel2G:
    """Type-pure Morton groups of ``gr`` rows (huge objects last in their
    class), ordered near-to-far from ``sort_origin``, with trailing probe
    groups (see ``sweep2._probe_tables``) and super-group boxes.  Built on the
    scene's device; the grouping itself runs on the host."""
    from raytracing_tests_tpu_torch.bvh.build import morton3d

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
    key = torch.where(valid, key, torch.full_like(key, 0xFFFFFFFF))
    morder = torch.argsort(key, stable=True).cpu().numpy()

    # Chunk each primitive class along its own Morton order: every group is
    # single-type, huge rows ride the tail group of their class (a world-size
    # box must not make a full regular group always-entered).
    v_np = valid.cpu().numpy()
    h_np = huge.cpu().numpy()
    isc_np = (scene.obj_type != geometry.ELLIPSOID).cpu().numpy() & v_np
    cls = {(False, False): [], (False, True): [], (True, False): [], (True, True): []}
    for i in morder:
        i = int(i)
        if v_np[i]:
            cls[bool(isc_np[i]), bool(h_np[i])].append(i)
    groups = []
    for is_cub in (False, True):
        cl = cls[is_cub, False] + cls[is_cub, True]  # huge last
        groups += [cl[k0:k0 + gr] for k0 in range(0, len(cl), gr)]
    if not groups:  # degenerate all-invalid scene
        groups = [[0]]
    rows, lv = [], []
    for gm in groups:
        rows += gm + [0] * (gr - len(gm))
        lv += [True] * len(gm) + [False] * (gr - len(gm))
    order = torch.from_numpy(np.array(rows, np.int64)).to(dev)
    pos_live = torch.from_numpy(np.array(lv, bool)).to(dev)
    n_pad = order.shape[0]
    G = n_pad // gr

    INF = 3.0e38
    vord = (valid[order] & pos_live)[:, None]
    lo_s = torch.where(vord, lo[order], torch.full((n_pad, 3), INF, device=dev))
    hi_s = torch.where(vord, hi[order], torch.full((n_pad, 3), -INF, device=dev))
    glo = torch.amin(lo_s.reshape(G, gr, 3), dim=1)
    ghi = torch.amax(hi_s.reshape(G, gr, 3), dim=1)
    gaabb = torch.zeros((G, GA_COLS), dtype=torch.float32, device=dev)
    gaabb[:, 0:3] = glo
    gaabb[:, 3:6] = ghi

    otab, ftab = pack_tables_g(scene, order, n_pad, pos_live=pos_live)
    perm = order.to(torch.int32)
    if sort_origin is not None:
        origin = torch.as_tensor(sort_origin, dtype=torch.float32, device=dev)
        near = torch.minimum(torch.maximum(origin, glo), ghi)  # closest box point
        d2 = torch.sum((near - origin) ** 2, dim=1)
        gorder = torch.argsort(d2, stable=True)
        otab = otab.reshape(G, gr, GO_COLS)[gorder].reshape(n_pad, GO_COLS)
        ftab = ftab.reshape(G, gr, GFT_COLS)[gorder].reshape(n_pad, GFT_COLS)
        gaabb = gaabb[gorder]
        perm = perm.reshape(G, gr)[gorder].reshape(n_pad)

    gkinds = census(otab, G, gr)
    gaabb[:, GA_KIND] = torch.tensor([KIND_CODES[k] for k in gkinds],
                                     dtype=torch.float32, device=dev)

    potab, pgaabb = _probe_tables(scene, key, valid, lo, hi, probe_rows,
                                  probe_mask=probe_mask, packer=_pack_probe_g,
                                  ot_cols=GO_COLS)
    parts = [gaabb, pgaabb]

    # Super-group union boxes over the FINAL (near-to-far) group order; only
    # formed when there are enough groups to be worth a level.
    n_sgroups = 0
    if G > SG:
        n_sgroups = -(-G // SG)
        pad = n_sgroups * SG - G
        glo_p = torch.cat([gaabb[:, 0:3], torch.full((pad, 3), INF, device=dev)])
        ghi_p = torch.cat([gaabb[:, 3:6], torch.full((pad, 3), -INF, device=dev)])
        sga = torch.zeros((n_sgroups, GA_COLS), dtype=torch.float32, device=dev)
        sga[:, 0:3] = torch.amin(glo_p.reshape(n_sgroups, SG, 3), dim=1)
        sga[:, 3:6] = torch.amax(ghi_p.reshape(n_sgroups, SG, 3), dim=1)
        parts.append(sga)

    return Accel2G(
        otab=torch.cat([otab, potab]).contiguous(), ftab=ftab.contiguous(),
        gaabb=torch.cat(parts).contiguous(), perm=perm.contiguous(), gr=gr,
        has_motion=has_motion, n_pgroups=pgaabb.shape[0], n_sgroups=n_sgroups,
        gkinds=gkinds)


# ---------------------------------------------------------------------------
# The plain PyTorch version
# ---------------------------------------------------------------------------


def _cub_t_inf(lox, loy, loz, ldx, ldy, ldz, sx, sy, sz):
    """Cuboid slab t with a bare reciprocal: 1/0 = +-inf gives the exact
    parallel-ray slab; an origin exactly on a slab plane of a parallel ray
    (0 * inf = NaN) reports a miss."""
    def axis(lo, ld, s):
        inv = 1.0 / ld
        return (-0.5 * s - lo) * inv, (0.5 * s - lo) * inv

    return _slab_t([axis(lox, ldx, sx), axis(loy, ldy, sy), axis(loz, ldz, sz)])


def _slab_hit(ga, o, inv, t_best):
    """Box rows ``ga`` (lo3 hi3 ..) against rays: (B,) or (B, K) bool."""
    u = (ga[..., 0:3] - o) * inv
    w = (ga[..., 3:6] - o) * inv
    tmin = torch.amax(torch.minimum(u, w), dim=-1)
    tmax = torch.amin(torch.maximum(u, w), dim=-1)
    return (tmax > tmin) & (tmax > 0.0) & (tmin < t_best)


def _group_candidates(rows, kind: str, o, d, omt, has_motion: bool):
    """Candidate t (B, gr) of one group's rows (gr, GO_COLS) for rays (B, 3)
    by the group's kind (see ``census``)."""
    col = lambda c: rows[None, :, c]
    ox, oy, oz = o[:, 0:1], o[:, 1:2], o[:, 2:3]
    dx, dy, dz = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    rx, ry, rz = ox - col(GO_PX), oy - col(GO_PY), oz - col(GO_PZ)
    if has_motion:
        m = omt[:, None]
        rx = rx + m * col(GO_DPX)
        ry = ry + m * col(GO_DPY)
        rz = rz + m * col(GO_DPZ)
    sx, sy, sz = col(GO_SX), col(GO_SY), col(GO_SZ)
    if kind == "s":
        # Isotropic sphere, unit direction: the world-frame quadratic, a = 1.
        hb = rx * dx + ry * dy + rz * dz
        cq = rx * rx + ry * ry + rz * rz - sx * sx
        disc = hb * hb - cq
        ok = disc > 0.0
        sq = torch.sqrt(torch.where(ok, disc, torch.ones_like(disc)))
        t0 = -hb - sq
        t1 = -hb + sq
        t_e = torch.where(t0 < 0.0, t1, t0)
        return _where_big(ok & (t_e > 0.0), t_e)
    if kind == "a":
        return _cub_t_inf(rx, ry, rz, dx, dy, dz, sx, sy, sz)
    r = [col(GO_R00 + i) for i in range(9)]
    if kind == "cy":
        return _cub_t_inf(r[0] * rx + r[6] * rz, ry, r[2] * rx + r[8] * rz,
                          r[0] * dx + r[6] * dz, dy, r[2] * dx + r[8] * dz,
                          sx, sy, sz)
    lox = r[0] * rx + r[3] * ry + r[6] * rz
    loy = r[1] * rx + r[4] * ry + r[7] * rz
    loz = r[2] * rx + r[5] * ry + r[8] * rz
    ldx = r[0] * dx + r[3] * dy + r[6] * dz
    ldy = r[1] * dx + r[4] * dy + r[7] * dz
    ldz = r[2] * dx + r[5] * dy + r[8] * dz
    loc = (lox, loy, loz, ldx, ldy, ldz, sx, sy, sz)
    if kind == "e":
        return _ell_t_div(*loc)
    if kind == "c":
        return _cub_t_inf(*loc)
    return torch.where(col(GO_TYPE) == _ELL, _ell_t_div(*loc), _cub_t_div(*loc))


def _sweep_plain_g(accel: Accel2G, o, d, omt, live, tlim):
    """Nearest (t_best, obj) over all rays: super-group slab, group slab, the
    group's rows, in table order and against each ray's current best t — what
    one thread of the kernel does, for all rays at once (the rays that enter a
    group are gathered, so memory stays at entered rays x ``gr``).
    Misses return obj = -1 and t_best = min(BIG_T, tlim)."""
    B = o.shape[0]
    dev = o.device
    G, gr = accel.n_groups, accel.gr
    eps = 1e-12
    inv = 1.0 / torch.where(d.abs() < eps, torch.full_like(d, eps), d)
    t_best = torch.clamp_max(tlim, BIG_T).clone()
    obj = torch.full((B,), -1, dtype=torch.int32, device=dev)
    ga = accel.gaabb
    sg0 = G + accel.n_pgroups
    rid = torch.arange(gr, device=dev)
    for s in range(max(accel.n_sgroups, 1)):
        if accel.n_sgroups:
            shit = live & _slab_hit(ga[sg0 + s], o, inv, t_best)
            g_range = range(s * SG, min((s + 1) * SG, G))
        else:
            shit = live
            g_range = range(G)
        for g in g_range:
            ghit = shit & _slab_hit(ga[g], o, inv, t_best)
            sel = torch.nonzero(ghit)[:, 0]
            if sel.numel() == 0:
                continue
            rows = accel.otab[g * gr:(g + 1) * gr]
            tc = _group_candidates(rows, accel.gkinds[g], o[sel], d[sel], omt[sel],
                                   accel.has_motion)
            tc = _where_big(rows[None, :, GO_VALID] > 0.0, tc)
            gmin = torch.amin(tc, dim=1)
            first = torch.amin(torch.where(tc == gmin[:, None], rid, gr), dim=1)
            better = gmin < t_best[sel]  # ties keep the lower row
            upd = sel[better]
            t_best[upd] = gmin[better]
            obj[upd] = (g * gr + first[better]).to(torch.int32)
    return t_best, obj


def sweep2g_plain(accel: Accel2G, rays):
    """Plain PyTorch version of the sweep kernel: ``rays`` (8, B) ->
    (t (B,), obj (B,) i32); a miss gives obj = -1 and t = min(BIG_T, tlim)."""
    o = rays[0:3].T.contiguous()
    d = rays[3:6].T.contiguous()
    live = _dot3(d, d) > 0.5  # dead rays carry d = 0 (unit dirs otherwise)
    return _sweep_plain_g(accel, o, d, rays[6], live, rays[7])


_EDGE_CHUNK = 4096  # rays per dense (rays x rows) block of the silhouette metric


def _edge_metric_g(accel: Accel2G, o, d, omt):
    """Silhouette candidate (B,) i32 of rays (B, 3): see ``sweep2g_edge_plain``."""
    n_pad = accel.n_pad
    rows = accel.otab[:n_pad]
    col = lambda c: rows[None, :, c]
    out = []
    for b0 in range(0, o.shape[0], _EDGE_CHUNK):
        sl = slice(b0, b0 + _EDGE_CHUNK)
        ob, db = o[sl], d[sl]
        ox, oy, oz = ob[:, 0:1], ob[:, 1:2], ob[:, 2:3]
        dx, dy, dz = db[:, 0:1], db[:, 1:2], db[:, 2:3]
        rx, ry, rz = ox - col(GO_PX), oy - col(GO_PY), oz - col(GO_PZ)
        if accel.has_motion:
            m = omt[sl][:, None]
            rx = rx + m * col(GO_DPX)
            ry = ry + m * col(GO_DPY)
            rz = rz + m * col(GO_DPZ)
        r = [col(GO_R00 + i) for i in range(9)]
        sx, sy, sz = col(GO_SX), col(GO_SY), col(GO_SZ)
        ex = (r[0] * rx + r[3] * ry + r[6] * rz) / sx
        ey = (r[1] * rx + r[4] * ry + r[7] * rz) / sy
        ez = (r[2] * rx + r[5] * ry + r[8] * rz) / sz
        fx = (r[0] * dx + r[3] * dy + r[6] * dz) / sx
        fy = (r[1] * dx + r[4] * dy + r[7] * dz) / sy
        fz = (r[2] * dx + r[5] * dy + r[8] * dz) / sz
        a = fx * fx + fy * fy + fz * fz
        hb = ex * fx + ey * fy + ez * fz
        cc = ex * ex + ey * ey + ez * ez
        me = cc - hb * hb * (1.0 / torch.clamp_min(a, 1e-30)) - 1.0
        cand = (hb < 0.0) & (col(GO_VALID) > 0.0) & (a > 1e-30)
        me = _where_big(cand, me)
        m_min = torch.amin(me, dim=1)
        rid = torch.arange(n_pad, device=o.device).expand_as(me)
        first = torch.amin(torch.where(me == m_min[:, None], rid, n_pad), dim=1)
        out.append(torch.where(m_min < BIG_T, first, -1).to(torch.int32))
    return torch.cat(out) if out else torch.zeros((0,), dtype=torch.int32, device=o.device)


def sweep2g_edge_plain(accel: Accel2G, rays):
    """Plain PyTorch version of the kernel's silhouette instantiation:
    ``rays`` (8, B) -> (t (B,), obj (B,) i32, edge (B,) i32).

    ``t`` and ``obj`` are ``sweep2g_plain``'s.  ``edge`` is the near-miss
    candidate of the generic soft edges: the VALID row with the least
    ``|e|^2 - (e.f)^2 / |f|^2 - 1``, the squared distance from the centre to
    the ray's line in the row's unit space (e = R^T (o - c) / scale, f = R^T d
    / scale) less 1, among the rows with ``e.f < 0`` (centre ahead) and
    ``|f|^2 > 1e-30``, over every row of the main table; the lowest row wins a
    tie, and -1 means no candidate (a dead ray, d = 0, has none).  The JAX
    kernel evaluates the metric only in groups that some ray of its 2048-ray
    block entered; on the rows it saw, the two agree."""
    t, obj = sweep2g_plain(accel, rays)
    o = rays[0:3].T.contiguous()
    d = rays[3:6].T.contiguous()
    return t, obj, _edge_metric_g(accel, o, d, rays[6])


def _gather_rows_g(accel: Accel2G, obj):
    """The winners' ftab rows (B, GFT_COLS); misses read zeros."""
    hit = obj >= 0
    rows = accel.ftab[obj.clamp_min(0).long()]
    return torch.where(hit[:, None], rows, torch.zeros_like(rows))


def _winner_refine_g(rows, o, d, t_best, hit, omt=None):
    """Re-solve the winner from its gathered row in the dense intersector's
    form (rotate by R^T, divide by scale, type-selected primitive test) and
    derive the world normal (ellipsoid gradient; cuboid nearest face scanned
    +x -x +y -y +z -z with a strict first minimum).
    Returns (t_best, t_safe, p (B, 3), n (B, 3), local_pos (B, 3)) where
    ``local_pos`` is the unit-space hit position p_local / scale.  ``omt``
    (B,), given for a moving accel, shifts the centre to ``c - omt * dp``."""
    ce = rows[:, FT_CX:FT_CZ + 1]
    if omt is not None:
        ce = ce - omt[:, None] * rows[:, FT_DPX:FT_DPZ + 1]
    re = o - ce
    rex, rey, rez = re[:, 0], re[:, 1], re[:, 2]
    dx, dy, dz = d[:, 0], d[:, 1], d[:, 2]
    r = [rows[:, GFT_R00 + i] for i in range(9)]
    lox = r[0] * rex + r[3] * rey + r[6] * rez
    loy = r[1] * rex + r[4] * rey + r[7] * rez
    loz = r[2] * rex + r[5] * rey + r[8] * rez
    ldx = r[0] * dx + r[3] * dy + r[6] * dz
    ldy = r[1] * dx + r[4] * dy + r[7] * dz
    ldz = r[2] * dx + r[5] * dy + r[8] * dz
    sx, sy, sz = rows[:, GFT_SX], rows[:, GFT_SY], rows[:, GFT_SZ]
    one = torch.ones_like(sx)
    # misses gathered a zero row: keep their arithmetic finite
    gx_, gy_, gz_ = (torch.where(hit, v, one) for v in (sx, sy, sz))
    loc = (lox, loy, loz, ldx, ldy, ldz, gx_, gy_, gz_)
    is_ell = rows[:, GFT_TYPE] == _ELL
    t_ref = torch.where(is_ell, _ell_t_div(*loc), _cub_t_div(*loc))
    ok = hit & (t_ref < BIG_T)
    t_best = torch.where(ok, t_ref, t_best)
    t_safe = torch.where(hit, t_best, one)

    plx = lox + t_safe * ldx
    ply = loy + t_safe * ldy
    plz = loz + t_safe * ldz
    gx, gy, gz = plx / (gx_ * gx_), ply / (gy_ * gy_), plz / (gz_ * gz_)
    gn = torch.sqrt(torch.clamp_min(gx * gx + gy * gy + gz * gz, 1e-38))
    zero = torch.zeros_like(plx)
    best = (plx - 0.5 * sx).abs()
    cn = [one, zero, zero]
    for dist, vec in (
        ((plx + 0.5 * sx).abs(), (-1.0, 0.0, 0.0)),
        ((ply - 0.5 * sy).abs(), (0.0, 1.0, 0.0)),
        ((ply + 0.5 * sy).abs(), (0.0, -1.0, 0.0)),
        ((plz - 0.5 * sz).abs(), (0.0, 0.0, 1.0)),
        ((plz + 0.5 * sz).abs(), (0.0, 0.0, -1.0)),
    ):
        upd = dist < best
        best = torch.where(upd, dist, best)
        cn = [torch.where(upd, torch.full_like(c, v), c) for c, v in zip(cn, vec)]
    nlx = torch.where(is_ell, gx / gn, cn[0])
    nly = torch.where(is_ell, gy / gn, cn[1])
    nlz = torch.where(is_ell, gz / gn, cn[2])
    n = torch.stack([r[0] * nlx + r[1] * nly + r[2] * nlz,
                     r[3] * nlx + r[4] * nly + r[5] * nlz,
                     r[6] * nlx + r[7] * nly + r[8] * nlz], dim=1)
    p = o + t_safe[:, None] * d
    lp = torch.stack([plx / gx_, ply / gy_, plz / gz_], dim=1)
    return t_best, t_safe, p, n, lp


def _ri_probe_g(accel: Accel2G, q, omt=None):
    """Surrounding-RI containment sum at probe points q (B, 3) over the
    trailing dielectric-only probe rows: the rotated point-in-primitive test
    in the fused unit space (e = M (q - c); ellipsoid |e|^2 <= 1, cuboid all
    |e| <= 0.5).  Mean RI of the containing rows when their sum exceeds 1,
    else 1."""
    if accel.n_pgroups == 0:
        return torch.ones(q.shape[0], dtype=q.dtype, device=q.device)
    rows = accel.otab[accel.n_pad:]  # (Pp, GO_COLS)
    col = lambda c: rows[None, :, c]
    rx = q[:, 0:1] - col(GO_PX)
    ry = q[:, 1:2] - col(GO_PY)
    rz = q[:, 2:3] - col(GO_PZ)
    if accel.has_motion:  # the centre at the ray's time is c - omt * dp
        rx = rx + omt[:, None] * col(GO_DPX)
        ry = ry + omt[:, None] * col(GO_DPY)
        rz = rz + omt[:, None] * col(GO_DPZ)
    m = [col(GO_M00 + i) for i in range(9)]
    ex = m[0] * rx + m[1] * ry + m[2] * rz
    ey = m[3] * rx + m[4] * ry + m[5] * rz
    ez = m[6] * rx + m[7] * ry + m[8] * rz
    in_e = ex * ex + ey * ey + ez * ez <= 1.0
    in_c = (ex.abs() <= 0.5) & (ey.abs() <= 0.5) & (ez.abs() <= 0.5)
    typ = col(GO_TYPE)
    inside = (torch.where(typ == _ELL, in_e, (typ == _CUB) & in_c)
              & (col(GO_VALID) > 0.0))
    ri = col(GO_RI).expand_as(inside)
    acc = torch.sum(torch.where(inside, ri, torch.zeros_like(ri)), dim=1)
    cnt = torch.sum(inside.to(q.dtype), dim=1)
    return torch.where(acc > 1.0, acc / torch.clamp_min(cnt, 1.0), torch.ones_like(acc))


# ---------------------------------------------------------------------------
# Kernel wrapper
# ---------------------------------------------------------------------------


def check_accel_g(accel: Accel2G, device):
    """Raise unless the accel's tables are what the kernels take."""
    n_pad, G = accel.n_pad, accel.n_groups
    if accel.gr <= 0 or n_pad % accel.gr:
        raise ValueError(f"accel: {n_pad} rows are no multiple of gr={accel.gr}")
    if accel.n_sgroups not in (0, -(-G // SG)):
        raise ValueError(f"accel: {accel.n_sgroups} super-groups for {G} groups")
    if len(accel.gkinds) != G:
        raise ValueError(f"accel: {len(accel.gkinds)} kinds for {G} groups")
    f32 = torch.float32
    _check_tensor("accel.ftab", accel.ftab, f32, (n_pad, GFT_COLS), device)
    _check_tensor("accel.otab", accel.otab, f32,
                  (n_pad + accel.n_pgroups * PROBE_GR, GO_COLS), device)
    _check_tensor("accel.gaabb", accel.gaabb, f32,
                  (G + accel.n_pgroups + accel.n_sgroups, GA_COLS), device)


def _launch_sweep2g(accel: Accel2G, rays, stats=None, with_edge: bool = False):
    """Check the arguments and launch ``csrc/sweep2g.cu`` -> (t, obj), or
    with ``with_edge`` its silhouette instantiation -> (t, obj, edge)."""
    dev = rays.device
    if rays.dim() != 2:
        raise ValueError(f"rays: shape {tuple(rays.shape)}, expected (8, B)")
    B = rays.shape[1]
    _check_tensor("rays", rays, torch.float32, (8, B), dev)
    check_accel_g(accel, dev)
    if stats is not None:
        _check_tensor("stats", stats, torch.int64, (EC_LEN if with_edge else GC_LEN,), dev)
    _build.check_device(dev)
    fn = _build.load("sweep2g").rt_sweep2g
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, i, i, i, i, i, i, i, p, i, p, p, p, p, i, p, p]
        fn.restype = ctypes.c_int
    t = torch.empty((B,), dtype=torch.float32, device=dev)
    obj = torch.empty((B,), dtype=torch.int32, device=dev)
    edge = torch.empty((B,), dtype=torch.int32, device=dev) if with_edge else None
    eblk, n_super = None, 0
    if with_edge:  # the block table's module reads this one's layout
        from raytracing_tests_tpu_torch.kernels.edge_cull import edge_blocks

        eblk, n_super = edge_blocks(accel)
    code = fn(accel.otab.data_ptr(), accel.gaabb.data_ptr(), live_rows(accel).data_ptr(),
              accel.n_groups, accel.gr, accel.n_pgroups, PROBE_GR, accel.n_sgroups,
              int(accel.has_motion),
              _build.coop_min(COOP_MIN), rays.data_ptr(), B, t.data_ptr(),
              obj.data_ptr(), edge.data_ptr() if with_edge else None,
              eblk.data_ptr() if with_edge else None, n_super,
              stats.data_ptr() if stats is not None else None,
              _build.stream_of(dev))
    _build.check(code, "rt_sweep2g")
    if not with_edge:
        _build.LAUNCHES["sweep2g"] += 1
        return t, obj
    _build.LAUNCHES["sweep2g_m_edge" if accel.has_motion else "sweep2g_edge"] += 1
    return t, obj, edge


def _sweep2g(accel: Accel2G, rays, stats=None):
    """The sweep on ``rays`` (8, B) f32: (t, obj).

    CPU tensors go through ``sweep2g_plain``; CUDA tensors launch the kernel
    of ``csrc/sweep2g.cu`` on the current stream (or raise).  ``stats``:
    optional zeroed int64[GC_LEN] CUDA tensor that gains the work counters
    (``GC_*``; measurement only)."""
    if rays.device.type == "cpu":
        if accel.device.type != "cpu":
            raise ValueError("rays on the CPU but accel on " + str(accel.device))
        return sweep2g_plain(accel, rays)
    with torch.cuda.device(rays.device):
        return _launch_sweep2g(accel, rays, stats)


def _sweep2g_edge(accel: Accel2G, rays, stats=None):
    """The silhouette sweep on ``rays`` (8, B) f32: (t, obj, edge).

    CPU tensors go through ``sweep2g_edge_plain``; CUDA tensors launch the
    ``EDGE`` instantiation of ``csrc/sweep2g.cu`` (or raise), static or motion
    by ``accel.has_motion`` (counted as ``sweep2g_edge`` and
    ``sweep2g_m_edge``).  ``stats``: optional zeroed int64[EC_LEN] CUDA tensor
    that gains the nearest-hit counters (``GC_*``) and the silhouette walk's
    (``EC_*``; measurement only)."""
    if rays.device.type == "cpu":
        if accel.device.type != "cpu":
            raise ValueError("rays on the CPU but accel on " + str(accel.device))
        return sweep2g_edge_plain(accel, rays)
    with torch.cuda.device(rays.device):
        return _launch_sweep2g(accel, rays, stats, with_edge=True)


def sweep2g_nearest_edge(accel: Accel2G, o, d, time_ratio, t_limit):
    """(t, obj_sorted, edge_sorted): ``sweep2g_nearest`` and the near-miss
    silhouette candidate of the generic soft-edge gradient
    (``sweep2g_edge_plain``)."""
    return _sweep2g_edge(accel, pack_rays(o, d, time_ratio, t_limit))


def sweep2g_nearest(accel: Accel2G, o, d, time_ratio, t_limit):
    """(t, obj_sorted) nearest-hit sweep over the generic table
    (occlusion-grade, no fields) — the generic analogue of
    ``sweep2.sweep2_nearest``.  A miss gives obj = -1, t = min(BIG_T, t_limit)."""
    return _sweep2g(accel, pack_rays(o, d, time_ratio, t_limit))
