"""First-generation sweeps over one scene table: nearest hit, nearest hit with
the surrounding refractive index, the refractive-index containment sum and the
two-level grouped sweep, plus the host-side scene classification used by
``RenderConfig.for_scene``.

Counterpart of the JAX package's ``kernels/sweep.py``.  The scene is ONE
table with a row per object, in one of two modes chosen per scene:

  'spheres'  — isotropic ellipsoids: world-space quadratic.
  'generic'  — rotated ellipsoids/cuboids: inverse-rotation transform, then
               the primitive test of the row's type in the dense intersector's
               arithmetic (``intersect_brute`` semantics, safe inverse).

The kernels are hand-written CUDA (``csrc/sweep.cu``); beside each stands its
plain PyTorch version (``sweep_nearest_plain``, ``sweep_nearest_ri_plain``,
``sweep_ri_plain``, ``sweep_grouped_plain``).  A wrapper uses the plain version
only for tensors that lie on the CPU; for a CUDA tensor it launches the kernel
or raises.  The winner's material row and normal are fetched outside the
kernel (``_finish_hit``: an indexed load from ``hit_matrix``).

Tables are row-major with 16-byte-aligned rows; the fields and their order are
the JAX package's (``S_*`` / ``G_*`` / ``H_*``), which keeps them as (F, N).
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import numpy as np
import torch

from raytracing_tests_tpu_torch.core import geometry, linalg
from raytracing_tests_tpu_torch.kernels import _build
from raytracing_tests_tpu_torch.ops.intersect import Hit
from raytracing_tests_tpu_torch.scene.types import Scene

BIG_T = 3.0e38

# (N, S_COLS) scene-table columns, sphere mode.
S_CX, S_CY, S_CZ, S_R2, S_DPX, S_DPY, S_DPZ, S_VALID, S_RI = range(9)
SPHERE_ROWS = 9
S_COLS = 12  # three 16-byte loads per row

# Generic mode: position, rotation (row-major), scale, delta, type, valid, ri.
(
    G_PX, G_PY, G_PZ,
    G_R00, G_R01, G_R02, G_R10, G_R11, G_R12, G_R20, G_R21, G_R22,
    G_SX, G_SY, G_SZ,
    G_DPX, G_DPY, G_DPZ,
    G_TYPE, G_VALID, G_RI,
) = range(21)
GENERIC_ROWS = 21
G_COLS = 24  # six 16-byte loads per row

GB_COLS = 8  # group box row: lo xyz, hi xyz, 0 0

MODES = ("spheres", "generic")
_PLAIN_CHUNK = 16384  # rays per dense (rays x objects) block of the plain versions
# Work counters of the grouped kernel (csrc/sweep.cu SC_*): the rows up to the
# live bound of every group each lane entered, for the hit pass and the RI
# pass (the live rows: ``make_accel`` sorts dead rows last), then each pass's
# lane slots and row-parallel group visits (SIMT efficiency = rows / slots).
SC_ROWS, SC_RI_ROWS, SC_SLOTS, SC_COOP, SC_RI_SLOTS, SC_RI_COOP, SC_LEN = range(7)
# The grouped kernel sweeps a group row-parallel where fewer than this many
# lanes of a warp entered it (csrc/warp_sweep.cuh; ``_build.forced_coop_min``
# pins another for tests and measurement).  16 was the fastest over the grid
# canary and the bvh queue frame of the coop_min sweeps in PERF.md.
COOP_MIN = 16
# Threads one H100 SXM holds resident (132 SMs x 2048): the dense kernels
# split a ray (or a point) over more lanes until a batch fills them.
RESIDENT_THREADS = 132 * 2048
NRI_SPLITS = (1, 2, 4, 8)
# Work counters of the dense kernels (csrc/sweep.cu DC_*): rows pre-tested
# (every (live ray or point, row) pair visited), rows fully tested (those
# within the bounding sphere; every visited row where the sphere test is the
# whole test) and the lane slots of the full tests (SIMT efficiency = full /
# slots).
DC_PRE, DC_FULL, DC_SLOTS, DC_LEN = range(4)
# Columns of the generic rows' bounding spheres, the dense kernels' pre-test
# (``dense_bounds``: px py pz q | dpx dpy dpz mu; ``ri_rows`` puts each row's
# refractive index where mu stands).
B_Q, B_MU = 3, 7


def _np(x):
    return x.detach().cpu().numpy()


def scene_mode(scene: Scene) -> str:
    """'spheres' when every valid object is an isotropic ellipsoid and either
    untextured or unrotated (rotation only affects texture coordinates on an
    isotropic sphere)."""
    valid = _np(scene.valid)
    if not valid.any():
        return "generic"
    ot = _np(scene.obj_type)[valid]
    sc = _np(scene.scale)[valid]
    iso = np.allclose(sc, sc[:, :1])
    spheres = (ot == geometry.ELLIPSOID).all() and iso
    if not spheres:
        return "generic"
    if scene.textures is not None and (_np(scene.texture_index)[valid] > 0).any():
        rot = _np(scene.rotation)[valid]
        if not np.allclose(rot, np.eye(3), atol=1e-6):
            return "generic"
    return "spheres"


def scene_has_motion(scene: Scene) -> bool:
    """Any valid object with a nonzero motion delta."""
    dp = _np(scene.delta_position) * _np(scene.valid)[:, None]
    return bool((np.abs(dp) > 0).any())


@dataclasses.dataclass
class HitFields:
    """Per-lane material fields of the winning object."""

    color: torch.Tensor  # (B, 3)
    refractive_index: torch.Tensor  # (B,)
    refractivity: torch.Tensor
    reflectivity: torch.Tensor
    scatter_refract: torch.Tensor
    scatter_reflect: torch.Tensor
    texture_index: torch.Tensor  # (B,) i32
    emissive: torch.Tensor  # (B,) bool


# ---------------------------------------------------------------------------
# Scene table packing
# ---------------------------------------------------------------------------


def _mode_cols(mode: str) -> int:
    if mode not in MODES:
        raise ValueError(f"mode {mode!r}: expected one of {MODES}")
    return S_COLS if mode == "spheres" else G_COLS


def pack_scene_table(scene: Scene, mode: str):
    """Scene SoA -> (N, S_COLS | G_COLS) f32 table, a row per object."""
    v = scene.valid.to(torch.float32)
    dp = scene.delta_position
    if mode == "spheres":
        r = scene.scale[:, 0]
        cols = [scene.position[:, 0], scene.position[:, 1], scene.position[:, 2],
                r * r, dp[:, 0], dp[:, 1], dp[:, 2], v, scene.refractive_index]
    else:
        R = scene.rotation
        cols = [scene.position[:, 0], scene.position[:, 1], scene.position[:, 2],
                *[R[:, i, j] for i in range(3) for j in range(3)],
                scene.scale[:, 0], scene.scale[:, 1], scene.scale[:, 2],
                dp[:, 0], dp[:, 1], dp[:, 2],
                scene.obj_type.to(torch.float32), v, scene.refractive_index]
    table = torch.zeros((scene.capacity, _mode_cols(mode)), dtype=torch.float32,
                        device=scene.device)
    table[:, :len(cols)] = torch.stack(cols, dim=1)
    return table


# pack_hit_matrix column indices
(
    H_PX, H_PY, H_PZ, H_DPX, H_DPY, H_DPZ, H_SX, H_SY, H_SZ,
    H_CR, H_CG, H_CB, H_RI, H_REFR, H_REFL, H_SCRFR, H_SCRFL, H_TEX, H_EMIS,
    H_OBJ,
) = range(20)
H_R00 = 20  # generic-mode extras: rotation 20..28, type 29
H_TYPE = 29


def pack_hit_matrix(scene: Scene, mode: str):
    """(N, F) f32 matrix of every field shading needs after a hit."""
    f32 = torch.float32
    cols = [
        scene.position[:, 0], scene.position[:, 1], scene.position[:, 2],
        scene.delta_position[:, 0], scene.delta_position[:, 1], scene.delta_position[:, 2],
        scene.scale[:, 0], scene.scale[:, 1], scene.scale[:, 2],
        scene.color[:, 0], scene.color[:, 1], scene.color[:, 2],
        scene.refractive_index, scene.refractivity, scene.reflectivity,
        scene.scatter_refract, scene.scatter_reflect,
        scene.texture_index.to(f32), scene.emissive.to(f32),
        torch.arange(scene.capacity, dtype=f32, device=scene.device),  # original id
    ]
    if mode != "spheres":
        R = scene.rotation
        cols += [R[:, i, j] for i in range(3) for j in range(3)]
        cols += [scene.obj_type.to(f32)]
    return torch.stack(cols, dim=1)


@dataclasses.dataclass
class PallasAccel:
    """Packed scene table + hit matrix + optional group-culling data.  When
    ``group > 0`` the table rows are Morton-ordered and ``gaabb`` holds the
    per-group boxes; ``perm`` maps sorted positions back to original ids.
    (The name is the JAX package's, whose ``intersector="pallas"`` builds it.)"""

    table: torch.Tensor  # (N | Np, S_COLS | G_COLS)
    mode: str
    hit_matrix: Optional[torch.Tensor] = None  # (N | Np, F)
    gaabb: Optional[torch.Tensor] = None  # (G, GB_COLS)
    perm: Optional[torch.Tensor] = None  # (N,) i32
    group: int = 0
    has_motion: bool = True

    @property
    def device(self):
        return self.table.device

    def to(self, device):
        mv = lambda x: None if x is None else x.to(device)
        return dataclasses.replace(self, table=self.table.to(device),
                                   hit_matrix=mv(self.hit_matrix),
                                   gaabb=mv(self.gaabb), perm=mv(self.perm))


SCENE_PERM_FIELDS = (
    "position", "rotation", "scale", "delta_position", "obj_type", "color",
    "refractive_index", "refractivity", "reflectivity", "scatter_refract",
    "scatter_reflect", "texture_index", "emissive", "valid",
)


def make_accel(scene: Scene, mode: Optional[str] = None, group: int = 0,
               has_motion: bool = True) -> PallasAccel:
    """``group <= 0``: the scene's own row order, for the dense sweeps.  Else
    Morton-ordered groups of ``group`` rows (huge objects first, in their own
    always-entered groups) with per-group boxes, for the grouped sweep."""
    from raytracing_tests_tpu_torch.bvh.build import morton3d

    mode = mode or scene_mode(scene)
    if group <= 0:
        return PallasAccel(pack_scene_table(scene, mode), mode,
                           pack_hit_matrix(scene, mode))
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

    perm_scene = scene.replace(**{f: getattr(scene, f)[order] for f in SCENE_PERM_FIELDS})
    table = pack_scene_table(perm_scene, mode)
    hm = pack_hit_matrix(perm_scene, mode)
    hm[:, H_OBJ] = order.to(torch.float32)

    n = scene.capacity
    n_pad = -(-n // group) * group
    INF = 3.0e38
    vo = valid[order][:, None]
    lo_s = torch.where(vo, lo[order], torch.full_like(lo, INF))
    hi_s = torch.where(vo, hi[order], torch.full_like(hi, -INF))
    if n_pad != n:
        pad = n_pad - n
        table = torch.cat([table, torch.zeros((pad, table.shape[1]), device=dev)])
        hm = torch.cat([hm, torch.zeros((pad, hm.shape[1]), device=dev)])
        lo_s = torch.cat([lo_s, torch.full((pad, 3), INF, device=dev)])
        hi_s = torch.cat([hi_s, torch.full((pad, 3), -INF, device=dev)])
    G = n_pad // group
    gaabb = torch.zeros((G, GB_COLS), dtype=torch.float32, device=dev)
    gaabb[:, 0:3] = torch.amin(lo_s.reshape(G, group, 3), dim=1)
    gaabb[:, 3:6] = torch.amax(hi_s.reshape(G, group, 3), dim=1)
    return PallasAccel(table.contiguous(), mode, hm.contiguous(), gaabb,
                       order.to(torch.int32), group, has_motion)


# ---------------------------------------------------------------------------
# The plain PyTorch versions
# ---------------------------------------------------------------------------


def _where_big(cond, t):
    return torch.where(cond, t, torch.full_like(t, BIG_T))


def _ell_t_div(lox, loy, loz, ldx, ldy, ldz, sx, sy, sz):
    """Ellipsoid t in the dense intersector's divide-by-scale arithmetic."""
    ex, ey, ez = lox / sx, loy / sy, loz / sz
    fx, fy, fz = ldx / sx, ldy / sy, ldz / sz
    a = fx * fx + fy * fy + fz * fz
    half_b = ex * fx + ey * fy + ez * fz
    c = ex * ex + ey * ey + ez * ez - 1.0
    disc = half_b * half_b - a * c
    ok = (disc > 0.0) & (a > 1e-30)
    a_safe = torch.where(ok, a, torch.ones_like(a))
    sq = torch.sqrt(torch.where(ok, disc, torch.ones_like(disc)))
    t0 = (-half_b - sq) / a_safe
    t1 = (-half_b + sq) / a_safe
    t_e = torch.where((t0 > t1) | (t0 < 0.0), t1, t0)
    return _where_big(ok & (t_e > 0.0), t_e)


def _slab_t(axes):
    """[(u, w)] x3 -> entry t (exit t from inside) or BIG.  ``torch.minimum``
    and ``torch.maximum`` carry a NaN into ``tmax > tmin`` = False."""
    (u1, w1), (u2, w2), (u3, w3) = axes
    tmin = torch.maximum(torch.maximum(torch.minimum(u1, w1), torch.minimum(u2, w2)),
                         torch.minimum(u3, w3))
    tmax = torch.minimum(torch.minimum(torch.maximum(u1, w1), torch.maximum(u2, w2)),
                         torch.maximum(u3, w3))
    t_c = _where_big(tmax > tmin, torch.where(tmin > 0.0, tmin, tmax))
    return _where_big(t_c > 0.0, t_c)


def _cub_t_div(lox, loy, loz, ldx, ldy, ldz, sx, sy, sz):
    """Cuboid slab t with the safe inverse (zero components become +-1e-12)."""
    def axis(lo, ld, s):
        inv = geometry._safe_inv(ld)
        return (-0.5 * s - lo) * inv, (0.5 * s - lo) * inv

    return _slab_t([axis(lox, ldx, sx), axis(loy, ldy, sy), axis(loz, ldz, sz)])


def _ray_cols(rays):
    """(8, B) -> eight (B, 1) columns ox oy oz dx dy dz omt tlim."""
    return [rays[k][:, None] for k in range(8)]


def _dir_a(dx, dy, dz):
    return torch.clamp_min(dx * dx + dy * dy + dz * dz, 1e-30)  # dead lanes carry d = 0


def _sphere_root(rx, ry, rz, dx, dy, dz, r2, a, valid):
    half_b = rx * dx + ry * dy + rz * dz
    c = rx * rx + ry * ry + rz * rz - r2
    disc = half_b * half_b - a * c
    ok = disc > 0.0
    sq = torch.sqrt(torch.clamp_min(disc, 0.0))
    inv_a = 1.0 / a
    t0 = (-half_b - sq) * inv_a
    t1 = (-half_b + sq) * inv_a
    t = torch.where((t0 > t1) | (t0 < 0.0), t1, t0)
    return _where_big(ok & (t > 0.0) & (valid > 0.0), t)


def _sphere_t(rows, ox, oy, oz, dx, dy, dz, omt, a):
    """Dense-sweep form: the shift is added to the relative origin."""
    col = lambda c: rows[None, :, c]
    rx = ox - col(S_CX) + omt * col(S_DPX)
    ry = oy - col(S_CY) + omt * col(S_DPY)
    rz = oz - col(S_CZ) + omt * col(S_DPZ)
    return _sphere_root(rx, ry, rz, dx, dy, dz, col(S_R2), a, col(S_VALID))


def _sphere_t_centre(rows, ox, oy, oz, dx, dy, dz, omt, a):
    """Fused / grouped form: the centre is shifted first -> (t, cx, cy, cz)."""
    col = lambda c: rows[None, :, c]
    cx = col(S_CX) - omt * col(S_DPX)
    cy = col(S_CY) - omt * col(S_DPY)
    cz = col(S_CZ) - omt * col(S_DPZ)
    t = _sphere_root(ox - cx, oy - cy, oz - cz, dx, dy, dz, col(S_R2), a, col(S_VALID))
    return t, cx, cy, cz


def _generic_local(rows, x, y, z, omt):
    """R^T (point - position + omt * delta) for rows (K, G_COLS) x points (B, 1)."""
    col = lambda c: rows[None, :, c]
    rx = x - col(G_PX) + omt * col(G_DPX)
    ry = y - col(G_PY) + omt * col(G_DPY)
    rz = z - col(G_PZ) + omt * col(G_DPZ)
    return (col(G_R00) * rx + col(G_R10) * ry + col(G_R20) * rz,
            col(G_R01) * rx + col(G_R11) * ry + col(G_R21) * rz,
            col(G_R02) * rx + col(G_R12) * ry + col(G_R22) * rz)


def _generic_t(rows, ox, oy, oz, dx, dy, dz, omt):
    """``intersect_brute`` per-object semantics: R^T transform, then both
    primitive tests selected by type."""
    col = lambda c: rows[None, :, c]
    lox, loy, loz = _generic_local(rows, ox, oy, oz, omt)
    ldx = col(G_R00) * dx + col(G_R10) * dy + col(G_R20) * dz
    ldy = col(G_R01) * dx + col(G_R11) * dy + col(G_R21) * dz
    ldz = col(G_R02) * dx + col(G_R12) * dy + col(G_R22) * dz
    valid = col(G_VALID) > 0.0
    # dead rows may carry zero scale: keep their (masked) arithmetic finite
    sx, sy, sz = (torch.where(valid, col(c), torch.ones_like(col(c)))
                  for c in (G_SX, G_SY, G_SZ))
    loc = (lox, loy, loz, ldx, ldy, ldz, sx, sy, sz)
    typ = col(G_TYPE)
    t = torch.where(typ == float(geometry.ELLIPSOID), _ell_t_div(*loc),
                    _where_big(typ == float(geometry.CUBOID), _cub_t_div(*loc)))
    return _where_big(valid, t)


def _contains(rows, mode: str, qx, qy, qz, omt):
    """(B, K) bool: is the (motion-shifted) point inside the row's primitive."""
    col = lambda c: rows[None, :, c]
    if mode == "spheres":
        rx = qx - col(S_CX) + omt * col(S_DPX)
        ry = qy - col(S_CY) + omt * col(S_DPY)
        rz = qz - col(S_CZ) + omt * col(S_DPZ)
        return (rx * rx + ry * ry + rz * rz <= col(S_R2)) & (col(S_VALID) > 0.0)
    valid = col(G_VALID) > 0.0
    lx, ly, lz = _generic_local(rows, qx, qy, qz, omt)
    sx, sy, sz = (torch.where(valid, col(c), torch.ones_like(col(c)))
                  for c in (G_SX, G_SY, G_SZ))
    lx, ly, lz = lx / sx, ly / sy, lz / sz
    in_e = lx * lx + ly * ly + lz * lz <= 1.0
    in_c = (lx.abs() <= 0.5) & (ly.abs() <= 0.5) & (lz.abs() <= 0.5)
    typ = col(G_TYPE)
    return torch.where(typ == float(geometry.ELLIPSOID), in_e,
                       (typ == float(geometry.CUBOID)) & in_c) & valid


def _ri_col(mode: str) -> int:
    return S_RI if mode == "spheres" else G_RI


def _mean_ri(acc, cnt):
    return torch.where(acc > 1.0, acc / torch.clamp_min(cnt, 1.0), torch.ones_like(acc))


def _sum_ri(inside, ri, acc=None):
    """The contained rows' RI added onto ``acc`` (default 0) one row at a
    time in ascending row order, as the JAX package's loops and the kernels
    add them (a reduction in another order differs in the last bits where a
    point lies in three or more rows), and their count -> (acc, cnt)."""
    ri = ri.expand_as(inside)
    rank = torch.cumsum(inside.to(torch.int32), dim=1)
    cnt = rank[:, -1] if inside.shape[1] else torch.zeros(
        inside.shape[0], dtype=torch.int32, device=inside.device)
    if acc is None:
        acc = torch.zeros(inside.shape[0], dtype=torch.float32, device=inside.device)
    zero = torch.zeros_like(ri)
    for k in range(1, int(cnt.max()) + 1 if cnt.numel() else 1):
        # the k-th contained row's RI: the only nonzero term of its sum
        acc = acc + torch.sum(torch.where(inside & (rank == k), ri, zero), dim=1)
    return acc, cnt.to(torch.float32)


def _ri_query_point(o, d, t, bc):
    """The query point of the fused sweeps: 1e-3 along unit(hit - centre)."""
    p = o + t[:, None] * d
    n = p - bc
    inv_n = torch.rsqrt(torch.clamp_min(torch.sum(n * n, dim=1, keepdim=True), 1e-30))
    return p + 1e-3 * n * inv_n


def _first_min(t):
    """(min, first index of the min) along dim 1."""
    t_min = torch.amin(t, dim=1)
    idx = torch.arange(t.shape[1], device=t.device).expand_as(t)
    first = torch.amin(torch.where(t == t_min[:, None], idx, t.shape[1]), dim=1)
    return t_min, first


def _in_chunks(fn, rays, n_out: int):
    """``fn`` on ray ranges of ``_PLAIN_CHUNK`` (bounds the dense blocks)."""
    B = rays.shape[1]
    if B <= _PLAIN_CHUNK:
        return fn(rays)
    parts = [fn(rays[:, b0:b0 + _PLAIN_CHUNK]) for b0 in range(0, B, _PLAIN_CHUNK)]
    return tuple(torch.cat([p[k] for p in parts]) for k in range(n_out))


def _nearest_chunk(table, mode, rays, with_ri):
    ox, oy, oz, dx, dy, dz, omt, tlim = _ray_cols(rays)
    a = _dir_a(dx, dy, dz)
    if mode == "spheres" and with_ri:
        tc, cx, cy, cz = _sphere_t_centre(table, ox, oy, oz, dx, dy, dz, omt, a)
    elif mode == "spheres":
        tc = _sphere_t(table, ox, oy, oz, dx, dy, dz, omt, a)
    else:
        tc = _generic_t(table, ox, oy, oz, dx, dy, dz, omt)
    limit0 = torch.clamp_max(tlim[:, 0], BIG_T)
    t_min, first = _first_min(tc)
    hit = t_min < limit0
    t_best = torch.where(hit, t_min, limit0)
    obj = torch.where(hit, first, torch.full_like(first, -1)).to(torch.int32)
    if not with_ri:
        return t_best, obj
    pick = first[:, None]
    zero = torch.zeros_like(t_best)
    bc = torch.stack([torch.where(hit, torch.gather(c.expand_as(tc), 1, pick)[:, 0], zero)
                      for c in (cx, cy, cz)], dim=1)
    q = _ri_query_point(rays[0:3].T, rays[3:6].T, t_best, bc)
    inside = _contains(table, mode, q[:, 0:1], q[:, 1:2], q[:, 2:3], omt)
    return t_best, obj, _mean_ri(*_sum_ri(inside, table[None, :, S_RI]))


def sweep_nearest_plain(table, mode: str, rays):
    """Plain version of the dense nearest-hit kernel: ``rays`` (8, B) ->
    (t, obj i32); ties keep the lower row; a miss gives obj = -1 and
    t = min(BIG_T, tlim)."""
    return _in_chunks(lambda r: _nearest_chunk(table, mode, r, False), rays, 2)


def sweep_nearest_ri_plain(table, rays):
    """Plain version of the fused sphere-mode kernel: (t, obj, surrounding RI
    1e-3 outside the hit point; every containing row counts)."""
    return _in_chunks(lambda r: _nearest_chunk(table, "spheres", r, True), rays, 3)


def sweep_ri_plain(table, mode: str, pts):
    """Plain version of the refractive-index kernel: ``pts`` (4, B) rows px py
    pz omt -> mean RI of the containing rows whose RI is not 1 (those are
    air), when their sum exceeds 1, else 1."""
    def chunk(p):
        inside = _contains(table, mode, p[0][:, None], p[1][:, None], p[2][:, None],
                           p[3][:, None])
        ri = table[None, :, _ri_col(mode)]
        return (_mean_ri(*_sum_ri(inside & (ri != 1.0), ri)),)

    return _in_chunks(chunk, pts, 1)[0]


def sweep_grouped_plain(table, gaabb, rays, group: int, with_ri: bool, mode: str):
    """Plain version of the grouped kernel -> (t, obj_sorted, ri): the groups
    in table order, each behind every ray's own box test against its current
    best t — what one thread of the kernel does, for all rays at once (the
    rays that enter a group are gathered).  ``with_ri`` (sphere mode) adds the
    fused RI pass over the groups whose box holds the query point."""
    if with_ri and mode != "spheres":
        raise ValueError("the fused RI pass exists in sphere mode only")
    B = rays.shape[1]
    dev = rays.device
    o, d = rays[0:3].T.contiguous(), rays[3:6].T.contiguous()
    omt = rays[6]
    inv = geometry._safe_inv(d)
    a = _dir_a(d[:, 0], d[:, 1], d[:, 2])
    t_best = torch.clamp_max(rays[7], BIG_T).clone()
    obj = torch.full((B,), -1, dtype=torch.int32, device=dev)
    bc = torch.zeros((B, 3), dtype=torch.float32, device=dev)
    G = gaabb.shape[0]
    for g in range(G):
        u = (gaabb[g, 0:3] - o) * inv
        w = (gaabb[g, 3:6] - o) * inv
        tmin = torch.amax(torch.minimum(u, w), dim=-1)
        tmax = torch.amin(torch.maximum(u, w), dim=-1)
        sel = torch.nonzero((tmax > tmin) & (tmin < t_best))[:, 0]
        if sel.numel() == 0:
            continue
        rows = table[g * group:(g + 1) * group]
        so, sd = o[sel], d[sel]
        cols = [so[:, 0:1], so[:, 1:2], so[:, 2:3], sd[:, 0:1], sd[:, 1:2], sd[:, 2:3],
                omt[sel][:, None]]
        if mode == "spheres":
            tc, cx, cy, cz = _sphere_t_centre(rows, *cols, a[sel][:, None])
        else:
            tc = _generic_t(rows, *cols)
        gmin, first = _first_min(tc)
        better = gmin < t_best[sel]  # ties keep the lower row
        upd = sel[better]
        t_best[upd] = gmin[better]
        obj[upd] = (g * group + first[better]).to(torch.int32)
        if mode == "spheres":
            pick = first[better][:, None]
            bc[upd] = torch.stack([torch.gather(c.expand_as(tc)[better], 1, pick)[:, 0]
                                   for c in (cx, cy, cz)], dim=1)
    ri = torch.ones(B, dtype=torch.float32, device=dev)
    if with_ri:
        q = _ri_query_point(o, d, t_best, bc)
        acc = torch.zeros(B, dtype=torch.float32, device=dev)
        cnt = torch.zeros(B, dtype=torch.float32, device=dev)
        for g in range(G):
            in_box = torch.all((q >= gaabb[g, 0:3]) & (q <= gaabb[g, 3:6]), dim=1)
            sel = torch.nonzero(in_box)[:, 0]
            if sel.numel() == 0:
                continue
            rows = table[g * group:(g + 1) * group]
            sq = q[sel]
            inside = _contains(rows, mode, sq[:, 0:1], sq[:, 1:2], sq[:, 2:3],
                               omt[sel][:, None])
            acc[sel], dc = _sum_ri(inside, rows[None, :, S_RI], acc[sel])
            cnt[sel] += dc
        ri = _mean_ri(acc, cnt)
    return t_best, obj, ri


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def _check_tensor(name, x, dtype, shape, device):
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(x).__name__}")
    if x.device != device:
        raise ValueError(f"{name}: on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name}: dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(x.shape)}, expected {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def _check_table(table, mode: str, device):
    if table.dim() != 2:
        raise ValueError(f"table: shape {tuple(table.shape)}, expected (N, {_mode_cols(mode)})")
    _check_tensor("table", table, torch.float32, (table.shape[0], _mode_cols(mode)), device)


def _check_rays(rays, rows: int):
    if rays.dim() != 2:
        raise ValueError(f"rays: shape {tuple(rays.shape)}, expected ({rows}, B)")
    _check_tensor("rays", rays, torch.float32, (rows, rays.shape[1]), rays.device)
    return rays.shape[1]


def _fn(name: str, argtypes, device):
    _build.check_device(device)
    fn = getattr(_build.load("sweep"), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


_P, _I = ctypes.c_void_p, ctypes.c_int


def _on_cpu(rays, table) -> bool:
    if rays.device.type != "cpu":
        return False
    if table.device.type != "cpu":
        raise ValueError("rays on the CPU but the table on " + str(table.device))
    return True


def nearest_ri_split(B: int, resident: int = RESIDENT_THREADS) -> int:
    """Lanes per ray (or point) of the dense kernels: the least K of
    ``NRI_SPLITS`` with ``B * K >= resident``, else the largest."""
    return next((k for k in NRI_SPLITS if B * k >= resident), NRI_SPLITS[-1])


def _split_of(B: int, device, split: Optional[int]) -> int:
    """``split`` (one of ``NRI_SPLITS``), by default ``nearest_ri_split(B)``
    (1 in the host rehearsal, whose warp is one lane); every split gives the
    same outputs."""
    if split is None:
        split = nearest_ri_split(B) if device.type == "cuda" else 1
    if split not in NRI_SPLITS:
        raise ValueError(f"split={split}: expected one of {NRI_SPLITS}")
    return split


def _memo(table, attr: str, extra: tuple, fn):
    """``fn()``, computed once per table: kept on the tensor under ``attr``
    and renewed when another table takes its memory or it is written in
    place."""
    key = (table.data_ptr(), table._version, *extra)
    memo = getattr(table, attr, None)
    if memo is None or memo[0] != key:
        memo = (key, fn())
        setattr(table, attr, memo)
    return memo[1]


def _dense_bounds(table):
    """(N, 8) f32 bounding spheres of a generic table's rows for the dense
    kernels' pre-test (csrc/sweep.cu cull_margin_note): px py pz, q, the dp
    row, mu.  rb = max|s| (ellipsoid) or |s| / 2 (cuboid) over sigma_min(R)
    holds the primitive; kappa = (max|s| / min|s|) (sigma_max(R) /
    sigma_min(R)); q = (rb (1 + 2^-9))^2 (1 + 2^-16 kappa), mu = min(2^-15
    kappa^3, 1).  Dead rows have q = -inf, mu = 0 (always rejected); rows with
    sigma_min(R) < 1/2 or a zero or non-finite scale q = inf, mu = 1 (never
    rejected).  Float64 on the host."""
    t = table.detach().to("cpu", torch.float64)
    rot = t[:, G_R00:G_R22 + 1].reshape(-1, 3, 3)
    s = t[:, G_SX:G_SZ + 1].abs()
    sv = torch.linalg.svdvals(rot)
    s_max, s_min, sig_min = s.amax(dim=1), s.amin(dim=1), sv[:, 2]
    ell = t[:, G_TYPE] == float(geometry.ELLIPSOID)
    rb = torch.where(ell, s_max, 0.5 * torch.linalg.vector_norm(s, dim=1)) / sig_min
    kappa = s_max / s_min * sv[:, 0] / sig_min
    q = (rb * (1.0 + 2.0 ** -9)) ** 2 * (1.0 + 2.0 ** -16 * kappa)
    mu = torch.clamp_max(2.0 ** -15 * kappa ** 3, 1.0)
    never = (sig_min < 0.5) | ~torch.isfinite(q) | ~torch.isfinite(mu) | (s_min == 0.0)
    q = torch.where(never, torch.full_like(q, float("inf")), q)
    mu = torch.where(never, torch.ones_like(mu), mu)
    live = t[:, G_VALID] > 0.0
    q = torch.where(live, q, torch.full_like(q, -float("inf")))
    mu = torch.where(live, mu, torch.zeros_like(mu))
    cols = [t[:, G_PX], t[:, G_PY], t[:, G_PZ], q, t[:, G_DPX], t[:, G_DPY], t[:, G_DPZ], mu]
    return torch.stack(cols, dim=1).to(table.device, torch.float32).contiguous()


def dense_bounds(table):
    """``_dense_bounds``, computed once per table."""
    return _memo(table, "_rt_dense_bounds", (), lambda: _dense_bounds(table))


def _ri_rows(table, mode: str):
    """The rows the RI sum walks: those that are valid and whose refractive
    index is not 1, the others being dead or air -> (index (M,) int32 in
    ascending order, staged rows: their (M, S_COLS) copies in sphere mode,
    their ``dense_bounds`` with the RI in column B_MU in generic mode)."""
    ri = table[:, _ri_col(mode)]
    keep = (table[:, S_VALID if mode == "spheres" else G_VALID] > 0.0) & (ri != 1.0)
    index = torch.nonzero(keep)[:, 0]
    if mode == "spheres":
        staged = table[index]
    else:
        staged = dense_bounds(table)[index]
        staged[:, B_MU] = ri[index]
    return index.to(torch.int32).contiguous(), staged.contiguous()


def ri_rows(table, mode: str):
    """``_ri_rows``, computed once per table."""
    return _memo(table, "_rt_ri_rows", (mode,), lambda: _ri_rows(table, mode))


def _stats_ptr(stats, n: int, device):
    if stats is None:
        return None
    _check_tensor("stats", stats, torch.int64, (n,), device)
    return stats.data_ptr()


def _launch_nearest(table, mode: str, rays, split: Optional[int] = None, stats=None):
    """The dense nearest hit: ``split`` lanes a ray (``_split_of``); ``stats``:
    optional zeroed int64[DC_LEN] that gains the counters ``DC_*``
    (measurement only).  Generic tables are culled behind ``dense_bounds``."""
    dev = rays.device
    B = _check_rays(rays, 8)
    _check_table(table, mode, dev)
    split = _split_of(B, dev, split)
    st = _stats_ptr(stats, DC_LEN, dev)
    fn = _fn("rt_sweep_nearest", [_P, _I, _I, _P, _I, _P, _I, _P, _P, _P, _P], dev)
    bounds = dense_bounds(table) if mode == "generic" else None
    t = torch.empty((B,), dtype=torch.float32, device=dev)
    obj = torch.empty((B,), dtype=torch.int32, device=dev)
    code = fn(table.data_ptr(), table.shape[0], MODES.index(mode),
              None if bounds is None else bounds.data_ptr(), split, rays.data_ptr(), B,
              t.data_ptr(), obj.data_ptr(), st, _build.stream_of(dev))
    _build.check(code, "rt_sweep_nearest")
    _build.LAUNCHES["sweep_nearest"] += 1
    return t, obj


def _launch_nearest_ri(table, rays, split: Optional[int] = None):
    """``split``: lanes per ray (``_split_of``)."""
    dev = rays.device
    B = _check_rays(rays, 8)
    _check_table(table, "spheres", dev)
    split = _split_of(B, dev, split)
    t = torch.empty((B,), dtype=torch.float32, device=dev)
    obj = torch.empty((B,), dtype=torch.int32, device=dev)
    ri = torch.empty((B,), dtype=torch.float32, device=dev)
    code = _fn("rt_sweep_nearest_ri", [_P, _I, _I, _P, _I, _P, _P, _P, _P], dev)(
        table.data_ptr(), table.shape[0], split, rays.data_ptr(), B, t.data_ptr(),
        obj.data_ptr(), ri.data_ptr(), _build.stream_of(dev))
    _build.check(code, "rt_sweep_nearest_ri")
    _build.LAUNCHES["sweep_nearest_ri"] += 1
    return t, obj, ri


def _launch_ri(table, mode: str, pts, split: Optional[int] = None, stats=None):
    """The RI sum at ``pts`` over ``ri_rows(table, mode)``; ``split`` and
    ``stats`` as ``_launch_nearest``'s."""
    dev = pts.device
    B = _check_rays(pts, 4)
    _check_table(table, mode, dev)
    split = _split_of(B, dev, split)
    st = _stats_ptr(stats, DC_LEN, dev)
    fn = _fn("rt_sweep_ri", [_P, _I, _I, _P, _P, _I, _I, _P, _I, _P, _P, _P], dev)
    index, staged = ri_rows(table, mode)
    ri = torch.empty((B,), dtype=torch.float32, device=dev)
    code = fn(table.data_ptr(), table.shape[0], MODES.index(mode), index.data_ptr(),
              staged.data_ptr(), index.shape[0], split, pts.data_ptr(), B, ri.data_ptr(), st,
              _build.stream_of(dev))
    _build.check(code, "rt_sweep_ri")
    _build.LAUNCHES["sweep_ri"] += 1
    return ri


def grouped_live_row_bounds(table, group: int, mode: str):
    """(G,) int32: each group's last live row + 1 (0 for a group without one)."""
    live = table[:, S_VALID if mode == "spheres" else G_VALID] > 0.0
    pos = torch.arange(1, group + 1, dtype=torch.int32, device=table.device)
    return (live.reshape(-1, group).to(torch.int32) * pos).amax(dim=1)


def grouped_live_rows(table, group: int, mode: str):
    """``grouped_live_row_bounds``, computed once per table."""
    return _memo(table, "_rt_live_rows", (group, mode),
                 lambda: grouped_live_row_bounds(table, group, mode))


def _launch_grouped(table, gaabb, rays, group: int, with_ri: bool, mode: str, stats=None):
    dev = rays.device
    B = _check_rays(rays, 8)
    _check_table(table, mode, dev)
    if group <= 0 or table.shape[0] % group:
        raise ValueError(f"table: {table.shape[0]} rows are no multiple of group={group}")
    G = table.shape[0] // group
    _check_tensor("gaabb", gaabb, torch.float32, (G, GB_COLS), dev)
    if with_ri and mode != "spheres":
        raise ValueError("the fused RI pass exists in sphere mode only")
    st = _stats_ptr(stats, SC_LEN, dev)
    t = torch.empty((B,), dtype=torch.float32, device=dev)
    obj = torch.empty((B,), dtype=torch.int32, device=dev)
    ri = torch.empty((B,), dtype=torch.float32, device=dev)
    live = grouped_live_rows(table, group, mode)
    code = _fn("rt_sweep_grouped",
               [_P, _P, _P, _I, _I, _I, _I, _I, _P, _I, _P, _P, _P, _P, _P], dev)(
        table.data_ptr(), gaabb.data_ptr(), live.data_ptr(), G, group, MODES.index(mode),
        int(with_ri), _build.coop_min(COOP_MIN), rays.data_ptr(), B, t.data_ptr(),
        obj.data_ptr(), ri.data_ptr(), st, _build.stream_of(dev))
    _build.check(code, "rt_sweep_grouped")
    _build.LAUNCHES["sweep_grouped"] += 1
    return t, obj, ri


def pack_rays(o, d, time_ratio, t_limit):
    """(B, 3) x2 + (B,) x2 -> (8, B) ray matrix: ox oy oz dx dy dz omt tlim."""
    return torch.stack([
        o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2],
        1.0 - time_ratio, t_limit,
    ]).contiguous()


def sweep_nearest(table, mode: str, o, d, time_ratio, t_limit):
    """(t, obj) of the nearest hit per ray; table from ``pack_scene_table``.
    CPU tensors run the plain version; CUDA tensors launch ``csrc/sweep.cu``."""
    rays = pack_rays(o, d, time_ratio, t_limit)
    if _on_cpu(rays, table):
        return sweep_nearest_plain(table, mode, rays)
    with torch.cuda.device(rays.device):
        return _launch_nearest(table, mode, rays)


def sweep_nearest_ri(table, o, d, time_ratio, t_limit):
    """Fused sphere-mode sweep: (t, obj, surrounding_ri) in one kernel."""
    rays = pack_rays(o, d, time_ratio, t_limit)
    if _on_cpu(rays, table):
        return sweep_nearest_ri_plain(table, rays)
    with torch.cuda.device(rays.device):
        return _launch_nearest_ri(table, rays)


def _sweep_grouped(table, gaabb, rays, group: int, with_ri: bool, mode: str, stats=None):
    """The grouped sweep on a ray matrix (8, B).  ``stats``: optional zeroed
    int64[SC_LEN] CUDA tensor that gains the work counters ``SC_*``
    (measurement only)."""
    if _on_cpu(rays, table):
        return sweep_grouped_plain(table, gaabb, rays, group, with_ri, mode)
    with torch.cuda.device(rays.device):
        return _launch_grouped(table, gaabb, rays, group, with_ri, mode, stats=stats)


def sweep_grouped(table, gaabb, o, d, time_ratio, t_limit, group: int,
                  with_ri: bool, mode: str = "spheres"):
    """Grouped two-level sweep -> (t, obj_sorted, ri).  The motion terms are
    always computed (three multiply-adds per row, exact zeros on a static
    scene), so there is no ``has_motion`` switch."""
    return _sweep_grouped(table, gaabb, pack_rays(o, d, time_ratio, t_limit), group,
                          with_ri, mode)


def sweep_ri(table, mode: str, point, time_ratio):
    """Surrounding refractive index at ``point`` (B, 3)."""
    pts = torch.stack([point[:, 0], point[:, 1], point[:, 2], 1.0 - time_ratio]).contiguous()
    if _on_cpu(pts, table):
        return sweep_ri_plain(table, mode, pts)
    with torch.cuda.device(pts.device):
        return _launch_ri(table, mode, pts)


def _sweep_dispatch(accel: PallasAccel, o, d, time_ratio, t_limit, with_ri: bool):
    """(t, obj_sorted_or_plain, ri_or_None) across kernel variants."""
    if accel.group and accel.gaabb is not None:
        fused_ri = with_ri and accel.mode == "spheres"
        t, obj, ri = sweep_grouped(
            accel.table, accel.gaabb, o, d, time_ratio, t_limit, accel.group,
            fused_ri, mode=accel.mode)
        return t, obj, (ri if fused_ri else None)
    if with_ri and accel.mode == "spheres":
        return sweep_nearest_ri(accel.table, o, d, time_ratio, t_limit)
    t, obj = sweep_nearest(accel.table, accel.mode, o, d, time_ratio, t_limit)
    return t, obj, None


# ---------------------------------------------------------------------------
# intersect-module-compatible entry points
# ---------------------------------------------------------------------------


def _finish_hit(accel: PallasAccel, o, d, time_ratio, t, obj):
    """Winner ids -> (Hit, HitFields): one indexed load of the winner's row
    from ``hit_matrix``, then its normal and unit-space hit position."""
    hit = obj >= 0
    t_safe = torch.where(hit, t, torch.ones_like(t))
    rows = accel.hit_matrix[obj.clamp_min(0).long()]  # (B, F)
    pos = rows[:, H_PX:H_PZ + 1]
    dp = rows[:, H_DPX:H_DPZ + 1]
    scale = rows[:, H_SX:H_SZ + 1]
    rel = o - pos + (1.0 - time_ratio)[:, None] * dp

    if accel.mode == "spheres":
        p_rel = rel + t_safe[:, None] * d  # hit point relative to the moved centre
        n_world = linalg.normalize(p_rel)
        p_local = p_rel / scale[:, 0:1]
    else:
        R = rows[:, H_R00:H_R00 + 9].reshape(-1, 3, 3)
        otype = rows[:, H_TYPE].to(torch.int32)
        lo = linalg.apply_rotation_t(R, rel)
        ld = linalg.apply_rotation_t(R, d)
        p_loc = lo + t_safe[:, None] * ld
        n_local = geometry.primitive_normal(p_loc, scale, otype)
        n_world = linalg.apply_rotation(R, n_local)
        p_local = p_loc / scale

    fields = HitFields(
        color=rows[:, H_CR:H_CB + 1],
        refractive_index=rows[:, H_RI],
        refractivity=rows[:, H_REFR],
        reflectivity=rows[:, H_REFL],
        scatter_refract=rows[:, H_SCRFR],
        scatter_reflect=rows[:, H_SCRFL],
        texture_index=rows[:, H_TEX].to(torch.int32),
        emissive=rows[:, H_EMIS] > 0.5,
    )
    h = Hit(t=t_safe, obj=rows[:, H_OBJ].to(torch.int32), hit=hit, normal=n_world,
            local_pos=p_local)
    return h, fields


def intersect_pallas_full(accel: PallasAccel, scene: Scene, o, d, time_ratio, t_limit):
    """Sweep + winner row -> (Hit, HitFields); the Hit matches
    ``intersect_brute``."""
    t, obj, _ = _sweep_dispatch(accel, o, d, time_ratio, t_limit, with_ri=False)
    return _finish_hit(accel, o, d, time_ratio, t, obj)


def intersect_pallas(accel: PallasAccel, scene: Scene, o, d, time_ratio, t_limit) -> Hit:
    """Same Hit contract as ``intersect_brute``."""
    return intersect_pallas_full(accel, scene, o, d, time_ratio, t_limit)[0]


def intersect_pallas_fused(accel: PallasAccel, scene: Scene, o, d, time_ratio, t_limit):
    """(Hit, HitFields, surrounding_ri) — one fused kernel in sphere mode,
    separate sweeps otherwise."""
    if accel.mode != "spheres":
        hit, flds = intersect_pallas_full(accel, scene, o, d, time_ratio, t_limit)
        hp = o + hit.t[:, None] * d
        ri = surrounding_ri_pallas(accel, scene, hp + 1e-3 * hit.normal, time_ratio)
        return hit, flds, ri
    t, obj, ri = _sweep_dispatch(accel, o, d, time_ratio, t_limit, with_ri=True)
    hit, flds = _finish_hit(accel, o, d, time_ratio, t, obj)
    return hit, flds, ri


def occluded_nearest_obj_pallas(accel: PallasAccel, scene: Scene, o, d, time_ratio, t_limit):
    """Original id of the nearest hit (-1 on a miss)."""
    _, obj, _ = _sweep_dispatch(accel, o, d, time_ratio, t_limit, with_ri=False)
    if accel.perm is not None:
        obj = torch.where(obj >= 0, accel.perm[obj.clamp_min(0).long()],
                          torch.full_like(obj, -1))
    return obj


def surrounding_ri_pallas(accel: PallasAccel, scene: Scene, point, time_ratio):
    return sweep_ri(accel.table, accel.mode, point, time_ratio)
