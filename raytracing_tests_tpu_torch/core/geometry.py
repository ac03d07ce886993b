"""Ray-primitive intersection math, in object-local unit space.

Two primitive families:

  - ELLIPSOID: the unit sphere scaled per-axis by ``scale`` (a sphere of
    radius r is ``scale = (r, r, r)``).
  - CUBOID: the axis-aligned box ``[-scale/2, +scale/2]``.

All intersection functions take rays already transformed into the object's
local frame and broadcast over leading batch dimensions.  A miss is ``t = -1``
and callers compare ``t > 0``.
"""

from __future__ import annotations

import torch

from raytracing_tests_tpu_torch.core import linalg

ELLIPSOID = 1
CUBOID = 2

MISS_T = -1.0


def _safe_inv(d, eps: float = 1e-12):
    """1/d with zero components clamped to +-eps (slab entries land at
    ~1e12, far beyond any t limit)."""
    d_safe = torch.where(d.abs() < eps,
                         torch.where(d >= 0.0, eps, -eps).to(d.dtype), d)
    return 1.0 / d_safe


def _miss_like(t):
    return torch.full_like(t, MISS_T)


def ray_ellipsoid_t(origin, direction, scale):
    """Nearest positive hit t of a ray with the ellipsoid ``|p/scale| = 1``.

    Prefers the near root, falls back to the far root when the near root is
    behind the origin (rays starting inside hit the back wall).
    """
    o = origin / scale
    d = direction / scale
    half_b = linalg.dot(o, d)
    a = linalg.dot(d, d)
    c = linalg.dot(o, o) - 1.0
    disc = half_b * half_b - a * c
    ok = (disc > 0.0) & (a > 1e-30)
    sq = torch.sqrt(torch.where(ok, disc, torch.ones_like(disc)))
    a_safe = torch.where(ok, a, torch.ones_like(a))
    t0 = (-half_b - sq) / a_safe
    t1 = (-half_b + sq) / a_safe
    t = torch.where((t0 > t1) | (t0 < 0.0), t1, t0)
    return torch.where(ok & (t > 0.0), t, _miss_like(t))


def ray_cuboid_t(origin, direction, scale):
    """Nearest positive hit t of a ray with the box ``[-scale/2, scale/2]``.

    Slab test; rays starting inside hit the exit face (t = tmax when tmin < 0).
    """
    inv_d = _safe_inv(direction)
    b_min = -scale * 0.5
    b_max = scale * 0.5
    t1 = (b_min - origin) * inv_d
    t2 = (b_max - origin) * inv_d
    tmin = torch.amax(torch.minimum(t1, t2), dim=-1)
    tmax = torch.amin(torch.maximum(t1, t2), dim=-1)
    t = torch.where(tmax > tmin, torch.where(tmin > 0.0, tmin, tmax),
                    _miss_like(tmin))
    return torch.where(t > 0.0, t, _miss_like(t))


def ray_primitive_t(origin, direction, scale, obj_type):
    """Dispatch on primitive type (vectorized select, both sides evaluated)."""
    t_e = ray_ellipsoid_t(origin, direction, scale)
    t_c = ray_cuboid_t(origin, direction, scale)
    return torch.where(obj_type == ELLIPSOID, t_e,
                       torch.where(obj_type == CUBOID, t_c, _miss_like(t_e)))


def ellipsoid_normal(hit_point, scale):
    """Outward local normal of the ellipsoid at a local-space hit point."""
    return linalg.normalize(hit_point / (scale * scale))


def cuboid_normal(hit_point, scale):
    """Local normal = axis of the nearest face (faces scanned in order
    +x, -x, +y, -y, +z, -z keeping strict minima)."""
    d_pos = (hit_point - scale * 0.5).abs()  # +x, +y, +z
    d_neg = (hit_point + scale * 0.5).abs()  # -x, -y, -z
    dists = torch.stack(
        [d_pos[..., 0], d_neg[..., 0], d_pos[..., 1], d_neg[..., 1],
         d_pos[..., 2], d_neg[..., 2]], dim=-1)
    # First minimum, matching the strict '>' scan: argmin of a stable sort key.
    mn = torch.amin(dists, dim=-1, keepdim=True)
    idx = torch.arange(6, device=dists.device).expand_as(dists)
    face = torch.amin(torch.where(dists == mn, idx, torch.full_like(idx, 6)),
                      dim=-1)
    axis = face // 2
    sign = torch.where(face % 2 == 0, 1.0, -1.0).to(hit_point.dtype)
    eye = torch.eye(3, dtype=hit_point.dtype, device=hit_point.device)
    return eye[axis] * sign[..., None]


def primitive_normal(hit_point, scale, obj_type):
    n_e = ellipsoid_normal(hit_point, scale)
    n_c = cuboid_normal(hit_point, scale)
    return torch.where((obj_type == ELLIPSOID)[..., None], n_e, n_c)


def ray_aabb_hit(bb_min, bb_max, origin, direction, t_limit):
    """Conservative slab test: True when the slab interval is non-empty and
    its entry is closer than ``t_limit`` (no positivity check on tmax — boxes
    behind the origin are accepted; leaf-level intersection rejects them)."""
    inv_d = _safe_inv(direction)
    t1 = (bb_min - origin) * inv_d
    t2 = (bb_max - origin) * inv_d
    tmin = torch.amax(torch.minimum(t1, t2), dim=-1)
    tmax = torch.amin(torch.maximum(t1, t2), dim=-1)
    return (tmax > tmin) & (t_limit > tmin)


def point_in_unit_primitive(local_point, obj_type):
    """Is a local-space point (already divided by scale) inside the unit
    primitive?  Used by the surrounding-refractive-index estimate."""
    in_e = linalg.dot(local_point, local_point) <= 1.0
    in_c = torch.all(local_point.abs() <= 0.5, dim=-1)
    return torch.where(obj_type == ELLIPSOID, in_e,
                       torch.where(obj_type == CUBOID, in_c,
                                   torch.zeros_like(in_e)))


def transform_ray_to_local(origin, direction, position, rotation, delta_position, time_ratio):
    """World ray -> object local frame, with per-sample motion offset: the
    object position is offset by ``(1 - ratio) * delta_pos``."""
    shift = (1.0 - time_ratio)[..., None] * delta_position
    o = linalg.apply_rotation_t(rotation, origin - position + shift)
    d = linalg.apply_rotation_t(rotation, direction)
    return o, d


def object_aabb(position, last_position, rotation, scale, obj_type=None):
    """Conservative world AABB of a transformed primitive including motion sweep.

    Half-extent along world axis k is the norm of row k of ``R @ diag(scale)``,
    swept over the segment [last_position, position].  (The full ``scale`` is
    used for both primitive types — cuboids get a 2x-loose box.)
    """
    rs = rotation * scale[..., None, :]  # R @ diag(scale)
    half = torch.sqrt(torch.sum(rs * rs, dim=-1))  # row norms -> (..., 3)
    lo = torch.minimum(position, last_position) - half
    hi = torch.maximum(position, last_position) + half
    return lo, hi
