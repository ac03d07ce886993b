"""Fast gradient rendering: kernel winner-finding + closed-form recompute.

No backward kernel is written.  Instead:

  - The WINNER of the nearest-hit sweep is a discrete argmin — its gradient
    is zero almost everywhere — so the sweep kernel (``kernels.sweep2`` in
    sphere mode, ``kernels.sweep2g`` in generic mode) runs under
    ``torch.no_grad()`` on detached inputs, only to name the winning object.
  - The hit distance, normal and material fields are then RECOMPUTED in
    closed form from the scene parameters of that one object (per-lane
    gathers and the primitive's own test), and THIS is what autograd
    differentiates: the analytic backward of the sweep restricted to the
    winner, the true gradient of the rendered value wherever the winner is
    locally stable (away from silhouettes; see ``soft`` for the edge-aware
    estimator).

The expensive O(N) search runs once per ray, forward only, at kernel speed;
the backward touches one object per lane.
"""

from __future__ import annotations

import torch

from raytracing_tests_tpu_torch.core import geometry, linalg
from raytracing_tests_tpu_torch.kernels.sweep import HitFields
from raytracing_tests_tpu_torch.kernels.sweep2 import (
    make_accel2, sweep2_nearest, sweep2_nearest_edge,
)
from raytracing_tests_tpu_torch.ops.intersect import Hit


class DiffAccel:
    """A detached accel (sphere-mode ``Accel2`` or generic ``Accel2G``) that
    marks the differentiable path for the renderer's dispatch."""

    def __init__(self, inner):
        self.inner = inner

    @property
    def mode(self):
        return self.inner.mode


def fastpath_eligible(cfg) -> bool:
    """When the fast gradient path applies: the ``pallas`` intersector, both
    scene modes, with or without ``soft_edges``.  Read by both
    ``diff.train._diff_cfg`` (to set ``diff_mode``) and
    ``ops.render._build_accel`` (to build the ``DiffAccel``)."""
    return cfg.intersector == "pallas"


def _detached(scene):
    return scene.replace(**{
        f: v.detach() for f, v in vars(scene).items() if isinstance(v, torch.Tensor)})


def make_diff_accel(scene, has_motion: bool = True, mode: str = "spheres",
                    probe_rows=None) -> DiffAccel:
    """The sweep's accel over the scene's detached values."""
    detached = _detached(scene)
    with torch.no_grad():
        if mode == "spheres":
            return DiffAccel(make_accel2(detached, has_motion=has_motion,
                                         probe_rows=probe_rows))
        from raytracing_tests_tpu_torch.kernels.sweep2g import make_accel2g

        return DiffAccel(make_accel2g(detached, has_motion=has_motion,
                                      probe_rows=probe_rows))


def _original(perm, obj_sorted):
    """Sorted row -> original object index; -1 stays -1."""
    return torch.where(obj_sorted >= 0, perm[obj_sorted.clamp_min(0).long()],
                       torch.full_like(obj_sorted, -1))


def _winner(accel, o, d, time_ratio, t_limit):
    """Original-scene index of the nearest hit (detached, by the kernel)."""
    args = (o.detach(), d.detach(), time_ratio.detach(), t_limit.detach())
    with torch.no_grad():
        if accel.mode == "spheres":
            _, obj_sorted = sweep2_nearest(accel, *args)
        else:
            from raytracing_tests_tpu_torch.kernels.sweep2g import sweep2g_nearest

            _, obj_sorted = sweep2g_nearest(accel, *args)
        return _original(accel.perm, obj_sorted)


def _clamp(x, lo: float):
    """max(x, lo) whose gradient splits 1/2 : 1/2 at a tie, as the JAX
    package's ``jnp.maximum`` does (``clamp_min`` passes all of it)."""
    return torch.maximum(x, torch.full((), lo, dtype=x.dtype, device=x.device))


def intersect_diff(accel: DiffAccel, scene, o, d, time_ratio, t_limit, soft: float = 0.0):
    """(Hit, HitFields, alpha) with gradients with respect to the scene's
    parameters and to (o, d).

    Both scene modes: the detached winner comes from the sphere sweep or the
    generic sweep per ``accel.mode``; the differentiable recompute below always
    uses the full rotation / per-axis-scale / type math, so rotated cuboids and
    anisotropic ellipsoids differentiate exactly like the dense intersector.

    ``soft > 0`` turns on the EDGE-AWARE estimator: lanes that narrowly miss
    every object adopt the kernel's silhouette candidate, and every lane gets
    a smooth coverage ``alpha`` of its candidate.  Sphere mode:
    sigmoid(-(h - r) / (soft * t)) with h the world distance from the ray's
    line to the centre.  Generic mode: the same blend in the object's local
    unit frame (rotate by R^T, divide by scale; ellipsoid silhouette at
    |q| = 1, cuboid at Chebyshev distance 0.5 of the closest-approach point
    q), rescaled to world units by the geometric-mean scale.  Hard visibility
    becomes a blend over a band about ``soft * t`` wide, so
    d(image)/d(position, scale, rotation) carries the silhouette term that
    autograd through the discontinuous hit mask loses.  ``alpha`` is None
    when ``soft == 0``."""
    inner = accel.inner
    if soft > 0.0:
        args = (o.detach(), d.detach(), time_ratio.detach(), t_limit.detach())
        with torch.no_grad():
            if accel.mode == "spheres":
                _, obj_sorted, edge_sorted = sweep2_nearest_edge(inner, *args)
            else:
                from raytracing_tests_tpu_torch.kernels.sweep2g import sweep2g_nearest_edge

                _, obj_sorted, edge_sorted = sweep2g_nearest_edge(inner, *args)
            obj = _original(inner.perm, obj_sorted)
            edge = _original(inner.perm, edge_sorted)
            obj = torch.where(obj >= 0, obj, edge)  # a near miss adopts the candidate
    else:
        obj = _winner(inner, o, d, time_ratio, t_limit)
    hit = obj >= 0
    safe = obj.clamp_min(0).long()
    # Per-lane rows of the winner.  index_select's backward adds the lanes'
    # gradients into the table with atomics; a plain index's backward sorts
    # the lanes and walks each object's run of them in one warp, serially,
    # and a ground sphere owns half the lanes.
    pick = lambda v: torch.index_select(v, 0, safe)

    # The winner's hit with the dense intersector's own math (same rotation
    # and per-axis-scale frame), so its gradients are the dense path's.
    rot = pick(scene.rotation)
    scale = pick(scene.scale)
    otype = pick(scene.obj_type)
    rel = (o - pick(scene.position)
           + (1.0 - time_ratio)[:, None] * pick(scene.delta_position))
    lo = linalg.apply_rotation_t(rot, rel)
    ld = linalg.apply_rotation_t(rot, d)
    t = geometry.ray_primitive_t(lo, ld, scale, otype)

    alpha = None
    if soft > 0.0:
        if accel.mode == "spheres":
            # Isotropic coverage: h = distance from the centre to the ray's
            # line at the closest-approach point t_cl (ahead of the ray, by
            # the kernel's forward filter); smooth on both sides.
            a = _clamp(torch.sum(d * d, dim=1), 1e-20)
            half_b = torch.sum(rel * d, dim=1)
            t_cl = -half_b / a
            h2 = torch.sum(rel * rel, dim=1) - half_b * half_b / a
            h = torch.sqrt(_clamp(h2, 1e-20))
            band = soft * _clamp(torch.abs(t_cl), 1e-3)
            alpha = torch.sigmoid(-(h - scale[:, 0]) / band)
        else:
            # Rotated-frame coverage: the closest approach of the ray to the
            # object in its LOCAL UNIT space (the ellipsoid is the unit
            # sphere, the cuboid the unit cube); the silhouette distance is
            # |q| - 1 (ellipsoid) or twice the Chebyshev max|q| - 0.5
            # (cuboid), in world units by the geometric-mean scale.
            ssafe = _clamp(scale, 1e-20)
            lo_s = lo / ssafe
            ld_s = ld / ssafe
            a = _clamp(torch.sum(ld_s * ld_s, dim=1), 1e-20)
            half_b = torch.sum(lo_s * ld_s, dim=1)
            t_cl = -half_b / a  # the world ray parameter (the same t in either frame)
            q = lo_s + t_cl[:, None] * ld_s
            h_ell = torch.sqrt(_clamp(torch.sum(q * q, dim=1), 1e-20))
            h_cub = torch.amax(torch.abs(q), dim=1)
            is_ell = otype == geometry.ELLIPSOID
            over = torch.where(is_ell, h_ell - 1.0, 2.0 * (h_cub - 0.5))
            r_geo = torch.exp(torch.mean(torch.log(ssafe), dim=1))
            band = soft * _clamp(torch.abs(t_cl), 1e-3)
            alpha = torch.sigmoid(-(over * r_geo) / band)
        alpha = torch.where(hit, alpha, torch.zeros_like(alpha))
        # Geometric-miss lanes (adopted candidates) hit at the tangent point.
        real = t < 2.9e38
        t = torch.where(real, t, t_cl)

    t = torch.where(hit, t, torch.ones_like(t))
    p_local = lo + t[:, None] * ld
    n_local = geometry.primitive_normal(p_local, scale, otype)
    normal = linalg.apply_rotation(rot, n_local)
    local_pos = p_local / scale

    flds = HitFields(
        color=pick(scene.color),
        refractive_index=pick(scene.refractive_index),
        refractivity=pick(scene.refractivity),
        reflectivity=pick(scene.reflectivity),
        scatter_refract=pick(scene.scatter_refract),
        scatter_reflect=pick(scene.scatter_reflect),
        texture_index=pick(scene.texture_index),
        emissive=pick(scene.emissive) & hit,
    )
    h = Hit(t=t, obj=obj.to(torch.int32), hit=hit, normal=normal, local_pos=local_pos)
    return h, flds, alpha


def occluded_nearest_obj_diff(accel: DiffAccel, scene, o, d, time_ratio, t_limit):
    """Shadow-ray occlusion is discrete: the detached winner's index."""
    return _winner(accel.inner, o, d, time_ratio, t_limit)
