"""Fast gradient rendering: kernel winner-finding + closed-form recompute.

No backward of the sweep is written.  Instead:

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
the backward touches one object per lane.  The per-lane gathers of the
winner's rows are one hand-written kernel with a hand-written backward
(``kernels.gather.winner_gather``) over the scene's fields packed once a
scene object (``winner_table``); the recompute from those rows is another,
with its backward and its forward-mode tangent
(``kernels.recompute.winner_recompute``).
"""

from __future__ import annotations

import torch

from raytracing_tests_tpu_torch.kernels import _build
from raytracing_tests_tpu_torch.kernels.gather import winner_table
from raytracing_tests_tpu_torch.kernels.recompute import winner_recompute
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


def make_diff_accel(scene, has_motion: bool = True, mode: str = "spheres",
                    probe_rows=None) -> DiffAccel:
    """The sweep's accel over the scene's detached values (a constant of
    autograd and of the ``torch.func`` transforms)."""
    names = [f for f, v in vars(scene).items() if isinstance(v, torch.Tensor)]

    def build(*tensors):
        detached = scene.replace(**dict(zip(names, tensors)))
        if mode == "spheres":
            return DiffAccel(make_accel2(detached, has_motion=has_motion,
                                         probe_rows=probe_rows))
        from raytracing_tests_tpu_torch.kernels.sweep2g import make_accel2g

        return DiffAccel(make_accel2g(detached, has_motion=has_motion,
                                      probe_rows=probe_rows))

    return _build.constant(build, *(getattr(scene, f) for f in names))


def _original(perm, obj_sorted):
    """Sorted row -> original object index; -1 stays -1."""
    return torch.where(obj_sorted >= 0, perm[obj_sorted.clamp_min(0).long()],
                       torch.full_like(obj_sorted, -1))


def _winner(accel, o, d, time_ratio, t_limit):
    """Original-scene index of the nearest hit (a constant, by the kernel)."""

    def search(*args):
        if accel.mode == "spheres":
            _, obj_sorted = sweep2_nearest(accel, *args)
        else:
            from raytracing_tests_tpu_torch.kernels.sweep2g import sweep2g_nearest

            _, obj_sorted = sweep2g_nearest(accel, *args)
        return _original(accel.perm, obj_sorted)

    return _build.constant(search, o, d, time_ratio, t_limit)


def _winner_or_candidate(accel, o, d, time_ratio, t_limit):
    """Original-scene index of the nearest hit, or where there is none the
    silhouette candidate's (a near miss adopts it; a constant, by the
    kernel's silhouette instantiation)."""

    def search(*args):
        if accel.mode == "spheres":
            _, obj_sorted, edge_sorted = sweep2_nearest_edge(accel, *args)
        else:
            from raytracing_tests_tpu_torch.kernels.sweep2g import sweep2g_nearest_edge

            _, obj_sorted, edge_sorted = sweep2g_nearest_edge(accel, *args)
        obj = _original(accel.perm, obj_sorted)
        return torch.where(obj >= 0, obj, _original(accel.perm, edge_sorted))

    return _build.constant(search, o, d, time_ratio, t_limit)


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
        obj = _winner_or_candidate(inner, o, d, time_ratio, t_limit)
    else:
        obj = _winner(inner, o, d, time_ratio, t_limit)
    hit = obj >= 0
    # Per-lane rows of the winner, every field by one gather
    # (kernels/gather.py); its backward adds the lanes' gradients into the
    # scene's packed table.
    f = winner_table(scene).gather(obj)

    # The winner's hit with the dense intersector's own math (same rotation
    # and per-axis-scale frame), so its gradients are the dense path's: one
    # hand-written kernel with its backward and tangent
    # (kernels/recompute.py).
    t, normal, local_pos, alpha = winner_recompute(
        o, d, time_ratio, hit, f["position"], f["delta_position"], f["rotation"], f["scale"],
        f["obj_type"], soft=soft, mode=accel.mode)

    flds = HitFields(
        color=f["color"],
        refractive_index=f["refractive_index"],
        refractivity=f["refractivity"],
        reflectivity=f["reflectivity"],
        scatter_refract=f["scatter_refract"],
        scatter_reflect=f["scatter_reflect"],
        texture_index=f["texture_index"],
        emissive=f["emissive"] & hit,
    )
    h = Hit(t=t, obj=obj.to(torch.int32), hit=hit, normal=normal, local_pos=local_pos)
    return h, flds, alpha


def occluded_nearest_obj_diff(accel: DiffAccel, scene, o, d, time_ratio, t_limit):
    """Shadow-ray occlusion is discrete: the detached winner's index."""
    return _winner(accel.inner, o, d, time_ratio, t_limit)
