"""Scene intersection: brute-force object sweep (vectorized over lanes x objects).

A dense lane x object sweep: every op is a fused elementwise broadcast.  It is
the readable reference intersector of the queue renderer and handles both
primitive families with rotation and motion.

Contract: all functions take flat lane tensors ``o, d: (B, 3)``,
``time_ratio: (B,)`` and return a ``Hit`` SoA of shape (B, ...).
"""

from __future__ import annotations

import dataclasses

import torch

from raytracing_tests_tpu_torch.core import geometry, linalg
from raytracing_tests_tpu_torch.scene.types import Scene

BIG_T = 3.0e38


@dataclasses.dataclass
class Hit:
    t: torch.Tensor  # (B,) hit distance; >= t_limit means miss
    obj: torch.Tensor  # (B,) i32 object index (undefined on miss)
    hit: torch.Tensor  # (B,) bool
    normal: torch.Tensor  # (B, 3) world normal at hit (undefined on miss)
    local_pos: torch.Tensor  # (B, 3) unit-space hit position (for texturing)


def _local_rays(scene: Scene, o, d, time_ratio):
    """Transform lane rays into every object's local frame: (B, N, 3)."""
    shift = (1.0 - time_ratio)[:, None, None] * scene.delta_position[None]
    rel = o[:, None, :] - scene.position[None] + shift  # (B, N, 3)
    lo = torch.einsum("nji,bnj->bni", scene.rotation, rel)
    ld = torch.einsum("nji,bj->bni", scene.rotation, d)
    return lo, ld


def _masked_t(scene: Scene, lo, ld, t_limit):
    t = geometry.ray_primitive_t(lo, ld, scene.scale[None], scene.obj_type[None])  # (B, N)
    big = torch.full_like(t, BIG_T)
    t = torch.where(scene.valid[None] & (t > 0.0), t, big)
    return torch.where(t < t_limit[:, None], t, big)


def _argmin_first(t):
    """(min, first index of the min) along dim 1."""
    t_min = torch.amin(t, dim=1)
    idx = torch.arange(t.shape[1], device=t.device).expand_as(t)
    first = torch.amin(
        torch.where(t == t_min[:, None], idx, torch.full_like(idx, t.shape[1])),
        dim=1)
    return t_min, first


def intersect_brute(scene: Scene, o, d, time_ratio, t_limit):
    """Nearest hit across all (valid) objects. (B,N) dense sweep."""
    lo, ld = _local_rays(scene, o, d, time_ratio)
    t = _masked_t(scene, lo, ld, t_limit)
    _, obj = _argmin_first(t)
    # The winner's own t, gathered: under autograd the gradient reaches that
    # one object's terms (a minimum would split it between exact ties).
    t_hit = torch.gather(t, 1, obj[:, None])[:, 0]
    hit = t_hit < BIG_T
    # Bounded t for misses: every downstream use is masked by ``hit``, but the
    # values still flow through normalize/shading.
    t_hit = torch.where(hit, t_hit, torch.ones_like(t_hit))

    rot = scene.rotation[obj]  # (B, 3, 3)
    scale = scene.scale[obj]
    otype = scene.obj_type[obj]
    pick = obj[:, None, None].expand(-1, 1, 3)
    lo_b = torch.gather(lo, 1, pick)[:, 0]
    ld_b = torch.gather(ld, 1, pick)[:, 0]
    p_local = lo_b + t_hit[:, None] * ld_b
    n_local = geometry.primitive_normal(p_local, scale, otype)
    n_world = linalg.apply_rotation(rot, n_local)
    return Hit(t=t_hit, obj=obj.to(torch.int32), hit=hit, normal=n_world,
               local_pos=p_local / scale)


def occluded_nearest_obj(scene: Scene, o, d, time_ratio, t_limit):
    """Index of the nearest object hit before ``t_limit`` (-1 if none)."""
    lo, ld = _local_rays(scene, o, d, time_ratio)
    t = _masked_t(scene, lo, ld, t_limit)
    t_hit, obj = _argmin_first(t)
    return torch.where(t_hit < BIG_T, obj, torch.full_like(obj, -1)).to(torch.int32)


def surrounding_refractive_index(scene: Scene, point, time_ratio):
    """Mean refractive index of containing objects with RI != 1.

    Accumulates the RI of every containing OPTICALLY DENSE (ri != 1) object;
    if the sum exceeds 1 returns sum/count else 1.  RI-1 containers are air —
    they cannot move the result off 1.0 alone, and skipping them keeps the
    estimate undiluted under geometry overlap while letting the kernels probe
    a dielectric-only sub-table.
    """
    # Containment is a boolean: no gradient passes it, so it is computed
    # outside autograd (the (B, N, 3) intermediates would otherwise be kept for
    # a backward pass that never reads them).  The sum below stays
    # differentiable with respect to refractive_index.
    with torch.no_grad():
        shift = (1.0 - time_ratio)[:, None, None] * scene.delta_position[None]
        rel = point[:, None, :] - scene.position[None] + shift
        local = torch.einsum("nji,bnj->bni", scene.rotation, rel) / scene.scale[None]
        inside = (geometry.point_in_unit_primitive(local, scene.obj_type[None])
                  & scene.valid[None] & (scene.refractive_index[None] != 1.0))
    ri = scene.refractive_index[None].expand_as(inside)
    acc = torch.sum(torch.where(inside, ri, torch.zeros_like(ri)), dim=1)
    cnt = torch.sum(inside.to(torch.float32), dim=1)
    return torch.where(acc > 1.0, acc / torch.clamp_min(cnt, 1.0),
                       torch.ones_like(acc))
