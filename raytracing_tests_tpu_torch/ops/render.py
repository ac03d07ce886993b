"""The queue path tracer: a bounded per-lane ray-queue bounce loop.

Every (pixel, sample) lane owns a fixed-capacity LIFO ray QUEUE held as SoA
tensors; each step pops the top of every lane, intersects, shades and pushes
the children, vectorized across the lane axis.  This is the port's readable
reference renderer; the fast path is ``kernels.uber.render_uber``.

Semantics reproduced:
  - absorption shading: every processed ray adds ``contribution * albedo``;
    each hit spawns up to two children (refract, reflect) and damps its own
    contribution by ``1 - 0.5 * (spawned fractions)``,
  - surrounding-refractive-index estimation by point-inclusion,
  - deterministic sunflower/cone sample distributions (no RNG),
  - emissive lights: shadow rays toward a per-sample point of each light's
    AABB scale a hit's contribution, a hit on an emissive object paints the
    sample white, and the background is black,
  - ``shading="materials"``: the Shirley-materials model with a per-ray
    medium refractive index (``_shade_materials``),
  - cube-sphere textures: an object with a texture index multiplies its
    albedo by a bilinear sample of its atlas at the cube-sphere UV of its
    unit-space hit position (``_material_color``),
  - per-sample gamma-2 then mean over samples.

Ported: ``shading="bvh"`` and ``"materials"``, with or without lights and
textures, and the normals view (``show_normals``), through the ``brute``
intersector, the ``bvh`` intersector (the LBVH traversal, ``bvh/``) or the
``pallas`` intersector: the grouped sphere sweep ``kernels.sweep2`` in sphere
mode, the first-generation sweeps of ``kernels.sweep`` for generic scenes
(grouped by ``pallas_groups``, dense when that is 0) and for sphere scenes
with ``pallas_v2=False``.  With ``diff_mode`` (set by ``diff.train``) the
``pallas`` intersector is the gradient path: a ``DiffAccel`` whose sweeps name
the winners and ``diff.fastpath.intersect_diff`` recomputes their hits
differentiably, with the soft-edge blend when ``soft_edges > 0``.  The
"bvh" shading of a pop is ``kernels.shade.shade_bvh``: one kernel launch on
the card, its plain version on the CPU.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from raytracing_tests_tpu_torch.core import linalg, sampling
from raytracing_tests_tpu_torch.kernels import queue as ray_queue
from raytracing_tests_tpu_torch.kernels import shade
from raytracing_tests_tpu_torch.ops import intersect as isect
from raytracing_tests_tpu_torch.ops.camera_rays import primary_rays
from raytracing_tests_tpu_torch.scene.types import Camera, Scene, _TensorStruct
from raytracing_tests_tpu_torch.utils.device import resolve_device

MAX_T_DEPTH = 32000.0


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static render parameters."""

    width: int = 128
    height: int = 72
    spp: int = 4  # samples per pixel
    max_bounces: int = 5
    queue_capacity: int = 5  # 40-float stack / 8 floats per record
    max_pops: Optional[int] = None  # ray-tree budget; None -> 2*max_bounces + 1
    t_max: float = MAX_T_DEPTH
    # Carried for the JAX package's config, read nowhere: ``finalize`` takes
    # the square root (gamma 2) as that package's does.
    gamma: float = 2.0
    background: tuple = ((1.0, 1.0, 1.0), (0.3, 0.4, 1.0))  # bottom, top
    # Read by the oracle (``reference.cpu_renderer``) and by callers deciding
    # whether to pass ``extract_lights``; the renderers read the lights given.
    enable_lights: bool = True
    # 'brute' | 'pallas' (the sweep kernels) | 'bvh' (the LBVH traversal)
    intersector: str = "brute"
    # 'bvh': the In-Next-Week family shading (surrounding-RI estimation,
    #        deviate-cone scatter, 0.5-forward damping).
    # 'materials': the In-One-Weekend Shirley materials (per-ray medium RI,
    #        Schlick shift, fibonacci-hemisphere scatter).
    shading: str = "bvh"
    # Debug view: the world normal of each primary's nearest hit, averaged
    # over the samples without gamma (black where the primary misses).
    show_normals: bool = False
    lane_chunk: Optional[int] = None  # bound peak memory: lanes per step
    aa_grid: bool = False  # sub-pixel supersampling grid
    early_exit: bool = True  # stop as soon as every ray queue drains
    # Static scene features (set via for_scene()).  has_dielectrics gates the
    # surrounding-refractive-index sweep -- the single most expensive per-pop
    # op for scenes that never refract.
    has_dielectrics: bool = True
    pallas_mode: str = "generic"  # 'spheres' | 'generic' (set via for_scene)
    has_motion: bool = True
    # Objects per culling group of the first-generation grouped sweep
    # (kernels.sweep); 0 = the dense sweep over the whole table.
    pallas_groups: int = 32
    # Sphere scenes take the grouped sphere sweep (kernels.sweep2) instead of
    # the first-generation sweeps.
    pallas_v2: bool = True
    # Count of dielectric (ri != 1) rows — sizes the trailing surrounding-RI
    # probe sub-table (sweep2.make_accel2).  -1 = count at accel-build time.
    probe_rows: int = -1
    # Gradient rendering: winner-finding by a detached sweep kernel +
    # differentiable closed-form recompute of the winner's hit
    # (diff/fastpath.py).  Set by diff.train.render_loss.
    diff_mode: bool = False
    # Edge-aware gradients (diff_mode only): > 0 turns hard visibility into a
    # smooth coverage blend over a band of ``soft_edges * t`` world units.
    # Training only: blurs silhouettes by about half a pixel, and unbiases
    # d(image)/d(geometry).
    soft_edges: float = 0.0

    def for_scene(self, scene) -> "RenderConfig":
        """Specialize static flags from a scene."""
        from raytracing_tests_tpu_torch.kernels.sweep import scene_has_motion, scene_mode

        npy = lambda x: x.detach().cpu().numpy()
        refr = npy(scene.refractivity) * npy(scene.valid)
        dmask = npy(scene.valid) & (npy(scene.refractive_index) != 1.0)
        has_d = bool((refr > 0.002).any())
        # The probe sub-table is consumed only on the has_dielectrics
        # bvh-shading path — don't carry the rows otherwise.
        use_probe = has_d and self.shading != "materials"
        return dataclasses.replace(
            self,
            has_dielectrics=has_d,
            pallas_mode=scene_mode(scene),
            has_motion=scene_has_motion(scene),
            probe_rows=int(dmask.sum()) if use_probe else 0,
        )

    @property
    def pops(self) -> int:
        return self.max_pops if self.max_pops is not None else 2 * self.max_bounces + 1


def _check_supported(cfg: RenderConfig):
    if cfg.shading not in ("bvh", "materials"):
        raise ValueError(f"unknown shading {cfg.shading!r}")
    if cfg.intersector not in ("brute", "pallas", "bvh"):
        raise NotImplementedError(f"unknown intersector {cfg.intersector!r}")


@dataclasses.dataclass
class Lights(_TensorStruct):
    """Static-shape emissive-object list: each light's world AABB and object
    index, padded to a capacity under ``mask``."""

    bb_min: torch.Tensor  # (L, 3)
    bb_max: torch.Tensor  # (L, 3)
    geom_idx: torch.Tensor  # (L,) i32
    mask: torch.Tensor  # (L,) bool

    @property
    def capacity(self) -> int:
        return self.geom_idx.shape[0]

    @property
    def count(self):
        return torch.sum(self.mask.to(torch.int32))


def extract_lights(scene: Scene, capacity: Optional[int] = None) -> Optional[Lights]:
    """Host-side: collect the emissive objects' AABBs into a padded Lights
    (on the scene's device).  None when the scene has no emissives, which
    disables the shadow rays."""
    npy = lambda x: x.detach().cpu().numpy()
    emissive = npy(scene.emissive) & npy(scene.valid)
    idx = np.nonzero(emissive)[0]
    if idx.size == 0:
        return None
    cap = max(capacity or int(idx.size), int(idx.size))
    lo, hi = (npy(x) for x in scene.world_aabbs())
    bb_min = np.zeros((cap, 3), np.float32)
    bb_max = np.zeros((cap, 3), np.float32)
    geom = np.zeros((cap,), np.int32)
    mask = np.zeros((cap,), bool)
    bb_min[: idx.size] = lo[idx]
    bb_max[: idx.size] = hi[idx]
    geom[: idx.size] = idx
    mask[: idx.size] = True
    t = lambda a: torch.from_numpy(a).to(scene.device)
    return Lights(bb_min=t(bb_min), bb_max=t(bb_max), geom_idx=t(geom), mask=t(mask))


# ----------------------------------------------------------------------------
# Per-lane ray queue (SoA). LIFO, drops pushes when full and counts them.
# ----------------------------------------------------------------------------


@dataclasses.dataclass
class RayQueue:
    """Each lane's stack of Q records, and one spill slot after them (index
    Q) that a push which cannot write lands in and no pop reads.

    ``stacks`` holds each field slot-major, ``(Q + 1, B, ...)``: record ``s``
    of every lane lies together, so the lanes of a push or a pop, whose
    queues mostly hold as many rays, write and read neighbouring addresses.
    The fields are origin (3), direction (3), contribution, bounced (int32)
    and, in a queue made with ``media``, the materials model's medium
    tracking: the refractive index of the medium each queued ray travels
    in, and its parent's (a depth-2 medium stack).  Without media both are
    air (1.0) and nothing stores them.

    Each method routes by device (``kernels.queue``): on the CPU the plain
    versions (``index_select``, ``index_copy``), on CUDA tensors the
    kernels of ``csrc/queue.cu``, which change the stacks in place and
    whose backward touches only the rows a step read or wrote (``grads``
    passes the stacks' gradient down the steps)."""

    stacks: dict  # name -> (Q + 1, B, ...)
    size: torch.Tensor  # (B,) i64
    lane: torch.Tensor  # (B,) i64: 0 .. B - 1
    grads: ray_queue.GradBuffers = dataclasses.field(default_factory=ray_queue.GradBuffers)

    @classmethod
    def create(cls, batch: int, capacity: int, device, media: bool = True):
        q1 = capacity + 1
        z = lambda *s, dt=torch.float32: torch.zeros(s, dtype=dt, device=device)  # noqa: E731
        stacks = dict(origin=z(q1, batch, 3), direction=z(q1, batch, 3),
                      contribution=z(q1, batch), bounced=z(q1, batch, dt=torch.int32))
        if media:
            stacks.update({n: torch.ones((q1, batch), dtype=torch.float32, device=device)
                           for n in ray_queue.MEDIA})
        return cls(stacks=stacks, size=z(batch, dt=torch.int64),
                   lane=torch.arange(batch, device=device))

    @property
    def capacity(self) -> int:
        return self.stacks["origin"].shape[0] - 1

    @property
    def media(self) -> bool:
        return ray_queue.MEDIA[0] in self.stacks

    def _rows(self, slot):
        """Row of each lane's record ``slot`` (B,) in a field's ((Q + 1) B)-row
        view."""
        return torch.add(self.lane, slot, alpha=self.lane.shape[0])

    def push(self, mask, origin, direction, contribution, bounced,
             medium=None, parent_medium=None):
        """Conditional push at position ``size`` for lanes in ``mask``
        (updates the queue in place) -> the dropped pushes, a 0-dim int64
        tensor on the queue's device (``kernels.queue.queue_push_plain``).
        ``medium`` / ``parent_medium`` default to air (1.0); a queue without
        media takes neither."""
        return self.push2((mask, origin, direction, contribution, bounced, medium,
                           parent_medium))

    def push2(self, first, second=None):
        """Push ``first`` and then ``second`` (each ``(mask, origin,
        direction, contribution, bounced, medium, parent_medium)``, the media
        optional; ``second`` None: ``first`` alone) -> the dropped pushes of
        both: one ``queue_push2`` launch on the card."""
        return ray_queue.push2(self, first, second)

    def pop(self):
        """LIFO pop -> (active, o, d, contribution, bounced, medium,
        parent_medium), the media None in a queue without them; lanes with
        empty queues return zeros and active=False."""
        return ray_queue.pop(self)


# ----------------------------------------------------------------------------
# Shading
# ----------------------------------------------------------------------------


def _is_v2(accel) -> bool:
    from raytracing_tests_tpu_torch.kernels.sweep2 import Accel2

    return isinstance(accel, Accel2)


def _is_pallas(accel) -> bool:
    from raytracing_tests_tpu_torch.kernels.sweep import PallasAccel

    return isinstance(accel, PallasAccel)


def _is_diff(accel) -> bool:
    from raytracing_tests_tpu_torch.diff.fastpath import DiffAccel

    return isinstance(accel, DiffAccel)


def _nearest(scene, accel, o, d, time_ratio, t_limit):
    """Intersector dispatch, the same ``Hit`` contract from each: the dense
    sweep (no accel), the gradient path's winner and recompute, the grouped
    sphere sweep, the first-generation sweeps, or the LBVH traversal."""
    if accel is None:
        return isect.intersect_brute(scene, o, d, time_ratio, t_limit)
    if _is_diff(accel):
        from raytracing_tests_tpu_torch.diff.fastpath import intersect_diff

        return intersect_diff(accel, scene, o, d, time_ratio, t_limit)[0]  # hard
    if _is_v2(accel):
        from raytracing_tests_tpu_torch.kernels.sweep2 import intersect2

        return intersect2(accel, scene, o, d, time_ratio, t_limit)
    if _is_pallas(accel):
        from raytracing_tests_tpu_torch.kernels.sweep import intersect_pallas

        return intersect_pallas(accel, scene, o, d, time_ratio, t_limit)
    from raytracing_tests_tpu_torch.bvh.traverse import traverse_nearest

    return traverse_nearest(accel, scene, o, d, time_ratio, t_limit)


def _nearest_obj(scene, accel, o, d, time_ratio, t_limit):
    """Original id of the nearest object hit before ``t_limit`` (-1 if none)."""
    if accel is None:
        return isect.occluded_nearest_obj(scene, o, d, time_ratio, t_limit)
    if _is_diff(accel):
        from raytracing_tests_tpu_torch.diff.fastpath import occluded_nearest_obj_diff

        return occluded_nearest_obj_diff(accel, scene, o, d, time_ratio, t_limit)
    if _is_v2(accel):
        from raytracing_tests_tpu_torch.kernels.sweep2 import occluded_nearest_obj2

        return occluded_nearest_obj2(accel, scene, o, d, time_ratio, t_limit)
    if _is_pallas(accel):
        from raytracing_tests_tpu_torch.kernels.sweep import occluded_nearest_obj_pallas

        return occluded_nearest_obj_pallas(accel, scene, o, d, time_ratio, t_limit)
    from raytracing_tests_tpu_torch.bvh.traverse import traverse_nearest_obj

    return traverse_nearest_obj(accel, scene, o, d, time_ratio, t_limit)


def _surrounding_ri(scene, accel, point, time_ratio):
    """Surrounding refractive index at ``point`` where no sweep fused it:
    the LBVH walk for the ``bvh`` intersector, else the dense containment
    sum (``kernels.ri_sum.containment_ri``: one kernel launch on the card;
    differentiable with respect to ``refractive_index``)."""
    from raytracing_tests_tpu_torch.kernels.ri_sum import containment_ri

    if _is_lbvh(accel):
        from raytracing_tests_tpu_torch.bvh.traverse import traverse_point_ri

        return traverse_point_ri(accel, scene, point, time_ratio)
    return containment_ri(scene, point, time_ratio)


def _is_lbvh(accel) -> bool:
    from raytracing_tests_tpu_torch.bvh.build import LBVH

    return isinstance(accel, LBVH)


# Lanes of one piece of the plain containment sum and of the LBVH walk
# (``_ri_of_lanes``).
RI_CHUNK = 65536


def _ri_of_lanes(scene, accel, point, time_ratio, need, capacity: Optional[int]):
    """The surrounding refractive index at ``point`` (``_surrounding_ri``)
    for the lanes in ``need``, the neutral 1 elsewhere -> (ri (B,), the count
    of lanes in ``need`` as a 0-dim int64 tensor).

    Static shapes and no host read: a cumulative sum gives each needing lane
    its slot, in lane order, and the sum runs over ``capacity`` slots only
    (every lane when None), which bounds the (slots, N) intermediates that
    autograd keeps of the dense containment sum.  Slots past the needing lanes
    compute lane 0's point and are thrown away.  A needing lane past the
    capacity reads 1: the caller compares the returned count with the
    capacity and traces again with more slots (``trace_lanes``,
    ``diff.train``).  On the card the dense sum is one kernel launch over
    every slot, which keeps no intermediate; on the CPU, and for the LBVH
    walk, the sum runs ``RI_CHUNK`` slots at a time, which bounds the plain
    version's transient (slots, N) tensors."""
    B = need.shape[0]
    n_need = torch.sum(need)
    cap = B if capacity is None else max(0, min(capacity, B))
    ones = torch.ones(B, dtype=torch.float32, device=need.device)
    if cap == 0:
        return ones, n_need
    slot = torch.cumsum(need, 0) - 1
    spill = torch.full_like(slot, cap)
    lanes = torch.zeros(cap + 1, dtype=torch.int64, device=need.device).scatter_(
        0, torch.where(need & (slot < cap), slot, spill),
        torch.arange(B, device=need.device))[:cap]
    whole = point.device.type != "cpu" and not _is_lbvh(accel)
    # a named range, so that a profile can tell the sum's kernels from the
    # shading's (its backward by the autograd sequence numbers of its ops)
    with torch.profiler.record_function("ri_sum"):
        ri = torch.cat([
            _surrounding_ri(scene, accel, point.index_select(0, part),
                            time_ratio.index_select(0, part))
            for part in ((lanes,) if whole else torch.split(lanes, RI_CHUNK))])
    used = torch.arange(cap, device=need.device) < n_need
    dest = torch.where(used, lanes, torch.full_like(lanes, B))
    return torch.cat([ones, ones[:1]]).scatter(0, dest, ri)[:B], n_need


def _material_color(scene: Scene, hit: isect.Hit, color, ti):
    """Albedo, cube-sphere-textured where the object has a texture index."""
    if scene.textures is None:
        return color
    from raytracing_tests_tpu_torch.kernels.texture import texture_color

    return texture_color(color, ti, hit.local_pos, scene.textures)


def _shadow_factor(scene, lights: Lights, hit, normal, sample_ratio, time_ratio, accel=None):
    """Fraction of lights visible from the hit point.

    Each lane aims at a per-sample point inside each light's AABB; a light
    counts as visible when the nearest occluder IS an emissive object.  The
    light axis is batched into one flattened (L*B)-lane occlusion sweep;
    masked lights carry zero directions."""
    origin = hit + 1e-4 * normal
    B = origin.shape[0]
    Lc = lights.capacity
    bb_min, bb_max = lights.bb_min, lights.bb_max  # (Lc, 3)
    center = (bb_min + bb_max) * 0.5
    target = bb_min[:, None, :] + (bb_max - bb_min)[:, None, :] * sample_ratio[None, :, None]
    t_lim = (
        torch.sqrt(torch.sum((center[:, None, :] - origin[None]) ** 2, dim=-1))
        + torch.sqrt(torch.sum((bb_max - bb_min) ** 2, dim=-1))[:, None]
    )  # (Lc, B)
    d = linalg.normalize(target - origin[None]) * lights.mask[:, None, None]
    o_f = origin[None].expand(Lc, B, 3).reshape(-1, 3)
    tr_f = time_ratio[None].expand(Lc, B).reshape(-1)
    nearest = _nearest_obj(scene, accel, o_f, d.reshape(-1, 3), tr_f, t_lim.reshape(-1))
    lit = (scene.emissive[nearest.clamp_min(0).long()] & (nearest >= 0)).reshape(Lc, B)
    is_lit = torch.sum(torch.where(lights.mask[:, None], lit.to(torch.float32),
                                   torch.zeros((), device=lit.device)), dim=0)
    return is_lit / torch.clamp_min(lights.count.to(torch.float32), 1.0)


@dataclasses.dataclass
class ShadeResult:
    """Everything one shading step produces for a batch of rays: color to
    accumulate, spawned child rays, and bookkeeping."""

    add_color: torch.Tensor  # (C, 3) contribution to accumulate
    set_white: torch.Tensor  # (C,) emissive abort: the sample becomes white
    hit_t: torch.Tensor  # (C,) hit distance (t_max convention on miss)
    did_hit: torch.Tensor  # (C,) bool (after the emissive abort)
    missed: torch.Tensor  # (C,) bool
    # children, refraction first (push order; LIFO pops reflect 1st)
    refr_mask: torch.Tensor
    refr_o: torch.Tensor
    refr_d: torch.Tensor
    refr_contrib: torch.Tensor
    refl_mask: torch.Tensor
    refl_o: torch.Tensor
    refl_d: torch.Tensor
    refl_contrib: torch.Tensor
    bounced: torch.Tensor  # (C,) child bounce count
    # Medium tracking (materials shading; 1.0 under 'bvh').
    refr_medium: torch.Tensor
    refr_parent: torch.Tensor
    refl_medium: torch.Tensor
    refl_parent: torch.Tensor


def shade_rays(scene, lights, cfg: RenderConfig, accel, o, d, contrib, bounced, active,
               sample_idx, time_ratio, medium=None, parent_medium=None,
               ri_lanes: Optional[int] = None, ri_max=None):
    """Intersect + shade one batch of rays (the path-tracer kernel body minus
    stack plumbing).  ``medium`` / ``parent_medium`` (materials shading)
    default to air.  ``ri_lanes``: the slots of the lanes that read the
    surrounding RI by the containment sum or the LBVH walk (``_ri_of_lanes``;
    None: every lane); ``ri_max``, a 0-dim int64 tensor, takes (in place) the
    count of the lanes that needed one where it exceeds it."""
    _check_supported(cfg)
    spp = cfg.spp
    B = o.shape[0]
    ones = torch.ones(B, dtype=torch.float32, device=o.device)
    medium = ones if medium is None else medium
    parent_medium = ones if parent_medium is None else parent_medium
    t_limit = torch.full((B,), cfg.t_max, dtype=torch.float32, device=o.device)
    sur_ri_fused = None
    soft_alpha = None
    needs_sur_ri = cfg.has_dielectrics and cfg.shading != "materials"
    if _is_diff(accel):
        from raytracing_tests_tpu_torch.diff.fastpath import intersect_diff

        hit, flds, soft_alpha = intersect_diff(
            accel, scene, o, d, time_ratio, t_limit, soft=cfg.soft_edges)
    elif _is_v2(accel):
        from raytracing_tests_tpu_torch.kernels.sweep2 import (
            intersect2_full, intersect2_fused,
        )

        if needs_sur_ri:
            hit, flds, sur_ri_fused = intersect2_fused(
                accel, scene, o, d, time_ratio, t_limit
            )
        else:
            hit, flds = intersect2_full(accel, scene, o, d, time_ratio, t_limit)
    elif _is_pallas(accel):
        from raytracing_tests_tpu_torch.kernels.sweep import (
            intersect_pallas_full, intersect_pallas_fused,
        )

        if needs_sur_ri:
            hit, flds, sur_ri_fused = intersect_pallas_fused(
                accel, scene, o, d, time_ratio, t_limit
            )
        else:
            hit, flds = intersect_pallas_full(accel, scene, o, d, time_ratio, t_limit)
    else:  # the dense intersector or the LBVH traversal
        hit = _nearest(scene, accel, o, d, time_ratio, t_limit)
        flds = None
    normal = hit.normal
    # The hit point where the surrounding RI's probe, the shadow rays or the
    # materials model read it (the "bvh" shading computes its own).
    hit_point = None
    if ((needs_sur_ri and sur_ri_fused is None) or lights is not None
            or cfg.shading == "materials"):
        hit_point = o + hit.t[:, None] * d

    if sur_ri_fused is not None:
        sur_ri = sur_ri_fused
    elif needs_sur_ri:
        # The dense intersector, the LBVH and the gradient path: for the lanes
        # that read it (refraction off a refractive winner, or out of an
        # interior hit); the others read the neutral 1, as the sweep kernels'
        # probe gives them.
        inner = linalg.dot(normal, d) > 0.0
        refractive = (scene.refractivity[hit.obj.long()] if flds is None
                      else flds.refractivity) > 0.002
        sur_ri, ri_need = _ri_of_lanes(
            scene, accel, hit_point + 1e-3 * normal, time_ratio,
            hit.hit & active & (inner | refractive), ri_lanes)
        if ri_max is not None:
            torch.maximum(ri_max, ri_need, out=ri_max)
    else:
        sur_ri = torch.ones(B, dtype=torch.float32, device=o.device)

    if flds is None:
        oi = hit.obj.long()
        base_color, tex_idx = scene.color[oi], scene.texture_index[oi]
        mat_ri = scene.refractive_index[oi]
        refractivity = scene.refractivity[oi]
        reflectivity = scene.reflectivity[oi]
        scat_rfr = scene.scatter_refract[oi]
        scat_rfl = scene.scatter_reflect[oi]
        emissive = scene.emissive[oi]
    else:  # grouped sweep: all fields from the winner's row
        base_color, tex_idx = flds.color, flds.texture_index
        mat_ri = flds.refractive_index
        refractivity = flds.refractivity
        reflectivity = flds.reflectivity
        scat_rfr = flds.scatter_refract
        scat_rfl = flds.scatter_reflect
        emissive = flds.emissive
    mat_color = _material_color(scene, hit, base_color, tex_idx)

    # With lights: the share of them each hit sees (the shadow sweep).
    lit = None
    if lights is not None:
        lit = _shadow_factor(scene, lights, hit_point, normal, sample_idx / spp,
                             time_ratio, accel)
    else:
        emissive = None

    if cfg.shading == "materials":
        did_hit, missed, add_color, contrib, set_white = shade.prelude_plain(
            d, contrib, active, hit.hit, soft_alpha, emissive, lit, cfg.background)
        return _shade_materials(
            cfg, o, d, contrib, bounced + 1, did_hit, missed, set_white, hit,
            hit_point, normal, mat_color, mat_ri, refractivity, reflectivity,
            scat_rfr, scat_rfl, medium, parent_medium, sample_idx, spp,
            add_color,
        )

    # The "bvh" model: one kernel launch on the card (kernels/shade.py).
    out = shade.shade_bvh(
        o, d, contrib, hit.t, normal, sur_ri, mat_color, mat_ri, refractivity, reflectivity,
        scat_rfr, scat_rfl, soft_alpha, sample_idx, lit, bounced, active, hit.hit, emissive,
        spp=spp, max_bounces=cfg.max_bounces, t_max=cfg.t_max, background=cfg.background)
    return ShadeResult(**dict(zip(shade.OUTPUTS, out)), refr_medium=ones, refr_parent=ones,
                       refl_medium=ones, refl_parent=ones)


def _shade_materials(cfg, o, d, contrib, bounced, did_hit, missed, set_white,
                     hit, hit_point, normal, mat_color, mat_ri, refractivity,
                     reflectivity, scat_rfr, scat_rfl, medium, parent_medium,
                     sample_idx, spp, add_color):
    """The Shirley-materials spawn model:

      - per-ray MEDIUM refractive index: an inner hit refracts toward the
        popped ray's parent medium; (medium, parent_medium) per ray is a
        depth-2 medium stack (grandparent media beyond depth 2 are air),
      - Schlick reflectance shifts contribution from refraction to
        reflection on outer hits,
      - an outer hit always spawns a reflection, scattered on the fibonacci
        hemisphere; refraction scatters likewise,
      - total internal reflection turns the refraction into a
        contribution-1.0 reflection along the mirror direction,
      - the local absorption term is ``contribution^2 * albedo``,
      - no 0.5-forward damping and no contribution cutoff (zero-contribution
        children are skipped: they add exactly nothing).
    """
    cos_theta = linalg.dot(normal, d)  # > 0 <=> inner hit
    inner_m = cos_theta > 0.0
    sin_theta = torch.sqrt(torch.clamp_min(1.0 - cos_theta * cos_theta, 0.0))
    target = torch.where(inner_m, parent_medium, mat_ri)
    ratio = medium / torch.clamp_min(target, 1e-6)
    ratio_sin = ratio * sin_theta
    tir = ratio_sin > 1.0

    zero = torch.zeros_like(contrib)
    refr_c = refractivity
    refl_c = reflectivity
    # Outer: Schlick shift from refraction to reflection.
    shift = torch.where(
        ~inner_m, refr_c * linalg.schlick(torch.clamp(-cos_theta, 0.0, 1.0), ratio), zero)
    refr_c = refr_c - shift
    refl_c = refl_c + shift
    # TIR: the refraction becomes a full-strength reflection.
    refl_c = torch.where(tir, torch.ones_like(refl_c), torch.where(inner_m, zero, refl_c))

    # Grazing-reflection lift: the mirror direction is raised to a minimum
    # elevation set by the scatter.
    inner3 = inner_m[:, None]
    _normal = torch.where(inner3, -normal, normal)  # toward the incident side
    refl_mirror = linalg.reflect(d, normal)
    n2ir = linalg.normalize(linalg.cross(_normal, d), eps=1e-20)
    n2n = linalg.normalize(linalg.cross(n2ir, _normal), eps=1e-20)
    s = torch.where(inner_m, scat_rfr, scat_rfl)
    inv = 1.0 / torch.sqrt(1.0 + s * s)
    max_reflect = (s * inv)[:, None] * _normal + inv[:, None] * n2n
    lift = linalg.dot(refl_mirror, _normal) <= linalg.dot(max_reflect, _normal)
    refl_base = torch.where((lift & ~inner_m)[:, None], max_reflect, refl_mirror)

    refl_dir = sampling.fibonacci_hemisphere(sample_idx, spp, scat_rfl, refl_base)
    refl_dir = torch.where((tir & inner_m)[:, None], refl_base, refl_dir)
    spawn_refl = did_hit & (bounced < cfg.max_bounces) & (~inner_m | tir)
    spawn_refl = spawn_refl & (contrib * refl_c > 0.0)

    # Refraction.
    _n2 = torch.where(inner3, normal, -normal)
    y_cap = _n2 * cos_theta[:, None]
    x_cap = d - y_cap
    refr_raw = (ratio_sin[:, None] * _n2
                + torch.sqrt(torch.clamp_min(1.0 - ratio_sin * ratio_sin, 0.0))[:, None] * x_cap)
    refr_base = linalg.normalize(refr_raw, eps=1e-20)
    refr_dir = sampling.fibonacci_hemisphere(sample_idx, spp, scat_rfr, refr_base)
    spawn_refr = did_hit & (bounced < cfg.max_bounces) & ~tir
    spawn_refr = spawn_refr & (contrib * refr_c > 0.0)

    # Local term: contribution^2 * albedo.
    add_color = add_color + torch.where(
        did_hit[:, None], (contrib * contrib)[:, None] * mat_color, torch.zeros_like(mat_color))

    return ShadeResult(
        add_color=add_color,
        set_white=set_white,
        hit_t=torch.where(hit.hit, hit.t, torch.full_like(hit.t, cfg.t_max)),
        did_hit=did_hit,
        missed=missed,
        refr_mask=spawn_refr,
        refr_o=hit_point + 1e-4 * _n2,
        refr_d=refr_dir,
        refr_contrib=contrib * refr_c,
        refl_mask=spawn_refl,
        refl_o=hit_point - 1e-4 * _n2,
        refl_d=refl_dir,
        refl_contrib=contrib * refl_c,
        bounced=bounced,
        refr_medium=target,
        # Exiting beyond the tracked depth approximates grandparent = air.
        refr_parent=torch.where(inner_m, torch.ones_like(medium), medium),
        refl_medium=medium,
        refl_parent=parent_medium,
    )


def _process_pop(scene, lights, cfg: RenderConfig, queue, state, sample_idx, spp, time_ratio,
                 accel=None, ri_lanes: Optional[int] = None, ri_max=None):
    """One queue step: pop LIFO top of every lane, shade, push children.
    Returns ``(state, n_dropped)`` (a device count); the queue is updated in
    place.  Static shapes, no host read.  ``ri_lanes``, ``ri_max``: see
    ``shade_rays``."""
    color, depth, done, primary_t = state
    active, o, d, contrib, bounced, medium, parent_medium = queue.pop()
    active = active & ~done
    is_primary = active & (bounced == 0)

    r = shade_rays(
        scene, lights, cfg, accel, o, d, contrib, bounced, active, sample_idx,
        time_ratio, medium, parent_medium, ri_lanes, ri_max,
    )
    if cfg.shading == "materials":
        # Push reflection then refraction: LIFO pops the refraction first.
        dropped = queue.push2(
            (r.refl_mask, r.refl_o, r.refl_d, r.refl_contrib, r.bounced, r.refl_medium,
             r.refl_parent),
            (r.refr_mask, r.refr_o, r.refr_d, r.refr_contrib, r.bounced, r.refr_medium,
             r.refr_parent))
    else:
        # Push refraction then reflection (LIFO pops reflect first).
        dropped = queue.push2((r.refr_mask, r.refr_o, r.refr_d, r.refr_contrib, r.bounced),
                              (r.refl_mask, r.refl_o, r.refl_d, r.refl_contrib, r.bounced))

    color = color + r.add_color
    color = torch.where(r.set_white[:, None], torch.ones_like(color), color)
    done = done | r.set_white
    primary_t = torch.where(is_primary, r.hit_t, primary_t)
    depth = torch.where(r.missed, torch.full_like(depth, cfg.t_max), depth)
    depth = torch.where(r.did_hit, r.hit_t, depth)
    return (color, depth, done, primary_t), dropped


# ----------------------------------------------------------------------------
# Entry points
# ----------------------------------------------------------------------------


def _build_accel(scene, cfg: RenderConfig):
    if cfg.intersector == "bvh":
        from raytracing_tests_tpu_torch.bvh.build import build_lbvh

        return build_lbvh(scene)
    if cfg.intersector == "pallas":
        if cfg.diff_mode:
            from raytracing_tests_tpu_torch.diff.fastpath import (
                fastpath_eligible, make_diff_accel)

            # render_loss sets diff_mode only where fastpath_eligible holds.
            assert fastpath_eligible(cfg), cfg
            return make_diff_accel(scene, has_motion=cfg.has_motion,
                                   mode=cfg.pallas_mode, probe_rows=cfg.probe_rows)
        if cfg.pallas_v2 and cfg.pallas_mode == "spheres":
            from raytracing_tests_tpu_torch.kernels.sweep2 import make_accel2

            return make_accel2(scene, probe_rows=cfg.probe_rows,
                               has_motion=cfg.has_motion)
        from raytracing_tests_tpu_torch.kernels.sweep import make_accel

        return make_accel(scene, cfg.pallas_mode, group=cfg.pallas_groups,
                          has_motion=cfg.has_motion)
    if cfg.intersector != "brute":
        raise NotImplementedError(f"unknown intersector {cfg.intersector!r}")
    return None


def trace_lanes(scene, lights, cfg: RenderConfig, o, d, time_ratio, sample_idx, accel=None,
                return_pops: bool = False, ri_lanes=None, ri_max=None):
    """Trace a flat batch of lanes. ``o, d: (B, 3)``; returns
    ``(color (B, 3), primary_t (B,), rays, dropped)`` where ``rays`` counts
    the rays actually processed (active pops) -- the honest rays/s numerator
    -- and ``dropped`` counts children lost to the fixed queue capacity, both
    0-dim int64 tensors on the lanes' device, as the JAX scan's carry keeps
    them (a caller reads them once, after the trace).  A lane whose sample
    turned white (emissive abort) pops its remaining queue without shading
    it; those pops count as rays, as the reference's do.

    ``return_pops``: append the number of pop steps taken (a 0-dim tensor):
    with the early exit, the steps that found a ray in some queue (the
    probe behind ``diff.train.probe_max_pops``); without it ``cfg.pops``, as
    the JAX package's scan counts.

    The pops have static shapes and read nothing on the host.  With
    ``cfg.early_exit`` the loop reads one count a pop, of the queues that
    hold a ray: the condition of the JAX package's ``while_loop``.  Without
    it (every gradient band) the ``cfg.pops`` steps run with no host read,
    as the JAX package's ``scan``, and can be captured in a CUDA graph.

    ``ri_lanes``: the slots a pop gives the lanes that read the surrounding
    RI by the containment sum or the LBVH walk (``_ri_of_lanes``), one count
    for every pop or a sequence of one per pop.  ``ri_max``: an int64 tensor
    on the lanes' device that takes (in place) the most lanes a pop needed,
    0-dim over all pops or with one entry per pop; above the slots the
    excess lanes read 1 and the trace must be made again with more.  With
    ``ri_lanes=None`` no lane can exceed them: with the early exit a pop
    takes the live lanes its condition counted (a lane that reads the RI is
    one of them), without it every lane.

    ``cfg.show_normals``: one nearest hit per lane, no shading: the colour is
    the world normal where the lane hits (else 0), ``primary_t`` the hit t
    (else ``t_max``), ``rays`` is B and ``dropped`` 0 (one pop step).

    Differentiable: with scene tensors that require grad, ``color`` carries
    the autograd graph of every pop (the early exit included: the steps it
    skips would pop nothing and add exact zeros)."""
    _check_supported(cfg)
    B = o.shape[0]
    dev = o.device
    count = lambda n: torch.full((), n, dtype=torch.int64, device=dev)  # noqa: E731
    if accel is None and cfg.intersector != "brute":
        accel = _build_accel(scene, cfg)
    if cfg.show_normals:
        t_limit = torch.full((B,), cfg.t_max, dtype=torch.float32, device=dev)
        hit = _nearest(scene, accel, o, d, time_ratio, t_limit)
        color = torch.where(hit.hit[:, None], hit.normal, torch.zeros_like(hit.normal))
        primary_t = torch.where(hit.hit, hit.t, torch.full_like(hit.t, cfg.t_max))
        return (color, primary_t, count(B), count(0)) + ((count(1),) if return_pops else ())
    out = _trace_queue(scene, lights, cfg, o, d, time_ratio, sample_idx, accel, ri_lanes, ri_max)
    color, primary_t, rays, dropped, pops = out
    if return_pops:
        return color, primary_t, rays, dropped, count(pops)
    return color, primary_t, rays, dropped


def _trace_queue(scene, lights, cfg: RenderConfig, o, d, time_ratio, sample_idx, accel,
                 ri_lanes, ri_max):
    """``trace_lanes``'s queue loop -> (color, primary_t, rays, dropped,
    the steps taken as an int)."""
    B = o.shape[0]
    dev = o.device
    count = lambda n: torch.full((), n, dtype=torch.int64, device=dev)  # noqa: E731
    queue = RayQueue.create(B, cfg.queue_capacity, dev, media=cfg.shading == "materials")
    queue.push2((
        torch.ones(B, dtype=torch.bool, device=dev), o, d,
        torch.ones(B, dtype=torch.float32, device=dev),
        torch.zeros(B, dtype=torch.int32, device=dev),
    ))
    state = (
        torch.zeros((B, 3), dtype=torch.float32, device=dev),  # accumulated color
        torch.full((B,), cfg.t_max, dtype=torch.float32, device=dev),  # last-written depth
        torch.zeros((B,), dtype=torch.bool, device=dev),  # emissive abort
        torch.full((B,), cfg.t_max, dtype=torch.float32, device=dev),  # primary hit t
    )

    # Most lanes' queues drain after 2-3 pops (sky lanes after 1), so the loop
    # exits as soon as every queue is empty instead of running the full budget.
    rays, dropped, pops = count(0), count(0), 0
    per_pop = isinstance(ri_lanes, (tuple, list))
    for i in range(cfg.pops):
        live = queue.size > 0
        slots = ri_lanes[i] if per_pop else ri_lanes
        if cfg.early_exit:
            n_live = int(torch.sum(live))  # the loop's condition
            if n_live == 0:
                break
            if slots is None:
                slots = n_live
        state, n_drop = _process_pop(
            scene, lights, cfg, queue, state, sample_idx, cfg.spp, time_ratio, accel, slots,
            ri_max[i] if ri_max is not None and ri_max.dim() == 1 else ri_max)
        rays = rays + torch.sum(live)
        dropped = dropped + n_drop
        pops += 1
    color, _, _, primary_t = state
    return color, primary_t, rays, dropped, pops


def _lane_inputs(camera, cfg: RenderConfig):
    """Flattened per-lane primary rays + sample metadata."""
    H, W, S = cfg.height, cfg.width, cfg.spp
    o, d, time_ratio = primary_rays(camera, W, H, S, cfg.aa_grid)
    B = H * W * S
    sample_idx = torch.arange(S, dtype=torch.float32, device=camera.device).expand(H, W, S)
    return (
        o.reshape(B, 3),
        d.reshape(B, 3),
        time_ratio.reshape(B),
        sample_idx.reshape(B),
    )


def _trace_frame(scene, camera, cfg: RenderConfig, lights):
    """All lanes of a frame, in ``cfg.lane_chunk`` pieces when that is set:
    (color (B, 3), primary_t (B,), rays, dropped), the counts as ints (read
    once, after the frame)."""
    o, d, time_ratio, sample_idx = _lane_inputs(camera, cfg)
    B = o.shape[0]
    accel = _build_accel(scene, cfg)
    chunk = cfg.lane_chunk or B
    colors, ts, counts = [], [], []
    for b0 in range(0, B, chunk):
        sl = slice(b0, b0 + chunk)
        co, pt, r, dr = trace_lanes(scene, lights, cfg, o[sl], d[sl],
                                    time_ratio[sl], sample_idx[sl], accel)
        colors.append(co)
        ts.append(pt)
        counts.append(torch.stack([r, dr]))
    rays, dropped = torch.stack(counts).sum(dim=0).tolist()
    if len(colors) == 1:
        return colors[0], ts[0], rays, dropped
    return torch.cat(colors), torch.cat(ts), rays, dropped


def _on_device(scene, camera, lights, device):
    dev = resolve_device(device)
    return scene.to(dev), camera.to(dev), None if lights is None else lights.to(dev)


def render_samples(scene, camera, cfg: RenderConfig, lights=None, device=None):
    """Render per-(pixel,sample) colors: returns (H, W, S, 3) plus depth.

    When ``cfg.lane_chunk`` is set, lanes are processed in fixed-size chunks
    so peak memory is bounded by chunk x objects."""
    scene, camera, lights = _on_device(scene, camera, lights, device)
    H, W, S = cfg.height, cfg.width, cfg.spp
    color, primary_t, _, _ = _trace_frame(scene, camera, cfg, lights)
    return color.reshape(H, W, S, 3), primary_t.reshape(H, W, S)


def render_stats(scene, camera, cfg: RenderConfig, lights=None, device=None):
    """Render + throughput accounting: dict(image, depth, rays, rays_dropped)
    where ``rays`` is the number of rays actually traced (active queue pops,
    i.e. primary + secondary rays; the honest numerator for Mrays/s).

    ``device=None`` means CUDA; pass ``device="cpu"`` to run on the CPU."""
    scene, camera, lights = _on_device(scene, camera, lights, device)
    H, W, S = cfg.height, cfg.width, cfg.spp
    color, primary_t, rays, dropped = _trace_frame(scene, camera, cfg, lights)
    out = finalize(color.reshape(H, W, S, 3), primary_t.reshape(H, W, S), cfg)
    out["rays"] = rays
    out["rays_dropped"] = dropped
    return out


def finalize(colors, depths, cfg: RenderConfig):
    """Per-sample gamma then mean over the sample axis; mid-sample depth.
    The normals view (``cfg.show_normals``) takes the plain mean.

    In ``cfg.diff_mode`` the gamma's floor is 1e-12, not 0: the backward of
    sqrt at a clamped 0 is inf * 0 = NaN wherever a trained colour drives a
    sample's channel negative, and the floor makes it an exact 0 (an image
    bias of 1e-6 on black samples, gradient rendering only)."""
    if cfg.show_normals:
        image = torch.mean(colors, dim=2)
    else:
        floor = 1e-12 if cfg.diff_mode else 0.0
        image = torch.mean(torch.sqrt(torch.clamp_min(colors, floor)), dim=2)
    depth = depths[:, :, cfg.spp // 2]  # the reference stores the mid sample
    return {"image": image, "depth": depth}


def render(scene: Scene, camera: Camera, cfg: RenderConfig, lights=None, device=None):
    """Full render: per-sample gamma then mean over the sample axis.

    Returns dict(image=(H, W, 3) in [0,1] (row 0 = bottom), depth=(H, W)).
    The sqrt is applied per sample before the mean."""
    colors, depths = render_samples(scene, camera, cfg, lights, device=device)
    return finalize(colors, depths, cfg)
