"""Stackless lane-parallel LBVH traversal.

A parent-link state machine: every lane carries (node, state) and the whole
batch advances in lockstep; finished lanes idle until all are done.
Transitions per step:

  DOWN  at an internal hit node  -> left child (DOWN)
  DOWN  at a leaf / missed node  -> (UP)                [a leaf also intersects]
  UP    from a left child        -> right sibling (DOWN)
  UP    from a right child       -> parent (UP); the root -> done

Node AABBs are pruned against the lane's current best t.

This is the reference-semantics oracle of the JAX package's
``bvh/traverse.py``, not a performance path: every step is some forty
elementwise operations over every lane, and every lane waits for the deepest.
The sweeps (``kernels.sweep``, ``kernels.sweep2``) are the fast intersectors.

The loop's exit.  The JAX package stops when every lane is done, or after
``max_steps = 3 * n_nodes + 2`` steps.  Reading ``done.all()`` on the host
after every step would cost one synchronisation a step, so ``_walk`` reads it
every ``CHECK_EVERY`` steps instead.  That changes no result: a finished lane
is a fixed point of the step (``is_down`` and ``is_up`` are both false, so its
node, state, best t and object stay as they are), so the steps run between
the last lane's finish and the next check leave every output as it was.  The
walk never runs past ``max_steps``.  ``_walk`` returns the steps it ran; they
exceed the steps the last lane needed by less than ``CHECK_EVERY``.
"""

from __future__ import annotations

import torch

from raytracing_tests_tpu_torch.bvh.build import LBVH
from raytracing_tests_tpu_torch.core import geometry, linalg
from raytracing_tests_tpu_torch.ops.intersect import BIG_T, Hit
from raytracing_tests_tpu_torch.scene.types import Scene

_DOWN, _UP = 0, 1
CHECK_EVERY = 16  # steps between host reads of ``done.all()``


def _walk(bvh: LBVH, step, carry):
    """Run ``step(carry) -> carry`` until every lane is done or
    ``3 * n_nodes + 2`` steps have run -> (carry, steps run).  ``carry[2]``
    is the lanes' ``done`` mask."""
    max_steps = 3 * bvh.left.shape[0] + 2
    steps = 0
    while steps < max_steps and not bool(carry[2].all()):
        for _ in range(min(CHECK_EVERY, max_steps - steps)):
            carry = step(carry)
        steps += min(CHECK_EVERY, max_steps - steps)
    return carry, steps


def _links(bvh: LBVH):
    """The node arrays as int64 index tensors."""
    return bvh.left.long(), bvh.right.long(), bvh.parent.long(), bvh.obj_id.long()


def _move(left, right, parent, cur, state, done, is_down, descend):
    """The parent-link transitions shared by both walks -> (cur, state, done)."""
    to_up = is_down & ~descend  # a leaf or a missed node
    is_up = (state == _UP) & ~done
    par = parent[cur]
    at_root = par < 0
    par_safe = par.clamp_min(0)
    was_left = ~at_root & (left[par_safe] == cur)
    up_left = is_up & ~at_root & was_left
    up_right = is_up & ~at_root & ~was_left
    new_done = done | (is_up & at_root)
    new_cur = torch.where(descend, left[cur],
                          torch.where(up_left, right[par_safe], torch.where(up_right, par, cur)))
    new_state = torch.where(descend | up_left, _DOWN,
                            torch.where(to_up | up_right, _UP, state))
    return new_cur, new_state, new_done


def _local(rot, v):
    """``R^T v`` per lane with its three terms summed in the order x, y, z.

    The walk's t must not depend on the device: a reduction such as
    ``torch.sum`` adds in an order of the device's choosing, and a last-ulp
    difference in t flips grazing rays.  Written out, every operation is one
    correctly rounded IEEE operation on any device, in the order the sweeps'
    plain versions use (``kernels.sweep._generic_local``)."""
    return torch.stack([rot[:, 0, i] * v[:, 0] + rot[:, 1, i] * v[:, 1] + rot[:, 2, i] * v[:, 2]
                        for i in range(3)], dim=-1)


def _ellipsoid_t(lo, ld, scale):
    """``geometry.ray_ellipsoid_t`` with its dot products written out (see
    ``_local``)."""
    e, f = lo / scale, ld / scale
    dot = lambda a, b: a[:, 0] * b[:, 0] + a[:, 1] * b[:, 1] + a[:, 2] * b[:, 2]  # noqa: E731
    a, half_b, c = dot(f, f), dot(e, f), dot(e, e) - 1.0
    disc = half_b * half_b - a * c
    ok = (disc > 0.0) & (a > 1e-30)
    sq = torch.sqrt(torch.where(ok, disc, torch.ones_like(disc)))
    a_safe = torch.where(ok, a, torch.ones_like(a))
    t0 = (-half_b - sq) / a_safe
    t1 = (-half_b + sq) / a_safe
    t = torch.where((t0 > t1) | (t0 < 0.0), t1, t0)
    return torch.where(ok & (t > 0.0), t, torch.full_like(t, -1.0))


def _leaf_hit_t(scene: Scene, obj, o, d, time_ratio):
    """Primitive t for one gathered object per lane (world-space rays)."""
    shift = (1.0 - time_ratio)[:, None] * scene.delta_position[obj]
    rot = scene.rotation[obj]
    lo = _local(rot, o - scene.position[obj] + shift)
    ld = _local(rot, d)
    scale, otype = scene.scale[obj], scene.obj_type[obj]
    t = torch.where(otype == geometry.ELLIPSOID, _ellipsoid_t(lo, ld, scale),
                    torch.where(otype == geometry.CUBOID, geometry.ray_cuboid_t(lo, ld, scale),
                                torch.full_like(lo[:, 0], -1.0)))
    return torch.where(scene.valid[obj] & (t > 0.0), t, torch.full_like(t, BIG_T))


def _traverse(bvh: LBVH, scene: Scene, o, d, time_ratio, t_limit):
    """Shared core: nearest (t, obj) per lane, BIG_T / -1 on a miss."""
    B = o.shape[0]
    dev = o.device
    left, right, parent, obj_id = _links(bvh)

    def step(carry):
        cur, state, done, t_best, obj_best = carry
        is_down = (state == _DOWN) & ~done
        aabb_hit = geometry.ray_aabb_hit(bvh.bb_min[cur], bvh.bb_max[cur], o, d, t_best)
        obj = obj_id[cur]
        is_leaf = obj >= 0
        # Leaf intersection, masked: every lane pays one primitive test per
        # step, the price of lockstep.
        t_leaf = _leaf_hit_t(scene, obj.clamp_min(0), o, d, time_ratio)
        take = is_down & is_leaf & aabb_hit & (t_leaf < t_best)
        t_best = torch.where(take, t_leaf, t_best)
        obj_best = torch.where(take, obj, obj_best)
        descend = is_down & ~is_leaf & aabb_hit
        cur, state, done = _move(left, right, parent, cur, state, done, is_down, descend)
        return cur, state, done, t_best, obj_best

    carry = (
        torch.zeros(B, dtype=torch.int64, device=dev),  # cur node (root = 0)
        torch.full((B,), _DOWN, dtype=torch.int64, device=dev),  # state
        torch.zeros(B, dtype=torch.bool, device=dev),  # done
        torch.clamp_max(torch.full((B,), BIG_T, device=dev), t_limit),  # best t (also prunes)
        torch.full((B,), -1, dtype=torch.int64, device=dev),  # best obj
    )
    (_, _, _, t_best, obj_best), _ = _walk(bvh, step, carry)
    hit = (obj_best >= 0) & (t_best < t_limit)
    return (torch.where(hit, t_best, torch.full_like(t_best, BIG_T)),
            torch.where(hit, obj_best, torch.full_like(obj_best, -1)).to(torch.int32))


def traverse_nearest(bvh: LBVH, scene: Scene, o, d, time_ratio, t_limit) -> Hit:
    """Nearest-hit query with the ``Hit`` contract of
    ``ops.intersect.intersect_brute``: ``t`` bounded (1.0) and ``obj`` 0 on
    a miss, the world normal and the unit-space hit position recomputed from
    the winner's row."""
    t, obj = _traverse(bvh, scene, o, d, time_ratio, t_limit)
    hit = obj >= 0
    obj_safe = obj.clamp_min(0)
    t_safe = torch.where(hit, t, torch.ones_like(t))  # bounded for miss lanes

    oi = obj_safe.long()
    rot = scene.rotation[oi]
    scale = scene.scale[oi]
    shift = (1.0 - time_ratio)[:, None] * scene.delta_position[oi]
    lo = linalg.apply_rotation_t(rot, o - scene.position[oi] + shift)
    ld = linalg.apply_rotation_t(rot, d)
    p_local = lo + t_safe[:, None] * ld
    n_local = geometry.primitive_normal(p_local, scale, scene.obj_type[oi])
    n_world = linalg.apply_rotation(rot, n_local)
    return Hit(t=t_safe, obj=obj_safe, hit=hit, normal=n_world, local_pos=p_local / scale)


def traverse_nearest_obj(bvh: LBVH, scene: Scene, o, d, time_ratio, t_limit):
    """Occlusion query: index of the nearest object before ``t_limit`` (-1
    none), as ``ops.intersect.occluded_nearest_obj``."""
    _, obj = _traverse(bvh, scene, o, d, time_ratio, t_limit)
    return obj


def traverse_point_ri(bvh: LBVH, scene: Scene, point, time_ratio):
    """Surrounding refractive index at ``point`` (B, 3) through the BVH.

    Walks the tree top-down over the nodes whose AABB contains the point and
    tests the exact primitive at the leaves, as
    ``ops.intersect.surrounding_refractive_index`` does over every object:
    RI-1 containers are air, and the RI is the mean over the containers when
    their sum exceeds 1.  O(depth) instead of O(N)."""
    B = point.shape[0]
    dev = point.device
    left, right, parent, obj_id = _links(bvh)

    def step(carry):
        cur, state, done, acc, cnt = carry
        is_down = (state == _DOWN) & ~done
        inside_aabb = torch.all((point >= bvh.bb_min[cur]) & (point <= bvh.bb_max[cur]), dim=-1)
        obj = obj_id[cur]
        is_leaf = obj >= 0
        # Exact containment test at the leaves (masked every step).
        o = obj.clamp_min(0)
        shift = (1.0 - time_ratio)[:, None] * scene.delta_position[o]
        p = _local(scene.rotation[o], point - scene.position[o] + shift) / scene.scale[o]
        ri, otype = scene.refractive_index[o], scene.obj_type[o]
        # geometry.point_in_unit_primitive, its squared norm written out
        in_e = p[:, 0] * p[:, 0] + p[:, 1] * p[:, 1] + p[:, 2] * p[:, 2] <= 1.0
        in_c = torch.all(p.abs() <= 0.5, dim=-1)
        inside = (torch.where(otype == geometry.ELLIPSOID, in_e,
                              (otype == geometry.CUBOID) & in_c)
                  & scene.valid[o] & (ri != 1.0))
        take = is_down & is_leaf & inside_aabb & inside
        acc = acc + torch.where(take, ri, torch.zeros_like(ri))
        cnt = cnt + take.to(torch.float32)
        descend = is_down & ~is_leaf & inside_aabb
        cur, state, done = _move(left, right, parent, cur, state, done, is_down, descend)
        return cur, state, done, acc, cnt

    carry = (
        torch.zeros(B, dtype=torch.int64, device=dev),
        torch.full((B,), _DOWN, dtype=torch.int64, device=dev),
        torch.zeros(B, dtype=torch.bool, device=dev),
        torch.zeros(B, dtype=torch.float32, device=dev),  # RI sum
        torch.zeros(B, dtype=torch.float32, device=dev),  # containers
    )
    (_, _, _, acc, cnt), _ = _walk(bvh, step, carry)
    return torch.where(acc > 1.0, acc / torch.clamp_min(cnt, 1.0), torch.ones_like(acc))
