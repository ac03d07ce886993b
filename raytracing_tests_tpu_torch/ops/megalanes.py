"""Lane-aligned megakernel renderer: every ray record stays at its lane.

Counterpart of the JAX package's ``ops/megalanes.py``.  The frame's lanes
(pixel x sample) are drained in chunks of ``chunk`` lanes; within a chunk
every per-ray record stays AT ITS LANE for the whole drain:

  - ``cur``   (16, C): the ray each lane is tracing right now (pool layout,
    see ``kernels.mega``).
  - ``queue`` (Q, 8, C): a per-lane LIFO stack, written and read at each
    lane's own slot; no record ever moves across lanes.
  - Reflection children continue IN PLACE and the refraction child waits on
    the stack (the reference pushes refraction then reflection and pops
    reflection first: the same LIFO order).
  - Colour accumulates with a dense aligned add.

One iteration is one launch of the chunked megakernel (``kernels.mega.
mega_step``) plus a dozen elementwise passes over the chunk; a chunk ends when
no lane is alive (one host read per iteration) or after ``cfg.pops``
iterations.

Scope (refused otherwise): sphere-mode scene, 'bvh' shading, no lights, no
textures.  ``ops.render`` remains the fully-featured path and
``kernels.uber.render_uber`` the fast one.
"""

from __future__ import annotations

import dataclasses

import torch

from raytracing_tests_tpu_torch.kernels import mega
from raytracing_tests_tpu_torch.kernels.mega import POOL_ROWS, mega_step
from raytracing_tests_tpu_torch.kernels.sweep2 import make_accel2
from raytracing_tests_tpu_torch.ops.render import RenderConfig, _lane_inputs, finalize
from raytracing_tests_tpu_torch.utils.device import resolve_device

DEFAULT_CHUNK = 1 << 20
QUEUE_ROWS = 8  # o(3) d(3) contrib bounced: what a stacked record keeps


def _drain_chunk(accel, cur, lane, cfg: RenderConfig):
    """Drain one chunk of lanes to completion; returns
    (color (3, C), primary_t (C,), rays_per_lane (C,) i32, iters, dropped)."""
    C = cur.shape[1]
    Q = cfg.queue_capacity
    dev = cur.device
    f32 = torch.float32

    # Queued records keep only the 8 live rows (o, d, contrib, bounced): omt is
    # a per-lane constant and t_limit is cfg.t_max for every child, both put
    # back on pop.  Slot Q is scratch: lanes that do not push write there.
    omt_row = cur[mega.P_OMT:mega.P_OMT + 1].clone()
    tmax_row = torch.full((1, C), cfg.t_max, dtype=f32, device=dev)
    spare = torch.zeros((POOL_ROWS - 10, C), dtype=f32, device=dev)
    queue = torch.zeros((Q + 1, QUEUE_ROWS, C), dtype=f32, device=dev)
    qsize = torch.zeros((C,), dtype=torch.int64, device=dev)
    color = torch.zeros((3, C), dtype=f32, device=dev)
    primary_t = torch.full((C,), cfg.t_max, dtype=f32, device=dev)
    rays = torch.zeros((C,), dtype=torch.int32, device=dev)
    dropped = torch.zeros((), dtype=torch.int64, device=dev)
    none = torch.full_like(lane, -1)

    it = 0
    while it < cfg.pops and bool((lane >= 0).any()):
        misc, refr, refl, rlane, llane = mega_step(
            accel, cur, lane, has_dielectrics=cfg.has_dielectrics, spp=cfg.spp,
            max_bounces=cfg.max_bounces, t_max=cfg.t_max, bg=cfg.background)

        active = lane >= 0
        color = color + misc[0:3]  # the kernel zeroes inactive lanes
        if it == 0:
            primary_t = torch.where(active, misc[3], primary_t)
        rays = rays + active.to(torch.int32)  # per-lane ray-tree size

        has_refl = llane >= 0
        has_refr = rlane >= 0

        # Both children: the refraction waits on the per-lane stack while the
        # reflection continues in place (reference LIFO order).
        push = has_refl & has_refr
        can = qsize < Q
        do_push = push & can
        dropped = dropped + torch.sum(push & ~can)
        refr8 = torch.cat([refr[0:6], refr[8:10]])
        slot = torch.where(do_push, qsize, torch.full_like(qsize, Q))
        queue.scatter_(0, slot.expand(1, QUEUE_ROWS, C), refr8[None])
        qsize = qsize + do_push.to(torch.int64)

        # Continue in place, else pop the stack, else the lane dies.
        need_pop = active & ~has_refl & ~has_refr
        do_pop = need_pop & (qsize > 0)
        top = torch.clamp_min(qsize - 1, 0)
        popped8 = torch.gather(queue, 0, top.expand(1, QUEUE_ROWS, C))[0]
        popped8 = torch.where(do_pop, popped8, torch.zeros_like(popped8))
        qsize = qsize - do_pop.to(torch.int64)
        popped = torch.cat([popped8[0:6], omt_row, tmax_row, popped8[6:8], spare])

        cur = torch.where(has_refl, refl, torch.where(has_refr, refr, popped))
        lane = torch.where(has_refl | has_refr | do_pop, lane, none)
        it += 1

    return color, primary_t, rays, it, dropped


def _init_chunk(o, d, time_ratio, lane, cfg: RenderConfig):
    """(C, 3) x2 + (C,) x2 -> (16, C) pool-layout primary records; padding
    lanes (lane < 0) carry a dead ray and no contribution."""
    C = o.shape[0]
    z = torch.zeros((C,), dtype=torch.float32, device=o.device)
    live = (lane >= 0).to(torch.float32)
    return torch.stack([
        o[:, 0], o[:, 1], o[:, 2],
        d[:, 0] * live, d[:, 1] * live, d[:, 2] * live,
        1.0 - time_ratio, torch.full_like(z, cfg.t_max),
        live, z, z, z, z, z, z, z,
    ]).contiguous()


def _drain_lanes(accel, o, d, time_ratio, ids, cfg: RenderConfig, C: int):
    """Drain a flat lane population in chunks of C; returns
    (rgb (3, B), primary_t (B,), rays_per_lane (B,), iters, dropped)."""
    B = o.shape[0]
    colors, pts, rayss = [], [], []
    iters = 0
    dropped = torch.zeros((), dtype=torch.int64, device=o.device)
    for c0 in range(0, B, C):
        sl = slice(c0, c0 + C)
        co, cd, ctr, lane = o[sl], d[sl], time_ratio[sl], ids[sl]
        pad = C - lane.shape[0]
        if pad:  # the ragged last chunk: padding lanes are inactive
            co = torch.nn.functional.pad(co, (0, 0, 0, pad))
            cd = torch.nn.functional.pad(cd, (0, 0, 0, pad))
            ctr = torch.nn.functional.pad(ctr, (0, pad))
            lane = torch.nn.functional.pad(lane, (0, pad), value=-1)
        col, pt, r, it, dr = _drain_chunk(
            accel, _init_chunk(co, cd, ctr, lane, cfg), lane.contiguous(), cfg)
        colors.append(col)
        pts.append(pt)
        rayss.append(r)
        iters += it
        dropped = dropped + dr
    rgb = torch.cat(colors, dim=1)[:, :B]
    return rgb, torch.cat(pts)[:B], torch.cat(rayss)[:B], iters, dropped


def render_megalanes(scene, camera, cfg: RenderConfig, lights=None,
                     chunk: int = DEFAULT_CHUNK, gr: int = 32,
                     schedule: str = "sorted", device=None):
    """Full render via the lane-aligned megakernel drain;
    dict(image, depth, rays, iterations, rays_dropped).

    ``schedule='sorted'`` runs a 1-spp prepass that measures each PIXEL's
    ray-tree size, then drains pixels in sorted-workload order so every chunk
    carries near-uniform trees and ends early together.  Results are
    un-permuted with one pixel-level gather.  ``device=None`` means CUDA
    (raises when absent); ``device="cpu"`` runs the plain versions."""
    dev = resolve_device(device)
    if lights is not None:
        raise NotImplementedError("megalanes path: no emissive lights (use the queue renderer)")
    if cfg.shading != "bvh":
        raise NotImplementedError("megalanes path implements INW ('bvh') shading only")
    if cfg.pallas_mode != "spheres":
        raise ValueError("megalanes path is sphere-mode")
    if scene.textures is not None:
        raise NotImplementedError("megalanes path is untextured")
    if schedule not in ("sorted", "natural"):
        raise ValueError(f"schedule={schedule!r}: 'sorted' or 'natural'")
    scene, camera = scene.to(dev), camera.to(dev)
    H, W, S = cfg.height, cfg.width, cfg.spp
    B = H * W * S
    P = H * W
    C = min(chunk, B)
    accel = make_accel2(scene, gr=gr, has_motion=cfg.has_motion,
                        probe_rows=cfg.probe_rows, sort_origin=camera.position)
    o, d, time_ratio, _ = _lane_inputs(camera, cfg)
    ids = torch.arange(B, dtype=torch.int32, device=dev)

    iters = 0
    perm = None
    if schedule == "sorted" and S > 1:
        pre_cfg = dataclasses.replace(cfg, spp=1)
        po, pd, ptr, _ = _lane_inputs(camera, pre_cfg)
        _, _, sizes, iters, _ = _drain_lanes(
            accel, po, pd, ptr, torch.arange(P, dtype=torch.int32, device=dev),
            pre_cfg, min(C, P))
        perm = torch.argsort(sizes, stable=True)  # (P,) ascending pixel workload
        o = o.reshape(P, S, 3)[perm].reshape(B, 3)
        d = d.reshape(P, S, 3)[perm].reshape(B, 3)
        time_ratio = time_ratio.reshape(P, S)[perm].reshape(B)
        ids = ids.reshape(P, S)[perm].reshape(B)

    rgb, primary_t, rays_lane, dit, dropped = _drain_lanes(
        accel, o, d, time_ratio, ids, cfg, C)
    del o, d
    rays = torch.sum(rays_lane.to(torch.int64))

    if perm is not None:
        inv = torch.argsort(perm)
        rgb = rgb.reshape(3, P, S)[:, inv].reshape(3, B)
        primary_t = primary_t.reshape(P, S)[inv].reshape(B)

    out = finalize(rgb.T.reshape(H, W, S, 3), primary_t.reshape(H, W, S), cfg)
    out["rays"] = rays
    out["iterations"] = iters + dit
    out["rays_dropped"] = dropped
    return out
