"""Lane-aligned megakernel renderer: every ray record stays at its lane.

Counterpart of the JAX package's ``ops/megalanes.py``.  The frame's lanes
(pixel x sample) are drained in chunks of ``chunk`` lanes; within a chunk
every per-ray record stays AT ITS LANE for the whole drain (the state is
``kernels.drain.DrainState``, on the device):

  - ``cur``   (16, C): the ray each lane is tracing right now (pool layout,
    see ``kernels.mega``).
  - ``queue`` (Q, 8, C): a per-lane LIFO stack, written and read at each
    lane's own slot; no record ever moves across lanes.
  - Reflection children continue IN PLACE and the refraction child waits on
    the stack (the reference pushes refraction then reflection and pops
    reflection first: the same LIFO order).
  - Colour accumulates with a dense aligned add.

One step is two launches: the chunked megakernel (``kernels.mega.mega_step``,
K6) and the drain's bookkeeping (``kernels.drain.drain_step``), which
updates the state in place.  No step waits for the one before it on the
host.  A chunk ends by a lagged poll: every ``POLL_EVERY`` steps the chunk's
iteration counter is copied to pinned host memory behind an event, and the
host reads a copy only when it is ``POLL_EVERY`` steps old (``_poll``), so
the card always holds queued steps.  K6 on a chunk whose lanes are all dead
adds nothing and spawns nothing, so the at most ``2 * POLL_EVERY`` steps a
chunk runs past its end change nothing but time.  The counts
(``iterations``: the steps that began with a live lane, what the JAX
package's ``cond`` counts; ``rays``; ``rays_dropped``) stay on the device,
and the frame reads them once, at its end (``_read_counts``), as the
reference's one ``jit`` does.

Scope (refused otherwise): sphere-mode scene, 'bvh' shading, no lights, no
textures.  ``ops.render`` remains the fully-featured path and
``kernels.uber.render_uber`` the fast one.
"""

from __future__ import annotations

import dataclasses

import torch

from raytracing_tests_tpu_torch.kernels.drain import DrainState, drain_step
from raytracing_tests_tpu_torch.kernels.mega import mega_step
from raytracing_tests_tpu_torch.kernels.sweep2 import make_accel2
from raytracing_tests_tpu_torch.ops.render import RenderConfig, _lane_inputs, finalize
from raytracing_tests_tpu_torch.utils.device import resolve_device

DEFAULT_CHUNK = 1 << 20
# Steps between two copies of a chunk's iteration counter, and the age of the
# copy the host reads: the fastest of 1 to 4 and the full budget on the
# headline's frames in both schedules (PERF.md; a step past a chunk's end
# costs 0.09 ms at 2^20 lanes, and the full budget runs 163 of them).
POLL_EVERY = 2


def _read_counts(*counts) -> list:
    """The frame's one host read: the 0-dim device counters as ints."""
    return torch.stack([c.to(torch.int64) for c in counts]).tolist()


def _snapshot(iters):
    """The counter's value now, copied behind the queued steps: (pinned host
    copy, event after the copy) on the card, a clone on the CPU."""
    if iters.device.type != "cuda":
        return iters.clone(), None
    host = torch.empty((), dtype=iters.dtype, pin_memory=True)
    host.copy_(iters, non_blocking=True)
    event = torch.cuda.Event()
    event.record()
    return host, event


def _poll(snapshot) -> int:
    """A chunk's host read: waits for the snapshot's event (steps old by
    then) and returns the counter's value."""
    host, event = snapshot
    if event is not None:
        event.synchronize()
    return int(host)


def _drain_chunk(accel, st: DrainState, cfg: RenderConfig, poll_every=None) -> int:
    """Drain the chunk loaded into ``st``: steps of K6 and the drain kernel,
    at most ``cfg.pops``, until a lagged poll every ``poll_every`` steps
    (default ``POLL_EVERY``) finds the chunk ended (see the module
    docstring); a period of ``cfg.pops`` or more runs the full budget and
    reads nothing.  The results stay in ``st`` (``color``,
    ``primary_t``, ``rays``, ``iters``, ``dropped``).  Returns the steps run.

    The counter after step s is s + 1 while the chunk lives and stops
    growing when it ends, so a copy taken after step s that reads less than
    s + 1 says that step s began with every lane dead."""
    poll_every = POLL_EVERY if poll_every is None else poll_every
    if poll_every < 1:
        raise ValueError(f"poll_every={poll_every}: a period of at least one step")
    pending = []
    for step in range(cfg.pops):
        misc, refr, refl, rlane, llane = mega_step(
            accel, st.cur, st.lane, has_dielectrics=cfg.has_dielectrics, spp=cfg.spp,
            max_bounces=cfg.max_bounces, t_max=cfg.t_max, bg=cfg.background)
        drain_step(st, misc, refr, refl, rlane, llane, step=step, t_max=cfg.t_max)
        if (step + 1) % poll_every or step + 1 == cfg.pops:
            continue
        pending.append((step, _snapshot(st.iters)))
        if len(pending) > 1:
            old_step, snapshot = pending.pop(0)
            if _poll(snapshot) <= old_step:
                return step + 1
    return cfg.pops


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
    (rgb (3, B), primary_t (B,), rays_per_lane (B,) i32, iterations, dropped),
    the last two 0-dim device tensors."""
    B = o.shape[0]
    dev = o.device
    n = -(-B // C)
    st = DrainState.create(C, cfg.queue_capacity, dev)
    rgb = torch.empty((3, n * C), dtype=torch.float32, device=dev)
    primary_t = torch.empty((n * C,), dtype=torch.float32, device=dev)
    rays = torch.empty((n * C,), dtype=torch.int32, device=dev)
    iters = torch.zeros((), dtype=torch.int32, device=dev)
    for c0 in range(0, B, C):
        sl = slice(c0, c0 + C)
        co, cd, ctr, lane = o[sl], d[sl], time_ratio[sl], ids[sl]
        pad = C - lane.shape[0]
        if pad:  # the ragged last chunk: padding lanes are inactive
            co = torch.nn.functional.pad(co, (0, 0, 0, pad))
            cd = torch.nn.functional.pad(cd, (0, 0, 0, pad))
            ctr = torch.nn.functional.pad(ctr, (0, pad))
            lane = torch.nn.functional.pad(lane, (0, pad), value=-1)
        st.load(_init_chunk(co, cd, ctr, lane, cfg), lane, cfg.t_max)
        _drain_chunk(accel, st, cfg)
        rgb[:, c0:c0 + C].copy_(st.color)
        primary_t[c0:c0 + C].copy_(st.primary_t)
        rays[c0:c0 + C].copy_(st.rays)
        iters.add_(st.iters)
    return rgb[:, :B], primary_t[:B], rays[:B], iters, st.dropped


def render_megalanes(scene, camera, cfg: RenderConfig, lights=None,
                     chunk: int = DEFAULT_CHUNK, gr: int = 32,
                     schedule: str = "sorted", device=None):
    """Full render via the lane-aligned megakernel drain;
    dict(image, depth, rays, iterations, rays_dropped).

    ``schedule='sorted'`` runs a 1-spp prepass that measures each PIXEL's
    ray-tree size, then drains pixels in sorted-workload order so every chunk
    carries near-uniform trees and ends together (the JAX package's chunks
    then exit early; here they run fewer live steps).  Results are
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

    iters = torch.zeros((), dtype=torch.int32, device=dev)
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
    iterations, = _read_counts(iters + dit)

    if perm is not None:
        inv = torch.argsort(perm)
        rgb = rgb.reshape(3, P, S)[:, inv].reshape(3, B)
        primary_t = primary_t.reshape(P, S)[inv].reshape(B)

    out = finalize(rgb.T.reshape(H, W, S, 3), primary_t.reshape(H, W, S), cfg)
    out["rays"] = rays
    out["iterations"] = iterations
    out["rays_dropped"] = dropped
    return out
