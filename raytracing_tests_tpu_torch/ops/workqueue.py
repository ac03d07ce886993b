"""Work-queue renderer: the whole bounce loop over one write-once ray pool.

Counterpart of the JAX package's ``ops/workqueue.py``:

  - The ray pool is a write-once queue in device memory: primaries occupy
    [0, B); every processed chunk appends its compacted children at the write
    cursor.
  - One loop drains the queue chunk by chunk.  Because children from
    successive generations land contiguously, small bounce generations
    COALESCE into full chunks, so the sweep kernel sees full batches to the
    end of the frame.

Same ray tree and shading as the queue renderer (``shade_rays``), emissive
lights included; summed radiance identical up to float32 ordering.  Rays are
dropped only on pool overflow (capacity ~3.2x the primary count), and counted.
Materials shading is refused: its records would need the medium stack the
pool does not carry.
"""

from __future__ import annotations

import numpy as np
import torch

from raytracing_tests_tpu_torch.ops.render import (
    RenderConfig, _build_accel, _lane_inputs, finalize, shade_rays,
)
from raytracing_tests_tpu_torch.utils.device import resolve_device

DEFAULT_CHUNK = 262144
N_FIELDS = 8  # o(3) d(3) contrib bounced

_PERM_CACHE = {}


def tile_order_perm(width: int, height: int, spp: int, tile: int):
    """Permutation placing lanes in (tile_y, tile_x, y, x, s) order (numpy
    int32).

    A chunk then covers square pixel neighbourhoods instead of full image
    rows, so its rays walk the same groups.  Lane IDS are unchanged — only the
    processing order permutes, and the indexed accumulation is order-blind."""
    key = (width, height, spp, tile)
    if key not in _PERM_CACHE:
        ids = np.arange(width * height * spp, dtype=np.int32).reshape(height, width, spp)
        ph = -(-height // tile) * tile
        pw = -(-width // tile) * tile
        padded = np.full((ph, pw, spp), -1, np.int32)
        padded[:height, :width] = ids
        t = (
            padded.reshape(ph // tile, tile, pw // tile, tile, spp)
            .transpose(0, 2, 1, 3, 4)
            .reshape(-1)
        )
        _PERM_CACHE[key] = t[t >= 0]  # drop pad entries -> exactly B lanes
    return _PERM_CACHE[key]


def _drain_queue(scene, accel, lights, pool_fields, pool_lane, write0: int,
                 cfg: RenderConfig, chunk: int, n_lanes: int, max_iters: int):
    """Drain the pool (``pool_fields`` (8, P) with the primaries in [:, :B],
    ``pool_lane`` (P,), both updated in place); returns
    (rgb (3, B), primary_t (B,), rays, iters, dropped).  A lane whose sample
    hit an emissive object ends white, whatever else its tree added."""
    C = chunk
    B = n_lanes
    P = pool_lane.shape[0]
    dev = pool_lane.device
    f32 = torch.float32

    color = torch.zeros((3 * B,), dtype=f32, device=dev)  # flat rgb planes
    white = torch.zeros((B,), dtype=torch.bool, device=dev)  # emissive abort
    primary_t = torch.full((B,), cfg.t_max, dtype=f32, device=dev)
    rays = torch.zeros((), dtype=torch.int64, device=dev)
    slot = torch.arange(C, device=dev)
    read, write, it, dropped = 0, write0, 0, 0
    while read < write and it < max_iters:
        avail = min(C, write - read)
        f = pool_fields[:, read:read + C]
        l = pool_lane[read:read + C]
        l = torch.where(slot < avail, l, torch.full_like(l, -1))

        # (C, 3) rows as the queue renderer holds them: the same reductions
        # in the same order, so the two renderers trace the same tree
        o = f[0:3].T.contiguous()
        d = f[3:6].T.contiguous()
        contrib, bounced = f[6], f[7].to(torch.int32)
        active = l >= 0
        sample_idx = (l % cfg.spp).to(f32)
        time_ratio = sample_idx / cfg.spp

        r = shade_rays(scene, lights, cfg, accel, o, d, contrib, bounced, active,
                       sample_idx, time_ratio)

        la = l[active].long()
        add = r.add_color[active]
        color.index_add_(0, torch.cat([la, la + B, la + 2 * B]),
                         torch.cat([add[:, 0], add[:, 1], add[:, 2]]))
        if lights is not None:
            white[l[r.set_white].long()] = True
        is_primary = active & (bounced == 0)
        primary_t[l[is_primary].long()] = r.hit_t[is_primary]

        # Children, compacted stably: refractions before reflections, in lane
        # order, appended at the write cursor.
        none = torch.full_like(l, -1)
        ch_lane = torch.cat([torch.where(r.refr_mask, l, none),
                             torch.where(r.refl_mask, l, none)])
        bf = r.bounced.to(f32)
        ch = torch.cat([
            torch.cat([r.refr_o.T, r.refr_d.T, r.refr_contrib[None], bf[None]]),
            torch.cat([r.refl_o.T, r.refl_d.T, r.refl_contrib[None], bf[None]]),
        ], dim=1)  # (8, 2C)
        valid = ch_lane >= 0
        packed_lane = ch_lane[valid]
        n_children = packed_lane.shape[0]

        w = min(write, P - 2 * C)  # clamp on overflow (drops late rays)
        pool_fields[:, w:w + n_children] = ch[:, valid]
        pool_lane[w:w + n_children] = packed_lane
        new_write = min(write + n_children, P - 2 * C)
        dropped += write + n_children - new_write

        rays = rays + torch.sum(active)
        read, write, it = read + avail, new_write, it + 1

    rgb = torch.where(white, torch.ones_like(color.reshape(3, B)), color.reshape(3, B))
    return rgb, primary_t, rays, it, dropped


def render_workqueue(scene, camera, cfg: RenderConfig, lights=None,
                     chunk: int = DEFAULT_CHUNK, pool_factor: float = 3.2,
                     tile: int = 0, device=None):
    """Full render; dict(image, depth, rays, iterations, rays_dropped).

    ``tile`` > 1 orders the pool by pixel tiles (helps culling at low spp; the
    permutation gather over all lanes is paid up front).  ``device=None``
    means CUDA (raises when absent); ``device="cpu"`` runs on the CPU."""
    dev = resolve_device(device)
    if cfg.shading != "bvh":
        raise NotImplementedError(
            "workqueue pool records carry no medium stack; materials shading "
            "runs on the queue renderer (render_stats)")
    scene, camera = scene.to(dev), camera.to(dev)
    lights = None if lights is None else lights.to(dev)
    H, W, S = cfg.height, cfg.width, cfg.spp
    B = H * W * S
    accel = _build_accel(scene, cfg)
    o, d, _, _ = _lane_inputs(camera, cfg)

    chunk = min(chunk, -(-B // 128) * 128)
    P = max(int(B * pool_factor), B + 4 * chunk)
    P = -(-P // chunk) * chunk

    if tile and tile > 1:
        lane0 = torch.from_numpy(tile_order_perm(W, H, S, tile)).to(dev)
        o, d = o[lane0.long()], d[lane0.long()]
    else:
        lane0 = torch.arange(B, dtype=torch.int32, device=dev)

    fields = torch.zeros((N_FIELDS, P), dtype=torch.float32, device=dev)
    fields[0:3, :B] = o.T
    fields[3:6, :B] = d.T
    fields[6, :B] = 1.0
    del o, d
    lane = torch.full((P,), -1, dtype=torch.int32, device=dev)
    lane[:B] = lane0

    max_iters = P // chunk + 8 * (cfg.max_bounces + 1)
    rgb, primary_t, rays, iters, dropped = _drain_queue(
        scene, accel, lights, fields, lane, B, cfg, chunk, B, max_iters)
    out = finalize(rgb.T.reshape(H, W, S, 3), primary_t.reshape(H, W, S), cfg)
    out["rays"] = rays
    out["iterations"] = iters
    out["rays_dropped"] = dropped
    return out
