"""Tiled progressive rendering with the reference's spiral schedule.

The reference's alternative render loop traces K tiles per frame, walking tiles
in a spiral outward from the image centre so the fovea refines first.  Here
the spiral is a precomputed order; each step traces the lanes of the next K
tiles through the queue renderer (``ops.render.trace_lanes``) and writes
their pixels into a persistent canvas: a progressive preview loop for
interactive use, while ``render`` and the mesh path remain the throughput
paths.
"""

from __future__ import annotations

from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from raytracing_tests_tpu_torch.ops.render import (
    Lights, RenderConfig, _build_accel, _lane_inputs, _on_device, trace_lanes,
)
from raytracing_tests_tpu_torch.scene.types import Camera, Scene


def spiral_tile_order(nx: int, ny: int) -> np.ndarray:
    """Tile indices (k, 2) spiralling outward from the grid centre.

    The reference's ring walk: the centre tile first, then for ring r = 1,
    2, ... the ring's tiles in angular order, skipping tiles outside the
    grid."""
    cx, cy = (nx - 1) / 2.0, (ny - 1) / 2.0
    tiles = [(x, y) for y in range(ny) for x in range(nx)]

    # ring index = Chebyshev distance from the centre; stable angular order inside
    def key(t):
        x, y = t
        ring = max(abs(x - cx), abs(y - cy))
        ang = np.arctan2(y - cy, x - cx)
        return (round(ring * 2) / 2, ang)

    return np.asarray(sorted(tiles, key=key), dtype=np.int32)


def _tile_image(scene, lights, cfg: RenderConfig, o, d, time_ratio, sample_idx, accel):
    """One tile's lanes through the queue renderer -> (hw, 3) pixels: the
    per-sample ``sqrt(max(c, 0))`` mean, in every mode."""
    color, _, _, _ = trace_lanes(scene, lights, cfg, o, d, time_ratio, sample_idx, accel)
    hw = o.shape[0] // cfg.spp
    return torch.mean(torch.sqrt(torch.clamp_min(color.reshape(hw, cfg.spp, 3), 0.0)), dim=1)


def render_progressive(
    scene: Scene,
    camera: Camera,
    cfg: RenderConfig,
    lights: Optional[Lights] = None,
    tile: Tuple[int, int] = (64, 64),
    tiles_per_step: int = 4,
    device=None,
) -> Iterator[dict]:
    """Yield dict(image, done_fraction) after each batch of spiral tiles.

    ``image`` is a copy of the full canvas, on the render's device, with the
    tiles not yet traced still black.  The accel and the frame's lanes are
    built once; each tile traces its own.  ``device=None`` means CUDA
    (raises when absent); ``device="cpu"`` runs on the CPU."""
    scene, camera, lights = _on_device(scene, camera, lights, device)
    H, W, S = cfg.height, cfg.width, cfg.spp
    tw, th = tile
    nx, ny = -(-W // tw), -(-H // th)
    order = spiral_tile_order(nx, ny)

    accel = _build_accel(scene, cfg)
    lanes = [x.reshape((H, W, S) + tuple(x.shape[1:])) for x in _lane_inputs(camera, cfg)]

    canvas = torch.zeros((H, W, 3), dtype=torch.float32, device=scene.device)
    done = 0
    for batch_start in range(0, len(order), tiles_per_step):
        for tx, ty in order[batch_start:batch_start + tiles_per_step]:
            x0, y0 = int(tx) * tw, int(ty) * th
            x1, y1 = min(x0 + tw, W), min(y0 + th, H)
            hh, ww = y1 - y0, x1 - x0
            o, d, tr, si = (a[y0:y1, x0:x1].reshape((hh * ww * S,) + tuple(a.shape[3:]))
                            for a in lanes)
            canvas[y0:y1, x0:x1] = _tile_image(scene, lights, cfg, o, d, tr, si,
                                               accel).reshape(hh, ww, 3)
            done += 1
        yield {"image": canvas.clone(), "done_fraction": done / (nx * ny)}
