"""Primary-ray generation with thin-lens depth of field.

Screen-space direction from an UNNORMALIZED right/up camera basis (faithful to
the reference, which skips the normalize), then a sunflower aperture offset
that pivots each sample ray about the focal point.

Three camera variants ride on it:
  - multi-focus: sample s focuses at ``focus_dist[s % K]``;
  - ``aa_grid``: per-sample screen jitter on the diagonal-scan supersampling
    grid (``sampling.supersample_grid_offsets``);
  - orthographic projection: parallel rays from a view-plane lattice,
    selected when ``camera.ortho_height > 0``.

Pixel convention: row 0 = bottom of the image (GL image origin); writers
flip for PNG.
"""

from __future__ import annotations

import torch

from raytracing_tests_tpu_torch.core import linalg, sampling
from raytracing_tests_tpu_torch.scene.types import Camera


def _world_up(like):
    return torch.tensor([0.0, 1.0, 0.0], dtype=torch.float32, device=like.device)


def aa_jitter(spp: int):
    """The ``aa_grid`` screen jitter of each sample, in pixels: (jx, jy)
    float32 numpy arrays of length ``spp`` in (-0.5, 0.5)."""
    import numpy as np

    cells, grid = sampling.supersample_grid_offsets(spp)
    jx = (cells[:, 0].astype(np.float32) + np.float32(0.5)) / np.float32(grid) - np.float32(0.5)
    jy = (cells[:, 1].astype(np.float32) + np.float32(0.5)) / np.float32(grid) - np.float32(0.5)
    return jx, jy


def primary_rays(camera: Camera, width: int, height: int, spp: int, aa_grid: bool = False):
    """Generate per-(pixel, sample) camera rays.

    Returns (origin, direction, time_ratio) each of shape (H, W, S, 3|).
    ``time_ratio = s / S`` is the motion-blur time coordinate.
    """
    dev = camera.device
    aspect = width / height
    screen_dist = 1.0 / (2.0 * torch.tan(camera.fov_y * 0.5))

    px = (torch.arange(width, dtype=torch.float32, device=dev) / width - 0.5) * aspect  # (W,)
    py = torch.arange(height, dtype=torch.float32, device=dev) / height - 0.5  # (H,)

    cam_right = linalg.cross(camera.direction, _world_up(camera.direction))  # unnormalized
    cam_up = linalg.cross(cam_right, camera.direction)

    if aa_grid:
        jx, jy = (torch.from_numpy(j).to(dev) for j in aa_jitter(spp))
        px_s = px[None, :, None] + jx[None, None, :] / width * aspect  # (1, W, S)
        py_s = py[:, None, None] + jy[None, None, :] / height  # (H, 1, S)
        base_dir = (
            camera.direction * screen_dist
            + cam_right * px_s[..., None]
            + cam_up * py_s[..., None]
        )  # (H, W, S, 3)
        base_dir = linalg.normalize(base_dir)
        o, d, time_ratio = _dof_rays(camera, base_dir, spp)
        sx, sy = px_s[..., None], py_s[..., None]
    else:
        base_dir = (
            camera.direction * screen_dist
            + cam_right * px[None, :, None]
            + cam_up * py[:, None, None]
        )  # (H, W, 3)
        base_dir = linalg.normalize(base_dir)
        o, d, time_ratio = _dof_rays(camera, base_dir[..., None, :], spp)
        sx = px[None, :, None, None].expand(height, width, 1, 1)
        sy = py[:, None, None, None].expand(height, width, 1, 1)

    if float(camera.ortho_height) > 0.0:
        # Parallel rays from the view-plane lattice: origin pos + h (sx r + sy u)
        # with the normalized right / up vectors, direction the camera's.
        right_n = linalg.normalize(cam_right)
        up_n = linalg.normalize(cam_up)
        o_ortho = camera.position + camera.ortho_height * (sx * right_n + sy * up_n)
        o = o_ortho.expand(o.shape).contiguous()
        d = camera.direction.expand(o.shape).contiguous()
    return o, d, time_ratio


def _dof_rays(camera: Camera, base_dir, spp: int):
    """Thin-lens DOF for base directions (..., S | 1, 3) -> (H, W, S, 3)."""
    s = torch.arange(spp, dtype=torch.float32, device=base_dir.device)
    offset = sampling.sunflower_disc(s, spp, camera.aperture)  # (S, 2)
    ray_right = linalg.cross(base_dir, _world_up(base_dir))
    ray_up = linalg.cross(ray_right, base_dir)
    new_tip = (
        camera.position
        + base_dir
        + ray_right * offset[:, 0, None]
        + ray_up * offset[:, 1, None]
    )
    # Multi-focus: sample s focuses at focus_dist[s % K] (single focus: K = 1).
    k = torch.arange(spp, device=base_dir.device) % camera.focus_dist.shape[0]
    fd = camera.focus_dist[k]  # (S,)
    look_at = camera.position + base_dir * fd[:, None]
    d = linalg.normalize(look_at - new_tip)
    o = new_tip - d
    time_ratio = (s / spp).expand(o.shape[:-1])
    return o, d, time_ratio
