"""Primary-ray generation with thin-lens depth of field.

Screen-space direction from an UNNORMALIZED right/up camera basis (faithful to
the reference, which skips the normalize), then a sunflower aperture offset
that pivots each sample ray about the focal point.

Ported so far: the perspective camera with one focus distance.  The
``aa_grid`` jitter, multi-focus and orthographic projection are not.

Pixel convention: row 0 = bottom of the image (GL image origin); writers
flip for PNG.
"""

from __future__ import annotations

import torch

from raytracing_tests_tpu_torch.core import linalg, sampling
from raytracing_tests_tpu_torch.scene.types import Camera


def _world_up(like):
    return torch.tensor([0.0, 1.0, 0.0], dtype=torch.float32, device=like.device)


def check_supported(camera: Camera, aa_grid: bool = False):
    """Raise for the camera variants that are not ported yet."""
    if aa_grid:
        raise NotImplementedError("aa_grid supersampling is not ported yet")
    if camera.focus_dist.shape[0] != 1:
        raise NotImplementedError("multi-focus cameras are not ported yet")
    if float(camera.ortho_height) != 0.0:
        raise NotImplementedError("orthographic cameras are not ported yet")


def primary_rays(camera: Camera, width: int, height: int, spp: int, aa_grid: bool = False):
    """Generate per-(pixel, sample) camera rays.

    Returns (origin, direction, time_ratio) each of shape (H, W, S, 3|).
    ``time_ratio = s / S`` is the motion-blur time coordinate.
    """
    check_supported(camera, aa_grid)
    dev = camera.device
    aspect = width / height
    screen_dist = 1.0 / (2.0 * torch.tan(camera.fov_y * 0.5))

    px = (torch.arange(width, dtype=torch.float32, device=dev) / width - 0.5) * aspect  # (W,)
    py = torch.arange(height, dtype=torch.float32, device=dev) / height - 0.5  # (H,)

    cam_right = linalg.cross(camera.direction, _world_up(camera.direction))  # unnormalized
    cam_up = linalg.cross(cam_right, camera.direction)

    base_dir = (
        camera.direction * screen_dist
        + cam_right * px[None, :, None]
        + cam_up * py[:, None, None]
    )  # (H, W, 3)
    base_dir = linalg.normalize(base_dir)
    return _dof_rays(camera, base_dir[..., None, :], spp)


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
    fd = camera.focus_dist[0].expand(spp)  # single focus
    look_at = camera.position + base_dir * fd[:, None]
    d = linalg.normalize(look_at - new_tip)
    o = new_tip - d
    time_ratio = (s / spp).expand(o.shape[:-1])
    return o, d, time_ratio
