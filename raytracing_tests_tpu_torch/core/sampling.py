"""Deterministic sample-distribution functions.

The renderer is *deterministic*: every "random" direction is a fixed function
of the sample index (sunflower / fibonacci lattices), which is what makes
parity testing possible.

All take sample indices (tensors or numbers) and broadcast.
"""

from __future__ import annotations

import numpy as np
import torch

from raytracing_tests_tpu_torch.core import linalg

PI = 3.1415926538
# 'PHI' in the reference kernels, evaluated in float32 like the reference.
GOLDEN_ANGLE = float(np.float32(PI) * (np.float32(3.0) - np.sqrt(np.float32(5.0))))


def _f32(x, like=None):
    """``x`` as float32, on ``like``'s device when one is given (a Python
    number by a fill, not a host copy: see ``linalg.const``)."""
    if isinstance(like, torch.Tensor) and isinstance(x, (int, float)):
        return torch.full((), x, dtype=torch.float32, device=like.device)
    device = like.device if isinstance(like, torch.Tensor) else None
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def _rim_count(n):
    return torch.round(2.0 * torch.sqrt(n))


def sunflower_disc(sample_index, max_samples, aperture):
    """Point in a disc of diameter ``aperture`` on a sunflower (Vogel) lattice.

    ``sample_index == 0`` maps to the center.  The outermost ``b ~ 2*sqrt(n)``
    samples are pinned to the rim (boundary smoothing).
    """
    i = _f32(sample_index)
    n = _f32(max_samples, i)
    b = _rim_count(n)
    half_ap = _f32(aperture, i) * 0.5
    denom = n - (b + 1.0) / 2.0
    denom = torch.where(denom > 0.0, denom, torch.ones_like(denom))
    r = torch.where(
        i > n - b,
        half_ap,
        half_ap * torch.sqrt(torch.clamp_min(i - 0.5, 0.0) / denom),
    )
    theta = GOLDEN_ANGLE * i
    pt = torch.stack([r * torch.cos(theta), r * torch.sin(theta)], dim=-1)
    return torch.where((i == 0)[..., None], torch.zeros_like(pt), pt)


def sunflower_unit_disc(sample_index, max_samples):
    """Unit-disc sunflower lattice with the materials-kernel angle convention
    (``theta = 2*pi*i/phi^2``)."""
    i = _f32(sample_index)
    n = _f32(max_samples, i)
    b = _rim_count(n)
    golden = float((np.sqrt(np.float32(5.0)) + np.float32(1.0)) / np.float32(2.0))
    denom = n - (b + 1.0) / 2.0
    denom = torch.where(denom > 0.0, denom, torch.ones_like(denom))
    r = torch.where(i > n - b, torch.ones_like(i),
                    torch.sqrt(torch.clamp_min(i - 0.5, 0.0) / denom))
    theta = 2.0 * PI * i / (golden * golden)
    pt = torch.stack([r * torch.cos(theta), r * torch.sin(theta)], dim=-1)
    return torch.where((i == 0)[..., None], torch.zeros_like(pt), pt)


def deviate_within_cone(direction, sample_index, max_samples, tan_theta):
    """Deterministically scatter ``direction`` within a cone of ``tan_theta``:
    a sunflower offset (diameter ``2*tan_theta``) in the plane spanned by
    ``cross(d, up)`` and ``cross(right, d)``, scaled by a fixed 0.1 factor."""
    off = sunflower_disc(sample_index, max_samples,
                         2.0 * _f32(tan_theta, direction))
    up = linalg.const((0.0, 1.0, 0.0), direction)
    right = linalg.cross(direction, up)
    up2 = linalg.cross(right, direction)
    factor = 0.1
    return linalg.normalize(
        direction + factor * (off[..., 0:1] * right + off[..., 1:2] * up2)
    )


def fibonacci_hemisphere(sample_index, max_samples, scatteritivity, focus_dirn):
    """Deterministic scatter around ``focus_dirn`` on a scaled fibonacci
    sphere of radius ``scatteritivity`` centered at the tip of ``focus_dirn``."""
    i = _f32(sample_index, focus_dirn)
    n = _f32(max_samples, focus_dirn)
    y = 1.0 - i / torch.clamp_min(n - 1.0, 1.0)  # n=1: the single sample is the pole
    radius = torch.sqrt(torch.clamp_min(1.0 - y * y, 0.0))
    theta = GOLDEN_ANGLE * i
    x = torch.cos(theta) * radius
    z = torch.sin(theta) * radius
    s = _f32(scatteritivity, focus_dirn)
    x, y, z = x * s, y * s, z * s

    y_cap = focus_dirn
    world_up = linalg.const((0.0, 1.0, 0.0), focus_dirn)
    z_cap = linalg.normalize(linalg.cross(world_up, y_cap), eps=1e-20)
    x_cap = linalg.normalize(linalg.cross(y_cap, z_cap), eps=1e-20)
    pt = focus_dirn + (
        x[..., None] * x_cap + y[..., None] * y_cap + z[..., None] * z_cap
    )
    return linalg.normalize(pt)


def supersample_grid_offsets(num_samples):
    """Diagonal-scan supersampling grid: for n samples, pick
    grid = ceil(sqrt(n)) and walk cells (1,1),(1,0),(0,1),(2,2),(2,1),...

    Returns integer offsets of shape (num_samples, 2) and the grid size;
    host-side helper (static, so plain Python).
    """
    grid = 1
    while grid * grid < num_samples:
        grid += 1
    out = []
    focus = x = y = 0
    sx = sy = 0
    for _ in range(num_samples):
        if focus < grid:
            if x == 0 and y == 0:
                focus += 1
                x = y = focus
                sx, sy = focus, focus
            else:
                if x < y:
                    y -= 1
                    sx, sy = focus, y
                else:
                    x -= 1
                    sx, sy = x, focus
        out.append((sx, sy))
    return np.asarray(out, dtype=np.int32), grid
