"""Mercator (equirectangular) <-> cubic (cube-sphere atlas) reprojection.

One gather over the whole output grid.  Conventions:
  - MERCATOR: U in [0,1) wraps yaw (atan2(z, x) / 2pi, negative wrapped up);
    V in [0,1] is acos(-y)/pi (V=0 at -y pole).
  - CUBIC: a (H, 6W) atlas, face order [+y, +x, +z, -x, -z, -y]; per-face
    texcoords follow the table in ``textures.cube_sphere_uv``.

Sampling is nearest-neighbour (integer truncation) by default;
``bilinear=True`` is offered for quality.
"""

from __future__ import annotations

import math

import numpy as np
import torch

FACES = 6


def _select(face, values):
    """values[face] per element, ``values`` one tensor per face."""
    return torch.stack(values, dim=-1).gather(-1, face[..., None].long())[..., 0]


def _face_uv_to_dir(face, u, v):
    """(face, u, v in [0,1]) -> unnormalized direction (x, y, z).

    Inverts the cube_sphere_uv table: builds the point on the unit cube
    [0,1]^3 of each face, then subtracts 0.5."""
    zeros = torch.zeros_like(u)
    ones = torch.ones_like(u)
    fx = _select(face, [u, ones, u, zeros, 1.0 - v, 1.0 - v])
    fy = _select(face, [ones, 1.0 - u, v, v, 1.0 - u, zeros])
    fz = _select(face, [1.0 - v, 1.0 - v, ones, u, zeros, u])
    return torch.stack([fx - 0.5, fy - 0.5, fz - 0.5], dim=-1)


def _dir_to_mercator_uv(d):
    """Direction -> (U, V) in [0,1]."""
    d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    v = torch.arccos(torch.clamp(-d[..., 1], -1.0, 1.0)) / np.pi
    u = torch.atan2(d[..., 2], d[..., 0]) / (2.0 * np.pi)
    u = torch.where(u < 0, u + 1.0, u)
    return u, v


def _mercator_uv_to_dir(u, v):
    """(U, V) -> direction."""
    pitch = (v * 180.0 - 90.0) * math.pi / 180.0
    yaw = u * 2.0 * math.pi
    return torch.stack(
        [torch.cos(yaw) * torch.cos(pitch), torch.sin(pitch), torch.sin(yaw) * torch.cos(pitch)],
        dim=-1,
    )


def _sample(img, x01, y01, bilinear: bool):
    """Sample (H, W, C) image at normalized coords; x/y in [0,1)."""
    H, W = img.shape[:2]
    if not bilinear:  # truncation: int(x * width)
        xi = torch.clamp((x01 * W).to(torch.int64), 0, W - 1)
        yi = torch.clamp((y01 * H).to(torch.int64), 0, H - 1)
        return img[yi, xi]
    fx = torch.clamp(x01 * W - 0.5, 0.0, W - 1.0)
    fy = torch.clamp(y01 * H - 0.5, 0.0, H - 1.0)
    x0 = torch.floor(fx).to(torch.int64)
    y0 = torch.floor(fy).to(torch.int64)
    x1 = torch.clamp_max(x0 + 1, W - 1)
    y1 = torch.clamp_max(y0 + 1, H - 1)
    wx = (fx - x0)[..., None]
    wy = (fy - y0)[..., None]
    top = img[y0, x0] * (1 - wx) + img[y0, x1] * wx
    bot = img[y1, x0] * (1 - wx) + img[y1, x1] * wx
    return top * (1 - wy) + bot * wy


def _as_image(img):
    if isinstance(img, torch.Tensor):
        return img.to(torch.float32)
    return torch.from_numpy(np.ascontiguousarray(img, np.float32))


def mercator_to_cubic(img, bilinear: bool = False):
    """Equirectangular (H, W, C) -> cube atlas of the same shape (6 faces
    packed along X, each W/6 wide)."""
    img = _as_image(img)
    H, W = img.shape[:2]
    ys = torch.arange(H, dtype=torch.float32, device=img.device) / H
    xs6 = 6.0 * torch.arange(W, dtype=torch.float32, device=img.device) / W  # [0, 6)
    Y, X = torch.meshgrid(ys, xs6, indexing="ij")  # (H, W)
    face = torch.clamp(X.to(torch.int32), 0, 5)
    u = X - face
    d = _face_uv_to_dir(face, u, Y)
    mu, mv = _dir_to_mercator_uv(d)
    return _sample(img, mu, mv, bilinear)


def cubic_to_mercator(atlas, bilinear: bool = False):
    """Cube atlas (H, W=6*face_w, C) -> equirectangular of the same shape."""
    from raytracing_tests_tpu_torch.scene.textures import cube_sphere_uv

    atlas = _as_image(atlas)
    H, W = atlas.shape[:2]
    vs = torch.arange(H, dtype=torch.float32, device=atlas.device) / H
    us = torch.arange(W, dtype=torch.float32, device=atlas.device) / W
    V, U = torch.meshgrid(vs, us, indexing="ij")
    d = _mercator_uv_to_dir(U, V)

    face, fu, fv = cube_sphere_uv(d)
    x01 = (face.to(torch.float32) + torch.clamp(fu, 0.0, 1.0)) / 6.0
    return _sample(atlas, x01, torch.clamp(fv, 0.0, 1.0), bilinear)


def load_image_texture(path: str, mapping: str = "cubic", bilinear: bool = True):
    """Load a PNG/JPG as a cube atlas for ``SceneBuilder.add_texture``
    ((H, W, 3) float32 numpy).

    ``mapping='mercator'`` reprojects an equirectangular image;
    ``'cubic'`` takes an already-packed 6-face atlas.  The image is flipped
    so that row 0 is its bottom.
    """
    from raytracing_tests_tpu_torch.utils.io import load_image

    img = np.ascontiguousarray(load_image(path)[::-1])
    if mapping == "mercator":
        return mercator_to_cubic(img, bilinear=bilinear).numpy()
    if mapping != "cubic":
        raise ValueError(f"unknown texture mapping {mapping!r}")
    return img
