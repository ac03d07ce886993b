"""Cube-sphere texturing: face mapping, atlas layout, procedural textures.

A hit point on a primitive maps to one of 6 cube faces by the dominant axis
of its LOCAL (unit-space) position, is projected onto that face's plane and
looked up in a 1x6 horizontal face atlas.

Face order: +y=0, +x=1, +z=2, -x=3, -z=4, -y=5, with the per-face texcoord
table of ``cube_sphere_uv``.

Atlases are ``(H, 6*W, 3)`` float arrays; a stack of them ``(T, H, 6W, 3)``
forms the scene texture array (slot 0 = filler so indices stay 1-based).
"""

from __future__ import annotations

import numpy as np
import torch


def cube_sphere_uv(local_pos):
    """Local (unit-space) position -> (face, u, v) on the cube-sphere.

    ``local_pos``: (..., 3).  Returns integer face (...,) and uv (...,) pairs
    in [0, 1].  The scan starts with +-x, then lets y then z win
    strict-greater comparisons of |component|.
    """
    x, y, z = local_pos[..., 0], local_pos[..., 1], local_pos[..., 2]
    ax, ay, az = x.abs(), y.abs(), z.abs()

    face = torch.where(x > 0, 1, 3)
    dom = ax
    face = torch.where(ay > dom, torch.where(y > 0, 0, 5), face)
    dom = torch.maximum(dom, ay)
    face = torch.where(az > dom, torch.where(z > 0, 2, 4), face)

    one = lambda f: (face == f).to(torch.float32)
    face_dirn = torch.stack([one(1) - one(3), one(0) - one(5), one(2) - one(4)], dim=-1)
    # Guarded divide: dead lanes carry local_pos = 0 (denominator 0); their
    # uv is masked downstream.
    denom = torch.sum(local_pos * face_dirn, dim=-1, keepdim=True)
    p = local_pos / torch.where(denom.abs() > 1e-12, denom, torch.ones_like(denom))
    p = p * 0.5 + 0.5  # (-1,1) -> (0,1)
    px, py, pz = p[..., 0], p[..., 1], p[..., 2]

    # Per-face texcoord table: u = [px, 1-py, px, pz, 1-py, pz],
    # v = [1-pz, 1-pz, py, py, 1-px, 1-px].
    us = torch.stack([px, 1.0 - py, px, pz, 1.0 - py, pz], dim=-1)
    vs = torch.stack([1.0 - pz, 1.0 - pz, py, py, 1.0 - px, 1.0 - px], dim=-1)
    idx = face[..., None]
    return face, us.gather(-1, idx)[..., 0], vs.gather(-1, idx)[..., 0]


def sample_atlas(textures, tex_index, face, u, v):
    """Bilinear sample of the (T, H, 6W, 3) atlas stack.

    ``tex_index`` is 1-based (0 = untextured; callers mask the result).
    Atlas u-coordinate is ``face/6 + u/6``.  Corners clamp at the atlas
    edges, and so do the weights.
    """
    T, H, W6, _ = textures.shape
    au = (face.to(torch.float32) + torch.clamp(u, 0.0, 1.0)) / 6.0
    av = torch.clamp(v, 0.0, 1.0)

    fx = au * W6 - 0.5
    fy = av * H - 0.5
    x0 = torch.clamp(torch.floor(fx).to(torch.int64), 0, W6 - 1)
    y0 = torch.clamp(torch.floor(fy).to(torch.int64), 0, H - 1)
    x1 = torch.clamp(x0 + 1, 0, W6 - 1)
    y1 = torch.clamp(y0 + 1, 0, H - 1)
    wx = torch.clamp(fx - x0, 0.0, 1.0)[..., None]
    wy = torch.clamp(fy - y0, 0.0, 1.0)[..., None]

    ti = torch.clamp(tex_index.to(torch.int64), 0, T - 1)
    c00 = textures[ti, y0, x0]
    c01 = textures[ti, y0, x1]
    c10 = textures[ti, y1, x0]
    c11 = textures[ti, y1, x1]
    return (c00 * (1 - wx) + c01 * wx) * (1 - wy) + (c10 * (1 - wx) + c11 * wx) * wy


# ----------------------------------------------------------------------------
# Procedural atlas generators (host-side, numpy)
# ----------------------------------------------------------------------------


def checker_atlas(size: int = 64, squares: int = 8, c0=(0.1, 0.1, 0.1), c1=(0.9, 0.9, 0.9)):
    """Checkerboard cube atlas (H=size, W=6*size)."""
    yy, xx = np.mgrid[0:size, 0 : 6 * size]
    mask = ((xx * squares // size) + (yy * squares // size)) % 2
    out = np.where(mask[..., None] == 0, np.asarray(c0, np.float32), np.asarray(c1, np.float32))
    return out.astype(np.float32)


def gradient_atlas(size: int = 64):
    """Simple UV-gradient atlas for debugging face orientation."""
    h, w = size, 6 * size
    yy, xx = np.mgrid[0:h, 0:w]
    out = np.stack(
        [xx / (w - 1), yy / (h - 1), np.zeros_like(xx, np.float32)], axis=-1
    ).astype(np.float32)
    return out
