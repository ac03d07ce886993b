"""Small linear-algebra helpers shared by the renderer.

Conventions (the reference's object-transform convention):

  - An object's rotation matrix ``R`` maps LOCAL -> WORLD directions
    (``n_world = R @ n_local``).  Rays are transformed into local space with
    the transpose: ``o_local = R.T @ (o_world - position)``.
  - Euler angles are applied yaw (Y) first, then pitch (X), then roll (Z):
    ``R = Rz(roll) @ Rx(pitch) @ Ry(yaw)``.

All functions broadcast over leading batch dimensions; vectors are ``(..., 3)``.
"""

from __future__ import annotations

import torch


def _rot(rows):
    return torch.stack([torch.stack(r, -1) for r in rows], -2)


def rotation_x(radians):
    """Rotation about +X. ``radians`` may be batched."""
    c, s = torch.cos(radians), torch.sin(radians)
    z, o = torch.zeros_like(c), torch.ones_like(c)
    return _rot([[o, z, z], [z, c, -s], [z, s, c]])


def rotation_y(radians):
    c, s = torch.cos(radians), torch.sin(radians)
    z, o = torch.zeros_like(c), torch.ones_like(c)
    return _rot([[c, z, s], [z, o, z], [-s, z, c]])


def rotation_z(radians):
    c, s = torch.cos(radians), torch.sin(radians)
    z, o = torch.zeros_like(c), torch.ones_like(c)
    return _rot([[c, -s, z], [s, c, z], [z, z, o]])


def rotation_from_euler(rotation_deg):
    """World-from-local rotation from Euler degrees ``(..., 3)`` = (pitch, yaw, roll).

    ``R = Rz(roll) @ Rx(pitch) @ Ry(yaw)`` (yaw, then pitch, then roll).
    """
    return rotation_from_radians(torch.deg2rad(rotation_deg))


def rotation_from_radians(r):
    """``rotation_from_euler`` for angles ``(..., 3)`` already in radians."""
    rx = rotation_x(r[..., 0])
    ry = rotation_y(r[..., 1])
    rz = rotation_z(r[..., 2])
    return torch.matmul(torch.matmul(rz, rx), ry)


def dot(a, b, keepdims: bool = False):
    return torch.sum(a * b, dim=-1, keepdim=keepdims)


def norm(v):
    return torch.sqrt(torch.clamp_min(dot(v, v), 0.0))


def normalize(v, eps: float = 0.0):
    """Normalize; zero vectors map to zero (dead lanes carry zero directions)."""
    n2 = dot(v, v, keepdims=True)
    return v / torch.sqrt(torch.clamp_min(n2, max(eps, 1e-38)))


def safe_normalize(v):
    """Normalize; zero vectors stay zero (used for 'no ray spawned' sentinels)."""
    n2 = dot(v, v, keepdims=True)
    return torch.where(n2 > 1e-20, v / torch.sqrt(torch.clamp_min(n2, 1e-20)),
                       torch.zeros_like(v))


def cross(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def reflect(d, n):
    """GLSL reflect: ``d - 2*dot(d,n)*n`` (``n`` need not face the ray)."""
    return d - 2.0 * dot(d, n, keepdims=True) * n


def refract(d, n, eta):
    """GLSL refract semantics: returns 0-vector on total internal reflection.

    ``d`` must be normalized, ``n`` the normal facing against ``d``,
    ``eta = ri_source / ri_target``.
    """
    eta = torch.as_tensor(eta, dtype=d.dtype, device=d.device)
    if eta.dim() == d.dim() - 1:
        eta = eta[..., None]
    cos_i = -dot(d, n, keepdims=True)
    k = 1.0 - eta * eta * (1.0 - cos_i * cos_i)
    tir = k < 0.0
    # The root only where k > 0 (0 elsewhere, TIR lanes are zeroed below):
    # under autograd the root's backward at k <= 0 would be inf or NaN, and
    # k = 0 exactly is common (a dead lane, d = 0, through eta = 1).
    pos = k > 0.0
    sqrt_k = torch.where(pos, torch.sqrt(torch.where(pos, k, torch.ones_like(k))),
                         torch.zeros_like(k))
    out = eta * d + (eta * cos_i - sqrt_k) * n
    return torch.where(tir, torch.zeros_like(out), out)


def schlick(cosine, ref_ratio):
    """Schlick reflectance approximation."""
    r0 = (1.0 - ref_ratio) / (1.0 + ref_ratio)
    r0 = r0 * r0
    return r0 + (1.0 - r0) * (1.0 - cosine) ** 5


def apply_rotation(R, v):
    """``R @ v`` for batched matrices ``(..., 3, 3)`` and vectors ``(..., 3)``."""
    return torch.sum(R * v[..., None, :], dim=-1)


def apply_rotation_t(R, v):
    """``R.T @ v`` — transform a world vector into the object's local frame."""
    return torch.sum(R * v[..., :, None], dim=-2)
