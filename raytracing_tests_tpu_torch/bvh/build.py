"""30-bit Morton codes (the part of the LBVH build the grouped accel needs).

Codes are held in int64 and masked to 32 bits after every multiply, which
reproduces uint32 wrap-around arithmetic.
"""

from __future__ import annotations

import torch

_U32 = 0xFFFFFFFF


def _expand_bits(v):
    """Insert two zero bits after each of the low 10 bits."""
    v = ((v * 0x00010001) & _U32) & 0xFF0000FF
    v = ((v * 0x00000101) & _U32) & 0x0F00F00F
    v = ((v * 0x00000011) & _U32) & 0xC30C30C3
    v = ((v * 0x00000005) & _U32) & 0x49249249
    return v


def morton3d(xyz01):
    """30-bit Morton code (int64 tensor) of points in [0,1]^3."""
    q = torch.clamp(xyz01 * 1024.0, 0.0, 1023.0).to(torch.int64)
    x = _expand_bits(q[..., 0])
    y = _expand_bits(q[..., 1])
    z = _expand_bits(q[..., 2])
    return (x << 2) | (y << 1) | z
