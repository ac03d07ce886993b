"""Vectorized 2D simplex noise, FBM, turbulence, and noise-texture baking.

Classic-permutation-table simplex noise, vectorized over whole pixel grids.
The gradient table is the standard one (``h & 1`` negates u, ``h & 2``
negates v).

The permutation table is Ken Perlin's canonical public-domain jumble of
0..255, shared by virtually every simplex implementation.
"""

from __future__ import annotations

import numpy as np
import torch

_PERM = np.array(
    [151, 160, 137, 91, 90, 15, 131, 13, 201, 95, 96, 53, 194, 233, 7, 225, 140,
     36, 103, 30, 69, 142, 8, 99, 37, 240, 21, 10, 23, 190, 6, 148, 247, 120,
     234, 75, 0, 26, 197, 62, 94, 252, 219, 203, 117, 35, 11, 32, 57, 177, 33,
     88, 237, 149, 56, 87, 174, 20, 125, 136, 171, 168, 68, 175, 74, 165, 71,
     134, 139, 48, 27, 166, 77, 146, 158, 231, 83, 111, 229, 122, 60, 211, 133,
     230, 220, 105, 92, 41, 55, 46, 245, 40, 244, 102, 143, 54, 65, 25, 63, 161,
     1, 216, 80, 73, 209, 76, 132, 187, 208, 89, 18, 169, 200, 196, 135, 130,
     116, 188, 159, 86, 164, 100, 109, 198, 173, 186, 3, 64, 52, 217, 226, 250,
     124, 123, 5, 202, 38, 147, 118, 126, 255, 82, 85, 212, 207, 206, 59, 227,
     47, 16, 58, 17, 182, 189, 28, 42, 223, 183, 170, 213, 119, 248, 152, 2, 44,
     154, 163, 70, 221, 153, 101, 155, 167, 43, 172, 9, 129, 22, 39, 253, 19,
     98, 108, 110, 79, 113, 224, 232, 178, 185, 112, 104, 218, 246, 97, 228,
     251, 34, 242, 193, 238, 210, 144, 12, 191, 179, 162, 241, 81, 51, 145, 235,
     249, 14, 239, 107, 49, 192, 214, 31, 181, 199, 106, 157, 184, 84, 204, 176,
     115, 121, 50, 45, 127, 4, 150, 254, 138, 236, 205, 93, 222, 114, 67, 29,
     24, 72, 243, 141, 128, 195, 78, 66, 215, 61, 156, 180],
    dtype=np.int32,
)

_F2 = 0.366025403  # 0.5*(sqrt(3)-1)
_G2 = 0.211324865  # (3-sqrt(3))/6


def _grad2(hash_, x, y):
    h = hash_ & 7
    u = torch.where(h < 4, x, y)
    v = torch.where(h < 4, 2.0 * y, 2.0 * x)
    u = torch.where((h & 1) != 0, -u, u)
    v = torch.where((h & 2) != 0, -v, v)
    return u + v


def snoise2(x, y):
    """2D simplex noise of float32 tensors, vectorized over any shape."""
    perm = torch.from_numpy(_PERM).to(x.device)
    s = (x + y) * _F2
    i = torch.floor(x + s).to(torch.int32)
    j = torch.floor(y + s).to(torch.int32)
    t = (i + j).to(torch.float32) * _G2
    x0 = x - (i.to(torch.float32) - t)
    y0 = y - (j.to(torch.float32) - t)

    upper = x0 > y0
    i1 = upper.to(torch.int32)
    j1 = 1 - i1

    x1 = x0 - i1 + _G2
    y1 = y0 - j1 + _G2
    x2 = x0 - 1.0 + 2.0 * _G2
    y2 = y0 - 1.0 + 2.0 * _G2

    ii = i & 255
    jj = j & 255
    at = lambda k: perm[(k & 255).long()]

    def corner(tval, xv, yv, hash_):
        t2 = torch.clamp_min(tval, 0.0)
        t2 = t2 * t2
        return t2 * t2 * _grad2(hash_, xv, yv)

    h0 = at(ii + at(jj))
    h1 = at(ii + i1 + at(jj + j1))
    h2 = at(ii + 1 + at(jj + 1))

    n0 = corner(0.5 - x0 * x0 - y0 * y0, x0, y0, h0)
    n1 = corner(0.5 - x1 * x1 - y1 * y1, x1, y1, h1)
    n2 = corner(0.5 - x2 * x2 - y2 * y2, x2, y2, h2)
    return n0 + n1 + n2


def fbm2(x, y, freq=4.0, lacunarity=2.0, gain=0.5, octaves=5):
    """Fractal Brownian motion: ``octaves`` of noise, each at ``lacunarity``
    times the frequency and ``gain`` times the amplitude of the last."""
    total = torch.zeros_like(x, dtype=torch.float32)
    amp = 1.0
    f = freq
    for _ in range(octaves):
        total = total + snoise2(x * f, y * f) * amp
        f *= lacunarity
        amp *= gain
    return total


def turbulence2(x, y, freq=4.0, lacunarity=2.0, gain=0.5, octaves=5):
    """Turbulent (absolute-value) fractal noise."""
    total = torch.zeros_like(x, dtype=torch.float32)
    amp = 1.0
    f = freq
    for _ in range(octaves):
        total = total + torch.abs(snoise2(x * f, y * f)) * amp
        f *= lacunarity
        amp *= gain
    return total


def bake_noise(
    height: int,
    width: int,
    kind: str = "fbm",
    freq: float = 4.0,
    octaves: int = 5,
    seed: int = 0,
):
    """Noise field in [0,1], normalized by its own minimum and maximum."""
    yy, xx = torch.meshgrid(torch.arange(height, dtype=torch.int32),
                            torch.arange(width, dtype=torch.int32), indexing="ij")
    x = xx / width + 13.37 * seed
    y = yy / height + 7.91 * seed
    if kind == "fbm":
        n = fbm2(x, y, freq=freq, octaves=octaves)
    elif kind == "turbulence":
        n = turbulence2(x, y, freq=freq, octaves=octaves)
    elif kind == "simplex":
        n = snoise2(x * freq, y * freq)
    else:
        raise ValueError(f"unknown noise kind: {kind}")
    lo, hi = torch.min(n), torch.max(n)
    return (n - lo) / torch.clamp_min(hi - lo, 1e-9)


def gradient_map(field, colors=((0.1, 0.1, 0.3), (0.9, 0.9, 0.8))):
    """Map a [0,1] field through a linear color gradient."""
    colors = torch.tensor(colors, dtype=torch.float32, device=field.device)  # (K, 3)
    k = colors.shape[0] - 1
    f = torch.clamp(field, 0.0, 1.0) * k
    i0 = torch.clamp(torch.floor(f).to(torch.int64), 0, k - 1)
    w = (f - i0)[..., None]
    return colors[i0] * (1 - w) + colors[i0 + 1] * w


def noise_atlas(size: int = 64, kind: str = "fbm", seed: int = 0, colors=None):
    """Bake a cube-face atlas (size, 6*size, 3) of gradient-mapped noise."""
    field = bake_noise(size, 6 * size, kind=kind, seed=seed)
    img = gradient_map(field, colors or ((0.1, 0.1, 0.3), (0.9, 0.9, 0.8)))
    return img.numpy().astype(np.float32)
