"""Cube-sphere atlas texturing inside the persistent kernel.

``pack_atlas`` lays the scene's (T, H, 6W, 3) atlas stack out for the card:
each texel a 16-byte RGBA ``float4`` (alpha 0), contiguous, so one load
through the read-only path fetches a bilinear corner
(``csrc/rt_common.cuh::texture_albedo``).  An atlas of a few MB stays in the
card's L2, so the kernel gathers its four corners directly; the hardware's
linear filter is not used, because it quantises the weights to 8 fractional
bits.

``texture_color`` is the plain version the plain persistent kernel uses: the
queue renderer's ``scene.textures.sample_atlas`` at ``cube_sphere_uv`` of the
unit-space hit position, read from the packed texels.
"""

from __future__ import annotations

import torch

from raytracing_tests_tpu_torch.scene.textures import cube_sphere_uv, sample_atlas

TEXEL_FLOATS = 4  # r, g, b, 0


def pack_atlas(textures):
    """(T, H, 6W, 3) f32 atlas stack -> (texels (T, H, 6W, 4) f32
    contiguous on the atlas's device, (T, H, W6))."""
    if textures.dim() != 4 or textures.shape[-1] != 3:
        raise ValueError(f"an atlas stack is (T, H, 6W, 3), not {tuple(textures.shape)}")
    T, H, W6, _ = textures.shape
    texels = torch.zeros((T, H, W6, TEXEL_FLOATS), dtype=torch.float32, device=textures.device)
    texels[..., :3] = textures
    return texels, (T, H, W6)


def texture_color(color, ti, local_pos, texels):
    """Albedo ``color`` (B, 3) times the atlas sample at ``local_pos`` (B, 3)
    where the texture index ``ti`` (B,) is above 0; ``texels``: the scene's
    (T, H, 6W, 3) atlas stack or ``pack_atlas``'s (T, H, 6W, 4) texels."""
    face, u, v = cube_sphere_uv(local_pos)
    tc = sample_atlas(texels[..., :3], ti, face, u, v)
    return torch.where((ti > 0)[:, None], color * tc, color)
