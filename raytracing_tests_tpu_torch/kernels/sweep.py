"""Host-side scene classification used by ``RenderConfig.for_scene``.

(The first-generation sweep kernels that live beside these helpers in the JAX
package are not ported yet.)
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from raytracing_tests_tpu_torch.core import geometry
from raytracing_tests_tpu_torch.scene.types import Scene


def _np(x):
    return x.detach().cpu().numpy()


def scene_mode(scene: Scene) -> str:
    """'spheres' when every valid object is an isotropic ellipsoid and either
    untextured or unrotated (rotation only affects texture coordinates on an
    isotropic sphere)."""
    valid = _np(scene.valid)
    if not valid.any():
        return "generic"
    ot = _np(scene.obj_type)[valid]
    sc = _np(scene.scale)[valid]
    iso = np.allclose(sc, sc[:, :1])
    spheres = (ot == geometry.ELLIPSOID).all() and iso
    if not spheres:
        return "generic"
    if scene.textures is not None and (_np(scene.texture_index)[valid] > 0).any():
        rot = _np(scene.rotation)[valid]
        if not np.allclose(rot, np.eye(3), atol=1e-6):
            return "generic"
    return "spheres"


def scene_has_motion(scene: Scene) -> bool:
    """Any valid object with a nonzero motion delta."""
    dp = _np(scene.delta_position) * _np(scene.valid)[:, None]
    return bool((np.abs(dp) > 0).any())


@dataclasses.dataclass
class HitFields:
    """Per-lane material fields of the winning object."""

    color: torch.Tensor  # (B, 3)
    refractive_index: torch.Tensor  # (B,)
    refractivity: torch.Tensor
    reflectivity: torch.Tensor
    scatter_refract: torch.Tensor
    scatter_reflect: torch.Tensor
    texture_index: torch.Tensor  # (B,) i32
    emissive: torch.Tensor  # (B,) bool
