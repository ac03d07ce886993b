"""The differentiable subset of the scene.

``Scene`` mixes float fields (positions, materials) with structural ints
(obj_type, texture_index) and masks; gradients only make sense for the float
fields.  ``SceneParams`` is that float subset — the optimisation variable —
and ``apply_params`` grafts it back onto a template scene.

Trainable parameters: sphere centres (position), radii (scale), albedo
(color), fuzz (scatter_reflect / scatter_refract), IOR (refractive_index),
the reflect / refract fractions, the motion delta and the texture atlas.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from raytracing_tests_tpu_torch.scene.types import Scene, _TensorStruct

FLOAT_FIELDS = (
    "position",
    "scale",
    "delta_position",
    "color",
    "refractive_index",
    "refractivity",
    "reflectivity",
    "scatter_refract",
    "scatter_reflect",
)


@dataclasses.dataclass
class SceneParams(_TensorStruct):
    position: torch.Tensor
    scale: torch.Tensor
    delta_position: torch.Tensor
    color: torch.Tensor
    refractive_index: torch.Tensor
    refractivity: torch.Tensor
    reflectivity: torch.Tensor
    scatter_refract: torch.Tensor
    scatter_reflect: torch.Tensor
    textures: Optional[torch.Tensor] = None

    def items(self):
        """(name, tensor) of every field that holds a tensor, in field order."""
        return [(f.name, getattr(self, f.name)) for f in dataclasses.fields(self)
                if getattr(self, f.name) is not None]

    def map(self, fn):
        """A ``SceneParams`` of ``fn(tensor)`` for every tensor field."""
        return self.replace(**{name: fn(v) for name, v in self.items()})


def extract_params(scene: Scene) -> SceneParams:
    return SceneParams(**{f: getattr(scene, f) for f in FLOAT_FIELDS},
                       textures=scene.textures)


def apply_params(scene: Scene, params: SceneParams) -> Scene:
    """Template scene + params -> scene (structural fields from the template)."""
    return scene.replace(**{f: getattr(params, f) for f in FLOAT_FIELDS},
                         textures=params.textures)


def params_mask(scene: Scene, *trainable_fields: str) -> SceneParams:
    """0/1 mask of the fields ``make_train_step`` updates, e.g.
    ``params_mask(scene, "color", "scatter_reflect")``."""
    unknown = set(trainable_fields) - set(FLOAT_FIELDS) - {"textures"}
    assert not unknown, f"unknown fields: {unknown}"
    p = extract_params(scene)
    return p.replace(**{
        name: torch.full_like(v, 1.0 if name in trainable_fields else 0.0)
        for name, v in p.items()})
