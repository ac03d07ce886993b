"""Scene-of-arrays (SoA) scene representation and camera model.

The scene is a struct of tensors: each field is an ``(N, ...)`` tensor padded
to a capacity that is a multiple of 8, with a ``valid`` mask.  ``Scene`` and
``Camera`` are plain dataclasses; ``.to(device)`` moves every tensor.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from raytracing_tests_tpu_torch.core import geometry, linalg

ELLIPSOID = geometry.ELLIPSOID
CUBOID = geometry.CUBOID

_PAD = 8  # pad object count to a multiple of this for friendly layouts


class _TensorStruct:
    """``.to(device)`` / ``.replace(**fields)`` for dataclasses of tensors."""

    def to(self, device):
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)
        })

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass
class Scene(_TensorStruct):
    """Static-capacity SoA scene. All tensors share leading dim N (padded)."""

    # Transform
    position: torch.Tensor  # (N, 3) f32
    rotation: torch.Tensor  # (N, 3, 3) f32 world-from-local
    scale: torch.Tensor  # (N, 3) f32
    delta_position: torch.Tensor  # (N, 3) f32 motion since last "frame"
    obj_type: torch.Tensor  # (N,) i32: 1=ellipsoid, 2=cuboid, 0=padding

    # Material
    color: torch.Tensor  # (N, 3) f32 albedo
    refractive_index: torch.Tensor  # (N,) f32
    refractivity: torch.Tensor  # (N,) f32 fraction of light refracted
    reflectivity: torch.Tensor  # (N,) f32 fraction of light reflected
    scatter_refract: torch.Tensor  # (N,) f32 tan(cone) of refracted scatter
    scatter_reflect: torch.Tensor  # (N,) f32 tan(cone) of reflected scatter
    texture_index: torch.Tensor  # (N,) i32, 0 = untextured, else 1-based atlas id
    emissive: torch.Tensor  # (N,) bool

    valid: torch.Tensor  # (N,) bool padding mask

    # Cube-sphere atlas stack (T, H, 6W, 3) f32, slot 0 a zero filler so that
    # texture indices stay 1-based; None for an untextured scene.
    textures: Optional[torch.Tensor] = None

    @property
    def capacity(self) -> int:
        return self.position.shape[0]

    @property
    def device(self):
        return self.position.device

    @property
    def num_valid(self):
        return torch.sum(self.valid.to(torch.int32))

    def world_aabbs(self):
        """Per-object conservative world AABBs including motion sweep."""
        last = self.position - self.delta_position
        return geometry.object_aabb(self.position, last, self.rotation, self.scale)


@dataclasses.dataclass
class Camera(_TensorStruct):
    """Pinhole + thin-lens camera.

    ``focus_dist`` is a vector (multi-focus arrays); single-focus uses
    ``focus_dist[0]``.  ``ortho_height > 0`` marks an orthographic projection.
    ``focus_dist`` may hold several distances: sample s focuses at
    ``focus_dist[s % K]``.
    """

    position: torch.Tensor  # (3,)
    direction: torch.Tensor  # (3,) normalized look direction
    fov_y: torch.Tensor  # () radians
    aperture: torch.Tensor  # () lens diameter
    focus_dist: torch.Tensor  # (K,)
    ortho_height: torch.Tensor = dataclasses.field(
        default_factory=lambda: torch.zeros(()))

    @property
    def device(self):
        return self.position.device

    @classmethod
    def make(cls, position, direction, fov_y_deg=60.0, aperture=0.0, focus_dist=10.0,
             ortho_height=0.0):
        # NOTE: focus_dist == 1.0 is degenerate under the DOF pivot
        # (lookAt - newTip becomes the zero vector); keep it > 1.
        fd = np.atleast_1d(np.asarray(focus_dist, np.float32))
        d = np.asarray(direction, np.float32)
        d = d / np.linalg.norm(d)
        f32 = lambda x: torch.from_numpy(np.array(x, np.float32))
        return cls(
            position=f32(position),
            direction=f32(d),
            fov_y=f32(np.deg2rad(fov_y_deg)),
            aperture=f32(aperture),
            focus_dist=f32(fd),
            ortho_height=f32(ortho_height),
        )

    @classmethod
    def orthographic(cls, position, direction, height=2.0):
        """An orthographic camera whose view is ``height`` units tall."""
        return cls.make(position, direction, ortho_height=height)

    @classmethod
    def from_pitch_yaw(cls, position, pitch_deg, yaw_deg, **kw):
        """Pitch/yaw camera."""
        p, y = np.deg2rad(pitch_deg), np.deg2rad(yaw_deg)
        d = np.array(
            [np.cos(p) * np.cos(y), np.sin(p), np.cos(p) * np.sin(y)], np.float32
        )
        return cls.make(position, d, **kw)


@dataclasses.dataclass
class _Obj:
    position: tuple
    rotation_deg: tuple
    scale: tuple
    delta_position: tuple
    obj_type: int
    color: tuple
    refractive_index: float
    refractivity: float
    reflectivity: float
    scatter_refract: float
    scatter_reflect: float
    texture_index: int
    emissive: bool


class SceneBuilder:
    """Host-side scene assembly -> padded SoA ``Scene`` (on the CPU; move it
    with ``scene.to(device)``)."""

    def __init__(self):
        self._objs: list[_Obj] = []
        self._textures: list[np.ndarray] = []

    def __len__(self):
        return len(self._objs)

    def add(
        self,
        position,
        scale,
        obj_type=ELLIPSOID,
        rotation_deg=(0.0, 0.0, 0.0),
        delta_position=(0.0, 0.0, 0.0),
        color=(1.0, 1.0, 1.0),
        refractive_index=1.5,
        refractivity=0.0,
        reflectivity=0.0,
        scatter_refract=0.0,
        scatter_reflect=0.0,
        texture_index=0,
        emissive=False,
    ):
        self._objs.append(
            _Obj(
                tuple(position),
                tuple(rotation_deg),
                tuple(scale),
                tuple(delta_position),
                int(obj_type),
                tuple(color),
                float(refractive_index),
                float(refractivity),
                float(reflectivity),
                float(scatter_refract),
                float(scatter_reflect),
                int(texture_index),
                bool(emissive),
            )
        )
        return len(self._objs) - 1

    def add_sphere(self, center, radius, **kw):
        return self.add(center, (radius, radius, radius), ELLIPSOID, **kw)

    def add_box(self, center, size, **kw):
        return self.add(center, size, CUBOID, **kw)

    # Shirley-style material sugar -------------------------------------------------
    def add_lambertian(self, center, radius, albedo, scatter=1.0, **kw):
        """Diffuse: all light reflected with a wide scatter cone."""
        return self.add_sphere(
            center, radius, color=albedo, reflectivity=1.0, scatter_reflect=scatter, **kw
        )

    def add_metal(self, center, radius, albedo, fuzz=0.0, **kw):
        return self.add_sphere(
            center, radius, color=albedo, reflectivity=1.0, scatter_reflect=fuzz, **kw
        )

    def add_dielectric(self, center, radius, ior=1.5, albedo=(1.0, 1.0, 1.0), **kw):
        return self.add_sphere(
            center,
            radius,
            color=albedo,
            refractive_index=ior,
            refractivity=0.9,
            reflectivity=0.1,
            **kw,
        )

    def add_light(self, center, scale, color=(1.0, 1.0, 1.0), obj_type=ELLIPSOID, **kw):
        return self.add(center, scale, obj_type, color=color, emissive=True, **kw)

    def add_texture(self, image: np.ndarray) -> int:
        """Register a cube-sphere atlas texture (H, 6W, 3) float in [0, 1];
        every atlas of a scene has the same shape.  Returns its 1-based
        texture index (0 means untextured)."""
        image = np.asarray(image, np.float32)
        if image.ndim != 3 or image.shape[-1] != 3:
            raise ValueError(f"an atlas is (H, 6W, 3), not {image.shape}")
        if self._textures and image.shape != self._textures[0].shape:
            raise ValueError(f"all atlas textures must share a shape: {image.shape} "
                             f"against {self._textures[0].shape}")
        self._textures.append(image)
        return len(self._textures)

    def build(self, capacity: Optional[int] = None) -> Scene:
        n = len(self._objs)
        if n == 0:
            raise ValueError("empty scene")
        cap = capacity or -(-n // _PAD) * _PAD
        if cap < n:
            raise ValueError(f"capacity {cap} < {n} objects")

        def field(fn, shape, dtype=np.float32, pad_value=0):
            # Padding rows use benign values (unit scale/RI): they never hit
            # (valid = False, obj_type = 0) but are still *evaluated* by the
            # dense sweep.
            out = np.full((cap,) + shape, pad_value, dtype)
            for i, o in enumerate(self._objs):
                out[i] = fn(o)
            return torch.from_numpy(out)

        rot = np.zeros((cap, 3, 3), np.float32)
        rot[:] = np.eye(3)
        degs = np.array([o.rotation_deg for o in self._objs], np.float32)
        if degs.any():
            # Radians in float32, cos/sin/products in float64, rounded once:
            # correctly-rounded entries whatever the device or library.
            rad = torch.deg2rad(torch.from_numpy(degs)).double()
            rot[:n] = linalg.rotation_from_radians(rad).float().numpy()

        textures = None
        if self._textures:  # behind a zero filler in slot 0
            textures = torch.from_numpy(
                np.stack([np.zeros_like(self._textures[0])] + self._textures))

        return Scene(
            position=field(lambda o: o.position, (3,)),
            rotation=torch.from_numpy(rot),
            scale=field(lambda o: o.scale, (3,), pad_value=1),
            delta_position=field(lambda o: o.delta_position, (3,)),
            obj_type=field(lambda o: o.obj_type, (), np.int32),
            color=field(lambda o: o.color, (3,)),
            refractive_index=field(lambda o: o.refractive_index, (), pad_value=1),
            refractivity=field(lambda o: o.refractivity, ()),
            reflectivity=field(lambda o: o.reflectivity, ()),
            scatter_refract=field(lambda o: o.scatter_refract, ()),
            scatter_reflect=field(lambda o: o.scatter_reflect, ()),
            texture_index=field(lambda o: o.texture_index, (), np.int32),
            emissive=field(lambda o: o.emissive, (), bool),
            valid=torch.from_numpy(np.arange(cap) < n),
            textures=textures,
        )
