"""Canonical example scenes.

Each function returns ``(scene, camera)``, built on the CPU; move them with
``.to(device)``.  These are the deterministic, scriptable versions of the
demo scenes:

  - ``sphere_scene``      one sphere over a ground (the infinite ground plane
                          is a thin huge cuboid — same image, no special-case
                          primitive).
  - ``groups_scene``      N-object mirror scene.
  - ``materials_scene``   matte ground, glass, metal and matte spheres (the
                          Shirley-materials demo).
  - ``motion_blur_scene`` two spheres swept between two checkpoints over a
                          ground sphere.
  - ``bvh_grid_scene``    grid of alternating ellipsoids / rotated cuboids.
  - ``lights_scene``      Cornell-style box room lit by one emissive panel.
  - ``iow_final_scene``   the Ray Tracing in One Weekend cover scene
                          (~480 random spheres) — the headline frame.

The textured scenes are not ported yet.
"""

from __future__ import annotations

import numpy as np

from raytracing_tests_tpu_torch.scene.types import CUBOID, Camera, SceneBuilder


def sphere_scene():
    b = SceneBuilder()
    b.add_sphere((0.0, 0.0, -3.0), 1.0, color=(0.8, 0.3, 0.3), reflectivity=1.0,
                 scatter_reflect=0.8)
    b.add_box((0.0, -101.0, 0.0), (400.0, 200.0, 400.0), color=(0.4, 0.8, 0.4),
              reflectivity=1.0, scatter_reflect=1.0)
    cam = Camera.make((0.0, 0.5, 2.0), (0.0, -0.1, -1.0), fov_y_deg=60.0, focus_dist=5.0)
    return b.build(), cam


def groups_scene():
    b = SceneBuilder()
    b.add_box((0.0, -1.2, -4.0), (6.0, 0.4, 6.0), color=(0.35, 0.6, 0.35),
              reflectivity=0.6)
    b.add_sphere((-1.2, 0.0, -4.0), 1.0, color=(0.9, 0.4, 0.3), reflectivity=0.8)
    b.add((1.2, 0.0, -4.5), (1.2, 0.8, 1.0), rotation_deg=(0.0, 30.0, 0.0),
          color=(0.3, 0.4, 0.9), reflectivity=0.8)
    b.add_box((0.0, 0.4, -6.5), (1.5, 1.5, 1.5), rotation_deg=(0.0, 45.0, 0.0),
              color=(0.9, 0.8, 0.2), reflectivity=0.9)
    cam = Camera.make((0.0, 0.6, 0.0), (0.0, -0.05, -1.0), fov_y_deg=70.0, focus_dist=4.0)
    return b.build(), cam


def materials_scene():
    # The reference demo: a big matte ground sphere, a glass sphere, a metal
    # sphere and a matte one.
    b = SceneBuilder()
    b.add_sphere((0.0, -100.5, -3.0), 100.0, color=(0.5, 0.7, 0.4),
                 reflectivity=1.0, scatter_reflect=1.2)
    b.add_sphere((0.0, 0.0, -3.0), 0.5, color=(0.9, 0.9, 0.9),
                 refractive_index=1.5, refractivity=0.85, reflectivity=0.15)
    b.add_sphere((1.1, 0.0, -3.2), 0.5, color=(0.8, 0.6, 0.2),
                 reflectivity=0.95, scatter_reflect=0.15)
    b.add_sphere((-1.1, 0.0, -3.2), 0.5, color=(0.7, 0.2, 0.2),
                 reflectivity=1.0, scatter_reflect=1.0)
    cam = Camera.make((0.0, 0.3, 0.5), (0.0, -0.08, -1.0), fov_y_deg=55.0,
                      aperture=0.05, focus_dist=3.5)
    return b.build(), cam


def motion_blur_scene():
    b = SceneBuilder()
    b.add_sphere((0.0, -100.5, -3.0), 100.0, color=(0.5, 0.7, 0.4),
                 reflectivity=1.0, scatter_reflect=1.2)
    b.add_sphere((-0.6, 0.1, -3.0), 0.4, color=(0.9, 0.3, 0.3),
                 reflectivity=0.9, scatter_reflect=0.3,
                 delta_position=(0.0, 0.35, 0.0))
    b.add_sphere((0.8, 0.0, -3.4), 0.45, color=(0.3, 0.3, 0.9),
                 reflectivity=0.9, scatter_reflect=0.1,
                 delta_position=(0.3, 0.0, 0.0))
    cam = Camera.make((0.0, 0.3, 0.5), (0.0, -0.08, -1.0), fov_y_deg=55.0, focus_dist=3.5)
    return b.build(), cam


def bvh_grid_scene(side: int = 8, spacing: float = 1.6):
    """Grid of alternating ellipsoids/cuboids."""
    b = SceneBuilder()
    rng = np.random.default_rng(7)
    for i in range(side):
        for j in range(side):
            x = (i - side / 2 + 0.5) * spacing
            z = -3.0 - j * spacing
            y = float(rng.uniform(-0.3, 0.3))
            col = rng.uniform(0.2, 0.95, 3)
            if (i + j) % 2 == 0:
                b.add_sphere((x, y, z), 0.45, color=tuple(col), reflectivity=0.85,
                             scatter_reflect=float(rng.uniform(0.0, 0.6)))
            else:
                b.add_box((x, y, z), (0.7, 0.7, 0.7),
                          rotation_deg=(0.0, float(rng.uniform(0, 90)), 0.0),
                          color=tuple(col), reflectivity=0.85,
                          scatter_reflect=float(rng.uniform(0.0, 0.6)))
    b.add_box((0.0, -101.0, -8.0), (400.0, 200.0, 400.0), color=(0.5, 0.5, 0.55),
              reflectivity=0.7, scatter_reflect=1.0)
    cam = Camera.make((0.0, 3.0, 2.0), (0.0, -0.45, -1.0), fov_y_deg=60.0, focus_dist=8.0)
    return b.build(), cam


def lights_scene():
    """Cornell-style: gray box room, two spheres, one emissive ceiling panel."""
    b = SceneBuilder()
    # floor / ceiling / back / sides (thin cuboids)
    b.add_box((0.0, -1.0, -4.0), (4.0, 0.1, 4.0), color=(0.75, 0.75, 0.75),
              reflectivity=0.9, scatter_reflect=1.0)
    b.add_box((0.0, 3.0, -4.0), (4.0, 0.1, 4.0), color=(0.75, 0.75, 0.75),
              reflectivity=0.9, scatter_reflect=1.0)
    b.add_box((0.0, 1.0, -6.0), (4.0, 4.0, 0.1), color=(0.75, 0.75, 0.75),
              reflectivity=0.9, scatter_reflect=1.0)
    b.add_box((-2.0, 1.0, -4.0), (0.1, 4.0, 4.0), color=(0.7, 0.2, 0.2),
              reflectivity=0.9, scatter_reflect=1.0)
    b.add_box((2.0, 1.0, -4.0), (0.1, 4.0, 4.0), color=(0.2, 0.7, 0.2),
              reflectivity=0.9, scatter_reflect=1.0)
    b.add_sphere((-0.7, -0.45, -4.3), 0.5, color=(0.9, 0.9, 0.9),
                 reflectivity=0.95, scatter_reflect=0.4)
    b.add_sphere((0.7, -0.45, -3.6), 0.5, color=(0.9, 0.8, 0.5),
                 reflectivity=0.95, scatter_reflect=0.05)
    b.add_light((0.0, 2.9, -4.0), (1.2, 0.08, 1.2), obj_type=CUBOID)
    cam = Camera.make((0.0, 0.8, 0.4), (0.0, -0.05, -1.0), fov_y_deg=60.0, focus_dist=4.5)
    return b.build(), cam


def iow_final_scene(seed: int = 1, side: int = 11):
    """Ray Tracing in One Weekend cover scene, expressed in this framework's
    material model (lambertian -> full reflect + wide scatter, metal ->
    reflect + fuzz, dielectric -> refract + slight reflect)."""
    rng = np.random.default_rng(seed)
    b = SceneBuilder()
    b.add_sphere((0.0, -1000.0, 0.0), 1000.0, color=(0.5, 0.5, 0.5),
                 reflectivity=1.0, scatter_reflect=1.2)
    for a in range(-side, side):
        for c in range(-side, side):
            choose = rng.uniform()
            center = np.array([a + 0.9 * rng.uniform(), 0.2, c + 0.9 * rng.uniform()])
            if np.linalg.norm(center - np.array([4.0, 0.2, 0.0])) <= 0.9:
                continue
            if choose < 0.8:
                albedo = rng.uniform(0, 1, 3) * rng.uniform(0, 1, 3)
                b.add_lambertian(tuple(center), 0.2, tuple(albedo), scatter=1.2)
            elif choose < 0.95:
                albedo = rng.uniform(0.5, 1.0, 3)
                b.add_metal(tuple(center), 0.2, tuple(albedo), fuzz=float(rng.uniform(0, 0.5)))
            else:
                b.add_dielectric(tuple(center), 0.2, ior=1.5)
    b.add_dielectric((0.0, 1.0, 0.0), 1.0, ior=1.5)
    b.add_lambertian((-4.0, 1.0, 0.0), 1.0, (0.4, 0.2, 0.1), scatter=1.2)
    b.add_metal((4.0, 1.0, 0.0), 1.0, (0.7, 0.6, 0.5), fuzz=0.0)
    cam = Camera.make((13.0, 2.0, 3.0), (-13.0, -1.8, -3.0), fov_y_deg=30.0,
                      aperture=0.1, focus_dist=10.0)
    return b.build(), cam
