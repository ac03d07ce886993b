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
  - ``texturing_scene``   spheres with checker, simplex-noise and gradient
                          cube-sphere atlases.
  - ``texturing_image_scene`` image-textured spheres: a procedural
                          equirectangular planet reprojected onto the cube
                          atlas (or an image file), and a dice atlas.
  - ``lights_scene``      Cornell-style box room lit by one emissive panel.
  - ``iow_final_scene``   the Ray Tracing in One Weekend cover scene
                          (~480 random spheres) — the headline frame.
"""

from __future__ import annotations

import numpy as np

from raytracing_tests_tpu_torch.scene import noise as noise_mod
from raytracing_tests_tpu_torch.scene import textures as tex
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


def texturing_scene(tex_size: int = 64):
    b = SceneBuilder()
    checker = b.add_texture(tex.checker_atlas(tex_size))
    noisy = b.add_texture(noise_mod.noise_atlas(tex_size, kind="fbm", seed=3))
    grad = b.add_texture(tex.gradient_atlas(tex_size))
    b.add_sphere((0.0, -100.5, -3.0), 100.0, color=(1.0, 1.0, 1.0),
                 reflectivity=1.0, scatter_reflect=1.2, texture_index=checker)
    b.add_sphere((-0.9, 0.0, -3.0), 0.5, color=(1.0, 1.0, 1.0),
                 reflectivity=0.9, scatter_reflect=0.2, texture_index=noisy)
    b.add_sphere((0.9, 0.0, -3.0), 0.5, color=(1.0, 0.9, 0.9),
                 reflectivity=0.9, scatter_reflect=0.2, texture_index=grad)
    cam = Camera.make((0.0, 0.3, 0.5), (0.0, -0.08, -1.0), fov_y_deg=55.0, focus_dist=3.5)
    return b.build(), cam


def texturing_image_scene(tex_size: int = 64, texture: str = None,
                          texture_mapping: str = "mercator"):
    """Image-textured spheres through the mercator -> cubic remap: a
    procedural equirectangular 'planet' image reprojected onto the cube-sphere
    atlas, and a dice-style cubic atlas beside it.

    ``texture``: path to an image file (PNG/JPG) to use instead of the
    procedural planet: ``texture_mapping='mercator'`` reprojects an
    equirectangular image, ``'cubic'`` takes an already-packed 6-face atlas.
    CLI: ``render texturing-image --texture path.png``."""
    from raytracing_tests_tpu_torch.scene import projection as proj

    if texture is not None:
        atlas_from_merc = proj.load_image_texture(texture, mapping=texture_mapping)
        H, W = atlas_from_merc.shape[:2]  # the dice atlas must share the shape
    else:
        H, W = tex_size, 2 * tex_size
        v, u = np.meshgrid(np.arange(H) / H, np.arange(W) / W, indexing="ij")
        continents = (np.sin(u * 11.0) * np.cos(v * 7.0 + u * 3.0) + np.sin(v * 5.0)) > 0.35
        merc = np.where(
            continents[..., None],
            np.stack([0.25 + 0.3 * v, 0.55 - 0.2 * v, 0.2 * np.ones_like(u)], -1),
            np.stack([0.1 * np.ones_like(u), 0.25 + 0.2 * u, 0.65 - 0.2 * v], -1),
        ).astype(np.float32)
        atlas_from_merc = proj.mercator_to_cubic(merc, bilinear=True).numpy()

    # dice-style cubic atlas: face index painted as brightness + pip colour
    fw = W // 6
    dice = np.zeros((H, W, 3), np.float32)
    yy, xx = np.mgrid[0:H, 0:W]
    for f in range(6):
        dice[:, f * fw : (f + 1) * fw] = 0.15 + 0.14 * f
        cx, cy = f * fw + fw // 2, H // 2
        pip = (xx - cx) ** 2 + (yy - cy) ** 2 < (fw // 5) ** 2
        dice[pip] = (0.9, 0.1, 0.1)

    b = SceneBuilder()
    ti_planet = b.add_texture(atlas_from_merc)
    ti_dice = b.add_texture(dice)
    b.add_sphere((0.0, -100.5, -3.0), 100.0, color=(0.6, 0.6, 0.6),
                 reflectivity=1.0, scatter_reflect=1.2)
    # Low reflectivity: the absorption shading adds contrib * albedo per hit,
    # so highly reflective spheres wash toward the sky colour; mostly matte
    # spheres show their texture.
    b.add_sphere((-0.7, 0.0, -3.0), 0.6, color=(1.0, 1.0, 1.0),
                 reflectivity=0.25, scatter_reflect=0.5, texture_index=ti_planet)
    b.add_sphere((0.9, 0.0, -3.2), 0.6, color=(1.0, 1.0, 1.0),
                 reflectivity=0.25, scatter_reflect=0.5, texture_index=ti_dice)
    cam = Camera.make((0.0, 0.3, 0.5), (0.0, -0.08, -1.0), fov_y_deg=55.0, focus_dist=3.5)
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
