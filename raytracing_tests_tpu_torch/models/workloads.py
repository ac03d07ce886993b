"""The registered workloads whose scenes are ported.

| name          | mirrors reference test                              |
|---------------|-----------------------------------------------------|
| sphere        | IOW-01 Adding Sphere                                |
| groups        | IOW-02 Groups                                       |
| materials     | IOW-03 Shadows and Materials                        |
| motion-blur   | INW-00 Motion Blur                                  |
| bvh           | INW-01 Bounding Volume Hierarchy                    |
| texturing     | INW-03 Solid and Noise Textures                     |
| texturing-image | INW-03 image textures (mercator remap, dice atlas) |
| lights        | INW-04 Lights, Camera and Action                    |
| iow-final     | the In-One-Weekend cover scene (the headline frame) |
"""

from __future__ import annotations

from typing import Optional

from raytracing_tests_tpu_torch.models.registry import register
from raytracing_tests_tpu_torch.ops.render import RenderConfig, extract_lights, render
from raytracing_tests_tpu_torch.scene import examples


def _rt_run(scene_fn, defaults: dict, lights: bool = False):
    """Shared run function of the raytracing workloads; ``lights``: render
    with the scene's emissive objects as lights."""

    def run(
        width: Optional[int] = None,
        height: Optional[int] = None,
        spp: Optional[int] = None,
        max_bounces: Optional[int] = None,
        show_normals: bool = False,
        intersector: Optional[str] = None,
        lane_chunk: Optional[int] = None,
        mesh=None,
        uber: bool = False,
        progressive: bool = False,
        tiles_per_step: int = 4,
        on_frame=None,
        device=None,
        **scene_kw,
    ):
        """Render the workload's frame.  ``progressive``: the spiral tiles of
        ``ops.tiles.render_progressive``, ``tiles_per_step`` a step, each
        step's dict(image, done_fraction) handed to ``on_frame``; the last
        step is the result.  Otherwise ``mesh`` (``parallel.make_mesh``)
        shards its rows: ``render_uber_sharded`` with ``uber``, else
        ``render_sharded``; the mesh names the devices, so ``device`` is
        not read then."""
        scene, camera = scene_fn(**scene_kw)
        cfg = RenderConfig(
            width=width or defaults.get("width", 128),
            height=height or defaults.get("height", 72),
            spp=spp or defaults.get("spp", 4),
            max_bounces=max_bounces or defaults.get("max_bounces", 5),
            show_normals=show_normals,
            intersector=intersector or defaults.get("intersector", "brute"),
            lane_chunk=lane_chunk,
            shading=defaults.get("shading", "bvh"),
        )
        cfg = cfg.for_scene(scene)
        lt = extract_lights(scene) if lights else None
        if progressive:
            from raytracing_tests_tpu_torch.ops.tiles import render_progressive

            step = None
            for step in render_progressive(scene, camera, cfg, lt,
                                           tiles_per_step=tiles_per_step, device=device):
                if on_frame is not None:
                    on_frame(step)
            return dict(step, scene=scene, camera=camera, cfg=cfg)
        if uber and mesh is not None:
            from raytracing_tests_tpu_torch.parallel import render_uber_sharded

            out = render_uber_sharded(scene, camera, cfg, mesh, lt)
        elif uber:
            from raytracing_tests_tpu_torch.kernels.uber import render_uber

            out = render_uber(scene, camera, cfg, lt, device=device)
        elif mesh is not None:
            from raytracing_tests_tpu_torch.parallel import render_sharded

            out = render_sharded(scene, camera, cfg, mesh, lt)
        else:
            out = render(scene, camera, cfg, lt, device=device)
        return dict(out, scene=scene, camera=camera, cfg=cfg)

    return run


register(
    "sphere",
    "one sphere over a ground slab; camera with pitch/yaw + focus",
    reference="In-One-Weekend/01_Adding_Sphere",
)(_rt_run(examples.sphere_scene, dict(spp=1, max_bounces=2)))

register(
    "groups",
    "N-object cuboid/ellipsoid scene with per-object rotations and mirror bounces",
    reference="In-One-Weekend/02_Groups",
)(_rt_run(examples.groups_scene, dict(spp=4)))

register(
    "materials",
    "full Shirley materials: dielectric + metal + lambertian with DOF "
    "(per-ray medium RI, Schlick shift, fibonacci scatter)",
    reference="In-One-Weekend/03_Shadows_and_Materials",
)(_rt_run(examples.materials_scene, dict(spp=16, max_bounces=5, shading="materials")))

register(
    "motion-blur",
    "objects swept between two checkpoints, per-sample time lerp",
    reference="In-Next-Week/00_MotionBlur",
)(_rt_run(examples.motion_blur_scene, dict(spp=16, max_bounces=5)))

register(
    "bvh",
    "grid of alternating ellipsoids / rotated cuboids through the grouped sweep; "
    "--bvh for the LBVH traversal (the reference-semantics oracle, not a fast path)",
    reference="In-Next-Week/01_BoundingVolumeHierarchy",
)(_rt_run(examples.bvh_grid_scene, dict(spp=4, intersector="pallas")))

register(
    "texturing",
    "cube-sphere textured objects: checker, simplex-noise and gradient atlases",
    reference="In-Next-Week/03_Solid_And_Noise_Textures",
)(_rt_run(examples.texturing_scene, dict(spp=4)))

register(
    "texturing-image",
    "image textures: procedural mercator planet (reprojected to cube atlas) + dice atlas",
    reference="In-Next-Week/03 texturing.cpp:41 + utility.cpp:253-487",
)(_rt_run(examples.texturing_image_scene, dict(spp=4)))

register(
    "lights",
    "emissive Cornell-style scene with AABB-targeted shadow rays",
    reference="In-Next-Week/04_Lights_Camera_And_Action",
)(_rt_run(examples.lights_scene, dict(spp=8, max_bounces=4), lights=True))

register(
    "iow-final",
    "the Ray Tracing in One Weekend cover scene (~480 spheres) — the headline frame",
    reference="BASELINE.json configs[0]",
)(_rt_run(examples.iow_final_scene, dict(width=400, height=225, spp=16, max_bounces=8)))
