"""The work-queue renderer against the port's queue renderer and the JAX
package's ``render_workqueue``.

On the CPU both of the port's renderers run the plain versions of the sweep
kernels; the JAX side runs its Pallas kernels in interpret mode.  Sizes are the
JAX package's own test sizes: 24x16x2 depth 3 with ``chunk=512`` on ``groups``,
``motion`` and ``bvh-grid(side=4)``, and an odd 7x5x3 depth 4 with
``chunk=256``.

Tolerances:
  - against the port's ``render`` (the same ``shade_rays`` on the same sweeps,
    the children in another order): image atol 2e-5, depth atol 1e-4, equal
    ray counts (found: equal images on all three scenes).
  - against JAX ``render_workqueue``: every pixel inside the oracle bar (atol
    2e-4 / rtol 1e-3), equal ``rays`` and ``iterations``, zero dropped (found:
    images within 2.1e-6).
  - a pool too small for the frame's children drops the same count as JAX's,
    and more than none.
  - ``tile_order_perm`` equal to JAX's.
"""

import dataclasses

import numpy as np
import pytest
import torch

from raytracing_tests_tpu.ops.render import RenderConfig as JRenderConfig
from raytracing_tests_tpu.ops.workqueue import render_workqueue as j_render_workqueue
from raytracing_tests_tpu.ops.workqueue import tile_order_perm as j_tile_order_perm
from raytracing_tests_tpu.scene import examples as jex
from raytracing_tests_tpu_torch.ops.render import (
    RenderConfig, extract_lights, render, render_stats,
)
from raytracing_tests_tpu_torch.ops.workqueue import render_workqueue, tile_order_perm
from raytracing_tests_tpu_torch.scene import examples as tex

torch.set_num_threads(2)

SCENES = {
    "groups": lambda ex: ex.groups_scene(),
    "motion": lambda ex: ex.motion_blur_scene(),
    "bvh-grid": lambda ex: ex.bvh_grid_scene(side=4),
}
FRAME = dict(width=24, height=16, spp=2, max_bounces=3, intersector="pallas")


@pytest.mark.parametrize("name", list(SCENES))
def test_workqueue_matches_queue(name):
    scene, cam = SCENES[name](tex)
    cfg = RenderConfig(**FRAME).for_scene(scene)
    rq = render_stats(scene, cam, cfg, device="cpu")
    rw = render_workqueue(scene, cam, cfg, chunk=512, device="cpu")
    np.testing.assert_allclose(rw["image"].numpy(), rq["image"].numpy(), atol=2e-5, rtol=0)
    np.testing.assert_allclose(rw["depth"].numpy(), rq["depth"].numpy(), atol=1e-4, rtol=0)
    assert int(rw["rays"]) == rq["rays"] and rw["rays_dropped"] == 0
    assert rw["iterations"] >= 2


@pytest.mark.parametrize("name", list(SCENES))
def test_workqueue_matches_jax_workqueue(name):
    js, jc = SCENES[name](jex)
    ts, tc = SCENES[name](tex)
    jcfg = JRenderConfig(**FRAME).for_scene(js)
    tcfg = RenderConfig(**FRAME).for_scene(ts)
    assert jcfg.has_motion == tcfg.has_motion == (name == "motion")
    oj = j_render_workqueue(js, jc, jcfg, chunk=512)
    ot = render_workqueue(ts, tc, tcfg, chunk=512, device="cpu")
    ij, it = np.asarray(oj["image"]), ot["image"].numpy()
    assert it.shape == (16, 24, 3) and np.isfinite(it).all()
    ok = np.isclose(it, ij, atol=2e-4, rtol=1e-3).all(axis=-1)
    assert ok.all(), ok.mean()
    assert int(ot["rays"]) == int(oj["rays"])
    assert int(ot["iterations"]) == int(oj["iterations"])
    assert ot["rays_dropped"] == int(oj["rays_dropped"]) == 0


@pytest.mark.parametrize("intersector", ["pallas", "brute"])
def test_workqueue_odd_sizes(intersector):
    """7x5x3 lanes in chunks of 256: one ragged chunk of primaries, then the
    children; on the scene with glass, so both kinds of child are compacted."""
    scene, cam = tex.iow_final_scene(side=5)
    cfg = RenderConfig(width=7, height=5, spp=3, max_bounces=4,
                       intersector=intersector).for_scene(scene)
    rq = render(scene, cam, cfg, device="cpu")
    rw = render_workqueue(scene, cam, cfg, chunk=256, device="cpu")
    np.testing.assert_allclose(rw["image"].numpy(), rq["image"].numpy(), atol=2e-5, rtol=0)
    assert rw["rays_dropped"] == 0


def test_pool_overflow_drops_the_same_count_as_jax():
    """768 primaries in chunks of 128 with ``pool_factor=1``: the pool holds
    B + 4 chunks and the write cursor is clamped two chunks before its end, so
    the late children are dropped, and counted."""
    js, jc = jex.motion_blur_scene()
    ts, tc = tex.motion_blur_scene()
    jcfg = JRenderConfig(**FRAME).for_scene(js)
    tcfg = RenderConfig(**FRAME).for_scene(ts)
    oj = j_render_workqueue(js, jc, jcfg, chunk=128, pool_factor=1.0)
    ot = render_workqueue(ts, tc, tcfg, chunk=128, pool_factor=1.0, device="cpu")
    assert int(oj["rays_dropped"]) > 0
    assert ot["rays_dropped"] == int(oj["rays_dropped"])
    assert int(ot["rays"]) == int(oj["rays"])
    assert torch.isfinite(ot["image"]).all()
    full = render_workqueue(ts, tc, tcfg, chunk=128, device="cpu")
    assert full["rays_dropped"] == 0 and int(full["rays"]) > int(ot["rays"])


@pytest.mark.parametrize("size", [(24, 16, 2, 8), (7, 5, 3, 4), (10, 9, 1, 16)])
def test_tile_order_perm_matches_jax(size):
    got, want = tile_order_perm(*size), np.asarray(j_tile_order_perm(*size))
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int32 and sorted(got.tolist()) == list(range(size[0] * size[1] * size[2]))


def test_tile_order_changes_nothing_in_the_picture():
    scene, cam = tex.groups_scene()
    cfg = RenderConfig(**FRAME).for_scene(scene)
    a = render_workqueue(scene, cam, cfg, chunk=512, device="cpu")
    b = render_workqueue(scene, cam, cfg, chunk=512, tile=8, device="cpu")
    np.testing.assert_allclose(b["image"].numpy(), a["image"].numpy(), atol=1e-6, rtol=0)
    assert torch.equal(a["depth"], b["depth"]) and int(a["rays"]) == int(b["rays"])


@pytest.mark.parametrize("what", ["materials", "lights"])
def test_workqueue_refuses_what_it_does_not_render(what):
    scene, cam = tex.groups_scene()
    cfg = RenderConfig(**FRAME).for_scene(scene)
    lights = None
    if what == "materials":
        cfg = dataclasses.replace(cfg, shading="materials")
    else:
        # lights render (test_torch_lights holds them); materials shading
        # stays refused with lights too
        scene, cam = tex.lights_scene()
        lights = extract_lights(scene)
        cfg = RenderConfig(**FRAME).for_scene(scene)
        lit = render_workqueue(scene, cam, cfg, lights, chunk=512, device="cpu")
        assert torch.isfinite(lit["image"]).all() and int(lit["rays_dropped"]) == 0
        cfg = dataclasses.replace(cfg, shading="materials")
    with pytest.raises(NotImplementedError):
        render_workqueue(scene, cam, cfg, lights, device="cpu")
