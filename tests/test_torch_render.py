"""The port's queue renderer against the JAX package and the golden images.

Tolerances (the JAX side runs under ``jit``, where XLA:CPU fuses a*b+c into
one rounding; eager PyTorch rounds twice):
  - ``sphere_scene`` and ``groups_scene`` hold the oracle bar: >= 99.5 % of
    pixels within atol 2e-4 / rtol 1e-3, ray counts within 0.5 %, and the
    goldens at atol 2e-5.
  - ``iow_final_scene(side=5)`` cannot: its 1000-radius ground sphere is
    ill-conditioned in float32 (|o/r|^2 - 1 cancels), so a last-ulp difference
    moves a hit by ~1e-4 of its distance and flips grazing children.  Found:
    96.4 % of pixels inside the oracle bar, ray counts 0.3 % apart.  Held to
    >= 95 % inside the bar plus the statistical envelope of the persistent
    kernel's canary: image means within 5e-3, under 3 % of pixels off by more
    than 0.05, ray counts within 0.5 %.
  - goldens: ``bvh`` was rendered by the JAX package's first-generation
    grouped sweep, which the port's ``bvh`` workload now runs too (its plain
    version here): all pixels within 3e-4, which is the bar.  ``iow-final``:
    91 % within 2e-5 found; held to >= 88 % plus the statistical envelope.
  - generic scenes through ``intersector="pallas"`` (the first-generation
    sweeps, grouped by 32 and dense) against the JAX package's same path at
    48x32x4: the oracle bar (>= 99.5 % of pixels within atol 2e-4 / rtol
    1e-3), ray counts within 0.3 %.  Found on four scenes, grouped and dense:
    every pixel inside the bar, equal ray counts.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax

from raytracing_tests_tpu.ops.render import RenderConfig as JRenderConfig
from raytracing_tests_tpu.ops.render import render_samples as j_render_samples
from raytracing_tests_tpu.ops.render import render_stats as j_render_stats
from raytracing_tests_tpu.scene import examples as jex
from raytracing_tests_tpu_torch.models import get_workload, list_workloads
from raytracing_tests_tpu_torch.ops.megalanes import render_megalanes
from raytracing_tests_tpu_torch.ops.render import (
    RenderConfig, extract_lights, render, render_samples, render_stats,
)
from raytracing_tests_tpu_torch.ops.workqueue import render_workqueue
from raytracing_tests_tpu_torch.scene import examples as tex
from raytracing_tests_tpu_torch.scene import types as ttypes
from raytracing_tests_tpu.scene import types as jtypes
from test_goldens import RT_KW, SPECIAL_KW
from test_torch_sweep2g import anisotropic_scene, dielectric_scene, overlapping_glass_scene

torch.set_num_threads(2)

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")
SIZE = dict(width=48, height=32, spp=4, max_bounces=5)
SCENES = {
    "sphere": ("sphere_scene", {}, 0.995),
    "groups": ("groups_scene", {}, 0.995),
    "iow5": ("iow_final_scene", {"side": 5}, 0.95),
}


def _envelope(a, b):
    d = np.abs(a - b).max(axis=-1)
    assert abs(float(a.mean()) - float(b.mean())) < 5e-3
    assert (d > 0.05).mean() < 0.03, (d > 0.05).mean()


@pytest.mark.parametrize("name", list(SCENES))
def test_queue_renderer_matches_jax_brute(name):
    fn, kw, bar = SCENES[name]
    js, jc = getattr(jex, fn)(**kw)
    ts, tc = getattr(tex, fn)(**kw)
    jcfg = JRenderConfig(**SIZE).for_scene(js)
    tcfg = RenderConfig(**SIZE).for_scene(ts)
    for f in ("has_dielectrics", "pallas_mode", "has_motion", "probe_rows", "pops"):
        assert getattr(jcfg, f) == getattr(tcfg, f), f
    oj = jax.jit(lambda s, c: j_render_stats(s, c, jcfg))(js, jc)
    ot = render_stats(ts, tc, tcfg, device="cpu")
    ij, it = np.asarray(oj["image"]), ot["image"].numpy()
    assert it.shape == (32, 48, 3) and ot["depth"].shape == (32, 48)
    ok = np.isclose(it, ij, atol=2e-4, rtol=1e-3).all(axis=-1)
    assert ok.mean() >= bar, ok.mean()
    _envelope(it, ij)
    rj, rt = int(oj["rays"]), int(ot["rays"])
    assert abs(rj - rt) / rj < 5e-3, (rj, rt)
    assert int(ot["rays_dropped"]) == int(oj["rays_dropped"]) == 0
    dd = np.abs(ot["depth"].numpy() - np.asarray(oj["depth"]))
    assert (dd > 1e-2).mean() < 0.01


GOLDEN_KW = dict(width=32, height=24, spp=2, max_bounces=3)


@pytest.mark.parametrize("name,atol", [("sphere", 2e-5), ("groups", 2e-5), ("bvh", 3e-4)])
def test_golden(name, atol):
    out = get_workload(name).run(device="cpu", **GOLDEN_KW)
    golden = np.load(os.path.join(GOLDEN_DIR, f"{name}.npy"))
    np.testing.assert_allclose(out["image"].numpy(), golden, atol=atol, rtol=0)


@pytest.mark.parametrize("name,share,ceiling", [
    ("lights", 1.0, 2e-5), ("materials", 767 / 768, 1e-4), ("motion-blur", 1.0, 2e-5),
    ("uv-image", 1.0, 2e-5), ("blur", 1.0, 2e-5), ("buffer", 1.0, 2e-5), ("evolve", 1.0, 2e-5),
])
def test_golden_of_the_other_workloads(name, share, ceiling):
    """The seven remaining goldens at their own sizes and the JAX suite's
    atol 2e-5 (``tests/test_goldens.py``): at least
    ``share`` of the pixels within it, every one within ``ceiling``.

    All but ``materials`` hold every pixel.  ``materials`` holds 767 of 768:
    pixel (8, 19) is 2.59e-5 off.  Its second sample hits the 100-radius
    ground sphere, where the refined root cancels; the golden was rendered
    under ``jit``, where XLA fuses a*b+c, and eager evaluation rounds twice.
    The port computes what the JAX package computes eagerly
    (``test_the_materials_golden_pixel_is_jits_rounding``)."""
    w = get_workload(name)
    kw = SPECIAL_KW.get(name, RT_KW if w.category == "raytracing" else {})
    img = torch.as_tensor(w.run(device="cpu", **kw)["image"]).numpy()
    golden = np.load(os.path.join(GOLDEN_DIR, f"{name}.npy"))
    assert img.shape == golden.shape
    d = np.abs(img.astype(np.float32) - golden).max(axis=-1)
    assert (d <= 2e-5).mean() >= share and d.max() <= ceiling, ((d <= 2e-5).mean(), d.max())


def test_the_materials_golden_pixel_is_jits_rounding():
    """The JAX package's own render of the ``materials`` golden with
    ``jax.disable_jit()`` (eager, each a*b+c rounded twice, as the port
    rounds) gives every sample within 2e-6 of the port's (1.4e-6 found), and
    its image is off the golden at pixel (8, 19) by what the port's is
    (within 1e-6): the pixel the port's golden test lets go is jit's."""
    kw = dict(RT_KW, shading="materials")
    js, jc = jex.materials_scene()
    ts, tc = tex.materials_scene()
    with jax.disable_jit():
        jcol, jt = j_render_samples(js, jc, JRenderConfig(**kw).for_scene(js))
    tcol, tt = render_samples(ts, tc, RenderConfig(**kw).for_scene(ts), device="cpu")
    jcol, tcol = np.asarray(jcol), tcol.numpy()
    np.testing.assert_allclose(tcol, jcol, atol=2e-6, rtol=0)
    golden = np.load(os.path.join(GOLDEN_DIR, "materials.npy"))
    off = [np.abs(np.sqrt(np.maximum(c, 0.0)).mean(axis=2) - golden).max(axis=-1)
           for c in (jcol, tcol)]
    assert off[0][8, 19] > 2e-5 and abs(off[0][8, 19] - off[1][8, 19]) <= 1e-6, (
        off[0][8, 19], off[1][8, 19])


@pytest.mark.parametrize("intersector", ["brute", "pallas"])
def test_golden_iow_final_statistically(intersector):
    out = get_workload("iow-final").run(device="cpu", intersector=intersector, **GOLDEN_KW)
    golden = np.load(os.path.join(GOLDEN_DIR, "iow-final.npy"))
    img = out["image"].numpy()
    assert np.isfinite(img).all()
    bar = 0.88 if intersector == "brute" else 0.80  # the golden is a brute render
    assert (np.abs(img - golden).max(axis=-1) <= 2e-5).mean() >= bar
    _envelope(img, golden)


def test_registry_lists_the_ported_workloads():
    """The port registers the JAX package's 13 workloads, each in its category."""
    from raytracing_tests_tpu.models import list_workloads as jax_workloads

    assert [(w.category, w.name) for w in list_workloads()] == [
        (w.category, w.name) for w in jax_workloads()]
    assert len(list_workloads()) == 13
    assert {w.name for w in list_workloads("compute")} == {"blur", "buffer", "evolve", "uv-image"}
    with pytest.raises(KeyError):
        get_workload("no-such-workload")


def test_sweep_intersector_matches_brute_in_the_port():
    scene, cam = tex.iow_final_scene(side=5)
    # 8 spp, the persistent kernel's test setting: one flipped sample of 4
    # would move a pixel past the envelope's 0.05
    cfg_b = RenderConfig(**dict(SIZE, spp=8)).for_scene(scene)
    cfg_p = dataclasses.replace(cfg_b, intersector="pallas")
    ob = render_stats(scene, cam, cfg_b, device="cpu")
    op = render_stats(scene, cam, cfg_p, device="cpu")
    _envelope(op["image"].numpy(), ob["image"].numpy())
    assert abs(ob["rays"] - op["rays"]) / ob["rays"] < 5e-3
    dd = (ob["depth"] - op["depth"]).abs().numpy()
    assert (dd > 1e-2).mean() < 0.01


def test_lane_chunk_changes_nothing():
    scene, cam = tex.groups_scene()
    cfg = RenderConfig(width=20, height=12, spp=3, max_bounces=4).for_scene(scene)
    whole = render_stats(scene, cam, cfg, device="cpu")
    parts = render_stats(scene, cam, dataclasses.replace(cfg, lane_chunk=100), device="cpu")
    assert torch.equal(whole["image"], parts["image"])
    assert torch.equal(whole["depth"], parts["depth"])
    assert whole["rays"] == parts["rays"] and whole["rays_dropped"] == parts["rays_dropped"]
    only = render(scene, cam, cfg, device="cpu")
    assert torch.equal(only["image"], whole["image"])


def test_queue_overflow_is_counted():
    scene, cam = tex.iow_final_scene(side=5)
    cfg = RenderConfig(queue_capacity=1, **SIZE).for_scene(scene)
    out = render_stats(scene, cam, cfg, device="cpu")
    assert out["rays_dropped"] > 0 and torch.isfinite(out["image"]).all()


@pytest.mark.parametrize("what", ["lights", "materials", "bvh_intersector", "generic_sweep"])
def test_unported_options_raise(what):
    scene, cam = tex.groups_scene()
    cfg = RenderConfig(width=8, height=4, spp=1).for_scene(scene)
    lights = None
    render_fn = render_stats
    if what == "lights":
        # lights render (test_torch_lights); the megalanes drain refuses
        # them, as the JAX package's does
        scene, cam = tex.lights_scene()
        lights = extract_lights(scene)
        cfg = RenderConfig(width=8, height=4, spp=1).for_scene(scene)
        lit = render_stats(scene, cam, cfg, lights, device="cpu")
        assert torch.isfinite(lit["image"]).all() and lit["rays_dropped"] == 0
        render_fn = render_megalanes
    elif what == "materials":
        # materials shading renders (test_torch_materials); the work queue
        # refuses it, as the JAX package's does
        cfg = dataclasses.replace(cfg, shading="materials")
        mat = render_stats(scene, cam, cfg, device="cpu")
        assert torch.isfinite(mat["image"]).all() and mat["rays_dropped"] == 0
        render_fn = render_workqueue
    elif what == "bvh_intersector":
        # the LBVH intersector is ported: it renders what the dense
        # intersector renders; an intersector nobody knows still raises
        walked = render(scene, cam, dataclasses.replace(cfg, intersector="bvh"), device="cpu")
        dense = render(scene, cam, cfg, device="cpu")
        np.testing.assert_allclose(walked["image"].numpy(), dense["image"].numpy(), atol=1e-5)
        cfg = dataclasses.replace(cfg, intersector="kd_tree")
        render_fn = render
    else:
        # the sweep for generic scenes is ported: it renders what the dense
        # intersector renders; an intersector nobody knows still raises
        swept = render_stats(scene, cam, dataclasses.replace(cfg, intersector="pallas"),
                             device="cpu")
        dense = render_stats(scene, cam, cfg, device="cpu")
        assert cfg.pallas_mode == "generic"
        np.testing.assert_allclose(swept["image"].numpy(), dense["image"].numpy(), atol=2e-4)
        cfg = dataclasses.replace(cfg, intersector="generic_sweep")
    with pytest.raises(NotImplementedError):
        render_fn(scene, cam, cfg, lights, device="cpu")


GENERIC = {
    "bvh5": (lambda ex, ty: ex.bvh_grid_scene(side=5), 5),
    "anisotropic": (lambda ex, ty: anisotropic_scene(ty), 6),
    "dielectric": (lambda ex, ty: dielectric_scene(ty), 6),
    "overlapping_glass": (lambda ex, ty: overlapping_glass_scene(ty), 6),
}


@pytest.mark.parametrize("groups", [32, 0])
@pytest.mark.parametrize("name", list(GENERIC))
def test_generic_sweep_renderer_matches_jax(name, groups):
    """``intersector="pallas"`` on a generic scene: the grouped (32) and the
    dense (0) first-generation sweep, against the JAX package's same path."""
    factory, depth = GENERIC[name]
    js, jc = factory(jex, jtypes)
    ts, tc = factory(tex, ttypes)
    frame = dict(width=48, height=32, spp=4, max_bounces=depth, intersector="pallas",
                 pallas_groups=groups)
    jcfg = JRenderConfig(**frame).for_scene(js)
    tcfg = RenderConfig(**frame).for_scene(ts)
    assert tcfg.pallas_mode == jcfg.pallas_mode == "generic"
    oj = jax.jit(lambda s, c: j_render_stats(s, c, jcfg))(js, jc)
    ot = render_stats(ts, tc, tcfg, device="cpu")
    ij, it = np.asarray(oj["image"]), ot["image"].numpy()
    ok = np.isclose(it, ij, atol=2e-4, rtol=1e-3).all(axis=-1)
    rj, rt = int(oj["rays"]), int(ot["rays"])
    assert np.isfinite(it).all() and ok.mean() >= 0.995, ok.mean()
    assert abs(rj - rt) / rj < 3e-3, (rj, rt)
    assert int(ot["rays_dropped"]) == int(oj["rays_dropped"]) == 0
    dd = np.abs(ot["depth"].numpy() - np.asarray(oj["depth"]))
    assert (dd > 1e-2).mean() < 0.01
    # ... and the port's dense intersector on the same frame
    ob = render_stats(ts, tc, dataclasses.replace(tcfg, intersector="brute"), device="cpu")
    okb = np.isclose(it, ob["image"].numpy(), atol=2e-4, rtol=1e-3).all(axis=-1)
    assert okb.mean() >= 0.995 and abs(ob["rays"] - rt) / rt < 3e-3, okb.mean()


@pytest.mark.parametrize("groups", [32, 0])
def test_first_generation_sweeps_render_a_sphere_scene(groups):
    """``pallas_v2=False`` sends a sphere scene through the first-generation
    sweeps with their fused refractive index (grouped and dense) instead of
    the grouped sphere sweep; the picture is the dense intersector's."""
    scene, cam = tex.iow_final_scene(side=5)
    cfg_b = RenderConfig(**dict(SIZE, spp=8)).for_scene(scene)
    cfg_p = dataclasses.replace(cfg_b, intersector="pallas", pallas_v2=False,
                                pallas_groups=groups)
    assert cfg_p.pallas_mode == "spheres" and cfg_p.has_dielectrics
    ob = render_stats(scene, cam, cfg_b, device="cpu")
    op = render_stats(scene, cam, cfg_p, device="cpu")
    _envelope(op["image"].numpy(), ob["image"].numpy())
    assert abs(ob["rays"] - op["rays"]) / ob["rays"] < 5e-3
    assert op["rays_dropped"] == 0
