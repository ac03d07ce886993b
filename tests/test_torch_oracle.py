"""The port's numpy oracle (``reference/cpu_renderer.py``) against the JAX
package's, and the port's renderer against the port's oracle.

Bars:
  - the two oracles, both float64 numpy on equal float32 inputs (the scene
    and camera handed over through ``convert``): image and depth equal bit
    for bit, on four configurations.
  - the port's ``render`` (its plain versions on the CPU) against the port's
    oracle, every case of the JAX package's ``tests/test_render_parity.py``
    at its sizes, with its bar: >= 99.5 % of pixels within atol 2e-4 (5e-4
    for lights) and rtol 1e-3, both intersectors where that file uses both;
    the normals view also through the sweeps and the LBVH, and a moving
    textured scene; depth within rtol 1e-3 / atol 1e-2 (its
    ``test_depth_output``).
  - the normals view against the JAX package's render: the same bar, 99.5 %
    of pixels within atol 2e-4 / rtol 1e-3 (found 99.9 % on the generic
    grid: a float32 normal of a rotated ellipsoid hit at a grazing angle
    moves by up to 3e-4 between two roundings of its t; the oracle lies
    between the two), depth within rtol 1e-4 (found 1.6e-5: the same
    grazing hits).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax

from raytracing_tests_tpu.ops.render import RenderConfig as JRenderConfig
from raytracing_tests_tpu.ops.render import render_jit as j_render_jit
from raytracing_tests_tpu.reference.cpu_renderer import render_cpu as j_render_cpu
from raytracing_tests_tpu.scene import examples as jex
from raytracing_tests_tpu_torch import convert
from raytracing_tests_tpu_torch.ops.render import RenderConfig, extract_lights, render
from raytracing_tests_tpu_torch.reference import render_cpu

torch.set_num_threads(2)

ATOL = 2e-4


def _moving_texturing():
    js, jc = jex.texturing_scene(tex_size=16)
    dp = np.zeros(np.asarray(js.delta_position).shape, np.float32)
    dp[1] = (0.3, 0.1, 0.0)
    dp[2] = (-0.2, 0.0, 0.15)
    return js.replace(delta_position=jax.numpy.asarray(dp)), jc


# name: (JAX scene, config, for_scene): test_render_parity.py's cases, its
# sizes, and the moving textured scene
CASES = {
    "normals": (jex.sphere_scene, dict(width=24, height=16, spp=1, show_normals=True), False),
    "normals_generic": (lambda: jex.bvh_grid_scene(side=3),
                        dict(width=24, height=16, spp=2, show_normals=True), True),
    "sphere": (jex.sphere_scene, dict(width=24, height=16, spp=2, max_bounces=3), False),
    "groups": (jex.groups_scene, dict(width=20, height=14, spp=2, max_bounces=4), False),
    "materials": (jex.materials_scene, dict(width=20, height=14, spp=3, max_bounces=4), False),
    "motion_blur": (jex.motion_blur_scene, dict(width=20, height=14, spp=4, max_bounces=3),
                    False),
    "texturing": (lambda: jex.texturing_scene(tex_size=16),
                  dict(width=20, height=14, spp=2, max_bounces=3), False),
    "lights": (jex.lights_scene, dict(width=16, height=12, spp=2, max_bounces=3), False),
    "depth": (jex.sphere_scene, dict(width=24, height=16, spp=1, max_bounces=2), False),
    "materials_shading": (jex.materials_scene, dict(width=24, height=16, spp=4, max_bounces=5,
                                                    shading="materials"), True),
    "texturing_motion": (_moving_texturing, dict(width=20, height=14, spp=2, max_bounces=3),
                         False),
}
BIT_EQUAL = ("normals", "materials_shading", "lights", "texturing_motion")


def _inputs(name):
    """(JAX scene, camera, config), (port scene, camera, config)."""
    scene_fn, kw, for_scene = CASES[name]
    js, jc = scene_fn()
    leaves = {f: np.asarray(getattr(js, f)) for f in convert.SCENE_FIELDS}
    if js.textures is not None:
        leaves["textures"] = np.asarray(js.textures)
    ts = convert.scene_from_numpy(leaves)
    tc = convert.camera_from_numpy({f: np.asarray(getattr(jc, f)) for f in convert.CAMERA_FIELDS})
    jcfg, tcfg = JRenderConfig(**kw), RenderConfig(**kw)
    if for_scene:
        jcfg, tcfg = jcfg.for_scene(js), tcfg.for_scene(ts)
    return (js, jc, jcfg), (ts, tc, tcfg)


@pytest.fixture(scope="module")
def oracle():
    """The port's oracle image of each case, computed once."""
    memo = {}

    def get(name):
        if name not in memo:
            _, (ts, tc, tcfg) = _inputs(name)
            memo[name] = render_cpu(ts, tc, tcfg)
        return memo[name]

    return get


@pytest.mark.parametrize("name", BIT_EQUAL)
def test_oracle_equals_jax_oracle_bit_for_bit(name, oracle):
    (js, jc, jcfg), _ = _inputs(name)
    want = j_render_cpu(js, jc, jcfg)
    got = oracle(name)
    assert got["image"].dtype == np.float64 and got["image"].shape == want["image"].shape
    assert np.array_equal(got["image"], want["image"])
    assert np.array_equal(got["depth"], want["depth"])


def _compare(name, oracle, intersector="brute", atol=ATOL):
    _, (ts, tc, tcfg) = _inputs(name)
    cfg = dataclasses.replace(tcfg, intersector=intersector)
    if intersector != "brute" and not CASES[name][2]:
        cfg = cfg.for_scene(ts)
    lights = extract_lights(ts) if cfg.enable_lights else None
    got = render(ts, tc, cfg, lights, device="cpu")
    img_got = got["image"].numpy().astype(np.float64)
    img_want = oracle(name)["image"]
    close = np.isclose(img_got, img_want, atol=atol, rtol=1e-3)
    assert close.mean() >= 0.995, (
        f"only {close.mean():.4f} of pixels match; max err "
        f"{np.abs(img_got - img_want).max():.3e}")
    return got


RENDER_CASES = (
    [(n, "brute") for n in CASES if n not in ("depth",)]
    + [("normals", "pallas"), ("normals", "bvh"), ("normals_generic", "pallas"),
       ("materials_shading", "pallas"), ("groups", "bvh")]
)


@pytest.mark.parametrize("name,intersector", RENDER_CASES)
def test_render_matches_oracle(name, intersector, oracle):
    got = _compare(name, oracle, intersector, atol=5e-4 if name == "lights" else ATOL)
    if name == "lights":  # lights: the background is black, and something is lit
        assert got["image"].max() > 0.05
    if name.startswith("normals"):
        assert got["image"].min() < -0.1 and got["image"].max() > 0.5


def test_depth_output(oracle):
    _, (ts, tc, tcfg) = _inputs("depth")
    got = render(ts, tc, tcfg, device="cpu")
    np.testing.assert_allclose(got["depth"].numpy(), oracle("depth")["depth"],
                               rtol=1e-3, atol=1e-2)


@pytest.mark.parametrize("name", ["normals", "normals_generic"])
def test_normals_view_matches_jax(name):
    """The normals view: the world normal of each primary's hit, averaged
    without gamma, ``t`` where it hits, against the JAX package's."""
    (js, jc, jcfg), (ts, tc, tcfg) = _inputs(name)
    want = j_render_jit(js, jc, jcfg)
    got = render(ts, tc, tcfg, device="cpu")
    close = np.isclose(got["image"].numpy(), np.asarray(want["image"]), atol=ATOL, rtol=1e-3)
    assert close.mean() >= 0.995, close.mean()
    np.testing.assert_allclose(got["depth"].numpy(), np.asarray(want["depth"]), rtol=1e-4)
