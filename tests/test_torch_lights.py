"""Emissive lights in the port against the JAX package: ``extract_lights``,
``convert`` and ``pack_lights``, the queue renderer's ``_shadow_factor``, the
queue renderer and the work queue on ``lights_scene()``, and the persistent
kernel's lights branch (its plain version here, and its CUDA source rehearsed
as host C++ where there is a g++), generic and sphere-mode.

Shadow visibility is binary: a shadow ray that grazes the light's box turns on
the last ulp of its direction.  On ``lights_scene()`` that is common, not
rare: the light's world AABB is twice the panel (the conservative box of a
cuboid), so the shadow rays of samples s with s / spp = 0.25 and 0.75 aim at
the panel's own corners.  So the renderers are held as the JAX package holds
its pair, statistically.

Tolerances:
  - ``extract_lights``, ``convert.lights_from_numpy`` and ``pack_lights``:
    exact.
  - ``_shadow_factor`` element by element on 4 096 seeded hit points inside
    the room, aimed at seeded points of the light's box: equal on >= 99.9 %
    of lanes.
  - the queue renderer against JAX ``render_stats`` at 48x32x8 depth 5 by the
    statistical bars below with ray counts within 0.5 %; at 2 spp, where no
    shadow ray aims at a corner (s / spp is 0 or 0.5), the oracle bar (atol
    2e-4 / rtol 1e-3) on >= 99 % of pixels.
  - the plain persistent kernel against JAX ``render_uber`` (interpret mode)
    and against the port's queue renderer, by the bars of the JAX package's
    own lights test: image means within 5e-3, every row band's mean within
    0.05, under 1 % of depth pixels off by more than 1e-2, ray counts within
    2 %, zero dropped.  Likewise on a sphere-mode scene lit by a spherical
    light (the sphere-mode instantiation).
  - ``render_workqueue(lights=)`` against JAX's at 24x16x2 depth 3 and
    against the port's queue renderer: the oracle bar on >= 99 % of pixels,
    equal ray counts.
  - the host rehearsal of the CUDA source against the plain version: ray
    counts within 0.5 %, zero dropped, primary t within rtol 1e-5, colours
    within 1e-4 on >= 99.5 % of samples (the corner-aimed shadow rays above).
"""

import dataclasses

import numpy as np
import pytest
import torch

from raytracing_tests_tpu.kernels.uber import pack_lights as j_pack_lights
from raytracing_tests_tpu.kernels.uber import render_uber as j_render_uber
from raytracing_tests_tpu.ops.render import RenderConfig as JRenderConfig
from raytracing_tests_tpu.ops.render import _shadow_factor as j_shadow_factor
from raytracing_tests_tpu.ops.render import extract_lights as j_extract_lights
from raytracing_tests_tpu.ops.render import render_stats as j_render_stats
from raytracing_tests_tpu.ops.workqueue import render_workqueue as j_render_workqueue
from raytracing_tests_tpu.scene import examples as jex
from raytracing_tests_tpu.scene import types as jtypes
from raytracing_tests_tpu_torch import convert
from raytracing_tests_tpu_torch.kernels import uber as tub
from raytracing_tests_tpu_torch.kernels.uber import render_uber
from raytracing_tests_tpu_torch.ops.render import (
    RenderConfig, _shadow_factor, extract_lights, render_stats,
)
from raytracing_tests_tpu_torch.ops.workqueue import render_workqueue
from raytracing_tests_tpu_torch.scene import examples as tex
from raytracing_tests_tpu_torch.scene import types as ttypes

torch.set_num_threads(2)

LIGHTS = dict(width=48, height=32, spp=8, max_bounces=5, intersector="pallas")


def lit_spheres_scene(ty):
    """Spheres under one spherical emissive light: a scene the sphere mode
    takes, so the sphere-mode lights instantiation renders it."""
    b = ty.SceneBuilder()
    b.add_sphere((0.0, -100.5, -3.0), 100.0, color=(0.6, 0.6, 0.6),
                 reflectivity=0.9, scatter_reflect=1.0)
    b.add_sphere((-0.7, 0.0, -3.2), 0.5, color=(0.9, 0.3, 0.3),
                 reflectivity=0.9, scatter_reflect=0.4)
    b.add_sphere((0.7, 0.0, -2.8), 0.5, color=(0.8, 0.8, 0.8),
                 refractive_index=1.5, refractivity=0.85, reflectivity=0.15)
    b.add_light((0.0, 1.6, -3.0), (0.35, 0.35, 0.35))
    cam = ty.Camera.make((0.0, 0.4, 0.8), (0.0, -0.1, -1.0), fov_y_deg=60.0, focus_dist=3.8)
    return b.build(), cam


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_lights_envelope(a, b, ray_tol=0.02):
    """The JAX package's lights bars: means, row-band means, depth, rays."""
    ia, ib = _np(a["image"]), _np(b["image"])
    assert ia.shape == ib.shape and np.isfinite(ia).all()
    found = dict(
        mean_diff=abs(float(ia.mean()) - float(ib.mean())),
        band_max=float(np.abs(ia.mean(axis=(1, 2)) - ib.mean(axis=(1, 2))).max()),
        frac_depth=float((np.abs(_np(a["depth"]) - _np(b["depth"])) > 1e-2).mean()),
        ray_diff=abs(int(a["rays"]) - int(b["rays"])) / int(b["rays"]))
    assert found["mean_diff"] < 5e-3, found
    assert found["band_max"] < 0.05, found
    assert found["frac_depth"] < 0.01, found
    assert found["ray_diff"] < ray_tol, found
    return found


def test_extract_convert_and_pack_lights_match_jax():
    js, _ = jex.lights_scene()
    ts, _ = tex.lights_scene()
    jl = j_extract_lights(js, capacity=3)
    tl = extract_lights(ts, capacity=3)
    assert tl.capacity == 3 and int(tl.count) == 1
    leaves = {f: np.asarray(getattr(jl, f)) for f in convert.LIGHTS_FIELDS}
    for f in convert.LIGHTS_FIELDS:
        assert np.array_equal(getattr(tl, f).numpy(), leaves[f]), f
    back = convert.lights_from_numpy(leaves)
    for f, arr in convert.lights_to_numpy(back).items():
        assert arr.dtype == leaves[f].dtype and np.array_equal(arr, leaves[f]), f
    jrows, jn = j_pack_lights(jl)
    trows, tn = tub.pack_lights(tl)
    assert tn == jn == 1 and np.array_equal(trows.numpy(), np.asarray(jrows))
    assert tub.pack_lights(tl)[0] is trows  # kept on the Lights
    assert extract_lights(tex.groups_scene()[0]) is None and tub.pack_lights(None) == (None, 0)


def test_shadow_factor_matches_jax_elementwise():
    import jax.numpy as jnp

    js, _ = jex.lights_scene()
    ts, _ = tex.lights_scene()
    jl, tl = j_extract_lights(js), extract_lights(ts)
    rng = np.random.default_rng(0)
    B = 4096
    hit = np.stack([rng.uniform(-1.9, 1.9, B), rng.uniform(-0.9, 2.8, B),
                    rng.uniform(-5.9, -2.1, B)], axis=1).astype(np.float32)
    n = rng.normal(size=(B, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    ratio = rng.uniform(0.0, 1.0, B).astype(np.float32)
    tr = np.zeros(B, np.float32)
    want = np.asarray(j_shadow_factor(js, jl, jnp.asarray(hit), jnp.asarray(n),
                                      jnp.asarray(ratio), jnp.asarray(tr)))
    got = _shadow_factor(ts, tl, torch.from_numpy(hit), torch.from_numpy(n),
                         torch.from_numpy(ratio), torch.from_numpy(tr)).numpy()
    assert 0.1 < float(want.mean()) < 0.9  # lit and shadowed points both
    assert (got == want).mean() >= 0.999, (got == want).mean()


@pytest.mark.parametrize("intersector", ["pallas", "brute"])
def test_queue_renderer_matches_jax_render_stats(intersector):
    js, jc = jex.lights_scene()
    ts, tc = tex.lights_scene()
    for spp in (8, 2):
        frame = dict(LIGHTS, intersector=intersector, spp=spp)
        oj = j_render_stats(js, jc, JRenderConfig(**frame).for_scene(js), j_extract_lights(js))
        ot = render_stats(ts, tc, RenderConfig(**frame).for_scene(ts), extract_lights(ts),
                          device="cpu")
        ij, it = np.asarray(oj["image"]), ot["image"].numpy()
        assert it.shape == (32, 48, 3) and np.isfinite(it).all()
        if spp == 2:
            ok = np.isclose(it, ij, atol=2e-4, rtol=1e-3).all(axis=-1)
            assert ok.mean() >= 0.99, ok.mean()
        else:
            _assert_lights_envelope(ot, oj, ray_tol=5e-3)
        assert ot["rays_dropped"] == int(oj["rays_dropped"]) == 0
        # the background is black and a sample that sees the light is white
        assert it.max() == 1.0 and (it == 1.0).all(axis=-1).any()


SCENES = {"lights": lambda ty, ex: ex.lights_scene(),
          "lit_spheres": lambda ty, ex: lit_spheres_scene(ty)}


@pytest.fixture(scope="module", params=list(SCENES))
def lights_frames(request):
    js, jc = SCENES[request.param](jtypes, jex)
    ts, tc = SCENES[request.param](ttypes, tex)
    jcfg = JRenderConfig(**LIGHTS).for_scene(js)
    tcfg = RenderConfig(**LIGHTS).for_scene(ts)
    assert tcfg.pallas_mode == jcfg.pallas_mode == (
        "generic" if request.param == "lights" else "spheres")
    tl = extract_lights(ts)
    return dict(name=request.param, js=js, jc=jc, jcfg=jcfg, jl=j_extract_lights(js), ts=ts,
                tc=tc, tcfg=tcfg, tl=tl, port=render_uber(ts, tc, tcfg, tl, gr=16, device="cpu"))


def test_uber_lights_matches_jax_uber_statistically(lights_frames):
    f = lights_frames
    oj = j_render_uber(f["js"], f["jc"], f["jcfg"], lights=f["jl"], L=256, R=8, gr=16)
    _assert_lights_envelope(f["port"], oj)
    assert int(f["port"]["rays_dropped"]) == int(oj["rays_dropped"]) == 0


def test_uber_lights_matches_the_ports_queue_renderer(lights_frames):
    f = lights_frames
    oq = render_stats(f["ts"], f["tc"], f["tcfg"], f["tl"], device="cpu")
    _assert_lights_envelope(f["port"], oq)
    assert int(f["port"]["rays_dropped"]) == 0 and oq["rays_dropped"] == 0


def test_uber_lights_instantiation_and_white_abort(lights_frames):
    """The plain kernel under lights: the instantiation's counter name, a
    black background (no sky gradient leaks in) and samples that hit the
    emissive object exactly white."""
    f = lights_frames
    acc, cam = tub._scene_accel(f["ts"], f["tc"], f["tcfg"], 16)
    rows, n = tub.pack_lights(f["tl"])
    st = tub.UberStatics.from_cfg(f["tcfg"], n)
    assert st.bg_bottom == st.bg_top == (0.0, 0.0, 0.0) and st.model == "lights"
    assert tub.launch_name(acc, st.model) == (
        "uber_g_lt" if f["name"] == "lights" else "uber_lt")
    out, stats = tub.uber_render_plain(acc, cam, st, rows)
    white = (out[:, :3] == 1.0).all(dim=1)
    assert white.any() and int(stats[tub.ST_RAYS]) == int(f["port"]["rays"])
    with pytest.raises(ValueError):
        tub.uber_render_plain(acc, cam, dataclasses.replace(st, shading="materials"), rows)


@pytest.mark.parametrize("name", list(SCENES))
def test_workqueue_lights_matches_jax_workqueue(name):
    frame = dict(width=24, height=16, spp=2, max_bounces=3, intersector="pallas")
    js, jc = SCENES[name](jtypes, jex)
    ts, tc = SCENES[name](ttypes, tex)
    jcfg = JRenderConfig(**frame).for_scene(js)
    tcfg = RenderConfig(**frame).for_scene(ts)
    tl = extract_lights(ts)
    oj = j_render_workqueue(js, jc, jcfg, j_extract_lights(js), chunk=512)
    ot = render_workqueue(ts, tc, tcfg, tl, chunk=512, device="cpu")
    oq = render_stats(ts, tc, tcfg, tl, device="cpu")
    it = ot["image"].numpy()
    assert it.shape == (16, 24, 3) and np.isfinite(it).all()
    for ref in (np.asarray(oj["image"]), oq["image"].numpy()):
        ok = np.isclose(it, ref, atol=2e-4, rtol=1e-3).all(axis=-1)
        assert ok.mean() >= 0.99, ok.mean()
    assert int(ot["rays"]) == int(oj["rays"]) == oq["rays"]
    assert int(ot["rays_dropped"]) == int(oj["rays_dropped"]) == 0


@pytest.mark.parametrize("name", list(SCENES))
def test_lights_kernel_source_rehearsed_on_the_host(name):
    """The lights instantiations of ``csrc/uber.cu`` compiled as host C++,
    generic (``lights_scene``) and sphere mode, against the plain version."""
    import shutil

    from raytracing_tests_tpu_torch.kernels import _build

    if shutil.which("g++") is None:
        pytest.skip("no g++ to rehearse the kernel source with")
    ts, tc = SCENES[name](ttypes, tex)
    cfg = RenderConfig(**dict(LIGHTS, width=24, height=16, spp=4)).for_scene(ts)
    rows, n = tub.pack_lights(extract_lights(ts))
    acc, cam = tub._scene_accel(ts, tc, cfg, 16)
    st = tub.UberStatics.from_cfg(cfg, n)
    want, stats_p = tub.uber_render_plain(acc, cam, st, rows)
    with _build.host_rehearsal():
        got, stats = tub._launch_uber(acc, cam, st, rows)
    rays, rays_p = int(stats[tub.ST_RAYS]), int(stats_p[tub.ST_RAYS])
    assert abs(rays - rays_p) / rays_p < 5e-3 and int(stats[tub.ST_DROPPED]) == 0
    assert int(stats[tub.ST_SHADOW_RAYS]) > 0
    np.testing.assert_allclose(got[:, 3].numpy(), want[:, 3].numpy(), rtol=1e-5)
    cerr = (got[:, :3] - want[:, :3]).abs().amax(dim=1)
    assert (cerr <= 1e-4).float().mean() >= 0.995, float((cerr <= 1e-4).float().mean())


def test_lights_workload_renders_through_the_cli(tmp_path):
    from raytracing_tests_tpu_torch.app.cli import main

    for uber in ([], ["--uber"]):
        out = tmp_path / f"l{len(uber)}.png"
        main(["render", "lights", "--device", "cpu", "--width", "16", "--height", "12",
              "--spp", "2", "--out", str(out), *uber])
        assert out.stat().st_size > 0
