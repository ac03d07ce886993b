"""Materials shading in the port against the JAX package: the queue
renderer's ``_shade_materials``, the queue renderer on ``materials_scene()``,
the persistent kernel's materials branch (its plain version here, and its CUDA
source rehearsed as host C++ where there is a g++), and a stack deeper than
eight records.

Tolerances:
  - ``_shade_materials`` element by element on 4 096 seeded lanes: every mask
    equal, every float within 1e-5 absolute (the scatter's cos/sin and the
    Schlick power are the libraries' own, an ulp apart on some arguments).
  - the queue renderer against JAX ``render_stats`` on ``materials_scene()``
    at 48x32x4 depth 5: the oracle bar, >= 99.5 % of pixels within atol 2e-4
    / rtol 1e-3, and ray counts within 0.5 %.
  - the plain persistent kernel against JAX ``render_uber`` (interpret mode)
    and against the port's queue renderer, by the bars of the JAX package's
    own materials tests: image means within 5e-3, under 3 % of pixels off by
    more than 0.05, ray counts within 2 %, zero dropped; on the nested glass
    shell (40x28x4 depth 7) the port's plain kernel and queue renderer count
    equal rays, as the JAX test asks of its pair.
  - ``queue_capacity=16`` through the plain kernel against the queue
    renderer with the same stack, on twelve concentric glass shells at depth
    16 (33 nodes a tree), where a stack of 8 drops rays: zero dropped, the
    envelope above, and equal ray counts under materials shading (under
    'bvh' the kernel's refine and the queue renderer's intersector round
    apart: within 0.5 %).
  - the host rehearsal of the CUDA source against the plain version: equal
    ray and drop counts, colours within 1e-4 on >= 99.9 % of samples,
    primary t within rtol 1e-5.
"""

import dataclasses
import importlib
import types

import numpy as np
import pytest
import torch

from raytracing_tests_tpu.kernels.uber import render_uber as j_render_uber
from raytracing_tests_tpu.ops.render import RenderConfig as JRenderConfig
from raytracing_tests_tpu.ops.render import render_stats as j_render_stats
from raytracing_tests_tpu.scene import examples as jex
from raytracing_tests_tpu.scene import types as jtypes
from raytracing_tests_tpu_torch.kernels import uber as tub
from raytracing_tests_tpu_torch.kernels.uber import render_uber
from raytracing_tests_tpu_torch.ops.render import RenderConfig, render_stats
from raytracing_tests_tpu_torch.scene import examples as tex
from raytracing_tests_tpu_torch.scene import types as ttypes

torch.set_num_threads(2)

jrender = importlib.import_module("raytracing_tests_tpu.ops.render")
trender = importlib.import_module("raytracing_tests_tpu_torch.ops.render")

MATERIALS = dict(width=48, height=32, spp=4, max_bounces=5, shading="materials",
                 intersector="pallas")
NESTED = dict(width=40, height=28, spp=4, max_bounces=7, shading="materials",
              intersector="pallas")


def nested_dielectric_scene(ty):
    """A glass shell with an air bubble over a matte ground sphere (the JAX
    package's nested-dielectric materials test)."""
    b = ty.SceneBuilder()
    b.add_sphere((0.0, -100.5, -3.0), 100.0, color=(0.6, 0.7, 0.5),
                 reflectivity=1.0, scatter_reflect=1.0)
    b.add_sphere((0.0, 0.0, -3.0), 0.5, color=(1.0, 1.0, 1.0),
                 refractive_index=1.5, refractivity=0.9, reflectivity=0.1)
    b.add_sphere((0.0, 0.0, -3.0), 0.3, color=(1.0, 1.0, 1.0),
                 refractive_index=1.0, refractivity=0.95, reflectivity=0.05)
    cam = ty.Camera.make((0.0, 0.2, 0.4), (0.0, -0.05, -1.0), fov_y_deg=55.0,
                         focus_dist=3.4)
    return b.build(), cam


def glass_shells_scene(n):
    """``n`` concentric glass spheres of alternating refractive index over a
    ground sphere: a camera ray that enters them under materials shading
    stacks one reflection at each of the n surfaces it enters."""
    b = ttypes.SceneBuilder()
    for k in range(n):
        b.add_sphere((0.0, 0.0, -3.0), 1.2 - k * (1.0 / n), color=(0.95, 0.95, 0.95),
                     refractive_index=(1.5, 1.3)[k % 2], refractivity=0.9, reflectivity=0.1)
    b.add_sphere((0.0, -101.3, -3.0), 100.0, color=(0.5, 0.6, 0.4), reflectivity=1.0,
                 scatter_reflect=1.0)
    return b.build(), ttypes.Camera.make((0.0, 0.2, 0.5), (0.0, -0.05, -1.0), fov_y_deg=50.0,
                                         focus_dist=3.5)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _envelope(a, b, ray_tol=0.02):
    ia, ib = _np(a["image"]), _np(b["image"])
    assert ia.shape == ib.shape and np.isfinite(ia).all()
    found = dict(mean_diff=abs(float(ia.mean()) - float(ib.mean())),
                 frac_pixels=float((np.abs(ia - ib).max(axis=-1) > 0.05).mean()),
                 ray_diff=abs(int(a["rays"]) - int(b["rays"])) / int(b["rays"]))
    assert found["mean_diff"] < 5e-3, found
    assert found["frac_pixels"] < 0.03, found
    assert found["ray_diff"] <= ray_tol, found
    return found


def test_shade_materials_matches_jax_elementwise():
    """``ops.render._shade_materials`` on seeded lanes: outer and inner hits,
    total internal reflection, media of air and glass, scatter 0 to 1.2."""
    import jax.numpy as jnp

    rng = np.random.default_rng(0)
    B = 4096
    f32 = lambda a: np.asarray(a, np.float32)
    d = f32(rng.normal(size=(B, 3)))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    n = f32(rng.normal(size=(B, 3)))
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    pick = lambda *v: f32(rng.choice(v, B))
    lanes = dict(
        o=f32(rng.uniform(-2, 2, (B, 3))), d=d, contrib=f32(rng.uniform(0.0, 1.0, B)),
        bounced=rng.integers(1, 6, B).astype(np.int32), did_hit=rng.uniform(size=B) < 0.8,
        hit_point=f32(rng.uniform(-2, 2, (B, 3))), normal=n,
        mat_color=f32(rng.uniform(0, 1, (B, 3))), mat_ri=pick(1.0, 1.33, 1.5, 2.4),
        refractivity=pick(0.0, 0.85, 0.95), reflectivity=pick(0.05, 0.15, 1.0),
        scat_rfr=pick(0.0, 0.1, 0.5), scat_rfl=pick(0.0, 0.15, 1.2),
        medium=pick(1.0, 1.5), parent_medium=pick(1.0, 1.33, 1.5),
        sample_idx=f32(rng.integers(0, 16, B)), add_color=f32(rng.uniform(0, 0.2, (B, 3))),
        hit_t=f32(rng.uniform(0.1, 20.0, B)))
    lanes["missed"] = ~lanes["did_hit"]
    cfg = dict(max_bounces=5, spp=16)

    def run(mod, cfg_cls, arr):
        a = {k: arr(v) for k, v in lanes.items()}
        hit = types.SimpleNamespace(hit=a["did_hit"], t=a["hit_t"])
        r = mod._shade_materials(
            cfg_cls(**cfg), a["o"], a["d"], a["contrib"], a["bounced"], a["did_hit"],
            a["missed"], a["did_hit"] & False, hit, a["hit_point"], a["normal"],
            a["mat_color"], a["mat_ri"], a["refractivity"], a["reflectivity"], a["scat_rfr"],
            a["scat_rfl"], a["medium"], a["parent_medium"], a["sample_idx"], cfg["spp"],
            a["add_color"])
        return {f.name: np.asarray(getattr(r, f.name)) for f in dataclasses.fields(r)}

    want = run(jrender, JRenderConfig, jnp.asarray)
    got = run(trender, RenderConfig, torch.from_numpy)
    assert want.keys() == got.keys()
    for k, w in want.items():
        g = got[k]
        assert g.shape == w.shape, k
        if w.dtype == bool or w.dtype.kind == "i":
            assert np.array_equal(g, w), (k, int((g != w).sum()))
        else:
            np.testing.assert_allclose(g, w, atol=1e-5, rtol=0, err_msg=k)
    # the lanes exercise every branch
    assert want["refr_mask"].any() and want["refl_mask"].any()
    inner = (lanes["normal"] * lanes["d"]).sum(1) > 0
    assert (inner & want["refl_mask"]).any() and (~inner & want["refr_mask"]).any()


def test_for_scene_carries_no_probe_rows_under_materials():
    scene, _ = tex.materials_scene()
    bvh = RenderConfig().for_scene(scene)
    mat = RenderConfig(shading="materials").for_scene(scene)
    assert bvh.has_dielectrics and bvh.probe_rows == int((scene.refractive_index != 1.0).sum()) > 0
    assert mat.has_dielectrics and mat.probe_rows == 0


@pytest.mark.parametrize("intersector", ["pallas", "brute"])
def test_queue_renderer_matches_jax_render_stats(intersector):
    js, jc = jex.materials_scene()
    ts, tc = tex.materials_scene()
    frame = dict(MATERIALS, intersector=intersector)
    oj = j_render_stats(js, jc, JRenderConfig(**frame).for_scene(js))
    ot = render_stats(ts, tc, RenderConfig(**frame).for_scene(ts), device="cpu")
    ij, it = np.asarray(oj["image"]), ot["image"].numpy()
    assert it.shape == (32, 48, 3) and np.isfinite(it).all()
    ok = np.isclose(it, ij, atol=2e-4, rtol=1e-3).all(axis=-1)
    assert ok.mean() >= 0.995, ok.mean()
    assert abs(ot["rays"] - int(oj["rays"])) / int(oj["rays"]) < 5e-3
    assert ot["rays_dropped"] == int(oj["rays_dropped"]) == 0


@pytest.fixture(scope="module")
def materials_frames():
    js, jc = jex.materials_scene()
    ts, tc = tex.materials_scene()
    jcfg = JRenderConfig(**MATERIALS).for_scene(js)
    tcfg = RenderConfig(**MATERIALS).for_scene(ts)
    return dict(js=js, jc=jc, jcfg=jcfg, ts=ts, tc=tc, tcfg=tcfg,
                port=render_uber(ts, tc, tcfg, gr=16, device="cpu"))


def test_uber_materials_matches_jax_uber(materials_frames):
    f = materials_frames
    oj = j_render_uber(f["js"], f["jc"], f["jcfg"], L=256, R=8, gr=16)
    _envelope(f["port"], oj)
    assert int(f["port"]["rays_dropped"]) == int(oj["rays_dropped"]) == 0


def test_uber_materials_matches_the_ports_queue_renderer(materials_frames):
    f = materials_frames
    oq = render_stats(f["ts"], f["tc"], f["tcfg"], device="cpu")
    _envelope(f["port"], oq)
    assert int(f["port"]["rays_dropped"]) == 0 and oq["rays_dropped"] == 0


def test_uber_materials_nested_dielectric():
    """The depth-2 medium stack and TIR-to-reflection through a glass shell
    with an air bubble; the pops budget cuts cutoff-free trees exactly as the
    queue renderer's pop count does."""
    js, jc = nested_dielectric_scene(jtypes)
    ts, tc = nested_dielectric_scene(ttypes)
    jcfg = JRenderConfig(**NESTED).for_scene(js)
    tcfg = RenderConfig(**NESTED).for_scene(ts)
    ou = render_uber(ts, tc, tcfg, gr=16, device="cpu")
    oq = render_stats(ts, tc, tcfg, device="cpu")
    _envelope(ou, oq)
    assert int(ou["rays"]) == oq["rays"]
    oj = j_render_uber(js, jc, jcfg, L=256, R=8, gr=16)
    _envelope(ou, oj)
    assert int(ou["rays_dropped"]) == int(oj["rays_dropped"]) == 0


@pytest.mark.parametrize("shading", ["materials", "bvh"])
def test_queue_capacity_16_matches_the_queue_renderer(shading):
    """A stack of 16 records (the kernel held at most 8 before) through the
    plain persistent kernel, on trees of up to 33 nodes that stack more than
    8 records."""
    ts, tc = glass_shells_scene(12)
    cfg = RenderConfig(**dict(NESTED, max_bounces=16, queue_capacity=16, shading=shading,
                              width=16, height=10, spp=2)).for_scene(ts)
    assert cfg.pops == 33
    if shading == "materials":
        assert int(render_uber(ts, tc, cfg, gr=16, qcap=8, device="cpu")["rays_dropped"]) > 0
    ou = render_uber(ts, tc, cfg, gr=16, device="cpu")
    oq = render_stats(ts, tc, cfg, device="cpu")
    _envelope(ou, oq, ray_tol=0 if shading == "materials" else 5e-3)
    assert shading == "bvh" or int(ou["rays"]) == oq["rays"]
    assert int(ou["rays_dropped"]) == oq["rays_dropped"] == 0


def _rehearse(scene, cam, cfg, gr):
    import shutil

    from raytracing_tests_tpu_torch.kernels import _build

    if shutil.which("g++") is None:
        pytest.skip("no g++ to rehearse the kernel source with")
    acc, camv = tub._scene_accel(scene, cam, cfg, gr)
    st = tub.UberStatics.from_cfg(cfg)
    want, stats_p = tub.uber_render_plain(acc, camv, st)
    with _build.host_rehearsal():
        got, stats = tub._launch_uber(acc, camv, st)
    return acc, st, got, stats, want, stats_p


@pytest.mark.parametrize("scene", ["materials", "groups", "nested_q16"])
def test_materials_kernel_source_rehearsed_on_the_host(scene):
    """The materials instantiations of ``csrc/uber.cu`` compiled as host C++:
    sphere mode (``materials_scene``), generic (``groups_scene``), and a
    stack of 16 records on the nested shell."""
    if scene == "materials":
        ts, tc = tex.materials_scene()
        frame = dict(MATERIALS, width=24, height=16)
    elif scene == "groups":
        ts, tc = tex.groups_scene()
        frame = dict(MATERIALS, width=24, height=16)
    else:
        ts, tc = nested_dielectric_scene(ttypes)
        frame = dict(NESTED, max_bounces=8, queue_capacity=16, width=16, height=12)
    cfg = RenderConfig(**frame).for_scene(ts)
    acc, st, got, stats, want, stats_p = _rehearse(ts, tc, cfg, 16)
    assert tub.launch_name(acc, st.model) == ("uber_g_mat" if scene == "groups" else "uber_mat")
    assert int(stats[tub.ST_RAYS]) == int(stats_p[tub.ST_RAYS])
    assert int(stats[tub.ST_DROPPED]) == int(stats_p[tub.ST_DROPPED]) == 0
    np.testing.assert_allclose(got[:, 3].numpy(), want[:, 3].numpy(), rtol=1e-5)
    cerr = (got[:, :3] - want[:, :3]).abs().amax(dim=1)
    assert (cerr <= 1e-4).float().mean() >= 0.999, float((cerr <= 1e-4).float().mean())


def test_materials_workload_renders_through_the_cli(tmp_path):
    from raytracing_tests_tpu_torch.app.cli import main

    for uber in ([], ["--uber"]):
        out = tmp_path / f"m{len(uber)}.png"
        main(["render", "materials", "--device", "cpu", "--width", "16", "--height", "12",
              "--spp", "2", "--out", str(out), *uber])
        assert out.stat().st_size > 0
