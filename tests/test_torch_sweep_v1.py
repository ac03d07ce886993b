"""The module that holds the first-generation sweep kernels, against the JAX
package, in both modes, on static and on moving scenes.

On the CPU the port's wrappers run the plain PyTorch versions of the kernels;
the JAX side runs its Pallas kernels in interpret mode.  Both run on the JAX
package's own accel, carried over by ``convert.pallas_accel_from_numpy``.

Tolerances, and what was found:
  - accel build: ``perm`` equal; table, hit matrix and group boxes within rtol
    1e-6 (found equal).
  - ``sweep_nearest``, ``sweep_nearest_ri``, ``sweep_grouped``: the same winner
    on >= 99.9 % of rays (found: all, in every scene); where the winner
    agrees, t within rtol 1e-5 on >= 98 % of the hits and within 1e-4 on all
    (XLA fuses a*b+c where eager PyTorch rounds twice, and a grazing hit loses
    that ulp to the cancellation in half_b^2 - a*c; found 98.8 % to 100 %
    within 1e-5, at most 3.0e-5); the surrounding RI equal on >= 99.9 %
    (found: all).
  - ``sweep_ri``: equal on >= 99.9 % of points (found: all).
  - ``_finish_hit`` on the SAME (t, obj), the JAX sweep's: normals within atol
    1e-5, the unit-space hit position within 1e-5 relative to the hit distance
    over the scale, every material field equal.
  - ``intersect_pallas_full`` end to end (each side's own t): normals and
    unit-space positions carry the t difference over the primitive's size:
    within 1e-5 on >= 98 % and within 1e-3 on all (found 98.4 % to 100 %, at
    most 3.2e-4 on a 0.45-radius sphere 10 units away).
"""

import shutil

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from raytracing_tests_tpu.kernels import sweep as jsw
from raytracing_tests_tpu.scene import examples as jex
from raytracing_tests_tpu.scene import types as jtypes
from raytracing_tests_tpu_torch import convert
from raytracing_tests_tpu_torch.kernels import _build, sweep as tsw
from raytracing_tests_tpu_torch.kernels.sweep2 import pack_rays
from raytracing_tests_tpu_torch.ops import intersect as tisect
from raytracing_tests_tpu_torch.scene import examples as tex
from raytracing_tests_tpu_torch.scene import types as ttypes
from test_torch_sweep2g import dielectric_scene

torch.set_num_threads(2)


def _moving(scene, ty, seed=11):
    """The scene with every valid object moving by up to 0.3 per frame."""
    rng = np.random.default_rng(seed)
    dp = rng.uniform(-0.3, 0.3, (scene.capacity, 3)).astype(np.float32)
    if ty is jtypes:
        return scene.replace(delta_position=jnp.asarray(dp))
    return scene.replace(delta_position=torch.from_numpy(dp))


def _glass_spheres(ty):
    """Sphere mode with nested and overlapping glass, over a ground sphere."""
    b = ty.SceneBuilder()
    b.add_dielectric((0.0, 0.0, -3.0), 0.8)
    b.add_dielectric((0.0, 0.0, -3.0), 0.4, ior=1.3)
    b.add_dielectric((0.9, 0.1, -3.2), 0.5)
    b.add_lambertian((-1.2, 0.0, -3.5), 0.5, (0.7, 0.3, 0.3))
    b.add_sphere((0.4, 0.9, -2.6), 0.3, refractive_index=1.0, reflectivity=0.5)
    b.add_lambertian((0.0, -100.8, -3.0), 100.0, (0.5, 0.6, 0.4))
    cam = ty.Camera.make((0.0, 0.3, 0.5), (0.0, -0.05, -1.0), fov_y_deg=60.0, focus_dist=3.5)
    return b.build(), cam


# name -> (scene factory (examples, types), mode, moving)
SCENES = {
    "bvh5_generic": (lambda ex, ty: ex.bvh_grid_scene(side=5), "generic", False),
    "bvh5_generic_moving": (lambda ex, ty: ex.bvh_grid_scene(side=5), "generic", True),
    "dielectric_generic": (lambda ex, ty: dielectric_scene(ty), "generic", False),
    "glass_spheres": (lambda ex, ty: _glass_spheres(ty), "spheres", False),
    "glass_spheres_moving": (lambda ex, ty: _glass_spheres(ty), "spheres", True),
    "iow5_spheres": (lambda ex, ty: ex.iow_final_scene(side=5), "spheres", False),
}
GROUP = 8


def _scenes(name):
    factory, mode, moving = SCENES[name]
    js, jc = factory(jex, jtypes)
    ts, tc = factory(tex, ttypes)
    if moving:
        js, ts = _moving(js, jtypes), _moving(ts, ttypes)
    return js, jc, ts, tc, mode


def _rays(seed, n, cam_pos, spread=1.0):
    rng = np.random.default_rng(seed)
    o = (np.asarray(cam_pos)[None] + rng.uniform(-spread, spread, (n, 3))).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[:, 2] = -np.abs(d[:, 2])
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d[:8] = 0.0  # dead rays
    tr = rng.uniform(0.0, 1.0, n).astype(np.float32)
    return o, d, tr, np.full(n, 32000.0, np.float32)


def port_of(ja):
    """The JAX package's first-generation accel in the port's layout."""
    opt = lambda x: None if x is None else np.asarray(x)
    return convert.pallas_accel_from_numpy(
        np.asarray(ja.table), ja.mode, np.asarray(ja.hit_matrix), opt(ja.gaabb),
        opt(ja.perm), ja.group, ja.has_motion)


@pytest.mark.parametrize("group", [0, GROUP])
@pytest.mark.parametrize("name", list(SCENES))
def test_make_accel_matches_jax(name, group):
    js, jc, ts, tc, mode = _scenes(name)
    ja = jsw.make_accel(js, mode, group=group)
    ta = tsw.make_accel(ts, mode, group=group)
    ref = port_of(ja)
    assert (ta.mode, ta.group, ta.has_motion) == (ref.mode, ref.group, ref.has_motion)
    np.testing.assert_allclose(ta.table.numpy(), ref.table.numpy(), rtol=1e-6, atol=0)
    np.testing.assert_allclose(ta.hit_matrix.numpy(), ref.hit_matrix.numpy(), rtol=1e-6, atol=0)
    if group:
        np.testing.assert_array_equal(ta.perm.numpy(), ref.perm.numpy())
        np.testing.assert_allclose(ta.gaabb.numpy(), ref.gaabb.numpy(), rtol=1e-6, atol=0)
        assert ta.table.shape[0] % group == 0
    else:
        assert ta.perm is None and ta.gaabb is None


@pytest.fixture(scope="module", params=list(SCENES))
def case(request):
    js, jc, ts, tc, mode = _scenes(request.param)
    o, d, tr, tl = _rays(7, 1024, np.asarray(jc.position))
    J = [jnp.asarray(x) for x in (o, d, tr, tl)]
    T = [torch.from_numpy(x) for x in (o, d, tr, tl)]
    dense = jsw.make_accel(js, mode, group=0)
    grouped = jsw.make_accel(js, mode, group=GROUP)
    return dict(name=request.param, mode=mode, js=js, ts=ts, J=J, T=T, jd=dense,
                jg=grouped, td=port_of(dense), tg=port_of(grouped))


def _rays_from_inside_the_glass(c):
    """The case's rays, restarted inside the 0.8-radius glass sphere of
    ``_glass_spheres`` (around its nested 0.4 sphere, beside the overlapping
    one), so that the fused refractive index is not 1 everywhere."""
    rng = np.random.default_rng(13)
    o = (np.array([[0.0, 0.0, -3.0]]) + rng.uniform(-0.45, 0.45, (1024, 3))).astype(np.float32)
    return [jnp.asarray(o), *c["J"][1:]], [torch.from_numpy(o), *c["T"][1:]]


def _hold(port, jax_out, with_ri):
    """The stated bars on (t, obj[, ri]) of the port against JAX's."""
    tt, to = port[0].numpy(), port[1].numpy()
    jt, jo = np.asarray(jax_out[0]), np.asarray(jax_out[1])
    assert (to == jo).mean() >= 0.999, (to == jo).mean()
    assert (to[:8] == -1).all()  # dead rays never hit
    m = (to == jo) & (jo >= 0)
    assert m.sum() > 100
    rel = np.abs(tt[m] - jt[m]) / jt[m]
    assert (rel <= 1e-5).mean() >= 0.98 and rel.max() <= 1e-4, (rel.max(), (rel <= 1e-5).mean())
    miss = (to == -1) & (jo == -1)
    np.testing.assert_array_equal(tt[miss], jt[miss])
    if with_ri:
        tr, jr = port[2].numpy(), np.asarray(jax_out[2])
        assert (tr[m | miss] == jr[m | miss]).mean() >= 0.999


def test_sweep_nearest_matches_jax(case):
    c = case
    jout = jsw.sweep_nearest(c["jd"].table, c["mode"], *c["J"])
    tout = tsw.sweep_nearest(c["td"].table, c["mode"], *c["T"])
    _hold(tout, jout, False)


def test_sweep_nearest_ri_matches_jax(case):
    c = case
    if c["mode"] != "spheres":
        with pytest.raises(ValueError):
            tsw._check_table(c["td"].table, "spheres", torch.device("cpu"))
        return
    jout = jsw.sweep_nearest_ri(c["jd"].table, *c["J"])
    tout = tsw.sweep_nearest_ri(c["td"].table, *c["T"])
    _hold(tout, jout, True)
    if "glass" in c["name"]:
        J, T = _rays_from_inside_the_glass(c)
        tout = tsw.sweep_nearest_ri(c["td"].table, *T)
        _hold(tout, jsw.sweep_nearest_ri(c["jd"].table, *J), True)
        assert 0.02 < (tout[2] != 1.0).float().mean() < 0.98


@pytest.mark.parametrize("with_ri", [False, True])
def test_sweep_grouped_matches_jax(case, with_ri):
    c = case
    if with_ri and c["mode"] != "spheres":
        with pytest.raises(ValueError):  # the fused pass exists in sphere mode only
            tsw.sweep_grouped(c["tg"].table, c["tg"].gaabb, *c["T"], GROUP, True, mode="generic")
        return
    ja = c["jg"]
    jout = jsw.sweep_grouped(ja.table, ja.gaabb, *c["J"], GROUP, with_ri,
                             has_motion=True, mode=c["mode"])
    tout = tsw.sweep_grouped(c["tg"].table, c["tg"].gaabb, *c["T"], GROUP, with_ri,
                             mode=c["mode"])
    _hold(tout, jout, with_ri)
    if not with_ri:
        assert torch.equal(tout[2], torch.ones_like(tout[2]))
    elif "glass" in c["name"]:
        J, T = _rays_from_inside_the_glass(c)
        tin = tsw.sweep_grouped(c["tg"].table, c["tg"].gaabb, *T, GROUP, True, mode="spheres")
        _hold(tin, jsw.sweep_grouped(ja.table, ja.gaabb, *J, GROUP, True, has_motion=True,
                                     mode="spheres"), True)
        assert 0.02 < (tin[2] != 1.0).float().mean() < 0.98
    # the grouped sweep finds what the dense sweep finds
    td, od = tsw.sweep_nearest(c["td"].table, c["mode"], *c["T"])
    same = torch.where(tout[1] >= 0, c["tg"].perm[tout[1].clamp_min(0).long()],
                       torch.full_like(od, -1)) == od
    assert same.float().mean() >= 0.999


def test_sweep_ri_matches_jax_and_the_dense_sum(case):
    c = case
    o, d, tr, _ = c["T"]
    rng = np.random.default_rng(9)
    pts = o + torch.from_numpy(rng.uniform(1.0, 5.0, (o.shape[0], 1)).astype(np.float32)) * \
        torch.nn.functional.normalize(d + 1e-3, dim=1)
    jr = np.asarray(jsw.sweep_ri(c["jd"].table, c["mode"], jnp.asarray(pts.numpy()), c["J"][2]))
    ri = tsw.sweep_ri(c["td"].table, c["mode"], pts, tr)
    assert (ri.numpy() == jr).mean() >= 0.999
    want = tisect.surrounding_refractive_index(c["ts"], pts, tr)
    assert (ri == want).float().mean() >= 0.999
    if "glass" in c["name"] or "dielectric" in c["name"]:
        assert (ri != 1.0).any()


@pytest.mark.parametrize("grouped", [False, True])
def test_finish_hit_matches_jax(case, grouped):
    c = case
    ja, ta = (c["jg"], c["tg"]) if grouped else (c["jd"], c["td"])
    jh, jf = jsw.intersect_pallas_full(ja, c["js"], *c["J"])
    th, tf = tsw.intersect_pallas_full(ta, c["ts"], *c["T"])
    m = np.asarray(jh.hit) & th.hit.numpy() & (np.asarray(jh.obj) == th.obj.numpy())
    assert m.mean() > 0.1 and (np.asarray(jh.hit) == th.hit.numpy()).mean() >= 0.999
    for got, want in ((th.normal, jh.normal), (th.local_pos, jh.local_pos)):
        err = np.abs(got.numpy()[m] - np.asarray(want)[m]).max(axis=-1)
        assert (err <= 1e-5).mean() >= 0.98 and err.max() <= 1e-3, (err.max(), (err <= 1e-5).mean())
    rel = np.abs(th.t.numpy()[m] - np.asarray(jh.t)[m]) / np.asarray(jh.t)[m]
    assert (rel <= 1e-5).mean() >= 0.98 and rel.max() <= 1e-4, rel.max()
    # _finish_hit alone: both sides are given the JAX sweep's (t, obj)
    jt, jo, _ = jsw._sweep_dispatch(ja, *c["J"], with_ri=False)
    jh2, _ = jsw._finish_hit(ja, *c["J"][:3], jt, jo)
    th2, _ = tsw._finish_hit(ta, *c["T"][:3], torch.from_numpy(np.array(jt)),
                             torch.from_numpy(np.array(jo)))
    k2 = np.asarray(jh2.hit)
    assert np.array_equal(th2.hit.numpy(), k2) and np.array_equal(
        th2.obj.numpy()[k2], np.asarray(jh2.obj)[k2])
    np.testing.assert_allclose(th2.normal.numpy()[k2], np.asarray(jh2.normal)[k2], atol=1e-5)
    np.testing.assert_allclose(th2.local_pos.numpy()[k2], np.asarray(jh2.local_pos)[k2],
                               rtol=1e-5, atol=1e-5)
    for f in ("color", "refractive_index", "refractivity", "reflectivity",
              "scatter_refract", "scatter_reflect", "texture_index", "emissive"):
        np.testing.assert_array_equal(getattr(tf, f).numpy()[m], np.asarray(getattr(jf, f))[m])
    # ... and the port's dense tensor intersector
    hb = tisect.intersect_brute(c["ts"], *c["T"])
    same = (th.hit == hb.hit) & (~hb.hit | (th.obj == hb.obj))
    assert same.float().mean() >= 0.999
    k = (th.hit & hb.hit & (th.obj == hb.obj)).numpy()
    err = np.abs(th.normal.numpy()[k] - hb.normal.numpy()[k]).max(axis=-1)
    assert (err <= 1e-5).mean() >= 0.99 and err.max() <= 1e-4, err.max()  # found 4.3e-5


@pytest.mark.parametrize("grouped", [False, True])
def test_fused_and_occlusion_entry_points_match_jax(case, grouped):
    c = case
    ja, ta = (c["jg"], c["tg"]) if grouped else (c["jd"], c["td"])
    jh, _, jri = jsw.intersect_pallas_fused(ja, c["js"], *c["J"])
    th, _, tri = tsw.intersect_pallas_fused(ta, c["ts"], *c["T"])
    m = np.asarray(jh.hit) & th.hit.numpy() & (np.asarray(jh.obj) == th.obj.numpy())
    assert (tri.numpy()[m] == np.asarray(jri)[m]).mean() >= 0.999
    jo = np.asarray(jsw.occluded_nearest_obj_pallas(ja, c["js"], *c["J"]))
    to = tsw.occluded_nearest_obj_pallas(ta, c["ts"], *c["T"])
    assert (to.numpy() == jo).mean() >= 0.999
    assert torch.equal(to, torch.where(th.hit, th.obj, torch.full_like(th.obj, -1)))


def test_kernel_sources_rehearsed_on_the_host(case):
    """Where there is a g++: the CUDA sources of the four kernels, compiled as
    host C++, against their plain versions (identical winners and RI; t within
    2e-5 relative: one ulp of a near-cancelling quadratic)."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ to rehearse the kernel sources with")
    c = case
    mode, td, tgr = c["mode"], c["td"], c["tg"]
    o, d, tr, tl = c["T"]
    rays = pack_rays(o, d, tr, tl)
    pts = torch.stack([o[:, 0] + 3 * d[:, 0], o[:, 1] + 3 * d[:, 1], o[:, 2] + 3 * d[:, 2],
                       1.0 - tr]).contiguous()
    stats = torch.zeros(tsw.SC_LEN, dtype=torch.int64)
    pairs = []
    with _build.host_rehearsal():
        pairs.append((tsw._launch_nearest(td.table, mode, rays),
                      tsw.sweep_nearest_plain(td.table, mode, rays)))
        pairs.append(((tsw._launch_ri(td.table, mode, pts),),
                      (tsw.sweep_ri_plain(td.table, mode, pts),)))
        pairs.append((tsw._launch_grouped(tgr.table, tgr.gaabb, rays, GROUP, False, mode, stats),
                      tsw.sweep_grouped_plain(tgr.table, tgr.gaabb, rays, GROUP, False, mode)))
        if mode == "spheres":
            pairs.append((tsw._launch_nearest_ri(td.table, rays),
                          tsw.sweep_nearest_ri_plain(td.table, rays)))
            pairs.append((tsw._launch_grouped(tgr.table, tgr.gaabb, rays, GROUP, True, mode),
                          tsw.sweep_grouped_plain(tgr.table, tgr.gaabb, rays, GROUP, True, mode)))
    valid = tgr.table[:, 7 if mode == "spheres" else 19] > 0
    assert 0 < int(stats[tsw.SC_ROWS]) <= rays.shape[1] * int(valid.sum())
    for got, want in pairs:
        for g, w in zip(got, want):
            if g.dtype == torch.int32:
                assert torch.equal(g, w)
            else:
                np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=2e-5)


def test_wrappers_check_their_arguments():
    scene, _ = tex.bvh_grid_scene(side=2)
    acc = tsw.make_accel(scene, "generic", group=4)
    rays = torch.zeros(8, 4)
    with pytest.raises(ValueError):
        tsw._launch_grouped(acc.table, acc.gaabb, rays, 3, False, "generic")
    with pytest.raises(ValueError):
        tsw._launch_grouped(acc.table, acc.gaabb, rays, 4, True, "generic")
    with pytest.raises(ValueError):
        tsw._launch_nearest(acc.table, "spheres", rays)
    with pytest.raises(ValueError):
        tsw._launch_ri(acc.table, "generic", rays)
    with pytest.raises(ValueError):
        tsw.pack_scene_table(scene, "boxes")
    with pytest.raises(ValueError):
        tsw.sweep_nearest(acc.table.to("meta"), "generic", torch.zeros(4, 3), torch.zeros(4, 3),
                          torch.zeros(4), torch.zeros(4))
