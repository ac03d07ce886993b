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


# ---------------------------------------------------------------------------
# The grouped sweep (K5) on the warp sweep and the fused dense sweep (K4's
# nearest_ri) with the table in shared memory, rehearsed on the host.  There a
# warp is one lane: coop_min 1 runs the per-lane walk and 33 the row-parallel
# sweep, each through its own code.  Every schedule must give the same bits;
# against the plain version obj and ri are equal and t is within rtol 2e-5
# (PyTorch's CPU kernels round a few near-cancelling quadratics otherwise than
# the sequential IEEE arithmetic of the host build: found equal on 99.9 % of
# the sphere rays and 99.7 % of the generic ones; on the card the -fmad=false
# build is held to equality by chip_smoke.py).
# ---------------------------------------------------------------------------

SCHEDULES = (1, 33, tsw.COOP_MIN)


def _need_gxx():
    if shutil.which("g++") is None:
        pytest.skip("no g++ to rehearse the kernel sources with")


def _grouped_rehearsed(acc, rays, with_ri, coop_min):
    """K5's source on the host at ``coop_min`` -> ((t, obj, ri), stats)."""
    stats = torch.zeros(tsw.SC_LEN, dtype=torch.int64)
    with _build.host_rehearsal(), _build.forced_coop_min(coop_min):
        out = tsw._launch_grouped(acc.table, acc.gaabb, rays, acc.group, with_ri, acc.mode,
                                  stats)
    return out, stats


def _hold_exact(got, want):
    """obj and ri equal, t within rtol 2e-5."""
    assert torch.equal(got[1], want[1])
    if len(got) > 2:
        assert torch.equal(got[2], want[2])
    np.testing.assert_allclose(got[0].numpy(), want[0].numpy(), rtol=2e-5)


def _same_bits(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("with_ri", [False, True])
def test_grouped_schedules_rehearsed(case, with_ri):
    """K5 in each instantiation (generic; spheres; spheres with the fused RI),
    at coop_min 1, 33 and the default: the same bits, and the plain version's."""
    _need_gxx()
    c = case
    rays = pack_rays(*c["T"])
    if with_ri and c["mode"] != "spheres":
        with pytest.raises(ValueError):  # the fused RI pass exists in sphere mode only
            _grouped_rehearsed(c["tg"], rays, True, tsw.COOP_MIN)
        return
    want = tsw.sweep_grouped_plain(c["tg"].table, c["tg"].gaabb, rays, GROUP, with_ri, c["mode"])
    outs = [_grouped_rehearsed(c["tg"], rays, with_ri, cm)[0] for cm in SCHEDULES]
    for got in outs[1:]:
        assert _same_bits(got, outs[0])
    _hold_exact(outs[0], want)
    if with_ri and "glass" in c["name"]:
        _, T = _rays_from_inside_the_glass(c)
        inside = pack_rays(*T)
        want = tsw.sweep_grouped_plain(c["tg"].table, c["tg"].gaabb, inside, GROUP, True,
                                       "spheres")
        outs = [_grouped_rehearsed(c["tg"], inside, True, cm)[0] for cm in SCHEDULES]
        assert all(_same_bits(got, outs[0]) for got in outs[1:])
        _hold_exact(outs[0], want)
        assert 0.02 < (outs[0][2] != 1.0).float().mean() < 0.98


def _with_dead_objects(scene, every=3):
    """The scene (either package's) with every ``every``-th object dead."""
    valid = np.array(scene.valid)
    valid[::every] = False
    if isinstance(scene.valid, torch.Tensor):
        return scene.replace(valid=torch.from_numpy(valid))
    return scene.replace(valid=jnp.asarray(valid))


@pytest.mark.parametrize("mode", ["spheres", "generic"])
def test_grouped_ragged_batch_rehearsed(mode):
    """A batch that is no multiple of a block, with dead rays (d = 0) in the
    middle: every schedule gives the plain version's answer, dead rays miss."""
    _need_gxx()
    scene, cam = (_glass_spheres(ttypes) if mode == "spheres" else tex.bvh_grid_scene(side=4))
    acc = tsw.make_accel(scene, mode, group=GROUP)
    o, d, tr, tl = _rays(5, 301, np.asarray(cam.position))
    d[100:140] = 0.0
    rays = pack_rays(*(torch.from_numpy(x) for x in (o, d, tr, tl)))
    for with_ri in (False, True) if mode == "spheres" else (False,):
        want = tsw.sweep_grouped_plain(acc.table, acc.gaabb, rays, GROUP, with_ri, mode)
        outs = [_grouped_rehearsed(acc, rays, with_ri, cm)[0] for cm in SCHEDULES]
        assert all(_same_bits(got, outs[0]) for got in outs[1:])
        _hold_exact(outs[0], want)
        assert (outs[0][1][100:140] == -1).all() and (outs[0][1] >= 0).any()


@pytest.mark.parametrize("mode", ["spheres", "generic"])
def test_grouped_live_row_bound_rehearsed(mode):
    """Groups that end in dead rows: the bound is each group's last live row
    + 1, and the kernel never reads a row past it.  A copy of the table whose
    rows past the bounds hold a live object in front of every ray, launched
    with the original bounds, still gives the original table's answer."""
    _need_gxx()
    scene, cam = (_glass_spheres(ttypes) if mode == "spheres" else tex.bvh_grid_scene(side=4))
    acc = tsw.make_accel(_with_dead_objects(scene), mode, group=GROUP)
    valid = acc.table[:, tsw.S_VALID if mode == "spheres" else tsw.G_VALID] > 0
    bounds = tsw.grouped_live_rows(acc.table, GROUP, mode)
    G = acc.gaabb.shape[0]
    want_bounds = [max([j + 1 for j in range(GROUP) if valid[g * GROUP + j]], default=0)
                   for g in range(G)]
    assert bounds.tolist() == want_bounds
    assert any(b < GROUP for b in want_bounds)  # the bound is visible
    assert tsw.grouped_live_rows(acc.table, GROUP, mode) is bounds  # computed once
    rays = pack_rays(*(torch.from_numpy(x) for x in _rays(3, 400, np.asarray(cam.position))))
    want = tsw.sweep_grouped_plain(acc.table, acc.gaabb, rays, GROUP, False, mode)
    poisoned = acc.table.clone()
    past = torch.cat([torch.arange(g * GROUP + b, (g + 1) * GROUP) for g, b in
                      enumerate(want_bounds)])
    decoy = tsw.pack_scene_table(_glass_spheres(ttypes)[0] if mode == "spheres" else scene, mode)[0]
    decoy[0:3] = torch.from_numpy(np.asarray(cam.position, np.float32))  # around every origin
    poisoned[past] = decoy
    poisoned._rt_live_rows = ((poisoned.data_ptr(), poisoned._version, GROUP, mode), bounds)
    poisoned_acc = tsw.PallasAccel(poisoned, mode, gaabb=acc.gaabb, group=GROUP)
    for cm in SCHEDULES:
        assert _same_bits(_grouped_rehearsed(poisoned_acc, rays, False, cm)[0],
                          _grouped_rehearsed(acc, rays, False, cm)[0])
    _hold_exact(_grouped_rehearsed(acc, rays, False, tsw.COOP_MIN)[0], want)
    # a write in place renews the bounds
    g_past = int(past[0]) // GROUP
    acc.table[past[:1]] = decoy
    assert int(tsw.grouped_live_rows(acc.table, GROUP, mode)[g_past]) == want_bounds[g_past] + 1


def _plain_walk_counts(acc, rays, with_ri):
    """What the sequential walk of every ray tests, by the plain version's
    arithmetic, for the hit pass and the RI pass: the live rows of the groups
    it enters, its (ray, group) visits, and the rows up to the live bound of
    those groups."""
    mode, group = acc.mode, acc.group
    live = (acc.table[:, tsw.S_VALID if mode == "spheres" else tsw.G_VALID] > 0)
    count = live.reshape(-1, group).sum(dim=1)
    bounds = tsw.grouped_live_row_bounds(acc.table, group, mode)
    o, d = rays[0:3].T, rays[3:6].T
    inv = tsw.geometry._safe_inv(d)
    t_best, obj, _ = tsw.sweep_grouped_plain(acc.table, acc.gaabb, rays, group, False, mode)
    # each group's entry test sees the best t of the groups before it
    t_run = torch.clamp_max(rays[7], tsw.BIG_T).clone()
    hit = dict(rows=0, visits=0, slots=0)
    for g in range(acc.gaabb.shape[0]):
        u = (acc.gaabb[g, 0:3] - o) * inv
        w = (acc.gaabb[g, 3:6] - o) * inv
        entered = (torch.amin(torch.maximum(u, w), -1) > torch.amax(torch.minimum(u, w), -1)) \
            & (torch.amax(torch.minimum(u, w), -1) < t_run)
        n = int(entered.sum())
        hit["rows"] += n * int(count[g])
        hit["visits"] += n
        hit["slots"] += n * int(bounds[g])
        t_run = tsw.sweep_grouped_plain(acc.table[: (g + 1) * group], acc.gaabb[: g + 1], rays,
                                        group, False, mode)[0]
    ri = dict(rows=0, visits=0, slots=0)
    if with_ri:
        bc = torch.zeros(rays.shape[1], 3)
        hitm = obj >= 0
        rows = acc.table[obj.clamp_min(0).long()]
        bc[hitm] = (rows[:, 0:3] - rays[6][:, None] * rows[:, 4:7])[hitm]
        q = tsw._ri_query_point(o, d, t_best, bc)
        for g in range(acc.gaabb.shape[0]):
            n = int(torch.all((q >= acc.gaabb[g, 0:3]) & (q <= acc.gaabb[g, 3:6]), dim=1).sum())
            ri["rows"] += n * int(count[g])
            ri["visits"] += n
            ri["slots"] += n * int(bounds[g])
    return hit, ri


@pytest.mark.parametrize("with_ri", [False, True])
def test_grouped_counters_rehearsed(case, with_ri):
    """SC_ROWS / SC_RI_ROWS are the live rows of the plain walk; the lane
    slots are the rows up to each entered group's bound (a warp of one lane
    issues just those), and the row-parallel visits are every (ray, group)
    visit at coop_min 33 and none at 1."""
    _need_gxx()
    c = case
    acc = tsw.make_accel(_with_dead_objects(c["ts"]), c["mode"], group=GROUP)
    rays = pack_rays(*c["T"])
    with_ri = with_ri and c["mode"] == "spheres"  # generic: the hit pass once more
    hit, ri = _plain_walk_counts(acc, rays, with_ri)
    assert hit["rows"] > 0 and (ri["rows"] > 0) == with_ri
    for cm in (1, 33):
        _, st = _grouped_rehearsed(acc, rays, with_ri, cm)
        assert int(st[tsw.SC_ROWS]) == hit["rows"] and int(st[tsw.SC_RI_ROWS]) == ri["rows"]
        assert int(st[tsw.SC_SLOTS]) == hit["slots"] and int(st[tsw.SC_RI_SLOTS]) == ri["slots"]
        assert int(st[tsw.SC_COOP]) == (hit["visits"] if cm == 33 else 0)
        assert int(st[tsw.SC_RI_COOP]) == (ri["visits"] if cm == 33 else 0)


@pytest.mark.parametrize("name", [n for n, s in SCENES.items() if s[1] == "spheres"])
def test_nearest_ri_rehearsed_at_split_1(name):
    """K4's fused dense kernel with the table staged in shared memory, K = 1
    (the host's warp is one lane), whole and streamed through two stages; a
    split the host cannot run is refused."""
    _need_gxx()
    js, jc, ts, tc, mode = _scenes(name)
    table = tsw.make_accel(ts, mode, group=0).table
    o, d, tr, tl = _rays(7, 1024, np.asarray(jc.position))
    rays = pack_rays(*(torch.from_numpy(x) for x in (o, d, tr, tl)))
    # ... and the same rows behind 600 dead ones: more than one stage holds
    long = torch.cat([torch.zeros(600, tsw.S_COLS), table]).contiguous()
    with _build.host_rehearsal():
        got = tsw._launch_nearest_ri(table, rays, 1)
        got_long = tsw._launch_nearest_ri(long, rays, 1)
        with pytest.raises(RuntimeError):
            tsw._launch_nearest_ri(table, rays, 2)
    _hold_exact(got, tsw.sweep_nearest_ri_plain(table, rays))
    assert torch.equal(got_long[1], torch.where(got[1] >= 0, got[1] + 600, got[1]))
    assert torch.equal(got_long[0], got[0]) and torch.equal(got_long[2], got[2])
    if "glass" in name:
        _, T = _rays_from_inside_the_glass(dict(J=[jnp.asarray(x) for x in (o, d, tr, tl)],
                                                T=[torch.from_numpy(x) for x in (o, d, tr, tl)]))
        inside = pack_rays(*T)
        with _build.host_rehearsal():
            got = tsw._launch_nearest_ri(table, inside, 1)
        _hold_exact(got, tsw.sweep_nearest_ri_plain(table, inside))
        assert (got[2] != 1.0).float().mean() > 0.02


def test_nearest_ri_split_choice():
    """K, lanes per ray: the least of 1, 2, 4, 8 with B * K at least the
    card's resident threads (132 SMs x 2048)."""
    R = tsw.RESIDENT_THREADS
    assert R == 270_336
    assert tsw.nearest_ri_split(5_760_000) == 1  # iow's camera lanes
    assert tsw.nearest_ri_split(179_200) == 2  # the canary's
    assert [tsw.nearest_ri_split(b) for b in (R, R - 1, R // 2, R // 4 - 1, 1)] == [1, 2, 2, 8, 8]
    assert tsw.nearest_ri_split(1000, resident=1000) == 1
    with pytest.raises(ValueError):
        tsw._launch_nearest_ri(torch.zeros(4, tsw.S_COLS), torch.zeros(8, 4), 3)


@pytest.mark.parametrize("name", list(SCENES))
def test_grouped_live_rows_match_jax_valid_column(name):
    """The live-row bounds of the port's grouped table, against the valid
    column of the JAX package's grouped table built from the same scene (with
    dead objects, so that groups end early)."""
    js, jc, ts, tc, mode = _scenes(name)
    valid_col = jsw.S_VALID if mode == "spheres" else jsw.G_VALID
    jvalid = np.asarray(jsw.make_accel(_with_dead_objects(js), mode, group=GROUP).table)[valid_col]
    ta = tsw.make_accel(_with_dead_objects(ts), mode, group=GROUP)
    live = (jvalid > 0).reshape(-1, GROUP)
    last = np.where(live.any(axis=1), GROUP - np.argmax(live[:, ::-1], axis=1), 0)
    np.testing.assert_array_equal(tsw.grouped_live_rows(ta.table, GROUP, mode).numpy(), last)
    assert (last < GROUP).any()
    # make_accel sorts dead rows last: the bounds count the live rows
    assert last.sum() == (jvalid > 0).sum()


def _deep_glass(ty):
    """Four concentric glass spheres and a fifth that cuts into them, with
    diffuse rows between and after them: a point near the centre lies in four
    or five rows spread over the table, where a sum of their refractive
    indices in another order than the rows' differs in the last bits."""
    b = ty.SceneBuilder()
    far = lambda k, y: b.add_lambertian((5.0 + k, y, -9.0), 0.3, (0.5, 0.5, 0.5))  # noqa: E731
    for k in range(5):
        far(k, 0.0)
    for j, (radius, ior) in enumerate(((0.9, 1.5), (0.65, 1.3), (0.45, 1.7), (0.25, 1.4))):
        b.add_dielectric((0.0, 0.0, -3.0), radius, ior=ior)
        for k in range(3):
            far(k, 2.0 + j)
    b.add_dielectric((0.45, 0.1, -2.8), 0.4, ior=1.6)
    for k in range(100):
        far(k, 1.0)
    return b.build()


def test_ri_sums_in_row_order_as_jax():
    """The JAX kernels add the contained rows' refractive indices one row at a
    time in row order; the plain versions (and so the CPU path) do the same:
    every point and every ray from inside the nested glass gets JAX's bits
    (a torch.sum over the rows gave them on 25 % of these points)."""
    js, ts = _deep_glass(jtypes), _deep_glass(ttypes)
    rng = np.random.default_rng(21)
    n = 2048
    o = (np.array([[0.0, 0.0, -3.0]]) + rng.uniform(-0.2, 0.2, (n, 3))).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    tr = rng.uniform(0.0, 1.0, n).astype(np.float32)
    tl = np.full(n, 32000.0, np.float32)
    J = [jnp.asarray(x) for x in (o, d, tr, tl)]
    T = [torch.from_numpy(x) for x in (o, d, tr, tl)]
    jd, jg = jsw.make_accel(js, "spheres", group=0), jsw.make_accel(js, "spheres", group=GROUP)
    td, tg = port_of(jd), port_of(jg)
    ri = tsw.sweep_ri(td.table, "spheres", T[0], T[2])
    assert (ri != 1.0).float().mean() > 0.9
    np.testing.assert_array_equal(ri.numpy(), np.asarray(jsw.sweep_ri(jd.table, "spheres",
                                                                      J[0], J[2])))
    for got, want in ((tsw.sweep_nearest_ri(td.table, *T), jsw.sweep_nearest_ri(jd.table, *J)),
                      (tsw.sweep_grouped(tg.table, tg.gaabb, *T, GROUP, True, mode="spheres"),
                       jsw.sweep_grouped(jg.table, jg.gaabb, *J, GROUP, True, has_motion=True,
                                         mode="spheres"))):
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        assert (got[2] != 1.0).float().mean() > 0.5
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


# ---------------------------------------------------------------------------
# K4's dense nearest hit and RI sum on the staged tables with their exact
# culls (the generic nearest hit behind each row's bounding sphere, the RI sum
# over the rows that can count, a generic row's point test behind the same
# sphere), rehearsed on the host at one lane a ray: obj and ri equal to the
# plain versions, t within the rtol 2e-5 stated above, the counters equal to a
# plain count of what the kernel tests.
# ---------------------------------------------------------------------------

def _nearest_rehearsed(table, mode, rays):
    stats = torch.zeros(tsw.DC_LEN, dtype=torch.int64)
    with _build.host_rehearsal():
        out = tsw._launch_nearest(table, mode, rays, 1, stats)
    return out, stats


def _ri_rehearsed(table, mode, pts):
    stats = torch.zeros(tsw.DC_LEN, dtype=torch.int64)
    with _build.host_rehearsal():
        out = tsw._launch_ri(table, mode, pts, 1, stats)
    return out, stats


def _pack_np(o, d, tr, tl):
    return pack_rays(*(torch.from_numpy(np.ascontiguousarray(x, np.float32)) for x in (o, d, tr, tl)))


def _cull_passes_plain(table, rays):
    """(B, N) bool: the generic pre-test of every (ray, row) pair, by the
    kernel's float32 expression, each pair seeing the ray's best t over the
    rows before its chunk of 32 (the kernel takes it once a chunk; the rows
    the test rejects cannot change the strict-< scan's best)."""
    b = tsw.dense_bounds(table)
    ox, oy, oz, dx, dy, dz, omt, tlim = tsw._ray_cols(rays)
    col = lambda c: b[None, :, c]  # noqa: E731
    rx = ox - col(0) + omt * col(4)
    ry = oy - col(1) + omt * col(5)
    rz = oz - col(2) + omt * col(6)
    rr = rx * rx + ry * ry + rz * rz
    bb = rx * dx + ry * dy + rz * dz
    dd = dx * dx + dy * dy + dz * dz
    t_row = tsw._generic_t(table, ox, oy, oz, dx, dy, dz, omt)
    t0 = torch.clamp_max(tlim, tsw.BIG_T)
    t_best = torch.cummin(torch.cat([t0, t_row[:, :-1]], dim=1), dim=1).values
    t_best = t_best[:, (torch.arange(t_best.shape[1]) // 32) * 32]
    c2 = rr - (col(tsw.B_Q) + col(tsw.B_MU) * rr + 2.0 ** -56 * (t_best * t_best))
    return ~((c2 > 0.0) & ((bb >= 0.0) | (bb * bb < dd * c2)))


def _hold_nearest(table, mode, rays):
    """Both builds' answers on ``rays``: the rehearsed kernel against the
    plain version, and its counters against a plain count -> the stats."""
    (t, obj), st = _nearest_rehearsed(table, mode, rays)
    want = tsw.sweep_nearest_plain(table, mode, rays)
    _hold_exact((t, obj), want)
    B, N = rays.shape[1], table.shape[0]
    assert int(st[tsw.DC_PRE]) == B * N
    full = int(_cull_passes_plain(table, rays).sum()) if mode == "generic" else B * N
    assert int(st[tsw.DC_FULL]) == full
    assert int(st[tsw.DC_SLOTS]) == full  # a warp of one lane
    return st


@pytest.mark.parametrize("name", list(SCENES))
def test_dense_nearest_and_ri_rehearsed(name):
    """Both modes of both kernels, static and moving, on the case's rays and
    on points spread over the scene, at one lane a ray; a split the host
    cannot run is refused."""
    _need_gxx()
    js, jc, ts, tc, mode = _scenes(name)
    table = tsw.make_accel(ts, mode, group=0).table
    rays = _pack_np(*_rays(7, 1024, np.asarray(jc.position)))
    st = _hold_nearest(table, mode, rays)
    if mode == "generic":  # the cull leaves a small share of the pairs
        assert 0 < int(st[tsw.DC_FULL]) < 0.5 * int(st[tsw.DC_PRE])
    o, d, tr = rays[0:3], rays[3:6], rays[6]
    rng = np.random.default_rng(17)
    dist = torch.from_numpy(rng.uniform(0.5, 6.0, rays.shape[1]).astype(np.float32))
    pts = torch.cat([o + dist * d, tr[None]]).contiguous()
    ri, st = _ri_rehearsed(table, mode, pts)
    assert torch.equal(ri, tsw.sweep_ri_plain(table, mode, pts))
    index, _ = tsw.ri_rows(table, mode)
    assert int(st[tsw.DC_PRE]) == rays.shape[1] * index.shape[0]
    with _build.host_rehearsal():
        with pytest.raises(RuntimeError):
            tsw._launch_nearest(table, mode, rays, 2)
        with pytest.raises(RuntimeError):
            tsw._launch_ri(table, mode, pts, 2)


def test_dense_tables_longer_than_a_stage_rehearsed():
    """Tables streamed through the two stages: 785 generic rows (the bounds
    stage 384 a stage, 768 whole) and a sphere table behind 600 dead rows (256
    a stage, 512 whole); the dead rows shift obj and change nothing else."""
    _need_gxx()
    scene, cam = tex.bvh_grid_scene(side=28)
    table = tsw.make_accel(scene, "generic", group=0).table
    assert table.shape[0] > 768
    rays = _pack_np(*_rays(4, 600, np.asarray(cam.position), spread=3.0))
    _hold_nearest(table, "generic", rays)
    js, jc, ts, tc, _ = _scenes("glass_spheres")
    sph = tsw.make_accel(ts, "spheres", group=0).table
    long = torch.cat([torch.zeros(600, tsw.S_COLS), sph]).contiguous()
    rays = _pack_np(*_rays(5, 512, np.asarray(jc.position)))
    (t, obj), _ = _nearest_rehearsed(sph, "spheres", rays)
    (t_l, obj_l), _ = _nearest_rehearsed(long, "spheres", rays)
    assert torch.equal(obj_l, torch.where(obj >= 0, obj + 600, obj)) and torch.equal(t_l, t)
    _hold_nearest(long, "spheres", rays)
    q = (np.array([0.0, 0.0, -3.0]) + np.random.default_rng(13).uniform(-0.45, 0.45, (512, 3)))
    pts = torch.from_numpy(np.concatenate([q.T, np.ones((1, 512))]).astype(np.float32)).contiguous()
    for tb in (sph, long):
        ri, _ = _ri_rehearsed(tb, "spheres", pts)
        assert torch.equal(ri, tsw.sweep_ri_plain(tb, "spheres", pts))
        assert (ri != 1.0).float().mean() > 0.2


def _adversarial_rays(table, rng):
    """Rays for the generic cull, around each live row: tangent to its
    bounding sphere (rb without the margin) and to the primitive (a sphere
    row's surface, a box's face plane), with the origin on that sphere, from
    inside the ground box, parallel to the ground box's faces and in its top
    plane, dead (d = 0) and with a short t_limit."""
    b = tsw.dense_bounds(table)
    live = torch.nonzero(torch.isfinite(b[:, tsw.B_Q]) & (b[:, tsw.B_Q] > 0))[:, 0]
    rows = live[torch.from_numpy(rng.choice(live.numel(), min(48, live.numel()), replace=False))]
    o, d, tl = [], [], []

    def unit(v):
        return v / np.linalg.norm(v)

    for k in rows.tolist():
        c = table[k, 0:3].numpy().astype(np.float64)
        s = table[k, tsw.G_SX:tsw.G_SZ + 1].numpy().astype(np.float64)
        rot = table[k, tsw.G_R00:tsw.G_R22 + 1].numpy().astype(np.float64).reshape(3, 3)
        ell = table[k, tsw.G_TYPE] == 1.0
        rb = s.max() if ell else 0.5 * np.linalg.norm(s)
        u = unit(rng.normal(size=3))
        v = unit(np.cross(u, rng.normal(size=3)))
        for radius in (rb, rb * (1 + 2e-7), rb * (1 - 2e-7), s.min() if ell else 0.5 * s[0]):
            o.append(c + radius * v - 4.0 * u)  # tangent at distance `radius`
            d.append(u)
            tl.append(32000.0)
        o.append(c + rb * u)  # on the sphere, outward and inward
        d.append(u)
        o.append(c + rb * u)
        d.append(-u)
        tl += [32000.0, 32000.0]
        if not ell:  # along a face of the box, in its plane
            axis = rot[:, 0]  # the local x axis in world space
            o.append(c + 0.5 * s[0] * axis - 3.0 * rot[:, 2])
            d.append(rot[:, 2])
            tl.append(32000.0)
    for x in (-150.0, 0.0, 120.0):  # inside the ground box, and in its top plane
        for dd in ((1.0, 0.0, 0.0), (0.0, 0.0, -1.0), (0.0, 1.0, 0.0), (0.3, -0.2, 0.9)):
            o.append((x, -50.0, -8.0))
            d.append(unit(np.array(dd)))
            tl.append(32000.0)
            o.append((x, -1.0, -8.0))
            d.append(unit(np.array(dd)))
            tl.append(32000.0)
    n = len(o)
    o, d, tl = np.array(o), np.array(d), np.array(tl)
    d[: n // 8] = 0.0  # dead
    tl[n // 8: n // 4] = rng.uniform(0.01, 3.0, n // 4 - n // 8)  # short limits
    return o, d, rng.uniform(0.0, 1.0, n), tl


@pytest.mark.parametrize("moving", [False, True])
def test_generic_cull_on_adversarial_rays_rehearsed(moving):
    """The pre-test rejects no row the full test would take, on the rays
    that graze it most."""
    _need_gxx()
    scene, _ = tex.bvh_grid_scene(side=6)
    if moving:
        scene = _moving(scene, ttypes)
    table = tsw.make_accel(scene, "generic", group=0).table
    rays = _pack_np(*_adversarial_rays(table, np.random.default_rng(23)))
    st = _hold_nearest(table, "generic", rays)
    want = tsw.sweep_nearest_plain(table, "generic", rays)
    assert (want[1] >= 0).float().mean() > 0.3  # many of them hit something
    assert int(st[tsw.DC_FULL]) < int(st[tsw.DC_PRE])


def _glass_stack(ty):
    """Generic glass: rotated ellipsoids and boxes nested three and four
    deep, with air rows (refractive index exactly 1) and opaque rows between
    them in the table, and a moving one."""
    b = ty.SceneBuilder()
    air = dict(refractive_index=1.0, refractivity=0.9)
    glass = lambda ior: dict(refractive_index=ior, refractivity=0.9, reflectivity=0.1)  # noqa: E731
    b.add((0.0, 0.0, -3.0), (1.0, 0.8, 0.9), ty.ELLIPSOID, rotation_deg=(10.0, 30.0, 0.0),
          **glass(1.5))
    b.add_sphere((0.1, 0.0, -3.0), 0.6, **air)
    b.add_box((0.0, 0.05, -3.0), (0.9, 0.8, 0.9), rotation_deg=(0.0, 25.0, 10.0), **glass(1.3))
    b.add_box((2.0, 0.0, -3.0), (0.5, 0.5, 0.5), color=(0.5, 0.5, 0.5))
    b.add((0.05, 0.0, -2.95), (0.45, 0.35, 0.4), ty.ELLIPSOID, rotation_deg=(0.0, 60.0, 20.0),
          **glass(1.7))
    b.add_box((-0.1, 0.0, -3.0), (0.5, 0.5, 0.5), rotation_deg=(30.0, 0.0, 0.0), **air)
    b.add((0.0, -0.05, -3.05), (0.3, 0.25, 0.3), ty.ELLIPSOID, rotation_deg=(45.0, 0.0, 0.0),
          delta_position=(0.05, 0.0, 0.0), **glass(1.4))
    b.add_sphere((0.0, -100.6, -4.0), 100.0, color=(0.6, 0.65, 0.6))
    return b.build()


def test_ri_sum_culls_rehearsed():
    """The RI sum over the rows that can count: on points around the nested
    generic glass (inside three or four rows, summed in row order), points
    just inside and just outside every row's bounding sphere and surface,
    and the sphere mode's deep glass; air rows between the glass rows never
    count and are not walked."""
    _need_gxx()
    ts, js = _glass_stack(ttypes), _glass_stack(jtypes)
    table = tsw.make_accel(ts, "generic", group=0).table
    index, staged = tsw.ri_rows(table, "generic")
    ri_col = table[:, tsw.G_RI]
    assert (ri_col == 1.0).sum() >= 2 and not (ri_col[index.long()] == 1.0).any()
    rng = np.random.default_rng(31)
    pts = [np.array([0.0, 0.0, -3.0]) + rng.uniform(-0.4, 0.4, (2000, 3))]
    b = tsw.dense_bounds(table)
    for k in index.tolist():
        c = table[k, 0:3].numpy().astype(np.float64)
        s = table[k, tsw.G_SX:tsw.G_SZ + 1].numpy().astype(np.float64)
        rb = s.max() if table[k, tsw.G_TYPE] == 1.0 else 0.5 * np.linalg.norm(s)
        u = rng.normal(size=(64, 3))
        u /= np.linalg.norm(u, axis=1, keepdims=True)
        for f in (1 - 1e-3, 1 + 1e-3, 1 - 1e-6, 1 + 1e-6):
            pts.append(c + f * rb * u)  # the bounding sphere
        rot = table[k, tsw.G_R00:tsw.G_R22 + 1].numpy().astype(np.float64).reshape(3, 3)
        surf = u * s[None] if table[k, tsw.G_TYPE] == 1.0 else 0.5 * np.sign(u) * s[None]
        for f in (1 - 1e-6, 1 + 1e-6):
            pts.append(c + f * surf @ rot.T)  # the surface (box corners)
        assert float(b[k, tsw.B_Q]) >= rb * rb
    p = np.concatenate(pts).astype(np.float32)
    tr = rng.uniform(0.0, 1.0, p.shape[0]).astype(np.float32)
    P = torch.from_numpy(np.concatenate([p.T, (1.0 - tr)[None]]).astype(np.float32)).contiguous()
    ri, st = _ri_rehearsed(table, "generic", P)
    want = tsw.sweep_ri_plain(table, "generic", P)
    assert torch.equal(ri, want)
    assert int(st[tsw.DC_PRE]) == P.shape[1] * index.shape[0]
    assert 0 < int(st[tsw.DC_FULL]) < int(st[tsw.DC_PRE]) and int(st[tsw.DC_SLOTS]) == int(
        st[tsw.DC_FULL])
    # three or more glass rows around the centre, summed in row order as JAX does
    inside = tsw._contains(table, "generic", P[0][:, None], P[1][:, None], P[2][:, None],
                           P[3][:, None]) & (ri_col != 1.0)[None]
    assert (inside.sum(dim=1) >= 3).sum() > 100
    jt = jsw.make_accel(js, "generic", group=0).table
    np.testing.assert_array_equal(ri.numpy(), np.asarray(jsw.sweep_ri(
        jt, "generic", jnp.asarray(p), jnp.asarray(tr))))
    # sphere mode: the deep glass, whose points lie in four or five rows
    sph = tsw.make_accel(_deep_glass(ttypes), "spheres", group=0).table
    q = (np.array([0.0, 0.0, -3.0]) + rng.uniform(-0.3, 0.3, (1500, 3))).astype(np.float32)
    Q = torch.from_numpy(np.concatenate([q.T, np.ones((1, 1500), np.float32)])).contiguous()
    ri, st = _ri_rehearsed(sph, "spheres", Q)
    assert torch.equal(ri, tsw.sweep_ri_plain(sph, "spheres", Q)) and (ri != 1.0).all()
    assert int(st[tsw.DC_FULL]) == 1500 * tsw.ri_rows(sph, "spheres")[0].shape[0]


@pytest.mark.parametrize("name", list(SCENES) + ["glass_stack"])
def test_dense_bounds_and_ri_rows_match_numpy_of_jax_table(name):
    """The bounds and the rows the RI sum walks, against a numpy
    recomputation from the JAX package's table of the same scene."""
    if name == "glass_stack":
        js, ts, mode = _glass_stack(jtypes), _glass_stack(ttypes), "generic"
    else:
        js, _, ts, _, mode = _scenes(name)
    jt = np.asarray(jsw.make_accel(js, mode, group=0).table).T.astype(np.float64)  # (N, F)
    table = tsw.make_accel(ts, mode, group=0).table
    valid_col, ri_col = (jsw.S_VALID, jsw.S_RI) if mode == "spheres" else (jsw.G_VALID, jsw.G_RI)
    keep = (jt[:, valid_col] > 0) & (jt[:, ri_col] != 1.0)
    index, staged = tsw.ri_rows(table, mode)
    np.testing.assert_array_equal(index.numpy(), np.nonzero(keep)[0])
    if mode == "spheres":
        np.testing.assert_array_equal(staged.numpy(), table[index.long()].numpy())
        return
    rot = jt[:, jsw.G_R00:jsw.G_R22 + 1].reshape(-1, 3, 3)
    s = np.abs(jt[:, jsw.G_SX:jsw.G_SZ + 1])
    sv = np.linalg.svd(rot, compute_uv=False)
    ell = jt[:, jsw.G_TYPE] == 1.0
    rb = np.where(ell, s.max(1), 0.5 * np.linalg.norm(s, axis=1)) / sv[:, 2]
    kappa = s.max(1) / s.min(1) * sv[:, 0] / sv[:, 2]
    q = (rb * (1 + 2.0 ** -9)) ** 2 * (1 + 2.0 ** -16 * kappa)
    mu = np.minimum(2.0 ** -15 * kappa ** 3, 1.0)
    live = jt[:, jsw.G_VALID] > 0
    q, mu = np.where(live, q, -np.inf), np.where(live, mu, 0.0)
    want = np.stack([jt[:, jsw.G_PX], jt[:, jsw.G_PY], jt[:, jsw.G_PZ], q,
                     jt[:, jsw.G_DPX], jt[:, jsw.G_DPY], jt[:, jsw.G_DPZ], mu], axis=1)
    got = tsw.dense_bounds(table).numpy()
    np.testing.assert_allclose(got, want.astype(np.float32), rtol=1e-6, atol=0)
    assert tsw.dense_bounds(table) is tsw.dense_bounds(table)  # computed once
    want_ri = want[keep]
    want_ri[:, tsw.B_MU] = jt[keep, jsw.G_RI]
    np.testing.assert_allclose(staged.numpy(), want_ri.astype(np.float32), rtol=1e-6, atol=0)
    # a write in place renews both
    table[int(index[0]), tsw.G_RI] = 1.0
    assert tsw.ri_rows(table, mode)[0].shape[0] == index.shape[0] - 1
