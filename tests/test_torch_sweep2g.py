"""The module that holds the generic grouped sweep kernel, against the JAX
package.

On the CPU the port's wrappers run the plain PyTorch version of the kernel;
the JAX side runs its Pallas kernel in interpret mode.

Tolerances, and what was found:
  - accel build: ``perm``, ``gkinds``, ``n_pgroups``, ``n_sgroups`` and the
    kind codes equal; boxes and table entries within rtol 1e-6 (the two
    packages round a general rotation's entries one ulp apart, and the boxes
    and the fused frame M = R^T / s carry that; found 9e-8).
  - ``sweep2g_nearest`` against JAX on the same tables: the same winner on
    >= 99.9 % of rays (found: all), and where the winner agrees t within
    2^-12 relative (the JAX kernel clears the low 11 mantissa bits of the
    candidate t in its packed (t, id) key, the port keeps the full t) plus
    2e-5 absolute: rays that start 2e-3 above the 100-radius ground sphere
    lose |o/s|^2 - 1 to float32 cancellation, and XLA fuses a*b+c where eager
    PyTorch rounds twice (found 9.3e-6 on 2 of 1074 hits).
  - on the port's own accel against the JAX package's: the same winners, t
    within rtol 1e-5 (the rotation's ulp again; found 6.5e-6).
  - against the port's own ``intersect_brute``: the same winner on >= 99.9 %
    (found: all), the refined t within rtol 1e-5 (found 5.5e-6); normals
    within 1e-5 on >= 99 % and 2e-4 everywhere, the unit-space hit position
    within 2e-4: on the 0.3-scale axis of an anisotropic ellipsoid both carry
    the hit point's error over the scale (found 7.9e-5 and 6.7e-5).
  - ``_ri_probe_g`` against the dense containment sum: equal.
"""

import contextlib
import dataclasses
import shutil

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from raytracing_tests_tpu.kernels import sweep2 as jsw2
from raytracing_tests_tpu.kernels import sweep2g as jg
from raytracing_tests_tpu.scene import examples as jex
from raytracing_tests_tpu.scene import types as jtypes
from raytracing_tests_tpu_torch import convert
from raytracing_tests_tpu_torch.kernels import _build, edge_cull as ec, sweep2 as tsw2
from raytracing_tests_tpu_torch.kernels import sweep2g as tg
from raytracing_tests_tpu_torch.ops import intersect as tisect
from raytracing_tests_tpu_torch.scene import examples as tex
from raytracing_tests_tpu_torch.scene import types as ttypes

torch.set_num_threads(2)


def anisotropic_scene(ty):
    """Anisotropic rotated ellipsoids and rotated boxes over a ground sphere
    (the scene of the JAX package's generic persistent-kernel test)."""
    b = ty.SceneBuilder()
    for i in range(6):
        x = (i - 2.5) * 1.2
        if i % 2 == 0:
            b.add((x, 0.0, -4.0), (0.5, 0.3, 0.4), ty.ELLIPSOID,
                  rotation_deg=(20.0, 35.0 * i, 10.0), color=(0.8, 0.4, 0.3),
                  reflectivity=0.8, scatter_reflect=0.3)
        else:
            b.add_box((x, 0.2, -5.0), (0.6, 0.9, 0.5), rotation_deg=(0.0, 25.0 * i, 15.0),
                      color=(0.3, 0.6, 0.8), reflectivity=0.9, scatter_reflect=0.1)
    b.add_sphere((0.0, -100.6, -4.0), 100.0, color=(0.6, 0.6, 0.6),
                 reflectivity=0.6, scatter_reflect=0.8)
    cam = ty.Camera.make((0.0, 0.6, 1.0), (0.0, -0.15, -1.0), fov_y_deg=55.0, focus_dist=5.0)
    return b.build(), cam


def dielectric_scene(ty):
    """A glass ellipsoid between two rotated boxes over a ground sphere (the
    scene of the JAX package's generic dielectric test)."""
    b = ty.SceneBuilder()
    b.add((0.0, 0.0, -3.5), (0.6, 0.4, 0.5), ty.ELLIPSOID, rotation_deg=(10.0, 30.0, 0.0),
          color=(1.0, 1.0, 1.0), refractive_index=1.5, refractivity=0.9, reflectivity=0.1)
    b.add_box((-1.3, 0.0, -4.0), (0.6, 0.8, 0.6), rotation_deg=(0.0, 40.0, 0.0),
              color=(0.3, 0.6, 0.8), reflectivity=0.9, scatter_reflect=0.2)
    b.add_box((1.3, -0.1, -4.2), (0.7, 0.6, 0.7), rotation_deg=(0.0, 70.0, 10.0),
              color=(0.8, 0.5, 0.3), reflectivity=0.9, scatter_reflect=0.2)
    b.add_sphere((0.0, -100.6, -4.0), 100.0, color=(0.6, 0.65, 0.6),
                 reflectivity=0.7, scatter_reflect=0.9)
    cam = ty.Camera.make((0.0, 0.4, 0.8), (0.0, -0.1, -1.0), fov_y_deg=55.0, focus_dist=4.2)
    return b.build(), cam


def overlapping_glass_scene(ty):
    """A glass ellipsoid and a glass box that poke into each other, beside an
    opaque box, over a ground sphere: a ray leaves one glass body inside the
    other, so the surrounding refractive index is not 1 there and the probe
    rows survive the relevance cut (a lone glass body's do not)."""
    b = ty.SceneBuilder()
    b.add((0.0, 0.0, -3.5), (0.7, 0.5, 0.6), ty.ELLIPSOID, rotation_deg=(10.0, 30.0, 0.0),
          color=(1.0, 1.0, 1.0), refractive_index=1.5, refractivity=0.9, reflectivity=0.1)
    b.add_box((0.6, 0.1, -3.4), (0.8, 0.7, 0.7), rotation_deg=(0.0, 25.0, 10.0),
              color=(0.9, 1.0, 0.9), refractive_index=1.3, refractivity=0.85,
              reflectivity=0.15)
    b.add_box((-1.4, 0.0, -4.0), (0.6, 0.8, 0.6), rotation_deg=(0.0, 40.0, 0.0),
              color=(0.3, 0.6, 0.8), reflectivity=0.9, scatter_reflect=0.2)
    b.add_sphere((0.0, -100.6, -4.0), 100.0, color=(0.6, 0.65, 0.6),
                 reflectivity=0.7, scatter_reflect=0.9)
    cam = ty.Camera.make((0.0, 0.4, 0.8), (0.0, -0.1, -1.0), fov_y_deg=55.0, focus_dist=4.2)
    return b.build(), cam


def _mixed_scene(ty):
    """Three objects of both classes and an identity-rotation box: with gr=8
    the cuboid class is one 'c' group (a rolled box beside an unrotated one)."""
    b = ty.SceneBuilder()
    b.add_sphere((0.0, 0.0, -3.0), 0.5)
    b.add_box((1.2, 0.0, -3.0), (0.6, 0.6, 0.6))
    b.add_box((-1.2, 0.0, -3.0), (0.6, 0.6, 0.6), rotation_deg=(15.0, 0.0, 30.0))
    cam = ty.Camera.make((0.0, 0.5, 1.0), (0.0, -0.1, -1.0))
    return b.build(), cam


# name -> (scene factory (examples module, types module), gr, sort, probe cut)
BUILDS = {
    "bvh4_gr8_sorted": (lambda ex, ty: ex.bvh_grid_scene(side=4), 8, True, False),
    "bvh6_gr16": (lambda ex, ty: ex.bvh_grid_scene(side=6), 16, False, False),
    "bvh12_gr8_supergroups": (lambda ex, ty: ex.bvh_grid_scene(side=12), 8, True, False),
    "anisotropic_gr16": (lambda ex, ty: anisotropic_scene(ty), 16, True, False),
    "dielectric_gr8_cut": (lambda ex, ty: dielectric_scene(ty), 8, True, True),
    "mixed_gr8": (lambda ex, ty: _mixed_scene(ty), 8, True, False),
    "overlapping_glass_gr8_cut": (lambda ex, ty: overlapping_glass_scene(ty), 8, True, True),
}


def _jax_ftab(accel):
    return sum(np.asarray(x.astype(jnp.float32)) for x in accel.ftab3)


def port_of(ja):
    """The JAX package's generic accel, re-laid into the port's tables."""
    return convert.accel2g_from_numpy(
        np.asarray(ja.otab), _jax_ftab(ja), np.asarray(ja.gaabb), np.asarray(ja.perm),
        ja.gr, ja.has_motion, ja.n_pgroups, ja.n_sgroups, ja.gkinds)


def _build_both(name):
    factory, gr, sort, cut = BUILDS[name]
    js, jc = factory(jex, jtypes)
    ts, tc = factory(tex, ttypes)
    jmask = jsw2.probe_relevant_rows(js) if cut else None
    tmask = tsw2.probe_relevant_rows(ts) if cut else None
    kw = lambda cam, mask: dict(
        gr=gr, has_motion=False, sort_origin=cam.position if sort else None,
        probe_rows=int(mask.sum()) if cut else None, probe_mask=mask)
    ja = jg.make_accel2g(js, **kw(jc, jmask))
    ta = tg.make_accel2g(ts, **kw(tc, tmask))
    return js, jc, ja, ts, tc, ta


@pytest.mark.parametrize("name", list(BUILDS))
def test_make_accel2g_matches_jax(name):
    js, jc, ja, ts, tc, ta = _build_both(name)
    np.testing.assert_array_equal(ta.perm.numpy(), np.asarray(ja.perm))
    assert ta.gkinds == ja.gkinds
    assert (ta.gr, ta.n_pgroups, ta.n_sgroups) == (ja.gr, ja.n_pgroups, ja.n_sgroups)
    ref = port_of(ja)
    np.testing.assert_array_equal(ta.gaabb[:, tg.GA_KIND].numpy(),
                                  ref.gaabb[:, tg.GA_KIND].numpy())
    np.testing.assert_allclose(ta.gaabb.numpy(), ref.gaabb.numpy(), rtol=1e-6, atol=0)
    np.testing.assert_allclose(ta.otab.numpy(), ref.otab.numpy(), rtol=1e-6, atol=0)
    np.testing.assert_allclose(ta.ftab.numpy(), ref.ftab.numpy(), rtol=1e-6, atol=0)
    tg.check_accel_g(ta, torch.device("cpu"))


def test_census_and_supergroups_of_the_grid():
    """The 12x12 grid at gr=8: 72 spheres in 9 's' groups, 73 cuboids in 10
    groups of which the last holds the unrotated ground box; 19 groups give 3
    super-groups whose boxes are the unions of their members'."""
    *_, ta = _build_both("bvh12_gr8_supergroups")
    assert ta.n_groups == 19 and ta.n_sgroups == 3
    assert sorted(set(ta.gkinds)) == ["a", "cy", "s"] and ta.gkinds.count("s") == 9
    G = ta.n_groups
    sg = ta.gaabb[G + ta.n_pgroups:]
    for s in range(3):
        members = ta.gaabb[s * tg.SG:min((s + 1) * tg.SG, G)]
        assert torch.equal(sg[s, 0:3], members[:, 0:3].amin(dim=0))
        assert torch.equal(sg[s, 3:6], members[:, 3:6].amax(dim=0))
    *_, mixed = _build_both("mixed_gr8")
    assert sorted(mixed.gkinds) == ["c", "s"] and mixed.n_sgroups == 0
    # the relevance cut drops a lone glass body's probe row and keeps those of
    # two glass bodies that overlap
    assert _build_both("dielectric_gr8_cut")[-1].n_pgroups == 0
    assert _build_both("overlapping_glass_gr8_cut")[-1].n_pgroups == 1


def _rays(seed, n, cam_pos, spread):
    rng = np.random.default_rng(seed)
    o = (np.asarray(cam_pos)[None] + rng.uniform(-spread, spread, (n, 3))).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[:, 2] = -np.abs(d[:, 2])  # towards the scene
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d[:16] = 0.0  # dead rays
    return o, d, np.zeros(n, np.float32), np.full(n, 32000.0, np.float32)


@pytest.fixture(scope="module", params=["bvh12_gr8_supergroups", "anisotropic_gr16",
                                        "dielectric_gr8_cut", "mixed_gr8"])
def sweep_case(request):
    """2048 seeded rays (16 of them dead) through the JAX kernel (interpret
    mode) and the port's plain version, both on the JAX package's own accel."""
    js, jc, ja, ts, tc, ta = _build_both(request.param)
    o, d, tr, tl = _rays(3, 2048, np.asarray(jc.position), 1.5)
    jt, jo = jg.sweep2g_nearest(ja, jnp.asarray(o), jnp.asarray(d), jnp.asarray(tr),
                                jnp.asarray(tl))
    ref = port_of(ja)
    T = torch.from_numpy
    tt, to = tg.sweep2g_nearest(ref, T(o), T(d), T(tr), T(tl))
    return dict(name=request.param, ts=ts, accel=ref, own=ta, rays=(T(o), T(d), T(tr), T(tl)),
                jax=(np.asarray(jt), np.asarray(jo)), port=(tt, to))


def test_sweep2g_nearest_matches_jax(sweep_case):
    c = sweep_case
    (jt, jo), (tt, to) = c["jax"], c["port"]
    to, tt = to.numpy(), tt.numpy()
    assert (to == jo).mean() >= 0.999, (to == jo).mean()
    assert (to[:16] == -1).all() and (jo[:16] == -1).all()  # dead rays
    m = (to == jo) & (jo >= 0)
    assert m.sum() > 30
    over = np.abs(tt[m] - jt[m]) - (2.0 ** -12 * jt[m] + 2e-5)
    assert over.max() <= 0.0, over.max()
    miss = (to == -1) & (jo == -1)
    assert np.all(tt[miss] == 32000.0)  # a miss reports the ray's own limit


def test_sweep2g_on_the_ports_own_accel_equals_on_jaxs(sweep_case):
    c = sweep_case
    tt, to = tg.sweep2g_nearest(c["own"], *c["rays"])
    assert torch.equal(to, c["port"][1])
    np.testing.assert_allclose(tt.numpy(), c["port"][0].numpy(), rtol=1e-5)


def test_sweep2g_and_refine_match_intersect_brute(sweep_case):
    c = sweep_case
    accel, (o, d, tr, tl) = c["accel"], c["rays"]
    tt, to = c["port"]
    hb = tisect.intersect_brute(c["ts"], o, d, tr, tl)
    orig = torch.where(to >= 0, accel.perm[to.clamp_min(0).long()], torch.full_like(to, -1))
    bo = torch.where(hb.hit, hb.obj, torch.full_like(hb.obj, -1))
    assert (orig == bo).float().mean() >= 0.999
    m = (orig == bo) & hb.hit
    rows = tg._gather_rows_g(accel, to)
    t_ref, t_safe, p, n, lp = tg._winner_refine_g(rows, o, d, tt, to >= 0)
    np.testing.assert_allclose(t_ref[m].numpy(), hb.t[m].numpy(), rtol=1e-5)
    nerr = (n[m] - hb.normal[m]).abs().amax(dim=1)
    assert (nerr <= 1e-5).float().mean() >= 0.99 and nerr.max() <= 2e-4, nerr.max()
    np.testing.assert_allclose(lp[m].numpy(), hb.local_pos[m].numpy(), atol=2e-4)
    assert torch.isfinite(n).all() and torch.isfinite(p).all() and torch.isfinite(lp).all()
    assert torch.equal(t_safe[to < 0], torch.ones_like(t_safe[to < 0]))


def test_ri_probe_g_matches_the_dense_containment_sum():
    ts, _ = dielectric_scene(ttypes)
    ta = tg.make_accel2g(ts, gr=8, has_motion=False)  # every row with ri != 1 probed
    assert ta.n_pgroups == 1
    rng = np.random.default_rng(5)
    q = torch.from_numpy(rng.uniform([-0.8, -0.6, -4.2], [0.8, 0.6, -2.8],
                                     (4096, 3)).astype(np.float32))
    ri = tg._ri_probe_g(ta, q)
    want = tisect.surrounding_refractive_index(ts, q, torch.zeros(4096))
    assert torch.equal(ri, want)
    assert 0.05 < (ri == 1.5).float().mean() < 0.95
    no_probe = tg.make_accel2g(ts, gr=8, probe_rows=0)
    assert no_probe.n_pgroups == 0 and torch.equal(tg._ri_probe_g(no_probe, q),
                                                   torch.ones(4096))


def _one_box(rotation_deg=(0.0, 0.0, 0.0)):
    b = ttypes.SceneBuilder()
    b.add_box((0.0, 0.0, -3.0), (1.0, 1.0, 1.0), rotation_deg=rotation_deg)
    return b.build()


def test_axis_parallel_ray_on_a_slab_plane_misses_in_both_versions():
    """The bare-reciprocal slab: a ray parallel to x whose origin lies exactly
    on the box's y = +0.5 plane gives 0 * inf = NaN on that axis, which has to
    end as a miss (as in the JAX kernel); its neighbours inside the slab hit
    at t = 2.5, and one just outside misses."""
    scene = _one_box()
    accel = tg.make_accel2g(scene, gr=8, has_motion=False)
    assert accel.gkinds == ("a",)
    o = torch.tensor([[-3.0, 0.5, -3.0], [-3.0, 0.25, -3.0], [-3.0, 0.5, -2.75],
                      [-3.0, 0.75, -3.0], [-3.0, -0.5, -3.0]])
    d = torch.tensor([[1.0, 0.0, 0.0]]).repeat(5, 1)
    tr, tl = torch.zeros(5), torch.full((5,), 100.0)
    t, obj = tg.sweep2g_nearest(accel, o, d, tr, tl)
    assert obj.tolist() == [-1, 0, -1, -1, -1]
    assert t.tolist() == [100.0, 2.5, 100.0, 100.0, 100.0]
    ja = jg.make_accel2g(jtypes.Scene(**{
        f: jnp.asarray(v) for f, v in convert.scene_to_numpy(scene).items()}),
        gr=8, has_motion=False)
    jt, jo = jg.sweep2g_nearest(ja, jnp.asarray(o.numpy()), jnp.asarray(d.numpy()),
                                jnp.zeros(5), jnp.full((5,), 100.0))
    assert np.asarray(jo).tolist() == obj.tolist()


def test_dead_lane_inside_a_box_reports_no_hit():
    """A dead lane (d = 0) whose stale origin sits inside a primitive: the
    safe-inverse slab would give it a finite exit t; it must report a miss."""
    for rot, kind in (((0.0, 0.0, 0.0), "a"), ((0.0, 30.0, 0.0), "cy"),
                      ((10.0, 30.0, 5.0), "c")):
        accel = tg.make_accel2g(_one_box(rot), gr=8, has_motion=False)
        assert accel.gkinds == (kind,)
        o = torch.tensor([[0.0, 0.0, -3.0], [0.0, 0.0, 0.0]])
        d = torch.tensor([[0.0, 0.0, 0.0], [0.0, 0.0, -1.0]])
        t, obj = tg.sweep2g_nearest(accel, o, d, torch.zeros(2), torch.full((2,), 50.0))
        assert obj.tolist() == [-1, 0] and t[0] == 50.0
        assert abs(float(t[1]) - 2.5) < 0.2


def test_all_invalid_scene_builds_one_dead_group():
    scene = _one_box()
    scene = scene.replace(valid=torch.zeros_like(scene.valid))
    accel = tg.make_accel2g(scene, gr=8, has_motion=False)
    assert accel.n_groups == 1 and accel.gkinds == ("e",)
    assert float(accel.otab[:, tg.GO_VALID].sum()) == 0.0
    o, d, tr, tl = (torch.from_numpy(x) for x in _rays(1, 64, (0.0, 0.0, 0.0), 1.0))
    t, obj = tg.sweep2g_nearest(accel, o, d, tr, tl)
    assert (obj == -1).all() and (t == 32000.0).all()


def test_moving_scene_through_the_generic_sweep():
    """The sweep carries the motion terms: a box that moved by +1 in x since
    the last frame is met one unit earlier at time_ratio 0 than at 1."""
    scene = _one_box()
    dp = torch.zeros_like(scene.delta_position)
    dp[0, 2] = -1.0  # moving away from the camera
    moving = scene.replace(delta_position=dp)
    accel = tg.make_accel2g(moving, gr=8, has_motion=True)
    o = torch.zeros(2, 3)
    d = torch.tensor([[0.0, 0.0, -1.0]]).repeat(2, 1)
    t, obj = tg.sweep2g_nearest(accel, o, d, torch.tensor([0.0, 1.0]), torch.full((2,), 50.0))
    hb = tisect.intersect_brute(moving, o, d, torch.tensor([0.0, 1.0]), torch.full((2,), 50.0))
    assert obj.tolist() == [0, 0]
    np.testing.assert_allclose(t.numpy(), hb.t.numpy(), rtol=1e-6)
    assert abs(float(t[1] - t[0]) - 1.0) < 1e-5


def test_wrapper_checks_its_arguments():
    accel = tg.make_accel2g(_one_box(), gr=8, has_motion=False)
    rays = torch.zeros(8, 4)
    with pytest.raises(ValueError):
        tg._launch_sweep2g(accel, torch.zeros(7, 4))
    with pytest.raises(TypeError):
        tg._launch_sweep2g(accel, rays.double())
    bad = tg.Accel2G(**{**accel.__dict__, "gkinds": ()})
    with pytest.raises(ValueError):
        tg._launch_sweep2g(bad, rays)


def test_kernel_source_rehearsed_on_the_host(sweep_case):
    """Where there is a g++: the CUDA source of the sweep, compiled as host
    C++, against the plain version on the same rays (identical winners; t
    within 2e-5 relative: one ulp of a near-cancelling quadratic)."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ to rehearse the kernel source with")
    c = sweep_case
    rays = tsw2.pack_rays(*c["rays"])
    stats = torch.zeros(tg.GC_LEN, dtype=torch.int64)
    with _build.host_rehearsal():
        t, obj = tg._launch_sweep2g(c["accel"], rays, stats)
    assert torch.equal(obj, c["port"][1])
    np.testing.assert_allclose(t.numpy(), c["port"][0].numpy(), rtol=2e-5)
    assert int(stats[tg.GC_SLAB]) > 0
    # only live rows are counted: a ray that enters every group tests each once
    accel = c["accel"]
    live = int((accel.otab[:accel.n_groups * accel.gr, tg.GO_VALID] > 0).sum())
    assert 0 < int(stats[tg.GC_SPHERE_ROWS] + stats[tg.GC_OTHER_ROWS]) <= rays.shape[1] * live


def test_work_counters_skip_dead_rows():
    """One box in a group of 8 rows: a ray through it tests one row, not 8."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ to rehearse the kernel source with")
    accel = tg.make_accel2g(_one_box(), gr=8, has_motion=False)
    live = int((accel.otab[:accel.n_groups * accel.gr, tg.GO_VALID] > 0).sum())
    c = accel.otab[accel.otab[:, tg.GO_VALID] > 0][0, :3]
    o = (c + torch.tensor([0.0, 0.0, 10.0]))[None].repeat(3, 1)
    d = torch.tensor([[0.0, 0.0, -1.0]]).repeat(3, 1)
    rays = tsw2.pack_rays(o, d, torch.zeros(3), torch.full((3,), 100.0))
    stats = torch.zeros(tg.GC_LEN, dtype=torch.int64)
    with _build.host_rehearsal():
        _, obj = tg._launch_sweep2g(accel, rays, stats)
    assert (obj >= 0).all() and live == 1
    assert int(stats[tg.GC_SPHERE_ROWS] + stats[tg.GC_OTHER_ROWS]) == 3 * live


# ---------------------------------------------------------------------------
# The silhouette instantiation (the gradient path's generic soft edges)
# ---------------------------------------------------------------------------
#
# Tolerances: the same winner as the JAX kernel on >= 99.9 % of rays, and t
# within the nearest-hit test's 2^-12 relative + 2e-5 where it agrees: the JAX
# edge variant solves every row in its unit-space form, the port's t is the
# nearest-hit sweep's, which solves censused spheres in the world frame
# (a = 1); the two round a near-cancelling quadratic apart (found 6.5e-5
# relative on one of 1002 hits).  ``edge`` equal to the JAX kernel's on every ray where
# the JAX kernel evaluated the port's candidate (a 2048-ray batch is one
# block, which evaluates every group some ray of it entered); elsewhere the
# port's candidate at least as good by the metric recomputed in numpy
# float32 from the same table.


def _edge_metric_g_np(accel, o, d, omt, rows):
    """|e|^2 - (e.f)^2 / |f|^2 - 1 of rows ``rows`` (B,) for rays (B, 3), numpy
    float32; BIG_T where the row is no candidate."""
    f = np.float32
    r = accel.otab.numpy()[rows]
    rel = o - r[:, tg.GO_PX:tg.GO_PZ + 1]
    if accel.has_motion:
        rel = rel + omt[:, None] * r[:, tg.GO_DPX:tg.GO_DPZ + 1]
    R = r[:, tg.GO_R00:tg.GO_R00 + 9].reshape(-1, 3, 3)
    sc = r[:, tg.GO_SX:tg.GO_SZ + 1]

    def local(v):  # R^T v, the terms in the kernel's order
        return np.stack([(R[:, 0, k] * v[:, 0] + R[:, 1, k] * v[:, 1]) + R[:, 2, k] * v[:, 2]
                         for k in range(3)], axis=1).astype(f)

    e = local(rel) / sc
    fv = local(d) / sc
    dot = lambda a, b: ((a[:, 0] * b[:, 0] + a[:, 1] * b[:, 1]) + a[:, 2] * b[:, 2]).astype(f)
    a, hb, cc = dot(fv, fv), dot(e, fv), dot(e, e)
    me = cc - hb * hb * (f(1.0) / np.maximum(a, f(1e-30))) - f(1.0)
    ok = (hb < 0.0) & (r[:, tg.GO_VALID] > 0.0) & (a > 1e-30)
    return np.where(ok, me, f(tg.BIG_T))


@pytest.fixture(scope="module")
def edge_case_g(sweep_case):
    c = sweep_case
    o, d, tr, tl = (x.numpy() for x in c["rays"])
    _, _, ja, *_ = _build_both(c["name"])
    jt, jo, je = (np.asarray(x) for x in jg.sweep2g_nearest_edge(
        ja, *(jnp.asarray(x) for x in (o, d, tr, tl))))
    port = tg.sweep2g_nearest_edge(c["accel"], *c["rays"])
    return dict(c, jax_edge=(jt, jo, je), port_edge=port)


def test_sweep2g_nearest_edge_matches_jax(edge_case_g):
    c = edge_case_g
    (jt, jo, je), (tt, to, te) = c["jax_edge"], c["port_edge"]
    assert torch.equal(tt, c["port"][0]) and torch.equal(to, c["port"][1])
    tt, to, te = tt.numpy(), to.numpy(), te.numpy()
    assert (to == jo).mean() >= 0.999, (to == jo).mean()
    m = (to == jo) & (jo >= 0)
    over = np.abs(tt[m] - jt[m]) - (2.0 ** -12 * jt[m] + 2e-5)
    assert over.max() <= 0.0, over.max()
    assert (te[:16] == -1).all() and (je[:16] == -1).all()  # dead rays
    assert (te >= 0).mean() > 0.3
    differ = te != je
    assert differ.mean() <= 0.001, (c["name"], differ.mean())
    if differ.any():
        o, d = (x.numpy()[differ] for x in c["rays"][:2])
        mp = _edge_metric_g_np(c["accel"], o, d, None, te[differ])
        mj = _edge_metric_g_np(c["accel"], o, d, None, np.maximum(je[differ], 0))
        assert (mp <= np.where(je[differ] >= 0, mj, np.float32(tg.BIG_T))).all()


@pytest.mark.parametrize("motion", [False, True])
def test_edge_kernel_source_rehearsed_on_the_host(sweep_case, motion):
    """``csrc/sweep2g.cu``'s EDGE instantiations (static and motion) compiled as
    host C++: obj and edge equal to the plain version's, t within 2e-5
    relative (as the nearest-hit rehearsal) and 2e-5 absolute (a moving
    ellipsoid met at t = 0.25 differed by 9.3e-6: PyTorch's vectorised CPU
    sqrt is not always correctly rounded), and (t, obj) bit for bit the
    nearest-hit instantiation's."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ to rehearse the kernel source with")
    c = sweep_case
    o, d, tr, tl = c["rays"]
    accel = c["accel"]
    if motion:
        scene = c["ts"]
        dp = torch.zeros_like(scene.delta_position)
        dp[::2, 2] = -0.4
        accel = tg.make_accel2g(scene.replace(delta_position=dp), gr=8, has_motion=True)
        tr = torch.from_numpy(np.random.default_rng(4).uniform(0, 1, tr.shape[0])
                              .astype(np.float32))
    rays = tsw2.pack_rays(o, d, tr, tl)
    want = tg.sweep2g_edge_plain(accel, rays)
    with _build.host_rehearsal():
        got = tg._launch_sweep2g(accel, rays, with_edge=True)
        t0, o0 = tg._launch_sweep2g(accel, rays)
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
    np.testing.assert_allclose(got[0].numpy(), want[0].numpy(), rtol=2e-5, atol=2e-5)
    assert torch.equal(got[0], t0) and torch.equal(got[1], o0)
    assert (want[2] >= 0).float().mean() > 0.3 and (want[2][:16] == -1).all()


# ---------------------------------------------------------------------------
# The exact per-block cull of the silhouette instantiation
# ---------------------------------------------------------------------------
#
# Tolerances: the culled pass must give the dense definition's candidate
# exactly: the host build of the EDGE instantiations is held to the plain
# version with torch.equal on obj and edge; its t (the nearest-hit sweep's,
# which the cull does not touch) bit for bit to the nearest-hit
# instantiation's, and to the plain version's within the tolerance of
# ``test_edge_kernel_source_rehearsed_on_the_host`` (2e-5 relative and
# absolute; its reason there).  The plain form of the block bound is held
# below every row's metric in ``test_torch_edge_cull.py``.


def _adversarial_generic(moving: bool):
    """Rotated boxes and ellipsoids that stress the cull: the 1000-radius
    ground ellipsoid, a field of anisotropic primitives at z in [-12, -3]
    (every third one moving in ``moving``), a 0.45 box 60 units out, 20
    copies of one rotated box (equal metrics on rows of different blocks),
    and 14 invalid rows of capacity padding."""
    rng = np.random.default_rng(11)
    b = ttypes.SceneBuilder()
    b.add_sphere((0.0, -1000.0, 0.0), 1000.0)
    for k in range(36):
        kw = {"delta_position": (rng.uniform(-0.5, 0.5), 0.0, rng.uniform(-0.5, 0.5))} \
            if moving and k % 3 == 0 else {}
        b.add((rng.uniform(-6.0, 6.0), rng.uniform(0.2, 1.0), rng.uniform(-12.0, -3.0)),
              tuple(np.exp(rng.uniform(np.log(0.1), np.log(0.6), 3))),
              ttypes.ELLIPSOID if k % 2 else ttypes.CUBOID,
              rotation_deg=tuple(rng.uniform(0.0, 360.0, 3)), **kw)
    b.add_box((60.0, 0.45, -60.0), (0.45, 0.45, 0.45))
    for _ in range(20):
        b.add_box((10.0, 0.5, -7.0), (0.3, 0.5, 0.2), rotation_deg=(10.0, 20.0, 30.0))
    return b.build(capacity=72)


def _unit(v):
    v = np.asarray(v, np.float64)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def _adversarial_rays_g(table, seed):
    """Ray families that a cull could get wrong -> ({family: slice}, o, d)."""
    rng = np.random.default_rng(seed)
    fam, o, d = {}, [], []

    def add(name, oo, dd):
        fam[name] = slice(len(o), len(o) + len(oo))
        o.extend(np.asarray(oo, np.float32))
        d.extend(np.asarray(dd, np.float32))

    field = np.stack([rng.uniform(-6, 6, 48), rng.uniform(0.0, 1.2, 48),
                      rng.uniform(-12, -3, 48)], axis=1)
    far = np.array([0.0, 3.0, 60.0]) + rng.uniform(-2, 2, (48, 3))
    add("far_origins", far, _unit(field - far))
    low = np.stack([rng.uniform(-5, 5, 32), rng.uniform(0.001, 0.02, 32),
                    rng.uniform(-2, 2, 32)], axis=1)
    add("over_the_ground", low, _unit(np.stack([rng.normal(size=32), rng.uniform(-0.05, 0.05, 32),
                                                -np.abs(rng.normal(size=32))], axis=1)))
    near = rng.uniform(-2, 2, (24, 3)) + np.array([0.0, 1.0, 0.0])
    add("to_the_far_one", near, _unit(np.array([60.0, 0.45, -60.0]) + rng.uniform(-1, 1, (24, 3))
                                      - near))
    oo, dd = [], []
    for e in range(table.shape[0]):  # lines at exactly the ball's radius from its centre
        u = _unit(rng.normal(size=3))
        n = _unit(np.cross(u, rng.normal(size=3)))
        oo.append(table[e, 0:3] + table[e, ec.EB_BR] * n - 15.0 * u)
        dd.append(u)
    add("grazing_balls", oo, dd)
    src = np.array([20.0, 0.5, -7.0]) + rng.uniform(-1, 1, (24, 3))
    add("tied_copies", src, _unit(np.array([10.0, 0.5, -7.0]) + rng.uniform(-0.05, 0.05, (24, 3))
                                  - src))
    over = np.stack([rng.uniform(-5, 5, 16), np.full(16, 2.5), rng.uniform(-1, 1, 16)], axis=1)
    add("misses", over, _unit(np.stack([rng.uniform(-0.3, 0.3, 16), np.full(16, 0.05),
                                        -np.ones(16)], axis=1)))
    add("nothing_ahead", np.tile([0.0, 50.0, 0.0], (8, 1)) + rng.uniform(-1, 1, (8, 3)),
        np.tile([0.0, 1.0, 0.0], (8, 1)))
    add("dead", rng.uniform(-3, 3, (8, 3)), np.zeros((8, 3)))
    return fam, np.stack(o), np.stack(d)


def test_edge_block_table_of_the_generic_accel():
    """The generic block table: valid rows only, each once in the blocks and
    once in the super-blocks, runs inside one group; built once per accel."""
    accel = tg.make_accel2g(_adversarial_generic(True), gr=16, has_motion=True)
    table, n_super = ec.edge_blocks(accel)
    assert ec.edge_blocks(accel)[0] is table
    t = table.numpy()
    valid = np.flatnonzero((accel.otab[:accel.n_pad, tg.GO_VALID] > 0).numpy())
    for part in (t[:n_super], t[n_super:]):
        rows = np.concatenate([np.arange(a, a + n) for a, n in
                               part[:, [ec.EB_ROW0, ec.EB_NROWS]].astype(int)])
        np.testing.assert_array_equal(rows, valid)
        assert (part[:, ec.EB_ROW0] // accel.gr ==
                (part[:, ec.EB_ROW0] + part[:, ec.EB_NROWS] - 1) // accel.gr).all()
    assert (t[n_super:, ec.EB_NROWS] <= ec.BLOCK_ROWS).all()
    assert (t[:n_super, ec.EB_NROWS] <= ec.SUPER_ROWS).all()
    for sup in t[:n_super]:  # a super-block is the union of the blocks it names
        sub = t[int(sup[ec.EB_SUB0]):int(sup[ec.EB_SUB0] + sup[ec.EB_NSUB])]
        assert sub[0, ec.EB_ROW0] == sup[ec.EB_ROW0]
        assert sub[:, ec.EB_NROWS].sum() == sup[ec.EB_NROWS]
    assert (t[:, ec.EB_MU] > 0).all() and np.isfinite(t[:, ec.EB_ERRK]).all()
    assert (t[:, ec.EB_DPMAX] > 0).any()


@pytest.mark.parametrize("motion", [False, True])
def test_edge_cull_rehearsed_on_adversarial_rays(motion):
    """The host build of the culled EDGE instantiation (static and moving)
    against the plain version (obj and edge torch.equal, t as the section's
    note says), on ray families that a cull could get wrong; each family
    shows what it claims, and the cull evaluated fewer rows than the dense
    pass."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ to rehearse the kernel source with")
    accel = tg.make_accel2g(_adversarial_generic(motion), gr=16, has_motion=motion)
    fam, o, d = _adversarial_rays_g(ec.edge_blocks(accel)[0].numpy().astype(np.float64), 6)
    n = o.shape[0]
    tr = np.random.default_rng(7).uniform(0.0, 1.0, n).astype(np.float32)
    tr[::7], tr[1::7] = 0.0, 1.0
    rays = tsw2.pack_rays(*(torch.from_numpy(x) for x in (o, d, tr, np.full(n, 1e4, np.float32))))
    want = tg.sweep2g_edge_plain(accel, rays)
    stats = torch.zeros(tg.EC_LEN, dtype=torch.int64)
    with _build.host_rehearsal():
        got = tg._launch_sweep2g(accel, rays, stats, with_edge=True)
        t0, _ = tg._launch_sweep2g(accel, rays)
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
    assert torch.equal(got[0], t0)
    np.testing.assert_allclose(got[0].numpy(), want[0].numpy(), rtol=2e-5, atol=2e-5)
    obj, edge = want[1].numpy(), want[2].numpy()
    assert (obj[fam["misses"]] == -1).all() and (edge[fam["misses"]] >= 0).all()
    assert (edge[fam["nothing_ahead"]] == -1).all() and (edge[fam["dead"]] == -1).all()
    ground = int(np.flatnonzero(accel.perm.numpy() == 0)[0])
    assert (obj[fam["far_origins"]] >= 0).any() and (obj[fam["over_the_ground"]] == ground).any()
    copies = np.flatnonzero(np.isin(accel.perm.numpy(), np.arange(38, 58))
                            & (accel.otab[:accel.n_pad, tg.GO_VALID] > 0).numpy())
    assert ((edge[fam["tied_copies"]] == copies.min()).sum() >= 12)
    starts = ec.edge_blocks(accel)[0].numpy()[:, ec.EB_ROW0]
    assert len(set(np.searchsorted(np.unique(starts), copies, side="right"))) >= 3
    act = (d != 0).any(axis=1)
    valid = int((accel.otab[:accel.n_pad, tg.GO_VALID] > 0).sum())
    assert 0 < int(stats[tg.EC_ROWS_HIT] + stats[tg.EC_ROWS_MISS]) < int(act.sum()) * valid


@pytest.mark.parametrize("sizes", [(1, 16), (4, 32), (8, 8)])
def test_edge_cull_gives_the_same_answer_at_other_block_sizes(sizes):
    """The culled pass on tables of other block sizes (a copy of the accel,
    ``edge_cull._with_block_sizes``, as the card's measurements build them):
    obj and edge torch.equal to the plain version's, moving rays included."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ to rehearse the kernel source with")
    accel = tg.make_accel2g(_adversarial_generic(True), gr=16, has_motion=True)
    other = ec._with_block_sizes(accel, *sizes)
    table, n_super = ec.edge_blocks(other)
    assert ec.edge_blocks(accel)[0].shape != table.shape
    assert (table[n_super:, ec.EB_NROWS] <= sizes[0]).all()
    fam, o, d = _adversarial_rays_g(table.numpy().astype(np.float64), 8)
    n = o.shape[0]
    tr = np.random.default_rng(9).uniform(0.0, 1.0, n).astype(np.float32)
    rays = tsw2.pack_rays(*(torch.from_numpy(x) for x in (o, d, tr, np.full(n, 1e4, np.float32))))
    want = tg.sweep2g_edge_plain(accel, rays)
    with _build.host_rehearsal():
        got = tg._launch_sweep2g(other, rays, with_edge=True)
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])


# ---------------------------------------------------------------------------
# The warp sweep's schedules (every K3 instantiation runs rt::warp_nearest_hit_g)
# ---------------------------------------------------------------------------
#
# Tolerances: the host build (a warp of one lane) runs each instantiation with
# coop_min forced to 1 (the per-lane walk) and 33 (row-parallel) and at the
# default; the three give torch.equal outputs and equal work counters but
# for the schedule's own (GC_COOP); obj and edge are torch.equal to the plain
# versions, t within the rehearsal tolerances above (2e-5 relative; for the
# moving tables also 2e-5 absolute, the reason at
# ``test_edge_kernel_source_rehearsed_on_the_host``).

SCHEDULES = (1, 33, None)  # forced coop_min; None: the module's COOP_MIN
INSTANTIATIONS = [(False, False), (True, False), (False, True), (True, True)]  # (motion, edge)


def _needs_gpp():
    if shutil.which("g++") is None:
        pytest.skip("no g++ to rehearse the kernel source with")


def _moving(scene, gr=8):
    """``scene`` with every other object moving, as a MOTION accel."""
    dp = torch.zeros_like(scene.delta_position)
    dp[::2, 2] = -0.4
    return tg.make_accel2g(scene.replace(delta_position=dp), gr=gr, has_motion=True)


def _schedules(accel, rays, edge):
    """The host build of K3 on ``rays`` in each schedule -> {coop_min: (outputs,
    stats)}."""
    out = {}
    with _build.host_rehearsal():
        for cm in SCHEDULES:
            stats = torch.zeros(tg.EC_LEN if edge else tg.GC_LEN, dtype=torch.int64)
            with contextlib.nullcontext() if cm is None else _build.forced_coop_min(cm):
                out[cm] = (tg._launch_sweep2g(accel, rays, stats, with_edge=edge), stats)
    return out


def _plain_walk_counts(accel, rays):
    """The counters the walk of one thread per ray implies, in plain PyTorch:
    slab tests, live rows tested in sphere-kind groups and in the others, and
    rows up to the live bound of every group a ray entered (the lane slots of a
    warp of one lane).  ``_sweep_plain_g``'s walk, counted."""
    o, d, omt, tlim = rays[0:3].T.contiguous(), rays[3:6].T.contiguous(), rays[6], rays[7]
    live = tsw2._dot3(d, d) > 0.5
    G, gr = accel.n_groups, accel.gr
    inv = 1.0 / torch.where(d.abs() < 1e-12, torch.full_like(d, 1e-12), d)
    t_best = torch.clamp_max(tlim, tg.BIG_T).clone()
    valid = accel.otab[:accel.n_pad, tg.GO_VALID].reshape(G, gr) > 0.0
    bound = tsw2.live_rows(accel)
    n = dict(slab=0, sphere=0, other=0, slots=0)
    for s in range(max(accel.n_sgroups, 1)):
        shit = live
        if accel.n_sgroups:
            n["slab"] += int(live.sum())
            shit = live & tg._slab_hit(accel.gaabb[G + accel.n_pgroups + s], o, inv, t_best)
        for g in range(s * tg.SG, min((s + 1) * tg.SG, G)) if accel.n_sgroups else range(G):
            n["slab"] += int(shit.sum())
            sel = torch.nonzero(shit & tg._slab_hit(accel.gaabb[g], o, inv, t_best))[:, 0]
            n["sphere" if accel.gkinds[g] == "s" else "other"] += sel.numel() * int(valid[g].sum())
            n["slots"] += sel.numel() * int(bound[g])
            if sel.numel():
                rows = accel.otab[g * gr:(g + 1) * gr]
                tc = tg._group_candidates(rows, accel.gkinds[g], o[sel], d[sel], omt[sel],
                                          accel.has_motion)
                gmin = torch.amin(tg._where_big(valid[g][None], tc), dim=1)
                t_best[sel] = torch.minimum(t_best[sel], gmin)
    return n


def _check_schedules(accel, rays, edge):
    """Every schedule of the host build: torch.equal to each other, obj (and
    edge) torch.equal to the plain version, t within the section's
    tolerances -> the per-lane schedule's stats."""
    runs = _schedules(accel, rays, edge)
    want = (tg.sweep2g_edge_plain if edge else tg.sweep2g_plain)(accel, rays)
    (first, st1) = runs[1]
    for cm, (got, st) in runs.items():
        assert all(torch.equal(a, b) for a, b in zip(got, first)), cm
        keep = [k for k in range(st.numel()) if k != tg.GC_COOP]
        assert torch.equal(st[keep], st1[keep]), (cm, st, st1)
    assert torch.equal(first[1], want[1])
    if edge:
        assert torch.equal(first[2], want[2])
    atol = 2e-5 if accel.has_motion else 0.0
    np.testing.assert_allclose(first[0].numpy(), want[0].numpy(), rtol=2e-5, atol=atol)
    assert int(st1[tg.GC_COOP]) == 0 < int(runs[33][1][tg.GC_COOP])
    return st1


@pytest.mark.parametrize("motion,edge", INSTANTIATIONS)
def test_every_instantiation_in_every_schedule_on_the_host(sweep_case, motion, edge):
    """The four instantiations of K3 (static, MOTION, each also EDGE) compiled
    as host C++, with coop_min 1, 33 and the default: identical outputs and
    counters, and the plain version's obj and edge."""
    _needs_gpp()
    c = sweep_case
    o, d, tr, tl = c["rays"]
    accel = c["accel"]
    if motion:
        accel = _moving(c["ts"])
        tr = torch.from_numpy(np.random.default_rng(4).uniform(0, 1, tr.shape[0])
                              .astype(np.float32))
    st = _check_schedules(accel, tsw2.pack_rays(o, d, tr, tl), edge)
    assert int(st[tg.GC_SPHERE_ROWS] + st[tg.GC_OTHER_ROWS]) > 0


@pytest.mark.parametrize("motion,edge", INSTANTIATIONS)
def test_ragged_batch_with_dead_lanes_in_the_middle_on_the_host(motion, edge):
    """B = 1000 (no multiple of the 256-thread block, so the last block's
    lanes past B take part as dead rays) with runs of dead rays inside the
    batch: every schedule gives the plain version's answer, and dead rays
    report no hit and no candidate."""
    _needs_gpp()
    scene, cam = tex.bvh_grid_scene(side=12)
    accel = (_moving(scene) if motion else
             tg.make_accel2g(scene, gr=8, has_motion=False, sort_origin=cam.position))
    o, d, _, tl = _rays(8, 1000, np.asarray(cam.position), 1.5)  # the first 16 dead
    dead = np.zeros(1000, bool)
    dead[:16] = dead[[255, 256, 511, 700]] = dead[300:340] = True
    d[dead] = 0.0
    tr = np.random.default_rng(5).uniform(0, 1, 1000).astype(np.float32)
    rays = tsw2.pack_rays(*(torch.from_numpy(x) for x in (o, d, tr, tl)))
    _check_schedules(accel, rays, edge)
    got = _schedules(accel, rays, edge)[None][0]
    assert (got[1][torch.from_numpy(dead)] == -1).all()
    if edge:
        assert (got[2][torch.from_numpy(dead)] == -1).all()
    assert (got[1][torch.from_numpy(~dead)] >= 0).float().mean() > 0.3


@pytest.mark.parametrize("edge", [False, True])
def test_live_row_bound_on_groups_that_end_in_dead_rows(edge):
    """A moving generic scene whose groups end in padding rows, with dead rows
    (valid = 0) put below the last live row of two groups: the live-row bound
    is below ``gr``, the rows past it are never read, the dead rows below it
    are skipped, and every schedule gives the plain version's answer."""
    _needs_gpp()
    accel = tg.make_accel2g(_adversarial_generic(True), gr=16, has_motion=True)
    otab = accel.otab.clone()
    otab[[5, 2 * accel.gr + 7], tg.GO_VALID] = 0.0
    accel = dataclasses.replace(accel, otab=otab)
    bound = tsw2.live_rows(accel)
    live = (accel.otab[:accel.n_pad, tg.GO_VALID] > 0).reshape(accel.n_groups, accel.gr)
    assert (bound < accel.gr).any()  # rows past the bound: padding
    assert (live.sum(dim=1) < bound).any()  # dead rows below it
    fam, o, d = _adversarial_rays_g(ec.edge_blocks(accel)[0].numpy().astype(np.float64), 12)
    n = o.shape[0]
    tr = np.random.default_rng(13).uniform(0.0, 1.0, n).astype(np.float32)
    rays = tsw2.pack_rays(*(torch.from_numpy(x) for x in (o, d, tr, np.full(n, 1e4, np.float32))))
    st = _check_schedules(accel, rays, edge)
    # a warp of one lane issues exactly the rows up to the bound of each group entered
    assert int(st[tg.GC_SLOTS]) == _plain_walk_counts(accel, rays)["slots"]


@pytest.mark.parametrize("motion", [False, True])
def test_work_counters_are_the_per_lane_walks_in_both_schedules(sweep_case, motion):
    """GC_SLAB, GC_SPHERE_ROWS and GC_OTHER_ROWS of the host build, per lane
    (coop_min 1) and row-parallel (33), equal the slab tests and live rows by
    kind that the plain walk implies; GC_SLOTS the rows up to each entered
    group's live bound (a warp of one lane), GC_COOP 0 per lane and one a
    group visit row-parallel."""
    _needs_gpp()
    c = sweep_case
    o, d, tr, tl = c["rays"]
    accel = _moving(c["ts"]) if motion else c["accel"]
    if motion:
        tr = torch.from_numpy(np.random.default_rng(6).uniform(0, 1, tr.shape[0])
                              .astype(np.float32))
    rays = tsw2.pack_rays(o, d, tr, tl)
    want = _plain_walk_counts(accel, rays)
    runs = _schedules(accel, rays, False)
    for cm in (1, 33):
        st = runs[cm][1]
        assert [int(st[k]) for k in (tg.GC_SLAB, tg.GC_SPHERE_ROWS, tg.GC_OTHER_ROWS,
                                     tg.GC_SLOTS)] == \
            [want[k] for k in ("slab", "sphere", "other", "slots")], (cm, st, want)
    assert int(runs[1][1][tg.GC_COOP]) == 0
    assert int(runs[33][1][tg.GC_COOP]) > 0 and want["slab"] > 0
