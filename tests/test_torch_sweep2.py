"""The module that holds the sphere-sweep kernel, against the JAX package.

On the CPU the port's wrappers run the plain PyTorch version of the kernel;
the JAX side runs its Pallas kernel in interpret mode.

Tolerances:
  - accel build: ``perm``, the probe mask and the probe row set are equal;
    group AABBs and anchors are equal; table entries agree to rtol 1e-6
    (K1 = |c|^2 - r^2 is a three-term sum) and atol 1e-3 on K1 of the
    1000-radius ground sphere, where one ulp of |c|^2 is 0.06.
  - sweeps: same winner on >= 99.9 % of rays.  The refined t (hit block) within
    rtol 1e-4 where the winner agrees, except on the 1000-radius ground
    sphere: there |o - c|^2 - r^2 cancels at 1e6 in float32, both packages sit
    up to 7e-4 (relative) from the float64 root for rays that start low over
    the ground, and XLA fuses a*b+c where eager PyTorch rounds twice, so the
    two are held to rtol 2e-3.  The unrefined t of ``sweep2_nearest``
    within rtol 2.5e-4 + atol 2e-2, because the JAX kernel truncates t to 13
    mantissa bits in its packed (t, id) key (up to 1.2e-4 relative) and the
    anchored solve carries an absolute error that only the refine removes.
    Hit-block material fields and surrounding RI equal; normals, which carry
    the t difference over the radius (x5 on the 0.2-radius spheres), within
    1e-5 on >= 95 % of hits (97.3 % found) and within 1e-3 on all.
  - the kernel source compiled as host C++ (where there is a g++) against the
    plain version, in each sweep schedule: winners equal, the hit block
    within 1e-5 (relative above 1) on >= 99.9 % of rays (the plain version
    sums the probe's RIs with ``torch.sum``, in another order), the ground
    sphere's refined t within rtol 2e-3 (as above), and every schedule's
    output bit for bit the default schedule's.  The surrounding RI inside glass
    spheres nested four deep equals, bit for bit, a sequential float32 sum
    over the probe rows in row order (the kernel's order); the plain
    version's within rtol 1e-6.
"""

import shutil

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from raytracing_tests_tpu.kernels import sweep2 as jsw
from raytracing_tests_tpu.ops.render import RenderConfig as JRenderConfig
from raytracing_tests_tpu.scene import examples as jex
from raytracing_tests_tpu.scene.types import SceneBuilder as JSceneBuilder
from raytracing_tests_tpu_torch import convert
from raytracing_tests_tpu_torch.kernels import _build
from raytracing_tests_tpu_torch.kernels import sweep2 as tsw
from raytracing_tests_tpu_torch.ops.intersect import intersect_brute
from raytracing_tests_tpu_torch.ops.render import RenderConfig as TRenderConfig
from raytracing_tests_tpu_torch.scene import examples as tex
from raytracing_tests_tpu_torch.scene.types import SceneBuilder as TSceneBuilder

torch.set_num_threads(2)


def _glass_pair(sb_cls):
    """Three spheres, two of them glass and touching: np_pad > n probe path."""
    b = sb_cls()
    b.add_dielectric((0.0, 0.0, -3.0), 0.5)
    b.add_dielectric((0.9, 0.0, -3.0), 0.5)
    b.add_lambertian((0.0, -100.5, -3.0), 100.0, (0.5, 0.6, 0.4))
    return b.build()


BUILDS = {
    # name -> (scene factory taking the examples module and scene class, gr, sort, cut)
    "iow5_default": (lambda ex, sb: ex.iow_final_scene(side=5), 128, False, False),
    "iow5_gr32_sorted_cut": (lambda ex, sb: ex.iow_final_scene(side=5), 32, True, True),
    "iow_headline": (lambda ex, sb: ex.iow_final_scene(), 64, True, True),
    "glass_pair": (lambda ex, sb: (_glass_pair(sb), ex.sphere_scene()[1]), 8, True, True),
}


def _jax_ftab(accel):
    return sum(np.asarray(x.astype(jnp.float32)) for x in accel.ftab3)


def _build_both(name):
    factory, gr, sort, cut = BUILDS[name]
    js, jc = factory(jex, JSceneBuilder)
    ts, tc = factory(tex, TSceneBuilder)
    jcfg = JRenderConfig().for_scene(js)
    tcfg = TRenderConfig().for_scene(ts)
    assert jcfg.probe_rows == tcfg.probe_rows and jcfg.pallas_mode == tcfg.pallas_mode
    jmask = jsw.probe_relevant_rows(js) if cut else None
    tmask = tsw.probe_relevant_rows(ts) if cut else None
    kw = lambda cfg, mask, cam: dict(
        gr=gr,
        sort_origin=cam.position if sort else None,
        probe_rows=int(mask.sum()) if cut else cfg.probe_rows, probe_mask=mask)
    ja = jsw.make_accel2(js, **kw(jcfg, jmask, jc))
    ta = tsw.make_accel2(ts, **kw(tcfg, tmask, tc))
    return js, ja, jmask, ts, ta, tmask


@pytest.mark.parametrize("name", list(BUILDS))
def test_make_accel2_matches_jax(name):
    js, ja, jmask, ts, ta, tmask = _build_both(name)
    if jmask is not None:
        np.testing.assert_array_equal(tmask, jmask)
    np.testing.assert_array_equal(ta.perm.numpy(), np.asarray(ja.perm))
    assert ta.n_pgroups == ja.n_pgroups and ta.gr == ja.gr
    ref = convert.accel2_from_numpy(
        np.asarray(ja.otab), _jax_ftab(ja), np.asarray(ja.gaabb),
        np.asarray(ja.perm), ja.gr)
    # group AABBs and anchors
    np.testing.assert_array_equal(ta.gaabb.numpy(), ref.gaabb.numpy())
    # probe row set: the live probe rows sit at the same places with the same RI
    live_t = ta.otab[ta.n_pad:, tsw.OT_K1].numpy() < 1e38
    live_j = ref.otab[ref.n_pad:, tsw.OT_K1].numpy() < 1e38
    np.testing.assert_array_equal(live_t, live_j)
    if jmask is not None:
        assert live_t.sum() == jmask.sum()
    # table entries
    k1 = tsw.OT_K1
    cols = [c for c in range(tsw.OT_COLS) if c != k1]
    np.testing.assert_allclose(ta.otab[:, cols].numpy(), ref.otab[:, cols].numpy(),
                               rtol=1e-6, atol=0)
    np.testing.assert_allclose(ta.otab[:, k1].numpy(), ref.otab[:, k1].numpy(),
                               rtol=1e-6, atol=1e-3)
    np.testing.assert_allclose(ta.ftab.numpy(), ref.ftab.numpy(), rtol=1e-6, atol=0)


def test_headline_probe_cut_keeps_40_of_486_rows():
    ts, _ = tex.iow_final_scene()
    cfg = TRenderConfig().for_scene(ts)
    assert cfg.probe_rows == 486
    assert int(tsw.probe_relevant_rows(ts).sum()) == 40


def test_make_accel2_refuses_motion():
    """It no longer does: a moving scene gets the accel with the motion
    columns (held against JAX in ``test_torch_motion``), and only tables that
    carry motion under a static flag are refused."""
    ts, _ = tex.iow_final_scene(side=5)
    assert ts.capacity > 1  # a sphere-mode scene
    moving = ts.replace(delta_position=torch.full_like(ts.delta_position, 0.1))
    accel = tsw.make_accel2(moving, gr=32)
    assert accel.has_motion and accel.otab.shape[1] == tsw.OT_COLS_MOTION
    assert (accel.otab[:ts.capacity, tsw.OT_DPX:tsw.OT_DPZ + 1] == 0.1).any()
    tsw.check_accel(accel, torch.device("cpu"))
    still = tsw.make_accel2(ts, gr=32)
    assert not still.has_motion and still.otab.shape[1] == tsw.OT_COLS
    wide = np.zeros((accel.otab.shape[0], 128), np.float32)
    wide[:, 8:11] = 0.1
    with pytest.raises(ValueError, match="has_motion"):
        convert.accel2_from_numpy(wide, np.zeros((24, accel.n_pad), np.float32),
                                  np.zeros((accel.gaabb.shape[0], 128), np.float32),
                                  accel.perm.numpy(), 32)


def _rays(seed, n):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-6.0, 6.0, (n, 3)).astype(np.float32)
    o[:, 1] = np.abs(o[:, 1]) * 0.5 + 0.05
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d[:16] = 0.0  # dead rays
    return o, d, np.zeros(n, np.float32), np.full(n, 32000.0, np.float32)


@pytest.fixture(scope="module")
def sweep_case():
    """4096 seeded rays through the JAX kernel (interpret mode) and the port's
    plain version, both on the JAX package's own accel."""
    js, ja, _, ts, ta, _ = _build_both("iow5_gr32_sorted_cut")
    o, d, tr, tl = _rays(5, 4096)
    jargs = [jnp.asarray(x) for x in (o, d, tr, tl)]
    targs = [torch.from_numpy(x) for x in (o, d, tr, tl)]
    ref = convert.accel2_from_numpy(
        np.asarray(ja.otab), _jax_ftab(ja), np.asarray(ja.gaabb),
        np.asarray(ja.perm), ja.gr)
    return dict(js=js, ja=ja, ts=ts, ta=ta, ref=ref, jargs=jargs, targs=targs)


@pytest.mark.parametrize("which", ["jax_accel", "own_accel"])
def test_sweep2_nearest_matches_jax(sweep_case, which):
    c = sweep_case
    jt, jo = jsw.sweep2_nearest(c["ja"], *c["jargs"])
    accel = c["ref"] if which == "jax_accel" else c["ta"]
    tt, to = tsw.sweep2_nearest(accel, *c["targs"])
    jt, jo, tt, to = np.asarray(jt), np.asarray(jo), tt.numpy(), to.numpy()
    assert (to[:16] == -1).all() and (jo[:16] == -1).all()
    same = jo == to
    assert same.mean() >= 0.999, same.mean()
    m = same & (jo >= 0)
    assert m.mean() > 0.3
    np.testing.assert_allclose(tt[m], jt[m], rtol=2.5e-4, atol=2e-2)
    np.testing.assert_array_equal(tt[same & (jo < 0)], jt[same & (jo < 0)])


@pytest.mark.parametrize("with_ri", [True, False])
def test_sweep2_full_matches_jax(sweep_case, with_ri):
    c = sweep_case
    jt, jo, jr = jsw.sweep2_full(c["ja"], *c["jargs"], with_ri=with_ri)
    tt, to, tr = tsw.sweep2_full(c["ref"], *c["targs"], with_ri=with_ri)
    jt, jo, jr = np.asarray(jt), np.asarray(jo), np.asarray(jr)
    tt, to, tr = tt.numpy(), to.numpy(), tr.numpy()
    assert tr.shape == jr.shape == (tsw.V_ROWS, 4096)
    same = jo == to
    assert same.mean() >= 0.999, same.mean()
    m = same & (jo >= 0)
    ground = np.asarray(c["ja"].perm)[np.maximum(jo, 0)] == 0  # original object 0
    np.testing.assert_allclose(tt[m & ~ground], jt[m & ~ground], rtol=1e-4, atol=0)
    np.testing.assert_allclose(tt[m & ground], jt[m & ground], rtol=2e-3, atol=0)
    np.testing.assert_array_equal(tr[tsw.V_T], tt)
    np.testing.assert_array_equal(tr[tsw.V_OBJ, m], np.asarray(c["ja"].perm)[jo[m]])
    np.testing.assert_array_equal(tr[tsw.V_RI, m], jr[jsw.V_RI, m])
    if not with_ri:
        assert (tr[tsw.V_RI] == 1.0).all()
    np.testing.assert_array_equal(tr[5:, m], jr[5:, m])
    nerr = np.abs(tr[2:5, m] - jr[2:5, m]).max(axis=0)
    assert (nerr <= 1e-5).mean() >= 0.95 and nerr.max() <= 1e-3, (
        (nerr <= 1e-5).mean(), nerr.max())


def test_sweep2_probes_ri_only_where_it_is_consumed(sweep_case):
    """The surrounding RI is probed for dielectric winners and interior hits
    (the rays whose refraction reads it); every other ray, misses included,
    carries the neutral 1 — as the JAX kernel's ``need`` mask has it."""
    c = sweep_case
    _, to, tr = tsw.sweep2_full(c["ta"], *c["targs"], with_ri=True)
    d = c["targs"][1]
    inner = (tr[tsw.V_NX:tsw.V_NZ + 1].T * d).sum(dim=1) > 0.0
    need = (to >= 0) & (inner | (tr[tsw.V_REFR] > 0.002))
    assert need.any() and (~need).any()
    assert (tr[tsw.V_RI][~need] == 1.0).all()
    # The probe is live: from the centre of one glass sphere towards the one
    # that overlaps it, the ray enters the second while still inside the first
    # and reads the first's index; a lambertian hit beside it reads 1.
    pair = _glass_pair(TSceneBuilder)
    accel = tsw.make_accel2(pair, gr=8, probe_rows=TRenderConfig().for_scene(pair).probe_rows)
    o = torch.tensor([[0.0, 0.0, -3.0], [3.0, 0.0, -3.0]])
    d = torch.tensor([[1.0, 0.0, 0.0], [0.0, -1.0, 0.0]])
    _, obj, rows = tsw.sweep2_full(accel, o, d, torch.zeros(2), torch.full((2,), 100.0),
                                   with_ri=True)
    assert (obj >= 0).all()
    assert rows[tsw.V_RI, 0] > 1.0 and rows[tsw.V_RI, 1] == 1.0


def test_sweep2_matches_intersect_brute(sweep_case):
    c = sweep_case
    o, d, trr, tl = c["targs"]
    hb = intersect_brute(c["ts"], o, d, trr, tl)
    h2, flds, ri = tsw.intersect2_fused(c["ta"], c["ts"], o, d, trr, tl)
    hit_b, hit_2 = hb.hit.numpy(), h2.hit.numpy()
    same = (hit_b == hit_2) & (~hit_b | (hb.obj.numpy() == h2.obj.numpy()))
    assert same.mean() >= 0.999, same.mean()
    m = same & hit_b
    ground = hb.obj.numpy() == 0
    np.testing.assert_allclose(h2.t.numpy()[m & ~ground], hb.t.numpy()[m & ~ground],
                               rtol=1e-4, atol=0)
    np.testing.assert_allclose(h2.t.numpy()[m & ground], hb.t.numpy()[m & ground],
                               rtol=2e-3, atol=0)
    # the brute sweep solves in unit space (o / r); normals carry the t
    # difference over the radius
    nerr = np.abs(h2.normal.numpy()[m] - hb.normal.numpy()[m]).max(axis=-1)
    assert (nerr <= 1e-4).mean() >= 0.99 and nerr.max() <= 5e-3, (
        (nerr <= 1e-4).mean(), nerr.max())
    col = c["ts"].color[hb.obj.long()].numpy()
    np.testing.assert_array_equal(flds.color.numpy()[m], col[m])
    h_only = tsw.intersect2(c["ta"], c["ts"], o, d, trr, tl)  # no RI probe
    assert torch.equal(h_only.t, h2.t) and torch.equal(h_only.obj, h2.obj)
    occ = tsw.occluded_nearest_obj2(c["ta"], c["ts"], o, d, trr, tl).numpy()
    assert ((occ == np.where(hit_2, h2.obj.numpy(), -1))).all()


def test_check_accel_refuses_wrong_table_shape(sweep_case):
    import dataclasses

    bad = dataclasses.replace(sweep_case["ta"], ftab=sweep_case["ta"].ftab[:, :-1])
    with pytest.raises(ValueError):
        tsw.check_accel(bad, torch.device("cpu"))


# ---------------------------------------------------------------------------
# The kernel source, compiled as host C++, in each sweep schedule
# ---------------------------------------------------------------------------

# coop_min of the host rehearsals: None is the module's default (COOP_MIN).
# A host warp is one lane, so 1 sweeps every group per lane and the others
# row-parallel with a row stride of 1.
SCHEDULES = [None, 1, 33]

DEEP_CENTRE = (0.0, 0.0, -3.0)


def deep_glass(sb_cls):
    """Four concentric glass spheres of different refractive indices and a
    fifth that cuts into them, over a ground sphere: a ray that leaves the
    innermost sphere from inside probes at a point inside three or four
    glass spheres."""
    b = sb_cls()
    for radius, ior in ((0.9, 1.5), (0.65, 1.3), (0.45, 1.7), (0.25, 1.4)):
        b.add_dielectric(DEEP_CENTRE, radius, ior=ior)
    b.add_dielectric((0.45, 0.1, -2.8), 0.4, ior=1.6)
    b.add_lambertian((0.0, -100.9, -3.0), 100.0, (0.5, 0.6, 0.4))
    return b.build()


def _rays_inside(seed, n):
    """Rays from points inside the innermost deep-glass sphere."""
    rng = np.random.default_rng(seed)
    o = (np.asarray(DEEP_CENTRE) + rng.uniform(-0.14, 0.14, (n, 3))).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return [torch.from_numpy(x) for x in (o, d, np.zeros(n, np.float32),
                                           np.full(n, 32000.0, np.float32))]


def _need_gxx():
    if shutil.which("g++") is None:
        pytest.skip("no g++ to rehearse the kernel source with")


def _forced(coop_min):
    import contextlib

    return contextlib.nullcontext() if coop_min is None else _build.forced_coop_min(coop_min)


def _rehearse(accel, rays, coop_min):
    """The host build of csrc/sweep2.cu on ``rays`` -> ((t, obj, rows), stats)."""
    stats = torch.zeros(tsw.SW_LEN, dtype=torch.int64)
    with _build.host_rehearsal(), _forced(coop_min):
        got = tsw._launch_sweep2(accel, rays, True, True, stats)
    return got, stats


def _hold_to_plain(accel, got, want):
    """Winners equal; the hit block within 1e-5 (relative above 1) on >=
    99.9 % of rays, but the refined t of the 1000-radius ground sphere within
    rtol 2e-3: there |o - c|^2 - r^2 cancels at 1e6, and the host build and
    PyTorch round it apart (the kernel before its warp sweep did the same)."""
    assert torch.equal(got[1], want[1])
    err = (got[2] - want[2]).abs() / want[2].abs().clamp_min(1.0)
    ground = (got[1] >= 0) & (accel.perm[got[1].clamp_min(0).long()] == 0)
    err[tsw.V_T, ground] = err[tsw.V_T, ground] * (1e-5 / 2e-3)
    ok = (err <= 1e-5).all(dim=0)
    assert ok.float().mean() >= 0.999, float(ok.float().mean())
    assert torch.equal(got[0], got[2][tsw.V_T])


@pytest.mark.parametrize("coop_min", SCHEDULES)
def test_kernel_source_rehearsed_on_the_host_in_each_schedule(sweep_case, coop_min):
    """``csrc/sweep2.cu`` (static instantiation) against the plain version in
    each schedule, and bit for bit against the default schedule, counters
    included."""
    _need_gxx()
    c = sweep_case
    rays = tsw.pack_rays(*c["targs"])
    want = tsw.sweep2_plain(c["ta"], rays, True, True)
    got, stats = _rehearse(c["ta"], rays, coop_min)
    _hold_to_plain(c["ta"], got, want)
    base, stats_base = _rehearse(c["ta"], rays, None)
    assert all(torch.equal(a, b) for a, b in zip(got, base))
    same = [tsw.SW_TESTS, tsw.SW_ROW_TESTS]
    assert torch.equal(stats[same], stats_base[same]) and int(stats[tsw.SW_TESTS]) > 0
    assert (int(stats[tsw.SW_COOP_VISITS]) > 0) == ((coop_min or tsw.COOP_MIN) > 1)
    # a host warp is one lane: every row iteration serves one lane's row
    assert int(stats[tsw.SW_LANE_SLOTS]) == int(stats[tsw.SW_ROW_TESTS])


def _sequential_ri(accel, q):
    """The surrounding RI at points q (N, 3) as csrc's ri_probe computes it:
    float32 throughout, the rows in order, one sum each."""
    f = np.float32
    rows = accel.otab[accel.n_pad:].numpy()
    anchors = accel.gaabb[accel.n_groups:, 6:9].numpy()
    out = np.ones(len(q), np.float32)
    for n, (qx, qy, qz) in enumerate(q.astype(np.float32)):
        acc, cnt = f(0.0), f(0.0)
        for r, row in enumerate(rows):
            ax, ay, az = anchors[r // tsw.PROBE_GR]
            ux, uy, uz = f(qx - ax), f(qy - ay), f(qz - az)
            qq = f(f(f(ux * ux) + f(uy * uy)) + f(uz * uz))
            qc = f(f(f(row[0] * ux) + f(row[1] * uy)) + f(row[2] * uz))
            lhs = f(f(qq + row[3]) - f(f(2.0) * qc))
            if lhs <= 0.0:
                acc = f(acc + row[tsw.OT_RI])
                cnt = f(cnt + f(1.0))
        out[n] = f(acc / max(cnt, f(1.0))) if acc > 1.0 else f(1.0)
    return out


@pytest.mark.parametrize("coop_min", SCHEDULES)
def test_probe_sums_nested_glass_in_row_order(coop_min):
    """Rays that start inside four nested glass spheres: the kernel source's
    surrounding RI is the sequential row-order sum bit for bit, at points
    that lie inside three or four glass spheres."""
    _need_gxx()
    scene = deep_glass(TSceneBuilder)
    cfg = TRenderConfig().for_scene(scene)
    accel = tsw.make_accel2(scene, gr=8, probe_rows=cfg.probe_rows)
    o, d, tr, tl = _rays_inside(7, 512)
    rays = tsw.pack_rays(o, d, tr, tl)
    want = tsw.sweep2_plain(accel, rays, True, True)
    got, _ = _rehearse(accel, rays, coop_min)
    assert torch.equal(got[1], want[1]) and (got[1] >= 0).all()
    t, rows = got[0], got[2]
    n = rows[tsw.V_NX:tsw.V_NZ + 1].T
    need = ((n * d).sum(dim=1) > 0.0) | (rows[tsw.V_REFR] > 0.002)
    assert need.all()  # every winner is glass
    q = ((o + t[:, None] * d) + np.float32(1e-3) * n).numpy()
    glass = scene.valid & (scene.refractive_index != 1.0)
    d2 = ((torch.from_numpy(q)[:, None] - scene.position[glass][None]) ** 2).sum(dim=-1)
    depth = (d2 <= scene.scale[glass, 0][None] ** 2).sum(dim=1)
    assert (depth >= 3).float().mean() > 0.5 and (depth >= 4).any()
    np.testing.assert_array_equal(rows[tsw.V_RI].numpy(), _sequential_ri(accel, q))
    np.testing.assert_allclose(rows[tsw.V_RI].numpy(), want[2][tsw.V_RI].numpy(), rtol=1e-6)


@pytest.mark.parametrize("kind", ["spheres", "motion", "generic"])
def test_live_rows_are_computed_once_per_accel(kind):
    """``live_rows`` gives ``live_row_bounds`` of the accel, the same tensor
    at every launch, and the new bounds once the tables change in place."""
    from raytracing_tests_tpu_torch.kernels import sweep2g

    if kind == "generic":
        scene, _ = tex.bvh_grid_scene(side=4)
        accel = sweep2g.make_accel2g(scene, gr=16, has_motion=False)
        valid = sweep2g.GO_VALID
    else:
        scene, _ = tex.iow_final_scene(side=5)
        if kind == "motion":
            scene = scene.replace(delta_position=torch.full_like(scene.delta_position, 0.1))
        accel = tsw.make_accel2(scene, gr=16)
        assert accel.has_motion == (kind == "motion")
    want = tsw.live_row_bounds(accel)
    got = tsw.live_rows(accel)
    assert torch.equal(got, want) and tsw.live_rows(accel) is got
    g = int(torch.nonzero(want).flatten()[0])
    last = g * accel.gr + int(want[g]) - 1  # group g's last live row: now dead
    if kind == "generic":
        accel.otab[last, valid] = 0.0
    else:
        accel.otab[last, tsw.OT_K1] = tsw.BIG_T
    renewed = tsw.live_rows(accel)
    assert torch.equal(renewed, tsw.live_row_bounds(accel)) and int(renewed[g]) < int(want[g])


# ---------------------------------------------------------------------------
# The silhouette instantiation (the gradient path's soft edges)
# ---------------------------------------------------------------------------
#
# Tolerances: (t, obj) as ``test_sweep2_nearest_matches_jax``.  ``edge`` equal
# to the JAX kernel's on every ray where the JAX kernel evaluated the port's
# candidate: a batch of at most 2048 rays is one block of the JAX kernel,
# which evaluates the metric in every group that some ray of the block
# entered.  Elsewhere the port's candidate must be at least as good, by the
# metric recomputed in numpy float32 from the same tables.


def _edge_metric_np(accel, o, d, omt, rows):
    """(c_q - nb^2) * rinv2 of rows ``rows`` (B,) for rays (B, 3), in numpy
    float32 from the port's tables (the group-anchored frame); BIG_T where
    the row's centre is not ahead."""
    f = np.float32
    ot = accel.otab.numpy()
    an = accel.gaabb.numpy()[rows // accel.gr, 6:9]
    r = ot[rows]
    s = (o - an).astype(f)
    od = (s * d).sum(axis=1, dtype=f)
    oo = (s * s).sum(axis=1, dtype=f)
    C = r[:, 0:3]
    nb = (C * d).sum(axis=1, dtype=f) - od
    cq = oo + r[:, tsw.OT_K1] - f(2.0) * (C * s).sum(axis=1, dtype=f)
    if accel.has_motion:
        dp = r[:, tsw.OT_DPX:tsw.OT_DPZ + 1]
        nb = nb - omt * (dp * d).sum(axis=1, dtype=f)
        cq = cq + omt * (f(2.0) * (dp * s).sum(axis=1, dtype=f) - r[:, tsw.OT_K2]) \
            + omt * omt * r[:, tsw.OT_K3]
    return np.where(nb > 0.0, (cq - nb * nb) * r[:, tsw.OT_RINV2], f(tsw.BIG_T))


@pytest.fixture(scope="module")
def edge_case(sweep_case):
    """The first 2048 rays of ``sweep_case`` (16 dead): one block of the JAX
    kernel, through both silhouette sweeps on the JAX package's accel."""
    c = sweep_case
    jargs = [x[:2048] for x in c["jargs"]]
    targs = [x[:2048] for x in c["targs"]]
    jt, jo, je = (np.asarray(x) for x in jsw.sweep2_nearest_edge(c["ja"], *jargs))
    tt, to, te = tsw.sweep2_nearest_edge(c["ref"], *targs)
    return dict(c, targs=targs, jax=(jt, jo, je), port=(tt, to, te))


def test_sweep2_nearest_edge_matches_jax(edge_case):
    c = edge_case
    (jt, jo, je), (tt, to, te) = c["jax"], [x.numpy() for x in c["port"]]
    assert (to[:16] == -1).all() and (te[:16] == -1).all() and (je[:16] == -1).all()
    same = jo == to
    assert same.mean() >= 0.999, same.mean()
    m = same & (jo >= 0)
    np.testing.assert_allclose(tt[m], jt[m], rtol=2.5e-4, atol=2e-2)
    # the nearest (t, obj) are the nearest-hit sweep's
    t0, o0 = tsw.sweep2_nearest(c["ref"], *c["targs"])
    assert torch.equal(c["port"][0], t0) and torch.equal(c["port"][1], o0)
    assert (te >= 0).mean() > 0.5 and (te >= 0).sum() > (to >= 0).sum()
    differ = te != je
    assert differ.mean() <= 0.001, differ.mean()
    if differ.any():
        o, d = (x.numpy()[differ] for x in c["targs"][:2])
        mp = _edge_metric_np(c["ref"], o, d, None, te[differ])
        mj = _edge_metric_np(c["ref"], o, d, None, np.maximum(je[differ], 0))
        assert (mp <= np.where(je[differ] >= 0, mj, np.float32(tsw.BIG_T))).all()


def _padded_pair(sb_cls):
    """One sphere at z = -3 in a scene of capacity 8: seven dead rows at the
    origin (K1 = BIG_T, rinv2 = 1e-30)."""
    b = sb_cls()
    b.add_lambertian((0.0, 0.0, -3.0), 0.5, (0.5, 0.6, 0.4))
    return b.build()


def test_sweep2_edge_adopts_a_dead_row_ahead():
    """A ray whose only row ahead is a dead one (the scene's padding rows sit
    at the origin) adopts it, in the port and in the JAX kernel, whose block
    enters the group through the second ray; a ray with nothing ahead and the
    dead rays get -1; the plain version and, where there is a g++, the kernel
    source agree."""
    ts = _padded_pair(TSceneBuilder)
    js = _padded_pair(JSceneBuilder)
    o = np.array([[0.0, 0.0, -1.0], [0.0, 0.0, 2.0], [0.0, 0.0, 5.0], [0.0, 0.0, -1.0]],
                 np.float32)
    d = np.array([[0.0, 0.0, 1.0], [0.0, 0.0, -1.0], [0.0, 0.0, 1.0], [0.0, 0.0, 0.0]],
                 np.float32)
    tr, tl = np.zeros(4, np.float32), np.full(4, 100.0, np.float32)
    ja = jsw.make_accel2(js, gr=8)
    ta = tsw.make_accel2(ts, gr=8)
    assert ta.perm.tolist() == list(range(8))
    jt, jo, je = (np.asarray(x) for x in jsw.sweep2_nearest_edge(
        ja, *(jnp.asarray(x) for x in (o, d, tr, tl))))
    targs = [torch.from_numpy(x) for x in (o, d, tr, tl)]
    tt, to, te = tsw.sweep2_nearest_edge(ta, *targs)
    assert to.tolist() == [-1, 0, -1, -1] and jo.tolist() == to.tolist()
    assert te.tolist() == [1, 0, -1, -1] and je.tolist() == te.tolist()
    m = float(_edge_metric_np(ta, o[:1], d[:1], None, np.array([1]))[0])
    assert 1e7 < m < 1e9  # (|s|^2 + BIG_T) * 1e-30: finite, below BIG_T
    if shutil.which("g++") is not None:
        with _build.host_rehearsal():
            got = tsw._launch_sweep2(ta, tsw.pack_rays(*targs), False, False,
                                     with_edge=True)
        assert all(torch.equal(a, b) for a, b in zip(got, (tt, to, te)))


@pytest.mark.parametrize("motion", [False, True])
def test_edge_kernel_source_rehearsed_on_the_host(sweep_case, motion):
    """``csrc/sweep2.cu``'s EDGE instantiations (static and motion) compiled as
    host C++: obj and edge equal to the plain version's, t within rtol 2e-4
    and atol 1e-4 (PyTorch's vectorised CPU sqrt lands one ulp off the
    correctly rounded root on some lanes, and the anchored quadratic's root
    is a difference of numbers near 800, whose ulp is 6.1e-5: found 9e-5
    relative on 16 of 4096 rays and 6.1e-5 absolute at t = 0.08, the host
    build matching a float32 numpy recompute), and (t, obj) bit for bit the
    nearest-hit instantiation's, in each schedule."""
    _need_gxx()
    c = sweep_case
    accel, scene = c["ta"], c["ts"]
    o, d, tr, tl = c["targs"]
    if motion:
        dp = torch.zeros_like(scene.delta_position)
        dp[1::3, 0] = 0.3
        scene = scene.replace(delta_position=dp)
        accel = tsw.make_accel2(scene, gr=32)
        tr = torch.from_numpy(np.random.default_rng(2).uniform(0, 1, tr.shape[0])
                              .astype(np.float32))
    assert accel.has_motion == motion
    rays = tsw.pack_rays(o, d, tr, tl)
    want = tsw.sweep2_edge_plain(accel, rays)
    for coop_min in SCHEDULES:
        with _build.host_rehearsal(), _forced(coop_min):
            got = tsw._launch_sweep2(accel, rays, False, False, with_edge=True)
            t0, o0, _ = tsw._launch_sweep2(accel, rays, False, False)
        assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
        np.testing.assert_allclose(got[0].numpy(), want[0].numpy(), rtol=2e-4, atol=1e-4)
        assert torch.equal(got[0], t0) and torch.equal(got[1], o0)
    assert (want[2] >= 0).float().mean() > 0.5
    with pytest.raises(ValueError):
        tsw._launch_sweep2(accel, rays, False, True, with_edge=True)


# ---------------------------------------------------------------------------
# The silhouette instantiation on adversarial rays
# ---------------------------------------------------------------------------
#
# K2's silhouette pass is dense (every row; a per-block cull measured no
# faster on the card, PERF.md), so these are the ray families such a pass
# must survive.  Tolerances: the host build of the EDGE instantiations is held
# to the plain version with torch.equal on obj and edge; its t (the
# nearest-hit sweep's) bit for bit to the nearest-hit instantiation's, and to
# the plain version's within the tolerance of
# ``test_edge_kernel_source_rehearsed_on_the_host`` (rtol 2e-4, atol 1e-4):
# PyTorch's vectorised CPU sqrt is not correctly rounded (found one ulp at
# t = 82 on 1 of 185 static rays, where the host build equals a float32
# numpy recompute with a correctly rounded root; 7.2e-6 relative on a moving
# ray, the ulp through the anchored root's cancellation).


def _adversarial_spheres(moving: bool):
    """Spheres that stress a silhouette pass: the 1000-radius ground, a field
    of small spheres at z in [-12, -3] (every other one moving in
    ``moving``), a 0.45-radius sphere 60 units out, 20 copies of one sphere
    (equal metrics on rows far apart), and 14 dead rows of capacity padding,
    at the world origin where no live centre lies."""
    rng = np.random.default_rng(9)
    b = TSceneBuilder()
    b.add_lambertian((0.0, -1000.0, 0.0), 1000.0, (0.5, 0.5, 0.5))
    for k in range(36):
        dp = (rng.uniform(-0.5, 0.5), 0.0, rng.uniform(-0.5, 0.5)) if moving and k % 2 else None
        b.add_lambertian((rng.uniform(-6.0, 6.0), rng.uniform(0.2, 1.0), rng.uniform(-12.0, -3.0)),
                         rng.uniform(0.1, 0.4), (0.4, 0.5, 0.6),
                         **({"delta_position": dp} if dp else {}))
    b.add_lambertian((60.0, 0.45, -60.0), 0.45, (0.9, 0.2, 0.2))
    for _ in range(20):
        b.add_lambertian((10.0, 0.5, -7.0), 0.3, (0.2, 0.9, 0.2))
    return b.build(capacity=72)


def _unit(v):
    v = np.asarray(v, np.float64)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def _adversarial_rays(balls, seed):
    """Ray families that a silhouette pass could get wrong -> ({family:
    slice}, o, d), float32.  ``balls``: (centre, radius) pairs that the
    grazing family's lines touch."""
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
                    rng.uniform(-2, 2, 32)], axis=1)  # just above the ground
    add("over_the_ground", low, _unit(np.stack([rng.normal(size=32), rng.uniform(-0.05, 0.05, 32),
                                                -np.abs(rng.normal(size=32))], axis=1)))
    near = rng.uniform(-2, 2, (24, 3)) + np.array([0.0, 1.0, 0.0])
    add("to_the_far_one", near, _unit(np.array([60.0, 0.45, -60.0]) + rng.uniform(-1, 1, (24, 3))
                                      - near))
    oo, dd = [], []
    for c, r in balls:  # lines at exactly the radius from the centre
        u = _unit(rng.normal(size=3))
        n = _unit(np.cross(u, rng.normal(size=3)))
        oo.append(np.asarray(c) + r * n - 15.0 * u)
        dd.append(u)
    add("grazing_balls", oo, dd)
    dup = np.array([10.0, 0.5, -7.0])
    src = np.array([20.0, 0.5, -7.0]) + rng.uniform(-1, 1, (24, 3))
    add("tied_copies", src, _unit(dup + rng.uniform(-0.08, 0.08, (24, 3)) - src))
    over = np.stack([rng.uniform(-5, 5, 16), np.full(16, 2.0), rng.uniform(-1, 1, 16)], axis=1)
    add("misses", over, _unit(np.stack([rng.uniform(-0.3, 0.3, 16), np.full(16, 0.05),
                                        -np.ones(16)], axis=1)))
    add("nothing_ahead", np.tile([0.0, 50.0, 0.0], (8, 1)) + rng.uniform(-1, 1, (8, 3)),
        np.tile([0.0, 1.0, 0.0], (8, 1)))
    add("dead", rng.uniform(-3, 3, (8, 3)), np.zeros((8, 3)))
    add("padding_ahead_only", np.tile([0.0, -0.5, -1.0], (8, 1)) + rng.uniform(-0.05, 0.05, (8, 3)),
        np.tile(_unit([0.0, 1.0, 1.0]), (8, 1)))
    return fam, np.stack(o), np.stack(d)


@pytest.mark.parametrize("motion", [False, True])
def test_edge_cull_rehearsed_on_adversarial_rays(motion):
    """The host build of the EDGE instantiation (static and moving) against
    the plain version (obj and edge torch.equal, t as the section's note
    says), on ray families that a silhouette pass could get wrong; each
    family shows what it claims."""
    _need_gxx()
    scene = _adversarial_spheres(motion)
    accel = tsw.make_accel2(scene, gr=16)
    assert accel.has_motion == motion
    n_obj = int(scene.num_valid)
    balls = zip(scene.position[:n_obj].numpy().astype(np.float64),
                scene.scale[:n_obj, 0].numpy().astype(np.float64))
    fam, o, d = _adversarial_rays(balls, 4)
    n = o.shape[0]
    tr = np.random.default_rng(5).uniform(0.0, 1.0, n).astype(np.float32)
    tr[::7], tr[1::7] = 0.0, 1.0
    rays = tsw.pack_rays(*(torch.from_numpy(x) for x in (o, d, tr, np.full(n, 1e4, np.float32))))
    want = tsw.sweep2_edge_plain(accel, rays)
    with _build.host_rehearsal():
        got = tsw._launch_sweep2(accel, rays, False, False, with_edge=True)
        t0, _, _ = tsw._launch_sweep2(accel, rays, False, False)
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
    assert torch.equal(got[0], t0)
    np.testing.assert_allclose(got[0].numpy(), want[0].numpy(), rtol=2e-4, atol=1e-4)
    obj, edge = want[1].numpy(), want[2].numpy()
    dead_row = (accel.otab[:accel.n_pad, tsw.OT_K1] >= tsw.BIG_T).numpy()
    assert (obj[fam["misses"]] == -1).all() and (edge[fam["misses"]] >= 0).all()
    assert (edge[fam["nothing_ahead"]] == -1).all() and (edge[fam["dead"]] == -1).all()
    assert dead_row[edge[fam["padding_ahead_only"]]].all()
    ground = int(np.flatnonzero(accel.perm.numpy() == 0)[0])
    assert (obj[fam["far_origins"]] >= 0).any() and (obj[fam["over_the_ground"]] == ground).any()
    # a tie: the lowest of the copies wins, and the copies lie in several groups
    copies = np.flatnonzero(np.isin(accel.perm.numpy(), np.arange(38, 58)))
    assert (edge[fam["tied_copies"]] == copies.min()).sum() >= 12
    assert len(set(copies // accel.gr)) >= 2
