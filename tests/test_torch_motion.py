"""Motion blur through the sphere tables, the sphere sweep, the persistent
kernel and both renderers, against the JAX package.

An object's centre at a ray's time is ``c - omt * dp`` with ``omt = 1 -
time_ratio`` and ``time_ratio = s / spp`` of the lane's sample.  On the CPU the
port runs the plain versions; the JAX side runs its Pallas kernels in
interpret mode.

Tolerances:
  - ``make_accel2(has_motion=True)``: ``perm``, group AABBs (motion-swept) and
    anchors equal; table entries, the motion columns ``dp``, ``K2 = 2 c.dp``
    (c relative to the group anchor) and ``K3 = |dp|^2`` included, rtol 1e-6
    (K1 of a 100-radius sphere atol 1e-3).  A static scene keeps the 8-float
    object row.
  - sweep at random ``time_ratio``: same winner on >= 99.9 % of rays, refined t
    rtol 1e-4 where the winner agrees (2e-3 on the 100-radius ground sphere),
    material fields and surrounding RI equal, normals within 1e-3.
  - the queue renderer and ``render_uber`` on ``motion_blur_scene`` against
    JAX's at 48x32x8 depth 5: the persistent kernel's envelope (image means
    within 5e-3, under 3 % of pixels beyond 0.05, under 1 % of depth pixels
    beyond 1e-2, ray counts within 2 %).  Found: the queue renderers agree on
    every pixel to the oracle bar and on the ray count.
  - a moving generic scene (rotated box and ellipsoid in motion) through
    ``render_uber`` against the port's queue renderer, grouped and dense: the
    same envelope.
  - where there is a g++, the ``MOTION`` instantiations of ``csrc/sweep2.cu``
    and ``csrc/uber.cu`` (sphere and generic) compiled as host C++ against
    their plain versions.
"""

import contextlib
import dataclasses
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from raytracing_tests_tpu.kernels import sweep2 as jsw
from raytracing_tests_tpu.kernels.uber import render_uber as j_render_uber
from raytracing_tests_tpu.ops.render import RenderConfig as JRenderConfig
from raytracing_tests_tpu.ops.render import render_stats as j_render_stats
from raytracing_tests_tpu.scene import examples as jex
from raytracing_tests_tpu_torch import convert
from raytracing_tests_tpu_torch.kernels import _build
from raytracing_tests_tpu_torch.kernels import sweep2 as tsw
from raytracing_tests_tpu_torch.kernels import uber as tub
from raytracing_tests_tpu_torch.kernels.uber import render_uber
from raytracing_tests_tpu_torch.models import get_workload
from raytracing_tests_tpu_torch.ops.render import RenderConfig, render_stats
from raytracing_tests_tpu_torch.scene import examples as tex

torch.set_num_threads(2)

FRAME = dict(width=48, height=32, spp=8, max_bounces=5, intersector="pallas")


def _moving_iow(ex, mod):
    """``iow_final_scene(side=5)`` with a seeded motion delta on every third
    object (the ground sphere stays)."""
    scene, cam = ex.iow_final_scene(side=5)
    n = scene.position.shape[0]
    rng = np.random.default_rng(11)
    dp = rng.uniform(-0.25, 0.25, (n, 3)).astype(np.float32)
    dp[np.arange(n) % 3 != 1] = 0.0
    return scene.replace(delta_position=mod.asarray(dp)), cam


BUILDS = {
    # name -> (scene factory (examples, array module), gr, sorted)
    "motion_blur": (lambda ex, mod: ex.motion_blur_scene(), 8, True),
    "motion_blur_default": (lambda ex, mod: ex.motion_blur_scene(), 128, False),
    "moving_iow5": (_moving_iow, 32, True),
}


class _Torch:
    asarray = staticmethod(torch.from_numpy)


def _jax_ftab(accel):
    return sum(np.asarray(x.astype(jnp.float32)) for x in accel.ftab3)


def _build_both(name):
    factory, gr, sort = BUILDS[name]
    js, jc = factory(jex, jnp)
    ts, tc = factory(tex, _Torch)
    jcfg = JRenderConfig().for_scene(js)
    tcfg = RenderConfig().for_scene(ts)
    assert jcfg.has_motion and tcfg.has_motion and jcfg.probe_rows == tcfg.probe_rows
    kw = lambda cfg, cam: dict(gr=gr, has_motion=True, probe_rows=cfg.probe_rows,
                               sort_origin=cam.position if sort else None)
    ja = jsw.make_accel2(js, **kw(jcfg, jc))
    ta = tsw.make_accel2(ts, **kw(tcfg, tc))
    ref = convert.accel2_from_numpy(np.asarray(ja.otab), _jax_ftab(ja), np.asarray(ja.gaabb),
                                    np.asarray(ja.perm), ja.gr, has_motion=True)
    return js, ja, ts, ta, ref


@pytest.mark.parametrize("name", list(BUILDS))
def test_make_accel2_with_motion_matches_jax(name):
    js, ja, ts, ta, ref = _build_both(name)
    assert ta.has_motion and ta.ot_cols == tsw.OT_COLS_MOTION == ta.otab.shape[1]
    np.testing.assert_array_equal(ta.perm.numpy(), np.asarray(ja.perm))
    assert ta.n_pgroups == ja.n_pgroups and ta.gr == ja.gr
    np.testing.assert_array_equal(ta.gaabb.numpy(), ref.gaabb.numpy())
    k1 = tsw.OT_K1
    cols = [c for c in range(tsw.OT_COLS_MOTION) if c != k1]
    np.testing.assert_allclose(ta.otab[:, cols].numpy(), ref.otab[:, cols].numpy(),
                               rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(ta.otab[:, k1].numpy(), ref.otab[:, k1].numpy(),
                               rtol=1e-6, atol=1e-3)
    np.testing.assert_allclose(ta.ftab.numpy(), ref.ftab.numpy(), rtol=1e-6, atol=0)
    moving = ta.otab[:ta.n_pad, tsw.OT_DPX:tsw.OT_DPZ + 1].abs().sum(dim=1) > 0
    assert moving.any() and (ta.otab[:ta.n_pad, tsw.OT_K3][moving] > 0).all()
    # the AABBs are swept: a moving row's group box holds both end positions
    lo, hi = ts.world_aabbs()
    swept = (hi - lo)[:, 0] - 2 * ts.scale[:, 0]
    assert (swept[ts.delta_position[:, 0].abs() > 0] > 0).all()


def test_static_accels_keep_the_short_row():
    ts, _ = tex.motion_blur_scene()
    still = ts.replace(delta_position=torch.zeros_like(ts.delta_position))
    a = tsw.make_accel2(still, gr=8)
    assert not a.has_motion and a.otab.shape[1] == tsw.OT_COLS == a.ot_cols
    # has_motion=False on a moving scene: the short row, motion ignored
    b = tsw.make_accel2(ts, gr=8, has_motion=False)
    assert not b.has_motion and b.otab.shape[1] == tsw.OT_COLS
    assert tsw.make_accel2(ts, gr=8).has_motion  # None asks the scene
    m = tsw.make_accel2(ts, gr=8)
    src = np.zeros((m.otab.shape[0], 128), np.float32)
    src[:, 8:11] = 1.0  # motion in the tables, none asked for
    with pytest.raises(ValueError, match="has_motion"):
        convert.accel2_from_numpy(src, np.zeros((24, m.n_pad), np.float32),
                                  np.zeros((m.gaabb.shape[0], 128), np.float32),
                                  m.perm.numpy(), 8)


def test_make_accel2_refuses_nothing_but_needs_omt():
    """The plain sweep of a moving accel needs each ray's ``omt``."""
    ts, _ = tex.motion_blur_scene()
    accel = tsw.make_accel2(ts, gr=8)
    o = torch.zeros(4, 3)
    d = torch.tensor([[0.0, 0.0, -1.0]]).expand(4, 3)
    with pytest.raises(ValueError):
        tsw._sweep_plain(accel, o, d, torch.ones(4, dtype=torch.bool), torch.full((4,), 1e4))


def _rays(seed, n):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-2.5, 2.5, (n, 3)).astype(np.float32)
    o[:, 1] = np.abs(o[:, 1]) * 0.5 + 0.05
    o[:, 2] -= 2.0
    target = np.array([0.0, 0.1, -3.2], np.float32) + rng.normal(size=(n, 3)).astype(np.float32)
    d = target - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d[:16] = 0.0  # dead rays
    tr = rng.uniform(0.0, 1.0, n).astype(np.float32)
    return o, d.astype(np.float32), tr, np.full(n, 32000.0, np.float32)


@pytest.fixture(scope="module")
def sweep_case():
    js, ja, ts, ta, ref = _build_both("motion_blur")
    args = _rays(5, 4096)
    return dict(ja=ja, ta=ta, ref=ref, ts=ts, jargs=[jnp.asarray(x) for x in args],
                targs=[torch.from_numpy(x) for x in args])


@pytest.mark.parametrize("which", ["jax_accel", "own_accel"])
def test_sweep2_with_motion_matches_jax(sweep_case, which):
    c = sweep_case
    jt, jo, jr = jsw.sweep2_full(c["ja"], *c["jargs"], with_ri=True)
    accel = c["ref"] if which == "jax_accel" else c["ta"]
    tt, to, tr = tsw.sweep2_full(accel, *c["targs"], with_ri=True)
    jt, jo, jr = np.asarray(jt), np.asarray(jo), np.asarray(jr)
    tt, to, tr = tt.numpy(), to.numpy(), tr.numpy()
    assert (to[:16] == -1).all() and (jo[:16] == -1).all()
    same = jo == to
    assert same.mean() >= 0.999, same.mean()
    m = same & (jo >= 0)
    perm = np.asarray(c["ja"].perm)
    ground = perm[np.maximum(jo, 0)] == 0
    moving = np.isin(perm[np.maximum(jo, 0)], [1, 2])
    assert (m & moving).mean() > 0.1 and (m & ground).mean() > 0.1
    np.testing.assert_allclose(tt[m & ~ground], jt[m & ~ground], rtol=1e-4, atol=0)
    np.testing.assert_allclose(tt[m & ground], jt[m & ground], rtol=2e-3, atol=0)
    np.testing.assert_array_equal(tr[5:, m], jr[5:, m])
    np.testing.assert_array_equal(tr[tsw.V_RI, m], jr[jsw.V_RI, m])
    nerr = np.abs(tr[2:5, m] - jr[2:5, m]).max(axis=0)
    assert nerr.max() <= 1e-3, nerr.max()
    # the nearest-only sweep names the same winners
    nt, no = tsw.sweep2_nearest(accel, *c["targs"])
    assert (no.numpy() == to).all()


def test_the_sweep_sees_the_object_where_it_is_at_the_rays_time(sweep_case):
    """A ray aimed at the red sphere's end position (time_ratio = 1) hits it
    there and misses it at time_ratio = 0, where it sits 0.35 lower; the
    brute intersector agrees."""
    from raytracing_tests_tpu_torch.ops.intersect import intersect_brute

    c = sweep_case
    o = torch.tensor([[-0.6, 0.45, 0.0]] * 2)
    d = torch.tensor([[0.0, 0.0, -1.0]] * 2)
    tr = torch.tensor([1.0, 0.0])
    tl = torch.full((2,), 100.0)
    t, obj = tsw.sweep2_nearest(c["ta"], o, d, tr, tl)
    hb = intersect_brute(c["ts"], o, d, tr, tl)
    orig = torch.where(obj >= 0, c["ta"].perm[obj.clamp_min(0).long()], -1)
    assert orig.tolist()[0] == 1 and orig.tolist()[1] != 1
    assert hb.hit.tolist()[0] and int(hb.obj[0]) == 1
    np.testing.assert_allclose(float(t[0]), float(hb.t[0]), rtol=1e-5)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_envelope(a, b, ray_tol=0.02):
    ia, ib = _np(a["image"]), _np(b["image"])
    assert ia.shape == ib.shape and np.isfinite(ia).all()
    found = dict(
        mean_diff=abs(float(ia.mean()) - float(ib.mean())),
        frac_pixels=float((np.abs(ia - ib).max(axis=-1) > 0.05).mean()),
        frac_depth=float((np.abs(_np(a["depth"]) - _np(b["depth"])) > 1e-2).mean()),
        ray_diff=abs(int(a["rays"]) - int(b["rays"])) / int(b["rays"]),
    )
    assert found["mean_diff"] < 5e-3, found
    assert found["frac_pixels"] < 0.03, found
    assert found["frac_depth"] < 0.01, found
    assert found["ray_diff"] < ray_tol, found
    return found


@pytest.fixture(scope="module")
def frames():
    js, jc = jex.motion_blur_scene()
    ts, tc = tex.motion_blur_scene()
    jcfg = JRenderConfig(**FRAME).for_scene(js)
    tcfg = RenderConfig(**FRAME).for_scene(ts)
    assert jcfg.has_motion and tcfg.has_motion and tcfg.pallas_mode == "spheres"
    return dict(js=js, jc=jc, jcfg=jcfg, ts=ts, tc=tc, tcfg=tcfg,
                queue=render_stats(ts, tc, tcfg, device="cpu"),
                uber=render_uber(ts, tc, tcfg, device="cpu"))


def test_queue_renderer_with_motion_matches_jax(frames):
    f = frames
    oj = jax.jit(lambda s, c: j_render_stats(s, c, f["jcfg"]))(f["js"], f["jc"])
    _assert_envelope(f["queue"], oj, ray_tol=5e-3)
    ok = np.isclose(f["queue"]["image"].numpy(), np.asarray(oj["image"]),
                    atol=2e-4, rtol=1e-3).all(axis=-1)
    assert ok.mean() >= 0.995, ok.mean()
    assert f["queue"]["rays_dropped"] == 0
    # the blur is in the picture: a still scene renders another image
    still = f["ts"].replace(delta_position=torch.zeros_like(f["ts"].delta_position))
    o_still = render_stats(still, f["tc"], RenderConfig(**FRAME).for_scene(still), device="cpu")
    assert (o_still["image"] - f["queue"]["image"]).abs().amax(dim=-1).gt(0.05).float().mean() > 0.01


def test_uber_with_motion_matches_jax_uber(frames):
    f = frames
    oj = j_render_uber(f["js"], f["jc"], f["jcfg"], L=256, R=8)
    _assert_envelope(f["uber"], oj)
    assert int(f["uber"]["rays_dropped"]) == int(oj["rays_dropped"]) == 0


def test_uber_with_motion_matches_the_ports_queue_renderer(frames):
    f = frames
    _assert_envelope(f["uber"], f["queue"], ray_tol=5e-3)
    accel, _ = tub._scene_accel(f["ts"], f["tc"], f["tcfg"], 8)
    assert accel.has_motion and tub.launch_name(accel) == "uber_m"


def _moving_generic():
    scene, cam = tex.groups_scene()
    dp = torch.zeros_like(scene.delta_position)
    dp[1] = torch.tensor([0.3, 0.0, 0.0])  # the sphere
    dp[2] = torch.tensor([0.0, 0.25, 0.1])  # the rotated ellipsoid
    dp[3] = torch.tensor([-0.2, 0.0, 0.0])  # the rotated box
    scene = scene.replace(delta_position=dp)
    cfg = RenderConfig(**FRAME).for_scene(scene)
    assert cfg.pallas_mode == "generic" and cfg.has_motion
    return scene, cam, cfg


@pytest.mark.parametrize("groups", [32, 0])
def test_uber_generic_with_motion_matches_the_ports_queue_renderer(groups):
    scene, cam, cfg = _moving_generic()
    ou = render_uber(scene, cam, cfg, gr=16, device="cpu")
    oq = render_stats(scene, cam, dataclasses.replace(cfg, pallas_groups=groups), device="cpu")
    ob = render_stats(scene, cam, dataclasses.replace(cfg, intersector="brute"), device="cpu")
    _assert_envelope(ou, oq, ray_tol=5e-3)
    _assert_envelope(ou, ob, ray_tol=5e-3)
    accel, _ = tub._scene_accel(scene, cam, cfg, 16)
    assert accel.mode == "generic" and accel.has_motion
    assert tub.launch_name(accel) == "uber_g_m"


def test_motion_blur_workload_is_registered():
    out = get_workload("motion-blur").run(device="cpu", width=24, height=16, spp=4)
    assert out["cfg"].has_motion and out["cfg"].max_bounces == 5
    assert tuple(out["image"].shape) == (16, 24, 3) and torch.isfinite(out["image"]).all()


def _need_gxx():
    if shutil.which("g++") is None:
        pytest.skip("no g++ to rehearse the kernel source with")


def test_sweep_kernel_motion_instantiation_rehearsed_on_the_host(sweep_case):
    """``csrc/sweep2.cu``'s MOTION instantiation as host C++ against the plain
    version: winners equal, hit block within 1e-5 on >= 99.9 % of rays."""
    _need_gxx()
    c = sweep_case
    rays = tsw.pack_rays(*c["targs"])
    want = tsw.sweep2_plain(c["ta"], rays, True, True)
    with _build.host_rehearsal():
        got = tsw._launch_sweep2(c["ta"], rays, True, True)
    assert torch.equal(got[1], want[1])
    ok = ((got[2] - want[2]).abs() <= 1e-5 + 1e-5 * want[2].abs()).all(dim=0)
    assert ok.float().mean() >= 0.999, float(ok.float().mean())
    with pytest.raises(RuntimeError):
        tsw._launch_sweep2(c["ta"], rays, True, True)  # CPU tensors outside the rehearsal


@pytest.mark.parametrize("coop_min", [1, 33])
def test_sweep_kernel_motion_instantiation_rehearsed_on_the_host_in_each_schedule(
        sweep_case, coop_min):
    """... in each forced sweep schedule: the bars above, and the default
    schedule's output and counters bit for bit."""
    _need_gxx()
    c = sweep_case
    rays = tsw.pack_rays(*c["targs"])
    want = tsw.sweep2_plain(c["ta"], rays, True, True)
    runs = {}
    for cm in (None, coop_min):
        stats = torch.zeros(tsw.SW_LEN, dtype=torch.int64)
        forced = _build.forced_coop_min(cm) if cm else contextlib.nullcontext()
        with _build.host_rehearsal(), forced:
            runs[cm] = tsw._launch_sweep2(c["ta"], rays, True, True, stats), stats
    (got, stats), (base, stats_base) = runs[coop_min], runs[None]
    assert torch.equal(got[1], want[1])
    ok = ((got[2] - want[2]).abs() <= 1e-5 + 1e-5 * want[2].abs()).all(dim=0)
    assert ok.float().mean() >= 0.999, float(ok.float().mean())
    assert all(torch.equal(a, b) for a, b in zip(got, base))
    same = [tsw.SW_TESTS, tsw.SW_ROW_TESTS]
    assert torch.equal(stats[same], stats_base[same])
    assert (int(stats[tsw.SW_COOP_VISITS]) > 0) == (coop_min > 1)


@pytest.mark.parametrize("mode", ["spheres", "generic"])
def test_uber_kernel_motion_instantiations_rehearsed_on_the_host(frames, mode):
    """``csrc/uber.cu``'s MOTION instantiations as host C++ against the plain
    version: equal ray and drop counts, primary t rtol 1e-5, colours within
    1e-4 on >= 99.9 % of the samples."""
    _need_gxx()
    if mode == "spheres":
        scene, cam_, cfg, gr = frames["ts"], frames["tc"], frames["tcfg"], 8
    else:
        scene, cam_, cfg = _moving_generic()
        gr = 16
    accel, cam = tub._scene_accel(scene, cam_, cfg, gr)
    st = tub.UberStatics.from_cfg(cfg)
    want, stats_p = tub.uber_render_plain(accel, cam, st)
    with _build.host_rehearsal():
        got, stats = tub._launch_uber(accel, cam, st)
    assert int(stats[tub.ST_RAYS]) == int(stats_p[tub.ST_RAYS])
    assert int(stats[tub.ST_DROPPED]) == int(stats_p[tub.ST_DROPPED]) == 0
    np.testing.assert_allclose(got[:, 3].numpy(), want[:, 3].numpy(), rtol=1e-5)
    cerr = (got[:, :3] - want[:, :3]).abs().amax(dim=1)
    assert (cerr <= 1e-4).float().mean() >= 0.999, float((cerr <= 1e-4).float().mean())


@pytest.mark.parametrize("coop_min", [1, 33])
@pytest.mark.parametrize("mode", ["spheres", "generic"])
def test_uber_kernel_motion_instantiations_rehearsed_on_the_host_in_each_schedule(
        frames, mode, coop_min):
    """... in each forced sweep schedule: the bars above, and the default
    schedule's output and counters bit for bit."""
    _need_gxx()
    if mode == "spheres":
        scene, cam_, cfg, gr = frames["ts"], frames["tc"], frames["tcfg"], 8
    else:
        scene, cam_, cfg = _moving_generic()
        gr = 16
    accel, cam = tub._scene_accel(scene, cam_, cfg, gr)
    st = tub.UberStatics.from_cfg(cfg)
    want, stats_p = tub.uber_render_plain(accel, cam, st)
    with _build.host_rehearsal():
        base, stats_base = tub._launch_uber(accel, cam, st)
        with tub._forced_coop_min(coop_min):
            got, stats = tub._launch_uber(accel, cam, st)
    assert int(stats[tub.ST_RAYS]) == int(stats_p[tub.ST_RAYS])
    assert int(stats[tub.ST_DROPPED]) == int(stats_p[tub.ST_DROPPED]) == 0
    np.testing.assert_allclose(got[:, 3].numpy(), want[:, 3].numpy(), rtol=1e-5)
    cerr = (got[:, :3] - want[:, :3]).abs().amax(dim=1)
    assert (cerr <= 1e-4).float().mean() >= 0.999, float((cerr <= 1e-4).float().mean())
    assert torch.equal(got, base)
    same = slice(tub.ST_RAYS, tub.ST_ROW_TESTS + 1)
    assert torch.equal(stats[same], stats_base[same])
    assert (int(stats[tub.ST_COOP_VISITS]) > 0) == (coop_min > 1)
