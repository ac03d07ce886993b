"""The module that holds the persistent path-tracer kernel — and the slice as
a whole — against the JAX package.

On the CPU ``render_uber(..., device="cpu")`` runs the plain PyTorch version
of the kernel; the JAX side runs its Pallas kernel in interpret mode.  Both
generate the camera rays themselves, with roundings that differ in the last
ulp, and the scene amplifies that (see ``test_torch_render``), so the bars are
the statistical envelope of ``tests/test_pallas.py``: image means within 5e-3,
under 3 % of pixels off by more than 0.05, under 1 % of depth pixels off by
more than 1e-2, ray counts within 2 %, zero dropped.  Found against JAX at
48x32x8 depth 5: mean difference 4.2e-4, 1.8 % of pixels, no depth pixel,
ray counts 0.07 % apart.

The generic branch (rotated ellipsoids and cuboids) is held to the same bars
on the three scenes of the JAX package's own generic tests, at 48x32x4: the
5x5 grid of spheres and y-rotated boxes (depth 5, gr=32), the anisotropic
rotated ellipsoids and rolled boxes (depth 6, gr=16) and the glass ellipsoid
between two boxes (depth 6, gr=16); and on a fourth where two glass bodies
overlap, the only one whose probe rows survive the relevance cut, so the only
one that runs the rotated containment probe.  Found on all four, against
JAX and against the port's queue renderer (grouped and dense): equal ray
counts, no pixel off by more than 0.05, no depth pixel, image means within
6e-8: without a 1000-radius sphere nothing amplifies the last ulp.
"""

import dataclasses

import numpy as np
import pytest
import torch


from raytracing_tests_tpu.kernels.uber import pack_camera as j_pack_camera
from raytracing_tests_tpu.kernels.uber import render_uber as j_render_uber
from raytracing_tests_tpu.ops.render import RenderConfig as JRenderConfig
from raytracing_tests_tpu.scene import examples as jex
from raytracing_tests_tpu_torch.kernels import uber as tub
from raytracing_tests_tpu_torch.kernels.uber import render_uber
from raytracing_tests_tpu_torch.ops.megalanes import render_megalanes
from raytracing_tests_tpu_torch.ops.render import RenderConfig, extract_lights, render_stats
from raytracing_tests_tpu_torch.scene import examples as tex
from raytracing_tests_tpu_torch.scene import types as ttypes
from raytracing_tests_tpu.scene import types as jtypes
from test_torch_sweep2g import anisotropic_scene, dielectric_scene, overlapping_glass_scene

torch.set_num_threads(2)

FRAME = dict(width=48, height=32, spp=8, max_bounces=5, intersector="pallas")


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
    js, jc = jex.iow_final_scene(side=5)
    ts, tc = tex.iow_final_scene(side=5)
    jcfg = JRenderConfig(**FRAME).for_scene(js)
    tcfg = RenderConfig(**FRAME).for_scene(ts)
    return dict(js=js, jc=jc, jcfg=jcfg, ts=ts, tc=tc, tcfg=tcfg,
                port=render_uber(ts, tc, tcfg, device="cpu"))


def test_uber_matches_jax_uber_statistically(frames):
    f = frames
    oj = j_render_uber(f["js"], f["jc"], f["jcfg"], L=256, R=8)
    ot = f["port"]
    assert set(("image", "depth", "rays", "rays_dropped")) <= set(ot)
    assert tuple(ot["image"].shape) == (32, 48, 3) and tuple(ot["depth"].shape) == (32, 48)
    _assert_envelope(ot, oj)
    assert int(ot["rays_dropped"]) == int(oj["rays_dropped"]) == 0


def test_uber_matches_the_ports_queue_renderer(frames):
    f = frames
    oq = render_stats(f["ts"], f["tc"], f["tcfg"], device="cpu")
    _assert_envelope(f["port"], oq)
    assert int(f["port"]["rays_dropped"]) == 0 and oq["rays_dropped"] == 0


def test_uber_odd_frame_and_drop_accounting(frames):
    """(a) a frame whose primary count (50*30*3) is no multiple of anything
    convenient; (b) a deliberately undersized ray stack must surface honest
    ``rays_dropped`` (never silently diverge), at JAX's rate."""
    f = frames
    cfg = RenderConfig(width=50, height=30, spp=3, max_bounces=4,
                       intersector="pallas").for_scene(f["ts"])
    ou = render_uber(f["ts"], f["tc"], cfg, gr=64, device="cpu")
    oq = render_stats(f["ts"], f["tc"], cfg, device="cpu")
    iu, iq = ou["image"].numpy(), oq["image"].numpy()
    assert (np.abs(iu - iq).max(axis=-1) > 0.05).mean() < 0.03
    assert abs(int(ou["rays"]) - oq["rays"]) / oq["rays"] < 0.005
    assert int(ou["rays_dropped"]) == 0

    o1 = render_uber(f["ts"], f["tc"], f["tcfg"], qcap=1, device="cpu")
    j1 = j_render_uber(f["js"], f["jc"], f["jcfg"], L=256, R=8, qcap=1)
    dt, dj = int(o1["rays_dropped"]), int(j1["rays_dropped"])
    assert dt > 0 and dj > 0  # overflow is visible, not silent
    assert abs(dt - dj) <= max(3, 0.1 * dj), (dt, dj)
    assert torch.isfinite(o1["image"]).all()
    _assert_envelope(o1, j1)


def test_pops_budget_kills_the_tree(frames):
    f = frames
    cfg = dataclasses.replace(f["tcfg"], max_pops=2)
    ou = render_uber(f["ts"], f["tc"], cfg, device="cpu")
    oq = render_stats(f["ts"], f["tc"], cfg, device="cpu")
    B = cfg.width * cfg.height * cfg.spp
    assert B < int(ou["rays"]) <= 2 * B
    assert abs(int(ou["rays"]) - oq["rays"]) / oq["rays"] < 0.005
    _assert_envelope(ou, oq)


def test_plain_version_in_ranges_equals_one_batch(frames, monkeypatch):
    """The plain version walks a large frame in ranges of primaries; trees are
    independent, so the ranges change nothing (48*32*8 = 12 288 primaries in
    ranges of 5000 leave a ragged last one)."""
    f = frames
    accel, cam = tub._scene_accel(f["ts"], f["tc"], f["tcfg"], 32)
    st = tub.UberStatics.from_cfg(f["tcfg"])
    whole, stats = tub.uber_render_plain(accel, cam, st)
    monkeypatch.setattr(tub, "_PLAIN_CHUNK", 5000)
    parts, stats_p = tub.uber_render_plain(accel, cam, st)
    assert tuple(parts.shape) == (st.B, 4)
    assert torch.equal(parts, whole) and torch.equal(stats_p, stats)
    assert int(stats[tub.ST_RAYS]) == int(f["port"]["rays"])


def test_pack_camera_matches_jax(frames):
    f = frames
    np.testing.assert_allclose(tub.pack_camera(f["tc"]).numpy(),
                               np.asarray(j_pack_camera(f["jc"]))[0],
                               rtol=1e-6, atol=1e-7)
    shard = tub.pack_camera(f["tc"], row_stride=4.0, row0=3.0)
    assert shard[tub.CAM_STRIDE] == 4.0 and shard[tub.CAM_ROW0] == 3.0


def test_plain_raygen_matches_primary_rays(frames):
    from raytracing_tests_tpu_torch.ops.camera_rays import primary_rays

    st = tub.UberStatics.from_cfg(frames["tcfg"])
    p = torch.arange(st.B)
    o, d, sidx, _ = tub._raygen(tub.pack_camera(frames["tc"]), st, p)
    ro, rd, _ = primary_rays(frames["tc"], st.W, st.H, st.spp)
    np.testing.assert_allclose(o.numpy(), ro.reshape(-1, 3).numpy(), atol=5e-6)
    np.testing.assert_allclose(d.numpy(), rd.reshape(-1, 3).numpy(), atol=2e-6)
    assert torch.equal(sidx, (p % st.spp).float())


@pytest.mark.parametrize("what", ["lights", "materials", "textures", "generic", "qcap"])
def test_unsupported_requests_raise(frames, what):
    f = frames
    scene, cam, cfg, kw = f["ts"], f["tc"], f["tcfg"], {}
    err = NotImplementedError
    render = render_uber
    small = dict(width=12, height=8, spp=2)
    if what == "lights":
        # lights render (test_torch_lights); materials shading takes none, as
        # in the JAX package
        scene, cam = tex.lights_scene()
        kw["lights"] = extract_lights(scene)
        cfg = dataclasses.replace(RenderConfig(**FRAME).for_scene(scene), **small)
        lit = render_uber(scene, cam, cfg, device="cpu", **kw)
        assert torch.isfinite(lit["image"]).all() and int(lit["rays_dropped"]) == 0
        cfg, err = dataclasses.replace(cfg, shading="materials"), ValueError
    elif what == "materials":
        # materials shading renders (test_torch_materials); the megalanes
        # drain refuses it, as the JAX package's does
        cfg = dataclasses.replace(cfg, shading="materials", **small)
        mat = render_uber(scene, cam, cfg, device="cpu")
        assert torch.isfinite(mat["image"]).all() and int(mat["rays_dropped"]) == 0
        render = render_megalanes
    elif what == "textures":
        # a textured scene renders (test_torch_texturing); the megalanes drain
        # refuses textures, as the JAX package's does
        scene, cam = tex.texturing_scene(tex_size=8)
        cfg = dataclasses.replace(RenderConfig(**FRAME).for_scene(scene), **small)
        tx = render_uber(scene, cam, cfg, device="cpu")
        assert torch.isfinite(tx["image"]).all() and int(tx["rays_dropped"]) == 0
        render = render_megalanes
    elif what == "generic":
        # a generic scene renders, and a moving one too (the motion
        # instantiation, held in test_torch_motion); what stays refused on a
        # generic scene is a camera the kernel does not generate rays for
        scene, cam = tex.groups_scene()
        dp = torch.zeros_like(scene.delta_position)
        dp[0, 0] = 0.1
        scene = scene.replace(delta_position=dp)
        cfg = dataclasses.replace(RenderConfig(**FRAME).for_scene(scene), width=12, height=8,
                                  spp=2)
        assert cfg.pallas_mode == "generic" and cfg.has_motion
        moving = render_uber(scene, cam, cfg, device="cpu")
        assert torch.isfinite(moving["image"]).all() and int(moving["rays_dropped"]) == 0
        # and with the aa_grid camera (test_torch_texturing holds the camera
        # variants); the megalanes drain refuses a generic scene, as the JAX
        # package's does
        cfg = dataclasses.replace(cfg, aa_grid=True)
        jit = render_uber(scene, cam, cfg, device="cpu")
        assert torch.isfinite(jit["image"]).all() and int(jit["rays_dropped"]) == 0
        render, err = render_megalanes, ValueError
    else:
        # any stack depth renders (test_queue_capacity_16_matches_the_queue_
        # renderer); a negative one raises
        deep = render_uber(scene, cam, dataclasses.replace(cfg, **small), qcap=16, device="cpu")
        assert torch.isfinite(deep["image"]).all() and int(deep["rays_dropped"]) == 0
        kw["qcap"], err = -1, ValueError
    with pytest.raises(err):
        render(scene, cam, cfg, device="cpu", **kw)


# name -> (scene factory (examples, types), gr, max_bounces)
GENERIC = {
    "bvh5": (lambda ex, ty: ex.bvh_grid_scene(side=5), 32, 5),
    "anisotropic": (lambda ex, ty: anisotropic_scene(ty), 16, 6),
    "dielectric": (lambda ex, ty: dielectric_scene(ty), 16, 6),
    "overlapping_glass": (lambda ex, ty: overlapping_glass_scene(ty), 16, 6),
}


@pytest.fixture(scope="module", params=list(GENERIC))
def generic_frames(request):
    factory, gr, depth = GENERIC[request.param]
    js, jc = factory(jex, jtypes)
    ts, tc = factory(tex, ttypes)
    frame = dict(width=48, height=32, spp=4, max_bounces=depth, intersector="pallas")
    jcfg = JRenderConfig(**frame).for_scene(js)
    tcfg = RenderConfig(**frame).for_scene(ts)
    assert tcfg.pallas_mode == jcfg.pallas_mode == "generic"
    assert tcfg.has_dielectrics == jcfg.has_dielectrics
    return dict(name=request.param, js=js, jc=jc, jcfg=jcfg, ts=ts, tc=tc, tcfg=tcfg, gr=gr,
                port=render_uber(ts, tc, tcfg, gr=gr, device="cpu"))


def test_uber_generic_matches_jax_uber_statistically(generic_frames):
    f = generic_frames
    oj = j_render_uber(f["js"], f["jc"], f["jcfg"], L=256, R=8, gr=f["gr"])
    ot = f["port"]
    assert tuple(ot["image"].shape) == (32, 48, 3) and torch.isfinite(ot["image"]).all()
    _assert_envelope(ot, oj)
    assert int(ot["rays_dropped"]) == int(oj["rays_dropped"]) == 0


@pytest.mark.parametrize("groups", [32, 0])
def test_uber_generic_matches_the_ports_queue_renderer(generic_frames, groups):
    """... through the grouped first-generation sweep (32) and the dense one (0)."""
    f = generic_frames
    cfg = dataclasses.replace(f["tcfg"], pallas_groups=groups)
    oq = render_stats(f["ts"], f["tc"], cfg, device="cpu")
    _assert_envelope(f["port"], oq)
    assert int(f["port"]["rays_dropped"]) == 0 and oq["rays_dropped"] == 0


def test_uber_generic_plain_version_counts_its_work(generic_frames):
    """The generic branch of the plain version fills the frame counters the
    kernel fills: rays, drops; and the accel it is given is the generic one."""
    f = generic_frames
    accel, cam = tub._scene_accel(f["ts"], f["tc"], f["tcfg"], f["gr"])
    assert accel.mode == "generic" and not accel.has_motion
    assert (accel.n_pgroups > 0) == (f["name"] == "overlapping_glass")
    st = tub.UberStatics.from_cfg(f["tcfg"])
    out, stats = tub.uber_render_plain(accel, cam, st)
    assert tuple(out.shape) == (st.B, 4) and tuple(stats.shape) == (tub.ST_LEN,)
    assert int(stats[tub.ST_RAYS]) == int(f["port"]["rays"])
    assert int(stats[tub.ST_DROPPED]) == 0


def _rehearse_on_the_host(scene, cam_, cfg, gr, coop_min=None):
    """The CUDA source of the persistent kernel, compiled as host C++, and
    the plain version on the same frame -> (got, stats, want, stats_plain).
    ``coop_min`` forces the kernel's sweep schedule (1: per lane, 33:
    row-parallel); the host's warp is one lane (``RT_WARP_LANES``)."""
    import contextlib
    import shutil

    from raytracing_tests_tpu_torch.kernels import _build

    if shutil.which("g++") is None:
        pytest.skip("no g++ to rehearse the kernel source with")
    accel, cam = tub._scene_accel(scene, cam_, cfg, gr)
    st = tub.UberStatics.from_cfg(cfg)
    want, stats_p = tub.uber_render_plain(accel, cam, st)
    forced = contextlib.nullcontext() if coop_min is None else tub._forced_coop_min(coop_min)
    with _build.host_rehearsal(), forced:
        got, stats = tub._launch_uber(accel, cam, st)
    return got, stats, want, stats_p


# The counters every sweep schedule must give alike (the last three measure the
# schedule itself).
SAME_IN_EVERY_SCHEDULE = slice(tub.ST_RAYS, tub.ST_ROW_TESTS + 1)


def _assert_schedule_is_exact(got, stats, base, stats_base, coop_min):
    """A forced schedule against the default one on the host: the same
    output bit for bit and the same counters; on a one-lane warp every lane
    slot holds a row test; row-parallel visits only where forced."""
    assert torch.equal(got, base)
    assert torch.equal(stats[SAME_IN_EVERY_SCHEDULE], stats_base[SAME_IN_EVERY_SCHEDULE])
    assert int(stats[tub.ST_ROW_TESTS]) == int(stats[tub.ST_LANE_SLOTS]) > 0
    assert (int(stats[tub.ST_COOP_VISITS]) > 0) == (coop_min > 1)


def test_generic_kernel_source_rehearsed_on_the_host(generic_frames):
    """Where there is a g++, the generic instantiation against the plain
    version: the same ray and drop counts, primary t within rtol 1e-5, colours
    within 1e-4 on >= 99.9 % of the samples (rsqrt, cos and sin are the C
    library's there and PyTorch's here, an ulp apart on some arguments).
    Found on all four scenes: equal counts, every colour within 4.8e-7."""
    f = generic_frames
    got, stats, want, stats_p = _rehearse_on_the_host(f["ts"], f["tc"], f["tcfg"], f["gr"])
    assert int(stats[tub.ST_RAYS]) == int(stats_p[tub.ST_RAYS])
    assert int(stats[tub.ST_DROPPED]) == int(stats_p[tub.ST_DROPPED]) == 0
    assert int(stats[tub.ST_HITS]) > 0 and int(stats[tub.ST_SLAB_TESTS]) > 0
    np.testing.assert_allclose(got[:, 3].numpy(), want[:, 3].numpy(), rtol=1e-5)
    cerr = (got[:, :3] - want[:, :3]).abs().amax(dim=1)
    assert (cerr <= 1e-4).float().mean() >= 0.999, float((cerr <= 1e-4).float().mean())


def test_sphere_kernel_source_rehearsed_on_the_host(frames):
    """... and the sphere instantiation, on the scene that amplifies the last
    ulp: ray counts within 0.5 %, zero dropped, primary t within rtol 1e-4 and
    colours within 1e-4 on >= 95 % of the samples.  Found: 28 041 rays on
    both sides and every sample inside both bars."""
    f = frames
    got, stats, want, stats_p = _rehearse_on_the_host(f["ts"], f["tc"], f["tcfg"], 32)
    rays, rays_p = int(stats[tub.ST_RAYS]), int(stats_p[tub.ST_RAYS])
    assert abs(rays - rays_p) / rays_p < 5e-3 and int(stats[tub.ST_DROPPED]) == 0
    terr = (got[:, 3] - want[:, 3]).abs() <= 1e-4 * want[:, 3]
    cerr = (got[:, :3] - want[:, :3]).abs().amax(dim=1) <= 1e-4
    assert terr.float().mean() >= 0.95 and cerr.float().mean() >= 0.95, (
        float(terr.float().mean()), float(cerr.float().mean()))


@pytest.mark.parametrize("coop_min", [1, 33])
def test_generic_kernel_source_rehearsed_on_the_host_in_each_schedule(generic_frames, coop_min):
    """Each forced sweep schedule of the generic instantiation, by the bars
    of ``test_generic_kernel_source_rehearsed_on_the_host``, and equal to the
    default schedule bit for bit."""
    f = generic_frames
    got, stats, want, stats_p = _rehearse_on_the_host(f["ts"], f["tc"], f["tcfg"], f["gr"],
                                                      coop_min)
    assert int(stats[tub.ST_RAYS]) == int(stats_p[tub.ST_RAYS])
    assert int(stats[tub.ST_DROPPED]) == int(stats_p[tub.ST_DROPPED]) == 0
    assert int(stats[tub.ST_HITS]) > 0 and int(stats[tub.ST_SLAB_TESTS]) > 0
    np.testing.assert_allclose(got[:, 3].numpy(), want[:, 3].numpy(), rtol=1e-5)
    cerr = (got[:, :3] - want[:, :3]).abs().amax(dim=1)
    assert (cerr <= 1e-4).float().mean() >= 0.999, float((cerr <= 1e-4).float().mean())
    base, stats_base, _, _ = _rehearse_on_the_host(f["ts"], f["tc"], f["tcfg"], f["gr"])
    _assert_schedule_is_exact(got, stats, base, stats_base, coop_min)


@pytest.mark.parametrize("coop_min", [1, 33])
def test_sphere_kernel_source_rehearsed_on_the_host_in_each_schedule(frames, coop_min):
    """... and of the sphere instantiation, by the bars of
    ``test_sphere_kernel_source_rehearsed_on_the_host``."""
    f = frames
    got, stats, want, stats_p = _rehearse_on_the_host(f["ts"], f["tc"], f["tcfg"], 32, coop_min)
    rays, rays_p = int(stats[tub.ST_RAYS]), int(stats_p[tub.ST_RAYS])
    assert abs(rays - rays_p) / rays_p < 5e-3 and int(stats[tub.ST_DROPPED]) == 0
    terr = (got[:, 3] - want[:, 3]).abs() <= 1e-4 * want[:, 3]
    cerr = (got[:, :3] - want[:, :3]).abs().amax(dim=1) <= 1e-4
    assert terr.float().mean() >= 0.95 and cerr.float().mean() >= 0.95, (
        float(terr.float().mean()), float(cerr.float().mean()))
    base, stats_base, _, _ = _rehearse_on_the_host(f["ts"], f["tc"], f["tcfg"], 32)
    _assert_schedule_is_exact(got, stats, base, stats_base, coop_min)


def _tie_scene(generic):
    """Two identical spheres (or y-rotated boxes) in one group, in two
    colours, seen head on: every hit is a tie."""
    b = ttypes.SceneBuilder()
    for colour in ((0.9, 0.1, 0.1), (0.1, 0.1, 0.9)):
        if generic:
            b.add_box((0.0, 0.0, -3.0), (1.2, 1.2, 1.2), rotation_deg=(0.0, 30.0, 0.0),
                      color=colour)
        else:
            b.add_sphere((0.0, 0.0, -3.0), 0.8, color=colour)
    cam = ttypes.Camera.make((0.0, 0.0, 0.0), (0.0, 0.0, -1.0), fov_y_deg=40.0, focus_dist=3.0)
    return b.build(), cam


@pytest.mark.parametrize("coop_min", [1, 33])
@pytest.mark.parametrize("mode", ["spheres", "generic"])
def test_a_tie_goes_to_the_lower_row_in_each_schedule(mode, coop_min):
    """Every hit sample takes the colour of the object in the lower row, in
    the plain version and in the kernel's source under each schedule."""
    scene, cam_ = _tie_scene(mode == "generic")
    cfg = RenderConfig(width=16, height=12, spp=2, max_bounces=4,
                       intersector="pallas").for_scene(scene)
    assert cfg.pallas_mode == mode
    got, _, want, _ = _rehearse_on_the_host(scene, cam_, cfg, 8, coop_min)
    accel, _ = tub._scene_accel(scene, cam_, cfg, 8)
    rows = [int((accel.perm[:accel.n_pad] == i).nonzero()[0]) for i in range(2)]
    assert rows[0] // 8 == rows[1] // 8  # one group
    winner = scene.color[rows.index(min(rows))]
    for out in (got, want):
        hit = out[:, 3] < cfg.t_max
        assert 0.1 < float(hit.float().mean()) < 0.9
        assert (out[hit, :3] == winner).all()


# name -> example scene; every example through the accel render_uber builds
EXAMPLES = {
    "sphere": lambda: tex.sphere_scene(),
    "groups": lambda: tex.groups_scene(),
    "motion_blur": lambda: tex.motion_blur_scene(),
    "bvh_grid": lambda: tex.bvh_grid_scene(),
    "bvh_grid32": lambda: tex.bvh_grid_scene(side=32),
    "iow_final5": lambda: tex.iow_final_scene(side=5),
    "iow_final": lambda: tex.iow_final_scene(),
}


@pytest.mark.parametrize("name", list(EXAMPLES))
def test_live_row_bounds_match_the_tables(name):
    """The bound the kernel takes per group is the last live row + 1 as the
    tables say (K1 < BIG_T in sphere mode, ``valid`` in generic mode), read
    row by row: every row at or past it is dead, so skipping them changes no
    result."""
    from raytracing_tests_tpu_torch.kernels import sweep2, sweep2g

    scene, cam = EXAMPLES[name]()
    cfg = RenderConfig(intersector="pallas").for_scene(scene)
    gr = min(64, max(8, -(-scene.capacity // 8) * 8))  # as render_uber clamps it
    accel, _ = tub._scene_accel(scene, cam, cfg, gr)
    got = sweep2.live_row_bounds(accel)
    assert got.dtype == torch.int32 and tuple(got.shape) == (accel.n_groups,)
    otab = accel.otab.numpy()
    want = []
    for g in range(accel.n_groups):
        bound = 0
        for r in range(accel.gr):
            row = otab[g * accel.gr + r]
            if accel.mode == "generic":
                live = row[sweep2g.GO_VALID] > 0.0
            else:
                live = row[sweep2.OT_K1] < np.float32(sweep2.BIG_T)
            if live:
                bound = r + 1
        want.append(bound)
    assert got.tolist() == want
    n_live = int(scene.valid.sum())
    assert 0 < sum(want) and n_live <= sum(want) <= accel.n_groups * accel.gr


@pytest.mark.parametrize("coop_min", [None, 1, 33])
def test_coop_min_reaches_the_kernels_parameters(frames, coop_min):
    """``_forced_coop_min`` sets the ``coop_min`` entry of the kernel's
    integer parameters inside its context and nowhere else."""
    import contextlib

    f = frames
    accel, _ = tub._scene_accel(f["ts"], f["tc"], f["tcfg"], 32)
    st = tub.UberStatics.from_cfg(f["tcfg"])
    at = tub._IP.index("coop_min")
    # the wrapper's parameter vector has the kernel's layout (IP_* of uber.cu)
    import re

    from raytracing_tests_tpu_torch.kernels import _build

    enum = re.search(r"enum \{ (IP_W = 0,.*?) \};", (_build.CSRC / "uber.cu").read_text(), re.S)
    names = [n.split("=")[0].strip() for n in re.sub(r"/\*.*?\*/", "", enum.group(1)).split(",")]
    assert names[-1] == "IP_LEN" and len(names) - 1 == len(tub._IP)
    assert names.index("IP_COOP_MIN") == at and names.index("IP_SHADING") == tub._IP.index("shading")
    forced = contextlib.nullcontext() if coop_min is None else tub._forced_coop_min(coop_min)
    with forced:
        ip, _ = tub._host_params(accel, st)
    assert ip[at] == (tub.COOP_MIN["spheres"] if coop_min is None else coop_min)
    assert tub._host_params(accel, st)[0][at] == tub.COOP_MIN["spheres"]
