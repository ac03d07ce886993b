"""The chunked megakernel ``mega_step`` against the JAX package.

On the CPU the port's ``mega_step`` runs its plain PyTorch version; the JAX
side runs its Pallas kernel in interpret mode (``block=512``).  Both take the
same pool of 2048 lane records, made here with numpy, on the JAX package's own
accel re-laid into the port's tables.

Pools: the camera lanes of ``iow_final_scene(side=5)`` at 32x16x4 with 64
lanes switched off (``lane = -1``) and 32 active lanes carrying a dead ray
(``d = 0``); their children (the second generation, where lanes that spawned
nothing are inactive); three generations on a scene of nested and overlapping
glass spheres, whose later generations start inside glass; and the camera
lanes and children of ``motion_blur_scene`` with ``has_motion``.

Tolerances, per output (``BARS``):
  - ``rlane`` / ``llane`` equal on >= 99.9 % of lanes.  They may differ: the
    JAX sweep truncates t to 13 mantissa bits in its packed (t, id) key on
    tables under 1023 rows, so two surfaces within 6e-5 relative can swap,
    and XLA fuses a*b+c where eager PyTorch rounds twice.  Found: equal on
    every lane of every pool here.
  - on the lanes where both agree: colours (``misc`` rows 0-2) within atol
    2e-5 (found 6e-8); ``omt``, ``t_max``, contribution and bounce count of
    the children equal to 1e-6 (found equal); rows 10-15 and ``misc`` rows 4-7
    zero.
  - hit distance and children's rays on the scenes seen from 3.5 units
    (``glass``, ``motion``): hit_t rtol 1e-4, origins atol 1e-5 (found 7.9e-6),
    directions within 1e-5 on >= 60 % of the spawning lanes and within 1e-4 on
    all (found 3.4e-5: the scatter cone turns the normal's last ulps).
  - on ``iow5`` the camera stands 13 units from spheres of radius 0.2: the
    refine's hb^2 - cq cancels (one ulp of hb^2 is 1.5e-5 against a
    discriminant of 0.04 or less), the two packages round it differently, and
    the child's origin carries the t difference, its direction that over the
    radius.  Held: hit_t rtol 1e-4 on >= 99 % and 1e-3 on all; origins within
    2e-5 on >= 60 % and 2e-3 on all; directions within 1e-5 on >= 25 % and
    2e-2 on all (found: 1.4e-4 worst t, 65 % / 1.3e-3 origins, 30 % / 1.3e-2
    directions, on the camera lanes; the later generations start near the
    spheres and agree to 3e-5 / 3e-4).
  - hits on the ground sphere: hit_t rtol 2e-2 (rays that leave the ground at
    a grazing angle and meet it again; found 7.6e-3 at radius 1000).
  - inactive lanes add exactly 0, report ``t_max`` and spawn nothing; dead
    active lanes add contribution x sky(dy = 0).
  - the kernel source compiled as host C++ (where there is a g++) against the
    plain version: children's lane ids equal, every float within 1e-5 on >=
    99.9 % of lanes (rsqrt, cos and sin are the C library's there and
    PyTorch's here, an ulp apart on some arguments), in each sweep schedule
    and bit for bit the default schedule's; the inactive and dead lanes of a
    scattered pool (C not a multiple of 32, a tile of dead lanes, a tile of
    inactive lanes, every seventh lane live) equal to the plain version's bit
    for bit, and every live lane within the bar above.
"""

import shutil

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from raytracing_tests_tpu.kernels import mega as jmega
from raytracing_tests_tpu.kernels import sweep2 as jsw
from raytracing_tests_tpu.ops.render import RenderConfig as JRenderConfig
from raytracing_tests_tpu.scene import examples as jex
from raytracing_tests_tpu.scene.types import Camera as JCamera
from raytracing_tests_tpu.scene.types import SceneBuilder as JSceneBuilder
from raytracing_tests_tpu_torch import convert
from raytracing_tests_tpu_torch.kernels import _build
from raytracing_tests_tpu_torch.kernels import mega as tmega
from raytracing_tests_tpu_torch.kernels import sweep2 as tsw
from raytracing_tests_tpu_torch.ops.megalanes import _init_chunk
from raytracing_tests_tpu_torch.ops.render import RenderConfig, _lane_inputs
from raytracing_tests_tpu_torch.scene import examples as tex
from raytracing_tests_tpu_torch.scene.types import Camera, SceneBuilder

torch.set_num_threads(2)

FRAME = dict(width=32, height=16, spp=4, max_bounces=5)  # 2048 lanes
GR = 32
# (bar, least share within it, bar for every lane) per quantity; see the
# module docstring for the reasons.
NEAR = dict(t=(1e-4, 1.0, 1e-4), o=(1e-5, 1.0, 1e-5), d=(1e-5, 0.60, 1e-4))
BARS = dict(glass=NEAR, motion=NEAR,
            iow5=dict(t=(1e-4, 0.99, 1e-3), o=(2e-5, 0.60, 2e-3), d=(1e-5, 0.25, 2e-2)))
GROUND_T_RTOL = 2e-2


def nested_glass(sb_cls, cam_cls):
    """Nested and overlapping glass spheres over a ground sphere: rays that
    entered one start inside it, and leave it inside another."""
    b = sb_cls()
    b.add_dielectric((0.0, 0.0, -3.0), 0.8)
    b.add_dielectric((0.0, 0.0, -3.0), 0.4, ior=1.3)
    b.add_dielectric((0.9, 0.1, -3.2), 0.5)
    b.add_lambertian((-1.2, 0.0, -3.5), 0.5, (0.7, 0.3, 0.3))
    b.add_lambertian((0.0, -100.8, -3.0), 100.0, (0.5, 0.6, 0.4))
    cam = cam_cls.make((0.0, 0.3, 0.5), (0.0, -0.08, -1.0), fov_y_deg=55.0, focus_dist=3.5)
    return b.build(), cam


SCENES = {
    "iow5": lambda ex, sb, cam: ex.iow_final_scene(side=5),
    "glass": lambda ex, sb, cam: nested_glass(sb, cam),
    "motion": lambda ex, sb, cam: ex.motion_blur_scene(),
}


class Case:
    """One scene: the JAX accel, the same tables in the port's layout, the
    statics both kernels take and the camera pool."""

    def __init__(self, name):
        js, jc = SCENES[name](jex, JSceneBuilder, JCamera)
        ts, tc = SCENES[name](tex, SceneBuilder, Camera)
        self.jcfg = JRenderConfig(**FRAME).for_scene(js)
        self.cfg = RenderConfig(**FRAME).for_scene(ts)
        assert self.cfg.has_motion == self.jcfg.has_motion == (name == "motion")
        assert self.cfg.pallas_mode == "spheres"
        self.ja = jsw.make_accel2(js, gr=GR, has_motion=self.jcfg.has_motion,
                                  probe_rows=self.jcfg.probe_rows,
                                  sort_origin=jc.position)
        ftab = sum(np.asarray(x.astype(jnp.float32)) for x in self.ja.ftab3)
        self.ta = convert.accel2_from_numpy(
            np.asarray(self.ja.otab), ftab, np.asarray(self.ja.gaabb),
            np.asarray(self.ja.perm), GR, has_motion=self.cfg.has_motion)
        self.bars = BARS[name]
        self.ground = 0  # original id of the big ground sphere in every scene
        o, d, tr, _ = _lane_inputs(tc, self.cfg)
        lane = torch.arange(o.shape[0], dtype=torch.int32)
        lane[100:164] = -1  # inactive lanes
        pool = _init_chunk(o, d, tr, lane, self.cfg)
        pool[3:6, 300:332] = 0.0  # active lanes with a dead ray
        self.pool, self.lane = pool, lane

    def jax_step(self, pool, lane):
        c = self.jcfg
        out = jmega.mega_step(
            self.ja.otab, self.ja.ftab3, self.ja.gaabb, jnp.asarray(pool.numpy()),
            jnp.asarray(lane.numpy()), GR, c.has_motion, c.has_dielectrics, c.spp,
            c.max_bounces, c.t_max, c.background, block=512)
        return [np.asarray(x) for x in out]

    def port_step(self, pool, lane):
        c = self.cfg
        return tmega.mega_step(
            self.ta, pool, lane, has_dielectrics=c.has_dielectrics, spp=c.spp,
            max_bounces=c.max_bounces, t_max=c.t_max, bg=c.background)


@pytest.fixture(scope="module", params=list(SCENES))
def case(request):
    return Case(request.param)


def next_generation(out, lane):
    """What the drain makes of a step: the reflection child in place, else the
    refraction child; lanes that spawned nothing go inactive."""
    _, refr, refl, rlane, llane = out
    has_refl, has_refr = llane >= 0, rlane >= 0
    cur = torch.where(has_refl, refl, refr).contiguous()
    return cur, torch.where(has_refl | has_refr, lane, torch.full_like(lane, -1))


def hold(case, pool, lane):
    """The port's step against JAX's on one pool, by the bars of the module
    docstring -> the port's outputs."""
    got = case.port_step(pool, lane)
    want = case.jax_step(pool, lane)
    misc, refr, refl, rlane, llane = [x.numpy() for x in got]
    jmisc, jrefr, jrefl, jrlane, jllane = want
    C = pool.shape[1]
    assert misc.shape == (8, C) and refr.shape == refl.shape == (16, C)
    assert rlane.shape == llane.shape == (C,) and rlane.dtype == np.int32
    same = (rlane == jrlane) & (llane == jllane)
    assert same.mean() >= 0.999, same.mean()
    ln = lane.numpy()
    assert (np.isin(rlane, [-1]) | (rlane == ln)).all() and (np.isin(llane, [-1]) | (llane == ln)).all()
    assert np.isfinite(misc).all() and np.isfinite(refr).all() and np.isfinite(refl).all()
    np.testing.assert_array_equal(misc[4:], 0.0)
    np.testing.assert_array_equal(refr[10:], 0.0)
    np.testing.assert_array_equal(refl[10:], 0.0)
    # which lanes hit the ground sphere: there t is ill-conditioned in float32
    o, d = pool[0:3].T, pool[3:6].T
    live = ((d * d).sum(dim=1) > 0.5) & (lane >= 0)
    _, obj = tsw._sweep_plain(case.ta, o, d, live, pool[7], pool[6])
    on_ground = ((obj >= 0) & (case.ta.perm[obj.clamp_min(0).long()] == case.ground)).numpy()
    np.testing.assert_allclose(misc[0:3, same], jmisc[0:3, same], atol=2e-5, rtol=0)

    def within(got_, want_, sel, bars, relative=False):
        """Two-tier bar: a share of the lanes within the tight one, all within
        the loose one; the error of a column is its largest row's."""
        if not sel.any():
            return
        g, w = np.atleast_2d(got_)[:, sel], np.atleast_2d(want_)[:, sel]
        tight, share, loose = bars
        err = np.abs(g - w) / (np.abs(w) if relative else 1.0)
        ok_t, ok_l = (err <= tight).all(axis=0), (err <= loose).all(axis=0)
        assert ok_t.mean() >= share and ok_l.all(), (ok_t.mean(), ok_l.mean(), err.max())

    hit = (obj >= 0).numpy()
    within(misc[3], jmisc[3], same & hit & ~on_ground, case.bars["t"], relative=True)
    np.testing.assert_allclose(misc[3, same & on_ground], jmisc[3, same & on_ground],
                               rtol=GROUND_T_RTOL, atol=0)
    np.testing.assert_array_equal(misc[3, same & ~hit], jmisc[3, same & ~hit])
    for child, jchild, cl in ((refr, jrefr, rlane), (refl, jrefl, llane)):
        sel = same & (cl >= 0)
        within(child[0:3], jchild[0:3], sel, case.bars["o"])
        within(child[3:6], jchild[3:6], sel, case.bars["d"])
        np.testing.assert_allclose(child[6:10, sel], jchild[6:10, sel], atol=1e-6, rtol=1e-6)
    return got


def test_mega_step_camera_lanes_match_jax(case):
    misc, refr, refl, rlane, llane = hold(case, case.pool, case.lane)
    cfg = case.cfg
    # inactive lanes: nothing added, t_max, no child
    off = slice(100, 164)
    assert (misc[0:3, off] == 0).all() and (misc[3, off] == cfg.t_max).all()
    assert (rlane[off] == -1).all() and (llane[off] == -1).all()
    # dead active lanes miss and add contribution (1) x sky at dy = 0
    dead = slice(300, 332)
    sky = 0.5 * (torch.tensor(cfg.background[0]) + torch.tensor(cfg.background[1]))
    np.testing.assert_allclose(misc[0:3, dead].numpy(), sky[:, None].expand(3, 32).numpy(), atol=1e-7)
    assert (misc[3, dead] == cfg.t_max).all()
    assert (rlane[dead] == -1).all() and (llane[dead] == -1).all()
    assert (llane >= 0).float().mean() > 0.3  # the pool is live: many lanes spawn
    # children carry the parent's omt, t_max and bounce count + 1
    assert torch.equal(refl[6], case.pool[6]) and (refl[7] == cfg.t_max).all()
    assert (refl[9] == 1.0).all() and (refr[9] == 1.0).all()


def test_mega_step_later_generations_match_jax(case):
    """The children of the camera lanes, and theirs: most lanes are inactive
    by then, and on the glass scene the rays start inside glass, so the
    surrounding refractive index differs from 1."""
    pool, lane = case.pool, case.lane
    out = case.port_step(pool, lane)
    inner_refractions = 0
    for _ in range(3):
        pool, lane = next_generation(out, lane)
        assert (lane < 0).any() and (lane >= 0).any()
        out = hold(case, pool, lane)
        # a ray that left the surface inwards (the refraction child in place)
        # and spawns a refraction again is an interior hit
        inner_refractions += int(((out[3] >= 0) & (pool[9] >= 1.0)).sum())
    if case.cfg.has_dielectrics:
        assert inner_refractions > 0


def test_mega_step_refuses_what_it_cannot_take(case):
    c = case.cfg
    kw = dict(has_dielectrics=c.has_dielectrics, spp=c.spp, max_bounces=c.max_bounces,
              t_max=c.t_max, bg=c.background)
    with pytest.raises(ValueError):
        tmega.mega_step(case.ta, case.pool[:8].contiguous(), case.lane, **kw)
    with pytest.raises(TypeError):
        tmega.mega_step(case.ta, case.pool, case.lane.long(), **kw)
    with pytest.raises(RuntimeError):  # a host pointer never reaches a launch
        tmega._launch_mega(case.ta, case.pool, case.lane, **kw)


def test_kernel_source_rehearsed_on_the_host(case):
    """Where there is a g++, ``csrc/mega.cu`` compiled as host C++ against the
    plain version, on the camera pool and its children (static and MOTION
    instantiations by the scene): ``rlane`` / ``llane`` equal, every float
    within 1e-5 on >= 99.9 % of lanes (rsqrt, cos and sin are the C library's
    there and PyTorch's here, an ulp apart on some arguments), inactive and
    dead lanes written in full, and the work counters plausible."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ to rehearse the kernel source with")
    c = case.cfg
    kw = dict(has_dielectrics=c.has_dielectrics, spp=c.spp, max_bounces=c.max_bounces,
              t_max=c.t_max, bg=c.background)
    pool, lane = case.pool, case.lane
    for gen in range(2):
        want = tmega.mega_step_plain(case.ta, pool, lane, **kw)
        stats = torch.zeros(tmega.MS_LEN, dtype=torch.int64)
        with _build.host_rehearsal():
            got = tmega._launch_mega(case.ta, pool, lane, stats=stats, **kw)
        assert torch.equal(got[3], want[3]) and torch.equal(got[4], want[4])
        for g, w in zip(got[:3], want[:3]):
            assert g.shape == w.shape and torch.isfinite(g).all()
            ok = ((g - w).abs() <= 1e-5 + 1e-5 * w.abs()).all(dim=0)
            assert ok.float().mean() >= 0.999, (gen, float(ok.float().mean()))
        live = int(((pool[3:6] ** 2).sum(dim=0) > 0.5)[lane >= 0].sum())
        assert int(stats[tmega.MS_LIVE]) == live
        assert int(stats[tmega.MS_HITS]) == int((want[0][3] < c.t_max).sum())
        assert int(stats[tmega.MS_TESTS]) % GR == 0 and int(stats[tmega.MS_TESTS]) >= GR
        if c.has_dielectrics:
            assert int(stats[tmega.MS_PROBES]) > 0
        pool, lane = next_generation(want, lane)


# coop_min of the host rehearsals: None is the module's default (COOP_MIN).
# A host warp is one lane, so 1 sweeps every group per lane and the others
# row-parallel with a row stride of 1.
SCHEDULES = [None, 1, 33]


def _forced(coop_min):
    import contextlib

    return contextlib.nullcontext() if coop_min is None else _build.forced_coop_min(coop_min)


def _rehearse(case, pool, lane, coop_min=None):
    """The host build of csrc/mega.cu on one pool -> (outputs, stats)."""
    c = case.cfg
    kw = dict(has_dielectrics=c.has_dielectrics, spp=c.spp, max_bounces=c.max_bounces,
              t_max=c.t_max, bg=c.background)
    stats = torch.zeros(tmega.MS_LEN, dtype=torch.int64)
    with _build.host_rehearsal(), _forced(coop_min):
        got = tmega._launch_mega(case.ta, pool, lane, stats=stats, **kw)
    return got, stats, tmega.mega_step_plain(case.ta, pool, lane, **kw)


def _need_gxx():
    if shutil.which("g++") is None:
        pytest.skip("no g++ to rehearse the kernel source with")


def _close(got, want):
    """Per lane: every float within 1e-5 (+ 1e-5 relative)."""
    ok = torch.ones(got[0].shape[1], dtype=torch.bool)
    for g, w in zip(got[:3], want[:3]):
        ok &= ((g - w).abs() <= 1e-5 + 1e-5 * w.abs()).all(dim=0)
    return ok


@pytest.mark.parametrize("coop_min", [1, 33])
def test_kernel_source_rehearsed_on_the_host_in_each_schedule(case, coop_min):
    """... in each forced sweep schedule: the bars above against the plain
    version, and the default schedule's outputs and counters bit for bit."""
    _need_gxx()
    got, stats, want = _rehearse(case, case.pool, case.lane, coop_min)
    base, stats_base, _ = _rehearse(case, case.pool, case.lane)
    assert torch.equal(got[3], want[3]) and torch.equal(got[4], want[4])
    assert _close(got, want).float().mean() >= 0.999
    assert all(torch.equal(a, b) for a, b in zip(got, base))
    same = [tmega.MS_LIVE, tmega.MS_TESTS, tmega.MS_HITS, tmega.MS_PROBES, tmega.MS_ACTIVE,
            tmega.MS_ROW_TESTS, tmega.MS_PASSES]
    assert torch.equal(stats[same], stats_base[same])
    assert (int(stats[tmega.MS_COOP_VISITS]) > 0) == (coop_min > 1)
    # a host warp is one lane: one dense pass per live lane, all slots filled
    assert int(stats[tmega.MS_PASSES]) == int(stats[tmega.MS_LIVE])
    assert int(stats[tmega.MS_ACTIVE]) == int((case.lane >= 0).sum())


@pytest.mark.parametrize("coop_min", SCHEDULES)
def test_scattered_pool_rehearsed_on_the_host(case, coop_min):
    """A pool whose live lanes are scattered: C = 2043 (not a multiple of 32),
    lanes 64..95 active with a dead ray, lanes 128..159 inactive, and of the
    rest every seventh lane live, the others alternately inactive and dead.
    Every lane's outputs (misc, both children, rlane, llane) are the plain
    version's: bit for bit on inactive and dead lanes, within the bars above
    on live ones."""
    _need_gxx()
    C = 2043
    pool, lane = case.pool[:, :C].clone(), case.lane[:C].clone()
    idx = torch.arange(C)
    live = (idx % 7 == 0) & (lane >= 0) & ((pool[3:6] ** 2).sum(dim=0) > 0.5)
    live[64:160] = False
    inactive = ~live & (idx % 2 == 1)
    inactive[64:96], inactive[128:160] = False, True
    dead = ~live & ~inactive
    lane = torch.where(inactive, torch.full_like(lane, -1), idx.to(torch.int32))
    pool[3:6, dead] = 0.0
    pool[8, dead] = 0.7  # a contribution the sky multiplies
    pool[6, :] = torch.linspace(0.0, 1.0, C)  # omt and bounce count reach every child
    pool[9, :] = (idx % 3).to(torch.float32)
    pool = pool.contiguous()
    got, stats, want = _rehearse(case, pool, lane, coop_min)
    assert int(stats[tmega.MS_LIVE]) == int(live.sum()) > 250
    assert int(stats[tmega.MS_ACTIVE]) == int((lane >= 0).sum())
    assert torch.equal(got[3], want[3]) and torch.equal(got[4], want[4])
    fixed = ~live
    for g, w in zip(got[:3], want[:3]):
        assert g.shape == w.shape and torch.equal(g[:, fixed], w[:, fixed])
    assert (got[0][0:3, inactive] == 0).all() and (got[0][0:3, dead] > 0).all()
    ok = _close(got, want)[live]
    assert ok.float().mean() >= 0.999, float(ok.float().mean())


def test_probe_inside_nested_glass_rehearsed_on_the_host():
    """Rays that start inside four nested glass spheres: every lane hits glass
    and probes the surrounding RI at a point inside three or four glass
    spheres; the kernel source's outputs within the bars above, children's
    lane ids equal, in each schedule."""
    _need_gxx()
    centre = (0.0, 0.0, -3.0)
    b = SceneBuilder()
    for radius, ior in ((0.9, 1.5), (0.65, 1.3), (0.45, 1.7), (0.25, 1.4)):
        b.add_dielectric(centre, radius, ior=ior)
    b.add_dielectric((0.45, 0.1, -2.8), 0.4, ior=1.6)
    b.add_lambertian((0.0, -100.9, -3.0), 100.0, (0.5, 0.6, 0.4))
    scene = b.build()
    cfg = RenderConfig(**FRAME).for_scene(scene)
    case = Case.__new__(Case)
    case.cfg = cfg
    case.ta = tsw.make_accel2(scene, gr=8, probe_rows=cfg.probe_rows)
    rng = np.random.default_rng(11)
    n = 512
    o = torch.from_numpy((np.asarray(centre) + rng.uniform(-0.14, 0.14, (n, 3))).astype(np.float32))
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d = torch.from_numpy(d / np.linalg.norm(d, axis=-1, keepdims=True))
    lane = torch.arange(n, dtype=torch.int32)
    pool = _init_chunk(o, d, torch.zeros(n), lane, cfg)
    for coop_min in SCHEDULES:
        got, stats, want = _rehearse(case, pool, lane, coop_min)
        assert int(stats[tmega.MS_PROBES]) == n  # every winner is glass
        assert torch.equal(got[3], want[3]) and torch.equal(got[4], want[4])
        assert _close(got, want).float().mean() >= 0.999
    # the probe points (1e-3 outside the winner's surface): inside three or
    # four glass spheres
    _, obj = tsw._sweep_plain(case.ta, o, d, torch.ones(n, dtype=torch.bool), pool[7])
    win = case.ta.perm[obj.long()].long()
    hit_p = o + got[0][3][:, None] * d
    q = hit_p + 1e-3 * (hit_p - scene.position[win]) / scene.scale[win, 0:1]
    glass = scene.valid & (scene.refractive_index != 1.0)
    d2 = ((q[:, None] - scene.position[glass][None]) ** 2).sum(dim=-1)
    depth = (d2 <= scene.scale[glass, 0][None] ** 2).sum(dim=1)
    assert (depth >= 3).all() and (depth >= 4).any()
