"""The work-queue renderer against the port's queue renderer and the JAX
package's ``render_workqueue``.

On the CPU both of the port's renderers run the plain versions of the sweep
kernels; the JAX side runs its Pallas kernels in interpret mode.  Sizes are the
JAX package's own test sizes: 24x16x2 depth 3 with ``chunk=512`` on ``groups``,
``motion`` and ``bvh-grid(side=4)``, and an odd 7x5x3 depth 4 with
``chunk=256``.

Tolerances:
  - against the port's ``render`` (the same ``shade_rays`` on the same sweeps,
    the children in another order): image atol 2e-5, depth atol 1e-4, equal
    ray counts (found: equal images on all three scenes).
  - against JAX ``render_workqueue``: every pixel inside the oracle bar (atol
    2e-4 / rtol 1e-3), equal ``rays`` and ``iterations``, zero dropped (found:
    images within 2.1e-6).
  - a pool too small for the frame's children drops the same count as JAX's,
    and more than none.
  - ``tile_order_perm`` equal to JAX's.
"""

import dataclasses

import numpy as np
import pytest
import torch

from raytracing_tests_tpu.ops.render import RenderConfig as JRenderConfig
from raytracing_tests_tpu.ops.workqueue import render_workqueue as j_render_workqueue
from raytracing_tests_tpu.ops.workqueue import tile_order_perm as j_tile_order_perm
from raytracing_tests_tpu.scene import examples as jex
from raytracing_tests_tpu_torch.ops.render import (
    RenderConfig, extract_lights, render, render_stats,
)
from raytracing_tests_tpu_torch.ops.workqueue import render_workqueue, tile_order_perm
from raytracing_tests_tpu_torch.scene import examples as tex

torch.set_num_threads(2)

SCENES = {
    "groups": lambda ex: ex.groups_scene(),
    "motion": lambda ex: ex.motion_blur_scene(),
    "bvh-grid": lambda ex: ex.bvh_grid_scene(side=4),
}
FRAME = dict(width=24, height=16, spp=2, max_bounces=3, intersector="pallas")


@pytest.mark.parametrize("name", list(SCENES))
def test_workqueue_matches_queue(name):
    scene, cam = SCENES[name](tex)
    cfg = RenderConfig(**FRAME).for_scene(scene)
    rq = render_stats(scene, cam, cfg, device="cpu")
    rw = render_workqueue(scene, cam, cfg, chunk=512, device="cpu")
    np.testing.assert_allclose(rw["image"].numpy(), rq["image"].numpy(), atol=2e-5, rtol=0)
    np.testing.assert_allclose(rw["depth"].numpy(), rq["depth"].numpy(), atol=1e-4, rtol=0)
    assert int(rw["rays"]) == rq["rays"] and rw["rays_dropped"] == 0
    assert rw["iterations"] >= 2


@pytest.mark.parametrize("name", list(SCENES))
def test_workqueue_matches_jax_workqueue(name):
    js, jc = SCENES[name](jex)
    ts, tc = SCENES[name](tex)
    jcfg = JRenderConfig(**FRAME).for_scene(js)
    tcfg = RenderConfig(**FRAME).for_scene(ts)
    assert jcfg.has_motion == tcfg.has_motion == (name == "motion")
    oj = j_render_workqueue(js, jc, jcfg, chunk=512)
    ot = render_workqueue(ts, tc, tcfg, chunk=512, device="cpu")
    ij, it = np.asarray(oj["image"]), ot["image"].numpy()
    assert it.shape == (16, 24, 3) and np.isfinite(it).all()
    ok = np.isclose(it, ij, atol=2e-4, rtol=1e-3).all(axis=-1)
    assert ok.all(), ok.mean()
    assert int(ot["rays"]) == int(oj["rays"])
    assert int(ot["iterations"]) == int(oj["iterations"])
    assert ot["rays_dropped"] == int(oj["rays_dropped"]) == 0


@pytest.mark.parametrize("intersector", ["pallas", "brute"])
def test_workqueue_odd_sizes(intersector):
    """7x5x3 lanes in chunks of 256: one ragged chunk of primaries, then the
    children; on the scene with glass, so both kinds of child are compacted."""
    scene, cam = tex.iow_final_scene(side=5)
    cfg = RenderConfig(width=7, height=5, spp=3, max_bounces=4,
                       intersector=intersector).for_scene(scene)
    rq = render(scene, cam, cfg, device="cpu")
    rw = render_workqueue(scene, cam, cfg, chunk=256, device="cpu")
    np.testing.assert_allclose(rw["image"].numpy(), rq["image"].numpy(), atol=2e-5, rtol=0)
    assert rw["rays_dropped"] == 0


def test_pool_overflow_drops_the_same_count_as_jax():
    """768 primaries in chunks of 128 with ``pool_factor=1``: the pool holds
    B + 4 chunks and the write cursor is clamped two chunks before its end, so
    the late children are dropped, and counted."""
    js, jc = jex.motion_blur_scene()
    ts, tc = tex.motion_blur_scene()
    jcfg = JRenderConfig(**FRAME).for_scene(js)
    tcfg = RenderConfig(**FRAME).for_scene(ts)
    oj = j_render_workqueue(js, jc, jcfg, chunk=128, pool_factor=1.0)
    ot = render_workqueue(ts, tc, tcfg, chunk=128, pool_factor=1.0, device="cpu")
    assert int(oj["rays_dropped"]) > 0
    assert ot["rays_dropped"] == int(oj["rays_dropped"])
    assert int(ot["rays"]) == int(oj["rays"])
    assert torch.isfinite(ot["image"]).all()
    full = render_workqueue(ts, tc, tcfg, chunk=128, device="cpu")
    assert full["rays_dropped"] == 0 and int(full["rays"]) > int(ot["rays"])


@pytest.mark.parametrize("size", [(24, 16, 2, 8), (7, 5, 3, 4), (10, 9, 1, 16)])
def test_tile_order_perm_matches_jax(size):
    got, want = tile_order_perm(*size), np.asarray(j_tile_order_perm(*size))
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int32 and sorted(got.tolist()) == list(range(size[0] * size[1] * size[2]))


def test_tile_order_changes_nothing_in_the_picture():
    scene, cam = tex.groups_scene()
    cfg = RenderConfig(**FRAME).for_scene(scene)
    a = render_workqueue(scene, cam, cfg, chunk=512, device="cpu")
    b = render_workqueue(scene, cam, cfg, chunk=512, tile=8, device="cpu")
    np.testing.assert_allclose(b["image"].numpy(), a["image"].numpy(), atol=1e-6, rtol=0)
    assert torch.equal(a["depth"], b["depth"]) and int(a["rays"]) == int(b["rays"])


@pytest.mark.parametrize("what", ["materials", "lights"])
def test_workqueue_refuses_what_it_does_not_render(what):
    scene, cam = tex.groups_scene()
    cfg = RenderConfig(**FRAME).for_scene(scene)
    lights = None
    if what == "materials":
        cfg = dataclasses.replace(cfg, shading="materials")
    else:
        # lights render (test_torch_lights holds them); materials shading
        # stays refused with lights too
        scene, cam = tex.lights_scene()
        lights = extract_lights(scene)
        cfg = RenderConfig(**FRAME).for_scene(scene)
        lit = render_workqueue(scene, cam, cfg, lights, chunk=512, device="cpu")
        assert torch.isfinite(lit["image"]).all() and int(lit["rays_dropped"]) == 0
        cfg = dataclasses.replace(cfg, shading="materials")
    with pytest.raises(NotImplementedError):
        render_workqueue(scene, cam, cfg, lights, device="cpu")


def _old_drain_queue(scene, accel, lights, pool_fields, pool_lane, write0, cfg, chunk,
                     n_lanes, max_iters):
    """The port's work-queue loop before the device cursors (cursors on the
    host, boolean-mask indexing, one host read a step), kept to hold the
    static body to: -> (rgb, primary_t, rays, iters, dropped, read, write)."""
    from raytracing_tests_tpu_torch.ops.render import shade_rays

    C, B, P = chunk, n_lanes, pool_lane.shape[0]
    f32 = torch.float32
    color = torch.zeros((3 * B,), dtype=f32)
    white = torch.zeros((B,), dtype=torch.bool)
    primary_t = torch.full((B,), cfg.t_max, dtype=f32)
    rays = torch.zeros((), dtype=torch.int64)
    slot = torch.arange(C)
    read, write, it, dropped = 0, write0, 0, 0
    while read < write and it < max_iters:
        avail = min(C, write - read)
        f = pool_fields[:, read:read + C]
        l = pool_lane[read:read + C]
        l = torch.where(slot < avail, l, torch.full_like(l, -1))
        o = f[0:3].T.contiguous()
        d = f[3:6].T.contiguous()
        contrib, bounced = f[6], f[7].to(torch.int32)
        active = l >= 0
        sample_idx = (l % cfg.spp).to(f32)
        r = shade_rays(scene, lights, cfg, accel, o, d, contrib, bounced, active,
                       sample_idx, sample_idx / cfg.spp)
        la = l[active].long()
        add = r.add_color[active]
        color.index_add_(0, torch.cat([la, la + B, la + 2 * B]),
                         torch.cat([add[:, 0], add[:, 1], add[:, 2]]))
        if lights is not None:
            white[l[r.set_white].long()] = True
        is_primary = active & (bounced == 0)
        primary_t[l[is_primary].long()] = r.hit_t[is_primary]
        none = torch.full_like(l, -1)
        ch_lane = torch.cat([torch.where(r.refr_mask, l, none),
                             torch.where(r.refl_mask, l, none)])
        bf = r.bounced.to(f32)
        ch = torch.cat([
            torch.cat([r.refr_o.T, r.refr_d.T, r.refr_contrib[None], bf[None]]),
            torch.cat([r.refl_o.T, r.refl_d.T, r.refl_contrib[None], bf[None]]),
        ], dim=1)
        valid = ch_lane >= 0
        packed_lane = ch_lane[valid]
        n_children = packed_lane.shape[0]
        w = min(write, P - 2 * C)
        pool_fields[:, w:w + n_children] = ch[:, valid]
        pool_lane[w:w + n_children] = packed_lane
        new_write = min(write + n_children, P - 2 * C)
        dropped += write + n_children - new_write
        rays = rays + torch.sum(active)
        read, write, it = read + avail, new_write, it + 1
    rgb = torch.where(white, torch.ones_like(color.reshape(3, B)), color.reshape(3, B))
    return rgb, primary_t, rays, it, dropped, read, write


STATIC_CASES = {
    # test_pool_overflow_drops_the_same_count_as_jax's frame and pool
    "overflow": (lambda: tex.motion_blur_scene(), dict(chunk=128, pool_factor=1.0), False),
    "lights": (lambda: tex.lights_scene(), dict(chunk=512, pool_factor=3.2), True),
}


@pytest.mark.parametrize("case", list(STATIC_CASES))
def test_the_static_body_gives_the_old_loops_pool_and_counts(case):
    """The device cursors and the static body leave the pool, its cursors,
    ``iterations``, ``rays`` and ``rays_dropped`` as the host-cursor loop
    did, and the same picture (the colour sums in the same order: bit for
    bit); the cursors are read once a replay."""
    from raytracing_tests_tpu_torch.ops import workqueue

    make, kw, lit = STATIC_CASES[case]
    scene, cam = make()
    cfg = RenderConfig(**FRAME).for_scene(scene)
    lights = extract_lights(scene) if lit else None
    dev = torch.device("cpu")
    q_old = workqueue._prepare(scene, cam, cfg, lights, kw["chunk"], kw["pool_factor"], 0, dev)
    q = workqueue._prepare(scene, cam, cfg, lights, kw["chunk"], kw["pool_factor"], 0, dev)
    max_iters = q.P // q.C + 8 * (cfg.max_bounces + 1)
    fields, lane = q_old.fields[:, :q.P].clone(), q_old.lane[:q.P].clone()
    rgb, primary_t, rays, it, dropped, read, write = _old_drain_queue(
        q_old.scene, q_old.accel, q_old.lights, fields, lane, q.B, cfg, q.C, q.B, max_iters)
    reads = []
    real = workqueue._read_cursors

    def counted(cursors):
        reads.append(1)
        return real(cursors)

    workqueue._read_cursors = counted
    try:
        iters = workqueue._drain_queue(q, max_iters, graphs=False)
    finally:
        workqueue._read_cursors = real
    assert iters == it and q.cursors.tolist() == [read, write, it, dropped]
    assert int(q.rays) == int(rays)
    assert (dropped > 0) == (case == "overflow")
    assert torch.equal(q.fields[:, :write], fields[:, :write])
    assert torch.equal(q.lane[:write], lane[:write])
    got_rgb, got_t = q.result()
    assert torch.equal(got_rgb, rgb) and torch.equal(got_t, primary_t)
    assert len(reads) == workqueue.LAST["host_reads"] == sum(workqueue.LAST["replays"].values())
    assert len(reads) <= iters


@pytest.mark.parametrize("k", [1, 4, 16])
def test_the_replay_rule_never_runs_past_the_queues_end(k):
    """Replays of k iterations (eager here, the rule the graphs follow):
    every iteration begins with ``read < write`` inside the budget; the
    frame is the same for every k, and k > 1 reads the host less."""
    from raytracing_tests_tpu_torch.ops import workqueue

    scene, cam = tex.iow_final_scene(side=5)
    cfg = RenderConfig(width=32, height=16, spp=4, max_bounces=4,
                       intersector="pallas").for_scene(scene)
    dev = torch.device("cpu")
    outs = {}
    for kk in sorted({1, k}):
        q = workqueue._prepare(scene, cam, cfg, None, 64, 3.2, 0, dev)
        max_iters = q.P // q.C + 8 * (cfg.max_bounces + 1)
        starts = []
        real = q.body

        def body():
            read, write, it, _ = q.cursors.tolist()
            starts.append((read, write, it))
            real()

        q.body = body
        iters = workqueue._drain_queue(q, max_iters, graphs=False, k=kk)
        assert len(starts) == iters >= 4
        assert all(r < w and i < max_iters for r, w, i in starts), starts
        assert q.cursors[0] == q.cursors[1]
        outs[kk] = (q.result(), q.rays.clone(), iters, dict(workqueue.LAST["replays"]))
    (rgb, t), rays, iters, replays = outs[k]
    (rgb1, t1), rays1, iters1, _ = outs[1]
    assert torch.equal(rgb, rgb1) and torch.equal(t, t1)
    assert int(rays) == int(rays1) and iters == iters1
    assert sum(n * c for n, c in replays.items()) == iters
    if k > 1:
        assert replays.get(k, 0) > 0 and sum(replays.values()) < iters
