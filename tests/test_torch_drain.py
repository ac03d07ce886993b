"""The drain step of the lane-aligned renderer (``kernels.drain``).

``drain_step_plain`` is held bit for bit against the loop body the port ran
before it (``_old_step`` below: the JAX package's ``ops/megalanes.py:74-122``
as the port wrote it, one ``torch.where`` pass after another, with a scratch
stack slot) over random lane states made from a numpy seed: pushes, full
stacks, pops, lanes that die, lanes already dead, the first step and a
later one.  Where there is a g++, the kernel source ``csrc/drain.cu``
compiled as host C++ (``_build.host_rehearsal``) is held bit for bit against
``drain_step_plain`` on the same states: the kernel adds, selects and copies
only.  A whole chunk drained with its full budget of steps gives the old
early-exit loop's colour, primary t, rays and drops bit for bit, and its
iteration counter counts what that loop's condition (the JAX package's
``cond``) counted.
"""

import shutil

import numpy as np
import pytest
import torch

from raytracing_tests_tpu_torch.kernels import _build, drain, mega
from raytracing_tests_tpu_torch.kernels.sweep2 import make_accel2
from raytracing_tests_tpu_torch.ops import megalanes
from raytracing_tests_tpu_torch.ops.render import RenderConfig, _lane_inputs
from raytracing_tests_tpu_torch.scene import examples as tex

torch.set_num_threads(2)

T_MAX = 32000.0


def _old_step(cur, lane, queue, qsize, color, primary_t, rays, dropped, misc, refr, refl,
              rlane, llane, omt_row, it, Q, t_max):
    """The port's loop body before the drain kernel (queue (Q + 1, 8, C),
    slot Q scratch; qsize int64) -> the new state."""
    C = cur.shape[1]
    f32 = torch.float32
    tmax_row = torch.full((1, C), t_max, dtype=f32)
    spare = torch.zeros((mega.POOL_ROWS - 10, C), dtype=f32)
    none = torch.full_like(lane, -1)
    active = lane >= 0
    color = color + misc[0:3]
    if it == 0:
        primary_t = torch.where(active, misc[3], primary_t)
    rays = rays + active.to(torch.int32)
    has_refl = llane >= 0
    has_refr = rlane >= 0
    push = has_refl & has_refr
    can = qsize < Q
    do_push = push & can
    dropped = dropped + torch.sum(push & ~can)
    refr8 = torch.cat([refr[0:6], refr[8:10]])
    slot = torch.where(do_push, qsize, torch.full_like(qsize, Q))
    queue = queue.clone()
    queue.scatter_(0, slot.expand(1, 8, C), refr8[None])
    qsize = qsize + do_push.to(torch.int64)
    need_pop = active & ~has_refl & ~has_refr
    do_pop = need_pop & (qsize > 0)
    top = torch.clamp_min(qsize - 1, 0)
    popped8 = torch.gather(queue, 0, top.expand(1, 8, C))[0]
    popped8 = torch.where(do_pop, popped8, torch.zeros_like(popped8))
    qsize = qsize - do_pop.to(torch.int64)
    popped = torch.cat([popped8[0:6], omt_row, tmax_row, popped8[6:8], spare])
    cur = torch.where(has_refl, refl, torch.where(has_refr, refr, popped))
    lane = torch.where(has_refl | has_refr | do_pop, lane, none)
    return cur, lane, queue, qsize, color, primary_t, rays, dropped


def _dead_record(omt, C):
    rec = torch.zeros((mega.POOL_ROWS, C))
    rec[mega.P_OMT] = omt
    rec[mega.P_TLIM] = T_MAX
    return rec


def random_state(seed, C=777, Q=3, step=0):
    """A drain state and K6 outputs as a drain meets them: ~30 % of lanes dead
    (their record the dead record), stack sizes 0..Q (full ones included),
    each child spawning with probability 0.5 on live lanes, K6's zeros and
    -1s on dead ones."""
    rng = np.random.default_rng(seed)
    f = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))  # noqa: E731
    lane = torch.from_numpy(rng.permutation(C).astype(np.int32))
    lane[torch.from_numpy(rng.random(C) < 0.3)] = -1
    active = lane >= 0
    omt = torch.from_numpy(rng.random(C).astype(np.float32))
    cur = torch.where(active, f(mega.POOL_ROWS, C), _dead_record(omt, C))
    cur[mega.P_OMT] = omt
    st = drain.DrainState.create(C, Q, "cpu")
    st.cur.copy_(cur)
    st.lane.copy_(lane)
    st.omt.copy_(omt)
    st.queue.copy_(f(Q, drain.QUEUE_ROWS, C))
    st.qsize.copy_(torch.from_numpy(rng.integers(0, Q + 1, C).astype(np.int32)))
    st.color.copy_(f(3, C))
    st.primary_t.copy_(f(C).abs() * 10)
    st.rays.copy_(torch.from_numpy(rng.integers(0, 6, C).astype(np.int32)))
    st.iters.fill_(step)
    st.dropped.fill_(int(rng.integers(0, 50)))
    misc = torch.where(active, f(mega.MISC_ROWS, C), torch.zeros(()))
    misc[4:] = 0.0
    refr, refl = f(mega.POOL_ROWS, C), f(mega.POOL_ROWS, C)
    refr[10:] = refl[10:] = 0.0
    spawn = lambda: active & torch.from_numpy(rng.random(C) < 0.5)  # noqa: E731
    rlane = torch.where(spawn(), lane, torch.full_like(lane, -1))
    llane = torch.where(spawn(), lane, torch.full_like(lane, -1))
    return st, (misc, refr, refl, rlane, llane)


def clone_state(st):
    return drain.DrainState(**{k: getattr(st, k).clone() for k in drain.DrainState.__annotations__})


def assert_same_state(a, b):
    for k in drain.DrainState.__annotations__:
        assert torch.equal(getattr(a, k), getattr(b, k)), k


@pytest.mark.parametrize("seed,step", [(0, 0), (1, 0), (2, 3), (3, 7)])
def test_plain_step_equals_the_old_loop_body(seed, step):
    st, outs = random_state(seed, step=step)
    Q = st.capacity
    C = st.lanes
    queue = torch.cat([st.queue, torch.zeros((1, drain.QUEUE_ROWS, C))])
    want = _old_step(st.cur, st.lane, queue, st.qsize.long(), st.color, st.primary_t, st.rays,
                     st.dropped, *outs, st.omt[None], step, Q, T_MAX)
    before = clone_state(st)
    drain.drain_step_plain(st, *outs, step=step, t_max=T_MAX)
    cur, lane, queue, qsize, color, primary_t, rays, dropped = want
    assert torch.equal(st.cur, cur) and torch.equal(st.lane, lane)
    assert torch.equal(st.queue, queue[:Q]) and torch.equal(st.qsize, qsize.to(torch.int32))
    assert torch.equal(st.color, color) and torch.equal(st.primary_t, primary_t)
    assert torch.equal(st.rays, rays) and torch.equal(st.dropped, dropped)
    assert int(st.iters) == step + 1  # some lane was live
    # the random state holds every case
    active = before.lane >= 0
    push = (outs[3] >= 0) & (outs[4] >= 0)
    none = active & (outs[3] < 0) & (outs[4] < 0)
    assert (push & (before.qsize == Q)).any() and (push & (before.qsize < Q)).any()
    assert (none & (before.qsize > 0)).any() and (none & (before.qsize == 0)).any()
    assert int(st.dropped) > int(before.dropped)


def test_a_step_over_dead_lanes_changes_nothing():
    st, outs = random_state(4, step=5)
    st.lane.fill_(-1)
    st.cur.copy_(_dead_record(st.omt, st.lanes))
    misc, refr, refl, rlane, llane = outs
    outs = (torch.zeros_like(misc), refr, refl, torch.full_like(rlane, -1),
            torch.full_like(llane, -1))
    before = clone_state(st)
    drain.drain_step_plain(st, *outs, step=9, t_max=T_MAX)
    assert_same_state(st, before)


@pytest.mark.parametrize("seed,step", [(0, 0), (2, 3), (5, 1)])
def test_kernel_source_rehearsed_on_the_host_bit_for_bit(seed, step):
    if shutil.which("g++") is None:
        pytest.skip("no g++ to rehearse the kernel source with")
    st, outs = random_state(seed, C=1000, step=step)
    got = clone_state(st)
    drain.drain_step_plain(st, *outs, step=step, t_max=T_MAX)
    with _build.host_rehearsal():
        drain._launch_drain(got, *outs, step=step, t_max=T_MAX)
    assert_same_state(got, st)


def test_the_wrapper_checks_its_arguments():
    st, outs = random_state(6)
    with pytest.raises(ValueError):
        drain.drain_step(st, outs[0][:, :10], *outs[1:], step=0, t_max=T_MAX)
    with pytest.raises(ValueError):
        drain.drain_step(st, *outs[:3], outs[3].long(), outs[4], step=0, t_max=T_MAX)
    with pytest.raises(RuntimeError):  # a host pointer never reaches a CUDA launch
        drain._launch_drain(st, *outs, step=0, t_max=T_MAX)


@pytest.fixture(scope="module")
def chunk():
    scene, cam = tex.iow_final_scene(side=5)
    cfg = RenderConfig(width=48, height=32, spp=2, max_bounces=5,
                       intersector="pallas").for_scene(scene)
    accel = make_accel2(scene, gr=32, probe_rows=cfg.probe_rows, sort_origin=cam.position)
    o, d, tr, _ = _lane_inputs(cam, cfg)
    lane = torch.arange(o.shape[0], dtype=torch.int32)
    lane[::7] = -1  # padding lanes among the live ones
    return accel, cfg, megalanes._init_chunk(o, d, tr, lane, cfg), lane


def _old_chunk(accel, cur, lane, cfg):
    """The port's drain of a chunk before the drain kernel: the early exit
    (JAX's ``cond``) read on the host each step."""
    C, Q = cur.shape[1], cfg.queue_capacity
    omt_row = cur[mega.P_OMT:mega.P_OMT + 1].clone()
    queue = torch.zeros((Q + 1, 8, C))
    qsize = torch.zeros((C,), dtype=torch.int64)
    color = torch.zeros((3, C))
    primary_t = torch.full((C,), cfg.t_max)
    rays = torch.zeros((C,), dtype=torch.int32)
    dropped = torch.zeros((), dtype=torch.int64)
    it = 0
    while it < cfg.pops and bool((lane >= 0).any()):
        outs = mega.mega_step_plain(accel, cur, lane, has_dielectrics=cfg.has_dielectrics,
                                    spp=cfg.spp, max_bounces=cfg.max_bounces,
                                    t_max=cfg.t_max, bg=cfg.background)
        cur, lane, queue, qsize, color, primary_t, rays, dropped = _old_step(
            cur, lane, queue, qsize, color, primary_t, rays, dropped, *outs, omt_row, it, Q,
            cfg.t_max)
        it += 1
    return color, primary_t, rays, it, dropped


@pytest.mark.parametrize("capacity,poll_every", [(5, None), (1, None), (5, 1), (5, 2), (1, 3)])
def test_a_chunk_equals_the_early_exit_loop(chunk, capacity, poll_every):
    """The full budget (``poll_every`` = ``cfg.pops``) and the lagged poll run
    steps past the chunk's end, over dead lanes only (at most 2 x
    ``poll_every`` of them under the poll), and give the early exit's
    results bit for bit; the counter counts the steps that began with a
    live lane (fewer than the budget here); a stack of one drops."""
    import dataclasses

    accel, cfg, cur, lane = chunk
    cfg = dataclasses.replace(cfg, queue_capacity=capacity)
    poll_every = poll_every or cfg.pops
    color, primary_t, rays, it, dropped = _old_chunk(accel, cur, lane, cfg)
    st = drain.DrainState.create(cur.shape[1], capacity, "cpu")
    st.load(cur, lane, cfg.t_max)
    calls = []
    real = megalanes.mega_step

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)

    megalanes.mega_step = counted
    try:
        steps = megalanes._drain_chunk(accel, st, cfg, poll_every)
    finally:
        megalanes.mega_step = real
    assert len(calls) == steps
    assert 1 < it < cfg.pops and int(st.iters) == it
    if poll_every == cfg.pops:
        assert steps == cfg.pops
    else:
        assert it < steps <= min(cfg.pops, it + 2 * poll_every)
    assert torch.equal(st.color, color) and torch.equal(st.primary_t, primary_t)
    assert torch.equal(st.rays, rays) and torch.equal(st.dropped, dropped)
    assert (int(dropped) > 0) == (capacity == 1)
    assert bool((st.lane < 0).all())


@pytest.mark.parametrize("renderer", ["megalanes", "workqueue"])
def test_the_drains_run_on_the_card_unless_the_cpu_is_named(renderer):
    """``device=None`` is the card: without one the two renderers raise
    before anything runs; ``device="cpu"`` is asked for by name."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None would run there")
    from raytracing_tests_tpu_torch.ops.workqueue import render_workqueue

    scene, cam = tex.iow_final_scene(side=5)
    cfg = RenderConfig(width=4, height=2, spp=1, max_bounces=2,
                       intersector="pallas").for_scene(scene)
    render = megalanes.render_megalanes if renderer == "megalanes" else render_workqueue
    with pytest.raises(RuntimeError, match="CUDA"):
        render(scene, cam, cfg)
    out = render(scene, cam, cfg, device="cpu")
    assert out["image"].device.type == "cpu" and torch.isfinite(out["image"]).all()
