"""The port's device-resident queue loop against the JAX package's.

The queue renderer keeps its shapes static and its counts on the device, as
the JAX package's does under ``jit``: ``RayQueue.push`` writes one record a
lane, its slot or a spill slot (the JAX package's one-hot ``where`` on the Q
records, by an ``index_copy``), ``trace_lanes``
accumulates ``rays``, ``dropped`` and ``pops`` as tensors, and the lanes that
read the surrounding refractive index by the containment sum are packed into
a fixed number of slots.  A gradient band then reads nothing on the host,
which is what lets ``diff.banded_value_and_grad`` capture it in a CUDA graph
on the card; on the CPU the same code runs eagerly.

Tolerances:
  - the queue's push and pop against the JAX ``RayQueue`` on the same seeded
    masks and values, full queues and overflow included: stacks, sizes,
    drop counts, the active flags and the values popped by active lanes
    equal bit for bit (``np.array_equal``; the JAX pop sums a one-hot row,
    which turns a -0.0 into +0.0, and equal arrays hold them equal);
  - ``trace_lanes`` in the gradient configuration against the JAX
    package's, with and without the early exit, on the same lanes: ``rays``,
    ``dropped`` and the pop count exactly, ``primary_t`` within rtol 1e-4,
    the colour within atol 5e-4 on every lane and 1e-5 on >= 99 % of them
    (XLA:CPU fuses a*b+c where eager PyTorch rounds twice);
  - a forced small RI capacity against an ample one: the overflow is seen
    and the recomputed step equals the ample step's loss and every gradient
    bit for bit (the same slots in the end, the same arithmetic).
"""

import collections
import dataclasses
import importlib

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import jax.numpy as jnp

from raytracing_tests_tpu import diff as jdiff
from raytracing_tests_tpu.scene import examples as jex
from raytracing_tests_tpu_torch import convert, diff
from raytracing_tests_tpu_torch.diff.train import _diff_cfg, _probe_lanes
from raytracing_tests_tpu_torch.kernels import _build
from raytracing_tests_tpu_torch.ops.render import RenderConfig

# the modules (each package's ``ops`` also exports a function ``render``)
jrender = importlib.import_module("raytracing_tests_tpu.ops.render")
trender = importlib.import_module("raytracing_tests_tpu_torch.ops.render")

torch.set_num_threads(2)

CPU = "cpu"
SEED = 17


def _port_of(js, jc):
    ts = convert.scene_from_numpy({f: np.asarray(getattr(js, f)) for f in convert.SCENE_FIELDS})
    tc = convert.camera_from_numpy(
        {f: np.asarray(getattr(jc, f)) for f in convert.CAMERA_FIELDS})
    return ts, tc


def _queues_equal(jq, tq):
    """The JAX queue's stacks and sizes against the port's Q records (kept
    slot-major; the port's spill slot after them is never read).  A port
    queue without media against the JAX queue's air."""
    for f in ("origin", "direction", "contribution", "bounced", "medium", "parent_medium"):
        want = np.asarray(getattr(jq, f))
        if f not in tq.stacks:
            assert not tq.media and (want == 1.0).all(), f
            continue
        assert np.array_equal(want, tq.stacks[f].transpose(0, 1)[:, :-1].numpy()), f
    assert np.array_equal(np.asarray(jq.size), tq.size.numpy())


def test_push_and_pop_match_jax():
    """Twenty seeded pushes and pops on 96 lanes with a capacity of 3: every
    lane fills, overflows (its pushes dropped and counted) and drains; some
    pushes carry media, some take the default."""
    rng = np.random.default_rng(SEED)
    B, Q = 96, 3
    jq = jrender.RayQueue.create(B, Q)
    tq = trender.RayQueue.create(B, Q, CPU)
    dropped_total = 0
    for step in range(20):
        if step in (5, 6, 11, 15) or rng.uniform() < 0.35:
            jq, *jout = jq.pop()
            tout = tq.pop()
            act = tout[0].numpy()
            assert np.array_equal(np.asarray(jout[0]), act)
            for a, b in zip(jout[1:], tout[1:]):
                # Popped values agree on the lanes that pop a ray; an empty
                # lane pops zeros here (a dead ray for the sweeps), where the
                # JAX package's one-hot sum reads its stale slot 0.
                assert np.array_equal(np.asarray(a)[act], b.numpy()[act])
                assert not b.numpy()[~act].any()
        else:
            mask = rng.uniform(size=B) < (0.9 if step < 8 else 0.5)
            o, d = (rng.normal(size=(B, 3)).astype(np.float32) for _ in range(2))
            c = rng.uniform(size=B).astype(np.float32)
            b = rng.integers(0, 9, size=B).astype(np.int32)
            media = (rng.uniform(1.0, 2.0, size=(2, B)).astype(np.float32)
                     if step % 3 == 0 else (None, None))
            jq, jd = jq.push(jnp.asarray(mask), jnp.asarray(o), jnp.asarray(d), jnp.asarray(c),
                             jnp.asarray(b), *(None if m is None else jnp.asarray(m)
                                               for m in media))
            td = tq.push(torch.from_numpy(mask), torch.from_numpy(o), torch.from_numpy(d),
                         torch.from_numpy(c), torch.from_numpy(b),
                         *(None if m is None else torch.from_numpy(m) for m in media))
            assert isinstance(td, torch.Tensor) and td.dim() == 0
            assert int(td) == int(jd)
            dropped_total += int(td)
        _queues_equal(jq, tq)
    assert dropped_total > 0 and int(tq.size.max()) <= Q


def test_a_queue_without_media_matches_jax():
    """The queue the renderer makes outside the materials model keeps no
    media: its pushes and pops against the JAX ``RayQueue`` (whose media stay
    air) bit for bit, its media read 1, and a push that brings media is
    refused."""
    rng = np.random.default_rng(SEED + 1)
    B, Q = 64, 2
    jq = jrender.RayQueue.create(B, Q)
    tq = trender.RayQueue.create(B, Q, CPU, media=False)
    assert not tq.media and set(tq.stacks) == {"origin", "direction", "contribution", "bounced"}
    for step in range(12):
        if step % 3 == 2:
            jq, *jout = jq.pop()
            tout = tq.pop()
            act = tout[0].numpy()
            assert np.array_equal(np.asarray(jout[0]), act) and tout[5] is None and tout[6] is None
            for a, b in zip(jout[1:5], tout[1:5]):
                assert np.array_equal(np.asarray(a)[act], b.numpy()[act])
                assert not b.numpy()[~act].any()
        else:
            mask = rng.uniform(size=B) < 0.8
            o, d = (rng.normal(size=(B, 3)).astype(np.float32) for _ in range(2))
            c = rng.uniform(size=B).astype(np.float32)
            b = rng.integers(0, 9, size=B).astype(np.int32)
            jq, jd = jq.push(*map(jnp.asarray, (mask, o, d, c, b)))
            td = tq.push(*map(torch.from_numpy, (mask, o, d, c, b)))
            assert int(td) == int(jd)
        _queues_equal(jq, tq)
    with pytest.raises(ValueError):
        tq.push(torch.ones(B, dtype=torch.bool), torch.zeros(B, 3), torch.zeros(B, 3),
                torch.ones(B), torch.zeros(B, dtype=torch.int32), torch.ones(B))


@pytest.fixture(scope="module")
def iow4():
    js, jc = jex.iow_final_scene(side=4)
    ts, tc = _port_of(js, jc)
    size = dict(width=24, height=16, spp=2, max_bounces=8, intersector="pallas")
    return js, jc, ts, tc, _diff_cfg(RenderConfig(**size).for_scene(ts))


@pytest.mark.parametrize("early_exit", [False, True])
def test_trace_lanes_matches_jax(early_exit):
    """The gradient path's trace of ``materials_scene()`` (a glass sphere:
    the surrounding RI read by the containment sum on the pops that refract)
    on the same lanes, at ``test_torch_diff.py``'s size.  Found: equal
    counts, the colour within 2.1e-4 on 3 of 768 lanes and within 1e-5 on the
    rest, ``primary_t`` within 5.7e-5.  (On ``iow_final_scene`` the two
    packages' recomputes round apart on the 1000-radius ground sphere, as
    the parent commit's did: ``diff.train._probe_cfg``.)"""
    js, jc = jex.materials_scene()
    ts, _ = _port_of(js, jc)
    size = dict(width=24, height=16, spp=2, max_bounces=4, intersector="pallas")
    jcfg = dataclasses.replace(jdiff.train._diff_cfg(jrender.RenderConfig(**size).for_scene(js)),
                               early_exit=early_exit)
    tcfg = dataclasses.replace(_diff_cfg(RenderConfig(**size).for_scene(ts)),
                               early_exit=early_exit)
    assert tcfg.diff_mode and tcfg.has_dielectrics
    lanes = [np.array(x) for x in jrender._lane_inputs(jc, jcfg)]
    jcol, jt, jrays, jdrop, jk = jrender.trace_lanes(js, None, jcfg, *map(jnp.asarray, lanes),
                                                     return_pops=True)
    tcol, tt, trays, tdrop, tk = trender.trace_lanes(ts, None, tcfg,
                                                     *map(torch.from_numpy, lanes),
                                                     return_pops=True)
    for x in (trays, tdrop, tk):
        assert isinstance(x, torch.Tensor) and x.dim() == 0
    assert (int(trays), int(tdrop), int(tk)) == (int(jrays), int(jdrop), int(jk))
    assert (int(tk) == tcfg.pops) if not early_exit else (1 < int(tk) < tcfg.pops)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(tcol.numpy(), np.asarray(jcol), rtol=0, atol=5e-4)
    close = np.abs(tcol.numpy() - np.asarray(jcol)).max(axis=-1) <= 1e-5
    assert close.mean() >= 0.99


def test_ri_slots_pack_the_lanes_in_order(iow4):
    """The static packing of the lanes that read the surrounding RI gives
    what a dynamic compaction (``torch.nonzero``) gives, bit for bit, and
    lanes past the capacity read 1 while the count reports them."""
    _, _, ts, _, _ = iow4
    rng = np.random.default_rng(SEED)
    B = 300
    point = torch.from_numpy(rng.normal(scale=1.5, size=(B, 3)).astype(np.float32))
    tr = torch.from_numpy(rng.uniform(size=B).astype(np.float32))
    need = torch.from_numpy(rng.uniform(size=B) < 0.4)
    lanes = torch.nonzero(need)[:, 0]
    want = torch.ones(B).index_put((lanes,), trender._surrounding_ri(ts, None, point[lanes],
                                                                     tr[lanes]))
    assert float((want != 1.0).float().mean()) > 0.05  # points inside glass
    for cap in (None, B, lanes.numel(), lanes.numel() + 7):
        got, n = trender._ri_of_lanes(ts, None, point, tr, need, cap)
        assert int(n) == lanes.numel() and torch.equal(got, want), cap
    short, n = trender._ri_of_lanes(ts, None, point, tr, need, 10)
    assert int(n) == lanes.numel()
    assert torch.equal(short[lanes[:10]], want[lanes[:10]])
    assert bool((short[lanes[10:]] == 1.0).all())


class _NoHostReads(TorchDispatchMode):
    """Raises on every ATen operation that reads a tensor on the host or
    sizes its output by the data: ``_local_scalar_dense`` (``item``,
    ``int``, ``float``, ``bool``), ``nonzero`` (also behind boolean-mask
    indexing and one-argument ``torch.where``), ``masked_select``,
    ``unique``."""

    HOST = ("_local_scalar_dense", "nonzero", "masked_select", "_unique2", "unique_dim",
            "unique_consecutive")

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.__name__.split(".")[0] in self.HOST:
            raise AssertionError(f"a host read in the band: {func}")
        return func(*args, **(kwargs or {}))


def _raise(what):
    def fail(*args, **kwargs):
        raise AssertionError(f"a host read in the band: {what}")
    return fail


@pytest.mark.parametrize("soft", [0.0, 0.03])
def test_a_band_reads_nothing_on_the_host(iow4, monkeypatch, soft):
    """One band's trace and gradient (the glass scene, the gradient path's
    sphere sweep, hard and soft edges) with the host reads patched to raise:
    ``torch.Tensor.item``, ``tolist``, ``__bool__``, ``__int__``,
    ``__float__``, ``__index__``, ``numpy``, ``torch.nonzero`` and
    ``torch.Tensor.nonzero``, and under ``_NoHostReads`` every ATen operation
    that reads the host.  The step around it reads once, after its bands."""
    _, _, ts, tc, _ = iow4
    cfg = RenderConfig(width=24, height=16, spp=2, max_bounces=8, intersector="pallas",
                       soft_edges=soft).for_scene(ts)
    pert = ts.replace(color=ts.color * 0.8 + 0.1)
    p = diff.extract_params(pert)
    target = torch.zeros((16, 24, 3))
    pops = diff.probe_band_pops(pert, tc, cfg, 4, device=CPU)
    vg = diff.banded_value_and_grad(pert, tc, cfg, grad_bands=4, band_pops=pops, device=CPU)
    loss, grads = vg(p, target)
    deepest = max(range(4), key=lambda b: pops[b])
    for name in ("item", "tolist", "__bool__", "__int__", "__float__", "__index__", "numpy",
                 "nonzero"):
        monkeypatch.setattr(torch.Tensor, name, _raise(f"Tensor.{name}"))
    monkeypatch.setattr(torch, "nonzero", _raise("torch.nonzero"))
    with _NoHostReads():
        vg.last.band(deepest)
    monkeypatch.undo()
    assert vg.counts["ri_probes"] == 1 and int(vg.last.ri_max.max()) > 0
    assert np.isfinite(float(loss)) and all(bool(torch.isfinite(g).all()) for _, g in
                                            grads.items())


def test_a_forced_small_ri_capacity_overflows_and_is_recomputed(iow4):
    """Four slots for the lanes that read the surrounding RI are too few on
    the glass scene: the step sees the overflow, grows the slots and
    recomputes, and its loss and gradients equal the ample step's bit for
    bit.  A trace at four slots alone gives another picture: the overflow
    is never silent."""
    _, _, ts, tc, _ = iow4
    cfg = RenderConfig(width=24, height=16, spp=2, max_bounces=8,
                       intersector="pallas").for_scene(ts)
    pert = ts.replace(color=ts.color * 0.8 + 0.1)
    p = diff.extract_params(pert)
    target = torch.zeros((16, 24, 3))
    pops = diff.probe_band_pops(pert, tc, cfg, 2, device=CPU)
    ample = diff.banded_value_and_grad(pert, tc, cfg, grad_bands=2, band_pops=pops, device=CPU)
    small = diff.banded_value_and_grad(pert, tc, cfg, grad_bands=2, band_pops=pops,
                                       device=CPU)
    small.ri_slots = [(4,) * c.pops for c in small.bucket_cfgs]  # in place of the probe
    la, ga = ample(p, target)
    ls, gs = small(p, target)
    assert ample.counts["recomputes"] == 0 and ample.counts["ri_probes"] == 1
    assert small.counts["recomputes"] >= 1 and small.counts["ri_probes"] == 0
    assert min(min(x) for x in small.ri_slots) == 4  # only the pops that overflowed grew
    assert float(ls) == float(la)
    for name, g in ga.items():
        assert torch.equal(getattr(gs, name), g), name
    # the overflow itself: a trace at four slots
    dcfg = _diff_cfg(cfg)
    o, d, tr, sidx = (x.reshape((-1,) + x.shape[3:]) for x in _probe_lanes(tc, dcfg,
                                                                         torch.device(CPU)))
    accel = trender._build_accel(pert, dcfg)
    seen = torch.zeros((), dtype=torch.int64)
    cut = trender.trace_lanes(pert, None, dcfg, o, d, tr, sidx, accel, ri_lanes=4, ri_max=seen)
    full = trender.trace_lanes(pert, None, dcfg, o, d, tr, sidx, accel)
    assert int(seen) > 4 and not torch.equal(cut[0], full[0])


def test_launch_record_replays_what_was_captured():
    """``_build.LaunchRecord``: the counts a capture makes leave ``LAUNCHES``
    and come back on each replay, so a replayed step counts what an eager
    one launches.  The "graph" here replays a recorded list of wrapper
    calls; a wrapper counts where it launches."""
    def wrapper(name):
        _build.LAUNCHES[name] += 1

    class FakeGraph:
        def __init__(self):
            self.calls, self.replays = [], 0

        def replay(self):
            self.replays += 1

    _build.reset_launches()
    _build.LAUNCHES["sweep2"] += 5  # launched before the capture: stays
    graph, record = FakeGraph(), _build.LaunchRecord()
    with record.record():
        for name in ("sweep2", "sweep2", "sweep2_edge", "sweep2", "sweep2g"):
            wrapper(name)
            graph.calls.append(name)
    assert _build.LAUNCHES == collections.Counter({"sweep2": 5})
    assert record.counts == collections.Counter(graph.calls)
    for _ in range(3):
        record.replay(graph)
    assert graph.replays == 3
    assert _build.LAUNCHES == collections.Counter({"sweep2": 5 + 9, "sweep2_edge": 3,
                                                   "sweep2g": 3})
    _build.reset_launches()


def test_graph_key_sees_the_build_and_the_routing(iow4, monkeypatch):
    """A graph captured under one build or sweep routing is never replayed
    under another: both are in the graph's key."""
    _, _, ts, tc, _ = iow4
    cfg = RenderConfig(width=24, height=16, spp=2, max_bounces=8,
                       intersector="pallas").for_scene(ts)
    vg = diff.banded_value_and_grad(ts, tc, cfg, grad_bands=2, device=CPU)
    vg.ri_slots = [(64,) * c.pops for c in vg.bucket_cfgs]
    p = diff.extract_params(ts)
    accel = trender._build_accel(ts, _diff_cfg(cfg))
    dev = torch.device(CPU)
    key = vg._key(p, accel, dev)
    assert vg._key(p, accel, dev) == key
    with _build.forced_coop_min(1):
        assert vg._key(p, accel, dev) != key
    with _build.precise():
        assert vg._key(p, accel, dev) != key
    from raytracing_tests_tpu_torch.kernels import sweep2

    monkeypatch.setattr(sweep2, "_sweep2", lambda *a, **k: None)
    assert vg._key(p, accel, dev) != key


def test_a_trace_that_names_no_slots_gives_a_pop_its_live_lanes(iow4):
    """``trace_lanes`` with ``ri_lanes=None`` and the early exit on the glass
    scene's gradient path: each pop gives the lanes that read the
    surrounding RI the live lanes its condition counted, so none can exceed
    them.  Detached: the colour, counts and each pop's need equal those of
    every lane's slots, bit for bit.  Recorded by autograd: the colour and
    the scene's position gradient equal those of every lane's slots, bit for
    bit."""
    _, _, ts, tc, cfg = iow4
    assert cfg.early_exit
    pert = ts.replace(color=ts.color * 0.8 + 0.1)
    o, d, tr, sidx = (x.reshape((-1,) + x.shape[3:])
                      for x in _probe_lanes(tc, cfg, torch.device(CPU)))
    B = o.shape[0]
    accel = trender._build_accel(pert, cfg)
    with torch.no_grad():
        need, need_all = (torch.zeros(cfg.pops, dtype=torch.int64) for _ in range(2))
        got = trender.trace_lanes(pert, None, cfg, o, d, tr, sidx, accel, ri_max=need)
        want = trender.trace_lanes(pert, None, cfg, o, d, tr, sidx, accel, ri_lanes=B,
                                   ri_max=need_all)
    assert int(need.max()) > 0 and torch.equal(need, need_all)
    for a, b in zip(got, want):
        assert torch.equal(a, b)

    def traced(slots):
        leaves = diff.extract_params(pert).map(lambda v: v.clone().requires_grad_(True))
        scene = diff.apply_params(pert, leaves)
        color = trender.trace_lanes(scene, None, cfg, o, d, tr, sidx, accel, ri_lanes=slots)[0]
        (g,) = torch.autograd.grad(torch.sum(color * color), [leaves.position])
        return color.detach(), g

    color, g = traced(None)
    color_all, g_all = traced(B)
    assert torch.equal(color, color_all) and torch.equal(g, g_all) and bool(g.abs().max() > 0)
