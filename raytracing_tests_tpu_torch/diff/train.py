"""Gradient-based scene optimisation (inverse rendering).

Render -> L2 loss against a target image -> gradients with respect to
``SceneParams`` -> an Adam update.  The sweeps run as kernels on detached
inputs (``diff/fastpath.py``); autograd differentiates the closed-form
recompute and the shading in plain PyTorch.  On a mesh
(``parallel.make_mesh``) the forward is row-sharded
(``parallel.render_sharded``): with every shard in this process one autograd
graph spans the shards, and under a process group each rank differentiates
its own rows and the gradients are summed over the ranks (``all_reduce``),
the psum the JAX package's ``shard_map`` transpose gives.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from raytracing_tests_tpu_torch.diff.params import SceneParams, apply_params, extract_params
from raytracing_tests_tpu_torch.kernels import _build
from raytracing_tests_tpu_torch.kernels.sweep2 import refresh_live_rows
from raytracing_tests_tpu_torch.ops.camera_rays import primary_rays
from raytracing_tests_tpu_torch.ops.render import (
    RenderConfig, _build_accel, finalize, render, trace_lanes,
)
from raytracing_tests_tpu_torch.scene.types import Camera, Scene
from raytracing_tests_tpu_torch.utils.device import resolve_device

REPROBE_EVERY = 25  # auto_pops: steps between re-probes of the band depths
POPS_MARGIN = 2  # auto_pops: pops added to each probed band depth


def _diff_cfg(cfg: RenderConfig) -> RenderConfig:
    """Gradient-rendering config: validate, and route the ``pallas``
    intersector to the fast gradient path (``diff_mode``).  The ``brute``
    intersector differentiates as it is; PyTorch's tape takes the early exit,
    so the config keeps it.  The ``bvh`` intersector is routed to ``brute``,
    as the JAX package routes it: the lockstep LBVH walk would put its
    thousands of steps on the autograd tape, and the dense sweep gives the
    same outputs."""
    from raytracing_tests_tpu_torch.diff.fastpath import fastpath_eligible

    if cfg.soft_edges > 0.0 and cfg.intersector != "pallas":
        # No other path implements the estimator: ignoring the flag would hand
        # back the biased silhouette gradients it exists to fix.
        raise ValueError(
            "soft_edges requires the fast gradient path (intersector='pallas'); "
            "both scene modes are supported")
    if fastpath_eligible(cfg):
        return dataclasses.replace(cfg, diff_mode=True)
    if cfg.intersector == "bvh":
        return dataclasses.replace(cfg, intersector="brute")
    return cfg


def _home(mesh, device) -> torch.device:
    """Where the loss and the parameters live: ``device``, or with a mesh and
    no device, the mesh's first device of this process; ``None`` without a
    mesh means the GPU."""
    if device is None and mesh is not None:
        return mesh.home
    return resolve_device(device)


def render_loss(params: SceneParams, template: Scene, camera: Camera, cfg: RenderConfig,
                target, mesh=None, lights=None, device=None):
    """Mean squared pixel error of the render against ``target`` (H, W, 3).
    ``device=None`` means the GPU (with a mesh: the mesh's first device).

    ``mesh``: the forward is ``parallel.render_sharded``.  With every shard in
    this process the loss's graph spans them all.  Under a process group the
    value is the global loss on every rank (the ranks' squared-error sums,
    all-reduced), but its graph holds this rank's rows only: its gradient is
    this rank's share, which ``value_and_grad_loss`` sums over the ranks.
    (A differentiable gather of the image would count every pixel world-size
    times, each rank holding the same loss.)"""
    cfg = _diff_cfg(cfg)
    dev = _home(mesh, device)
    scene = apply_params(template, params)
    target = torch.as_tensor(target, dtype=torch.float32, device=dev)
    if mesh is None:
        out = render(scene, camera, cfg, lights, device=dev)
        return torch.mean((out["image"] - target) ** 2)
    from raytracing_tests_tpu_torch.parallel.render_sharded import (
        render_sharded, trace_shards)

    if not mesh.distributed:
        out = render_sharded(scene, camera, cfg, mesh, lights)
        return torch.mean((out["image"].to(dev) - target) ** 2)
    from raytracing_tests_tpu_torch.parallel.mesh import ROWS_AXIS, shard_rows

    (shard, colors, primary_t, _, _), = trace_shards(scene, camera, cfg, mesh, lights)
    rows = torch.from_numpy(shard_rows(cfg.height, mesh.shape[ROWS_AXIS], shard)).to(dev)
    img = finalize(colors, primary_t, cfg)["image"].to(dev)
    mine = torch.sum((img - target[rows]) ** 2) / target.numel()
    total = mine.detach().clone()
    torch.distributed.all_reduce(total, group=mesh.group)
    return total + (mine - mine.detach())  # the value is total's, bit for bit


def _leaves(params: SceneParams, device):
    """Fresh autograd leaves of ``params`` on ``device``."""
    return params.map(lambda v: v.detach().to(device).requires_grad_(True))


def _grads_of(value, leaves: SceneParams, accumulate: Optional[SceneParams] = None):
    """d value / d leaves as a ``SceneParams`` (zeros where unused), added to
    ``accumulate`` when given.  Each gradient is its own contiguous tensor:
    autograd hands the fields of the gradient path's packed table
    (``kernels.gather.winner_table``) back as strided views of one buffer,
    and an ``all_reduce`` takes contiguous tensors only."""
    names = [n for n, _ in leaves.items()]
    tensors = [v for _, v in leaves.items()]
    got = torch.autograd.grad(value, tensors, allow_unused=True)
    got = {n: torch.zeros_like(t) if g is None else g.contiguous()
           for n, t, g in zip(names, tensors, got)}
    if accumulate is not None:
        got = {n: getattr(accumulate, n) + g for n, g in got.items()}
    return leaves.replace(**got)


def value_and_grad_loss(params: SceneParams, template: Scene, camera: Camera,
                        cfg: RenderConfig, target, mesh=None, lights=None, device=None):
    """(loss, grads) of ``render_loss`` by autograd over the whole frame.

    Under a process group (``mesh.distributed``) each rank's gradient is its
    own rows' share; they are summed over the ranks (``all_reduce``), so every
    rank returns the global loss and gradient."""
    dev = _home(mesh, device)
    leaves = _leaves(params, dev)
    loss = render_loss(leaves, template, camera, cfg, target, mesh, lights, dev)
    grads = _grads_of(loss, leaves)
    if mesh is not None and mesh.distributed:
        for _, g in grads.items():
            torch.distributed.all_reduce(g, group=mesh.group)
    return loss.detach(), grads


def _probe_lanes(camera, cfg, dev):
    H, W, S = cfg.height, cfg.width, cfg.spp
    o, d, tr = primary_rays(camera.to(dev), W, H, S)
    sidx = torch.arange(S, dtype=torch.float32, device=dev).expand(H, W, S)
    return o, d, tr, sidx


def _probe_cfg(cfg):
    """The gradient path's own forward, with the early exit: the probe counts
    the pops of exactly the trees the gradient traces.  (The JAX package
    probes with its forward renderer, whose trees can be shallower: on a
    1000-radius ground sphere the closed-form recompute and the sweep's
    refine round apart, and a band's recomputed trees can run deeper than
    the forward's.)"""
    return dataclasses.replace(_diff_cfg(cfg), early_exit=True)


@torch.no_grad()
def probe_max_pops(scene: Scene, camera: Camera, cfg: RenderConfig, lights=None,
                   device=None) -> int:
    """Pop steps the deepest ray tree of this (scene, camera, cfg) needs: the
    early-exit step count of the gradient path's forward over the full frame
    (detached).

    A gradient step over ``min(probed, cfg.pops)`` pops is EXACT for this
    scene: the steps cut would pop empty queues.  Training moves the scene, so
    ``make_train_step(auto_pops=True)`` adds a margin and re-probes."""
    cfg = _probe_cfg(cfg)
    dev = resolve_device(device)
    scene, lights = scene.to(dev), None if lights is None else lights.to(dev)
    o, d, tr, sidx = _probe_lanes(camera, cfg, dev)
    flat = lambda x: x.reshape((-1,) + x.shape[3:])
    accel = _build_accel(scene, cfg)
    return int(trace_lanes(scene, lights, cfg, flat(o), flat(d), flat(tr), flat(sidx),
                           accel, return_pops=True)[4])


@torch.no_grad()
def probe_band_pops(scene: Scene, camera: Camera, cfg: RenderConfig, grad_bands: int,
                    lights=None, device=None) -> list:
    """``probe_max_pops`` per row band: the true max ray-tree depth of each of
    ``grad_bands`` bands.  Sky-only bands measure 1; glass-heavy bands run to
    the budget — ``banded_value_and_grad(band_pops=...)`` buckets the bands by
    these depths so shallow bands stop paying the deepest band's length."""
    cfg = _probe_cfg(cfg)
    H, W, S = cfg.height, cfg.width, cfg.spp
    assert H % grad_bands == 0, (H, grad_bands)
    h = H // grad_bands
    dev = resolve_device(device)
    scene, lights = scene.to(dev), None if lights is None else lights.to(dev)
    o, d, tr, sidx = _probe_lanes(camera, cfg, dev)
    flat = lambda x: x.reshape((h * W * S,) + x.shape[3:])
    accel = _build_accel(scene, cfg)
    out = []
    for b in range(grad_bands):
        sl = slice(b * h, (b + 1) * h)
        out.append(int(trace_lanes(scene, lights, cfg, flat(o[sl]), flat(d[sl]),
                                   flat(tr[sl]), flat(sidx[sl]), accel,
                                   return_pops=True)[4]))
    return out


def _buckets(band_pops, grad_bands: int, pops: int):
    """Group bands into at most 3 buckets by probed depth: [(ceiling, bands)]."""
    assert len(band_pops) == grad_bands, (len(band_pops), grad_bands)
    caps = np.minimum(np.asarray(band_pops, np.int64), pops)
    ceilings = sorted(set(int(c) for c in caps))
    while len(ceilings) > 3:  # merge the two closest ceilings
        i = int(np.argmin(np.diff(ceilings)))
        ceilings.pop(i)  # the bands under the removed ceiling run deeper
    buckets, prev = [], 0
    for ceil in ceilings:
        idxs = tuple(b for b in range(grad_bands) if prev < caps[b] <= ceil)
        if idxs:
            buckets.append((ceil, idxs))
        prev = ceil
    return buckets


def _ri_slots(n: int, lanes: int) -> int:
    """Slots for a pop whose probe counted ``n`` lanes that read the
    surrounding RI (``ops.render._ri_of_lanes``): a quarter more and 1024,
    since training moves the scene the probe saw, in multiples of 1024, at
    most ``lanes``."""
    return min(lanes, -(-(n + n // 4 + 1024) // 1024) * 1024)


def _grown_ri_slots(need, slots, lanes: int) -> tuple:
    """Each pop's ``slots`` where its ``need`` fitted, else ``_ri_slots`` of
    the larger of ``need`` and one more than it had."""
    return tuple(s if n <= s else _ri_slots(max(n, s + 1), lanes) for n, s in zip(need, slots))


def _sweep_routing() -> tuple:
    """The sweep, winner-gather, recompute, containment-sum, shading and
    queue wrappers the gradient path calls, as bound now (a test or a
    measurement may route them to their plain versions): part of a CUDA
    graph's key."""
    from raytracing_tests_tpu_torch.kernels import (
        gather, queue, recompute, ri_sum, shade, sweep2, sweep2g,
    )

    return (sweep2._sweep2, sweep2._sweep2_edge, sweep2g._sweep2g, sweep2g._sweep2g_edge,
            gather._gather, gather._scatter, recompute._recompute, recompute._recompute_grad,
            ri_sum._ri_sum, ri_sum._ri_sum_grad, shade._shade, shade._shade_grad,
            queue.pop, queue.push2, queue._pop, queue._push2, queue._pop_grad,
            queue._push2_grad)


def _band(tmpl, leaves, lights, cfg, slots, accel, lanes, tgt, acc, sse, ri_max):
    """One row band's forward and backward: its squared error against
    ``tgt`` (h, W, 3) added to ``sse`` and its gradient with respect to
    ``leaves`` to ``acc`` (in place, in field order), the most lanes each pop
    read the surrounding RI for to ``ri_max`` (one entry a pop) with
    ``slots`` (one count a pop) for them.  Static shapes and no host
    read, so it runs the same eagerly and inside a CUDA graph."""
    scene = apply_params(tmpl, leaves)
    h, W, S = tgt.shape[0], cfg.width, cfg.spp
    color, primary_t, _, _ = trace_lanes(scene, lights, cfg, *lanes, accel, ri_lanes=slots,
                                         ri_max=ri_max)
    img = finalize(color.reshape(h, W, S, 3), primary_t.reshape(h, W, S), cfg)["image"]
    s_b = torch.sum((img - tgt) ** 2)
    got = torch.autograd.grad(s_b, [v for _, v in leaves.items()], allow_unused=True)
    with torch.no_grad():
        for a, g in zip(acc, got):
            if g is not None:
                a.add_(g)
        sse.add_(s_b)


class _Bands:
    """How ``BandedValueAndGrad`` cuts the frame: the row bands, their depth
    buckets and each bucket's config (its ceiling of pops, no early exit)."""

    def __init__(self, cfg, grad_bands: int, band_pops):
        H, W, S = cfg.height, cfg.width, cfg.spp
        assert H % grad_bands == 0, (H, grad_bands)
        self.h = H // grad_bands
        self.lanes_per_band = self.h * W * S
        if band_pops is None:
            self.buckets = [(None, tuple(range(grad_bands)))]
        else:
            self.buckets = _buckets(band_pops, grad_bands, cfg.pops)
        # A band runs its bucket's pops without the early exit, as the JAX
        # package's scan does: no host read (the steps past the deepest tree
        # pop nothing and add exact zeros).
        scan = dataclasses.replace(cfg, early_exit=False)
        self.bucket_cfgs = [scan if ceil is None else dataclasses.replace(scan, max_pops=ceil)
                            for ceil, _ in self.buckets]
        self.bucket_of = {b: k for k, (_, idxs) in enumerate(self.buckets) for b in idxs}

    def ri_counter(self, dev):
        """Zeros (buckets, pops of the deepest bucket) int64: what a step's
        pops needed, bucket by bucket and pop by pop."""
        return torch.zeros((len(self.buckets), max(c.pops for c in self.bucket_cfgs)),
                           dtype=torch.int64, device=dev)

    def band_lanes(self, lanes, b: int):
        sl = slice(b * self.lanes_per_band, (b + 1) * self.lanes_per_band)
        return tuple(x[sl] for x in lanes)

    def band_rows(self, tgt, b: int):
        return tgt[b * self.h:(b + 1) * self.h]


class _EagerStep:
    """One step of ``BandedValueAndGrad`` band after band, eagerly: the CPU's
    path, and the card's with ``graphs=False``."""

    def __init__(self, bands, slots, params, accel, tmpl, lights, lanes, tgt, dev):
        self.bands, self.accel, self.tmpl, self.lights = bands, accel, tmpl, lights
        self.ri_slots, self.lanes, self.tgt = slots, lanes, tgt
        self.leaves = _leaves(params, dev)
        self.acc = [torch.zeros_like(v) for _, v in self.leaves.items()]
        self.sse = torch.zeros((), dtype=torch.float32, device=dev)
        self.ri_max = bands.ri_counter(dev)

    def band(self, b: int) -> None:
        """Band ``b`` once more, added to this step's sums."""
        k = self.bands.bucket_of[b]
        _band(self.tmpl, self.leaves, self.lights, self.bands.bucket_cfgs[k],
              self.ri_slots[k], self.accel, self.bands.band_lanes(self.lanes, b),
              self.bands.band_rows(self.tgt, b), self.acc, self.sse, self.ri_max[k])

    def run(self) -> None:
        for _, idxs in self.bands.buckets:
            for b in idxs:
                self.band(b)


class _GraphedStep:
    """The step as one captured CUDA graph per depth bucket, each replayed
    once per band of its bucket.

    Everything a graph reads lives in tensors made here: the leaves (each
    step's parameters are copied in), the accel (each step's tables are
    copied into its storage, and the tables derived from it renewed in
    theirs: ``sweep2.refresh_live_rows``, ``edge_cull.edge_blocks_as``), a
    band's lanes and target rows (copied in before each replay), and the
    sums.  ``key`` names all that a graph bakes in: the device, the build,
    the sweep routing, the accel's host statics and table shapes, the
    silhouette block table's shape, the parameters' shapes and the RI slots.
    The graphs share one memory pool and replay in capture order."""

    def __init__(self, bands, slots, key, params, accel, tmpl, lights, lanes, tgt, dev):
        self.bands, self.key, self.tmpl, self.lights = bands, key, tmpl, lights
        self.src = (lanes, tgt)
        self.ri_slots = list(slots)
        with torch.no_grad():
            self.leaves = params.map(lambda v: v.detach().to(dev).clone().requires_grad_(True))
            inner = accel.inner
            self.inner = dataclasses.replace(inner, **{
                f.name: getattr(inner, f.name).clone() for f in dataclasses.fields(inner)
                if isinstance(getattr(inner, f.name), torch.Tensor)})
        self.accel = type(accel)(self.inner)
        n = bands.lanes_per_band
        self.lanes = tuple(torch.empty((n,) + x.shape[1:], dtype=x.dtype, device=dev)
                           for x in lanes)
        self.tgt = torch.empty((bands.h,) + tuple(tgt.shape[1:]), dtype=tgt.dtype, device=dev)
        self.acc = [torch.zeros_like(v) for _, v in self.leaves.items()]
        self.sse = torch.zeros((), dtype=torch.float32, device=dev)
        self.ri_max = bands.ri_counter(dev)
        # Warm-up on a side stream (PyTorch's graph documentation): one band
        # of each bucket, eagerly, which also builds every kernel and the
        # tables derived from the accel before any capture.
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            for k, (_, idxs) in enumerate(bands.buckets):
                self._load_band(idxs[0])
                self._body(k)
        torch.cuda.current_stream(dev).wait_stream(side)
        pool = torch.cuda.graph_pool_handle()
        self.graphs = []
        for k in range(len(bands.buckets)):
            graph, record = torch.cuda.CUDAGraph(), _build.LaunchRecord()
            with record.record(), torch.cuda.graph(graph, pool=pool):
                self._body(k)
            self.graphs.append((graph, record))

    def release(self) -> None:
        """Drop the graphs and give their memory back to the card.  A
        deleted graph's private pool stays cached in PyTorch's allocator
        until an allocation runs short and frees every cached block at once,
        which stalls some later, unrelated launch.  ``torch.cuda.empty_cache``
        frees it now; it also returns the process's other unused cached
        blocks, which the next allocations then take from the card again."""
        if self.graphs:
            self.graphs.clear()
            torch.cuda.synchronize(self.sse.device)
            torch.cuda.empty_cache()

    def _body(self, k: int) -> None:
        _band(self.tmpl, self.leaves, self.lights, self.bands.bucket_cfgs[k], self.ri_slots[k],
              self.accel, self.lanes, self.tgt, self.acc, self.sse, self.ri_max[k])

    def _load_band(self, b: int) -> None:
        lanes, tgt = self.src
        for mine, x in zip(self.lanes, self.bands.band_lanes(lanes, b)):
            mine.copy_(x)
        self.tgt.copy_(self.bands.band_rows(tgt, b))

    @torch.no_grad()
    def load(self, params, accel) -> bool:
        """This step's parameters and accel into the graphs' tensors; False
        where the silhouette block table no longer fits (capture again)."""
        for (_, mine), (_, v) in zip(self.leaves.items(), params.items()):
            mine.copy_(v)
        inner = accel.inner
        for f in dataclasses.fields(inner):
            v = getattr(inner, f.name)
            if isinstance(v, torch.Tensor):
                getattr(self.inner, f.name).copy_(v)
        refresh_live_rows(self.inner)
        if "_edge_blocks" in self.inner.__dict__:
            from raytracing_tests_tpu_torch.kernels.edge_cull import edge_blocks_as

            return edge_blocks_as(self.inner, inner)
        return True

    def zero(self) -> None:
        for a in self.acc:
            a.zero_()
        self.sse.zero_()
        self.ri_max.zero_()

    def band(self, b: int) -> None:
        """Band ``b`` once more (one replay), added to this step's sums."""
        graph, record = self.graphs[self.bands.bucket_of[b]]
        self._load_band(b)
        record.replay(graph)

    def run(self) -> None:
        for _, idxs in self.bands.buckets:
            for b in idxs:
                self.band(b)


class BandedValueAndGrad:
    """``banded_value_and_grad``'s function: ``f(params, target) -> (loss,
    grads)``.

    Each row band's trace has static shapes and reads nothing on the host
    (``ops.render.trace_lanes`` without the early exit), so on the card each
    depth bucket's band -- forward, backward and the sums -- is one captured
    CUDA graph, replayed once per band of the bucket: what ``jax.jit`` makes of
    the JAX package's step.  On the CPU, or with ``graphs=False``, the same
    code runs eagerly.  A capture that fails raises; nothing falls back.

    The accel is built once a step, outside the bands, from the detached
    scene.  The lanes that read the surrounding RI by the containment sum get
    ``ri_slots[k][i]`` slots in pop ``i`` of bucket ``k``: the first call
    probes the most that pop of the bucket's bands needs (the gradient path's
    own forward, once) and adds a margin (``_ri_slots``).  Each step reads
    one thing on the host, after its bands: the most lanes each pop needed
    in each bucket.  Where that exceeds the slots, the excess lanes read 1,
    so those slots grow (``_grown_ri_slots``), the graphs are captured again
    and the step is recomputed.  ``counts``
    tallies the probes, captures and recomputes; ``last`` is the last step
    (``last.band(b)`` runs band ``b`` again, for measurement).  ``release()``
    drops the graphs and their memory; a new capture releases the old
    graphs first."""

    def __init__(self, template, camera, cfg, lights, grad_bands, band_pops, device,
                 graphs: bool):
        self.template, self.camera, self.cfg, self.lights = template, camera, cfg, lights
        self.device, self.graphs, self.grad_bands = device, graphs, grad_bands
        self.bands = _Bands(cfg, grad_bands, band_pops)
        self.buckets, self.bucket_cfgs = self.bands.buckets, self.bands.bucket_cfgs
        self.bucket_of = self.bands.bucket_of
        self.ri_slots = None  # probed by the first call
        self.counts = collections.Counter()
        self.last = None
        self._on = None  # (device, template, lights, whole-frame lanes) there


    def _inputs(self, dev):
        """The template, lights and every lane of the frame on ``dev``, made
        once: nothing of them changes between steps."""
        if self._on is None or self._on[0] != dev:
            o, d, tr, sidx = _probe_lanes(self.camera, self.cfg, dev)
            flat = lambda x: x.reshape((-1,) + x.shape[3:])  # noqa: E731
            self._on = (dev, self.template.to(dev),
                        None if self.lights is None else self.lights.to(dev),
                        tuple(flat(x) for x in (o, d, tr, sidx)))
        return self._on[1:]

    @torch.no_grad()
    def _probe_ri(self, scene, lights, lanes, accel) -> list:
        """Slots for each pop of each bucket: the most lanes that pop of its
        bands needs, by the gradient path's own forward with the early exit."""
        if not self.cfg.has_dielectrics or self.cfg.shading == "materials":
            return [(0,) * c.pops for c in self.bucket_cfgs]  # no lane reads it
        self.counts["ri_probes"] += 1
        need = self.bands.ri_counter(lanes[0].device)
        for k, (_, idxs) in enumerate(self.buckets):
            probe = dataclasses.replace(self.bucket_cfgs[k], early_exit=True)
            for b in idxs:
                trace_lanes(scene, lights, probe, *self.bands.band_lanes(lanes, b), accel,
                            ri_max=need[k])
        return [tuple(_ri_slots(n, self.bands.lanes_per_band) for n in row[:c.pops])
                for row, c in zip(need.tolist(), self.bucket_cfgs)]

    def _key(self, params, accel, dev) -> tuple:
        inner = accel.inner
        tables = tuple((f.name, (tuple(v.shape), v.dtype) if isinstance(v, torch.Tensor) else v)
                       for f in dataclasses.fields(inner) for v in (getattr(inner, f.name),))
        edge = None
        if self.cfg.soft_edges > 0.0 and inner.mode == "generic":
            from raytracing_tests_tpu_torch.kernels.edge_cull import edge_blocks

            table, n_super = edge_blocks(inner)
            edge = (tuple(table.shape), n_super)
        return (dev, _build.variant(), _sweep_routing(), tables, edge,
                tuple((n, tuple(v.shape), v.dtype) for n, v in params.items()),
                tuple(self.ri_slots))

    def _graphed(self, params, accel, tmpl, lights, lanes, tgt, dev) -> _GraphedStep:
        key = self._key(params, accel, dev)
        step = self.last if isinstance(self.last, _GraphedStep) else None
        if step is None or step.key != key or not step.load(params, accel):
            self.release()  # the old graphs and their pool go first
            step = self.last = _GraphedStep(self.bands, self.ri_slots, key, params, accel,
                                            tmpl, lights, lanes, tgt, dev)
            self.counts["captures"] += 1
        step.src = (lanes, tgt)
        step.zero()
        step.run()
        return step

    def release(self) -> None:
        """Drop the last step and, graphed, its graphs and their memory
        (``_GraphedStep.release``)."""
        if isinstance(self.last, _GraphedStep):
            self.last.release()
        self.last = None

    def __call__(self, params: SceneParams, target):
        dev = resolve_device(self.device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        tmpl, lights, lanes = self._inputs(dev)
        tgt = torch.as_tensor(target, dtype=torch.float32, device=dev)
        with torch.no_grad():
            scene = apply_params(tmpl, params.map(lambda v: v.detach().to(dev)))
            accel = _build_accel(scene, self.cfg)
            if self.ri_slots is None:
                self.ri_slots = self._probe_ri(scene, lights, lanes, accel)
        while True:
            if self.graphs and dev.type == "cuda":
                step = self._graphed(params, accel, tmpl, lights, lanes, tgt, dev)
            else:
                step = self.last = _EagerStep(self.bands, self.ri_slots, params, accel, tmpl,
                                              lights, lanes, tgt, dev)
                step.run()
            need = step.ri_max.tolist()  # the step's one host read
            grown = [_grown_ri_slots(row, slots, self.bands.lanes_per_band)
                     for row, slots in zip(need, self.ri_slots)]
            if grown == self.ri_slots:
                break
            self.ri_slots = grown
            self.counts["recomputes"] += 1
        n = self.cfg.height * self.cfg.width * 3
        return step.sse / n, step.leaves.replace(**{
            name: a / n for (name, _), a in zip(step.leaves.items(), step.acc)})


def banded_value_and_grad(template: Scene, camera: Camera, cfg: RenderConfig,
                          lights=None, grad_bands: int = 8, grad_pops: Optional[int] = None,
                          band_pops=None, device=None,
                          graphs: bool = True) -> BandedValueAndGrad:
    """Gradient ACCUMULATION over image row bands: ``f(params, target) ->
    (loss, grads)``, equal to ``value_and_grad_loss`` (the MSE is a pixel
    mean, so the bands' squared-error sums add up to it) at 1/``grad_bands``
    of the backward's peak memory: each band's graph is freed before the next
    band is traced.

    ``grad_pops``: a probed scan length (``probe_max_pops``), exact when at
    least the scene's true depth; ``cfg.pops`` clamps it.  ``band_pops``: each
    band's probed depth (``probe_band_pops``): the bands are grouped into at
    most 3 buckets, each traced at its own ceiling.  The accel depends only on
    the detached scene, so one is built per call and shared by the bands.

    On the card each bucket's band is one captured CUDA graph
    (``BandedValueAndGrad``); ``graphs=False`` runs the same static bands
    eagerly there (to compare the two)."""
    cfg = _diff_cfg(cfg)
    if grad_pops is not None:
        cfg = dataclasses.replace(cfg, max_pops=min(int(grad_pops), cfg.pops))
    return BandedValueAndGrad(template, camera, cfg, lights, grad_bands, band_pops, device,
                              graphs)


def adam(learning_rate: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
    """The optimiser of ``TrainState`` / ``make_train_step``:
    ``torch.optim.Adam`` with ``optax.adam``'s parameters (its ``eps`` is
    added to the bias-corrected root, as optax's is)."""
    return functools.partial(torch.optim.Adam, lr=learning_rate, betas=(b1, b2), eps=eps)


_ADAM_KEYS = ("step", "exp_avg", "exp_avg_sq")


@dataclasses.dataclass
class TrainState:
    """Scene parameters, the optimiser over them, and the step count.

    ``params`` holds plain tensors (the optimiser's leaves); the optimiser's
    state is made at creation (Adam's step and both moments per field), so a
    fresh state and one after any number of steps have the same leaves —
    ``app.checkpoint`` saves and restores them."""

    params: SceneParams
    optimizer: torch.optim.Optimizer
    step: int = 0

    @classmethod
    def create(cls, scene: Scene, optimizer, device=None) -> "TrainState":
        dev = resolve_device(device)
        params = extract_params(scene).map(lambda v: v.detach().to(dev).clone())
        return cls(params=params, optimizer=_make_optimizer(optimizer, params), step=0)

    @property
    def opt_state(self) -> dict:
        """Field name -> {'step', 'exp_avg', 'exp_avg_sq'} of the optimiser."""
        return {n: self.optimizer.state[v] for n, v in self.params.items()}

    def tree_flatten(self):
        return [self.params, [{k: s[k] for k in _ADAM_KEYS} for s in self.opt_state.values()],
                self.step]

    def tree_unflatten(self, children):
        params, opt_state, step = children
        optimizer = _make_optimizer(self.optimizer.defaults, params)
        for (_, v), s in zip(params.items(), opt_state):
            for k in _ADAM_KEYS:
                optimizer.state[v][k].copy_(s[k])
        return TrainState(params=params, optimizer=optimizer, step=int(step))


def _make_optimizer(spec, params: SceneParams) -> torch.optim.Optimizer:
    """An Adam over ``params`` with its state made now.  ``spec``: what
    ``adam`` returns, or an optimiser's ``defaults``."""
    tensors = [v for _, v in params.items()]
    if isinstance(spec, dict):
        spec = functools.partial(torch.optim.Adam, **{
            k: spec[k] for k in ("lr", "betas", "eps")})
    opt = spec(tensors)
    if not isinstance(opt, torch.optim.Adam):
        raise TypeError(f"TrainState takes an Adam (see diff.train.adam), got {type(opt)}")
    for v in tensors:
        # Adam's own lazy initialisation, done now: a CPU float step and
        # zero moments.
        opt.state[v] = {"step": torch.zeros((), dtype=torch.float32),
                        "exp_avg": torch.zeros_like(v, memory_format=torch.preserve_format),
                        "exp_avg_sq": torch.zeros_like(v, memory_format=torch.preserve_format)}
    return opt


def make_train_step(template: Scene, camera: Camera, cfg: RenderConfig, optimizer=None,
                    mesh=None, lights=None, trainable: Optional[SceneParams] = None,
                    grad_bands: int = 1, auto_pops: bool = False, device=None):
    """The training step: value and gradient -> masked gradient -> Adam.

    Returns ``step(state, target) -> (state, loss)``; the state's tensors are
    updated in place and returned in a new ``TrainState``.  ``optimizer`` is
    what ``adam`` returns and must be the one the state was created with.

    ``trainable`` optionally masks which fields update (a ``SceneParams`` of
    0/1 tensors, multiplied into the gradients before the update).  Autograd
    through the renderer differentiates the smooth shading only; silhouette
    jumps are invisible to it unless ``cfg.soft_edges > 0``, so geometry sees
    biased gradients near edges.

    ``grad_bands > 1`` accumulates the gradient over image row bands
    (``banded_value_and_grad``): the same loss and gradients at 1/bands of the
    backward's peak memory — what a full-resolution frame needs.  The banded
    function is kept across steps, so on the card its CUDA graphs are
    captured once and replayed every step after (Adam writes the parameters
    in place; each step copies them into the graphs' leaves).  Single
    device only, as in the JAX package: with a ``mesh`` (the sharded step,
    ``value_and_grad_loss(mesh=)``) it is refused, and so is ``auto_pops``,
    which needs bands.

    ``auto_pops`` (banded only): probe each band's depth with the early-exit
    forward and trace the bands at those depths + 2.  Training can DEEPEN ray
    trees (an object turning reflective opens spawn gates the probe saw
    closed), which would truncate the cut traces, so the step re-probes the
    current params every ``REPROBE_EVERY`` (25) steps and rebuilds the buckets
    when a band outgrew its margin (``step.pops_state``)."""
    if mesh is not None and grad_bands > 1:
        raise ValueError("grad_bands composes with single-device only (mesh=None)")
    if auto_pops and grad_bands <= 1:
        raise ValueError(
            "auto_pops requires grad_bands > 1 (the probed depths are per row "
            "band; pass e.g. grad_bands=8)")
    pops_state = {"band_pops": None, "since": 0}
    vg = None
    if grad_bands > 1:
        if auto_pops:
            pops_state["band_pops"] = [p + POPS_MARGIN for p in probe_band_pops(
                template, camera, cfg, grad_bands, lights, device)]
        vg = banded_value_and_grad(template, camera, cfg, lights, grad_bands=grad_bands,
                                   band_pops=pops_state["band_pops"], device=device)
    vg_box = [vg]  # the re-probe swaps the closure in place

    def step(state: TrainState, target):
        if auto_pops:
            pops_state["since"] += 1
            if pops_state["since"] >= REPROBE_EVERY:
                pops_state["since"] = 0
                fresh = probe_band_pops(apply_params(template, state.params), camera, cfg,
                                        grad_bands, lights, device)
                if any(f > b for f, b in zip(fresh, pops_state["band_pops"])):
                    pops_state["band_pops"] = [p + POPS_MARGIN for p in fresh]
                    vg_box[0].release()
                    vg_box[0] = banded_value_and_grad(
                        template, camera, cfg, lights, grad_bands=grad_bands,
                        band_pops=pops_state["band_pops"], device=device)
        if vg_box[0] is not None:
            loss, grads = vg_box[0](state.params, target)
        else:
            loss, grads = value_and_grad_loss(state.params, template, camera, cfg, target,
                                              mesh, lights, device)
        if trainable is not None:
            grads = grads.replace(**{
                n: g * torch.as_tensor(getattr(trainable, n), dtype=g.dtype, device=g.device)
                for n, g in grads.items()})
        for (_, v), (_, g) in zip(state.params.items(), grads.items()):
            v.grad = g.to(v.device)
        state.optimizer.step()
        state.optimizer.zero_grad(set_to_none=True)
        return (TrainState(params=state.params, optimizer=state.optimizer,
                           step=state.step + 1), loss)

    step.pops_state = pops_state  # test / introspection hook
    step.value_and_grad = lambda: vg_box[0]  # the banded function in use (or None)
    return step
