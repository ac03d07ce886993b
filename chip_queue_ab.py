"""The queue renderer's forward frames, the unbanded and the banded gradient
steps and the two chunked renderers' headline frames of several checkouts of
the port, side by side on one NVIDIA GPU: wall time and the device time of
every kernel.

Run from the repository root, with each checkout's root as an argument:

    python3 chip_queue_ab.py _parent/base . . _parent/base
    python3 chip_queue_ab.py --only megalanes_natural,megalanes_sorted,workqueue_frame \
        _parent/base . . _parent/base

Each argument runs in a process of its own, in the order given (alternate
them: parent, change, change, parent), and imports
``raytracing_tests_tpu_torch`` from that root, whose kernels it builds from
that root's sources.  Workloads, at the sizes ``chip_smoke.py`` drives them:

- ``bvh_queue_frame``: ``render_stats`` of ``bvh_grid_scene(side=32)``,
  800x450x16 spp, depth 8, intersector "pallas" (K5);
- ``dense_generic_frame``: the same with ``pallas_groups=0`` (K4);
- ``unbanded_step``: ``diff.value_and_grad_loss`` of ``iow_final_scene()``
  at 800x450x2 spp, depth 8, colours perturbed (K2);
- ``sharded_step``: the same on 3 virtual shards of the one card
  (``make_mesh(devices=[dev] * 3)``);
- ``megalanes_natural``, ``megalanes_sorted``: ``render_megalanes`` of
  ``iow_final_scene()`` at 800x450x100 spp, depth 8, ``gr=64``, chunks of
  2^20 lanes, in each schedule (K6, and the drain kernel where the checkout
  has one);
- ``workqueue_frame``: ``render_workqueue`` of the same frame (K2), as the
  checkout runs it by default;
- ``megalanes_motion``: ``render_megalanes`` of ``motion_blur_scene()`` at
  800x450x16 spp, depth 8, sorted (K6's MOTION instantiation);
- ``grad``, ``grad_soft``, ``generic_hard``, ``generic_soft``,
  ``motion_soft``, ``moving_groups_soft``: one step of
  ``diff.banded_value_and_grad`` as ``chip_smoke.py``'s ``grad_frame``,
  ``grad_soft_frame``, ``grad_generic_soft`` (hard, then soft) and
  ``grad_motion_soft`` build it, 800x450x16 spp, depth 8, 25 bands, band
  depths probed + 2: ``iow_final_scene()`` with colours x 0.8 + 0.1 (K2),
  the same with soft edges 0.03 (K2's silhouette instantiation),
  ``bvh_grid_scene(side=32)`` with positions moved by up to 0.1 (K3, and
  with soft edges K3's silhouette instantiation), ``motion_blur_scene()``
  and ``chip_smoke.moving_groups_scene()`` with positions moved likewise and
  soft edges (the silhouette instantiations' ``MOTION`` forms); each moved
  scene from a generator of its own seeded 0; on the card each depth bucket's band is a
  captured CUDA graph, so the warm call captures and the timed ones replay;
  the loss and each field's largest |gradient| are printed beside the times;
- ``grad_eager``: ``grad``'s step with ``graphs=False``, the same static
  bands run eagerly (host-bound: some 18 000 launches a band);
- ``recompute_pop``: the gradient path's differentiable recompute alone,
  ``diff.fastpath.intersect_diff`` and the backward of a sum of its
  outputs, on ``grad``'s scene with its parameters as leaves: on one band's
  230 400 primary lanes (timed like the others), and on 4 096 of them
  ``RECOMPUTE_ITERS`` times in a row with one synchronise at the end, whose
  seconds per pop are the host's cost of a pop where the card has little to
  do;
- ``grad_split``: ``grad``'s deepest band once, eagerly, under a profiler
  session that records the operators' input shapes: the device time of
  every ``aten::index_add_`` by its destination's shape, assigned to the
  winner gathers' backward (destination rows = the scene's capacity), the
  queue pop's ``index_select`` backward (destination rows = (Q + 1) times
  the band's lanes) or other.  A replayed graph launches no operator, so
  the shapes come from the eager band (the same kernels);
- ``backward_pops``: the shading's and the recompute's backward kernels
  alone (``kernels.shade._launch_shade_grad``,
  ``kernels.recompute._launch_recompute_grad``) on the inputs and the
  gradients they get at the pops that ``chip_smoke.py``'s ``shade_vs_plain``
  and ``recompute_vs_plain`` use: the deepest band's pops 1 and 3 of
  ``grad``, pop 1 of ``grad_soft`` and of ``generic_hard`` (bvh1k), and for
  the recompute bvh1k's pop 1 with soft edges and a seeded gradient; each
  band traced eagerly at its probed depth and differentiated (its squared
  error against the target's rows).  Every checkout builds these inputs and
  says whether they equal the first checkout's bit for bit; each runs its
  kernels on the first checkout's (a step that refracts adds some float
  gradients by atomics, so two traces may differ in a last ulp), every
  input's gradient and then the band's own ``need``, in both builds, and
  times each kernel on them (every input's gradient; cold L2, least of
  ``REPS``: after a flush that leaves the L2 full of dirty lines, as every
  other cold time here, and after one that reads through it), each beside a
  plain device copy of as many bytes under the same flush (``copy_ms``,
  what streaming those bytes costs).  The parent process then holds every
  checkout's outputs against the first checkout's bit for bit (the floats'
  bits, so NaNs in the same places) and prints the verdict
  (``backward_pops_bits``);
- ``ri_split``: ``grad``'s deepest band once, eagerly, under a profiler
  session of host and device activity: the device time of every kernel by
  the range that launched it (``op_split``): the surrounding-RI containment
  sum (``ri_sum``), the recompute (``diff.fastpath.intersect_diff``), the
  queue's push and pop (``RayQueue.push``, ``push2`` and ``pop``; their
  kernels' backward by their autograd nodes), the shading's kernel (``kernels.shade.shade_bvh``,
  in a checkout that has it), the rest of ``ops.render.shade_rays`` and
  other, each forward and backward.

``--only a,b`` runs the named workloads alone; ``--reps n`` times each n
times (default ``REPS``).

Each workload runs once to warm, ``REPS`` times timed by the host clock
around a synchronise, then once under ``torch.profiler``.  From that trace:
each kernel's device ms and record count, their sum, the union of the
kernel intervals (busy) and the span from the first kernel's start to the
last one's end, so busy / span is the share of the span the card worked.
The session is padded at both ends (a session on an H100 has lost the device
records of its first and last launches); only the records of launches
between the padding's synchronisations count.  Prints one JSON object per
checkout and workload, then the card as ``nvidia-smi`` names it; fails
without CUDA.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time

REPS = 3
RECOMPUTE_ITERS = 200
L2_FLUSH_BYTES = 128 << 20  # written or read before each cold-L2 launch (the card's L2: 50 MB)
SLEEP_CYCLES = 500_000
POP_LANES_SEED = 0  # the seeded gradient of the soft bvh1k recompute case
# where ``backward_pops`` keeps what it hands from one checkout's process to
# the next and to the parent (a directory the parent makes)
AB_DIR_ENV = "CHIP_QUEUE_AB_DIR"
AB_RUN_ENV = "CHIP_QUEUE_AB_RUN"
TOP = 30  # kernels printed per workload, by device time
DEVICE_RECORDS = ("kernel", "gpu_memcpy", "gpu_memset")
FRAME = dict(width=800, height=450, spp=16, max_bounces=8)
STEP = dict(width=800, height=450, spp=2, max_bounces=8)
HEADLINE = dict(width=800, height=450, spp=100, max_bounces=8)
GRAD = dict(width=800, height=450, spp=16, max_bounces=8)
SOFT = 0.03
WORKLOADS = ("bvh_queue_frame", "dense_generic_frame", "unbanded_step", "sharded_step",
             "megalanes_natural", "megalanes_sorted", "workqueue_frame", "megalanes_motion",
             "grad_split", "ri_split", "grad", "grad_soft", "generic_hard", "generic_soft",
             "motion_soft", "moving_groups_soft", "grad_eager", "recompute_pop",
             "backward_pops")
GRAD_WORKLOADS = ("grad_split", "ri_split", "grad", "grad_soft", "generic_hard", "generic_soft",
                  "motion_soft", "moving_groups_soft", "grad_eager")
# The ranges ``op_split`` attributes a kernel to, innermost first where they
# nest: the containment sum, the recompute, the queue, the shading's kernel
# (``kernels.shade.shade_bvh``, where the checkout has it), the rest of the
# shading.
SPLIT_RANGES = ("ri_sum", "recompute", "queue", "shade", "shade_rays")
# The backward nodes of the port's autograd.Functions, known by name (their
# forward records no operator of their own to take a sequence number from).
NODE_RANGES = {"ContainmentRI": "ri_sum", "WinnerGather": "recompute",
               "WinnerRecompute": "recompute", "ShadeBvh": "shade", "QueuePop": "queue",
               "QueuePush2": "queue"}


def _pad(n: int) -> None:
    import torch

    one = torch.zeros(1, device="cuda")
    for _ in range(n):
        one.add_(1.0)
    torch.cuda.synchronize()


def body_window(host, trailing: int) -> tuple:
    """(start, end) host timestamps of what a padded session's body
    launched: after the leading pad's synchronise, and before the last
    synchronise ahead of the trailing pad's ``trailing`` launches.  (The last
    but one synchronise is not that bound: a session's trace can hold one
    more after the pad's, and then the pad's own launches counted as the
    body's, 2 048 one-element adds or 2.4 ms of device time.)"""
    syncs = sorted(e["ts"] for e in host if e["name"] == "cudaDeviceSynchronize")
    launches = sorted(e["ts"] for e in host if "LaunchKernel" in e["name"])
    pad_at = launches[-trailing]
    return syncs[0], max(t for t in syncs if t < pad_at)


def profiled(fn) -> dict:
    """``fn()`` under a torch.profiler session -> its kernels' device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _pad(256)
        fn()
        torch.cuda.synchronize()
        _pad(2048)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    host = [e for e in events if e.get("cat") in ("cuda_runtime", "cuda_driver")]
    lo, hi = body_window(host, 2048)
    mine = {e["args"]["correlation"] for e in host
            if lo < e["ts"] < hi and "correlation" in e.get("args", {})}
    records = sorted((e for e in events if e.get("cat") in DEVICE_RECORDS
                      and e.get("args", {}).get("correlation") in mine), key=lambda e: e["ts"])
    by, count = {}, {}
    busy, end = 0.0, None
    for e in records:
        name = e["name"][:110]
        by[name] = by.get(name, 0.0) + e["dur"] / 1e3
        count[name] = count.get(name, 0) + 1
        lo, hi = e["ts"], e["ts"] + e["dur"]
        if end is None or lo >= end:
            busy += hi - lo
            end = hi
        elif hi > end:
            busy += hi - end
            end = hi
    span = (end - records[0]["ts"]) / 1e3 if records else 0.0
    top = sorted(by.items(), key=lambda kv: -kv[1])[:TOP]
    return dict(records=len(records), device_ms_sum=sum(by.values()), busy_ms=busy / 1e3,
                span_ms=span, busy_share_of_span=busy / 1e3 / span if span else None,
                by_kernel={name: [ms, count[name]] for name, ms in top})


def measured(fn) -> dict:
    import torch

    from raytracing_tests_tpu_torch.kernels import _build

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        _build.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    out = dict(seconds=times, seconds_min=min(times), launches=dict(_build.LAUNCHES),
               peak_memory_bytes=torch.cuda.max_memory_allocated())
    out["trace"] = profiled(fn)
    return out


def child(root: str, only) -> None:
    sys.path.insert(0, root)
    import dataclasses

    import torch

    from raytracing_tests_tpu_torch import diff
    from raytracing_tests_tpu_torch.ops.megalanes import render_megalanes
    from raytracing_tests_tpu_torch.ops.render import RenderConfig, render_stats
    from raytracing_tests_tpu_torch.ops.workqueue import render_workqueue
    from raytracing_tests_tpu_torch.parallel import make_mesh
    from raytracing_tests_tpu_torch.scene import examples

    import raytracing_tests_tpu_torch as pkg

    dev = torch.device("cuda", 0)
    say = lambda **kw: print(json.dumps(dict(root=root, package=os.path.dirname(pkg.__file__),
                                             **kw)), flush=True)  # noqa: E731
    if {"bvh_queue_frame", "dense_generic_frame"} & only:
        scene, cam = (x.to(dev) for x in examples.bvh_grid_scene(side=32))
        cfg = RenderConfig(intersector="pallas", **FRAME).for_scene(scene)
        for name, c in (("bvh_queue_frame", cfg),
                        ("dense_generic_frame", dataclasses.replace(cfg, pallas_groups=0))):
            if name in only:
                say(workload=name, **measured(lambda: render_stats(scene, cam, c)))
    scene, cam = (x.to(dev) for x in examples.iow_final_scene())
    if {"unbanded_step", "sharded_step"} & only:
        cfg = RenderConfig(intersector="pallas", **STEP).for_scene(scene)
        pert = scene.replace(color=scene.color * 0.8 + 0.1)
        p = diff.extract_params(pert)
        target = render_stats(scene, cam, cfg)["image"]
        mesh = make_mesh(devices=[dev] * 3)
        for name, m in (("unbanded_step", None), ("sharded_step", mesh)):
            if name in only:
                say(workload=name, **measured(
                    lambda: diff.value_and_grad_loss(p, pert, cam, cfg, target, mesh=m)))
    cfg = RenderConfig(intersector="pallas", **HEADLINE).for_scene(scene)
    for name, fn in (
            ("megalanes_natural", lambda: render_megalanes(scene, cam, cfg, chunk=1 << 20, gr=64,
                                                           schedule="natural")),
            ("megalanes_sorted", lambda: render_megalanes(scene, cam, cfg, chunk=1 << 20, gr=64,
                                                          schedule="sorted")),
            ("workqueue_frame", lambda: render_workqueue(scene, cam, cfg))):
        if name in only:
            drain_frame(say, name, fn)
    if "megalanes_motion" in only:
        scene, cam = (x.to(dev) for x in examples.motion_blur_scene())
        cfg = RenderConfig(intersector="pallas", **FRAME).for_scene(scene)
        drain_frame(say, "megalanes_motion", lambda: render_megalanes(
            scene, cam, cfg, chunk=1 << 20, gr=64, schedule="sorted"))
    if set(GRAD_WORKLOADS) & only:
        grad_workloads(say, dev, only)
    if "recompute_pop" in only:
        recompute_pop(say, dev)
    if "backward_pops" in only:
        backward_pops(say, dev)


def moving_groups_scene():
    """``groups_scene()`` with three of its objects in motion: a copy of
    ``chip_smoke.moving_groups_scene``, for the reason ``grad_inputs``
    gives."""
    import torch

    from raytracing_tests_tpu_torch.scene import examples

    scene, camera = examples.groups_scene()
    dp = torch.zeros_like(scene.delta_position)
    dp[1] = torch.tensor([0.3, 0.0, 0.0])  # the sphere
    dp[2] = torch.tensor([0.0, 0.25, 0.1])  # the rotated ellipsoid
    dp[3] = torch.tensor([-0.2, 0.0, 0.0])  # the rotated box
    return scene.replace(delta_position=dp), camera


def grad_inputs(dev, scene_cam, perturb, soft=0.0) -> dict:
    """A gradient frame as ``chip_smoke.grad_inputs`` builds it: the forward
    render is the target, ``perturb`` makes the trained scene, the bands by
    the port's bench, band depths probed on the gradient path + POPS_MARGIN.
    A copy, not an import: ``chip_smoke.py`` exits at import without a card
    and imports the package of its own checkout, where a child here imports
    the package of the root it was given (a parent's among them)."""
    import dataclasses

    from raytracing_tests_tpu_torch import diff
    from raytracing_tests_tpu_torch.bench import grad_bands
    from raytracing_tests_tpu_torch.ops.render import RenderConfig, render_stats

    scene, cam = (x.to(dev) for x in scene_cam)
    cfg = dataclasses.replace(RenderConfig(intersector="pallas", **GRAD).for_scene(scene),
                              soft_edges=soft)
    pert = perturb(scene)
    bands = grad_bands(cfg)
    pops = [q + diff.train.POPS_MARGIN for q in diff.probe_band_pops(pert, cam, cfg, bands)]
    return dict(cam=cam, cfg=cfg, pert=pert, p=diff.extract_params(pert), bands=bands,
                pops=pops, target=render_stats(scene, cam, cfg)["image"])


def index_add_split(fn, n_rows: int, pop_rows: int) -> dict:
    """``fn()`` under a profiler session with the operators' input shapes ->
    the device ms and calls of ``aten::index_add_`` by destination shape,
    each assigned to the winner gathers (``n_rows`` rows), the queue pop
    (``pop_rows`` rows) or other, and the ``indexFuncLargeIndex`` kernels'
    device ms by name."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    device_ms = lambda e: getattr(e, "self_device_time_total",  # noqa: E731
                                  getattr(e, "self_cuda_time_total", 0.0)) / 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        _pad(256)
        fn()
        torch.cuda.synchronize()
        _pad(256)
    by_shape, by_kind = [], dict(winner_gathers=0.0, queue_pop=0.0, other=0.0)
    for e in prof.key_averages(group_by_input_shape=True):
        if e.key != "aten::index_add_":
            continue
        dest = list(e.input_shapes[0]) if e.input_shapes else []
        kind = ("winner_gathers" if dest[:1] == [n_rows] else
                "queue_pop" if dest[:1] == [pop_rows] else "other")
        by_kind[kind] += device_ms(e)
        by_shape.append(dict(destination=dest, kind=kind, calls=e.count, device_ms=device_ms(e)))
    kernels = {e.key[:110]: [device_ms(e), e.count] for e in prof.key_averages()
               if "indexFuncLargeIndex" in e.key}
    total = sum(by_kind.values())
    return dict(index_add_device_ms=by_kind, index_add_device_ms_total=total,
                pop_share=by_kind["queue_pop"] / total if total else None,
                by_destination=sorted(by_shape, key=lambda r: -r["device_ms"]),
                index_func_kernels=kernels)


@contextlib.contextmanager
def split_ranges():
    """Inside: the recompute, the queue's pop, push and push pair (where the
    checkout's ``RayQueue`` has ``push2``), the shading's kernel
    (``kernels.shade.shade_bvh``, where the checkout has one) and
    ``ops.render.shade_rays`` run inside ``torch.profiler.record_function``
    ranges named as in ``SPLIT_RANGES``; so does the containment sum
    (``ops.render._surrounding_ri``) where the checkout's ``_ri_of_lanes``
    opens no ``ri_sum`` range of its own (an older checkout)."""
    import importlib
    import importlib.util
    import inspect

    import torch

    from raytracing_tests_tpu_torch.diff import fastpath

    # the module, not the package's re-exported ``render`` function
    render = importlib.import_module("raytracing_tests_tpu_torch.ops.render")

    def ranged(name, fn):
        def run(*args, **kw):
            with torch.profiler.record_function(name):
                return fn(*args, **kw)
        return run

    patches = [(fastpath, "intersect_diff", "recompute"), (render.RayQueue, "push", "queue"),
               (render.RayQueue, "pop", "queue"), (render, "shade_rays", "shade_rays")]
    if hasattr(render.RayQueue, "push2"):  # the loop's push pair, one launch on the card
        patches.append((render.RayQueue, "push2", "queue"))
    if '"ri_sum"' not in inspect.getsource(render._ri_of_lanes):
        patches.append((render, "_surrounding_ri", "ri_sum"))
    if importlib.util.find_spec("raytracing_tests_tpu_torch.kernels.shade") is not None:
        shade = importlib.import_module("raytracing_tests_tpu_torch.kernels.shade")
        patches.append((shade, "shade_bvh", "shade"))
    saved = [(obj, attr, getattr(obj, attr)) for obj, attr, _ in patches]
    try:
        for obj, attr, name in patches:
            setattr(obj, attr, ranged(name, getattr(obj, attr)))
        yield
    finally:
        for obj, attr, fn in saved:
            setattr(obj, attr, fn)


def op_split(fn, top: int = 6) -> dict:
    """``fn()`` under a profiler session of host and device activity, inside
    ``split_ranges`` -> the device ms of its kernels by the range that
    launched them, forward and backward.

    A kernel launched on the forward's thread belongs to the innermost
    ``SPLIT_RANGES`` range around its launch ("other" outside them all); one
    launched inside a backward node (``autograd::engine::evaluate_function``)
    to the range of the last forward operator that recorded the node's
    sequence number (the one that made the node: the operators before it
    record the number it will take), or by ``NODE_RANGES`` where the node is
    one of the port's ``autograd.Function``s.
    Only launches between the padding's synchronisations count."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with split_ranges(), profile(activities=[ProfilerActivity.CPU,
                                             ProfilerActivity.CUDA]) as prof:
        _pad(256)
        fn()
        torch.cuda.synchronize()
        _pad(256)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    return split_of(events, top)


def split_of(events, top: int = 6) -> dict:
    """``op_split``'s numbers from a session's trace events."""
    host = [e for e in events if e.get("cat") in ("cuda_runtime", "cuda_driver")]
    lo, hi = body_window(host, 256)
    launch = {e["args"]["correlation"]: e for e in host
              if lo < e["ts"] < hi and "correlation" in e.get("args", {})}
    records = [e for e in events if e.get("cat") in DEVICE_RECORDS
               and e.get("args", {}).get("correlation") in launch]
    ranges = collections.defaultdict(list)  # thread -> [(start, end, range)]
    for e in events:
        if e.get("cat") == "user_annotation" and e.get("name") in SPLIT_RANGES:
            ranges[e["tid"]].append((e["ts"], e["ts"] + e["dur"], e["name"]))

    def innermost(spans, ts):
        best = None
        for lo, hi, name in spans:
            if lo <= ts <= hi and (best is None or lo >= best[0]):
                best = (lo, name)
        return None if best is None else best[1]

    ops = sorted((e for e in events if e.get("cat") == "cpu_op"), key=lambda e: e["ts"])
    evaluate = "autograd::engine::evaluate_function"
    nodes = [e for e in ops if e["name"].startswith(evaluate)]
    in_node = collections.defaultdict(list)  # thread -> [(start, end, None)]
    for e in nodes:
        in_node[e["tid"]].append((e["ts"], e["ts"] + e["dur"], None))
    forward = {}  # sequence number -> range of the forward operator that took it
    for e in ops:
        seq = e.get("args", {}).get("Sequence number")
        if seq is not None and not any(lo <= e["ts"] <= hi for lo, hi, _ in in_node[e["tid"]]):
            forward[seq] = innermost(ranges[e["tid"]], e["ts"]) or "other"
    backward = collections.defaultdict(list)  # thread -> [(start, end, range)]
    for e in nodes:
        named = [r for n, r in NODE_RANGES.items() if n in e["name"]]
        name = named[0] if named else forward.get(e.get("args", {}).get("Sequence number"),
                                                  "other")
        backward[e["tid"]].append((e["ts"], e["ts"] + e["dur"], name))
    split = collections.defaultdict(float)
    kernels = collections.defaultdict(lambda: collections.defaultdict(float))
    for r in records:
        at = launch[r["args"]["correlation"]]
        node = innermost(backward[at["tid"]], at["ts"])
        key = (f"{node}_backward" if node is not None else
               f"{innermost(ranges[at['tid']], at['ts']) or 'other'}_forward")
        split[key] += r["dur"] / 1e3
        kernels[key][r["name"][:110]] += r["dur"] / 1e3
    total = sum(split.values())
    ri = split["ri_sum_forward"] + split["ri_sum_backward"]
    return dict(device_ms_total=total, ri_sum_device_ms=ri,
                ri_sum_share=ri / total if total else None,
                device_ms=dict(sorted(split.items(), key=lambda kv: -kv[1])),
                share={k: v / total for k, v in split.items()} if total else {},
                top_kernels_ms={k: dict(sorted(v.items(), key=lambda kv: -kv[1])[:top])
                                for k, v in kernels.items()})


def grad_workloads(say, dev, only) -> None:
    """The gradient workloads (see the docstring)."""
    import dataclasses

    import numpy as np
    import torch

    from raytracing_tests_tpu_torch import diff
    from raytracing_tests_tpu_torch.scene import examples

    recolour = lambda s: s.replace(color=s.color * 0.8 + 0.1)  # noqa: E731

    def jitter(s):
        dpos = np.random.default_rng(0).uniform(-0.1, 0.1, tuple(s.position.shape))
        dpos = torch.from_numpy(dpos.astype(np.float32))
        return s.replace(position=s.position + dpos.to(s.position.device))

    frames = {}
    if {"grad_split", "ri_split", "grad", "grad_soft", "grad_eager"} & only:
        frames["grad"] = grad_inputs(dev, examples.iow_final_scene(), recolour)
        frames["grad_soft"] = dict(frames["grad"], cfg=dataclasses.replace(
            frames["grad"]["cfg"], soft_edges=SOFT))
        frames["grad_eager"] = frames["grad"]
    if {"generic_hard", "generic_soft"} & only:
        # probed with soft edges, then run hard, as chip_smoke.py's grad_generic_soft does
        frames["generic_soft"] = grad_inputs(dev, examples.bvh_grid_scene(side=32), jitter,
                                             soft=SOFT)
        frames["generic_hard"] = dict(frames["generic_soft"], cfg=dataclasses.replace(
            frames["generic_soft"]["cfg"], soft_edges=0.0))
    if "motion_soft" in only:
        frames["motion_soft"] = grad_inputs(dev, examples.motion_blur_scene(), jitter, soft=SOFT)
    if "moving_groups_soft" in only:
        frames["moving_groups_soft"] = grad_inputs(dev, moving_groups_scene(), jitter, soft=SOFT)
    if "grad_split" in only:
        g = frames["grad"]
        vg = diff.banded_value_and_grad(g["pert"], g["cam"], g["cfg"], grad_bands=g["bands"],
                                        band_pops=g["pops"], graphs=False)
        vg(g["p"], g["target"])
        deepest = max(range(g["bands"]), key=lambda b: g["pops"][b])
        lanes = g["cfg"].height // g["bands"] * g["cfg"].width * g["cfg"].spp
        pop_rows = (g["cfg"].queue_capacity + 1) * lanes
        say(workload="grad_split", band=deepest, pops=g["pops"][deepest],
            scene_rows=int(g["pert"].capacity), pop_rows=pop_rows,
            **index_add_split(lambda: vg.last.band(deepest), int(g["pert"].capacity),
                              pop_rows))
        del vg
    if "ri_split" in only:
        g = frames["grad"]
        vg = diff.banded_value_and_grad(g["pert"], g["cam"], g["cfg"], grad_bands=g["bands"],
                                        band_pops=g["pops"], graphs=False)
        vg(g["p"], g["target"])
        deepest = max(range(g["bands"]), key=lambda b: g["pops"][b])
        band = lambda: vg.last.band(deepest)  # noqa: E731
        band()
        torch.cuda.synchronize()
        say(workload="ri_split", band=deepest, pops=vg.bucket_cfgs[vg.bucket_of[deepest]].pops,
            ri_slots=list(vg.ri_slots[vg.bucket_of[deepest]]), **op_split(band))
        vg.release()
    for name in ("grad", "grad_soft", "generic_hard", "generic_soft", "motion_soft",
                 "moving_groups_soft", "grad_eager"):
        if name not in only:
            continue
        g = frames[name]
        if name == "grad_soft":
            g["pops"] = [q + diff.train.POPS_MARGIN for q in diff.probe_band_pops(g["pert"], g["cam"], g["cfg"],
                                                            g["bands"])]
        vg = diff.banded_value_and_grad(g["pert"], g["cam"], g["cfg"], grad_bands=g["bands"],
                                        band_pops=g["pops"], graphs=name != "grad_eager")
        got = {}

        def step():
            got["out"] = vg(g["p"], g["target"])

        res = measured(step)
        loss, grads = got["out"]
        say(workload=name, band_pops=g["pops"], loss=float(loss),
            max_abs_grad={n: float(v.abs().max()) for n, v in grads.items()}, **res)
        vg.release()


def recompute_pop(say, dev) -> None:
    """The ``recompute_pop`` workload (see the docstring)."""
    import torch

    from raytracing_tests_tpu_torch import diff
    from raytracing_tests_tpu_torch.diff import fastpath
    from raytracing_tests_tpu_torch.diff.train import _diff_cfg
    from raytracing_tests_tpu_torch.ops.render import RenderConfig, _build_accel, _lane_inputs
    from raytracing_tests_tpu_torch.scene import examples

    scene, cam = (x.to(dev) for x in examples.iow_final_scene())
    cfg = _diff_cfg(RenderConfig(intersector="pallas", **GRAD).for_scene(scene))
    pert = scene.replace(color=scene.color * 0.8 + 0.1)
    leaves = diff.extract_params(pert).map(lambda v: v.detach().clone().requires_grad_(True))
    tensors = [v for _, v in leaves.items()]
    s = diff.apply_params(pert, leaves)
    accel = _build_accel(s, cfg)
    o, d, tr, _ = _lane_inputs(cam, cfg)
    lanes = cfg.height // 25 * cfg.width * cfg.spp
    band = slice(12 * lanes, 13 * lanes)  # the middle band's lanes
    o, d, tr = o[band], d[band], tr[band]
    t_limit = torch.full((lanes,), float("inf"), device=dev)

    def pop(n):
        h, f, _ = fastpath.intersect_diff(accel, s, o[:n], d[:n], tr[:n], t_limit[:n])
        hit = h.hit[:, None]
        loss = (torch.where(h.hit, h.t, 0.0).sum() + torch.where(hit, h.normal, 0.0).sum()
                + torch.where(hit, h.local_pos, 0.0).sum()
                + f.color.sum() + f.refractive_index.sum() + f.refractivity.sum()
                + f.reflectivity.sum() + f.scatter_refract.sum() + f.scatter_reflect.sum())
        torch.autograd.grad(loss, tensors, allow_unused=True)

    small = 4096
    pop(small)
    torch.cuda.synchronize()
    host = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        for _ in range(RECOMPUTE_ITERS):
            pop(small)
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t0) / RECOMPUTE_ITERS)
    say(workload="recompute_pop", lanes=lanes, host_lanes=small,
        host_seconds_per_pop=host, host_seconds_per_pop_min=min(host),
        **measured(lambda: pop(lanes)))


def cold_ms(fn, clean=False) -> float:
    """Least device ms of one call of ``fn()`` over ``REPS``, each timed by
    CUDA events recorded while the card sleeps (so that the call is enqueued
    before its start event fires) after the L2 cache was overwritten
    (``clean``: read through instead, so that the call evicts no dirty line
    and writes none back)."""
    import torch

    junk = torch.empty(L2_FLUSH_BYTES // 4, device="cuda")
    fn()
    times = []
    for _ in range(REPS):
        if clean:
            junk.sum()
        else:
            junk.zero_()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return min(times)


def band_backward_inputs(g, band) -> dict:
    """The shading's and the recompute's backward calls of band ``band`` of
    the gradient frame ``g``, traced eagerly at its probed depth and
    differentiated (its squared error against the target's rows), in pop
    order -> dict(shade=[dict(inputs, grads, statics, need)], recompute=[dict(
    inputs, grads, soft, spheres, need)]) (the recompute has no backward at
    a band's last pop with hard edges)."""
    import dataclasses

    import torch

    from raytracing_tests_tpu_torch import diff
    from raytracing_tests_tpu_torch.diff.train import _diff_cfg
    from raytracing_tests_tpu_torch.kernels import recompute, shade
    from raytracing_tests_tpu_torch.ops.render import (_build_accel, _lane_inputs, finalize,
                                                       trace_lanes)

    cfg = dataclasses.replace(_diff_cfg(g["cfg"]), early_exit=False, max_pops=g["pops"][band])
    lo, ld, ltr, ls = _lane_inputs(g["cam"], cfg)
    h = cfg.height // g["bands"]
    n = h * cfg.width * cfg.spp
    sl = slice(band * n, (band + 1) * n)
    leaves = g["p"].map(lambda v: v.detach().clone().requires_grad_(True))
    scene = diff.apply_params(g["pert"], leaves)
    got = dict(shade=[], recompute=[])
    s_bwd, r_bwd = shade._shade_grad, recompute._recompute_grad
    keep = lambda xs: [None if x is None else x.detach().clone() for x in xs]  # noqa: E731

    def keep_shade(inputs, grads, statics, need):
        got["shade"].append(dict(inputs=keep(inputs), grads=keep(grads), statics=statics,
                                 need=list(need)))
        return s_bwd(inputs, grads, statics, need)

    def keep_recompute(inputs, grads, soft, spheres, need):
        got["recompute"].append(dict(inputs=keep(inputs), grads=keep(grads), soft=soft,
                                     spheres=spheres, need=list(need)))
        return r_bwd(inputs, grads, soft, spheres, need)

    shade._shade_grad, recompute._recompute_grad = keep_shade, keep_recompute
    try:
        color, primary_t, _, _ = trace_lanes(scene, None, cfg, lo[sl], ld[sl], ltr[sl], ls[sl],
                                             _build_accel(scene, cfg))
        img = finalize(color.reshape(h, cfg.width, cfg.spp, 3),
                       primary_t.reshape(h, cfg.width, cfg.spp), cfg)["image"]
        sse = torch.sum((img - g["target"][band * h:(band + 1) * h]) ** 2)
        torch.autograd.grad(sse, [v for _, v in leaves.items()], allow_unused=True)
    finally:
        shade._shade_grad, recompute._recompute_grad = s_bwd, r_bwd
    return {k: v[::-1] for k, v in got.items()}  # the backward runs the pops in reverse


def backward_pop_cases(dev) -> dict:
    """The ``backward_pops`` cases: {name: (kernel, dict of its launch's
    arguments)} (see the docstring)."""
    import dataclasses

    import numpy as np
    import torch

    from raytracing_tests_tpu_torch import diff
    from raytracing_tests_tpu_torch.scene import examples

    def jitter(s):
        dpos = np.random.default_rng(0).uniform(-0.1, 0.1, tuple(s.position.shape))
        dpos = torch.from_numpy(dpos.astype(np.float32))
        return s.replace(position=s.position + dpos.to(s.position.device))

    deepest = lambda g: max(range(g["bands"]), key=lambda b: g["pops"][b])  # noqa: E731
    g = grad_inputs(dev, examples.iow_final_scene(), lambda s: s.replace(color=s.color * 0.8 + 0.1))
    gs = dict(g, cfg=dataclasses.replace(g["cfg"], soft_edges=SOFT))
    gs["pops"] = [q + diff.train.POPS_MARGIN
                  for q in diff.probe_band_pops(gs["pert"], gs["cam"], gs["cfg"], gs["bands"])]
    gg = grad_inputs(dev, examples.bvh_grid_scene(side=32), jitter, soft=SOFT)
    hard = dict(gg, cfg=dataclasses.replace(gg["cfg"], soft_edges=0.0))
    cases = {}
    for label, frame, pops in (("grad", g, (1, 3)), ("grad_soft", gs, (1,)),
                               ("bvh1k", hard, (1,))):
        calls = band_backward_inputs(frame, deepest(frame))
        for pop in pops:
            cases[f"shade_{label}_pop{pop}"] = ("shade", calls["shade"][pop - 1])
            cases[f"recompute_{label}_pop{pop}"] = ("recompute", calls["recompute"][pop - 1])
    soft = dict(cases["recompute_bvh1k_pop1"][1], soft=SOFT, need=[True] * 7)
    rng = np.random.default_rng(POP_LANES_SEED)
    B = soft["inputs"][0].shape[0]
    soft["grads"] = [torch.from_numpy(rng.normal(size=(B, w) if w > 1 else (B,))
                                      .astype(np.float32)).to(dev) for w in (1, 3, 3, 1)]
    cases["recompute_bvh1k_soft_pop1"] = ("recompute", soft)
    return cases


def _same_bits(a, b) -> bool:
    """Two tensors (or Nones) equal bit for bit: floats by their bits, so
    NaNs in the same places with the same payload."""
    import torch

    if a is None or b is None:
        return a is None and b is None
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.is_floating_point():
        return bool(torch.equal(a.view(torch.int32), b.view(torch.int32)))
    return bool(torch.equal(a, b))


def _to(x, dev):
    """``x`` (nested lists, tuples and dicts of tensors) with every tensor on
    ``dev``."""
    import torch

    if isinstance(x, torch.Tensor):
        return x.to(dev)
    if isinstance(x, dict):
        return {k: _to(v, dev) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_to(v, dev) for v in x)
    return x


def backward_pops(say, dev) -> None:
    """The ``backward_pops`` workload of one checkout (see the docstring):
    its outputs go to ``$CHIP_QUEUE_AB_DIR/backward_pops_<run>.pt``, for the
    parent to compare."""
    import torch

    from raytracing_tests_tpu_torch.kernels import _build, recompute, shade

    out_dir, run = os.environ[AB_DIR_ENV], int(os.environ[AB_RUN_ENV])
    own = backward_pop_cases(dev)
    shared = os.path.join(out_dir, "backward_pops_inputs.pt")
    if os.path.exists(shared):
        cases = _to(torch.load(shared), dev)
        same = {name: all(_same_bits(a, b) for a, b in zip(c["inputs"] + c["grads"],
                                                             own[name][1]["inputs"]
                                                             + own[name][1]["grads"]))
                for name, (_, c) in cases.items()}
    else:
        torch.save(_to(own, "cpu"), shared)
        cases, same = own, {name: True for name in own}
    del own

    def launch(kernel, c, need=None):
        if kernel == "shade":
            return shade._launch_shade_grad(c["inputs"], c["grads"], c["statics"], need)
        return recompute._launch_recompute_grad(c["inputs"], c["grads"], c["soft"], c["spheres"],
                                                need)

    outs, rows = {}, {}
    for name, (kernel, c) in cases.items():
        got = {}
        for build, ctx in (("default", contextlib.nullcontext), ("precise", _build.precise)):
            with ctx():
                got[f"{build}_every"] = launch(kernel, c)
                got[f"{build}_band_need"] = launch(kernel, c, c["need"])
        torch.cuda.synchronize()
        outs[name] = _to(got, "cpu")
        lanes = int(c["inputs"][0].shape[0])
        # a plain device copy of as many bytes as the kernel reads and writes:
        # what streaming those bytes costs under the same flushes
        moved = sum(x.numel() * x.element_size() for x in c["inputs"] + c["grads"]
                    + list(got["default_every"]) if x is not None)
        src = torch.empty(moved // 8, device=dev)
        dst = torch.empty_like(src)
        rows[name] = dict(kernel=kernel, lanes=lanes, inputs_equal_first_checkout=same[name],
                          band_need=c["need"], ms=cold_ms(lambda: launch(kernel, c)),
                          ms_clean_l2=cold_ms(lambda: launch(kernel, c), clean=True),
                          bytes=moved, copy_ms=cold_ms(lambda: dst.copy_(src)),
                          copy_ms_clean_l2=cold_ms(lambda: dst.copy_(src), clean=True))
        del src, dst
    torch.save(outs, os.path.join(out_dir, f"backward_pops_{run}.pt"))
    say(workload="backward_pops", run=run, cases=rows)


def compare_backward_pops(out_dir, roots) -> bool:
    """Every checkout's ``backward_pops`` outputs against the first's, bit
    for bit -> whether all are equal (and prints the verdict)."""
    import torch

    got = [torch.load(os.path.join(out_dir, f"backward_pops_{k}.pt")) for k in range(len(roots))]
    differ = {}
    for k, outs in enumerate(got[1:], 1):
        for name, by in outs.items():
            for key, xs in by.items():
                bad = [j for j, (a, b) in enumerate(zip(xs, got[0][name][key]))
                       if not _same_bits(a, b)]
                if bad or len(xs) != len(got[0][name][key]):
                    differ.setdefault(roots[k], []).append(dict(case=name, run=key, fields=bad))
    print(json.dumps(dict(workload="backward_pops_bits", roots=roots, first=roots[0],
                          all_equal=not differ, differ=differ)), flush=True)
    return not differ


def drain_frame(say, name, fn) -> None:
    out = fn()
    say(workload=name, rays=int(out["rays"]), iterations=int(out["iterations"]),
        rays_dropped=int(out["rays_dropped"]), image_mean=float(out["image"].mean()),
        **measured(fn))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_queue_ab.py needs a CUDA device: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    global REPS
    args = sys.argv[1:]
    if len(args) > 1 and args[0] == "--reps":
        REPS = int(args[1])
        args = args[2:]
    only = list(WORKLOADS)
    if len(args) > 1 and args[0] == "--only":
        only = args[1].split(",")
        args = args[2:]
        unknown = set(only) - set(WORKLOADS)
        if unknown:
            print(f"unknown workloads {sorted(unknown)}; known: {WORKLOADS}", file=sys.stderr)
            return 2
    if len(args) > 1 and args[0] == "--child":
        child(args[1], set(only))
        return 0
    roots = args
    if not roots:
        print(__doc__, file=sys.stderr)
        return 2
    for root in roots:
        if not os.path.isdir(os.path.join(root, "raytracing_tests_tpu_torch")):
            print(f"{root}: no raytracing_tests_tpu_torch here", file=sys.stderr)
            return 2
    failed = 0
    with tempfile.TemporaryDirectory() as ab_dir:
        for run, root in enumerate(roots):
            env = dict(os.environ, **{AB_DIR_ENV: ab_dir, AB_RUN_ENV: str(run)})
            failed |= subprocess.call([sys.executable, os.path.abspath(__file__), "--reps",
                                       str(REPS), "--only", ",".join(only), "--child",
                                       os.path.abspath(root)],
                                      cwd=os.path.abspath(root), env=env) != 0
        if "backward_pops" in only and not failed:
            failed |= not compare_backward_pops(ab_dir, roots)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    return int(failed)


if __name__ == "__main__":
    sys.exit(main())
