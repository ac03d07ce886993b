"""The queue renderer's forward frames, the unbanded gradient steps and the
two chunked renderers' headline frames of several checkouts of the port,
side by side on one NVIDIA GPU: wall time and the device time of every
kernel.

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
  800x450x16 spp, depth 8, sorted (K6's MOTION instantiation).

``--only a,b`` runs the named workloads alone.

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

import json
import os
import subprocess
import sys
import tempfile
import time

REPS = 3
TOP = 30  # kernels printed per workload, by device time
DEVICE_RECORDS = ("kernel", "gpu_memcpy", "gpu_memset")
FRAME = dict(width=800, height=450, spp=16, max_bounces=8)
STEP = dict(width=800, height=450, spp=2, max_bounces=8)
HEADLINE = dict(width=800, height=450, spp=100, max_bounces=8)
WORKLOADS = ("bvh_queue_frame", "dense_generic_frame", "unbanded_step", "sharded_step",
             "megalanes_natural", "megalanes_sorted", "workqueue_frame", "megalanes_motion")


def _pad(n: int) -> None:
    import torch

    one = torch.zeros(1, device="cuda")
    for _ in range(n):
        one.add_(1.0)
    torch.cuda.synchronize()


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
    syncs = sorted(e["ts"] for e in host if e["name"] == "cudaDeviceSynchronize")
    mine = {e["args"]["correlation"] for e in host
            if syncs[0] < e["ts"] < syncs[-2] and "correlation" in e.get("args", {})}
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
    args = sys.argv[1:]
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
    for root in roots:
        failed |= subprocess.call([sys.executable, os.path.abspath(__file__), "--only",
                                   ",".join(only), "--child", os.path.abspath(root)],
                                  cwd=os.path.abspath(root)) != 0
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    return int(failed)


if __name__ == "__main__":
    sys.exit(main())
