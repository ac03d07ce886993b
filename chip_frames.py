"""Device time of the megakernel (K6) and the sphere sweep (K2) over the frames
that launch them, launch by launch, on one NVIDIA GPU.

Run from the root of a checkout, optionally with a label for the output:

    python3 chip_frames.py [label]

It drives the headline frame (``iow_final_scene()`` at 800x450x100 depth 8,
``gr=64``) once through ``render_megalanes`` (natural schedule, chunks of
2^20 lanes) and once through ``render_workqueue``, and times every launch of
K6 and of K2 by CUDA events: each launch is first run once untimed on the same
inputs (so that the allocator holds its outputs' memory), then timed while
the card sleeps (``torch.cuda._sleep``) until the host has enqueued it, so
the pair of events holds the device's time alone.  Prints one JSON object:
K6's summed time and its mean by iteration of a chunk, K2's summed time,
launch counts, rays, and the card as ``nvidia-smi`` names it.  It uses only
the API that the port has had since its third slice, so a copy of this file
runs in a checkout of an earlier commit as well, which is how two commits are
compared in one call (parent, change, change, parent).  Fails without CUDA.
"""

from __future__ import annotations

import json
import subprocess
import sys

import torch

if not torch.cuda.is_available():
    sys.exit("chip_frames.py needs a CUDA device: torch.cuda.is_available() is False")

from raytracing_tests_tpu_torch.kernels import _build, sweep2  # noqa: E402
from raytracing_tests_tpu_torch.ops import megalanes, workqueue  # noqa: E402
from raytracing_tests_tpu_torch.ops.render import RenderConfig  # noqa: E402
from raytracing_tests_tpu_torch.scene import examples  # noqa: E402

HEADLINE = dict(width=800, height=450, spp=100, max_bounces=8)
CHUNK = 1 << 20
GR = 64
SLEEP_CYCLES = 500_000  # about 0.3 ms: longer than the host takes to enqueue a launch


def device_timed(real, log, tag):
    """A stand-in for the kernel wrapper ``real`` whose every call is run
    once untimed, then timed on the device alone; ``log`` gains (events,
    tag(args))."""
    def timed(*args, **kw):
        real(*args, **kw)
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        a.record()
        out = real(*args, **kw)
        b.record()
        log.append(((a, b), tag(*args)))
        return out
    return timed


def frame_times(scene, camera, cfg):
    """K6 and K2 timed launch by launch over the two frames -> numbers."""
    k6 = []
    real6 = megalanes.mega_step
    megalanes.mega_step = device_timed(real6, k6, lambda acc, pool, lane: int((lane >= 0).sum()))
    try:
        out6 = megalanes.render_megalanes(scene, camera, cfg, chunk=CHUNK, gr=GR,
                                          schedule="natural")
    finally:
        megalanes.mega_step = real6
    k2 = []
    real2 = sweep2._sweep2
    sweep2._sweep2 = device_timed(real2, k2, lambda acc, rays, *rest: rays.shape[1])
    try:
        out2 = workqueue.render_workqueue(scene, camera, cfg)
    finally:
        sweep2._sweep2 = real2
    torch.cuda.synchronize()

    # iteration of a chunk: active lanes never rise within one
    by_iter, it, last = {}, 0, None
    for (a, b), active in k6:
        it = 0 if last is None or active > last else it + 1
        last = active
        by_iter.setdefault(it, []).append(a.elapsed_time(b))
    return dict(
        k6=dict(ms=sum(sum(v) for v in by_iter.values()), launches=len(k6),
                rays=int(out6["rays"]), iterations=out6["iterations"],
                ms_by_iteration={i: sum(v) / len(v) for i, v in sorted(by_iter.items())},
                steps_by_iteration={i: len(v) for i, v in sorted(by_iter.items())}),
        k2=dict(ms=sum(a.elapsed_time(b) for (a, b), _ in k2), launches=len(k2),
                rays_swept=sum(n for _, n in k2), rays=int(out2["rays"]),
                iterations=out2["iterations"]))


def headline(dev):
    scene, camera = examples.iow_final_scene()
    scene, camera = scene.to(dev), camera.to(dev)
    return scene, camera, RenderConfig(intersector="pallas", **HEADLINE).for_scene(scene)


def main():
    label = sys.argv[1] if len(sys.argv) > 1 else "this checkout"
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    _build.build()
    times = frame_times(*headline(torch.device("cuda", 0)))
    print(json.dumps(dict(label=label, card=card, **times)), flush=True)


if __name__ == "__main__":
    main()
