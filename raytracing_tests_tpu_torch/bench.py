"""The port's benchmark: Mrays/s of ``render_uber`` on the In-One-Weekend
final scene, on one GPU.

The counterpart of the JAX package's root ``bench.py``, with the same
configurations at the same sizes:

  - the headline: ``iow_final_scene()`` at 800x450x100spp depth 8 through
    ``render_uber`` (``gr=64``), one warm frame and 8 timed ones, min and
    mean; it must drop no ray;
  - the parity canary: 200x112x8 depth 6, ``render_uber`` against
    ``render_stats`` with the "pallas" intersector, under the JAX bench's
    four bars (channel means within 5e-3, ray ratio within 2 %, depth
    disagreeing on under 1 % of the pixels, no ray dropped);
  - the side configurations: motion, bvh1k, texturing, lights and materials
    at 800x450x16spp depth 8, 4 timed frames each;
  - ``grad_config``: one banded gradient step at 800x450x16spp depth 8 (the
    smallest band count >= W*H*spp / 300 000 that divides H, each band's
    probed depth + 2), one warm step and one timed.

Each frame is timed by the host clock between two ``torch.cuda.synchronize()``
calls.  The JAX bench's persistent-kernel tunes (``R``, ``L``, ``stage``, the
shallow ``qcap=3`` stack), its retry loop and its compilation cache are TPU
workarounds and are not carried over: ``render_uber`` runs its default stack.

Prints one JSON line ``{"metric", "value", "unit", "parity_ok", "device"}``
(``parity_ok`` not in a smoke run).  No TPU figure is a target here, so the
line has no ``vs_baseline``.  A full run writes its details to ``details``
(default ``bench_details_torch.json``); a smoke run (``materials_scene()`` at
80x45x4, the headline only, one frame) writes none.

    python -m raytracing_tests_tpu_torch bench [--smoke]
"""

from __future__ import annotations

import collections
import json
import time

import torch

from raytracing_tests_tpu_torch.kernels import _build
from raytracing_tests_tpu_torch.ops.render import RenderConfig, extract_lights, render_stats
from raytracing_tests_tpu_torch.scene import examples
from raytracing_tests_tpu_torch.utils.device import resolve_device

RENDERERS = ("uber", "megalanes", "queue", "workqueue")
BAND_SAMPLES = 300_000  # the banded backward's live samples a band, at most


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _make_fn(renderer, cfg, chunk, dev):
    if renderer == "uber":
        from raytracing_tests_tpu_torch.kernels.uber import render_uber

        return lambda s, c, lt: render_uber(s, c, cfg, lt, gr=64, device=dev)
    if renderer == "megalanes":
        from raytracing_tests_tpu_torch.ops.megalanes import render_megalanes

        return lambda s, c, lt: render_megalanes(s, c, cfg, chunk=chunk, gr=128,
                                                 schedule="natural", device=dev)
    if renderer == "workqueue":
        from raytracing_tests_tpu_torch.ops.workqueue import render_workqueue

        return lambda s, c, lt: render_workqueue(s, c, cfg, lt, chunk=chunk, device=dev)
    if renderer == "queue":
        return lambda s, c, lt: render_stats(s, c, cfg, lt, device=dev)
    raise ValueError(f"renderer must be one of {RENDERERS}, got {renderer!r}")


def time_config(scene, camera, cfg, renderer, chunk, lights=None, n_iters=3, device=None):
    """One warm frame, then ``n_iters`` timed ones -> a detail dict (with the
    kernel launches of each timed frame)."""
    dev = resolve_device(device)
    scene, camera = scene.to(dev), camera.to(dev)
    lights = None if lights is None else lights.to(dev)
    fn = _make_fn(renderer, cfg, chunk, dev)
    out = fn(scene, camera, lights)
    _sync(dev)
    rays = int(out["rays"])
    times, launches = [], []
    for _ in range(n_iters):
        before = collections.Counter(_build.LAUNCHES)
        _sync(dev)
        t0 = time.perf_counter()
        out = fn(scene, camera, lights)
        _sync(dev)
        times.append(time.perf_counter() - t0)
        launches.append(dict(_build.LAUNCHES - before))
    dt = min(times)
    return {
        "mrays_per_s": rays / dt / 1e6,
        "rays_per_frame": rays,
        "seconds_per_frame": dt,
        "seconds_per_frame_mean": sum(times) / len(times),
        "rays_dropped": int(out.get("rays_dropped", 0)),
        "renderer": renderer,
        "intersector": cfg.intersector,
        "size": f"{cfg.width}x{cfg.height}x{cfg.spp}spp d{cfg.max_bounces}",
        "mean_image": float(out["image"].mean()),
        "launches_per_frame": launches,
    }


def parity_canary(chunk, device=None):
    """``render_uber`` against the queue renderer on one small iow-final
    frame, held to the JAX bench's statistical envelope -> a detail dict."""
    from raytracing_tests_tpu_torch.kernels.uber import render_uber

    dev = resolve_device(device)
    scene, camera = (x.to(dev) for x in examples.iow_final_scene())
    cfg = RenderConfig(width=200, height=112, spp=8, max_bounces=6, lane_chunk=chunk,
                       intersector="pallas").for_scene(scene)
    before = collections.Counter(_build.LAUNCHES)
    ou = render_uber(scene, camera, cfg, gr=64, device=dev)
    oq = render_stats(scene, camera, cfg, device=dev)
    launches = dict(_build.LAUNCHES - before)
    iu, iq = ou["image"], oq["image"]
    ru, rq = int(ou["rays"]), int(oq["rays"])
    mean_diff = float((iu.mean(dim=(0, 1)) - iq.mean(dim=(0, 1))).abs().max())
    ray_ratio = ru / max(rq, 1)
    dnear = ou["depth"].clamp_max(100.0) - oq["depth"].clamp_max(100.0)
    depth_disagree = float((dnear.abs() > 1e-2).double().mean())
    detail = {
        "mean_image_diff": mean_diff,
        "ray_count_ratio": ray_ratio,
        "depth_disagree_frac": depth_disagree,
        "rays_dropped": int(ou["rays_dropped"]),
        "launches": launches,
    }
    detail["ok"] = bool(mean_diff < 5e-3 and abs(ray_ratio - 1.0) < 0.02
                        and depth_disagree < 0.01 and detail["rays_dropped"] == 0)
    return detail


def side_configs(chunk):
    """The other configurations at 800x450x16spp depth 8, each through
    ``render_uber`` whatever renders the headline -> {name: (scene, camera,
    cfg, lights)}."""
    mk = lambda scene, **kw: RenderConfig(  # noqa: E731
        width=800, height=450, spp=16, max_bounces=8, lane_chunk=chunk,
        intersector="pallas", **kw).for_scene(scene)
    out = {}
    s, c = examples.motion_blur_scene()
    out["motion"] = (s, c, mk(s), None)
    s, c = examples.bvh_grid_scene(side=32)  # 1,025 objects, generic mode
    out["bvh1k"] = (s, c, mk(s), None)
    s, c = examples.texturing_scene()
    out["texturing"] = (s, c, mk(s), None)
    s, c = examples.lights_scene()
    out["lights"] = (s, c, mk(s), extract_lights(s))
    s, c = examples.materials_scene()
    out["materials"] = (s, c, mk(s, shading="materials"), None)
    return out


def grad_bands(cfg) -> int:
    """The smallest divisor of H whose bands hold at most BAND_SAMPLES samples."""
    want = max(1, -(-cfg.width * cfg.height * cfg.spp // BAND_SAMPLES))
    return min(b for b in range(want, cfg.height + 1) if cfg.height % b == 0)


def grad_config(chunk, device=None):
    """One banded gradient step at 800x450x16spp depth 8 (the fast gradient
    path) -> a detail dict.  Mrays/s-equivalent = the forward's traced-ray
    count / the step's time."""
    from raytracing_tests_tpu_torch.diff import (
        banded_value_and_grad, extract_params, probe_band_pops,
    )

    dev = resolve_device(device)
    scene, cam = (x.to(dev) for x in examples.iow_final_scene())
    cfg = RenderConfig(width=800, height=450, spp=16, max_bounces=8, lane_chunk=chunk,
                       intersector="pallas").for_scene(scene)
    fwd = render_stats(scene, cam, cfg, device=dev)
    rays = int(fwd["rays"])
    target = fwd["image"]
    pert = scene.replace(color=scene.color * 0.8 + 0.1)
    p = extract_params(pert)
    bands = grad_bands(cfg)
    pops = [q + 2 for q in probe_band_pops(pert, cam, cfg, bands, device=dev)]
    gr = banded_value_and_grad(pert, cam, cfg, grad_bands=bands, band_pops=pops, device=dev)
    gr(p, target)  # warm
    _sync(dev)
    before = collections.Counter(_build.LAUNCHES)
    t0 = time.perf_counter()
    loss, grads = gr(p, target)
    _sync(dev)
    dt = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES - before)
    gr.release()
    return {
        "seconds_per_step": dt,
        "mrays_equiv_per_s": rays / dt / 1e6,
        "rays_forward": rays,
        "grad_bands": bands,
        "grad_band_pops": pops,
        "loss": float(loss),
        "grads_finite": all(bool(torch.isfinite(g).all()) for _, g in grads.items()),
        "launches": launches,
        "size": f"{cfg.width}x{cfg.height}x{cfg.spp}spp d{cfg.max_bounces}",
        "path": "banded fast path (detached winners + closed-form recompute)",
    }


def main(smoke: bool = False, spp: int = None, renderer: str = "uber", chunk: int = None,
         skip_side: bool = False, skip_grad: bool = False, device=None,
         details: str = "bench_details_torch.json"):
    """Run the benchmark on ``device`` (``None``: the GPU), print its line and
    write ``details`` (not in a smoke run) -> (line, details dict)."""
    dev = resolve_device(device)
    if smoke:
        width, height, spp = 80, 45, 4
        scene, camera = examples.materials_scene()
        chunk = chunk or 16384
    else:
        width, height, spp = 800, 450, spp or 100
        scene, camera = examples.iow_final_scene()
        chunk = chunk or 1048576
    cfg = RenderConfig(width=width, height=height, spp=spp, max_bounces=8, lane_chunk=chunk,
                       intersector="pallas").for_scene(scene)
    head = time_config(scene, camera, cfg, renderer, chunk, n_iters=1 if smoke else 8,
                       device=dev)
    if head["rays_dropped"]:
        raise RuntimeError(f"the headline frame dropped rays: {head}")
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    info = {"device": name, "platform": "gpu" if dev.type == "cuda" else "cpu",
            "lane_chunk": chunk, "configs": {"iow-final": head}}
    parity_ok = None
    if not smoke:
        info["parity_canary"] = parity_canary(chunk, dev)
        parity_ok = info["parity_canary"]["ok"]
        if not skip_side:
            for cname, (s, c, scfg, lights) in side_configs(chunk).items():
                info["configs"][cname] = time_config(s, c, scfg, "uber", chunk, lights=lights,
                                                     n_iters=4, device=dev)
        if not skip_grad:
            info["configs"]["grad"] = grad_config(chunk, dev)
    line = {
        "metric": f"Mrays/s {'smoke' if smoke else 'iow-final'} "
                  f"{width}x{height}x{spp}spp d{cfg.max_bounces}",
        "value": head["mrays_per_s"],
        "unit": "Mrays/s",
        "device": name,
    }
    if parity_ok is not None:
        line["parity_ok"] = parity_ok
    print(json.dumps(line), flush=True)
    if not smoke:
        with open(details, "w") as f:
            json.dump(info, f, indent=2)
            f.write("\n")
    if parity_ok is False:
        raise SystemExit("parity canary failed: " + json.dumps(info["parity_canary"]))
    return line, info
