"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

It builds the CUDA kernels from ``raytracing_tests_tpu_torch/csrc``, holds
each kernel against its plain PyTorch version on the card, runs the parity
canary (persistent kernel vs queue renderer) and then the headline frame
(``iow_final_scene()`` at 800x450, depth 8) through ``render_uber``, and
prints one JSON object per phase.  The last line is
``{"ok": true, "device": {...}}``.  Any failed phase raises, so the exit code
is non-zero and no result line is printed; without CUDA it fails at once.

Phases and their bars:
  3. sweep kernel vs plain, on three batches: 100 000 seeded rays on the
     persistent kernel's accel, and, on the queue renderer's own accel (the
     tables the canary's launches read), the canary's 179 200 camera lanes and
     as many second-generation rays (mirrored off or continued through the
     first hits, dead lanes where the camera ray missed).  The -fmad=false
     build (see 4) must agree on >= 99.9 % throughout.  Default build: same
     winner on >= 99.9 % of rays; where the winner agrees, the unrefined t
     (solved around the group anchor) within 2e-2 absolute, the refined t
     within rtol 1e-4 on >= 99 % (the 1000-radius ground sphere is
     ill-conditioned in float32 and the compiler fuses a*b+c where eager
     PyTorch rounds twice) and within 2e-2 everywhere; material fields within
     1e-5 and the surrounding RI equal on >= 99.9 %; normals, which carry the
     t difference times 1/radius (5 for most spheres), within 1e-3 on >= 99 %.
     SWEEP_BARS states, with the reason, where a batch's bars differ.
  4. persistent kernel vs plain, at 200x112x8 depth 6 and at the headline
     frame's own statics (800x450x100 depth 8, every one of its 36 000 000
     primaries).  The scene amplifies last-ulp differences (a 1000-radius
     ground sphere in float32, scatter off 0.2-radius spheres), and nvcc fuses
     a*b+c where eager PyTorch rounds twice.  So the same sources are also
     built with -fmad=false: THAT build must give per-sample colours within
     1e-4 and primary t within rtol 1e-4 on >= 99.9 % of samples and the same
     ray count within 0.05 % (the kernel's logic is the plain version's).  The
     default build, which the main path runs, is held statistically: primary t
     within rtol 1e-4 on >= 99.9 %, colours within 1e-4 on >= 85 % and within
     5e-2 on >= 97 % of samples, channel means within 5e-3, ray count within
     0.5 %, zero dropped; and at the headline, where 100 samples average out
     the flipped ones, per PIXEL of the finished image against the plain
     version's and against the -fmad=false build's: within PIXEL_ATOL (0.1)
     on >= 99.9 % of the pixels, within 1e-2 on >= 90 %, 5e-3 on average and
     nowhere further than 0.5.
  5. canary, persistent kernel vs queue renderer through the sweep kernel at
     200x112x8 depth 6: channel means within 5e-3, ray ratio within 2 %,
     depth disagreement under 1 %, zero dropped.
  6. the headline frame: no NaN, zero dropped, rays within 2 % of 91 994 750,
     image mean within 1e-2 of 1.0021 (both are properties of the scene).
Launch counts are kept per driven path: set to 0 before the canary and read
after it, and again around every headline frame (one launch of the persistent
kernel, none of the sweep).
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

if not torch.cuda.is_available():
    sys.exit("chip_smoke.py needs a CUDA device: torch.cuda.is_available() is False")

from raytracing_tests_tpu_torch.kernels import _build, sweep2, uber  # noqa: E402
from raytracing_tests_tpu_torch.ops.render import (  # noqa: E402
    RenderConfig, _build_accel, _lane_inputs, render_stats,
)
from raytracing_tests_tpu_torch.scene import examples  # noqa: E402

SEED = 0
HEADLINE = dict(width=800, height=450, spp=100, max_bounces=8)
SMALL = dict(width=200, height=112, spp=8, max_bounces=6)
GR = 64  # sphere rows per culling group on the headline path
N_DEAD = 64  # leading rays of the sweep comparison that carry d = 0
SCENE_RAYS = 91_994_750  # rays of the headline frame: a property of the scene
SCENE_MEAN = 1.0021  # its image mean, likewise
# Per-pixel bars of the default build's finished headline image (phase 4).
PIXEL_ATOL, PIXEL_FRAC, PIXEL_MAX = 1e-1, 0.999, 0.5
PIXEL_FRAC_1E2, PIXEL_MEAN = 0.90, 5e-3  # share within 1e-2; mean distance

# Published peaks of one H100 SXM: fp32 outside the tensor cores, HBM3.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
# Operation counts of the kernels' arithmetic (a fused multiply-add counts 2).
FLOPS_PER_SPHERE_TEST = 18  # two 3-dots, nb, c_q, disc, compares
FLOPS_PER_SLAB_TEST = 26  # 6 sub-mul pairs, 10 min/max, 3 compares
FLOPS_PER_NODE_SHADE = 220  # refine, probe point, mirror/refract, children
FLOPS_PER_REFINE = 60  # the winner's own quadratic, hit point, normal
FLOPS_PER_PROBE_ROW = 10  # containment test of one dielectric row


def size_of(frame):
    return "{width}x{height}x{spp}spp d{max_bounces}".format(**frame)


def say(**kw):
    print(json.dumps(kw), flush=True)


def require(cond, what):
    if not cond:
        raise AssertionError(what)


def cuda_ms(fn, reps):
    """Mean milliseconds of ``fn()`` over ``reps`` launches, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def frac(mask):
    """Share of true entries (exact: a float32 mean of many ones is not 1)."""
    return int(mask.sum()) / max(mask.numel(), 1)


def bound(n_bytes, n_flops):
    t_b = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_f = n_flops / PEAK_FP32_FLOPS * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


def accel_bytes(accel):
    return 4 * (accel.otab.numel() + accel.ftab.numel() + accel.gaabb.numel())


def compare_sweep(accel, rays):
    """The sweep kernel of the current build variant against the plain
    version on the same rays, for (t, obj) alone and for the hit block."""
    out = {}
    for with_fields in (False, True):
        tk, ok_, rk = sweep2._sweep2(accel, rays, with_fields, with_fields)
        tp, op, rp = sweep2.sweep2_plain(accel, rays, with_fields, with_fields)
        torch.cuda.synchronize()
        same = ok_ == op
        dead = (rays[3:6] * rays[3:6]).sum(dim=0) < 0.5
        m = same & (op >= 0)
        terr = (tk[m] - tp[m]).abs()
        res = dict(same_obj=frac(same),
                   hit_frac=frac(op >= 0),
                   dead_rays=int(dead.sum()),
                   dead_rays_miss=bool((ok_[dead] == -1).all()),
                   t_within_rtol_1e4=frac(terr <= 1e-4 * tp[m]),
                   t_within_2e2=frac(terr <= 2e-2),
                   t_max_abs_err=float(terr.max()),
                   t_max_rel_err=float((terr / tp[m]).max()))
        if with_fields:
            nerr = (rk[2:5, m] - rp[2:5, m]).abs().amax(dim=0)
            ferr = (rk[5:, m] - rp[5:, m]).abs().amax(dim=0)
            res["normal_within_1e5"] = frac(nerr <= 1e-5)
            res["normal_within_1e3"] = frac(nerr <= 1e-3)
            res["normal_within_1e2"] = frac(nerr <= 1e-2)
            res["normal_max_abs_err"] = float(nerr.max())
            res["fields_within_1e5"] = frac(ferr <= 1e-5)
            res["fields_max_abs_err"] = float(ferr.max())
            res["ri_equal"] = frac(rk[1, m] == rp[1, m])
        out["hit_block" if with_fields else "nearest"] = res
    return out


# Bars of phase 3 for the default build, per batch.  ``raw_t_2e2``: share of
# rays whose unrefined t lies within 2e-2; ``normal_1e3`` / ``normal_1e2``:
# shares of normals within 1e-3 / 1e-2; ``normal_max``: the furthest normal.
SWEEP_BARS = dict(
    random=dict(raw_t_2e2=1.0, normal_1e3=0.99, normal_1e2=1.0, normal_max=2e-2),
    # Camera rays travel 13 to 40 units to spheres of radius 0.2: grazing
    # hits lose the refined t to float32 cancellation in hb^2 - cq (one ulp of
    # hb^2 is 6e-5 there), and the normal carries that error times 1/radius.
    canary_lanes=dict(raw_t_2e2=1.0, normal_1e3=0.97, normal_1e2=0.999, normal_max=5e-2),
    # Rays that start 1e-4 from a surface: the anchored quadratic's near root
    # of the sphere just left is zero within its error, so the builds may
    # pick different roots of that sphere before the refine re-solves it.
    canary_second_pop=dict(raw_t_2e2=0.999, normal_1e3=0.99, normal_1e2=1.0, normal_max=2e-2),
)


def check_sweep(batch, res, precise):
    """The bars of phase 3 on one batch of rays."""
    bars = SWEEP_BARS[batch]
    for r in (*res.values(), *precise.values()):
        require(r["same_obj"] >= 0.999 and r["dead_rays_miss"],
                f"sweep2 winners disagree on {batch}: {r}")
    # The unrefined t is solved around the group anchor and carries an
    # absolute error (the hit block re-solves it); the refined t is held
    # relatively.
    require(res["nearest"]["t_within_2e2"] >= bars["raw_t_2e2"],
            f"sweep2 t disagrees on {batch}: {res['nearest']}")
    hb = res["hit_block"]
    require(hb["t_within_rtol_1e4"] >= 0.99 and hb["t_max_abs_err"] < 2e-2,
            f"sweep2 refined t disagrees on {batch}: {hb}")
    require(hb["fields_within_1e5"] >= 0.999, f"sweep2 hit block disagrees on {batch}: {hb}")
    require(hb["ri_equal"] >= 0.999, f"sweep2 surrounding RI disagrees on {batch}: {hb}")
    require(hb["normal_within_1e3"] >= bars["normal_1e3"]
            and hb["normal_within_1e2"] >= bars["normal_1e2"]
            and hb["normal_max_abs_err"] < bars["normal_max"],
            f"sweep2 normals disagree on {batch}: {hb}")
    hbp = precise["hit_block"]
    require(hbp["t_within_rtol_1e4"] >= 0.999 and hbp["normal_within_1e5"] >= 0.999
            and hbp["fields_within_1e5"] >= 0.999 and hbp["ri_equal"] >= 0.999
            and precise["nearest"]["t_within_rtol_1e4"] >= 0.999,
            f"sweep2 precise build disagrees on {batch}: {precise}")


def second_generation(accel, rays):
    """The rays a second pop would carry: from each first hit, even lanes
    mirror off the surface and odd lanes continue through it (so glass is
    entered); lanes whose first ray missed are dead (d = 0)."""
    t, _, rows = sweep2.sweep2_plain(accel, rays, True, True)
    o, d = rays[0:3], rays[3:6]
    hit = t < 1e30
    n = rows[sweep2.V_NX:sweep2.V_NZ + 1]
    nd = (n * d).sum(dim=0)
    n_out = torch.where(nd > 0.0, -n, n)
    pt = o + torch.where(hit, t, torch.zeros_like(t)) * d
    mirror = torch.arange(t.shape[0], device=t.device) % 2 == 0
    side = torch.where(mirror, 1e-4, -1e-4).to(torch.float32)
    d2 = torch.where(mirror, d - 2.0 * nd * n, d)
    d2 = d2 / d2.norm(dim=0).clamp_min(1e-20)
    d2 = torch.where(hit, d2, torch.zeros_like(d2))
    o2 = torch.where(hit, pt + side * n_out, o)
    return torch.cat([o2, d2, rays[6:8]]).contiguous()


def compare_uber(accel, cam, st, out_p, stats_p):
    """The persistent kernel of the current build variant against the plain
    version's output ``out_p`` on the same frame -> (numbers, kernel out)."""
    out_k, stats_k = uber.uber_render(accel, cam, st)
    torch.cuda.synchronize()
    cerr = (out_k[:, :3] - out_p[:, :3]).abs().amax(dim=1)
    terr = (out_k[:, 3] - out_p[:, 3]).abs()
    rays_k, rays_p = int(stats_k[uber.ST_RAYS]), int(stats_p[uber.ST_RAYS])
    return dict(finite=bool(torch.isfinite(out_k).all()),
                colour_within_1e4=frac(cerr <= 1e-4),
                colour_within_5e2=frac(cerr <= 5e-2),
                colour_max_abs_err=float(cerr.max()),
                mean_abs_diff=float((out_k[:, :3].mean(dim=0) - out_p[:, :3].mean(dim=0)).abs().max()),
                primary_t_within_rtol_1e4=frac(terr <= 1e-4 * out_p[:, 3]),
                rays=rays_k, ray_count_rel_diff=abs(rays_k - rays_p) / rays_p,
                dropped=int(stats_k[uber.ST_DROPPED])), (out_k, stats_k)


def check_uber(size, plain_dropped, res, precise):
    """The per-sample bars of phase 4 at one frame size."""
    require(plain_dropped == 0, f"plain version dropped rays at {size}")
    for r in (res, precise):
        require(r["finite"] and r["dropped"] == 0, f"uber output at {size}: {r}")
    require(precise["colour_within_1e4"] >= 0.999
            and precise["primary_t_within_rtol_1e4"] >= 0.999
            and precise["ray_count_rel_diff"] < 5e-4,
            f"uber precise build disagrees with the plain version at {size}: {precise}")
    require(res["primary_t_within_rtol_1e4"] >= 0.999
            and res["colour_within_1e4"] >= 0.85 and res["colour_within_5e2"] >= 0.97
            and res["mean_abs_diff"] < 5e-3 and res["ray_count_rel_diff"] < 5e-3,
            f"uber kernel disagrees with the plain version at {size}: {res}")


def compare_pixels(img, ref):
    """Per-pixel distance of two finished images (H, W, 3)."""
    err = (img - ref).abs().amax(dim=-1)
    return dict(within_atol=frac(err <= PIXEL_ATOL),
                within_1e2=frac(err <= 1e-2),
                within_1e3=frac(err <= 1e-3),
                mean_abs_err=float(err.mean()), max_abs_err=float(err.max()))


def main():
    dev = torch.device("cuda", 0)

    # 1. the card -----------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    say(phase="card", card=card, torch=torch.__version__, cuda=torch.version.cuda)

    # 2. build ----------------------------------------------------------------
    info = _build.build(with_precise=True)
    ptxas = [ln.strip() for ln in info["log"].splitlines()
             if "registers" in ln or "spill" in ln]
    say(phase="build", seconds=info["seconds"], built=info["built"], ptxas=ptxas)

    scene, camera = examples.iow_final_scene()
    scene, camera = scene.to(dev), camera.to(dev)
    cfg_s = RenderConfig(intersector="pallas", **SMALL).for_scene(scene)
    cfg = RenderConfig(intersector="pallas", **HEADLINE).for_scene(scene)

    # 3. sweep kernel against its plain version -------------------------------
    accel, cam = uber._scene_accel(scene, camera, cfg_s, GR)
    rng = np.random.default_rng(SEED)
    B3 = 100_000
    o = rng.uniform(-12.0, 12.0, (B3, 3)).astype(np.float32)
    o[:, 1] = np.abs(o[:, 1]) * 0.3 + 0.05  # above the ground, among the spheres
    d = rng.normal(size=(B3, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d[:N_DEAD] = 0.0  # dead rays
    rays = sweep2.pack_rays(
        torch.from_numpy(o).to(dev), torch.from_numpy(d).to(dev),
        torch.zeros(B3, device=dev), torch.full((B3,), 32000.0, device=dev))
    # What the sweep is given on the main path: the queue renderer's own accel
    # (no camera sort, its own probe table) and the canary's lanes.
    accel_q = _build_accel(scene, cfg_s)
    lo, ld, ltr, _ = _lane_inputs(camera, cfg_s)
    lanes = sweep2.pack_rays(lo, ld, ltr, torch.full_like(ltr, cfg_s.t_max))
    lanes2 = second_generation(accel_q, lanes)
    k2 = {}
    for batch, (acc, rr) in dict(random=(accel, rays), canary_lanes=(accel_q, lanes),
                                 canary_second_pop=(accel_q, lanes2)).items():
        res = compare_sweep(acc, rr)
        with _build.precise():
            precise = compare_sweep(acc, rr)
        say(phase="sweep2_vs_plain", batch=batch, rays=rr.shape[1],
            default_build=res, precise_build=precise)
        check_sweep(batch, res, precise)
        k2[batch] = res["hit_block"]
    require(k2["random"]["dead_rays"] == N_DEAD and k2["canary_second_pop"]["dead_rays"] > 0,
            f"dead rays missing from the sweep batches: {k2}")
    plain_ms_k2 = cuda_ms(lambda: sweep2.sweep2_plain(accel_q, lanes, True, True), 2)

    # 4. persistent kernel against its plain version ----------------------------
    st_s = uber.UberStatics.from_cfg(cfg_s)
    out_p, stats_p = uber.uber_render_plain(accel, cam, st_s)
    k1_s, _ = compare_uber(accel, cam, st_s, out_p, stats_p)
    with _build.precise():
        k1_s_precise, _ = compare_uber(accel, cam, st_s, out_p, stats_p)
    say(phase="uber_vs_plain", size=size_of(SMALL), samples=st_s.B,
        rays_plain=int(stats_p[uber.ST_RAYS]),
        default_build=k1_s, precise_build=k1_s_precise)
    check_uber(size_of(SMALL), int(stats_p[uber.ST_DROPPED]), k1_s, k1_s_precise)

    # ... and on the headline frame itself: the same tables and statics the
    # main path hands the kernel, every primary of the frame.
    accel_h, cam_h = uber._scene_accel(scene, camera, cfg, GR)
    st_h = uber.UberStatics.from_cfg(cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out_p, stats_p = uber.uber_render_plain(accel_h, cam_h, st_h)
    torch.cuda.synchronize()
    plain_ms_k1 = (time.perf_counter() - t0) * 1e3
    k1, got = compare_uber(accel_h, cam_h, st_h, out_p, stats_p)
    img_k = uber._uber_post(*got, cfg)["image"]
    with _build.precise():
        k1_precise, got = compare_uber(accel_h, cam_h, st_h, out_p, stats_p)
    img_precise = uber._uber_post(*got, cfg)["image"]
    img_p = uber._uber_post(out_p, stats_p, cfg)["image"]
    px_plain = compare_pixels(img_k, img_p)
    px_precise = compare_pixels(img_k, img_precise)
    say(phase="uber_vs_plain", size=size_of(HEADLINE), samples=st_h.B,
        rays_plain=int(stats_p[uber.ST_RAYS]), plain_seconds=plain_ms_k1 / 1e3,
        default_build=k1, precise_build=k1_precise,
        pixels_default_vs_plain=px_plain, pixels_default_vs_precise=px_precise,
        pixel_atol=PIXEL_ATOL)
    check_uber(size_of(HEADLINE), int(stats_p[uber.ST_DROPPED]), k1, k1_precise)
    for px in (px_plain, px_precise):
        require(px["within_atol"] >= PIXEL_FRAC and px["max_abs_err"] <= PIXEL_MAX
                and px["within_1e2"] >= PIXEL_FRAC_1E2 and px["mean_abs_err"] < PIXEL_MEAN,
                f"headline image of the default build is off per pixel: {px}")
    del out_p, got, img_k, img_precise, img_p

    # 5. parity canary: persistent kernel vs queue renderer ---------------------
    _build.reset_launches()  # this path's own counts
    ou = uber.render_uber(scene, camera, cfg_s, gr=GR)
    oq = render_stats(scene, camera, cfg_s)
    launches_canary = dict(_build.LAUNCHES)
    iu, iq = ou["image"], oq["image"]
    ru, rq = int(ou["rays"]), int(oq["rays"])
    mean_diff = float((iu.mean(dim=(0, 1)) - iq.mean(dim=(0, 1))).abs().max())
    ddiff = (ou["depth"].clamp_max(100.0) - oq["depth"].clamp_max(100.0)).abs()
    canary = dict(mean_image_diff=mean_diff, ray_count_ratio=ru / max(rq, 1),
                  depth_disagree_frac=frac(ddiff > 1e-2),
                  rays_dropped=int(ou["rays_dropped"]),
                  queue_rays_dropped=int(oq["rays_dropped"]),
                  launches=launches_canary)
    say(phase="canary", **canary)
    require(mean_diff < 5e-3 and abs(canary["ray_count_ratio"] - 1.0) < 0.02
            and canary["depth_disagree_frac"] < 0.01 and canary["rays_dropped"] == 0,
            f"parity canary failed: {canary}")
    require(launches_canary.get("uber") == 1 and launches_canary.get("sweep2", 0) > 0,
            f"the canary did not go through both kernels: {launches_canary}")

    # 6. the headline frame -------------------------------------------------------
    torch.cuda.reset_peak_memory_stats()
    times, launches_frames = [], []
    for frame_no in range(4):  # one warm frame, three timed
        _build.reset_launches()  # every frame carries its own counts
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = uber.render_uber(scene, camera, cfg, gr=GR)
        torch.cuda.synchronize()
        if frame_no:
            times.append(time.perf_counter() - t0)
        launches_frames.append(dict(_build.LAUNCHES))
    img = out["image"]
    rays, dropped = int(out["rays"]), int(out["rays_dropped"])
    frame = dict(size=size_of(HEADLINE),
                 seconds_per_frame_min=min(times),
                 seconds_per_frame_mean=sum(times) / len(times),
                 rays=rays, mrays_per_s=rays / min(times) / 1e6,
                 rays_dropped=dropped, image_mean=float(img.mean()),
                 launches_per_frame=launches_frames,
                 peak_memory_bytes=torch.cuda.max_memory_allocated())
    say(phase="headline", **frame)
    require(tuple(img.shape) == (cfg.height, cfg.width, 3), f"image shape {img.shape}")
    require(bool(torch.isfinite(img).all()) and bool(torch.isfinite(out["depth"]).all()),
            "headline frame is not finite")
    require(dropped == 0, f"headline frame dropped rays: {frame}")
    require(abs(rays - SCENE_RAYS) / SCENE_RAYS < 0.02, f"headline ray count: {frame}")
    require(abs(frame["image_mean"] - SCENE_MEAN) < 1e-2, f"headline image mean: {frame}")
    for got in launches_frames:
        require(got == {"uber": 1},
                f"a headline frame is one launch of the persistent kernel: {launches_frames}")

    # 7. the kernels at the main path's shapes -----------------------------------
    ms_k1 = cuda_ms(lambda: uber.uber_render(accel_h, cam_h, st_h), 3)
    with _build.precise():  # what separately rounded multiply-adds would cost
        ms_k1_precise = cuda_ms(lambda: uber.uber_render(accel_h, cam_h, st_h), 3)
    # where the rest of a frame goes: the accel build (host + device) and the
    # epilogue (per-sample sqrt, mean over samples)
    t0 = time.perf_counter()
    for _ in range(3):
        uber._scene_accel(scene, camera, cfg, GR)
    torch.cuda.synchronize()
    accel_ms = (time.perf_counter() - t0) / 3 * 1e3
    out_h, stats_h = uber.uber_render(accel_h, cam_h, st_h)
    post_ms = cuda_ms(lambda: uber._uber_post(out_h, stats_h, cfg), 3)
    n_nodes, sphere_tests = int(stats_h[uber.ST_RAYS]), int(stats_h[uber.ST_SPHERE_TESTS])
    del out_h
    say(phase="frame_breakdown", kernel_ms=ms_k1, kernel_ms_precise_build=ms_k1_precise,
        accel_build_ms=accel_ms,
        epilogue_ms=post_ms, frame_ms=min(times) * 1e3,
        sphere_tests_per_ray=sphere_tests / n_nodes)
    k1_bytes = 16 * st_h.B + accel_bytes(accel_h) + 4 * uber.CAM_LEN
    k1_flops = (sphere_tests * FLOPS_PER_SPHERE_TEST
                + n_nodes * (accel_h.n_groups * FLOPS_PER_SLAB_TEST + FLOPS_PER_NODE_SHADE))
    k1_bound, k1_by = bound(k1_bytes, k1_flops)

    # The sweep's shape on the main path: the canary's lanes, hit block + RI.
    # Counted for this run's data: quadratics the kernel solved, refines for
    # the rays that hit, the RI probe for the rays that need it.
    tests = torch.zeros(1, dtype=torch.int64, device=dev)
    _, obj_q, rows_q = sweep2._sweep2(accel_q, lanes, True, True, stats=tests)
    ms_k2 = cuda_ms(lambda: sweep2._sweep2(accel_q, lanes, True, True), 20)
    Bq = lanes.shape[1]
    hit_q = obj_q >= 0
    inner_q = (rows_q[sweep2.V_NX:sweep2.V_NZ + 1] * lanes[3:6]).sum(dim=0) > 0.0
    n_probe = int((hit_q & (inner_q | (rows_q[sweep2.V_REFR] > 0.002))).sum())
    k2_bytes = 4 * Bq * (8 + 1 + 1 + sweep2.V_ROWS) + accel_bytes(accel_q)
    k2_flops = (int(tests) * FLOPS_PER_SPHERE_TEST
                + Bq * accel_q.n_groups * FLOPS_PER_SLAB_TEST
                + int(hit_q.sum()) * FLOPS_PER_REFINE
                + n_probe * accel_q.n_pgroups * sweep2.PROBE_GR * FLOPS_PER_PROBE_ROW)
    k2_bound, k2_by = bound(k2_bytes, k2_flops)
    k2_main = k2["canary_lanes"]

    say(kernels=[
        dict(name="uber_render", route="cuda",
             source="raytracing_tests_tpu_torch/csrc/uber.cu",
             replaces="raytracing_tests_tpu/kernels/uber.py:874",
             launches=launches_frames[-1]["uber"],
             launches_by_path=dict(canary=launches_canary.get("uber", 0),
                                   headline_frame=launches_frames[-1]["uber"]),
             max_abs_err=px_plain["max_abs_err"],
             tolerance=f"finished image within {PIXEL_ATOL} of the plain version's on "
                       f">= {PIXEL_FRAC} of the pixels, at most {PIXEL_MAX} anywhere, "
                       f"{PIXEL_MEAN} on average",
             frac_within_tolerance=px_plain["within_atol"],
             per_sample_max_abs_err=k1["colour_max_abs_err"],
             per_sample_frac_within_1e4=k1["colour_within_1e4"],
             per_sample_frac_within_1e4_precise_build=k1_precise["colour_within_1e4"],
             ms=ms_k1, plain_ms=plain_ms_k1, bound_ms=k1_bound, bound_by=k1_by,
             library_ms=None, shape=size_of(HEADLINE)),
        dict(name="sweep2", route="cuda",
             source="raytracing_tests_tpu_torch/csrc/sweep2.cu",
             replaces="raytracing_tests_tpu/kernels/sweep2.py:955",
             launches=launches_canary["sweep2"],
             launches_by_path=dict(canary=launches_canary["sweep2"],
                                   headline_frame=launches_frames[-1].get("sweep2", 0)),
             max_abs_err=max(k2_main["fields_max_abs_err"], k2_main["normal_max_abs_err"]),
             tolerance="on the canary's lanes: material fields within 1e-5, "
                       "surrounding RI equal and normals within 1e-2 on >= 99.9% "
                       "of rays, refined t rtol 1e-4 on >= 99%",
             frac_within_tolerance=min(k2_main["fields_within_1e5"], k2_main["ri_equal"],
                                       k2_main["normal_within_1e2"],
                                       k2_main["t_within_rtol_1e4"]),
             ms=ms_k2, plain_ms=plain_ms_k2, bound_ms=k2_bound, bound_by=k2_by,
             library_ms=None, shape=f"{Bq} rays, hit block + RI"),
    ])
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
