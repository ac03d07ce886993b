"""Command-line interface.

Usage:
  python -m raytracing_tests_tpu_torch list
  python -m raytracing_tests_tpu_torch info
  python -m raytracing_tests_tpu_torch render <workload> [--width W --height H
        --spp S --bounces B --normals --bvh --pallas --uber --mesh N
        --out out.png --depth-out depth.png --progressive --tiles-per-step K
        --device cuda|cpu --texture image.png --texture-mapping mercator|cubic]
  python -m raytracing_tests_tpu_torch train <workload> [--steps N --lr F
        --train-fields color,position --pallas --grad-bands N --auto-pops
        --soft-edges F --mesh N --out-dir dir --ckpt-dir dir --ckpt-every N
        --device cuda|cpu]

Renders and training run on the GPU unless ``--device cpu`` is given.
``--progressive`` writes the canvas after every batch of tiles as
``<stem>_pNNN.png`` beside ``--out``.
``--mesh N`` shards the image rows over the first N GPUs (it raises when
there are fewer), or with ``--device cpu`` over N virtual shards of the CPU.
"""

from __future__ import annotations

import argparse
import logging
import os
import time

import numpy as np
import torch


def _cmd_list(_args):
    from raytracing_tests_tpu_torch.models import list_workloads

    rows = [(w.category, w.name, w.description) for w in list_workloads()]
    width = max(len(r[1]) for r in rows)
    cat = None
    for c, name, desc in rows:
        if c != cat:
            print(f"\n[{c}]")
            cat = c
        print(f"  {name:<{width}}  {desc}")


def _mesh_of(n, device):
    """``--mesh N``: N virtual shards of the CPU with ``--device cpu``, else
    the first N CUDA devices."""
    from raytracing_tests_tpu_torch.parallel import make_mesh

    if device is not None and torch.device(device).type == "cpu":
        return make_mesh(devices=["cpu"] * n)
    return make_mesh(n)


def _cmd_render(args):
    import numpy as np

    from raytracing_tests_tpu_torch.models import get_workload
    from raytracing_tests_tpu_torch.utils import io

    log = logging.getLogger("raytracing_tests_tpu_torch")
    w = get_workload(args.workload)
    kw = {"device": args.device}
    if args.width:
        kw["width"] = args.width
    if args.height:
        kw["height"] = args.height
    if args.spp:
        kw["spp"] = args.spp
    if args.bounces:
        kw["max_bounces"] = args.bounces
    if args.normals:
        kw["show_normals"] = True
    if args.bvh:
        kw["intersector"] = "bvh"
    if args.pallas:
        kw["intersector"] = "pallas"
    if args.uber:
        kw["uber"] = True
        kw["intersector"] = "pallas"
    if args.mesh:
        kw["mesh"] = _mesh_of(args.mesh, args.device)
    if args.texture:
        if args.workload != "texturing-image":
            raise SystemExit(
                "--texture is only supported by the texturing-image "
                f"workload (got {args.workload!r})")
        kw["texture"] = args.texture
        kw["texture_mapping"] = args.texture_mapping
    if args.progressive:
        # the spiral fill-in from the centre, on disk as it happens
        kw["progressive"] = True
        kw["tiles_per_step"] = args.tiles_per_step
        stem = args.out[:-4] if args.out.endswith(".png") else args.out
        written = []

        def on_frame(step):
            written.append(f"{stem}_p{len(written) + 1:03d}.png")
            io.save_png(written[-1], step["image"].detach().cpu().numpy())
            log.info("progressive: %.0f%% -> %s", 100 * step["done_fraction"], written[-1])

        kw["on_frame"] = on_frame
    t0 = time.perf_counter()
    out = w.run(**kw)
    img = out["image"].detach().cpu().numpy()  # waits for the device
    dt = time.perf_counter() - t0
    log.info("%s: %s in %.2fs", w.name, img.shape, dt)
    io.save_png(args.out, img)
    log.info("wrote %s", args.out)
    if args.depth_out and "depth" in out:
        d = out["depth"].detach().cpu().numpy()
        lo, hi = d.min(), min(d.max(), 100 * max(d.min(), 1e-3))
        io.save_png(args.depth_out, np.repeat(((d - lo) / max(hi - lo, 1e-9))[..., None], 3, -1))
        log.info("wrote %s", args.depth_out)


def _perturbed(scene, fields, seed: int):
    """The scene the training demo starts from: the trained fields moved by
    numpy ``default_rng(seed)`` draws (the JAX package's demo draws the same)."""
    rng = np.random.default_rng(seed)
    f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32))
    out = scene
    if "color" in fields:
        out = out.replace(color=scene.color * 0.5
                          + f32(rng.uniform(0, 0.5, tuple(scene.color.shape))))
    if "position" in fields:
        out = out.replace(position=scene.position
                          + f32(rng.uniform(-0.1, 0.1, tuple(scene.position.shape))))
    if "scale" in fields:
        out = out.replace(scale=scene.scale * f32(rng.uniform(0.85, 1.15, (scene.capacity, 1))))
    if out is scene:  # other fields: a mild colour shift keeps the loss above 0
        out = out.replace(color=scene.color * 0.8 + 0.1)
    return out


def _cmd_train(args):
    import dataclasses

    from raytracing_tests_tpu_torch.app import checkpoint as ckpt
    from raytracing_tests_tpu_torch.diff import (
        TrainState, adam, apply_params, make_train_step, params_mask,
    )
    from raytracing_tests_tpu_torch.models import get_workload
    from raytracing_tests_tpu_torch.ops.render import render
    from raytracing_tests_tpu_torch.utils import io

    log = logging.getLogger("raytracing_tests_tpu_torch")
    mesh = _mesh_of(args.mesh, args.device) if args.mesh else None
    w = get_workload(args.workload)
    kw = {}
    if args.pallas or args.soft_edges > 0.0:
        # the fast gradient path; the soft-edge estimator only exists there
        kw["intersector"] = "pallas"
    out = w.run(width=args.width, height=args.height, spp=args.spp, device=args.device, **kw)
    scene, camera, cfg = out["scene"], out["camera"], out["cfg"]
    target = out["image"].detach()
    fields = args.train_fields.split(",")
    perturbed = _perturbed(scene, fields, args.seed)
    if args.soft_edges > 0.0:
        cfg = dataclasses.replace(cfg, soft_edges=args.soft_edges)
    opt = adam(args.lr)
    step = make_train_step(perturbed, camera, cfg, opt, mesh=mesh, grad_bands=args.grad_bands,
                           auto_pops=args.auto_pops,
                           trainable=params_mask(perturbed, *fields), device=args.device)
    st = TrainState.create(perturbed, opt, device=args.device)
    start = 0
    if args.ckpt_dir:
        restored, start = ckpt.restore_train_state(args.ckpt_dir, st)
        if restored is not None:
            st = restored
            log.info("resumed from step %d", start)
    for k in range(start, args.steps):
        st, loss = step(st, target)
        if k % max(1, args.steps // 10) == 0 or k == args.steps - 1:
            log.info("step %4d  loss %.6g", k, float(loss))
        if args.ckpt_dir and (k + 1) % args.ckpt_every == 0:
            ckpt.save_train_state(args.ckpt_dir, st, k + 1)
    if args.out_dir:
        os.makedirs(args.out_dir, exist_ok=True)
        with torch.no_grad():
            final = render(apply_params(perturbed, st.params), camera, cfg,
                           device=args.device)
        io.save_png(f"{args.out_dir}/target.png", target.cpu().numpy())
        io.save_png(f"{args.out_dir}/final.png", final["image"].cpu().numpy())
        log.info("wrote %s/{target,final}.png", args.out_dir)


def _cmd_info(_args):
    """Device capability readout."""
    import torch

    print(f"torch {torch.__version__}, CUDA runtime {torch.version.cuda}")
    if not torch.cuda.is_available():
        print("CUDA: not available (renders need --device cpu)")
        return
    for i in range(torch.cuda.device_count()):
        p = torch.cuda.get_device_properties(i)
        print(f"  {i}: {p.name} sm_{p.major}{p.minor} "
              f"{p.multi_processor_count} SMs {p.total_memory / (1 << 30):.1f} GiB")


def main(argv=None):
    p = argparse.ArgumentParser(prog="raytracing_tests_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    sub.add_parser("list", help="list registered workloads")
    sub.add_parser("info", help="device capability readout")

    pr = sub.add_parser("render", help="render one workload to PNG")
    pr.add_argument("workload")
    pr.add_argument("--width", type=int)
    pr.add_argument("--height", type=int)
    pr.add_argument("--spp", type=int)
    pr.add_argument("--bounces", type=int)
    pr.add_argument("--normals", action="store_true", help="debug normals view")
    pr.add_argument("--bvh", action="store_true",
                    help="use the LBVH intersector (the traversal oracle; slow)")
    pr.add_argument("--pallas", action="store_true",
                    help="use the grouped sweep kernel (sphere scenes)")
    pr.add_argument("--uber", action="store_true",
                    help="use the persistent path-tracer kernel (fastest)")
    pr.add_argument("--mesh", type=int,
                    help="shard the image rows over N devices (with --device cpu: "
                    "N virtual CPU shards)")
    pr.add_argument("--out", default="render.png")
    pr.add_argument("--depth-out", help="also write normalized depth PNG")
    pr.add_argument("--progressive", action="store_true",
                    help="spiral refine-from-center tile rendering; writes "
                    "an intermediate PNG per tile batch")
    pr.add_argument("--tiles-per-step", type=int, default=4,
                    help="tiles traced per progressive step")
    pr.add_argument("--device", default=None,
                    help="torch device; default: the GPU (cuda)")
    pr.add_argument("--texture", help="image file for texturing-image "
                    "(PNG/JPG; remapped onto the cube-sphere atlas)")
    pr.add_argument("--texture-mapping", default="mercator",
                    choices=("mercator", "cubic"),
                    help="how to interpret --texture: equirectangular "
                    "or packed 6-face atlas")

    pt = sub.add_parser("train", help="inverse-rendering demo: recover scene params")
    pt.add_argument("workload")
    pt.add_argument("--steps", type=int, default=100)
    pt.add_argument("--lr", type=float, default=2e-2)
    pt.add_argument("--width", type=int, default=64)
    pt.add_argument("--height", type=int, default=36)
    pt.add_argument("--spp", type=int, default=2)
    pt.add_argument("--seed", type=int, default=0)
    pt.add_argument("--mesh", type=int,
                    help="shard the image rows over N devices and sum the "
                    "gradients (with --device cpu: N virtual CPU shards)")
    pt.add_argument("--train-fields", default="color")
    pt.add_argument("--pallas", action="store_true",
                    help="fast gradient path (kernel winner-finding + "
                    "closed-form recompute)")
    pt.add_argument("--grad-bands", type=int, default=1,
                    help="accumulate gradients over N image row bands (exact; "
                    "1/N the backward's peak memory, for full-resolution frames)")
    pt.add_argument("--auto-pops", action="store_true",
                    help="probe each band's ray-tree depth and trace the bands "
                    "to it (exact; needs --grad-bands > 1)")
    pt.add_argument("--soft-edges", type=float, default=0.0,
                    help="edge-aware gradient band (~0.03 when training "
                    "position/scale; implies the fast gradient path)")
    pt.add_argument("--out-dir")
    pt.add_argument("--ckpt-dir", help="checkpoint/resume directory")
    pt.add_argument("--ckpt-every", type=int, default=20)
    pt.add_argument("--device", default=None,
                    help="torch device; default: the GPU (cuda)")

    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    {
        "list": _cmd_list,
        "info": _cmd_info,
        "render": _cmd_render,
        "train": _cmd_train,
    }[args.cmd](args)


if __name__ == "__main__":
    main()
