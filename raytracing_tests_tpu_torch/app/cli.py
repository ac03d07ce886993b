"""Command-line interface.

Usage:
  python -m raytracing_tests_tpu_torch list
  python -m raytracing_tests_tpu_torch info
  python -m raytracing_tests_tpu_torch render <workload> [--width W --height H
        --spp S --bounces B --pallas --uber --out out.png
        --depth-out depth.png --device cuda|cpu
        --texture image.png --texture-mapping mercator|cubic]

Renders run on the GPU unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import logging
import time


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
    if args.pallas:
        kw["intersector"] = "pallas"
    if args.uber:
        kw["uber"] = True
        kw["intersector"] = "pallas"
    if args.texture:
        if args.workload != "texturing-image":
            raise SystemExit(
                "--texture is only supported by the texturing-image "
                f"workload (got {args.workload!r})")
        kw["texture"] = args.texture
        kw["texture_mapping"] = args.texture_mapping
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
    pr.add_argument("--pallas", action="store_true",
                    help="use the grouped sweep kernel (sphere scenes)")
    pr.add_argument("--uber", action="store_true",
                    help="use the persistent path-tracer kernel (fastest)")
    pr.add_argument("--out", default="render.png")
    pr.add_argument("--depth-out", help="also write normalized depth PNG")
    pr.add_argument("--device", default=None,
                    help="torch device; default: the GPU (cuda)")
    pr.add_argument("--texture", help="image file for texturing-image "
                    "(PNG/JPG; remapped onto the cube-sphere atlas)")
    pr.add_argument("--texture-mapping", default="mercator",
                    choices=("mercator", "cubic"),
                    help="how to interpret --texture: equirectangular "
                    "or packed 6-face atlas")

    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    {
        "list": _cmd_list,
        "info": _cmd_info,
        "render": _cmd_render,
    }[args.cmd](args)


if __name__ == "__main__":
    main()
