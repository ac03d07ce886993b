"""In-call A/B of source variants of the sphere sweep (K2) and the megakernel
(K6) on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_ab.py

Each variant is the checkout's ``raytracing_tests_tpu_torch/csrc`` with lines
replaced (``VARIANTS``).  All variants are built with ``nvcc`` at once, each
into ``raytracing_tests_tpu_torch/_build/ab/<variant>/``, and each in turn is
put in the wrappers' library cache, so ``mega.mega_step`` and
``sweep2._sweep2`` launch it unchanged.  Each variant's outputs are compared
with the default build's on every input (``identical``: a variant that only
moves registers gives the same bits; one that moves code may round a fused
multiply-add apart).  Times are CUDA-event means at the shapes the main
paths give the kernels: K6 on the pools the lane-aligned drain hands it in the
headline frame's first chunk (2^20 lanes; the iterations of ``ITERATIONS``
and the chunk's last), K2 on the parity canary's 179 200 lanes and their
second generation.  ``ROUNDS`` rounds alternate the order of the variants.
Then each variant drives the frames that launch the two kernels,
``FRAME_ROUNDS`` times in alternating order, with every launch timed on the
device (``chip_frames.frame_times``: K6 over a natural megalanes frame of the
headline, K2 over a work-queue frame).  Prints one JSON object per variant
(its ``ptxas -v`` lines and times), then the card as ``nvidia-smi`` names it;
fails without CUDA.
"""

from __future__ import annotations

import ctypes
import json
import shutil
import subprocess
import sys

import torch

if not torch.cuda.is_available():
    sys.exit("chip_ab.py needs a CUDA device: torch.cuda.is_available() is False")

import chip_frames  # noqa: E402
import chip_smoke as cs  # noqa: E402
from raytracing_tests_tpu_torch.kernels import _build, mega, sweep2  # noqa: E402
from raytracing_tests_tpu_torch.ops.render import (  # noqa: E402
    RenderConfig, _build_accel, _lane_inputs,
)
from raytracing_tests_tpu_torch.scene import examples  # noqa: E402

ROUNDS = 4
FRAME_ROUNDS = 2
ITERATIONS = (0, 1, 2, 3, 4, 6, 8, 11)  # and the chunk's last
K2_BOUNDS = "__global__ void __launch_bounds__(THREADS, MIN_BLOCKS) sweep2_kernel("
K6_APPEND = "      if (live) cols[(l_tail + __popc(lm & below)) % RING] = i;"
K6_CLAIM = "constexpr int CLAIM = 1;"
# name -> {source file: [(line as it is, line in the variant)]}
VARIANTS = {
    "default": {},
    # K2's launch bounds: unbounded, and 4 blocks of 256 threads per SM
    "k2_unbounded": {"sweep2.cu": [(K2_BOUNDS, K2_BOUNDS.replace(", MIN_BLOCKS", ""))]},
    "k2_min_blocks_4": {"sweep2.cu": [("constexpr int MIN_BLOCKS = 3;",
                                       "constexpr int MIN_BLOCKS = 4;")]},
    # K6's launch bounds: 4 and 8 blocks of 128 threads per SM
    "k6_min_blocks_4": {"mega.cu": [("constexpr int MIN_BLOCKS = 6;",
                                     "constexpr int MIN_BLOCKS = 4;")]},
    "k6_min_blocks_8": {"mega.cu": [("constexpr int MIN_BLOCKS = 6;",
                                     "constexpr int MIN_BLOCKS = 8;")]},
    # the surrounding-RI probe row-parallel even where most of a warp needs it
    "probe_always_row_parallel": {"warp_sweep.cuh": [(
        "  if (__popc(m) >= coop_min) return need ?",
        "  if (false) return need ?")]},
    # K6's tiles per claim: a dense pass's columns spread over more or fewer
    # tiles, against a coarser or finer balance between warps
    **{f"k6_claim_{n}": {"mega.cu": [(K6_CLAIM, f"constexpr int CLAIM = {n};")]}
       for n in (2, 4, 16)},
    # K6 without compaction: each tile's live lanes traced in place, one tile
    # per claim
    "k6_no_compaction": {"mega.cu": [(K6_APPEND, (
        "      if (lm != 0u) {\n"
        "        const LaneOut o = dense_pass<MOTION>(T, P, live_rows, pool, lane_ids, s, lane,\n"
        "                                             live ? i : -1, tl);\n"
        "        if (live) write_lane(O, s, i, P.t_max, o);\n"
        "      }\n"
        "      if (true) continue;"))]},
}
LIBS = ("mega", "sweep2")


def build_variants():
    """Every variant's libraries, all nvcc started together ->
    {variant: {lib: path}}, {variant: ptxas per kernel}."""
    root = _build.BUILD_ROOT / "ab"
    shutil.rmtree(root, ignore_errors=True)
    procs, paths = [], {}
    for name, edits in VARIANTS.items():
        src = root / name / "csrc"
        shutil.copytree(_build.CSRC, src)
        for fname, subs in edits.items():
            text = (src / fname).read_text()
            for old, new in subs:
                if text.count(old) != 1:
                    raise RuntimeError(f"variant {name}: {old!r} is not one line of {fname}")
                text = text.replace(old, new)
            (src / fname).write_text(text)
        paths[name] = {}
        for lib in LIBS:
            out = root / name / f"{lib}.so"
            cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(src), "-o", str(out),
                   str(src / f"{lib}.cu")]
            procs.append((name, lib, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
            paths[name][lib] = out
    ptxas = {name: {} for name in VARIANTS}
    for name, lib, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name} {lib}:\n{log}")
        ptxas[name].update(cs.ptxas_by_kernel(f"== {lib}.so ==\n{log}"))
    return paths, ptxas


def use(paths):
    """Put one variant's libraries in the wrappers' cache."""
    for lib, path in paths.items():
        _build._LIBS[(lib, ())] = ctypes.CDLL(str(path))


def main():
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    paths, ptxas = build_variants()
    use(paths["default"])

    scene, camera = examples.iow_final_scene()
    scene, camera = scene.to(dev), camera.to(dev)
    cfg = RenderConfig(intersector="pallas", **cs.HEADLINE).for_scene(scene)
    cfg_s = RenderConfig(intersector="pallas", **cs.SMALL).for_scene(scene)
    accel = sweep2.make_accel2(scene, gr=cs.GR, has_motion=cfg.has_motion,
                               probe_rows=cfg.probe_rows, sort_origin=camera.position)
    _, iters = cs.capture_steps(accel, camera, cfg, cs.CHUNK, set())
    pools, _ = cs.capture_steps(accel, camera, cfg, cs.CHUNK, {*ITERATIONS, iters - 1})
    kw = cs.step_kw(cfg)
    accel_q = _build_accel(scene, cfg_s)
    lo, ld, ltr, _ = _lane_inputs(camera, cfg_s)
    lanes = sweep2.pack_rays(lo, ld, ltr, torch.full_like(ltr, cfg_s.t_max))
    rays = dict(canary_lanes=lanes, canary_second_pop=cs.second_generation(accel_q, lanes))

    calls = {f"K6 iteration {it}": (lambda p=p, ln=ln: mega.mega_step(accel, p, ln, **kw))
             for it, (p, ln) in sorted(pools.items())}
    calls.update({f"K2 {n}": (lambda r=r: sweep2._sweep2(accel_q, r, True, True))
                  for n, r in rays.items()})
    want = {k: fn() for k, fn in calls.items()}
    res = {name: {k: [] for k in calls} for name in VARIANTS}
    same = {}
    names = list(VARIANTS)
    for rnd in range(ROUNDS):
        for name in (names if rnd % 2 == 0 else names[::-1]):
            use(paths[name])
            if rnd == 0:
                same[name] = {k: all(torch.equal(a, b) for a, b in zip(fn(), want[k])
                                     if a is not None) for k, fn in calls.items()}
            for k, fn in calls.items():
                res[name][k].append(cs.cuda_ms(fn, 5))
    # every variant over the frames that launch the kernels, FRAME_ROUNDS
    # rounds in alternating order
    frames = {name: [] for name in VARIANTS}
    for rnd in range(FRAME_ROUNDS):
        for name in (names if rnd % 2 == 0 else names[::-1]):
            use(paths[name])
            frames[name].append(chip_frames.frame_times(scene, camera, cfg))
    for name in VARIANTS:
        ms = {k: sum(v) / len(v) for k, v in res[name].items()}
        print(json.dumps(dict(
            variant=name, ptxas=ptxas[name], identical=same[name],
            k6_frame_ms=[f["k6"]["ms"] for f in frames[name]],
            k2_frame_ms=[f["k2"]["ms"] for f in frames[name]],
            k6_frame_ms_by_iteration=frames[name][0]["k6"]["ms_by_iteration"],
            k6_ms_sum=sum(v for k, v in ms.items() if k.startswith("K6")),
            k2_ms_sum=sum(v for k, v in ms.items() if k.startswith("K2")),
            ms=ms, ms_rounds=res[name])), flush=True)
    print(card, flush=True)


if __name__ == "__main__":
    main()
