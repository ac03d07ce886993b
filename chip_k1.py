"""The persistent path tracer (K1, ``csrc/uber.cu``) timed on one NVIDIA GPU.

Run from the repository root:

    python3 chip_k1.py [label]        # K1 at the headline's and bvh1k's statics
    python3 chip_k1.py --bounds       # launch-bound variants, materials and lights frames
    python3 chip_k1.py --tex-bounds   # launch-bound variants, texturing frames
    python3 chip_k1.py --raygen       # ptxas without the camera variants' branches

The first form builds the kernels, prints ``ptxas -v`` of ``uber.so`` and
K1's device time at the statics ``render_uber`` gives it on the headline frame
(``iow_final_scene()``, 800x450x100 depth 8), on the ``bvh1k`` frame
(``bvh_grid_scene(side=32)``, 800x450x16 depth 8) and on the lights frame
(``lights_scene()`` with its light, 800x450x16 depth 8): CUDA events around
``REPS`` launches after a warm one, ``ROUNDS`` rounds.  It calls nothing the
port did not have before materials and lights, so it runs in an older
checkout too: to compare two commits on one card, copy it there and run it in
both in turns (parent, change, change, parent).

The second form builds ``uber.cu`` variants with the launch bounds of the
lights and materials instantiations replaced (``BOUND_VARIANTS``), all
``nvcc`` started together into ``raytracing_tests_tpu_torch/_build/k1_bounds/``,
and times K1 on the materials frame (``materials_scene()``, materials shading),
the lights frame (``lights_scene()`` with its light) and a sphere-mode lit
frame (``chip_smoke.lit_spheres_scene()``), all 800x450x16 depth 8, in each
variant, in ``ROUNDS`` rounds of alternating order, with each
variant's ``ptxas`` lines and its output compared with the default build's.
The third form does the same for ``uber_tex.cu``'s bound of its static sphere
'bvh' instantiation (``TEX_BOUND_VARIANTS``) on the ``texturing`` and
``texturing-image`` frames (``texturing_scene()``, ``texturing_image_scene()``,
800x450x16 depth 8).
The fourth builds ``uber.cu`` with each of the camera variants' raygen
branches compiled out (``RAYGEN_VARIANTS``: its condition made false), and
prints the twelve instantiations' ``ptxas`` lines of each.

Prints one JSON object per measurement and the card as ``nvidia-smi`` names
it; fails without CUDA.
"""

from __future__ import annotations

import ctypes
import json
import shutil
import subprocess
import sys

import torch

if not torch.cuda.is_available():
    sys.exit("chip_k1.py needs a CUDA device: torch.cuda.is_available() is False")

import chip_smoke as cs  # noqa: E402
from raytracing_tests_tpu_torch.kernels import _build, uber  # noqa: E402
from raytracing_tests_tpu_torch.ops.render import RenderConfig  # noqa: E402
from raytracing_tests_tpu_torch.scene import examples  # noqa: E402

REPS = 3
ROUNDS = 3
FRAME16 = dict(width=800, height=450, spp=16, max_bounces=8)
LIGHTS_LINE = "constexpr int MIN_BLOCKS_LIGHTS[2] = {5, 6};"
MATERIALS_LINE = "constexpr int MIN_BLOCKS_MATERIALS[2] = {6, 5};"
# name -> [(line of uber.cu, line in the variant)]: a raygen branch of the
# camera variants compiled out, all of them, or each hinted unlikely
AA_IF, MF_IF, ORTHO_IF = ("  if (V.aa != nullptr) {", "  if (V.n_focus > 1) {",
                          "  if (V.ortho) {")
RAYGEN_VARIANTS = {
    "default": [],
    "no_aa": [(AA_IF, "  if (false) {")],
    "no_multi_focus": [(MF_IF, "  if (false) {")],
    "no_ortho": [(ORTHO_IF, "  if (false) {")],
    "none": [(c, "  if (false) {") for c in (AA_IF, MF_IF, ORTHO_IF)],
    "unlikely": [(c, f"  if (__builtin_expect({c[6:-3]}, 0)) {{") for c in (AA_IF, MF_IF, ORTHO_IF)],
}
TEX_LINE = "constexpr int MIN_BLOCKS_TEX_SPHERE = 6;"
# name -> [(line as it is, line in the variant)] of uber.cu, built as uber_tex.cu
TEX_BOUND_VARIANTS = {
    "default": [],
    **{f"tex_spheres_{n}": [(TEX_LINE, TEX_LINE.replace("6", str(n)))] for n in (4, 5, 7, 8)},
}
# name -> [(line as it is, line in the variant)]; each changes one entry: of
# the generic lights instantiation (the lights frame), the sphere lights one
# (the lit spheres frame) or the sphere materials one (the materials frame)
BOUND_VARIANTS = {
    "default": [],
    **{f"lights_generic_{n}": [(LIGHTS_LINE, LIGHTS_LINE.replace("{5, 6}", f"{{5, {n}}}"))]
       for n in (4, 5, 7, 8)},
    **{f"lights_spheres_{n}": [(LIGHTS_LINE, LIGHTS_LINE.replace("{5, 6}", f"{{{n}, 6}}"))]
       for n in (4, 6)},
    **{f"materials_spheres_{n}": [(MATERIALS_LINE, MATERIALS_LINE.replace("{6, 5}", f"{{{n}, 5}}"))]
       for n in (4, 5, 8)},
}


def card():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return smi.stdout.strip().splitlines()[0]


def k1_ms(run):
    """Mean ms of ``run()`` per round, by CUDA events."""
    return [cs.cuda_ms(run, REPS) for _ in range(ROUNDS)]


def frames(dev):
    """(name, accel, camera vector, statics, lights rows) of the frames timed."""
    from raytracing_tests_tpu_torch.ops.render import extract_lights

    out = []
    for name, (scene, camera), frame in (
            ("headline", examples.iow_final_scene(), cs.HEADLINE),
            ("bvh1k", examples.bvh_grid_scene(side=32), FRAME16),
            ("lights", examples.lights_scene(), FRAME16)):
        scene, camera = scene.to(dev), camera.to(dev)
        cfg = RenderConfig(intersector="pallas", **frame).for_scene(scene)
        rows, n = uber.pack_lights(extract_lights(scene) if name == "lights" else None)
        acc, cam = uber._scene_accel(scene, camera, cfg, min(cs.GR, max(8, scene.capacity)))
        out.append((name, acc, cam, uber.UberStatics.from_cfg(cfg, n), rows))
    return out


def headline(label):
    dev = torch.device("cuda", 0)
    info = _build.build()
    ptxas = {k: v for k, v in cs.ptxas_by_kernel(info["log"]).items() if k.startswith("uber.so")}
    print(json.dumps(dict(label=label, build_seconds=info["seconds"], ptxas=ptxas)), flush=True)
    for name, acc, cam, st, rows in frames(dev):
        ms = k1_ms(lambda: uber.uber_render(acc, cam, st, rows))
        _, stats = uber.uber_render(acc, cam, st, rows)
        print(json.dumps(dict(label=label, frame=name, k1_ms_rounds=ms, k1_ms=min(ms),
                              rays=int(stats[uber.ST_RAYS]))), flush=True)


def shading_frames(dev):
    """(name, accel, camera vector, statics, lights rows) of the materials,
    lights and lit spheres frames."""
    from raytracing_tests_tpu_torch.ops.render import extract_lights

    out = []
    for name, (scene, camera), shading, lit in (
            ("materials", examples.materials_scene(), "materials", False),
            ("lights", examples.lights_scene(), "bvh", True),
            ("lit_spheres", cs.lit_spheres_scene(), "bvh", True)):
        scene, camera = scene.to(dev), camera.to(dev)
        cfg = RenderConfig(intersector="pallas", shading=shading, **FRAME16).for_scene(scene)
        rows, n = uber.pack_lights(extract_lights(scene) if lit else None)
        acc, cam, _ = cs.k1_inputs(scene, camera, cfg)
        out.append((name, acc, cam, uber.UberStatics.from_cfg(cfg, n), rows))
    return out


def build_bound_variants(variants=BOUND_VARIANTS, source="uber",
                         kernels=("<0,0,2,0>", "<1,0,1,0>", "<0,0,1,0>")):
    """Every variant's ``source``.so (uber.cu, or uber_tex.cu which includes
    it), all nvcc started together -> {variant: path}, {variant: ptxas of
    ``kernels``}."""
    root = _build.BUILD_ROOT / f"k1_bounds_{source}"
    shutil.rmtree(root, ignore_errors=True)
    procs, paths = [], {}
    for name, subs in variants.items():
        src = root / name / "csrc"
        shutil.copytree(_build.CSRC, src)
        text = (src / "uber.cu").read_text()
        for old, new in subs:
            if text.count(old) != 1:
                raise RuntimeError(f"variant {name}: {old!r} is not one line of uber.cu")
            text = text.replace(old, new)
        (src / "uber.cu").write_text(text)
        paths[name] = root / name / f"{source}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(src), "-o", str(paths[name]),
               str(src / f"{source}.cu")]
        procs.append((name, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True)))
    ptxas = {}
    for name, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        ptxas[name] = {k: v for k, v in cs.ptxas_by_kernel(f"== {source}.so ==\n{log}").items()
                       if k.endswith(kernels)}
    return paths, ptxas


def texturing_frames(dev):
    """(name, accel, camera vector, statics, packed atlas) of the texturing
    frames."""
    from raytracing_tests_tpu_torch.kernels.texture import pack_atlas

    out = []
    for name, (scene, camera) in (("texturing", examples.texturing_scene()),
                                  ("texturing_image", examples.texturing_image_scene())):
        scene, camera = scene.to(dev), camera.to(dev)
        cfg = RenderConfig(intersector="pallas", **FRAME16).for_scene(scene)
        acc, cam, st = cs.k1_inputs(scene, camera, cfg)
        out.append((name, acc, cam, st, pack_atlas(scene.textures)))
    return out


def bounds(textured=False):
    """Time each launch-bound variant on its frames, in alternating rounds."""
    dev = torch.device("cuda", 0)
    if textured:
        source, (paths, ptxas) = "uber_tex", build_bound_variants(
            TEX_BOUND_VARIANTS, "uber_tex", ("<0,0,0,1>",))
        todo = [(f, a, c, s, None, atlas) for f, a, c, s, atlas in texturing_frames(dev)]
    else:
        source, (paths, ptxas) = "uber", build_bound_variants()
        todo = [(*f, None) for f in shading_frames(dev)]
    libs = {name: ctypes.CDLL(str(p)) for name, p in paths.items()}
    ms = {name: {f[0]: [] for f in todo} for name in libs}
    ref = {}
    for rnd in range(ROUNDS):
        for name in (list(libs) if rnd % 2 == 0 else list(libs)[::-1]):
            _build._LIBS[(source, ())] = libs[name]
            for frame, acc, cam, st, rows, atlas in todo:
                ms[name][frame].append(
                    cs.cuda_ms(lambda: uber.uber_render(acc, cam, st, rows, atlas), 2))
    for name in libs:
        _build._LIBS[(source, ())] = libs[name]
        same = {}
        for frame, acc, cam, st, rows, atlas in todo:
            out, stats = uber.uber_render(acc, cam, st, rows, atlas)
            if name == "default":
                ref[frame] = out
            same[frame] = bool(torch.equal(out, ref[frame]))
        print(json.dumps(dict(variant=name, ptxas=ptxas[name], identical_to_default=same,
                              ms={f: dict(rounds=v, min=min(v)) for f, v in ms[name].items()})),
              flush=True)
    _build._LIBS.pop((source, ()), None)


def raygen_ptxas():
    """The untextured instantiations' ptxas lines in each RAYGEN_VARIANTS."""
    _, ptxas = build_bound_variants(RAYGEN_VARIANTS, "uber", (",0>",))
    for name, lines in ptxas.items():
        print(json.dumps(dict(variant=name, ptxas={
            k.split()[-1]: (v.get("registers"), v["spill_stores"], v["spill_loads"], v["stack"])
            for k, v in sorted(lines.items())})), flush=True)


def main():
    if "--raygen" in sys.argv[1:]:
        raygen_ptxas()
    elif "--tex-bounds" in sys.argv[1:]:
        bounds(textured=True)
    elif "--bounds" in sys.argv[1:]:
        bounds()
    else:
        headline(sys.argv[1] if len(sys.argv) > 1 else "")
    print(card(), flush=True)


if __name__ == "__main__":
    main()
