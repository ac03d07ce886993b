"""Parent against change in one call: K3, the generic sweep (its nearest-hit
and silhouette instantiations), or with ``--sweep`` K4's three dense kernels
(the nearest hit, the fused nearest hit + RI, the RI sum) and K5, the grouped
sweep (``csrc/sweep.cu``), on one NVIDIA GPU.

Run from the repository root, with an older checkout of the repository
unpacked beside it (a directory that .gitignore lists), for example:

    git archive <commit> | tar -x -C _parent
    python3 chip_edge.py _parent            # or: python3 chip_edge.py _parent --quick
    python3 chip_edge.py _parent --sweep    # K4 and K5; --sweep --quick likewise

``--sweep`` builds the parent checkout's ``sweep.cu`` into
``raytracing_tests_tpu_torch/_build/sweep_parent/`` and launches it behind
this checkout's wrappers through the C interface it had before (its dense
nearest hit and RI sum lack the bounds, rows, split and counters, which
``_ParentFn`` drops: its RI sum walks the whole table; the grouped and fused
kernels' interfaces are this checkout's).  On the inputs ``chip_smoke.py`` gives the kernels: the outputs of
parent and change, and of this checkout's -fmad=false build against the plain
versions; the ``ptxas`` lines of both builds (whether the kernels this
checkout did not redesign kept theirs is printed); each kernel's time per
launch at fixed shapes in ``ROUNDS`` rounds of parent, change, change, parent
(K5 also at coop_min 1, K4 also at every split): the grid canary's lanes,
bvh1k's 5 760 000 camera lanes and their second pop, the first pop of the
first-generation grouped path; K4's fused sweep at the sphere canary's 179 200
lanes, the first pop of the first-generation dense path (44 800) and the
5 760 000 camera lanes of the sphere scene at 800x450x16; K4's dense nearest
hit at the glass canary's lanes and bvh1k's camera lanes and second pop (the
dense table), its RI sum at the glass canary's probe points, the glass volume
and the glass grid frame's first two pops; then every launch of each driven
path (the grid canary, the first-generation grouped and dense paths, the
glass canary, the bvh queue frame, the dense generic frame and the glass grid
frame at bvh1k's size) timed on the device alone, parent, change and the
variants on the same inputs in rotating order, summed.  ``--quick`` leaves
out the 5 760 000-lane shapes and the three frames and runs one round.

Builds the parent checkout's ``sweep2g.cu`` with ``nvcc`` into
``raytracing_tests_tpu_torch/_build/edge_parent/`` and this checkout's
kernels as usual, and launches the parent's through the C interface it had
before the warp sweep (no live-row bounds, no ``coop_min``), behind this
checkout's wrappers (the same Python path and checks).  Three frames, as
``chip_smoke.py`` builds them: the hard generic gradient step
(``bvh_grid_scene(side=32)`` with jittered positions, K3's nearest-hit
instantiation ``sweep2g`` behind ``fastpath._winner``), the same frame with
``soft_edges`` (``sweep2g_edge``) and the moving-groups soft step
(``sweep2g_m_edge``).  On the rays of each frame's first two pops in the
middle band:

  - the outputs of both builds against the plain version and against each
    other (the share of rays on which this checkout's default build gives the
    parent's bits), and of this checkout's -fmad=false build against the plain
    version, which must agree on every obj and edge;
  - the time of each launch by CUDA events, in ``ROUNDS`` rounds of parent,
    change, change, parent, with this checkout at coop_min 1 (the walk of one
    thread per ray) beside them; the SIMT efficiency of the nearest-hit sweep
    at the default coop_min and at 1; the bound (``chip_smoke.k3_nearest_bound``,
    ``edge_bound``);
  - for the silhouette instantiations, the nearest-hit instantiation alone on
    the same rays, parent and change (the part of the time that is not the
    silhouette pass);
  - source variants (``VARIANTS``: lines of ``csrc`` files replaced; each must
    give the same outputs) and their ``ptxas`` lines;
then each frame's whole gradient step (``banded_value_and_grad``) with every
launch of the instantiation timed by CUDA events, parent, change, change,
parent: the device total (launch latency and the wrapper's host work
included), the launches and the step's seconds; the step once more with
every launch timed on the device alone, parent and change on the same
inputs; and once more with every launch timed in each ``coop_min`` of
``COOP_SWEEP`` (``chip_smoke.k3_coop_sweep``).

``--quick`` stops after the first pop of each instantiation and one round
(a first check of a new build).  Prints one JSON object per phase, the
``ptxas -v`` lines of both builds' K3 kernels, and the card as ``nvidia-smi``
names it; fails without CUDA.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import json
import pathlib
import shutil
import subprocess
import sys
import types

import numpy as np
import torch

if not torch.cuda.is_available():
    sys.exit("chip_edge.py needs a CUDA device: torch.cuda.is_available() is False")

import chip_smoke as cs  # noqa: E402
from raytracing_tests_tpu_torch.kernels import _build, sweep2g  # noqa: E402
from raytracing_tests_tpu_torch.scene import examples  # noqa: E402

ROUNDS = 3
# Source variants of this checkout's generic sweep, timed beside it on the
# same pops: name -> [(file under csrc/, line as it is there, the variant's)].
VARIANTS = {
    "min_blocks_3": [("sweep2g.cu", "constexpr int MIN_BLOCKS = 4;",
                      "constexpr int MIN_BLOCKS = 3;")],
    "edge_min_blocks_2": [("sweep2g.cu", "constexpr int EDGE_MIN_BLOCKS = MOTION ? 2 : 4;",
                           "constexpr int EDGE_MIN_BLOCKS = MOTION ? 2 : 2;")],
    "edge_min_blocks_4": [("sweep2g.cu", "constexpr int EDGE_MIN_BLOCKS = MOTION ? 2 : 4;",
                           "constexpr int EDGE_MIN_BLOCKS = MOTION ? 4 : 4;")],
}


def say(**kw):
    print(json.dumps(kw), flush=True)


def nvcc(src_dir, so, source="sweep2g.cu"):
    """Start nvcc on ``src_dir``'s ``source`` -> the process."""
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(src_dir), "-o", str(so),
           str(pathlib.Path(src_dir) / source)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def finish(what, so, proc, argtypes):
    """Wait for ``proc`` -> (CDLL with ``argtypes``, ptxas lines); raise on failure."""
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {what}:\n{log}")
    lib = ctypes.CDLL(str(so))
    lib.rt_sweep2g.argtypes, lib.rt_sweep2g.restype = argtypes, ctypes.c_int
    return lib, cs.ptxas_by_kernel(f"== sweep2g.so ==\n{log}\n")


def build_others(parent):
    """nvcc the parent's sweep2g.cu and every variant's, all at once ->
    (parent CDLL, its ptxas lines, {variant: CDLL}, {variant: ptxas lines})."""
    p, i = ctypes.c_void_p, ctypes.c_int
    out = _build.BUILD_ROOT / "edge_parent"
    out.mkdir(parents=True, exist_ok=True)
    procs = {None: (out / "sweep2g.so", nvcc(pathlib.Path(parent) / "raytracing_tests_tpu_torch"
                                              / "csrc", out / "sweep2g.so"))}
    procs.update(start_variants(VARIANTS, "edge_variants", "sweep2g.cu"))
    # the parent's C interface: no live_rows, no coop_min
    parent_lib, parent_ptxas = finish("the parent's sweep2g.cu", *procs.pop(None),
                                      [p, p, i, i, i, i, i, i, p, i, p, p, p, p, i, p, p])
    argtypes = [p, p, p, i, i, i, i, i, i, i, p, i, p, p, p, p, i, p, p]  # this checkout's
    libs, ptxas = {}, {}
    for name, (so, proc) in procs.items():
        libs[name], ptxas[name] = finish(f"variant {name}", so, proc, argtypes)
    return parent_lib, parent_ptxas, libs, ptxas


def start_variants(variants, where, source):
    """Copy csrc/ once per variant of ``variants`` under ``_build/<where>/``,
    replace its lines and start nvcc on its ``source`` -> {name: (so, process)}."""
    root = _build.BUILD_ROOT / where
    procs = {}
    for name, subs in variants.items():
        src = root / name / "csrc"
        shutil.rmtree(src, ignore_errors=True)
        shutil.copytree(_build.CSRC, src)
        for fname, old, new in subs:
            text = (src / fname).read_text()
            if text.count(old) != 1:
                raise RuntimeError(f"variant {name}: {old!r} is not one line of {fname}")
            (src / fname).write_text(text.replace(old, new))
        so = root / name / (pathlib.Path(source).stem + ".so")
        procs[name] = (so, nvcc(src, so, source))
    return procs


class _ParentFn:
    """The parent's C function behind this checkout's wrapper: called with
    this checkout's arguments, it drops those at ``drop`` (for the generic
    sweep: ``live_rows`` and ``coop_min``)."""

    def __init__(self, fn, drop=(2, 9)):
        self.fn, self.argtypes, self.drop = fn, fn.argtypes, drop

    def __call__(self, *args):
        return self.fn(*(a for k, a in enumerate(args) if k not in self.drop))


KEY = ("sweep2g", ())  # the generic sweep's entry in _build's loaded libraries


@contextlib.contextmanager
def kernels_of(lib, key=KEY):
    """Inside: the wrappers launch ``lib``'s kernels (the same Python path,
    checks and launch counters as this checkout's)."""
    _build.load(key[0])
    saved = _build._LIBS[key]
    _build._LIBS[key] = lib
    try:
        yield
    finally:
        _build._LIBS[key] = saved


def parent_kernels(parent):
    """Inside: the wrappers launch the parent's kernel."""
    return kernels_of(types.SimpleNamespace(rt_sweep2g=_ParentFn(parent.rt_sweep2g)))


def same(a, b):
    """Shares of identical t, obj and edge."""
    return {k: cs.frac(x == y) for k, x, y in zip(("t", "obj", "edge"), a, b)}


def frames(dev):
    """The three gradient frames as chip_smoke.grad_phases builds them."""
    def jitter_of(seed):
        rng = np.random.default_rng(seed)

        def jitter(s):
            dpos = rng.uniform(-0.1, 0.1, tuple(s.position.shape)).astype(np.float32)
            return s.replace(position=s.position + torch.from_numpy(dpos).to(s.position.device))

        return jitter

    soft = cs.grad_inputs(dev, examples.bvh_grid_scene(side=32), jitter_of(cs.SEED), soft=cs.SOFT)
    hard = dict(soft, cfg=dataclasses.replace(soft["cfg"], soft_edges=0.0))
    moving = cs.grad_inputs(dev, cs.moving_groups_scene(), jitter_of(cs.SEED), soft=cs.SOFT)
    return {"sweep2g": hard, "sweep2g_edge": soft, "sweep2g_m_edge": moving}


def kernel_ms(fns, rounds):
    """{label: [ms per round]} of {label: (context factory, fn)}: each round
    times the labels in order and then reversed, 10 launches each inside its
    context; rounds alternate the order."""
    out = {k: [] for k in fns}
    for r in range(rounds):
        order = list(fns) if r % 2 == 0 else list(fns)[::-1]
        for k in order + order[::-1]:
            ctx, fn = fns[k]
            with ctx():
                out[k].append(cs.cuda_ms(fn, 10))
    return out


def pops_phase(name, g, parent, quick, variants):
    module, wrapper, plain, _ = cs.POP_KERNELS[name]
    run = getattr(module, wrapper)
    edge = name != "sweep2g"
    pops = cs.first_two_pops(g, name, g["bands"] // 2)
    none = contextlib.nullcontext
    for k, (accel, rays) in enumerate(pops[:1] if quick else pops):
        want = plain(accel, rays)
        new = run(accel, rays)
        with parent_kernels(parent):
            old = run(accel, rays)
        with _build.precise():
            new_precise = run(accel, rays)
        with cs.coop(1):
            new_lane = run(accel, rays)
            _, stats_lane = cs.k3_run(name, accel, rays)
        _, stats = cs.k3_run(name, accel, rays)
        B = rays.shape[1]
        bnd = (cs.edge_bound(name, accel, rays, stats) if edge else
               dict(zip(("bound_ms", "bound_by"), cs.k3_nearest_bound(accel, B, stats))))
        fns = {"parent": (lambda: parent_kernels(parent), lambda: run(accel, rays)),
               "change": (none, lambda: run(accel, rays)),
               "change_per_lane": (lambda: cs.coop(1), lambda: run(accel, rays))}
        if edge:
            nearest = lambda: sweep2g._sweep2g(accel, rays)  # noqa: E731
            fns["parent_nearest_only"] = (lambda: parent_kernels(parent), nearest)
            fns["nearest_only"] = (none, nearest)
        for v, lib in variants.items():
            with kernels_of(lib):
                if min(same(run(accel, rays), new).values()) < 1.0:
                    raise AssertionError(f"variant {v} changes the outputs of {name}")
            fns[v] = (lambda lib=lib: kernels_of(lib), lambda: run(accel, rays))
        times = kernel_ms(fns, 1 if quick else ROUNDS)
        res = dict(phase="k3_pop", kernel=name, pop=k + 1, rays=B,
                   change_vs_plain=same(new, want), precise_vs_plain=same(new_precise, want),
                   parent_vs_plain=same(old, want), change_vs_parent=same(new, old),
                   per_lane_vs_change=same(new_lane, new),
                   ms={f: min(t) for f, t in times.items()}, rounds_ms=times,
                   simt=cs.k3_simt(stats), simt_per_lane_mode=cs.k3_simt(stats_lane), **bnd)
        if edge:
            res.update(cs.edge_pairs(rays, new[1], stats, bnd["rows"]))
        say(**res)
        exact = same(new_precise, want)
        cs.require(exact["obj"] == 1.0 and exact.get("edge", 1.0) == 1.0,
                   f"{name} pop {k + 1}: the -fmad=false build differs from the plain version")


def step_phase(name, g, parent):
    """The frame's gradient step, parent, change, change, parent, with every
    launch of the instantiation timed (the wrapper's host work included, the
    same for both); then its coop_min sweep."""
    module, wrapper, _, _ = cs.POP_KERNELS[name]
    out = {"parent": [], "change": []}
    for who in ("parent", "change", "change", "parent"):
        with parent_kernels(parent) if who == "parent" else contextlib.nullcontext():
            with cs.launch_events(module, wrapper) as ev:
                k = cs.grad_step(g)
            out[who].append(dict(seconds_per_step=k["ms"] / 1e3, device_ms=cs.events_ms(ev),
                                 launches=len(ev), loss=float(k["loss"])))
    say(phase="k3_step", kernel=name, bands=g["bands"], band_pops=g["pops"], **out)
    step_device_phase(name, g, parent)
    cs.k3_coop_sweep(f"{name} step (chip_edge.py)", g, name)


def step_device_phase(name, g, parent):
    """The frame's gradient step once more, every launch of the instantiation
    timed on the device alone (``chip_smoke.gapless_events``, the faster of
    two timings), parent and change on the same inputs in alternating order:
    their sums over the step and the share of launches the change won."""
    module, wrapper, _, _ = cs.POP_KERNELS[name]
    real = getattr(module, wrapper)
    got = {"parent": [], "change": []}

    def hook(accel, rays, stats=None):
        real(accel, rays)  # untimed: the live-row bounds, the allocator's memory
        who = ("parent", "change") if len(got["change"]) % 2 == 0 else ("change", "parent")
        for w in who:
            with parent_kernels(parent) if w == "parent" else contextlib.nullcontext():
                got[w].append([cs.gapless_events(lambda: real(accel, rays)) for _ in range(2)])
        return real(accel, rays)

    with cs.patched(module, wrapper, hook):
        cs.grad_step(g)
    torch.cuda.synchronize()
    ms = {w: [min(a.elapsed_time(b) for a, b in ev) for ev in evs] for w, evs in got.items()}
    say(phase="k3_step_device", kernel=name, launches=len(ms["change"]),
        parent_ms=sum(ms["parent"]), change_ms=sum(ms["change"]),
        change_won=sum(c < p for c, p in zip(ms["change"], ms["parent"])) / len(ms["change"]),
        slowest_change=sorted(ms["change"])[-3:], slowest_parent=sorted(ms["parent"])[-3:])


# ---------------------------------------------------------------------------
# --sweep: K4's fused dense sweep and K5, csrc/sweep.cu
# ---------------------------------------------------------------------------

SWEEP_KEY = ("sweep", ())
# Source variants of this checkout's sweep.cu, timed beside it on the kernel
# their name begins with (each must give the same outputs).
SWEEP_VARIANTS = {
    "k5_min_blocks_4": [("sweep.cu", "constexpr int G_MIN_BLOCKS = 5;",
                         "constexpr int G_MIN_BLOCKS = 4;")],
    "k4_unroll_1": [("sweep.cu", "#pragma unroll 4\n    for (int j = sub; j < n; j += K) {",
                     "#pragma unroll 1\n    for (int j = sub; j < n; j += K) {")],
    "k4_unroll_8": [("sweep.cu", "#pragma unroll 4\n    for (int j = sub; j < n; j += K) {",
                     "#pragma unroll 8\n    for (int j = sub; j < n; j += K) {")],
}


def build_sweep_others(parent):
    """nvcc the parent's sweep.cu and every SWEEP_VARIANTS one, all at once ->
    (the parent's four C functions behind this checkout's wrappers, its ptxas
    lines, {variant: CDLL}, {variant: ptxas lines}); this checkout's own, as
    variant "change", for its ptxas lines, whether or not _build had it."""
    p, i = ctypes.c_void_p, ctypes.c_int
    out = _build.BUILD_ROOT / "sweep_parent"
    out.mkdir(parents=True, exist_ok=True)
    proc = nvcc(pathlib.Path(parent) / "raytracing_tests_tpu_torch" / "csrc", out / "sweep.so",
                "sweep.cu")
    procs = start_variants({"change": [], **SWEEP_VARIANTS}, "sweep_variants", "sweep.cu")
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for the parent's sweep.cu:\n{log}")
    libs, ptxas = {}, {}
    for name, (so, vproc) in procs.items():
        vlog, _ = vproc.communicate()
        if vproc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{vlog}")
        libs[name] = ctypes.CDLL(str(so))
        ptxas[name] = cs.ptxas_by_kernel(f"== sweep.so ==\n{vlog}\n")
    lib = ctypes.CDLL(str(out / "sweep.so"))
    for name, argtypes in dict(rt_sweep_nearest=[p, i, i, p, i, p, p, p],
                               rt_sweep_ri=[p, i, i, p, i, p, p],
                               rt_sweep_nearest_ri=[p, i, i, p, i, p, p, p, p],
                               rt_sweep_grouped=[p, p, p, i, i, i, i, i, p, i, p, p, p, p,
                                                 p]).items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
    ns = types.SimpleNamespace(
        # the parent's dense kernels take no bounds, split or stats
        rt_sweep_nearest=_ParentFn(lib.rt_sweep_nearest, drop=(3, 4, 9)),
        # ... nor the RI rows: the parent walks the whole table
        rt_sweep_ri=_ParentFn(lib.rt_sweep_ri, drop=(3, 4, 5, 6, 10)),
        rt_sweep_nearest_ri=lib.rt_sweep_nearest_ri, rt_sweep_grouped=lib.rt_sweep_grouped)
    return ns, cs.ptxas_by_kernel(f"== sweep.so ==\n{log}\n"), libs, ptxas


def sweep_inputs(dev, quick):
    """The inputs chip_smoke.py gives K4 and K5 -> (K5 shapes {name: args of
    _launch_grouped}, K4 fused shapes {name: (table, rays)}, K4 dense shapes
    {name: (kind, table, mode, rays or points)}, driven paths {name: (wrapper
    names, render)})."""
    scene, camera = examples.bvh_grid_scene(side=32)
    scene, camera = scene.to(dev), camera.to(dev)
    cfg = cs.RenderConfig(intersector="pallas", **cs.BVH1K).for_scene(scene)
    cfg_s = cs.RenderConfig(intersector="pallas", **cs.SMALL).for_scene(scene)
    acc5 = cs._build_accel(scene, cfg)

    def lanes_of(cam, c):
        lo, ld, ltr, _ = cs._lane_inputs(cam, c)
        return cs.sweep2.pack_rays(lo, ld, ltr, torch.full_like(ltr, c.t_max))

    g5 = lambda rr: (acc5.table, acc5.gaabb, rr, acc5.group, False, "generic")  # noqa: E731
    i_scene, i_cam = examples.iow_final_scene()
    i_scene, i_cam = i_scene.to(dev), i_cam.to(dev)
    i_cfg = cs.RenderConfig(intersector="pallas", **cs.SMALL).for_scene(i_scene)
    s_dense = cs.sweep.make_accel(i_scene, "spheres", group=0)
    cfg_v1 = dataclasses.replace(i_cfg, pallas_v2=False, spp=2)
    with cs.launches_of(cs.sweep, "_launch_grouped") as pops:
        cs.render_stats(i_scene, i_cam, dataclasses.replace(cfg_v1, pallas_groups=32))
    with cs.launches_of(cs.sweep, "_launch_nearest_ri") as dense_pops:
        cs.render_stats(i_scene, i_cam, dataclasses.replace(cfg_v1, pallas_groups=0))
    k5 = {"grid canary lanes": g5(lanes_of(camera, cfg_s)),
          "first_generation_grouped pop 1": pops[0]}
    k4 = {"sphere canary lanes": (s_dense.table, lanes_of(i_cam, i_cfg)),
          "first_generation_dense pop 1": dense_pops[0]}
    # K4's dense kernels: the glass canary (the overlapping glass scene, dense)
    gl_scene, gl_cam = cs.overlapping_glass_scene()
    gl_scene, gl_cam = gl_scene.to(dev), gl_cam.to(dev)
    cfg_gl = cs.RenderConfig(intersector="pallas", pallas_groups=0,
                             **cs.GLASS).for_scene(gl_scene)
    acc_gl = cs._build_accel(gl_scene, cfg_gl)
    gl_lanes = lanes_of(gl_cam, cfg_gl)
    vol = cs.seeded_rays((0.2, 0.0, -3.5), 0.9, 100_000, dev, n_dead=0)
    k4d = {"glass canary lanes": ("nearest", acc_gl.table, "generic", gl_lanes),
           "glass canary probe points": ("ri", acc_gl.table, "generic",
                                         cs.probe_points(acc_gl, gl_lanes)),
           "glass volume": ("ri", acc_gl.table, "generic",
                            torch.cat([vol[0:3], vol[6:7]]).contiguous())}
    paths = {"grid canary": (("_launch_grouped",), lambda: cs.render_stats(scene, camera, cfg_s)),
             "first_generation_grouped": (("_launch_grouped",), lambda: cs.render_stats(
                 i_scene, i_cam, dataclasses.replace(cfg_v1, pallas_groups=32))),
             "first_generation_dense": (("_launch_nearest_ri",), lambda: cs.render_stats(
                 i_scene, i_cam, dataclasses.replace(cfg_v1, pallas_groups=0))),
             "glass canary": (("_launch_nearest", "_launch_ri"),
                              lambda: cs.render_stats(gl_scene, gl_cam, cfg_gl))}
    if not quick:
        lanes = lanes_of(camera, cfg)
        k5["bvh1k camera lanes"] = g5(lanes)
        k5["bvh1k second pop"] = g5(cs.second_generation_g(acc5, lanes))
        cfg_i16 = cs.RenderConfig(intersector="pallas", **cs.BVH1K).for_scene(i_scene)
        k4["iow camera lanes 800x450x16"] = (s_dense.table, lanes_of(i_cam, cfg_i16))
        acc4 = cs._build_accel(scene, dataclasses.replace(cfg, pallas_groups=0))
        k4d["bvh1k camera lanes"] = ("nearest", acc4.table, "generic", lanes)
        k4d["bvh1k second pop"] = ("nearest", acc4.table, "generic",
                                   cs.second_generation_g(acc5, lanes))
        gg_scene, gg_cam = cs.glass_grid_scene()
        gg_scene, gg_cam = gg_scene.to(dev), gg_cam.to(dev)
        cfg_gg = cs.RenderConfig(intersector="pallas", **cs.BVH1K).for_scene(gg_scene)
        with cs.launches_of(cs.sweep, "_launch_ri") as ri_pops:
            cs.render_stats(gg_scene, gg_cam, cfg_gg)
        for k, (table, mode, pts) in enumerate(ri_pops[:2]):
            k4d[f"glass_grid_frame pop {k + 1}"] = ("ri", table, mode, pts)
        del ri_pops
        cfg_dense = dataclasses.replace(cfg, pallas_groups=0)
        paths["bvh queue frame"] = (("_launch_grouped",),
                                    lambda: cs.render_stats(scene, camera, cfg))
        paths["dense_generic_frame"] = (("_launch_nearest",),
                                        lambda: cs.render_stats(scene, camera, cfg_dense))
        paths["glass_grid_frame"] = (("_launch_ri",),
                                     lambda: cs.render_stats(gg_scene, gg_cam, cfg_gg))
    return k5, k4, k4d, paths


def sweep_shapes(parent, variants, k5, k4, k4d, rounds):
    """Per launch at fixed shapes: outputs and times of parent, change and
    the source variants."""
    none = contextlib.nullcontext
    old_of = lambda: kernels_of(parent, SWEEP_KEY)  # noqa: E731
    for name, args in k5.items():
        run = lambda: cs.sweep._launch_grouped(*args)  # noqa: E731
        new, (_, stats) = run(), cs.k5_run(*args)
        with old_of():
            old = run()
        with _build.precise():
            precise = run()
        want = cs.sweep.sweep_grouped_plain(*args)
        fns = {"parent": (old_of, run), "change": (none, run),
               "change_per_lane": (lambda: cs.coop(1), run),
               "change_row_parallel": (lambda: cs.coop(33), run)}
        for v, lib in variants.items():
            if v.startswith("k5_"):
                with kernels_of(lib, SWEEP_KEY):
                    if min(same(run(), new).values()) < 1.0:
                        raise AssertionError(f"variant {v} changes the outputs of K5 on {name}")
                fns[v] = (lambda lib=lib: kernels_of(lib, SWEEP_KEY), run)
        times = kernel_ms(fns, rounds)
        bnd = cs.k5_bound(args[0], args[1], args[2], args[4], args[5], stats)
        say(phase="k5_shape", shape=name, rays=args[2].shape[1], with_ri=args[4], mode=args[5],
            change_vs_parent=same(new, old), precise_vs_plain=cs.exact_vs_plain(precise, want),
            ms={f: min(t) for f, t in times.items()}, rounds_ms=times, bound_ms=bnd[0],
            bound_by=bnd[1], **cs.k5_simt(stats))
    for name, (table, rays) in k4.items():
        run = lambda k=None: cs.sweep._launch_nearest_ri(table, rays, k)  # noqa: E731
        new = run()
        with old_of():
            old = run()
        with _build.precise():
            precise = run()
        want = cs.sweep.sweep_nearest_ri_plain(table, rays)
        with _build.precise():
            splits = {k: same(run(k), precise) for k in cs.sweep.NRI_SPLITS}
        cs.require(all(min(v.values()) == 1.0 for v in splits.values()),
                   f"K4 splits differ on {name}: {splits}")
        fns = {"parent": (old_of, run), "change": (none, run),
               **{f"change_K{k}": (none, lambda k=k: run(k)) for k in cs.sweep.NRI_SPLITS}}
        for v, lib in variants.items():
            if v.startswith("k4_"):
                with kernels_of(lib, SWEEP_KEY):
                    if min(same(run(), new).values()) < 1.0:
                        raise AssertionError(f"variant {v} changes the outputs of K4 on {name}")
                fns[v] = (lambda lib=lib: kernels_of(lib, SWEEP_KEY), run)
        times = kernel_ms(fns, rounds)
        bnd = cs.k4_nri_bound(table, rays)
        say(phase="k4_nri_shape", shape=name, rays=rays.shape[1],
            default_split=cs.sweep.nearest_ri_split(rays.shape[1]),
            change_vs_parent=same(new, old), precise_vs_plain=cs.exact_vs_plain(precise, want),
            ms={f: min(t) for f, t in times.items()}, rounds_ms=times, bound_ms=bnd[0],
            bound_by=bnd[1])
    for name, (kind, table, mode, x) in k4d.items():
        launch = cs._K4_LAUNCH[kind]
        run = lambda k=None: launch(table, mode, x, k)  # noqa: E731
        tup = lambda o: o if kind == "nearest" else (o,)  # noqa: E731
        new = tup(run())
        with old_of():
            old = tup(run())
        with _build.precise():
            splits = {k: tup(run(k)) for k in cs.sweep.NRI_SPLITS}
        want = (cs.sweep.sweep_nearest_plain(table, mode, x) if kind == "nearest"
                else (cs.sweep.sweep_ri_plain(table, mode, x),))
        exact = all(torch.equal(a, b) for o in splits.values() for a, b in zip(o, want))
        cs.require(exact, f"K4 {kind} on {name}: a split of the -fmad=false build differs "
                   "from the plain version")
        fns = {"parent": (old_of, run), "change": (none, run),
               **{f"change_K{k}": (none, lambda k=k: run(k)) for k in cs.sweep.NRI_SPLITS}}
        times = kernel_ms(fns, rounds)
        _, stats = cs.k4_run(kind, table, mode, x)
        say(phase=f"k4_{kind}_shape", shape=name, mode=mode, size=x.shape[1],
            rows=table.shape[0], default_split=cs.sweep.nearest_ri_split(x.shape[1]),
            change_vs_parent={k: cs.frac(a == b) for k, a, b in zip(("t", "obj", "ri")[
                2 if kind == "ri" else 0:], new, old)},
            ms={f: min(t) for f, t in times.items()}, rounds_ms=times,
            **cs.k4_bound(kind, table, mode, x, stats), **cs.k4_counts(stats))


def sweep_path(name, wrapper, render, parent, variants):
    """Every launch of ``wrapper`` over ``render()`` timed on the device alone,
    parent, change and each source variant on the same inputs in rotating
    order (the faster of two timings each) -> their sums."""
    real = getattr(cs.sweep, wrapper)
    prefix = {"_launch_grouped": "k5_", "_launch_nearest_ri": "k4_"}.get(wrapper)
    bound_of = {"_launch_grouped": cs.k5_bound_of_launch,
                "_launch_nearest_ri": cs.k4_nri_bound_of_launch,
                "_launch_nearest": cs.K4Path("nearest"), "_launch_ri": cs.K4Path("ri")}[wrapper]
    libs = {"parent": parent, "change": None,
            **{v: lib for v, lib in variants.items() if prefix and v.startswith(prefix)}}
    got = {w: [] for w in libs}
    bounds = []

    def hook(table, *args, **kw):
        kw.pop("stats", None)
        real(table, *args, **kw)  # untimed: the live-row bounds, the allocator's memory
        k = len(got["change"]) % len(libs)
        for w in list(libs)[k:] + list(libs)[:k]:
            with kernels_of(libs[w], SWEEP_KEY) if libs[w] else contextlib.nullcontext():
                got[w].append([cs.gapless_events(lambda: real(table, *args, **kw))
                               for _ in range(2)])
        bounds.append(bound_of(table, *args))
        return real(table, *args, **kw)

    with cs.patched(cs.sweep, wrapper, hook):
        render()
    torch.cuda.synchronize()
    ms = {w: [min(a.elapsed_time(b) for a, b in ev) for ev in evs] for w, evs in got.items()}
    say(phase="sweep_path", path=name, kernel=wrapper, launches=len(ms["change"]),
        parent_ms=sum(ms["parent"]), change_ms=sum(ms["change"]), bound_ms=sum(bounds),
        variants_ms={v: sum(ms[v]) for v in ms if v not in ("parent", "change")},
        parent_lost_ms=sum(ms["parent"]) - sum(bounds),
        change_lost_ms=sum(ms["change"]) - sum(bounds),
        change_won=sum(c < p for c, p in zip(ms["change"], ms["parent"])) / len(ms["change"]),
        change_by_launch=ms["change"], parent_by_launch=ms["parent"])


def sweep_main(parent_dir, quick, dev):
    info = _build.build(with_precise=True)
    parent, ptxas_parent, variants, ptxas_variants = build_sweep_others(parent_dir)
    del variants["change"]
    ptxas = ptxas_variants.pop("change")
    kept = {k: ptxas.get(k) == v for k, v in ptxas_parent.items()
            if "nearest_ri_kernel" in k or "grouped_kernel" in k}
    say(phase="build", seconds=info["seconds"], change=ptxas, parent=ptxas_parent,
        variants=ptxas_variants, untouched_kernels_as_parent=kept)
    k5, k4, k4d, paths = sweep_inputs(dev, quick)
    sweep_shapes(parent, variants, k5, k4, k4d, 1 if quick else ROUNDS)
    for name, (wrappers, render) in paths.items():
        for wrapper in wrappers:
            sweep_path(name, wrapper, render, parent, variants)


def main():
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    quick = "--quick" in sys.argv[1:]
    parent = args[0] if args else "_parent"
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    say(phase="card", card=card, torch=torch.__version__, cuda=torch.version.cuda)
    if "--sweep" in sys.argv[1:]:
        sweep_main(parent, quick, dev)
        print(card, flush=True)
        return
    info = _build.build(with_precise=True)
    parent_lib, ptxas_parent, variants, ptxas_variants = build_others(parent)
    ptxas = cs.ptxas_by_kernel(info["log"])
    say(phase="build", seconds=info["seconds"],
        change={k: v for k, v in ptxas.items() if k.startswith("sweep2g.so")},
        parent=ptxas_parent, variants=ptxas_variants)
    for name, g in frames(dev).items():
        pops_phase(name, g, parent_lib, quick, variants)
        if not quick:
            step_phase(name, g, parent_lib)
    print(card, flush=True)


if __name__ == "__main__":
    main()
