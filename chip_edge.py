"""Parent against change in one call: the generic silhouette pass (K3) on one
NVIDIA GPU.

Run from the repository root, with an older checkout of the repository
unpacked beside it (a directory that .gitignore lists), for example:

    git archive <commit> | tar -x -C _parent
    python3 chip_edge.py _parent            # or: python3 chip_edge.py _parent --quick

Builds the parent checkout's ``sweep2g.cu`` with ``nvcc`` into
``raytracing_tests_tpu_torch/_build/edge_parent/`` and this checkout's
kernels as usual, and launches the parent's through the C interface its
silhouette instantiations had before the cull (no block table: a dense pass
over every row), behind this checkout's wrappers (the same Python path and
checks).  For both silhouette instantiations of K3 (``sweep2g_edge``,
``sweep2g_m_edge``) on the gradient frame ``chip_smoke.py`` gives it, and on
the rays of that frame's first two pops in the middle band:

  - (t, obj, edge) of both against the plain version, and against each other
    (the -fmad=false build of this checkout against the plain version too);
  - the time of each launch by CUDA events, in ``ROUNDS`` rounds of parent,
    change, change, parent; the bound (the culled and the dense count beside
    it) and the share of (live ray, row) pairs the culled pass evaluated, for
    rays that hit and rays that missed (``chip_smoke.edge_bound``,
    ``edge_pairs``);
  - the nearest-hit instantiation alone on the same rays (the part of the
    time that is not the silhouette pass), and source variants of the walk
    (``VARIANTS``, lines of ``csrc/edge_cull.cuh`` replaced; each must give
    the same outputs);
  - the culled pass with other block sizes (``BLOCK_SIZES``: rows per block
    and per super-block, on a copy of the accel,
    ``edge_cull._with_block_sizes``; the kernel is the same);
  - then the frame's whole gradient step (``banded_value_and_grad``) with
    every launch of the instantiation timed by CUDA events, parent, change,
    change, parent: the device total, the launches and the step's seconds.

``--quick`` stops after the first pop of each instantiation and one round
(a first check of a new build).  Prints one JSON object per phase, the
``ptxas -v`` lines of both builds' silhouette kernels, and the card as
``nvidia-smi`` names it; fails without CUDA.
"""

from __future__ import annotations

import contextlib
import ctypes
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
from raytracing_tests_tpu_torch.kernels import _build, edge_cull, sweep2g  # noqa: E402
from raytracing_tests_tpu_torch.scene import examples  # noqa: E402

ROUNDS = 3
# Source variants of this checkout's silhouette walk, timed beside it on the
# same pops: name -> [(line as it is in csrc/edge_cull.cuh, the variant's)].
VARIANTS = {
    # step 1 (the pick of the least-bound super-block) for every lane, seeded or not
    "pick_for_every_lane": [("  if (active && best.row < 0) {", "  if (active) {")],
}
# rows per block and per super-block of the block table
BLOCK_SIZES = ((1, 16), (2, 8), (2, 16), (4, 32), (8, 32))
ORDER = ("sweep2g_edge", "sweep2g_m_edge")


def say(**kw):
    print(json.dumps(kw), flush=True)


def build_parent(parent):
    """nvcc the parent's generic sweep source -> (CDLL, ptxas lines)."""
    src = pathlib.Path(parent) / "raytracing_tests_tpu_torch" / "csrc"
    out = _build.BUILD_ROOT / "edge_parent"
    out.mkdir(parents=True, exist_ok=True)
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(src), "-o",
           str(out / "sweep2g.so"), str(src / "sweep2g.cu")]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for the parent's sweep2g.cu:\n{proc.stdout}")
    lib = ctypes.CDLL(str(out / "sweep2g.so"))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.rt_sweep2g.argtypes = [p, p, i, i, i, i, i, i, p, i, p, p, p, p, p]
    lib.rt_sweep2g.restype = ctypes.c_int
    return lib, cs.ptxas_by_kernel(f"== sweep2g.so ==\n{proc.stdout}\n")


class _ParentFn:
    """The parent's C function behind this checkout's wrapper: called with
    this checkout's arguments, it drops the two of the block table."""

    def __init__(self, fn, drop):
        self.fn, self.drop, self.argtypes = fn, drop, fn.argtypes

    def __call__(self, *args):
        return self.fn(*(a for k, a in enumerate(args) if k not in self.drop))


KEY = ("sweep2g", ())  # the generic sweep's entry in _build's loaded libraries


@contextlib.contextmanager
def kernels_of(lib):
    """Inside: the wrappers launch ``lib``'s kernels (the same Python path,
    checks and launch counters as this checkout's)."""
    _build.load("sweep2g")
    saved = _build._LIBS[KEY]
    _build._LIBS[KEY] = lib
    try:
        yield
    finally:
        _build._LIBS[KEY] = saved


def parent_kernels(parent):
    """Inside: the wrappers launch the parent's kernel."""
    return kernels_of(types.SimpleNamespace(rt_sweep2g=_ParentFn(parent.rt_sweep2g, (13, 14))))


def build_variants():
    """nvcc every variant's sweep2g.cu -> {variant: CDLL} with this
    checkout's C interface."""
    root = _build.BUILD_ROOT / "edge_variants"
    procs, out = [], {}
    for name, subs in VARIANTS.items():
        src = root / name / "csrc"
        shutil.rmtree(src, ignore_errors=True)
        shutil.copytree(_build.CSRC, src)
        text = (src / "edge_cull.cuh").read_text()
        for old, new in subs:
            if text.count(old) != 1:
                raise RuntimeError(f"variant {name}: {old!r} is not one line of edge_cull.cuh")
            text = text.replace(old, new)
        (src / "edge_cull.cuh").write_text(text)
        so = root / name / "sweep2g.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(src), "-o", str(so),
               str(src / "sweep2g.cu")]
        procs.append((name, so, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    argtypes = _build.load("sweep2g").rt_sweep2g.argtypes
    for name, so, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{log}")
        lib = ctypes.CDLL(str(so))
        lib.rt_sweep2g.argtypes, lib.rt_sweep2g.restype = argtypes, ctypes.c_int
        out[name] = lib
    return out


def same(a, b):
    """Shares of identical t, obj and edge."""
    return {k: cs.frac(x == y) for k, x, y in zip(("t", "obj", "edge"), a, b)}


def frame(dev, name):
    """The gradient frame of ``name`` as chip_smoke.grad_phases builds it."""
    rng = np.random.default_rng(cs.SEED)

    def jitter(s):
        dpos = torch.from_numpy(rng.uniform(-0.1, 0.1, tuple(s.position.shape)).astype(np.float32))
        return s.replace(position=s.position + dpos.to(s.position.device))

    scene_cam = {"sweep2g_edge": lambda: examples.bvh_grid_scene(side=32),
                 "sweep2g_m_edge": cs.moving_groups_scene}[name]()
    return cs.grad_inputs(dev, scene_cam, jitter, soft=cs.SOFT)


def kernel_ms(fns, reps=10):
    """{label: [ms per round]} of {label: (context, fn)}: each round times
    the labels in order and then reversed, ``reps`` launches each inside its
    context; rounds alternate the order."""
    out = {k: [] for k in fns}
    for r in range(ROUNDS):
        order = list(fns) if r % 2 == 0 else list(fns)[::-1]
        for k in order + order[::-1]:
            ctx, fn = fns[k]
            with ctx():
                out[k].append(cs.cuda_ms(fn, reps))
    return out


def pops_phase(name, g, parent, quick, variants):
    module, wrapper, plain, _ = cs.EDGE_KERNELS[name]
    run = getattr(module, wrapper)
    pops = cs.first_two_pops(g, name, g["bands"] // 2)
    for k, (accel, rays) in enumerate(pops[:1] if quick else pops):
        want = plain(accel, rays)
        new = run(accel, rays)
        with parent_kernels(parent):
            old = run(accel, rays)
        with _build.precise():
            new_precise = run(accel, rays)
        stats = torch.zeros(sweep2g.EC_LEN, dtype=torch.int64, device=rays.device)
        run(accel, rays, stats)
        bnd = cs.edge_bound(name, accel, rays, stats)

        none = contextlib.nullcontext
        fns = {"parent": (lambda: parent_kernels(parent), lambda: run(accel, rays)),
               "change": (none, lambda: run(accel, rays)),
               "nearest_only": (none, lambda: sweep2g._sweep2g(accel, rays))}
        for v, lib in variants.items():
            with kernels_of(lib):
                if min(same(run(accel, rays), new).values()) < 1.0:
                    raise AssertionError(f"variant {v} changes the outputs of {name}")
            fns[v] = (lambda lib=lib: kernels_of(lib), lambda: run(accel, rays))
        times = kernel_ms(fns)
        table, n_super = edge_cull.edge_blocks(accel)
        res = dict(phase="edge_pop", kernel=name, pop=k + 1, rays=rays.shape[1],
                   entries=int(table.shape[0]), super_blocks=n_super,
                   block_sizes_default=(edge_cull.BLOCK_ROWS, edge_cull.SUPER_ROWS),
                   change_vs_plain=same(new, want), precise_vs_plain=same(new_precise, want),
                   parent_vs_plain=same(old, want), change_vs_parent=same(new, old),
                   parent_ms=min(times["parent"]), change_ms=min(times["change"]),
                   nearest_only_ms=min(times["nearest_only"]),
                   variants_ms={v: min(times[v]) for v in variants},
                   rounds_ms=times, **bnd, **cs.edge_pairs(rays, new[1], stats, bnd["rows"]))
        if not quick:
            sizes = {}
            for size in BLOCK_SIZES:
                other = edge_cull._with_block_sizes(accel, *size)
                st = torch.zeros_like(stats)
                got = run(other, rays, st)
                sizes[f"{size[0]}/{size[1]}"] = dict(
                    ms=cs.cuda_ms(lambda: run(other, rays), 10),
                    identical=min(same(got, new).values()),
                    **cs.edge_pairs(rays, got[1], st, bnd["rows"]))
            res["block_sizes"] = sizes
        say(**res)


def step_phase(name, g, parent):
    """The frame's gradient step, parent, change, change, parent, with every
    launch of the instantiation timed (the wrapper's host work included, the
    same for both)."""
    module, wrapper, _, _ = cs.EDGE_KERNELS[name]
    out = {"parent": [], "change": []}
    for who in ("parent", "change", "change", "parent"):
        with parent_kernels(parent) if who == "parent" else contextlib.nullcontext():
            with cs.launch_events(module, wrapper) as ev:
                k = cs.grad_step(g)
            out[who].append(dict(seconds_per_step=k["ms"] / 1e3, device_ms=cs.events_ms(ev),
                                 launches=len(ev), loss=float(k["loss"])))
    say(phase="edge_step", kernel=name, bands=g["bands"], band_pops=g["pops"], **out)


def main():
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    quick = "--quick" in sys.argv[1:]
    parent = args[0] if args else "_parent"
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    say(phase="card", card=card, torch=torch.__version__, cuda=torch.version.cuda)
    info = _build.build(with_precise=True)
    parent_lib, ptxas_parent = build_parent(parent)
    variants = build_variants()
    ptxas = cs.ptxas_by_kernel(info["log"])
    say(phase="build", seconds=info["seconds"],
        change={k: v for k, v in ptxas.items() if k.startswith("sweep2g.so")},
        parent=ptxas_parent)
    for name in ORDER:
        g = frame(dev, name)
        pops_phase(name, g, parent_lib, quick, variants)
        if not quick:
            step_phase(name, g, parent_lib)
    print(card, flush=True)


if __name__ == "__main__":
    main()
