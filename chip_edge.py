"""Parent against change in one call: K3, the generic sweep (its nearest-hit
and silhouette instantiations), on one NVIDIA GPU.

Run from the repository root, with an older checkout of the repository
unpacked beside it (a directory that .gitignore lists), for example:

    git archive <commit> | tar -x -C _parent
    python3 chip_edge.py _parent            # or: python3 chip_edge.py _parent --quick

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


def nvcc(src_dir, so):
    """Start nvcc on ``src_dir``'s sweep2g.cu -> the process."""
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(src_dir), "-o", str(so),
           str(pathlib.Path(src_dir) / "sweep2g.cu")]
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
    root = _build.BUILD_ROOT / "edge_variants"
    for name, subs in VARIANTS.items():
        src = root / name / "csrc"
        shutil.rmtree(src, ignore_errors=True)
        shutil.copytree(_build.CSRC, src)
        for fname, old, new in subs:
            text = (src / fname).read_text()
            if text.count(old) != 1:
                raise RuntimeError(f"variant {name}: {old!r} is not one line of {fname}")
            (src / fname).write_text(text.replace(old, new))
        procs[name] = (root / name / "sweep2g.so", nvcc(src, root / name / "sweep2g.so"))
    # the parent's C interface: no live_rows, no coop_min
    parent_lib, parent_ptxas = finish("the parent's sweep2g.cu", *procs.pop(None),
                                      [p, p, i, i, i, i, i, i, p, i, p, p, p, p, i, p, p])
    argtypes = [p, p, p, i, i, i, i, i, i, i, p, i, p, p, p, p, i, p, p]  # this checkout's
    libs, ptxas = {}, {}
    for name, (so, proc) in procs.items():
        libs[name], ptxas[name] = finish(f"variant {name}", so, proc, argtypes)
    return parent_lib, parent_ptxas, libs, ptxas


class _ParentFn:
    """The parent's C function behind this checkout's wrapper: called with
    this checkout's arguments, it drops ``live_rows`` and ``coop_min``."""

    DROP = (2, 9)

    def __init__(self, fn):
        self.fn, self.argtypes = fn, fn.argtypes

    def __call__(self, *args):
        return self.fn(*(a for k, a in enumerate(args) if k not in self.DROP))


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


def main():
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    quick = "--quick" in sys.argv[1:]
    parent = args[0] if args else "_parent"
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    say(phase="card", card=card, torch=torch.__version__, cuda=torch.version.cuda)
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
