"""The "bvh" shading of the queue renderers (``kernels.shade``).

- The port's ``ops.render.shade_rays`` (through ``shade_bvh``, on the CPU its
  plain version) against the JAX package's ``shade_rays``, the same scene
  leaves and rays: a sphere scene of nested glass and a generic one (the
  dense intersector, ``accel=None``), a lights scene, and a soft-edged pop
  through the gradient path (the ``DiffAccel``).  Every ``ShadeResult``
  field: the masks and ``bounced`` equal, the floats within 2e-5 (abs + rel;
  the JAX package's eager CPU ops round as PyTorch's but for the sums over
  three components and sin / cos), on the active lanes: an inactive lane
  reads the neutral surrounding RI in the port (``ops.render._ri_of_lanes``
  sums it only for the lanes that read it) where the JAX package sums it at
  every hit, so its refraction differs, and no pop reads it.
- ``shade_bvh`` (the ``torch.autograd.Function``) on the CPU equals the plain
  version's outputs, autograd and ``torch.func.jvp`` bit for bit.
- Where there is a g++, the kernel source ``csrc/shade.cu`` compiled as host
  C++ (``_build.host_rehearsal``): its forward's masks and ``bounced`` equal
  the plain version's and every float within 1e-5 (abs + rel) on >= 99.9 %
  of lanes (the kernel sums a vector's three components and rounds a cross
  product as PyTorch's CUDA kernels do, the host's plain version as its CPU
  kernels do); its backward and tangent against float64 autograd and
  ``torch.func.jvp`` of the plain version, each field's largest error
  within its float32 plain version's own plus 1e-5 of the field's sum of
  |g| and its summed error at most twice the plain version's plus 1e-6 of
  that sum (the recompute's bars: float32 loses digits near grazing lanes
  and thresholds in both); and a whole gradient step through the rehearsed
  kernels against ``jax.value_and_grad``, at the bars of
  ``test_torch_diff.py::test_loss_and_grads_match_jax``.
- A tensor that is not on the CPU never reaches a plain version; the
  wrappers check their arguments.
"""

import dataclasses
import importlib
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracing_tests_tpu.diff import fastpath as jfastpath
from raytracing_tests_tpu.scene import examples as jex
from raytracing_tests_tpu.scene import types as jtypes
from raytracing_tests_tpu_torch import convert
from raytracing_tests_tpu_torch.diff import fastpath
from raytracing_tests_tpu_torch.kernels import _build, shade

# the modules (each package's ``ops`` exports a function of the same name)
jrender = importlib.import_module("raytracing_tests_tpu.ops.render")
render = importlib.import_module("raytracing_tests_tpu_torch.ops.render")

torch.set_num_threads(2)

B = 512
BG = ((1.0, 1.0, 1.0), (0.3, 0.4, 1.0))
FLOAT_FIELDS = ("add_color", "hit_t", "refr_o", "refr_d", "refr_contrib", "refl_o", "refl_d",
                "refl_contrib", "refr_medium", "refr_parent", "refl_medium", "refl_parent")
EXACT_FIELDS = ("set_white", "did_hit", "missed", "refr_mask", "refl_mask", "bounced")


def nested_spheres(ty):
    """A glass sphere (RI 1.3) holding a denser one (1.8), a mirror ball and
    a matte ground: sphere rows only."""
    b = ty.SceneBuilder()
    b.add_dielectric((0.0, 0.0, -4.0), 1.2, ior=1.3)
    b.add_dielectric((0.15, 0.05, -4.0), 0.6, ior=1.8)
    b.add_sphere((0.0, -101.2, -4.0), 100.0, color=(0.6, 0.5, 0.4), reflectivity=0.5,
                 scatter_reflect=0.9)
    b.add_sphere((1.5, 1.2, -6.0), 0.8, color=(0.2, 0.6, 0.9), reflectivity=0.3,
                 scatter_reflect=0.2)
    cam = ty.Camera.make((0.0, 0.2, 0.5), (0.0, -0.05, -1.0), fov_y_deg=50.0, focus_dist=4.5)
    return b.build(), cam


def nested_generic(ty):
    from test_torch_ri_sum import nested_glass

    return nested_glass(ty)


def rays(seed, spp=4, max_bounces=4):
    """B lanes: a third from the camera's side toward the scene's middle, a
    third from inside the glass (inner hits), a third from anywhere in any
    direction (misses among them); random contributions, bounce counts and
    sample indices; a few inactive."""
    rng = np.random.default_rng(seed)
    centre = np.array([0.0, 0.0, -4.0])
    n = B // 3
    o = np.concatenate([
        np.array([0.0, 0.2, 0.5]) + rng.normal(size=(n, 3)) * 0.3,
        centre + rng.uniform(-0.5, 0.5, (n, 3)),
        centre + rng.uniform(-3.0, 3.0, (B - 2 * n, 3))])
    aim = centre + rng.normal(size=(B, 3)) * 1.2
    d = aim - o
    d[2 * n:] = rng.normal(size=(B - 2 * n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return dict(o=o.astype(np.float32), d=d.astype(np.float32),
                contrib=rng.uniform(0.0, 1.0, B).astype(np.float32),
                bounced=rng.integers(0, max_bounces, B).astype(np.int32),
                active=rng.uniform(size=B) < 0.95,
                sample_idx=rng.integers(0, spp, B).astype(np.float32),
                time_ratio=rng.uniform(0.0, 1.0, B).astype(np.float32))


def port_scene(js):
    return convert.scene_from_numpy({f: np.asarray(getattr(js, f)) for f in convert.SCENE_FIELDS})


CASES = {
    "nested_spheres": (nested_spheres, "brute", 0.0, False),
    "nested_generic": (nested_generic, "brute", 0.0, False),
    "lights": (lambda ty: jex.lights_scene(), "brute", 0.0, True),
    "diff_soft": (nested_spheres, "pallas", 0.03, False),
}


@pytest.mark.parametrize("case", list(CASES))
def test_shade_rays_matches_jax(case):
    factory, intersector, soft, lights = CASES[case]
    js, _ = factory(jtypes)
    ts = port_scene(js)
    size = dict(width=16, height=8, spp=4, max_bounces=4)
    jcfg = dataclasses.replace(jrender.RenderConfig(**size).for_scene(js), soft_edges=soft,
                               intersector=intersector)
    tcfg = dataclasses.replace(render.RenderConfig(**size).for_scene(ts), soft_edges=soft,
                               intersector=intersector)
    assert tcfg.has_dielectrics == jcfg.has_dielectrics
    jl = jrender.extract_lights(js) if lights else None
    tl = render.extract_lights(ts) if lights else None
    if intersector == "pallas":
        jacc = jfastpath.make_diff_accel(js, has_motion=jcfg.has_motion, mode=jcfg.pallas_mode,
                                         probe_rows=jcfg.probe_rows)
        tacc = fastpath.make_diff_accel(ts, has_motion=tcfg.has_motion, mode=tcfg.pallas_mode,
                                        probe_rows=tcfg.probe_rows)
    else:
        jacc = tacc = None
    x = rays(1, spp=size["spp"], max_bounces=size["max_bounces"])
    names = ("o", "d", "contrib", "bounced", "active", "sample_idx", "time_ratio")
    want = jrender.shade_rays(js, jl, jcfg, jacc, *(jnp.asarray(x[k]) for k in names))
    got = render.shade_rays(ts, tl, tcfg, tacc, *(torch.from_numpy(x[k]) for k in names))
    assert bool(got.did_hit.any()) and bool(got.missed.any())
    if soft > 0.0 or lights:
        assert bool((got.did_hit & ~got.refr_mask & ~got.refl_mask).any())
    assert bool(got.refr_mask.any()) and bool(got.refl_mask.any())
    for name in EXACT_FIELDS:
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), err_msg=name)
    on = x["active"]
    for name in FLOAT_FIELDS:
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert g.shape == w.shape, name
        assert float(np.max(np.abs(g - w)[on] / (1.0 + np.abs(w[on])))) <= 2e-5, name


def lanes(seed, soft, lights, spp=16, dtype=torch.float32, n=B):
    """The kernel's inputs for ``n`` lanes: unit directions and normals in
    every relation (inner and outer hits, grazing ones), material fields on
    each side of their thresholds but never on them (a float32 and a float64
    comparison would split there), soft coverage and lights when asked ->
    (inputs, statics)."""
    rng = np.random.default_rng(seed)

    def unit(v):
        return v / np.linalg.norm(v, axis=1, keepdims=True)

    def pick(vals):
        return np.asarray(vals)[rng.integers(0, len(vals), n)]

    d, nrm = unit(rng.normal(size=(n, 3))), unit(rng.normal(size=(n, 3)))

    def f(v):
        return torch.from_numpy(np.ascontiguousarray(v)).to(dtype)

    floats = [f(rng.normal(size=(n, 3)) * 3.0), f(d), f(rng.uniform(0.0, 1.2, n)),
              f(rng.uniform(0.1, 10.0, n)), f(nrm), f(pick([1.0, 1.0, 1.3, 1.5])),
              f(rng.uniform(0.0, 1.0, (n, 3))), f(pick([1.0, 1.5, 2.4, 1.33])),
              f(pick([0.0, 0.0015, 0.3, 1.0])), f(pick([0.0, 0.5, 0.9, 0.003])),
              f(pick([0.0, 0.0005, 0.1, 0.5])), f(pick([0.0, 0.2, 0.05, 0.0008])),
              f(rng.uniform(0.0, 1.0, n)) if soft else None]
    others = [torch.from_numpy(rng.integers(0, spp, n).astype(np.float32)),
              torch.from_numpy(pick([0.0, 0.5, 1.0]).astype(np.float32)) if lights else None,
              torch.from_numpy(rng.integers(0, 5, n).astype(np.int32)),
              torch.from_numpy(rng.uniform(size=n) < 0.9),
              torch.from_numpy(rng.uniform(size=n) < 0.8),
              torch.from_numpy(rng.uniform(size=n) < 0.1) if lights else None]
    return floats + others, (spp, 5, 32000.0, BG)


KERNEL_CASES = [(False, False), (True, False), (False, True), (True, True)]


def _through(inputs, statics):
    """The Function of the float inputs present, its float outputs."""
    spp, max_bounces, t_max, bg = statics
    present = [k for k in range(shade.N_FLOAT) if inputs[k] is not None]

    def fn(*xs):
        full = list(inputs)
        for k, x in zip(present, xs):
            full[k] = x
        out = shade.shade_bvh(*full, spp=spp, max_bounces=max_bounces, t_max=t_max,
                              background=bg)
        return tuple(out[k] for k in shade._FLOAT_AT)

    return fn, [inputs[k] for k in present]


@pytest.mark.parametrize("soft,lights", KERNEL_CASES)
def test_the_function_on_the_cpu_is_the_plain_version(soft, lights):
    inputs, statics = lanes(2, soft, lights)
    fn_p, xs = shade._plain_of(inputs, statics)
    fn_f, _ = _through(inputs, statics)
    want = shade._shade_plain(inputs, statics)
    spp, max_bounces, t_max, bg = statics
    got = shade.shade_bvh(*inputs, spp=spp, max_bounces=max_bounces, t_max=t_max, background=bg)
    for name, g, w in zip(shade.OUTPUTS, got, want):
        assert torch.equal(g, w), name
    rng = np.random.default_rng(3)
    out_w, vjp_w = torch.func.vjp(fn_p, *xs)
    out_g, vjp_g = torch.func.vjp(fn_f, *xs)
    cts = tuple(torch.from_numpy(rng.normal(size=tuple(v.shape)).astype(np.float32))
                for v in out_w)
    for g, w in zip(vjp_g(cts), vjp_w(cts)):
        assert torch.equal(g, w)
    tans = tuple(torch.from_numpy(rng.normal(size=tuple(x.shape)).astype(np.float32))
                 for x in xs)
    for g, w in zip(torch.func.jvp(fn_f, tuple(xs), tans)[1],
                    torch.func.jvp(fn_p, tuple(xs), tans)[1]):
        assert torch.equal(g, w)
    # ordinary autograd through the Function: the same gradients
    leaves = [x.clone().requires_grad_(True) for x in xs]
    back = torch.autograd.grad(fn_f(*leaves), leaves, cts, allow_unused=True)
    for g, w in zip(back, vjp_w(cts)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("soft,lights", KERNEL_CASES)
def test_the_backward_reaches_what_autograd_of_the_plain_version_reaches(soft, lights):
    """Each float output's gradient reaches the float inputs that autograd
    of the plain version reaches (not None) and no other: the kernel's
    backward passes None where the plain graph has no path, so no zero
    gradient wakes an earlier node's backward (the recompute's at a band's
    last pop)."""
    inputs, statics = lanes(3, soft, lights, n=64)
    fn, xs = shade._plain_of(inputs, statics)
    leaves = [x.clone().requires_grad_(True) for x in xs]
    outs = fn(*leaves)
    names = [n for (n, _), x in zip(shade.FLOAT_INPUTS, inputs) if x is not None]
    for (name, _), out in zip(shade.FLOAT_OUTPUTS, outs):
        got = torch.autograd.grad(out.sum(), leaves, allow_unused=True, retain_graph=True)
        plain = {n for n, g in zip(names, got) if g is not None}
        assert plain == shade.reached([name], lights) & set(names), name


def _within_float64(kernel, ref, plain):
    """The recompute's bars: the largest error within the float32 plain
    version's own plus 1e-5 of the sum of |ref|, the summed error at most
    twice the plain version's plus 1e-6 of that sum."""
    err = (kernel.double() - ref).abs()
    perr = (plain.double() - ref).abs()
    s = float(ref.abs().sum())
    return (bool(torch.isfinite(kernel).all())
            and float(err.max()) <= float(perr.max()) + 1e-5 * s
            and float(err.sum()) <= 2.0 * float(perr.sum()) + 1e-6 * s)


@pytest.mark.skipif(shutil.which("g++") is None, reason="the host rehearsal needs g++")
@pytest.mark.parametrize("soft,lights", KERNEL_CASES)
def test_kernel_source_rehearsed_on_the_host(soft, lights):
    inputs, statics = lanes(4, soft, lights, n=2048)
    n = inputs[0].shape[0]
    want = shade._shade_plain(inputs, statics)
    with _build.host_rehearsal():
        got = shade._launch_shade(inputs, statics)
    close = torch.ones(n, dtype=torch.bool)
    for name, g, w in zip(shade.OUTPUTS, got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        if g.dtype == torch.float32:
            close &= ((g - w).abs() <= 1e-5 * (1.0 + w.abs())).reshape(n, -1).all(1)
        else:
            assert torch.equal(g, w), name
    assert float(close.float().mean()) >= 0.999

    x64 = [x.double() if x is not None and k < shade.N_FLOAT else x
           for k, x in enumerate(inputs)]
    rng = np.random.default_rng(5)
    grads = [torch.from_numpy(rng.normal(size=tuple(want[k].shape)).astype(np.float32))
             for k in shade._FLOAT_AT]
    ref = shade._shade_grad_plain(x64, [q.double() for q in grads], statics)
    plain = shade._shade_grad_plain(inputs, grads, statics)
    with _build.host_rehearsal():
        kern = shade._launch_shade_grad(inputs, grads, statics)
    for (name, _), k, r, p in zip(shade.FLOAT_INPUTS, kern, ref, plain):
        if r is None:
            assert k is None and not soft, name
            continue
        assert float(r.abs().sum()) > 0.0, name
        assert _within_float64(k, r, p), name

    tans = [None if x is None else
            torch.from_numpy(rng.normal(size=tuple(x.shape)).astype(np.float32))
            for x in inputs[:shade.N_FLOAT]]
    ref = shade._shade_jvp_plain(x64, [None if t is None else t.double() for t in tans], statics)
    plain = shade._shade_jvp_plain(inputs, tans, statics)
    with _build.host_rehearsal():
        kern = shade._launch_shade_jvp(inputs, tans, statics)
    for (name, _), k, r, p in zip(shade.FLOAT_OUTPUTS, kern, ref, plain):
        assert _within_float64(k, r, p), name


@pytest.mark.skipif(shutil.which("g++") is None, reason="the host rehearsal needs g++")
def test_the_rehearsed_backward_skips_what_is_not_needed():
    """A null gradient pointer writes nothing; a missing output gradient is
    zero; an absent soft_alpha gets none."""
    inputs, statics = lanes(6, False, False)
    want = shade._shade_plain(inputs, statics)
    g_add = torch.ones_like(want[0])
    need = [True, False, True, False, True, False, True, False, True, False, True, False, True]
    grads = [g_add] + [None] * 7
    full = [g_add] + [torch.zeros_like(want[k]) for k in shade._FLOAT_AT[1:]]
    with _build.host_rehearsal():
        got = shade._launch_shade_grad(inputs, grads, statics, need)
        every = shade._launch_shade_grad(inputs, full, statics)
    for g, f, n, x in zip(got, every, need, inputs):
        assert (g is not None) == (n and x is not None)
        if g is not None:
            assert torch.equal(g, f)


BLOCK = 128  # lanes a block of the backward kernel (csrc/shade.cu GRAD_THREADS)


def _bits(a, b):
    """Equal bit for bit (a float's bits, so NaNs in the same places), or
    both None."""
    if a is None or b is None:
        return a is None and b is None
    return a.shape == b.shape and torch.equal(a.view(torch.int32), b.view(torch.int32))


def _lanes_at(inputs, grads, at):
    """The inputs and gradients of lanes ``at``: views where ``at`` is a
    slice, copies where it is an index tensor."""
    return ([None if x is None else x[at] for x in inputs],
            [None if q is None else q[at] for q in grads])


@pytest.mark.skipif(shutil.which("g++") is None, reason="the host rehearsal needs g++")
@pytest.mark.parametrize("soft,lights", [(False, False), (True, True)])
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("n", [0, 1, BLOCK - 1, BLOCK + 1, 3 * BLOCK + 5])
def test_the_rehearsed_backward_in_blocks_equals_its_lanes_one_at_a_time(n, offset, soft, lights):
    """The backward over n lanes (a ragged last block; below one block;
    every field a view one lane in, so no base is 16-byte aligned) equals
    bit for bit the same lanes run one a launch, and is within the bars of
    ``test_kernel_source_rehearsed_on_the_host`` against float64 autograd of
    the plain version."""
    inputs, statics = lanes(12, soft, lights, n=n + offset)
    want = shade._shade_plain(inputs, statics)
    rng = np.random.default_rng(13)
    grads = [torch.from_numpy(rng.normal(size=tuple(want[k].shape)).astype(np.float32))
             for k in shade._FLOAT_AT]
    inputs, grads = _lanes_at(inputs, grads, slice(offset, None))
    with _build.host_rehearsal():
        got = shade._launch_shade_grad(inputs, grads, statics)
        one = [shade._launch_shade_grad(*_lanes_at(inputs, grads, slice(j, j + 1)), statics)
               for j in range(n)]
    for k, (name, _) in enumerate(shade.FLOAT_INPUTS):
        if got[k] is None:
            assert name == "soft_alpha" and not soft and all(o[k] is None for o in one)
            continue
        assert got[k].shape[0] == n, name
        if n:
            assert _bits(got[k], torch.cat([o[k] for o in one])), name
    if n > 1:
        x64 = [x.double() if x is not None and k < shade.N_FLOAT else x
               for k, x in enumerate(inputs)]
        ref = shade._shade_grad_plain(x64, [q.double() for q in grads], statics)
        plain = shade._shade_grad_plain(inputs, grads, statics)
        for (name, _), k, r, p in zip(shade.FLOAT_INPUTS, got, ref, plain):
            if r is not None:
                assert _within_float64(k, r, p), name


def _branch_keys(inputs):
    """Each lane's branches in the backward: inner or outer hit, total
    internal reflection, each cone deviated and kept."""
    d, nrm, sri, mri = inputs[1], inputs[4], inputs[5], inputs[7]
    dn = (nrm * d).sum(1)
    inner = dn > 0.0
    eta = torch.where(inner, mri / sri, sri / mri)
    tir = 1.0 - eta * eta * (1.0 - dn * dn) < 0.0
    dev_l, dev_r = inputs[11] > 0.001, inputs[10] > 0.001
    keep_l, keep_r = inputs[9] > 0.002, inputs[8] > 0.002
    return torch.stack([inner, tir, dev_l & keep_l, dev_r & keep_r], 1)


@pytest.mark.skipif(shutil.which("g++") is None, reason="the host rehearsal needs g++")
@pytest.mark.parametrize("soft,lights", KERNEL_CASES)
def test_a_block_of_mixed_branches_permutes_with_its_lanes(soft, lights):
    """Blocks whose lanes take every branch of the backward (inner and outer
    hits, total internal reflection, each cone deviated or not, missed and
    inactive lanes): permuting the input lanes permutes every input's
    gradient bit for bit."""
    n = 2 * BLOCK
    inputs, statics = lanes(14, soft, lights, n=n)
    keys = _branch_keys(inputs)
    kinds = {tuple(k) for k in keys.tolist()}
    assert {(True, True), (True, False), (False, False)} <= {k[:2] for k in kinds}
    assert {(False, False, True, True), (False, False, False, False)} <= kinds
    assert not bool(inputs[shade.N_FLOAT + 3].all()) and not bool(inputs[shade.N_FLOAT + 4].all())
    want = shade._shade_plain(inputs, statics)
    rng = np.random.default_rng(15)
    grads = [torch.from_numpy(rng.normal(size=tuple(want[k].shape)).astype(np.float32))
             for k in shade._FLOAT_AT]
    perm = torch.from_numpy(rng.permutation(n))
    with _build.host_rehearsal():
        got = shade._launch_shade_grad(inputs, grads, statics)
        moved = shade._launch_shade_grad(*_lanes_at(inputs, grads, perm), statics)
    for (name, _), g, m in zip(shade.FLOAT_INPUTS, got, moved):
        assert _bits(None if g is None else g[perm], m), name


def _rehearsed(kernel):
    def run(*args, **kw):
        with _build.host_rehearsal():
            return kernel(*args, **kw)

    return run


@pytest.mark.skipif(shutil.which("g++") is None, reason="the host rehearsal needs g++")
def test_the_step_through_the_rehearsed_kernels_matches_jax(monkeypatch):
    """``diff.value_and_grad_loss`` on the CPU with the shading's forward and
    backward run by the kernel source as host C++ (every other kernel
    plain) against ``jax.value_and_grad`` of the JAX package's
    ``render_loss``, at the bars of ``test_loss_and_grads_match_jax``, on
    its soft-edged case (the coverage's gradient through the kernel; the
    hard edges' is the same path without it); one ``shade_bvh`` a pop and
    one ``shade_bvh_grad`` a pop whose outputs reach the loss."""
    case = "pallas_soft"
    import jax

    from raytracing_tests_tpu import diff as jdiff
    from raytracing_tests_tpu_torch import diff
    from test_torch_diff import CASES as DIFF_CASES
    from test_torch_diff import SIZE, port_of

    factory, intersector, soft, perturb, (rtol, bar) = DIFF_CASES[case]
    js, jc = jex.materials_scene()
    jcfg = jrender.RenderConfig(**SIZE).for_scene(js)
    target = np.asarray(jrender.render_jit(js, jc, jcfg)["image"])
    jpert = perturb(js)
    jcfg = dataclasses.replace(jcfg, intersector=intersector, soft_edges=soft)
    jl, jg = jax.value_and_grad(jdiff.render_loss)(
        jdiff.extract_params(jpert), jpert, jc, jcfg, jnp.asarray(target))
    ts, tc = port_of(jpert, jc)
    tcfg = dataclasses.replace(render.RenderConfig(**SIZE).for_scene(ts),
                               intersector=intersector, soft_edges=soft)
    p = convert.scene_params_from_numpy(
        {f: np.asarray(getattr(jdiff.extract_params(jpert), f)) for f in diff.FLOAT_FIELDS})
    monkeypatch.setattr(shade, "_shade", _rehearsed(shade._launch_shade))
    monkeypatch.setattr(shade, "_shade_grad", _rehearsed(shade._shade_grad_kernel))
    _build.reset_launches()
    tl, tg = diff.value_and_grad_loss(p, ts, tc, tcfg, torch.from_numpy(target), device="cpu")
    launches = dict(_build.LAUNCHES)
    _build.reset_launches()
    assert launches["shade_bvh"] > 0 and 0 < launches["shade_bvh_grad"] <= launches["shade_bvh"]
    np.testing.assert_allclose(float(tl), float(jl), rtol=rtol)
    for name, g in tg.items():
        want = np.asarray(getattr(jg, name))
        scale = float(np.abs(want).max())
        assert np.isfinite(g.numpy()).all(), name
        assert float(np.abs(g.numpy() - want).max()) <= bar * max(scale, 1e-30), name


def test_shade_bvh_on_a_device_tensor_never_calls_the_plain_version(monkeypatch):
    """A tensor that is not on the CPU goes to the kernels: with their launch
    replaced by a stub, a 'meta' tensor reaches it, and the plain versions
    are never called."""
    inputs, statics = lanes(7, True, True, n=64)
    inputs = [None if x is None else x.to("meta") for x in inputs]
    called = []

    def plain(*a, **k):
        raise AssertionError("the plain version was called")

    def stub(inp, st):
        called.append("fwd")
        n = inp[0].shape[0]
        outs = {nm: torch.empty(shade._shape(n, w), device="meta") for nm, w in shade.FLOAT_OUTPUTS}
        outs.update({nm: torch.empty(n, dtype=torch.bool, device="meta") for nm in shade.MASKS})
        outs["bounced"] = torch.empty(n, dtype=torch.int32, device="meta")
        return tuple(outs[nm] for nm in shade.OUTPUTS)

    for name in ("_shade_plain", "_shade_grad_plain", "_shade_jvp_plain", "shade_bvh_plain"):
        monkeypatch.setattr(shade, name, plain)
    monkeypatch.setattr(shade, "_launch_shade", stub)
    spp, max_bounces, t_max, bg = statics
    out = shade.shade_bvh(*inputs, spp=spp, max_bounces=max_bounces, t_max=t_max, background=bg)
    assert called == ["fwd"] and len(out) == len(shade.OUTPUTS)
    assert all(o.device.type == "meta" for o in out)


def test_the_wrappers_check_their_arguments():
    inputs, statics = lanes(8, False, False, n=32)
    with pytest.raises(RuntimeError, match="take CUDA tensors"):
        shade._launch_shade(inputs, statics)
    bad = list(inputs)
    bad[1] = bad[1].double()
    with _build.host_rehearsal(), pytest.raises(ValueError, match="d:"):
        shade._launch_shade(bad, statics)
    bad = list(inputs)
    bad[shade.N_FLOAT + 2] = bad[shade.N_FLOAT + 2].long()
    with _build.host_rehearsal(), pytest.raises(ValueError, match="bounced:"):
        shade._launch_shade(bad, statics)
    bad = list(inputs)
    bad[4] = bad[4].t().contiguous().t()
    with _build.host_rehearsal(), pytest.raises(ValueError, match="normal:"):
        shade._launch_shade(bad, statics)
    bad = list(inputs)
    bad[shade.N_FLOAT + 1] = torch.ones(32)  # lit without emissive
    with _build.host_rehearsal(), pytest.raises(ValueError, match="lit and emissive"):
        shade._launch_shade(bad, statics)
    with _build.host_rehearsal(), pytest.raises(ValueError, match="gradients for"):
        shade._launch_shade_grad(inputs, [None] * 3, statics)
    with _build.host_rehearsal(), pytest.raises(ValueError, match="tangents for"):
        shade._launch_shade_jvp(inputs, [None] * 3, statics)
    spp, max_bounces, t_max, _ = statics
    with pytest.raises(ValueError, match="background"):
        shade.shade_bvh(*inputs, spp=spp, max_bounces=max_bounces, t_max=t_max,
                        background=((1.0, 1.0, 1.0),))
    with pytest.raises(ValueError, match="lit and emissive"):
        shade.shade_bvh(*inputs[:shade.N_FLOAT + 1], torch.ones(32), *inputs[shade.N_FLOAT + 2:],
                        spp=spp, max_bounces=max_bounces, t_max=t_max, background=BG)
