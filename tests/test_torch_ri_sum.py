"""The gradient path's surrounding-RI containment sum (``kernels.ri_sum``).

Inputs come from a numpy seed: ``iow_final_scene()``'s table (488 rows) and
a small generic scene of rotated ellipsoids and cuboids, with moving rows,
invalid rows and rows of RI 1, nested four deep as ``deep_glass_spheres()``
nests its glass.  S = 4096 points: half inside one to four rows (each made
inside a live row), the rest outside every row.

The plain versions (``ri_sum_plain``, ``ri_sum_grad_plain``) and
``containment_ri`` on the CPU (the ``torch.autograd.Function``) are held
against the JAX package's ``surrounding_refractive_index`` and its
``jax.vjp`` with respect to ``refractive_index``; ``containment_ri``
against ``torch.autograd.gradcheck`` in float64.  Where there is a g++, the
kernel source ``csrc/ri_sum.cu`` compiled as host C++
(``_build.host_rehearsal``) is held against the plain versions in both modes
of the backward, the shared tile and the global atomics (forced by a
shared-memory budget of 0): the forward bit for bit, the backward within
1e-6 of each row's sum of |g / count| (its sums run in another order).  A
banded gradient step through the rehearsed kernels equals the plain route.
On a small frame of nested glass, where the probe points of lanes with a
gradient lie inside glass, the port's banded step is held against
``jax.value_and_grad`` of the JAX package's ``render_loss`` at the bars of
``test_torch_diff.py::test_loss_and_grads_match_jax`` (the loss within rtol
1e-6, every field within 5e-4 of its max |g|).
``test_torch_diff.py``, ``test_torch_diff_train.py`` and
``test_torch_queue_static.py`` reach the sum through
``ops.render._surrounding_ri``.
"""

import dataclasses
import importlib
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracing_tests_tpu import diff as jdiff
from raytracing_tests_tpu.ops import intersect as jisect
from raytracing_tests_tpu.ops.render import RenderConfig as JRenderConfig
from raytracing_tests_tpu.ops.render import render_jit
from raytracing_tests_tpu.scene import types as jtypes
from raytracing_tests_tpu_torch import convert, diff
from raytracing_tests_tpu_torch.kernels import _build, ri_sum
from raytracing_tests_tpu_torch.ops.render import RenderConfig
from raytracing_tests_tpu_torch.scene import examples
from raytracing_tests_tpu_torch.scene.types import CUBOID, ELLIPSOID, SceneBuilder

trender = importlib.import_module("raytracing_tests_tpu_torch.ops.render")

torch.set_num_threads(2)

S = 4096


def generic_scene():
    """Rotated ellipsoids and cuboids nested four deep (RI 1.5, 1.3, 1.7,
    1.4 from the outside in), a moving pair, rows of RI 1 among them, a glass
    row marked invalid inside one of them and the capacity's padding."""
    b = SceneBuilder()
    for k, (size, ior, typ) in enumerate(((2.0, 1.5, ELLIPSOID), (1.5, 1.3, CUBOID),
                                          (1.0, 1.7, ELLIPSOID), (0.5, 1.4, CUBOID))):
        b.add((0.1 * k, -0.05 * k, 0.0), (size, 0.8 * size, 0.9 * size), typ,
              rotation_deg=(10.0 * k, 25.0, -15.0 * k), refractive_index=ior)
    b.add((0.3, 0.2, 0.1), (0.6, 0.6, 0.6), ELLIPSOID, refractive_index=1.0)  # air
    b.add((3.0, 0.5, -1.0), (1.0, 0.7, 0.5), CUBOID, rotation_deg=(30.0, 0.0, 45.0),
          delta_position=(0.4, -0.2, 0.3), refractive_index=1.6)
    b.add((3.2, 0.4, -0.8), (0.5, 0.5, 0.8), ELLIPSOID, rotation_deg=(0.0, 60.0, 0.0),
          delta_position=(-0.3, 0.1, 0.0), refractive_index=1.45)
    b.add((-3.0, 0.0, 1.0), (0.8, 0.8, 0.8), CUBOID, refractive_index=1.0)  # air
    b.add((-3.1, 0.1, 1.1), (0.4, 0.9, 0.4), ELLIPSOID, rotation_deg=(5.0, 5.0, 70.0),
          refractive_index=2.0)
    scene = b.build(capacity=16)  # rows 9..15 padding
    valid = scene.valid.clone()
    valid[8] = False  # a glass ellipsoid whose row is invalid
    return scene.replace(valid=valid)


def _map(scene, fn):
    """``scene`` with ``fn`` applied to each field."""
    return scene.replace(**{f: fn(getattr(scene, f)) for f in convert.SCENE_FIELDS})


def _points(scene, seed):
    """(point (S, 3), time_ratio (S,)) float32: the first half each inside a
    live row (a local point well inside its unit primitive, carried to the
    world at its time), the rest drawn around the scene and kept where no
    row contains them."""
    rng = np.random.default_rng(seed)
    pos, dpos, scale = (getattr(scene, f).double().numpy() for f in
                        ("position", "delta_position", "scale"))
    rot = scene.rotation.double().numpy()
    typ = scene.obj_type.numpy()
    live = np.nonzero(scene.valid.numpy() & (scene.refractive_index.numpy() != 1.0))[0]
    half = S // 2
    rows = rng.choice(live, half)
    u = rng.normal(size=(half, 3))
    u *= (rng.uniform(0.0, 0.9, (half, 1)) ** (1 / 3)) / np.linalg.norm(u, axis=1, keepdims=True)
    box = rng.uniform(-0.45, 0.45, (half, 3))
    local = np.where((typ[rows] == CUBOID)[:, None], box, u) * scale[rows]
    tr_in = rng.uniform(0.0, 1.0, half)
    inside = (pos[rows] - (1.0 - tr_in)[:, None] * dpos[rows]
              + np.einsum("bji,bi->bj", rot[rows], local))
    lo, hi = pos.min(0) - 2.0, pos.max(0) + 2.0
    out, tr_out = [], []
    while sum(len(o) for o in out) < S - half:
        p = rng.uniform(lo, hi, (S, 3)).astype(np.float32)
        t = rng.uniform(0.0, 1.0, S).astype(np.float32)
        keep = ri_sum.ri_sum_plain(_inputs(scene, torch.from_numpy(p),
                                           torch.from_numpy(t)))[0].numpy() == 1.0
        out.append(p[keep])
        tr_out.append(t[keep])
    point = np.concatenate([inside.astype(np.float32)] + out)[:S]
    tr = np.concatenate([tr_in.astype(np.float32)] + tr_out)[:S]
    return torch.from_numpy(point), torch.from_numpy(tr)


def _inputs(scene, point, tr):
    return [point, tr] + [getattr(scene, f).contiguous() for f in ri_sum.FIELDS]


@pytest.fixture(scope="module", params=["iow_final", "generic"])
def case(request):
    scene = examples.iow_final_scene()[0] if request.param == "iow_final" else generic_scene()
    point, tr = _points(scene, seed=len(request.param))
    g = torch.from_numpy(np.random.default_rng(3).normal(size=S).astype(np.float32))
    return dict(name=request.param, scene=scene, point=point, tr=tr, g=g)


def _jax_scene(scene):
    return jtypes.Scene(**{f: jnp.asarray(v) for f, v in convert.scene_to_numpy(scene).items()})


def test_points_lie_inside_one_to_four_rows_or_none(case):
    inside = ri_sum._inside(*_inputs(case["scene"], case["point"], case["tr"]))
    depth = inside.sum(dim=1)
    assert bool((depth[: S // 2] >= 1).all()) and bool((depth[S // 2:] == 0).all())
    assert int(depth.max()) <= 4
    if case["name"] == "generic":
        assert int(depth.max()) == 4  # the nested glass, summed in row order


def test_plain_sum_equals_jax_and_its_vjp(case):
    scene, point, tr, g = case["scene"], case["point"], case["tr"], case["g"]
    js = _jax_scene(scene)
    jp, jt = jnp.asarray(point.numpy()), jnp.asarray(tr.numpy())
    want, vjp = jax.vjp(
        lambda ri: jisect.surrounding_refractive_index(js.replace(refractive_index=ri), jp, jt),
        js.refractive_index)
    (want_grad,) = vjp(jnp.asarray(g.numpy()))
    want = np.asarray(want)

    inputs = _inputs(scene, point, tr)
    got, den = ri_sum.ri_sum_plain(inputs)
    # The JAX package sums the contained rows' RI by one reduction over the
    # rows, the plain version one row at a time in row order: where a point
    # lies in three or more rows the two can differ in the last bit.
    assert (got.numpy() == want).mean() >= 0.999
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    assert (want != 1.0).sum() >= S // 2 - 8  # the points inside glass read its RI
    got_grad = ri_sum.ri_sum_grad_plain(inputs, den, g)
    np.testing.assert_allclose(got_grad.numpy(), np.asarray(want_grad), rtol=1e-6, atol=1e-7)

    # the Function on the CPU: the plain forward and backward under autograd
    t = scene.replace(refractive_index=scene.refractive_index.clone().requires_grad_(True))
    got2 = ri_sum.containment_ri(t, point, tr)
    assert torch.equal(got2.detach(), got)
    (got_grad2,) = torch.autograd.grad(got2, t.refractive_index, g)
    np.testing.assert_allclose(got_grad2.numpy(), np.asarray(want_grad), rtol=1e-6, atol=1e-7)


def test_plain_tangent_equals_jax_jvp(case):
    """Forward-mode AD: ``ri_sum_jvp_plain`` and ``torch.func.jvp`` through
    ``containment_ri`` on the CPU against ``jax.jvp`` of the JAX package's
    ``surrounding_refractive_index`` with respect to the rows' RI (the same
    row-order caveat as the forward: within 1e-6)."""
    scene, point, tr = case["scene"], case["point"], case["tr"]
    tangent = torch.from_numpy(np.random.default_rng(4).normal(
        size=scene.capacity).astype(np.float32))
    js = _jax_scene(scene)
    jp, jt = jnp.asarray(point.numpy()), jnp.asarray(tr.numpy())
    _, want = jax.jvp(
        lambda ri: jisect.surrounding_refractive_index(js.replace(refractive_index=ri), jp, jt),
        (js.refractive_index,), (jnp.asarray(tangent.numpy()),))
    want = np.asarray(want)
    assert np.abs(want).max() > 0.1  # the points inside glass move with its RI
    inputs = _inputs(scene, point, tr)
    _, den = ri_sum.ri_sum_plain(inputs)
    np.testing.assert_allclose(ri_sum.ri_sum_jvp_plain(inputs, den, tangent).numpy(), want,
                               rtol=0, atol=1e-6)
    _, got = torch.func.jvp(
        lambda ri: ri_sum.containment_ri(scene.replace(refractive_index=ri), point, tr),
        (scene.refractive_index,), (tangent,))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def test_gradcheck_of_containment_ri_in_float64():
    """In float64 on a table without rows of RI 1 (at 1 a row's liveness
    turns: the sum is not differentiable there)."""
    scene = generic_scene()
    scene = scene.replace(refractive_index=torch.where(
        scene.refractive_index == 1.0, torch.full_like(scene.refractive_index, 1.25),
        scene.refractive_index))
    point, tr = _points(scene, seed=5)
    pick = torch.cat([torch.arange(0, 24), torch.arange(S - 8, S)])
    d = _map(scene, lambda v: v.double() if v.is_floating_point() else v)
    p, t = point[pick].double(), tr[pick].double()
    ri = d.refractive_index.clone().requires_grad_(True)
    assert torch.autograd.gradcheck(
        lambda r: ri_sum.containment_ri(d.replace(refractive_index=r), p, t), (ri,))
    # no other input takes a gradient
    q = p.clone().requires_grad_(True)
    pos = d.position.clone().requires_grad_(True)
    out = ri_sum.containment_ri(d.replace(position=pos, refractive_index=ri), q, t)
    got = torch.autograd.grad(out.sum(), [q, pos, ri], allow_unused=True)
    assert got[0] is None and got[1] is None and got[2] is not None


def _within_sum_abs(got, inputs, den, g, rtol=1e-6):
    """|got - exact| against rtol times each row's sum of |g / count| over
    the points that reach it, the exact sum in float64 -> the largest ratio."""
    inside = ri_sum._inside(*inputs).double()
    v = torch.where(den > 0, g.double() / den.clamp_min(1).double(), torch.zeros_like(g.double()))
    exact = (inside * v[:, None]).sum(0)
    scale = (inside * v.abs()[:, None]).sum(0)
    err = (got.double() - exact).abs()
    assert bool((err[scale == 0] == 0).all())
    return float((err / (rtol * scale).clamp_min(1e-300))[scale > 0].max())


@pytest.mark.parametrize("mode", ["tile", "global"])
def test_kernel_source_rehearsed_on_the_host(case, mode):
    if shutil.which("g++") is None:
        pytest.skip("no g++ to rehearse the kernel source with")
    inputs = _inputs(case["scene"], case["point"], case["tr"])
    want, want_den = ri_sum.ri_sum_plain(inputs)
    budget = ri_sum.SMEM_BUDGET if mode == "tile" else 0
    with _build.host_rehearsal():
        got, den = ri_sum._launch_ri_sum(inputs)
        grad, ran = ri_sum._launch_ri_sum_grad(inputs, den, case["g"], budget)
    assert torch.equal(got, want) and torch.equal(den, want_den)
    assert ran == mode
    assert _within_sum_abs(grad, inputs, den, case["g"]) <= 1.0
    plain = ri_sum.ri_sum_grad_plain(inputs, want_den, case["g"])
    assert _within_sum_abs(plain, inputs, den, case["g"]) <= 1.0


def test_kernel_tangent_rehearsed_on_the_host(case):
    """The tangent instantiation (``rt_ri_sum_jvp``) bit for bit the plain
    version's, which adds in the same row order."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ to rehearse the kernel source with")
    inputs = _inputs(case["scene"], case["point"], case["tr"])
    _, den = ri_sum.ri_sum_plain(inputs)
    tangent = torch.from_numpy(np.random.default_rng(5).normal(
        size=case["scene"].capacity).astype(np.float32))
    want = ri_sum.ri_sum_jvp_plain(inputs, den, tangent)
    _build.reset_launches()
    with _build.host_rehearsal():
        got = ri_sum._launch_ri_sum_jvp(inputs, den, tangent)
    assert dict(_build.LAUNCHES) == {"ri_sum_jvp": 1}
    _build.reset_launches()
    assert torch.equal(got, want)
    assert bool((got[den == 0] == 0).all()) and bool((got[den > 0] != 0).any())


def test_the_wrappers_check_their_arguments():
    scene = generic_scene()
    point, tr = _points(scene, seed=7)
    inputs = _inputs(scene, point, tr)
    den = torch.zeros(S, dtype=torch.int32)
    with pytest.raises(RuntimeError, match="CUDA"):  # outside the rehearsal: CUDA only
        ri_sum._launch_ri_sum(inputs)
    with pytest.raises(RuntimeError, match="CUDA"):
        ri_sum._launch_ri_sum_grad(inputs, den, tr)
    with _build.host_rehearsal():
        for k, bad in ((0, point.double()), (0, point.t()), (1, tr[1:]), (4, scene.rotation[1:]),
                       (6, scene.obj_type.long()), (7, scene.valid.to(torch.uint8))):
            args = list(inputs)
            args[k] = bad
            with pytest.raises(ValueError):
                ri_sum._launch_ri_sum(args)
        with pytest.raises(ValueError, match="den"):
            ri_sum._launch_ri_sum_grad(inputs, den.long(), tr)
        with pytest.raises(ValueError, match="g"):
            ri_sum._launch_ri_sum_grad(inputs, den, tr[1:])
        with pytest.raises(ValueError, match="smem_budget"):
            ri_sum._launch_ri_sum_grad(inputs, den, tr, ri_sum.MAX_SMEM_BUDGET + 1)


class _FakeKernel:
    """Stands for a kernel of the loaded library: records its calls."""

    def __init__(self, calls, name):
        self.argtypes, self.restype, self.calls, self.name = None, None, calls, name

    def __call__(self, *args):
        self.calls.append(self.name)
        if self.name == "grad":
            args[15]._obj.value = 1  # the mode it ran: the tile
        return 0


def test_containment_ri_on_a_device_tensor_never_calls_the_plain_version(monkeypatch):
    """A tensor off the CPU launches the kernels or raises: without a card
    (meta tensors) the launch raises, and with the launch stood in for it
    runs the kernels' wrappers, counted, and never the plain versions."""
    def plain(*args, **kw):
        raise AssertionError("the plain version ran for a tensor off the CPU")

    for name in ("ri_sum_plain", "ri_sum_grad_plain", "_inside", "_sum_in_row_order"):
        monkeypatch.setattr(ri_sum, name, plain)
    scene = _map(generic_scene(), lambda v: torch.empty_like(v, device="meta"))
    scene = scene.replace(refractive_index=scene.refractive_index.requires_grad_(True))
    point = torch.empty((S, 3), device="meta")
    tr = torch.empty((S,), device="meta")
    with pytest.raises(RuntimeError, match="CUDA"):
        ri_sum.containment_ri(scene, point, tr)

    calls = []
    lib = type("Lib", (), {})()
    lib.rt_ri_sum = _FakeKernel(calls, "forward")
    lib.rt_ri_sum_grad = _FakeKernel(calls, "grad")
    monkeypatch.setattr(_build, "check_device", lambda dev: None)
    monkeypatch.setattr(_build, "stream_of", lambda dev: None)
    monkeypatch.setattr(_build, "load", lambda name: lib)
    _build.reset_launches()
    out = ri_sum.containment_ri(scene, point, tr)
    torch.autograd.grad(out.sum(), scene.refractive_index)
    assert calls == ["forward", "grad"]
    assert dict(_build.LAUNCHES) == {"ri_sum": 1, "ri_sum_grad": 1}
    # no backward launch where the RI needs no gradient
    calls.clear()
    _build.reset_launches()
    ri_sum.containment_ri(scene.replace(refractive_index=scene.refractive_index.detach()),
                          point, tr)
    assert calls == ["forward"] and dict(_build.LAUNCHES) == {"ri_sum": 1}
    _build.reset_launches()


def test_the_render_path_sums_through_containment_ri(monkeypatch):
    """``_surrounding_ri``'s dense branch (no accel, or the gradient path's)
    is ``containment_ri``; on the CPU ``_ri_of_lanes`` still sums RI_CHUNK
    slots at a time."""
    scene = generic_scene()
    point, tr = _points(scene, seed=9)
    seen = []
    real = ri_sum.containment_ri

    def spy(s, p, t):
        seen.append(p.shape[0])
        return real(s, p, t)

    monkeypatch.setattr(ri_sum, "containment_ri", spy)
    monkeypatch.setattr(trender, "RI_CHUNK", 1000)
    got = trender._surrounding_ri(scene, None, point, tr)
    assert torch.equal(got, ri_sum.ri_sum_plain(_inputs(scene, point, tr))[0]) and seen == [S]
    seen.clear()
    need = torch.ones(S, dtype=torch.bool)
    ri, n = trender._ri_of_lanes(scene, None, point, tr, need, S)
    assert seen == [1000, 1000, 1000, 1000, 96] and int(n) == S
    assert torch.equal(ri, got)


@pytest.mark.parametrize("soft", [0.0, 0.03])
def test_the_step_through_the_rehearsed_kernels(monkeypatch, soft):
    """A banded gradient step on the CPU with the containment sum's forward
    and backward run by the kernel source as host C++: the loss bit for bit
    the plain route's, every gradient within 1e-6 of its field's max |g|;
    one forward launch a pop of every band, and one backward launch a pop
    but the last (the last pop's RI bends only children no pop reads)."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ to rehearse the kernel source with")
    scene, cam = examples.iow_final_scene(side=5)
    cfg = RenderConfig(width=16, height=8, spp=2, max_bounces=3,
                       intersector="pallas").for_scene(scene)
    cfg = dataclasses.replace(cfg, soft_edges=soft)
    pert = scene.replace(color=scene.color * 0.8 + 0.1)
    target = torch.full((cfg.height, cfg.width, 3), 0.5)
    p = diff.extract_params(pert)
    bands = 2

    def step():
        """The second call of a new function: the first also probes the
        RI slots (a forward without gradient)."""
        vg = diff.banded_value_and_grad(pert, cam, cfg, grad_bands=bands, device="cpu")
        vg(p, target)
        _build.reset_launches()
        out = vg(p, target)
        return out, sum(c.pops * len(idxs) for c, (_, idxs) in zip(vg.bucket_cfgs, vg.buckets))

    (loss_plain, grads_plain), _ = step()

    def rehearsed_sum(inputs):
        with _build.host_rehearsal():
            return ri_sum._launch_ri_sum(inputs)

    def rehearsed_grad(inputs, den, g):
        with _build.host_rehearsal():
            return ri_sum._launch_ri_sum_grad(inputs, den, g)[0]

    monkeypatch.setattr(ri_sum, "_ri_sum", rehearsed_sum)
    monkeypatch.setattr(ri_sum, "_ri_sum_grad", rehearsed_grad)
    (loss, grads), pops = step()
    launches = dict(_build.LAUNCHES)
    _build.reset_launches()
    assert pops > bands
    assert launches == {"ri_sum": pops, "ri_sum_grad": pops - bands}
    assert float(loss) == float(loss_plain)
    for name, want in grads_plain.items():
        scale = float(want.abs().max())
        assert float((getattr(grads, name) - want).abs().max()) <= 1e-6 * max(scale, 1e-30), name


def nested_glass(ty):
    """A glass sphere (RI 1.3) holding a denser one (1.8) and a glass cube
    (1.6), over a matte ground, with a coloured sphere behind (``ty``: the
    JAX package's or the port's ``scene.types``): a ray that refracts into
    the outer sphere and hits the inner one probes a point inside the outer
    one, whose RI the sum reads."""
    b = ty.SceneBuilder()
    b.add_dielectric((0.0, 0.0, -4.0), 1.2, ior=1.3)
    b.add_dielectric((0.15, 0.05, -4.0), 0.6, ior=1.8)
    b.add_box((-0.1, -0.1, -4.1), (0.5, 0.5, 0.5), refractive_index=1.6, refractivity=1.0,
              rotation_deg=(20.0, 30.0, 0.0))
    b.add_sphere((0.0, -101.2, -4.0), 100.0, color=(0.6, 0.5, 0.4), reflectivity=0.5,
                 scatter_reflect=0.9)
    b.add_sphere((1.5, 1.2, -6.0), 0.8, color=(0.2, 0.6, 0.9), reflectivity=0.3)
    cam = ty.Camera.make((0.0, 0.2, 0.5), (0.0, -0.05, -1.0), fov_y_deg=50.0, focus_dist=4.5)
    return b.build(), cam


def test_nested_glass_step_matches_jax_through_the_sum(monkeypatch):
    """16x12x2 at depth 6 (a ray needs five bounces to come out of both
    spheres), the outer and inner spheres' RI and the colours moved off the
    target's: the port's banded step (two bands) against
    ``jax.value_and_grad(render_loss)``.  The sum's backward gets lanes whose
    point lies inside glass with a gradient, and what it adds into the outer
    sphere's RI is more than a thousand times the field's bar: a step that
    lost it would fail the comparison."""
    size = dict(width=16, height=12, spp=2, max_bounces=6)
    js, jc = nested_glass(jtypes)
    jcfg = JRenderConfig(**size).for_scene(js)
    target = np.array(render_jit(js, jc, jcfg)["image"])
    jpert = js.replace(refractive_index=js.refractive_index.at[0].add(0.05).at[1].add(-0.05),
                       color=js.color * 0.9 + 0.05)
    jcfg = dataclasses.replace(jcfg, intersector="pallas")
    jl, jg = jax.value_and_grad(jdiff.render_loss)(
        jdiff.extract_params(jpert), jpert, jc, jcfg, jnp.asarray(target))

    ts = convert.scene_from_numpy({f: np.asarray(getattr(jpert, f)) for f in convert.SCENE_FIELDS})
    tc = convert.camera_from_numpy({f: np.asarray(getattr(jc, f)) for f in convert.CAMERA_FIELDS})
    tcfg = dataclasses.replace(RenderConfig(**size).for_scene(ts), intersector="pallas")
    assert tcfg.has_dielectrics and tcfg.shading != "materials"
    p = convert.scene_params_from_numpy(
        {f: np.asarray(getattr(jdiff.extract_params(jpert), f)) for f in diff.FLOAT_FIELDS})
    sums = []
    real = ri_sum._ri_sum_grad

    def keep(inputs, den, g):
        out = real(inputs, den, g)
        sums.append((int(((den > 0) & (g != 0)).sum()), out))
        return out

    monkeypatch.setattr(ri_sum, "_ri_sum_grad", keep)
    tl, tg = diff.banded_value_and_grad(ts, tc, tcfg, grad_bands=2, device="cpu")(
        p, torch.from_numpy(target))
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)
    for name, g in tg.items():
        want = np.asarray(getattr(jg, name))
        scale = float(np.abs(want).max())
        assert float(np.abs(g.numpy() - want).max()) <= 5e-4 * max(scale, 1e-30), name
    assert sum(n for n, _ in sums) > 0  # lanes inside glass with a gradient
    through_sum = float(sum(out for _, out in sums)[0])
    ri_scale = float(np.abs(np.asarray(jg.refractive_index)).max())
    assert abs(through_sum) > 1e3 * 5e-4 * ri_scale
