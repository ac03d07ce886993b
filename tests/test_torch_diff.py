"""The gradient path of the port (``diff/``) against the JAX package's, at the
sizes of ``tests/test_diff.py`` (24x16x2, depth 3-4; ``materials_scene()`` and
the rotated-box scene), and the single-device tests of that file ported.

On the CPU the port's sweep wrappers run their plain PyTorch versions; the JAX
side runs its Pallas kernels in interpret mode.  Both packages are fed the
same scene leaves (``convert``).

Tolerances:
  - loss and every ``SceneParams`` field's gradient against
    ``jax.value_and_grad(render_loss)`` (``test_loss_and_grads_match_jax``):
    the loss within rtol 1e-6 and each field within 5e-4 of the field's
    max |g| (found: 6.8e-8 and 1.0e-4 on scatter_reflect; XLA:CPU fuses a*b+c
    where eager PyTorch rounds twice, and the reflection cone's scatter is
    the most sensitive term).  With ``soft_edges`` on the sphere scene: the
    loss within rtol 1e-4 and the fields within 1e-2 of max |g| (found 1.3e-5
    and 6.0e-3: a grazing lane that one package hits and the other adopts as
    a near miss carries a different coverage and tangent point).
  - the port's own identities as ``test_diff.py`` holds the JAX package's:
    banded equals full (rtol 1e-6 / 2e-5), the probed pop count and the depth
    buckets exact, the fast path equal to the dense one (atol 1e-7), and the
    finite-difference bars of ``test_diff.py``, unchanged.
  - the forward renderer's pop count per band equals the JAX package's probe
    (the port's probe counts the gradient path's own trees instead, which is
    what makes a probed trace exact; see ``diff.train._probe_cfg``).
  - per-pixel d(image)/d(theta) by forward-mode autodiff against central
    differences of the JAX package's numpy oracle, the bars of ``test_diff.py``
    (atol 2e-2 for an albedo, 5e-2 for a refractive index).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from raytracing_tests_tpu import diff as jdiff
from raytracing_tests_tpu.ops.render import RenderConfig as JRenderConfig
from raytracing_tests_tpu.ops.render import render_jit
from raytracing_tests_tpu.scene import examples as jex
from raytracing_tests_tpu.scene import types as jtypes
from raytracing_tests_tpu_torch import convert
from raytracing_tests_tpu_torch import diff
from raytracing_tests_tpu_torch.ops.render import RenderConfig, render
from raytracing_tests_tpu_torch.scene import examples as tex
from raytracing_tests_tpu_torch.scene import types as ttypes

torch.set_num_threads(2)

CPU = "cpu"
SIZE = dict(width=24, height=16, spp=2, max_bounces=3)


def port_of(js, jc):
    """The JAX scene and camera as the port's, leaf for leaf."""
    ts = convert.scene_from_numpy({f: np.asarray(getattr(js, f)) for f in convert.SCENE_FIELDS})
    tc = convert.camera_from_numpy(
        {f: np.asarray(getattr(jc, f)) for f in convert.CAMERA_FIELDS})
    return ts, tc


def box_scene(ty):
    """One rotated box over a matte ground, camera square-on: a loss
    dominated by the box's silhouette (``test_diff.py``'s generic fixture)."""
    b = ty.SceneBuilder()
    b.add_box((0.0, 0.0, -4.0), (0.9, 0.9, 0.9), rotation_deg=(0.0, 35.0, 0.0),
              color=(0.85, 0.3, 0.2), reflectivity=0.6, scatter_reflect=0.4)
    b.add_sphere((0.0, -100.6, -4.0), 100.0, color=(0.6, 0.6, 0.6), reflectivity=0.5,
                 scatter_reflect=0.9)
    cam = ty.Camera.make((0.0, 0.3, 0.5), (0.0, -0.05, -1.0), fov_y_deg=55.0,
                         focus_dist=4.5)
    return b.build(), cam


@pytest.fixture(scope="module")
def setup():
    """``materials_scene()`` at 24x16x2 depth 3 and the port's own target."""
    scene, cam = tex.materials_scene()
    cfg = RenderConfig(**SIZE)
    target = render(scene, cam, cfg, device=CPU)["image"]
    return scene, cam, cfg, target


@pytest.fixture(scope="module")
def generic_setup():
    scene, cam = box_scene(ttypes)
    cfg = RenderConfig(**SIZE)
    target = render(scene, cam, cfg, device=CPU)["image"]
    return scene, cam, cfg, target


def _colour_shift(s):
    return s.replace(color=s.color * 0.6 + 0.2)


# name -> (scene factory (types module) or None for materials, intersector,
#          soft_edges, perturbation of the JAX scene, (loss rtol, field bar))
CASES = {
    "brute": (None, "brute", 0.0, _colour_shift, (1e-6, 5e-4)),
    "pallas": (None, "pallas", 0.0, _colour_shift, (1e-6, 5e-4)),
    "pallas_soft": (None, "pallas", 0.03,
                    lambda s: s.replace(position=s.position.at[1, 0].add(0.08)), (1e-4, 1e-2)),
    "generic_pallas": (box_scene, "pallas", 0.0,
                       lambda s: s.replace(position=s.position.at[0, 0].add(0.07)),
                       (1e-6, 5e-4)),
    "generic_soft": (box_scene, "pallas", 0.03,
                     lambda s: s.replace(position=s.position.at[0, 0].add(0.07)), (1e-6, 5e-4)),
}


def _jvp_case(case):
    """(the JAX scene, camera, config, target, perturbed scene, the port's
    perturbed scene, camera and config, its params, the field bar) of a
    forward-mode case: a case of CASES, or ``nested_glass`` (the nested-glass
    frame of ``test_torch_ri_sum.py``, 16x12x2 at depth 6, RI and colours
    moved), whose probe points lie inside glass."""
    if case == "nested_glass":
        from test_torch_ri_sum import nested_glass

        size = dict(width=16, height=12, spp=2, max_bounces=6)
        js, jc = nested_glass(jtypes)
        intersector, soft, bar = "pallas", 0.0, 5e-4
        perturb = lambda s: s.replace(  # noqa: E731
            refractive_index=s.refractive_index.at[0].add(0.05).at[1].add(-0.05),
            color=s.color * 0.9 + 0.05)
    else:
        factory, intersector, soft, perturb, (_, bar) = CASES[case]
        size = SIZE
        js, jc = jex.materials_scene() if factory is None else factory(jtypes)
    jcfg = JRenderConfig(**size).for_scene(js)
    target = np.asarray(render_jit(js, jc, jcfg)["image"])
    jpert = perturb(js)
    jcfg = dataclasses.replace(jcfg, intersector=intersector, soft_edges=soft)
    ts, tc = port_of(jpert, jc)
    tcfg = dataclasses.replace(RenderConfig(**size).for_scene(ts), intersector=intersector,
                               soft_edges=soft)
    p = convert.scene_params_from_numpy(
        {f: np.asarray(getattr(jdiff.extract_params(jpert), f)) for f in diff.FLOAT_FIELDS})
    return jc, jcfg, target, jpert, ts, tc, tcfg, p, bar


@pytest.mark.parametrize("case", ["pallas", "pallas_soft", "generic_pallas", "generic_soft",
                                  "nested_glass"])
def test_forward_mode_through_the_fast_path_matches_jax_jvp(case):
    """``torch.func.jvp`` of the port's ``render_loss`` on the fast path
    (``intersector="pallas"``: the winner gather, the recompute and the
    containment sum under forward-mode AD) against ``jax.jvp`` of the JAX
    package's, along a seeded tangent of every trainable field: within the
    bars of ``test_loss_and_grads_match_jax`` carried to a tangent v, the
    field bar times the sum over fields of max |g| times sum |v| (g the port's
    reverse-mode gradient); and against that gradient, <g, v>, within 1e-4
    of sum |g v| (forward and reverse mode of the same port)."""
    jc, jcfg, target, jpert, ts, tc, tcfg, p, bar = _jvp_case(case)
    rng = np.random.default_rng(7)
    tan = {f: rng.normal(size=np.shape(getattr(jdiff.extract_params(jpert), f))).astype(
        np.float32) for f in diff.FLOAT_FIELDS}
    jp = jdiff.extract_params(jpert)

    def jloss(*fields):
        return jdiff.render_loss(jp.replace(**dict(zip(diff.FLOAT_FIELDS, fields))), jpert, jc,
                                 jcfg, jnp.asarray(target))

    _, jt = jax.jvp(jloss, tuple(getattr(jp, f) for f in diff.FLOAT_FIELDS),
                    tuple(jnp.asarray(tan[f]) for f in diff.FLOAT_FIELDS))

    def tloss(*fields):
        return diff.render_loss(p.replace(**dict(zip(diff.FLOAT_FIELDS, fields))), ts, tc, tcfg,
                                torch.from_numpy(target), device=CPU)

    _, tt = torch.func.jvp(tloss, tuple(getattr(p, f) for f in diff.FLOAT_FIELDS),
                           tuple(torch.from_numpy(tan[f]) for f in diff.FLOAT_FIELDS))
    _, tg = diff.value_and_grad_loss(p, ts, tc, tcfg, torch.from_numpy(target), device=CPU)
    grads = dict(tg.items())
    size = sum(float(grads[f].abs().max()) * float(np.abs(tan[f]).sum())
               for f in diff.FLOAT_FIELDS)
    assert size > 0.0
    assert abs(float(tt) - float(jt)) <= bar * size, (float(tt), float(jt), bar * size)
    dot = sum(float((grads[f] * torch.from_numpy(tan[f])).sum()) for f in diff.FLOAT_FIELDS)
    terms = sum(float((grads[f] * torch.from_numpy(tan[f])).abs().sum())
                for f in diff.FLOAT_FIELDS)
    assert abs(float(tt) - dot) <= 1e-4 * terms, (float(tt), dot, terms)
    assert abs(float(tt)) > 1e-3 * terms  # the tangent moves the loss


@pytest.mark.parametrize("case", list(CASES))
def test_loss_and_grads_match_jax(case):
    factory, intersector, soft, perturb, (rtol, bar) = CASES[case]
    js, jc = jex.materials_scene() if factory is None else factory(jtypes)
    jcfg = JRenderConfig(**SIZE).for_scene(js)
    target = np.asarray(render_jit(js, jc, jcfg)["image"])
    jpert = perturb(js)
    jcfg = dataclasses.replace(jcfg, intersector=intersector, soft_edges=soft)
    jl, jg = jax.value_and_grad(jdiff.render_loss)(
        jdiff.extract_params(jpert), jpert, jc, jcfg, jnp.asarray(target))
    ts, tc = port_of(jpert, jc)
    tcfg = dataclasses.replace(RenderConfig(**SIZE).for_scene(ts), intersector=intersector,
                               soft_edges=soft)
    assert tcfg.pallas_mode == jcfg.pallas_mode == ("spheres" if factory is None else "generic")
    p = convert.scene_params_from_numpy(
        {f: np.asarray(getattr(jdiff.extract_params(jpert), f)) for f in diff.FLOAT_FIELDS})
    tl, tg = diff.value_and_grad_loss(p, ts, tc, tcfg, torch.from_numpy(target), device=CPU)
    np.testing.assert_allclose(float(tl), float(jl), rtol=rtol)
    moved = 0
    for name, g in tg.items():
        want = np.asarray(getattr(jg, name))
        scale = float(np.abs(want).max())
        err = float(np.abs(g.numpy() - want).max())
        assert err <= bar * max(scale, 1e-30), (name, err, scale)
        assert np.isfinite(g.numpy()).all(), name
        moved += scale > 0.0
    assert moved >= 5


def test_all_gradients_finite(setup):
    scene, cam, cfg, target = setup
    pert = _colour_shift(scene)
    _, g = diff.value_and_grad_loss(diff.extract_params(pert), pert, cam, cfg, target,
                                    device=CPU)
    for name, v in g.items():
        assert bool(torch.isfinite(v).all()), f"non-finite grads in {name}"


def test_gradient_path_runs_under_anomaly_mode(setup):
    """The queue's pushes under autograd and every guarded root: autograd's
    anomaly mode finds no in-place change of a saved tensor and no NaN in any
    backward step, with and without soft edges."""
    scene, cam, cfg, target = setup
    pert = scene.replace(position=scene.position.clone())
    pert.position[1, 0] += 0.08
    cfg = dataclasses.replace(cfg, intersector="pallas").for_scene(pert)
    with torch.autograd.detect_anomaly():
        for soft in (0.0, 0.03):
            c = dataclasses.replace(cfg, soft_edges=soft)
            diff.value_and_grad_loss(diff.extract_params(pert), pert, cam, c, target,
                                     device=CPU)


def test_banded_grads_match_full(setup):
    scene, cam, cfg, target = setup
    cfg = dataclasses.replace(cfg, intersector="pallas").for_scene(scene)
    pert = _colour_shift(scene)
    p = diff.extract_params(pert)
    loss_f, g_f = diff.value_and_grad_loss(p, pert, cam, cfg, target, device=CPU)
    loss_b, g_b = diff.banded_value_and_grad(pert, cam, cfg, grad_bands=4, device=CPU)(
        p, target)
    np.testing.assert_allclose(float(loss_b), float(loss_f), rtol=1e-6)
    for name, a in g_f.items():
        np.testing.assert_allclose(getattr(g_b, name).numpy(), a.numpy(), rtol=2e-5,
                                   atol=1e-7, err_msg=name)


def _loss_with(p, field, index, delta, *args):
    arr = getattr(p, field).clone()
    arr[index] += delta
    return float(diff.render_loss(p.replace(**{field: arr}), *args, device=CPU))


@pytest.mark.parametrize("field,index", [
    ("color", (0, 0)), ("color", (1, 2)), ("reflectivity", (2,)), ("refractivity", (1,)),
    ("refractive_index", (1,)),
])
def test_grad_matches_finite_difference(setup, field, index):
    """Appearance parameters are smooth: autodiff == central finite diff."""
    scene, cam, cfg, target = setup
    pert = _colour_shift(scene)
    p = diff.extract_params(pert)
    _, g = diff.value_and_grad_loss(p, pert, cam, cfg, target, device=CPU)
    eps = 1e-3
    args = (pert, cam, cfg, target)
    fd = (_loss_with(p, field, index, eps, *args) - _loss_with(p, field, index, -eps, *args)) \
        / (2 * eps)
    ad = float(getattr(g, field)[index])
    assert np.isclose(ad, fd, rtol=5e-2, atol=1e-7), (field, index, ad, fd)


def test_grad_wrt_geometry_descends(setup):
    scene, cam, cfg, target = setup
    pos = scene.position.clone()
    pos[0, 1] += 0.05
    pert = scene.replace(position=pos)
    p = diff.extract_params(pert)
    loss0, g = diff.value_and_grad_loss(p, pert, cam, cfg, target, device=CPU)
    stepped = p.replace(position=p.position - 0.02 * g.position / (1e-8 + g.position.abs().max()))
    loss1 = float(diff.render_loss(stepped, pert, cam, cfg, target, device=CPU))
    assert loss1 < float(loss0), (float(loss0), loss1)


def test_pallas_diff_grads_match_brute(setup):
    """Winner-recompute gradients == dense-sweep gradients on every field."""
    scene, cam, cfg, target = setup
    cfg = cfg.for_scene(scene)
    assert cfg.pallas_mode == "spheres"
    pert = _colour_shift(scene)
    p = diff.extract_params(pert)
    _, gb = diff.value_and_grad_loss(p, pert, cam, dataclasses.replace(cfg, intersector="brute"),
                                     target, device=CPU)
    _, gp = diff.value_and_grad_loss(p, pert, cam,
                                     dataclasses.replace(cfg, intersector="pallas"), target,
                                     device=CPU)
    for name, a in gb.items():
        np.testing.assert_allclose(a.numpy(), getattr(gp, name).numpy(), atol=1e-7,
                                   err_msg=name)


def _soft_fd(p, pert, cam, cfg, target, field, index):
    _, g = diff.value_and_grad_loss(p, pert, cam, cfg, target, device=CPU)
    eps = 1e-5  # small: the difference must sample the smooth band, not candidate swaps
    args = (pert, cam, cfg, target)
    fd = (_loss_with(p, field, index, eps, *args) - _loss_with(p, field, index, -eps, *args)) \
        / (2 * eps)
    return float(getattr(g, field)[index]), fd


@pytest.mark.parametrize("field,index", [("position", (1, 1)), ("scale", (1, 0))])
def test_soft_edge_grad_matches_fd_through_silhouette(setup, field, index):
    """With soft_edges on, AD == FD for geometry whose loss response runs
    through a visible silhouette."""
    scene, cam, cfg, target = setup
    cfg = dataclasses.replace(cfg.for_scene(scene), intersector="pallas", soft_edges=0.03)
    pos = scene.position.clone()
    pos[1, 0] += 0.08
    pert = scene.replace(position=pos)
    ad, fd = _soft_fd(diff.extract_params(pert), pert, cam, cfg, target, field, index)
    assert np.isclose(ad, fd, rtol=1.5e-1, atol=1e-6), (field, index, ad, fd)


@pytest.mark.parametrize("field,index", [("position", (0, 0)), ("scale", (0, 1))])
def test_soft_edge_grad_generic_matches_fd(generic_setup, field, index):
    """The edge-aware estimator through a rotated cuboid's silhouette."""
    scene, cam, cfg, target = generic_setup
    cfg = dataclasses.replace(cfg.for_scene(scene), intersector="pallas", soft_edges=0.03)
    assert cfg.pallas_mode == "generic"
    pos = scene.position.clone()
    pos[0, 0] += 0.07
    pert = scene.replace(position=pos)
    ad, fd = _soft_fd(diff.extract_params(pert), pert, cam, cfg, target, field, index)
    assert np.isclose(ad, fd, rtol=1.5e-1, atol=1e-6), (field, index, ad, fd)


def test_generic_fast_gradients_match_dense():
    """Generic mode: the detached sweep2g winner and the closed-form recompute
    against the dense sweep, for colour and interior position."""
    scene, cam = tex.bvh_grid_scene(side=4)
    base = RenderConfig(width=32, height=24, spp=2, max_bounces=4,
                        intersector="pallas").for_scene(scene)
    assert base.pallas_mode == "generic"
    cfg_fast = dataclasses.replace(base, diff_mode=True)
    cfg_dense = dataclasses.replace(base, intersector="brute")
    for field in ("color", "position"):
        grads = []
        for cfg in (cfg_fast, cfg_dense):
            v = getattr(scene, field).clone().requires_grad_(True)
            out = render(scene.replace(**{field: v}), cam, cfg, device=CPU)
            grads.append(torch.autograd.grad(out["image"].mean(), v)[0])
        gf, gd = grads
        scale = float(gd.abs().max()) + 1e-8
        assert float((gf - gd).abs().max()) / scale < 2e-3, field
        assert bool(torch.isfinite(gf).all()), field


def test_pixel_grad_allclose_vs_cpu_ref():
    """Per-pixel d(image)/d(theta) by forward-mode autodiff in the port against
    central differences of the JAX package's independent numpy oracle: an
    albedo channel and a dielectric's refractive index (the refraction chain)."""
    from raytracing_tests_tpu.reference.cpu_renderer import render_cpu

    js, jc = jex.materials_scene()
    jcfg = dataclasses.replace(
        JRenderConfig(width=24, height=16, spp=2, max_bounces=4,
                      intersector="brute").for_scene(js), early_exit=False)
    ts, tc = port_of(js, jc)
    tcfg = RenderConfig(width=24, height=16, spp=2, max_bounces=4).for_scene(ts)

    def check(field, index, eps, atol):
        base = float(np.asarray(getattr(js, field))[index])

        def img_of(v):
            arr = getattr(ts, field).clone()
            arr[index] = v
            return render(ts.replace(**{field: arr}), tc, tcfg, device=CPU)["image"]

        _, g_ad = torch.func.jvp(img_of, (torch.tensor(base),), (torch.tensor(1.0),))

        def cpu_img(v):
            arr = getattr(js, field).at[index].set(v)
            return np.asarray(render_cpu(js.replace(**{field: arr}), jc, jcfg)["image"])

        g_fd = (cpu_img(base + eps) - cpu_img(base - eps)) / (2 * eps)
        np.testing.assert_allclose(g_ad.numpy(), g_fd, atol=atol)
        assert np.abs(g_fd).max() > atol  # the pixels do move

    check("color", (2, 0), 2e-3, 2e-2)
    check("refractive_index", (1,), 1e-3, 5e-2)


@pytest.fixture(scope="module")
def iow4():
    scene, cam = tex.iow_final_scene(side=4)
    cfg = RenderConfig(width=32, height=24, spp=2, max_bounces=8,
                       intersector="pallas").for_scene(scene)
    p = diff.extract_params(scene.replace(color=scene.color * 0.9))
    return scene, cam, cfg, p, torch.zeros((24, 32, 3))


def test_probed_grad_pops_is_exact(iow4):
    """A probed trace length reproduces the full budget's loss and gradients
    exactly: the steps cut only pop empty queues."""
    scene, cam, cfg, p, target = iow4
    pops = diff.probe_max_pops(scene, cam, cfg, device=CPU)
    assert 0 < pops < cfg.pops
    full = diff.banded_value_and_grad(scene, cam, cfg, grad_bands=4, device=CPU)(p, target)
    cut = diff.banded_value_and_grad(scene, cam, cfg, grad_bands=4, grad_pops=pops,
                                     device=CPU)(p, target)
    assert float(full[0]) == float(cut[0])
    for name, a in full[1].items():
        assert torch.equal(a, getattr(cut[1], name)), name


def test_band_pops_count_as_jax_and_buckets_are_exact(iow4):
    """The pop count of the forward renderer per band equals the JAX probe's
    (which probes with that renderer), the port's probe counts the gradient
    path's own trees, and the depth-bucketed gradients equal the flat ones to
    accumulation order."""
    from raytracing_tests_tpu_torch.diff.train import _probe_lanes
    from raytracing_tests_tpu_torch.ops.render import _build_accel, trace_lanes

    scene, cam, cfg, p, target = iow4
    bp = diff.probe_band_pops(scene, cam, cfg, grad_bands=4, device=CPU)
    js, jc = jex.iow_final_scene(side=4)
    jcfg = JRenderConfig(width=32, height=24, spp=2, max_bounces=8,
                         intersector="pallas").for_scene(js)
    o, d, tr, sidx = _probe_lanes(cam, cfg, torch.device(CPU))
    flat = lambda x: x.reshape((-1,) + x.shape[3:])
    accel = _build_accel(scene, cfg)
    forward = [trace_lanes(scene, None, cfg, flat(o[b * 6:b * 6 + 6]), flat(d[b * 6:b * 6 + 6]),
                           flat(tr[b * 6:b * 6 + 6]), flat(sidx[b * 6:b * 6 + 6]), accel,
                           return_pops=True)[4] for b in range(4)]
    assert forward == jdiff.probe_band_pops(js, jc, jcfg, grad_bands=4)
    assert diff.probe_max_pops(scene, cam, cfg, device=CPU) == max(bp)
    assert len(bp) == 4 and min(bp) >= 1 and len(set(bp)) > 1
    full = diff.banded_value_and_grad(scene, cam, cfg, grad_bands=4, device=CPU)(p, target)
    cut = diff.banded_value_and_grad(scene, cam, cfg, grad_bands=4, band_pops=bp,
                                     device=CPU)(p, target)
    np.testing.assert_allclose(float(full[0]), float(cut[0]), rtol=1e-6)
    for name, a in full[1].items():
        np.testing.assert_allclose(getattr(cut[1], name).numpy(), a.numpy(), rtol=2e-5,
                                   atol=1e-7, err_msg=name)


def test_buckets_merge_to_three():
    from raytracing_tests_tpu_torch.diff.train import _buckets

    assert _buckets([1, 9, 4, 17, 12, 3], 6, 17) == [(4, (0, 2, 5)), (12, (1, 4)), (17, (3,))]
    assert _buckets([30, 1], 2, 17) == [(1, (1,)), (17, (0,))]


def test_grad_finite_with_negative_trained_color():
    """A trained colour driven negative makes a sample's channel negative:
    the diff-mode gamma floor keeps its gradient an exact 0, not NaN."""
    scene, cam = tex.iow_final_scene(side=4)
    cfg = RenderConfig(width=32, height=24, spp=2, max_bounces=6,
                       intersector="pallas").for_scene(scene)
    col = scene.color.clone()
    col[1:6] = -0.05
    pert = scene.replace(color=col)
    loss, g = diff.banded_value_and_grad(pert, cam, cfg, grad_bands=2, device=CPU)(
        diff.extract_params(pert), torch.zeros((24, 32, 3)))
    assert np.isfinite(float(loss))
    for name, v in g.items():
        assert bool(torch.isfinite(v).all()), name


def test_entry_points_refuse_what_is_not_ported(setup):
    scene, cam, cfg, target = setup
    p = diff.extract_params(scene)
    from raytracing_tests_tpu_torch.parallel import make_mesh

    # A mesh is taken now (the sharded loss is the single-device one); what
    # stays refused with it is what the JAX package refuses: row bands.
    mesh = make_mesh(devices=[CPU] * 2)
    np.testing.assert_allclose(
        float(diff.render_loss(p, scene, cam, cfg, target, mesh=mesh, device=CPU)),
        float(diff.render_loss(p, scene, cam, cfg, target, device=CPU)), rtol=1e-6)
    with pytest.raises(ValueError, match="single-device"):
        diff.make_train_step(scene, cam, cfg, diff.adam(1e-2), mesh=mesh, grad_bands=2,
                             device=CPU)
    with pytest.raises(ValueError, match="soft_edges"):
        diff.render_loss(p, scene, cam, dataclasses.replace(cfg, soft_edges=0.03), target,
                         device=CPU)
    with pytest.raises(ValueError, match="grad_bands"):
        diff.make_train_step(scene, cam, cfg, diff.adam(1e-2), auto_pops=True, device=CPU)
    if not torch.cuda.is_available():  # device=None means the GPU
        with pytest.raises(RuntimeError, match="CUDA"):
            diff.render_loss(p, scene, cam, cfg, target)


def test_scene_params_round_trip_through_numpy():
    """``convert``: JAX ``SceneParams`` leaves -> the port's and back, bit for
    bit, textures included."""
    js, _ = jex.texturing_scene()
    jp = jdiff.extract_params(js)
    leaves = {f: np.asarray(getattr(jp, f)) for f in diff.FLOAT_FIELDS}
    leaves["textures"] = np.asarray(jp.textures)
    p = convert.scene_params_from_numpy(leaves)
    back = convert.scene_params_to_numpy(p)
    assert set(back) == set(leaves)
    for name, v in leaves.items():
        assert np.array_equal(back[name], v) and back[name].dtype == v.dtype, name
    ts, _ = port_of(js, jex.texturing_scene()[1])
    assert "textures" not in convert.scene_params_to_numpy(diff.extract_params(ts))
