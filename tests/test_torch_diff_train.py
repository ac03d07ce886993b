"""The port's training step (``diff.train.make_train_step``, Adam) against
the JAX package's (``optax.adam``), and the recovery tests of
``tests/test_diff.py`` on one device.

Tolerances:
  - three Adam steps from the same scene and target: the losses within rtol
    1e-5 (found 6.8e-8, 1.7e-6, 5.8e-6: the colours drift apart by the
    gradients' 1e-4-relative difference, ``test_torch_diff``), the trained
    colours within 1e-6 absolute (found 4.2e-7: Adam's first steps move each
    entry by about the learning rate whatever the gradient's size) and
    Adam's first moment within rtol 1e-4 (found 2.0e-5);
  - the recoveries hold ``test_diff.py``'s bars: the loss below 5 % of the
    first (albedo), the displaced body's error halved (soft edges).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import optax

from raytracing_tests_tpu import diff as jdiff
from raytracing_tests_tpu.ops.render import RenderConfig as JRenderConfig
from raytracing_tests_tpu.ops.render import render_jit
from raytracing_tests_tpu.scene import examples as jex
from raytracing_tests_tpu_torch import diff
from raytracing_tests_tpu_torch.ops.render import RenderConfig, render
from raytracing_tests_tpu_torch.scene import examples as tex
from raytracing_tests_tpu_torch.scene import types as ttypes
from test_torch_diff import SIZE, box_scene, port_of

torch.set_num_threads(2)

CPU = "cpu"


def test_adam_steps_match_optax():
    js, jc = jex.materials_scene()
    jcfg = JRenderConfig(**SIZE).for_scene(js)
    target = np.asarray(render_jit(js, jc, jcfg)["image"])
    jpert = js.replace(color=js.color * 0.6 + 0.2)
    opt = optax.adam(2e-2)
    jstep = jdiff.make_train_step(jpert, jc, jcfg, opt,
                                  trainable=jdiff.params_mask(jpert, "color"))
    jst = jdiff.TrainState.create(jpert, opt)
    ts, tc = port_of(jpert, jc)
    tcfg = RenderConfig(**SIZE).for_scene(ts)
    tstep = diff.make_train_step(ts, tc, tcfg, diff.adam(2e-2),
                                 trainable=diff.params_mask(ts, "color"), device=CPU)
    tst = diff.TrainState.create(ts, diff.adam(2e-2), device=CPU)
    tgt = torch.from_numpy(target)
    for k in range(3):
        jst, jl = jstep(jst, jnp.asarray(target))
        tst, tl = tstep(tst, tgt)
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5, err_msg=f"step {k}")
    assert tst.step == 3 and int(jst.step) == 3
    np.testing.assert_allclose(tst.params.color.numpy(), np.asarray(jst.params.color), atol=1e-6)
    # the masked fields stay where they were, Adam's moments at zero
    assert torch.equal(tst.params.position, ts.position)
    assert float(tst.opt_state["position"]["exp_avg"].abs().max()) == 0.0
    assert float(tst.opt_state["color"]["step"]) == 3.0
    np.testing.assert_allclose(tst.opt_state["color"]["exp_avg"].numpy(),
                               np.asarray(jst.opt_state[0].mu.color), rtol=1e-4, atol=1e-9)


@pytest.fixture(scope="module")
def setup():
    scene, cam = tex.materials_scene()
    cfg = RenderConfig(**SIZE)
    target = render(scene, cam, cfg, device=CPU)["image"]
    return scene, cam, cfg, target


def _train(pert, cam, cfg, target, field, steps, **kw):
    opt = diff.adam(2e-2)
    step = diff.make_train_step(pert, cam, cfg, opt, trainable=diff.params_mask(pert, field),
                                device=CPU, **kw)
    st = diff.TrainState.create(pert, opt, device=CPU)
    losses = []
    for _ in range(steps):
        st, loss = step(st, target)
        losses.append(float(loss))
    return st, losses


def test_inverse_rendering_recovers_albedo(setup):
    scene, cam, cfg, target = setup
    pert = scene.replace(color=scene.color * 0.6 + 0.2)
    _, losses = _train(pert, cam, cfg, target, "color", 40)
    assert losses[-1] < losses[0] * 0.05, (losses[0], losses[-1])


def test_soft_edges_recover_displaced_sphere(setup):
    """With position trainable, the soft-edge estimator pulls a displaced
    sphere back toward the target."""
    scene, cam, cfg, target = setup
    cfg = dataclasses.replace(cfg.for_scene(scene), intersector="pallas", soft_edges=0.05)
    pos = scene.position.clone()
    pos[1, 0] += 0.12
    st, _ = _train(scene.replace(position=pos), cam, cfg, target, "position", 30)
    err0 = 0.12
    err1 = abs(float(st.params.position[1, 0] - scene.position[1, 0]))
    assert err1 < 0.5 * err0, (err0, err1)


def test_soft_edges_recover_displaced_box():
    scene, cam = box_scene(ttypes)
    cfg = RenderConfig(**SIZE)
    target = render(scene, cam, cfg, device=CPU)["image"]
    cfg = dataclasses.replace(cfg.for_scene(scene), intersector="pallas", soft_edges=0.05)
    assert cfg.pallas_mode == "generic"
    pos = scene.position.clone()
    pos[0, 0] += 0.12
    st, _ = _train(scene.replace(position=pos), cam, cfg, target, "position", 30)
    err1 = abs(float(st.params.position[0, 0] - scene.position[0, 0]))
    assert err1 < 0.5 * 0.12, err1


def test_train_step_auto_pops_runs():
    scene, cam = tex.materials_scene()
    cfg = RenderConfig(width=16, height=12, spp=1, max_bounces=6,
                       intersector="pallas").for_scene(scene)
    target = render(scene, cam, cfg, device=CPU)["image"]
    pert = scene.replace(color=scene.color * 0.7)
    st, losses = _train(pert, cam, cfg, target, "color", 2, grad_bands=2, auto_pops=True)
    assert losses[1] < losses[0]


def _reflective(refl):
    b = ttypes.SceneBuilder()
    b.add_sphere((0.0, 0.0, -3.0), 1.0, color=(0.8, 0.3, 0.3), reflectivity=refl,
                 scatter_reflect=0.0)
    b.add_box((0.0, -101.0, 0.0), (400.0, 200.0, 400.0), color=(0.4, 0.8, 0.4),
              reflectivity=refl, scatter_reflect=0.0)
    return b.build()


def test_auto_pops_reprobes_when_trees_deepen():
    """Parameter drift can deepen ray trees past the probed depths: the
    auto_pops step re-probes on its cadence and rebuilds its buckets instead
    of truncating the gradient."""
    cam = ttypes.Camera.make((0.0, 0.5, 2.0), (0.0, -0.1, -1.0), fov_y_deg=60.0,
                             focus_dist=5.0)
    pert = _reflective(0.0)  # shallow trees: the probe sees depth ~1
    cfg = RenderConfig(width=24, height=16, spp=1, max_bounces=6,
                       intersector="pallas").for_scene(_reflective(0.9))
    target = render(_reflective(0.9), cam, cfg, device=CPU)["image"]
    opt = diff.adam(1e-2)
    step = diff.make_train_step(pert, cam, cfg, opt, grad_bands=2, auto_pops=True,
                                trainable=diff.params_mask(pert, "color"), device=CPU)
    pops0 = list(step.pops_state["band_pops"])
    assert max(pops0) <= 4
    st = diff.TrainState.create(pert, opt, device=CPU)
    for _ in range(24):
        st, loss = step(st, target)
        assert np.isfinite(float(loss))
    # drift the params into a deep-tree regime (a restore or a manual edit)
    deep = diff.extract_params(_reflective(0.9))
    for (_, v), (_, w) in zip(st.params.items(), deep.items()):
        v.copy_(w)
    st, loss = step(st, target)  # step 25: the re-probe fires
    assert np.isfinite(float(loss))
    assert max(step.pops_state["band_pops"]) > max(pops0), (pops0, step.pops_state)
    st, loss = step(st, target)  # and the rebuilt traces keep working
    assert np.isfinite(float(loss))
