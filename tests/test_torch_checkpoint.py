"""``app.checkpoint`` and the CLI's ``train`` subcommand of the port.

A resumed run must continue bit for bit: the checkpoint holds the scene
parameters, Adam's step and both moments per field, and the step count, and
restoring pours them into a fresh ``TrainState``.  The CLI's demo starts from
the JAX package's perturbed scene (the same numpy draws): compared equal.
"""

import logging
import os

import numpy as np
import pytest
import torch

from raytracing_tests_tpu.scene import examples as jex
from raytracing_tests_tpu_torch import convert, diff
from raytracing_tests_tpu_torch.app import checkpoint as ckpt
from raytracing_tests_tpu_torch.app import cli
from raytracing_tests_tpu_torch.ops.render import RenderConfig, render
from raytracing_tests_tpu_torch.scene import examples as tex
from test_torch_diff import port_of

torch.set_num_threads(2)

CPU = "cpu"


def _setup():
    scene, cam = tex.materials_scene()
    cfg = RenderConfig(width=16, height=12, spp=1, max_bounces=3,
                       intersector="pallas").for_scene(scene)
    target = render(scene, cam, cfg, device=CPU)["image"]
    pert = scene.replace(color=scene.color * 0.6 + 0.2)
    opt = diff.adam(2e-2)
    step = diff.make_train_step(pert, cam, cfg, opt,
                                trainable=diff.params_mask(pert, "color", "position"),
                                device=CPU)
    return pert, opt, step, target


def test_round_trip_resumes_identically(tmp_path):
    pert, opt, step, target = _setup()
    st = diff.TrainState.create(pert, opt, device=CPU)
    for _ in range(2):
        st, _ = step(st, target)
    # the state's parameters through numpy and back (``convert``), bit for bit
    back_p = convert.scene_params_from_numpy(convert.scene_params_to_numpy(st.params))
    assert all(torch.equal(a, b) for (_, a), (_, b) in zip(st.params.items(), back_p.items()))
    path = ckpt.save_train_state(str(tmp_path), st, st.step)
    assert os.path.basename(path) == "ckpt_2.npz"
    on, losses_on = st, []
    for _ in range(2):
        on, loss = step(on, target)
        losses_on.append(float(loss))
    fresh = diff.TrainState.create(pert, opt, device=CPU)
    back, at = ckpt.restore_train_state(str(tmp_path), fresh)
    assert at == 2 and back.step == 2
    assert float(back.opt_state["color"]["step"]) == 2.0
    assert float(back.opt_state["color"]["exp_avg_sq"].abs().max()) > 0.0
    losses_back = []
    for _ in range(2):
        back, loss = step(back, target)
        losses_back.append(float(loss))
    assert losses_back == losses_on
    for (name, a), (_, b) in zip(on.params.items(), back.params.items()):
        assert torch.equal(a, b), name
    for name in ("color", "position"):
        for k in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(on.opt_state[name][k], back.opt_state[name][k]), (name, k)


def test_latest_checkpoint_and_leaf_count(tmp_path):
    assert ckpt.latest_checkpoint(str(tmp_path / "none")) is None
    assert ckpt.restore_train_state(str(tmp_path), None) == (None, 0)
    for name in ("ckpt_2.npz", "ckpt_10.npz", "ckpt_x.npz", "other_99.npz", "ckpt_7.txt"):
        (tmp_path / name).write_bytes(b"")
    assert ckpt.latest_checkpoint(str(tmp_path)) == str(tmp_path / "ckpt_10.npz")
    tree = {"a": torch.arange(3.0), "b": [np.ones(2, np.int32), 5], "c": None}
    ckpt.save_pytree(str(tmp_path / "t.npz"), tree)
    back = ckpt.load_pytree(str(tmp_path / "t"), tree)
    assert torch.equal(back["a"], tree["a"]) and back["b"][1] == 5 and back["c"] is None
    assert back["b"][0].dtype == np.int32
    with pytest.raises(ValueError, match="leaves"):
        ckpt.load_pytree(str(tmp_path / "t.npz"), {"a": torch.zeros(3)})


def test_cli_train_starts_from_the_jax_demo_scene():
    js, _ = jex.materials_scene()
    ts, _ = port_of(js, jex.materials_scene()[1])
    fields = ["color", "position", "scale"]
    got = cli._perturbed(ts, fields, 3)
    rng = np.random.default_rng(3)  # the JAX demo's draws, in its order
    color = js.color * 0.5 + rng.uniform(0, 0.5, js.color.shape).astype("float32")
    position = js.position + rng.uniform(-0.1, 0.1, js.position.shape).astype("float32")
    scale = js.scale * rng.uniform(0.85, 1.15, (js.capacity, 1)).astype("float32")
    for name, want in (("color", color), ("position", position), ("scale", scale)):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(want), name)


def test_cli_train_two_steps_then_resume(tmp_path, caplog):
    args = ["train", "materials", "--steps", "2", "--width", "16", "--height", "12",
            "--spp", "1", "--pallas", "--device", CPU, "--ckpt-dir", str(tmp_path / "ck"),
            "--ckpt-every", "1", "--out-dir", str(tmp_path / "out"),
            "--train-fields", "color"]
    with caplog.at_level(logging.INFO, logger="raytracing_tests_tpu_torch"):
        cli.main(args)
    assert ckpt.latest_checkpoint(str(tmp_path / "ck")).endswith("ckpt_2.npz")
    for name in ("target.png", "final.png"):
        assert (tmp_path / "out" / name).stat().st_size > 0
    steps = [r.getMessage() for r in caplog.records if r.getMessage().startswith("step")]
    assert len(steps) == 2
    caplog.clear()
    with caplog.at_level(logging.INFO, logger="raytracing_tests_tpu_torch"):
        cli.main(args[:2] + ["--steps", "3"] + args[4:])
    msgs = [r.getMessage() for r in caplog.records]
    assert "resumed from step 2" in msgs
    steps = [m.split() for m in msgs if m.startswith("step")]
    assert len(steps) == 1 and steps[0][1] == "2"  # only the step after the checkpoint
    assert ckpt.latest_checkpoint(str(tmp_path / "ck")).endswith("ckpt_3.npz")
    # --mesh is taken now: two virtual CPU shards resume the same checkpoint
    caplog.clear()
    with caplog.at_level(logging.INFO, logger="raytracing_tests_tpu_torch"):
        cli.main(args[:2] + ["--steps", "4"] + args[4:] + ["--mesh", "2"])
    msgs = [r.getMessage() for r in caplog.records]
    assert "resumed from step 3" in msgs
    assert [m.split()[1] for m in msgs if m.startswith("step")] == ["3"]
