"""The row-sharded mesh of the port (``parallel/``, the sharded gradient step,
``--mesh`` in the CLI, the dry run) against the port's own single-device
results and against the JAX package's ``parallel/``.

A mesh of virtual CPU shards (``make_mesh(devices=["cpu"] * n)``) stands in
for the JAX tests' 8-device host platform; on the CPU every kernel wrapper
runs its plain version, so a shard computes exactly what the single device
computes for its rows.

Tolerances:
  - ``row_permutation``: equal to the JAX package's, element for element.
  - ``render_sharded`` against the single-device queue renderer
    (``render_stats``): image atol 1e-5 and depth atol 1e-4 (the JAX
    package's bars, ``tests/test_parallel.py``) and equal ray counts.  Found:
    identical images, depths and counts.
  - ``render_uber_sharded`` against ``render_uber`` (the plain K1): image
    atol 2e-6 (``tests/test_parallel.py``), depth atol 1e-4, equal rays where
    the shard count divides the height.  Found: identical.
  - against JAX: the queue renderers by the oracle bar (>= 99.5 % of pixels
    within atol 2e-4 / rtol 1e-3, rays within 0.5 %); the persistent kernels
    by the kernel envelope of ``test_torch_uber`` (image means within 5e-3,
    under 3 % of pixels off by 0.05, under 1 % of depth pixels off by 1e-2,
    rays within 2 %, zero dropped).
  - gradients: against the unsharded port, the loss within rtol 1e-6 and every
    field within 1e-6 of its max |g| (the shards' sums add in another order);
    against ``jax.value_and_grad(render_loss)`` on JAX's 4-device mesh, the
    bars of ``test_torch_diff`` (rtol 1e-6, 5e-4 of max |g|).
  - the two-rank gloo run against one process: images bit for bit, the loss
    within rtol 1e-6 and gradients within 1e-6 of max |g|.
  - the host rehearsal of ``csrc/uber.cu`` with the row map: four shard
    launches reassemble the single launch bit for bit.
"""

import dataclasses
import importlib.util
import logging
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from raytracing_tests_tpu import diff as jdiff
from raytracing_tests_tpu.ops.render import RenderConfig as JRenderConfig
from raytracing_tests_tpu.parallel import make_mesh as j_make_mesh
from raytracing_tests_tpu.parallel import render_sharded_jit as j_render_sharded
from raytracing_tests_tpu.parallel import row_permutation as j_row_permutation
from raytracing_tests_tpu.parallel.render_sharded import render_uber_sharded as j_uber_sharded
from raytracing_tests_tpu.scene import examples as jex
from raytracing_tests_tpu_torch import convert, diff
from raytracing_tests_tpu_torch.app import checkpoint as ckpt
from raytracing_tests_tpu_torch.app import cli
from raytracing_tests_tpu_torch.dryrun import dryrun_multichip
from raytracing_tests_tpu_torch.kernels import uber as tub
from raytracing_tests_tpu_torch.kernels.uber import render_uber
from raytracing_tests_tpu_torch.ops.render import (
    RenderConfig, extract_lights, render, render_stats,
)
from raytracing_tests_tpu_torch.parallel import (
    make_mesh, render_sharded, render_uber_sharded, row_permutation,
)
from raytracing_tests_tpu_torch.parallel import multihost
from raytracing_tests_tpu_torch.scene import examples as tex

torch.set_num_threads(2)

CPU = "cpu"


def cpu_mesh(n):
    return make_mesh(devices=[CPU] * n)


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def port_of(js, jc):
    """The JAX scene and camera as the port's, leaf for leaf."""
    ts = convert.scene_from_numpy({f: np.asarray(getattr(js, f)) for f in convert.SCENE_FIELDS})
    tc = convert.camera_from_numpy(
        {f: np.asarray(getattr(jc, f)) for f in convert.CAMERA_FIELDS})
    return ts, tc


@pytest.mark.parametrize("height,n", [(13, 4), (450, 3), (450, 4), (20, 8)])
def test_row_permutation_matches_jax(height, n):
    got, want = row_permutation(height, n), j_row_permutation(height, n)
    for a, b in zip(got[:2], want[:2]):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert got[2] == want[2]
    perm, inverse, padded = got
    x = np.arange(padded)
    assert np.array_equal(x[perm][inverse], x)


@pytest.mark.parametrize("n", [1, 4, 8])
def test_render_sharded_matches_single_device(n):
    scene, cam = tex.materials_scene()
    cfg = RenderConfig(width=32, height=20, spp=4, max_bounces=4)
    ref = render_stats(scene, cam, cfg, device=CPU)
    out = render_sharded(scene, cam, cfg, cpu_mesh(n))
    np.testing.assert_allclose(_np(out["image"]), _np(ref["image"]), atol=1e-5)
    np.testing.assert_allclose(_np(out["depth"]), _np(ref["depth"]), atol=1e-4)
    assert out["rays"] == ref["rays"] and out["rays_dropped"] == ref["rays_dropped"] == 0


def test_render_sharded_height_not_divisible():
    scene, cam = tex.groups_scene()
    cfg = RenderConfig(width=16, height=13, spp=2, max_bounces=3)  # 13 % 8 != 0
    ref = render_stats(scene, cam, cfg, device=CPU)
    out = render_sharded(scene, cam, cfg, cpu_mesh(8))
    np.testing.assert_allclose(_np(out["image"]), _np(ref["image"]), atol=1e-5)
    assert out["rays"] == ref["rays"]  # only real rows are traced


def test_render_sharded_with_lights():
    scene, cam = tex.lights_scene()
    lights = extract_lights(scene)
    cfg = RenderConfig(width=16, height=12, spp=2, max_bounces=3)
    ref = render_stats(scene, cam, cfg, lights, device=CPU)
    out = render_sharded(scene, cam, cfg, cpu_mesh(8), lights)
    np.testing.assert_allclose(_np(out["image"]), _np(ref["image"]), atol=1e-5)
    assert out["rays"] == ref["rays"]


def test_render_sharded_more_shards_than_rows():
    scene, cam = tex.sphere_scene()
    cfg = RenderConfig(width=8, height=3, spp=1, max_bounces=2)
    ref = render_stats(scene, cam, cfg, device=CPU)
    out = render_sharded(scene, cam, cfg, cpu_mesh(5))
    assert torch.equal(out["image"], ref["image"]) and out["rays"] == ref["rays"]


def _uber_pair(scene, cam, cfg, n, lights=None, gr=64):
    single = render_uber(scene, cam, cfg, lights, gr=gr, device=CPU)
    sharded = render_uber_sharded(scene, cam, cfg, cpu_mesh(n), lights, gr=gr)
    np.testing.assert_allclose(_np(sharded["image"]), _np(single["image"]), atol=2e-6)
    np.testing.assert_allclose(_np(sharded["depth"]), _np(single["depth"]), atol=1e-4)
    if cfg.height % n == 0:
        assert int(single["rays"]) == int(sharded["rays"])
    return single, sharded


def test_uber_sharded_matches_single_device():
    """The cases of ``tests/test_parallel.py``: the persistent kernel over 8
    shards == one device (the same in-kernel ray generation per frame row)."""
    scene, cam = tex.iow_final_scene(side=5)
    cfg = RenderConfig(width=48, height=32, spp=2, max_bounces=4,
                       intersector="pallas").for_scene(scene)
    _uber_pair(scene, cam, cfg, 8)


def test_uber_sharded_materials_shading():
    scene, cam = tex.materials_scene()
    cfg = RenderConfig(width=40, height=24, spp=2, max_bounces=4, shading="materials",
                       intersector="pallas").for_scene(scene)
    _, sharded = _uber_pair(scene, cam, cfg, 8, gr=16)
    assert int(sharded["rays_dropped"]) == 0


def test_uber_sharded_lights_and_textures():
    scene, cam = tex.lights_scene()
    cfg = RenderConfig(width=40, height=24, spp=2, max_bounces=4,
                       intersector="pallas").for_scene(scene)
    _uber_pair(scene, cam, cfg, 8, extract_lights(scene), gr=16)
    scene, cam = tex.texturing_scene(tex_size=8)
    cfg = RenderConfig(width=40, height=24, spp=2, max_bounces=3,
                       intersector="pallas").for_scene(scene)
    _uber_pair(scene, cam, cfg, 8, gr=16)


def test_uber_sharded_camera_features_match_single():
    """aa_grid, multi-focus and orthographic cameras take the same raygen
    switches sharded as on one device; the aa table and 1/H stay the
    frame's, not the shard's."""
    scene, cam = tex.iow_final_scene(side=4)
    base = RenderConfig(width=32, height=24, spp=4, max_bounces=4,
                        intersector="pallas").for_scene(scene)
    _uber_pair(scene, cam, dataclasses.replace(base, aa_grid=True), 4)
    cam_mf = tex.Camera.make(cam.position.numpy(), cam.direction.numpy(), fov_y_deg=30.0,
                             aperture=0.1, focus_dist=[6.0, 10.0, 14.0])
    _uber_pair(scene, cam_mf, base, 4)
    cam_o = tex.Camera.make((0.0, 1.0, 4.0), (0.0, -0.2, -1.0), ortho_height=6.0)
    _uber_pair(scene, cam_o, base, 4)


def test_uber_sharded_refuses_what_render_uber_refuses():
    scene, cam = tex.lights_scene()
    cfg = RenderConfig(width=8, height=4, spp=1, shading="materials",
                       intersector="pallas").for_scene(scene)
    with pytest.raises(ValueError, match="lights"):
        render_uber_sharded(scene, cam, cfg, cpu_mesh(2), extract_lights(scene))
    with pytest.raises(ValueError, match="shading"):
        render_uber_sharded(scene, cam, dataclasses.replace(cfg, shading="normals"),
                            cpu_mesh(2))


def test_render_sharded_matches_jax_sharded():
    """The port's 8 shards against the JAX package's 8-device mesh."""
    js, jc = jex.materials_scene()
    ts, tc = port_of(js, jc)
    size = dict(width=32, height=20, spp=4, max_bounces=4)
    oj = j_render_sharded(js, jc, JRenderConfig(**size).for_scene(js), j_make_mesh(8))
    ot = render_sharded(ts, tc, RenderConfig(**size).for_scene(ts), cpu_mesh(8))
    ij, it = np.asarray(oj["image"]), _np(ot["image"])
    assert it.shape == ij.shape == (20, 32, 3)
    assert np.isclose(it, ij, atol=2e-4, rtol=1e-3).all(axis=-1).mean() >= 0.995
    assert abs(ot["rays"] - int(oj["rays"])) <= 0.005 * int(oj["rays"])


def test_uber_sharded_matches_jax_uber_sharded():
    js, jc = jex.iow_final_scene(side=5)
    ts, tc = port_of(js, jc)
    size = dict(width=48, height=32, spp=2, max_bounces=4, intersector="pallas")
    oj = j_uber_sharded(js, jc, JRenderConfig(**size).for_scene(js), j_make_mesh(8),
                        L=256, R=4, gr=64)
    ot = render_uber_sharded(ts, tc, RenderConfig(**size).for_scene(ts), cpu_mesh(8), gr=64)
    ia, ib = _np(ot["image"]), np.asarray(oj["image"])
    assert ia.shape == ib.shape and np.isfinite(ia).all()
    assert abs(float(ia.mean()) - float(ib.mean())) < 5e-3
    assert (np.abs(ia - ib).max(axis=-1) > 0.05).mean() < 0.03
    assert (np.abs(_np(ot["depth"]) - np.asarray(oj["depth"])) > 1e-2).mean() < 0.01
    assert abs(int(ot["rays"]) - int(oj["rays"])) < 0.02 * int(oj["rays"])
    assert int(ot["rays_dropped"]) == int(oj["rays_dropped"]) == 0


GRAD_SIZE = dict(width=24, height=16, spp=2, max_bounces=3, intersector="pallas")


@pytest.fixture(scope="module")
def grad_case():
    """``materials_scene()`` with shifted colours, the fast gradient path (K2
    behind ``fastpath._winner``), the unperturbed render as the target."""
    js, jc = jex.materials_scene()
    ts, tc = port_of(js, jc)
    cfg = RenderConfig(**GRAD_SIZE).for_scene(ts)
    target = render(ts, tc, dataclasses.replace(cfg, intersector="brute"), device=CPU)["image"]
    jpert = js.replace(color=js.color * 0.6 + 0.2)
    tpert = port_of(jpert, jc)[0]
    p = diff.extract_params(tpert)
    single = diff.value_and_grad_loss(p, tpert, tc, cfg, target, device=CPU)
    return dict(js=js, jc=jc, jpert=jpert, tpert=tpert, tc=tc, cfg=cfg, target=target,
                p=p, single=single)


def _assert_grads(got, want, bar):
    moved = 0
    for name, g in want.items():
        w = _np(g)
        scale = float(np.abs(w).max())
        err = float(np.abs(_np(getattr(got, name)) - w).max())
        assert err <= bar * max(scale, 1e-30), (name, err, scale)
        moved += scale > 0.0
    assert moved >= 5


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_grads_match_single_device(grad_case, n):
    g = grad_case
    loss, grads = diff.value_and_grad_loss(g["p"], g["tpert"], g["tc"], g["cfg"], g["target"],
                                           mesh=cpu_mesh(n), device=CPU)
    np.testing.assert_allclose(float(loss), float(g["single"][0]), rtol=1e-6)
    _assert_grads(grads, g["single"][1], 1e-6)


def test_sharded_grads_match_jax_sharded(grad_case):
    g = grad_case
    jcfg = JRenderConfig(**GRAD_SIZE).for_scene(g["js"])
    vg = jax.jit(jax.value_and_grad(jdiff.render_loss), static_argnames=("cfg", "mesh"))
    jl, jg = vg(jdiff.extract_params(g["jpert"]), g["jpert"], g["jc"], jcfg,
                jnp.asarray(_np(g["target"])), j_make_mesh(4))
    loss, grads = diff.value_and_grad_loss(g["p"], g["tpert"], g["tc"], g["cfg"], g["target"],
                                           mesh=cpu_mesh(4), device=CPU)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-6)
    want = diff.SceneParams(**{n: torch.from_numpy(np.array(getattr(jg, n)))
                               for n in diff.FLOAT_FIELDS})
    _assert_grads(grads, want, 5e-4)


def test_sharded_train_step_refuses_bands(grad_case):
    """As the JAX package does: bands compose with one device only, and the
    probed depths (``auto_pops``) need bands."""
    g = grad_case
    with pytest.raises(AssertionError):
        jdiff.make_train_step(g["jpert"], g["jc"], JRenderConfig(**GRAD_SIZE), None,
                              mesh=j_make_mesh(2), grad_bands=2)
    with pytest.raises(ValueError, match="single-device"):
        diff.make_train_step(g["tpert"], g["tc"], g["cfg"], diff.adam(1e-2),
                             mesh=cpu_mesh(2), grad_bands=2, device=CPU)
    with pytest.raises(ValueError, match="grad_bands"):
        diff.make_train_step(g["tpert"], g["tc"], g["cfg"], diff.adam(1e-2),
                             mesh=cpu_mesh(2), auto_pops=True, device=CPU)


def test_sharded_train_step_descends(grad_case):
    g = grad_case
    opt = diff.adam(2e-2)
    step = diff.make_train_step(g["tpert"], g["tc"], g["cfg"], opt, mesh=cpu_mesh(3),
                                trainable=diff.params_mask(g["tpert"], "color"), device=CPU)
    st = diff.TrainState.create(g["tpert"], opt, device=CPU)
    losses = []
    for _ in range(3):
        st, loss = step(st, g["target"])
        losses.append(float(loss))
    assert losses[0] == pytest.approx(float(g["single"][0]), rel=1e-6)
    assert losses[2] < losses[1] < losses[0], losses


def test_shard_work_sums_to_the_single_device_rays():
    scene, cam = tex.iow_final_scene(side=4)
    cfg = RenderConfig(width=24, height=16, spp=2, max_bounces=4,
                       intersector="pallas").for_scene(scene)
    single = int(render_uber(scene, cam, cfg, device=CPU)["rays"])
    for n in (2, 4):
        rays = multihost.shard_iteration_counts(scene, cam, cfg, n, device=CPU)
        assert len(rays) == n and sum(rays) == single, (rays, single)
    report = multihost.load_imbalance_report(scene, cam, cfg, (1, 2, 4), device=CPU)
    assert [r["shards"] for r in report] == [1, 2, 4]
    assert report[0]["imbalance"] == report[0]["efficiency_bound"] == 1.0
    for r in report:
        assert 0.0 < r["efficiency_bound"] <= 1.0 <= r["imbalance"]
        assert r["efficiency_bound"] == pytest.approx(1.0 / r["imbalance"])
    rows = multihost.scaling_report(scene, cam, cfg, (1, 2), renderer="uber",
                                    devices=[CPU] * 2)
    assert [r["devices"] for r in rows] == [1, 2] and rows[0]["efficiency"] == 1.0
    assert all(r["rays_per_s"] > 0 for r in rows)


def test_initialize_multihost_is_a_no_op_in_one_process(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert multihost.initialize_multihost() == 0
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("uber", [False, True])
def test_cli_render_mesh_equals_unsharded(tmp_path, uber):
    base = ["render", "iow-final", "--width", "24", "--height", "13", "--spp", "2",
            "--bounces", "3", "--device", CPU] + (["--uber"] if uber else [])
    cli.main(base + ["--out", str(tmp_path / "one.png")])
    cli.main(base + ["--mesh", "2", "--out", str(tmp_path / "two.png")])
    from PIL import Image

    one = np.asarray(Image.open(tmp_path / "one.png"))
    two = np.asarray(Image.open(tmp_path / "two.png"))
    assert one.shape == (13, 24, 3) and np.array_equal(one, two)


def test_cli_train_mesh_equals_unsharded(tmp_path, caplog):
    args = ["train", "materials", "--steps", "2", "--width", "16", "--height", "12",
            "--spp", "1", "--pallas", "--device", CPU, "--ckpt-every", "2"]
    losses = {}
    for name, extra in (("one", []), ("two", ["--mesh", "2"])):
        caplog.clear()
        with caplog.at_level(logging.INFO, logger="raytracing_tests_tpu_torch"):
            cli.main(args + ["--ckpt-dir", str(tmp_path / name)] + extra)
        losses[name] = [float(r.getMessage().split()[-1]) for r in caplog.records
                        if r.getMessage().startswith("step")]
    assert len(losses["one"]) == 2
    np.testing.assert_allclose(losses["two"], losses["one"], rtol=1e-5)
    got = [np.load(ckpt.latest_checkpoint(str(tmp_path / n))) for n in ("one", "two")]
    assert sorted(got[0].files) == sorted(got[1].files)
    for k in got[0].files:
        np.testing.assert_allclose(got[1][k], got[0][k], atol=1e-5, err_msg=k)


def test_dryrun_on_four_cpu_shards():
    found = dryrun_multichip(4, devices=[CPU] * 4)
    assert np.isfinite(found["train_loss"])
    assert set(found) == {"train_loss", "iow_final", "materials", "lights"}


WORKER = r'''
"""One rank of the two-rank gloo run: render and differentiate on the
process group's mesh; rank 0 writes what it got."""
import sys

import numpy as np
import torch

torch.set_num_threads(1)

from raytracing_tests_tpu_torch import diff
from raytracing_tests_tpu_torch.kernels.uber import render_uber
from raytracing_tests_tpu_torch.ops.render import RenderConfig, render, render_stats
from raytracing_tests_tpu_torch.parallel import make_mesh, render_sharded, render_uber_sharded
from raytracing_tests_tpu_torch.parallel.multihost import initialize_multihost
from raytracing_tests_tpu_torch.scene import examples

UBER = RenderConfig(width=24, height=13, spp=2, max_bounces=3, intersector="pallas")
QUEUE = RenderConfig(width=16, height=13, spp=2, max_bounces=3)
GRAD = RenderConfig(width=16, height=12, spp=2, max_bounces=3, intersector="pallas")


def inputs():
    iow, iow_cam = examples.iow_final_scene(side=4)
    mat, mat_cam = examples.materials_scene()
    target = render(mat, mat_cam, GRAD, device="cpu")["image"]
    pert = mat.replace(color=mat.color * 0.6 + 0.2)
    return iow, iow_cam, mat, mat_cam, pert, target


def run(mesh):
    """image_uber, image_queue, rays_queue, loss, grads; one process without
    a mesh, else sharded."""
    iow, iow_cam, mat, mat_cam, pert, target = inputs()
    ucfg, gcfg = UBER.for_scene(iow), GRAD.for_scene(pert)
    p = diff.extract_params(pert)
    if mesh is None:
        u = render_uber(iow, iow_cam, ucfg, device="cpu")
        q = render_stats(mat, mat_cam, QUEUE, device="cpu")
        loss, g = diff.value_and_grad_loss(p, pert, mat_cam, gcfg, target, device="cpu")
    else:
        u = render_uber_sharded(iow, iow_cam, ucfg, mesh)
        q = render_sharded(mat, mat_cam, QUEUE, mesh)
        loss, g = diff.value_and_grad_loss(p, pert, mat_cam, gcfg, target, mesh=mesh)
    out = dict(image_uber=u["image"].numpy(), image_queue=q["image"].numpy(),
               rays_queue=np.int64(q["rays"]), loss=np.float32(loss))
    out.update({"grad_" + n: v.numpy() for n, v in g.items()})
    return out


if __name__ == "__main__":
    store, rank, out = sys.argv[1], int(sys.argv[2]), sys.argv[3]
    assert initialize_multihost("file://" + store, 2, rank, device="cpu") == rank
    try:
        mesh = make_mesh()
        assert mesh.distributed and mesh.shape == {"rows": 2} and mesh.rank == rank
        got = run(mesh)
        if rank == 0:
            np.savez(out, **got)
    finally:
        torch.distributed.destroy_process_group()
'''


def test_two_gloo_ranks_equal_one_process(tmp_path):
    """Two processes through a FileStore: the gathered images bit for bit the
    single process's, the all-reduced loss and gradients within 1e-6."""
    script = tmp_path / "rank.py"
    script.write_text(WORKER)
    out = tmp_path / "rank0.npz"
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    env.pop("WORLD_SIZE", None)
    procs = [subprocess.Popen([sys.executable, str(script), str(tmp_path / "store"), str(r),
                               str(out)], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in (0, 1)]
    try:
        logs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [0, 0], logs
    spec = importlib.util.spec_from_file_location("rank_worker", script)
    worker = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(worker)
    want = worker.run(None)
    got = np.load(out)
    assert np.array_equal(got["image_uber"], want["image_uber"])
    assert np.array_equal(got["image_queue"], want["image_queue"])
    assert int(got["rays_queue"]) == int(want["rays_queue"])
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]), rtol=1e-6)
    for k in want:
        if k.startswith("grad_"):
            scale = float(np.abs(want[k]).max())
            assert float(np.abs(got[k] - want[k]).max()) <= 1e-6 * max(scale, 1e-30), k


def test_row_map_rehearsed_on_the_host_reassembles_the_frame():
    """Where there is a g++, ``csrc/uber.cu`` compiled as host C++: four
    launches, each with its own row map and ``ceil(H / 4)`` rows of the
    frame's height, reassemble the single launch's (r, g, b, t) bit for bit
    (H = 14: the last two shards render one off-frame row each)."""
    from raytracing_tests_tpu_torch.kernels import _build

    if shutil.which("g++") is None:
        pytest.skip("no g++ to rehearse the kernel source with")
    scene, cam = tex.iow_final_scene(side=4)
    cfg = RenderConfig(width=12, height=14, spp=2, max_bounces=4,
                       intersector="pallas").for_scene(scene)
    accel, cvec = tub._scene_accel(scene, cam, cfg, 64)
    st = tub.UberStatics.from_cfg(cfg, 0, cam)
    n, H, W, S = 4, 14, 12, 2
    h = -(-H // n)
    st_shard = dataclasses.replace(st, rows=h)
    with _build.host_rehearsal():
        whole, stats = tub._launch_uber(accel, cvec, st)
        parts = [tub._launch_uber(accel, tub.pack_camera(cam, row_stride=float(n),
                                                         row0=float(d)), st_shard)
                 for d in range(n)]
    assert st_shard.B == h * W * S
    blocks = torch.stack([o.reshape(h, W, S, 4) for o, _ in parts])
    full = blocks.transpose(0, 1).reshape(h * n, W, S, 4)[:H]
    assert torch.equal(full.reshape(-1, 4), whole)
    assert sum(int(s[tub.ST_RAYS]) for _, s in parts) > int(stats[tub.ST_RAYS]) > 0
