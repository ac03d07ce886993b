"""The port imports nothing of JAX and never picks the CPU by itself."""

import pkgutil
import subprocess
import sys

import pytest
import torch

import raytracing_tests_tpu_torch
from raytracing_tests_tpu_torch.kernels.uber import render_uber
from raytracing_tests_tpu_torch.ops.render import RenderConfig, render, render_stats
from raytracing_tests_tpu_torch.scene import examples
from raytracing_tests_tpu_torch.utils.device import resolve_device

MODULES = sorted(
    m.name for m in pkgutil.walk_packages(
        raytracing_tests_tpu_torch.__path__, "raytracing_tests_tpu_torch."))


def test_the_fifteen_modules_exist():
    for mod in (
        "core.linalg", "core.geometry", "core.sampling", "scene.types",
        "scene.examples", "ops.camera_rays", "ops.intersect", "bvh.build",
        "kernels.sweep", "kernels.sweep2", "kernels.sweep2g", "ops.render", "kernels.mega",
        "kernels.uber", "utils.io", "models.registry", "models.workloads",
        "app.cli", "__main__", "convert", "ops.megalanes", "ops.workqueue",
        "scene.textures", "scene.noise", "scene.projection", "kernels.texture",
        "diff", "diff.fastpath", "diff.params", "diff.train", "app.checkpoint",
        "parallel", "parallel.mesh", "parallel.render_sharded", "parallel.multihost",
        "dryrun", "reference", "reference.cpu_renderer", "ops.tiles", "bvh.traverse",
        "bvh.debug", "bvh.host_build", "native", "ops.compute_basics", "ops.apt", "app.watch",
        "bench", "utils.logging", "utils.profiling", "utils.resilience", "utils.debug",
    ):
        assert "raytracing_tests_tpu_torch." + mod in MODULES, mod


def test_every_module_of_the_jax_package_has_a_counterpart():
    """A ``comm`` of the two trees' ``.py`` paths: each file of the JAX
    package has one at the same path in the port (the port may have more)."""
    import pathlib

    repo = pathlib.Path(raytracing_tests_tpu_torch.__file__).parent.parent
    paths = lambda pkg: {p.relative_to(repo / pkg).as_posix()  # noqa: E731
                         for p in (repo / pkg).rglob("*.py")}
    jax_paths = paths("raytracing_tests_tpu")
    assert len(jax_paths) > 50
    assert sorted(jax_paths - paths("raytracing_tests_tpu_torch")) == []


def test_importing_every_module_leaves_jax_out():
    code = (
        "import importlib, sys\n"
        f"mods = {MODULES!r}\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'raytracing_tests_tpu')]\n"
        "assert not bad, bad\n"
        "assert 'torch' in sys.modules\n"
        "print('imported', len(mods))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert f"imported {len(MODULES)}" in out.stdout


def test_kernels_package_reexports_the_sweep_entry_points_and_builds_nothing():
    """``kernels`` exports the first-generation sweeps as the JAX package's
    does, and importing it neither compiles nor loads a kernel (``_build``
    stays lazy): after torch is imported, any library load or child process
    raises."""
    code = (
        "import ctypes, subprocess, torch\n"
        "def refuse(*a, **k):\n"
        "    raise AssertionError('a kernel was built or loaded at import')\n"
        "ctypes.CDLL = subprocess.run = subprocess.Popen = refuse\n"
        "from raytracing_tests_tpu_torch.kernels import (\n"
        "    intersect_pallas, occluded_nearest_obj_pallas, surrounding_ri_pallas)\n"
        "from raytracing_tests_tpu_torch.kernels import _build, sweep\n"
        "assert intersect_pallas is sweep.intersect_pallas\n"
        "assert occluded_nearest_obj_pallas is sweep.occluded_nearest_obj_pallas\n"
        "assert surrounding_ri_pallas is sweep.surrounding_ri_pallas\n"
        "assert not _build._LIBS and not _build.LAUNCHES\n"
        "print('lazy')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "lazy"


def test_sources_do_not_mention_jax_imports():
    import pathlib

    root = pathlib.Path(raytracing_tests_tpu_torch.__file__).parent
    for path in root.rglob("*.py"):
        for line in path.read_text().splitlines():
            s = line.strip()
            assert not s.startswith(("import jax", "from jax", "import flax",
                                     "from flax", "import optax", "from optax",
                                     "from raytracing_tests_tpu ",
                                     "from raytracing_tests_tpu.",
                                     "import raytracing_tests_tpu ",
                                     "import raytracing_tests_tpu.")), (path, line)


def test_the_smoke_script_imports_nothing_of_jax():
    import pathlib

    text = (pathlib.Path(raytracing_tests_tpu_torch.__file__).parent.parent
            / "chip_smoke.py").read_text()
    for line in text.splitlines():
        s = line.strip()
        if s.startswith(("import ", "from ")):
            assert "jax" not in s and "raytracing_tests_tpu " not in s + " " \
                and "raytracing_tests_tpu." not in s, line


@pytest.mark.parametrize("script", ["chip_ab.py", "chip_edge.py", "chip_frames.py", "chip_k1.py",
                                    "chip_queue_ab.py"])
def test_the_other_chip_scripts_import_nothing_of_jax(script):
    """The measurement scripts beside the smoke script run on the card too."""
    import pathlib

    text = (pathlib.Path(raytracing_tests_tpu_torch.__file__).parent.parent / script).read_text()
    for line in text.splitlines():
        s = line.strip()
        if s.startswith(("import ", "from ")):
            assert "jax" not in s and "raytracing_tests_tpu " not in s + " " \
                and "raytracing_tests_tpu." not in s, line


@pytest.mark.parametrize("entry", ["render_uber", "render_stats", "render", "cli",
                                   "render_uber_generic", "render_stats_generic",
                                   "render_stats_generic_dense", "cli_bvh",
                                   "render_megalanes", "render_workqueue",
                                   "render_workqueue_generic", "render_uber_materials",
                                   "render_uber_generic_lights",
                                   "render_workqueue_generic_lights",
                                   "render_uber_textures", "render_stats_textures",
                                   "render_workqueue_textures", "cli_texturing",
                                   "render_loss", "banded_value_and_grad", "probe_band_pops",
                                   "train_step", "cli_train", "make_mesh", "cli_render_mesh",
                                   "cli_train_mesh", "initialize_multihost",
                                   "shard_iteration_counts", "dryrun", "render_progressive",
                                   "render_bvh"])
def test_entry_points_raise_without_cuda_and_do_not_fall_back(entry):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    from raytracing_tests_tpu_torch.ops.render import extract_lights

    generic = "generic" in entry
    lights = None
    if entry.endswith("lights"):
        scene, cam = examples.lights_scene()
        lights = extract_lights(scene)
    elif entry.endswith("materials"):
        scene, cam = examples.materials_scene()
    elif entry.endswith("textures"):
        scene, cam = examples.texturing_scene(tex_size=8)
    else:
        scene, cam = examples.bvh_grid_scene(side=2) if generic else examples.iow_final_scene(side=2)
    cfg = RenderConfig(width=8, height=4, spp=1, intersector="pallas",
                       shading="materials" if entry.endswith("materials") else "bvh",
                       pallas_groups=0 if entry.endswith("dense") else 32).for_scene(scene)
    assert cfg.pallas_mode == ("generic" if generic else "spheres")
    with pytest.raises(RuntimeError, match="CUDA"):
        if entry in ("render_loss", "banded_value_and_grad", "probe_band_pops", "train_step"):
            from raytracing_tests_tpu_torch import diff

            p, target = diff.extract_params(scene), torch.zeros(4, 8, 3)
            if entry == "render_loss":
                diff.render_loss(p, scene, cam, cfg, target)
            elif entry == "banded_value_and_grad":
                diff.banded_value_and_grad(scene, cam, cfg, grad_bands=2)(p, target)
            elif entry == "probe_band_pops":
                diff.probe_band_pops(scene, cam, cfg, 2)
            else:
                diff.make_train_step(scene, cam, cfg, diff.adam(1e-2))(
                    diff.TrainState.create(scene, diff.adam(1e-2), device="cpu"), target)
        elif entry == "cli_train":
            from raytracing_tests_tpu_torch.app.cli import main

            main(["train", "iow-final", "--pallas", "--steps", "1", "--width", "8",
                  "--height", "4", "--spp", "1"])
        elif entry == "make_mesh":
            from raytracing_tests_tpu_torch.parallel import make_mesh

            make_mesh(2)
        elif entry in ("cli_render_mesh", "cli_train_mesh"):
            from raytracing_tests_tpu_torch.app.cli import main

            cmd = ["render", "iow-final", "--out", "unused.png"] if entry == "cli_render_mesh" \
                else ["train", "iow-final", "--steps", "1"]
            main(cmd + ["--mesh", "2", "--width", "8", "--height", "4", "--spp", "1"])
        elif entry == "initialize_multihost":
            from raytracing_tests_tpu_torch.parallel.multihost import initialize_multihost

            initialize_multihost("localhost:1", 2, 0)
        elif entry == "shard_iteration_counts":
            from raytracing_tests_tpu_torch.parallel.multihost import shard_iteration_counts

            shard_iteration_counts(scene, cam, cfg, 2)
        elif entry == "dryrun":
            from raytracing_tests_tpu_torch.dryrun import dryrun_multichip

            dryrun_multichip(2)
        elif entry == "render_megalanes":
            from raytracing_tests_tpu_torch.ops.megalanes import render_megalanes

            render_megalanes(scene, cam, cfg)
        elif entry.startswith("render_workqueue"):
            from raytracing_tests_tpu_torch.ops.workqueue import render_workqueue

            render_workqueue(scene, cam, cfg, lights)
        elif entry.startswith("render_uber"):
            render_uber(scene, cam, cfg, lights)
        elif entry.startswith("render_stats"):
            render_stats(scene, cam, cfg)
        elif entry == "render":
            render(scene, cam, cfg)
        elif entry == "render_progressive":
            from raytracing_tests_tpu_torch.ops.tiles import render_progressive

            next(render_progressive(scene, cam, cfg))
        elif entry == "render_bvh":
            import dataclasses

            render(scene, cam, dataclasses.replace(cfg, intersector="bvh"))
        elif entry == "cli_texturing":
            from raytracing_tests_tpu_torch.app.cli import main

            main(["render", "texturing", "--uber", "--width", "8", "--height", "4",
                  "--spp", "1", "--out", "unused.png"])
        elif entry == "cli_bvh":
            from raytracing_tests_tpu_torch.app.cli import main

            main(["render", "bvh", "--uber", "--width", "8", "--height", "4",
                  "--spp", "1", "--out", "unused.png"])
        else:
            from raytracing_tests_tpu_torch.app.cli import main

            main(["render", "iow-final", "--uber", "--width", "8", "--height", "4",
                  "--spp", "1", "--out", "unused.png"])


def test_sweep_wrappers_refuse_a_tensor_they_cannot_launch_on():
    """A wrapper takes the plain version only for CPU tensors: anything else
    goes to the kernel's launch path, which raises where it cannot run (here a
    meta tensor stands in for a device this machine does not have)."""
    from raytracing_tests_tpu_torch.kernels import sweep, sweep2g

    scene, _ = examples.bvh_grid_scene(side=2)
    z3, z1 = torch.zeros(4, 3, device="meta"), torch.zeros(4, device="meta")
    acc = sweep.make_accel(scene, "generic", group=4)
    acc2g = sweep2g.make_accel2g(scene, gr=8, has_motion=False)
    with pytest.raises((ValueError, RuntimeError, NotImplementedError)):
        sweep.sweep_grouped(acc.table, acc.gaabb, z3, z3, z1, z1, 4, False, mode="generic")
    with pytest.raises((ValueError, RuntimeError, NotImplementedError)):
        sweep.sweep_ri(acc.table, "generic", z3, z1)
    with pytest.raises((ValueError, RuntimeError, NotImplementedError)):
        sweep2g.sweep2g_nearest(acc2g, z3, z3, z1, z1)
    with pytest.raises((ValueError, RuntimeError, NotImplementedError)):
        sweep2g.sweep2g_nearest_edge(acc2g, z3, z3, z1, z1)
    from raytracing_tests_tpu_torch.kernels import sweep2

    acc2 = sweep2.make_accel2(examples.iow_final_scene(side=2)[0], gr=8)
    with pytest.raises((ValueError, RuntimeError, NotImplementedError)):
        sweep2.sweep2_nearest_edge(acc2, z3, z3, z1, z1)


@pytest.mark.parametrize("kernel", ["nearest", "nearest_ri", "ri", "grouped", "sweep2g", "uber",
                                    "sweep2", "mega", "uber_tex", "sweep2_edge",
                                    "sweep2g_edge"])
def test_launch_functions_refuse_cpu_tensors_outside_the_host_rehearsal(kernel):
    """Well-formed CPU arguments must not reach a build or a launch: only the
    host rehearsal's context lets a ``_launch_*`` function take them."""
    from raytracing_tests_tpu_torch.kernels import sweep, sweep2g, uber

    generic = kernel not in ("nearest_ri", "sweep2", "mega", "uber_tex", "sweep2_edge")
    scene, cam = examples.bvh_grid_scene(side=2) if generic else examples.iow_final_scene(side=2)
    mode = "generic" if generic else "spheres"
    rays, pts = torch.zeros(8, 4), torch.zeros(4, 4)
    with pytest.raises(RuntimeError, match="CUDA tensors"):
        if kernel == "nearest":
            sweep._launch_nearest(sweep.make_accel(scene, mode, group=0).table, mode, rays)
        elif kernel == "nearest_ri":
            sweep._launch_nearest_ri(sweep.make_accel(scene, mode, group=0).table, rays)
        elif kernel == "ri":
            sweep._launch_ri(sweep.make_accel(scene, mode, group=0).table, mode, pts)
        elif kernel == "grouped":
            acc = sweep.make_accel(scene, mode, group=4)
            sweep._launch_grouped(acc.table, acc.gaabb, rays, 4, False, mode)
        elif kernel == "sweep2":
            from raytracing_tests_tpu_torch.kernels import sweep2

            sweep2._launch_sweep2(sweep2.make_accel2(scene, gr=8), rays, True, True)
        elif kernel == "mega":
            from raytracing_tests_tpu_torch.kernels import mega, sweep2

            mega._launch_mega(sweep2.make_accel2(scene, gr=8), torch.zeros(16, 4),
                              torch.zeros(4, dtype=torch.int32), has_dielectrics=True, spp=1,
                              max_bounces=3, t_max=1e4, bg=((1.0, 1.0, 1.0), (0.3, 0.4, 1.0)))
        elif kernel == "sweep2_edge":
            from raytracing_tests_tpu_torch.kernels import sweep2

            sweep2._launch_sweep2(sweep2.make_accel2(scene, gr=8), rays, False, False,
                                  with_edge=True)
        elif kernel == "sweep2g":
            sweep2g._launch_sweep2g(sweep2g.make_accel2g(scene, gr=8, has_motion=False), rays)
        elif kernel == "sweep2g_edge":
            sweep2g._launch_sweep2g(sweep2g.make_accel2g(scene, gr=8, has_motion=False), rays,
                                    with_edge=True)
        elif kernel == "uber_tex":
            from raytracing_tests_tpu_torch.kernels.texture import pack_atlas

            scene, cam = examples.texturing_scene(tex_size=8)
            cfg = RenderConfig(width=8, height=4, spp=1, intersector="pallas").for_scene(scene)
            accel, cvec = uber._scene_accel(scene, cam, cfg, 8)
            uber._launch_uber(accel, cvec, uber.UberStatics.from_cfg(cfg), None,
                              pack_atlas(scene.textures), uber.aa_table(8, 4, 1, "cpu"))
        else:
            cfg = RenderConfig(width=8, height=4, spp=1, intersector="pallas").for_scene(scene)
            accel, cvec = uber._scene_accel(scene, cam, cfg, 8)
            uber._launch_uber(accel, cvec, uber.UberStatics.from_cfg(cfg))


def test_make_mesh_takes_cuda_unless_given_devices():
    """``make_mesh()`` spans the CUDA devices (raising without them, and when
    asked for more than there are); only an explicit device list, which may
    repeat a device, makes virtual shards."""
    from raytracing_tests_tpu_torch.parallel import make_mesh

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            make_mesh()
    mesh = make_mesh(devices=["cpu"] * 3)
    assert mesh.shape == {"rows": 3} and not mesh.distributed
    assert [s for s, _ in mesh.local_shards()] == [0, 1, 2]
    assert make_mesh(2, devices=["cpu"] * 3).shape == {"rows": 2}
    with pytest.raises(ValueError):
        make_mesh(4, devices=["cpu"] * 3)


def test_cli_mesh_is_no_longer_refused(tmp_path, caplog):
    """``render --mesh`` and ``train --mesh`` run (over virtual CPU shards
    with ``--device cpu``); neither says "not ported"."""
    import logging

    from raytracing_tests_tpu_torch.app.cli import main

    main(["render", "sphere", "--width", "8", "--height", "5", "--spp", "1", "--mesh", "2",
          "--device", "cpu", "--out", str(tmp_path / "x.png")])
    assert (tmp_path / "x.png").stat().st_size > 0
    with caplog.at_level(logging.INFO, logger="raytracing_tests_tpu_torch"):
        main(["train", "sphere", "--steps", "1", "--width", "8", "--height", "4", "--spp", "1",
              "--mesh", "2", "--device", "cpu"])
    msgs = [r.getMessage() for r in caplog.records]
    assert any(m.startswith("step") for m in msgs)
    assert not any("not ported" in m for m in msgs)


@pytest.mark.parametrize("flag", ["normals", "bvh", "progressive"])
def test_cli_normals_bvh_and_progressive_write_their_pngs(tmp_path, flag):
    """``render --normals``, ``--bvh`` and ``--progressive --tiles-per-step
    2`` on the CPU: the progressive render writes ``<stem>_pNNN.png`` a step
    (130x70 in 64-pixel tiles: 3 x 2 tiles, 3 steps) and the final image."""
    from raytracing_tests_tpu_torch.app.cli import main

    out = tmp_path / "x.png"
    args = {"normals": ["sphere", "--normals", "--width", "16", "--height", "10"],
            "bvh": ["bvh", "--bvh", "--width", "12", "--height", "8", "--bounces", "2"],
            "progressive": ["sphere", "--progressive", "--tiles-per-step", "2",
                            "--width", "130", "--height", "70"]}[flag]
    main(["render", *args, "--spp", "1", "--device", "cpu", "--out", str(out)])
    assert out.stat().st_size > 0
    steps = sorted(p.name for p in tmp_path.glob("x_p*.png"))
    assert steps == (["x_p001.png", "x_p002.png", "x_p003.png"] if flag == "progressive" else [])


def test_the_persistent_kernel_refuses_the_normals_view():
    """``render_uber`` and ``render_uber_sharded`` have no normals view, as
    the JAX package's ``render_uber`` asserts."""
    from raytracing_tests_tpu_torch.parallel import make_mesh, render_uber_sharded

    scene, cam = examples.iow_final_scene(side=2)
    cfg = RenderConfig(width=8, height=4, spp=1, intersector="pallas",
                       show_normals=True).for_scene(scene)
    with pytest.raises(ValueError, match="normals"):
        render_uber(scene, cam, cfg, device="cpu")
    with pytest.raises(ValueError, match="normals"):
        render_uber_sharded(scene, cam, cfg, make_mesh(devices=["cpu"] * 2))


def test_resolve_device_names_the_cpu_only_when_asked():
    assert resolve_device("cpu").type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            resolve_device(None)
        with pytest.raises(RuntimeError):
            resolve_device("cuda")


def test_cli_list_and_cpu_render(tmp_path, capsys):
    from raytracing_tests_tpu_torch.app.cli import main

    main(["list"])
    assert "iow-final" in capsys.readouterr().out
    main(["info"])
    assert "torch" in capsys.readouterr().out
    out = tmp_path / "x.png"
    depth = tmp_path / "d.png"
    main(["render", "sphere", "--width", "16", "--height", "12", "--device", "cpu",
          "--out", str(out), "--depth-out", str(depth)])
    assert out.stat().st_size > 0 and depth.stat().st_size > 0


def test_image_io(tmp_path):
    import numpy as np

    from raytracing_tests_tpu_torch.utils import io

    img = torch.tensor([[[0.0, 0.5, 2.0]], [[-1.0, 1.0, 0.25]]])
    u8 = io.to_uint8(img)
    assert u8.dtype == np.uint8 and u8.tolist() == [[[0, 128, 255]], [[0, 255, 64]]]
    io.save_npy(str(tmp_path / "a.npy"), img)
    assert np.array_equal(np.load(tmp_path / "a.npy"), img.numpy())
    io.save_png(str(tmp_path / "a.png"), img)
    from PIL import Image

    back = np.asarray(Image.open(tmp_path / "a.png"))
    assert np.array_equal(back, u8[::-1])  # row 0 of a render is the bottom
