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
        "kernels.sweep", "kernels.sweep2", "ops.render", "kernels.mega",
        "kernels.uber", "utils.io", "models.registry", "models.workloads",
        "app.cli", "__main__", "convert",
    ):
        assert "raytracing_tests_tpu_torch." + mod in MODULES, mod


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


@pytest.mark.parametrize("entry", ["render_uber", "render_stats", "render", "cli"])
def test_entry_points_raise_without_cuda_and_do_not_fall_back(entry):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    scene, cam = examples.iow_final_scene(side=2)
    cfg = RenderConfig(width=8, height=4, spp=1, intersector="pallas").for_scene(scene)
    with pytest.raises(RuntimeError, match="CUDA"):
        if entry == "render_uber":
            render_uber(scene, cam, cfg)
        elif entry == "render_stats":
            render_stats(scene, cam, cfg)
        elif entry == "render":
            render(scene, cam, cfg)
        else:
            from raytracing_tests_tpu_torch.app.cli import main

            main(["render", "iow-final", "--uber", "--width", "8", "--height", "4",
                  "--spp", "1", "--out", "unused.png"])


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
