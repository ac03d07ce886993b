"""Progressive spiral tiles (``ops/tiles.py``) against the JAX package's.

Bars:
  - ``spiral_tile_order`` equal to the JAX package's;
  - the JAX package's two cases (``tests/test_tiles.py``): the final canvas
    within atol 1e-5 of ``render``'s image of the same frame, and
    ``done_fraction`` rising to 1.0;
  - the port's final canvas against the JAX package's ``render_progressive``
    canvas: the bar against the JAX queue renderer, >= 99.5 % of pixels
    within atol 2e-4 / rtol 1e-3.
"""

import numpy as np
import pytest
import torch

from raytracing_tests_tpu.ops.render import RenderConfig as JRenderConfig
from raytracing_tests_tpu.ops.tiles import render_progressive as j_render_progressive
from raytracing_tests_tpu.ops.tiles import spiral_tile_order as j_spiral_tile_order
from raytracing_tests_tpu.scene import examples as jex
from raytracing_tests_tpu_torch.ops.render import RenderConfig, render
from raytracing_tests_tpu_torch.ops.tiles import render_progressive, spiral_tile_order
from raytracing_tests_tpu_torch.scene import examples as tex

torch.set_num_threads(2)


@pytest.mark.parametrize("grid", [(5, 3), (13, 8), (1, 1)])
def test_spiral_order_equals_jax(grid):
    got = spiral_tile_order(*grid)
    assert got.dtype == np.int32 and np.array_equal(got, j_spiral_tile_order(*grid))
    assert len({tuple(t) for t in got.tolist()}) == grid[0] * grid[1]
    assert got[0].tolist() == [(grid[0] - 1) // 2, (grid[1] - 1) // 2]


# JAX tests/test_tiles.py's two cases: (scene, config, tile, tiles_per_step)
CASES = {
    "materials": ("materials_scene", dict(width=48, height=32, spp=2, max_bounces=3), (16, 16), 2),
    "tile_not_dividing": ("sphere_scene", dict(width=30, height=22, spp=1, max_bounces=2),
                          (16, 16), 4),
}


def _progressive(name):
    fn, kw, tile, k = CASES[name]
    scene, cam = getattr(tex, fn)()
    cfg = RenderConfig(**kw)
    steps = list(render_progressive(scene, cam, cfg, tile=tile, tiles_per_step=k, device="cpu"))
    return scene, cam, cfg, steps


@pytest.mark.parametrize("name", list(CASES))
def test_progressive_matches_full_render(name):
    scene, cam, cfg, steps = _progressive(name)
    fractions = [s["done_fraction"] for s in steps]
    assert fractions == sorted(fractions) and fractions[-1] == 1.0
    tw, th = CASES[name][2]
    n_tiles = -(-cfg.width // tw) * -(-cfg.height // th)
    assert len(steps) == -(-n_tiles // CASES[name][3])
    if len(steps) > 1:  # untraced tiles stay black; each step's canvas is its own copy
        assert (steps[0]["image"] == 0).all(dim=-1).any()
        assert not torch.equal(steps[0]["image"], steps[-1]["image"])
    ref = render(scene, cam, cfg, device="cpu")["image"]
    np.testing.assert_allclose(steps[-1]["image"].numpy(), ref.numpy(), atol=1e-5)


@pytest.mark.parametrize("name", list(CASES))
def test_progressive_matches_jax(name):
    fn, kw, tile, k = CASES[name]
    js, jc = getattr(jex, fn)()
    for out in j_render_progressive(js, jc, JRenderConfig(**kw), tile=tile, tiles_per_step=k):
        pass
    got = _progressive(name)[3][-1]["image"].numpy()
    close = np.isclose(got, out["image"], atol=2e-4, rtol=1e-3)
    assert close.mean() >= 0.995, close.mean()


def test_progressive_normals_view():
    """The tiles take the same per-sample square root in every mode, as the
    JAX package's do: the normals view's final canvas is that of the
    per-sample ``sqrt(max(n, 0))`` mean."""
    scene, cam = tex.sphere_scene()
    cfg = RenderConfig(width=20, height=12, spp=2, show_normals=True)
    for out in render_progressive(scene, cam, cfg, tile=(8, 8), device="cpu"):
        pass
    from raytracing_tests_tpu_torch.ops.render import render_samples

    colors, _ = render_samples(scene, cam, cfg, device="cpu")
    want = torch.mean(torch.sqrt(torch.clamp_min(colors, 0.0)), dim=2)
    np.testing.assert_allclose(out["image"].numpy(), want.numpy(), atol=1e-6)
