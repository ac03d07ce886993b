"""``primary_rays`` of the port against the JAX package: the same float32
formulas evaluated op by op, held to atol 1e-6 + rtol 1e-6 (directions and
time are <= 1; origins reach 13, where one ulp is 9.5e-7)."""

import numpy as np
import pytest
import torch

from raytracing_tests_tpu.ops.camera_rays import primary_rays as j_primary_rays
from raytracing_tests_tpu.scene import examples as jex
from raytracing_tests_tpu.scene.types import Camera as JCamera
from raytracing_tests_tpu_torch.ops.camera_rays import primary_rays as t_primary_rays
from raytracing_tests_tpu_torch.scene import examples as tex
from raytracing_tests_tpu_torch.scene.types import Camera as TCamera

torch.set_num_threads(2)

CAMS = {
    "iow_final": lambda m: m.iow_final_scene(side=3)[1],
    "sphere": lambda m: m.sphere_scene()[1],
    "groups": lambda m: m.groups_scene()[1],
}


@pytest.mark.parametrize("name", list(CAMS))
@pytest.mark.parametrize("size", [(48, 32, 8), (17, 9, 3), (5, 4, 1)])
def test_primary_rays_match_jax(name, size):
    W, H, S = size
    jo, jd, jt = j_primary_rays(CAMS[name](jex), W, H, S)
    to, td, tt = t_primary_rays(CAMS[name](tex), W, H, S)
    assert tuple(to.shape) == (H, W, S, 3) == tuple(np.asarray(jo).shape)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=1e-6, atol=1e-6)


def test_pitch_yaw_camera_matches_jax():
    kw = dict(fov_y_deg=50.0, aperture=0.2, focus_dist=6.0)
    jc = JCamera.from_pitch_yaw((1.0, 2.0, 3.0), -12.0, 250.0, **kw)
    tc = TCamera.from_pitch_yaw((1.0, 2.0, 3.0), -12.0, 250.0, **kw)
    for j, t in zip(j_primary_rays(jc, 12, 8, 4), t_primary_rays(tc, 12, 8, 4)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("variant", ["aa_grid", "multi_focus", "orthographic"])
def test_unported_camera_variants_raise(variant):
    """The three camera variants, which the port once refused, against the
    JAX package at the module's tolerance (rtol 1e-6 + atol 1e-6)."""
    aa = variant == "aa_grid"
    kw = dict(fov_y_deg=50.0, aperture=0.2, focus_dist=3.5)
    if variant == "multi_focus":
        kw["focus_dist"] = (3.0, 5.0, 8.0)
    if variant == "orthographic":
        kw["ortho_height"] = 2.0
    jc = JCamera.make((0.0, 0.4, 0.8), (0.0, -0.1, -1.0), **kw)
    tc = TCamera.make((0.0, 0.4, 0.8), (0.0, -0.1, -1.0), **kw)
    for size in ((8, 4, 2), (17, 9, 5)):
        for j, t in zip(j_primary_rays(jc, *size, aa_grid=aa),
                        t_primary_rays(tc, *size, aa_grid=aa)):
            assert tuple(t.shape) == np.asarray(j).shape
            np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6, atol=1e-6)
