"""Every leaf of each ported example scene and camera equals the JAX one,
and ``convert`` round-trips.

All leaves are compared for exact equality except ``rotation``: its entries
are cos/sin of float32 radians, which each library evaluates with its own
polynomial (XLA's differs from the correctly rounded value on ~1 % of
arguments).  The port rounds the float64 result once, so it is held to one
float32 ulp of a value <= 1 (atol 6e-8)."""

import numpy as np
import pytest
import torch

from raytracing_tests_tpu.scene import examples as jex
from raytracing_tests_tpu_torch import convert
from raytracing_tests_tpu_torch.scene import examples as tex

torch.set_num_threads(2)

SCENES = {
    "sphere": ("sphere_scene", {}),
    "groups": ("groups_scene", {}),
    "bvh_grid": ("bvh_grid_scene", {}),
    "bvh_grid_side4": ("bvh_grid_scene", {"side": 4}),
    "iow_final": ("iow_final_scene", {}),
    "iow_final_side5": ("iow_final_scene", {"side": 5}),
}


def _jax_leaves(obj, names):
    return {n: np.asarray(getattr(obj, n)) for n in names}


@pytest.mark.parametrize("name", list(SCENES))
def test_scene_leaves_equal_jax(name):
    fn, kw = SCENES[name]
    js, jc = getattr(jex, fn)(**kw)
    ts, tc = getattr(tex, fn)(**kw)
    assert ts.textures is None and js.textures is None
    jl = _jax_leaves(js, convert.SCENE_FIELDS)
    tl = convert.scene_to_numpy(ts)
    for f in convert.SCENE_FIELDS:
        assert jl[f].dtype == tl[f].dtype and jl[f].shape == tl[f].shape, f
        if f == "rotation":
            np.testing.assert_allclose(tl[f], jl[f], rtol=0, atol=6e-8)
        else:
            np.testing.assert_array_equal(tl[f], jl[f], err_msg=f)
    jcl = _jax_leaves(jc, convert.CAMERA_FIELDS)
    tcl = convert.camera_to_numpy(tc)
    for f in convert.CAMERA_FIELDS:
        assert jcl[f].dtype == tcl[f].dtype and jcl[f].shape == tcl[f].shape, f
        np.testing.assert_array_equal(tcl[f], jcl[f], err_msg=f)


@pytest.mark.parametrize("name", ["groups", "iow_final_side5"])
def test_convert_round_trips(name):
    fn, kw = SCENES[name]
    js, jc = getattr(jex, fn)(**kw)
    scene = convert.scene_from_numpy(_jax_leaves(js, convert.SCENE_FIELDS))
    cam = convert.camera_from_numpy(_jax_leaves(jc, convert.CAMERA_FIELDS))
    back = convert.scene_to_numpy(scene)
    for f in convert.SCENE_FIELDS:
        np.testing.assert_array_equal(back[f], np.asarray(getattr(js, f)))
        assert back[f].dtype == np.asarray(getattr(js, f)).dtype
    cback = convert.camera_to_numpy(cam)
    for f in convert.CAMERA_FIELDS:
        np.testing.assert_array_equal(cback[f], np.asarray(getattr(jc, f)))
    assert scene.capacity == js.capacity and scene.device.type == "cpu"


def test_convert_refuses_missing_field_and_textures():
    """A missing field raises; textures cross both ways, bit for bit."""
    js, _ = jex.texturing_scene(tex_size=8)
    leaves = dict(_jax_leaves(js, convert.SCENE_FIELDS), textures=np.asarray(js.textures))
    scene = convert.scene_from_numpy(leaves)
    assert scene.textures.dtype == torch.float32
    np.testing.assert_array_equal(scene.textures.numpy(), np.asarray(js.textures))
    back = convert.scene_to_numpy(scene)
    np.testing.assert_array_equal(back["textures"], np.asarray(js.textures))
    assert "textures" not in convert.scene_to_numpy(convert.scene_from_numpy(
        _jax_leaves(jex.sphere_scene()[0], convert.SCENE_FIELDS)))
    del leaves["color"]
    with pytest.raises(KeyError):
        convert.scene_from_numpy(leaves)


def test_world_aabbs_match_jax():
    js, _ = jex.bvh_grid_scene(side=4)
    ts, _ = tex.bvh_grid_scene(side=4)
    for j, t in zip(js.world_aabbs(), ts.world_aabbs()):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6, atol=1e-6)
