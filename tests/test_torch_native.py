"""The port's native host runtime (``native/``, its own copy of
``rt_native.cpp``) against the JAX package's build of the same source.

Bars: the host-built LBVH equal in every array to the JAX package's native
build (the same code and flags) and to the port's ``build_lbvh`` (the node
arrays equal, the boxes within 1e-5, as ``tests/test_native.py`` holds the
JAX package's two builders); the traversal over the host-built tree equal to
the dense intersector in ``hit`` and ``obj``; the noise equal to the JAX
package's native output bit for bit, and the JAX package's two property
tests.  Skipped, as the JAX package's are, where there is no ``g++``.
"""

import numpy as np
import pytest
import torch

from raytracing_tests_tpu import native as j_native
from raytracing_tests_tpu.scene import examples as jex
from raytracing_tests_tpu_torch import convert, native
from raytracing_tests_tpu_torch.bvh import build_lbvh
from raytracing_tests_tpu_torch.bvh.host_build import build_lbvh_native
from raytracing_tests_tpu_torch.bvh.traverse import traverse_nearest
from raytracing_tests_tpu_torch.ops.intersect import intersect_brute
from raytracing_tests_tpu_torch.scene import examples as tex

torch.set_num_threads(2)

NODE_FIELDS = ("left", "right", "parent", "obj_id", "bb_min", "bb_max")


@pytest.fixture(scope="module", autouse=True)
def toolchain():
    if not native.available():
        pytest.skip("no native toolchain (g++)")


SCENES = {
    "bvh_grid6": lambda: jex.bvh_grid_scene(side=6)[0],  # padded capacity
    "materials": lambda: jex.materials_scene()[0],
    "iow4": lambda: jex.iow_final_scene(side=4)[0],
}


@pytest.mark.parametrize("name", list(SCENES))
def test_host_lbvh_matches_jax_native_and_the_device_builder(name):
    js = SCENES[name]()
    ts = convert.scene_from_numpy({f: np.asarray(getattr(js, f)) for f in convert.SCENE_FIELDS})
    host = build_lbvh_native(ts)
    lo, hi = (np.asarray(x) for x in js.world_aabbs())
    valid = np.asarray(js.valid)
    big = hi[valid].max(axis=0)
    lo, hi = (np.where(valid[:, None], x, big) for x in (lo, hi))
    want = j_native.build_lbvh_host(lo, hi)
    for f in NODE_FIELDS:
        got = getattr(host, f).numpy()
        assert got.dtype == want[f].dtype and np.array_equal(got, want[f]), f
    dev = build_lbvh(ts)
    for f in ("left", "right", "parent", "obj_id"):
        assert torch.equal(getattr(host, f), getattr(dev, f)), f
    for f in ("bb_min", "bb_max"):
        np.testing.assert_allclose(getattr(host, f).numpy(), getattr(dev, f).numpy(), atol=1e-5)


def test_host_lbvh_renders_identically():
    """Traversal over the host-built tree == the dense intersector."""
    scene, _ = tex.bvh_grid_scene(side=5)
    bvh = build_lbvh_native(scene)
    rng = np.random.default_rng(3)
    o = torch.from_numpy(rng.uniform(-8, 8, (256, 3)).astype(np.float32))
    d = rng.normal(size=(256, 3)).astype(np.float32)
    d = torch.from_numpy(d / np.linalg.norm(d, axis=-1, keepdims=True))
    ratio, t_lim = torch.zeros(256), torch.full((256,), 32000.0)
    hb = intersect_brute(scene, o, d, ratio, t_lim)
    ht = traverse_nearest(bvh, scene, o, d, ratio, t_lim)
    assert torch.equal(hb.hit, ht.hit) and hb.hit.any()
    assert torch.equal(hb.obj[hb.hit], ht.obj[hb.hit])


@pytest.mark.parametrize("kind", list(native.NOISE_KINDS))
def test_noise_equals_jax_native(kind):
    got = native.noise_texture_host(40, 56, scale=5.0, octaves=4, kind=kind)
    assert np.array_equal(got, j_native.noise_texture_host(40, 56, scale=5.0, octaves=4,
                                                           kind=kind))


def test_native_noise_properties():
    tex_ = native.noise_texture_host(64, 48, scale=6.0, octaves=4, kind="fbm")
    assert tex_.shape == (64, 48) and tex_.dtype == np.float32
    assert tex_.min() >= 0.0 and tex_.max() <= 1.0
    assert tex_.std() > 0.05  # actually textured, not flat
    np.testing.assert_array_equal(tex_, native.noise_texture_host(64, 48, scale=6.0, octaves=4,
                                                                 kind="fbm"))


def test_native_noise_kinds_differ():
    a = native.noise_texture_host(32, 32, kind="simplex")
    b = native.noise_texture_host(32, 32, kind="turbulence")
    assert not np.allclose(a, b)


def test_the_library_is_built_from_the_ports_source_into_its_build_dir():
    assert native.AVAILABLE and native._lib_path().exists()
    assert native._lib_path().parent == native.BUILD_DIR
    assert native.BUILD_DIR.name == "_build"
    with pytest.raises(ValueError):
        native.build_lbvh_host(np.zeros((1, 3)), np.zeros((1, 3)))
