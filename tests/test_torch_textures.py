"""Cube-sphere texturing of the port against the JAX package: the UV mapping,
the bilinear atlas sampler, the procedural atlases, simplex noise, the
mercator <-> cubic reprojection, image loading and the kernel's atlas layout.

Tolerances:
  - ``cube_sphere_uv``: faces equal, u and v within 1e-6 (the same float32
    formulas; the projection is one division and a halving).  Positions on
    the cube's edges and corners (two or three equal components) take the
    face the scan order gives, in both packages.
  - ``sample_atlas``: within 1e-6 (the same gathers and f32 weights).
  - ``checker_atlas`` / ``gradient_atlas``: numpy in both, equal.
  - noise: ``snoise2``, ``fbm2`` and ``turbulence2`` within 1e-6 on seeded
    points; ``bake_noise`` and ``noise_atlas`` floor ``x + s`` at simplex
    cell edges, where an XLA and a torch rounding could flip a cell, so they
    are held by share: >= 99.9 % of texels within 1e-6 (found: all equal).
  - reprojection: nearest sampling picks texels by truncation, held by share
    (>= 99.5 % of texels equal; found: all); bilinear within 1e-4 everywhere
    (found about 5e-6: ``acos`` / ``atan2`` of the two libraries differ by an
    ulp).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from raytracing_tests_tpu.scene import noise as jnoise
from raytracing_tests_tpu.scene import projection as jproj
from raytracing_tests_tpu.scene import textures as jtex
from raytracing_tests_tpu_torch.kernels import texture as ktex
from raytracing_tests_tpu_torch.scene import noise as tnoise
from raytracing_tests_tpu_torch.scene import projection as tproj
from raytracing_tests_tpu_torch.scene import textures as ttex
from raytracing_tests_tpu_torch.utils import io as tio

torch.set_num_threads(2)


def _positions(kind, n=4096, seed=0):
    """Seeded unit-space positions: on the unit sphere, on the cube's edges
    and corners (two or three components of equal magnitude), or the zero
    vector (dead lanes)."""
    rng = np.random.default_rng(seed)
    if kind == "sphere":
        p = rng.normal(size=(n, 3))
        return (p / np.linalg.norm(p, axis=1, keepdims=True)).astype(np.float32)
    if kind == "edges":
        p = rng.uniform(-1.0, 1.0, size=(n, 3)).astype(np.float32)
        a, b = rng.integers(0, 3, n), rng.integers(1, 3, n)
        c = (a + b) % 3
        mag = np.abs(p[np.arange(n), a])
        p[np.arange(n), c] = np.where(rng.uniform(size=n) < 0.5, -mag, mag)
        corner = rng.uniform(size=n) < 0.25
        p[corner] = np.sign(p[corner]) * np.abs(p[corner, :1])
        return p
    return np.zeros((n, 3), np.float32)


@pytest.mark.parametrize("kind", ["sphere", "edges", "zero"])
def test_cube_sphere_uv_matches_jax(kind):
    p = _positions(kind)
    jf, ju, jv = jtex.cube_sphere_uv(jnp.asarray(p))
    tf, tu, tv = ttex.cube_sphere_uv(torch.from_numpy(p))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0, atol=1e-6)
    assert set(np.unique(tf.numpy())) <= set(range(6))


@pytest.mark.parametrize("kind", ["sphere", "edges"])
@pytest.mark.parametrize("shape", [(3, 8, 48), (2, 5, 18)])
def test_sample_atlas_matches_jax(kind, shape):
    T, H, W6 = shape
    rng = np.random.default_rng(1)
    atlas = rng.uniform(size=(T, H, W6, 3)).astype(np.float32)
    p = _positions(kind, seed=2)
    ti = rng.integers(0, T + 1, size=p.shape[0]).astype(np.int32)  # T: clamped
    jf, ju, jv = jtex.cube_sphere_uv(jnp.asarray(p))
    want = jtex.sample_atlas(jnp.asarray(atlas), jnp.asarray(ti), jf, ju, jv)
    tf, tu, tv = ttex.cube_sphere_uv(torch.from_numpy(p))
    got = ttex.sample_atlas(torch.from_numpy(atlas), torch.from_numpy(ti), tf, tu, tv)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)


@pytest.mark.parametrize("size", [8, 64])
def test_procedural_atlases_match_jax(size):
    np.testing.assert_array_equal(ttex.checker_atlas(size), jtex.checker_atlas(size))
    np.testing.assert_array_equal(ttex.checker_atlas(size, 4, (1, 0, 0), (0, 0, 1)),
                                  jtex.checker_atlas(size, 4, (1, 0, 0), (0, 0, 1)))
    np.testing.assert_array_equal(ttex.gradient_atlas(size), jtex.gradient_atlas(size))


@pytest.mark.parametrize("fn", ["snoise2", "fbm2", "turbulence2"])
def test_noise_functions_match_jax(fn):
    rng = np.random.default_rng(3)
    x = rng.uniform(-20.0, 20.0, 20000).astype(np.float32)
    y = rng.uniform(-20.0, 20.0, 20000).astype(np.float32)
    want = np.asarray(getattr(jnoise, fn)(jnp.asarray(x), jnp.asarray(y)))
    got = getattr(tnoise, fn)(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("kind", ["fbm", "turbulence", "simplex"])
@pytest.mark.parametrize("seed", [0, 3])
def test_noise_atlas_matches_jax_by_share(kind, seed):
    field_j = np.asarray(jnoise.bake_noise(16, 96, kind=kind, seed=seed))
    field_t = tnoise.bake_noise(16, 96, kind=kind, seed=seed).numpy()
    assert field_t.dtype == np.float32 and field_t.shape == (16, 96)
    assert (np.abs(field_t - field_j) <= 1e-6).mean() >= 0.999
    a_j = jnoise.noise_atlas(16, kind=kind, seed=seed)
    a_t = tnoise.noise_atlas(16, kind=kind, seed=seed)
    assert a_t.shape == a_j.shape == (16, 96, 3) and a_t.dtype == np.float32
    assert (np.abs(a_t - a_j).max(axis=-1) <= 1e-6).mean() >= 0.999


def test_gradient_map_matches_jax():
    f = np.linspace(-0.2, 1.2, 257, dtype=np.float32)
    cols = ((0.0, 0.1, 0.2), (0.5, 0.5, 0.5), (1.0, 0.9, 0.0))
    np.testing.assert_allclose(tnoise.gradient_map(torch.from_numpy(f), cols).numpy(),
                               np.asarray(jnoise.gradient_map(jnp.asarray(f), cols)),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("bilinear", [False, True])
@pytest.mark.parametrize("direction", ["mercator_to_cubic", "cubic_to_mercator"])
def test_reprojection_matches_jax(direction, bilinear):
    img = np.random.default_rng(4).uniform(size=(24, 72, 3)).astype(np.float32)
    want = np.asarray(getattr(jproj, direction)(img, bilinear=bilinear))
    got = getattr(tproj, direction)(img, bilinear=bilinear).numpy()
    assert got.shape == want.shape == img.shape
    d = np.abs(got - want).max(axis=-1)
    if bilinear:
        assert d.max() <= 1e-4, d.max()
    else:
        assert (d == 0).mean() >= 0.995, (d == 0).mean()


def test_load_image_reads_a_png(tmp_path):
    from PIL import Image

    px = np.zeros((5, 7, 3), np.uint8)
    px[0, 0] = (255, 0, 0)
    px[4, 6] = (0, 0, 255)
    path = str(tmp_path / "t.png")
    Image.fromarray(px).save(path)
    img = tio.load_image(path)
    assert img.shape == (5, 7, 3) and img.dtype == np.float32
    np.testing.assert_array_equal(img, px.astype(np.float32) / 255.0)
    from raytracing_tests_tpu.utils.io import load_image as j_load_image

    np.testing.assert_array_equal(img, j_load_image(path))
    cubic = tproj.load_image_texture(path, mapping="cubic")
    np.testing.assert_array_equal(cubic, img[::-1])  # row 0 = the image's bottom
    np.testing.assert_array_equal(cubic, jproj.load_image_texture(path, mapping="cubic"))


def test_pack_atlas_layout():
    rng = np.random.default_rng(5)
    atlas = torch.from_numpy(rng.uniform(size=(3, 4, 12, 3)).astype(np.float32))
    texels, meta = ktex.pack_atlas(atlas)
    assert meta == (3, 4, 12) and tuple(texels.shape) == (3, 4, 12, 4)
    assert texels.is_contiguous() and texels.dtype == torch.float32
    assert torch.equal(texels[..., :3], atlas) and not texels[..., 3].any()
    flat = texels.reshape(-1)  # texel (t, y, x) at ((t * H + y) * W6 + x) * 4
    t, y, x = 2, 3, 7
    assert torch.equal(flat[((t * 4 + y) * 12 + x) * 4:][:3], atlas[t, y, x])
    with pytest.raises(ValueError):
        ktex.pack_atlas(atlas[..., :2])


def test_texture_color_masks_untextured_winners():
    rng = np.random.default_rng(6)
    texels, _ = ktex.pack_atlas(torch.from_numpy(rng.uniform(size=(3, 4, 12, 3)).astype(np.float32)))
    lp = torch.from_numpy(_positions("sphere", n=64, seed=7))
    color = torch.full((64, 3), 0.5)
    ti = torch.arange(64) % 3
    got = ktex.texture_color(color, ti, lp, texels)
    face, u, v = ttex.cube_sphere_uv(lp)
    want = 0.5 * ttex.sample_atlas(texels[..., :3], ti, face, u, v)
    assert torch.equal(got[ti == 0], color[ti == 0])
    assert torch.equal(got[ti > 0], want[ti > 0])
