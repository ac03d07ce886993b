"""The port's ``core`` math against the JAX package on seeded random inputs.

Both sides evaluate the same float32 formulas op by op, so the tolerance is
rtol 1e-6 / atol 1e-6 (one ulp of cos/sin and of a three-term sum)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from raytracing_tests_tpu.core import geometry as jgeo
from raytracing_tests_tpu.core import linalg as jlin
from raytracing_tests_tpu.core import sampling as jsam
from raytracing_tests_tpu_torch.core import geometry as tgeo
from raytracing_tests_tpu_torch.core import linalg as tlin
from raytracing_tests_tpu_torch.core import sampling as tsam

torch.set_num_threads(2)

N = 257
TOL = dict(rtol=1e-6, atol=1e-6)


def _inputs():
    rng = np.random.default_rng(11)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    unit = lambda v: v / np.linalg.norm(v, axis=-1, keepdims=True)
    d = unit(f(N, 3))
    n = unit(f(N, 3))
    n = np.where((d * n).sum(-1, keepdims=True) > 0, -n, n).astype(np.float32)
    return dict(
        a=f(N, 3), b=f(N, 3), d=d, n=n,
        ang=rng.uniform(-3.0, 3.0, N).astype(np.float32),
        deg=rng.uniform(-180.0, 180.0, (N, 3)).astype(np.float32),
        eta=rng.uniform(0.5, 1.6, N).astype(np.float32),
        cosine=rng.uniform(0.0, 1.0, N).astype(np.float32),
        R=np.array(jlin.rotation_from_euler(
            jnp.asarray(rng.uniform(-90, 90, (N, 3)).astype(np.float32)))),
        o=(f(N, 3) * 2.0).astype(np.float32),
        scale=rng.uniform(0.3, 2.0, (N, 3)).astype(np.float32),
        otype=rng.integers(0, 3, N).astype(np.int32),
        tr=rng.uniform(0, 1, N).astype(np.float32),
        lo=(-rng.uniform(0.1, 2, (N, 3))).astype(np.float32),
        hi=rng.uniform(0.1, 2, (N, 3)).astype(np.float32),
        tl=rng.uniform(0.5, 50, N).astype(np.float32),
        sidx=rng.integers(0, 16, N).astype(np.float32),
        tan=rng.uniform(0.0, 1.2, N).astype(np.float32),
        zeros=np.zeros((4, 3), np.float32),
    )


X = _inputs()

# name -> (module pair, function name, argument names or literal values)
CASES = {
    "rotation_x": ("lin", "rotation_x", ["ang"]),
    "rotation_y": ("lin", "rotation_y", ["ang"]),
    "rotation_z": ("lin", "rotation_z", ["ang"]),
    "rotation_from_euler": ("lin", "rotation_from_euler", ["deg"]),
    "dot": ("lin", "dot", ["a", "b"]),
    "norm": ("lin", "norm", ["a"]),
    "normalize": ("lin", "normalize", ["a"]),
    "safe_normalize": ("lin", "safe_normalize", ["a"]),
    "safe_normalize_zero": ("lin", "safe_normalize", ["zeros"]),
    "cross": ("lin", "cross", ["a", "b"]),
    "reflect": ("lin", "reflect", ["d", "n"]),
    "refract": ("lin", "refract", ["d", "n", "eta"]),
    "schlick": ("lin", "schlick", ["cosine", "eta"]),
    "apply_rotation": ("lin", "apply_rotation", ["R", "a"]),
    "apply_rotation_t": ("lin", "apply_rotation_t", ["R", "a"]),
    "ray_ellipsoid_t": ("geo", "ray_ellipsoid_t", ["o", "d", "scale"]),
    "ray_cuboid_t": ("geo", "ray_cuboid_t", ["o", "d", "scale"]),
    "ray_primitive_t": ("geo", "ray_primitive_t", ["o", "d", "scale", "otype"]),
    "ellipsoid_normal": ("geo", "ellipsoid_normal", ["a", "scale"]),
    "cuboid_normal": ("geo", "cuboid_normal", ["a", "scale"]),
    "primitive_normal": ("geo", "primitive_normal", ["a", "scale", "otype"]),
    "ray_aabb_hit": ("geo", "ray_aabb_hit", ["lo", "hi", "o", "d", "tl"]),
    "point_in_unit_primitive": ("geo", "point_in_unit_primitive", ["a", "otype"]),
    "transform_ray_to_local": ("geo", "transform_ray_to_local",
                               ["o", "d", "a", "R", "b", "tr"]),
    "object_aabb": ("geo", "object_aabb", ["a", "b", "R", "scale"]),
    "sunflower_disc": ("sam", "sunflower_disc", ["sidx", 16, 0.1]),
    "sunflower_disc_tiny_n": ("sam", "sunflower_disc", ["sidx", 2, 0.3]),
    "sunflower_unit_disc": ("sam", "sunflower_unit_disc", ["sidx", 16]),
    "deviate_within_cone": ("sam", "deviate_within_cone", ["d", "sidx", 16, "tan"]),
    "fibonacci_hemisphere": ("sam", "fibonacci_hemisphere", ["sidx", 16, 0.7, "d"]),
}
MODS = {"lin": (jlin, tlin), "geo": (jgeo, tgeo), "sam": (jsam, tsam)}


def _leaves(out):
    return list(out) if isinstance(out, (tuple, list)) else [out]


@pytest.mark.parametrize("name", list(CASES))
def test_core_function_matches_jax(name):
    mod, fn, args = CASES[name]
    jmod, tmod = MODS[mod]
    jargs = [jnp.asarray(X[a]) if isinstance(a, str) else a for a in args]
    targs = [torch.from_numpy(X[a]) if isinstance(a, str) else a for a in args]
    jout = _leaves(getattr(jmod, fn)(*jargs))
    tout = _leaves(getattr(tmod, fn)(*targs))
    assert len(jout) == len(tout)
    for j, t in zip(jout, tout):
        j, t = np.asarray(j), t.numpy()
        assert j.shape == t.shape
        if j.dtype == bool:
            np.testing.assert_array_equal(j, t)
        else:
            np.testing.assert_allclose(t, j, **TOL)


@pytest.mark.parametrize("n", [1, 2, 4, 7, 16])
def test_supersample_grid_offsets_match(n):
    jc, jg = jsam.supersample_grid_offsets(n)
    tc, tg = tsam.supersample_grid_offsets(n)
    assert jg == tg
    np.testing.assert_array_equal(jc, tc)


def test_golden_angle_constant_matches():
    assert np.float32(tsam.GOLDEN_ANGLE) == np.float32(jsam.GOLDEN_ANGLE)


def test_normalize_maps_zero_vectors_to_zero():
    """The documented contract (dead lanes carry zero directions).  Not held
    against JAX here: XLA:CPU flushes the 1e-38 floor, a denormal, to zero and
    returns NaN for this input."""
    out = tlin.normalize(torch.zeros(4, 3))
    assert torch.equal(out, torch.zeros(4, 3))
