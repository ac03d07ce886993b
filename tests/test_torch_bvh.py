"""The port's LBVH (``bvh/``) against the JAX package's.

Bars:
  - the build: ``left``, ``right``, ``parent`` and ``obj_id`` equal to the
    JAX package's ``build_lbvh`` (run eagerly) on the same float32 scene, and
    the boxes bit for bit too (min/max of the same values); the JAX package's
    structural invariants (``_tree_ok``) on every tree.
  - the traversal against the dense intersectors of both packages: ``hit``
    and ``obj`` equal, ``t`` within 1e-6 relative (found: 1.2e-7); against
    the JAX package's traversal walking the same tree
    (``convert.lbvh_from_numpy``), and the JAX walk over the port's tree:
    ``obj`` equal, and ``t`` within that package's own bar for its walk,
    1e-4 relative (``tests/test_bvh.py``: its ``while_loop`` body is
    compiled, and XLA fuses multiply-adds there: on other rays than its
    test's it misses its own bar against its dense sweep, by 1.2e-4 on the
    moving scene);
    the surrounding RI equal to the dense containment sum within 1e-6
    relative.
  - ``render(intersector="bvh")`` against the dense intersector: the JAX
    package's bars, image atol 1e-5 and depth atol 1e-4.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from raytracing_tests_tpu.bvh import build_lbvh as j_build_lbvh
from raytracing_tests_tpu.bvh import debug as j_debug
from raytracing_tests_tpu.bvh import traverse as j_traverse
from raytracing_tests_tpu.ops import intersect as j_intersect
from raytracing_tests_tpu.scene import examples as jex
from raytracing_tests_tpu.scene import types as jtypes
from raytracing_tests_tpu_torch import convert
from raytracing_tests_tpu_torch.bvh import LBVH, build_lbvh, debug, traverse
from raytracing_tests_tpu_torch.bvh import traverse_nearest, traverse_nearest_obj
from raytracing_tests_tpu_torch.diff.train import _diff_cfg
from raytracing_tests_tpu_torch.ops import intersect as isect
from raytracing_tests_tpu_torch.ops.render import RenderConfig, render, render_stats
from raytracing_tests_tpu_torch.scene import examples as tex
from test_torch_sweep2g import overlapping_glass_scene

torch.set_num_threads(2)

NODE_FIELDS = ("left", "right", "parent", "obj_id", "bb_min", "bb_max")


def port_scene(js):
    return convert.scene_from_numpy({f: np.asarray(getattr(js, f)) for f in convert.SCENE_FIELDS})


def _random_spheres(n_obj, capacity=None):
    rng = np.random.default_rng(0)
    b = jtypes.SceneBuilder()
    for _ in range(n_obj):
        b.add_sphere(tuple(rng.uniform(-5, 5, 3)), float(rng.uniform(0.1, 1.0)))
    return b.build(capacity=capacity)


def _equal_codes():
    """Twelve objects whose centroids share one Morton cell, of three sizes
    and in no sorted order: the tie-break by size and then by index decides
    the leaf order, and the Karras split falls back on positions."""
    b = jtypes.SceneBuilder()
    for k in range(12):
        b.add_sphere((1e-4 * ((5 * k) % 12), 0.0, 0.0), 0.1 + 0.01 * ((7 * k) % 3))
    b.add_box((4.0, 1.0, -2.0), (0.5, 0.5, 0.5))  # a second cell, so the extent is wide
    return b.build()


BUILD_CASES = {
    **{f"n{n}": (lambda n=n: _random_spheres(n, capacity=n)) for n in (2, 3, 7, 33)},
    "padded": lambda: _random_spheres(5),
    "bvh_grid6": lambda: jex.bvh_grid_scene(side=6)[0],
    "equal_codes": _equal_codes,
}


def _tree_ok(bvh: LBVH):
    """The JAX package's structural invariants (``tests/test_bvh.py``)."""
    n = bvh.n_leaves
    left, right = bvh.left.numpy(), bvh.right.numpy()
    parent, obj_id = bvh.parent.numpy(), bvh.obj_id.numpy()
    assert left.shape[0] == 2 * n - 1
    assert parent[0] == -1
    assert sorted(obj_id[n - 1:].tolist()) == list(range(n))
    for i in range(n - 1):
        assert parent[left[i]] == i and parent[right[i]] == i
    seen, stack = set(), [0]
    while stack:
        k = stack.pop()
        assert k not in seen
        seen.add(k)
        if left[k] >= 0:
            stack += [int(left[k]), int(right[k])]
    assert len(seen) == 2 * n - 1
    lo, hi = bvh.bb_min.numpy(), bvh.bb_max.numpy()
    for i in range(n - 1):
        for c in (left[i], right[i]):
            assert np.all(lo[i] <= lo[c] + 1e-5) and np.all(hi[i] >= hi[c] - 1e-5)


@pytest.mark.parametrize("case", list(BUILD_CASES))
def test_build_equals_jax_and_holds_the_invariants(case):
    js = BUILD_CASES[case]()
    jb = j_build_lbvh(js)
    tb = build_lbvh(port_scene(js))
    for f in NODE_FIELDS:
        got, want = getattr(tb, f).numpy(), np.asarray(getattr(jb, f))
        assert got.dtype == want.dtype and np.array_equal(got, want), f
    assert tb.n_leaves == jb.n_leaves and tb.n_internal == jb.n_internal
    _tree_ok(tb)


def test_equal_codes_case_has_equal_codes():
    """The tie-break case really ties: several leaves share a Morton code."""
    from raytracing_tests_tpu_torch.bvh.build import morton3d

    ts = port_scene(_equal_codes())
    lo, hi = ts.world_aabbs()
    c = (lo + hi) * 0.5
    s_lo, s_hi = lo.amin(0), hi.amax(0)
    codes = morton3d((c - s_lo) / (s_hi - s_lo))
    assert len(set(codes[:12].tolist())) == 1


def test_clz_is_exact_around_powers_of_two():
    from raytracing_tests_tpu_torch.bvh.build import _clz32

    vals = [0, 1, 2, 3] + [v for k in range(2, 33) for v in ((1 << k) - 1, 1 << k, (1 << k) + 1)
                           if v < (1 << 32)]
    got = _clz32(torch.tensor(vals, dtype=torch.int64)).tolist()
    assert got == [32 - int(v).bit_length() for v in vals]


def _rays(rng, n, spread):
    """JAX ``test_bvh.py``'s ``_random_rays``: the same draws."""
    o = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


TRAVERSAL_CASES = {
    # (scene, rays, spread, moving, t_limit): JAX test_bvh.py's three cases,
    # on its rays (numpy default_rng(0), drawn in its order)
    "static": (lambda: jex.bvh_grid_scene(side=6)[0], 512, 8.0, False, 32000.0),
    "motion": (lambda: jex.motion_blur_scene()[0], 256, 4.0, True, 32000.0),
    "occlusion": (lambda: jex.bvh_grid_scene(side=5)[0], 256, 8.0, False, 10.0),
}


@pytest.mark.parametrize("case", list(TRAVERSAL_CASES))
def test_traversal_matches_brute_and_jax(case):
    scene_fn, n, spread, moving, t_lim = TRAVERSAL_CASES[case]
    js = scene_fn()
    ts = port_scene(js)
    tb = build_lbvh(ts)
    jb = j_build_lbvh(js)
    rng = np.random.default_rng(0)
    o, d = _rays(rng, n, spread)
    ratio = rng.uniform(0, 1, n).astype(np.float32) if moving else np.zeros(n, np.float32)
    lim = np.full(n, t_lim, np.float32)
    targs = [torch.from_numpy(x) for x in (o, d, ratio, lim)]
    jargs = [jnp.asarray(x) for x in (o, d, ratio, lim)]
    # the port's walk over the JAX package's tree, and the reverse
    jb_t = convert.lbvh_from_numpy({f: np.asarray(getattr(jb, f)) for f in NODE_FIELDS})
    tb_j = j_traverse.LBVH(**{f: jnp.asarray(v) for f, v in convert.lbvh_to_numpy(tb).items()})

    obj = traverse_nearest_obj(tb, ts, *targs).numpy()
    assert np.array_equal(obj, isect.occluded_nearest_obj(ts, *targs).numpy())
    assert np.array_equal(obj, np.asarray(j_traverse.traverse_nearest_obj(jb, js, *jargs)))
    assert np.array_equal(obj, traverse_nearest_obj(jb_t, ts, *targs).numpy())
    assert np.array_equal(obj, np.asarray(j_traverse.traverse_nearest_obj(tb_j, js, *jargs)))
    assert (obj >= 0).any() and (obj < 0).any()

    ht = traverse_nearest(tb, ts, *targs)
    hb = isect.intersect_brute(ts, *targs)
    m = ht.hit.numpy()
    for other, rtol in ((hb, 1e-6), (j_intersect.intersect_brute(js, *jargs), 1e-6),
                        (j_traverse.traverse_nearest(jb, js, *jargs), 1e-4)):
        assert np.array_equal(m, np.asarray(other.hit))
        assert np.array_equal(ht.obj.numpy()[m], np.asarray(other.obj)[m])
        np.testing.assert_allclose(ht.t.numpy()[m], np.asarray(other.t)[m], rtol=rtol)
    # the Hit contract: bounded t and obj 0 on a miss
    assert (ht.t.numpy()[~m] == 1.0).all() and (ht.obj.numpy()[~m] == 0).all()
    same = np.isclose(ht.normal.numpy()[m], hb.normal.numpy()[m], atol=1e-5).all(axis=-1)
    assert same.mean() > 0.99, same.mean()


def _glass_in_air(ty):
    """An RI-1.5 ellipsoid poking into an RI-1.3 box, both rotated, inside a
    box of air (RI 1), beside an opaque box (the builder's RI 1.5)."""
    b = ty.SceneBuilder()
    b.add((0.0, 0.0, -3.5), (0.7, 0.5, 0.6), ty.ELLIPSOID, rotation_deg=(10.0, 30.0, 0.0),
          refractive_index=1.5, refractivity=0.9, reflectivity=0.1)
    b.add_box((0.6, 0.1, -3.4), (0.8, 0.7, 0.7), rotation_deg=(0.0, 25.0, 10.0),
              refractive_index=1.3, refractivity=0.85, reflectivity=0.15)
    b.add_box((0.0, 0.0, -3.5), (3.0, 3.0, 3.0), refractive_index=1.0)
    b.add_box((-1.1, 0.0, -3.6), (0.4, 0.6, 0.4), rotation_deg=(0.0, 40.0, 0.0),
              reflectivity=0.9)
    return b.build()


def test_point_ri_walk_matches_the_dense_sum_and_jax():
    """``traverse_point_ri`` against the dense containment sum and the JAX
    package's walk: RI-1 containers are air, the RI is averaged where the
    glass bodies overlap."""
    js = _glass_in_air(jtypes)
    ts = port_scene(js)
    rng = np.random.default_rng(3)
    pts = (rng.uniform(-1.0, 1.0, (2048, 3)) * [1.6, 0.8, 0.8] + [0.0, 0.0, -3.5]).astype(
        np.float32)
    ratio = np.zeros(2048, np.float32)
    tp, tr = torch.from_numpy(pts), torch.from_numpy(ratio)
    got = traverse.traverse_point_ri(build_lbvh(ts), ts, tp, tr).numpy()
    dense = isect.surrounding_refractive_index(ts, tp, tr).numpy()
    jgot = np.asarray(j_traverse.traverse_point_ri(j_build_lbvh(js), js, jnp.asarray(pts),
                                                   jnp.asarray(ratio)))
    np.testing.assert_allclose(got, dense, rtol=1e-6)
    np.testing.assert_allclose(got, jgot, rtol=1e-6)
    for ri in (1.0, 1.3, 1.4, 1.5):  # air, each body alone, the overlap
        assert np.isclose(got, ri).any(), (ri, np.unique(np.round(got, 3)))


@pytest.mark.parametrize("scene", ["bvh_grid4", "overlapping_glass"])
def test_render_with_bvh_intersector_matches_brute(scene):
    """JAX ``test_bvh.py:125-136`` on the grid, and on overlapping glass,
    where the renderer's surrounding-RI probe walks the tree."""
    if scene == "bvh_grid4":
        ts, cam = tex.bvh_grid_scene(side=4)
    else:
        from raytracing_tests_tpu_torch.scene import types as ttypes

        ts, cam = overlapping_glass_scene(ttypes)
    cfg = RenderConfig(width=24, height=16, spp=2, max_bounces=3).for_scene(ts)
    rb = render(ts, cam, cfg, device="cpu")
    rt = render(ts, cam, dataclasses.replace(cfg, intersector="bvh"), device="cpu")
    np.testing.assert_allclose(rt["image"].numpy(), rb["image"].numpy(), atol=1e-5)
    np.testing.assert_allclose(rt["depth"].numpy(), rb["depth"].numpy(), atol=1e-4)
    assert cfg.has_dielectrics == (scene == "overlapping_glass")


def test_walk_stops_within_its_cap_and_checks_every_few_steps():
    """The walk's steps: at least what the deepest lane needed, fewer than
    that plus ``CHECK_EVERY``, never past ``3 * n_nodes + 2``; a finished
    lane is a fixed point, so more steps change nothing."""
    js = jex.bvh_grid_scene(side=6)[0]
    ts = port_scene(js)
    tb = build_lbvh(ts)
    o, d = (torch.from_numpy(x) for x in _rays(np.random.default_rng(1), 64, 8.0))
    z, lim = torch.zeros(64), torch.full((64,), 32000.0)
    got = []
    real = traverse._walk

    def logged(bvh, step, carry):
        out, steps = real(bvh, step, carry)
        got.append(steps)
        # one step more, from the finished state, changes nothing
        again = step(out)
        assert all(torch.equal(a, b) for a, b in zip(again, out))
        return out, steps

    traverse._walk = logged
    try:
        traverse_nearest_obj(tb, ts, o, d, z, lim)
    finally:
        traverse._walk = real
    cap = 3 * tb.left.shape[0] + 2
    assert len(got) == 1 and 0 < got[0] <= cap and got[0] % traverse.CHECK_EVERY == 0


def test_format_tree_and_stats_equal_jax():
    js = jex.bvh_grid_scene(side=3)[0]
    tb = build_lbvh(port_scene(js))
    jb = j_build_lbvh(js)
    assert debug.format_tree(tb) == j_debug.format_tree(jb)
    assert debug.format_tree(tb, max_depth=2) == j_debug.format_tree(jb, max_depth=2)
    assert debug.tree_stats(tb) == j_debug.tree_stats(jb)


def test_diff_cfg_routes_bvh_to_brute():
    cfg = RenderConfig(width=8, height=4, spp=1, intersector="bvh")
    assert _diff_cfg(cfg).intersector == "brute"
    assert not _diff_cfg(cfg).diff_mode
    with pytest.raises(ValueError):
        _diff_cfg(dataclasses.replace(cfg, soft_edges=0.03))


def test_lbvh_moves_between_devices_and_round_trips_numpy():
    tb = build_lbvh(tex.bvh_grid_scene(side=2)[0])
    assert tb.device.type == "cpu" and tb.to("cpu").left is not None
    back = convert.lbvh_from_numpy(convert.lbvh_to_numpy(tb))
    assert all(torch.equal(getattr(back, f), getattr(tb, f)) for f in NODE_FIELDS)


@pytest.mark.parametrize("what", ["bvh", "normals"])
def test_row_sharded_render_takes_the_lbvh_and_the_normals_view(what):
    """``parallel.render_sharded`` builds the LBVH once through
    ``_build_accel`` and moves it to each shard's device, and the normals
    view goes through ``trace_lanes`` and ``finalize``: bit for bit the
    single device's frame on virtual CPU shards."""
    from raytracing_tests_tpu_torch.parallel import make_mesh, render_sharded

    ts, cam = tex.bvh_grid_scene(side=3)
    cfg = RenderConfig(width=12, height=9, spp=2, max_bounces=3).for_scene(ts)
    cfg = dataclasses.replace(cfg, **({"intersector": "bvh"} if what == "bvh"
                                      else {"show_normals": True}))
    want = render(ts, cam, cfg, device="cpu")
    got = render_sharded(ts, cam, cfg, make_mesh(devices=["cpu"] * 2))
    assert torch.equal(got["image"], want["image"]) and torch.equal(got["depth"], want["depth"])


@pytest.mark.parametrize("scene", ["bvh_grid4", "iow_final3"])
def test_walk_renders_the_generic_sweeps_frame_bit_for_bit(scene):
    """The walk's leaf test sums its terms in the order of the generic
    sweeps' plain versions (``traverse._local``), so the bvh frame equals
    the first-generation sweeps' frame over the scene's generic table bit for
    bit (on the card, their -fmad=false build: ``chip_smoke.py``
    ``lbvh_frame`` and ``lbvh_ri_canary``); on the glass of the headline
    scene the RI walk runs too."""
    ts, cam = tex.bvh_grid_scene(side=4) if scene == "bvh_grid4" else tex.iow_final_scene(side=3)
    cfg = RenderConfig(width=24, height=16, spp=2, max_bounces=4, intersector="pallas")
    cfg = dataclasses.replace(cfg.for_scene(ts), pallas_mode="generic")
    swept = render_stats(ts, cam, cfg, device="cpu")
    walked = render_stats(ts, cam, dataclasses.replace(cfg, intersector="bvh"), device="cpu")
    assert torch.equal(walked["image"], swept["image"])
    assert torch.equal(walked["depth"], swept["depth"]) and walked["rays"] == swept["rays"]
    assert cfg.has_dielectrics == (scene == "iow_final3")
