"""The render path's caches: the probe cut, the accel with its camera vector,
and the packed atlas (``kernels/_cache.py``), keyed on tensor identity and
version.

A second ``render_uber`` (or ``render_uber_sharded``) of an unchanged scene
builds nothing and gives the same image bit for bit; any in-place write to a
scene or camera tensor, or to a returned table, makes the next call rebuild,
and the rebuilt tables equal a fresh build's exactly.  Builds are counted by
wrapping the build functions the entry point calls.  The cached probe mask equals the
JAX package's ``probe_relevant_rows`` on the same seeded scenes.
"""

import dataclasses

import numpy as np
import pytest
import torch

from raytracing_tests_tpu.kernels import sweep2 as jsw2
from raytracing_tests_tpu.scene import types as jtypes
from raytracing_tests_tpu_torch.kernels import sweep2 as tsw2
from raytracing_tests_tpu_torch.kernels import uber as tub
from raytracing_tests_tpu_torch.ops.render import RenderConfig
from raytracing_tests_tpu_torch.parallel import make_mesh, render_uber_sharded
from raytracing_tests_tpu_torch.scene import examples as tex
from raytracing_tests_tpu_torch.scene import types as ttypes

torch.set_num_threads(2)

SIZE = dict(width=8, height=6, spp=1, max_bounces=2)
TABLES = ("otab", "ftab", "gaabb", "perm")
CACHES = (tsw2._PROBE_CACHE, tub._ACCEL_CACHE, tub._ATLAS_CACHE)


def seeded_scene(ty, generic: bool, seed: int = 16):
    """24 objects in a 4 x 1 x 4 box over a ground sphere, every third one
    glass and some opaque ones of RI 1, from a seed; generic: rotated
    ellipsoids and boxes, else spheres.  Glass bodies touch others, so the
    probe cut keeps some dielectric rows and drops others."""
    rng = np.random.default_rng(seed)
    b = ty.SceneBuilder()
    for i in range(24):
        c = tuple(float(x) for x in rng.uniform((-2.0, -0.3, -6.0), (2.0, 0.7, -2.0)))
        if i % 3 == 0:
            kw = dict(color=(1.0, 1.0, 1.0), refractive_index=1.5, refractivity=0.9,
                      reflectivity=0.1)
        else:
            kw = dict(color=tuple(float(x) for x in rng.uniform(0.2, 0.9, 3)),
                      refractive_index=1.0 if i % 2 else 1.5, reflectivity=0.8,
                      scatter_reflect=0.3)
        if not generic:
            b.add_sphere(c, float(rng.uniform(0.3, 0.6)), **kw)
            continue
        rot = tuple(float(x) for x in rng.uniform(0.0, 90.0, 3))
        size = tuple(float(x) for x in rng.uniform(0.3, 0.7, 3))
        if i % 2:
            b.add_box(c, size, rotation_deg=rot, **kw)
        else:
            b.add(c, size, ty.ELLIPSOID, rotation_deg=rot, **kw)
    b.add_sphere((0.0, -100.6, -4.0), 100.0, color=(0.6, 0.65, 0.6), reflectivity=0.7,
                 scatter_reflect=0.9)
    cam = ty.Camera.make((0.0, 0.4, 0.8), (0.0, -0.1, -1.0), fov_y_deg=55.0, focus_dist=4.2)
    return b.build(), cam


def clone(struct):
    """The same values in new tensors: a scene or camera the caches never saw."""
    return dataclasses.replace(struct, **{
        f.name: getattr(struct, f.name).clone() for f in dataclasses.fields(struct)
        if isinstance(getattr(struct, f.name), torch.Tensor)})


@pytest.fixture
def counts(monkeypatch):
    """Empty caches, and a counter of each build function's calls from here on."""
    tub.clear_caches()
    n = {"accel": 0, "cut": 0, "atlas": 0}

    def counted(key, fn):
        def wrapper(*a, **k):
            n[key] += 1
            return fn(*a, **k)
        return wrapper

    monkeypatch.setattr(tub, "make_accel2", counted("accel", tub.make_accel2))
    monkeypatch.setattr(tub, "make_accel2g", counted("accel", tub.make_accel2g))
    monkeypatch.setattr(tsw2, "_probe_cut", counted("cut", tsw2._probe_cut))
    monkeypatch.setattr(tub, "pack_atlas", counted("atlas", tub.pack_atlas))
    yield n
    tub.clear_caches()


def setup(generic: bool):
    scene, cam = seeded_scene(ttypes, generic)
    cfg = RenderConfig(**SIZE).for_scene(scene)
    assert cfg.pallas_mode == ("generic" if generic else "spheres") and cfg.probe_rows > 0
    return scene, cam, cfg


def render(scene, cam, cfg):
    return tub.render_uber(scene, cam, cfg, device="cpu")


def accel_of(scene, cam, cfg):
    return tub._scene_accel(scene, cam, cfg, 32)


def assert_same_tables(got, want):
    (a, ca), (b, cb) = got, want
    for name in TABLES:
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    assert torch.equal(ca, cb)
    assert (a.gr, a.n_pgroups, a.has_motion, a.mode) == (b.gr, b.n_pgroups, b.has_motion, b.mode)


def _flat(accel_cam):
    accel, cvec = accel_cam
    return [getattr(accel, name) for name in TABLES] + [cvec]


def assert_same_frame(a, b):
    assert torch.equal(a["image"], b["image"]) and torch.equal(a["depth"], b["depth"])
    assert int(a["rays"]) == int(b["rays"]) and int(a["rays_dropped"]) == int(b["rays_dropped"])


@pytest.mark.parametrize("generic", [False, True], ids=["spheres", "generic"])
def test_a_repeated_render_builds_nothing(counts, generic):
    scene, cam, cfg = setup(generic)
    first = render(scene, cam, cfg)
    assert counts == {"accel": 1, "cut": 1, "atlas": 0}
    again = render(scene, cam, cfg)
    assert counts == {"accel": 1, "cut": 1, "atlas": 0}
    assert_same_frame(again, first)


@pytest.mark.parametrize("generic", [False, True], ids=["spheres", "generic"])
def test_the_cached_tables_equal_a_fresh_build(counts, generic):
    scene, cam, cfg = setup(generic)
    built = accel_of(scene, cam, cfg)
    hit = accel_of(scene, cam, cfg)
    assert hit[0] is built[0] and hit[1] is built[1] and counts["accel"] == 1
    tub.clear_caches()
    fresh = accel_of(scene, cam, cfg)
    assert fresh[0] is not built[0] and counts["accel"] == 2
    assert_same_tables(hit, fresh)


def _rot_y(deg):
    a = np.deg2rad(deg)
    return torch.tensor([[np.cos(a), 0.0, np.sin(a)], [0.0, 1.0, 0.0],
                         [-np.sin(a), 0.0, np.cos(a)]], dtype=torch.float32)


# One in-place write each: every tensor the probe cut reads, the colour (read
# by the accel alone) and the camera's position (the accel's sort origin and
# the camera vector).
EDITS = {
    "position": lambda s, c: s.position[3].add_(torch.tensor([0.05, 0.0, -0.05])),
    "rotation": lambda s, c: s.rotation[2].copy_(_rot_y(33.0) @ s.rotation[2]),
    "scale": lambda s, c: s.scale[0].mul_(1.3),
    "delta_position": lambda s, c: s.delta_position[4].fill_(0.0).add_(1e-7),
    "obj_type": lambda s, c: s.obj_type[1:3].copy_(s.obj_type[1:3].flip(0)),
    "valid": lambda s, c: s.valid.__setitem__(5, False),
    "refractive_index": lambda s, c: s.refractive_index[0].fill_(1.0),
    "refractivity": lambda s, c: s.refractivity[3].fill_(0.0),
    "texture_index": lambda s, c: s.texture_index[7].fill_(0),
    "color": lambda s, c: s.color[1].mul_(0.5),
    "camera_position": lambda s, c: c.position.add_(torch.tensor([0.3, 0.1, 0.0])),
}


# Writes that leave every table as it was, and still rebuild: a sphere table
# carries no rotation in an untextured scene, rows 1 and 2 are both spheres in
# the sphere scene, and row 7's texture index is 0 already.
NO_OP_EDITS = {("rotation", False), ("obj_type", False), ("texture_index", False),
               ("texture_index", True)}


@pytest.mark.parametrize("generic", [False, True], ids=["spheres", "generic"])
@pytest.mark.parametrize("edit", list(EDITS))
def test_each_in_place_edit_rebuilds(counts, edit, generic):
    """After the write the next call rebuilds (the probe cut too, where it
    reads the tensor) and gives what a fresh build of the edited values
    gives: the same tables and the same frame."""
    scene, cam, cfg = setup(generic)
    render(scene, cam, cfg)
    before = [t.clone() for t in _flat(accel_of(scene, cam, cfg))]
    assert counts["accel"] == 1 and counts["cut"] == 1
    EDITS[edit](scene, cam)
    after = render(scene, cam, cfg)
    reads_cut = edit in ("position", "rotation", "scale", "delta_position", "obj_type", "valid",
                         "refractive_index", "refractivity", "texture_index")
    assert counts["accel"] == 2 and counts["cut"] == (2 if reads_cut else 1), counts
    rebuilt = accel_of(scene, cam, cfg)
    assert counts["accel"] == 2  # and hits again
    fresh_scene, fresh_cam = clone(scene), clone(cam)
    assert_same_tables(rebuilt, accel_of(fresh_scene, fresh_cam, cfg))
    assert counts["accel"] == 3
    assert_same_frame(after, render(fresh_scene, fresh_cam, cfg))
    moved = any(not torch.equal(a, b) for a, b in zip(_flat(rebuilt), before))
    assert moved == ((edit, generic) not in NO_OP_EDITS), (edit, generic, moved)


@pytest.mark.parametrize("table", TABLES + ("camera_vector",))
def test_a_write_into_a_returned_table_rebuilds(counts, table):
    scene, cam, cfg = setup(generic=True)
    accel, cvec = accel_of(scene, cam, cfg)
    want = {name: getattr(accel, name).clone() for name in TABLES}
    want_cvec = cvec.clone()
    written = cvec if table == "camera_vector" else getattr(accel, table)
    written.view(-1)[0] += 1
    got = accel_of(scene, cam, cfg)
    assert counts["accel"] == 2 and got[0] is not accel
    for name in TABLES:
        assert torch.equal(getattr(got[0], name), want[name]), name
    assert torch.equal(got[1], want_cvec)


def test_a_replaced_table_rebuilds(counts):
    """An accel field rebound to another tensor is not the cached one."""
    scene, cam, cfg = setup(generic=False)
    accel, _ = accel_of(scene, cam, cfg)
    accel.otab = accel.otab.clone()
    assert accel_of(scene, cam, cfg)[0] is not accel and counts["accel"] == 2


def test_replace_variants_coexist(counts):
    """``scene.replace(...)`` variants share ``position``; alternating two of
    them builds each once (the JAX package's round-5 case)."""
    a, cam, cfg = setup(generic=False)
    b = a.replace(refractivity=a.refractivity * 0.5)
    frames = [render(s, cam, cfg) for s in (a, b, a, b)]
    assert counts["accel"] == 2 and counts["cut"] == 2
    assert_same_frame(frames[2], frames[0])
    assert_same_frame(frames[3], frames[1])
    assert not torch.equal(frames[0]["image"], frames[1]["image"])


def test_the_fifo_keeps_eight(counts):
    scene, cam, cfg = setup(generic=False)
    scenes = [clone(scene) for _ in range(9)]
    for s in scenes:
        accel_of(s, cam, cfg)
    assert counts["accel"] == 9 and counts["cut"] == 9
    assert len(tub._ACCEL_CACHE) == 8 and len(tsw2._PROBE_CACHE) == 8
    accel_of(scenes[8], cam, cfg)  # the newest is there
    assert counts["accel"] == 9 and counts["cut"] == 9
    accel_of(scenes[0], cam, cfg)  # the ninth evicted the first
    assert counts["accel"] == 10 and counts["cut"] == 10
    assert len(tub._ACCEL_CACHE) == 8


def test_the_atlas_is_packed_once_and_again_after_an_edit(counts):
    scene, cam = tex.texturing_scene()
    cfg = RenderConfig(**SIZE).for_scene(scene)
    first = render(scene, cam, cfg)
    again = render(scene, cam, cfg)
    assert counts["atlas"] == 1 and counts["accel"] == 1
    assert_same_frame(again, first)
    scene.textures.mul_(0.5)
    edited = render(scene, cam, cfg)
    assert counts["atlas"] == 2
    assert not torch.equal(edited["image"], first["image"])
    assert_same_frame(edited, render(clone(scene), clone(cam), cfg))
    assert counts["atlas"] == 3


@pytest.mark.parametrize("name", ["glass_spheres", "texturing"])
def test_the_sharded_path_hits_after_render_uber(counts, name):
    if name == "texturing":
        scene, cam = tex.texturing_scene()
        cfg = RenderConfig(**SIZE).for_scene(scene)
    else:
        scene, cam, cfg = setup(generic=False)
    single = render(scene, cam, cfg)
    built = dict(counts)
    mesh = make_mesh(devices=["cpu"] * 2)
    sharded = render_uber_sharded(scene, cam, cfg, mesh)
    assert counts == built, (counts, built)
    render_uber_sharded(scene, cam, cfg, mesh)
    assert counts == built
    assert_same_frame(sharded, single)


@pytest.mark.parametrize("generic", [False, True], ids=["spheres", "generic"])
def test_the_cached_probe_mask_matches_jax(counts, generic):
    ts, _ = seeded_scene(ttypes, generic)
    js, _ = seeded_scene(jtypes, generic)
    first = tsw2.probe_relevant_rows(ts)
    first[:] = True  # a copy: the cached mask is not written
    got = tsw2.probe_relevant_rows(ts)
    assert counts["cut"] == 1
    want = jsw2.probe_relevant_rows(js)
    np.testing.assert_array_equal(got, np.asarray(want))
    dielectric = ts.valid.numpy() & (ts.refractive_index.numpy() != 1.0)
    assert 0 < got.sum() < dielectric.sum(), (got.sum(), dielectric.sum())


@pytest.fixture
def copying_to(monkeypatch):
    """``.to(device)`` of scenes and cameras makes new tensors, as it does
    for a scene built on the CPU and rendered on CUDA."""
    monkeypatch.setattr(ttypes._TensorStruct, "to", lambda self, device: clone(self))


@pytest.mark.parametrize("name", ["glass_spheres", "texturing"])
def test_a_copied_scene_is_built_afresh_and_not_cached(counts, copying_to, name):
    """A scene that ``render_uber`` had to copy to its device is built on
    every call and leaves nothing cached: its entry could never hit and would
    pin the copy on the device."""
    if name == "texturing":
        scene, cam = tex.texturing_scene()
        cfg = RenderConfig(**SIZE).for_scene(scene)
    else:
        scene, cam, cfg = setup(generic=False)
    before = {c: dict(c.counts) for c in CACHES}
    first = render(scene, cam, cfg)
    again = render(scene, cam, cfg)
    assert counts == {"accel": 2, "cut": 2 if cfg.probe_rows > 0 else 0,
                      "atlas": 2 if name == "texturing" else 0}
    assert all(len(c) == 0 for c in CACHES)
    for c in CACHES:
        assert c.counts["hit"] == before[c].get("hit", 0)
        assert c.counts["miss"] == before[c].get("miss", 0)
    assert tub._ACCEL_CACHE.counts["bypass"] == before[tub._ACCEL_CACHE].get("bypass", 0) + 2
    assert_same_frame(again, first)
    mesh = make_mesh(devices=["cpu"] * 2)
    render_uber_sharded(scene, cam, cfg, mesh)
    assert all(len(c) == 0 for c in CACHES)
    assert_same_frame(render_uber_sharded(scene, cam, cfg, mesh), first)


def test_the_counts_tell_hits_from_misses(counts):
    scene, cam, cfg = setup(generic=False)
    before = {c: dict(c.counts) for c in CACHES}
    for _ in range(3):
        render(scene, cam, cfg)
    for c in (tub._ACCEL_CACHE, tsw2._PROBE_CACHE):
        got = {k: c.counts[k] - before[c].get(k, 0) for k in ("hit", "miss", "bypass")}
        assert got == {"hit": 2, "miss": 1, "bypass": 0}, got
