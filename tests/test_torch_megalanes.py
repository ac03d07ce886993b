"""The lane-aligned megakernel renderer against the JAX package and against
the port's own queue renderer.

On the CPU the port's ``render_megalanes(..., device="cpu")`` runs the plain
version of ``mega_step``; the JAX side runs its Pallas kernel in interpret
mode (``block=512``).  The frame is the JAX package's own test size:
``iow_final_scene(side=5)`` at 48x32x4 depth 5, ``chunk=2048`` (three chunks,
and one of 1536 lanes for the sorted schedule's prepass).

Tolerances:
  - against JAX ``render_megalanes``, both schedules: the reference's bar
    (<= 0.5 % of pixels beyond 2e-4) is not reachable across the two
    packages, because XLA fuses a*b+c where eager PyTorch rounds twice and
    the scene's 1000-radius ground sphere amplifies the last ulp (see
    ``test_torch_render``): held to >= 95 % of pixels inside the oracle bar
    (atol 2e-4 / rtol 1e-3) plus the envelope (image means within 5e-3, under
    3 % of pixels beyond 0.05); ``rays`` within 0.3 %; ``iterations`` within 1
    per chunk (a chunk ends when its deepest tree ends, and one flipped
    grazing child lengthens or shortens that tree by a node);
    ``rays_dropped`` equal (0).  Found, both schedules: 98.1 % of pixels
    inside the bar, means 4.7e-4 apart, 1.4 % of pixels beyond 0.05, rays
    14 025 against 14 003, iterations equal (25 natural, 28 sorted).
  - against the port's queue renderer through the sphere sweep (the same
    sweep; the shading is the same model in two transcriptions, the queue
    renderer's through ``core.linalg`` and the kernel's own order of
    operations, which round differently): the reference's bars exactly: image
    <= 0.5 % of pixels beyond 2e-4 and max < 0.6, depth <= 0.5 % beyond 1e-3,
    zero dropped.  Found: 0.13 % of pixels beyond 2e-4 (two pixels, 0.17 the
    furthest), rays 14 025 against 14 028, no depth pixel off.
  - ``queue_capacity=1``: dropped counts within 10 % of JAX's, or 3 (found 11
    against 10).
  - ``schedule="sorted"`` gives ``"natural"``'s image to atol 1e-6 and its ray
    count exactly: the same lanes in another order.
"""

import dataclasses

import numpy as np
import pytest
import torch

from raytracing_tests_tpu.ops.megalanes import render_megalanes as j_render_megalanes
from raytracing_tests_tpu.ops.render import RenderConfig as JRenderConfig
from raytracing_tests_tpu.scene import examples as jex
from raytracing_tests_tpu_torch.ops.megalanes import render_megalanes
from raytracing_tests_tpu_torch.ops.render import RenderConfig, render_stats
from raytracing_tests_tpu_torch.scene import examples as tex

torch.set_num_threads(2)

FRAME = dict(width=48, height=32, spp=4, max_bounces=5, intersector="pallas")
CHUNK = 2048
N_CHUNKS = {"natural": 3, "sorted": 4}  # the sorted schedule adds its prepass


@pytest.fixture(scope="module")
def scenes():
    js, jc = jex.iow_final_scene(side=5)
    ts, tc = tex.iow_final_scene(side=5)
    return dict(js=js, jc=jc, jcfg=JRenderConfig(**FRAME).for_scene(js),
                ts=ts, tc=tc, tcfg=RenderConfig(**FRAME).for_scene(ts))


@pytest.fixture(scope="module")
def port_frames(scenes):
    s = scenes
    return {sched: render_megalanes(s["ts"], s["tc"], s["tcfg"], chunk=CHUNK,
                                    schedule=sched, device="cpu")
            for sched in ("natural", "sorted")}


@pytest.mark.parametrize("schedule", ["natural", "sorted"])
def test_megalanes_matches_jax_megalanes(scenes, port_frames, schedule):
    s = scenes
    oj = j_render_megalanes(s["js"], s["jc"], s["jcfg"], chunk=CHUNK, block=512,
                            schedule=schedule)
    ot = port_frames[schedule]
    assert set(("image", "depth", "rays", "iterations", "rays_dropped")) <= set(ot)
    ij, it = np.asarray(oj["image"]), ot["image"].numpy()
    assert it.shape == (32, 48, 3) and np.isfinite(it).all()
    ok = np.isclose(it, ij, atol=2e-4, rtol=1e-3).all(axis=-1)
    assert ok.mean() >= 0.95, ok.mean()
    assert abs(float(it.mean()) - float(ij.mean())) < 5e-3
    assert (np.abs(it - ij).max(axis=-1) > 0.05).mean() < 0.03
    rj, rt = int(oj["rays"]), int(ot["rays"])
    assert abs(rj - rt) / rj < 3e-3, (rj, rt)
    assert abs(int(oj["iterations"]) - ot["iterations"]) <= N_CHUNKS[schedule], (
        int(oj["iterations"]), ot["iterations"])
    assert int(ot["rays_dropped"]) == int(oj["rays_dropped"]) == 0
    dd = np.abs(ot["depth"].numpy() - np.asarray(oj["depth"]))
    assert (dd > 1e-2).mean() < 0.01


@pytest.mark.parametrize("schedule", ["natural", "sorted"])
def test_megalanes_matches_the_ports_queue_renderer(scenes, port_frames, schedule):
    s = scenes
    oq = render_stats(s["ts"], s["tc"], s["tcfg"], device="cpu")
    om = port_frames[schedule]
    iq, im = oq["image"].numpy(), om["image"].numpy()
    bad = np.abs(iq - im).max(axis=-1) > 2e-4
    assert bad.mean() <= 0.005, (bad.sum(), np.abs(iq - im).max())
    assert np.abs(iq - im).max() < 0.6
    ddiff = np.abs(oq["depth"].numpy() - om["depth"].numpy())
    assert (ddiff > 1e-3).mean() <= 0.005, (ddiff > 1e-3).sum()
    assert int(om["rays_dropped"]) == 0 and oq["rays_dropped"] == 0
    assert abs(int(om["rays"]) - oq["rays"]) / oq["rays"] < 3e-3


def test_sorted_schedule_renders_the_natural_image(port_frames):
    nat, srt = port_frames["natural"], port_frames["sorted"]
    np.testing.assert_allclose(srt["image"].numpy(), nat["image"].numpy(), atol=1e-6, rtol=0)
    assert torch.equal(srt["depth"], nat["depth"])
    assert int(srt["rays"]) == int(nat["rays"])
    # the prepass is counted, and sorting lets chunks end early
    assert srt["iterations"] != nat["iterations"]
    assert nat["iterations"] <= 3 * 11 and srt["iterations"] <= 4 * 11  # pops = 2 * 5 + 1


def test_a_full_stack_drops_and_counts(scenes):
    """``queue_capacity=1``: a second waiting refraction child is dropped and
    counted, at JAX's rate; the picture stays finite."""
    s = scenes
    jcfg = dataclasses.replace(s["jcfg"], queue_capacity=1)
    tcfg = dataclasses.replace(s["tcfg"], queue_capacity=1)
    oj = j_render_megalanes(s["js"], s["jc"], jcfg, chunk=CHUNK, block=512, schedule="natural")
    ot = render_megalanes(s["ts"], s["tc"], tcfg, chunk=CHUNK, schedule="natural", device="cpu")
    dj, dt = int(oj["rays_dropped"]), int(ot["rays_dropped"])
    assert dj > 0 and dt > 0
    assert abs(dt - dj) <= max(3, 0.1 * dj), (dt, dj)
    assert torch.isfinite(ot["image"]).all()
    assert abs(int(ot["rays"]) - int(oj["rays"])) / int(oj["rays"]) < 5e-3


def test_ragged_last_chunk_and_the_pops_budget(scenes, port_frames):
    """A chunk size that does not divide the frame pads the last chunk with
    inactive lanes and changes nothing; ``max_pops`` ends every tree."""
    s = scenes
    ragged = render_megalanes(s["ts"], s["tc"], s["tcfg"], chunk=2500, schedule="natural",
                              device="cpu")
    nat = port_frames["natural"]
    assert torch.equal(ragged["image"], nat["image"]) and int(ragged["rays"]) == int(nat["rays"])
    cfg = dataclasses.replace(s["tcfg"], max_pops=2)
    out = render_megalanes(s["ts"], s["tc"], cfg, chunk=CHUNK, schedule="natural", device="cpu")
    B = cfg.width * cfg.height * cfg.spp
    assert out["iterations"] == 2 * 3 and B < int(out["rays"]) <= 2 * B


@pytest.mark.parametrize("what", ["lights", "materials", "generic", "textures", "schedule"])
def test_megalanes_refuses_what_the_path_does_not_render(scenes, what):
    scene, cam, cfg, kw = scenes["ts"], scenes["tc"], scenes["tcfg"], {}
    err = NotImplementedError
    if what == "lights":
        kw["lights"] = object()
    elif what == "materials":
        cfg = dataclasses.replace(cfg, shading="materials")
    elif what == "generic":
        scene, cam = tex.groups_scene()
        cfg, err = RenderConfig(**FRAME).for_scene(scene), ValueError
    elif what == "textures":
        scene = scene.replace(textures=torch.zeros(1, 2, 12, 3))
    else:
        kw["schedule"], err = "random", ValueError
    with pytest.raises(err):
        render_megalanes(scene, cam, cfg, device="cpu", **kw)
