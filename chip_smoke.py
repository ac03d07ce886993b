"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

It builds the CUDA kernels from ``raytracing_tests_tpu_torch/csrc``, holds
each kernel against its plain PyTorch version on the card, and drives the
three slices of the port: the sphere slice (the parity canary, persistent
kernel vs queue renderer, and the headline frame, ``iow_final_scene()`` at
800x450x100 depth 8 through ``render_uber``), the generic slice (rotated
ellipsoids and cuboids: two canaries and ``bvh_grid_scene(side=32)`` at
800x450x16 depth 8), and the third slice: the headline frame through the
lane-aligned megakernel drain (``render_megalanes``, both schedules) and once
through the work queue (``render_workqueue``), and motion blur
(``motion_blur_scene()`` at 800x450x16 depth 8 through ``render_uber``, the
sphere sweep and the drain, and a moving generic scene); the schedules of
the sphere sweep and the megakernel (phase ``sweep_modes``); and the sixth
slice: materials shading and emissive lights through the persistent kernel
(the ``materials`` and ``lights`` frames, ``materials_scene()`` and
``lights_scene()`` at 800x450x16 depth 8, and a canary for each of the eight
new instantiations), the work queue with lights, and stacks of 16 and 32
records; and the later slices' paths, down to the fourteenth's: the numpy
oracle against the sweeps on the card, the normals view, progressive tiles
and the LBVH walk with its native host build.
It prints one JSON object per phase.  The last line is
``{"ok": true, "device": {...}}``.  Any failed phase raises, so the exit code
is non-zero and no result line is printed; without CUDA it fails at once.
The whole script takes about six minutes on one H100.

Phases and their bars:
  uber_modes. the persistent kernel's two sweep schedules (per lane and
     row-parallel, ``coop_min`` = 1 and 33, see ``FORCED``) and its default:
     bit-identical ``out`` and equal counters in the -fmad=false build on the
     sphere, generic, moving generic and motion canaries (before any other
     phase) and on the headline and generic frames; on two scenes of
     identical twins every schedule of both builds gives each hit the lower
     row's colour; each forced schedule of the default build meets the
     frame's bars of 4 and 9 against the plain version; SIMT efficiency
     (row tests / lane slots) per schedule; the kernel's time over
     ``COOP_SWEEP`` on both frames.
  3. sweep kernel vs plain, on three batches: 100 000 seeded rays on the
     persistent kernel's accel, and, on the queue renderer's own accel (the
     tables the canary's launches read), the canary's 179 200 camera lanes and
     as many second-generation rays (mirrored off or continued through the
     first hits, dead lanes where the camera ray missed).  The -fmad=false
     build (see 4) must agree on >= 99.9 % throughout.  Default build: same
     winner on >= 99.9 % of rays; where the winner agrees, the unrefined t
     (solved around the group anchor) within 2e-2 absolute, the refined t
     within rtol 1e-4 on >= 99 % (the 1000-radius ground sphere is
     ill-conditioned in float32 and the compiler fuses a*b+c where eager
     PyTorch rounds twice) and within 2e-2 everywhere; material fields within
     1e-5 and the surrounding RI equal on >= 99.9 %; normals, which carry the
     t difference times 1/radius (5 for most spheres), within 1e-3 on >= 99 %.
     SWEEP_BARS states, with the reason, where a batch's bars differ.
  4. persistent kernel vs plain, at 200x112x8 depth 6 and at the headline
     frame's own statics (800x450x100 depth 8, every one of its 36 000 000
     primaries).  The scene amplifies last-ulp differences (a 1000-radius
     ground sphere in float32, scatter off 0.2-radius spheres), and nvcc fuses
     a*b+c where eager PyTorch rounds twice.  So the same sources are also
     built with -fmad=false: THAT build must give per-sample colours within
     1e-4 and primary t within rtol 1e-4 on >= 99.9 % of samples and the same
     ray count within 0.05 % (the kernel's logic is the plain version's).  The
     default build, which the main path runs, is held statistically: primary t
     within rtol 1e-4 on >= 99.9 %, colours within 1e-4 on >= 85 % and within
     5e-2 on >= 97 % of samples, channel means within 5e-3, ray count within
     0.5 %, zero dropped; and at the headline, where 100 samples average out
     the flipped ones, per PIXEL of the finished image against the plain
     version's and against the -fmad=false build's: within PIXEL_ATOL (0.1)
     on >= 99.9 % of the pixels, within 1e-2 on >= 90 %, 5e-3 on average and
     nowhere further than 0.5.
  5. canary, persistent kernel vs queue renderer through the sweep kernel at
     200x112x8 depth 6: channel means within 5e-3, ray ratio within 2 %,
     depth disagreement under 1 %, zero dropped.
  6. the headline frame: no NaN, zero dropped, rays within 2 % of 91 994 750,
     image mean within 1e-2 of 1.0021 (both are properties of the scene).
  8. the sweeps over generic tables (``sweep2g``, ``sweep_grouped``,
     ``sweep_nearest``) vs plain on the generic frame's own tables and rays:
     all 5 760 000 camera lanes of the frame, as many second-generation rays
     (537 600 of them dead) and four edge cases (an axis-parallel ray whose
     origin lies on a slab plane of the ground box, one inside that slab, two
     dead rays).  -fmad=false build: the plain version's winner on >= 99.9 %
     of rays and t within rtol 1e-4 on >= 99.9 % of the agreeing hits.  Default
     build: NEAREST_BARS.  The three plain sweeps must name the same object on
     >= 99.9 % of rays.  ``sweep_ri`` (both modes), ``sweep_nearest_ri`` and
     the sphere-mode instantiations of ``sweep_nearest`` / ``sweep_grouped``
     are held the same way on the sphere canary's lanes and on two glass
     scenes where the refractive-index sums differ from 1.
  9. persistent kernel, generic instantiation, vs plain at the generic frame's
     statics (every one of its 5 760 000 primaries), per sample as in 4 and
     per pixel by the bars above ``compare_pixels_g``, from the frame's camera
     and from five more (``EXTRA_CAMERAS``); and on a scene of
     overlapping glass bodies, where the rotated containment probe runs.
 10. generic canaries at 200x112x8 depth 6, bars as in 5: persistent kernel
     vs queue renderer through ``sweep_grouped`` on the grid scene; through
     the dense ``sweep_nearest`` + ``sweep_ri`` on the glass scene
     (``pallas_groups=0``); ``sweep2g_nearest`` through its own entry point on
     the canary's lanes against ``sweep_grouped``'s winners; and the sphere
     scene through the first-generation sweeps (``pallas_v2=False``, dense and
     grouped) against the grouped sphere sweep.
 11. the generic frame: no NaN, zero dropped, rays within 2 % and image mean
     within 1e-2 of the plain version's (this run's, itself held to
     ``BVH1K_RAYS`` and ``BVH1K_MEAN``), exactly one launch of the generic
     instantiation per frame.
 12. every kernel's time at the frame's shapes beside its bound; the bounds
     count the live rows a kernel tested, not the dead and padding rows it
     skipped; and K3, K4 and K5 summed over the canaries that launch them,
     launch by launch (``driven_paths``), the first-generation paths
     (``pallas_v2=False``) every pop, K4's fused sweep dense and K5 with the
     fused RI, each with the row cost of its mode.
  k45_modes. K5 on every input it is held on above (the grid canary's lanes,
     bvh1k's camera lanes and their second pop, the edge cases, the sphere
     lanes with and without the RI pass, nested and deep glass, every pop of
     the first-generation grouped path) in coop_min 1, 33 and the default of
     the -fmad=false build: outputs bit for bit and equal counters, and t,
     obj and the refractive index bit for bit the plain version's; K4's fused
     sweep likewise at every split K (1, 2, 4, 8), also at the 5 760 000
     camera lanes of the sphere scene at 800x450x16; after the frames below,
     K4's dense sweep_nearest and sweep_ri likewise at every split, in both
     modes (the glass canary's lanes and second pop, bvh1k's camera lanes,
     second pop and edge cases, the first two pops of both frames below, the
     sphere lanes and deep glass; for sweep_ri the glass probe and volume
     points, the grid's hit points, the glass grid frame's first two pops and
     ``deep_glass_spheres()``), each with its counters (``k4_dense_modes``).
  bvh_queue_frame. The bvh workload's own path: the queue renderer
     (``render_stats``, intersector="pallas", K5's generic instantiation) on
     ``bvh_grid_scene(side=32)`` at 800x450x16 depth 8, one warm frame and
     three timed; parity against the render_uber frame of 11 by the bars of
     5 with under 3 % of pixels off by 0.05; only K5 launched; every K5
     launch timed on the device alone beside its bound; a profiled frame for
     the card's busy and idle shares and K5's share; K5's coop_min sweep
     over the frame and over the grid canary (``k5_coop_sweep``).
  dense_generic_frame. The same scene and size through the queue renderer
     with pallas_groups=0: K4's culled dense sweep_nearest alone, once a pop;
     the canary's envelope against the bvh queue frame of the same run; zero
     dropped; every launch timed on the device alone beside its bound (the
     lesser of the dense count and the work K4's counters name, ``k4_bound``),
     none at or below it; the counters' share of rows fully tested and SIMT
     efficiency; the card's idle share over a profiled frame.
  glass_grid_frame. ``glass_grid_scene()`` (every fourth grid object glass)
     at 800x450x16 d8 through the default grouped queue renderer: K5 and
     K4's sweep_ri (the generic scene's surrounding-RI probe) once a pop
     each; the envelope against render_uber of the same scene; zero dropped;
     both kernels' launches timed and bounded as above, apart.
 13. the chunked megakernel (``mega_step``) vs plain at the shapes the drain
     gives it: the (16, 2^20) pools of the headline frame's first chunk at
     iterations 0, 1 and the chunk's last (mostly inactive lanes), taken from
     the drain itself; the same on the motion frame for the MOTION
     instantiation.  Bars: ``MEGA_BARS``, with their reasons.
 14. the headline frame through ``render_megalanes``, ``schedule="natural"``
     and ``"sorted"``, ``gr=64``: rays within 2 % of 91 994 750, image mean
     within 1e-2 of 1.0021, zero dropped, the canary's envelope against the
     ``render_uber`` frame of the same run, and exactly one launch of the
     megakernel per iteration; then where a frame's time goes.
 15. the work queue: ``render_workqueue`` at 200x112x8 depth 6 against the
     queue renderer given a full tree's budget (image atol 2e-5 on >= 99.5 %
     of pixels, equal rays, zero dropped, one sweep launch per iteration), then
     the headline frame once through it, held to the envelope, and once more
     with K2's bound summed over its launches.
 16. the motion frame through ``render_uber``: one launch of the persistent
     kernel's MOTION instantiation, held against its plain version on every
     primary (both builds, bars as in 4) and per pixel; the motion canary
     against the queue renderer through the sweep's MOTION instantiation; that
     sweep vs plain on the frame's 5 760 000 camera lanes and their children;
     the frame through the drain (the megakernel's MOTION instantiation).
 17. a moving generic scene at the canary's size: the persistent kernel's
     generic MOTION instantiation vs plain and vs the queue renderer.
  sweep_modes. the sphere sweep's (K2) and the megakernel's (K6) two sweep
     schedules, as uber_modes holds K1's: ``coop_min`` 1, 33 and the default
     give bit-identical outputs and equal counters in the -fmad=false build on
     K2's inputs (the canary's lanes and their second generation, the first
     launches of a work-queue frame of the headline, the motion frame's
     lanes, and a scene of glass spheres nested three deep,
     ``deep_glass_spheres()``, where probe points lie inside three or more
     spheres and the probe's sum has several terms) and on K6's (the
     headline chunk's pools at iterations 0, 1 and its last, the motion
     chunk's, and the deep-glass frame's first four iterations); SIMT
     efficiency per schedule; the share of lane slots K6's dense passes
     filled; the ``coop_min`` sweep over ``COOP_SWEEP``: K6's summed step time
     over a natural megalanes frame of the headline and K2's summed time over
     a work-queue frame, each launch timed twice by CUDA events with the card
     kept busy while the host enqueues it, the faster timing counted.  K3's
     part runs with the gradient phases: its four instantiations' schedules
     bit for bit in the -fmad=false build, and each equal to the plain
     version (t, obj, edge) on every ray, on the generic canary's lanes and
     on the first two pops of the middle band of the hard and soft generic
     steps and of the moving-groups step (``k3_sweep_modes``); its summed
     time over the hard and the soft generic step per coop_min, each launch
     above its bound (``k3_coop_sweep``).
  materials_frame, lights_frame. ``materials_scene()`` (materials shading) and
     ``lights_scene()`` (with ``extract_lights``) at 800x450x16 depth 8
     through ``render_uber``: one launch of ``uber_mat`` / ``uber_g_lt`` per
     frame, min and mean of 3 frames after a warm one, rays, Mrays/s, K1's
     time and bound, accel build, epilogue; zero dropped; image mean within
     SHADING_FRAME_MEAN and rays within SHADING_FRAME_RAYS of the plain
     version of the same frame; K1 against its plain version per sample on
     every primary (``check_shading``: the -fmad=false build within 1e-4 on
     >= SHADING_PRECISE, for lights off the samples whose shadow rays aim at
     a corner of the light's box, CORNER_RATIOS says why); the schedules
     bit for bit in the -fmad=false build (uber_modes).
  shading_canary. each of the eight new instantiations (materials and lights,
     sphere and generic, static and moving; ``SHADING_CANARIES``) at
     200x112x8 depth 6 against the queue renderer, by the bars of 5, which
     launches K2 or K5, shadow sweeps included; against its plain version by
     ``check_shading``; the schedules bit for bit.
  workqueue_lights. ``render_workqueue`` with lights on the sphere lights
     canary against the queue renderer given a full tree's budget: image atol
     2e-5 on >= 99.5 %, zero dropped, K2 alone; rays at or above the queue
     renderer's and within 2 % (``workqueue_lights`` says why).
  deep_stack. K1 with stacks of 16 and 32 records on ``deep_glass_spheres()``
     under materials shading at depths 12 and 16 against the queue renderer
     with the same stack, by the bars of 5; the same frames at 8 records
     drop rays.
  Then the eighth slice, the gradient path (``diff``), all at 800x450x16 d8:
  grad_frame. ``bench.py``'s ``grad_config``: ``iow_final_scene()``, colours
     ``* 0.8 + 0.1``, the queue renderer's frame as the target, 25 bands of 18
     rows (the 300 k-sample rule), band depths probed + 2, one
     ``banded_value_and_grad`` through the kernels (K2 behind
     ``fastpath._winner``), once in the -fmad=false build and once with the
     sweeps routed to their plain versions on the card (``plain_sweeps``):
     the -fmad=false build's loss within GRAD_PRECISE's rtol 1e-5 and every
     field's gradient within 1e-3 of its max |g|; the default build by
     GRAD_DEFAULT (its reason there).  Seconds per step, forward rays and
     seconds, band depths, peak memory, K2's launches and device time, and
     the deepest band's device busy share (``torch.profiler``).
  grad_soft_frame, grad_generic_soft, grad_motion_soft. The same frame with
     ``soft_edges`` 0.03 (K2's EDGE instantiation); ``bvh_grid_scene(side=32)``
     with jittered positions, soft (K3's EDGE instantiation) and hard (K3
     behind ``_winner``); ``motion_blur_scene()`` and a moving
     ``groups_scene()``, soft (the two moving EDGE instantiations): finite
     gradients, each step running its one sweep instantiation only; each
     step's sweep launches timed by CUDA events (device total and count); on
     bvh1k K3's bound summed over the hard step's launches from their own
     counters and its SIMT efficiency (live rows / lane slots) over each step
     at the default coop_min and at 1.
  edge_vs_plain. Each EDGE instantiation against its plain version on the
     rays of its frame's first two pops in the middle band: the -fmad=false
     build with t, obj and edge identical on >= EDGE_PRECISE (99.9 %), the
     default build by NEAREST_BARS with the silhouette candidate's share
     held to the winner's; dead rays have none; time, plain time and bound:
     the lesser of the dense pass's (every live ray and row) and, for K3,
     the culled pass's (its counters: entries bounded, rows evaluated), both
     printed beside it; for K3 the share of (live ray, row) pairs evaluated
     for rays that hit and missed.
  train_steps. ``make_train_step`` (Adam, colour trainable, auto_pops) three
     steps of grad_config: the loss falls; a checkpoint after them restores
     parameters and Adam's state bit for bit, and the next step's loss from
     both is equal.
  Then the thirteenth slice, the row-sharded mesh (``parallel/``) on virtual
  shards of this card (``make_mesh(devices=[card] * n)``: each shard its own
  launches with its own row map):
  sharded_headline. The headline frame through ``render_uber_sharded`` on 3
     shards (150 rows each) and 4 (113, two of them off the frame): exactly
     ``{"uber": n}`` a frame; in the -fmad=false build image and depth bit
     for bit the single ``render_uber`` frame's, rays equal at 3 (at 4 the
     off-frame rows add rays, as in the JAX package); the default build by
     the canary's envelope against the headline frame of this run, with the
     share of bit-identical pixels; min and mean of 3 frames after a warm
     one beside the single frame's, timed again in the phase; K1 alone on
     the same tables by CUDA events, the n shard launches against the one
     launch, in turns (single, sharded, sharded, single).
  load_imbalance. ``multihost.load_imbalance_report`` on the headline at 1,
     2, 4 and 8 shards (15 launches): per-shard rays, imbalance, efficiency
     bound in (0, 1]; one shard's rays within 0.5 % of the headline's.
  sharded_bvh_queue. bvh1k through ``render_sharded`` on 3 shards (the
     ``bvh`` workload's queue renderer): K5 alone; -fmad=false build image,
     depth and rays identical to ``render_stats``; the default build by the
     envelope; min and mean of 3 frames beside the single frame's.
  sharded_train_step. ``grad_config``'s scene and target at 800x450, depth
     8, spp cut from 16 to TRAIN_SPP (2): a mesh takes no bands, as in the
     JAX package, and 16 spp unbanded would need some 100 GB (1 spp if the
     unsharded step's peak passes 60 GB); ``value_and_grad_loss`` on 3
     shards against one device: -fmad=false build by GRAD_SHARDED_PRECISE
     (its reason there), the default build by GRAD_DEFAULT; K2 alone; peak
     memory and seconds per step of both; three Adam steps of
     ``make_train_step(mesh=)``: the last two below the first.
  dryrun. ``dryrun.dryrun_multichip(4, devices=[card] * 4)`` in the
     -fmad=false build: one sharded Adam step with a finite loss, and
     ``render_uber_sharded`` against ``render_uber`` at atol 2e-6 with equal
     rays under 'bvh', materials and lights (each one single and four shard
     launches).
  world_one. ``multihost.initialize_multihost`` with NCCL, world size
     1, through a FileStore in a temporary directory; ``make_mesh()`` is the
     group's; ``render_uber_sharded`` at 200x112x8 d6 bit for bit
     ``render_uber`` (one launch); one ``value_and_grad_loss(mesh=)``
     through the all-reduce against the unsharded one by
     GRAD_SHARDED_PRECISE; the group destroyed in a ``finally``.
  Then the fourteenth slice, last: the numpy oracle, the normals view,
  progressive tiles and the LBVH with its native host build.
  oracle_parity. ``render`` with intersector="pallas" on the card (K2 on the
     sphere scenes, K5 on the generic ones) against the port's float64 numpy
     oracle ``reference.render_cpu`` (which shares no renderer code) on
     ``tests/test_render_parity.py``'s cases at its sizes (``ORACLE_CASES``),
     both builds: >= 99.5 % of pixels within atol 2e-4 (lights 5e-4) and
     rtol 1e-3, K2 or K5 launched in each case; the phase's seconds.
  normals_frame. The normals view (``show_normals``) through the queue
     renderer on ``iow_final_scene()`` at 800x450x100 (one K2 launch a
     frame) and on bvh1k at 800x450x16 (one K5 launch), each against the
     same frame with the sweeps routed to their plain versions
     (``plain_sweeps``, ``plain_grouped``): the -fmad=false build's image and
     depth bit for bit, the default build by the canary's envelope; min and
     mean of 3 frames after a warm one.
  progressive_frame. ``ops.tiles.render_progressive`` on the bvh workload's
     path (bvh1k, 800x450x16 d8, intersector="pallas"), 104 tiles of 64x64
     four a step (26 yields): done_fraction rising to 1.0, the final canvas
     within atol 1e-5 of ``render_stats``'s frame and its share of
     bit-identical pixels, both builds; K5 alone, its launches summed over
     the tiles' pops; the seconds beside the full frame's.
  lbvh_build, lbvh_frame, lbvh_ri_canary, native_noise. ``build_lbvh`` on the
     card against ``build_lbvh_native`` (the C++ of ``native/``, built with
     g++, which the card's machine must have) on bvh1k and the headline
     scene: node arrays equal, boxes within 1e-5, both builds' milliseconds;
     bvh1k at 800x450 d8 with spp cut from 16 to 1 (``LBVH_FRAME``: the
     walk is the JAX package's lockstep oracle, some forty launches a step
     over every lane) with intersector="bvh": no kernel launched, >= 99.5 %
     of pixels within atol 2e-4 / rtol 1e-3 of the -fmad=false build's
     grouped-sweep frame (K5), the canary's envelope against the default
     build's, each walk's steps against its cap 3 * nodes + 2; the headline
     scene at the canary's size with intersector="bvh", where the RI walk
     (``traverse_point_ri``) runs: no kernel, the oracle bar against the
     queue renderer through the first-generation sweeps over the scene's
     generic table (K5 and K4's ``sweep_ri``) in the -fmad=false build,
     whose arithmetic the walk's is (the walk sums its terms in a fixed
     order, so its bits do not depend on the device), the RI walk equal to
     the dense containment sum at 131 072 points around the glass on
     >= 99.9 %, and the envelope against the sphere sweep printed; the native
     noise in [0, 1], its three kinds different.
Launch counts are kept per driven path: set to 0 before a path and read after
it (each canary, each frame); every kernel must be launched on at least one.
"""

from __future__ import annotations

import contextlib
import json
import re
import subprocess
import sys
import time

import numpy as np
import torch

if not torch.cuda.is_available():
    sys.exit("chip_smoke.py needs a CUDA device: torch.cuda.is_available() is False")

import dataclasses  # noqa: E402

from raytracing_tests_tpu_torch import diff  # noqa: E402
from raytracing_tests_tpu_torch.kernels import (  # noqa: E402
    _build, edge_cull, mega, sweep, sweep2, sweep2g, uber,
)
from raytracing_tests_tpu_torch.ops import megalanes, workqueue  # noqa: E402
from raytracing_tests_tpu_torch.ops.render import (  # noqa: E402
    RenderConfig, _build_accel, _lane_inputs, finalize, render_stats,
)
from raytracing_tests_tpu_torch.scene import examples  # noqa: E402
from raytracing_tests_tpu_torch.scene.types import ELLIPSOID, Camera, SceneBuilder  # noqa: E402

SEED = 0
HEADLINE = dict(width=800, height=450, spp=100, max_bounces=8)
SMALL = dict(width=200, height=112, spp=8, max_bounces=6)
# The generic frame: bvh_grid_scene(side=32), 1 025 objects (512 spheres, 512
# y-rotated boxes, the ground box).
BVH1K = dict(width=800, height=450, spp=16, max_bounces=8)
GLASS = dict(width=200, height=112, spp=4, max_bounces=6)  # the dense-sweep pass
GR = 64  # sphere rows per culling group on the headline path
N_DEAD = 64  # leading rays of the sweep comparison that carry d = 0
SCENE_RAYS = 91_994_750  # rays of the headline frame: a property of the scene
SCENE_MEAN = 1.0021  # its image mean, likewise
# The generic frame's ray count and image mean as the PLAIN version renders it
# (and the -fmad=false build, one ray apart); the default build, which the
# frame runs, counts 0.34 % fewer rays.  Phase 11 also holds the frame against
# the plain version's numbers of the same run.
BVH1K_RAYS = 17_510_505
BVH1K_MEAN = 0.9759
# Five more cameras over the same grid, for the per-pixel bars of phase 9;
# their far classes (see FAR_T) hold 3 % to 35 % of the samples.
EXTRA_CAMERAS = dict(
    side_low=dict(origin=(9.0, 1.6, 4.0), direction=(-0.35, -0.12, -1.0)),
    high_steep=dict(origin=(-4.0, 9.0, -6.0), direction=(0.15, -0.8, -1.0)),
    side_high=dict(origin=(14.0, 5.0, -2.0), direction=(-0.6, -0.4, -1.0)),
    back=dict(origin=(0.0, 2.0, -56.0), direction=(0.1, -0.3, 1.0)),
    low=dict(origin=(0.0, 1.2, 3.0), direction=(0.0, -0.08, -1.0)),
)
# Per-pixel bars of the default build's finished headline image (phase 4).
PIXEL_ATOL, PIXEL_FRAC, PIXEL_MAX = 1e-1, 0.999, 0.5
PIXEL_FRAC_1E2, PIXEL_MEAN = 0.90, 5e-3  # share within 1e-2; mean distance

# Published peaks of one H100 SXM: fp32 outside the tensor cores, HBM3.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
# Operation counts of the kernels' arithmetic (a fused multiply-add counts 2).
FLOPS_PER_SPHERE_TEST = 18  # two 3-dots, nb, c_q, disc, compares
FLOPS_PER_SLAB_TEST = 26  # 6 sub-mul pairs, 10 min/max, 3 compares
FLOPS_PER_NODE_SHADE = 220  # refine, probe point, mirror/refract, children
FLOPS_PER_REFINE = 60  # the winner's own quadratic, hit point, normal
FLOPS_PER_PROBE_ROW = 10  # containment test of one dielectric row
FLOPS_PER_MOTION_TERMS = 20  # two more 3-dots and the omt terms of nb and c_q
# Generic primitives (rotated ellipsoids and cuboids):
FLOPS_PER_CENSUS_SPHERE_ROW = 20  # world-frame quadratic with a = 1
FLOPS_PER_CENSUS_CUBOID_ROW = 48  # 2x2 rotation of o and d, 3 reciprocals, slab
FLOPS_PER_GENERIC_ROW = 70  # motion shift, two 3x3 rotations, divisions, one test
FLOPS_PER_REFINE_G = 120  # both rotations, the winner's test, normal, local position
FLOPS_PER_PROBE_ROW_G = 30  # fused-frame 3x3 product and the containment test
FLOPS_PER_CONTAINS_SPHERE = 14  # shifted centre, squared distance, compare
FLOPS_PER_CONTAINS_GENERIC = 45  # shift, rotation, 3 divisions, compare


# What ``ptxas -v`` gives the persistent kernel's static 'bvh' instantiations
# with the warp sweeps of csrc/warp_sweep.cuh (sphere; generic), on the toolkit
# of CUDA 12.8, since their stacks moved to a global scratch buffer: the
# 256-byte local array left the stack frame (288 B before, with 80 and 94
# registers; before the warp sweeps 80 registers and no spill, and 64 with
# 148 / 164 B of spill stores / loads).
PTXAS_STATIC = {
    "uber_kernel<0,0,0,0>": dict(registers=80, stack=32, spill_stores=0, spill_loads=0),
    "uber_kernel<1,0,0,0>": dict(registers=93, stack=32, spill_stores=0, spill_loads=0),
}
# What it gave all twelve untextured instantiations before the textured ones
# and the camera variants came (<generic, motion, shading>; PERF.md section 6),
# the last template argument (TEX) added to the names.
PTXAS_K1 = {
    f"uber_kernel<{k},0>": dict(registers=r, stack=st, spill_stores=ss, spill_loads=sl)
    for k, (r, st, ss, sl) in {
        "0,0,0": (80, 32, 0, 0), "0,0,1": (96, 40, 4, 4), "0,0,2": (80, 56, 24, 24),
        "0,1,0": (80, 56, 24, 24), "0,1,1": (96, 48, 12, 12), "0,1,2": (80, 56, 24, 24),
        "1,0,0": (93, 32, 0, 0), "1,0,1": (80, 112, 136, 96), "1,0,2": (96, 32, 0, 0),
        "1,1,0": (96, 32, 0, 0), "1,1,1": (80, 120, 152, 116), "1,1,2": (96, 48, 12, 12),
    }.items()
}
# What it gives the sphere sweep and the megakernel since they run the warp
# sweeps too, at their launch bounds of 3 blocks of 256 threads and 6 of 128
# per SM (before: sweep2_kernel<0> 48 registers, 4/4 B of spill, <1> 70 and
# none; mega_kernel<0> and <1> 64 and none).  The sweeps' names carry a second
# template argument since their silhouette (EDGE) instantiations came: the
# lines are those of the <MOTION, false> ones.  And the generic sweep's four
# instantiations since they run the warp sweep, at 4 blocks of 256 per SM
# (moving EDGE: 2; before, one thread's walk: sweep2g_kernel<0> and <1> 48
# registers with 8/8 and 16/16 B of spill at no bound, the EDGE ones 58 and 60
# and none, at 2).
PTXAS_REDESIGNED = {
    "sweep2.so sweep2_kernel<0,0>": dict(registers=61, stack=0, spill_stores=0, spill_loads=0),
    "sweep2.so sweep2_kernel<1,0>": dict(registers=77, stack=0, spill_stores=0, spill_loads=0),
    "mega.so mega_kernel<0>": dict(registers=80, stack=32, spill_stores=0, spill_loads=0),
    "mega.so mega_kernel<1>": dict(registers=80, stack=32, spill_stores=0, spill_loads=0),
    "sweep2g.so sweep2g_kernel<0>": dict(registers=62, stack=0, spill_stores=0, spill_loads=0),
    "sweep2g.so sweep2g_kernel<1>": dict(registers=64, stack=0, spill_stores=0, spill_loads=0),
    "sweep2g.so sweep2g_edge_kernel<0>": dict(registers=64, stack=0, spill_stores=0,
                                              spill_loads=0),
    "sweep2g.so sweep2g_edge_kernel<1>": dict(registers=72, stack=0, spill_stores=0,
                                              spill_loads=0),
}
# The generic sweep's instantiations, which must build with no spill.
K3_INSTANTIATIONS = [k for k in PTXAS_REDESIGNED if k.startswith("sweep2g.so")]
# (K4's dense nearest_kernel and ri_kernel, one thread a ray before they were
# staged and split: <0> 32 and 40 registers, <1> 32 and 39, no spill.)
# ... and what it gives K5 on the warp sweep (<generic, fused RI>, at 5 blocks
# of 256 per SM) and K4's fused sweep in shared memory (<lanes per ray>; before:
# one nearest_ri_kernel, 38 registers, no spill; <2> and <4> had 36 and 40
# before the dense kernels came to share its staging code).
PTXAS_K45 = {
    "sweep.so grouped_kernel<0,0>": dict(registers=46, stack=0, spill_stores=0, spill_loads=0),
    "sweep.so grouped_kernel<0,1>": dict(registers=48, stack=0, spill_stores=0, spill_loads=0),
    "sweep.so grouped_kernel<1,0>": dict(registers=48, stack=0, spill_stores=0, spill_loads=0),
    "sweep.so nearest_ri_kernel<1>": dict(registers=39, stack=0, spill_stores=0, spill_loads=0),
    "sweep.so nearest_ri_kernel<2>": dict(registers=35, stack=0, spill_stores=0, spill_loads=0),
    "sweep.so nearest_ri_kernel<4>": dict(registers=38, stack=0, spill_stores=0, spill_loads=0),
    "sweep.so nearest_ri_kernel<8>": dict(registers=40, stack=0, spill_stores=0, spill_loads=0),
}


def kernel_of(mangled):
    """'uber_kernel<0,1>' from a mangled entry name: the length-prefixed name
    that ends in _kernel, and the values of its template arguments."""
    for m in re.finditer(r"\d+", mangled):
        digits = m.group()
        for k in range(len(digits)):  # the digits of a hash may run into the length
            n, at = int(digits[k:]), m.end()
            name = mangled[at:at + n]
            if n and name.endswith("_kernel") and name.isidentifier():
                rest = re.match(r"I((?:L[bi]\d+E)+)E", mangled[at + n:])
                args = ",".join(re.findall(r"L[bi](\d+)E", rest.group(1))) if rest else ""
                return name + (f"<{args}>" if args else "")
    return mangled


def ptxas_by_kernel(log):
    """``ptxas -v`` per library and kernel instantiation from the build log:
    {"uber.so uber_kernel<0,1>": {registers, stack, spill_stores, spill_loads}}."""
    out, lib, key = {}, "", None
    for ln in log.splitlines():
        if ln.startswith("== "):
            lib = ln.strip("= ")
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            key = f"{lib} {kernel_of(m.group(1))}"
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m and key:
            out[key] = dict(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                            spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", ln)
        if m and key:
            out.setdefault(key, {})["registers"] = int(m.group(1))
    return out


def size_of(frame):
    return "{width}x{height}x{spp}spp d{max_bounces}".format(**frame)


def say(**kw):
    print(json.dumps(kw), flush=True)


def require(cond, what):
    if not cond:
        raise AssertionError(what)


def cuda_ms(fn, reps):
    """Mean milliseconds of ``fn()`` over ``reps`` launches, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def frac(mask):
    """Share of true entries (exact: a float32 mean of many ones is not 1)."""
    return int(mask.sum()) / max(mask.numel(), 1)


def bound(n_bytes, n_flops):
    t_b = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_f = n_flops / PEAK_FP32_FLOPS * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


def accel_bytes(accel):
    return 4 * (accel.otab.numel() + accel.ftab.numel() + accel.gaabb.numel())


def compare_sweep(accel, rays):
    """The sweep kernel of the current build variant against the plain
    version on the same rays, for (t, obj) alone and for the hit block."""
    out = {}
    for with_fields in (False, True):
        tk, ok_, rk = sweep2._sweep2(accel, rays, with_fields, with_fields)
        tp, op, rp = sweep2.sweep2_plain(accel, rays, with_fields, with_fields)
        torch.cuda.synchronize()
        same = ok_ == op
        dead = (rays[3:6] * rays[3:6]).sum(dim=0) < 0.5
        m = same & (op >= 0)
        terr = (tk[m] - tp[m]).abs()
        res = dict(same_obj=frac(same),
                   hit_frac=frac(op >= 0),
                   dead_rays=int(dead.sum()),
                   dead_rays_miss=bool((ok_[dead] == -1).all()),
                   t_within_rtol_1e4=frac(terr <= 1e-4 * tp[m]),
                   t_within_2e2=frac(terr <= 2e-2),
                   t_max_abs_err=float(terr.max()),
                   t_max_rel_err=float((terr / tp[m]).max()))
        if with_fields:
            nerr = (rk[2:5, m] - rp[2:5, m]).abs().amax(dim=0)
            ferr = (rk[5:, m] - rp[5:, m]).abs().amax(dim=0)
            res["normal_within_1e5"] = frac(nerr <= 1e-5)
            res["normal_within_1e3"] = frac(nerr <= 1e-3)
            res["normal_within_1e2"] = frac(nerr <= 1e-2)
            res["normal_max_abs_err"] = float(nerr.max())
            res["fields_within_1e5"] = frac(ferr <= 1e-5)
            res["fields_max_abs_err"] = float(ferr.max())
            res["ri_equal"] = frac(rk[1, m] == rp[1, m])
        out["hit_block" if with_fields else "nearest"] = res
    return out


# Bars of phase 3 for the default build, per batch.  ``raw_t_2e2``: share of
# rays whose unrefined t lies within 2e-2; ``normal_1e3`` / ``normal_1e2``:
# shares of normals within 1e-3 / 1e-2; ``normal_max``: the furthest normal.
SWEEP_BARS = dict(
    random=dict(raw_t_2e2=1.0, normal_1e3=0.99, normal_1e2=1.0, normal_max=2e-2),
    # Camera rays travel 13 to 40 units to spheres of radius 0.2: grazing
    # hits lose the refined t to float32 cancellation in hb^2 - cq (one ulp of
    # hb^2 is 6e-5 there), and the normal carries that error times 1/radius.
    canary_lanes=dict(raw_t_2e2=1.0, normal_1e3=0.97, normal_1e2=0.999, normal_max=5e-2),
    # Rays that start 1e-4 from a surface: the anchored quadratic's near root
    # of the sphere just left is zero within its error, so the builds may
    # pick different roots of that sphere before the refine re-solves it.
    canary_second_pop=dict(raw_t_2e2=0.999, normal_1e3=0.99, normal_1e2=1.0, normal_max=2e-2),
)


def check_sweep(batch, res, precise):
    """The bars of phase 3 on one batch of rays."""
    bars = SWEEP_BARS[batch]
    for r in (*res.values(), *precise.values()):
        require(r["same_obj"] >= 0.999 and r["dead_rays_miss"],
                f"sweep2 winners disagree on {batch}: {r}")
    # The unrefined t is solved around the group anchor and carries an
    # absolute error (the hit block re-solves it); the refined t is held
    # relatively.
    require(res["nearest"]["t_within_2e2"] >= bars["raw_t_2e2"],
            f"sweep2 t disagrees on {batch}: {res['nearest']}")
    hb = res["hit_block"]
    require(hb["t_within_rtol_1e4"] >= 0.99 and hb["t_max_abs_err"] < 2e-2,
            f"sweep2 refined t disagrees on {batch}: {hb}")
    require(hb["fields_within_1e5"] >= 0.999, f"sweep2 hit block disagrees on {batch}: {hb}")
    require(hb["ri_equal"] >= 0.999, f"sweep2 surrounding RI disagrees on {batch}: {hb}")
    require(hb["normal_within_1e3"] >= bars["normal_1e3"]
            and hb["normal_within_1e2"] >= bars["normal_1e2"]
            and hb["normal_max_abs_err"] < bars["normal_max"],
            f"sweep2 normals disagree on {batch}: {hb}")
    hbp = precise["hit_block"]
    require(hbp["t_within_rtol_1e4"] >= 0.999 and hbp["normal_within_1e5"] >= 0.999
            and hbp["fields_within_1e5"] >= 0.999 and hbp["ri_equal"] >= 0.999
            and precise["nearest"]["t_within_rtol_1e4"] >= 0.999,
            f"sweep2 precise build disagrees on {batch}: {precise}")


def second_generation(accel, rays):
    """The rays a second pop would carry: from each first hit, even lanes
    mirror off the surface and odd lanes continue through it (so glass is
    entered); lanes whose first ray missed are dead (d = 0)."""
    t, _, rows = sweep2.sweep2_plain(accel, rays, True, True)
    o, d = rays[0:3], rays[3:6]
    hit = t < 1e30
    n = rows[sweep2.V_NX:sweep2.V_NZ + 1]
    nd = (n * d).sum(dim=0)
    n_out = torch.where(nd > 0.0, -n, n)
    pt = o + torch.where(hit, t, torch.zeros_like(t)) * d
    mirror = torch.arange(t.shape[0], device=t.device) % 2 == 0
    side = torch.where(mirror, 1e-4, -1e-4).to(torch.float32)
    d2 = torch.where(mirror, d - 2.0 * nd * n, d)
    d2 = d2 / d2.norm(dim=0).clamp_min(1e-20)
    d2 = torch.where(hit, d2, torch.zeros_like(d2))
    o2 = torch.where(hit, pt + side * n_out, o)
    return torch.cat([o2, d2, rays[6:8]]).contiguous()


def compare_uber(accel, cam, st, out_p, stats_p, lights=None, atlas=None, aa=None):
    """The persistent kernel of the current build variant against the plain
    version's output ``out_p`` on the same frame (``lights``: its
    ``pack_lights`` rows; ``atlas``: the scene's ``pack_atlas``; ``aa``: the
    ``aa_table``) -> (numbers, kernel out)."""
    out_k, stats_k = uber.uber_render(accel, cam, st, lights, atlas, aa)
    torch.cuda.synchronize()
    cerr = (out_k[:, :3] - out_p[:, :3]).abs().amax(dim=1)
    terr = (out_k[:, 3] - out_p[:, 3]).abs()
    rays_k, rays_p = int(stats_k[uber.ST_RAYS]), int(stats_p[uber.ST_RAYS])
    return dict(finite=bool(torch.isfinite(out_k).all()),
                colour_within_1e4=frac(cerr <= 1e-4),
                colour_within_5e2=frac(cerr <= 5e-2),
                colour_max_abs_err=float(cerr.max()),
                mean_abs_diff=float((out_k[:, :3].mean(dim=0) - out_p[:, :3].mean(dim=0)).abs().max()),
                primary_t_within_rtol_1e4=frac(terr <= 1e-4 * out_p[:, 3]),
                rays=rays_k, ray_count_rel_diff=abs(rays_k - rays_p) / rays_p,
                dropped=int(stats_k[uber.ST_DROPPED])), (out_k, stats_k)


def check_uber(size, plain_dropped, res, precise=None):
    """The per-sample bars of phase 4 at one frame size (the -fmad=false
    build's where it is given)."""
    require(plain_dropped == 0, f"plain version dropped rays at {size}")
    for r in (res, precise or res):
        require(r["finite"] and r["dropped"] == 0, f"uber output at {size}: {r}")
    require(precise is None
            or (precise["colour_within_1e4"] >= 0.999
                and precise["primary_t_within_rtol_1e4"] >= 0.999
                and precise["ray_count_rel_diff"] < 5e-4),
            f"uber precise build disagrees with the plain version at {size}: {precise}")
    require(res["primary_t_within_rtol_1e4"] >= 0.999
            and res["colour_within_1e4"] >= 0.85 and res["colour_within_5e2"] >= 0.97
            and res["mean_abs_diff"] < 5e-3 and res["ray_count_rel_diff"] < 5e-3,
            f"uber kernel disagrees with the plain version at {size}: {res}")


def compare_pixels(img, ref):
    """Per-pixel distance of two finished images (H, W, 3)."""
    err = (img - ref).abs().amax(dim=-1)
    return dict(within_atol=frac(err <= PIXEL_ATOL),
                within_1e2=frac(err <= 1e-2),
                within_1e3=frac(err <= 1e-3),
                mean_abs_err=float(err.mean()), max_abs_err=float(err.max()))


def check_pixels(what, px):
    require(px["within_atol"] >= PIXEL_FRAC and px["max_abs_err"] <= PIXEL_MAX
            and px["within_1e2"] >= PIXEL_FRAC_1E2 and px["mean_abs_err"] < PIXEL_MEAN,
            f"{what}: the image of the default build is off per pixel: {px}")


# ---------------------------------------------------------------------------
# K1's two sweep schedules (csrc/warp_sweep.cuh): a culling group that fewer
# than coop_min lanes of a warp entered is swept row-parallel.  1 keeps every
# group per lane (the earlier one-thread-per-tree schedule), 33 sweeps
# every group row-parallel.  Both give the same result bit for bit in the
# -fmad=false build; the phase "uber_modes" holds them to that, holds each
# forced schedule to the default build's bars against the plain version, and
# times coop_min over COOP_SWEEP.
# ---------------------------------------------------------------------------

FORCED = (1, 33)
COOP_SWEEP = (1, 4, 8, 12, 16, 24, 33)
SWEEP_ROUNDS = 3  # alternating rounds of the coop_min sweep


def coop(cm):
    """The context that runs the warp sweeps (K1, K2, K6) with coop_min forced
    to ``cm`` (None: each module's default ``COOP_MIN``)."""
    return contextlib.nullcontext() if cm is None else _build.forced_coop_min(cm)


def sweep_counters(stats, generic):
    """The counters every schedule must give alike, and its own SIMT numbers."""
    keys = ["ST_RAYS", "ST_DROPPED", "ST_SPHERE_TESTS", "ST_ROW_TESTS", "ST_SHADOW_RAYS",
            "ST_TEX_SAMPLES"]
    if generic:
        keys += ["ST_SLAB_TESTS", "ST_OTHER_TESTS", "ST_HITS"]
    return {k: int(stats[getattr(uber, k)]) for k in keys}


def simt(stats):
    """Row tests over lane slots, and the share of group visits served row-parallel."""
    slots = int(stats[uber.ST_LANE_SLOTS])
    return dict(simt_efficiency=int(stats[uber.ST_ROW_TESTS]) / max(slots, 1),
                lane_slots=slots, coop_visits=int(stats[uber.ST_COOP_VISITS]))


def modes_identical(what, acc, cam, st, lights=None, atlas=None):
    """K1 in the -fmad=false build with coop_min forced to 1 and 33 and at the
    default: bit-identical ``out`` and equal counters, or raise ->
    {mode: SIMT numbers}."""
    generic = acc.mode == "generic"
    runs = {}
    with _build.precise():
        for cm in (*FORCED, None):
            with coop(cm):
                runs[cm] = uber.uber_render(acc, cam, st, lights, atlas)
    torch.cuda.synchronize()
    out1, stats1 = runs[FORCED[0]]
    res = {}
    for cm, (out, stats) in runs.items():
        res[str(cm or "default")] = dict(
            identical_out=bool(torch.equal(out, out1)),
            same_counters=sweep_counters(stats, generic) == sweep_counters(stats1, generic),
            **simt(stats))
    res["counters"] = sweep_counters(stats1, generic)
    require(all(r["identical_out"] and r["same_counters"] for k, r in res.items()
                if k != "counters"),
            f"{what}: K1's sweep schedules differ in the -fmad=false build: {res}")
    return res


def k1_inputs(scene, camera, cfg):
    """The accel, camera vector and statics ``render_uber`` gives K1 (gr
    clamped to the scene's capacity as it does)."""
    gr = min(GR, max(8, -(-scene.capacity // 8) * 8))
    acc, cam = uber._scene_accel(scene, camera, cfg, gr)
    return acc, cam, uber.UberStatics.from_cfg(cfg)


def tie_scene(generic):
    """Two identical spheres (or boxes) in one group, in two colours, seen
    head on: every hit is a tie, which the lower row must win."""
    b = SceneBuilder()
    for colour in ((0.9, 0.1, 0.1), (0.1, 0.1, 0.9)):
        if generic:
            b.add_box((0.0, 0.0, -3.0), (1.2, 1.2, 1.2), rotation_deg=(0.0, 30.0, 0.0),
                      color=colour)
        else:
            b.add_sphere((0.0, 0.0, -3.0), 0.8, color=colour)
    return b.build(), Camera.make((0.0, 0.0, 0.0), (0.0, 0.0, -1.0), fov_y_deg=40.0,
                                  focus_dist=3.0)


def tie_break(dev):
    """On both tie scenes, every schedule in both builds colours each hit
    sample with the lower row's object -> numbers."""
    res = {}
    for generic in (False, True):
        scene, camera = tie_scene(generic)
        scene, camera = scene.to(dev), camera.to(dev)
        cfg = RenderConfig(intersector="pallas", width=32, height=24, spp=2,
                           max_bounces=4).for_scene(scene)
        acc, cam, st = k1_inputs(scene, camera, cfg)
        rows = [int((acc.perm[:acc.n_pad] == i).nonzero()[0]) for i in range(2)]
        want = scene.color[rows.index(min(rows))]
        for variant in ("default", "precise"):
            for cm in FORCED:
                build = _build.precise() if variant == "precise" else contextlib.nullcontext()
                with build, coop(cm):
                    out, _ = uber.uber_render(acc, cam, st)
                hit = out[:, 3] < cfg.t_max
                res[f"{'generic' if generic else 'spheres'} {variant} coop_min={cm}"] = dict(
                    hit_share=frac(hit),
                    lower_row_wins=bool((out[hit, :3] == want).all()) and bool(hit.any()))
    require(all(r["lower_row_wins"] for r in res.values()),
            f"a tie is not won by the lower row in every schedule: {res}")
    return res


def moving_groups_scene():
    """``groups_scene()`` with three of its objects in motion."""
    scene, camera = examples.groups_scene()
    dp = torch.zeros_like(scene.delta_position)
    dp[1] = torch.tensor([0.3, 0.0, 0.0])  # the sphere
    dp[2] = torch.tensor([0.0, 0.25, 0.1])  # the rotated ellipsoid
    dp[3] = torch.tensor([-0.2, 0.0, 0.0])  # the rotated box
    return scene.replace(delta_position=dp), camera


def uber_modes_canaries(dev):
    """Phase uber_modes on the canaries: the schedules bit for bit in the
    -fmad=false build on the sphere, generic, moving generic and motion
    canaries at 200x112x8 d6, and the tie break."""
    canaries = dict(spheres=examples.iow_final_scene(), generic=examples.bvh_grid_scene(side=32),
                    motion=examples.motion_blur_scene(), moving_generic=moving_groups_scene())
    out = {}
    for name, (scene, camera) in canaries.items():
        scene, camera = scene.to(dev), camera.to(dev)
        cfg = RenderConfig(intersector="pallas", **SMALL).for_scene(scene)
        acc, cam, st = k1_inputs(scene, camera, cfg)
        out[name] = modes_identical(f"{name} canary", acc, cam, st)
        out[name]["instantiation"] = uber.launch_name(acc)
    out["tie_break"] = tie_break(dev)
    say(phase="uber_modes", what="canaries", size=size_of(SMALL), **out)
    return out


def uber_modes_frame(what, acc, cam, st, cfg, out_p, stats_p, generic, far=None):
    """Phase uber_modes on a full frame: each forced schedule in the default
    build against the plain version's ``out_p`` by the frame's own bars, and
    all schedules bit for bit in the -fmad=false build -> numbers."""
    img_p = uber._uber_post(out_p, stats_p, cfg)["image"]
    res = dict(precise_build=modes_identical(what, acc, cam, st))
    for cm in FORCED:
        with coop(cm):
            k1, got = compare_uber(acc, cam, st, out_p, stats_p)
        img = uber._uber_post(*got, cfg)["image"]
        size = f"{what} coop_min={cm}"
        if generic:
            check_uber_g(size, int(stats_p[uber.ST_DROPPED]), k1)
            px = compare_pixels_g(img, img_p, far)
            check_pixels_g(f"{size} against the plain version", px)
        else:
            check_uber(size, int(stats_p[uber.ST_DROPPED]), k1)
            px = compare_pixels(img, img_p)
            check_pixels(f"{size} against the plain version", px)
        res[f"coop_min={cm}"] = dict(default_build=k1, pixels_default_vs_plain=px,
                                     **simt(got[1]))
        del got, img
    say(phase="uber_modes", what=what, **res)
    return res


def coop_sweep(what, acc, cam, st, lights=None, atlas=None):
    """K1's milliseconds over COOP_SWEEP, by CUDA events, in SWEEP_ROUNDS
    rounds that alternate the order; each value's SIMT numbers -> numbers."""
    ms = {cm: [] for cm in COOP_SWEEP}
    for rnd in range(SWEEP_ROUNDS):
        for cm in (COOP_SWEEP if rnd % 2 == 0 else COOP_SWEEP[::-1]):
            with coop(cm):
                ms[cm].append(cuda_ms(lambda: uber.uber_render(acc, cam, st, lights, atlas), 2))
    res = {}
    for cm in COOP_SWEEP:
        with coop(cm):
            _, stats = uber.uber_render(acc, cam, st, lights, atlas)
        res[str(cm)] = dict(ms=sum(ms[cm]) / len(ms[cm]), ms_rounds=ms[cm], **simt(stats))
    best = min(COOP_SWEEP, key=lambda cm: res[str(cm)]["ms"])
    say(phase="uber_modes", what=f"{what} coop_min sweep", default_coop_min=uber.COOP_MIN[acc.mode],
        fastest_coop_min=best, by_coop_min=res)
    return res

# ---------------------------------------------------------------------------
# The generic slice: rotated ellipsoids and cuboids
# ---------------------------------------------------------------------------


def overlapping_glass_scene():
    """A glass ellipsoid and a glass box that poke into each other, beside an
    opaque box, over a ground sphere.  A ray leaves one glass body inside the
    other, so the surrounding refractive index is not 1 there: the probe rows
    survive the relevance cut and the containment sums have work to do."""
    b = SceneBuilder()
    b.add((0.0, 0.0, -3.5), (0.7, 0.5, 0.6), ELLIPSOID, rotation_deg=(10.0, 30.0, 0.0),
          color=(1.0, 1.0, 1.0), refractive_index=1.5, refractivity=0.9, reflectivity=0.1)
    b.add_box((0.6, 0.1, -3.4), (0.8, 0.7, 0.7), rotation_deg=(0.0, 25.0, 10.0),
              color=(0.9, 1.0, 0.9), refractive_index=1.3, refractivity=0.85,
              reflectivity=0.15)
    b.add_box((-1.4, 0.0, -4.0), (0.6, 0.8, 0.6), rotation_deg=(0.0, 40.0, 0.0),
              color=(0.3, 0.6, 0.8), reflectivity=0.9, scatter_reflect=0.2)
    b.add_sphere((0.0, -100.6, -4.0), 100.0, color=(0.6, 0.65, 0.6),
                 reflectivity=0.7, scatter_reflect=0.9)
    cam = Camera.make((0.0, 0.4, 0.8), (0.0, -0.1, -1.0), fov_y_deg=55.0, focus_dist=4.2)
    return b.build(), cam


def nested_glass_spheres():
    """Sphere mode with nested and overlapping glass over a ground sphere: from
    inside the outer sphere the fused refractive index is not 1."""
    b = SceneBuilder()
    b.add_dielectric((0.0, 0.0, -3.0), 0.8)
    b.add_dielectric((0.0, 0.0, -3.0), 0.4, ior=1.3)
    b.add_dielectric((0.9, 0.1, -3.2), 0.5)
    b.add_lambertian((-1.2, 0.0, -3.5), 0.5, (0.7, 0.3, 0.3))
    b.add_lambertian((0.0, -100.8, -3.0), 100.0, (0.5, 0.6, 0.4))
    return b.build()


def seeded_rays(centre, spread, n, dev, n_dead=N_DEAD):
    """``n`` rays from a box of half-width ``spread`` around ``centre`` in
    seeded directions, the first ``n_dead`` of them dead (d = 0)."""
    rng = np.random.default_rng(SEED + 1)
    o = (np.asarray(centre)[None] + rng.uniform(-spread, spread, (n, 3))).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d[:n_dead] = 0.0
    return sweep2.pack_rays(torch.from_numpy(o).to(dev), torch.from_numpy(d).to(dev),
                            torch.zeros(n, device=dev), torch.full((n,), 32000.0, device=dev))


def unpack(rays):
    """(8, B) ray matrix -> (o, d, time_ratio, t_limit) as the wrappers take them."""
    return rays[0:3].T.contiguous(), rays[3:6].T.contiguous(), 1.0 - rays[6], rays[7]


def timed_ms(fn):
    """One call of ``fn`` by the host clock around a synchronise -> (ms, result)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3, out


def compare_nearest(got, want, rays):
    """A sweep's (t, obj[, ri]) against its plain version's on the same rays."""
    tk, ok_ = got[0], got[1]
    tp, op = want[0], want[1]
    same = ok_ == op
    dead = (rays[3:6] * rays[3:6]).sum(dim=0) < 0.5
    m = same & (op >= 0)
    terr = (tk[m] - tp[m]).abs()
    miss = same & (op < 0)
    share = lambda mask: frac(mask) if mask.numel() else 1.0
    top = lambda x: float(x.max()) if x.numel() else 0.0
    res = dict(same_obj=frac(same), hit_frac=frac(op >= 0), dead_rays=int(dead.sum()),
               dead_rays_miss=bool((ok_[dead] == -1).all()),
               misses_report_the_limit=bool((tk[miss] == tp[miss]).all()),
               t_within_rtol_1e5=share(terr <= 1e-5 * tp[m]),
               t_within_rtol_1e4=share(terr <= 1e-4 * tp[m]),
               t_max_abs_err=top(terr), t_max_rel_err=top(terr / tp[m]))
    if len(got) > 2:
        res["ri_equal"] = frac(got[2][same] == want[2][same])
        res["ri_not_one"] = frac(want[2] != 1.0)
    return res


# Bars of the sweeps over generic tables, default build.  The -fmad=false
# build must give the plain version's winner on >= 99.9 % of rays and t within
# rtol 1e-4 on >= 99.9 % of the agreeing hits, on every batch.  The default
# build fuses a*b+c: ``same``: share of equal winners; ``t_1e4``: share of
# agreeing hits with t within rtol 1e-4; ``ri``: share of equal refractive
# indices.
NEAREST_BARS = dict(same=0.999, t_1e4=0.99, ri=0.999)


def check_nearest(what, res, precise):
    for r in (res, precise):
        require(r["dead_rays_miss"] and r["misses_report_the_limit"],
                f"{what}: dead rays or misses are wrong: {r}")
    require(precise["same_obj"] >= 0.999 and precise["t_within_rtol_1e4"] >= 0.999
            and precise.get("ri_equal", 1.0) >= 0.999,
            f"{what}: the -fmad=false build disagrees with the plain version: {precise}")
    require(res["same_obj"] >= NEAREST_BARS["same"]
            and res["t_within_rtol_1e4"] >= NEAREST_BARS["t_1e4"]
            and res.get("ri_equal", 1.0) >= NEAREST_BARS["ri"],
            f"{what}: the kernel disagrees with the plain version: {res}")


def both_builds(what, batch, kernel_fn, want, rays):
    """Run ``kernel_fn`` in the default and the -fmad=false build against the
    plain version's ``want``; print and check; -> the default build's numbers."""
    res = compare_nearest(kernel_fn(), want, rays)
    with _build.precise():
        precise = compare_nearest(kernel_fn(), want, rays)
    torch.cuda.synchronize()
    say(phase=f"{what}_vs_plain", batch=batch, rays=rays.shape[1],
        default_build=res, precise_build=precise)
    check_nearest(f"{what} on {batch}", res, precise)
    return res


def second_generation_g(acc, rays):
    """The rays a second pop would carry on a generic scene: from each first
    hit (found by the plain grouped sweep), even lanes mirror off the surface
    and odd lanes continue through it, so they start inside a primitive; lanes
    whose first ray missed are dead (d = 0)."""
    o, d, tr, _ = unpack(rays)
    t, obj, _ = sweep.sweep_grouped_plain(acc.table, acc.gaabb, rays, acc.group, False, acc.mode)
    h, _ = sweep._finish_hit(acc, o, d, tr, t, obj)
    hit = h.hit[:, None]
    n = h.normal
    nd = (n * d).sum(dim=1, keepdim=True)
    n_out = torch.where(nd > 0.0, -n, n)
    pt = o + h.t[:, None] * d
    mirror = (torch.arange(o.shape[0], device=o.device) % 2 == 0)[:, None]
    side = torch.where(mirror, 1e-4, -1e-4).to(torch.float32)
    d2 = torch.where(mirror, d - 2.0 * nd * n, d)
    d2 = d2 / d2.norm(dim=1, keepdim=True).clamp_min(1e-20)
    d2 = torch.where(hit, d2, torch.zeros_like(d2))
    o2 = torch.where(hit, pt + side * n_out, o)
    return sweep2.pack_rays(o2, d2, tr, rays[7])


def probe_points(acc, rays):
    """(4, B) query points of the refractive-index sum: 1e-3 outside the first
    hit of each ray along the normal (the ray's origin where it missed)."""
    o, d, tr, _ = unpack(rays)
    t, obj, _ = sweep.sweep_grouped_plain(acc.table, acc.gaabb, rays, acc.group, False, acc.mode) \
        if acc.group else (*sweep.sweep_nearest_plain(acc.table, acc.mode, rays), None)
    h, _ = sweep._finish_hit(acc, o, d, tr, t, obj)
    q = torch.where(h.hit[:, None], o + h.t[:, None] * d + 1e-3 * h.normal, o)
    return torch.stack([q[:, 0], q[:, 1], q[:, 2], rays[6]]).contiguous()


def compare_ri(what, batch, table, mode, pts):
    """The refractive-index sum of both builds against its plain version."""
    q, tr = pts[0:3].T.contiguous(), 1.0 - pts[3]
    want = sweep.sweep_ri_plain(table, mode, pts)
    got = sweep.sweep_ri(table, mode, q, tr)
    with _build.precise():
        got_p = sweep.sweep_ri(table, mode, q, tr)
    torch.cuda.synchronize()
    res = dict(equal=frac(got == want), equal_precise_build=frac(got_p == want),
               not_one=frac(want != 1.0),
               max_abs_err=float((got - want).abs().max()))
    say(phase=f"{what}_vs_plain", batch=batch, points=pts.shape[1], **res)
    require(res["equal"] >= 0.999 and res["equal_precise_build"] >= 0.999,
            f"{what} on {batch} disagrees with its plain version: {res}")
    return res


# Bars of the persistent kernel's generic instantiation against its plain
# version at 16 spp, per pixel of the finished image.  The winner is re-solved
# in the dense intersector's divide-by-scale form (the reference's arithmetic),
# whose quadratic half_b^2 - a c cancels in float32 once a small primitive is
# far away: for a 0.45-radius sphere 60 units off, |o/s|^2 is 2e4 with an ulp
# of 2e-3, and the refined t is good to about 5e-4 -- more than the 1e-4 by
# which a child ray is lifted off the surface.  There the child starts at
# random on either side of the surface in ANY build, and the default build
# (fused a*b+c) and the plain version (rounded twice) draw different lots
# (the phase prints the share of samples beyond 5e-2 on either side of FAR_T).
# So the pixels are held in two classes.  NEAR (no sample's primary hit at FAR_T
# or beyond, the sky aside): as the sphere frame, but a flipped sample moves a
# 16-spp pixel six times as far as a 100-spp one, hence PIXEL_ATOL_16 (found:
# 99.995 % within it, 99.88 % within 1e-2, 1.0e-4 on average).  FAR: a loose
# share within PIXEL_ATOL_16, the class's mean colour and, so that the class is
# held where it lies in the image and not only as a whole, the mean colour of
# the far pixels of every TILE x TILE block that holds at least TILE_MIN of
# them (a block's flipped samples average out as a pixel's cannot).
# The far bars come from six cameras over this scene (the frame's and
# EXTRA_CAMERAS), and the phase runs all six.  Found, on one H100: 5.4 % to 7.0 % of the far samples beyond 5e-2 (0.14 % to 0.44 % of
# the near ones); far pixels within PIXEL_ATOL_16 94.4 % to 96.7 %; class mean
# 2.3e-3 to 8.9e-3 apart; block means at most 4.5e-2 to 8.1e-2 apart, 5.2e-3 to
# 1.2e-2 on average.  The class means differ by far more than unbiased flips
# of that many samples would give (about 1e-4): fusing a*b+c shifts the side
# on which a far child ray starts systematically, and the default build traces
# 0.13 % to 0.41 % fewer rays than the plain version on every camera.  The bars
# stand at about twice the worst reading.
FAR_T = 20.0
PIXEL_ATOL_16 = 2.5e-1
NEAR_FRAC_1E2, NEAR_MEAN = 0.99, 1e-3
FAR_FRAC_16, FAR_MEAN = 0.90, 2e-2
TILE, TILE_MIN = 16, 64
FAR_TILE_MAX, FAR_TILE_MEAN = 1.6e-1, 2.5e-2


def far_tiles(img, ref, far):
    """Mean colour of the far pixels of each TILE x TILE block of two frames:
    the distance of the two, over the blocks with at least TILE_MIN of them."""
    pool = lambda x: torch.nn.functional.avg_pool2d(
        x.permute(2, 0, 1)[None], TILE, ceil_mode=True, count_include_pad=True)[0] * TILE * TILE
    w = far[..., None].to(img.dtype)
    n = pool(w)[0]
    keep = n >= TILE_MIN
    diff = ((pool(img * w) - pool(ref * w)) / n.clamp_min(1.0)).abs().amax(dim=0)[keep]
    if not diff.numel():
        return dict(tiles=0, mean_diff_max=0.0, mean_diff_mean=0.0)
    return dict(tiles=int(keep.sum()), mean_diff_max=float(diff.max()),
                mean_diff_mean=float(diff.mean()))


def compare_pixels_g(img, ref, far):
    """Per-pixel distances of two finished generic frames, by class."""
    err = (img - ref).abs().amax(dim=-1)
    near = ~far
    cls = lambda m: dict(
        pixels=int(m.sum()), within_atol_16=frac(err[m] <= PIXEL_ATOL_16),
        within_1e2=frac(err[m] <= 1e-2), within_1e3=frac(err[m] <= 1e-3),
        mean_abs_err=float(err[m].mean()), max_abs_err=float(err[m].max()),
        class_mean_diff=float((img[m].mean(dim=0) - ref[m].mean(dim=0)).abs().max()))
    return dict(near=cls(near), far=cls(far), far_tiles=far_tiles(img, ref, far),
                max_abs_err=float(err.max()), within_atol_16=frac(err <= PIXEL_ATOL_16))


def check_pixels_g(what, px):
    near, far = px["near"], px["far"]
    require(near["within_atol_16"] >= PIXEL_FRAC and near["within_1e2"] >= NEAR_FRAC_1E2
            and near["mean_abs_err"] < NEAR_MEAN,
            f"{what}: the near pixels of the default build's frame are off: {near}")
    require(far["within_atol_16"] >= FAR_FRAC_16 and far["class_mean_diff"] < FAR_MEAN,
            f"{what}: the far pixels of the default build's frame are off: {far}")
    tiles = px["far_tiles"]
    require(tiles["mean_diff_max"] < FAR_TILE_MAX and tiles["mean_diff_mean"] < FAR_TILE_MEAN,
            f"{what}: blocks of far pixels of the default build's frame are off: {tiles}")


def check_uber_g(size, plain_dropped, res, precise=None):
    require(plain_dropped == 0, f"plain version dropped rays at {size}")
    for r in (res, precise or res):
        require(r["finite"] and r["dropped"] == 0, f"generic uber output at {size}: {r}")
    require(precise is None
            or (precise["colour_within_1e4"] >= 0.999
                and precise["primary_t_within_rtol_1e4"] >= 0.999
                and precise["ray_count_rel_diff"] < 5e-4),
            f"generic uber -fmad=false build disagrees with the plain version at {size}: {precise}")
    require(res["primary_t_within_rtol_1e4"] >= 0.999
            and res["colour_within_1e4"] >= 0.85 and res["colour_within_5e2"] >= 0.97
            and res["mean_abs_diff"] < 5e-3 and res["ray_count_rel_diff"] < 5e-3,
            f"generic uber kernel disagrees with the plain version at {size}: {res}")


def uber_g_vs_plain(camera_name, acc, cam, st, cfg, modes=False):
    """Phase 9 on one camera: the generic instantiation, both builds, against
    the plain version per sample and per pixel; prints and checks; with
    ``modes``, also phase uber_modes on this frame.  -> (default build's
    numbers, -fmad=false build's, pixels vs plain, the plain version's
    milliseconds, its rays and image mean)."""
    size = f"{size_of(BVH1K)} camera {camera_name}"
    plain_ms, (out_p, stats_p) = timed_ms(lambda: uber.uber_render_plain(acc, cam, st))
    k1, got = compare_uber(acc, cam, st, out_p, stats_p)
    img_k = uber._uber_post(*got, cfg)["image"]
    # where the samples differ: by the distance of the primary hit
    far_s = (out_p[:, 3] >= FAR_T) & (out_p[:, 3] < 0.99 * cfg.t_max)
    near_s = (out_p[:, 3] < FAR_T)
    cerr = (got[0][:, :3] - out_p[:, :3]).abs().amax(dim=1)
    k1["samples_beyond_5e2_by_primary_hit"] = dict(
        nearer_than_far_t=frac(cerr[near_s] > 5e-2), far_t_or_beyond=frac(cerr[far_s] > 5e-2),
        share_of_samples_far=frac(far_s))
    del cerr, near_s
    with _build.precise():
        k1_precise, got = compare_uber(acc, cam, st, out_p, stats_p)
    img_precise = uber._uber_post(*got, cfg)["image"]
    img_p = uber._uber_post(out_p, stats_p, cfg)["image"]
    far = far_s.reshape(cfg.height, cfg.width, cfg.spp).any(dim=-1)
    px_plain = compare_pixels_g(img_k, img_p, far)
    px_precise = compare_pixels_g(img_k, img_precise, far)
    plain_frame = dict(rays=int(stats_p[uber.ST_RAYS]), image_mean=float(img_p.mean()))
    say(phase="uber_generic_vs_plain", size=size, samples=st.B,
        rays_plain=plain_frame["rays"], image_mean_plain=plain_frame["image_mean"],
        plain_seconds=plain_ms / 1e3,
        default_build=k1, precise_build=k1_precise, pixels_default_vs_plain=px_plain,
        pixels_default_vs_precise=px_precise, pixel_atol=PIXEL_ATOL_16, far_t=FAR_T)
    check_uber_g(size, int(stats_p[uber.ST_DROPPED]), k1, k1_precise)
    check_pixels_g(f"{size} against the plain version", px_plain)
    check_pixels_g(f"{size} against the -fmad=false build", px_precise)
    if modes:
        uber_modes_frame(f"bvh1k camera {camera_name}", acc, cam, st, cfg, out_p, stats_p,
                         generic=True, far=far)
    return k1, k1_precise, px_plain, plain_ms, plain_frame


def timed_frames(render):
    """One warm frame, then three timed -> (last frame, seconds, launch counts
    of every frame, each counted from 0)."""
    times, launches = [], []
    for frame_no in range(4):
        _build.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = render()
        torch.cuda.synchronize()
        if frame_no:
            times.append(time.perf_counter() - t0)
        launches.append(dict(_build.LAUNCHES))
    return out, times, launches


def parity(ou, oq):
    """The canary's numbers: persistent kernel's frame against the queue
    renderer's."""
    iu, iq = ou["image"], oq["image"]
    ru, rq = int(ou["rays"]), int(oq["rays"])
    ddiff = (ou["depth"].clamp_max(100.0) - oq["depth"].clamp_max(100.0)).abs()
    return dict(mean_image_diff=float((iu.mean(dim=(0, 1)) - iq.mean(dim=(0, 1))).abs().max()),
                frac_pixels_off_5e2=frac((iu - iq).abs().amax(dim=-1) > 5e-2),
                row_band_max_diff=float((iu.mean(dim=(1, 2)) - iq.mean(dim=(1, 2))).abs().max()),
                ray_count_ratio=ru / max(rq, 1),
                depth_disagree_frac=frac(ddiff > 1e-2),
                rays_dropped=int(ou["rays_dropped"]),
                queue_rays_dropped=int(oq["rays_dropped"]),
                finite=bool(torch.isfinite(iu).all() and torch.isfinite(iq).all()))


def check_parity(what, c, lights=False):
    """The canary's envelope: the reference's (bench.py:171-172: channel
    means, ray ratio, depth, drops) and under 3 % of pixels off by more than
    0.05.  With lights the pixel share is replaced by the JAX package's own
    lights bar, every row band's mean within 0.05: a sample whose shadow ray
    grazes the light's box turns on the last ulp (CORNER_RATIOS), and one
    turned sample moves its pixel by more than 0.05."""
    pixels = c["row_band_max_diff"] < 0.05 if lights else c["frac_pixels_off_5e2"] < 0.03
    require(c["finite"] and c["mean_image_diff"] < 5e-3 and pixels
            and abs(c["ray_count_ratio"] - 1.0) < 0.02 and c["depth_disagree_frac"] < 0.01
            and c["rays_dropped"] == 0 and c["queue_rays_dropped"] == 0,
            f"{what} failed: {c}")


def kernels_on_path(render, hooks):
    """Run ``render()`` with each launch function of ``hooks`` ({label:
    (module, name, bound_of)}) timed at every launch by CUDA events, the card
    kept busy while the host enqueues it, and charged ``bound_of(*args)`` ms
    (taken first: its counted launch fills the wrapper's per-table memos,
    which the timed launch then finds) -> {label: launches, summed ms and
    bound, their difference, the launches that read at or below their
    bound}."""
    got = {label: [] for label in hooks}
    reals = {label: getattr(module, name) for label, (module, name, _) in hooks.items()}

    def timed(label, bound_of):
        def launch(*args, **kw):
            held = {}
            bnd = bound_of(*args, **kw)
            events = gapless_events(lambda: held.update(out=reals[label](*args, **kw)))
            got[label].append((events, bnd))
            return held["out"]
        return launch

    for label, (module, name, bound_of) in hooks.items():
        setattr(module, name, timed(label, bound_of))
    try:
        render()
    finally:
        for label, (module, name, _) in hooks.items():
            setattr(module, name, reals[label])
    torch.cuda.synchronize()
    res = {}
    for label, calls in got.items():
        each = [(a.elapsed_time(b), bnd) for (a, b), bnd in calls]
        ms = sum(m for m, _ in each)
        bnd = sum(b for _, b in each)
        res[label] = dict(launches=len(calls), ms=ms, bound_ms=bnd, ms_above_bound=ms - bnd,
                          launches_at_or_below_bound=sum(m <= b for m, b in each))
    return res


def generic_phases(dev, iow, ptxas):
    """Phases 8 to 12 -> (the kernels-line entries of the generic slice, K3's
    (accel, rays) at the generic canary's lanes).
    ``iow``: the sphere scene, its camera, its small config, its canary lanes;
    ``ptxas``: the build's lines per kernel."""
    scene, camera = examples.bvh_grid_scene(side=32)
    scene, camera = scene.to(dev), camera.to(dev)
    cfg = RenderConfig(intersector="pallas", **BVH1K).for_scene(scene)
    cfg_s = RenderConfig(intersector="pallas", **SMALL).for_scene(scene)
    require(cfg.pallas_mode == "generic" and not cfg.has_dielectrics and not cfg.has_motion,
            f"the grid scene's statics: {cfg}")

    # 8. K3, K4, K5 against their plain versions on the frame's own tables and
    # rays: all 5 760 000 camera lanes and as many second-generation rays.
    acc3, cam_g = uber._scene_accel(scene, camera, cfg, GR)  # what K1 generic and K3 read
    acc5 = _build_accel(scene, cfg)  # the queue renderer's: groups of 32
    acc4 = _build_accel(scene, dataclasses.replace(cfg, pallas_groups=0))  # dense
    require(acc3.gkinds.count("s") == 8 and acc3.n_groups == 17 and acc3.n_sgroups == 3
            and acc5.group == 32 and acc4.group == 0,
            f"accels of the grid scene: {acc3.gkinds} {acc3.n_sgroups} {acc5.group}")
    lo, ld, ltr, _ = _lane_inputs(camera, cfg)
    lanes = sweep2.pack_rays(lo, ld, ltr, torch.full_like(ltr, cfg.t_max))
    del lo, ld, ltr
    lanes2 = second_generation_g(acc5, lanes)
    # plus the edge cases every version must agree on: dead rays, an
    # axis-parallel ray whose origin lies on a slab plane of the ground box
    # (its top, y = -1), and one that runs inside that plane's slab
    edge = lanes[:, :4].clone()
    edge[0:3] = torch.tensor([[-3.0, 5.0], [-1.0, -1.5], [-8.0, 2.0]], device=dev).repeat(1, 2)
    edge[3:6] = torch.tensor([[1.0, 0.0], [0.0, 0.0], [0.0, -1.0]], device=dev).repeat(1, 2)
    edge[3:6, 2:] = 0.0  # two dead rays
    batches = dict(camera_lanes=lanes, second_pop=lanes2, edge_cases=edge)
    sweeps = {}
    plain_ms = {}
    for batch, rr in batches.items():
        o, d, tr, tl = unpack(rr)
        plain_ms[batch, "sweep2g"], want3 = timed_ms(lambda: sweep2g.sweep2g_plain(acc3, rr))
        plain_ms[batch, "sweep_grouped"], want5 = timed_ms(lambda: sweep.sweep_grouped_plain(
            acc5.table, acc5.gaabb, rr, acc5.group, False, "generic"))
        plain_ms[batch, "sweep_nearest"], want4 = timed_ms(
            lambda: sweep.sweep_nearest_plain(acc4.table, "generic", rr))
        if batch == "edge_cases":
            # on the plane: a miss; inside the slab: the ground box from within
            require(want3[1].tolist()[2:] == [-1, -1] and int(want3[1][0]) == -1
                    and int(want3[1][1]) >= 0, f"edge cases of the plain sweep: {want3}")
            for w in (want3, want5, want4):
                say(phase="edge_cases_plain", t=w[0].tolist(), obj=w[1].tolist())
        sweeps[batch] = dict(
            sweep2g=both_builds("sweep2g", batch, lambda: sweep2g.sweep2g_nearest(
                acc3, o, d, tr, tl), want3, rr),
            sweep_grouped=both_builds("sweep_grouped", batch, lambda: sweep.sweep_grouped(
                acc5.table, acc5.gaabb, o, d, tr, tl, acc5.group, False, mode="generic"),
                want5, rr),
            sweep_nearest=both_builds("sweep_nearest", batch, lambda: sweep.sweep_nearest(
                acc4.table, "generic", o, d, tr, tl), want4, rr))
        # the three sweeps name the same object (each in its own row order)
        w3 = torch.where(want3[1] >= 0, acc3.perm[want3[1].clamp_min(0).long()], -1)
        w5 = torch.where(want5[1] >= 0, acc5.perm[want5[1].clamp_min(0).long()], -1)
        agree = dict(k3_k5=frac(w3 == w5), k4_k5=frac(want4[1] == w5))
        say(phase="sweeps_agree", batch=batch, **agree)
        require(min(agree.values()) >= 0.999 or batch == "edge_cases",
                f"the plain sweeps name different objects on {batch}: {agree}")
        del want3, want4, want5, w3, w5
    require(sweeps["second_pop"]["sweep2g"]["dead_rays"] > 0, "no dead lanes in the second pop")

    # the refractive-index sum on the grid's table (no glass: all 1) and on
    # the glass scene's, where the sum has work to do
    gl_scene, gl_cam = overlapping_glass_scene()
    gl_scene, gl_cam = gl_scene.to(dev), gl_cam.to(dev)
    cfg_gl = RenderConfig(intersector="pallas", pallas_groups=0, **GLASS).for_scene(gl_scene)
    require(cfg_gl.pallas_mode == "generic" and cfg_gl.has_dielectrics, f"glass scene: {cfg_gl}")
    acc_gl = _build_accel(gl_scene, cfg_gl)
    glo, gld, gltr, _ = _lane_inputs(gl_cam, cfg_gl)
    gl_lanes = sweep2.pack_rays(glo, gld, gltr, torch.full_like(gltr, cfg_gl.t_max))
    gl_lanes2 = second_generation_g(sweep.make_accel(gl_scene, "generic", group=4), gl_lanes)
    pts_grid = probe_points(acc5, lanes)
    ri_grid = compare_ri("sweep_ri", "grid_hit_points", acc4.table, "generic", pts_grid)
    say(phase="sweep_ri_grid_hit_points", points=pts_grid.shape[1],
        note="the grid has no glass, but its objects carry the builder's default refractive "
             "index 1.5 (refractivity 0), so none of them is an air row: the sum walks all "
             "1 025 live rows, each behind its bounding sphere; the glass scenes are its measure",
        rows_walked=int(sweep.ri_rows(acc4.table, "generic")[0].shape[0]),
        **k4_counts(k4_run("ri", acc4.table, "generic", pts_grid)[1]))
    ri_glass = {}
    for batch, rr in dict(glass_lanes=gl_lanes, glass_second_pop=gl_lanes2).items():
        ri_glass[batch] = compare_ri("sweep_ri", batch, acc_gl.table, "generic",
                                     probe_points(acc_gl, rr))
        o, d, tr, tl = unpack(rr)
        both_builds("sweep_nearest", batch, lambda: sweep.sweep_nearest(
            acc_gl.table, "generic", o, d, tr, tl),
            sweep.sweep_nearest_plain(acc_gl.table, "generic", rr), rr)
    # points spread through the glass bodies' volume: many lie inside one or both
    vol = seeded_rays((0.2, 0.0, -3.5), 0.9, 100_000, dev, n_dead=0)
    ri_glass["glass_volume"] = compare_ri("sweep_ri", "glass_volume", acc_gl.table, "generic",
                                          torch.cat([vol[0:3], vol[6:7]]).contiguous())
    require(ri_glass["glass_volume"]["not_one"] > 0.05,
            f"the glass scene's refractive-index sums are all 1: {ri_glass}")

    # ... and the sphere-mode instantiations, on the sphere scene's tables and
    # its canary's lanes (the path of pallas_v2=False)
    i_scene, i_cam, i_cfg, i_lanes = iow
    i_lanes2 = second_generation(_build_accel(i_scene, i_cfg), i_lanes)
    s_dense = sweep.make_accel(i_scene, "spheres", group=0)
    s_grp = sweep.make_accel(i_scene, "spheres", group=32)
    spheres = {}
    for batch, rr in dict(sphere_lanes=i_lanes, sphere_second_pop=i_lanes2).items():
        o, d, tr, tl = unpack(rr)
        plain_ms[batch, "sweep_nearest_ri"], want = timed_ms(
            lambda: sweep.sweep_nearest_ri_plain(s_dense.table, rr))
        spheres[batch] = both_builds("sweep_nearest_ri", batch, lambda: sweep.sweep_nearest_ri(
            s_dense.table, o, d, tr, tl), want, rr)
        both_builds("sweep_nearest_spheres", batch, lambda: sweep.sweep_nearest(
            s_dense.table, "spheres", o, d, tr, tl),
            sweep.sweep_nearest_plain(s_dense.table, "spheres", rr), rr)
        for with_ri in (False, True):
            both_builds(f"sweep_grouped_spheres_ri{int(with_ri)}", batch,
                        lambda: sweep.sweep_grouped(s_grp.table, s_grp.gaabb, o, d, tr, tl, 32,
                                                    with_ri, mode="spheres"),
                        sweep.sweep_grouped_plain(s_grp.table, s_grp.gaabb, rr, 32, with_ri,
                                                  "spheres"), rr)
        compare_ri("sweep_ri_spheres", batch, s_dense.table, "spheres",
                   probe_points(s_dense, rr))
    # the fused refractive index where it is not 1: rays from inside nested glass
    nest = nested_glass_spheres().to(dev)
    n_dense = sweep.make_accel(nest, "spheres", group=0)
    n_grp = sweep.make_accel(nest, "spheres", group=4)
    nest_rays = seeded_rays((0.0, 0.0, -3.0), 0.45, 100_000, dev)
    # ... and inside deep_glass_spheres(), where a point lies in up to four
    deep, _ = deep_glass_spheres()
    deep = deep.to(dev)
    d_dense = sweep.make_accel(deep, "spheres", group=0)
    d_grp = sweep.make_accel(deep, "spheres", group=4)
    deep_rays = seeded_rays(DEEP_CENTRE, 0.14, 1 << 16, dev)
    for batch, (dense, grp, rr) in dict(nested_glass=(n_dense, n_grp, nest_rays),
                                        deep_glass=(d_dense, d_grp, deep_rays)).items():
        o, d, tr, tl = unpack(rr)
        spheres[batch] = both_builds(
            "sweep_nearest_ri", batch, lambda: sweep.sweep_nearest_ri(
                dense.table, o, d, tr, tl), sweep.sweep_nearest_ri_plain(dense.table, rr), rr)
        both_builds("sweep_grouped_spheres_ri1", batch, lambda: sweep.sweep_grouped(
            grp.table, grp.gaabb, o, d, tr, tl, 4, True, mode="spheres"),
            sweep.sweep_grouped_plain(grp.table, grp.gaabb, rr, 4, True, "spheres"), rr)
        require(spheres[batch]["ri_not_one"] > 0.05,
                f"no fused refractive index differs from 1: {spheres[batch]}")

    # 9. K1 generic against its plain version, at the frame's own statics, from
    # the frame's camera and from five more ---------------------------------------
    st = uber.UberStatics.from_cfg(cfg)
    k1, k1_precise, px_plain, plain_ms_k1, plain_frame = uber_g_vs_plain(
        "frame", acc3, cam_g, st, cfg, modes=True)
    for name, kw in EXTRA_CAMERAS.items():
        cam_x = Camera.make(kw["origin"], kw["direction"], fov_y_deg=60.0, focus_dist=8.0).to(dev)
        uber_g_vs_plain(name, *uber._scene_accel(scene, cam_x, cfg, GR), st, cfg)

    # ... and with the rotated containment probe, on the glass scene
    acc_glu, cam_glu = uber._scene_accel(gl_scene, gl_cam, cfg_gl, 8)
    require(acc_glu.n_pgroups == 1, f"the glass scene's probe rows were cut: {acc_glu.n_pgroups}")
    st_gl = uber.UberStatics.from_cfg(cfg_gl)
    out_p, stats_p = uber.uber_render_plain(acc_glu, cam_glu, st_gl)
    k1_gl, _ = compare_uber(acc_glu, cam_glu, st_gl, out_p, stats_p)
    with _build.precise():
        k1_gl_precise, _ = compare_uber(acc_glu, cam_glu, st_gl, out_p, stats_p)
    say(phase="uber_generic_vs_plain", size=size_of(GLASS) + " glass", samples=st_gl.B,
        rays_plain=int(stats_p[uber.ST_RAYS]), default_build=k1_gl, precise_build=k1_gl_precise)
    check_uber_g(size_of(GLASS) + " glass", int(stats_p[uber.ST_DROPPED]), k1_gl, k1_gl_precise)
    del out_p

    # 10. generic canaries: each path's launches counted from 0 ----------------
    _build.reset_launches()
    ou = uber.render_uber(scene, camera, cfg_s, gr=GR)
    oq = render_stats(scene, camera, cfg_s)
    launches_canary = dict(_build.LAUNCHES)
    canary = parity(ou, oq)
    say(phase="generic_canary", scene="bvh_grid_scene(side=32)", size=size_of(SMALL),
        launches=launches_canary, **canary)
    check_parity("generic canary", canary)
    require(launches_canary.get("uber_g") == 1 and launches_canary.get("sweep_grouped", 0) > 0
            and set(launches_canary) == {"uber_g", "sweep_grouped"},
            f"the generic canary's launches: {launches_canary}")

    # K3 through its own entry point on the canary's lanes, against K5's
    # winners (K3's consumer in the product is the differentiable fast path,
    # diff/fastpath.py::_winner, which the gradient phases drive)
    acc3_s, _ = uber._scene_accel(scene, camera, cfg_s, GR)
    clo, cld, cltr, _ = _lane_inputs(camera, cfg_s)
    ctl = torch.full_like(cltr, cfg_s.t_max)
    _build.reset_launches()
    t3, obj3 = sweep2g.sweep2g_nearest(acc3_s, clo, cld, cltr, ctl)
    launches_k3 = dict(_build.LAUNCHES)
    obj5 = sweep.occluded_nearest_obj_pallas(acc5, scene, clo, cld, cltr, ctl)
    orig3 = torch.where(obj3 >= 0, acc3_s.perm[obj3.clamp_min(0).long()], -1)
    k3_entry = dict(same_winner_as_sweep_grouped=frac(orig3 == obj5), hit_frac=frac(obj3 >= 0),
                    launches=launches_k3)
    say(phase="sweep2g_entry", rays=clo.shape[0], **k3_entry)
    require(k3_entry["same_winner_as_sweep_grouped"] >= 0.999 and launches_k3 == {"sweep2g": 1},
            f"sweep2g_nearest against the grouped sweep: {k3_entry}")

    # the dense sweeps (pallas_groups=0) on the glass scene: K4's two kernels
    _build.reset_launches()
    ou = uber.render_uber(gl_scene, gl_cam, cfg_gl, gr=GR)
    oq = render_stats(gl_scene, gl_cam, cfg_gl)
    launches_glass = dict(_build.LAUNCHES)
    glass = parity(ou, oq)
    say(phase="generic_canary", scene="overlapping glass, dense sweeps", size=size_of(GLASS),
        launches=launches_glass, **glass)
    check_parity("glass canary", glass)
    require(launches_glass.get("uber_g") == 1 and launches_glass.get("sweep_nearest", 0) > 0
            and launches_glass.get("sweep_ri", 0) > 0
            and set(launches_glass) == {"uber_g", "sweep_nearest", "sweep_ri"},
            f"the glass canary's launches: {launches_glass}")

    # K4 and K5 at the shapes their driven paths give them: every launch of
    # the glass canary's dense sweeps and of the grid canary's grouped sweep
    glass_nearest, glass_ri = K4Path("nearest"), K4Path("ri")
    driven = kernels_on_path(lambda: render_stats(gl_scene, gl_cam, cfg_gl), dict(
        sweep_nearest=(sweep, "_launch_nearest", glass_nearest),
        sweep_ri=(sweep, "_launch_ri", glass_ri)))
    driven["sweep_nearest"] = glass_nearest.summary(driven["sweep_nearest"])
    driven["sweep_ri"] = glass_ri.summary(driven["sweep_ri"])
    driven.update(kernels_on_path(lambda: render_stats(scene, camera, cfg_s), dict(
        sweep_grouped=(sweep, "_launch_grouped", k5_bound_of_launch))))
    st3c = torch.zeros(sweep2g.GC_LEN, dtype=torch.int64, device=dev)
    lanes3 = sweep2g.pack_rays(clo, cld, cltr, ctl)
    sweep2g._sweep2g(acc3_s, lanes3, st3c)
    driven["sweep2g"] = dict(
        launches=launches_k3["sweep2g"], ms=cuda_ms(lambda: sweep2g._sweep2g(acc3_s, lanes3), 10),
        bound_ms=k3_nearest_bound(acc3_s, lanes3.shape[1], st3c)[0], **k3_simt(st3c))
    driven["sweep2g"]["ms_above_bound"] = driven["sweep2g"]["ms"] - driven["sweep2g"]["bound_ms"]
    # the first-generation sweeps on the sphere scene (pallas_v2=False): the
    # fused nearest + refractive index kernel, dense and grouped, every pop
    cfg_v1 = dataclasses.replace(i_cfg, pallas_v2=False, spp=2)
    driven["first_generation_dense"] = kernels_on_path(
        lambda: render_stats(i_scene, i_cam, dataclasses.replace(cfg_v1, pallas_groups=0)),
        dict(sweep_nearest_ri=(sweep, "_launch_nearest_ri", k4_nri_bound_of_launch)))[
        "sweep_nearest_ri"]
    driven["first_generation_grouped"] = kernels_on_path(
        lambda: render_stats(i_scene, i_cam, dataclasses.replace(cfg_v1, pallas_groups=32)),
        dict(sweep_grouped=(sweep, "_launch_grouped", k5_bound_of_launch)))["sweep_grouped"]
    say(phase="driven_paths", what="K3, K4 and K5 at the shapes their driven paths give them",
        paths=dict(sweep_nearest="glass canary", sweep_ri="glass canary",
                   sweep_grouped="grid canary", sweep2g="its entry point at the canary's lanes",
                   first_generation_dense="sweep_nearest_ri on the sphere scene, every pop",
                   first_generation_grouped="sweep_grouped (spheres, fused RI), every pop"),
        **driven)
    require(all(r["ms"] > r["bound_ms"] for r in driven.values())
            and driven["sweep_nearest"]["launches_at_or_below_bound"] == 0
            and driven["sweep_ri"]["launches_at_or_below_bound"] == 0,
            f"a kernel below its bound on its driven path, a counting error: {driven}")
    o_v2 = render_stats(i_scene, i_cam, dataclasses.replace(i_cfg, spp=2))
    launches_v1, pops_v1 = {}, {}
    for groups in (0, 32):
        _build.reset_launches()
        with launches_of(sweep, "_launch_grouped" if groups else "_launch_nearest_ri") as got:
            o_v1 = render_stats(i_scene, i_cam, dataclasses.replace(cfg_v1, pallas_groups=groups))
        launches_v1[groups] = dict(_build.LAUNCHES)
        pops_v1[groups] = got
        v1 = parity(o_v1, o_v2)
        say(phase="first_generation_spheres", pallas_groups=groups,
            launches=launches_v1[groups], **v1)
        check_parity(f"first-generation sphere sweeps, groups={groups}", v1)
    require(launches_v1[0].get("sweep_nearest_ri", 0) > 0 and set(launches_v1[0]) == {"sweep_nearest_ri"}
            and launches_v1[32].get("sweep_grouped", 0) > 0 and set(launches_v1[32]) == {"sweep_grouped"},
            f"the first-generation sphere path's launches: {launches_v1}")

    # K5's schedules and K4's splits bit for bit on every input above, and K4
    # at the camera lanes of the sphere scene's 800x450x16 frame
    cfg_i16 = RenderConfig(intersector="pallas", **BVH1K).for_scene(i_scene)
    ilo, ild, iltr, _ = _lane_inputs(i_cam, cfg_i16)
    iow_lanes = sweep2.pack_rays(ilo, ild, iltr, torch.full_like(iltr, cfg_i16.t_max))
    del ilo, ild, iltr
    generic5 = lambda rr: (acc5.table, acc5.gaabb, rr, acc5.group, False, "generic")  # noqa: E731
    k5_in = {"grid canary lanes": generic5(lanes3), "bvh1k camera lanes": generic5(lanes),
             "bvh1k second pop": generic5(lanes2), "edge cases": generic5(edge),
             "sphere lanes": (s_grp.table, s_grp.gaabb, i_lanes, 32, False, "spheres"),
             "sphere lanes, RI": (s_grp.table, s_grp.gaabb, i_lanes, 32, True, "spheres"),
             "sphere second pop, RI": (s_grp.table, s_grp.gaabb, i_lanes2, 32, True, "spheres"),
             "nested glass": (n_grp.table, n_grp.gaabb, nest_rays, 4, True, "spheres"),
             "deep glass": (d_grp.table, d_grp.gaabb, deep_rays, 4, True, "spheres"),
             **{f"first_generation_grouped pop {k + 1}": args
                for k, args in enumerate(pops_v1[32])}}
    k4_in = {"sphere lanes": (s_dense.table, i_lanes), "sphere second pop": (s_dense.table, i_lanes2),
             "nested glass": (n_dense.table, nest_rays), "deep glass": (d_dense.table, deep_rays),
             "iow camera lanes 800x450x16": (s_dense.table, iow_lanes),
             **{f"first_generation_dense pop {k + 1}": args for k, args in enumerate(pops_v1[0])}}
    k45_modes(k5_in, k4_in)
    del k5_in, k4_in

    # 11. the generic frame ------------------------------------------------------
    torch.cuda.reset_peak_memory_stats()
    out, times, launches_frames = timed_frames(
        lambda: uber.render_uber(scene, camera, cfg, gr=GR))
    img = out["image"]
    rays, dropped = int(out["rays"]), int(out["rays_dropped"])
    frame = dict(scene="bvh_grid_scene(side=32)", size=size_of(BVH1K),
                 seconds_per_frame_min=min(times), seconds_per_frame_mean=sum(times) / len(times),
                 rays=rays, mrays_per_s=rays / min(times) / 1e6, rays_dropped=dropped,
                 image_mean=float(img.mean()), launches_per_frame=launches_frames,
                 peak_memory_bytes=torch.cuda.max_memory_allocated())
    say(phase="bvh1k", **frame)
    require(tuple(img.shape) == (cfg.height, cfg.width, 3), f"image shape {img.shape}")
    require(bool(torch.isfinite(img).all()) and bool(torch.isfinite(out["depth"]).all()),
            "the generic frame is not finite")
    require(dropped == 0, f"the generic frame dropped rays: {frame}")
    require(abs(plain_frame["rays"] - BVH1K_RAYS) / BVH1K_RAYS < 1e-4
            and abs(plain_frame["image_mean"] - BVH1K_MEAN) < 2e-3,
            f"the plain version's generic frame moved: {plain_frame}")
    require(abs(rays - BVH1K_RAYS) / BVH1K_RAYS < 0.02, f"generic frame ray count: {frame}")
    require(abs(frame["image_mean"] - plain_frame["image_mean"]) < 1e-2,
            f"generic frame image mean: {frame} against the plain version's {plain_frame}")
    for got in launches_frames:
        require(got == {"uber_g": 1},
                f"a generic frame is one launch of the persistent kernel: {launches_frames}")
    # ... and the same frame through the bvh workload's own path, against it
    bvh_queue, launches_q, oq_k5 = bvh_queue_frame(scene, camera, cfg, out)
    k5_grid_sweep = k5_coop_sweep("grid canary", lambda: render_stats(scene, camera, cfg_s))
    # ... and the two frames that drive K4's dense kernels at full width
    dense_f, launches_dense, dense_pops = dense_generic_frame(scene, camera, cfg, oq_k5)
    del oq_k5
    glass_f, launches_gg, glass_pops = glass_grid_frame(dev)
    frames12 = dict(dense_generic_frame=dense_f["sweep_nearest"],
                    glass_grid_frame_sweep_ri=glass_f["sweep_ri"],
                    glass_grid_frame_sweep_grouped=glass_f["sweep_grouped"])
    say(phase="driven_paths", what="K4's dense kernels and K5 on the twelfth slice's frames",
        paths=dict(dense_generic_frame="sweep_nearest, every pop",
                   glass_grid_frame="sweep_grouped and sweep_ri, every pop"), **frames12)
    require(all(r["ms"] > r["bound_ms"] for r in frames12.values())
            and all(frames12[k]["launches_at_or_below_bound"] == 0
                    for k in ("dense_generic_frame", "glass_grid_frame_sweep_ri")),
            f"a kernel below its bound on the twelfth slice's frames: {frames12}")
    # K4's dense kernels in every split, bit for bit, on every input above
    k4_generic = lambda table, rr: (table, "generic", rr)  # noqa: E731
    k4_nearest_in = {
        "glass lanes": k4_generic(acc_gl.table, gl_lanes),
        "glass second pop": k4_generic(acc_gl.table, gl_lanes2),
        "bvh1k camera lanes": k4_generic(acc4.table, lanes),
        "bvh1k second pop": k4_generic(acc4.table, lanes2),
        "edge cases": k4_generic(acc4.table, edge),
        **{f"dense_generic_frame pop {k + 1}": args for k, args in enumerate(dense_pops)},
        "sphere lanes": (s_dense.table, "spheres", i_lanes),
        "sphere second pop": (s_dense.table, "spheres", i_lanes2),
        "deep glass": (d_dense.table, "spheres", deep_rays)}
    deep_pts = probe_points(d_dense, deep_rays)
    k4_ri_in = {
        "glass lanes": k4_generic(acc_gl.table, probe_points(acc_gl, gl_lanes)),
        "glass second pop": k4_generic(acc_gl.table, probe_points(acc_gl, gl_lanes2)),
        "glass volume": k4_generic(acc_gl.table, torch.cat([vol[0:3], vol[6:7]]).contiguous()),
        "grid hit points": k4_generic(acc4.table, pts_grid),
        **{f"glass_grid_frame pop {k + 1}": args for k, args in enumerate(glass_pops)},
        "deep glass points": (d_dense.table, "spheres", deep_pts),
        "deep glass volume": (d_dense.table, "spheres",
                              torch.cat([deep_rays[0:3], deep_rays[6:7]]).contiguous())}
    k4_modes = k4_dense_modes(k4_nearest_in, k4_ri_in)
    require(k4_modes["K4 ri deep glass volume"]["ri_not_one"] > 0.5,
            f"the deep glass points lie in no glass: {k4_modes['K4 ri deep glass volume']}")
    del k4_nearest_in, k4_ri_in, dense_pops

    # 12. the kernels at the main path's shapes ----------------------------------
    ms_k1 = cuda_ms(lambda: uber.uber_render(acc3, cam_g, st), 3)
    with coop(1):
        ms_k1_lane = cuda_ms(lambda: uber.uber_render(acc3, cam_g, st), 3)
    sweep_k1 = coop_sweep("bvh1k", acc3, cam_g, st)
    with _build.precise():
        ms_k1_precise = cuda_ms(lambda: uber.uber_render(acc3, cam_g, st), 3)
    t0 = time.perf_counter()
    for _ in range(3):
        uber._scene_accel(scene, camera, cfg, GR)
    torch.cuda.synchronize()
    accel_ms = (time.perf_counter() - t0) / 3 * 1e3
    out_h, stats_h = uber.uber_render(acc3, cam_g, st)
    post_ms = cuda_ms(lambda: uber._uber_post(out_h, stats_h, cfg), 3)
    n_nodes, n_hits = int(stats_h[uber.ST_RAYS]), int(stats_h[uber.ST_HITS])
    s_rows, o_rows = int(stats_h[uber.ST_SPHERE_TESTS]), int(stats_h[uber.ST_OTHER_TESTS])
    n_slab = int(stats_h[uber.ST_SLAB_TESTS])
    del out_h
    say(phase="bvh1k_breakdown", kernel_ms=ms_k1, kernel_ms_per_lane_mode=ms_k1_lane,
        kernel_ms_precise_build=ms_k1_precise,
        accel_build_ms=accel_ms, epilogue_ms=post_ms, frame_ms=min(times) * 1e3,
        nodes=n_nodes, hits=n_hits, live_sphere_rows_per_node=s_rows / n_nodes,
        live_cuboid_rows_per_node=o_rows / n_nodes, slab_tests_per_node=n_slab / n_nodes,
        **simt(stats_h))
    k1_bytes = 16 * st.B + accel_bytes(acc3) + 4 * uber.CAM_LEN
    k1_flops = (s_rows * FLOPS_PER_CENSUS_SPHERE_ROW + o_rows * FLOPS_PER_CENSUS_CUBOID_ROW
                + n_slab * FLOPS_PER_SLAB_TEST + n_hits * FLOPS_PER_REFINE_G
                + n_nodes * FLOPS_PER_NODE_SHADE)
    k1_bound, k1_by = bound(k1_bytes, k1_flops)

    B = lanes.shape[1]
    o, d, tr, tl = unpack(lanes)
    # K3: counted slab tests and live rows by kind
    st3 = torch.zeros(sweep2g.GC_LEN, dtype=torch.int64, device=dev)
    sweep2g._sweep2g(acc3, lanes, st3)
    ms_k3 = cuda_ms(lambda: sweep2g._sweep2g(acc3, lanes), 10)
    with coop(1):  # the walk of one thread per ray, in the same call
        ms_k3_lane = cuda_ms(lambda: sweep2g._sweep2g(acc3, lanes), 10)
        st3_lane = torch.zeros_like(st3)
        sweep2g._sweep2g(acc3, lanes, st3_lane)
    k3_bound, k3_by = k3_nearest_bound(acc3, B, st3)
    # K5: every group's box is tested by every ray; live rows counted
    _, st5 = k5_run(*generic5(lanes))
    ms_k5 = cuda_ms(lambda: sweep.sweep_grouped(acc5.table, acc5.gaabb, o, d, tr, tl, 32, False,
                                                mode="generic"), 10)
    with coop(1):  # the walk of one thread per ray, in the same call
        ms_k5_lane = cuda_ms(lambda: sweep._sweep_grouped(*generic5(lanes)), 10)
        _, st5_lane = k5_run(*generic5(lanes))
    _, st5_2 = k5_run(*generic5(lanes2))
    ms_k5_2 = cuda_ms(lambda: sweep._sweep_grouped(*generic5(lanes2)), 10)
    n_g5 = acc5.gaabb.shape[0]
    k5_bnd, k5_by = k5_bound(acc5.table, acc5.gaabb, lanes, False, "generic", st5)
    # K4: each ray pre-tests every row and fully tests those within its
    # bounding sphere; the RI sum at the glass grid frame's first probe points
    # (the grid's own hit points are printed above)
    n4 = acc4.table.shape[0]
    live4 = int((acc4.table[:, sweep.G_VALID] > 0).sum())
    ms_k4 = cuda_ms(lambda: sweep.sweep_nearest(acc4.table, "generic", o, d, tr, tl), 5)
    _, st4 = k4_run("nearest", acc4.table, "generic", lanes)
    k4_b = k4_bound("nearest", acc4.table, "generic", lanes, st4)
    ms_k4_split = {k: cuda_ms(lambda: sweep._launch_nearest(acc4.table, "generic", lanes, k), 3)
                   for k in sweep.NRI_SPLITS}
    ri_table, _, ri_pts = glass_pops[0]
    Bri, nri4 = ri_pts.shape[1], ri_table.shape[0]
    ms_ri = cuda_ms(lambda: sweep._launch_ri(ri_table, "generic", ri_pts), 5)
    _, st_ri = k4_run("ri", ri_table, "generic", ri_pts)
    ri_b = k4_bound("ri", ri_table, "generic", ri_pts, st_ri)
    ms_ri_split = {k: cuda_ms(lambda: sweep._launch_ri(ri_table, "generic", ri_pts, k), 3)
                   for k in sweep.NRI_SPLITS}
    plain_ms["glass_grid_pop_1", "sweep_ri"], _ = timed_ms(
        lambda: sweep.sweep_ri_plain(ri_table, "generic", ri_pts))
    # the fused sphere kernel at the sphere canary's lanes
    io, id_, itr, itl = unpack(i_lanes)
    Bi, ni = i_lanes.shape[1], s_dense.table.shape[0]
    live_i = int((s_dense.table[:, sweep.S_VALID] > 0).sum())
    ms_nri = cuda_ms(lambda: sweep.sweep_nearest_ri(s_dense.table, io, id_, itr, itl), 20)
    nri_bound, nri_by = k4_nri_bound(s_dense.table, i_lanes)
    nri_by_split = {k: cuda_ms(lambda: sweep._launch_nearest_ri(s_dense.table, i_lanes, k), 20)
                    for k in sweep.NRI_SPLITS}
    nri_wide = dict(rays=iow_lanes.shape[1], split=sweep.nearest_ri_split(iow_lanes.shape[1]),
                    ms=cuda_ms(lambda: sweep._launch_nearest_ri(s_dense.table, iow_lanes), 5),
                    bound_ms=k4_nri_bound(s_dense.table, iow_lanes)[0])
    say(phase="sweeps_at_the_frames_lanes", rays=B,
        sweep2g=dict(ms=ms_k3, ms_per_lane_mode=ms_k3_lane,
                     slab_tests_per_ray=int(st3[sweep2g.GC_SLAB]) / B,
                     live_sphere_rows_per_ray=int(st3[sweep2g.GC_SPHERE_ROWS]) / B,
                     live_cuboid_rows_per_ray=int(st3[sweep2g.GC_OTHER_ROWS]) / B,
                     **k3_simt(st3), per_lane_mode=k3_simt(st3_lane)),
        sweep_grouped=dict(ms=ms_k5, ms_per_lane_mode=ms_k5_lane,
                           live_rows_per_ray=int(st5[sweep.SC_ROWS]) / B, groups=n_g5,
                           **k5_simt(st5), per_lane_mode=k5_simt(st5_lane),
                           second_pop=dict(ms=ms_k5_2, bound_ms=k5_bound(
                               acc5.table, acc5.gaabb, lanes2, False, "generic", st5_2)[0],
                               **k5_simt(st5_2))),
        sweep_nearest=dict(ms=ms_k4, live_rows_per_ray=live4, table_rows=n4,
                           split=sweep.nearest_ri_split(B), ms_by_split=ms_k4_split,
                           **k4_b, **k4_counts(st4)),
        sweep_ri=dict(ms=ms_ri, at="the glass grid frame's first pop", points=Bri,
                      table_rows=nri4, rows_walked=int(sweep.ri_rows(ri_table, "generic")[0]
                                                     .shape[0]),
                      split=sweep.nearest_ri_split(Bri), ms_by_split=ms_ri_split,
                      **ri_b, **k4_counts(st_ri)),
        sweep_nearest_ri=dict(ms=ms_nri, live_rows_per_ray=live_i, table_rows=ni,
                              split=sweep.nearest_ri_split(Bi), ms_by_split=nri_by_split,
                              at_iow_camera_lanes=nri_wide))

    paths = dict(generic_canary=launches_canary, sweep2g_entry=launches_k3,
                 glass_canary=launches_glass, first_generation_dense=launches_v1[0],
                 first_generation_grouped=launches_v1[32], bvh1k_frame=launches_frames[-1],
                 bvh_queue_frame=launches_q, dense_generic_frame=launches_dense,
                 glass_grid_frame=launches_gg)
    by_path = lambda name: {p: got.get(name, 0) for p, got in paths.items()}
    main = sweeps["camera_lanes"]
    tol = ("same winner as the plain version on >= 99.9 % of rays, t within rtol 1e-4 on "
           ">= 99 % of the agreeing hits; the -fmad=false build on >= 99.9 %")
    src = "raytracing_tests_tpu_torch/csrc/"
    jax_src = "raytracing_tests_tpu/kernels/"
    entry = lambda name, source, replaces, launches, res, **kw: dict(
        name=name, route="cuda", source=src + source, replaces=jax_src + replaces,
        launches=launches, launches_by_path=by_path(name), max_abs_err=res["t_max_abs_err"],
        tolerance=tol, frac_within_tolerance=min(res["same_obj"], res["t_within_rtol_1e4"]),
        library_ms=None, **kw)
    return [
        dict(name="uber_render_generic", route="cuda", source=src + "uber.cu",
             replaces=jax_src + "uber.py:874", launches=launches_frames[-1].get("uber_g", 0),
             launches_by_path=by_path("uber_g"), max_abs_err=px_plain["max_abs_err"],
             tolerance=f"finished 16-spp image within {PIXEL_ATOL_16} of the plain version's "
                       f"on >= {PIXEL_FRAC} of the pixels whose primary hits lie nearer than "
                       f"{FAR_T}, {NEAR_MEAN} on average; the farther pixels by their mean "
                       f"colour within {FAR_MEAN}; per sample as the sphere instantiation",
             frac_within_tolerance=px_plain["near"]["within_atol_16"],
             per_sample_max_abs_err=k1["colour_max_abs_err"],
             per_sample_frac_within_1e4=k1["colour_within_1e4"],
             per_sample_frac_within_1e4_precise_build=k1_precise["colour_within_1e4"],
             ms=ms_k1, ms_per_lane_mode=ms_k1_lane, plain_ms=plain_ms_k1, bound_ms=k1_bound,
             bound_by=k1_by, simt_efficiency=simt(stats_h)["simt_efficiency"],
             simt_efficiency_per_lane_mode=sweep_k1["1"]["simt_efficiency"],
             library_ms=None, shape=size_of(BVH1K) + ", 1025 objects, gr=64"),
        entry("sweep2g", "sweep2g.cu", "sweep2g.py:838", launches_k3.get("sweep2g", 0),
              main["sweep2g"], ms=ms_k3, ms_per_lane_mode=ms_k3_lane,
              plain_ms=plain_ms["camera_lanes", "sweep2g"], bound_ms=k3_bound, bound_by=k3_by,
              simt_efficiency=k3_simt(st3)["simt_efficiency"],
              simt_efficiency_per_lane_mode=k3_simt(st3_lane)["simt_efficiency"],
              shape=f"{B} rays, 17 groups of 64", at_driven_path=driven["sweep2g"]),
        entry("sweep_nearest", "sweep.cu", "sweep.py:535", launches_dense.get("sweep_nearest", 0),
              main["sweep_nearest"], ms=ms_k4, plain_ms=plain_ms["camera_lanes", "sweep_nearest"],
              bound_ms=k4_b["bound_ms"], bound_by=k4_b["bound_by"],
              dense_bound_ms=k4_b["dense_bound_ms"], culled_bound_ms=k4_b["culled_bound_ms"],
              split=sweep.nearest_ri_split(B), ms_by_split=ms_k4_split, counters=k4_counts(st4),
              shape=f"{B} rays x {n4} generic rows", at_driven_path=driven["sweep_nearest"],
              at_dense_generic_frame=dense_f["sweep_nearest"],
              ptxas={k: ptxas.get(k) for k in K4_DENSE_INSTANTIATIONS if "nearest_kernel" in k}),
        dict(name="sweep_ri", route="cuda", source=src + "sweep.cu",
             replaces=jax_src + "sweep.py:535", launches=launches_gg.get("sweep_ri", 0),
             launches_by_path=by_path("sweep_ri"), max_abs_err=max(
                 ri_grid["max_abs_err"], *(r["max_abs_err"] for r in ri_glass.values())),
             tolerance="equal to the plain version on >= 99.9 % of the points",
             frac_within_tolerance=min(ri_grid["equal"], *(r["equal"] for r in ri_glass.values())),
             ms=ms_ri, plain_ms=plain_ms["glass_grid_pop_1", "sweep_ri"],
             bound_ms=ri_b["bound_ms"], bound_by=ri_b["bound_by"],
             dense_bound_ms=ri_b["dense_bound_ms"], culled_bound_ms=ri_b["culled_bound_ms"],
             split=sweep.nearest_ri_split(Bri), ms_by_split=ms_ri_split,
             counters=k4_counts(st_ri), library_ms=None,
             shape=f"{Bri} points x {nri4} generic rows (the glass grid frame's first pop)",
             at_driven_path=driven["sweep_ri"], at_glass_grid_frame=glass_f["sweep_ri"],
             ptxas={k: ptxas.get(k) for k in K4_DENSE_INSTANTIATIONS if "ri_kernel" in k}),
        entry("sweep_nearest_ri", "sweep.cu", "sweep.py:535",
              launches_v1[0].get("sweep_nearest_ri", 0), spheres["sphere_lanes"], ms=ms_nri,
              plain_ms=plain_ms["sphere_lanes", "sweep_nearest_ri"], bound_ms=nri_bound,
              bound_by=nri_by, shape=f"{Bi} rays x {ni} sphere rows",
              split=sweep.nearest_ri_split(Bi), ms_by_split=nri_by_split,
              at_iow_camera_lanes=nri_wide, at_driven_path=driven["first_generation_dense"],
              ptxas={k: ptxas.get(k) for k in K4_NRI_INSTANTIATIONS}),
        entry("sweep_grouped", "sweep.cu", "sweep.py:590", launches_canary.get("sweep_grouped", 0),
              main["sweep_grouped"], ms=ms_k5, ms_per_lane_mode=ms_k5_lane,
              plain_ms=plain_ms["camera_lanes", "sweep_grouped"],
              bound_ms=k5_bnd, bound_by=k5_by, shape=f"{B} rays, {n_g5} groups of 32",
              simt_efficiency=k5_simt(st5)["simt_efficiency"],
              simt_efficiency_per_lane_mode=k5_simt(st5_lane)["simt_efficiency"],
              coop_min=sweep.COOP_MIN, at_driven_path=driven["sweep_grouped"],
              at_first_generation_grouped=driven["first_generation_grouped"],
              at_bvh_queue_frame=bvh_queue["k5_by_launch"],
              coop_sweep=dict(grid_canary={cm: r["ms"] for cm, r in k5_grid_sweep.items()},
                              bvh_queue_frame={cm: r["ms"] for cm, r in
                                               bvh_queue["coop_sweep"].items()}),
              ptxas={k: ptxas.get(k) for k in K5_INSTANTIATIONS}),
    ], (acc3_s, lanes3)



# ---------------------------------------------------------------------------
# The eleventh slice: K5 (sweep_grouped) on the warp sweep, and K4's fused
# dense sweep (sweep_nearest_ri) with the table in shared memory and K lanes
# a ray
# ---------------------------------------------------------------------------

K5_SAME = (sweep.SC_ROWS, sweep.SC_RI_ROWS)  # the counters every schedule gives alike
K5_INSTANTIATIONS = ("sweep.so grouped_kernel<0,0>", "sweep.so grouped_kernel<0,1>",
                     "sweep.so grouped_kernel<1,0>")
K4_NRI_INSTANTIATIONS = tuple(f"sweep.so nearest_ri_kernel<{k}>" for k in sweep.NRI_SPLITS)


def k5_simt(stats):
    """SIMT efficiency of K5: the live rows its per-thread walk tests over the
    lane slots the warps issued, for the hit pass and the fused RI pass; and
    the row-parallel group visits of each."""
    slots, ri_slots = int(stats[sweep.SC_SLOTS]), int(stats[sweep.SC_RI_SLOTS])
    return dict(simt_efficiency=int(stats[sweep.SC_ROWS]) / max(slots, 1), lane_slots=slots,
                coop_visits=int(stats[sweep.SC_COOP]),
                ri_simt_efficiency=int(stats[sweep.SC_RI_ROWS]) / ri_slots if ri_slots else None,
                ri_coop_visits=int(stats[sweep.SC_RI_COOP]))


_K5_LAUNCH = sweep._launch_grouped  # the wrapper, also while a hook stands in its name


def k5_run(table, gaabb, rays, group, with_ri, mode):
    """One launch of K5 with its counters -> (outputs, stats)."""
    stats = torch.zeros(sweep.SC_LEN, dtype=torch.int64, device=rays.device)
    return _K5_LAUNCH(table, gaabb, rays, group, with_ri, mode, stats=stats), stats


def k5_bound(table, gaabb, rays, with_ri, mode, stats):
    """The least time of K5 on these rays, from its counters: every ray's box
    test of every group (with the RI pass, also its point-in-box test), and
    the live rows of the groups its walk enters, at the row cost of the mode
    -> (ms, what bounds it)."""
    B, G = rays.shape[1], gaabb.shape[0]
    row = FLOPS_PER_GENERIC_ROW if mode == "generic" else FLOPS_PER_SPHERE_TEST + 6
    flops = B * G * FLOPS_PER_SLAB_TEST + int(stats[sweep.SC_ROWS]) * row
    if with_ri:
        flops += B * G * 6 + int(stats[sweep.SC_RI_ROWS]) * FLOPS_PER_CONTAINS_SPHERE
    return bound(44 * B + 4 * (table.numel() + gaabb.numel()), flops)


def k5_bound_of_launch(table, gaabb, rays, group, with_ri, mode, stats=None):
    """``kernels_on_path``'s bound of one K5 launch (counted by one more)."""
    return k5_bound(table, gaabb, rays, with_ri, mode,
                    k5_run(table, gaabb, rays, group, with_ri, mode)[1])[0]


def k4_nri_bound(table, rays):
    """The least time of K4's fused sweep: every ray tests every live row,
    for the hit and for containment -> (ms, what bounds it)."""
    B = rays.shape[1]
    live = int((table[:, sweep.S_VALID] > 0).sum())
    return bound(44 * B + 4 * table.numel(),
                 B * live * (FLOPS_PER_SPHERE_TEST + 6 + FLOPS_PER_CONTAINS_SPHERE))


def k4_nri_bound_of_launch(table, rays, split=None):
    return k4_nri_bound(table, rays)[0]


@contextlib.contextmanager
def launches_of(module, name):
    """The arguments of every call of ``module.name`` (rays cloned)."""
    got = []
    real = getattr(module, name)

    def keep(table, *args, **kw):
        got.append((table, *(a.clone() if isinstance(a, torch.Tensor) and a.dim() == 2
                             and a.shape[0] == 8 else a for a in args)))
        return real(table, *args, **kw)

    with patched(module, name, keep):
        yield got


def exact_vs_plain(got, want):
    """t, obj and the refractive index bit for bit (both sum the contained
    rows' indices in row order), and the share of indices that are not 1."""
    return dict(t_identical=bool(torch.equal(got[0], want[0])),
                obj_identical=bool(torch.equal(got[1], want[1])),
                ri_identical=bool(torch.equal(got[2], want[2])),
                ri_not_one=frac(want[2] != 1.0))


def k45_modes(k5_in, k4_in):
    """Phase k45_modes: K5 on each input in coop_min 1, 33 and the default of
    the -fmad=false build, bit for bit and against its plain version; K4's
    fused sweep at every split K, forced, likewise."""
    res = {}
    for name, args in k5_in.items():
        r = schedules_identical(f"K5 {name}", lambda: k5_run(*args), K5_SAME, k5_simt)
        with _build.precise():
            got = sweep._launch_grouped(*args)
        r["vs_plain"] = exact_vs_plain(got, sweep.sweep_grouped_plain(*args))
        res[f"K5 {name}"] = r
    for name, (table, rays) in k4_in.items():
        with _build.precise():
            outs = {k: sweep._launch_nearest_ri(table, rays, k) for k in sweep.NRI_SPLITS}
        r = {f"K={k}": dict(identical_to_K1=all(torch.equal(a, b) for a, b in zip(o, outs[1])))
             for k, o in outs.items()}
        r["vs_plain"] = exact_vs_plain(outs[1], sweep.sweep_nearest_ri_plain(table, rays))
        r["rays"], r["default_K"] = rays.shape[1], sweep.nearest_ri_split(rays.shape[1])
        res[f"K4 {name}"] = r
    say(phase="k45_modes", what="K5 schedules and K4 splits bit for bit, -fmad=false build",
        **res)
    for name, r in res.items():
        v = r["vs_plain"]
        require(v["t_identical"] and v["obj_identical"] and v["ri_identical"]
                and all(x["identical_to_K1"] for k, x in r.items() if k.startswith("K=")),
                f"{name}: the -fmad=false build differs: {r}")
    return res


def k5_coop_sweep(what, render):
    """K5's summed device time over ``render()`` per coop_min of COOP_SWEEP
    (each launch timed twice, the faster counted), with its SIMT numbers."""
    calls = {}
    with patched(sweep, "_launch_grouped",
                 timed_by_coop(sweep._launch_grouped, calls, sweep.SC_LEN)):
        render()
    res = coop_sweep_table(calls, k5_simt)
    say(phase="k5_coop_sweep", path=what, default=sweep.COOP_MIN, **res)
    return res


def device_profile(render):
    """One ``render()`` under torch.profiler -> {kernel name: device ms}."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        render()
        torch.cuda.synchronize()
    return {e.key: e.self_device_time_total / 1e3 for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA}


def bvh_queue_frame(scene, camera, cfg, ou):
    """Phase bvh_queue_frame: the bvh workload's own path, the queue renderer
    with intersector="pallas" (K5's generic instantiation) at bvh1k's size:
    one warm frame, three timed; parity against ``ou``, the render_uber frame
    of the same run; every K5 launch timed on the device alone with its bound;
    a profiled frame for the card's busy and idle shares; the coop_min sweep
    -> (numbers, the last frame's launches, the frame)."""
    render = lambda: render_stats(scene, camera, cfg)  # noqa: E731
    oq, times, launches = timed_frames(render)
    c = parity(ou, oq)
    k5 = kernels_on_path(render, dict(
        sweep_grouped=(sweep, "_launch_grouped", k5_bound_of_launch)))["sweep_grouped"]
    by = device_profile(render)
    frame_ms = min(times) * 1e3
    busy = sum(by.values())
    k5_ms = sum(v for k, v in by.items() if "grouped_kernel" in k)
    res = dict(scene="bvh_grid_scene(side=32)", size=size_of(BVH1K),
               renderer="render_stats (the queue renderer), intersector='pallas'",
               seconds_per_frame_min=min(times), seconds_per_frame_mean=sum(times) / len(times),
               rays=int(oq["rays"]), mrays_per_s=int(oq["rays"]) / min(times) / 1e6,
               rays_dropped=int(oq["rays_dropped"]), image_mean=float(oq["image"].mean()),
               launches_per_frame=launches[-1], device_busy_ms=busy,
               device_idle_share=1.0 - busy / frame_ms, k5_profiled_ms=k5_ms,
               k5_share_of_frame=k5_ms / frame_ms, kernels_traced=len(by),
               k5_by_launch=k5, parity_vs_render_uber=c)
    say(phase="bvh_queue_frame", **res)
    check_parity("bvh queue frame against render_uber", c)
    require(all(set(got) == {"sweep_grouped"} and got["sweep_grouped"] > 0 for got in launches),
            f"a bvh queue frame launches K5 and nothing else: {launches}")
    require(k5["ms"] > k5["bound_ms"], f"K5 below its bound on the bvh queue frame: {k5}")
    res["coop_sweep"] = k5_coop_sweep("bvh queue frame", render)
    return res, launches[-1], oq


# ---------------------------------------------------------------------------
# The twelfth slice: K4's dense nearest hit (sweep_nearest) and RI sum
# (sweep_ri) on staged tables with their exact culls, and two full-width
# frames that drive them
# ---------------------------------------------------------------------------

K4_DENSE_INSTANTIATIONS = tuple(f"sweep.so {k}_kernel<{m},{s}>" for k in ("nearest", "ri")
                                for m in (0, 1) for s in sweep.NRI_SPLITS)
FLOPS_PER_CULL_TEST = 24  # shifted relative origin, |r|^2, r.d, rho^2, the two tests
FLOPS_PER_CONTAINS_PRETEST = 12  # shifted relative point, |r|^2, compare
_K4_LAUNCH = dict(nearest=sweep._launch_nearest, ri=sweep._launch_ri)  # while hooks stand


def k4_run(kind, table, mode, x, split=None):
    """One launch of K4's dense ``kind`` ("nearest": rays, "ri": points) with
    its counters -> (outputs, stats)."""
    stats = torch.zeros(sweep.DC_LEN, dtype=torch.int64, device=x.device)
    return _K4_LAUNCH[kind](table, mode, x, split, stats), stats


def k4_counts(stats):
    pre, full, slots = (int(stats[k]) for k in (sweep.DC_PRE, sweep.DC_FULL, sweep.DC_SLOTS))
    return dict(rows_pre_tested=pre, rows_fully_tested=full, lane_slots=slots,
                share_fully_tested=full / max(pre, 1), simt_efficiency=full / max(slots, 1))


def k4_bound(kind, table, mode, x, stats):
    """The least time of one K4 launch: the lesser of the dense count (every
    point or ray against every live row, at the generic row's cost, as before
    the culls) and the work its counters name (each pre-test and each full
    test at its own cost; the staged rows' bytes) -> dict."""
    B = x.shape[1]
    live = int((table[:, sweep.G_VALID if mode == "generic" else sweep.S_VALID] > 0).sum())
    pre, full = int(stats[sweep.DC_PRE]), int(stats[sweep.DC_FULL])
    if kind == "nearest":
        dense = bound(40 * B + 4 * table.numel(), B * live * FLOPS_PER_GENERIC_ROW)
        if mode == "generic":
            culled = bound(40 * B + 4 * (sweep.dense_bounds(table).numel() + table.numel()),
                           pre * FLOPS_PER_CULL_TEST + full * FLOPS_PER_GENERIC_ROW)
        else:
            culled = bound(40 * B + 4 * table.numel(), pre * FLOPS_PER_SPHERE_TEST)
    else:
        dense = bound(20 * B + 4 * table.numel(), B * live * FLOPS_PER_CONTAINS_GENERIC)
        index, staged = sweep.ri_rows(table, mode)
        rows_bytes = 4 * (staged.numel() + index.numel())
        if mode == "generic":
            culled = bound(20 * B + rows_bytes + 4 * sweep.G_COLS * index.numel(),
                           pre * FLOPS_PER_CONTAINS_PRETEST + full * FLOPS_PER_CONTAINS_GENERIC)
        else:
            culled = bound(20 * B + rows_bytes, pre * FLOPS_PER_CONTAINS_SPHERE)
    least = min(dense, culled)
    return dict(bound_ms=least[0], bound_by=least[1], dense_bound_ms=dense[0],
                culled_bound_ms=culled[0])


class K4Path:
    """``kernels_on_path``'s bound of each K4 launch (from a counted launch of
    its own), with the counters and both counts summed over the path."""

    def __init__(self, kind):
        self.kind, self.stats, self.dense, self.culled = kind, torch.zeros(sweep.DC_LEN,
                                                                            dtype=torch.int64), 0.0, 0.0

    def __call__(self, table, mode, x, split=None, stats=None):
        _, st = k4_run(self.kind, table, mode, x)
        b = k4_bound(self.kind, table, mode, x, st)
        self.stats += st.cpu()
        self.dense += b["dense_bound_ms"]
        self.culled += b["culled_bound_ms"]
        return b["bound_ms"]

    def summary(self, on_path):
        return dict(on_path, dense_bound_ms=self.dense, culled_bound_ms=self.culled,
                    **k4_counts(self.stats))


def k4_on_path(render, kind, extra=None):
    """K4's ``kind`` over ``render()``, launch by launch (``kernels_on_path``)."""
    label = "sweep_nearest" if kind == "nearest" else "sweep_ri"
    path = K4Path(kind)
    got = kernels_on_path(render, {label: (sweep, "_launch_" + kind, path), **(extra or {})})
    got[label] = path.summary(got[label])
    return got


# The glass grid: every fourth object of bvh_grid_scene(side=32)'s grid (its
# rows 1, 5, 9, ...: spheres and boxes alike) made glass, with add_dielectric's
# material (refractive index 1.5, refractivity 0.9, reflectivity 0.1, no
# scatter).  A glass hit's reflected child carries a tenth of its parent's
# contribution, so below any path its pending refraction siblings nest at most
# twice before the children fall under the 0.01 spawn floor: the default stack
# of 5 records never fills, whatever the share (rays_dropped must be 0).  The
# other objects keep the builder's default refractive index 1.5 (refractivity
# 0): the RI sum counts them as the plain version does (index not 1), so the
# sum's air-row cut removes only the padding rows here.
GLASS_EVERY = 4


def glass_grid_scene():
    scene, cam = examples.bvh_grid_scene(side=32)
    glass = torch.zeros(scene.capacity, dtype=torch.bool)
    glass[1:32 * 32:GLASS_EVERY] = True
    on = lambda v, field: torch.where(glass, torch.full_like(field, v), field)  # noqa: E731
    return scene.replace(refractive_index=on(1.5, scene.refractive_index),
                         refractivity=on(0.9, scene.refractivity),
                         reflectivity=on(0.1, scene.reflectivity),
                         scatter_reflect=on(0.0, scene.scatter_reflect)), cam


def frame_numbers(what, times, out, launches, by, kernels):
    """A frame's common figures; ``by``: its device profile; ``kernels``:
    {name: profiled-kernel name substring}."""
    frame_ms = min(times) * 1e3
    busy = sum(by.values())
    return dict(scene=what, size=size_of(BVH1K), seconds_per_frame_min=min(times),
                seconds_per_frame_mean=sum(times) / len(times), rays=int(out["rays"]),
                mrays_per_s=int(out["rays"]) / min(times) / 1e6,
                rays_dropped=int(out["rays_dropped"]), image_mean=float(out["image"].mean()),
                launches_per_frame=launches[-1], device_busy_ms=busy,
                device_idle_share=1.0 - busy / frame_ms,
                profiled_ms={k: sum(v for n, v in by.items() if sub in n)
                             for k, sub in kernels.items()})


def dense_generic_frame(scene, camera, cfg, oq_k5):
    """Phase dense_generic_frame: bvh1k's scene and size through the queue
    renderer with pallas_groups=0, the dense sweep over the whole table: one
    warm frame, three timed, K4's sweep_nearest alone launched (once a pop);
    the canary's envelope against ``oq_k5``, the same frame through K5 in
    this run; every launch timed on the device alone beside its bound (the
    lesser of the dense and the culled counts), the counters summed; the
    card's idle share over a profiled frame -> (numbers, launches of a frame,
    the first two pops' (table, mode, rays))."""
    cfg0 = dataclasses.replace(cfg, pallas_groups=0)
    render = lambda: render_stats(scene, camera, cfg0)  # noqa: E731
    out, times, launches = timed_frames(render)
    c = parity(out, oq_k5)
    k4 = k4_on_path(render, "nearest")["sweep_nearest"]
    res = frame_numbers("bvh_grid_scene(side=32), pallas_groups=0", times, out, launches,
                        device_profile(render), dict(sweep_nearest="nearest_kernel"))
    res.update(sweep_nearest=k4, parity_vs_bvh_queue_frame=c)
    with launches_of(sweep, "_launch_nearest") as pops:
        render_stats(scene, camera, cfg0)
    say(phase="dense_generic_frame", **res)
    check_parity("dense generic frame against the bvh queue frame", c)
    n = launches[-1].get("sweep_nearest", 0)
    require(n > 0 and all(got == {"sweep_nearest": n} for got in launches),
            f"a dense generic frame launches sweep_nearest once a pop, nothing else: {launches}")
    require(res["rays_dropped"] == 0, f"the dense generic frame dropped rays: {res}")
    return res, launches[-1], pops[:2]


def glass_grid_frame(dev):
    """Phase glass_grid_frame: ``glass_grid_scene()`` at 800x450x16 d8 through
    the default grouped queue renderer (K5, then sweep_ri's dense probe over
    every row, once a pop each); the canary's envelope against render_uber
    (uber_g with the probe cut) of the same scene; every launch of both
    kernels timed on the device alone beside its bound; the idle share ->
    (numbers, launches of a frame, the first two pops' (table, mode, points),
    the render_uber frame's launches)."""
    scene, camera = glass_grid_scene()
    scene, camera = scene.to(dev), camera.to(dev)
    cfg = RenderConfig(intersector="pallas", **BVH1K).for_scene(scene)
    require(cfg.pallas_mode == "generic" and cfg.has_dielectrics and cfg.pallas_groups == 32,
            f"the glass grid's statics: {cfg}")
    render = lambda: render_stats(scene, camera, cfg)  # noqa: E731
    out, times, launches = timed_frames(render)
    _build.reset_launches()
    ou = uber.render_uber(scene, camera, cfg, gr=GR)
    launches_u = dict(_build.LAUNCHES)
    c = parity(ou, out)
    got = k4_on_path(render, "ri", dict(
        sweep_grouped=(sweep, "_launch_grouped", k5_bound_of_launch)))
    res = frame_numbers(f"glass_grid_scene() (every {GLASS_EVERY}th grid object glass)", times,
                        out, launches, device_profile(render),
                        dict(sweep_ri="ri_kernel", sweep_grouped="grouped_kernel"))
    res.update(got, parity_vs_render_uber=c, render_uber_launches=launches_u,
               glass_rows=int((scene.refractivity > 0.002).sum()))
    with launches_of(sweep, "_launch_ri") as pops:
        render_stats(scene, camera, cfg)
    say(phase="glass_grid_frame", **res)
    check_parity("glass grid frame against render_uber", c)
    n = launches[-1].get("sweep_ri", 0)
    require(n > 0 and all(g == {"sweep_grouped": n, "sweep_ri": n} for g in launches),
            f"a glass grid frame launches K5 and sweep_ri once a pop each: {launches}")
    require(res["rays_dropped"] == 0 and c["rays_dropped"] == 0,
            f"the glass grid frame dropped rays: {res}")
    require(launches_u == {"uber_g": 1}, f"the glass grid's render_uber frame: {launches_u}")
    return res, launches[-1], pops[:2]


def k4_dense_modes(nearest_in, ri_in):
    """Phase k45_modes, K4's dense kernels: on each input, every split K of
    the -fmad=false build bit for bit, and t, obj or the RI bit for bit the
    plain version's; the counters of the default split."""
    res = {}
    for kind, inputs in (("nearest", nearest_in), ("ri", ri_in)):
        for name, (table, mode, x) in inputs.items():
            with _build.precise():
                outs = {k: _K4_LAUNCH[kind](table, mode, x, k) for k in sweep.NRI_SPLITS}
            outs = {k: o if kind == "nearest" else (o,) for k, o in outs.items()}
            want = (sweep.sweep_nearest_plain(table, mode, x) if kind == "nearest"
                    else (sweep.sweep_ri_plain(table, mode, x),))
            r = {f"K={k}": dict(identical_to_K1=all(torch.equal(a, b) for a, b in zip(o, outs[1])))
                 for k, o in outs.items()}
            r["vs_plain"] = {f: bool(torch.equal(a, b))
                             for f, a, b in zip(("t", "obj") if kind == "nearest" else ("ri",),
                                                outs[1], want)}
            r.update(mode=mode, points_or_rays=x.shape[1], rows=table.shape[0],
                     default_K=sweep.nearest_ri_split(x.shape[1]),
                     **k4_counts(k4_run(kind, table, mode, x)[1]))
            if kind == "ri":
                r["ri_not_one"] = frac(want[0] != 1.0)
            res[f"K4 {kind} {name}"] = r
            del outs, want
    say(phase="k45_modes", what="K4's dense sweep_nearest and sweep_ri: every split bit for "
        "bit and the plain version's outputs, -fmad=false build", **res)
    for name, r in res.items():
        require(all(r["vs_plain"].values())
                and all(x["identical_to_K1"] for k, x in r.items() if k.startswith("K=")),
                f"{name}: the -fmad=false build differs: {r}")
    return res


# ---------------------------------------------------------------------------
# The third slice: the chunked megakernel, the lane-aligned drain, the work
# queue, and motion blur
# ---------------------------------------------------------------------------

CHUNK = 1 << 20  # lanes per chunk of the lane-aligned drain on the headline
MOTION = dict(width=800, height=450, spp=16, max_bounces=8)  # the motion frame
# Bars of K6's default build against its plain version, on the lanes where both
# name the same children (``MEGA_SAME`` of all lanes).  The -fmad=false build
# must give the plain version's outputs on >= 99.9 % of lanes: the same
# children and every float within 1e-6 (relative above 1).  Not bit for bit:
# cosf and sinf are inlined from the device library and compiled with the
# build's own flag, so at 100 spp (angles up to 237 rad) a few per cent of the
# scatter cones turn by one ulp against PyTorch's own build of the same
# functions; the phase prints the bitwise share too.  The default build
# fuses a*b+c: the colour a node adds depends on its winner alone and is held
# tightly; the hit distance is the refine's (grazing hits on 0.2-radius spheres
# 13 to 40 units away lose it to cancellation, as in SWEEP_BARS, and a chunk's
# last iterations hold a hundred rays that left the ground sphere at a grazing
# angle and meet it again after a short, ill-conditioned t: rtol 1e-4 on
# >= 95 %, within 2e-2 absolute on >= 99.9 %: a few lanes in a million name
# another winner with the same children); a child's
# origin carries the t difference and its direction that
# over the radius, doubled by the mirror and turned by the scatter cone.
MEGA_SAME = 0.999
MEGA_BARS = dict(colour_1e5=0.999, t_1e4=0.95, t_2e2=0.999, origin_1e3=0.99, origin_5e2=0.999,
                 dir_1e2=0.97, dir_5e2=0.99)


def step_kw(cfg):
    return dict(has_dielectrics=cfg.has_dielectrics, spp=cfg.spp, max_bounces=cfg.max_bounces,
                t_max=cfg.t_max, bg=cfg.background)


def capture_steps(accel, camera, cfg, chunk, wanted):
    """Drain the first chunk of a frame through the lane-aligned drain and
    keep the (pool, lane) pairs that ``mega_step`` was given at the iterations
    in ``wanted`` -> ({iteration: (pool, lane)}, iterations of the chunk)."""
    o, d, tr, _ = _lane_inputs(camera, cfg)
    lane = torch.arange(chunk, dtype=torch.int32, device=o.device)
    cur = megalanes._init_chunk(o[:chunk], d[:chunk], tr[:chunk], lane, cfg)
    del o, d, tr
    kept, calls = {}, [0]
    real = megalanes.mega_step

    def keeping(acc, pool, ln, **kw):
        if calls[0] in wanted:
            kept[calls[0]] = (pool.clone(), ln.clone())
        calls[0] += 1
        return real(acc, pool, ln, **kw)

    megalanes.mega_step = keeping
    try:
        _, _, _, iters, _ = megalanes._drain_chunk(accel, cur, lane, cfg)
    finally:
        megalanes.mega_step = real
    return kept, iters


def compare_mega(accel, pool, lane, kw, want):
    """K6 of the current build variant against the plain version's ``want``."""
    got = mega.mega_step(accel, pool, lane, **kw)
    torch.cuda.synchronize()
    same = (got[3] == want[3]) & (got[4] == want[4])
    ident, close = same.clone(), same.clone()
    for g, w in zip(got[:3], want[:3]):
        ident &= (g == w).all(dim=0)
        close &= ((g - w).abs() <= 1e-6 * w.abs().clamp_min(1.0)).all(dim=0)
    hit = same & (want[0][3] < kw["t_max"])
    terr = (got[0][3] - want[0][3]).abs()[hit]
    cerr = (got[0][:3] - want[0][:3]).abs().amax(dim=0)[same]
    res = dict(same_children=frac(same), identical=frac(ident), within_1e6=frac(close),
               active=frac(lane >= 0),
               colour_within_1e5=frac(cerr <= 1e-5), colour_max_abs_err=float(cerr.max()),
               t_within_rtol_1e4=frac(terr <= 1e-4 * want[0][3][hit]) if hit.any() else 1.0,
               t_within_2e2=frac(terr <= 2e-2) if hit.any() else 1.0,
               finite=bool(all(torch.isfinite(g).all() for g in got[:3])),
               inactive_lanes_add_nothing=bool((got[0][:3, lane < 0] == 0).all()
                                               and (got[3][lane < 0] == -1).all()
                                               and (got[4][lane < 0] == -1).all()))
    oerr, derr = [], []
    for child, wchild, cl in ((got[1], want[1], want[3]), (got[2], want[2], want[4])):
        sel = same & (cl >= 0)
        oerr.append((child[0:3, sel] - wchild[0:3, sel]).abs().amax(dim=0))
        derr.append((child[3:6, sel] - wchild[3:6, sel]).abs().amax(dim=0))
    oerr, derr = torch.cat(oerr), torch.cat(derr)
    if oerr.numel():
        res.update(children=oerr.numel(), origin_within_1e3=frac(oerr <= 1e-3),
                   origin_within_5e2=frac(oerr <= 5e-2),
                   origin_max_abs_err=float(oerr.max()), dir_within_1e2=frac(derr <= 1e-2),
                   dir_within_5e2=frac(derr <= 5e-2), dir_max_abs_err=float(derr.max()))
    return res


def check_mega(what, res, precise):
    for r in (res, precise):
        require(r["finite"] and r["inactive_lanes_add_nothing"], f"{what}: K6 output: {r}")
    require(precise["within_1e6"] >= 0.999,
            f"{what}: K6's -fmad=false build differs from the plain version: {precise}")
    b = MEGA_BARS
    require(res["same_children"] >= MEGA_SAME and res["colour_within_1e5"] >= b["colour_1e5"]
            and res["t_within_rtol_1e4"] >= b["t_1e4"] and res["t_within_2e2"] >= b["t_2e2"],
            f"{what}: K6 disagrees with the plain version: {res}")
    if "children" in res:
        require(res["origin_within_1e3"] >= b["origin_1e3"]
                and res["origin_within_5e2"] >= b["origin_5e2"]
                and res["dir_within_1e2"] >= b["dir_1e2"] and res["dir_within_5e2"] >= b["dir_5e2"],
                f"{what}: K6's children disagree with the plain version's: {res}")


def mega_bound(accel, C, stats):
    """K6's bound for one step from its own counters.  Bytes by lane class:
    every lane writes 42 floats; an inactive lane reads its lane id, omt and
    bounce count (its children carry them), a dead one its direction and
    contribution too, a live one its whole record (11 values); the tables and
    the live-row bounds once.  Operations by what the lanes did."""
    live, tests, hits, probes, active = (int(stats[k]) for k in (
        mega.MS_LIVE, mega.MS_ROW_TESTS, mega.MS_HITS, mega.MS_PROBES, mega.MS_ACTIVE))
    inactive, dead = C - active, active - live
    n_bytes = (4 * (42 * C + 3 * inactive + 7 * dead + 11 * live) + accel_bytes(accel)
               + 4 * accel.n_groups)
    n_flops = (tests * FLOPS_PER_SPHERE_TEST + live * accel.n_groups * FLOPS_PER_SLAB_TEST
               + hits * FLOPS_PER_NODE_SHADE
               + probes * accel.n_pgroups * sweep2.PROBE_GR * FLOPS_PER_PROBE_ROW)
    t_b = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_f = n_flops / PEAK_FP32_FLOPS * 1e3
    return dict(bound_ms=max(t_b, t_f), bound_by="bytes" if t_b >= t_f else "operations",
                bytes_ms=t_b, operations_ms=t_f, live_lanes=live, dead_lanes=dead,
                inactive_lanes=inactive, sphere_tests_per_live_lane=tests / max(live, 1),
                hits=hits, probed=probes, **k6_simt(stats))


def mega_vs_plain(what, accel, camera, cfg, chunk):
    """Phase 13 on one frame: K6 against its plain version on the first chunk's
    pools at iterations 0, 1 and the chunk's last, taken from the drain itself;
    both builds; each pool's time (and with coop_min = 1, the per-lane sweep,
    in the same call), bound and the plain version's time.
    -> ({iteration: numbers}, {iteration: (pool, lane)})."""
    _, iters = capture_steps(accel, camera, cfg, chunk, set())
    late = iters - 1
    require(late > 1, f"{what}: the chunk ended after {iters} iterations")
    pools, _ = capture_steps(accel, camera, cfg, chunk, {0, 1, late})
    kw = step_kw(cfg)
    out = {}
    for it, (pool, lane) in pools.items():
        plain_ms, want = timed_ms(lambda: mega.mega_step_plain(accel, pool, lane, **kw))
        res = compare_mega(accel, pool, lane, kw, want)
        with _build.precise():
            precise = compare_mega(accel, pool, lane, kw, want)
        stats = torch.zeros(mega.MS_LEN, dtype=torch.int64, device=pool.device)
        mega.mega_step(accel, pool, lane, stats=stats, **kw)
        ms = cuda_ms(lambda: mega.mega_step(accel, pool, lane, **kw), 10)
        with coop(1):
            ms_lane = cuda_ms(lambda: mega.mega_step(accel, pool, lane, **kw), 10)
            stats_lane = torch.zeros_like(stats)
            mega.mega_step(accel, pool, lane, stats=stats_lane, **kw)
        bnd = mega_bound(accel, pool.shape[1], stats)
        say(phase="mega_vs_plain", frame=what, iteration=it, lanes=pool.shape[1],
            default_build=res, precise_build=precise, ms=ms, ms_per_lane_mode=ms_lane,
            simt_efficiency_per_lane_mode=k6_simt(stats_lane)["simt_efficiency"],
            plain_ms=plain_ms, **bnd)
        check_mega(f"{what} iteration {it}", res, precise)
        require(min(ms, ms_lane) > bnd["bound_ms"],
                f"{what} iteration {it}: K6 below its bound, a counting error: {ms} {bnd}")
        out[it] = dict(res=res, ms=ms, ms_per_lane_mode=ms_lane, plain_ms=plain_ms,
                       simt_efficiency_per_lane_mode=k6_simt(stats_lane)["simt_efficiency"],
                       **bnd)
    require(out[0]["res"]["active"] == 1.0 and out[late]["res"]["active"] < 0.5,
            f"{what}: the pools' shares of active lanes: "
            f"{[(i, o['res']['active']) for i, o in out.items()]}")
    return out, pools


def device_ms_by_kernel(fn):
    """Milliseconds the card spent in each kernel (and copy) during ``fn()``,
    from ``torch.profiler``'s device trace; None where the trace is empty."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {e.key: e.self_device_time_total / 1e3 for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA}
    return out if sum(out.values()) > 0 else None


def megalanes_breakdown(scene, camera, cfg):
    """Where a natural-schedule frame of the lane-aligned drain goes: K6 by
    CUDA events around every step, the set-up and the epilogue by the host
    clock, and, from a profiled frame, the card's time in K6, in the drain's
    elementwise kernels and idle (waiting for the host)."""
    events = []
    real = megalanes.mega_step

    def clocked(acc, pool, ln, **kw):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        out = real(acc, pool, ln, **kw)
        b.record()
        events.append((a, b))
        return out

    megalanes.mega_step = clocked
    try:
        frame_ms, out = timed_ms(lambda: megalanes.render_megalanes(
            scene, camera, cfg, chunk=CHUNK, gr=GR, schedule="natural"))
    finally:
        megalanes.mega_step = real
    k6 = [a.elapsed_time(b) for a, b in events]
    accel_ms, accel = timed_ms(lambda: sweep2.make_accel2(
        scene, gr=GR, has_motion=cfg.has_motion, probe_rows=cfg.probe_rows,
        sort_origin=camera.position))
    lanes_ms, lanes = timed_ms(lambda: _lane_inputs(camera, cfg))
    del lanes
    B = cfg.width * cfg.height * cfg.spp
    rgb = torch.zeros((3, B), device=scene.device)
    pt = torch.zeros((B,), device=scene.device)
    post_ms, _ = timed_ms(lambda: finalize(
        rgb.T.reshape(cfg.height, cfg.width, cfg.spp, 3),
        pt.reshape(cfg.height, cfg.width, cfg.spp), cfg))
    del rgb, pt
    iters = out["iterations"]
    chunks = -(-B // CHUNK)
    by_kernel = device_ms_by_kernel(lambda: megalanes.render_megalanes(
        scene, camera, cfg, chunk=CHUNK, gr=GR, schedule="natural"))
    device = dict(device_trace="not measured")
    if by_kernel is not None:
        k6_dev = sum(v for k, v in by_kernel.items() if "mega_kernel" in k)
        busy = sum(by_kernel.values())
        device = dict(device_k6_ms=k6_dev, device_other_kernels_ms=busy - k6_dev,
                      device_other_kernels_ms_per_iteration=(busy - k6_dev) / iters,
                      device_busy_ms=busy, device_idle_share=max(0.0, 1.0 - busy / frame_ms))
    return dict(frame_ms=frame_ms, iterations=iters, chunks=chunks, **device,
                k6_ms_sum=sum(k6), k6_ms_per_step_mean=sum(k6) / len(k6),
                k6_ms_per_step_max=max(k6), k6_ms_per_step_min=min(k6),
                accel_build_ms=accel_ms, lane_inputs_ms=lanes_ms, epilogue_ms=post_ms,
                drain_and_host_ms=frame_ms - sum(k6) - accel_ms - lanes_ms - post_ms,
                drain_and_host_ms_per_iteration=(frame_ms - sum(k6) - accel_ms - lanes_ms
                                                 - post_ms) / iters,
                dead_share_of_lane_steps=1.0 - int(out["rays"]) / (iters * CHUNK)), accel


def k2_sweep_bound(accel, rays, with_ri, with_fields, tests, obj, rows):
    """K2's bound for one launch -> (bytes, operations): rays in, (t, obj)
    and the hit block out, the tables once; the quadratics it solved, a slab
    test per group and ray, a refine per hit, the RI probe where a hit
    consumes it.  ``tests``: the rows it tested (each group's rows up to its
    last live one, for every ray that entered the group)."""
    B = rays.shape[1]
    n_bytes = (4 * B * (8 + 2 + (sweep2.V_ROWS if with_fields else 0)) + accel_bytes(accel)
               + 4 * accel.n_groups)
    hit = obj >= 0
    n_flops = (tests * (FLOPS_PER_SPHERE_TEST + (FLOPS_PER_MOTION_TERMS if accel.has_motion else 0))
               + B * accel.n_groups * FLOPS_PER_SLAB_TEST)
    if with_fields:
        n_flops += int(hit.sum()) * FLOPS_PER_REFINE
    if with_ri:
        inner = (rows[sweep2.V_NX:sweep2.V_NZ + 1] * rays[3:6]).sum(dim=0) > 0.0
        n_probe = int((hit & (inner | (rows[sweep2.V_REFR] > 0.002))).sum())
        n_flops += n_probe * accel.n_pgroups * sweep2.PROBE_GR * FLOPS_PER_PROBE_ROW
    return n_bytes, n_flops


def workqueue_k2_bound(render):
    """Run ``render()`` with every K2 launch counted: launches, rays and the
    bound summed over the launches -> numbers."""
    real = sweep2._sweep2
    acc = dict(launches=0, rays=0, bytes=0, operations=0)

    def counted(accel, rays, with_ri, with_fields, stats=None):
        counts = torch.zeros(sweep2.SW_LEN, dtype=torch.int64, device=rays.device)
        t, obj, rows = real(accel, rays, with_ri, with_fields, stats=counts)
        n_bytes, n_flops = k2_sweep_bound(accel, rays, with_ri, with_fields,
                                          int(counts[sweep2.SW_ROW_TESTS]), obj, rows)
        acc.update(launches=acc["launches"] + 1, rays=acc["rays"] + rays.shape[1],
                   bytes=acc["bytes"] + n_bytes, operations=acc["operations"] + n_flops)
        return t, obj, rows

    sweep2._sweep2 = counted
    try:
        render()
    finally:
        sweep2._sweep2 = real
    t_b = acc["bytes"] / PEAK_BYTES_PER_S * 1e3
    t_f = acc["operations"] / PEAK_FP32_FLOPS * 1e3
    return dict(acc, bound_ms=max(t_b, t_f), bound_by="bytes" if t_b >= t_f else "operations",
                bytes_ms=t_b, operations_ms=t_f)


# ---------------------------------------------------------------------------
# K2's and K6's sweep schedules (csrc/warp_sweep.cuh), held as uber_modes holds
# K1's: coop_min 1, 33 and the default bit for bit in the -fmad=false build,
# SIMT efficiency per schedule, and the time over COOP_SWEEP on the frames
# that launch them.
# ---------------------------------------------------------------------------

# Counters every schedule must give alike (the SIMT slots and the row-parallel
# visits are the schedule's own; K6's dense passes, and with them its slots,
# also depend on which warp claimed which tiles, which changes from run to run).
K2_SAME = (sweep2.SW_TESTS, sweep2.SW_ROW_TESTS)
K6_SAME = (mega.MS_LIVE, mega.MS_TESTS, mega.MS_HITS, mega.MS_PROBES, mega.MS_ACTIVE,
           mega.MS_ROW_TESTS)
# Cycles the card sleeps before a timed launch, so that the launch is enqueued
# before its start event fires (about 0.3 ms at the H100's clocks, more than
# the host takes to enqueue one launch).
SLEEP_CYCLES = 500_000


def k2_simt(stats):
    slots = int(stats[sweep2.SW_LANE_SLOTS])
    return dict(simt_efficiency=int(stats[sweep2.SW_ROW_TESTS]) / max(slots, 1),
                lane_slots=slots, coop_visits=int(stats[sweep2.SW_COOP_VISITS]))


def k6_simt(stats):
    """SIMT efficiency of the dense passes' sweeps, and the share of their
    lane slots that live lanes filled."""
    slots, passes = int(stats[mega.MS_LANE_SLOTS]), int(stats[mega.MS_PASSES])
    return dict(simt_efficiency=int(stats[mega.MS_ROW_TESTS]) / max(slots, 1),
                lane_slots=slots, coop_visits=int(stats[mega.MS_COOP_VISITS]),
                dense_passes=passes,
                dense_fill=int(stats[mega.MS_LIVE]) / max(32 * passes, 1))


DEEP_CENTRE = (0.0, 0.0, -3.0)


def deep_glass_spheres():
    """Four concentric glass spheres of different refractive indices, a fifth
    that cuts into them, a diffuse sphere and a ground sphere.  A ray that
    leaves the innermost sphere from inside probes at a point inside three
    or four glass spheres, where the surrounding refractive index sums as
    many terms and their order shows in the last bits."""
    b = SceneBuilder()
    for radius, ior in ((0.9, 1.5), (0.65, 1.3), (0.45, 1.7), (0.25, 1.4)):
        b.add_dielectric(DEEP_CENTRE, radius, ior=ior)
    b.add_dielectric((0.45, 0.1, -2.8), 0.4, ior=1.6)
    b.add_lambertian((-1.4, 0.0, -3.5), 0.5, (0.7, 0.3, 0.3))
    b.add_lambertian((0.0, -100.9, -3.0), 100.0, (0.5, 0.6, 0.4))
    cam = Camera.make((0.0, 0.3, 0.5), (0.0, -0.08, -1.0), fov_y_deg=55.0, focus_dist=3.5)
    return b.build(), cam


def glass_depth(scene, q):
    """How many glass spheres of ``scene`` contain each point of ``q`` (3, N)."""
    glass = scene.valid & (scene.refractive_index != 1.0)
    c = scene.position[glass]
    r = scene.scale[glass, 0]
    d2 = ((q.T[:, None, :] - c[None]) ** 2).sum(dim=-1)
    return (d2 <= r[None] ** 2).sum(dim=1)


def k2_run(accel, rays):
    stats = torch.zeros(sweep2.SW_LEN, dtype=torch.int64, device=rays.device)
    out = sweep2._sweep2(accel, rays, True, True, stats=stats)
    return out, stats


def k6_run(accel, pool, lane, kw):
    stats = torch.zeros(mega.MS_LEN, dtype=torch.int64, device=pool.device)
    out = mega.mega_step(accel, pool, lane, stats=stats, **kw)
    return out, stats


def schedules_identical(what, run, same, simt_of):
    """``run()`` -> (outputs, stats) in the -fmad=false build with coop_min
    forced to 1 and 33 and at the default: bit-identical outputs and equal
    counters ``same``, or raise -> {mode: SIMT numbers}."""
    runs = {}
    with _build.precise():
        for cm in (*FORCED, None):
            with coop(cm):
                runs[cm] = run()
    torch.cuda.synchronize()
    out1, stats1 = runs[FORCED[0]]
    counters = lambda stats: [int(stats[k]) for k in same]
    res = {}
    for cm, (out, stats) in runs.items():
        res[str(cm or "default")] = dict(
            identical_out=all(torch.equal(a, b) for a, b in zip(out, out1)),
            same_counters=counters(stats) == counters(stats1), **simt_of(stats))
    require(all(r["identical_out"] and r["same_counters"] for r in res.values()),
            f"{what}: the sweep schedules differ in the -fmad=false build: {res}")
    return res


def device_ms(fn, reps):
    """The least device time of ``fn()`` over ``reps`` calls, each timed by
    ``gapless_events`` (for launches shorter than the wrapper's host work,
    which ``cuda_ms`` would count)."""
    fn()
    times = []
    for _ in range(reps):
        a, b = gapless_events(fn)
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return min(times)


def gapless_events(fn):
    """CUDA events around one call of ``fn()``, recorded while the card sleeps
    (``torch.cuda._sleep``), so that the call is enqueued before its start
    event fires and the pair times the device alone -> (start, end)."""
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    a.record()
    fn()
    b.record()
    return a, b


def timed_by_coop(real, calls, n_stats):
    """A stand-in for a kernel wrapper ``real`` that, on each call, runs it
    once untimed (so that the allocator holds the outputs' memory), then for
    each coop_min of COOP_SWEEP, the order rotating from call to call, twice
    timed and once with its ``n_stats`` counters, and returns the default
    schedule's result: ``calls`` gains {coop_min: [(events, stats)]}.  The
    faster of the two timings counts: a host stalled for longer than the
    card's sleep would charge the stall to the launch."""
    n = [0]

    def timed(accel, *args, **kw):
        kw.pop("stats", None)
        k = n[0] % len(COOP_SWEEP)
        n[0] += 1
        real(accel, *args, **kw)
        for cm in COOP_SWEEP[k:] + COOP_SWEEP[:k]:
            with coop(cm):
                events = [gapless_events(lambda: real(accel, *args, **kw)) for _ in range(2)]
                stats = torch.zeros(n_stats, dtype=torch.int64, device=accel.device)
                real(accel, *args, stats=stats, **kw)
            calls.setdefault(cm, []).append((events, stats))
        return real(accel, *args, **kw)

    return timed


def coop_sweep_table(calls, simt_of):
    """{coop_min: summed ms (each launch the faster of its two timings),
    launches, SIMT numbers over the launches, the three slowest launches
    (their number in the frame and ms)}."""
    torch.cuda.synchronize()
    res = {}
    for cm, got in calls.items():
        ms = [min(a.elapsed_time(b) for a, b in events) for events, _ in got]
        slow = sorted(range(len(ms)), key=lambda k: -ms[k])[:3]
        res[str(cm)] = dict(ms=sum(ms), launches=len(got),
                            slowest=[(k, ms[k]) for k in slow],
                            **simt_of(torch.stack([st for _, st in got]).sum(dim=0)))
    return res


def k6_coop_sweep(scene, camera, cfg):
    """K6's summed step time over a natural megalanes frame of the headline,
    for each coop_min of COOP_SWEEP, every step timed in every schedule."""
    calls, accels = {}, []
    real = megalanes.mega_step
    timer = timed_by_coop(real, calls, mega.MS_LEN)

    def hook(accel, pool, *args, **kw):
        accels.append(accel)
        require(pool.shape[1] == CHUNK, f"a step of {pool.shape[1]} lanes")
        return timer(accel, pool, *args, **kw)

    megalanes.mega_step = hook
    try:
        out = megalanes.render_megalanes(scene, camera, cfg, chunk=CHUNK, gr=GR,
                                         schedule="natural")
    finally:
        megalanes.mega_step = real
    res = coop_sweep_table(calls, k6_simt)
    # each step's bound from its counters (the same in every schedule)
    bounds = [mega_bound(accels[0], CHUNK, s)["bound_ms"] for _, s in calls[COOP_SWEEP[0]]]
    for cm, got in calls.items():
        ms = [min(a.elapsed_time(b) for a, b in events) for events, _ in got]
        below = [(k, ms[k], bounds[k]) for k in range(len(ms)) if ms[k] <= bounds[k]]
        require(not below, f"K6 steps below their bound at coop_min {cm}, a counting error: "
                           f"{below[:5]}")
    best = min(COOP_SWEEP, key=lambda cm: res[str(cm)]["ms"])
    require(abs(int(out["rays"]) - SCENE_RAYS) / SCENE_RAYS < 0.02,
            f"the megalanes frame of the coop_min sweep: {int(out['rays'])} rays")
    say(phase="sweep_modes", what="K6 coop_min sweep, natural megalanes frame",
        size=size_of(HEADLINE), iterations=out["iterations"], default_coop_min=mega.COOP_MIN,
        fastest_coop_min=best, bound_ms_sum=sum(bounds), by_coop_min=res)
    return dict(by_coop_min=res, bound_ms_sum=sum(bounds))


def k2_coop_sweep(scene, camera, cfg, keep):
    """K2's summed time over a work-queue frame of the headline, for each
    coop_min of COOP_SWEEP, every launch timed in every schedule; keeps the
    (accel, rays) of the launches numbered in ``keep`` -> (numbers, kept)."""
    calls, kept, n = {}, {}, [0]
    real = sweep2._sweep2
    timer = timed_by_coop(real, calls, sweep2.SW_LEN)

    def keeping(accel, rays, with_ri, with_fields, stats=None):
        if n[0] in keep:
            kept[n[0]] = (accel, rays.clone())
        n[0] += 1
        require(with_ri and with_fields, "the work queue asks K2 for the hit block and RI")
        return timer(accel, rays, with_ri, with_fields)

    sweep2._sweep2 = keeping
    try:
        out = workqueue.render_workqueue(scene, camera, cfg)
    finally:
        sweep2._sweep2 = real
    res = coop_sweep_table(calls, k2_simt)
    best = min(COOP_SWEEP, key=lambda cm: res[str(cm)]["ms"])
    require(abs(int(out["rays"]) - SCENE_RAYS) / SCENE_RAYS < 0.02,
            f"the work-queue frame of the coop_min sweep: {int(out['rays'])} rays")
    say(phase="sweep_modes", what="K2 coop_min sweep, work-queue frame", size=size_of(HEADLINE),
        iterations=out["iterations"], default_coop_min=sweep2.COOP_MIN, fastest_coop_min=best,
        by_coop_min=res)
    return res, kept


def deep_glass_inputs(dev):
    """K2's and K6's inputs on ``deep_glass_spheres()``: 65 536 seeded rays
    that start inside the innermost sphere (K2's rays, and a pool of them
    for K6), and the drain's pools at iterations 0 to 3 of the canary's size
    (with their rays for K2: a pool record's first eight rows are a ray
    matrix) -> (k2 inputs, k6 inputs, numbers)."""
    scene, camera = deep_glass_spheres()
    scene, camera = scene.to(dev), camera.to(dev)
    cfg = RenderConfig(intersector="pallas", **SMALL).for_scene(scene)
    acc_m = sweep2.make_accel2(scene, gr=GR, has_motion=cfg.has_motion,
                               probe_rows=cfg.probe_rows, sort_origin=camera.position)
    acc_q = _build_accel(scene, cfg)
    inside = seeded_rays(DEEP_CENTRE, 0.14, 1 << 16, dev)  # |offset| < 0.25
    n = inside.shape[1]
    pool = torch.cat([inside, torch.ones((1, n), device=dev),
                      torch.zeros((mega.POOL_ROWS - 9, n), device=dev)]).contiguous()
    pools = {"inside": (pool, torch.arange(n, dtype=torch.int32, device=dev))}
    B = cfg.width * cfg.height * cfg.spp
    drained, _ = capture_steps(acc_m, camera, cfg, B, {0, 1, 2, 3})
    pools.update({f"iteration {it}": got for it, got in sorted(drained.items())})
    k2_in, k6_in, depth = {}, {}, []
    for name, (pool, lane) in pools.items():
        k6_in[f"deep_glass {name}"] = (acc_m, pool, lane, step_kw(cfg))
        rays = pool[:8].contiguous()
        k2_in[f"deep_glass {name}"] = (acc_q, rays)
        # the probe points of the hits that need the surrounding RI
        t, obj, rows = sweep2.sweep2_plain(acc_q, rays, True, True)
        hit = obj >= 0
        nrm = rows[sweep2.V_NX:sweep2.V_NZ + 1]
        need = hit & (((nrm * rays[3:6]).sum(dim=0) > 0.0) | (rows[sweep2.V_REFR] > 0.002))
        q = rays[0:3] + torch.where(hit, t, torch.zeros_like(t)) * rays[3:6] + 1e-3 * nrm
        depth.append(glass_depth(scene, q[:, need]))
    depth = torch.cat(depth)
    info = dict(probed_points=depth.numel(), inside_3_or_more=int((depth >= 3).sum()),
                inside_4_or_more=int((depth >= 4).sum()),
                probe_rows=acc_q.n_pgroups * sweep2.PROBE_GR)
    require(info["inside_3_or_more"] > 0, f"no probe point lies inside three glass spheres: {info}")
    return k2_in, k6_in, info


def sweep_modes(k2_in, k6_in, info):
    """Phase sweep_modes, the bit-for-bit part: K2 and K6 on each input in
    coop_min 1, 33 and the default of the -fmad=false build."""
    res = dict(deep_glass=info)
    for name, (acc, rays) in k2_in.items():
        res[f"K2 {name}"] = schedules_identical(
            f"K2 {name}", lambda: k2_run(acc, rays), K2_SAME, k2_simt)
    for name, (acc, pool, lane, kw) in k6_in.items():
        res[f"K6 {name}"] = schedules_identical(
            f"K6 {name}", lambda: k6_run(acc, pool, lane, kw), K6_SAME, k6_simt)
    say(phase="sweep_modes", what="schedules bit for bit, -fmad=false build", **res)
    return res

def frame_sweep(res, default, **extra):
    """A kernel's summed time over a frame at its default coop_min and per
    lane (1), its SIMT efficiency at both, and every coop_min's time."""
    return dict(ms=res[str(default)]["ms"], ms_per_lane_mode=res["1"]["ms"],
                simt_efficiency=res[str(default)]["simt_efficiency"],
                simt_efficiency_per_lane_mode=res["1"]["simt_efficiency"],
                ms_by_coop_min={cm: r["ms"] for cm, r in res.items()}, **extra)


def third_slice_phases(dev, ctx):
    """Phases 13 to 17 and sweep_modes -> the kernels-line entries of the third
    slice.  ``ctx``: the headline scene, camera, config, small config, the
    persistent kernel's frame of this run and K2's canary inputs
    ({name: (accel, rays)})."""
    scene, camera, cfg, cfg_s, uber_frame, k2_canary = ctx
    src = "raytracing_tests_tpu_torch/csrc/"
    jax_src = "raytracing_tests_tpu/kernels/"

    # 13. K6 against its plain version at the headline's chunk shapes ----------
    accel_m = sweep2.make_accel2(scene, gr=GR, has_motion=cfg.has_motion,
                                 probe_rows=cfg.probe_rows, sort_origin=camera.position)
    require(not accel_m.has_motion and accel_m.otab.shape[1] == sweep2.OT_COLS,
            "the headline's accel is static")
    k6, pools_h = mega_vs_plain("headline", accel_m, camera, cfg, CHUNK)

    # 14. the headline frame through the lane-aligned drain ---------------------
    frames_ml = {}
    for schedule in ("natural", "sorted"):
        torch.cuda.reset_peak_memory_stats()
        out, times, launches = timed_frames(lambda: megalanes.render_megalanes(
            scene, camera, cfg, chunk=CHUNK, gr=GR, schedule=schedule))
        env = parity(out, uber_frame)
        rays = int(out["rays"])
        frames_ml[schedule] = dict(
            seconds_per_frame_min=min(times), seconds_per_frame_mean=sum(times) / len(times),
            rays=rays, mrays_per_s=rays / min(times) / 1e6, iterations=out["iterations"],
            image_mean=float(out["image"].mean()), launches_per_frame=launches,
            peak_memory_bytes=torch.cuda.max_memory_allocated(), against_render_uber=env)
        say(phase="megalanes_frame", schedule=schedule, size=size_of(HEADLINE), chunk=CHUNK,
            **frames_ml[schedule])
        require(abs(rays - SCENE_RAYS) / SCENE_RAYS < 0.02
                and abs(frames_ml[schedule]["image_mean"] - SCENE_MEAN) < 1e-2,
                f"megalanes frame ({schedule}): {frames_ml[schedule]}")
        check_parity(f"megalanes frame ({schedule}) against render_uber", env)
        for got in launches:
            require(got == {"mega_step": out["iterations"]},
                    f"a megalanes frame launches K6 once per iteration: {launches}")
        del out
    breakdown, _ = megalanes_breakdown(scene, camera, cfg)
    say(phase="megalanes_breakdown", schedule="natural", **breakdown)
    k6_sweep = k6_coop_sweep(scene, camera, cfg)

    # 15. the work queue: canary against the queue renderer, then the headline --
    _build.reset_launches()
    ow = workqueue.render_workqueue(scene, camera, cfg_s)
    launches_wq = dict(_build.LAUNCHES)
    # The work queue walks every tree to its end; the queue renderer stops a
    # lane after cfg.pops nodes (13 at depth 6), fewer than a tree of glass can
    # hold.  So the reference is the queue renderer with the budget and the
    # stack of a full tree; its count under the default budget is printed too.
    oq = render_stats(scene, camera, dataclasses.replace(
        cfg_s, max_pops=1 << cfg_s.max_bounces, queue_capacity=cfg_s.max_bounces + 2))
    werr = (ow["image"] - oq["image"]).abs().amax(dim=-1)
    wq = dict(pixels_within_2e5=frac(werr <= 2e-5), max_abs_err=float(werr.max()),
              rays=int(ow["rays"]), queue_rays=int(oq["rays"]),
              queue_rays_default_budget=int(render_stats(scene, camera, cfg_s)["rays"]),
              queue_rays_dropped=int(oq["rays_dropped"]), iterations=ow["iterations"],
              rays_dropped=int(ow["rays_dropped"]), launches=launches_wq,
              depth_max_abs_err=float((ow["depth"] - oq["depth"]).abs().max()))
    say(phase="workqueue_canary", size=size_of(SMALL), **wq)
    require(wq["pixels_within_2e5"] >= 0.995 and wq["rays"] == wq["queue_rays"]
            and wq["rays_dropped"] == 0 and launches_wq == {"sweep2": wq["iterations"]},
            f"workqueue canary: {wq}")
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    wq_ms, ow = timed_ms(lambda: workqueue.render_workqueue(scene, camera, cfg))
    launches_wq_frame = dict(_build.LAUNCHES)
    env = parity(ow, uber_frame)
    wq_frame = dict(seconds=wq_ms / 1e3, rays=int(ow["rays"]), iterations=ow["iterations"],
                    mrays_per_s=int(ow["rays"]) / wq_ms / 1e3, launches=launches_wq_frame,
                    image_mean=float(ow["image"].mean()),
                    peak_memory_bytes=torch.cuda.max_memory_allocated(), against_render_uber=env)
    by_kernel = device_ms_by_kernel(lambda: workqueue.render_workqueue(scene, camera, cfg))
    if by_kernel is None:
        wq_frame["device_trace"] = "not measured"
    else:
        k2_dev = sum(v for k, v in by_kernel.items() if "sweep2_kernel" in k)
        busy = sum(by_kernel.values())
        wq_frame.update(device_k2_ms=k2_dev, device_other_kernels_ms=busy - k2_dev,
                        device_busy_ms=busy, device_idle_share=max(0.0, 1.0 - busy / wq_ms),
                        kernel_kinds_launched=len(by_kernel))
    wq_frame["k2"] = workqueue_k2_bound(lambda: workqueue.render_workqueue(scene, camera, cfg))
    say(phase="workqueue_frame", size=size_of(HEADLINE), **wq_frame)
    check_parity("workqueue frame against render_uber", env)
    require(launches_wq_frame == {"sweep2": ow["iterations"]},
            f"a workqueue frame launches the sweep once per iteration: {launches_wq_frame}")
    del ow, oq
    k2_sweep, wq_first = k2_coop_sweep(scene, camera, cfg, {0, 1, 2})
    require(all(r["ms"] > wq_frame["k2"]["bound_ms"] for r in k2_sweep.values()),
            f"K2 over the work-queue frame below its bound, a counting error: {k2_sweep}")

    # 16. the motion frame: K1 MOTION, K2 MOTION, K6 MOTION ---------------------
    m_scene, m_camera = examples.motion_blur_scene()
    m_scene, m_camera = m_scene.to(dev), m_camera.to(dev)
    m_cfg = RenderConfig(intersector="pallas", **MOTION).for_scene(m_scene)
    m_cfg_s = RenderConfig(intersector="pallas", **SMALL).for_scene(m_scene)
    require(m_cfg.has_motion and m_cfg.pallas_mode == "spheres", f"motion scene: {m_cfg}")
    m_out, m_times, m_launches = timed_frames(
        lambda: uber.render_uber(m_scene, m_camera, m_cfg, gr=GR))
    for got in m_launches:
        require(got == {"uber_m": 1}, f"a motion frame is one launch of K1 MOTION: {m_launches}")
    m_acc, m_cam = uber._scene_accel(m_scene, m_camera, m_cfg, 8)  # gr as render_uber clamps it
    require(m_acc.has_motion and m_acc.otab.shape[1] == sweep2.OT_COLS_MOTION,
            "the motion frame's accel carries the motion columns")
    m_st = uber.UberStatics.from_cfg(m_cfg)
    plain_ms_k1m, (out_p, stats_p) = timed_ms(lambda: uber.uber_render_plain(m_acc, m_cam, m_st))
    k1m, got = compare_uber(m_acc, m_cam, m_st, out_p, stats_p)
    img_k = uber._uber_post(*got, m_cfg)["image"]
    with _build.precise():
        k1m_precise, _ = compare_uber(m_acc, m_cam, m_st, out_p, stats_p)
    px_m = compare_pixels(img_k, uber._uber_post(out_p, stats_p, m_cfg)["image"])
    ms_k1m = cuda_ms(lambda: uber.uber_render(m_acc, m_cam, m_st), 5)
    with coop(1):
        ms_k1m_lane = cuda_ms(lambda: uber.uber_render(m_acc, m_cam, m_st), 5)
        _, stats_lane = uber.uber_render(m_acc, m_cam, m_st)
    out_h, stats_h = uber.uber_render(m_acc, m_cam, m_st)
    n_nodes, tests = int(stats_h[uber.ST_RAYS]), int(stats_h[uber.ST_SPHERE_TESTS])
    k1m_bound, k1m_by = bound(
        16 * m_st.B + accel_bytes(m_acc) + 4 * uber.CAM_LEN,
        tests * (FLOPS_PER_SPHERE_TEST + FLOPS_PER_MOTION_TERMS)
        + n_nodes * (m_acc.n_groups * FLOPS_PER_SLAB_TEST + FLOPS_PER_NODE_SHADE))
    del out_p, got, out_h
    m_frame = dict(seconds_per_frame_min=min(m_times),
                   seconds_per_frame_mean=sum(m_times) / len(m_times), rays=int(m_out["rays"]),
                   mrays_per_s=int(m_out["rays"]) / min(m_times) / 1e6,
                   rays_dropped=int(m_out["rays_dropped"]),
                   image_mean=float(m_out["image"].mean()), launches_per_frame=m_launches,
                   kernel_ms=ms_k1m, kernel_ms_per_lane_mode=ms_k1m_lane,
                   sphere_tests_per_ray=tests / n_nodes, **simt(stats_h))
    say(phase="motion_frame", scene="motion_blur_scene()", size=size_of(MOTION), **m_frame,
        rays_plain=int(stats_p[uber.ST_RAYS]), plain_seconds=plain_ms_k1m / 1e3,
        default_build=k1m, precise_build=k1m_precise, pixels_default_vs_plain=px_m)
    check_uber(size_of(MOTION) + " motion", int(stats_p[uber.ST_DROPPED]), k1m, k1m_precise)
    require(px_m["within_1e2"] >= 0.99 and px_m["mean_abs_err"] < 1e-3,
            f"motion frame of the default build is off per pixel: {px_m}")
    require(m_frame["rays_dropped"] == 0 and bool(torch.isfinite(m_out["image"]).all())
            and abs(m_frame["rays"] - int(stats_p[uber.ST_RAYS])) / m_frame["rays"] < 5e-3,
            f"motion frame: {m_frame}")

    # the motion canary: K1 MOTION against the queue renderer through K2 MOTION
    _build.reset_launches()
    ou = uber.render_uber(m_scene, m_camera, m_cfg_s, gr=GR)
    oq = render_stats(m_scene, m_camera, m_cfg_s)
    launches_mc = dict(_build.LAUNCHES)
    mc = parity(ou, oq)
    say(phase="motion_canary", size=size_of(SMALL), launches=launches_mc, **mc)
    check_parity("motion canary", mc)
    require(launches_mc.get("uber_m") == 1 and launches_mc.get("sweep2_m", 0) > 0
            and set(launches_mc) == {"uber_m", "sweep2_m"},
            f"the motion canary's launches: {launches_mc}")

    # K2 MOTION against its plain version on the frame's camera lanes and their
    # children, on the queue renderer's own accel
    acc_q = _build_accel(m_scene, m_cfg)
    lo, ld, ltr, _ = _lane_inputs(m_camera, m_cfg)
    lanes = sweep2.pack_rays(lo, ld, ltr, torch.full_like(ltr, m_cfg.t_max))
    del lo, ld, ltr
    k2m = {}
    for batch, rr in dict(motion_lanes=lanes,
                          motion_second_pop=second_generation(acc_q, lanes)).items():
        res = compare_sweep(acc_q, rr)
        with _build.precise():
            precise = compare_sweep(acc_q, rr)
        say(phase="sweep2_motion_vs_plain", batch=batch, rays=rr.shape[1],
            default_build=res, precise_build=precise)
        check_sweep("random", res, precise)  # nothing far or grazing here: the tight bars
        k2m[batch] = res["hit_block"]
    plain_ms_k2m = cuda_ms(lambda: sweep2.sweep2_plain(acc_q, lanes, True, True), 1)
    stats_k2m = torch.zeros(sweep2.SW_LEN, dtype=torch.int64, device=dev)
    _, obj_q, _ = sweep2._sweep2(acc_q, lanes, True, True, stats=stats_k2m)
    ms_k2m = cuda_ms(lambda: sweep2._sweep2(acc_q, lanes, True, True), 10)
    with coop(1):
        ms_k2m_lane = cuda_ms(lambda: sweep2._sweep2(acc_q, lanes, True, True), 10)
    Bq = lanes.shape[1]
    k2m_bound, k2m_by = bound(
        4 * Bq * (8 + 1 + 1 + sweep2.V_ROWS) + accel_bytes(acc_q) + 4 * acc_q.n_groups,
        int(stats_k2m[sweep2.SW_ROW_TESTS]) * (FLOPS_PER_SPHERE_TEST + FLOPS_PER_MOTION_TERMS)
        + Bq * acc_q.n_groups * FLOPS_PER_SLAB_TEST + int((obj_q >= 0).sum()) * FLOPS_PER_REFINE)
    require(min(ms_k2m, ms_k2m_lane) > k2m_bound,
            f"K2 MOTION below its bound, a counting error: {ms_k2m} {k2m_bound}")

    # K6 MOTION against its plain version on a chunk of the motion frame, and
    # the motion frame through the lane-aligned drain
    acc_mm = sweep2.make_accel2(m_scene, gr=GR, has_motion=True, probe_rows=m_cfg.probe_rows,
                                sort_origin=m_camera.position)
    k6m, pools_m = mega_vs_plain("motion", acc_mm, m_camera, m_cfg, CHUNK)
    _build.reset_launches()
    ml_ms, om = timed_ms(lambda: megalanes.render_megalanes(
        m_scene, m_camera, m_cfg, chunk=CHUNK, gr=GR, schedule="sorted"))
    launches_mm = dict(_build.LAUNCHES)
    env = parity(om, m_out)
    say(phase="megalanes_motion_frame", size=size_of(MOTION), seconds=ml_ms / 1e3,
        rays=int(om["rays"]), iterations=om["iterations"], launches=launches_mm,
        against_render_uber=env)
    check_parity("megalanes motion frame against render_uber", env)
    require(launches_mm == {"mega_step_m": om["iterations"]},
            f"the motion frame through the drain launches K6 MOTION: {launches_mm}")
    del om

    # 17. a moving generic scene: uber_kernel<generic, motion> -------------------
    g_scene, g_camera = moving_groups_scene()
    g_scene, g_camera = g_scene.to(dev), g_camera.to(dev)
    g_cfg = RenderConfig(intersector="pallas", **SMALL).for_scene(g_scene)
    require(g_cfg.pallas_mode == "generic" and g_cfg.has_motion, f"moving generic scene: {g_cfg}")
    _build.reset_launches()
    ou = uber.render_uber(g_scene, g_camera, g_cfg, gr=GR)
    oq = render_stats(g_scene, g_camera, g_cfg)
    launches_gm = dict(_build.LAUNCHES)
    gm = parity(ou, oq)
    g_acc, g_cam = uber._scene_accel(g_scene, g_camera, g_cfg, 8)
    g_st = uber.UberStatics.from_cfg(g_cfg)
    plain_ms_gm, (out_p, stats_p) = timed_ms(lambda: uber.uber_render_plain(g_acc, g_cam, g_st))
    k1gm, got = compare_uber(g_acc, g_cam, g_st, out_p, stats_p)
    with _build.precise():
        k1gm_precise, _ = compare_uber(g_acc, g_cam, g_st, out_p, stats_p)
    px_gm = compare_pixels(uber._uber_post(*got, g_cfg)["image"],
                           uber._uber_post(out_p, stats_p, g_cfg)["image"])
    ms_gm = device_ms(lambda: uber.uber_render(g_acc, g_cam, g_st), 10)
    with coop(1):
        ms_gm_lane = device_ms(lambda: uber.uber_render(g_acc, g_cam, g_st), 10)
        _, stats_gm_lane = uber.uber_render(g_acc, g_cam, g_st)
    _, stats_h = uber.uber_render(g_acc, g_cam, g_st)
    gm_bound, gm_by = bound(
        16 * g_st.B + accel_bytes(g_acc) + 4 * uber.CAM_LEN,
        int(stats_h[uber.ST_SPHERE_TESTS]) * FLOPS_PER_CENSUS_SPHERE_ROW
        + int(stats_h[uber.ST_OTHER_TESTS]) * FLOPS_PER_GENERIC_ROW
        + int(stats_h[uber.ST_SLAB_TESTS]) * FLOPS_PER_SLAB_TEST
        + int(stats_h[uber.ST_HITS]) * FLOPS_PER_REFINE_G
        + int(stats_h[uber.ST_RAYS]) * FLOPS_PER_NODE_SHADE)
    say(phase="moving_generic_canary", scene="groups_scene() with three objects in motion",
        size=size_of(SMALL), launches=launches_gm, **gm, default_build=k1gm,
        precise_build=k1gm_precise, pixels_default_vs_plain=px_gm)
    check_parity("moving generic canary", gm)
    check_uber_g(size_of(SMALL) + " moving generic", int(stats_p[uber.ST_DROPPED]),
                 k1gm, k1gm_precise)
    require(launches_gm.get("uber_g_m") == 1 and launches_gm.get("sweep_grouped", 0) > 0
            and set(launches_gm) == {"uber_g_m", "sweep_grouped"},
            f"the moving generic canary's launches: {launches_gm}")

    # sweep_modes: K2's and K6's schedules bit for bit -----------------------------
    k2_in = dict(k2_canary)
    k2_in.update({f"workqueue launch {n}": got for n, got in sorted(wq_first.items())})
    k2_in["motion_lanes"] = (acc_q, lanes)
    k6_in = {f"headline iteration {it}": (accel_m, pool, lane, step_kw(cfg))
             for it, (pool, lane) in sorted(pools_h.items())}
    k6_in.update({f"motion iteration {it}": (acc_mm, pool, lane, step_kw(m_cfg))
                  for it, (pool, lane) in sorted(pools_m.items())})
    k2_deep, k6_deep, deep_info = deep_glass_inputs(dev)
    k2_in.update(k2_deep)
    k6_in.update(k6_deep)
    sweep_modes(k2_in, k6_in, deep_info)
    del k2_in, k6_in, pools_h, pools_m, wq_first, lanes

    # the kernels line's entries ------------------------------------------------
    paths = dict(megalanes_frame=frames_ml["natural"]["launches_per_frame"][-1],
                 megalanes_frame_sorted=frames_ml["sorted"]["launches_per_frame"][-1],
                 workqueue_canary=launches_wq, workqueue_frame=launches_wq_frame,
                 motion_frame=m_launches[-1], motion_canary=launches_mc,
                 megalanes_motion_frame=launches_mm, moving_generic_canary=launches_gm)
    by_path = lambda name: {p: got.get(name, 0) for p, got in paths.items()}
    tol_k6 = (f"same children as the plain version on >= {MEGA_SAME} of lanes; there: colour "
              f"within 1e-5 on >= {MEGA_BARS['colour_1e5']}, hit t rtol 1e-4 on >= "
              f"{MEGA_BARS['t_1e4']}, child origins within 1e-3 on >= {MEGA_BARS['origin_1e3']}; "
              "the -fmad=false build within 1e-6 on >= 99.9 % of lanes")

    def k6_entry(name, launches, res, shape, frame=None):
        first = res[0]
        return dict(name=name, route="cuda", source=src + "mega.cu",
                    replaces=jax_src + "mega.py:666", launches=launches,
                    launches_by_path=by_path(name), max_abs_err=first["res"]["colour_max_abs_err"],
                    tolerance=tol_k6, frac_within_tolerance=first["res"]["same_children"],
                    ms=first["ms"], ms_per_lane_mode=first["ms_per_lane_mode"],
                    plain_ms=first["plain_ms"], bound_ms=first["bound_ms"],
                    bound_by=first["bound_by"], simt_efficiency=first["simt_efficiency"],
                    simt_efficiency_per_lane_mode=first["simt_efficiency_per_lane_mode"],
                    library_ms=None, shape=shape,
                    by_iteration={str(i): dict(ms=r["ms"], ms_per_lane_mode=r["ms_per_lane_mode"],
                                               bound_ms=r["bound_ms"],
                                               bound_by=r["bound_by"], bytes_ms=r["bytes_ms"],
                                               operations_ms=r["operations_ms"],
                                               active=r["res"]["active"],
                                               simt_efficiency=r["simt_efficiency"],
                                               dense_fill=r["dense_fill"])
                                  for i, r in res.items()},
                    **({} if frame is None else dict(at_megalanes_frame=frame)))

    tol_k1 = ("per sample as the static instantiations: primary t rtol 1e-4 on >= 99.9 %, colours "
              "within 1e-4 on >= 85 % and 5e-2 on >= 97 %, channel means within 5e-3, ray count "
              "within 0.5 %; the -fmad=false build within 1e-4 on >= 99.9 %")
    return [
        k6_entry("mega_step", frames_ml["natural"]["launches_per_frame"][-1]["mega_step"], k6,
                 f"{CHUNK} lanes, the headline's first chunk at iteration 0",
                 frame=frame_sweep(k6_sweep["by_coop_min"], mega.COOP_MIN,
                                   bound_ms=k6_sweep["bound_ms_sum"], bound_by="summed per step",
                                   schedules_bit_identical=True)),
        k6_entry("mega_step_m", launches_mm["mega_step_m"], k6m,
                 f"{CHUNK} lanes, the motion frame's first chunk at iteration 0"),
        dict(name="uber_render_motion", route="cuda", source=src + "uber.cu",
             replaces=jax_src + "uber.py:874", launches=m_launches[-1]["uber_m"],
             launches_by_path=by_path("uber_m"), max_abs_err=px_m["max_abs_err"],
             tolerance=tol_k1, frac_within_tolerance=k1m["colour_within_5e2"],
             per_sample_frac_within_1e4=k1m["colour_within_1e4"],
             per_sample_frac_within_1e4_precise_build=k1m_precise["colour_within_1e4"],
             ms=ms_k1m, ms_per_lane_mode=ms_k1m_lane, plain_ms=plain_ms_k1m,
             bound_ms=k1m_bound, bound_by=k1m_by, simt_efficiency=m_frame["simt_efficiency"],
             simt_efficiency_per_lane_mode=simt(stats_lane)["simt_efficiency"],
             library_ms=None, shape=size_of(MOTION) + ", 3 spheres, gr=8"),
        dict(name="uber_render_generic_motion", route="cuda", source=src + "uber.cu",
             replaces=jax_src + "uber.py:874", launches=launches_gm["uber_g_m"],
             launches_by_path=by_path("uber_g_m"), max_abs_err=px_gm["max_abs_err"],
             tolerance=tol_k1, frac_within_tolerance=k1gm["colour_within_5e2"],
             per_sample_frac_within_1e4=k1gm["colour_within_1e4"],
             per_sample_frac_within_1e4_precise_build=k1gm_precise["colour_within_1e4"],
             ms=ms_gm, ms_per_lane_mode=ms_gm_lane, plain_ms=plain_ms_gm, bound_ms=gm_bound,
             bound_by=gm_by, simt_efficiency=simt(stats_h)["simt_efficiency"],
             simt_efficiency_per_lane_mode=simt(stats_gm_lane)["simt_efficiency"],
             library_ms=None, shape=size_of(SMALL) + ", 4 objects, three in motion"),
        dict(name="sweep2_motion", route="cuda", source=src + "sweep2.cu",
             replaces=jax_src + "sweep2.py:955", launches=launches_mc["sweep2_m"],
             launches_by_path=by_path("sweep2_m"),
             max_abs_err=max(k2m["motion_lanes"]["fields_max_abs_err"],
                             k2m["motion_lanes"]["normal_max_abs_err"]),
             tolerance="on the motion frame's camera lanes: same winner on >= 99.9 % of rays, "
                       "refined t rtol 1e-4 on >= 99 %, material fields within 1e-5 and "
                       "surrounding RI equal on >= 99.9 %, normals within 1e-3 on >= 99 %",
             frac_within_tolerance=min(k2m["motion_lanes"]["fields_within_1e5"],
                                       k2m["motion_lanes"]["ri_equal"],
                                       k2m["motion_lanes"]["normal_within_1e2"],
                                       k2m["motion_lanes"]["t_within_rtol_1e4"]),
             ms=ms_k2m, ms_per_lane_mode=ms_k2m_lane, plain_ms=plain_ms_k2m,
             bound_ms=k2m_bound, bound_by=k2m_by,
             simt_efficiency=k2_simt(stats_k2m)["simt_efficiency"],
             library_ms=None, shape=f"{Bq} rays, hit block + RI, 3 spheres"),
    ], by_path("sweep2"), dict(device_ms=wq_frame.get("device_k2_ms", "not measured"),
                                 **wq_frame["k2"],
                                 **frame_sweep(k2_sweep, sweep2.COOP_MIN, schedules_bit_identical=True))


# ---------------------------------------------------------------------------
# The sixth slice: materials shading and emissive lights through K1, and a
# stack of any depth
# ---------------------------------------------------------------------------

SHADING_FRAME = dict(width=800, height=450, spp=16, max_bounces=8)  # bench.py:199-207
FLOPS_PER_MATERIALS_SHADE = 290  # refine, Schlick, lift, two fibonacci scatters, children
FLOPS_PER_SHADOW_RAY = 40  # target, normalise by division, centre distance, emissive test
# The frames' image means and ray counts within these of their plain
# version's: the headline's bars against its scene's numbers.
SHADING_FRAME_MEAN, SHADING_FRAME_RAYS = 1e-2, 0.02
# Per-sample bars of the new instantiations against their plain version.
# -fmad=false build: colours within 1e-4 on >= SHADING_PRECISE of the samples
# and rays within 0.05 %, the kernel's logic being the plain version's; where
# it is not met the phase says on which samples (see ``corner_samples``).
SHADING_PRECISE = 0.999
# On lights_scene() the light's world AABB is twice the panel, so a shadow ray
# of a sample with s / spp = 0.25 or 0.75 aims at one of the panel's corners:
# its visibility turns on the last ulp of the hit point, which the raygen's
# rsqrtf (approximate on the card, exact in PyTorch) already moves.  Those
# samples are held by their share only.
CORNER_RATIOS = (0.25, 0.75)


def lit_spheres_scene():
    """Spheres (one of glass) under one spherical emissive light: a scene
    the sphere mode takes, so the sphere-mode lights instantiations render
    it (tests/test_torch_lights.py holds it against the JAX package)."""
    b = SceneBuilder()
    b.add_sphere((0.0, -100.5, -3.0), 100.0, color=(0.6, 0.6, 0.6),
                 reflectivity=0.9, scatter_reflect=1.0)
    b.add_sphere((-0.7, 0.0, -3.2), 0.5, color=(0.9, 0.3, 0.3),
                 reflectivity=0.9, scatter_reflect=0.4)
    b.add_sphere((0.7, 0.0, -2.8), 0.5, color=(0.8, 0.8, 0.8),
                 refractive_index=1.5, refractivity=0.85, reflectivity=0.15)
    b.add_light((0.0, 1.6, -3.0), (0.35, 0.35, 0.35))
    cam = Camera.make((0.0, 0.4, 0.8), (0.0, -0.1, -1.0), fov_y_deg=60.0, focus_dist=3.8)
    return b.build(), cam


def moved(scene_cam, index, dp):
    """The scene with object ``index`` in motion by ``dp``."""
    scene, camera = scene_cam
    d = torch.zeros_like(scene.delta_position)
    d[index] = torch.tensor(dp)
    return scene.replace(delta_position=d), camera


# instantiation -> (scene, shading, with its lights) of its canary; the
# name of its entry on the kernels line after it
SHADING_CANARIES = {
    "uber_mat": (examples.materials_scene, "materials", False),
    "uber_m_mat": (lambda: moved(examples.materials_scene(), 3, (0.2, 0.0, 0.0)), "materials",
                   False),
    "uber_g_mat": (examples.groups_scene, "materials", False),
    "uber_g_m_mat": (moving_groups_scene, "materials", False),
    "uber_g_lt": (examples.lights_scene, "bvh", True),
    "uber_g_m_lt": (lambda: moved(examples.lights_scene(), 6, (0.2, 0.0, 0.0)), "bvh", True),
    "uber_lt": (lit_spheres_scene, "bvh", True),
    "uber_m_lt": (lambda: moved(lit_spheres_scene(), 1, (0.2, 0.0, 0.0)), "bvh", True),
}
KERNEL_ENTRY = {"uber": "uber_render", "uber_g": "uber_render_generic",
                "uber_m": "uber_render_motion", "uber_g_m": "uber_render_generic_motion"}
KERNEL_ENTRY.update({name: KERNEL_ENTRY[name.rsplit("_", 1)[0]] + (
    "_materials" if name.endswith("_mat") else "_lights") for name in SHADING_CANARIES})


def instantiation_of(name):
    """'uber_kernel<1,0,2,1>' for the launch counter 'uber_g_mat_tex'."""
    tex = name.endswith("_tex")
    base = name[:-len("_tex")] if tex else name
    sh = 2 if base.endswith("_mat") else 1 if base.endswith("_lt") else 0
    return f"uber_kernel<{int('_g' in base)},{int('_m_' in base + '_')},{sh},{int(tex)}>"


def shading_inputs(dev, name, frame, spec=None):
    """(scene, camera, cfg, Lights or None, K1's accel, camera vector, statics,
    lights rows, packed atlas or None) of instantiation ``name``'s scene at
    ``frame``; ``spec``: (scene maker, shading, lit) in place of the
    instantiation's canary's."""
    from raytracing_tests_tpu_torch.kernels.texture import pack_atlas
    from raytracing_tests_tpu_torch.ops.render import extract_lights

    make, shading, lit = spec or CANARY_SCENES[name]
    scene, camera = make()
    scene, camera = scene.to(dev), camera.to(dev)
    cfg = RenderConfig(intersector="pallas", shading=shading, **frame).for_scene(scene)
    lights = extract_lights(scene) if lit else None
    rows, n = uber.pack_lights(lights)
    acc, cam, _ = k1_inputs(scene, camera, cfg)
    st = uber.UberStatics.from_cfg(cfg, n)
    atlas = None if scene.textures is None else pack_atlas(scene.textures)
    selected = uber.launch_name(acc, st.model, atlas is not None)
    require(selected == name, f"{name}'s scene selects {selected}")
    return scene, camera, cfg, lights, acc, cam, st, rows, atlas


def corner_samples(st):
    """Samples whose shadow rays aim at a corner of the light's box (sample s
    with s / spp in CORNER_RATIOS), as a (B,) mask in p-linear order."""
    s = torch.arange(st.B, device="cuda") % st.spp
    return sum(s == r * st.spp for r in CORNER_RATIOS).bool()


def shading_vs_plain(name, acc, cam, st, rows, out_p, stats_p, atlas=None):
    """The new instantiation against its plain version's ``out_p``, both
    builds, per sample -> (default, -fmad=false, default build's out)."""
    k1, got = compare_uber(acc, cam, st, out_p, stats_p, rows, atlas)
    with _build.precise():
        k1_precise, got_p = compare_uber(acc, cam, st, out_p, stats_p, rows, atlas)
    if st.n_lights or atlas is not None:
        # the same numbers off the samples whose shadow rays aim at a corner
        # of a light's box (lights) and whose primary hit lies on a cube
        # edge of its atlas (textures)
        corner = corner_samples(st) if st.n_lights else torch.zeros_like(out_p[:, 0], dtype=bool)
        seam = seam_samples(acc, cam, st, rows) if atlas is not None else torch.zeros_like(corner)
        keep = ~(corner | seam)
        for res, (out_k, _) in ((k1, got), (k1_precise, got_p)):
            cerr = (out_k[keep, :3] - out_p[keep, :3]).abs().amax(dim=1)
            res["off_marked_samples"] = dict(share=frac(keep), corner_share=frac(corner),
                                             seam_share=frac(seam),
                                             colour_within_1e4=frac(cerr <= 1e-4))
    cerr = (got_p[0][:, :3] - out_p[:, :3]).abs().amax(dim=1)
    k1_precise["colour_within_1e6"] = frac(cerr <= 1e-6)
    k1_precise["bitwise"] = frac((got_p[0] == out_p).all(dim=1))
    return k1, k1_precise, got


def check_shading(name, plain_dropped, k1, k1_precise):
    """The -fmad=false build within 1e-4 on >= SHADING_PRECISE of the samples
    (for lights and textures: of those off the marked ones, corner-aimed and
    face-seam samples) and rays within 0.05 %; the default build by the
    frame's statistical bars (check_uber's, with the per-sample colour bars
    taken off the marked samples)."""
    require(plain_dropped == 0 and k1["dropped"] == k1_precise["dropped"] == 0
            and k1["finite"] and k1_precise["finite"], f"{name}: {k1} {k1_precise}")
    within = k1_precise.get("off_marked_samples", k1_precise)["colour_within_1e4"]
    require(within >= SHADING_PRECISE and k1_precise["ray_count_rel_diff"] < 5e-4
            and k1_precise["primary_t_within_rtol_1e4"] >= 0.999,
            f"{name}: the -fmad=false build disagrees with the plain version: {k1_precise}")
    near = k1.get("off_marked_samples", k1)["colour_within_1e4"]
    require(k1["primary_t_within_rtol_1e4"] >= 0.999 and near >= 0.85
            and k1["colour_within_5e2"] >= 0.9 and k1["mean_abs_diff"] < 5e-3
            and k1["ray_count_rel_diff"] < 5e-3,
            f"{name}: the default build disagrees with the plain version: {k1}")


def k1_bound(acc, st, stats, rows=None, atlas=None):
    """K1's least time for this run's work: its output, the tables, the
    camera, lights and atlas texels once over the memory rate, or the
    operations its counters say it did over the fp32 peak -> (ms, by)."""
    n_nodes, n_shadow = int(stats[uber.ST_RAYS]), int(stats[uber.ST_SHADOW_RAYS])
    shade = FLOPS_PER_MATERIALS_SHADE if st.shading == "materials" else FLOPS_PER_NODE_SHADE
    n_bytes = (16 * st.B + accel_bytes(acc) + 4 * uber.CAM_LEN
               + (0 if rows is None else 4 * rows.numel())
               + (0 if atlas is None else 4 * atlas[0].numel()))
    if acc.mode == "generic":
        flops = (int(stats[uber.ST_SPHERE_TESTS]) * FLOPS_PER_CENSUS_SPHERE_ROW
                 + int(stats[uber.ST_OTHER_TESTS]) * FLOPS_PER_GENERIC_ROW
                 + int(stats[uber.ST_SLAB_TESTS]) * FLOPS_PER_SLAB_TEST
                 + int(stats[uber.ST_HITS]) * FLOPS_PER_REFINE_G + n_nodes * shade)
    else:
        per_test = FLOPS_PER_SPHERE_TEST + (FLOPS_PER_MOTION_TERMS if acc.has_motion else 0)
        flops = (int(stats[uber.ST_SPHERE_TESTS]) * per_test
                 + (n_nodes + n_shadow) * acc.n_groups * FLOPS_PER_SLAB_TEST + n_nodes * shade)
    return bound(n_bytes, flops + n_shadow * FLOPS_PER_SHADOW_RAY
                 + int(stats[uber.ST_TEX_SAMPLES]) * FLOPS_PER_TEX_SAMPLE)


def shading_frame(dev, what, name, spec=None):
    """Phase materials_frame / lights_frame / texturing_frame /
    texturing_image_frame: the frame through render_uber (one warm frame,
    three timed), K1 against its plain version on every primary, the
    schedules bit for bit, and where the frame's time goes -> (numbers, the
    kernels-line fields).  ``spec``: the frame's (scene maker, shading, lit)
    where it is not the canary's scene of ``name``."""
    from raytracing_tests_tpu_torch.kernels.texture import pack_atlas

    scene, camera, cfg, lights, acc, cam, st, rows, atlas = shading_inputs(
        dev, name, SHADING_FRAME, spec)
    out, times, launches = timed_frames(
        lambda: uber.render_uber(scene, camera, cfg, lights, gr=GR))
    for got in launches:
        require(got == {name: 1}, f"a {what} frame is one launch of {name}: {launches}")
    plain_ms, (out_p, stats_p) = timed_ms(
        lambda: uber.uber_render_plain(acc, cam, st, rows, atlas))
    img_p = uber._uber_post(out_p, stats_p, cfg)["image"]
    k1, k1_precise, got = shading_vs_plain(name, acc, cam, st, rows, out_p, stats_p, atlas)
    px = compare_pixels(uber._uber_post(*got, cfg)["image"], img_p)
    del got
    ms_k1 = cuda_ms(lambda: uber.uber_render(acc, cam, st, rows, atlas), 3)
    with coop(1):
        ms_k1_lane = cuda_ms(lambda: uber.uber_render(acc, cam, st, rows, atlas), 3)
        _, stats_lane = uber.uber_render(acc, cam, st, rows, atlas)
    _, stats_k = uber.uber_render(acc, cam, st, rows, atlas)
    t0 = time.perf_counter()
    for _ in range(3):
        uber._scene_accel(scene, camera, cfg, min(GR, max(8, -(-scene.capacity // 8) * 8)))
        if atlas is not None:
            pack_atlas(scene.textures)
    torch.cuda.synchronize()
    accel_ms = (time.perf_counter() - t0) / 3 * 1e3
    out_k, _ = uber.uber_render(acc, cam, st, rows, atlas)
    post_ms = cuda_ms(lambda: uber._uber_post(out_k, stats_k, cfg), 3)
    del out_k
    bnd, by = k1_bound(acc, st, stats_k, rows, atlas)
    texture = {}
    if atlas is not None:
        # the cost of the atlas samples: the same frame through the
        # untextured instantiation, in the same call
        ms_plain_albedo = cuda_ms(lambda: uber.uber_render(acc, cam, st, rows), 3)
        n_tex = int(stats_k[uber.ST_TEX_SAMPLES])
        texture = dict(tex_samples=n_tex, atlas_bytes=4 * atlas[0].numel(),
                       kernel_ms_untextured=ms_plain_albedo,
                       tex_ns_per_sample=(ms_k1 - ms_plain_albedo) * 1e6 / max(n_tex, 1))
    rays, img = int(out["rays"]), out["image"]
    frame = dict(size=size_of(SHADING_FRAME), instantiation=name,
                 seconds_per_frame_min=min(times), seconds_per_frame_mean=sum(times) / len(times),
                 rays=rays, mrays_per_s=rays / min(times) / 1e6,
                 rays_dropped=int(out["rays_dropped"]), image_mean=float(img.mean()),
                 rays_plain=int(stats_p[uber.ST_RAYS]), image_mean_plain=float(img_p.mean()),
                 plain_seconds=plain_ms / 1e3, launches_per_frame=launches,
                 kernel_ms=ms_k1, kernel_ms_per_lane_mode=ms_k1_lane, bound_ms=bnd, bound_by=by,
                 accel_build_ms=accel_ms, epilogue_ms=post_ms,
                 shadow_rays=int(stats_k[uber.ST_SHADOW_RAYS]), **texture, **simt(stats_k),
                 default_build=k1, precise_build=k1_precise, pixels_default_vs_plain=px)
    say(phase=f"{what}_frame", **frame)
    require(tuple(img.shape) == (cfg.height, cfg.width, 3) and bool(torch.isfinite(img).all())
            and frame["rays_dropped"] == 0, f"{what} frame: {frame}")
    require(abs(rays - frame["rays_plain"]) / frame["rays_plain"] < SHADING_FRAME_RAYS
            and abs(frame["image_mean"] - frame["image_mean_plain"]) < SHADING_FRAME_MEAN,
            f"{what} frame against its plain version: {frame}")
    check_shading(f"{what} frame", int(stats_p[uber.ST_DROPPED]), k1, k1_precise)
    require(min(ms_k1, ms_k1_lane) > bnd, f"{what}: K1 below its bound, a counting error")
    modes = modes_identical(f"{what} frame", acc, cam, st, rows, atlas)
    say(phase="uber_modes", what=f"{what} frame", precise_build=modes)
    sweep = coop_sweep(f"{what} frame", acc, cam, st, rows, atlas)
    del out, out_p
    entry = dict(launches=launches[-1][name], max_abs_err=px["max_abs_err"],
                 per_sample_max_abs_err=k1["colour_max_abs_err"],
                 frac_within_tolerance=k1_precise.get(
                     "off_corner_samples", k1_precise)["colour_within_1e4"],
                 per_sample_frac_within_1e4=k1["colour_within_1e4"],
                 per_sample_frac_within_1e4_precise_build=k1_precise["colour_within_1e4"],
                 ms=ms_k1, ms_per_lane_mode=ms_k1_lane, plain_ms=plain_ms, bound_ms=bnd,
                 bound_by=by, simt_efficiency=simt(stats_k)["simt_efficiency"],
                 simt_efficiency_per_lane_mode=simt(stats_lane)["simt_efficiency"],
                 shape=size_of(SHADING_FRAME) + f", {what}_scene()", **texture,
                 at_frame=frame_sweep(sweep, uber.COOP_MIN[acc.mode],
                                      schedules_bit_identical=True))
    return frame, entry


def shading_canary(dev, name):
    """The new instantiation's canary at 200x112x8 d6: K1 against the queue
    renderer under the reference envelope, and against its plain version
    (both builds) -> (launches of the path, numbers, kernels-line fields)."""
    scene, camera, cfg, lights, acc, cam, st, rows, atlas = shading_inputs(dev, name, SMALL)
    _build.reset_launches()
    ou = uber.render_uber(scene, camera, cfg, lights, gr=GR)
    oq = render_stats(scene, camera, cfg, lights)
    launches = dict(_build.LAUNCHES)
    env = parity(ou, oq)
    check_parity(f"{name} canary", env, lights=lights is not None)
    queue_kernel = "sweep_grouped" if acc.mode == "generic" else "sweep2_m" if acc.has_motion \
        else "sweep2"
    require(launches.get(name) == 1 and launches.get(queue_kernel, 0) > 0
            and set(launches) == {name, queue_kernel},
            f"the {name} canary's launches: {launches}")
    plain_ms, (out_p, stats_p) = timed_ms(
        lambda: uber.uber_render_plain(acc, cam, st, rows, atlas))
    k1, k1_precise, got = shading_vs_plain(name, acc, cam, st, rows, out_p, stats_p, atlas)
    px = compare_pixels(uber._uber_post(*got, cfg)["image"],
                        uber._uber_post(out_p, stats_p, cfg)["image"])
    check_shading(f"{name} canary", int(stats_p[uber.ST_DROPPED]), k1, k1_precise)
    ms = device_ms(lambda: uber.uber_render(acc, cam, st, rows, atlas), 10)
    with coop(1):
        ms_lane = device_ms(lambda: uber.uber_render(acc, cam, st, rows, atlas), 10)
        _, stats_lane = uber.uber_render(acc, cam, st, rows, atlas)
    _, stats_k = uber.uber_render(acc, cam, st, rows, atlas)
    bnd, by = k1_bound(acc, st, stats_k, rows, atlas)
    modes = modes_identical(f"{name} canary", acc, cam, st, rows, atlas)
    say(phase="shading_canary", instantiation=name, size=size_of(SMALL), launches=launches,
        **env, default_build=k1, precise_build=k1_precise, pixels_default_vs_plain=px,
        kernel_ms=ms, bound_ms=bnd, schedules_bit_identical=True,
        simt=modes[str(FORCED[0])]["simt_efficiency"])
    require(min(ms, ms_lane) > bnd, f"{name}: K1 below its bound, a counting error")
    entry = dict(launches=launches[name], max_abs_err=px["max_abs_err"],
                 per_sample_max_abs_err=k1["colour_max_abs_err"],
                 frac_within_tolerance=k1_precise.get(
                     "off_corner_samples", k1_precise)["colour_within_1e4"],
                 per_sample_frac_within_1e4=k1["colour_within_1e4"],
                 per_sample_frac_within_1e4_precise_build=k1_precise["colour_within_1e4"],
                 ms=ms, ms_per_lane_mode=ms_lane, plain_ms=plain_ms, bound_ms=bnd, bound_by=by,
                 simt_efficiency=simt(stats_k)["simt_efficiency"],
                 simt_efficiency_per_lane_mode=simt(stats_lane)["simt_efficiency"],
                 shape=size_of(SMALL) + f", {int(scene.valid.sum())} objects")
    return launches, entry


def glass_shells_scene(n):
    """``n`` concentric glass spheres of alternating refractive index over a
    ground sphere: a camera ray that enters them under materials shading
    stacks one reflection at each of the n surfaces it enters."""
    b = SceneBuilder()
    for k in range(n):
        b.add_sphere((0.0, 0.0, -3.0), 1.2 - k * (1.0 / n), color=(0.95, 0.95, 0.95),
                     refractive_index=(1.5, 1.3)[k % 2], refractivity=0.9, reflectivity=0.1)
    b.add_sphere((0.0, -101.3, -3.0), 100.0, color=(0.5, 0.6, 0.4), reflectivity=1.0,
                 scatter_reflect=1.0)
    return b.build(), Camera.make((0.0, 0.2, 0.5), (0.0, -0.05, -1.0), fov_y_deg=50.0,
                                  focus_dist=3.5)


def deep_stacks(dev):
    """Phase deep_stack: K1 with a stack of 16 and of 32 records against the
    queue renderer with the same stack, by the bars of 5 and with zero
    dropped: on ``deep_glass_spheres()`` at depth 8 under both shadings, and
    under materials shading (no contribution cutoff) on 12 and 24 concentric
    glass shells at depths 16 and 28, where half the stack drops rays, so the
    deeper one is used."""
    res = {}
    cases = [(f"deep_glass {shading} Q={q}", deep_glass_spheres, shading, q, 8, None)
             for q in (16, 32) for shading in ("bvh", "materials")]
    cases += [(f"shells_{n} materials Q={q}", lambda n=n: glass_shells_scene(n), "materials",
               q, depth, q // 2) for n, q, depth in ((12, 16, 16), (24, 32, 28))]
    for what, make, shading, q, depth, half in cases:
        scene, camera = make()
        scene, camera = scene.to(dev), camera.to(dev)
        cfg = RenderConfig(intersector="pallas", shading=shading, queue_capacity=q,
                           **dict(SMALL, max_bounces=depth)).for_scene(scene)
        _build.reset_launches()
        ou = uber.render_uber(scene, camera, cfg, gr=GR)
        launches = dict(_build.LAUNCHES)
        oq = render_stats(scene, camera, cfg)
        env = parity(ou, oq)
        r = res[what] = dict(depth=depth, pops=cfg.pops, rays=int(ou["rays"]),
                             rays_queue=oq["rays"], launches=launches, **env)
        check_parity(f"K1 with a stack of {q} ({what}) against the queue renderer", env)
        name = "uber_mat" if shading == "materials" else "uber"
        require(launches.get(name) == 1, f"deep stack {what}: {r}")
        if half:
            r[f"rays_dropped_at_q{half}"] = int(
                uber.render_uber(scene, camera, cfg, gr=GR, qcap=half)["rays_dropped"])
            require(r[f"rays_dropped_at_q{half}"] > 0, f"{what} does not use the deep stack: {r}")
    say(phase="deep_stack", **res)
    return res


def workqueue_lights(dev):
    """Phase workqueue_lights: ``render_workqueue`` with lights on the sphere
    lights canary against the queue renderer given a full tree's budget, as
    phase 15; K2 launched once per iteration."""
    scene, camera, cfg, lights, *_ = shading_inputs(dev, "uber_lt", SMALL)
    cfg_full = dataclasses.replace(cfg, max_pops=2 ** cfg.max_bounces)
    _build.reset_launches()
    ow = workqueue.render_workqueue(scene, camera, cfg, lights, chunk=16384)
    launches = dict(_build.LAUNCHES)
    oq = render_stats(scene, camera, cfg_full, lights)
    close = (ow["image"] - oq["image"]).abs().amax(dim=-1) <= 2e-5
    res = dict(size=size_of(SMALL), within_2e5=frac(close), rays=int(ow["rays"]),
               rays_queue=oq["rays"], iterations=ow["iterations"],
               rays_dropped=int(ow["rays_dropped"]), launches=launches)
    say(phase="workqueue_lights", **res)
    # Equal images.  The rays may differ: a queue renderer's lane whose sample
    # turned white pops its stacked siblings without tracing them, while in
    # the pool they are already queued and run (both as in the JAX package).
    require(res["within_2e5"] >= 0.995 and res["rays_queue"] <= res["rays"]
            and res["rays"] <= 1.02 * res["rays_queue"] and res["rays_dropped"] == 0
            and set(launches) == {"sweep2"} and launches["sweep2"] >= ow["iterations"],
            f"the work queue with lights against the queue renderer: {res}")
    return launches


def shading_phases(dev):
    """The sixth slice's phases -> (kernels-line entries, {path: launches})."""
    src = "raytracing_tests_tpu_torch/csrc/uber.cu"
    paths, entries = {}, []
    frames = {}
    for what, name in (("materials", "uber_mat"), ("lights", "uber_g_lt")):
        frames[name], entries_f = shading_frame(dev, what, name)
        paths[f"{what}_frame"] = frames[name]["launches_per_frame"][-1]
        entries.append((name, entries_f))
    for name in SHADING_CANARIES:
        launches, entry = shading_canary(dev, name)
        paths[f"{name}_canary"] = launches
        if name not in frames:
            entries.append((name, entry))
    paths["workqueue_lights"] = workqueue_lights(dev)
    deep = deep_stacks(dev)
    for q, r in deep.items():
        paths[f"deep_stack_{q}"] = r["launches"]
    tol = (f"the -fmad=false build within 1e-4 of the plain version on >= {SHADING_PRECISE} "
           "of the samples (lights: of those whose shadow rays do not aim at a corner of the "
           "light's box); the default build: primary t rtol 1e-4 on >= 99.9 %, channel means "
           "within 5e-3, rays within 0.5 %")
    out = []
    for name, fields in entries:
        by_path = {p: got.get(name, 0) for p, got in paths.items()}
        out.append(dict(name=KERNEL_ENTRY[name], instantiation=name, route="cuda", source=src,
                        replaces="raytracing_tests_tpu/kernels/uber.py:874",
                        launches_by_path=by_path, tolerance=tol, library_ms=None, **fields))
    return out, paths


# ---------------------------------------------------------------------------
# The seventh slice: cube-sphere textures through K1, the queue renderer and
# the work queue, and K1's camera variants
# ---------------------------------------------------------------------------

# uv (dominant axis, projection by division), the atlas coordinates, the
# floors, the clamped weights, three bilinear blends and the albedo product
FLOPS_PER_TEX_SAMPLE = 60
# A primary whose hit's unit-space position has its two largest components
# within this relative band lies on a cube edge of its atlas: the face turns
# on strict comparisons there, so a last-ulp difference in the refined hit
# reads another face's texel.  Those samples are held by their share only.
SEAM_BAND = 1e-5


def textured(scene_cam):
    """The scene with a checker and a gradient atlas on every object but each
    third (``texture_index`` 1, 2, 0, 1, ...)."""
    from raytracing_tests_tpu_torch.scene import textures as tx

    scene, camera = scene_cam
    atlases = [tx.checker_atlas(32), tx.gradient_atlas(32)]
    stack = np.stack([np.zeros_like(atlases[0])] + atlases)
    ti = ((torch.arange(scene.capacity) + 1) % 3).to(torch.int32)
    return scene.replace(textures=torch.from_numpy(stack),
                         texture_index=torch.where(scene.valid, ti, 0)), camera


def textured_box_scene():
    """A textured rotated box and a textured sphere over a ground sphere (the
    JAX package's generic texturing test, tests/test_pallas.py:440-460)."""
    from raytracing_tests_tpu_torch.scene import textures as tx

    b = SceneBuilder()
    checker = b.add_texture(tx.checker_atlas(32))
    grad = b.add_texture(tx.gradient_atlas(32))
    b.add_box((-0.8, 0.0, -4.0), (0.9, 0.9, 0.9), rotation_deg=(0.0, 30.0, 0.0),
              color=(1.0, 1.0, 1.0), reflectivity=0.85, scatter_reflect=0.2,
              texture_index=checker)
    b.add_sphere((0.9, 0.0, -3.6), 0.55, color=(1.0, 0.9, 0.9), reflectivity=0.9,
                 scatter_reflect=0.2, texture_index=grad)
    b.add_sphere((0.0, -100.6, -4.0), 100.0, color=(0.6, 0.6, 0.6), reflectivity=0.7,
                 scatter_reflect=0.9)
    return b.build(), Camera.make((0.0, 0.4, 0.8), (0.0, -0.1, -1.0), fov_y_deg=55.0,
                                  focus_dist=4.2)


# textured instantiation -> (scene, shading, with its lights) of its canary
TEXTURED_CANARIES = {
    "uber_tex": (examples.texturing_scene, "bvh", False),
    "uber_m_tex": (lambda: moved(examples.texturing_scene(), 1, (0.2, 0.0, 0.0)), "bvh", False),
    "uber_g_tex": (textured_box_scene, "bvh", False),
    "uber_g_m_tex": (lambda: moved(textured_box_scene(), 0, (0.2, 0.0, 0.0)), "bvh", False),
    "uber_mat_tex": (lambda: textured(examples.materials_scene()), "materials", False),
    "uber_m_mat_tex": (lambda: textured(moved(examples.materials_scene(), 3, (0.2, 0.0, 0.0))),
                       "materials", False),
    "uber_g_mat_tex": (lambda: textured(examples.groups_scene()), "materials", False),
    "uber_g_m_mat_tex": (lambda: textured(moving_groups_scene()), "materials", False),
    "uber_lt_tex": (lambda: textured(lit_spheres_scene()), "bvh", True),
    "uber_m_lt_tex": (lambda: textured(moved(lit_spheres_scene(), 1, (0.2, 0.0, 0.0))), "bvh",
                      True),
    "uber_g_lt_tex": (lambda: textured(examples.lights_scene()), "bvh", True),
    "uber_g_m_lt_tex": (lambda: textured(moved(examples.lights_scene(), 6, (0.2, 0.0, 0.0))),
                        "bvh", True),
}
CANARY_SCENES = {**SHADING_CANARIES, **TEXTURED_CANARIES}
KERNEL_ENTRY.update({name: KERNEL_ENTRY[name[:-len("_tex")]] + "_textured"
                     for name in TEXTURED_CANARIES})


def seam_samples(acc, cam, st, rows=None):
    """Samples whose primary hit is on a textured winner and lies within
    SEAM_BAND of a cube edge of its atlas, as a (B,) mask in p-linear order
    (the plain version's raygen, sweep and refine)."""
    from raytracing_tests_tpu_torch.kernels.sweep2 import FT_TEX

    out = []
    for p0 in range(0, st.B, 1 << 20):
        p = torch.arange(p0, min(st.B, p0 + (1 << 20)), device=acc.device)
        o, d, sidx, _ = uber._raygen(cam, st, p)
        omt = 1.0 - sidx / st.spp
        live = torch.ones_like(sidx, dtype=torch.bool)
        tlim = torch.full_like(sidx, st.t_max)
        if acc.mode == "generic":
            t, obj = sweep2g._sweep_plain_g(acc, o, d, omt, live, tlim)
        else:
            t, obj = sweep2._sweep_plain(acc, o, d, live, tlim, omt)
        hit = obj >= 0
        rows_w, _, _, _, _, lp = mega._refine(acc, o, d, t, obj, hit, omt)
        a = lp.abs().sort(dim=1).values
        out.append(hit & (rows_w[:, FT_TEX] > 0.5) & (a[:, 2] - a[:, 1] <= SEAM_BAND * a[:, 2]))
    return torch.cat(out)


def workqueue_textures(dev):
    """Phase workqueue_textures: ``render_workqueue`` on the texturing canary
    against the queue renderer given a full tree's budget, as phase 15;
    K2 launched once per iteration."""
    scene, camera, cfg, *_ = shading_inputs(dev, "uber_tex", SMALL)
    cfg_full = dataclasses.replace(cfg, max_pops=2 ** cfg.max_bounces)
    _build.reset_launches()
    ow = workqueue.render_workqueue(scene, camera, cfg, chunk=16384)
    launches = dict(_build.LAUNCHES)
    oq = render_stats(scene, camera, cfg_full)
    close = (ow["image"] - oq["image"]).abs().amax(dim=-1) <= 2e-5
    res = dict(size=size_of(SMALL), within_2e5=frac(close), rays=int(ow["rays"]),
               rays_queue=oq["rays"], iterations=ow["iterations"],
               rays_dropped=int(ow["rays_dropped"]), launches=launches)
    say(phase="workqueue_textures", **res)
    require(res["within_2e5"] >= 0.995 and res["rays"] == res["rays_queue"]
            and res["rays_dropped"] == 0 and set(launches) == {"sweep2"}
            and launches["sweep2"] >= ow["iterations"],
            f"the work queue with textures against the queue renderer: {res}")
    return launches


def camera_variant(camera, variant):
    """(camera, aa_grid) of ``variant``: the camera itself ('plain'); the
    aa_grid jitter; three focus distances around the camera's; an
    orthographic view of the height the perspective view has at the focus
    distance."""
    fd = camera.focus_dist[:1]
    if variant == "plain":
        return camera, False
    if variant == "aa_grid":
        return camera, True
    if variant == "multi_focus":
        return camera.replace(focus_dist=torch.cat([fd * 0.8, fd, fd * 1.25])), False
    return camera.replace(ortho_height=2.0 * fd[0] * torch.tan(camera.fov_y * 0.5)), False


def camera_canaries(dev):
    """Phase camera_canaries: each camera variant in sphere mode (the
    headline's scene) and generic mode (``groups_scene()``) at 200x112x8 d6:
    K1 against the queue renderer, and against its plain version in the
    -fmad=false build (colours within 1e-4 on >= SHADING_PRECISE of the
    samples, rays within 0.05 %) -> {path: launches}.  Against the queue
    renderer the generic canaries take check_parity's bars; the headline's
    scene takes phase 5's (the reference's envelope: means, rays, depth,
    drops), whose share of pixels off by 0.05 its 1000-radius ground sphere
    drives (printed beside the same share of the unvaried camera)."""
    paths, res = {}, {}
    for mode, make in (("spheres", examples.iow_final_scene), ("generic", examples.groups_scene)):
        for variant in (("plain",) if mode == "spheres" else ()) + (
                "aa_grid", "multi_focus", "orthographic"):
            scene, camera = make()
            camera, aa = camera_variant(camera, variant)
            scene, camera = scene.to(dev), camera.to(dev)
            cfg = RenderConfig(intersector="pallas", aa_grid=aa, **SMALL).for_scene(scene)
            _build.reset_launches()
            ou = uber.render_uber(scene, camera, cfg, gr=GR)
            oq = render_stats(scene, camera, cfg)
            launches = dict(_build.LAUNCHES)
            env = parity(ou, oq)
            what = f"{variant} camera, {mode}"
            if mode == "generic":
                check_parity(f"the {what} canary", env)
            require(env["finite"] and env["mean_image_diff"] < 5e-3
                    and abs(env["ray_count_ratio"] - 1.0) < 0.02
                    and env["depth_disagree_frac"] < 0.01 and env["rays_dropped"] == 0,
                    f"the {what} canary failed: {env}")
            acc, cam, _ = k1_inputs(scene, camera, cfg)
            st = uber.UberStatics.from_cfg(cfg, 0, camera)
            aat = uber.aa_table(st.W, st.H, st.spp, dev) if aa else None
            out_p, stats_p = uber.uber_render_plain(acc, cam, st, aa=aat)
            with _build.precise():
                k1_precise, _ = compare_uber(acc, cam, st, out_p, stats_p, aa=aat)
            require(k1_precise["colour_within_1e4"] >= SHADING_PRECISE
                    and k1_precise["ray_count_rel_diff"] < 5e-4 and k1_precise["dropped"] == 0,
                    f"the {what} canary: the -fmad=false build against the plain version: "
                    f"{k1_precise}")
            k1 = uber.launch_name(acc)
            require(launches.get(k1) == 1, f"the {what} canary's launches: {launches}")
            res[what] = dict(launches=launches, **env, precise_build=k1_precise)
            paths[f"{variant}_{mode}_camera_canary"] = launches
    say(phase="camera_canaries", size=size_of(SMALL), **res)
    return paths


def texturing_phases(dev):
    """The seventh slice's phases -> (kernels-line entries, {path: launches})."""
    src = "raytracing_tests_tpu_torch/csrc/uber_tex.cu"
    paths, entries, frames = {}, [], {}
    for what, make in (("texturing", examples.texturing_scene),
                       ("texturing_image", examples.texturing_image_scene)):
        frames[what] = shading_frame(dev, what, "uber_tex", (make, "bvh", False))
        paths[f"{what}_frame"] = frames[what][0]["launches_per_frame"][-1]
    entry = dict(frames["texturing"][1], at_texturing_image_frame={
        k: frames["texturing_image"][1][k] for k in ("ms", "ms_per_lane_mode", "plain_ms",
                                                    "bound_ms", "bound_by", "max_abs_err")})
    entries.append(("uber_tex", entry))
    for name in TEXTURED_CANARIES:
        launches, entry = shading_canary(dev, name)
        paths[f"{name}_canary"] = launches
        if name != "uber_tex":
            entries.append((name, entry))
    paths["workqueue_textures"] = workqueue_textures(dev)
    paths.update(camera_canaries(dev))
    tol = (f"the -fmad=false build within 1e-4 of the plain version on >= {SHADING_PRECISE} "
           "of the samples off the marked ones (a primary hit within SEAM_BAND of an atlas "
           "cube edge; with lights, a shadow ray aimed at a corner of the light's box); the "
           "default build: primary t rtol 1e-4 on >= 99.9 %, channel means within 5e-3, rays "
           "within 0.5 %")
    out = []
    for name, fields in entries:
        by_path = {p: got.get(name, 0) for p, got in paths.items()}
        out.append(dict(name=KERNEL_ENTRY[name], instantiation=name, route="cuda", source=src,
                        replaces="raytracing_tests_tpu/kernels/uber.py:874",
                        launches_by_path=by_path, tolerance=tol, library_ms=None, **fields))
    return out, paths


# ---------------------------------------------------------------------------
# The eighth slice: the gradient path, and the silhouette instantiations of
# K2 and K3 (sweep2_edge, sweep2_m_edge, sweep2g_edge, sweep2g_m_edge)
# ---------------------------------------------------------------------------

GRAD = dict(width=800, height=450, spp=16, max_bounces=8)  # bench.py:211-257 grad_config
BAND_SAMPLES = 300_000  # samples per band of the banded backward (grad_config's rule)
SOFT = 0.03  # soft_edges of the soft-edge frames
# Operation counts of the silhouette metric, per (live ray, row) evaluated:
# K2's (c_q - nb^2) * rinv2 and its compare on the anchored terms of the
# quadratic (counted in FLOPS_PER_SPHERE_TEST), K3's unit-space |f|^2, e.f,
# |e|^2, the reciprocal and the metric on the row's local frame
# (FLOPS_PER_GENERIC_ROW).  K2's pass is dense (every live ray and row).
# K3's culled pass evaluates the rows its counters name and bounds each
# block-table entry it counts (FLOPS_PER_EDGE_BOUND: the ball's distance to
# the line, the ahead test and the margins, in float32).
FLOPS_PER_EDGE_METRIC = 4
FLOPS_PER_EDGE_METRIC_G = 15
FLOPS_PER_EDGE_BOUND = 30
# The gradient step against the same step with the sweeps routed to their
# plain versions (``plain_sweeps``): the -fmad=false build must agree to the
# order of the atomic adds that gather each object's gradient (found: equal
# loss, every field within 3.1e-6 of its max |g|).  The default build fuses
# a*b+c, and on the 1000-radius ground sphere of iow_final_scene() a last-ulp
# difference moves a hit and flips grazing children and their whole subtrees
# (the forward frames' canary envelope); each flipped lane carries its own
# d(loss)/d(position, scale, fuzz) into another object's row, so the
# geometry and scatter fields' largest entries move by a tenth of the field's
# max |g| (found 0.114 position, 0.117 scale, 0.121 scatter_reflect; 1.3e-3 on
# the loss) while the appearance fields stay within 1e-3: held to twice that.
GRAD_PRECISE = dict(loss_rtol=1e-5, field_of_max=1e-3)
GRAD_DEFAULT = dict(loss_rtol=1e-2, field_of_max=0.25)
EDGE_PRECISE = 0.999  # share of identical t, obj and edge, -fmad=false build
# Default-build bars of the silhouette instantiations by pop: the first pop's
# are NEAREST_BARS.  The gradient path spawns its children from the
# closed-form recompute's hit point, whose error on the 1000-radius ground
# sphere exceeds the 1e-4 spawn offset, so second-pop rays start on that
# surface and its anchored quadratic's near root is zero within its error: the
# builds pick different roots there (found: the same winner on 0.99817, t
# within rtol 1e-4 on 0.967 of the agreeing hits; the candidates on 0.99999).
EDGE_BARS = {1: NEAREST_BARS, 2: dict(same=0.995, t_1e4=0.95, ri=0.999)}


def grad_bands(cfg):
    """The smallest divisor of the height whose bands hold <= BAND_SAMPLES."""
    want = max(1, -(-cfg.width * cfg.height * cfg.spp // BAND_SAMPLES))
    return min(b for b in range(want, cfg.height + 1) if cfg.height % b == 0)


@contextlib.contextmanager
def patched(module, name, fn):
    saved = getattr(module, name)
    setattr(module, name, fn)
    try:
        yield saved
    finally:
        setattr(module, name, saved)


@contextlib.contextmanager
def plain_sweeps():
    """Inside: the sweep wrappers of K2 and K3 (both instantiations each) run
    their plain versions on the card: the gradient path with no kernel."""
    with contextlib.ExitStack() as stack:
        for module, name, plain in (
                (sweep2, "_sweep2", lambda a, r, ri, f, stats=None: sweep2.sweep2_plain(a, r, ri, f)),
                (sweep2, "_sweep2_edge", lambda a, r, stats=None: sweep2.sweep2_edge_plain(a, r)),
                (sweep2g, "_sweep2g", lambda a, r, stats=None: sweep2g.sweep2g_plain(a, r)),
                (sweep2g, "_sweep2g_edge",
                 lambda a, r, stats=None: sweep2g.sweep2g_edge_plain(a, r))):
            stack.enter_context(patched(module, name, plain))
        yield


@contextlib.contextmanager
def launch_events(module, name):
    """Every call of ``module.name`` between two CUDA events -> [(start, end)].
    Each launch of the gradient path follows a host read, so the card waits
    for it and the pair times the kernel (and its launch latency)."""
    pairs = []
    real = getattr(module, name)

    def timed(*args, **kw):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        out = real(*args, **kw)
        b.record()
        pairs.append((a, b))
        return out

    with patched(module, name, timed):
        yield pairs


def events_ms(pairs):
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs)


@contextlib.contextmanager
def captured(module, name, n):
    """The (accel, rays) of the first ``n`` calls of the sweep wrapper
    ``module.name``."""
    got = []
    real = getattr(module, name)

    def keep(accel, rays, *args, **kw):
        if len(got) < n:
            got.append((accel, rays.clone()))
        return real(accel, rays, *args, **kw)

    with patched(module, name, keep):
        yield got


def grad_inputs(dev, scene_cam, perturb, soft=0.0):
    """A gradient frame as grad_config builds it: the forward render of the
    scene (render_stats) is the target, ``perturb`` makes the trained scene,
    bands by BAND_SAMPLES, band depths probed on the gradient path + 2."""
    scene, cam = (x.to(dev) for x in scene_cam)
    cfg = dataclasses.replace(RenderConfig(intersector="pallas", **GRAD).for_scene(scene),
                              soft_edges=soft)
    fwd_ms, fwd = timed_ms(lambda: render_stats(scene, cam, cfg))
    pert = perturb(scene)
    bands = grad_bands(cfg)
    probe_ms, pops = timed_ms(lambda: diff.probe_band_pops(pert, cam, cfg, bands))
    return dict(scene=scene, cam=cam, cfg=cfg, pert=pert, p=diff.extract_params(pert),
                target=fwd["image"], rays=int(fwd["rays"]), forward_ms=fwd_ms, probe_ms=probe_ms,
                bands=bands, pops=[q + diff.train.POPS_MARGIN for q in pops])


def grad_step(g):
    """One banded_value_and_grad of the frame -> its numbers and results."""
    vg = diff.banded_value_and_grad(g["pert"], g["cam"], g["cfg"], grad_bands=g["bands"],
                                    band_pops=g["pops"])
    _build.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    ms, (loss, grads) = timed_ms(lambda: vg(g["p"], g["target"]))
    return dict(ms=ms, loss=loss, grads=grads, launches=dict(_build.LAUNCHES),
                peak_memory_bytes=torch.cuda.max_memory_allocated())


def compare_grads(got, want):
    """Loss and every field's gradient of two steps: relative loss difference
    and, per field, the largest difference over the field's max |g|."""
    fields = {}
    for name, w in want["grads"].items():
        scale = float(w.abs().max())
        dg = getattr(got["grads"], name) - w
        err = float(dg.abs().max())
        norm = float(w.norm())
        fields[name] = dict(max_abs_g=scale, err_of_max=err / scale if scale > 0 else err,
                            rel_l2=float(dg.norm()) / norm if norm > 0 else float(dg.norm()))
    finite = all(bool(torch.isfinite(v).all()) for _, v in got["grads"].items())
    return dict(loss=float(got["loss"]), loss_rel_err=abs(float(got["loss"]) / float(want["loss"]) - 1.0),
                worst_field_err_of_max=max(f["err_of_max"] for f in fields.values()),
                finite=finite, fields=fields)


def check_grads(what, res, bars):
    require(res["finite"] and res["loss_rel_err"] <= bars["loss_rtol"]
            and res["worst_field_err_of_max"] <= bars["field_of_max"],
            f"{what}: the gradient step disagrees with its plain version: {res} (bars {bars})")


def band_device_share(g, b):
    """Band ``b`` of the frame's gradient step: its wall time by the host
    clock, then once more under torch.profiler (device activity only) for the
    card's busy time: the idle share of the unprofiled wall time, and the
    sweep kernels' share."""
    from torch.profiler import ProfilerActivity, profile

    from raytracing_tests_tpu_torch.diff.train import _buckets, _diff_cfg, _grads_of, _leaves
    from raytracing_tests_tpu_torch.ops.render import _build_accel, finalize, trace_lanes

    cfg = _diff_cfg(g["cfg"])
    ceil = next(c for c, idxs in _buckets(g["pops"], g["bands"], cfg.pops) if b in idxs)
    cfg = dataclasses.replace(cfg, max_pops=ceil)
    H, W, S = cfg.height, cfg.width, cfg.spp
    h = H // g["bands"]
    lo, ld, ltr, ls = _lane_inputs(g["cam"], dataclasses.replace(cfg, aa_grid=False))
    sl = slice(b * h * W * S, (b + 1) * h * W * S)
    leaves = _leaves(g["p"], lo.device)
    scene = diff.apply_params(g["scene"], leaves)

    def run():
        accel = _build_accel(scene, cfg)
        color, pt, _, _ = trace_lanes(scene, None, cfg, lo[sl], ld[sl], ltr[sl], ls[sl], accel)
        img = finalize(color.reshape(h, W, S, 3), pt.reshape(h, W, S), cfg)["image"]
        _grads_of(torch.sum((img - g["target"][b * h:(b + 1) * h]) ** 2), leaves)

    run()
    wall, _ = timed_ms(run)  # the host clock, unprofiled
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    by = {e.key: e.self_device_time_total / 1e3 for e in prof.key_averages()
          if e.device_type == torch.autograd.DeviceType.CUDA}
    busy = sum(by.values())
    sweeps = sum(v for k, v in by.items() if "sweep2" in k)
    return dict(band=b, pops=ceil, wall_ms=wall, device_busy_ms=busy,
                device_idle_share=1.0 - busy / wall, sweep_kernels_ms=sweeps,
                kernels_traced=len(by))


def compare_edge(got, want, rays):
    """(t, obj, edge) of a silhouette instantiation against its plain version."""
    res = compare_nearest(got[:2], want[:2], rays)
    dead = (rays[3:6] * rays[3:6]).sum(dim=0) < 0.5
    res.update(same_edge=frac(got[2] == want[2]), edge_frac=frac(want[2] >= 0),
               t_identical=frac(got[0] == want[0]),
               dead_rays_no_edge=bool((got[2][dead] == -1).all()))
    return res


def check_edge(what, res, precise, bars):
    for r in (res, precise):
        require(r["dead_rays_miss"] and r["misses_report_the_limit"] and r["dead_rays_no_edge"],
                f"{what}: dead rays or misses are wrong: {r}")
    require(min(precise["same_obj"], precise["same_edge"], precise["t_identical"]) >= EDGE_PRECISE,
            f"{what}: the -fmad=false build disagrees with the plain version: {precise}")
    require(res["same_obj"] >= bars["same"] and res["t_within_rtol_1e4"] >= bars["t_1e4"]
            and res["same_edge"] >= NEAREST_BARS["same"],
            f"{what}: the kernel disagrees with the plain version: {res} (bars {bars})")


# launch counter -> (module, wrapper, plain version, the TPU kernel's site)
EDGE_KERNELS = {
    "sweep2_edge": (sweep2, "_sweep2_edge", sweep2.sweep2_edge_plain, "sweep2.py:955"),
    "sweep2_m_edge": (sweep2, "_sweep2_edge", sweep2.sweep2_edge_plain, "sweep2.py:955"),
    "sweep2g_edge": (sweep2g, "_sweep2g_edge", sweep2g.sweep2g_edge_plain, "sweep2g.py:838"),
    "sweep2g_m_edge": (sweep2g, "_sweep2g_edge", sweep2g.sweep2g_edge_plain, "sweep2g.py:838"),
}


def first_two_pops(g, name, band):
    """The (accel, rays) of the first two launches of the sweep wrapper of
    ``name`` (a K3 or silhouette launch counter) when band ``band`` of the
    frame's gradient path is traced (detached)."""
    from raytracing_tests_tpu_torch.diff.train import _diff_cfg
    from raytracing_tests_tpu_torch.ops.render import _build_accel, trace_lanes

    module, wrapper, _, _ = POP_KERNELS[name]
    cfg = dataclasses.replace(_diff_cfg(g["cfg"]), max_pops=2)
    lo, ld, ltr, ls = _lane_inputs(g["cam"], cfg)
    n = lo.shape[0] // g["bands"]
    sl = slice(band * n, (band + 1) * n)
    with torch.no_grad(), captured(module, wrapper, 2) as got:
        trace_lanes(g["pert"], None, cfg, lo[sl], ld[sl], ltr[sl], ls[sl],
                    _build_accel(g["pert"], cfg))
    require(len(got) == 2, f"{name}: band {band} made {len(got)} launches")
    return got


def edge_bound(name, accel, rays, stats):
    """The least time for the silhouette sweep on ``rays`` -> dict(bound_ms,
    bound_by, culled_bound_ms, dense_bound_ms, rows).  Dense: every (live
    ray, row) pair's anchored or local terms and the metric, the nearest-hit
    sweep's slab tests, rays in and (t, obj, edge) out, the tables once.
    Culled (K3, from its counters): the nearest-hit sweep's slab tests and
    rows, the block-table entries bounded and the rows whose metric was
    evaluated, the block table once more.  ``bound_ms`` is the lesser: both
    passes compute the same candidate, so the least work of the two is what
    the function needs."""
    B = rays.shape[1]
    live = (rays[3:6] * rays[3:6]).sum(dim=0) > 0.5
    n_live = int(live.sum())
    n_bytes = 4 * B * (8 + 3) + accel_bytes(accel)
    if name.startswith("sweep2g"):
        rows = int((accel.otab[:accel.n_pad, sweep2g.GO_VALID] > 0.0).sum())
        per = FLOPS_PER_GENERIC_ROW + FLOPS_PER_EDGE_METRIC_G
        slab = int(stats[sweep2g.GC_SLAB]) * FLOPS_PER_SLAB_TEST
        dense = bound(n_bytes, n_live * rows * per + slab)
        culled = bound(
            n_bytes + 4 * edge_cull.edge_blocks(accel)[0].numel(),
            slab + int(stats[sweep2g.GC_SPHERE_ROWS]) * FLOPS_PER_CENSUS_SPHERE_ROW
            + int(stats[sweep2g.GC_OTHER_ROWS]) * FLOPS_PER_CENSUS_CUBOID_ROW
            + int(stats[sweep2g.EC_BOUNDS]) * FLOPS_PER_EDGE_BOUND
            + int(stats[sweep2g.EC_ROWS_HIT] + stats[sweep2g.EC_ROWS_MISS]) * per)
    else:
        rows = accel.n_pad
        per = FLOPS_PER_SPHERE_TEST + FLOPS_PER_EDGE_METRIC
        per += FLOPS_PER_MOTION_TERMS if accel.has_motion else 0
        dense = bound(n_bytes, n_live * (rows * per + accel.n_groups * FLOPS_PER_SLAB_TEST))
        culled = None
    least = dense if culled is None else min(dense, culled)
    return dict(bound_ms=least[0], bound_by=least[1],
                culled_bound_ms=None if culled is None else culled[0],
                dense_bound_ms=dense[0], rows=rows)


def edge_pairs(rays, obj, stats, rows):
    """K3's culled pass: the share of (live ray, row) pairs whose metric it
    evaluated, for rays that hit and rays that missed; the walk's SIMT
    efficiency (rows evaluated / lane slots of its row iterations)."""
    act = (rays[3:6] * rays[3:6]).sum(dim=0) > 0.0  # the rays that look for a candidate
    hit = obj >= 0
    n_hit, n_miss = int((act & hit).sum()), int((act & ~hit).sum())
    r_hit, r_miss = int(stats[sweep2g.EC_ROWS_HIT]), int(stats[sweep2g.EC_ROWS_MISS])
    return dict(rays_hit=n_hit, rays_missed=n_miss, rows_evaluated_hit=r_hit,
                rows_evaluated_miss=r_miss,
                pairs_share_hit=r_hit / max(n_hit * rows, 1),
                pairs_share_miss=r_miss / max(n_miss * rows, 1),
                pairs_share=(r_hit + r_miss) / max((n_hit + n_miss) * rows, 1),
                bounds_per_ray=int(stats[sweep2g.EC_BOUNDS]) / max(n_hit + n_miss, 1),
                walk_simt_efficiency=(r_hit + r_miss) / max(int(stats[sweep2g.EC_SLOTS]), 1))


# K3's wrappers by launch counter: the nearest-hit sweep, then its EDGE twins.
POP_KERNELS = {"sweep2g": (sweep2g, "_sweep2g", sweep2g.sweep2g_plain, "sweep2g.py:838"),
               **EDGE_KERNELS}
# The counters of K3 that a schedule cannot change: slab tests and live rows by
# kind, and with EDGE the silhouette walk's, which reads the same winners.
K3_SAME = (sweep2g.GC_SLAB, sweep2g.GC_SPHERE_ROWS, sweep2g.GC_OTHER_ROWS)
K3_EDGE_SAME = K3_SAME + (sweep2g.EC_BOUNDS, sweep2g.EC_ROWS_HIT, sweep2g.EC_ROWS_MISS,
                          sweep2g.EC_SLOTS)


def k3_simt(stats):
    """SIMT efficiency of K3's nearest-hit sweep: the live rows the walk of one
    thread per ray tests over the lane slots the warps issued; and its
    row-parallel group visits."""
    slots = int(stats[sweep2g.GC_SLOTS])
    rows = int(stats[sweep2g.GC_SPHERE_ROWS]) + int(stats[sweep2g.GC_OTHER_ROWS])
    return dict(simt_efficiency=rows / max(slots, 1), lane_slots=slots,
                coop_visits=int(stats[sweep2g.GC_COOP]))


def k3_nearest_bound(accel, B, stats):
    """The least time of K3's nearest-hit sweep on B rays, from its counters:
    rays in and (t, obj) out, the tables once; the slab tests and the live rows
    by kind -> (ms, "bytes" or "operations")."""
    return bound(40 * B + 4 * (accel.otab.numel() + accel.gaabb.numel()),
                 int(stats[sweep2g.GC_SLAB]) * FLOPS_PER_SLAB_TEST
                 + int(stats[sweep2g.GC_SPHERE_ROWS]) * FLOPS_PER_CENSUS_SPHERE_ROW
                 + int(stats[sweep2g.GC_OTHER_ROWS]) * FLOPS_PER_CENSUS_CUBOID_ROW)


def k3_run(name, accel, rays):
    """One launch of K3's wrapper for ``name`` with its counters -> (outputs, stats)."""
    module, wrapper, _, _ = POP_KERNELS[name]
    stats = torch.zeros(sweep2g.GC_LEN if name == "sweep2g" else sweep2g.EC_LEN,
                        dtype=torch.int64, device=rays.device)
    return getattr(module, wrapper)(accel, rays, stats), stats


def k3_sweep_modes(k3_in):
    """Phase sweep_modes, K3's part: each input ({label: (launch counter, accel,
    rays)}) in coop_min 1, 33 and the default of the -fmad=false build:
    bit-identical outputs and counters (``schedules_identical``), and the
    plain version's t, obj and edge on every ray."""
    res = {}
    for label, (name, accel, rays) in k3_in.items():
        same = K3_SAME if name == "sweep2g" else K3_EDGE_SAME
        modes = schedules_identical(f"K3 {name} {label}", lambda: k3_run(name, accel, rays),
                                    same, k3_simt)
        want = POP_KERNELS[name][2](accel, rays)
        with _build.precise():
            got, _ = k3_run(name, accel, rays)
        exact = {k: frac(a == b) for k, a, b in zip(("t", "obj", "edge"), got, want)}
        res[f"{name} {label}"] = dict(rays=rays.shape[1], identical_to_plain=exact, **modes)
    say(phase="sweep_modes", what="K3 schedules bit for bit, -fmad=false build", **res)
    bad = {k: r["identical_to_plain"] for k, r in res.items()
           if min(r["identical_to_plain"].values()) < 1.0}
    require(not bad, f"K3's -fmad=false build differs from the plain version: {bad}")
    return res


def k3_coop_sweep(what, g, name):
    """K3's summed time over a generic gradient step, for each coop_min of
    COOP_SWEEP, every launch of ``name``'s wrapper timed in every schedule
    (``timed_by_coop``) -> ``frame_sweep``'s numbers, the launches and their
    bounds summed (each from its own counters, which no schedule changes)."""
    module, wrapper, _, _ = POP_KERNELS[name]
    edge = name != "sweep2g"
    calls, bounds = {}, []
    timer = timed_by_coop(getattr(module, wrapper), calls,
                          sweep2g.EC_LEN if edge else sweep2g.GC_LEN)

    def hook(accel, rays, stats=None):
        out = timer(accel, rays)
        st = calls[COOP_SWEEP[0]][-1][1]
        bounds.append(edge_bound(name, accel, rays, st)["bound_ms"] if edge
                      else k3_nearest_bound(accel, rays.shape[1], st)[0])
        return out

    with patched(module, wrapper, hook):
        grad_step(g)
    res = coop_sweep_table(calls, k3_simt)
    for cm, got in calls.items():
        ms = [min(a.elapsed_time(b) for a, b in events) for events, _ in got]
        below = [(k, ms[k], bounds[k]) for k in range(len(ms)) if ms[k] <= bounds[k]]
        require(not below, f"K3 {name} launches below their bound at coop_min {cm}, a "
                           f"counting error: {below[:5]}")
    default = sweep2g.COOP_MIN
    best = min(COOP_SWEEP, key=lambda cm: res[str(cm)]["ms"])
    say(phase="sweep_modes", what=f"K3 coop_min sweep, {what}", kernel=name, size=size_of(GRAD),
        launches=len(bounds), default_coop_min=default, fastest_coop_min=best,
        bound_ms_sum=sum(bounds), by_coop_min=res)
    return frame_sweep(res, default, launches=len(bounds), bound_ms_sum=sum(bounds),
                       fastest_coop_min=best)


def edge_vs_plain(name, g, band):
    """Phase edge_vs_plain for one instantiation, on the first two pops of a
    band of its gradient frame -> its kernels-line fields."""
    module, wrapper, plain, site = EDGE_KERNELS[name]
    run = getattr(module, wrapper)
    pops, out = first_two_pops(g, name, band), {}
    for k, (accel, rays) in enumerate(pops):
        require(accel.has_motion == ("_m_" in name), f"{name}: the frame's accel")
        plain_ms, want = timed_ms(lambda: plain(accel, rays))
        with _build.precise():
            precise = compare_edge(run(accel, rays), want, rays)
        res = compare_edge(run(accel, rays), want, rays)
        torch.cuda.synchronize()
        generic = name.startswith("sweep2g")
        stats = torch.zeros(sweep2g.EC_LEN if generic else sweep2.SW_LEN,
                            dtype=torch.int64, device=rays.device)
        _, obj, _ = run(accel, rays, stats)
        bnd = edge_bound(name, accel, rays, stats)
        out[f"pop{k + 1}"] = dict(rays=rays.shape[1], default_build=res, precise_build=precise,
                                  ms=cuda_ms(lambda: run(accel, rays), 10), plain_ms=plain_ms,
                                  **bnd, **(dict(edge_pairs(rays, obj, stats, bnd["rows"]),
                                                 nearest_simt_efficiency=k3_simt(
                                                     stats)["simt_efficiency"])
                                            if generic else {}))
    say(phase="edge_vs_plain", kernel=name, band=band, **out)
    for k in (1, 2):
        got = out[f"pop{k}"]
        check_edge(f"{name} on pop {k}", got["default_build"], got["precise_build"], EDGE_BARS[k])
        require(got["ms"] > got["bound_ms"], f"{name} below its bound: {got}")
    first = out["pop1"]
    worst = min((p["default_build"] for p in out.values()), key=lambda r: r["same_edge"])
    return dict(name=name, route="cuda", source="raytracing_tests_tpu_torch/csrc/" + (
                    "sweep2g.cu" if name.startswith("sweep2g") else "sweep2.cu"),
                replaces="raytracing_tests_tpu/kernels/" + site,
                max_abs_err=max(p["default_build"]["t_max_abs_err"] for p in out.values()),
                tolerance="default build: the plain version's winner and silhouette candidate "
                          "on >= 99.9 % of rays, t rtol 1e-4 on >= 99 % of the agreeing hits; "
                          "-fmad=false build: t, obj and edge identical on >= 99.9 %",
                frac_within_tolerance=min(worst["same_edge"], worst["same_obj"],
                                          worst["t_within_rtol_1e4"]),
                ms=first["ms"], plain_ms=first["plain_ms"], bound_ms=first["bound_ms"],
                bound_by=first["bound_by"], culled_bound_ms=first["culled_bound_ms"],
                dense_bound_ms=first["dense_bound_ms"], library_ms=None,
                shape=f"{first['rays']} rays (one band's first pop) x {first['rows']} rows",
                pairs_share_hit=first.get("pairs_share_hit"),
                pairs_share_miss=first.get("pairs_share_miss"),
                simt_efficiency=first.get("nearest_simt_efficiency"),
                at_second_pop={k: out["pop2"].get(k) for k in (
                    "rays", "ms", "plain_ms", "bound_ms", "culled_bound_ms", "dense_bound_ms",
                    "pairs_share_hit", "pairs_share_miss", "nearest_simt_efficiency")})


def grad_phases(dev, k3_canary):
    """The eighth slice's phases -> (kernels-line entries, {path: launches},
    K3's numbers over the hard generic step for its kernels-line entry).

    grad_frame (the sphere sweep through fastpath._winner), grad_soft_frame
    (its silhouette instantiation), grad_generic_soft (K3 and its silhouette
    instantiation on bvh1k, each also timed over COOP_SWEEP), grad_motion_soft
    (both moving silhouette instantiations), sweep_modes' K3 part (on
    ``k3_canary``, K3's (accel, rays) at the generic canary's lanes, and on
    the generic frames' first two pops), edge_vs_plain (the four silhouette
    instantiations against their plain versions on their frames' first two
    pops) and train_steps."""
    paths = {}
    recolour = lambda s: s.replace(color=s.color * 0.8 + 0.1)

    # grad_frame: bench.py's grad_config, through the kernels, the -fmad=false
    # build and the plain versions
    g = grad_inputs(dev, examples.iow_final_scene(), recolour)
    with launch_events(sweep2, "_sweep2") as ev:
        k = grad_step(g)
    k2_ms, n_k2 = events_ms(ev), len(ev)
    with _build.precise():
        kp = grad_step(g)
    with plain_sweeps():
        pl = grad_step(g)
    default, precise = compare_grads(k, pl), compare_grads(kp, pl)
    share = band_device_share(g, max(range(g["bands"]), key=lambda b: g["pops"][b]))
    frame = dict(size=size_of(GRAD), bands=g["bands"], band_pops=g["pops"],
                 seconds_per_step=k["ms"] / 1e3, plain_seconds_per_step=pl["ms"] / 1e3,
                 forward_rays=g["rays"], forward_seconds=g["forward_ms"] / 1e3,
                 step_over_forward=k["ms"] / g["forward_ms"],
                 mrays_equiv_per_s=g["rays"] / (k["ms"] / 1e3) / 1e6,
                 probe_seconds=g["probe_ms"] / 1e3, peak_memory_bytes=k["peak_memory_bytes"],
                 launches=k["launches"], k2_launches=n_k2, k2_device_ms=k2_ms,
                 deepest_band=share, default_build=default, precise_build=precise)
    say(phase="grad_frame", **frame)
    check_grads("grad_frame, -fmad=false build", precise, GRAD_PRECISE)
    check_grads("grad_frame, default build", default, GRAD_DEFAULT)
    require(set(k["launches"]) == {"sweep2"} and k["launches"]["sweep2"] == n_k2 > 0,
            f"grad_frame: the step runs K2 and nothing else: {k['launches']}")
    paths["grad_frame"] = k["launches"]
    edge_frames = {}

    # grad_soft_frame: the same frame with soft edges (K2's silhouette
    # instantiation)
    gs = dict(g, cfg=dataclasses.replace(g["cfg"], soft_edges=SOFT))
    _build.reset_launches()
    pops_ms, pops = timed_ms(lambda: diff.probe_band_pops(gs["pert"], gs["cam"], gs["cfg"],
                                                          gs["bands"]))
    gs.update(pops=[q + diff.train.POPS_MARGIN for q in pops], probe_ms=pops_ms)
    with launch_events(sweep2, "_sweep2_edge") as ev:
        ks = grad_step(gs)
    res = dict(size=size_of(GRAD), soft_edges=SOFT, band_pops=gs["pops"],
               seconds_per_step=ks["ms"] / 1e3, probe_seconds=pops_ms / 1e3,
               loss=float(ks["loss"]), peak_memory_bytes=ks["peak_memory_bytes"],
               launches=ks["launches"], edge_device_ms=events_ms(ev), edge_launches=len(ev),
               finite=all(bool(torch.isfinite(v).all()) for _, v in ks["grads"].items()))
    say(phase="grad_soft_frame", **res)
    require(res["finite"] and set(ks["launches"]) == {"sweep2_edge"},
            f"grad_soft_frame: {res}")
    paths["grad_soft_frame"] = ks["launches"]
    edge_frames["sweep2_edge"] = gs

    # grad_generic_soft: bvh1k, position trained, with and without soft edges
    rng = np.random.default_rng(SEED)

    def jitter(s):
        dpos = torch.from_numpy(rng.uniform(-0.1, 0.1, tuple(s.position.shape)).astype(np.float32))
        return s.replace(position=s.position + dpos.to(s.position.device))

    gg = grad_inputs(dev, examples.bvh_grid_scene(side=32), jitter, soft=SOFT)
    with launch_events(sweep2g, "_sweep2g_edge") as ev:
        kg = grad_step(gg)
    hard = dict(gg, cfg=dataclasses.replace(gg["cfg"], soft_edges=0.0))
    with launch_events(sweep2g, "_sweep2g") as ev_hard:
        kh = grad_step(hard)
    hard_ms = events_ms(ev_hard)
    # both steps once more with every K3 launch timed in each coop_min
    k3_hard = k3_coop_sweep("hard generic step", hard, "sweep2g")
    k3_soft = k3_coop_sweep("generic soft step", gg, "sweep2g_edge")
    res = dict(size=size_of(GRAD), objects=int(gg["scene"].num_valid), soft_edges=SOFT,
               band_pops=gg["pops"], seconds_per_step=kg["ms"] / 1e3,
               edge_device_ms=events_ms(ev), edge_launches=len(ev),
               edge_simt_efficiency=k3_soft["simt_efficiency"],
               edge_simt_efficiency_per_lane_mode=k3_soft["simt_efficiency_per_lane_mode"],
               hard_seconds_per_step=kh["ms"] / 1e3, hard_device_ms=hard_ms,
               hard_k3_launches=len(ev_hard), hard_bound_ms=k3_hard["bound_ms_sum"],
               hard_ms_above_bound=hard_ms - k3_hard["bound_ms_sum"],
               hard_simt_efficiency=k3_hard["simt_efficiency"],
               hard_simt_efficiency_per_lane_mode=k3_hard["simt_efficiency_per_lane_mode"],
               loss=float(kg["loss"]),
               hard_loss=float(kh["loss"]), peak_memory_bytes=kg["peak_memory_bytes"],
               launches=kg["launches"], hard_launches=kh["launches"],
               position_grad_max=float(kg["grads"].position.abs().max()),
               finite=all(bool(torch.isfinite(v).all())
                          for x in (kg, kh) for _, v in x["grads"].items()))
    say(phase="grad_generic_soft", **res)
    require(res["finite"] and set(kg["launches"]) == {"sweep2g_edge"}
            and set(kh["launches"]) == {"sweep2g"} and res["position_grad_max"] > 0.0,
            f"grad_generic_soft: {res}")
    paths["grad_generic_soft"] = kg["launches"]
    paths["grad_generic"] = kh["launches"]
    edge_frames["sweep2g_edge"] = gg
    at_hard_step = dict(launches=len(ev_hard), device_ms=hard_ms, bound_ms=k3_hard["bound_ms_sum"],
                        ms_above_bound=hard_ms - k3_hard["bound_ms_sum"],
                        coop_min_sweep=k3_hard, at_soft_step_edge=k3_soft)

    # grad_motion_soft: the moving scenes' silhouette instantiations
    for name, scene_cam in (("sweep2_m_edge", examples.motion_blur_scene()),
                            ("sweep2g_m_edge", moving_groups_scene())):
        gm = grad_inputs(dev, scene_cam, jitter, soft=SOFT)
        module, wrapper, _, _ = EDGE_KERNELS[name]
        with launch_events(module, wrapper) as ev:
            km = grad_step(gm)
        res = dict(kernel=name, size=size_of(GRAD), band_pops=gm["pops"],
                   seconds_per_step=km["ms"] / 1e3, loss=float(km["loss"]),
                   launches=km["launches"], edge_device_ms=events_ms(ev),
                   edge_launches=len(ev),
                   finite=all(bool(torch.isfinite(v).all()) for _, v in km["grads"].items()))
        say(phase="grad_motion_soft", **res)
        require(res["finite"] and set(km["launches"]) == {name}, f"grad_motion_soft: {res}")
        paths[f"grad_motion_soft_{name}"] = km["launches"]
        edge_frames[name] = gm

    # sweep_modes, K3's part: its schedules bit for bit on the canary's lanes
    # and on the first two pops of each generic frame's middle band (the
    # moving frame's also through the nearest-hit MOTION instantiation)
    k3_in = {"canary lanes": ("sweep2g", *k3_canary)}
    for label, name, ge in (("hard step", "sweep2g", hard), ("soft step", "sweep2g_edge", gg),
                            ("moving groups", "sweep2g_m_edge", edge_frames["sweep2g_m_edge"])):
        for k, (accel, rays) in enumerate(first_two_pops(ge, name, ge["bands"] // 2)):
            k3_in[f"{label} pop {k + 1}"] = (name, accel, rays)
            if name == "sweep2g_m_edge":
                k3_in[f"{label} pop {k + 1}, nearest"] = ("sweep2g", accel, rays)
    k3_sweep_modes(k3_in)
    del k3_in

    # edge_vs_plain: each silhouette instantiation on its frame's first two
    # pops (a band through the middle of the frame)
    entries, failed = [], []
    for name, ge in edge_frames.items():
        try:  # every instantiation is measured and printed before any failure is raised
            e = edge_vs_plain(name, ge, ge["bands"] // 2)
        except AssertionError as err:
            failed.append(str(err))
            continue
        e["launches"] = max(got.get(name, 0) for got in paths.values())
        e["launches_by_path"] = {p: got.get(name, 0) for p, got in paths.items() if got.get(name)}
        entries.append(e)
    require(not failed, f"edge_vs_plain: {failed}")

    # train_steps: three Adam steps of grad_config lower the loss; a
    # checkpoint round trip on the card
    import tempfile

    from raytracing_tests_tpu_torch.app import checkpoint

    opt = diff.adam(2e-2)
    _build.reset_launches()
    step = diff.make_train_step(g["pert"], g["cam"], g["cfg"], opt, grad_bands=g["bands"],
                                auto_pops=True, trainable=diff.params_mask(g["pert"], "color"))
    st = diff.TrainState.create(g["pert"], opt)
    losses, times = [], []
    for _ in range(3):
        ms, (st, loss) = timed_ms(lambda: step(st, g["target"]))
        losses.append(float(loss))
        times.append(ms / 1e3)
    launches_train = dict(_build.LAUNCHES)
    with tempfile.TemporaryDirectory() as tmp:
        checkpoint.save_train_state(tmp, st, st.step)
        back, at = checkpoint.restore_train_state(tmp, diff.TrainState.create(g["pert"], opt))
    same = all(torch.equal(a, b) for (_, a), (_, b) in zip(st.params.items(), back.params.items()))
    same_adam = all(torch.equal(st.opt_state[n][key].cpu(), back.opt_state[n][key].cpu())
                    for n in st.opt_state for key in ("step", "exp_avg", "exp_avg_sq"))
    _, l_on = step(st, g["target"])
    _, l_back = step(back, g["target"])
    res = dict(size=size_of(GRAD), losses=losses, seconds_per_step=times,
               band_pops=step.pops_state["band_pops"], launches=launches_train,
               checkpoint_step=at, restored_params_equal=same, restored_adam_equal=same_adam,
               next_loss=float(l_on), next_loss_from_restored=float(l_back))
    say(phase="train_steps", **res)
    require(losses[2] < losses[0] and losses[1] < losses[0], f"train_steps: {res}")
    require(at == 3 and same and same_adam and float(l_on) == float(l_back),
            f"train_steps: the checkpoint did not resume identically: {res}")
    paths["train_steps"] = launches_train
    return entries, paths, at_hard_step


# ---------------------------------------------------------------------------
# The thirteenth slice: the row-sharded mesh (parallel/), the sharded gradient
# step, a process group of one through NCCL, and the port's dry run.  A mesh
# here repeats the one card (make_mesh(devices=[dev] * n)): n virtual shards,
# each its own launches with its own row map, which must reassemble the
# single-device frame.
# ---------------------------------------------------------------------------

SHARDS = (3, 4)  # 150 rows each; 113 rows each, two of them off the frame
IMBALANCE_SHARDS = (1, 2, 4, 8)
TRAIN_SPP = 2  # grad_config's 16 spp cut: a mesh takes no bands (JAX diff/train.py:312)
TRAIN_PEAK_LIMIT = 60e9  # above it the sharded step drops to 1 spp
# The sharded gradient against the unsharded one: the -fmad=false build
# gives every lane the same bits, and only the order of the sums differs:
# each field's gradient gathers its objects' terms from every lane by atomic
# adds (the backward of the winner gathers), in the order the lanes happen to
# run, and the lanes lie in another order on a mesh.  A colour's gradient sums
# terms of both signs from some 10^5 lanes, so a different order moves it by
# some 1e-5 of the field's largest entry (found 2.2e-5 on the colours, under
# 1e-6 on the geometry; the same unsharded step twice: printed as
# ``repeat_precise``).  The loss is a mean over the same image: equal.
GRAD_SHARDED_PRECISE = dict(loss_rtol=1e-6, field_of_max=1e-4)


def same_frame(a, b):
    """Two finished frames bit for bit: image, depth and rays."""
    return dict(image=bool(torch.equal(a["image"], b["image"])),
                depth=bool(torch.equal(a["depth"], b["depth"])),
                rays=int(a["rays"]) == int(b["rays"]))


def identical_pixels(a, b):
    return frac((a["image"] == b["image"]).all(dim=-1))


def sharded_headline(dev, headline, single_frame):
    """Phase sharded_headline: the headline frame through render_uber_sharded
    on SHARDS virtual shards -> {path: launches}."""
    from raytracing_tests_tpu_torch.parallel import make_mesh, render_uber_sharded

    scene, camera = (x.to(dev) for x in examples.iow_final_scene())
    cfg = RenderConfig(intersector="pallas", **HEADLINE).for_scene(scene)
    with _build.precise():
        single_p = uber.render_uber(scene, camera, cfg, gr=GR)
    # the single frame again, beside the sharded ones (the host's accel build
    # drifts over a run), and K1 alone on the same tables, by CUDA events
    _, single_times, _ = timed_frames(lambda: uber.render_uber(scene, camera, cfg, gr=GR))
    accel, cam1 = uber._scene_accel(scene, camera, cfg, GR)
    st = uber.UberStatics.from_cfg(cfg, 0, camera)
    one = lambda: uber.uber_render(accel, cam1, st)  # noqa: E731
    paths = {}
    for n in SHARDS:
        mesh = make_mesh(devices=[dev] * n)
        render = lambda: render_uber_sharded(scene, camera, cfg, mesh, gr=GR)  # noqa: E731
        out, times, launches = timed_frames(render)
        with _build.precise():
            out_p = render()
        exact = same_frame(out_p, single_p)
        c = parity(out, headline)
        st_n = dataclasses.replace(st, rows=-(-cfg.height // n))
        cams = [uber.pack_camera(camera, row_stride=float(n), row0=float(d)) for d in range(n)]
        shards = lambda: [uber.uber_render(accel, cv, st_n) for cv in cams]  # noqa: E731
        k1_single, k1_sharded = [cuda_ms(one, 3)], [cuda_ms(shards, 3), cuda_ms(shards, 3)]
        k1_single.append(cuda_ms(one, 3))  # in turns: single, sharded, sharded, single
        res = dict(shards=n, rows_per_shard=-(-cfg.height // n), size=size_of(HEADLINE),
                   seconds_per_frame_min=min(times),
                   seconds_per_frame_mean=sum(times) / len(times),
                   single_seconds_per_frame_min=min(single_times),
                   single_seconds_per_frame_mean=sum(single_times) / len(single_times),
                   headline_phase_seconds_per_frame_min=single_frame["seconds_per_frame_min"],
                   k1_ms_single=k1_single, k1_ms_all_shards=k1_sharded,
                   rays=int(out["rays"]), single_rays=int(headline["rays"]),
                   rays_dropped=int(out["rays_dropped"]), launches_per_frame=launches,
                   precise_build_equal_to_single=exact,
                   precise_rays=int(out_p["rays"]), single_precise_rays=int(single_p["rays"]),
                   default_build_identical_pixels=identical_pixels(out, headline),
                   parity_vs_single=c)
        say(phase="sharded_headline", **res)
        for got in launches:
            require(got == {"uber": n}, f"a frame on {n} shards is {n} launches: {launches}")
        require(exact["image"] and exact["depth"] and (exact["rays"] or n != 3),
                f"sharded headline, -fmad=false build, not the single frame: {res}")
        require(n == 3 or int(out_p["rays"]) > int(single_p["rays"]),
                f"the off-frame rows of {n} shards count no rays: {res}")
        check_parity(f"sharded headline on {n} shards", c)
        paths[f"sharded_headline_{n}"] = launches[-1]
    return paths


def load_imbalance(dev, single_rays):
    """Phase load_imbalance: the headline's per-shard rays at IMBALANCE_SHARDS;
    ``single_rays``: the headline frame's rays in this run."""
    from raytracing_tests_tpu_torch.parallel import multihost

    scene, camera = (x.to(dev) for x in examples.iow_final_scene())
    cfg = RenderConfig(intersector="pallas", **HEADLINE).for_scene(scene)
    _build.reset_launches()
    ms, report = timed_ms(lambda: multihost.load_imbalance_report(
        scene, camera, cfg, IMBALANCE_SHARDS, gr=GR))
    launches = dict(_build.LAUNCHES)
    say(phase="load_imbalance", size=size_of(HEADLINE), seconds=ms / 1e3, report=report,
        launches=launches)
    require(launches == {"uber": sum(IMBALANCE_SHARDS)},
            f"load_imbalance: one launch a shard: {launches}")
    require(all(0.0 < r["efficiency_bound"] <= 1.0 for r in report)
            and abs(report[0]["rays"][0] - single_rays) < 5e-3 * single_rays,
            f"load_imbalance: {report} (the headline's rays: {single_rays})")
    return {"load_imbalance": launches}


def sharded_bvh_queue(dev):
    """Phase sharded_bvh_queue: the bvh workload's path on 3 virtual shards."""
    from raytracing_tests_tpu_torch.parallel import make_mesh, render_sharded

    scene, camera = (x.to(dev) for x in examples.bvh_grid_scene(side=32))
    cfg = RenderConfig(intersector="pallas", **BVH1K).for_scene(scene)
    mesh = make_mesh(devices=[dev] * 3)
    render = lambda: render_sharded(scene, camera, cfg, mesh)  # noqa: E731
    single, single_times, _ = timed_frames(lambda: render_stats(scene, camera, cfg))
    out, times, launches = timed_frames(render)
    with _build.precise():
        exact = same_frame(render(), render_stats(scene, camera, cfg))
    c = parity(out, single)
    res = dict(scene="bvh_grid_scene(side=32)", size=size_of(BVH1K), shards=3,
               seconds_per_frame_min=min(times), seconds_per_frame_mean=sum(times) / len(times),
               single_seconds_per_frame_min=min(single_times),
               single_seconds_per_frame_mean=sum(single_times) / len(single_times),
               rays=int(out["rays"]),
               single_rays=int(single["rays"]), rays_dropped=int(out["rays_dropped"]),
               launches_per_frame=launches, precise_build_equal_to_single=exact,
               default_build_identical_pixels=identical_pixels(out, single),
               parity_vs_single=c)
    say(phase="sharded_bvh_queue", **res)
    require(all(set(got) == {"sweep_grouped"} and got["sweep_grouped"] > 0 for got in launches),
            f"a sharded bvh queue frame launches K5 and nothing else: {launches}")
    require(all(exact.values()), f"sharded bvh queue, -fmad=false build: {res}")
    check_parity("sharded bvh queue frame", c)
    return {"sharded_bvh_queue": launches[-1]}


def train_inputs(dev, spp):
    scene, cam = (x.to(dev) for x in examples.iow_final_scene())
    cfg = RenderConfig(intersector="pallas", **dict(GRAD, spp=spp)).for_scene(scene)
    pert = scene.replace(color=scene.color * 0.8 + 0.1)  # grad_config's perturbation
    return dict(cfg=cfg, cam=cam, pert=pert, p=diff.extract_params(pert),
                target=render_stats(scene, cam, cfg)["image"])


def sharded_vg(t, mesh):
    """One value_and_grad_loss of ``t`` on ``mesh`` (None: one device)."""
    _build.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    ms, (loss, grads) = timed_ms(lambda: diff.value_and_grad_loss(
        t["p"], t["pert"], t["cam"], t["cfg"], t["target"], mesh=mesh))
    return dict(ms=ms, loss=loss, grads=grads, launches=dict(_build.LAUNCHES),
                peak_memory_bytes=torch.cuda.max_memory_allocated())


def sharded_train_step(dev):
    """Phase sharded_train_step: grad_config's scene and target at TRAIN_SPP,
    unbanded, through the sharded gradient step on 3 virtual shards."""
    from raytracing_tests_tpu_torch.parallel import make_mesh

    mesh = make_mesh(devices=[dev] * 3)
    spp = TRAIN_SPP
    t = train_inputs(dev, spp)
    one = sharded_vg(t, None)
    if one["peak_memory_bytes"] > TRAIN_PEAK_LIMIT:
        spp = 1
        t = train_inputs(dev, spp)
        one = sharded_vg(t, None)
    sh = sharded_vg(t, mesh)
    with _build.precise():
        one_p, sh_p, one_p2 = sharded_vg(t, None), sharded_vg(t, mesh), sharded_vg(t, None)
    default, precise = compare_grads(sh, one), compare_grads(sh_p, one_p)
    repeat = compare_grads(one_p2, one_p)
    opt = diff.adam(2e-2)
    step = diff.make_train_step(t["pert"], t["cam"], t["cfg"], opt, mesh=mesh,
                                trainable=diff.params_mask(t["pert"], "color"))
    st = diff.TrainState.create(t["pert"], opt)
    losses, times = [], []
    for _ in range(3):
        ms, (st, loss) = timed_ms(lambda: step(st, t["target"]))
        losses.append(float(loss))
        times.append(ms / 1e3)
    res = dict(size=size_of(dict(GRAD, spp=spp)), spp=spp, spp_cut_from=GRAD["spp"],
               shards=3, seconds_per_step=sh["ms"] / 1e3, single_seconds_per_step=one["ms"] / 1e3,
               peak_memory_bytes=sh["peak_memory_bytes"],
               single_peak_memory_bytes=one["peak_memory_bytes"], launches=sh["launches"],
               single_launches=one["launches"], precise_build=precise, default_build=default,
               repeat_precise=dict(loss_rel_err=repeat["loss_rel_err"],
                                   worst_field_err_of_max=repeat["worst_field_err_of_max"]),
               train_losses=losses, train_seconds_per_step=times)
    say(phase="sharded_train_step", **res)
    check_grads("sharded_train_step, -fmad=false build", precise, GRAD_SHARDED_PRECISE)
    check_grads("sharded_train_step, default build", default, GRAD_DEFAULT)
    require(set(sh["launches"]) == {"sweep2"} and sh["launches"]["sweep2"] > 0,
            f"sharded_train_step: the step runs K2 and nothing else: {sh['launches']}")
    require(losses[1] < losses[0] and losses[2] < losses[0],
            f"sharded_train_step: two more Adam steps did not lower the loss: {losses}")
    return {"sharded_train_step": sh["launches"]}


def dryrun_phase(dev):
    """Phase dryrun: the port's dry run on 4 virtual shards, -fmad=false."""
    from raytracing_tests_tpu_torch.dryrun import dryrun_multichip

    _build.reset_launches()
    with _build.precise():
        ms, found = timed_ms(lambda: dryrun_multichip(4, devices=[dev] * 4))
    launches = dict(_build.LAUNCHES)
    say(phase="dryrun", shards=4, seconds=ms / 1e3, found=found, launches=launches)
    require(len(launches) == 3 and set(launches.values()) == {5},
            f"dryrun: three cases of K1, each one single and four shard launches: {launches}")
    return {"dryrun": launches}


def world_one(dev):
    """Phase world_one: a process group of one through NCCL (a FileStore in a
    temporary directory): the group's mesh against one device."""
    import tempfile

    import torch.distributed as dist

    from raytracing_tests_tpu_torch.parallel import make_mesh, render_uber_sharded
    from raytracing_tests_tpu_torch.parallel.multihost import initialize_multihost

    scene, camera = (x.to(dev) for x in examples.iow_final_scene())
    cfg_s = RenderConfig(intersector="pallas", **SMALL).for_scene(scene)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        rank = initialize_multihost("file://" + tmp + "/store", 1, 0)
        try:
            init_s = time.perf_counter() - t0
            mesh = make_mesh()
            backend = dist.get_backend()
            single = uber.render_uber(scene, camera, cfg_s, gr=GR)
            _build.reset_launches()
            out = render_uber_sharded(scene, camera, cfg_s, mesh, gr=GR)
            launches = dict(_build.LAUNCHES)
            target = render_stats(scene, camera, cfg_s)["image"]
            pert = scene.replace(color=scene.color * 0.8 + 0.1)
            args = (diff.extract_params(pert), pert, camera, cfg_s, target)
            one = dict(zip(("loss", "grads"), diff.value_and_grad_loss(*args)))
            _build.reset_launches()
            grp = dict(zip(("loss", "grads"), diff.value_and_grad_loss(*args, mesh=mesh)))
            launches_vg = dict(_build.LAUNCHES)
            grads = compare_grads(grp, one)
            res = dict(backend=backend, rank=rank, world_size=dist.get_world_size(),
                       init_seconds=init_s, mesh=str(mesh.shape), distributed=mesh.distributed,
                       size=size_of(SMALL), frame_equal_to_single=same_frame(out, single),
                       launches=launches, value_and_grad=grads, launches_value_and_grad=launches_vg)
            say(phase="world_one", **res)
            require(backend == "nccl" and mesh.distributed and mesh.shape == {"rows": 1},
                    f"world_one: not a process group of one through NCCL: {res}")
            require(all(res["frame_equal_to_single"].values()) and launches == {"uber": 1},
                    f"world_one: the group's frame is not the single launch's: {res}")
            check_grads("world_one value_and_grad_loss", grads, GRAD_SHARDED_PRECISE)
        finally:
            dist.destroy_process_group()
    return {"world_one": {k: launches.get(k, 0) + launches_vg.get(k, 0)
                          for k in set(launches) | set(launches_vg)}}


def parallel_phases(dev, headline, single_frame):
    """The thirteenth slice's phases, each path's launches counted from 0 ->
    {path: launches}.  ``headline``: the render_uber headline frame of this
    run; ``single_frame``: its numbers (phase headline)."""
    paths = sharded_headline(dev, headline, single_frame)
    paths.update(load_imbalance(dev, int(headline["rays"])))
    paths.update(sharded_bvh_queue(dev))
    paths.update(sharded_train_step(dev))
    paths.update(dryrun_phase(dev))
    paths.update(world_one(dev))
    return paths



# ---------------------------------------------------------------------------
# The fourteenth slice: the numpy oracle on the card, the normals view,
# progressive tiles, and the LBVH with its native host build
# ---------------------------------------------------------------------------

# tests/test_render_parity.py's cases at its own sizes: (scene, config)
ORACLE_CASES = {
    "sphere_normals": (examples.sphere_scene, dict(width=24, height=16, spp=1,
                                                   show_normals=True)),
    "sphere": (examples.sphere_scene, dict(width=24, height=16, spp=2, max_bounces=3)),
    "groups": (examples.groups_scene, dict(width=20, height=14, spp=2, max_bounces=4)),
    "materials": (examples.materials_scene, dict(width=20, height=14, spp=3, max_bounces=4)),
    "materials_shading": (examples.materials_scene, dict(width=24, height=16, spp=4,
                                                         max_bounces=5, shading="materials")),
    "motion_blur": (examples.motion_blur_scene, dict(width=20, height=14, spp=4,
                                                     max_bounces=3)),
    "texturing": (lambda: examples.texturing_scene(tex_size=16),
                  dict(width=20, height=14, spp=2, max_bounces=3)),
    "lights": (examples.lights_scene, dict(width=16, height=12, spp=2, max_bounces=3)),
}
ORACLE_ATOL = dict(lights=5e-4)  # that file's own; 2e-4 elsewhere
ORACLE_FRAC = 0.995  # share of pixels within atol and rtol 1e-3
K2_K5 = ("sweep2", "sweep2_m", "sweep_grouped")
# The normals view at full width: (scene, size, its one kernel launch)
NORMALS_FRAMES = dict(
    iow_final=(examples.iow_final_scene, HEADLINE, "sweep2"),
    bvh1k=(lambda: examples.bvh_grid_scene(side=32), BVH1K, "sweep_grouped"),
)
PROGRESSIVE_TILE, TILES_PER_STEP = (64, 64), 4  # the CLI's progressive defaults
# bvh1k through the LBVH walk: the headline's width and height at depth 8 with
# spp cut from 16 to 1, since the walk is the JAX package's lockstep oracle,
# some forty elementwise launches a step over every lane
LBVH_FRAME = dict(BVH1K, spp=1)


def oracle_parity(dev):
    """Phase oracle_parity: the port's render on the card (intersector
    "pallas": K2 in sphere mode, K5 in generic mode) against the port's numpy
    oracle ``render_cpu`` on the same scene, both builds -> {path: launches}."""
    from raytracing_tests_tpu_torch.ops.render import extract_lights, render
    from raytracing_tests_tpu_torch.reference import render_cpu

    t0 = time.perf_counter()
    paths = {}
    for name, (scene_fn, kw) in ORACLE_CASES.items():
        scene, camera = scene_fn()
        cfg = RenderConfig(intersector="pallas", **kw).for_scene(scene)
        want = render_cpu(scene, camera, cfg)["image"]
        lights = extract_lights(scene) if cfg.enable_lights else None
        row = {}
        for build in ("default", "precise"):
            with _build.precise() if build == "precise" else contextlib.nullcontext():
                _build.reset_launches()
                got = render(scene, camera, cfg, lights, device=dev)["image"]
                launched = dict(_build.LAUNCHES)
            got = got.double().cpu().numpy()
            close = np.isclose(got, want, atol=ORACLE_ATOL.get(name, 2e-4), rtol=1e-3)
            row[build] = dict(frac_within=float(close.mean()),
                              max_abs_err=float(np.abs(got - want).max()), launches=launched)
        paths[f"oracle_{name}"] = row["default"]["launches"]
        say(phase="oracle_parity", case=name, config=kw, mode=cfg.pallas_mode,
            atol=ORACLE_ATOL.get(name, 2e-4), **row)
        for build, r in row.items():
            require(r["frac_within"] >= ORACLE_FRAC,
                    f"oracle_parity {name}, {build} build: {r}")
            require(any(r["launches"].get(k) for k in K2_K5),
                    f"oracle_parity {name}: neither K2 nor K5 launched: {r['launches']}")
    say(phase="oracle_parity", cases=len(ORACLE_CASES), seconds=time.perf_counter() - t0)
    return paths


@contextlib.contextmanager
def plain_grouped():
    """Inside: K5's wrapper runs its plain version on the card."""
    with patched(sweep, "_sweep_grouped",
                 lambda table, gaabb, rays, group, with_ri, mode, stats=None:
                 sweep.sweep_grouped_plain(table, gaabb, rays, group, with_ri, mode)):
        yield


def normals_frame(dev):
    """Phase normals_frame: the normals view at full width through the queue
    renderer: one nearest-hit launch a frame (K2 on the headline scene, K5 on
    bvh1k), against the same frame with the sweeps routed to their plain
    versions -> {path: launches}."""
    paths = {}
    for name, (scene_fn, size, kernel) in NORMALS_FRAMES.items():
        scene, camera = (x.to(dev) for x in scene_fn())
        cfg = RenderConfig(intersector="pallas", show_normals=True, **size).for_scene(scene)
        frame = lambda: render_stats(scene, camera, cfg)  # noqa: E731
        out, times, launches = timed_frames(frame)
        with plain_sweeps(), plain_grouped():
            plain = frame()
        with _build.precise():
            exact = same_frame(frame(), plain)
        c = parity(out, plain)
        res = dict(scene=name, size=size_of(size), seconds_per_frame_min=min(times),
                   seconds_per_frame_mean=sum(times) / len(times), lanes=int(out["rays"]),
                   launches_per_frame=launches[-1], precise_build_equal_to_plain=exact,
                   default_build_vs_plain=c,
                   frac_pixels_bit_identical=frac((out["image"] == plain["image"]).all(-1)))
        say(phase="normals_frame", **res)
        require(all(exact.values()), f"normals frame {name}, -fmad=false build: {res}")
        check_parity(f"normals frame {name} against the plain sweeps", c)
        require(all(got == {kernel: 1} for got in launches),
                f"normals frame {name}: one {kernel} launch a frame: {launches}")
        paths[f"normals_{name}"] = launches[-1]
    return paths


def progressive_frame(dev):
    """Phase progressive_frame: the bvh workload's path (intersector
    "pallas", K5) at bvh1k's size through ``render_progressive``, 104 tiles
    of 64x64 four a step, against ``render_stats``'s frame, both builds ->
    {path: launches}."""
    from raytracing_tests_tpu_torch.ops.tiles import render_progressive

    scene, camera = (x.to(dev) for x in examples.bvh_grid_scene(side=32))
    cfg = RenderConfig(intersector="pallas", **BVH1K).for_scene(scene)
    res = {}
    for build in ("default", "precise"):
        with _build.precise() if build == "precise" else contextlib.nullcontext():
            full, times, _ = timed_frames(lambda: render_stats(scene, camera, cfg))
            _build.reset_launches()
            ms, steps = timed_ms(lambda: [
                (step["done_fraction"], step["image"]) for step in render_progressive(
                    scene, camera, cfg, tile=PROGRESSIVE_TILE, tiles_per_step=TILES_PER_STEP,
                    device=dev)])
            launched = dict(_build.LAUNCHES)
        fractions, image = [f for f, _ in steps], steps[-1][1]
        diff_px = (image - full["image"]).abs().amax(dim=-1)
        res[build] = dict(seconds=ms / 1e3, full_frame_seconds_min=min(times), yields=len(fractions),
                          done_fractions_rise=fractions == sorted(fractions),
                          last_done_fraction=fractions[-1], launches=launched,
                          max_abs_diff=float(diff_px.max()),
                          frac_pixels_bit_identical=frac(diff_px == 0),
                          frac_pixels_within_1e5=frac(diff_px <= 1e-5))
    tw, th = PROGRESSIVE_TILE
    n_tiles = -(-BVH1K["width"] // tw) * -(-BVH1K["height"] // th)
    say(phase="progressive_frame", scene="bvh_grid_scene(side=32)", size=size_of(BVH1K),
        tile=PROGRESSIVE_TILE, tiles_per_step=TILES_PER_STEP, tiles=n_tiles, **res)
    for build, r in res.items():
        require(r["done_fractions_rise"] and r["last_done_fraction"] == 1.0
                and r["yields"] == -(-n_tiles // TILES_PER_STEP),
                f"progressive_frame, {build} build: the spiral did not fill the frame: {r}")
        require(r["max_abs_diff"] <= 1e-5, f"progressive_frame, {build} build: {r}")
        require(set(r["launches"]) == {"sweep_grouped"},
                f"progressive_frame: the tiles launch K5 and nothing else: {r['launches']}")
    return {"progressive_bvh1k": res["default"]["launches"]}


@contextlib.contextmanager
def walk_log():
    """Inside: every LBVH walk's steps and cap are recorded -> [(steps, cap,
    kind)], kind "nearest" or "ri"."""
    from raytracing_tests_tpu_torch.bvh import traverse

    log, kind = [], ["nearest"]
    real_walk, real_ri = traverse._walk, traverse.traverse_point_ri

    def walk(bvh, step, carry):
        out, steps = real_walk(bvh, step, carry)
        log.append((steps, 3 * bvh.left.shape[0] + 2, kind[0]))
        return out, steps

    def point_ri(*args):
        kind[0] = "ri"
        try:
            return real_ri(*args)
        finally:
            kind[0] = "nearest"

    with patched(traverse, "_walk", walk), patched(traverse, "traverse_point_ri", point_ri):
        yield log


def walk_summary(log):
    by = {}
    for steps, cap, kind in log:
        by.setdefault(kind, []).append(steps)
    return dict(cap=log[0][1] if log else None, **{
        kind: dict(walks=len(v), steps_max=max(v), steps_mean=sum(v) / len(v),
                   steps_per_walk=v) for kind, v in by.items()})


def host_ms(fn, reps=3):
    """Mean milliseconds of ``fn()`` by the host clock, the card synchronised."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def compare_frames(got, want, atol=2e-4):
    a, b = got["image"], want["image"]
    d = (a - b).abs()
    close = d <= atol + 1e-3 * b.abs()
    return dict(frac_within=frac(close), frac_within_1e5=frac(d <= 1e-5),
                max_abs_err=float(d.max()))


def ri_walk_points(scene, n=1 << 17):
    """``traverse_point_ri`` against the dense containment sum at ``n``
    points in and around the scene's glass (seeded) -> shares."""
    from raytracing_tests_tpu_torch.bvh import build_lbvh
    from raytracing_tests_tpu_torch.bvh.traverse import traverse_point_ri
    from raytracing_tests_tpu_torch.ops.intersect import surrounding_refractive_index

    glass = torch.nonzero(scene.valid & (scene.refractivity > 0.002))[:, 0]
    rng = np.random.default_rng(SEED)
    pick = glass[torch.from_numpy(rng.integers(0, glass.numel(), n)).to(scene.device)]
    off = torch.from_numpy(rng.uniform(-1.3, 1.3, (n, 3)).astype(np.float32)).to(scene.device)
    pts = scene.position[pick] + off * scene.scale[pick]
    tr = torch.zeros(n, device=scene.device)
    got = traverse_point_ri(build_lbvh(scene), scene, pts, tr)
    want = torch.cat([surrounding_refractive_index(scene, pts[k:k + 8192], tr[k:k + 8192])
                      for k in range(0, n, 8192)])
    return dict(points=n, frac_equal=frac(got == want), frac_not_air=frac(want != 1.0),
                max_abs_diff=float((got - want).abs().max()))


def lbvh_phase(dev):
    """Phase lbvh: (a) the LBVH built on the card against the native host
    build; (b) lbvh_frame, bvh1k through the LBVH walk; (c) the RI walk on
    the headline scene at the canary's size; (d) the native noise ->
    {path: launches}."""
    import dataclasses as dc

    from raytracing_tests_tpu_torch import native
    from raytracing_tests_tpu_torch.bvh import build_lbvh
    from raytracing_tests_tpu_torch.bvh.host_build import build_lbvh_native

    require(native.available(), "the native library did not build: g++ is needed")
    paths = {}
    # (a) the build
    for name, scene_fn in (("bvh1k", lambda: examples.bvh_grid_scene(side=32)),
                           ("iow_final", examples.iow_final_scene)):
        scene = scene_fn()[0].to(dev)
        on_card, on_host = build_lbvh(scene), build_lbvh_native(scene)
        equal = {f: bool(torch.equal(getattr(on_card, f), getattr(on_host, f)))
                 for f in ("left", "right", "parent", "obj_id")}
        box = max(float((getattr(on_card, f) - getattr(on_host, f)).abs().max())
                  for f in ("bb_min", "bb_max"))
        res = dict(scene=name, objects=scene.capacity, nodes=int(on_card.left.shape[0]),
                   arrays_equal=equal, boxes_max_abs_diff=box,
                   build_ms_card=host_ms(lambda: build_lbvh(scene)),
                   build_ms_host=host_ms(lambda: build_lbvh_native(scene)))
        say(phase="lbvh_build", **res)
        require(all(equal.values()) and box <= 1e-5, f"lbvh_build {name}: {res}")

    # (b) lbvh_frame: the walk against the grouped sweep, which the exact
    # build runs as its plain version does
    scene, camera = (x.to(dev) for x in examples.bvh_grid_scene(side=32))
    cfg_p = RenderConfig(intersector="pallas", **LBVH_FRAME).for_scene(scene)
    cfg_b = dc.replace(cfg_p, intersector="bvh")
    with walk_log() as log:
        _build.reset_launches()
        ms, ob = timed_ms(lambda: render_stats(scene, camera, cfg_b))
        launched = dict(_build.LAUNCHES)
    op = render_stats(scene, camera, cfg_p)
    with _build.precise():
        op_exact = render_stats(scene, camera, cfg_p)
    vs_exact, vs_default = compare_frames(ob, op_exact), compare_frames(ob, op)
    c = parity(ob, op)
    res = dict(scene="bvh_grid_scene(side=32)", size=size_of(LBVH_FRAME),
               spp_cut_from=BVH1K["spp"], seconds=ms / 1e3, rays=int(ob["rays"]),
               rays_pallas=int(op["rays"]), launches=launched,
               vs_pallas_precise_build=vs_exact, vs_pallas_default_build=vs_default,
               envelope_vs_default_build=c, walks=walk_summary(log))
    say(phase="lbvh_frame", **res)
    require(not launched, f"lbvh_frame: the bvh path launched a kernel: {launched}")
    require(log and all(s <= cap for s, cap, _ in log), f"lbvh_frame: walks: {res['walks']}")
    require(vs_exact["frac_within"] >= ORACLE_FRAC, f"lbvh_frame: {res}")
    check_parity("lbvh_frame against the default build's grouped sweep", c)
    paths["lbvh_frame"] = launched

    # (c) the RI walk: the headline scene's glass at the canary's size,
    # against the first-generation sweeps over its generic table (K5 and K4's
    # sweep_ri), whose exact build rounds as the walk does
    scene, camera = (x.to(dev) for x in examples.iow_final_scene())
    cfg_p = RenderConfig(intersector="pallas", **SMALL).for_scene(scene)
    cfg_g = dc.replace(cfg_p, pallas_mode="generic")
    with walk_log() as log:
        _build.reset_launches()
        ms, ob = timed_ms(lambda: render_stats(scene, camera, dc.replace(cfg_p, intersector="bvh")))
        launched = dict(_build.LAUNCHES)
    with _build.precise():
        _build.reset_launches()
        og_exact = render_stats(scene, camera, cfg_g)
        launched_g = dict(_build.LAUNCHES)
    op = render_stats(scene, camera, cfg_p)
    ri = ri_walk_points(scene)
    c = parity(ob, op)
    res = dict(scene="iow_final_scene()", size=size_of(SMALL), seconds=ms / 1e3,
               rays=int(ob["rays"]), launches=launched,
               vs_generic_sweeps_precise_build=compare_frames(ob, og_exact),
               rays_generic_sweeps=int(og_exact["rays"]), generic_sweeps_launches=launched_g,
               envelope_vs_sphere_sweep=c, ri_walk_vs_dense_sum=ri, walks=walk_summary(log))
    say(phase="lbvh_ri_canary", **res)
    require(not launched, f"lbvh_ri_canary: the bvh path launched a kernel: {launched}")
    require("ri" in res["walks"], f"lbvh_ri_canary: no RI walk ran: {res['walks']}")
    require(res["vs_generic_sweeps_precise_build"]["frac_within"] >= ORACLE_FRAC,
            f"lbvh_ri_canary against the generic sweeps: {res}")
    require(ri["frac_equal"] >= 0.999, f"lbvh_ri_canary, the RI walk: {ri}")
    # The envelope against the sphere sweep (K2) is printed, not required: the
    # sphere and the generic arithmetic round the 1000-radius ground sphere
    # apart, and their plain versions differ by as much on the CPU (7.6 % of
    # pixels beyond 0.05 at this size).
    paths["lbvh_ri_canary_generic_sweeps"] = launched_g

    # (d) the native noise
    t0 = time.perf_counter()
    tex = {k: native.noise_texture_host(256, 256, kind=k) for k in native.NOISE_KINDS}
    ms = (time.perf_counter() - t0) / len(tex) * 1e3
    kinds_differ = all(not np.allclose(tex[a], tex[b]) for a in tex for b in tex if a < b)
    res = dict(size=[256, 256], ms_per_texture=ms, kinds_differ=kinds_differ,
               ranges={k: [float(v.min()), float(v.max())] for k, v in tex.items()},
               stds={k: float(v.std()) for k, v in tex.items()})
    say(phase="native_noise", **res)
    require(kinds_differ and all(0.0 <= v.min() and v.max() <= 1.0 and v.std() > 0.05
                                 for v in tex.values()), f"native_noise: {res}")
    return paths


def fourteenth_phases(dev):
    """The fourteenth slice's phases, each path's launches counted from 0 ->
    {path: launches}."""
    paths = oracle_parity(dev)
    paths.update(normals_frame(dev))
    paths.update(progressive_frame(dev))
    paths.update(lbvh_phase(dev))
    return paths


def main():
    dev = torch.device("cuda", 0)

    # 1. the card -----------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    say(phase="card", card=card, torch=torch.__version__, cuda=torch.version.cuda)

    # 2. build ----------------------------------------------------------------
    info = _build.build(with_precise=True)
    ptxas = ptxas_by_kernel(info["log"])
    say(phase="build", seconds=info["seconds"], built=info["built"], ptxas=ptxas,
        static_instantiations_as_expected={
            k: ptxas.get(f"uber.so {k}") == v for k, v in PTXAS_STATIC.items()},
        untextured_instantiations_as_before={
            k: ptxas.get(f"uber.so {k}") == v for k, v in PTXAS_K1.items()},
        redesigned_as_recorded={k: ptxas.get(k) == v
                                for k, v in {**PTXAS_REDESIGNED, **PTXAS_K45}.items()},
        k4_dense={k: ptxas.get(k) for k in K4_DENSE_INSTANTIATIONS})
    if "sweep2g.so" in info["built"]:  # not when an earlier run left it built
        spilled = {k: ptxas.get(k) for k in K3_INSTANTIATIONS
                   if not ptxas.get(k) or ptxas[k]["spill_stores"] or ptxas[k]["spill_loads"]}
        require(not spilled, f"K3 instantiations that spill: {spilled}")
    if "sweep.so" in info["built"]:
        spilled = {k: ptxas.get(k) for k in K5_INSTANTIATIONS + K4_NRI_INSTANTIATIONS
                   + K4_DENSE_INSTANTIATIONS
                   if not ptxas.get(k) or ptxas[k]["spill_stores"] or ptxas[k]["spill_loads"]}
        require(not spilled, f"K4 / K5 instantiations that spill: {spilled}")

    # the sweep schedules of K1 bit for bit before anything else runs on them
    uber_modes_canaries(dev)

    scene, camera = examples.iow_final_scene()
    scene, camera = scene.to(dev), camera.to(dev)
    cfg_s = RenderConfig(intersector="pallas", **SMALL).for_scene(scene)
    cfg = RenderConfig(intersector="pallas", **HEADLINE).for_scene(scene)

    # 3. sweep kernel against its plain version -------------------------------
    accel, cam = uber._scene_accel(scene, camera, cfg_s, GR)
    rng = np.random.default_rng(SEED)
    B3 = 100_000
    o = rng.uniform(-12.0, 12.0, (B3, 3)).astype(np.float32)
    o[:, 1] = np.abs(o[:, 1]) * 0.3 + 0.05  # above the ground, among the spheres
    d = rng.normal(size=(B3, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d[:N_DEAD] = 0.0  # dead rays
    rays = sweep2.pack_rays(
        torch.from_numpy(o).to(dev), torch.from_numpy(d).to(dev),
        torch.zeros(B3, device=dev), torch.full((B3,), 32000.0, device=dev))
    # What the sweep is given on the main path: the queue renderer's own accel
    # (no camera sort, its own probe table) and the canary's lanes.
    accel_q = _build_accel(scene, cfg_s)
    lo, ld, ltr, _ = _lane_inputs(camera, cfg_s)
    lanes = sweep2.pack_rays(lo, ld, ltr, torch.full_like(ltr, cfg_s.t_max))
    lanes2 = second_generation(accel_q, lanes)
    k2 = {}
    for batch, (acc, rr) in dict(random=(accel, rays), canary_lanes=(accel_q, lanes),
                                 canary_second_pop=(accel_q, lanes2)).items():
        res = compare_sweep(acc, rr)
        with _build.precise():
            precise = compare_sweep(acc, rr)
        say(phase="sweep2_vs_plain", batch=batch, rays=rr.shape[1],
            default_build=res, precise_build=precise)
        check_sweep(batch, res, precise)
        k2[batch] = res["hit_block"]
    require(k2["random"]["dead_rays"] == N_DEAD and k2["canary_second_pop"]["dead_rays"] > 0,
            f"dead rays missing from the sweep batches: {k2}")
    plain_ms_k2 = cuda_ms(lambda: sweep2.sweep2_plain(accel_q, lanes, True, True), 2)

    # 4. persistent kernel against its plain version ----------------------------
    st_s = uber.UberStatics.from_cfg(cfg_s)
    out_p, stats_p = uber.uber_render_plain(accel, cam, st_s)
    k1_s, _ = compare_uber(accel, cam, st_s, out_p, stats_p)
    with _build.precise():
        k1_s_precise, _ = compare_uber(accel, cam, st_s, out_p, stats_p)
    say(phase="uber_vs_plain", size=size_of(SMALL), samples=st_s.B,
        rays_plain=int(stats_p[uber.ST_RAYS]),
        default_build=k1_s, precise_build=k1_s_precise)
    check_uber(size_of(SMALL), int(stats_p[uber.ST_DROPPED]), k1_s, k1_s_precise)

    # ... and on the headline frame itself: the same tables and statics the
    # main path hands the kernel, every primary of the frame.
    accel_h, cam_h = uber._scene_accel(scene, camera, cfg, GR)
    st_h = uber.UberStatics.from_cfg(cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out_p, stats_p = uber.uber_render_plain(accel_h, cam_h, st_h)
    torch.cuda.synchronize()
    plain_ms_k1 = (time.perf_counter() - t0) * 1e3
    k1, got = compare_uber(accel_h, cam_h, st_h, out_p, stats_p)
    img_k = uber._uber_post(*got, cfg)["image"]
    with _build.precise():
        k1_precise, got = compare_uber(accel_h, cam_h, st_h, out_p, stats_p)
    img_precise = uber._uber_post(*got, cfg)["image"]
    img_p = uber._uber_post(out_p, stats_p, cfg)["image"]
    px_plain = compare_pixels(img_k, img_p)
    px_precise = compare_pixels(img_k, img_precise)
    say(phase="uber_vs_plain", size=size_of(HEADLINE), samples=st_h.B,
        rays_plain=int(stats_p[uber.ST_RAYS]), plain_seconds=plain_ms_k1 / 1e3,
        default_build=k1, precise_build=k1_precise,
        pixels_default_vs_plain=px_plain, pixels_default_vs_precise=px_precise,
        pixel_atol=PIXEL_ATOL)
    check_uber(size_of(HEADLINE), int(stats_p[uber.ST_DROPPED]), k1, k1_precise)
    for px in (px_plain, px_precise):
        check_pixels("headline", px)
    del got, img_k, img_precise, img_p
    uber_modes_frame("headline", accel_h, cam_h, st_h, cfg, out_p, stats_p, generic=False)
    del out_p

    # 5. parity canary: persistent kernel vs queue renderer ---------------------
    _build.reset_launches()  # this path's own counts
    ou = uber.render_uber(scene, camera, cfg_s, gr=GR)
    oq = render_stats(scene, camera, cfg_s)
    launches_canary = dict(_build.LAUNCHES)
    iu, iq = ou["image"], oq["image"]
    ru, rq = int(ou["rays"]), int(oq["rays"])
    mean_diff = float((iu.mean(dim=(0, 1)) - iq.mean(dim=(0, 1))).abs().max())
    ddiff = (ou["depth"].clamp_max(100.0) - oq["depth"].clamp_max(100.0)).abs()
    canary = dict(mean_image_diff=mean_diff, ray_count_ratio=ru / max(rq, 1),
                  depth_disagree_frac=frac(ddiff > 1e-2),
                  rays_dropped=int(ou["rays_dropped"]),
                  queue_rays_dropped=int(oq["rays_dropped"]),
                  launches=launches_canary)
    say(phase="canary", **canary)
    require(mean_diff < 5e-3 and abs(canary["ray_count_ratio"] - 1.0) < 0.02
            and canary["depth_disagree_frac"] < 0.01 and canary["rays_dropped"] == 0,
            f"parity canary failed: {canary}")
    require(launches_canary.get("uber") == 1 and launches_canary.get("sweep2", 0) > 0,
            f"the canary did not go through both kernels: {launches_canary}")

    # 6. the headline frame -------------------------------------------------------
    torch.cuda.reset_peak_memory_stats()
    out, times, launches_frames = timed_frames(
        lambda: uber.render_uber(scene, camera, cfg, gr=GR))
    img = out["image"]
    rays, dropped = int(out["rays"]), int(out["rays_dropped"])
    frame = dict(size=size_of(HEADLINE),
                 seconds_per_frame_min=min(times),
                 seconds_per_frame_mean=sum(times) / len(times),
                 rays=rays, mrays_per_s=rays / min(times) / 1e6,
                 rays_dropped=dropped, image_mean=float(img.mean()),
                 launches_per_frame=launches_frames,
                 peak_memory_bytes=torch.cuda.max_memory_allocated())
    say(phase="headline", **frame)
    require(tuple(img.shape) == (cfg.height, cfg.width, 3), f"image shape {img.shape}")
    require(bool(torch.isfinite(img).all()) and bool(torch.isfinite(out["depth"]).all()),
            "headline frame is not finite")
    require(dropped == 0, f"headline frame dropped rays: {frame}")
    require(abs(rays - SCENE_RAYS) / SCENE_RAYS < 0.02, f"headline ray count: {frame}")
    require(abs(frame["image_mean"] - SCENE_MEAN) < 1e-2, f"headline image mean: {frame}")
    for got in launches_frames:
        require(got == {"uber": 1},
                f"a headline frame is one launch of the persistent kernel: {launches_frames}")

    # 7. the kernels at the main path's shapes -----------------------------------
    ms_k1 = cuda_ms(lambda: uber.uber_render(accel_h, cam_h, st_h), 3)
    with coop(1):  # the one-thread-per-tree schedule, in the same call
        ms_k1_lane = cuda_ms(lambda: uber.uber_render(accel_h, cam_h, st_h), 3)
    sweep_k1 = coop_sweep("headline", accel_h, cam_h, st_h)
    with _build.precise():  # what separately rounded multiply-adds would cost
        ms_k1_precise = cuda_ms(lambda: uber.uber_render(accel_h, cam_h, st_h), 3)
    # where the rest of a frame goes: the accel build (host + device) and the
    # epilogue (per-sample sqrt, mean over samples)
    t0 = time.perf_counter()
    for _ in range(3):
        uber._scene_accel(scene, camera, cfg, GR)
    torch.cuda.synchronize()
    accel_ms = (time.perf_counter() - t0) / 3 * 1e3
    out_h, stats_h = uber.uber_render(accel_h, cam_h, st_h)
    post_ms = cuda_ms(lambda: uber._uber_post(out_h, stats_h, cfg), 3)
    n_nodes, sphere_tests = int(stats_h[uber.ST_RAYS]), int(stats_h[uber.ST_SPHERE_TESTS])
    del out_h
    say(phase="frame_breakdown", kernel_ms=ms_k1, kernel_ms_per_lane_mode=ms_k1_lane,
        kernel_ms_precise_build=ms_k1_precise, accel_build_ms=accel_ms,
        epilogue_ms=post_ms, frame_ms=min(times) * 1e3,
        sphere_tests_per_ray=sphere_tests / n_nodes, **simt(stats_h))
    k1_bytes = 16 * st_h.B + accel_bytes(accel_h) + 4 * uber.CAM_LEN
    k1_flops = (sphere_tests * FLOPS_PER_SPHERE_TEST
                + n_nodes * (accel_h.n_groups * FLOPS_PER_SLAB_TEST + FLOPS_PER_NODE_SHADE))
    k1_bound, k1_by = bound(k1_bytes, k1_flops)

    # The sweep's shape on the main path: the canary's lanes, hit block + RI.
    # Counted for this run's data: quadratics the kernel solved, refines for
    # the rays that hit, the RI probe for the rays that need it.
    stats_k2 = torch.zeros(sweep2.SW_LEN, dtype=torch.int64, device=dev)
    _, obj_q, rows_q = sweep2._sweep2(accel_q, lanes, True, True, stats=stats_k2)
    ms_k2 = cuda_ms(lambda: sweep2._sweep2(accel_q, lanes, True, True), 20)
    with coop(1):  # the per-lane sweep, in the same call
        ms_k2_lane = cuda_ms(lambda: sweep2._sweep2(accel_q, lanes, True, True), 20)
        stats_k2_lane = torch.zeros_like(stats_k2)
        sweep2._sweep2(accel_q, lanes, True, True, stats=stats_k2_lane)
    Bq = lanes.shape[1]
    hit_q = obj_q >= 0
    inner_q = (rows_q[sweep2.V_NX:sweep2.V_NZ + 1] * lanes[3:6]).sum(dim=0) > 0.0
    n_probe = int((hit_q & (inner_q | (rows_q[sweep2.V_REFR] > 0.002))).sum())
    k2_bytes = 4 * Bq * (8 + 1 + 1 + sweep2.V_ROWS) + accel_bytes(accel_q) + 4 * accel_q.n_groups
    k2_flops = (int(stats_k2[sweep2.SW_ROW_TESTS]) * FLOPS_PER_SPHERE_TEST
                + Bq * accel_q.n_groups * FLOPS_PER_SLAB_TEST
                + int(hit_q.sum()) * FLOPS_PER_REFINE
                + n_probe * accel_q.n_pgroups * sweep2.PROBE_GR * FLOPS_PER_PROBE_ROW)
    k2_bound, k2_by = bound(k2_bytes, k2_flops)
    require(min(ms_k2, ms_k2_lane) > k2_bound,
            f"K2 below its bound at the canary's lanes, a counting error: {ms_k2} {k2_bound}")
    k2_main = k2["canary_lanes"]

    kernels = [
        dict(name="uber_render", route="cuda",
             source="raytracing_tests_tpu_torch/csrc/uber.cu",
             replaces="raytracing_tests_tpu/kernels/uber.py:874",
             launches=launches_frames[-1]["uber"],
             launches_by_path=dict(canary=launches_canary.get("uber", 0),
                                   headline_frame=launches_frames[-1]["uber"]),
             max_abs_err=px_plain["max_abs_err"],
             tolerance=f"finished image within {PIXEL_ATOL} of the plain version's on "
                       f">= {PIXEL_FRAC} of the pixels, at most {PIXEL_MAX} anywhere, "
                       f"{PIXEL_MEAN} on average",
             frac_within_tolerance=px_plain["within_atol"],
             per_sample_max_abs_err=k1["colour_max_abs_err"],
             per_sample_frac_within_1e4=k1["colour_within_1e4"],
             per_sample_frac_within_1e4_precise_build=k1_precise["colour_within_1e4"],
             ms=ms_k1, ms_per_lane_mode=ms_k1_lane, plain_ms=plain_ms_k1, bound_ms=k1_bound,
             bound_by=k1_by, simt_efficiency=simt(stats_h)["simt_efficiency"],
             simt_efficiency_per_lane_mode=sweep_k1["1"]["simt_efficiency"],
             library_ms=None, shape=size_of(HEADLINE)),
        dict(name="sweep2", route="cuda",
             source="raytracing_tests_tpu_torch/csrc/sweep2.cu",
             replaces="raytracing_tests_tpu/kernels/sweep2.py:955",
             launches=launches_canary["sweep2"],
             launches_by_path=dict(canary=launches_canary["sweep2"],
                                   headline_frame=launches_frames[-1].get("sweep2", 0)),
             max_abs_err=max(k2_main["fields_max_abs_err"], k2_main["normal_max_abs_err"]),
             tolerance="on the canary's lanes: material fields within 1e-5, "
                       "surrounding RI equal and normals within 1e-2 on >= 99.9% "
                       "of rays, refined t rtol 1e-4 on >= 99%",
             frac_within_tolerance=min(k2_main["fields_within_1e5"], k2_main["ri_equal"],
                                       k2_main["normal_within_1e2"],
                                       k2_main["t_within_rtol_1e4"]),
             ms=ms_k2, ms_per_lane_mode=ms_k2_lane, plain_ms=plain_ms_k2, bound_ms=k2_bound,
             bound_by=k2_by, simt_efficiency=k2_simt(stats_k2)["simt_efficiency"],
             simt_efficiency_per_lane_mode=k2_simt(stats_k2_lane)["simt_efficiency"],
             library_ms=None, shape=f"{Bq} rays, hit block + RI"),
    ]
    generic, k3_canary = generic_phases(dev, (scene, camera, cfg_s, lanes), ptxas)
    kernels += generic
    k2_canary = dict(canary_lanes=(accel_q, lanes), canary_second_pop=(accel_q, lanes2))
    third, sweep2_by_path, k2_wq = third_slice_phases(
        dev, (scene, camera, cfg, cfg_s, out, k2_canary))
    kernels += third
    kernels[1]["launches_by_path"].update(sweep2_by_path)  # K2 static: the work queue's paths
    kernels[1]["at_workqueue_frame"] = k2_wq  # its launches there, summed
    sixth, sixth_paths = shading_phases(dev)
    kernels += sixth
    seventh, seventh_paths = texturing_phases(dev)
    kernels += seventh
    eighth, eighth_paths, k3_hard_step = grad_phases(dev, k3_canary)
    # the thirteenth slice: the row-sharded mesh, on virtual shards of this card
    thirteenth_paths = parallel_phases(dev, out, frame)
    # the fourteenth slice: the oracle on the card, the normals view,
    # progressive tiles and the LBVH
    fourteenth_paths = fourteenth_phases(dev)
    k3 = next(k for k in kernels if k["name"] == "sweep2g")
    k3.update(at_hard_step=k3_hard_step, ptxas=ptxas.get("sweep2g.so sweep2g_kernel<0>"))
    for k in eighth:  # the silhouette instantiations' ptxas lines
        m = int("_m_" in k["name"])
        k["ptxas"] = ptxas.get(f"sweep2g.so sweep2g_edge_kernel<{m}>" if k["name"].startswith(
            "sweep2g") else f"sweep2.so sweep2_kernel<{m},1>")
    kernels += eighth
    # every instantiation of K1 with its ptxas line
    entry_of = {v: n for n, v in KERNEL_ENTRY.items()}
    for k in kernels:
        if k["name"] in entry_of:
            k.setdefault("instantiation", entry_of[k["name"]])
            lib = "uber_tex.so" if k["instantiation"].endswith("_tex") else "uber.so"
            k["ptxas"] = ptxas.get(f"{lib} {instantiation_of(k['instantiation'])}")
    # the sixth and seventh slices' paths that launch earlier kernels: K2 and
    # K5 behind the queue renderer on the new canaries, shadow sweeps
    # included, K2 behind the work queue with lights and textures, K1 'bvh' on
    # the deep stacks, the untextured instantiations on the camera canaries; the
    # thirteenth slice's: K1 once a shard, K5 behind the sharded queue
    # renderer, K2 behind the sharded gradient step; the fourteenth's: K2 and
    # K5 behind the oracle's cases, the normals view and the progressive tiles
    later_paths = {**sixth_paths, **seventh_paths, **eighth_paths, **thirteenth_paths,
                   **fourteenth_paths}
    for k in kernels:
        counter = dict(sweep2="sweep2", sweep2_motion="sweep2_m", sweep2g="sweep2g",
                       sweep_grouped="sweep_grouped", sweep_ri="sweep_ri").get(
            k["name"], k.get("instantiation"))
        if counter:
            k["launches_by_path"].update({p: got[counter] for p, got in later_paths.items()
                                          if got.get(counter)})
    require(sum(k["name"] in entry_of for k in kernels) == 24,
            "the kernels line lists the twenty-four instantiations of K1")
    for k in kernels:
        require(max(k["launches_by_path"].values()) > 0 and k["launches"] > 0,
                f"kernel {k['name']} was launched on no driven path: {k['launches_by_path']}")
    say(kernels=kernels)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
