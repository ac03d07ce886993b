"""Persistent path tracer: the ENTIRE render in one kernel launch.

Counterpart of the JAX package's ``kernels/uber.py``.  Per primary ``p``
(pixel ``p // spp``, sample ``p % spp``) the camera ray is generated in the
kernel (fov basis + sunflower thin-lens DOF with up to 7 focus distances,
optionally jittered on the ``aa_grid`` supersampling grid, or the
orthographic lattice), then its ray tree is walked with
a LIFO stack of ``Q`` records — nearest hit, winner re-solve, shading,
children — one child continuing in place and the other waiting on the stack,
in each shading model's push/pop order, under a budget of ``cfg.pops`` nodes
per primary and the queue renderer's overflow drop order:

  - ``shading="bvh"`` (In-Next-Week): surrounding-RI probe, reflection in
    place, refraction stacked; records of 8 floats (o, d, contribution,
    bounce count);
  - with emissive ``lights``: the same, plus one shadow ray per light from
    every hit (its contribution scaled by the share of lights it sees), a
    black background, and a hit on an emissive object paints the sample
    white and drops the rest of its tree;
  - ``shading="materials"`` (Shirley materials): refraction in place,
    reflection stacked; records of 10 floats (+ the medium RI and the
    parent's), no contribution cutoff, so only the pops budget bounds a tree.

The kernel is hand-written CUDA (``csrc/uber.cu``); ``uber_render_plain`` is
the same function in plain PyTorch without the scheduling: all ``B``
primaries as one batch, a loop of at most ``cfg.pops`` iterations, each doing
the nearest hit (``sweep2._sweep_plain`` over spheres in the sweep's anchored
form, ``sweep2g._sweep_plain_g`` over rotated ellipsoids and cuboids), refine,
probe, shade and the in-place-child / stack step.  The wrapper ``uber_render``
uses the plain version only when the tables lie on the CPU; on CUDA tensors it
launches the kernel or raises.

The kernel has twenty-four instantiations: sphere-mode scenes
(``sweep2.Accel2``) and generic scenes (``sweep2g.Accel2G``), each static or,
for an accel built with ``has_motion``, with motion blur (a primary's sample
``s`` fixes its tree's time, ``omt = 1 - s / spp``), each under 'bvh'
shading, 'bvh' shading with lights, or materials shading, each untextured or
with the scene's cube-sphere atlases (``texture.pack_atlas``; a textured
winner's albedo times its atlas sample, ``texture.texture_color``), the
textured twelve in a library of their own, ``csrc/uber_tex.cu``
(``launch_name``).  Each thread's stack
lives in a scratch buffer the wrapper allocates for the threads the launch
keeps resident, so any ``Q`` is taken.

A warp of the kernel sweeps every culling group together: per lane where at
least ``COOP_MIN[accel.mode]`` of its lanes entered the group, row-parallel
for one entered lane after another where fewer did (``csrc/warp_sweep.cuh``).  Both
schedules give the same result; ``_forced_coop_min`` (``_build.forced_coop_min``)
pins one for tests.  The wrapper hands the kernel each group's last live row + 1
(``sweep2.live_rows``, computed once per accel), so rows past it are never read.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from raytracing_tests_tpu_torch.kernels import _build, sweep2
from raytracing_tests_tpu_torch.kernels._cache import TensorCache
from raytracing_tests_tpu_torch.kernels.mega import (
    GOLDEN_ANGLE, _cross_up, _shade_hits, _shade_materials_k, sunflower_statics,
)
from raytracing_tests_tpu_torch.kernels.sweep2 import (
    PROBE_GR, _check_tensor, _dot3, _sweep_plain, check_accel, live_rows, make_accel2,
    probe_relevant_rows,
)
from raytracing_tests_tpu_torch.kernels.sweep2g import (
    _sweep_plain_g, check_accel_g, make_accel2g,
)
from raytracing_tests_tpu_torch.kernels.texture import TEXEL_FLOATS, pack_atlas
from raytracing_tests_tpu_torch.ops.camera_rays import aa_jitter
from raytracing_tests_tpu_torch.utils.device import resolve_device

# Camera scalar-vector layout.  STRIDE/ROW0 map a local row index to the
# global image row (iy = local * stride + row0), for row-interleaved shards.
# CAM_PAD holds the orthographic height, CAM_FD2.. the focus distances after
# the first (multi-focus, K <= MAX_FOCUS); an orthographic camera, which has
# no lens, holds there instead its unit right and up vectors (CAM_RNX, CAM_UNX).
(
    CAM_PX, CAM_PY, CAM_PZ, CAM_DX, CAM_DY, CAM_DZ,
    CAM_RX, CAM_RY, CAM_RZ, CAM_UX, CAM_UY, CAM_UZ,
    CAM_SD, CAM_AP, CAM_FD, CAM_STRIDE, CAM_ROW0, CAM_PAD, CAM_FD2,
) = range(19)
CAM_LEN = 24  # padded
MAX_FOCUS = 1 + CAM_LEN - CAM_FD2
CAM_RNX, CAM_UNX = CAM_FD2, CAM_FD2 + 3

# Host parameter vectors of csrc/uber.cu (IP_* / FP_* there).
_IP = ("W", "H", "spp", "Q", "pops", "has_dielectrics", "n_groups", "gr",
       "n_pgroups", "probe_gr", "generic", "n_sgroups", "has_motion", "coop_min",
       "shading", "n_lights", "n_focus", "ortho", "tex_t", "tex_h", "tex_w6")
# The shading codes of csrc/uber.cu (SH_* there), and the floats per stacked
# record each takes.
SHADING_CODE = {"bvh": 0, "lights": 1, "materials": 2}
REC = {"bvh": 8, "lights": 8, "materials": 10}
# Frame counters of csrc/uber.cu (ST_* there).  ST_SPHERE_TESTS: sphere
# quadratics solved; the next three are counted in generic mode only: slab
# tests, live rows tested in groups of another kind than 's', nodes that hit.
# The next three measure the warp sweeps: rows each lane's own walk needed,
# 32 x the row iterations the warps issued (SIMT efficiency = ST_ROW_TESTS /
# ST_LANE_SLOTS), group visits served row-parallel.  ST_SHADOW_RAYS: shadow
# rays swept (lights only; their rows are in the sweep counters too).
# ST_TEX_SAMPLES: atlas samples taken (textured instantiations: shaded hits on
# a winner with a texture index).  The plain version fills none of the last
# eight.
(ST_NEXT, ST_RAYS, ST_DROPPED, ST_SPHERE_TESTS, ST_SLAB_TESTS, ST_OTHER_TESTS,
 ST_HITS, ST_ROW_TESTS, ST_LANE_SLOTS, ST_COOP_VISITS, ST_SHADOW_RAYS, ST_TEX_SAMPLES,
 ST_LEN) = range(13)

# A culling group that fewer than this many lanes of a warp entered is swept
# row-parallel, by accel mode (the fastest of 1..33 on the headline and the
# bvh1k frame, PERF.md).  1 keeps every group per lane (the one-thread-per-tree
# schedule), 33 sweeps every group row-parallel.
COOP_MIN = {"spheres": 12, "generic": 8}
_forced_coop_min = _build.forced_coop_min

_PLAIN_CHUNK = 1 << 20  # primaries per batch of the plain version

# (library, device, mode, motion, shading, B) -> the threads a launch keeps
# resident (rt_uber_threads: an occupancy query, asked once per key)
_THREADS: dict = {}


@dataclasses.dataclass(frozen=True)
class UberStatics:
    """The static (per-frame) numbers both versions of the kernel take.

    ``H`` is the frame's height: raygen's ``1/H``, the aspect and the
    ``aa_grid`` table take it.  ``rows`` is how many rows the launch renders,
    when that is not the frame (a shard of a row-interleaved mesh, whose
    camera vector maps local row r to ``r * CAM_STRIDE + CAM_ROW0``); 0 means
    all ``H``.  ``B`` counts the launch's primaries."""

    W: int
    H: int
    spp: int
    Q: int
    pops: int
    max_bounces: int
    t_max: float
    has_dielectrics: bool
    bg_bottom: tuple
    bg_top: tuple
    shading: str = "bvh"  # 'bvh' | 'materials'
    n_lights: int = 0  # rows of the pack_lights table ('bvh' only)
    n_focus: int = 1  # focus distances of the camera (1 .. MAX_FOCUS)
    ortho: bool = False  # orthographic camera
    rows: int = 0  # rows this launch renders (0: the frame's H)

    @classmethod
    def from_cfg(cls, cfg, n_lights: int = 0, camera=None) -> "UberStatics":
        """The frame's statics (the camera's too, if given); a scene with
        lights has a black background."""
        bg = ((0.0, 0.0, 0.0),) * 2 if n_lights else cfg.background
        n_focus, ortho = (1, False) if camera is None else _camera_statics(camera)
        return cls(W=cfg.width, H=cfg.height, spp=cfg.spp,
                   Q=cfg.queue_capacity, pops=cfg.pops,
                   max_bounces=cfg.max_bounces, t_max=cfg.t_max,
                   has_dielectrics=cfg.has_dielectrics,
                   bg_bottom=tuple(bg[0]), bg_top=tuple(bg[1]),
                   shading=cfg.shading, n_lights=n_lights, n_focus=n_focus, ortho=ortho)

    @property
    def B(self) -> int:
        return self.W * (self.rows or self.H) * self.spp

    @property
    def model(self) -> str:
        """'bvh', 'lights' or 'materials': the instantiation's shading."""
        return "lights" if self.n_lights else self.shading


def pack_lights(lights):
    """``ops.render.Lights`` -> ((n_lights, 8) f32 rows [bb_min xyz, bb_max
    xyz, diagonal, 0] on the lights' device, n_lights); the masked-out rows
    are dropped; ``(None, 0)`` for no lights.  Computed once per Lights and
    kept on it, renewed when one of its tensors is replaced or written in
    place."""
    if lights is None:
        return None, 0
    key = tuple((t.data_ptr(), t._version) for t in (lights.mask, lights.bb_min, lights.bb_max))
    memo = lights.__dict__.get("_packed")
    if memo is None or memo[0] != key:
        idx = torch.nonzero(lights.mask)[:, 0]
        mn, mx = lights.bb_min[idx], lights.bb_max[idx]
        rows = torch.zeros((idx.shape[0], 8), dtype=torch.float32, device=mn.device)
        rows[:, 0:3] = mn
        rows[:, 3:6] = mx
        rows[:, 6] = torch.sqrt(torch.sum((mx - mn) ** 2, dim=1))
        memo = lights.__dict__["_packed"] = (key, (rows, int(idx.shape[0])) if len(idx) else (None, 0))
    return memo[1]


def aa_table(W: int, H: int, spp: int, device):
    """The ``aa_grid`` screen offset of every sample as the kernel adds it to
    the pixel's screen point: (spp, 2) f32 (jx / W * aspect, jy / H) on
    ``device``, rounded as ``ops.camera_rays.primary_rays`` rounds them."""
    jx, jy = aa_jitter(spp)
    tab = np.stack([jx / np.float32(W) * np.float32(W / H), jy / np.float32(H)], axis=1)
    return torch.from_numpy(tab).to(device)


def pack_camera(camera, row_stride=1.0, row0=0.0):
    """Camera -> (CAM_LEN,) f32 scalar vector (see CAM_* layout), on the
    camera's device; ``focus_dist[1:MAX_FOCUS]`` rides the tail at
    ``CAM_FD2``, or for an orthographic camera its unit right and up vectors,
    each normalised in float32 by division as the kernel would."""
    dev = camera.device
    d = camera.direction
    up = torch.tensor([0.0, 1.0, 0.0], dtype=torch.float32, device=dev)
    right = torch.linalg.cross(d, up)  # unnormalized, faithful to the reference
    cup = torch.linalg.cross(right, d)
    sd = 1.0 / (2.0 * torch.tan(camera.fov_y * 0.5))
    f32 = lambda x: torch.as_tensor(x, dtype=torch.float32, device=dev).reshape(())
    vals = torch.cat([
        camera.position, d, right, cup,
        torch.stack([sd, camera.aperture, camera.focus_dist[0],
                     f32(row_stride), f32(row0), f32(camera.ortho_height)]),
        camera.focus_dist[1:MAX_FOCUS],
    ]).to(torch.float32)
    out = torch.zeros(CAM_LEN, dtype=torch.float32, device=dev)
    out[:vals.shape[0]] = vals
    unit = lambda v: v / torch.sqrt(v[0] * v[0] + v[1] * v[1] + v[2] * v[2])
    out[CAM_RNX:CAM_UNX + 3] = torch.where(
        camera.ortho_height > 0.0,
        torch.cat([unit(out[CAM_RX:CAM_RZ + 1]), unit(out[CAM_UX:CAM_UZ + 1])]),
        out[CAM_RNX:CAM_UNX + 3])
    return out


# ---------------------------------------------------------------------------
# The plain PyTorch version
# ---------------------------------------------------------------------------


def _raygen(cam, st: UberStatics, p, aa=None):
    """Primary rays for global primary indices ``p`` (B,) i64 ->
    (o (B, 3), d (B, 3), sidx (B,), (cos th, sin th)).

    Transcribes ``ops.camera_rays.primary_rays`` the way the kernel computes
    it: unnormalized right/up screen basis + sunflower thin-lens aperture
    pivoting about the focal point at the sample's focus distance; ``aa``
    (``aa_table``) jitters the screen point per sample; an orthographic
    camera (``st.ortho``) starts parallel rays on the view-plane lattice."""
    W, H, spp = st.W, st.H, st.spp
    aspect = W / H
    pix = p // spp
    s_i = p - pix * spp
    sf = s_i.to(torch.float32)
    ix = pix % W
    iy = (pix // W).to(torch.float32) * cam[CAM_STRIDE] + cam[CAM_ROW0]
    pxs = (ix.to(torch.float32) * (1.0 / W) - 0.5) * aspect
    pys = iy * (1.0 / H) - 0.5
    if aa is not None:
        pxs = pxs + aa[s_i, 0]
        pys = pys + aa[s_i, 1]
    th = GOLDEN_ANGLE * sf
    cth, sth = torch.cos(th), torch.sin(th)
    pos = cam[CAM_PX:CAM_PZ + 1]
    if st.ortho:
        # origin pos + h (pxs r / |r| + pys u / |u|), the unit vectors packed
        h = cam[CAM_PAD]
        o = (pos + (pxs * h)[:, None] * cam[CAM_RNX:CAM_RNX + 3]
             + (pys * h)[:, None] * cam[CAM_UNX:CAM_UNX + 3])
        d = cam[CAM_DX:CAM_DZ + 1].expand(o.shape).contiguous()
        return o, d, sf, (cth, sth)
    sd = cam[CAM_SD]
    bd = (cam[CAM_DX:CAM_DZ + 1] * sd
          + cam[CAM_RX:CAM_RZ + 1] * pxs[:, None]
          + cam[CAM_UX:CAM_UZ + 1] * pys[:, None])
    bd = bd * torch.rsqrt(torch.clamp_min(_dot3(bd, bd), 1e-30))[:, None]

    # sunflower_disc(s, spp, aperture)
    n, b, denom = sunflower_statics(spp)
    half_ap = cam[CAM_AP] * 0.5
    r = torch.where(
        sf > n - b, half_ap.expand_as(sf),
        half_ap * torch.sqrt(torch.clamp_min(sf - 0.5, 0.0) * (1.0 / denom)))
    r = torch.where(sf == 0.0, torch.zeros_like(r), r)
    offx = (r * cth)[:, None]
    offy = (r * sth)[:, None]
    rr, ru = _cross_up(bd)

    tip = pos + bd + rr * offx + ru * offy
    if st.n_focus == 1:
        fd = cam[CAM_FD]
    else:  # sample s focuses at the (s % K)-th distance
        fds = torch.cat([cam[CAM_FD:CAM_FD + 1], cam[CAM_FD2:CAM_FD2 + st.n_focus - 1]])
        fd = fds[s_i % st.n_focus][:, None]
    dd = pos + bd * fd - tip
    dd = dd * torch.rsqrt(torch.clamp_min(_dot3(dd, dd), 1e-30))[:, None]
    return tip - dd, dd, sf, (cth, sth)


def uber_render_plain(accel, cam, st: UberStatics, lights=None, atlas=None, aa=None):
    """Plain PyTorch version of the persistent kernel.

    Returns ``(out (B, 4) f32, stats (ST_LEN,) i64)``: per primary r, g, b and
    the primary hit distance in p-linear order, and the frame counters.  Trees
    are independent, so the frame is walked in ranges of ``_PLAIN_CHUNK``
    primaries that bound memory; this is not scheduling.  ``lights``: the
    ``pack_lights`` rows of ``st.n_lights`` lights; ``atlas``: the scene's
    ``texture.pack_atlas`` (texels, (T, H, W6)) or None; ``aa``: the
    ``aa_table`` of an ``aa_grid`` frame or None."""
    _check_inputs(lights, atlas, aa, st, accel.device)
    texels = None if atlas is None else atlas[0]
    parts = [_plain_range(accel, cam, st, p0, min(_PLAIN_CHUNK, st.B - p0), lights,
                          texels, aa)
             for p0 in range(0, st.B, _PLAIN_CHUNK)]
    out = torch.cat([o for o, _, _ in parts]) if len(parts) > 1 else parts[0][0]
    stats = torch.zeros(ST_LEN, dtype=torch.int64, device=accel.device)
    stats[ST_NEXT] = st.B
    stats[ST_RAYS] = sum(r for _, r, _ in parts)
    stats[ST_DROPPED] = sum(d for _, _, d in parts)
    return out, stats


def _plain_range(accel, cam, st: UberStatics, p0: int, B: int, lights=None, texels=None,
                 aa=None):
    """The trees of primaries ``p0 .. p0 + B`` as one batch ->
    (out (B, 4), rays, dropped); ``texels``: ``pack_atlas``'s, textured
    winners' albedo is textured."""
    dev = accel.device
    Q = st.Q
    f32 = torch.float32
    materials = st.shading == "materials"
    p = torch.arange(p0, p0 + B, dtype=torch.int64, device=dev)
    o, d, sidx, trig = _raygen(cam, st, p, aa)
    contrib = torch.ones(B, dtype=f32, device=dev)
    bounced = torch.zeros(B, dtype=f32, device=dev)
    medium = torch.ones(B, dtype=f32, device=dev)  # materials only
    parent = torch.ones(B, dtype=f32, device=dev)
    act = torch.ones(B, dtype=torch.bool, device=dev)
    qs = torch.zeros(B, dtype=torch.int64, device=dev)
    stack = torch.zeros((B, max(Q, 1), REC[st.model]), dtype=f32, device=dev)
    acc = torch.zeros((B, 3), dtype=f32, device=dev)
    acc_t = torch.full((B,), st.t_max, dtype=f32, device=dev)
    tlim = torch.full((B,), st.t_max, dtype=f32, device=dev)
    bottom = torch.tensor(st.bg_bottom, dtype=f32, device=dev)
    top = torch.tensor(st.bg_top, dtype=f32, device=dev)
    lanes = torch.arange(B, device=dev)
    n_rays = n_drop = 0
    generic = accel.mode == "generic"
    omt = 1.0 - sidx / st.spp  # the tree's time is its sample's: s / spp

    for cnt in range(1, st.pops + 1):  # cnt = nodes processed per live tree
        if not bool(act.any()):
            break
        live = (_dot3(d, d) > 0.5) & act
        if generic:
            t_best, obj = _sweep_plain_g(accel, o, d, omt, live, tlim)
        else:
            t_best, obj = _sweep_plain(accel, o, d, live, tlim, omt)
        hit = (obj >= 0) & act
        tt = ((d[:, 1] + 1.0) * 0.5)[:, None]
        bg = (1.0 - tt) * bottom + tt * top
        kw = dict(spp=st.spp, max_bounces=st.max_bounces, t_max=st.t_max, trig=trig, omt=omt,
                  texels=texels)
        if materials:
            sh = _shade_materials_k(accel, o, d, contrib, bounced, act, sidx, t_best, obj,
                                    hit, bg, medium, parent, **kw)
        else:
            sh = _shade_hits(accel, o, d, contrib, bounced, act, sidx, t_best, obj, hit,
                             bg, has_dielectrics=st.has_dielectrics, lights=lights, **kw)
        primary = act & (bounced == 0.0)
        acc = acc + sh.add  # zero on finished lanes
        # Emissive abort: the sample becomes white and its tree ends.
        white = torch.zeros_like(act) if sh.white is None else sh.white & act
        acc = torch.where(white[:, None], torch.ones_like(acc), acc)
        acc_t = torch.where(primary, sh.hit_t, acc_t)
        n_rays += int(act.sum())  # every processed node, misses included

        # One child continues in place, the other waits on the stack — the
        # queue renderer's push/pop order: reflection in place under 'bvh',
        # refraction in place under materials shading.
        refr_rec = [sh.refr_o, sh.refr_d, sh.refr_contrib[:, None], sh.bounced[:, None]]
        refl_rec = [sh.refl_o, sh.refl_d, sh.refl_contrib[:, None], sh.bounced[:, None]]
        cur = [o, d, contrib[:, None], bounced[:, None]]
        if materials:
            refr_rec += [sh.refr_medium[:, None], sh.refr_parent[:, None]]
            refl_rec += [sh.refl_medium[:, None], sh.refl_parent[:, None]]
            cur += [medium[:, None], parent[:, None]]
        refr_rec, refl_rec = torch.cat(refr_rec, dim=1), torch.cat(refl_rec, dim=1)
        if materials:
            in_rec, q_rec, sp_in, sp_q = refr_rec, refl_rec, sh.spawn_refr, sh.spawn_refl
        else:
            in_rec, q_rec, sp_in, sp_q = refl_rec, refr_rec, sh.spawn_refl, sh.spawn_refr
        push = sh.spawn_refl & sh.spawn_refr & act
        canq = qs < Q
        do_push = push & canq
        overflow = push & ~canq
        n_drop += int(overflow.sum())
        pl = lanes[do_push]
        stack[pl, qs[pl]] = q_rec[pl]
        qs = qs + do_push.to(torch.int64)
        # Per-primary node budget, and the emissive abort: the tree dies,
        # stacked siblings drop.
        kill = white | (act if cnt >= st.pops else torch.zeros_like(act))
        qs = torch.where(kill, torch.zeros_like(qs), qs)
        need_pop = act & ~sh.spawn_refl & ~sh.spawn_refr & ~kill
        do_pop = need_pop & (qs > 0)
        pop_rec = stack[lanes, torch.clamp_min(qs - 1, 0)]
        qs = qs - do_pop.to(torch.int64)
        # On overflow the stacked-preference child survives.
        chosen = torch.where((sp_in & ~overflow)[:, None], in_rec,
                             torch.where((sp_q | overflow)[:, None], q_rec, pop_rec))
        keep = ~act[:, None]  # finished lanes hold their last record
        cur = torch.where(keep, torch.cat(cur, dim=1), chosen)
        o, d, contrib, bounced = cur[:, 0:3], cur[:, 3:6], cur[:, 6], cur[:, 7]
        if materials:
            medium, parent = cur[:, 8], cur[:, 9]
        act = act & (sh.spawn_refl | sh.spawn_refr | do_pop) & ~kill

    return torch.cat([acc, acc_t[:, None]], dim=1), n_rays, n_drop


# ---------------------------------------------------------------------------
# Kernel wrapper
# ---------------------------------------------------------------------------


def _uber_lib(textured: bool):
    """``uber.so`` (the untextured instantiations) or ``uber_tex.so``."""
    lib = _build.load("uber_tex" if textured else "uber")
    if lib.rt_uber_render.argtypes is None:
        p, ip = ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)
        lib.rt_uber_render.argtypes = [p, p, p, p, p, p, p, p, ip,
                                       ctypes.POINTER(ctypes.c_float), ctypes.c_longlong, p, p,
                                       p, ctypes.c_longlong, p]
        lib.rt_uber_render.restype = ctypes.c_int
        lib.rt_uber_threads.argtypes = [ip, ctypes.c_longlong]
        lib.rt_uber_threads.restype = ctypes.c_longlong
    return lib


def _host_params(accel, st: UberStatics, atlas=None):
    n, b, denom = sunflower_statics(st.spp)
    T, H, W6 = (0, 0, 0) if atlas is None else atlas[1]
    ints = dict(W=st.W, H=st.H, spp=st.spp, Q=st.Q, pops=st.pops,
                has_dielectrics=int(st.has_dielectrics),
                n_groups=accel.n_groups, gr=accel.gr,
                n_pgroups=accel.n_pgroups, probe_gr=PROBE_GR,
                generic=int(accel.mode == "generic"),
                n_sgroups=getattr(accel, "n_sgroups", 0),
                has_motion=int(accel.has_motion),
                coop_min=_build.coop_min(COOP_MIN[accel.mode]),
                shading=SHADING_CODE[st.model], n_lights=st.n_lights,
                n_focus=st.n_focus, ortho=int(st.ortho), tex_t=T, tex_h=H, tex_w6=W6)
    ip = (ctypes.c_int * len(_IP))(*[ints[k] for k in _IP])
    floats = [st.t_max, GOLDEN_ANGLE, 1.0 / st.W, 1.0 / st.H, st.W / st.H,
              n, n - b, denom, 1.0 / denom, float(st.max_bounces),
              *st.bg_bottom, *st.bg_top, 1.0 / st.spp, 1.0 / max(st.n_lights, 1)]
    fp = (ctypes.c_float * len(floats))(*floats)
    return ip, fp


def _check_inputs(lights, atlas, aa, st: UberStatics, dev):
    """The lights rows, the packed atlas and the aa table against the
    statics and the device."""
    if st.n_lights and st.shading != "bvh":
        raise ValueError("materials shading takes no emissive lights")
    if st.n_lights:
        _check_tensor("lights", lights, torch.float32, (st.n_lights, 8), dev)
    elif lights is not None:
        raise ValueError("lights given, but the statics count none")
    if not 1 <= st.n_focus <= MAX_FOCUS:
        raise ValueError(f"{st.n_focus} focus distances: the kernel takes 1 to {MAX_FOCUS}")
    if atlas is not None:
        texels, (T, H, W6) = atlas
        if min(T, H, W6) < 1:
            raise ValueError(f"an empty atlas stack: {(T, H, W6)}")
        _check_tensor("atlas", texels, torch.float32, (T, H, W6, TEXEL_FLOATS), dev)
    if aa is not None:
        _check_tensor("aa", aa, torch.float32, (st.spp, 2), dev)


def _launch_uber(accel, cam, st: UberStatics, lights=None, atlas=None, aa=None):
    """Check the arguments and launch ``csrc/uber.cu`` (``uber_tex.cu`` with
    an atlas) -> (out, stats).  The per-thread stacks are a scratch buffer of
    ``Q`` records for each thread the launch keeps resident
    (``rt_uber_threads``)."""
    dev = accel.device
    generic = accel.mode == "generic"
    (check_accel_g if generic else check_accel)(accel, dev)
    _check_tensor("cam", cam, torch.float32, (CAM_LEN,), dev)
    _check_inputs(lights, atlas, aa, st, dev)
    _build.check_device(dev)
    lib = _uber_lib(atlas is not None)
    ip, fp = _host_params(accel, st, atlas)
    live = live_rows(accel)
    out = torch.empty((st.B, 4), dtype=torch.float32, device=dev)
    stats = torch.zeros(ST_LEN, dtype=torch.int64, device=dev)
    key = (id(lib), dev.index, accel.mode, accel.has_motion, st.model, st.B)
    threads = _THREADS.get(key)
    if threads is None:
        threads = lib.rt_uber_threads(ip, st.B)
        if threads < 0:
            _build.check(-threads, "rt_uber_threads")
        threads = _THREADS[key] = threads
    stack = torch.empty(max(threads * st.Q * REC[st.model], 1), dtype=torch.float32,
                        device=dev)
    code = lib.rt_uber_render(
        accel.otab.data_ptr(), accel.ftab.data_ptr(), accel.gaabb.data_ptr(),
        live.data_ptr(), cam.data_ptr(), None if lights is None else lights.data_ptr(),
        None if atlas is None else atlas[0].data_ptr(), None if aa is None else aa.data_ptr(),
        ip, fp, st.B, out.data_ptr(), stats.data_ptr(), stack.data_ptr(), threads,
        _build.stream_of(dev))
    _build.check(code, "rt_uber_render")
    _build.LAUNCHES[launch_name(accel, st.model, atlas is not None)] += 1
    return out, stats


def launch_name(accel, model: str = "bvh", textured: bool = False) -> str:
    """The launch counter of the instantiation that ``accel``, the shading
    ``model`` (``UberStatics.model``) and an atlas select: ``uber`` /
    ``uber_g`` (sphere / generic), ``_m`` appended with motion, then ``_lt``
    with lights or ``_mat`` under materials shading, then ``_tex`` when
    textured."""
    name = "uber_g" if accel.mode == "generic" else "uber"
    name = name + "_m" if accel.has_motion else name
    name += {"bvh": "", "lights": "_lt", "materials": "_mat"}[model]
    return name + "_tex" if textured else name


def uber_render(accel, cam, st: UberStatics, lights=None, atlas=None, aa=None):
    """The whole frame: ``(out (B, 4) f32, stats (ST_LEN,) i64)``.

    Tables on the CPU go through ``uber_render_plain``; on CUDA the kernel of
    ``csrc/uber.cu`` is launched on the current stream (or this raises), in
    the instantiation the accel, the statics and the atlas select (counted
    under ``launch_name``).  ``lights``: ``pack_lights`` rows, ``st.n_lights``
    of them; ``atlas``: ``texture.pack_atlas`` of the scene's textures;
    ``aa``: ``aa_table`` for an ``aa_grid`` frame."""
    dev = accel.device
    if cam.device != dev:
        raise ValueError(f"cam on {cam.device}, accel on {dev}")
    if min(st.W, st.H, st.spp, st.pops) < 1 or st.Q < 0 or st.rows < 0:
        raise ValueError(f"bad frame statics: {st}")
    if st.shading not in ("bvh", "materials"):
        raise ValueError(f"unknown shading {st.shading!r}")
    if dev.type == "cpu":
        return uber_render_plain(accel, cam, st, lights, atlas, aa)
    with torch.cuda.device(dev):
        return _launch_uber(accel, cam, st, lights, atlas, aa)


# ---------------------------------------------------------------------------
# Entry point
# ---------------------------------------------------------------------------


# The render path's caches (``kernels/_cache.py``): the accel with the camera
# vector it was packed beside, in a FIFO of 8, and the packed atlas, in a FIFO
# of 4.  A cached table that a caller wrote into is rebuilt, not served.
_ACCEL_CACHE = TensorCache(
    8, watch=lambda v: (v[0].otab, v[0].ftab, v[0].gaabb, v[0].perm, v[1]))
_ATLAS_CACHE = TensorCache(4, watch=lambda v: (v[0],))


def clear_caches() -> None:
    """Empty the probe-cut, accel and atlas caches: the next ``render_uber``
    builds every table afresh."""
    sweep2._PROBE_CACHE.clear()
    _ACCEL_CACHE.clear()
    _ATLAS_CACHE.clear()


def _tensors(*structs):
    """Every tensor field of the given scenes and cameras, in field order."""
    return tuple(t for x in structs for t in (getattr(x, f.name) for f in dataclasses.fields(x))
                 if isinstance(t, torch.Tensor))


def _scene_accel(scene, camera, cfg, gr, cache: bool = True):
    """Probe cut + accel build + camera pack -> (accel, camera vector).

    The probe cut (``sweep2.probe_relevant_rows``) trims the surrounding-RI
    sub-table to rows that can actually answer; ``cfg.probe_rows == -1`` keeps
    the full table, ``0`` disables the probe.  Cached on the identity and
    version of every scene and camera tensor, with ``gr``, ``cfg.has_motion``,
    ``cfg.pallas_mode`` and the probe rows (``_ACCEL_CACHE``): variants of a
    scene coexist, and an in-place write to any of them, or to the returned
    tables, rebuilds.  Shared by ``render_uber`` and the row-sharded path.
    ``cache=False`` builds everything and stores nothing."""
    probe_rows, probe_mask = cfg.probe_rows, None
    if probe_rows > 0:
        probe_mask = probe_relevant_rows(scene, cache=cache)
        probe_rows = int(probe_mask.sum())

    def build():
        if cfg.pallas_mode == "spheres":
            accel = make_accel2(scene, gr=gr, sort_origin=camera.position,
                                probe_rows=probe_rows, probe_mask=probe_mask,
                                has_motion=cfg.has_motion)
        else:
            accel = make_accel2g(scene, gr=gr, has_motion=cfg.has_motion,
                                 sort_origin=camera.position,
                                 probe_rows=probe_rows, probe_mask=probe_mask)
        return accel, pack_camera(camera)

    deps = _tensors(scene, camera) if cache else None
    return _ACCEL_CACHE.cached(deps, (gr, cfg.has_motion, cfg.pallas_mode, probe_rows), build)


def packed_atlas(textures, cache: bool = True):
    """``texture.pack_atlas(textures)``, cached on the stack's identity and
    version (``_ATLAS_CACHE``) unless ``cache=False``."""
    return _ATLAS_CACHE.cached((textures,) if cache else None, (), lambda: pack_atlas(textures))


def _to_device(scene, camera, dev):
    """(scene, camera) on ``dev``, and whether they are still the caller's own
    tensors.  Only those go into the caches: a copy made for one call dies
    with it, so its entry could never be served and would only pin the copy
    and its tables on the device."""
    moved = scene.to(dev), camera.to(dev)
    own = all(a is b for a, b in zip(_tensors(scene, camera), _tensors(*moved)))
    return (*moved, own)


def _camera_statics(camera):
    """The camera's raygen switches: (n_focus, is_ortho).  The kernel takes
    at most ``MAX_FOCUS`` focus distances (the camera vector's tail)."""
    n_focus = int(camera.focus_dist.shape[0])
    if not 1 <= n_focus <= MAX_FOCUS:
        raise ValueError(f"render_uber takes 1 to {MAX_FOCUS} focus distances, not {n_focus}")
    return n_focus, float(camera.ortho_height) > 0.0


def render_uber(scene, camera, cfg, lights=None, gr: int = 32, qcap=None,
                device=None):
    """Full render via the persistent kernel;
    dict(image, depth, rays, rays_dropped).

    ``qcap`` overrides ``cfg.queue_capacity`` for the per-tree LIFO stack;
    ``rays_dropped`` reports any overflow honestly.  ``lights``
    (``ops.render.Lights``, from ``extract_lights``) adds the emissive
    lights; materials shading takes none.  A scene with textures runs the
    textured instantiation.  ``device=None`` means CUDA (raises when
    absent); ``device="cpu"`` runs the plain version.

    Identity-cached: the probe cut, the accel, the camera vector and the atlas
    are built once for a scene and camera and served again while none of
    their tensors is replaced or written in place (``_scene_accel``,
    ``packed_atlas``, ``kernels/_cache.py``; a hit costs no device sync).
    The scene and camera are moved to ``device`` first: ones already there
    keep their tensors and hit; ones on another device (a scene built on the
    CPU and rendered on CUDA, as ``models.workloads`` and the CLI do) are
    copied on every call, built afresh every time and never cached.  A write
    that bypasses PyTorch's version counter (through ``.data`` or a numpy
    view) is not seen; call ``clear_caches()`` after one."""
    dev = resolve_device(device)
    if qcap is not None and qcap != cfg.queue_capacity:
        cfg = dataclasses.replace(cfg, queue_capacity=qcap)
    if cfg.shading not in ("bvh", "materials"):
        raise ValueError(f"unknown shading {cfg.shading!r}")
    if cfg.shading == "materials" and lights is not None:
        raise ValueError("materials shading takes no emissive lights")
    if cfg.show_normals:
        raise ValueError("render_uber has no normals view (show_normals)")
    _camera_statics(camera)
    scene, camera, own = _to_device(scene, camera, dev)
    if lights is not None and lights.bb_min.device != dev:
        lights = lights.to(dev)  # a Lights already there keeps its packed rows
    lts, n_lights = pack_lights(lights)
    # Small scenes: clamp the group size to the capacity — a 3-object scene
    # at gr=64 would sweep 64 rows of which 61 are dead padding.
    gr = min(gr, max(8, -(-scene.capacity // 8) * 8))
    accel, cam = _scene_accel(scene, camera, cfg, gr, cache=own)
    atlas = None if scene.textures is None else packed_atlas(scene.textures, cache=own)
    aa = aa_table(cfg.width, cfg.height, cfg.spp, dev) if cfg.aa_grid else None
    st = UberStatics.from_cfg(cfg, n_lights, camera)
    out, stats = uber_render(accel, cam, st, lts, atlas, aa)
    return _uber_post(out, stats, cfg)


def _uber_post(out, stats, cfg):
    """Epilogue: per-primary (r, g, b, t) in p-linear order ->
    dict(image, depth, counters).  Counters stay tensors (no synchronise)."""
    from raytracing_tests_tpu_torch.ops.render import finalize

    H, W, S = cfg.height, cfg.width, cfg.spp
    colors = out[:, :3].reshape(H, W, S, 3)
    primary_t = out[:, 3].reshape(H, W, S)
    res = finalize(colors, primary_t, cfg)
    res["rays"] = stats[ST_RAYS]
    res["rays_dropped"] = stats[ST_DROPPED]
    return res
