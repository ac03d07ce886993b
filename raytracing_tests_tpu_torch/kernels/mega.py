"""The chunked megakernel: one fused trace-and-shade step over a pool of
lanes, and the In-Next-Week shading model it shares with the persistent
kernel.

Counterpart of the JAX package's ``kernels/mega.py``.  ``mega_step`` takes a
``(16, C)`` pool of ray records and the lane ids and returns, per lane, the
colour to add, the hit distance and both children as pool records: nearest
hit over the grouped sphere tables, winner row, exact re-solve, surrounding
refractive index, shading.  The lane-aligned drain ``ops.megalanes`` calls it
once per iteration.  The kernel is hand-written CUDA (``csrc/mega.cu``);
``mega_step_plain`` is the same function in plain PyTorch.  ``mega_step`` uses
the plain version only for tensors that lie on the CPU; for CUDA tensors it
launches the kernel or raises.  The kernel gathers each warp's live lanes into
dense passes and sweeps them with the warp sweep of ``csrc/warp_sweep.cuh``
(per lane where at least ``COOP_MIN`` lanes of a pass entered a group,
row-parallel where fewer did); the result does not depend on the schedule.

Pool record layout (16 rows x lanes, float32): rows 0-2 origin, 3-5 direction,
6 ``omt`` (1 - time_ratio), 7 ``t_limit``, 8 contribution, 9 bounce count,
10-15 spare (zero).

The shading functions serve sphere-mode accels (``sweep2.Accel2``) and
generic ones (``sweep2g.Accel2G``), and the plain version of the persistent
kernel (``uber.uber_render_plain``) runs them too: ``_shade_hits`` (the
In-Next-Week model, with ``_cross_up`` and ``_deviate``; CUDA:
``csrc/rt_common.cuh::shade_hit``), its emissive lights (``_shadow_factor_k``;
CUDA: ``csrc/warp_sweep.cuh::warp_shadow_factor``) and the Shirley-materials
model ``_shade_materials_k`` with ``_fibonacci_hemisphere_k`` (CUDA:
``rt_common.cuh::shade_materials``).  No textures.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from raytracing_tests_tpu_torch.kernels import _build
from raytracing_tests_tpu_torch.kernels.sweep2 import (
    FT_CB, FT_CR, FT_EMIS, FT_MRI, FT_REFL, FT_REFR, FT_SRFL, FT_SRFR, FT_TEX, PROBE_GR,
    Accel2, _check_tensor, _dot3, _gather_rows, _ri_probe, _sweep_plain,
    _winner_refine, check_accel, live_rows,
)
from raytracing_tests_tpu_torch.kernels.sweep2g import (
    _gather_rows_g, _ri_probe_g, _sweep_plain_g, _winner_refine_g,
)
from raytracing_tests_tpu_torch.kernels.texture import texture_color

# The angle every sunflower lattice turns by, rounded to float32 once.
GOLDEN_ANGLE = float(np.float32(np.pi * (3.0 - np.sqrt(5.0))))

# Pool record rows.
(P_OX, P_OY, P_OZ, P_DX, P_DY, P_DZ, P_OMT, P_TLIM, P_CONTRIB,
 P_BOUNCED) = range(10)
POOL_ROWS = 16
MISC_ROWS = 8  # add_r add_g add_b hit_t, four spare
# Work counters of csrc/mega.cu (MS_* there): live lanes, gr per group a live
# lane entered, lanes that hit, lanes whose surrounding RI was probed, active
# lanes; the rows each lane's own walk tested (to its groups' last live rows),
# 32 x the row iterations the dense passes issued (SIMT efficiency =
# MS_ROW_TESTS / MS_LANE_SLOTS), row-parallel group visits, dense passes
# (their fill = MS_LIVE / (32 x MS_PASSES)).
(MS_LIVE, MS_TESTS, MS_HITS, MS_PROBES, MS_ACTIVE, MS_ROW_TESTS, MS_LANE_SLOTS,
 MS_COOP_VISITS, MS_PASSES, MS_LEN) = range(10)
# A culling group that fewer than this many lanes of a dense pass entered is
# swept row-parallel, and the surrounding RI is probed row-parallel where
# fewer lanes need it (the fastest of 1..33 on a natural megalanes frame of
# the headline, PERF.md); ``_build.forced_coop_min`` pins another for tests
# and measurement.
COOP_MIN = 8
# Host parameter vector of csrc/mega.cu (IP_* there).
_IP = ("spp", "has_dielectrics", "n_groups", "gr", "n_pgroups", "probe_gr",
       "has_motion", "coop_min")


def sunflower_statics(spp: int):
    """(n, b, denom) of the sunflower lattice for ``spp`` samples: the
    outermost ``b ~ 2 sqrt(n)`` samples sit on the rim."""
    n = float(spp)
    b = float(np.round(2.0 * np.sqrt(n)))
    denom = n - (b + 1.0) / 2.0
    return n, b, (denom if denom > 0 else 1.0)


def _cross_up(d):
    """cross(d, (0,1,0)) and cross(that, d) for (B, 3) directions."""
    dx, dy, dz = d[:, 0], d[:, 1], d[:, 2]
    rx, ry, rz = -dz, torch.zeros_like(dy), dx
    ux = ry * dz - rz * dy
    uy = rz * dx - rx * dz
    uz = rx * dy - ry * dx
    return torch.stack([rx, ry, rz], dim=1), torch.stack([ux, uy, uz], dim=1)


def _deviate(d, sidx, spp: int, tan_theta, trig):
    """``sampling.deviate_within_cone`` with carried trig: sunflower offset in
    the plane of cross(d, up) x cross(., d), scaled by the reference's 0.1.

    ``trig``: (cos th, sin th) for th = GOLDEN_ANGLE * sidx — the same angle
    for a primary's whole ray tree, so it is computed once at ray generation."""
    n, b, denom = sunflower_statics(spp)
    half = tan_theta  # aperture = 2*tan_theta -> half = tan_theta
    r = torch.where(
        sidx > n - b, half,
        half * torch.sqrt(torch.clamp_min(sidx - 0.5, 0.0) / denom))
    r = torch.where(sidx == 0.0, torch.zeros_like(r), r)
    offx = (r * trig[0])[:, None]
    offy = (r * trig[1])[:, None]
    right, up = _cross_up(d)
    v = d + 0.1 * (offx * right + offy * up)
    inv = torch.rsqrt(torch.clamp_min(_dot3(v, v), 1e-38))
    return v * inv[:, None]


def _norm3(v, eps):
    """v / sqrt(max(|v|^2, eps)) for (B, 3) vectors, the sum in x, y, z order."""
    return v / torch.sqrt(torch.clamp_min(_dot3(v, v), max(eps, 1e-38)))[:, None]


def _cross3(a, b):
    ax, ay, az = a[:, 0], a[:, 1], a[:, 2]
    bx, by, bz = b[:, 0], b[:, 1], b[:, 2]
    return torch.stack([ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], dim=1)


def _fibonacci_hemisphere_k(sidx, spp: int, s, f, trig):
    """``sampling.fibonacci_hemisphere`` with carried trig: deterministic
    scatter of the unit direction ``f`` (B, 3) on a fibonacci sphere of
    radius ``s`` centred at its tip.  ``trig``: (cos th, sin th) of
    th = GOLDEN_ANGLE * sidx (see ``_deviate``)."""
    n = float(spp)
    y = 1.0 - sidx / max(n - 1.0, 1.0)
    radius = torch.sqrt(torch.clamp_min(1.0 - y * y, 0.0))
    x = trig[0] * radius
    z = trig[1] * radius
    x, y, z = x * s, y * s, z * s
    # z_cap = normalize(cross(up, f)) with up = (0, 1, 0): (fz, 0, -fx)
    zc = _norm3(torch.stack([f[:, 2], torch.zeros_like(f[:, 0]), -f[:, 0]], dim=1), 1e-20)
    xc = _norm3(_cross3(f, zc), 1e-20)
    pt = f + x[:, None] * xc + y[:, None] * f + z[:, None] * zc
    return _norm3(pt, 1e-38)


def _shadow_factor_k(accel, p, n, omt, sidx, did_hit, lights, spp: int):
    """Fraction of the lights visible from the hit points ``p`` (B, 3) with
    outward normals ``n``: one occlusion sweep per light, from p + 1e-4 n
    toward a per-sample point inside the light's AABB, limited to the
    distance to the box's centre plus its diagonal; the light counts where the
    nearest occluder is an emissive object.  ``lights``: (n_lights, 8) rows
    of ``uber.pack_lights`` (bb_min xyz, bb_max xyz, diagonal, 0).  Lanes
    without ``did_hit`` sweep a dead ray.  Generic accels sweep with their
    super-groups, as the primary sweep does."""
    generic = accel.mode == "generic"
    if omt is None:  # a static accel reads no time
        omt = torch.zeros_like(sidx)
    sratio = sidx * (1.0 / spp)
    so = p + 1e-4 * n
    zero = torch.zeros_like(so)
    lit = torch.zeros_like(sidx)
    for row in lights:
        mn, mx, diag = row[0:3], row[3:6], row[6]
        target = mn + (mx - mn) * sratio[:, None]
        dd = target - so
        dd = dd / torch.sqrt(torch.clamp_min(_dot3(dd, dd), 1e-38))[:, None]
        dd = torch.where(did_hit[:, None], dd, zero)
        e = (mn + mx) * 0.5 - so
        tlim = torch.sqrt(torch.clamp_min(_dot3(e, e), 0.0)) + diag
        if generic:
            _, obj = _sweep_plain_g(accel, so, dd, omt, did_hit, tlim)
            rows = _gather_rows_g(accel, obj)
        else:
            _, obj = _sweep_plain(accel, so, dd, did_hit, tlim, omt)
            rows = _gather_rows(accel, obj)
        lit = lit + ((obj >= 0) & (rows[:, FT_EMIS] > 0.5)).to(lit.dtype)
    return lit * (1.0 / lights.shape[0])


@dataclasses.dataclass
class Shaded:
    """What shading one batch of nodes produces: colour to accumulate, the
    hit distance (t_max convention on a miss) and the two children; under
    emissive lights the nodes that paint their sample white, under materials
    shading the children's media."""

    add: torch.Tensor  # (B, 3)
    hit_t: torch.Tensor  # (B,)
    refr_o: torch.Tensor  # (B, 3) refraction child
    refr_d: torch.Tensor
    refr_contrib: torch.Tensor  # (B,)
    refl_o: torch.Tensor  # (B, 3) reflection child
    refl_d: torch.Tensor
    refl_contrib: torch.Tensor
    spawn_refr: torch.Tensor  # (B,) bool
    spawn_refl: torch.Tensor
    bounced: torch.Tensor  # (B,) child bounce count
    white: torch.Tensor = None  # (B,) bool: hit an emissive object
    refr_medium: torch.Tensor = None  # (B,) materials shading only
    refr_parent: torch.Tensor = None
    refl_medium: torch.Tensor = None
    refl_parent: torch.Tensor = None


def _refine(accel, o, d, t_best, obj, hit, omt):
    """The winners' ftab rows and their refine -> (rows, t_best, p, n, omt,
    lp): ``lp`` the unit-space hit position (the normal for spheres); the
    accel's own ``omt`` rule (None unless it moves, required if it does)."""
    if not accel.has_motion:
        omt = None
    elif omt is None:
        raise ValueError("a moving accel needs omt = 1 - time_ratio per ray")
    if accel.mode == "generic":
        rows = _gather_rows_g(accel, obj)
        t_best, _, p, n, lp = _winner_refine_g(rows, o, d, t_best, hit, omt)
    else:
        rows = _gather_rows(accel, obj)
        t_best, _, p, n = _winner_refine(rows, o, d, t_best, hit, omt)
        lp = n
    return rows, t_best, p, n, omt, lp


def _albedo(rows, lp, texels):
    """The winners' albedo (B, 3): textured by ``texture.texture_color``
    where a winner carries a texture index and ``texels`` (``pack_atlas``)
    are given."""
    color = rows[:, FT_CR:FT_CB + 1]
    if texels is None:
        return color
    return texture_color(color, torch.round(rows[:, FT_TEX]).to(torch.int64), lp, texels)


def _shade_hits(accel, o, d, contrib, bounced, active, sidx, t_best,
                obj, hit, bg, *, has_dielectrics: bool, spp: int,
                max_bounces: int, t_max: float, trig, omt=None,
                lights=None, texels=None) -> Shaded:
    """Winner row + refine + surrounding-RI + INW shading + child-ray
    construction for a batch of nodes (hits and misses alike: ``hit`` masks).
    ``omt`` (B,) = 1 - time_ratio, read only by a moving accel.  ``lights``
    ((n_lights, 8), ``uber.pack_lights``): a hit on an emissive object paints
    its sample white (``Shaded.white``) and spawns nothing; every other hit's
    contribution is scaled by the fraction of lights it sees.  ``texels``
    (``texture.pack_atlas``): the albedo of a textured winner is textured."""
    generic = accel.mode == "generic"
    rows, t_best, p, n, omt, lp = _refine(accel, o, d, t_best, obj, hit, omt)

    did_hit = hit
    white = None
    if lights is not None:
        white = hit & (rows[:, FT_EMIS] > 0.5)
        did_hit = hit & ~white
        lit = _shadow_factor_k(accel, p, n, omt, sidx, did_hit, lights, spp)
        contrib = torch.where(did_hit, contrib * lit, contrib)
    missed = active & ~hit
    miss_c = torch.where(missed, contrib, torch.zeros_like(contrib))
    add = miss_c[:, None] * bg

    mat_ri = rows[:, FT_MRI]
    refrv = rows[:, FT_REFR]
    reflv = rows[:, FT_REFL]
    srfr = rows[:, FT_SRFR]
    srfl = rows[:, FT_SRFL]

    ndotd = _dot3(n, d)
    inner = ndotd > 0.0

    if has_dielectrics and accel.n_pgroups > 0:
        sur_ri = (_ri_probe_g if generic else _ri_probe)(accel, p + 1e-3 * n, omt)
    else:
        sur_ri = torch.ones_like(contrib)

    bounced1 = bounced + 1.0
    can_spawn = (((reflv > 0.002) | (refrv > 0.002)) & (contrib > 0.01)
                 & (bounced1 < float(max_bounces)) & did_hit)

    # Outer reflection: mirror + cone deviation.
    mirror = d - 2.0 * ndotd[:, None] * n
    rinv = torch.rsqrt(torch.clamp_min(_dot3(mirror, mirror), 1e-38))
    rl = mirror * rinv[:, None]
    rl = torch.where((srfl > 0.001)[:, None],
                     _deviate(rl, sidx, spp, srfl, trig), rl)

    # Outer refraction: eta = sur/mat.
    eta_o = sur_ri / torch.clamp_min(mat_ri, 1e-6)
    cos_i = -ndotd  # > 0 for outer hits
    k_o = 1.0 - eta_o * eta_o * (1.0 - cos_i * cos_i)
    sqk_o = torch.sqrt(torch.clamp_min(k_o, 0.0))
    rf = eta_o[:, None] * d + (eta_o * cos_i - sqk_o)[:, None] * n
    finv = torch.rsqrt(torch.clamp_min(_dot3(rf, rf), 1e-38))
    rf = rf * finv[:, None]
    rf = torch.where(((srfr > 0.001) & (k_o > 0.0))[:, None],
                     _deviate(rf, sidx, spp, srfr, trig), rf)
    refr_ok_o = k_o > 0.0

    # Inner hit: flip normal, eta = mat/sur; TIR reflects.
    eta_i = mat_ri / torch.clamp_min(sur_ri, 1e-6)
    cos_ii = ndotd  # = -(d . n_in), > 0 for inner hits
    k_i = 1.0 - eta_i * eta_i * (1.0 - cos_ii * cos_ii)
    sqk_i = torch.sqrt(torch.clamp_min(k_i, 0.0))
    inf_ = eta_i[:, None] * d - (eta_i * cos_ii - sqk_i)[:, None] * n
    tir = k_i <= 0.0

    spawn_refr = can_spawn & ((inner & ~tir)
                              | (~inner & refr_ok_o & (refrv > 0.002)))
    spawn_refl = can_spawn & ((inner & tir) | (~inner & (reflv > 0.002)))
    inner3 = inner[:, None]
    cd = torch.where(inner3, inf_, rf)
    cl = torch.where(inner3, mirror, rl)  # inner TIR = mirror about n_in
    n_out = torch.where(inner3, -n, n)  # outward-facing normal

    zero = torch.zeros_like(contrib)
    fwd = torch.where(spawn_refr, refrv, zero) + torch.where(spawn_refl, reflv, zero)
    contrib_post = contrib * (1.0 - 0.5 * fwd)
    hit_c = torch.where(did_hit, contrib_post, zero)
    add = add + hit_c[:, None] * _albedo(rows, lp, texels)

    hit_t = torch.where(hit, t_best, torch.full_like(t_best, t_max))
    return Shaded(
        add=add, hit_t=hit_t,
        refr_o=p - 1e-4 * n_out, refr_d=cd, refr_contrib=contrib * refrv,
        refl_o=p + 1e-4 * n_out, refl_d=cl, refl_contrib=contrib * reflv,
        spawn_refr=spawn_refr, spawn_refl=spawn_refl, bounced=bounced1, white=white,
    )


def _shade_materials_k(accel, o, d, contrib, bounced, active, sidx, t_best,
                       obj, hit, bg, medium, parent, *, spp: int,
                       max_bounces: int, t_max: float, trig, omt=None,
                       texels=None) -> Shaded:
    """``ops.render._shade_materials`` for a batch of nodes, in the
    persistent kernel's arithmetic: the Shirley-materials model with the
    per-ray medium RI (``medium``, ``parent`` (B,)), Schlick contribution
    shift, fibonacci-hemisphere scatter, total internal reflection turned
    into a contribution-1 reflection, the ``contrib^2 * albedo`` local term,
    no surrounding-RI probe and no contribution cutoff.  The children carry
    their media in ``Shaded``'s ``refr_*`` / ``refl_*`` fields; ``texels``
    as ``_shade_hits`` takes them."""
    rows, t_best, p, n, _, lp = _refine(accel, o, d, t_best, obj, hit, omt)
    zero = torch.zeros_like(contrib)
    missed = active & ~hit
    mat_ri = rows[:, FT_MRI]
    refrv = rows[:, FT_REFR]
    reflv = rows[:, FT_REFL]
    srfr = rows[:, FT_SRFR]
    srfl = rows[:, FT_SRFL]

    cos_theta = _dot3(n, d)
    inner = cos_theta > 0.0
    sin_theta = torch.sqrt(torch.clamp_min(1.0 - cos_theta * cos_theta, 0.0))
    target = torch.where(inner, parent, mat_ri)
    ratio = medium / torch.clamp_min(target, 1e-6)
    ratio_sin = ratio * sin_theta
    tir = ratio_sin > 1.0

    # Schlick shift from refraction to reflection on outer hits.
    r0 = (1.0 - ratio) / (1.0 + ratio)
    r0 = r0 * r0
    om = 1.0 - torch.clamp(-cos_theta, 0.0, 1.0)
    schl = r0 + (1.0 - r0) * om * om * om * om * om
    shift = torch.where(~inner, refrv * schl, zero)
    refr_c = refrv - shift
    refl_c = reflv + shift
    refl_c = torch.where(tir, torch.ones_like(refl_c), torch.where(inner, zero, refl_c))

    # Grazing-reflection lift.
    inner3 = inner[:, None]
    n_in = torch.where(inner3, -n, n)  # toward the incident side
    mirror = d - (2.0 * cos_theta)[:, None] * n
    n2ir = _norm3(_cross3(n_in, d), 1e-20)
    n2n = _norm3(_cross3(n2ir, n_in), 1e-20)
    s = torch.where(inner, srfr, srfl)
    inv = 1.0 / torch.sqrt(1.0 + s * s)
    max_refl = (s * inv)[:, None] * n_in + inv[:, None] * n2n
    lift = _dot3(mirror, n_in) <= _dot3(max_refl, n_in)
    rbase = torch.where((lift & ~inner)[:, None], max_refl, mirror)
    rd = _fibonacci_hemisphere_k(sidx, spp, srfl, rbase, trig)
    rd = torch.where((tir & inner)[:, None], rbase, rd)
    bounced1 = bounced + 1.0
    depth_ok = bounced1 < float(max_bounces)
    spawn_refl = hit & depth_ok & (~inner | tir) & (contrib * refl_c > 0.0)

    # Refraction; n2 is the opposite of n_in.
    n2 = -n_in
    xc = d - n2 * cos_theta[:, None]
    sq = torch.sqrt(torch.clamp_min(1.0 - ratio_sin * ratio_sin, 0.0))
    fbase = _norm3(ratio_sin[:, None] * n2 + sq[:, None] * xc, 1e-20)
    fd = _fibonacci_hemisphere_k(sidx, spp, srfr, fbase, trig)
    spawn_refr = hit & depth_ok & ~tir & (contrib * refr_c > 0.0)

    add = torch.where(missed, contrib, zero)[:, None] * bg
    hit_c = torch.where(hit, contrib * contrib, zero)
    add = add + hit_c[:, None] * _albedo(rows, lp, texels)
    hit_t = torch.where(hit, t_best, torch.full_like(t_best, t_max))
    return Shaded(
        add=add, hit_t=hit_t,
        refr_o=p + 1e-4 * n2, refr_d=fd, refr_contrib=contrib * refr_c,
        refl_o=p - 1e-4 * n2, refl_d=rd, refl_contrib=contrib * refl_c,
        spawn_refr=spawn_refr, spawn_refl=spawn_refl, bounced=bounced1,
        refr_medium=target, refr_parent=torch.where(inner, torch.ones_like(medium), medium),
        refl_medium=medium, refl_parent=parent,
    )


# ---------------------------------------------------------------------------
# The chunked megakernel
# ---------------------------------------------------------------------------


def _check_step(accel, pool, lane, spp: int):
    if not isinstance(accel, Accel2):
        raise TypeError("mega_step takes a sphere-mode accel (sweep2.Accel2)")
    if pool.dim() != 2:
        raise ValueError(f"pool: shape {tuple(pool.shape)}, expected ({POOL_ROWS}, C)")
    C = pool.shape[1]
    dev = pool.device
    _check_tensor("pool", pool, torch.float32, (POOL_ROWS, C), dev)
    _check_tensor("lane", lane, torch.int32, (C,), dev)
    check_accel(accel, dev)
    if spp < 1:
        raise ValueError(f"spp = {spp}")
    return C, dev


def mega_step_plain(accel: Accel2, pool, lane, *, has_dielectrics: bool,
                    spp: int, max_bounces: int, t_max: float, bg):
    """Plain PyTorch version of the kernel: see ``mega_step``."""
    C, dev = _check_step(accel, pool, lane, spp)
    f32 = torch.float32
    o = pool[P_OX:P_OZ + 1].T
    d = pool[P_DX:P_DZ + 1].T
    omt, tlim = pool[P_OMT], pool[P_TLIM]
    contrib, bounced = pool[P_CONTRIB], pool[P_BOUNCED]
    active = lane >= 0
    ln = lane.clamp_min(0)
    sidx = (ln - torch.div(ln, spp, rounding_mode="floor") * spp).to(f32)
    live = (_dot3(d, d) > 0.5) & active  # dead rays carry d = 0
    t_best, obj = _sweep_plain(accel, o, d, live, tlim, omt)
    hit = (obj >= 0) & active
    bottom = torch.tensor(bg[0], dtype=f32, device=dev)
    top = torch.tensor(bg[1], dtype=f32, device=dev)
    tt = ((d[:, 1] + 1.0) * 0.5)[:, None]
    th = GOLDEN_ANGLE * sidx
    sh = _shade_hits(
        accel, o, d, contrib, bounced, active, sidx, t_best, obj, hit,
        (1.0 - tt) * bottom + tt * top, has_dielectrics=has_dielectrics,
        spp=spp, max_bounces=max_bounces, t_max=t_max,
        trig=(torch.cos(th), torch.sin(th)), omt=omt)

    zero = torch.zeros(C, dtype=f32, device=dev)
    misc = torch.stack([sh.add[:, 0], sh.add[:, 1], sh.add[:, 2], sh.hit_t,
                        zero, zero, zero, zero])
    tmax_row = torch.full((C,), t_max, dtype=f32, device=dev)

    def record(co, cd, cc):
        # A lane that hits nothing spawns nothing: its children carry a dead
        # ray (selected, never multiplied: the unselected arithmetic ran on a
        # zero row).
        co = torch.where(hit[:, None], co, torch.zeros_like(co))
        cd = torch.where(hit[:, None], cd, torch.zeros_like(cd))
        cc = torch.where(hit, cc, zero)
        return torch.stack([co[:, 0], co[:, 1], co[:, 2], cd[:, 0], cd[:, 1], cd[:, 2],
                            omt, tmax_row, cc, sh.bounced,
                            zero, zero, zero, zero, zero, zero])

    none = torch.full_like(lane, -1)
    return (misc, record(sh.refr_o, sh.refr_d, sh.refr_contrib),
            record(sh.refl_o, sh.refl_d, sh.refl_contrib),
            torch.where(sh.spawn_refr, lane, none),
            torch.where(sh.spawn_refl, lane, none))


def _launch_mega(accel: Accel2, pool, lane, *, has_dielectrics: bool, spp: int,
                 max_bounces: int, t_max: float, bg, stats=None):
    """Check the arguments and launch ``csrc/mega.cu`` ->
    (misc, refr, refl, rlane, llane)."""
    C, dev = _check_step(accel, pool, lane, spp)
    if stats is not None:
        _check_tensor("stats", stats, torch.int64, (MS_LEN,), dev)
    _build.check_device(dev)
    fn = _build.load("mega").rt_mega_step
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, ctypes.POINTER(ctypes.c_int),
                       ctypes.POINTER(ctypes.c_float), p, p, i, p, p, p, p, p, p, p, p]
        fn.restype = ctypes.c_int
    ints = dict(spp=spp, has_dielectrics=int(has_dielectrics),
                n_groups=accel.n_groups, gr=accel.gr, n_pgroups=accel.n_pgroups,
                probe_gr=PROBE_GR, has_motion=int(accel.has_motion),
                coop_min=_build.coop_min(COOP_MIN))
    ip = (ctypes.c_int * len(_IP))(*[ints[k] for k in _IP])
    n, b, denom = sunflower_statics(spp)
    floats = [t_max, GOLDEN_ANGLE, n, n - b, denom, float(max_bounces),
              *bg[0], *bg[1]]
    fp = (ctypes.c_float * len(floats))(*floats)
    f32 = torch.float32
    misc = torch.empty((MISC_ROWS, C), dtype=f32, device=dev)
    refr = torch.empty((POOL_ROWS, C), dtype=f32, device=dev)
    refl = torch.empty((POOL_ROWS, C), dtype=f32, device=dev)
    rlane = torch.empty((C,), dtype=torch.int32, device=dev)
    llane = torch.empty((C,), dtype=torch.int32, device=dev)
    cursor = torch.empty((1,), dtype=torch.int32, device=dev)  # zeroed by the launch
    code = fn(accel.otab.data_ptr(), accel.ftab.data_ptr(), accel.gaabb.data_ptr(),
              live_rows(accel).data_ptr(), ip, fp, pool.data_ptr(), lane.data_ptr(), C,
              misc.data_ptr(), refr.data_ptr(), refl.data_ptr(), rlane.data_ptr(),
              llane.data_ptr(), cursor.data_ptr(),
              stats.data_ptr() if stats is not None else None,
              _build.stream_of(dev))
    _build.check(code, "rt_mega_step")
    _build.LAUNCHES["mega_step_m" if accel.has_motion else "mega_step"] += 1
    return misc, refr, refl, rlane, llane


def mega_step(accel: Accel2, pool, lane, *, has_dielectrics: bool, spp: int,
              max_bounces: int, t_max: float, bg, stats=None):
    """One fused trace-and-shade step over a ``(16, C)`` pool of ray records.

    ``lane`` (C,) int32 holds each record's lane id (pixel * spp + sample),
    negative where the lane is inactive; ``bg`` = (bottom rgb, top rgb) of the
    sky gradient.  Group size, probe groups and motion come from the accel.
    Returns ``(misc (8, C), refr (16, C), refl (16, C), rlane (C,), llane
    (C,))``: misc rows are ``[add_r, add_g, add_b, hit_t, 0, 0, 0, 0]`` (an
    inactive lane adds 0 and reports ``t_max``; an active lane that misses,
    a dead one with d = 0 included, adds contribution x sky); ``refr`` /
    ``refl`` are the refraction / reflection child as pool records (the
    parent's ``omt``, ``t_max``, bounce count + 1, rows 10-15 zero; a dead ray
    where the lane hit nothing); ``rlane`` / ``llane`` are ``lane`` where that
    child spawns, else -1.

    CPU tensors go through ``mega_step_plain``; CUDA tensors launch the kernel
    of ``csrc/mega.cu`` on the current stream (or raise), in its static or
    its motion instantiation by ``accel.has_motion`` (counted as ``mega_step``
    and ``mega_step_m``).  ``stats``: optional
    zeroed int64[MS_LEN] CUDA tensor that gains the kernel's work counters
    (measurement only)."""
    kw = dict(has_dielectrics=has_dielectrics, spp=spp, max_bounces=max_bounces,
              t_max=t_max, bg=bg)
    if pool.device.type == "cpu":
        if accel.device.type != "cpu":
            raise ValueError("pool on the CPU but accel on " + str(accel.device))
        return mega_step_plain(accel, pool, lane, **kw)
    with torch.cuda.device(pool.device):
        return _launch_mega(accel, pool, lane, stats=stats, **kw)
