"""The In-Next-Week shading model on ray batches, as tensor code.

Counterpart of the device functions of the JAX package's ``kernels/mega.py``
that the persistent kernel inlines: ``_cross_up``, ``_deviate`` and
``_shade_hits`` without lights or textures, for sphere-mode accels
(``sweep2.Accel2``) and generic ones (``sweep2g.Accel2G``).  The CUDA version
of the same arithmetic is ``csrc/rt_common.cuh::shade_hit``; this module is
what the plain version of the persistent kernel (``uber.uber_render_plain``)
runs.  (The chunked megakernel ``mega_step`` itself is not ported yet.)
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from raytracing_tests_tpu_torch.kernels.sweep2 import (
    FT_CB, FT_CR, FT_MRI, FT_REFL, FT_REFR, FT_SRFL, FT_SRFR,
    _dot3, _gather_rows, _ri_probe, _winner_refine,
)
from raytracing_tests_tpu_torch.kernels.sweep2g import (
    _gather_rows_g, _ri_probe_g, _winner_refine_g,
)

# The angle every sunflower lattice turns by, rounded to float32 once.
GOLDEN_ANGLE = float(np.float32(np.pi * (3.0 - np.sqrt(5.0))))


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


@dataclasses.dataclass
class Shaded:
    """What shading one batch of nodes produces: colour to accumulate, the
    hit distance (t_max convention on a miss) and the two children."""

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


def _shade_hits(accel, o, d, contrib, bounced, active, sidx, t_best,
                obj, hit, bg, *, has_dielectrics: bool, spp: int,
                max_bounces: int, t_max: float, trig) -> Shaded:
    """Winner row + refine + surrounding-RI + INW shading + child-ray
    construction for a batch of nodes (hits and misses alike: ``hit`` masks)."""
    generic = accel.mode == "generic"
    if generic:
        rows = _gather_rows_g(accel, obj)
        t_best, _, p, n, _ = _winner_refine_g(rows, o, d, t_best, hit)
    else:
        rows = _gather_rows(accel, obj)
        t_best, _, p, n = _winner_refine(rows, o, d, t_best, hit)

    did_hit = hit
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
        sur_ri = (_ri_probe_g if generic else _ri_probe)(accel, p + 1e-3 * n)
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
    add = add + hit_c[:, None] * rows[:, FT_CR:FT_CB + 1]

    hit_t = torch.where(hit, t_best, torch.full_like(t_best, t_max))
    return Shaded(
        add=add, hit_t=hit_t,
        refr_o=p - 1e-4 * n_out, refr_d=cd, refr_contrib=contrib * refrv,
        refl_o=p + 1e-4 * n_out, refl_d=cl, refl_contrib=contrib * reflv,
        spawn_refr=spawn_refr, spawn_refl=spawn_refl, bounced=bounced1,
    )
