"""Mesh-sharded rendering: image rows over the mesh's shards, scene replicated.

Counterpart of the JAX package's ``parallel/render_sharded.py``.  Shard ``s``
of an ``n``-shard mesh renders the interleaved rows ``{s, s+n, s+2n, ...}``
(``mesh.shard_rows``, the map of ``mesh.row_permutation``); the scene and
its accel are built once and shared by every shard (copied, not rebuilt, to
another device).  No collective runs
in the forward pass of a mesh whose shards are all in this process; under a
process group the finished blocks are gathered (``all_gather``) and the
counters summed (``all_reduce``), what the JAX package's ``shard_map`` output
specs and ``psum`` do.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from raytracing_tests_tpu_torch.ops.render import (
    RenderConfig, _build_accel, _lane_inputs, finalize, trace_lanes,
)
from raytracing_tests_tpu_torch.parallel.mesh import ROWS_AXIS, Mesh, shard_rows
from raytracing_tests_tpu_torch.scene.types import Camera, Scene


def _accel_to(accel, dev):
    """The accel on ``dev``: itself when it is there, else a copy of its
    tables (a ``DiffAccel`` keeps its wrapper)."""
    if accel is None:
        return None
    inner = getattr(accel, "inner", None)
    if inner is not None:
        return accel if inner.device == dev else type(accel)(inner.to(dev))
    return accel if accel.device == dev else accel.to(dev)


def _lights_to(lights, dev):
    # a Lights already there keeps its packed rows (kernels.uber.pack_lights)
    return lights if lights is None or lights.bb_min.device == dev else lights.to(dev)


def _padded(x, h: int, dev):
    """``x`` (k, ...) on ``dev`` with zero rows appended up to ``h``."""
    x = x.to(dev)
    if x.shape[0] < h:
        x = torch.cat([x, x.new_zeros((h - x.shape[0],) + tuple(x.shape[1:]))])
    return x


def _deinterleave(blocks, mesh: Mesh, H: int):
    """Per-shard row blocks -> the frame's rows, on ``mesh.home``.

    ``blocks``: [(shard, x)] of this process's shards, ``x`` (k, ...) holding
    the shard's rows in order, at most ``h = ceil(H / n)`` of them.  Shard s's
    local row i is the frame's row ``i * n + s``; rows past ``H`` (an
    off-frame row or zero padding) are dropped.  Under a process group every
    rank's block is gathered first, so every rank returns the whole frame."""
    n = mesh.shape[ROWS_AXIS]
    h = -(-H // n)
    home = mesh.home
    if mesh.distributed:
        (_, mine), = blocks
        mine = _padded(mine, h, home).contiguous()
        got = [torch.empty_like(mine) for _ in range(n)]
        dist.all_gather(got, mine, group=mesh.group)
        stacked = torch.stack(got)
    else:
        stacked = torch.stack([_padded(x, h, home) for _, x in sorted(blocks, key=lambda b: b[0])])
    return stacked.transpose(0, 1).reshape((h * n,) + tuple(stacked.shape[2:]))[:H]


def _summed(values, mesh: Mesh, dev):
    """Counters summed over this process's shards and, under a process
    group, over the ranks: one int64 tensor (len(values[0]),) on ``dev``."""
    as64 = lambda x: (x.to(dev, torch.int64) if isinstance(x, torch.Tensor)  # noqa: E731
                      else torch.full((), x, dtype=torch.int64, device=dev))
    total = torch.stack([torch.stack([as64(x) for x in v]) for v in values]).sum(0)
    if mesh.distributed:
        dist.all_reduce(total, op=dist.ReduceOp.SUM, group=mesh.group)
    return total


def trace_shards(scene: Scene, camera: Camera, cfg: RenderConfig, mesh: Mesh,
                 lights=None):
    """The queue renderer over this process's shards, real rows only:
    [(shard, colors (k, W, S, 3), primary_t (k, W, S), rays, dropped)] with
    ``k`` the shard's rows below ``H``.

    The primary lanes of the whole frame are made once per device
    (``ops.render._lane_inputs``) and each shard traces its own rows of them
    (``ops.render.trace_lanes``); the accel is built once, on the first
    shard's device.  Differentiable, like ``trace_lanes``: scene tensors that
    require grad carry their graph through every shard."""
    H, W, S = cfg.height, cfg.width, cfg.spp
    n = mesh.shape[ROWS_AXIS]
    accel = None
    per_dev = {}
    out = []
    for shard, dev in mesh.local_shards():
        if dev not in per_dev:
            sc, cam = scene.to(dev), camera.to(dev)
            if accel is None:
                accel = _build_accel(sc, cfg)
            lanes = [x.reshape((H, W * S) + tuple(x.shape[1:])) for x in _lane_inputs(cam, cfg)]
            per_dev[dev] = (sc, _lights_to(lights, dev), _accel_to(accel, dev), lanes)
        sc, lt, acc, lanes = per_dev[dev]
        rows = shard_rows(H, n, shard)
        k = len(rows)
        if k == 0:  # more shards than rows
            out.append((shard, torch.zeros((0, W, S, 3), device=dev),
                        torch.zeros((0, W, S), device=dev), 0, 0))
            continue
        idx = torch.from_numpy(rows).to(dev)
        o, d, tr, sidx = (x[idx].reshape((k * W * S,) + tuple(x.shape[2:])) for x in lanes)
        color, primary_t, rays, dropped = trace_lanes(sc, lt, cfg, o, d, tr, sidx, acc)
        out.append((shard, color.reshape(k, W, S, 3), primary_t.reshape(k, W, S),
                    rays, dropped))
    return out


def render_sharded(scene: Scene, camera: Camera, cfg: RenderConfig, mesh: Mesh,
                   lights=None):
    """Full render by the queue renderer, sharded over ``mesh``'s ``rows``
    axis: dict(image (H, W, 3), depth (H, W), rays, rays_dropped), the
    single-device ``ops.render.render_stats``'s outputs, on ``mesh.home``.

    Each shard traces only its real rows, so no lane of a padding row reaches
    a sweep and ``rays`` counts exactly the single-device render's rays: the
    JAX package's ``psum - (padded - H) * W * S``, which assumes that each of
    its zero-direction padding lanes costs exactly one pop.  (This port
    normalises a zero direction to 0 where JAX gets NaN, so a padding lane
    would not be bound to that cost here; it never exists.)"""
    H = cfg.height
    blocks = trace_shards(scene, camera, cfg, mesh, lights)
    home = mesh.home
    full = _deinterleave([(s, torch.cat([c, t[..., None]], dim=-1)) for s, c, t, _, _ in blocks],
                         mesh, H)
    out = finalize(full[..., :3], full[..., 3], cfg)
    rays, dropped = _summed([(r, dr) for _, _, _, r, dr in blocks], mesh, home).tolist()
    out["rays"] = rays
    out["rays_dropped"] = dropped
    return out


def _uber_shards(scene, camera, cfg, mesh: Mesh, lights=None, gr: int = 32):
    """The persistent kernel once per shard of this process:
    ([(shard, out (h, W, S, 4), stats (ST_LEN,))], h), ``h = ceil(H / n)``
    rows a shard.

    The probe cut and the accel come from ``kernels.uber._scene_accel`` (on
    the first shard's device), the atlas from ``uber.packed_atlas`` a device:
    both cached, so a scene already on that device that ``render_uber`` or an
    earlier call packed is not packed again (a copy made for another device
    is packed afresh and not cached, as in ``render_uber``).  The lights are packed once a
    device.  Each shard's statics render ``h`` rows of the frame's height
    (``UberStatics.rows``: ``1/H``, the aspect and the ``aa_grid`` table stay
    the frame's) and its camera vector maps local row r to ``r * n + shard``
    (``pack_camera(row_stride=n, row0=shard)``)."""
    from raytracing_tests_tpu_torch.kernels import uber

    if cfg.shading not in ("bvh", "materials"):
        raise ValueError(f"unknown shading {cfg.shading!r}")
    if cfg.shading == "materials" and lights is not None:
        raise ValueError("materials shading takes no emissive lights")
    if cfg.show_normals:
        raise ValueError("render_uber has no normals view (show_normals)")
    uber._camera_statics(camera)
    H, W, S = cfg.height, cfg.width, cfg.spp
    n = mesh.shape[ROWS_AXIS]
    h = -(-H // n)
    gr = min(gr, max(8, -(-scene.capacity // 8) * 8))
    accel = None
    per_dev = {}
    out = []
    for shard, dev in mesh.local_shards():
        if dev not in per_dev:
            sc, cam, own = uber._to_device(scene, camera, dev)
            lts, n_lights = uber.pack_lights(_lights_to(lights, dev))
            if accel is None:
                accel, _ = uber._scene_accel(sc, cam, cfg, gr, cache=own)
            atlas = None if sc.textures is None else uber.packed_atlas(sc.textures, cache=own)
            aa = uber.aa_table(W, H, S, dev) if cfg.aa_grid else None
            st = dataclasses.replace(uber.UberStatics.from_cfg(cfg, n_lights, cam), rows=h)
            per_dev[dev] = (cam, _accel_to(accel, dev), lts, atlas, aa, st)
        cam, acc, lts, atlas, aa, st = per_dev[dev]
        cvec = uber.pack_camera(cam, row_stride=float(n), row0=float(shard))
        o, stats = uber.uber_render(acc, cvec, st, lts, atlas, aa)
        out.append((shard, o.reshape(h, W, S, 4), stats))
    return out, h


def render_uber_sharded(scene: Scene, camera: Camera, cfg: RenderConfig, mesh: Mesh,
                        lights=None, gr: int = 32):
    """The persistent kernel sharded over ``mesh``'s ``rows`` axis: one launch
    a shard; dict(image, depth, rays, rays_dropped) on ``mesh.home``.

    Each shard renders the INTERLEAVED rows ``{s, s+n, s+2n, ...}``: the
    affine (stride, offset) row map rides the kernel's camera vector, so each
    shard generates exactly the rays the single-device ``render_uber`` would
    for its rows.  Every shard renders ``ceil(H / n)`` rows; when ``n`` does
    not divide ``H`` the rows past ``H`` render off-frame rays, which count in
    ``rays`` and are dropped from the image, as in the JAX package.  ``rays``
    and ``rays_dropped`` are summed over the shards (tensors, as
    ``render_uber``'s).  The refusals are ``render_uber``'s, and so is ``gr``."""
    from raytracing_tests_tpu_torch.kernels.uber import ST_DROPPED, ST_RAYS

    blocks, _ = _uber_shards(scene, camera, cfg, mesh, lights, gr)
    full = _deinterleave([(s, o) for s, o, _ in blocks], mesh, cfg.height)
    res = finalize(full[..., :3], full[..., 3], cfg)
    stats = _summed([st[[ST_RAYS, ST_DROPPED]] for _, _, st in blocks], mesh, mesh.home)
    res["rays"] = stats[0]
    res["rays_dropped"] = stats[1]
    return res
