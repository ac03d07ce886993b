"""Work-queue renderer: the whole bounce loop over one write-once ray pool.

Counterpart of the JAX package's ``ops/workqueue.py``:

  - The ray pool is a write-once queue in device memory: primaries occupy
    [0, B); every processed chunk appends its compacted children at the write
    cursor.  The ``read`` and ``write`` cursors, the iteration count and the
    dropped count live on the device (``_Queue.cursors``).
  - One loop drains the queue chunk by chunk.  Because children from
    successive generations land contiguously, small bounce generations
    COALESCE into full chunks, so the sweep kernel sees full batches to the
    end of the frame.

An iteration has static shapes and reads nothing on the host (``_Queue.body``,
the JAX package's ``body``): the chunk is gathered at ``read + arange(C)``
and its live lanes are the first ``write - read``; colour, the emissive
abort and the primary hit distance are scattered with dead lanes sent to a
drop slot; the children are compacted stably (refractions, then
reflections, in lane order) by a prefix sum to ``write``, the invalid ones
to a spill column.  On the card ``REPLAY_K`` iterations are captured as one
CUDA graph and one iteration as another, and the host replays them, reading
the cursors once after each replay: while ``read < write`` at least
``ceil((write - read) / C)`` iterations remain (each consumes at most C
lanes), so the K-graph runs only while that bound is at least K, and no
iteration runs past the queue's end.  With ``graphs=False``, and on the CPU,
the same body runs eagerly under the same rule.

Same ray tree and shading as the queue renderer (``shade_rays``), emissive
lights included; summed radiance identical up to float32 ordering.  Rays are
dropped only on pool overflow (capacity ~3.2x the primary count), and counted.
Materials shading is refused: its records would need the medium stack the
pool does not carry.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from raytracing_tests_tpu_torch.kernels import _build
from raytracing_tests_tpu_torch.ops.render import (
    RenderConfig, _build_accel, _lane_inputs, finalize, shade_rays,
)
from raytracing_tests_tpu_torch.utils.device import resolve_device

DEFAULT_CHUNK = 262144
N_FIELDS = 8  # o(3) d(3) contrib bounced

_PERM_CACHE = {}


def tile_order_perm(width: int, height: int, spp: int, tile: int):
    """Permutation placing lanes in (tile_y, tile_x, y, x, s) order (numpy
    int32).

    A chunk then covers square pixel neighbourhoods instead of full image
    rows, so its rays walk the same groups.  Lane IDS are unchanged — only the
    processing order permutes, and the indexed accumulation is order-blind."""
    key = (width, height, spp, tile)
    if key not in _PERM_CACHE:
        ids = np.arange(width * height * spp, dtype=np.int32).reshape(height, width, spp)
        ph = -(-height // tile) * tile
        pw = -(-width // tile) * tile
        padded = np.full((ph, pw, spp), -1, np.int32)
        padded[:height, :width] = ids
        t = (
            padded.reshape(ph // tile, tile, pw // tile, tile, spp)
            .transpose(0, 2, 1, 3, 4)
            .reshape(-1)
        )
        _PERM_CACHE[key] = t[t >= 0]  # drop pad entries -> exactly B lanes
    return _PERM_CACHE[key]


# Iterations a replay of the long graph runs.
REPLAY_K = 8

# What the last ``render_workqueue`` call did (measurement): replays of each
# graph, host reads of the cursors, seconds spent capturing.
LAST = {}


def _read_cursors(cursors) -> list:
    """The loop's host read: ``[read, write, it]`` as ints."""
    return cursors[:3].tolist()


def _replay_size(read: int, write: int, it: int, chunk: int, max_iters: int, k: int) -> int:
    """Iterations the next replay runs: ``k`` where the queue surely holds
    that many (each iteration consumes at most ``chunk`` lanes) and the budget
    allows them, else 1; 0 once the queue is drained or the budget spent."""
    if read >= write or it >= max_iters:
        return 0
    if k > 1 and -(-(write - read) // chunk) >= k and it + k <= max_iters:
        return k
    return 1


class _Queue:
    """The pool and everything a work-queue iteration reads and writes, on
    the device: ``fields`` (8, P + 1) and ``lane`` (P + 1,) (column P is the
    spill column), ``cursors`` (4,) int64 = read, write, it, dropped;
    ``color`` (3B + 1,) flat rgb planes and ``white``, ``primary_t`` (B + 1,)
    (index 3B / B is the drop slot); ``rays``."""

    def __init__(self, scene, accel, lights, fields, lane, cfg: RenderConfig, chunk: int,
                 n_lanes: int):
        dev = lane.device
        self.scene, self.accel, self.lights, self.cfg = scene, accel, lights, cfg
        self.C, self.B, self.P = chunk, n_lanes, lane.shape[0] - 1
        self.fields, self.lane = fields, lane
        f32 = torch.float32
        self.cursors = torch.tensor([0, n_lanes, 0, 0], dtype=torch.int64, device=dev)
        self.color = torch.zeros((3 * n_lanes + 1,), dtype=f32, device=dev)
        self.white = torch.zeros((n_lanes + 1,), dtype=f32, device=dev)
        self.primary_t = torch.full((n_lanes + 1,), cfg.t_max, dtype=f32, device=dev)
        self.rays = torch.zeros((), dtype=torch.int64, device=dev)
        self.slot = torch.arange(chunk, device=dev)

    def body(self) -> None:
        """One iteration, in place (the JAX package's ``body``)."""
        C, B, P, cfg = self.C, self.B, self.P, self.cfg
        f32 = torch.float32
        read, write = self.cursors[0], self.cursors[1]
        avail = torch.clamp(write - read, 0, C)
        idx = read + self.slot
        f = self.fields.index_select(1, idx)
        l = torch.where(self.slot < avail, self.lane.index_select(0, idx), -1)

        # (C, 3) rows as the queue renderer holds them: the same reductions
        # in the same order, so the two renderers trace the same tree
        o = f[0:3].T.contiguous()
        d = f[3:6].T.contiguous()
        contrib, bounced = f[6], f[7].to(torch.int32)
        active = l >= 0
        sample_idx = (l % cfg.spp).to(f32)
        time_ratio = sample_idx / cfg.spp

        r = shade_rays(self.scene, self.lights, cfg, self.accel, o, d, contrib, bounced,
                       active, sample_idx, time_ratio)

        li = l.long()
        drop = torch.full_like(li, B)
        self.color.index_add_(0, torch.cat([torch.where(active, li + k * B, 3 * drop)
                                            for k in range(3)]),
                              torch.cat([r.add_color[:, 0], r.add_color[:, 1],
                                         r.add_color[:, 2]]))
        if self.lights is not None:
            self.white.index_add_(0, torch.where(active, li, drop), r.set_white.to(f32))
        is_primary = active & (bounced == 0)
        self.primary_t.index_copy_(0, torch.where(is_primary, li, drop), r.hit_t)

        # Children, compacted stably: refractions before reflections, in lane
        # order, from the write cursor on; the invalid ones to the spill column.
        none = torch.full_like(l, -1)
        ch_lane = torch.cat([torch.where(r.refr_mask, l, none),
                             torch.where(r.refl_mask, l, none)])
        bf = r.bounced.to(f32)
        ch = torch.cat([
            torch.cat([r.refr_o.T, r.refr_d.T, r.refr_contrib[None], bf[None]]),
            torch.cat([r.refl_o.T, r.refl_d.T, r.refl_contrib[None], bf[None]]),
        ], dim=1)  # (8, 2C)
        valid = (ch_lane >= 0).to(torch.int64)
        pos = torch.cumsum(valid, 0)
        n_children = pos[-1]
        w = torch.clamp_max(write, P - 2 * C)  # clamp on overflow (drops late rays)
        dest = torch.where(valid > 0, w + pos - 1, P)
        self.fields.index_copy_(1, dest, ch)
        self.lane.index_copy_(0, dest, ch_lane)
        new_write = torch.clamp_max(write + n_children, P - 2 * C)

        self.rays.add_(torch.sum(active))
        self.cursors.add_(torch.stack([avail, new_write - write, torch.ones_like(avail),
                                       write + n_children - new_write]))

    def result(self):
        """(rgb (3, B), primary_t (B,)): a lane whose sample hit an emissive
        object ends white, whatever else its tree added."""
        B = self.B
        rgb = self.color[:3 * B].reshape(3, B)
        rgb = torch.where(self.white[:B] > 0.0, torch.ones_like(rgb), rgb)
        return rgb, self.primary_t[:B]


class _Graphs:
    """``_Queue.body`` captured on the card: ``k`` iterations as one CUDA
    graph and one as another, each captured at its first use, on one memory
    pool, with its launches kept (``_build.LaunchRecord``)."""

    def __init__(self, q: _Queue):
        self.q = q
        self.pool = torch.cuda.graph_pool_handle()
        self.graphs = {}
        self.capture_seconds = 0.0

    def warm_up(self) -> None:
        """One iteration eagerly on a side stream, the warm-up a capture
        wants (PyTorch's graph documentation): the kernels are built and the
        tables derived from the accel made before any capture."""
        dev = self.q.rays.device
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self.q.body()
        torch.cuda.current_stream(dev).wait_stream(side)

    def run(self, n: int) -> None:
        """``n`` iterations: one replay of the graph of ``n``."""
        if n not in self.graphs:
            t0 = time.perf_counter()
            graph, record = torch.cuda.CUDAGraph(), _build.LaunchRecord()
            with record.record(), torch.cuda.graph(graph, pool=self.pool):
                for _ in range(n):
                    self.q.body()
            self.graphs[n] = (graph, record)
            self.capture_seconds += time.perf_counter() - t0
        graph, record = self.graphs[n]
        record.replay(graph)

    def release(self) -> None:
        """Drop the graphs and give their memory back to the card: a dropped
        graph's private pool otherwise stays cached in PyTorch's allocator
        until an allocation runs short and frees every cached block at once,
        which stalls some later launch (``diff.train``'s ``release``)."""
        if self.graphs:
            self.graphs.clear()
            torch.cuda.synchronize(self.q.rays.device)
            torch.cuda.empty_cache()


def _drain_queue(q: _Queue, max_iters: int, graphs: bool, k: Optional[int] = None) -> int:
    """Drain the pool of ``q`` in runs of ``k`` iterations (default
    ``REPLAY_K``) or one (``_replay_size``), the cursors read once after
    each; returns the iterations run.  ``graphs``: each run is a replay of a
    captured CUDA graph (the card; the first iteration, the warm-up, runs
    eagerly), else the body runs eagerly."""
    k = REPLAY_K if k is None else k
    read, write, it = 0, q.B, 0
    replays = {}
    g = _Graphs(q) if graphs else None
    try:
        while (n := _replay_size(read, write, it, q.C, max_iters, k)) > 0:
            if g is None:
                for _ in range(n):
                    q.body()
            elif it == 0:
                g.warm_up()
                n = 1
            else:
                g.run(n)
            replays[n] = replays.get(n, 0) + 1
            read, write, it = _read_cursors(q.cursors)
    finally:
        LAST.update(replays=replays, host_reads=sum(replays.values()),
                    capture_seconds=0.0 if g is None else g.capture_seconds)
        if g is not None:
            g.release()
    return it


def render_workqueue(scene, camera, cfg: RenderConfig, lights=None,
                     chunk: int = DEFAULT_CHUNK, pool_factor: float = 3.2,
                     tile: int = 0, graphs: bool = True, device=None):
    """Full render; dict(image, depth, rays, iterations, rays_dropped).

    ``tile`` > 1 orders the pool by pixel tiles (helps culling at low spp; the
    permutation gather over all lanes is paid up front).  ``graphs``: on the
    card, replay the loop's iterations as captured CUDA graphs (``False``:
    the same body eagerly, which the LBVH intersector always takes: its walk
    reads the host).  ``device=None`` means CUDA (raises when absent);
    ``device="cpu"`` runs on the CPU, eagerly."""
    dev = resolve_device(device)
    if cfg.shading != "bvh":
        raise NotImplementedError(
            "workqueue pool records carry no medium stack; materials shading "
            "runs on the queue renderer (render_stats)")
    graphs = graphs and dev.type == "cuda" and cfg.intersector != "bvh"
    q = _prepare(scene, camera, cfg, lights, chunk, pool_factor, tile, dev)
    H, W, S = cfg.height, cfg.width, cfg.spp
    max_iters = q.P // q.C + 8 * (cfg.max_bounces + 1)
    iters = _drain_queue(q, max_iters, graphs)
    rgb, primary_t = q.result()
    out = finalize(rgb.T.reshape(H, W, S, 3), primary_t.reshape(H, W, S), cfg)
    out["rays"] = q.rays
    out["iterations"] = iters
    out["rays_dropped"] = q.cursors[3]
    return out


def _prepare(scene, camera, cfg: RenderConfig, lights, chunk: int, pool_factor: float,
             tile: int, dev) -> _Queue:
    """The frame's pool on ``dev``: the primaries in [0, B), in tile order
    where ``tile`` > 1."""
    scene, camera = scene.to(dev), camera.to(dev)
    lights = None if lights is None else lights.to(dev)
    H, W, S = cfg.height, cfg.width, cfg.spp
    B = H * W * S
    accel = _build_accel(scene, cfg)
    o, d, _, _ = _lane_inputs(camera, cfg)

    chunk = min(chunk, -(-B // 128) * 128)
    P = max(int(B * pool_factor), B + 4 * chunk)
    P = -(-P // chunk) * chunk

    if tile and tile > 1:
        lane0 = torch.from_numpy(tile_order_perm(W, H, S, tile)).to(dev)
        o, d = o[lane0.long()], d[lane0.long()]
    else:
        lane0 = torch.arange(B, dtype=torch.int32, device=dev)

    fields = torch.zeros((N_FIELDS, P + 1), dtype=torch.float32, device=dev)
    fields[0:3, :B] = o.T
    fields[3:6, :B] = d.T
    fields[6, :B] = 1.0
    del o, d
    lane = torch.full((P + 1,), -1, dtype=torch.int32, device=dev)
    lane[:B] = lane0
    return _Queue(scene, accel, lights, fields, lane, cfg, chunk, B)
