"""Multi-process entry, and the scaling and load-balance harness.

Counterpart of the JAX package's ``parallel/multihost.py``.
``initialize_multihost`` brings up ``torch.distributed`` (NCCL on CUDA, gloo
on the CPU), after which ``parallel.make_mesh()`` spans the group's ranks,
one shard a process.  Each process runs the same program; the renders gather
the full frame on every rank, and the gradient step all-reduces the
parameters' gradients (``diff.train``).

``measure_rays_per_s`` / ``scaling_report`` time the sharded renderers on
meshes of several sizes; ``shard_iteration_counts`` /
``load_imbalance_report`` give the deterministic per-shard work of the
interleaved row map, which one device can measure for any shard count.
"""

from __future__ import annotations

import os
import time
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from raytracing_tests_tpu_torch.ops.render import RenderConfig
from raytracing_tests_tpu_torch.parallel.mesh import make_mesh
from raytracing_tests_tpu_torch.parallel.render_sharded import (
    _uber_shards, render_sharded, render_uber_sharded,
)
from raytracing_tests_tpu_torch.utils.device import resolve_device


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         device=None) -> int:
    """Bring up ``torch.distributed`` and return this process's rank.

    A no-op (returning the rank) when a group is already up, and (returning
    0) in a single-process environment: no address, no process count and no
    ``WORLD_SIZE`` in the environment.  ``coordinator_address``: ``host:port``
    (read as ``tcp://``) or a URL (``tcp://``, ``file://``); without one the
    group reads ``env://`` (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``,
    ``WORLD_SIZE``).  ``device=None`` means CUDA: the NCCL backend, each
    process on ``cuda:LOCAL_RANK`` (else ``rank % device_count``), and this
    raises without CUDA; ``device="cpu"`` takes gloo."""
    if dist.is_initialized():
        return dist.get_rank()
    if coordinator_address is None and num_processes is None \
            and "WORLD_SIZE" not in os.environ:
        return 0
    dev = resolve_device(device)
    if coordinator_address is None:
        init = "env://"
    elif "://" in coordinator_address:
        init = coordinator_address
    else:
        init = f"tcp://{coordinator_address}"
    kw = {}
    if num_processes is not None:
        kw["world_size"] = int(num_processes)
    if process_id is not None:
        kw["rank"] = int(process_id)
    if dev.type == "cuda":
        rank = int(process_id if process_id is not None else os.environ.get("RANK", 0))
        local = int(os.environ.get("LOCAL_RANK", rank % torch.cuda.device_count()))
        torch.cuda.set_device(local)
        dist.init_process_group("nccl", init_method=init, **kw)
    else:
        dist.init_process_group("gloo", init_method=init, **kw)
    return dist.get_rank()


def _synchronize(out, mesh):
    for _, dev in mesh.local_shards():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    return int(out["rays"])


def measure_rays_per_s(scene, camera, cfg: RenderConfig, n_devices: int, iters: int = 3,
                       renderer: str = "queue", devices=None) -> float:
    """Wall-clock rays/s of the row-sharded renderer on an ``n_devices`` mesh
    (``make_mesh(n_devices, devices)``): one warm frame, then the mean of
    ``iters`` frames, each ended by a synchronise.

    The numerator is the renderer's own traced-ray counter (primary and
    secondary rays processed), the one ``render_stats`` reports.
    ``renderer="uber"`` times ``render_uber_sharded`` (``cfg`` with
    ``intersector="pallas"``), else the queue renderer ``render_sharded``."""
    mesh = make_mesh(n_devices, devices)
    if renderer == "uber":
        fn = lambda: render_uber_sharded(scene, camera, cfg, mesh)
    elif renderer == "queue":
        fn = lambda: render_sharded(scene, camera, cfg, mesh)
    else:
        raise ValueError(f"renderer is 'queue' or 'uber', not {renderer!r}")
    rays = _synchronize(fn(), mesh)
    t0 = time.perf_counter()
    for _ in range(iters):
        _synchronize(fn(), mesh)
    return rays / ((time.perf_counter() - t0) / iters)


def shard_iteration_counts(scene, camera, cfg: RenderConfig, n_shards: int, gr: int = 32,
                           device=None) -> list:
    """DETERMINISTIC per-shard work of the interleaved row sharding: each
    shard's exact program (its rows, its camera row map, the shared accel) run
    in turn on one device (``device=None``: CUDA), as ``render_uber_sharded``
    runs it.

    The JAX package counts each shard's persistent-kernel loop iterations.
    This port's kernel has no such loop count: its warps refill from an atomic
    cursor, so a warp's iterations depend on the schedule.  The work counted
    here is each shard's ``ST_RAYS``, the ray-tree nodes it traced, which the
    plain version counts too and which does not depend on the schedule.  With
    every shard running the same kernel at the same cost per node, the
    slowest shard sets a mesh's time: efficiency <= mean / max.

    Returns a list of ``n_shards`` ray counts; they sum to the single-device
    ``render_uber``'s rays when ``n_shards`` divides ``H`` (else the
    off-frame rows count too)."""
    from raytracing_tests_tpu_torch.kernels.uber import ST_RAYS

    dev = resolve_device(device)
    mesh = make_mesh(devices=[dev] * n_shards)
    blocks, _ = _uber_shards(scene, camera, cfg, mesh, None, gr)
    return [int(stats[ST_RAYS]) for _, _, stats in blocks]


def load_imbalance_report(scene, camera, cfg: RenderConfig,
                          shard_counts: Sequence[int] = (1, 2, 4, 8), gr: int = 32,
                          device=None) -> list:
    """The deterministic scaling model over ``shard_counts``: per-shard rays
    (``shard_iteration_counts``), worst / mean imbalance and the efficiency
    bound mean / worst.  The interleaved row map exists to keep the ratio
    near 1: sky rows and geometry rows alternate across shards."""
    rows = []
    for n in shard_counts:
        rays = shard_iteration_counts(scene, camera, cfg, n, gr=gr, device=device)
        mean = sum(rays) / len(rays)
        worst = max(rays)
        rows.append({"shards": n, "rays": rays, "imbalance": worst / mean,
                     "efficiency_bound": mean / worst})
    return rows


def scaling_report(scene, camera, cfg: RenderConfig, device_counts: Sequence[int],
                   renderer: str = "queue", devices=None) -> list:
    """Scaling table: rays/s and efficiency against linear from the first
    entry; a list of dict(devices, rays_per_s, speedup, efficiency)."""
    rows = []
    base = None
    for n in device_counts:
        rps = measure_rays_per_s(scene, camera, cfg, n, renderer=renderer, devices=devices)
        if base is None:
            base = (n, rps)
        speedup = rps / base[1]
        rows.append({"devices": n, "rays_per_s": rps, "speedup": speedup,
                     "efficiency": speedup / (n / base[0])})
    return rows
