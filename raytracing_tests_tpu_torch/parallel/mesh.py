"""The row mesh, and the load-balanced row assignment.

Counterpart of the JAX package's ``parallel/mesh.py``.  Path tracing is
embarrassingly parallel over pixels, so one data axis, ``rows``, suffices; the
scene and its accel are replicated.  A ``Mesh`` is the list of devices along
that axis, shard ``s`` on ``devices[s]``, in one of two forms:

  - every shard in this process (``rank is None``): the visible CUDA devices,
    or an explicit list, which may name one device several times (n virtual
    shards of one card, or of the CPU in the tests: the counterpart of the JAX
    tests' ``--xla_force_host_platform_device_count``);
  - one shard per process of a ``torch.distributed`` group (after
    ``parallel.multihost.initialize_multihost``): this process holds shard
    ``rank``, and the collectives run over the group.

``row_permutation`` is the load balancer: a strided interleave, so each shard
gets every n-th row and mixes cheap sky rows with expensive geometry rows
instead of one shard taking the whole horizon.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

ROWS_AXIS = "rows"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Devices along the ``rows`` axis: shard ``s`` renders on ``devices[s]``.

    ``rank`` is None when every shard runs in this process; under a process
    group it is this process's shard, and ``group`` the group whose ranks are
    the shards."""

    devices: tuple
    rank: Optional[int] = None
    group: object = None

    def __post_init__(self):
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        if self.rank is not None and not 0 <= self.rank < len(self.devices):
            raise ValueError(f"rank {self.rank} outside a mesh of {len(self.devices)}")

    @property
    def shape(self) -> dict:
        return {ROWS_AXIS: len(self.devices)}

    @property
    def distributed(self) -> bool:
        """True when the shards are the ranks of a process group."""
        return self.rank is not None

    def local_shards(self) -> list:
        """[(shard, device)] of the shards this process renders."""
        if self.distributed:
            return [(self.rank, self.devices[self.rank])]
        return list(enumerate(self.devices))

    @property
    def home(self) -> torch.device:
        """This process's first device: where assembled outputs land."""
        return self.local_shards()[0][1]


def _world_devices(group=None) -> tuple:
    """Every rank's device, gathered: the CPU under gloo, else the CUDA device
    each rank made current."""
    if dist.get_backend(group) == "gloo":
        mine = "cpu"
    else:
        mine = f"cuda:{torch.cuda.current_device()}"
    got = [None] * dist.get_world_size(group)
    dist.all_gather_object(got, mine, group=group)
    return tuple(torch.device(d) for d in got)


def make_mesh(n_devices: Optional[int] = None, devices: Optional[Sequence] = None) -> Mesh:
    """A one-axis mesh of ``n_devices`` shards (all of them when None).

    ``devices``: an explicit list (may repeat a device: virtual shards), cut
    to its first ``n_devices``.  Else, once a process group is up, the
    group's ranks, this process holding shard ``rank`` (``n_devices`` must
    then be None or the world size).  Else the visible CUDA devices: this
    raises without CUDA, and when ``n_devices`` is more than there are."""
    if devices is not None:
        devs = tuple(torch.device(d) for d in devices)
        if n_devices is not None:
            if n_devices > len(devs):
                raise ValueError(f"{n_devices} shards asked of {len(devs)} devices")
            devs = devs[:n_devices]
        return Mesh(devs)
    if dist.is_available() and dist.is_initialized():
        world = dist.get_world_size()
        if n_devices not in (None, world):
            raise ValueError(
                f"{n_devices} shards asked of a process group of {world}: a shard "
                "is a rank")
        return Mesh(_world_devices(), rank=dist.get_rank(), group=dist.group.WORLD)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: make_mesh() spans the CUDA devices; pass "
            "devices=['cpu'] * n for virtual CPU shards")
    count = torch.cuda.device_count()
    n = count if n_devices is None else n_devices
    if not 1 <= n <= count:
        raise ValueError(f"{n_devices} shards asked of {count} CUDA devices")
    return Mesh(tuple(torch.device("cuda", i) for i in range(n)))


def row_permutation(height: int, n_shards: int):
    """(perm, inverse, padded_height): strided interleave of image rows.

    Rows are padded to a multiple of ``n_shards``; ``perm[k]`` is the source
    row of position k in the sharded layout, laid out so shard s holds rows
    ``s, s + n, s + 2n, ...`` — each shard sees a uniform slice of the image.
    """
    padded = -(-height // n_shards) * n_shards
    # position (s, i) <- row i * n_shards + s
    perm = np.arange(padded).reshape(-1, n_shards).T.reshape(-1)
    inverse = np.argsort(perm)
    return perm, inverse, padded


def shard_rows(height: int, n_shards: int, shard: int) -> np.ndarray:
    """The real rows of ``shard``: ``shard, shard + n, ...`` below ``height``."""
    return np.arange(shard, height, n_shards)
