"""Tracing/profiling: ``torch.profiler`` wrappers + throughput counters.

The reference's closest artifacts are a frame Timestep and ImGui capability
readouts; the port exposes a profiler trace (a Chrome trace, viewable in
Perfetto or ``chrome://tracing``) and a rays/s meter.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time

import torch


# Tiny kernels each CUDA trace launches first and last (``pad_device_trace``).
PRIMER_LAUNCHES = 256
DRAIN_LAUNCHES = 2048


def pad_device_trace(launches: int = PRIMER_LAUNCHES, name: str = "trace_primer") -> None:
    """Launch ``launches`` one-element adds on the current CUDA device and
    wait for them, inside a range named ``name``.

    On an H100 a ``torch.profiler`` session lost device records at both ends
    (the cause of neither is known).  Late in a long process it lost those of
    its first few kernel launches, however long after its start they came,
    so a short block such as one cached ``render_uber`` frame showed none of
    its kernels.  A session of thousands of launches lost those of its last
    ones: 2 of 18 017, 335 and 864 of some 106 700.  A session that opens
    with ``PRIMER_LAUNCHES`` of these (``trace_primer``) and closes with
    ``DRAIN_LAUNCHES`` (``trace_drain``) loses theirs instead.  What a
    reader wants lies between the first ``cudaDeviceSynchronize`` and the
    last but one."""
    with torch.profiler.record_function(name):
        x = torch.zeros(1, device=torch.cuda.current_device())
        for _ in range(launches):
            x.add_(1.0)
        torch.cuda.synchronize()


@contextlib.contextmanager
def trace(log_dir: str = None):
    """Capture a ``torch.profiler`` trace of the enclosed block into
    ``log_dir`` (default: ``rt_torch_trace`` under the temporary directory)
    as ``trace_<pid>_<ns>.json``.  The trace holds CUDA activity (kernels,
    copies) when CUDA is initialised at entry, and host activity always; a
    CUDA session is padded at both ends (``pad_device_trace``).  Yields
    ``log_dir``."""
    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "rt_torch_trace")
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    cuda = torch.cuda.is_available() and torch.cuda.is_initialized()
    if cuda:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        if cuda:
            pad_device_trace()
        yield log_dir
        if cuda:
            torch.cuda.synchronize()
            pad_device_trace(DRAIN_LAUNCHES, "trace_drain")
    finally:
        prof.stop()
        prof.export_chrome_trace(
            os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


class ThroughputMeter:
    """Accumulates (rays, seconds) across frames; reports Mrays/s.

    ``frame`` times the block by the host clock.  PyTorch returns before the
    card has run what it enqueued, so where CUDA is initialised ``frame``
    calls ``torch.cuda.synchronize()`` before each reading of the clock:
    without it the meter would time the launches, not the frames."""

    def __init__(self):
        self.rays = 0
        self.seconds = 0.0

    @staticmethod
    def _sync():
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()

    @contextlib.contextmanager
    def frame(self, rays: int):
        self._sync()
        t0 = time.perf_counter()
        yield
        self._sync()
        self.seconds += time.perf_counter() - t0
        self.rays += int(rays)

    @property
    def mrays_per_s(self) -> float:
        return self.rays / self.seconds / 1e6 if self.seconds else 0.0


def annotate(name: str):
    """Named range for profiler traces (``torch.profiler.record_function``)."""
    return torch.profiler.record_function(name)
