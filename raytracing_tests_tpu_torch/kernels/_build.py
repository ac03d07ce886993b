"""Build and load the CUDA kernels under ``csrc/``.

Each ``.cu`` source is compiled by ``nvcc`` for ``sm_90a`` into its own shared
library with a plain C interface and loaded with ``ctypes``.  The build runs
at first use (never at import), all sources in parallel, into
``raytracing_tests_tpu_torch/_build/<hash>/`` where the hash covers every file
under ``csrc/`` and the compiler flags, so an edited source rebuilds.

Also here: the launch counters.  Each kernel wrapper adds one to its count
where it launches its kernel, and nowhere else.  And the one switch of the
warp sweeps' schedule for tests and measurement (``forced_coop_min``).

Where there is no GPU, ``host_rehearsal()`` builds the same sources as plain
C++ with ``g++`` and ``csrc/host_shim.h``, so a test can run a kernel's source
on CPU buffers through its ``_launch_*`` function.  That rehearses logic,
layouts and argument order; the GPU build is only proven on a GPU.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

_PKG = pathlib.Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "_build"

SOURCES = ("mega.cu", "sweep.cu", "sweep2.cu", "sweep2g.cu", "uber.cu", "uber_tex.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# Keeps every multiply and add separately rounded.  The default build lets
# nvcc fuse a*b+c; this variant rounds like eager PyTorch does, so a kernel can
# be held against its plain version exactly (see ``precise``).
PRECISE_FLAG = "-fmad=false"

# Marks the host-C++ variant (see ``host_rehearsal``); never passed to nvcc.
HOST_FLAG = "host"
HOST_CXX_FLAGS = (
    "-std=c++17", "-O2", "-shared", "-fPIC", "-x", "c++", "-include", "host_shim.h",
)

# kernel name -> launches since the last reset
LAUNCHES: collections.Counter = collections.Counter()

_LIBS: dict = {}  # (name, extra flags) -> CDLL
_extra_flags: tuple = ()
_coop_min_forced = None


def reset_launches() -> None:
    LAUNCHES.clear()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError(
        "nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): the CUDA kernels "
        "build from source at first use and need the CUDA toolkit")


@contextlib.contextmanager
def precise():
    """Inside this context the wrappers run the ``PRECISE_FLAG`` variant of
    the kernels (built beside the default one).  For verification only."""
    global _extra_flags
    saved = _extra_flags
    _extra_flags = (PRECISE_FLAG,)
    try:
        yield
    finally:
        _extra_flags = saved


@contextlib.contextmanager
def forced_coop_min(coop_min: int):
    """Inside this context every kernel with a warp sweep (K1 ``uber``, K2
    ``sweep2``, K3 ``sweep2g``, K5 ``sweep_grouped``, K6 ``mega``) sweeps with
    ``coop_min`` in place
    of its module's ``COOP_MIN``: 1 keeps every culling group per lane, 33
    sweeps every group row-parallel.  Both give the same result.  For tests
    and measurement only."""
    global _coop_min_forced
    saved = _coop_min_forced
    _coop_min_forced = int(coop_min)
    try:
        yield
    finally:
        _coop_min_forced = saved


def coop_min(default: int) -> int:
    """The ``coop_min`` a launch passes: ``default`` (the module's
    ``COOP_MIN``) unless ``forced_coop_min`` pins another."""
    return default if _coop_min_forced is None else _coop_min_forced


@contextlib.contextmanager
def host_rehearsal():
    """Inside this context ``load`` gives the host-C++ build of a source (see
    the module docstring).  Raises ``RuntimeError`` where there is no g++."""
    global _extra_flags
    if shutil.which("g++") is None:
        raise RuntimeError("host rehearsal of the kernels needs g++")
    saved = _extra_flags
    _extra_flags = (HOST_FLAG,)
    try:
        yield
    finally:
        _extra_flags = saved


def check_device(device) -> None:
    """A ``_launch_*`` function runs on CUDA tensors; on CPU tensors only
    inside ``host_rehearsal()``.  Anything else raises: a host pointer must
    never reach a CUDA launch."""
    host = _extra_flags == (HOST_FLAG,)
    if device.type != ("cpu" if host else "cuda"):
        raise RuntimeError(
            f"cannot launch on {device}: the "
            + ("host rehearsal takes CPU tensors" if host else "kernels take CUDA tensors"))


def stream_of(device) -> int | None:
    """The current CUDA stream's handle for a launch on ``device``; none for
    the host rehearsal's CPU buffers."""
    import torch

    check_device(device)
    if device.type != "cuda":
        return None
    return torch.cuda.current_stream(device).cuda_stream


def source_hash() -> str:
    h = hashlib.sha256()
    for path in sorted(CSRC.iterdir()):
        if path.suffix in (".cu", ".cuh", ".h"):
            h.update(path.name.encode())
            h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _lib_path(out_dir, src, extra) -> pathlib.Path:
    tag = {(): "", (PRECISE_FLAG,): ".precise", (HOST_FLAG,): ".host"}[tuple(extra)]
    return out_dir / (pathlib.Path(src).stem + tag + ".so")


def build(with_precise: bool = False) -> dict:
    """Compile every source that has no library yet — the default variant,
    the current ``precise()`` one and, if asked, the precise one too — all
    compilers started together.  Returns
    ``{"dir", "seconds", "built": [names], "log": nvcc output}``.
    Raises ``RuntimeError`` with nvcc's output when a compile fails."""
    out_dir = BUILD_ROOT / source_hash()
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    if _extra_flags == (HOST_FLAG,):
        variants = {_extra_flags}  # no nvcc needed, none asked for
    else:
        variants = {(), _extra_flags} | ({(PRECISE_FLAG,)} if with_precise else set())
    procs = []
    for src in SOURCES:
        for extra in sorted(variants):
            lib = _lib_path(out_dir, src, extra)
            if lib.exists():
                continue
            tmp = out_dir / f".{lib.name}.{os.getpid()}.tmp"
            if extra == (HOST_FLAG,):
                cmd = ["g++", *HOST_CXX_FLAGS, "-I", str(CSRC), "-o", str(tmp),
                       str(CSRC / src)]
            else:
                cmd = [_nvcc(), *NVCC_FLAGS, *extra, "-I", str(CSRC), "-o", str(tmp),
                       str(CSRC / src)]
            procs.append((lib.name, lib, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs, failed = [], []
    for src, lib, tmp, proc in procs:  # all started; now wait for each
        log, _ = proc.communicate()
        logs.append(f"== {src} ==\n{log}")
        if proc.returncode != 0:
            failed.append(src)
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, lib)  # atomic: a concurrent build sees whole files
    log = "\n".join(logs)
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n{log}")
    return {"dir": str(out_dir), "seconds": time.perf_counter() - t0,
            "built": [p[0] for p in procs], "log": log}


def load(name: str) -> ctypes.CDLL:
    """The shared library of ``csrc/<name>.cu`` (the variant of the current
    context), built if needed."""
    key = (name, _extra_flags)
    lib = _LIBS.get(key)
    if lib is None:
        info = build()
        lib = ctypes.CDLL(str(_lib_path(pathlib.Path(info["dir"]), name + ".cu", _extra_flags)))
        _LIBS[key] = lib
    return lib


def check(code: int, what: str) -> None:
    """Turn a ``cudaGetLastError()`` code from a launch into an exception."""
    if code != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error code {code}")
