"""Build and load the CUDA kernels under ``csrc/``.

Each ``.cu`` source is compiled by ``nvcc`` for ``sm_90a`` into its own shared
library with a plain C interface and loaded with ``ctypes``.  The build runs
at first use (never at import), all sources in parallel, into
``raytracing_tests_tpu_torch/_build/<hash>/`` where the hash covers every file
under ``csrc/`` and the compiler flags, so an edited source rebuilds.

Also here: the launch counters.  Each kernel wrapper adds one to its count
where it launches its kernel, and nowhere else.
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

SOURCES = ("sweep2.cu", "uber.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# Keeps every multiply and add separately rounded.  The default build lets
# nvcc fuse a*b+c; this variant rounds like eager PyTorch does, so a kernel can
# be held against its plain version exactly (see ``precise``).
PRECISE_FLAG = "-fmad=false"

# kernel name -> launches since the last reset
LAUNCHES: collections.Counter = collections.Counter()

_LIBS: dict = {}  # (name, extra flags) -> CDLL
_extra_flags: tuple = ()


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


def source_hash() -> str:
    h = hashlib.sha256()
    for path in sorted(CSRC.iterdir()):
        if path.suffix in (".cu", ".cuh"):
            h.update(path.name.encode())
            h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _lib_path(out_dir, src, extra) -> pathlib.Path:
    tag = ".precise" if extra else ""
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
    variants = {(), _extra_flags} | ({(PRECISE_FLAG,)} if with_precise else set())
    procs = []
    for src in SOURCES:
        for extra in sorted(variants):
            lib = _lib_path(out_dir, src, extra)
            if lib.exists():
                continue
            tmp = out_dir / f".{lib.name}.{os.getpid()}.tmp"
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
