"""ctypes loader for the native host runtime (``src/rt_native.cpp``).

Compiled at first use with ``g++`` (never at import) into
``raytracing_tests_tpu_torch/_build/librt_native-<sha>.so``, named by a hash
of the source: an edited source always rebuilds, and a binary built from
other source is never loaded.  Without a compiler ``available()`` is False
and every entry point raises ``RuntimeError``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess

import numpy as np

_DIR = pathlib.Path(__file__).resolve().parent
_SRC = _DIR / "src" / "rt_native.cpp"
BUILD_DIR = _DIR.parent / "_build"
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17", "-pthread")

AVAILABLE = False
_lib = None


def _lib_path() -> pathlib.Path:
    digest = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"librt_native-{digest}.so"


def _build():
    """The library's path, compiled first if needed; None without g++."""
    lib = _lib_path()
    if lib.exists():
        return lib
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    try:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run(["g++", *CXX_FLAGS, str(_SRC), "-o", str(tmp)],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, lib)  # atomic: concurrent builders race safely
        return lib
    except (OSError, subprocess.SubprocessError):
        return None


def _load():
    global _lib, AVAILABLE
    if _lib is not None:
        return _lib
    path = _build()
    if path is None:
        return None
    lib = ctypes.CDLL(str(path))
    lib.rt_version.restype = ctypes.c_int
    if lib.rt_version() != 1:
        raise RuntimeError(f"{path}: unexpected ABI version {lib.rt_version()}")
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    lib.rt_build_lbvh.argtypes = [f32p, f32p, ctypes.c_int, i32p, i32p, i32p, i32p, f32p, f32p]
    lib.rt_build_lbvh.restype = None
    lib.rt_noise_texture.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int, f32p,
    ]
    lib.rt_noise_texture.restype = None
    _lib = lib
    AVAILABLE = True
    return lib


def _required():
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable: building src/rt_native.cpp "
                           "needs g++")
    return lib


def build_lbvh_host(bb_min: np.ndarray, bb_max: np.ndarray) -> dict:
    """Native Karras LBVH build over (N, 3) AABB arrays, N >= 2 ->
    dict(left, right, parent, obj_id, bb_min, bb_max) numpy arrays with the
    node layout of ``bvh.build.build_lbvh``."""
    lib = _required()
    bb_min = np.ascontiguousarray(bb_min, np.float32)
    bb_max = np.ascontiguousarray(bb_max, np.float32)
    n = bb_min.shape[0]
    if n < 2 or bb_min.shape != (n, 3) or bb_max.shape != (n, 3):
        raise ValueError(f"two (N, 3) arrays with N >= 2, not {bb_min.shape} {bb_max.shape}")
    total = 2 * n - 1
    left, right, parent, obj_id = (np.empty(total, np.int32) for _ in range(4))
    node_lo = np.empty((total, 3), np.float32)
    node_hi = np.empty((total, 3), np.float32)
    lib.rt_build_lbvh(bb_min, bb_max, n, left, right, parent, obj_id, node_lo, node_hi)
    return dict(left=left, right=right, parent=parent, obj_id=obj_id,
                bb_min=node_lo, bb_max=node_hi)


NOISE_KINDS = {"simplex": 0, "fbm": 1, "turbulence": 2}


def noise_texture_host(height: int, width: int, scale: float = 8.0, octaves: int = 5,
                       kind: str = "fbm") -> np.ndarray:
    """Threaded native noise baking -> (H, W) float32 in [0, 1]."""
    lib = _required()
    out = np.empty((height, width), np.float32)
    lib.rt_noise_texture(height, width, float(scale), int(octaves), NOISE_KINDS[kind], out)
    return out


def available() -> bool:
    return _load() is not None
