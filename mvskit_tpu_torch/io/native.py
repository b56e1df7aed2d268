# Copy of mvskit_tpu/io/native.py (library source and build directory are the port's own); the port imports nothing of mvskit_tpu.
"""ctypes bindings for the native PLY library (csrc/plyio.cpp).

The reference keeps point-cloud I/O native (io/io_file.c + RPly,
SURVEY.md C14/C15). The shared library is auto-built with g++ on first
use into build/mvskit_tpu_torch/, keyed by a hash of the source;
everything degrades gracefully to the pure-Python path (io/ply.py) when
a compiler is unavailable or MVSKIT_NO_NATIVE is set.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Dict, Optional

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG, "csrc", "plyio.cpp")
_BUILD = os.path.join(os.path.dirname(_PKG), "build", "mvskit_tpu_torch")

_lock = threading.Lock()
_lib = None
_tried = False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        if os.environ.get("MVSKIT_NO_NATIVE"):
            return None
        try:
            with open(_SRC, "rb") as f:
                digest = hashlib.sha256(f.read()).hexdigest()[:16]
            path = os.path.join(_BUILD, f"libplyio-{digest}.so")
            if not os.path.exists(path):
                os.makedirs(_BUILD, exist_ok=True)
                tmp = f"{path}.{os.getpid()}.tmp"
                subprocess.run(
                    ["g++", "-O2", "-shared", "-fPIC", "-o", tmp, _SRC],
                    check=True,
                    capture_output=True,
                    timeout=120,
                )
                os.replace(tmp, path)
            lib = ctypes.CDLL(path)
            lib.ply_count.restype = ctypes.c_long
            lib.ply_count.argtypes = [
                ctypes.c_char_p,
                ctypes.POINTER(ctypes.c_int),
                ctypes.POINTER(ctypes.c_int),
            ]
            lib.ply_read.restype = ctypes.c_int
            lib.ply_read.argtypes = [ctypes.c_char_p] + [ctypes.c_void_p] * 3
            lib.ply_write.restype = ctypes.c_int
            lib.ply_write.argtypes = [
                ctypes.c_char_p, ctypes.c_long,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int,
            ]
            _lib = lib
        except Exception:
            _lib = None
        return _lib


def available() -> bool:
    return _load() is not None


def read_ply(path: str) -> Optional[Dict[str, np.ndarray]]:
    """Native PLY read; returns None when the native path can't handle
    the file (caller falls back to pure Python)."""
    lib = _load()
    if lib is None:
        return None
    hn = ctypes.c_int(0)
    hr = ctypes.c_int(0)
    n = lib.ply_count(path.encode(), ctypes.byref(hn), ctypes.byref(hr))
    if n < 0:
        return None
    xyz = np.empty((n, 3), np.float64)
    normals = np.empty((n, 3), np.float64) if hn.value else None
    rgb = np.empty((n, 3), np.uint8) if hr.value else None
    rc = lib.ply_read(
        path.encode(),
        xyz.ctypes.data_as(ctypes.c_void_p),
        normals.ctypes.data_as(ctypes.c_void_p) if normals is not None else None,
        rgb.ctypes.data_as(ctypes.c_void_p) if rgb is not None else None,
    )
    if rc != 0:
        return None
    out = {"xyz": xyz}
    if normals is not None:
        out["normal"] = normals
    if rgb is not None:
        out["rgb"] = rgb
    return out


def write_ply(
    path: str,
    xyz: np.ndarray,
    normal: Optional[np.ndarray] = None,
    rgb: Optional[np.ndarray] = None,
    binary: bool = False,
) -> bool:
    lib = _load()
    if lib is None:
        return False
    xyz = np.ascontiguousarray(xyz, np.float32)
    nrm = (
        np.ascontiguousarray(normal, np.float32)
        if normal is not None
        else None
    )
    col = np.ascontiguousarray(rgb, np.uint8) if rgb is not None else None
    rc = lib.ply_write(
        path.encode(),
        xyz.shape[0],
        xyz.ctypes.data_as(ctypes.c_void_p),
        nrm.ctypes.data_as(ctypes.c_void_p) if nrm is not None else None,
        col.ctypes.data_as(ctypes.c_void_p) if col is not None else None,
        1 if binary else 0,
    )
    return rc == 0
