"""Build the port's CUDA kernels at first use.

``load_library()`` compiles every ``csrc/*.cu`` of the package with
``nvcc`` into one shared library with a plain C interface, loads it with
ctypes and caches it for the process. The library lands in
``build/mvskit_tpu_torch/<hash>/`` at the root of the checkout, keyed by
a hash of the sources and flags, so an unchanged tree builds once. It
uses nothing but the sources in the repository; a failed build raises
with nvcc's stderr.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_ROOT = PKG_DIR.parent / "build" / "mvskit_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def find_nvcc() -> str:
    """nvcc from PATH, else under CUDA_HOME or /usr/local/cuda."""
    path = shutil.which("nvcc")
    if path:
        return path
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda)")


def _sources():
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def _digest() -> str:
    h = hashlib.sha256()
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_ROOT / _digest() / "libmvskit_kernels.so"


def build() -> Path:
    """Compile csrc/*.cu into the hashed library path (no-op when it
    exists). Returns the path."""
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cu = [str(p) for p in _sources() if p.suffix == ".cu"]
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *cu]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({res.returncode}): {' '.join(cmd)}\n{res.stderr}"
        )
    os.replace(tmp, out)
    return out


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, once per process."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            ptr, i32 = ctypes.c_void_p, ctypes.c_int
            ints = ctypes.POINTER(ctypes.c_int)
            common = [ptr, i32, ints, ints, ints, i32,
                      ptr, ptr, ptr, ptr, ptr, ptr, i32, i32]
            for chans in ("", "luma_"):
                # ungrouped: (..., ablate, stream); grouped and fused:
                # (..., group, ablate, stream)
                ung = getattr(lib, f"mvs_sample_windows_{chans}ungrouped")
                ung.argtypes, ung.restype = common + [i32, ptr], i32
                for form in ("grouped", "fused"):
                    fn = getattr(lib, f"mvs_sample_windows_{chans}{form}")
                    fn.argtypes, fn.restype = common + [i32, i32, ptr], i32
            _lib = lib
        return _lib
