"""Build the port's CUDA kernels at first use.

``load_library()`` compiles every ``csrc/*.cu`` of the package with
``nvcc`` into one shared library with a plain C interface, loads it with
ctypes and caches it for the process. Each source compiles to an object
in its own nvcc process, all started together, and one nvcc links them.
The library lands in ``build/mvskit_tpu_torch/<hash>/`` at the root of
the checkout, keyed by a hash of the sources (``*.cu`` and the shared
``*.cuh``) and flags, so an unchanged tree builds once. It uses nothing
but the sources in the repository; a failed build raises with nvcc's
stderr.

nvcc runs with ``-Xptxas -v``: ptxas reports each kernel instance's
registers, shared memory, stack and spills, and a successful build keeps
that report as ``ptxas.txt`` beside the library. ``ptxas_report()``
reads it back per instance, under names such as
``window_kernel<3, 7, 0>`` (the template arguments of the mangled name).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_ROOT = PKG_DIR.parent / "build" / "mvskit_tpu_torch"
GENCODE = ("-gencode", "arch=compute_90a,code=sm_90a")
# per source (-c); the objects link with GENCODE and -shared
NVCC_FLAGS = (
    *GENCODE, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
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


def report_path() -> Path:
    return library_path().with_name("ptxas.txt")


def _run_all(cmds):
    """Run the commands side by side; raise with the first failure's
    stderr. Returns their stdout + stderr, in order."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for c in cmds]
    outs = [p.communicate() for p in procs]
    for cmd, p, (_, err) in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}): {' '.join(cmd)}\n{err}")
    return [so + se for so, se in outs]


def build(out: Optional[Path] = None) -> Path:
    """Compile csrc/*.cu into `out` (default: the hashed library path;
    a no-op when it exists): one nvcc per source, all at once, then one
    link. Returns the path."""
    out = library_path() if out is None else Path(out)
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    nvcc, tag = find_nvcc(), os.getpid()
    cu = [p for p in _sources() if p.suffix == ".cu"]
    objs = [out.with_name(f"{p.stem}.{tag}.o") for p in cu]
    reports = _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(p)]
                        for p, o in zip(cu, objs)])
    tmp = out.with_suffix(f".{tag}.tmp")
    _run_all([[nvcc, *GENCODE, "-shared", "-o", str(tmp), *map(str, objs)]])
    for o in objs:
        o.unlink()
    out.with_name("ptxas.txt").write_text("".join(reports))
    os.replace(tmp, out)
    return out


def demangle(name: str) -> str:
    """`_Z13window_kernelILi3ELi7ELi0EEv...` -> `window_kernel<3, 7, 0>`:
    the kernel's name and its integer template arguments (the only kind
    the library's kernels take); other names come back unchanged."""
    m = re.match(r"_Z(\d+)", name)
    if not m:
        return name
    start = m.end()
    base = name[start:start + int(m.group(1))]
    args = re.match(r"I((?:Li-?\d+E)+)E", name[start + len(base):])
    if not args:
        return base
    values = re.findall(r"Li(-?\d+)E", args.group(1))
    return f"{base}<{', '.join(values)}>"


def parse_ptxas(text: str) -> Dict[str, Dict[str, int]]:
    """Per kernel instance (demangled name): registers, smem_bytes (static
    shared memory), stack_bytes, spill_stores and spill_loads, from
    ptxas's -v report."""
    out: Dict[str, Dict[str, int]] = {}
    entry = None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry = demangle(m.group(1))
            out[entry] = {"registers": 0, "smem_bytes": 0, "stack_bytes": 0,
                          "spill_stores": 0, "spill_loads": 0}
            continue
        if entry is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            out[entry].update(stack_bytes=int(m.group(1)), spill_stores=int(m.group(2)),
                              spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[entry]["registers"] = int(m.group(1))
            s = re.search(r"(\d+) bytes smem", line)
            out[entry]["smem_bytes"] = int(s.group(1)) if s else 0
            entry = None
    return out


def ptxas_report() -> Dict[str, Dict[str, int]]:
    """The built library's ptxas report, per kernel instance (an empty
    dict where the build kept none)."""
    path = report_path()
    return parse_ptxas(path.read_text()) if path.exists() else {}


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, once per process."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            ptr, i32 = ctypes.c_void_p, ctypes.c_int
            ints = ctypes.POINTER(ctypes.c_int)
            # planes, total, level offsets, widths, heights, n_levels, ni,
            # illum, idx, lvl, tl, dx, dy, out, B, wsize
            common = [ptr, i32, ints, ints, ints, i32, i32, i32,
                      ptr, ptr, ptr, ptr, ptr, ptr, i32, i32]
            for chans in ("", "luma_"):
                # ungrouped: (..., ablate, stream); grouped and fused:
                # (..., group, ablate, stream)
                ung = getattr(lib, f"mvs_sample_windows_{chans}ungrouped")
                ung.argtypes, ung.restype = common + [i32, ptr], i32
                for form in ("grouped", "fused"):
                    fn = getattr(lib, f"mvs_sample_windows_{chans}{form}")
                    fn.argtypes, fn.restype = common + [i32, i32, ptr], i32
            # (form, B, wsize, group, int plan[10])
            lib.mvs_sample_windows_plan.argtypes = [i32] * 4 + [ints]
            lib.mvs_sample_windows_plan.restype = i32
            # the backward: planes, total, level tables, n_levels, ni,
            # illum, idx, lvl, tl, dx, dy, grad_out, grads, B, wsize, stream
            for chans in ("", "luma_"):
                fn = getattr(lib, f"mvs_sample_windows_{chans}grad")
                fn.argtypes = common[:13] + [ptr, ptr, i32, i32, ptr]
                fn.restype = i32
            _lib = lib
        return _lib
