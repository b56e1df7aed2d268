"""Time the kernel library's build (``ops/_build.py``) from nothing.

    python -m mvskit_tpu_torch.tools.bench_build [--reps 2]

Builds the library into a fresh temporary directory, three ways in turn,
``--reps`` times each:

  parallel      ``_build.build()``: one nvcc per ``csrc/*.cu``, all
                started together, then one nvcc link;
  one_nvcc      one nvcc over every ``csrc/*.cu`` with ``-shared`` (the
                command the library was built with before the backward's
                source joined);
  forward_only  that command over ``sample_windows.cu`` alone (the build
                before the backward existed).

Prints one JSON record: each way's seconds per build, its sources, and
the card's name and power limit. Needs nvcc (the card's machine).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import tempfile
import time
from pathlib import Path

from ..ops import _build


def one_nvcc(out: Path, sources) -> None:
    """One nvcc over `sources` into the shared library `out`."""
    cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(out),
           *map(str, sources)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}): {' '.join(cmd)}\n{res.stderr}")


def run(reps: int = 2) -> dict:
    from .e2e_run import card_line

    cu = sorted(_build.CSRC_DIR.glob("*.cu"))
    forward = [p for p in cu if p.name == "sample_windows.cu"]
    ways = {
        "parallel": (cu, lambda out: _build.build(out)),
        "one_nvcc": (cu, lambda out: one_nvcc(out, cu)),
        "forward_only": (forward, lambda out: one_nvcc(out, forward)),
    }
    seconds = {name: [] for name in ways}
    for _ in range(reps):
        for name, (_, fn) in ways.items():
            with tempfile.TemporaryDirectory(prefix="mvskit_build_") as td:
                t0 = time.perf_counter()
                fn(Path(td) / "libmvskit_kernels.so")
                seconds[name].append(time.perf_counter() - t0)
    return {"metric": "build_s", "card": card_line(),
            "ways": {name: {"sources": [p.name for p in srcs], "seconds": seconds[name]}
                     for name, (srcs, _) in ways.items()}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m mvskit_tpu_torch.tools.bench_build")
    ap.add_argument("--reps", type=int, default=2)
    a = ap.parse_args(argv)
    print(json.dumps(run(a.reps)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
