"""Microbenchmark of the NCC window sampler (port of
``tools/bench_pallas_kernel.py``).

    python -m mvskit_tpu_torch.tools.bench_kernel [n_windows] [reps]
    GROUP=32 FUSED=1 python -m mvskit_tpu_torch.tools.bench_kernel
    GROUP=32 ABLATE=nomm python -m mvskit_tpu_torch.tools.bench_kernel

On the JAX tool's scene (16 views of 640x480, pyramid level 1, 7x7
windows, `n_windows` plane points, default 57,344) it times the luma,
then the RGB launch of ``cuda_ncc.sample_windows`` and, beside each,
its plain PyTorch version on the same windows, and holds each output to
the plain version bit for bit. GROUP=K lays the windows out as the
refinement rounds do: each of n_windows / K base windows repeated K
times with a +-2 px jitter of the lattice origin (member 0 unjittered).
FUSED=1 selects the fused form and ABLATE one of
``cuda_ncc.ABLATIONS``. Times are CUDA-event medians of `reps` warm
runs (``--device cuda``, the default): `ms` and `plain_ms` with each run
queued behind a device-side wait, so they count the device's work
alone, and `call_ms` without it (one call as a caller sees it, the
host's launch latency included). With ``--device cpu`` the kernel is its
plain version and nothing is timed. Prints KERNEL_MSPS= (luma)
and KERNEL_RGB_MSPS= (RGB) in millions of samples per second, then one
JSON record.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from .. import get_device
from ..geometry import camera as cam
from ..ops import cuda_ncc, ncc
from ..utils import synthetic

LEVEL, WSIZE = 1, 7
A1 = math.radians(60.0)
N_WINDOWS = 57344
SCENE = dict(n_views=16, width=640, height=480)


class BenchResult(NamedTuple):
    record: Dict          # the JSON record
    layout: Dict          # idx, lvl, tl, dx, dy, valid of the windows
    out: Dict             # {"luma": tensor, "rgb": tensor}, kernel outputs


def bench_scene(device, n_views: int = 16, width: int = 640, height: int = 480):
    """Projections and Scene of the benchmark's textured plane."""
    Ps, _, scene = synthetic.plane_scene(n_views=n_views, width=width,
                                         height=height, device=device)
    return Ps, scene


def window_layout(scene, Ps, n_windows: int, group: int = 1) -> Dict:
    """The JAX tool's windows: plane points (seed 1, extent 1.2) seen
    from views drawn with numpy rng seed 0, their window geometry at
    LEVEL, and with group > 1 the grouped layout (rng seed 1 jitter).
    Returns idx, lvl [B] int32, tl, dx, dy [B, 2] f32, valid [B] bool."""
    if group > 1 and n_windows % group:
        raise ValueError(f"n_windows {n_windows} is not a multiple of group {group}")
    dev = scene.device
    B = n_windows
    coord_np, normal_np = synthetic.plane_points(Ps, B, extent=1.2)
    coord = torch.as_tensor(coord_np, dtype=torch.float32, device=dev)
    normal = torch.as_tensor(normal_np, dtype=torch.float32, device=dev)
    idx = torch.as_tensor(np.random.default_rng(0).integers(0, scene.n_images, B),
                          dtype=torch.int64, device=dev)
    px, py = cam.get_paxes(scene.cams, idx, coord, normal, LEVEL)
    tl, dx, dy, lvl, valid = ncc.window_geometry(
        scene, idx, coord, px, py, normal, LEVEL, WSIZE, A1)
    if group > 1:
        Bg = B // group
        jx = np.random.default_rng(1).uniform(-2, 2, (Bg, group, 2)).astype(np.float32)
        jx[:, 0] = 0.0
        rep = lambda x: x[:Bg].repeat_interleave(group, 0)  # noqa: E731
        tl = (tl[:Bg].unsqueeze(1) + torch.as_tensor(jx, device=dev)).reshape(B, 2)
        idx, lvl, dx, dy, valid = rep(idx), rep(lvl), rep(dx), rep(dy), rep(valid)
    return dict(idx=idx.to(torch.int32).contiguous(), lvl=lvl.to(torch.int32).contiguous(),
                tl=tl.contiguous(), dx=dx.contiguous(), dy=dy.contiguous(), valid=valid)


# cycles of torch.cuda._sleep queued before each timed call (about
# 20 ms at the H100's 1.98 GHz boost clock): the host enqueues the whole
# call while the device waits, so the events time the device's work and
# not the host's launch latency
HOLD_CYCLES = 40_000_000


def cuda_time_ms(fn, reps: int, hold: bool = True) -> float:
    """Median of `reps` warm runs of fn, each timed with CUDA events.
    With `hold` each run is queued behind a device-side wait (its device
    time); without, the events also count the host's time to launch it
    while the device idles (the time one call takes)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        if hold:
            torch.cuda._sleep(HOLD_CYCLES)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    return bool(torch.equal(a.contiguous().view(torch.int32),
                            b.contiguous().view(torch.int32)))


def run(n_windows: int = N_WINDOWS, reps: int = 3, group: int = 1,
        fused: bool = False, ablate: str = "", device="cuda", scene=None,
        n_views: int = 16, width: int = 640, height: int = 480) -> BenchResult:
    """One benchmark setting on the plane scene of n_views x width x
    height (or on `scene`, a (Ps, Scene) pair from ``bench_scene``).
    The record holds, per channel mode, the launch form, kernel (device
    and per call) and plain times (None off the card), Msamples/s,
    max |kernel - plain| and whether the two are equal bit for bit."""
    dev = get_device(str(device)) if scene is None else scene[1].device
    Ps, sc = scene if scene is not None else bench_scene(dev, n_views, width, height)
    lay = window_layout(sc, Ps, n_windows, group)
    args = tuple(lay[k] for k in ("idx", "lvl", "tl", "dx", "dy"))
    S = WSIZE * WSIZE
    on_card = dev.type == "cuda"
    rec = {"windows": n_windows, "group": group, "fused": fused, "ablate": ablate,
           "device": torch.cuda.get_device_name(dev) if on_card else str(dev),
           "scene": [sc.n_images, sc.widths[0], sc.heights[0]], "level": LEVEL,
           "wsize": WSIZE, "valid_frac": float(lay["valid"].float().mean())}
    outs = {}
    for mode in ("luma", "rgb"):
        luma = mode == "luma"

        def kern():
            return cuda_ncc.sample_windows(sc, *args, WSIZE, group=group, luma=luma,
                                           fused=fused, ablate=ablate)[0]

        plain_fn = cuda_ncc.sample_windows_luma_plain if luma else cuda_ncc.sample_windows_plain

        def plain():
            return plain_fn(sc, *args, WSIZE, ablate=ablate)

        out_k, out_p = kern(), plain()
        both = torch.isfinite(out_k) & torch.isfinite(out_p)
        r = {"form": cuda_ncc.launch_form(n_windows, group, luma, fused),
             "bitwise_equal_plain": bits_equal(out_k, out_p),
             "max_abs_err": float((out_k - out_p).abs()[both].max()) if both.any() else 0.0,
             "ms": None, "call_ms": None, "plain_ms": None, "msamples_per_s": None}
        if on_card:
            r["ms"] = cuda_time_ms(kern, reps)
            r["call_ms"] = cuda_time_ms(kern, reps, hold=False)
            r["plain_ms"] = cuda_time_ms(plain, reps)
            r["msamples_per_s"] = n_windows * S / r["ms"] / 1e3
        rec[mode] = r
        outs[mode] = out_k
    return BenchResult(rec, lay, outs)


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m mvskit_tpu_torch.tools.bench_kernel",
        description="time the NCC window sampler against its plain version "
                    "(GROUP, FUSED and ABLATE from the environment)")
    ap.add_argument("n_windows", nargs="?", type=int, default=N_WINDOWS)
    ap.add_argument("reps", nargs="?", type=int, default=3)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    group = int(os.environ.get("GROUP", "1"))
    fused = os.environ.get("FUSED", "") == "1"
    ablate = os.environ.get("ABLATE", "")
    res = run(args.n_windows, args.reps, group=group, fused=fused, ablate=ablate,
              device=args.device, **SCENE)
    rec = res.record
    print(f"scene {rec['scene']}, {rec['windows']} windows, group {group}, "
          f"fused {fused}, ablate {ablate!r}, valid {rec['valid_frac']:.2f}",
          file=sys.stderr)
    for mode, key in (("luma", "KERNEL_MSPS"), ("rgb", "KERNEL_RGB_MSPS")):
        r = rec[mode]
        print(f"{mode} {r['form']}: kernel {r['ms']} ms, plain {r['plain_ms']} ms, "
              f"bit-equal {r['bitwise_equal_plain']}", file=sys.stderr)
        if r["msamples_per_s"] is not None:
            print(f"{key}={r['msamples_per_s']:.2f}")
    print(json.dumps(rec))
    return 0 if all(rec[m]["bitwise_equal_plain"] for m in ("luma", "rgb")) else 1


if __name__ == "__main__":
    raise SystemExit(main())
