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
host's launch latency included). Beside them, `library_ms` times the
library yardstick below on a grid built beforehand and `library_call_ms`
with the grid's preparation and the copy into the kernel's layout;
`library_max_abs_err` holds it to the kernel's output (unablated runs
only). With ``--device cpu`` the kernel is its plain version and
nothing is timed. Prints KERNEL_MSPS= (luma)
and KERNEL_RGB_MSPS= (RGB) in millions of samples per second, then one
JSON record.

``library_windows`` is the yardstick each form is timed against: the
same samples from one ``torch.nn.functional.grid_sample`` call on a 5-D
volume of every (view, illumination, level) plane. Nothing in the engine
calls it.
"""

from __future__ import annotations

import argparse
import functools
import json
import math
import os
import sys
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

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


def edge_windows(scene, n_windows: int = 2048, seed: int = 0):
    """Windows whose lattices reach every edge case of the tap origin
    and fractions, beside ordinary ones: every third window takes the
    next of ``edge_cases`` on its level (w, h): NaN, +-inf and -0.0
    coordinates, negative ones, ones on integers, on w - 2 and h - 2 and
    past them, next to integers, denormal, and past int32. The others lie
    inside their level at random. Views, levels and lattices are drawn
    with numpy from `seed`. Returns idx, lvl [B] int32, tl, dx, dy [B, 2]
    f32 on the scene's device."""
    rng = np.random.default_rng(seed)
    B = n_windows
    idx = rng.integers(0, scene.n_images, B)
    lvl = rng.integers(0, len(scene.offsets), B)
    w = np.asarray(scene.widths, np.float32)[lvl]
    h = np.asarray(scene.heights, np.float32)[lvl]
    tl = np.stack([rng.uniform(0, w - 1), rng.uniform(0, h - 1)], 1).astype(np.float32)
    step = rng.uniform(-1.5, 1.5, (B, 2, 2)).astype(np.float32)
    dx, dy = step[:, 0].copy(), step[:, 1].copy()
    for b in range(0, B, 3):
        cases = edge_cases(float(w[b]), float(h[b]))
        tl[b], dx[b], dy[b] = cases[(b // 3) % len(cases)]
    as_t = lambda a, t: torch.as_tensor(np.ascontiguousarray(a), dtype=t,  # noqa: E731
                                        device=scene.device)
    return (as_t(idx, torch.int32), as_t(lvl, torch.int32), as_t(tl, torch.float32),
            as_t(dx, torch.float32), as_t(dy, torch.float32))


def edge_cases(w: float, h: float):
    """(tl, dx, dy) of each edge case of ``edge_windows`` on a level of
    w x h pixels."""
    inf, nan = float("inf"), float("nan")
    below5 = float(np.nextafter(np.float32(5), np.float32(0)))
    ex, ey = (1.0, 0.0), (0.0, 1.0)  # unit steps: every sample on the grid of tl
    return (
        ((nan, 10.0), ex, ey), ((10.0, nan), ex, ey),
        ((inf, 5.0), ex, ey), ((-inf, 5.0), ex, ey), ((5.0, inf), ex, (0.0, -inf)),
        ((-3.7, -2.2), ex, ey),                          # negative, crossing 0
        ((3.0, 4.0), ex, ey),                            # on integers
        ((w - 5, h - 5), ex, ey),                        # integers up to and past w - 2
        ((w - 2, h - 2), (0.5, 0.0), (0.0, 0.5)),        # from w - 2 outwards
        ((w - 2.25, h - 1.5), (0.25, 0.5), (-0.5, 0.25)),
        ((below5, below5), ex, ey),                      # one ulp below integers
        ((3e9, -3e9), (1e30, 0.0), (0.0, -1e30)),        # past int32
        ((1e-45, -1e-45), (1e-45, 0.0), (0.0, 1e-45)),   # denormal
        ((-0.0, -0.0), (-0.0, 0.0), (0.0, -0.0)),
        ((4.0, 4.0), (inf, 0.0), (0.0, nan)),            # inf * 0 at i = 0
        ((w / 2, h / 2), (-1.0, -1.0), (-1.0, 1.0)),     # walking off the top left
    )


@functools.lru_cache(maxsize=2)
def _volume(planes: torch.Tensor, offsets, widths, heights, luma: bool) -> torch.Tensor:
    n, n_illums = planes.shape[:2]
    W0, H0 = widths[0], heights[0]
    slices = []
    for o, w, h in zip(offsets, widths, heights):
        lv = planes[:, :, o:o + w * h]
        lv = ((lv & 0xFF).to(torch.float32).unsqueeze(-1) if luma else lv)
        lv = lv.reshape(n * n_illums, h, w, -1).permute(0, 3, 1, 2)
        slices.append(F.pad(lv, (0, W0 - w, 0, H0 - h), mode="replicate"))
    vol = torch.stack(slices, 1)  # [n * I, L, C, H0, W0]
    return vol.flatten(0, 1).transpose(0, 1).unsqueeze(0).contiguous()


def level_volume(scene, luma: bool = False) -> torch.Tensor:
    """[1, C, n * I * L, H0, W0] f32 volume of every plane of the scene:
    slice (v * I + i) * L + l holds view v's level l under illumination
    i, replicate-padded from its w x h to level 0's W0 x H0, so a sample
    past its level's edge reads the edge pixel, as the plain sampler's
    clamped taps do. RGB reads ``Scene.planes`` (C = 3), luma the low
    byte of ``Scene.planes_luma_quad``, each pixel's own u8 luma (C = 1).
    Built once per (planes, luma) and cached."""
    planes = scene.planes_luma_quad if luma else scene.planes
    return _volume(planes, tuple(scene.offsets), tuple(scene.widths),
                   tuple(scene.heights), luma)


def library_grid(scene, idx, lvl, tl, dx, dy, wsize: int, volume: torch.Tensor,
                 illum: int = 0) -> torch.Tensor:
    """The [1, B, S, 1, 3] grid of the windows' lattices in `volume`:
    x, y normalised over level 0's size and z at the (view, illum,
    level) slice, for ``grid_sample`` with align_corners=True."""
    D, H0, W0 = volume.shape[2:]
    B, S = idx.shape[0], wsize * wsize
    gx, gy = cuda_ncc.lattice(tl, dx, dy, wsize)
    z = ((idx.long() * scene.n_illums + illum) * len(scene.offsets) + lvl.long())
    zn = (z.to(torch.float32) * (2.0 / max(D - 1, 1)) - 1.0).unsqueeze(1).expand(B, S)
    grid = torch.stack([gx * (2.0 / (W0 - 1)) - 1.0, gy * (2.0 / (H0 - 1)) - 1.0, zn], -1)
    return grid.view(1, B, S, 1, 3)


def library_sample(volume: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """The one ``grid_sample`` call: [1, C, B, S, 1] samples."""
    return F.grid_sample(volume, grid, mode="bilinear", padding_mode="border",
                         align_corners=True)


def library_windows(scene, idx, lvl, tl, dx, dy, wsize: int, luma: bool = False,
                    volume: Optional[torch.Tensor] = None, illum: int = 0) -> torch.Tensor:
    """What ``cuda_ncc.sample_windows_plain`` (or ``_luma_plain`` with
    `luma`) computes, in its [B, C * S] layout, through one
    ``grid_sample`` call on ``level_volume(scene, luma)`` (or `volume`).
    The coordinates' normalise / unnormalise round trip moves a sample
    by about 1e-4 px, so the two agree within 0.02 on the 0-255 scale
    (a few 1e-4 on the plane's textures), not bit for bit."""
    vol = level_volume(scene, luma) if volume is None else volume
    grid = library_grid(scene, idx, lvl, tl, dx, dy, wsize, vol, illum)
    out = library_sample(vol, grid)[0, ..., 0]  # [C, B, S]
    return out.permute(1, 0, 2).reshape(idx.shape[0], -1)


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
             "ms": None, "call_ms": None, "plain_ms": None, "msamples_per_s": None,
             "library_ms": None, "library_call_ms": None, "library_max_abs_err": None}
        if not ablate:  # the yardstick computes the unablated samples
            vol = level_volume(sc, luma)
            lib = library_windows(sc, *args, WSIZE, luma=luma, volume=vol)
            both = torch.isfinite(lib) & torch.isfinite(out_k)
            r["library_max_abs_err"] = float((lib - out_k).abs()[both].max())
            del lib
        if on_card:
            r["ms"] = cuda_time_ms(kern, reps)
            r["call_ms"] = cuda_time_ms(kern, reps, hold=False)
            r["plain_ms"] = cuda_time_ms(plain, reps)
            r["msamples_per_s"] = n_windows * S / r["ms"] / 1e3
            if not ablate:
                grid = library_grid(sc, *args, WSIZE, vol)
                r["library_ms"] = cuda_time_ms(lambda: library_sample(vol, grid), reps)
                r["library_call_ms"] = cuda_time_ms(lambda: library_windows(
                    sc, *args, WSIZE, luma=luma, volume=vol), reps)
                del grid
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
              f"grid_sample {r['library_ms']} ms, bit-equal {r['bitwise_equal_plain']}",
              file=sys.stderr)
        if r["msamples_per_s"] is not None:
            print(f"{key}={r['msamples_per_s']:.2f}")
    print(json.dumps(rec))
    return 0 if all(rec[m]["bitwise_equal_plain"] for m in ("luma", "rgb")) else 1


if __name__ == "__main__":
    raise SystemExit(main())
