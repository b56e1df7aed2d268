"""Where one refinement round's time goes (port of
``tools/bench_refine_parts.py``).

    python -m mvskit_tpu_torch.tools.bench_refine_parts [--batch 65536]
        [--reps 3] [--luma] [--group 32] [--scan LO,HI] [--device cuda]
        [--out FILE]

At the shapes of bench.py's candidate rounds (`--batch` patches x tau 6
views, 7x7 windows at pyramid level 1 on the 16-view 640x480 plane) it
runs each part of a round alone, under the JAX tool's names:
  geometry         the per-view window geometry (``ncc.window_geometry``
                   over [tau, B]);
  geometry_dense   the dense-over-views geometry ``texs_for_views``
                   uses (``ncc.window_geometry_views``);
  geometry+kernel  geometry and the window sampler;
  raw_windows      ``texs_for_views`` without ``normalize_tex``;
  texs_for_views   normalized windows;
  eval_cost        normalized windows and the cost (``incc_cost``).
Each part reduces to one scalar (``value``). ``--luma`` samples
luminance, ``--group K`` repeats each of batch / K plane points K times
with a +-2e-3 depth jitter (the refinement's candidate layout), which
the sampler serves in its grouped form.

Each part records, on a card: ``ms``, its device time (CUDA events
around runs queued behind a device-side wait, the better of two medians
of `--reps`), ``call_ms`` (the same without the wait: one call as its
caller sees it), Msamples/s at ``ms``, the sampler's launches in one
call (``cuda_ncc.LAUNCHES``), and ``device_kernels``, the device
kernels (and copies) of one call in a ``utils/profiling.trace``. With
``--scan LO,HI`` it also times LO and HI chained calls (each perturbs
the depth by the last one's result, so no call can reuse another) and
reports the per-round slope of the call time. On the CPU nothing is
timed or traced. It prints ``<PART>_MS=`` (and ``SCAN_<PART>_MS=``)
lines, then the record; ``--out`` also writes it as JSON.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile

import numpy as np
import torch

from ..device import get_device
from ..geometry import camera as cam
from ..ops import cuda_ncc, ncc
from ..utils import profiling, synthetic
from .bench import A1, LEVEL, TAU, WSIZE
from .bench_kernel import cuda_time_ms

PARTS = ("geometry", "geometry_dense", "geometry+kernel", "raw_windows",
         "texs_for_views", "eval_cost")


def line_name(part: str) -> str:
    """The JAX tool's printed name of a part (``GEOMETRY_KERNEL``)."""
    return part.upper().replace("+", "_")


def part_inputs(Ps, scene, batch: int, group: int = 1, extent: float = 1.2):
    """The JAX tool's views [B, tau] (0..tau-1 for every patch), coord
    and normal [B, 4] on the plane scene (Ps, scene)."""
    if batch % group:
        raise ValueError(f"batch {batch} is not a multiple of group {group}")
    if group > 1:
        coord, normal = synthetic.plane_points(Ps, batch // group, extent=extent)
        coord = np.repeat(coord, group, axis=0)
        normal = np.repeat(normal, group, axis=0)
        coord[:, 2] += np.random.default_rng(0).uniform(-2e-3, 2e-3, coord.shape[0])
    else:
        coord, normal = synthetic.plane_points(Ps, batch, extent=extent)
    dev = scene.device
    t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)  # noqa: E731
    views = torch.arange(TAU, dtype=torch.int32, device=dev).expand(batch, TAU).contiguous()
    return views, t(coord), t(normal)


def _geometry(scene, views, coord, normal):
    """window_geometry of every (view, patch) pair, [T, B] with plane
    axes from the reference view."""
    B, T = views.shape
    ref = views[:, 0].clamp(min=0).long()
    px, py = cam.get_paxes(scene.cams, ref, coord, normal, LEVEL)
    wide = lambda x: x.unsqueeze(0).expand(T, B, 4)  # noqa: E731
    idx = views.T.clamp(min=0).long()
    tl, dx, dy, nl, valid = ncc.window_geometry(
        scene, idx, wide(coord), wide(px), wide(py), wide(normal), LEVEL, WSIZE, A1)
    return idx, tl, dx, dy, nl, valid


def _dense(scene, views, coord, normal):
    ref = views[:, 0].clamp(min=0).long()
    px, py = cam.get_paxes(scene.cams, ref, coord, normal, LEVEL)
    vt = views.T.contiguous()
    return (vt.clamp(min=0),) + ncc.window_geometry_views(
        scene, vt, coord, px, py, normal, LEVEL, WSIZE, A1)


def _geom_sum(tl, dx, dy, nl, valid):
    return tl.sum() + dx.sum() + dy.sum() + nl.sum() + valid.sum()


def parts(luma: bool, group: int):
    """{part: fn(scene, views, coord, normal) -> scalar tensor}."""
    flat = lambda x, k=(): x.reshape((-1,) + k).contiguous()  # noqa: E731

    def geometry(scene, views, coord, normal):
        return _geom_sum(*_geometry(scene, views, coord, normal)[1:])

    def geometry_dense(scene, views, coord, normal):
        return _geom_sum(*_dense(scene, views, coord, normal)[1:])

    def geometry_kernel(scene, views, coord, normal):
        idx, tl, dx, dy, nl, _ = _geometry(scene, views, coord, normal)
        out, fit = cuda_ncc.sample_windows(
            scene, flat(idx.to(torch.int32)), flat(nl.to(torch.int32)), flat(tl, (2,)),
            flat(dx, (2,)), flat(dy, (2,)), WSIZE, group=group, luma=luma)
        return (out * out).sum() + fit.sum()

    def raw_windows(scene, views, coord, normal):
        idx, tl, dx, dy, nl, valid = _dense(scene, views, coord, normal)
        tex, fit, _ = ncc.sample_windows_raw(scene, idx, tl, dx, dy, nl, WSIZE, 0, luma,
                                             group)
        return tex.sum() + fit.sum() + valid.sum()

    def texs(scene, views, coord, normal):
        tex, valid = ncc.texs_for_views(scene, views, coord, normal, LEVEL, WSIZE, A1,
                                        luma=luma, group=group)
        return (tex * tex).sum() + valid.sum()

    def eval_cost(scene, views, coord, normal):
        tex, valid = ncc.texs_for_views(scene, views, coord, normal, LEVEL, WSIZE, A1,
                                        luma=luma, group=group)
        return ncc.incc_cost(tex, valid, 3).sum()

    return dict(zip(PARTS, (geometry, geometry_dense, geometry_kernel, raw_windows, texs,
                            eval_cost)))


def chain(fn, scene, views, coord, normal, n: int):
    """n calls of fn, each on the depths moved by the last one's result
    (so no call reuses another's work). Returns the last result."""
    carry = torch.zeros((), dtype=torch.float32, device=coord.device)
    for _ in range(n):
        c = coord.clone()
        c[:, 2] += carry * 1e-6
        carry = fn(scene, views, c, normal) * 1e-9
    return carry


def device_kernels(fn) -> int:
    """The device kernels (and copies) one call of fn runs, counted in
    a ``utils/profiling.trace``."""
    with tempfile.TemporaryDirectory(prefix="mvskit_parts_") as td:
        with profiling.trace(td) as prof:
            fn()
            torch.cuda.synchronize()
    return sum(1 for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA)


def _better_of_two(fn, reps: int, hold: bool) -> float:
    return min(cuda_time_ms(fn, reps, hold=hold) for _ in range(2))


def run(batch: int = 65536, reps: int = 3, luma: bool = False, group: int = 1, scan=None,
        device="cuda", n_views: int = 16, width: int = 640, height: int = 480,
        extent: float = 1.2, scene=None):
    """Every part at `batch` x tau windows on the plane of n_views x
    width x height (or on `scene`, a (Ps, Scene) pair of
    ``bench_kernel.bench_scene``). `scan` is (LO, HI) or None. Returns
    the record."""
    from .bench_kernel import bench_scene
    from .e2e_run import card_line

    dev = get_device(str(device)) if scene is None else scene[1].device
    on_card = dev.type == "cuda"
    Ps, sc = scene if scene is not None else bench_scene(dev, n_views, width, height)
    views, coord, normal = part_inputs(Ps, sc, batch, group, extent)
    S = WSIZE * WSIZE
    windows = batch * TAU
    rec = {"batch": batch, "tau": TAU, "windows": windows, "wsize": WSIZE, "level": LEVEL,
           "luma": luma, "group": group, "reps": reps, "scan": list(scan) if scan else None,
           "scene": [sc.n_images, sc.widths[0], sc.heights[0]],
           "device": torch.cuda.get_device_name(dev) if on_card else "cpu",
           "card": card_line() if on_card else None, "parts": {}, "scan_parts": {}}
    for name, fn in parts(luma, group).items():
        one = lambda fn=fn: fn(sc, views, coord, normal)  # noqa: E731
        profiling.COUNTERS.reset()
        value = float(one())
        p = {"value": value, "launches": {k: v for k, v in cuda_ncc.LAUNCHES.items() if v},
             "ms": None, "call_ms": None, "msamples_per_s": None, "device_kernels": None}
        if on_card:
            p["ms"] = _better_of_two(one, reps, hold=True)
            p["call_ms"] = _better_of_two(one, reps, hold=False)
            p["msamples_per_s"] = windows * S / p["ms"] / 1e3
            p["device_kernels"] = device_kernels(one)
        rec["parts"][name] = p
        if scan:
            lo, hi = scan
            runs = {n: (lambda n=n, fn=fn: chain(fn, sc, views, coord, normal, n))
                    for n in (lo, hi)}
            s = {"value_hi": float(runs[hi]()), "ms_lo": None, "ms_hi": None,
                 "ms_per_round": None, "msamples_per_s": None}
            if on_card:
                s["ms_lo"] = _better_of_two(runs[lo], reps, hold=False)
                s["ms_hi"] = _better_of_two(runs[hi], reps, hold=False)
                s["ms_per_round"] = max(1e-9, s["ms_hi"] - s["ms_lo"]) / (hi - lo)
                s["msamples_per_s"] = windows * S / s["ms_per_round"] / 1e3
            rec["scan_parts"][name] = s
    return rec


def _fmt(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m mvskit_tpu_torch.tools.bench_refine_parts")
    ap.add_argument("--batch", type=int, default=65536, help="patches (x tau 6 windows)")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--luma", action="store_true", help="sample luminance")
    ap.add_argument("--group", type=int, default=1, help="candidates per patch")
    ap.add_argument("--scan", default=None, metavar="LO,HI",
                    help="per-round slope of LO and HI chained calls")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="device to run on (default cuda; raises if absent)")
    ap.add_argument("--out", default=None, help="also write the record here")
    a = ap.parse_args(argv)
    scan = None
    if a.scan:
        scan = tuple(int(x) for x in a.scan.split(","))
        if len(scan) != 2 or not 0 <= scan[0] < scan[1]:
            ap.error(f"--scan wants LO,HI with 0 <= LO < HI, got {a.scan}")
    rec = run(a.batch, a.reps, a.luma, a.group, scan, a.device)
    for name, p in rec["parts"].items():
        print(f"{name}: {_fmt(p['ms'])} ms device, {_fmt(p['call_ms'])} ms a call, "
              f"{p['device_kernels']} device kernels, launches {p['launches']}",
              file=sys.stderr)
        print(f"{line_name(name)}_MS={_fmt(p['ms'])}")
    for name, s in rec["scan_parts"].items():
        print(f"SCAN_{line_name(name)}_MS={_fmt(s['ms_per_round'])}")
    print(json.dumps(rec))
    if a.out:
        with open(a.out, "w") as f:
            json.dump(rec, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
