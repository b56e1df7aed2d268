"""NCC + PatchMatch refinement throughput on one card (port of the root
``bench.py``).

    python -m mvskit_tpu_torch.tools.bench [--batch 8192] [--rounds 6]
        [--rounds-lo N] [--cands 32] [--luma] [--rgb-tail 2] [--plain]
        [--reps 5] [--seed 0] [--device cuda]

The last line of its output is one JSON object:
  {"metric": "ncc_refine_throughput", "value": N, "unit": "Msamples/s",
   "vs_baseline": N}

A "sample" is one bilinear RGB texture fetch inside the NCC objective,
the unit of work that dominates the reference's runtime (SURVEY.md
§3.3: one refinement is up to 500 evals x tau views x wsize^2 fetches):
samples = batch x rounds x cands x tau x wsize^2. The search is the
config's default, an RGB search (``luma_refine = False``). ``--luma``
searches the first rounds - ``--rgb-tail`` rounds in luminance, and the
metric then counts reference-equivalent samples: the RGB fetches the
C++ reference needs for the same number of cost evaluations.

The work is the JAX tool's: ``refine_batch`` with the config's defaults
(6 rounds x 32 candidates, shrink 0.4096, radii 4 and 8, the candidates
of a patch sampled as one group) on a 16-view 640x480 plane (pyramid
level 1, tau 6, 7x7 windows) for `--batch` plane points (extent 1.2)
that start on the plane with their true normals; their views come from
add_images -> sort_images -> set_scales at a1 = 60 degrees. The search
noise comes from a ``torch.Generator`` seeded with ``--seed``.
``--plain`` runs the sampler's plain PyTorch version on the card
(``Scene.use_kernel = False``; the JAX tool's ``BENCH_PALLAS=0``).

Timing: one warm-up call (the kernel build included), then ``--reps``
calls, each between ``torch.cuda.synchronize()`` calls and timed by CUDA
events; the median. With ``--rounds-lo N`` it also times N rounds and
reports the slope between N and ``--rounds`` rounds, which cancels the
fixed cost of a call (the JAX tool's BENCH_DIFFERENTIAL). With
``--device cpu`` the calls are timed by the host clock and the value is
the CPU's.

vs_baseline divides by the single-threaded C++ hot-loop model
(``csrc/ref_hotloop.cpp``, a copy of ``native/ref_hotloop.cpp``;
BASELINE.md), built with ``g++ -O3 -march=native`` into
``build/mvskit_tpu_torch/`` and measured on the host it runs on at
first use; the rate is cached in ``build/baseline_cpu.json``. Where the
build or the run fails, vs_baseline is null and the reason goes to
stderr.

The lines before the last give the batch, evaluations, ms per call and
median ncc; the sampler's launches by form (``cuda_ncc.LAUNCHES``) and
windows per launch in the warm-up call; peak device memory; and the
card's name and power limit.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from ..config import MVSConfig
from ..device import get_device
from ..ops import cuda_ncc
from ..pipeline import refine as rf
from ..pipeline import views as vw
from ..utils import profiling, synthetic

LEVEL, WSIZE, TAU = 1, 7, 6
A1 = math.radians(60.0)
ASCALE = math.pi / 48.0
METRIC = "ncc_refine_throughput"

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(_PKG)
_BUILD = os.path.join(REPO, "build")
BASELINE_CACHE = os.path.join(_BUILD, "baseline_cpu.json")


def cpu_baseline_msps(cache: str = BASELINE_CACHE, evals: int = 100000) -> float:
    """Msamples/s of the C++ hot-loop model on this host: read from
    `cache`, or built from ``csrc/ref_hotloop.cpp`` (g++ -O3
    -march=native), run for `evals` cost evaluations and written there."""
    if os.path.exists(cache):
        with open(cache) as f:
            return json.load(f)["msamples_per_s"]
    src = os.path.join(_PKG, "csrc", "ref_hotloop.cpp")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    exe = os.path.join(_BUILD, "mvskit_tpu_torch", f"ref_hotloop-{digest}")
    if not os.path.exists(exe):
        os.makedirs(os.path.dirname(exe), exist_ok=True)
        tmp = f"{exe}.{os.getpid()}.tmp"
        subprocess.run(["g++", "-O3", "-march=native", "-o", tmp, src],
                       check=True, capture_output=True, timeout=300)
        os.replace(tmp, exe)
    out = subprocess.run([exe, str(evals)], check=True, capture_output=True,
                         text=True, timeout=600)
    val = float(out.stdout.strip())
    os.makedirs(os.path.dirname(cache) or ".", exist_ok=True)
    with open(cache, "w") as f:
        json.dump({"msamples_per_s": val, "evals": evals}, f)
    return val


def prep(scene, coord, normal, tau: int = TAU):
    """The JAX tool's prep: view 0 as the reference, add_images ->
    sort_images -> set_scales (over `tau` views). Returns (images [B, n]
    int32, dscale [B])."""
    images = torch.full((coord.shape[0], scene.n_images), -1, dtype=torch.int32,
                        device=coord.device)
    images[:, 0] = 0
    images = vw.add_images(scene, coord, normal, images, LEVEL, A1)
    images = vw.sort_images(scene, coord, normal, images, LEVEL)
    dscale, _ = vw.set_scales(scene, coord, images, LEVEL, tau, WSIZE)
    return images, dscale


def plane_inputs(Ps, scene, batch: int, extent: float = 1.2):
    """`batch` plane points (coord, normal [B, 4]) on the scene's device."""
    coord, normal = synthetic.plane_points(Ps, batch, extent=extent)
    t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=scene.device)  # noqa: E731
    return t(coord), t(normal)


def search(scene, coord, normal, images, dscale, deltas=None, generator=None, *,
           rounds: int, cands: int, luma: bool = False, rgb_tail=None, group_dma=None,
           grad_steps: int = 0):
    """``refine_batch`` as the benchmark calls it: the config's shrink,
    grouping and RGB tail unless given, radii 4 and 8; `grad_steps`
    gradient polish steps (0, the benchmark's, is off)."""
    cfg = MVSConfig()
    return rf.refine_batch(
        scene, coord, normal, images, dscale, deltas, level=LEVEL, wsize=WSIZE,
        tau=TAU, min_image_num=3, angle_threshold1=A1, ascale=ASCALE, rounds=rounds,
        n_cands=cands, shrink=cfg.refine_shrink, init_depth_radius=4.0,
        init_angle_radius=8.0, grad_steps=grad_steps, luma=luma,
        group_dma=cfg.refine_group_dma if group_dma is None else group_dma,
        rgb_tail=cfg.refine_rgb_tail if rgb_tail is None else rgb_tail,
        generator=generator)


def _call_ms(fn, reps: int, dev) -> list:
    """Milliseconds of each of `reps` calls of fn: CUDA events between
    synchronizes on a card, the host clock on the CPU."""
    times = []
    for _ in range(reps):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            torch.cuda.synchronize(dev)
            times.append(a.elapsed_time(b))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return times


def run(batch: int = 8192, rounds=None, rounds_lo=None, cands=None, luma: bool = False,
        rgb_tail=None, plain: bool = False, reps: int = 5, seed: int = 0, device="cuda",
        n_views: int = 16, width: int = 640, height: int = 480, extent: float = 1.2,
        baseline_cache: str = BASELINE_CACHE, scene=None):
    """One benchmark run on the plane of n_views x width x height (or
    on `scene`, a (Ps, Scene) pair of ``bench_kernel.bench_scene``).
    Returns (record, the warm-up call's RefineResult);
    ``record["result"]`` is the metric line."""
    from .bench_kernel import bench_scene
    from .e2e_run import card_line

    cfg = MVSConfig()
    rounds = cfg.refine_rounds if rounds is None else rounds
    cands = cfg.refine_cands if cands is None else cands
    rgb_tail = cfg.refine_rgb_tail if rgb_tail is None else rgb_tail
    if rounds_lo is not None and not 0 <= rounds_lo < rounds:
        raise ValueError(f"--rounds-lo {rounds_lo} must lie in [0, {rounds})")
    dev = get_device(str(device)) if scene is None else scene[1].device
    on_card = dev.type == "cuda"
    Ps, scene = scene if scene is not None else bench_scene(dev, n_views, width, height)
    coord, normal = plane_inputs(Ps, scene, batch, extent)
    images, dscale = prep(scene, coord, normal)
    if plain:
        scene = dataclasses.replace(scene, use_kernel=False)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def call(r):
        return search(scene, coord, normal, images, dscale, generator=gen, rounds=r,
                      cands=cands, luma=luma, rgb_tail=rgb_tail)

    if on_card:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    profiling.COUNTERS.reset()
    t0 = time.time()
    first = call(rounds)
    if on_card:
        torch.cuda.synchronize(dev)
    first_s = time.time() - t0
    launches = {k: v for k, v in cuda_ncc.LAUNCHES.items() if v}
    windows = {k: {str(b): n for b, n in sorted(cuda_ncc.WINDOWS[k].items())}
               for k in launches}
    lo = None
    if rounds_lo is not None:
        call(rounds_lo)
        lo = _call_ms(lambda: call(rounds_lo), reps, dev)
    hi = _call_ms(lambda: call(rounds), reps, dev)
    if lo is None:
        ms, evals = statistics.median(hi), rounds * cands
    else:
        ms = max(1e-9, statistics.median(hi) - statistics.median(lo))
        evals = (rounds - rounds_lo) * cands
    samples = batch * evals * TAU * WSIZE * WSIZE  # reference-equivalent RGB samples
    msps = samples / ms / 1e3
    try:
        base = cpu_baseline_msps(baseline_cache)
    except (OSError, subprocess.SubprocessError, ValueError, KeyError) as e:
        print(f"baseline failed: {e!r}", file=sys.stderr)
        base = None
    ncc = first.ncc.cpu().numpy()
    record = {
        "batch": batch, "rounds": rounds, "rounds_lo": rounds_lo, "cands": cands,
        "tau": TAU, "wsize": WSIZE, "luma": luma, "rgb_tail": rgb_tail if luma else None,
        "plain": plain, "seed": seed, "reps": reps,
        "scene": [scene.n_images, scene.widths[0], scene.heights[0]],
        "evals_per_patch": evals, "samples": samples,
        "ms": ms, "ms_per_call": statistics.median(hi), "ms_runs": hi, "ms_lo_runs": lo,
        "first_call_s": first_s, "median_ncc": float(np.median(ncc)),
        "launches": launches, "windows_per_launch": windows,
        "peak_mem_gib": torch.cuda.max_memory_allocated(dev) / 2**30 if on_card else None,
        "device": torch.cuda.get_device_name(dev) if on_card else "cpu",
        "card": card_line() if on_card else None,
        "timer": "cuda events" if on_card else "host clock",
        "baseline_msps": base,
        "result": {"metric": METRIC, "value": msps, "unit": "Msamples/s",
                   "vs_baseline": msps / base if base else None},
    }
    return record, first


def build_parser() -> argparse.ArgumentParser:
    cfg = MVSConfig()
    ap = argparse.ArgumentParser(prog="python -m mvskit_tpu_torch.tools.bench")
    ap.add_argument("--batch", type=int, default=8192)
    ap.add_argument("--rounds", type=int, default=cfg.refine_rounds)
    ap.add_argument("--rounds-lo", type=int, default=None,
                    help="also time this many rounds and report the slope")
    ap.add_argument("--cands", type=int, default=cfg.refine_cands)
    ap.add_argument("--luma", action="store_true", help="luminance search, RGB tail")
    ap.add_argument("--rgb-tail", type=int, default=cfg.refine_rgb_tail)
    ap.add_argument("--plain", action="store_true",
                    help="the sampler's plain PyTorch version instead of its kernel")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="device to run on (default cuda; raises if absent)")
    return ap


def main(argv=None) -> int:
    a = build_parser().parse_args(argv)
    rec, _ = run(a.batch, a.rounds, a.rounds_lo, a.cands, a.luma, a.rgb_tail, a.plain,
                 a.reps, a.seed, a.device)
    print(f"batch {rec['batch']}, {rec['evals_per_patch']} evals/patch, "
          f"{rec['ms']:.3f} ms ({rec['timer']}, median of {rec['reps']}) -> "
          f"{rec['result']['value']:.1f} Msamples/s (median ncc {rec['median_ncc']:.4f}, "
          f"first call {rec['first_call_s']:.2f} s)")
    print("launches " + json.dumps(rec["launches"]))
    print("windows per launch " + json.dumps(rec["windows_per_launch"]))
    print(f"peak memory GiB {rec['peak_mem_gib']}, CPU baseline {rec['baseline_msps']} "
          "Msamples/s")
    print(json.dumps({k: v for k, v in rec.items() if k != "result"}))
    print(rec["card"] or "card: none")
    print(json.dumps(rec["result"]))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
