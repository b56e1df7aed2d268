"""Refinement quality by schedule, grouping and luma on the card (port of
``tools/ab_refine_chip.py``).

    python -m mvskit_tpu_torch.tools.ab_refine_chip [--batch 4096]
        [--views 16] [--width 640] [--height 480] [--device cuda]
        [--out REFINE_AB_torch.json]

The JAX tool measured, on its TPU kernel path, what the refinement
schedule, the grouped tile DMA (which drops views there: DIVERGENCES.md
A12) and the luma search do to refinement quality. Here the same six
arms run through the port's kernels: 6 x 32 grouped and ungrouped luma
(K3g, K3u), 12 x 16 grouped luma, 6 x 32 grouped RGB (K2), and 6 x 32
grouped luma with one and two RGB rounds at the end. The port's grouped
launch is bit-equal to the ungrouped one, so the two 6 x 32 luma arms
must agree bit for bit.

Each arm refines `--batch` points of the production-size plane from
perturbed starts: 3 dscale off along the reference ray, the normal
tilted by 0.27 x N(0, 1) (``RandomState(1)``). Each arm runs twice,
with noise from a ``torch.Generator`` seeded 0, then 1: the first call's
host seconds (kernel build included on the first arm) are
``compile_plus_first_seconds``, the second's ``warm_seconds``, and the
second call's result gives the quality (depth error on the z = 0 plane
over patches with a reference view). The record keeps the JAX record's
keys (REFINE_AB_CHIP.json) and adds the device and the card's name and
power limit, and whether the two 6 x 32 luma arms agreed bit for bit
(``grouped_equals_ungrouped_luma``); it is written to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from ..device import get_device
from ..pipeline import refine as rf
from .bench import A1, ASCALE, LEVEL, REPO, TAU, WSIZE, prep

ARMS = {
    "6x32_grouped_luma": dict(rounds=6, n_cands=32, shrink=0.4096, group_dma=True,
                              luma=True),
    "6x32_ungrouped_luma": dict(rounds=6, n_cands=32, shrink=0.4096, group_dma=False,
                                luma=True),
    "12x16_grouped_luma": dict(rounds=12, n_cands=16, shrink=0.64, group_dma=True,
                               luma=True),
    "6x32_grouped_rgb": dict(rounds=6, n_cands=32, shrink=0.4096, group_dma=True,
                             luma=False),
    "6x32_grouped_hybrid_tail1": dict(rounds=6, n_cands=32, shrink=0.4096, group_dma=True,
                                      luma=True, rgb_tail=1),
    "6x32_grouped_hybrid_tail2": dict(rounds=6, n_cands=32, shrink=0.4096, group_dma=True,
                                      luma=True, rgb_tail=2),
}


def torch_deltas(device):
    """The tools' noise: `(rounds, B, n_cands, seed)` -> uniform draws
    in [-1, 1) from a ``torch.Generator`` seeded with `seed`."""
    def draw(rounds, B, n_cands, seed):
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        return rf.draw_deltas(gen, rounds, B, n_cands, device)
    return draw


def perturbed_starts(scene, coord, normal, images, dscale, seed: int):
    """The JAX tools' starts: 3 dscale off along the reference ray, the
    normal tilted by 0.27 x N(0, 1) from ``RandomState(seed)``. Returns
    (start, start_n), [B, 4] each."""
    ref = images[:, 0].clamp(min=0).long()
    ray = coord - scene.cams.center[ref]
    ray = ray / torch.sqrt(torch.clamp((ray * ray).sum(-1, keepdim=True), min=1e-20))
    start = coord + (3.0 * dscale).unsqueeze(1) * ray
    B = coord.shape[0]
    tilt = normal[:, :3].cpu().numpy() + 0.27 * np.random.RandomState(seed).normal(size=(B, 3))
    tilt /= np.linalg.norm(tilt, axis=1, keepdims=True)
    start_n = torch.as_tensor(np.concatenate([tilt, np.zeros((B, 1))], 1),
                              dtype=torch.float32, device=coord.device)
    return start, start_n


def run(batch: int = 4096, n_views: int = 16, width: int = 640, height: int = 480,
        extent: float = 1.2, device="cuda", draw=None, scene=None):
    """Every arm of ARMS. `draw(rounds, B, n_cands, seed)` gives the
    search noise (default ``torch_deltas``); `scene` reuses a (Ps, Scene)
    pair of ``bench_kernel.bench_scene``. Returns (record, {arm: the
    second call's RefineResult}, inputs), inputs holding start, start_n,
    images, dscale and ok (patches with a reference view)."""
    from .bench import plane_inputs
    from .bench_kernel import bench_scene
    from .e2e_run import card_line

    dev = get_device(str(device)) if scene is None else scene[1].device
    on_card = dev.type == "cuda"
    Ps, sc = scene if scene is not None else bench_scene(dev, n_views, width, height)
    draw = draw or torch_deltas(dev)
    coord, normal = plane_inputs(Ps, sc, batch, extent)
    images, dscale = prep(sc, coord, normal)
    start, start_n = perturbed_starts(sc, coord, normal, images, dscale, 1)
    ok = (images[:, 0] >= 0).cpu().numpy()
    inputs = dict(start=start, start_n=start_n, images=images, dscale=dscale, ok=ok)

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    out = {"batch": batch, "arms": {}}
    results = {}
    for name, arm in ARMS.items():
        def call(seed, arm=arm):
            res = rf.refine_batch(
                sc, start, start_n, images, dscale,
                draw(arm["rounds"], batch, arm["n_cands"], seed), level=LEVEL, wsize=WSIZE,
                tau=TAU, min_image_num=3, angle_threshold1=A1, ascale=ASCALE,
                rounds=arm["rounds"], n_cands=arm["n_cands"], shrink=arm["shrink"],
                init_depth_radius=4.0, init_angle_radius=8.0, luma=arm["luma"],
                group_dma=arm["group_dma"], rgb_tail=arm.get("rgb_tail", 0))
            sync()
            return res

        sync()
        t0 = time.time()
        call(0)
        first = time.time() - t0
        t0 = time.time()
        res = call(1)
        warm = time.time() - t0
        results[name] = res
        z = np.abs(res.coord[:, 2].cpu().numpy()[ok])
        rec = {
            "err_median": float(np.median(z)),
            "err_mean": float(np.mean(z)),
            "frac_err_lt_0.05": float((z < 0.05).mean()),
            "ncc_median": float(np.median(res.ncc.cpu().numpy()[ok])),
            "cost_median": float(np.median(res.cost.cpu().numpy()[ok])),
            "warm_seconds": warm,
            "compile_plus_first_seconds": first,
        }
        out["arms"][name] = rec
        print(name, rec, file=sys.stderr)
    g, u = results["6x32_grouped_luma"], results["6x32_ungrouped_luma"]
    out["grouped_equals_ungrouped_luma"] = bool(
        torch.equal(g.coord, u.coord) and torch.equal(g.ncc, u.ncc))
    out["device"] = torch.cuda.get_device_name(dev) if on_card else "cpu"
    out["card"] = card_line() if on_card else None
    return out, results, inputs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m mvskit_tpu_torch.tools.ab_refine_chip")
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--views", type=int, default=16)
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--height", type=int, default=480)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="device to run on (default cuda; raises if absent)")
    ap.add_argument("--out", default=os.path.join(REPO, "REFINE_AB_torch.json"))
    a = ap.parse_args(argv)
    rec, _, _ = run(a.batch, a.views, a.width, a.height, device=a.device)
    with open(a.out, "w") as f:
        json.dump(rec, f, indent=1)
    print(json.dumps(rec))
    print(f"wrote {a.out}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
