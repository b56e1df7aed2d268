"""Luma-vs-RGB refinement search on the occluding sphere scene (port of
``tools/ab_luma.py``).

    python -m mvskit_tpu_torch.tools.ab_luma [--batch 512] [--nillums 2]
        [--device cuda] [--out LUMA_AB_torch.json]

Luminance NCC is blind to chroma-only texture, so the JAX tool compared
the luma search with the RGB search on the sphere-on-plane geometry
(8 views, 160x120), once with one illumination and once with
`--nillums`, where the texture and occlusion differ from the plane's.
Both arms run the config's schedule (6 rounds x 32 candidates, grouped)
from the same perturbed starts (3 dscale along the reference ray, the
normal tilted by 0.27 x N(0, 1) from ``RandomState(3)``) with the same
noise (a ``torch.Generator`` seeded 0); the luma arm searches every
round in luminance, and both score the final pose in RGB, so the
comparison isolates the argmin's signal. The points are
``visible_surface_points(seed=11)``. It reports the distance to the
analytic surface and the final NCC over patches with a reference view,
under the JAX record's keys (LUMA_AB.json), adds the device and the
card's name and power limit, and writes the record to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

from ..config import MVSConfig
from ..device import get_device
from ..pipeline import refine as rf
from ..utils import synthetic
from .ab_refine_chip import perturbed_starts, torch_deltas
from .bench import A1, LEVEL, REPO, TAU, WSIZE, prep

N_VIEWS, WIDTH, HEIGHT = 8, 160, 120


def run(batch: int = 512, nillums: int = 2, device="cuda", draw=None):
    """Both arms on the sphere with 1 and `nillums` illuminations.
    `draw(rounds, B, n_cands, seed)` gives the search noise (default
    ``ab_refine_chip.torch_deltas``). Returns (record, {(scene tag, arm):
    RefineResult}, {scene tag: inputs}), inputs holding the scene,
    start, start_n, images, dscale and ok."""
    from .e2e_run import card_line

    cfg = MVSConfig()
    dev = get_device(str(device))
    on_card = dev.type == "cuda"
    draw = draw or torch_deltas(dev)
    out = {"batch": batch, "scenes": {}}
    results, inputs = {}, {}
    for tag, n_il in (("sphere", 1), (f"sphere_illum{nillums}", nillums)):
        Ps, _, scene = synthetic.sphere_scene(n_views=N_VIEWS, width=WIDTH, height=HEIGHT,
                                              nillums=n_il, device=dev)
        coord, normal = synthetic.visible_surface_points(
            Ps, 3 * batch, geometry="sphere", seed=11, width=WIDTH, height=HEIGHT)
        t = lambda a: torch.as_tensor(a[:batch], dtype=torch.float32, device=dev)  # noqa: E731
        coord, normal = t(coord), t(normal)
        n = coord.shape[0]
        images, dscale = prep(scene, coord, normal)
        ok = (images[:, 0] >= 0).cpu().numpy()
        start, start_n = perturbed_starts(scene, coord, normal, images, dscale, 3)
        inputs[tag] = dict(scene=scene, start=start, start_n=start_n, images=images,
                           dscale=dscale, ok=ok)
        res_scene = {}
        for name, luma in (("rgb_search", False), ("luma_search", True)):
            res = rf.refine_batch(
                scene, start, start_n, images, dscale,
                draw(cfg.refine_rounds, n, cfg.refine_cands, 0), level=LEVEL, wsize=WSIZE,
                tau=TAU, min_image_num=3, angle_threshold1=A1, ascale=cfg.ascale,
                rounds=cfg.refine_rounds, n_cands=cfg.refine_cands,
                shrink=cfg.refine_shrink, init_depth_radius=cfg.refine_init_depth_radius,
                init_angle_radius=cfg.refine_init_angle_radius, luma=luma,
                n_illums=n_il)
            results[tag, name] = res
            err = synthetic.surface_distance(res.coord.cpu().numpy()[ok, :3], "sphere")
            res_scene[name] = {
                "err_median": float(np.median(err)),
                "err_mean": float(np.mean(err)),
                "frac_err_lt_0.05": float((err < 0.05).mean()),
                "ncc_median": float(np.median(res.ncc.cpu().numpy()[ok])),
            }
            print(tag, name, res_scene[name], file=sys.stderr)
        out["scenes"][tag] = res_scene
    out["device"] = torch.cuda.get_device_name(dev) if on_card else "cpu"
    out["card"] = card_line() if on_card else None
    return out, results, inputs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m mvskit_tpu_torch.tools.ab_luma")
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--nillums", type=int, default=2)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="device to run on (default cuda; raises if absent)")
    ap.add_argument("--out", default=os.path.join(REPO, "LUMA_AB_torch.json"))
    a = ap.parse_args(argv)
    rec, _, _ = run(a.batch, a.nillums, a.device)
    with open(a.out, "w") as f:
        json.dump(rec, f, indent=1)
    print(json.dumps(rec))
    print(f"wrote {a.out}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
