"""Gradient-polish study (port of ``tools/ab_gradpolish.py``).

    python -m mvskit_tpu_torch.tools.ab_gradpolish [--batch 256]
        [--device cuda] [--out GRADPOLISH_torch.json]

The JAX tool compared pure random search with random search followed by
the differentiable polish (``refine_batch``'s grad_steps) at about the
same budget of forward evaluations. A polish step costs one forward and
backward through the sampler (about two forward evaluations) and one
forward for its acceptance test, so the arms are:

  A: 12 rounds x 16 candidates, no polish      (192 evaluations)
  B: 12 rounds x  8 candidates, 4 polish steps (96 + 4 x 3 = 108)
  C: 12 rounds x 16 candidates, 4 polish steps (A with the polish on top)

on the plane and the sphere (8 views, 160x120), from the JAX tool's
perturbed starts (3 dscale along the reference ray, the normal tilted by
0.27 x N(0, 1) from ``RandomState(1)``). The search noise is drawn from a
``torch.Generator`` seeded 7 (the JAX tool's PRNGKey(7) cannot be
reproduced in torch). It reports the JAX record's keys per arm (final
cost, |z| error on the plane or distance to the sphere, NCC) over the
patches with a reference view, adds the device and the card's name and
power limit, and writes the record to ``--out``. On a card the polish's
gradient goes through the window sampler's backward kernel.
GRADPOLISH.json is the JAX package's record of the same study on a CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

from ..device import get_device
from ..pipeline import refine as rf
from ..utils import synthetic
from .ab_refine_chip import perturbed_starts, torch_deltas
from .bench import A1, ASCALE, LEVEL, REPO, TAU, WSIZE, plane_inputs, prep

N_VIEWS, WIDTH, HEIGHT = 8, 160, 120
ARMS = {
    "A_random_12x16": dict(rounds=12, n_cands=16, grad_steps=0),
    "B_random_12x8_grad4": dict(rounds=12, n_cands=8, grad_steps=4),
    "C_random_12x16_grad4": dict(rounds=12, n_cands=16, grad_steps=4),
}
SHRINK, GRAD_LR = 0.64, 0.5


def scene_inputs(geometry: str, batch: int, dev):
    """The JAX tool's scene and points: (scene, coord, normal)."""
    if geometry == "plane":
        Ps, _, scene = synthetic.plane_scene(n_views=N_VIEWS, width=WIDTH, height=HEIGHT,
                                             device=dev)
        coord, normal = plane_inputs(Ps, scene, batch, extent=0.6)
        return scene, coord, normal
    Ps, _, scene = synthetic.sphere_scene(n_views=N_VIEWS, width=WIDTH, height=HEIGHT,
                                          device=dev)
    coord, normal = synthetic.visible_surface_points(
        Ps, 3 * batch, geometry="sphere", seed=5, width=WIDTH, height=HEIGHT)
    t = lambda a: torch.as_tensor(a[:batch], dtype=torch.float32, device=dev)  # noqa: E731
    return scene, t(coord), t(normal)


def run(batch: int = 256, device="cuda", draw=None):
    """Every arm on both scenes. `draw(rounds, B, n_cands, seed)` gives
    the search noise (default ``ab_refine_chip.torch_deltas``). Returns
    (record, {(geometry, arm): RefineResult}, {geometry: inputs}), inputs
    holding the scene, start, start_n, images, dscale and ok."""
    from .e2e_run import card_line

    dev = get_device(str(device))
    on_card = dev.type == "cuda"
    draw = draw or torch_deltas(dev)
    out = {"batch": batch, "scenes": {}}
    results, inputs = {}, {}
    for geometry in ("plane", "sphere"):
        scene, coord, normal = scene_inputs(geometry, batch, dev)
        n = coord.shape[0]
        images, dscale = prep(scene, coord, normal)
        ok = (images[:, 0] >= 0).cpu().numpy()
        start, start_n = perturbed_starts(scene, coord, normal, images, dscale, 1)
        inputs[geometry] = dict(scene=scene, start=start, start_n=start_n, images=images,
                                dscale=dscale, ok=ok)
        res_scene = {}
        for name, arm in ARMS.items():
            res = rf.refine_batch(
                scene, start, start_n, images, dscale,
                draw(arm["rounds"], n, arm["n_cands"], 7), level=LEVEL, wsize=WSIZE,
                tau=TAU, min_image_num=3, angle_threshold1=A1, ascale=ASCALE,
                rounds=arm["rounds"], n_cands=arm["n_cands"], shrink=SHRINK,
                init_depth_radius=4.0, init_angle_radius=8.0,
                grad_steps=arm["grad_steps"], grad_lr=GRAD_LR)
            results[geometry, name] = res
            c = res.coord.cpu().numpy()[ok, :3]
            err = np.abs(c[:, 2]) if geometry == "plane" else \
                synthetic.surface_distance(c, "sphere")
            cost = res.cost.cpu().numpy()[ok]
            res_scene[name] = {
                "evals_fwd_equiv": arm["rounds"] * arm["n_cands"] + 3 * arm["grad_steps"],
                "cost_mean": float(np.mean(cost)),
                "cost_median": float(np.median(cost)),
                "err_median": float(np.median(err)),
                "err_mean": float(np.mean(err)),
                "frac_err_lt_0.05": float((err < 0.05).mean()),
                "ncc_median": float(np.median(res.ncc.cpu().numpy()[ok])),
            }
            print(geometry, name, res_scene[name], file=sys.stderr)
        out["scenes"][geometry] = res_scene
    out["device"] = torch.cuda.get_device_name(dev) if on_card else "cpu"
    out["card"] = card_line() if on_card else None
    return out, results, inputs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m mvskit_tpu_torch.tools.ab_gradpolish")
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="device to run on (default cuda; raises if absent)")
    ap.add_argument("--out", default=os.path.join(REPO, "GRADPOLISH_torch.json"))
    a = ap.parse_args(argv)
    rec, _, _ = run(a.batch, a.device)
    with open(a.out, "w") as f:
        json.dump(rec, f, indent=1)
    print(json.dumps(rec))
    print(f"wrote {a.out}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
