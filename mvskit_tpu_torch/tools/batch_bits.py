"""Whether a row keeps its bits when its batch is cut into blocks.

The dp axis (``parallel/shard.deal_rows``) runs each stage on blocks of
the rows the unsharded stage runs as one batch, and must give the same
bits. A library kernel may round a row differently when the batch
around it has another length or start (another tile shape, vector loop
or reduction order), so a block starts at a multiple of
``shard.DP_GRAIN`` for its device. This tool measures that property on
the functions the dp stages run (NCC scoring, the view-list
projection, the depth product, the reference-view pick, the quadric
residual, the angle check, the per-view units) and on the [6, B]
column sum of the weighted NCC: for each cut of a batch of plane
patches it counts the outputs whose bits differ from the whole batch's.

Cuts: ``half``, ``quarter``, ``grain`` (blocks of the device's
DP_GRAIN), ``grain_ragged`` (a block of 1.5 grains), ``ragged3`` (three
blocks of a third), ``tiny`` (7 rows and 1 row).

    python -m mvskit_tpu_torch.tools.batch_bits [--device cuda] \\
        [--points 16384] [--views 16] [--width 640] [--height 480]

It prints one JSON line: {function: {cut: [differing outputs, max
|difference|]}}, with the device's name.
"""

from __future__ import annotations

import argparse
import json
import math


def cuts(B: int, grain: int):
    """The block lists of each cut of a batch of B rows."""
    third = B // 3
    return {
        "half": [(0, B // 2), (B // 2, B)],
        "quarter": [(i * B // 4, (i + 1) * B // 4) for i in range(4)],
        "grain": [(s, min(s + grain, B)) for s in range(0, min(4 * grain, B), grain)],
        "grain_ragged": [(grain, min(grain + grain + grain // 2, B))],
        "ragged3": [(0, third), (third, 2 * third), (2 * third, B)],
        "tiny": [(0, 7), (7, 8)],
    }


def run(points: int = 16384, views: int = 16, width: int = 640, height: int = 480,
        device="cuda") -> dict:
    import torch

    from ..core import patches as pt
    from ..device import get_device
    from ..geometry import camera as cam
    from ..ops import ncc
    from ..parallel import shard as sh
    from ..pipeline import filters as fl
    from ..pipeline import views as vw
    from ..utils import synthetic

    dev = get_device(str(device))
    a1 = math.radians(60.0)
    Ps, _, scene = synthetic.plane_scene(n_views=views, width=width, height=height,
                                         max_level=4, device=dev)
    c_np, n_np = synthetic.plane_points(Ps, points, seed=1, extent=0.8)
    coord = torch.as_tensor(c_np, dtype=torch.float32, device=dev)
    normal = torch.as_tensor(n_np, dtype=torch.float32, device=dev)
    B = coord.shape[0]
    images = vw.add_images(scene, coord, normal,
                           torch.full((B, views), -1, dtype=torch.int32, device=dev), 1, a1)
    images = vw.sort_images(scene, coord, normal, images, 1, is_fixed=False)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    nbrs = torch.randint(0, B, (B, 48), generator=gen, device=dev).to(torch.int32)
    nbrs[:, 40:] = -1
    table = pt.from_numpy(c_np, n_np, images.cpu().numpy(), B, views, device=dev)
    terms = torch.rand((6, B), generator=gen, device=dev)
    fns = {
        "compute_patch_ncc": lambda s, e: ncc.compute_patch_ncc(
            scene, images[s:e, :6], coord[s:e], normal[s:e], 1, 7, 6, a1),
        "set_ref_image": lambda s, e: vw.set_ref_image(
            scene, coord[s:e], normal[s:e], images[s:e], 1, 7, a1),
        "project_xy_lists": lambda s, e: cam.project_xy_lists(
            scene.cams, images[s:e].clamp(min=0), coord[s:e], 1)[0],
        "depth_product": lambda s, e: coord[s:e] @ scene.cams.oaxis.T,
        "quad_residuals": lambda s, e: fl.quad_residuals_batch(
            scene, table, coord[s:e], normal[s:e], images[s:e], nbrs[s:e], 1, 6)[0],
        "check_angles": lambda s, e: vw.check_angles(scene, coord[s:e], images[s:e], 0.1, 1.0),
        "compute_units": lambda s, e: ncc.compute_units(
            scene, images[s:e], coord[s:e], normal[s:e], 1),
        "column_sum_6xB": lambda s, e: terms[:, s:e].sum(0),
    }
    out = {}
    for name, f in fns.items():
        full = f(0, B)
        rec = {}
        for cut, blocks in cuts(B, sh.dp_grain([dev])).items():
            bad, worst = 0, 0.0
            for s, e in blocks:
                part, ref = f(s, e), full[s:e]
                same = part == ref
                if part.dtype.is_floating_point:
                    same |= torch.isnan(part) & torch.isnan(ref)
                    diff = (part - ref).abs()[~same]
                    diff = diff[torch.isfinite(diff)]
                    if diff.numel():
                        worst = max(worst, float(diff.max()))
                bad += int((~same).sum())
            rec[cut] = [bad, worst]
        out[name] = rec
    return {"device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
            "points": B, "views": views, "grain": sh.dp_grain([dev]), "differing": out}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m mvskit_tpu_torch.tools.batch_bits")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--points", type=int, default=16384)
    ap.add_argument("--views", type=int, default=16)
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--height", type=int, default=480)
    args = ap.parse_args(argv)
    print(json.dumps(run(args.points, args.views, args.width, args.height, args.device)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
