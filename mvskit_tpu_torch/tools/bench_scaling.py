"""Sharded programs at k logical shards (port of ``tools/bench_scaling.py``).

Runs the port's three parallel axes at k = 1, 2, 4 shards on one device
type, each shard a copy of the same device (``[cuda:0] * k`` on one
card, ``[cpu] * k`` on the host):

  * dp   — ``propagate_round`` with the gauntlet's chunks dealt to k
           devices;
  * tile — ``parallel/tiles.tiled_propagate_round`` over k row tiles;
  * view — ``compute_patch_ncc`` on the scene view-sharded k ways.

For each k it records whether the outputs equal the k = 1 run bit for
bit and the seconds per step (host clock around work that ends in a
device synchronize; the best of ``--reps``). The shards share one
device, so the seconds measure what sharding costs there (extra
launches, compaction, syncs), not scaling across devices.

    python -m mvskit_tpu_torch.tools.bench_scaling [--device cuda] \\
        [--out SCALING_torch.json]

It writes its record to ``--out`` (default ``SCALING_torch.json`` in
the working directory; the JAX package's ``SCALING.json`` is not
touched).
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time

NOTE = ("k logical shards on one device: the seconds are the overhead of "
        "the sharded programs there, not a scaling measurement")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="bench_scaling")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--rows", type=int, default=4096)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--views", type=int, default=8)
    ap.add_argument("--donor-budget", type=int, default=1024)
    ap.add_argument("--shards", default="1,2,4")
    ap.add_argument("--out", default="SCALING_torch.json")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from ..core import patches as pt
    from ..device import get_device
    from ..ops import ncc as nccops
    from ..parallel import shard as sh
    from ..parallel import tiles
    from ..pipeline import propagate as pr
    from ..pipeline import views as vw
    from ..utils.synthetic import plane_points, plane_scene

    dev = get_device(args.device)
    shards = [int(x) for x in args.shards.split(",")]
    n_views, a1 = args.views, math.radians(60.0)
    tau = min(6, n_views)
    Ps, _, scene = plane_scene(n_views=n_views, width=320, height=240, max_level=4,
                               device=dev)
    n_seed = min(args.rows // 2, 2048)
    coord_np, normal_np = plane_points(Ps, n_seed, extent=0.8)
    coord = torch.as_tensor(coord_np, dtype=torch.float32, device=dev)
    normal = torch.as_tensor(normal_np, dtype=torch.float32, device=dev)
    views = torch.as_tensor(np.tile(np.arange(n_views, dtype=np.int32), (n_seed, 1)),
                            device=dev)
    images = vw.sort_images(scene, coord, normal, views, 1, is_fixed=False)
    dscale, ascale = vw.set_scales(scene, coord, images, 1, tau, 7)
    ncc0 = nccops.compute_patch_ncc(scene, images, coord, normal, 1, 7, tau, a1)
    table = pt.from_numpy(coord_np, normal_np, images.cpu().numpy(), args.rows, n_views,
                          dev, ncc=ncc0.cpu().numpy(), dscale=dscale.cpu().numpy(),
                          ascale=ascale.cpu().numpy())
    p = pr.PropagateParams(
        level=1, csize=2, wsize=7, tau=tau, min_image_num=3, cell_capacity=8,
        angle_threshold0=a1, angle_threshold1=a1,
        max_angle_threshold=math.radians(10.0), ascale=math.pi / 48.0,
        refine_rounds=4, refine_cands=4, refine_shrink=0.8,
        refine_depth_radius=4.0, refine_angle_radius=8.0,
        neighbor_threshold=0.5, donor_budget=args.donor_budget,
        chunk=args.donor_budget,
    )

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def timed(fn):
        out = fn()  # warm-up, and the output compared
        times = []
        for _ in range(args.reps):
            sync()
            t0 = time.time()
            fn()
            sync()
            times.append(time.time() - t0)
        return out, min(times)

    def round_fn(k, kind):
        def run():
            gen = torch.Generator(device=dev)
            gen.manual_seed(0)
            noise = pr.TorchNoise(gen)
            if kind == "tile":
                mesh = sh.make_mesh(k, "tile", devices=[dev] * k)
                return tiles.tiled_propagate_round(mesh, scene, table, noise, p, 1, 0.7,
                                                   0.4, row_limit=args.rows)
            return pr.propagate_round(scene, table, noise, p, 1, 0.7, 0.4,
                                      row_limit=args.rows,
                                      dp_devices=[dev] * k if k > 1 else None)
        return run

    results = {"dp_propagate": [], "tile_propagate": [], "view_ncc": []}
    for kind in ("dp", "tile"):
        ref = None
        for k in shards:
            (out, stats), sec = timed(round_fn(k, kind))
            if ref is None:
                ref = (out, stats)
            equal = stats == ref[1] and all(torch.equal(a, b) for a, b in zip(out, ref[0]))
            results[f"{kind}_propagate"].append({
                "shards": k, "seconds_per_round": sec, "hypotheses": stats.total,
                "hypotheses_per_s": stats.total / sec, "alive_after": out.n_alive(),
                "equal_to_1_shard": bool(equal)})
            print(f"{kind} {k} shards: {sec:.4f} s/round, equal {equal}", file=sys.stderr)

    B = 4096
    vc, vn = plane_points(Ps, B, extent=0.8)
    vc = torch.as_tensor(vc, dtype=torch.float32, device=dev)
    vn = torch.as_tensor(vn, dtype=torch.float32, device=dev)
    vv = torch.as_tensor(np.tile(np.arange(n_views, dtype=np.int32), (B, 1)), device=dev)
    ref = None
    for k in shards:
        if n_views % k:
            continue
        scn = scene if k == 1 else sh.enable_view_sharding(
            scene, sh.make_mesh(k, "view", devices=[dev] * k))
        got, sec = timed(lambda: nccops.compute_patch_ncc(scn, vv, vc, vn, 1, 7, tau, a1))
        if ref is None:
            ref = got
        results["view_ncc"].append({
            "shards": k, "seconds": sec, "pairs_per_s": B * tau / sec,
            "equal_to_1_shard": bool(torch.equal(got, ref))})
        print(f"view {k} shards: {sec:.4f} s", file=sys.stderr)

    card = None
    if dev.type == "cuda":
        from .e2e_run import card_line

        card = card_line()
    artifact = {"note": NOTE, "device": str(dev),
                "device_name": torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu",
                "card": card, "host_cores": os.cpu_count(), "rows": args.rows,
                "donor_budget": args.donor_budget, "results": results}
    with open(args.out, "w") as f:
        json.dump(artifact, f, indent=1)
    ok = all(r["equal_to_1_shard"] for v in results.values() for r in v)
    print(json.dumps({"wrote": args.out, "all_equal": ok, "note": NOTE}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
