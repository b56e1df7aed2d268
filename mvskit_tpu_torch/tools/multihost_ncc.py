"""One rank of the multi-process view-sharded NCC check.

    python -m mvskit_tpu_torch.tools.multihost_ncc RANK WORLD PORT OUT.json \
        [--backend gloo|nccl] [--device cpu|cuda] [--local-shards 2]

Every rank joins the process group at ``tcp://localhost:PORT`` with the
backend it is given, builds the same synthetic plane scene (WORLD x
local-shards views, 96 x 64) and patches from fixed seeds, and scores
them with ``compute_patch_ncc`` twice: on the whole scene in this process
alone, and on the scene view-sharded over the global mesh
(``parallel/multihost.enable_view_sharding_global``), where it holds only
its own views' planes and one all_reduce combines the ranks' windows.
Then it refines the patches from perturbed starts with the gradient
polish (``refine_batch`` with grad_steps, the search noise from a seeded
``torch.Generator``) on both scenes: the polish's gradient on the
sharded scene sums the ranks' shares (``multihost.sum_grads``). Each
pair must be equal, and the polish must move a patch. The rank writes
its record to OUT.json and exits 0 when all hold.
"""

from __future__ import annotations

import argparse
import json
import math
import sys


# the polished refinement of the check: a short search, then the polish
POLISH = dict(rounds=2, n_cands=4, shrink=0.64, init_depth_radius=4.0,
              init_angle_radius=8.0, grad_lr=0.5)
POLISH_STEPS = 2


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="multihost_ncc")
    ap.add_argument("rank", type=int)
    ap.add_argument("world", type=int)
    ap.add_argument("port", type=int)
    ap.add_argument("out")
    ap.add_argument("--backend", default="gloo", choices=("gloo", "nccl"))
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--local-shards", type=int, default=2)
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    import torch.distributed as dist

    from mvskit_tpu_torch import get_device
    from mvskit_tpu_torch.ops import cuda_ncc, ncc
    from mvskit_tpu_torch.parallel import multihost as mh
    from mvskit_tpu_torch.pipeline import refine as rf
    from mvskit_tpu_torch.tools.ab_refine_chip import perturbed_starts, torch_deltas
    from mvskit_tpu_torch.tools.bench import A1, ASCALE, LEVEL, WSIZE, prep
    from mvskit_tpu_torch.utils import profiling
    from mvskit_tpu_torch.utils.synthetic import plane_points, plane_scene

    dev = get_device(args.device)
    mh.init_distributed(args.backend, f"tcp://localhost:{args.port}", args.world,
                        args.rank)
    try:
        n_views = args.world * args.local_shards
        Ps, _, scene = plane_scene(n_views=n_views, width=96, height=64, max_level=4,
                                   device=dev)
        coord, normal = plane_points(Ps, 16, extent=0.6)
        coord = torch.as_tensor(coord, dtype=torch.float32, device=dev)
        normal = torch.as_tensor(normal, dtype=torch.float32, device=dev)
        views = torch.as_tensor(np.tile(np.arange(n_views, dtype=np.int32), (16, 1)),
                                device=dev)
        tau = min(6, n_views)

        def score(scn):
            return ncc.compute_patch_ncc(scn, views, coord, normal, 1, 7, tau,
                                         math.radians(60.0))

        images, dscale = prep(scene, coord, normal, tau)
        start, start_n = perturbed_starts(scene, coord, normal, images, dscale, 1)
        deltas = torch_deltas(dev)(POLISH["rounds"], coord.shape[0], POLISH["n_cands"], 7)

        def refine(scn, grad_steps=POLISH_STEPS):
            res = rf.refine_batch(scn, start, start_n, images, dscale, deltas, level=LEVEL,
                                  wsize=WSIZE, tau=tau, min_image_num=3,
                                  angle_threshold1=A1, ascale=ASCALE, grad_steps=grad_steps,
                                  **POLISH)
            return [mh.to_host_replicated(x) for x in res]

        ref = mh.to_host_replicated(score(scene))
        ref_polish, searched = refine(scene), refine(scene, 0)
        mesh = mh.global_view_mesh([dev] * args.local_shards)
        gscene = mh.enable_view_sharding_global(scene, mesh)
        profiling.COUNTERS.reset()
        got = mh.to_host_replicated(score(gscene))
        got_polish = refine(gscene)
        launches = {k: v for k, v in cuda_ncc.LAUNCHES.items() if v}
        rec = {"rank": args.rank, "processes": dist.get_world_size(),
               "backend": dist.get_backend(), "device": str(dev),
               "global_shards": mesh.size, "local_shards": len(gscene.view_shards),
               "local_plane_views": [s.scene.planes.shape[0] for s in gscene.view_shards],
               "home_plane_views": gscene.planes.shape[0],
               "launches": launches, "equal": bool(np.array_equal(got, ref)),
               "max_abs_diff": float(np.max(np.abs(got - ref))),
               "polish_equal": all(np.array_equal(a, b)
                                   for a, b in zip(got_polish, ref_polish)),
               "polish_moved": int((ref_polish[0] != searched[0]).any(1).sum())}
        with open(args.out, "w") as f:
            json.dump(rec, f)
        print(json.dumps(rec))
        return 0 if rec["equal"] and rec["polish_equal"] and rec["polish_moved"] else 1
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    sys.exit(main())
