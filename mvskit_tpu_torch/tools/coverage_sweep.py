"""Propagation-coverage sweep over the donor budget, rounds and donor
policy (port of ``tools/coverage_sweep.py``).

    python -m mvskit_tpu_torch.tools.coverage_sweep [--prefix DIR]
        [--views 16] [--width 640] [--height 480] [--seeds 4096]
        [--max-patches 262144] [--budgets 4096,16384,65536] [--rounds 4,8]
        [--policies cell_first,ncc] [--iterations 1] [--device cuda]
        [--out COVERAGE_torch.json]

The reference propagates every reference-view patch of every cell in
every sweep (reference propagate.cpp:88-121); the engine instead takes
at most ``donor_budget`` donors a checkerboard round
(``pipeline/propagate.select_donors``: per cell first, or by NCC). The
sweep measures what that costs: the pipeline at production table
capacity for each (policy, budget, rounds), and the cloud's size and
accuracy / completeness at 0.05 against the analytic plane (a 200 x 200
grid of [-1, 1]^2, cropped to its box). The dataset is written at
`--prefix` unless its marker file is there; the scene is loaded once
and shared by every configuration. Each run goes through
``PMMVS(cfg, device=...)`` without snapshots.

The artifact keeps the JAX artifact's keys (COVERAGE.json), with
``device`` and the card's name and power limit in place of ``backend``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

from .bench import REPO

NOTE = ("reference baseline = exhaustive per-cell donation "
        "(propagate.cpp:88-121); the engine's global top-budget "
        "donor selection matches it when completeness saturates "
        "as budget grows")


def dataset_marker(prefix: str, views: int, width: int, height: int, seeds: int) -> str:
    """The file that says `prefix` holds this sweep's dataset."""
    return os.path.join(prefix, f"dataset_{views}x{width}x{height}x{seeds}.ok")


def run(prefix: str, views: int = 16, width: int = 640, height: int = 480,
        seeds: int = 4096, max_patches: int = 1 << 18, budgets=(4096, 16384, 65536),
        rounds=(4, 8), policies=("cell_first", "ncc"), iterations: int = 1,
        device="cuda", log=None):
    """Every (policy, budget, rounds) configuration. Returns the
    artifact."""
    import numpy as np
    import torch

    from ..config import MVSConfig
    from ..device import get_device
    from ..pipeline.driver import PMMVS
    from ..utils import metrics, synthetic
    from .e2e_run import card_line

    log = log or (lambda *a: print(*a, file=sys.stderr))
    dev = get_device(str(device))
    marker = dataset_marker(prefix, views, width, height, seeds)
    if not os.path.exists(marker):
        log(f"writing dataset at {prefix}...")
        synthetic.write_dataset(prefix, n_views=views, width=width, height=height,
                                n_seeds=seeds)
        with open(marker, "w") as f:
            f.write("ok\n")

    g = np.linspace(-1.0, 1.0, 200)
    xs, ys = np.meshgrid(g, g)
    gt = np.stack([xs.ravel(), ys.ravel(), np.zeros(xs.size)], axis=1)

    scene = None
    runs = []
    for policy in policies:
        for budget in budgets:
            for n_rounds in rounds:
                cfg = MVSConfig.from_option_file(prefix, "option")
                cfg.n_iterations = iterations
                cfg.max_patches = max_patches
                cfg.donor_budget = budget
                cfg.prop_rounds = n_rounds
                cfg.donor_policy = policy
                t0 = time.time()
                engine = PMMVS(cfg, scene=scene, device=dev, log=log)
                try:
                    scene = engine.scene  # the pyramids, shared by every configuration
                    engine.seed()
                    engine.run(write_snapshots=False)
                    cloud = engine.collect()["coord"][:, :3]
                finally:
                    engine.close()
                dt = time.time() - t0
                m = metrics.accuracy_completeness(cloud, gt, threshold=0.05,
                                                  crop_to_gt_bbox=True)
                rec = {
                    "donor_policy": policy,
                    "donor_budget": budget,
                    "prop_rounds": n_rounds,
                    "iterations": iterations,
                    "seconds": dt,
                    "final_alive": int(cloud.shape[0]),
                    "acc_median": m["acc_median"],
                    "comp_frac@0.05": m["comp_frac"],
                    "comp_median": m["comp_median"],
                }
                runs.append(rec)
                log(json.dumps(rec))
    on_card = dev.type == "cuda"
    return {
        "dataset": {"views": views, "width": width, "height": height, "seeds": seeds},
        "max_patches": max_patches,
        "device": torch.cuda.get_device_name(dev) if on_card else "cpu",
        "card": card_line() if on_card else None,
        "note": NOTE,
        "runs": runs,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m mvskit_tpu_torch.tools.coverage_sweep")
    ap.add_argument("--prefix", default=os.path.join(tempfile.gettempdir(), "mvskit_e2e"),
                    help="dataset directory (written there unless present)")
    ap.add_argument("--views", type=int, default=16)
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--height", type=int, default=480)
    ap.add_argument("--seeds", type=int, default=4096)
    ap.add_argument("--max-patches", type=int, default=1 << 18)
    ap.add_argument("--budgets", default="4096,16384,65536")
    ap.add_argument("--rounds", default="4,8")
    ap.add_argument("--policies", default="cell_first,ncc")
    ap.add_argument("--iterations", type=int, default=1)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="device to run on (default cuda; raises if absent)")
    ap.add_argument("--out", default=os.path.join(REPO, "COVERAGE_torch.json"))
    a = ap.parse_args(argv)
    ints = lambda s: tuple(int(v) for v in s.split(","))  # noqa: E731
    artifact = run(a.prefix, a.views, a.width, a.height, a.seeds, a.max_patches,
                   ints(a.budgets), ints(a.rounds), tuple(a.policies.split(",")),
                   a.iterations, a.device)
    with open(a.out, "w") as f:
        json.dump(artifact, f, indent=1)
    print(json.dumps({"wrote": a.out}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
