"""End-to-end pipeline run with a JSON record (port of ``tools/e2e_run.py``).

Runs the whole reconstruction (seed -> N x {propagate; snapshot; filter;
anneal; snapshot} -> final cloud; reference pmmvps/pmmvps.cpp:76-114)
on a synthetic dataset of the dinoSparseRing shape (16 views, 640x480,
BASELINE.json config 1) through the port's driver, and records stage
seconds (host clock around work that ends in a device synchronize),
hypotheses/s, alive counts per iteration, filter kills and the quality
against the analytic plane or sphere in ``E2E_<tag>.json``, written to
``--out`` (default: inside ``--prefix``, never over a committed
``E2E_r*.json`` record of the JAX package).

    python -m mvskit_tpu_torch.tools.e2e_run --tag torch_plane
    python -m mvskit_tpu_torch.tools.e2e_run --geometry sphere --nillums 2 \\
        --tag torch_sphere --out E2E_torch_sphere.json
    python -m mvskit_tpu_torch.tools.e2e_run --device cpu --views 6 \\
        --width 160 --height 120 --seeds 256 --max-patches 16384 --tag smoke

The JSON keeps the JAX tool's field names; ``backend`` is the torch
device type, ``device_name`` / ``card`` name the card where there is
one, and ``peak_mem_gib`` is the device's peak allocation.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile
import time


def build_parser() -> argparse.ArgumentParser:
    from ..cli import parse_mesh

    ap = argparse.ArgumentParser(prog="e2e_run")
    ap.add_argument("--prefix", default=os.path.join(tempfile.gettempdir(), "mvskit_torch_e2e"),
                    help="dataset directory (written there unless present)")
    ap.add_argument("--tag", default="run")
    ap.add_argument("--out", default=None,
                    help="JSON path (default <prefix>/E2E_<tag>.json)")
    ap.add_argument("--views", type=int, default=16)
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--height", type=int, default=480)
    ap.add_argument("--seeds", type=int, default=4096)
    ap.add_argument("--iterations", type=int, default=3)
    ap.add_argument("--prop-rounds", type=int, default=None)
    ap.add_argument("--max-patches", type=int, default=1 << 18)
    ap.add_argument("--donor-budget", type=int, default=None)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="device to run on (default cuda; raises if absent)")
    ap.add_argument("--fresh-dataset", action="store_true")
    ap.add_argument("--geometry", default="plane", choices=("plane", "sphere"))
    ap.add_argument("--nillums", type=int, default=1)
    ap.add_argument("--strategy", default=None, choices=("pm_image", "pmvs"))
    ap.add_argument("--luma-refine", type=int, default=None,
                    help="override config.luma_refine (1/0)")
    ap.add_argument("--mesh", default=None, type=parse_mesh, metavar="DP,VIEW,TILE",
                    help="device mesh shape (see the CLI's --mesh)")
    return ap


def quality(cloud, geometry: str, views: int, width: int, height: int) -> dict:
    """Quality at 0.05 against the analytic surface (JAX e2e_run.py:
    177-202): accuracy / completeness, plus for the sphere the exact
    surface distances and for the plane its RMS."""
    import numpy as np

    from ..utils import metrics, synthetic

    if geometry == "sphere":
        Ps = synthetic.sphere_cameras(views, width, height)
        gt, _ = synthetic.visible_surface_points(Ps, 40000, geometry="sphere", seed=97,
                                                 width=width, height=height)
        m = metrics.accuracy_completeness(cloud, gt[:, :3], threshold=0.05)
        dist = synthetic.surface_distance(cloud, "sphere")
        m["surface_dist_median"] = float(np.median(dist))
        m["surface_frac@0.05"] = float((dist < 0.05).mean())
        m["n_off_surface@0.2"] = int((dist > 0.2).sum())
        m["n_on_sphere"] = int(((np.abs(cloud[:, 2]) > 0.05) & (dist < 0.05)).sum())
        return m
    g = np.linspace(-1.0, 1.0, 200)
    xs, ys = np.meshgrid(g, g)
    gt = np.stack([xs.ravel(), ys.ravel(), np.zeros(xs.size)], axis=1)
    m = metrics.accuracy_completeness(cloud, gt, threshold=0.05, crop_to_gt_bbox=True)
    m["plane_rms"] = metrics.plane_rms(cloud)
    return m


def card_line():
    """``nvidia-smi``'s name and power limit of the first card, or None
    where the tool is absent."""
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60, check=True)
    except FileNotFoundError:
        return None
    return res.stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import torch

    from ..config import MVSConfig
    from ..device import get_device
    from ..pipeline.driver import PMMVS
    from ..utils import synthetic

    out_path = args.out or os.path.join(args.prefix, f"E2E_{args.tag}.json")
    if re.fullmatch(r"E2E_r\d.*\.json", os.path.basename(out_path)) and os.path.exists(out_path):
        raise SystemExit(f"refusing to overwrite {out_path}, a record of the JAX package")
    dev = get_device(args.device)

    marker = os.path.join(
        args.prefix, f"dataset_{args.geometry}{args.nillums}_"
        f"{args.views}x{args.width}x{args.height}x{args.seeds}.ok")
    if args.fresh_dataset or not os.path.exists(marker):
        print(f"writing dataset at {args.prefix}...", file=sys.stderr)
        t0 = time.time()
        synthetic.write_dataset(args.prefix, n_views=args.views, width=args.width,
                                height=args.height, n_seeds=args.seeds,
                                geometry=args.geometry, nillums=args.nillums)
        with open(marker, "w") as f:
            f.write("ok\n")
        print(f"dataset written in {time.time() - t0:.1f}s", file=sys.stderr)

    cfg = MVSConfig.from_option_file(args.prefix, "option")
    cfg.n_iterations = args.iterations
    cfg.max_patches = args.max_patches
    for flag, field in (("prop_rounds", "prop_rounds"), ("donor_budget", "donor_budget"),
                        ("strategy", "strategy")):
        if getattr(args, flag) is not None:
            setattr(cfg, field, getattr(args, flag))
    if args.luma_refine is not None:
        cfg.luma_refine = bool(args.luma_refine)
    if args.mesh is not None:
        cfg.mesh_dp, cfg.mesh_view, cfg.mesh_tile = args.mesh
    print(cfg.summary(), file=sys.stderr)

    stages = []

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def stage(name, fn, **extra):
        sync()
        t0 = time.time()
        out = fn()
        sync()
        dt = time.time() - t0
        stages.append({"stage": name, "seconds": dt, **extra})
        print(f"[stage] {name}: {dt:.2f}s {extra}", file=sys.stderr)
        return out

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t_all = time.time()
    log = lambda *a: print(*a, file=sys.stderr)  # noqa: E731
    engine = stage("init(scene load + pyramids)",
                   lambda: PMMVS(cfg, device=dev, log=log), backend=dev.type)
    try:
        stage("seed", engine.seed)
        n_seeded = engine.table.n_alive()
        alive_per_iter = []
        for it in range(cfg.n_iterations):
            st = stage(f"propagate[{it}]", lambda it=it: engine.propagate(it))
            sec = stages[-1]["seconds"]
            stages[-1].update(hypotheses=st.total, accepted=st.passed,
                              hypotheses_per_s=st.total / max(sec, 1e-9))
            stage(f"snapshot[{it}] before filter", lambda it=it: engine.write_patches(
                os.path.join(args.prefix, "ply", f"refined_patches_before_refine_{it}")))
            fs = stage(f"filter[{it}]", engine.filter)
            stages[-1]["removed"] = fs._asdict()
            engine.update_threshold()
            engine.depth += 1
            stage(f"snapshot[{it}] after filter", lambda it=it: engine.write_patches(
                os.path.join(args.prefix, "ply", f"refined_patches_{it}")))
            alive_per_iter.append(engine.table.n_alive())
        stage("final write (.ply + .patch)", lambda: engine.write_patches(
            os.path.join(args.prefix, "ply", "final_patches"), export_ply=True,
            export_patch=True))
        total_s = time.time() - t_all
        data = engine.collect()
    finally:
        engine.close()

    cloud = data["coord"][:, :3]
    m = quality(cloud, args.geometry, args.views, args.width, args.height)
    prop_secs = sum(s["seconds"] for s in stages if s["stage"].startswith("propagate"))
    hyp_total = sum(s.get("hypotheses", 0) for s in stages)
    artifact = {
        "tag": args.tag,
        "backend": dev.type,
        "device_name": torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu",
        "card": card_line() if dev.type == "cuda" else None,
        "dataset": {"views": args.views, "width": args.width, "height": args.height,
                    "seeds": args.seeds, "geometry": args.geometry,
                    "nillums": args.nillums},
        "config": {
            "iterations": cfg.n_iterations, "prop_rounds": cfg.prop_rounds,
            "donor_budget": cfg.donor_budget, "max_patches": cfg.max_patches,
            "level": cfg.level, "csize": cfg.csize, "wsize": cfg.wsize,
            "refine_rounds": cfg.refine_rounds, "refine_cands": cfg.refine_cands,
            "strategy": cfg.strategy, "luma_refine": cfg.luma_refine,
            "mesh": [cfg.mesh_dp, cfg.mesh_view, cfg.mesh_tile],
        },
        "total_seconds": total_s,
        "seeded": n_seeded,
        "alive_per_iter": alive_per_iter,
        "final_alive": int(cloud.shape[0]),
        "hypotheses_total": hyp_total,
        "hypotheses_per_s_overall": hyp_total / max(prop_secs, 1e-9),
        "peak_mem_gib": (torch.cuda.max_memory_allocated(dev) / 2**30
                         if dev.type == "cuda" else None),
        f"quality_vs_analytic_{args.geometry}@0.05": m,
        "stages": stages,
    }
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(artifact, f, indent=1)
    print(f"wrote {out_path}", file=sys.stderr)
    print(json.dumps({k: artifact[k] for k in (
        "tag", "backend", "total_seconds", "final_alive", "hypotheses_per_s_overall")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
