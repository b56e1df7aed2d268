"""Command-line entry point of the port:

    python -m mvskit_tpu_torch <prefix> [--device cuda|cpu]
    python -m mvskit_tpu_torch <prefix> --filter-only --resume-iter 1
    python -m mvskit_tpu_torch <prefix> --device cpu --mesh 1,2,2
    python -m mvskit_tpu_torch <prefix> --trace-spans --report run.json

Same dataset directory contract and outputs as ``python -m mvskit_tpu``.
``--device`` defaults to ``cuda`` and never falls back to the CPU.
``--trace-spans`` records the program's spans and host syncs over the
run (``utils/profiling.tracing``); the report then holds their summary
under ``spans``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="mvskit_tpu_torch",
        description="PatchMatch multi-view stereo in PyTorch/CUDA",
    )
    p.add_argument("prefix", help="dataset root (contains option, image/, txt/, ply/)")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="device to run on (default cuda; raises if absent)")
    p.add_argument("--option", default="option", help="option file name")
    p.add_argument("--filter-only", action="store_true",
                   help="resume from a .patch checkpoint and run only the "
                        "filter stage (reference test_filter.cpp)")
    p.add_argument("--resume-iter", type=int, default=0,
                   help="checkpoint index ply/%%08d.patch to seed/resume from")
    p.add_argument("--iterations", type=int, default=None,
                   help="override number of outer iterations")
    p.add_argument("--prop-rounds", type=int, default=None,
                   help="override checkerboard rounds per iteration")
    p.add_argument("--no-snapshots", action="store_true",
                   help="skip intermediate PLY dumps")
    p.add_argument("--export-patch", action="store_true",
                   help="also write a final .patch checkpoint")
    p.add_argument("--out", default=None,
                   help="final output path prefix (default "
                        "<prefix>/ply/final_patches)")
    p.add_argument("--max-patches", type=int, default=None,
                   help="patch table capacity")
    p.add_argument("--donor-budget", type=int, default=None,
                   help="max donors per propagation phase")
    p.add_argument("--chunk", type=int, default=None,
                   help="gauntlet chunk size")
    p.add_argument("--refine-rounds", type=int, default=None,
                   help="random-search rounds per refinement")
    p.add_argument("--refine-cands", type=int, default=None,
                   help="candidates per refinement round")
    p.add_argument("--strategy", default=None, choices=("pm_image", "pmvs"),
                   help="propagation strategy (reference live path "
                        "pm_image, or the PMVS-style expansion)")
    p.add_argument("--mesh", default=None, type=parse_mesh, metavar="DP,VIEW,TILE",
                   help="device mesh shape, e.g. 1,2,2: dp deals the gauntlet's "
                        "chunks to devices, view shards the pyramid planes, tile "
                        "shards the cell-grid rows; on cuda it takes distinct "
                        "cards and raises where there are fewer")
    p.add_argument("--report", default=None,
                   help="write a JSON run report (stage seconds, alive "
                        "counts, filter kills) to this path")
    p.add_argument("--trace-spans", action="store_true",
                   help="record the program's spans and host syncs over the run; "
                        "the report gains their summary under 'spans' (off by default)")
    return p


def parse_mesh(spec: str):
    """DP,VIEW,TILE, each >= 1 (JAX cli.py:68-72, as an argparse type:
    a bad value is a usage error, exit 2, not a bare ValueError)."""
    try:
        parts = [int(x) for x in spec.split(",")]
    except ValueError:
        parts = []
    if len(parts) != 3 or any(x < 1 for x in parts):
        raise argparse.ArgumentTypeError(f"--mesh wants DP,VIEW,TILE >= 1, got {spec!r}")
    return parts


# flag -> MVSConfig field (the JAX CLI's overrides, cli.py:87-102)
OVERRIDES = (
    ("iterations", "n_iterations"),
    ("prop_rounds", "prop_rounds"),
    ("max_patches", "max_patches"),
    ("donor_budget", "donor_budget"),
    ("chunk", "gauntlet_chunk"),
    ("refine_rounds", "refine_rounds"),
    ("refine_cands", "refine_cands"),
    ("strategy", "strategy"),
)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from .config import MVSConfig
    from .pipeline.driver import PMMVS
    from .utils import profiling

    cfg = MVSConfig.from_option_file(args.prefix, args.option)
    for flag, field in OVERRIDES:
        if getattr(args, flag) is not None:
            setattr(cfg, field, getattr(args, flag))
    if args.mesh is not None:
        cfg.mesh_dp, cfg.mesh_view, cfg.mesh_tile = args.mesh
    print(cfg.summary(), file=sys.stderr)

    out = args.out or os.path.join(args.prefix, "ply", "final_patches")
    with (profiling.tracing() if args.trace_spans else contextlib.nullcontext()) as trace:
        engine = PMMVS(cfg, device=args.device,
                       log=lambda *a: print(*a, file=sys.stderr))
        try:
            engine.seed(resume_iter=args.resume_iter)
            if args.filter_only:
                engine.filter()
            else:
                engine.run(write_snapshots=not args.no_snapshots)
            engine.write_patches(out, export_ply=True, export_patch=args.export_patch)
        finally:
            engine.close()
    print(f"wrote {out}.ply", file=sys.stderr)
    if args.report:
        report = dict(engine.report, device=str(engine.device),
                      strategy=cfg.strategy, final_alive=engine.table.n_alive(),
                      prop_params=engine.prop_params._asdict())
        if trace is not None:
            report["spans"] = trace.summary()
        with open(args.report, "w") as f:
            json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
