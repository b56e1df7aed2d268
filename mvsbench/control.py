"""Readings of the output check on the program and on its control.

    python3 -m mvsbench.control --workload dino16.plane --seeds 11,12,13 \\
        [--mode control|program|<fault>] --out control.jsonl

For each seed, at the cell's own size, on the card. ``control`` (the
default): the scene and dataset as a run's set-up makes them, then the
engine's scene load and seeding as the window runs them (``PMMVS`` on
the dataset, ``seed()``), and the seed stage's numbers ``run.check``
compares: once for the program (its pyramids and its seeded patches'
scores against the float64 reference) and once for the control, the
reference computed in bfloat16 put in the program's place, which the
check has to reject. ``program``: every number ``run.check`` compares
after a run's set-up and one whole reconstruction. A fault's name
(``faults.py``): the same with that fault planted in the program, which
the check has to reject. One JSON line per seed. The benchmark's own
runs do not run it.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import sys
import tempfile
import time
from typing import Optional

from . import faults, run, scene


def readings(cell: dict, seed: int, device) -> dict:
    """Program and control readings of one seed."""
    import torch
    from mvskit_tpu_torch.pipeline.driver import PMMVS

    config = cell["config"]
    work = tempfile.mkdtemp(prefix="mvsbench_control_")
    try:
        prefix = os.path.join(work, "data")
        scene.write_dataset(prefix, scene.make_scene(config, cell["traffic"], seed, device),
                            config)
        engine = PMMVS(run.engine_config(prefix, config), device=device, log=run._quiet)
        try:
            engine.seed()
            seeds, planes = run.seed_rows(engine, config), engine.scene.planes
        finally:
            engine.close()
        del engine
        return {"seed": seed, "workload": cell["name"], "seeded": int(seeds["alive"].sum()),
                "program": run.reference_gaps(prefix, config, planes, seeds, device),
                "control": run.reference_gaps(prefix, config, planes, seeds, device,
                                              dtype=torch.bfloat16)}
    finally:
        shutil.rmtree(work, ignore_errors=True)


def run_readings(cell: dict, seed: int, device, fault: Optional[str] = None) -> dict:
    """The numbers ``run.check`` compares after one reconstruction at the
    cell's own size, as a run with a window of one makes it, with fault
    `fault` (``faults.FAULTS``) planted in the program, or none."""
    with faults.planted(fault) if fault else contextlib.nullcontext():
        res = run.run_cell(cell, seed, 0.0, False, device, time.perf_counter())
    return {"seed": seed, "workload": cell["name"], "fault": fault, "correct": res["correct"],
            "checks": {k: c["value"] for k, c in res["checks"].items()}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="mvsbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated whole numbers")
    ap.add_argument("--mode", default="control",
                    choices=("control", "program") + tuple(faults.FAULTS),
                    help="control: the seed stage's readings, the program's and the "
                         "bfloat16 control's; program: a whole reconstruction's check "
                         "numbers; a fault's name: the same with that fault planted")
    ap.add_argument("--out", default=None, help="also append the lines to this file")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("mvsbench.control: no CUDA device", file=sys.stderr)
        return 2
    cell = run.load_cell(args.workload)
    dev = torch.device("cuda", 0)
    for s in args.seeds.split(","):
        if args.mode == "control":
            r = readings(cell, int(s), dev)
        else:
            r = run_readings(cell, int(s), dev, None if args.mode == "program" else args.mode)
        line = json.dumps(r)
        print(line, flush=True)
        if args.out:
            os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
