"""Parent against change: a phase of `chip_smoke.py` of two checkouts,
in turns, on one card.

    python -m mvskit_tpu_torch.tools.kernel_ab PARENT_DIR [--phase kernels|grad|paths] [--out FILE]

PARENT_DIR is another checkout of the repository (for example the
parent commit unpacked with `git archive`). The tool runs the phase of
PARENT_DIR's `chip_smoke.py` and of this checkout's in the order
parent, change, change, parent, each in its own process started in its
own directory, so each builds and loads its own kernels: `kernels`
(default) is `chip_smoke.kernel_phase`, compared by each kernel's device
ms, and where a record has them by the device ms of the ungrouped
launch on the same windows (`ungrouped_ms_same_windows`, K1 beside K2
and K3u beside K3g), of the grouped launch on the same windows
(`grouped_ms_same_windows`, K2 and K3g beside K4) and on the gauntlet's
windows (`gauntlet_windows`);
`grad` is `chip_smoke.grad_kernel_phase` (the sampler's backward kernel
on K1's RGB windows and K3u's luma windows, each held to its plain
version), compared by each mode's device ms;
`paths` is `chip_smoke.paths_phase` (RGB, luma, short ungrouped luma,
3-illumination runs), compared by each path's propagation seconds. It
prints the card (name and power limit), then per record each run's
numbers and, per side, the best of its two runs, and ends with one JSON
line of that summary. FILE (default `build/<phase>_ab.json`) receives
every run's full records.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
ORDER = ("parent", "change", "change", "parent")
MARK = "KERNEL_AB "
CALL = {"kernels": "cs.kernel_phase(dev)", "grad": "cs.grad_kernel_phase(dev)",
        "paths": "cs.paths_phase(dev, work)"}


def metrics(phase: str, record: dict) -> dict:
    """The compared numbers of one record: `metric` as named in the
    summary -> value."""
    if phase == "paths":
        return {"propagate_s": record["propagate_s"]}
    out = {"ms": record["ms"]}
    if "ungrouped_ms_same_windows" in record:
        out["ungrouped_ms_same_windows"] = record["ungrouped_ms_same_windows"]
    if "grouped_ms_same_windows" in record:
        out["grouped_ms_same_windows"] = record["grouped_ms_same_windows"]
    if "gauntlet_windows" in record:
        out["gauntlet_ms"] = record["gauntlet_windows"]["ms"]
    return out


def snippet(phase: str) -> str:
    """The program each run executes in its checkout."""
    return "\n".join((
        "import json, sys, tempfile",
        "sys.path.insert(0, '.')",
        "import chip_smoke as cs",
        "from mvskit_tpu_torch import get_device",
        "dev = get_device('cuda')",
        "with tempfile.TemporaryDirectory() as work:",
        f"    records = {CALL[phase]}",
        f"print({MARK!r} + json.dumps(records), flush=True)",
    ))


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def run_phase(checkout: Path, phase: str, timeout: float) -> dict:
    """The records of `phase` of `checkout`'s chip_smoke.py, run there."""
    env = dict(os.environ, PYTHONPATH=str(checkout))
    res = subprocess.run([sys.executable, "-c", snippet(phase)], cwd=checkout, env=env,
                         capture_output=True, text=True, timeout=timeout)
    lines = [ln for ln in res.stdout.splitlines() if ln.startswith(MARK)]
    if res.returncode != 0 or not lines:
        raise RuntimeError(f"{phase} phase of {checkout} failed ({res.returncode}):\n"
                           f"{res.stdout[-4000:]}\n{res.stderr[-4000:]}")
    return json.loads(lines[-1][len(MARK):])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m mvskit_tpu_torch.tools.kernel_ab",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("parent", type=Path, help="the other checkout")
    ap.add_argument("--phase", choices=tuple(CALL), default="kernels")
    ap.add_argument("--out", type=Path, help="default build/<phase>_ab.json")
    ap.add_argument("--timeout", type=float, default=900.0, help="seconds per run")
    args = ap.parse_args(argv)
    phase = args.phase
    out = args.out or REPO / "build" / f"{phase}_ab.json"
    sides = {"parent": args.parent.resolve(), "change": REPO}
    card = card_line()
    print(card, flush=True)
    runs = []
    for side in ORDER:
        t0 = time.time()
        records = run_phase(sides[side], phase, args.timeout)
        runs.append({"side": side, "seconds": time.time() - t0, "records": records})
        print(f"[ab] {side}: " + json.dumps({k: metrics(phase, r)
                                             for k, r in records.items()}), flush=True)
    summary = {"card": card, "order": list(ORDER), "phase": phase, "records": {}}
    for name, first in runs[0]["records"].items():
        for metric in metrics(phase, first):
            vals = {side: [metrics(phase, r["records"][name]).get(metric) for r in runs
                           if r["side"] == side and name in r["records"]]
                    for side in sides}
            vals = {side: [v for v in vs if v is not None] for side, vs in vals.items()}
            if not (vals["parent"] and vals["change"]):
                continue
            best = {side: min(v) for side, v in vals.items()}
            entry = {"parent_runs": vals["parent"], "change_runs": vals["change"],
                     "parent_best": best["parent"], "change_best": best["change"],
                     "change_over_parent": best["change"] / best["parent"]}
            change = [r["records"][name] for r in runs if r["side"] == "change"][0]
            if metric == "ms" and "bound_ms" in change:
                entry.update(bound_ms=change["bound_ms"],
                             change_bound_share=change["bound_ms"] / best["change"])
            summary["records"][name if metric in ("ms", "propagate_s")
                               else f"{name}.{metric}"] = entry
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({"summary": summary, "runs": runs}, indent=1))
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
