"""The benchmark of mvskit_tpu_torch: whole reconstructions, timed end to end.

    python3 -m mvsbench.run --workload dino16.plane --seed 7 --seconds 30 --trace 0

One cell of ``BENCHMARK.json`` is a configuration (``configs/<name>.json``:
the dataset's shape and the engine's options) under a traffic mix
(``traffic/<name>.json``: the scene). A run:

1. set-up: renders the scene from ``--seed`` on the card
   (``scene.py``), writes it as a dataset under the temporary directory,
   and runs one reconstruction of one iteration, which also builds the
   engine's kernel library inside the checkout on a checkout's first run;
2. the window: whole reconstructions back to back, each as the engine's
   command line runs it at its defaults (``PMMVS`` on the dataset
   directory, ``run(write_snapshots=True)``, ``write_patches`` of the
   final PLY and patch file, ``close``), each fresh from the files;
   another starts only while the last one's time still fits in
   ``--seconds``, and at least one runs. With ``--trace 1`` the first one
   runs under ``torch.profiler`` (``trace.py``) and at least one more,
   untraced, follows it;
3. the checks (``reference/``), once the window has closed and the
   device's peak memory has been read: the program's pyramids against
   the reference's, the seed patches' NCC scores against the reference's
   float64 scores, every final patch's image count against minImageNum,
   and every reconstruction's final cloud against the scene's analytic
   surface (``quality.py``: accuracy, completeness, and the patches it
   grew from the seeds);
4. one JSON line on stdout: ``correct``, ``attempted``, ``failed``,
   ``metrics`` (``end_to_end`` with ``--trace 0``, ``per_layer`` with
   ``--trace 1``, each read by ``metrics/<name>.py``), ``device``,
   ``breakdown`` (traced runs) and ``checks`` last, each compared number
   beside its limit, an upper (``max``) or a lower (``min``) one
   (``limits/default.json`` and the cell's ``limits/<cell>.json``).

It exits non-zero without a result where no card, too few cards, or no
``mvskit_tpu_torch`` package is there, and where ``jax``, ``jaxlib``,
``flax`` or ``mvskit_tpu`` were imported.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import importlib.util
import json
import math
import os
import shutil
import sys
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "mvskit_tpu")
CHECKS = ("pyramid_gap", "seed_ncc_gap", "min_images_short", "acc_p90", "comp_pct", "growth")


class ForbiddenImport(RuntimeError):
    """JAX or the JAX package was loaded in the benchmark's process."""


def forbidden_modules(names=None) -> List[str]:
    """Loaded modules whose top-level name (before the first dot) is JAX's
    or the JAX package's."""
    tops = {n.split(".")[0] for n in (sys.modules if names is None else names)}
    return sorted(t for t in tops if t in FORBIDDEN)


def load_json(path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, root: Path = ROOT) -> dict:
    """The cell `name` of ``BENCHMARK.json``: its configuration, traffic,
    limits, chips and the metric names it reports."""
    bench = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; known: {sorted(cells)}")
    cell = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    own = HERE / "limits" / f"{name}.json"
    limits = {**load_json(HERE / "limits" / "default.json"),
              **(load_json(own) if own.exists() else {})}
    if sorted(limits) != sorted(CHECKS):
        raise SystemExit(f"{name}: limits for {sorted(limits)}, the check compares "
                         f"{sorted(CHECKS)} (limits/{name}.json)")
    return {
        "name": name,
        "chips": cell["chips"],
        "config": load_json(root / conf["file"]),
        "traffic": load_json(HERE / "traffic" / f"{cell['traffic']}.json"),
        "limits": limits,
        "end_to_end": [m for m in bench["end_to_end"] if name in m.get("workloads", [name])],
        "per_layer": [m for m in bench["per_layer"] if name in m.get("workloads", [name])],
    }


def reader(metric: str):
    """``metrics/<metric>.py``'s ``read``."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"mvsbench.metrics.{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _quiet(*_args) -> None:
    pass


def engine_config(prefix: str, config: dict, overrides: Optional[dict] = None):
    """The engine's configuration as its command line builds it from the
    dataset's option file, with the configuration's engine settings."""
    from mvskit_tpu_torch.config import MVSConfig

    cfg = MVSConfig.from_option_file(prefix)
    for k, v in {**config.get("engine", {}), **(overrides or {})}.items():
        if not hasattr(cfg, k):
            raise ValueError(f"unknown engine setting {k!r}")
        setattr(cfg, k, v)
    return cfg


def seed_rows(engine, config: dict) -> Dict[str, object]:
    """Copies of the seeded rows of the engine's patch table (the seed
    stage fills a prefix of at most ``seed_points`` rows)."""
    t = engine.table
    k = min(config["seed_points"], t.capacity)
    return {f: getattr(t, f)[:k].clone() for f in ("coord", "normal", "images", "ncc", "alive")}


@dataclasses.dataclass
class Recon:
    wall_s: float
    rec: object
    patch_path: str
    n_seeded: int
    planes: object = None
    seeds: Optional[Dict[str, object]] = None


def reconstruct(prefix: str, out_dir: str, config: dict, device, rec, overrides=None) -> Recon:
    """One reconstruction as ``python -m mvskit_tpu_torch <prefix>`` runs
    it at its defaults, with the final patch file as well, each engine
    call inside a span of `rec`. Keeps the scene's planes and the seeded
    patches for the checks."""
    from mvskit_tpu_torch.pipeline.driver import PMMVS

    cfg = engine_config(prefix, config, overrides)
    seeds: Dict[str, object] = {}
    t0 = time.perf_counter()
    with rec.span("load"):
        engine = PMMVS(cfg, device=device, log=_quiet)
    try:
        def grab_seeds(_):
            seeds.update(seed_rows(engine, config))

        def counted(name, fn, counter=None):
            calls = [0]

            def inner(*args):
                with rec.span(f"{name}[{calls[0]}]"):
                    out = fn(*args)
                calls[0] += 1
                if counter:
                    rec.counters[counter] += int(out.total)
                return out
            return inner

        engine.seed = rec.wrap("seed", engine.seed, after=grab_seeds)
        engine.propagate = counted("propagate", engine.propagate, "hypotheses")
        engine.filter = counted("filter", engine.filter)
        engine.write_patches = rec.wrap("write", engine.write_patches)
        engine.join_snapshots = rec.wrap("write", engine.join_snapshots)
        engine.run(write_snapshots=True)
        out = os.path.join(out_dir, "final_patches")
        engine.write_patches(out, export_ply=True, export_patch=True)
    finally:
        engine.close()
        for name in ("seed", "propagate", "filter", "write_patches", "join_snapshots"):
            engine.__dict__.pop(name, None)  # the wrappers refer back to the engine
    rec.sync()
    return Recon(time.perf_counter() - t0, rec, out + ".patch", int(seeds["alive"].sum()),
                 engine.scene.planes, seeds)


def _windows_snapshot():
    from mvskit_tpu_torch.ops import cuda_ncc

    return {k: collections.Counter(v) for k, v in cuda_ncc.WINDOWS.items()}


def _windows_delta(before):
    after = _windows_snapshot()
    return {k: dict(after[k] - before.get(k, collections.Counter())) for k in after
            if after[k] - before.get(k, collections.Counter())}


def reference_gaps(prefix: str, config: dict, planes, seeds: Dict[str, object], device,
                   dtype=None) -> Dict[str, float]:
    """The program's pyramids `planes` and seeded patches' scores `seeds`
    against the float64 reference worked out from the dataset's files.
    With `dtype`, the reference computed in that precision stands in the
    program's place (the control)."""
    import torch

    from .reference import ncc as R

    opt = config["option"]
    n, level, wsize = config["views"], int(opt["level"]), int(opt["wsize"])
    tau = min(2 * int(opt["minImageNum"]), n)
    n_il = planes.shape[1]
    cams = R.load_cameras(prefix, n, torch.float64, device)
    pl = R.load_planes(prefix, n, n_il, R.level_count(level), torch.float64, device)
    rows = seeds["alive"]
    coord, normal, images = seeds["coord"][rows], seeds["normal"][rows], seeds["images"][rows]
    ref = R.patch_ncc(cams, pl, coord.double(), normal.double(), images, level=level,
                      wsize=wsize, tau=tau)
    if dtype is None:
        got_planes, got_ncc = planes, seeds["ncc"][rows]
    else:
        cams_c = R.load_cameras(prefix, n, dtype, device)
        pl_c = R.load_planes(prefix, n, n_il, R.level_count(level), dtype, device)
        got_planes = pl_c.planes
        got_ncc = R.patch_ncc(cams_c, pl_c, coord.to(dtype), normal.to(dtype), images,
                              level=level, wsize=wsize, tau=tau)
    same = tuple(pl.planes.shape) == tuple(got_planes.shape)
    return {"pyramid_gap": R.max_abs_gap(pl.planes, got_planes) if same else math.inf,
            "seed_ncc_gap": R.max_abs_gap(ref, got_ncc) if bool(rows.any()) else math.inf}


def check(prefix: str, config: dict, recons: List[Recon], clouds: List[dict],
          device) -> Dict[str, float]:
    """The numbers `correct` compares: the last reconstruction's pyramids
    and seed scores against the plain reference; and of every
    reconstruction's final cloud (`clouds`, from its patch file), the
    image counts against the configuration's minImageNum, and the worst
    accuracy, completeness and growth (final patches per seeded patch)
    against the scene's analytic surface."""
    out = reference_gaps(prefix, config, recons[-1].planes, recons[-1].seeds, device)
    mini = int(config["option"]["minImageNum"])
    out["min_images_short"] = float(sum(int((c["nimg"] < mini).sum()) for c in clouds))
    out["acc_p90"] = max(c["acc_p90"] for c in clouds)
    out["comp_pct"] = min(c["comp_pct"] for c in clouds)
    out["growth"] = min(c["patches"] / max(r.n_seeded, 1) for r, c in zip(recons, clouds))
    return out


def passes(value: float, limit: Dict[str, float]) -> bool:
    """`value` within `limit`: ``{"max": x}`` or ``{"min": x}``."""
    (kind, x), = limit.items()
    return math.isfinite(value) and (value <= x if kind == "max" else value >= x)


def run_cell(cell: dict, seed: int, seconds: float, trace: bool, device, t_start: float,
             log=_quiet) -> dict:
    """Set-up, window and checks of one cell on `device`; returns the
    result record (the last line's object)."""
    import numpy as np
    import torch

    from . import quality, scene
    from .trace import Recorder, breakdown, read_trace

    config, traffic = cell["config"], cell["traffic"]
    on_card = device.type == "cuda"
    work = tempfile.mkdtemp(prefix="mvsbench_")
    try:
        prefix = os.path.join(work, "data")
        log(f"[setup] torch and the card ready: {time.perf_counter() - t_start:.2f}s")
        sc = scene.make_scene(config, traffic, seed, device)
        log(f"[setup] scene rendered: {time.perf_counter() - t_start:.2f}s")
        scene.write_dataset(prefix, sc, config)
        Ps = sc.Ps
        del sc
        log(f"[setup] dataset written: {time.perf_counter() - t_start:.2f}s")
        reconstruct(prefix, os.path.join(work, "warm"), config, device, Recorder(device),
                    overrides={"n_iterations": 1})
        shutil.rmtree(os.path.join(work, "warm"))
        setup_s = time.perf_counter() - t_start
        log(f"[setup] warm-up done: {setup_s:.2f}s")

        if on_card:
            torch.cuda.synchronize(device)
            torch.cuda.reset_peak_memory_stats(device)
        recons: List[Recon] = []
        traced_rec, windows = None, {}
        t_w0 = time.perf_counter()
        while True:
            if recons:
                recons[-1].planes = recons[-1].seeds = None
            out_dir = os.path.join(work, f"out{len(recons)}")
            traced = trace and not recons
            rec = Recorder(device, traced=traced and on_card)
            before = _windows_snapshot() if traced else None
            r = reconstruct(prefix, out_dir, config, device, rec)
            if traced:
                traced_rec, windows = rec, _windows_delta(before)
            recons.append(r)
            log(f"[window] reconstruction {len(recons)}{' (traced)' if traced else ''}: "
                f"{r.wall_s:.3f}s, {r.rec.counters['hypotheses']} hypotheses")
            # a traced window also times at least one untraced reconstruction
            if (len(recons) > int(trace)
                    and time.perf_counter() - t_w0 + r.wall_s > seconds):
                break
        peak = torch.cuda.max_memory_allocated(device) if on_card else 0
        found = forbidden_modules()
        if found:
            raise ForbiddenImport(f"modules of JAX or the JAX package were loaded: {found}")

        # quality of every reconstruction's final cloud
        geometry, (center, radius) = traffic["geometry"], scene.sphere_of(traffic)
        gt = quality.ground_truth(geometry, Ps, config["width"], config["height"], center,
                                  radius)
        dists, clouds = [], []
        for r in recons:
            coord, nimg = quality.read_patches(r.patch_path)
            dists.append(quality.surface_distance(coord, geometry, center, radius))
            clouds.append({"acc_p90": quality.accuracy(dists[-1]),
                           "comp_pct": quality.completeness(gt, coord, device),
                           "patches": coord.shape[0], "nimg": nimg})
            log(f"[quality] {coord.shape[0]} patches from {r.n_seeded} seeded, acc_p90 "
                f"{clouds[-1]['acc_p90']!r}, comp_pct {clouds[-1]['comp_pct']!r}")

        values = {
            "recon_s": sum(r.wall_s for r in recons) / len(recons),
            "acc_p90": quality.accuracy(np.concatenate(dists)),
            "comp_pct": float(np.mean([c["comp_pct"] for c in clouds])),
            "setup_s": setup_s,
        }
        result = {"correct": False, "attempted": len(recons), "failed": 0, "metrics": {}}
        dev_rec = {"platform": "gpu" if on_card else device.type,
                   "kind": torch.cuda.get_device_name(device) if on_card else device.type,
                   "count": 1, "memory_peak_bytes": int(peak)}
        if trace:
            reading = read_trace(traced_rec, [(r.rec, r.wall_s) for r in recons[1:]],
                                 int(config["option"]["wsize"]), windows)
            for m in cell["per_layer"]:
                v = reader(m["name"])(reading)
                if v is not None:
                    result["metrics"][m["name"]] = {"value": float(v), "unit": m["unit"]}
            if reading.busy_s is not None:
                dev_rec.update(busy_s=reading.busy_s, window_s=reading.traced_s)
                result["breakdown"] = breakdown(reading)
        else:
            for m in cell["end_to_end"]:
                result["metrics"][m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
        result["device"] = dev_rec

        if on_card:
            torch.cuda.empty_cache()
        checks = check(prefix, config, recons, clouds, device)
        limits = cell["limits"]
        result["correct"] = all(passes(checks[k], limits[k]) for k in CHECKS)
        result["checks"] = {k: {"value": checks[k], "limit": x, "kind": kind}
                            for k in CHECKS for kind, x in limits[k].items()}
        return result
    finally:
        shutil.rmtree(work, ignore_errors=True)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="mvsbench.run", description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    t_start = time.perf_counter()
    args = parse_args(argv)
    cell = load_cell(args.workload)
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(ROOT / "build" / sub)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"mvsbench: needs {cell['chips']} CUDA device(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    import mvskit_tpu_torch  # noqa: F401  (no program, no run)

    log = lambda msg: print(msg, file=sys.stderr, flush=True)  # noqa: E731
    try:
        result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                          torch.device("cuda", 0), t_start, log)
    except ForbiddenImport as e:
        print(f"mvsbench: {e}", file=sys.stderr)
        return 3
    for k, c in result["checks"].items():
        print(f"check {k} {c['value']!r} {c['kind']} {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
