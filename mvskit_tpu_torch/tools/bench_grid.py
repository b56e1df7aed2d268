"""The cell-grid build at production capacity (port of ``tools/bench_grid.py``).

The grid rebuild (slots and vslots by a segmented top-K, the z-buffer
depth maps; reference patch_manager.cpp:223-239 and filter.cpp:580-626)
runs once per propagation round and twice per filter phase. Its sorts
are sized by the table's capacity times the list width, so a synthetic
table at production capacity (2^18 rows, 4-10-view lists over the
dataset's views) reproduces the production sort sizes.

It builds the grid three ways on one device and holds each to the plain
build bit for bit (slots, vslots, depth, depth_idx, evicted):

  * plain  — ``core/grid.build_grid``;
  * tiled  — ``parallel/tiles.tiled_build_grid`` over ``--tiles`` row
             tiles, its padded rows cut off;
  * dp     — ``build_grid`` with its rows dealt to ``--dp`` dp shards.

The tiled and dp shards are logical shards of the one device. On a card
each form is timed with CUDA events around one call (the better of two
medians of ``--reps`` calls); on the CPU nothing is timed (the times
are null).

    python -m mvskit_tpu_torch.tools.bench_grid --prefix DATASET \\
        [--tiles 2] [--dp 2] [--device cuda] [--out grid.json]

It prints one JSON line (the JAX tool's ``metric``, ``value``,
``capacity_rows``, ``alive`` and ``cell_capacity``, with the card's
name and power limit from ``nvidia-smi``).
"""

from __future__ import annotations

import argparse
import json
import statistics
from typing import Callable, Optional

import numpy as np


def synthetic_table(n_img: int, capacity: int, alive: int, device):
    """The JAX tool's production-shaped table, from the same numpy code
    (tools/bench_grid.py:63-84): `alive` plane patches near z = 0 with
    random 4-10-view lists (as images and vimages) and NCC in [0.4, 1),
    padded to `capacity` rows. Returns (coord, normal, images, ncc) as
    numpy arrays and the port's PatchTable on `device`."""
    from ..core import patches as pt

    rng = np.random.default_rng(0)
    A = alive
    coord = np.concatenate(
        [rng.uniform(-1, 1, (A, 2)), rng.normal(0, 0.01, (A, 1)), np.ones((A, 1))],
        axis=1,
    ).astype(np.float32)
    normal = np.tile(np.asarray([0, 0, 1, 0], np.float32), (A, 1))
    images = np.full((A, n_img), -1, np.int32)
    for i in range(A):
        k = rng.integers(4, 11)
        images[i, :k] = rng.choice(n_img, size=k, replace=False)
    ncc = rng.uniform(0.4, 1.0, (A,)).astype(np.float32)
    table = pt.from_numpy(coord, normal, images, capacity, n_img, ncc=ncc,
                          vimages=images, device=device)
    return (coord, normal, images, ncc), table


def stage_ms(fn: Callable, reps: int, device) -> Optional[float]:
    """Milliseconds of one call of `fn` on a card: CUDA events around
    each of `reps` calls after a warm call, the better of two medians.
    None on the CPU, where nothing is timed (and `fn` is not called)."""
    import torch

    if torch.device(device).type != "cuda":
        return None
    fn()
    torch.cuda.synchronize(device)
    medians = []
    for _ in range(2):
        times = []
        for _ in range(reps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            torch.cuda.synchronize(device)
            times.append(a.elapsed_time(b))
        medians.append(statistics.median(times))
    return min(medians)


def grids_equal(a, b) -> bool:
    """Two GridStates equal bit for bit, field by field."""
    import torch

    def bits(x):
        return x.view(torch.int32) if x.dtype.is_floating_point else x

    return all(torch.equal(bits(x), bits(y)) for x, y in zip(a, b))


def run(prefix: str, max_patches: int = 1 << 18, alive: int = 57850, reps: int = 5,
        tiles: int = 2, dp: int = 2, device="cuda") -> dict:
    """The plain, tiled and dp builds on the dataset at `prefix` (its
    option file's level, csize and cell capacity). Raises AssertionError
    where a sharded build differs from the plain one. Returns the
    record."""
    import torch

    from ..config import MVSConfig
    from ..core import grid as gridmod
    from ..device import get_device
    from ..image.scene import load_scene
    from ..parallel import shard as sh
    from ..parallel import tiles as tl
    from .e2e_run import card_line

    dev = get_device(str(device))
    cfg = MVSConfig.from_option_file(prefix)
    cfg.max_patches = max_patches
    scene = load_scene(cfg.prefix, cfg.images, cfg.nillums, cfg.max_level, device=dev)
    _, table = synthetic_table(scene.n_images, max_patches, alive, dev)
    level, csize, cap = cfg.level, cfg.csize, cfg.max_patches_per_cell
    mesh = sh.make_mesh(tiles, "tile", devices=[dev] * tiles)
    forms = {
        "plain": lambda: gridmod.build_grid(scene, table, level, csize, cap),
        "tiled": lambda: tl.tiled_grid_to_global(
            scene, tl.tiled_build_grid(mesh, scene, table, level, csize, cap), level, csize),
        "dp": lambda: gridmod.build_grid(scene, table, level, csize, cap,
                                         dp_devices=[dev] * dp),
    }
    grids = {name: fn() for name, fn in forms.items()}
    equal = {name: grids_equal(grids[name], grids["plain"]) for name in ("tiled", "dp")}
    if not all(equal.values()):
        raise AssertionError(f"sharded grid builds differ from the plain one: {equal}")
    ms = {name: stage_ms(fn, reps, dev) for name, fn in forms.items()}
    return {
        "metric": "grid_build_ms", "value": ms["plain"], "tiled_ms": ms["tiled"],
        "dp_ms": ms["dp"], "tiles": tiles, "dp": dp, "capacity_rows": max_patches,
        "alive": alive, "cell_capacity": cap, "reps": reps, "equal": equal,
        "occupied_slots": int((grids["plain"].slots >= 0).sum()),
        "evicted": int(grids["plain"].evicted.sum()),
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "card": card_line() if dev.type == "cuda" else None,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m mvskit_tpu_torch.tools.bench_grid")
    ap.add_argument("--prefix", required=True, help="dataset directory with an option file")
    ap.add_argument("--max-patches", type=int, default=1 << 18)
    ap.add_argument("--alive", type=int, default=57850)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--tiles", type=int, default=2)
    ap.add_argument("--dp", type=int, default=2)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--out", default=None, help="also write the record here")
    args = ap.parse_args(argv)
    rec = run(args.prefix, args.max_patches, args.alive, args.reps, args.tiles, args.dp,
              args.device)
    print(json.dumps(rec))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rec, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
