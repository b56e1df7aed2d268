"""Faults planted in the program underneath a run, which the output check
has to catch (``run.check`` comes out not correct).

    with faults.planted("propagation_unchanged"):
        run.run_cell(...)

Each breaks the timed path where the engine computes, by replacing one
function of ``mvskit_tpu_torch`` for the duration of the block:

- ``pyramid_unchanged``: a pyramid step that returns its input (every
  second pixel, no filter);
- ``half_views``: half of the views left out of a score's weighted mean,
  the mean taken over the rest;
- ``seed_score_altered``: one seeded patch's score altered by 0.1 where
  the seed stage produces it;
- ``propagation_unchanged``: a propagation round that returns the patch
  table unchanged;
- ``half_hypotheses``: every second hypothesis of a propagation round
  left out of the gauntlet, which scores and inserts the rest;
- ``output_moved``: every patch centre the engine hands out (snapshots
  and the final files) moved 0.1 along its normal where ``collect``
  gathers it.

``python3 -m mvsbench.control --mode <name>`` reads them at a cell's
own size on the card; ``tests/test_mvsbench_control.py`` under a tiny
cell on the CPU.
"""

from __future__ import annotations

import contextlib

import numpy as np


def _pyramid_unchanged(psc, pncc, ppr):
    def downsample_once(img, filter=0):
        return np.asarray(img, dtype=np.float32)[0::2, 0::2]
    return psc, "downsample_once", downsample_once


def _half_views(psc, pncc, ppr):
    orig = pncc.incc_weighted

    def incc_weighted(tex, valid, weights, robust=True):
        valid = valid.clone()
        valid[(valid.shape[0] + 1) // 2:] = False
        return orig(tex, valid, weights, robust)
    return pncc, "incc_weighted", incc_weighted


def _seed_score_altered(psc, pncc, ppr):
    orig = pncc.compute_patch_ncc_n

    def compute_patch_ncc_n(*args, **kwargs):
        out = orig(*args, **kwargs).clone()
        out[0] += 0.1
        return out
    return pncc, "compute_patch_ncc_n", compute_patch_ncc_n


def _propagation_unchanged(psc, pncc, ppr):
    def propagate_round(scene, table, *args, **kwargs):
        return table, ppr.RoundStats(0, 0, 0, 0)
    return ppr, "propagate_round", propagate_round


def _half_hypotheses(psc, pncc, ppr):
    orig = ppr._gauntlet_chunked

    def _gauntlet_chunked(scene, grid, table, coord, normal, images, ok, *args, **kwargs):
        ok = ok.clone()
        ok[1::2] = False
        return orig(scene, grid, table, coord, normal, images, ok, *args, **kwargs)
    return ppr, "_gauntlet_chunked", _gauntlet_chunked


def _output_moved(psc, pncc, ppr):
    from mvskit_tpu_torch.pipeline.driver import PMMVS

    orig = PMMVS.collect

    def collect(self, table=None):
        data = orig(self, table)
        data["coord"] = data["coord"].copy()
        data["coord"][:, :3] += 0.1 * data["normal"][:, :3]
        return data
    return PMMVS, "collect", collect


FAULTS = {
    "pyramid_unchanged": _pyramid_unchanged,
    "half_views": _half_views,
    "seed_score_altered": _seed_score_altered,
    "propagation_unchanged": _propagation_unchanged,
    "half_hypotheses": _half_hypotheses,
    "output_moved": _output_moved,
}


@contextlib.contextmanager
def planted(name: str):
    """The program with fault `name` in place, restored on exit."""
    from mvskit_tpu_torch.image import scene as psc
    from mvskit_tpu_torch.ops import ncc as pncc
    from mvskit_tpu_torch.pipeline import propagate as ppr

    module, attr, fn = FAULTS[name](psc, pncc, ppr)
    orig = getattr(module, attr)
    setattr(module, attr, fn)
    try:
        yield
    finally:
        setattr(module, attr, orig)
