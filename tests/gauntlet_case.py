"""One propagation round's gauntlet inputs for the tests of the gauntlet's
chunk shape and CUDA graphs: an engine seeded on a small synthetic
dataset, the round's grid, table and hypotheses as
``propagate.round_from_donors`` makes them, and a noise source whose
draws depend only on its seed and the chunk, so that two runs of one
round draw alike. Imports nothing of JAX, so the card's tests use it."""

from __future__ import annotations

import torch

from mvskit_tpu_torch.config import MVSConfig
from mvskit_tpu_torch.core import grid as gridmod
from mvskit_tpu_torch.pipeline import propagate as pr
from mvskit_tpu_torch.pipeline.driver import PMMVS
from mvskit_tpu_torch.utils import synthetic

SMALL = dict(max_patches=4096, donor_budget=512, gauntlet_chunk=256, refine_cands=8,
             prop_rounds=1)


def make_engine(prefix: str, device, nillums: int = 1, **cfg) -> PMMVS:
    """A seeded engine on a 6-view 160x120 plane dataset written at
    `prefix`, at the small sizes of SMALL updated by `cfg`."""
    synthetic.write_dataset(prefix, n_views=6, width=160, height=120, n_seeds=256,
                            nillums=nillums)
    c = MVSConfig.from_option_file(prefix)
    for k, v in {**SMALL, **cfg}.items():
        setattr(c, k, v)
    e = PMMVS(c, device=device, log=lambda *a: None)
    e.seed()
    return e


class ChunkNoise:
    """A RoundNoise whose draws are a function of (seed, axis) and
    (seed, chunk) alone."""

    def __init__(self, seed: int, device):
        self.seed, self.device = seed, torch.device(device)

    def _rand(self, key: int, shape) -> torch.Tensor:
        g = torch.Generator(device=self.device).manual_seed(1000 * self.seed + key)
        return torch.rand(shape, generator=g, device=self.device, dtype=torch.float32)

    def jitter(self, axis: int, n: int) -> torch.Tensor:
        return self._rand(900 + axis, (n, 2)) - 0.5

    def refine(self, chunk, n_chunks, rounds, rows, n_cands) -> torch.Tensor:
        return self._rand(chunk, (rounds, rows, n_cands, 3)) * 2.0 - 1.0


def round_inputs(engine: PMMVS, direction: int = 1, seed: int = 0):
    """(grid, table, coord, normal, images, ok) of a round of `engine`'s
    table: the grid build, the cap's evictions, donor selection and the
    hypotheses of both axes."""
    scene, table, p = engine.scene, engine.table, engine.prop_params
    grid = gridmod.build_grid(scene, table, p.level, p.csize, p.cell_capacity)
    table = table._replace(alive=table.alive & ~grid.evicted)
    donors = pr.select_donors(scene, grid, table, p.donor_budget, p.donor_policy)
    noise = ChunkNoise(seed, table.coord.device)
    parts = [pr.generate_hypotheses(scene, table, grid, *donors, axis, direction,
                                    noise.jitter(axis, p.donor_budget), p)
             for axis in (0, 1)]
    coord, normal, images, _, ok = (torch.cat([pt[i] for pt in parts]) for i in range(5))
    return grid, table, coord, normal, images, ok


def bits(x: torch.Tensor) -> torch.Tensor:
    """`x` as comparable integers: floats by their bits (NaN equal to
    itself)."""
    x = x.contiguous()
    return x.view(torch.int32) if x.dtype == torch.float32 else x
