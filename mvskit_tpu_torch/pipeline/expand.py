"""PMVS-style scene-space expansion, the ``pmvs`` strategy (port of
``mvskit_tpu/pipeline/expand.py``).

Re-expresses Propagate::propagatePmvs / findEmptyBlocks / expandSub /
checkCounts / updateCounts (reference pmmvps/propagate.cpp:384-691; the
reference compiles the strategy but does not call it in its live
configuration, propagate.cpp:47-52): instead of pushing hypotheses into
image-grid neighbor cells, each donor patch spawns candidates at 6
angular sectors on its own tangent plane at radius computeRadius(),
skipping sectors its neighbors already fill, with per-cell effort
counters throttling repeated expansion into the same cells.

A round takes a donor budget in score2-descending order (the reference's
priority queue) and carries the effort counters as a dense [n, gh, gw]
tensor across the rounds of one propagation phase. Its random numbers
are the gauntlet's refinement deltas, injected through a ``RoundNoise``
whose chunk draws come from the round's key as a whole (the JAX round
hands its key to the gauntlet unsplit).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from ..core import grid as gridmod
from ..core.patches import PatchTable, count_valid
from ..image.scene import Scene
from ..ops import sampling
from ..parallel import shard as sh
from . import filters as fl
from . import propagate as pr
from . import views as vw

N_SECTORS = 6  # reference propagate.cpp:415


class ExpandState(NamedTuple):
    counts: torch.Tensor  # [n, gh, gw] int32 effort counters (m_counts)


def init_state(scene: Scene, level: int, csize: int) -> ExpandState:
    gw, gh = gridmod.grid_dims(scene, level, csize)
    return ExpandState(counts=torch.zeros((scene.n_images, gh, gw),
                                          dtype=torch.int32, device=scene.device))


def find_empty_sectors(scene: Scene, grid: gridmod.GridState, table: PatchTable,
                       donor_rows, level: int, csize: int,
                       neighbor_threshold: float, max_neighbors: int = 64):
    """findEmptyBlocks (propagate.cpp:414-472): per donor, project its
    neighbors into the tangent-plane frame, accumulate angular fill, and
    emit one candidate coordinate per sector at radius computeRadius.
    Returns (cand_coord[H, 6, 4], empty[H, 6] bool).

    The fill is a float scatter-add whose order may differ from the JAX
    package's, but only ``fill <= 0`` is read and every weight is >= 0
    (the low sector's is > 0), so `empty` depends only on which sector
    each in-annulus neighbor falls in."""
    dl = donor_rows.long()
    coord = table.coord[dl]
    normal = table.normal[dl]
    dscale = table.dscale[dl]
    images = table.images[dl]

    xdir, ydir = fl._ortho(normal)
    radius = fl.compute_radius_batch(scene, coord, normal, images, level, csize)
    rlow = radius / 6.0
    rhigh = radius * 2.5

    nbrs, _ = fl.gather_neighbors_batch(
        scene, grid, table, coord, normal, dscale, images, donor_rows,
        level, csize, margin=1, scale=4.0,
        neighbor_threshold=neighbor_threshold, max_neighbors=max_neighbors,
    )
    nok = nbrs >= 0
    diff = table.coord[nbrs.clamp(min=0).long()] - coord.unsqueeze(1)
    fx = (diff * xdir.unsqueeze(1)).sum(-1)
    fy = (diff * ydir.unsqueeze(1)).sum(-1)
    ln = torch.sqrt(torch.clamp(fx * fx + fy * fy, min=1e-20))
    in_annulus = nok & (ln >= rlow.unsqueeze(1)) & (ln <= rhigh.unsqueeze(1))

    ang = torch.atan2(fy, fx)
    ang = torch.where(ang < 0.0, ang + 2.0 * math.pi, ang)
    findex = ang / (2.0 * math.pi / N_SECTORS)
    lo = torch.floor(findex).clamp(-2147483520.0, 2147483520.0).to(torch.int64)
    hi = lo + 1
    w_hi = findex - lo.to(findex.dtype)
    w_lo = 1.0 - w_hi

    H = nbrs.shape[0]
    zero = torch.zeros_like(w_lo)
    fill = torch.zeros((H, N_SECTORS), dtype=torch.float32, device=coord.device)
    fill.scatter_add_(1, lo % N_SECTORS, torch.where(in_annulus, w_lo, zero))
    fill.scatter_add_(1, hi % N_SECTORS, torch.where(in_annulus, w_hi, zero))
    empty = fill <= 0.0

    angles = (2.0 * math.pi
              * torch.arange(N_SECTORS, dtype=torch.float32, device=coord.device)
              / N_SECTORS)
    r = radius.reshape(H, 1, 1)
    cand = (coord.unsqueeze(1)
            + torch.cos(angles).reshape(1, N_SECTORS, 1) * r * xdir.unsqueeze(1)
            + torch.sin(angles).reshape(1, N_SECTORS, 1) * r * ydir.unsqueeze(1))
    return cand, empty


def check_counts(scene: Scene, grid: gridmod.GridState, counts, coord, images,
                 level: int, csize: int, count_threshold, min_image_num: int,
                 depth: int):
    """checkCounts (propagate.cpp:558-617): a candidate is throttled
    when too few of its cells are both unoccupied and below the effort
    threshold. Returns the pass mask [B]."""
    cx, cy, valid = gridmod.patch_cells(scene, coord, images, level, csize)
    img = images.clamp(min=0).long()
    gh, gw = grid.slots.shape[1], grid.slots.shape[2]
    cxs = cx.clamp(0, gw - 1).long()
    cys = cy.clamp(0, gh - 1).long()
    occupied = grid.slots[img, cys, cxs, 0] >= 0
    count_full = counts[img, cys, cxs] >= count_threshold
    full = valid & (occupied | count_full)
    empty = valid & ~occupied & ~count_full
    n_full = full.sum(1)
    n_empty = empty.sum(1)
    need = min_image_num if depth <= 1 else min_image_num - 1
    blocked = (n_empty < need) & (n_full != 0)
    return ~blocked


def update_counts(scene: Scene, counts, coord, images, vimages, ok,
                  level: int, csize: int):
    """updateCounts (propagate.cpp:619-691): add one to the effort
    counter of every cell an accepted patch lands in, over its views and
    its extra views. Pairs that do not count go to a sentinel bucket past
    the end (the JAX package's drop mode), which is then cut off."""
    n, gh, gw = counts.shape
    size = counts.numel()
    flat = torch.cat([counts.reshape(-1),
                      torch.zeros(1, dtype=counts.dtype, device=counts.device)])
    for lists in (images, vimages):
        cx, cy, valid = gridmod.patch_cells(scene, coord, lists, level, csize)
        img = lists.clamp(min=0).long()
        dest = (img * gh + cy.clamp(0, gh - 1).long()) * gw + cx.clamp(0, gw - 1).long()
        use = valid & ok.unsqueeze(1)
        dest = torch.where(use, dest, torch.full_like(dest, size))
        flat.index_add_(0, dest.reshape(-1), use.reshape(-1).to(counts.dtype))
    return flat[:size].reshape(n, gh, gw)


def _donor_rows(table: PatchTable, first: int, ncc_threshold, budget: int):
    """The first `budget` of table rows [first, first + len(table)) by a
    stable descending sort of their score2 priority (-inf where dead or
    without views). Returns (priority, row)."""
    prio = torch.where(
        table.alive & (count_valid(table.images) > 0),
        fl.score2(table, ncc_threshold),
        torch.full_like(table.ncc, -math.inf),
    )
    top = torch.sort(prio, descending=True, stable=True).indices[:budget]
    return prio[top], top + first


def select_donor_rows(table: PatchTable, ncc_threshold, budget: int, dp_devices=None):
    """Donor selection: priority = score2 (the reference's queue order,
    patch_manager.cpp:107-121), the top `budget` with ties to the lower
    row (lax.top_k's order, -inf rows included): a stable descending sort.
    `dp_devices` deals the table's rows in contiguous blocks
    (``shard.deal_rows``), each keeping its own top `budget`, merged in
    block order by the same sort (``shard.merge_top``).
    Returns (rows int32 [budget], ok [budget])."""
    if not dp_devices:
        prio, rows = _donor_rows(table, 0, ncc_threshold, budget)
    else:
        home = table.coord.device
        parts = [_donor_rows(PatchTable(*(x[s:e].to(d) for x in table)), s,
                             ncc_threshold, budget)
                 for _, d, s, e in sh.deal_rows("pmvs_donors", table.capacity, dp_devices)]
        prio, rows = sh.merge_top(parts, home, budget)
    return rows.to(torch.int32), prio > -math.inf


def expand_round(
    scene: Scene, table: PatchTable, state: ExpandState, noise: pr.RoundNoise,
    p: pr.PropagateParams, ncc_threshold, ncc_threshold_before,
    count_threshold, depth: int, use_depth: bool = True, quad_threshold=2.5,
    row_limit: Optional[int] = None, dp_devices=None, *, graphs=None,
) -> Tuple[PatchTable, ExpandState, pr.RoundStats]:
    """One PMVS-style expansion round: donors by score2 priority ->
    empty-sector candidates -> checkCounts throttle -> gauntlet ->
    updateCounts + insertion. `noise.refine` gives the gauntlet's chunk
    draws; `row_limit` bounds the live table rows. `dp_devices`
    partitions the grid build, the donor sort, the gauntlet and the
    insertion as in ``propagate_round``; the sector search, the count
    throttle and the count update (one batch of budget / 6 donors and
    their candidates each) run on the table's device. `graphs`, an
    engine's runner, replays the gauntlet's chunks as CUDA graphs."""
    grid = gridmod.build_grid(scene, table, p.level, p.csize, p.cell_capacity,
                              row_limit=row_limit, dp_devices=dp_devices)
    table = table._replace(alive=table.alive & ~grid.evicted)

    budget = max(p.donor_budget // N_SECTORS, 1)
    donor_rows, donor_ok = select_donor_rows(table, ncc_threshold, budget, dp_devices)

    cand, empty = find_empty_sectors(
        scene, grid, table, donor_rows, p.level, p.csize,
        p.neighbor_threshold, max_neighbors=max(p.neighbor_capacity, 64),
    )

    H = budget * N_SECTORS
    coord = cand.reshape(H, 4)
    donor_flat = donor_rows.long().repeat_interleave(N_SECTORS)
    normal = table.normal[donor_flat]
    images0 = table.images[donor_flat]
    ok = (empty & donor_ok.unsqueeze(1)).reshape(H)

    # setGridsImages: drop views whose cell leaves the grid
    _, _, cell_ok = gridmod.patch_cells(scene, coord, images0, p.level, p.csize)
    images = vw.compact_list(images0, cell_ok)
    ok &= count_valid(images) > 0

    # scene mask gate (expandSub, propagate.cpp:515-517)
    ok &= sampling.scene_mask_ok(scene, coord, p.level)

    # effort throttle
    ok &= check_counts(scene, grid, state.counts, coord, images, p.level,
                       p.csize, count_threshold, p.min_image_num, depth)

    out = pr._gauntlet_chunked(
        scene, grid, table, coord, normal, images, ok, noise, p,
        ncc_threshold, ncc_threshold_before, use_depth, quad_threshold,
        dp_devices, graphs=graphs,
    )
    counts = update_counts(scene, state.counts, out.coord, out.images,
                           out.vimages, out.ok, p.level, p.csize)
    table = pr.insert_patches(table, out, dp_devices)
    return table, ExpandState(counts), pr._round_stats(ok, out)
