"""Cell-row tile sharding of a propagation round (port of
``mvskit_tpu/parallel/tiles.py``).

The checkerboard rounds of pipeline/propagate.py index patches by the
per-image cell grids (reference pmmvps/patch_manager.hpp:90-104). Here
those grids are split by cell ROW over the mesh's ``tile`` axis:

  * the grid build (slots, vslots, z-buffer) runs per tile on the tile's
    device, for the (patch, view) pairs landing in its row window
    (``core/grid._fill_slots`` / ``build_depth_maps`` with ``row_start``
    / ``row_count``, and the table's live-row bound ``row_limit``);
  * donor selection takes each tile's top ``budget`` candidates and
    merges them into the exact global priority order, by the same stable
    descending sort as ``propagate.select_donors``;
  * the full-cell gate reads each donor's target cell on the tile that
    owns the donor's row; a target one row past the tile comes from the
    neighbour by the 1-row halo exchange (``shard.ppermute_rows``);
  * the hypotheses and the gauntlet run on the global grid, the tiles'
    rows gathered once per round (``propagate.round_from_donors``; with
    a dp axis they, and the insertion, deal their rows to its devices).

Row i of the grid belongs to tile i // gh_l; the rows are padded up to
k * gh_l, and padded rows hold no cells. ``tiled_propagate_round`` gives
the unsharded ``propagate_round``'s result bit for bit under the same
noise.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..core import grid as gridmod
from ..core.grid import GridState
from ..core.patches import PatchTable
from ..image.scene import Scene
from ..pipeline import propagate as pr
from .shard import Mesh, all_gather_rows, ppermute_rows, psum, replicas

NEG = pr.NEG


def _tile_rows(scene: Scene, level: int, csize: int, k: int) -> Tuple[int, int]:
    """(rows per tile, padded total rows) (JAX tiles.py:55): cell rows
    pad up to a multiple of the mesh size; padded rows hold no cells
    (every real cy < gh) and are sliced off before the gauntlet."""
    _, gh = gridmod.grid_dims(scene, level, csize)
    gh_l = (gh + k - 1) // k
    return gh_l, gh_l * k


def _halo_rows(blocks, fill):
    """The boundary cell row of each tile's [n, rows_local, gw] block
    from both neighbours (JAX tiles.py:64): (from_prev, from_next), one
    per tile, `fill`-valued at the mesh edges."""
    return ppermute_rows(blocks, fill)


def tiled_build_grid(
    mesh: Mesh,
    scene: Scene,
    table: PatchTable,
    level: int,
    csize: int,
    capacity: int,
    v_capacity: Optional[int] = None,
    with_depth: bool = True,
    axis: str = "tile",
    row_limit: Optional[int] = None,
) -> GridState:
    """build_grid with cell rows sharded over `axis` (JAX tiles.py:81):
    each tile runs the segmented per-cell top-K and the z-buffer scatter
    for its row window only (exact per cell: cells are disjoint and every
    tile sees the whole table up to `row_limit`). Returns the tiles' rows
    gathered on the table's device, padded to k * rows_local;
    ``tiled_grid_to_global`` slices the padding off. ``evicted`` is the
    OR of the tiles' (each over-capacity pair belongs to one tile)."""
    if v_capacity is None:
        v_capacity = capacity
    devs = mesh.axis_devices(axis)
    gh_l, _ = _tile_rows(scene, level, csize, len(devs))
    n = scene.n_images
    gw, _ = gridmod.grid_dims(scene, level, csize)
    home = table.coord.device
    on = replicas(devs, home, scene, table)
    parts = []
    for t, d in enumerate(devs):
        scn, tbl = on[d]
        win = dict(row_limit=row_limit, row_start=t * gh_l, row_count=gh_l)
        slots, evicted = gridmod._fill_slots(scn, tbl, tbl.images, level, csize,
                                             capacity, **win)
        vslots, _ = gridmod._fill_slots(scn, tbl, tbl.vimages, level, csize,
                                        v_capacity, **win)
        if with_depth:
            depth, depth_idx = gridmod.build_depth_maps(scn, tbl, level, csize, **win)
        else:
            depth = torch.full((n, gh_l, gw), gridmod.INF, dtype=torch.float32, device=d)
            depth_idx = torch.full((n, gh_l, gw), -1, dtype=torch.int32, device=d)
        parts.append((slots, vslots, depth, depth_idx, evicted.to(torch.int32)))
    slots, vslots, depth, depth_idx = (
        all_gather_rows([p[i] for p in parts], home, dim=1) for i in range(4))
    evicted = psum([p[4] for p in parts], home) > 0
    return GridState(slots, vslots, depth, depth_idx, evicted)


def tiled_grid_to_global(scene: Scene, grid: GridState, level: int, csize: int) -> GridState:
    """The tiled GridState without its padded rows: the global layout
    the cross-view stages read (JAX tiles.py:141)."""
    _, gh = gridmod.grid_dims(scene, level, csize)
    return GridState(slots=grid.slots[:, :gh], vslots=grid.vslots[:, :gh],
                     depth=grid.depth[:, :gh], depth_idx=grid.depth_idx[:, :gh],
                     evicted=grid.evicted)


def tiled_select_donors(
    mesh: Mesh,
    scene: Scene,
    grid: GridState,
    table: PatchTable,
    budget: int,
    level: int,
    csize: int,
    axis: str = "tile",
    policy: str = "cell_first",
):
    """select_donors over a row-tiled grid (JAX tiles.py:158): each tile
    keeps its top `budget` slots (all of them where it has fewer), in
    the order of a stable descending sort of the priority; the
    candidates are merged by the same order over their flat index in the
    padded layout, which orders real cells as the unpadded layout does,
    so ties fall as in ``propagate.select_donors``. A slot a tile drops
    has `budget` better ones in its own tile and cannot be a global
    donor, so the merge is exact. Raises ValueError where the grid has
    fewer slots than `budget` (the unsharded round cannot run there:
    its jitter has `budget` rows). Returns (pidx, img, cy, cx, ok),
    equal to select_donors on every ok entry."""
    devs = mesh.axis_devices(axis)
    gh_l, gh_pad = _tile_rows(scene, level, csize, len(devs))
    n, _, gw, S = grid.slots.shape
    _, gh = gridmod.grid_dims(scene, level, csize)
    if n * gh * gw * S < budget:
        raise ValueError(f"donor budget {budget} exceeds the grid's {n * gh * gw * S} slots")
    home = table.coord.device
    on = replicas(devs, home, table.images[:, 0], table.ncc, table.alive)
    vals, gflat, cand_pidx = [], [], []
    for t, d in enumerate(devs):
        images0, ncc, alive = on[d]
        flat = grid.slots[:, t * gh_l:(t + 1) * gh_l].to(d).reshape(-1)
        pidx = flat.clamp(min=0).long()
        ar = torch.arange(flat.shape[0], device=d)
        slot_img = ar // (gh_l * gw * S)
        ok = (flat >= 0) & (images0[pidx].long() == slot_img) & alive[pidx]
        prio = pr.donor_priority(ncc[pidx], ar % S, ok, policy)
        loc = torch.sort(prio, descending=True, stable=True).indices[:budget]
        cell_l, s = loc // S, loc % S
        img, rem = cell_l // (gh_l * gw), cell_l % (gh_l * gw)
        g = ((img * gh_pad + t * gh_l + rem // gw) * gw + rem % gw) * S + s
        vals.append(prio[loc])
        gflat.append(g)
        cand_pidx.append(pidx[loc])
    vals, gflat, cand_pidx = (all_gather_rows(x, home) for x in (vals, gflat, cand_pidx))
    by_index = torch.sort(gflat, stable=True).indices
    top = by_index[torch.sort(vals[by_index], descending=True, stable=True).indices[:budget]]
    cell = gflat[top] // S
    img, rem = cell // (gh_pad * gw), cell % (gh_pad * gw)
    i32 = lambda x: x.to(torch.int32)  # noqa: E731
    return (i32(cand_pidx[top]), i32(img), i32(rem // gw), i32(rem % gw),
            vals[top] > NEG)


def tiled_full_cell_gate(
    mesh: Mesh,
    scene: Scene,
    grid: GridState,
    table: PatchTable,
    donor_img,
    donor_cy,
    donor_cx,
    axis_sp: int,
    direction: int,
    level: int,
    csize: int,
    axis: str = "tile",
):
    """The full-cell gate (worst incumbent of each donor's target cell,
    reference propagate.cpp:166-173) over a row-tiled grid (JAX
    tiles.py:227). Each tile gates the donors whose row it owns; a
    target one row past its rows comes by the halo exchange, -1 (empty)
    at the mesh edges. Every donor has one owner, so the tiles' results
    merge by a sum of exact zeros elsewhere. Returns (full [B] bool,
    worst_ncc [B]), for ``generate_hypotheses``' gate_full /
    gate_worst_ncc."""
    devs = mesh.axis_devices(axis)
    gh_l, _ = _tile_rows(scene, level, csize, len(devs))
    gw, _ = gridmod.grid_dims(scene, level, csize)
    home = table.coord.device
    on = replicas(devs, home, table.ncc, donor_img, donor_cy, donor_cx)
    blocks = [grid.slots[:, t * gh_l:(t + 1) * gh_l, :, -1].to(d) for t, d in enumerate(devs)]
    prev, nxt = _halo_rows(blocks, fill=-1)
    fulls, worsts = [], []
    for t, d in enumerate(devs):
        ncc, dimg, dcy, dcx = on[d]
        worstp = torch.cat([prev[t], blocks[t], nxt[t]], dim=1)
        r0 = t * gh_l
        ty = dcy + (direction if axis_sp == 1 else 0)
        tx = dcx + (direction if axis_sp == 0 else 0)
        own = (dcy >= r0) & (dcy < r0 + gh_l)
        tyl = (ty - r0 + 1).clamp(0, gh_l + 1).long()
        txc = tx.clamp(0, gw - 1).long()
        w_idx = worstp[dimg.long(), tyl, txc]
        full = own & (w_idx >= 0)
        fulls.append(full.to(torch.int32))
        worsts.append(torch.where(full, ncc[w_idx.clamp(min=0).long()],
                                  torch.zeros_like(ncc[:1])))
    return psum(fulls, home) > 0, psum(worsts, home)


def tiled_propagate_round(
    mesh: Mesh,
    scene: Scene,
    table: PatchTable,
    noise: Optional[pr.RoundNoise],
    p: pr.PropagateParams,
    direction: int,
    ncc_threshold,
    ncc_threshold_before,
    use_depth: bool = True,
    quad_threshold=2.5,
    axis: str = "tile",
    *,
    row_limit: Optional[int] = None,
    generator: Optional[torch.Generator] = None,
    dp_devices=None,
    graphs=None,
) -> Tuple[PatchTable, pr.RoundStats]:
    """propagate_round with the cell grids row-tiled over `axis` (JAX
    tiles.py:281): tile-local grid build under the live-row bound
    `row_limit`, the exact merged donor selection and the halo-exchanged
    full-cell gate, then the hypotheses and the gauntlet on the gathered
    grid. It draws the same noise in the same order (the jitter of each
    axis, then each gauntlet chunk's refinement draws) and gives the
    unsharded round's table and counts bit for bit. `graphs`, an
    engine's runner, replays the gauntlet's chunks as CUDA graphs."""
    noise = pr._noise(noise, generator)
    grid_t = tiled_build_grid(mesh, scene, table, p.level, p.csize, p.cell_capacity,
                              axis=axis, row_limit=row_limit)
    table = table._replace(alive=table.alive & ~grid_t.evicted)
    donors = tiled_select_donors(mesh, scene, grid_t, table, p.donor_budget, p.level,
                                 p.csize, axis=axis, policy=p.donor_policy)
    _, img, cy, cx, _ = donors
    gates = [tiled_full_cell_gate(mesh, scene, grid_t, table, img, cy, cx, axis_sp,
                                  direction, p.level, p.csize, axis=axis)
             for axis_sp in (0, 1)]
    grid = tiled_grid_to_global(scene, grid_t, p.level, p.csize)
    return pr.round_from_donors(scene, table, grid, donors, gates, noise, p, direction,
                                ncc_threshold, ncc_threshold_before, use_depth,
                                quad_threshold, dp_devices, graphs=graphs)
