"""Dense cell-grid spatial index (port of ``mvskit_tpu/core/grid.py``).

The reference's mutable per-image cell vectors (pmmvps/patch_manager.*)
become a deterministic dense rebuild over the patch table:

  * slots  [n, gh, gw, S] — per-cell patch indices, NCC descending,
    from a two-key stable sort (cell key ascending, NCC descending) and
    a segmented rank;
  * depth / depth_idx [n, gh, gw] — z-buffer of the front-most patch
    per cell via scatter-min (filter.cpp:580-626);
  * vslots — the same over the ``vimages`` lists.

Every scatter writes out-of-grid pairs to one sentinel bucket past the
end (the ``+ 1`` slot), which is then dropped, so no index ever leaves
its tensor.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..geometry import camera as cam
from ..image.scene import Scene
from ..parallel import shard as sh
from ..utils import profiling
from .patches import PatchTable, compact_by_keys, member_mask, position_in_list

INF = float(1e30)


def grid_dims(scene: Scene, level: int, csize: int) -> Tuple[int, int]:
    """(gw, gh) — reference patch_manager.cpp:36-37 (ceil division)."""
    w = scene.width(level)
    h = scene.height(level)
    return (w + csize - 1) // csize, (h + csize - 1) // csize


class GridState(NamedTuple):
    slots: torch.Tensor       # [n, gh, gw, S] int32, -1 empty, ncc desc
    vslots: torch.Tensor      # [n, gh, gw, Sv] int32
    depth: torch.Tensor       # [n, gh, gw] f32 (INF empty)
    depth_idx: torch.Tensor   # [n, gh, gw] int32 (-1 empty)
    evicted: torch.Tensor     # [N] bool — dropped from an over-full cell

    @property
    def capacity(self) -> int:
        return self.slots.shape[-1]


def _cell_index(v, csize: int):
    """floor(v + 0.5) // csize as int32 (floor division, saturating)."""
    iv = torch.floor(v + 0.5).clamp(-2147483520.0, 2147483520.0)
    return torch.div(iv.to(torch.int32), csize, rounding_mode="floor")


def patch_cells(scene: Scene, coord, lists, level: int, csize: int):
    """Cell coordinates of each (patch, view-list entry) pair
    (setGridsImages, patch_manager.cpp:223-239): ix = floor(px + 0.5) //
    csize; pairs projecting outside the grid are invalid.
    Returns (cx[N, M], cy[N, M], valid[N, M])."""
    gw, gh = grid_dims(scene, level, csize)
    idx = lists.clamp(min=0)
    px, py, pvalid = cam.project_xy_lists(scene.cams, idx, coord, level)
    ix = _cell_index(px, csize)
    iy = _cell_index(py, csize)
    valid = (
        (lists >= 0) & pvalid & (ix >= 0) & (ix < gw) & (iy >= 0) & (iy < gh)
    )
    return ix, iy, valid


def _slot_pairs(scene: Scene, coord, lists, alive, ncc, first_row: int,
                level: int, csize: int, row_start: int, row_count: int):
    """The (patch, list-entry) pairs of table rows [first_row, first_row
    + len(coord)): cell key (n * row_count * gw where the pair lands
    outside the grid's row window or its row is dead), NCC and row
    index, flattened row-major. Returns (key, ncc, pidx, nkeys)."""
    n = scene.n_images
    gw, _ = grid_dims(scene, level, csize)
    R, M = lists.shape
    cx, cy, valid = patch_cells(scene, coord, lists, level, csize)
    valid = valid & alive.unsqueeze(1)
    cy = cy - row_start
    valid = valid & (cy >= 0) & (cy < row_count)
    img = lists.clamp(min=0)
    nkeys = n * row_count * gw
    key = (img * row_count + cy) * gw + cx
    key = torch.where(valid, key, torch.full_like(key, nkeys)).reshape(-1)
    ncc = ncc.unsqueeze(1).expand(R, M).reshape(-1)
    pidx = (torch.arange(first_row, first_row + R, dtype=torch.int32, device=lists.device)
            .unsqueeze(1).expand(R, M).reshape(-1))
    return key, ncc, pidx, nkeys


def _rank_pairs(key, ncc):
    """The pairs in (cell key asc, NCC desc) order, ties by pair order (two
    stable passes, secondary key first), with each pair's rank within
    its cell. Returns (order, sorted key, rank)."""
    o1 = torch.sort(-ncc, stable=True).indices
    o2 = torch.sort(key[o1], stable=True).indices
    order = o1[o2]
    skey = key[order]
    pos = torch.arange(skey.shape[0], device=key.device)
    is_start = torch.ones_like(skey, dtype=torch.bool)
    is_start[1:] = skey[1:] != skey[:-1]
    seg_start = torch.cummax(torch.where(is_start, pos, torch.zeros_like(pos)), 0).values
    return order, skey, pos - seg_start


def _slots_and_evicted(skey, spidx, rank, nkeys: int, capacity: int, N: int, shape):
    """Scatter ranked pairs into [*shape, capacity] slots; rows with a
    pair ranked past the capacity are evicted. Returns (slots, evicted
    [N] int32)."""
    dev = skey.device
    in_slot = (skey < nkeys) & (rank < capacity)
    slots_flat = torch.full((nkeys * capacity + 1,), -1, dtype=torch.int32, device=dev)
    dest = torch.where(in_slot, skey.long() * capacity + rank,
                       torch.full_like(rank, nkeys * capacity))
    slots_flat[dest] = torch.where(in_slot, spidx, torch.full_like(spidx, -1))
    over = (skey < nkeys) & (rank >= capacity)
    evicted = torch.zeros(N, dtype=torch.int32, device=dev)
    evicted.scatter_reduce_(0, spidx.long(), over.to(torch.int32), reduce="amax")
    return slots_flat[:-1].reshape(*shape, capacity), evicted


def _fill_slots(
    scene: Scene,
    table: PatchTable,
    lists: torch.Tensor,
    level: int,
    csize: int,
    capacity: int,
    row_limit: Optional[int] = None,
    row_start: int = 0,
    row_count: Optional[int] = None,
    dp_devices=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Segmented per-cell top-K by NCC over (patch, list-entry) pairs.

    `row_limit` declares that every alive table row index is below it
    (the compacted-table invariant): the pair sort then runs over
    row_limit * M pairs instead of capacity * M, with the same result.
    `row_start` / `row_count` restrict the build to a window of cell
    rows (one tile of parallel/tiles.py; JAX grid.py:92-131): pairs
    landing outside it are dropped and the slots cover only its rows,
    each cell as in a full build (cells are disjoint, the sort stable).

    `dp_devices` deals the rows [0, row_limit) to those devices in
    contiguous blocks (``shard.deal_rows``). Each block ranks its own
    pairs by the same two stable passes and keeps its per-cell top
    `capacity`; the blocks' survivors, joined in block order, are ranked
    again on the table's device. A pair a block drops has `capacity`
    better pairs in its own block, so it cannot make the global top; a
    tie across blocks falls to the earlier block, whose rows come first,
    as it does in one sort. A row is evicted where a pair of it ranks
    past `capacity`, in its block or in the merge.
    Returns (slots[n, row_count, gw, capacity], evicted[N])."""
    n = scene.n_images
    gw, gh = grid_dims(scene, level, csize)
    if row_count is None:
        row_count = gh
    N = table.capacity
    R = N if row_limit is None else min(row_limit, N)
    shape = (n, row_count, gw)
    win = dict(level=level, csize=csize, row_start=row_start, row_count=row_count)
    if not dp_devices:
        key, ncc, pidx, nkeys = _slot_pairs(scene, table.coord[:R], lists[:R],
                                            table.alive[:R], table.ncc[:R], 0, **win)
        order, skey, rank = _rank_pairs(key, ncc)
        slots, evicted = _slots_and_evicted(skey, pidx[order], rank, nkeys, capacity, N,
                                            shape)
        return slots, evicted > 0

    home = table.coord.device
    on = sh.replicas(dp_devices, home, scene)
    keys, nccs, pidxs = [], [], []
    evicted = torch.zeros(N, dtype=torch.int32, device=home)
    for _, d, s, e in sh.deal_rows("grid", R, dp_devices):
        if s == e:
            continue
        rows = (table.coord[s:e], lists[s:e], table.alive[s:e], table.ncc[s:e])
        key, ncc, pidx, nkeys = _slot_pairs(on[d][0], *(x.to(d) for x in rows), s, **win)
        order, skey, rank = _rank_pairs(key, ncc)
        keep = (skey < nkeys) & (rank < capacity)
        over = (skey < nkeys) & (rank >= capacity)
        ev = torch.zeros(e - s, dtype=torch.int32, device=d)
        ev.scatter_reduce_(0, (pidx[order] - s).long(), over.to(torch.int32), reduce="amax")
        evicted[s:e] = ev.to(home)
        keys.append(skey[keep])
        nccs.append(ncc[order][keep])
        pidxs.append(pidx[order][keep])
    nkeys = n * row_count * gw
    key, ncc, pidx = (sh.all_gather_rows(x, home) for x in (keys, nccs, pidxs))
    order, skey, rank = _rank_pairs(key, ncc)
    slots, ev = _slots_and_evicted(skey, pidx[order], rank, nkeys, capacity, N, shape)
    return slots, (evicted | ev) > 0


def pow2_limit(n: int, cap: int) -> int:
    """Round a live-row bound up to the next power of two (capped)."""
    r = 1
    while r < n:
        r *= 2
    return min(r, cap)


def _depth_block(scene: Scene, coord, alive, first_row: int, level: int, csize: int,
                 row_start: int, row_count: int):
    """The z-buffer of table rows [first_row, first_row + len(coord)):
    per cell the least depth and the greatest row at it (INF, -1 where
    no row projects). Returns (depth[ncells], depth_idx[ncells])."""
    n = scene.n_images
    gw, gh = grid_dims(scene, level, csize)
    N = coord.shape[0]
    dev = coord.device
    ids = torch.arange(n, dtype=torch.int32, device=dev)
    xy, _, pvalid = cam.project(
        scene.cams, ids.long().unsqueeze(0), coord.unsqueeze(1), level
    )
    fx = (xy[..., 0] / csize).clamp(-2147483520.0, 2147483520.0)
    fy = (xy[..., 1] / csize).clamp(-2147483520.0, 2147483520.0)
    x0 = torch.floor(fx).to(torch.int32)
    x1 = torch.ceil(fx).to(torch.int32)
    y0 = torch.floor(fy).to(torch.int32)
    y1 = torch.ceil(fy).to(torch.int32)
    depth = coord @ scene.cams.oaxis.T  # [N, n]

    base_valid = pvalid & alive.unsqueeze(1)
    ncells = n * row_count * gw
    dest_l, ok_l = [], []
    for qx, qy in ((x0, y0), (x1, y0), (x0, y1), (x1, y1)):
        qyl = qy - row_start
        ok = (base_valid & (qx >= 0) & (qx < gw) & (qy >= 0) & (qy < gh)
              & (qyl >= 0) & (qyl < row_count))
        d = (ids.unsqueeze(0) * row_count + qyl) * gw + qx
        dest_l.append(torch.where(ok, d, torch.full_like(d, ncells)))
        ok_l.append(ok)
    dest4 = torch.stack(dest_l).reshape(-1).long()
    ok4 = torch.stack(ok_l)
    depth4 = depth.unsqueeze(0).expand(4, N, n)
    dgrid = torch.full((ncells + 1,), INF, dtype=torch.float32, device=dev)
    dgrid.scatter_reduce_(
        0, dest4,
        torch.where(ok4, depth4, torch.full_like(depth4, INF)).reshape(-1),
        reduce="amin",
    )
    pidx4 = (torch.arange(first_row, first_row + N, dtype=torch.int32, device=dev)
             .unsqueeze(1).expand(N, n).unsqueeze(0))
    win = ok4 & (depth4 <= dgrid[dest4].reshape(4, N, n))
    igrid = torch.full((ncells + 1,), -1, dtype=torch.int32, device=dev)
    igrid.scatter_reduce_(
        0, dest4,
        torch.where(win, pidx4, torch.full_like(pidx4, -1)).reshape(-1),
        reduce="amax",
    )
    return dgrid[:-1], igrid[:-1]


def build_depth_maps(
    scene: Scene, table: PatchTable, level: int, csize: int,
    row_start: int = 0, row_count: Optional[int] = None,
    row_limit: Optional[int] = None, *, dp_devices=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Z-buffer rebuild (filter.cpp:580-626): every alive patch projects
    into EVERY image; its optical-axis depth updates the floor/ceil cell
    quad. `row_start` / `row_count` restrict it to a window of cell rows
    (exact there: a cell's minimum only involves pairs that target it).
    `dp_devices` deals the rows [0, row_limit) in contiguous blocks
    (``shard.deal_rows``), each with its own scatter-min; a cell's depth
    is the least of the blocks' (a float minimum is exact), and its index
    the greatest of the blocks' own indices among the blocks at that
    depth, as one scatter over all rows gives it.
    Returns (depth[n, row_count, gw], depth_idx)."""
    n = scene.n_images
    gw, gh = grid_dims(scene, level, csize)
    if row_count is None:
        row_count = gh
    cap = table.capacity
    N = cap if row_limit is None else min(row_limit, cap)
    win = dict(level=level, csize=csize, row_start=row_start, row_count=row_count)
    if not dp_devices:
        depth, idx = _depth_block(scene, table.coord[:N], table.alive[:N], 0, **win)
        return depth.reshape(n, row_count, gw), idx.reshape(n, row_count, gw)

    home = table.coord.device
    on = sh.replicas(dp_devices, home, scene)
    depth = torch.full((n * row_count * gw,), INF, dtype=torch.float32, device=home)
    idx = torch.full_like(depth, -1, dtype=torch.int32)
    parts = []
    for _, d, s, e in sh.deal_rows("grid", N, dp_devices):
        if s < e:
            dgrid, igrid = _depth_block(on[d][0], table.coord[s:e].to(d),
                                        table.alive[s:e].to(d), s, **win)
            parts.append((dgrid.to(home), igrid.to(home)))
    for dgrid, _ in parts:
        depth = torch.minimum(depth, dgrid)
    for dgrid, igrid in parts:
        at_min = torch.where(dgrid == depth, igrid, torch.full_like(igrid, -1))
        idx = torch.maximum(idx, at_min)
    return depth.reshape(n, row_count, gw), idx.reshape(n, row_count, gw)


def build_grid(
    scene: Scene,
    table: PatchTable,
    level: int,
    csize: int,
    capacity: int,
    v_capacity: Optional[int] = None,
    with_depth: bool = True,
    row_limit: Optional[int] = None,
    dp_devices=None,
) -> GridState:
    """Slots, vslots, z-buffer and evictions of the table's rows below
    `row_limit`; `dp_devices` deals those rows to the dp devices in
    contiguous blocks and merges exactly (``_fill_slots``,
    ``build_depth_maps``). The recorder sees it as span ``grid``."""
    if v_capacity is None:
        v_capacity = capacity
    with profiling.span("grid"):
        slots, evicted = _fill_slots(
            scene, table, table.images, level, csize, capacity, row_limit=row_limit,
            dp_devices=dp_devices,
        )
        vslots, _ = _fill_slots(
            scene, table, table.vimages, level, csize, v_capacity,
            row_limit=row_limit, dp_devices=dp_devices,
        )
        if with_depth:
            depth, depth_idx = build_depth_maps(
                scene, table, level, csize, row_limit=row_limit, dp_devices=dp_devices,
            )
        else:
            n = scene.n_images
            gw, gh = grid_dims(scene, level, csize)
            dev = table.coord.device
            depth = torch.full((n, gh, gw), INF, dtype=torch.float32, device=dev)
            depth_idx = torch.full((n, gh, gw), -1, dtype=torch.int32, device=dev)
    return GridState(slots, vslots, depth, depth_idx, evicted)


def is_visible(
    scene: Scene,
    grid: GridState,
    table: PatchTable,
    coord,
    normal,
    image,
    cx,
    cy,
    strict,
    level: int,
    csize: int,
    use_depth: bool = True,
):
    """Occlusion test against the cell z-buffer (patch_manager.cpp:
    335-376): visible when in bounds and either the cell is empty or the
    patch sits within a tolerance of the front surface along its
    viewing ray. All args broadcast."""
    gw, gh = grid_dims(scene, level, csize)
    inb = (cx >= 0) & (cx < gw) & (cy >= 0) & (cy < gh)
    if not use_depth:
        return inb

    img = image.clamp(min=0).long()
    cxs = cx.clamp(0, gw - 1).long()
    cys = cy.clamp(0, gh - 1).long()
    didx = grid.depth_idx[img, cys, cxs]
    empty = didx < 0

    dp_coord = table.coord[didx.clamp(min=0).long()]
    ray = coord - scene.cams.center[img]
    ray = ray / torch.sqrt(torch.clamp((ray * ray).sum(-1, keepdim=True), min=1e-20))
    diff = (ray * (coord - dp_coord)).sum(-1)
    factor = torch.clamp(2.0 + (ray * normal).sum(-1), max=2.0)
    unit = cam.get_unit(scene.cams, img, coord, level)
    near = diff < unit * csize * strict * factor
    return inb & (empty | near)


def visible_extra_views(
    scene: Scene,
    grid: GridState,
    table: PatchTable,
    coord,
    normal,
    images,
    vimages,
    alive,
    level: int,
    csize: int,
    neighbor_threshold: float,
    use_depth: bool = True,
):
    """setVImagesVGrids for a batch (patch_manager.cpp:263-301): every
    view not already in images/vimages joins vimages if the patch passes
    the visibility test there. Existing vimages keep their order; new
    views append in ascending id order. Returns new vimages [B, M]."""
    B, M = images.shape
    n = scene.n_images
    vmember = member_mask(vimages, n)
    known = member_mask(images, n) | vmember

    ids = torch.arange(n, dtype=torch.int32, device=coord.device)
    idl = ids.long().unsqueeze(0)
    xy, _, pvalid = cam.project(scene.cams, idl, coord.unsqueeze(1), level)
    cx = _cell_index(xy[..., 0], csize)
    cy = _cell_index(xy[..., 1], csize)
    vis = is_visible(
        scene, grid, table, coord.unsqueeze(1), normal.unsqueeze(1),
        idl, cx, cy, neighbor_threshold, level, csize, use_depth,
    )
    vis = vis & pvalid & alive.unsqueeze(1)

    vpos = position_in_list(vimages, n).to(torch.float32)
    keys = torch.where(
        vmember,
        vpos,
        torch.where(vis & ~known, M + ids.to(torch.float32), torch.full_like(vpos, INF)),
    )
    return compact_by_keys(keys, big=float(INF))[:, :M]


def set_vimages(
    scene: Scene,
    grid: GridState,
    table: PatchTable,
    level: int,
    csize: int,
    neighbor_threshold: float,
    use_depth: bool = True,
    row_limit: Optional[int] = None,
    chunk: int = 8192,
    dp_devices=None,
):
    """Table-wide setVImagesVGrids, in row chunks. `row_limit` bounds the
    rows scanned (compacted-table invariant); rows beyond it are dead and
    their vimages reset to -1. `dp_devices` deals the rows in contiguous
    blocks (``shard.deal_rows``), each against a replica of the scene,
    grid and table; every row is computed alone."""
    cap = table.capacity
    N = cap if row_limit is None else min(row_limit, cap)
    out = torch.full_like(table.vimages, -1)
    home = table.coord.device
    for _, b0, b1, (scn, grd, tbl) in sh.row_blocks("vimages", N, dp_devices, home,
                                                    scene, grid, table):
        for s in range(b0, b1, chunk):
            e = min(s + chunk, b1)
            out[s:e] = visible_extra_views(
                scn, grd, tbl,
                tbl.coord[s:e], tbl.normal[s:e], tbl.images[s:e],
                tbl.vimages[s:e], tbl.alive[s:e],
                level, csize, neighbor_threshold, use_depth,
            ).to(home)
    return out
