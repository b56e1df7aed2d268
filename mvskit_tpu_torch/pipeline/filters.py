"""Outlier filtering as dense tensor passes (port of
``mvskit_tpu/pipeline/filters.py``).

  * filterOutside — per-patch gain = score2 minus the max pressure of
    non-neighbor co-cell patches (filter.cpp:51-146);
  * filterExact — per (patch, view) visibility against the z-buffer in
    the cell or its 4-neighborhood (filter.cpp:148-263);
  * filterNeighbor + filterQuad — neighbor count gate and a batched
    least-squares quadric residual test (filter.cpp:265-430);
  * filterSmallGroups — connected components under isNeighbor by
    min-label propagation with path halving (filter.cpp:432-578).

Row passes run in chunks; the chunk size bounds memory and does not
change the result.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..core import grid as gridmod
from ..core.patches import PatchTable, count_valid
from ..geometry import camera as cam
from ..image.scene import Scene
from ..ops.ncc import compute_units
from . import views as vw

INF = float(1e30)
COS120 = -0.5


def _ref_unit(scene: Scene, table: PatchTable, idx, level: int):
    """getUnit(patch.images[0], patch.coord) for patch rows `idx`."""
    ref = table.images[idx, 0].clamp(min=0).long()
    return cam.get_unit(scene.cams, ref, table.coord[idx], level)


def score2(table: PatchTable, ncc_threshold):
    """Patch::score2 (patch.cpp:27-29): max(0, ncc - threshold) times
    the number of views."""
    return (torch.clamp(table.ncc - ncc_threshold, min=0.0)
            * count_valid(table.images).to(torch.float32))


def is_neighbor_pairs(scene: Scene, table: PatchTable, a_idx, b_idx, hunit,
                      threshold, radius=None):
    """isNeighbor / isNeighborRadius (pmmvps.cpp:117-180) for index
    pairs. All args broadcast; returns bool."""
    na = table.normal[a_idx]
    nb = table.normal[b_idx]
    ndot = (na * nb).sum(-1)
    diff = table.coord[a_idx] - table.coord[b_idx]
    vunit = table.dscale[a_idx] + table.dscale[b_idx]
    vunit = torch.where(vunit == 0.0, torch.full_like(vunit, 1e-6), vunit)
    f0 = (na * diff).sum(-1)
    f1 = (nb * diff).sum(-1)
    ftmp = (f0.abs() + f1.abs()) / 2.0 / vunit
    hvec = (diff - f0.unsqueeze(-1) * na) + (diff - f1.unsqueeze(-1) * nb)
    hsize = torch.sqrt(torch.clamp((hvec * hvec).sum(-1), min=0.0)) / 2.0 / hunit
    ftmp = torch.where(hsize > 1.0, ftmp / torch.clamp(hsize, max=2.0), ftmp)
    ok = (ndot >= COS120) & (ftmp < threshold)
    if radius is not None:
        ok &= hsize <= radius / hunit
    return ok


def _is_neighbor_vs_table(scene, table, coord, normal, dscale, b_idx, hunit,
                          threshold, radius=None):
    """isNeighbor between explicit self patches [B, 4] (broadcast over
    b_idx's trailing dims) and table rows b_idx."""
    expand = (slice(None),) + (None,) * (b_idx.ndim - 1)
    bl = b_idx.long()
    na = normal[expand]                  # [B, 1.., 4]
    nb = table.normal[bl]                # [B, K.., 4]
    d = coord[expand] - table.coord[bl]
    ndot = (na * nb).sum(-1)
    f0 = (na * d).sum(-1)
    f1 = (nb * d).sum(-1)
    vunit = dscale[expand] + table.dscale[bl]
    vunit = torch.where(vunit == 0.0, torch.full_like(vunit, 1e-6), vunit)
    ftmp = (f0.abs() + f1.abs()) / 2.0 / vunit
    hv = (d - f0.unsqueeze(-1) * na) + (d - f1.unsqueeze(-1) * nb)
    hsize = torch.sqrt(torch.clamp((hv * hv).sum(-1), min=0.0)) / 2.0 / hunit
    ftmp = torch.where(hsize > 1.0, ftmp / torch.clamp(hsize, max=2.0), ftmp)
    ok = (ndot >= COS120) & (ftmp < threshold)
    if radius is not None:
        ok &= hsize <= radius / hunit
    return ok


# ----------------------------------------------------------------------
# filterOutside
# ----------------------------------------------------------------------

def gain_batch(
    scene: Scene,
    grid: gridmod.GridState,
    table: PatchTable,
    coord,
    normal,
    dscale,
    ncc,
    images,
    vimages,
    self_rows,
    level: int,
    csize: int,
    ncc_threshold,
    neighbor_threshold1,
) -> torch.Tensor:
    """Filter::computeGain for a batch of patches (filter.cpp:108-146).
    `self_rows` [B] gives each entry's table row (a patch never presses
    on itself); -1 for hypotheses not in the table (Optim::check runs
    the same gain on not-yet-inserted patches, optim.cpp:300-309)."""
    nimg = count_valid(images).to(torch.float32)
    gains = torch.clamp(ncc - ncc_threshold, min=0.0) * nimg
    ref = images[:, 0].clamp(min=0).long()
    self_unit = cam.get_unit(scene.cams, ref, coord, level)
    gh, gw = grid.slots.shape[1], grid.slots.shape[2]

    def pressure_over(lists, need_depth_gate):
        cx, cy, valid = gridmod.patch_cells(scene, coord, lists, level, csize)
        img = lists.clamp(min=0).long()
        cell = grid.slots[img, cy.clamp(0, gh - 1).long(), cx.clamp(0, gw - 1).long()]
        occupied = cell >= 0
        cidx = cell.clamp(min=0)
        hunit = (
            (self_unit[:, None, None] + _ref_unit(scene, table, cidx.long(), level))
            / 2.0 * csize
        )
        nb = _is_neighbor_vs_table(
            scene, table, coord, normal, dscale, cidx, hunit,
            neighbor_threshold1,
        )
        press = table.ncc[cidx.long()] - ncc_threshold
        use = (
            occupied & valid.unsqueeze(-1) & ~nb
            & (cidx != self_rows[:, None, None])
        )
        if need_depth_gate:
            # only co-cell patches BEHIND this patch press on it
            # (filter.cpp:136-141)
            oax = scene.cams.oaxis[img]                           # [B, M, 4]
            pdepth = (oax * coord.unsqueeze(1)).sum(-1).unsqueeze(-1)
            bdepth = (oax.unsqueeze(2) * table.coord[cidx.long()]).sum(-1)
            use = use & (pdepth < bdepth)
        maxp = torch.where(use, press, torch.zeros_like(press)).amax(2).clamp(min=0.0)
        return torch.where(valid, maxp, torch.zeros_like(maxp)).sum(1)

    gains = gains - pressure_over(images, False)
    gains = gains - pressure_over(vimages, True)
    return gains


def compute_gains(scene, grid, table, level, csize, ncc_threshold,
                  neighbor_threshold1, chunk: int = 1024, row_limit=None):
    """Filter::computeGain for every table row, in row chunks; rows past
    `row_limit` (dead by the compacted-table invariant) get gain 0."""
    cap = table.capacity
    N = cap if row_limit is None else min(row_limit, cap)
    out = torch.zeros(cap, dtype=torch.float32, device=table.coord.device)
    for s in range(0, N, chunk):
        rs = torch.arange(s, min(s + chunk, N), device=table.coord.device)
        out[s:s + rs.shape[0]] = gain_batch(
            scene, grid, table,
            table.coord[rs], table.normal[rs], table.dscale[rs],
            table.ncc[rs], table.images[rs], table.vimages[rs],
            rs.to(torch.int32), level, csize, ncc_threshold,
            neighbor_threshold1,
        )
    return out


def filter_outside(scene, grid, table, level, csize, ncc_threshold,
                   neighbor_threshold1, row_limit=None) -> Tuple[PatchTable, int]:
    """Remove patches with negative gain (filter.cpp:51-97)."""
    gains = compute_gains(scene, grid, table, level, csize, ncc_threshold,
                          neighbor_threshold1, row_limit=row_limit)
    kill = table.alive & (gains < 0.0)
    return table._replace(alive=table.alive & ~kill), int(kill.sum())


# ----------------------------------------------------------------------
# filterExact
# ----------------------------------------------------------------------

def filter_exact(
    scene, grid, table, level, csize, wsize, min_image_num,
    neighbor_threshold1, angle_threshold1, use_depth: bool = True,
    row_limit=None, chunk: int = 8192,
) -> Tuple[PatchTable, int]:
    """Per-(patch, view) exact visibility (filter.cpp:148-263): a view
    survives if the patch passes isVisible in its cell or any 4-neighbor
    cell; patches under minImageNum die. Survivors re-pick their
    reference view (setRefImage)."""
    cap, M = table.images.shape
    N = cap if row_limit is None else min(row_limit, cap)
    new_images = torch.full_like(table.images, -1)
    enough = torch.zeros(cap, dtype=torch.bool, device=table.coord.device)
    for s in range(0, N, chunk):
        e = min(s + chunk, N)
        coord, normal, images = table.coord[s:e], table.normal[s:e], table.images[s:e]
        cx, cy, valid = gridmod.patch_cells(scene, coord, images, level, csize)
        img = images.clamp(min=0)

        def vis_at(dx, dy):
            return gridmod.is_visible(
                scene, grid, table, coord.unsqueeze(1), normal.unsqueeze(1),
                img, cx + dx, cy + dy, neighbor_threshold1, level, csize,
                use_depth,
            )

        safe = (vis_at(0, 0) | vis_at(-1, 0) | vis_at(1, 0)
                | vis_at(0, -1) | vis_at(0, 1))
        ni = vw.compact_list(images, valid & safe)
        en = count_valid(ni) >= min_image_num
        ni = vw.set_ref_image(scene, coord, normal, ni, level, wsize,
                              angle_threshold1)
        new_images[s:e] = torch.where(en.unsqueeze(1), ni, torch.full_like(ni, -1))
        enough[s:e] = en
    killed = table.alive & ~enough
    return (
        table._replace(
            images=torch.where(table.alive.unsqueeze(1), new_images, table.images),
            alive=table.alive & enough,
        ),
        int(killed.sum()),
    )


# ----------------------------------------------------------------------
# neighbor gathering (findNeighbors) + filterNeighbor/filterQuad
# ----------------------------------------------------------------------

def compute_radius_batch(scene: Scene, coord, normal, images, level: int, csize: int):
    """Propagate::computeRadius (propagate.cpp:474-481): second-smallest
    per-view unit times csize."""
    units = compute_units(scene, images, coord, normal, level)
    two = torch.sort(units, dim=1).values[:, :2]
    return two[:, 1] * csize


def compute_radius(scene: Scene, table: PatchTable, level: int, csize: int):
    return compute_radius_batch(scene, table.coord, table.normal,
                                table.images, level, csize)


def gather_neighbors_batch(
    scene, grid, table, coord, normal, dscale, lists, self_rows, level,
    csize, margin: int, scale: float, neighbor_threshold,
    max_neighbors: int, cand_cap: int = 1024,
):
    """findNeighbors (patch_manager.cpp:671-728) for explicit self-patch
    attributes: candidates from (2*margin+1)^2 cells around the patch in
    every view of its list, over both slot grids, deduplicated, gated by
    isNeighborRadius, first `max_neighbors` returned. Returns
    (nbrs[B, K] int32 -1-pad, count[B] distinct before capping)."""
    B = coord.shape[0]
    N = table.images.shape[0]
    gh, gw = grid.slots.shape[1], grid.slots.shape[2]
    dev = coord.device

    cx, cy, valid = gridmod.patch_cells(scene, coord, lists, level, csize)
    radius = 1.5 * margin * compute_radius_batch(
        scene, coord, normal, lists, level, csize
    )
    idx = lists.clamp(min=0).long()
    units = cam.get_unit(scene.cams, idx, coord.unsqueeze(1), level)
    nimg = torch.clamp(count_valid(lists), min=1)
    hunit = torch.where(lists >= 0, units, torch.zeros_like(units)).sum(1) / nimg * csize

    cands = []
    for dy in range(-margin, margin + 1):
        for dx in range(-margin, margin + 1):
            ty, tx = cy + dy, cx + dx
            inb = (valid & (ty >= 0) & (ty < gh) & (tx >= 0) & (tx < gw)).unsqueeze(-1)
            tyc, txc = ty.clamp(0, gh - 1).long(), tx.clamp(0, gw - 1).long()
            for slots in (grid.slots, grid.vslots):
                c = slots[idx, tyc, txc]
                cands.append(torch.where(inb, c, torch.full_like(c, -1)).reshape(B, -1))
    cand = torch.cat(cands, dim=1)  # [B, Kc]
    Kc = cand.shape[1]

    # compact + dedup first, then test (the test depends only on the
    # candidate's table row)
    cand_cap = min(cand_cap, Kc)
    vals = torch.where(cand >= 0, cand, torch.full_like(cand, N))
    svals = torch.sort(vals, dim=1).values
    uniq = torch.ones_like(svals, dtype=torch.bool)
    uniq[:, 1:] = svals[:, 1:] != svals[:, :-1]
    uniq &= svals < N
    rank = torch.cumsum(uniq.to(torch.int32), dim=1) - 1
    dest = torch.where(uniq & (rank < cand_cap), rank, torch.full_like(rank, cand_cap))
    rows = torch.arange(B, device=dev).unsqueeze(1).expand(B, Kc)
    ucand = torch.full((B, cand_cap + 1), N, dtype=torch.int32, device=dev)
    ucand[rows, dest.long()] = svals
    ucand = ucand[:, :cand_cap]

    cidx = torch.clamp(ucand, max=N - 1)
    ok = (ucand < N) & table.alive[cidx.long()] & (cidx != self_rows.unsqueeze(1))
    ok &= _is_neighbor_vs_table(
        scene, table, coord, normal, dscale, cidx, hunit.unsqueeze(1),
        neighbor_threshold * scale, radius.unsqueeze(1),
    )
    count = ok.sum(1)
    vals2 = torch.where(ok, cidx, torch.full_like(cidx, N))
    sv2 = torch.sort(vals2, dim=1).values[:, :max_neighbors]
    nbrs = torch.where(sv2 < N, sv2, torch.full_like(sv2, -1)).to(torch.int32)
    return nbrs, count


def _ortho(z):
    """Plane basis (filter.cpp:394-409 / propagate.cpp:483-498)."""
    ax = z[..., 0].abs()
    ay = z[..., 1].abs()
    zeros = torch.zeros_like(z[..., 0])
    x_a = torch.stack([z[..., 1], -z[..., 0], zeros, zeros], dim=-1)
    x_b = torch.stack([zeros, z[..., 2], -z[..., 1], zeros], dim=-1)
    x_c = torch.stack([-z[..., 2], zeros, z[..., 0], zeros], dim=-1)
    x = torch.where(
        (ax > 0.5).unsqueeze(-1), x_a,
        torch.where((ay > 0.5).unsqueeze(-1), x_b, x_c),
    )
    x = x / torch.sqrt(torch.clamp((x * x).sum(-1, keepdim=True), min=1e-20))
    y3 = torch.linalg.cross(z[..., :3], x[..., :3], dim=-1)
    y = torch.cat([y3, torch.zeros_like(z[..., :1])], dim=-1)
    return x, y


def quad_residuals_batch(scene, table, coord, normal, images, nbrs, level: int, tau: int):
    """Filter::filterQuad residual (filter.cpp:329-392): fit a quadric
    z = f(x, y) over the neighbors in the patch plane frame; return the
    mean |residual| / unit normalized by (nsize - 5), and nsize - 5.
    Masked least squares via 5x5 normal equations; a singular system
    gives non-finite values, as jnp.linalg.solve does."""
    xdir, ydir = _ortho(normal)
    nok = nbrs >= 0
    nc = table.coord[nbrs.clamp(min=0).long()]          # [B, K, 4]
    dc = nc - coord.unsqueeze(1)
    dist = torch.sqrt(torch.clamp((dc * dc).sum(-1), min=0.0))
    fxs = (dc * xdir.unsqueeze(1)).sum(-1)
    fys = (dc * ydir.unsqueeze(1)).sum(-1)
    fzs = (dc * normal.unsqueeze(1)).sum(-1)
    cnt = torch.clamp(nok.sum(1), min=1)
    h = torch.where(nok, dist, torch.zeros_like(dist)).sum(1) / cnt
    h = torch.where(h == 0.0, torch.ones_like(h), h)
    fxs = fxs / h.unsqueeze(1)
    fys = fys / h.unsqueeze(1)

    A = torch.stack([fxs * fxs, fys * fys, fxs * fys, fxs, fys], dim=-1)
    Aw = torch.where(nok.unsqueeze(-1), A, torch.zeros_like(A))
    bw = torch.where(nok, fzs, torch.zeros_like(fzs))
    AtA = Aw.transpose(1, 2) @ Aw
    AtA = AtA + 1e-8 * torch.eye(5, device=coord.device).unsqueeze(0)
    Atb = (Aw.transpose(1, 2) @ bw.unsqueeze(-1))
    x = torch.linalg.solve_ex(AtA, Atb, check_errors=False).result[..., 0]

    lists = images[:, :tau]
    idx = lists.clamp(min=0).long()
    units = cam.get_unit(scene.cams, idx, coord.unsqueeze(1), level)
    ucnt = torch.clamp((lists >= 0).sum(1), min=1)
    unit = torch.where(lists >= 0, units, torch.zeros_like(units)).sum(1) / ucnt
    unit = torch.where(unit == 0.0, torch.ones_like(unit), unit)

    pred = (A @ x.unsqueeze(-1))[..., 0]
    res = (pred - fzs).abs() / unit.unsqueeze(1)
    total = torch.where(nok, res, torch.zeros_like(res)).sum(1)
    denom = nok.sum(1) - 5
    return total / torch.clamp(denom, min=1), denom


def filter_neighbor_rows(
    scene, grid, table, row_offset: int, row_count: int, level, csize, tau,
    quad_threshold, neighbor_threshold, max_neighbors: int = 48,
    chunk: int = 1024, cand_cap: int = 1024,
) -> Tuple[PatchTable, int]:
    """filterNeighbor (filter.cpp:265-327) over rows [row_offset,
    row_offset + row_count): fewer than 6 scene-space neighbors, or a
    too-large quadric residual, kills the patch. Every chunk sees the
    table as it was at the start of the pass; kills apply at the end."""
    N = table.capacity
    dev = table.coord.device
    rows_all = (row_offset + torch.arange(row_count, device=dev)) % N
    reject = torch.zeros(row_count, dtype=torch.bool, device=dev)
    for s in range(0, row_count, chunk):
        rows = rows_all[s:s + chunk]
        nbrs, count = gather_neighbors_batch(
            scene, grid, table, table.coord[rows], table.normal[rows],
            table.dscale[rows], table.images[rows], rows.to(torch.int32),
            level, csize, margin=2, scale=4.0,
            neighbor_threshold=neighbor_threshold,
            max_neighbors=max_neighbors, cand_cap=cand_cap,
        )
        resid, denom = quad_residuals_batch(
            scene, table, table.coord[rows], table.normal[rows],
            table.images[rows], nbrs, level, tau,
        )
        reject[s:s + rows.shape[0]] = (count < 6) | ((denom >= 1) & (resid >= quad_threshold))
    kill = table.alive[rows_all] & reject
    alive = table.alive.clone()
    alive[rows_all] = table.alive[rows_all] & ~reject
    return table._replace(alive=alive), int(kill.sum())


# ----------------------------------------------------------------------
# filterSmallGroups
# ----------------------------------------------------------------------

def filter_small_groups(
    scene, grid, table, level, csize, neighbor_threshold2, iters: int = 32,
    row_limit=None, chunk: int = 2048,
) -> Tuple[PatchTable, int]:
    """filterSmallGroups (filter.cpp:432-578): connected components
    under isNeighbor over the reference-view 3x3 cell graph; components
    smaller than max(20, alive/10000) are removed. BFS becomes min-label
    propagation with path halving."""
    cap, M = table.images.shape
    N = cap if row_limit is None else min(row_limit, cap)
    gh, gw = grid.slots.shape[1], grid.slots.shape[2]
    dev = table.coord.device

    ref_list = table.images[:N, :1]
    cx, cy, valid = gridmod.patch_cells(scene, table.coord[:N], ref_list, level, csize)
    cx, cy, valid = cx[:, 0], cy[:, 0], valid[:, 0]
    img = table.images[:N, 0].clamp(min=0).long()

    cands = []
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            ty, tx = cy + dy, cx + dx
            inb = (valid & (ty >= 0) & (ty < gh) & (tx >= 0) & (tx < gw)).unsqueeze(1)
            tyc, txc = ty.clamp(0, gh - 1).long(), tx.clamp(0, gw - 1).long()
            for slots in (grid.slots, grid.vslots):
                c = slots[img, tyc, txc]
                cands.append(torch.where(inb, c, torch.full_like(c, -1)))
    cand = torch.cat(cands, dim=1)  # [N, Kc]
    cidx = cand.clamp(0, N - 1).long()
    me = torch.arange(N, device=dev)
    ref_unit_all = _ref_unit(scene, table, me, level)  # [N]

    edge = torch.empty(cand.shape, dtype=torch.bool, device=dev)
    for s in range(0, N, chunk):
        rs = me[s:s + chunk]
        cc = cidx[rs]
        hunit = (ref_unit_all[rs].unsqueeze(1) + ref_unit_all[cc]) / 2.0 * csize
        edge[s:s + rs.shape[0]] = (
            (cand[rs] >= 0)
            & table.alive[cc]
            & table.alive[rs].unsqueeze(1)
            & is_neighbor_pairs(scene, table, rs.unsqueeze(1), cc, hunit,
                                neighbor_threshold2)
        )

    alive_n = table.alive[:N]
    label = torch.where(alive_n, me, torch.full_like(me, N))
    bigN = torch.full_like(cidx, N)
    for _ in range(iters):
        nl = torch.where(edge, label[cidx], bigN).amin(1).clamp(max=N)
        label = torch.minimum(label, nl)
        # path halving: label <- label[label]
        hop = label[label.clamp(0, N - 1)]
        label = torch.minimum(label, torch.where(label < N, hop, torch.full_like(hop, N)))

    sizes = torch.zeros(N + 1, dtype=torch.int64, device=dev)
    sizes.index_add_(0, label.clamp(0, N), alive_n.to(torch.int64))
    psize = int(table.alive.sum())
    threshold = max(20, psize // 10000)
    small = torch.zeros(cap, dtype=torch.bool, device=dev)
    small[:N] = sizes[label.clamp(0, N)] < threshold
    kill = table.alive & small
    return table._replace(alive=table.alive & ~kill), int(kill.sum())


# ----------------------------------------------------------------------
# orchestration
# ----------------------------------------------------------------------

class FilterStats(NamedTuple):
    outside: int
    exact: int
    neighbor: int
    groups: int


def rebuild(scene, table, level, csize, capacity, neighbor_threshold,
            additive: bool, use_depth: bool = True, row_limit=None):
    """setDepthMapsVGridsVPGridsAddPatchV (filter.cpp:628-655): rebuild
    depth maps, (re)derive vimages (cleared first when additive=0), and
    rebuild the v-grids."""
    if not additive:
        table = table._replace(vimages=torch.full_like(table.vimages, -1))
    grid = gridmod.build_grid(scene, table, level, csize, capacity,
                              row_limit=row_limit)
    vimages = gridmod.set_vimages(scene, grid, table, level, csize,
                                  neighbor_threshold, use_depth,
                                  row_limit=row_limit)
    table = table._replace(vimages=vimages)
    grid = gridmod.build_grid(scene, table, level, csize, capacity,
                              row_limit=row_limit)
    return table, grid


def run_filters(
    scene, table, *, level, csize, wsize, tau, min_image_num, cell_capacity,
    ncc_threshold, quad_threshold, neighbor_threshold, neighbor_threshold1,
    neighbor_threshold2, angle_threshold1, neighbor_chunk: int = 1024,
    neighbor_cand_cap: int = 1024, neighbor_capacity: int = 48,
    small_group_iters: int = 32, row_limit=None, neighbor_rows=None,
) -> Tuple[PatchTable, FilterStats]:
    """Filter::run (filter.cpp:25-49): rebuild -> outside -> rebuild ->
    exact -> rebuild -> neighbor -> rebuild -> groups -> rebuild.
    `row_limit` bounds the rows every phase scans (compacted-table
    invariant); `neighbor_rows` (default: the same bound) the rows the
    neighbor filter tests."""
    R = row_limit

    def rb(t, additive):
        return rebuild(scene, t, level, csize, cell_capacity,
                       neighbor_threshold, additive=additive, row_limit=R)

    table, grid = rb(table, False)
    table, n_out = filter_outside(scene, grid, table, level, csize,
                                  ncc_threshold, neighbor_threshold1,
                                  row_limit=R)
    table, grid = rb(table, True)
    table, n_exact = filter_exact(scene, grid, table, level, csize, wsize,
                                  min_image_num, neighbor_threshold1,
                                  angle_threshold1, row_limit=R)
    table, grid = rb(table, True)
    rows = table.capacity if R is None else min(R, table.capacity)
    if neighbor_rows is not None:
        rows = min(rows, neighbor_rows)
    table, n_nb = filter_neighbor_rows(
        scene, grid, table, 0, rows, level, csize, tau, quad_threshold,
        neighbor_threshold, max_neighbors=neighbor_capacity,
        chunk=neighbor_chunk, cand_cap=neighbor_cand_cap,
    )
    table, grid = rb(table, True)
    table, n_grp = filter_small_groups(scene, grid, table, level, csize,
                                       neighbor_threshold2,
                                       iters=small_group_iters, row_limit=R)
    table, _ = rb(table, True)
    return table, FilterStats(n_out, n_exact, n_nb, n_grp)


# ----------------------------------------------------------------------
# in-gauntlet check (depth >= 2)
# ----------------------------------------------------------------------

def check_batch(
    scene, grid, table, coord, normal, dscale, ncc, images, vimages, *,
    level: int, csize: int, tau: int, ncc_threshold, quad_threshold,
    neighbor_threshold, neighbor_threshold1, max_neighbors: int = 48,
    cand_cap: int = 1024,
):
    """Optim::check (optim.cpp:300-323) on a hypothesis batch: reject
    when the occlusion gain is negative, or when >6 scene-space
    neighbors exist and the quadric residual is too large. Returns the
    reject mask [B]."""
    B = coord.shape[0]
    no_rows = torch.full((B,), -1, dtype=torch.int32, device=coord.device)
    gains = gain_batch(scene, grid, table, coord, normal, dscale, ncc, images,
                       vimages, no_rows, level, csize, ncc_threshold,
                       neighbor_threshold1)
    reject = gains < 0.0
    nbrs, count = gather_neighbors_batch(
        scene, grid, table, coord, normal, dscale, images, no_rows, level,
        csize, margin=2, scale=4.0, neighbor_threshold=neighbor_threshold,
        max_neighbors=max_neighbors, cand_cap=cand_cap,
    )
    resid, denom = quad_residuals_batch(scene, table, coord, normal, images,
                                        nbrs, level, tau)
    return reject | ((count > 6) & (denom >= 1) & (resid >= quad_threshold))
