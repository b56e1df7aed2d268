"""Struct-of-arrays patch state (port of ``mvskit_tpu/core/patches.py``).

One dense table replaces the reference's pointer graph of patches
(pmmvps/patch.hpp:23-67). ``images[N, M]`` is the ordered view list of
each patch (-1 padded, entry 0 the reference view); ``vimages`` the
extra visible views.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..utils import profiling


class PatchTable(NamedTuple):
    coord: torch.Tensor    # [N, 4] homogeneous, w = 1
    normal: torch.Tensor   # [N, 4]
    ncc: torch.Tensor      # [N]
    dscale: torch.Tensor   # [N]
    ascale: torch.Tensor   # [N]
    images: torch.Tensor   # [N, M] int32, -1 pad
    vimages: torch.Tensor  # [N, M] int32, -1 pad
    alive: torch.Tensor    # [N] bool

    @property
    def capacity(self) -> int:
        return self.coord.shape[0]

    @property
    def max_views(self) -> int:
        return self.images.shape[1]

    def n_images_per_patch(self) -> torch.Tensor:
        """[N] count of listed views per row, on the table's device."""
        return count_valid(self.images)

    def n_alive(self) -> int:
        with profiling.sync("table.n_alive"):
            return int(self.alive.sum())


def empty_table(capacity: int, max_views: int, device) -> PatchTable:
    coord = torch.zeros((capacity, 4), dtype=torch.float32, device=device)
    coord[:, 3] = 1.0
    return PatchTable(
        coord=coord,
        normal=torch.zeros((capacity, 4), dtype=torch.float32, device=device),
        ncc=torch.full((capacity,), -1.0, dtype=torch.float32, device=device),
        dscale=torch.zeros((capacity,), dtype=torch.float32, device=device),
        ascale=torch.zeros((capacity,), dtype=torch.float32, device=device),
        images=torch.full((capacity, max_views), -1, dtype=torch.int32, device=device),
        vimages=torch.full((capacity, max_views), -1, dtype=torch.int32, device=device),
        alive=torch.zeros((capacity,), dtype=torch.bool, device=device),
    )


def from_numpy(
    coord: np.ndarray,
    normal: np.ndarray,
    images: np.ndarray,
    capacity: int,
    max_views: int,
    ncc=None,
    dscale=None,
    ascale=None,
    vimages=None,
    *,
    device,
) -> PatchTable:
    """Host-side constructor padding a seed set up to `capacity`."""
    n = coord.shape[0]
    if n > capacity:
        raise ValueError(f"{n} patches exceed the table capacity {capacity}")
    t = empty_table(capacity, max_views, device)

    def put(dst, src):
        with profiling.sync("table.copy"):
            dst[:n] = torch.as_tensor(np.asarray(src), device=device).to(dst.dtype)

    put(t.coord, coord)
    put(t.normal, normal)
    put(t.images, np.asarray(images)[:, :max_views])
    t.alive[:n] = True
    for dst, src in ((t.ncc, ncc), (t.dscale, dscale), (t.ascale, ascale)):
        if src is not None:
            put(dst, src)
    if vimages is not None:
        put(t.vimages, np.asarray(vimages)[:, :max_views])
    return t


def compact_table(table: PatchTable) -> PatchTable:
    """Move alive rows to the front, stable in row order, so row loops
    and the grid build can bound themselves to the live prefix."""
    order = torch.argsort((~table.alive).to(torch.uint8), stable=True)
    return PatchTable(*(x[order] for x in table))


def count_valid(lst: torch.Tensor) -> torch.Tensor:
    """Number of non-(-1) entries per row of an index list."""
    return (lst >= 0).sum(-1)


def member_mask(lst: torch.Tensor, n_images: int) -> torch.Tensor:
    """[..., M] ordered list -> [..., n_images] bool membership."""
    ids = torch.arange(n_images, dtype=lst.dtype, device=lst.device)
    return (lst.unsqueeze(-1) == ids).any(-2)


def position_in_list(lst: torch.Tensor, n_images: int) -> torch.Tensor:
    """[..., M] list -> [..., n_images] position of each view id in the
    list (first occurrence), or M where absent."""
    M = lst.shape[-1]
    ids = torch.arange(n_images, dtype=lst.dtype, device=lst.device)
    eq = lst.unsqueeze(-1) == ids  # [..., M, n]
    pos = torch.argmax(eq.to(torch.uint8), dim=-2)
    present = eq.any(-2)
    return torch.where(present, pos, torch.full_like(pos, M)).to(torch.int32)


def compact_by_keys(keys: torch.Tensor, big: float = 1e30) -> torch.Tensor:
    """Turn per-view sort keys [..., n_images] (big == excluded) into an
    ordered view list [..., n_images] (-1 pad), ascending by key, ties
    by view id."""
    sorted_keys, order = torch.sort(keys, dim=-1, stable=True)
    order = order.to(torch.int32)
    return torch.where(sorted_keys < big, order, torch.full_like(order, -1))
