"""Carry state between the JAX package and the port as numpy arrays.

The caller turns each JAX field into numpy (``np.asarray``); these
functions build the port's Scene and PatchTable from them on a given
device, and turn a PatchTable back into numpy. Nothing here imports jax.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from .core.patches import PatchTable
from .geometry.camera import make_camera_set
from .image.scene import Scene, scene_from_planes

TABLE_FIELDS = ("coord", "normal", "ncc", "dscale", "ascale", "images",
                "vimages", "alive")
_DTYPES = {"images": np.int32, "vimages": np.int32, "alive": np.bool_}


def scene_from_numpy(
    planes: np.ndarray,
    planes_packed: np.ndarray,
    masks: Optional[np.ndarray],
    P: np.ndarray,
    offsets: Sequence[int],
    widths: Sequence[int],
    heights: Sequence[int],
    max_level: int,
    device="cpu",
    planes_luma_quad: Optional[np.ndarray] = None,
) -> Scene:
    """A Scene from the JAX Scene's planes [n, I, total, 3],
    planes_packed [n, I, total], masks [n, total] (or None), the level-0
    projections P [n, 3, 4] (float64 as built, so the derived camera
    quantities match), the static level metadata and, optionally, its
    planes_luma_quad [n, I, total] (else built from `planes`)."""
    cams = make_camera_set(np.asarray(P, np.float64), device)
    return scene_from_planes(planes, planes_packed, masks, cams, offsets,
                             widths, heights, max_level, device,
                             planes_luma_quad=planes_luma_quad)


def table_from_numpy(fields: Dict[str, np.ndarray], device="cpu") -> PatchTable:
    """A PatchTable from a dict of coord/normal/ncc/dscale/ascale/images/
    vimages/alive numpy arrays."""
    return PatchTable(**{
        k: torch.tensor(
            np.asarray(fields[k], _DTYPES.get(k, np.float32)), device=device
        )
        for k in TABLE_FIELDS
    })


def table_to_numpy(table: PatchTable) -> Dict[str, np.ndarray]:
    """The PatchTable's fields as numpy arrays."""
    return {k: getattr(table, k).detach().cpu().numpy() for k in TABLE_FIELDS}
