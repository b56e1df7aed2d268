"""Meshes, placement, collectives and view sharding (port of
``mvskit_tpu/parallel/shard.py``).

One controller in one process drives a ``Mesh``: a numpy object array of
``torch.device``s, one per logical shard, with axis names (JAX's ``Mesh``
+ ``shard_map``). Devices may repeat: ``[cpu] * 8`` stands in for the JAX
tests' eight virtual CPU devices, ``[cuda:0] * k`` puts k shards on one
card. Only an explicit ``devices=`` list repeats a device; ``make_mesh``
on ``cuda`` takes distinct cards or raises.

The collectives are explicit functions on per-shard tensors: ``psum``
(sum the shards' parts on one device), ``ppermute_rows`` (hand each
shard's boundary row to its neighbours) and ``all_gather_rows``
(concatenate row blocks). A tensor moves between devices with ``.to``,
which is a no-op where two shards share a device.

JAX's ``NamedSharding`` / ``PartitionSpec`` have no counterpart: a
tensor here lives on one device. ``shard_rows`` (``shard_table``'s
counterpart) returns the row blocks themselves, one per device of the
axis, and ``replicate`` a copy on one device.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..core.patches import PatchTable
from ..image.scene import Scene, ViewShard

# the driver's mesh axes, in the order of MVSConfig's mesh_dp, mesh_view,
# mesh_tile (JAX driver.py:117-122)
MESH_AXES = ("dp", "view", "tile")


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """Devices shaped by named axes. ``shape`` maps each axis name to its
    size, as JAX's ``Mesh.shape`` does."""

    devices: np.ndarray
    axis_names: Tuple[str, ...]

    def __post_init__(self):
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"mesh of shape {self.devices.shape} with axes "
                             f"{self.axis_names}")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return self.devices.size

    def axis_devices(self, axis: str) -> List[torch.device]:
        """The devices along `axis`, at index 0 of every other axis."""
        at = [0] * self.devices.ndim
        at[self.axis_names.index(axis)] = slice(None)
        return list(self.devices[tuple(at)])


def make_mesh(n_devices: Union[int, Sequence[int], None] = None,
              axis: Union[str, Sequence[str]] = "dp", device="cuda",
              devices: Optional[Sequence] = None) -> Mesh:
    """A mesh of `n_devices` (an int, or one size per name in `axis`).

    With `devices` it takes that list (repeats allowed; its length must
    be the mesh size). Else on ``cuda`` it takes the first distinct CUDA
    devices and raises ValueError when there are fewer (JAX driver.py:
    110-116); on ``cpu`` it takes copies of the CPU."""
    axes = (axis,) if isinstance(axis, str) else tuple(axis)
    if devices is not None:
        devs = [torch.device(d) for d in devices]
        if n_devices is None:
            n_devices = len(devs)
    else:
        dev = torch.device(device)
        if dev.type == "cuda":
            have = torch.cuda.device_count() if torch.cuda.is_available() else 0
            n = have if n_devices is None else int(np.prod(n_devices))
            if have < n:
                raise ValueError(
                    f"mesh {tuple(np.atleast_1d(n_devices))} needs {n} CUDA devices, "
                    f"have {have} (pass devices= to put several shards on one card)")
            devs = [torch.device("cuda", i) for i in range(n)]
        elif dev.type == "cpu":
            devs = [dev] * (1 if n_devices is None else int(np.prod(n_devices)))
        else:
            raise ValueError(f"unsupported mesh device {device!r}")
    shape = (n_devices,) if isinstance(n_devices, int) else tuple(n_devices)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} for axes {axes}")
    if int(np.prod(shape)) != len(devs):
        raise ValueError(f"mesh shape {shape} needs {int(np.prod(shape))} devices, "
                         f"got {len(devs)}")
    arr = np.empty(len(devs), dtype=object)
    arr[:] = devs
    return Mesh(arr.reshape(shape), axes)


# ----------------------------------------------------------------------
# placement
# ----------------------------------------------------------------------

_SHARD_FIELDS = ("view_mesh", "view_shards", "view_group")


def replicate(tree, device):
    """A copy of `tree` (a tensor, NamedTuple, Scene, tuple, list or dict
    of them) on `device`; tensors already there are not copied. A Scene's
    view shards stay on their own devices."""
    device = torch.device(device)
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, Scene):
        return dataclasses.replace(tree, **{
            f.name: replicate(getattr(tree, f.name), device)
            for f in dataclasses.fields(tree) if f.name not in _SHARD_FIELDS})
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(replicate(x, device) for x in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(replicate(x, device) for x in tree)
    if isinstance(tree, dict):
        return {k: replicate(v, device) for k, v in tree.items()}
    return tree


def shard_rows(x, mesh: Mesh, axis: str = "dp"):
    """The row blocks of a tensor or PatchTable over the devices of
    `axis`, in order, each on its device: ceil(rows / k) rows each, the
    last block shorter where k does not divide the rows."""
    devs = mesh.axis_devices(axis)
    if isinstance(x, PatchTable):
        parts = [shard_rows(f, mesh, axis) for f in x]
        return [PatchTable(*blocks) for blocks in zip(*parts)]
    per = -(-x.shape[0] // len(devs))
    return [x[i * per:(i + 1) * per].to(d) for i, d in enumerate(devs)]


# ----------------------------------------------------------------------
# collectives on per-shard tensors
# ----------------------------------------------------------------------

def psum(parts: Sequence[torch.Tensor], device) -> torch.Tensor:
    """The sum of the shards' parts on `device`, added in shard order."""
    out = parts[0].to(device)
    for x in parts[1:]:
        out = out + x.to(device)
    return out


def ppermute_rows(blocks: Sequence[torch.Tensor], fill):
    """The 1-row halo exchange of per-shard [n, rows, ...] blocks (JAX
    tiles._halo_rows): for shard i, the last row of shard i - 1 and the
    first row of shard i + 1, each on shard i's device, `fill`-valued at
    the mesh edges. Returns (from_prev, from_next), one per shard."""
    k = len(blocks)
    prev, nxt = [], []
    for i, b in enumerate(blocks):
        edge = torch.full_like(b[:, :1], fill)
        prev.append(blocks[i - 1][:, -1:].to(b.device) if i > 0 else edge)
        nxt.append(blocks[i + 1][:, :1].to(b.device) if i < k - 1 else edge)
    return prev, nxt


def all_gather_rows(blocks: Sequence[torch.Tensor], device, dim: int = 0) -> torch.Tensor:
    """The shards' row blocks concatenated along `dim` on `device`."""
    return torch.cat([b.to(device) for b in blocks], dim)


# ----------------------------------------------------------------------
# view sharding
# ----------------------------------------------------------------------

def view_shard_scene(scene: Scene, base: int, count: int, device) -> Scene:
    """The sampler's Scene of views [base, base + count) on `device`:
    plane slices (views of the same tensors where `device` is theirs),
    cameras and level metadata replicated (so its ``n_images`` still
    counts every view), no masks (the sampler reads none)."""
    device = torch.device(device)
    sl = lambda t: t[base:base + count].to(device)  # noqa: E731
    rep = replicate(dataclasses.replace(
        scene, masks=None, covis=None, view_mesh=None, view_shards=(),
        view_group=None), device)
    return dataclasses.replace(
        rep, planes=sl(scene.planes), planes_packed=sl(scene.planes_packed),
        planes_luma_quad=sl(scene.planes_luma_quad))


def check_view_split(n_images: int, k: int, axis: str = "view") -> int:
    """Views per shard; ValueError unless k divides n_images (JAX
    shard.py:99-104)."""
    if k < 1 or n_images % k != 0:
        raise ValueError(f"n_images={n_images} not divisible by mesh axis {axis}={k}")
    return n_images // k


def enable_view_sharding(scene: Scene, mesh: Mesh, axis: str = "view") -> Scene:
    """Mark the scene view-sharded over `axis` of `mesh`: shard i holds
    views [i * n / k, (i + 1) * n / k) of ``planes``, ``planes_packed``
    and ``planes_luma_quad`` on the i-th device of the axis, and every
    window fetch of ``ops/ncc.texs_for_views_illums`` then samples each
    view on its shard (``ops/ncc._sample_windows_view_sharded``). The
    home scene keeps its tensors (cameras, level metadata and masks
    stay replicated). Requires n_images % k == 0."""
    devs = mesh.axis_devices(axis)
    n_local = check_view_split(scene.n_images, len(devs), axis)
    shards = tuple(
        ViewShard(i, i * n_local, view_shard_scene(scene, i * n_local, n_local, d))
        for i, d in enumerate(devs))
    return dataclasses.replace(scene, view_mesh=mesh, view_axis=axis,
                               view_shards=shards, view_group=None)
