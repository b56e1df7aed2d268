"""Multi-process execution over ``torch.distributed`` (port of
``mvskit_tpu/parallel/multihost.py``).

The reference is one process on one workstation (SURVEY.md §2). Within a
process, ``shard.py`` and ``tiles.py`` drive a mesh from one controller;
across processes the mesh spans every rank's devices and the collectives
go through ``torch.distributed``. Each process holds only its own
shards: a view-sharded window fetch compacts and samples this process's
windows (``ops/ncc._sample_windows_view_sharded``), leaves exact zeros
in the home output outside them, and one ``all_reduce`` sum over the
group completes it.

Entry points:
  * init_distributed(backend, init_method, world_size, rank) — join the
    process group. The backend is the caller's: ``gloo`` on the CPU,
    ``nccl`` where every rank has a GPU of its own. Nothing picks one.
  * global_view_mesh(local_devices) — a 1-D mesh over every rank's
    devices (this process's own, ``None`` for the others').
  * enable_view_sharding_global(scene, mesh) — the multi-process
    ``shard.enable_view_sharding``.
  * shard_table_global(table, mesh) — this process's row blocks.
  * to_host_replicated(x) — a replicated result as numpy.
  * sum_grads(group, *xs) — `xs` unchanged, their gradients summed over
    the group in the backward (a replicated input whose uses are split
    over the ranks: the view-sharded sampler's lattice).

Two ranks may share one card (NCCL refuses that); then gloo carries
their collectives, and ``all_reduce_sum`` stages a CUDA tensor through
pinned host memory for it, by design.
"""

from __future__ import annotations

import dataclasses
import datetime
from typing import List, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..core.patches import PatchTable
from ..image.scene import Scene, ViewShard
from .shard import Mesh, check_view_split, view_shard_scene


def init_distributed(backend: str, init_method: str, world_size: int, rank: int,
                     timeout_s: float = 120.0) -> None:
    """Join the process group: `backend` ("gloo" or "nccl"),
    `init_method` (e.g. ``tcp://localhost:<port>``), the world size and
    this process's rank, all explicit (JAX multihost.py:45-69 takes the
    coordinator the same way off a pod)."""
    dist.init_process_group(backend=backend, init_method=init_method,
                            world_size=world_size, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))


def global_view_mesh(local_devices: Sequence, axis: str = "view", group=None) -> Mesh:
    """A 1-D mesh over every rank's devices, ``len(local_devices)`` per
    rank in rank order (JAX multihost.py:72). This process addresses its
    own; the entries of other ranks are None."""
    world, rank = dist.get_world_size(group), dist.get_rank(group)
    per = len(local_devices)
    arr = np.empty(world * per, dtype=object)
    arr[rank * per:(rank + 1) * per] = [torch.device(d) for d in local_devices]
    return Mesh(arr, (axis,))


def enable_view_sharding_global(scene: Scene, mesh: Mesh, axis: str = "view",
                                group=None) -> Scene:
    """The multi-process ``shard.enable_view_sharding`` (JAX
    multihost.py:100): this process keeps the plane slices of its own
    shards, each a copy on its device, and no other planes (the home
    scene's plane tensors are left with 0 views, so a read of another
    rank's view fails loudly); cameras, level metadata and masks stay
    replicated. Window fetches then all-reduce over `group` (default:
    the world). Requires n_images % mesh.shape[axis] == 0."""
    devs = mesh.axis_devices(axis)
    n_local = check_view_split(scene.n_images, len(devs), axis)
    shards = []
    for i, d in enumerate(devs):
        if d is None:
            continue
        sub = view_shard_scene(scene, i * n_local, n_local, d)
        sub = dataclasses.replace(sub, **{f: getattr(sub, f).clone() for f in (
            "planes", "planes_packed", "planes_luma_quad")})
        shards.append(ViewShard(i, i * n_local, sub))
    empty = lambda t: t.new_empty((0,) + tuple(t.shape[1:]))  # noqa: E731
    return dataclasses.replace(
        scene, planes=empty(scene.planes), planes_packed=empty(scene.planes_packed),
        planes_luma_quad=empty(scene.planes_luma_quad), view_mesh=mesh,
        view_axis=axis, view_shards=tuple(shards),
        view_group=dist.group.WORLD if group is None else group)


def shard_table_global(table: PatchTable, mesh: Mesh, axis: str = "dp") -> List[PatchTable]:
    """This process's row blocks of the table over the mesh's `axis`
    (JAX multihost.py:135): ceil(rows / k) rows per shard, each block on
    its (local) device, in mesh order."""
    devs = mesh.axis_devices(axis)
    per = -(-table.capacity // len(devs))
    return [PatchTable(*(f[i * per:(i + 1) * per].to(d) for f in table))
            for i, d in enumerate(devs) if d is not None]


def to_host_replicated(x: torch.Tensor) -> np.ndarray:
    """A replicated result (every rank holds all of it) as local numpy
    (JAX multihost.py:148)."""
    return x.detach().cpu().numpy()


def all_reduce_sum(t: torch.Tensor, group=None) -> None:
    """In-place sum of `t` over the group's ranks. A CUDA tensor under
    gloo goes through pinned host memory (gloo's own CUDA support is not
    relied on); NCCL reduces it on the card. Where one rank holds each
    entry and the others exact zeros, the sum is that rank's value (a
    -0.0 comes back as +0.0)."""
    if t.is_cuda and dist.get_backend(group) == "gloo":
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t)
        dist.all_reduce(host, op=dist.ReduceOp.SUM, group=group)
        t.copy_(host)
    else:
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)


class _SumGrads(torch.autograd.Function):
    """Identity forward; the backward sums each cotangent over the
    group's ranks (one all_reduce for all of them)."""

    @staticmethod
    def forward(ctx, group, *xs):
        ctx.group = group
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        flat = torch.cat([g.reshape(-1) for g in grads])
        all_reduce_sum(flat, ctx.group)
        parts = flat.split([g.numel() for g in grads])
        return (None, *(p.view_as(g) for p, g in zip(parts, grads)))


def sum_grads(group, *xs):
    """`xs` as they are, with their gradients summed over the group in
    the backward. Every rank holds the same `xs` and computes the same
    loss, but each rank's graph reaches only its own share of their uses
    (the windows of its views): the gradient of a replicated input is
    the sum of the ranks' shares (the transpose of a replication, as
    JAX's shard_map takes it). Returns a tuple of views of `xs`."""
    return _SumGrads.apply(group, *xs)
