"""Meshes, placement and collectives of mvskit_tpu_torch/parallel/shard.py
(mirrors tests/test_shard.py): view-sharded NCC at k = 2 and 4 equals the
unsharded port bit for bit and the JAX package's view-sharded op within
atol 1e-5 (JAX's bound); a propagation round with the gauntlet's chunks
dealt to 8 dp devices equals the unsharded round bit for bit. Also the
mesh's construction and its errors, placement without copies on the
home device, and the explicit collectives. Shards are copies of the CPU,
as the JAX tests' are virtual CPU devices."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvskit_tpu.ops import ncc as jncc
from mvskit_tpu.parallel import shard as jsh
from mvskit_tpu.utils import synthetic as jsyn
from mvskit_tpu_torch.ops import ncc as tncc
from mvskit_tpu_torch.parallel import shard as tsh
from mvskit_tpu_torch.pipeline import propagate as tpr
from torch_replay import jax_scene_to_torch

LEVEL, WSIZE, TAU = 1, 7, 6
A1 = math.radians(60.0)


@pytest.fixture(scope="module")
def sp():
    Ps, _, js = jsyn.plane_scene(n_views=8, width=160, height=120)
    coord, normal = jsyn.plane_points(Ps, 32, extent=0.6)
    views = np.tile(np.arange(8, dtype=np.int32), (32, 1))
    return js, jax_scene_to_torch(js, Ps), coord.astype(np.float32), \
        normal.astype(np.float32), views


def test_make_mesh_devices():
    cpu = torch.device("cpu")
    m = tsh.make_mesh(4, "view", device="cpu")
    assert m.shape == {"view": 4} and m.axis_devices("view") == [cpu] * 4
    m = tsh.make_mesh((2, 2, 2), tsh.MESH_AXES, device="cpu")
    assert m.shape == {"dp": 2, "view": 2, "tile": 2} and m.size == 8
    assert m.axis_devices("tile") == [cpu] * 2
    # an explicit list may repeat a device (k shards on one card)
    m = tsh.make_mesh((1, 3, 1), tsh.MESH_AXES, devices=["cpu"] * 3)
    assert m.axis_devices("view") == [cpu] * 3
    with pytest.raises(ValueError, match="needs 4 devices, got 3"):
        tsh.make_mesh(4, "view", devices=["cpu"] * 3)
    with pytest.raises(ValueError, match="axes"):
        tsh.make_mesh((2, 2), "view", device="cpu")


def test_make_mesh_on_cuda_takes_distinct_cards():
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(ValueError, match=f"needs {have + 1} CUDA devices, have {have}"):
        tsh.make_mesh((1, have + 1, 1), tsh.MESH_AXES, device="cuda")


def test_placement_without_copies(sp):
    _, ts, *_ = sp
    vs = tsh.enable_view_sharding(ts, tsh.make_mesh(4, "view", device="cpu"))
    for i, shard in enumerate(vs.view_shards):
        assert shard.index == i and shard.base == 2 * i
        assert shard.scene.planes_packed.shape[0] == 2
        # a plane slice on the home device is a view, not a copy
        assert shard.scene.planes_packed.data_ptr() == ts.planes_packed[2 * i].data_ptr()
        assert shard.scene.cams.P.data_ptr() == ts.cams.P.data_ptr()
    rep = tsh.replicate(ts, "cpu")
    assert rep.planes.data_ptr() == ts.planes.data_ptr()
    with pytest.raises(ValueError, match="not divisible"):
        tsh.enable_view_sharding(ts, tsh.make_mesh(3, "view", device="cpu"))


def test_shard_rows_and_collectives():
    from mvskit_tpu_torch.core import patches as tpt

    mesh = tsh.make_mesh(3, "dp", device="cpu")
    x = torch.arange(20).reshape(10, 2)
    blocks = tsh.shard_rows(x, mesh)
    assert [b.shape[0] for b in blocks] == [4, 4, 2]
    assert torch.equal(tsh.all_gather_rows(blocks, "cpu"), x)
    table = tpt.empty_table(10, 4, "cpu")
    parts = tsh.shard_rows(table, mesh)
    assert all(isinstance(p, tpt.PatchTable) for p in parts)
    assert torch.equal(torch.cat([p.coord for p in parts]), table.coord)
    assert torch.equal(tsh.psum([torch.ones(3), 2 * torch.ones(3)], "cpu"),
                       3 * torch.ones(3))
    rows = [torch.full((2, 3, 4), i) for i in range(3)]
    prev, nxt = tsh.ppermute_rows(rows, fill=-1)
    assert [int(p.flatten()[0]) for p in prev] == [-1, 0, 1]
    assert [int(p.flatten()[0]) for p in nxt] == [1, 2, -1]
    assert prev[1].shape == (2, 1, 4)


@pytest.mark.parametrize("k", [2, 4])
def test_view_sharded_ncc_matches_reference_op(sp, k):
    js, ts, coord, normal, views = sp
    args = (torch.as_tensor(views[:, :TAU]), torch.as_tensor(coord),
            torch.as_tensor(normal), LEVEL, WSIZE, TAU, A1)
    want = tncc.compute_patch_ncc(ts, *args)
    got = tncc.compute_patch_ncc(
        tsh.enable_view_sharding(ts, tsh.make_mesh(k, "view", device="cpu")), *args)
    assert torch.equal(got, want)
    score = jax.jit(jncc.compute_patch_ncc, static_argnums=(4, 5, 6, 7))
    jgot = score(jsh.enable_view_sharding(js, jsh.make_mesh(k, axis="view")),
                 jnp.asarray(views[:, :TAU]), jnp.asarray(coord), jnp.asarray(normal),
                 LEVEL, WSIZE, TAU, A1)
    np.testing.assert_allclose(got.numpy(), np.asarray(jgot), atol=1e-5)


def test_dp_sharded_propagation(sp):
    from test_torch_view_shard import _seeded_table

    _, ts, coord, normal, views = sp
    table = _seeded_table(ts, coord, normal, views)
    p = tpr.PropagateParams(
        level=1, csize=2, wsize=7, tau=6, min_image_num=3, cell_capacity=8,
        angle_threshold0=A1, angle_threshold1=A1,
        max_angle_threshold=math.radians(10.0), ascale=math.pi / 48.0,
        refine_rounds=2, refine_cands=2, refine_shrink=0.8,
        refine_depth_radius=4.0, refine_angle_radius=8.0,
        neighbor_threshold=0.5, donor_budget=64, chunk=16)

    def run(dp):
        gen = torch.Generator()
        gen.manual_seed(0)
        mesh = tsh.make_mesh(dp, "dp", device="cpu")
        return tpr.propagate_round(ts, table, None, p, 1, 0.7, 0.4, generator=gen,
                                   dp_devices=mesh.axis_devices("dp"))

    want, wstats = run(1)
    got, gstats = run(8)
    assert gstats == wstats and wstats.passed > 16  # more than one chunk's work
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert got.n_alive() >= table.n_alive()
