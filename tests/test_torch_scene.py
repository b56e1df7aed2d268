"""Port scene construction vs mvskit_tpu.image.scene, bit for bit, and the
port's jax-free dataset writer vs the JAX package's, byte for byte."""

import os

import numpy as np
import pytest

from mvskit_tpu.config import MVSConfig
from mvskit_tpu.image import scene as jscene
from mvskit_tpu.pipeline import seed as jseed
from mvskit_tpu.utils import synthetic as jsyn
from mvskit_tpu_torch.image import scene as tscene
from mvskit_tpu_torch.pipeline import seed as tseed
from mvskit_tpu_torch.utils import synthetic as tsyn


def _assert_scene_equal(j, t):
    np.testing.assert_array_equal(np.asarray(j.planes), t.planes.numpy())
    np.testing.assert_array_equal(np.asarray(j.planes_packed), t.planes_packed.numpy())
    np.testing.assert_array_equal(np.asarray(j.planes_luma_quad),
                                  t.planes_luma_quad.numpy())
    assert t.planes_packed.dtype.is_floating_point is False
    assert (j.offsets, j.widths, j.heights, j.max_level) == (
        t.offsets, t.widths, t.heights, t.max_level)
    for a, b in ((j.lvl_offsets, t.lvl_offsets), (j.lvl_widths, t.lvl_widths),
                 (j.lvl_heights, t.lvl_heights)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    if j.masks is None:
        assert t.masks is None
    else:
        np.testing.assert_array_equal(np.asarray(j.masks), t.masks.numpy())
    for name in j.cams._fields:
        np.testing.assert_array_equal(np.asarray(getattr(j.cams, name)),
                                      getattr(t.cams, name).numpy())


def test_pyramid_and_packed_planes_bit_exact():
    rng = np.random.default_rng(0)
    Ps = jsyn.ring_cameras(3, 96, 64)
    imgs = [rng.integers(0, 256, (2, 64, 96, 3), dtype=np.uint8) for _ in range(3)]
    masks = [None, (rng.random((64, 96)) > 0.3).astype(np.uint8) * 255, None]
    j = jscene.scene_from_arrays(Ps, imgs, masks=masks, max_level=4)
    t = tscene.scene_from_arrays(Ps, imgs, masks=masks, max_level=4, device="cpu")
    _assert_scene_equal(j, t)
    assert t.n_illums == 2 and t.has_mask


def test_plane_scene_matches():
    _, _, j = jsyn.plane_scene(n_views=4, width=80, height=60)
    _, _, t = tsyn.plane_scene(n_views=4, width=80, height=60, device="cpu")
    _assert_scene_equal(j, t)


def test_rq_decompose_matches():
    Ps = jsyn.ring_cameras(5, 160, 120)
    for P in Ps:
        for a, b in zip(jseed.rq_decompose(P[:, :3]), tseed.rq_decompose(P[:, :3])):
            np.testing.assert_array_equal(a, b)


def _tree_bytes(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


@pytest.mark.parametrize("kw", [
    dict(n_views=4, width=96, height=72, n_seeds=32),
    dict(n_views=3, width=64, height=48, n_seeds=16, geometry="sphere", nillums=2),
])
def test_write_dataset_byte_identical(tmp_path, kw):
    jsyn.write_dataset(str(tmp_path / "jax"), **kw)
    tsyn.write_dataset(str(tmp_path / "torch"), **kw)
    a, b = _tree_bytes(tmp_path / "jax"), _tree_bytes(tmp_path / "torch")
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k] == b[k], k


def test_load_scene_from_written_dataset(tmp_path):
    prefix = str(tmp_path / "ds")
    tsyn.write_dataset(prefix, n_views=4, width=96, height=72, n_seeds=16)
    cfg = MVSConfig.from_option_file(prefix)
    j = jscene.load_scene(prefix, cfg.images, cfg.nillums, cfg.max_level)
    t = tscene.load_scene(prefix, cfg.images, cfg.nillums, cfg.max_level, device="cpu")
    _assert_scene_equal(j, t)
