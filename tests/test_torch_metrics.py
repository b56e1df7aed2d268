"""Port scene statistic ``image/scene.pairwise_view_distances`` against
mvskit_tpu's (PhotoSet::setDistances), on the plane and sphere scenes'
cameras: within 1e-6 (both read float32 centres and axes)."""

import numpy as np
import pytest

from mvskit_tpu.image import scene as jscene
from mvskit_tpu.utils import synthetic as jsyn
from mvskit_tpu_torch.image import scene as tscene
from mvskit_tpu_torch.utils import synthetic as tsyn


def _pair(Ps, h=48, w=64):
    imgs = [np.zeros((h, w, 3), np.uint8)] * len(Ps)
    return (jscene.scene_from_arrays(Ps, imgs, max_level=2),
            tscene.scene_from_arrays(Ps, imgs, max_level=2, device="cpu"))


def test_plane_scene_distances_match():
    """tests/test_metrics.py's plane case on the port, and against JAX."""
    _, _, j = jsyn.plane_scene(n_views=4, width=64, height=48)
    _, _, t = tsyn.plane_scene(n_views=4, width=64, height=48, device="cpu")
    d = tscene.pairwise_view_distances(t)
    assert d.shape == (4, 4)
    assert np.allclose(np.diag(d), np.maximum(0, 1 - 1 - np.cos(np.deg2rad(10))))
    assert d[0, 3] > d[0, 1] * 0.5
    np.testing.assert_allclose(d, jscene.pairwise_view_distances(j), rtol=0, atol=1e-6)


@pytest.mark.parametrize("cams", ["sphere", "ring"])
def test_camera_ring_distances_match(cams):
    Ps = (jsyn.sphere_cameras(8, 64, 48) if cams == "sphere"
          else jsyn.ring_cameras(6, 64, 48))
    j, t = _pair(Ps)
    d = tscene.pairwise_view_distances(t)
    np.testing.assert_allclose(d, jscene.pairwise_view_distances(j), rtol=0, atol=1e-6)
    np.testing.assert_allclose(d, d.T, atol=1e-6)


def test_one_view_and_identical_centres():
    """One view: the raw 1x1 distance. Identical centres: ValueError, as
    in JAX."""
    Ps = jsyn.ring_cameras(3, 64, 48)
    j, t = _pair(Ps[:1])
    np.testing.assert_array_equal(tscene.pairwise_view_distances(t),
                                  jscene.pairwise_view_distances(j))
    j, t = _pair(np.stack([Ps[0], Ps[0]]))
    with pytest.raises(ValueError):
        jscene.pairwise_view_distances(j)
    with pytest.raises(ValueError):
        tscene.pairwise_view_distances(t)
