"""The plain reference against windows and scores worked out by hand.

Three identical cameras (f = 100 px, principal point (16, 16), 10 units
above z = 0, looking down) see a 32 x 32 image whose channels are linear
ramps, so bilinear samples are the ramps themselves. A patch at the
origin facing the cameras has a 1-pixel lattice in every view: its 7 x 7
window at level 0 starts at (13, 19) and steps (1, 0) along i and
(0, -1) along j. View 2's image is the first one inverted (255 - v), so
its normalised window is the reference's negated: robust INCC 2 / 7.
"""

import math
import os

import numpy as np
import pytest
import torch

from mvsbench.reference import ncc as R

F, C0, D = 100.0, 16.0, 10.0


def _ramp():
    y, x = np.mgrid[0:32, 0:32].astype(np.float64)
    return np.stack([10 + x + 2 * y, 100 - x, 50 + 3 * y], -1)


@pytest.fixture()
def dataset(tmp_path):
    P = np.array([[F, 0, C0, 0], [0, F, C0, 0], [0, 0, 1, 0]]) @ np.array(
        [[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, D], [0, 0, 0, 1]], dtype=np.float64)
    os.makedirs(tmp_path / "txt")
    os.makedirs(tmp_path / "image")
    img = _ramp().astype(np.uint8)
    for v, im in enumerate((img, img, 255 - img)):
        flat = P.reshape(-1)
        (tmp_path / "txt" / f"{v:08d}.txt").write_text(
            "CONTOUR\n" + " ".join(repr(float(v)) for v in flat[:6]) + "\n" + " ".join(repr(float(v)) for v in flat[6:]) + "\n")
        (tmp_path / "image" / f"{v:04d}0000.ppm").write_bytes(b"P6\n32 32\n255\n" + im.tobytes())
    cams = R.load_cameras(str(tmp_path), 3)
    planes = R.load_planes(str(tmp_path), 3, 1, 3)
    return cams, planes


PATCH = torch.tensor([[0.0, 0.0, 0.0, 1.0]], dtype=torch.float64)
NORMAL = torch.tensor([[0.0, 0.0, -1.0, 0.0]], dtype=torch.float64)


def test_window_by_hand(dataset):
    cams, planes = dataset
    views = torch.tensor([[0, 1, 2]])
    tex, valid = R.windows(cams, planes, views, PATCH, NORMAL, 0, 7, 60.0, 0)
    assert valid.all()
    i = np.tile(np.arange(7), 7)
    j = np.repeat(np.arange(7), 7)
    x, y = 13 + i, 19 - j
    want = np.stack([10 + x + 2 * y, 100 - x, 50 + 3 * y])
    np.testing.assert_allclose(tex[0, 0].numpy(), want, atol=1e-9)
    np.testing.assert_allclose(tex[2, 0].numpy(), 255 - want, atol=1e-9)


@pytest.mark.parametrize("images,want", [
    ([0, 1, -1], 1.0),                        # the same window: INCC 0
    ([0, 2, -1], -1.0),                       # inverted: 1 - (2/7) / (1 - 6/7)
    ([0, 1, 2], 0.75),                        # mean 1/7: 1 - (1/7) / (1 - 3/7)
    ([0, -1, -1], 1.4),                       # one view: score 2
])
def test_score_by_hand(dataset, images, want):
    cams, planes = dataset
    got = R.patch_ncc(cams, planes, PATCH, NORMAL, torch.tensor([images]), level=0,
                      wsize=7, tau=3)
    assert math.isclose(float(got[0]), want, abs_tol=1e-9)


def test_pyramid_step_by_hand():
    """A constant 64 over 4 x 4: each output's taps lose one row and one
    column of weight 1 outside the image, (7 / 8)^2 x 64 = 49."""
    out = R.downsample(torch.full((4, 4, 3), 64.0, dtype=torch.float64))
    assert out.shape == (2, 2, 3) and bool((out == 49.0).all())


def test_bfloat16_moves_the_pyramid(dataset):
    cams, planes = dataset
    img = torch.as_tensor(np.random.default_rng(0).integers(0, 256, (64, 64, 3)))
    f64 = R.downsample(img.to(torch.float64))
    bf = R.downsample(img.to(torch.bfloat16))
    assert float((f64 - bf.double()).abs().max()) >= 1.0
