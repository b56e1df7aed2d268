"""The port's own copies of the JAX package's jax-free modules (config,
PLY and .patch I/O, image decoding, metrics) against the originals:
the same option files parse to the same config, the same malformed
files raise the same errors, and the writers write the same bytes."""

import dataclasses
import os

import numpy as np
import pytest

from mvskit_tpu import config as jconfig
from mvskit_tpu.image import decode as jdecode
from mvskit_tpu.io import patch_io as jpatch
from mvskit_tpu.io import ply as jply
from mvskit_tpu.utils import metrics as jmetrics
from mvskit_tpu.utils import synthetic as jsyn
from mvskit_tpu_torch import config as tconfig
from mvskit_tpu_torch.image import decode as tdecode
from mvskit_tpu_torch.io import patch_io as tpatch
from mvskit_tpu_torch.io import ply as tply
from mvskit_tpu_torch.utils import metrics as tmetrics


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    root = tmp_path_factory.mktemp("cfgio")
    out = {}
    for name, kw in (("plain", {}), ("illum3", dict(nillums=3)),
                     ("sphere", dict(geometry="sphere", n_views=4))):
        prefix = str(root / name)
        jsyn.write_dataset(prefix, width=64, height=48, n_seeds=16, **kw)
        out[name] = prefix
    return out


@pytest.mark.parametrize("name", ["plain", "illum3", "sphere"])
def test_option_file_parses_identically(datasets, name):
    j = jconfig.MVSConfig.from_option_file(datasets[name])
    t = tconfig.MVSConfig.from_option_file(datasets[name])
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.summary() == j.summary()
    assert (t.tau, t.ascale, t.angle_threshold1) == (j.tau, j.ascale, j.angle_threshold1)
    if name == "illum3":
        assert t.nillums == 3


@pytest.mark.parametrize("text,match", [
    ("level 1\nbogus 3\nimages -1 0 4\n", "Unrecognizable option"),
    ("level 1\ncsize 2\n", "images"),
])
def test_option_file_errors_match(tmp_path, text, match):
    with open(tmp_path / "option", "w") as f:
        f.write(text)
    errs = []
    for mod in (jconfig, tconfig):
        with pytest.raises(ValueError, match=match) as ei:
            mod.MVSConfig.from_option_file(str(tmp_path))
        errs.append(str(ei.value))
    assert errs[0] == errs[1]


@pytest.fixture(scope="module")
def cloud():
    rng = np.random.default_rng(0)
    n = 257
    return (rng.normal(size=(n, 3)).astype(np.float32),
            rng.normal(size=(n, 3)).astype(np.float32),
            rng.integers(0, 256, (n, 3)).astype(np.uint8))


@pytest.mark.parametrize("binary", [False, True])
@pytest.mark.parametrize("fields", ["xyz", "normal", "rgb"])
def test_write_ply_bytes_identical(tmp_path, cloud, binary, fields):
    xyz, nrm, rgb = cloud
    kw = dict(normal=nrm if fields != "xyz" else None,
              rgb=rgb if fields == "rgb" else None, binary=binary)
    jply.write_ply(str(tmp_path / "j.ply"), xyz, **kw)
    tply.write_ply(str(tmp_path / "t.ply"), xyz, **kw)
    a = (tmp_path / "j.ply").read_bytes()
    assert a == (tmp_path / "t.ply").read_bytes()
    got, want = tply.read_ply(str(tmp_path / "t.ply")), jply.read_ply(str(tmp_path / "j.ply"))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_write_ply_mesh_extensions_identical(tmp_path, cloud):
    xyz = cloud[0][:6]
    kw = dict(faces=[[0, 1, 2], [3, 4, 5]], range_grid=np.array([[0, -1], [2, 3]]),
              obj_info={"scanner": "synthetic"})
    jply.write_ply(str(tmp_path / "j.ply"), xyz, **kw)
    tply.write_ply(str(tmp_path / "t.ply"), xyz, **kw)
    assert (tmp_path / "j.ply").read_bytes() == (tmp_path / "t.ply").read_bytes()
    got = tply.read_ply(str(tmp_path / "t.ply"))
    np.testing.assert_array_equal(got["range_grid"], [[0, -1], [2, 3]])


def test_write_patch_file_bytes_identical(tmp_path):
    rng = np.random.default_rng(1)
    n = 40
    coord = np.concatenate([rng.normal(size=(n, 3)), np.ones((n, 1))], 1).astype(np.float32)
    normal = np.concatenate([rng.normal(size=(n, 3)), np.zeros((n, 1))], 1).astype(np.float32)
    ncc, ds, asc = (rng.uniform(size=n).astype(np.float32) for _ in range(3))
    images = [list(rng.choice(8, rng.integers(1, 5), replace=False)) for _ in range(n)]
    vimages = [list(rng.choice(8, rng.integers(0, 3), replace=False)) for _ in range(n)]
    for mod, name in ((jpatch, "j"), (tpatch, "t")):
        mod.write_patch_file(str(tmp_path / f"{name}.patch"), coord, normal, ncc, ds,
                             asc, images, vimages)
    assert (tmp_path / "j.patch").read_bytes() == (tmp_path / "t.patch").read_bytes()
    got = tpatch.read_patch_file(str(tmp_path / "t.patch"))
    want = jpatch.read_patch_file(str(tmp_path / "j.patch"))
    for k in ("coord", "normal", "ncc", "dscale", "ascale"):
        np.testing.assert_array_equal(got[k], want[k])
    assert got["images"] == want["images"] and got["vimages"] == want["vimages"]
    np.testing.assert_array_equal(tpatch.lists_to_padded(got["images"], 8),
                                  jpatch.lists_to_padded(want["images"], 8))


def test_decode_and_metrics_match(datasets):
    prefix = datasets["illum3"]
    img = os.path.join(prefix, "image", "00010002.ppm")
    np.testing.assert_array_equal(tdecode.load_rgb(img), jdecode.load_rgb(img))
    assert tdecode.load_mask(os.path.join(prefix, "mask", "00000000")) is None
    cloud = tply.read_ply(os.path.join(prefix, "ply", "00000000.ply"))["xyz"]
    g = np.linspace(-0.8, 0.8, 40)
    xs, ys = np.meshgrid(g, g)
    gt = np.stack([xs.ravel(), ys.ravel(), np.zeros(xs.size)], axis=1)
    assert (tmetrics.accuracy_completeness(cloud, gt, threshold=0.05)
            == jmetrics.accuracy_completeness(cloud, gt, threshold=0.05))
    assert tmetrics.plane_rms(cloud) == jmetrics.plane_rms(cloud)
