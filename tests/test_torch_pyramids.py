"""The scene's planes built on its device (``scene_from_arrays``: one
``downsample_once`` step a level over every view and illumination, the
packers' torch forms) against the numpy functions (``build_pyramid``,
``pack_rgb``, ``pack_luma_quad`` and ``downsample_once`` on numpy
input), element for element: 1 and 3 illuminations, an odd size whose
edge taps and clamped x+1 / y+1 both sides hit, every filter of the
step, and the luma of all 2^24 (r, g, b) triples, where a contracted FMA
or another rounding of the float32 sum would differ. ``scene.PYRAMIDS``
counts a load as built on the device and interop's host-built planes as
``host``. The card case (marker ``cuda``) repeats the comparisons at 47
views of 640x480. The file imports no jax; on the card's machine:

    python -m pytest --noconftest -q -p no:cacheprovider tests/test_torch_pyramids.py
"""

import numpy as np
import pytest
import torch

from mvskit_tpu_torch.image import scene as sc
from mvskit_tpu_torch.utils import profiling, synthetic

# one torch thread per test worker, as tests/torch_replay.py sets it
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")
    from mvskit_tpu_torch import get_device

    return get_device("cuda")


def _images(n, n_illums, h, w, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (n_illums, h, w, 3), dtype=np.uint8) for _ in range(n)]


def _host_planes(imgs, max_level):
    """The planes, packed planes and luma quads by the numpy functions,
    one image at a time."""
    n, n_illums, h, w = len(imgs), imgs[0].shape[0], imgs[0].shape[1], imgs[0].shape[2]
    ws, hs = sc.level_dims(w, h, max_level)
    sizes = [a * b for a, b in zip(ws, hs)]
    offsets = [sum(sizes[:l]) for l in range(max_level)]
    planes = np.zeros((n, n_illums, sum(sizes), 3), np.float32)
    for v in range(n):
        for il in range(n_illums):
            for l, lv in enumerate(sc.build_pyramid(imgs[v][il], max_level)):
                planes[v, il, offsets[l] : offsets[l] + sizes[l]] = lv.reshape(-1, 3)
    return planes, sc.pack_rgb(planes), sc.pack_luma_quad(planes, offsets, ws, hs)


def _assert_planes_equal(scene, imgs, max_level):
    planes, packed, quad = _host_planes(imgs, max_level)
    assert scene.planes.dtype == torch.float32
    assert scene.planes_packed.dtype == scene.planes_luma_quad.dtype == torch.int32
    np.testing.assert_array_equal(scene.planes.cpu().numpy(), planes)
    np.testing.assert_array_equal(scene.planes_packed.cpu().numpy(), packed)
    np.testing.assert_array_equal(scene.planes_luma_quad.cpu().numpy(), quad)


def _assert_luma_exhaustive(device, rs_per_chunk=16):
    """Every (r, g, b) triple, chunked by r: the torch luma quads on
    `device` equal numpy's (one level one pixel high, so each quad's low
    byte is that pixel's luma)."""
    gb = np.stack(np.meshgrid(np.arange(256), np.arange(256), indexing="ij"), -1).reshape(-1, 2)
    for r0 in range(0, 256, rs_per_chunk):
        r = np.repeat(np.arange(r0, r0 + rs_per_chunk), gb.shape[0])[:, None]
        rgb = np.concatenate([r, np.tile(gb, (rs_per_chunk, 1))], 1).astype(np.float32)
        planes = rgb[None, None]
        size = [planes.shape[2]]
        want = sc.pack_luma_quad(planes, [0], size, [1])
        got = sc.pack_luma_quad(torch.from_numpy(planes).to(device), [0], size, [1])
        np.testing.assert_array_equal(got.cpu().numpy(), want, err_msg=f"r from {r0}")


@pytest.mark.parametrize("n,n_illums,h,w", [(3, 1, 29, 37), (2, 3, 29, 37), (2, 1, 64, 96)])
def test_device_planes_equal_numpy(n, n_illums, h, w):
    imgs = _images(n, n_illums, h, w, seed=n * 10 + n_illums)
    Ps = synthetic.ring_cameras(n, w, h)
    scene = sc.scene_from_arrays(Ps, imgs, max_level=4, device="cpu")
    _assert_planes_equal(scene, imgs, 4)
    assert scene.n_illums == n_illums
    assert scene.lvl_offsets.tolist() == list(scene.offsets)
    assert scene.lvl_widths.tolist() == list(scene.widths)
    assert scene.lvl_heights.tolist() == list(scene.heights)


@pytest.mark.parametrize("filter", [0, 1, 2])
def test_step_on_every_image_equals_numpy_step(filter):
    """One tensor step over [H, W, n, I, 3] equals the numpy step of each
    [H, W, 3] image, unquantized and after the quantization of every
    level of the pyramid (max_level 4, odd 29 x 37)."""
    imgs = _images(3, 2, 29, 37, seed=filter)
    stack = torch.from_numpy(np.stack(imgs)).permute(2, 3, 0, 1, 4).to(torch.float32)
    got = sc.downsample_once(stack, filter)
    assert isinstance(got, torch.Tensor) and got.shape == (14, 18, 3, 2, 3)
    for v, im in enumerate(imgs):
        for il in range(2):
            want = sc.downsample_once(im[il].astype(np.float32), filter)
            np.testing.assert_array_equal(got[:, :, v, il].numpy(), want)
    level = stack
    for l in range(1, 4):
        level = torch.floor(sc.downsample_once(level, filter) + 0.5).clamp_(0.0, 255.0)
        for v, im in enumerate(imgs):
            for il in range(2):
                want = sc.build_pyramid(im[il], 4, filter=filter)[l]
                np.testing.assert_array_equal(level[:, :, v, il].numpy(), want)


def test_luma_of_every_rgb_triple_equals_numpy():
    _assert_luma_exhaustive("cpu")


def test_load_counts_one_device_pyramid_and_keeps_its_spans(tmp_path):
    prefix = str(tmp_path / "ds")
    synthetic.write_dataset(prefix, n_views=3, width=37, height=29, n_seeds=8, nillums=2)
    profiling.COUNTERS.reset()
    with profiling.tracing() as tr:
        scene = sc.load_scene(prefix, [0, 1, 2], 2, 4, device="cpu")
    assert sc.PYRAMIDS == {"device": 1, "host": 0}
    by_id = {s.id: s for s in tr.spans}
    paths = tr.paths()
    tree = {paths[s.id] for s in tr.spans if s.kind != "sync"}
    assert tree == {"load", "load/decode", "load/pyramid"}
    syncs = {paths[s.id] for s in tr.spans if s.kind == "sync"}
    assert "load/pyramid/scene.copy" in syncs
    assert all(by_id[s.parent].name in ("load", "pyramid") for s in tr.spans
               if s.kind == "sync")
    imgs = [np.stack([sc.decode.load_rgb(f"{prefix}/image/{v:04d}{il:04d}.ppm")
                      for il in range(2)]) for v in range(3)]
    _assert_planes_equal(scene, imgs, 4)


def test_interop_counts_host_planes():
    from mvskit_tpu_torch import interop

    imgs = _images(2, 1, 24, 32)
    planes, packed, _ = _host_planes(imgs, 2)
    Ps = synthetic.ring_cameras(2, 32, 24)
    ws, hs = sc.level_dims(32, 24, 2)
    profiling.COUNTERS.reset()
    scene = interop.scene_from_numpy(planes, packed, None, Ps, (0, ws[0] * hs[0]), ws, hs,
                                     2, device="cpu")
    assert sc.PYRAMIDS == {"device": 0, "host": 1}
    _assert_planes_equal(scene, imgs, 2)


@pytest.mark.cuda
def test_card_planes_equal_numpy(card):
    """47 views of 640 x 480 (temple47's load) built on the card, and the
    luma of every (r, g, b) triple there, against the numpy functions."""
    imgs = _images(47, 1, 480, 640, seed=47)
    Ps = synthetic.ring_cameras(47, 640, 480)
    profiling.COUNTERS.reset()
    scene = sc.scene_from_arrays(Ps, imgs, max_level=4, device=card)
    torch.cuda.synchronize()
    assert sc.PYRAMIDS == {"device": 1, "host": 0}
    assert scene.planes.device.type == "cuda"
    _assert_planes_equal(scene, imgs, 4)
    _assert_luma_exhaustive(card, rs_per_chunk=64)
