"""mvskit_tpu_torch.interop's device rule: like every entry point of the
port, scene_from_numpy and table_from_numpy default to "cuda", resolved
through device.get_device, so without a card they raise; a caller that
wants the CPU says so. The file imports no jax."""

import numpy as np
import pytest
import torch

from mvskit_tpu_torch import interop
from mvskit_tpu_torch.utils import synthetic


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.fixture(scope="module")
def scene_arrays():
    Ps, _, sc = synthetic.plane_scene(n_views=2, width=32, height=24, max_level=2,
                                      device="cpu")
    return (sc.planes.numpy(), sc.planes_packed.numpy(), None, Ps, sc.offsets,
            sc.widths, sc.heights, sc.max_level), sc


def _fields(n=5):
    rng = np.random.default_rng(0)
    return {"coord": rng.normal(size=(n, 4)), "normal": rng.normal(size=(n, 4)),
            "ncc": rng.uniform(size=n), "dscale": rng.uniform(size=n),
            "ascale": rng.uniform(size=n), "images": np.zeros((n, 4), np.int64),
            "vimages": np.full((n, 4), -1), "alive": rng.uniform(size=n) > 0.5}


def test_defaults_to_cuda_and_raises_without_a_card(no_card, scene_arrays):
    args, _ = scene_arrays
    with pytest.raises(RuntimeError, match="cuda"):
        interop.scene_from_numpy(*args)
    with pytest.raises(RuntimeError, match="cuda"):
        interop.table_from_numpy(_fields())


def test_cpu_when_asked(no_card, scene_arrays):
    args, want = scene_arrays
    torch.backends.cuda.matmul.allow_tf32 = True
    sc = interop.scene_from_numpy(*args, device="cpu")
    assert not torch.backends.cuda.matmul.allow_tf32  # pinned by get_device
    assert sc.planes_packed.device.type == "cpu" and sc.cams.center.device.type == "cpu"
    assert torch.equal(sc.planes_packed, want.planes_packed)
    assert torch.equal(sc.planes_luma_quad, want.planes_luma_quad)
    fields = _fields()
    table = interop.table_from_numpy(fields, device="cpu")
    assert table.coord.device.type == "cpu"
    assert table.images.dtype == torch.int32 and table.alive.dtype == torch.bool
    back = interop.table_to_numpy(table)
    for k in interop.TABLE_FIELDS:
        np.testing.assert_array_equal(back[k], np.asarray(fields[k], back[k].dtype))
