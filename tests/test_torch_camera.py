"""Port camera model vs mvskit_tpu.geometry.camera on the same inputs.

Tolerance: 1e-5 relative (float32 products summed in another order;
pixel coordinates are O(100), so also an absolute floor of 1e-4)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvskit_tpu.geometry import camera as jcam
from mvskit_tpu.utils import synthetic as jsyn
from mvskit_tpu_torch.geometry import camera as tcam

RTOL, ATOL = 1e-5, 1e-4


@pytest.fixture(scope="module")
def cams():
    Ps = jsyn.ring_cameras(6, 160, 120)
    return Ps, jcam.make_camera_set(Ps), tcam.make_camera_set(Ps, "cpu")


def _pts(n, seed, behind=False):
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(-1.0, 1.0, (n, 3))
    if behind:
        xyz[: n // 4] *= 40.0  # far points, some behind cameras
    return np.concatenate([xyz, np.ones((n, 1))], 1).astype(np.float32)


def test_camera_set_fields_match(cams):
    _, j, t = cams
    for name in j._fields:
        a, b = np.asarray(getattr(j, name)), getattr(t, name).numpy()
        assert b.dtype == np.float32, name
        np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("level", [0, 1, 2])
def test_project_matches(cams, level):
    _, j, t = cams
    c = _pts(64, level, behind=True)
    idx = np.arange(64) % 6
    jxy, jz, jv = jcam.project(j, jnp.asarray(idx), jnp.asarray(c), level)
    txy, tz, tv = tcam.project(t, torch.as_tensor(idx), torch.as_tensor(c), level)
    np.testing.assert_array_equal(np.asarray(jv), tv.numpy())
    np.testing.assert_allclose(txy.numpy(), np.asarray(jxy), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tz.numpy(), np.asarray(jz), rtol=RTOL, atol=ATOL)
    assert (txy.numpy()[~tv.numpy()] == tcam.BEHIND).all()


def test_project_xy_lists_matches_with_behind(cams):
    _, j, t = cams
    c = _pts(48, 7, behind=True)
    lists = np.random.default_rng(1).integers(0, 6, (48, 5)).astype(np.int32)
    jx, jy, jv = jcam.project_xy_lists(j, jnp.asarray(lists), jnp.asarray(c), 1)
    tx, ty, tv = tcam.project_xy_lists(t, torch.as_tensor(lists), torch.as_tensor(c), 1)
    np.testing.assert_array_equal(np.asarray(jv), tv.numpy())
    assert (~tv.numpy()).any(), "fixture must exercise the BEHIND sentinel"
    assert (tx.numpy()[~tv.numpy()] == tcam.BEHIND).all()
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=RTOL, atol=ATOL)


def test_unproject_inverts_and_matches(cams):
    _, j, t = cams
    c = _pts(32, 3)
    idx = np.arange(32) % 6
    xy, z, _ = tcam.project(t, torch.as_tensor(idx), torch.as_tensor(c), 1)
    back = tcam.unproject(t, torch.as_tensor(idx), xy, z, 1)
    np.testing.assert_allclose(back.numpy(), c, atol=1e-4)
    jback = jcam.unproject(j, jnp.asarray(idx), jnp.asarray(xy.numpy()),
                           jnp.asarray(z.numpy()), 1)
    np.testing.assert_allclose(back.numpy(), np.asarray(jback), rtol=RTOL, atol=ATOL)


def test_paxes_unit_depth_scale_match(cams):
    _, j, t = cams
    c = _pts(40, 5)
    rng = np.random.default_rng(2)
    n3 = rng.normal(size=(40, 3)) + np.array([0.0, 0.0, 3.0])
    n3 /= np.linalg.norm(n3, axis=1, keepdims=True)
    nrm = np.concatenate([n3, np.zeros((40, 1))], 1).astype(np.float32)
    idx = np.arange(40) % 6
    ji, ti = jnp.asarray(idx), torch.as_tensor(idx)
    jc, tc = jnp.asarray(c), torch.as_tensor(c)
    jpx, jpy = jcam.get_paxes(j, ji, jc, jnp.asarray(nrm), 1)
    tpx, tpy = tcam.get_paxes(t, ti, tc, torch.as_tensor(nrm), 1)
    np.testing.assert_allclose(tpx.numpy(), np.asarray(jpx), rtol=RTOL, atol=1e-6)
    np.testing.assert_allclose(tpy.numpy(), np.asarray(jpy), rtol=RTOL, atol=1e-6)
    for jf, tf in ((jcam.get_unit, tcam.get_unit), (jcam.get_scale_cam, tcam.get_scale_cam)):
        np.testing.assert_allclose(tf(t, ti, tc, 2).numpy(),
                                   np.asarray(jf(j, ji, jc, 2)), rtol=RTOL)
    np.testing.assert_allclose(tcam.compute_depth(t, ti, tc).numpy(),
                               np.asarray(jcam.compute_depth(j, ji, jc)), rtol=RTOL)


def test_camera_file_parsing_matches(tmp_path):
    p = tmp_path / "cam.txt"
    p.write_text("CONTOUR2\n600 610 0.5 80 60 0\n10 -20 30 0.1 0.2 5\n")
    ji, je, jt = jcam.parse_camera_file(str(p))
    ti, te, tt = tcam.parse_camera_file(str(p))
    assert jt == tt == 2
    np.testing.assert_array_equal(
        jcam.projection_from_params(ji, je, jt), tcam.projection_from_params(ti, te, tt)
    )


@pytest.mark.parametrize("q", [
    [12.0, -35.0, 130.0, 0.4, -1.2, 3.3],
    [-170.0, 89.0, -5.0, 0.0, 2.0, -1.0],
    [30.0, 90.0, 0.0, 1.0, 1.0, 1.0],     # proj[2, 0] == -1
    [30.0, -90.0, 0.0, 1.0, 1.0, 1.0],    # proj[2, 0] == +1
])
def test_proj2quat_roundtrip_and_matches(q):
    """The JAX round trip (tests/test_camera.py) on the port, and the port
    against JAX to 1e-12 on float64, gimbal-lock branches included."""
    proj = tcam.quat2proj(q)
    got = tcam.proj2quat(proj)
    if abs(q[1]) != 90.0:
        np.testing.assert_allclose(got, q, atol=1e-5)
    np.testing.assert_allclose(got, jcam.proj2quat(proj), rtol=0, atol=1e-12)
    rng = np.random.default_rng(int(abs(q[0])))
    for _ in range(8):
        r = np.concatenate([rng.uniform(-179, 179, 1), rng.uniform(-89, 89, 1),
                            rng.uniform(-179, 179, 1), rng.normal(size=3)])
        P = tcam.quat2proj(r)
        np.testing.assert_allclose(tcam.proj2quat(P), jcam.proj2quat(P), rtol=0, atol=1e-12)
        np.testing.assert_allclose(tcam.proj2quat(P), r, atol=1e-9)


@pytest.mark.parametrize("txt_type", [0, 1, 2])
def test_write_camera_file_matches(tmp_path, txt_type):
    """The same bytes as the JAX writer for CONTOUR and CONTOUR2, read
    back by parse_camera_file; ValueError for any other type."""
    rng = np.random.default_rng(txt_type)
    intr = rng.normal(size=6) * 100.0
    extr = rng.normal(size=6)
    jp, tp = str(tmp_path / "j.txt"), str(tmp_path / "t.txt")
    if txt_type not in (0, 2):
        with pytest.raises(ValueError):
            jcam.write_camera_file(jp, intr, extr, txt_type)
        with pytest.raises(ValueError):
            tcam.write_camera_file(tp, intr, extr, txt_type)
        return
    jcam.write_camera_file(jp, intr, extr, txt_type)
    tcam.write_camera_file(tp, intr, extr, txt_type)
    with open(jp, "rb") as a, open(tp, "rb") as b:
        assert a.read() == b.read()
    i2, e2, t2 = tcam.parse_camera_file(tp)
    assert t2 == txt_type
    np.testing.assert_array_equal(i2, intr)
    np.testing.assert_array_equal(e2, extr)
