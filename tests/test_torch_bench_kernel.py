"""The kernel benchmark path (mvskit_tpu_torch.tools.bench_kernel) and
the ablation switches of the NCC window sampler (K5), against the JAX
package on the CPU.

Each switch's plain version is held to its definition built from the
JAX package's values: its window geometry (window_geometry_views), its
planes (planes_packed, planes_luma_quad) and its gather path
(sample_color_ch_packed, sample_luma_quad), with the lattice evaluated
in numpy float32 in the port's order. Tolerances: exact for the switches
that store plane bytes (nodma, nocompute, nomm: integers, or zeros);
1e-3 (RGB) and 1e-4 (luma) on the 0-255 scale against the JAX gather
path for the weighted ones ("", norot, nowx), as tests/test_torch_ncc.py
and tests/test_torch_luma.py allow. The benchmark's window layout equals
the one rebuilt from the JAX package's plane_scene / plane_points /
window_geometry with the JAX tool's rng seeds: view and level indices
exactly, lattice origins and steps to 1e-4 px (float32 projections in
another order). The kernels themselves are held to these plain
versions on the card (tests/test_torch_cuda.py, chip_smoke.py)."""

import json
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvskit_tpu.geometry import camera as jcam
from mvskit_tpu.ops import ncc as jncc
from mvskit_tpu.ops import sampling as jsmp
from mvskit_tpu.utils import synthetic as jsyn
from mvskit_tpu_torch.ops import cuda_ncc
from mvskit_tpu_torch.tools import bench_kernel as bk
from test_torch_ncc import _candidates, _geometry, _t, _views
from torch_replay import jax_scene_to_torch

WSIZE = 7
S = WSIZE * WSIZE
SWITCHES = cuda_ncc.ABLATIONS


@pytest.fixture(scope="module")
def windows():
    """A JAX plane scene, the port's copy, and 4 x 32 candidate windows
    over 3 views (JAX geometry): (js, ts, idx, lvl, tl, dx, dy)."""
    Ps, _, js = jsyn.plane_scene(n_views=6, width=160, height=120)
    coord, normal = _candidates(Ps, 4, 32, seed=7)
    idx, lvl, tl, dx, dy, valid = _geometry(js, coord, normal, _views(coord.shape[0], 3))
    assert valid.mean() > 0.5
    return js, jax_scene_to_torch(js, Ps), idx, lvl, tl, dx, dy


def _lattice_np(tl, dx, dy, origin):
    """The port's lattice in numpy float32, op by op."""
    k = np.zeros(WSIZE, np.float32) if origin else np.arange(WSIZE, dtype=np.float32)
    li, lj = np.tile(k, WSIZE)[None, :], np.repeat(k, WSIZE)[None, :]
    gx = tl[:, :1] + dx[:, :1] * li + dy[:, :1] * lj
    gy = tl[:, 1:] + dx[:, 1:] * li + dy[:, 1:] * lj
    return gx.astype(np.float32), gy.astype(np.float32)


def _jax_taps(js, planes, idx, lvl, gx, gy, n_taps):
    """The plane words the gather path reads for each sample: JAX's tap
    origin (sampling.py: clip(int(x), 0, w - 2)) on JAX's planes."""
    flat = np.asarray(planes).reshape(-1)
    ni, t = planes.shape[1], planes.shape[2]
    lv = lvl[:, None]
    off = np.asarray(js.lvl_offsets)[lv]
    w = np.asarray(js.lvl_widths)[lv]
    h = np.asarray(js.lvl_heights)[lv]
    lx = np.asarray(jnp.clip(jnp.asarray(gx).astype(jnp.int32), 0, w - 2))
    ly = np.asarray(jnp.clip(jnp.asarray(gy).astype(jnp.int32), 0, h - 2))
    base = (idx[:, None].astype(np.int64) * ni) * t + off + ly * w + lx
    return [flat[base + d] for d in (0, 1, w, w + 1)[:n_taps]]


def _bytes(v, k):
    return ((v >> (8 * k)) & 0xFF).astype(np.float32)


def _definition(js, idx, lvl, tl, dx, dy, ablate, luma):
    """What the switch stores, from JAX values: [B, C * S]."""
    B = idx.shape[0]
    gx, gy = _lattice_np(tl, dx, dy, origin=ablate == "nowx")
    if ablate in ("", "norot", "nowx"):
        ii = jnp.asarray(np.broadcast_to(idx[:, None], (B, S)))
        ll = jnp.asarray(np.broadcast_to(lvl[:, None], (B, S)))
        fn = jsmp.sample_luma_quad if luma else jsmp.sample_color_ch_packed
        tex = np.asarray(fn(js, ii, jnp.asarray(gx), jnp.asarray(gy), ll, 0))
        return np.transpose(tex, (1, 0, 2)).reshape(B, -1)
    if ablate == "nodma":
        return np.zeros((B, (1 if luma else 3) * S), np.float32)
    if luma:
        (v,) = _jax_taps(js, js.planes_luma_quad, idx, lvl, gx, gy, 1)
        if ablate == "nocompute":
            return _bytes(v, 0)
        return ((_bytes(v, 0) + _bytes(v, 1)) + _bytes(v, 2)) + _bytes(v, 3)
    taps = _jax_taps(js, js.planes_packed, idx, lvl, gx, gy, 4)
    if ablate == "nocompute":
        chans = [_bytes(taps[0], c) for c in range(3)]
    else:  # nomm
        chans = [sum(_bytes(v, c) for v in taps) for c in range(3)]
    return np.concatenate(chans, axis=1)


@pytest.mark.parametrize("luma", [False, True], ids=["rgb", "luma"])
@pytest.mark.parametrize("ablate", SWITCHES)
def test_switch_plain_matches_its_definition(windows, ablate, luma):
    js, ts, idx, lvl, tl, dx, dy = windows
    args = (ts, _t(idx), _t(lvl), _t(tl), _t(dx), _t(dy), WSIZE)
    plain = cuda_ncc.sample_windows_luma_plain if luma else cuda_ncc.sample_windows_plain
    got = plain(*args, ablate=ablate).numpy()
    want = _definition(js, idx, lvl, tl, dx, dy, ablate, luma)
    assert got.shape == want.shape == (idx.shape[0], (1 if luma else 3) * S)
    if ablate in ("nodma", "nocompute", "nomm"):
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, atol=1e-4 if luma else 1e-3)
    # the CPU wrapper runs the same plain version in every launch form
    for group, fused in ((1, False), (32, False), (32, True)):
        out, fit = cuda_ncc.sample_windows(*args, group=group, luma=luma,
                                           fused=fused, ablate=ablate)
        assert fit.all() and torch.equal(out, torch.as_tensor(got))


def test_unknown_switch_raises(windows):
    _, ts, idx, lvl, tl, dx, dy = windows
    args = (ts, _t(idx), _t(lvl), _t(tl), _t(dx), _t(dy), WSIZE)
    for fn in (cuda_ncc.sample_windows, cuda_ncc.sample_windows_plain,
               cuda_ncc.sample_windows_luma_plain):
        with pytest.raises(ValueError, match="ablate"):
            fn(*args, ablate="noflop")
    with pytest.raises(ValueError, match="group"):
        bk.window_layout(ts, None, 100, group=32)


@pytest.mark.parametrize("group", [1, 32])
def test_run_layout_matches_jax_tool(group):
    """bench_kernel.run on a 6 x 160x120 scene against the JAX tool's
    layout (tools/bench_pallas_kernel.py:42-77), rebuilt from the JAX
    package with the same seeds."""
    B, n_views = 512, 6
    res = bk.run(B, reps=1, group=group, device="cpu", n_views=n_views,
                 width=160, height=120)
    Ps, _, js = jsyn.plane_scene(n_views=n_views, width=160, height=120)
    coord, normal = jsyn.plane_points(Ps, B, extent=1.2)
    coord = jnp.asarray(coord, jnp.float32)
    normal = jnp.asarray(normal, jnp.float32)
    idx = jnp.asarray(np.random.default_rng(0).integers(0, n_views, B), jnp.int32)
    px, py = jcam.get_paxes(js.cams, idx, coord, normal, bk.LEVEL)
    tl, dx, dy, lvl, valid = jncc.window_geometry(js, idx, coord, px, py, normal,
                                                  bk.LEVEL, WSIZE, math.radians(60.0))
    tl, dx, dy = (np.asarray(a) for a in (tl, dx, dy))
    idx, lvl, valid = np.asarray(idx), np.asarray(lvl), np.asarray(valid)
    if group > 1:
        Bg = B // group
        jx = np.random.default_rng(1).uniform(-2, 2, (Bg, group, 2)).astype(np.float32)
        jx[:, 0] = 0.0
        tl = (tl[:Bg][:, None, :] + jx).reshape(B, 2)
        idx, lvl, dx, dy, valid = (np.repeat(a[:Bg], group, 0)
                                   for a in (idx, lvl, dx, dy, valid))
    lay = res.layout
    np.testing.assert_array_equal(lay["idx"].numpy(), idx)
    np.testing.assert_array_equal(lay["lvl"].numpy(), lvl)
    np.testing.assert_array_equal(lay["valid"].numpy(), valid)
    for k, want in (("tl", tl), ("dx", dx), ("dy", dy)):
        np.testing.assert_allclose(lay[k].numpy(), want, atol=1e-4, err_msg=k)
    rec = res.record
    assert rec["windows"] == B and rec["scene"] == [n_views, 160, 120]
    assert 0.3 < rec["valid_frac"] < 1.0
    for mode, width in (("luma", S), ("rgb", 3 * S)):
        r = rec[mode]
        assert r["bitwise_equal_plain"] and r["max_abs_err"] == 0.0
        assert r["ms"] is None and r["plain_ms"] is None  # nothing timed off the card
        assert r["form"].endswith("grouped" if group > 1 else "ungrouped")
        assert res.out[mode].shape == (B, width)


def test_main_prints_its_record(capsys, monkeypatch):
    """The CLI reads GROUP / FUSED / ABLATE from the environment, as the
    JAX tool does (here on the CPU and a small batch)."""
    monkeypatch.setattr(bk, "SCENE", dict(n_views=6, width=160, height=120))
    monkeypatch.setenv("GROUP", "32")
    monkeypatch.setenv("FUSED", "1")
    monkeypatch.setenv("ABLATE", "nomm")
    assert bk.main(["256", "1", "--device", "cpu"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    rec = json.loads(out[-1])
    assert (rec["group"], rec["fused"], rec["ablate"]) == (32, True, "nomm")
    assert rec["rgb"]["form"] == "fused" and rec["luma"]["form"] == "luma_fused"
    assert not any(line.startswith("KERNEL_") for line in out)  # no device time on the CPU
