"""Bicubic sampling and the profiling utilities of mvskit_tpu_torch
against mvskit_tpu (tests/test_extras.py's cases, and more).

Tolerances and why: bicubic colors 1e-3 on the 0-255 scale (16 float32
products summed in the JAX package's order; the weights' polynomials
round alike, the sums may not); exact at lattice points, where the
weights collapse to one tap."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvskit_tpu.ops import sampling as jsmp
from mvskit_tpu.utils import synthetic as jsyn
from mvskit_tpu.utils.profiling import Counters as JCounters
from mvskit_tpu_torch.ops import sampling as tsmp
from mvskit_tpu_torch.utils import profiling
from torch_replay import jax_scene_to_torch


@pytest.fixture(scope="module")
def scenes():
    Ps, imgs, js = jsyn.plane_scene(n_views=3, width=64, height=48)
    return imgs, js, jax_scene_to_torch(js, Ps)


def test_bicubic_interpolates_lattice(scenes):
    imgs, _, ts = scenes
    col = tsmp.sample_color_bicubic(ts, 1, torch.tensor(10.0), torch.tensor(7.0), 0)
    assert col.shape == (3,)
    np.testing.assert_allclose(col.numpy(), imgs[1][7, 10], atol=1e-3)


def test_bicubic_matches_jax(scenes):
    _, js, ts = scenes
    rng = np.random.default_rng(0)
    n = 2048
    img = rng.integers(0, 3, n).astype(np.int32)
    lvl = rng.integers(0, 3, n).astype(np.int32)
    w = np.asarray(js.widths)[lvl]
    h = np.asarray(js.heights)[lvl]
    # inside, on the clamped borders and outside the image
    x = (rng.uniform(-0.1, 1.1, n) * (w - 1)).astype(np.float32)
    y = (rng.uniform(-0.1, 1.1, n) * (h - 1)).astype(np.float32)
    want = np.asarray(jsmp.sample_color_bicubic(
        js, jnp.asarray(img), jnp.asarray(x), jnp.asarray(y), jnp.asarray(lvl)))
    got = tsmp.sample_color_bicubic(ts, torch.as_tensor(img), torch.as_tensor(x),
                                    torch.as_tensor(y), torch.as_tensor(lvl))
    assert got.shape == want.shape == (3, n)
    assert np.ptp(want) > 50.0, "fixture must sample textured pixels"
    np.testing.assert_allclose(got.numpy(), want, atol=1e-3)


def test_phase_timer_and_counters():
    t = profiling.PhaseTimer()
    with t.phase("a"):
        pass
    with t.phase("a", sync=torch.ones(3)):
        pass
    with t.phase("b") as box:
        box["sync"] = torch.zeros(2)
    assert t.counts == {"a": 2, "b": 1}
    assert set(t.as_dict()) == {"a", "b"} and all(v >= 0.0 for v in t.totals.values())
    assert "a" in t.summary() and "x2" in t.summary()
    # the counters agree with the JAX package's on the same additions
    c, jc = profiling.Counters(), JCounters()
    for kw in (dict(total=10, passed=7), dict(total=5, passed=2, fail0=1)):
        c.add(**kw)
        jc.add(**kw)
    assert c.values == jc.values == {"total": 15, "passed": 9, "fail0": 1}
    assert c.rates() == pytest.approx(jc.rates())
    assert c.rates()["passed"] == pytest.approx(60.0)
    assert json.loads(c.as_json()) == c.values


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(None) as prof:
        assert prof is None
    log_dir = str(tmp_path / "trace")
    with profiling.trace(log_dir) as prof:
        torch.ones(64).sum()
    assert prof is not None
    with open(os.path.join(log_dir, "trace.json")) as f:
        assert "traceEvents" in json.load(f)
