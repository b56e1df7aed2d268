"""The port's refinement benchmark and studies on the CPU at a small size
(mvskit_tpu_torch/tools/bench.py, bench_refine_parts.py,
ab_refine_chip.py, ab_luma.py, ab_gradpolish.py, coverage_sweep.py),
against the JAX package on the gather path, and the driver's
``use_pallas`` switch.

Small plane: 6 views of 80x60 (plane points of extent 0.4, which all
views see at that size), B = 64, rounds 3, cands 8; the studies at
B = 32. Tolerances:
- bench's prep: the view lists equal, dscale to 1e-6 relative;
- a search against JAX ``refine_batch(group_dma=False)`` fed the same
  inputs and the same replayed noise (``torch_replay.refine_deltas``):
  coord within 1e-4 and ncc within 2e-4 on >= 99 % of patches, as in
  test_torch_refine.py (an argmin may flip between near-equal costs
  summed in another order);
  the ungrouped luma arm of ab_refine_chip may have up to 10 % of its
  patches end instead at a cost within 1e-5 of JAX's (its 6-round luma
  search from 3-dscale starts meets near-ties in its last rounds);
- each part of bench_refine_parts against the same part computed by the
  JAX package on its gather path: rtol 1e-5 (float32 sums of up to
  56,448 terms in another order);
- the port's grouped and ungrouped searches, and a driver run with
  ``use_pallas=False`` against the default run: equal bit for bit.
"""

import functools
import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvskit_tpu.geometry import camera as jcam
from mvskit_tpu.ops import ncc as jncc
from mvskit_tpu.pipeline import refine as jrf
from mvskit_tpu.pipeline import views as jvw
from mvskit_tpu.utils import synthetic as jsyn
from mvskit_tpu_torch.config import MVSConfig
from mvskit_tpu_torch.pipeline.driver import PMMVS
from mvskit_tpu_torch.tools import ab_gradpolish, ab_luma, ab_refine_chip, bench
from mvskit_tpu_torch.tools import bench_refine_parts
from mvskit_tpu_torch.tools import coverage_sweep
from mvskit_tpu_torch.tools.bench_kernel import bench_scene
from mvskit_tpu_torch.utils import synthetic
from torch_replay import refine_deltas

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LEVEL, WSIZE, TAU = 1, 7, 6
A1 = math.radians(60.0)
SMALL = dict(n_views=6, width=80, height=60, extent=0.4)
B, ROUNDS, CANDS = 64, 3, 8
JKW = dict(level=LEVEL, wsize=WSIZE, tau=TAU, min_image_num=3, angle_threshold1=A1,
           ascale=math.pi / 48.0, init_depth_radius=4.0, init_angle_radius=8.0)


def _close_enough(jres, tres, near_ties: float = 0.0):
    """>= 99 % of patches within 1e-4 on coord and 2e-4 on ncc. With
    `near_ties`, up to that fraction of the patches may instead end at a
    final cost within 1e-5 of JAX's: a search the two packages took
    apart at a near-tie of two candidates' costs."""
    jc, tc = np.asarray(jres.coord), tres.coord.numpy()
    jn, tn = np.asarray(jres.ncc), tres.ncc.numpy()
    ok = (np.abs(jc - tc).max(1) <= 1e-4) & (np.abs(jn - tn) <= 2e-4)
    tie = ~ok & (np.abs(np.asarray(jres.cost) - tres.cost.numpy()) <= 1e-5)
    assert tie.mean() <= near_ties and (ok | tie).mean() >= 0.99, (
        ok.mean(), tie.mean(), np.abs(jc - tc).max(), np.abs(jn - tn).max())


def jax_draw(rounds, n, cands, seed):
    """The noise of JAX refine_batch(PRNGKey(seed)) as the tools' draw."""
    return torch.from_numpy(refine_deltas(jax.random.PRNGKey(seed), rounds, n, cands))


@pytest.fixture(scope="module")
def plane():
    """The small plane in both packages (the same numpy renderer) and
    the port's bench inputs."""
    Ps, ts = bench_scene("cpu", SMALL["n_views"], SMALL["width"], SMALL["height"])
    _, _, js = jsyn.plane_scene(n_views=SMALL["n_views"], width=SMALL["width"],
                                height=SMALL["height"])
    coord, normal = bench.plane_inputs(Ps, ts, B, SMALL["extent"])
    return Ps, ts, js, coord, normal


def test_bench_prep_matches_jax(plane):
    _, ts, js, coord, normal = plane
    images, dscale = bench.prep(ts, coord, normal)
    c, n = jnp.asarray(coord.numpy()), jnp.asarray(normal.numpy())
    jimg = jnp.full((B, js.n_images), -1, jnp.int32).at[:, 0].set(0)
    jimg = jvw.add_images(js, c, n, jimg, LEVEL, A1)
    jimg = jvw.sort_images(js, c, n, jimg, LEVEL)
    jds, _ = jvw.set_scales(js, c, jimg, LEVEL, TAU, WSIZE)
    assert np.array_equal(images.numpy(), np.asarray(jimg))
    np.testing.assert_allclose(dscale.numpy(), np.asarray(jds), rtol=1e-6)
    assert (images[:, :3] >= 0).all()


@pytest.mark.parametrize("luma", [False, True])
def test_bench_search_matches_jax_gather_path(plane, luma):
    _, ts, js, coord, normal = plane
    images, dscale = bench.prep(ts, coord, normal)
    # start off the surface so the search has work to do
    start = coord.clone()
    start[:, 2] += torch.from_numpy(np.random.default_rng(0).uniform(-0.03, 0.03, B)).float()
    key = jax.random.PRNGKey(7)
    deltas = torch.from_numpy(refine_deltas(key, ROUNDS, B, CANDS))
    kw = dict(rounds=ROUNDS, cands=CANDS, luma=luma)
    tres = bench.search(ts, start, normal, images, dscale, deltas, group_dma=False, **kw)
    cfg = MVSConfig()
    j = lambda t: jnp.asarray(t.numpy())  # noqa: E731
    jres = jrf.refine_batch(js, j(start), j(normal), j(images), j(dscale), key,
                            rounds=ROUNDS, n_cands=CANDS, shrink=cfg.refine_shrink,
                            luma=luma, rgb_tail=cfg.refine_rgb_tail, group_dma=False, **JKW)
    _close_enough(jres, tres)
    assert np.median(np.abs(tres.coord[:, 2].numpy())) < np.median(np.abs(start[:, 2].numpy()))
    # the bench's own grouping serves the same candidates: the same bits
    grouped = bench.search(ts, start, normal, images, dscale, deltas, **kw)
    assert torch.equal(grouped.coord, tres.coord) and torch.equal(grouped.ncc, tres.ncc)


def test_bench_run_record_and_last_line(tmp_path, capsys, monkeypatch):
    cache = tmp_path / "baseline_cpu.json"
    cache.write_text(json.dumps({"msamples_per_s": 50.0}))
    rec, first = bench.run(batch=B, rounds=ROUNDS, cands=CANDS, reps=2, device="cpu",
                           baseline_cache=str(cache), **SMALL)
    assert rec["samples"] == B * ROUNDS * CANDS * TAU * WSIZE * WSIZE
    assert rec["evals_per_patch"] == ROUNDS * CANDS
    res = rec["result"]
    assert set(res) == {"metric", "value", "unit", "vs_baseline"}
    assert (res["metric"], res["unit"]) == ("ncc_refine_throughput", "Msamples/s")
    assert res["value"] > 0 and res["vs_baseline"] == pytest.approx(res["value"] / 50.0)
    assert rec["device"] == "cpu" and rec["timer"] == "host clock"
    assert rec["launches"] == {}  # the CPU runs the plain version
    assert rec["median_ncc"] > 0.9 and first.ncc.shape == (B,)
    # the differential mode counts the evaluations between the two depths
    rec_lo, _ = bench.run(batch=B, rounds=ROUNDS, rounds_lo=1, cands=CANDS, reps=1,
                          device="cpu", baseline_cache=str(cache), **SMALL)
    assert rec_lo["evals_per_patch"] == (ROUNDS - 1) * CANDS
    # the CLI's last line is the metric line
    monkeypatch.setattr(bench, "run", functools.partial(bench.run, baseline_cache=str(cache),
                                                        **SMALL))
    assert bench.main(["--device", "cpu", "--batch", "32", "--rounds", "2", "--cands", "4",
                       "--reps", "1", "--plain"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    last = json.loads(lines[-1])
    assert set(last) == {"metric", "value", "unit", "vs_baseline"}
    assert last["vs_baseline"] == pytest.approx(last["value"] / 50.0)
    assert lines[-2] == "card: none"


def test_cpu_baseline_builds_and_caches(tmp_path):
    cache = tmp_path / "baseline.json"
    val = bench.cpu_baseline_msps(str(cache), evals=2000)
    assert val > 0
    assert json.loads(cache.read_text())["msamples_per_s"] == val
    assert bench.cpu_baseline_msps(str(cache)) == val


def _jax_parts(js, views, coord, normal, luma, group):
    """The JAX tool's parts (tools/bench_refine_parts.py:96-216) on the
    gather path."""
    ref = jnp.maximum(views[:, 0], 0)
    px, py = jcam.get_paxes(js.cams, ref, coord, normal, LEVEL)
    T, Bn = views.shape[1], views.shape[0]
    wide = lambda x: jnp.broadcast_to(x[None], (T, Bn, 4))  # noqa: E731
    idx = jnp.maximum(views.T, 0)
    geo = jncc.window_geometry(js, idx, wide(coord), wide(px), wide(py), wide(normal),
                               LEVEL, WSIZE, A1)
    dense = jncc.window_geometry_views(js, views.T, coord, px, py, normal, LEVEL, WSIZE, A1)
    gsum = lambda tl, dx, dy, nl, valid: (jnp.sum(tl) + jnp.sum(dx) + jnp.sum(dy)  # noqa: E731
                                          + jnp.sum(nl) + jnp.sum(valid))
    out, fit, _ = jncc.sample_windows_raw(js, idx, *geo[:4], WSIZE, 0, luma, group)
    raw, rfit, _ = jncc.sample_windows_raw(js, idx, *dense[:4], WSIZE, 0, luma, group)
    tex, valid = jncc.texs_for_views(js, views, coord, normal, LEVEL, WSIZE, A1,
                                     luma=luma, group=group)
    return {
        "geometry": gsum(*geo),
        "geometry_dense": gsum(*dense),
        "geometry+kernel": jnp.sum(out * out) + jnp.sum(fit),
        "raw_windows": jnp.sum(raw) + jnp.sum(rfit) + jnp.sum(dense[4]),
        "texs_for_views": jnp.sum(tex * tex) + jnp.sum(valid),
        "eval_cost": jnp.sum(jncc.incc_cost(tex, valid, 3)),
    }


@pytest.mark.parametrize("luma,group", [(False, 1), (True, 8)])
def test_refine_parts_match_jax_gather_path(plane, luma, group):
    Ps, ts, js, _, _ = plane
    rec = bench_refine_parts.run(batch=B, luma=luma, group=group, scene=(Ps, ts),
                                 extent=SMALL["extent"])
    assert list(rec["parts"]) == list(bench_refine_parts.PARTS)
    assert rec["windows"] == B * TAU and rec["device"] == "cpu"
    views, coord, normal = bench_refine_parts.part_inputs(Ps, ts, B, group, SMALL["extent"])
    j = lambda t: jnp.asarray(t.numpy())  # noqa: E731
    ref = _jax_parts(js, j(views), j(coord), j(normal), luma, group)
    for name, p in rec["parts"].items():
        assert p["ms"] is None and p["launches"] == {}  # nothing timed on the CPU
        np.testing.assert_allclose(p["value"], float(ref[name]), rtol=1e-5, err_msg=name)


def test_refine_parts_scan_lines(plane, capsys, monkeypatch):
    Ps, ts, _, _, _ = plane
    monkeypatch.setattr(bench_refine_parts, "run", functools.partial(
        bench_refine_parts.run, scene=(Ps, ts), extent=SMALL["extent"]))
    assert bench_refine_parts.main(["--device", "cpu", "--batch", "32", "--group", "8",
                                    "--scan", "1,3"]) == 0
    out = capsys.readouterr().out.splitlines()
    names = [bench_refine_parts.line_name(p) for p in bench_refine_parts.PARTS]
    for n in names:
        assert f"{n}_MS=not measured" in out, n
        assert f"SCAN_{n}_MS=not measured" in out, n
    rec = json.loads(out[-1])
    assert rec["scan"] == [1, 3] and list(rec["scan_parts"]) == list(bench_refine_parts.PARTS)


def _jax_refine(js, inp, seed, **arm):
    j = lambda t: jnp.asarray(t.numpy())  # noqa: E731
    return jrf.refine_batch(js, j(inp["start"]), j(inp["start_n"]), j(inp["images"]),
                            j(inp["dscale"]), jax.random.PRNGKey(seed), group_dma=False,
                            **{**JKW, **arm})


def test_ab_refine_chip_arms(plane):
    _, _, js, _, _ = plane
    rec, res, inp = ab_refine_chip.run(batch=32, device="cpu", draw=jax_draw, **SMALL)
    with open(os.path.join(REPO, "REFINE_AB_CHIP.json")) as f:
        jrec = json.load(f)
    assert set(jrec) <= set(rec) and list(rec["arms"]) == list(jrec["arms"])
    for name, arm in rec["arms"].items():
        assert set(arm) == set(jrec["arms"][name]), name
    g, u = res["6x32_grouped_luma"], res["6x32_ungrouped_luma"]
    assert torch.equal(g.coord, u.coord) and torch.equal(g.ncc, u.ncc)
    assert rec["grouped_equals_ungrouped_luma"] is True
    # the luma search from these starts meets near-ties in its last
    # rounds: 2 of the 32 patches here branch apart from JAX's search
    # in round 5 or 6 at costs equal to 6e-8, and end within 6.4e-6
    for name, kw, ties in (("6x32_grouped_rgb", dict(luma=False), 0.0),
                           ("6x32_ungrouped_luma", dict(luma=True, rgb_tail=0), 0.1)):
        jres = _jax_refine(js, inp, 1, rounds=6, n_cands=32, shrink=0.4096, **kw)
        _close_enough(jres, res[name], ties)


def test_ab_luma_arms():
    rec, res, inputs = ab_luma.run(batch=32, nillums=2, device="cpu", draw=jax_draw)
    with open(os.path.join(REPO, "LUMA_AB.json")) as f:
        jrec = json.load(f)
    assert set(jrec) <= set(rec) and list(rec["scenes"]) == list(jrec["scenes"])
    for tag, arms in rec["scenes"].items():
        assert list(arms) == list(jrec["scenes"][tag])
        for name, arm in arms.items():
            assert set(arm) == set(jrec["scenes"][tag][name]), (tag, name)
    cfg = MVSConfig()
    inp = inputs["sphere"]
    _, _, js = jsyn.sphere_scene(n_views=8, width=160, height=120, nillums=1)
    for name, luma in (("rgb_search", False), ("luma_search", True)):
        jres = _jax_refine(js, inp, 0, rounds=cfg.refine_rounds, n_cands=cfg.refine_cands,
                           shrink=cfg.refine_shrink, luma=luma)
        _close_enough(jres, res["sphere", name])
    # the tool's grouped search against the same search ungrouped
    from mvskit_tpu_torch.pipeline import refine as trf

    ungrouped = trf.refine_batch(
        inp["scene"], inp["start"], inp["start_n"], inp["images"], inp["dscale"],
        jax_draw(cfg.refine_rounds, 32, cfg.refine_cands, 0), rounds=cfg.refine_rounds,
        n_cands=cfg.refine_cands, shrink=cfg.refine_shrink, luma=True, group_dma=False,
        **JKW)
    got = res["sphere", "luma_search"]
    assert torch.equal(ungrouped.coord, got.coord) and torch.equal(ungrouped.ncc, got.ncc)


def test_ab_gradpolish_arms():
    """The study's record has GRADPOLISH.json's layout; arm C (arm A's
    search, the same noise, then 4 polish steps) never ends at a higher
    cost than arm A and lowers some; arm B searches with half the
    candidates. (The polish itself is held to JAX in
    tests/test_torch_polish.py.)"""
    rec, res, inputs = ab_gradpolish.run(batch=16, device="cpu", draw=jax_draw)
    with open(os.path.join(REPO, "GRADPOLISH.json")) as f:
        jrec = json.load(f)
    assert set(jrec) <= set(rec) and list(rec["scenes"]) == list(jrec["scenes"])
    for tag, arms in rec["scenes"].items():
        assert list(arms) == list(jrec["scenes"][tag])
        for name, arm in arms.items():
            assert set(arm) == set(jrec["scenes"][tag][name]), (tag, name)
            assert arm["evals_fwd_equiv"] == jrec["scenes"][tag][name]["evals_fwd_equiv"]
    for tag in rec["scenes"]:
        a, c = res[tag, "A_random_12x16"].cost, res[tag, "C_random_12x16_grad4"].cost
        ok = torch.as_tensor(inputs[tag]["ok"])
        assert (c <= a).all() and (c[ok] < a[ok]).any(), tag
        assert not torch.equal(res[tag, "B_random_12x8_grad4"].coord,
                               res[tag, "A_random_12x16"].coord)


def test_coverage_sweep_artifact(tmp_path):
    out = tmp_path / "cov.json"
    prefix = str(tmp_path / "ds")
    args = ["--prefix", prefix, "--views", "4", "--width", "80", "--height", "60",
            "--seeds", "64", "--max-patches", "4096", "--budgets", "256", "--rounds", "2",
            "--policies", "cell_first", "--device", "cpu", "--out", str(out)]
    assert coverage_sweep.main(args) == 0
    art = json.loads(out.read_text())
    with open(os.path.join(REPO, "COVERAGE.json")) as f:
        jart = json.load(f)
    assert set(art) == (set(jart) - {"backend"}) | {"device", "card"}
    assert art["device"] == "cpu" and len(art["runs"]) == 1
    run = art["runs"][0]
    assert set(run) == set(jart["runs"][0])
    assert (run["donor_policy"], run["donor_budget"], run["prop_rounds"]) == ("cell_first",
                                                                              256, 2)
    assert run["final_alive"] > 0 and 0.0 < run["comp_frac@0.05"] <= 1.0
    assert os.path.exists(coverage_sweep.dataset_marker(prefix, 4, 80, 60, 64))


def test_driver_use_pallas_false_equals_default(tmp_path):
    prefix = str(tmp_path / "ds")
    synthetic.write_dataset(prefix, n_views=4, width=80, height=60, n_seeds=64)
    clouds = []
    for use_pallas in (True, False):
        cfg = MVSConfig.from_option_file(prefix)
        cfg.n_iterations, cfg.prop_rounds, cfg.max_patches = 1, 2, 4096
        cfg.donor_budget, cfg.refine_cands = 256, 4
        cfg.use_pallas = use_pallas
        engine = PMMVS(cfg, device="cpu", log=lambda *a: None)
        try:
            assert engine.scene.use_kernel is use_pallas
            engine.seed()
            engine.run(write_snapshots=False)
            clouds.append(engine.collect())
        finally:
            engine.close()
    for k in ("coord", "normal", "ncc", "images"):
        assert np.array_equal(clouds[0][k], clouds[1][k]), k
    assert clouds[0]["coord"].shape[0] > 0
