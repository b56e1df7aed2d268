#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (mvskit_tpu_torch) once on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure raises and the process exits non-zero):
  0. device: needs torch.cuda; prints the card's name and power limit
     (nvidia-smi) and the CUDA version;
  1. build: compiles the kernel library from mvskit_tpu_torch/csrc and
     prints ptxas's registers, shared memory and spills of every kernel
     instance the script launches;
  2. kernels vs plain: the NCC window sampler's launch forms (RGB and
     luma, ungrouped, grouped and fused) against their plain PyTorch
     versions, bit for bit, at the shapes their paths give them on a
     16 x 640x480, 4-level plane scene (RGB ungrouped: 4096 patches x 6
     views; the others: 4096 x 32 refinement candidates x 6 views, the
     luma ungrouped launch also on the 4096 x 6), the grouped and fused
     forms also against the ungrouped / grouped launch and the ungrouped
     forms against the grouped launch, with CUDA-event timings and each
     kernel's bound (least time for its bytes and operations on an
     H100); every record (K1, K2, K3u, K3g, K4) also carries its
     launch plan (tile, persistent grid, stages, store path) and
     ptxas's numbers, the grouped and fused ones each K5 switch's time on
     the same windows, the grouped ones K4's time and the ungrouped
     launch's plan and time, the ungrouped ones the timing floors beside
     theirs; each is also timed against the library yardstick, one 5-D
     grid_sample call on the scene's level volume
     (tools/bench_kernel.library_windows), which must agree with the
     kernel's output within LIBRARY_ATOL; K4 also runs the edge lattices of
     tools/bench_kernel.edge_windows (NaN, +-inf, negative coordinates,
     ones on integers and past w - 2) at 7 x 7 and 5 x 5 under every K5
     switch, beside the grouped and ungrouped launches, each bit for bit
     against its plain version;
  3. RGB main path: writes the 16 x 640x480, 4096-seed plane dataset and
     runs `mvskit_tpu_torch.cli.main` with the default config (3
     iterations, 8 rounds, 6 x 32 RGB search, 2^18-row table);
  4. luma search: `PMMVS` with luma_refine=True on phase 3's dataset at
     full depth (4 luma rounds through the grouped luma kernel, then 2
     RGB rounds), then a short run with refine_group_dma=False, which
     launches the ungrouped luma kernel;
  5. multi-illumination: a 3-illumination dataset of the same size
     through `cli.main` with the default config (every score averaged
     over the 3 illuminations);
  6. kernel bench path: `mvskit_tpu_torch.tools.bench_kernel.run` at the
     JAX tool's size (57,344 windows on 16 x 640x480): group 1 and 32,
     fused off and on, and every ablation switch on the grouped RGB and
     luma forms, each output bit for bit against its plain version and
     each unablated one within LIBRARY_ATOL of the grid_sample yardstick;
  7. pmvs: `cli.main --strategy pmvs` on phase 3's dataset at the
     default depth.
  8. K1 at the RGB path's batches: the ungrouped RGB launch timed,
     bounded and checked bit for bit at the median and the largest
     batch that phase 3 gave it, with its plan, K5 times and timing
     floors there.
  9. meshes: `PMMVS` on phase 3's dataset with the default config,
     unsharded and then with the meshes (dp, view, tile) = (1, 2, 1),
     (1, 1, 2), (2, 1, 1), (4, 1, 1) and (2, 2, 2) as logical shards of
     the one card (`mesh_devices=[cuda:0] * k`); each sharded run's
     alive counts per iteration and cloud (coord, normal, ncc, images)
     equal the unsharded run's bit for bit, every view shard launched K1
     and K2 on its own windows, and every dp shard took rows in every
     stage its axis partitions (`shard.DP_ROWS`; with a tile axis the
     rounds' grid build and donor selection are the tiles') and launched
     K1 in hypothesis scoring (`shard.DP_K1`);
 10. multihost: `mvskit_tpu_torch.tools.multihost_ncc` as two processes
     on the card joined by gloo, then as one process on nccl (a real
     NCCL init and all_reduce); each rank's view-sharded NCC, and its
     gradient-polished refinement (the backward kernel launched, the
     gradient summed over the ranks), equal its single-process values
     (each child has a timeout).
 11. grid and round benches (run after phase 5, before phase 7 rewrites
     the RGB path's .patch): `tools.bench_grid.run` at production
     capacity (2^18 rows, 57,850 alive) on phase 3's dataset, plain,
     `--tiles 2` and `--dp 2`, all three equal; `tools.bench_prop_parts.run`
     on the RGB path's final .patch at dp 1 and 2, each stage's time and
     K1/K2 launches logged.
 12. refine tools (last): `tools.bench.run` (the refinement throughput
     metric) at B = 8,192 on 16 x 640x480, RGB, then `--plain`, whose
     search equals the kernel path's bit for bit and launches nothing;
     `tools.bench_refine_parts.run` at B = 65,536 (RGB group 1 and 32,
     luma group 32); `tools.ab_refine_chip.run` at B = 4,096 (its grouped
     and ungrouped luma arms equal bit for bit); `tools.ab_luma.run`; and
     one `tools.coverage_sweep.run` configuration on phase 3's dataset.
 14. polish (run after phase 5, on phase 3's dataset): the backward
     kernel of the window sampler (csrc/sample_windows_grad.cu) on K1's
     windows (RGB) and K3u's (luma) with a seeded cotangent and on the
     edge lattices at 7 x 7 and 5 x 5, two launches bit for bit and
     within GRAD_RTOL of its plain version (autograd through the gather
     path, in float64 from the same lattice), timed against its bound,
     the float32 plain version and grid_sample's backward; then `PMMVS`
     with refine_grad_steps=4 at full width and depth (quality against
     the round's bar, K1 / K2 / backward launches, rows each polish step
     accepted, the polish's share of the refinement's device time), and
     one-iteration runs: luma with refine_rgb_tail 0 (the luma
     backward), and the meshes (1,2,1) and (2,1,1) with the polish, each
     equal to the unsharded polished run bit for bit.
 13. surface (run after phase 11, on the RGB path's final table with
     planted floaters and the filter pass's first grid):
     `filters.filter_neighbor` equal to `filter_neighbor_rows(0,
     capacity)` (kill mask and count; it must kill),
     `gather_neighbors` / `quad_residuals` equal to their `_batch` forms
     on 1,024 alive rows, and `PatchTable.n_images_per_patch` equal to
     its value on a CPU copy, each bit for bit.
Each path runs with the launch counters set to 0 just before it and
read just after (launches and windows per launch of each form); each
checks its outputs and, where the path has one, its quality against the
analytic plane. The line before the last is the kernels' JSON record;
the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
WSIZE, LEVEL, TAU, N_CANDS = 7, 1, 6, 32
KERNEL_SOURCE = "mvskit_tpu_torch/csrc/sample_windows.cu"
GRAD_SOURCE = "mvskit_tpu_torch/csrc/sample_windows_grad.cu"
# the backward replaces no TPU kernel: the JAX polish takes the gradient
# by XLA's autodiff of the gather path (gscene drops the Pallas planes)
REPLACES_GRAD = "mvskit_tpu/pipeline/refine.py:290"
REPLACES = "mvskit_tpu/ops/pallas_ncc.py:190"
REPLACES_FUSED = "mvskit_tpu/ops/pallas_ncc.py:323"
REPLACES_ABLATE = "mvskit_tpu/ops/pallas_ncc.py:194"
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and float32 FLOP/s
# outside the tensor cores
HBM_BYTES_PER_S, F32_FLOPS = 3.35e12, 67e12
# float32 operations per sample: lattice 8 (4 mul + 4 add); tap
# fractions 4; RGB: 4 tap weights + 3 channels x 4 taps x (mul + add);
# luma: 4 taps x 2 mul + 3 add. Ablation switches: nodma, norot and nowx
# do the same arithmetic; nocompute only the lattice; nomm the lattice
# and the unweighted tap sums (RGB 3 x 4 adds, luma 3 adds)
FLOPS_PER_SAMPLE = {"rgb": 8 + 4 + 4 + 24, "luma": 8 + 4 + 11}
# the backward kernel per sample: lattice 8, fractions 4, the two clip
# slopes' differences 2; per channel the two tap-difference brackets (4
# subtractions, 4 multiplications, 2 additions) and their products with
# the cotangent into the x and y sums (4); then the two slopes (2) and
# the six partial sums (4 multiplications + 6 additions)
GRAD_FLOPS_PER_SAMPLE = {"rgb": 8 + 4 + 2 + 3 * 14 + 2 + 10, "luma": 8 + 4 + 2 + 14 + 2 + 10}
ABLATE_FLOPS = {("rgb", "nocompute"): 8, ("luma", "nocompute"): 8,
                ("rgb", "nomm"): 8 + 12, ("luma", "nomm"): 8 + 3}
# limits per path (acc_mean max, comp_frac min) at 0.05 against the
# analytic plane. RGB and multi-illumination: the round's carried-over
# quality bar (E2E_r05.json, a TPU v5e run of the JAX package: acc_mean
# 0.0116, comp_frac 1.0) with margin; luma: E2E_r05_luma.json (0.0158 /
# 0.9997 on the TPU).
LIMITS = {"rgb": (0.015, 0.98), "luma": (0.017, 0.98), "illum3": (0.015, 0.98)}
ACC_MEAN_BAR = 0.012
# the library yardstick (one grid_sample call) against each kernel, on
# the 0-255 scale: its coordinates' normalise / unnormalise round trip
# moves a sample by about 1e-4 px
LIBRARY_ATOL = 0.02
# name, launch-counter form, channel mode, the window set its path gives
# it (K1: the gauntlet's patches x views; K2, K3 grouped and K3
# ungrouped: the refinement candidates, which the luma path launches
# ungrouped when refine_group_dma=False; K4, whose path is the kernel
# bench: the same refinement candidates), group of the launch, fused
KERNELS = (
    ("sample_windows_ungrouped", "ungrouped", "rgb", "ungrouped", 1, False),
    ("sample_windows_grouped", "grouped", "rgb", "grouped", N_CANDS, False),
    ("sample_windows_luma_ungrouped", "luma_ungrouped", "luma", "grouped", 1, False),
    ("sample_windows_luma_grouped", "luma_grouped", "luma", "grouped", N_CANDS, False),
    ("sample_windows_fused", "fused", "rgb", "grouped", N_CANDS, True),
    ("sample_windows_luma_fused", "luma_fused", "luma", "grouped", N_CANDS, True),
)
# the kernel instance (ptxas name: kernel<C, WS, switch>) behind each
# record. The ungrouped and grouped forms of a channel mode are one
# instance of the persistent window kernel (K1 and K2 window_kernel<3, 7,
# 0>, K3u and K3g window_kernel<1, 7, 0>), launched with different tile
# plans; K4 is fused_kernel<C, WS, switch>.
INSTANCE = {
    "sample_windows_ungrouped": f"window_kernel<3, {WSIZE}, 0>",
    "sample_windows_grouped": f"window_kernel<3, {WSIZE}, 0>",
    "sample_windows_luma_ungrouped": f"window_kernel<1, {WSIZE}, 0>",
    "sample_windows_luma_grouped": f"window_kernel<1, {WSIZE}, 0>",
    "sample_windows_fused": f"fused_kernel<3, {WSIZE}, 0>",
    "sample_windows_luma_fused": f"fused_kernel<1, {WSIZE}, 0>",
}
# every instance the script launches: both kernels, both channel modes,
# WS = 7 and the run-time size instance (WS = 0, the edge lattices at
# EDGE_WSIZE), every K5 switch
EDGE_WSIZE = 5
LAUNCHED_INSTANCES = tuple(f"{k}<{c}, {ws}, {a}>" for k in ("window_kernel", "fused_kernel")
                           for c in (3, 1) for ws in (WSIZE, 0) for a in range(6)) + tuple(
    f"window_grad_kernel<{c}, {ws}>" for c in (3, 1) for ws in (WSIZE, 0))


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return res.stdout.strip().splitlines()[0]


def window_sets(dev, n_points=4096, grouped=True):
    """Windows of real patch geometry at the main path's shapes:
    `n_points` plane patches with their 6 best views (sortImages order),
    and (with `grouped`) the n_points x 32 jittered refinement
    candidates of round 0 over the same views. Returns the scene and,
    per set, (idx, lvl, tl, dx, dy, valid, T, B) flattened T-major."""
    import torch

    from mvskit_tpu_torch.geometry import camera as cam
    from mvskit_tpu_torch.ops import ncc
    from mvskit_tpu_torch.pipeline import refine as rf
    from mvskit_tpu_torch.pipeline import views as vw
    from mvskit_tpu_torch.utils import synthetic

    Ps, _, scene = synthetic.plane_scene(
        n_views=16, width=640, height=480, max_level=LEVEL + 3, device=dev
    )
    coord_np, normal_np = synthetic.plane_points(Ps, n_points, seed=1, extent=0.8)
    coord = torch.as_tensor(coord_np, dtype=torch.float32, device=dev)
    normal = torch.as_tensor(normal_np, dtype=torch.float32, device=dev)
    B = coord.shape[0]
    empty = torch.full((B, 16), -1, dtype=torch.int32, device=dev)
    images = vw.add_images(scene, coord, normal, empty, LEVEL, 1.0471976)
    images = vw.sort_images(scene, coord, normal, images, LEVEL, is_fixed=False)
    views = images[:, :TAU]

    def geometry(views, coord, normal):
        ref = views[:, 0].clamp(min=0).long()
        px, py = cam.get_paxes(scene.cams, ref, coord, normal, LEVEL)
        views_t = views.T.contiguous()
        tl, dx, dy, lvl, valid = ncc.window_geometry_views(
            scene, views_t, coord, px, py, normal, LEVEL, WSIZE, 1.0471976
        )
        valid = valid & (views_t >= 0)
        T, Bw = views_t.shape
        flat = lambda x, k: x.reshape((T * Bw,) + k).contiguous()  # noqa: E731
        return (flat(views_t.clamp(min=0).to(torch.int32), ()),
                flat(lvl.to(torch.int32), ()), flat(tl, (2,)),
                flat(dx, (2,)), flat(dy, (2,)), valid, T, Bw)

    ungrouped = geometry(views, coord, normal)
    if not grouped:
        return scene, {"ungrouped": ungrouped}

    # round-0 refinement candidates (refine.refine_batch's encoding)
    ds, _ = vw.set_scales(scene, coord, views, LEVEL, TAU, WSIZE)
    ds = torch.where(ds == 0.0, torch.ones_like(ds), ds)
    ref = views[:, 0].clamp(min=0).long()
    ray = coord - scene.cams.center[ref]
    ray = ray / ray.norm(dim=-1, keepdim=True)
    ascale = 3.141592653589793 / 48.0
    a1, a2 = rf.encode_normal(scene, ref, normal)
    p0 = torch.stack([torch.zeros_like(a1), a1 / ascale, a2 / ascale], -1)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    radius = torch.tensor([4.0, 8.0, 8.0], device=dev)
    delta = rf.draw_deltas(gen, 1, B, N_CANDS, dev)[0] * radius
    delta[:, 0] = 0.0
    cand = (p0.unsqueeze(1) + delta).reshape(B * N_CANDS, 3)
    rep = lambda x: x.repeat_interleave(N_CANDS, 0)  # noqa: E731
    c = rf.decode_coord(rep(coord), rep(ray), rep(ds), cand[:, 0])
    n = rf.decode_normal(scene, rep(ref), cand[:, 1] * ascale, cand[:, 2] * ascale)
    grouped = geometry(rep(views), c, n)
    return scene, {"ungrouped": ungrouped, "grouped": grouped}


def touched_pixels(scene, idx, lvl, tl, dx, dy, mode: str, ablate: str = "") -> int:
    """Distinct plane pixels (4-byte words) the windows read: the four
    taps of each sample in the RGB form, the one quad of each sample in
    the luma form; under an ablation switch what it still reads (nodma
    none, nocompute tap 00, nowx the lattice origin's taps)."""
    import torch

    from mvskit_tpu_torch.ops import cuda_ncc, sampling

    if ablate == "nodma":
        return 0
    planes = scene.planes_luma_quad if mode == "luma" else scene.planes_packed
    n, ni, total = planes.shape
    seen = torch.zeros(n * ni * total, dtype=torch.bool, device=planes.device)
    step = 1 << 18
    for s in range(0, idx.shape[0], step):
        sl = slice(s, s + step)
        gx, gy = cuda_ncc.lattice(tl[sl], dx[sl], dy[sl], WSIZE, origin=ablate == "nowx")
        lv = lvl[sl].long().clamp(0, len(scene.offsets) - 1).unsqueeze(1)
        w = scene.lvl_widths[lv]
        lx, ly = sampling._bilinear_frac(gx, gy, w, scene.lvl_heights[lv])[:2]
        base = ((idx[sl].long() * ni).unsqueeze(1) * total + scene.lvl_offsets[lv]
                + ly * w + lx).long()
        one = mode == "luma" or ablate == "nocompute"
        for d in ((0,) if one else (0, 1, w.long(), w.long() + 1)):
            seen[(base + d).reshape(-1)] = True
    return int(seen.sum())


def bound(nwin: int, mode: str, touched: int, ablate: str = "", grad: bool = False):
    """Least time (ms) for the kernel's work on an H100 and what bounds
    it: the bytes it must move (32 B of window parameters per window,
    each touched plane word once, each output float once; with `grad`,
    the backward's, each grad_out float read once and 24 B of gradients
    written per window) over HBM bandwidth, against its float32
    operations over the f32 peak."""
    S = WSIZE * WSIZE
    out_floats = nwin * S * (1 if mode == "luma" else 3)
    nbytes = nwin * 32 + touched * 4 + out_floats * 4 + (nwin * 24 if grad else 0)
    per_sample = (GRAD_FLOPS_PER_SAMPLE[mode] if grad
                  else ABLATE_FLOPS.get((mode, ablate), FLOPS_PER_SAMPLE[mode]))
    flops = nwin * S * per_sample
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), nbytes, flops


def measure(name, scene, wset, mode, group, fused=False):
    """One launch form on one window set: bit for bit against its plain
    version, finite NCC costs, its bound and its times (kernel, kernel
    as one call, plain, twice; each a median of 7). Returns (record,
    output)."""
    import torch

    from mvskit_tpu_torch.ops import cuda_ncc, ncc
    from mvskit_tpu_torch.tools.bench_kernel import bits_equal, cuda_time_ms

    idx, lvl, tl, dx, dy, valid, T, Bw = wset
    luma = mode == "luma"
    S = WSIZE * WSIZE
    nwin = idx.shape[0]
    kern = lambda: cuda_ncc.sample_windows(  # noqa: E731
        scene, idx, lvl, tl, dx, dy, WSIZE, group=group, luma=luma, fused=fused)[0]
    plain_fn = cuda_ncc.sample_windows_luma_plain if luma else cuda_ncc.sample_windows_plain
    plain = lambda: plain_fn(scene, idx, lvl, tl, dx, dy, WSIZE)  # noqa: E731
    out_k = kern()
    torch.cuda.synchronize()
    out_p = plain()
    torch.cuda.synchronize()
    bitwise = bits_equal(out_k, out_p)
    both = torch.isfinite(out_k) & torch.isfinite(out_p)
    err = (out_k - out_p).abs()[both].max().item() if both.any() else 0.0
    if not bitwise:
        raise AssertionError(f"{name}: kernel differs from its plain version "
                             f"(max |d| {err})")
    # NCC costs through normalize_tex / incc_cost
    C = 1 if luma else 3
    cost = ncc.incc_cost(ncc.normalize_tex(out_k.reshape(T, Bw, C * S), C, S), valid, 3)
    if not torch.isfinite(cost).all():
        raise AssertionError(f"{name}: non-finite NCC cost")
    del out_p, cost
    touched = touched_pixels(scene, idx, lvl, tl, dx, dy, mode)
    b_ms, b_by, nbytes, flops = bound(nwin, mode, touched)
    ms, plain_ms, call_ms = [], [], []
    for _ in range(2):
        ms.append(cuda_time_ms(kern, 7))
        call_ms.append(cuda_time_ms(kern, 7, hold=False))
        plain_ms.append(cuda_time_ms(plain, 7))
    rec = {"windows": nwin, "group": group, "fused": fused,
           "form": cuda_ncc.launch_form(nwin, group, luma, fused),
           "valid_frac": float(valid.float().mean()),
           "max_abs_err": err, "bitwise_equal_plain": bitwise,
           "touched_plane_words": touched, "bytes": nbytes, "flops": flops,
           "bound_ms": b_ms, "bound_by": b_by, "ms_runs": ms, "plain_ms_runs": plain_ms,
           "call_ms_runs": call_ms, "ms": min(ms), "call_ms": min(call_ms),
           "plain_ms": min(plain_ms)}
    rec["bound_share"] = b_ms / rec["ms"]
    rec["msamples_per_s"] = nwin * S / rec["ms"] / 1e3
    return rec, out_k


def library_times(scene, wset, mode, out_k):
    """The library yardstick on the record's windows: one 5-D
    grid_sample call (tools/bench_kernel.library_windows) on the scene's
    level volume. `library_ms` is that call alone on a grid built
    beforehand, `library_call_ms` the grid's preparation from the
    lattices, the call and the copy into the kernel's layout, both timed
    as `ms` is; `library_max_abs_err` is against the kernel's output
    (0.02 at most on the 0-255 scale)."""
    import torch

    from mvskit_tpu_torch.tools import bench_kernel as bk

    args = tuple(wset[:5])
    luma = mode == "luma"
    vol = bk.level_volume(scene, luma)
    grid = bk.library_grid(scene, *args, WSIZE, vol)
    lib = bk.library_windows(scene, *args, WSIZE, luma=luma, volume=vol)
    both = torch.isfinite(lib) & torch.isfinite(out_k)
    err = (lib - out_k).abs()[both].max().item() if both.any() else 0.0
    del lib
    rec = {"library_max_abs_err": err, "library_volume_bytes": vol.numel() * 4,
           "library_ms": min(bk.cuda_time_ms(lambda: bk.library_sample(vol, grid), 7)
                             for _ in range(2)),
           "library_call_ms": min(bk.cuda_time_ms(lambda: bk.library_windows(
               scene, *args, WSIZE, luma=luma, volume=vol), 7) for _ in range(2))}
    del grid
    if not err <= LIBRARY_ATOL:
        raise AssertionError(f"{mode}: grid_sample differs from the kernel by {err}")
    return rec


def check_ungrouped(rec, scene, wset, mode, out):
    """The ungrouped output against the grouped launch (groups of
    N_CANDS) on the same windows, bit for bit (on the whole groups the
    batch holds), and the ungrouped launch's plan."""
    from mvskit_tpu_torch.ops import cuda_ncc
    from mvskit_tpu_torch.tools.bench_kernel import bits_equal

    n = wset[0].shape[0]
    m = n - n % N_CANDS
    luma = mode == "luma"
    if m:
        grp = cuda_ncc.sample_windows(scene, *(x[:m] for x in wset[:5]), WSIZE,
                                      group=N_CANDS, luma=luma)[0]
        rec["bitwise_equal_grouped"] = bits_equal(grp, out[:m])
        if not rec["bitwise_equal_grouped"]:
            raise AssertionError(f"{mode} ungrouped output differs from the grouped launch")
    rec["plan"] = cuda_ncc.ungrouped_plan(n, WSIZE, luma)


def floor_times(scene, wset, mode, out):
    """Device ms, timed as the kernels are, of a launch that does next to
    nothing (torch's fill of 4 floats), of writing an output of the
    record's size (torch's fill of it), of the ungrouped launch on the
    record's first window alone, and of a plane-row tensor
    idx * ni + illum built for the record's windows (two elementwise
    kernels): the floor every launch pays in this timing, the floor of
    the record's stores, the kernel's own fixed chain (prologue, one
    pass, store), and what a wrapper that builds the plane rows per call
    adds to each call (the kernel computes them in its member table)."""
    import torch

    from mvskit_tpu_torch.ops import cuda_ncc
    from mvskit_tpu_torch.tools.bench_kernel import cuda_time_ms

    tiny = torch.empty(4, device=out.device)
    full = torch.empty_like(out)
    idx = wset[0]
    ni = (scene.planes_luma_quad if mode == "luma" else scene.planes_packed).shape[1]
    one = tuple(x[:1] for x in wset[:5])
    return {"fill_4_floats": cuda_time_ms(lambda: tiny.fill_(1.0), 7),
            "fill_output": cuda_time_ms(lambda: full.fill_(1.0), 7),
            "one_window": cuda_time_ms(lambda: cuda_ncc.sample_windows(
                scene, *one, WSIZE, luma=mode == "luma")[0], 7),
            "plane_rows": cuda_time_ms(lambda: (idx * ni + 0).contiguous(), 7)}


def ungrouped_extras(rec, scene, wset, mode, out, ptxas):
    """The ungrouped record's check against the grouped launch, its plan
    and ptxas line, each K5 switch's time on the same windows, and its
    timing floors."""
    check_ungrouped(rec, scene, wset, mode, out)
    rec["ptxas"] = ptxas.get(f"window_kernel<{1 if mode == 'luma' else 3}, {WSIZE}, 0>")
    rec["ablate_ms_same_windows"] = ablation_times(scene, wset, mode, 1)
    rec["floor_ms"] = floor_times(scene, wset, mode, out)


def ablation_times(scene, wset, mode, group, fused=False):
    """Device ms of the launch form of `group` (and `fused`) under each
    K5 switch on the same windows: what each dropped stage of the work
    costs."""
    from mvskit_tpu_torch.ops import cuda_ncc
    from mvskit_tpu_torch.tools.bench_kernel import cuda_time_ms

    idx, lvl, tl, dx, dy = wset[:5]
    times = {}
    for ablate in cuda_ncc.ABLATIONS[1:]:
        def kern():
            return cuda_ncc.sample_windows(scene, idx, lvl, tl, dx, dy, WSIZE, group=group,
                                           luma=mode == "luma", fused=fused,
                                           ablate=ablate)[0]
        times[ablate] = min(cuda_time_ms(kern, 7) for _ in range(2))
    return times


def edge_check(scene, mode):
    """K4 of one channel mode on the edge lattices of
    tools/bench_kernel.edge_windows (NaN, +-inf, -0.0, negative
    coordinates, ones on integers, on w - 2 and past it, denormal, past
    int32), at WSIZE (compiled) and EDGE_WSIZE (run-time size), in groups
    of N_CANDS under every K5 switch, and the grouped and ungrouped
    launches of the window kernel beside it: each bit for bit against
    its plain version. Returns the record."""
    from mvskit_tpu_torch.ops import cuda_ncc
    from mvskit_tpu_torch.tools.bench_kernel import bits_equal, edge_windows

    luma = mode == "luma"
    plain_fn = cuda_ncc.sample_windows_luma_plain if luma else cuda_ncc.sample_windows_plain
    args = edge_windows(scene, 64 * N_CANDS)
    launches = 0
    for wsize in (WSIZE, EDGE_WSIZE):
        for ablate in cuda_ncc.ABLATIONS:
            plain = plain_fn(scene, *args, wsize, ablate=ablate)
            for group, fused in ((N_CANDS, True), (N_CANDS, False), (1, False)):
                out = cuda_ncc.sample_windows(scene, *args, wsize, group=group, luma=luma,
                                              fused=fused, ablate=ablate)[0]
                launches += 1
                if not bits_equal(out, plain):
                    raise AssertionError(f"{mode} edge lattices, wsize {wsize}, group {group}, "
                                         f"fused {fused}, ablate {ablate!r}: kernel differs "
                                         f"from its plain version")
    return {"windows": args[0].shape[0], "wsizes": [WSIZE, EDGE_WSIZE],
            "switches": list(cuda_ncc.ABLATIONS), "launches": launches,
            "bitwise_equal_plain": True}


def kernel_phase(dev):
    """Phase 2. Returns the per-kernel records (without path launches)."""
    import torch

    from mvskit_tpu_torch.ops import _build, cuda_ncc
    from mvskit_tpu_torch.tools import bench_kernel as bk

    _build.load_library()  # built before its ptxas report is read
    ptxas = _build.ptxas_report()
    scene, sets = window_sets(dev)
    card = card_line()
    records = {}
    for name, _, mode, wset, group, fused in KERNELS:
        rec, out = measure(name, scene, sets[wset], mode, group, fused)
        if fused:  # the fused launch equals the unfused grouped one
            base = "sample_windows_luma_grouped" if mode == "luma" else "sample_windows_grouped"
            grp, out_g = measure(name + " (grouped launch)", scene, sets[wset], mode, group)
            rec["bitwise_equal_grouped"] = bk.bits_equal(out_g, out)
            if not rec["bitwise_equal_grouped"]:
                raise AssertionError(f"{name}: fused output differs from grouped")
            rec["grouped_ms_same_windows"] = grp["ms"]
            rec["vs_" + base] = rec["ms"] / records[base]["ms"]
            rec["vs_grouped_same_call"] = rec["ms"] / grp["ms"]
            rec["plan"] = cuda_ncc.fused_plan(rec["windows"], WSIZE, group, mode == "luma")
            rec["ptxas"] = ptxas.get(INSTANCE[name])
            rec["ablate_ms_same_windows"] = ablation_times(scene, sets[wset], mode, group,
                                                           fused=True)
            rec["edge_lattices"] = edge_check(scene, mode)
            del out_g
        elif group > 1:  # the grouped launch equals the ungrouped one
            ung, out_u = measure(name + " (ungrouped launch)", scene, sets[wset], mode, 1)
            rec["bitwise_equal_ungrouped"] = bk.bits_equal(out_u, out)
            if not rec["bitwise_equal_ungrouped"]:
                raise AssertionError(f"{name}: grouped output differs from ungrouped")
            rec["ungrouped_ms_same_windows"] = ung["ms"]
            rec["plan"] = cuda_ncc.grouped_plan(rec["windows"], WSIZE, group, mode == "luma")
            rec["ptxas"] = ptxas.get(INSTANCE[name])
            rec["ablate_ms_same_windows"] = ablation_times(scene, sets[wset], mode, group)
            rec["ungrouped_plan_same_windows"] = cuda_ncc.ungrouped_plan(
                rec["windows"], WSIZE, mode == "luma")
            del out_u
        else:  # the ungrouped forms, K1 and K3u
            ungrouped_extras(rec, scene, sets[wset], mode, out, ptxas)
            if wset != "ungrouped":  # also at the gauntlet's shape
                g, out_g = measure(name + " (gauntlet windows)", scene, sets["ungrouped"],
                                   mode, 1)
                ungrouped_extras(g, scene, sets["ungrouped"], mode, out_g, ptxas)
                rec["gauntlet_windows"] = {k: g[k] for k in (
                    "windows", "ms", "plain_ms", "bound_ms", "bound_share",
                    "bitwise_equal_grouped", "plan", "ablate_ms_same_windows",
                    "floor_ms")}
                del out_g
        rec.update(library_times(scene, sets[wset], mode, out))
        log(f"[kernel] {name} on {card}: " + json.dumps(rec))
        records[name] = rec
        del out
        torch.cuda.empty_cache()
    # K4 computes K2's and K3g's output on the same windows
    for grouped, fused in (("sample_windows_grouped", "sample_windows_fused"),
                           ("sample_windows_luma_grouped", "sample_windows_luma_fused")):
        records[grouped]["fused_ms_same_windows"] = records[fused]["ms"]
        log(f"[kernel] {grouped}: {records[grouped]['ms']} ms (bound share "
            f"{records[grouped]['bound_share']:.3f}), fused {records[fused]['ms']} ms, "
            f"grid {records[grouped]['plan']['grid']}, ptxas {records[grouped]['ptxas']}")
    bk._volume.cache_clear()
    return records


def path_batch_phase(dev, batches):
    """Phase 8: K1 at the median and the largest batch the RGB path gave
    it, on that many gauntlet windows (plane patches x 6 views, the
    first `n` T-major), timed, bounded and bit for bit against its plain
    version and the grouped launch, with each K5 switch's time and the
    timing floors. `batches` counts the path's launches per batch size.
    Returns {"median"|"max": record}."""
    import torch

    out = {}
    median = int(statistics.median(batches.elements()))
    for what, n in (("median", median), ("max", max(batches))):
        scene, sets = window_sets(dev, n_points=-(-n // TAU), grouped=False)
        idx, lvl, tl, dx, dy, valid = sets["ungrouped"][:6]
        wset = (idx[:n], lvl[:n], tl[:n], dx[:n], dy[:n], valid.reshape(1, -1)[:, :n], 1, n)
        rec, out_k = measure(f"sample_windows_ungrouped ({what} RGB path batch)", scene,
                             wset, "rgb", 1)
        check_ungrouped(rec, scene, wset, "rgb", out_k)
        rec["ablate_ms_same_windows"] = ablation_times(scene, wset, "rgb", 1)
        rec["floor_ms"] = floor_times(scene, wset, "rgb", out_k)
        log(f"[batches] K1 at the RGB path's {what} batch: " + json.dumps(rec))
        out[what] = {k: rec[k] for k in ("windows", "ms", "plain_ms", "bound_ms",
                                         "bound_share", "max_abs_err", "plan",
                                         "floor_ms")}
        del out_k, sets
        torch.cuda.empty_cache()
    return out


def build_report():
    """ptxas's registers, shared memory and spills of every kernel
    instance the script launches (None where the report lacks one)."""
    from mvskit_tpu_torch.ops import _build

    ptxas = _build.ptxas_report()
    report = {k: ptxas.get(k) for k in LAUNCHED_INSTANCES}
    log("[build] ptxas " + json.dumps(report))
    missing = [k for k, v in report.items() if v is None]
    if missing:
        log(f"[build] ptxas report lacks {missing} ({len(ptxas)} instances read)")
    return report


def bench_phase(dev):
    """Phase 6: the kernel bench path (tools/bench_kernel.run) at the JAX
    tool's size, with the launch counters set to 0 just before and read
    just after. Every output equals its plain version bit for bit; each
    ablated run gets its bound from its own reads. Returns (records,
    launches)."""
    from mvskit_tpu_torch.ops import cuda_ncc
    from mvskit_tpu_torch.tools import bench_kernel as bk
    from mvskit_tpu_torch.utils import profiling

    scene = bk.bench_scene(dev, **bk.SCENE)
    settings = ([(g, f, "") for g in (1, N_CANDS) for f in (False, True)]
                + [(N_CANDS, False, a) for a in cuda_ncc.ABLATIONS[1:]])
    profiling.COUNTERS.reset()
    records = []
    for group, fused, ablate in settings:
        res = bk.run(bk.N_WINDOWS, reps=7, group=group, fused=fused, ablate=ablate,
                     scene=scene)
        rec = res.record
        for mode in ("luma", "rgb"):
            if not rec[mode]["bitwise_equal_plain"]:
                raise AssertionError(f"bench {group}/{fused}/{ablate!r} {mode}: kernel "
                                     f"differs from its plain version")
            if not ablate and not rec[mode]["library_max_abs_err"] <= LIBRARY_ATOL:
                raise AssertionError(f"bench {group}/{fused} {mode}: grid_sample differs "
                                     f"by {rec[mode]['library_max_abs_err']}")
            lay = res.layout
            touched = touched_pixels(scene[1], lay["idx"], lay["lvl"], lay["tl"], lay["dx"],
                                     lay["dy"], mode, ablate)
            b_ms, b_by, _, _ = bound(bk.N_WINDOWS, mode, touched, ablate)
            rec[mode].update(bound_ms=b_ms, bound_by=b_by, touched_plane_words=touched)
        log("[bench] " + json.dumps(rec))
        records.append(rec)
    launches = dict(cuda_ncc.LAUNCHES)
    bk._volume.cache_clear()
    log("[bench] launches " + json.dumps(launches))
    return records, launches


def plane_quality(cloud):
    import numpy as np

    from mvskit_tpu_torch.utils import metrics

    g = np.linspace(-1.0, 1.0, 200)
    xs, ys = np.meshgrid(g, g)
    gt = np.stack([xs.ravel(), ys.ravel(), np.zeros(xs.size)], axis=1)
    m = metrics.accuracy_completeness(cloud, gt, threshold=0.05, crop_to_gt_bbox=True)
    m["plane_rms"] = metrics.plane_rms(cloud)
    return m


def path_windows():
    """Per launch form (and ablation switch) the path launched, its
    windows per launch: count, median and max, and its launches per
    batch size."""
    import collections

    from mvskit_tpu_torch.ops import cuda_ncc

    return {k: {"count": v.total(), "median": statistics.median(v.elements()),
                "max": max(v), "batches": collections.Counter(v)}
            for k, v in cuda_ncc.WINDOWS.items() if v}


def summarize(tag, report, wall, launches, windows, m):
    """Log a path's stages, throughput, launches, windows per launch and
    quality (the batch-size lists stay out of the log line)."""
    for st in report["stages"]:
        log(f"[{tag}] stage {json.dumps(st)}")
    hyp = sum(s.get("hypotheses", 0) for s in report["stages"])
    prop_s = sum(s["seconds"] for s in report["stages"]
                 if s["stage"].startswith("propagate"))
    summary = {"wall_s": wall, "launches": launches,
               "alive_per_iter": report["alive_per_iter"],
               "filter_kills": report["filters"], "hypotheses": hyp,
               "propagate_s": prop_s, "hypotheses_per_s": hyp / max(prop_s, 1e-9),
               "peak_mem_gib": report.get("peak_mem_gib"), "quality": m,
               "view_shards": report.get("shards"), "dp": report.get("dp"),
               "windows": {k: {f: v[f] for f in ("count", "median", "max")}
                           for k, v in windows.items()}}
    log(f"[{tag}] summary " + json.dumps(summary))
    summary["batches"] = {k: v["batches"] for k, v in windows.items()}
    return summary


def check_quality(tag, m, limits):
    acc_max, comp_min = limits
    log(f"[{tag}] acc_mean {m['acc_mean']:.6f} (limit {acc_max}), comp_frac "
        f"{m['comp_frac']:.4f} (limit {comp_min})")
    if not (m["acc_mean"] <= acc_max and m["comp_frac"] >= comp_min):
        raise AssertionError(f"{tag}: quality below the limits {limits}: {m}")


def check_pyramids(tag, loads):
    """scene.PYRAMIDS since the counters' last reset: `loads` scenes
    whose planes were built on their device, none from host planes."""
    from mvskit_tpu_torch.image import scene as sc

    got = dict(sc.PYRAMIDS)
    log(f"[{tag}] scene.PYRAMIDS {json.dumps(got)}")
    if got != {"device": loads, "host": 0}:
        raise AssertionError(f"{tag}: scene.PYRAMIDS {got}, want {loads} built on the device")


def cli_path(tag, dev, prefix, *flags):
    """The port's CLI on `prefix` (with extra `flags`) with the launch
    counters reset just before and read just after. Returns (report,
    wall, launches, windows, m)."""
    import torch

    from mvskit_tpu_torch import cli
    from mvskit_tpu_torch.io import ply
    from mvskit_tpu_torch.ops import cuda_ncc
    from mvskit_tpu_torch.utils import profiling

    out = os.path.join(prefix, "ply", "final_patches")
    report_path = os.path.join(prefix, f"report_{tag}.json")
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    profiling.COUNTERS.reset()
    t0 = time.time()
    rc = cli.main([prefix, "--device", dev.type, "--export-patch", "--out", out,
                   "--report", report_path, *flags])
    wall = time.time() - t0
    launches = dict(cuda_ncc.LAUNCHES)
    windows = path_windows()
    if rc != 0:
        raise AssertionError(f"{tag}: cli.main returned {rc}")
    check_pyramids(tag, 1)
    with open(report_path) as f:
        report = json.load(f)
    if dev.type == "cuda":
        report["peak_mem_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
    for ext in (".ply", ".patch"):
        if not os.path.exists(out + ext):
            raise AssertionError(f"{tag}: missing output {out + ext}")
    cloud = ply.read_ply(out + ".ply")["xyz"]
    if report["final_alive"] <= 0 or cloud.shape[0] != report["final_alive"]:
        raise AssertionError(f"{tag}: bad final cloud {cloud.shape[0]} vs "
                             f"{report['final_alive']}")
    return report, wall, launches, windows, plane_quality(cloud)


def shard_stats(trace=None):
    """The view-sharded sampler's calls per (shard, form) with their
    windows per launch, and its host syncs (the sync spans of `trace`,
    a utils/profiling.Trace, at "sampler.shard_counts")."""
    from mvskit_tpu_torch.ops import ncc
    from mvskit_tpu_torch.utils import profiling

    calls = {f"{s}/{f}": {"launches": n, "windows_per_launch": ncc.SHARD_WINDOWS[s, f] / n}
             for (s, f), n in sorted(ncc.SHARD_CALLS.items())}
    syncs = profiling.sync_count(trace, "sampler.shard_counts") if trace is not None else 0
    return {"calls": calls, "syncs": syncs}


def dp_stats():
    """The dp axis's rows per stage and shard, and its K1 launches per
    shard from hypothesis scoring."""
    from mvskit_tpu_torch.parallel import shard as sh

    rows = {}
    for (stage, shard), n in sorted(sh.DP_ROWS.items()):
        rows.setdefault(stage, {})[str(shard)] = n
    return {"rows": rows, "k1": {str(k): v for k, v in sorted(sh.DP_K1.items())}}


def engine_path(tag, dev, prefix, scene=None, mesh_devices=None, **overrides):
    """PMMVS through the Python API (the luma search has no CLI flag),
    seed + run, with the launch counters reset just before and read
    just after; a mesh run records its spans (utils/profiling.tracing)
    for the sampler's host syncs. Returns (engine, report, wall,
    launches, windows, m)."""
    import contextlib

    import numpy as np
    import torch

    from mvskit_tpu_torch.config import MVSConfig
    from mvskit_tpu_torch.ops import cuda_ncc
    from mvskit_tpu_torch.pipeline.driver import PMMVS
    from mvskit_tpu_torch.utils import profiling

    cfg = MVSConfig.from_option_file(prefix)
    for k, v in overrides.items():
        setattr(cfg, k, v)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    profiling.COUNTERS.reset()
    t0 = time.time()
    engine = PMMVS(cfg, scene=scene, device=dev, log=lambda *a: None,
                   mesh_devices=mesh_devices)
    recording = profiling.tracing() if mesh_devices is not None else contextlib.nullcontext()
    try:
        with recording as trace:
            engine.seed()
            engine.run(write_snapshots=False)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        wall = time.time() - t0
        launches = dict(cuda_ncc.LAUNCHES)
        windows = path_windows()
        check_pyramids(tag, 0 if scene is not None else 1)
        data = engine.collect()
    finally:
        engine.close()
    report = dict(engine.report, shards=shard_stats(trace), dp=dp_stats(), peak_mem_gib=(
        torch.cuda.max_memory_allocated(dev) / 2**30 if dev.type == "cuda" else None))
    cloud = data["coord"][:, :3]
    if cloud.shape[0] <= 0 or not np.isfinite(cloud).all():
        raise AssertionError(f"{tag}: bad final cloud of {cloud.shape[0]} points")
    return engine, report, wall, launches, windows, plane_quality(cloud)


def paths_phase(dev, workdir):
    """Phases 3-5. Returns {path: summary}."""
    from mvskit_tpu_torch.utils import synthetic

    size = dict(n_views=16, width=640, height=480, n_seeds=4096)
    out = {}

    # 3. RGB main path
    plane = os.path.join(workdir, "plane16")
    t0 = time.time()
    synthetic.write_dataset(plane, **size)
    log(f"[main] dataset written in {time.time() - t0:.2f} s")
    out["rgb"] = summarize("main", *cli_path("main", dev, plane))

    # 4. luma search, full depth, then a short ungrouped run
    engine, *res = engine_path("luma", dev, plane, luma_refine=True)
    out["luma"] = summarize("luma", *res)
    _, *res = engine_path("luma_ungrouped", dev, plane, scene=engine.scene,
                          luma_refine=True, refine_group_dma=False, n_iterations=1,
                          prop_rounds=2)
    out["luma_ungrouped"] = summarize("luma_ungrouped", *res)
    del engine

    # 5. multi-illumination
    il3 = os.path.join(workdir, "illum3")
    t0 = time.time()
    synthetic.write_dataset(il3, nillums=3, **size)
    log(f"[illum3] dataset written in {time.time() - t0:.2f} s")
    res = cli_path("illum3", dev, il3)
    out["illum3"] = summarize("illum3", *res)
    out["illum3"]["n_illums"] = res[0]["prop_params"]["n_illums"]
    return out


def pmvs_phase(dev, workdir):
    """Phase 7: the pmvs strategy through the CLI on phase 3's dataset."""
    res = cli_path("pmvs", dev, os.path.join(workdir, "plane16"), "--strategy", "pmvs")
    report = res[0]
    summary = summarize("pmvs", *res)
    summary["accepted_per_iter"] = [st["accepted"] for st in report["stages"]
                                    if st["stage"].startswith("propagate")]
    if report["strategy"] != "pmvs":
        raise AssertionError(f"pmvs path ran strategy {report['strategy']!r}")
    return summary


MESHES = ((1, 2, 1), (1, 1, 2), (2, 1, 1), (4, 1, 1), (2, 2, 2))
# the stages a dp axis partitions (shard.DP_ROWS); with a tile axis the
# rounds' grid build and donor selection are the tiles', and the filter
# pass's grid builds are the dp axis's
DP_STAGES = ("grid", "vimages", "donors", "hypotheses", "gauntlet", "insert", "outside",
             "exact", "neighbor", "groups")


def mesh_phase(dev, workdir, rgb):
    """Phase 9: the unsharded RGB run through PMMVS on phase 3's dataset,
    then each mesh of MESHES, on the scene that run loaded, as logical
    shards of the card, each with
    the counters set to 0 just before it and read just after. A sharded
    run must keep the unsharded run's alive counts per iteration and its
    cloud bit for bit, and each view shard must launch K1 and K2.
    Returns {name: summary}."""
    import numpy as np
    import torch

    card0 = torch.device("cuda", 0)
    plane = os.path.join(workdir, "plane16")
    out = {}
    engine, *res = engine_path("mesh_1x1x1", dev, plane)
    base, scene = engine.collect(), engine.scene
    out["1x1x1"] = summarize("mesh_1x1x1", *res)
    if out["1x1x1"]["alive_per_iter"] != rgb["alive_per_iter"]:
        raise AssertionError(f"unsharded PMMVS run {out['1x1x1']['alive_per_iter']} differs "
                             f"from the RGB path {rgb['alive_per_iter']}")
    del engine
    for dp, view, tile in MESHES:
        name = f"{dp}x{view}x{tile}"
        engine, *res = engine_path(f"mesh_{name}", dev, plane, scene=scene,
                                   mesh_devices=[card0] * (dp * view * tile),
                                   mesh_dp=dp, mesh_view=view, mesh_tile=tile)
        got = engine.collect()
        del engine
        summary = summarize(f"mesh_{name}", *res)
        out[name] = summary
        if summary["alive_per_iter"] != out["1x1x1"]["alive_per_iter"]:
            raise AssertionError(f"mesh {name}: alive {summary['alive_per_iter']} vs "
                                 f"{out['1x1x1']['alive_per_iter']} unsharded")
        for k in ("coord", "normal", "ncc", "images"):
            if not np.array_equal(got[k], base[k]):
                raise AssertionError(f"mesh {name}: cloud {k} differs from the unsharded run")
        calls = summary["view_shards"]["calls"]
        for s_ in range(view if view > 1 else 0):
            for form in ("ungrouped", "grouped"):
                if calls.get(f"{s_}/{form}", {}).get("launches", 0) <= 0:
                    raise AssertionError(f"mesh {name}: view shard {s_} launched no {form}")
        if not (summary["launches"]["ungrouped"] > 0 and summary["launches"]["grouped"] > 0):
            raise AssertionError(f"mesh {name} missed a kernel: {summary['launches']}")
        rows, k1 = summary["dp"]["rows"], summary["dp"]["k1"]
        for stage in (DP_STAGES if dp > 1 else ()):
            if stage == "donors" and tile > 1:
                continue
            got = [rows.get(stage, {}).get(str(i), 0) for i in range(dp)]
            if min(got) <= 0:
                raise AssertionError(f"mesh {name}: a dp shard took no rows in {stage}: {got}")
        if dp > 1 and min(k1.get(str(i), 0) for i in range(dp)) <= 0:
            raise AssertionError(f"mesh {name}: a dp shard launched no K1: {k1}")
        log(f"[mesh_{name}] cloud and alive counts equal to the unsharded run bit for bit"
            + (f"; dp rows {json.dumps(rows)}, dp K1 {json.dumps(k1)}" if dp > 1 else ""))
    return out


def bench_tools_phase(dev, workdir):
    """Phase 11: tools/bench_grid at production capacity on phase 3's
    dataset (plain, 2 tiles, dp 2; run() raises where a sharded build
    differs), then tools/bench_prop_parts on the RGB path's final .patch
    at dp 1 and 2. Returns both records."""
    from mvskit_tpu_torch.tools import bench_grid, bench_prop_parts

    plane = os.path.join(workdir, "plane16")
    grid = bench_grid.run(plane, tiles=2, dp=2, device=dev)
    log("[benches] bench_grid " + json.dumps(grid))
    parts, _ = bench_prop_parts.run(plane, os.path.join(plane, "ply", "final_patches.patch"),
                                    dp=2, device=dev)
    for tag, table in parts["stages"].items():
        log(f"[benches] bench_prop_parts {tag} " + json.dumps(table))
    log("[benches] bench_prop_parts " + json.dumps(
        {k: v for k, v in parts.items() if k != "stages"}))
    return grid, parts


def surface_phase(dev, workdir):
    """Phase 13: on the RGB path's final table (phase 3's .patch, read
    back into a table of cfg.max_patches rows on `dev`, with every 50th
    alive row lifted off the plane, and the filter pass's first grid
    rebuilt on it), the whole-table filter entry point and the row
    helpers against what the main path calls: filter_neighbor against
    filter_neighbor_rows(0, capacity) (kill mask and count),
    gather_neighbors / quad_residuals against the _batch forms on the
    first 1,024 alive rows, and n_images_per_patch against its value on
    a CPU copy of the table, each bit for bit; and the lifted rows split
    by the gate that kills or keeps each (fewer than 6 neighbours, the
    quadric; survivors with denom < 1, with a residual under
    quad_threshold, with a non-finite residual), whose kills must be
    the whole pass's kills among them. Returns the record."""
    import torch

    from mvskit_tpu_torch.config import MVSConfig
    from mvskit_tpu_torch.core.grid import pow2_limit
    from mvskit_tpu_torch.core.patches import PatchTable
    from mvskit_tpu_torch.pipeline import filters as fl
    from mvskit_tpu_torch.pipeline import seed as sd
    from mvskit_tpu_torch.pipeline.driver import PMMVS

    plane = os.path.join(workdir, "plane16")
    cfg = MVSConfig.from_option_file(plane)
    engine = PMMVS(cfg, device=dev, log=lambda *a: None)
    scene = engine.scene
    table = sd.seed_from_patch_file(scene, cfg, os.path.join(plane, "ply", "final_patches.patch"))
    engine.close()
    n_alive = table.n_alive()
    # plant floaters (every 50th alive row lifted 0.2 off the plane) so
    # that the neighbour filter has rows to kill
    lift = torch.nonzero(table.alive).flatten()[::50]
    table.coord[lift, 2] += 0.2
    table, grid = fl.rebuild(scene, table, cfg.level, cfg.csize, cfg.filter_cell_capacity,
                             cfg.neighbor_threshold, additive=False,
                             row_limit=pow2_limit(max(n_alive, 1), table.capacity))
    lv, cs = cfg.level, cfg.csize
    caps = dict(max_neighbors=cfg.neighbor_capacity, cand_cap=cfg.neighbor_cand_cap)

    def bits(t):
        return t.view(torch.int32) if t.dtype == torch.float32 else t

    def same(a, b):
        return a.shape == b.shape and torch.equal(bits(a), bits(b))

    t0 = time.time()
    whole, n_whole = fl.filter_neighbor(scene, grid, table, lv, cs, cfg.tau,
                                        cfg.quad_threshold, cfg.neighbor_threshold, **caps)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    whole_s = time.time() - t0
    by_rows, n_rows = fl.filter_neighbor_rows(scene, grid, table, 0, table.capacity, lv, cs,
                                              cfg.tau, cfg.quad_threshold,
                                              cfg.neighbor_threshold, **caps)
    rows = torch.nonzero(table.alive).flatten()[:1024].to(torch.int32)
    idx = rows.long()
    nb_kw = dict(margin=2, scale=4.0, neighbor_threshold=cfg.neighbor_threshold, **caps)
    nbrs, count = fl.gather_neighbors(scene, grid, table, rows, lv, cs, **nb_kw)
    nbrs_b, count_b = fl.gather_neighbors_batch(
        scene, grid, table, table.coord[idx], table.normal[idx], table.dscale[idx],
        table.images[idx], rows, lv, cs, **nb_kw)
    resid, denom = fl.quad_residuals(scene, table, rows, nbrs, lv, cfg.tau)
    resid_b, denom_b = fl.quad_residuals_batch(scene, table, table.coord[idx],
                                               table.normal[idx], table.images[idx], nbrs,
                                               lv, cfg.tau)
    # the floaters by gate of filter_neighbor_rows' reject rule, each
    # scored in the pass's own chunk of 1,024 rows (a batch of another
    # size may round its quadric fit otherwise)
    parts = []
    for s0 in (torch.unique(lift // 1024) * 1024).tolist():
        c_rows = torch.arange(s0, min(s0 + 1024, table.capacity), device=dev,
                              dtype=torch.int32)
        c_nbrs, c_count = fl.gather_neighbors(scene, grid, table, c_rows, lv, cs, **nb_kw)
        c_resid, c_denom = fl.quad_residuals(scene, table, c_rows, c_nbrs, lv, cfg.tau)
        sel = lift[(lift >= s0) & (lift < s0 + 1024)] - s0
        parts.append((c_count[sel], c_resid[sel], c_denom[sel]))
    f_count, f_resid, f_denom = (torch.cat([p[i] for p in parts]) for i in range(3))
    q = cfg.quad_threshold
    f_reject = (f_count < 6) | ((f_denom >= 1) & (f_resid >= q))
    f_fit = ~f_reject & (f_denom >= 1)
    gates = {"count_lt_6": f_count < 6,
             "quadric": (f_count >= 6) & (f_denom >= 1) & (f_resid >= q),
             "survive_denom_lt_1": ~f_reject & (f_denom < 1),
             "survive_resid_lt_threshold": f_fit & (f_resid < q),
             "survive_resid_not_finite": f_fit & ~torch.isfinite(f_resid)}
    host = PatchTable(*(x.cpu() for x in table))
    rec = {
        "capacity": table.capacity, "alive": n_alive, "floaters": int(lift.numel()),
        "rows": int(rows.numel()),
        "filter_neighbor_s": whole_s, "kills": n_whole, "kills_by_rows": n_rows,
        "kill_mask_equal": same(whole.alive, by_rows.alive) and n_whole == n_rows,
        "gather_neighbors_equal": same(nbrs, nbrs_b) and same(count, count_b),
        "quad_residuals_equal": same(resid, resid_b) and same(denom, denom_b),
        "n_images_per_patch_equal": same(table.n_images_per_patch().cpu(),
                                         host.n_images_per_patch()),
        "max_views": table.max_views,
        "median_neighbors": float(count.float().median()),
        "floaters_killed": int((table.alive[lift] & ~whole.alive[lift]).sum()),
        "floater_gates": {k: int(v.sum()) for k, v in gates.items()},
        "floater_median_neighbors": float(f_count.float().median()),
        "floater_kills_equal": bool(torch.equal(f_reject,
                                                table.alive[lift] & ~whole.alive[lift])),
    }
    log("[surface] " + json.dumps(rec))
    failed = [k for k, v in rec.items() if k.endswith("_equal") and not v]
    if failed or n_whole <= 0 or not (rows.numel() == min(1024, n_alive) > 0):
        raise AssertionError(f"surface phase: {failed or 'no kills or no alive rows'}: {rec}")
    return rec


def refine_tools_phase(dev, workdir):
    """Phase 12: the refinement benchmark and studies, each run with the
    launch counters set to 0 just before it and read just after:
    (a) tools/bench.run at full size (B = 8,192, RGB): a positive value,
        median ncc >= 0.95 on the plane sampled at its true pose, a
        numeric vs_baseline, K1 and K2 launched;
    (b) the same with --plain: coord, normal and ncc equal (a)'s bit for
        bit, and no kernel launched;
    (c) tools/bench_refine_parts at B = 65,536: RGB group 1 (K1), RGB
        group 32 (K2), luma group 32 (K3g), every part timed and traced;
    (d) tools/ab_refine_chip at B = 4,096: the grouped and ungrouped
        luma arms equal bit for bit, the ungrouped one through K3u;
    (e) tools/ab_luma at its size, and one tools/coverage_sweep
        configuration (cell_first, 16,384 donors, 8 rounds, 1 iteration)
        on phase 3's dataset.
    Returns ({tool: record}, {tool: launches})."""
    import numpy as np
    import torch

    from mvskit_tpu_torch.ops import cuda_ncc
    from mvskit_tpu_torch.tools import ab_luma, ab_refine_chip, bench, bench_refine_parts
    from mvskit_tpu_torch.tools import coverage_sweep
    from mvskit_tpu_torch.tools.bench_kernel import bench_scene, bits_equal
    from mvskit_tpu_torch.utils import profiling

    def counted(tag, fn):
        torch.cuda.synchronize(dev)
        profiling.COUNTERS.reset()
        t0 = time.time()
        res = fn()
        torch.cuda.synchronize(dev)
        launches = {k: v for k, v in cuda_ncc.LAUNCHES.items() if v}
        log(f"[refine_tools] {tag}: {time.time() - t0:.2f} s, launches {json.dumps(launches)}")
        return res, launches

    def need(tag, launches, *forms):
        missed = [f for f in forms if launches.get(f, 0) <= 0]
        if missed:
            raise AssertionError(f"{tag} launched no {missed}: {launches}")

    scene = bench_scene(dev)  # the 16 x 640x480 plane of (a) to (d)
    recs, launches = {}, {}
    (rec, kern), launches["bench"] = counted("bench", lambda: bench.run(scene=scene))
    res = rec["result"]
    log("[refine_tools] bench " + json.dumps({k: v for k, v in rec.items() if k != "result"}))
    log("[refine_tools] bench " + json.dumps(res))
    if not (res["value"] > 0 and rec["median_ncc"] >= 0.95
            and isinstance(res["vs_baseline"], float)):
        raise AssertionError(f"bench: {res}, median ncc {rec['median_ncc']}")
    need("bench", launches["bench"], "ungrouped", "grouped")
    (prec, plain), launches["bench_plain"] = counted(
        "bench --plain", lambda: bench.run(plain=True, reps=2, scene=scene))
    if launches["bench_plain"]:
        raise AssertionError(f"bench --plain launched {launches['bench_plain']}")
    for k in ("coord", "normal", "ncc"):
        if not bits_equal(getattr(kern, k), getattr(plain, k)):
            raise AssertionError(f"bench: the kernel path's {k} differs from the plain path's")
    log(f"[refine_tools] bench kernel path == plain path bit for bit (coord, normal, ncc); "
        f"{rec['ms']:.3f} ms a call ({res['value']:.1f} Msamples/s) against plain "
        f"{prec['ms']:.3f} ms ({prec['result']['value']:.1f})")
    recs["bench"], recs["bench_plain"] = rec, prec

    for luma, group, form in ((False, 1, "ungrouped"), (False, N_CANDS, "grouped"),
                              (True, N_CANDS, "luma_grouped")):
        tag = f"parts_{'luma' if luma else 'rgb'}_g{group}"
        prt, launches[tag] = counted(tag, lambda luma=luma, group=group: bench_refine_parts.run(
            batch=65536, luma=luma, group=group, scene=scene))
        need(tag, launches[tag], form)
        for name, p in prt["parts"].items():
            if not (np.isfinite(p["value"]) and p["ms"] > 0 and p["device_kernels"] > 0):
                raise AssertionError(f"{tag} {name}: {p}")
        log(f"[refine_tools] {tag} " + json.dumps(prt))
        recs[tag] = prt

    (arec, _, _), launches["ab_refine_chip"] = counted(
        "ab_refine_chip", lambda: ab_refine_chip.run(scene=scene))
    log("[refine_tools] ab_refine_chip " + json.dumps(arec))
    if not arec["grouped_equals_ungrouped_luma"]:
        raise AssertionError("ab_refine_chip: the grouped and ungrouped luma arms differ")
    need("ab_refine_chip", launches["ab_refine_chip"], "ungrouped", "grouped", "luma_grouped",
         "luma_ungrouped")
    for name, arm in arec["arms"].items():
        if not all(np.isfinite(v) for v in arm.values()) or arm["err_median"] > 0.05:
            raise AssertionError(f"ab_refine_chip {name}: {arm}")
    recs["ab_refine_chip"] = arec

    (lrec, _, _), launches["ab_luma"] = counted("ab_luma", lambda: ab_luma.run(device=dev))
    log("[refine_tools] ab_luma " + json.dumps(lrec))
    need("ab_luma", launches["ab_luma"], "ungrouped", "grouped", "luma_grouped")
    for tag, arms in lrec["scenes"].items():
        for name, arm in arms.items():
            if not all(np.isfinite(v) for v in arm.values()):
                raise AssertionError(f"ab_luma {tag} {name}: {arm}")
    recs["ab_luma"] = lrec

    plane = os.path.join(workdir, "plane16")
    with open(coverage_sweep.dataset_marker(plane, 16, 640, 480, 4096), "w") as f:
        f.write("ok\n")  # phase 3's dataset
    cov, launches["coverage_sweep"] = counted("coverage_sweep", lambda: coverage_sweep.run(
        plane, budgets=(16384,), rounds=(8,), policies=("cell_first",), iterations=1,
        device=dev, log=lambda *a: None))
    log("[refine_tools] coverage_sweep " + json.dumps(cov))
    need("coverage_sweep", launches["coverage_sweep"], "ungrouped", "grouped")
    run = cov["runs"][0]
    if not (run["final_alive"] > 0 and run["acc_median"] <= 0.05):
        raise AssertionError(f"coverage_sweep: {run}")
    recs["coverage_sweep"] = cov
    return recs, launches


def multihost_phase():
    """Phase 10: tools/multihost_ncc as two ranks on the card joined by
    gloo, then as one rank on nccl: view-sharded NCC and the polished
    refinement against the rank's single-process run. Every child has a
    timeout; one that fails, disagrees or hangs fails the phase. Returns
    the records."""
    import socket

    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    records = {}
    for backend, world in (("gloo", 2), ("nccl", 1)):
        s = socket.socket()
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
        s.close()
        with tempfile.TemporaryDirectory(prefix="mvskit_mh_") as td:
            outs = [os.path.join(td, f"rank{r}.json") for r in range(world)]
            procs = [subprocess.Popen(
                [sys.executable, "-m", "mvskit_tpu_torch.tools.multihost_ncc", str(r),
                 str(world), str(port), outs[r], "--backend", backend, "--device", "cuda",
                 "--local-shards", "2"],
                cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True) for r in range(world)]
            errs = []
            try:
                for p in procs:
                    _, se = p.communicate(timeout=300)
                    errs.append(se[-1500:])
            finally:
                for p in procs:
                    if p.poll() is None:
                        p.kill()
                        p.wait()
            if any(p.returncode != 0 for p in procs):
                raise AssertionError(f"multihost {backend}: rank failed: {errs}")
            recs = []
            for o in outs:
                with open(o) as f:
                    recs.append(json.load(f))
        for rec in recs:
            if not (rec["equal"] and rec["polish_equal"] and rec["polish_moved"] > 0
                    and rec["backend"] == backend and rec["launches"].get("ungrouped", 0) > 0
                    and rec["launches"].get("grad", 0) > 0):
                raise AssertionError(f"multihost {backend}: {rec}")
        log(f"[multihost] {backend} x {world}: " + json.dumps(recs))
        records[backend] = recs
    return records


# the backward kernel against its plain version: each output within
# GRAD_RTOL of the sum of its terms' magnitudes (cuda_ncc.grad_scale) of
# the plain version evaluated in float64 from the same float32 lattice;
# the float32 plain version, which forms each tap's product with the
# cotangent before subtracting (as JAX's autodiff does), strays a few
# 1e-5 of that scale by itself, so the kernel, which subtracts the taps
# first, is held to the float64 evaluation
GRAD_RTOL = 1e-5
# the library yardstick's backward (grid_sample's gradient in its grid,
# chained to tl, dx, dy) against the kernel, on windows whose every
# sample lies inside its level and at least LIBRARY_GRAD_MARGIN px from
# an integer (elsewhere the two take different taps or slopes): within
# LIBRARY_GRAD_RTOL of the same scale (the coordinates' normalise /
# unnormalise round trip moves a sample by about 1e-4 px)
LIBRARY_GRAD_RTOL = 1e-3
LIBRARY_GRAD_MARGIN = 1e-3
# polish steps and step size of the polished path (GRADPOLISH.json's arms)
GRAD_STEPS, GRAD_LR = 4, 0.5
# the polished RGB path's quality bar: the round's acc_mean and comp_frac
POLISH_LIMITS = (ACC_MEAN_BAR, 0.99)


def grad_check(scene, args, mode, seed, wsize=WSIZE):
    """The backward kernel on one window set: two launches bit for bit,
    against the float64 plain version within GRAD_RTOL, with its NaN
    pattern (and the float32 plain version's NaN pattern and distance
    beside). Returns (record, cotangent, kernel gradients, scale)."""
    import torch

    from mvskit_tpu_torch.ops import cuda_ncc
    from mvskit_tpu_torch.tools.bench_kernel import bits_equal

    luma = mode == "luma"
    idx = args[0]
    C = 1 if luma else 3
    gen = torch.Generator(device=idx.device).manual_seed(seed)
    cot = torch.randn((idx.shape[0], C * wsize * wsize), generator=gen, device=idx.device)
    got = cuda_ncc.sample_windows_grad(scene, *args, wsize, cot, luma=luma)
    again = cuda_ncc.sample_windows_grad(scene, *args, wsize, cot, luma=luma)
    torch.cuda.synchronize()
    f64 = torch.float64
    want = cuda_ncc.sample_windows_grad_plain(scene, *args, wsize, cot, luma=luma, dtype=f64)
    p32 = cuda_ncc.sample_windows_grad_plain(scene, *args, wsize, cot, luma=luma)
    scale = cuda_ncc.grad_scale(cuda_ncc.sample_grad_terms(
        scene, *args, wsize, cot, luma=luma, dtype=f64), wsize)
    rel = abs_err = rel32 = abs32 = 0.0
    nan_equal, nans = True, 0
    for g, a, w, p, sc in zip(got, again, want, p32, scale):
        if not bits_equal(g, a):
            raise AssertionError(f"backward {mode}: two launches differ")
        nan_equal &= all(torch.equal(torch.isnan(x), torch.isnan(w)) and
                         torch.equal(torch.isfinite(x), torch.isfinite(w)) for x in (g, p))
        nans += int(torch.isnan(w).sum())
        fin = torch.isfinite(w)
        if fin.any():
            d, d32 = (g.double() - w).abs()[fin], (p.double() - w).abs()[fin]
            rel = max(rel, (d / sc[fin]).max().item())
            rel32 = max(rel32, (d32 / sc[fin]).max().item())
            abs_err = max(abs_err, (g - p).abs()[fin].max().item())
            abs32 = max(abs32, d32.max().item())
    rec = {"windows": idx.shape[0], "max_rel_err_f64": rel, "max_abs_err": abs_err,
           "plain_f32_max_rel_err_f64": rel32, "plain_f32_max_abs_err_f64": abs32,
           "nan_outputs": nans, "nan_pattern_equal": nan_equal, "bitwise_repeat": True}
    if not (nan_equal and rel <= GRAD_RTOL):
        raise AssertionError(f"backward {mode}, wsize {wsize}: kernel differs from its plain "
                             f"version: {rec}")
    return rec, cot, got, scale


def library_grad(scene, args, mode, cot, got, scale):
    """The library yardstick of the backward: the gradient of one 5-D
    grid_sample call (tools/bench_kernel.library_windows) in its grid,
    timed alone as `ms` is (`library_ms`), and chained to tl, dx, dy,
    against the kernel on the windows where both take the same taps and
    slopes."""
    import torch

    from mvskit_tpu_torch.ops import cuda_ncc
    from mvskit_tpu_torch.tools import bench_kernel as bk

    idx, lvl, tl, dx, dy = args
    luma = mode == "luma"
    B, C, S = idx.shape[0], (1 if luma else 3), WSIZE * WSIZE
    vol = bk.level_volume(scene, luma)
    cot_lib = cot.reshape(B, C, S).permute(1, 0, 2).reshape(1, C, B, S, 1).contiguous()
    grid = bk.library_grid(scene, idx, lvl, tl, dx, dy, WSIZE, vol).detach().requires_grad_()
    out = bk.library_sample(vol, grid)
    library_ms = min(bk.cuda_time_ms(lambda: torch.autograd.grad(
        out, grid, cot_lib, retain_graph=True), 7) for _ in range(2))
    del out, grid
    leaves = [t.clone().requires_grad_() for t in (tl, dx, dy)]
    with torch.enable_grad():
        out = bk.library_sample(vol, bk.library_grid(scene, idx, lvl, *leaves, WSIZE, vol))
        lib = torch.autograd.grad(out, leaves, cot_lib)
    gx, gy = cuda_ncc.lattice(tl, dx, dy, WSIZE)
    lv = lvl.long().unsqueeze(1)
    w, h = scene.lvl_widths[lv].float(), scene.lvl_heights[lv].float()

    def clean(c, lim):
        frac = c - torch.floor(c)
        return ((c > 0) & (c < lim - 1) & (frac > LIBRARY_GRAD_MARGIN)
                & (frac < 1 - LIBRARY_GRAD_MARGIN)).all(1)

    ok = clean(gx, w) & clean(gy, h)
    err = max(((a - g).abs()[ok] / sc[ok]).max().item() for a, g, sc in zip(lib, got, scale))
    rec = {"library_ms": library_ms, "library_windows_compared": int(ok.sum()),
           "library_max_rel_err": err}
    if not (ok.sum() > B // 2 and err <= LIBRARY_GRAD_RTOL):
        raise AssertionError(f"backward {mode}: grid_sample's gradient differs: {rec}")
    return rec


def grad_kernel_phase(dev):
    """Phase 14 (kernel): the backward kernel on K1's window set (RGB,
    the gauntlet's 4,096 patches x 6 views) and K3u's (luma, the
    refinement candidates) with a seeded cotangent, and on the edge
    lattices at 7 x 7 and 5 x 5: two launches bit for bit, against the
    plain version (GRAD_RTOL), timed against its bound, the plain
    version and grid_sample's backward, with its launch plan and ptxas
    line. Returns {mode: record}."""
    import torch

    from mvskit_tpu_torch.ops import _build, cuda_ncc
    from mvskit_tpu_torch.tools import bench_kernel as bk

    _build.load_library()  # built before its ptxas report is read
    ptxas = _build.ptxas_report()
    scene, sets = window_sets(dev)
    card = card_line()
    records = {}
    for mode, wset in (("rgb", "ungrouped"), ("luma", "grouped")):
        args = tuple(sets[wset][:5])
        luma = mode == "luma"
        rec, cot, got, scale = grad_check(scene, args, mode, seed=14)
        touched = touched_pixels(scene, *args, mode)
        b_ms, b_by, nbytes, flops = bound(rec["windows"], mode, touched, grad=True)
        kern = lambda: cuda_ncc.sample_windows_grad(scene, *args, WSIZE, cot, luma=luma)  # noqa: E731
        plain = lambda: cuda_ncc.sample_windows_grad_plain(  # noqa: E731
            scene, *args, WSIZE, cot, luma=luma)
        ms, plain_ms = [], []
        for _ in range(2):
            ms.append(bk.cuda_time_ms(kern, 7))
            plain_ms.append(bk.cuda_time_ms(plain, 7))
        rec.update(touched_plane_words=touched, bytes=nbytes, flops=flops, bound_ms=b_ms,
                   bound_by=b_by, ms_runs=ms, plain_ms_runs=plain_ms, ms=min(ms),
                   plain_ms=min(plain_ms))
        rec["bound_share"] = b_ms / rec["ms"]
        rec["plan"] = cuda_ncc.grad_plan(rec["windows"], WSIZE, luma)
        rec["ptxas"] = ptxas.get(f"window_grad_kernel<{1 if luma else 3}, {WSIZE}>")
        rec.update(library_grad(scene, args, mode, cot, got, scale))
        edge = {}
        for wsize in (WSIZE, EDGE_WSIZE):
            e = grad_check(scene, bk.edge_windows(scene, 64 * N_CANDS, seed=wsize), mode,
                           wsize, wsize)[0]
            if e["nan_outputs"] <= 0:
                raise AssertionError(f"backward {mode}: the edge lattices gave no NaN")
            edge[str(wsize)] = {k: e[k] for k in ("windows", "max_rel_err_f64", "nan_outputs")}
        rec["edge_lattices"] = edge
        log(f"[polish] backward {mode} on {card}: " + json.dumps(rec))
        records[mode] = rec
        del cot, got, scale
        torch.cuda.empty_cache()
    bk._volume.cache_clear()
    return records


def polish_path(tag, dev, plane, **overrides):
    """engine_path with the polish recorded (utils/profiling.polish_stats):
    its summary gains the rows accepted per polish step and the polish's
    share of the refinement's device time. Returns (engine, summary)."""
    from mvskit_tpu_torch.utils import profiling

    with profiling.polish_stats() as stats:
        engine, *res = engine_path(tag, dev, plane, **overrides)
    summary = summarize(tag, *res)
    summary["polish"] = stats.as_dict()
    log(f"[{tag}] polish " + json.dumps(summary["polish"]))
    return engine, summary


def polish_phase(dev, workdir, rgb):
    """Phase 14 (path): PMMVS with refine_grad_steps=4 on phase 3's
    dataset at full width and depth (its quality against POLISH_LIMITS,
    its K1, K2 and backward launches, the rows each polish step
    accepted, the polish's share of refinement), then short runs (one
    iteration): luma with refine_rgb_tail 0 (the luma backward), and the
    meshes (1,2,1) and (2,1,1) with the polish, each equal to the
    unsharded polished run at that depth bit for bit. Returns {run:
    summary}."""
    import numpy as np
    import torch

    card0 = torch.device("cuda", 0)
    plane = os.path.join(workdir, "plane16")
    polish = dict(refine_grad_steps=GRAD_STEPS, refine_grad_lr=GRAD_LR)
    out = {}
    engine, out["rgb"] = polish_path("polish", dev, plane, **polish)
    short = dict(polish, n_iterations=1, scene=engine.scene)
    del engine
    r = out["rgb"]
    if not (r["launches"]["grad"] > 0 and r["launches"]["ungrouped"] > 0
            and r["launches"]["grouped"] > 0):
        raise AssertionError(f"polished path missed a kernel: {r['launches']}")
    if not (len(r["alive_per_iter"]) == 3 and min(r["polish"]["accepted"]) > 0):
        raise AssertionError(f"polished path: {r['alive_per_iter']}, {r['polish']}")
    check_quality("polish", r["quality"], POLISH_LIMITS)
    log(f"[polish] wall {r['wall_s']:.3f} s vs RGB {rgb['wall_s']:.3f} s (cli.main); "
        f"launches K1 {r['launches']['ungrouped']} K2 {r['launches']['grouped']} backward "
        f"{r['launches']['grad']} vs RGB K1 {rgb['launches']['ungrouped']} K2 "
        f"{rgb['launches']['grouped']}")
    _, out["luma"] = polish_path("polish_luma", dev, plane, luma_refine=True,
                                 refine_rgb_tail=0, **short)
    if out["luma"]["launches"]["luma_grad"] <= 0:
        raise AssertionError(f"luma polish missed its backward: {out['luma']['launches']}")
    engine, out["1x1x1"] = polish_path("polish_1x1x1", dev, plane, **short)
    base = engine.collect()
    del engine
    for dp, view, tile in ((1, 2, 1), (2, 1, 1)):
        name = f"{dp}x{view}x{tile}"
        engine, summary = polish_path(f"polish_{name}", dev, plane,
                                      mesh_devices=[card0] * (dp * view * tile), mesh_dp=dp,
                                      mesh_view=view, mesh_tile=tile, **short)
        got = engine.collect()
        del engine
        out[name] = summary
        if summary["alive_per_iter"] != out["1x1x1"]["alive_per_iter"]:
            raise AssertionError(f"polished mesh {name}: alive {summary['alive_per_iter']} "
                                 f"vs {out['1x1x1']['alive_per_iter']}")
        for k in ("coord", "normal", "ncc", "images"):
            if not np.array_equal(got[k], base[k]):
                raise AssertionError(f"polished mesh {name}: cloud {k} differs from the "
                                     f"unsharded run")
        if summary["launches"]["grad"] <= 0:
            raise AssertionError(f"polished mesh {name} launched no backward")
        log(f"[polish_{name}] cloud and alive counts equal to the unsharded polished run "
            f"bit for bit")
    return out


def check_paths(paths):
    """The path checks of the card run: launches of each kernel on its
    path, the illumination count, quality limits, accepted hypotheses of
    every pmvs iteration."""
    rgb, luma, lu, il3, pmvs = (paths[k] for k in (
        "rgb", "luma", "luma_ungrouped", "illum3", "pmvs"))
    if not (rgb["launches"]["ungrouped"] > 0 and rgb["launches"]["grouped"] > 0):
        raise AssertionError(f"RGB main path missed a kernel: {rgb['launches']}")
    if not (luma["launches"]["luma_grouped"] > 0 and luma["launches"]["grouped"] > 0):
        raise AssertionError(f"luma path missed a kernel: {luma['launches']}")
    if lu["launches"]["luma_ungrouped"] <= 0:
        raise AssertionError(f"ungrouped luma run missed its kernel: {lu['launches']}")
    if il3["n_illums"] != 3:
        raise AssertionError(f"illum-3 path ran with n_illums {il3['n_illums']}")
    if not (il3["launches"]["ungrouped"] > 0 and il3["launches"]["grouped"] > 0):
        raise AssertionError(f"illum-3 path missed a kernel: {il3['launches']}")
    if not (pmvs["launches"]["ungrouped"] > 0 and pmvs["launches"]["grouped"] > 0):
        raise AssertionError(f"pmvs path missed a kernel: {pmvs['launches']}")
    if not (len(pmvs["accepted_per_iter"]) == 3 and min(pmvs["accepted_per_iter"]) > 0):
        raise AssertionError(f"pmvs accepted no hypothesis in an iteration: "
                             f"{pmvs['accepted_per_iter']}")
    # no completeness limit: pmvs expands an order of magnitude less by
    # design (STRATEGY_AB.json); its comp_frac is recorded
    check_quality("pmvs", pmvs["quality"], (LIMITS["rgb"][0], 0.0))
    check_quality("main", rgb["quality"], LIMITS["rgb"])
    log(f"[main] round bar acc_mean {ACC_MEAN_BAR} (E2E_r05.json): "
        f"{'met' if rgb['quality']['acc_mean'] <= ACC_MEAN_BAR else 'missed'}")
    check_quality("luma", luma["quality"], LIMITS["luma"])
    check_quality("illum3", il3["quality"], LIMITS["illum3"])
    # both from the driver's stage timer; the two runs enter differently
    # (luma: PMMVS without snapshots; RGB: cli.main, whose snapshots are
    # written by a thread during the stages)
    log(f"[luma] propagation stages {luma['propagate_s']:.3f} s (PMMVS) vs RGB "
        f"{rgb['propagate_s']:.3f} s (cli.main), luma / RGB = "
        f"{luma['propagate_s'] / max(rgb['propagate_s'], 1e-9):.3f}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke needs CUDA: torch.cuda.is_available() is False")
    sys.path.insert(0, REPO)
    from mvskit_tpu_torch import get_device
    from mvskit_tpu_torch.ops import _build, cuda_ncc

    dev = get_device("cuda")
    card = card_line()
    log(card)
    log(f"[device] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")

    t0 = time.time()
    lib = _build.build()
    _build.load_library()
    log(f"[build] {lib} in {time.time() - t0:.2f} s")
    build_report()

    t0 = time.time()
    records = kernel_phase(dev)
    log(f"[kernel] phase {time.time() - t0:.2f} s")
    with tempfile.TemporaryDirectory(prefix="mvskit_smoke_") as work:
        paths = paths_phase(dev, work)
        t0 = time.time()
        grad_records = grad_kernel_phase(dev)
        polish = polish_phase(dev, work, paths["rgb"])
        log(f"[polish] phase {time.time() - t0:.2f} s")
        t0 = time.time()
        bench_tools_phase(dev, work)
        log(f"[benches] phase {time.time() - t0:.2f} s")
        t0 = time.time()
        surface_phase(dev, work)
        log(f"[surface] phase {time.time() - t0:.2f} s")
        t0 = time.time()
        bench, bench_launches = bench_phase(dev)
        log(f"[bench] phase {time.time() - t0:.2f} s")
        paths["pmvs"] = pmvs_phase(dev, work)
        t0 = time.time()
        meshes = mesh_phase(dev, work, paths["rgb"])
        log(f"[mesh] phase {time.time() - t0:.2f} s")
        check_paths(paths)
        t0 = time.time()
        multihost_phase()
        log(f"[multihost] phase {time.time() - t0:.2f} s")
        t0 = time.time()
        k1_batches = path_batch_phase(dev, paths["rgb"]["batches"]["ungrouped"])
        log(f"[batches] phase {time.time() - t0:.2f} s")
        t0 = time.time()
        _, tool_launches = refine_tools_phase(dev, work)
        log(f"[refine_tools] phase {time.time() - t0:.2f} s")
    for form in ("fused", "luma_fused", *(f"ablate_{a}" for a in cuda_ncc.ABLATIONS[1:])):
        if bench_launches[form] <= 0:
            raise AssertionError(f"bench path missed {form}: {bench_launches}")

    path_of = {"ungrouped": "rgb", "grouped": "rgb", "luma_grouped": "luma",
               "luma_ungrouped": "luma_ungrouped"}
    kernels = []
    for name, form, _, _, _, fused in KERNELS:
        r = records[name]
        entry = {
            "name": name, "route": "cuda", "source": KERNEL_SOURCE,
            "replaces": REPLACES_FUSED if fused else REPLACES,
            "launches": bench_launches[form] if fused else paths[path_of[form]]["launches"][form],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "library_call_ms": r["library_call_ms"],
            "library_max_abs_err": r["library_max_abs_err"],
            "library_volume_bytes": r["library_volume_bytes"],
        }
        if "plan" in r:  # every form: K1, K2, K3u, K3g and K4
            entry.update(windows=r["windows"], bound_share=r["bound_share"], plan=r["plan"],
                         ptxas=r["ptxas"])
        if fused:  # K4: beside the grouped launch, and on the edge lattices
            entry.update(grouped_ms_same_windows=r["grouped_ms_same_windows"],
                         edge_lattices=r["edge_lattices"])
        if "fused_ms_same_windows" in r:  # K2 and K3g
            entry["fused_ms_same_windows"] = r["fused_ms_same_windows"]
        if "bitwise_equal_grouped" in r and not fused:  # K1 and K3u
            entry.update(bitwise_equal_grouped=r["bitwise_equal_grouped"],
                         floor_ms=r["floor_ms"])
        if form == "ungrouped":
            entry["path_batches"] = k1_batches
        if form in ("ungrouped", "grouped"):  # per view shard on the mesh paths
            entry["mesh_launches"] = {
                name: {"total": m["launches"][form], "per_view_shard": {
                    k.split("/")[0]: v["launches"]
                    for k, v in m["view_shards"]["calls"].items() if k.endswith("/" + form)}}
                for name, m in meshes.items()}
        if form == "ungrouped":  # per dp shard from hypothesis scoring
            for name, m in meshes.items():
                entry["mesh_launches"][name]["hypotheses_per_dp_shard"] = m["dp"]["k1"]
        if not fused:  # K1, K2, K3u, K3g in phase 12's runs
            entry["refine_tools_launches"] = {tool: n[form] for tool, n in tool_launches.items()
                                              if n.get(form)}
        if "gauntlet_windows" in r:  # K3u
            entry["gauntlet_windows"] = {k: r["gauntlet_windows"][k] for k in (
                "windows", "ms", "bound_ms", "plan", "floor_ms")}
        kernels.append(entry)
    # one entry per ablation switch: its grouped RGB run on the bench
    # path, with the grouped luma run beside it
    for rec in bench:
        if not rec["ablate"]:
            continue
        rgb, luma = rec["rgb"], rec["luma"]
        kernels.append({
            "name": f"sample_windows_ablate_{rec['ablate']}", "route": "cuda",
            "source": KERNEL_SOURCE, "replaces": REPLACES_ABLATE,
            "launches": bench_launches[f"ablate_{rec['ablate']}"],
            "max_abs_err": max(rgb["max_abs_err"], luma["max_abs_err"]),
            "ms": rgb["ms"], "plain_ms": rgb["plain_ms"], "bound_ms": rgb["bound_ms"],
            "bound_by": rgb["bound_by"], "library_ms": None, "windows": rec["windows"],
            "group": rec["group"], "luma_ms": luma["ms"], "luma_plain_ms": luma["plain_ms"],
            "luma_bound_ms": luma["bound_ms"],
        })
    # the backward kernel: launches on the polished RGB path (luma: the
    # short luma run), and per mesh of phase 14's short runs
    for mode, key, run in (("rgb", "grad", "rgb"), ("luma", "luma_grad", "luma")):
        r = grad_records[mode]
        kernels.append({
            "name": f"sample_windows_{'luma_' if mode == 'luma' else ''}grad", "route": "cuda",
            "source": GRAD_SOURCE, "replaces": REPLACES_GRAD,
            "launches": polish[run]["launches"][key], "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"], "windows": r["windows"],
            "bound_share": r["bound_share"], "plan": r["plan"], "ptxas": r["ptxas"],
            "max_rel_err_f64": r["max_rel_err_f64"],
            "plain_f32_max_rel_err_f64": r["plain_f32_max_rel_err_f64"],
            "library_max_rel_err": r["library_max_rel_err"],
            "edge_lattices": r["edge_lattices"],
            "mesh_launches": {name: polish[name]["launches"][key]
                              for name in ("1x1x1", "1x2x1", "2x1x1")} if mode == "rgb" else None,
        })
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
