"""Tests of the port that need an NVIDIA card (marker `cuda`); each
skips where torch.cuda is unavailable. The file imports no jax, so on
the card's machine, which has none, it runs without the repository's
conftest:

    python -m pytest --noconftest -q -p no:cacheprovider tests/test_torch_cuda.py

Tolerances: every launch form equals its plain version bit for bit
(the same arithmetic, each operation rounded alone), as chip_smoke.py
requires: ungrouped (K1 RGB, K3u luma) and grouped (K2, K3g), all four
the persistent window kernel, at the compiled window size 7 and the
run-time size instance, at every batch size (a ragged last tile
included) and illumination; fused (K4, its own persistent kernel) equals
the plain version and the grouped launch bit for bit at every window size
and group, and on edge lattices (NaN, +-inf, negative coordinates, ones
on integers and past w - 2) in every switch; every ablation switch (K5)
in every launch form equals its plain version bit for bit.
The view-sharded sampler on k shards of the card (each launching the
batch's form on its compacted windows) equals the unsharded launch bit
for bit; a mesh of more cards than there are raises. refine_batch
through the kernels equals it through the plain versions
(``use_pallas=False``) bit for bit.
The pipeline on the card against the same pipeline on the CPU, fed the
same random numbers: alive counts within 3 % (reductions sum in another
order on the card, which can flip a near-tie accept/reject).
The sampler's backward kernel (csrc/sample_windows_grad.cu) against its
plain version (autograd through the gather path) evaluated in float64
from the same float32 lattice: within 1e-5 of each output's sum of term
magnitudes (``cuda_ncc.grad_scale``; the float32 plain version, which
forms each tap's product with the cotangent before subtracting, strays
up to a few 1e-5 of it by itself), the same NaN pattern (float32 plain
version too), and two launches bit for bit, at 7 x 7 and the run-time
sizes 5, 9, 15, at batches of 1, 3, 5, one tile + 1 and 786,432
windows, and with grad_out or tl at an address 4 bytes past a 16-byte
boundary; the polished refinement through it tracks the plain path
within the refinement tolerance (coord 1e-4 on >= 99 % of rows), and
equals itself on view shards of the card bit for bit.
The span recorder (utils/profiling.py) on the card: each synchronizing
operation of a propagation round (depth-2 check included, its gauntlet
chunks replayed from CUDA graphs) and of a filter pass, as the CUDA sync
debug mode reports them, is one sync span of the recorder, and none
more; a 50 ms host sleep between two kernels inside a span puts that
idle gap in that span within 5 ms.
The gauntlet's CUDA graphs (pipeline/propagate.py ``_GauntletGraphs``):
a round's chunks replayed from the graph captured on its first chunk
equal the same chunks run op by op at the same padded shape, bit for
bit in every output, on RGB, luma (rgb_tail 2) and 2-illumination
search with the depth-2 check off and on, and again on the next round's
table and grid without a new capture; the sampler's launch counters
read the same, each replay crediting its capture's counts."""

import numpy as np
import pytest
import torch

from mvskit_tpu_torch.utils import profiling

pytestmark = pytest.mark.cuda

WSIZE, LEVEL = 7, 1


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")
    from mvskit_tpu_torch import get_device

    return get_device("cuda")


def _no_launches():
    from mvskit_tpu_torch.ops import cuda_ncc

    return {k: 0 for k in cuda_ncc.LAUNCHES}


def _windows(scene, n_patch=64, n_cands=32, wsize=WSIZE):
    from mvskit_tpu_torch.geometry import camera as cam
    from mvskit_tpu_torch.ops import ncc
    from mvskit_tpu_torch.utils import synthetic

    Ps = synthetic.ring_cameras(6, 160, 120)
    coord, normal = synthetic.plane_points(Ps, n_patch, seed=3, extent=0.6)
    rng = np.random.default_rng(0)
    coord = np.repeat(coord, n_cands, 0)
    coord[:, 2] += rng.uniform(-0.02, 0.02, coord.shape[0])
    dev = scene.device
    c = torch.as_tensor(coord, dtype=torch.float32, device=dev)
    n = torch.as_tensor(np.repeat(normal, n_cands, 0), dtype=torch.float32, device=dev)
    views = torch.tensor([[0, 1, 2]], dtype=torch.int32, device=dev).expand(c.shape[0], 3)
    px, py = cam.get_paxes(scene.cams, views[:, 0].long(), c, n, LEVEL)
    tl, dx, dy, lvl, valid = ncc.window_geometry_views(
        scene, views.T.contiguous(), c, px, py, n, LEVEL, wsize, 1.0471976)
    flat = lambda x, k=(): x.reshape((-1,) + k).contiguous()  # noqa: E731
    return (flat(views.T.contiguous()), flat(lvl.to(torch.int32)), flat(tl, (2,)),
            flat(dx, (2,)), flat(dy, (2,)))


def test_kernel_forms_match_plain(card):
    from mvskit_tpu_torch.ops import cuda_ncc
    from mvskit_tpu_torch.utils import synthetic

    _, _, scene = synthetic.plane_scene(n_views=6, width=160, height=120, device=card)
    args = _windows(scene)
    profiling.COUNTERS.reset()
    ung, fit = cuda_ncc.sample_windows(scene, *args, WSIZE, group=1)
    grp, _ = cuda_ncc.sample_windows(scene, *args, WSIZE, group=32)
    odd, _ = cuda_ncc.sample_windows(scene, *(a[:-1] for a in args), WSIZE, group=32)
    torch.cuda.synchronize()
    plain = cuda_ncc.sample_windows_plain(scene, *args, WSIZE)
    assert cuda_ncc.LAUNCHES == dict(_no_launches(), ungrouped=2, grouped=1)
    assert fit.all()
    assert torch.equal(_bits(ung), _bits(plain))
    assert torch.equal(ung.view(torch.int32), grp.view(torch.int32))
    assert torch.equal(odd.view(torch.int32), ung[:-1].view(torch.int32))


def _bits(x):
    return x.contiguous().view(torch.int32)


def test_luma_kernel_forms_match_plain_bitwise(card):
    from mvskit_tpu_torch.ops import cuda_ncc
    from mvskit_tpu_torch.utils import synthetic

    _, _, scene = synthetic.plane_scene(n_views=6, width=160, height=120, device=card)
    args = _windows(scene)
    profiling.COUNTERS.reset()
    ung, fit = cuda_ncc.sample_windows(scene, *args, WSIZE, group=1, luma=True)
    grp, _ = cuda_ncc.sample_windows(scene, *args, WSIZE, group=32, luma=True)
    odd, _ = cuda_ncc.sample_windows(scene, *(a[:-1] for a in args), WSIZE, group=32,
                                     luma=True)
    torch.cuda.synchronize()
    plain = cuda_ncc.sample_windows_luma_plain(scene, *args, WSIZE)
    assert cuda_ncc.LAUNCHES == dict(_no_launches(), luma_ungrouped=2, luma_grouped=1)
    assert fit.all() and ung.shape == (args[0].shape[0], WSIZE * WSIZE)
    assert torch.equal(_bits(ung), _bits(plain))
    assert torch.equal(_bits(grp), _bits(ung))
    assert torch.equal(_bits(odd), _bits(ung[:-1]))


def test_fused_forms_match_grouped_and_plain_bitwise(card):
    """K4 in both channel modes at group 2 (float stores), 32 and 128
    (75 KB a stage for RGB); a group whose one stage passes the block's
    shared-memory limit raises."""
    from mvskit_tpu_torch.ops import cuda_ncc
    from mvskit_tpu_torch.utils import synthetic

    _, _, scene = synthetic.plane_scene(n_views=6, width=160, height=120, device=card)
    args = _windows(scene)
    for luma, plain_fn in ((False, cuda_ncc.sample_windows_plain),
                           (True, cuda_ncc.sample_windows_luma_plain)):
        profiling.COUNTERS.reset()
        ung, _ = cuda_ncc.sample_windows(scene, *args, WSIZE, luma=luma)
        for group in (2, 32, 128):
            fused, fit = cuda_ncc.sample_windows(scene, *args, WSIZE, group=group,
                                                 luma=luma, fused=True)
            torch.cuda.synchronize()
            assert fit.all() and torch.equal(_bits(fused), _bits(ung)), (luma, group)
        plain = plain_fn(scene, *args, WSIZE)
        assert torch.equal(_bits(ung), _bits(plain))
        form = "luma_fused" if luma else "fused"
        assert cuda_ncc.LAUNCHES == dict(_no_launches(), **{
            form: 3, ("luma_ungrouped" if luma else "ungrouped"): 1})
    # 15 x 15 RGB windows at group 128: 345,600 B of outputs per block
    with pytest.raises(RuntimeError, match="fused"):
        cuda_ncc.sample_windows(scene, *args, 15, group=128, fused=True)


def test_ablation_switches_match_plain_bitwise(card):
    """K5: every switch in every launch form and channel mode equals its
    plain version bit for bit (the grouped form also in its run-time
    window size instance, at 5 x 5); norot equals the normal output."""
    from mvskit_tpu_torch.ops import cuda_ncc
    from mvskit_tpu_torch.utils import synthetic

    _, _, scene = synthetic.plane_scene(n_views=6, width=160, height=120, device=card)
    cases = ((WSIZE, ((1, False), (32, False), (32, True))), (5, ((32, False),)))
    profiling.COUNTERS.reset()
    for wsize, forms in cases:
        args = _windows(scene, n_patch=16, wsize=wsize)
        for ablate in cuda_ncc.ABLATIONS[1:]:
            for luma, plain_fn in ((False, cuda_ncc.sample_windows_plain),
                                   (True, cuda_ncc.sample_windows_luma_plain)):
                plain = plain_fn(scene, *args, wsize, ablate=ablate)
                for group, fused in forms:
                    out, _ = cuda_ncc.sample_windows(scene, *args, wsize, group=group,
                                                     luma=luma, fused=fused, ablate=ablate)
                    torch.cuda.synchronize()
                    assert torch.equal(_bits(out), _bits(plain)), (
                        wsize, ablate, luma, group, fused)
    assert cuda_ncc.LAUNCHES == dict(_no_launches(), **{
        f"ablate_{a}": 8 for a in cuda_ncc.ABLATIONS[1:]})
    args = _windows(scene, n_patch=16)
    normal, _ = cuda_ncc.sample_windows(scene, *args, WSIZE, group=32)
    norot, _ = cuda_ncc.sample_windows(scene, *args, WSIZE, group=32, ablate="norot")
    assert torch.equal(_bits(norot), _bits(normal))
    with pytest.raises(ValueError, match="ablate"):
        cuda_ncc.sample_windows(scene, *args, WSIZE, ablate="noflop")


@pytest.mark.parametrize("luma", [False, True])
def test_grouped_form_every_size_and_group_bitwise(card, luma):
    """K2 (RGB) / K3g (luma), the persistent grouped kernel, at wsize 5, 7
    (the compiled-size instance), 9 and 15 (the run-time size instance)
    and group 2, 4, 32 and 128: bit-equal to the plain version and to the
    ungrouped launch. Group 2 at 7 x 7 (392 B luma, 1,176 B RGB per
    group) leaves by float stores, the others by TMA bulk store; where two
    output stages pass the H100's 232,448 B per block (RGB group 128 at
    9 x 9, luma group 128 at 15 x 15) the kernel runs one. RGB group 128
    at 15 x 15 (345,600 B for one stage) is refused by the card, and the
    wrapper raises."""
    from mvskit_tpu_torch.ops import cuda_ncc
    from mvskit_tpu_torch.utils import synthetic

    _, _, scene = synthetic.plane_scene(n_views=6, width=160, height=120, device=card)
    plain_fn = cuda_ncc.sample_windows_luma_plain if luma else cuda_ncc.sample_windows_plain
    form = "luma_grouped" if luma else "grouped"
    profiling.COUNTERS.reset()
    grouped = 0
    for wsize in (5, 7, 9, 15):
        args = _windows(scene, wsize=wsize)
        B = args[0].shape[0]
        ung, _ = cuda_ncc.sample_windows(scene, *args, wsize, luma=luma)
        plain = plain_fn(scene, *args, wsize)
        torch.cuda.synchronize()
        assert torch.equal(_bits(ung), _bits(plain)), wsize
        for group in (2, 4, 32, 128):
            if not luma and (wsize, group) == (15, 128):
                with pytest.raises(RuntimeError, match="grouped"):
                    cuda_ncc.grouped_plan(B, wsize, group, luma)
                with pytest.raises(RuntimeError, match="grouped"):
                    cuda_ncc.sample_windows(scene, *args, wsize, group=group, luma=luma)
                continue
            plan = cuda_ncc.grouped_plan(B, wsize, group, luma)
            out, _ = cuda_ncc.sample_windows(scene, *args, wsize, group=group, luma=luma)
            torch.cuda.synchronize()
            grouped += 1
            assert torch.equal(_bits(out), _bits(ung)), (wsize, group, plan)
            run_bytes = group * wsize * wsize * (1 if luma else 3) * 4
            assert plan["tma_store"] == (run_bytes % 16 == 0), plan
            single = (wsize, group) == ((15, 128) if luma else (9, 128))
            assert plan["stages"] == (1 if single else 2), (wsize, group, plan)
            assert 1 <= plan["grid"] <= B // group
    assert cuda_ncc.LAUNCHES == dict(_no_launches(), **{
        form: grouped, ("luma_ungrouped" if luma else "ungrouped"): 4})


@pytest.mark.parametrize("luma", [False, True])
def test_grouped_form_walks_many_groups_per_block(card, luma):
    """786,432 windows in groups of 32 (the main path's refinement batch)
    at 7 x 7 and 5 x 5: at least 8 groups per persistent block, so every
    block walks both parameter buffers and both output stages many
    times; bit-equal to the ungrouped launch and the plain version."""
    from mvskit_tpu_torch.ops import cuda_ncc
    from mvskit_tpu_torch.utils import synthetic

    _, _, scene = synthetic.plane_scene(n_views=6, width=160, height=120, device=card)
    plain_fn = cuda_ncc.sample_windows_luma_plain if luma else cuda_ncc.sample_windows_plain
    for wsize in (WSIZE, 5):
        args = _windows(scene, n_patch=8192, wsize=wsize)
        B = args[0].shape[0]
        plan = cuda_ncc.grouped_plan(B, wsize, 32, luma)
        assert B // 32 >= 8 * plan["grid"], plan
        assert plan["tma_store"] and plan["stages"] == 2, plan
        out, _ = cuda_ncc.sample_windows(scene, *args, wsize, group=32, luma=luma)
        ung, _ = cuda_ncc.sample_windows(scene, *args, wsize, luma=luma)
        plain = plain_fn(scene, *args, wsize)
        torch.cuda.synchronize()
        assert torch.equal(_bits(out), _bits(ung)), wsize
        assert torch.equal(_bits(ung), _bits(plain)), wsize


@pytest.mark.parametrize("luma", [False, True])
def test_fused_form_every_size_and_group_bitwise(card, luma):
    """K4 (RGB / luma), the persistent fused kernel with one thread per
    lattice row, at wsize 5, 7 (the compiled-size instance), 9 and 15 (the
    run-time size instance) and group 2, 4, 32 and 128: bit-equal to the
    plain version and to the grouped launch. Group 2 at 7 x 7 (392 B luma
    per group) leaves by float stores, the others by TMA bulk store; where
    two output stages pass the H100's 232,448 B per block (RGB group 128
    at 9 x 9, luma group 128 at 15 x 15) it runs one. RGB group 128 at
    15 x 15 (345,600 B for one stage) is refused, and the wrapper
    raises."""
    from mvskit_tpu_torch.ops import cuda_ncc
    from mvskit_tpu_torch.utils import synthetic

    _, _, scene = synthetic.plane_scene(n_views=6, width=160, height=120, device=card)
    form = "luma_fused" if luma else "fused"
    profiling.COUNTERS.reset()
    fused = 0
    for wsize in (5, 7, 9, 15):
        args = _windows(scene, wsize=wsize)
        B = args[0].shape[0]
        plain = _plain_fn(luma)(scene, *args, wsize)
        for group in (2, 4, 32, 128):
            if not luma and (wsize, group) == (15, 128):
                with pytest.raises(RuntimeError, match="fused"):
                    cuda_ncc.fused_plan(B, wsize, group, luma)
                with pytest.raises(RuntimeError, match="fused"):
                    cuda_ncc.sample_windows(scene, *args, wsize, group=group, luma=luma,
                                            fused=True)
                continue
            plan = cuda_ncc.fused_plan(B, wsize, group, luma)
            out, fit = cuda_ncc.sample_windows(scene, *args, wsize, group=group, luma=luma,
                                               fused=True)
            grp, _ = cuda_ncc.sample_windows(scene, *args, wsize, group=group, luma=luma)
            torch.cuda.synchronize()
            fused += 1
            assert fit.all() and torch.equal(_bits(out), _bits(plain)), (wsize, group, plan)
            assert torch.equal(_bits(out), _bits(grp)), (wsize, group, plan)
            run_bytes = group * wsize * wsize * (1 if luma else 3) * 4
            assert plan["tma_store"] == (run_bytes % 16 == 0), plan
            single = (wsize, group) == ((15, 128) if luma else (9, 128))
            assert plan["stages"] == (1 if single else 2), (wsize, group, plan)
            assert 1 <= plan["grid"] <= B // group and plan["tile"] == group, plan
            assert plan["threads"] % 32 == 0 and 32 <= plan["threads"] <= 256, plan
    assert cuda_ncc.LAUNCHES == dict(_no_launches(), **{
        form: fused, ("luma_grouped" if luma else "grouped"): fused})


@pytest.mark.parametrize("luma", [False, True])
def test_fused_form_walks_many_groups_per_block(card, luma):
    """K4 on 786,432 windows in groups of 32 (the refinement batch) at
    7 x 7 and 5 x 5: at least 8 groups per persistent block, so every
    block walks both parameter buffers and both output stages many times;
    bit-equal to the grouped launch and the plain version."""
    from mvskit_tpu_torch.ops import cuda_ncc
    from mvskit_tpu_torch.utils import synthetic

    _, _, scene = synthetic.plane_scene(n_views=6, width=160, height=120, device=card)
    for wsize in (WSIZE, 5):
        args = _windows(scene, n_patch=8192, wsize=wsize)
        B = args[0].shape[0]
        plan = cuda_ncc.fused_plan(B, wsize, 32, luma)
        assert B // 32 >= 8 * plan["grid"], plan
        assert plan["tma_store"] and plan["stages"] == 2, plan
        out, _ = cuda_ncc.sample_windows(scene, *args, wsize, group=32, luma=luma, fused=True)
        grp, _ = cuda_ncc.sample_windows(scene, *args, wsize, group=32, luma=luma)
        plain = _plain_fn(luma)(scene, *args, wsize)
        torch.cuda.synchronize()
        assert torch.equal(_bits(out), _bits(grp)), wsize
        assert torch.equal(_bits(out), _bits(plain)), wsize


def test_edge_lattices_every_form_and_switch_bitwise(card):
    """Edge lattices (tools/bench_kernel.edge_windows: NaN, +-inf, -0.0,
    negative coordinates, ones on integers, on w - 2 and past it, one ulp
    below integers, denormal, past int32) through K4 in both channel
    modes, at 7 x 7 (compiled) and 5 x 5 (run-time size), in groups of 2,
    32 and 128 and under every K5 switch, and through the window kernel's
    ungrouped and grouped launches: each bit-equal to its plain
    version."""
    from mvskit_tpu_torch.ops import cuda_ncc
    from mvskit_tpu_torch.tools import bench_kernel
    from mvskit_tpu_torch.utils import synthetic

    _, _, scene = synthetic.plane_scene(n_views=6, width=160, height=120, device=card)
    args = bench_kernel.edge_windows(scene, 2048)
    profiling.COUNTERS.reset()
    for wsize in (WSIZE, 5):
        for luma in (False, True):
            for ablate in cuda_ncc.ABLATIONS:
                plain = _plain_fn(luma)(scene, *args, wsize, ablate=ablate)
                runs = [(32, True), (1, False), (32, False)]
                if not ablate:
                    runs += [(2, True), (128, True)]
                for group, fused in runs:
                    out, _ = cuda_ncc.sample_windows(scene, *args, wsize, group=group,
                                                     luma=luma, fused=fused, ablate=ablate)
                    torch.cuda.synchronize()
                    assert torch.equal(_bits(out), _bits(plain)), (
                        wsize, luma, ablate, group, fused)
    assert cuda_ncc.LAUNCHES["fused"] == cuda_ncc.LAUNCHES["luma_fused"] == 2 * 3
    assert all(cuda_ncc.LAUNCHES[f"ablate_{a}"] == 2 * 2 * 3
               for a in cuda_ncc.ABLATIONS[1:])


def test_kernels_read_the_asked_illumination(card):
    """On a 3-illumination scene, illum = 2 reads illumination 2's
    planes: equal to the plain version at illum 2, different from
    illum 0, in both the RGB and the luma forms."""
    from mvskit_tpu_torch.ops import cuda_ncc
    from mvskit_tpu_torch.utils import synthetic

    _, _, scene = synthetic.sphere_scene(n_views=6, width=160, height=120, nillums=3,
                                         device=card)
    args = _windows(scene)
    for luma, plain_fn in ((False, cuda_ncc.sample_windows_plain),
                           (True, cuda_ncc.sample_windows_luma_plain)):
        outs = {}
        for il in (0, 2):
            for group in (1, 32):
                outs[il, group], _ = cuda_ncc.sample_windows(
                    scene, *args, WSIZE, illum=il, group=group, luma=luma)
        torch.cuda.synchronize()
        p2 = plain_fn(scene, *args, WSIZE, illum=2)
        assert torch.equal(_bits(outs[2, 1]), _bits(p2))
        assert torch.equal(_bits(outs[2, 32]), _bits(outs[2, 1]))
        assert (outs[2, 1] - outs[0, 1]).abs().max().item() > 1.0
    with pytest.raises(ValueError):
        cuda_ncc.sample_windows(scene, *args, WSIZE, illum=3)


def _plain_fn(luma):
    from mvskit_tpu_torch.ops import cuda_ncc

    return cuda_ncc.sample_windows_luma_plain if luma else cuda_ncc.sample_windows_plain


@pytest.mark.parametrize("luma", [False, True])
@pytest.mark.parametrize("wsize", [5, 7, 9, 15])
def test_ungrouped_form_every_batch_bitwise(card, wsize, luma):
    """K1 (RGB) / K3u (luma), the persistent window kernel over tiles of
    independent windows, at B = 1, 3, the plan's tile - 1, tile and
    tile + 1 and the gauntlet's 24,576 windows: bit-equal to the plain
    version and to the grouped launch over the same windows (the first
    B of a batch of whole groups of 32). Every plan stays within the
    card's limits, takes one output stage and the same tile whatever B,
    and at least one batch leaves a ragged last tile."""
    from mvskit_tpu_torch.ops import cuda_ncc
    from mvskit_tpu_torch.utils import synthetic

    _, _, scene = synthetic.plane_scene(n_views=6, width=160, height=120, device=card)
    args = _windows(scene, n_patch=256, wsize=wsize)  # 256 x 32 x 3 = 24,576
    full = args[0].shape[0]
    grp, _ = cuda_ncc.sample_windows(scene, *args, wsize, group=32, luma=luma)
    tile = cuda_ncc.ungrouped_plan(full, wsize, luma)["tile"]
    ragged = 0
    profiling.COUNTERS.reset()
    for B in sorted({1, 3, tile - 1, tile, tile + 1, full}):
        sub = tuple(a[:B] for a in args)
        plan = cuda_ncc.ungrouped_plan(B, wsize, luma)
        assert plan["tile"] % 4 == 0 and 1 <= plan["grid"] <= -(-B // plan["tile"]), plan
        assert (plan["stages"], plan["threads"], plan["tile"]) == (1, 256, tile), plan
        ragged += B % plan["tile"] != 0
        out, fit = cuda_ncc.sample_windows(scene, *sub, wsize, luma=luma)
        plain = _plain_fn(luma)(scene, *sub, wsize)
        torch.cuda.synchronize()
        assert fit.all() and out.shape == plain.shape
        assert torch.equal(_bits(out), _bits(plain)), (B, plan)
        assert torch.equal(_bits(out), _bits(grp[:B])), (B, plan)
    assert ragged > 0
    form = "luma_ungrouped" if luma else "ungrouped"
    assert cuda_ncc.LAUNCHES[form] == cuda_ncc.WINDOWS[form].total() > 0


@pytest.mark.parametrize("luma", [False, True])
def test_ungrouped_form_never_refuses_a_window_size(card, luma):
    """Every window size 1-15 launches ungrouped (the run-time size
    instance, and the compiled 7), with 1 window and 1,000, bit-equal to
    the plain version; its plan never passes the card's shared memory."""
    from mvskit_tpu_torch.ops import cuda_ncc
    from mvskit_tpu_torch.utils import synthetic

    _, _, scene = synthetic.plane_scene(n_views=6, width=160, height=120, device=card)
    for wsize in range(1, 16):
        args = _windows(scene, n_patch=16, n_cands=21, wsize=wsize)  # 1,008 windows
        for B in (1, 1000):
            sub = tuple(a[:B] for a in args)
            plan = cuda_ncc.ungrouped_plan(B, wsize, luma)
            out, _ = cuda_ncc.sample_windows(scene, *sub, wsize, luma=luma)
            plain = _plain_fn(luma)(scene, *sub, wsize)
            torch.cuda.synchronize()
            assert torch.equal(_bits(out), _bits(plain)), (wsize, B, plan)


def test_ungrouped_ablation_switches_bitwise(card):
    """K5 on the ungrouped forms (K1, K3u): every switch at a ragged
    batch of 999 windows, at 7 x 7 (compiled) and 5 x 5 (run-time size),
    equals its plain version bit for bit."""
    from mvskit_tpu_torch.ops import cuda_ncc
    from mvskit_tpu_torch.utils import synthetic

    _, _, scene = synthetic.plane_scene(n_views=6, width=160, height=120, device=card)
    profiling.COUNTERS.reset()
    for wsize in (WSIZE, 5):
        args = tuple(a[:999] for a in _windows(scene, n_patch=16, wsize=wsize))
        for ablate in cuda_ncc.ABLATIONS[1:]:
            for luma in (False, True):
                out, _ = cuda_ncc.sample_windows(scene, *args, wsize, luma=luma,
                                                 ablate=ablate)
                plain = _plain_fn(luma)(scene, *args, wsize, ablate=ablate)
                torch.cuda.synchronize()
                assert torch.equal(_bits(out), _bits(plain)), (wsize, ablate, luma)
    assert cuda_ncc.LAUNCHES == dict(_no_launches(), **{
        f"ablate_{a}": 4 for a in cuda_ncc.ABLATIONS[1:]})


def test_every_form_reads_the_illumination_it_is_given(card):
    """The kernel computes each window's plane row as idx * ni + illum:
    on a 3-illumination scene every form (ungrouped at a ragged batch,
    grouped, fused; RGB and luma) at every illumination equals the plain
    version at that illumination bit for bit."""
    from mvskit_tpu_torch.ops import cuda_ncc
    from mvskit_tpu_torch.utils import synthetic

    _, _, scene = synthetic.sphere_scene(n_views=6, width=160, height=120, nillums=3,
                                         device=card)
    args = _windows(scene)
    odd = tuple(a[:1001] for a in args)
    for luma in (False, True):
        for il in range(3):
            plain = _plain_fn(luma)(scene, *args, WSIZE, illum=il)
            for sub, group, fused in ((odd, 1, False), (args, 1, False), (args, 32, False),
                                      (args, 32, True)):
                out, _ = cuda_ncc.sample_windows(scene, *sub, WSIZE, illum=il, group=group,
                                                 luma=luma, fused=fused)
                torch.cuda.synchronize()
                n = sub[0].shape[0]
                assert torch.equal(_bits(out), _bits(plain[:n])), (luma, il, n, group, fused)


def test_ungrouped_launch_refuses_an_output_past_int_max(card):
    """A batch whose output passes INT_MAX floats (14,608,732 RGB windows
    of 7 x 7) is refused by the launch, not run with wrapped offsets."""
    from mvskit_tpu_torch.ops import cuda_ncc
    from mvskit_tpu_torch.utils import synthetic

    _, _, scene = synthetic.plane_scene(n_views=6, width=160, height=120, device=card)
    B = 2**31 // (3 * WSIZE * WSIZE) + 1
    idx = torch.zeros(B, dtype=torch.int32, device=card)
    pts = torch.zeros((B, 2), dtype=torch.float32, device=card)
    with pytest.raises(RuntimeError, match="ungrouped"):
        cuda_ncc.sample_windows(scene, idx, idx, pts, pts, pts, WSIZE)
    torch.cuda.synchronize()


def test_pipeline_on_card_tracks_cpu(card, tmp_path):
    from mvskit_tpu_torch.config import MVSConfig
    from mvskit_tpu_torch.ops import cuda_ncc
    from mvskit_tpu_torch.pipeline.driver import PMMVS
    from mvskit_tpu_torch.pipeline.propagate import TorchNoise
    from mvskit_tpu_torch.utils import synthetic

    prefix = str(tmp_path)
    synthetic.write_dataset(prefix, n_views=6, width=160, height=120, n_seeds=48)
    alive = {}
    for dev in ("cpu", "cuda"):
        cfg = MVSConfig.from_option_file(prefix)
        cfg.max_patches, cfg.donor_budget, cfg.gauntlet_chunk = 4096, 512, 256
        cfg.refine_cands, cfg.prop_rounds, cfg.n_iterations = 4, 2, 2
        noise = TorchNoise(torch.Generator().manual_seed(0))  # CPU draws
        profiling.COUNTERS.reset()
        e = PMMVS(cfg, device=dev, noise=noise, log=lambda *a: None)
        e.seed()
        e.run(write_snapshots=False)
        e.close()
        alive[dev] = e.report["alive_per_iter"]
        if dev == "cuda":
            assert cuda_ncc.LAUNCHES["ungrouped"] > 0 and cuda_ncc.LAUNCHES["grouped"] > 0
    for a, b in zip(alive["cpu"], alive["cuda"]):
        assert abs(a - b) <= 0.03 * a, alive


def test_recorder_counts_every_sync_of_a_round_and_a_filter_pass(card, tmp_path):
    """Stage by stage, a reconstruction's synchronizing operations (the
    load, the seed, two propagation rounds, the second with the depth-2
    check, two filter passes and the final write) each lie inside one
    sync span of the recorder, and every sync span holds one."""
    import collections
    import time
    import warnings

    from mvskit_tpu_torch.config import MVSConfig
    from mvskit_tpu_torch.pipeline.driver import PMMVS
    from mvskit_tpu_torch.utils import profiling, synthetic

    prefix = str(tmp_path / "data")
    synthetic.write_dataset(prefix, n_views=6, width=160, height=120, n_seeds=256)
    cfg = MVSConfig.from_option_file(prefix)
    cfg.max_patches, cfg.donor_budget, cfg.gauntlet_chunk = 4096, 512, 256
    cfg.refine_cands, cfg.prop_rounds = 4, 1
    engine = []

    def second_iteration():
        engine[0].update_threshold()
        engine[0].depth += 1  # the round runs the depth-2 check
        return engine[0].propagate(1)

    stages = (("load", lambda: engine.append(PMMVS(cfg, device=card, log=lambda *a: None))),
              ("seed", lambda: engine[0].seed()), ("round", lambda: engine[0].propagate(0)),
              ("filter", lambda: engine[0].filter()), ("round", second_iteration),
              ("filter", lambda: engine[0].filter()),
              ("write", lambda: engine[0].write_patches(str(tmp_path / "out"),
                                                        export_patch=True)))
    try:
        for stage, fn in stages:
            caught = []

            def hook(message, category, filename, lineno, file=None, line=None):
                if "synchronizing CUDA operation" in str(message):
                    caught.append((time.perf_counter_ns(), f"{filename}:{lineno}"))

            torch.cuda.synchronize()
            with profiling.tracing() as trace, warnings.catch_warnings():
                warnings.simplefilter("always")
                warnings.showwarning = hook
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    fn()
                finally:
                    torch.cuda.set_sync_debug_mode(0)
            syncs = sorted((s.start_ns - trace.offset_ns, s.end_ns - trace.offset_ns, s.name)
                           for s in trace.spans if s.kind == "sync")
            outside = collections.Counter(
                site for t, site in caught
                if sum(1 for a, b, _ in syncs if a <= t < b) != 1)
            hits = collections.Counter(n for a, b, n in syncs
                                       if sum(1 for t, _ in caught if a <= t < b) != 1)
            assert len(caught) == len(syncs) > 0 and not outside and not hits, (
                stage, len(caught), len(syncs), outside, hits)
            if stage == "round":
                names = {s.name for s in trace.spans}
                assert "chunk" in names
                assert ("check" in names) == (fn is second_iteration)
                # its chunks replay CUDA graphs, the first captured
                assert {"capture", "replay"} <= names, names
    finally:
        if engine:
            engine[0].close()


def test_idle_gap_lands_in_its_span(card):
    import time

    from torch.profiler import ProfilerActivity, profile

    from mvskit_tpu_torch.utils import profiling

    x = torch.randn(1 << 20, device=card)

    def two_kernels():
        with profiling.tracing() as trace, profile(activities=[ProfilerActivity.CUDA]) as prof:
            with profiling.span("work"):
                y = x * 2
                with profiling.span("gap"):
                    time.sleep(0.05)
                y + 1
                torch.cuda.synchronize()
        return trace, prof

    two_kernels()  # the profiler's first recording starts slowly
    trace, prof = two_kernels()
    busy = [(e.start_ns(), e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == torch.autograd.DeviceType.CUDA]
    assert len(busy) == 2
    idle = trace.idle_by_span(busy)
    assert abs(idle["work/gap"] - 0.05) < 0.005, idle


@pytest.mark.parametrize("luma", [False, True])
def test_refine_kernel_path_equals_plain_path(card, luma):
    """refine_batch at B = 512 through the sampler's kernels and through
    its plain version on the card (Scene.use_kernel = False, the
    driver's use_pallas=False): the same bits, and only the kernel path
    launches."""
    import dataclasses

    from mvskit_tpu_torch.ops import cuda_ncc
    from mvskit_tpu_torch.tools import bench
    from mvskit_tpu_torch.tools.bench_kernel import bench_scene

    Ps, scene = bench_scene(card, 6, 160, 120)
    coord, normal = bench.plane_inputs(Ps, scene, 512, extent=0.7)
    images, dscale = bench.prep(scene, coord, normal)
    out, launches = [], []
    for use_kernel in (True, False):
        gen = torch.Generator(device=card).manual_seed(0)
        sc = dataclasses.replace(scene, use_kernel=use_kernel)
        profiling.COUNTERS.reset()
        out.append(bench.search(sc, coord, normal, images, dscale, generator=gen, rounds=6,
                                cands=32, luma=luma))
        torch.cuda.synchronize()
        launches.append(sum(cuda_ncc.LAUNCHES.values()))
    for k in ("coord", "normal", "ncc", "cost"):
        assert torch.equal(getattr(out[0], k), getattr(out[1], k)), k
    assert launches[0] > 0 and launches[1] == 0, launches


@pytest.mark.parametrize("k", [3, 6])
@pytest.mark.parametrize("luma", [False, True])
@pytest.mark.parametrize("group", [1, 32])
def test_view_sharded_launch_every_form_bitwise(card, k, luma, group):
    """The view-sharded sampler (ops/ncc._sample_windows_view_sharded) on
    k shards of 6 views, all on the card: each shard owning a used view
    launches the batch's form once on its compacted windows, and the
    result equals the unsharded launch bit for bit."""
    from mvskit_tpu_torch.ops import cuda_ncc, ncc
    from mvskit_tpu_torch.parallel import shard as sh
    from mvskit_tpu_torch.utils import profiling, synthetic

    _, _, scene = synthetic.plane_scene(n_views=6, width=160, height=120, device=card)
    idx, lvl, tl, dx, dy = _windows(scene)  # views 0, 1, 2 of 64 x 32 windows
    T = 3
    args = (idx.reshape(T, -1), tl.reshape(T, -1, 2), dx.reshape(T, -1, 2),
            dy.reshape(T, -1, 2), lvl.reshape(T, -1), WSIZE, 0, luma, group)
    want, _, _ = ncc.sample_windows_raw(scene, *args)
    vs = sh.enable_view_sharding(scene, sh.make_mesh(k, "view", devices=[card] * k))
    profiling.COUNTERS.reset()
    with profiling.tracing() as trace:
        got, fit, _ = ncc._sample_windows_view_sharded(vs, *args)
    torch.cuda.synchronize()
    form = cuda_ncc.launch_form(idx.shape[0], group, luma, False)
    shards = {v // (6 // k) for v in range(T)}
    assert cuda_ncc.LAUNCHES == dict(_no_launches(), **{form: len(shards)})
    assert {s for s, _ in ncc.SHARD_CALLS} == shards
    assert profiling.sync_count(trace, "sampler.shard_counts") == 1
    assert fit.all() and torch.equal(_bits(got), _bits(want))


def test_cli_mesh_needs_distinct_cards(card, tmp_path):
    """--device cuda --mesh takes distinct cards: with fewer than the
    mesh's size it raises ValueError naming the count, and never shares
    a card silently."""
    from mvskit_tpu_torch import cli
    from mvskit_tpu_torch.utils import synthetic

    synthetic.write_dataset(str(tmp_path), n_views=4, width=96, height=64, n_seeds=16)
    have = torch.cuda.device_count()
    with pytest.raises(ValueError, match=f"have {have}"):
        cli.main([str(tmp_path), "--device", "cuda", "--mesh", f"1,1,{have + 1}",
                  "--no-snapshots"])


def _grad_windows(scene, kind, wsize, luma):
    from mvskit_tpu_torch.tools.bench_kernel import edge_windows

    if kind == "edge":
        args = edge_windows(scene, 64 * 32)
    else:
        args = _windows(scene, wsize=wsize)
    B = args[0].shape[0]
    C = 1 if luma else 3
    gen = torch.Generator(device=scene.device).manual_seed(wsize)
    cot = torch.randn((B, C * wsize * wsize), generator=gen, device=scene.device)
    return args, cot


def _check_backward(scene, args, cot, wsize, luma):
    """The backward kernel on (args, cot): two launches (and only they)
    bit for bit, each output within 1e-5 (chip_smoke.GRAD_RTOL) of the
    float64 plain version's, relative to grad_scale, with its NaN and
    finite patterns (the float32 plain version's patterns too)."""
    from mvskit_tpu_torch.ops import cuda_ncc

    profiling.COUNTERS.reset()
    got = cuda_ncc.sample_windows_grad(scene, *args, wsize, cot, luma=luma)
    again = cuda_ncc.sample_windows_grad(scene, *args, wsize, cot, luma=luma)
    torch.cuda.synchronize()
    key = "luma_grad" if luma else "grad"
    assert cuda_ncc.LAUNCHES == dict(_no_launches(), **{key: 2})
    f64 = torch.float64
    want = cuda_ncc.sample_windows_grad_plain(scene, *args, wsize, cot, luma=luma, dtype=f64)
    scale = cuda_ncc.grad_scale(cuda_ncc.sample_grad_terms(scene, *args, wsize, cot,
                                                           luma=luma, dtype=f64), wsize)
    plain32 = cuda_ncc.sample_windows_grad_plain(scene, *args, wsize, cot, luma=luma)
    for g, a, w, sc, p32 in zip(got, again, want, scale, plain32):
        assert torch.equal(_bits(g), _bits(a))
        for x in (g, p32):
            assert torch.equal(torch.isnan(x), torch.isnan(w))
            assert torch.equal(torch.isfinite(x), torch.isfinite(w))
        fin = torch.isfinite(w)
        err = (g.double() - w).abs()[fin] / sc[fin]
        assert (err <= 1e-5).all(), err.max()


@pytest.mark.parametrize("kind", ["plane", "edge"])
@pytest.mark.parametrize("wsize", [7, 5, 9, 15])
@pytest.mark.parametrize("luma", [False, True])
def test_backward_kernel_matches_plain(card, kind, wsize, luma):
    """WS = 7 and the run-time size instance (5: four windows a warp; 9,
    15: two)."""
    from mvskit_tpu_torch.utils import synthetic

    _, _, scene = synthetic.plane_scene(n_views=6, width=160, height=120, device=card)
    args, cot = _grad_windows(scene, kind, wsize, luma)
    _check_backward(scene, args, cot, wsize, luma)


def _edge_batch(scene, B, wsize, luma):
    from mvskit_tpu_torch.tools.bench_kernel import edge_windows

    args = edge_windows(scene, B, seed=B)
    gen = torch.Generator(device=scene.device).manual_seed(B)
    cot = torch.randn((B, (1 if luma else 3) * wsize * wsize), generator=gen,
                      device=scene.device)
    return args, cot


@pytest.mark.parametrize("batch,wsize", [("1", 7), ("3", 7), ("5", 7), ("tile+1", 7),
                                         ("786432", 7), ("1", 9), ("3", 9), ("5", 9),
                                         ("tile+1", 9)])
@pytest.mark.parametrize("luma", [False, True])
def test_backward_kernel_every_batch(card, batch, wsize, luma):
    """Batches of 1, 3, 5 windows, one tile and one window (a second
    tile of one window) and 786,432 (many tiles a block; the last
    tile's ragged size depends on the tile), on the edge lattices: the
    ragged last tile is staged by 4-byte copies, the others by bulk
    copies, and every window's outputs are held to the plain version."""
    from mvskit_tpu_torch.ops import cuda_ncc
    from mvskit_tpu_torch.utils import synthetic

    _, _, scene = synthetic.plane_scene(n_views=6, width=160, height=120, device=card)
    plan = cuda_ncc.grad_plan(4096, wsize, luma)
    B = plan["tile"] + 1 if batch == "tile+1" else int(batch)
    args, cot = _edge_batch(scene, B, wsize, luma)
    _check_backward(scene, args, cot, wsize, luma)
    if B == 786432:
        big = cuda_ncc.grad_plan(B, wsize, luma)
        assert big["grid"] < B // big["tile"] and big["bulk_copy"]


@pytest.mark.parametrize("array", ["grad_out", "tl"])
@pytest.mark.parametrize("luma", [False, True])
def test_backward_kernel_unaligned_arrays(card, array, luma):
    """A contiguous grad_out (or tl) view that starts 4 bytes past a
    16-byte boundary: every tile is staged by 4-byte copies, the launch
    is neither refused nor sent to the plain version, and it gives the
    aligned launch's bits."""
    from mvskit_tpu_torch.ops import cuda_ncc
    from mvskit_tpu_torch.utils import synthetic

    _, _, scene = synthetic.plane_scene(n_views=6, width=160, height=120, device=card)
    args, cot = _grad_windows(scene, "plane", WSIZE, luma)
    aligned = cuda_ncc.sample_windows_grad(scene, *args, WSIZE, cot, luma=luma)

    def shifted(t):
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
        out = buf[1:].view(t.shape)
        out.copy_(t)
        assert out.is_contiguous() and out.data_ptr() % 16 == 4
        return out

    if array == "grad_out":
        cot = shifted(cot)
    else:
        args = (*args[:2], shifted(args[2]), *args[3:])
    _check_backward(scene, args, cot, WSIZE, luma)
    got = cuda_ncc.sample_windows_grad(scene, *args, WSIZE, cot, luma=luma)
    for g, a in zip(got, aligned):
        assert torch.equal(_bits(g), _bits(a))


def test_backward_kernel_is_the_autograd_of_the_launch(card):
    """Autograd through sample_windows on the card launches the forward
    kernel and the backward kernel, and gives the backward's bits."""
    from mvskit_tpu_torch.ops import cuda_ncc
    from mvskit_tpu_torch.utils import synthetic

    _, _, scene = synthetic.plane_scene(n_views=6, width=160, height=120, device=card)
    (idx, lvl, tl, dx, dy), cot = _grad_windows(scene, "plane", WSIZE, False)
    direct = cuda_ncc.sample_windows_grad(scene, idx, lvl, tl, dx, dy, WSIZE, cot)
    leaves = [t.clone().requires_grad_() for t in (tl, dx, dy)]
    profiling.COUNTERS.reset()
    out, _ = cuda_ncc.sample_windows(scene, idx, lvl, *leaves, WSIZE, group=32)
    grads = torch.autograd.grad(out, leaves, cot)
    assert cuda_ncc.LAUNCHES == dict(_no_launches(), grouped=1, grad=1)
    for g, d in zip(grads, direct):
        assert torch.equal(_bits(g), _bits(d))


def test_polished_refine_kernel_path_tracks_plain_path(card):
    """refine_batch with grad_steps=4 at B = 512 through the kernels and
    through the plain versions on the card (use_kernel=False): the
    backward's sums differ from autograd's by rounding, so the two
    agree as the refinement parity does (coord 1e-4 on >= 99 % of
    rows); only the kernel path launches, the backward among it, and
    the polish never raises a row's cost."""
    import dataclasses

    from mvskit_tpu_torch.ops import cuda_ncc
    from mvskit_tpu_torch.tools import bench
    from mvskit_tpu_torch.tools.bench_kernel import bench_scene

    Ps, scene = bench_scene(card, 6, 160, 120)
    coord, normal = bench.plane_inputs(Ps, scene, 512, extent=0.7)
    images, dscale = bench.prep(scene, coord, normal)
    out, launches = [], []
    for use_kernel in (True, False):
        gen = torch.Generator(device=card).manual_seed(0)
        sc = dataclasses.replace(scene, use_kernel=use_kernel)
        profiling.COUNTERS.reset()
        out.append(bench.search(sc, coord, normal, images, dscale, generator=gen, rounds=3,
                                cands=8, grad_steps=4))
        torch.cuda.synchronize()
        launches.append(dict(cuda_ncc.LAUNCHES))
    assert launches[0]["grad"] == 4 and launches[0]["ungrouped"] >= 8
    assert sum(launches[1].values()) == 0
    d = (out[0].coord - out[1].coord).abs().max(1).values
    assert (d <= 1e-4).float().mean() >= 0.99, d.max()
    gen = torch.Generator(device=card).manual_seed(0)
    base = bench.search(scene, coord, normal, images, dscale, generator=gen, rounds=3, cands=8)
    assert (out[0].cost <= base.cost).all()


@pytest.mark.parametrize("k", [2, 3])
def test_polished_refine_on_view_shards_equals_unsharded(card, k):
    from mvskit_tpu_torch.ops import cuda_ncc
    from mvskit_tpu_torch.parallel import shard as sh
    from mvskit_tpu_torch.tools import bench
    from mvskit_tpu_torch.tools.bench_kernel import bench_scene

    Ps, scene = bench_scene(card, 6, 160, 120)
    coord, normal = bench.plane_inputs(Ps, scene, 256, extent=0.7)
    images, dscale = bench.prep(scene, coord, normal)
    vs = sh.enable_view_sharding(scene, sh.make_mesh(k, "view", devices=[card] * k))
    out = []
    for sc in (scene, vs):
        gen = torch.Generator(device=card).manual_seed(0)
        profiling.COUNTERS.reset()
        out.append(bench.search(sc, coord, normal, images, dscale, generator=gen, rounds=2,
                                cands=8, grad_steps=2))
        assert cuda_ncc.LAUNCHES["grad"] > 0
    for a, b in zip(*out):
        assert torch.equal(_bits(a), _bits(b))


@pytest.mark.parametrize("depth2", [False, True])
@pytest.mark.parametrize("mode", ["rgb", "luma", "illum2"])
def test_graphed_gauntlet_equals_eager(card, tmp_path, mode, depth2):
    """Two rounds' chunks through the engine's runner against the same
    chunks op by op at the padded shape: every GauntletOut field bit for
    bit, one capture for both rounds, and the same launch counters, each
    replay crediting the capture's windows (its stored increments of
    every registered counter)."""
    import collections

    from gauntlet_case import ChunkNoise, bits, make_engine, round_inputs
    from mvskit_tpu_torch.ops import cuda_ncc
    from mvskit_tpu_torch.pipeline import propagate as pr

    e = make_engine(str(tmp_path / "data"), card, nillums=2 if mode == "illum2" else 1,
                    luma_refine=mode == "luma", refine_rgb_tail=2)
    p = e.prop_params._replace(depth2_check=depth2)
    assert p.n_illums == (2 if mode == "illum2" else 1) and p.luma_refine == (mode == "luma")
    runner = pr._GauntletGraphs(card)
    try:
        for rnd, direction in enumerate((1, -1)):
            grid, table, *hyps, ok = round_inputs(e, direction, seed=rnd)
            live = torch.nonzero(ok).flatten()
            ok = ok.clone()
            ok[live[-100:]] = False  # leaves the last chunk ragged
            hyps.append(ok)
            runs = []
            for graphs in (None, runner):
                profiling.COUNTERS.reset()
                out = pr._gauntlet_chunked(e.scene, grid, table, *hyps, ChunkNoise(rnd, card),
                                           p, 0.6, 0.4, True, 2.5, graphs=graphs)
                torch.cuda.synchronize()
                runs.append((out, dict(cuda_ncc.LAUNCHES),
                             {k: collections.Counter(v) for k, v in cuda_ncc.WINDOWS.items()},
                             collections.Counter(pr.GRAPHS)))
            (eager, l0, w0, g0), (graphed, l1, w1, g1) = runs
            for f in pr.GauntletOut._fields:
                assert torch.equal(bits(getattr(eager, f)), bits(getattr(graphed, f))), (rnd, f)
            assert graphed.ok.any()
            chunks = g0["eager_no_runner"]
            assert chunks >= 2 and g0["pad_rows"] > 0, g0
            assert g1 == collections.Counter(captures=1 - rnd, replays=chunks,
                                             pad_rows=g0["pad_rows"]), g1
            assert l1 == l0 and w1 == w0
            (entry,) = runner.graphs.values()
            assert w1 == {k: collections.Counter({b: c * chunks for b, c in
                                                  entry.counts[f"cuda_ncc.WINDOWS/{k}"].items()})
                          for k in w1}
            e.table = pr.insert_patches(table, graphed)
    finally:
        runner.release()
        e.close()
