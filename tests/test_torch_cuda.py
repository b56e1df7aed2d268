"""Tests of the port that need an NVIDIA card (marker `cuda`); each
skips where torch.cuda is unavailable. The file imports no jax, so on
the card's machine, which has none, it runs without the repository's
conftest:

    python -m pytest --noconftest -q -p no:cacheprovider tests/test_torch_cuda.py

Tolerances: the RGB kernel equals its plain version (same arithmetic,
each operation rounded alone) — checked to 1e-3 on the 0-255 scale, the
bound chip_smoke.py also states; the luma kernel equals its plain
version bit for bit; grouped and fused (K4) equal ungrouped bit for bit;
every ablation switch (K5) in every launch form equals its plain
version bit for bit.
The pipeline on the card against the same pipeline on the CPU, fed the
same random numbers: alive counts within 3 % (reductions sum in another
order on the card, which can flip a near-tie accept/reject)."""

import numpy as np
import pytest
import torch

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


def _windows(scene, n_patch=64, n_cands=32):
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
        scene, views.T.contiguous(), c, px, py, n, LEVEL, WSIZE, 1.0471976)
    flat = lambda x, k=(): x.reshape((-1,) + k).contiguous()  # noqa: E731
    return (flat(views.T.contiguous()), flat(lvl.to(torch.int32)), flat(tl, (2,)),
            flat(dx, (2,)), flat(dy, (2,)))


def test_kernel_forms_match_plain(card):
    from mvskit_tpu_torch.ops import cuda_ncc
    from mvskit_tpu_torch.utils import synthetic

    _, _, scene = synthetic.plane_scene(n_views=6, width=160, height=120, device=card)
    args = _windows(scene)
    cuda_ncc.reset_launches()
    ung, fit = cuda_ncc.sample_windows(scene, *args, WSIZE, group=1)
    grp, _ = cuda_ncc.sample_windows(scene, *args, WSIZE, group=32)
    odd, _ = cuda_ncc.sample_windows(scene, *(a[:-1] for a in args), WSIZE, group=32)
    torch.cuda.synchronize()
    plain = cuda_ncc.sample_windows_plain(scene, *args, WSIZE)
    assert cuda_ncc.LAUNCHES == dict(_no_launches(), ungrouped=2, grouped=1)
    assert fit.all()
    assert (ung - plain).abs().max().item() <= 1e-3
    assert torch.equal(ung.view(torch.int32), grp.view(torch.int32))
    assert torch.equal(odd.view(torch.int32), ung[:-1].view(torch.int32))


def _bits(x):
    return x.contiguous().view(torch.int32)


def test_luma_kernel_forms_match_plain_bitwise(card):
    from mvskit_tpu_torch.ops import cuda_ncc
    from mvskit_tpu_torch.utils import synthetic

    _, _, scene = synthetic.plane_scene(n_views=6, width=160, height=120, device=card)
    args = _windows(scene)
    cuda_ncc.reset_launches()
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
    (75 KB of dynamic shared memory for RGB); a group whose outputs pass
    the block's shared-memory limit raises."""
    from mvskit_tpu_torch.ops import cuda_ncc
    from mvskit_tpu_torch.utils import synthetic

    _, _, scene = synthetic.plane_scene(n_views=6, width=160, height=120, device=card)
    args = _windows(scene)
    for luma, plain_fn in ((False, cuda_ncc.sample_windows_plain),
                           (True, cuda_ncc.sample_windows_luma_plain)):
        cuda_ncc.reset_launches()
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
    plain version bit for bit; norot equals the normal output."""
    from mvskit_tpu_torch.ops import cuda_ncc
    from mvskit_tpu_torch.utils import synthetic

    _, _, scene = synthetic.plane_scene(n_views=6, width=160, height=120, device=card)
    args = _windows(scene, n_patch=16)
    cuda_ncc.reset_launches()
    for ablate in cuda_ncc.ABLATIONS[1:]:
        for luma, plain_fn in ((False, cuda_ncc.sample_windows_plain),
                               (True, cuda_ncc.sample_windows_luma_plain)):
            plain = plain_fn(scene, *args, WSIZE, ablate=ablate)
            for group, fused in ((1, False), (32, False), (32, True)):
                out, _ = cuda_ncc.sample_windows(scene, *args, WSIZE, group=group,
                                                 luma=luma, fused=fused, ablate=ablate)
                torch.cuda.synchronize()
                assert torch.equal(_bits(out), _bits(plain)), (ablate, luma, group, fused)
    assert cuda_ncc.LAUNCHES == dict(_no_launches(), **{
        f"ablate_{a}": 6 for a in cuda_ncc.ABLATIONS[1:]})
    normal, _ = cuda_ncc.sample_windows(scene, *args, WSIZE, group=32)
    norot, _ = cuda_ncc.sample_windows(scene, *args, WSIZE, group=32, ablate="norot")
    assert torch.equal(_bits(norot), _bits(normal))
    with pytest.raises(ValueError, match="ablate"):
        cuda_ncc.sample_windows(scene, *args, WSIZE, ablate="noflop")


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
        assert (outs[2, 1] - p2).abs().max().item() <= (0.0 if luma else 1e-3)
        assert torch.equal(_bits(outs[2, 32]), _bits(outs[2, 1]))
        assert (outs[2, 1] - outs[0, 1]).abs().max().item() > 1.0
    with pytest.raises(ValueError):
        cuda_ncc.sample_windows(scene, *args, WSIZE, illum=3)


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
        cuda_ncc.reset_launches()
        e = PMMVS(cfg, device=dev, noise=noise, log=lambda *a: None)
        e.seed()
        e.run(write_snapshots=False)
        e.close()
        alive[dev] = e.report["alive_per_iter"]
        if dev == "cuda":
            assert cuda_ncc.LAUNCHES["ungrouped"] > 0 and cuda_ncc.LAUNCHES["grouped"] > 0
    for a, b in zip(alive["cpu"], alive["cuda"]):
        assert abs(a - b) <= 0.03 * a, alive
