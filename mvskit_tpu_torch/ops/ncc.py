"""Batched NCC photo-consistency scoring (port of ``mvskit_tpu/ops/ncc.py``).

For a batch of patch hypotheses: warp a wsize x wsize window on the
patch plane into each candidate view (bilinear, with a per-(patch, view)
pyramid level), normalize it, and reduce to robust inverse-NCC scores
(reference pmmvps/optim.cpp:790-948, 601-628, 630-706).

Window tensors are windows-major, ``tex[T, B, L]`` with L = 3 * S lanes
per (view, patch) row and channel c in lanes ``[c * S, (c + 1) * S)``
(L = S for the luma search): the literal row layout of the window
sampler (``ops/cuda_ncc.py``). With several illuminations, each one is
sampled against the same window geometry and the scores are averaged.
``normalize_tex`` folds the 1/sqrt(C * S) mean factor into the values,
so the dot of two normalized rows is the reference's mean NCC dot.
"""

from __future__ import annotations

import collections
import math

import torch

from ..geometry import camera as cam
from ..image.scene import Scene
from . import cuda_ncc

BIG = float(2**30)


def robustincc(incc):
    """incc / (1 + 3 incc) (optim.cpp:622-624)."""
    return incc / (1.0 + 3.0 * incc)


def unrobustincc(rincc):
    """Inverse of robustincc (optim.cpp:626-628)."""
    return rincc / (1.0 - 3.0 * rincc)


def _dot4(a, b):
    return (a * b).sum(-1)


def _unit_ray_to_camera(scene: Scene, index, coord):
    """Normalized ray from patch to camera center (w component 0)."""
    ray = scene.cams.center[index] - coord
    n = torch.sqrt(torch.clamp((ray * ray).sum(-1), min=1e-20))
    return ray / n.unsqueeze(-1)


def _window_tail(scene: Scene, c_xy, dx, dy, level: int, wsize: int):
    """Footprint ratio -> level shift -> rescaled lattice steps ->
    border-safety check -> lattice origin (optim.cpp:806-822).

    Returns (tl[..., 2], dx2[..., 2], dy2[..., 2], new_level[...] int32,
    valid_safe[...])."""
    n_levels = len(scene.widths)
    if n_levels < level + 3:
        raise ValueError(
            f"scene has {n_levels} pyramid levels; getTex at level {level} "
            f"needs >= {level + 3} (reference pmmvps.cpp:36)"
        )
    ratio = (
        torch.sqrt(torch.clamp((dx * dx).sum(-1), min=1e-20))
        + torch.sqrt(torch.clamp((dy * dy).sum(-1), min=1e-20))
    ) / 2.0
    level_diff = torch.floor(torch.log2(ratio) + 0.5)
    # clamp before the int cast (saturating, NaN -> 0 as in XLA), so a
    # degenerate window can never index outside the level tables
    level_diff = torch.nan_to_num(level_diff, nan=0.0)
    level_diff = level_diff.clamp(-level, 2).to(torch.int32)
    scale = torch.exp2(level_diff.to(torch.float32))
    new_level = level + level_diff

    c2 = c_xy / scale.unsqueeze(-1)
    dx2 = dx / scale.unsqueeze(-1)
    dy2 = dy / scale.unsqueeze(-1)

    margin = wsize // 2
    half = dx2 * margin
    halfy = dy2 * margin
    minxy = c2 - half.abs() - halfy.abs()
    maxxy = c2 + half.abs() + halfy.abs()
    lv = new_level.long()
    w_l = scene.lvl_widths[lv].to(torch.float32)
    h_l = scene.lvl_heights[lv].to(torch.float32)
    margin2 = 2.0
    valid_safe = (
        (minxy[..., 0] >= margin2)
        & (maxxy[..., 0] < w_l - 1.0 - margin2)
        & (minxy[..., 1] >= margin2)
        & (maxxy[..., 1] < h_l - 1.0 - margin2)
    )
    tl = c2 - half - halfy
    return tl, dx2, dy2, new_level, valid_safe


def window_geometry(
    scene: Scene, idx, coord, pxaxis, pyaxis, normal, level: int,
    wsize: int, angle_threshold1: float,
):
    """The geometric half of Optim::getTex (optim.cpp:790-822).
    Returns (tl, dx, dy, new_level, valid)."""
    ray = _unit_ray_to_camera(scene, idx, coord)
    weight = torch.clamp(_dot4(ray, normal), min=0.0)
    valid_angle = weight >= math.cos(angle_threshold1)

    c_xy, _, c_ok = cam.project(scene.cams, idx, coord, level)
    px_xy, _, _ = cam.project(scene.cams, idx, coord + pxaxis, level)
    py_xy, _, _ = cam.project(scene.cams, idx, coord + pyaxis, level)
    tl, dx2, dy2, new_level, valid_safe = _window_tail(
        scene, c_xy, px_xy - c_xy, py_xy - c_xy, level, wsize
    )
    return tl, dx2, dy2, new_level, valid_angle & valid_safe & c_ok


def window_geometry_views(
    scene: Scene, views_t, coord, pxaxis, pyaxis, normal, level: int,
    wsize: int, angle_threshold1: float,
):
    """window_geometry for a [T, B] view batch sharing per-patch
    geometry. Projection is linear, so one [B, 4] @ [4, 3V] float32
    matmul per lattice point projects the batch into every view, and
    each (t, b) entry then picks its view's row. Padded entries
    (views_t == -1) select zeros and come back invalid, as in the JAX
    package's one-hot selection."""
    T, B = views_t.shape
    V = scene.n_images
    cams = scene.cams
    Pcat = cams.P.reshape(V * 3, 4).T  # [4, 3V]
    qc = (coord @ Pcat).reshape(B, V, 3)
    qx = (pxaxis @ Pcat).reshape(B, V, 3)
    qy = (pyaxis @ Pcat).reshape(B, V, 3)

    # viewing-angle gate dense over views, ray norm computed
    # subtract-then-square (the expanded form cancels catastrophically)
    c3 = coord[:, :3]
    n3 = normal[:, :3]
    cen = cams.center[:, :3]                                 # [V, 3]
    diff = cen.unsqueeze(0) - c3.unsqueeze(1)                # [B, V, 3]
    rnorm = torch.sqrt(torch.clamp((diff * diff).sum(-1), min=1e-20))
    wraw = (diff * n3.unsqueeze(1)).sum(-1) / rnorm          # [B, V]
    ang_ok = torch.clamp(wraw, min=0.0) >= math.cos(angle_threshold1)

    q = torch.cat([qc, qx, qy], dim=-1)                      # [B, V, 9]
    live = views_t >= 0
    vsel = views_t.clamp(min=0).long()
    cols = torch.arange(B, device=coord.device).unsqueeze(0)
    selq = q[cols, vsel]                                     # [T, B, 9]
    selq = torch.where(live.unsqueeze(-1), selq, torch.zeros_like(selq))
    sel_ang = ang_ok[cols, vsel] & live
    ic = selq[..., 0:3]
    s = cam.level_scale(level)

    def proj_xy(p):
        z = p[..., 2]
        ok = z > 0.0
        safe_z = torch.where(ok, z, torch.ones_like(z))
        xy = (p[..., :2] / (safe_z * s).unsqueeze(-1)).clamp(-1e9, 1e9)
        return torch.where(ok.unsqueeze(-1), xy, torch.full_like(xy, cam.BEHIND)), ok

    c_xy, c_ok = proj_xy(ic)
    px_xy, _ = proj_xy(ic + selq[..., 3:6])
    py_xy, _ = proj_xy(ic + selq[..., 6:9])
    tl, dx2, dy2, new_level, valid_safe = _window_tail(
        scene, c_xy, px_xy - c_xy, py_xy - c_xy, level, wsize
    )
    return tl, dx2, dy2, new_level, sel_ang & valid_safe & c_ok


def normalize_tex(tex, channels: int, s: int):
    """Zero-mean normalization (optim.cpp:917-940) of windows-major rows
    [..., channels * s]: per-channel mean over each block's s lanes,
    joint RMS over all channels * s lanes, values scaled by
    1/sqrt(channels * s) so ``tex_dot`` is the reference's mean dot."""
    shape = tex.shape
    x = tex.reshape(shape[:-1] + (channels, s))
    diff = x - x.sum(-1, keepdim=True) / s
    ssd = (diff * diff).sum((-2, -1), keepdim=True)
    cs = channels * s
    msd = torch.sqrt(ssd / cs)
    msd = torch.where(msd == 0.0, torch.ones_like(msd), msd)
    return (diff / (msd * math.sqrt(cs))).reshape(shape)


def tex_dot(tex0, tex1):
    """Mean elementwise product (optim.cpp:601-609) as a lane sum."""
    return (tex0 * tex1).sum(-1)


def window_batch(scene: Scene, views, coord, normal, level: int, wsize: int,
                 angle_threshold1: float):
    """The window geometry of a [B, T] view list sharing per-patch plane
    axes from the reference view views[:, 0] (optim.cpp:635-638).
    views == -1 marks padding. It does not depend on the illumination.
    Returns (idx, tl, dx2, dy2, new_level, valid), each [T, B, ...]."""
    ref = views[:, 0].clamp(min=0).long()
    pxaxis, pyaxis = cam.get_paxes(scene.cams, ref, coord, normal, level)
    views_t = views.T.contiguous()  # [T, B]
    tl, dx2, dy2, new_level, valid = window_geometry_views(
        scene, views_t, coord, pxaxis, pyaxis, normal, level, wsize,
        angle_threshold1,
    )
    return views_t.clamp(min=0), tl, dx2, dy2, new_level, valid & (views_t >= 0)


def texs_for_views_illums(
    scene: Scene,
    views,
    coord,
    normal,
    level: int,
    wsize: int,
    angle_threshold1: float,
    illums,
    luma: bool = False,
    group: int = 1,
):
    """``texs_for_views`` for each illumination in `illums`: the window
    geometry is computed once and the sampler runs once per
    illumination. Returns a list of (tex[T, B, L], valid[T, B])."""
    idx, tl, dx2, dy2, new_level, valid = window_batch(
        scene, views, coord, normal, level, wsize, angle_threshold1,
    )
    sample = (_sample_windows_view_sharded if scene.view_mesh is not None
              else sample_windows_raw)
    out = []
    for il in illums:
        tex, fit, channels = sample(
            scene, idx, tl, dx2, dy2, new_level, wsize, il, luma, group,
        )
        out.append((normalize_tex(tex, channels, wsize * wsize), valid & fit))
    return out


def texs_for_views(
    scene: Scene,
    views,
    coord,
    normal,
    level: int,
    wsize: int,
    angle_threshold1: float,
    illum: int = 0,
    luma: bool = False,
    group: int = 1,
):
    """Normalized windows for a [B, T] view list (see ``window_batch``).
    Returns (tex[T, B, L], valid[T, B]) with L = 3 * S, or S with `luma`
    (the luminance search of the opt-in luma_refine).

    group > 1 declares that every `group` consecutive rows are jittered
    candidates of one patch (same view rows): the sampler's grouped
    form then serves each (candidate group, view) together."""
    return texs_for_views_illums(
        scene, views, coord, normal, level, wsize, angle_threshold1,
        (illum,), luma, group,
    )[0]


def sample_windows_raw(
    scene: Scene, idx, tl, dx2, dy2, new_level, wsize: int, illum: int = 0,
    luma: bool = False, group: int = 1,
):
    """The sampling half of getTex on a [T, B] pair batch: raw windows
    from the window sampler (a CUDA tensor launches the kernel, a CPU
    tensor runs its plain version). Returns (tex[T, B, C * S],
    fit[T, B], channels), C = 1 with `luma` else 3. The [T, B] -> flat
    order is T-major, so a candidate group stays contiguous."""
    T, B = idx.shape
    out, fit = cuda_ncc.sample_windows(
        scene,
        idx.reshape(-1).to(torch.int32).contiguous(),
        new_level.reshape(-1).to(torch.int32).contiguous(),
        tl.reshape(-1, 2).contiguous(),
        dx2.reshape(-1, 2).contiguous(),
        dy2.reshape(-1, 2).contiguous(),
        wsize, illum=illum, group=group, luma=luma,
    )
    return out.reshape(T, B, out.shape[-1]), fit.reshape(T, B), 1 if luma else 3


# per view shard (its index on the view axis) and launch form: the
# sampler calls of the view-sharded path and their windows; and the host
# syncs it made (one per sampler call, for the shards' window counts)
SHARD_CALLS: collections.Counter = collections.Counter()
SHARD_WINDOWS: collections.Counter = collections.Counter()
SHARD_SYNCS = collections.Counter()


def reset_shard_stats() -> None:
    SHARD_CALLS.clear()
    SHARD_WINDOWS.clear()
    SHARD_SYNCS.clear()


def _sample_windows_view_sharded(
    scene: Scene, idx, tl, dx2, dy2, new_level, wsize: int, illum: int = 0,
    luma: bool = False, group: int = 1,
):
    """sample_windows_raw on a view-sharded scene (JAX ncc.py:427-500):
    each shard samples only the windows whose view it owns, on its own
    plane slice with local view indices, and the results go back into
    the home output (on idx's device) with ``index_copy_``.

    The windows are compacted, not masked: JAX samples the whole batch on
    every shard, zeroes the windows of other shards and psums k outputs
    of the batch's size; here each shard's launch covers its own windows
    only. A stable sort by shard keeps a shard's windows in batch order,
    and a candidate group (`group` consecutive windows of one patch at
    one view slot, pipeline/refine.py) is all on one shard, so the
    compacted batch launches grouped as the whole batch would. One host
    sync per call reads the shards' window counts. The result is bit for
    bit the unsharded one: every window is computed alone, by the same
    kernel or plain version.

    In a multi-process scene (``view_group``) this process holds only
    its own shards: the home output is zero outside their windows and
    one ``all_reduce`` sum over the group completes it
    (``parallel/multihost.all_reduce_sum``). The sum stays outside
    autograd, so a rank's graph reaches only its own windows; where the
    lattice requires grad, ``multihost.sum_grads`` sums its gradient
    over the group in the backward, so every rank takes the whole
    gradient."""
    T, B = idx.shape
    home = tl.device
    multi = scene.view_group is not None
    if multi:
        from ..parallel import multihost

        if any(t.requires_grad for t in (tl, dx2, dy2)):
            tl, dx2, dy2 = multihost.sum_grads(scene.view_group, tl, dx2, dy2)
    k = scene.view_mesh.shape[scene.view_axis]
    n_local = scene.n_images // k
    if n_local * k != scene.n_images:
        raise ValueError(f"n_images={scene.n_images} not divisible by {k} view shards")
    flat = idx.reshape(-1)
    shard_of = flat.long() // n_local
    order = torch.sort(shard_of, stable=True).indices
    counts = torch.bincount(shard_of, minlength=k)
    form = cuda_ncc.launch_form(flat.shape[0], group, luma, False)
    if not form.endswith("ungrouped"):
        g = shard_of.reshape(-1, group)
        mixed = (g != g[:, :1]).any().reshape(1)
    else:
        mixed = torch.zeros(1, dtype=counts.dtype, device=counts.device)
    *counts, mixed = torch.cat([counts, mixed.to(counts.dtype)]).tolist()
    SHARD_SYNCS["sampler"] += 1
    if mixed:
        raise AssertionError("a candidate group spans two view shards")
    C = 1 if luma else 3
    S = wsize * wsize
    shape = (flat.shape[0], C * S)
    out = (torch.zeros if multi else torch.empty)(shape, dtype=torch.float32, device=home)
    starts = [0]
    for c in counts:
        starts.append(starts[-1] + c)
    for sh in scene.view_shards:
        n = counts[sh.index]
        if n == 0:
            continue
        rows = order[starts[sh.index]:starts[sh.index] + n]
        dev = sh.scene.device
        take = lambda x, r=rows: x.reshape((-1,) + x.shape[2:]).index_select(0, r).to(dev).contiguous()  # noqa: E731
        part, _ = cuda_ncc.sample_windows(
            sh.scene, (take(idx) - sh.base).to(torch.int32),
            take(new_level).to(torch.int32), take(tl), take(dx2), take(dy2),
            wsize, illum=illum, group=group, luma=luma,
        )
        out.index_copy_(0, rows, part.to(home))
        key = (sh.index, cuda_ncc.launch_form(n, group, luma, False))
        SHARD_CALLS[key] += 1
        SHARD_WINDOWS[key] += n
    if multi:
        multihost.all_reduce_sum(out.detach(), scene.view_group)
    fit = torch.ones((T, B), dtype=torch.bool, device=home)
    return out.reshape(T, B, C * S), fit, C


def _off_ref(ok):
    """ok with row 0 (the reference view) cleared."""
    ok = ok.clone()
    ok[0] = False
    return ok


def incc_cost(tex, valid, minimum):
    """cost_func aggregation (optim.cpp:401-468, pairwise=0): unweighted
    mean of robustincc(1 - dot(ref, other)) over valid others; 2.0 when
    the reference window is invalid or fewer than minimum-1 others are
    valid. tex [T, B, L]; valid [T, B]; minimum [B] or scalar. -> [B]."""
    r = robustincc(1.0 - tex_dot(tex[:1], tex))  # [T, B]
    ok = _off_ref(valid & valid[:1])
    denom = ok.sum(0)
    ans = torch.where(ok, r, torch.zeros_like(r)).sum(0)
    cost = ans / torch.clamp(denom, min=1)
    minimum = torch.as_tensor(minimum, device=tex.device)
    two = torch.full_like(cost, 2.0)
    cost = torch.where(denom >= minimum - 1, cost, two)
    return torch.where(valid[0], cost, two)


def incc_weighted(tex, valid, weights, robust: bool = True):
    """computeINCC aggregation (optim.cpp:684-706): weighted mean of
    [robust]incc(1 - dot(ref, other)); 2.0 when no weight.
    tex [T, B, L]; weights batch-major [B, T]."""
    incc = 1.0 - tex_dot(tex[:1], tex)
    if robust:
        incc = robustincc(incc)
    w = weights.T
    ok = _off_ref(valid & valid[:1])
    zero = torch.zeros_like(incc)
    tw = torch.where(ok, w, zero).sum(0)
    score = torch.where(ok, incc * w, zero).sum(0)
    two = torch.full_like(tw, 2.0)
    score = torch.where(
        tw > 0.0, score / torch.where(tw == 0, torch.ones_like(tw), tw), two
    )
    return torch.where(valid[0], score, two)


def incc_vs_ref(tex, valid, robust: bool):
    """Per-view INCC against the reference view (optim.cpp:708-746):
    entry 0 is 0; invalid entries are 2. Returns batch-major [B, T]."""
    incc = 1.0 - tex_dot(tex[:1], tex)
    if robust:
        incc = robustincc(incc)
    out = torch.where(valid & valid[:1], incc, torch.full_like(incc, 2.0))
    out[0] = torch.where(
        valid[0], torch.zeros_like(out[0]), torch.full_like(out[0], 2.0)
    )
    return out.T


def incc_pairwise(tex, valid, robust: bool):
    """All-pairs INCC matrix [B, T, T] (optim.cpp:748-783); diagonal 0,
    invalid pairs 2. tex [T, B, L], valid [T, B]."""
    T = valid.shape[0]
    tb = tex.permute(1, 0, 2)                       # [B, T, L]
    incc = 1.0 - torch.bmm(tb, tb.transpose(1, 2))  # [B, T, T]
    if robust:
        incc = robustincc(incc)
    vb = valid.T
    pair_ok = vb.unsqueeze(2) & vb.unsqueeze(1)
    out = torch.where(pair_ok, incc, torch.full_like(incc, 2.0))
    eye = torch.eye(T, dtype=torch.bool, device=tex.device).unsqueeze(0)
    return torch.where(eye, torch.zeros_like(out), out)


def compute_units(scene: Scene, views, coord, normal, level: int):
    """Per-view footprint units (optim.cpp:109-132): getUnit /
    (ray . normal), BIG when the view sees the back side."""
    idx = views.clamp(min=0).long()
    unit = cam.get_unit(scene.cams, idx, coord.unsqueeze(1), level)
    ray = _unit_ray_to_camera(scene, idx, coord.unsqueeze(1))
    dot = _dot4(ray, normal.unsqueeze(1))
    big = torch.full_like(unit, BIG)
    unit = torch.where(
        dot > 0.0, unit / torch.where(dot > 0, dot, torch.ones_like(dot)), big
    )
    return torch.where(views >= 0, unit, big)


def compute_weights(scene: Scene, views, coord, normal, level: int):
    """Resolution-ratio weights (optim.cpp:942-948):
    w_i = min(1, unit_0 / unit_i), w_0 = 1."""
    units = compute_units(scene, views, coord, normal, level)
    w = torch.clamp(units[:, :1] / units, max=1.0)
    w[:, 0] = 1.0
    return w


def compute_patch_ncc_n(
    scene: Scene, views, coord, normal, level: int, wsize: int, tau: int,
    angle_threshold1: float, n_illums: int = 1,
):
    """compute_patch_ncc dispatching on the illumination count of the
    config (JAX ncc.py:592-614)."""
    if n_illums <= 1:
        return compute_patch_ncc(
            scene, views, coord, normal, level, wsize, tau, angle_threshold1
        )
    return compute_patch_ncc_illums(
        scene, views, coord, normal, level, wsize, tau, angle_threshold1
    )


def compute_patch_ncc_illums(
    scene: Scene, views, coord, normal, level: int, wsize: int, tau: int,
    angle_threshold1: float,
):
    """Multi-illumination NCC (JAX ncc.py:617-645): the weighted robust
    INCC of each illumination against the same geometry, averaged over
    the scene's illuminations. The geometry is computed once."""
    v = views[:, :tau]
    weights = compute_weights(scene, v, coord, normal, level)
    nviews = (views >= 0).sum(1)
    scores = []
    for tex, valid in texs_for_views_illums(
        scene, v, coord, normal, level, wsize, angle_threshold1,
        range(scene.n_illums),
    ):
        s = incc_weighted(tex, valid, weights, robust=True)
        scores.append(torch.where(nviews < 2, torch.full_like(s, 2.0), s))
    score = sum(scores) / len(scores)
    return 1.0 - unrobustincc(score)


def compute_patch_ncc(
    scene: Scene, views, coord, normal, level: int, wsize: int, tau: int,
    angle_threshold1: float,
):
    """PatchManager::computeNcc (patch_manager.cpp:401-404):
    ncc = 1 - unrobustincc(weighted robust INCC over the first tau
    views). views: [B, M] ordered view list (-1 pad). Returns ncc [B]."""
    v = views[:, :tau]
    weights = compute_weights(scene, v, coord, normal, level)
    tex, valid = texs_for_views(
        scene, v, coord, normal, level, wsize, angle_threshold1
    )
    nviews = (views >= 0).sum(1)
    score = incc_weighted(tex, valid, weights, robust=True)
    score = torch.where(nviews < 2, torch.full_like(score, 2.0), score)
    return 1.0 - unrobustincc(score)
