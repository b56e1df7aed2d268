"""Batched patch refinement (port of ``mvskit_tpu/pipeline/refine.py``).

The reference refines one patch at a time with BOBYQA over depth along
the ray and two normal angles (pmmvps/optim.cpp:470-599). Here, as in
the JAX package, thousands of patches refine together by random search
with a shrinking trust region over the same encoding and the same
robust-INCC objective (cost_func, optim.cpp:401-468). Every candidate
round is one batch through the window sampler; with ``group_dma`` the
round's candidates of one patch form one group of the sampler's grouped
form.

With ``luma`` the first rounds search on luminance (the opt-in
luma_refine) and the last ``rgb_tail`` rounds in RGB; with ``n_illums``
> 1 every cost averages over the illuminations. With ``grad_steps`` > 0
a gradient polish follows the search (JAX refine.py:277-300): the
objective is differentiable in the three encoded parameters through the
bilinear warp, on a card through the window sampler's backward kernel.

The search noise is injected: ``deltas`` [rounds, B, n_cands, 3] holds
uniform draws in [-1, 1), or, when absent, they are drawn from
``generator``. Round r uses deltas[r] in either mode, as the JAX
package uses its r-th split key.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..core.patches import count_valid
from ..image.scene import Scene
from ..ops import ncc as nccops
from ..utils import profiling

ANGLE_BOUND = 23.99999  # reference optim.cpp:496-497


def encode_normal(scene: Scene, ref, normal):
    """Normal -> two camera-frame angles (optim.cpp:553-580), radians."""
    n3 = normal[..., :3]
    fx = (scene.cams.xaxis[ref] * n3).sum(-1)
    fy = (scene.cams.yaxis[ref] * n3).sum(-1)
    fz = (scene.cams.zaxis[ref] * n3).sum(-1)
    a2 = torch.arcsin(fy.clamp(-1.0, 1.0))
    cosb = torch.cos(a2)
    zero = cosb == 0.0
    safe = torch.where(zero, torch.ones_like(cosb), cosb)
    sina = fx / safe
    cosa = -fz / safe
    a1 = torch.arccos(cosa.clamp(-1.0, 1.0))
    a1 = torch.where(sina < 0.0, -a1, a1)
    a1 = torch.where(zero, torch.zeros_like(a1), a1)
    return a1, a2


def decode_normal(scene: Scene, ref, angle1, angle2):
    """Two camera-frame angles -> world normal (optim.cpp:582-595)."""
    fx = torch.sin(angle1) * torch.cos(angle2)
    fy = torch.sin(angle2)
    fz = -torch.cos(angle1) * torch.cos(angle2)
    n3 = (
        scene.cams.xaxis[ref] * fx.unsqueeze(-1)
        + scene.cams.yaxis[ref] * fy.unsqueeze(-1)
        + scene.cams.zaxis[ref] * fz.unsqueeze(-1)
    )
    return torch.cat([n3, torch.zeros_like(n3[..., :1])], dim=-1)


def decode_coord(center, ray, dscale, v0):
    """depth parameter -> coordinate (optim.cpp:597-599)."""
    return center + (dscale * v0).unsqueeze(-1) * ray


class RefineResult(NamedTuple):
    coord: torch.Tensor    # [B, 4]
    normal: torch.Tensor   # [B, 4]
    ncc: torch.Tensor      # [B] final weighted ncc (1 - unrobustincc)
    cost: torch.Tensor     # [B] final cost_func value


def _eval_cost(scene, views, coord, normal, minimum, level, wsize,
               angle_threshold1, luma=False, group=1, n_illums=1):
    """cost_func (optim.cpp:401-468), averaged over the illuminations
    when n_illums > 1 (JAX refine.py:76-91)."""
    costs = [
        nccops.incc_cost(tex, valid, minimum)
        for tex, valid in nccops.texs_for_views_illums(
            scene, views, coord, normal, level, wsize, angle_threshold1,
            range(max(n_illums, 1)), luma, group,
        )
    ]
    return sum(costs) / len(costs)


def draw_deltas(generator: torch.Generator, rounds: int, B: int,
                n_cands: int, device) -> torch.Tensor:
    """Uniform search noise in [-1, 1), [rounds, B, n_cands, 3]."""
    u = torch.rand((rounds, B, n_cands, 3), generator=generator,
                   device=device, dtype=torch.float32)
    return u * 2.0 - 1.0


def refine_batch(
    scene: Scene,
    coord,
    normal,
    images,
    dscale,
    deltas: Optional[torch.Tensor] = None,
    *,
    level: int,
    wsize: int,
    tau: int,
    min_image_num: int,
    angle_threshold1: float,
    ascale: float,
    rounds: int,
    n_cands: int,
    shrink: float,
    init_depth_radius: float,
    init_angle_radius: float,
    grad_steps: int = 0,
    grad_lr: float = 0.5,
    group_dma: bool = True,
    luma: bool = False,
    rgb_tail: int = 0,
    n_illums: int = 1,
    generator: Optional[torch.Generator] = None,
) -> RefineResult:
    """Refine a batch of patches (Optim::refinePatch, optim.cpp:470-547).
    `images` is the fixed view list for the whole refinement; entry 0 is
    the reference view. Total cost evaluations per patch: rounds *
    n_cands; round 0's candidate 0 is the unperturbed start pose.

    luma: the first rounds - rgb_tail rounds score luminance windows,
    the last min(rgb_tail, rounds) rounds RGB (JAX refine.py:248-274).
    The first RGB round after luma rounds re-anchors: best_c resets to
    +inf and its candidate 0 is pinned to the incumbent pose. The final
    score is always RGB. rgb_tail < 0 with luma raises ValueError.

    deltas: [rounds, B, n_cands, 3] uniform noise in [-1, 1), scaled by
    each round's radius; drawn from `generator` when None.

    grad_steps: after the search, that many safeguarded steps along the
    normalised gradient of the summed cost (JAX refine.py:277-300): g =
    grad of sum(cost(best_p)), cand = best_p - grad_lr * g / |g| (angles
    clipped to +-ANGLE_BOUND), accepted per row where its cost beats the
    incumbent's. A row whose gradient is not finite keeps its pose (its
    candidate's comparison is false). The cost is taken at group 1, in
    luma with `luma`; on a card the gradient of the window sampler is
    its backward kernel (ops/cuda_ncc.SampleWindowsFn). With luma and
    min(rgb_tail, rounds) > 0 the search ends in RGB while the polish
    scores luma, so a step would compare a luma cost with an RGB
    incumbent (JAX refine.py:299): that raises ValueError."""
    if luma and rgb_tail < 0:
        raise ValueError(f"rgb_tail must be >= 0 with luma, got {rgb_tail}")
    if grad_steps > 0 and luma and min(rgb_tail, rounds) > 0:
        raise ValueError(
            "grad_steps > 0 with luma and rgb_tail > 0 would accept a luma cost against "
            "the RGB search's incumbent (JAX refine.py:299); set rgb_tail=0")
    B = coord.shape[0]
    dev = coord.device
    stats = profiling.POLISH  # None unless a caller records the polish
    mark_start = stats.mark(dev) if stats else None
    ref = images[:, 0].clamp(min=0).long()
    center = coord
    ray = center - scene.cams.center[ref]
    ray = ray / torch.sqrt(torch.clamp((ray * ray).sum(-1, keepdim=True), min=1e-20))
    views = images[:, :tau]
    nimg = count_valid(images)
    sz = torch.clamp(nimg, max=tau)
    minimum = torch.clamp(sz, max=min_image_num)
    safe_dscale = torch.where(dscale == 0.0, torch.ones_like(dscale), dscale)

    # weights frozen at the starting coordinate (optim.cpp:490)
    weights = nccops.compute_weights(scene, views, coord, normal, level)

    a1, a2 = encode_normal(scene, ref, normal)
    p0 = torch.stack(
        [torch.zeros_like(a1), a1 / ascale, a2 / ascale], dim=-1
    )
    p0[:, 1:] = p0[:, 1:].clamp(-ANGLE_BOUND, ANGLE_BOUND)

    best_p = p0
    best_c = torch.full((B,), float("inf"), dtype=torch.float32, device=dev)
    # filled on the device, with no host copy, so that a CUDA graph can
    # hold it
    radius = torch.full((3,), init_angle_radius, dtype=torch.float32, device=dev)
    radius[0].fill_(init_depth_radius)
    if rounds > 0 and deltas is None:
        if generator is None:
            raise ValueError("refine_batch needs deltas or a generator")
        deltas = draw_deltas(generator, rounds, B, n_cands, dev)
    if rounds > 0 and tuple(deltas.shape) != (rounds, B, n_cands, 3):
        raise ValueError(
            f"deltas must be {(rounds, B, n_cands, 3)}, got {tuple(deltas.shape)}"
        )

    rep = lambda x: x.repeat_interleave(n_cands, dim=0)  # noqa: E731
    center_r, ray_r, dscale_r = rep(center), rep(ray), rep(safe_dscale)
    ref_r, views_r, minimum_r = rep(ref), rep(views), rep(minimum)
    group = n_cands if group_dma else 1
    rows = torch.arange(B, device=dev)
    n1 = rounds - (min(rgb_tail, rounds) if luma else 0)  # luma rounds
    for r in range(rounds):
        if r == n1 and n1 > 0:
            # first RGB round after the luma rounds: luma and RGB costs
            # sit on different scales, so the search re-anchors
            best_c = torch.full_like(best_c, float("inf"))
        delta = deltas[r].to(device=dev, dtype=torch.float32) * radius
        if r == 0 or r == n1:
            # a segment's first round: candidate 0 is the incumbent pose
            delta = delta.clone()
            delta[:, 0, :] = 0.0
        cand = best_p.unsqueeze(1) + delta
        cand[:, :, 1:] = cand[:, :, 1:].clamp(-ANGLE_BOUND, ANGLE_BOUND)
        flat = cand.reshape(B * n_cands, 3)
        c = decode_coord(center_r, ray_r, dscale_r, flat[:, 0])
        n = decode_normal(scene, ref_r, flat[:, 1] * ascale, flat[:, 2] * ascale)
        costs = _eval_cost(
            scene, views_r, c, n, minimum_r, level, wsize, angle_threshold1,
            luma=luma and r < n1, group=group, n_illums=n_illums,
        ).reshape(B, n_cands)
        kbest = torch.argmin(costs, dim=1)
        cbest = costs[rows, kbest]
        pbest = cand[rows, kbest]
        improved = cbest < best_c
        best_p = torch.where(improved.unsqueeze(1), pbest, best_p)
        best_c = torch.where(improved, cbest, best_c)
        radius = radius * shrink

    def cost_of(p):
        c = decode_coord(center, ray, safe_dscale, p[:, 0])
        n = decode_normal(scene, ref, p[:, 1] * ascale, p[:, 2] * ascale)
        return _eval_cost(scene, views, c, n, minimum, level, wsize,
                          angle_threshold1, luma=luma, n_illums=n_illums)

    if rounds <= 0:  # degenerate budget: score the start pose only
        best_c = cost_of(p0)

    # the gradient polish: safeguarded accept-if-better steps
    mark_polish = stats.mark(dev) if stats else None
    for k in range(grad_steps):
        with torch.enable_grad():
            p = best_p.detach().requires_grad_()
            (g,) = torch.autograd.grad(cost_of(p).sum(), p)
        gn = torch.sqrt(torch.clamp((g * g).sum(-1, keepdim=True), min=1e-12))
        cand = best_p - grad_lr * g / gn
        cand[:, 1:] = cand[:, 1:].clamp(-ANGLE_BOUND, ANGLE_BOUND)
        c = cost_of(cand)
        improved = c < best_c
        best_p = torch.where(improved.unsqueeze(1), cand, best_p)
        best_c = torch.where(improved, c, best_c)
        if stats:
            stats.step(k, improved)
    mark_polished = stats.mark(dev) if stats else None

    out_coord = decode_coord(center, ray, safe_dscale, best_p[:, 0])
    out_normal = decode_normal(
        scene, ref, best_p[:, 1] * ascale, best_p[:, 2] * ascale
    )
    # final score: weighted robust INCC at the refined pose with the
    # frozen weights (optim.cpp:539), RGB always, averaged over the
    # illuminations
    scores = []
    for tex, valid in nccops.texs_for_views_illums(
        scene, views, out_coord, out_normal, level, wsize, angle_threshold1,
        range(max(n_illums, 1)),
    ):
        s = nccops.incc_weighted(tex, valid, weights, robust=True)
        scores.append(torch.where(nimg < 2, torch.full_like(s, 2.0), s))
    score = sum(scores) / len(scores)
    out_ncc = 1.0 - nccops.unrobustincc(score)
    if stats:
        stats.call(mark_start, mark_polish, mark_polished, stats.mark(dev))
    return RefineResult(out_coord, out_normal, out_ncc, best_c)
