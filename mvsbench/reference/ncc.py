"""Plain reference of the engine's scene load and photo-consistency score.

Written from the definitions the engine follows (PMVS-style patch NCC,
reference pmmvps/optim.cpp:34-84, 601-628, 684-706, 790-948 and
image/image.cpp:135-138, 268-298), in plain PyTorch, in the precision
``dtype`` names at every step:

- ``load_cameras``: CONTOUR camera files -> level-0 projections;
- ``load_planes``: binary PPM images -> image pyramids ([1 3 3 1]^2 / 64
  taps, zero outside the image, rounded to bytes per level), flattened
  per view and illumination as ``[n, I, total, 3]``;
- ``patch_ncc``: the weighted robust NCC of each patch over the first
  ``tau`` views of its image list, 1 - unrobustincc(score), 1.4 where
  the patch has no valid score.

Every arithmetic step runs in ``dtype``: float64 is the reference,
bfloat16 the control that the output check has to reject.
"""

from __future__ import annotations

import math
import os
from typing import NamedTuple, Tuple

import numpy as np
import torch

BIG = float(2**30)
BEHIND = -65535.0
_K1D = (1.0, 3.0, 3.0, 1.0)


class Cameras(NamedTuple):
    P: torch.Tensor        # [n, 3, 4]
    center: torch.Tensor   # [n, 4]
    xaxis: torch.Tensor    # [n, 3]
    ipscale: torch.Tensor  # [n]


class Planes(NamedTuple):
    planes: torch.Tensor   # [n, I, total, 3]
    offsets: Tuple[int, ...]
    widths: Tuple[int, ...]
    heights: Tuple[int, ...]


def read_contour(path: str) -> np.ndarray:
    """A CONTOUR camera file: 12 numbers, the 3x4 projection row-major."""
    with open(path) as f:
        toks = f.read().split()
    if toks[0] != "CONTOUR":
        raise ValueError(f"{path}: not a CONTOUR camera file")
    return np.array([float(t) for t in toks[1:13]], dtype=np.float64).reshape(3, 4)


def load_cameras(prefix: str, n_views: int, dtype=torch.float64, device="cpu") -> Cameras:
    """Cameras of views 0..n_views-1 from ``txt/%08d.txt``: the optical
    centre, the image x axis made orthogonal to the optical axis, and the
    sum of the focal lengths along the two image axes (ipscale), derived
    in float64 and then taken in `dtype`."""
    P = np.stack([read_contour(os.path.join(prefix, "txt", f"{i:08d}.txt"))
                  for i in range(n_views)])
    M, q = P[:, :, :3], P[:, :, 3]
    center = np.concatenate([-np.einsum("nij,nj->ni", np.linalg.inv(M), q),
                             np.ones((n_views, 1))], axis=1)
    z = P[:, 2, :3] / np.linalg.norm(P[:, 2, :3], axis=1, keepdims=True)
    y = np.cross(z, P[:, 0, :3])
    y /= np.linalg.norm(y, axis=1, keepdims=True)
    x = np.cross(y, z)
    ipscale = np.einsum("ni,ni->n", P[:, 0, :3], x) + np.einsum("ni,ni->n", P[:, 1, :3], y)

    def t(a):
        return torch.as_tensor(a, device=device).to(dtype)

    return Cameras(t(P), t(center), t(x), t(ipscale))


def read_ppm(path: str) -> np.ndarray:
    """A binary PPM (P6, maxval 255, no comments) as [H, W, 3] uint8."""
    with open(path, "rb") as f:
        data = f.read()
    toks, pos = [], 0
    while len(toks) < 4:
        while data[pos:pos + 1].isspace():
            pos += 1
        end = pos
        while not data[end:end + 1].isspace():
            end += 1
        toks.append(data[pos:end])
        pos = end
    if toks[0] != b"P6" or int(toks[3]) != 255:
        raise ValueError(f"{path}: not an 8-bit binary PPM")
    w, h = int(toks[1]), int(toks[2])
    body = np.frombuffer(data, dtype=np.uint8, count=w * h * 3, offset=pos + 1)
    return body.reshape(h, w, 3).copy()


def downsample(img: torch.Tensor) -> torch.Tensor:
    """One pyramid step of a [H, W, 3] image: the [1 3 3 1]^2 / 64 taps
    around (2y, 2x), taps outside the image count as 0 without
    renormalising, then rounded half up and clipped to a byte."""
    h, w = img.shape[:2]
    ho, wo = h // 2, w // 2
    pad = torch.zeros((h + 3, w + 3, 3), dtype=img.dtype, device=img.device)
    pad[1:1 + h, 1:1 + w] = img
    out = torch.zeros((ho, wo, 3), dtype=img.dtype, device=img.device)
    for i in range(4):
        for j in range(4):
            wgt = _K1D[i] * _K1D[j] / 64.0
            out = out + wgt * pad[i:i + 2 * ho:2, j:j + 2 * wo:2]
    return torch.clamp(torch.floor(out + 0.5), 0.0, 255.0)


def load_planes(prefix: str, n_views: int, n_illums: int, n_levels: int,
                dtype=torch.float64, device="cpu") -> Planes:
    """The pyramids of ``image/%04d%04d.ppm`` (view x illumination),
    flattened per level and concatenated: [n, I, total, 3] of `dtype`."""
    views = []
    for v in range(n_views):
        illums = []
        for il in range(n_illums):
            img = torch.as_tensor(read_ppm(os.path.join(prefix, "image", f"{v:04d}{il:04d}.ppm")),
                                  device=device).to(dtype)
            levels = [img]
            for _ in range(1, n_levels):
                levels.append(downsample(levels[-1]))
            illums.append(torch.cat([lv.reshape(-1, 3) for lv in levels]))
        views.append(torch.stack(illums))
    widths, heights = [levels[0].shape[1]], [levels[0].shape[0]]
    for _ in range(1, n_levels):
        widths.append(widths[-1] // 2)
        heights.append(heights[-1] // 2)
    offsets = [0]
    for w, h in zip(widths[:-1], heights[:-1]):
        offsets.append(offsets[-1] + w * h)
    return Planes(torch.stack(views), tuple(offsets), tuple(widths), tuple(heights))


def _norm(v, eps=1e-20):
    return torch.sqrt(torch.clamp((v * v).sum(-1), min=eps))


def project(cams: Cameras, view, X, level: int):
    """Pixel position at `level` of homogeneous points X [..., 4] in
    `view`, and whether they lie in front of the camera."""
    ic = (cams.P[view] * X.unsqueeze(-2)).sum(-1)
    z = ic[..., 2]
    ok = z > 0
    safe = torch.where(ok, z, torch.ones_like(z)) * (2.0 ** level)
    xy = (ic[..., :2] / safe.unsqueeze(-1)).clamp(-1e9, 1e9)
    return torch.where(ok.unsqueeze(-1), xy, torch.full_like(xy, BEHIND)), ok


def unit(cams: Cameras, view, coord, level: int):
    """Scene size of one pixel at `level` (optim.cpp:34-41)."""
    fz = _norm(coord - cams.center[view])
    ips = cams.ipscale[view]
    zero = ips == 0
    u = 2.0 * fz * (2.0 ** level) / torch.where(zero, torch.ones_like(ips), ips)
    return torch.where(zero, torch.ones_like(u), u)


def patch_axes(cams: Cameras, ref, coord, normal, level: int):
    """The patch plane's axes, one pixel long in the reference view
    (optim.cpp:67-84)."""
    ps = unit(cams, ref, coord, level).unsqueeze(-1)
    n3 = normal[..., :3]
    y3 = torch.linalg.cross(n3, cams.xaxis[ref], dim=-1)
    y3 = y3 / _norm(y3).unsqueeze(-1)
    x3 = torch.linalg.cross(y3, n3, dim=-1)
    zero = torch.zeros_like(x3[..., :1])
    px = torch.cat([x3, zero], -1) * ps
    py = torch.cat([y3, zero], -1) * ps
    c, _ = project(cams, ref, coord, level)
    cx, _ = project(cams, ref, coord + px, level)
    cy, _ = project(cams, ref, coord + py, level)
    return px / _norm(cx - c).unsqueeze(-1), py / _norm(cy - c).unsqueeze(-1)


def windows(cams: Cameras, pl: Planes, views, coord, normal, level: int, wsize: int,
            angle_deg: float, illum: int):
    """Each (view slot, patch) window [T, B, 3, S] on its resolved
    pyramid level, and whether it is valid [T, B] (optim.cpp:790-822):
    the patch faces the view within `angle_deg`, lies in front of it,
    and the window stays two pixels inside its level."""
    T, B = views.shape[1], views.shape[0]
    v = views.T.clamp(min=0).long()                          # [T, B]
    ref = views[:, 0].clamp(min=0).long()
    px, py = patch_axes(cams, ref, coord, normal, level)
    c4 = coord.unsqueeze(0).expand(T, B, 4)
    c_xy, c_ok = project(cams, v, c4, level)
    x_xy, _ = project(cams, v, c4 + px, level)
    y_xy, _ = project(cams, v, c4 + py, level)
    dx, dy = x_xy - c_xy, y_xy - c_xy
    diff = cams.center[v][..., :3] - c4[..., :3]
    facing = (diff * normal[:, :3]).sum(-1) / _norm(diff)
    ang_ok = torch.clamp(facing, min=0) >= math.cos(math.radians(angle_deg))

    ratio = (_norm(dx) + _norm(dy)) / 2.0
    shift = torch.nan_to_num(torch.floor(torch.log2(ratio) + 0.5), nan=0.0)
    shift = shift.clamp(-level, 2)
    scale = (2.0 ** shift).unsqueeze(-1)
    lvl = (level + shift).long()
    c2, dx2, dy2 = c_xy / scale, dx / scale, dy / scale
    m = wsize // 2
    half, halfy = dx2 * m, dy2 * m
    lo = c2 - half.abs() - halfy.abs()
    hi = c2 + half.abs() + halfy.abs()
    W = torch.tensor(pl.widths, device=coord.device)[lvl]
    H = torch.tensor(pl.heights, device=coord.device)[lvl]
    inside = ((lo[..., 0] >= 2) & (hi[..., 0] < (W - 3).to(hi.dtype))
              & (lo[..., 1] >= 2) & (hi[..., 1] < (H - 3).to(hi.dtype)))
    valid = ang_ok & inside & c_ok & (views.T >= 0)
    tl = c2 - half - halfy

    k = torch.arange(wsize, device=coord.device).to(coord.dtype)
    i, j = k.repeat(wsize), k.repeat_interleave(wsize)     # s = j * wsize + i
    gx = tl[..., :1] + dx2[..., :1] * i + dy2[..., :1] * j   # [T, B, S]
    gy = tl[..., 1:] + dx2[..., 1:] * i + dy2[..., 1:] * j
    gx, gy = torch.nan_to_num(gx).clamp(-1e6, 1e6), torch.nan_to_num(gy).clamp(-1e6, 1e6)
    Wl, Hl = W.unsqueeze(-1), H.unsqueeze(-1)
    lx = torch.minimum(torch.clamp(torch.trunc(gx).long(), min=0), Wl - 2)
    ly = torch.minimum(torch.clamp(torch.trunc(gy).long(), min=0), Hl - 2)
    fx = torch.clamp(gx - lx.to(gx.dtype), 0.0, 1.0)
    fy = torch.clamp(gy - ly.to(gy.dtype), 0.0, 1.0)
    off = torch.tensor(pl.offsets, device=coord.device)[lvl].unsqueeze(-1)
    n_il, total = pl.planes.shape[1], pl.planes.shape[2]
    base = (v.unsqueeze(-1) * n_il + illum) * total + off + ly * Wl + lx
    flat = pl.planes.reshape(-1, 3)
    tex = 0.0
    for d, wgt in ((0, (1 - fx) * (1 - fy)), (1, fx * (1 - fy)),
                   (Wl, (1 - fx) * fy), (Wl + 1, fx * fy)):
        tex = tex + flat[base + d] * wgt.unsqueeze(-1)
    return tex.permute(0, 1, 3, 2), valid                   # [T, B, 3, S]


def normalize(tex):
    """Zero mean per channel, unit joint RMS, scaled so that the sum of
    the product of two windows is their mean product (optim.cpp:917-940)."""
    cs = tex.shape[-1] * tex.shape[-2]
    diff = tex - tex.mean(-1, keepdim=True)
    msd = torch.sqrt((diff * diff).sum((-2, -1), keepdim=True) / cs)
    msd = torch.where(msd == 0, torch.ones_like(msd), msd)
    return diff / (msd * math.sqrt(cs))


def patch_ncc(cams: Cameras, pl: Planes, coord, normal, images, *, level: int, wsize: int,
              tau: int, angle_deg: float = 60.0, chunk: int = 4096):
    """The stored score of a patch (patch_manager.cpp:401-404): over the
    first `tau` views of `images` [B, M] (-1 padded, view 0 the
    reference), the robust INCC against the reference view weighted by
    min(1, unit_ref / unit_view), averaged over the illuminations, as
    1 - unrobustincc(score). Patches with fewer than two views, an
    invalid reference window or no valid other view score 2 (ncc 1.4).
    coord / normal [B, 4] in the planes' dtype. Returns [B]."""
    out = []
    for s in range(0, coord.shape[0], chunk):
        out.append(_patch_ncc(cams, pl, coord[s:s + chunk], normal[s:s + chunk],
                              images[s:s + chunk], level, wsize, tau, angle_deg))
    return torch.cat(out)


def _patch_ncc(cams, pl, coord, normal, images, level, wsize, tau, angle_deg):
    views = images[:, :tau]
    v = views.clamp(min=0).long()
    # weights from each view's footprint on the patch (optim.cpp:109-132, 942-948)
    ray = cams.center[v] - coord.unsqueeze(1)
    ray = ray / _norm(ray).unsqueeze(-1)
    facing = (ray * normal.unsqueeze(1)).sum(-1)
    u = unit(cams, v, coord.unsqueeze(1), level)
    big = torch.full_like(u, BIG)
    u = torch.where(facing > 0, u / torch.where(facing > 0, facing, torch.ones_like(facing)), big)
    u = torch.where(views >= 0, u, big)
    w = torch.clamp(u[:, :1] / u, max=1.0)
    w[:, 0] = 1.0
    w = w.T                                                   # [T, B]
    few = (images >= 0).sum(1) < 2
    scores = []
    for il in range(pl.planes.shape[1]):
        tex, valid = windows(cams, pl, views, coord, normal, level, wsize, angle_deg, il)
        tex = normalize(tex)
        incc = 1.0 - (tex[:1] * tex).sum((-2, -1))            # [T, B]
        r = incc / (1.0 + 3.0 * incc)
        ok = valid & valid[:1]
        ok[0] = False
        zero = torch.zeros_like(r)
        tw = torch.where(ok, w, zero).sum(0)
        sc = torch.where(ok, r * w, zero).sum(0)
        two = torch.full_like(tw, 2.0)
        score = torch.where(tw > 0, sc / torch.where(tw == 0, torch.ones_like(tw), tw), two)
        score = torch.where(valid[0] & ~few, score, two)
        scores.append(score)
    score = sum(scores) / len(scores)
    return 1.0 - score / (1.0 - 3.0 * score)


def max_abs_gap(a: torch.Tensor, b: torch.Tensor) -> float:
    """Largest |a - b| in float64 (inf where exactly one side is not finite)."""
    a, b = a.to(torch.float64), b.to(torch.float64)
    both = torch.isfinite(a) & torch.isfinite(b)
    gap = torch.where(both, (a - b).abs(), torch.full_like(a, math.inf))
    gap = torch.where(~torch.isfinite(a) & ~torch.isfinite(b), torch.zeros_like(a), gap)
    return float(gap.max()) if gap.numel() else 0.0


def level_count(level: int) -> int:
    """Pyramid levels the engine builds for a working level (pmmvps.cpp:36)."""
    return level + 3
