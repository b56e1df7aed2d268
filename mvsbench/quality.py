"""Quality of a point cloud against the scene's analytic surface.

A frozen copy of the arithmetic of ``mvskit_tpu_torch/utils/metrics.py``
(``accuracy_completeness``: nearest-neighbour distances, the share within
a threshold) and ``utils/synthetic.py`` (``surface_distance``) and of
``tools/e2e_run.py``'s ground truth (``quality``) at commit 9af5b6f, with
the Middlebury accuracy definition (the distance within which 90 % of
the cloud lies) in place of the mean:

- ``surface_distance``: each point's distance to the plane z = 0, or to
  the plane with the sphere resting on it;
- ``ground_truth``: the plane's 200 x 200 grid over [-1, 1]^2, or 40,000
  samples of the sphere scene that at least two views see;
- ``completeness``: the share of ground-truth samples with a cloud point
  within the threshold (nearest neighbours in float64, in blocks).
"""

from __future__ import annotations

import numpy as np
import torch

COMP_THRESHOLD = 0.05
ACC_QUANTILE = 0.9


def surface_distance(pts: np.ndarray, geometry: str, center, radius: float) -> np.ndarray:
    """Exact distance of each point [N, 3] to the analytic surface."""
    d = np.abs(pts[:, 2])
    if geometry != "sphere":
        return d
    d_sp = np.abs(np.linalg.norm(pts - np.asarray(center)[None, :], axis=1) - radius)
    return np.minimum(d, d_sp)


def ground_truth(geometry: str, Ps: np.ndarray, width: int, height: int, center,
                 radius: float) -> np.ndarray:
    """The completeness reference samples [N, 3] of the scene."""
    if geometry == "sphere":
        from .scene import rng_for, visible_surface_points

        pts, _ = visible_surface_points(Ps, 40000, True, rng_for(97), width, height,
                                        center=center, radius=radius)
        return pts
    g = np.linspace(-1.0, 1.0, 200)
    xs, ys = np.meshgrid(g, g)
    return np.stack([xs.ravel(), ys.ravel(), np.zeros(xs.size)], axis=1)


def nearest_distance(src: np.ndarray, dst: np.ndarray, device, block: int = 256) -> np.ndarray:
    """Distance from each src point to its nearest dst point, float64."""
    if dst.shape[0] == 0:
        return np.full(src.shape[0], np.inf)
    d = torch.as_tensor(dst, dtype=torch.float64, device=device)
    d2 = (d * d).sum(1)
    out = []
    for s in range(0, src.shape[0], block):
        q = torch.as_tensor(src[s:s + block], dtype=torch.float64, device=device)
        m = ((q * q).sum(1, keepdim=True) - 2.0 * q @ d.T + d2).min(1).values
        out.append(torch.sqrt(torch.clamp(m, min=0.0)).cpu())
    return torch.cat(out).numpy()


def accuracy(dist: np.ndarray) -> float:
    """The distance within which ACC_QUANTILE of the cloud lies."""
    return float(np.quantile(dist, ACC_QUANTILE)) if dist.size else float("inf")


def completeness(gt: np.ndarray, cloud: np.ndarray, device) -> float:
    """Percent of ground-truth samples within COMP_THRESHOLD of the cloud."""
    return 100.0 * float((nearest_distance(gt, cloud, device) < COMP_THRESHOLD).mean())


def read_patches(path: str):
    """A ``.patch`` file's patch centres [N, 3] and view counts [N]."""
    with open(path) as f:
        toks = f.read().split()
    if toks[0] not in ("PATCHES", "PATCHA"):
        raise ValueError(f"{path}: bad header {toks[0]!r}")
    n = int(toks[1])
    coord = np.empty((n, 3))
    nimg = np.empty(n, dtype=np.int64)
    pos = 2
    for i in range(n):
        pos += 1  # the per-patch PATCHES tag
        coord[i] = [float(t) for t in toks[pos:pos + 3]]
        pos += 11  # centre, normal (4 each), score and two scales
        k = int(toks[pos])
        nimg[i] = k
        pos += 1 + k
        pos += 1 + int(toks[pos])
    return coord, nimg
