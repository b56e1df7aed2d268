# Copy of mvskit_tpu/utils/metrics.py; the port imports nothing of mvskit_tpu.
"""Point-cloud evaluation metrics.

The benchmark criteria (BASELINE.md) are accuracy / completeness at a
distance threshold — the standard MVS measures (DTU/Tanks&Temples
style) the reference never implemented. Used by the end-to-end tests
(against analytic ground truth) and by dataset benchmarking.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np


def _nn_dist(src: np.ndarray, dst: np.ndarray, block: int = 2048) -> np.ndarray:
    """Nearest-neighbor distance from each src point to dst (brute
    force, blocked). src [N,3], dst [M,3] -> [N]."""
    if dst.shape[0] == 0:
        return np.full(src.shape[0], np.inf)
    out = np.empty(src.shape[0])
    d2_dst = np.sum(dst * dst, axis=1)
    for i in range(0, src.shape[0], block):
        s = src[i : i + block]
        d2 = (
            np.sum(s * s, axis=1)[:, None]
            - 2.0 * (s @ dst.T)
            + d2_dst[None, :]
        )
        out[i : i + block] = np.sqrt(np.maximum(d2.min(axis=1), 0.0))
    return out


def accuracy_completeness(
    cloud: np.ndarray,
    gt: np.ndarray,
    threshold: float,
    crop_to_gt_bbox: bool = False,
    bbox_margin: Optional[float] = None,
) -> Dict[str, float]:
    """DTU-style metrics:
      accuracy     — mean / median distance cloud -> ground truth, and
                     the fraction of cloud points within `threshold`;
      completeness — mean / median distance ground truth -> cloud, and
                     the fraction of ground-truth points covered.

    crop_to_gt_bbox: evaluate accuracy only on cloud points inside the
    ground truth's bounding box (+ `bbox_margin`, default `threshold`)
    — the DTU-evaluation convention (observation-volume crop), so a
    reconstruction legitimately extending beyond the sampled GT extent
    is not penalized. Completeness always uses the full cloud."""
    if crop_to_gt_bbox and cloud.shape[0] and gt.shape[0]:
        m = threshold if bbox_margin is None else bbox_margin
        lo, hi = gt.min(axis=0) - m, gt.max(axis=0) + m
        cloud_acc = cloud[np.all((cloud >= lo) & (cloud <= hi), axis=1)]
    else:
        cloud_acc = cloud
    d_acc = _nn_dist(cloud_acc, gt)
    d_comp = _nn_dist(gt, cloud)
    return {
        "acc_mean": float(d_acc.mean()) if d_acc.size else float("inf"),
        "acc_median": float(np.median(d_acc)) if d_acc.size else float("inf"),
        "acc_frac": float((d_acc < threshold).mean()) if d_acc.size else 0.0,
        "comp_mean": float(d_comp.mean()) if d_comp.size else float("inf"),
        "comp_median": float(np.median(d_comp)) if d_comp.size else float("inf"),
        "comp_frac": float((d_comp < threshold).mean()) if d_comp.size else 0.0,
        "n_cloud": int(cloud.shape[0]),
        "n_cloud_in_gt_bbox": int(cloud_acc.shape[0]),
        "n_gt": int(gt.shape[0]),
    }


def plane_rms(cloud: np.ndarray, plane_z: float = 0.0) -> float:
    """RMS distance to the synthetic ground-truth plane z = plane_z."""
    if cloud.shape[0] == 0:
        return float("inf")
    return float(np.sqrt(np.mean((cloud[:, 2] - plane_z) ** 2)))


def f_score(metrics: Dict[str, float]) -> float:
    """Harmonic mean of accuracy and completeness fractions
    (the Tanks & Temples F-score form)."""
    p, r = metrics["acc_frac"], metrics["comp_frac"]
    return 0.0 if p + r == 0 else 2.0 * p * r / (p + r)
