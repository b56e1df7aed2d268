"""Patch seeding (port of ``mvskit_tpu/pipeline/seed.py``).

Two paths, mirroring reference pmmvps/depth_normal_init.cpp:29-144:

  * resume from a ``ply/%08d.patch`` checkpoint (image ids translated to
    indices, unknown views dropped, vimages cleared);
  * a PLY seed cloud ``ply/00000000.ply`` plus per-view normal maps
    ``ply/%08d.ply``: one patch per seed visible in >= 2 views, averaged
    world normal, free-choice sortImages, scales and NCC computed.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from ..config import MVSConfig
from ..core import patches as pt
from ..image.scene import Scene
from ..io import patch_io, ply
from ..ops import ncc as nccops
from . import views as vw


def rq_decompose(M: np.ndarray):
    """M = K R with K upper-triangular (positive diagonal), R rotation
    (copied from mvskit_tpu/pipeline/seed.py, which imports jax)."""
    rev = M[::-1].T
    q, r = np.linalg.qr(rev)
    K = r.T[::-1, ::-1]
    R = q.T[::-1]
    # enforce positive diagonal on K
    s = np.sign(np.diag(K))
    s[s == 0] = 1.0
    K = K * s[None, :]
    R = R * s[:, None]
    if np.linalg.det(R) < 0:
        K = -K
        R = -R
    return K, R


def finalize_seeds(
    scene: Scene,
    cfg: MVSConfig,
    coord: np.ndarray,
    normal: np.ndarray,
    images: np.ndarray,
    ncc: Optional[np.ndarray] = None,
    dscale: Optional[np.ndarray] = None,
    ascale: Optional[np.ndarray] = None,
) -> pt.PatchTable:
    """Build the device patch table; fill any missing scales/scores.
    Patches that lost every view die immediately."""
    table = pt.from_numpy(
        coord, normal, images, cfg.max_patches, scene.n_images,
        scene.device, ncc=ncc, dscale=dscale, ascale=ascale,
    )
    n = coord.shape[0]
    c, nm, im = table.coord[:n], table.normal[:n], table.images[:n]
    if dscale is None or ascale is None:
        ds, asc = vw.set_scales(scene, c, im, cfg.level, cfg.tau, cfg.wsize)
        table.dscale[:n] = ds
        table.ascale[:n] = asc
    if ncc is None:
        table.ncc[:n] = nccops.compute_patch_ncc_n(
            scene, im, c, nm, cfg.level, cfg.wsize, cfg.tau,
            cfg.angle_threshold1,
            n_illums=scene.n_illums if cfg.use_illums else 1,
        )
    return table._replace(alive=table.alive & (pt.count_valid(table.images) > 0))


def seed_from_patch_file(scene: Scene, cfg: MVSConfig, path: str) -> pt.PatchTable:
    data = patch_io.read_patch_file(path)
    id2idx = {img: i for i, img in enumerate(cfg.images)}

    keep, imgs = [], []
    for i, lst in enumerate(data["images"]):
        translated = [id2idx[v] for v in lst if v in id2idx]
        if translated:
            keep.append(i)
            imgs.append(translated)
    keep = np.asarray(keep, dtype=np.int64)
    if len(keep) == 0:
        raise ValueError(f"no usable patches in {path}")
    images = patch_io.lists_to_padded(imgs, scene.n_images)
    return finalize_seeds(
        scene, cfg,
        data["coord"][keep].astype(np.float32),
        data["normal"][keep].astype(np.float32),
        images,
        ncc=data["ncc"][keep].astype(np.float32),
        dscale=data["dscale"][keep].astype(np.float32),
        ascale=data["ascale"][keep].astype(np.float32),
    )


def _seed_chunk(
    coord: np.ndarray,
    P_host: np.ndarray,
    nmaps: np.ndarray,
    have_map: np.ndarray,
    masks0,
    w0: int,
    h0: int,
    n_images: int,
):
    """Vectorized per-seed work for one chunk (depth_normal_init.cpp:
    36-94; copied from mvskit_tpu/pipeline/seed.py, which imports jax):
    project into every view, gate by bounds/mask, average the per-view
    world normals, keep seeds with >= 2 views and a nonzero normal.
    Returns (coord, normal, images_padded) for the survivors."""
    ic = np.einsum("nij,sj->nsi", P_host, coord.astype(np.float64))
    z = ic[:, :, 2]
    with np.errstate(divide="ignore", invalid="ignore"):
        x = np.floor(ic[:, :, 0] / z + 0.5).astype(np.int64)
        y = np.floor(ic[:, :, 1] / z + 0.5).astype(np.int64)
    inb = (z > 0) & (x >= 0) & (x < w0) & (y >= 0) & (y < h0)
    xs = np.clip(x, 0, w0 - 1)
    ys = np.clip(y, 0, h0 - 1)
    if masks0 is not None:
        mask_ok = masks0[np.arange(n_images)[:, None], ys, xs] > 0
        inb &= mask_ok

    contrib = nmaps[np.arange(n_images)[:, None], ys, xs]  # [n, S, 3]
    w = (inb & have_map[:, None])[..., None]
    nsum = np.sum(np.where(w, contrib, 0.0), axis=0)       # [S, 3]
    nview = inb.sum(axis=0)
    nrm = np.linalg.norm(nsum, axis=1)
    keep = (nview >= 2) & (nrm > 0)
    if not keep.any():
        return None
    n3 = nsum[keep] / nrm[keep][:, None]
    ckeep = coord[keep]
    normal = np.concatenate(
        [n3, -np.sum(ckeep[:, :3] * n3, axis=1, keepdims=True)], axis=1
    ).astype(np.float32)
    inbk = inb[:, keep].T  # [K, n_images]
    slot = np.cumsum(inbk, axis=1) - 1
    images = np.full((inbk.shape[0], n_images), -1, np.int32)
    rows, cols = np.nonzero(inbk)
    images[rows, slot[rows, cols]] = cols
    return ckeep, normal, images


def seed_from_plys(scene: Scene, cfg: MVSConfig, prefix: str,
                   chunk: int = 1 << 18) -> pt.PatchTable:
    seed_path = os.path.join(prefix, "ply", "00000000.ply")
    pts = ply.read_ply(seed_path)["xyz"]
    n_seeds = pts.shape[0]
    coord = np.concatenate([pts, np.ones((n_seeds, 1))], axis=1).astype(np.float32)

    w0, h0 = scene.width(0), scene.height(0)
    P_host = scene.cams.P.detach().cpu().numpy().astype(np.float64)
    nmaps = np.zeros((scene.n_images, h0, w0, 3), dtype=np.float32)
    have_map = np.zeros(scene.n_images, dtype=bool)
    for i in range(scene.n_images):
        p = os.path.join(prefix, "ply", f"{i + 1:08d}.ply")
        if not os.path.exists(p):
            continue
        d = ply.read_ply(p)
        if "normal" not in d:
            continue
        _, R = rq_decompose(P_host[i][:, :3])
        world = d["normal"] @ R.T  # reference: R * normal3
        x = d["xyz"][:, 0].astype(np.int64)
        y = d["xyz"][:, 1].astype(np.int64)
        ok = (x >= 0) & (x < w0) & (y >= 0) & (y < h0)
        nmaps[i, y[ok], x[ok]] = world[ok]
        have_map[i] = True

    masks0 = None
    if scene.masks is not None:
        masks0 = scene.masks[:, : w0 * h0].cpu().numpy().reshape(
            scene.n_images, h0, w0
        )

    parts = []
    for off in range(0, n_seeds, chunk):
        r = _seed_chunk(coord[off : off + chunk], P_host, nmaps, have_map,
                        masks0, w0, h0, scene.n_images)
        if r is not None:
            parts.append(r)
    if not parts:
        raise ValueError(f"no seeds with >=2 visible views in {seed_path}")
    coord_a = np.concatenate([p[0] for p in parts]).astype(np.float32)
    normal_a = np.concatenate([p[1] for p in parts]).astype(np.float32)
    images = np.concatenate([p[2] for p in parts])

    # free-choice reference view ordering (sortImages isFixed=0,
    # depth_normal_init.cpp:78)
    dev = scene.device
    images_t = vw.sort_images(
        scene, torch.as_tensor(coord_a, device=dev),
        torch.as_tensor(normal_a, device=dev),
        torch.as_tensor(images, device=dev), cfg.level, is_fixed=False,
    )
    return finalize_seeds(scene, cfg, coord_a, normal_a, images_t.cpu().numpy())


def seed(scene: Scene, cfg: MVSConfig, prefix: str, resume_iter: int = 0) -> pt.PatchTable:
    """DepthNormInit::createPatches: prefer the .patch checkpoint."""
    patch_path = os.path.join(prefix, "ply", f"{resume_iter:08d}.patch")
    if os.path.exists(patch_path):
        return seed_from_patch_file(scene, cfg, patch_path)
    return seed_from_plys(scene, cfg, prefix)
