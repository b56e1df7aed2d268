"""Scene container: cameras + image pyramids + masks as dense tensors
(port of ``mvskit_tpu/image/scene.py``).

Pyramid levels are flattened and concatenated per view, so a
per-sample pyramid level is index arithmetic:

    planes[v, illum, offsets[l] + y * widths[l] + x, :]

``planes_packed`` holds the same pixels as ``r | g << 8 | b << 16``
int32 (lossless: every level is u8-quantized). ``planes_luma_quad``
holds, per pixel, the u8 luminances of its 2x2 bilinear support packed
into one int32. They are the operands of the CUDA window sampler's RGB
and luma forms, which read them flat; the JAX package's (8,128)-padded
per-level kernel planes have no counterpart here.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..geometry.camera import CameraSet, load_camera_set, make_camera_set
from ..utils import profiling
from . import decode

# ----------------------------------------------------------------------
# pyramid construction (host side, numpy). level_dims, downsample_once,
# build_pyramid, build_mask_pyramid and load_visdata are copied from
# mvskit_tpu/image/scene.py, which imports jax.
# ----------------------------------------------------------------------

_K1D = np.array([1.0, 3.0, 3.0, 1.0])
_K2D = np.outer(_K1D, _K1D) / 64.0


def level_dims(width: int, height: int, max_level: int) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """Per-level dims by successive halving (reference image.cpp:135-138)."""
    ws, hs = [width], [height]
    for _ in range(1, max_level):
        ws.append(ws[-1] // 2)
        hs.append(hs[-1] // 2)
    return tuple(ws), tuple(hs)


def downsample_once(img: np.ndarray, filter: int = 0) -> np.ndarray:
    """One pyramid level step on a [H, W, C] float image.

    filter mirrors the reference (image.cpp:284-298):
      0 = [1 3 3 1]^2 weighted average (the live path),
      1 = max over the 4x4 support,
      2 = min over the 4x4 support.
    Returns the unquantized float result (caller re-quantizes)."""
    h, w = img.shape[:2]
    ho, wo = h // 2, w // 2
    # reference image.cpp:268-277: taps outside [0, h-1] x [0, w-1] are
    # skipped with no weight renormalization; the last parent row/col
    # (ytmp == h-1) DOES contribute (the guard is `h - 1 < ytmp`).
    # Zero/255 padding reproduces the skip exactly.
    src = np.array(img, dtype=np.float32)
    fill = 0.0 if filter != 2 else 255.0
    pad = np.full((h + 3, w + 3) + img.shape[2:], fill, dtype=np.float32)
    pad[1 : 1 + h, 1 : 1 + w] = src
    if filter == 0:
        out = np.zeros((ho, wo) + img.shape[2:], dtype=np.float32)
    elif filter == 1:
        out = np.zeros((ho, wo) + img.shape[2:], dtype=np.float32)
    else:
        out = np.full((ho, wo) + img.shape[2:], 255.0, dtype=np.float32)
    for i in range(-1, 3):
        for j in range(-1, 3):
            tap = pad[
                1 + i : 1 + i + 2 * ho : 2, 1 + j : 1 + j + 2 * wo : 2
            ]
            if filter == 0:
                out += _K2D[i + 1, j + 1] * tap
            elif filter == 1:
                out = np.maximum(out, tap)
            else:
                out = np.minimum(out, tap)
    return out


def build_pyramid(
    img_u8: np.ndarray, max_level: int, filter: int = 0
) -> List[np.ndarray]:
    """Full image pyramid, re-quantized to uint8 values per level
    (kept as float32 for the device)."""
    levels = [np.asarray(img_u8, dtype=np.float32)]
    for _ in range(1, max_level):
        down = downsample_once(levels[-1], filter)
        down = np.clip(np.floor(down + 0.5), 0.0, 255.0)
        levels.append(down.astype(np.float32))
    return levels


def build_mask_pyramid(mask_u8: np.ndarray, max_level: int) -> List[np.ndarray]:
    """OR-dilating mask pyramid (reference image.cpp:717-747)."""
    levels = [np.asarray(mask_u8, dtype=np.uint8)]
    for _ in range(1, max_level):
        prev = levels[-1]
        h, w = prev.shape
        ho, wo = h // 2, w // 2
        ys0 = 2 * np.arange(ho)
        ys1 = np.minimum(h - 1, ys0 + 1)
        xs0 = 2 * np.arange(wo)
        xs1 = np.minimum(w - 1, xs0 + 1)
        acc = (
            prev[np.ix_(ys0, xs0)].astype(np.int32)
            + prev[np.ix_(ys0, xs1)]
            + prev[np.ix_(ys1, xs0)]
            + prev[np.ix_(ys1, xs1)]
        )
        levels.append(np.where(acc > 0, 255, 0).astype(np.uint8))
    return levels


def load_visdata(path: str, image_ids: Sequence[int]) -> Optional[np.ndarray]:
    """Parse a PMVS-style vis.dat covisibility file:
        VISDATA
        <n>
        <id> <k> <id_0> ... <id_{k-1}>   (one row per image)
    Returns [n, n] bool over the configured image list (diagonal True),
    or None if the file does not exist (option.cpp:167-169 leaves this
    branch unimplemented in the reference)."""
    if not os.path.exists(path):
        return None
    with open(path) as f:
        toks = f.read().split()
    if not toks or toks[0] != "VISDATA":
        raise ValueError(f"bad vis.dat header in {path}")
    id2idx = {img: i for i, img in enumerate(image_ids)}
    n = len(image_ids)
    covis = np.eye(n, dtype=bool)
    pos = 1
    count = int(toks[pos]); pos += 1
    for _ in range(count):
        img = int(toks[pos]); k = int(toks[pos + 1]); pos += 2
        row = [int(v) for v in toks[pos : pos + k]]; pos += k
        if img not in id2idx:
            continue
        i = id2idx[img]
        for v in row:
            if v in id2idx:
                covis[i, id2idx[v]] = True
    return covis


# ----------------------------------------------------------------------
# Scene
# ----------------------------------------------------------------------


@dataclasses.dataclass
class Scene:
    """All per-scene device state.

    planes        [n, I, total, 3] f32 — flattened pyramids
    masks         [n, total] f32 in {0, 255}, or None
    cams          CameraSet
    lvl_offsets / lvl_widths / lvl_heights [L] int32 device copies of
    the static `offsets` / `widths` / `heights` tuples
    planes_packed [n, I, total] int32 — r | g << 8 | b << 16
    planes_luma_quad [n, I, total] int32 — y00 | y10 << 8 | y01 << 16
                  | y11 << 24, the luminances of each pixel's 2x2
                  bilinear support (x+1 / y+1 clamped at level edges)
    covis         optional [n, n] bool covisibility (vis.dat)

    The fields that the JAX package's Scene also has come in its order
    (it has the Pallas level planes besides, which the port does not
    read); the port's own fields follow, keyword-only.

    View sharding (``parallel/shard.enable_view_sharding``, JAX
    ``image/scene.py:173-174``): ``view_mesh`` / ``view_axis`` name the
    mesh axis the planes are sharded over, and ``view_shards`` holds one
    ``ViewShard`` per shard this process samples (its planes on its
    device). Every window fetch of ``ops/ncc.texs_for_views_illums``
    then runs on the shards (``ops/ncc._sample_windows_view_sharded``).
    ``view_group`` is the ``torch.distributed`` group whose ranks hold
    the other shards (``parallel/multihost``), or None in one process.

    ``use_kernel`` says whether the window fetches of a CUDA scene
    launch the sampler's kernel (True, the default) or run its plain
    version (False; the JAX package's ``enable_pallas`` is this switch,
    and ``PMMVS`` sets it from ``cfg.use_pallas``, as JAX
    ``driver.py:81`` does). A CPU scene always runs the plain version.
    """

    planes: torch.Tensor
    masks: Optional[torch.Tensor]
    cams: CameraSet
    lvl_offsets: torch.Tensor
    lvl_widths: torch.Tensor
    lvl_heights: torch.Tensor
    planes_packed: torch.Tensor
    planes_luma_quad: torch.Tensor
    covis: Optional[torch.Tensor] = None
    widths: Tuple[int, ...] = ()
    heights: Tuple[int, ...] = ()
    offsets: Tuple[int, ...] = ()
    max_level: int = 0
    view_mesh: Optional[object] = None
    view_axis: str = "view"
    # the port's own fields, keyword-only
    view_shards: Tuple["ViewShard", ...] = dataclasses.field(default=(), kw_only=True)
    view_group: Optional[object] = dataclasses.field(default=None, kw_only=True)
    use_kernel: bool = dataclasses.field(default=True, kw_only=True)

    @property
    def device(self) -> torch.device:
        return self.planes.device

    @property
    def n_images(self) -> int:
        # from the cameras: a multi-process view-sharded scene holds no
        # planes of other processes' views (parallel/multihost.py)
        return self.cams.P.shape[0]

    @property
    def n_illums(self) -> int:
        return self.planes.shape[1]

    @property
    def has_mask(self) -> bool:
        return self.masks is not None

    def width(self, level: int) -> int:
        return self.widths[level]

    def height(self, level: int) -> int:
        return self.heights[level]


@dataclasses.dataclass(frozen=True)
class ViewShard:
    """One shard of a view-sharded scene: its position on the view axis,
    its first view, and a Scene of its views (planes ``[base:base +
    count]``, cameras and level metadata replicated) on its device. On
    the home device the planes are views of the home scene's tensors,
    not copies."""

    index: int
    base: int
    scene: Scene


def pairwise_view_distances(scene: Scene) -> np.ndarray:
    """PhotoSet::setDistances (reference photoSet.cpp:105-148): optical
    center distances normalized by their mean, plus an angular penalty
    max(0, 1 - axis_i . axis_j - cos 10deg). A scene statistic; nothing
    in the pipeline reads it. The [n, 4] centres and axes are copied to
    the host (from mvskit_tpu/image/scene.py, which imports jax)."""
    centers = scene.cams.center.cpu().numpy()[:, :3]
    n = centers.shape[0]
    diff = centers[:, None, :] - centers[None, :, :]
    dist = np.linalg.norm(diff, axis=-1)
    off = ~np.eye(n, dtype=bool)
    denom = off.sum()
    if denom == 0:
        return dist
    avedis = dist[off].mean()
    if avedis == 0.0:
        raise ValueError("all the optical centers are identical")
    dist = dist / avedis
    axes = scene.cams.oaxis.cpu().numpy()[:, :3]
    margin = np.cos(np.deg2rad(10.0))
    ang = np.maximum(0.0, 1.0 - axes @ axes.T - margin)
    return dist + ang


def pack_rgb(planes: np.ndarray) -> np.ndarray:
    """[..., 3] u8-valued float planes -> [...] int32 r | g<<8 | b<<16."""
    return (
        planes[..., 0].astype(np.int32)
        | (planes[..., 1].astype(np.int32) << 8)
        | (planes[..., 2].astype(np.int32) << 16)
    )


def pack_luma_quad(planes: np.ndarray, offsets: Sequence[int],
                   widths: Sequence[int], heights: Sequence[int]) -> np.ndarray:
    """[n, I, total, 3] u8-valued float planes -> [n, I, total] int32
    luma quads (copied from mvskit_tpu/image/scene.py:304-322): luma =
    clip(round(0.299 r + 0.587 g + 0.114 b), 0, 255); each pixel packs
    y(x, y) | y(x+1, y) << 8 | y(x, y+1) << 16 | y(x+1, y+1) << 24 with
    x+1 / y+1 clamped at its level's edge."""
    n, n_illums = planes.shape[:2]
    luma = np.clip(np.round(
        0.299 * planes[..., 0] + 0.587 * planes[..., 1]
        + 0.114 * planes[..., 2]
    ), 0, 255).astype(np.int32)
    lq = np.zeros_like(luma)
    for o, wl, hl in zip(offsets, widths, heights):
        lv = luma[..., o : o + wl * hl].reshape(n, n_illums, hl, wl)
        xp = np.minimum(np.arange(wl) + 1, wl - 1)
        yp = np.minimum(np.arange(hl) + 1, hl - 1)
        q = (
            lv
            | (lv[..., :, xp] << 8)
            | (lv[..., yp, :] << 16)
            | (lv[..., yp, :][..., :, xp] << 24)
        )
        lq[..., o : o + wl * hl] = q.reshape(n, n_illums, -1)
    return lq


def scene_from_planes(
    planes: np.ndarray,
    planes_packed: np.ndarray,
    masks: Optional[np.ndarray],
    cams: CameraSet,
    offsets: Sequence[int],
    widths: Sequence[int],
    heights: Sequence[int],
    max_level: int,
    device,
    planes_luma_quad: Optional[np.ndarray] = None,
) -> Scene:
    """Copy host-built planes onto `device` as a Scene (the luma quads
    are built from `planes` unless given)."""
    dev = torch.device(device)

    def i32(a):
        with profiling.sync("scene.copy"):
            return torch.tensor(np.asarray(a, dtype=np.int32), device=dev)

    def f32(a):
        with profiling.sync("scene.copy"):
            return torch.tensor(np.asarray(a, np.float32), device=dev)

    if planes_luma_quad is None:
        planes_luma_quad = pack_luma_quad(
            np.asarray(planes, np.float32), offsets, widths, heights)
    return Scene(
        planes=f32(planes),
        planes_packed=i32(planes_packed),
        planes_luma_quad=i32(planes_luma_quad),
        masks=None if masks is None else f32(masks),
        cams=cams,
        lvl_offsets=i32(offsets),
        lvl_widths=i32(widths),
        lvl_heights=i32(heights),
        widths=tuple(int(v) for v in widths),
        heights=tuple(int(v) for v in heights),
        offsets=tuple(int(v) for v in offsets),
        max_level=int(max_level),
    )


def scene_from_arrays(
    projections: np.ndarray,
    images: Sequence[np.ndarray],
    masks: Optional[Sequence[Optional[np.ndarray]]] = None,
    max_level: int = 4,
    cams: Optional[CameraSet] = None,
    device="cuda",
) -> Scene:
    """Build a Scene from in-memory arrays (pyramids built host-side,
    as ``mvskit_tpu.image.scene.scene_from_arrays`` builds them).

    images: per view either [H, W, 3] or [n_illums, H, W, 3] uint8.
    All views must share dimensions."""
    imgs = []
    for im in images:
        a = np.asarray(im)
        if a.ndim == 3:
            a = a[None]
        imgs.append(a)
    n = len(imgs)
    n_illums = imgs[0].shape[0]
    h, w = imgs[0].shape[1:3]
    for a in imgs:
        if a.shape != (n_illums, h, w, 3):
            raise ValueError("all views must share dims")

    ws, hs = level_dims(w, h, max_level)
    offsets = []
    total = 0
    for l in range(max_level):
        offsets.append(total)
        total += ws[l] * hs[l]

    planes = np.zeros((n, n_illums, total, 3), dtype=np.float32)
    for v in range(n):
        for il in range(n_illums):
            pyr = build_pyramid(imgs[v][il], max_level)
            for l in range(max_level):
                planes[v, il, offsets[l] : offsets[l] + ws[l] * hs[l]] = pyr[
                    l
                ].reshape(-1, 3)

    mask_arr = None
    if masks is not None and any(m is not None for m in masks):
        mask_arr = np.full((n, total), 255.0, dtype=np.float32)
        for v in range(n):
            if masks[v] is None:
                continue
            mpyr = build_mask_pyramid(masks[v], max_level)
            for l in range(max_level):
                mask_arr[v, offsets[l] : offsets[l] + ws[l] * hs[l]] = (
                    mpyr[l].reshape(-1).astype(np.float32)
                )

    if cams is None:
        cams = make_camera_set(projections, device)
    return scene_from_planes(
        planes, pack_rgb(planes), mask_arr, cams, offsets, ws, hs,
        max_level, device,
    )


def load_scene(
    prefix: str,
    image_ids: Sequence[int],
    nillums: int,
    max_level: int,
    use_vis_data: bool = False,
    device="cuda",
) -> Scene:
    """Load a scene from the reference dataset directory contract
    (reference photoSet.cpp:20-61):

      image/%04d%04d.{jpg,ppm,png,tiff}  view x illumination
      txt/%08d.txt                       CONTOUR camera files
      mask/%08d.{pgm,pbm}                optional masks

    The recorder sees span ``load``, and in it ``decode`` (the files)
    and ``pyramid`` (the pyramids built and moved to the device).
    """
    with profiling.span("load"):
        n = len(image_ids)
        cam_paths = [os.path.join(prefix, "txt", f"{i:08d}.txt") for i in range(n)]
        cams = load_camera_set(cam_paths, device)

        images = []
        masks = []
        with profiling.span("decode"):
            for i in range(n):
                illums = []
                for il in range(nillums):
                    base = os.path.join(prefix, "image", f"{i:04d}{il:04d}")
                    path = None
                    for ext in (".jpg", ".jpeg", ".ppm", ".png", ".tiff"):
                        if os.path.exists(base + ext):
                            path = base + ext
                            break
                    if path is None:
                        raise FileNotFoundError(f"no image for view {i} illum {il}: {base}.*")
                    illums.append(decode.load_rgb(path))
                images.append(np.stack(illums))
                masks.append(decode.load_mask(os.path.join(prefix, "mask", f"{i:08d}")))

        with profiling.span("pyramid"):
            scene = scene_from_arrays(
                projections=None, images=images, masks=masks,
                max_level=max_level, cams=cams, device=device,
            )
        if use_vis_data:
            covis = load_visdata(os.path.join(prefix, "vis.dat"), image_ids)
            if covis is not None:
                with profiling.sync("scene.copy"):
                    covis = torch.as_tensor(covis, device=scene.device)
                scene = dataclasses.replace(scene, covis=covis)
        return scene
