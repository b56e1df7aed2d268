"""The NCC window sampler: CUDA kernel wrapper and its plain versions.

Counterpart of ``mvskit_tpu/ops/pallas_ncc.py`` (``sample_windows``,
``_make_kernel``). For each window it returns the raw bilinear samples
of a wsize x wsize lattice ``tl + i * dx + j * dy`` on the window's
pyramid level, plus a ``fit`` mask that is all true: the kernel reads
every tap exactly, so no window overflows a tile. RGB rows are
``[B, 3 * S]`` (S = wsize^2, channel c in lanes ``[c * S, (c + 1) * S)``)
from ``Scene.planes_packed``; luma rows (``luma=True``) are ``[B, S]``
from ``Scene.planes_luma_quad``.

``sample_windows`` routes by device: a CUDA tensor launches the kernel
of ``csrc/sample_windows.cu`` (ungrouped, or grouped when ``group`` > 1
divides the batch), a CPU tensor runs the plain version
(``sample_windows_plain`` / ``sample_windows_luma_plain``), the same
arithmetic on the gather path. ``LAUNCHES`` counts kernel launches per
form.
"""

from __future__ import annotations

import ctypes

import torch

from ..image.scene import Scene
from . import sampling

LAUNCHES = {"ungrouped": 0, "grouped": 0, "luma_ungrouped": 0,
            "luma_grouped": 0}

# the TPU kernel's grouped form needs group | 128 (W_BLK); the same
# rule picks the launch form here (pallas_ncc.py:609-610)
_W_BLK = 128


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def lattice(tl, dx, dy, wsize: int):
    """Sample coordinates [B, S] of each window's lattice,
    s = j * wsize + i -> tl + dx * i + dy * j (JAX ncc.py:408-412)."""
    xs = torch.arange(wsize, dtype=torch.float32, device=tl.device)
    lat_x = xs.repeat(wsize).unsqueeze(0)              # i = s % wsize
    lat_y = xs.repeat_interleave(wsize).unsqueeze(0)   # j = s // wsize
    gx = tl[:, 0:1] + dx[:, 0:1] * lat_x + dy[:, 0:1] * lat_y
    gy = tl[:, 1:2] + dx[:, 1:2] * lat_x + dy[:, 1:2] * lat_y
    return gx, gy


def sample_windows_plain(scene: Scene, idx, lvl, tl, dx, dy, wsize: int,
                         illum: int = 0):
    """Plain PyTorch version of the RGB kernel, on the gather path
    (``sampling.sample_color_ch_packed``). Returns [B, 3 * S] f32."""
    B = idx.shape[0]
    S = wsize * wsize
    gx, gy = lattice(tl, dx, dy, wsize)
    tex = sampling.sample_color_ch_packed(
        scene, idx.unsqueeze(1).expand(B, S), gx, gy,
        lvl.unsqueeze(1).expand(B, S), illum,
    )  # [3, B, S]
    return tex.permute(1, 0, 2).reshape(B, 3 * S)


def sample_windows_luma_plain(scene: Scene, idx, lvl, tl, dx, dy,
                              wsize: int, illum: int = 0):
    """Plain PyTorch version of the luma kernel, on the gather path
    (``sampling.sample_luma_quad``). Returns [B, S] f32."""
    B = idx.shape[0]
    S = wsize * wsize
    gx, gy = lattice(tl, dx, dy, wsize)
    return sampling.sample_luma_quad(
        scene, idx.unsqueeze(1).expand(B, S), gx, gy,
        lvl.unsqueeze(1).expand(B, S), illum,
    )[0]


def _planes(scene: Scene, luma: bool):
    return scene.planes_luma_quad if luma else scene.planes_packed


def _check(scene: Scene, idx, lvl, tl, dx, dy, wsize: int, illum: int,
           luma: bool):
    B = idx.shape[0]
    planes = _planes(scene, luma)
    name = "planes_luma_quad" if luma else "planes_packed"
    dev = planes.device
    for arg, t, dtype, shape in (
        ("idx", idx, torch.int32, (B,)),
        ("lvl", lvl, torch.int32, (B,)),
        ("tl", tl, torch.float32, (B, 2)),
        ("dx", dx, torch.float32, (B, 2)),
        ("dy", dy, torch.float32, (B, 2)),
    ):
        if t.device != dev:
            raise ValueError(f"{arg} on {t.device}, {name} on {dev}")
        if t.dtype != dtype:
            raise TypeError(f"{arg} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{arg} must have shape {shape}, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{arg} must be contiguous")
    if (planes.dtype != torch.int32 or planes.ndim != 3
            or not planes.is_contiguous()):
        raise ValueError(f"{name} must be a contiguous [n, I, total] int32 tensor")
    if not 0 <= illum < planes.shape[1]:
        raise ValueError(f"illum {illum} out of range for {planes.shape[1]} illuminations")
    if not 1 <= wsize <= 15:
        raise ValueError(f"wsize {wsize} out of range")


def _launch(scene: Scene, idx, lvl, tl, dx, dy, wsize: int, illum: int,
            group: int, luma: bool):
    from . import _build

    lib = _build.load_library()
    planes = _planes(scene, luma)
    B = idx.shape[0]
    S = wsize * wsize
    n, ni, total = planes.shape
    img = (idx * ni + illum).contiguous()
    out = torch.empty((B, S if luma else 3 * S), dtype=torch.float32,
                      device=tl.device)
    L = len(scene.offsets)
    ints = ctypes.c_int * L
    args = (
        ctypes.c_void_p(planes.data_ptr()), total,
        ints(*scene.offsets), ints(*scene.widths), ints(*scene.heights), L,
        ctypes.c_void_p(img.data_ptr()), ctypes.c_void_p(lvl.data_ptr()),
        ctypes.c_void_p(tl.data_ptr()), ctypes.c_void_p(dx.data_ptr()),
        ctypes.c_void_p(dy.data_ptr()), ctypes.c_void_p(out.data_ptr()),
        B, wsize,
    )
    stream = ctypes.c_void_p(torch.cuda.current_stream(tl.device).cuda_stream)
    prefix = "luma_" if luma else ""
    if group > 1 and _W_BLK % group == 0 and B % group == 0:
        form = prefix + "grouped"
        err = getattr(lib, f"mvs_sample_windows_{form}")(*args, group, stream)
    else:
        form = prefix + "ungrouped"
        err = getattr(lib, f"mvs_sample_windows_{form}")(*args, stream)
    if err != 0:
        raise RuntimeError(f"sample_windows {form} launch failed: CUDA error {err}")
    LAUNCHES[form] += 1
    return out


def sample_windows(scene: Scene, idx, lvl, tl, dx, dy, wsize: int,
                   illum: int = 0, group: int = 1, luma: bool = False):
    """Raw windows for a flat batch of B windows.

    idx [B] int32 view index, lvl [B] int32 resolved pyramid level,
    tl / dx / dy [B, 2] f32 lattice origin and steps at that level.
    `group` > 1 declares that every `group` consecutive windows are
    candidates of one (patch, view), which the kernel's grouped form
    serves together. Returns (out [B, 3 * S] f32, or [B, S] with `luma`,
    fit [B] bool, all true)."""
    _check(scene, idx, lvl, tl, dx, dy, wsize, illum, luma)
    if tl.device.type == "cuda":
        out = _launch(scene, idx, lvl, tl, dx, dy, wsize, illum, group, luma)
    elif tl.device.type == "cpu":
        plain = sample_windows_luma_plain if luma else sample_windows_plain
        out = plain(scene, idx, lvl, tl, dx, dy, wsize, illum)
    else:
        raise ValueError(f"sample_windows: unsupported device {tl.device}")
    fit = torch.ones(idx.shape[0], dtype=torch.bool, device=tl.device)
    return out, fit
