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
divides the batch, or fused with ``fused``), a CPU tensor runs the plain
version (``sample_windows_plain`` / ``sample_windows_luma_plain``), the
same arithmetic on the gather path. A CUDA scene whose ``use_kernel``
is False (``cfg.use_pallas = False``) runs the plain version too. ``ablate`` names one of the
measurement switches of the JAX kernel (``ABLATIONS``), each of which
drops one stage of the work and has a defined output that its plain
version repeats. ``LAUNCHES`` counts kernel launches per form,
ablated launches per switch and the backward kernel's launches (keys
``grad`` / ``luma_grad``); ``WINDOWS`` counts those launches per
batch size. ``grouped_plan`` and ``ungrouped_plan`` report how the
persistent window kernel launches a batch on the current card (tile,
grid, threads, shared memory, output stages, store path), and
``fused_plan`` how the fused form (K4) does.

The gradient polish of the refinement (``pipeline/refine.py``) needs
the samples' derivative with respect to the lattice. The JAX package
takes it by XLA's autodiff of its gather path (its Pallas kernel has no
VJP); here ``SampleWindowsFn`` pairs the forward launch with a backward
kernel written by hand (``csrc/sample_windows_grad.cu``, reached by
``sample_windows_grad``), whose plain version is autograd through the
gather path (``sample_windows_grad_plain``).
"""

from __future__ import annotations

import collections
import ctypes
import functools

import torch

from ..image.scene import Scene
from . import sampling

# the JAX kernel's `ablate` settings (pallas_ncc.py:194-200), in the
# order of csrc/sample_windows.cu's Ablate enum
ABLATIONS = ("", "nodma", "nocompute", "norot", "nowx", "nomm")

LAUNCHES = {"ungrouped": 0, "grouped": 0, "luma_ungrouped": 0,
            "luma_grouped": 0, "fused": 0, "luma_fused": 0,
            **{f"ablate_{a}": 0 for a in ABLATIONS[1:]},
            "grad": 0, "luma_grad": 0}

# the TPU kernel's grouped form needs group | 128 (W_BLK); the same
# rule picks the launch form here (pallas_ncc.py:609-610)
_W_BLK = 128


# per key of LAUNCHES, its launches counted by batch size (windows)
WINDOWS = {k: collections.Counter() for k in LAUNCHES}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
        WINDOWS[k].clear()


def lattice(tl, dx, dy, wsize: int, origin: bool = False):
    """Sample coordinates [B, S] of each window's lattice,
    s = j * wsize + i -> tl + dx * i + dy * j (JAX ncc.py:408-412).
    With `origin` every sample takes i = j = 0 (the `nowx` switch)."""
    xs = torch.arange(wsize, dtype=torch.float32, device=tl.device)
    if origin:
        xs = torch.zeros_like(xs)
    lat_x = xs.repeat(wsize).unsqueeze(0)              # i = s % wsize
    lat_y = xs.repeat_interleave(wsize).unsqueeze(0)   # j = s // wsize
    gx = tl[:, 0:1] + dx[:, 0:1] * lat_x + dy[:, 0:1] * lat_y
    gy = tl[:, 1:2] + dx[:, 1:2] * lat_x + dy[:, 1:2] * lat_y
    return gx, gy


def _check_ablate(ablate: str) -> None:
    if ablate not in ABLATIONS:
        raise ValueError(f"unknown ablate {ablate!r}; expected one of {ABLATIONS}")


def _byte(v, k: int):
    return ((v >> (8 * k)) & 0xFF).to(torch.float32)


def _ablated_taps(planes, scene: Scene, image_idx, x, y, level, illum, n_taps,
                  ablate: str):
    """The taps the kernel reads under `ablate` (zeros for nodma) and the
    tap fractions (lx, ly, dx0, dx1, dy0, dy1)."""
    flat = planes.reshape(-1)
    ni, t = planes.shape[1], planes.shape[2]
    off, w, h = sampling._level_meta(scene, level)
    frac = sampling._bilinear_frac(x, y, w, h)
    lx, ly = frac[:2]
    base = ((image_idx * ni + illum) * t + off + ly * w + lx).long()
    wl = w.long()
    offsets = (0, 1, wl, wl + 1)[:n_taps]
    if ablate == "nodma":
        taps = [torch.zeros_like(base, dtype=torch.int32) for _ in offsets]
    else:
        taps = [flat[base + d] for d in offsets]
    return taps, frac


def _rgb_ablated(scene: Scene, image_idx, x, y, level, illum, ablate: str):
    """sampling.sample_color_ch_packed under nodma / nocompute / nomm:
    channel-leading [3, ...]."""
    taps, (_, _, dx0, dx1, dy0, dy1) = _ablated_taps(
        scene.planes_packed, scene, image_idx, x, y, level, illum, 4, ablate)
    if ablate == "nocompute":
        return torch.stack([_byte(taps[0], k) for k in range(3)])
    if ablate == "nomm":
        weights = (None,) * 4
    else:
        weights = (dx0 * dy0, dx1 * dy0, dx0 * dy1, dx1 * dy1)
    chans = []
    for k in range(3):
        acc = 0.0
        for v, wgt in zip(taps, weights):
            acc = acc + (_byte(v, k) if wgt is None else _byte(v, k) * wgt)
        chans.append(acc)
    return torch.stack(chans)


def _luma_ablated(scene: Scene, image_idx, x, y, level, illum, ablate: str):
    """sampling.sample_luma_quad under nodma / nocompute / nomm: [1, ...]."""
    (v,), (_, _, dx0, dx1, dy0, dy1) = _ablated_taps(
        scene.planes_luma_quad, scene, image_idx, x, y, level, illum, 1, ablate)
    y00, y10, y01, y11 = (_byte(v, k) for k in range(4))
    if ablate == "nocompute":
        out = y00
    elif ablate == "nomm":
        out = y00 + y10 + y01 + y11
    else:
        out = y00 * dx0 * dy0 + y10 * dx1 * dy0 + y01 * dx0 * dy1 + y11 * dx1 * dy1
    return out.unsqueeze(0)


def _plain(scene: Scene, idx, lvl, tl, dx, dy, wsize: int, illum: int,
           luma: bool, ablate: str):
    """[C, B, S] samples of the gather path under `ablate`."""
    _check_ablate(ablate)
    B = idx.shape[0]
    S = wsize * wsize
    gx, gy = lattice(tl, dx, dy, wsize, origin=ablate == "nowx")
    ii = idx.unsqueeze(1).expand(B, S)
    ll = lvl.unsqueeze(1).expand(B, S)
    if ablate in ("nodma", "nocompute", "nomm"):
        fn = _luma_ablated if luma else _rgb_ablated
        return fn(scene, ii, gx, gy, ll, illum, ablate)
    fn = sampling.sample_luma_quad if luma else sampling.sample_color_ch_packed
    return fn(scene, ii, gx, gy, ll, illum)


def sample_windows_plain(scene: Scene, idx, lvl, tl, dx, dy, wsize: int,
                         illum: int = 0, ablate: str = ""):
    """Plain PyTorch version of the RGB kernel, on the gather path
    (``sampling.sample_color_ch_packed``). Returns [B, 3 * S] f32."""
    tex = _plain(scene, idx, lvl, tl, dx, dy, wsize, illum, False, ablate)
    return tex.permute(1, 0, 2).reshape(idx.shape[0], -1)


def sample_windows_luma_plain(scene: Scene, idx, lvl, tl, dx, dy,
                              wsize: int, illum: int = 0, ablate: str = ""):
    """Plain PyTorch version of the luma kernel, on the gather path
    (``sampling.sample_luma_quad``). Returns [B, S] f32."""
    return _plain(scene, idx, lvl, tl, dx, dy, wsize, illum, True, ablate)[0]


def _planes(scene: Scene, luma: bool):
    return scene.planes_luma_quad if luma else scene.planes_packed


def _check(scene: Scene, idx, lvl, tl, dx, dy, wsize: int, illum: int,
           luma: bool, ablate: str):
    _check_ablate(ablate)
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


def launch_form(B: int, group: int, luma: bool, fused: bool) -> str:
    """The kernel form a batch of B windows launches: grouped (or fused)
    where group > 1 divides both 128 and B, as the JAX kernel's rule
    (pallas_ncc.py:609-610) decides, else ungrouped."""
    if group > 1 and _W_BLK % group == 0 and B % group == 0:
        form = "fused" if fused else "grouped"
    else:
        form = "ungrouped"
    return ("luma_" if luma else "") + form


@functools.lru_cache(maxsize=64)
def _level_arrays(offsets, widths, heights):
    """The kernel's host-side level metadata for one scene layout (the
    static `offsets` / `widths` / `heights` tuples), built once."""
    ints = ctypes.c_int * len(offsets)
    return ints(*offsets), ints(*widths), ints(*heights), len(offsets)


def _launch(scene: Scene, idx, lvl, tl, dx, dy, wsize: int, illum: int,
            group: int, luma: bool, fused: bool, ablate: str):
    from . import _build

    lib = _build.load_library()
    planes = _planes(scene, luma)
    B = idx.shape[0]
    S = wsize * wsize
    n, ni, total = planes.shape
    out = torch.empty((B, S if luma else 3 * S), dtype=torch.float32,
                      device=tl.device)
    args = (
        ctypes.c_void_p(planes.data_ptr()), total,
        *_level_arrays(scene.offsets, scene.widths, scene.heights), ni, illum,
        ctypes.c_void_p(idx.data_ptr()), ctypes.c_void_p(lvl.data_ptr()),
        ctypes.c_void_p(tl.data_ptr()), ctypes.c_void_p(dx.data_ptr()),
        ctypes.c_void_p(dy.data_ptr()), ctypes.c_void_p(out.data_ptr()),
        B, wsize,
    )
    stream = ctypes.c_void_p(torch.cuda.current_stream(tl.device).cuda_stream)
    form = launch_form(B, group, luma, fused)
    switch = ABLATIONS.index(ablate)
    fn = getattr(lib, f"mvs_sample_windows_{form}")
    if form.endswith("ungrouped"):
        err = fn(*args, switch, stream)
    else:
        err = fn(*args, group, switch, stream)
    if err != 0:
        raise RuntimeError(f"sample_windows {form} (ablate {ablate!r}) launch "
                           f"failed: CUDA error {err}")
    key = f"ablate_{ablate}" if ablate else form
    LAUNCHES[key] += 1
    WINDOWS[key][B] += 1
    return out


# csrc/sample_windows.cu's Form enum values
_FORMS = {"ungrouped": 0, "grouped": 1, "luma_ungrouped": 2, "luma_grouped": 3,
          "fused": 4, "luma_fused": 5}
PLAN_KEYS = ("tile", "grid", "threads", "smem_bytes", "stages", "tma_store",
             "param_copy16", "blocks_per_sm", "sms", "stage_floats")


def _plan(form: str, B: int, wsize: int, group: int) -> dict:
    from . import _build

    lib = _build.load_library()
    plan = (ctypes.c_int * len(PLAN_KEYS))()
    err = lib.mvs_sample_windows_plan(_FORMS[form], B, wsize, group, plan)
    if err != 0:
        raise RuntimeError(f"sample_windows {form} plan (B {B}, wsize {wsize}, group "
                           f"{group}) failed: CUDA error {err}")
    rec = dict(zip(PLAN_KEYS, plan))
    for k in ("tma_store", "param_copy16"):
        rec[k] = bool(rec[k])
    return rec


def grouped_plan(B: int, wsize: int, group: int, luma: bool = False) -> dict:
    """How the grouped form launches B windows of wsize in groups of
    `group` on the current card (the wrapper's 16-byte aligned arrays):
    the tile (= group), the persistent grid, threads per block, dynamic
    shared memory, output stages (2, or 1 where two exceed the card's
    shared memory), whether a tile's run leaves by TMA bulk store,
    whether parameters are copied in 16-byte chunks, resident blocks per
    SM and the SM count. Raises where the launch would fail (a
    shared-memory size the card refuses). Needs the card."""
    return _plan("luma_grouped" if luma else "grouped", B, wsize, group)


def ungrouped_plan(B: int, wsize: int, luma: bool = False) -> dict:
    """How the ungrouped form launches B windows of wsize on the current
    card: the same record as ``grouped_plan``, with tiles of consecutive
    windows of a fixed sample count (40 RGB or 64 luma windows at 7 x 7)
    and one output stage. Needs the card."""
    return _plan("luma_ungrouped" if luma else "ungrouped", B, wsize, 1)


def fused_plan(B: int, wsize: int, group: int, luma: bool = False) -> dict:
    """How the fused form (K4) launches B windows of wsize in groups of
    `group` on the current card: the record of ``grouped_plan``, where
    `threads` serve one lattice row each (group * wsize rows a group).
    Raises where the launch would fail. Needs the card."""
    return _plan("luma_fused" if luma else "fused", B, wsize, group)


def sample_grad_terms(scene: Scene, idx, lvl, tl, dx, dy, wsize: int, grad_out,
                      illum: int = 0, luma: bool = False, dtype=torch.float32):
    """Each sample's term of the backward: the cotangent times the
    sample's derivative in x and in y (s = j * wsize + i), summed over
    the channels, by autograd through the gather path
    (``sampling.sample_color_ch_packed`` / ``sample_luma_quad``, whose
    fractions follow the JAX package's clip rule). The lattice is
    computed in float32, as the kernels compute it, and then taken in
    `dtype`: float64 keeps every tap origin, fraction and tie of the
    float32 evaluation and only rounds the arithmetic less. Returns
    (gx, gy), each [B, S] of `dtype`."""
    fn = sampling.sample_luma_quad if luma else sampling.sample_color_ch_packed
    B, S = idx.shape[0], wsize * wsize
    with torch.enable_grad():
        gx, gy = (c.detach().to(dtype).requires_grad_() for c in lattice(tl, dx, dy, wsize))
        ii, ll = idx.unsqueeze(1).expand(B, S), lvl.unsqueeze(1).expand(B, S)
        out = fn(scene, ii, gx, gy, ll, illum)  # [C, B, S]
        cot = grad_out.to(dtype).reshape(B, out.shape[0], S).permute(1, 0, 2)
        return torch.autograd.grad(out, (gx, gy), cot)


def _lattice_weights(wsize: int, device, dtype):
    """Per sample the factor of each output: 1 (tl), i (dx), j (dy)."""
    k = torch.arange(wsize, dtype=dtype, device=device)
    return torch.ones(wsize * wsize, dtype=dtype, device=device), k.repeat(wsize), \
        k.repeat_interleave(wsize)


def sample_windows_grad_plain(scene: Scene, idx, lvl, tl, dx, dy, wsize: int,
                              grad_out, illum: int = 0, luma: bool = False,
                              dtype=torch.float32):
    """Plain PyTorch version of the backward kernel: the vector-Jacobian
    product of ``sample_windows_plain`` (``_luma_plain`` with `luma`)
    with `grad_out` [B, C * S] with respect to tl, dx and dy, which is
    autograd through the plain version: the terms of
    ``sample_grad_terms`` summed over the samples (times i for dx, j for
    dy), as the lattice's backward sums them. In float32 (the default)
    it is the CPU path's gradient, and it rounds as JAX's autodiff of
    the gather path does: each tap's product with the cotangent is
    formed and the products subtracted, so its error grows with the
    taps' size. With dtype=torch.float64 the same function rounds less
    (chip_smoke.py holds the kernel, which subtracts the taps first, to
    it). Returns (grad_tl, grad_dx, grad_dy), each [B, 2] of `dtype`."""
    gx, gy = sample_grad_terms(scene, idx, lvl, tl, dx, dy, wsize, grad_out, illum, luma,
                               dtype)
    return tuple(torch.stack([(gx * w).sum(1), (gy * w).sum(1)], 1)
                 for w in _lattice_weights(wsize, gx.device, gx.dtype))


def grad_scale(terms, wsize: int):
    """The size of each backward output's sum, max(1, sum over s of
    |term|) with the terms of ``sample_grad_terms`` (times i for dx, j
    for dy): [3, B, 2], the scale of the kernel's float32 sums, taken in
    another order than the plain version's."""
    gx, gy = terms
    return torch.stack([
        torch.stack([(gx * w).abs().sum(1), (gy * w).abs().sum(1)], 1)
        for w in _lattice_weights(wsize, gx.device, gx.dtype)
    ]).clamp(min=1.0)


def _check_grad_out(grad_out, B: int, wsize: int, luma: bool, dev) -> None:
    shape = (B, (1 if luma else 3) * wsize * wsize)
    if grad_out.device != dev or grad_out.dtype != torch.float32:
        raise TypeError(f"grad_out must be float32 on {dev}, got {grad_out.dtype} on "
                        f"{grad_out.device}")
    if tuple(grad_out.shape) != shape or not grad_out.is_contiguous():
        raise ValueError(f"grad_out must be a contiguous {shape}, got "
                         f"{tuple(grad_out.shape)}")


def _launch_grad(scene: Scene, idx, lvl, tl, dx, dy, wsize: int, illum: int,
                 luma: bool, grad_out):
    """The backward kernel (csrc/sample_windows_grad.cu) on the card:
    (grad_tl, grad_dx, grad_dy), each [B, 2] f32."""
    from . import _build

    B = idx.shape[0]
    _check_grad_out(grad_out, B, wsize, luma, tl.device)
    lib = _build.load_library()
    planes = _planes(scene, luma)
    n, ni, total = planes.shape
    grads = torch.empty((3, B, 2), dtype=torch.float32, device=tl.device)
    key = "luma_grad" if luma else "grad"
    fn = lib.mvs_sample_windows_luma_grad if luma else lib.mvs_sample_windows_grad
    err = fn(
        ctypes.c_void_p(planes.data_ptr()), total,
        *_level_arrays(scene.offsets, scene.widths, scene.heights), ni, illum,
        ctypes.c_void_p(idx.data_ptr()), ctypes.c_void_p(lvl.data_ptr()),
        ctypes.c_void_p(tl.data_ptr()), ctypes.c_void_p(dx.data_ptr()),
        ctypes.c_void_p(dy.data_ptr()), ctypes.c_void_p(grad_out.data_ptr()),
        ctypes.c_void_p(grads.data_ptr()), B, wsize,
        ctypes.c_void_p(torch.cuda.current_stream(tl.device).cuda_stream),
    )
    if err != 0:
        raise RuntimeError(f"sample_windows {key} launch failed: CUDA error {err}")
    LAUNCHES[key] += 1
    WINDOWS[key][B] += 1
    return grads[0], grads[1], grads[2]


def sample_windows_grad(scene: Scene, idx, lvl, tl, dx, dy, wsize: int, grad_out,
                        illum: int = 0, luma: bool = False):
    """The vector-Jacobian product of ``sample_windows`` with `grad_out`
    [B, C * S] with respect to the lattice: (grad_tl, grad_dx, grad_dy),
    each [B, 2] f32. A CUDA tensor of a ``use_kernel`` scene launches the
    backward kernel, a CPU tensor runs the plain version
    (``sample_windows_grad_plain``)."""
    _check(scene, idx, lvl, tl, dx, dy, wsize, illum, luma, "")
    if tl.device.type == "cuda" and scene.use_kernel:
        return _launch_grad(scene, idx, lvl, tl, dx, dy, wsize, illum, luma, grad_out)
    if tl.device.type in ("cpu", "cuda"):
        return sample_windows_grad_plain(scene, idx, lvl, tl, dx, dy, wsize, grad_out,
                                         illum, luma)
    raise ValueError(f"sample_windows_grad: unsupported device {tl.device}")


class SampleWindowsFn(torch.autograd.Function):
    """The window sampler's kernel with a gradient: the forward is the
    launch of ``sample_windows`` (any form, unablated), the backward the
    backward kernel (``_launch_grad``) with respect to tl, dx and dy.
    idx, lvl and the planes carry no gradient."""

    @staticmethod
    def forward(ctx, scene, idx, lvl, tl, dx, dy, wsize, illum, group, luma, fused):
        ctx.scene, ctx.wsize, ctx.illum, ctx.luma = scene, wsize, illum, luma
        ctx.save_for_backward(idx, lvl, tl, dx, dy)
        return _launch(scene, idx, lvl, tl, dx, dy, wsize, illum, group, luma, fused, "")

    @staticmethod
    def backward(ctx, grad_out):
        idx, lvl, tl, dx, dy = ctx.saved_tensors
        g_tl, g_dx, g_dy = _launch_grad(ctx.scene, idx, lvl, tl, dx, dy, ctx.wsize,
                                        ctx.illum, ctx.luma, grad_out.contiguous())
        return None, None, None, g_tl, g_dx, g_dy, None, None, None, None, None


def sample_windows(scene: Scene, idx, lvl, tl, dx, dy, wsize: int,
                   illum: int = 0, group: int = 1, luma: bool = False,
                   fused: bool = False, ablate: str = ""):
    """Raw windows for a flat batch of B windows.

    idx [B] int32 view index, lvl [B] int32 resolved pyramid level,
    tl / dx / dy [B, 2] f32 lattice origin and steps at that level.
    `group` > 1 declares that every `group` consecutive windows are
    candidates of one (patch, view), which the kernel's grouped form
    serves together; `fused` serves such a group with the fused form
    (the JAX kernel's fused=True, the same output). `ablate` is one of
    ``ABLATIONS``. Returns (out [B, 3 * S] f32, or [B, S] with `luma`,
    fit [B] bool, all true).

    Where autograd is on and tl, dx or dy requires grad, the launch goes
    through ``SampleWindowsFn``, whose backward is the backward kernel;
    on the CPU (and on a ``use_kernel=False`` scene) autograd runs
    through the plain version."""
    _check(scene, idx, lvl, tl, dx, dy, wsize, illum, luma, ablate)
    if tl.device.type == "cuda" and scene.use_kernel:
        if torch.is_grad_enabled() and any(t.requires_grad for t in (tl, dx, dy)):
            if ablate:
                raise ValueError(f"ablate {ablate!r} has no backward")
            out = SampleWindowsFn.apply(scene, idx, lvl, tl, dx, dy, wsize, illum,
                                        group, luma, fused)
        else:
            out = _launch(scene, idx, lvl, tl, dx, dy, wsize, illum, group, luma,
                          fused, ablate)
    elif tl.device.type in ("cpu", "cuda"):
        plain = sample_windows_luma_plain if luma else sample_windows_plain
        out = plain(scene, idx, lvl, tl, dx, dy, wsize, illum, ablate)
    else:
        raise ValueError(f"sample_windows: unsupported device {tl.device}")
    fit = torch.ones(idx.shape[0], dtype=torch.bool, device=tl.device)
    return out, fit
