"""Texture and mask sampling from flattened pyramids (port of
``mvskit_tpu/ops/sampling.py``).

The gather path: batched bilinear fetches over the Scene's flat planes,
with the pyramid level a per-sample tensor. ``sample_color_ch_packed``
is also the plain version of the CUDA window sampler
(``ops/cuda_ncc.py``), which repeats its arithmetic exactly.
"""

from __future__ import annotations

import torch

from ..geometry import camera as cam
from ..image.scene import Scene

# float -> int32 conversion saturates at these bounds (as the CUDA
# kernel's __float2int_rz does); in-range values are unaffected
_I32_LO = -2147483520.0
_I32_HI = 2147483520.0


def _level_meta(scene: Scene, level):
    level = torch.as_tensor(level, dtype=torch.int32, device=scene.device)
    lv = level.long()
    return scene.lvl_offsets[lv], scene.lvl_widths[lv], scene.lvl_heights[lv]


def _trunc_i32(x):
    """C-style float -> int32 truncation, saturating out of range."""
    return x.clamp(_I32_LO, _I32_HI).to(torch.int32)


def clip01_slope(v):
    """The derivative of the JAX package's ``jnp.clip(v, 0, 1)`` (a max
    then a min, each splitting a tie evenly): 1 inside (0, 1), 0.5 on
    either bound, 0 outside and at NaN."""
    inside = ((v > 0.0) & (v < 1.0)).to(v.dtype)
    tie = ((v == 0.0) | (v == 1.0)).to(v.dtype)
    return inside + 0.5 * tie


class _Clip01(torch.autograd.Function):
    """clamp(v, 0, 1) whose backward is the cotangent times
    ``clip01_slope(v)``, as JAX's (torch.clamp's is 1 on the bounds, and
    a select that turns a NaN cotangent into 0 outside them)."""

    @staticmethod
    def forward(ctx, v):
        ctx.save_for_backward(v)
        return torch.clamp(v, 0.0, 1.0)

    @staticmethod
    def backward(ctx, g):
        (v,) = ctx.saved_tensors
        return g * clip01_slope(v)


def clip01(v):
    """torch.clamp(v, 0, 1) (the same bits, NaN kept), differentiated by
    the JAX package's rule (``clip01_slope``)."""
    if torch.is_grad_enabled() and v.requires_grad:
        return _Clip01.apply(v)
    return torch.clamp(v, 0.0, 1.0)


def _bilinear_frac(x, y, w, h):
    """The gather path's tap origin and fractions (sampling.py:87-92 of
    the JAX package): lx = clamp(trunc(x), 0, w-2), dx1 = clamp(x - lx,
    0, 1), dx0 = 1 - dx1, likewise for y. The fractions' derivative
    follows jnp.clip's (``clip01``), so the gradient of a sample equals
    JAX's autodiff of its gather path, a lattice on an integer or on
    w - 1 included."""
    lx = torch.minimum(torch.clamp(_trunc_i32(x), min=0), w - 2)
    ly = torch.minimum(torch.clamp(_trunc_i32(y), min=0), h - 2)
    dx1 = clip01(x - lx.to(x.dtype))
    dy1 = clip01(y - ly.to(y.dtype))
    return lx, ly, 1.0 - dx1, dx1, 1.0 - dy1, dy1


def _bilinear_setup(x, y, w, h):
    """Tap origin and the four tap weights f00, f10, f01, f11."""
    lx, ly, dx0, dx1, dy0, dy1 = _bilinear_frac(x, y, w, h)
    return lx, ly, dx0 * dy0, dx1 * dy0, dx0 * dy1, dx1 * dy1


def sample_color_ch(scene: Scene, image_idx, x, y, level, illum=0):
    """Bilinear color fetch from the float planes, channel-leading
    output [3, ...]."""
    flat = scene.planes.reshape(-1)
    ni, t = scene.planes.shape[1], scene.planes.shape[2]
    off, w, h = _level_meta(scene, level)
    lx, ly, f00, f10, f01, f11 = _bilinear_setup(x, y, w, h)
    base = (
        (torch.as_tensor(image_idx, dtype=torch.int32, device=x.device) * ni
         + illum) * t + off + ly * w + lx
    ).long() * 3
    row = (w * 3).long()
    chans = []
    for c in range(3):
        b = base + c
        chans.append(
            flat[b] * f00 + flat[b + 3] * f10 + flat[b + row] * f01
            + flat[b + row + 3] * f11
        )
    return torch.stack(chans, dim=0)


def sample_color_ch_packed(scene: Scene, image_idx, x, y, level, illum=0):
    """Bilinear fetch from the packed int32 planes, channel-leading
    [3, ...] output. Each channel accumulates its four taps in the order
    f00, f10, f01, f11, starting from 0."""
    flat = scene.planes_packed.reshape(-1)
    ni, t = scene.planes_packed.shape[1], scene.planes_packed.shape[2]
    off, w, h = _level_meta(scene, level)
    lx, ly, f00, f10, f01, f11 = _bilinear_setup(x, y, w, h)
    base = (
        (torch.as_tensor(image_idx, dtype=torch.int32, device=x.device) * ni
         + illum) * t + off + ly * w + lx
    ).long()
    wl = w.long()
    r = g = b = 0.0
    for doff, wgt in ((0, f00), (1, f10), (wl, f01), (wl + 1, f11)):
        v = flat[base + doff]
        r = r + (v & 0xFF).to(torch.float32) * wgt
        g = g + ((v >> 8) & 0xFF).to(torch.float32) * wgt
        b = b + ((v >> 16) & 0xFF).to(torch.float32) * wgt
    return torch.stack([r, g, b], dim=0)


def sample_luma_quad(scene: Scene, image_idx, x, y, level, illum=0):
    """Bilinear luma fetch from the quad-packed planes (JAX
    sampling.py:112-148): one int32 holds the four u8 luminances of a
    pixel's 2x2 support, so one fetch yields a bilinear sample,
    y00*dx0*dy0 + y10*dx1*dy0 + y01*dx0*dy1 + y11*dx1*dy1 evaluated left
    to right. Returns the channel-leading [1, ...] layout."""
    flat = scene.planes_luma_quad.reshape(-1)
    ni, t = scene.planes_luma_quad.shape[1], scene.planes_luma_quad.shape[2]
    off, w, h = _level_meta(scene, level)
    lx, ly, dx0, dx1, dy0, dy1 = _bilinear_frac(x, y, w, h)
    idx = (
        (torch.as_tensor(image_idx, dtype=torch.int32, device=x.device) * ni
         + illum) * t + off + ly * w + lx
    ).long()
    v = flat[idx]
    y00 = (v & 0xFF).to(torch.float32)
    y10 = ((v >> 8) & 0xFF).to(torch.float32)
    y01 = ((v >> 16) & 0xFF).to(torch.float32)
    y11 = ((v >> 24) & 0xFF).to(torch.float32)
    out = y00 * dx0 * dy0 + y10 * dx1 * dy0 + y01 * dx0 * dy1 + y11 * dx1 * dy1
    return out.unsqueeze(0)


def sample_color(scene: Scene, image_idx, x, y, level, illum=0):
    """Bilinear color fetch at float pixel coords of `level`
    (image.cpp:447-471). Returns [..., 3] float32."""
    return sample_color_ch(scene, image_idx, x, y, level, illum).movedim(0, -1)


def _bicubic_w0(f):
    """Weight at offset -1 (image.cpp:345-446: (((-1)g+5)g-8)g+4 at g=1+f)."""
    g = 1.0 + f
    return ((-g + 5.0) * g - 8.0) * g + 4.0


def _bicubic_w1(f):
    """Weight at offset 0."""
    return ((f - 2.0) * f) * f + 1.0


def sample_color_bicubic(scene: Scene, image_idx, x, y, level, illum=0):
    """Bicubic color fetch (image.cpp:345-446, the PMMVPS_IMAGE_BICUBIC
    variant; JAX sampling.py:188-232): 4x4 taps from the float planes
    with the reference's weight polynomials, summed row by row in the
    JAX package's order. Channel-leading [3, ...]."""
    flat = scene.planes.reshape(-1)
    ni, t = scene.planes.shape[1], scene.planes.shape[2]
    off, w, h = _level_meta(scene, level)
    x = torch.as_tensor(x, dtype=torch.float32, device=scene.device)
    y = torch.as_tensor(y, dtype=torch.float32, device=scene.device)
    x1 = torch.minimum(torch.clamp(_trunc_i32(torch.floor(x)), min=1), w - 3)
    y1 = torch.minimum(torch.clamp(_trunc_i32(torch.floor(y)), min=1), h - 3)
    p = torch.clamp(x - x1.to(x.dtype), 0.0, 1.0)
    q = torch.clamp(y - y1.to(y.dtype), 0.0, 1.0)
    wx = (_bicubic_w0(p), _bicubic_w1(p), _bicubic_w1(1.0 - p), _bicubic_w0(1.0 - p))
    wy = (_bicubic_w0(q), _bicubic_w1(q), _bicubic_w1(1.0 - q), _bicubic_w0(1.0 - q))
    img = torch.as_tensor(image_idx, dtype=torch.int32, device=scene.device)
    base = ((img * ni + illum) * t + off + (y1 - 1) * w + (x1 - 1)).long() * 3
    row = (w * 3).long()
    chans = []
    for c in range(3):
        acc = 0.0
        for j in range(4):
            rowacc = 0.0
            for i in range(4):
                rowacc = rowacc + flat[base + c + j * row + i * 3] * wx[i]
            acc = acc + rowacc * wy[j]
        chans.append(acc)
    return torch.stack(chans, dim=0)


def sample_mask(scene: Scene, image_idx, x, y, level):
    """Nearest-neighbor mask lookup (image.cpp:749-781): 255 inside, 0
    outside, -1 when out of image bounds or when the scene has no masks."""
    if scene.masks is None:
        shape = torch.broadcast_shapes(x.shape, y.shape)
        return torch.full(shape, -1.0, device=x.device)
    off, w, h = _level_meta(scene, level)
    ix = _trunc_i32(torch.floor(x + 0.5))
    iy = _trunc_i32(torch.floor(y + 0.5))
    inb = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
    ixc = torch.minimum(torch.clamp(ix, min=0), w - 1)
    iyc = torch.minimum(torch.clamp(iy, min=0), h - 1)
    t = scene.masks.shape[1]
    flat = scene.masks.reshape(-1)
    img = torch.as_tensor(image_idx, dtype=torch.int32, device=x.device)
    val = flat[(img * t + off + iyc * w + ixc).long()]
    return torch.where(inb, val, torch.full_like(val, -1.0))


def scene_mask_ok(scene: Scene, coord, level):
    """Scene-level mask test (photoSet.cpp:223-233): a point fails iff
    ANY view's mask maps it to 0; out-of-bounds (-1) passes.
    coord: [..., 4]; returns bool [...]."""
    if scene.masks is None:
        return torch.ones(coord.shape[:-1], dtype=torch.bool, device=coord.device)
    n = scene.n_images
    idx = torch.arange(n, dtype=torch.int32, device=coord.device).reshape(
        (n,) + (1,) * (coord.ndim - 1)
    )
    xy, _, valid = cam.project(scene.cams, idx.long(), coord.unsqueeze(0), level)
    vals = sample_mask(scene, idx, xy[..., 0], xy[..., 1], level)
    vals = torch.where(valid, vals, torch.full_like(vals, -1.0))
    return torch.all(vals != 0.0, dim=0)


def color_at_coord(scene: Scene, image_idx, coord, level, illum=0):
    """Photo::getColor — project then sample (photo.cpp:22-46)."""
    xy, _, valid = cam.project(scene.cams, image_idx, coord, level)
    col = sample_color(scene, image_idx, xy[..., 0], xy[..., 1], level, illum)
    return torch.where(valid.unsqueeze(-1), col, torch.zeros_like(col))
