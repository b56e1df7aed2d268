"""Vectorized pinhole camera model (port of ``mvskit_tpu/geometry/camera.py``).

All cameras of a scene live in one ``CameraSet`` of float32 tensors.
The per-level projection is ``P_level = diag(2^-l, 2^-l, 1) @ P_0``, so
only ``P_0`` is stored and a level may be a per-sample tensor.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch

from ..utils import profiling

# Sentinel returned by project() for points behind the camera
# (reference camera.cpp:313-315).
BEHIND = -65535.0


class CameraSet(NamedTuple):
    """All cameras of a scene as float32 tensors (n = number of views).

      P [n, 3, 4], Minv [n, 3, 3], center [n, 4], oaxis [n, 4],
      xaxis / yaxis / zaxis [n, 3], ipscale [n], ipscale_cam [n]
    (field meanings as in ``mvskit_tpu.geometry.camera.CameraSet``)."""

    P: torch.Tensor
    Minv: torch.Tensor
    center: torch.Tensor
    oaxis: torch.Tensor
    xaxis: torch.Tensor
    yaxis: torch.Tensor
    zaxis: torch.Tensor
    ipscale: torch.Tensor
    ipscale_cam: torch.Tensor

    @property
    def n_images(self) -> int:
        return self.P.shape[0]


# ----------------------------------------------------------------------
# Construction (host-side numpy). quat2proj, proj2quat,
# projection_from_params, parse_camera_file and write_camera_file are
# copied from mvskit_tpu/geometry/camera.py, which imports jax.
# ----------------------------------------------------------------------

def quat2proj(q: Sequence[float]) -> np.ndarray:
    """Euler-angle (degrees) + translation -> 4x4 [R|t] (camera.cpp:241-261)."""
    a, b, g = (math.radians(q[0]), math.radians(q[1]), math.radians(q[2]))
    s1, s2, s3 = math.sin(a), math.sin(b), math.sin(g)
    c1, c2, c3 = math.cos(a), math.cos(b), math.cos(g)
    proj = np.zeros((4, 4), dtype=np.float64)
    proj[0, 0] = c2 * c3
    proj[0, 1] = c3 * s2 * s1 - s3 * c1
    proj[1, 0] = s3 * c2
    proj[1, 1] = s3 * s2 * s1 + c3 * c1
    proj[2, 0] = -s2
    proj[2, 1] = c2 * s1
    proj[0, 2] = c3 * s2 * c1 + s3 * s1
    proj[1, 2] = s3 * s2 * c1 - c3 * s1
    proj[2, 2] = c2 * c1
    proj[0, 3] = q[3]
    proj[1, 3] = q[4]
    proj[2, 3] = q[5]
    proj[3, 3] = 1.0
    return proj


def proj2quat(proj: np.ndarray) -> np.ndarray:
    """4x4 [R|t] -> Euler angles (degrees) + translation (camera.cpp:199-239)."""
    q = np.zeros(6, dtype=np.float64)
    q[3:6] = proj[0:3, 3]
    if proj[2, 0] == 1.0:
        q[1] = -math.pi / 2.0
        q[2] = 0.0
        q[0] = math.atan2(-proj[0, 1], proj[1, 1])
    elif proj[2, 0] == -1.0:
        q[1] = math.pi / 2.0
        q[2] = 0.0
        q[0] = math.atan2(proj[0, 1], proj[1, 1])
    else:
        q[1] = math.asin(-proj[2, 0])
        s = 1.0 if math.cos(q[1]) > 0.0 else -1.0
        q[0] = math.atan2(proj[2, 1] * s, proj[2, 2] * s)
        q[2] = math.atan2(proj[1, 0] * s, proj[0, 0] * s)
    q[0:3] = np.degrees(q[0:3])
    for i in range(3):
        if abs(q[i]) > 180.0:
            q[i] = q[i] - 360.0 if q[i] > 0 else q[i] + 360.0
    return q

def projection_from_params(
    intrinsics: Sequence[float], extrinsics: Sequence[float], txt_type: int
) -> np.ndarray:
    """Build the level-0 3x4 projection (reference camera.cpp:102-141)."""
    if txt_type == 0:  # CONTOUR: 12 raw entries, row-major
        params = list(intrinsics) + list(extrinsics)
        return np.array(params, dtype=np.float64).reshape(3, 4)
    if txt_type == 2:  # CONTOUR2: K(fx, fy, skew, cx, cy) * [R|t]
        fx, fy, skew, cx, cy = intrinsics[0], intrinsics[1], intrinsics[2], \
            intrinsics[3], intrinsics[4]
        K = np.array(
            [
                [fx, skew, cx, 0.0],
                [0.0, fy, cy, 0.0],
                [0.0, 0.0, 1.0, 0.0],
                [0.0, 0.0, 0.0, 1.0],
            ],
            dtype=np.float64,
        )
        Rt = quat2proj(extrinsics)
        return (K @ Rt)[0:3, 0:4]
    raise ValueError(f"Unsupported camera txt type: {txt_type}")


def parse_camera_file(path: str) -> Tuple[np.ndarray, np.ndarray, int]:
    """Read a CONTOUR/CONTOUR2 camera text file (camera.cpp:27-55)."""
    with open(path, "r") as f:
        tokens = f.read().split()
    header = tokens[0]
    if header == "CONTOUR":
        txt_type = 0
    elif header == "CONTOUR2":
        txt_type = 2
    elif header == "CONTOUR3":
        txt_type = 3
    else:
        raise ValueError(f"Unrecognizable camera text format: {header}")
    vals = [float(t) for t in tokens[1:13]]
    return np.array(vals[:6]), np.array(vals[6:12]), txt_type


def write_camera_file(path: str, intrinsics, extrinsics, txt_type: int) -> None:
    """Write a camera file (reference camera.cpp:263-292)."""
    with open(path, "w") as f:
        if txt_type == 0:
            f.write("CONTOUR\n")
        elif txt_type == 2:
            f.write("CONTOUR2\n")
        else:
            raise ValueError(f"Incorrect txt type {txt_type}")
        f.write(" ".join(repr(float(v)) for v in intrinsics) + "\n")
        f.write(" ".join(repr(float(v)) for v in extrinsics) + "\n")

def make_camera_set(projections: np.ndarray, device) -> CameraSet:
    """Derive all per-camera quantities from level-0 P matrices in
    float64 numpy, then cast each to a float32 tensor on `device`.

    Mirrors Camera::updateCamera (camera.cpp:65-89) + Optim::setAxesScales
    (optim.cpp:43-65)."""
    P = np.asarray(projections, dtype=np.float64)
    if P.ndim != 3 or P.shape[1:] != (3, 4):
        raise ValueError(f"projections must be [n, 3, 4], got {P.shape}")
    n = P.shape[0]

    M = P[:, :, :3]
    q = P[:, :, 3]
    Minv = np.linalg.inv(M)
    center3 = -np.einsum("nij,nj->ni", Minv, q)
    center = np.concatenate([center3, np.ones((n, 1))], axis=1)

    oaxis = P[:, 2, :].copy()
    oaxis /= np.linalg.norm(oaxis[:, :3], axis=1, keepdims=True)

    zaxis = oaxis[:, :3].copy()
    xaxis = P[:, 0, :3].copy()
    yaxis = np.cross(zaxis, xaxis)
    yaxis /= np.linalg.norm(yaxis, axis=1, keepdims=True)
    xaxis = np.cross(yaxis, zaxis)

    fx = np.einsum("ni,ni->n", P[:, 0, :3], xaxis)
    fy = np.einsum("ni,ni->n", P[:, 1, :3], yaxis)
    ipscale = fx + fy

    n0 = np.linalg.norm(P[:, 0, :3], axis=1)
    n1 = np.linalg.norm(P[:, 1, :3], axis=1)
    ipscale_cam = (n0 + n1) / 2.0
    ipscale_cam = np.where(ipscale_cam == 0.0, 1.0, ipscale_cam)

    def conv(a):
        with profiling.sync("cameras.copy"):
            return torch.as_tensor(
                np.asarray(a, dtype=np.float32), device=device
            )

    return CameraSet(
        P=conv(P),
        Minv=conv(Minv),
        center=conv(center),
        oaxis=conv(oaxis),
        xaxis=conv(xaxis),
        yaxis=conv(yaxis),
        zaxis=conv(zaxis),
        ipscale=conv(ipscale),
        ipscale_cam=conv(ipscale_cam),
    )


def load_camera_set(paths: Sequence[str], device) -> CameraSet:
    projs = []
    for p in paths:
        intr, extr, txt_type = parse_camera_file(p)
        projs.append(projection_from_params(intr, extr, txt_type))
    return make_camera_set(np.stack(projs), device)


# ----------------------------------------------------------------------
# Device-side geometry. `index` is an integer tensor (or int), `coord`
# is homogeneous with w = 1; everything broadcasts over leading dims.
# ----------------------------------------------------------------------

def level_scale(level):
    """2^level as float32: a Python float for an int level, a tensor for
    a per-sample level tensor."""
    if isinstance(level, torch.Tensor):
        return torch.exp2(level.to(torch.float32))
    return float(2.0 ** level)


def _matvec(M, v):
    """[..., i, j] @ [..., j] -> [..., i]."""
    return (M * v.unsqueeze(-2)).sum(-1)


def project(cams: CameraSet, index, coord, level=0):
    """Project homogeneous points into view `index` at pyramid `level`.

    Returns (xy[..., 2], depth_denominator[...], valid[...]). Points
    behind the camera get the BEHIND sentinel and valid=False
    (camera.cpp:310-326)."""
    ic = _matvec(cams.P[index], coord)
    z = ic[..., 2]
    valid = z > 0.0
    safe_z = torch.where(valid, z, torch.ones_like(z))
    xy = ic[..., :2] / (safe_z * level_scale(level)).unsqueeze(-1)
    xy = xy.clamp(-1e9, 1e9)
    xy = torch.where(valid.unsqueeze(-1), xy, torch.full_like(xy, BEHIND))
    return xy, z, valid


def project_xy_lists(cams: CameraSet, index, coord, level=0):
    """Camera::project for a [N] coord batch against a [N, M] view-index
    list: one [N, 4] @ [4, 3V] float32 matmul projects every point into
    every view, then each list entry picks its view's row (an exact
    selection). Behind-camera pairs get BEHIND and valid=False.

    Returns (x[N, M], y[N, M], valid[N, M])."""
    V = cams.P.shape[0]
    N = coord.shape[0]
    Pcat = cams.P.reshape(V * 3, 4).T  # [4, 3V]
    q = (coord.to(torch.float32) @ Pcat).reshape(N, V, 3)
    rows = torch.arange(N, device=coord.device).unsqueeze(1)
    sel = q[rows, index.long()]  # [N, M, 3]
    ix, iy, iz = sel[..., 0], sel[..., 1], sel[..., 2]
    valid = iz > 0.0
    safe_z = torch.where(valid, iz, torch.ones_like(iz)) * level_scale(level)
    x = (ix / safe_z).clamp(-1e9, 1e9)
    y = (iy / safe_z).clamp(-1e9, 1e9)
    x = torch.where(valid, x, torch.full_like(x, BEHIND))
    y = torch.where(valid, y, torch.full_like(y, BEHIND))
    return x, y, valid


def unproject(cams: CameraSet, index, xy, pz, level=0):
    """Inverse of projection (camera.cpp:329-337). `xy` is the pixel
    coordinate at `level`; `pz` the projective depth. Returns [..., 4]."""
    s = level_scale(level)
    b = torch.stack(
        [xy[..., 0] * s * pz, xy[..., 1] * s * pz, pz], dim=-1
    ) - cams.P[index][..., :, 3]
    pt3 = _matvec(cams.Minv[index], b)
    return torch.cat([pt3, torch.ones_like(pt3[..., :1])], dim=-1)


def compute_depth(cams: CameraSet, index, coord):
    """Optical-axis depth (camera.cpp:339-346)."""
    return (cams.oaxis[index] * coord).sum(-1)


def _norm(v):
    return torch.linalg.vector_norm(v, dim=-1)


def get_unit(cams: CameraSet, index, coord, level):
    """Pixel footprint in scene units (optim.cpp:34-41):
    2 * ||coord - center|| * 2^level / (fx + fy)."""
    fz = _norm(coord - cams.center[index])
    ips = cams.ipscale[index]
    zero = ips == 0.0
    unit = 2.0 * fz * level_scale(level) / torch.where(
        zero, torch.ones_like(ips), ips
    )
    return torch.where(zero, torch.ones_like(unit), unit)


def get_paxes(cams: CameraSet, index, coord, normal, level):
    """Patch-plane axes scaled to ~1 pixel in view `index`
    (Optim::getPAxes, optim.cpp:67-84). Returns (pxaxis[..., 4],
    pyaxis[..., 4])."""
    pscale = get_unit(cams, index, coord, level)
    normal3 = normal[..., :3]
    xcam = cams.xaxis[index]
    normal3, xcam = torch.broadcast_tensors(normal3, xcam)
    yaxis3 = torch.linalg.cross(normal3, xcam, dim=-1)
    yaxis3 = yaxis3 / _safe_norm(yaxis3)
    xaxis3 = torch.linalg.cross(yaxis3, normal3, dim=-1)

    zeros = torch.zeros_like(xaxis3[..., :1])
    pxaxis = torch.cat([xaxis3, zeros], dim=-1) * pscale.unsqueeze(-1)
    pyaxis = torch.cat([yaxis3, zeros], dim=-1) * pscale.unsqueeze(-1)

    c_xy, _, _ = project(cams, index, coord, level)
    px_xy, _, _ = project(cams, index, coord + pxaxis, level)
    py_xy, _, _ = project(cams, index, coord + pyaxis, level)
    xdis = _safe_norm(px_xy - c_xy)[..., 0]
    ydis = _safe_norm(py_xy - c_xy)[..., 0]
    return pxaxis / xdis.unsqueeze(-1), pyaxis / ydis.unsqueeze(-1)


def get_scale_cam(cams: CameraSet, index, coord, level):
    """Camera::getScale with the mean-row-norm ipscale (camera.cpp:349-364)."""
    ray = coord - cams.center[index]
    return _norm(ray) * level_scale(level) / cams.ipscale_cam[index]


def _safe_norm(v, eps=1e-20):
    return torch.sqrt(torch.clamp((v * v).sum(-1, keepdim=True), min=eps))
