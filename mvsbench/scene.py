"""The benchmark's scene generator: calibrated views of an analytic scene,
rendered on the device from the run's seed and written as an MVS dataset.

The scene models are a frozen copy of ``mvskit_tpu_torch/utils/synthetic.py``
at commit 9af5b6f (``procedural_texture``, ``procedural_texture3``,
``ring_cameras``, ``light_dirs``, ``raytrace_view``, ``render_views``,
``visible_surface_points``, ``write_dataset``): the textured plane z = 0,
optionally a sphere resting on it, lambertian shading under each
illumination times a smooth gain field. The rendering is rewritten in
PyTorch so that it runs on the card, and the random draws come from one
``numpy.random.Generator`` seeded with the run's seed (any whole number)
instead of the original's fixed ``RandomState`` streams.

A configuration file gives the dataset's shape (views, width, height,
seed points, engine options); a traffic file gives the scene (geometry,
illuminations, camera ring). ``write_dataset`` writes the reference's
on-disk contract: ``option``, ``image/%04d%04d.ppm`` (view x
illumination), ``txt/%08d.txt`` CONTOUR cameras, ``ply/00000000.ply``
seed points and ``ply/%08d.ply`` per-view normal maps.
"""

from __future__ import annotations

import math
import os
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch


class Scene(NamedTuple):
    Ps: np.ndarray            # [n, 3, 4] level-0 projections
    images: torch.Tensor      # [n, I, H, W, 3] uint8 on the device
    seeds: np.ndarray         # [K, 3] seed points on the surface
    geometry: str
    center: tuple
    radius: float


def rng_for(seed: int) -> np.random.Generator:
    """The run's random source: every whole number is a valid seed."""
    return np.random.default_rng(int(seed) % (1 << 64))


def ring_cameras(n_views: int, width: int, height: int, focal: float, radius: float,
                 elevation: float, arc: float, target=(0.0, 0.0, 0.0)) -> np.ndarray:
    """Pinhole cameras on a ring of `radius` at `elevation` above z = 0,
    covering `arc` of the full circle, looking at `target`. [n, 3, 4]."""
    target = np.asarray(target, dtype=np.float64)
    Ps = []
    for i in range(n_views):
        ang = 2 * math.pi * i / max(n_views, 1) * arc
        C = np.array([radius * math.cos(ang), radius * math.sin(ang), elevation])
        z = target - C
        z /= np.linalg.norm(z)
        x = np.cross(z, np.array([0.0, 0.0, 1.0]))
        if np.linalg.norm(x) < 1e-8:
            x = np.array([1.0, 0.0, 0.0])
        x /= np.linalg.norm(x)
        y = np.cross(z, x)
        R = np.stack([x, y, z])
        K = np.array([[focal, 0.0, width / 2.0], [0.0, focal, height / 2.0], [0.0, 0.0, 1.0]])
        Ps.append(K @ np.concatenate([R, (-R @ C)[:, None]], axis=1))
    return np.stack(Ps)


def light_dirs(nillums: int) -> np.ndarray:
    """Illumination 0 overhead, the others tilted 35 degrees around the
    azimuth ring."""
    dirs = [np.array([0.0, 0.0, 1.0])]
    theta = math.radians(35.0)
    for b in range(1, nillums):
        phi = 2 * math.pi * (b - 1) / max(nillums - 1, 1)
        dirs.append(np.array([math.sin(theta) * math.cos(phi),
                              math.sin(theta) * math.sin(phi), math.cos(theta)]))
    return np.stack(dirs[:nillums])


def texture_params(rng: np.random.Generator, sphere: bool, ncomp: int = 24) -> Dict[str, np.ndarray]:
    """Frequencies, phases and amplitudes of the sum of sines: over the
    plane's (x, y), or over 3-space at a higher band for curved surfaces."""
    if sphere:
        freqs = rng.uniform(2.0, 18.0, size=(3, ncomp, 3))
    else:
        freqs = rng.uniform(0.6, 6.0, size=(3, ncomp, 2))
    phases = rng.uniform(0, 2 * math.pi, size=(3, ncomp))
    amps = rng.uniform(0.3, 1.0, size=(3, ncomp))
    amps /= amps.sum(axis=1, keepdims=True)
    return {"freqs": freqs, "phases": phases, "amps": amps}


def texture(p: torch.Tensor, tp: Dict[str, np.ndarray]) -> torch.Tensor:
    """RGB in [15, 235] at points p [..., 3] (the plane's texture reads x
    and y only). Returns [..., 3]."""
    f = torch.as_tensor(tp["freqs"], dtype=p.dtype, device=p.device)      # [3, K, D]
    ph = torch.as_tensor(tp["phases"], dtype=p.dtype, device=p.device)
    amp = torch.as_tensor(tp["amps"], dtype=p.dtype, device=p.device)
    q = p[..., : f.shape[-1]]
    arg = torch.einsum("...d,ckd->...ck", q, f) + ph
    acc = (amp * torch.sin(arg)).sum(-1)
    return (acc * 0.5 + 0.5) * 220.0 + 15.0


def raytrace(P: np.ndarray, xs: torch.Tensor, ys: torch.Tensor, sphere: bool, center, radius):
    """Trace the rays of pixels (xs, ys) against z = 0 and, with `sphere`,
    the sphere. Returns (points [..., 3], normals [..., 3], hit [...])."""
    dev, dt = xs.device, torch.float64
    M = np.linalg.inv(P[:, :3])
    C = torch.as_tensor(-M @ P[:, 3], dtype=dt, device=dev)
    Minv = torch.as_tensor(M, dtype=dt, device=dev)
    pix = torch.stack([xs.to(dt), ys.to(dt), torch.ones_like(xs, dtype=dt)], -1)
    d = pix @ Minv.T
    t_pl = -C[2] / d[..., 2]
    ok_pl = (t_pl > 1e-9) & torch.isfinite(t_pl)
    inf = torch.full_like(t_pl, math.inf)
    t_pl_eff = torch.where(ok_pl, t_pl, inf)
    if sphere:
        S = torch.as_tensor(center, dtype=dt, device=dev)
        oc = C - S
        a = (d * d).sum(-1)
        b = 2.0 * (d * oc).sum(-1)
        c = float((oc * oc).sum() - radius * radius)
        disc = b * b - 4.0 * a * c
        sq = torch.sqrt(torch.clamp(disc, min=0.0))
        t0 = (-b - sq) / (2.0 * a)
        t1 = (-b + sq) / (2.0 * a)
        t_sp = torch.where(t0 > 1e-9, t0, t1)
        ok_sp = (disc >= 0.0) & (t_sp > 1e-9)
        t_sp_eff = torch.where(ok_sp, t_sp, inf)
        on_sphere = ok_sp & (t_sp_eff < t_pl_eff)
        hit = ok_pl | ok_sp
    else:
        t_sp, on_sphere, hit = t_pl, torch.zeros_like(ok_pl), ok_pl
    t = torch.where(on_sphere, t_sp, t_pl)
    pts = C + t.unsqueeze(-1) * d
    up = torch.tensor([0.0, 0.0, 1.0], dtype=dt, device=dev).expand_as(pts)
    if sphere:
        normal = torch.where(on_sphere.unsqueeze(-1), (pts - S) / radius, up)
    else:
        normal = up
    return pts, normal, hit


def render(Ps: np.ndarray, width: int, height: int, sphere: bool, nillums: int,
           rng: np.random.Generator, center, radius, device) -> torch.Tensor:
    """Every view under every illumination: texture times lambertian
    shading (ambient 0.35) against ``light_dirs``, times for b > 0 a
    smooth gain field; mid-grey where the ray hits nothing. Returns
    uint8 [n, nillums, H, W, 3] on `device`."""
    tp = texture_params(rng, sphere)
    gain_w = rng.uniform(0.6, 1.8, size=(nillums, 3))
    gain_p = rng.uniform(0, 2 * math.pi, size=(nillums,))
    lights = torch.as_tensor(light_dirs(nillums), dtype=torch.float64, device=device)
    ys, xs = torch.meshgrid(torch.arange(height, device=device),
                            torch.arange(width, device=device), indexing="ij")
    out = torch.empty((Ps.shape[0], nillums, height, width, 3), dtype=torch.uint8, device=device)
    for i in range(Ps.shape[0]):
        pts, normal, hit = raytrace(Ps[i], xs, ys, sphere, center, radius)
        tex = texture(pts, tp)
        for b in range(nillums):
            lam = 0.35 + 0.65 * torch.clamp((normal * lights[b]).sum(-1), min=0.0)
            if b == 0:
                gain = torch.ones_like(lam)
            else:
                g = torch.as_tensor(gain_w[b], dtype=pts.dtype, device=device)
                gain = 0.8 + 0.2 * torch.sin((pts * g).sum(-1) + float(gain_p[b]))
            img = torch.where(hit.unsqueeze(-1), tex * (lam * gain).unsqueeze(-1),
                              torch.full_like(tex, 128.0))
            out[i, b] = torch.clamp(torch.floor(img + 0.5), 0, 255).to(torch.uint8)
    return out


def _blocked_by_sphere(C, pts, center, radius) -> np.ndarray:
    """True where the open segment from camera centre C to each point
    passes through the sphere."""
    S = np.asarray(center, dtype=np.float64)
    d = pts - C[None, :]
    L = np.linalg.norm(d, axis=1)
    dn = d / np.maximum(L, 1e-12)[:, None]
    oc = C - S
    b = dn @ oc
    disc = b * b - float(oc @ oc - radius * radius)
    t0 = -b - np.sqrt(np.maximum(disc, 0.0))
    return (disc > 0.0) & (t0 > 1e-6) & (t0 < L - 1e-4)


def visible_surface_points(Ps: np.ndarray, n_points: int, sphere: bool, rng: np.random.Generator,
                           width: int, height: int, extent: float = 1.2, center=(0.0, 0.0, 0.55),
                           radius: float = 0.55, min_vis: int = 2, sphere_frac: float = 0.4,
                           min_facing: float = 0.5):
    """Surface samples seen by at least `min_vis` views: in front of the
    camera, 4 pixels inside the image, facing it within 60 degrees, and
    (with the sphere) not occluded. Returns (points [N, 3], normals [N, 3])."""
    S = np.asarray(center, dtype=np.float64)
    n_sp = int(n_points * sphere_frac) if sphere else 0
    pl = rng.uniform(-extent, extent, size=(n_points - n_sp, 2))
    pts = np.concatenate([pl, np.zeros((pl.shape[0], 1))], axis=1)
    nrm = np.tile([0.0, 0.0, 1.0], (pts.shape[0], 1))
    if sphere:
        keep = np.linalg.norm(pl, axis=1) > radius * 0.25
        pts, nrm = pts[keep], nrm[keep]
        v = rng.normal(size=(n_sp, 3))
        v /= np.linalg.norm(v, axis=1, keepdims=True)
        sp = S[None, :] + radius * v
        sp = sp[sp[:, 2] > 0.05]
        pts = np.concatenate([pts, sp])
        nrm = np.concatenate([nrm, (sp - S[None, :]) / radius])
    vis = np.zeros(pts.shape[0], dtype=np.int64)
    for P in Ps:
        M, q = P[:, :3], P[:, 3]
        C = -np.linalg.inv(M) @ q
        ic = pts @ M.T + q[None, :]
        z = ic[:, 2]
        with np.errstate(divide="ignore", invalid="ignore"):
            x, y = ic[:, 0] / z, ic[:, 1] / z
        ok = (z > 0) & np.isfinite(x) & (x >= 4) & (x < width - 4) & (y >= 4) & (y < height - 4)
        to_cam = C[None, :] - pts
        to_cam /= np.maximum(np.linalg.norm(to_cam, axis=1, keepdims=True), 1e-12)
        ok &= np.einsum("nj,nj->n", to_cam, nrm) > min_facing
        if sphere:
            ok &= ~_blocked_by_sphere(C, pts, center, radius)
        vis += ok
    keep = vis >= min_vis
    return pts[keep], nrm[keep]


def rq_decompose(M: np.ndarray):
    """M = K R, K upper triangular with a positive diagonal, R a rotation."""
    q, r = np.linalg.qr(M[::-1].T)
    K, R = r.T[::-1, ::-1], q.T[::-1]
    s = np.sign(np.diag(K))
    s[s == 0] = 1.0
    K, R = K * s[None, :], R * s[:, None]
    if np.linalg.det(R) < 0:
        K, R = -K, -R
    return K, R


def sphere_of(traffic: dict):
    """The traffic's sphere: (center, radius), where its geometry has one."""
    return (tuple(traffic.get("sphere_center", (0.0, 0.0, 0.55))),
            float(traffic.get("sphere_radius", 0.55)))


def make_scene(config: dict, traffic: dict, seed: int, device) -> Scene:
    """Cameras, rendered images and seed points of a configuration's
    shape under a traffic mix's scene, drawn from `seed`."""
    n, w, h = config["views"], config["width"], config["height"]
    cam = traffic["cameras"]
    sphere = traffic["geometry"] == "sphere"
    center, radius = sphere_of(traffic)
    Ps = ring_cameras(n, w, h, config["focal"], cam["radius"], cam["elevation"], cam["arc"])
    rng = rng_for(seed)
    images = render(Ps, w, h, sphere, traffic["illuminations"], rng, center, radius, device)
    k = config["seed_points"]
    ext = traffic["seed_extent"]
    if sphere:
        seeds, _ = visible_surface_points(Ps, 2 * k, True, rng, w, h, extent=ext,
                                          center=center, radius=radius)
        seeds = seeds[:k]
    else:
        seeds = np.concatenate([rng.uniform(-ext, ext, size=(k, 2)), np.zeros((k, 1))], axis=1)
    return Scene(Ps, images, seeds, traffic["geometry"], center, radius)


def write_ply(path: str, xyz: np.ndarray, normal: Optional[np.ndarray] = None) -> None:
    """A binary little-endian PLY of float32 x y z [nx ny nz]."""
    cols = [np.asarray(xyz, np.float32)]
    props = ["x", "y", "z"]
    if normal is not None:
        cols.append(np.asarray(normal, np.float32))
        props += ["nx", "ny", "nz"]
    data = np.ascontiguousarray(np.concatenate(cols, axis=1), dtype="<f4")
    head = "ply\nformat binary_little_endian 1.0\n" + f"element vertex {data.shape[0]}\n"
    head += "".join(f"property float {p}\n" for p in props) + "end_header\n"
    with open(path, "wb") as f:
        f.write(head.encode())
        f.write(data.tobytes())


def write_dataset(prefix: str, scene: Scene, config: dict, normal_stride: int = 2) -> None:
    """The dataset directory the engine reads: option file (the
    configuration's options, the illuminations, every view), the images
    as binary PPM, CONTOUR cameras, the seed cloud and per-view normal
    maps in the camera frame (pixel-indexed, every `normal_stride`-th
    pixel; the engine rotates them by the view's R)."""
    for d in ("image", "txt", "ply"):
        os.makedirs(os.path.join(prefix, d), exist_ok=True)
    n, nil, h, w = scene.images.shape[:4]
    lines = [f"{k} {v}" for k, v in config["option"].items()]
    if nil > 1:
        lines.append(f"illum {nil}")
    lines.append(f"images -1 0 {n}")
    with open(os.path.join(prefix, "option"), "w") as f:
        f.write("\n".join(lines) + "\n")
    host = scene.images.cpu().numpy()
    for i in range(n):
        for b in range(nil):
            with open(os.path.join(prefix, "image", f"{i:04d}{b:04d}.ppm"), "wb") as f:
                f.write(f"P6\n{w} {h}\n255\n".encode())
                f.write(host[i, b].tobytes())
        flat = scene.Ps[i].reshape(-1)
        with open(os.path.join(prefix, "txt", f"{i:08d}.txt"), "w") as f:
            f.write("CONTOUR\n" + " ".join(repr(float(v)) for v in flat[:6]) + "\n"
                    + " ".join(repr(float(v)) for v in flat[6:12]) + "\n")
    write_ply(os.path.join(prefix, "ply", "00000000.ply"), scene.seeds)
    dev = scene.images.device
    ys, xs = torch.meshgrid(torch.arange(0, h, normal_stride, device=dev),
                            torch.arange(0, w, normal_stride, device=dev), indexing="ij")
    xs, ys = xs.reshape(-1), ys.reshape(-1)
    sphere = scene.geometry == "sphere"
    for i in range(n):
        _, R = rq_decompose(scene.Ps[i][:, :3])
        _, nw, hit = raytrace(scene.Ps[i], xs, ys, sphere, scene.center, scene.radius)
        keep = hit if sphere else torch.ones_like(hit)
        pts = torch.stack([xs, ys, torch.zeros_like(xs)], -1)[keep].to(torch.float64)
        nrm = nw[keep] @ torch.as_tensor(R, dtype=torch.float64, device=dev)
        write_ply(os.path.join(prefix, "ply", f"{i + 1:08d}.ply"),
                  pts.cpu().numpy(), nrm.cpu().numpy())
