"""The benchmark's scene: a textured room ray-cast on the device.

Frozen copy of `orb_slam3_tpu_torch/entry.py` at commit 356070c
(`_blur`, `plane_texture`, `room_scene`, `QuadScene._cast`,
`radtan_undistort_np`), which copies tests/synthetic_scene.py. The
benchmark keeps its own copy so that a change to the program cannot change
the inputs it is measured on. It imports nothing of the program.

Changes from the original: rays come from a camera with rad-tan distortion
(each raw pixel undistorted once), the exposure jitter and the noise are
drawn on the device from a `torch.Generator`, and a whole lap is rendered
into host arrays in the types a user's player hands in (8-bit grey, 16-bit
depth in DepthMapFactor units).
"""

from __future__ import annotations

import numpy as np
import torch

RADTAN_NEWTON_STEPS = 20


def blur(img, ksize: int = 3, sigma: float = 0.8):
    """ksize x ksize Gaussian with reflect-101 borders, separable, float32."""
    r = ksize // 2
    w = np.exp(-np.arange(-r, r + 1, dtype=np.float64) ** 2 / (2.0 * sigma * sigma))
    w = (w / w.sum()).astype(np.float32)
    p = np.pad(img, r, mode="reflect")
    h, wd = img.shape
    rows = sum(w[k] * p[:, k:k + wd] for k in range(ksize))
    return sum(w[k] * rows[k:k + h] for k in range(ksize))


def plane_texture(seed: int, size: int = 1024, blobs: int = 4000):
    """A blob texture: `blobs` rectangles of random grey, then a 3x3 blur."""
    rng = np.random.default_rng(seed)
    tex = np.zeros((size, size), np.float32)
    xs = rng.integers(0, size - 14, blobs)
    ys = rng.integers(0, size - 14, blobs)
    for x, y in zip(xs, ys):
        w, h = rng.integers(4, 14, 2)
        tex[y:y + h, x:x + w] = rng.uniform(40, 255)
    return blur(tex)


def room_quads(seed: int, half: float, wall_h: float, n_panels: int):
    """A square room (four walls, floor, ceiling) and a ring of free-standing
    panels facing its centre; each quad is (p0, ex, ey, texture seed). The
    world's y axis points down (gravity +y), as the camera's y does."""
    S, H = half, wall_h
    quads = [
        (np.array([-S, -H, S]), np.array([2 * S, 0, 0]), np.array([0, 2 * H, 0]), 1),
        (np.array([S, -H, -S]), np.array([-2 * S, 0, 0]), np.array([0, 2 * H, 0]), 2),
        (np.array([S, -H, S]), np.array([0, 0, -2 * S]), np.array([0, 2 * H, 0]), 3),
        (np.array([-S, -H, -S]), np.array([0, 0, 2 * S]), np.array([0, 2 * H, 0]), 4),
        (np.array([-S, H, -S]), np.array([2 * S, 0, 0]), np.array([0, 0, 2 * S]), 5),
        (np.array([-S, -H, -S]), np.array([2 * S, 0, 0]), np.array([0, 0, 2 * S]), 6),
    ]
    rng = np.random.default_rng(seed + 37)
    for j in range(n_panels):
        a = 2 * np.pi * (j + rng.uniform(-0.2, 0.2)) / max(n_panels, 1)
        r = rng.uniform(0.55, 0.8) * S
        cx, cz = r * np.sin(a), r * np.cos(a)
        pw = rng.uniform(1.0, 1.8)
        ph = rng.uniform(0.8, 1.4)
        y0 = rng.uniform(-0.9, 0.2)
        ex = np.array([np.cos(a), 0.0, -np.sin(a)]) * pw
        ey = np.array([0.0, 1.0, 0.0]) * ph
        quads.append((np.array([cx, y0, cz]) - 0.5 * ex, ex, ey, 20 + j))
    return [(p0.astype(np.float64), ex.astype(np.float64), ey.astype(np.float64), ts)
            for p0, ex, ey, ts in quads]


def radtan_rays(K, D, img_wh):
    """[H, W, 3] float64 rays (z = 1) of the raw pixels of a pinhole camera
    K = (fx, fy, cx, cy) with rad-tan distortion D = (k1, k2, p1, p2, k3):
    Newton steps on the distortion map, converged to ~1e-12."""
    fx, fy, cx, cy = (float(v) for v in K[:4])
    k1, k2, p1, p2, k3 = (float(v) for v in np.pad(np.ravel(D), (0, 5))[:5])
    w, h = img_wh
    us, vs = np.meshgrid(np.arange(w, dtype=np.float64), np.arange(h, dtype=np.float64))
    xd, yd = (us - cx) / fx, (vs - cy) / fy
    x, y = xd.copy(), yd.copy()
    for _ in range(RADTAN_NEWTON_STEPS):
        r2 = x * x + y * y
        rad = 1 + r2 * (k1 + r2 * (k2 + r2 * k3))
        drad = k1 + r2 * (2 * k2 + 3 * k3 * r2)
        ex = x * rad + 2 * p1 * x * y + p2 * (r2 + 2 * x * x) - xd
        ey = y * rad + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y - yd
        jxx = rad + 2 * x * x * drad + 2 * p1 * y + 6 * p2 * x
        jxy = 2 * x * y * drad + 2 * p1 * x + 2 * p2 * y
        jyy = rad + 2 * y * y * drad + 6 * p1 * y + 2 * p2 * x
        det = jxx * jyy - jxy * jxy
        x, y = x - (jyy * ex - jxy * ey) / det, y - (jxx * ey - jxy * ex) / det
    return np.stack([x, y, np.ones_like(x)], -1)


def distort(K, D, X):
    """Raw pixel coordinates [N, 2] of camera points X [N, 3] (the rad-tan
    model the rays above invert)."""
    fx, fy, cx, cy = (float(v) for v in K[:4])
    k1, k2, p1, p2, k3 = (float(v) for v in np.pad(np.ravel(D), (0, 5))[:5])
    x, y = X[:, 0] / X[:, 2], X[:, 1] / X[:, 2]
    r2 = x * x + y * y
    rad = 1 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xd = x * rad + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
    yd = y * rad + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
    return np.stack([fx * xd + cx, fy * yd + cy], -1)


class Room:
    """The room of `room_quads`, cast on `device` through a camera's rays."""

    def __init__(self, seed: int, rays, device, half=6.0, wall_h=2.2, n_panels=10,
                 smooth_texture=True):
        self.device = device
        self.quads = room_quads(seed, half, wall_h, n_panels)
        texs = {}
        for _, _, _, ts in self.quads:
            t = plane_texture(seed + ts)
            texs[ts] = blur(t, 5, 1.2) if smooth_texture else t
        self._tex = [torch.from_numpy(np.ascontiguousarray(texs[q[3]])).to(device)
                     for q in self.quads]
        self._rays = torch.from_numpy(np.ascontiguousarray(rays)).to(device)

    def cast(self, R_cw, t_cw):
        """(image, depth) float32 tensors on the device: the nearest quad hit
        along each pixel's ray, sampled bilinearly; depth is the camera z of
        the hit (rays have z = 1), 0 where nothing is hit."""
        f64 = dict(dtype=torch.float64, device=self.device)
        h, w = self._rays.shape[:2]
        R_wc = torch.as_tensor(np.asarray(R_cw, np.float64).T, **f64)
        c = -R_wc @ torch.as_tensor(np.asarray(t_cw, np.float64), **f64)
        rays_w = self._rays @ R_wc.T
        img = torch.zeros((h, w), dtype=torch.float32, device=self.device)
        depth = torch.full((h, w), float("inf"), dtype=torch.float32, device=self.device)
        for (p0, ex, ey, _), tex in zip(self.quads, self._tex):
            p0, ex, ey = (torch.as_tensor(v, **f64) for v in (p0, ex, ey))
            n = torch.linalg.cross(ex, ey)
            n = n / torch.linalg.norm(n)
            denom = rays_w @ n
            denom = torch.where(denom.abs() < 1e-9, 1e-9, denom)
            lam = ((p0 - c) @ n) / denom
            d = c + lam[..., None] * rays_w - p0
            tx = d @ ex / (ex @ ex)
            ty = d @ ey / (ey @ ey)
            inside = ((lam > 0.05) & (tx >= 0) & (tx <= 1) & (ty >= 0) & (ty <= 1)
                      & (lam < depth))
            size = tex.shape[0]
            tu = (tx * (size - 1)).to(torch.float32)
            tv = (ty * (size - 1)).to(torch.float32)
            u0 = torch.clamp(torch.floor(tu), 0, size - 2).long()
            v0 = torch.clamp(torch.floor(tv), 0, size - 2).long()
            a_ = torch.clamp(tu - u0, 0.0, 1.0).to(torch.float64)
            b_ = torch.clamp(tv - v0, 0.0, 1.0).to(torch.float64)
            val = ((1 - a_) * (1 - b_) * tex[v0, u0] + a_ * (1 - b_) * tex[v0, u0 + 1]
                   + (1 - a_) * b_ * tex[v0 + 1, u0] + a_ * b_ * tex[v0 + 1, u0 + 1])
            img = torch.where(inside, val.to(torch.float32), img)
            depth = torch.where(inside, lam.to(torch.float32), depth)
        depth = torch.where(torch.isfinite(depth), depth, 0.0)
        return img, depth

    def render_lap(self, R_cw, t_cw, gen, exposure_jitter=0.0, noise=0.0,
                   depth_factor=None):
        """Host arrays of a lap: images [N, H, W] uint8 and, with a
        depth_factor (RGBD.DepthMapFactor), depths [N, H, W] uint16 in its
        units (0: no reading, as beyond 65535). Exposure jitter and noise
        come from the device generator `gen`."""
        n = len(R_cw)
        h, w = self._rays.shape[:2]
        imgs = np.empty((n, h, w), np.uint8)
        depths = np.empty((n, h, w), np.uint16) if depth_factor is not None else None
        for i in range(n):
            img, depth = self.cast(R_cw[i], t_cw[i])
            if exposure_jitter > 0:
                u = torch.rand((), generator=gen, device=self.device)
                img = img * (1.0 + exposure_jitter * (2.0 * u - 1.0))
            if noise > 0:
                img = img + noise * torch.randn(img.shape, generator=gen, device=self.device)
            img = torch.clamp(torch.round(img), 0, 255).to(torch.uint8)
            imgs[i] = img.cpu().numpy()
            if depths is not None:
                d = torch.round(depth * depth_factor)
                d = torch.where(d > 65535, 0.0, d).to(torch.int32)
                depths[i] = d.cpu().numpy().astype(np.uint16)
        return imgs, depths

    def surface_distance(self, X):
        """Distance [N] from world points X [N, 3] to the nearest quad."""
        best = np.full(len(X), np.inf)
        for p0, ex, ey, _ in self.quads:
            d = X - p0
            tx = np.clip(d @ ex / (ex @ ex), 0.0, 1.0)
            ty = np.clip(d @ ey / (ey @ ey), 0.0, 1.0)
            q = p0 + tx[:, None] * ex + ty[:, None] * ey
            best = np.minimum(best, np.linalg.norm(X - q, axis=1))
        return best
