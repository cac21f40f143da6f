"""Camera models: pinhole and Kannala-Brandt8 fisheye (port of
orb_slam3_tpu/frontend/camera.py).

The reference's GeometricCamera hierarchy (`GeometricCamera.h:61-89`,
`Pinhole.cpp`, `KannalaBrandt8.cpp`) as functions of a parameter vector,
padded to 8 for uniform batching as in the JAX package:
  pinhole: [fx, fy, cx, cy, 0, 0, 0, 0]
  kb8:     [fx, fy, cx, cy, k0, k1, k2, k3]

Projection is differentiable with torch.func.jacfwd (local BA and the KB8
pose BA differentiate through it). Pinhole projection is distortion-free:
rad-tan distortion is removed from the keypoints right after extraction
(`undistort_points_radtan`, the role of `Frame::UndistortKeyPoints`).
"""

from __future__ import annotations

import math

import torch

from .. import device as device_mod

PINHOLE = 0
KB8 = 1


def pinhole_project(params, Xc):
    """[..., 3] camera-frame points -> [..., 2] pixels (valid where z > 0)."""
    fx, fy, cx, cy = params[..., 0], params[..., 1], params[..., 2], params[..., 3]
    z = Xc[..., 2]
    zs = torch.where(z.abs() < 1e-9, torch.full_like(z, 1e-9), z)
    u = fx * Xc[..., 0] / zs + cx
    v = fy * Xc[..., 1] / zs + cy
    return torch.stack([u, v], dim=-1)


def pinhole_unproject(params, uv):
    """Pixels -> unit-depth ray [..., 3] (z = 1)."""
    fx, fy, cx, cy = params[..., 0], params[..., 1], params[..., 2], params[..., 3]
    x = (uv[..., 0] - cx) / fx
    y = (uv[..., 1] - cy) / fy
    return torch.stack([x, y, torch.ones_like(x)], dim=-1)


def _theta_poly(th, k0, k1, k2, k3):
    t2 = th * th
    return th * (1.0 + t2 * (k0 + t2 * (k1 + t2 * (k2 + t2 * k3))))


def kb8_project(params, Xc):
    """Equidistant fisheye with 4 radial terms (KannalaBrandt8::project,
    `KannalaBrandt8.cpp:43-61`). The 1e-18 under the root keeps the
    Jacobian finite on the optical axis. The arithmetic runs on [..., 1]
    slices: under torch.func.jacfwd a 0-dim tensor combined with a Python
    float gets a float64 tangent (torch 2.13), as in lie._theta."""
    fx, fy, cx, cy = (params[..., i:i + 1] for i in range(4))
    k0, k1, k2, k3 = (params[..., i:i + 1] for i in range(4, 8))
    x, y, z = Xc[..., 0:1], Xc[..., 1:2], Xc[..., 2:3]
    r = torch.sqrt(x * x + y * y + 1e-18)
    scale = _theta_poly(torch.atan2(r, z), k0, k1, k2, k3) / r
    return torch.cat([fx * scale * x + cx, fy * scale * y + cy], dim=-1)


def kb8_unproject(params, uv, iters: int = 10):
    """Pixels -> ray [..., 3] with z = 1: the theta polynomial inverted by a
    fixed number of Newton steps from theta = min(r_d, pi/2), as the JAX
    package does (the reference iterates to 1e-6, `KannalaBrandt8.cpp:
    270-305`)."""
    fx, fy, cx, cy = params[..., 0], params[..., 1], params[..., 2], params[..., 3]
    k0, k1, k2, k3 = params[..., 4], params[..., 5], params[..., 6], params[..., 7]
    mx = (uv[..., 0] - cx) / fx
    my = (uv[..., 1] - cy) / fy
    r_d = torch.sqrt(mx * mx + my * my + 1e-18)
    th = torch.clamp(r_d, max=math.pi / 2)
    for _ in range(iters):
        t2 = th * th
        f = _theta_poly(th, k0, k1, k2, k3) - r_d
        df = 1.0 + t2 * (3 * k0 + t2 * (5 * k1 + t2 * (7 * k2 + t2 * 9 * k3)))
        th = th - f / torch.where(df.abs() < 1e-9, torch.full_like(df, 1e-9), df)
    scale = torch.tan(th) / r_d
    return torch.stack([mx * scale, my * scale, torch.ones_like(mx)], dim=-1)


def project(kind: int, params, Xc):
    """Dispatch on the camera kind (a Python int)."""
    if kind == PINHOLE:
        return pinhole_project(params, Xc)
    if kind == KB8:
        return kb8_project(params, Xc)
    raise ValueError(f"unknown camera kind {kind}")


def unproject(kind: int, params, uv):
    if kind == PINHOLE:
        return pinhole_unproject(params, uv)
    if kind == KB8:
        return kb8_unproject(params, uv)
    raise ValueError(f"unknown camera kind {kind}")


def make_pinhole(fx, fy, cx, cy, device=None):
    """Pinhole parameter vector [8] float32 on `device` (default CUDA)."""
    return torch.tensor(
        [fx, fy, cx, cy, 0, 0, 0, 0], dtype=torch.float32,
        device=device_mod.resolve(device),
    )


def make_kb8(fx, fy, cx, cy, k0, k1, k2, k3, device=None):
    """KB8 parameter vector [8] float32 on `device` (default CUDA)."""
    return torch.tensor(
        [fx, fy, cx, cy, k0, k1, k2, k3], dtype=torch.float32,
        device=device_mod.resolve(device),
    )


def undistort_points_radtan(K_params, dist, uv, iters: int = 5):
    """Undistort pixel keypoints under the OpenCV rad-tan model (k1, k2,
    p1, p2, k3) by 5 fixed-point steps, as the JAX package does (the role
    of cv::undistortPoints in `Frame::UndistortKeyPoints`,
    `Frame.cc:747-780`). Returns pixels under the same K."""
    fx, fy, cx, cy = K_params[..., 0], K_params[..., 1], K_params[..., 2], K_params[..., 3]
    k1, k2, p1, p2, k3 = dist[..., 0], dist[..., 1], dist[..., 2], dist[..., 3], dist[..., 4]
    xd = (uv[..., 0] - cx) / fx
    yd = (uv[..., 1] - cy) / fy
    x, y = xd, yd
    for _ in range(iters):
        r2 = x * x + y * y
        rad = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
        xdist = x * rad + (2 * p1 * x * y + p2 * (r2 + 2 * x * x))
        ydist = y * rad + (p1 * (r2 + 2 * y * y) + 2 * p2 * x * y)
        x, y = x + (xd - xdist), y + (yd - ydist)
    return torch.stack([x * fx + cx, y * fy + cy], dim=-1)
