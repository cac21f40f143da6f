"""Pinhole camera model (port of the pinhole part of
orb_slam3_tpu/frontend/camera.py).

Parameter layout padded to 8 for uniform batching, as in the JAX package:
pinhole [fx, fy, cx, cy, 0, 0, 0, 0]. Projection is distortion-free; the
reference undistorts keypoints at frame construction. The Kannala-Brandt
fisheye model and rad-tan undistortion arrive with the fisheye/stereo slice.
"""

from __future__ import annotations

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


def _only_pinhole(kind: int):
    if kind != PINHOLE:
        raise NotImplementedError(
            "the KB8 fisheye model is not ported yet (fisheye/stereo slice)"
        )


def project(kind: int, params, Xc):
    _only_pinhole(kind)
    return pinhole_project(params, Xc)


def unproject(kind: int, params, uv):
    _only_pinhole(kind)
    return pinhole_unproject(params, uv)


def make_pinhole(fx, fy, cx, cy, device=None):
    """Pinhole parameter vector [8] float32 on `device` (default CUDA)."""
    return torch.tensor(
        [fx, fy, cx, cy, 0, 0, 0, 0], dtype=torch.float32,
        device=device_mod.resolve(device),
    )
