"""Stereo rectification remapping (port of orb_slam3_tpu/frontend/rectify.py).

The legacy EuRoC stereo YAML ships per-camera (K, D, R, P) blocks
(`Examples_old/Stereo/EuRoC.yaml:50-81`) that the reference feeds to
cv::initUndistortRectifyMap, and `System::TrackStereo` remaps both images
before tracking (`System.cc:253-265`).

`build_remap` computes the backward map once on the host in numpy (the
initUndistortRectifyMap algorithm, the port's own copy); `remap_bilinear`
applies it per frame as four gathers and a weighted sum, plain torch ops
on any device.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import device as device_mod


def build_remap(K, D, R, P, width: int, height: int) -> np.ndarray:
    """Backward map [H, W, 2] float32: the (x, y) source pixel of each
    rectified pixel. Each rectified pixel is unprojected through P, rotated
    by R^-1 into the original camera, distorted by the rad-tan D and
    projected through K."""
    K = np.asarray(K, np.float64).reshape(3, 3)
    D = np.asarray(D, np.float64).ravel()
    D = np.pad(D, (0, max(0, 5 - len(D))))[:5]
    R = np.asarray(R, np.float64).reshape(3, 3)
    P = np.asarray(P, np.float64).reshape(3, -1)[:, :3]

    u, v = np.meshgrid(np.arange(width), np.arange(height))
    ray = np.stack([u, v, np.ones_like(u)], axis=-1) @ np.linalg.inv(P).T
    ray = ray @ R  # R^-1 = R^T, applied to row vectors
    x = ray[..., 0] / ray[..., 2]
    y = ray[..., 1] / ray[..., 2]
    k1, k2, p1, p2, k3 = D
    r2 = x * x + y * y
    radial = 1.0 + k1 * r2 + k2 * r2 * r2 + k3 * r2 ** 3
    xd = x * radial + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
    yd = y * radial + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
    return np.stack([K[0, 0] * xd + K[0, 2], K[1, 1] * yd + K[1, 2]],
                    axis=-1).astype(np.float32)


def remap_bilinear(img, map_xy):
    """Apply a backward map: img [H, W], map_xy [H', W', 2] -> [H', W'].
    A sample outside the image reads the clamped border (cv::remap's
    BORDER_CONSTANT differs only outside the stereo overlap)."""
    H, W = img.shape
    mx, my = map_xy[..., 0], map_xy[..., 1]
    x0 = torch.clamp(torch.floor(mx).to(torch.int32), 0, W - 2).long()
    y0 = torch.clamp(torch.floor(my).to(torch.int32), 0, H - 2).long()
    fx = torch.clamp(mx - x0, 0.0, 1.0)
    fy = torch.clamp(my - y0, 0.0, 1.0)
    top = img[y0, x0] * (1 - fx) + img[y0, x0 + 1] * fx
    bot = img[y0 + 1, x0] * (1 - fx) + img[y0 + 1, x0 + 1] * fx
    return top * (1 - fy) + bot * fy


class StereoRectifier:
    """The left and right backward maps, made once on `device` (default
    CUDA), applied to each pair (`System.cc:253-265`)."""

    def __init__(self, left: dict, right: dict, width: int, height: int, device=None):
        """left / right: dicts with K [3,3], D [N], R [3,3], P [3,4]."""
        dev = device_mod.resolve(device)
        self.map_l = torch.from_numpy(build_remap(
            left["K"], left["D"], left["R"], left["P"], width, height)).to(dev)
        self.map_r = torch.from_numpy(build_remap(
            right["K"], right["D"], right["R"], right["P"], width, height)).to(dev)

    def __call__(self, img_left, img_right):
        dev = self.map_l.device
        as_t = lambda im: torch.as_tensor(np.asarray(im) if not torch.is_tensor(im) else im,  # noqa: E731
                                          dtype=torch.float32, device=dev)
        return (remap_bilinear(as_t(img_left), self.map_l),
                remap_bilinear(as_t(img_right), self.map_r))
