"""Image pyramid and Gaussian blur (port of orb_slam3_tpu/frontend/pyramid.py).

Role of `ORBextractor::ComputePyramid` (8 levels, scale 1.2) and the 7x7
sigma=2 GaussianBlur applied before descriptor sampling. Each level
resamples LEVEL 0 with the same numpy bilinear weight matrices as the JAX
package, as two f32 matmuls; the blur is 2 x 7 shifted weighted adds with
reflect-101 padding (no cuDNN convolution).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F


def level_shapes(h: int, w: int, n_levels: int, scale: float):
    """Static per-level (H, W) list, mirroring the reference's rounding."""
    shapes = []
    for lvl in range(n_levels):
        s = 1.0 / (scale ** lvl)
        shapes.append((int(round(h * s)), int(round(w * s))))
    return shapes


def _bilinear_weight_np(n_out: int, n_in: int):
    """[n_out, n_in] bilinear resampling matrix with half-pixel centers
    (in = (out + 0.5) * n_in / n_out - 0.5, edge-clamped)."""
    W = np.zeros((n_out, n_in), np.float32)
    s = n_in / n_out
    for o in range(n_out):
        c = (o + 0.5) * s - 0.5
        lo = int(np.floor(c))
        frac = c - lo
        W[o, np.clip(lo, 0, n_in - 1)] += 1.0 - frac
        W[o, np.clip(lo + 1, 0, n_in - 1)] += frac
    return W


@lru_cache(maxsize=16)
def _resize_weights_np(h: int, w: int, n_levels: int, scale: float):
    shapes = level_shapes(h, w, n_levels, scale)
    return [
        (_bilinear_weight_np(hl, h), np.ascontiguousarray(_bilinear_weight_np(wl, w).T))
        for hl, wl in shapes[1:]
    ]


_DEVICE_WEIGHTS: dict = {}


def _resize_weights(h, w, n_levels, scale, device):
    key = (h, w, n_levels, scale, str(device))
    if key not in _DEVICE_WEIGHTS:
        _DEVICE_WEIGHTS[key] = [
            (torch.from_numpy(Wh).to(device), torch.from_numpy(Ww).to(device))
            for Wh, Ww in _resize_weights_np(h, w, n_levels, scale)
        ]
    return _DEVICE_WEIGHTS[key]


def build_pyramid(img, n_levels: int = 8, scale: float = 1.2):
    """img [H, W] float32 in [0, 255] -> list of [H_l, W_l] tensors.
    Level l = Wh_l @ img @ Ww_l (bilinear, no error accumulation)."""
    h, w = img.shape
    levels = [img]
    for Wh, Ww in _resize_weights(h, w, n_levels, float(scale), img.device):
        levels.append((Wh @ img) @ Ww)
    return levels


def _gauss_kernel1d(ksize: int, sigma: float, device):
    x = torch.arange(ksize, dtype=torch.float32, device=device) - (ksize - 1) / 2.0
    k = torch.exp(-0.5 * (x / sigma) ** 2)
    return k / torch.sum(k)


def gaussian_blur(img, ksize: int = 7, sigma: float = 2.0):
    """Separable Gaussian blur, reflect-101 padding, [H, W] -> [H, W]
    (cv::GaussianBlur(..., Size(7,7), 2, 2, BORDER_REFLECT_101))."""
    k = _gauss_kernel1d(ksize, sigma, img.device)
    pad = ksize // 2
    h, w = img.shape
    x = F.pad(img[None], (0, 0, pad, pad), mode="reflect")[0]
    acc = k[0] * x[0:h]
    for i in range(1, ksize):
        acc = acc + k[i] * x[i:i + h]
    x = F.pad(acc[None], (pad, pad, 0, 0), mode="reflect")[0]
    out = k[0] * x[:, 0:w]
    for i in range(1, ksize):
        out = out + k[i] * x[:, i:i + w]
    return out
