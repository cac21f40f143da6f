"""FAST-9/16 corner detection as dense tensor ops (port of
orb_slam3_tpu/frontend/fast.py).

Role of the per-cell cv::FAST calls in `ORBextractor::ComputeKeyPointsOctTree`:
segment test on the 16-pixel Bresenham circle (arc >= 9), OpenCV-compatible
corner score, 3x3 non-max suppression, and the two-threshold policy
(iniThFAST with a minThFAST retry in cells where the high threshold fires
nothing). Every pixel is scored at once as [H, W] maps.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# Bresenham circle radius 3, OpenCV pixel order (dx, dy), clockwise from top
CIRCLE = (
    (0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
    (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2), (-1, -3),
)
ARC = 9  # contiguous arc length for FAST-9/16


def _shifted(img, dx, dy):
    """img[..., y+dy, x+dx], wrapping around at the borders like the JAX
    package's jnp.roll (the border band is masked out later)."""
    return torch.roll(img, shifts=(-dy, -dx), dims=(-2, -1))


def _arc_reduce_min(v16):
    """[16, H, W] -> min over the 9-long circular arc starting at each index
    (log-step windowed reduction)."""
    v = torch.cat([v16, v16], dim=0)
    w2 = torch.minimum(v[:16], v[1:17])
    v2 = torch.cat([w2, w2], dim=0)
    w4 = torch.minimum(v2[:16], v2[2:18])
    v4 = torch.cat([w4, w4], dim=0)
    w8 = torch.minimum(v4[:16], v4[4:20])
    v8 = torch.cat([w8, w8], dim=0)
    return torch.minimum(v8[:16], v[8:24])


def fast_score(img):
    """Threshold-free FAST-9/16 score map [..., H, W]: the max over arc starts of
    the arc-min signed difference (bright) or its negation (dark). A pixel
    is a corner at threshold t exactly when the score exceeds t."""
    img = img.to(torch.float32)
    diffs = torch.stack([_shifted(img, dx, dy) for dx, dy in CIRCLE]) - img[None]
    score_b = torch.amax(_arc_reduce_min(diffs), dim=0)
    score_d = torch.amax(_arc_reduce_min(-diffs), dim=0)
    return torch.maximum(score_b, score_d)


def nonmax_3x3(score):
    """Keep pixels that are the max of their 3x3 neighbourhood (-inf
    padding); score [H, W] or [B, H, W]."""
    mx = F.max_pool2d(score.unsqueeze(-3), 3, stride=1, padding=1).squeeze(-3)
    return torch.where((score >= mx) & (score > 0.0), score, torch.zeros_like(score))


def detect(img, hi_threshold: float = 20.0, lo_threshold: float = 7.0,
           cell: int = 35, border: int = 16):
    """Dual-threshold FAST with per-cell fallback and NMS -> [H, W] response
    map (0 = no corner), border-masked (`ORBextractor.cc:785-859`)."""
    h, w = img.shape
    s = fast_score(img)
    zero = torch.zeros_like(s)
    r_hi = torch.where(s > hi_threshold, s, zero)
    r_lo = torch.where(s > lo_threshold, s, zero)

    ph, pw = (-h) % cell, (-w) % cell
    rh = F.pad(r_hi, (0, pw, 0, ph))
    ncy, ncx = (h + ph) // cell, (w + pw) // cell
    has_hi = rh.reshape(ncy, cell, ncx, cell).amax(dim=(1, 3)) > 0.0
    use_lo = ~has_hi
    use_lo_full = use_lo.repeat_interleave(cell, 0).repeat_interleave(cell, 1)[:h, :w]
    resp = torch.where(use_lo_full, r_lo, r_hi)

    resp = nonmax_3x3(resp)
    ys = torch.arange(h, device=img.device)[:, None]
    xs = torch.arange(w, device=img.device)[None, :]
    in_border = (ys >= border) & (ys < h - border) & (xs >= border) & (xs < w - border)
    return torch.where(in_border, resp, torch.zeros_like(resp))
