"""Projection-windowed descriptor matching (port of the tracking subset of
orb_slam3_tpu/frontend/matching.py).

`ORBmatcher::SearchByProjection` as dense masked ops: window and octave
gates, Hamming distances, per-row best match with the TH_HIGH gate and the
best/second-best ratio test. On CUDA tensors `search_by_projection` runs the
hand-written kernel K1 (match_kernel.py); on CPU tensors its plain version.
"""

from __future__ import annotations

import torch

from . import match_kernel

TH_LOW = 50
TH_HIGH = 100
HISTO_BINS = 30
BIG = match_kernel.BIG


def hamming_matrix(da, db):
    """[N, 32] uint8 x [M, 32] uint8 -> [N, M] int32 Hamming distances
    (XOR, then a per-byte SWAR popcount; exact)."""
    x = da[:, None, :] ^ db[None, :, :]
    x = x - ((x >> 1) & 0x55)
    x = (x & 0x33) + ((x >> 2) & 0x33)
    x = (x + (x >> 4)) & 0x0F
    return x.sum(dim=-1, dtype=torch.int32)


def masked_best_match(dist, mask, max_dist=TH_LOW, ratio=None):
    """Per-row best match under mask: (idx [N] int64, best [N] int32, ok [N]).
    Masked pairs count as BIG; ties go to the first index; the ratio test
    compares with the best of the row without its argmin column."""
    d = torch.where(mask, dist, torch.full_like(dist, BIG))
    idx = torch.argmin(d, dim=1)
    best = torch.gather(d, 1, idx[:, None])[:, 0]
    ok = best <= max_dist
    if ratio is not None:
        d2 = d.clone()
        d2[torch.arange(d.shape[0], device=d.device), idx] = BIG
        second = torch.amin(d2, dim=1)
        ok = ok & (best.to(torch.float32) < ratio * second.to(torch.float32))
    return idx, best, ok


def window_mask(uv_pred, kp_xy, radius, valid_pred=None, valid_kp=None):
    """[N, 2] predicted positions vs [M, 2] keypoints -> [N, M] bool
    (`Frame::GetFeaturesInArea` as a dense window test)."""
    d = (uv_pred[:, None, :] - kp_xy[None, :, :]).abs()
    if not torch.is_tensor(radius) or radius.ndim == 0:
        m = torch.all(d <= radius, dim=-1)
    else:
        m = torch.all(d <= radius[:, None, None], dim=-1)
    if valid_pred is not None:
        m = m & valid_pred[:, None]
    if valid_kp is not None:
        m = m & valid_kp[None, :]
    return m


def octave_mask(oct_pred, oct_kp, lo=0, hi=0):
    """Allow keypoint octave in [oct_pred + lo, oct_pred + hi] -> [N, M] bool."""
    o = oct_kp[None, :]
    p = oct_pred[:, None]
    return (o >= p + lo) & (o <= p + hi)


def search_by_projection(uv_pred, pred_octave, pred_desc, pred_valid,
                         kp_xy, kp_octave, kp_desc, kp_valid,
                         radius_px, scale_factors,
                         max_dist=TH_HIGH, ratio=0.9,
                         level_lo=-1, level_hi=1):
    """SearchByProjection family (`ORBmatcher.cc:43-222,1676-1887`):
    landmarks [N, ...] against frame keypoints [M, ...]. The window radius
    is radius_px times the predicted octave's scale factor. Returns
    (idx [N], dist [N], ok [N]) from kernel K1 (CUDA) or its plain version
    (CPU)."""
    n_levels = scale_factors.shape[0]
    radius = radius_px * scale_factors[torch.clamp(pred_octave, 0, n_levels - 1).long()]
    return match_kernel.search_by_projection_kernel(
        uv_pred, pred_octave, pred_desc, pred_valid,
        kp_xy, kp_octave, kp_desc, kp_valid, radius,
        max_dist=max_dist, ratio=ratio, level_lo=level_lo, level_hi=level_hi,
    )
