"""Descriptor matching as dense masked ops (port of
orb_slam3_tpu/frontend/matching.py).

`ORBmatcher::SearchByProjection`: window and octave gates, Hamming
distances, per-row best match with the TH_HIGH gate and the best/second-best
ratio test. On CUDA tensors `search_by_projection` runs the hand-written
kernel K1 (match_kernel.py); on CPU tensors its plain version. The mono-init
search, brute-force matching with cross-check and the rotation histogram
are plain torch ops everywhere.
"""

from __future__ import annotations

import math

import torch

from . import match_kernel

TH_LOW = 50
TH_HIGH = 100
HISTO_BINS = 30
BIG = match_kernel.BIG


def hamming_matrix(da, db):
    """[N, 32] uint8 x [M, 32] uint8 -> [N, M] int32 Hamming distances
    (XOR, then a per-byte SWAR popcount; exact)."""
    return popcount_bytes(da[:, None, :] ^ db[None, :, :])


def popcount_bytes(x):
    """Set bits of a uint8 tensor summed over its last dimension, int32."""
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


def mutual_filter(idx_ab, ok_ab, idx_ba):
    """Keep only the matches whose reverse best match points back."""
    back = idx_ba[idx_ab]
    return ok_ab & (back == torch.arange(idx_ab.shape[0], device=idx_ab.device))


def top_k_stable(x, k: int):
    """(values, indices) of the k largest entries of a 1-D tensor, ties to
    the lower index first, as `lax.top_k` gives them (torch.topk promises
    no order on ties)."""
    idx = torch.argsort(-x, stable=True)[:k]
    return x[idx], idx


def rotation_consistency(angles_a, angles_b, idx, ok, keep_bins: int = 3):
    """30-bin rotation histogram filter (ComputeThreeMaxima,
    `ORBmatcher.cc:2044-2076`): keep the matches whose angle difference
    falls in the `keep_bins` most populated bins; bins 2-3 count only when
    above 0.1x the first."""
    rot = (angles_a - angles_b[idx]) * (180.0 / math.pi)
    rot = torch.where(rot < 0, rot + 360.0, rot)
    bins = torch.clamp((rot / (360.0 / HISTO_BINS)).to(torch.int32), 0, HISTO_BINS - 1).long()
    hist = torch.zeros(HISTO_BINS, dtype=torch.int32, device=ok.device)
    hist = hist.index_add(0, bins, ok.to(torch.int32))
    top_vals, top_idx = top_k_stable(hist, keep_bins)
    keep = top_vals.to(torch.float32) > 0.1 * top_vals[0].to(torch.float32)
    keep[0] = True
    allowed = torch.zeros(HISTO_BINS, dtype=torch.bool, device=ok.device)
    allowed[top_idx] = keep
    return ok & allowed[bins]


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


def search_for_initialization(xy0, desc0, valid0, xy1, desc1, valid1,
                              window=100.0, ratio=0.9, max_dist=TH_LOW):
    """Mono-init wide-window matching with a mutual cross-check
    (SearchForInitialization, `ORBmatcher.cc:648-763`).
    Returns (idx [N0] int64, ok [N0])."""
    m = window_mask(xy0, xy1, window, valid0, valid1)
    dist = hamming_matrix(desc0, desc1)
    idx01, _, ok01 = masked_best_match(dist, m, max_dist=max_dist, ratio=ratio)
    idx10, _, _ = masked_best_match(dist.T, m.T, max_dist=max_dist)
    return idx01, mutual_filter(idx01, ok01, idx10)


def search_by_brute_force(desc_a, valid_a, desc_b, valid_b,
                          ratio=0.75, max_dist=TH_LOW):
    """Unconstrained descriptor matching with ratio test and cross-check
    (the role the BoW-node-gated SearchByBoW plays for keyframe pairs).
    Returns (idx [Na] int64, dist [Na], ok [Na])."""
    m = valid_a[:, None] & valid_b[None, :]
    dist = hamming_matrix(desc_a, desc_b)
    idx_ab, d_ab, ok_ab = masked_best_match(dist, m, max_dist=max_dist, ratio=ratio)
    idx_ba, _, _ = masked_best_match(dist.T, m.T, max_dist=max_dist)
    return idx_ab, d_ab, mutual_filter(idx_ab, ok_ab, idx_ba)
