"""Observation densification (port of `fuse_into_keyframe` from
orb_slam3_tpu/mapping/fuse.py).

The role of ORBmatcher::Fuse + LocalMapping::SearchInNeighbors
(`ORBmatcher.cc:1148`, `LocalMapping.cc:714-900`): project landmarks into a
keyframe and bind unambiguous matches to its unbound features, so that a
triangulated landmark gains observations beyond its two birth keyframes.
The projection search is `matching.search_by_projection`, which runs
kernel K1 on CUDA tensors. `merge_duplicates_at_keyframe` comes with loop
closing.
"""

from __future__ import annotations

import torch

from ..atlas import ops as atlas_ops
from ..atlas.state import NO_LM, MapState
from ..frontend import camera as cam
from ..frontend import matching
from ..ops import lie
from ..ops.scatter import mark


def invert_matches(idx, ok, n_feat: int):
    """[n_feat] int32: the landmark row bound to each feature from the
    per-landmark matches (idx [L], ok [L]), NO_LM where none. Where several
    landmarks pick one feature the highest row wins: the JAX package's
    scatter-set lets the last write win on the CPU, and its landmark rows
    are ascending. A max is the same value in any order, so the result is
    the same on the card."""
    L = idx.shape[0]
    out = torch.full((n_feat + 1,), NO_LM, dtype=torch.int32, device=idx.device)
    rows = torch.arange(L, dtype=torch.int32, device=idx.device)
    return out.scatter_reduce(0, torch.where(ok, idx.long(), n_feat),
                              torch.where(ok, rows, NO_LM), "amax")[:n_feat]


def fuse_into_keyframe(kind: int, K, s: MapState, kf_row: int, scale_factors,
                       radius_px: float = 2.0, max_dist: int = 35, lm_mask=None) -> MapState:
    """Project the valid landmarks of the active map (restricted to
    `lm_mask` when given: the covisibility pool of SearchInNeighbors) that
    keyframe `kf_row` does not observe yet into it, and bind the matches
    (radius 2 px at the predicted octave, octave band -1..+1, Hamming
    distance <= max_dist, ratio 0.8) to its unbound features. Returns the
    new MapState."""
    L, F = s.lmax, s.fmax
    R, t = s.kf_R[kf_row], s.kf_t[kf_row]
    row_lm = s.kf_feat_lm[kf_row]

    lm_ok = s.lm_valid & (s.lm_map_id == s.active_map)
    if lm_mask is not None:
        lm_ok = lm_ok & lm_mask
    already = mark(L, torch.clamp(row_lm, 0, L - 1).long(), row_lm >= 0, s.device)
    lm_ok = lm_ok & ~already

    Xc = lie.se3_apply(R, t, s.lm_pos)
    uv = cam.project(kind, K, Xc)
    d_vec = s.lm_pos + (R.T @ t)[None, :]
    dist = torch.sqrt(torch.sum(d_vec * d_vec, dim=-1))
    lm_ok = (lm_ok & (Xc[:, 2] > 0) & (dist >= 0.8 * s.lm_min_dist)
             & (dist <= 1.3 * s.lm_max_dist))
    feat_free = s.kf_feat_valid[kf_row] & (row_lm == NO_LM)

    log_s = torch.log(torch.tensor(1.2, dtype=torch.float32, device=s.device))
    ratio = torch.clamp(s.lm_max_dist, min=1e-9) / torch.clamp(dist, min=1e-9)
    pred_oct = torch.clamp(torch.ceil(torch.log(ratio) / log_s).to(torch.int32),
                           0, scale_factors.shape[0] - 1)
    idx, _, ok = matching.search_by_projection(
        uv, pred_oct, s.lm_desc, lm_ok,
        s.kf_feat_xy[kf_row], s.kf_feat_octave[kf_row], s.kf_feat_desc[kf_row], feat_free,
        radius_px, scale_factors, max_dist=max_dist, ratio=0.8, level_lo=-1, level_hi=1,
    )
    feat_lm_new = invert_matches(idx, ok, F)
    bind = (feat_lm_new >= 0) & feat_free
    return atlas_ops.add_observations(
        s, kf_row, torch.arange(F, dtype=torch.int32, device=s.device), feat_lm_new, bind)
