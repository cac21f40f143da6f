"""Observation densification and duplicate merging (port of
orb_slam3_tpu/mapping/fuse.py).

The role of ORBmatcher::Fuse + LocalMapping::SearchInNeighbors
(`ORBmatcher.cc:1148`, `LocalMapping.cc:714-900`): project landmarks into a
keyframe and bind unambiguous matches to its unbound features, so that a
triangulated landmark gains observations beyond its two birth keyframes.
`merge_duplicates_at_keyframe` is the Replace path of the loop closer's
SearchAndFuse (`LoopClosing.cc:2115-2255`, `MapPoint::Replace`). Both
project through `matching.search_by_projection`, which runs kernel K1 on
CUDA tensors.
"""

from __future__ import annotations

import dataclasses

import torch

from ..atlas import ops as atlas_ops
from ..atlas.state import NO_LM, MapState
from ..frontend import camera as cam
from ..frontend import matching
from ..ops import lie
from ..ops.scatter import add_at, mark


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


def _predicted_octave(s: MapState, dist, n_levels: int):
    log_s = torch.log(torch.tensor(1.2, dtype=torch.float32, device=s.device))
    ratio = torch.clamp(s.lm_max_dist, min=1e-9) / torch.clamp(dist, min=1e-9)
    return torch.clamp(torch.ceil(torch.log(ratio) / log_s).to(torch.int32), 0, n_levels - 1)


def _project_into(kind: int, K, s: MapState, kf_row: int):
    """Each landmark's projection into keyframe kf_row, its distance to the
    camera centre and whether it lies in front inside its scale range."""
    R, t = s.kf_R[kf_row], s.kf_t[kf_row]
    Xc = lie.se3_apply(R, t, s.lm_pos)
    d_vec = s.lm_pos + (R.T @ t)[None, :]
    dist = torch.sqrt(torch.sum(d_vec * d_vec, dim=-1))
    ok = (Xc[:, 2] > 0) & (dist >= 0.8 * s.lm_min_dist) & (dist <= 1.3 * s.lm_max_dist)
    return cam.project(kind, K, Xc), dist, ok


def fuse_into_keyframe(kind: int, K, s: MapState, kf_row: int, scale_factors,
                       radius_px: float = 2.0, max_dist: int = 35, lm_mask=None) -> MapState:
    """Project the valid landmarks of the active map (restricted to
    `lm_mask` when given: the covisibility pool of SearchInNeighbors) that
    keyframe `kf_row` does not observe yet into it, and bind the matches
    (radius 2 px at the predicted octave, octave band -1..+1, Hamming
    distance <= max_dist, ratio 0.8) to its unbound features. Returns the
    new MapState."""
    L, F = s.lmax, s.fmax
    row_lm = s.kf_feat_lm[kf_row]

    lm_ok = s.lm_valid & (s.lm_map_id == s.active_map)
    if lm_mask is not None:
        lm_ok = lm_ok & lm_mask
    already = mark(L, torch.clamp(row_lm, 0, L - 1).long(), row_lm >= 0, s.device)
    uv, dist, in_range = _project_into(kind, K, s, kf_row)
    lm_ok = lm_ok & ~already & in_range
    feat_free = s.kf_feat_valid[kf_row] & (row_lm == NO_LM)
    idx, _, ok = matching.search_by_projection(
        uv, _predicted_octave(s, dist, scale_factors.shape[0]), s.lm_desc, lm_ok,
        s.kf_feat_xy[kf_row], s.kf_feat_octave[kf_row], s.kf_feat_desc[kf_row], feat_free,
        radius_px, scale_factors, max_dist=max_dist, ratio=0.8, level_lo=-1, level_hi=1,
    )
    feat_lm_new = invert_matches(idx, ok, F)
    bind = (feat_lm_new >= 0) & feat_free
    return atlas_ops.add_observations(
        s, kf_row, torch.arange(F, dtype=torch.int32, device=s.device), feat_lm_new, bind)


def merge_duplicates_at_keyframe(kind: int, K, s: MapState, kf_row: int, scale_factors,
                                 radius_px: float = 3.0, max_dist: int = 35):
    """Fuse duplicated landmarks through keyframe `kf_row` (SearchAndFuse's
    Replace path): every valid landmark of the active map is projected into
    the keyframe (K1: radius 3 px at the predicted octave, band -1..+1,
    Hamming distance <= max_dist, ratio 0.9) against its bound features;
    a match to a feature bound to another landmark makes the pair
    duplicates. The less-observed one (the projected landmark on a tie)
    loses: every `kf_feat_lm` pointer to it is redirected to the keeper,
    its visible / found counters move over, and it is invalidated.

    Where several pairs name one loser, the JAX package's scatter-set keeps
    the last write on the CPU, the pair of the highest projected row; here
    an amax of that row picks it, the same in any order. The replacement
    map is path-halved twice against merge chains. Returns (state, number
    of pairs), the count a 0-dim tensor (nothing is read to the host)."""
    L = s.lmax
    dev = s.device
    row_lm = s.kf_feat_lm[kf_row]
    uv, dist, in_range = _project_into(kind, K, s, kf_row)
    lm_ok = s.lm_valid & (s.lm_map_id == s.active_map) & in_range
    feat_bound = s.kf_feat_valid[kf_row] & (row_lm >= 0)
    idx, _, ok = matching.search_by_projection(
        uv, _predicted_octave(s, dist, scale_factors.shape[0]), s.lm_desc, lm_ok,
        s.kf_feat_xy[kf_row], s.kf_feat_octave[kf_row], s.kf_feat_desc[kf_row], feat_bound,
        radius_px, scale_factors, max_dist=max_dist, ratio=0.9, level_lo=-1, level_hi=1,
    )
    a = torch.arange(L, dtype=torch.int64, device=dev)
    hit = row_lm[idx.long()]
    b = torch.clamp(hit, 0, L - 1).long()
    pair_ok = ok & (hit >= 0) & (b != a) & s.lm_valid[b]

    # keeper = the more-observed landmark (MapPoint::Replace keeps nObs-max)
    bound = (s.kf_feat_lm >= 0) & s.kf_feat_valid & s.kf_valid[:, None]
    lm_flat = torch.clamp(s.kf_feat_lm, 0, L - 1).long().reshape(-1)
    n_obs = add_at(torch.zeros((L,), dtype=torch.int32, device=dev), lm_flat,
                   bound.reshape(-1).to(torch.int32), bound.reshape(-1))
    keep_a = n_obs[a] >= n_obs[b]
    winner = torch.where(keep_a, a, b)
    loser = torch.where(keep_a, b, a)

    # replace[loser] = winner of the highest pair row naming it
    entry = torch.full((L + 1,), -1, dtype=torch.int64, device=dev).scatter_reduce(
        0, torch.where(pair_ok, loser, L), torch.where(pair_ok, a, -1), "amax")[:L]
    replace = torch.where(entry >= 0, winner[torch.clamp(entry, min=0)], a)
    replace = replace[replace]
    replace = replace[replace]

    new_feat_lm = torch.where(s.kf_feat_lm >= 0,
                              replace[torch.clamp(s.kf_feat_lm, 0, L - 1).long()].to(torch.int32),
                              s.kf_feat_lm)
    died = replace != a
    zero = torch.zeros((L,), dtype=s.lm_visible.dtype, device=dev)
    add_vis = add_at(zero, replace, torch.where(died, s.lm_visible, 0), died)
    add_fnd = add_at(zero, replace, torch.where(died, s.lm_found, 0), died)
    return dataclasses.replace(
        s, kf_feat_lm=new_feat_lm, lm_valid=s.lm_valid & ~died,
        lm_visible=s.lm_visible + add_vis, lm_found=s.lm_found + add_fnd,
    ), torch.sum(pair_ok)
