"""Atlas mutations: keyframe / landmark insertion, culling and the map
lifecycle (port of orb_slam3_tpu/atlas/ops.py).

Functional forms of `Atlas::AddKeyFrame/AddMapPoint`,
`KeyFrame::AddMapPoint`, `MapPoint::AddObservation`,
`Map::ApplyScaledRotation` (`Map.cc:252`) and `Tracking::CreateMapInAtlas`
(`Tracking.cc:2662`): each op returns a new MapState and never writes into
its input. Rows are allocated by the n_kf / n_lm bump counters. Writes that
JAX drops (`mode="drop"`) go through `ops.scatter.put_drop`.
"""

from __future__ import annotations

import dataclasses

import torch

from ..ops.scatter import add_at, put_drop
from . import state as state_mod
from .state import NO_LM, MapState


def _set_row(t, k, value):
    out = t.clone()
    out[k] = value
    return out


def _pad(a, n: int, fill):
    """Pad the leading dimension of `a` to n rows with `fill`."""
    if a.shape[0] == n:
        return a
    tail = torch.full((n - a.shape[0],) + tuple(a.shape[1:]), fill, dtype=a.dtype,
                      device=a.device)
    return torch.cat([a, tail])


def add_keyframe(s: MapState, R, t, timestamp,
                 feat_xy, feat_octave, feat_angle, feat_desc, feat_valid,
                 feat_lm=None, feat_ur=None, feat_depth=None,
                 vel=None, bg=None, ba=None, parent=None, prev=None):
    """Append one keyframe at row n_kf. Returns (state, kf_row 0-dim)."""
    k = s.n_kf.long()
    F = s.fmax
    if feat_xy.shape[0] > F:
        raise ValueError(f"{feat_xy.shape[0]} features do not fit fmax={F}")
    dev = s.device
    upd = dict(
        kf_R=_set_row(s.kf_R, k, R),
        kf_t=_set_row(s.kf_t, k, t),
        kf_timestamp=_set_row(s.kf_timestamp, k, float(timestamp)),
        kf_map_id=_set_row(s.kf_map_id, k, s.active_map),
        kf_valid=_set_row(s.kf_valid, k, True),
        kf_feat_xy=_set_row(s.kf_feat_xy, k, _pad(feat_xy, F, 0)),
        kf_feat_octave=_set_row(s.kf_feat_octave, k, _pad(feat_octave, F, 0)),
        kf_feat_angle=_set_row(s.kf_feat_angle, k, _pad(feat_angle, F, 0)),
        kf_feat_desc=_set_row(s.kf_feat_desc, k, _pad(feat_desc, F, 0)),
        kf_feat_valid=_set_row(s.kf_feat_valid, k, _pad(feat_valid, F, False)),
        kf_feat_lm=_set_row(
            s.kf_feat_lm, k,
            _pad(feat_lm, F, NO_LM) if feat_lm is not None
            else torch.full((F,), NO_LM, dtype=torch.int32, device=dev)),
        n_kf=s.n_kf + 1,
    )
    if feat_ur is not None:
        upd["kf_feat_ur"] = _set_row(s.kf_feat_ur, k, _pad(feat_ur, F, -1.0))
    if feat_depth is not None:
        upd["kf_feat_depth"] = _set_row(s.kf_feat_depth, k, _pad(feat_depth, F, 0))
    for name, v in (("kf_vel", vel), ("kf_bg", bg), ("kf_ba", ba),
                    ("kf_parent", parent), ("kf_prev", prev)):
        if v is not None:
            upd[name] = _set_row(getattr(s, name), k, v)
    return dataclasses.replace(s, **upd), s.n_kf


def add_landmarks(s: MapState, pos, desc, first_kf, new_valid, kf_rows, feat_idx):
    """Allocate up to M new landmarks and bind them to the (kf_rows,
    feat_idx) observations; pos [M,3], desc [M,32], new_valid [M].
    Landmarks past the arena's end are refused (NO_LM, nothing written):
    refused entries go to the out-of-range row L / feature F and are dropped,
    so they never clobber a row allocated in the same call.
    Returns (state, lm_rows [M] int32)."""
    L, F = s.lmax, s.fmax
    offs = torch.cumsum(new_valid.to(torch.int32), 0) - 1
    rows = s.n_lm + offs
    fits = new_valid & (rows < L)
    rows = torch.clamp(rows, 0, L - 1)
    safe = torch.where(fits, rows, L).long()
    feat = torch.where(fits, feat_idx, F).long()
    n_new = new_valid.to(torch.int32).sum()
    s2 = dataclasses.replace(
        s,
        lm_pos=put_drop(s.lm_pos, safe, pos),
        lm_desc=put_drop(s.lm_desc, safe, desc),
        lm_valid=put_drop(s.lm_valid, safe, True),
        lm_map_id=put_drop(s.lm_map_id, safe, s.active_map),
        lm_first_kf=put_drop(s.lm_first_kf, safe, first_kf.to(torch.int32)),
        # fresh rows may be reused after compaction: clear the stats
        lm_visible=put_drop(s.lm_visible, safe, 0),
        lm_found=put_drop(s.lm_found, safe, 0),
        kf_feat_lm=put_drop(s.kf_feat_lm, (kf_rows.long(), feat), rows.to(torch.int32),
                            dim=1),
        n_lm=torch.clamp(s.n_lm + n_new, max=L).to(torch.int32),
    )
    return s2, torch.where(fits, rows, NO_LM).to(torch.int32)


def add_observations(s: MapState, kf_row, feat_idx, lm_rows, ok) -> MapState:
    """Bind existing landmarks to features of one keyframe
    (MapPoint::AddObservation). Only the `ok` entries write: `feat_idx` may
    repeat a feature among entries that are not ok (a best match without
    the cross-check), and a write-back of the old value there would race
    the ok binding of the same feature. The JAX package writes those
    entries back (`atlas/ops.py:133-135`), so a later duplicate undoes the
    binding on the CPU and either may win on an accelerator."""
    F = s.fmax
    k = torch.as_tensor(kf_row, device=s.device).long().expand(feat_idx.shape)
    f = torch.where(ok, feat_idx.long(), F)
    return dataclasses.replace(
        s, kf_feat_lm=put_drop(s.kf_feat_lm, (k, f), lm_rows.to(torch.int32), dim=1))


def invalidate_landmarks(s: MapState, lm_rows, kill) -> MapState:
    """SetBadFlag: clear validity and detach every observation
    (MapPoint::SetBadFlag, `MapPoint.cc:215-246`)."""
    L = s.lmax
    bad = put_drop(torch.zeros((L,), dtype=torch.bool, device=s.device),
                   torch.where(kill, lm_rows, L).long(), True)
    detach = bad[torch.clamp(s.kf_feat_lm, 0, L - 1).long()] & (s.kf_feat_lm >= 0)
    return dataclasses.replace(
        s, lm_valid=torch.where(bad, False, s.lm_valid),
        kf_feat_lm=torch.where(detach, NO_LM, s.kf_feat_lm),
    )


def replace_landmark(s: MapState, old_rows, new_rows, do) -> MapState:
    """MapPoint::Replace (`MapPoint.cc:248-290`): repoint the observations of
    old -> new, invalidate old and merge its found/visible counters."""
    L = s.lmax
    dev = s.device
    old_d = torch.where(do, old_rows, L).long()
    new_d = torch.where(do, new_rows, L).long()
    mapping = put_drop(torch.arange(L, dtype=torch.int32, device=dev), old_d,
                       torch.where(do, new_rows, 0).to(torch.int32))
    lm = s.kf_feat_lm
    remapped = torch.where(lm >= 0, mapping[torch.clamp(lm, 0, L - 1).long()], lm)
    old_c = torch.clamp(old_rows, 0, L - 1).long()
    zeros = torch.zeros((L + 1,), dtype=torch.int32, device=dev)
    add_vis = add_at(zeros, new_d, s.lm_visible[old_c])[:L]
    add_fnd = add_at(zeros, new_d, s.lm_found[old_c])[:L]
    return dataclasses.replace(
        s, kf_feat_lm=remapped, lm_valid=put_drop(s.lm_valid, old_d, False),
        lm_visible=s.lm_visible + add_vis, lm_found=s.lm_found + add_fnd,
    )


def apply_scaled_rotation(s: MapState, Ryw, scale, map_id) -> MapState:
    """Gauge transform of one map (Map::ApplyScaledRotation, `Map.cc:252-310`)
    with world transform X' = scale * Ryw X: R_cw' = R_cw Ryw^T,
    t_cw' = scale * t_cw, X' = scale Ryw X, v' = scale Ryw v. Culled
    keyframe rows are transformed too (trajectory records compose against
    them); the scale-invariance distances scale with the gauge."""
    kf_in = s.kf_map_id == map_id
    lm_in = s.lm_valid & (s.lm_map_id == map_id)
    return dataclasses.replace(
        s,
        kf_R=torch.where(kf_in[:, None, None], s.kf_R @ Ryw.T[None], s.kf_R),
        kf_t=torch.where(kf_in[:, None], scale * s.kf_t, s.kf_t),
        kf_vel=torch.where(kf_in[:, None], scale * (s.kf_vel @ Ryw.T), s.kf_vel),
        lm_pos=torch.where(lm_in[:, None], scale * (s.lm_pos @ Ryw.T), s.lm_pos),
        lm_min_dist=torch.where(lm_in, scale * s.lm_min_dist, s.lm_min_dist),
        lm_max_dist=torch.where(lm_in, scale * s.lm_max_dist, s.lm_max_dist),
    )


def create_map(s: MapState) -> MapState:
    """Tracking::CreateMapInAtlas (`Tracking.cc:2662`): stored maps keep
    their rows; new insertions carry the fresh map id."""
    return dataclasses.replace(s, active_map=s.n_maps.clone(), n_maps=s.n_maps + 1)


def compact(s: MapState):
    """Move every valid keyframe / landmark row to a dense prefix (stable, so
    temporal order stays) and rewrite the cross-row references (parent,
    prev, feature bindings, first keyframe). Invalid rows keep their stale
    data at their new place. Returns (state, kf_new_of_old [K], lm_new_of_old
    [L])."""
    K, L = s.kmax, s.lmax
    dev = s.device
    kf_order = torch.argsort((~s.kf_valid).to(torch.int32), stable=True)
    lm_order = torch.argsort((~s.lm_valid).to(torch.int32), stable=True)
    kf_new = torch.empty(K, dtype=torch.int32, device=dev)
    kf_new[kf_order] = torch.arange(K, dtype=torch.int32, device=dev)
    lm_new = torch.empty(L, dtype=torch.int32, device=dev)
    lm_new[lm_order] = torch.arange(L, dtype=torch.int32, device=dev)

    def remap(r, new, n):
        return torch.where(r >= 0, new[torch.clamp(r, 0, n - 1).long()], r)

    upd = {}
    for f in dataclasses.fields(s):
        v = getattr(s, f.name)
        if f.name.startswith("kf_"):
            v = v[kf_order]
        elif f.name.startswith("lm_"):
            v = v[lm_order]
        upd[f.name] = v
    upd["kf_parent"] = remap(upd["kf_parent"], kf_new, K)
    upd["kf_prev"] = remap(upd["kf_prev"], kf_new, K)
    upd["kf_feat_lm"] = remap(upd["kf_feat_lm"], lm_new, L)
    upd["lm_first_kf"] = remap(upd["lm_first_kf"], kf_new, K)
    upd["n_kf"] = s.kf_valid.sum().to(torch.int32)
    upd["n_lm"] = s.lm_valid.sum().to(torch.int32)
    return dataclasses.replace(s, **upd), kf_new, lm_new


def grow(s: MapState, kmax: int | None = None, lmax: int | None = None) -> MapState:
    """Enlarge the arena: every row array padded to the new capacity."""
    new_k = int(kmax) if kmax is not None else s.kmax
    new_l = int(lmax) if lmax is not None else s.lmax
    if new_k < s.kmax or new_l < s.lmax:
        raise ValueError("grow cannot shrink the arena")
    fresh = state_mod.empty(kmax=new_k, fmax=s.fmax, lmax=new_l, device=s.device)
    upd = {}
    for f in dataclasses.fields(s):
        old = getattr(s, f.name)
        if f.name.startswith(("kf_", "lm_")):
            tgt = getattr(fresh, f.name).clone()
            tgt[: old.shape[0]] = old
            upd[f.name] = tgt
        else:
            upd[f.name] = old
    return dataclasses.replace(fresh, **upd)


def reset_active_map(s: MapState) -> MapState:
    """Tracking::ResetActiveMap (`Tracking.cc:3840`): drop every row of the
    active map (they stay as holes until `compact`) and start a fresh map
    id, leaving stored maps untouched."""
    kf_in = s.kf_valid & (s.kf_map_id == s.active_map)
    lm_in = s.lm_valid & (s.lm_map_id == s.active_map)
    return dataclasses.replace(
        s, kf_valid=s.kf_valid & ~kf_in, lm_valid=s.lm_valid & ~lm_in,
        active_map=s.n_maps.clone(), n_maps=s.n_maps + 1,
    )


def change_map_id(s: MapState, from_id, to_id) -> MapState:
    """Relabel a whole map (KeyFrame::UpdateMap / merge bookkeeping)."""
    return dataclasses.replace(
        s,
        kf_map_id=torch.where(s.kf_map_id == from_id, to_id, s.kf_map_id).to(torch.int32),
        lm_map_id=torch.where(s.lm_map_id == from_id, to_id, s.lm_map_id).to(torch.int32),
    )
