"""The per-keyframe mapping pipeline, visual path (port of the fused stages
of orb_slam3_tpu/mapping/pipeline.py).

The LocalMapping work unit (`LocalMapping.cc:64-282`) in three stages over
MapState, as the tracker runs it synchronously for a visual sensor and
the background mapper (`runtime/mapper.py`) runs it for every sensor:

    map_stage_pre  : frame statistics, keyframe insertion, triangulation
                     against the best covisible neighbours, the
                     SearchInNeighbors fuse, BA-window selection
    run_visual_ba  : windowed local BA
    map_stage_post : landmark and keyframe culling, landmark statistics

A `KFPackage` carries one keyframe's tracking output into them (the role
of `LocalMapping::InsertKeyFrame`'s queue entry, `LocalMapping.cc:284`).
Where the JAX program selects on device values (`jax.lax.top_k`, `where`
on a cull flag), the port reads the few scalars it branches on to the host
once: the keyframe row, the two top-k lists and the cull flag. A depth
sensor's keyframe also makes landmarks from its measured depths, and its
local BA runs stereo edges.

On the synchronous path the inertial sensors run the JAX package's
per-stage helpers instead (`insert_keyframe_pkg`, `triangulate_mono`,
`fuse_recent` with K1 over the last 4 keyframes, `ba_window`, `cull`; JAX
`pipeline.py:81-237`), between which the tracker places the IMU's interval
commit, the visual-inertial BA and the inertial culling and
initialization; the mapper runs the fused `map_stage_pre` for them too, as
the JAX mapper does.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

import numpy as np

from ..atlas import ops as atlas_ops
from ..atlas import state as atlas_state
from ..frontend import camera as cam
from ..frontend import matching
from ..ops import lie
from ..ops.scatter import mark
from . import fuse, local_mapper


@dataclasses.dataclass
class KFPackage:
    """One keyframe's worth of tracking output: the entry of the mapper's
    queue (`runtime/mapper.py`), or the synchronous path's argument."""

    R: torch.Tensor              # [3,3] Tcw at creation
    t: torch.Tensor              # [3]
    timestamp: float
    feat_xy: torch.Tensor        # [F,2]
    feat_octave: torch.Tensor    # [F]
    feat_angle: torch.Tensor     # [F]
    feat_desc: torch.Tensor      # [F,32]
    feat_valid: torch.Tensor     # [F]
    feat_lm: Optional[torch.Tensor]  # [F] landmark rows bound by tracking
    feat_ur: Optional[torch.Tensor]
    feat_depth: Optional[torch.Tensor]
    n_inliers: int
    # per-landmark tracking statistics since the last package
    # (mnVisible / mnFound, Tracking::SearchLocalPoints bookkeeping)
    stat_vis: Optional[torch.Tensor] = None    # [L] int32
    stat_found: Optional[torch.Tensor] = None  # [L] int32
    # inertial sensors: the raw IMU interval (acc, gyro, dts, ts) from the
    # previous keyframe to this one, cut by the tracker at request time
    # (ImuState.cut_interval) and owned by the mapper's ImuState after
    # delivery (the mlQueueImuData -> preintegration hand-off)
    imu_interval: Optional[tuple] = None
    # the mapper commit version whose gauge the pose is expressed in (the
    # tracker's last adopted commit): an inertial gauge event or a loop /
    # merge / GBA correction committed between enqueue and processing
    # re-expresses the pose on arrival (AsyncMapper._regauge_pkg)
    gauge_version: int = 0


def apply_frame_stats(s: atlas_state.MapState, pkg: KFPackage):
    if pkg.stat_vis is None:
        return s
    return dataclasses.replace(s, lm_visible=s.lm_visible + pkg.stat_vis,
                               lm_found=s.lm_found + pkg.stat_found)


def _covis_row(W, kf: int, kf_valid):
    """Keyframe kf's covisibility row without itself and invalid rows."""
    K = W.shape[0]
    row = torch.where(torch.arange(K, device=W.device) == kf, 0, W[kf])
    return torch.where(kf_valid, row, 0)


def map_stage_pre(kind: int, K8, s: atlas_state.MapState, R, t, timestamp,
                  feat_xy, feat_octave, feat_angle, feat_desc, feat_valid,
                  feat_lm, feat_ur, feat_depth, stat_vis, stat_found,
                  parent_row: int, scale_factors, bf, th_depth, min_depth,
                  with_depth: bool, n_tri: int = 3, n_fuse: int = 4,
                  wnd: int = 10, local_window: int = 6, kf_row_host=None):
    """Insert one keyframe package and run the pre-BA mapping stages.
    Returns (state, kf_row int, ba_rows [wnd] int32, n_fixed 0-dim).

    Triangulation runs against the n_tri best covisible neighbours with a
    weight of at least 15 (the parent when none reaches it; ties go to the
    lower row, as `lax.top_k` gives them); the fuse runs into the keyframe
    and its n_fuse - 1 best covisible neighbours (the keyframe again where
    a neighbour is missing), over the landmarks bound in its covisibility
    neighbourhood.

    with_depth (a depth sensor's keyframe): every unbound feature with a
    depth above min_depth that is closer than bf * th_depth / fx, or among
    the 100 nearest, becomes a landmark at its measured depth
    (`Tracking.cc:3247-3331`; ties in depth go to the lower feature, as the
    JAX program's stable argsort gives them), and triangulation prefers the
    measured depth (`local_mapper.triangulate_pair`).

    kf_row_host: the caller's host mirror of the append position (n_kf
    before the insert: the arena is a bump allocator); given, the keyframe
    row is not read back from the device."""
    Kc, L = s.kmax, s.lmax
    dev = s.device

    # frame statistics buffered by the tracker (mnVisible / mnFound)
    s = dataclasses.replace(s, lm_visible=s.lm_visible + stat_vis,
                            lm_found=s.lm_found + stat_found)
    # bindings re-validated against the current landmark validity
    alive = s.lm_valid[torch.clamp(feat_lm, 0, L - 1).long()] & (feat_lm >= 0)
    feat_lm = torch.where(alive, feat_lm, atlas_state.NO_LM)
    parent = torch.tensor(int(parent_row), dtype=torch.int32, device=dev)
    s, kf = atlas_ops.add_keyframe(
        s, R, t, timestamp, feat_xy, feat_octave, feat_angle, feat_desc, feat_valid,
        feat_lm=feat_lm, feat_ur=feat_ur, feat_depth=feat_depth, parent=parent, prev=parent)

    kf = int(kf) if kf_row_host is None else int(kf_row_host)
    if with_depth:
        F = feat_xy.shape[0]
        has_depth = (feat_depth > min_depth) & feat_valid & (s.kf_feat_lm[kf] < 0)
        th_depth_m = torch.full((), float(bf), dtype=torch.float32, device=dev) * th_depth / K8[0]
        # rank of each feature in depth order: the inverse of a stable sort
        order = torch.argsort(torch.where(has_depth, feat_depth, torch.inf), stable=True)
        rank = torch.empty_like(order)
        rank[order] = torch.arange(F, device=dev)
        close = has_depth & ((feat_depth < th_depth_m) | (rank < 100))
        Rw, tw = lie.se3_inv(R, t)
        Xw = lie.se3_apply(Rw, tw, cam.unproject(kind, K8, feat_xy) * feat_depth[:, None])
        col = torch.full((F,), kf, dtype=torch.int32, device=dev)
        s, _ = atlas_ops.add_landmarks(s, Xw, feat_desc, col, close, col,
                                       torch.arange(F, dtype=torch.int32, device=dev))

    # covisibility of the fresh keyframe and its best neighbours: one host
    # read of the keyframe row and both top-k lists
    W_row = _covis_row(atlas_state.covisibility_weights(s), kf, s.kf_valid)
    n_nb = max(n_fuse - 1, 1)
    k = max(n_tri, n_nb)
    top_w, top_rows = matching.top_k_stable(W_row, k)
    picked = torch.cat([top_w, top_rows]).tolist()
    top_w, top_rows = picked[:k], picked[k:]

    # CreateNewMapPoints against the best covisible neighbours
    # (LocalMapping.cc:391-408); the parent when none reaches the threshold
    for i in range(n_tri):
        nbr = top_rows[i] if top_w[i] >= 15 else (int(parent_row) if i == 0 else kf)
        if nbr < 0 or nbr == kf:
            continue  # the JAX stage masks this pair's accept to nothing
        Xw, f1, f2, accept = local_mapper.triangulate_pair(
            kind, K8, s, kf, nbr, scale_factors, use_depth=with_depth, min_depth=min_depth)
        s = local_mapper.insert_triangulated(s, kf, nbr, Xw, f1, f2, accept)

    # SearchInNeighbors (LocalMapping.cc:714-900): the keyframe and its best
    # covisible neighbours, candidate landmarks from the neighbourhood's
    # bindings; the weights are the pre-triangulation ones, as in the JAX
    # stage (a stable top-k of fewer entries is a prefix of this one)
    fuse_rows = [kf] + [r if w >= 15 else kf for w, r in zip(top_w[:n_nb], top_rows[:n_nb])]
    nbr_kfs = W_row > 0
    nbr_kfs[kf] = True
    bound_nb = (s.kf_feat_lm >= 0) & s.kf_feat_valid & nbr_kfs[:, None]
    lm_pool = mark(L, torch.clamp(s.kf_feat_lm, 0, L - 1).long().reshape(-1),
                   bound_nb.reshape(-1), dev)
    for row in fuse_rows:
        s = fuse.fuse_into_keyframe(kind, K8, s, row, scale_factors, lm_mask=lm_pool)

    # BA window: the last `wnd` valid keyframes of the active map, ascending,
    # padded by repeating the newest (duplicates are frozen in local_ba)
    mask = s.kf_valid & (s.kf_map_id == s.active_map)
    idx = torch.sort(torch.where(mask, torch.arange(Kc, device=dev), Kc)).values
    n_valid = mask.sum()
    start = torch.clamp(n_valid - wnd, 0, max(Kc - wnd, 0))
    ba_rows = idx[start + torch.arange(wnd, device=dev)]
    newest = idx[torch.clamp(n_valid - 1, min=0)]
    ba_rows = torch.where(ba_rows >= Kc, newest, ba_rows).to(torch.int32)
    n_rows = torch.clamp(n_valid, max=wnd)
    n_fixed = torch.where(n_rows > 2, torch.clamp(n_rows - local_window, min=2), 1)
    return s, kf, ba_rows, n_fixed


def run_pre_stage(s, pkg: KFPackage, cfg, base_sensor: str, parent_row: int,
                  scale_factors, kf_row_host=None):
    """map_stage_pre on a package, with its optional fields made concrete.
    Returns (state, kf_row int, ba_rows, n_fixed). `kf_row_host` is the
    caller's host mirror of the append position (the background mapper
    keeps one), as the JAX stage takes it (`runtime/mapper.py:404-407`)."""
    L, F = s.lmax, s.fmax
    dev = s.device
    z_i32 = torch.zeros((L,), dtype=torch.int32, device=dev)
    return map_stage_pre(
        cfg.kind, cfg.K, s, pkg.R, pkg.t, float(pkg.timestamp),
        pkg.feat_xy, pkg.feat_octave, pkg.feat_angle, pkg.feat_desc, pkg.feat_valid,
        pkg.feat_lm if pkg.feat_lm is not None
        else torch.full((F,), atlas_state.NO_LM, dtype=torch.int32, device=dev),
        pkg.feat_ur if pkg.feat_ur is not None
        else -torch.ones((F,), dtype=torch.float32, device=dev),
        pkg.feat_depth if pkg.feat_depth is not None
        else torch.zeros((F,), dtype=torch.float32, device=dev),
        pkg.stat_vis if pkg.stat_vis is not None else z_i32,
        pkg.stat_found if pkg.stat_found is not None else z_i32,
        parent_row, scale_factors, cfg.bf, cfg.th_depth, cfg.min_depth,
        with_depth=base_sensor != "mono" and pkg.feat_depth is not None,
        wnd=cfg.local_window + 4, local_window=cfg.local_window, kf_row_host=kf_row_host,
    )


def run_visual_ba(s: atlas_state.MapState, cfg, scale_factors, rows, n_fixed,
                  base_sensor: str, iters: int = 8):
    """Windowed local BA (`Optimizer::LocalBundleAdjustment`) over the
    window rows, with stereo edges for a depth sensor, run to its end in one
    call, as the JAX mapper dispatches it (`runtime/mapper.py:420-426`): the
    mapper's preemption is skipping the BA while packages wait
    (`AsyncMapper.max_ba_skips`), not an abort between iterations."""
    s, _ = local_mapper.local_ba(
        cfg.kind, cfg.K, s, rows, n_fixed=n_fixed, window=cfg.local_window + 4,
        iters=iters, scale_factors=scale_factors, stereo=base_sensor != "mono", bf=cfg.bf)
    return s


def map_stage_post(s: atlas_state.MapState, ba_rows, min_kf_for_cull: int):
    """Post-BA: landmark culling, keyframe culling over the BA window once
    the map holds more than `min_kf_for_cull` valid keyframes, landmark
    statistics refresh. The JAX stage computes the culled state and selects
    it on device; the port branches on one host read of the flag."""
    s = local_mapper.cull_landmarks(s)
    if int(s.kf_valid.sum()) > int(min_kf_for_cull):
        s = local_mapper.cull_keyframes(s, ba_rows)
    return atlas_state.update_landmark_stats(s)


# ---------------------------------------------------------------------------
# Per-stage helpers of the inertial path (JAX pipeline.py:81-237)
# ---------------------------------------------------------------------------

def insert_keyframe_pkg(s: atlas_state.MapState, pkg: KFPackage, cfg, base_sensor: str,
                        parent_row: int):
    """Add the keyframe row and, for a depth sensor, landmarks at the
    measured depths of its unbound close features (those nearer than bf *
    th_depth / fx, or among the 100 nearest; Tracking::CreateNewKeyFrame,
    `Tracking.cc:3216-3331`). The tracked bindings are re-validated against
    the current landmark validity. Returns (state, kf_row int)."""
    L = s.lmax
    dev = s.device
    feat_lm = pkg.feat_lm
    if feat_lm is not None:
        alive = s.lm_valid[torch.clamp(feat_lm, 0, L - 1).long()] & (feat_lm >= 0)
        feat_lm = torch.where(alive, feat_lm, atlas_state.NO_LM)
    parent = torch.tensor(int(parent_row), dtype=torch.int32, device=dev)
    s, kf = atlas_ops.add_keyframe(
        s, pkg.R, pkg.t, pkg.timestamp, pkg.feat_xy, pkg.feat_octave, pkg.feat_angle,
        pkg.feat_desc, pkg.feat_valid, feat_lm=feat_lm, feat_ur=pkg.feat_ur,
        feat_depth=pkg.feat_depth, parent=parent, prev=parent)
    kf = int(kf)
    if base_sensor != "mono" and pkg.feat_depth is not None:
        depth = pkg.feat_depth
        F = depth.shape[0]
        has_depth = (depth > cfg.min_depth) & pkg.feat_valid & (s.kf_feat_lm[kf] < 0)
        th_depth_m = cfg.bf * cfg.th_depth / float(cfg.K[0])
        # rank in depth order, ties to the lower feature (a stable sort)
        order = torch.argsort(torch.where(has_depth, depth, torch.inf), stable=True)
        rank = torch.empty_like(order)
        rank[order] = torch.arange(F, device=dev)
        close = has_depth & ((depth < th_depth_m) | (rank < 100))
        Rw, tw = lie.se3_inv(pkg.R, pkg.t)
        Xw = lie.se3_apply(Rw, tw, cam.unproject(cfg.kind, cfg.K, pkg.feat_xy) * depth[:, None])
        col = torch.full((F,), kf, dtype=torch.int32, device=dev)
        s, _ = atlas_ops.add_landmarks(s, Xw, pkg.feat_desc, col, close, col,
                                       torch.arange(F, dtype=torch.int32, device=dev))
    return s, kf


def triangulate_mono(s: atlas_state.MapState, kf: int, cfg, scale_factors, fallback_row: int,
                     n_neighbors: int = 3):
    """CreateNewMapPoints against the best covisible neighbours with a
    weight of at least 15 (LocalMapping.cc:391-408), or the parent when
    there is none; the neighbours in numpy's argsort order of the weights,
    as the JAX helper takes them; measured depths first for a depth
    sensor."""
    W = atlas_state.covisibility_weights(s)[kf].cpu().numpy().copy()
    W[kf] = 0
    order = np.argsort(-W)
    prev_rows = [int(r) for r in order[:n_neighbors] if W[r] >= 15]
    if not prev_rows and fallback_row >= 0:
        prev_rows = [fallback_row]
    use_depth = cfg.sensor.split("-")[0] != "mono"
    for prev in prev_rows:
        Xw, f1, f2, accept = local_mapper.triangulate_pair(
            cfg.kind, cfg.K, s, kf, prev, scale_factors, use_depth=use_depth,
            min_depth=cfg.min_depth)
        s = local_mapper.insert_triangulated(s, kf, prev, Xw, f1, f2, accept)
    return s


def fuse_recent(s: atlas_state.MapState, cfg, scale_factors, n_recent: int = 4):
    """Densify observations into the `n_recent` newest keyframe rows
    (SearchInNeighbors role, LocalMapping.cc:714): one K1 launch per row."""
    n_kf = int(s.n_kf)
    for krow in range(max(0, n_kf - n_recent), n_kf):
        s = fuse.fuse_into_keyframe(cfg.kind, cfg.K, s, krow, scale_factors)
    return s


def ba_window(s: atlas_state.MapState, cfg):
    """The local-BA window: the last `local_window` valid keyframes of the
    active map free and up to 4 earlier ones fixed
    (Optimizer::LocalBundleAdjustment's lFixedCameras, Optimizer.cc:1118),
    padded to local_window + 4 rows by repeating the newest. Returns (rows
    [w + 4] np.int64, n_fixed)."""
    w = cfg.local_window
    valid_rows = np.nonzero((s.kf_valid & (s.kf_map_id == s.active_map)).cpu().numpy())[0]
    n_rows = min(len(valid_rows), w + 4)
    rows = valid_rows[-n_rows:]
    n_fixed = max(2, n_rows - w) if n_rows > 2 else 1
    rows = np.concatenate([rows, np.full((w + 4) - len(rows), rows[-1])])
    return rows, n_fixed


def cull(s: atlas_state.MapState, cfg, rows, use_imu: bool):
    """MapPoint culling and, for a visual map, KeyFrame culling over the
    window once the map has more than local_window + 4 keyframe rows
    (LocalMapping.cc:346, 902); then the landmark statistics. The inertial
    map culls keyframes with the chain rules of
    vi_tracker.cull_keyframes_inertial instead."""
    w = cfg.local_window
    s = local_mapper.cull_landmarks(s)
    if not use_imu and int(s.n_kf) > w + 4:
        s = local_mapper.cull_keyframes(s, torch.as_tensor(rows[: w + 4], device=s.device))
    return atlas_state.update_landmark_stats(s)
