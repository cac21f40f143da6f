"""Monocular map bootstrap and per-frame tracking (port of the subset of
orb_slam3_tpu/tracking/tracker.py that this path runs).

- `initialize_monocular`: `Tracker._try_initialize`
  (MonocularInitialization + CreateInitialMapMonocular,
  `Tracking.cc:2448-2599`) step for step: wide-window matching against the
  reference frame, two-view reconstruction, two keyframes and the
  triangulated landmarks in the Atlas, the initial 20-iteration BA, the
  median-depth normalization and the landmark statistics. It reads the
  host where the JAX tracker does: one stacked fetch of three gate scalars,
  the reconstruction, the keyframe rows and the landmark depths.
- `track_frame`: the covisibility-local map mask of the reference keyframe
  and the mono fused tracking step (`Tracker._local_map_mask`,
  `_track_frame_fused`), through kernels K1 and K2.

Plain functions over MapState; the caller keeps the tracker's state (the
reference frame, the last pose, the velocity). The full Tracker class comes
with a later slice.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from ..atlas import ops as atlas_ops
from ..atlas import state as atlas_state
from ..frontend import camera as cam
from ..frontend import matching, orb, two_view
from ..mapping import local_mapper
from ..ops import lie
from . import track as track_mod


@dataclasses.dataclass
class TrackerConfig:
    """The fields of the JAX TrackerConfig this path reads, with its
    defaults (`tracker.py:104-161`)."""

    K: torch.Tensor = None  # camera params [8]
    kind: int = cam.PINHOLE
    img_wh: tuple = (640, 480)
    orb: orb.OrbConfig = dataclasses.field(default_factory=orb.OrbConfig)
    init_min_matches: int = 80      # Tracking.cc:2492 (100 in the reference)
    min_inliers: int = 15           # Tracking.cc:3030-3061
    local_window: int = 8
    kmax: int = 128
    lmax: int = 8192
    match_radius_coarse: float = 15.0  # TrackWithMotionModel th (Tracking.cc:2879)
    match_radius_fine: float = 4.0

    def scale_factors(self):
        return self.orb.scale_factors(self.K.device)


def empty_map(cfg: TrackerConfig, device=None) -> atlas_state.MapState:
    """The tracker's empty arena (kmax x n_features x lmax) on `device`
    (default CUDA)."""
    return atlas_state.empty(kmax=cfg.kmax, fmax=cfg.orb.n_features, lmax=cfg.lmax,
                             device=device)


@dataclasses.dataclass
class InitResult:
    """Outcome of one initialize_monocular call. `init_ref` is the
    (features, timestamp) reference the caller keeps for the next call; on
    success `map` holds the two keyframes (rows kf0, kf1) and the landmarks
    and `R`, `t` are keyframe 1's pose."""

    success: bool
    init_ref: Optional[tuple]
    n_matches: int = 0
    map: Optional[atlas_state.MapState] = None
    kf0: int = -1
    kf1: int = -1
    R: Optional[torch.Tensor] = None
    t: Optional[torch.Tensor] = None
    n_landmarks: int = 0
    ba_stats: Optional[tuple] = None
    used_h: bool = False


def no_timer(name: str):
    return contextlib.nullcontext()


def initialize_monocular(cfg: TrackerConfig, s: atlas_state.MapState, init_ref,
                         feats: orb.Features, timestamp: float, seed: int = 0,
                         sets=None, timer: Callable = no_timer) -> InitResult:
    """One MonocularInitialization attempt with frame `feats` against the
    reference `init_ref` = (features, timestamp) or None.

    The minimal sets of the two-view RANSAC are drawn from a CPU
    torch.Generator seeded with `seed` (the JAX tracker seeds its key with
    the frame count), so the same seed gives the same sets on any device;
    `sets` [200, 8] replaces the draw. `timer(name)` is a context manager
    wrapped around each part (matching, reconstruct, atlas, local_ba,
    stats)."""
    if init_ref is None:
        keep = (feats, timestamp) if int(feats.valid.sum()) > 100 else None
        return InitResult(False, keep)
    ref, ref_ts = init_ref
    with timer("matching"):
        idx, ok = matching.search_for_initialization(
            ref.xy, ref.descriptors, ref.valid, feats.xy, feats.descriptors, feats.valid,
            window=100.0, ratio=0.9)
    with timer("reconstruct"):
        gen = None if sets is not None else torch.Generator().manual_seed(int(seed))
        res = two_view.reconstruct(ref.xy, feats.xy[idx], ok, cfg.K, generator=gen,
                                   sets=sets, min_triangulated=50)
        # one stacked fetch of the three gates
        gates = torch.stack([feats.valid.sum(), ok.sum(),
                             res["success"].to(torch.int64)]).cpu().numpy()
    n_kp, n_match = int(gates[0]), int(gates[1])
    if n_match < cfg.init_min_matches:
        return InitResult(False, (feats, timestamp) if n_kp > 100 else None, n_match)
    if not gates[2]:
        return InitResult(False, init_ref, n_match)

    with timer("reconstruct"):
        good = res["good"].cpu().numpy()
        X = res["X"].cpu().numpy()
        R = res["R"].cpu().numpy()
        t = res["t"].cpu().numpy()
        # median-depth normalization (CreateInitialMapMonocular:2582-2599)
        med = float(np.median(X[good][:, 2]))
    if med <= 0:
        return InitResult(False, init_ref, n_match)
    X, t = X / med, t / med

    dev = s.device
    f32 = dict(dtype=torch.float32, device=dev)
    with timer("atlas"):
        s, kf0 = atlas_ops.add_keyframe(
            s, torch.eye(3, **f32), torch.zeros(3, **f32), ref_ts,
            ref.xy, ref.octave, ref.angle, ref.descriptors, ref.valid)
        s, kf1 = atlas_ops.add_keyframe(
            s, torch.as_tensor(R, **f32), torch.as_tensor(t, **f32), timestamp,
            feats.xy, feats.octave, feats.angle, feats.descriptors, feats.valid,
            parent=kf0, prev=kf0)
        kf0, kf1 = int(kf0), int(kf1)
        # new landmarks bound to the reference frame's features, then
        # observed from keyframe 1
        accept = torch.as_tensor(good, device=dev) & ok
        n = X.shape[0]
        kf0_col = torch.full((n,), kf0, dtype=torch.int32, device=dev)
        s, rows = atlas_ops.add_landmarks(
            s, torch.as_tensor(X, **f32), ref.descriptors, kf0_col, accept, kf0_col,
            torch.arange(n, dtype=torch.int32, device=dev))
        s = atlas_ops.add_observations(s, kf1, idx, rows, accept & (rows >= 0))

    # the initial BA (20 iterations, Tracking.cc:2580), then the median-depth
    # renormalization (the reference normalizes after it, :2582-2599)
    with timer("local_ba"):
        window_rows = torch.tensor([kf0, kf1] + [kf1] * (cfg.local_window - 2),
                                   dtype=torch.int32, device=dev)
        s, stats = local_mapper.local_ba(
            cfg.kind, cfg.K, s, window_rows, n_fixed=1, window=cfg.local_window,
            iters=20, scale_factors=cfg.scale_factors())
    with timer("stats"):
        active = s.lm_valid.cpu().numpy()
        z0 = s.lm_pos.cpu().numpy()[active][:, 2]
        med2 = float(np.median(z0[z0 > 0])) if (z0 > 0).any() else 1.0
        if med2 > 0:
            inv = 1.0 / med2
            s = dataclasses.replace(
                s,
                lm_pos=torch.where(s.lm_valid[:, None], s.lm_pos * inv, s.lm_pos),
                kf_t=torch.where(s.kf_valid[:, None], s.kf_t * inv, s.kf_t),
            )
        s = atlas_state.update_landmark_stats(s)
    return InitResult(
        True, None, n_match, map=s, kf0=kf0, kf1=kf1, R=s.kf_R[kf1], t=s.kf_t[kf1],
        n_landmarks=int(accept.sum()), ba_stats=stats, used_h=bool(res["used_h"]),
    )


def local_map(s: atlas_state.MapState, ref_kf: int):
    """[L] bool landmarks tracking matches against: the covisibility-local
    map of keyframe `ref_kf` (`Tracker._local_map_mask`), or the whole
    active map while there is no reference keyframe."""
    if ref_kf < 0:
        return s.lm_valid & (s.lm_map_id == s.active_map)
    W_row = atlas_state.covisibility_weights(s)[ref_kf]
    return track_mod.local_map_mask(
        s.kf_feat_lm, s.kf_feat_valid, s.kf_valid, s.lm_valid, s.lm_map_id,
        s.active_map, W_row, ref_kf)


def track_frame(cfg: TrackerConfig, s: atlas_state.MapState, feats: orb.Features,
                ref_kf: int, R_last, t_last, velocity=None, tracked=None,
                last_inliers: int = 0, in_map=None):
    """Track one mono frame against the map (`Tracker._track_frame_fused`
    without census, two-camera stage or chained prediction). The pose is
    predicted by the constant-velocity model when `velocity` = (Rv, tv) is
    given, else it is the last pose. `tracked` [L] is the previous frame's
    tracked mask; `in_map` defaults to `local_map(s, ref_kf)`. Returns the
    track_frame_visual outputs."""
    dev = s.device
    if in_map is None:
        in_map = local_map(s, ref_kf)
    if velocity is not None:
        R_pred, t_pred = lie.se3_mul(velocity[0], velocity[1], R_last, t_last)
    else:
        R_pred, t_pred = R_last, t_last
    kf = max(ref_kf, 0)
    ref_lm_rows = s.kf_feat_lm[kf]
    ref_has_lm = ((ref_lm_rows >= 0) & s.kf_feat_valid[kf] if ref_kf >= 0
                  else torch.zeros((s.fmax,), dtype=torch.bool, device=dev))
    if tracked is None:
        tracked = torch.zeros((s.lmax,), dtype=torch.bool, device=dev)
    return track_mod.track_frame_visual(
        cfg.kind, cfg.K, 0.0,
        s.lm_pos, s.lm_desc, in_map, s.lm_max_dist, s.lm_min_dist, s.lm_normal,
        s.kf_feat_desc[kf], ref_has_lm, ref_lm_rows,
        feats.xy, feats.descriptors, feats.octave, feats.valid,
        -torch.ones((s.fmax,), dtype=torch.float32, device=dev),
        R_pred, t_pred, R_last, t_last,
        velocity is not None, tracked, last_inliers,
        cfg.match_radius_coarse, cfg.match_radius_fine, cfg.min_inliers,
        cfg.scale_factors(), float(cfg.img_wh[0]), float(cfg.img_wh[1]),
        use_stereo=False,
        R_kf=s.kf_R[kf] if ref_kf >= 0 else None,
        t_kf=s.kf_t[kf] if ref_kf >= 0 else None,
    )
