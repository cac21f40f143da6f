"""Monocular tracking state machine with synchronous local mapping (port of
the mono visual path of orb_slam3_tpu/tracking/tracker.py).

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
- `Tracker`: the state machine of `Tracking::Track()` (`Tracking.cc:
  1794-2332`) for a monocular camera: NOT_INITIALIZED -> OK ->
  RECENTLY_LOST -> LOST (a new map in the Atlas), the constant-velocity
  motion model, NeedNewKeyFrame, and keyframe insertion followed by the
  whole local-mapping stack on the same frame (`mapping/pipeline.py`: the
  JAX tracker's `async_mapping=False` path). Each frame's outcome is read
  on that frame, as the JAX tracker does at `pipeline_depth=1`: one host
  read of the outcome scalars besides the two branch reads of the fused
  step.

Left out of the JAX class, each with the slice that brings it: the
background mapper (`runtime/mapper.py`) with its commits and the software
pipeline of in-flight frames (a later slice; ROADMAP Queue 1 item 10);
stereo / RGB-D initialization and tracking, localization-only mode and
keypoint undistortion (item 12); the IMU (item 13); relocalization, loop
closing and global BA (item 14: until then `_try_relocalize` returns False,
as the JAX one does without a loop closer, `tracker.py:690-691`).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from .. import device as device_mod
from ..atlas import ops as atlas_ops
from ..atlas import state as atlas_state
from ..frontend import camera as cam
from ..frontend import matching, orb, two_view
from ..mapping import local_mapper, pipeline
from ..ops import lie
from ..ops.scatter import add_at
from ..utils import verbose
from ..utils.timing import GLOBAL_TIMER
from . import track as track_mod

NOT_INITIALIZED = 0
OK = 1
RECENTLY_LOST = 2
LOST = 3


@dataclasses.dataclass
class TrackerConfig:
    """The fields of the JAX TrackerConfig this path reads, with its
    defaults (`tracker.py:104-161`). Only `sensor="mono"` is ported."""

    K: torch.Tensor = None  # camera params [8]
    kind: int = cam.PINHOLE
    img_wh: tuple = (640, 480)
    sensor: str = "mono"
    orb: orb.OrbConfig = dataclasses.field(default_factory=orb.OrbConfig)
    init_min_matches: int = 80      # Tracking.cc:2492 (100 in the reference)
    min_inliers: int = 15           # Tracking.cc:3030-3061
    kf_min_frames: int = 0
    kf_max_frames: int = 5          # c1a (fps-dependent in the reference)
    kf_tracked_ratio: float = 0.8   # c2 thRefRatio (0.9 mono, Tracking.cc:3155)
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
    track_frame_visual outputs and the predicted pose (R_pred, t_pred)."""
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
    out = track_mod.track_frame_visual(
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
    out["R_pred"], out["t_pred"] = R_pred, t_pred
    return out


def _ref_tracked_map_points(s: atlas_state.MapState, ref_row: int, min_obs: int):
    """KeyFrame::TrackedMapPoints(nMinObs) (`KeyFrame.cc:500`): the
    reference keyframe's features bound to valid landmarks that valid
    keyframes observe at least min_obs times. 0-dim count."""
    L = s.lmax
    bound = (s.kf_feat_valid & s.kf_valid[:, None] & (s.kf_feat_lm >= 0)).reshape(-1)
    counts = add_at(torch.zeros((L,), dtype=torch.int32, device=s.device),
                    torch.clamp(s.kf_feat_lm, 0, L - 1).long().reshape(-1),
                    bound.to(torch.int32), valid=bound)
    ref_lm = torch.clamp(s.kf_feat_lm[ref_row], 0, L - 1).long()
    ok = s.kf_feat_valid[ref_row] & (s.kf_feat_lm[ref_row] >= 0) & s.lm_valid[ref_lm]
    return torch.sum(ok & (counts[ref_lm] >= min_obs))


@dataclasses.dataclass
class FrameRecord:
    """Per-frame pose stored relative to its reference keyframe
    (T_cur<-refkf; mlRelativeFramePoses + mlpReferences,
    `Tracking.cc:2300-2320`), so the exported trajectory picks up later BA
    corrections of the keyframe poses."""

    timestamp: float
    ref_kf: int
    R_rel: torch.Tensor
    t_rel: torch.Tensor
    ok: bool


def _np(a):
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


class Tracker:
    """The monocular tracker with synchronous local mapping.

    `cfg.K` may be a tensor, whose device the tracker runs on, or anything
    numpy reads, which is moved to `device` (default CUDA; RuntimeError
    without it). Feed frames with `process`; read the trajectory with
    `poses`."""

    def __init__(self, cfg: TrackerConfig, device=None):
        if cfg.sensor != "mono":
            raise NotImplementedError(
                f"sensor {cfg.sensor!r}: only 'mono' is ported; stereo / RGB-D come with "
                "their slice, the inertial sensors with the inertial slice")
        if device is None and torch.is_tensor(cfg.K):
            device = cfg.K.device
        dev = device_mod.resolve(device)
        K = torch.as_tensor(np.asarray(_np(cfg.K), np.float32), device=dev)
        # the tracker's own copy: growing the arena updates kmax / lmax
        self.cfg = dataclasses.replace(cfg, K=K)
        self.device = dev
        self.map = empty_map(self.cfg, device=dev)
        self.state = NOT_INITIALIZED
        self.scale_factors = self.cfg.scale_factors()
        self._extract = lambda im: orb.extract(im, self.cfg.orb)
        self.init_ref = None          # (features, timestamp)
        self.last = None              # dict: R, t, feats, ts
        self.velocity = None          # (Rv, tv): T_cur<-last
        self.last_kf_row = -1
        self.last_kf_inliers = 0
        self.last_inliers = 0
        self.frames_since_kf = 0
        self.trajectory: list[FrameRecord] = []
        self.lost_count = 0
        self._map_version = 0         # bumps on structural map updates
        self._tracked_lms = None      # [L] landmarks tracked by the last frame
        self._feat_lm = None          # [F] landmark row of each feature of it
        self._caches = {}

    # ------------------------------------------------------------------
    # host-side caches keyed by the map version
    # ------------------------------------------------------------------
    def _cached(self, name: str, key, fn):
        hit = self._caches.get(name)
        if hit is None or hit[0] != key:
            hit = self._caches[name] = (key, fn())
        return hit[1]

    def _n_kf_cache(self) -> int:
        return self._cached("n_kf", self._map_version, lambda: int(self.map.n_kf))

    def _n_lm_cache(self) -> int:
        return self._cached("n_lm", self._map_version, lambda: int(self.map.n_lm))

    def _local_map_mask(self, s):
        """Covisibility-local landmark mask for tracking (SearchLocalPoints
        scope, `Tracking.cc:3417-3607`), cached per map version; the whole
        active map while there is no reference keyframe."""
        if self.last_kf_row < 0:
            return s.lm_valid & (s.lm_map_id == s.active_map)
        return self._cached("local_mask", (self._map_version, self.last_kf_row),
                            lambda: local_map(s, self.last_kf_row))

    # ------------------------------------------------------------------
    # arena capacity (compaction replaces deletion)
    # ------------------------------------------------------------------
    def _maybe_compact(self):
        """When the bump allocators near capacity, reclaim culled rows by
        stable compaction and re-anchor what refers to rows; if the arena is
        still nearly full, double it (the reference's heap is unbounded;
        KeyFrame::SetBadFlag frees nodes, `KeyFrame.cc:573`)."""
        s = self.map
        lm_tight = self._n_lm_cache() > s.lmax - s.fmax
        kf_tight = self._n_kf_cache() > s.kmax - 4
        if not (lm_tight or kf_tight):
            return
        old_valid, old_parent = _np(s.kf_valid), _np(s.kf_parent)
        old_R, old_t = _np(s.kf_R).astype(np.float64), _np(s.kf_t).astype(np.float64)
        s2, kf_new_t, lm_new_t = atlas_ops.compact(s)
        kf_new = _np(kf_new_t)

        # trajectory records on a culled keyframe move to its nearest valid
        # spanning-tree ancestor, chaining the culled poses (the reference
        # chains mTcp through parents, System.cc:662-882)
        for rec in self.trajectory:
            r = rec.ref_kf
            if r < 0:
                continue
            if not old_valid[r]:
                R_rel, t_rel = _np(rec.R_rel).astype(np.float64), _np(rec.t_rel).astype(np.float64)
                a = r
                while a >= 0 and not old_valid[a]:
                    p = int(old_parent[a])
                    if p < 0:
                        break
                    # T_rel' = T_rel T_a T_p^-1
                    R_ap = old_R[a] @ old_R[p].T
                    t_ap = old_t[a] - R_ap @ old_t[p]
                    t_rel = R_rel @ t_ap + t_rel
                    R_rel = R_rel @ R_ap
                    a = p
                if a >= 0 and old_valid[a]:
                    rec.ref_kf, rec.R_rel, rec.t_rel = a, R_rel, t_rel
                else:
                    rec.ref_kf = -1
                    continue
            rec.ref_kf = int(kf_new[rec.ref_kf])
        if self.last_kf_row >= 0:
            self.last_kf_row = int(kf_new[self.last_kf_row])

        lm_new = lm_new_t.long()
        if self._tracked_lms is not None:
            moved = torch.empty_like(self._tracked_lms)
            moved[lm_new] = self._tracked_lms
            self._tracked_lms = moved
        if self._feat_lm is not None:
            fl = self._feat_lm
            self._feat_lm = torch.where(
                fl >= 0, lm_new_t[torch.clamp(fl, 0, s.lmax - 1).long()], fl)

        # still tight after reclaiming holes: double the capacity
        n_kf2, n_lm2 = (int(v) for v in torch.stack([s2.n_kf, s2.n_lm]).tolist())
        new_kmax = s2.kmax * 2 if n_kf2 > s2.kmax - 8 else None
        new_lmax = s2.lmax * 2 if n_lm2 > s2.lmax - 2 * s2.fmax else None
        if new_kmax or new_lmax:
            verbose.print_mess(f"atlas arena grow: kmax={new_kmax or s2.kmax} "
                               f"lmax={new_lmax or s2.lmax}", verbose.VERBOSITY_NORMAL)
            s2 = atlas_ops.grow(s2, kmax=new_kmax, lmax=new_lmax)
            self.cfg.kmax, self.cfg.lmax = s2.kmax, s2.lmax
            if new_lmax and self._tracked_lms is not None:
                pad = torch.zeros((s2.lmax - self._tracked_lms.shape[0],), dtype=torch.bool,
                                  device=self.device)
                self._tracked_lms = torch.cat([self._tracked_lms, pad])
        self.map = s2
        self._map_version += 1
        verbose.print_mess(f"atlas compacted: n_kf={n_kf2} n_lm={n_lm2}",
                           verbose.VERBOSITY_NORMAL)

    # ------------------------------------------------------------------
    # relocalization (Tracking::Relocalization, Tracking.cc:3609-3761)
    # ------------------------------------------------------------------
    def _try_relocalize(self, feats) -> bool:
        """Relocalization needs the keyframe database of the place-
        recognition slice; without it the JAX tracker returns False too."""
        return False

    # ------------------------------------------------------------------
    def process(self, img, timestamp: float):
        """Track one monocular frame ([H, W] image, anything torch.as_tensor
        reads) taken at `timestamp` seconds."""
        with GLOBAL_TIMER.stage("track.adopt"):
            self._maybe_compact()
        # timestamp sanity (Tracking.cc:1818-1855): a backwards step stores
        # the active map and restarts in a fresh one; a gap over 1 s drops
        # the motion model
        if self.last is not None and self.state != NOT_INITIALIZED:
            gap = timestamp - float(self.last["ts"])
            if gap < -1e-9:
                self._timestamp_jump()
            elif gap > 1.0:
                self.velocity = None
        with GLOBAL_TIMER.stage("track.img_xfer"):
            img = torch.as_tensor(np.asarray(img) if not torch.is_tensor(img) else img,
                                  dtype=torch.float32, device=self.device)
        with GLOBAL_TIMER.stage("orb_extraction"):
            feats = self._extract(img)
        rel = None
        if self.state == NOT_INITIALIZED:
            ok = self._try_initialize(feats, timestamp)
        else:
            ok, rel = self._track_frame(feats, timestamp)
        self._record_frame(timestamp, ok, rel)

    def _timestamp_jump(self):
        """Timestamp discontinuity: store the active map and continue in a
        fresh one (`Tracking.cc:1818-1855` -> CreateMapInAtlas, :2662)."""
        verbose.print_mess("Timestamp discontinuity: creating new map in Atlas",
                           verbose.VERBOSITY_NORMAL)
        self.map = atlas_ops.create_map(self.map)
        self._restart_in_fresh_map()

    def _reset_active_map(self):
        """Discard the active map and restart (Tracking::ResetActiveMap,
        `Tracking.cc:3840`)."""
        self.map = atlas_ops.reset_active_map(self.map)
        self._restart_in_fresh_map()

    def _restart_in_fresh_map(self):
        self._map_version += 1
        self.state = NOT_INITIALIZED
        self.init_ref = None
        self.last = None
        self.velocity = None
        self.last_kf_row = -1
        self.frames_since_kf = 0
        self.lost_count = 0
        self._tracked_lms = None

    def _record_frame(self, timestamp, ok, rel=None):
        if self.last is None or self.last_kf_row < 0:
            self.trajectory.append(FrameRecord(
                timestamp, -1, torch.eye(3), torch.zeros(3), False))
            return
        kf = self.last_kf_row
        if rel is None:
            Ri, ti = lie.se3_inv(self.map.kf_R[kf], self.map.kf_t[kf])
            rel = lie.se3_mul(self.last["R"], self.last["t"], Ri, ti)
        self.trajectory.append(FrameRecord(timestamp, kf, rel[0], rel[1], bool(ok)))

    # ------------------------------------------------------------------
    # initialization (MonocularInitialization, Tracking.cc:2448-2525)
    # ------------------------------------------------------------------
    def _try_initialize(self, feats, timestamp) -> bool:
        res = initialize_monocular(self.cfg, self.map, self.init_ref, feats, timestamp,
                                   seed=len(self.trajectory))
        self.init_ref = res.init_ref
        if not res.success:
            return False
        self.map = res.map
        self.state = OK
        self.last = {"R": res.R, "t": res.t, "feats": feats, "ts": timestamp}
        self.velocity = None
        self.last_kf_row = res.kf1
        self.last_kf_inliers = res.n_landmarks
        self.frames_since_kf = 0
        self._map_version += 1
        return True

    # ------------------------------------------------------------------
    # per-frame tracking (TrackWithMotionModel + TrackLocalMap)
    # ------------------------------------------------------------------
    def _track_frame(self, feats, timestamp):
        """Track one frame and consume its outcome. Returns (ok, rel) where
        rel is the pose relative to the reference keyframe computed in the
        step, or None when that keyframe changed."""
        cfg = self.cfg
        s = self.map
        # a visual tracker that is lost goes straight to relocalization
        # (Tracking.cc:1981-2012)
        if self.state in (RECENTLY_LOST, LOST):
            if self._try_relocalize(feats):
                self.last["ts"] = timestamp
                return True, None
            self.lost_count += 1
            if self.lost_count >= 5:
                self.state = LOST
            self.last["ts"] = timestamp
            self._new_map_if_lost()
            return False, None

        kf_row = self.last_kf_row
        with GLOBAL_TIMER.stage("track.fused_step"):
            out = track_frame(
                cfg, s, feats, kf_row, self.last["R"], self.last["t"],
                velocity=self.velocity, tracked=self._tracked_lms,
                last_inliers=self.last_inliers, in_map=self._local_map_mask(s))
            n_inliers, vel_poisoned = (int(v) for v in out["scal"][:2].tolist())
        self.last_inliers = n_inliers

        if n_inliers < cfg.min_inliers:
            self.lost_count += 1
            self.state = RECENTLY_LOST if self.lost_count < 5 else LOST
            # the prediction stands as the pose estimate
            self.last = {"R": out["R_pred"], "t": out["t_pred"], "feats": feats,
                         "ts": timestamp}
            self.velocity = None
            self._tracked_lms = None
            ok = self._try_relocalize(feats)
            if not ok:
                self._new_map_if_lost()
            return ok, None

        self.lost_count = 0
        self.state = OK
        self.velocity = None if vel_poisoned else (out["Rv"], out["tv"])
        self.last = {"R": out["R"], "t": out["t"], "feats": feats, "ts": timestamp}
        self.frames_since_kf += 1
        self._tracked_lms = out["tracked"]
        self._feat_lm = out["feat_lm"]
        self.map = dataclasses.replace(self.map, lm_visible=self.map.lm_visible + out["vis32"],
                                       lm_found=self.map.lm_found + out["fnd32"])
        with GLOBAL_TIMER.stage("track.kf_decision"):
            need = self._need_new_keyframe(n_inliers)
        if need:
            with GLOBAL_TIMER.stage("track.kf_insert_sync"):
                self._insert_keyframe(feats, timestamp, n_inliers)
        # the step's relative pose holds while the reference keyframe does
        rel = (out["R_rel"], out["t_rel"]) if kf_row == self.last_kf_row else None
        return True, rel

    def _new_map_if_lost(self):
        """A persistent loss of a mature map starts a new map in the Atlas
        (Tracking::CreateMapInAtlas, `Tracking.cc:2014-2032`)."""
        if self.state == LOST and self._n_kf_cache() >= 10:
            self.map = atlas_ops.create_map(self.map)
            self._map_version += 1
            self.state = NOT_INITIALIZED
            self.init_ref = None
            self.last_kf_row = -1

    def _need_new_keyframe(self, n_inliers: int) -> bool:
        """NeedNewKeyFrame (`Tracking.cc:3064-3187`) for a monocular camera
        with synchronous mapping (the mapper is always idle): c1a (max
        frames), c1b (min frames), c2 (tracked ratio 0.9 against the
        reference keyframe's map points observed >= 3 times, or the
        kf_tracked_ratio decay against the inliers at the last insertion),
        and the cadence ceiling (at most kf_max_frames frames without a
        keyframe)."""
        cfg = self.cfg
        n_kfs = self._n_kf_cache()
        if self.last_kf_row >= 0:
            # nMinObs = 3 (2 for tiny maps, Tracking.cc:3097-3099)
            min_obs = 3 if n_kfs > 2 else min(n_kfs, 2)
            ref_matches = self._cached(
                "ref_matches", (self._map_version, self.last_kf_row, min_obs),
                lambda: max(int(_ref_tracked_map_points(self.map, self.last_kf_row,
                                                        min_obs)), 1))
        else:
            ref_matches = max(self.last_kf_inliers, 1)
        th_ratio = 0.9  # Tracking.cc:3144
        c1a = self.frames_since_kf >= cfg.kf_max_frames
        c1b = self.frames_since_kf >= cfg.kf_min_frames
        c2 = ((n_inliers < th_ratio * ref_matches
               or n_inliers < cfg.kf_tracked_ratio * max(self.last_kf_inliers, 1))
              and n_inliers > cfg.min_inliers)
        c_ceiling = c1a and n_inliers > cfg.min_inliers
        return ((c1a or c1b) and c2) or c_ceiling

    # ------------------------------------------------------------------
    def _insert_keyframe(self, feats, timestamp, n_inliers: int):
        """Keyframe insertion and the whole local-mapping stack on this
        frame (the JAX tracker's visual path with async_mapping=False):
        map_stage_pre -> local BA -> map_stage_post."""
        cfg = self.cfg
        if self._n_kf_cache() >= cfg.kmax - 1:
            self._maybe_compact()
        if self._n_kf_cache() >= cfg.kmax - 1:
            return
        pkg = pipeline.KFPackage(
            R=self.last["R"], t=self.last["t"], timestamp=timestamp,
            feat_xy=feats.xy, feat_octave=feats.octave, feat_angle=feats.angle,
            feat_desc=feats.descriptors, feat_valid=feats.valid, feat_lm=self._feat_lm,
            feat_ur=None, feat_depth=None, n_inliers=n_inliers,
        )
        dev = self.device
        with GLOBAL_TIMER.stage_sync("map.pre", dev):
            s, kf, ba_rows, n_fixed = pipeline.run_pre_stage(
                self.map, pkg, cfg, "mono", self.last_kf_row, self.scale_factors)
        with GLOBAL_TIMER.stage_sync("map.local_ba", dev):
            s = pipeline.run_visual_ba(s, cfg, self.scale_factors, ba_rows, n_fixed, "mono")
        with GLOBAL_TIMER.stage_sync("map.culling", dev):
            s = pipeline.map_stage_post(s, ba_rows, cfg.local_window + 4)
        self.map = s
        self._finish_keyframe(kf, n_inliers)

    def _finish_keyframe(self, kf: int, n_inliers: int):
        """Tail of keyframe insertion: the pose refreshed from the optimized
        keyframe and the bookkeeping (loop closing and global BA come with
        their slice)."""
        s = self.map
        self.last["R"] = s.kf_R[kf]
        self.last["t"] = s.kf_t[kf]
        self.velocity = None
        self.last_kf_row = kf
        self.last_kf_inliers = n_inliers
        self.frames_since_kf = 0
        # the next frame tracks against the updated map
        self._map_version += 1

    # ------------------------------------------------------------------
    def poses(self):
        """The trajectory as (timestamps, Tcw rotations [N,3,3],
        translations [N,3], ok [N]) in numpy, each frame composed against
        the current keyframe poses (System::SaveTrajectoryEuRoC)."""
        if not self.trajectory:
            return np.zeros(0), np.zeros((0, 3, 3)), np.zeros((0, 3)), np.zeros(0, bool)
        kf_R = _np(self.map.kf_R).astype(np.float64)
        kf_t = _np(self.map.kf_t).astype(np.float64)
        ts, Rs, tts, oks = [], [], [], []
        for f in self.trajectory:
            ts.append(f.timestamp)
            if f.ref_kf < 0:
                Rs.append(np.eye(3))
                tts.append(np.zeros(3))
                oks.append(False)
                continue
            R_rel, t_rel = _np(f.R_rel).astype(np.float64), _np(f.t_rel).astype(np.float64)
            Rs.append(R_rel @ kf_R[f.ref_kf])
            tts.append(R_rel @ kf_t[f.ref_kf] + t_rel)
            oks.append(f.ok)
        return np.array(ts), np.stack(Rs), np.stack(tts), np.array(oks)
