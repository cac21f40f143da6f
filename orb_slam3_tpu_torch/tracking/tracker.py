"""Tracking state machine with background or synchronous local mapping
(port of orb_slam3_tpu/tracking/tracker.py: mono, stereo and RGB-D with a
pinhole or a KB8 fisheye camera, each also with an IMU).

- `initialize_monocular`: `Tracker._try_initialize`
  (MonocularInitialization + CreateInitialMapMonocular,
  `Tracking.cc:2448-2599`) step for step: wide-window matching against the
  reference frame, two-view reconstruction, two keyframes and the
  triangulated landmarks in the Atlas, the initial 20-iteration BA, the
  median-depth normalization and the landmark statistics. It reads the
  host where the JAX tracker does: one stacked fetch of three gate scalars,
  the reconstruction, the keyframe rows and the landmark depths.
- `track_frame`: the covisibility-local map mask of the reference keyframe
  and the fused tracking step (`Tracker._local_map_mask`,
  `_track_frame_fused`), through kernels K1 and K2; with a depth sensor the
  pose BA takes the frame's stereo rows (K2's stereo template) and the
  step counts the close points NeedNewKeyFrame reads.
- `Tracker`: the state machine of `Tracking::Track()` (`Tracking.cc:
  1794-2332`): NOT_INITIALIZED -> OK -> RECENTLY_LOST -> LOST (a new map in
  the Atlas), the constant-velocity motion model, NeedNewKeyFrame, and
  keyframe insertion. A stereo pair is two extractions and `frontend/stereo.match_stereo`;
  a non-rectified fisheye pair (`stereo_fisheye`) is matched and
  triangulated by `match_stereo_fisheye`, its depth bound as ur = u - bf/z,
  and the right camera's features join the pose BA through the rig's
  extrinsics (`track.pose_optimize_two_cam`); an RGB-D frame binds its
  depth map with `depth_from_rgbd`; each initializes from one frame
  (`StereoInitialization`). A pinhole camera with rad-tan `dist_coeffs`
  has its keypoints undistorted right after extraction. With mapping paused
  (localization mode) a depth sensor tracks against the frozen map plus the
  previous frame's visual-odometry points.

Mapping runs as the config says, with the JAX TrackerConfig's defaults:
- `async_mapping=True` (the default): a keyframe becomes a KFPackage
  queued to the background mapper (`runtime/mapper.py`, on a thread and a
  CUDA stream of its own), which runs the whole local-mapping stack, the
  inertial init and refinement and the loop closer, and publishes commits;
  the tracker adopts the latest at each frame boundary (re-anchoring its
  pose after a loop, merge, global BA or inertial gauge change) and buffers
  the landmark statistics of its frames into the next package.
  `deterministic_mapping=True` steps the same mapper inline, one package
  per frame boundary, with no thread.
- `async_mapping=False`: the keyframe's whole mapping stack runs on the
  frame that inserts it (`mapping/pipeline.py`).
- `pipeline_depth` (6 by default) frames of the fused visual step may be in
  flight: frame i's outcome scalars are consumed up to depth - 1 frames
  later, as soon as their copy to pinned host memory has landed (a CUDA
  event; on the CPU at once), and the next frame's prediction chains on the
  device from the previous step's outputs meanwhile. The state machine
  then lags by up to depth - 1 frames. At depth 1, and always for an
  inertial sensor, each frame's outcome is consumed on that frame.

An inertial sensor ("mono-imu", "stereo-imu", "rgbd-imu") takes each
frame's IMU packet (`process(..., imu=...)`, `tracking/vi_tracker.py`):
before the IMU is initialized the tracker inserts a keyframe every 0.25 s
and runs the visual stages; the inertial initialization runs after a
keyframe once the chain is long enough, then the staged refinements. After
it the pose is predicted from the preintegration, the fused visual step
(K1, K2) warm-starts it and the pose-inertial optimization refines it
(`vi_pose_opt.pose_inertial_optimize`, chained through the marginal
prior), and each keyframe runs the visual-inertial local BA and inertial
keyframe culling. A stereo or RGB-D inertial map is anchored only once the
accelerometer shows excitation.

With a vocabulary attached (`attach_loop_closer`) the tracker relocalizes
a lost frame against the keyframe database (BoW candidates, PnP RANSAC,
MLPnP, then the motion-only BA through K2), runs the loop closer after each
keyframe (loop correction or map merge, `graphopt/loop_closer.py`) and
starts a global BA in a side thread after a loop correction
(`mapping/global_ba.py`), whose result is reconciled into the map at a
later keyframe.

The JAX tracker's readiness probe and host-copy choreography around its
device link are not ported: the probe here is a CUDA event after the
outcome's copy to pinned memory.
"""

from __future__ import annotations

import contextlib
import dataclasses
from collections import deque
from typing import Callable, Optional

import numpy as np
import torch

from .. import device as device_mod
from ..atlas import ops as atlas_ops
from ..atlas import state as atlas_state
from ..frontend import camera as cam
from ..frontend import matching, orb, stereo, two_view
from ..graphopt import loop_closer as lc
from ..imu import factors
from ..imu import preintegration as preint_mod
from ..mapping import global_ba, local_mapper, pipeline
from ..ops import lie
from ..ops.scatter import add_at
from ..place import recognition, vocab as vocab_mod
from ..runtime import mapper as mapper_mod
from ..utils import verbose
from ..utils.timing import GLOBAL_TIMER
from . import track as track_mod
from . import vi_pose_opt, vi_tracker

NOT_INITIALIZED = 0
OK = 1
RECENTLY_LOST = 2
LOST = 3

# the frame's outcome goes through the software pipeline, which records it
# (Tracker._finalize_one)
PENDING = object()


@dataclasses.dataclass
class TrackerConfig:
    """The fields of the JAX TrackerConfig this path reads, with its
    defaults (`tracker.py:104-161`); every sensor of it is ported. The
    camera vectors, extrinsics and distortion may be tensors or anything
    numpy reads; the Tracker moves them to its device."""

    K: torch.Tensor = None  # camera params [8]
    kind: int = cam.PINHOLE
    img_wh: tuple = (640, 480)
    sensor: str = "mono"            # mono | stereo | rgbd, each also with "-imu"
    bf: float = 0.0                 # baseline * fx (stereo / RGB-D)
    imu_noise: dict = dataclasses.field(default_factory=lambda: dict(
        noise_gyro=1.7e-3, noise_acc=2e-2, walk_gyro=1.9e-4, walk_acc=3e-2))
    Tbc: np.ndarray = None          # body-from-camera extrinsics [4, 4] (identity)
    min_depth: float = 0.1
    th_depth: float = 40.0          # close-point threshold (Settings thDepth)
    depth_factor: float = 1.0       # RGB-D depth map scaling
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
    # non-rectified (fisheye) stereo: the right camera's intrinsics and the
    # extrinsics X_r = R_rl X_l + t_rl; depth from two-view triangulation
    # (Frame::ComputeStereoFishEyeMatches, Frame.cc:1126)
    stereo_fisheye: bool = False
    K_right: torch.Tensor = None
    R_rl: torch.Tensor = None
    t_rl: torch.Tensor = None
    # pinhole rad-tan distortion (k1 k2 p1 p2 k3): keypoints are undistorted
    # after extraction (Frame::UndistortKeyPoints, Frame.cc:747-780); None
    # for rectified or distortion-free input
    dist_coeffs: torch.Tensor = None
    # run the per-keyframe mapping stack (triangulation, fuse, local BA,
    # culling, the inertial init and refinement, loop detection) on a
    # background mapper thread over immutable snapshots: the reference's
    # LocalMapping / LoopClosing threads (System.cc:197,214), for every
    # sensor
    async_mapping: bool = True
    # deterministic scheduling of that mapper: the same queue / commit /
    # adopt dataflow, stepped inline at each frame boundary (one package per
    # frame) instead of a free-running thread, reproducible run to run
    deterministic_mapping: bool = False
    # software-pipeline depth of the fused visual tracking step: up to
    # `pipeline_depth` frames in flight before the host consumes frame
    # i - depth + 1's outcome scalars; the state machine (loss, keyframe
    # decisions) lags by up to depth - 1 frames, the bounded staleness the
    # mapper runs under already. 1 restores the synchronous loop
    pipeline_depth: int = 6

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
                last_inliers: int = 0, in_map=None, frame_ur=None, frame_depth=None,
                th_depth_m: float = 0.0, feats_r=None, pred=None, chain=None):
    """Track one frame against the map (`Tracker._track_frame_fused`). The
    pose is
    predicted by the constant-velocity model when `velocity` = (Rv, tv) is
    given, else it is the last pose. `tracked` [L] is the previous frame's
    tracked mask; `in_map` defaults to `local_map(s, ref_kf)`. With
    `frame_ur` [F] (a depth sensor's right coordinates, -1 where none) the
    pose BA runs mono and stereo rows with cfg.bf; with `frame_depth` [F]
    the step also counts the tracked and untracked close points (depth in
    (cfg.min_depth, th_depth_m)) into scal[2:4]. With `feats_r`, the right
    image's features of a fisheye rig (cfg.stereo_fisheye), the step adds
    the right-camera stage: the local map matched through the extrinsics
    (K1) and the pose refined over both cameras. `pred` = (R, t) replaces
    the prediction (the IMU's, after inertial initialization). `chain`, the
    outputs of the previous step still in flight, replaces the host state:
    its pose, velocity, velocity flag, tracked mask and inlier count feed
    this step on the device (the software pipeline; R_last / t_last,
    velocity, tracked and last_inliers are then ignored). Returns the
    track_frame_visual outputs and the predicted pose (R_pred, t_pred), the
    fallback pose of a failed frame (the chained step's last pose)."""
    dev = s.device
    if in_map is None:
        in_map = local_map(s, ref_kf)
    chain_pred = chain is not None
    if chain_pred:
        # the motion-model prediction is chained inside the step
        R_pred, t_pred, R_last, t_last = chain["Rv"], chain["tv"], chain["R"], chain["t"]
        have_velocity, tracked, last_inliers = chain["has_vel"], chain["tracked"], chain["n"]
    elif pred is not None:
        R_pred, t_pred = pred
    elif velocity is not None:
        R_pred, t_pred = lie.se3_mul(velocity[0], velocity[1], R_last, t_last)
    else:
        R_pred, t_pred = R_last, t_last
    if not chain_pred:
        have_velocity = velocity is not None
    kf = max(ref_kf, 0)
    ref_lm_rows = s.kf_feat_lm[kf]
    ref_has_lm = ((ref_lm_rows >= 0) & s.kf_feat_valid[kf] if ref_kf >= 0
                  else torch.zeros((s.fmax,), dtype=torch.bool, device=dev))
    if tracked is None:
        tracked = torch.zeros((s.lmax,), dtype=torch.bool, device=dev)
    use_stereo = frame_ur is not None
    if not use_stereo:
        frame_ur = -torch.ones((s.fmax,), dtype=torch.float32, device=dev)
    two_cam = {}
    if feats_r is not None:
        two_cam = dict(use_two_cam=True, rfeat_xy=feats_r.xy, rfeat_desc=feats_r.descriptors,
                       rfeat_octave=feats_r.octave, rfeat_valid=feats_r.valid,
                       K_r=cfg.K_right, R_rl=cfg.R_rl, t_rl=cfg.t_rl)
    out = track_mod.track_frame_visual(
        cfg.kind, cfg.K, cfg.bf if use_stereo else 0.0,
        s.lm_pos, s.lm_desc, in_map, s.lm_max_dist, s.lm_min_dist, s.lm_normal,
        s.kf_feat_desc[kf], ref_has_lm, ref_lm_rows,
        feats.xy, feats.descriptors, feats.octave, feats.valid, frame_ur,
        R_pred, t_pred, R_last, t_last,
        have_velocity, tracked, last_inliers,
        cfg.match_radius_coarse, cfg.match_radius_fine, cfg.min_inliers,
        cfg.scale_factors(), float(cfg.img_wh[0]), float(cfg.img_wh[1]),
        use_stereo=use_stereo, chain_pred=chain_pred,
        with_census=frame_depth is not None, feat_depth=frame_depth,
        min_depth=cfg.min_depth, th_depth_m=th_depth_m,
        R_kf=s.kf_R[kf] if ref_kf >= 0 else None,
        t_kf=s.kf_t[kf] if ref_kf >= 0 else None,
        **two_cam,
    )
    out["R_pred"], out["t_pred"] = (R_last, t_last) if chain_pred else (R_pred, t_pred)
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
    """The tracker of a pinhole or KB8 camera (mono, stereo or RGB-D, each
    also with an IMU), with the background mapper or synchronous mapping as
    the config says.

    `cfg.K` may be a tensor, whose device the tracker runs on, or anything
    numpy reads, which is moved to `device` (default CUDA; RuntimeError
    without it). Feed frames with `process`; read the trajectory with
    `poses`. Set `mapping_paused` for localization-only mode. `settle`
    consumes the frames in flight, `sync_mapping` also drains the mapper;
    call `shutdown` before leaving (it stops the mapper thread)."""

    def __init__(self, cfg: TrackerConfig, device=None):
        if cfg.sensor not in ("mono", "stereo", "rgbd", "mono-imu", "stereo-imu", "rgbd-imu"):
            raise ValueError(f"unknown sensor {cfg.sensor!r}")
        if device is None and torch.is_tensor(cfg.K):
            device = cfg.K.device
        dev = device_mod.resolve(device)
        K_np = np.asarray(_np(cfg.K), np.float32)

        def on_dev(a):
            return None if a is None else torch.as_tensor(np.asarray(_np(a), np.float32),
                                                          device=dev)

        # the tracker's own copy: growing the arena updates kmax / lmax
        self.cfg = dataclasses.replace(
            cfg, K=on_dev(K_np), K_right=on_dev(cfg.K_right), R_rl=on_dev(cfg.R_rl),
            t_rl=on_dev(cfg.t_rl), dist_coeffs=on_dev(cfg.dist_coeffs))
        self.base_sensor = cfg.sensor.split("-")[0]
        if cfg.stereo_fisheye and (self.base_sensor != "stereo" or self.cfg.K_right is None
                                   or self.cfg.R_rl is None or self.cfg.t_rl is None):
            raise ValueError("stereo_fisheye needs the stereo sensor, K_right, R_rl and t_rl")
        self.device = dev
        # close points lie nearer than bf * thDepth / fx (Tracking.cc:628)
        self.th_depth_m = cfg.bf * cfg.th_depth / float(K_np[0])
        self.map = empty_map(self.cfg, device=dev)
        self.state = NOT_INITIALIZED
        self.scale_factors = self.cfg.scale_factors()
        # rad-tan undistortion of a pinhole camera's keypoints; descriptors
        # stay sampled from the raw image, as in the reference
        dist = self.cfg.dist_coeffs
        self._undistort = (dist is not None and cfg.kind == cam.PINHOLE
                           and float(np.abs(_np(dist)).max()) > 0)
        self.init_ref = None          # (features, timestamp)
        self.last = None              # dict: R, t, feats, ts
        self.velocity = None          # (Rv, tv): T_cur<-last
        self.last_kf_row = -1
        self.last_kf_inliers = 0
        self.last_inliers = 0
        self.frames_since_kf = 0
        self.trajectory: list[FrameRecord] = []
        self.lost_count = 0
        self.mapping_paused = False   # localization-only mode (System.cc:409)
        self._frame_ur = None         # [F] this frame's right coordinates (depth sensors)
        self._frame_depth = None      # [F] and depths
        self._frame_feats_r = None    # the right image's features (fisheye stereo)
        self._census = None           # (tracked, untracked) close points of this frame
        self._vo_buffer = None        # localization mode: last frame's VO points
        self._map_version = 0         # bumps on structural map updates
        self._tracked_lms = None      # [L] landmarks tracked by the last frame
        self._feat_lm = None          # [F] landmark row of each feature of it
        self._caches = {}
        self._last_reloc_frame = -(10 ** 9)  # keyframe cooldown after a relocalization
        self.loop_closer = None       # LoopCloser (attach_loop_closer)
        self.gba = None               # background GlobalBARunner (synchronous mapping)
        self.background_gba = True    # global BA in a side thread after a loop correction
        self.async_mapper = None      # runtime.mapper.AsyncMapper (made at the first package)
        self._mapper_stale = False    # the tracker changed the map outside the mapper
        self._mapper_gauge_version = 0  # the last adopted commit's version
        self._stat_vis = None         # buffered landmark statistics of the next package
        self._stat_found = None
        self._last_kf_req_ts = -1e9   # timestamp of the last queued keyframe
        self._pipeline = deque()      # in-flight frames of the fused visual step
        self.debug_events: list[dict] = []  # inertial init / refinement history (SaveDebugData)
        self._vi_prior = None         # ConstraintPoseImu chain (Optimizer.cc:4875)
        self._last_avg_a = None       # the excitation gate's previous mean acceleration
        self.imu = None
        if cfg.sensor.endswith("-imu"):
            Tbc = cfg.Tbc if cfg.Tbc is not None else np.eye(4, dtype=np.float32)
            self.imu = vi_tracker.ImuState(cfg.imu_noise, _np(Tbc), dev)

    def attach_loop_closer(self, voc: vocab_mod.Vocabulary):
        """Enable place recognition with vocabulary `voc` (moved to the
        tracker's device): relocalization, loop closing and map merging
        (the LoopClosing thread and KeyFrameDatabase roles)."""
        voc = dataclasses.replace(voc, centers=voc.centers.to(self.device),
                                  weights=voc.weights.to(self.device))
        self.loop_closer = lc.LoopCloser(voc, self.cfg.kmax, scale_factors=self.scale_factors)
        if self.async_mapper is not None:
            self.async_mapper.loop_closer = self.loop_closer

    def _stop_gba(self):
        """Abort a running global BA, the tracker's or an idle mapper's, and
        wait for it (mbStopGBA)."""
        for owner in (self, self.async_mapper):
            gba = None if owner is None else owner.gba
            if gba is not None and gba.running:
                gba.request_abort()
                gba.join(timeout=60.0)
            if owner is not None:
                owner.gba = None

    # ------------------------------------------------------------------
    # the background mapper (runtime/mapper.py dataflow)
    # ------------------------------------------------------------------
    def _ensure_mapper(self):
        """Make and start the mapper at the first package; reseed it with the
        tracker's map after the tracker changed the map itself (a new map, a
        relocalization map switch, compaction, a re-initialization)."""
        if self.async_mapper is None:
            self.async_mapper = mapper_mod.AsyncMapper(
                self.cfg, self.scale_factors, self.base_sensor, loop_closer=self.loop_closer,
                background_gba=self.background_gba, inline=self.cfg.deterministic_mapping)
            self.async_mapper.start(self.map, self.last_kf_row, imu=self.imu)
        elif self._mapper_stale:
            self.async_mapper.flush()
            self.async_mapper.poll_commit()  # the tracker's map is authoritative
            self.async_mapper.set_state(self.map, self.last_kf_row, imu=self.imu)
        else:
            return
        self._mapper_stale = False
        self._mapper_gauge_version = self.async_mapper._version

    def _adopt_commits(self):
        """At a frame boundary: step an inline mapper once, raise its error,
        adopt the latest commit (the reference's map-update detection,
        Tracking.cc:1888-1896)."""
        m = self.async_mapper
        if m is None:
            return
        if m.inline:
            m.step_inline()  # the fixed schedule: one package per frame boundary
        if m.error is not None:
            err, m.error = m.error, None
            raise RuntimeError("the background mapper failed") from err
        c = m.poll_commit()
        if c is not None and not self._mapper_stale:
            if c.big_change:
                # frames in flight were chained in the old world
                self._finalize_pending()
            self._adopt(c)

    def _adopt(self, c):
        """Take commit `c` as the map: the tracker's stream waits for its
        event and marks its tensors; the relative frame poses rescale by its
        gauge scale; after a big change the pose is carried over through
        the package's keyframe, T_cur_new = (T_cur T_pkg^-1, its translation
        scaled by the gauge scale) T_kf_new (small local-BA refinements do
        not move it: the next pose BA converges onto the refined map); the
        host caches take the commit's counts; the IMU takes its biases (and
        its velocity on a gauge change or at the init); a bad-IMU flag
        resets the active map."""
        stream = None
        if c.event is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(c.event)
        mapper_mod.hand_over((c.state, c.stats, c.imu_state), stream)
        s_new = c.state
        self._mapper_gauge_version = c.version
        gs = c.gauge_scale
        if gs != 1.0:
            for f in self.trajectory:
                f.t_rel = f.t_rel * gs
        if c.kf_row >= 0:
            self.last_kf_row = int(c.kf_row)
        if c.big_change and c.kf_row >= 0 and self.last is not None:
            R_rel, t_rel = lie.se3_mul(self.last["R"], self.last["t"],
                                       *lie.se3_inv(c.pkg_R, c.pkg_t))
            if gs != 1.0:
                t_rel = t_rel * gs
            Rn, tn = lie.se3_mul(R_rel, t_rel, s_new.kf_R[c.kf_row], s_new.kf_t[c.kf_row])
            self.last["R"], self.last["t"] = lie.normalize_rotation(Rn), tn
        self.map = s_new
        self._map_version += 1
        self.debug_events.extend(c.debug_events)
        if c.stats is not None:
            n_kf, n_lm, *rm = c.stats.tolist()
            v = self._map_version
            self._caches["n_kf"] = (v, n_kf)
            self._caches["n_lm"] = (v, n_lm)
            if c.kf_row >= 0:
                self._caches["kf_ts"] = ((v, int(c.kf_row)), c.pkg_ts)
                mo = 3 if n_kf > 2 else min(n_kf, 2)
                if mo >= 1:
                    self._caches["ref_matches"] = ((v, int(c.kf_row), mo), max(rm[mo - 1], 1))
        if c.imu_state is not None and self.imu is not None:
            st = c.imu_state
            was_init = self.imu.initialized
            self.imu.initialized = st["initialized"]
            self.imu.viba_stage = st["viba_stage"]
            self.imu.bg, self.imu.ba = st["bg"], st["ba"]
            if c.big_change or (st["initialized"] and not was_init):
                self.imu.vel = st["vel"]
        if c.bad_imu and self.imu is not None:
            # mbBadImu found on the mapper: reset the active map
            # (LocalMapping.cc:136-146)
            self.imu.bad = True
            self._reset_active_map()
            return
        if c.big_change:
            self.velocity = None
            self._tracked_lms = None
            self._vi_prior = None

    def _mapper_barrier(self):
        """Drain the mapper and adopt its final commit before the tracker
        changes the map itself (RequestStop + isStopped, LoopClosing.cc:
        975-999), and take back the mapper-owned IMU bookkeeping so that
        the tracker's surgery works on the real intervals."""
        m = self.async_mapper
        if m is None:
            return
        c = m.flush()
        if c is not None and not self._mapper_stale:
            self._adopt(c)
        mimu = m.export_imu()
        if mimu is not None and self.imu is not None:
            imu = self.imu
            imu.kf_buffers = mimu.kf_buffers
            imu.first_kf_ts, imu.init_ts = mimu.first_kf_ts, mimu.init_ts
            imu.last_scale_refine_ts, imu.tinit = mimu.last_scale_refine_ts, mimu.tinit

    def sync_mapping(self):
        """Barrier: consume the frames in flight and drain the mapper, so that
        `map` reflects every queued package (System's save, shutdown and
        global-BA entry points call it)."""
        self._finalize_pending()
        self._mapper_barrier()

    def shutdown(self):
        """Drain and stop the mapper thread and any background global BA.
        Callers of Tracker or System must call this (System.shutdown does)
        before leaving: a mapper thread left inside a CUDA call at teardown
        aborts the process."""
        self.sync_mapping()
        self._stop_gba()
        if self.async_mapper is not None:
            self.async_mapper.stop()
            self.async_mapper = None

    def adopt_map(self, s_new: atlas_state.MapState):
        """Replace the map of a live session from outside: a map shipped in
        from another host (`parallel/multihost.HostedAtlas.ship_map`) or an
        atlas loaded into a running tracker (`Tracker.adopt_map`,
        `tracking/tracker.py:435` of the JAX package). `s_new` keeps this
        session's rows where they were (ship_map appends), so the
        bindings the tracker holds stay valid. The frames in flight and the
        mapper are drained first (they hold rows of the old arena); the
        per-landmark buffers grow to the new capacity; the mapper is
        reseeded with the new map and the place-recognition database
        rebuilt from it (Atlas::PostLoad re-adds every keyframe,
        `System.cc:1445-1506`)."""
        self.sync_mapping()
        if s_new.kmax < self.map.kmax or s_new.lmax < self.map.lmax:
            raise ValueError("adopt_map cannot shrink the arena under live tracker state")
        s_new = atlas_state.to_device(s_new, self.device)
        L_new = s_new.lmax
        if L_new > self.map.lmax:
            def pad(a):
                return torch.cat([a, torch.zeros((L_new - a.shape[0],), dtype=a.dtype,
                                                 device=a.device)])

            if self._tracked_lms is not None:
                self._tracked_lms = pad(self._tracked_lms)
            if self._stat_vis is not None:
                vis, fnd = self._stats_reduce()
                self._stat_vis, self._stat_found = [pad(vis)], [pad(fnd)]
        if s_new.kmax > self.map.kmax and self.loop_closer is not None:
            old = self.loop_closer  # the database has kmax rows: a new loop closer
            self.cfg.kmax = s_new.kmax
            self.attach_loop_closer(old.voc)
            self.loop_closer.n_loops, self.loop_closer.n_merges = old.n_loops, old.n_merges
        self.cfg.kmax, self.cfg.lmax = s_new.kmax, s_new.lmax
        self.map = s_new
        self._map_version += 1
        self._vi_prior = None
        if self.async_mapper is not None:
            self.async_mapper.set_state(s_new, self.last_kf_row, imu=self.imu)
            self._mapper_stale = False
            self._mapper_gauge_version = self.async_mapper._version
        if self.loop_closer is not None:
            self.loop_closer.pending = None
            self.loop_closer.rebuild_db(s_new)

    def _stats_reduce(self):
        """The buffered per-frame landmark statistics summed into one [L]
        array each (pairwise, in frame order)."""
        if self._stat_vis is None:
            return None, None
        vis, fnd = self._stat_vis[0], self._stat_found[0]
        for v, f in zip(self._stat_vis[1:], self._stat_found[1:]):
            vis, fnd = vis + v, fnd + f
        self._stat_vis, self._stat_found = [vis], [fnd]
        return vis, fnd

    def _add_frame_stats(self, vis32, fnd32):
        """A tracked frame's landmark statistics (mnVisible / mnFound,
        Tracking::SearchLocalPoints): buffered for the next package while
        the mapper owns the map, else written into the map."""
        if self.cfg.async_mapping:
            if self._stat_vis is None:
                self._stat_vis, self._stat_found = [], []
            self._stat_vis.append(vis32)
            self._stat_found.append(fnd32)
        else:
            self.map = dataclasses.replace(self.map, lm_visible=self.map.lm_visible + vis32,
                                           lm_found=self.map.lm_found + fnd32)

    def _keyframe(self, feats, timestamp, n_inliers: int):
        if self.cfg.async_mapping:
            with GLOBAL_TIMER.stage("track.kf_request"):
                self._request_keyframe(feats, timestamp, n_inliers)
        else:
            with GLOBAL_TIMER.stage("track.kf_insert_sync"):
                self._insert_keyframe(feats, timestamp, n_inliers)

    def _request_keyframe(self, feats, timestamp, n_inliers: int) -> bool:
        """The asynchronous keyframe insertion: package the frame and queue
        it to the mapper (LocalMapping::InsertKeyFrame). An inertial package
        carries the IMU interval cut from the open window and is forced in;
        a refused package gives its interval back. The first package
        blocks until it is mapped, as in the JAX tracker. Returns whether
        it was queued. A visual package waits for the mapper to be idle, so
        it is never refused and the mapper lags the tracker by one package
        at most."""
        self._ensure_mapper()
        stat_vis, stat_found = self._stats_reduce()
        pkg = pipeline.KFPackage(
            R=self.last["R"], t=self.last["t"], timestamp=timestamp,
            feat_xy=feats.xy, feat_octave=feats.octave, feat_angle=feats.angle,
            feat_desc=feats.descriptors, feat_valid=feats.valid, feat_lm=self._feat_lm,
            feat_ur=self._frame_ur, feat_depth=self._frame_depth, n_inliers=n_inliers,
            stat_vis=stat_vis, stat_found=stat_found,
            imu_interval=self.imu.cut_interval() if self.imu is not None else None,
            gauge_version=self._mapper_gauge_version)
        first = self.async_mapper.n_processed == 0
        inertial = pkg.imu_interval is not None
        if not self.async_mapper.enqueue(pkg, force=inertial, wait=not inertial):
            if pkg.imu_interval is not None:
                self.imu.restore_interval(pkg.imu_interval)
            return False  # saturated: retry on a later frame (Tracking.cc:3196)
        self._stat_vis = self._stat_found = None
        self.frames_since_kf = 0
        self._last_kf_req_ts = float(timestamp)
        self.last_kf_inliers = n_inliers
        if first:
            self._mapper_barrier()
        return True

    # ------------------------------------------------------------------
    # the software pipeline of the fused visual step
    # ------------------------------------------------------------------
    @property
    def _pending(self):
        """The newest in-flight frame, or None."""
        return self._pipeline[-1] if self._pipeline else None

    def settle(self):
        """Consume every frame in flight, so that the state, the pose and the
        trajectory reflect the last processed frame."""
        self._finalize_pending()

    def _finalize_pending(self):
        while self._pipeline:
            self._finalize_one(self._pipeline.popleft())

    def _depth(self) -> int:
        """Inertial sensors run at depth 1: keyframe creation keeps step with
        the IMU's ingestion, or a keyframe's interval would take the lagged
        frames' measurements (Tracking::PreintegrateIMU, Tracking.cc:
        1624-1735)."""
        return 1 if self.imu is not None else max(1, self.cfg.pipeline_depth)

    def _finalize_to_depth(self):
        """Consume the oldest in-flight frames: each whose outcome has
        already reached the host, then as many as keep the pipeline under
        its depth."""
        depth = self._depth()
        while self._pipeline:
            if len(self._pipeline) < depth and not self._is_ready(self._pipeline[0]):
                break
            self._finalize_one(self._pipeline.popleft())

    def _is_ready(self, p) -> bool:
        """The readiness probe: the frame's outcome copy has landed in pinned
        host memory (its CUDA event has completed). Always on the CPU."""
        ev = p.get("ready")
        return ev is None or ev.query()

    def _finalize_one(self, p):
        """Consume one fused step's outcome: the state machine, the motion
        model, the statistics, the keyframe decision, the trajectory
        record."""
        out, feats, timestamp = p["out"], p["feats"], p["ts"]
        # the frame's depth bindings, for its census and its package
        self._frame_ur, self._frame_depth = p["ur"], p["depth"]
        cfg = self.cfg
        ev = p.get("ready")
        if ev is not None:
            ev.synchronize()
            scal = p["scal_host"].tolist()
        else:
            scal = out["scal"].tolist()
        n_inliers, vel_poisoned = scal[0], scal[1]
        self.last_inliers = n_inliers
        self._census = (scal[2], scal[3]) if p["depth"] is not None else None
        if n_inliers < cfg.min_inliers:
            self.lost_count += 1
            self.state = RECENTLY_LOST if self.lost_count < 5 else LOST
            # the prediction stands as the pose estimate
            self.last = {"R": p["R_pred"], "t": p["t_pred"], "feats": feats, "ts": timestamp}
            self.velocity = None
            self._tracked_lms = None
            self._vi_prior = None
            ok = self._try_relocalize(feats)
            if not ok:
                self._new_map_if_lost()
            self._record_frame(timestamp, ok)
            return
        self.lost_count = 0
        self.state = OK
        self.velocity = None if vel_poisoned else (out["Rv"], out["tv"])
        self.last = {"R": out["R"], "t": out["t"], "feats": feats, "ts": timestamp}
        self.frames_since_kf += 1
        self._tracked_lms = out["tracked"]
        self._feat_lm = out["feat_lm"]
        self._add_frame_stats(out["vis32"], out["fnd32"])
        with GLOBAL_TIMER.stage("track.kf_decision"):
            need = self._need_new_keyframe(n_inliers, timestamp)
        if need:
            self._keyframe(feats, timestamp, n_inliers)
        # the step's relative pose holds while the reference keyframe does
        rel = (out["R_rel"], out["t_rel"]) if p["kf_row"] == self.last_kf_row else None
        self._record_frame(timestamp, True, rel)

    def _extract(self, img) -> orb.Features:
        """ORB features of one image, with the keypoints undistorted under
        the rad-tan dist_coeffs of a pinhole camera (`Frame::
        UndistortKeyPoints`); the descriptors stay sampled from the raw
        image, as in the reference."""
        f = orb.extract(img, self.cfg.orb)
        if self._undistort:
            f = dataclasses.replace(
                f, xy=cam.undistort_points_radtan(self.cfg.K, self.cfg.dist_coeffs, f.xy))
        return f

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
        # the frames in flight and the mapper's queue refer to the old rows:
        # drain them; a campaign on the old rows cannot be reconciled
        self._finalize_pending()
        self._mapper_barrier()
        self._stop_gba()
        s = self.map
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
        if self.imu is not None:
            self.imu.kf_buffers = {int(kf_new[r]): b for r, b in self.imu.kf_buffers.items()}
        self._vi_prior = None

        lm_new = lm_new_t.long()
        if self._tracked_lms is not None:
            moved = torch.empty_like(self._tracked_lms)
            moved[lm_new] = self._tracked_lms
            self._tracked_lms = moved
        if self._stat_vis is not None:
            # the buffered statistics follow their landmarks
            moved = [torch.zeros_like(b) for b in self._stats_reduce()]
            for m, b in zip(moved, self._stats_reduce()):
                m[lm_new] = b
            self._stat_vis, self._stat_found = [moved[0]], [moved[1]]
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
            if new_lmax and self._stat_vis is not None:
                vis, fnd = self._stats_reduce()
                pad = torch.zeros((s2.lmax - vis.shape[0],), dtype=vis.dtype, device=self.device)
                self._stat_vis, self._stat_found = [torch.cat([vis, pad])], [torch.cat([fnd, pad])]
        self.map = s2
        self._map_version += 1
        if self.loop_closer is not None:
            if new_kmax:  # the database has kmax rows: a new loop closer
                old = self.loop_closer
                self.attach_loop_closer(old.voc)
                self.loop_closer.n_loops, self.loop_closer.n_merges = old.n_loops, old.n_merges
            self.loop_closer.pending = None
            self.loop_closer.rebuild_db(s2)
        self._mapper_stale = self.async_mapper is not None
        verbose.print_mess(f"atlas compacted: n_kf={n_kf2} n_lm={n_lm2}",
                           verbose.VERBOSITY_NORMAL)

    # ------------------------------------------------------------------
    # relocalization (Tracking::Relocalization, Tracking.cc:3609-3761)
    # ------------------------------------------------------------------
    def _try_relocalize(self, feats) -> bool:
        """Tracking::Relocalization against the keyframe database: for each
        BoW candidate (up to 3 within 0.75 of the best score) the frame is
        matched to the candidate's map points by brute force (ratio 0.85),
        the pose found by PnP RANSAC (minimal sets from a CPU generator
        seeded with the frame count), refined by MLPnP, then by the
        motion-only BA (K2 for a pinhole camera). The three counts are read
        in one host read and gated as the JAX tracker gates them (>= 15
        matches, >= 20 PnP inliers, >= 20 BA inliers). On success the
        tracker is OK at that pose, with no keyframe for kf_max_frames
        frames, in the candidate's map. False without a loop closer."""
        if self.loop_closer is None:
            return False
        cfg = self.cfg
        s = self.map
        L = s.lmax
        db = self.loop_closer.db
        m = self.async_mapper
        if m is not None and m._stream is not None:
            # the mapper thread writes the database on its stream
            cur = torch.cuda.current_stream(self.device)
            cur.wait_stream(m._stream)
            mapper_mod.hand_over(db, cur)
        bow = vocab_mod.sparse_bow(self.loop_closer.voc, feats.descriptors, feats.valid)
        idx, _, ok = recognition.reloc_candidates(db, bow)
        inv_sig2 = self._inv_sigma2(feats.octave)
        for cand, okc in zip(_np(idx), _np(ok)):
            if not okc:
                continue
            cand = int(cand)
            with GLOBAL_TIMER.stage("track.reloc_attempt"):
                lm_c = s.kf_feat_lm[cand]
                midx, _, mok = matching.search_by_brute_force(
                    feats.descriptors, feats.valid, s.kf_feat_desc[cand],
                    (lm_c >= 0) & s.kf_feat_valid[cand], ratio=0.85, max_dist=matching.TH_LOW)
                lm_rows = torch.clamp(lm_c[midx], 0, L - 1).long()
                Xw = s.lm_pos[lm_rows]
                valid = mok & s.lm_valid[lm_rows]
                R, t, inl, n_inl = recognition.pnp_ransac(
                    cfg.kind, cfg.K, feats.xy, Xw, valid,
                    generator=torch.Generator().manual_seed(len(self.trajectory)))
                R, t, inl, _ = recognition.mlpnp_refine(cfg.kind, cfg.K, R, t, feats.xy, Xw,
                                                       inv_sig2, valid)
                R, t, _, n2 = track_mod.pose_optimize(cfg.kind, cfg.K, R, t, feats.xy, Xw,
                                                      inv_sig2, inl)
                n_match, n_pnp, n_ba = torch.stack([mok.sum(), n_inl.to(torch.int64),
                                                    n2.to(torch.int64)]).tolist()
            if n_match < 15 or n_pnp < 20 or n_ba < 20:
                continue
            self.last = {"R": R, "t": t, "feats": feats,
                         "ts": self.last["ts"] if self.last else 0.0}
            self.state = OK
            self.lost_count = 0
            self._last_reloc_frame = len(self.trajectory)
            self.velocity = None
            self._tracked_lms = None
            cand_map = int(s.kf_map_id[cand])
            if cand_map != int(s.active_map):
                self._mapper_barrier()
                self.map = dataclasses.replace(
                    self.map, active_map=torch.tensor(cand_map, dtype=torch.int32,
                                                      device=self.device))
                self._map_version += 1
                self._mapper_stale = self.async_mapper is not None
            return True
        return False

    # ------------------------------------------------------------------
    def _to_device(self, img):
        return torch.as_tensor(np.asarray(img) if not torch.is_tensor(img) else img,
                               dtype=torch.float32, device=self.device)

    def process(self, img, timestamp: float, img_right=None, depth_map=None, imu=None):
        """Track one frame ([H, W] image, anything torch.as_tensor reads)
        taken at `timestamp` seconds: a stereo sensor passes the right image
        of the rectified pair as img_right, an RGB-D sensor its [H, W] depth
        map as depth_map (System::TrackStereo / TrackRGBD routing,
        `System.cc:244,328`), an inertial sensor the [M, 7] rows (t, gx, gy,
        gz, ax, ay, az) measured since the previous frame as imu
        (GrabImuData, `Tracking.cc:1618`)."""
        with GLOBAL_TIMER.stage("track.finalize"):
            self._finalize_to_depth()
        with GLOBAL_TIMER.stage("track.adopt"):
            self._adopt_commits()
            self._maybe_compact()
        if self.imu is not None:
            self.imu.ingest(None if imu is None else np.asarray(imu))
        # timestamp sanity (Tracking.cc:1818-1855): a backwards step, or a
        # gap over 1 s on an inertial sensor (preintegration continuity),
        # stores the active map and restarts in a fresh one; a gap over 1 s
        # drops a visual tracker's motion model
        if self.last is not None and self.state != NOT_INITIALIZED:
            prev_ts = self._pipeline[-1]["ts"] if self._pipeline else float(self.last["ts"])
            gap = timestamp - prev_ts
            if gap < -1e-9 or (self.imu is not None and gap > 1.0):
                self._timestamp_jump()
            elif gap > 1.0:
                self.velocity = None
        stereo_pair = self.base_sensor == "stereo"
        with GLOBAL_TIMER.stage("track.img_xfer"):
            img = self._to_device(img)
            if stereo_pair:
                img_right = self._to_device(img_right)
            elif self.base_sensor == "rgbd":
                depth_map = self._to_device(depth_map)
        with GLOBAL_TIMER.stage("orb_extraction"):
            # the two extractions run one after the other, as in the JAX
            # tracker's pair program (tracker.py:66-73)
            feats = self._extract(img)
            feats_r = self._extract(img_right) if stereo_pair else None
        ur = depth = None
        self._frame_feats_r = None
        if stereo_pair and self.cfg.stereo_fisheye:
            # the right features carry their own edges through the pose BA
            self._frame_feats_r = feats_r
            cfg = self.cfg
            with GLOBAL_TIMER.stage("track.stereo_depth"):
                depth, _ = stereo.match_stereo_fisheye(
                    cfg.kind, cfg.K, cfg.K_right, cfg.R_rl, cfg.t_rl,
                    feats.xy, feats.descriptors, feats.valid,
                    feats_r.xy, feats_r.descriptors, feats_r.valid)
                # the triangulated depth bound as an inverse-depth stereo
                # measurement, ur = u - bf/z, as the JAX tracker binds it
                # (tracker.py:812-826)
                if cfg.bf > 0:
                    ur = torch.where(depth > cfg.min_depth,
                                     feats.xy[:, 0] - cfg.bf / torch.clamp(depth, min=1e-6),
                                     -1.0)
        elif stereo_pair:
            with GLOBAL_TIMER.stage("track.stereo_depth"):
                ur, depth, _ = stereo.match_stereo(
                    feats.xy, feats.octave, feats.descriptors, feats.valid,
                    feats_r.xy, feats_r.octave, feats_r.descriptors, feats_r.valid,
                    img, img_right, self.scale_factors, self.cfg.bf, self.cfg.min_depth)
        elif self.base_sensor == "rgbd":
            with GLOBAL_TIMER.stage("track.stereo_depth"):
                ur, depth, _ = stereo.depth_from_rgbd(feats.xy, depth_map, self.cfg.bf,
                                                      self.cfg.depth_factor)
        self._frame_ur, self._frame_depth = ur, depth
        rel = None
        if self.state == NOT_INITIALIZED:
            if self.base_sensor == "mono":
                ok = self._try_initialize(feats, timestamp)
            else:
                ok = self._initialize_with_depth(feats, ur, depth, timestamp)
        else:
            ok, rel = self._track_frame(feats, timestamp)
        if ok is not PENDING:
            self._record_frame(timestamp, ok, rel)

    def _timestamp_jump(self):
        """Timestamp discontinuity: store the active map and continue in a
        fresh one (`Tracking.cc:1818-1855` -> CreateMapInAtlas, :2662)."""
        self._finalize_pending()
        verbose.print_mess("Timestamp discontinuity: creating new map in Atlas",
                           verbose.VERBOSITY_NORMAL)
        self._mapper_barrier()
        self.map = atlas_ops.create_map(self.map)
        self._restart_in_fresh_map()

    def _reset_active_map(self):
        """Discard the active map and restart (Tracking::ResetActiveMap,
        `Tracking.cc:3840`); the keyframe database forgets its keyframes."""
        self._finalize_pending()
        self._mapper_barrier()
        self._stop_gba()
        self.map = atlas_ops.reset_active_map(self.map)
        if self.loop_closer is not None:
            self.loop_closer.pending = None
            self.loop_closer.rebuild_db(self.map)
        self._restart_in_fresh_map()

    def _restart_in_fresh_map(self):
        self._pipeline.clear()  # frames in flight belong to the old map
        self._map_version += 1
        self._mapper_stale = True
        self.state = NOT_INITIALIZED
        self.init_ref = None
        self.last = None
        self.velocity = None
        self.last_kf_row = -1
        self.frames_since_kf = 0
        self.lost_count = 0
        self._tracked_lms = None
        self._vi_prior = None
        if self.imu is not None:
            # the biases survive as priors of the next initialization
            imu = self.imu
            imu.initialized = imu.bad = False  # the reset services mbBadImu
            imu.first_kf_ts = imu.init_ts = None
            imu.viba_stage, imu.tinit = 0, 0.0
            imu._cur = ([], [], [], [])

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
        ref_ts = None if self.init_ref is None else self.init_ref[1]
        res = initialize_monocular(self.cfg, self.map, self.init_ref, feats, timestamp,
                                   seed=len(self.trajectory))
        self.init_ref = res.init_ref
        if not res.success:
            return False
        if self.imu is not None:
            # keyframe 1's interval is exactly (ref_ts, timestamp]: what was
            # recorded before the reference frame precedes the map
            self.imu.trim_before(ref_ts)
            self.imu.first_kf_ts = ref_ts
            self.imu.commit_keyframe(res.kf1, timestamp)
        self.map = res.map
        self.state = OK
        self.last = {"R": res.R, "t": res.t, "feats": feats, "ts": timestamp}
        self.velocity = None
        self.last_kf_row = res.kf1
        self.last_kf_inliers = res.n_landmarks
        self.frames_since_kf = 0
        self._map_version += 1
        self._mapper_stale = self.async_mapper is not None
        return True

    # ------------------------------------------------------------------
    # stereo / RGB-D initialization (StereoInitialization, Tracking.cc:2335)
    # ------------------------------------------------------------------
    def _initialize_with_depth(self, feats, ur, depth, timestamp) -> bool:
        """One keyframe at the origin and a landmark unprojected from every
        keypoint with a measured depth (`Tracking.cc:2365-2395`), once the
        frame has 100 keypoints and 50 depths (the reference asks for 500
        keypoints at its full budget, :2337). One host read of both counts."""
        cfg = self.cfg
        has_depth = (depth > cfg.min_depth) & feats.valid
        n_kp, n_depth = (int(v) for v in torch.stack([feats.valid.sum(), has_depth.sum()]).tolist())
        if n_kp < 100 or n_depth < 50:
            return False
        if self.imu is not None and not self._excited():
            return False
        dev = self.device
        f32 = dict(dtype=torch.float32, device=dev)
        s, kf0 = atlas_ops.add_keyframe(
            self.map, torch.eye(3, **f32), torch.zeros(3, **f32), timestamp,
            feats.xy, feats.octave, feats.angle, feats.descriptors, feats.valid,
            feat_ur=ur, feat_depth=depth)
        kf0 = int(kf0)
        X = cam.unproject(cfg.kind, cfg.K, feats.xy) * depth[:, None]
        F = X.shape[0]
        col = torch.full((F,), kf0, dtype=torch.int32, device=dev)
        s, _ = atlas_ops.add_landmarks(s, X, feats.descriptors, col, has_depth, col,
                                       torch.arange(F, dtype=torch.int32, device=dev))
        self.map = atlas_state.update_landmark_stats(s)
        if self.imu is not None:
            # the intervals start at this keyframe; the backlog is dropped
            self.imu.trim_before(timestamp)
            self.imu.first_kf_ts = timestamp
        self.state = OK
        self.last = {"R": torch.eye(3, **f32), "t": torch.zeros(3, **f32), "feats": feats,
                     "ts": timestamp}
        self.velocity = None
        self.last_kf_row = kf0
        self.last_kf_inliers = n_depth
        self.frames_since_kf = 0
        self._map_version += 1
        self._mapper_stale = self.async_mapper is not None
        return True

    def _excited(self) -> bool:
        """Stereo / RGB-D inertial: the map is anchored only once the mean
        acceleration of this frame's window differs from the previous
        frame's by at least 0.5 m/s^2 (a static start leaves gravity and
        the biases unobservable, `Tracking.cc:2340-2350`). One host read."""
        pint = self.imu.preint_frame()
        avg_a = None if pint is None else pint.avgA.cpu().numpy()
        last_a, self._last_avg_a = self._last_avg_a, avg_a
        if avg_a is None or last_a is None:
            return False
        if float(np.linalg.norm(avg_a - last_a)) < 0.5:
            verbose.print_mess("not enough acceleration", verbose.VERBOSITY_NORMAL)
            return False
        return True

    # ------------------------------------------------------------------
    # per-frame tracking (TrackWithMotionModel + TrackLocalMap)
    # ------------------------------------------------------------------
    def _track_frame(self, feats, timestamp):
        """Track one frame. Returns (ok, rel), rel being the pose relative to
        the reference keyframe computed in the step (None when that
        keyframe changed), or (PENDING, None) for the fused visual step,
        whose outcome the software pipeline consumes and records."""
        cfg = self.cfg
        imu_active = self.imu is not None and self.imu.initialized
        loc_mode = self.mapping_paused and self._frame_depth is not None
        # the host-orchestrated paths (inertial, localization, lost) read
        # the host state: consume the frames in flight first
        if self._pipeline and (imu_active or loc_mode
                               or self.state in (RECENTLY_LOST, LOST)):
            cur = (self._frame_ur, self._frame_depth)
            self._finalize_pending()
            self._frame_ur, self._frame_depth = cur
            imu_active = self.imu is not None and self.imu.initialized
        s = self.map
        # a visual tracker that is lost goes straight to relocalization
        # (Tracking.cc:1981-2012); an initialized IMU keeps predicting
        if self.state in (RECENTLY_LOST, LOST) and not imu_active:
            if self._try_relocalize(feats):
                self.last["ts"] = timestamp
                return True, None
            self.lost_count += 1
            if self.lost_count >= 5:
                self.state = LOST
            self.last["ts"] = timestamp
            self._new_map_if_lost()
            return False, None

        # the IMU's prediction (PredictStateIMU, Tracking.cc:1738), else the
        # constant-velocity motion model (:2862-2877)
        pred = self._imu_prediction() if imu_active else None
        if loc_mode:
            return self._track_frame_localization(feats, timestamp, s, pred), None
        if imu_active:
            return self._track_frame_inertial(feats, timestamp, s, pred), None

        # the fused visual step; with a frame in flight its pose, velocity
        # and tracked mask feed this step on the device
        chain = self._pipeline[-1]["out"] if self._pipeline else None
        with GLOBAL_TIMER.stage("track.fused_step"):
            out = track_frame(
                cfg, s, feats, self.last_kf_row, self.last["R"], self.last["t"],
                velocity=self.velocity, tracked=self._tracked_lms,
                last_inliers=self.last_inliers, in_map=self._local_map_mask(s),
                frame_ur=self._frame_ur, frame_depth=self._frame_depth,
                th_depth_m=self.th_depth_m, feats_r=self._frame_feats_r, chain=chain)
        p = dict(out=out, feats=feats, ts=timestamp, R_pred=out["R_pred"], t_pred=out["t_pred"],
                 ur=self._frame_ur, depth=self._frame_depth, kf_row=self.last_kf_row)
        if self._depth() == 1:
            self._finalize_one(p)
            return PENDING, None
        if self.device.type == "cuda":
            # the readiness probe: the outcome scalars copied to pinned host
            # memory behind the step, and an event after the copy
            scal = out["scal"]
            p["scal_host"] = torch.empty(scal.shape, dtype=scal.dtype, pin_memory=True)
            p["scal_host"].copy_(scal, non_blocking=True)
            p["ready"] = torch.cuda.Event()
            p["ready"].record(torch.cuda.current_stream(self.device))
        self._pipeline.append(p)
        return PENDING, None

    # ------------------------------------------------------------------
    # inertial tracking (Tracker._track_frame's IMU branch)
    # ------------------------------------------------------------------
    def _imu_prediction(self):
        """(R, t) Tcw predicted from the last pose, velocity and biases over
        this frame's window, or None without one (the motion model then
        predicts). Sets the IMU velocity to the predicted one."""
        imu = self.imu
        with GLOBAL_TIMER.stage("track.imu_predict"):
            pint = imu.preint_frame()
            if pint is None:
                return None
            Rb, tb = vi_tracker.cam_to_body(self.last["R"], self.last["t"], imu.Rbc, imu.tbc)
            Rb2, tb2, v2 = preint_mod.predict_state(pint, Rb, tb, imu.vel, imu.bg, imu.ba)
            imu.vel = v2
            return vi_tracker.body_to_cam(Rb2, tb2, imu.Rbc, imu.tbc)

    def _track_frame_inertial(self, feats, timestamp, s, pred) -> bool:
        """An IMU-initialized frame: the fused visual step (K1, K2) from the
        IMU's prediction warm-starts the pose, the pose-inertial
        optimization re-solves it with the preintegration, bias and prior
        terms (PoseInertialOptimizationLast{KeyFrame,Frame}, Tracking.cc:
        2970-2992), one host read of the outcome scalars. A non-finite
        inertial solve falls back to the visual pose."""
        cfg = self.cfg
        imu = self.imu
        R_last, t_last = self.last["R"], self.last["t"]
        with GLOBAL_TIMER.stage("track.fused_step"):
            out = track_frame(
                cfg, s, feats, self.last_kf_row, R_last, t_last, velocity=self.velocity,
                tracked=self._tracked_lms, last_inliers=self.last_inliers,
                in_map=self._local_map_mask(s), frame_ur=self._frame_ur,
                frame_depth=self._frame_depth, th_depth_m=self.th_depth_m,
                feats_r=self._frame_feats_r, pred=pred)
        with GLOBAL_TIMER.stage("track.vi_refine"):
            vi = self._vi_refine_fused(s, feats, out)
        with GLOBAL_TIMER.stage("track.vi_fetch"):
            scal = (out["scal"] if vi is None else vi[2]).tolist()
        n_inliers = scal[0]
        n_vi = scal[4] if vi is not None else -1
        if n_vi >= 0:
            cur, _, _, H15 = vi
            n_inliers = n_vi
            R2, t2 = vi_tracker.body_to_cam(cur["R"], cur["t"], imu.Rbc, imu.tbc)
            imu.vel, imu.bg, imu.ba = cur["v"], cur["bg"], cur["ba"]
            self._vi_prior = {"state": cur, "H": H15, "version": self._map_version}
        else:
            R2, t2 = out["R"], out["t"]
        self.last_inliers = n_inliers
        self._census = (scal[2], scal[3]) if self._frame_depth is not None else None
        if n_inliers < cfg.min_inliers:
            self.lost_count += 1
            self.state = RECENTLY_LOST if self.lost_count < 5 else LOST
            self.last = {"R": out["R_pred"], "t": out["t_pred"], "feats": feats,
                         "ts": timestamp}
            self.velocity = None
            self._tracked_lms = None
            self._vi_prior = None
            ok = self._try_relocalize(feats)
            if not ok:
                self._new_map_if_lost()
            return ok
        self.lost_count = 0
        self.state = OK
        # motion model: velocity = T_cur T_last^-1 (Tracking.cc:2207)
        Rv, tv = lie.se3_mul(R2, t2, *lie.se3_inv(R_last, t_last))
        self.velocity = (lie.normalize_rotation(Rv), tv)
        self.last = {"R": R2, "t": t2, "feats": feats, "ts": timestamp}
        self.frames_since_kf += 1
        self._tracked_lms = out["tracked"]
        self._feat_lm = out["feat_lm"]
        self._add_frame_stats(out["vis32"], out["fnd32"])
        with GLOBAL_TIMER.stage("track.kf_decision"):
            need = self._need_new_keyframe(n_inliers, timestamp)
        if need:
            self._keyframe(feats, timestamp, n_inliers)
        return True

    def _vi_pose_optimize(self, s, uv, ur, Xw, inv_sig2, valid, R0, t0):
        """PoseInertialOptimizationLast{KeyFrame,Frame} dispatch
        (Tracking.cc:2970-2992): after a map update, against the last
        keyframe's fixed state over the window since it; otherwise against
        the previous frame through the marginal ConstraintPoseImu prior.
        From the pose (R0, t0) Tcw and the IMU's velocity and biases.
        Returns the device outputs of pose_inertial_optimize, or None
        without a window."""
        imu = self.imu
        cfg = self.cfg
        prior = self._vi_prior
        use_prior = prior is not None and prior["version"] == self._map_version
        if use_prior:
            if imu.frame_dt() <= 0.0:
                return None
            pint = imu.preint_frame()
            prev = prior["state"]
        else:
            if self.last_kf_row < 0 or imu.since_kf_dt() <= 0.0:
                return None
            kf = self.last_kf_row
            bg_kf, ba_kf = s.kf_bg[kf], s.kf_ba[kf]
            pint = imu.preint_since_kf(bg=bg_kf, ba=ba_kf)
            Rb, tb = vi_tracker.cam_to_body(s.kf_R[kf], s.kf_t[kf], imu.Rbc, imu.tbc)
            prev = {"R": Rb, "t": tb, "v": s.kf_vel[kf], "bg": bg_kf, "ba": ba_kf}
        if pint is None:
            return None
        d, info = factors.preint_edge_data(pint)
        Rb0, tb0 = vi_tracker.cam_to_body(R0, t0, imu.Rbc, imu.tbc)
        cur0 = {"R": Rb0, "t": tb0, "v": imu.vel, "bg": imu.bg, "ba": imu.ba}
        kwargs = {}
        if use_prior:
            kwargs = dict(prior_data={"R0": prev["R"], "t0": prev["t"], "v0": prev["v"],
                                      "bg0p": prev["bg"], "ba0p": prev["ba"]},
                          prior_H=prior["H"], free_prev=True)
        return vi_pose_opt.pose_inertial_optimize(
            cfg.kind, cfg.K, cfg.bf, imu.Rbc, imu.tbc, prev, cur0, d, info,
            factors.rw_info6(pint), uv, ur, Xw, inv_sig2, valid, **kwargs)

    def _vi_refine_fused(self, s, feats, out):
        """The pose-inertial refinement chained on the fused visual step's
        device outputs over its per-feature edges (uv = keypoint, Xw = its
        bound landmark). Returns (cur_state, inlier [F], scal5, H15) with
        scal5 = [n_visual, vel_poisoned, census tracked, census untracked,
        n_vi], n_vi = -1 for a non-finite solve; or None without a window.
        Reads nothing back to the host."""
        feat_lm = out["feat_lm"]
        okf = (feat_lm >= 0) & feats.valid
        Xw = s.lm_pos[torch.clamp(feat_lm, 0, s.lmax - 1).long()]
        if self._frame_ur is not None:
            ur = torch.where(okf, self._frame_ur, -1.0)
        else:
            ur = -torch.ones((feats.xy.shape[0],), dtype=torch.float32, device=self.device)
        vi = self._vi_pose_optimize(s, feats.xy, ur, Xw, self._inv_sigma2(feats.octave), okf,
                                    out["R"], out["t"])
        if vi is None:
            return None
        cur, inlier_f, n, H15 = vi
        finite = torch.isfinite(cur["t"]).all() & torch.isfinite(cur["v"]).all()
        n_vi = torch.where(finite, n.to(torch.int64), -1)
        scal5 = torch.cat([out["scal"].to(torch.int64), n_vi.reshape(1)])
        return cur, inlier_f, scal5, H15

    def _match_and_optimize(self, s, feats, R0, t0, lm_mask, radius):
        """Projection search and motion-only BA of the map against the frame
        (`Tracker._match_and_optimize` without the statistics): the frame's
        stereo rows where it has them. Returns (R normalized, t)."""
        cfg = self.cfg
        idx, ok, _, _, _ = track_mod.match_local_map(
            cfg.kind, cfg.K, R0, t0, s.lm_pos, s.lm_desc, lm_mask,
            s.lm_max_dist, s.lm_min_dist, s.lm_normal,
            feats.xy, feats.descriptors, feats.octave, feats.valid,
            radius, self.scale_factors, img_wh=(float(cfg.img_wh[0]), float(cfg.img_wh[1])))
        idx = idx.long()
        uv = feats.xy[idx]
        inv_sig2 = self._inv_sigma2(feats.octave[idx])
        if self._frame_ur is None:
            R, t, _, _ = track_mod.pose_optimize(cfg.kind, cfg.K, R0, t0, uv, s.lm_pos,
                                                 inv_sig2, ok)
        else:
            ur_edge = torch.where(ok, self._frame_ur[idx], -1.0)
            R, t, _, _ = track_mod.pose_optimize_stereo(
                cfg.kind, cfg.K, cfg.bf, R0, t0, uv, ur_edge, s.lm_pos, inv_sig2, ok)
        return lie.normalize_rotation(R), t

    def _inv_sigma2(self, octave):
        n_levels = self.scale_factors.shape[0]
        return 1.0 / self.scale_factors[torch.clamp(octave, 0, n_levels - 1).long()] ** 2

    def _track_frame_localization(self, feats, timestamp, s, pred=None) -> bool:
        """Localization-only mode with a depth sensor (mbOnlyTracking,
        `Tracker._track_frame_localization`): the pose against the frozen
        map (a coarse match and pose BA at the predicted pose, then a fine
        match) plus the previous frame's visual-odometry points, unprojected
        from its depths (`Tracking::UpdateLastFrame`, `Tracking.cc:
        2788-2851`), in one pose BA over the map's rows and the VO rows. The
        VO points match through K1 like landmarks without a distance range
        or normal, and live one frame. Tracking health is judged on all
        inliers, as the JAX tracker does (it computes the map inliers but
        does not use them). No keyframe is made and the map is not
        touched. `pred` is the IMU's prediction, where there is one."""
        cfg = self.cfg
        R_last, t_last = self.last["R"], self.last["t"]
        if pred is not None:
            R_pred, t_pred = pred
        elif self.velocity is not None:
            R_pred, t_pred = lie.se3_mul(self.velocity[0], self.velocity[1], R_last, t_last)
        else:
            R_pred, t_pred = R_last, t_last
        in_map = self._local_map_mask(s)
        img_wh = (float(cfg.img_wh[0]), float(cfg.img_wh[1]))
        with GLOBAL_TIMER.stage("track.localization"):
            R1, t1 = self._match_and_optimize(s, feats, R_pred, t_pred, in_map,
                                              cfg.match_radius_coarse)
            idx, ok, _, _, _ = track_mod.match_local_map(
                cfg.kind, cfg.K, R1, t1, s.lm_pos, s.lm_desc, in_map,
                s.lm_max_dist, s.lm_min_dist, s.lm_normal,
                feats.xy, feats.descriptors, feats.octave, feats.valid,
                cfg.match_radius_fine, self.scale_factors, img_wh=img_wh)
            idx = idx.long()
            uv_all, X_all = feats.xy[idx], s.lm_pos
            inv_all, ok_all = self._inv_sigma2(feats.octave[idx]), ok
            if self._vo_buffer is not None:
                vo_pos, vo_desc, vo_valid = self._vo_buffer
                Fv = vo_pos.shape[0]
                f32 = dict(dtype=torch.float32, device=self.device)
                vidx, vok, _, _, _ = track_mod.match_local_map(
                    cfg.kind, cfg.K, R1, t1, vo_pos, vo_desc, vo_valid,
                    torch.full((Fv,), 1e6, **f32), torch.zeros((Fv,), **f32),
                    torch.zeros((Fv, 3), **f32),
                    feats.xy, feats.descriptors, feats.octave, feats.valid,
                    cfg.match_radius_fine, self.scale_factors, img_wh=img_wh)
                vidx = vidx.long()
                uv_all = torch.cat([uv_all, feats.xy[vidx]])
                X_all = torch.cat([X_all, vo_pos])
                inv_all = torch.cat([inv_all, self._inv_sigma2(feats.octave[vidx])])
                ok_all = torch.cat([ok, vok])
            R2, t2, inlier, n2 = track_mod.pose_optimize(cfg.kind, cfg.K, R1, t1, uv_all,
                                                         X_all, inv_all, ok_all)
            R2 = lie.normalize_rotation(R2)
            # the VO buffer for the next frame, from this one's depths
            depth = self._frame_depth
            fresh = feats.valid & (depth > cfg.min_depth) & (depth < self.th_depth_m)
            Xc = cam.unproject(cfg.kind, cfg.K, feats.xy) * depth[:, None]
            Rw, tw = lie.se3_inv(R2, t2)
            self._vo_buffer = (lie.se3_apply(Rw, tw, Xc), feats.descriptors, fresh)
            n_inliers = int(n2)
        self.last_inliers = n_inliers
        if n_inliers < cfg.min_inliers:
            self.lost_count += 1
            self.state = RECENTLY_LOST if self.lost_count < 5 else LOST
            self.last = {"R": R_pred, "t": t_pred, "feats": feats, "ts": timestamp}
            self.velocity = None
            self._tracked_lms = None
            return self._try_relocalize(feats)
        self.lost_count = 0
        self.state = OK
        Rl_inv, tl_inv = lie.se3_inv(R_last, t_last)
        Rv, tv = lie.se3_mul(R2, t2, Rl_inv, tl_inv)
        self.velocity = (lie.normalize_rotation(Rv), tv)
        self.last = {"R": R2, "t": t2, "feats": feats, "ts": timestamp}
        self._tracked_lms = inlier[:s.lmax]
        return True

    def _new_map_if_lost(self):
        """A persistent loss of a mature map starts a new map in the Atlas
        (Tracking::CreateMapInAtlas, `Tracking.cc:2014-2032`)."""
        if self.state == LOST and self._n_kf_cache() >= 10:
            self._mapper_barrier()
            self.map = atlas_ops.create_map(self.map)
            self._map_version += 1
            self._mapper_stale = self.async_mapper is not None
            self.state = NOT_INITIALIZED
            self.init_ref = None
            self.last_kf_row = -1

    def _last_kf_ts(self) -> float:
        """Host timestamp of the reference keyframe, cached per map version."""
        if self.last_kf_row < 0:
            return -1e9
        return self._cached("kf_ts", (self._map_version, self.last_kf_row),
                            lambda: float(self.map.kf_timestamp[self.last_kf_row]))

    def _need_new_keyframe(self, n_inliers: int, timestamp: float) -> bool:
        """NeedNewKeyFrame (`Tracking.cc:3064-3187`): nothing while mapping
        is paused; before the IMU is initialized an inertial sensor inserts
        every 0.25 s after the last keyframe, queued ones included
        (`:3066-3074`); c1a (max frames), c1b (min frames and the mapper
        idle; synchronous mapping is always idle), c1c for a
        visual depth sensor (weak tracking, or fewer than 100 tracked and
        more than 70 untracked close points, `:3106-3128`), c2 (tracked
        ratio against the reference keyframe's map points observed >= 3
        times: 0.9 mono, 0.75 / 0.9 mono-inertial above / below 350
        inliers, else kf_tracked_ratio, 0.4 below two keyframes; the
        close-point deficit; or the kf_tracked_ratio decay against the
        inliers at the last insertion), the cadence ceiling (at most
        kf_max_frames frames without a keyframe), and for an inertial
        sensor c3 (0.5 s since the last keyframe) and, mono-inertial, c4
        (thin tracking: between min_inliers and 75 inliers). With the mapper
        busy, an inertial keyframe is still requested (the queue absorbs
        it), a monocular one not; a stereo / RGB-D one is requested too and
        its request waits for the mapper to be idle (`_request_keyframe`):
        the JAX tracker asks only while fewer than 3 packages wait
        (Tracking.cc:3196-3214), which on this port lets the mapper fall
        behind and starves the map (ROADMAP Queue 3)."""
        cfg = self.cfg
        if self.mapping_paused:
            return False
        # the adopted commit's keyframe lags the queue: count the queued
        # ones too, or a busy mapper is asked for a keyframe every frame
        last_kf_ts = max(self._last_kf_ts(), self._last_kf_req_ts)
        if self.imu is not None and not self.imu.initialized:
            return timestamp - last_kf_ts >= 0.25
        n_kfs = self._n_kf_cache()
        # relocalization cooldown (Tracking.cc:3091-3094)
        if (len(self.trajectory) < self._last_reloc_frame + cfg.kf_max_frames
                and n_kfs > cfg.kf_max_frames):
            return False
        idle = (not self.cfg.async_mapping or self.async_mapper is None
                or self.async_mapper.idle())
        need_close = False
        depth_sensor = self.base_sensor != "mono"
        if depth_sensor and self._census is not None:
            n_tracked_close, n_untracked_close = self._census
            need_close = n_tracked_close < 100 and n_untracked_close > 70
        if self.last_kf_row >= 0:
            # nMinObs = 3 (2 for tiny maps, Tracking.cc:3097-3099)
            min_obs = 3 if n_kfs > 2 else min(n_kfs, 2)
            ref_matches = self._cached(
                "ref_matches", (self._map_version, self.last_kf_row, min_obs),
                lambda: max(int(_ref_tracked_map_points(self.map, self.last_kf_row,
                                                        min_obs)), 1))
        else:
            ref_matches = max(self.last_kf_inliers, 1)
        if cfg.sensor == "mono":
            th_ratio = 0.9  # Tracking.cc:3144
        elif cfg.sensor == "mono-imu":
            th_ratio = 0.75 if n_inliers > 350 else 0.90
        else:
            th_ratio = cfg.kf_tracked_ratio if n_kfs >= 2 else 0.4
        c1a = self.frames_since_kf >= cfg.kf_max_frames
        c1b = self.frames_since_kf >= cfg.kf_min_frames and idle
        c1c = (depth_sensor and self.imu is None
               and (n_inliers < 0.25 * ref_matches or need_close))
        c2 = ((n_inliers < th_ratio * ref_matches or need_close
               or n_inliers < cfg.kf_tracked_ratio * max(self.last_kf_inliers, 1))
              and n_inliers > cfg.min_inliers)
        c_ceiling = c1a and n_inliers > cfg.min_inliers
        c3 = self.imu is not None and timestamp - last_kf_ts >= 0.5
        c4 = (cfg.sensor == "mono-imu"
              and (cfg.min_inliers < n_inliers < 75 or self.state == RECENTLY_LOST))
        if not (((c1a or c1b or c1c) and c2) or c_ceiling or c3 or c4):
            return False
        if idle or self.imu is not None:
            return True
        return self.base_sensor != "mono"

    # ------------------------------------------------------------------
    def _insert_keyframe(self, feats, timestamp, n_inliers: int):
        """Keyframe insertion and the whole local-mapping stack on this
        frame (the JAX tracker's visual path with async_mapping=False):
        map_stage_pre -> local BA -> map_stage_post, then the loop closer.
        A depth sensor's keyframe carries the frame's right coordinates and
        depths."""
        cfg = self.cfg
        if self._n_kf_cache() >= cfg.kmax - 1:
            self._maybe_compact()
        if self._n_kf_cache() >= cfg.kmax - 1:
            return
        pkg = pipeline.KFPackage(
            R=self.last["R"], t=self.last["t"], timestamp=timestamp,
            feat_xy=feats.xy, feat_octave=feats.octave, feat_angle=feats.angle,
            feat_desc=feats.descriptors, feat_valid=feats.valid, feat_lm=self._feat_lm,
            feat_ur=self._frame_ur, feat_depth=self._frame_depth, n_inliers=n_inliers,
        )
        if self.imu is not None:
            self._insert_keyframe_inertial(pkg, timestamp, n_inliers)
            return
        dev = self.device
        with GLOBAL_TIMER.stage_sync("map.pre", dev):
            s, kf, ba_rows, n_fixed = pipeline.run_pre_stage(
                self.map, pkg, cfg, self.base_sensor, self.last_kf_row, self.scale_factors)
        with GLOBAL_TIMER.stage_sync("map.local_ba", dev):
            s = pipeline.run_visual_ba(s, cfg, self.scale_factors, ba_rows, n_fixed,
                                       self.base_sensor)
        with GLOBAL_TIMER.stage_sync("map.culling", dev):
            s = pipeline.map_stage_post(s, ba_rows, cfg.local_window + 4)
        self.map = s
        self._finish_keyframe(kf, n_inliers)

    def _insert_keyframe_inertial(self, pkg, timestamp, n_inliers: int):
        """The inertial sensors' synchronous keyframe (`Tracker.
        _insert_keyframe`'s IMU path, the stage helpers of
        mapping/pipeline.py): insertion, the interval commit, the bad-IMU
        check, triangulation, the fuse over the last 4 keyframes (K1), the
        local BA (visual-inertial once the IMU is initialized), culling,
        then the inertial initialization or the staged refinement."""
        cfg = self.cfg
        imu = self.imu
        dev = self.device
        sf = self.scale_factors
        with GLOBAL_TIMER.stage_sync("map.insert", dev):
            s, kf = pipeline.insert_keyframe_pkg(self.map, pkg, cfg, self.base_sensor,
                                                 self.last_kf_row)
            imu.commit_keyframe(kf, timestamp)
        if imu.initialized and imu.viba_stage < 2 and self._bad_imu(s, kf, timestamp):
            return
        with GLOBAL_TIMER.stage_sync("map.triangulate", dev):
            s = pipeline.triangulate_mono(s, kf, cfg, sf, self.last_kf_row)
        with GLOBAL_TIMER.stage_sync("map.fuse", dev):
            s = pipeline.fuse_recent(s, cfg, sf)
        rows, n_fixed = pipeline.ba_window(s, cfg)
        ran_vi_ba = False
        if imu.initialized:
            with GLOBAL_TIMER.stage_sync("map.vi_local_ba", dev):
                self.map = s
                ran_vi_ba = vi_tracker.run_vi_local_ba(self, rows, n_fixed)
                s = self.map
        if not ran_vi_ba:
            with GLOBAL_TIMER.stage_sync("map.local_ba", dev):
                s = pipeline.run_visual_ba(s, cfg, sf, rows, n_fixed, self.base_sensor)
        with GLOBAL_TIMER.stage_sync("map.culling", dev):
            self.map = pipeline.cull(s, cfg, rows, use_imu=True)
            if imu.initialized and int(self.map.n_kf) > cfg.local_window + 4:
                vi_tracker.cull_keyframes_inertial(self, rows[:cfg.local_window + 4])
        # the inertial initialization once the chain allows it, then the
        # staged refinement (LocalMapping.cc:181-242)
        if not imu.initialized:
            with GLOBAL_TIMER.stage_sync("map.imu_init", dev):
                moved = vi_tracker.try_initialize_imu(self)
        else:
            with GLOBAL_TIMER.stage_sync("map.imu_refine", dev):
                moved = vi_tracker.try_refine_imu(self)
        if moved:
            self.last["R"], self.last["t"] = self.map.kf_R[kf], self.map.kf_t[kf]
            self._vi_prior = None  # gauge changed
        self._finish_keyframe(kf, n_inliers)

    def _bad_imu(self, s, kf: int, timestamp: float) -> bool:
        """The bad-IMU check (LocalMapping.cc:130-146) before inertial BA2:
        the init time accumulates only while the last three keyframes'
        camera centres move more than 0.05; under 0.02 of motion within
        10 s of init time the initialization was under-excited and the
        active map is reset. One host read of the three keyframes."""
        imu = self.imu
        prev = int(s.kf_prev[kf])
        pprev = int(s.kf_prev[prev]) if prev >= 0 else -1
        if prev < 0 or pprev < 0:
            return False
        rows = torch.tensor([kf, prev, pprev], device=s.device)
        R, t, ts = (a.double().cpu().numpy() for a in (s.kf_R[rows], s.kf_t[rows],
                                                        s.kf_timestamp[rows]))
        cs = [-(R[i].T @ t[i]) for i in range(3)]
        dist = np.linalg.norm(cs[0] - cs[1]) + np.linalg.norm(cs[1] - cs[2])
        if dist > 0.05:
            imu.tinit += timestamp - float(ts[1])
        if imu.tinit < 10.0 and dist < 0.02:
            verbose.print_mess("Not enough motion for initializing. Reseting...",
                               verbose.VERBOSITY_NORMAL)
            imu.bad = True
            self.debug_events.append({"event": "bad_imu_reset", "t": timestamp})
            self._reset_active_map()
            return True
        return False

    def _finish_keyframe(self, kf: int, n_inliers: int):
        """Tail of keyframe insertion: a finished background global BA
        reconciled into the map (the current pose moved with the last
        keyframe's correction; a failed campaign raises here), loop / merge
        detection on the new keyframe (told whether the IMU is initialized
        and its refinement stage), after a map merge of an inertial map the
        visual-inertial BA over the last 10 keyframes (MergeInertialBA,
        `LoopClosing.cc:1783`), a global BA launched in a side thread after
        a loop correction of a visual map (at most 200 keyframes; a
        correction while one runs aborts it, `LoopClosing.cc:1199-1207`),
        then the pose refreshed from the optimized keyframe and the
        bookkeeping."""
        cfg = self.cfg
        if self.gba is not None and self.gba.failed:
            raise RuntimeError("the background global BA failed") from self.gba.error
        if self.gba is not None and self.gba.finished:
            s = self.map
            Ro, to = s.kf_R[self.last_kf_row], s.kf_t[self.last_kf_row]
            s = self.gba.reconcile(s)
            R_rel, t_rel = lie.se3_mul(self.last["R"], self.last["t"], *lie.se3_inv(Ro, to))
            self.last["R"], self.last["t"] = lie.se3_mul(
                R_rel, t_rel, s.kf_R[self.last_kf_row], s.kf_t[self.last_kf_row])
            self.map = s
            self.velocity = None
            self._tracked_lms = None
            self._vi_prior = None
            self._map_version += 1
        if self.loop_closer is not None:
            loops_before = self.loop_closer.n_loops
            merges_before = self.loop_closer.n_merges
            self.loop_closer.inertial = (None if self.imu is None
                                         else (self.imu.initialized, self.imu.viba_stage))
            with GLOBAL_TIMER.stage_sync("loop.on_keyframe", self.device):
                self.map, closed = self.loop_closer.on_keyframe(self.map, kf, cfg.kind, cfg.K)
            if closed:
                self._tracked_lms = None
                self._vi_prior = None
                if (self.loop_closer.n_merges > merges_before and self.imu is not None
                        and self.imu.initialized):
                    n_kf = int(self.map.n_kf)
                    vi_tracker.run_vi_local_ba(self, np.arange(n_kf - min(n_kf, 10), n_kf),
                                               n_fixed=1)
                if self.loop_closer.n_loops > loops_before:
                    if self.gba is not None and self.gba.running:
                        self.gba.request_abort()
                    elif (self.background_gba and self.imu is None
                          and int(self.map.n_kf) < 200):
                        self.gba = global_ba.GlobalBARunner(cfg.K, cfg.kind)
                        self.gba.launch(self.map)
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
        the current keyframe poses (System::SaveTrajectoryEuRoC), after
        `sync_mapping`."""
        self.sync_mapping()
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
