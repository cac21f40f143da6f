"""Entry points of the port.

`entry()` is the counterpart of the JAX package's `__graft_entry__.entry()`:
one full tracking step (ORB extraction, local-map projection matching
through kernel K1, motion-only pose BA through kernel K2) at the flagship
width, 752x480 with 1000 features over 8 levels and a 2048-landmark local
map. It returns `(track_step, example_args)` on CUDA unless the caller
passes `device="cpu"`.

`bootstrap(frames)` is the monocular map bootstrap at the same width with
the tracker's defaults (`tracker_config`): two-view initialization into the
Atlas, the initial Schur BA, then the fused per-frame tracking of the next
frames against the 8192-landmark arena through K1 and K2.

`slam(frames)` is monocular SLAM at the same width through the `System`
façade: the bootstrap, then tracking with keyframe insertion and the
local-mapping stack (triangulation, the fuse through K1, local BA,
culling) on every keyframe. With a stereo or RGB-D config it does the same
for a rectified stereo pair or an RGB-D camera: a one-frame initialization
from measured depth, tracking through K2's stereo rows, depth landmarks at
each keyframe, and optionally localization-only mode from a given frame.

A session may also start from a reference-format settings file
(`slam(frames, settings_path=..., sensor=...)`): a KB8 fisheye stereo rig,
a pinhole camera with rad-tan distortion, or a legacy stereo file whose
raw images are rectified before tracking.

`blob_frame` and `make_scene` build a self-consistent tracking scene from
a seed: landmarks lifted from a frame's own keypoints plus random map slots,
and a perturbed start pose. `plane_sequence` renders the textured-plane
scene of tests/synthetic_scene.py along its orbit, in numpy;
`render_stereo` and `render_with_depth` give a rectified pair and an image
with its depth map, `render_rays` the image of a camera whose pixel rays
are made once by `kb8_rays` (a KB8 fisheye camera, the role of
tests/synthetic_scene.render_kb8 without OpenCV) or `radtan_rays` (the raw
pixels of a pinhole camera with rad-tan distortion; `render_radtan`);
`kb8_stereo_settings` and `euroc_legacy_settings` write the settings files
of those two rigs, `pinhole_settings` one for a plain pinhole camera, and
`write_euroc_folder` writes frames as a EuRoC dataset folder for the
drivers (`drivers.py`).

With an inertial config (`sensor="mono-imu"`, `"stereo-imu"` or
`"rgbd-imu"`) `slam(frames, cfg, imu=packets, timestamps=...)` passes each
frame's IMU packet through; `vi_render_trajectory` and
`vi_depth_trajectory` are the IMU-consistent trajectories of
tests/test_slam_vi.py and tests/test_slam_vi_depth.py in numpy.

With a vocabulary (`slam(..., vocabulary=...)`, trained in the run by
`train_vocabulary` on held-out views) the session relocalizes, closes loops
and merges maps. `room_scene` and `loop_trajectory` are the textured room
and the closed circle of tests/synthetic_scene.py in numpy (`QuadScene`:
ray-cast quads, 5x5 blur and bilinear sampling without OpenCV).
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from . import device as device_mod
from .frontend import camera as cam
from .frontend import orb
from .ops import lie
from .tracking import track, tracker

FULL_WH = (752, 480)
FULL_L = 2048
START_XI = (0.03, -0.02, 0.05, 0.004, -0.003, 0.002)  # (rho, phi) off the truth


def make_track_step(cfg: orb.OrbConfig, K, img_wh, radius_px: float = 15.0):
    """track_step(img, lm_pos, lm_desc, lm_valid, lm_max_dist, lm_min_dist,
    lm_normal, R0, t0) -> (R, t, n_inliers) on the device of K."""
    scale_factors = cfg.scale_factors(K.device)
    img_wh = (float(img_wh[0]), float(img_wh[1]))

    def track_step(img, lm_pos, lm_desc, lm_valid, lm_maxd, lm_mind,
                   lm_normal, R0, t0):
        feats = orb.extract(img, cfg)
        idx, ok, _visible, _, _d = track.match_local_map(
            cam.PINHOLE, K, R0, t0, lm_pos, lm_desc, lm_valid,
            lm_maxd, lm_mind, lm_normal,
            feats.xy, feats.descriptors, feats.octave, feats.valid,
            radius_px, scale_factors, img_wh=img_wh,
        )
        idx = idx.long()
        oct_m = torch.clamp(feats.octave[idx], 0, cfg.n_levels - 1).long()
        inv_sig2 = 1.0 / (scale_factors[oct_m] ** 2)
        R, t, _inl, n = track.pose_optimize(
            cam.PINHOLE, K, R0, t0, feats.xy[idx].contiguous(), lm_pos,
            inv_sig2, ok,
        )
        return R, t, n

    return track_step


def entry(device=None):
    """(track_step, example_args) at full width on `device` (default CUDA).
    The example arguments are those of the JAX entry(): a uniform-noise
    frame and random landmarks, made from numpy seed 0."""
    dev = device_mod.resolve(device)
    cfg = orb.OrbConfig(n_features=1000, n_levels=8)
    K = cam.make_pinhole(450.0, 450.0, 376.0, 240.0, device=dev)
    step = make_track_step(cfg, K, FULL_WH)

    L = FULL_L
    rng = np.random.default_rng(0)
    f32 = dict(dtype=torch.float32, device=dev)
    img = torch.tensor(rng.uniform(0, 255, (FULL_WH[1], FULL_WH[0])), **f32)
    lm_pos = torch.tensor(
        np.concatenate([rng.uniform(-3, 3, (L, 2)), rng.uniform(4, 9, (L, 1))], axis=1),
        **f32,
    )
    lm_desc = torch.tensor(rng.integers(0, 256, (L, 32)), dtype=torch.uint8, device=dev)
    example_args = (
        img, lm_pos, lm_desc, torch.ones(L, dtype=torch.bool, device=dev),
        torch.full((L,), 8.0, **f32), torch.full((L,), 2.0, **f32),
        torch.zeros((L, 3), **f32),
        torch.eye(3, **f32), torch.zeros(3, **f32),
    )
    return step, example_args


def blob_frame(h: int, w: int, seed: int = 1, n_blobs=None):
    """Blob-textured float32 frame drawn like the JAX bench's hot-path frames
    (bench.py): square blobs of side 3-9 and value 40-255 on black. The blob
    count defaults to the bench's 2500 per 752x480, scaled by area."""
    if n_blobs is None:
        n_blobs = int(round(2500 * h * w / (752 * 480)))
    rng = np.random.default_rng(seed)
    img = np.zeros((h, w), np.float32)
    xs = rng.integers(10, w - 12, n_blobs)
    ys = rng.integers(10, h - 10, n_blobs)
    side = rng.integers(3, 10, n_blobs)
    val = rng.uniform(40, 255, n_blobs)
    for x, y, s, v in zip(xs, ys, side, val):
        img[y:y + s, x:x + s] = v
    return img


def make_scene(xy, octave, desc, valid, K, n_levels: int, L: int,
               scale: float = 1.2, seed: int = 0, start_xi=START_XI):
    """Self-consistent local map for a frame's own features (numpy in,
    numpy out, float32 / uint8 / bool as the packages hold them).

    Every valid keypoint becomes a landmark at depth U[4, 8] on its ray under
    the true pose (identity), with the keypoint's descriptor,
    max_dist = |X| * scale**octave, min_dist = max_dist / scale**(levels-1)
    and a unit normal towards the camera's view. The remaining L - n slots
    are random valid landmarks with random descriptors (like entry()'s
    example map). Rows are shuffled. Tracking starts from
    exp(start_xi) * truth. Returns a dict with lm_pos, lm_desc, lm_valid,
    lm_max_dist, lm_min_dist, lm_normal, R0, t0, R_true, t_true, n_frame."""
    rng = np.random.default_rng(seed)
    K = np.asarray(K, np.float64)
    fx, fy, cx, cy = K[:4]
    keep = np.flatnonzero(np.asarray(valid))
    n_frame = min(len(keep), L)
    keep = keep[:n_frame]
    uv = np.asarray(xy, np.float64)[keep]
    depth = rng.uniform(4.0, 8.0, n_frame)
    X = np.stack([(uv[:, 0] - cx) / fx * depth, (uv[:, 1] - cy) / fy * depth, depth], 1)
    dist = np.linalg.norm(X, axis=1)
    maxd = dist * scale ** np.asarray(octave, np.float64)[keep]
    mind = maxd / scale ** (n_levels - 1)
    normal = X / dist[:, None]
    d_frame = np.asarray(desc, np.uint8)[keep]

    n_rand = L - n_frame
    Xr = np.concatenate([rng.uniform(-3, 3, (n_rand, 2)), rng.uniform(4, 9, (n_rand, 1))], 1)
    d_rand = rng.integers(0, 256, (n_rand, 32)).astype(np.uint8)

    perm = rng.permutation(L)
    lm_pos = np.concatenate([X, Xr])[perm]
    lm_desc = np.concatenate([d_frame, d_rand])[perm]
    lm_maxd = np.concatenate([maxd, np.full(n_rand, 8.0)])[perm]
    lm_mind = np.concatenate([mind, np.full(n_rand, 2.0)])[perm]
    lm_normal = np.concatenate([normal, np.zeros((n_rand, 3))])[perm]

    R0, t0 = (a.numpy() for a in lie.se3_exp(torch.tensor(start_xi, dtype=torch.float64)))
    f = np.float32
    return dict(
        lm_pos=lm_pos.astype(f), lm_desc=np.ascontiguousarray(lm_desc),
        lm_valid=np.ones(L, bool), lm_max_dist=lm_maxd.astype(f),
        lm_min_dist=lm_mind.astype(f), lm_normal=lm_normal.astype(f),
        R0=R0.astype(f), t0=t0.astype(f),
        R_true=np.eye(3, dtype=f), t_true=np.zeros(3, f), n_frame=n_frame,
    )


# ---------------------------------------------------------------------------
# The monocular map bootstrap (two-view init -> Atlas -> BA -> tracking)
# ---------------------------------------------------------------------------

FULL_K = (450.0, 450.0, 376.0, 240.0)


def tracker_config(device=None, img_wh=FULL_WH, K=FULL_K, **fields):
    """TrackerConfig at the flagship width on `device` (default CUDA): the
    JAX TrackerConfig defaults (kmax 128, lmax 8192, window 8, init BA of
    20 iterations, 80 init matches, 15 inliers, radii 15 / 4 px, the
    background mapper on a free-running thread, pipeline depth 6) with
    OrbConfig(1000, 8) at 752x480 and K = (450, 450, 376, 240). A depth
    sensor (sensor="stereo" or "rgbd", with its bf) gets th_depth 20, as
    tests/test_slam_rgbd_stereo.py sets it. `fields` override any of
    them."""
    fields.setdefault("orb", orb.OrbConfig(n_features=1000, n_levels=8))
    if fields.get("sensor", "mono") != "mono":
        fields.setdefault("th_depth", 20.0)
    return tracker.TrackerConfig(K=cam.make_pinhole(*K, device=device),
                                 img_wh=tuple(img_wh), **fields)


def bootstrap(frames, cfg=None, device=None, n_track: int = 8,
              max_init_frames: int = 10, timer=tracker.no_timer):
    """Bootstrap a monocular map from `frames` (a sequence of [H, W] images)
    on `device` (default CUDA): extract each frame, call
    initialize_monocular frame by frame (the frame index seeds the
    two-view draw, as the JAX tracker's frame count does) keeping the
    reference frame as the tracker does, then track the next `n_track`
    frames with track_frame. A frame with fewer than min_inliers inliers
    ends the run (relocalization comes with a later slice).

    Returns a dict: init (InitResult), init_frame, feats (per frame),
    frames_tracked, and track_sequence's poses [(R, t)], n_inliers, outs
    (track_frame outputs), map (with the tracked frames' visible / found
    counts added) and lost."""
    if cfg is None:
        cfg = tracker_config(device)
    dev = cfg.K.device
    feats = [orb.extract(torch.as_tensor(np.asarray(f), dtype=torch.float32, device=dev),
                         cfg.orb) for f in frames]
    return bootstrap_features(feats, cfg, n_track=n_track,
                              max_init_frames=max_init_frames, timer=timer)


def bootstrap_features(feats, cfg, n_track: int = 8, max_init_frames: int = 10,
                       timer=tracker.no_timer):
    """`bootstrap` on features already extracted (on cfg.K's device)."""
    s = tracker.empty_map(cfg, device=cfg.K.device)
    init_ref, res, i = None, None, 0
    for i in range(min(max_init_frames, len(feats))):
        res = tracker.initialize_monocular(cfg, s, init_ref, feats[i], float(i), seed=i,
                                           timer=timer)
        init_ref = res.init_ref
        if res.success:
            break
    out = dict(init=res, init_frame=i, feats=feats, frames_tracked=[], poses=[],
               n_inliers=[], outs=[], map=None, lost=False)
    if res is not None and res.success:
        out.update(track_sequence(cfg, res, feats[i + 1:i + 1 + n_track], timer=timer))
        out["frames_tracked"] = list(range(i + 1, i + 1 + len(out["n_inliers"])))
    return out


def track_sequence(cfg, init, feats, timer=tracker.no_timer):
    """Track `feats` frame by frame against the map of a successful
    InitResult, as the tracker's fused path does: constant-velocity
    prediction (dropped when the widened retry found it poisoned), the
    previous frame's tracked mask, and the map's visible / found counts
    updated after each frame. One host read per frame (n, vel_poisoned)
    besides the two of track_frame_visual. Stops at the first frame with
    fewer than min_inliers inliers.

    Returns a dict: poses [(R, t)], n_inliers, outs, map, lost."""
    s = init.map
    R_last, t_last = init.R, init.t
    velocity, tracked, last_inliers = None, None, 0
    out = dict(poses=[], n_inliers=[], outs=[], map=s, lost=False)
    for f in feats:
        with timer("track_frame"):
            o = tracker.track_frame(cfg, s, f, init.kf1, R_last, t_last, velocity=velocity,
                                    tracked=tracked, last_inliers=last_inliers)
            n, poisoned = (int(v) for v in o["scal"][:2].cpu())
        out["outs"].append(o)
        out["n_inliers"].append(n)
        if n < cfg.min_inliers:
            out["lost"] = True
            break
        out["poses"].append((o["R"], o["t"]))
        velocity = None if poisoned else (o["Rv"], o["tv"])
        R_last, t_last, tracked, last_inliers = o["R"], o["t"], o["tracked"], n
        s = dataclasses.replace(s, lm_visible=s.lm_visible + o["vis32"],
                                lm_found=s.lm_found + o["fnd32"])
    out["map"] = s
    return out


def slam(frames, cfg=None, device=None, localize_from=None, timer=tracker.no_timer,
         settings_path=None, sensor="mono", vocabulary=None, until=None, imu=None,
         timestamps=None):
    """SLAM over `frames`, 0.05 s apart, through the System façade on
    `device` (default CUDA), routed on the session's sensor: track_monocular
    ("mono", each frame an [H, W] image), track_stereo ("stereo", each frame
    a (left, right) pair: rectified, a fisheye rig's, or raw images that the
    settings file's rectification blocks remap) or track_rgbd ("rgbd", each
    frame an (image, depth map) pair). Initialization, tracking, keyframe
    insertion and local mapping on each keyframe; from frame
    `localize_from` on, the session runs in localization-only mode (mapping
    paused). The session is System(settings_path, sensor) when a settings
    file is given, else System(config=cfg), `cfg` defaulting to
    tracker_config() (mono, 752x480, OrbConfig(1000, 8), kmax 128, lmax
    8192, window 8). With `vocabulary` the session relocalizes, closes loops
    and merges maps. `timer(name)` is a context manager wrapped around each
    frame ("frame"); the session stops after the first frame on which
    `until(system)` holds. An inertial session passes `imu[i]`, the [M, 7]
    packet (t, gx, gy, gz, ax, ay, az) measured up to frame i, with frame i
    (System::Track*(..., vImuMeas)). `timestamps` replaces the frames'
    0.05 s spacing. The session maps as its config says (by default on the
    background mapper thread, TrackerConfig.async_mapping); the run ends
    with `tracker.sync_mapping()`, so the map reflects every queued
    keyframe. Returns the System, whose tracker holds the map and the
    trajectory; the caller shuts it down (`System.shutdown`), which stops
    the mapper thread."""
    from .api.system import System

    if settings_path is not None:
        if cfg is not None:
            raise ValueError("pass cfg or settings_path, not both")
        sys_ = System(settings_path, sensor=sensor, vocabulary=vocabulary, device=device)
    else:
        sys_ = System(config=cfg if cfg is not None else tracker_config(device),
                      vocabulary=vocabulary, device=device)
    track = {"mono": lambda f, ts, m: sys_.track_monocular(f, ts, imu=m),
             "stereo": lambda f, ts, m: sys_.track_stereo(f[0], f[1], ts, imu=m),
             "rgbd": lambda f, ts, m: sys_.track_rgbd(f[0], f[1], ts, imu=m),
             }[sys_.tracker.base_sensor]
    for i, frame in enumerate(frames):
        if i == localize_from:
            sys_.activate_localization_mode()
        with timer("frame"):
            track(frame, 0.05 * i if timestamps is None else timestamps[i],
                  None if imu is None else imu[i])
        if until is not None and until(sys_):
            break
    sys_.tracker.sync_mapping()
    return sys_


def kb8_stereo_settings(K8, img_wh, baseline: float, n_features: int = 1000,
                        n_levels: int = 8, th_depth: float = 20.0) -> str:
    """The text of a TUM-VI-style settings file (schema 1.0) for a KB8
    fisheye stereo rig: Camera1 = Camera2 = K8 [8], the right camera
    `baseline` along the left camera's x (Stereo.T_c1_c2)."""
    cams = "\n".join(f"Camera{c}.{k}: {float(v)!r}" for c in (1, 2) for k, v in zip(
        ("fx", "fy", "cx", "cy", "k1", "k2", "k3", "k4"), K8))
    return f"""%YAML:1.0
File.version: "1.0"
Camera.type: "KannalaBrandt8"
{cams}
Camera.width: {img_wh[0]}
Camera.height: {img_wh[1]}
Camera.fps: 20
Stereo.ThDepth: {th_depth!r}
Stereo.T_c1_c2: !!opencv-matrix
   rows: 4
   cols: 4
   dt: f
   data: [1.0, 0.0, 0.0, {baseline!r}, 0.0, 1.0, 0.0, 0.0,
          0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 0.0, 1.0]
ORBextractor.nFeatures: {n_features}
ORBextractor.scaleFactor: 1.2
ORBextractor.nLevels: {n_levels}
ORBextractor.iniThFAST: 20
ORBextractor.minThFAST: 7
"""


def pinhole_settings(K, img_wh, n_features: int = 1000, n_levels: int = 8,
                     fps: float = 20.0, bf: float = 0.0, th_depth: float = 20.0) -> str:
    """The text of an old-format settings file (Camera.fx ...) for an
    undistorted pinhole camera K = (fx, fy, cx, cy) at img_wh, with
    Camera.bf and ThDepth for the depth sensors."""
    fx, fy, cx, cy = (float(v) for v in K[:4])
    return f"""%YAML:1.0
Camera.type: "PinHole"
Camera.fx: {fx!r}
Camera.fy: {fy!r}
Camera.cx: {cx!r}
Camera.cy: {cy!r}
Camera.k1: 0.0
Camera.k2: 0.0
Camera.p1: 0.0
Camera.p2: 0.0
Camera.width: {img_wh[0]}
Camera.height: {img_wh[1]}
Camera.fps: {fps!r}
Camera.bf: {float(bf)!r}
Camera.RGB: 1
ThDepth: {th_depth!r}
DepthMapFactor: 1.0
ORBextractor.nFeatures: {n_features}
ORBextractor.scaleFactor: 1.2
ORBextractor.nLevels: {n_levels}
ORBextractor.iniThFAST: 20
ORBextractor.minThFAST: 7
"""


def write_euroc_folder(root, frames, fps: float = 20.0, t0_ns: int = 1_403_636_579_763_555_584,
                       right=None, imu=None) -> list:
    """Write grey frames (float or uint8 [H, W]) as a EuRoC ASL folder:
    mav0/cam0/data.csv and mav0/cam0/data/<ns>.png (PNG from
    utils/png.py), with `right` frames under cam1 and `imu` rows [M, 7]
    (t in seconds from the first frame, gyro, acc) under imu0. Returns the
    frame timestamps in ns."""
    from .utils import png

    ts = [t0_ns + int(round(i * 1e9 / fps)) for i in range(len(frames))]
    for cam, imgs in (("cam0", frames), ("cam1", right)):
        if imgs is None:
            continue
        d = os.path.join(root, "mav0", cam, "data")
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(root, "mav0", cam, "data.csv"), "w") as f:
            f.write("#timestamp [ns],filename\n")
            for t, img in zip(ts, imgs):
                png.write(os.path.join(d, f"{t}.png"),
                          np.clip(np.rint(np.asarray(img)), 0, 255).astype(np.uint8))
                f.write(f"{t},{t}.png\n")
    if imu is not None:
        d = os.path.join(root, "mav0", "imu0")
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, "data.csv"), "w") as f:
            f.write("#timestamp [ns],w_x,w_y,w_z,a_x,a_y,a_z\n")
            for row in np.asarray(imu, np.float64):
                f.write(f"{t0_ns + int(round(row[0] * 1e9))},"
                        + ",".join(repr(float(v)) for v in row[1:7]) + "\n")
    return ts


EUROC_K = (458.654, 457.296, 367.215, 248.375)  # cam0 of EuRoC MAV (tests/test_api.py)
EUROC_D = (-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05, 0.0)
EUROC_BASELINE = 0.11  # metres, the right camera along the left camera's x


def euroc_legacy_settings() -> str:
    """The text of an old-format EuRoC stereo settings file
    (Examples_old/Stereo/EuRoC.yaml) at 752x480: LEFT. / RIGHT.
    rectification blocks with the raw camera EUROC_K and rad-tan EUROC_D on
    both sides, R = I, and the rectified cameras P = FULL_K with
    RIGHT.P[0, 3] = -fx * EUROC_BASELINE; ThDepth 35, 1000 features on 8
    levels. `data:[` without a space, as those files write it."""
    K, D, P, img_wh = EUROC_K, EUROC_D, FULL_K, FULL_WH
    k = f"[{K[0]!r}, 0.0, {K[2]!r}, 0.0, {K[1]!r}, {K[3]!r}, 0.0, 0.0, 1.0]"
    d = "[" + ", ".join(repr(float(v)) for v in D) + "]"
    eye = "[1.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 1.0]"

    def p(tx):
        return (f"[{P[0]!r}, 0.0, {P[2]!r}, {tx!r}, 0.0, {P[1]!r}, {P[3]!r}, 0.0, "
                f"0.0, 0.0, 1.0, 0.0]")

    blocks = []
    for side, tx in (("LEFT", 0.0), ("RIGHT", -P[0] * EUROC_BASELINE)):
        blocks.append(f"""#--------------------------------------------------------------
# {side} camera: rectification parameters
#--------------------------------------------------------------
{side}.height: {img_wh[1]}
{side}.width: {img_wh[0]}
{side}.D: !!opencv-matrix
   rows: 1
   cols: {len(D)}
   dt: d
   data:{d}
{side}.K: !!opencv-matrix
   rows: 3
   cols: 3
   dt: d
   data:{k}
{side}.R:  !!opencv-matrix
   rows: 3
   cols: 3
   dt: d
   data:{eye}
{side}.P:  !!opencv-matrix
   rows: 3
   cols: 4
   dt: d
   data:{p(tx)}""")
    return f"""%YAML:1.0

# Camera parameters (after rectification)
Camera.fx: {P[0]!r}
Camera.fy: {P[1]!r}
Camera.cx: {P[2]!r}
Camera.cy: {P[3]!r}
Camera.width: {img_wh[0]}
Camera.height: {img_wh[1]}
Camera.fps: 20.0
Camera.RGB: 1
ThDepth: 35.0

""" + "\n\n".join(blocks) + f"""

ORBextractor.nFeatures: 1000
ORBextractor.scaleFactor: 1.2
ORBextractor.nLevels: 8
ORBextractor.iniThFAST: 20
ORBextractor.minThFAST: 7
"""


def _blur(img, ksize: int = 3, sigma: float = 0.8):
    """ksize x ksize Gaussian with reflect-101 borders
    (cv2.GaussianBlur((ksize, ksize), sigma)), separable, in float32."""
    r = ksize // 2
    w = np.exp(-np.arange(-r, r + 1, dtype=np.float64) ** 2 / (2.0 * sigma * sigma))
    w = (w / w.sum()).astype(np.float32)
    p = np.pad(img, r, mode="reflect")
    h, wd = img.shape
    rows = sum(w[k] * p[:, k:k + wd] for k in range(ksize))
    return sum(w[k] * rows[k:k + h] for k in range(ksize))


def plane_texture(seed: int, size: int = 1024, blobs: int = 4000):
    """Blob texture of a scene plane, drawn like tests/synthetic_scene.py's
    make_texture (same draws), blurred by the 3x3 Gaussian."""
    rng = np.random.default_rng(seed)
    tex = np.zeros((size, size), np.float32)
    xs = rng.integers(0, size - 14, blobs)
    ys = rng.integers(0, size - 14, blobs)
    for x, y in zip(xs, ys):
        w, h = rng.integers(4, 14, 2)
        tex[y:y + h, x:x + w] = rng.uniform(40, 255)
    return _blur(tex)


def plane_scene(seed: int = 0):
    """The planes of tests/synthetic_scene.PlaneScene: a far plane at z = 6
    and four near patches at z ~ U[4.2, 5.2], each with its texture."""
    planes = [dict(z=6.0, x0=-6.0, x1=8.0, y0=-4.5, y1=4.5, tex=plane_texture(seed))]
    rng = np.random.default_rng(seed + 7)
    for j, (x0, x1, y0, y1) in enumerate([(-1.5, 0.2, -0.8, 0.6), (1.2, 2.8, 0.2, 1.6),
                                          (3.0, 4.6, -1.6, -0.3), (5.0, 6.6, -0.5, 0.9)]):
        planes.append(dict(z=float(rng.uniform(4.2, 5.2)), x0=x0, x1=x1, y0=y0, y1=y1,
                           tex=plane_texture(seed + 1 + j)))
    return planes


def _pixels(img_wh):
    w, h = img_wh
    return np.meshgrid(np.arange(w, dtype=np.float64), np.arange(h, dtype=np.float64))


def _pinhole_rays(K, img_wh):
    fx, fy, cx, cy = K[:4]
    us, vs = _pixels(img_wh)
    return np.stack([(us - cx) / fx, (vs - cy) / fy, np.ones_like(us)], -1)


RADTAN_NEWTON_STEPS = 20


def radtan_undistort_np(K, D, us, vs):
    """Rad-tan undistortion (k1, k2, p1, p2, k3) of raw pixels in float64
    numpy by Newton steps on the distortion map, converged to ~1e-12 in the
    image corners: pixels -> rays [..., 3] with z = 1."""
    fx, fy, cx, cy = (float(v) for v in K[:4])
    k1, k2, p1, p2, k3 = (float(v) for v in np.pad(np.ravel(D), (0, 5))[:5])
    xd, yd = (us - cx) / fx, (vs - cy) / fy
    x, y = xd.copy(), yd.copy()
    for _ in range(RADTAN_NEWTON_STEPS):
        r2 = x * x + y * y
        rad = 1 + r2 * (k1 + r2 * (k2 + r2 * k3))
        drad = k1 + r2 * (2 * k2 + 3 * k3 * r2)   # d rad / d r2
        ex = x * rad + 2 * p1 * x * y + p2 * (r2 + 2 * x * x) - xd
        ey = y * rad + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y - yd
        jxx = rad + 2 * x * x * drad + 2 * p1 * y + 6 * p2 * x
        jxy = 2 * x * y * drad + 2 * p1 * x + 2 * p2 * y
        jyx = 2 * x * y * drad + 2 * p1 * x + 2 * p2 * y
        jyy = rad + 2 * y * y * drad + 6 * p1 * y + 2 * p2 * x
        det = jxx * jyy - jxy * jyx
        x, y = x - (jyy * ex - jxy * ey) / det, y - (jxx * ey - jyx * ex) / det
    return np.stack([x, y, np.ones_like(x)], -1)


def _plane_hits(planes, rays, R_cw, t_cw):
    """Per plane: (plane, depth along each pixel's ray, texture u, v,
    inside) for the camera Tcw = (R_cw, t_cw) whose pixels look along
    `rays` [H, W, 3] (z = 1 in the camera)."""
    R_wc = np.asarray(R_cw, np.float64).T
    c = -R_wc @ np.asarray(t_cw, np.float64)
    rays_w = rays @ R_wc.T
    for pl in planes:
        size = pl["tex"].shape[0]
        rz = rays_w[..., 2]
        lam = (pl["z"] - c[2]) / np.where(np.abs(rz) < 1e-9, 1e-9, rz)
        tu = (c[0] + lam * rays_w[..., 0] - pl["x0"]) / (pl["x1"] - pl["x0"]) * (size - 1)
        tv = (c[1] + lam * rays_w[..., 1] - pl["y0"]) / (pl["y1"] - pl["y0"]) * (size - 1)
        inside = (lam > 0) & (tu >= 0) & (tu <= size - 1) & (tv >= 0) & (tv <= size - 1)
        yield pl, lam, tu, tv, inside


def render_planes(planes, K, img_wh, R_cw, t_cw):
    """Render the planes seen from Tcw = (R_cw, t_cw): each pixel's ray is
    intersected with every plane (later planes drawn over earlier ones, as
    PlaneScene.render does) and the texture sampled bilinearly."""
    return render_with_depth(planes, K, img_wh, R_cw, t_cw, with_depth=False)[0]


def kb8_rays(K8, img_wh):
    """[H, W, 3] float64 rays (z = 1) of a KB8 fisheye camera K8 [8]:
    camera.kb8_unproject of every pixel, in float64 on the CPU."""
    uv = torch.from_numpy(np.stack(_pixels(img_wh), -1))
    return cam.kb8_unproject(torch.tensor(K8, dtype=torch.float64), uv).numpy()


def radtan_rays(K, D, img_wh):
    """[H, W, 3] float64 rays (z = 1) of the raw pixels of a pinhole camera K
    with rad-tan distortion D (k1, k2, p1, p2, k3): radtan_undistort_np."""
    return radtan_undistort_np(np.asarray(K, np.float64), D, *_pixels(img_wh))


def render_rays(planes, rays, R_cw, t_cw):
    """The planes seen from Tcw by a camera whose pixels look along `rays`
    [H, W, 3] (kb8_rays, radtan_rays: compute them once per camera)."""
    return _render(planes, rays, R_cw, t_cw, with_depth=False)[0]


def render_radtan(planes, K, D, img_wh, R_cw, t_cw):
    """The raw image of a pinhole camera K with rad-tan distortion D from
    Tcw: each raw pixel undistorted onto its ray, then the planes hit as
    render_planes does."""
    return render_rays(planes, radtan_rays(K, D, img_wh), R_cw, t_cw)


def render_with_depth(planes, K, img_wh, R_cw, t_cw, with_depth: bool = True):
    """(image, depth): render_planes and the [H, W] depth (camera z; rays
    have unit z) of the surface drawn at each pixel, 0 where there is none
    (PlaneScene.render_with_depth); depth None without with_depth."""
    return _render(planes, _pinhole_rays(K, img_wh), R_cw, t_cw, with_depth)


def _render(planes, rays, R_cw, t_cw, with_depth: bool):
    h, w = rays.shape[:2]
    img = np.zeros((h, w), np.float32)
    depth = np.zeros((h, w), np.float32) if with_depth else None
    for pl, lam, tu, tv, inside in _plane_hits(planes, rays, R_cw, t_cw):
        if with_depth:
            depth = np.where(inside, lam.astype(np.float32), depth)
        img = np.where(inside, _bilinear(pl["tex"], tu, tv), img)
    return img, depth


def _bilinear(tex, tu, tv):
    """Bilinear samples of the square texture `tex` at (tu, tv) (texel
    units, clipped to the texture), float32."""
    size = tex.shape[0]
    u0 = np.clip(np.floor(tu), 0, size - 2).astype(np.int64)
    v0 = np.clip(np.floor(tv), 0, size - 2).astype(np.int64)
    a = np.clip(tu - u0, 0.0, 1.0)
    b = np.clip(tv - v0, 0.0, 1.0)
    val = ((1 - a) * (1 - b) * tex[v0, u0] + a * (1 - b) * tex[v0, u0 + 1]
           + (1 - a) * b * tex[v0 + 1, u0] + a * b * tex[v0 + 1, u0 + 1])
    return val.astype(np.float32)


def render_stereo(planes, K, img_wh, R_cw, t_cw, baseline: float):
    """A rectified pair (left, right): the right camera is displaced by
    +baseline along the left camera's x axis (PlaneScene.render_stereo)."""
    t_right = np.asarray(t_cw, np.float64) - np.array([baseline, 0.0, 0.0])
    return (render_planes(planes, K, img_wh, R_cw, t_cw),
            render_planes(planes, K, img_wh, R_cw, t_right))


def orbit_trajectory(n_frames: int, radius=0.04, advance=0.035, yaw_rate=0.004):
    """tests/synthetic_scene.orbit_trajectory: sideways travel along +x with a
    slight yaw. Returns (R_cw [N,3,3], t_cw [N,3]) as float64 numpy."""
    Rs, ts = [], []
    for i in range(n_frames):
        yaw = yaw_rate * i
        cy_, sy_ = np.cos(yaw), np.sin(yaw)
        R_wc = np.array([[cy_, 0.0, sy_], [0.0, 1.0, 0.0], [-sy_, 0.0, cy_]])
        c = np.array([advance * i, radius * np.sin(0.15 * i), 0.1 * np.sin(0.05 * i)])
        Rs.append(R_wc.T)
        ts.append(-R_wc.T @ c)
    return np.stack(Rs), np.stack(ts)


def plane_sequence(n_frames: int, img_wh=FULL_WH, K=FULL_K, seed: int = 0):
    """(frames, R_cw, t_cw, planes): the PlaneScene rendered along the orbit."""
    planes = plane_scene(seed)
    R, t = orbit_trajectory(n_frames)
    frames = [render_planes(planes, K, img_wh, R[i], t[i]) for i in range(n_frames)]
    return frames, R, t, planes


# ---------------------------------------------------------------------------
# IMU-consistent trajectories (tests/test_slam_vi.py, tests/test_slam_vi_depth.py)
# ---------------------------------------------------------------------------

GRAVITY = 9.81


def so3_exp_np(w):
    """Rodrigues in float64 numpy: axis-angle [3] -> rotation [3, 3]."""
    w = np.asarray(w, np.float64)
    th = float(np.linalg.norm(w))
    W = np.array([[0.0, -w[2], w[1]], [w[2], 0.0, -w[0]], [-w[1], w[0], 0.0]])
    if th < 1e-6:
        a, b = 1.0 - th * th / 6.0, 0.5 - th * th / 24.0
    else:
        a, b = np.sin(th) / th, (1.0 - np.cos(th)) / (th * th)
    return np.eye(3) + a * W + b * (W @ W)


def _imu_rows(R, v, p, t_abs, per_frame, dt, accel):
    """One frame's IMU packet by the exact discrete recursion the
    preintegration assumes; accel(t) -> (world acceleration, body rate).
    Returns (rows [per_frame, 7], R, v, p) after the packet."""
    g = np.array([0.0, 0.0, -GRAVITY])
    rows = []
    for k in range(per_frame):
        t = t_abs + k * dt
        a_w, w_b = accel(t)
        rows.append(np.concatenate([[t + dt], w_b, R.T @ (a_w - g)]))
        p = p + v * dt + 0.5 * a_w * dt * dt
        v = v + a_w * dt
        R = R @ so3_exp_np(w_b * dt)
    return np.array(rows), R, v, p


def vi_render_trajectory(n_frames=40, fps=10.0, hz=200.0):
    """tests/test_slam_vi.vi_render_trajectory: (R_cw [N,3,3], t_cw [N,3],
    IMU packets) with camera = body, z forward and gravity -z. Frame f is
    the state at the END of packet f, t = (f + 1) / fps, which is the
    timestamp a caller passes with it (recording it before the packet pairs
    each preintegration with the visual displacement a frame ahead: a
    17-19% scale bias under the acceleration ramp)."""
    dt = 1.0 / hz
    per_frame = int(hz / fps)

    def accel(t):
        ramp = min(t / 0.5, 1.0)
        a_w = np.array([0.7 * (1.0 - ramp) + 0.35 * np.sin(1.9 * t), 0.25 * np.cos(1.3 * t),
                        0.18 * np.sin(0.9 * t)])
        return a_w, np.array([0.05 * np.sin(0.7 * t), 0.06 * np.cos(0.9 * t), 0.04])

    R, v, p, t_abs = np.eye(3), np.zeros(3), np.zeros(3), 0.0
    R_cw, t_cw, packets = [], [], []
    for _ in range(n_frames):
        rows, R, v, p = _imu_rows(R, v, p, t_abs, per_frame, dt, accel)
        t_abs += per_frame * dt
        packets.append(rows)
        R_cw.append(R.T.copy())
        t_cw.append(-R.T @ p)
    return np.stack(R_cw), np.stack(t_cw), packets


def vi_depth_trajectory(n_frames=36, hz=200.0, fps=10.0, n_gentle=6):
    """tests/test_slam_vi_depth.vi_depth_trajectory: a gentle lead-in of
    n_gentle frames whose acceleration changes by less than 0.5 m/s^2
    between frames (the excitation gate must refuse it), then a vigorous
    shake with drift. Here frame f is the state at the START of packet f,
    as in that test."""
    dt = 1.0 / hz
    per_frame = int(hz / fps)
    t_shake = n_gentle / fps

    def accel(t):
        if t < t_shake:
            return (np.array([0.03 * np.sin(0.8 * t), 0.02, 0.0]),
                    np.array([0.01, 0.015, 0.01]))
        ts = t - t_shake
        return (np.array([2.5 * np.sin(12.0 * ts) + 0.5, 1.8 * np.cos(9.0 * ts),
                          0.9 * np.sin(7.0 * ts)]),
                np.array([0.05 * np.sin(0.7 * ts), 0.06 * np.cos(0.9 * ts), 0.04]))

    R, v, p, t_abs = np.eye(3), np.zeros(3), np.zeros(3), 0.0
    R_cw, t_cw, packets = [], [], []
    for _ in range(n_frames):
        R_cw.append(R.T.copy())
        t_cw.append(-R.T @ p)
        rows, R, v, p = _imu_rows(R, v, p, t_abs, per_frame, dt, accel)
        t_abs += per_frame * dt
        packets.append(rows)
    return np.stack(R_cw), np.stack(t_cw), packets


# ---------------------------------------------------------------------------
# The room scene and the closed loop (tests/synthetic_scene.py, numpy only)
# ---------------------------------------------------------------------------

class QuadScene:
    """Textured quads (dicts with p0, ex, ey, tex) rendered by casting each
    pixel's ray and keeping the nearest hit, with a per-render exposure
    jitter and noise drawn from one numpy generator (seed + 991), as
    tests/synthetic_scene.QuadScene does; textures sampled bilinearly. The
    ray casting runs in float64 torch ops on `device` (default CUDA); the
    images come back as float32 numpy arrays."""

    def __init__(self, K, img_wh=(512, 384), quads=(), exposure_jitter=0.0, noise=0.0,
                 seed=0, device=None):
        self.device = device_mod.resolve(device)
        self.img_wh = tuple(img_wh)
        self.quads = list(quads)
        self.exposure_jitter = exposure_jitter
        self.noise = noise
        self._rng = np.random.default_rng(seed + 991)
        self._rays = torch.from_numpy(_pinhole_rays(np.asarray(K, np.float64),
                                                    self.img_wh)).to(self.device)
        self._tex = {}

    def _texture(self, j):
        tex = self.quads[j]["tex"]
        hit = self._tex.get(j)
        if hit is None or hit[0] is not tex:
            hit = self._tex[j] = (tex, torch.from_numpy(np.ascontiguousarray(tex)).to(self.device))
        return hit[1]

    def _cast(self, R_cw, t_cw):
        f64 = dict(dtype=torch.float64, device=self.device)
        w, h = self.img_wh
        R_wc = torch.as_tensor(np.asarray(R_cw, np.float64).T, **f64)
        c = -R_wc @ torch.as_tensor(np.asarray(t_cw, np.float64), **f64)
        rays_w = self._rays @ R_wc.T
        img = torch.zeros((h, w), dtype=torch.float32, device=self.device)
        depth = torch.full((h, w), float("inf"), dtype=torch.float32, device=self.device)
        for j, q in enumerate(self.quads):
            p0, ex, ey = (torch.as_tensor(q[k], **f64) for k in ("p0", "ex", "ey"))
            n = torch.linalg.cross(ex, ey)
            n = n / torch.linalg.norm(n)
            denom = rays_w @ n
            denom = torch.where(denom.abs() < 1e-9, 1e-9, denom)
            lam = ((p0 - c) @ n) / denom
            d = c + lam[..., None] * rays_w - p0
            tx = d @ ex / (ex @ ex)
            ty = d @ ey / (ey @ ey)
            inside = ((lam > 0.05) & (tx >= 0) & (tx <= 1) & (ty >= 0) & (ty <= 1)
                      & (lam < depth))
            tex = self._texture(j)
            size = tex.shape[0]
            tu = (tx * (size - 1)).to(torch.float32)
            tv = (ty * (size - 1)).to(torch.float32)
            u0 = torch.clamp(torch.floor(tu), 0, size - 2).long()
            v0 = torch.clamp(torch.floor(tv), 0, size - 2).long()
            a_ = torch.clamp(tu - u0, 0.0, 1.0).to(torch.float64)
            b_ = torch.clamp(tv - v0, 0.0, 1.0).to(torch.float64)
            val = ((1 - a_) * (1 - b_) * tex[v0, u0] + a_ * (1 - b_) * tex[v0, u0 + 1]
                   + (1 - a_) * b_ * tex[v0 + 1, u0] + a_ * b_ * tex[v0 + 1, u0 + 1])
            img = torch.where(inside, val.to(torch.float32), img)
            depth = torch.where(inside, lam.to(torch.float32), depth)
        depth = torch.where(torch.isfinite(depth), depth, 0.0)
        return img.cpu().numpy(), depth.cpu().numpy()

    def _photometric(self, img):
        if self.exposure_jitter > 0:
            img = img * (1.0 + self._rng.uniform(-self.exposure_jitter, self.exposure_jitter))
        if self.noise > 0:
            img = img + self._rng.normal(0.0, self.noise, img.shape)
        return np.clip(img, 0, 255).astype(np.float32)

    def render(self, R_cw, t_cw):
        return self._photometric(self._cast(R_cw, t_cw)[0])

    def render_with_depth(self, R_cw, t_cw):
        img, depth = self._cast(R_cw, t_cw)
        return self._photometric(img), depth


def plane_quads(planes):
    """plane_scene's planes as QuadScene quads (each plane z = const over its
    x / y range, the texture along x and y), so that QuadScene casts the
    PlaneScene on a device: the near patches lie in front of the far plane
    and apart from each other, so the nearest hit is the plane drawn last."""
    return [dict(p0=np.array([pl["x0"], pl["y0"], pl["z"]]),
                 ex=np.array([pl["x1"] - pl["x0"], 0.0, 0.0]),
                 ey=np.array([0.0, pl["y1"] - pl["y0"], 0.0]), tex=pl["tex"]) for pl in planes]


def room_scene(K, img_wh=(512, 384), half=6.0, wall_h=2.2, seed=0, exposure_jitter=0.0,
               noise=0.0, smooth_texture=True, n_panels=10, device=None):
    """tests/synthetic_scene.room_scene: a square room's four walls, floor
    and ceiling plus a ring of free-standing panels facing its centre, each
    with a blob texture (seed + its index; with smooth_texture a further
    5x5 Gaussian of sigma 1.2). Cast on `device` (default CUDA)."""

    def tex(j):
        t = plane_texture(seed + j)
        return _blur(t, 5, 1.2) if smooth_texture else t

    S, H = half, wall_h
    quads = [
        dict(p0=np.array([-S, -H, S]), ex=np.array([2 * S, 0, 0]),
             ey=np.array([0, 2 * H, 0]), tex=tex(1)),
        dict(p0=np.array([S, -H, -S]), ex=np.array([-2 * S, 0, 0]),
             ey=np.array([0, 2 * H, 0]), tex=tex(2)),
        dict(p0=np.array([S, -H, S]), ex=np.array([0, 0, -2 * S]),
             ey=np.array([0, 2 * H, 0]), tex=tex(3)),
        dict(p0=np.array([-S, -H, -S]), ex=np.array([0, 0, 2 * S]),
             ey=np.array([0, 2 * H, 0]), tex=tex(4)),
        dict(p0=np.array([-S, H, -S]), ex=np.array([2 * S, 0, 0]),
             ey=np.array([0, 0, 2 * S]), tex=tex(5)),
        dict(p0=np.array([-S, -H, -S]), ex=np.array([2 * S, 0, 0]),
             ey=np.array([0, 0, 2 * S]), tex=tex(6)),
    ]
    rng = np.random.default_rng(seed + 37)
    for j in range(n_panels):
        a = 2 * np.pi * (j + rng.uniform(-0.2, 0.2)) / max(n_panels, 1)
        r = rng.uniform(0.55, 0.8) * S
        cx, cz = r * np.sin(a), r * np.cos(a)
        pw = rng.uniform(1.0, 1.8)
        ph = rng.uniform(0.8, 1.4)
        y0 = rng.uniform(-0.9, 0.2)
        ex = np.array([np.cos(a), 0.0, -np.sin(a)]) * pw
        ey = np.array([0.0, 1.0, 0.0]) * ph
        quads.append(dict(p0=np.array([cx, y0, cz]) - 0.5 * ex, ex=ex, ey=ey,
                          tex=tex(20 + j)))
    return QuadScene(K, img_wh, quads, exposure_jitter=exposure_jitter, noise=noise,
                     seed=seed, device=device)


def loop_trajectory(n_frames=160, radius=1.6, bob=0.05, start_angle=0.0, loops=1.0):
    """tests/synthetic_scene.loop_trajectory: a circle of `radius` in the
    x-z plane looking radially outward; after `loops` revolutions the camera
    sees the first wall again. Returns (R_cw [N,3,3], t_cw [N,3])."""
    Rs, ts = [], []
    for i in range(n_frames):
        a = start_angle + 2 * np.pi * loops * i / n_frames
        c = np.array([radius * np.sin(a), bob * np.sin(0.21 * i), radius * np.cos(a)])
        zc = np.array([np.sin(a), 0.0, np.cos(a)])
        yc = np.array([0.0, 1.0, 0.0])
        xc = np.cross(yc, zc)
        xc /= np.linalg.norm(xc)
        R_cw = np.stack([xc, yc, zc], axis=1).T
        Rs.append(R_cw)
        ts.append(-R_cw @ c)
    return np.stack(Rs), np.stack(ts)


def train_vocabulary(frames, cfg, branching: int = 8, depth: int = 3, seed: int = 0):
    """A vocabulary trained on the valid ORB descriptors of `frames` (held-
    out views of the scene), extracted with cfg.orb on cfg.K's device: the
    stand-in for the reference's offline ORBvoc, as the JAX tests train
    theirs."""
    from .place import vocab

    dev = cfg.K.device
    descs = []
    for f in frames:
        feats = orb.extract(torch.as_tensor(np.asarray(f), dtype=torch.float32, device=dev),
                            cfg.orb)
        descs.append(feats.descriptors[feats.valid].cpu().numpy())
    return vocab.train(np.concatenate(descs), branching=branching, depth=depth, seed=seed,
                       device=dev)
