"""Settings files: the reference's YAML configuration (port of
orb_slam3_tpu/api/settings.py).

The role of the `Settings` class (`Settings.cc`, `Settings.h`): typed
parsing of the "File.version 1.0" schema (cameras and distortion, stereo
bf / thDepth, IMU noise and Tbc, ORB extractor, RGB-D depth factor,
`Camera2` with `Stereo.T_c1_c2`, `Camera.newWidth/newHeight`) and of the
legacy flat keys of `Tracking::ParseCamParamFile`, with the old EuRoC
stereo file's `LEFT.` / `RIGHT.` rectification blocks. The OpenCV-flavoured
YAML (a %YAML directive, `!!opencv-matrix` mappings, `data:[` without a
space) is read by `_load_yaml`, a few regular expressions for the subset
those files use; nothing here needs PyYAML or OpenCV.
"""

from __future__ import annotations

import dataclasses
import re

import numpy as np
import torch

from .. import device as device_mod
from ..frontend import camera as cam

_KEY = re.compile(r"([A-Za-z_][\w.]*)\s*:(.*)")
_INT = re.compile(r"[-+]?\d+")
_ITEM = re.compile(r"(\w+)\s*:\s*(\[[^\]]*\]|[^\n]*)")


@dataclasses.dataclass
class SlamSettings:
    sensor: str = "mono"
    kind: int = cam.PINHOLE
    K: np.ndarray = None                  # [8] fx fy cx cy (k0..k3 for KB8)
    dist_coeffs: np.ndarray = None        # [5] rad-tan k1 k2 p1 p2 k3
    width: int = 640
    height: int = 480
    fps: float = 30.0
    bf: float = 0.0
    th_depth: float = 40.0
    depth_factor: float = 1.0
    # ORB
    n_features: int = 1000
    scale_factor: float = 1.2
    n_levels: int = 8
    ini_th_fast: int = 20
    min_th_fast: int = 7
    # IMU (the TrackerConfig's imu_noise and Tbc)
    imu_freq: float = 200.0
    noise_gyro: float = 1.7e-4
    noise_acc: float = 2e-3
    walk_gyro: float = 1.9e-5
    walk_acc: float = 3e-3
    Tbc: np.ndarray = None                # [4, 4]
    # non-rectified (fisheye) stereo: the right camera and T_c1_c2
    # (left-from-right, `Stereo.T_c1_c2`, Settings.cc readCamera2)
    K_right: np.ndarray = None            # [8]
    T_lr: np.ndarray = None               # [4, 4]
    # the legacy rectified-stereo blocks (LEFT./RIGHT. K, D, R, P of the old
    # EuRoC.yaml, Examples_old/Stereo/EuRoC.yaml:50-81): both images are
    # remapped before tracking (System.cc:253-265)
    rect_left: dict = None                # {K [3,3], D, R [3,3], P [3,4]}
    rect_right: dict = None
    # Camera.newWidth/newHeight (Settings.cc:384-409): images are resized
    # before tracking and the calibration scaled with them
    resize_wh: tuple = None               # (new_w, new_h) or None


def _scalar(tok: str):
    """A YAML scalar: a quoted string, an int, a float, else the bare text."""
    tok = tok.strip()
    if len(tok) >= 2 and tok[0] == tok[-1] and tok[0] in "\"'":
        return tok[1:-1]
    if _INT.fullmatch(tok):
        return int(tok)
    try:
        return float(tok)
    except ValueError:
        return tok


def _flow_list(text: str):
    """`[a, b, ...]` -> list of scalars."""
    inner = text.strip()[1:-1]
    return [_scalar(x) for x in inner.split(",") if x.strip()]


def _value(first: str, rest: list):
    """The value of one top-level key: the text after its colon and its
    indented continuation lines."""
    first = first.replace("!!opencv-matrix", "").strip()
    if not first and rest:  # an indented mapping (an opencv-matrix)
        return {k: _flow_list(v) if v.startswith("[") else _scalar(v)
                for k, v in _ITEM.findall("\n".join(ln.strip() for ln in rest))}
    text = " ".join([first] + [ln.strip() for ln in rest])
    return _flow_list(text) if text.startswith("[") else _scalar(text)


def _parse_yaml(text: str) -> dict:
    """The top-level keys of an OpenCV-flavoured YAML text -> {key: value}:
    scalars, flow lists, and `!!opencv-matrix` mappings as dicts of rows,
    cols, dt and data. Comments and the %YAML directive are dropped."""
    out, key, first, rest, depth = {}, None, "", [], 0
    for line in text.splitlines():
        line = re.sub(r"(^|\s)#.*$", "", line).rstrip()
        if not line.strip() or line.startswith("%") or line.strip() == "---":
            continue
        m = _KEY.fullmatch(line)
        if m and depth == 0:
            if key is not None:
                out[key] = _value(first, rest)
            key, first, rest = m.group(1), m.group(2), []
        elif key is not None:
            rest.append(line)
        depth += line.count("[") - line.count("]")
    if key is not None:
        out[key] = _value(first, rest)
    return out


def _load_yaml(path: str) -> dict:
    """Read a reference-format settings file (see _parse_yaml)."""
    with open(path) as f:
        return _parse_yaml(f.read())


def _vec8(*values) -> np.ndarray:
    return np.array(list(values) + [0.0] * (8 - len(values)), np.float32)


def load_settings(path: str, sensor: str = "mono") -> SlamSettings:
    """Parse the settings file at `path` for `sensor` ("mono", "stereo",
    "rgbd", or one of them with "-imu")."""
    d = _load_yaml(path)

    def get(*keys, default=None):
        for k in keys:
            if k in d and d[k] is not None:
                return d[k]
        return default

    s = SlamSettings(sensor=sensor)
    cam_type = str(get("Camera.type", "Camera1.type", default="PinHole"))
    s.kind = cam.KB8 if "Kannala" in cam_type else cam.PINHOLE

    fx = float(get("Camera1.fx", "Camera.fx", default=450.0))
    fy = float(get("Camera1.fy", "Camera.fy", default=450.0))
    cx = float(get("Camera1.cx", "Camera.cx", default=320.0))
    cy = float(get("Camera1.cy", "Camera.cy", default=240.0))
    if s.kind == cam.KB8:
        k = [float(get(f"Camera1.k{i + 1}", f"Camera.k{i + 1}", default=0.0)) for i in range(4)]
        s.K = _vec8(fx, fy, cx, cy, *k)
        s.dist_coeffs = np.zeros(5, np.float32)
    else:
        s.K = _vec8(fx, fy, cx, cy)
        s.dist_coeffs = np.array(
            [float(get(f"Camera1.{n}", f"Camera.{n}", default=0.0))
             for n in ("k1", "k2", "p1", "p2", "k3")], np.float32)

    s.width = int(get("Camera.width", default=640))
    s.height = int(get("Camera.height", default=480))
    s.fps = float(get("Camera.fps", default=30.0))
    s.bf = float(get("Camera.bf", "Stereo.b", default=0.0))
    if get("Stereo.b") is not None and get("Camera.bf") is None:
        s.bf = float(get("Stereo.b")) * fx
    s.th_depth = float(get("Stereo.ThDepth", "ThDepth", default=40.0))
    s.depth_factor = 1.0 / float(get("RGBD.DepthMapFactor", "DepthMapFactor", default=1.0))

    s.n_features = int(get("ORBextractor.nFeatures", default=1000))
    s.scale_factor = float(get("ORBextractor.scaleFactor", default=1.2))
    s.n_levels = int(get("ORBextractor.nLevels", default=8))
    s.ini_th_fast = int(get("ORBextractor.iniThFAST", default=20))
    s.min_th_fast = int(get("ORBextractor.minThFAST", default=7))

    s.imu_freq = float(get("IMU.Frequency", default=200.0))
    s.noise_gyro = float(get("IMU.NoiseGyro", default=1.7e-4))
    s.noise_acc = float(get("IMU.NoiseAcc", default=2e-3))
    s.walk_gyro = float(get("IMU.GyroWalk", default=1.9e-5))
    s.walk_acc = float(get("IMU.AccWalk", default=3e-3))

    # the second (right) camera of a non-rectified rig
    if get("Camera2.fx") is not None:
        K2 = [float(get(f"Camera2.{n}")) for n in ("fx", "fy", "cx", "cy")]
        if s.kind == cam.KB8:
            K2 += [float(get(f"Camera2.k{i + 1}", default=0.0)) for i in range(4)]
        s.K_right = _vec8(*K2)
        tlr = get("Stereo.T_c1_c2", "Tlr")
        if isinstance(tlr, dict) and "data" in tlr:
            rows = 4 if len(tlr["data"]) == 16 else 3
            s.T_lr = np.eye(4, dtype=np.float32)
            s.T_lr[:rows] = np.array(tlr["data"], np.float32).reshape(rows, 4)
        elif tlr is not None:
            s.T_lr = np.array(tlr, np.float32).reshape(4, 4)

    def mat(key):
        m = get(key)
        if isinstance(m, dict) and "data" in m:
            return np.array(m["data"], np.float64).reshape(int(m.get("rows", 3)),
                                                          int(m.get("cols", 3)))
        return np.asarray(m, np.float64) if m is not None else None

    if get("LEFT.K") is not None:
        s.rect_left = {k: mat(f"LEFT.{k}") for k in ("K", "D", "R", "P")}
        s.rect_right = {k: mat(f"RIGHT.{k}") for k in ("K", "D", "R", "P")}
        # after rectification the camera is LEFT.P without distortion, and
        # bf is RIGHT.P[0, 3] = -fx * baseline
        P = s.rect_left["P"]
        s.K = _vec8(P[0, 0], P[1, 1], P[0, 2], P[1, 2])
        s.dist_coeffs = np.zeros(5, np.float32)
        if s.bf == 0.0 and s.rect_right["P"] is not None:
            s.bf = float(abs(s.rect_right["P"][0, 3]))
        s.width = int(get("LEFT.width", default=s.width))
        s.height = int(get("LEFT.height", default=s.height))

    tbc = get("IMU.T_b_c1", "Tbc")
    if isinstance(tbc, dict) and "data" in tbc:
        s.Tbc = np.array(tbc["data"], np.float32).reshape(4, 4)
    elif tbc is not None:
        s.Tbc = np.array(tbc, np.float32).reshape(4, 4)
    else:
        s.Tbc = np.eye(4, dtype=np.float32)

    # Camera.newWidth/newHeight, applied last so that every quantity above
    # is at the original size; not with the legacy rectification blocks
    # (the reference rectifies at the original size in that schema)
    nw, nh = get("Camera.newWidth"), get("Camera.newHeight")
    if (nw is not None or nh is not None) and s.rect_left is None:
        nw = int(nw) if nw is not None else s.width
        nh = int(nh) if nh is not None else s.height
        sx, sy = nw / s.width, nh / s.height
        for Karr in (s.K, s.K_right):
            if Karr is not None:
                Karr[0] *= sx
                Karr[2] *= sx
                Karr[1] *= sy
                Karr[3] *= sy
        s.bf *= sx
        s.resize_wh = (nw, nh)
        s.width, s.height = nw, nh
    return s


def to_tracker_config(s: SlamSettings, device=None, **overrides):
    """The port's TrackerConfig for settings `s`, its tensors on `device`
    (default CUDA). A KB8 stereo rig with a right camera and T_c1_c2
    becomes a fisheye-stereo config (R_rl = R_lr^T, t_rl = -R_lr^T t_lr,
    bf = |t_lr| fx unless the file gives one); a pinhole camera with
    rad-tan coefficients gets its keypoints undistorted; the IMU noise
    densities and Tbc are passed on. `overrides` set any field
    afterwards."""
    from ..frontend import orb as orb_mod
    from ..tracking import tracker as trk

    dev = device_mod.resolve(device)
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)  # noqa: E731
    cfg = trk.TrackerConfig(
        K=f32(s.K), kind=s.kind, img_wh=(s.width, s.height), sensor=s.sensor, bf=s.bf,
        th_depth=s.th_depth, depth_factor=s.depth_factor,
        orb=orb_mod.OrbConfig(n_features=s.n_features, n_levels=s.n_levels,
                              scale_factor=s.scale_factor, ini_th_fast=float(s.ini_th_fast),
                              min_th_fast=float(s.min_th_fast)),
        imu_noise=dict(noise_gyro=s.noise_gyro, noise_acc=s.noise_acc,
                       walk_gyro=s.walk_gyro, walk_acc=s.walk_acc),
        Tbc=s.Tbc,
    )
    if (s.kind == cam.PINHOLE and s.dist_coeffs is not None
            and float(np.abs(s.dist_coeffs).max()) > 0):
        cfg.dist_coeffs = f32(s.dist_coeffs)
    if (s.sensor.startswith("stereo") and s.kind == cam.KB8
            and s.K_right is not None and s.T_lr is not None):
        R_lr, t_lr = s.T_lr[:3, :3], s.T_lr[:3, 3]
        cfg.stereo_fisheye = True
        cfg.K_right = f32(s.K_right)
        cfg.R_rl = f32(R_lr.T)
        cfg.t_rl = f32(-R_lr.T @ t_lr)
        if cfg.bf <= 0:
            # a virtual bf for the inverse-depth binding of the
            # triangulated depth, from the rig's baseline
            cfg.bf = float(np.linalg.norm(t_lr)) * float(s.K[0])
    for k, v in overrides.items():
        setattr(cfg, k, v)
    return cfg
