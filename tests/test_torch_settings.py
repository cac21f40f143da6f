"""The port's settings files (api/settings.py, no PyYAML) and
System(settings_path) against the JAX package, on inline YAML text (no
file of the reference is read).

Four files: tests/test_api.py's EuRoC 1.0 file (pinhole with rad-tan, IMU
blocks), a TUM-VI-style KB8 stereo file with Camera2 and Stereo.T_c1_c2,
the old EuRoC stereo file's LEFT. / RIGHT. blocks, and a 1.0 file with
Camera.newWidth / newHeight. For each: `_load_yaml` gives the values the
JAX package's PyYAML reading gives, and load_settings / to_tracker_config
equal the JAX package's field by field. System(settings_path) builds the
fisheye rig, the rectifier and the resize from them.
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

from orb_slam3_tpu.api import settings as jset
from orb_slam3_tpu_torch import entry
from orb_slam3_tpu_torch.api import settings as tset
from orb_slam3_tpu_torch.api import system as tsys
from orb_slam3_tpu_torch.tracking import tracker as ttrk
from test_api import EUROC_YAML

torch.set_num_threads(1)

TUMVI_YAML = """%YAML:1.0
File.version: "1.0"
Camera.type: "KannalaBrandt8"
Camera1.fx: 190.978477
Camera1.fy: 190.973307
Camera1.cx: 254.931706
Camera1.cy: 256.897442
Camera1.k1: 0.003482389402
Camera1.k2: 0.000715034845
Camera1.k3: -0.002053236141
Camera1.k4: 0.000202936736
Camera2.fx: 190.442369
Camera2.fy: 190.434438
Camera2.cx: 252.597244
Camera2.cy: 254.917219
Camera2.k1: 0.003400308733
Camera2.k2: 0.001766325680
Camera2.k3: -0.002664381083
Camera2.k4: 0.000335560147
Camera.width: 512
Camera.height: 512
Camera.fps: 20
Camera.RGB: 1
# the right camera in the left camera's frame
Stereo.T_c1_c2: !!opencv-matrix
  rows: 4
  cols: 4
  dt: f
  data: [0.999997256477881, 0.002312067192424, 0.000376008102415, -0.101084154518,
         -0.002317135723281, 0.999898048506644, 0.014089835846648, 0.001988059900656,
         -0.000343393120525, -0.014090668452714, 0.999900662637729, -0.001001025262154,
         0.0, 0.0, 0.0, 1.0]
Stereo.ThDepth: 60.0
IMU.NoiseGyro: 0.00016
IMU.Frequency: 200.0
ORBextractor.nFeatures: 1500
ORBextractor.scaleFactor: 1.2
ORBextractor.nLevels: 8
ORBextractor.iniThFAST: 20
ORBextractor.minThFAST: 7
"""

RESIZE_YAML = EUROC_YAML + "Camera.newWidth: 600\nCamera.newHeight: 350\n"

FILES = {"euroc": EUROC_YAML, "tumvi": TUMVI_YAML, "legacy": entry.euroc_legacy_settings(),
         "resize": RESIZE_YAML}
SENSOR = {"euroc": "mono", "tumvi": "stereo", "legacy": "stereo", "resize": "mono"}


@pytest.fixture(params=sorted(FILES))
def settings_file(request, tmp_path):
    path = tmp_path / f"{request.param}.yaml"
    path.write_text(FILES[request.param])
    return request.param, str(path)


def _same(a, b):
    """A value of the port's reading against PyYAML's (which keeps an
    exponent without a dot, such as 1e-5, as text)."""
    if isinstance(b, dict):
        return isinstance(a, dict) and a.keys() == b.keys() and all(_same(a[k], b[k]) for k in b)
    if isinstance(b, list):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(b, (int, float)) or isinstance(a, (int, float)):
        return float(a) == float(b)
    return a == b


def test_load_yaml_reads_what_pyyaml_reads(settings_file):
    _, path = settings_file
    ours, ref = tset._load_yaml(path), jset._load_yaml(path)
    assert ours.keys() == ref.keys()
    bad = [k for k in ref if not _same(ours[k], ref[k])]
    assert not bad, [(k, ours[k], ref[k]) for k in bad]


def test_load_settings_matches_jax(settings_file):
    name, path = settings_file
    ours, ref = tset.load_settings(path, SENSOR[name]), jset.load_settings(path, SENSOR[name])
    for f in ("sensor", "kind", "width", "height", "fps", "bf", "th_depth", "depth_factor",
              "n_features", "scale_factor", "n_levels", "ini_th_fast", "min_th_fast",
              "imu_freq", "noise_gyro", "noise_acc", "walk_gyro", "walk_acc", "resize_wh"):
        assert getattr(ours, f) == getattr(ref, f), f
    for f in ("K", "dist_coeffs", "Tbc", "K_right", "T_lr"):
        a, b = getattr(ours, f), getattr(ref, f)
        assert (a is None) == (b is None), f
        if b is not None:
            assert a.dtype == np.asarray(b).dtype, f
            np.testing.assert_array_equal(a, np.asarray(b), err_msg=f)
    assert (ours.rect_left is None) == (ref.rect_left is None)
    if ref.rect_left is not None:
        for side in ("rect_left", "rect_right"):
            for k in ("K", "D", "R", "P"):
                np.testing.assert_array_equal(getattr(ours, side)[k], getattr(ref, side)[k])
    assert ours.kind == (1 if name == "tumvi" else 0)
    assert ours.resize_wh == ((600, 350) if name == "resize" else None)
    assert (ours.rect_left is not None) == (name == "legacy")


def test_to_tracker_config_matches_jax(settings_file):
    name, path = settings_file
    s_t, s_j = tset.load_settings(path, SENSOR[name]), jset.load_settings(path, SENSOR[name])
    ours, ref = tset.to_tracker_config(s_t, device="cpu"), jset.to_tracker_config(s_j)
    for f in ("kind", "img_wh", "sensor", "bf", "th_depth", "depth_factor", "stereo_fisheye"):
        assert getattr(ours, f) == getattr(ref, f), f
    for f in ("n_features", "n_levels", "scale_factor", "ini_th_fast", "min_th_fast"):
        assert getattr(ours.orb, f) == getattr(ref.orb, f), f
    for f in ("K", "K_right", "R_rl", "t_rl", "dist_coeffs"):
        a, b = getattr(ours, f), getattr(ref, f)
        assert (a is None) == (b is None), f
        if b is not None:
            assert a.device.type == "cpu" and a.dtype == torch.float32
            np.testing.assert_array_equal(a.numpy(), np.asarray(b, np.float32), err_msg=f)
    assert ours.stereo_fisheye == (name == "tumvi")
    assert (ours.dist_coeffs is not None) == (name in ("euroc", "resize"))
    # the IMU noise densities and the body-camera extrinsics are passed on
    assert ours.imu_noise == ref.imu_noise
    np.testing.assert_array_equal(np.asarray(ours.Tbc), np.asarray(ref.Tbc))


def test_system_from_settings_files(tmp_path, monkeypatch):
    paths = {}
    for name, text in FILES.items():
        paths[name] = tmp_path / f"{name}.yaml"
        paths[name].write_text(text)
    # a KB8 stereo rig: the fisheye-stereo tracker, no rectifier, no resize
    fe = tsys.System(str(paths["tumvi"]), sensor="stereo", device="cpu")
    cfg = fe.tracker.cfg
    assert cfg.stereo_fisheye and fe.rectifier is None and fe._resize_hw is None
    assert cfg.K_right.device.type == "cpu" and cfg.R_rl.shape == (3, 3)
    # the legacy stereo file: the rectifier, the rectified camera LEFT.P and
    # bf from RIGHT.P
    lg = tsys.System(str(paths["legacy"]), sensor="stereo", device="cpu")
    assert lg.rectifier is not None and lg.rectifier.map_l.shape == (480, 752, 2)
    assert lg.tracker.cfg.K[:4].tolist() == list(entry.FULL_K)
    assert abs(lg.tracker.cfg.bf - 450.0 * 0.11) < 1e-9 and lg.tracker.cfg.dist_coeffs is None
    # entry.slam's settings route builds the same session
    sl = entry.slam([], settings_path=str(paths["legacy"]), sensor="stereo", device="cpu")
    assert sl.rectifier is not None and sl.tracker.base_sensor == "stereo"
    with pytest.raises(ValueError, match="not both"):
        entry.slam([], lg.tracker.cfg, settings_path=str(paths["legacy"]), sensor="stereo")
    # the same file read for a monocular sensor does not rectify
    assert tsys.System(str(paths["legacy"]), device="cpu").rectifier is None
    # Camera.newWidth/newHeight: every frame is resized before tracking
    rs = tsys.System(str(paths["resize"]), device="cpu")
    assert rs.tracker.cfg.img_wh == (600, 350) and rs.tracker.cfg.dist_coeffs is not None
    seen = []
    monkeypatch.setattr(rs.tracker, "process",
                        lambda img, ts, **kw: seen.append(tuple(img.shape)))
    rs.track_monocular(np.zeros((480, 752), np.float32), 0.0)
    assert seen == [(350, 600)]
    # an inertial sensor's session takes the file's IMU noise and Tbc
    vi = tsys.System(str(paths["euroc"]), sensor="mono-imu", device="cpu").tracker
    s_vi = tset.load_settings(str(paths["euroc"]), "mono-imu")
    assert vi.cfg.sensor == "mono-imu" and vi.imu.noise["noise_gyro"] == s_vi.noise_gyro
    np.testing.assert_array_equal(vi.imu.Rbc.numpy(), s_vi.Tbc[:3, :3])
    np.testing.assert_array_equal(vi.imu.tbc.numpy(), s_vi.Tbc[:3, 3])
    # a config, when given, is used as is
    cfg_mono = ttrk.TrackerConfig(K=np.asarray([40.0, 40.0, 32.0, 24.0, 0, 0, 0, 0], np.float32),
                                  img_wh=(64, 48), kmax=4, lmax=32)
    assert tsys.System(str(paths["tumvi"]), config=cfg_mono, device="cpu").tracker.cfg.kind == 0
