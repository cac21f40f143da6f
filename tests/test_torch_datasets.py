"""Dataset enumerators, the frame loader and the dataset drivers of the port.

- each enumerator gives the JAX package's FrameData list on a synthetic
  layout written here: EuRoC mono, stereo and with IMU; the TUM RGB-D
  association; KITTI; TUM-VI;
- read_image equals the JAX package's (cv2.IMREAD_GRAYSCALE) on grey and
  colour PNG;
- the twin of tests/test_native_misc.py::test_frameloader_roundtrip. The
  port's loader decodes with its own PNG codec (a CUDA host need not have
  libpng for native/libframeloader.so), so a JPEG is refused, naming the
  file, where the native loader decodes it;
- the EuRoC driver (python -m orb_slam3_tpu_torch.drivers euroc) tracks
  8 frames of a synthetic folder at the small CPU config, writes the
  trajectory and the Atlas, and a second run resumes from that Atlas; the
  evaluate_ate subcommand reads the trajectory back.
"""

import functools
import os
import sys

import cv2
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

from orb_slam3_tpu.api import datasets as jds
from orb_slam3_tpu_torch import drivers, entry
from orb_slam3_tpu_torch.api import datasets as tds
from orb_slam3_tpu_torch.api import settings as tsettings
from orb_slam3_tpu_torch.atlas import invariants as tinv
from orb_slam3_tpu_torch.tracking import tracker as ttrk
from orb_slam3_tpu_torch.utils import png
from orb_slam3_tpu_torch.utils.frameloader import FrameLoader

torch.set_num_threads(2)


def _same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert (x.timestamp, x.img_path, x.img_right_path, x.depth_path) == (
            y.timestamp, y.img_path, y.img_right_path, y.depth_path)
        if x.imu is None or y.imu is None:
            assert x.imu is None and y.imu is None
        else:
            np.testing.assert_array_equal(x.imu, y.imu)


def test_enumerators_match_the_jax_packages(tmp_path):
    rng = np.random.default_rng(0)
    frames = [rng.integers(0, 256, (12, 16)).astype(np.float32) for _ in range(5)]
    t_imu = np.arange(52) * 0.005
    imu = np.concatenate([t_imu[:, None], rng.normal(size=(52, 6))], 1)
    root = str(tmp_path / "euroc")
    entry.write_euroc_folder(root, frames, fps=20.0, right=frames, imu=imu)
    for kw in (dict(), dict(stereo=True), dict(with_imu=True), dict(with_imu=True, stereo=True)):
        _same(tds.load_euroc(root, **kw), jds.load_euroc(root, **kw))
        _same(tds.load_tum_vi(root, **kw), jds.load_tum_vi(root, **kw))
    got = tds.load_euroc(root, with_imu=True)
    assert sum(len(f.imu) for f in got) == sum(imu[:, 0] <= 0.2 + 1e-9)

    tum = tmp_path / "tum"
    tum.mkdir()
    (tum / "rgb.txt").write_text("# color images\n" + "".join(
        f"{1305031102.175304 + 0.033 * i:.6f} rgb/{i}.png\n" for i in range(6)))
    (tum / "depth.txt").write_text("# depth\n" + "".join(
        f"{1305031102.160407 + 0.034 * i:.6f} depth/{i}.png\n" for i in range(0, 6, 2)))
    _same(tds.load_tum_rgbd(str(tum)), jds.load_tum_rgbd(str(tum)))
    assert 0 < len(tds.load_tum_rgbd(str(tum))) < 6

    seq = tmp_path / "kitti" / "sequences" / "03"
    seq.mkdir(parents=True)
    (seq / "times.txt").write_text("".join(f"{0.1 * i:e}\n" for i in range(4)))
    for stereo in (True, False):
        _same(tds.load_kitti(str(tmp_path / "kitti"), "03", stereo),
              jds.load_kitti(str(tmp_path / "kitti"), "03", stereo))


def test_read_image_matches_the_jax_package(tmp_path):
    rng = np.random.default_rng(1)
    for name, img in (("g.png", rng.integers(0, 256, (20, 30)).astype(np.uint8)),
                      ("c.png", rng.integers(0, 256, (20, 30, 3)).astype(np.uint8))):
        p = str(tmp_path / name)
        cv2.imwrite(p, img)
        got, want = tds.read_image(p), jds.read_image(p)
        assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
        assert np.abs(got - want).max() <= (0 if img.ndim == 2 else 1)
    depth = rng.integers(0, 65536, (20, 30)).astype(np.uint16)
    cv2.imwrite(str(tmp_path / "d.png"), depth)
    np.testing.assert_array_equal(tds.read_depth(str(tmp_path / "d.png")),
                                  depth.astype(np.float32))
    with pytest.raises(FileNotFoundError):
        tds.read_image(str(tmp_path / "missing.png"))


def test_frameloader_roundtrip(tmp_path):
    """tests/test_native_misc.py::test_frameloader_roundtrip on the port's
    loader: 6 PNG (cv2-written) and a PGM decode exactly, in order, through
    a queue shallower than the sequence; a JPEG raises naming the file."""
    rng = np.random.default_rng(0)
    paths, imgs = [], []
    for i in range(6):
        img = rng.integers(0, 255, (48, 64), dtype=np.uint8)
        p = str(tmp_path / f"f{i}.png")
        cv2.imwrite(p, img)
        paths.append(p)
        imgs.append(img)
    pp = str(tmp_path / "p.pgm")
    cv2.imwrite(pp, imgs[1])
    paths.append(pp)
    loader = FrameLoader(paths, n_threads=2, queue_depth=3)
    out = list(loader)
    assert len(out) == 7
    for i in range(6):
        assert out[i].dtype == np.float32
        np.testing.assert_array_equal(out[i].astype(np.uint8), imgs[i])
    np.testing.assert_array_equal(out[6].astype(np.uint8), imgs[1])
    loader.close()
    pj = str(tmp_path / "j.jpg")
    cv2.imwrite(pj, imgs[0])
    with FrameLoader([paths[0], pj], n_threads=2, queue_depth=2) as loader:
        np.testing.assert_array_equal(next(loader).astype(np.uint8), imgs[0])
        with pytest.raises(IOError, match="j.jpg"):
            next(loader)


def test_euroc_driver_runs_and_resumes_on_the_cpu(tmp_path, capsys, monkeypatch):
    """8 PlaneScene frames written as a EuRoC folder, the driver at the
    small CPU config (256x192, OrbConfig(300, 4) from the settings file;
    kmax 16, lmax 1024, window 4 and the deterministic schedule set on
    the config the settings file gives): the session initializes and
    tracks, the trajectory and the Atlas are written, a second run
    resumes from the Atlas."""
    wh, K = (256, 192), (200.0, 200.0, 128.0, 96.0)
    frames, _, _, _ = entry.plane_sequence(8, img_wh=wh, K=K)
    root = str(tmp_path / "seq")
    entry.write_euroc_folder(root, frames)
    yaml = tmp_path / "cam.yaml"
    yaml.write_text(entry.pinhole_settings(K, wh, n_features=300, n_levels=4))
    monkeypatch.setattr(tsettings, "to_tracker_config", functools.partial(
        tsettings.to_tracker_config, kmax=16, lmax=1024, local_window=4,
        deterministic_mapping=True, pipeline_depth=1))
    out, atlas = str(tmp_path / "traj.txt"), str(tmp_path / "atlas.npz")
    res = drivers.run_euroc(root, str(yaml), "mono", out=out, atlas_out=atlas, device="cpu",
                            log=lambda *a: None)
    tr = res["system"].tracker
    assert res["frames"] == 8 and res["fps"] > 0 and tr.async_mapper is None
    assert tr.state == ttrk.OK and int(tr.map.kf_valid.sum()) >= 2
    assert res["save_atlas_bytes"] == os.path.getsize(atlas) > 0
    n_lines = sum(1 for ln in open(out) if not ln.startswith("#"))
    assert n_lines >= 3
    # the session ran in seconds since the first frame (float32 keyframe
    # times stay apart); the file carries the dataset's own times
    assert res["time_origin"] == tds.load_euroc(root)[0].timestamp > 1.4e9
    assert not tinv.check_all(tr.map)
    kf_ts = tr.map.kf_timestamp[tr.map.kf_valid]
    assert float(kf_ts.max()) < 1.0 and bool((kf_ts[1:] > kf_ts[:-1]).all())
    first = float(open(out).read().split("\n")[0].split()[0])
    assert abs(first - res["time_origin"]) < 1.0
    # a resumed run of 2 frames, and the ATE subcommand
    drivers.run_euroc(root, str(yaml), "mono", out=str(tmp_path / "t2.txt"), atlas_in=atlas,
                      max_frames=2, device="cpu", log=lambda *a: None)
    assert drivers.main(["evaluate_ate", out, out]) == 0
    assert "absolute_translational_error.rmse 0.000000" in capsys.readouterr().out


def test_write_euroc_folder_is_read_back_exactly(tmp_path):
    rng = np.random.default_rng(2)
    frames = [rng.uniform(0, 255, (24, 32)).astype(np.float32) for _ in range(3)]
    root = str(tmp_path / "e")
    ts = entry.write_euroc_folder(root, frames)
    fr = tds.load_euroc(root)
    assert [os.path.basename(f.img_path) for f in fr] == [f"{t}.png" for t in ts]
    np.testing.assert_allclose([f.timestamp for f in fr], np.asarray(ts) * 1e-9, rtol=1e-15)
    for f, img in zip(fr, frames):
        np.testing.assert_array_equal(png.read(f.img_path), np.rint(img).astype(np.uint8))
