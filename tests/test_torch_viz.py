"""The port's PNG codec, map exports and live viewer.

- utils/png against cv2 (installed on this host): exact on 8- and 16-bit
  grey files the port wrote with each of the five row filters, on files
  cv2 wrote (grey, RGB, RGBA, 16-bit), within 1 grey level on colour to
  grey (cv2.IMREAD_GRAYSCALE); a JPEG is refused with its name;
- save_map_ply writes the JAX package's bytes for the same converted map,
  and map_3d_payload its numbers within 1e-6;
- twins of tests/test_api.py::test_live_viewer_serves_map_and_stats (on
  127.0.0.1, port 0) and ::test_save_map_3d on a port session at the small
  CPU config.
"""

import json
import os
import re
import sys
import urllib.request

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

from orb_slam3_tpu.api import viz as jviz
from orb_slam3_tpu.atlas import state as jstate
from orb_slam3_tpu_torch import convert, entry
from orb_slam3_tpu_torch.api import viz as tviz
from orb_slam3_tpu_torch.api.system import System
from orb_slam3_tpu_torch.frontend import orb as torb
from orb_slam3_tpu_torch.tracking import tracker as ttrk
from orb_slam3_tpu_torch.utils import png

torch.set_num_threads(2)
K_NP = np.asarray([200.0, 200.0, 128.0, 96.0, 0, 0, 0, 0], np.float32)
WH = (256, 192)


# ---------------------------------------------------------------------------
# the codec
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("filter_type", [0, 1, 2, 3, 4])
def test_codec_matches_cv2_for_each_filter(tmp_path, filter_type):
    rng = np.random.default_rng(filter_type)
    g8 = rng.integers(0, 256, (37, 53)).astype(np.uint8)
    g8[10:20] = np.linspace(0, 255, 53).astype(np.uint8)  # smooth rows
    g16 = rng.integers(0, 65536, (29, 31)).astype(np.uint16)
    rgb = rng.integers(0, 256, (21, 27, 3)).astype(np.uint8)
    for name, img in (("g8", g8), ("g16", g16), ("rgb", rgb)):
        p = str(tmp_path / f"{name}.png")
        png.write(p, img, filter_type)
        want = cv2.imread(p, cv2.IMREAD_UNCHANGED)
        if want.ndim == 3:
            want = want[..., ::-1]  # cv2 reads BGR
        np.testing.assert_array_equal(want, img, err_msg=name)
        np.testing.assert_array_equal(png.read(p), img, err_msg=name)
        gray = cv2.imread(p, cv2.IMREAD_GRAYSCALE).astype(int)
        diff = np.abs(png.read_gray(p).astype(int) - gray).max()
        assert diff <= (0 if img.ndim == 2 else 1), (name, diff)


def test_codec_reads_what_cv2_writes(tmp_path):
    rng = np.random.default_rng(7)
    smooth = (np.linspace(0, 255, 120)[None] * np.linspace(0.2, 1, 90)[:, None]
              + rng.normal(0, 3, (90, 120))).clip(0, 255)
    cases = {"g8": smooth.astype(np.uint8),
             "g16": (smooth * 250).astype(np.uint16),
             "bgr": rng.integers(0, 256, (33, 57, 3)).astype(np.uint8),
             "bgra": rng.integers(0, 256, (33, 57, 4)).astype(np.uint8),
             "bgr16": rng.integers(0, 65536, (20, 21, 3)).astype(np.uint16)}
    for name, img in cases.items():
        for level in (0, 3, 9):
            p = str(tmp_path / f"{name}_{level}.png")
            cv2.imwrite(p, img, [cv2.IMWRITE_PNG_COMPRESSION, level])
            want = cv2.imread(p, cv2.IMREAD_UNCHANGED)
            got = png.read(p)
            if want.ndim == 3:  # the codec keeps the file's RGB(A) order
                want = want[..., [2, 1, 0, 3][:want.shape[2]]]
            np.testing.assert_array_equal(got, want, err_msg=p)
            gray = cv2.imread(p, cv2.IMREAD_GRAYSCALE).astype(int)
            diff = np.abs(png.read_gray(p).astype(int) - gray).max()
            assert diff <= (0 if img.ndim == 2 else 1), (p, diff)
    ok, jpg = cv2.imencode(".jpg", cases["g8"])
    p = str(tmp_path / "frame.jpg")
    with open(p, "wb") as f:
        f.write(jpg.tobytes())
    with pytest.raises(png.PNGError, match="frame.jpg: JPEG"):
        png.read(p)


# ---------------------------------------------------------------------------
# the exports against the JAX package's
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def session():
    """A port RGB-D session of 5 frames at the small CPU config (the
    reference viewer test's orbit), with the live viewer serving."""
    cfg = ttrk.TrackerConfig(K=convert.camera(K_NP, "cpu"), img_wh=WH,
                             orb=torb.OrbConfig(300, 4), kmax=16, lmax=1024, local_window=4,
                             sensor="rgbd", bf=20.0, th_depth=20.0, deterministic_mapping=True,
                             pipeline_depth=1)
    sys_ = System(config=cfg)
    viewer = sys_.start_viewer(port=0)
    planes = entry.plane_scene(11)
    R, t = entry.orbit_trajectory(5)
    for i in range(5):
        img, depth = entry.render_with_depth(planes, tuple(K_NP[:4]), WH, R[i], t[i])
        sys_.track_rgbd(img, depth, i * 0.05)
    yield sys_, viewer
    sys_.shutdown()


def _jax_map(s):
    return jstate.MapState(**{k: jnp.asarray(v) for k, v in convert.map_state_arrays(s).items()})


def test_ply_and_payload_equal_the_jax_packages(session, tmp_path):
    sys_, _ = session
    sys_.tracker.sync_mapping()
    s = sys_.tracker.map
    js = _jax_map(s)
    tviz.save_map_ply(str(tmp_path / "port.ply"), s)
    jviz.save_map_ply(str(tmp_path / "jax.ply"), js)
    got, want = (open(tmp_path / n, "rb").read() for n in ("port.ply", "jax.ply"))
    assert got == want and got.count(b"\n") > 50
    traj = np.random.default_rng(0).normal(size=(6, 3)).astype(np.float32)
    a, b = tviz.map_3d_payload(s, traj), jviz.map_3d_payload(js, traj)
    assert a.keys() == b.keys()
    for k in a:
        if k in ("edges", "colors", "palette"):
            assert a[k] == b[k], k
        else:
            np.testing.assert_allclose(np.asarray(a[k], float), np.asarray(b[k], float),
                                       rtol=0, atol=1e-6, err_msg=k)
    # the renders: the size, the keyframes drawn in red, landmarks in map 0's colour
    img = tviz.render_topdown(s, traj, size=300)
    assert img.shape == (300, 300, 3)
    assert ((img == [255, 0, 0]).all(-1)).sum() > 0
    assert ((img == tviz._MAP_COLORS[0]).all(-1)).sum() > 20


def test_live_viewer_serves_map_and_stats(session):
    """tests/test_api.py::test_live_viewer_serves_map_and_stats on the port."""
    sys_, viewer = session
    base = f"http://127.0.0.1:{viewer.port}"
    stats = json.loads(urllib.request.urlopen(base + "/stats.json", timeout=10).read())
    assert stats["state"] == "OK" and stats["n_keyframes"] >= 1
    for ep in ("/map.png", "/frame.png"):
        body = urllib.request.urlopen(base + ep, timeout=30).read()
        assert body[:8] == png.SIGNATURE
        assert png.decode(body).ndim == 3
    frame = png.decode(urllib.request.urlopen(base + "/frame.png", timeout=30).read())
    assert frame.shape == (WH[1], WH[0], 3)
    urllib.request.urlopen(base + "/cmd?localization=1", timeout=10).read()
    assert sys_.localization_only
    urllib.request.urlopen(base + "/cmd?localization=0", timeout=10).read()
    assert not sys_.localization_only
    page = urllib.request.urlopen(base, timeout=10).read()
    assert b"live session" in page
    html3d = urllib.request.urlopen(base + "/map3d", timeout=30).read()
    assert b"kf_centers" in html3d and b"orbit" in html3d


def test_save_map_3d(session, tmp_path):
    """tests/test_api.py::test_save_map_3d on the port."""
    sys_, _ = session
    path = str(tmp_path / "map.html")
    sys_.save_map_3d(path)
    html = open(path).read()
    m = re.search(r'<script id="scene" type="application/json">(.*?)</script>', html, re.S)
    assert m, "embedded scene JSON missing"
    scene = json.loads(m.group(1))
    assert len(scene["points"]) > 50
    assert len(scene["kf_centers"]) >= 1
    assert len(scene["kf_rot"]) == len(scene["kf_centers"])
    assert len(scene["trajectory"]) >= 5


@pytest.mark.parametrize("kinds", [(0, 1, 2), (0, 1, 2, 3, 4)])
def test_codec_reads_rows_of_mixed_filters(tmp_path, kinds):
    """Runs of Up rows after None and Sub rows (the running-sum path) and
    rows of all five filters (the wavefront path), as adaptive encoders
    write them, against cv2."""
    rng = np.random.default_rng(len(kinds))
    for img in (rng.integers(0, 256, (41, 37)).astype(np.uint8),
                rng.integers(0, 256, (23, 19, 3)).astype(np.uint8),
                rng.integers(0, 65536, (17, 13)).astype(np.uint16)):
        rows = rng.choice(kinds, img.shape[0])
        rows[3:9] = 2   # a run of Up rows
        rows[0] = 2     # an Up row on the zero row above the image
        p = str(tmp_path / "mixed.png")
        with open(p, "wb") as f:
            f.write(png.encode(img, rows))
        want = cv2.imread(p, cv2.IMREAD_UNCHANGED)
        np.testing.assert_array_equal(want[..., ::-1] if want.ndim == 3 else want, img)
        np.testing.assert_array_equal(png.read(p), img)
