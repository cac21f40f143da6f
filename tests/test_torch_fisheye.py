"""The port's KB8 fisheye-stereo path against the JAX package, on the same
numpy inputs.

- match_stereo_fisheye on test_stereo_fisheye.py's inputs (TUM-VI-like
  calibrations, 200 points up to ~50 deg off the axis, 11 cm baseline):
  good equal, depth within 1e-4 relative, and that test's gates.
- KB8 pose_optimize and pose_optimize_stereo (no kernel: plain torch ops):
  inlier masks equal, R within 1e-4 and t within 1e-3 of the JAX XLA path.
- pose_optimize_two_cam at KB8 on test_tobody.py's divergent rig: the
  right-only features carry the solve as there (> 40 right inliers, pose
  within 1e-3 of the truth), and the JAX result within R 1e-4 / t 1e-3.
- The mapping stages at KB8, at the tolerances of test_torch_mapping.py /
  test_torch_depth_mapping.py: triangulate_pair and local_ba on a KB8 map
  built from projections; slow: triangulate_pair(use_depth) and
  local_ba(stereo) on the state before the last keyframe of a port
  fisheye session (256x192, OrbConfig(300, 4), kmax 8, lmax 1024,
  window 4).
- A fisheye-stereo session through System(settings_path) against the JAX
  Tracker (async_mapping=False, pipeline_depth=1) on the same features:
  states, inliers and poses (atol 1e-4), slow (3 frames at 256x192, and
  test_slam_fisheye.py's size, 512x384, 10 frames: the JAX compile of the
  tracker's stereo init and fused step is most of it); Tier-1 runs the 3
  frames on the port alone with test_slam_fisheye.py's gates.
"""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

from orb_slam3_tpu.api import settings as jsettings
from orb_slam3_tpu.atlas import ops as jops
from orb_slam3_tpu.frontend import camera as jcam
from orb_slam3_tpu.frontend import orb as jorb
from orb_slam3_tpu.frontend import stereo as jstereo
from orb_slam3_tpu.mapping import local_mapper as jlm
from orb_slam3_tpu.mapping import pipeline as jpipe
from orb_slam3_tpu.ops import lie as jlie
from orb_slam3_tpu.tracking import track as jtrack
from orb_slam3_tpu.tracking import tracker as jtrk
from orb_slam3_tpu_torch import convert, entry
from orb_slam3_tpu_torch.api import evaluate as teval
from orb_slam3_tpu_torch.api import system as tsys
from orb_slam3_tpu_torch.frontend import camera as tcam
from orb_slam3_tpu_torch.frontend import orb as torb
from orb_slam3_tpu_torch.frontend import stereo as tstereo
from orb_slam3_tpu_torch.mapping import local_mapper as tlm
from orb_slam3_tpu_torch.mapping import pipeline as tpipe
from orb_slam3_tpu_torch.tracking import track as ttrack
from orb_slam3_tpu_torch.tracking import tracker as ttrk
from test_torch_mapping import jax_add_observations_ok_only, jax_map, jax_package

torch.set_num_threads(1)
BASE = 0.3  # test_slam_fisheye.py's baseline
K8_SMALL = np.asarray([200.0, 200.0, 128.0, 96.0, 0.01, -0.005, 0.002, -0.001], np.float32)
K8_FULL = np.asarray([260.0, 260.0, 256.0, 192.0, 0.01, -0.005, 0.002, -0.001], np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------- stereo
def _stereo_inputs():
    """test_stereo_fisheye.py's points, projections and descriptors."""
    K_L = np.asarray([190.98, 190.97, 254.93, 256.90, 0.00348, 0.000715, -0.00205, 0.000841],
                     np.float32)
    K_R = np.asarray([190.44, 190.44, 252.59, 254.99, 0.00340, 0.000772, -0.00213, 0.000870],
                     np.float32)
    rng = np.random.default_rng(0)
    N = 200
    theta = rng.uniform(0, 0.9, N)
    phi = rng.uniform(0, 2 * np.pi, N)
    z = rng.uniform(1.0, 6.0, N)
    r = z * np.tan(theta)
    X_l = np.stack([r * np.cos(phi), r * np.sin(phi), z], -1)
    R_rl = np.array(jlie.so3_exp(jnp.asarray([0.004, -0.01, 0.002])))
    t_rl = np.array([-0.11, 0.0005, -0.001])
    X_r = X_l @ R_rl.T + t_rl
    uv_l = np.array(jcam.kb8_project(jnp.asarray(K_L), jnp.asarray(X_l, jnp.float32)))
    uv_r = np.array(jcam.kb8_project(jnp.asarray(K_R), jnp.asarray(X_r, jnp.float32)))
    keep = ((uv_l > 5).all(1) & (uv_l < 507).all(1) & (uv_r > 5).all(1) & (uv_r < 507).all(1)
            & (X_r[:, 2] > 0.2))
    desc = rng.integers(0, 256, (N, 32), dtype=np.uint8)
    uv_l += 0.2 * rng.standard_normal((N, 2))
    uv_r += 0.2 * rng.standard_normal((N, 2))
    args = (K_L, K_R, R_rl.astype(np.float32), t_rl.astype(np.float32),
            uv_l.astype(np.float32), desc, keep, uv_r.astype(np.float32), desc, keep)
    return args, X_l, keep


def test_match_stereo_fisheye_matches_jax():
    args, X_l, keep = _stereo_inputs()
    dj, gj = (np.asarray(a) for a in jstereo.match_stereo_fisheye(
        jcam.KB8, *(jnp.asarray(a) for a in args)))
    dt, gt = (a.numpy() for a in tstereo.match_stereo_fisheye(tcam.KB8, *(_t(a) for a in args)))
    np.testing.assert_array_equal(gt, gj)
    np.testing.assert_allclose(dt[gt], dj[gt], rtol=1e-4, atol=0)
    assert (dt[~gt] == 0).all()
    # test_stereo_fisheye.py's gates, on the port
    near = keep & (X_l[:, 2] < 3.0)
    assert near.sum() > 40 and gt[near].mean() > 0.9
    rel = np.abs(dt[gt] - X_l[gt, 2]) / X_l[gt, 2]
    assert np.median(rel) < 0.06 and rel.mean() < 0.15
    assert not gt[~keep].any()


def test_match_stereo_fisheye_ties_take_the_lower_index():
    """Two right keypoints with the left keypoint's descriptor: the ratio
    test refuses the match on both sides; a near-tie (one bit apart) keeps
    the lower-distance one, whatever its index."""
    args, _, _ = _stereo_inputs()
    args = list(args)
    desc_r = args[8].copy()
    desc_r[1] = desc_r[0]             # exact tie for left keypoint 0
    desc_r[3] = desc_r[2]
    desc_r[3, 0] ^= 1                 # right 3 one bit from left 2's partner
    args[8] = desc_r
    dj, gj = (np.asarray(a) for a in jstereo.match_stereo_fisheye(
        jcam.KB8, *(jnp.asarray(a) for a in args)))
    dt, gt = (a.numpy() for a in tstereo.match_stereo_fisheye(tcam.KB8, *(_t(a) for a in args)))
    np.testing.assert_array_equal(gt, gj)
    np.testing.assert_allclose(dt[gt], dj[gt], rtol=1e-4, atol=0)
    assert not gt[0]


# ---------------------------------------------------------------- pose BA
def _pose_case(stereo: bool, seed=1, n=400):
    rng = np.random.default_rng(seed)
    X = np.concatenate([rng.uniform(-4, 4, (n, 2)), rng.uniform(2, 8, (n, 1))], 1)
    R_true = np.asarray(jlie.so3_exp(jnp.asarray([0.02, -0.03, 0.01])), np.float64)
    t_true = np.array([0.05, -0.02, 0.08])
    Xc = X @ R_true.T + t_true
    uv = np.asarray(jcam.kb8_project(jnp.asarray(K8_FULL), jnp.asarray(Xc, jnp.float32)))
    uv = uv + 0.5 * rng.standard_normal(uv.shape)
    bad = rng.random(n) < 0.1
    uv[bad] += rng.uniform(-30, 30, (bad.sum(), 2))   # outliers
    valid = rng.random(n) < 0.9
    octv = rng.integers(0, 4, n)
    inv = (1.0 / 1.2 ** (2 * octv)).astype(np.float32)
    R0 = np.asarray(jlie.so3_exp(jnp.asarray([0.01, 0.02, -0.01])), np.float32) @ R_true
    t0 = t_true + np.array([0.03, -0.02, 0.02])
    f = lambda a: np.asarray(a, np.float32)  # noqa: E731
    case = dict(R0=f(R0), t0=f(t0), uv=f(uv), Xw=f(X), inv=inv, valid=valid)
    if stereo:
        bf = 260.0 * BASE
        ur = uv[:, 0] - bf / Xc[:, 2] + 0.3 * rng.standard_normal(n)
        ur[rng.random(n) < 0.4] = -1.0   # mono rows
        case.update(ur=f(ur), bf=bf)
    return case, R_true, t_true


@pytest.mark.parametrize("stereo", [False, True])
def test_kb8_pose_optimize_matches_jax(stereo):
    c, R_true, t_true = _pose_case(stereo)
    K = K8_FULL
    if stereo:
        jo = jtrack.pose_optimize_stereo(jcam.KB8, jnp.asarray(K), jnp.float32(c["bf"]),
                                         *(jnp.asarray(c[k]) for k in ("R0", "t0", "uv", "ur",
                                                                       "Xw", "inv", "valid")))
        to = ttrack.pose_optimize_stereo(tcam.KB8, _t(K), c["bf"],
                                         *(_t(c[k]) for k in ("R0", "t0", "uv", "ur", "Xw", "inv",
                                                              "valid")))
    else:
        jo = jtrack.pose_optimize(jcam.KB8, jnp.asarray(K),
                                  *(jnp.asarray(c[k]) for k in ("R0", "t0", "uv", "Xw", "inv",
                                                                "valid")))
        to = ttrack.pose_optimize(tcam.KB8, _t(K), *(_t(c[k]) for k in ("R0", "t0", "uv", "Xw",
                                                                         "inv", "valid")))
    Rj, tj, mj, nj = (np.asarray(a) for a in jo)
    Rt, tt, mt, nt = (a.numpy() for a in to)
    np.testing.assert_array_equal(mt, mj)
    assert int(nt) == int(nj) >= 250
    np.testing.assert_allclose(Rt, Rj, atol=1e-4, rtol=0)
    np.testing.assert_allclose(tt, tj, atol=1e-3, rtol=0)
    assert np.abs(tt - t_true).max() < 0.01 and Rt.dtype == np.float32


def test_kb8_two_cam_uses_right_only_features():
    """test_tobody.py's divergent rig: 12 left observations, the right
    camera's full view through T_rl."""
    R_rl = np.asarray(jlie.so3_exp(jnp.asarray([0.0, -0.5, 0.0])), np.float32)
    t_rl = (-R_rl @ np.array([0.1, 0.0, 0.0], np.float32)).astype(np.float32)
    rng = np.random.default_rng(0)
    X = np.concatenate([rng.uniform(-1.0, 14.0, (256, 1)), rng.uniform(-1.5, 1.5, (256, 1)),
                        rng.uniform(3.0, 7.0, (256, 1))], axis=1).astype(np.float32)
    R_true = np.asarray(jlie.so3_exp(jnp.asarray([0.02, -0.03, 0.01])), np.float32)
    t_true = np.array([0.05, -0.02, 0.08], np.float32)

    def proj(R, t):
        Xc = X @ R.T + t
        uv = np.asarray(jcam.kb8_project(jnp.asarray(K8_FULL), jnp.asarray(Xc)))
        ok = ((Xc[:, 2] > 0.1) & (uv[:, 0] > 2) & (uv[:, 0] < 510) & (uv[:, 1] > 2)
              & (uv[:, 1] < 382))
        return uv, ok

    uv_l, ok_l = proj(R_true, t_true)
    uv_r, ok_r = proj(R_rl @ R_true, R_rl @ t_true + t_rl)
    keep = np.zeros(256, bool)
    keep[np.flatnonzero(ok_l)[:12]] = True
    assert (ok_r & ~ok_l).sum() > 40
    R0 = (np.asarray(jlie.so3_exp(jnp.asarray([0.03, 0.02, -0.02])), np.float32) @ R_true)
    t0 = t_true + np.array([0.08, -0.06, 0.05], np.float32)
    info = np.ones(256, np.float32)
    args = (K8_FULL, K8_FULL, R_rl, t_rl, R0, t0, uv_l, X, info, keep, uv_r, X, info, ok_r)
    jo = [np.asarray(a) for a in jtrack.pose_optimize_two_cam(
        jcam.KB8, *(jnp.asarray(a) for a in args))]
    to = [a.numpy() for a in ttrack.pose_optimize_two_cam(tcam.KB8, *(_t(a) for a in args))]
    np.testing.assert_array_equal(to[2], jo[2])
    np.testing.assert_array_equal(to[3], jo[3])
    assert int(to[4]) == int(jo[4])
    np.testing.assert_allclose(to[0], jo[0], atol=1e-4, rtol=0)
    np.testing.assert_allclose(to[1], jo[1], atol=1e-3, rtol=0)
    rot = np.linalg.norm(np.asarray(jlie.so3_log(jnp.asarray(to[0] @ R_true.T))))
    assert to[3].sum() > 40 and np.linalg.norm(to[1] - t_true) < 1e-3 and rot < 1e-3


# ---------------------------------------------------------------- sessions
def kb8_frames(n, K8, wh, seed=5):
    """The PlaneScene (seed 5, two planes) along the orbit, rendered by the
    port's numpy KB8 renderer: (left, right) pairs, right at +BASE in x."""
    planes = entry.plane_scene(seed)
    R, t = entry.orbit_trajectory(n)
    rays = entry.kb8_rays(K8, wh)
    return [(entry.render_rays(planes, rays, R[i], t[i]),
             entry.render_rays(planes, rays, R[i], t[i] - np.array([BASE, 0.0, 0.0])))
            for i in range(n)], R, t


def _jax_features(f):
    return jorb.Features(xy=jnp.asarray(f.xy.numpy()), response=jnp.asarray(f.response.numpy()),
                         angle=jnp.asarray(f.angle.numpy()), octave=jnp.asarray(f.octave.numpy()),
                         descriptors=jnp.asarray(f.descriptors.numpy()),
                         valid=jnp.asarray(f.valid.numpy()))


def system_vs_jax(tmp_path, n, K8, wh, orb_cfg, kmax, lmax, window):
    """The port's System(settings_path) and the JAX Tracker (from the JAX
    settings of the same file) over the same frames, both fed the port's
    features. Returns both trackers and their per-frame (state, keyframe
    row, inliers)."""
    path = tmp_path / "fisheye.yaml"
    path.write_text(entry.kb8_stereo_settings(K8, wh, BASE, *orb_cfg))
    frames, R_gt, t_gt = kb8_frames(n, K8, wh)
    sys_ = tsys.System(str(path), sensor="stereo", device="cpu")
    cfg = sys_.tracker.cfg
    assert cfg.stereo_fisheye and cfg.kind == tcam.KB8 and abs(cfg.bf - K8[0] * BASE) < 1e-3
    sys_.tracker = ttrk.Tracker(dataclasses.replace(cfg, kmax=kmax, lmax=lmax,
                                                    local_window=window, async_mapping=False,
                                                    pipeline_depth=1), device="cpu")
    jcfg = jsettings.to_tracker_config(jsettings.load_settings(str(path), "stereo"), kmax=kmax,
                                       lmax=lmax, local_window=window, async_mapping=False,
                                       pipeline_depth=1)
    j = jtrk.Tracker(jcfg)
    tf = [sys_.tracker._extract(torch.from_numpy(a)) for fr in frames for a in fr]
    it_t, it_j = iter(tf), iter(tf)
    sys_.tracker._extract = lambda img: next(it_t)
    j._extract_pair = lambda l, r: (_jax_features(next(it_j)), _jax_features(next(it_j)))
    rec_t, rec_j = [], []
    for i, (l, r) in enumerate(frames):
        sys_.track_stereo(l, r, 0.05 * i)
        j.process(l, 0.05 * i, img_right=r)
        j.settle()
        tr = sys_.tracker
        rec_t.append((tr.state, tr.last_kf_row, tr.last_inliers))
        rec_j.append((j.state, j.last_kf_row, j.last_inliers))
    return sys_.tracker, j, rec_t, rec_j, R_gt, t_gt


def assert_fisheye_sessions_agree(t, j, rec_t, rec_j, R_gt, t_gt):
    assert rec_t == rec_j, (rec_t, rec_j)
    _, R_j, t_j, ok_j = j.poses()
    ts, R_t, t_t, ok_t = t.poses()
    np.testing.assert_array_equal(ok_t, ok_j)
    np.testing.assert_allclose(R_t, R_j, atol=1e-4)
    np.testing.assert_allclose(t_t, t_j, atol=1e-4)
    # test_slam_fisheye.py's gates
    assert ok_t.sum() >= 0.7 * len(ok_t)
    est = teval.camera_centers(R_t[ok_t], t_t[ok_t])
    gt = teval.camera_centers(R_gt[ok_t], t_gt[ok_t])
    assert teval.ate_rmse(ts[ok_t], est, ts[ok_t], gt, with_scale=False)[0] < 0.05


@pytest.fixture
def jax_ok_only(monkeypatch):
    jax.clear_caches()
    monkeypatch.setattr(jops, "add_observations", jax_add_observations_ok_only)
    yield
    jax.clear_caches()


def test_fisheye_system_session_tracks_on_the_port(tmp_path):
    """The port's System(settings_path) alone on the same 3 fisheye frames
    (Tier-1 twin of the JAX comparison below, which compiles the JAX
    tracker's stereo init and fused step): every frame OK with >= 50
    inliers from the second on, and test_slam_fisheye.py's gates."""
    path = tmp_path / "fisheye.yaml"
    path.write_text(entry.kb8_stereo_settings(K8_SMALL, (256, 192), BASE, 300, 4))
    frames, R_gt, t_gt = kb8_frames(3, K8_SMALL, (256, 192))
    sys_ = tsys.System(str(path), sensor="stereo", device="cpu")
    sys_.tracker = ttrk.Tracker(dataclasses.replace(sys_.tracker.cfg, kmax=8, lmax=1024,
                                                    local_window=4, async_mapping=False,
                                                    pipeline_depth=1), device="cpu")
    rec = []
    for i, (l, r) in enumerate(frames):
        sys_.track_stereo(l, r, 0.05 * i)
        rec.append((sys_.tracker.state, sys_.tracker.last_inliers))
    assert all(r[0] == ttrk.OK for r in rec) and min(r[1] for r in rec[1:]) >= 50
    ts, R_t, t_t, ok = sys_.tracker.poses()
    assert ok.all()
    est = teval.camera_centers(R_t[ok], t_t[ok])
    gt = teval.camera_centers(R_gt[ok], t_gt[ok])
    assert teval.ate_rmse(ts[ok], est, ts[ok], gt, with_scale=False)[0] < 0.05


@pytest.mark.slow
def test_fisheye_system_session_matches_jax_tracker(tmp_path, jax_ok_only):
    t, j, rec_t, rec_j, R_gt, t_gt = system_vs_jax(tmp_path, 3, K8_SMALL, (256, 192), (300, 4),
                                                   kmax=8, lmax=1024, window=4)
    assert all(r[0] == ttrk.OK for r in rec_t) and min(r[2] for r in rec_t[1:]) >= 50
    assert_fisheye_sessions_agree(t, j, rec_t, rec_j, R_gt, t_gt)
    j.shutdown()


@pytest.mark.slow
def test_fisheye_system_session_matches_jax_tracker_full(tmp_path, jax_ok_only):
    """test_slam_fisheye.py's size: 512x384, OrbConfig(500, 3), kmax 32,
    lmax 4096, window 5, 10 frames (keyframes and local BA included)."""
    t, j, rec_t, rec_j, R_gt, t_gt = system_vs_jax(tmp_path, 10, K8_FULL, (512, 384), (500, 3),
                                                   kmax=32, lmax=4096, window=5)
    assert int(t.map.n_kf) >= 2
    assert_fisheye_sessions_agree(t, j, rec_t, rec_j, R_gt, t_gt)
    j.shutdown()


def synthetic_kb8_map(seed=7, n=160, F=200, L=512):
    """A KB8 map built directly: three keyframes 0.15 apart along x over
    landmarks at 3-7 m, features at their KB8 projections (0.3 px noise,
    descriptors a few bits apart per keyframe). The first half of the
    landmarks exist, bound in all three keyframes; the second half are
    unbound features for triangulate_pair. Returns the port's MapState on
    the CPU."""
    from orb_slam3_tpu_torch.atlas import ops as tops
    from orb_slam3_tpu_torch.atlas import state as tstate

    rng = np.random.default_rng(seed)
    X = np.concatenate([rng.uniform(-3, 3, (n, 1)), rng.uniform(-2, 2, (n, 1)),
                        rng.uniform(3, 7, (n, 1))], 1).astype(np.float32)
    base = rng.integers(0, 256, (n, 32)).astype(np.uint8)
    s = tstate.empty(kmax=4, fmax=F, lmax=L, device="cpu")
    octave = np.zeros(F, np.int32)
    octave[:n] = rng.integers(0, 3, n)
    for k in range(3):
        R = np.asarray(jlie.so3_exp(jnp.asarray([0.0, 0.01 * k, 0.0])), np.float32)
        t = (-R @ np.array([0.15 * k, 0.0, 0.0])).astype(np.float32)
        uv = tcam.kb8_project(_t(K8_SMALL), _t(X @ R.T + t)).numpy()
        uv = uv + 0.3 * rng.standard_normal(uv.shape).astype(np.float32)
        xy = np.zeros((F, 2), np.float32)
        xy[:n] = uv
        desc = np.zeros((F, 32), np.uint8)
        desc[:n] = base ^ (rng.random((n, 32)) < 0.01).astype(np.uint8)
        valid = np.zeros(F, bool)
        valid[:n] = (uv[:, 0] > 0) & (uv[:, 0] < 256) & (uv[:, 1] > 0) & (uv[:, 1] < 192)
        prev = None if k == 0 else k - 1
        s, _ = tops.add_keyframe(s, _t(R), _t(t), 0.1 * k, _t(xy), _t(octave),
                                 torch.zeros(F), _t(desc), _t(valid), parent=prev, prev=prev)
    half = n // 2
    Xb = X[:half] + 0.02 * rng.standard_normal((half, 3)).astype(np.float32)
    col = torch.zeros(half, dtype=torch.int32)
    s, rows = tops.add_landmarks(s, _t(Xb), _t(base[:half]), col, s.kf_feat_valid[0, :half],
                                 col, torch.arange(half, dtype=torch.int32))
    for k in (1, 2):
        s = tops.add_observations(s, k, torch.arange(half, dtype=torch.int32), rows,
                                  (rows >= 0) & s.kf_feat_valid[k, :half])
    return s


@pytest.fixture(scope="module")
def kb8_map():
    return synthetic_kb8_map()


def test_kb8_triangulate_pair_matches_jax_on_a_built_map(kb8_map):
    sf = np.asarray([1.2 ** i for i in range(4)], np.float32)
    js = jax_map(kb8_map)
    Xj, f1j, f2j, aj = (np.asarray(a) for a in jlm.triangulate_pair(
        jcam.KB8, jnp.asarray(K8_SMALL), js, jnp.int32(2), jnp.int32(0), jnp.asarray(sf)))
    Xt, f1t, f2t, at = (a.numpy() for a in tlm.triangulate_pair(
        tcam.KB8, _t(K8_SMALL), kb8_map, 2, 0, _t(sf)))
    np.testing.assert_array_equal(f1t, f1j)
    np.testing.assert_array_equal(at, aj)
    assert aj.sum() >= 20
    np.testing.assert_array_equal(f2t[at], f2j[at])
    err = np.linalg.norm(Xt[at] - Xj[at], axis=1) / np.linalg.norm(Xj[at], axis=1)
    assert err.max() <= 1e-4, err.max()


def test_kb8_local_ba_matches_jax_on_a_built_map(kb8_map):
    sf = np.asarray([1.2 ** i for i in range(4)], np.float32)
    rows = np.asarray([0, 1, 2, 2], np.int32)
    j, _ = jlm.local_ba(jcam.KB8, jnp.asarray(K8_SMALL), jax_map(kb8_map), jnp.asarray(rows),
                        n_fixed=1, window=4, iters=8, scale_factors=jnp.asarray(sf))
    t, stats = tlm.local_ba(tcam.KB8, _t(K8_SMALL), kb8_map, _t(rows), n_fixed=1, window=4,
                            iters=8, scale_factors=_t(sf))
    assert float(stats.cost) < float(stats.cost0)
    kv = np.asarray(j.kf_valid)
    np.testing.assert_array_equal(t.kf_feat_lm.numpy(), np.asarray(j.kf_feat_lm))
    np.testing.assert_allclose(t.kf_R.numpy()[kv], np.asarray(j.kf_R)[kv], atol=1e-4)
    np.testing.assert_allclose(t.kf_t.numpy()[kv], np.asarray(j.kf_t)[kv], atol=1e-4)
    lv = np.asarray(j.lm_valid)
    Xj, Xt = np.asarray(j.lm_pos)[lv], t.lm_pos.numpy()[lv]
    rel = np.linalg.norm(Xt - Xj, axis=1) / np.linalg.norm(Xj, axis=1)
    assert lv.sum() >= 60 and (rel <= 1e-3).mean() >= 0.99, np.sort(rel)[-5:]


@pytest.fixture(scope="module")
def kb8_session():
    """A 6-frame port fisheye session on the CPU (256x192) and the inputs of
    its last keyframe insertion, carried across to the JAX package."""
    frames, R_gt, t_gt = kb8_frames(6, K8_SMALL, (256, 192))
    cfg = ttrk.TrackerConfig(
        K=K8_SMALL, kind=tcam.KB8, img_wh=(256, 192), sensor="stereo",
        orb=torb.OrbConfig(300, 4), kmax=8, lmax=1024, local_window=4, th_depth=20.0,
        stereo_fisheye=True, K_right=K8_SMALL, R_rl=np.eye(3, dtype=np.float32),
        t_rl=np.array([-BASE, 0.0, 0.0], np.float32), bf=float(K8_SMALL[0]) * BASE,
        async_mapping=False, pipeline_depth=1)
    tr = ttrk.Tracker(cfg, device="cpu")
    rec = []
    orig = tpipe.run_pre_stage

    def record(s, pkg, cfg_, base_sensor, parent_row, scale_factors):
        rec.append((s, pkg, parent_row))
        return orig(s, pkg, cfg_, base_sensor, parent_row, scale_factors)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tpipe, "run_pre_stage", record)
        for i, (l, r) in enumerate(frames):
            tr.process(l, 0.05 * i, img_right=r)
    assert rec, "the session inserted no keyframe"
    s, pkg, parent = rec[-1]
    assert pkg.feat_ur is not None and bool((pkg.feat_ur >= 0).any())
    return dict(tracker=tr, cfg=tr.cfg, R_gt=R_gt, t_gt=t_gt, js=jax_map(s),
                jpkg=jax_package(pkg), parent=parent)


def _jax_cfg(tcfg):
    return jtrk.TrackerConfig(
        K=jnp.asarray(K8_SMALL), kind=jcam.KB8, img_wh=(256, 192), sensor="stereo",
        orb=jorb.OrbConfig(300, 4), kmax=8, lmax=1024, local_window=4, th_depth=20.0,
        stereo_fisheye=True, K_right=jnp.asarray(K8_SMALL), R_rl=np.eye(3, dtype=np.float32),
        t_rl=np.array([-BASE, 0.0, 0.0], np.float32), bf=tcfg.bf, async_mapping=False,
        pipeline_depth=1)


@pytest.mark.slow
def test_kb8_session_tracks_the_truth(kb8_session):
    tr = kb8_session["tracker"]
    ts, R, t, ok = tr.poses()
    assert ok.all() and tr.state == ttrk.OK
    est = teval.camera_centers(R, t)
    gt = teval.camera_centers(kb8_session["R_gt"], kb8_session["t_gt"])
    assert teval.ate_rmse(ts, est, ts, gt, with_scale=False)[0] < 0.05


@pytest.mark.slow
def test_kb8_triangulate_pair_matches_jax(kb8_session, jax_ok_only):
    b = kb8_session
    p = b["jpkg"]
    js, kf = jops.add_keyframe(b["js"], p.R, p.t, p.timestamp, p.feat_xy, p.feat_octave,
                               p.feat_angle, p.feat_desc, p.feat_valid, feat_lm=p.feat_lm,
                               feat_ur=p.feat_ur, feat_depth=p.feat_depth,
                               parent=jnp.int32(b["parent"]), prev=jnp.int32(b["parent"]))
    kf = int(kf)
    sf = np.asarray([1.2 ** i for i in range(4)], np.float32)
    Xj, f1j, f2j, aj = (np.asarray(a) for a in jlm.triangulate_pair(
        jcam.KB8, jnp.asarray(K8_SMALL), js, jnp.int32(kf), jnp.int32(kf - 1), jnp.asarray(sf),
        use_depth=True, min_depth=jnp.float32(0.1)))
    Xt, f1t, f2t, at = (a.numpy() for a in tlm.triangulate_pair(
        tcam.KB8, _t(K8_SMALL), convert.map_state(js, "cpu"), kf, kf - 1, _t(sf),
        use_depth=True, min_depth=0.1))
    np.testing.assert_array_equal(f1t, f1j)
    assert aj.sum() >= 10 and (at == aj).mean() >= 0.99
    both = at & aj
    np.testing.assert_array_equal(f2t[both], f2j[both])
    err = np.linalg.norm(Xt[both] - Xj[both], axis=1) / np.linalg.norm(Xj[both], axis=1)
    assert err.max() <= 1e-4, err.max()


@pytest.mark.slow
def test_kb8_local_ba_matches_jax(kb8_session, jax_ok_only):
    b = kb8_session
    sf = np.asarray([1.2 ** i for i in range(4)], np.float32)
    tcfg = b["cfg"]
    js, kf, rows, n_fixed = jpipe.run_pre_stage(b["js"], b["jpkg"], _jax_cfg(tcfg), "stereo",
                                                b["parent"], jnp.asarray(sf))
    W = tcfg.local_window + 4
    j, _ = jlm.local_ba(jcam.KB8, jnp.asarray(K8_SMALL), js, rows, n_fixed=n_fixed, window=W,
                        iters=8, scale_factors=jnp.asarray(sf), stereo=True,
                        bf=jnp.float32(tcfg.bf))
    t, stats = tlm.local_ba(tcam.KB8, _t(K8_SMALL), convert.map_state(js, "cpu"),
                            _t(np.asarray(rows)), n_fixed=int(n_fixed), window=W, iters=8,
                            scale_factors=_t(sf), stereo=True, bf=tcfg.bf)
    assert float(stats.cost) < float(stats.cost0)
    fl_j, fl_t = np.asarray(j.kf_feat_lm), t.kf_feat_lm.numpy()
    kv = np.asarray(j.kf_valid)
    for r in np.flatnonzero(kv):
        assert (fl_t[r] == fl_j[r]).mean() >= 0.99
    np.testing.assert_allclose(t.kf_R.numpy()[kv], np.asarray(j.kf_R)[kv], atol=1e-4)
    np.testing.assert_allclose(t.kf_t.numpy()[kv], np.asarray(j.kf_t)[kv], atol=1e-4)
    lv = np.asarray(j.lm_valid)
    Xj, Xt = np.asarray(j.lm_pos)[lv], t.lm_pos.numpy()[lv]
    rel = np.linalg.norm(Xt - Xj, axis=1) / np.linalg.norm(Xj, axis=1)
    assert (rel <= 1e-3).mean() >= 0.99, np.sort(rel)[-5:]
