"""The port's Tracker and System with a depth sensor, against the JAX
package where it runs a whole session.

- Sessions against the JAX Tracker(async_mapping=False, pipeline_depth=1)
  (slow: the JAX side compiles every stage of its tracker): RGB-D (12
  frames, PlaneScene seed 1), stereo (12 frames, seed 2, baseline 0.12) and
  localization mode (RGB-D, seed 6, 8 mapped frames then 8 with mapping
  paused; once at th_depth 20 and once at th_depth 80, where the VO points
  of the paused frames are valid and match), at the size of test_torch_mapping.py (256x192, OrbConfig(300, 4),
  kmax 8, lmax 1024, local window 4, th_depth 20), the port fed the JAX
  package's features. States and keyframe timestamps equal, inliers within
  max(2, 2%), poses within 1e-3, landmark counts within 2%. The RGB-D
  session and the 14-frame mono session of test_torch_system.py also count
  the new observations of every fuse call on both sides: the counts must be
  equal call for call.
- Port-only and cheap: a stereo session through System.track_stereo
  (K2's stereo template's plain version on every tracked frame, the
  reference test's unscaled ATE gate), the façade's sensor routing, and
  the Tracker against entry.bootstrap on the same frames: the same init
  frame and landmarks, and the same poses (atol 1e-6) and inliers up to the
  first keyframe insertion.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

from orb_slam3_tpu.atlas import ops as jops
from orb_slam3_tpu.mapping import fuse as jfuse
from orb_slam3_tpu.tracking import tracker as jtrk
from orb_slam3_tpu_torch import convert, entry
from orb_slam3_tpu_torch.api import evaluate as teval
from orb_slam3_tpu_torch.api import system as tsys
from orb_slam3_tpu_torch.frontend import orb as torb
from orb_slam3_tpu_torch.mapping import fuse as tfuse
from orb_slam3_tpu_torch.tracking import track as ttrack
from orb_slam3_tpu_torch.tracking import tracker as ttrk
from synthetic_scene import PlaneScene, orbit_trajectory
from test_torch_depth_mapping import depth_config, jax_depth_config
from test_torch_mapping import (K_NP, OCFG, WH, jax_add_observations_ok_only, jax_config,
                                jax_features, port_tracker, use_jax_minimal_sets)

torch.set_num_threads(1)


def count_fuses(mp, port_counts, jax_counts):
    """New observations made by each fuse_into_keyframe call: the port's
    read after the call, the JAX one's reported from inside its jitted
    mapping stage (ordered callbacks). JAX's caches must be cleared so
    that the stage is traced with the wrapper."""
    t_orig, j_orig = tfuse.fuse_into_keyframe, jfuse.fuse_into_keyframe

    def port(kind, K, s, row, sf, **kw):
        out = t_orig(kind, K, s, row, sf, **kw)
        port_counts.append(int(((out.kf_feat_lm[row] >= 0) & (s.kf_feat_lm[row] < 0)).sum()))
        return out

    def jax_(kind, K, s, row, sf, **kw):
        out = j_orig(kind, K, s, row, sf, **kw)
        n = jnp.sum((out.kf_feat_lm[row] >= 0) & (s.kf_feat_lm[row] < 0))
        jax.debug.callback(lambda v: jax_counts.append(int(v)), n, ordered=True)
        return out

    mp.setattr(tfuse, "fuse_into_keyframe", port)
    mp.setattr(jfuse, "fuse_into_keyframe", jax_)


def depth_inputs(sensor, n, seed, baseline=0.1):
    """PlaneScene frames as (image, right image or depth map) and the JAX
    package's features of them (both images of a pair, in the order the
    port's Tracker extracts them)."""
    scene = PlaneScene(K_NP, img_wh=WH, two_planes=True, seed=seed)
    R, t = orbit_trajectory(n)
    zero, K = jnp.zeros((5,), jnp.float32), jnp.asarray(K_NP)
    frames, feats = [], []
    for i in range(n):
        if sensor == "rgbd":
            frames.append(scene.render_with_depth(R[i], t[i]))
            feats.append(jtrk._extract_features(jnp.asarray(frames[-1][0], jnp.float32), K, zero,
                                                OCFG, False))
        else:
            frames.append(scene.render_stereo(R[i], t[i], baseline))
            feats.extend(jtrk._extract_features_pair(
                *(jnp.asarray(a, jnp.float32) for a in frames[-1]), K, zero, OCFG, False))
    tf = [convert.features(f.xy, f.response, f.angle, f.octave, f.descriptors, f.valid,
                           device="cpu") for f in feats]
    return frames, tf


def run_pair(sensor, frames, tf, bf, pause_at=None, th_depth=20.0):
    """The port's and the JAX tracker over the frames, mapping paused from
    frame `pause_at` on. Returns both trackers and their per-frame
    (state, keyframe row, inliers)."""
    t = ttrk.Tracker(depth_config(sensor, bf, th_depth))
    it = iter(tf)
    t._extract = lambda img: next(it)
    j = jtrk.Tracker(jax_depth_config(t.cfg))
    rec_t, rec_j = [], []
    for i, (a, b) in enumerate(frames):
        if i == pause_at:
            for tr in (t, j):
                tr.sync_mapping()
                tr.mapping_paused = True
        kw = {"img_right": b} if sensor == "stereo" else {"depth_map": b}
        t.process(a, 0.05 * i, **kw)
        j.process(a, 0.05 * i, **kw)
        j.settle()
        rec_t.append((t.state, t.last_kf_row, t.last_inliers))
        rec_j.append((j.state, j.last_kf_row, j.last_inliers))
    t.settle()
    return t, j, rec_t, rec_j


def assert_sessions_agree(t, j, rec_t, rec_j):
    assert [r[:2] for r in rec_t] == [r[:2] for r in rec_j]
    for (_, _, n_t), (_, _, n_j) in zip(rec_t, rec_j):
        assert abs(n_t - n_j) <= max(2, 0.02 * n_j), (rec_t, rec_j)
    kf_ts_j = np.asarray(j.map.kf_timestamp)[np.asarray(j.map.kf_valid)]
    kf_ts_t = t.map.kf_timestamp[t.map.kf_valid].numpy()
    np.testing.assert_array_equal(kf_ts_t, kf_ts_j)
    _, R_j, t_j, ok_j = j.poses()
    _, R_t, t_t, ok_t = t.poses()
    np.testing.assert_array_equal(ok_t, ok_j)
    np.testing.assert_allclose(R_t, R_j, atol=1e-3)
    np.testing.assert_allclose(t_t, t_j, atol=1e-3)
    n_j, n_t = int(j.map.lm_valid.sum()), int(t.map.lm_valid.sum())
    assert abs(n_t - n_j) <= 0.02 * n_j, (n_t, n_j)
    return kf_ts_t


@pytest.fixture
def jax_ok_only(monkeypatch):
    jax.clear_caches()
    monkeypatch.setattr(jops, "add_observations", jax_add_observations_ok_only)
    yield
    jax.clear_caches()


@pytest.mark.slow
def test_rgbd_session_matches_jax_tracker(jax_ok_only, monkeypatch):
    frames, tf = depth_inputs("rgbd", 12, seed=1)
    fuse_t, fuse_j = [], []
    count_fuses(monkeypatch, fuse_t, fuse_j)
    t, j, rec_t, rec_j = run_pair("rgbd", frames, tf, bf=20.0)
    kf_ts = assert_sessions_agree(t, j, rec_t, rec_j)
    assert len(kf_ts) >= 3 and all(r[0] == ttrk.OK for r in rec_t)
    # equal call for call; at this size no RGB-D fuse call binds anything,
    # on either side (the mono session's do)
    assert len(fuse_t) == 4 * (len(kf_ts) - 1)
    assert fuse_t == fuse_j
    j.shutdown()


@pytest.mark.slow
def test_stereo_session_matches_jax_tracker(jax_ok_only):
    frames, tf = depth_inputs("stereo", 12, seed=2, baseline=0.12)
    t, j, rec_t, rec_j = run_pair("stereo", frames, tf, bf=200.0 * 0.12)
    kf_ts = assert_sessions_agree(t, j, rec_t, rec_j)
    assert len(kf_ts) >= 3 and all(r[0] == ttrk.OK for r in rec_t)
    j.shutdown()


@pytest.mark.slow
@pytest.mark.parametrize("th_depth", [20.0, 80.0])
def test_localization_session_matches_jax_tracker(jax_ok_only, monkeypatch, th_depth):
    """Mapping paused after 8 frames. At th_depth 20 (th_depth_m = bf *
    th_depth / fx = 2 m, under the scene's 4.2-6 m) the VO points are all
    invalid; at th_depth 80 (8 m) they are valid, so their unprojection,
    the VO match and the pose BA over map + VO rows run with real rows on
    both sides."""
    frames, tf = depth_inputs("rgbd", 16, seed=6)
    vo = []  # per VO-point match: (valid VO points, matched)
    orig = ttrack.match_local_map

    def match(kind, K, R, t, lm_pos, lm_desc, mask, *a, **kw):
        out = orig(kind, K, R, t, lm_pos, lm_desc, mask, *a, **kw)
        if lm_pos.shape[0] == OCFG.n_features:
            vo.append((int(mask.sum()), int(out[1].sum())))
        return out

    monkeypatch.setattr(ttrack, "match_local_map", match)
    t, j, rec_t, rec_j = run_pair("rgbd", frames, tf, bf=20.0, pause_at=8, th_depth=th_depth)
    kf_ts = assert_sessions_agree(t, j, rec_t, rec_j)
    assert all(r[0] == ttrk.OK for r in rec_t) and rec_t[8][1] == rec_t[-1][1]
    assert (kf_ts < 0.05 * 8).all()  # no keyframe while paused
    assert len(vo) == 16 - 8 - 1, vo  # from the second paused frame on
    if th_depth > 60.0:
        assert all(n_valid >= 100 and n_ok >= 50 for n_valid, n_ok in vo), vo
    else:
        assert all(n_valid == 0 for n_valid, _ in vo), vo
    np.testing.assert_allclose(t.last["R"].numpy(), np.asarray(j.last["R"]), atol=1e-3)
    np.testing.assert_allclose(t.last["t"].numpy(), np.asarray(j.last["t"]), atol=1e-3)
    j.shutdown()


@pytest.mark.slow
def test_mono_session_fuse_counts_match_jax(jax_ok_only, monkeypatch):
    """test_torch_system.py's 14-frame mono session, each fuse call's new
    observations counted on both sides."""
    imgs, _, tf, _ = jax_features(12)
    blank = np.zeros_like(imgs[0])
    imgs = imgs + [blank, blank]
    tf = tf + [torb.extract(torch.from_numpy(blank), convert.orb_config(OCFG))] * 2
    use_jax_minimal_sets(monkeypatch)
    fuse_t, fuse_j = [], []
    count_fuses(monkeypatch, fuse_t, fuse_j)
    t = port_tracker(tf)
    j = jtrk.Tracker(jax_config(t.cfg))
    for i, img in enumerate(imgs):
        t.process(img, 0.05 * i)
        j.process(img, 0.05 * i)
        j.settle()
    assert len(fuse_t) >= 8 and sum(fuse_t) > 0
    assert fuse_t == fuse_j
    j.shutdown()


# ---------------------------------------------------------------------------
# port-only
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def stereo_session():
    """10 stereo frames (PlaneScene seed 2, baseline 0.12) through
    System.track_stereo on the CPU, counting the stereo pose BAs."""
    planes = entry.plane_scene(2)
    R, t = entry.orbit_trajectory(10)
    K = tuple(K_NP[:4])
    frames = [entry.render_stereo(planes, K, WH, R[i], t[i], 0.12) for i in range(10)]
    cfg = entry.tracker_config("cpu", img_wh=WH, K=K, orb=torb.OrbConfig(300, 4), kmax=8,
                               lmax=1024, local_window=4, sensor="stereo", bf=200.0 * 0.12,
                               async_mapping=False, pipeline_depth=1)
    calls = {"stereo": 0, "mono": 0}
    orig_s, orig_m = ttrack.pose_optimize_stereo, ttrack.pose_optimize

    def stereo(*a, **kw):
        calls["stereo"] += 1
        return orig_s(*a, **kw)

    def mono(*a, **kw):
        calls["mono"] += 1
        return orig_m(*a, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ttrack, "pose_optimize_stereo", stereo)
        mp.setattr(ttrack, "pose_optimize", mono)
        system = entry.slam(frames, cfg)
    return dict(system=system, R=R, t=t, calls=calls, cfg=cfg)


def test_stereo_session_tracks_the_truth(stereo_session):
    system = stereo_session["system"]
    tr = system.tracker
    assert system.tracking_state() == ttrk.OK
    ts, R, t, ok = tr.poses()
    assert ok.all()
    est = teval.camera_centers(R, t)
    gt = teval.camera_centers(stereo_session["R"], stereo_session["t"])
    rmse, _, _ = teval.ate_rmse(ts, est, ts, gt, with_scale=False)
    assert rmse < 0.15, rmse
    assert int(tr.map.kf_valid.sum()) >= 2
    # the fused step's stage 1 and stage 2 use the frame's stereo rows
    assert stereo_session["calls"]["stereo"] >= 2 * 9
    ur = tr.map.kf_feat_ur[tr.map.kf_valid]
    assert bool((ur >= 0).any()) and bool((ur < 0).any())


def test_system_routes_each_sensor(stereo_session):
    system = stereo_session["system"]
    with pytest.raises(ValueError, match="'stereo' session"):
        system.track_rgbd(None, None, 1.0)
    with pytest.raises(ValueError, match="'stereo' session"):
        system.track_monocular(None, 1.0)
    with pytest.raises(ValueError, match="rgbd"):
        tsys.System(config=stereo_session["cfg"], sensor="rgbd")
    # the inertial sensor is its own config's (test_torch_vi_session.py)
    with pytest.raises(ValueError, match="stereo-imu"):
        tsys.System(config=stereo_session["cfg"], sensor="stereo-imu")
    system.activate_localization_mode()
    assert system.tracker.mapping_paused
    system.deactivate_localization_mode()
    assert not system.tracker.mapping_paused
    if not torch.cuda.is_available():  # entry points default to the card
        with pytest.raises(RuntimeError, match="CUDA"):
            tsys.System(config=ttrk.TrackerConfig(K=K_NP, sensor="rgbd", bf=20.0))


def test_tracker_follows_the_bootstrap():
    """Tracker.process and entry.bootstrap on the same frames: the same
    init frame and landmarks, then the same poses and inliers frame by frame
    until the Tracker inserts its first keyframe (held back for 6 frames
    with kf_min_frames; the bootstrap reads no keyframe field)."""
    K = tuple(K_NP[:4])
    frames, _, _, _ = entry.plane_sequence(12, img_wh=WH, K=K)
    cfg = entry.tracker_config("cpu", img_wh=WH, K=K, orb=torb.OrbConfig(300, 4), kmax=8,
                               lmax=1024, local_window=4, kf_min_frames=6, kf_max_frames=6,
                               async_mapping=False, pipeline_depth=1)
    boot = entry.bootstrap(frames, cfg, n_track=8)
    assert boot["init"].success and len(boot["poses"]) >= 3
    tr = ttrk.Tracker(cfg)
    feats = iter(boot["feats"])
    tr._extract = lambda img: next(feats)
    i0 = boot["init_frame"]
    compared = 0
    for i, img in enumerate(frames):
        n_kf = int(tr.map.n_kf)
        tr.process(img, 0.05 * i)
        if i < i0:
            assert tr.state == ttrk.NOT_INITIALIZED
            continue
        if i == i0:
            s, b = tr.map, boot["init"].map
            assert tr.state == ttrk.OK and tr.last_kf_row == boot["init"].kf1
            assert torch.equal(s.lm_valid, b.lm_valid) and torch.equal(s.kf_feat_lm, b.kf_feat_lm)
            np.testing.assert_allclose(s.lm_pos.numpy(), b.lm_pos.numpy(), atol=1e-6)
            continue
        k = i - i0 - 1
        if k >= len(boot["poses"]):
            break
        assert tr.last_inliers == boot["n_inliers"][k], (i, tr.last_inliers, boot["n_inliers"][k])
        if int(tr.map.n_kf) > n_kf:
            break  # this frame inserted a keyframe: its pose is the BA's from here on
        R_b, t_b = boot["poses"][k]
        np.testing.assert_allclose(tr.last["R"].numpy(), R_b.numpy(), atol=1e-6)
        np.testing.assert_allclose(tr.last["t"].numpy(), t_b.numpy(), atol=1e-6)
        compared += 1
    assert compared >= 5, compared
