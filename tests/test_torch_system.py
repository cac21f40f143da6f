"""The port's monocular Tracker and System against the JAX package.

- A short session (slow: the JAX side compiles every stage of its tracker):
  the port's Tracker and the JAX Tracker(async_mapping=False,
  pipeline_depth=1) on the same PlaneScene frames at the size of
  test_torch_bootstrap.py (256x192, OrbConfig(300, 4), kmax 8, lmax 1024,
  local window 4), the port fed the JAX package's features and two-view
  minimal sets. The same frames become keyframes, inliers agree within
  max(2, 2%), poses within 1e-3 through at least two inserted keyframes,
  and two blank frames lose tracking the same way on both sides.
- A port-only session through System.track_monocular with an arena small
  enough that Tracker._maybe_compact compacts and grows it: the Atlas
  invariants hold, >= 95% of bindings are on valid landmarks, poses() is
  the same just before and just after the compaction, the trajectory
  tracks the truth; then the loss, new-map and reset paths of the façade.
- The numpy helpers (trajectory export, ATE) against the JAX package's.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

from orb_slam3_tpu.api import evaluate as jeval
from orb_slam3_tpu.api import trajectory as jtraj
from orb_slam3_tpu.atlas import ops as jops
from orb_slam3_tpu.tracking import tracker as jtrk
from orb_slam3_tpu_torch import convert, entry
from orb_slam3_tpu_torch.api import evaluate as teval
from orb_slam3_tpu_torch.api import system as tsys
from orb_slam3_tpu_torch.api import trajectory as ttraj
from orb_slam3_tpu_torch.atlas import invariants as tinv
from orb_slam3_tpu_torch.atlas import ops as tops
from orb_slam3_tpu_torch.frontend import orb as torb
from orb_slam3_tpu_torch.tracking import tracker as ttrk
from orb_slam3_tpu_torch.utils.timing import GLOBAL_TIMER
from test_torch_mapping import (K_NP, OCFG, WH, jax_add_observations_ok_only, jax_config,
                                jax_features, port_tracker, use_jax_minimal_sets)

torch.set_num_threads(1)


@pytest.mark.slow
def test_session_matches_jax_tracker(monkeypatch):
    imgs, jf, tf, _ = jax_features(12)
    blank = np.zeros_like(imgs[0])
    imgs = imgs + [blank, blank]
    tf = tf + [torb.extract(torch.from_numpy(blank), convert.orb_config(OCFG))] * 2
    use_jax_minimal_sets(monkeypatch)
    t = port_tracker(tf)
    monkeypatch.setattr(jops, "add_observations", jax_add_observations_ok_only)
    j = jtrk.Tracker(jax_config(t.cfg))
    rec_t, rec_j = [], []
    for i, img in enumerate(imgs):
        t.process(img, 0.05 * i)
        j.process(img, 0.05 * i)
        j.settle()
        rec_t.append((t.state, t.last_kf_row, t.last_inliers))
        rec_j.append((j.state, j.last_kf_row, j.last_inliers))
    assert [r[:2] for r in rec_t] == [r[:2] for r in rec_j]
    for (_, _, n_t), (_, _, n_j) in zip(rec_t, rec_j):
        assert abs(n_t - n_j) <= max(2, 0.02 * n_j), (rec_t, rec_j)
    states = [r[0] for r in rec_t]
    assert states[-3:] == [ttrk.OK, ttrk.RECENTLY_LOST, ttrk.RECENTLY_LOST]
    kf_ts_j = np.asarray(j.map.kf_timestamp)[np.asarray(j.map.kf_valid)]
    kf_ts_t = t.map.kf_timestamp[t.map.kf_valid].numpy()
    np.testing.assert_array_equal(kf_ts_t, kf_ts_j)
    assert len(kf_ts_t) >= 4  # the two of the init and at least two inserted
    ts_j, R_j, t_j, ok_j = j.poses()
    ts_t, R_t, t_t, ok_t = t.poses()
    np.testing.assert_array_equal(ok_t, ok_j)
    np.testing.assert_allclose(R_t, R_j, atol=1e-3)
    np.testing.assert_allclose(t_t, t_j, atol=1e-3)
    n_j, n_t = int(j.map.lm_valid.sum()), int(t.map.lm_valid.sum())
    assert abs(n_t - n_j) <= 0.02 * n_j, (n_t, n_j)
    j.shutdown()


SMALL = dict(img_wh=WH, K=(200.0, 200.0, 128.0, 96.0))


@pytest.fixture(scope="module")
def session():
    """20 PlaneScene frames through System.track_monocular on the CPU with
    kmax 8 and lmax 512, with poses() recorded around each compaction."""
    frames, R_gt, t_gt, _ = entry.plane_sequence(20, **SMALL)
    cfg = entry.tracker_config("cpu", orb=torb.OrbConfig(300, 4), kmax=8, lmax=512,
                               local_window=4, async_mapping=False, pipeline_depth=1, **SMALL)
    system = tsys.System(config=cfg)
    tr = system.tracker
    calls = {"compact": 0, "grow": []}
    around = []  # (poses() before, poses() after) of each compaction
    orig_compact, orig_grow, orig_maybe = tops.compact, tops.grow, tr._maybe_compact

    def compact(s):
        calls["compact"] += 1
        return orig_compact(s)

    def grow(s, **kw):
        calls["grow"].append(kw)
        return orig_grow(s, **kw)

    def maybe_compact():
        n, before = calls["compact"], tr.poses()
        orig_maybe()
        if calls["compact"] > n:
            around.append((before, tr.poses()))

    GLOBAL_TIMER.reset()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tops, "compact", compact)
        mp.setattr(tops, "grow", grow)
        mp.setattr(tr, "_maybe_compact", maybe_compact)
        for i, img in enumerate(frames):
            out = system.track_monocular(img, 0.05 * i)
    return dict(system=system, R_gt=R_gt, t_gt=t_gt, around=around, calls=calls,
                last_out=out, timer=GLOBAL_TIMER.summary(), cfg=cfg)


def test_session_compacts_grows_and_keeps_the_map_consistent(session):
    tr = session["system"].tracker
    assert session["around"] and session["calls"]["grow"], session["calls"]
    assert tr.map.lmax > 512 and tr.cfg.lmax == tr.map.lmax
    assert tinv.check_all(tr.map) == []
    lm = tr.map.kf_feat_lm.numpy()
    bound = lm[(lm >= 0) & tr.map.kf_valid.numpy()[:, None]]
    assert bound.size > 300 and tr.map.lm_valid.numpy()[bound].mean() >= 0.95
    assert int(tr.map.kf_valid.sum()) >= 5 and int(tr.map.lm_valid.sum()) > 150
    for before, after in session["around"]:
        assert len(before[0]) == len(after[0]) > 0
        np.testing.assert_array_equal(before[3], after[3])
        np.testing.assert_allclose(after[1], before[1], atol=1e-5)
        np.testing.assert_allclose(after[2], before[2], atol=1e-5)


def test_session_tracks_the_truth(session):
    system = session["system"]
    assert system.tracking_state() == ttrk.OK and not system.is_lost()
    ts, R, t, ok = system.tracker.poses()
    assert ok.sum() >= 0.7 * len(ok)
    est = teval.camera_centers(R[ok], t[ok])
    gt = teval.camera_centers(session["R_gt"][ok], session["t_gt"][ok])
    rmse, n, scale = teval.ate_rmse(ts[ok], est, ts[ok], gt)
    path = np.linalg.norm(np.diff(gt, axis=0), axis=1).sum()
    assert n == ok.sum() and rmse < 0.25 * path, (rmse, path, scale)
    # track_monocular returns the frame's pose, current_pose the same in numpy
    R_last, t_last = session["last_out"]
    Rn, tn = system.current_pose()
    np.testing.assert_array_equal(R_last.numpy(), Rn)
    np.testing.assert_array_equal(t_last.numpy(), tn)
    np.testing.assert_allclose(Rn, R[-1], atol=1e-5)
    timer = session["timer"]
    for name in ("orb_extraction", "track.fused_step", "track.kf_decision",
                 "track.kf_insert_sync", "map.pre", "map.local_ba", "map.culling",
                 "track.process_total"):
        assert timer[name]["n"] >= 1, name
    assert timer["map.pre"]["n"] == timer["track.kf_insert_sync"]["n"] >= 3


def test_trajectory_export_matches_jax_writers(session, tmp_path):
    system = session["system"]
    ts, R, t, ok = system.tracker.poses()
    for name, ours, ref in (("tum", ttraj.save_tum, jtraj.save_tum),
                            ("euroc", ttraj.save_euroc, jtraj.save_euroc),
                            ("kitti", ttraj.save_kitti, jtraj.save_kitti)):
        ours(str(tmp_path / f"t_{name}.txt"), ts, R, t, ok)
        ref(str(tmp_path / f"j_{name}.txt"), ts, R, t, ok)
        got = np.loadtxt(tmp_path / f"t_{name}.txt")
        want = np.loadtxt(tmp_path / f"j_{name}.txt")
        assert got.shape == want.shape and got.shape[0] == ok.sum()
        np.testing.assert_allclose(got, want, atol=2e-6, err_msg=name)
    system.save_trajectory_tum(str(tmp_path / "s_tum.txt"))
    system.save_trajectory_euroc(str(tmp_path / "s_euroc.txt"))
    system.save_trajectory_kitti(str(tmp_path / "s_kitti.txt"))
    np.testing.assert_allclose(np.loadtxt(tmp_path / "s_tum.txt"),
                               np.loadtxt(tmp_path / "t_tum.txt"), atol=2e-6)
    ts_l, pos, quat = ttraj.load_tum(str(tmp_path / "s_tum.txt"))
    np.testing.assert_allclose(pos, teval.camera_centers(R[ok], t[ok]), atol=1e-6)
    system.save_keyframe_trajectory_tum(str(tmp_path / "kf.txt"))
    kf = np.loadtxt(tmp_path / "kf.txt")
    assert kf.shape == (int(system.tracker.map.kf_valid.sum()), 8)


def test_evaluate_matches_jax():
    rng = np.random.default_rng(3)
    gt = np.cumsum(rng.normal(size=(30, 3)), axis=0)
    ts = np.arange(30) * 0.05
    est = 0.7 * gt @ np.linalg.qr(rng.normal(size=(3, 3)))[0].T + rng.normal(size=(30, 3)) * 0.01
    for with_scale in (True, False):
        got = teval.ate_rmse(ts, est, ts + 0.001, gt, with_scale=with_scale)
        want = jeval.ate_rmse(ts, est, ts + 0.001, gt, with_scale=with_scale)
        np.testing.assert_allclose(got, want, rtol=1e-12)
    R = np.linalg.qr(rng.normal(size=(5, 3, 3)))[0]
    t = rng.normal(size=(5, 3))
    np.testing.assert_allclose(teval.camera_centers(R, t), jeval.camera_centers(R, t))
    q_t = ttraj.rot_to_quat(R * np.sign(np.linalg.det(R))[:, None, None])
    from orb_slam3_tpu.ops import lie as jlie

    q_j = np.asarray(jlie.rot_to_quat(jnp.asarray(R * np.sign(np.linalg.det(R))[:, None, None],
                                                  jnp.float32)))
    np.testing.assert_allclose(q_t, q_j, atol=1e-6)


def test_loss_new_map_and_reset(session):
    """After the session: blank frames lose tracking (RECENTLY_LOST, then
    LOST after 5; the map has fewer than 10 keyframes, so no new map), a
    backwards timestamp stores the active map and restarts in a fresh one,
    reset drops everything."""
    system = session["system"]
    tr = system.tracker
    blank = np.zeros((WH[1], WH[0]), np.float32)
    n0 = len(tr.trajectory)
    t0 = 0.05 * n0
    states = []
    for k in range(5):
        system.track_monocular(blank, t0 + 0.05 * k)
        states.append(system.tracking_state())
    assert states == [ttrk.RECENTLY_LOST] * 4 + [ttrk.LOST] and system.is_lost()
    assert not any(f.ok for f in tr.trajectory[n0:])
    map_id = int(tr.map.active_map)
    system.change_dataset()
    assert system.tracking_state() == ttrk.NOT_INITIALIZED
    assert int(tr.map.active_map) == map_id + 1
    system.reset()
    assert system.tracker is not tr and system.tracker.state == ttrk.NOT_INITIALIZED
    assert int(system.tracker.map.n_kf) == 0 and system.current_pose() is None
    system.shutdown()


def test_system_raises_for_what_is_not_ported(session):
    cfg = session["cfg"]
    # settings files are read (test_torch_settings.py), a vocabulary
    # attaches the loop closer (test_torch_loop.py) and a saved Atlas loads
    # (test_torch_checkpoint.py): a missing one is a missing file
    with pytest.raises(FileNotFoundError):
        tsys.System("no-such-settings.yaml", device="cpu")
    from orb_slam3_tpu_torch.place import vocab as tvocab

    voc = tvocab.train(np.random.default_rng(0).integers(0, 256, (200, 32), dtype=np.uint8),
                       branching=4, depth=2, device="cpu")
    assert tsys.System(config=cfg, vocabulary=voc).tracker.loop_closer.voc.n_words == 16
    with pytest.raises(FileNotFoundError):
        tsys.System(config=cfg, atlas_path="no-such-atlas.npz")
    # the inertial sensors are ported (test_torch_vi_session.py): the
    # session runs its config's sensor
    with pytest.raises(ValueError, match="mono-imu"):
        tsys.System(config=cfg, sensor="mono-imu")
    assert ttrk.Tracker(ttrk.TrackerConfig(K=cfg.K, sensor="rgbd-imu")).imu is not None
    # stereo and RGB-D are ported: a session of one sensor refuses the others
    with pytest.raises(ValueError, match="stereo"):
        tsys.System(config=cfg, sensor="stereo")
    system = session["system"]
    for call in (lambda: system.track_stereo(None, None, 0.0),
                 lambda: system.track_rgbd(None, None, 0.0)):
        with pytest.raises(ValueError, match="'mono' session"):
            call()
    with pytest.raises(ValueError, match="IMU"):
        system.track_monocular(None, 0.0, imu=np.zeros((1, 7)))
    # every entry point of the JAX facade is ported (saving the Atlas, the
    # 3D map and the live viewer: test_torch_checkpoint.py,
    # test_torch_viz.py): none raises NotImplementedError
    import inspect

    assert "NotImplementedError" not in inspect.getsource(tsys)


def test_convert_tracker_config_and_package():
    j = jtrk.TrackerConfig(K=jnp.asarray(K_NP), img_wh=WH, orb=OCFG, kmax=16, lmax=2048,
                           local_window=5, kf_max_frames=7, min_inliers=20)
    t = convert.tracker_config(j, "cpu")
    assert (t.kmax, t.lmax, t.local_window, t.kf_max_frames, t.min_inliers, t.sensor) == \
        (16, 2048, 5, 7, 20, "mono")
    assert t.orb.n_features == 300 and t.img_wh == WH
    np.testing.assert_array_equal(t.K.numpy(), K_NP)
