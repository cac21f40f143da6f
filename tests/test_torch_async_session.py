"""Port sessions on the background mapper's schedules (256x192 PlaneScene,
OrbConfig(300, 4), kmax 8, lmax 1024, local window 4, as in
test_torch_system.py), and the software pipeline of in-flight frames.

- The deterministic schedule (deterministic_mapping=True, pipeline_depth
  1): a 12-frame monocular session run twice gives the same poses bit for
  bit; it passes the Atlas invariants and tracks the truth (the map within
  5 frames, every frame after it tracked, ATE under a quarter of the
  path); every keyframe went through the mapper's queue and commits.
- The free-running thread (the defaults): the same session tracks and
  maps, passes the invariants, and shutdown() stops the thread within its
  timeout.
- pipeline_depth=4 with the readiness probe forced "not ready": the state
  machine lags exactly 3 frames (each fused step runs with 4 frames' outcomes
  unconsumed, the newest consumed one 4 frames back), every frame is
  recorded once and in order, and settle() drains the pipeline.
- An inertial session holds depth 1 whatever pipeline_depth says, its
  keyframes reach the mapper with their IMU intervals, and the barrier
  hands the intervals back to the tracker.

The sessions of tests/test_async_accuracy.py at their 512x384, and the
port against the JAX tracker on its deterministic schedule, are the slow
tests of test_torch_async_parity.py.
"""

import numpy as np
import pytest
import torch

from orb_slam3_tpu_torch import entry
from orb_slam3_tpu_torch.api import evaluate as teval
from orb_slam3_tpu_torch.atlas import invariants as tinv
from orb_slam3_tpu_torch.frontend import orb as torb
from orb_slam3_tpu_torch.tracking import tracker as ttrk

torch.set_num_threads(1)
SMALL = dict(img_wh=(256, 192), K=(200.0, 200.0, 128.0, 96.0))
N = 12


@pytest.fixture(scope="module")
def frames():
    return entry.plane_sequence(N, **SMALL)[:3]


def _config(kmax=8, **schedule):
    return entry.tracker_config("cpu", orb=torb.OrbConfig(300, 4), kmax=kmax, lmax=1024,
                                local_window=4, **SMALL, **schedule)


def _run(frames, **schedule):
    imgs, R_gt, t_gt = frames
    system = entry.slam(imgs, _config(**schedule))
    return system, system.tracker.poses()


def _tracks_the_truth(frames, poses):
    _, R_gt, t_gt = frames
    ts, R, t, ok = poses
    # the map within the first 5 frames, every frame after it tracked
    first = int(np.argmax(ok))
    assert ok[first:].all() and first <= 4, ok
    est = teval.camera_centers(R[ok], t[ok])
    gt = teval.camera_centers(R_gt[ok], t_gt[ok])
    rmse, n, _ = teval.ate_rmse(ts[ok], est, ts[ok], gt)
    path = np.linalg.norm(np.diff(gt, axis=0), axis=1).sum()
    assert n == ok.sum() and rmse < 0.25 * path, (rmse, path)


def test_deterministic_schedule_repeats_bit_for_bit(frames):
    runs = [_run(frames, deterministic_mapping=True, pipeline_depth=1) for _ in range(2)]
    (sys_a, pa), (sys_b, pb) = runs
    for a, b in zip(pa, pb):
        np.testing.assert_array_equal(a, b)
    tr = sys_a.tracker
    m = tr.async_mapper
    assert m is not None and m.inline and m._thread is None
    assert m.n_processed >= 2 and m.n_ba_runs + m.n_ba_skips == m.n_processed
    assert int(tr.map.kf_valid.sum()) == 2 + m.n_processed  # the init's two + the packages
    assert tinv.check_all(tr.map) == []
    assert tr.state == ttrk.OK
    _tracks_the_truth(frames, pa)
    for s in (sys_a, sys_b):
        s.shutdown()
        assert s.tracker.async_mapper is None


def test_free_running_thread_tracks_maps_and_shuts_down(frames):
    system, poses = _run(frames)
    tr = system.tracker
    m = tr.async_mapper
    assert tr.cfg.async_mapping and not tr.cfg.deterministic_mapping
    assert m._thread is not None and m._thread.name == "mapper"
    assert m.n_processed >= 2 and m.idle()
    assert int(tr.map.kf_valid.sum()) >= 4 and int(tr.map.lm_valid.sum()) > 100
    assert tinv.check_all(tr.map) == []
    _tracks_the_truth(frames, poses)
    thread = m._thread
    system.shutdown()
    assert not thread.is_alive() and tr.async_mapper is None


def test_pipeline_lags_by_depth_minus_one_when_nothing_is_ready(frames, monkeypatch):
    imgs = frames[0]
    monkeypatch.setattr(ttrk.Tracker, "_is_ready", lambda self, p: False)
    # (kmax 32: no compaction, which drains the pipeline, in 12 frames)
    tr = ttrk.Tracker(_config(kmax=32, deterministic_mapping=True, pipeline_depth=4))
    steps = []  # (frame index, frames recorded, frames in flight) at each fused step
    orig = ttrk.track_frame

    def track(*a, **kw):
        steps.append((i, len(tr.trajectory), len(tr._pipeline)))
        return orig(*a, **kw)

    monkeypatch.setattr(ttrk, "track_frame", track)
    for i, img in enumerate(imgs):
        tr.process(img, 0.05 * i)
        assert len(tr.trajectory) + len(tr._pipeline) == i + 1
    steady = [s for s in steps if s[0] >= steps[0][0] + 4]
    assert steady, steps
    for i, recorded, in_flight in steady:
        # frames i-3 .. i-1 in flight: the newest consumed outcome is i-4's
        assert in_flight == 3 and recorded == i - 3, steps
    assert len(tr._pipeline) == 4
    tr.settle()
    assert not tr._pipeline
    ts = [f.timestamp for f in tr.trajectory]
    assert ts == [0.05 * i for i in range(N)]
    oks = [f.ok for f in tr.trajectory]
    assert True in oks and all(oks[oks.index(True):]) and tr.state == ttrk.OK
    assert tr.async_mapper is not None and tr.async_mapper.n_processed >= 1
    tr.shutdown()


def test_inertial_session_holds_depth_one():
    n = 10
    R, t, imu = entry.vi_render_trajectory(n)
    planes = entry.plane_scene(3)
    K = (350.0, 350.0, 128.0, 96.0)
    imgs = [entry.render_planes(planes, K, SMALL["img_wh"], R[i], t[i]) for i in range(n)]
    cfg = entry.tracker_config("cpu", img_wh=SMALL["img_wh"], K=K, sensor="mono-imu",
                               orb=torb.OrbConfig(300, 4), kmax=32, lmax=1024, local_window=6,
                               kf_max_frames=3, deterministic_mapping=True)
    assert cfg.pipeline_depth == 6
    tr = ttrk.Tracker(cfg)
    for i in range(n):
        tr.process(imgs[i], (i + 1) / 10.0, imu=imu[i])
        assert not tr._pipeline and len(tr.trajectory) == i + 1
    m = tr.async_mapper
    assert m is not None and m.n_processed >= 1 and m._vi_ctx is not None
    kf_rows = sorted(m._vi_ctx.imu.kf_buffers)
    assert kf_rows and not tr.imu.initialized
    tr.sync_mapping()
    assert sorted(tr.imu.kf_buffers) == sorted(m._vi_ctx.imu.kf_buffers)
    assert tinv.check_all(tr.map) == []
    tr.shutdown()
