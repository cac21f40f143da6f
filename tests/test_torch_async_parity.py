"""The port's background mapper against the JAX package's, and the gates of
tests/test_async_accuracy.py on the port. All slow: the JAX side compiles
every stage of its tracker and mapper, and the accuracy sessions run at
their 512x384.

- Parity on the deterministic schedule: the port's Tracker and the JAX
  Tracker(deterministic_mapping=True, pipeline_depth=1) on the same
  frames, the port fed the JAX package's features and two-view minimal
  sets, the JAX side with the ok-only add_observations (see
  test_torch_mapping.py), at the size of test_torch_system.py (256x192,
  OrbConfig(300, 4), kmax 8 / 32, lmax 1024): a mono session and an RGB-D
  session keep the same states and keyframe rows frame by frame, the same
  keyframe timestamps, inliers within max(2, 2%), poses within 1e-3 and
  landmark counts within 2% (test_torch_system.py's tolerances); a
  mono-inertial session keeps the same states and keyframe rows up to the
  IMU init, which both mappers run on the same frame, with the init's
  scale within 5% and its commit's gauge scale carried to both trackers.
- The six tests of tests/test_async_accuracy.py on the port, on the
  free-running thread (the TrackerConfig defaults), with their gates:
  mono ATE, RGB-D metric ATE, loop closing, relocalization after a
  blackout, the IMU init and metric scale, and two runs' consistency.
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

from orb_slam3_tpu.atlas import ops as jops
from orb_slam3_tpu.frontend import orb as jorb
from orb_slam3_tpu.tracking import tracker as jtrk
from orb_slam3_tpu_torch import convert, entry
from orb_slam3_tpu_torch.api import evaluate as teval
from orb_slam3_tpu_torch.frontend import orb as torb
from orb_slam3_tpu_torch.place import vocab as tvocab
from orb_slam3_tpu_torch.tracking import tracker as ttrk
from synthetic_scene import PlaneScene, orbit_trajectory
from test_torch_depth_mapping import depth_config, jax_depth_config
from test_torch_depth_session import assert_sessions_agree, depth_inputs
from test_torch_mapping import (K_NP, WH, jax_add_observations_ok_only, jax_config,
                                jax_features, port_tracker, use_jax_minimal_sets)

torch.set_num_threads(1)
DETERMINISTIC = dict(async_mapping=True, deterministic_mapping=True, pipeline_depth=1)


@pytest.fixture
def jax_ok_only(monkeypatch):
    jax.clear_caches()
    monkeypatch.setattr(jops, "add_observations", jax_add_observations_ok_only)
    yield
    jax.clear_caches()


def _drive(t, j, frames, **inputs):
    rec_t, rec_j = [], []
    for i, frame in enumerate(frames):
        kw = {k: v[i] for k, v in inputs.items()}
        t.process(frame, 0.05 * i, **kw)
        j.process(frame, 0.05 * i, **kw)
        j.settle()
        rec_t.append((t.state, t.last_kf_row, t.last_inliers))
        rec_j.append((j.state, j.last_kf_row, j.last_inliers))
    t.settle()
    return rec_t, rec_j


@pytest.mark.slow
def test_mono_session_matches_jax_deterministic_schedule(jax_ok_only, monkeypatch):
    imgs, _, tf, _ = jax_features(14)
    use_jax_minimal_sets(monkeypatch)
    t = port_tracker(tf, **DETERMINISTIC)
    j = jtrk.Tracker(dataclasses.replace(jax_config(t.cfg), **DETERMINISTIC))
    rec_t, rec_j = _drive(t, j, imgs)
    kf_ts = assert_sessions_agree(t, j, rec_t, rec_j)
    assert len(kf_ts) >= 4
    m, jm = t.async_mapper, j.async_mapper
    assert m.inline and jm.inline
    assert (m.n_processed, m.n_ba_runs, m.n_ba_skips) == (jm.n_processed, jm.n_ba_runs,
                                                          jm.n_ba_skips)
    t.shutdown()
    j.shutdown()


@pytest.mark.slow
def test_rgbd_session_matches_jax_deterministic_schedule(jax_ok_only):
    frames, tf = depth_inputs("rgbd", 12, seed=1)
    t = ttrk.Tracker(dataclasses.replace(depth_config("rgbd", 20.0, 20.0), **DETERMINISTIC))
    it = iter(tf)
    t._extract = lambda img: next(it)
    j = jtrk.Tracker(dataclasses.replace(jax_depth_config(t.cfg), **DETERMINISTIC))
    rec_t, rec_j = _drive(t, j, [a for a, _ in frames], depth_map=[b for _, b in frames])
    kf_ts = assert_sessions_agree(t, j, rec_t, rec_j)
    assert len(kf_ts) >= 3 and all(r[0] == ttrk.OK for r in rec_t)
    t.shutdown()
    j.shutdown()


@pytest.mark.slow
def test_mono_inertial_session_matches_jax_through_the_imu_init(jax_ok_only, monkeypatch):
    n = 34
    wh, K = (256, 192), (350.0, 350.0, 128.0, 96.0)
    K8 = np.array(list(K) + [0.0] * 4, np.float32)
    ocfg = jorb.OrbConfig(n_features=300, n_levels=4)
    R, t_, imu = entry.vi_render_trajectory(n)
    planes = entry.plane_scene(3)
    imgs = [entry.render_planes(planes, K, wh, R[i], t_[i]) for i in range(n)]
    zero = jnp.zeros((5,), jnp.float32)
    tf = [convert.features(f.xy, f.response, f.angle, f.octave, f.descriptors, f.valid,
                           device="cpu")
          for f in (jtrk._extract_features(jnp.asarray(im, jnp.float32), jnp.asarray(K8), zero,
                                           ocfg, False) for im in imgs)]
    use_jax_minimal_sets(monkeypatch)
    jcfg = jtrk.TrackerConfig(K=jnp.asarray(K8), img_wh=wh, sensor="mono-imu", orb=ocfg,
                              kmax=32, lmax=1024, local_window=6, kf_max_frames=3,
                              **DETERMINISTIC)
    port = ttrk.Tracker(convert.tracker_config(jcfg, device="cpu"))
    assert port.cfg.deterministic_mapping and port.cfg.pipeline_depth == 1
    it = iter(tf)
    port._extract = lambda img: next(it)
    jt = jtrk.Tracker(jcfg)
    rec = []
    for i in range(n):
        ts = (i + 1) / 10.0
        jt.process(imgs[i], ts, imu=imu[i])
        jt.settle()
        port.process(imgs[i], ts, imu=imu[i])
        rec.append(((jt.state, jt.last_kf_row, jt.imu.initialized),
                    (port.state, port.last_kf_row, port.imu.initialized)))
    init_j = next(i for i, r in enumerate(rec) if r[0][2])
    init_t = next(i for i, r in enumerate(rec) if r[1][2])
    assert init_j == init_t
    assert [r[0] for r in rec[:init_j + 1]] == [r[1] for r in rec[:init_j + 1]]
    ev_j = [e for e in jt.async_mapper._vi_ctx.debug_events if "scale" in e]
    ev_t = [e for e in port.async_mapper._vi_ctx.debug_events if "scale" in e]
    assert ev_t[0]["event"] == ev_j[0]["event"] == "init"
    assert abs(ev_t[0]["scale"] - float(ev_j[0]["scale"])) < 0.05 * float(ev_j[0]["scale"])
    # the tracker took the commit's gauge: its events, and an initialized IMU
    assert [e["event"] for e in port.debug_events if "scale" in e][0] == "init"
    assert port.imu.initialized and jt.imu.initialized
    port.shutdown()
    jt.shutdown()


# ---------------------------------------------------------------------------
# tests/test_async_accuracy.py on the port (the free-running thread)
# ---------------------------------------------------------------------------

K_REF = (350.0, 350.0, 256.0, 192.0)
K_REF8 = np.array(list(K_REF) + [0.0] * 4, np.float32)
WH_REF = (512, 384)


def _config(**fields):
    return entry.tracker_config("cpu", img_wh=WH_REF, K=K_REF,
                                orb=torb.OrbConfig(600, 4), **fields)


def _run_mono(n_frames=40, seed=0):
    scene = PlaneScene(K_REF8, img_wh=WH_REF, two_planes=True, seed=seed)
    R_gt, t_gt = orbit_trajectory(n_frames)
    t = ttrk.Tracker(_config(kmax=32, lmax=4096, local_window=6))
    assert t.cfg.async_mapping and not t.cfg.deterministic_mapping
    for i in range(n_frames):
        t.process(scene.render(R_gt[i], t_gt[i]), i * 0.05)
    t.sync_mapping()
    return t, R_gt, t_gt


def _scaled_ate(t, R_gt, t_gt, with_scale=True):
    ts, R, tt, ok = t.poses()
    est = teval.camera_centers(R[ok], tt[ok])
    gt = teval.camera_centers(R_gt[ok], t_gt[ok])
    return teval.ate_rmse(ts[ok], est, ts[ok], gt, with_scale=with_scale), ok


@pytest.mark.slow
def test_async_mono_ate():
    t, R_gt, t_gt = _run_mono()
    (rmse, _, s), ok = _scaled_ate(t, R_gt, t_gt)
    assert t.state == ttrk.OK
    assert ok.sum() >= 0.7 * len(ok), f"tracked {ok.sum()}/{len(ok)}"
    assert rmse < 0.35, f"async mono ATE {rmse:.4f} (scale {s:.3f})"
    t.shutdown()


@pytest.mark.slow
def test_async_rgbd_ate_metric():
    scene = PlaneScene(K_REF8, img_wh=WH_REF, two_planes=True, seed=1)
    n = 25
    R_gt, t_gt = orbit_trajectory(n)
    t = ttrk.Tracker(_config(sensor="rgbd", bf=35.0, th_depth=20.0, kmax=32, lmax=4096,
                             local_window=6))
    for i in range(n):
        img, depth = scene.render_with_depth(R_gt[i], t_gt[i])
        t.process(img, i * 0.05, depth_map=depth)
    t.sync_mapping()
    (rmse, _, _), ok = _scaled_ate(t, R_gt, t_gt, with_scale=False)
    assert t.state == ttrk.OK
    assert ok.sum() >= 0.8 * n
    assert rmse < 0.10, f"async RGB-D metric ATE {rmse:.4f}"
    t.shutdown()


def _room_tracker(scene, kmax=96):
    """test_async_accuracy.py's RGB-D tracker with a vocabulary trained on 4
    views of a smaller circle, on the free-running schedule."""
    t = ttrk.Tracker(_config(sensor="rgbd", bf=35.0, th_depth=20.0, kmax=kmax, lmax=8192,
                             local_window=6, kf_max_frames=2))
    Rv, tv = entry.loop_trajectory(4, radius=1.0, start_angle=0.4)
    descs = []
    for i in range(4):
        f = torb.extract(torch.from_numpy(scene.render(Rv[i], tv[i])), t.cfg.orb)
        descs.append(f.descriptors.numpy()[f.valid.numpy()])
    t.attach_loop_closer(tvocab.train(np.concatenate(descs), branching=8, depth=3,
                                      device="cpu"))
    return t


@pytest.mark.slow
def test_async_loop_closing():
    scene = entry.room_scene(K_REF8, img_wh=WH_REF, seed=3, exposure_jitter=0.04, device="cpu")
    n = 110
    R_gt, t_gt = entry.loop_trajectory(n, radius=1.6, loops=1.12)
    t = _room_tracker(scene)
    for i in range(n):
        img, depth = scene.render_with_depth(R_gt[i], t_gt[i])
        t.process(img, i * 0.05, depth_map=depth)
    t.sync_mapping()
    assert t.loop_closer.n_loops + t.loop_closer.n_merges >= 1, \
        "no loop/merge closed on the async schedule"
    s = t.map
    rows = np.flatnonzero(s.kf_valid.numpy())
    idx = np.clip(np.round(s.kf_timestamp.numpy()[rows] / 0.05).astype(int), 0, n - 1)
    est = teval.camera_centers(s.kf_R.numpy()[rows], s.kf_t.numpy()[rows])
    gt = teval.camera_centers(R_gt[idx], t_gt[idx])
    rmse, _, _ = teval.ate_rmse(idx.astype(float), est, idx.astype(float), gt, with_scale=False)
    assert rmse < 0.20, f"async post-loop KF ATE {rmse:.4f}"
    t.shutdown()


@pytest.mark.slow
def test_async_relocalization():
    scene = entry.room_scene(K_REF8, img_wh=WH_REF, seed=5, device="cpu")
    R_gt, t_gt = entry.loop_trajectory(40, radius=1.5, loops=0.35)
    t = _room_tracker(scene)
    blank = np.zeros((WH_REF[1], WH_REF[0]), np.float32)
    k = 0
    for i in range(24):
        img, depth = scene.render_with_depth(R_gt[i], t_gt[i])
        t.process(img, k * 0.05, depth_map=depth)
        k += 1
    for _ in range(6):
        t.process(blank, k * 0.05, depth_map=blank)
        k += 1
    t.settle()
    assert t.state != ttrk.OK
    relocalized = False
    for i in range(24, 40):
        img, depth = scene.render_with_depth(R_gt[i], t_gt[i])
        t.process(img, k * 0.05, depth_map=depth)
        t.settle()
        k += 1
        if t.state == ttrk.OK:
            relocalized = True
            break
    assert relocalized, "never relocalized after blackout (async)"
    t.shutdown()


@pytest.mark.slow
def test_async_vi_init_and_metric_scale():
    scene = PlaneScene(K_REF8, img_wh=WH_REF, two_planes=True, seed=3)
    n = 60
    R_gt, t_gt, packets = entry.vi_render_trajectory(n)
    t = ttrk.Tracker(_config(sensor="mono-imu", kmax=64, lmax=8192, local_window=6,
                             kf_max_frames=3))
    for i in range(n):
        t.process(scene.render(R_gt[i], t_gt[i]), (i + 1) * 0.1, imu=packets[i])
    t.settle()
    t.sync_mapping()
    assert t.imu.initialized, "async VI never initialized the IMU"
    (_, _, s_fit), ok = _scaled_ate(t, R_gt, t_gt)
    assert ok.sum() >= 0.6 * n
    assert abs(s_fit - 1.0) < 0.2, f"async VI metric scale {s_fit:.3f}"
    t.shutdown()


@pytest.mark.slow
def test_async_schedule_consistency():
    ates = []
    for _ in range(2):
        t, R_gt, t_gt = _run_mono(seed=0)
        (rmse, _, _), _ = _scaled_ate(t, R_gt, t_gt)
        ates.append(rmse)
        t.shutdown()
    assert max(ates) < 0.35, ates
