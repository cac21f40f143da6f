"""The port at the reference's operating scale: arena compaction and growth
inside a live session, with the mapper, the loop closer and the keyframe
database.

- Tier-1, the port alone at a small size (256x192, OrbConfig(300, 4), kmax
  8, lmax 1024, a keyframe every frame, RGB-D, the deterministic schedule,
  a vocabulary trained in the test): the session compacts and grows the
  arena mid-way. At each growth every tracker-side buffer indexed by
  landmark or keyframe has the arena's new length and still names the same
  landmarks (checked by landmark position), the keyframe database holds
  exactly the valid keyframes, and the Atlas invariants hold; the mapper
  continues on the grown arena.
- Behind `slow`, the port twins of
  tests/test_reference_scale.py::test_reference_scale_session (420 RGB-D
  frames of the room, a blackout, a new map, a cross-map merge, growth past
  kmax 64) and tests/test_compaction.py::test_e2e_churn_compacts_and_grows
  (60 frames, a keyframe every frame, kmax 16) at the tests' own
  configurations and gates; the churn twin also runs the JAX tracker on the
  same frames with the JAX features fed to both and holds the two to the
  same compactions and growths and the same keyframe poses.
"""

import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

from orb_slam3_tpu.atlas import ops as jops
from orb_slam3_tpu.frontend import camera as jcam
from orb_slam3_tpu.frontend import orb as jorb
from orb_slam3_tpu.tracking import tracker as jtrk
from orb_slam3_tpu_torch import convert, entry
from orb_slam3_tpu_torch.api import evaluate as teval
from orb_slam3_tpu_torch.api.system import System
from orb_slam3_tpu_torch.atlas import invariants as tinv
from orb_slam3_tpu_torch.atlas import ops as tops
from orb_slam3_tpu_torch.frontend import orb as torb
from orb_slam3_tpu_torch.tracking import tracker as ttrk
from synthetic_scene import PlaneScene, orbit_trajectory
from test_torch_mapping import jax_add_observations_ok_only

torch.set_num_threads(2)

SMALL_K = (200.0, 200.0, 128.0, 96.0)
SMALL_WH = (256, 192)


def _sorted_rows(a):
    a = np.asarray(a, np.float64).reshape(len(a), -1)
    return a[np.lexsort(a.T[::-1])] if len(a) else a


def tracker_buffers(tr, s):
    """What the tracker keeps indexed by landmark or keyframe row, named by
    landmark position (and keyframe pose): the landmarks the last frame
    tracked, the landmark of each of its features, the buffered statistics
    of the next package, the last keyframe's pose."""
    pos = s.lm_pos.numpy()
    valid = s.lm_valid.numpy()
    out = {"kmax": s.kmax, "lmax": s.lmax}
    if tr._tracked_lms is not None:
        m = tr._tracked_lms.numpy()
        out["tracked_len"] = len(m)
        out["tracked"] = _sorted_rows(pos[m & valid[: len(m)]])
    if tr._feat_lm is not None:
        fl = tr._feat_lm.numpy()
        out["feat_bound"] = fl >= 0
        out["feat_pos"] = pos[np.clip(fl, 0, len(pos) - 1)][fl >= 0]
    vis, fnd = tr._stats_reduce()
    if vis is not None:
        vis, fnd = vis.numpy(), fnd.numpy()
        out["stats_len"] = (len(vis), len(fnd))
        keep = valid & ((vis != 0) | (fnd != 0))
        out["stats"] = _sorted_rows(np.concatenate([pos[keep], vis[keep, None],
                                                    fnd[keep, None]], 1))
    if tr.last_kf_row >= 0:
        out["last_kf"] = np.concatenate([s.kf_R[tr.last_kf_row].numpy().ravel(),
                                         s.kf_t[tr.last_kf_row].numpy()])
    return out


@pytest.fixture(scope="module")
def growth_session():
    """7 RGB-D frames of PlaneScene seed 11 (orbit advance 0.02) through
    System.track_rgbd with kmax 8, lmax 1024 and a keyframe every frame: the
    6th frame's _maybe_compact compacts and doubles both. Records the
    tracker's buffers just before each compaction (after the frames in
    flight and the mapper's queue are drained) and just after it."""
    planes = entry.plane_scene(11)
    R, t = entry.orbit_trajectory(7, advance=0.02)
    frames = [entry.render_with_depth(planes, SMALL_K, SMALL_WH, R[i], t[i]) for i in range(7)]
    cfg = entry.tracker_config("cpu", img_wh=SMALL_WH, K=SMALL_K, sensor="rgbd", bf=20.0,
                               orb=torb.OrbConfig(300, 4), kmax=8, lmax=1024, local_window=4,
                               kf_max_frames=1, deterministic_mapping=True)
    voc = entry.train_vocabulary([f[0] for f in frames[:3]], cfg)
    system = System(config=cfg, vocabulary=voc)
    tr = system.tracker
    rec = {"before": [], "after": [], "frame": []}
    orig_compact, orig_maybe = tops.compact, tr._maybe_compact

    def compact(s):
        rec["before"].append(tracker_buffers(tr, s))
        rec["frame"].append(len(tr.trajectory))
        return orig_compact(s)

    def maybe_compact():
        n = len(rec["before"])
        orig_maybe()
        if len(rec["before"]) > n:
            s = tr.map
            rec["after"].append(dict(
                tracker_buffers(tr, s), cfg=(tr.cfg.kmax, tr.cfg.lmax),
                db_valid=tr.loop_closer.db.valid.numpy().copy(),
                kf_valid=s.kf_valid.numpy().copy(), violations=tinv.check_all(s)))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tops, "compact", compact)
        mp.setattr(tr, "_maybe_compact", maybe_compact)
        for i, (img, depth) in enumerate(frames):
            system.track_rgbd(img, depth, 0.05 * i)
        tr.sync_mapping()
    yield dict(system=system, rec=rec, R=R, t=t)
    system.shutdown()


def _growths(rec):
    assert rec["after"] and len(rec["before"]) == len(rec["after"])
    grown = [(b, a) for b, a in zip(rec["before"], rec["after"])
             if (a["kmax"], a["lmax"]) != (b["kmax"], b["lmax"])]
    assert grown, [(b["kmax"], b["lmax"]) for b in rec["before"]]
    return grown


def test_growth_keeps_every_tracker_buffer_on_its_landmarks(growth_session):
    rec = growth_session["rec"]
    assert rec["frame"][0] < 6  # mid-way: the session tracks on after it
    for b, a in _growths(rec):
        assert a["kmax"] == 2 * b["kmax"] and a["lmax"] == 2 * b["lmax"]
        assert a["cfg"] == (a["kmax"], a["lmax"])
        assert a["tracked_len"] == a["lmax"]
        np.testing.assert_array_equal(a["tracked"], b["tracked"])
        assert len(a["tracked"]) > 50
        np.testing.assert_array_equal(a["feat_bound"], b["feat_bound"])
        np.testing.assert_array_equal(a["feat_pos"], b["feat_pos"])
        assert a["feat_bound"].sum() > 50
        np.testing.assert_array_equal(a["last_kf"], b["last_kf"])
        # a keyframe every frame hands each frame's statistics to its
        # package: a buffer left over is padded and follows its landmarks
        assert ("stats" in a) == ("stats" in b)
        if "stats" in a:
            assert a["stats_len"] == (a["lmax"], a["lmax"])
            np.testing.assert_array_equal(a["stats"], b["stats"])


def test_growth_rebuilds_the_database_on_the_valid_keyframes(growth_session):
    for _, a in _growths(growth_session["rec"]):
        assert len(a["db_valid"]) == a["kmax"]
        np.testing.assert_array_equal(a["db_valid"], a["kf_valid"])
        assert a["kf_valid"].sum() >= 5 and a["violations"] == []


def test_the_session_goes_on_in_the_grown_arena(growth_session):
    """The mapper's state, the database and the tracker agree on the grown
    size, the map is sound and the trajectory follows the truth."""
    tr = growth_session["system"].tracker
    m = tr.async_mapper
    assert m._state.kmax == tr.map.kmax == tr.cfg.kmax > 8
    assert m._state.lmax == tr.map.lmax == tr.cfg.lmax > 1024
    assert tr.loop_closer.db.valid.shape[0] == tr.map.kmax
    assert int(tr.map.kf_valid.sum()) >= 6 and tr.state == ttrk.OK
    assert tinv.check_all(tr.map) == []
    ts, R, t, ok = tr.poses()
    assert ok.all()
    est = teval.camera_centers(R, t)
    gt = teval.camera_centers(growth_session["R"], growth_session["t"])
    assert teval.ate_rmse(ts, est, ts, gt, with_scale=False)[0] < 0.05


# ---------------------------------------------------------------------------
# the reference's sessions at their own configurations (slow)
# ---------------------------------------------------------------------------

@pytest.mark.slow
def test_reference_scale_session():
    """tests/test_reference_scale.py::test_reference_scale_session on the
    port: the room (seed 21) at 384x288, 420 frames of 2.3 turns, frames
    180-186 blank, OrbConfig(400, 3), kmax 64, lmax 8192, window 6,
    kf_max_frames 2, the deterministic schedule; the test's gates."""
    K = (260.0, 260.0, 192.0, 144.0)
    wh = (384, 288)
    scene = entry.room_scene(np.array(K), img_wh=wh, seed=21, device="cpu")
    n = 420
    R_gt, t_gt = entry.loop_trajectory(n, radius=1.6, loops=2.3)
    cfg = entry.tracker_config("cpu", img_wh=wh, K=K, sensor="rgbd", bf=26.0, th_depth=20.0,
                               orb=torb.OrbConfig(400, 3), kmax=64, lmax=8192, local_window=6,
                               kf_max_frames=2, deterministic_mapping=True)
    Rv, tv = entry.loop_trajectory(4, radius=1.0, start_angle=0.4)
    voc = entry.train_vocabulary([scene.render(Rv[i], tv[i]) for i in range(4)], cfg)
    system = System(config=cfg, vocabulary=voc)
    tr = system.tracker
    blank = np.zeros((wh[1], wh[0]), np.float32)
    frame_s = []
    for i in range(n):
        if 180 <= i < 187:
            img, depth = blank, np.ones_like(blank)
        else:
            img, depth = scene.render_with_depth(R_gt[i], t_gt[i])
        f0 = time.perf_counter()
        system.track_rgbd(img, depth, i * 0.1)
        frame_s.append(time.perf_counter() - f0)
    tr.sync_mapping()
    try:
        s = tr.map
        assert int(s.n_maps) >= 2, "blackout never spawned a second map"
        assert tr.loop_closer.n_merges >= 1, "maps never merged after the loss"
        kv = s.kf_valid.numpy()
        ids = s.kf_map_id.numpy()[kv]
        assert len(np.unique(ids)) == 1, f"atlas not unified: maps {set(ids)}"
        assert int(kv.sum()) >= 100, f"only {int(kv.sum())} keyframes"
        assert s.kmax > 64, "arena never grew"
        kc = teval.camera_centers(s.kf_R.numpy()[kv], s.kf_t.numpy()[kv])
        kts = s.kf_timestamp.numpy()[kv]
        fr = np.clip((kts / 0.1 + 0.5).astype(int), 0, n - 1)
        gtc = teval.camera_centers(R_gt[fr], t_gt[fr])
        rmse, nm, _ = teval.ate_rmse(kts, kc, kts, gtc, with_scale=False)
        assert rmse < 0.30, f"reference-scale ATE {rmse:.3f} over {nm} KFs"
        early, late = np.median(frame_s[40:140]), np.median(frame_s[-100:])
        assert late < 4.0 * early + 0.05, (early, late)
        assert not tinv.check_all(s)
    finally:
        system.shutdown()


CHURN_K = (350.0, 350.0, 256.0, 192.0)
CHURN_WH = (512, 384)


@pytest.mark.slow
def test_churn_compacts_and_grows_as_the_jax_tracker(monkeypatch):
    """tests/test_compaction.py::test_e2e_churn_compacts_and_grows on the
    port (PlaneScene seed 11 at 512x384, 60 RGB-D frames, OrbConfig(400, 4),
    kmax 16, lmax 2048, window 5, a keyframe every frame, synchronous), with
    its gates, and the JAX Tracker(async_mapping=False, pipeline_depth=1)
    on the same frames, the JAX features fed to both: the two compact and
    grow at the same frames to the same kmax / lmax, insert the same
    keyframes, and keep keyframe poses within 1e-3."""
    jax.clear_caches()
    monkeypatch.setattr(jops, "add_observations", jax_add_observations_ok_only)
    scene = PlaneScene(np.array(CHURN_K), img_wh=CHURN_WH, two_planes=True, seed=11)
    n = 60
    R_gt, t_gt = orbit_trajectory(n, advance=0.02)
    ocfg = jorb.OrbConfig(n_features=400, n_levels=4)
    K8 = np.asarray(jcam.make_pinhole(*CHURN_K))
    zero = jnp.zeros((5,), jnp.float32)
    frames, tf = [], []
    for i in range(n):
        frames.append(scene.render_with_depth(R_gt[i], t_gt[i]))
        f = jtrk._extract_features(jnp.asarray(frames[-1][0], jnp.float32), jnp.asarray(K8),
                                   zero, ocfg, False)
        tf.append(convert.features(f.xy, f.response, f.angle, f.octave, f.descriptors, f.valid,
                                   device="cpu"))
    t = ttrk.Tracker(ttrk.TrackerConfig(
        K=convert.camera(K8, "cpu"), img_wh=CHURN_WH, sensor="rgbd", bf=35.0, th_depth=20.0,
        orb=convert.orb_config(ocfg), kmax=16, lmax=2048, local_window=5, kf_max_frames=1,
        async_mapping=False, pipeline_depth=1))
    it = iter(tf)
    t._extract = lambda img: next(it)
    j = jtrk.Tracker(jtrk.TrackerConfig(
        K=jnp.asarray(K8), img_wh=CHURN_WH, sensor="rgbd", bf=35.0, th_depth=20.0, orb=ocfg,
        kmax=16, lmax=2048, local_window=5, kf_max_frames=1, async_mapping=False,
        pipeline_depth=1))
    events = {"port": [], "jax": []}
    for side, mod, tr in (("port", tops, t), ("jax", jops, j)):
        orig_c, orig_g = mod.compact, mod.grow

        def compact(s, _o=orig_c, _ev=events[side], _tr=tr):
            _ev.append(("compact", len(_tr.trajectory), s.kmax, s.lmax))
            return _o(s)

        def grow(s, kmax=None, lmax=None, _o=orig_g, _ev=events[side], _tr=tr):
            _ev.append(("grow", len(_tr.trajectory), kmax or s.kmax, lmax or s.lmax))
            return _o(s, kmax=kmax, lmax=lmax)

        monkeypatch.setattr(mod, "compact", compact)
        monkeypatch.setattr(mod, "grow", grow)
    for i, (img, depth) in enumerate(frames):
        t.process(img, i * 0.05, depth_map=depth)
        j.process(img, i * 0.05, depth_map=depth)
        j.settle()
    t.settle()
    j.shutdown()
    # tests/test_compaction.py's gates on the port
    ts, R, tt, ok = t.poses()
    assert ok.sum() >= 0.8 * n, f"tracked {ok.sum()}/{n}"
    est = teval.camera_centers(R[ok], tt[ok])
    gt = teval.camera_centers(R_gt[ok], t_gt[ok])
    rmse = teval.ate_rmse(ts[ok], est, ts[ok], gt, with_scale=False)[0]
    assert rmse < 0.15, f"churn ATE {rmse:.3f}"
    assert not tinv.check_all(t.map)
    assert int(t.map.n_kf) < 60
    # the same arena history and keyframes as the JAX tracker
    assert any(e[0] == "grow" for e in events["port"]), events
    assert events["port"] == events["jax"]
    assert (t.map.kmax, t.map.lmax) == (j.map.kmax, j.map.lmax)
    kv_t, kv_j = t.map.kf_valid.numpy(), np.asarray(j.map.kf_valid)
    np.testing.assert_array_equal(t.map.kf_timestamp.numpy()[kv_t],
                                  np.asarray(j.map.kf_timestamp)[kv_j])
    np.testing.assert_allclose(t.map.kf_R.numpy()[kv_t], np.asarray(j.map.kf_R)[kv_j], atol=1e-3)
    np.testing.assert_allclose(t.map.kf_t.numpy()[kv_t], np.asarray(j.map.kf_t)[kv_j], atol=1e-3)
