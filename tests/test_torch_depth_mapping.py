"""The port's depth-sensor mapping stages against the JAX package, and the
port's RGB-D session on the CPU.

The map comes from a 12-frame RGB-D session of the port's Tracker on the
CPU (PlaneScene seed 1 at 256x192, OrbConfig(300, 4), kmax 8, lmax 1024,
local window 4, bf = 200 x 0.1, th_depth 20): the state just before its
last keyframe insertion and that keyframe's package, carried across to the
JAX package, are the input of both sides:

- triangulate_pair(use_depth=True) against two neighbours: accept masks
  equal on >= 99% of features, the matched feature equal where both accept,
  Xw within 1e-4 relative, and points placed at their measured depth that
  the parallax gate alone would refuse;
- map_stage_pre with the depth-landmark branch, on the real package and with
  60 of its depths made bitwise equal across the 100-nearest cut (which
  features become landmarks then depends on the tie order: jnp.argsort is
  stable): keyframe row, BA window and n_fixed equal, landmark counts within
  1%, bindings equal on >= 99% of each row, the new keyframe's depth
  landmarks equal;
- local_ba(stereo=True) over that window (3-dim edges, the third row
  weightless where ur < 0): bindings equal on >= 99% of each row, keyframe
  poses within 1e-4, 99% of landmark positions within 1e-3 relative.

The session itself (no JAX): it initializes on frame 0 from depth, tracks
every frame with stereo rows through K2's plain version, inserts keyframes
with depth landmarks, and follows the truth within the reference test's
unscaled ATE gate; it then runs in localization-only mode for 4 frames
without touching the map.
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
from orb_slam3_tpu.mapping import local_mapper as jlm
from orb_slam3_tpu.mapping import pipeline as jpipe
from orb_slam3_tpu.tracking import tracker as jtrk
from orb_slam3_tpu_torch import convert, entry
from orb_slam3_tpu_torch.api import evaluate as teval
from orb_slam3_tpu_torch.atlas import invariants as tinv
from orb_slam3_tpu_torch.mapping import local_mapper as tlm
from orb_slam3_tpu_torch.mapping import pipeline as tpipe
from orb_slam3_tpu_torch.tracking import tracker as ttrk
from orb_slam3_tpu_torch.utils.timing import GLOBAL_TIMER
from test_torch_mapping import (K_NP, OCFG, SF, WH, jax_add_observations_ok_only, jax_map,
                                jax_package)

torch.set_num_threads(1)
BF = 200.0 * 0.1
N_MAP, N_LOC = 12, 4


def rgbd_frames(n, seed=1):
    planes = entry.plane_scene(seed)
    R, t = entry.orbit_trajectory(n)
    K = tuple(K_NP[:4])
    return [entry.render_with_depth(planes, K, WH, R[i], t[i]) for i in range(n)], R, t


def depth_config(sensor="rgbd", bf=BF, th_depth=20.0):
    return ttrk.TrackerConfig(K=convert.camera(K_NP, "cpu"), img_wh=WH,
                              orb=convert.orb_config(OCFG), kmax=8, lmax=1024, local_window=4,
                              sensor=sensor, bf=bf, th_depth=th_depth, async_mapping=False,
                              pipeline_depth=1)


def jax_depth_config(tcfg):
    return jtrk.TrackerConfig(K=jnp.asarray(K_NP), img_wh=WH, orb=OCFG, kmax=tcfg.kmax,
                              lmax=tcfg.lmax, local_window=tcfg.local_window,
                              sensor=tcfg.sensor, bf=tcfg.bf, th_depth=tcfg.th_depth,
                              async_mapping=False, pipeline_depth=1)


@pytest.fixture(scope="module")
def session():
    """The port's RGB-D session (N_MAP mapped frames, then N_LOC frames in
    localization mode) with the inputs of its last keyframe insertion."""
    frames, R_gt, t_gt = rgbd_frames(N_MAP + N_LOC)
    tr = ttrk.Tracker(depth_config())
    rec = []
    orig = tpipe.run_pre_stage

    def record(s, pkg, cfg, base_sensor, parent_row, scale_factors):
        rec.append((s, pkg, parent_row, base_sensor))
        return orig(s, pkg, cfg, base_sensor, parent_row, scale_factors)

    GLOBAL_TIMER.reset()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tpipe, "run_pre_stage", record)
        for i, (img, depth) in enumerate(frames[:N_MAP]):
            tr.process(img, 0.05 * i, depth_map=depth)
        mapped = dict(n_kf=int(tr.map.n_kf), n_lm=int(tr.map.n_lm), poses=tr.poses(),
                      kf_feat_lm=tr.map.kf_feat_lm.clone(), lm_pos=tr.map.lm_pos.clone())
        tr.sync_mapping()
        tr.mapping_paused = True
        states = []
        for i in range(N_MAP, N_MAP + N_LOC):
            img, depth = frames[i]
            tr.process(img, 0.05 * i, depth_map=depth)
            states.append(tr.state)
        tr.settle()
    s, pkg, parent, base = rec[-1]
    assert base == "rgbd" and pkg.feat_depth is not None
    return dict(tracker=tr, R_gt=R_gt, t_gt=t_gt, mapped=mapped, loc_states=states,
                js=jax_map(s), jpkg=jax_package(pkg), parent=parent, n_pre=len(rec),
                timer=GLOBAL_TIMER.summary())


@pytest.fixture(scope="module")
def jax_ok_only():
    """JAX programs traced with the ok-only add_observations (see
    test_torch_mapping.py), cleared around the module."""
    jax.clear_caches()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jops, "add_observations", jax_add_observations_ok_only)
        yield
    jax.clear_caches()


def test_rgbd_session_tracks_the_truth(session):
    tr = session["tracker"]
    ts, R, t, ok = session["mapped"]["poses"]
    assert ok.all() and len(ok) == N_MAP
    assert session["n_pre"] >= 2 and session["mapped"]["n_kf"] == session["n_pre"] + 1
    est = teval.camera_centers(R, t)
    gt = teval.camera_centers(session["R_gt"][:N_MAP], session["t_gt"][:N_MAP])
    rmse, _, scale = teval.ate_rmse(ts, est, ts, gt, with_scale=False)
    assert rmse < 0.10 and scale == 1.0, rmse
    assert tinv.check_all(tr.map) == []
    timer = session["timer"]
    assert timer["track.stereo_depth"]["n"] == N_MAP + N_LOC
    assert timer["map.pre"]["n"] == session["n_pre"]


def test_localization_mode_leaves_the_map_alone(session):
    tr = session["tracker"]
    mapped = session["mapped"]
    assert session["loc_states"] == [ttrk.OK] * N_LOC
    assert int(tr.map.n_kf) == mapped["n_kf"] and int(tr.map.n_lm) == mapped["n_lm"]
    assert torch.equal(tr.map.kf_feat_lm, mapped["kf_feat_lm"])
    assert torch.equal(tr.map.lm_pos, mapped["lm_pos"])
    assert tr._vo_buffer is not None and int(tr._vo_buffer[2].sum()) == 0  # th_depth_m 2 m
    c_est = -tr.last["R"].numpy().T @ tr.last["t"].numpy()
    i = N_MAP + N_LOC - 1
    c_gt = -session["R_gt"][i].T @ session["t_gt"][i]
    assert np.linalg.norm(c_est - c_gt) < 0.15, np.linalg.norm(c_est - c_gt)


def _with_keyframe(b):
    """The JAX state with the package's keyframe appended, depths included."""
    p = b["jpkg"]
    js, kf = jops.add_keyframe(b["js"], p.R, p.t, p.timestamp, p.feat_xy, p.feat_octave,
                               p.feat_angle, p.feat_desc, p.feat_valid, feat_lm=p.feat_lm,
                               feat_ur=p.feat_ur, feat_depth=p.feat_depth,
                               parent=jnp.int32(b["parent"]), prev=jnp.int32(b["parent"]))
    return js, int(kf)


@pytest.mark.parametrize("nbr_back", [1, 2])
def test_triangulate_pair_with_depth_matches_jax(session, jax_ok_only, nbr_back):
    js, kf = _with_keyframe(session)
    nbr = kf - nbr_back
    Xj, f1j, f2j, aj = (np.asarray(a) for a in jlm.triangulate_pair(
        0, jnp.asarray(K_NP), js, jnp.int32(kf), jnp.int32(nbr), jnp.asarray(SF),
        use_depth=True, min_depth=jnp.float32(0.1)))
    ts = convert.map_state(js, "cpu")
    Xt, f1t, f2t, at = (a.numpy() for a in tlm.triangulate_pair(
        0, convert.camera(K_NP, "cpu"), ts, kf, nbr, torch.from_numpy(SF), use_depth=True,
        min_depth=0.1))
    np.testing.assert_array_equal(f1t, f1j)
    assert aj.sum() >= (10 if nbr_back == 1 else 3), aj.sum()
    assert (at == aj).mean() >= 0.99, ((at != aj).sum(), aj.sum())
    both = at & aj
    np.testing.assert_array_equal(f2t[both], f2j[both])
    err = np.linalg.norm(Xt[both] - Xj[both], axis=1) / np.linalg.norm(Xj[both], axis=1)
    assert err.max() <= 1e-4, err.max()
    if nbr_back > 1:
        return
    # measured points: placed at their depth, some below the parallax gate
    meas = both & (ts.kf_feat_depth[kf].numpy() > 0.1)
    assert meas.sum() >= 5
    Xm = Xt[meas]
    c1 = -ts.kf_R[kf].numpy().T @ ts.kf_t[kf].numpy()
    c2 = -ts.kf_R[nbr].numpy().T @ ts.kf_t[nbr].numpy()
    r1, r2 = Xm - c1, Xm - c2
    cosp = (r1 * r2).sum(1) / np.linalg.norm(r1, axis=1) / np.linalg.norm(r2, axis=1)
    assert (cosp >= 0.9998).any(), cosp.min()


def _tied(jpkg, js):
    """The package with 60 of its free measured depths set bitwise equal, the
    group straddling the 100-nearest cut of map_stage_pre."""
    depth = np.array(jpkg.feat_depth)
    free = np.array(jpkg.feat_valid) & ~(np.array(jpkg.feat_lm) >= 0) & (depth > 0.1)
    order = np.flatnonzero(free)[np.argsort(depth[free], kind="stable")]
    assert order.size >= 140, order.size
    group = order[80:140]
    depth[group] = depth[order[80]]
    return dataclasses.replace(jpkg, feat_depth=jnp.asarray(depth)), group


@pytest.mark.parametrize("ties", [False, True])
def test_map_stage_pre_with_depth_matches_jax(session, jax_ok_only, ties):
    b = session
    jpkg, group = _tied(b["jpkg"], b["js"]) if ties else (b["jpkg"], None)
    tcfg = depth_config()
    jsf = jnp.asarray(SF)
    js, kf_j, rows_j, nf_j = jpipe.run_pre_stage(b["js"], jpkg, jax_depth_config(tcfg), "rgbd",
                                                 b["parent"], jsf)
    ts, kf_t, rows_t, nf_t = tpipe.run_pre_stage(
        convert.map_state(b["js"], "cpu"), convert.kf_package(jpkg, "cpu"), tcfg, "rgbd",
        b["parent"], torch.from_numpy(SF))
    assert kf_t == kf_j
    assert rows_t.tolist() == np.asarray(rows_j).tolist() and int(nf_t) == int(nf_j)
    n_j, n_t = int(js.lm_valid.sum()), int(ts.lm_valid.sum())
    assert n_j >= int(b["js"].lm_valid.sum()) + 100 and abs(n_t - n_j) <= 0.01 * n_j, (n_t, n_j)
    n0 = int(b["js"].n_lm)  # the first row the stage allocates
    fl_j, fl_t = np.asarray(js.kf_feat_lm), ts.kf_feat_lm.numpy()
    for r in np.flatnonzero(np.asarray(js.kf_valid)):
        assert (fl_t[r] == fl_j[r]).mean() >= 0.99, (r, (fl_t[r] != fl_j[r]).sum())
    # the keyframe's depth landmarks: no depth is under th_depth_m (2 m), so
    # the 100 nearest free features get them, the stage's first 100 rows
    made_j = (fl_j[kf_j] >= n0) & (fl_j[kf_j] < n0 + 100)
    made_t = (fl_t[kf_t] >= n0) & (fl_t[kf_t] < n0 + 100)
    assert made_j.sum() == 100
    np.testing.assert_array_equal(made_t, made_j)
    if ties:
        # of the tied group, the lowest features cross the cut, as a stable
        # sort orders them
        chosen = group[made_j[group]]
        assert 0 < chosen.size < group.size
        assert sorted(chosen.tolist()) == sorted(group.tolist())[:chosen.size]


def test_local_ba_stereo_matches_jax(session, jax_ok_only):
    b = session
    tcfg = depth_config()
    jsf = jnp.asarray(SF)
    js, kf, rows, n_fixed = jpipe.run_pre_stage(b["js"], b["jpkg"], jax_depth_config(tcfg),
                                                "rgbd", b["parent"], jsf)
    W = tcfg.local_window + 4
    j, _ = jlm.local_ba(0, jnp.asarray(K_NP), js, rows, n_fixed=n_fixed, window=W, iters=8,
                        scale_factors=jsf, stereo=True, bf=jnp.float32(BF))
    ts_in = convert.map_state(js, "cpu")
    t, stats = tlm.local_ba(0, convert.camera(K_NP, "cpu"), ts_in,
                            torch.from_numpy(np.asarray(rows)), n_fixed=int(n_fixed), window=W,
                            iters=8, scale_factors=torch.from_numpy(SF), stereo=True, bf=BF)
    assert float(stats.cost) < float(stats.cost0)
    ur = ts_in.kf_feat_ur[torch.from_numpy(np.asarray(rows)).long()]
    assert bool((ur < 0).any()) and bool((ur >= 0).any())  # mono and stereo rows both
    fl_j, fl_t = np.asarray(j.kf_feat_lm), t.kf_feat_lm.numpy()
    kv = np.asarray(j.kf_valid)
    for r in np.flatnonzero(kv):
        assert (fl_t[r] == fl_j[r]).mean() >= 0.99, (r, (fl_t[r] != fl_j[r]).sum())
    np.testing.assert_allclose(t.kf_R.numpy()[kv], np.asarray(j.kf_R)[kv], atol=1e-4)
    np.testing.assert_allclose(t.kf_t.numpy()[kv], np.asarray(j.kf_t)[kv], atol=1e-4)
    lv = np.asarray(j.lm_valid)
    Xj, Xt = np.asarray(j.lm_pos)[lv], t.lm_pos.numpy()[lv]
    rel = np.linalg.norm(Xt - Xj, axis=1) / np.linalg.norm(Xj, axis=1)
    assert (rel <= 1e-3).mean() >= 0.99, np.sort(rel)[-5:]
