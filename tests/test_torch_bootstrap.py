"""The port's monocular bootstrap against the JAX tracker, end to end.

Two PlaneScene frames at 256x192 (frames 0 and 5 of the orbit; OrbConfig
(300, 4), kmax 8, lmax 1024, local window 4) initialize the map on both
sides from the same JAX features: the JAX side is Tracker._try_initialize
called twice, the port's is initialize_monocular with the minimal sets JAX
draws. Key-frame poses agree within 1e-3, the landmark count within 1%,
landmark positions within 1e-3 relative. Frames 6 and 7 are then tracked
on both sides (the JAX tracker's _track_frame_fused, the port's
track_frame) and agree as test_torch_slice.py holds slice 1: n within
max(2, 1%), R within 1e-4, t within 1e-3. The widened retry and the
reference-keyframe fallback are forced once each (a poisoned velocity, an
emptied map mask), and pose_optimize_two_cam is held against JAX on a
pinhole rig.

Those comparisons compile the JAX tracker's init and fused step (~35 s)
and run behind `slow`. Tier-1 runs the same frames through the port
alone (its own features and minimal sets): the init's map, the two
tracked frames and the two forced branches, each with the gates of its
JAX comparison that do not name the JAX result.

The JAX side runs with one repair that the port makes: add_observations
writes only its ok entries. The JAX function also writes the entries that
are not ok back, which on a duplicate feature index undoes an ok binding
(at 256x192, 31 of keyframe 1's 99 observations); the last test shows it.
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
from orb_slam3_tpu.frontend import camera as jcam
from orb_slam3_tpu.frontend import matching as jm
from orb_slam3_tpu.frontend import orb as jorb
from orb_slam3_tpu.frontend import two_view as jtv
from orb_slam3_tpu.ops import lie as jlie
from orb_slam3_tpu.tracking import track as jtrack
from orb_slam3_tpu.tracking import tracker as jtrk
from orb_slam3_tpu_torch import convert
from orb_slam3_tpu_torch.frontend import match_kernel as tmk
from orb_slam3_tpu_torch.tracking import pose_kernel as tpk
from orb_slam3_tpu_torch.tracking import track as ttrack
from orb_slam3_tpu_torch.tracking import tracker as ttrk
from synthetic_scene import PlaneScene, orbit_trajectory

torch.set_num_threads(1)
WH = (256, 192)
K_NP = np.asarray([200.0, 200.0, 128.0, 96.0, 0, 0, 0, 0], np.float32)
FRAMES = (0, 5, 6, 7)


def T(a):
    return torch.from_numpy(np.array(a))


def _feats(f):
    return convert.features(f.xy, f.response, f.angle, f.octave, f.descriptors, f.valid,
                            device="cpu")


def _jax_add_observations_ok_only(s, kf_row, feat_idx, lm_rows, ok):
    """JAX atlas_ops.add_observations writing only the ok entries."""
    F = s.kf_feat_lm.shape[1]
    new = s.kf_feat_lm.at[kf_row, jnp.where(ok, feat_idx, F)].set(lm_rows, mode="drop")
    return dataclasses.replace(s, kf_feat_lm=new)


@pytest.fixture(scope="module")
def boot():
    scene = PlaneScene(K_NP, img_wh=WH, two_planes=True, seed=0)
    R_gt, t_gt = orbit_trajectory(max(FRAMES) + 1)
    ocfg = jorb.OrbConfig(n_features=300, n_levels=4)
    extract = jax.jit(jorb.extract, static_argnums=1)
    jf = {i: extract(jnp.asarray(scene.render(R_gt[i], t_gt[i])), ocfg) for i in FRAMES}
    jcfg = jtrk.TrackerConfig(K=jnp.asarray(K_NP), img_wh=WH, orb=ocfg, kmax=8, lmax=1024,
                              local_window=4, async_mapping=False)
    jt = jtrk.Tracker(jcfg)
    # the reference with its add_observations repaired as the port has it
    # (test_add_observations_keeps_the_ok_binding below shows the fault)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jops, "add_observations", _jax_add_observations_ok_only)
        assert not jt._try_initialize(jf[0], 0.0)
        assert jt._try_initialize(jf[5], 5.0)

    # the minimal sets the JAX tracker drew (its key: the frame count, 0)
    _, ok = jm.search_for_initialization(jf[0].xy, jf[0].descriptors, jf[0].valid,
                                         jf[5].xy, jf[5].descriptors, jf[5].valid,
                                         window=100.0, ratio=0.9)
    sets = jtv._sample_minimal_sets(jax.random.split(jax.random.PRNGKey(0))[0], ok)
    tcfg = ttrk.TrackerConfig(K=convert.camera(K_NP, "cpu"), img_wh=WH,
                              orb=convert.orb_config(ocfg), kmax=8, lmax=1024, local_window=4)
    tf = {i: _feats(f) for i, f in jf.items()}
    s = ttrk.empty_map(tcfg, device="cpu")
    r0 = ttrk.initialize_monocular(tcfg, s, None, tf[0], 0.0)
    assert not r0.success and r0.init_ref is not None
    r1 = ttrk.initialize_monocular(tcfg, s, r0.init_ref, tf[5], 5.0, sets=T(sets))
    return dict(jt=jt, jf=jf, tf=tf, tcfg=tcfg, res=r1)


@pytest.mark.slow
def test_initialize_monocular_matches_jax(boot):
    jt, res = boot["jt"], boot["res"]
    assert res.success and (res.kf0, res.kf1) == (0, 1) == (0, jt.last_kf_row)
    js, ts = jt.map, res.map
    assert int(ts.n_kf) == int(js.n_kf) == 2
    np.testing.assert_allclose(ts.kf_R[:2].numpy(), np.asarray(js.kf_R[:2]), atol=1e-3)
    np.testing.assert_allclose(ts.kf_t[:2].numpy(), np.asarray(js.kf_t[:2]), atol=1e-3)
    n_j, n_t = int(js.lm_valid.sum()), int(ts.lm_valid.sum())
    assert n_j > 50 and abs(n_t - n_j) <= 0.01 * n_j, (n_t, n_j)
    assert res.n_landmarks == jt.last_kf_inliers
    # keyframe 1 observes every landmark (no binding lost to a duplicate)
    assert int((ts.kf_feat_lm[1] >= 0).sum()) == int((js.kf_feat_lm[1] >= 0).sum()) == n_t
    # landmarks by the reference-frame feature they were made from
    fl_j, fl_t = np.asarray(js.kf_feat_lm[0]), ts.kf_feat_lm[0].numpy()
    both = (fl_j >= 0) & (fl_t >= 0)
    assert both.sum() >= 0.99 * min((fl_j >= 0).sum(), (fl_t >= 0).sum())
    Xj = np.asarray(js.lm_pos)[fl_j[both]]
    Xt = ts.lm_pos.numpy()[fl_t[both]]
    assert (np.linalg.norm(Xt - Xj, axis=1) <= 1e-3 * np.linalg.norm(Xj, axis=1)).mean() >= 0.99
    for name in ("lm_normal", "lm_max_dist", "lm_min_dist"):
        np.testing.assert_allclose(getattr(ts, name).numpy()[fl_t[both]],
                                   np.asarray(getattr(js, name))[fl_j[both]], rtol=1e-3, atol=1e-3)


def _agree(out_t, out_j):
    n_t, n_j = int(out_t["n"]), int(out_j["n"])
    assert abs(n_t - n_j) <= max(2, 0.01 * n_j), (n_t, n_j)
    np.testing.assert_allclose(out_t["R"].numpy(), np.asarray(out_j["R"]), atol=1e-4)
    np.testing.assert_allclose(out_t["t"].numpy(), np.asarray(out_j["t"]), atol=1e-3)
    assert bool(out_t["vel_poisoned"]) == bool(out_j["vel_poisoned"])
    return n_t


@pytest.mark.slow
def test_tracked_frames_match_jax(boot):
    jt, tf, jf, cfg, res = boot["jt"], boot["tf"], boot["jf"], boot["tcfg"], boot["res"]
    js = jt.map
    in_map_j = jt._local_map_mask(js)
    in_map_t = ttrk.local_map(res.map, res.kf1)
    np.testing.assert_array_equal(in_map_t.numpy(), np.asarray(in_map_j))
    R_last, t_last = np.asarray(jt.last["R"]), np.asarray(jt.last["t"])
    vel_j = vel_t = None
    tracked_t, last_n = None, 0
    for i in (6, 7):
        if vel_j is None:
            Rp, tp = jnp.asarray(R_last), jnp.asarray(t_last)
        else:
            Rp, tp = jlie.se3_mul(vel_j[0], vel_j[1], jnp.asarray(R_last), jnp.asarray(t_last))
        out_j = jt._track_frame_fused(jf[i], float(i), js, in_map_j, Rp, tp,
                                      jnp.asarray(R_last), jnp.asarray(t_last), defer=False)
        out_t = ttrk.track_frame(cfg, res.map, tf[i], res.kf1, T(R_last), T(t_last),
                                 velocity=vel_t, tracked=tracked_t, last_inliers=last_n)
        n = _agree(out_t, out_j)
        assert n >= 50
        np.testing.assert_array_equal(out_t["feat_lm"].numpy() >= 0, np.asarray(out_j["feat_lm"]) >= 0)
        # the tracker's state for the next frame, on both sides
        jt.velocity, jt._tracked_lms, jt.last_inliers = (out_j["Rv"], out_j["tv"]), out_j["tracked"], n
        vel_j = (out_j["Rv"], out_j["tv"])
        vel_t, tracked_t, last_n = (out_t["Rv"], out_t["tv"]), out_t["tracked"], n
        R_last, t_last = np.asarray(out_j["R"]), np.asarray(out_j["t"])


def _visual_args(boot, in_map, R_pred, t_pred, have_velocity, last_inliers):
    """track_frame_visual's arguments for frame 6 on the map, typed as
    Tracker._track_frame_fused passes them (so its compiled program is
    reused)."""
    s, cfg = boot["jt"].map, boot["jt"].cfg
    f = boot["jf"][6]
    f32 = jnp.float32
    args = (cfg.K, jnp.asarray(0.0, f32), s.lm_pos, s.lm_desc, in_map, s.lm_max_dist,
            s.lm_min_dist, s.lm_normal, s.kf_feat_desc[1],
            (s.kf_feat_lm[1] >= 0) & s.kf_feat_valid[1], s.kf_feat_lm[1],
            f.xy, f.descriptors, f.octave, f.valid, -jnp.ones((s.fmax,), f32),
            R_pred, t_pred, s.kf_R[1], s.kf_t[1], jnp.asarray(have_velocity),
            jnp.zeros((s.lmax,), bool), jnp.asarray(last_inliers, jnp.int32),
            jnp.asarray(15.0, f32), jnp.asarray(4.0, f32), jnp.asarray(15, jnp.int32),
            boot["jt"].scale_factors, jnp.asarray(float(WH[0]), f32),
            jnp.asarray(float(WH[1]), f32))
    return args, dict(R_kf=s.kf_R[1], t_kf=s.kf_t[1])


def _port(a):
    return T(a) if isinstance(a, jax.Array) else a


@pytest.mark.slow
@pytest.mark.parametrize("case", ["poisoned_velocity", "empty_map_mask"])
def test_forced_branches_match_jax(boot, case, monkeypatch):
    s = boot["jt"].map
    R_kf, t_kf = s.kf_R[1], s.kf_t[1]
    in_map = boot["jt"]._local_map_mask(s)
    if case == "poisoned_velocity":
        # the motion model predicts a pose 0.3 units off: stage 1 finds few
        # matches, so the widened retry from the last pose runs and wins
        args, kw = _visual_args(boot, in_map, R_kf, t_kf + jnp.asarray([0.3, 0.0, 0.0]),
                                True, 200)
    else:
        # nothing to match: stage 2 finds no inlier and the reference-
        # keyframe fallback runs (and finds no map point to use)
        args, kw = _visual_args(boot, jnp.zeros_like(in_map), R_kf, t_kf, False, 0)
    out_j = jtrack.track_frame_visual(jcam.PINHOLE, *args, use_stereo=False, **kw)
    calls = {"k1": 0, "k2": []}
    k1_plain, k2_plain = tmk.search_by_projection_plain, tpk.pose_ba_plain

    def count_k1(*a, **kw):
        calls["k1"] += 1
        return k1_plain(*a, **kw)

    def count_k2(*a, **kw):
        calls["k2"].append(a[3].shape[1])
        return k2_plain(*a, **kw)

    monkeypatch.setattr(tmk, "search_by_projection_plain", count_k1)
    monkeypatch.setattr(tpk, "pose_ba_plain", count_k2)
    out_t = ttrack.track_frame_visual(0, *(_port(a) for a in args), use_stereo=False,
                                      **{k: _port(v) for k, v in kw.items()})
    _agree(out_t, out_j)
    if case == "poisoned_velocity":
        assert bool(out_t["vel_poisoned"]) and int(out_t["n"]) >= 50
        assert calls == {"k1": 3, "k2": [1024, 1024, 1024]}
    else:
        assert int(out_t["n"]) == 0
        # stage 1, stage 2, then the fallback's pose BA over the 300
        # features and its fine match
        assert calls == {"k1": 3, "k2": [1024, 1024, 300, 1024]}


def test_pose_optimize_two_cam_matches_jax():
    rng = np.random.default_rng(7)
    n = 120
    K = np.asarray([200.0, 200.0, 128.0, 96.0, 0, 0, 0, 0], np.float32)
    R_rl = np.asarray(jlie.so3_exp(jnp.asarray([0.0, 0.02, 0.0])), np.float32)
    t_rl = np.asarray([-0.12, 0.0, 0.0], np.float32)
    Xw = np.concatenate([rng.uniform(-2, 2, (n, 2)), rng.uniform(3, 7, (n, 1))], 1).astype(np.float32)
    Rt, tt = (np.asarray(a, np.float32) for a in jlie.se3_exp(jnp.asarray([0.05, -0.02, 0.03, 0.01, 0.02, -0.01])))

    def proj(X):
        return K[:2] * X[:, :2] / X[:, 2:] + K[2:4]

    Xl = Xw @ Rt.T + tt
    uv_l = proj(Xl) + rng.normal(0, 0.5, (n, 2))
    uv_r = proj(Xl @ R_rl.T + t_rl) + rng.normal(0, 0.5, (n, 2))
    uv_l[:10] += 40.0  # outliers
    uv_r[-8:] -= 35.0
    info = (1.0 / 1.44 ** rng.integers(0, 4, n)).astype(np.float32)
    vl, vr = rng.uniform(size=n) > 0.05, rng.uniform(size=n) > 0.3
    args = (K, K, R_rl, t_rl, np.eye(3, dtype=np.float32), np.zeros(3, np.float32),
            uv_l.astype(np.float32), Xw, info, vl, uv_r.astype(np.float32), Xw, info, vr)
    ref = jtrack.pose_optimize_two_cam(jcam.PINHOLE, *(jnp.asarray(a) for a in args))
    got = ttrack.pose_optimize_two_cam(0, *(T(a) for a in args))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), atol=1e-4)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]), atol=1e-3)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(ref[3]))
    assert int(got[4]) == int(ref[4]) > 150
    np.testing.assert_allclose(got[0].numpy(), Rt, atol=2e-3)


def test_add_observations_keeps_the_ok_binding():
    """A feature that is the ok match of one entry and the unchecked best
    match of a later one: the port binds it; the JAX function's write-back
    of the later entry undoes the binding (on the CPU, the last write
    wins)."""
    from orb_slam3_tpu.atlas import state as jstate
    from orb_slam3_tpu_torch.atlas import ops as tops
    from orb_slam3_tpu_torch.atlas import state as tstate

    feat = np.int32([3, 5, 3, 7])
    rows = np.int32([10, 11, 12, 13])
    ok = np.array([True, True, False, False])
    j = jops.add_observations(jstate.empty(kmax=2, fmax=8, lmax=16), 1, jnp.asarray(feat),
                              jnp.asarray(rows), jnp.asarray(ok))
    t = tops.add_observations(tstate.empty(kmax=2, fmax=8, lmax=16, device="cpu"), 1,
                              T(feat), T(rows), T(ok))
    assert t.kf_feat_lm[1].tolist() == [-1, -1, -1, 10, -1, 11, -1, -1]
    assert np.asarray(j.kf_feat_lm[1]).tolist() == [-1, -1, -1, -1, -1, 11, -1, -1]


# ---------------------------------------------------------------------------
# Tier-1: the same frames through the port alone
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def port_boot():
    from orb_slam3_tpu_torch.frontend import orb as torb

    scene = PlaneScene(K_NP, img_wh=WH, two_planes=True, seed=0)
    R_gt, t_gt = orbit_trajectory(max(FRAMES) + 1)
    ocfg = torb.OrbConfig(n_features=300, n_levels=4)
    tf = {i: torb.extract(torch.from_numpy(scene.render(R_gt[i], t_gt[i])), ocfg)
          for i in FRAMES}
    tcfg = ttrk.TrackerConfig(K=convert.camera(K_NP, "cpu"), img_wh=WH, orb=ocfg, kmax=8,
                              lmax=1024, local_window=4)
    s = ttrk.empty_map(tcfg, device="cpu")
    r0 = ttrk.initialize_monocular(tcfg, s, None, tf[0], 0.0)
    res = ttrk.initialize_monocular(tcfg, s, r0.init_ref, tf[5], 5.0, seed=0)
    return dict(tf=tf, tcfg=tcfg, res=res, R_gt=R_gt)


def test_initialize_monocular_on_the_port(port_boot):
    res = port_boot["res"]
    assert res.success and (res.kf0, res.kf1) == (0, 1)
    ts = res.map
    n = int(ts.lm_valid.sum())
    assert int(ts.n_kf) == 2 and n > 50 and res.n_landmarks == n
    # keyframe 1 observes every landmark; each was made from a reference feature
    assert int((ts.kf_feat_lm[1] >= 0).sum()) == int((ts.kf_feat_lm[0] >= 0).sum()) == n
    # keyframe 1's rotation against the truth (the orbit's yaw over 5 frames)
    R_gt = port_boot["R_gt"]
    R_rel = R_gt[5] @ R_gt[0].T
    cos = (np.trace(ts.kf_R[1].numpy().astype(np.float64) @ R_rel.T) - 1.0) / 2.0
    assert np.degrees(np.arccos(np.clip(cos, -1.0, 1.0))) < 0.5
    for name in ("lm_normal", "lm_max_dist", "lm_min_dist", "lm_pos"):
        assert torch.isfinite(getattr(ts, name)[ts.lm_valid]).all(), name


def test_tracked_frames_on_the_port(port_boot):
    tf, cfg, res = port_boot["tf"], port_boot["tcfg"], port_boot["res"]
    R_last, t_last = res.R, res.t
    vel, tracked, last_n = None, None, 0
    for i in (6, 7):
        out = ttrk.track_frame(cfg, res.map, tf[i], res.kf1, R_last, t_last, velocity=vel,
                               tracked=tracked, last_inliers=last_n)
        n = int(out["n"])
        assert n >= 50 and not bool(out["vel_poisoned"])
        vel, tracked, last_n = (out["Rv"], out["tv"]), out["tracked"], n
        R_last, t_last = out["R"], out["t"]


@pytest.mark.parametrize("case", ["poisoned_velocity", "empty_map_mask"])
def test_forced_branches_on_the_port(port_boot, case, monkeypatch):
    """The widened retry and the reference-keyframe fallback on the port's
    own map, with the kernel calls of the JAX comparison above."""
    tf, cfg, res = port_boot["tf"], port_boot["tcfg"], port_boot["res"]
    s = res.map
    R_kf, t_kf = s.kf_R[1], s.kf_t[1]
    in_map = ttrk.local_map(s, 1)
    f = tf[6]
    if case == "poisoned_velocity":
        R_pred, t_pred, have_vel, last_n = R_kf, t_kf + torch.tensor([0.3, 0.0, 0.0]), True, 200
    else:
        in_map, R_pred, t_pred, have_vel, last_n = torch.zeros_like(in_map), R_kf, t_kf, False, 0
    calls = {"k1": 0, "k2": []}
    k1_plain, k2_plain = tmk.search_by_projection_plain, tpk.pose_ba_plain

    def count_k1(*a, **kw):
        calls["k1"] += 1
        return k1_plain(*a, **kw)

    def count_k2(*a, **kw):
        calls["k2"].append(a[3].shape[1])
        return k2_plain(*a, **kw)

    monkeypatch.setattr(tmk, "search_by_projection_plain", count_k1)
    monkeypatch.setattr(tpk, "pose_ba_plain", count_k2)
    out = ttrack.track_frame_visual(
        0, cfg.K, 0.0, s.lm_pos, s.lm_desc, in_map, s.lm_max_dist, s.lm_min_dist, s.lm_normal,
        s.kf_feat_desc[1], (s.kf_feat_lm[1] >= 0) & s.kf_feat_valid[1], s.kf_feat_lm[1],
        f.xy, f.descriptors, f.octave, f.valid, -torch.ones(s.fmax), R_pred, t_pred, R_kf, t_kf,
        have_vel, torch.zeros(s.lmax, dtype=torch.bool), last_n, 15.0, 4.0, 15,
        cfg.scale_factors(), float(WH[0]), float(WH[1]), use_stereo=False, R_kf=R_kf, t_kf=t_kf)
    if case == "poisoned_velocity":
        assert bool(out["vel_poisoned"]) and int(out["n"]) >= 50
        assert calls == {"k1": 3, "k2": [1024, 1024, 1024]}
    else:
        assert int(out["n"]) == 0
        assert calls == {"k1": 3, "k2": [1024, 1024, 300, 1024]}
