"""The port's duplicate merging, global BA, relocalization, loop closing and
map merging.

Against the JAX package, on the same numpy-seeded inputs:
- merge_duplicates_at_keyframe (K1 on its plain version here) exactly equal
  on a map where keyframe 0's features are bound to duplicates of the
  landmarks the other keyframes observe, with a planted conflict: two
  keepers match one duplicate's feature, so one loser has two winners.
  The JAX package's scatter keeps the last write (the higher projected
  row), the port resolves it with an amax of that row;
- GlobalBARunner.run against the JAX runner on its one-device mesh on a
  perturbed map: keyframe poses within 1e-4, landmarks within 1e-3; the
  catch-up reconciliation and the abort as tests/test_global_ba.py.

The port alone, on the CPU at the verify skill's small config (PlaneScene
at 256x192, OrbConfig(300, 4), kmax 8, lmax 1024, window 4, RGB-D):
- relocalization after a blackout into the same map (the gates of
  tests/test_loop_reloc.py::test_relocalization_after_blackout);
- a loop correction and a cross-map merge driven on that session's map;
- behind `slow`: the loop-closing and multimap-merge sessions of
  tests/test_loop_closing.py and tests/test_loop_reloc.py at their size,
  under their gates.
"""

import dataclasses
import os
import sys
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

from orb_slam3_tpu.atlas import state as jstate
from orb_slam3_tpu.mapping import fuse as jfuse
from orb_slam3_tpu.mapping import global_ba as jgba
from orb_slam3_tpu_torch import convert, entry
from orb_slam3_tpu_torch.api import evaluate as teval
from orb_slam3_tpu_torch.api.system import System
from orb_slam3_tpu_torch.atlas import invariants as tinv
from orb_slam3_tpu_torch.atlas import ops as tops
from orb_slam3_tpu_torch.atlas import state as tstate
from orb_slam3_tpu_torch.frontend import match_kernel as tmk
from orb_slam3_tpu_torch.frontend import orb as torb
from orb_slam3_tpu_torch.frontend import stereo as tstereo
from orb_slam3_tpu_torch.mapping import fuse as tfuse
from orb_slam3_tpu_torch.mapping import global_ba as tgba
from orb_slam3_tpu_torch.ops import lie as tlie
from orb_slam3_tpu_torch.tracking import tracker as ttrk

torch.set_num_threads(2)
K_NP = np.asarray([200.0, 200.0, 128.0, 96.0, 0, 0, 0, 0], np.float32)
WH = (256, 192)
SF = np.asarray([1.2 ** i for i in range(4)], np.float32)


def _jax_map(s):
    return jstate.MapState(**{k: jnp.asarray(v) for k, v in convert.map_state_arrays(s).items()})


def synthetic_map(seed=0, n_lm=40, n_kf=4, dup_kf0=True, plant=True, noise=0.0):
    """A map of n_kf keyframes along x looking at n_lm landmarks. With
    dup_kf0, keyframe 0's features are bound to duplicates (rows n_lm..) of
    the landmarks keyframes 1.. observe; with plant, landmark n_lm - 1 is
    copied to a second keeper row (same point, descriptor and
    observations on features of their own), so both keepers match keyframe
    0's feature of that point. noise perturbs poses and landmarks (for
    BA)."""
    rng = np.random.default_rng(seed)
    K, F, L = 8, 64, 128
    s = tstate.empty(kmax=K, fmax=F, lmax=L, device="cpu")
    X = np.stack([rng.uniform(-1.5, 1.5, n_lm), rng.uniform(-1.0, 1.0, n_lm),
                  rng.uniform(4.0, 6.0, n_lm)], -1).astype(np.float32)
    desc = rng.integers(0, 256, (n_lm, 32), dtype=np.uint8)
    kf_R = np.tile(np.eye(3, dtype=np.float32), (K, 1, 1))
    kf_t = np.zeros((K, 3), np.float32)
    kf_t[:n_kf, 0] = -0.1 * np.arange(n_kf)
    feat_xy = np.zeros((K, F, 2), np.float32)
    feat_desc = np.zeros((K, F, 32), np.uint8)
    feat_lm = np.full((K, F), -1, np.int32)
    feat_valid = np.zeros((K, F), bool)
    lm_pos = np.zeros((L, 3), np.float32)
    lm_desc = np.zeros((L, 32), np.uint8)
    lm_valid = np.zeros(L, bool)
    first = np.full(L, -1, np.int32)
    lm_pos[:n_lm], lm_desc[:n_lm], lm_valid[:n_lm], first[:n_lm] = X, desc, True, 1
    keeper2 = n_lm if plant else None
    dup0 = n_lm + (1 if plant else 0)
    if plant:
        lm_pos[keeper2], lm_desc[keeper2], lm_valid[keeper2], first[keeper2] = \
            X[-1], desc[-1], True, 1
    for k in range(n_kf):
        Xc = X + kf_t[k]
        uv = K_NP[:2] * Xc[:, :2] / Xc[:, 2:] + K_NP[2:4]
        feat_xy[k, :n_lm], feat_desc[k, :n_lm], feat_valid[k, :n_lm] = uv, desc, True
        if k == 0 and dup_kf0:
            rows = dup0 + np.arange(n_lm)
            feat_lm[0, :n_lm] = rows
            lm_pos[rows], lm_desc[rows], lm_valid[rows], first[rows] = X, desc, True, 0
        else:
            feat_lm[k, :n_lm] = np.arange(n_lm)
            if plant:
                feat_xy[k, n_lm], feat_desc[k, n_lm] = uv[-1] + 0.3, desc[-1]
                feat_valid[k, n_lm], feat_lm[k, n_lm] = True, keeper2
    if noise:
        lm_pos[lm_valid] += rng.normal(0, noise, (lm_valid.sum(), 3)).astype(np.float32)
        kf_t[2:n_kf] += rng.normal(0, noise, (n_kf - 2, 3)).astype(np.float32)
    kv = np.zeros(K, bool)
    kv[:n_kf] = True
    parent = np.full(K, -1, np.int32)
    parent[1:n_kf] = np.arange(n_kf - 1)
    f = lambda a: torch.from_numpy(a)  # noqa: E731
    s = dataclasses.replace(
        s, kf_R=f(kf_R), kf_t=f(kf_t), kf_valid=f(kv), kf_parent=f(parent),
        kf_feat_xy=f(feat_xy), kf_feat_desc=f(feat_desc), kf_feat_lm=f(feat_lm),
        kf_feat_valid=f(feat_valid), lm_pos=f(lm_pos), lm_desc=f(lm_desc),
        lm_valid=f(lm_valid), lm_first_kf=f(first), kf_map_id=torch.zeros(K, dtype=torch.int32),
        lm_map_id=torch.zeros(L, dtype=torch.int32), n_kf=torch.tensor(n_kf, dtype=torch.int32),
        n_lm=torch.tensor(int(lm_valid.sum()), dtype=torch.int32),
        lm_visible=f(rng.integers(1, 9, L).astype(np.int32)),
        lm_found=f(rng.integers(1, 5, L).astype(np.int32)))
    return tstate.update_landmark_stats(s), keeper2, dup0


def test_merge_duplicates_matches_jax_with_a_planted_conflict():
    s, keeper2, dup0 = synthetic_map()
    n_lm = keeper2
    loser = dup0 + n_lm - 1                  # the duplicate both keepers match
    js = _jax_map(s)
    K8, sf = jnp.asarray(K_NP), jnp.asarray(SF)
    want, want_n = jfuse.merge_duplicates_at_keyframe(0, K8, js, jnp.asarray(0, jnp.int32), sf)
    got, got_n = tfuse.merge_duplicates_at_keyframe(0, convert.camera(K_NP, "cpu"), s, 0,
                                                    torch.from_numpy(SF))
    assert int(got_n) == int(want_n) >= n_lm + 1
    for name in ("kf_feat_lm", "lm_valid", "lm_visible", "lm_found"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), err_msg=name)
    # the conflict: keyframe 0's feature of that point now points at the
    # higher keeper row, and both keepers stay valid
    f = n_lm - 1
    assert int(got.kf_feat_lm[0, f]) == keeper2 and not bool(got.lm_valid[loser])
    assert bool(got.lm_valid[n_lm - 1]) and bool(got.lm_valid[keeper2])
    # the other duplicates went to their keepers, counters moved over
    np.testing.assert_array_equal(got.kf_feat_lm[0, :n_lm - 1].numpy(), np.arange(n_lm - 1))
    assert int(got.lm_visible[0]) == int(s.lm_visible[0]) + int(s.lm_visible[dup0])
    assert not tinv.check_observations(got)


def test_merge_duplicates_count_is_zero_without_duplicates():
    s, _, _ = synthetic_map(dup_kf0=False, plant=False)
    got, n = tfuse.merge_duplicates_at_keyframe(0, convert.camera(K_NP, "cpu"), s, 0,
                                                torch.from_numpy(SF))
    assert int(n) == 0
    np.testing.assert_array_equal(got.kf_feat_lm.numpy(), s.kf_feat_lm.numpy())


def test_global_ba_lowers_the_reprojection_cost():
    """The port alone (the JAX parity below is slow: its mesh program's
    compile): 10 iterations on a perturbed map pull the landmarks and the
    free keyframes back (keyframes 0 and 1 fixed)."""
    s, _, _ = synthetic_map(seed=3, n_kf=5, dup_kf0=False, plant=False, noise=0.02)
    truth, _, _ = synthetic_map(seed=3, n_kf=5, dup_kf0=False, plant=False)
    got = tgba.GlobalBARunner(convert.camera(K_NP, "cpu"), 0).run(s)
    np.testing.assert_array_equal(got.kf_t.numpy()[:2], s.kf_t.numpy()[:2])
    lv = s.lm_valid.numpy()
    before = np.abs(s.lm_pos.numpy()[lv] - truth.lm_pos.numpy()[lv]).mean()
    after = np.abs(got.lm_pos.numpy()[lv] - truth.lm_pos.numpy()[lv]).mean()
    assert after < 0.5 * before
    assert np.abs(got.kf_t.numpy()[2:5] - truth.kf_t.numpy()[2:5]).max() < 0.01


@pytest.mark.slow
def test_global_ba_matches_the_jax_runner():
    """The JAX runner on its one-device mesh and the port's, 10 iterations
    in chunks of 5, on a map with perturbed landmarks and keyframes."""
    s, _, _ = synthetic_map(seed=3, n_kf=5, dup_kf0=False, plant=False, noise=0.02)
    want = jgba.GlobalBARunner(jnp.asarray(K_NP), 0).run(_jax_map(s))
    got = tgba.GlobalBARunner(convert.camera(K_NP, "cpu"), 0).run(s)
    kv = s.kf_valid.numpy()
    np.testing.assert_allclose(got.kf_R.numpy()[kv], np.asarray(want.kf_R)[kv], atol=1e-4)
    np.testing.assert_allclose(got.kf_t.numpy()[kv], np.asarray(want.kf_t)[kv], atol=1e-4)
    lv = s.lm_valid.numpy()
    np.testing.assert_allclose(got.lm_pos.numpy()[lv], np.asarray(want.lm_pos)[lv], atol=1e-3)
    # it moved the map: the keyframes 0 and 1 stay fixed, the others move
    np.testing.assert_array_equal(got.kf_t.numpy()[:2], s.kf_t.numpy()[:2])
    assert np.abs(got.kf_t.numpy()[2:5] - s.kf_t.numpy()[2:5]).max() > 1e-3


def test_background_gba_reconcile_and_abort():
    """tests/test_global_ba.py on the port: a keyframe added after launch
    keeps its pose relative to its parent; old keyframes take the GBA pose;
    an aborted campaign stops."""
    s, _, _ = synthetic_map(seed=4, n_kf=5, dup_kf0=False, plant=False, noise=0.02)
    runner = tgba.GlobalBARunner(convert.camera(K_NP, "cpu"), 0, num_iters=4, chunk=2)
    runner.launch(s)
    runner.join(timeout=10)
    assert not runner.running, "the campaign did not end within 10 s"
    assert runner.finished and not runner.failed
    parent = int(s.n_kf) - 1
    R_child, t_child = tlie.se3_mul(torch.eye(3), torch.tensor([0.02, 0.0, 0.0]),
                                    s.kf_R[parent], s.kf_t[parent])
    F = s.fmax
    s_live, kf_new = tops.add_keyframe(
        s, R_child, t_child, 99.0, torch.zeros((F, 2)), torch.zeros(F, dtype=torch.int32),
        torch.zeros(F), torch.zeros((F, 32), dtype=torch.uint8), torch.zeros(F, dtype=torch.bool),
        parent=parent)
    gba_R, gba_t = runner.result.kf_R.clone(), runner.result.kf_t.clone()
    out = runner.reconcile(s_live)
    np.testing.assert_allclose(out.kf_t[2].numpy(), gba_t[2].numpy(), atol=1e-6)
    np.testing.assert_allclose(out.kf_R[2].numpy(), gba_R[2].numpy(), atol=1e-6)
    R_rel, t_rel = tlie.se3_mul(out.kf_R[int(kf_new)], out.kf_t[int(kf_new)],
                                *tlie.se3_inv(out.kf_R[parent], out.kf_t[parent]))
    np.testing.assert_allclose(R_rel.numpy(), np.eye(3), atol=2e-3)
    np.testing.assert_allclose(t_rel.numpy(), [0.02, 0.0, 0.0], atol=2e-3)

    runner = tgba.GlobalBARunner(convert.camera(K_NP, "cpu"), 0, num_iters=50, chunk=1)
    runner.launch(s)
    runner.request_abort()
    runner.join(timeout=10)
    assert not runner.running, "the aborted campaign did not end within 10 s"


def test_background_gba_runs_beside_the_tracking_thread():
    """A campaign in its side thread while this thread differentiates too
    (a global BA of its own, whose linearization is a vmap of jacfwd, as a
    keyframe's local BA is): torch.func's forward-AD levels are process-wide,
    so without the package's FORWARD_AD lock one of the two threads dies
    with "Trying to access a forward AD level with an invalid index"."""
    s, _, _ = synthetic_map(seed=5, n_kf=5, dup_kf0=False, plant=False, noise=0.02)
    K = convert.camera(K_NP, "cpu")
    runner = tgba.GlobalBARunner(K, 0, num_iters=20, chunk=5)
    runner.launch(s)
    n = 0
    deadline = time.monotonic() + 10
    while (runner.running or n < 3) and time.monotonic() < deadline:
        tgba.global_ba(s, K, num_iters=2)
        n += 1
    assert not runner.running, "the campaign did not end within 10 s"
    assert runner.finished and not runner.failed, runner.error
    assert n >= 3


# ---------------------------------------------------------------------------
# port sessions
# ---------------------------------------------------------------------------

def small_config(kf_max_frames=5, kmax=8):
    return ttrk.TrackerConfig(K=convert.camera(K_NP, "cpu"), img_wh=WH,
                              orb=torb.OrbConfig(300, 4), kmax=kmax, lmax=1024, local_window=4,
                              sensor="rgbd", bf=200.0 * 0.1, th_depth=20.0,
                              kf_max_frames=kf_max_frames, async_mapping=False, pipeline_depth=1)


def plane_frames(seed, idx, n):
    planes = entry.plane_scene(seed)
    R, t = entry.orbit_trajectory(n)
    return [entry.render_with_depth(planes, tuple(K_NP[:4]), WH, R[i], t[i]) for i in idx], R, t


@pytest.fixture(scope="module")
def reloc_session():
    """tests/test_loop_reloc.py::test_relocalization_after_blackout on the
    port at the small config: 14 frames, 3 blank frames, a resume at frame
    6's view; the vocabulary from 3 views of the scene."""
    n = 14
    frames, R_gt, t_gt = plane_frames(5, range(n), n)
    cfg = small_config()
    voc = entry.train_vocabulary([f[0] for f in frames[:3]], cfg)
    sys_ = System(config=cfg, vocabulary=voc)
    tr = sys_.tracker
    for i, (img, depth) in enumerate(frames):
        sys_.track_rgbd(img, depth, 0.05 * i)
    state_mapped, n_kf = tr.state, int(tr.map.n_kf)
    blank = np.zeros((WH[1], WH[0]), np.float32)
    for j in range(3):
        sys_.track_rgbd(blank, np.ones_like(blank), (n + j) * 0.05)
    state_lost = tr.state
    calls = []
    orig = tr._try_relocalize

    def rec(feats):
        ok = orig(feats)
        calls.append(ok)
        return ok

    tr._try_relocalize = rec
    img, depth = frames[6]
    sys_.track_rgbd(img, depth, (n + 4) * 0.05)
    return dict(system=sys_, tracker=tr, R_gt=R_gt, t_gt=t_gt, state_mapped=state_mapped,
                n_kf=n_kf, state_lost=state_lost, calls=calls, voc=voc)


def test_relocalization_after_blackout(reloc_session):
    r = reloc_session
    tr = r["tracker"]
    assert r["state_mapped"] == ttrk.OK and r["n_kf"] >= 2
    assert r["state_lost"] in (ttrk.RECENTLY_LOST, ttrk.LOST)
    assert r["calls"] == [True] and tr.state == ttrk.OK
    est_c = teval.camera_centers(tr.last["R"].numpy()[None], tr.last["t"].numpy()[None])[0]
    gt_c = teval.camera_centers(r["R_gt"][6][None], r["t_gt"][6][None])[0]
    assert np.linalg.norm(est_c - gt_c) < 0.15
    assert int(tr.map.n_maps) == 1
    # the keyframe cooldown after a relocalization (Tracking.cc:3091-3094)
    assert tr._last_reloc_frame == len(tr.trajectory) - 1
    # the database holds every valid keyframe inserted after the
    # initialization (the init keyframe never reaches the loop closer, and
    # culled keyframes stay until a rebuild, as in the JAX package)
    assert tr.loop_closer.db.valid.shape[0] == tr.map.kmax
    assert bool((tr.loop_closer.db.valid | ~tr.map.kf_valid)[1:].all())


def _reprojection_rms(s):
    """RMS pixel error of every bound observation of the valid keyframes."""
    ok = (s.kf_feat_lm >= 0) & s.kf_feat_valid & s.kf_valid[:, None]
    k, f = torch.nonzero(ok, as_tuple=True)
    X = s.lm_pos[s.kf_feat_lm[k, f].long()]
    Xc = (s.kf_R[k] @ X[:, :, None])[:, :, 0] + s.kf_t[k]
    uv = Xc[:, :2] / Xc[:, 2:] * torch.from_numpy(K_NP[:2]) + torch.from_numpy(K_NP[2:4])
    return float(torch.sqrt(torch.mean(torch.sum((uv - s.kf_feat_xy[k, f]) ** 2, dim=-1))))


def test_system_runs_global_ba_on_the_session_map(reloc_session):
    """System.run_global_ba (Optimizer::GlobalBundleAdjustemnt) on the
    relocalization session's map: the first two keyframes hold, the map's
    reprojection error drops, the keyframes move by little, the map stays
    consistent."""
    sys_ = reloc_session["system"]
    tr = sys_.tracker
    s0 = tr.map
    v0 = tr._map_version
    sys_.run_global_ba(num_iters=2)
    s1 = tr.map
    rows = np.flatnonzero(s0.kf_valid.numpy())
    np.testing.assert_array_equal(s1.kf_t.numpy()[rows[:2]], s0.kf_t.numpy()[rows[:2]])
    assert _reprojection_rms(s1) < _reprojection_rms(s0)
    assert np.abs(s1.kf_t.numpy()[rows] - s0.kf_t.numpy()[rows]).max() < 0.1
    assert tr._map_version == v0 + 1 and not tinv.check_all(s1)
    tr.map = s0


def test_loop_correction_on_the_session_map(reloc_session):
    """CorrectLoop on the relocalization session's map, the last keyframe
    matched to the first with its own pose as the measured Scw (a loop with
    no drift): the essential graph and the welding (merge_duplicates and
    fuse through each window keyframe) leave the poses where they were and
    the map consistent."""
    tr = reloc_session["tracker"]
    s = tr.map
    kv = s.kf_valid.numpy()
    rows = np.flatnonzero(kv)
    cur, cand = int(rows[-1]), int(rows[0])
    lc = tr.loop_closer
    n0 = tmk.launches
    out = lc._correct_loop(s, cur, cand, s.kf_R[cur], s.kf_t[cur], 1.0, None, 0, tr.cfg.K)
    assert tmk.launches == n0  # CPU tensors: the plain version, no launch
    np.testing.assert_allclose(out.kf_t.numpy()[kv], s.kf_t.numpy()[kv], atol=2e-3)
    assert not tinv.check_all(out)


def test_map_merge_on_the_session_map(reloc_session):
    """MergeLocal on the session's map split in two: the keyframes from the
    fourth on (and their landmarks) relabelled as a second map, then merged
    into the first through the identity Scw: one map id afterwards, the
    welding (merge_duplicates and fuse on both sides, a mono local BA with
    the candidate side fixed) leaves finite poses and a consistent map.
    With four keyframes the current side's window also holds the
    candidate's neighbours, so the weld is free to move them: the poses are
    not held to their old values."""
    tr = reloc_session["tracker"]
    s = tr.map
    kv = s.kf_valid.numpy()
    rows = np.flatnonzero(kv)
    second = np.zeros(s.kmax, bool)
    second[rows[3:]] = True
    lm_second = second[np.clip(s.lm_first_kf.numpy(), 0, s.kmax - 1)] & s.lm_valid.numpy()
    s2 = dataclasses.replace(
        s, kf_map_id=torch.where(torch.from_numpy(second), 1, s.kf_map_id).to(torch.int32),
        lm_map_id=torch.where(torch.from_numpy(lm_second), 1, s.lm_map_id).to(torch.int32),
        active_map=torch.tensor(1, dtype=torch.int32), n_maps=torch.tensor(2, dtype=torch.int32))
    cur, cand = int(rows[-1]), int(rows[0])
    out = tr.loop_closer._merge_maps_scw(s2, cur, cand, s.kf_R[cur], s.kf_t[cur], 1.0, 0,
                                         tr.cfg.K)
    ids = out.kf_map_id.numpy()[kv]
    assert len(np.unique(ids)) == 1 and int(out.active_map) == 0
    assert np.isfinite(out.kf_t.numpy()[kv]).all() and np.isfinite(out.kf_R.numpy()[kv]).all()
    assert int(out.lm_valid.sum()) > 0.9 * int(s.lm_valid.sum())
    assert not tinv.check_all(out)


def test_a_stage1_pose_with_few_inliers_goes_to_the_reference_keyframe(reloc_session,
                                                                      monkeypatch):
    """The repair of the fused step: when the stage-1 pose BA keeps fewer
    than 10 inliers, the frame takes the reference-keyframe fallback even if
    stage 2, started from that ill-posed pose, reports min_inliers or more
    (the reference's TrackWithMotionModel fails on nmatchesMap < 10). The
    first two pose BAs are replaced by what the card gave on such a frame:
    a pose 0.36 m off with 2, then 21, inliers."""
    from orb_slam3_tpu_torch.tracking import track

    tr = reloc_session["tracker"]
    s = tr.map
    kf = int(np.flatnonzero(s.kf_valid.numpy())[-1])
    i = int(round(float(s.kf_timestamp[kf]) / 0.05))
    [(img, depth)], _, _ = plane_frames(5, [i + 1], i + 2)
    feats = tr._extract(torch.from_numpy(img))
    ur, dep, _ = tstereo.depth_from_rgbd(feats.xy, torch.from_numpy(depth), tr.cfg.bf,
                                         tr.cfg.depth_factor)
    real = track.pose_optimize_stereo
    calls = []

    def card_like(kind, K, bf, R0, t0, uv, ur_, Xw, inv, valid):
        calls.append(1)
        out = real(kind, K, bf, R0, t0, uv, ur_, Xw, inv, valid)
        if len(calls) > 2:
            return out
        n = torch.tensor(2 if len(calls) == 1 else 21, dtype=out[3].dtype)
        return R0, t0 + torch.tensor([0.36, 0.0, 0.0]), out[2], n

    monkeypatch.setattr(track, "pose_optimize_stereo", card_like)
    out = ttrk.track_frame(tr.cfg, s, feats, kf, s.kf_R[kf], s.kf_t[kf], frame_ur=ur,
                           frame_depth=dep, th_depth_m=tr.th_depth_m)
    assert len(calls) == 3  # stage 1, stage 2, then the reference keyframe's match
    assert int(out["n"]) > 50
    assert float((out["t"] - s.kf_t[kf]).abs().max()) < 0.1


# ---------------------------------------------------------------------------
# the reference's loop-closing and merging sessions (slow)
# ---------------------------------------------------------------------------

K_REF = (350.0, 350.0, 256.0, 192.0)
WH_REF = (512, 384)


def ref_config(kmax, kf_max_frames):
    return entry.tracker_config("cpu", img_wh=WH_REF, K=K_REF, sensor="rgbd", bf=35.0,
                                th_depth=20.0, orb=torb.OrbConfig(600, 4), kmax=kmax,
                                lmax=8192, local_window=6, kf_max_frames=kf_max_frames,
                                async_mapping=False, pipeline_depth=1)


def _kf_ate(s, R_gt, t_gt, dt=0.05):
    rows = np.flatnonzero(s.kf_valid.numpy())
    idx = np.clip(np.round(s.kf_timestamp.numpy()[rows] / dt).astype(int), 0, len(R_gt) - 1)
    est = teval.camera_centers(s.kf_R.numpy()[rows], s.kf_t.numpy()[rows])
    gt = teval.camera_centers(R_gt[idx], t_gt[idx])
    return teval.ate_rmse(idx.astype(float), est, idx.astype(float), gt, with_scale=False)[0]


@pytest.mark.slow
def test_loop_closes_and_reduces_drift():
    """tests/test_loop_closing.py::test_loop_closes_and_reduces_drift on the
    port (numpy room scene, seed 3, exposure jitter 0.04; 110 frames,
    1.12 loops)."""
    scene = entry.room_scene(np.array(K_REF), img_wh=WH_REF, seed=3, exposure_jitter=0.04,
                             device="cpu")
    n = 110
    R_gt, t_gt = entry.loop_trajectory(n, radius=1.6, loops=1.12)
    cfg = ref_config(96, 2)
    Rv, tv = entry.loop_trajectory(4, radius=1.0, start_angle=0.4)
    voc = entry.train_vocabulary([scene.render(Rv[i], tv[i]) for i in range(4)], cfg)
    sys_ = System(config=cfg, vocabulary=voc)
    tr = sys_.tracker
    n1 = int(n / 1.12 * 0.72)
    for i in range(n1):
        sys_.track_rgbd(*scene.render_with_depth(R_gt[i], t_gt[i]), i * 0.05)
    assert tr.state == ttrk.OK
    ate_pre = _kf_ate(tr.map, R_gt, t_gt)
    assert ate_pre < 0.10, ate_pre
    for i in range(n1, n):
        sys_.track_rgbd(*scene.render_with_depth(R_gt[i], t_gt[i]), i * 0.05)
    sys_.shutdown()
    assert tr.loop_closer.n_loops >= 1
    ate_post = _kf_ate(tr.map, R_gt, t_gt)
    assert ate_post < max(1.05 * ate_pre, 0.05), (ate_pre, ate_post)
    assert ate_post < 0.12, ate_post
    assert tr.poses()[3][-10:].all()
    assert not tinv.check_all(tr.map)


@pytest.mark.slow
def test_multimap_merge():
    """tests/test_loop_reloc.py::test_multimap_merge on the port (PlaneScene
    seed 6 at 512x384): 24 frames, a blackout into a second map, a resume
    far away heading back until the maps merge."""
    planes = entry.plane_scene(6)
    R_gt, t_gt = entry.orbit_trajectory(60, advance=0.05)
    cfg = ref_config(64, 2)
    frame = lambda i: entry.render_with_depth(planes, K_REF, WH_REF, R_gt[i], t_gt[i])  # noqa
    R3, t3 = entry.orbit_trajectory(3)
    voc = entry.train_vocabulary(
        [entry.render_with_depth(planes, K_REF, WH_REF, R3[i], t3[i])[0] for i in range(3)], cfg)
    sys_ = System(config=cfg, vocabulary=voc)
    tr = sys_.tracker
    for i in range(24):
        sys_.track_rgbd(*frame(i), i * 0.05)
    assert tr.state == ttrk.OK and int(tr.map.n_kf) >= 10
    blank = np.zeros((WH_REF[1], WH_REF[0]), np.float32)
    for j in range(7):
        sys_.track_rgbd(blank, np.ones_like(blank), (20 + j) * 0.05)
    assert int(tr.map.n_maps) == 2
    for k, i in enumerate(range(40, 4, -2)):
        sys_.track_rgbd(*frame(i), (30 + k) * 0.05)
        if tr.loop_closer.n_merges > 0:
            break
    sys_.shutdown()
    assert tr.loop_closer.n_merges >= 1
    ids = tr.map.kf_map_id.numpy()[tr.map.kf_valid.numpy()]
    assert len(np.unique(ids)) == 1
