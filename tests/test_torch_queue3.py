"""Open items of ROADMAP Queue 3 held on the port (all `slow`).

- H: in localization mode at th_depth 80 (PlaneScene seed 6, RGB-D, 8
  mapped frames then 8 paused), the VO-point match of every paused frame
  (K1 at N = F, the plain version here) matches as many of the previous
  frame's valid VO points on the port as in the JAX tracker
  (`Tracker._track_frame_localization`), the JAX features fed to both, at
  the small CPU config of tests/test_torch_depth_session.py (256x192,
  OrbConfig(300, 4)): the counts are equal frame for frame.
- G: the twin of
  tests/test_loop_closing.py::test_no_false_loop_on_repetitive_texture on
  the port at its size (the room with two opposite walls carrying one
  texture, one of them mirrored; a 60-frame arc of 0.55 turns that never
  closes): no merge, keyframe ATE < 0.12.
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

torch.set_num_threads(2)


@pytest.mark.slow
def test_localization_vo_matches_equal_the_jax_trackers(monkeypatch):
    import jax

    from orb_slam3_tpu.atlas import ops as jops
    from orb_slam3_tpu.tracking import track as jtrack
    from orb_slam3_tpu_torch.tracking import track as ttrack
    from test_torch_depth_session import depth_inputs, run_pair
    from test_torch_mapping import OCFG, jax_add_observations_ok_only

    # the JAX side on the path the port runs: the ok-only observation write
    # (ROADMAP Queue 3, resolved), traced afresh with the counting match
    jax.clear_caches()
    monkeypatch.setattr(jops, "add_observations", jax_add_observations_ok_only)
    counts = {"port": [], "jax": []}

    def counting(side, orig):
        def match(kind, K, R, t, lm_pos, lm_desc, mask, *a, **kw):
            out = orig(kind, K, R, t, lm_pos, lm_desc, mask, *a, **kw)
            if lm_pos.shape[0] == OCFG.n_features:  # the VO points (N = F)
                counts[side].append((int(np.asarray(mask).sum()), int(np.asarray(out[1]).sum())))
            return out
        return match

    monkeypatch.setattr(ttrack, "match_local_map", counting("port", ttrack.match_local_map))
    monkeypatch.setattr(jtrack, "match_local_map", counting("jax", jtrack.match_local_map))
    frames, tf = depth_inputs("rgbd", 16, seed=6)
    t, j, rec_t, rec_j = run_pair("rgbd", frames, tf, bf=20.0, pause_at=8, th_depth=80.0)
    j.shutdown()
    print(f"VO points (valid, matched) per paused frame: port {counts['port']}, "
          f"JAX {counts['jax']}")
    assert len(counts["port"]) == 16 - 8 - 1
    assert counts["port"] == counts["jax"]


@pytest.mark.slow
def test_no_false_loop_on_repetitive_texture():
    from orb_slam3_tpu_torch import entry
    from orb_slam3_tpu_torch.api import evaluate as teval
    from orb_slam3_tpu_torch.frontend import orb as torb
    from orb_slam3_tpu_torch.tracking import tracker as ttrk

    K, wh = (350.0, 350.0, 256.0, 192.0), (512, 384)
    scene = entry.room_scene(np.array(K), img_wh=wh, seed=4, device="cpu")
    scene.quads[1]["tex"] = scene.quads[0]["tex"][:, ::-1].copy()
    n = 60
    R_gt, t_gt = entry.loop_trajectory(n_frames=n, radius=1.6, loops=0.55)
    cfg = entry.tracker_config("cpu", img_wh=wh, K=K, sensor="rgbd", bf=350.0 * 0.1,
                               th_depth=20.0, orb=torb.OrbConfig(600, 4), kmax=64, lmax=8192,
                               local_window=6, kf_max_frames=2, deterministic_mapping=True)
    Rv, tv = entry.loop_trajectory(4, radius=1.0, start_angle=0.4)
    voc = entry.train_vocabulary([scene.render(Rv[i], tv[i]) for i in range(4)], cfg)
    t = ttrk.Tracker(cfg, device="cpu")
    t.attach_loop_closer(voc)
    for i in range(n):
        img, depth = scene.render_with_depth(R_gt[i], t_gt[i])
        t.process(img, i * 0.05, depth_map=depth)
    t.sync_mapping()
    t.shutdown()
    assert t.loop_closer.n_merges == 0
    s = t.map
    rows = np.flatnonzero(s.kf_valid.numpy())
    idx = np.clip(np.round(s.kf_timestamp.numpy()[rows] / 0.05).astype(int), 0, n - 1)
    est = teval.camera_centers(s.kf_R.numpy()[rows], s.kf_t.numpy()[rows])
    gt = teval.camera_centers(R_gt[idx], t_gt[idx])
    ate = teval.ate_rmse(idx.astype(float), est, idx.astype(float), gt, with_scale=False)[0]
    assert ate < 0.12, f"aliasing corrupted the map (ATE {ate:.4f}, " \
                       f"{t.loop_closer.n_loops} corrections)"
