"""The port's background mapper (runtime/mapper.py) and the tracker's commit
adoption against the JAX package, on the same numpy inputs, and the
mapper's queue rules on the port alone.

- `_regauge_pkg` after an inertial gauge event (no anchor: R' = R dR^T,
  t' = ds t) and after a loop correction (through the anchor keyframe's
  pose change), within 1e-5; an ordinary commit leaves the package as it
  is. The JAX AsyncMapper is built with inline=True and its gauge and
  anchor histories are set by hand, the port's to the same values.
- `_publish` folds an unpolled commit into the next: gauge scales
  multiply, big-change and bad-IMU are ORed, the gauge and anchor
  histories and the last big-change version equal the JAX mapper's.
- `Tracker._adopt`: a big change re-anchors the pose through the
  package's keyframe, and a gauge scale rescales the stored relative frame
  poses, within 1e-5 of the JAX tracker's.
- Queue rules: max_queue refuses, force=True accepts, wait=True waits
  for the idle mapper and accepts, the BA is skipped
  while packages wait and forced through after max_ba_skips skips, an
  exception in `_process` surfaces at the next enqueue / flush and at the
  tracker's next adoption, stop() and flush() return within their
  timeouts; a running global BA of the mapper is stopped with the
  tracker's; the inertial events reach the tracker through the commits.
"""

import dataclasses
import os
import sys
import time
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

from orb_slam3_tpu.mapping import pipeline as jpipe
from orb_slam3_tpu.runtime import mapper as jmapper
from orb_slam3_tpu.tracking import tracker as jtrk
from orb_slam3_tpu_torch import convert
from orb_slam3_tpu_torch.mapping import pipeline as tpipe
from orb_slam3_tpu_torch.runtime import mapper as tmapper
from orb_slam3_tpu_torch.tracking import tracker as ttrk
from test_torch_mapping import K_NP, OCFG, WH

torch.set_num_threads(1)


def _rot(rng, scale=0.4):
    w = rng.normal(size=3) * scale
    th = np.linalg.norm(w)
    k = w / th
    Kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return (np.eye(3) + np.sin(th) * Kx + (1 - np.cos(th)) * Kx @ Kx).astype(np.float32)


def _pose(rng):
    return _rot(rng), rng.normal(size=3).astype(np.float32)


def _packages(R, t, version):
    """The same package (pose only) for both mappers."""
    none = dict(feat_xy=None, feat_octave=None, feat_angle=None, feat_desc=None,
                feat_valid=None, feat_lm=None, feat_ur=None, feat_depth=None, n_inliers=0)
    j = jpipe.KFPackage(R=jnp.asarray(R), t=jnp.asarray(t), timestamp=1.0,
                        gauge_version=version, **none)
    p = tpipe.KFPackage(R=torch.from_numpy(R), t=torch.from_numpy(t), timestamp=1.0,
                        gauge_version=version, **none)
    return j, p


def _mappers(**kw):
    j = jmapper.AsyncMapper(None, None, "mono", inline=True, **kw)
    j._reset_gauge()
    cfg = types.SimpleNamespace(K=torch.zeros(8), kmax=1000, local_window=4, kind=0)
    p = tmapper.AsyncMapper(cfg, None, "mono", inline=True, **kw)
    p._reset_gauge()
    return j, p


def _states(rng, n=6):
    Rs = np.stack([_rot(rng) for _ in range(n)])
    ts = rng.normal(size=(n, 3)).astype(np.float32)
    return (types.SimpleNamespace(kf_R=jnp.asarray(Rs), kf_t=jnp.asarray(ts)),
            types.SimpleNamespace(kf_R=torch.from_numpy(Rs), kf_t=torch.from_numpy(ts)))


@pytest.mark.parametrize("case", ["gauge_event", "anchor_after_loop", "ordinary_commit"])
def test_regauge_pkg_matches_jax(case):
    rng = np.random.default_rng({"gauge_event": 1, "anchor_after_loop": 2,
                                 "ordinary_commit": 3}[case])
    j, p = _mappers()
    js, ps = _states(rng)
    j._state, p._state = js, ps
    Rg_old, Rg = _rot(rng, 0.2), _rot(rng, 0.2)
    for m in (j, p):
        m._gauge_hist = {3: (Rg_old, 1.1)}
        m._gauge_tot = (Rg, 1.7)
        m._last_change_version = 5
    if case == "anchor_after_loop":
        Ra, ta = _pose(rng)
        j._anchor_hist = {3: (2, jnp.asarray(Ra), jnp.asarray(ta))}
        p._anchor_hist = {3: (2, torch.from_numpy(Ra), torch.from_numpy(ta))}
    R, t = _pose(rng)
    version = 5 if case == "ordinary_commit" else 3
    jpkg, ppkg = _packages(R, t, version)
    jout, pout = j._regauge_pkg(jpkg), p._regauge_pkg(ppkg)
    if case == "ordinary_commit":
        assert pout is ppkg and jout is jpkg
        return
    assert not np.allclose(pout.t.numpy(), t, atol=1e-3)  # the package moved
    np.testing.assert_allclose(pout.R.numpy(), np.asarray(jout.R), atol=1e-5)
    np.testing.assert_allclose(pout.t.numpy(), np.asarray(jout.t), atol=1e-5)


def _commit_pair(mod, state, version, kf_row, R, t, **kw):
    arr = (jnp.asarray if mod is jmapper else torch.from_numpy)
    return mod.MapCommit(state=state, version=version, kf_row=kf_row, pkg_R=arr(R),
                         pkg_t=arr(t), big_change=kw.pop("big_change"), n_loops=0,
                         n_merges=0, **kw)


def test_publish_folds_unpolled_commits_as_jax_does():
    rng = np.random.default_rng(4)
    j, p = _mappers()
    js, ps = _states(rng)
    R, t = _pose(rng)
    flags = [dict(big_change=True, gauge_scale=1.5, bad_imu=False, kf_row=2),
             dict(big_change=False, gauge_scale=0.8, bad_imu=True, kf_row=3),
             dict(big_change=False, gauge_scale=1.25, bad_imu=False, kf_row=-1)]
    for v, f in enumerate(flags, start=1):
        f = dict(f)
        kf_row = f.pop("kf_row")
        for m, mod, st in ((j, jmapper, js), (p, tmapper, ps)):
            m._gauge_tot = (np.eye(3, dtype=np.float32), 1.0 + v)
            m._publish(_commit_pair(mod, st, v, kf_row, R, t, **f))
    cj, cp = j.poll_commit(), p.poll_commit()
    assert cp.gauge_scale == pytest.approx(cj.gauge_scale) == pytest.approx(1.5 * 0.8 * 1.25)
    assert cp.big_change is cj.big_change is True
    assert cp.bad_imu is cj.bad_imu is True
    assert p.poll_commit() is None and j.poll_commit() is None
    assert p._last_change_version == j._last_change_version == 1
    assert sorted(p._gauge_hist) == sorted(j._gauge_hist)
    for v in j._gauge_hist:
        assert p._gauge_hist[v][1] == j._gauge_hist[v][1]
    assert sorted(p._anchor_hist) == sorted(j._anchor_hist) == [1, 2]
    for v, (r, Ra, ta) in j._anchor_hist.items():
        assert p._anchor_hist[v][0] == r
        np.testing.assert_array_equal(p._anchor_hist[v][1].numpy(), np.asarray(Ra))
        np.testing.assert_array_equal(p._anchor_hist[v][2].numpy(), np.asarray(ta))


def _trackers():
    jcfg = jtrk.TrackerConfig(K=jnp.asarray(K_NP), img_wh=WH, orb=OCFG, kmax=8, lmax=64)
    tcfg = ttrk.TrackerConfig(K=convert.camera(K_NP, "cpu"), img_wh=WH,
                              orb=convert.orb_config(OCFG), kmax=8, lmax=64)
    return jtrk.Tracker(jcfg), ttrk.Tracker(tcfg)


@pytest.mark.parametrize("big_change", [True, False])
def test_adopt_reanchors_and_rescales_as_jax_does(big_change):
    rng = np.random.default_rng(5 + big_change)
    jt, pt = _trackers()
    js, ps = _states(rng)
    R_last, t_last = _pose(rng)
    R_pkg, t_pkg = _pose(rng)
    jt.last = {"R": jnp.asarray(R_last), "t": jnp.asarray(t_last), "ts": 1.0}
    pt.last = {"R": torch.from_numpy(R_last), "t": torch.from_numpy(t_last), "ts": 1.0}
    rels = [_pose(rng) for _ in range(3)]
    jt.trajectory = [jtrk.FrameRecord(0.1 * i, 1, R, t, True) for i, (R, t) in enumerate(rels)]
    pt.trajectory = [ttrk.FrameRecord(0.1 * i, 1, torch.from_numpy(R), torch.from_numpy(t), True)
                     for i, (R, t) in enumerate(rels)]
    kw = dict(big_change=big_change, gauge_scale=1.37)
    jt._adopt(_commit_pair(jmapper, js, 7, 4, R_pkg, t_pkg, **kw))
    pt._adopt(_commit_pair(tmapper, ps, 7, 4, R_pkg, t_pkg, **kw))
    assert pt.last_kf_row == jt.last_kf_row == 4
    assert pt._mapper_gauge_version == jt._mapper_gauge_version == 7
    assert pt.map is ps
    np.testing.assert_allclose(pt.last["R"].numpy(), np.asarray(jt.last["R"]), atol=1e-5)
    np.testing.assert_allclose(pt.last["t"].numpy(), np.asarray(jt.last["t"]), atol=1e-5)
    if not big_change:
        np.testing.assert_array_equal(pt.last["t"].numpy(), t_last)
    for a, b in zip(pt.trajectory, jt.trajectory):
        np.testing.assert_allclose(a.t_rel.numpy(), np.asarray(b.t_rel), atol=1e-5)
    assert (pt.velocity is None) and (jt.velocity is None)


# ---------------------------------------------------------------------------
# queue rules, on the port alone
# ---------------------------------------------------------------------------

def _pkg():
    return _packages(np.eye(3, dtype=np.float32), np.zeros(3, np.float32), 0)[1]


def _cpu_mapper(**kw):
    cfg = types.SimpleNamespace(K=torch.zeros(8), kmax=1000, local_window=4, kind=0)
    return tmapper.AsyncMapper(cfg, None, "mono", **kw)


def _stub_state():
    return types.SimpleNamespace(n_kf=torch.tensor(0), kf_R=torch.zeros(8, 3, 3),
                                 kf_t=torch.zeros(8, 3))


def _stub_stages(monkeypatch, calls):
    """Stages that only count: the queue rules do not depend on them."""
    monkeypatch.setattr(tpipe, "run_pre_stage",
                        lambda s, pkg, cfg, base, parent, sf, kf_row_host=None:
                        (s, kf_row_host, None, 1))
    monkeypatch.setattr(tpipe, "run_visual_ba",
                        lambda s, *a, **kw: calls.append("ba") or s)
    monkeypatch.setattr(tpipe, "map_stage_post",
                        lambda s, rows, min_kf: calls.append(("post", min_kf)) or s)
    monkeypatch.setattr(tmapper.AsyncMapper, "_commit",
                        lambda self, s, kf, pkg, big, **kw: tmapper.MapCommit(
                            s, self._version, kf, pkg.R, pkg.t, big, 0, 0, **kw))


def test_queue_refuses_when_full_and_force_accepts():
    m = _cpu_mapper(inline=True, max_queue=2)
    assert m.enqueue(_pkg()) and m.enqueue(_pkg())
    assert not m.enqueue(_pkg())
    assert m.queue_len() == 2 and not m.idle()
    assert m.enqueue(_pkg(), force=True)
    assert m.queue_len() == 3 and m.max_queue_seen == 3


def test_a_waiting_enqueue_waits_for_the_idle_mapper(monkeypatch):
    """A stereo / RGB-D keyframe is not dropped when the mapper is behind:
    its request waits until the mapper is idle (inline: it processes what
    waits) and is accepted, so the mapper lags by one package at most."""
    calls = []
    _stub_stages(monkeypatch, calls)
    m = _cpu_mapper(inline=True, max_queue=2)
    m.start(_stub_state(), -1)
    assert m.enqueue(_pkg()) and m.enqueue(_pkg()) and not m.enqueue(_pkg())
    assert m.enqueue(_pkg(), wait=True)
    assert m.n_processed == 2 and len(m._queue) == 1
    # the first ran while the second waited (its BA skipped), the second not
    assert (m.n_ba_runs, m.n_ba_skips) == (1, 1)


def test_ba_is_skipped_while_packages_wait_and_forced_after_max_skips(monkeypatch):
    calls = []
    _stub_stages(monkeypatch, calls)
    m = _cpu_mapper(inline=True, max_ba_skips=2)
    m.start(_stub_state(), -1)
    for _ in range(5):
        assert m.enqueue(_pkg(), force=True)
    runs = []
    for _ in range(5):
        m.step_inline()
        runs.append(calls.count("ba"))
    # waiting 4, 3, 2, 1, 0: skip, skip, forced, skip, idle
    assert runs == [0, 0, 1, 1, 2]
    assert (m.n_processed, m.n_ba_runs, m.n_ba_skips) == (5, 2, 3)
    # a skipped BA still culls, with keyframe culling gated off
    assert calls.count(("post", 1000 + 1)) == 3 and calls.count(("post", 4 + 4)) == 2
    c = m.poll_commit()
    assert c.kf_row == 4 and m.idle() and m.flush(timeout=1.0) is None


def test_inertial_ba_is_never_skipped_before_the_imu_init(monkeypatch):
    """Before the IMU init every inertial package runs its BA, whatever
    waits (the init aligns the chain these BAs refine); after it the queue
    rule holds as for a visual package."""
    from orb_slam3_tpu_torch.tracking import vi_tracker as tvit

    calls = []
    _stub_stages(monkeypatch, calls)
    monkeypatch.setattr(tvit, "run_vi_local_ba",
                        lambda ctx, rows, n_fixed, **kw: calls.append("vi_ba") or True)
    monkeypatch.setattr(tvit, "try_initialize_imu", lambda ctx, **kw: False)
    monkeypatch.setattr(tvit, "try_refine_imu", lambda ctx, **kw: False)
    monkeypatch.setattr(tvit, "cull_keyframes_inertial", lambda ctx, rows: False)
    monkeypatch.setattr(tmapper.local_mapper, "cull_landmarks", lambda s: s)
    monkeypatch.setattr(tmapper.atlas_state, "update_landmark_stats", lambda s: s)
    m = _cpu_mapper(inline=True, max_ba_skips=2)
    imu = tvit.ImuState(dict(noise_gyro=1e-3, noise_acc=1e-2, walk_gyro=1e-4, walk_acc=1e-3),
                        np.eye(4, dtype=np.float32), "cpu")
    m.start(_stub_state(), -1, imu=imu)
    interval = (np.zeros((2, 3)), np.zeros((2, 3)), np.full(2, 0.005), np.zeros(2))

    def run(n):
        for _ in range(n):
            assert m.enqueue(dataclasses.replace(_pkg(), imu_interval=interval), force=True)
        for _ in range(n):
            m.step_inline()

    monkeypatch.setattr(tmapper.AsyncMapper, "_take", lambda self, pkg: None)
    # ba_rows as host_window reads them
    monkeypatch.setattr(tpipe, "run_pre_stage",
                        lambda s, pkg, cfg, base, parent, sf, kf_row_host=None:
                        (s, kf_row_host, torch.zeros(8, dtype=torch.int32), torch.tensor(1)))
    run(4)
    assert calls.count("ba") == 4 and m.n_ba_skips == 0   # before the init: every BA
    m._vi_ctx.imu.initialized = True
    m._vi_ctx.imu.viba_stage = 2   # past the bad-IMU check
    run(4)
    # waiting 3, 2, 1, 0: skip, skip, forced, idle
    assert calls.count("vi_ba") == 2 and m.n_ba_skips == 2
    assert sorted(m._vi_ctx.imu.kf_buffers) == list(range(8))


def test_an_exception_in_process_surfaces_at_the_next_call(monkeypatch):
    def boom(self, pkg):
        raise ValueError("boom")

    monkeypatch.setattr(tmapper.AsyncMapper, "_process", boom)
    m = _cpu_mapper()
    m.start(_stub_state(), -1)
    try:
        assert m.enqueue(_pkg())
        with pytest.raises(RuntimeError, match="mapper failed") as e:
            m.flush(timeout=10.0)
        assert isinstance(e.value.__cause__, ValueError)
        with pytest.raises(RuntimeError, match="mapper failed"):
            m.enqueue(_pkg())
    finally:
        m.stop(timeout=10.0)
    # inline: kept, and raised at the tracker's next adoption
    tr = ttrk.Tracker(ttrk.TrackerConfig(K=convert.camera(K_NP, "cpu"), img_wh=WH,
                                         orb=convert.orb_config(OCFG), kmax=8, lmax=64))
    tr.async_mapper = mi = _cpu_mapper(inline=True)
    mi.start(_stub_state(), -1)
    mi.enqueue(_pkg())
    with pytest.raises(RuntimeError, match="mapper failed"):
        tr._adopt_commits()


def test_stop_and_flush_return_within_their_timeouts():
    m = _cpu_mapper()
    m.start(_stub_state(), -1)
    assert m._thread.is_alive() and m._thread.name == "mapper"
    t0 = time.perf_counter()
    assert m.flush(timeout=5.0) is None   # idle: returns at once
    assert time.perf_counter() - t0 < 1.0
    t0 = time.perf_counter()
    m.stop(timeout=5.0)
    assert time.perf_counter() - t0 < 5.0 and not m._thread.is_alive()
    assert m not in tmapper._LIVE_MAPPERS


def test_stop_gba_aborts_the_mappers_campaign_too():
    """Compaction and a map reset stop a running global BA: on the
    asynchronous schedule it is the mapper's (launched after a loop on the
    mapper thread), which the JAX tracker leaves running; its result would
    be reconciled onto rows that compaction renumbered."""
    class Campaign:
        running, aborted = True, False

        def request_abort(self):
            self.aborted, self.running = True, False

        def join(self, timeout=None):
            pass

    tr = ttrk.Tracker(ttrk.TrackerConfig(K=convert.camera(K_NP, "cpu"), img_wh=WH,
                                         orb=convert.orb_config(OCFG), kmax=8, lmax=64))
    tr.async_mapper = m = _cpu_mapper(inline=True)
    m.gba = g = Campaign()
    tr._stop_gba()
    assert g.aborted and m.gba is None and tr.gba is None


def test_inertial_events_reach_the_tracker_through_the_commits():
    """The init / refinement events of the mapper's context are folded into
    the next commit and appended to the tracker's debug_events at adoption
    (save_debug_data reads them; the JAX tracker keeps them on the mapper)."""
    rng = np.random.default_rng(9)
    _, p = _mappers()
    _, ps = _states(rng)
    R, t = _pose(rng)
    for v, ev in enumerate(([{"event": "init", "scale": 1.3}], [{"event": "viba1", "scale": 1.01}]),
                           start=1):
        p._publish(_commit_pair(tmapper, ps, v, 1, R, t, big_change=True, debug_events=ev))
    c = p.poll_commit()
    assert [e["event"] for e in c.debug_events] == ["init", "viba1"]
    tr = ttrk.Tracker(ttrk.TrackerConfig(K=convert.camera(K_NP, "cpu"), img_wh=WH,
                                         orb=convert.orb_config(OCFG), kmax=8, lmax=64))
    tr._adopt(c)
    assert [e["event"] for e in tr.debug_events] == ["init", "viba1"]


def test_hand_over_walks_packages_and_states():
    pkg = dataclasses.replace(_pkg(), imu_interval=(np.zeros(3),), stat_vis=torch.zeros(4))
    found = list(tmapper._tensors((pkg, {"x": torch.ones(2)}, None)))
    assert len(found) == 4  # R, t, stat_vis and the dict's tensor
    tmapper.hand_over(pkg, None)  # no stream: nothing to mark
