"""Visual-inertial parts of the tracker (port of
orb_slam3_tpu/tracking/vi_tracker.py).

The IMU side of Tracking (`Tracking.cc`): per-frame IMU ingestion and the
preintegration from the last frame and from the last keyframe
(`GrabImuData:1618`, `PreintegrateIMU:1624`); and of LocalMapping: the
inertial initialization and its gauge transform (`InitializeIMU:1173`,
`Map::ApplyScaledRotation:252`), the staged refinements (VIBA1, VIBA2, the
monocular scale refinement), inertial keyframe culling and the
visual-inertial local BA (`LocalInertialBA` through imu/vi_ba.py).

Every mapping routine here (`run_vi_local_ba`, `try_initialize_imu`,
`try_refine_imu`, `cull_keyframes_inertial`) takes a `tracker`: the
Tracker on the synchronous path, or the background mapper's `MapperVICtx`,
which holds the mapper's own map and a clone of the IMU state.

The map stores camera poses Tcw; the body pose is Twb = Tcw^-1 Tcb with
the fixed extrinsics Tbc (X_b = Rbc X_c + tbc, IMU::Calib). The raw
measurements stay on the host in numpy, as in the JAX package; each
preintegration moves one window (or one stack of windows) to the
tracker's device and runs there.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Optional

import numpy as np
import torch

from ..atlas import ops as atlas_ops
from ..imu import factors, initialization, vi_ba
from ..imu import preintegration as pre
from ..ops import lie
from ..ops.scatter import mark, put_drop

IMU_BUF = 512  # samples kept per keyframe interval

# window-length buckets of the JAX package's VI-BA (one XLA program per
# bucket). The port keeps them: a pad row's chain edge is an empty window
# whose information (1e10) sets the BA's cost scale, so the bucket is part
# of the numbers (PERF.md section 7)
VI_W_BUCKETS = (10, 12, 16, 24, 32, 48, 64)


def _w_bucket(n: int) -> int:
    for b in VI_W_BUCKETS:
        if n <= b:
            return b
    return -(-n // 32) * 32


def cam_to_body(R_cw, t_cw, Rbc, tbc):
    """Tcw -> Twb = Twc Tcb, with Tbc mapping camera to body."""
    R_wc, t_wc = lie.se3_inv(R_cw, t_cw)
    Rcb, tcb = lie.se3_inv(Rbc, tbc)
    return lie.se3_mul(R_wc, t_wc, Rcb, tcb)


def body_to_cam(R_wb, t_wb, Rbc, tbc):
    """Twb -> Tcw, contiguous (K2 takes the pose as it is laid out)."""
    R_wc, t_wc = lie.se3_mul(R_wb, t_wb, Rbc, tbc)
    R_cw, t_cw = lie.se3_inv(R_wc, t_wc)
    return R_cw.contiguous(), t_cw


class ImuState:
    """The tracker's IMU bookkeeping: biases, velocity and the per-keyframe
    measurement intervals (host numpy), the staged-refinement flags."""

    def __init__(self, noise: dict, Tbc: np.ndarray, device):
        self.noise = dict(noise)
        self.device = device
        f32 = dict(dtype=torch.float32, device=device)
        Tbc = np.asarray(Tbc, np.float32)
        self.Rbc = torch.as_tensor(Tbc[:3, :3], **f32)
        self.tbc = torch.as_tensor(Tbc[:3, 3], **f32)
        self.initialized = False
        self.bg = torch.zeros(3, **f32)
        self.ba = torch.zeros(3, **f32)
        self.vel = torch.zeros(3, **f32)      # current body velocity (world)
        self.kf_buffers = {}                  # kf_row -> (acc, gyro, dts) since the previous kf
        self._cur = ([], [], [], [])          # (acc, gyro, dts, ts) since the last kf
        self._frame_meas = None               # measurements since the last frame
        self._frame_window = None             # (bg, ba, its preintegration)
        self.first_kf_ts = None
        # staged refinement (VIBA1 at t > 5 s, VIBA2 at t > 15 s, mono scale
        # refinement every ~10 s until 75 s; LocalMapping.cc:200-242)
        self.init_ts = None
        self.viba_stage = 0
        self.last_scale_refine_ts = None
        self.tinit = 0.0                      # motion-gated init time (mTinit)
        self.bad = False                      # mbBadImu (LocalMapping.cc:144)

    # ------------------------------------------------------------------
    def ingest(self, imu):
        """imu rows [M, 7] (t, gx, gy, gz, ax, ay, az) since the previous
        frame (the reference's vImuMeas)."""
        self._frame_window = None
        if imu is None or len(imu) == 0:
            self._frame_meas = None
            return
        imu = np.asarray(imu)
        ts = imu[:, 0]
        dts = np.diff(ts, prepend=ts[0] - (ts[1] - ts[0] if len(ts) > 1 else 0.005))
        gyro, acc = imu[:, 1:4], imu[:, 4:7]
        self._frame_meas = (acc, gyro, dts)
        for lst, x in zip(self._cur, (acc, gyro, dts, ts)):
            lst.append(x)

    def _integrate(self, acc, gyro, dts, bg, ba):
        """One window on the device (the last IMU_BUF samples)."""
        acc, gyro, dts = acc[-IMU_BUF:], gyro[-IMU_BUF:], dts[-IMU_BUF:]
        f32 = dict(dtype=torch.float32, device=self.device)
        buf = torch.as_tensor(np.concatenate([acc, gyro, dts[:, None]], axis=1), **f32)
        return pre.integrate(buf[:, :3], buf[:, 3:6], buf[:, 6], None, bg, ba, **self.noise)

    def preint_frame(self):
        """The window since the last frame at the current biases, or None.
        A frame integrates it for the prediction and again for the
        pose-inertial refinement: the second call returns the first's
        result while the biases are the same tensors."""
        if self._frame_meas is None:
            return None
        hit = self._frame_window
        if hit is None or hit[0] is not self.bg or hit[1] is not self.ba:
            hit = self._frame_window = (self.bg, self.ba,
                                        self._integrate(*self._frame_meas, self.bg, self.ba))
        return hit[2]

    def frame_dt(self) -> float:
        """Host seconds covered by the last frame's measurements."""
        return float(np.sum(self._frame_meas[2])) if self._frame_meas is not None else 0.0

    def since_kf_dt(self) -> float:
        return float(sum(np.sum(d) for d in self._cur[2])) if self._cur[2] else 0.0

    def preint_since_kf(self, bg=None, ba=None):
        """The window over every measurement since the last keyframe
        (mpImuPreintegratedFromLastKF), the inertial edge of
        PoseInertialOptimizationLastKeyFrame; None before any."""
        a, g, d, _ = self._cur
        if not a:
            return None
        return self._integrate(np.concatenate(a), np.concatenate(g), np.concatenate(d),
                               self.bg if bg is None else bg, self.ba if ba is None else ba)

    def commit_keyframe(self, kf_row: int, timestamp: float):
        """The since-last-keyframe buffer becomes this keyframe's interval."""
        a, g, d, _ = self._cur
        if a:
            self.kf_buffers[kf_row] = (np.concatenate(a), np.concatenate(g), np.concatenate(d))
        self._cur = ([], [], [], [])
        if self.first_kf_ts is None:
            self.first_kf_ts = timestamp

    def cut_interval(self):
        """Detach and return the since-last-keyframe buffer (acc, gyro, dts,
        ts), resetting the accumulation as commit_keyframe does (the
        reference starts mpImuPreintegratedFromLastKF afresh at
        CreateNewKeyFrame, Tracking.cc:3216)."""
        a, g, d, tl = self._cur
        out = tuple(np.concatenate(x) for x in (a, g, d, tl)) if a else None
        self._cur = ([], [], [], [])
        return out

    def restore_interval(self, interval):
        """Undo cut_interval: the measurements belong to the open window."""
        if interval is None:
            return
        a, g, d, tl = self._cur
        self._cur = ([interval[0]] + a, [interval[1]] + g, [interval[2]] + d,
                     [interval[3]] + tl)

    def store_interval(self, kf_row: int, interval, timestamp: float):
        """commit_keyframe for an interval cut earlier."""
        if interval is not None:
            self.kf_buffers[kf_row] = interval[:3]
        if self.first_kf_ts is None:
            self.first_kf_ts = timestamp

    def clone_for_mapper(self) -> "ImuState":
        """A copy for the background mapper's context that shares no mutable
        buffer with this one: the mapper owns the keyframe intervals and the
        init / refinement bookkeeping from here on, and the tracker's copies
        are refreshed from its commits. The tensors are shared: every
        update replaces them, none writes in place."""
        c = ImuState(self.noise, np.eye(4, dtype=np.float32), self.device)
        c.Rbc, c.tbc = self.Rbc, self.tbc
        c.initialized = self.initialized
        c.bg, c.ba, c.vel = self.bg, self.ba, self.vel
        c.kf_buffers = copy.deepcopy(self.kf_buffers)
        c.first_kf_ts = self.first_kf_ts
        c.init_ts = self.init_ts
        c.viba_stage = self.viba_stage
        c.last_scale_refine_ts = self.last_scale_refine_ts
        c.tinit = self.tinit
        c.bad = self.bad
        return c

    def trim_before(self, t0: float):
        """Drop the accumulated measurements at or before t0: the map's first
        keyframe is committed at the reference frame's timestamp, and what
        was recorded while searching for an initialization pair precedes
        the map (Tracking.cc:2526-2660)."""
        a, g, d, tl = self._cur
        if not a:
            return
        acc, gyro, dts, ts = (np.concatenate(x) for x in (a, g, d, tl))
        keep = ts > t0 + 1e-9
        self._cur = (([acc[keep]], [gyro[keep]], [dts[keep]], [ts[keep]]) if keep.any()
                     else ([], [], [], []))

    def stacked_buffers(self, kf_rows):
        """Padded [N, IMU_BUF] stacks (acc, gyro, dts, valid) of the
        intervals ending at kf_rows (None or a row without a buffer: an
        all-invalid window), and the longest window's length."""
        n = len(kf_rows)
        acc = np.zeros((n, IMU_BUF, 3), np.float32)
        gyro = np.zeros((n, IMU_BUF, 3), np.float32)
        dts = np.zeros((n, IMU_BUF), np.float32)
        valid = np.zeros((n, IMU_BUF), np.float32)
        longest = 0
        for i, r in enumerate(kf_rows):
            if r is None or r not in self.kf_buffers:
                continue
            a, g, d = self.kf_buffers[r]
            m = min(len(d), IMU_BUF)
            acc[i, :m], gyro[i, :m], dts[i, :m], valid[i, :m] = a[-m:], g[-m:], d[-m:], 1.0
            longest = max(longest, m)
        return acc, gyro, dts, valid, longest

    def integrate_intervals(self, kf_rows, bg, ba):
        """The intervals ending at kf_rows preintegrated side by side as one
        stack at biases bg / ba [N, 3] (the JAX package's vmapped
        `_integrate_batch`; rows without a buffer stay empty windows)."""
        acc, gyro, dts, valid, longest = self.stacked_buffers(kf_rows)
        f32 = dict(dtype=torch.float32, device=self.device)
        return pre.integrate(torch.as_tensor(acc, **f32), torch.as_tensor(gyro, **f32),
                             torch.as_tensor(dts, **f32), torch.as_tensor(valid, **f32),
                             bg, ba, length=longest, **self.noise)

    def preint_between(self, kf_row: int, bg=None, ba=None):
        """(Re-)integrate the stored interval ending at kf_row
        (Preintegrated::Reintegrate on a bias update, ImuTypes.cc:168)."""
        if kf_row not in self.kf_buffers:
            return None
        return self._integrate(*self.kf_buffers[kf_row], self.bg if bg is None else bg,
                               self.ba if ba is None else ba)


@dataclasses.dataclass
class MapperVICtx:
    """The stand-in for the Tracker that every inertial mapping routine
    accepts: the background mapper's own map and IMU state. It has no
    trajectory, and `last` is None, so `_apply_inertial_solution` moves
    neither: the tracker rescales its relative frame poses and re-anchors
    its pose when it adopts the commit (its `gauge_scale`)."""

    map: object
    imu: ImuState
    cfg: object
    scale_factors: object
    debug_events: list
    last: Optional[dict] = None
    velocity: object = None
    _vi_prior: object = None
    last_kf_row: int = -1


# ----------------------------------------------------------------------
# inertial initialization (LocalMapping::InitializeIMU)
# ----------------------------------------------------------------------

def _inertial_chain(tracker, bg=None, ba=None):
    """(chain rows, stacked windows, R_wb, t_wb) of the temporal chain
    (buffer r covers kf_prev[r] -> r), or None. The chain follows mPrevKF
    links, so it stays connected across culled keyframes; only its
    connected suffix is kept."""
    imu = tracker.imu
    s = tracker.map
    host = torch.cat([s.n_kf.reshape(1), s.kf_prev, s.kf_valid.to(torch.int32)]).cpu().numpy()
    K = s.kmax
    n_kf, kf_prev, kf_valid = int(host[0]), host[1:K + 1], host[K + 1:].astype(bool)
    rows = [r for r in range(1, n_kf)
            if r in imu.kf_buffers and kf_valid[r] and kf_prev[r] >= 0 and kf_valid[kf_prev[r]]]
    connected = []
    for r in rows:
        if connected and kf_prev[r] != connected[-1]:
            connected = []
        connected.append(r)
    rows = connected
    if not rows:
        return None
    n_e = len(rows)
    bg1 = (imu.bg if bg is None else bg).reshape(1, 3).expand(n_e, 3)
    ba1 = (imu.ba if ba is None else ba).reshape(1, 3).expand(n_e, 3)
    pstack = imu.integrate_intervals(rows, bg1, ba1)
    chain = [int(kf_prev[rows[0]])] + rows
    idx = torch.as_tensor(chain, device=s.device)
    R_wb, t_wb = cam_to_body(s.kf_R[idx], s.kf_t[idx], imu.Rbc, imu.tbc)
    return chain, pstack, R_wb, t_wb


def _apply_inertial_solution(tracker, out, chain, update_bias=True, event: str = "init"):
    """Gauge transform and state writes shared by the init and the
    refinements (ApplyScaledRotation + UpdateFrameIMU, LocalMapping.cc:
    1281-1295): X' = s Ryw X over the active map, the chain's velocities,
    the biases, the tracked pose and the stored relative frame poses."""
    imu = tracker.imu
    s = tracker.map
    dev = s.device
    scale = out["scale"].to(torch.float32).reshape(())
    Ryw = out["Rwg"].T
    g = out["Rwg"] @ pre.gravity_vec(dev)
    host = torch.cat([scale.reshape(1), g, out["bg"], out["ba"], Ryw.reshape(-1),
                      s.kf_timestamp[(s.n_kf - 1).long()].reshape(1)]).cpu().numpy()
    tracker.debug_events.append({
        "ts": float(host[-1]), "event": event, "scale": float(host[0]),
        "gravity": host[1:4].copy(), "bg": host[4:7].copy(), "ba": host[7:10].copy(),
        "Ryw": host[10:19].reshape(3, 3).copy()})
    s2 = atlas_ops.apply_scaled_rotation(s, Ryw, scale, s.active_map)
    v_new = scale * (out["velocities"] @ Ryw.T)
    kf_vel = s2.kf_vel.clone()
    kf_vel[torch.as_tensor(chain, device=dev)] = v_new
    s2 = dataclasses.replace(s2, kf_vel=kf_vel)
    if update_bias:
        s2 = dataclasses.replace(s2, kf_bg=out["bg"][None].expand(s2.kmax, 3).clone(),
                                 kf_ba=out["ba"][None].expand(s2.kmax, 3).clone())
        imu.bg, imu.ba = out["bg"], out["ba"]
    tracker.map = s2
    imu.vel = v_new[-1]
    if tracker.last is not None:
        tracker.last["R"] = tracker.last["R"] @ Ryw.T
        tracker.last["t"] = scale * tracker.last["t"]
    # the stored relative frame poses rescale with the gauge
    # (Tracking::UpdateFrameIMU, Tracking.cc:3980-4010); the mapper's
    # context has none (the tracker rescales at adoption)
    s_host = float(host[0])
    for f in getattr(tracker, "trajectory", ()):
        f.t_rel = f.t_rel * s_host
    tracker.velocity = None
    tracker._vi_prior = None


def try_initialize_imu(tracker, min_kfs: int = 10, min_time=None, n_kf_host=None,
                       ts_now_host=None) -> bool:
    """Inertial-only MAP and the gauge transform once the chain holds
    `min_kfs` keyframes over `min_time` seconds (2 s monocular, 1 s with
    depth; LocalMapping.cc:1178-1189). Monocular warm-starts the MAP from
    the closed-form linear alignment, postpones while its two scale reads
    disagree, and keeps the linear gauge when the MAP runs off it. Then a
    joint visual-inertial BA with strong bias priors (FullInertialBA,
    LocalMapping.cc:1304-1310), alternated for monocular with two
    scale-and-gravity re-solves. The background mapper passes its host
    mirrors of n_kf and of the newest keyframe's timestamp (`n_kf_host`,
    `ts_now_host`), so the gates read nothing from the device. Returns True
    on success."""
    imu = tracker.imu
    s = tracker.map
    mono = tracker.cfg.sensor == "mono-imu"
    if min_time is None:
        min_time = 2.0 if mono else 1.0
    n_kf = int(s.n_kf) if n_kf_host is None else int(n_kf_host)
    if imu.initialized or n_kf < min_kfs or imu.first_kf_ts is None:
        return False
    ts_now = float(s.kf_timestamp[n_kf - 1]) if ts_now_host is None else float(ts_now_host)
    if ts_now - imu.first_kf_ts < min_time:
        return False
    chain_out = _inertial_chain(tracker)
    if chain_out is None or len(chain_out[0]) < min_kfs:
        return False
    chain, preints, R_wb, t_wb = chain_out

    fix_scale = tracker.cfg.sensor in ("stereo-imu", "rgbd-imu")
    s_lin = Rwg_lin = v_lin = None
    if not fix_scale:
        s_lin, s_q, Rwg_lin, v_lin = initialization.linear_alignment(R_wb, t_wb, preints)
        if not np.isfinite(s_lin) or s_lin <= 1e-2:
            return False
        # the two independent scale reads must agree, else the data is thin
        if not (np.isfinite(s_q) and 0.5 < s_q / s_lin < 2.0):
            return False
    out = initialization.inertial_only_optimization(
        R_wb, t_wb, preints, fix_scale=fix_scale, s0=s_lin, Rwg0=Rwg_lin, v0=v_lin)
    scale = float(out["scale"])
    if not fix_scale and not (s_lin / 3.0 < scale < s_lin * 3.0):
        # the MAP left the convex solution: keep the linear gauge, take the
        # biases from the MAP
        out = dict(out, scale=torch.tensor(s_lin, dtype=torch.float32, device=s.device),
                   Rwg=Rwg_lin, velocities=v_lin)
        scale = s_lin
    if scale <= 1e-2:
        return False

    _apply_inertial_solution(tracker, out, chain)
    imu.initialized = True
    imu.init_ts = ts_now
    imu.viba_stage = 0
    imu.last_scale_refine_ts = ts_now
    pa = 1e10 if mono else 1e5
    run_full_inertial_ba(tracker, 1e2, pa, iters=15)
    if mono:
        for _ in range(2):
            if not scale_refine_once(tracker):
                break
            run_full_inertial_ba(tracker, 1e2, pa, iters=10)
    return True


def _scale_gravity_only(tracker, chain, preints, R_wb, t_wb, iters: int = 30):
    """InertialOptimization with the biases and velocities frozen at the
    map's estimates: only the scale and the gravity direction are solved
    (Optimizer.cc:3389)."""
    imu = tracker.imu
    v0 = tracker.map.kf_vel[torch.as_tensor(chain, device=tracker.map.device)]
    return initialization.inertial_only_optimization(
        R_wb, t_wb, preints, bg0=imu.bg, ba0=imu.ba, fix_bias=True, v0=v0,
        fix_velocities=True, iters=iters)


def try_refine_imu(tracker, n_kf_host=None, ts_now_host=None) -> bool:
    """The staged refinement after the init (LocalMapping::Run, LocalMapping.cc:
    200-242): VIBA1 re-runs the inertial MAP with relaxed priors (1, 1e5)
    after more than 5 s, VIBA2 with none after more than 15 s, each ending
    in a full inertial BA; monocular also refines scale and gravity every
    ~10 s until 75 s. A refinement scale outside (0.5, 2) is refused (the
    map is already metric). `n_kf_host` / `ts_now_host` as for
    try_initialize_imu. Returns True when the map was transformed."""
    imu = tracker.imu
    s = tracker.map
    if not imu.initialized or imu.init_ts is None:
        return False
    n_kf = int(s.n_kf) if n_kf_host is None else int(n_kf_host)
    ts_now = float(s.kf_timestamp[n_kf - 1]) if ts_now_host is None else float(ts_now_host)
    tinit = ts_now - imu.init_ts
    stage_prior = None
    if imu.viba_stage == 0 and tinit > 5.0:
        stage_prior = (1.0, 1e5)        # VIBA1 (LocalMapping.cc:207)
    elif imu.viba_stage == 1 and tinit > 15.0:
        stage_prior = (0.0, 0.0)        # VIBA2 (:221)
    mono = tracker.cfg.sensor == "mono-imu"
    want_scale_refine = (mono and stage_prior is None and imu.viba_stage >= 1 and tinit < 75.0
                         and ts_now - (imu.last_scale_refine_ts or ts_now) > 10.0)
    if stage_prior is None and not want_scale_refine:
        return False
    chain_out = _inertial_chain(tracker, bg=imu.bg, ba=imu.ba)
    if chain_out is None or len(chain_out[0]) < 4:
        return False
    chain, preints, R_wb, t_wb = chain_out
    fix_scale_sensor = tracker.cfg.sensor in ("stereo-imu", "rgbd-imu")

    if stage_prior is not None:
        pg, pa = stage_prior
        out = initialization.inertial_only_optimization(
            R_wb, t_wb, preints, prior_gyro=max(pg, 1e-6), prior_acc=max(pa, 1e-6),
            fix_scale=fix_scale_sensor, bg0=imu.bg, ba0=imu.ba)
        scale = float(out["scale"])
        if scale <= 1e-2 or not np.isfinite(scale) or not (0.5 < scale < 2.0):
            return False
        _apply_inertial_solution(tracker, out, chain, event=f"viba{imu.viba_stage + 1}")
        run_full_inertial_ba(tracker, pg, pa, iters=10)
        imu.viba_stage += 1
        return True

    out = _scale_gravity_only(tracker, chain, preints, R_wb, t_wb)
    imu.last_scale_refine_ts = ts_now
    scale = float(out["scale"])
    if scale <= 1e-2 or not np.isfinite(scale) or not (0.5 < scale < 2.0):
        return False
    if abs(scale - 1.0) < 1e-5:   # only a meaningful correction (|s - 1| > 1e-5)
        return False
    _apply_inertial_solution(tracker, out, chain, update_bias=False, event="scale_refine")
    return True


def scale_refine_once(tracker) -> bool:
    """One scale-and-gravity-only solve against the inertial chain
    (ScaleRefinement, LocalMapping.cc:1429), accepted within (0.25, 4):
    the joint BA descends the scale valley slowly, this jumps to the
    inertially consistent scale."""
    imu = tracker.imu
    chain_out = _inertial_chain(tracker, bg=imu.bg, ba=imu.ba)
    if chain_out is None or len(chain_out[0]) < 4:
        return False
    out = _scale_gravity_only(tracker, *chain_out)
    scale = float(out["scale"])
    if scale <= 1e-2 or not np.isfinite(scale) or not (0.25 < scale < 4.0):
        return False
    if abs(scale - 1.0) < 1e-5:
        return False
    _apply_inertial_solution(tracker, out, chain_out[0], update_bias=False,
                             event="scale_refine")
    return True


def cull_keyframes_inertial(tracker, window_rows, min_redundancy: float = 0.9) -> bool:
    """KeyFrameCulling for inertial maps (LocalMapping.cc:902-1041): the
    redundancy test (more than 90% of over 10 bound landmarks seen by 3
    other keyframes; 50% with depth) plus the temporal-chain rules: the
    gap a culled keyframe leaves stays under 3 s (monocular) / 0.5 s, and
    its IMU interval merges into its successor's (MergePrevious,
    ImuTypes.cc:237). One host read of the map's keyframe tables; the
    decisions are the JAX function's host loop."""
    s = tracker.map
    imu = tracker.imu
    if tracker.cfg.sensor == "mono-imu":
        max_gap = 3.0
    else:
        max_gap, min_redundancy = 0.5, 0.5
    L, K = s.lmax, s.kmax
    n_kf = int(s.n_kf)
    lm_all = s.kf_feat_lm.cpu().numpy()
    fv_all = s.kf_feat_valid.cpu().numpy()
    kf_valid = s.kf_valid.cpu().numpy().copy()
    kf_prev = s.kf_prev.cpu().numpy().copy()
    ts = s.kf_timestamp.cpu().numpy()
    obs_cnt = np.zeros(L, np.int64)
    bound_all = (lm_all >= 0) & fv_all
    np.add.at(obs_cnt, np.clip(lm_all, 0, L - 1)[bound_all], 1)
    next_of = -np.ones(K, np.int32)
    for r in range(n_kf):
        if kf_prev[r] >= 0:
            next_of[kf_prev[r]] = r
    killed = []
    for k in (int(r) for r in np.asarray(window_rows)):
        if k <= 1 or k >= n_kf - 2 or not kf_valid[k]:
            continue
        p, nx = kf_prev[k], next_of[k]
        if p < 0 or nx < 0 or not (kf_valid[p] and kf_valid[nx]):
            continue
        if ts[nx] - ts[p] >= max_gap:
            continue
        bound = bound_all[k]
        if int(bound.sum()) <= 10:
            continue
        frac = float((obs_cnt[np.clip(lm_all[k], 0, L - 1)][bound] >= 4).mean())
        if frac <= min_redundancy:
            continue
        # the interval prev -> k merges into k -> next
        if k in imu.kf_buffers and nx in imu.kf_buffers:
            a1, g1, d1 = imu.kf_buffers.pop(k)
            a2, g2, d2 = imu.kf_buffers[nx]
            imu.kf_buffers[nx] = (np.concatenate([a1, a2]), np.concatenate([g1, g2]),
                                  np.concatenate([d1, d2]))
        elif k in imu.kf_buffers:
            imu.kf_buffers[nx] = imu.kf_buffers.pop(k)
        kf_prev[nx] = p
        next_of[p] = nx
        kf_valid[k] = False
        killed.append(k)
    if not killed:
        return False
    dev = s.device
    killed_mask = mark(K, torch.as_tensor(killed, device=dev),
                       torch.ones(len(killed), dtype=torch.bool, device=dev), dev)
    # children re-parent to their first surviving ancestor (a single hop
    # dangles when the grandparent died in the same pass)
    parent0 = s.kf_parent.cpu().numpy()
    new_parent = parent0.copy()
    killed_set = set(killed)
    for r in range(n_kf):
        p = int(new_parent[r])
        while p >= 0 and p in killed_set:
            p = int(parent0[p])
        new_parent[r] = p
    i32 = dict(dtype=torch.int32, device=dev)
    tracker.map = dataclasses.replace(
        s, kf_valid=torch.as_tensor(kf_valid, device=dev),
        kf_prev=torch.as_tensor(kf_prev, **i32),
        kf_feat_lm=torch.where(killed_mask[:, None] & (s.kf_feat_lm >= 0), -1, s.kf_feat_lm),
        kf_parent=torch.as_tensor(new_parent, **i32))
    return True


# ----------------------------------------------------------------------
# VI local BA dispatch
# ----------------------------------------------------------------------

def run_vi_local_ba(tracker, window_rows, n_fixed: int, iters: int = 6,
                    bias_prior=None) -> bool:
    """LocalInertialBA over the window rows (the inertial chain needs
    consecutive mPrevKF links; with bias_prior and the whole chain this is
    FullInertialBA, Optimizer.cc:392-811). The window is padded to its
    bucket by repeating the last row (fixed, no visual edge, no chain
    edge), as in the JAX package. A row that appears twice is written back
    from its last slot. Returns False when no chain edge exists."""
    cfg = tracker.cfg
    imu = tracker.imu
    s = tracker.map
    dev = s.device
    rows = [int(r) for r in np.asarray(window_rows)]
    W0 = len(rows)
    W = _w_bucket(W0)
    rows = rows + [rows[-1]] * (W - W0)
    real = np.arange(W) < W0
    L, Fc = s.lmax, s.fmax
    kf_prev = s.kf_prev.cpu().numpy()
    interval_rows, ok_chain = [], []
    for i in range(W - 1):
        ok = bool(real[i + 1] and kf_prev[rows[i + 1]] == rows[i]
                  and rows[i + 1] in imu.kf_buffers)
        interval_rows.append(rows[i + 1] if ok else None)
        ok_chain.append(ok)
    if not any(ok_chain):
        return False
    rows_t = torch.as_tensor(rows, device=dev)
    real_t = torch.as_tensor(real, device=dev)
    Rwb, twb = cam_to_body(s.kf_R[rows_t], s.kf_t[rows_t], imu.Rbc, imu.tbc)
    pstack = imu.integrate_intervals(interval_rows, s.kf_bg[rows_t[:-1]], s.kf_ba[rows_t[:-1]])
    preint_data, preint_info = factors.preint_edge_data(pstack)
    rw_info = factors.rw_info6(pstack)

    # visual edges of the window's rows (a pad row contributes none)
    lm_idx0 = s.kf_feat_lm[rows_t]
    feat_ok = s.kf_feat_valid[rows_t] & (lm_idx0 >= 0) & real_t[:, None]
    lm_safe = torch.clamp(lm_idx0, 0, L - 1).long()
    obs_ok = (feat_ok & s.lm_valid[lm_safe]).reshape(-1)
    cam_idx = torch.arange(W, device=dev)[:, None].expand(W, Fc).reshape(-1)
    lm_edge = lm_safe.reshape(-1)
    oct_ = s.kf_feat_octave[rows_t].reshape(-1)
    sf = tracker.scale_factors
    inv_sig2 = 1.0 / sf[torch.clamp(oct_, 0, sf.shape[0] - 1).long()] ** 2
    observed = mark(L, lm_edge, obs_ok, dev)
    cam_fixed = (torch.arange(W, device=dev) < n_fixed) | ~real_t
    src = torch.arange(W - 1, dtype=torch.int32, device=dev)
    Ro, to, vo, bgo, bao, Xo, _ = vi_ba.local_inertial_ba(
        cfg.kind, cfg.K, imu.Rbc, imu.tbc, Rwb, twb, s.kf_vel[rows_t], s.kf_bg[rows_t],
        s.kf_ba[rows_t], cam_fixed, s.lm_pos, ~observed, cam_idx, lm_edge,
        s.kf_feat_xy[rows_t].reshape(-1, 2), inv_sig2, obs_ok, preint_data, preint_info,
        rw_info, src, src + 1, torch.as_tensor(ok_chain, device=dev), iters=iters,
        bias_prior=bias_prior)
    R_cw, t_cw = body_to_cam(Ro, to, imu.Rbc, imu.tbc)
    # the last slot of each row writes; pads and earlier repeats drop
    last = [bool(real[i]) and rows[i] not in rows[i + 1:W0] for i in range(W)]
    rows_w = torch.where(torch.as_tensor(last, device=dev), rows_t, s.kmax)
    tracker.map = dataclasses.replace(
        s, kf_R=put_drop(s.kf_R, rows_w, R_cw), kf_t=put_drop(s.kf_t, rows_w, t_cw),
        kf_vel=put_drop(s.kf_vel, rows_w, vo), kf_bg=put_drop(s.kf_bg, rows_w, bgo),
        kf_ba=put_drop(s.kf_ba, rows_w, bao), lm_pos=Xo)
    imu.bg, imu.ba, imu.vel = bgo[W0 - 1], bao[W0 - 1], vo[W0 - 1]
    return True


def run_full_inertial_ba(tracker, prior_g: float, prior_a: float, iters: int = 15) -> bool:
    """FullInertialBA over the active map's whole temporal chain
    (Optimizer.cc:392-811; LocalMapping.cc:1304-1310 with priors 1e2 /
    1e10 at init, 1 / 1e5 at VIBA1, 0 / 0 at VIBA2) with zero-mean bias
    priors on the first keyframe."""
    imu = tracker.imu
    chain_out = _inertial_chain(tracker, bg=imu.bg, ba=imu.ba)
    if chain_out is None or len(chain_out[0]) < 4:
        return False
    prior = None
    if prior_g > 0 or prior_a > 0:
        prior = (max(prior_g, 1e-6), max(prior_a, 1e-6))
    return run_vi_local_ba(tracker, np.asarray(chain_out[0]), n_fixed=1, iters=iters,
                           bias_prior=prior)
