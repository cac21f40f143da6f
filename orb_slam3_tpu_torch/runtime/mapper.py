"""Background mapper thread: the LocalMapping + LoopClosing runtime (port of
orb_slam3_tpu/runtime/mapper.py).

Replaces the reference's two long-lived worker threads (`System.cc:197,
214`: `LocalMapping::Run`, `LoopClosing::Run`) and their queue protocol
(fuse and BA are skipped while keyframes wait, `LocalMapping.cc:108-156`).

- The mapper owns the canonical MapState. Tracking never writes it: the
  tracker reads the latest published commit (an immutable snapshot; every
  atlas op returns new tensors) and buffers its per-landmark statistics
  into the next KFPackage.
- Each processed package publishes a `MapCommit`; the tracker adopts it at
  the next frame boundary (the reference's map-change dataflow,
  `Tracking.cc:1888-1896`), re-anchoring its pose after a loop, merge,
  global BA or inertial gauge change.
- Local BA runs as one call. Its preemption is the queue rule: while
  packages wait the BA is skipped, at most `max_ba_skips` times in a row
  (`LocalMapping.cc:108-156`; the JAX mapper, `runtime/mapper.py:418-445`);
  an inertial package's BA is not skipped before the IMU init.

On CUDA the mapper thread runs all its work inside `torch.cuda.stream` of
a stream of its own. A package is consumed after the mapper's stream waits
for the event the tracker recorded at enqueue; a commit is consumed after
the tracker's stream waits for the event recorded at publish. Every tensor
that crosses from one stream to the other is marked with `record_stream`
by its consumer (`hand_over`), so the caching allocator does not reuse its
block while the other stream may still read it. In inline mode (the
deterministic schedule) there is no thread and no second stream.
"""

from __future__ import annotations

import atexit
import contextlib
import dataclasses
import threading
import weakref
from collections import deque
from typing import Optional

import numpy as np
import torch

from ..atlas import state as atlas_state
from ..mapping import global_ba, local_mapper, pipeline
from ..ops import lie
from ..tracking import vi_tracker
from ..utils import verbose
from ..utils.timing import GLOBAL_TIMER as T

# mappers still alive at interpreter exit are stopped from an atexit hook: a
# daemon thread left inside a CUDA call at teardown aborts the process
_LIVE_MAPPERS: "weakref.WeakSet[AsyncMapper]" = weakref.WeakSet()


@atexit.register
def _stop_live_mappers():
    for m in list(_LIVE_MAPPERS):
        # at exit there is no caller left to raise to: drop what waits and
        # let the thread finish its package
        with contextlib.suppress(Exception):
            m.stop(timeout=5.0, drain=False)


def _tensors(obj):
    if torch.is_tensor(obj):
        yield obj
    elif dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            yield from _tensors(getattr(obj, f.name))
    elif isinstance(obj, (tuple, list)):
        for x in obj:
            yield from _tensors(x)
    elif isinstance(obj, dict):
        for x in obj.values():
            yield from _tensors(x)


def hand_over(obj, stream) -> None:
    """Mark every CUDA tensor in `obj` (a tensor, a dataclass of them, a
    tuple, list or dict) as used on `stream`: the caching allocator then
    holds its block until the work queued there has finished. Nothing for
    stream None (the CPU, or inline mode)."""
    if stream is None:
        return
    for t in _tensors(obj):
        if t.is_cuda:
            t.record_stream(stream)


@dataclasses.dataclass
class MapCommit:
    """One atomic map update published by the mapper."""

    state: atlas_state.MapState
    version: int
    kf_row: int                       # newest keyframe row
    pkg_R: Optional[torch.Tensor]     # the package's Tcw (re-gauged) at enqueue
    pkg_t: Optional[torch.Tensor]
    big_change: bool                  # loop / merge / GBA / gauge: re-anchor
    n_loops: int
    n_merges: int
    # inertial commits: the bias / velocity estimates, the staged-init
    # progress, and the net gauge scale applied since the previous commit
    # (the tracker rescales its relative frame poses by it,
    # Tracking::UpdateFrameIMU, Tracking.cc:3980); bad_imu is mbBadImu
    # (LocalMapping.cc:144)
    imu_state: Optional[dict] = None
    gauge_scale: float = 1.0
    bad_imu: bool = False
    # [n_kf, n_lm, TrackedMapPoints(1), (2), (3)] of the new reference
    # keyframe (KeyFrame.cc:500), read by the tracker at adoption
    stats: Optional[torch.Tensor] = None
    pkg_ts: Optional[float] = None    # the keyframe's timestamp
    event: Optional[object] = None    # torch.cuda.Event after the commit's work
    debug_events: list = dataclasses.field(default_factory=list)  # inertial events


class AsyncMapper:
    """The background mapper. `inline=True` is the deterministic schedule:
    no thread, the tracker calls `step_inline` at each frame boundary and
    the same enqueue / process / commit / adopt dataflow runs on a fixed
    schedule."""

    def __init__(self, cfg, scale_factors, base_sensor: str, loop_closer=None,
                 background_gba: bool = True, max_queue: int = 3, max_ba_skips: int = 2,
                 inline: bool = False):
        self.cfg = cfg
        self.scale_factors = scale_factors
        self.base_sensor = base_sensor
        self.loop_closer = loop_closer
        self.background_gba = background_gba
        self.max_queue = max_queue
        self.max_ba_skips = max_ba_skips
        self.inline = inline
        self.device = cfg.K.device
        self._stream = None           # the mapper's CUDA stream (thread mode on CUDA)
        self._state: Optional[atlas_state.MapState] = None
        self._seeded = False          # _state came from the tracker's stream
        self._vi_ctx = None           # MapperVICtx of an inertial sensor
        self._version = 0
        self._last_kf_row = -1
        self._host_n_kf = 0
        self._kf_ts_host = {}
        self._queue: deque = deque()
        self._cond = threading.Condition()
        self._busy = False
        self._stop = False
        self._skipped_ba = 0
        self._latest: Optional[MapCommit] = None
        self._thread: Optional[threading.Thread] = None
        self.gba = None
        self.error: Optional[BaseException] = None
        self.n_processed = 0
        self.n_ba_runs = 0
        self.n_ba_skips = 0
        self.max_queue_seen = 0

    # ------------------------------------------------------------------
    # tracker side
    # ------------------------------------------------------------------
    def start(self, initial_state: atlas_state.MapState, last_kf_row: int, imu=None):
        """Seed the canonical state and start the thread (unless inline)."""
        self._seed(initial_state, imu)
        self._last_kf_row = last_kf_row
        self._stop = False
        if self.inline:
            return
        if self.device.type == "cuda":
            self._stream = torch.cuda.Stream(self.device)
        self._thread = threading.Thread(target=self._run, name="mapper", daemon=True)
        self._thread.start()
        _LIVE_MAPPERS.add(self)

    def _seed(self, s, imu):
        self._state = s
        self._seeded = True
        # host mirrors: each processed package appends one keyframe row, and
        # the timestamps of the rows inserted since the seed
        self._host_n_kf = int(s.n_kf)
        self._kf_ts_host = {}
        if imu is not None:
            self._vi_ctx = vi_tracker.MapperVICtx(
                map=s, imu=imu.clone_for_mapper(), cfg=self.cfg,
                scale_factors=self.scale_factors, debug_events=[])
        self._reset_gauge()

    def _record(self):
        """An event on the calling thread's current stream, or None."""
        if self._stream is None:
            return None
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(self.device))
        return ev

    def step_inline(self, max_packages: int = 1):
        """Process up to `max_packages` queued packages on the caller's
        thread (the deterministic schedule). An exception is kept in
        `error`, as the thread keeps it, and surfaces at the next call."""
        assert self.inline
        for _ in range(max_packages):
            with self._cond:
                if not self._queue:
                    return
                pkg, _ = self._queue.popleft()
            try:
                self._process(pkg)
            except Exception as e:  # noqa: BLE001 -- raised at the next enqueue / adoption
                self.error = e
                return

    def _raise_error(self):
        if self.error is not None:
            raise RuntimeError("the background mapper failed") from self.error

    def enqueue(self, pkg: pipeline.KFPackage, force: bool = False, wait: bool = False) -> bool:
        """LocalMapping::InsertKeyFrame. False when the queue is full
        (NeedNewKeyFrame checks idleness first, so this is a backstop).
        force=True always accepts: an inertial keyframe is never dropped
        (the reference's queue is unbounded, LocalMapping.cc:284; a dropped
        one breaks the preintegration chain). wait=True first waits until
        the mapper is idle (an inline mapper processes what waits), so the
        package is never refused and the mapper lags by one package at
        most."""
        self._raise_error()
        if wait:
            if self.inline:
                while self._queue and self.error is None:
                    self.step_inline()
            else:
                with self._cond:
                    self._cond.wait_for(lambda: (not self._queue and not self._busy)
                                        or self.error is not None)
            self._raise_error()
        ev = self._record()
        with self._cond:
            if not force and len(self._queue) >= self.max_queue:
                return False
            self._queue.append((pkg, ev))
            self.max_queue_seen = max(self.max_queue_seen,
                                      len(self._queue) + (1 if self._busy else 0))
            self._cond.notify_all()
        return True

    def export_imu(self):
        """The mapper-owned IMU bookkeeping (call only while idle, after
        flush), so that the tracker's map surgery (compaction's row remap, a
        reset) works on the real state before the mapper is reseeded."""
        return None if self._vi_ctx is None else self._vi_ctx.imu

    def _publish(self, commit: MapCommit):
        """Install a commit as the latest, folding in what the tracker has
        not polled yet: it adopts only the latest commit, so the gauge
        scales, the big-change and bad-IMU flags and the inertial events of
        a superseded commit carry into it."""
        if commit.big_change:
            # packages enqueued under this version or later are in the
            # corrected world
            self._last_change_version = commit.version
        with self._cond:
            prev = self._latest
            if prev is not None:
                commit.gauge_scale *= prev.gauge_scale
                commit.big_change = commit.big_change or prev.big_change
                commit.bad_imu = commit.bad_imu or prev.bad_imu
                commit.debug_events = prev.debug_events + commit.debug_events
            # the cumulative gauge and the newest keyframe's pose under this
            # version, for re-gauging packages enqueued after its adoption
            self._gauge_hist[commit.version] = self._gauge_tot
            if commit.kf_row >= 0:
                self._anchor_hist[commit.version] = (
                    int(commit.kf_row), commit.state.kf_R[commit.kf_row],
                    commit.state.kf_t[commit.kf_row])
            for hist in (self._gauge_hist, self._anchor_hist):
                if len(hist) > 64:
                    for v in sorted(hist)[:-32]:
                        del hist[v]
            self._latest = commit
            self._cond.notify_all()

    def poll_commit(self) -> Optional[MapCommit]:
        """The latest commit if newer than the last poll, else None."""
        with self._cond:
            c, self._latest = self._latest, None
            return c

    def queue_len(self) -> int:
        with self._cond:
            return len(self._queue) + (1 if self._busy else 0)

    def idle(self) -> bool:
        return self.queue_len() == 0

    def flush(self, timeout: float = 600.0) -> Optional[MapCommit]:
        """Block until every queued package is processed and return the
        final commit (the RequestStop + isStopped barrier role). Raises the
        mapper's exception, or TimeoutError after `timeout` seconds."""
        if self.inline:
            self.step_inline(max_packages=len(self._queue))
            self._raise_error()
            return self.poll_commit()
        with self._cond:
            done = self._cond.wait_for(
                lambda: (not self._queue and not self._busy) or self.error is not None,
                timeout=timeout)
        self._raise_error()
        if not done:
            raise TimeoutError(f"the background mapper did not drain within {timeout} s")
        return self.poll_commit()

    def set_state(self, s: atlas_state.MapState, last_kf_row: Optional[int] = None, imu=None):
        """Replace the canonical state; legal only while idle (callers flush
        first). The tracker's own map operations (a new map, a relocalization
        map switch, compaction, a re-initialization) reseed the mapper
        through this; an inertial tracker passes its ImuState, which is
        cloned."""
        with self._cond:
            assert not self._queue and not self._busy, "set_state while the mapper is busy"
            self._version += 1
            self._seed(s, imu)
            if last_kf_row is not None:
                self._last_kf_row = last_kf_row

    def _reset_gauge(self):
        """The cumulative world-gauge transform of the inertial solutions
        since the seed, X' = s_tot R_tot X, snapshotted per commit version,
        and the newest keyframe's pose per version: `_regauge_pkg`
        re-expresses a package enqueued before an inertial gauge event or a
        loop / merge / GBA correction (the reference stops LocalMapping and
        drains its queue before CorrectLoop moves the world,
        LoopClosing.cc:975-999; this queue survives the correction, so its
        packages move instead)."""
        self._gauge_tot = (np.eye(3, dtype=np.float32), 1.0)
        self._gauge_hist = {self._version: self._gauge_tot}
        self._anchor_hist = {}
        self._last_change_version = self._version

    def _regauge_pkg(self, pkg: pipeline.KFPackage) -> pipeline.KFPackage:
        """The package's pose in the current world. Unchanged unless a big
        change committed after the version the tracker enqueued it under
        (ordinary local-BA refinement does not move it): through the anchor
        keyframe's pose change, T' = (T_pkg T_a_old^-1 scaled by ds) T_a_new,
        or by the gauge alone, R' = R dR^T, t' = ds t."""
        v = pkg.gauge_version
        if v >= self._last_change_version:
            return pkg
        Ra_g, sa_g = self._gauge_hist.get(v, self._gauge_tot)
        Rc_g, sc_g = self._gauge_tot
        ds = sc_g / sa_g
        anch = self._anchor_hist.get(v)
        if anch is not None:
            r, Ra, ta = anch
            Rrel, trel = lie.se3_mul(pkg.R, pkg.t, *lie.se3_inv(Ra, ta))
            Rn, tn = lie.se3_mul(Rrel, trel * ds, self._state.kf_R[r], self._state.kf_t[r])
            return dataclasses.replace(pkg, R=lie.normalize_rotation(Rn), t=tn)
        if ds != 1.0 or not np.array_equal(Ra_g, Rc_g):
            dR = torch.as_tensor(Rc_g @ Ra_g.T, dtype=torch.float32, device=pkg.R.device)
            return dataclasses.replace(pkg, R=pkg.R @ dR.T, t=pkg.t * ds)
        return pkg

    def stop(self, timeout: float = 30.0, drain: bool = True):
        """Stop the thread (after the queue drains; with drain=False the
        waiting packages are dropped) and abort a running global BA. Raises
        TimeoutError when the thread does not end within `timeout`."""
        if not self.inline:
            with self._cond:
                self._stop = True
                if not drain:
                    self._queue.clear()
                self._cond.notify_all()
            if self._thread is not None:
                self._thread.join(timeout)
                if self._thread.is_alive():
                    raise TimeoutError(f"the mapper thread did not stop within {timeout} s")
                _LIVE_MAPPERS.discard(self)
        if self.gba is not None and self.gba.running:
            self.gba.request_abort()
            self.gba.join(timeout)

    # ------------------------------------------------------------------
    # mapper thread
    # ------------------------------------------------------------------
    def _queue_nonempty(self) -> bool:
        with self._cond:
            return len(self._queue) > 0

    def _run(self):
        try:
            with torch.cuda.stream(self._stream):
                while True:
                    with self._cond:
                        self._cond.wait_for(lambda: self._queue or self._stop)
                        if self._stop and not self._queue:
                            return
                        pkg, ev = self._queue.popleft()
                        self._busy = True
                    try:
                        if ev is not None:
                            self._stream.wait_event(ev)
                        self._process(pkg)
                    finally:
                        with self._cond:
                            self._busy = False
                            self._cond.notify_all()
        except Exception as e:  # noqa: BLE001 -- raised at the tracker's next call
            self.error = e
            with self._cond:
                self._busy = False
                self._cond.notify_all()

    def _take(self, pkg):
        """The mapper's stream uses the package's tensors (and, after a
        seed, the state's and the IMU clone's) from here on."""
        hand_over(pkg, self._stream)
        if self._seeded:
            hand_over(self._state, self._stream)
            if self._vi_ctx is not None:
                imu = self._vi_ctx.imu
                hand_over((imu.bg, imu.ba, imu.vel), self._stream)
            self._seeded = False

    def _commit(self, s, kf: int, pkg, big: bool, **kw) -> MapCommit:
        from ..tracking.tracker import _ref_tracked_map_points

        stats = torch.stack([s.n_kf.to(torch.int64), s.n_lm.to(torch.int64)] + [
            _ref_tracked_map_points(s, kf, m).to(torch.int64) for m in (1, 2, 3)])
        lc = self.loop_closer
        self._version += 1
        return MapCommit(state=s, version=self._version, kf_row=kf, pkg_R=pkg.R, pkg_t=pkg.t,
                         big_change=big, n_loops=lc.n_loops if lc else 0,
                         n_merges=lc.n_merges if lc else 0, stats=stats,
                         pkg_ts=float(pkg.timestamp), event=self._record(), **kw)

    def _process(self, pkg: pipeline.KFPackage):
        cfg = self.cfg
        self._take(pkg)
        if self._host_n_kf >= cfg.kmax - 1:
            verbose.print_mess("mapper: keyframe arena full, dropping keyframe",
                               verbose.VERBOSITY_NORMAL)
            return
        if self.gba is not None and self.gba.failed:
            raise RuntimeError("the background global BA failed") from self.gba.error
        # a package that straddles a loop / merge / GBA correction or an
        # inertial gauge event carries a pose in the old world
        pkg = self._regauge_pkg(pkg)
        if self._vi_ctx is not None and pkg.imu_interval is not None:
            return self._process_inertial(pkg)
        dev = self.device
        s = self._state
        with T.stage_sync("map.pre", dev):
            s, kf, ba_rows, n_fixed = pipeline.run_pre_stage(
                s, pkg, cfg, self.base_sensor, self._last_kf_row, self.scale_factors,
                kf_row_host=self._host_n_kf)
            self._host_n_kf += 1
        # local BA only while no package waits (LocalMapping.cc:108-156),
        # forced through after max_ba_skips skips in a row
        if not self._queue_nonempty() or self._skipped_ba >= self.max_ba_skips:
            with T.stage_sync("map.local_ba", dev):
                s = pipeline.run_visual_ba(s, cfg, self.scale_factors, ba_rows, n_fixed,
                                           self.base_sensor)
            with T.stage_sync("map.culling", dev):
                s = pipeline.map_stage_post(s, ba_rows, cfg.local_window + 4)
            self._skipped_ba = 0
            self.n_ba_runs += 1
        else:
            # MapPointCulling runs on every keyframe (LocalMapping.cc:105)
            with T.stage_sync("map.culling", dev):
                s = pipeline.map_stage_post(s, ba_rows, cfg.kmax + 1)
            self._skipped_ba += 1
            self.n_ba_skips += 1

        # a finished background global BA folds into the canonical state
        # (RunGlobalBundleAdjustment's catch-up, LoopClosing.cc:2320-2494)
        big = False
        if self.gba is not None and self.gba.finished:
            s = self.gba.reconcile(s)
            self.gba = None
            big = True
        if self.loop_closer is not None:
            loops_before = self.loop_closer.n_loops
            self.loop_closer.inertial = None
            with T.stage_sync("map.loop_detect", dev):
                s, closed = self.loop_closer.on_keyframe(s, kf, cfg.kind, cfg.K)
            if closed:
                big = True
                if self.loop_closer.n_loops > loops_before:
                    if self.gba is not None and self.gba.running:
                        self.gba.request_abort()   # mbStopGBA
                    elif self.background_gba and self._host_n_kf < 200:
                        self.gba = global_ba.GlobalBARunner(cfg.K, cfg.kind)
                        self.gba.launch(s)
        self._state = s
        self._last_kf_row = kf
        self.n_processed += 1
        self._publish(self._commit(s, kf, pkg, big))

    def _process_inertial(self, pkg: pipeline.KFPackage):
        """One inertial keyframe through the mapping stack (the
        LocalMapping::Run body for IMU sensors, LocalMapping.cc:64-282,
        1173-1496) against the mapper's own map and ImuState: the fused pre
        stage, the interval, the bad-IMU check, the visual-inertial (or
        visual) local BA, culling, the staged IMU init / refinement, the
        loop closer with the inertial context and MergeInertialBA. Gauge
        transforms reach the tracker as the commit's gauge_scale."""
        cfg = self.cfg
        ctx = self._vi_ctx
        dev = self.device
        s = self._state
        ts = float(pkg.timestamp)
        events0 = len(ctx.debug_events)
        with T.stage_sync("map.pre", dev):
            s, kf, ba_rows, n_fixed = pipeline.run_pre_stage(
                s, pkg, cfg, self.base_sensor, self._last_kf_row, self.scale_factors,
                kf_row_host=self._host_n_kf)
            self._host_n_kf += 1
            ctx.imu.store_interval(kf, pkg.imu_interval, ts)
            # the bad-IMU check (LocalMapping.cc:130-146), one host read:
            # the init time accumulates only while the last three keyframes'
            # centres move more than 0.05
            bad = False
            prev = self._last_kf_row
            if ctx.imu.initialized and ctx.imu.viba_stage < 2 and prev >= 0:
                pprev_d = s.kf_prev[prev]
                rs = torch.stack([torch.tensor(kf, device=dev), torch.tensor(prev, device=dev),
                                  torch.clamp(pprev_d.long(), 0, cfg.kmax - 1)])
                cs = -torch.einsum("kij,ki->kj", s.kf_R[rs], s.kf_t[rs])
                pprev, dist = torch.stack([
                    pprev_d.to(torch.float32),
                    torch.linalg.norm(cs[0] - cs[1]) + torch.linalg.norm(cs[1] - cs[2])]).tolist()
                if pprev >= 0:
                    prev_ts = self._kf_ts_host.get(prev)
                    if prev_ts is None:
                        prev_ts = float(s.kf_timestamp[prev])
                    if dist > 0.05:
                        ctx.imu.tinit += ts - prev_ts
                    if ctx.imu.tinit < 10.0 and dist < 0.02:
                        verbose.print_mess("Not enough motion for initializing. Reseting...",
                                           verbose.VERBOSITY_NORMAL)
                        ctx.imu.bad = bad = True
            self._kf_ts_host[kf] = ts
        if bad:
            # the tracker resets the active map when it adopts the flag
            self._state = s
            self._last_kf_row = kf
            self._publish(self._commit(s, kf, pkg, True, bad_imu=True, debug_events=[
                {"event": "bad_imu_reset", "t": ts}]))
            return

        w = cfg.local_window
        host = {}

        def host_window():
            # the VI paths take host rows: read once, when one runs
            if not host:
                host["rows"], host["n_fixed"] = ba_rows.cpu().numpy(), int(n_fixed)
            return host["rows"], host["n_fixed"]

        ctx.map = s
        # the queue rule, except before the IMU init: the init aligns the
        # keyframe chain that these BAs refine. On the card this mapper is
        # host-bound and falls behind the 0.25 s keyframe cadence, and with
        # two of every three pre-init BAs skipped the init's scale went
        # wrong in 2 of 8 runs (ROADMAP Queue 3)
        if (ctx.imu.initialized and self._queue_nonempty()
                and self._skipped_ba < self.max_ba_skips):
            self._skipped_ba += 1
            self.n_ba_skips += 1
        else:
            with T.stage_sync("map.local_ba", dev):
                ran_vi = ctx.imu.initialized and vi_tracker.run_vi_local_ba(ctx, *host_window())
                if ran_vi:
                    s = ctx.map
                else:
                    s = pipeline.run_visual_ba(s, cfg, self.scale_factors, ba_rows, n_fixed,
                                               self.base_sensor)
            self._skipped_ba = 0
            self.n_ba_runs += 1
        with T.stage_sync("map.culling", dev):
            if ctx.imu.initialized:
                s = atlas_state.update_landmark_stats(local_mapper.cull_landmarks(s))
                ctx.map = s
                if self._host_n_kf > w + 4:
                    vi_tracker.cull_keyframes_inertial(ctx, host_window()[0][:w + 4])
                    s = ctx.map
            else:
                # before the init keyframes are not culled (the gate lies
                # above the arena)
                s = pipeline.map_stage_post(s, ba_rows, cfg.kmax + 1)

        # the staged inertial initialization / refinement, gated on the
        # host mirrors (this keyframe is the newest)
        ctx.map = s
        with T.stage_sync("map.imu_stage", dev):
            if not ctx.imu.initialized:
                vi_tracker.try_initialize_imu(ctx, n_kf_host=self._host_n_kf, ts_now_host=ts)
            else:
                vi_tracker.try_refine_imu(ctx, n_kf_host=self._host_n_kf, ts_now_host=ts)
        s = ctx.map

        # the net gauge scale of this package's events, folded into the
        # cumulative gauge (Rg <- Ryw Rg, sg <- s sg)
        gauge_scale, gauged = 1.0, False
        events = ctx.debug_events[events0:]
        for e in events:
            if "scale" in e:
                gauge_scale *= float(e["scale"])
                gauged = True
                if "Ryw" in e:
                    Rg, sg = self._gauge_tot
                    self._gauge_tot = (np.asarray(e["Ryw"], np.float32) @ Rg,
                                       sg * float(e["scale"]))

        # loop / merge detection with the inertial context (the VIBA2 gate,
        # LoopClosing.cc:341); after an inertial merge the temporal window
        # is re-solved with its inertial chain (MergeInertialBA,
        # LoopClosing.cc:1783, Optimizer.cc:3948)
        big = gauged
        if self.loop_closer is not None:
            merges_before = self.loop_closer.n_merges
            self.loop_closer.inertial = (ctx.imu.initialized, ctx.imu.viba_stage)
            with T.stage_sync("map.loop_detect", dev):
                s, closed = self.loop_closer.on_keyframe(s, kf, cfg.kind, cfg.K)
            big = big or closed
            if closed and self.loop_closer.n_merges > merges_before:
                ctx.map = s
                n_rows = min(self._host_n_kf, 10)
                rows = np.arange(self._host_n_kf - n_rows, self._host_n_kf)
                if vi_tracker.run_vi_local_ba(ctx, rows, n_fixed=1):
                    s = ctx.map
        self._state = s
        self._last_kf_row = kf
        self.n_processed += 1
        imu = ctx.imu
        imu_state = dict(initialized=imu.initialized, viba_stage=imu.viba_stage,
                         bg=imu.bg, ba=imu.ba, vel=imu.vel)
        self._publish(self._commit(s, kf, pkg, big, imu_state=imu_state,
                                   gauge_scale=gauge_scale, debug_events=list(events)))
