"""The public session façade (port of orb_slam3_tpu/api/system.py for the
six sensors).

The reference's top-level API (`System.h:105-198`, `System.cc`): construct
from a reference-format settings file and a sensor, or from a config; feed
frames with `track_monocular`, `track_stereo` or `track_rgbd` as the
sensor asks, each with the frame's IMU measurements for an inertial sensor
(a legacy stereo file's rectification blocks remap both images first, and
`Camera.newWidth/newHeight` resizes every image); switch
localization-only mode on and off, query the tracking state, reset, export
trajectories. With a vocabulary the session relocalizes, closes loops and
merges maps; `run_global_ba` optimizes the active map. `save_atlas` writes
the Atlas and `atlas_path` resumes from one (`api/checkpoint.py`, files
shared with the JAX package); `save_map_3d` writes the interactive HTML map
and `start_viewer` serves the live session over HTTP. The session maps on
the background mapper thread unless its config says otherwise; call
`shutdown` before leaving.
"""

from __future__ import annotations

import threading
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from .. import device as device_mod
from ..frontend.rectify import StereoRectifier
from ..tracking import tracker as trk
from ..utils.timing import GLOBAL_TIMER
from . import checkpoint
from . import settings as settings_mod
from . import trajectory


class System:
    MONOCULAR = "mono"
    STEREO = "stereo"
    RGBD = "rgbd"
    IMU_MONOCULAR = "mono-imu"
    IMU_STEREO = "stereo-imu"
    IMU_RGBD = "rgbd-imu"

    def __init__(self, settings_path: Optional[str] = None, sensor: str = "mono",
                 vocabulary=None, config: Optional[trk.TrackerConfig] = None,
                 atlas_path: Optional[str] = None, device=None):
        """settings_path: a reference-format YAML read for `sensor` ("mono",
        "stereo" or "rgbd", each also with "-imu"; the System ctor reads the
        settings file,
        `System.cc:70-85`), on `device` (default CUDA). Or config: a
        TrackerConfig, whose `sensor` the session runs (`sensor`, when not
        the default, must name the same one); the camera tensor's device is
        the session's, or `device` when the camera is not a tensor. A
        config, when given, is used and the settings file is not read, as
        in the JAX façade. vocabulary: a `place.vocab.Vocabulary`, which
        attaches the loop closer (relocalization, loop closing, map
        merging). atlas_path: a checkpoint (`save_atlas`, either package's)
        to resume from: its maps are loaded, tracking starts in a fresh
        map, and the keyframe database is rebuilt from the loaded
        keyframes, so the session relocalizes into and merges with them
        (`System.cc:171`, `Atlas::PostLoad`)."""
        self.rectifier = None
        self._resize_hw = None
        if config is None:
            if settings_path is None:
                raise ValueError("need settings_path or config")
            dev = device_mod.resolve(device)
            s = settings_mod.load_settings(settings_path, sensor)
            config = settings_mod.to_tracker_config(s, device=dev)
            if s.rect_left is not None and sensor.startswith("stereo"):
                # legacy EuRoC-style rectification: remap both images before
                # tracking (System::TrackStereo, System.cc:253-265)
                self.rectifier = StereoRectifier(s.rect_left, s.rect_right, s.width,
                                                 s.height, device=dev)
            if s.resize_wh is not None:
                self._resize_hw = (s.resize_wh[1], s.resize_wh[0])
        if sensor != self.MONOCULAR and sensor != config.sensor:
            raise ValueError(f"sensor {sensor!r} but the config's is {config.sensor!r}")
        self.tracker = trk.Tracker(config, device=device)
        self.vocabulary = vocabulary
        self._viewer = None
        self._last_img = None
        self._frame_lock = threading.RLock()  # frames and the viewer's commands
        if atlas_path is not None:
            from ..atlas import ops as atlas_ops

            state, _ = checkpoint.load_atlas(atlas_path, vocabulary, device=self.tracker.device)
            if state.fmax != self.tracker.map.fmax:
                raise ValueError(f"the atlas holds {state.fmax} features per keyframe, the "
                                 f"config extracts {self.tracker.map.fmax}")
            self.tracker.cfg.kmax, self.tracker.cfg.lmax = state.kmax, state.lmax
            self.tracker.map = atlas_ops.create_map(state)
        if vocabulary is not None:
            self.tracker.attach_loop_closer(vocabulary)
            if atlas_path is not None:
                self.tracker.loop_closer.rebuild_db(self.tracker.map)

    # ------------------------------------------------------------------
    def _expect(self, sensor: str, call: str, imu):
        if self.tracker.base_sensor != sensor:
            raise ValueError(f"{call} on a {self.tracker.base_sensor!r} session")
        if imu is not None and self.tracker.imu is None:
            raise ValueError(f"IMU measurements passed to a {self.tracker.cfg.sensor!r} session")

    def _resize(self, img):
        """Camera.newWidth/newHeight: a bilinear resize with half-pixel
        centres and no antialiasing (`jax.image.resize(..., "bilinear",
        antialias=False)` in the JAX façade)."""
        if self._resize_hw is None:
            return img
        t = torch.as_tensor(np.asarray(img) if not torch.is_tensor(img) else img,
                            dtype=torch.float32, device=self.tracker.device)
        return F.interpolate(t[None, None], size=self._resize_hw, mode="bilinear",
                             align_corners=False, antialias=False)[0, 0]

    def _track(self, img, timestamp, **inputs):
        with self._frame_lock:
            if self._viewer is not None:
                self._last_img = img  # the live viewer's frame view
            with GLOBAL_TIMER.stage("track.process_total"):
                self.tracker.process(img, timestamp, **inputs)
            with GLOBAL_TIMER.stage("track.pose_return"):
                return self.current_pose(settle=False)

    def track_monocular(self, img, timestamp: float, imu=None):
        """System::TrackMonocular (`System.cc:399`); imu: the [M, 7] rows
        (t, gx, gy, gz, ax, ay, az) measured since the previous frame, for
        an inertial session. Returns the frame's (R, t) Tcw as tensors on
        the session's device, or None before initialization."""
        self._expect(self.MONOCULAR, "track_monocular", imu)
        return self._track(self._resize(img), timestamp, imu=imu)

    def track_stereo(self, img_left, img_right, timestamp: float, imu=None):
        """System::TrackStereo (`System.cc:244`); returns as track_monocular
        does. A settings file with rectification blocks remaps the raw pair
        first (`System.cc:253-265`)."""
        self._expect(self.STEREO, "track_stereo", imu)
        if self.rectifier is not None:
            with GLOBAL_TIMER.stage("track.rectify"):
                img_left, img_right = self.rectifier(img_left, img_right)
        return self._track(self._resize(img_left), timestamp, img_right=self._resize(img_right),
                           imu=imu)

    def track_rgbd(self, img, depth, timestamp: float, imu=None):
        """System::TrackRGBD (`System.cc:328`): an image and its registered
        [H, W] depth map (scaled by the config's depth_factor); returns as
        track_monocular does."""
        self._expect(self.RGBD, "track_rgbd", imu)
        return self._track(self._resize(img), timestamp, depth_map=self._resize(depth), imu=imu)

    # ------------------------------------------------------------------
    def current_pose(self, settle: bool = True):
        """Latest Tcw estimate (R, t), or None before initialization: numpy
        arrays after consuming the frames in flight; or with settle=False,
        without waiting, the tensors themselves (no host copy): the newest
        in-flight frame's pose when one is in flight."""
        tr = self.tracker
        if settle:
            tr.settle()
        elif tr._pending is not None:
            out = tr._pending["out"]
            return out["R"], out["t"]
        last = tr.last
        if last is None:
            return None
        if not settle:
            return last["R"], last["t"]
        return last["R"].cpu().numpy(), last["t"].cpu().numpy()

    def tracking_state(self) -> int:
        """System::GetTrackingState (`System.h:160`), after the frames in
        flight."""
        self.tracker.settle()
        return self.tracker.state

    def is_lost(self) -> bool:
        return self.tracking_state() in (trk.RECENTLY_LOST, trk.LOST)

    def activate_localization_mode(self):
        """System::ActivateLocalizationMode (`System.cc:409`): tracking goes
        on, mapping stops (no keyframe, no change to the map)."""
        self.tracker.sync_mapping()
        self.tracker.mapping_paused = True

    def deactivate_localization_mode(self):
        self.tracker.mapping_paused = False

    @property
    def localization_only(self) -> bool:
        return self.tracker.mapping_paused

    def reset(self):
        """System::Reset: drop everything and start a fresh Atlas."""
        self.tracker.shutdown()
        self.tracker = trk.Tracker(self.tracker.cfg)
        if self.vocabulary is not None:
            self.tracker.attach_loop_closer(self.vocabulary)

    def change_dataset(self):
        """System::ChangeDataset: store the active map and restart tracking
        in a fresh one before the next frame."""
        if self.tracker.state != trk.NOT_INITIALIZED:
            self.tracker._timestamp_jump()

    # ------------------------------------------------------------------
    def save_trajectory_tum(self, path: str, time_offset: float = 0.0):
        """The frame trajectory in TUM format, `time_offset` added to every
        timestamp (a driver that tracked in seconds since its first frame
        writes the dataset's own times)."""
        ts, R, t, ok = self.tracker.poses()
        trajectory.save_tum(path, ts + time_offset, R, t, ok)

    def save_trajectory_euroc(self, path: str):
        """SaveTrajectoryEuRoC (`System.cc:662-882`): the camera frame, or
        for an inertial sensor the body frame Twb through Tbc (EuRoC's
        ground truth is in the IMU frame)."""
        ts, R, t, ok = self.tracker.poses()
        trajectory.save_euroc(path, ts, R, t, ok, Tbc=self._tbc())

    def _tbc(self):
        """The 4x4 camera-to-body extrinsics of an inertial sensor, else None."""
        imu = self.tracker.imu
        if imu is None:
            return None
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = imu.Rbc.cpu().numpy()
        T[:3, 3] = imu.tbc.cpu().numpy()
        return T

    def save_trajectory_kitti(self, path: str):
        ts, R, t, ok = self.tracker.poses()
        trajectory.save_kitti(path, ts, R, t, ok)

    def save_keyframe_trajectory_tum(self, path: str, time_offset: float = 0.0):
        """System::SaveKeyFrameTrajectoryTUM (`System.cc:884`)."""
        self.tracker.sync_mapping()
        s = self.tracker.map
        kv = s.kf_valid.cpu().numpy()
        trajectory.save_tum(path, s.kf_timestamp.cpu().numpy()[kv].astype(np.float64)
                            + time_offset,
                            s.kf_R.cpu().numpy()[kv], s.kf_t.cpu().numpy()[kv])

    def run_global_ba(self, num_iters: int = 10):
        """Synchronous full bundle adjustment of the active map
        (Optimizer::GlobalBundleAdjustemnt, `Optimizer.cc:52`). The tracker
        also starts one in a side thread after a loop correction."""
        from ..mapping.global_ba import GlobalBARunner

        tr = self.tracker
        tr.sync_mapping()
        runner = GlobalBARunner(tr.cfg.K, tr.cfg.kind, num_iters=num_iters)
        tr.map = runner.run(tr.map)
        tr._map_version += 1
        tr._mapper_stale = tr.async_mapper is not None

    def save_atlas(self, path: str):
        """System::SaveAtlas (`System.cc:1403`): every map and the
        vocabulary's checksum in one npz, after the mapper has drained (the
        map changes on the mapper's stream)."""
        self.tracker.sync_mapping()
        checkpoint.save_atlas(path, self.tracker.map, self.vocabulary)

    def save_map_3d(self, path: str):
        """The interactive 3D map (the MapDrawer / Viewer role,
        `MapDrawer.cc:135-447`): landmarks, keyframe frusta, the spanning
        tree and the trajectory in one self-contained HTML file."""
        from . import evaluate, viz

        self.tracker.sync_mapping()
        ts, R, t, ok = self.tracker.poses()
        traj = evaluate.camera_centers(R[ok], t[ok]) if ok.any() else None
        viz.save_map_html(path, self.tracker.map, traj)

    def save_debug_data(self, path: str):
        """System::SaveDebugData (`System.cc:1265-1318`): the inertial
        initialization and refinement history, one line per event
        (timestamp, event, scale applied, gravity, gyro and acc biases)."""
        with open(path, "w") as f:
            f.write("# ts event scale gx gy gz bgx bgy bgz bax bay baz\n")
            for e in self.tracker.debug_events:
                if "gravity" not in e:   # a bad-IMU reset carries no solution
                    continue
                g, bg, ba = e["gravity"], e["bg"], e["ba"]
                f.write(f"{e['ts']:.6f} {e['event']} {e['scale']:.6f} "
                        f"{g[0]:.4f} {g[1]:.4f} {g[2]:.4f} "
                        f"{bg[0]:.6f} {bg[1]:.6f} {bg[2]:.6f} "
                        f"{ba[0]:.6f} {ba[1]:.6f} {ba[2]:.6f}\n")

    def start_viewer(self, port: int = 8090, refresh_s: float = 1.0):
        """Start the live HTTP viewer on 127.0.0.1 (the Viewer thread's role,
        `Viewer.cc:162`; `api/viewer.py`); port 0 takes a free port, read
        it from the returned LiveViewer's `port`. `shutdown` stops it."""
        from .viewer import LiveViewer

        if self._viewer is not None:
            self._viewer.stop()
        self._viewer = LiveViewer(self, port=port, refresh_s=refresh_s)
        self._viewer.start()
        return self._viewer

    def shutdown(self):
        """System::Shutdown (`System.cc:515`): stop the live viewer, drain
        the background mapper, join or abort a running background global BA
        and fold a finished one into the map, stop the mapper thread."""
        if self._viewer is not None:
            self._viewer.stop()
            self._viewer = None
        tr = self.tracker
        tr.sync_mapping()
        m = tr.async_mapper
        gba = m.gba if m is not None and m.gba is not None else tr.gba
        if gba is not None and gba.running:
            gba.request_abort()
            gba.join(timeout=60.0)
        if gba is not None and gba.failed:
            raise RuntimeError("the background global BA failed") from gba.error
        if gba is not None and gba.finished:
            tr.map = gba.reconcile(tr.map)
            tr._map_version += 1
            tr._mapper_stale = m is not None
        if m is not None:
            m.gba = None
        tr.gba = None
        tr.shutdown()
