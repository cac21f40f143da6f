"""Dataset drivers and trajectory evaluation: the port's way in from disk.

    python -m orb_slam3_tpu_torch.drivers euroc    ROOT SETTINGS.yaml --sensor mono [...]
    python -m orb_slam3_tpu_torch.drivers tum_rgbd ROOT SETTINGS.yaml [...]
    python -m orb_slam3_tpu_torch.drivers kitti    ROOT SETTINGS.yaml --sequence 00 [...]
    python -m orb_slam3_tpu_torch.drivers tum_vi   ROOT TUM-VI.yaml --sensor stereo-imu [...]
    python -m orb_slam3_tpu_torch.drivers evaluate_ate GROUNDTRUTH ESTIMATE [--no-scale]

The example mains of the reference (`Examples/Monocular/mono_euroc.cc`,
`Stereo/stereo_euroc.cc`, `Monocular-Inertial/mono_inertial_euroc.cc`,
`RGB-D/rgbd_tum.cc`, `Stereo/stereo_kitti.cc`, the TUM-VI mains and
`evaluation/evaluate_ate_scale.py`), as the JAX package's
`examples/run_*.py` and `examples/evaluate_ate.py` run them: enumerate the
dataset (`api/datasets`), decode ahead on worker threads
(`utils/frameloader`), track through `api/system.System` built from the
settings file, then write the trajectory, and optionally the keyframe
trajectory and the Atlas. `--atlas-in` resumes from a saved Atlas.
Everything runs on CUDA unless `--device cpu`.

The session is fed seconds since the sequence's first frame (its IMU rows
too), and the trajectory files get the dataset's own times back: the map
keeps timestamps in float32 (the JAX package's MapState), which cannot tell
apart two keyframes a frame apart at EuRoC's absolute times (~1.4e9 s,
steps of 128 s).

Each `run_*` function is the driver as a call: it returns a dict with the
(shut down) System, the frame count, the frames per second of the tracking
loop, and the size and time of the Atlas save when one was asked for.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

from .api import datasets, evaluate, trajectory
from .api.system import System
from .utils.frameloader import FrameLoader
from .utils.timing import GLOBAL_TIMER


def _system(settings_yaml, sensor, device, vocab_path, atlas_in):
    voc = None
    if vocab_path:
        from .place import vocab as vocab_mod

        voc = vocab_mod.load_orb_text(vocab_path, device=device)
    return System(settings_yaml, sensor=sensor, vocabulary=voc, atlas_path=atlas_in,
                  device=device)


def _finish(slam, n, wall, origin, out, out_format, kf_out, atlas_out, log):
    """Write the outputs (at the dataset's times), stop the session, and
    report."""
    res = dict(system=slam, frames=n, seconds=wall, fps=n / wall if wall > 0 else 0.0,
               time_origin=origin)
    if out:
        if out_format == "kitti":  # KITTI's format has no timestamps
            slam.save_trajectory_kitti(out)
        else:
            slam.save_trajectory_tum(out, time_offset=origin)
    if kf_out:
        slam.save_keyframe_trajectory_tum(kf_out, time_offset=origin)
    if atlas_out:
        t0 = time.perf_counter()
        slam.save_atlas(atlas_out)
        res["save_atlas_ms"] = 1e3 * (time.perf_counter() - t0)
        res["save_atlas_bytes"] = os.path.getsize(atlas_out)
    slam.shutdown()
    log(f"{n} frames in {wall:.2f} s: {res['fps']:.1f} fps (decoder: {FrameLoader.decoder})")
    return res


def _play(slam, frames, stereo, use_imu, log, every=50, depth=False):
    """Track every frame, decoding ahead, in seconds since the first frame;
    returns (the loop's wall seconds, the first frame's timestamp)."""
    origin = frames[0].timestamp if frames else 0.0
    loader = FrameLoader([f.img_path for f in frames])
    loader_r = FrameLoader([f.img_right_path for f in frames]) if stereo else None
    t0 = time.perf_counter()
    try:
        for i, (fr, img) in enumerate(zip(frames, loader)):
            ts = fr.timestamp - origin
            imu = None
            if use_imu:
                imu = fr.imu.copy()
                imu[:, 0] -= origin
            with GLOBAL_TIMER.stage("frame_total"):
                if stereo:
                    slam.track_stereo(img, next(loader_r), ts, imu=imu)
                elif depth:
                    slam.track_rgbd(img, datasets.read_depth(fr.depth_path), ts)
                else:
                    slam.track_monocular(img, ts, imu=imu)
            if every and i % every == 0:
                log(f"frame {i}  state={slam.tracking_state()}  "
                    f"kf={int(slam.tracker.map.n_kf)}")
        slam.tracking_state()  # the frames in flight
    finally:
        loader.close()
        if loader_r is not None:
            loader_r.close()
    return time.perf_counter() - t0, origin


def run_euroc(dataset_root, settings_yaml, sensor="mono", out=None, kf_out=None,
              atlas_out=None, atlas_in=None, vocab=None, max_frames=None, device=None,
              log=print, enumerate_fn=None):
    """The EuRoC driver (`examples/run_euroc.py`): sensor mono, stereo,
    mono-imu or stereo-imu; the trajectory in TUM format."""
    use_imu = sensor.endswith("-imu")
    stereo = sensor.startswith("stereo")
    frames = (enumerate_fn or datasets.load_euroc)(dataset_root, with_imu=use_imu,
                                                   stereo=stereo)
    if max_frames:
        frames = frames[:max_frames]
    log(f"{len(frames)} frames")
    slam = _system(settings_yaml, sensor, device, vocab, atlas_in)
    wall, origin = _play(slam, frames, stereo, use_imu, log)
    return _finish(slam, len(frames), wall, origin, out, "tum", kf_out, atlas_out, log)


def run_tum_vi(dataset_root, settings_yaml, sensor="mono", **kw):
    """The TUM-VI driver (`examples/run_tum_vi.py`): the EuRoC layout with a
    KB8 settings file."""
    return run_euroc(dataset_root, settings_yaml, sensor, enumerate_fn=datasets.load_tum_vi,
                     **kw)


def run_tum_rgbd(dataset_root, settings_yaml, out=None, kf_out=None, atlas_out=None,
                 atlas_in=None, vocab=None, max_frames=None, device=None, log=print):
    """The TUM RGB-D driver (`examples/run_tum_rgbd.py`). The depth map goes
    in as stored; the tracker scales it by the settings' DepthMapFactor."""
    frames = datasets.load_tum_rgbd(dataset_root)
    if max_frames:
        frames = frames[:max_frames]
    log(f"{len(frames)} frames")
    slam = _system(settings_yaml, "rgbd", device, vocab, atlas_in)
    wall, origin = _play(slam, frames, False, False, log, depth=True)
    return _finish(slam, len(frames), wall, origin, out, "tum", kf_out, atlas_out, log)


def run_kitti(dataset_root, settings_yaml, sequence="00", sensor="stereo", out=None,
              kf_out=None, atlas_out=None, atlas_in=None, vocab=None, max_frames=None,
              device=None, log=print):
    """The KITTI odometry driver (`examples/run_kitti.py`); the trajectory in
    KITTI format."""
    stereo = sensor == "stereo"
    frames = datasets.load_kitti(dataset_root, sequence, stereo)
    if max_frames:
        frames = frames[:max_frames]
    log(f"{len(frames)} frames")
    slam = _system(settings_yaml, sensor, device, vocab, atlas_in)
    wall, origin = _play(slam, frames, stereo, False, log, every=100)
    return _finish(slam, len(frames), wall, origin, out, "kitti", kf_out, atlas_out, log)


def evaluate_ate(groundtruth, estimate, with_scale=True, max_dt=0.02):
    """RMS absolute trajectory error of two TUM files after Horn alignment
    (with the optimal scale for monocular runs): (rmse, matched, scale)."""
    gt_ts, gt_pos, _ = trajectory.load_tum(groundtruth)
    est_ts, est_pos, _ = trajectory.load_tum(estimate)
    return evaluate.ate_rmse(est_ts, est_pos, gt_ts, gt_pos, with_scale=with_scale,
                             max_dt=max_dt)


def _common(p, sensors=None, default=None):
    p.add_argument("dataset_root")
    p.add_argument("settings_yaml")
    if sensors:
        p.add_argument("--sensor", default=default, choices=sensors)
    p.add_argument("--out", default="trajectory.txt")
    p.add_argument("--kf-out", default=None)
    p.add_argument("--atlas-out", default=None)
    p.add_argument("--atlas-in", default=None, help="resume from a saved Atlas")
    p.add_argument("--vocab", default=None, help="an ORB vocabulary in the reference's text format")
    p.add_argument("--max-frames", type=int, default=None)
    p.add_argument("--device", default=None, help="cuda (default) or cpu")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m orb_slam3_tpu_torch.drivers")
    sub = ap.add_subparsers(dest="cmd", required=True)
    inertial = ["mono", "stereo", "mono-imu", "stereo-imu"]
    _common(sub.add_parser("euroc", help="EuRoC ASL"), inertial, "mono")
    _common(sub.add_parser("tum_vi", help="TUM-VI (EuRoC layout, KB8)"), inertial, "mono")
    _common(sub.add_parser("tum_rgbd", help="TUM RGB-D"))
    p = sub.add_parser("kitti", help="KITTI odometry")
    _common(p, ["mono", "stereo"], "stereo")
    p.add_argument("--sequence", default="00")
    p = sub.add_parser("evaluate_ate", help="RMS ATE of a TUM trajectory")
    p.add_argument("groundtruth")
    p.add_argument("estimate")
    p.add_argument("--no-scale", action="store_true")
    p.add_argument("--max-dt", type=float, default=0.02)
    a = ap.parse_args(argv)
    if a.cmd == "evaluate_ate":
        rmse, n, s = evaluate_ate(a.groundtruth, a.estimate, not a.no_scale, a.max_dt)
        print(f"absolute_translational_error.rmse {rmse:.6f} m")
        print(f"matched_pairs {n}")
        print(f"scale {s:.6f}")
        return 0
    kw = dict(out=a.out, kf_out=a.kf_out, atlas_out=a.atlas_out, atlas_in=a.atlas_in,
              vocab=a.vocab, max_frames=a.max_frames, device=a.device)
    if a.cmd == "euroc":
        run_euroc(a.dataset_root, a.settings_yaml, a.sensor, **kw)
    elif a.cmd == "tum_vi":
        run_tum_vi(a.dataset_root, a.settings_yaml, a.sensor, **kw)
    elif a.cmd == "tum_rgbd":
        run_tum_rgbd(a.dataset_root, a.settings_yaml, **kw)
    else:
        run_kitti(a.dataset_root, a.settings_yaml, a.sequence, a.sensor, **kw)
    print(GLOBAL_TIMER.print_stats())
    return 0


if __name__ == "__main__":
    sys.exit(main())
