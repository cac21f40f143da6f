"""Dataset enumerators: EuRoC ASL, TUM RGB-D, TUM-VI, KITTI odometry (port
of orb_slam3_tpu/api/datasets.py).

The example mains' loaders (`Examples/Monocular/mono_euroc.cc` LoadImages,
`Examples/RGB-D/rgbd_tum.cc` with `associate.py`,
`Examples/Stereo/stereo_kitti.cc`, `mono_inertial_euroc.cc` LoadIMU):
(timestamp, image path[, right path, depth path, IMU rows]) streams from
the datasets' folder layouts. Images are decoded later, by `read_image` /
`read_depth` or `utils/frameloader.FrameLoader`, with the port's PNG codec.
"""

from __future__ import annotations

import csv
import dataclasses
import os
from typing import Optional

import numpy as np

from ..utils import png


@dataclasses.dataclass
class FrameData:
    timestamp: float
    img_path: str
    img_right_path: Optional[str] = None
    depth_path: Optional[str] = None
    imu: Optional[np.ndarray] = None  # [M, 7]: t, gx, gy, gz, ax, ay, az


def read_image(path: str) -> np.ndarray:
    """An image as float32 grey (cv2.IMREAD_GRAYSCALE); FileNotFoundError
    when the file is missing."""
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    return png.read_gray(path).astype(np.float32)


def read_depth(path: str) -> np.ndarray:
    """A depth map's raw samples as float32 (cv2.IMREAD_UNCHANGED): TUM
    RGB-D stores 16-bit PNG, 5000 per metre; the tracker scales it by its
    config's depth_factor."""
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    return png.read(path).astype(np.float32)


def load_euroc(root: str, with_imu: bool = False, stereo: bool = False):
    """EuRoC ASL layout: mav0/cam0/data.csv with data/<ts>.png (and cam1 for
    stereo), mav0/imu0/data.csv. Each frame carries the IMU rows measured
    since the previous frame (the reference's vImuMeas, `System.cc:311`)."""
    cam0 = os.path.join(root, "mav0", "cam0")
    frames = []
    with open(os.path.join(cam0, "data.csv")) as f:
        for row in csv.reader(f):
            if row[0].startswith("#"):
                continue
            name = row[1].strip()
            frames.append(FrameData(
                timestamp=int(row[0]) * 1e-9,
                img_path=os.path.join(cam0, "data", name),
                img_right_path=(os.path.join(root, "mav0", "cam1", "data", name)
                                if stereo else None)))
    if with_imu:
        imu_rows = []
        with open(os.path.join(root, "mav0", "imu0", "data.csv")) as f:
            for row in csv.reader(f):
                if row[0].startswith("#"):
                    continue
                imu_rows.append([int(row[0]) * 1e-9] + [float(x) for x in row[1:7]])
        imu = np.array(imu_rows)
        j = 0
        for fr in frames:
            lo = j
            while j < len(imu) and imu[j, 0] <= fr.timestamp:
                j += 1
            fr.imu = imu[lo:j]
    return frames


def load_tum_rgbd(root: str, max_dt: float = 0.02):
    """TUM RGB-D layout: rgb.txt and depth.txt, each colour frame paired
    with the nearest depth frame within max_dt (associate.py)."""

    def read_list(name):
        entries = []
        with open(os.path.join(root, name)) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                ts, path = line.split()[:2]
                entries.append((float(ts), os.path.join(root, path)))
        return entries

    rgb = read_list("rgb.txt")
    depth = read_list("depth.txt")
    dts = np.array([d[0] for d in depth])
    frames = []
    for ts, path in rgb:
        j = int(np.argmin(np.abs(dts - ts)))
        if abs(dts[j] - ts) <= max_dt:
            frames.append(FrameData(timestamp=ts, img_path=path, depth_path=depth[j][1]))
    return frames


def load_kitti(root: str, sequence: str = "00", stereo: bool = True):
    """KITTI odometry layout: sequences/<seq>/image_0, image_1, times.txt."""
    seq = os.path.join(root, "sequences", sequence)
    with open(os.path.join(seq, "times.txt")) as f:
        times = [float(x) for x in f.read().split()]
    return [FrameData(timestamp=ts, img_path=os.path.join(seq, "image_0", f"{i:06d}.png"),
                      img_right_path=(os.path.join(seq, "image_1", f"{i:06d}.png")
                                      if stereo else None))
            for i, ts in enumerate(times)]


def load_tum_vi(root: str, with_imu: bool = False, stereo: bool = False):
    """TUM-VI (512x512 fisheye): its "Euroc / DSO 512x512" release has the
    EuRoC mav0/ layout, so this is load_euroc (`mono_inertial_tum_vi.cc`,
    `stereo_inertial_tum_vi.cc`); use it with a KB8 settings file."""
    return load_euroc(root, with_imu=with_imu, stereo=stereo)
