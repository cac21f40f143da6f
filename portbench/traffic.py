"""The one traffic generator: a closed lap of camera poses, and the
settings-file values the renderer needs.

A traffic file (`traffic/<name>.json`) gives the lap as parameters:

- `fps`, `lap_frames`: the camera rate and the frames of one lap;
- `path`: the camera centre `centre + radius (sin a, 0, cos a)` with
  `a = 2 pi turns s` over the lap phase s in [0, 1), plus `position_terms`
  (`axis` 0-2, `amp` metres, harmonic `k`, `phase` radians); the heading
  `look` "outward" (along a) or "fixed", plus `yaw_deg` and `angle_terms`
  (`angle` yaw, pitch or roll, `amp_deg`, `k`, `phase`). Every term is a
  whole harmonic of the lap, so the lap closes;
- `scene`: the room (its texture and panel `seed`, size and panels) and
  the exposure jitter and noise. The room and the lap are fixed by the
  file, so every run does the same work; `--seed` draws the photometric
  noise;
- `warmup_frames`, `profile_frames`, `profile_at` (a share of the window),
  `vocabulary_views`: the harness's use of the lap;
- `target`: the published mean speed and rotation rate the lap is made to
  match (checked by the tests).

World frame: y points down (the room's floor is at y = +wall_h). Rotations
are R_wc = Ry(yaw) Rx(pitch) Rz(roll) on the camera axes (x right, y down,
z forward).
"""

from __future__ import annotations

import json
import re
from pathlib import Path

import numpy as np


def load(path) -> dict:
    with open(path) as f:
        return json.load(f)


# ---------------------------------------------------------------------------
# settings files: the few keys the renderer reads
# ---------------------------------------------------------------------------

_KEY = re.compile(r"^([A-Za-z_][\w.]*)\s*:(.*)$")


def read_settings(path) -> dict:
    """Top-level scalars and `!!opencv-matrix` data lists of an upstream
    ORB-SLAM3 settings file, as {key: float | str | list}."""
    out, key = {}, None
    text = Path(path).read_text()
    for line in text.splitlines():
        line = re.sub(r"(^|\s)#.*$", "", line).rstrip()
        if not line.strip() or line.startswith("%"):
            continue
        m = _KEY.match(line)
        if m and not line[0].isspace():
            key, val = m.group(1), m.group(2).replace("!!opencv-matrix", "").strip()
            out[key] = _scalar(val) if val else {}
        elif key is not None and isinstance(out[key], dict):
            out[key].setdefault("_text", []).append(line.strip())
    for k, v in list(out.items()):
        if isinstance(v, dict):
            body = " ".join(v.get("_text", []))
            data = re.search(r"data:\s*\[([^\]]*)\]", body)
            out[k] = [float(x) for x in data.group(1).split(",")] if data else None
    return out


def _scalar(tok: str):
    tok = tok.strip()
    if len(tok) >= 2 and tok[0] == tok[-1] and tok[0] in "\"'":
        return tok[1:-1]
    try:
        return float(tok)
    except ValueError:
        return tok


class Camera:
    """The camera and depth values of a settings file. Only a pinhole
    camera with rad-tan distortion is rendered (`scene.radtan_rays`)."""

    def __init__(self, s: dict):
        if s.get("Camera.type") != "PinHole":
            raise ValueError(f"Camera.type {s.get('Camera.type')!r}: the renderer draws only "
                             "a PinHole camera with rad-tan distortion")
        self.K = tuple(float(s[f"Camera1.{k}"]) for k in ("fx", "fy", "cx", "cy"))
        self.D = tuple(float(s.get(f"Camera1.{k}", 0.0)) for k in ("k1", "k2", "p1", "p2", "k3"))
        self.wh = (int(s["Camera.width"]), int(s["Camera.height"]))
        self.fps = float(s["Camera.fps"])
        self.depth_factor = float(s["RGBD.DepthMapFactor"]) if "RGBD.DepthMapFactor" in s else None


# ---------------------------------------------------------------------------
# the lap
# ---------------------------------------------------------------------------

def _rot(axis: int, a):
    c, s = np.cos(a), np.sin(a)
    if axis == 0:
        return np.array([[1, 0, 0], [0, c, -s], [0, s, c]])
    if axis == 1:
        return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])


class Lap:
    """The closed lap of a traffic file."""

    def __init__(self, traffic: dict):
        self.t = traffic
        self.fps = float(traffic["fps"])
        self.n = int(traffic["lap_frames"])
        self.period = self.n / self.fps

    def pose_wc(self, s):
        """(R_wc [3, 3], centre [3]) at lap phase s (any real: periodic)."""
        p = self.t["path"]
        a = 2 * np.pi * float(p.get("turns", 0)) * s
        r = float(p.get("radius", 0.0))
        c = np.array(p.get("centre", [0.0, 0.0, 0.0]), np.float64) + r * np.array(
            [np.sin(a), 0.0, np.cos(a)])
        for term in p.get("position_terms", ()):
            c[int(term["axis"])] += term["amp"] * np.sin(2 * np.pi * term["k"] * s
                                                         + term.get("phase", 0.0))
        ang = {"yaw": np.deg2rad(p.get("yaw_deg", 0.0)) + (a if p["look"] == "outward" else 0.0),
               "pitch": 0.0, "roll": 0.0}
        for term in p.get("angle_terms", ()):
            ang[term["angle"]] += np.deg2rad(term["amp_deg"]) * np.sin(
                2 * np.pi * term["k"] * s + term.get("phase", 0.0))
        return _rot(1, ang["yaw"]) @ _rot(0, ang["pitch"]) @ _rot(2, ang["roll"]), c

    def frames(self):
        """(R_cw [N, 3, 3], t_cw [N, 3]) of the lap's frames (frame j at
        phase j / N)."""
        Rs, ts = [], []
        for j in range(self.n):
            R_wc, c = self.pose_wc(j / self.n)
            Rs.append(R_wc.T)
            ts.append(-R_wc.T @ c)
        return np.stack(Rs), np.stack(ts)

    def mean_rates(self, sub: int = 20):
        """(mean speed m/s, mean rotation rate deg/s) over the lap."""
        m = self.n * sub
        dist = ang = 0.0
        R0, c0 = self.pose_wc(0.0)
        for i in range(1, m + 1):
            R1, c1 = self.pose_wc(i / m)
            dist += np.linalg.norm(c1 - c0)
            ang += np.linalg.norm(so3_log(R0.T @ R1))
            R0, c0 = R1, c1
        return dist / self.period, np.rad2deg(ang) / self.period


def so3_log(R):
    """Rotation [3, 3] -> axis-angle [3]."""
    c = np.clip((np.trace(R) - 1.0) / 2.0, -1.0, 1.0)
    th = np.arccos(c)
    v = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    if th < 1e-8:
        return 0.5 * v
    return th / (2.0 * np.sin(th)) * v
