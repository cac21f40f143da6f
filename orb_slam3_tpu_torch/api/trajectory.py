"""Trajectory export in TUM / EuRoC / KITTI formats (the port's numpy copy
of orb_slam3_tpu/api/trajectory.py).

Role of `System::SaveTrajectoryTUM/EuRoC/KITTI` and the keyframe variant
(`System.cc:569-1262`), written as:
- TUM:   `timestamp tx ty tz qx qy qz qw` (camera-to-world)
- EuRoC: the same fields, timestamp in nanoseconds
- KITTI: 12 numbers per line (3x4 camera-to-world matrix, row-major)
"""

from __future__ import annotations

import numpy as np


def rot_to_quat(R):
    """[..., 3, 3] -> quaternion [..., 4] (x, y, z, w), w >= 0, from the
    best conditioned of the four constructions (lie.rot_to_quat of the
    JAX package, in numpy)."""
    R = np.asarray(R, np.float64)
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    qw0 = np.sqrt(np.clip(1.0 + tr, 1e-12, None)) * 0.5
    q0 = np.stack([(m21 - m12) / (4 * qw0), (m02 - m20) / (4 * qw0),
                   (m10 - m01) / (4 * qw0), qw0], axis=-1)
    qx1 = np.sqrt(np.clip(1.0 + m00 - m11 - m22, 1e-12, None)) * 0.5
    q1 = np.stack([qx1, (m01 + m10) / (4 * qx1), (m02 + m20) / (4 * qx1),
                   (m21 - m12) / (4 * qx1)], axis=-1)
    qy2 = np.sqrt(np.clip(1.0 - m00 + m11 - m22, 1e-12, None)) * 0.5
    q2 = np.stack([(m01 + m10) / (4 * qy2), qy2, (m12 + m21) / (4 * qy2),
                   (m02 - m20) / (4 * qy2)], axis=-1)
    qz3 = np.sqrt(np.clip(1.0 - m00 - m11 + m22, 1e-12, None)) * 0.5
    q3 = np.stack([(m02 + m20) / (4 * qz3), (m12 + m21) / (4 * qz3), qz3,
                   (m10 - m01) / (4 * qz3)], axis=-1)
    k = np.argmax(np.stack([tr, m00, m11, m22], axis=-1), axis=-1)
    qs = np.stack([q0, q1, q2, q3], axis=-2)
    q = np.take_along_axis(qs, k[..., None, None] * np.ones_like(qs[..., :1, :], dtype=k.dtype),
                           axis=-2)[..., 0, :]
    q = q / np.linalg.norm(q, axis=-1, keepdims=True)
    return q * np.where(q[..., 3:4] < 0, -1.0, 1.0)


def _twc(R_cw, t_cw, Tbc=None):
    """Tcw -> (R_wc, t_wc = camera centre). With Tbc (camera-to-body, X_b =
    Rbc X_c + tbc) the body poses Twb = (Tbc Tcw)^-1 instead, as
    SaveTrajectoryEuRoC exports an inertial sensor's (System.cc:662-882)."""
    R_cw, t_cw = np.asarray(R_cw), np.asarray(t_cw)
    if Tbc is not None:
        Tbc = np.asarray(Tbc)
        Rbc, tbc = Tbc[:3, :3], Tbc[:3, 3]
        R_cw, t_cw = (np.einsum("ij,njk->nik", Rbc, R_cw),
                      np.einsum("ij,nj->ni", Rbc, t_cw) + tbc)
    R_wc = np.swapaxes(R_cw, -1, -2)
    t_wc = -np.einsum("nij,ni->nj", R_cw, t_cw)
    return R_wc, t_wc


def save_tum(path: str, ts, R_cw, t_cw, ok=None) -> None:
    """TUM RGB-D format (SaveTrajectoryTUM, System.cc:569-660)."""
    R_wc, c = _twc(R_cw, t_cw)
    q = rot_to_quat(R_wc)
    with open(path, "w") as f:
        for i in range(len(ts)):
            if ok is not None and not ok[i]:
                continue
            f.write(
                f"{ts[i]:.6f} {c[i,0]:.7f} {c[i,1]:.7f} {c[i,2]:.7f} "
                f"{q[i,0]:.7f} {q[i,1]:.7f} {q[i,2]:.7f} {q[i,3]:.7f}\n"
            )


def save_euroc(path: str, ts, R_cw, t_cw, ok=None, Tbc=None) -> None:
    """EuRoC format: nanosecond timestamps (SaveTrajectoryEuRoC,
    System.cc:662-882); with Tbc the IMU body frame, as the reference
    exports an inertial sensor's."""
    R_wc, c = _twc(R_cw, t_cw, Tbc)
    q = rot_to_quat(R_wc)
    with open(path, "w") as f:
        for i in range(len(ts)):
            if ok is not None and not ok[i]:
                continue
            f.write(
                f"{int(ts[i]*1e9)} {c[i,0]:.7f} {c[i,1]:.7f} {c[i,2]:.7f} "
                f"{q[i,0]:.7f} {q[i,1]:.7f} {q[i,2]:.7f} {q[i,3]:.7f}\n"
            )


def save_kitti(path: str, ts, R_cw, t_cw, ok=None) -> None:
    """KITTI format: row-major 3x4 Twc per line (SaveTrajectoryKITTI,
    System.cc:1190-1262)."""
    R_wc, c = _twc(R_cw, t_cw)
    with open(path, "w") as f:
        for i in range(len(ts)):
            if ok is not None and not ok[i]:
                continue
            T = np.concatenate([R_wc[i], c[i][:, None]], axis=1).reshape(-1)
            f.write(" ".join(f"{x:.9e}" for x in T) + "\n")


def load_tum(path: str):
    """Read a TUM trajectory / ground-truth file -> (ts, positions, quats)."""
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.replace(",", " ").split()
            rows.append([float(x) for x in parts[:8]])
    arr = np.array(rows)
    return arr[:, 0], arr[:, 1:4], arr[:, 4:8]
