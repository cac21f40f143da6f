"""Trajectory evaluation: RMS ATE after Horn alignment with optimal scale
(the port's numpy copy of orb_slam3_tpu/api/evaluate.py).

Same semantics as the reference's evaluation tooling
(`evaluation/evaluate_ate_scale.py`): associate by
timestamp, align model->ground-truth with the closed-form Horn method plus
the optimal similarity scale (for monocular), report RMS of the aligned
translational error.
"""

from __future__ import annotations

import numpy as np


def horn_align(model: np.ndarray, data: np.ndarray, with_scale: bool = True):
    """model/data: [3, N] matched positions. Returns (R, t, s, trans_error)
    such that s*R@model + t ~= data (evaluate_ate_scale.py::align)."""
    mu_m = model.mean(axis=1, keepdims=True)
    mu_d = data.mean(axis=1, keepdims=True)
    mz = model - mu_m
    dz = data - mu_d
    W = np.zeros((3, 3))
    for i in range(model.shape[1]):
        W += np.outer(dz[:, i], mz[:, i])
    U, d, Vt = np.linalg.svd(W.transpose())
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    rot_mz = R @ mz
    if with_scale:
        dots = float(np.sum(dz * rot_mz))
        norms = float(np.sum(mz * mz))
        s = dots / max(norms, 1e-12)
    else:
        s = 1.0
    t = mu_d - s * R @ mu_m
    aligned = s * R @ model + t
    err = np.linalg.norm(aligned - data, axis=0)
    return R, t, s, err


def ate_rmse(est_ts, est_pos, gt_ts, gt_pos, with_scale=True,
             max_dt: float = 0.02):
    """Associate by nearest timestamp (within max_dt) then Horn-align.

    est_pos/gt_pos: [N, 3] camera centers. Returns (rmse, n_matched, scale).
    """
    j = np.searchsorted(gt_ts, est_ts)
    j = np.clip(j, 0, len(gt_ts) - 1)
    j_prev = np.clip(j - 1, 0, len(gt_ts) - 1)
    pick = np.where(
        np.abs(gt_ts[j_prev] - est_ts) < np.abs(gt_ts[j] - est_ts), j_prev, j
    )
    ok = np.abs(gt_ts[pick] - est_ts) <= max_dt
    if ok.sum() < 3:
        return np.inf, int(ok.sum()), 1.0
    model = est_pos[ok].T
    data = gt_pos[pick[ok]].T
    _, _, s, err = horn_align(model, data, with_scale)
    return float(np.sqrt(np.mean(err**2))), int(ok.sum()), float(s)


def camera_centers(R_cw: np.ndarray, t_cw: np.ndarray) -> np.ndarray:
    """Tcw arrays -> camera centers Ow = -R^T t, [N, 3]."""
    return -np.einsum("nij,ni->nj", R_cw, t_cw)
