"""The comparison that decides `correct`: what the timed session produced
against the benchmark's own ground truth, in plain numpy.

Horn alignment is a frozen copy of `orb_slam3_tpu_torch/api/evaluate.
horn_align` at commit 356070c, with one repair: the copy there sums
outer(data, model) where the reference's evaluate_ate_scale.py sums
outer(model, data), and so returns the transposed rotation; here the sum is
the reference's.
Nothing here imports the program: the session's trajectory and map are
handed in as numpy arrays read after the window, and the truth comes from
the lap and the room the benchmark generated.

Numbers compared (each against `limits/<cell>.json`, lower is better):

- `lost_share`: frames after the session's first pose that it records as
  lost, over those frames;
- `ate_m`: RMS of the tracked frames' camera centres against the lap's,
  after Horn alignment (rigid for a depth sensor, with scale for a
  monocular one);
- `map_median_m`: the median distance of the active map's landmarks, under
  the same alignment, to the nearest surface of the room.
"""

from __future__ import annotations

import numpy as np


def horn_align(model: np.ndarray, data: np.ndarray, with_scale: bool = True):
    """model / data: [3, N] matched positions. Returns (R, t, s, errors)
    with s R model + t ~= data."""
    mu_m = model.mean(axis=1, keepdims=True)
    mu_d = data.mean(axis=1, keepdims=True)
    mz, dz = model - mu_m, data - mu_d
    W = mz @ dz.T  # sum of outer(model_i, data_i), as evaluate_ate_scale.py
    U, _, Vt = np.linalg.svd(W.T)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    rot_mz = R @ mz
    s = float(np.sum(dz * rot_mz)) / max(float(np.sum(mz * mz)), 1e-12) if with_scale else 1.0
    t = mu_d - s * R @ mu_m
    err = np.linalg.norm(s * R @ model + t - data, axis=0)
    return R, t, s, err


def lost_after_first_pose(ok) -> tuple[int, int]:
    """(frames recorded as lost after the session's first pose, frames from
    that pose on); (0, 0) when no frame has a pose."""
    first = np.flatnonzero(ok)
    if not len(first):
        return 0, 0
    return int((~ok[first[0]:]).sum()), len(ok) - int(first[0])


def judge(out: dict, truth: dict, room, monocular: bool) -> dict:
    """Readings of one session. out: ts [N], R_cw [N,3,3], t_cw [N,3], ok [N]
    (the session's trajectory), landmarks [L, 3] (its active map). truth:
    {timestamp: camera centre [3]} of every frame handed in."""
    ts, R, t, ok = out["ts"], out["R_cw"], out["t_cw"], out["ok"]
    n_lost, after = lost_after_first_pose(ok)
    readings = {"lost_share": n_lost / max(after, 1) if after else 1.0}
    keep = [i for i in range(len(ts)) if ok[i] and float(ts[i]) in truth]
    if len(keep) < 3:
        readings["ate_m"] = readings["map_median_m"] = float("inf")
        return readings
    est = -np.einsum("nji,nj->ni", R[keep], t[keep])  # Ow = -R^T t
    gt = np.stack([truth[float(ts[i])] for i in keep])
    Ra, ta, s, err = horn_align(est.T, gt.T, with_scale=monocular)
    readings["ate_m"] = float(np.sqrt(np.mean(err ** 2)))
    readings["ate_max_m"] = float(err.max())
    step = s * Ra @ np.diff(est, axis=0).T - np.diff(gt, axis=0).T
    readings["rpe_m"] = float(np.sqrt(np.mean(np.sum(step ** 2, axis=0))))
    lms = out["landmarks"]
    if len(lms):
        d = room.surface_distance((s * Ra @ lms.T + ta).T)
        readings["map_median_m"] = float(np.median(d))
        readings["map_p90_m"] = float(np.percentile(d, 90))
    else:
        readings["map_median_m"] = readings["map_p90_m"] = float("inf")
    return readings


def compare(readings: dict, limits: dict) -> tuple[bool, dict]:
    """(every reading at or under its limit, {name: {value, limit}})."""
    vals = {k: float(readings.get(k, float("inf"))) for k in limits}
    ok = all(np.isfinite(vals[k]) and vals[k] <= float(v) for k, v in limits.items())
    # a reading that could not be made (no pose, no landmark) prints as null
    checks = {k: {"value": vals[k] if np.isfinite(vals[k]) else None, "limit": float(v)}
              for k, v in limits.items()}
    return ok, checks
