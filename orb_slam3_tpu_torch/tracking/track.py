"""Per-frame tracking: motion-only pose optimisation and local-map matching
(port of the slice-1 subset of orb_slam3_tpu/tracking/track.py).

- `pose_optimize` / `pose_optimize_stereo`: motion-only BA with staged
  outlier gating (Optimizer::PoseOptimization, `Optimizer.cc:814-1113`;
  3 rounds x 6 iterations). For the pinhole camera they run kernel K2
  (pose_kernel.py) on CUDA tensors and its plain version on CPU tensors.
- `match_local_map`: frustum cull and projection of the local-map snapshot,
  then the windowed descriptor search (SearchLocalPoints,
  `Tracking.cc:2949-3061,3343`), which runs kernel K1 on CUDA tensors.
"""

from __future__ import annotations

import torch

from ..frontend import camera as cam
from ..frontend import matching
from ..ops import lie
from . import pose_kernel


def _project_points(kind, K, R, t, X):
    Xc = lie.se3_apply(R, t, X)
    return cam.project(kind, K, Xc), Xc[..., 2]


def _no_kernel(kind):
    # The JAX package has no kernel for the KB8 fisheye camera either
    # (track.py:48): its pose BA is plain XLA ops there and will be plain
    # torch ops on the card here, with the fisheye slice that ports KB8.
    raise NotImplementedError(
        f"pose BA for camera kind {kind}: only PINHOLE is ported so far"
    )


def pose_optimize(kind: int, K, R0, t0, uv, Xw, inv_sigma2, valid,
                  rounds: int = 3, iters: int = 6):
    """Motion-only BA with staged outlier gating. R0/t0: initial Tcw; uv
    [N,2] observations of world points Xw [N,3]; inv_sigma2 [N]; valid [N].
    Returns (R, t, inlier_mask [N], n_inliers)."""
    if kind != cam.PINHOLE:
        _no_kernel(kind)
    R, t, inl, n = pose_kernel.pose_ba(
        K[None, :4].contiguous(), R0[None], t0[None], uv[None], Xw[None],
        inv_sigma2[None], valid[None], rounds=rounds, iters=iters,
    )
    return R[0], t[0], inl[0], n[0]


def pose_optimize_stereo(kind: int, K, bf, R0, t0, uv, ur, Xw, inv_sigma2,
                         valid, rounds: int = 3, iters: int = 6):
    """Motion-only BA with mixed mono / stereo edges: rows with ur >= 0 carry
    the (uL, v, uR) residual with uR = uL - bf/z and the 7.815 gate
    (g2o::EdgeStereoSE3ProjectXYZOnlyPose); rows with ur < 0 are mono."""
    if kind != cam.PINHOLE:
        _no_kernel(kind)
    bf_t = torch.as_tensor(bf, dtype=torch.float32, device=R0.device).reshape(1)
    R, t, inl, n = pose_kernel.pose_ba(
        K[None, :4].contiguous(), R0[None], t0[None], uv[None], Xw[None],
        inv_sigma2[None], valid[None], ur=ur[None], bf=bf_t,
        rounds=rounds, iters=iters,
    )
    return R[0], t[0], inl[0], n[0]


def match_local_map(kind: int, K, R, t, lm_pos, lm_desc, lm_valid,
                    lm_max_dist, lm_min_dist, lm_normal,
                    kp_xy, kp_desc, kp_octave, kp_valid,
                    radius_px, scale_factors,
                    view_cos_th: float = 0.5,
                    img_wh=(640.0, 480.0)):
    """SearchLocalPoints: frustum cull (Frame::isInFrustum, Frame.cc:512)
    and projection-window descriptor search. Returns per-landmark
    (kp index, ok, visible, uv_pred, distance)."""
    uv_pred, z = _project_points(kind, K, R, t, lm_pos)
    Ow = -(R.T @ t)
    d_vec = lm_pos - Ow
    dist = torch.sqrt(torch.sum(d_vec * d_vec, dim=-1))
    in_depth = (z > 0.0) & (dist >= 0.8 * lm_min_dist) & (dist <= 1.2 * lm_max_dist)
    in_img = (
        (uv_pred[:, 0] >= 0) & (uv_pred[:, 0] < img_wh[0])
        & (uv_pred[:, 1] >= 0) & (uv_pred[:, 1] < img_wh[1])
    )
    n_norm = torch.sqrt(torch.sum(lm_normal * lm_normal, dim=-1))
    vcos = torch.sum(d_vec * lm_normal, dim=-1) / torch.clamp(dist * n_norm, min=1e-9)
    has_normal = n_norm > 1e-6
    view_ok = torch.where(has_normal, vcos > view_cos_th, True)
    visible = lm_valid & in_depth & in_img & view_ok

    # predicted octave from distance, in f32 like the JAX package
    ratio = torch.clamp(lm_max_dist, min=1e-9) / torch.clamp(dist, min=1e-9)
    n_levels = scale_factors.shape[0]
    log_s = torch.log(torch.tensor(1.2, dtype=torch.float32, device=ratio.device))
    pred_oct = torch.clamp(
        torch.ceil(torch.log(ratio) / log_s), 0, n_levels - 1
    ).to(torch.int32)

    idx, d, ok = matching.search_by_projection(
        uv_pred, pred_oct, lm_desc, visible,
        kp_xy, kp_octave, kp_desc, kp_valid,
        radius_px, scale_factors,
        max_dist=matching.TH_HIGH, ratio=0.8, level_lo=-1, level_hi=1,
    )
    return idx, ok, visible, uv_pred, d
