"""Per-frame tracking (port of orb_slam3_tpu/tracking/track.py).

- `pose_optimize` / `pose_optimize_stereo`: motion-only BA with staged
  outlier gating (Optimizer::PoseOptimization, `Optimizer.cc:814-1113`;
  3 rounds x 6 iterations). For the pinhole camera they run kernel K2
  (pose_kernel.py) on CUDA tensors and its plain version on CPU tensors;
  for the KB8 fisheye camera plain torch ops (`_pose_gn`), as the JAX
  package runs it on XLA.
- `pose_optimize_two_cam`: the same over a non-rectified stereo rig, plain
  torch ops (no kernel in the JAX package either).
- `match_local_map`: frustum cull and projection of the local-map snapshot,
  then the windowed descriptor search (SearchLocalPoints,
  `Tracking.cc:2949-3061,3343`), which runs kernel K1 on CUDA tensors.
- `track_frame_visual`: the fused per-frame step built from those two.
- `local_map_mask`: the covisibility-local landmark set tracking matches
  against.
"""

from __future__ import annotations

import torch
from torch.func import jacfwd

from ..frontend import camera as cam
from ..frontend import matching
from ..ops import lie, robust
from ..ops.scatter import mark
from ..utils.threads import FORWARD_AD
from . import pose_kernel

NO_LM = -1


_SCALARS: dict = {}


def _scalar(value: float, device) -> torch.Tensor:
    """A 0-dim f32 tensor of `value` on `device`, made once per (value,
    device) so that a call pays no host-to-device copy for it."""
    key = (float(value), device)
    t = _SCALARS.get(key)
    if t is None:
        t = _SCALARS[key] = torch.tensor(value, dtype=torch.float32, device=device)
    return t


def _log_scale(device) -> torch.Tensor:
    """log(1.2) as a 0-dim f32 tensor, computed once per device on that
    device (the same bits as computing it each call)."""
    key = ("log", device)
    t = _SCALARS.get(key)
    if t is None:
        t = _SCALARS[key] = torch.log(_scalar(1.2, device))
    return t


def _project_points(kind, K, R, t, X):
    Xc = lie.se3_apply(R, t, X)
    return cam.project(kind, K, Xc), Xc[..., 2]


def _pose_gn(res_fn, info, valid, gate, delta, R0, t0, rounds: int, iters: int):
    """Motion-only BA of one SE3 pose in plain torch ops: `rounds` rounds of
    `iters` damped Gauss-Newton steps (Huber in rounds 0-1, gated-cost
    acceptance), each round ending in the chi2 reclassification
    (Optimizer::PoseOptimization). res_fn(R, t) -> (r [M, d], z [M]), the
    residuals and the camera depth of each row; info [M]; gate and delta
    scalars or [M]. The Jacobian is jacfwd's and the 6x6 step solve_ex's,
    whose non-finite result becomes a zero step. Returns (R, t, mask [M]
    float)."""
    dev = R0.device

    def chi2_of(R, t):
        r, z = res_fn(R, t)
        return torch.where(z > 0, torch.sum(r * r, dim=-1) * info, 1e9)

    def gated_cost(R, t, mask):
        c2 = chi2_of(R, t)
        capped = torch.minimum(c2, gate) if torch.is_tensor(gate) else torch.clamp(c2, max=gate)
        return torch.sum(capped * mask)

    eye6 = torch.eye(6, dtype=torch.float32, device=dev)
    zero6 = torch.zeros(6, dtype=torch.float32, device=dev)
    valid_f = valid.to(torch.float32)
    R, t, mask = R0, t0, valid_f
    for round_i in range(rounds):
        lam = torch.full((), 1e-3, dtype=torch.float32, device=dev)
        c_cur = gated_cost(R, t, mask)
        for _ in range(iters):
            def res_at(dxi, R=R, t=t):
                r = res_fn(*lie.se3_lplus(R, t, dxi))[0]
                return r, r

            with FORWARD_AD:
                J, r = jacfwd(res_at, has_aux=True)(zero6)  # [M, d, 6], [M, d]
            c2 = torch.sum(r * r, dim=-1) * info
            w_rob = robust.huber_weight(c2, delta) if round_i < 2 else torch.ones_like(c2)
            wJ = J * (w_rob * info * mask)[:, None, None]
            H = torch.einsum("nri,nrj->ij", J, wJ)
            g = torch.einsum("nri,nr->i", wJ, r)
            dxi = torch.linalg.solve_ex(H + lam * eye6, -g)[0]
            dxi = torch.where(torch.isfinite(dxi).all(), dxi, 0.0)
            Rn, tn = lie.se3_lplus(R, t, dxi)
            c_new = gated_cost(Rn, tn, mask)
            accept = c_new < c_cur
            R, t = torch.where(accept, Rn, R), torch.where(accept, tn, t)
            lam = torch.where(accept, lam * 0.5, lam * 4.0)
            c_cur = torch.where(accept, c_new, c_cur)
        mask = torch.where(chi2_of(R, t) < gate, valid_f, 0.0)
    return R, t, mask


def _pose_optimize_plain(kind, K, bf, R0, t0, uv, ur, Xw, inv_sigma2, valid,
                         rounds, iters):
    """The JAX package's XLA pose BA (`track.py:57-121`, `:152-219`) for a
    camera without a kernel: mono rows, and with `ur` the rows with ur >= 0
    carrying the third (uR = uL - bf/z) residual and the 7.815 gate."""
    if ur is None:
        def res_fn(R, t):
            Xc = lie.se3_apply(R, t, Xw)
            return uv - cam.project(kind, K, Xc), Xc[:, 2]

        R, t, mask = _pose_gn(res_fn, inv_sigma2, valid, robust.CHI2_2DOF,
                              robust.CHI2_2DOF ** 0.5, R0, t0, rounds, iters)
        return R, t, mask > 0, torch.sum(mask > 0)
    has_ur = ur >= 0.0
    obs3 = torch.cat([uv, torch.where(has_ur, ur, 0.0)[:, None]], dim=1)
    comp_w = torch.cat([torch.ones_like(uv), has_ur.to(torch.float32)[:, None]], dim=1)
    gate = torch.where(has_ur, robust.CHI2_3DOF, robust.CHI2_2DOF)
    deltas = torch.where(has_ur, robust.CHI2_3DOF ** 0.5, robust.CHI2_2DOF ** 0.5)

    def res_fn(R, t):
        Xc = lie.se3_apply(R, t, Xw)
        p2 = cam.project(kind, K, Xc)
        z = torch.where(torch.abs(Xc[:, 2]) < 1e-9, 1e-9, Xc[:, 2])
        pred = torch.cat([p2, (p2[:, 0] - bf / z)[:, None]], dim=1)
        return (obs3 - pred) * comp_w, Xc[:, 2]

    R, t, mask = _pose_gn(res_fn, inv_sigma2, valid, gate, deltas, R0, t0, rounds, iters)
    return R, t, mask > 0, torch.sum(mask > 0)


def pose_optimize(kind: int, K, R0, t0, uv, Xw, inv_sigma2, valid,
                  rounds: int = 3, iters: int = 6):
    """Motion-only BA with staged outlier gating. R0/t0: initial Tcw; uv
    [N,2] observations of world points Xw [N,3]; inv_sigma2 [N]; valid [N].
    Returns (R, t, inlier_mask [N], n_inliers). The pinhole camera runs
    kernel K2; the KB8 camera plain torch ops, as the JAX package keeps it
    on XLA (`track.py:48`)."""
    if kind != cam.PINHOLE:
        return _pose_optimize_plain(kind, K, 0.0, R0, t0, uv, None, Xw, inv_sigma2, valid,
                                    rounds, iters)
    R, t, inl, n = pose_kernel.pose_ba(
        K[None, :4].contiguous(), R0[None], t0[None], uv[None], Xw[None],
        inv_sigma2[None], valid[None], rounds=rounds, iters=iters,
    )
    return R[0], t[0], inl[0], n[0]


def pose_optimize_stereo(kind: int, K, bf, R0, t0, uv, ur, Xw, inv_sigma2,
                         valid, rounds: int = 3, iters: int = 6):
    """Motion-only BA with mixed mono / stereo edges: rows with ur >= 0 carry
    the (uL, v, uR) residual with uR = uL - bf/z and the 7.815 gate
    (g2o::EdgeStereoSE3ProjectXYZOnlyPose); rows with ur < 0 are mono. K2's
    stereo template for the pinhole camera, plain torch ops for KB8
    (`track.py:134`)."""
    if kind != cam.PINHOLE:
        return _pose_optimize_plain(kind, K, bf, R0, t0, uv, ur, Xw, inv_sigma2, valid,
                                    rounds, iters)
    if torch.is_tensor(bf):  # no copy when it already lies on the device as f32
        bf_t = bf.to(device=R0.device, dtype=torch.float32).reshape(1)
    else:
        bf_t = _scalar(bf, R0.device).reshape(1)
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
    log_s = _log_scale(ratio.device)
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


def pose_optimize_two_cam(kind: int, K_l, K_r, R_rl, t_rl, R0, t0,
                          uv_l, Xw_l, info_l, valid_l,
                          uv_r, Xw_r, info_r, valid_r,
                          rounds: int = 3, iters: int = 6):
    """Motion-only BA over the two cameras of a non-rectified stereo rig:
    left-camera edges plus right-camera edges through the fixed extrinsics
    X_r = R_rl X_l + t_rl (PoseOptimization with the ToBody edges,
    `Optimizer.cc:871-977`). Plain torch ops (the JAX package has no kernel
    for it). Returns (R, t, inlier_l, inlier_r, n)."""
    n_l = uv_l.shape[0]

    def res_fn(R, t):
        Xl = lie.se3_apply(R, t, Xw_l)
        rl = uv_l - cam.project(kind, K_l, Xl)
        Xr = lie.se3_apply(R, t, Xw_r) @ R_rl.T + t_rl
        rr = uv_r - cam.project(kind, K_r, Xr)
        return torch.cat([rl, rr]), torch.cat([Xl[:, 2], Xr[:, 2]])

    R, t, mask = _pose_gn(res_fn, torch.cat([info_l, info_r]), torch.cat([valid_l, valid_r]),
                          robust.CHI2_2DOF, robust.CHI2_2DOF ** 0.5, R0, t0, rounds, iters)
    inl = mask > 0
    return R, t, inl[:n_l], inl[n_l:], inl.sum()


def track_frame_visual(kind: int, K, bf,
                       lm_pos, lm_desc, in_map, lm_max_dist, lm_min_dist, lm_normal,
                       ref_desc, ref_has_lm, ref_lm_rows,
                       feat_xy, feat_desc, feat_octave, feat_valid, frame_ur,
                       R_pred, t_pred, R_last, t_last,
                       have_velocity, tracked_lms, last_inliers,
                       radius_coarse, radius_fine, min_inliers,
                       scale_factors, img_w, img_h,
                       use_stereo: bool,
                       use_two_cam: bool = False,
                       rfeat_xy=None, rfeat_desc=None, rfeat_octave=None,
                       rfeat_valid=None, K_r=None, R_rl=None, t_rl=None,
                       chain_pred: bool = False,
                       with_census: bool = False,
                       feat_depth=None, min_depth=None, th_depth_m=None,
                       R_kf=None, t_kf=None):
    """One visual tracking step (TrackWithMotionModel + TrackLocalMap +
    TrackReferenceKeyFrame, `Tracking.cc:2720-3061`): stage-1 coarse match
    and pose BA at the predicted pose, the widened retry from the last pose
    when the motion model looks poisoned, stage-2 fine match, the reference-
    keyframe appearance fallback, SO(3) projection, the motion model and
    the per-feature landmark assignment.

    Every stage matches through kernel K1 and optimizes through kernel K2.
    The JAX program's two `lax.cond`s are Python branches here, each on one
    device scalar read to the host (two reads per frame), so a branch not
    taken launches nothing.

    Returns a dict with R, t (normalized), n, tracked [L], feat_lm [F],
    vis32 / fnd32 [L], Rv / tv (velocity), vel_poisoned, has_vel and the
    stacked scalars scal = (n, vel_poisoned, census tracked, census
    untracked); R_rel / t_rel against (R_kf, t_kf) when given."""
    dev = lm_pos.device
    L = lm_pos.shape[0]
    n_feat = feat_xy.shape[0]
    n_levels = scale_factors.shape[0]
    img_wh = (float(img_w), float(img_h))
    have_velocity = torch.as_tensor(have_velocity, device=dev)
    last_inliers = torch.as_tensor(last_inliers, device=dev)

    if chain_pred:
        # motion-model prediction chained from the previous step's outputs
        Rm, tm = lie.se3_mul(R_pred, t_pred, R_last, t_last)
        R_pred = torch.where(have_velocity, Rm, R_last)
        t_pred = torch.where(have_velocity, tm, t_last)

    def inv_sigma2(octave):
        return 1.0 / scale_factors[torch.clamp(octave, 0, n_levels - 1).long()] ** 2

    cont = in_map & tracked_lms
    stage1_mask = torch.where(cont.sum() > 2 * min_inliers, cont, in_map)

    def match_opt(R0, t0, mask, radius):
        idx, ok, visible, _, _ = match_local_map(
            kind, K, R0, t0, lm_pos, lm_desc, mask,
            lm_max_dist, lm_min_dist, lm_normal,
            feat_xy, feat_desc, feat_octave, feat_valid,
            radius, scale_factors, img_wh=img_wh,
        )
        idx = idx.long()
        inv = inv_sigma2(feat_octave[idx])
        uv = feat_xy[idx]
        if use_stereo:
            ur_edge = torch.where(ok, frame_ur[idx], -1.0)
            R, t, inlier, n = pose_optimize_stereo(kind, K, bf, R0, t0, uv, ur_edge,
                                                   lm_pos, inv, ok)
        else:
            R, t, inlier, n = pose_optimize(kind, K, R0, t0, uv, lm_pos, inv, ok)
        return R, t, inlier, n, idx, visible

    # stage 1 at the predicted pose
    R1, t1, _, n1, _, _ = match_opt(R_pred, t_pred, stage1_mask, radius_coarse)

    # widened retry from the last pose when the motion model looks poisoned
    # (Tracking.cc:2892-2897); accepted only on a decisive improvement: the
    # wide window admits lattice-aliased matches on repetitive texture
    do_fb = have_velocity & (n1 < torch.clamp(0.5 * last_inliers, min=2 * min_inliers))
    vel_poisoned = torch.zeros((), dtype=torch.bool, device=dev)
    if bool(do_fb):
        Rb, tb, _, nb, _, _ = match_opt(R_last, t_last, in_map, 2.0 * radius_coarse)
        vel_poisoned = (nb > 2 * n1) & (nb > 2 * min_inliers)
        R1 = torch.where(vel_poisoned, Rb, R1)
        t1 = torch.where(vel_poisoned, tb, t1)
        n1 = torch.where(vel_poisoned, nb, n1)

    # stage 2: fine matching at the refined pose
    R2, t2, inlier, n2, idx, visible = match_opt(R1, t1, in_map, radius_fine)

    # TrackReferenceKeyFrame appearance fallback (Tracking.cc:2720-2779),
    # also when stage 1 kept fewer than 10 inliers: the reference's
    # TrackWithMotionModel fails there (nmatchesMap >= 10, Tracking.cc:
    # 2854-2946) and Track() falls back to TrackReferenceKeyFrame (:1939-
    # 1956). The JAX step reads stage 2 alone, which then starts from the
    # pose of an ill-posed stage-1 BA: K2 and its plain version diverge on
    # such a problem, and on the card that pose once found 21 consistent
    # inliers 0.36 m from the truth and was kept
    if bool((n2 < min_inliers) | (n1 < 10)):
        midx, _, mok = matching.search_by_brute_force(
            feat_desc, feat_valid, ref_desc, ref_has_lm, ratio=0.7, max_dist=matching.TH_LOW)
        enough = mok.sum() >= 15
        rows = torch.clamp(ref_lm_rows[midx], 0, L - 1).long()
        okr = mok & in_map[rows]
        Rr, tr, _, nr = pose_optimize(kind, K, R_last, t_last, feat_xy, lm_pos[rows],
                                      inv_sigma2(feat_octave), okr)
        Rb, tb, inlb, nb, idxb, visb = match_opt(Rr, tr, in_map, radius_fine)
        use = enough & (nr >= 10) & (nb > n2)
        R2, t2 = torch.where(use, Rb, R2), torch.where(use, tb, t2)
        inlier = torch.where(use, inlb, inlier)
        n2 = torch.where(use, nb, n2)
        idx = torch.where(use, idxb, idx)
        visible = torch.where(use, visb, visible)

    if use_two_cam:
        # right-camera stage (fisheye stereo): match through T_rl and refine
        # the LEFT pose over both cameras' edges; right-only features count
        R_r = R_rl @ R2
        t_r = R_rl @ t2 + t_rl
        idx_r, ok_r, vis_r, _, _ = match_local_map(
            kind, K_r, R_r, t_r, lm_pos, lm_desc, in_map,
            lm_max_dist, lm_min_dist, lm_normal,
            rfeat_xy, rfeat_desc, rfeat_octave, rfeat_valid,
            radius_fine, scale_factors, img_wh=img_wh,
        )
        idx_r = idx_r.long()
        R2, t2, inlier, inl_r, n2 = pose_optimize_two_cam(
            kind, K, K_r, R_rl, t_rl, R2, t2,
            feat_xy[idx], lm_pos, inv_sigma2(feat_octave[idx]), inlier,
            rfeat_xy[idx_r], lm_pos, inv_sigma2(rfeat_octave[idx_r]), ok_r,
        )
        visible = visible | vis_r
        tracked_any = inlier | inl_r
    else:
        tracked_any = inlier

    R2 = lie.normalize_rotation(R2)
    # motion model velocity = T_cur T_last^-1 (Tracking.cc:2207)
    Rl_inv, tl_inv = lie.se3_inv(R_last, t_last)
    Rv, tv = lie.se3_mul(R2, t2, Rl_inv, tl_inv)
    Rv = lie.normalize_rotation(Rv)

    # per-feature landmark assignment: the highest landmark row wins
    feat_lm = torch.full((n_feat + 1,), NO_LM, dtype=torch.int32, device=dev)
    feat_lm = feat_lm.scatter_reduce(
        0, torch.where(inlier, idx, n_feat),
        torch.where(inlier, torch.arange(L, dtype=torch.int32, device=dev), NO_LM), "amax",
    )[:n_feat]

    if with_census:
        close = (feat_depth > min_depth) & (feat_depth < th_depth_m) & feat_valid
        trk_f = feat_lm >= 0
        census = ((close & trk_f).sum().to(torch.int32), (close & ~trk_f).sum().to(torch.int32))
    else:
        census = (torch.tensor(-1, dtype=torch.int32, device=dev),) * 2
    out = dict(
        R=R2, t=t2, n=n2, tracked=tracked_any, feat_lm=feat_lm,
        vis32=visible.to(torch.int32), fnd32=tracked_any.to(torch.int32),
        Rv=Rv, tv=tv, vel_poisoned=vel_poisoned,
        has_vel=(n2 >= min_inliers) & ~vel_poisoned,
        scal=torch.stack([n2.to(torch.int32), vel_poisoned.to(torch.int32), *census]),
    )
    if R_kf is not None:
        Rk_inv, tk_inv = lie.se3_inv(R_kf, t_kf)
        out["R_rel"], out["t_rel"] = lie.se3_mul(R2, t2, Rk_inv, tk_inv)
    return out


def local_map_mask(kf_feat_lm, kf_feat_valid, kf_valid, lm_valid, lm_map_id,
                   active_map, covis_W_row, ref_row, max_kfs: int = 80):
    """Landmarks of the covisibility-local map of keyframe `ref_row`
    (UpdateLocalKeyFrames / UpdateLocalPoints, `Tracking.cc:3417-3607`):
    those observed by the reference keyframe and its top `max_kfs`
    covisible keyframes, in the active map. covis_W_row: [K] covisibility
    weights of the reference keyframe. The top-k takes the lower row first
    on ties, as `lax.top_k` does."""
    K = kf_feat_lm.shape[0]
    L = lm_valid.shape[0]
    dev = kf_feat_lm.device
    rows = torch.arange(K, device=dev)
    row = torch.where(rows == ref_row, 0, covis_W_row)
    row = torch.where(kf_valid, row, 0)
    topw, topi = matching.top_k_stable(row, min(max_kfs, K))
    in_local = torch.zeros((K,), dtype=torch.bool, device=dev)
    in_local[topi] = topw > 0
    ref = torch.clamp(torch.as_tensor(ref_row, device=dev), 0, K - 1).long()
    in_local[ref] = True
    bound = (kf_feat_lm >= 0) & kf_feat_valid & in_local[:, None]
    mask = mark(L, torch.clamp(kf_feat_lm, 0, L - 1).long().reshape(-1),
                bound.reshape(-1), dev)
    return mask & lm_valid & (lm_map_id == active_map)
