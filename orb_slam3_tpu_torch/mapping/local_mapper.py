"""Local mapping (port of orb_slam3_tpu/mapping/local_mapper.py).

The LocalMapping work unit (`LocalMapping.cc:64-282`) as functions over
MapState: two-view triangulation of new landmarks against a neighbour
keyframe (`CreateNewMapPoints:388`), windowed local BA through the Schur LM
engine (`Optimizer::LocalBundleAdjustment`, `Optimizer.cc:1116`), landmark
culling (`MapPointCulling:346`) and keyframe culling (`KeyFrameCulling:902`).
With a depth sensor, triangulation prefers the measured depth and local BA
runs the stereo (uL, v, uR) edges.
"""

from __future__ import annotations

import dataclasses

import torch

from ..atlas import ops as atlas_ops
from ..atlas.state import NO_LM, MapState
from ..frontend import camera as cam
from ..frontend import matching, two_view
from ..lm import edges as lm_edges
from ..lm import schur
from ..ops import lie, robust
from ..ops.scatter import add_at, mark, put_drop


def _fundamental_from_poses(K, R1, t1, R2, t2):
    """F21 mapping image-1 points to epipolar lines in image 2
    (GeometricTools::ComputeF12)."""
    R21 = R2 @ R1.T
    t21 = t2 - R21 @ t1
    Kinv = two_view._inv(two_view._kmat(K))
    E = lie.hat(t21) @ R21
    return Kinv.T @ E @ Kinv


def triangulate_pair(kind: int, K, s: MapState, kf1: int, kf2: int, scale_factors,
                     max_new: int = 256, use_depth: bool = False, min_depth: float = 0.0):
    """Match the unbound features of kf1 against the unbound features of kf2
    (ratio, mutual check and epipolar gate), triangulate, and run the
    acceptance checks of CreateNewMapPoints (`LocalMapping.cc:388-712`):
    cheirality, reprojection chi2 < 5.991 sigma2 in both views, parallax.
    With use_depth, a kf1 feature with a measured depth above min_depth is
    placed at that depth instead, and waives the parallax gate: the depth
    sensor is the baseline (`LocalMapping.cc:557-604`). At most `max_new`
    candidates are accepted, lowest features first.

    Returns (Xw [F,3], src_feat [F], dst_feat [F], accept [F]), F = fmax:
    kf1 feature i pairs with kf2 feature dst_feat[i]."""
    F = s.fmax
    dev = s.device
    R1, t1 = s.kf_R[kf1], s.kf_t[kf1]
    R2, t2 = s.kf_R[kf2], s.kf_t[kf2]
    free1 = s.kf_feat_valid[kf1] & (s.kf_feat_lm[kf1] == NO_LM)
    free2 = s.kf_feat_valid[kf2] & (s.kf_feat_lm[kf2] == NO_LM)
    xy1, xy2 = s.kf_feat_xy[kf1], s.kf_feat_xy[kf2]
    n_levels = scale_factors.shape[0]

    dist = matching.hamming_matrix(s.kf_feat_desc[kf1], s.kf_feat_desc[kf2])
    m = free1[:, None] & free2[None, :]
    # epipolar gate: a point in image 1 against its line in image 2
    Fm = _fundamental_from_poses(K, R1, t1, R2, t2)
    ones = torch.ones((F, 1), dtype=torch.float32, device=dev)
    lines = torch.cat([xy1, ones], dim=-1) @ Fm.T
    dnum = torch.abs(lines @ torch.cat([xy2, ones], dim=-1).T)
    dden = torch.sqrt(torch.clamp(lines[:, 0:1] ** 2 + lines[:, 1:2] ** 2, min=1e-12))
    ep_dist2 = (dnum / dden) ** 2
    sig2 = scale_factors[torch.clamp(s.kf_feat_octave[kf2], 0, n_levels - 1).long()] ** 2
    m = m & (ep_dist2 < 3.84 * sig2[None, :])

    idx, _, ok = matching.masked_best_match(dist, m, max_dist=matching.TH_LOW, ratio=0.8)
    idx_back, _, _ = matching.masked_best_match(dist.T, m.T, max_dist=matching.TH_LOW)
    ok = matching.mutual_filter(idx, ok, idx_back)

    Km = two_view._kmat(K)
    P1 = Km @ torch.cat([R1, t1[:, None]], dim=1)
    P2 = Km @ torch.cat([R2, t2[:, None]], dim=1)
    xy2m = xy2[idx]
    Xw = two_view.triangulate(P1, P2, xy1, xy2m)
    has_meas = torch.zeros((F,), dtype=torch.bool, device=dev)
    if use_depth:
        d1 = s.kf_feat_depth[kf1]
        has_meas = d1 > min_depth
        R1w, t1w = lie.se3_inv(R1, t1)
        Xw_meas = lie.se3_apply(R1w, t1w, cam.unproject(kind, K, xy1) * d1[:, None])
        Xw = torch.where(has_meas[:, None], Xw_meas, Xw)

    Xc1 = lie.se3_apply(R1, t1, Xw)
    Xc2 = lie.se3_apply(R2, t2, Xw)
    depth_ok = (Xc1[:, 2] > 0) & (Xc2[:, 2] > 0)
    s1 = scale_factors[torch.clamp(s.kf_feat_octave[kf1], 0, n_levels - 1).long()] ** 2
    e1 = torch.sum((cam.project(kind, K, Xc1) - xy1) ** 2, dim=-1)
    e2 = torch.sum((cam.project(kind, K, Xc2) - xy2m) ** 2, dim=-1)
    reproj_ok = (e1 < 5.991 * s1) & (e2 < 5.991 * sig2[idx])
    r1 = Xw - (-R1.T @ t1)
    r2 = Xw - (-R2.T @ t2)
    cosp = torch.sum(r1 * r2, dim=-1) / torch.clamp(
        torch.sqrt(torch.sum(r1 * r1, dim=-1)) * torch.sqrt(torch.sum(r2 * r2, dim=-1)),
        min=1e-9)
    finite = torch.isfinite(Xw).all(dim=-1)

    accept = ok & depth_ok & reproj_ok & ((cosp < 0.9998) | has_meas) & finite
    accept = accept & (torch.cumsum(accept.to(torch.int32), 0) <= max_new)
    return Xw, torch.arange(F, dtype=torch.int32, device=dev), idx.to(torch.int32), accept


def insert_triangulated(s: MapState, kf1: int, kf2, Xw, f1, f2, accept) -> MapState:
    """Allocate the accepted landmarks, bound to kf1's features and observed
    from kf2's."""
    col = torch.full(f1.shape, int(kf1), dtype=torch.int32, device=s.device)
    s2, rows = atlas_ops.add_landmarks(s, Xw, s.kf_feat_desc[kf1], col, accept, col, f1)
    return atlas_ops.add_observations(s2, kf2, f2, rows, accept & (rows >= 0))


def _obs_count(s: MapState):
    """[L] int32: bindings of each landmark over every keyframe row."""
    L = s.lmax
    bound = ((s.kf_feat_lm >= 0) & s.kf_feat_valid).reshape(-1)
    return add_at(torch.zeros((L,), dtype=torch.int32, device=s.device),
                  torch.clamp(s.kf_feat_lm, 0, L - 1).long().reshape(-1),
                  bound.to(torch.int32), valid=bound)


def cull_landmarks(s: MapState, min_found_ratio: float = 0.25,
                   min_obs: int = 2, grace_kfs: int = 2) -> MapState:
    """MapPointCulling (`LocalMapping.cc:346-386`): kill the landmarks whose
    found/visible ratio is poor (once tested more than 3 times), that have
    fewer than `min_obs` observations `grace_kfs` keyframes after their
    creation, or that have none."""
    L = s.lmax
    obs_cnt = _obs_count(s)
    ratio = s.lm_found.to(torch.float32) / torch.clamp(s.lm_visible.to(torch.float32), min=1.0)
    seen = s.lm_visible > 3
    mature = (s.n_kf - 1 - s.lm_first_kf) >= grace_kfs
    bad = s.lm_valid & ((mature & (obs_cnt < min_obs)) | (seen & (ratio < min_found_ratio))
                        | (obs_cnt == 0))
    return atlas_ops.invalidate_landmarks(
        s, torch.arange(L, dtype=torch.int32, device=s.device), bad)


def cull_keyframes(s: MapState, window_rows, min_redundancy: float = 0.9,
                   protect_last: int = 2) -> MapState:
    """KeyFrameCulling (`LocalMapping.cc:902-1170`) over `window_rows`: a
    keyframe is redundant when more than 90% of its (over 10) bound
    landmarks are observed by at least 3 other keyframes. The newest
    `protect_last` rows and rows 0-1 are kept, and never two adjacent
    window entries in one pass. A culled keyframe is invalidated, its
    observations detached, and its children and temporal successors
    re-linked to the first surviving ancestor (the chains of one pass are
    at most the window long)."""
    L, K = s.lmax, s.kmax
    dev = s.device
    obs_cnt = _obs_count(s)
    rows = torch.as_tensor(window_rows, device=dev).long()
    lm = s.kf_feat_lm[rows]
    bound = (lm >= 0) & s.kf_feat_valid[rows]
    redundant = bound & (obs_cnt[torch.clamp(lm, 0, L - 1).long()] >= 4)
    n_bound = bound.sum(dim=1)
    frac = redundant.sum(dim=1).to(torch.float32) / torch.clamp(n_bound, min=1).to(torch.float32)
    protect = (rows >= s.n_kf - protect_last) | (rows <= 1)
    kill = (frac > min_redundancy) & (n_bound > 10) & ~protect & s.kf_valid[rows]
    kill = kill & torch.cat([torch.ones((1,), dtype=torch.bool, device=dev), ~kill[:-1]])

    kill_rows = torch.where(kill, rows, K)
    killed = mark(K, rows, kill, dev)
    kf_feat_lm = torch.where(killed[:, None] & (s.kf_feat_lm >= 0), NO_LM, s.kf_feat_lm)

    def relink(link0):
        link = link0
        for _ in range(rows.shape[0]):
            at = torch.clamp(link, 0, K - 1).long()
            link = torch.where(killed[at] & (link >= 0), link0[at], link)
        return link

    return dataclasses.replace(
        s, kf_valid=put_drop(s.kf_valid, kill_rows, False), kf_feat_lm=kf_feat_lm,
        kf_parent=relink(s.kf_parent), kf_prev=relink(s.kf_prev),
    )


def local_ba(kind: int, K, s: MapState, window_rows, n_fixed: int = 2,
             window: int = 8, iters: int = 10, scale_factors=None,
             stereo: bool = False, bf: float = 0.0):
    """Windowed local BA over `window` keyframe rows (padded with repeats):
    the first n_fixed entries are held fixed (gauge anchoring); landmarks
    observed in the window are free, all others fixed. Mono edges are the
    2-dim reprojection; with `stereo` every edge is the 3-dim (uL, v, uR)
    residual with uR = uL - bf / z, whose third row carries no weight where
    the feature has no right coordinate (ur < 0; EdgeStereoSE3ProjectXYZ,
    `Optimizer.cc:1325-1352`). Writes back the optimized poses (projected
    onto SO(3)) and landmarks, and detaches the observations whose chi2
    exceeds the 99% gate afterwards (9.21 mono, 7.815 stereo;
    `Optimizer.cc:1413-1475`). Returns (state, BAStats)."""
    W, F, L = window, s.fmax, s.lmax
    dev = s.device
    rows = torch.as_tensor(window_rows, device=dev).long()

    # a row repeated in the window is a camera only at its first slot
    eq = rows[:, None] == rows[None, :]
    first_occ = torch.tril(eq, diagonal=-1).sum(dim=1) == 0

    lm_idx = s.kf_feat_lm[rows]
    feat_ok = s.kf_feat_valid[rows] & (lm_idx >= 0) & first_occ[:, None]
    lm_safe = torch.clamp(lm_idx, 0, L - 1).long()
    mask = (feat_ok & s.lm_valid[lm_safe]).reshape(-1)

    cam_idx = torch.arange(W, device=dev)[:, None].expand(W, F).reshape(-1)
    lm_edge = lm_safe.reshape(-1)
    uv = s.kf_feat_xy[rows].reshape(-1, 2)
    oct_ = s.kf_feat_octave[rows].reshape(-1)
    if scale_factors is None:
        scale_factors = 1.2 ** torch.arange(8, dtype=torch.float32, device=dev)
    inv_sigma2 = 1.0 / scale_factors[torch.clamp(oct_, 0, scale_factors.shape[0] - 1).long()] ** 2

    observed = mark(L, lm_edge, mask, dev)
    cam_fixed = (torch.arange(W, device=dev) < n_fixed) | ~first_occ

    E = W * F
    K_edges = K[None].expand(E, K.shape[0])
    if stereo:
        ur = s.kf_feat_ur[rows].reshape(-1)
        has_ur = ur >= 0.0
        uvr = torch.cat([uv, torch.where(has_ur, ur, 0.0)[:, None]], dim=1)
        ones = torch.ones_like(ur)
        obs_info = torch.diag_embed(
            torch.stack([ones, ones, has_ur.to(torch.float32)], dim=-1) * inv_sigma2[:, None])
        obs_data = {"uvr": uvr, "K": K_edges,
                    "bf": torch.full((E,), float(bf), dtype=torch.float32, device=dev)}
        res = lm_edges.make_stereo_residual(kind)
        residual_dim, huber, gate = 3, robust.CHI2_3DOF ** 0.5, 7.815
    else:
        obs_info = inv_sigma2
        obs_data = {"uv": uv, "K": K_edges}
        res = lm_edges.make_mono_residual(kind)
        residual_dim, huber, gate = 2, robust.CHI2_2DOF ** 0.5, 9.21

    def ba_residual(cam_state, x, data):
        return res(cam_state, {"x": x}, data)

    bap = schur.BAProblem(
        cams=lm_edges.make_pose_block(s.kf_R[rows], s.kf_t[rows], cam_fixed),
        points=s.lm_pos, point_fixed=~observed, cam_idx=cam_idx, lm_idx=lm_edge,
        obs_data=obs_data, obs_info=obs_info, obs_mask=mask, cam_edges=(),
        residual_dim=residual_dim, residual=ba_residual, huber_delta=huber,
    )
    solved, stats = schur.solve(bap, num_iters=iters, lam0=1e-5)

    # detach outliers at the optimized state (gate at the 99% quantile: a
    # detach is permanent until a fuse pass re-binds)
    inlier = schur.obs_chi2(solved) < gate
    new_feat_lm = torch.where((mask & ~inlier).reshape(W, F), NO_LM, s.kf_feat_lm[rows])
    rows_w = torch.where(first_occ, rows, s.kmax)  # duplicate slots write nothing
    # SO(3) projection of the written poses: repeated BA runs otherwise
    # accumulate f32 composition error in the stored rotations
    R_out = lie.normalize_rotation(solved.cams.state["R"])
    s_out = dataclasses.replace(
        s,
        kf_R=put_drop(s.kf_R, rows_w, R_out),
        kf_t=put_drop(s.kf_t, rows_w, solved.cams.state["t"]),
        lm_pos=solved.points,
        kf_feat_lm=put_drop(s.kf_feat_lm, rows_w, new_feat_lm),
    )
    return s_out, stats
