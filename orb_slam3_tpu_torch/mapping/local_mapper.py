"""Local mapping (port of `local_ba` from
orb_slam3_tpu/mapping/local_mapper.py).

`Optimizer::LocalBundleAdjustment` (`Optimizer.cc:1116`) over a window of
keyframe rows through the Schur LM engine. Triangulation, landmark and
keyframe culling come with the mapping slice.
"""

from __future__ import annotations

import dataclasses

import torch

from ..atlas.state import NO_LM, MapState
from ..lm import edges as lm_edges
from ..lm import schur
from ..ops import lie, robust
from ..ops.scatter import mark, put_drop


def local_ba(kind: int, K, s: MapState, window_rows, n_fixed: int = 2,
             window: int = 8, iters: int = 10, scale_factors=None):
    """Windowed local BA over `window` keyframe rows (padded with repeats)
    with mono reprojection edges: the first n_fixed entries are held fixed
    (gauge anchoring); landmarks observed in the window are free, all others
    fixed. Writes back the optimized poses (projected onto SO(3)) and
    landmarks, and detaches the observations whose chi2 exceeds 9.21
    afterwards (`Optimizer.cc:1413-1475`). Returns (state, BAStats). The
    JAX function's stereo edges come with the stereo slice."""
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

    res = lm_edges.make_mono_residual(kind)

    def ba_residual(cam_state, x, data):
        return res(cam_state, {"x": x}, data)

    bap = schur.BAProblem(
        cams=lm_edges.make_pose_block(s.kf_R[rows], s.kf_t[rows], cam_fixed),
        points=s.lm_pos, point_fixed=~observed, cam_idx=cam_idx, lm_idx=lm_edge,
        obs_data={"uv": uv, "K": K[None].expand(W * F, K.shape[0])}, obs_info=inv_sigma2,
        obs_mask=mask, cam_edges=(), residual_dim=2, residual=ba_residual,
        huber_delta=robust.CHI2_2DOF ** 0.5,
    )
    solved, stats = schur.solve(bap, num_iters=iters, lam0=1e-5)

    # detach outliers at the optimized state (gate at the 99% quantile: a
    # detach is permanent until a fuse pass re-binds)
    inlier = schur.obs_chi2(solved) < 9.21
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
