"""Closed-form Sim(3) between matched 3D point sets, RANSAC and the Sim3
refinement (port of orb_slam3_tpu/graphopt/sim3_solver.py).

Role of `Sim3Solver` (`Sim3Solver.cc`: Horn's method on 3-point minimal
sets, inliers gated by reprojection in both keyframes, `CheckInliers`;
fixed scale for metric maps) and of `Optimizer::OptimizeSim3`
(`Optimizer.cc:2115-2380`). Every hypothesis is solved in one batched SVD
and scored by one [H, N] projection test per camera. The minimal sets are
drawn from a CPU `torch.Generator`, or handed in as `sets`.
"""

from __future__ import annotations

import torch
from torch.func import jacfwd

from ..frontend import camera as cam
from ..ops import lie
from ..place.recognition import sample_sets
from ..utils.threads import FORWARD_AD


def horn_sim3(P, Q, w, fix_scale: bool = False):
    """Weighted Horn alignment (Sim3Solver::ComputeSim3, SVD form): (R, t,
    s) with Q ~= s R P + t. P, Q [..., N, 3], w [..., N]; batched over the
    leading dimensions. s is [...] (1 with fix_scale)."""
    wsum = torch.clamp(torch.sum(w, dim=-1), min=1e-9)[..., None]
    mp = torch.sum(P * w[..., None], dim=-2) / wsum
    mq = torch.sum(Q * w[..., None], dim=-2) / wsum
    Pc = (P - mp[..., None, :]) * w[..., None]
    Qc = Q - mq[..., None, :]
    U, S, Vt = torch.linalg.svd(Pc.transpose(-1, -2) @ Qc)
    V = Vt.transpose(-1, -2)
    d = torch.sign(torch.linalg.det(V @ U.transpose(-1, -2)))
    D = torch.stack([torch.ones_like(d), torch.ones_like(d), d], dim=-1)
    R = (V * D[..., None, :]) @ U.transpose(-1, -2)
    if fix_scale:
        s = torch.ones_like(d)
    else:
        var_p = torch.sum(w[..., None] * (P - mp[..., None, :]) ** 2, dim=(-1, -2))
        s = torch.sum(S * D, dim=-1) / torch.clamp(var_p, min=1e-12)
    t = mq - s[..., None] * (R @ mp[..., None])[..., 0]
    return R, t, s


def sim3_ransac(kind: int, K8, X1, X2, valid, R1, t1, R2, t2, uv1, uv2,
                generator: torch.Generator | None = None, sets=None, n_hyp: int = 128,
                inlier_px: float = 6.0, fix_scale: bool = False):
    """RANSAC Sim3 between the matched landmarks X1 / X2 [N, 3] (world
    frames of map 1 / map 2, same index = match) seen by keyframes (R1, t1)
    and (R2, t2), with their observed keypoints uv1 / uv2 [N, 2] for the
    two-sided reprojection gate (Sim3Solver::CheckInliers). Minimal sets:
    `sets` [n_hyp, 3], else drawn with `generator`. Returns (R12, t12,
    s12, inliers, n_inl): the similarity from camera-2 into camera-1
    coordinates (the reference's S12)."""
    P1 = lie.se3_apply(R1, t1, X1)
    P2 = lie.se3_apply(R2, t2, X2)
    if sets is None:
        if generator is None:
            raise ValueError("sim3_ransac needs a torch.Generator or the minimal sets")
        sets = sample_sets(generator, valid, n_hyp, 3)
    sets = sets.long()
    Rs, ts, ss = horn_sim3(P2[sets], P1[sets], torch.ones(sets.shape, dtype=P1.dtype,
                                                          device=P1.device), fix_scale)

    def score(Rh, th, sh):
        # [..., N] inlier masks of hypotheses (Rh [..., 3, 3], th [..., 3], sh [...])
        p1_from_2 = sh[..., None, None] * torch.einsum("...ij,nj->...ni", Rh, P2) + th[..., None, :]
        p2_from_1 = (1.0 / sh)[..., None, None] * torch.einsum(
            "...ji,...nj->...ni", Rh, P1 - th[..., None, :])
        shp = p1_from_2.shape
        e1 = torch.linalg.norm(cam.project(kind, K8, p1_from_2.reshape(-1, 3)).reshape(
            *shp[:-1], 2) - uv1, dim=-1)
        e2 = torch.linalg.norm(cam.project(kind, K8, p2_from_1.reshape(-1, 3)).reshape(
            *shp[:-1], 2) - uv2, dim=-1)
        return ((e1 < inlier_px) & (e2 < inlier_px) & (p1_from_2[..., 2] > 0)
                & (p2_from_1[..., 2] > 0) & valid)

    inls = score(Rs, ts, ss)
    counts = torch.sum(inls, dim=1)
    best = torch.argmax(counts)
    R_r, t_r, s_r = horn_sim3(P2, P1, inls[best].to(torch.float32), fix_scale)
    inl_r = score(R_r, t_r, s_r)
    better = torch.sum(inl_r) >= counts[best]
    inl_out = torch.where(better, inl_r, inls[best])
    return (torch.where(better, R_r, Rs[best]), torch.where(better, t_r, ts[best]),
            torch.where(better, s_r, ss[best]), inl_out, torch.sum(inl_out))


def optimize_sim3(kind: int, K8, P1, P2, uv1, uv2, valid, R12, t12, s12,
                  valid_inv=None, iters: int = 10, th2: float = 10.0,
                  fix_scale: bool = False):
    """Sim3 refinement with two-way reprojection residuals
    (Optimizer::OptimizeSim3): one Sim3 vertex, fixed camera-frame points
    P1 / P2 [N, 3] with their keypoints uv1 / uv2, Huber edges (delta =
    sqrt(th2)) as IRLS weights held through each Gauss-Newton step, the
    outliers dropped halfway. `valid` marks the forward edges (P2 through
    S12 against uv1); `valid_inv` the inverse ones (P1 through S21 against
    uv2, only where the current feature has its own map point). A pair is
    an inlier when every edge it carries passes th2.
    Returns (R, t, s, inlier mask, n_inl)."""
    delta_h = th2 ** 0.5
    if valid_inv is None:
        valid_inv = valid
    dev = P1.device

    def residuals(R, t, s):
        p1 = s * torch.einsum("ij,nj->ni", R, P2) + t
        Ri, ti, si = lie.sim3_inv(R, t, s)
        p2 = si * torch.einsum("ij,nj->ni", Ri, P1) + ti
        return (cam.project(kind, K8, p1) - uv1, cam.project(kind, K8, p2) - uv2,
                p1[:, 2] > 1e-3, p2[:, 2] > 1e-3)

    def chi2(R, t, s):
        r1, r2, pos1, pos2 = residuals(R, t, s)
        big = torch.tensor(1e9, dtype=torch.float32, device=dev)
        return (torch.where(pos1, torch.sum(r1 ** 2, -1), big),
                torch.where(pos2, torch.sum(r2 ** 2, -1), big))

    n_dof = 6 if fix_scale else 7
    eye = torch.eye(n_dof, dtype=torch.float32, device=dev)

    def full(dxi):
        return torch.cat([dxi, torch.zeros((1,), dtype=dxi.dtype, device=dev)]) \
            if fix_scale else dxi

    def gn_pass(R, t, s, m1, m2, n_iters):
        for _ in range(n_iters):
            r1c, r2c, pos1c, pos2c = residuals(R, t, s)
            w1 = (m1 & pos1c).to(torch.float32) * torch.clamp(
                delta_h / torch.sqrt(torch.sum(r1c ** 2, -1) + 1e-12), max=1.0)
            w2 = (m2 & pos2c).to(torch.float32) * torch.clamp(
                delta_h / torch.sqrt(torch.sum(r2c ** 2, -1) + 1e-12), max=1.0)
            sw1, sw2 = torch.sqrt(w1)[:, None], torch.sqrt(w2)[:, None]

            def res_flat(dxi, R=R, t=t, s=s):
                dR, dt, ds = lie.sim3_exp(full(dxi))
                r1, r2, _, _ = residuals(*lie.sim3_mul(dR, dt, ds, R, t, s))
                return torch.cat([(r1 * sw1).reshape(-1), (r2 * sw2).reshape(-1)])

            z = torch.zeros((n_dof,), dtype=torch.float32, device=dev)
            with FORWARD_AD:
                J = jacfwd(res_flat)(z)
            g = J.T @ res_flat(z)
            dxi = -torch.linalg.solve_ex(J.T @ J + 1e-6 * eye, g)[0]
            dR, dt, ds = lie.sim3_exp(full(dxi))
            R, t, s = lie.sim3_mul(dR, dt, ds, R, t, s)
        return R, t, s

    def inliers_of(R, t, s, m1, m2):
        c1, c2 = chi2(R, t, s)
        return m1 & (c1 < th2) & (~m2 | (c2 < th2))

    s = torch.as_tensor(s12, dtype=torch.float32, device=dev)
    half = iters // 2
    R, t, s = gn_pass(R12, t12, s, valid, valid_inv, half)
    inl = inliers_of(R, t, s, valid, valid_inv)
    R, t, s = gn_pass(R, t, s, inl, inl & valid_inv, iters - half)
    inl = inliers_of(R, t, s, valid, valid_inv)
    return R, t, s, inl, torch.sum(inl)
