"""Pose-inertial tracking optimization with a marginalized prior (port of
orb_slam3_tpu/tracking/vi_pose_opt.py).

- `PoseInertialOptimizationLastKeyFrame` (`Optimizer.cc:4491`): the
  current frame's 15-DoF body state {Rwb, twb, v, bg, ba} against the
  visual pose-only edges, an EdgeInertial to the last keyframe (fixed) and
  the gyro / acc random walks to its biases.
- `PoseInertialOptimizationLastFrame` (`Optimizer.cc:4875`, free_prev):
  the previous frame is a second free 15-DoF vertex held by the
  EdgePriorPoseImu of the previous call's marginalization
  (ConstraintPoseImu, `G2oTypes.h:706-730`); after the solve it is
  marginalized out by Schur complement (`Optimizer::Marginalize:2960`)
  into the next frame's 15x15 prior.

The rounds are the JAX function's: `rounds` chi2-gated reclassifications
of `iters` damped Gauss-Newton iterations each, the gates decreasing as in
`Optimizer.cc:4698-4701`, Huber in every round but the last. Mixed mono /
stereo rows use the (uL, v, uR) residual with the third row masked where
ur < 0, as `track.pose_optimize_stereo` does.

The JAX function linearizes every residual with jacfwd in every
iteration. Here the Jacobians are written in closed form: the visual rows'
as K2 does (with Xb = R^T (Xw - t) the point in the body frame, the update
R <- R Exp(dphi), t <- t + R dt moves it by dXb = -dt + [Xb]x dphi, and
Xc = Rbc^T (Xb - tbc) carries that through the projection's Jacobian), the
inertial, random-walk and prior residuals' as g2o's linearizeOplus does
(`imu/factors.py`). On the card jacfwd of the inertial residuals alone
made 16579 CUDA kernels and 557 ms a call (PERF.md section 5). Shapes are
fixed and nothing is read back to the host inside the rounds: accepting a
step is a `torch.where`, the 15x15 / 30x30 systems are solved by
`torch.linalg.solve_ex` without its error check.
"""

from __future__ import annotations

import torch
from torch.func import jacfwd, vmap

from ..frontend import camera as cam
from ..imu import factors
from ..ops import lie
from ..utils.threads import FORWARD_AD

# decreasing visual gates per round (Optimizer.cc:4698-4699); rounds beyond
# the schedule reuse the last entry
_GATES_MONO = (12.0, 7.5, 5.991, 5.991)
_GATES_STEREO = (15.6, 9.8, 7.815, 7.815)


def retract15(state, d):
    """Right-multiplicative SE3 update and additive v / bg / ba (the
    reference's VertexPose / VertexVelocity / VertexGyroBias / VertexAccBias
    updates, `G2oTypes.h:74-110,191-255`)."""
    R, t = lie.se3_rplus(state["R"], state["t"], d[:6])
    return {"R": R, "t": t, "v": state["v"] + d[6:9], "bg": state["bg"] + d[9:12],
            "ba": state["ba"] + d[12:15]}


def _split(state):
    return ({"R": state["R"], "t": state["t"]}, {"v": state["v"]}, {"b": state["bg"]},
            {"b": state["ba"]})


def _rw_res(prev, cur):
    return torch.cat([cur["bg"] - prev["bg"], cur["ba"] - prev["ba"]])


def _prior_res(prev, prior_data):
    p, v, bg, ba = _split(prev)
    return factors.prior_pose_imu_residual(p, v, bg, ba, prior_data)


def _psd_project(H):
    """ConstraintPoseImu's eigenvalue clamp (`G2oTypes.h:706-730`): the
    negative eigenvalues of the marginal information are zeroed."""
    H = 0.5 * (H + H.T)
    w, V = torch.linalg.eigh(H)
    return (V * torch.clamp(w, min=0.0)[None, :]) @ V.T


def _projection_jacobian(kind: int, K, Xc, zs):
    """(pixels [N, 2], d pixels / d Xc [N, 2, 3]): closed form for the
    pinhole camera, forward-mode per point for KB8."""
    if kind == cam.PINHOLE:
        p2 = cam.project(kind, K, Xc)
        fx, fy = K[0], K[1]
        inv_z = 1.0 / zs
        x_z, y_z = Xc[:, 0] * inv_z, Xc[:, 1] * inv_z
        zero = torch.zeros_like(zs)
        J = torch.stack([
            torch.stack([fx * inv_z, zero, -fx * x_z * inv_z], dim=-1),
            torch.stack([zero, fy * inv_z, -fy * y_z * inv_z], dim=-1),
        ], dim=-2)
        return p2, J
    with FORWARD_AD:
        J = vmap(jacfwd(lambda x: cam.project(kind, K, x)))(Xc)
    return cam.project(kind, K, Xc), J


def visual_rows(kind: int, K, bf, Rbc, tbc, cur, Xw, obs3, comp_w, D: int,
                with_jac: bool = True):
    """(residuals [N, 3], depths [N], Jacobian [N, 3, D] or None) of the
    visual pose-only rows (uL, v, uR) at the body state `cur`, each
    component weighted by comp_w (the uR row 0 for a mono observation).
    The Jacobian is in the current state's tangent (columns 0-5: dt, dphi;
    the rest zero)."""
    f32 = dict(dtype=torch.float32, device=Xw.device)
    R, t = cur["R"], cur["t"]
    Rcw, tcw = lie.se3_inv(R @ Rbc, R @ tbc + t)
    Xc = Xw @ Rcw.T + tcw
    z = Xc[:, 2]
    zs = torch.where(z.abs() < 1e-9, 1e-9, z)
    if not with_jac:
        p2 = cam.project(kind, K, Xc)
        pred = torch.cat([p2, (p2[:, 0] - bf / zs)[:, None]], dim=1)
        return (obs3 - pred) * comp_w, z, None
    p2, Jp = _projection_jacobian(kind, K, Xc, zs)
    pred = torch.cat([p2, (p2[:, 0] - bf / zs)[:, None]], dim=1)
    Jur = Jp[:, 0] + torch.stack([torch.zeros_like(zs), torch.zeros_like(zs),
                                  bf / (zs * zs)], dim=-1)
    Jpred = torch.cat([Jp, Jur[:, None]], dim=1)                      # [N, 3, 3]
    Xb = (Xw - t) @ R                                                 # R^T (Xw - t)
    dXb = torch.cat([-torch.eye(3, **f32).expand(Xb.shape[0], 3, 3), lie.hat(Xb)], dim=-1)
    J6 = -comp_w[:, :, None] * (Jpred @ (Rbc.T @ dXb))               # [N, 3, 6]
    J = torch.cat([J6, torch.zeros(J6.shape[:2] + (D - 6,), **f32)], dim=-1)
    return (obs3 - pred) * comp_w, z, J


def pose_inertial_optimize(kind: int, K, bf, Rbc, tbc, prev_state, cur_state,
                           preint_data, preint_info9, rw_info6,
                           uv, ur, Xw, inv_sigma2, valid,
                           prior_data=None, prior_H=None,
                           rounds: int = 3, iters: int = 6, free_prev: bool = False):
    """Optimize the current frame's body state with inertial coupling.

    prev_state / cur_state: {"R", "t", "v", "bg", "ba"} body states
    (world-from-body); preint_*: the window between them
    (factors.preint_edge_data, and the random-walk informations as one
    [6, 6] block diagonal); uv [N, 2], ur [N] (-1 = mono), Xw [N, 3],
    inv_sigma2 [N], valid [N]: the current frame's visual pose-only edges;
    prior_data / prior_H: the 15-dim marginal prior on prev (free_prev).

    Returns (cur_state, inlier [N] bool, n_inliers 0-dim, H15): H15 is the
    current frame's marginal information after eliminating the previous
    state, the next frame's ConstraintPoseImu."""
    dev = uv.device
    f32 = dict(dtype=torch.float32, device=dev)
    D = 30 if free_prev else 15
    bf = torch.as_tensor(bf, **f32)
    has_ur = ur >= 0.0
    obs3 = torch.cat([uv, torch.where(has_ur, ur, 0.0)[:, None]], dim=1)
    comp_w = torch.cat([torch.ones_like(uv), has_ur.to(torch.float32)[:, None]], dim=1)
    infos = [preint_info9, rw_info6] + ([prior_H] if free_prev else [])
    eye_d = torch.eye(D, **f32)

    def states_at(prev, cur, dx):
        cur2 = retract15(cur, dx[:15])
        prev2 = retract15(prev, dx[15:30]) if free_prev else prev
        return prev2, cur2

    def vis_chi2(r, z):
        return torch.where(z > 0, torch.sum(r * r, dim=-1) * inv_sigma2, 1e9)

    def other_chi2(rs):
        return sum(r @ I @ r for r, I in zip(rs, infos))

    # the random walks' Jacobian is constant: +I on the current biases,
    # -I on the previous frame's
    eye6 = torch.eye(6, **f32)
    J_rw = torch.cat([torch.zeros((6, 9), **f32), eye6]
                     + ([torch.zeros((6, 9), **f32), -eye6] if free_prev else []), dim=-1)

    def linearize(prev, cur):
        """Every residual and its Jacobian in the D tangent at (prev, cur):
        (visual rows [N, 3], depths [N], visual J [N, 3, D], the inertial,
        random-walk (and prior) residuals, their Jacobians), in closed
        form. A step's candidate is linearized once: its cost reads these
        residuals and, accepted, it is the next linearization point."""
        rv, zdep, Jv = visual_rows(kind, K, bf, Rbc, tbc, cur, Xw, obs3, comp_w, D)
        p1, v1, bg1, ba1 = _split(prev)
        p2, v2, _, _ = _split(cur)
        r_in, (Jp1, Jv1, Jbg, Jba, Jp2, Jv2) = factors.inertial_jacobians(
            p1, v1, bg1, ba1, p2, v2, preint_data)
        J_in = torch.cat([Jp2, Jv2, torch.zeros((9, 6), **f32)]
                         + ([Jp1, Jv1, Jbg, Jba] if free_prev else []), dim=-1)
        rs, Js = [r_in, _rw_res(prev, cur)], [J_in, J_rw]
        if free_prev:
            rs.append(_prior_res(prev, prior_data))
            Js.append(torch.cat([torch.zeros((15, 15), **f32),
                                 factors.prior_pose_imu_jacobian(p1, prior_data)], dim=-1))
        return rv, zdep, Jv, tuple(rs), tuple(Js)

    def select(accept, new, old):
        if isinstance(new, dict):
            return {k: torch.where(accept, new[k], old[k]) for k in new}
        if isinstance(new, tuple):
            return tuple(select(accept, a, b) for a, b in zip(new, old))
        return torch.where(accept, new, old)

    gates = [torch.where(has_ur, _GATES_STEREO[min(i, 3)], _GATES_MONO[min(i, 3)])
             for i in range(rounds)]

    prev, cur = prev_state, cur_state
    lin = linearize(prev, cur)
    mask = valid.to(torch.float32)
    for round_i in range(rounds):
        gate_r = gates[round_i]
        use_huber = round_i < rounds - 1
        delta = torch.sqrt(gate_r)
        lam = torch.full((), 1e-3, **f32)
        for _ in range(iters):
            rv, zdep, Jv, rs, Js = lin
            c2_raw = torch.sum(rv * rv, dim=-1) * inv_sigma2
            w_rob = (torch.clamp(delta / torch.sqrt(torch.clamp(c2_raw, min=1e-12)), max=1.0)
                     if use_huber else torch.ones_like(c2_raw))
            w = w_rob * inv_sigma2 * mask * (zdep > 0)
            wJ = Jv * w[:, None, None]
            H = torch.einsum("nri,nrj->ij", Jv, wJ)
            g = torch.einsum("nri,nr->i", wJ, rv)
            for r_o, J_o, I_o in zip(rs, Js, infos):
                IJ = I_o @ J_o
                H = H + J_o.T @ IJ
                g = g + IJ.T @ r_o
            dx, _ = torch.linalg.solve_ex(H + lam * eye_d, -g)
            okf = torch.isfinite(dx).all()
            dx = torch.where(okf, dx, 0.0)
            prev_n, cur_n = states_at(prev, cur, dx)
            lin_n = linearize(prev_n, cur_n)
            c_old = torch.sum(torch.minimum(vis_chi2(rv, zdep), gate_r) * mask) + other_chi2(rs)
            c_new = (torch.sum(torch.minimum(vis_chi2(lin_n[0], lin_n[1]), gate_r) * mask)
                     + other_chi2(lin_n[3]))
            accept = c_new < c_old
            cur = select(accept, cur_n, cur)
            if free_prev:
                prev = select(accept, prev_n, prev)
            lin = select(accept, lin_n, lin)
            lam = torch.where(accept, lam * 0.5, lam * 4.0)
        mask = torch.where(vis_chi2(lin[0], lin[1]) < gate_r, valid.to(torch.float32), 0.0)

    # marginal information for the next frame's prior
    _, zdep, Jv, _, Js = lin
    w = inv_sigma2 * mask * (zdep > 0)
    Hfull = torch.einsum("nri,nrj->ij", Jv * w[:, None, None], Jv)
    for J_o, I_o in zip(Js, infos):
        Hfull = Hfull + J_o.T @ I_o @ J_o
    if free_prev:
        # Schur-marginalize the previous frame (Optimizer::Marginalize:2960)
        Hcc, Hcp, Hpp = Hfull[:15, :15], Hfull[:15, 15:], Hfull[15:, 15:]
        Hpp_inv = torch.linalg.pinv(0.5 * (Hpp + Hpp.T), rtol=1e-8)
        H15 = Hcc - Hcp @ Hpp_inv @ Hcp.T
    else:
        H15 = Hfull[:15, :15]
    inlier = mask > 0
    return cur, inlier, inlier.sum(), _psd_project(H15)
