"""Inertial factors for the LM engine (port of orb_slam3_tpu/imu/factors.py).

Residuals of the reference's g2o types (`G2oTypes.cc` / `G2oTypes.h`):
EdgeInertial (`:495-544`), EdgeInertialGS (`:548-631`), EdgeGyroRW /
EdgeAccRW (`:635-704`), EdgePriorPoseImu (`:732-765`) and EdgePriorAcc /
Gyro (`:768-814`), with the world-from-body pose vertex and its
right-multiplicative update (ImuCamPose::Update, `G2oTypes.h:74-110`).

Vertex blocks:
  "vipose": {"R": Rwb [N,3,3], "t": twb [N,3]}, retract se3_rplus
  "vel":    {"v": [N,3]};  "bg" / "ba": {"b": [N,3]}
  "gdir":   {"R": Rwg [N,3,3]}, a 2-DoF rotation update
  "scale":  {"s": [N,1]}, multiplicative exp update (VertexScale)

The scale is held as [N, 1], not [N] as in the JAX package: under
torch.func.jacfwd a 0-dim tensor combined with a Python float gets a
float64 tangent, so everything the engines differentiate works on [..., 1]
slices. Edge data carry the preintegration tensors, so the bias-corrected
deltas (first-order J db updates) are recomputed inside the residual and
differentiation gives the reference's bias Jacobians.
"""

from __future__ import annotations

import torch

from ..lm.problem import VertexBlock
from ..ops import lie
from .preintegration import GRAVITY, Preintegrated


def _mv(M, v):
    return (M @ v[..., None])[..., 0]


def _gvec(like):
    return torch.tensor([0.0, 0.0, -GRAVITY], dtype=torch.float32, device=like.device)


# ---------------------------------------------------------------------------
# Vertex blocks
# ---------------------------------------------------------------------------

def vipose_retract(state, delta):
    R, t = lie.se3_rplus(state["R"], state["t"], delta)
    return {"R": R, "t": t}


def make_vipose_block(Rwb, twb, fixed):
    return VertexBlock(state={"R": Rwb, "t": twb}, fixed=fixed, tangent_dim=6,
                       retract=vipose_retract)


def vec3_retract(state, delta):
    return {"v": state["v"] + delta}


def vec3_retract_b(state, delta):
    return {"b": state["b"] + delta}


def make_vec3_block(v, fixed):
    return VertexBlock(state={"v": v}, fixed=fixed, tangent_dim=3, retract=vec3_retract)


def gdir_retract(state, delta):
    """2-DoF gravity-direction update Rwg <- Rwg Exp(dx, dy, 0) (VertexGDir,
    `G2oTypes.h:257-293`)."""
    d = torch.cat([delta, torch.zeros_like(delta[..., :1])], dim=-1)
    return {"R": state["R"] @ lie.so3_exp(d)}


def make_gdir_block(Rwg, fixed):
    return VertexBlock(state={"R": Rwg}, fixed=fixed, tangent_dim=2, retract=gdir_retract)


def scale_retract(state, delta):
    """s <- s exp(ds) (VertexScale, `G2oTypes.h:296-317`), on [..., 1]."""
    return {"s": state["s"] * torch.exp(delta[..., :1])}


def make_scale_block(s, fixed):
    """s [N, 1]."""
    return VertexBlock(state={"s": s}, fixed=fixed, tangent_dim=1, retract=scale_retract)


# ---------------------------------------------------------------------------
# Bias-corrected deltas from edge data (ImuTypes.cc:283-307)
# ---------------------------------------------------------------------------

def _corrected_deltas(data, bg, ba):
    dbg = bg - data["bg0"]
    dba = ba - data["ba0"]
    dR = data["dR"] @ lie.so3_exp(_mv(data["JRg"], dbg))
    dV = data["dV"] + _mv(data["JVg"], dbg) + _mv(data["JVa"], dba)
    dP = data["dP"] + _mv(data["JPg"], dbg) + _mv(data["JPa"], dba)
    return dR, dV, dP


# ---------------------------------------------------------------------------
# Edge residuals (one edge; the engines batch them)
# ---------------------------------------------------------------------------

def inertial_residual(pose1, vel1, bg, ba, pose2, vel2, data):
    """EdgeInertial::computeError: 9-dim (er, ev, ep)."""
    dt = data["dT"][..., None]
    dR, dV, dP = _corrected_deltas(data, bg["b"], ba["b"])
    g = _gvec(dt)
    R1T = pose1["R"].transpose(-1, -2)
    er = lie.so3_log(dR.transpose(-1, -2) @ R1T @ pose2["R"])
    ev = _mv(R1T, vel2["v"] - vel1["v"] - g * dt) - dV
    ep = _mv(R1T, pose2["t"] - pose1["t"] - vel1["v"] * dt - 0.5 * g * dt * dt) - dP
    return torch.cat([er, ev, ep], dim=-1)


def inertial_gs_residual(pose1, vel1, bg, ba, pose2, vel2, gdir, scale, data):
    """EdgeInertialGS::computeError (`G2oTypes.cc:617-641`): the gravity
    direction Rwg and the scale s as vertices (inertial-only init)."""
    dt = data["dT"][..., None]
    dR, dV, dP = _corrected_deltas(data, bg["b"], ba["b"])
    g = _mv(gdir["R"], _gvec(dt))
    s = scale["s"]
    R1T = pose1["R"].transpose(-1, -2)
    er = lie.so3_log(dR.transpose(-1, -2) @ R1T @ pose2["R"])
    ev = _mv(R1T, s * (vel2["v"] - vel1["v"]) - g * dt) - dV
    ep = _mv(R1T, s * (pose2["t"] - pose1["t"] - vel1["v"] * dt) - 0.5 * g * dt * dt) - dP
    return torch.cat([er, ev, ep], dim=-1)


def bias_rw_residual(b1, b2, data):
    """EdgeGyroRW / EdgeAccRW: b2 - b1."""
    return b2["b"] - b1["b"]


def bias_prior_residual(b, data):
    """EdgePriorAcc / EdgePriorGyro: b - prior."""
    return b["b"] - data["prior"]


def prior_pose_imu_residual(pose, vel, bg, ba, data):
    """EdgePriorPoseImu: 15-dim residual against a marginalized prior state
    (R0, t0, v0, bg0p, ba0p), the pose-inertial tracking optimizations'
    ConstraintPoseImu (`Optimizer.cc:4491/4875`)."""
    er = lie.so3_log(data["R0"].transpose(-1, -2) @ pose["R"])
    return torch.cat([er, pose["t"] - data["t0"], vel["v"] - data["v0"],
                      bg["b"] - data["bg0p"], ba["b"] - data["ba0p"]], dim=-1)


# ---------------------------------------------------------------------------
# Edge data from preintegrated windows
# ---------------------------------------------------------------------------

def preint_edge_data(p: Preintegrated):
    """(data dict, info9) of one window or a stack of them (leading dims
    kept): info9 is the symmetrized inverse of C[:9, :9] (EdgeInertial
    ctor, `G2oTypes.cc:555-566`)."""
    C9 = p.C[..., :9, :9]
    eye9 = torch.eye(9, dtype=torch.float32, device=C9.device)
    C9 = 0.5 * (C9 + C9.transpose(-1, -2)) + 1e-10 * eye9
    info = torch.linalg.inv(C9)
    info = 0.5 * (info + info.transpose(-1, -2))
    data = {"dT": p.dT, "dR": p.dR, "dV": p.dV, "dP": p.dP, "JRg": p.JRg, "JVg": p.JVg,
            "JVa": p.JVa, "JPg": p.JPg, "JPa": p.JPa, "bg0": p.bias_gyro,
            "ba0": p.bias_acc}
    return data, info


def gyro_rw_info(p: Preintegrated):
    """Inverse of the gyro random-walk block C[9:12, 9:12] (EdgeGyroRW)."""
    eye3 = torch.eye(3, dtype=torch.float32, device=p.C.device)
    return torch.linalg.inv(p.C[..., 9:12, 9:12] + 1e-12 * eye3)


def acc_rw_info(p: Preintegrated):
    eye3 = torch.eye(3, dtype=torch.float32, device=p.C.device)
    return torch.linalg.inv(p.C[..., 12:15, 12:15] + 1e-12 * eye3)


def rw_info6(p: Preintegrated):
    """block-diag(gyro RW info, acc RW info) [..., 6, 6]."""
    g, a = gyro_rw_info(p), acc_rw_info(p)
    z = torch.zeros_like(g)
    return torch.cat([torch.cat([g, z], dim=-1), torch.cat([z, a], dim=-1)], dim=-2)


# ---------------------------------------------------------------------------
# Closed-form Jacobians (EdgeInertial / EdgeInertialGS::linearizeOplus,
# G2oTypes.cc): the derivatives of the residuals above in the vertex
# tangents, pose tangent (dt, dphi) with R <- R Exp(dphi), t <- t + R dt.
# One edge, vmappable; forward-mode differentiation of the same residuals
# gives the same matrices (tests/test_torch_imu.py). The card runs a few
# dozen small kernels for them where jacfwd runs a few hundred.
# ---------------------------------------------------------------------------

def _eye3(like):
    return torch.eye(3, dtype=like.dtype, device=like.device)


def _inv_right_jacobian(w):
    """J_r^-1(w) = I + [w]x / 2 + c [w]x^2 with c = 1/t^2 - (1 + cos t) /
    (2 t sin t), t = |w|; below t = 0.1 its series 1/12 + t^2/720 +
    t^4/30240. (lie.so3_right_jacobian_inv mixes the guarded angle of
    lie._theta, t - 1e-8, into the closed form, as the JAX function does:
    at t ~ 1e-4 its c is off by ~1e5, a ~3e-4 error in the Jacobian.)"""
    t2 = torch.sum(w * w, dim=-1, keepdim=True)
    small = t2 < 1e-2
    t = torch.sqrt(torch.where(small, torch.ones_like(t2), t2))
    c = torch.where(small, 1.0 / 12.0 + t2 / 720.0 + t2 * t2 / 30240.0,
                    1.0 / (t * t) - (1.0 + torch.cos(t)) / (2.0 * t * torch.sin(t)))
    W = lie.hat(w)
    return _eye3(w) + 0.5 * W + c[..., None] * (W @ W)


def _inertial_common(pose1, bg, ba, pose2, data):
    """Terms both residuals and their Jacobians share: (dt, er, the
    corrected dV / dP, invJr, R1T, the er Jacobians in dphi1 and bg), with
    the residual's own ops, so the residuals come out the same."""
    dt = data["dT"][..., None]
    dbg = bg["b"] - data["bg0"]
    dba = ba["b"] - data["ba0"]
    phi_b = _mv(data["JRg"], dbg)
    dR = data["dR"] @ lie.so3_exp(phi_b)
    dV = data["dV"] + _mv(data["JVg"], dbg) + _mv(data["JVa"], dba)
    dP = data["dP"] + _mv(data["JPg"], dbg) + _mv(data["JPa"], dba)
    R1T = pose1["R"].transpose(-1, -2)
    eR = dR.transpose(-1, -2) @ R1T @ pose2["R"]
    er = lie.so3_log(eR)
    invJr = _inv_right_jacobian(er)
    J_er_phi1 = -invJr @ pose2["R"].transpose(-1, -2) @ pose1["R"]
    J_er_bg = -invJr @ eR.transpose(-1, -2) @ lie.so3_right_jacobian(phi_b) @ data["JRg"]
    return dt, er, dV, dP, invJr, R1T, J_er_phi1, J_er_bg


def _stack_rows(*blocks):
    """[er; ev; ep] row blocks of 3 into one [9, n] matrix."""
    return torch.cat(blocks, dim=-2)


def inertial_jacobians(pose1, vel1, bg, ba, pose2, vel2, data):
    """(r [9], (J_pose1 [9,6], J_vel1 [9,3], J_bg [9,3], J_ba [9,3], J_pose2
    [9,6], J_vel2 [9,3])) of inertial_residual."""
    dt, er, dV, dP, invJr, R1T, J_er_phi1, J_er_bg = _inertial_common(pose1, bg, ba, pose2,
                                                                       data)
    g = _gvec(dt)
    a_v = _mv(R1T, vel2["v"] - vel1["v"] - g * dt)
    a_p = _mv(R1T, pose2["t"] - pose1["t"] - vel1["v"] * dt - 0.5 * g * dt * dt)
    r = torch.cat([er, a_v - dV, a_p - dP], dim=-1)
    I3, Z3 = _eye3(R1T), torch.zeros_like(R1T)
    J_pose1 = _stack_rows(torch.cat([Z3, J_er_phi1], -1), torch.cat([Z3, lie.hat(a_v)], -1),
                          torch.cat([-I3, lie.hat(a_p)], -1))
    J_vel1 = _stack_rows(Z3, -R1T, -R1T * dt[..., None])
    J_bg = _stack_rows(J_er_bg, -data["JVg"], -data["JPg"])
    J_ba = _stack_rows(Z3, -data["JVa"], -data["JPa"])
    J_pose2 = _stack_rows(torch.cat([Z3, invJr], -1), torch.cat([Z3, Z3], -1),
                          torch.cat([R1T @ pose2["R"], Z3], -1))
    J_vel2 = _stack_rows(Z3, R1T, Z3)
    return r, (J_pose1, J_vel1, J_bg, J_ba, J_pose2, J_vel2)


def inertial_gs_jacobians(pose1, vel1, bg, ba, pose2, vel2, gdir, scale, data):
    """(r [9], Jacobians in the 8 slots of inertial_gs_residual: pose1,
    vel1, bg, ba, pose2, vel2, gdir [9,2], scale [9,1])."""
    dt, er, dV, dP, invJr, R1T, J_er_phi1, J_er_bg = _inertial_common(pose1, bg, ba, pose2,
                                                                       data)
    gI = _gvec(dt)
    g = _mv(gdir["R"], gI)
    s = scale["s"]
    dv = vel2["v"] - vel1["v"]
    dp = pose2["t"] - pose1["t"] - vel1["v"] * dt
    a_v = _mv(R1T, s * dv - g * dt)
    a_p = _mv(R1T, s * dp - 0.5 * g * dt * dt)
    r = torch.cat([er, a_v - dV, a_p - dP], dim=-1)
    I3, Z3 = _eye3(R1T), torch.zeros_like(R1T)
    sR1T = s[..., None] * R1T
    J_pose1 = _stack_rows(torch.cat([Z3, J_er_phi1], -1), torch.cat([Z3, lie.hat(a_v)], -1),
                          torch.cat([-s[..., None] * I3, lie.hat(a_p)], -1))
    J_vel1 = _stack_rows(Z3, -sR1T, -sR1T * dt[..., None])
    J_bg = _stack_rows(J_er_bg, -data["JVg"], -data["JPg"])
    J_ba = _stack_rows(Z3, -data["JVa"], -data["JPa"])
    J_pose2 = _stack_rows(torch.cat([Z3, invJr], -1), torch.cat([Z3, Z3], -1),
                          torch.cat([sR1T @ pose2["R"], Z3], -1))
    J_vel2 = _stack_rows(Z3, sR1T, Z3)
    # g <- Rwg Exp(d0, d1, 0) gI: dg / dd = -Rwg [gI]x, its first two columns
    dg = -(gdir["R"] @ lie.hat(gI))[..., :2]
    Z32 = torch.zeros_like(dg)
    J_gdir = _stack_rows(Z32, -(R1T @ dg) * dt[..., None], -(R1T @ dg) * (0.5 * dt * dt)[..., None])
    J_scale = _stack_rows(torch.zeros_like(a_v[..., None]), _mv(sR1T, dv)[..., None],
                          _mv(sR1T, dp)[..., None])
    return r, (J_pose1, J_vel1, J_bg, J_ba, J_pose2, J_vel2, J_gdir, J_scale)


def bias_prior_jacobians(b, data):
    """(r [3], (I,)) of bias_prior_residual."""
    r = bias_prior_residual(b, data)
    return r, (_eye3(r).expand(r.shape[:-1] + (3, 3)),)


def prior_pose_imu_jacobian(pose, data):
    """[15, 15] Jacobian of prior_pose_imu_residual in the state tangent
    (dt, dphi, dv, dbg, dba); the state's own residual is computed by the
    caller."""
    er = lie.so3_log(data["R0"].transpose(-1, -2) @ pose["R"])
    I3, Z3 = _eye3(er), torch.zeros_like(pose["R"])
    rows = [torch.cat([Z3, _inv_right_jacobian(er), Z3, Z3, Z3], -1),
            torch.cat([pose["R"], Z3, Z3, Z3, Z3], -1),
            torch.cat([Z3, Z3, I3, Z3, Z3], -1),
            torch.cat([Z3, Z3, Z3, I3, Z3], -1),
            torch.cat([Z3, Z3, Z3, Z3, I3], -1)]
    return torch.cat(rows, dim=-2)
