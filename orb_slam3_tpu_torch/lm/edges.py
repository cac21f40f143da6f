"""Vertex parameterizations and reprojection residuals for the LM engine
(port of the visual subset of orb_slam3_tpu/lm/edges.py).

Pose vertices hold Tcw as {"R": [N,3,3], "t": [N,3]} with g2o's
left-multiplicative update Tcw <- exp(dxi) Tcw (`se3quat.h::oplusImpl`);
landmarks are Euclidean {"x": [N,3]}. Residuals are written for one edge
and batched by the engine. The mono and stereo reprojection edges, full and
pose-only, and the right-camera (ToBody) edges of a non-rectified stereo
rig are here (`OptimizableTypes.cpp`, `G2oTypes.cc`), with the Sim3
vertex, the relative SE3 / Sim3 pose-graph edges and the Sim3 point edges
of OptimizeSim3; the inertial residuals are in imu/factors.py.
"""

from __future__ import annotations

import torch

from ..frontend import camera as cam
from ..ops import lie
from .problem import VertexBlock


def se3_retract(state, delta):
    """T <- exp(delta) T (g2o SE3Quat convention)."""
    R, t = lie.se3_lplus(state["R"], state["t"], delta)
    return {"R": R, "t": t}


def point_retract(state, delta):
    return {"x": state["x"] + delta}


def sim3_retract(state, delta):
    """S <- exp(delta) S, delta = (rho, phi, sigma) (g2o VertexSim3Expmap,
    `types_seven_dof_expmap.h`)."""
    dR, dt, ds = lie.sim3_exp(delta)
    R, t, s = lie.sim3_mul(dR, dt, ds, state["R"], state["t"], state["s"])
    return {"R": R, "t": t, "s": s}


def make_pose_block(R, t, fixed):
    return VertexBlock(state={"R": R, "t": t}, fixed=fixed, tangent_dim=6,
                       retract=se3_retract)


def make_point_block(x, fixed):
    return VertexBlock(state={"x": x}, fixed=fixed, tangent_dim=3, retract=point_retract)


def make_sim3_block(R, t, s, fixed):
    return VertexBlock(state={"R": R, "t": t, "s": s}, fixed=fixed, tangent_dim=7,
                       retract=sim3_retract)


def make_mono_residual(kind: int):
    """obs - project(Tcw Xw) (EdgeSE3ProjectXYZ). data = {"uv": [2], "K": [8]}."""

    def residual(pose, point, data):
        Xc = lie.se3_apply(pose["R"], pose["t"], point["x"])
        return data["uv"] - cam.project(kind, data["K"], Xc)

    return residual


def make_mono_pose_only_residual(kind: int):
    """Motion-only edge with the landmark as data (EdgeSE3ProjectXYZOnlyPose).
    data = {"uv": [2], "K": [8], "Xw": [3]}."""

    def residual(pose, data):
        Xc = lie.se3_apply(pose["R"], pose["t"], data["Xw"])
        return data["uv"] - cam.project(kind, data["K"], Xc)

    return residual


def make_tobody_residual(kind: int):
    """Right-camera reprojection edge of a non-rectified (fisheye) rig:
    obs_r - project_r(T_rl Tcw Xw) with the fixed left-to-right extrinsics;
    the vertex is the left camera's pose (EdgeSE3ProjectXYZToBody,
    `OptimizableTypes.h:59-87`). data = {"uv": [2], "K": [8] (right
    intrinsics), "R_rl": [3,3], "t_rl": [3]}."""

    def residual(pose, point, data):
        Xl = lie.se3_apply(pose["R"], pose["t"], point["x"])
        return data["uv"] - cam.project(kind, data["K"], data["R_rl"] @ Xl + data["t_rl"])

    return residual


def make_tobody_pose_only_residual(kind: int):
    """Motion-only variant with the landmark as data
    (EdgeSE3ProjectXYZOnlyPoseToBody). data = {"uv": [2], "K": [8],
    "Xw": [3], "R_rl": [3,3], "t_rl": [3]}."""

    def residual(pose, data):
        Xl = lie.se3_apply(pose["R"], pose["t"], data["Xw"])
        return data["uv"] - cam.project(kind, data["K"], data["R_rl"] @ Xl + data["t_rl"])

    return residual


def _stereo(kind, Xc, data):
    uv = cam.project(kind, data["K"], Xc)
    z = torch.where(torch.abs(Xc[2]) < 1e-9, torch.full_like(Xc[2], 1e-9), Xc[2])
    return data["uvr"] - torch.stack([uv[0], uv[1], uv[0] - data["bf"] / z])


def make_stereo_residual(kind: int):
    """3-dim (uL, v, uR) rectified-stereo residual with uR = uL - bf/z
    (EdgeStereoSE3ProjectXYZ, `Optimizer.cc:1325-1352`).
    data = {"uvr": [3], "K": [8], "bf": []}."""

    def residual(pose, point, data):
        return _stereo(kind, lie.se3_apply(pose["R"], pose["t"], point["x"]), data)

    return residual


def make_stereo_pose_only_residual(kind: int):
    """Motion-only stereo edge. data = {"uvr": [3], "K": [8], "bf": [], "Xw": [3]}."""

    def residual(pose, data):
        return _stereo(kind, lie.se3_apply(pose["R"], pose["t"], data["Xw"]), data)

    return residual


def relative_se3_residual(pose_i, pose_j, data):
    """log(T_ji_meas T_i T_j^-1), 6-dim: poses are Tcw and the measured
    constraint is T_ji = T_j T_i^-1."""
    Rj_inv, tj_inv = lie.se3_inv(pose_j["R"], pose_j["t"])
    Ra, ta = lie.se3_mul(pose_i["R"], pose_i["t"], Rj_inv, tj_inv)
    Re, te = lie.se3_mul(data["R_ji"], data["t_ji"], Ra, ta)
    return lie.se3_log(Re, te)


def relative_sim3_residual(sim_i, sim_j, data):
    """7-dim essential-graph edge log(S_ji_meas S_i S_j^-1) (g2o EdgeSim3,
    OptimizeEssentialGraph, `Optimizer.cc:1501-1782`)."""
    Rj_i, tj_i, sj_i = lie.sim3_inv(sim_j["R"], sim_j["t"], sim_j["s"])
    Ra, ta, sa = lie.sim3_mul(sim_i["R"], sim_i["t"], sim_i["s"], Rj_i, tj_i, sj_i)
    Re, te, se = lie.sim3_mul(data["R_ji"], data["t_ji"], data["s_ji"], Ra, ta, sa)
    return lie.sim3_log(Re, te, se)


def make_sim3_point_residual(kind: int, inverse: bool):
    """OptimizeSim3's edges (`Optimizer.cc:2115`): the other keyframe's
    matched point, fixed in its camera frame, projected through S12 (or
    S12^-1 with `inverse`). data = {"uv": [2], "K": [8], "Xc": [3]}."""

    def residual(sim, data):
        R, t, s = sim["R"], sim["t"], sim["s"]
        if inverse:
            R, t, s = lie.sim3_inv(R, t, s)
        return data["uv"] - cam.project(kind, data["K"], lie.sim3_apply(R, t, s, data["Xc"]))

    return residual
