"""Vertex parameterizations and reprojection residuals for the LM engine
(port of the visual subset of orb_slam3_tpu/lm/edges.py).

Pose vertices hold Tcw as {"R": [N,3,3], "t": [N,3]} with g2o's
left-multiplicative update Tcw <- exp(dxi) Tcw (`se3quat.h::oplusImpl`);
landmarks are Euclidean {"x": [N,3]}. Residuals are written for one edge
and batched by the engine. The mono and stereo reprojection edges, full and
pose-only, and the right-camera (ToBody) edges of a non-rectified stereo
rig are here (`OptimizableTypes.cpp`, `G2oTypes.cc`); the Sim3,
inertial and relative-pose residuals come with the slices that use them.
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


def make_pose_block(R, t, fixed):
    return VertexBlock(state={"R": R, "t": t}, fixed=fixed, tangent_dim=6,
                       retract=se3_retract)


def make_point_block(x, fixed):
    return VertexBlock(state={"x": x}, fixed=fixed, tangent_dim=3, retract=point_retract)


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
