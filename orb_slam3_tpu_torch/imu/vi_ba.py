"""Visual-inertial bundle adjustment on the Schur engine (port of
orb_slam3_tpu/imu/vi_ba.py).

`Optimizer::LocalInertialBA` (`Optimizer.cc:2383-2958`) and
`FullInertialBA` (`:392-811`): a temporal keyframe window whose every
keyframe is a 15-DoF body state {Rwb, twb, v, bg, ba} (the pose with the
reference's right-multiplicative update, `G2oTypes.h:74-110`), with visual
reprojections, the preintegrated inertial chain and the bias random walks.
On `lm/schur` the state is the camera block: visual edges touch its pose
slice (the rest of their Jacobian is zero), the inertial chain, the random
walks and the first keyframe's bias prior are camera-camera factors
assembled densely into Hcc, and the landmarks are eliminated as in the
visual BA. Every edge carries its closed-form Jacobian (g2o's
linearizeOplus; the JAX engine differentiates): on the card forward-mode
over the 15-DoF tangent was most of the BA's time.

Visual curvatures (~1e-3 after the cost scaling below) and inertial ones
(~1) meet in one f32 reduced system; `schur._schur_solve` refines its
Cholesky solve twice, and TF32 stays off (`device.init_cuda`).
"""

from __future__ import annotations

import torch

from ..frontend import camera as cam_mod
from ..lm import schur
from ..lm.problem import EdgeBatch, VertexBlock
from ..ops import lie, robust
from . import factors


def vi_cam_retract(state, delta):
    """15-dim tangent: (dt, dphi) right-multiplicative on (Rwb, twb), then
    additive velocity, gyro bias and acc bias."""
    R, t = lie.se3_rplus(state["R"], state["t"], delta[..., :6])
    return {"R": R, "t": t, "v": state["v"] + delta[..., 6:9],
            "bg": state["bg"] + delta[..., 9:12], "ba": state["ba"] + delta[..., 12:15]}


def make_vi_cam_block(Rwb, twb, vel, bg, ba, fixed):
    return VertexBlock(state={"R": Rwb, "t": twb, "v": vel, "bg": bg, "ba": ba},
                       fixed=fixed, tangent_dim=15, retract=vi_cam_retract)


def make_vi_obs_residual(kind: int, K8, Rbc, tbc):
    """Reprojection from the 15-DoF body state through the body-camera
    extrinsics (EdgeMono); data = {"uv": [2]}."""

    def residual(cam_state, x, data):
        Rwc = cam_state["R"] @ Rbc
        twc = (cam_state["R"] @ tbc[..., None])[..., 0] + cam_state["t"]
        Rcw, tcw = lie.se3_inv(Rwc, twc)
        return data["uv"] - cam_mod.project(kind, K8, lie.se3_apply(Rcw, tcw, x))

    return residual


def make_vi_obs_jacobian(kind: int, K8, Rbc, tbc):
    """The closed form of make_vi_obs_residual's Jacobians for a pinhole
    camera, (r [2], Jc [2, 15], Jl [2, 3]); None for another camera (the
    engine differentiates). With Xb = R^T (x - t) the point in the body
    frame, dXb = -dt + [Xb]x dphi and Xc = Rbc^T (Xb - tbc)."""
    if kind != cam_mod.PINHOLE:
        return None
    residual = make_vi_obs_residual(kind, K8, Rbc, tbc)

    def jacobian(cam_state, x, data):
        R, t = cam_state["R"], cam_state["t"]
        Rcw = Rbc.transpose(-1, -2) @ R.transpose(-1, -2)
        Xb = (R.transpose(-1, -2) @ (x - t)[..., None])[..., 0]
        Xc = (Rbc.transpose(-1, -2) @ (Xb - tbc)[..., None])[..., 0]
        z = torch.where(Xc[..., 2:].abs() < 1e-9, 1e-9, Xc[..., 2:])
        inv_z = 1.0 / z
        zero = torch.zeros_like(inv_z)
        Jp = torch.stack([
            torch.cat([K8[0:1] * inv_z, zero, -K8[0:1] * Xc[..., 0:1] * inv_z * inv_z], -1),
            torch.cat([zero, K8[1:2] * inv_z, -K8[1:2] * Xc[..., 1:2] * inv_z * inv_z], -1),
        ], dim=-2)
        dXb = torch.cat([-torch.eye(3, dtype=x.dtype, device=x.device), lie.hat(Xb)], dim=-1)
        Jc6 = -Jp @ Rbc.transpose(-1, -2) @ dXb
        Jc = torch.cat([Jc6, torch.zeros(Jc6.shape[:-1] + (9,), dtype=x.dtype, device=x.device)],
                       dim=-1)
        return residual(cam_state, x, data), Jc, -Jp @ Rcw

    return jacobian


def _vi_inertial_residual(cam1, cam2, data):
    """EdgeInertial between two body states, both biases from cam1 (the
    reference's b1)."""
    return factors.inertial_residual(
        {"R": cam1["R"], "t": cam1["t"]}, {"v": cam1["v"]}, {"b": cam1["bg"]},
        {"b": cam1["ba"]}, {"R": cam2["R"], "t": cam2["t"]}, {"v": cam2["v"]}, data)


def _split15(cam):
    return ({"R": cam["R"], "t": cam["t"]}, {"v": cam["v"]}, {"b": cam["bg"]},
            {"b": cam["ba"]})


def _vi_inertial_jacobian(cam1, cam2, data):
    """(r [9], (J_cam1 [9, 15], J_cam2 [9, 15])) in closed form."""
    p1, v1, bg, ba = _split15(cam1)
    p2, v2, _, _ = _split15(cam2)
    r, (Jp1, Jv1, Jbg, Jba, Jp2, Jv2) = factors.inertial_jacobians(p1, v1, bg, ba, p2, v2, data)
    return r, (torch.cat([Jp1, Jv1, Jbg, Jba], -1),
               torch.cat([Jp2, Jv2, torch.zeros_like(Jbg), torch.zeros_like(Jba)], -1))


def _bias_rw_residual(cam1, cam2, data):
    """EdgeGyroRW and EdgeAccRW stacked: 6-dim."""
    return torch.cat([cam2["bg"] - cam1["bg"], cam2["ba"] - cam1["ba"]], dim=-1)


def _bias_selector(like):
    """[6, 15]: the (bg, ba) rows of a 15-DoF tangent."""
    eye6 = torch.eye(6, dtype=like.dtype, device=like.device)
    return torch.cat([torch.zeros((6, 9), dtype=like.dtype, device=like.device), eye6], -1)


def _bias_rw_jacobian(cam1, cam2, data):
    r = _bias_rw_residual(cam1, cam2, data)
    S = _bias_selector(r)
    return r, (-S, S)


def build_inertial_chain_edges(preint_data, preint_info9, rw_info6, src, dst, valid):
    """EdgeBatches of the preintegration chain and the bias random walks:
    preint_data stacked as factors.preint_edge_data gives it, info9
    [E, 9, 9], rw_info6 [E, 6, 6] = block-diag(gyro RW, acc RW)."""
    inertial = EdgeBatch(indices=(src, dst), data=preint_data, info=preint_info9, mask=valid,
                         vertex_blocks=("cam", "cam"), residual_dim=9,
                         residual=_vi_inertial_residual, jacobian=_vi_inertial_jacobian)
    bias_rw = EdgeBatch(indices=(src, dst), data={"dummy": torch.zeros_like(src,
                                                                             dtype=torch.float32)},
                        info=rw_info6, mask=valid, vertex_blocks=("cam", "cam"),
                        residual_dim=6, residual=_bias_rw_residual, jacobian=_bias_rw_jacobian)
    return inertial, bias_rw


def _bias_prior_residual(cam, data):
    """EdgePriorAcc / EdgePriorGyro (`G2oTypes.h:768-814`): zero-mean priors
    on the first keyframe's biases (FullInertialBA's staged init)."""
    return torch.cat([cam["bg"], cam["ba"]], dim=-1)


def _bias_prior_jacobian(cam, data):
    r = _bias_prior_residual(cam, data)
    return r, (_bias_selector(r),)


def local_inertial_ba(kind: int, K8, Rbc, tbc, Rwb, twb, vel, bg, ba, cam_fixed,
                      points, point_fixed, cam_idx, lm_idx, uv, inv_sigma2, obs_mask,
                      preint_data, preint_info9, rw_info6, chain_src, chain_dst, chain_valid,
                      iters: int = 8, bias_prior=None):
    """Windowed VI-BA: W body states, L landmarks (the whole arena, with
    point_fixed outside the window), E visual edges, W-1 chain edges.

    Every information is divided by the largest diagonal entry of the
    inertial informations (at least 1), the Huber threshold with it (f32
    conditioning, see imu/initialization.py). bias_prior = (priorG, priorA)
    adds zero-mean bias priors on the first camera (FullInertialBA's
    staging: 1e2 / 1e10 at init, 1 / 1e5 at VIBA1; None or zeros add a
    zero-information edge). Returns (Rwb, twb, vel, bg, ba, points, stats)."""
    dev = points.device
    f32 = dict(dtype=torch.float32, device=dev)
    info_scale = torch.clamp(torch.diagonal(preint_info9, dim1=-2, dim2=-1).max(), min=1.0)
    if bias_prior is None:
        bias_prior = torch.zeros((2,), **f32)
    bias_prior = torch.as_tensor(bias_prior, **f32)
    cam_edges = build_inertial_chain_edges(preint_data, preint_info9 / info_scale,
                                           rw_info6 / info_scale, chain_src, chain_dst,
                                           chain_valid)
    info6 = torch.diag(torch.cat([bias_prior[0].expand(3), bias_prior[1].expand(3)]))
    prior = EdgeBatch(indices=(torch.zeros((1,), dtype=torch.int32, device=dev),),
                      data={"dummy": torch.zeros((1,), **f32)},
                      info=(info6 / info_scale)[None],
                      mask=torch.ones((1,), dtype=torch.bool, device=dev),
                      vertex_blocks=("cam",), residual_dim=6, residual=_bias_prior_residual,
                      jacobian=_bias_prior_jacobian)
    bap = schur.BAProblem(
        cams=make_vi_cam_block(Rwb, twb, vel, bg, ba, cam_fixed), points=points,
        point_fixed=point_fixed, cam_idx=cam_idx, lm_idx=lm_idx, obs_data={"uv": uv},
        obs_info=inv_sigma2 / info_scale, obs_mask=obs_mask, cam_edges=cam_edges + (prior,),
        residual_dim=2, residual=make_vi_obs_residual(kind, K8, Rbc, tbc),
        jacobian=make_vi_obs_jacobian(kind, K8, Rbc, tbc),
        # the Huber threshold in the scaled chi2: chi2' = chi2 / scale
        huber_delta=torch.sqrt(robust.CHI2_2DOF / info_scale),
    )
    solved, stats = schur.solve(bap, num_iters=iters, lam0=1e-4)
    st = solved.cams.state
    return st["R"], st["t"], st["v"], st["bg"], st["ba"], solved.points, stats
