"""Inertial initialization (port of orb_slam3_tpu/imu/initialization.py).

`LocalMapping::InitializeIMU` (`LocalMapping.cc:1173-1427`) and
`Optimizer::InertialOptimization` (`Optimizer.cc:3042-3226`): from a
visually tracked keyframe chain and its preintegrated intervals, estimate
the gravity direction, the scale, the velocities and the biases with the
visual poses fixed (EdgeInertialGS factors), for the caller's gauge
transform (`Map::ApplyScaledRotation`).

`linear_alignment` is the JAX package's closed-form, errors-in-variables
alignment in float64 numpy on the host after one read of its inputs, as
there. `inertial_only_optimization` runs the port's dense LM engine with
the factors' closed-form Jacobians (the JAX engine differentiates). The
JAX package pads the chain to a length bucket so that XLA compiles one
program per bucket; torch compiles nothing, so the chain runs at its own
length (the pads were fixed vertices and masked edges).
"""

from __future__ import annotations

import numpy as np
import torch

from ..lm import dense
from ..lm.problem import EdgeBatch, Problem, VertexBlock
from ..ops import lie
from . import factors
from . import preintegration as pre
from .preintegration import GRAVITY


def initial_gravity_estimate(R_wb, dV):
    """Gravity direction from the mean preintegrated velocity change
    (`LocalMapping.cc:1228-1252`: dirG = -sum(Rwb dV)); returns Rwg.
    R_wb [E, 3, 3] (poses at the interval starts), dV [E, 3]."""
    dirG = -torch.einsum("eij,ej->i", R_wb, dV)
    dirG = dirG / torch.clamp(torch.linalg.norm(dirG), min=1e-9)
    gI = torch.tensor([0.0, 0.0, -1.0], dtype=torch.float32, device=dV.device)
    v = torch.linalg.cross(gI, dirG)
    nv = torch.linalg.norm(v)
    ang = torch.atan2(nv, torch.dot(gI, dirG))
    return lie.so3_exp(v / torch.clamp(nv, min=1e-9) * ang)


def linear_alignment(R_wb, t_wb, preints: pre.Preintegrated, max_trim: int = 2):
    """Closed-form visual-inertial alignment with the noisy visual
    displacement as the observation (unbiased least squares), in visual
    units: q = 1/s, the keyframe velocities w_i and the visual gravity h
    (magnitude G/s), from

        ep_i: dp_i - w_i dT - 0.5 h dT^2 - q R_i dP_i = n_i
        ev_i: w_{i+1} - w_i - h dT - q R_i dV_i       = 0   (weighted 10x)

    Up to `max_trim` position equations with a residual over 4x the median
    are dropped and the system solved again. Returns (scale = G / |h|,
    scale_q = 1 / q, Rwg [3, 3], velocities [K, 3] in visual units) — see
    the JAX function's docstring for why this and not the reference's
    EdgeInertialGS starts the MAP."""
    dev = R_wb.device
    R, p, dT_all, dV_all, dP_all = (
        a.to(torch.float64).cpu().numpy()
        for a in (R_wb, t_wb, preints.dT, preints.dV, preints.dP))
    Kn = R.shape[0]
    n_e = Kn - 1
    nx = 3 * Kn + 4          # w (3K), h (3), q (1)
    W_EV = 10.0
    A = np.zeros((6 * n_e, nx))
    rhs = np.zeros(6 * n_e)
    I3 = np.eye(3)
    for i in range(n_e):
        dT, dV, dP = dT_all[i], dV_all[i], dP_all[i]
        r0 = 6 * i
        A[r0:r0 + 3, 3 * i:3 * i + 3] = I3 * dT
        A[r0:r0 + 3, 3 * Kn:3 * Kn + 3] = I3 * (0.5 * dT * dT)
        A[r0:r0 + 3, 3 * Kn + 3] = R[i] @ dP
        rhs[r0:r0 + 3] = p[i + 1] - p[i]
        r1 = r0 + 3
        A[r1:r1 + 3, 3 * (i + 1):3 * (i + 1) + 3] = I3 * W_EV
        A[r1:r1 + 3, 3 * i:3 * i + 3] = -I3 * W_EV
        A[r1:r1 + 3, 3 * Kn:3 * Kn + 3] = -I3 * (dT * W_EV)
        A[r1:r1 + 3, 3 * Kn + 3] = -(R[i] @ dV) * W_EV
    ep_w = np.ones(n_e)
    for _ in range(max_trim + 1):
        Aw, rw = A.copy(), rhs.copy()
        for i in range(n_e):
            if ep_w[i] == 0.0:
                Aw[6 * i:6 * i + 3] = 0.0
                rw[6 * i:6 * i + 3] = 0.0
        x, *_ = np.linalg.lstsq(Aw, rw, rcond=None)
        if int(ep_w.sum()) <= max(4, n_e - max_trim):
            break
        res = (A @ x - rhs).reshape(n_e, 6)[:, :3]
        r_ep = np.where(ep_w > 0, np.linalg.norm(res, axis=1), 0.0)
        worst = int(np.argmax(r_ep))
        med = float(np.median(r_ep[ep_w > 0]))
        if r_ep[worst] > 4.0 * max(med, 1e-9):
            ep_w[worst] = 0.0
        else:
            break
    h = x[3 * Kn:3 * Kn + 3]
    q = float(x[-1])
    nh = float(np.linalg.norm(h))
    scale = GRAVITY / max(nh, 1e-9)
    scale_q = 1.0 / q if abs(q) > 1e-9 else np.inf
    # Rwg rotating [0, 0, -G] onto the visual gravity direction h
    gI, gn = np.array([0.0, 0.0, -1.0]), h / max(nh, 1e-9)
    v = np.cross(gI, gn)
    nv = float(np.linalg.norm(v))
    ang = float(np.arctan2(nv, gI @ gn))
    axis = v / nv if nv > 1e-9 else np.array([1.0, 0.0, 0.0])
    Rwg = lie.so3_exp(torch.as_tensor(axis * ang, dtype=torch.float32, device=dev))
    v_vis = torch.as_tensor(x[:3 * Kn].reshape(Kn, 3), dtype=torch.float32, device=dev)
    return scale, scale_q, Rwg, v_vis


def inertial_only_optimization(R_wb, t_wb, preints: pre.Preintegrated,
                               prior_gyro: float = 1e2, prior_acc: float = 1e10,
                               fix_scale: bool = False, iters: int = 60,
                               bg0=None, ba0=None, fix_bias: bool = False,
                               s0=None, Rwg0=None, v0=None, fix_velocities: bool = False):
    """MAP estimate of (scale, Rwg, keyframe velocities, shared biases) with
    the poses fixed (InertialOptimization, `Optimizer.cc:3042`:
    EdgeInertialGS with GDir and Scale vertices, bias priors), by dense LM
    (`iters` iterations, lambda0 1e-2).

    R_wb / t_wb [K, 3, 3] / [K, 3]: world-from-body keyframe poses
    (visual, up to scale); preints: stacked Preintegrated with leading dim
    K-1 (interval i -> i+1). bg0 / ba0 warm-start the biases (the windows
    must be integrated at the same biases); fix_bias freezes both (the
    scale and gravity-only variant of ScaleRefinement, `Optimizer.cc:
    3389`); s0 / Rwg0 / v0 warm-start scale, gravity and velocities;
    fix_velocities frees only gravity and scale. Returns dict(scale 0-dim,
    Rwg, bg, ba, velocities [K, 3], stats)."""
    dev = R_wb.device
    f32 = dict(dtype=torch.float32, device=dev)
    Kn = R_wb.shape[0]
    n_e = Kn - 1
    bg0 = torch.zeros((1, 3), **f32) if bg0 is None else torch.as_tensor(bg0, **f32).reshape(1, 3)
    ba0 = torch.zeros((1, 3), **f32) if ba0 is None else torch.as_tensor(ba0, **f32).reshape(1, 3)
    if v0 is None:
        # finite differences; the last keyframe repeats the previous one
        v_mid = (t_wb[1:] - t_wb[:-1]) / torch.clamp(preints.dT[:, None], min=1e-3)
        v0 = torch.cat([v_mid, v_mid[-1:]], dim=0)
    if Rwg0 is None:
        Rwg0 = initial_gravity_estimate(R_wb[:-1], preints.dV)
    s_init = torch.ones((1, 1), **f32) if s0 is None else torch.full((1, 1), float(s0), **f32)

    blocks = {
        "pose": factors.make_vipose_block(R_wb, t_wb, torch.ones(Kn, dtype=torch.bool,
                                                                 device=dev)),
        # fix_velocities: ScaleRefinement frees only GDir and Scale
        "vel": factors.make_vec3_block(v0, torch.full((Kn,), fix_velocities,
                                                      dtype=torch.bool, device=dev)),
        "bg": VertexBlock(state={"b": bg0}, fixed=torch.full((1,), fix_bias, device=dev),
                          tangent_dim=3, retract=factors.vec3_retract_b),
        "ba": VertexBlock(state={"b": ba0}, fixed=torch.full((1,), fix_bias, device=dev),
                          tangent_dim=3, retract=factors.vec3_retract_b),
        "gdir": factors.make_gdir_block(Rwg0[None], torch.zeros(1, dtype=torch.bool,
                                                               device=dev)),
        "scale": factors.make_scale_block(s_init, torch.full((1,), fix_scale, device=dev)),
    }
    data, info = factors.preint_edge_data(preints)
    # one global cost scale: preintegration informations reach 1e8 and more
    # over short windows, which f32 normal equations cannot hold (g2o runs
    # double); the optimum does not depend on it
    c = torch.clamp(torch.diagonal(info, dim1=-2, dim2=-1).max(), min=1e-12)
    info = info / c
    c = float(c)
    src = torch.arange(n_e, dtype=torch.int32, device=dev)
    zeros = torch.zeros(n_e, dtype=torch.int32, device=dev)
    one = torch.zeros(1, dtype=torch.int32, device=dev)
    gs_edge = EdgeBatch(
        indices=(src, src, zeros, zeros, src + 1, src + 1, zeros, zeros), data=data,
        info=info, mask=torch.ones(n_e, dtype=torch.bool, device=dev),
        vertex_blocks=("pose", "vel", "bg", "ba", "pose", "vel", "gdir", "scale"),
        residual_dim=9, residual=factors.inertial_gs_residual,
        jacobian=factors.inertial_gs_jacobians)

    def prior(block, weight):
        return EdgeBatch(indices=(one,), data={"prior": torch.zeros((1, 3), **f32)},
                         info=torch.full((1,), weight / c, **f32),
                         mask=torch.ones(1, dtype=torch.bool, device=dev),
                         vertex_blocks=(block,), residual_dim=3,
                         residual=factors.bias_prior_residual,
                         jacobian=factors.bias_prior_jacobians)

    problem = Problem(blocks=blocks, edges=(gs_edge, prior("bg", prior_gyro),
                                            prior("ba", prior_acc)))
    solved, stats = dense.solve(problem, num_iters=iters, lam0=1e-2)
    out = solved.blocks
    return {"scale": out["scale"].state["s"][0, 0], "Rwg": out["gdir"].state["R"][0],
            "bg": out["bg"].state["b"][0], "ba": out["ba"].state["b"][0],
            "velocities": out["vel"].state["v"], "stats": stats}
