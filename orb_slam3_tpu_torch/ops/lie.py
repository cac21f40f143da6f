"""SO(3) / SE(3) over trailing dimensions (port of the SE3 subset of
orb_slam3_tpu/ops/lie.py).

Rotations are `[..., 3, 3]` matrices, translations `[..., 3]` vectors.
Twists are ordered (rho, phi) = (translation, rotation) like Sophus; the
visual edges' left-multiplicative update is `se3_lplus`, the inertial
vertices' right-multiplicative one `se3_rplus`. Small-angle branches use the
same guarded formulas as the JAX package so both give the same f32 values.
Sim(3) and quaternions arrive with the slices that need them.
"""

from __future__ import annotations

import math

import torch

_EPS = 1e-8


def _safe(x, cutoff=_EPS):
    """(is_small, x with 1 where |x| < cutoff): guards a division whose
    small-|x| branch is replaced by torch.where."""
    is_small = x.abs() < cutoff
    return is_small, torch.where(is_small, torch.ones_like(x), x)


def _eye_like(W):
    return torch.eye(3, dtype=W.dtype, device=W.device).expand(W.shape)


def _norm(v, keepdim=False):
    return torch.sqrt(torch.sum(v * v, dim=-1, keepdim=keepdim))


def hat(w):
    """so(3) hat: [..., 3] -> skew-symmetric [..., 3, 3]."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([z, -wz, wy], dim=-1),
            torch.stack([wz, z, -wx], dim=-1),
            torch.stack([-wy, wx, z], dim=-1),
        ],
        dim=-2,
    )


def vee(W):
    """Inverse of hat: [..., 3, 3] -> [..., 3]."""
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], dim=-1)


def _theta(w):
    """(theta, theta2, small, theta guarded, theta2 guarded)."""
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(theta2 + _EPS * _EPS) - _EPS
    small, th2_s = _safe(theta2, 1e-12)
    _, th_s = _safe(theta, 1e-6)
    return theta, theta2, small, th_s, th2_s


def so3_exp(w):
    """Rodrigues: axis-angle [..., 3] -> rotation matrix [..., 3, 3]."""
    theta, theta2, small, th_s, th2_s = _theta(w)
    W = hat(w)
    W2 = W @ W
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(th_s) / th_s)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(th_s)) / th2_s)
    return _eye_like(W) + a[..., None, None] * W + b[..., None, None] * W2


def so3_log(R):
    """Rotation matrix [..., 3, 3] -> axis-angle [..., 3].

    Generic branch theta / (2 sin theta) * vee(R - R^T) with the angle from
    atan2; near pi (cos < -0.9) the axis comes from (R + R^T)/2 - cos I =
    (1 - cos) a a^T and the sign from the skew part.
    """
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    skew = vee(R - R.transpose(-1, -2))
    ss = torch.sum(skew * skew, dim=-1)
    sin_t = 0.5 * torch.sqrt(ss + 1e-24)
    theta = torch.atan2(sin_t, cos_t)

    small_s, sin_s = _safe(sin_t, 1e-6)
    w_generic = skew * torch.where(
        small_s, 0.5 + theta * theta / 12.0, theta / (2.0 * sin_s)
    )[..., None]

    S = (R + R.transpose(-1, -2)) * 0.5
    M = S - cos_t[..., None, None] * _eye_like(R)
    diag = torch.stack([M[..., 0, 0], M[..., 1, 1], M[..., 2, 2]], dim=-1)
    k = torch.argmax(diag, dim=-1)
    idx = k[..., None, None].expand(*k.shape, 1, 3)
    axis_unnorm = torch.gather(M, -2, idx)[..., 0, :]
    norm = _norm(axis_unnorm, keepdim=True)
    axis = axis_unnorm / torch.where(norm < 1e-20, torch.ones_like(norm), norm)
    theta_pi = math.pi - torch.asin(torch.clamp(sin_t, 0.0, 1.0))
    dot = torch.sum(skew * axis, dim=-1, keepdim=True)
    sign = torch.where(dot < 0.0, -torch.ones_like(dot), torch.ones_like(dot))
    w_pi = axis * sign * theta_pi[..., None]

    near_pi = cos_t < -0.9
    return torch.where(near_pi[..., None], w_pi, w_generic)


def so3_left_jacobian(w):
    """Left Jacobian J_l of SO(3): exp(w + dw) ~ exp(J_l dw) exp(w)."""
    theta, theta2, small, th_s, th2_s = _theta(w)
    W = hat(w)
    W2 = W @ W
    th3_s = th2_s * th_s
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(th_s)) / th2_s)
    c = torch.where(
        small, 1.0 / 6.0 - theta2 / 120.0, (th_s - torch.sin(th_s)) / th3_s
    )
    return _eye_like(W) + b[..., None, None] * W + c[..., None, None] * W2


def _left_jacobian_inv(w):
    theta, theta2, small, th_s, th2_s = _theta(w)
    W = hat(w)
    W2 = W @ W
    cot_term = torch.where(
        small,
        1.0 / 12.0 + theta2 / 720.0,
        (1.0 / th2_s) - (1.0 + torch.cos(th_s)) / (2.0 * th_s * torch.sin(th_s)),
    )
    return _eye_like(W) - 0.5 * W + cot_term[..., None, None] * W2


def normalize_rotation(R):
    """Nearest rotation matrix via SVD (g2o NormalizeRotation analogue)."""
    U, _, Vh = torch.linalg.svd(R)
    det = torch.linalg.det(U @ Vh)
    D = torch.cat([torch.ones_like(R[..., :2, 0]), det[..., None]], dim=-1)
    return (U * D[..., None, :]) @ Vh


def se3_exp(xi):
    """Twist [..., 6] (rho, phi) -> (R, t)."""
    rho, phi = xi[..., :3], xi[..., 3:]
    R = so3_exp(phi)
    V = so3_left_jacobian(phi)
    t = (V @ rho[..., None])[..., 0]
    return R, t


def se3_log(R, t):
    """(R, t) -> twist [..., 6] (rho, phi)."""
    phi = so3_log(R)
    Vinv = _left_jacobian_inv(phi)
    rho = (Vinv @ t[..., None])[..., 0]
    return torch.cat([rho, phi], dim=-1)


def se3_mul(Ra, ta, Rb, tb):
    """(Ra, ta) * (Rb, tb)."""
    return Ra @ Rb, (Ra @ tb[..., None])[..., 0] + ta


def se3_inv(R, t):
    Rt = R.transpose(-1, -2)
    return Rt, -(Rt @ t[..., None])[..., 0]


def se3_apply(R, t, X):
    """Transform points X [..., 3]."""
    return (R @ X[..., None])[..., 0] + t


def se3_rplus(R, t, dxi):
    """Right-multiplicative update T <- T exp(dxi) of the inertial vertices
    (ImuCamPose::Update): R <- R Exp(dphi), t <- t + R dt."""
    dt, dphi = dxi[..., :3], dxi[..., 3:]
    t_new = t + (R @ dt[..., None])[..., 0]
    R_new = R @ so3_exp(dphi)
    return R_new, t_new


def se3_lplus(R, t, dxi):
    """Left-multiplicative update T <- exp(dxi) T (g2o SE3Quat::update)."""
    dR, dt = se3_exp(dxi)
    return se3_mul(dR, dt, R, t)
