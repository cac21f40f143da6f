"""SO(3) / SE(3) over trailing dimensions (port of the SE3 subset of
orb_slam3_tpu/ops/lie.py, with the right Jacobian and its inverse that
the IMU preintegration uses).

Rotations are `[..., 3, 3]` matrices, translations `[..., 3]` vectors.
Twists are ordered (rho, phi) = (translation, rotation) like Sophus; the
visual edges' left-multiplicative update is `se3_lplus`, the inertial
vertices' right-multiplicative one `se3_rplus`. Small-angle branches use the
same guarded formulas as the JAX package so both give the same f32 values.
Sim(3) is (R, t, s) acting as X -> s R X + t (g2o `sim3.h`); its scalar
arithmetic runs on [..., 1] slices, as `_theta` does, so that the Sim3
edges differentiate with f32 tangents under jacfwd. Quaternions are
(x, y, z, w) with w >= 0.
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
    """(theta, theta2, small, theta guarded, theta2 guarded), each [..., 1].

    The trailing unit dimension is deliberate: under torch.func.jacfwd a
    0-dim tensor combined with a Python scalar gets a float64 tangent
    (torch 2.13), which then breaks the f32 matmuls of se3_exp."""
    theta2 = torch.sum(w * w, dim=-1, keepdim=True)
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
    return _eye_like(W) + a[..., None] * W + b[..., None] * W2


def so3_log(R):
    """Rotation matrix [..., 3, 3] -> axis-angle [..., 3].

    Generic branch theta / (2 sin theta) * vee(R - R^T) with the angle from
    atan2; near pi (cos < -0.9) the axis comes from (R + R^T)/2 - cos I =
    (1 - cos) a a^T and the sign from the skew part. The angle terms are
    [..., 1] slices (see `_theta`): Sim3 edges differentiate through it.
    """
    trace = (R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2])[..., None]
    cos_t = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    skew = vee(R - R.transpose(-1, -2))
    ss = torch.sum(skew * skew, dim=-1, keepdim=True)
    sin_t = 0.5 * torch.sqrt(ss + 1e-24)
    theta = torch.atan2(sin_t, cos_t)

    small_s, sin_s = _safe(sin_t, 1e-6)
    w_generic = skew * torch.where(small_s, 0.5 + theta * theta / 12.0, theta / (2.0 * sin_s))

    S = (R + R.transpose(-1, -2)) * 0.5
    M = S - cos_t[..., None] * _eye_like(R)
    diag = torch.stack([M[..., 0, 0], M[..., 1, 1], M[..., 2, 2]], dim=-1)
    k = torch.argmax(diag, dim=-1)
    idx = k[..., None, None].expand(*k.shape, 1, 3)
    axis_unnorm = torch.gather(M, -2, idx)[..., 0, :]
    norm = _norm(axis_unnorm, keepdim=True)
    axis = axis_unnorm / torch.where(norm < 1e-20, torch.ones_like(norm), norm)
    theta_pi = math.pi - torch.asin(torch.clamp(sin_t, 0.0, 1.0))
    dot = torch.sum(skew * axis, dim=-1, keepdim=True)
    sign = torch.where(dot < 0.0, -torch.ones_like(dot), torch.ones_like(dot))
    w_pi = axis * sign * theta_pi

    return torch.where(cos_t < -0.9, w_pi, w_generic)


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
    return _eye_like(W) + b[..., None] * W + c[..., None] * W2


def so3_exp_and_right_jacobian(w):
    """(so3_exp(w), so3_right_jacobian(w)) from one set of angle terms: the
    same values as the two calls, with half the kernels (the IMU
    preintegration takes both of every sample)."""
    theta, theta2, small, th_s, th2_s = _theta(w)
    W = hat(w)
    W2 = W @ W
    sin_t, cos_t = torch.sin(th_s), torch.cos(th_s)
    a = torch.where(small, 1.0 - theta2 / 6.0, sin_t / th_s)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - cos_t) / th2_s)
    c = torch.where(small, 1.0 / 6.0 - theta2 / 120.0, (th_s - sin_t) / (th2_s * th_s))
    eye, bW, W2c = _eye_like(W), b[..., None] * W, c[..., None] * W2
    return eye + a[..., None] * W + b[..., None] * W2, eye - bW + W2c


def so3_right_jacobian(w):
    """Right Jacobian J_r(w) = J_l(-w) (IMU::RightJacobianSO3)."""
    return so3_left_jacobian(-w)


def so3_right_jacobian_inv(w):
    """Inverse right Jacobian J_r^-1(w) = J_l^-1(-w)
    (IMU::InverseRightJacobianSO3), equal to the JAX function: like it, the
    closed form takes the guarded angle of `_theta` (t - 1e-8), which
    leaves its second-order term far off at |w| ~ 1e-4; the inertial
    closed-form Jacobians use `imu/factors._inv_right_jacobian`."""
    return _left_jacobian_inv(-w)


def _left_jacobian_inv(w):
    theta, theta2, small, th_s, th2_s = _theta(w)
    W = hat(w)
    W2 = W @ W
    cot_term = torch.where(
        small,
        1.0 / 12.0 + theta2 / 720.0,
        (1.0 / th2_s) - (1.0 + torch.cos(th_s)) / (2.0 * th_s * torch.sin(th_s)),
    )
    return _eye_like(W) - 0.5 * W + cot_term[..., None] * W2


def normalize_rotation(R):
    """Nearest rotation matrix via SVD (g2o NormalizeRotation analogue)."""
    U, _, Vh = torch.linalg.svd(R)
    det = torch.linalg.det(U @ Vh)
    D = torch.cat([torch.ones_like(R[..., :2, 0]), det[..., None]], dim=-1)
    return (U * D[..., None, :]) @ Vh


def nearest_rotation(R, iters: int = 2):
    """The rotation nearest to a matrix that is almost one: the polar factor
    that `normalize_rotation`'s SVD gives, by Newton's iteration X <- (X +
    X^-T) / 2 with X^-T = cofactor(X) / det(X). Elementwise work and no
    solver, so the card runs a few small kernels where the SVD runs cuSOLVER
    and waits for it; from the ~1e-7 drift of an f32 product of rotations
    one step already reaches rounding."""
    X = R
    for _ in range(iters):
        r0, r1, r2 = X[..., 0, :], X[..., 1, :], X[..., 2, :]
        cof = torch.stack([torch.linalg.cross(r1, r2), torch.linalg.cross(r2, r0),
                           torch.linalg.cross(r0, r1)], dim=-2)
        det = torch.sum(r0 * cof[..., 0, :], dim=-1)
        X = 0.5 * (X + cof / det[..., None, None])
    return X


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


# ---------------------------------------------------------------------------
# Sim(3): (R, t, s) acting as X -> s R X + t
# ---------------------------------------------------------------------------

def sim3_mul(Ra, ta, sa, Rb, tb, sb):
    """(Ra, ta, sa) * (Rb, tb, sb); scales are [...] tensors."""
    t = sa[..., None] * (Ra @ tb[..., None])[..., 0] + ta
    return Ra @ Rb, t, sa * sb


def sim3_inv(R, t, s):
    Rt = R.transpose(-1, -2)
    s_inv = 1.0 / s[..., None]
    return Rt, -s_inv * (Rt @ t[..., None])[..., 0], s_inv[..., 0]


def sim3_apply(R, t, s, X):
    return s[..., None] * (R @ X[..., None])[..., 0] + t


def _sim3_V_closed(phi, sigma):
    """V(phi, sigma) = int_0^1 exp(u sigma) exp(u hat(phi)) du in closed
    form (the translation part of Sim(3) exp, Sophus `sim3.hpp`):
    V = A I + B Om + C Om^2 with Om = hat(phi), theta = |phi| and
      A = (e^sigma - 1) / sigma,
      B = I_sin / theta, I_sin = (e^sg (sg sin th - th cos th) + th) / (sg^2 + th^2),
      C = (A - I_cos) / theta^2, I_cos = (e^sg (sg cos th + th sin th) - sg) / (sg^2 + th^2),
    with first-order Taylor branches for small sigma and the theta -> 0
    limits. sigma is [..., 1]."""
    theta, theta2, small_t, th_s, th2_s = _theta(phi)
    small_s, sg_s = _safe(sigma, 1e-6)
    es = torch.exp(sigma)
    Om = hat(phi)
    Om2 = Om @ Om

    A = torch.where(small_s, 1.0 + sigma / 2.0 + sigma * sigma / 6.0, (es - 1.0) / sg_s)
    sin_t, cos_t = torch.sin(th_s), torch.cos(th_s)
    denom = sg_s * sg_s + th2_s
    I_sin = (es * (sg_s * sin_t - th_s * cos_t) + th_s) / denom
    I_cos = (es * (sg_s * cos_t + th_s * sin_t) - sg_s) / denom
    B_gen = torch.where(
        small_s,
        (1.0 - cos_t) / th2_s + sigma * (sin_t - th_s * cos_t) / (th2_s * th_s),
        I_sin / th_s,
    )
    # d/dsigma at sigma = 0 of C: (1/2 - (cos th + th sin th - 1) / th^2) / th^2
    c_sigma = (0.5 * th2_s - (cos_t + th_s * sin_t - 1.0)) / (th2_s * th2_s)
    C_gen = torch.where(
        small_s,
        (th_s - sin_t) / (th2_s * th_s) + sigma * c_sigma,
        (A - I_cos) / th2_s,
    )
    B_small = torch.where(small_s, 0.5 + sigma / 3.0,
                          (es * (sg_s - 1.0) + 1.0) / (sg_s * sg_s))
    C_small = torch.where(small_s, 1.0 / 6.0 + sigma / 8.0,
                          (es * (sg_s * sg_s - 2.0 * sg_s + 2.0) - 2.0) / (2.0 * sg_s ** 3))
    B = torch.where(small_t, B_small, B_gen)
    C = torch.where(small_t, C_small, C_gen)
    return A[..., None] * _eye_like(Om) + B[..., None] * Om + C[..., None] * Om2


def sim3_exp(xi):
    """[..., 7] (rho, phi, sigma) -> (R, t, s)."""
    rho, phi, sigma = xi[..., :3], xi[..., 3:6], xi[..., 6:7]
    R = so3_exp(phi)
    V = _sim3_V_closed(phi, sigma)
    t = (V @ rho[..., None])[..., 0]
    return R, t, torch.exp(sigma)[..., 0]


def _solve3(A, b):
    """A^-1 b for [..., 3, 3] A by Cramer's rule (elementwise). Used where
    jacfwd differentiates under vmap: torch.linalg.solve's forward-mode
    derivative is wrong for every batch element after the first there
    (torch 2.13)."""
    c0, c1, c2 = A[..., :, 0], A[..., :, 1], A[..., :, 2]

    def det(a, b_, c):
        return torch.sum(a * torch.linalg.cross(b_, c), dim=-1, keepdim=True)

    d = det(c0, c1, c2)
    return torch.cat([det(b, c1, c2), det(c0, b, c2), det(c0, c1, b)], dim=-1) / d


def sim3_log(R, t, s):
    """(R, t, s) -> [..., 7] by a 3x3 solve against the closed-form V."""
    phi = so3_log(R)
    sigma = torch.log(s[..., None])
    rho = _solve3(_sim3_V_closed(phi, sigma), t)
    return torch.cat([rho, phi, sigma], dim=-1)


# ---------------------------------------------------------------------------
# Quaternions (x, y, z, w): trajectory export (TUM format)
# ---------------------------------------------------------------------------

def rot_to_quat(R):
    """[..., 3, 3] -> [..., 4] (x, y, z, w), w >= 0: of the four standard
    constructions the one with the largest pivot (trace or a diagonal
    entry)."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def root(x):
        return torch.sqrt(torch.clamp(x, min=1e-12)) * 0.5

    qw0 = root(1.0 + tr)
    q0 = torch.stack([(m21 - m12) / (4 * qw0), (m02 - m20) / (4 * qw0),
                      (m10 - m01) / (4 * qw0), qw0], dim=-1)
    qx1 = root(1.0 + m00 - m11 - m22)
    q1 = torch.stack([qx1, (m01 + m10) / (4 * qx1), (m02 + m20) / (4 * qx1),
                      (m21 - m12) / (4 * qx1)], dim=-1)
    qy2 = root(1.0 - m00 + m11 - m22)
    q2 = torch.stack([(m01 + m10) / (4 * qy2), qy2, (m12 + m21) / (4 * qy2),
                      (m02 - m20) / (4 * qy2)], dim=-1)
    qz3 = root(1.0 - m00 - m11 + m22)
    q3 = torch.stack([(m02 + m20) / (4 * qz3), (m12 + m21) / (4 * qz3), qz3,
                      (m10 - m01) / (4 * qz3)], dim=-1)
    k = torch.argmax(torch.stack([tr, m00, m11, m22], dim=-1), dim=-1)
    q = torch.stack([q0, q1, q2, q3], dim=-2)
    q = torch.gather(q, -2, k[..., None, None].expand(*k.shape, 1, 4))[..., 0, :]
    q = q / _norm(q, keepdim=True)
    return q * torch.where(q[..., 3:4] < 0, -1.0, 1.0)


def quat_to_rot(q):
    """Quaternion [..., 4] (x, y, z, w) -> rotation matrix [..., 3, 3]."""
    q = q / _norm(q, keepdim=True)
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)], dim=-1),
        torch.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)], dim=-1),
        torch.stack([2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)], dim=-1),
    ], dim=-2)
