"""On-manifold IMU preintegration with covariance and bias Jacobians (port
of orb_slam3_tpu/imu/preintegration.py).

`IMU::Preintegrated` (`ImuTypes.cc:177-235` IntegrateNewMeasurement,
`ImuTypes.h:143-251`): elapsed dT, the 15x15 covariance C ordered (theta,
v, p, bg, ba), the deltas dR / dV / dP and the bias Jacobians JRg, JVg,
JVa, JPg, JPa, integrated in the reference's order (position before
velocity before rotation, the old dR in the dP / dV update).

The JAX package scans a capacity-padded buffer with a validity mask. Here
`integrate` is a Python loop over the buffer's slots, each step selected by
`torch.where` on its validity, so a padded slot leaves the state exactly as
it was; `length` cuts the loop after the last valid slot the caller knows
of, which gives the same numbers with fewer launches. Every field carries
any leading batch shape: one state, or a stack of windows integrated side
by side (the JAX package's vmapped `_integrate_batch`). The JAX package
projects each product of rotations back onto SO(3) by SVD; here the same
nearest rotation comes from `lie.nearest_rotation` (Newton's polar
iteration; one step per sample takes the ~1e-7 drift of a product of two
rotations to rounding), equal to rounding: on the card an SVD per sample
was most of a window's time.
"""

from __future__ import annotations

import dataclasses

import torch

from ..ops import lie

GRAVITY = 9.81  # IMU::GRAVITY_VALUE (ImuTypes.h:43)


@dataclasses.dataclass(frozen=True)
class Preintegrated:
    dT: torch.Tensor         # [...]
    C: torch.Tensor          # [..., 15, 15] covariance (theta, v, p, bg, ba)
    dR: torch.Tensor         # [..., 3, 3]
    dV: torch.Tensor         # [..., 3]
    dP: torch.Tensor         # [..., 3]
    JRg: torch.Tensor        # [..., 3, 3]
    JVg: torch.Tensor
    JVa: torch.Tensor
    JPg: torch.Tensor
    JPa: torch.Tensor
    bias_gyro: torch.Tensor  # [..., 3] bias the window was integrated at
    bias_acc: torch.Tensor
    avgA: torch.Tensor       # [..., 3] running mean of dR (a - ba) (excitation gate)
    avgW: torch.Tensor


def map_fields(fn, *ps: Preintegrated) -> Preintegrated:
    """A Preintegrated whose every field is fn(field of each of ps)."""
    return Preintegrated(**{f.name: fn(*(getattr(p, f.name) for p in ps))
                            for f in dataclasses.fields(Preintegrated)})


def stack(ps) -> Preintegrated:
    """Stack single windows along a new leading dimension."""
    return map_fields(lambda *xs: torch.stack(xs), *ps)


def index(p: Preintegrated, i) -> Preintegrated:
    """Window(s) i of a stacked Preintegrated."""
    return map_fields(lambda x: x[i], p)


def init_state(bias_gyro, bias_acc) -> Preintegrated:
    """The empty window at biases [..., 3] (their batch shape is the
    state's)."""
    bg = torch.as_tensor(bias_gyro, dtype=torch.float32)
    ba = torch.as_tensor(bias_acc, dtype=torch.float32, device=bg.device)
    batch = bg.shape[:-1]
    f32 = dict(dtype=torch.float32, device=bg.device)
    z3 = torch.zeros(batch + (3,), **f32)
    z33 = torch.zeros(batch + (3, 3), **f32)
    return Preintegrated(
        dT=torch.zeros(batch, **f32), C=torch.zeros(batch + (15, 15), **f32),
        dR=torch.eye(3, **f32).expand(batch + (3, 3)).clone(), dV=z3, dP=z3,
        JRg=z33, JVg=z33, JVa=z33, JPg=z33, JPa=z33,
        bias_gyro=bg, bias_acc=ba, avgA=z3, avgW=z3,
    )


def _mv(M, v):
    return (M @ v[..., None])[..., 0]


def _step(state: Preintegrated, acc_m, gyro_m, dt, valid, noise_cov, walk_cov):
    """One IntegrateNewMeasurement (ImuTypes.cc:177-235); acc_m / gyro_m
    [..., 3], dt / valid [...]. A slot whose valid is 0 keeps the state;
    valid None takes every slot."""
    acc = acc_m - state.bias_acc
    w = gyro_m - state.bias_gyro
    dt1 = dt[..., None]
    dt3 = dt[..., None, None]
    dt2 = dt * dt
    dt23 = dt2[..., None, None]
    dR, dV, dP = state.dR, state.dV, state.dP
    denom = torch.clamp(state.dT + dt, min=1e-9)[..., None]
    dRa = _mv(dR, acc)
    avgA = (state.dT[..., None] * state.avgA + dRa * dt1) / denom
    avgW = (state.dT[..., None] * state.avgW + w * dt1) / denom

    # position and velocity with the old rotation
    dP_new = dP + dV * dt1 + 0.5 * dRa * dt2[..., None]
    dV_new = dV + dRa * dt1

    Wacc = lie.hat(acc)
    dRi, Jr = lie.so3_exp_and_right_jacobian(w * dt1)
    dRW = dR @ Wacc
    eye3 = torch.eye(3, dtype=torch.float32, device=acc.device).expand(dR.shape)
    z33 = torch.zeros_like(dR)

    # A / B of the covariance propagation of (theta, v, p)
    A = torch.cat([
        torch.cat([dRi.transpose(-1, -2), z33, z33], dim=-1),
        torch.cat([-dRW * dt3, eye3, z33], dim=-1),
        torch.cat([-0.5 * dRW * dt23, eye3 * dt3, eye3], dim=-1),
    ], dim=-2)
    B = torch.cat([
        torch.cat([Jr * dt3, z33], dim=-1),
        torch.cat([z33, dR * dt3], dim=-1),
        torch.cat([z33, 0.5 * dR * dt23], dim=-1),
    ], dim=-2)

    # bias Jacobians (ImuTypes.cc:212-218) from the old dR / JRg / JVg / JVa
    JPa_new = state.JPa + state.JVa * dt3 - 0.5 * dR * dt23
    JPg_new = state.JPg + state.JVg * dt3 - (0.5 * dRW * dt23) @ state.JRg
    JVa_new = state.JVa - dR * dt3
    JVg_new = state.JVg - (dRW * dt3) @ state.JRg

    dR_new = lie.nearest_rotation(dR @ dRi, iters=1)
    JRg_new = dRi.transpose(-1, -2) @ state.JRg - Jr * dt3

    C9 = (A @ state.C[..., :9, :9] @ A.transpose(-1, -2)
          + B @ (noise_cov / dt3) @ B.transpose(-1, -2))
    C_bias = state.C[..., 9:, 9:] + walk_cov * dt3
    C = torch.cat([
        torch.cat([C9, state.C[..., :9, 9:]], dim=-1),
        torch.cat([state.C[..., 9:, :9], C_bias], dim=-1),
    ], dim=-2)

    new = Preintegrated(
        dT=state.dT + dt, C=C, dR=dR_new, dV=dV_new, dP=dP_new,
        JRg=JRg_new, JVg=JVg_new, JVa=JVa_new, JPg=JPg_new, JPa=JPa_new,
        bias_gyro=state.bias_gyro, bias_acc=state.bias_acc, avgA=avgA, avgW=avgW,
    )
    if valid is None:
        return new
    keep = valid > 0
    return map_fields(
        lambda n, o: torch.where(keep.reshape(keep.shape + (1,) * (n.ndim - keep.ndim)), n, o),
        new, state)


def noise_covariances(noise_gyro: float, noise_acc: float, walk_gyro: float,
                      walk_acc: float, device=None):
    """(noise_cov [6,6], walk_cov [6,6]): the continuous-time densities of
    IMU::Calib (`ImuTypes.h:92-126`) as diagonals; the step divides the
    noise by dt (sigma^2 * freq with dt = 1/freq)."""
    f32 = dict(dtype=torch.float32, device=device)
    noise = torch.diag(torch.tensor([noise_gyro ** 2] * 3 + [noise_acc ** 2] * 3, **f32))
    walk = torch.diag(torch.tensor([walk_gyro ** 2] * 3 + [walk_acc ** 2] * 3, **f32))
    return noise, walk


def integrate(acc, gyro, dts, valid, bias_gyro, bias_acc,
              noise_gyro: float, noise_acc: float, walk_gyro: float, walk_acc: float,
              length=None) -> Preintegrated:
    """Preintegrate a masked measurement window: acc / gyro [..., M, 3],
    dts / valid [..., M] (valid None: every slot valid, and no masking),
    biases [..., 3] on the same device. The loop runs over the first
    `length` slots (default all M); slots past it must be invalid."""
    dev = acc.device
    noise_cov, walk_cov = noise_covariances(noise_gyro, noise_acc, walk_gyro, walk_acc, dev)
    state = init_state(torch.as_tensor(bias_gyro, dtype=torch.float32, device=dev),
                       torch.as_tensor(bias_acc, dtype=torch.float32, device=dev))
    M = acc.shape[-2] if length is None else int(length)
    for i in range(M):
        state = _step(state, acc[..., i, :], gyro[..., i, :], dts[..., i],
                      None if valid is None else valid[..., i], noise_cov, walk_cov)
    return state


# ---------------------------------------------------------------------------
# Bias-corrected getters (first-order update, ImuTypes.cc:283-307)
# ---------------------------------------------------------------------------

def delta_rotation(p: Preintegrated, bias_gyro):
    db = bias_gyro - p.bias_gyro
    return lie.nearest_rotation(p.dR @ lie.so3_exp(_mv(p.JRg, db)))


def delta_velocity(p: Preintegrated, bias_gyro, bias_acc):
    return p.dV + _mv(p.JVg, bias_gyro - p.bias_gyro) + _mv(p.JVa, bias_acc - p.bias_acc)


def delta_position(p: Preintegrated, bias_gyro, bias_acc):
    return p.dP + _mv(p.JPg, bias_gyro - p.bias_gyro) + _mv(p.JPa, bias_acc - p.bias_acc)


def gravity_vec(device=None):
    return torch.tensor([0.0, 0.0, -GRAVITY], dtype=torch.float32, device=device)


def predict_state(p: Preintegrated, R_wb, t_wb, v_w, bias_gyro, bias_acc):
    """IMU state prediction over the window (Tracking::PredictStateIMU,
    `Tracking.cc:1738-1793`). Returns (R_wb', t_wb', v_w')."""
    dt = p.dT[..., None]
    g = gravity_vec(R_wb.device)
    R2 = lie.nearest_rotation(R_wb @ delta_rotation(p, bias_gyro))
    t2 = (t_wb + v_w * dt + 0.5 * g * dt * dt
          + _mv(R_wb, delta_position(p, bias_gyro, bias_acc)))
    v2 = v_w + g * dt + _mv(R_wb, delta_velocity(p, bias_gyro, bias_acc))
    return R2, t2, v2


def merge_windows(acc_a, gyro_a, dts_a, valid_a, acc_b, gyro_b, dts_b, valid_b,
                  bias_gyro, bias_acc, **noise):
    """Merge two consecutive windows by re-integrating the concatenated
    buffers, as Preintegrated::MergePrevious does (`ImuTypes.cc:237-265`)."""
    return integrate(torch.cat([acc_a, acc_b], dim=-2), torch.cat([gyro_a, gyro_b], dim=-2),
                     torch.cat([dts_a, dts_b], dim=-1), torch.cat([valid_a, valid_b], dim=-1),
                     bias_gyro, bias_acc, **noise)
