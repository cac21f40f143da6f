"""SO(3)/SE(3) of the PyTorch port against orb_slam3_tpu/ops/lie.py.

Elementwise parity at atol 1e-6 on the same seeded inputs, including
near-zero and near-pi angles, and the identities of tests/test_lie.py
(exp/log round trips, inverse, left update) on the port itself.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam3_tpu.ops import lie as jlie
from orb_slam3_tpu.ops import robust as jrobust
from orb_slam3_tpu_torch.ops import lie as tlie
from orb_slam3_tpu_torch.ops import robust as trobust

torch.set_num_threads(1)
ATOL = 1e-6


def _twists(n=64, seed=0):
    rng = np.random.default_rng(seed)
    xi = rng.normal(size=(n, 6)) * 0.7
    xi[:4, 3:] *= 1e-7                       # near-identity rotations
    axis = rng.normal(size=(4, 3))
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    xi[4:8, 3:] = axis * (np.pi - 1e-3)      # near pi
    return xi.astype(np.float32)


def _both(fn_j, fn_t, *arrays):
    out_j = fn_j(*[jnp.asarray(a) for a in arrays])
    out_t = fn_t(*[torch.from_numpy(np.array(a)) for a in arrays])
    if not isinstance(out_j, tuple):
        out_j, out_t = (out_j,), (out_t,)
    return [np.asarray(o) for o in out_j], [o.numpy() for o in out_t]


@pytest.mark.parametrize("name", ["hat", "so3_exp", "so3_left_jacobian",
                                  "_left_jacobian_inv", "so3_right_jacobian",
                                  "so3_right_jacobian_inv"])
def test_so3_functions_of_vectors(name):
    w = _twists()[:, 3:]
    js, ts = _both(getattr(jlie, name), getattr(tlie, name), w)
    for j, t in zip(js, ts):
        np.testing.assert_allclose(t, j, atol=ATOL)


@pytest.mark.parametrize("name", ["vee", "so3_log", "normalize_rotation"])
def test_so3_functions_of_matrices(name):
    R = np.asarray(jlie.so3_exp(jnp.asarray(_twists()[:, 3:])))
    # a slightly non-orthogonal input for normalize_rotation
    R = R + np.random.default_rng(1).normal(size=R.shape).astype(np.float32) * 1e-4
    js, ts = _both(getattr(jlie, name), getattr(tlie, name), R)
    for j, t in zip(js, ts):
        np.testing.assert_allclose(t, j, atol=ATOL)


def test_se3_functions():
    xi = _twists()
    xi2 = _twists(seed=2)
    pts = np.random.default_rng(3).normal(size=(64, 3)).astype(np.float32) * 3
    js, ts = _both(jlie.se3_exp, tlie.se3_exp, xi)
    for j, t in zip(js, ts):
        np.testing.assert_allclose(t, j, atol=ATOL)
    R, t = (np.asarray(a) for a in jlie.se3_exp(jnp.asarray(xi)))
    R2, t2 = (np.asarray(a) for a in jlie.se3_exp(jnp.asarray(xi2)))
    cases = [
        (jlie.se3_log, tlie.se3_log, (R, t)),
        (jlie.se3_mul, tlie.se3_mul, (R, t, R2, t2)),
        (jlie.se3_inv, tlie.se3_inv, (R, t)),
        (jlie.se3_apply, tlie.se3_apply, (R, t, pts)),
        (jlie.se3_lplus, tlie.se3_lplus, (R, t, xi2 * 0.1)),
        (jlie.se3_rplus, tlie.se3_rplus, (R, t, xi2 * 0.1)),
    ]
    for fj, ft, args in cases:
        js, ts = _both(fj, ft, *args)
        for j, tt in zip(js, ts):
            np.testing.assert_allclose(tt, j, atol=ATOL)


def test_huber_weight():
    e2 = np.concatenate([np.linspace(0, 20, 101), [1e-30, 1e9]]).astype(np.float32)
    for d in (trobust.HUBER_MONO, trobust.HUBER_STEREO):
        w_j = np.asarray(jrobust.huber_weight(jnp.asarray(e2), d))
        w_t = trobust.huber_weight(torch.from_numpy(e2), d).numpy()
        np.testing.assert_allclose(w_t, w_j, atol=ATOL)
    assert trobust.CHI2_2DOF == jrobust.CHI2_2DOF
    assert trobust.CHI2_3DOF == jrobust.CHI2_3DOF


def test_identities_on_port():
    xi = torch.from_numpy(_twists())
    R, t = tlie.se3_exp(xi)
    # exp(log(T)) = T, log(exp(xi)) = xi away from pi
    R2, t2 = tlie.se3_exp(tlie.se3_log(R, t))
    torch.testing.assert_close(R2, R, atol=5e-5, rtol=0)
    torch.testing.assert_close(t2, t, atol=5e-5, rtol=0)
    gen = torch.linalg.norm(xi[:, 3:], dim=-1) < 3.0
    torch.testing.assert_close(tlie.se3_log(R, t)[gen], xi[gen], atol=5e-5, rtol=0)
    # R R^T = I, T T^-1 = I
    eye = torch.eye(3).expand_as(R)
    torch.testing.assert_close(R @ R.transpose(-1, -2), eye, atol=2e-6, rtol=0)
    Ri, ti = tlie.se3_inv(R, t)
    Ru, tu = tlie.se3_mul(R, t, Ri, ti)
    torch.testing.assert_close(Ru, eye, atol=2e-6, rtol=0)
    torch.testing.assert_close(tu, torch.zeros_like(tu), atol=5e-6, rtol=0)
    # lplus(T, d) = exp(d) T, and a zero update changes nothing
    d = xi.flip(0) * 0.1
    Rl, tl = tlie.se3_lplus(R, t, d)
    Re, te = tlie.se3_exp(d)
    Rm, tm = tlie.se3_mul(Re, te, R, t)
    torch.testing.assert_close(Rl, Rm)
    torch.testing.assert_close(tl, tm)
    R0, t0 = tlie.se3_lplus(R, t, torch.zeros_like(d))
    torch.testing.assert_close(R0, R, atol=1e-7, rtol=0)
    torch.testing.assert_close(t0, t, atol=1e-7, rtol=0)
