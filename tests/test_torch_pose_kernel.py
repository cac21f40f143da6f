"""Kernel K2 (motion-only pose BA) of the PyTorch port.

The port's plain version runs on the CPU against the JAX package's XLA
path (track.pose_optimize / pose_optimize_stereo) and its Pallas kernel in
interpret mode, on the cases of tests/test_pose_kernel.py with its
tolerances: n and mask equal, R atol 5e-6, t atol 5e-5 mono / 1e-4 stereo.
A batch of two problems equals the two single solves. The CUDA kernel
against the plain version is in test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from orb_slam3_tpu.frontend import camera as jcam
from orb_slam3_tpu.ops import lie as jlie
from orb_slam3_tpu.tracking import pose_kernel as jpk
from orb_slam3_tpu.tracking import track as jtrack
from orb_slam3_tpu_torch.frontend import camera as tcam
from orb_slam3_tpu_torch.tracking import pose_kernel as tpk
from orb_slam3_tpu_torch.tracking import track as ttrack

torch.set_num_threads(1)
K_NP = np.asarray([450.0, 450.0, 376.0, 240.0, 0, 0, 0, 0], np.float32)
BF = 0.1 * 450.0


def _mono_case(n, n_out, seed=3):
    """tests/test_pose_kernel.py's mono case, as numpy float32."""
    rng = np.random.default_rng(seed)
    K = jnp.asarray(K_NP)
    Xw = np.concatenate([rng.uniform(-3, 3, (n, 2)), rng.uniform(4, 9, (n, 1))], 1)
    Xw = Xw.astype(np.float32)
    xi_true = jnp.asarray(rng.normal(size=6) * 0.05, jnp.float32)
    Rt, tt = jlie.se3_exp(xi_true)
    uv = jcam.pinhole_project(K, jlie.se3_apply(Rt, tt, jnp.asarray(Xw)))
    uv = np.array(uv + jnp.asarray(rng.normal(size=(n, 2)) * 0.5, jnp.float32))
    if n_out:
        uv[:n_out] += rng.uniform(20, 60, (n_out, 2)).astype(np.float32)
    return dict(uv=uv, Xw=Xw, isig=np.ones(n, np.float32), valid=np.ones(n, bool),
                t_true=np.asarray(tt))


def _stereo_case(n=256, seed=11):
    """tests/test_pose_kernel.py's mixed mono/stereo case."""
    rng = np.random.default_rng(seed)
    K = jnp.asarray(K_NP)
    Xw = np.concatenate([rng.uniform(-3, 3, (n, 2)), rng.uniform(4, 9, (n, 1))], 1)
    Xw = jnp.asarray(Xw, jnp.float32)
    xi_true = jnp.asarray(rng.normal(size=6) * 0.04, jnp.float32)
    Rt, tt = jlie.se3_exp(xi_true)
    Xc = jlie.se3_apply(Rt, tt, Xw)
    uv = jcam.pinhole_project(K, Xc)
    uv = uv + jnp.asarray(rng.normal(size=(n, 2)) * 0.4, jnp.float32)
    ur = uv[:, 0] - BF / Xc[:, 2] + jnp.asarray(rng.normal(size=n) * 0.4, jnp.float32)
    ur = jnp.where(jnp.asarray(rng.uniform(size=n) < 0.5), ur, -1.0)
    return dict(uv=np.asarray(uv), ur=np.asarray(ur), Xw=np.asarray(Xw),
                isig=np.ones(n, np.float32), valid=np.ones(n, bool),
                t_true=np.asarray(tt))


def _t(a, device="cpu"):
    return torch.from_numpy(np.array(a)).to(device)


def _port_mono(c, device="cpu"):
    K = _t(K_NP, device)
    return ttrack.pose_optimize(
        tcam.PINHOLE, K, torch.eye(3, device=device), torch.zeros(3, device=device),
        _t(c["uv"], device), _t(c["Xw"], device), _t(c["isig"], device),
        _t(c["valid"], device),
    )


def _port_stereo(c, device="cpu"):
    K = _t(K_NP, device)
    return ttrack.pose_optimize_stereo(
        tcam.PINHOLE, K, BF, torch.eye(3, device=device), torch.zeros(3, device=device),
        _t(c["uv"], device), _t(c["ur"], device), _t(c["Xw"], device),
        _t(c["isig"], device), _t(c["valid"], device),
    )


def _assert_close(port, ref, t_atol, r_atol=5e-6):
    R_p, t_p, inl_p, n_p = (np.asarray(x.cpu()) if torch.is_tensor(x) else np.asarray(x)
                            for x in port)
    R_r, t_r, inl_r, n_r = (np.asarray(x) for x in ref)
    assert int(n_p) == int(n_r)
    np.testing.assert_array_equal(inl_p, inl_r)
    np.testing.assert_allclose(R_p, R_r, atol=r_atol)
    np.testing.assert_allclose(t_p, t_r, atol=t_atol)


@pytest.mark.parametrize("n,n_out", [(300, 30), (130, 0)])
def test_plain_mono_matches_jax(n, n_out):
    c = _mono_case(n, n_out)
    K = jnp.asarray(K_NP)
    args = (K, jnp.eye(3), jnp.zeros(3), jnp.asarray(c["uv"]), jnp.asarray(c["Xw"]),
            jnp.asarray(c["isig"]), jnp.asarray(c["valid"]))
    ref_x = jtrack.pose_optimize(jcam.PINHOLE, *args)
    with pltpu.force_tpu_interpret_mode():
        ref_p = jpk.pose_optimize_pallas(*args)
    port = _port_mono(c)
    _assert_close(port, ref_x, t_atol=5e-5)
    _assert_close(port, ref_p, t_atol=5e-5)
    assert np.linalg.norm(port[1].numpy() - c["t_true"]) < 0.02
    if n_out:
        assert not port[2][:n_out].any()  # planted outliers rejected


def test_plain_stereo_matches_jax():
    c = _stereo_case()
    K = jnp.asarray(K_NP)
    args = (K, BF, jnp.eye(3), jnp.zeros(3), jnp.asarray(c["uv"]), jnp.asarray(c["ur"]),
            jnp.asarray(c["Xw"]), jnp.asarray(c["isig"]), jnp.asarray(c["valid"]))
    ref_x = jtrack.pose_optimize_stereo(jcam.PINHOLE, *args)
    with pltpu.force_tpu_interpret_mode():
        ref_p = jpk.pose_optimize_stereo_pallas(*args)
    port = _port_stereo(c)
    _assert_close(port, ref_x, t_atol=1e-4)
    _assert_close(port, ref_p, t_atol=1e-4)
    assert np.linalg.norm(port[1].numpy() - c["t_true"]) < 0.02


def test_batch_equals_single_solves():
    """Two mono problems of one size (300 rows) solved as one B=2 batch."""
    cs = [_mono_case(300, 30, seed=3), _mono_case(300, 0, seed=4)]
    st = lambda k: _t(np.stack([c[k] for c in cs]))
    R, t, inl, n = tpk.pose_ba(_t(np.stack([K_NP, K_NP])), torch.eye(3).expand(2, 3, 3),
                               torch.zeros(2, 3), st("uv"), st("Xw"), st("isig"), st("valid"))
    for b, c in enumerate(cs):
        R1, t1, inl1, n1 = _port_mono(c)
        assert int(n[b]) == int(n1)
        assert torch.equal(inl[b], inl1)
        torch.testing.assert_close(R[b], R1, atol=1e-6, rtol=0)
        torch.testing.assert_close(t[b], t1, atol=1e-5, rtol=0)
