"""Pose-inertial tracking optimization of the PyTorch port against
orb_slam3_tpu/tracking/vi_pose_opt.py, on the three variants of
tests/test_vi_pose_opt.py (last keyframe, last frame with the marginal
prior chain, stereo rows).

Each variant's inputs are made once with that test's helpers (a module
fixture). In Tier-1 the port meets that test's own gates (the last-frame
variant from the prior of its own frame-1 solve). Behind `slow` (one JAX
compile per variant, ~35 s) both packages run the same inputs, the
last-frame variant from the JAX prior: the solved state agrees within
2e-4 (rotation, translation), 2e-3 (velocity) and 1e-4 (biases), the
inlier masks are equal and the marginal information agrees within 1e-2
relative to its largest entry. The closed-form Jacobian of the visual rows
equals forward-mode differentiation of the same residual within 1e-3 of
its largest entry.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(__file__))

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import jacfwd

from orb_slam3_tpu.frontend import camera as jcam
from orb_slam3_tpu.tracking import vi_pose_opt as jvpo
from orb_slam3_tpu_torch.ops import lie as tlie
from orb_slam3_tpu_torch.tracking import vi_pose_opt as tvpo
from test_vi_ba import K
from test_vi_pose_opt import _observations, _perturb, _setup

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _tree_t(d):
    return {k: _t(v) for k, v in d.items()}


def _run(lib, prev, cur0, packed, uv, ur, Xw, bf, prior=None):
    """One variant through the JAX package ("jax") or the port ("port")."""
    d, info, rw = packed
    N = uv.shape[0]
    if lib == "jax":
        kw = {} if prior is None else dict(prior_data=prior[0], prior_H=prior[1], free_prev=True)
        return jvpo.pose_inertial_optimize(jcam.PINHOLE, K, bf, jnp.eye(3), jnp.zeros(3), prev,
                                           cur0, d, info, rw, uv, ur, Xw, jnp.ones(N),
                                           jnp.ones(N, bool), **kw)
    kw = {} if prior is None else dict(prior_data=_tree_t(prior[0]), prior_H=_t(prior[1]),
                                       free_prev=True)
    return tvpo.pose_inertial_optimize(0, _t(K), bf, torch.eye(3), torch.zeros(3), _tree_t(prev),
                                       _tree_t(cur0), _tree_t(d), _t(info), _t(rw), _t(uv),
                                       _t(ur), _t(Xw), torch.ones(N),
                                       torch.ones(N, dtype=torch.bool), **kw)


@pytest.fixture(scope="module")
def inputs():
    """The three variants' inputs, made with tests/test_vi_pose_opt.py's
    helpers; the last-frame variant's prior comes from frame 1's solve
    against keyframe 0 (`prior_from(lib)`)."""
    states, packed = _setup()
    Xw, uv, _ = _observations(states[1], seed=1)
    N = uv.shape[0]
    Xw1, uv1, _ = _observations(states[1], seed=2)
    Xw2, uv2, n_out = _observations(states[2], outlier_frac=0.15, seed=3)
    Xws, uvs, _ = _observations(states[1], n=80, seed=4)
    bf = 40.0
    Rcw, tcw = jnp.swapaxes(states[1]["R"], 0, 1), -states[1]["R"].T @ states[1]["t"]
    z = (jnp.einsum("ij,nj->ni", Rcw, Xws) + tcw)[:, 2]
    return dict(
        last_kf=((states[0], _perturb(states[1], jax.random.PRNGKey(5)), packed[0], uv,
                  -jnp.ones(N), Xw, 0.0), states[1], None),
        frame1=(states[0], _perturb(states[1], jax.random.PRNGKey(6)), packed[0], uv1,
                -jnp.ones(N), Xw1, 0.0),
        last_frame=((_perturb(states[2], jax.random.PRNGKey(7)), packed[1], uv2, -jnp.ones(N),
                     Xw2, 0.0), states[2], n_out),
        stereo=((states[0], _perturb(states[1], jax.random.PRNGKey(8)), packed[0], uvs,
                 uvs[:, 0] - bf / z, Xws, bf), states[1], None))


def _variant(inputs, variant, lib, prior_lib=None):
    """(lib's output, truth, outliers) of a variant; the last-frame variant
    runs from the prior that prior_lib's frame-1 solve gives."""
    if variant != "last_frame":
        args, truth, n_out = inputs[variant]
        return _run(lib, *args), truth, n_out
    f1, _, _, H1 = _run(prior_lib or lib, *inputs["frame1"])
    f1 = {k: np.asarray(v) for k, v in f1.items()}
    prior = ({"R0": f1["R"], "t0": f1["t"], "v0": f1["v"], "bg0p": f1["bg"],
              "ba0p": f1["ba"]}, np.asarray(H1))
    args, truth, n_out = inputs["last_frame"]
    prev = {k: jnp.asarray(v) for k, v in f1.items()}
    return _run(lib, prev, *args, prior=prior), truth, n_out


def _err(a, b):
    Ra, Rb = np.asarray(a["R"], np.float64), np.asarray(b["R"], np.float64)
    c = np.clip((np.trace(Ra.T @ Rb) - 1.0) / 2.0, -1.0, 1.0)
    return float(np.arccos(c)), float(np.linalg.norm(np.asarray(a["t"]) - np.asarray(b["t"])))


@pytest.mark.slow
@pytest.mark.parametrize("variant", ["last_kf", "last_frame", "stereo"])
def test_matches_jax(inputs, variant):
    (cj, inl_j, n_j, Hj), _, _ = _variant(inputs, variant, "jax")
    (ct, inl_t, n_t, Ht), _, _ = _variant(inputs, variant, "port", prior_lib="jax")
    for k, atol in (("R", 2e-4), ("t", 2e-4), ("v", 2e-3), ("bg", 1e-4), ("ba", 1e-4)):
        np.testing.assert_allclose(ct[k].numpy(), np.asarray(cj[k]), atol=atol, err_msg=k)
    np.testing.assert_array_equal(inl_t.numpy(), np.asarray(inl_j))
    assert int(n_t) == int(n_j)
    Hj = np.asarray(Hj)
    np.testing.assert_allclose(Ht.numpy(), Hj, atol=1e-2 * np.abs(Hj).max())


@pytest.mark.parametrize("variant", ["last_kf", "last_frame", "stereo"])
def test_port_meets_the_jax_tests_gates(inputs, variant):
    (cur, inlier, n_inl, H), truth, n_out = _variant(inputs, variant, "port")
    dR, dt = _err(cur, truth)
    N = inlier.shape[0]
    w = np.linalg.eigvalsh(H.numpy().astype(np.float64))
    assert w.min() > -1e-3
    if variant == "last_kf":
        assert dt < 0.02 and dR < 0.01, (dt, dR)
        assert float(np.linalg.norm(cur["v"].numpy() - np.asarray(truth["v"]))) < 0.08
        assert int(n_inl) > 0.9 * N and w.max() > 1.0
    elif variant == "last_frame":
        assert dt < 0.03 and dR < 0.015, (dt, dR)
        inl = inlier.numpy()
        assert inl[:n_out].sum() <= 0.2 * n_out and inl[n_out:].mean() > 0.85
    else:
        assert dt < 0.02 and dR < 0.01, (dt, dR)
        assert int(n_inl) > 0.85 * N


@pytest.mark.parametrize("bf", [0.0, 40.0])
def test_closed_form_visual_jacobian_equals_forward_mode(bf):
    """The visual rows' Jacobian in the body-state tangent, closed form
    against jacfwd of the same residual through retract15, with a
    body-camera extrinsic that is not the identity."""
    rng = np.random.default_rng(0)
    cur = {"R": tlie.so3_exp(_t(rng.normal(size=3) * 0.2)), "t": _t(rng.normal(size=3)),
           "v": torch.zeros(3), "bg": torch.zeros(3), "ba": torch.zeros(3)}
    Rbc, tbc = tlie.so3_exp(_t([0.01, -0.02, 0.015])), _t([0.05, -0.01, 0.02])
    Rwc = cur["R"] @ Rbc
    twc = cur["R"] @ tbc + cur["t"]
    Xc = _t(np.stack([rng.uniform(-1, 1, 40), rng.uniform(-1, 1, 40),
                      rng.uniform(4, 9, 40)], -1))
    Xw = Xc @ Rwc.T + twc
    Kt = _t(K)
    uv = Xc[:, :2] / Xc[:, 2:] * Kt[:2] + Kt[2:4]
    ur = torch.where(torch.arange(40) % 3 == 0, -1.0, uv[:, 0] - bf / Xc[:, 2])
    obs3 = torch.cat([uv, torch.where(ur >= 0, ur, 0.0)[:, None]], dim=1)
    comp_w = torch.stack([torch.ones(40), torch.ones(40), (ur >= 0).float()], -1)
    _, _, J = tvpo.visual_rows(0, Kt, torch.tensor(bf), Rbc, tbc, cur, Xw, obs3, comp_w, 15)

    def res(dx):
        c2 = tvpo.retract15(cur, dx)
        Rcw, tcw = tlie.se3_inv(c2["R"] @ Rbc, c2["R"] @ tbc + c2["t"])
        X = Xw @ Rcw.T + tcw
        u = Kt[0] * X[:, 0] / X[:, 2] + Kt[2]
        v = Kt[1] * X[:, 1] / X[:, 2] + Kt[3]
        pred = torch.stack([u, v, u - bf / X[:, 2]], -1)
        return (obs3 - pred) * comp_w

    J_ad = jacfwd(res)(torch.zeros(15))
    np.testing.assert_allclose(J.numpy(), J_ad.numpy(),
                               atol=1e-3 * float(J_ad.abs().max()))
