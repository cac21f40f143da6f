"""Inertial initialization and visual-inertial BA of the PyTorch port
against orb_slam3_tpu/imu/{initialization,vi_ba}.py.

Inputs are tests/test_imu_init.py's and tests/test_vi_ba.py's simulated
keyframe chains (their rotations integrated in float64 numpy instead of
eager JAX calls), preintegrated by each package from the same numpy
measurements. In Tier-1: the initial gravity estimate and the closed-form
linear alignment against JAX (scale within 1e-4 relative, gravity and
velocities within 1e-4), and the gates of both JAX tests on the port
(scale within 5% / 15%, gravity cosine, velocity and bias bounds; the VI
BA's cost, translation and velocity reductions). Behind `slow`, the JAX
functions that compile most: inertial_only_optimization (scale within 1e-3
relative, gravity within 1e-3, velocities within 1e-2, biases within
1e-4) and local_inertial_ba (poses within 1e-3, velocities within 1e-2,
landmarks within 1e-2, both costs within 1% of the initial cost).
"""

import os
import sys
from unittest import mock

sys.path.insert(0, os.path.dirname(__file__))

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_imu_init
import test_vi_ba
from orb_slam3_tpu.frontend import camera as jcam
from orb_slam3_tpu.imu import factors as jfac
from orb_slam3_tpu.imu import initialization as jinit
from orb_slam3_tpu.imu import preintegration as jpre
from orb_slam3_tpu.imu import vi_ba as jvba
from orb_slam3_tpu_torch import entry as tentry
from orb_slam3_tpu_torch.imu import factors as tfac
from orb_slam3_tpu_torch.imu import initialization as tinit
from orb_slam3_tpu_torch.imu import preintegration as tpre
from orb_slam3_tpu_torch.imu import vi_ba as tvba
from orb_slam3_tpu_torch.ops import lie as tlie

torch.set_num_threads(1)
G = np.array([0.0, 0.0, -tpre.GRAVITY])


class _NumpyLie:
    so3_exp = staticmethod(lambda w: tentry.so3_exp_np(np.asarray(w)))


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _windows(meas, noise):
    """Each interval's measurements integrated by both packages: (JAX
    stacked Preintegrated, port stacked Preintegrated)."""
    js, ts = [], []
    for m in meas:
        acc = np.stack([x[0] for x in m]).astype(np.float32)
        gyro = np.stack([x[1] for x in m]).astype(np.float32)
        dts = np.array([x[2] for x in m], np.float32)
        js.append(jpre.integrate(jnp.asarray(acc), jnp.asarray(gyro), jnp.asarray(dts),
                                 jnp.ones(len(m)), jnp.zeros(3), jnp.zeros(3), **noise))
        ts.append(tpre.integrate(_t(acc), _t(gyro), _t(dts), torch.ones(len(m)),
                                 torch.zeros(3), torch.zeros(3), **noise))
    return jax.tree.map(lambda *xs: jnp.stack(xs), *js), tpre.stack(ts)


@pytest.fixture(scope="module")
def init_chain():
    """test_imu_init's six-keyframe chain seen in a visual world rotated by
    Rmis and scaled by 1/3."""
    with mock.patch.object(test_imu_init, "lie", _NumpyLie):
        kf_states, meas = test_imu_init.simulate_vi()
    pj, pt = _windows(meas, test_imu_init.NOISE)
    s_true = 3.0
    Rmis = tentry.so3_exp_np([0.15, -0.1, 0.3])
    R_wb = np.stack([Rmis @ st[0] for st in kf_states]).astype(np.float32)
    t_wb = np.stack([(Rmis @ st[1]) / s_true for st in kf_states]).astype(np.float32)
    v_true = np.stack([Rmis @ st[2] for st in kf_states]) / s_true
    return dict(pj=pj, pt=pt, R_wb=R_wb, t_wb=t_wb, s_true=s_true, Rmis=Rmis, v_true=v_true)


@pytest.fixture(scope="module")
def noisy_chain():
    """test_imu_init's ten-keyframe chain at scale 1/6 with 10% relative
    translation noise (the linear-alignment test)."""
    with mock.patch.object(test_imu_init, "lie", _NumpyLie):
        kf_states, meas = test_imu_init.simulate_vi(n_kf=10, kf_dt=0.3)
    pj, pt = _windows(meas, test_imu_init.NOISE)
    s_true = 6.0
    Rmis = tentry.so3_exp_np([0.1, -0.2, 0.25])
    rng = np.random.default_rng(7)
    R_wb = np.stack([Rmis @ st[0] for st in kf_states]).astype(np.float32)
    t_clean = np.stack([(Rmis @ st[1]) / s_true for st in kf_states])
    step = np.median(np.linalg.norm(np.diff(t_clean, axis=0), axis=1))
    t_wb = (t_clean + rng.normal(0, 0.1 * step, t_clean.shape)).astype(np.float32)
    return dict(pj=pj, pt=pt, R_wb=R_wb, t_wb=t_wb, s_true=s_true, Rmis=Rmis)


def _cos(a, b):
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def test_initial_gravity_estimate_matches_jax(init_chain):
    c = init_chain
    Rj = jinit.initial_gravity_estimate(jnp.asarray(c["R_wb"][:-1]), c["pj"].dV)
    Rt = tinit.initial_gravity_estimate(_t(c["R_wb"][:-1]), c["pt"].dV)
    np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), atol=1e-4)


def test_linear_alignment_matches_jax(noisy_chain):
    c = noisy_chain
    sj, sqj, Rj, vj = jinit.linear_alignment(jnp.asarray(c["R_wb"]), jnp.asarray(c["t_wb"]),
                                             c["pj"])
    st, sqt, Rt, vt = tinit.linear_alignment(_t(c["R_wb"]), _t(c["t_wb"]), c["pt"])
    np.testing.assert_allclose(st, sj, rtol=1e-4)
    np.testing.assert_allclose(sqt, sqj, rtol=1e-4)
    np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), atol=1e-4)
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), atol=1e-4)


def test_port_linear_alignment_recovers_scale_under_pose_noise(noisy_chain):
    c = noisy_chain
    s, s_q, Rwg, _ = tinit.linear_alignment(_t(c["R_wb"]), _t(c["t_wb"]), c["pt"])
    assert abs(s - c["s_true"]) / c["s_true"] < 0.15, (s, s_q)
    assert abs(s_q - c["s_true"]) / c["s_true"] < 0.3, (s, s_q)
    assert _cos(Rwg.numpy() @ G, c["Rmis"] @ G) > 0.995


def test_port_inertial_init_recovers_scale_and_gravity(init_chain):
    c = init_chain
    out = tinit.inertial_only_optimization(_t(c["R_wb"]), _t(c["t_wb"]), c["pt"])
    s_est = float(out["scale"])
    assert out["scale"].shape == () and out["scale"].dtype == torch.float32
    assert abs(s_est - c["s_true"]) / c["s_true"] < 0.05, s_est
    assert _cos(out["Rwg"].numpy() @ G, c["Rmis"] @ G) > 0.999
    err = np.linalg.norm(out["velocities"].numpy() - c["v_true"], axis=1)
    assert np.median(err) < 0.1 * np.linalg.norm(c["v_true"], axis=1).max()
    assert float(torch.linalg.norm(out["bg"])) < 0.01


@pytest.mark.slow
def test_inertial_only_optimization_matches_jax(init_chain):
    c = init_chain
    oj = jinit.inertial_only_optimization(jnp.asarray(c["R_wb"]), jnp.asarray(c["t_wb"]),
                                          c["pj"])
    ot = tinit.inertial_only_optimization(_t(c["R_wb"]), _t(c["t_wb"]), c["pt"])
    np.testing.assert_allclose(float(ot["scale"]), float(oj["scale"]), rtol=1e-3)
    np.testing.assert_allclose(ot["Rwg"].numpy(), np.asarray(oj["Rwg"]), atol=1e-3)
    np.testing.assert_allclose(ot["velocities"].numpy(), np.asarray(oj["velocities"]),
                               atol=1e-2)
    for k in ("bg", "ba"):
        np.testing.assert_allclose(ot[k].numpy(), np.asarray(oj[k]), atol=1e-4)


# ---------------------------------------------------------------------------
# local_inertial_ba on tests/test_vi_ba.py's window
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ba_window():
    """test_vi_ba's five-keyframe window (six states) with 150 landmarks:
    everything but keyframe 0 perturbed; the perturbations drawn once with
    a numpy generator and fed to both packages."""
    with mock.patch.object(test_vi_ba, "lie", _NumpyLie):
        kf_states, meas = test_vi_ba.simulate_vi_exact(n_kf=5, kf_dt=0.4)
    W = len(kf_states)
    Rwb = np.stack([s[0] for s in kf_states]).astype(np.float32)
    twb = np.stack([s[1] for s in kf_states]).astype(np.float32)
    vel = np.stack([s[2] for s in kf_states]).astype(np.float32)
    pj, pt = _windows(meas, test_vi_ba.NOISE)
    rng = np.random.default_rng(0)
    L = 150
    rays = np.stack([rng.uniform(-0.5, 0.5, L), rng.uniform(-0.4, 0.4, L), np.ones(L)], -1)
    X = ((rays * rng.uniform(6, 14, L)[:, None]) @ Rwb[0].T + twb[0]).astype(np.float32)
    Rcw = np.swapaxes(Rwb, 1, 2)
    tcw = -np.einsum("kij,kj->ki", Rcw, twb)
    Xc = np.einsum("kij,lj->kli", Rcw, X) + tcw[:, None, :]
    K = np.asarray(test_vi_ba.K)
    uv = (Xc[..., :2] / Xc[..., 2:] * K[:2] + K[2:4]).reshape(-1, 2)
    uv = (uv + 0.4 * rng.standard_normal(uv.shape)).astype(np.float32)
    in_img = (uv[:, 0] > 0) & (uv[:, 0] < 640) & (uv[:, 1] > 0) & (uv[:, 1] < 480)
    obs_mask = (Xc[..., 2] > 1.0).reshape(-1) & in_img
    dpose = 0.02 * rng.standard_normal((W, 6)).astype(np.float32)
    dpose[0] = 0.0
    Rp, tp = (a.numpy() for a in tlie.se3_rplus(_t(Rwb), _t(twb), _t(dpose)))
    vp = vel + 0.2 * rng.standard_normal((W, 3)).astype(np.float32)
    vp[0] = vel[0]
    Xp = X + 0.08 * rng.standard_normal((L, 3)).astype(np.float32)
    args = dict(Rp=Rp, tp=tp, vp=vp, Xp=Xp, uv=uv, obs_mask=obs_mask,
                cam_idx=np.repeat(np.arange(W, dtype=np.int32), L),
                lm_idx=np.tile(np.arange(L, dtype=np.int32), W))
    return dict(W=W, L=L, K=K, twb=twb, vel=vel, pj=pj, pt=pt, args=args)


def _port_ba(b):
    a, W, L = b["args"], b["W"], b["L"]
    data, info = tfac.preint_edge_data(b["pt"])
    src = torch.arange(W - 1, dtype=torch.int32)
    fixed = torch.zeros(W, dtype=torch.bool)
    fixed[0] = True
    return tvba.local_inertial_ba(
        0, _t(b["K"]), torch.eye(3), torch.zeros(3), _t(a["Rp"]), _t(a["tp"]), _t(a["vp"]),
        torch.zeros(W, 3), torch.zeros(W, 3), fixed, _t(a["Xp"]), torch.zeros(L, dtype=torch.bool),
        torch.from_numpy(a["cam_idx"]), torch.from_numpy(a["lm_idx"]), _t(a["uv"]),
        torch.ones(W * L), torch.from_numpy(a["obs_mask"]), data, info, tfac.rw_info6(b["pt"]),
        src, src + 1, torch.ones(W - 1, dtype=torch.bool), iters=12)


def test_port_local_inertial_ba_recovers_states(ba_window):
    b = ba_window
    assert int(b["args"]["obs_mask"].sum()) > 300
    Ro, to, vo, bgo, bao, Xo, stats = _port_ba(b)
    assert float(stats.cost) < float(stats.cost0) * 0.1, (float(stats.cost0), float(stats.cost))
    terr0 = np.linalg.norm(b["args"]["tp"] - b["twb"], axis=1).max()
    assert np.linalg.norm(to.numpy() - b["twb"], axis=1).max() < 0.3 * terr0
    verr0 = np.linalg.norm(b["args"]["vp"] - b["vel"], axis=1).max()
    assert np.linalg.norm(vo.numpy() - b["vel"], axis=1).max() < 0.35 * verr0


@pytest.mark.slow
def test_local_inertial_ba_matches_jax(ba_window):
    b = ba_window
    a, W, L = b["args"], b["W"], b["L"]
    data, info = jax.vmap(jfac.preint_edge_data)(b["pj"])
    rw = jnp.zeros((W - 1, 6, 6))
    rw = rw.at[:, :3, :3].set(jax.vmap(jfac.gyro_rw_info)(b["pj"]))
    rw = rw.at[:, 3:, 3:].set(jax.vmap(jfac.acc_rw_info)(b["pj"]))
    src = jnp.arange(W - 1, dtype=jnp.int32)
    outj = jvba.local_inertial_ba(
        jcam.PINHOLE, jnp.asarray(b["K"]), jnp.eye(3), jnp.zeros(3), jnp.asarray(a["Rp"]),
        jnp.asarray(a["tp"]), jnp.asarray(a["vp"]), jnp.zeros((W, 3)), jnp.zeros((W, 3)),
        jnp.zeros(W, bool).at[0].set(True), jnp.asarray(a["Xp"]), jnp.zeros(L, bool),
        jnp.asarray(a["cam_idx"]), jnp.asarray(a["lm_idx"]), jnp.asarray(a["uv"]),
        jnp.ones(W * L), jnp.asarray(a["obs_mask"]), data, info, rw, src, src + 1,
        jnp.ones(W - 1, bool), iters=12)
    outt = _port_ba(b)
    for i, atol in ((0, 1e-3), (1, 1e-3), (2, 1e-2), (3, 1e-3), (4, 1e-3), (5, 1e-2)):
        np.testing.assert_allclose(outt[i].numpy(), np.asarray(outj[i]), atol=atol, err_msg=i)
    sj, st = outj[6], outt[6]
    assert abs(float(st.cost) - float(sj.cost)) < 0.01 * float(sj.cost0)
    np.testing.assert_allclose(float(st.cost0), float(sj.cost0), rtol=1e-3)


def test_closed_form_jacobians_equal_the_engines_forward_mode(ba_window, init_chain):
    """Every closed-form Jacobian the inertial BAs carry against the LM
    engines' forward-mode linearization of the same residuals: the VI BA's
    visual edges (15-DoF cameras) and camera-camera edges, and the
    gravity-scale and bias-prior edges of inertial_only_optimization;
    within 1e-4 of the largest entry."""
    import dataclasses

    from orb_slam3_tpu_torch.lm import problem as tprob
    from orb_slam3_tpu_torch.lm import schur

    def close(a, b):
        b = b.detach()
        np.testing.assert_allclose(a.detach().numpy(), b.numpy(),
                                   atol=1e-4 * max(1.0, float(b.abs().max())))

    b = ba_window
    a, W, L = b["args"], b["W"], b["L"]
    data, info = tfac.preint_edge_data(b["pt"])
    R = tlie.so3_exp(_t(np.random.default_rng(3).normal(0, 0.05, (W, 3))))
    K8 = _t(b["K"])
    Rbc, tbc = tlie.so3_exp(_t([0.01, -0.02, 0.03])), _t([0.05, 0.01, -0.02])
    cams = tvba.make_vi_cam_block(_t(a["Rp"]) @ R, _t(a["tp"]), _t(a["vp"]), torch.full((W, 3), 1e-3),
                                  torch.full((W, 3), -2e-3), torch.zeros(W, dtype=torch.bool))
    src = torch.arange(W - 1, dtype=torch.int32)
    edges = tvba.build_inertial_chain_edges(data, info, tfac.rw_info6(b["pt"]), src, src + 1,
                                            torch.ones(W - 1, dtype=torch.bool))
    bap = schur.BAProblem(
        cams=cams, points=_t(a["Xp"]), point_fixed=torch.zeros(L, dtype=torch.bool),
        cam_idx=torch.from_numpy(a["cam_idx"]), lm_idx=torch.from_numpy(a["lm_idx"]),
        obs_data={"uv": _t(a["uv"])}, obs_info=torch.ones(W * L),
        obs_mask=torch.from_numpy(a["obs_mask"]), cam_edges=edges, residual_dim=2,
        residual=tvba.make_vi_obs_residual(0, K8, Rbc, tbc),
        jacobian=tvba.make_vi_obs_jacobian(0, K8, Rbc, tbc))
    got = schur._linearize_obs(bap)
    ref = schur._linearize_obs(dataclasses.replace(bap, jacobian=None))
    for x, y in zip(got, ref):
        close(x, y)
    prob = tprob.Problem(blocks={"cam": cams}, edges=edges)
    for e in edges:
        for x, y in zip(tprob.linearize_edge(prob, e)[1],
                        tprob.linearize_edge(prob, dataclasses.replace(e, jacobian=None))[1]):
            close(x, y)
    # the gravity-scale edge and the bias priors of the inertial-only MAP
    c = init_chain
    seen = []
    orig = tinit.dense.solve

    def capture(problem, **kw):
        seen.append(problem)
        return orig(problem, num_iters=1, lam0=kw["lam0"])

    with mock.patch.object(tinit.dense, "solve", capture):
        tinit.inertial_only_optimization(_t(c["R_wb"]), _t(c["t_wb"]), c["pt"], s0=2.0)
    prob = seen[0]
    assert all(e.jacobian is not None for e in prob.edges)
    for e in prob.edges:
        for x, y in zip(tprob.linearize_edge(prob, e)[1],
                        tprob.linearize_edge(prob, dataclasses.replace(e, jacobian=None))[1]):
            close(x, y)
