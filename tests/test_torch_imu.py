"""IMU preintegration and inertial factors of the PyTorch port against
orb_slam3_tpu/imu/{preintegration,factors}.py.

The same seeded numpy windows go through both packages (one JAX
integration per window, shared by module fixtures). Preintegration: dT and
the deltas within 1e-5 (rotation) / 2e-5 (velocity, position), the bias
Jacobians within 1e-5, the covariance within 1e-3 relative (f32 sums of
terms ~1e-8). Factors: every residual within 1e-5, the informations within
1e-3 relative, and the residuals' forward-mode Jacobians within 1e-4 and in
float32. The gates of tests/test_imu.py hold on the port with that test's
tolerances.
"""

import functools
import os
import sys
from unittest import mock

sys.path.insert(0, os.path.dirname(__file__))

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import jacfwd

from orb_slam3_tpu.imu import factors as jfac
from orb_slam3_tpu.imu import preintegration as jpre
from orb_slam3_tpu_torch.imu import factors as tfac
from orb_slam3_tpu_torch.imu import preintegration as tpre
from orb_slam3_tpu_torch.ops import lie as tlie
import test_imu
from orb_slam3_tpu_torch import entry as tentry
from test_imu import NOISE, simulate_trajectory

torch.set_num_threads(1)
FIELDS = ("dT", "dR", "dV", "dP", "JRg", "JVg", "JVa", "JPg", "JPa", "avgA", "avgW")
BG = np.array([0.002, -0.001, 0.0015], np.float32)
BA = np.array([0.01, -0.02, 0.015], np.float32)


class _NumpyLie:
    """The one lie function the simulator calls, in numpy: the JAX one
    dispatches eagerly per substep (~12 s for the windows here)."""

    so3_exp = staticmethod(lambda w: tentry.so3_exp_np(np.asarray(w)))


@functools.lru_cache(maxsize=None)
def _simulated(T):
    """tests/test_imu.py's simulated window of T seconds, made once, with
    its rotations integrated in float64 numpy."""
    with mock.patch.object(test_imu, "lie", _NumpyLie):
        return simulate_trajectory(T=T)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


@pytest.fixture(scope="module")
def window():
    """A 0.5 s window at 200 Hz with nonzero integration biases, padded by
    24 invalid slots of junk, integrated by both packages."""
    accs, gyros, dts, _ = _simulated(0.5)
    n, pad = len(dts), 24
    acc = np.concatenate([accs, np.full((pad, 3), 99.0, np.float32)])
    gyro = np.concatenate([gyros, np.full((pad, 3), 99.0, np.float32)])
    dt = np.concatenate([dts, np.full(pad, 0.1, np.float32)])
    valid = np.concatenate([np.ones(n, np.float32), np.zeros(pad, np.float32)])
    j = jpre.integrate(jnp.asarray(acc), jnp.asarray(gyro), jnp.asarray(dt),
                       jnp.asarray(valid), jnp.asarray(BG), jnp.asarray(BA), **NOISE)
    t = tpre.integrate(_t(acc), _t(gyro), _t(dt), _t(valid), _t(BG), _t(BA), **NOISE)
    return dict(acc=acc, gyro=gyro, dt=dt, valid=valid, n=n, j=j, t=t)


def _assert_windows_close(got, ref):
    """Every field of two windows within the module's tolerances (relative
    to the field's magnitude where it exceeds 1)."""
    for name, atol in zip(FIELDS, (1e-6, 1e-5, 2e-5, 2e-5) + (1e-5,) * 5 + (2e-5, 1e-5)):
        r = np.asarray(getattr(ref, name))
        np.testing.assert_allclose(np.asarray(getattr(got, name)), r,
                                   atol=atol * max(1.0, float(np.abs(r).max())), err_msg=name)
    C = np.asarray(ref.C)
    np.testing.assert_allclose(np.asarray(got.C), C, rtol=1e-3, atol=1e-3 * np.abs(C).max())


def test_preintegration_matches_jax(window):
    _assert_windows_close(window["t"], window["j"])


def test_loop_cut_after_the_valid_slots_gives_the_same_numbers(window):
    w = window
    cut = tpre.integrate(_t(w["acc"]), _t(w["gyro"]), _t(w["dt"]), _t(w["valid"]), _t(BG),
                         _t(BA), length=w["n"], **NOISE)
    for name in FIELDS + ("C",):
        assert torch.equal(getattr(cut, name), getattr(w["t"], name)), name


def test_batched_windows_equal_single_windows(window):
    """A stack of windows integrated side by side (the JAX package's
    vmapped _integrate_batch) equals each window alone."""
    w = window
    acc2 = np.stack([w["acc"], w["acc"][::-1].copy()])
    gyro2 = np.stack([w["gyro"], w["gyro"] * 0.5])
    dt2 = np.stack([w["dt"], w["dt"]])
    valid2 = np.stack([w["valid"], np.roll(w["valid"], 24)])
    bg2, ba2 = np.stack([BG, -BG]), np.stack([BA, BA * 2])
    batch = tpre.integrate(_t(acc2), _t(gyro2), _t(dt2), _t(valid2), _t(bg2), _t(ba2), **NOISE)
    for i in range(2):
        one = tpre.integrate(_t(acc2[i]), _t(gyro2[i]), _t(dt2[i]), _t(valid2[i]), _t(bg2[i]),
                             _t(ba2[i]), **NOISE)
        _assert_windows_close(tpre.index(batch, i), one)


def test_corrected_deltas_and_prediction_match_jax(window):
    j, t = window["j"], window["t"]
    bg, ba = BG + 1e-3, BA - 5e-3
    pairs = [(jpre.delta_rotation(j, jnp.asarray(bg)), tpre.delta_rotation(t, _t(bg))),
             (jpre.delta_velocity(j, jnp.asarray(bg), jnp.asarray(ba)),
              tpre.delta_velocity(t, _t(bg), _t(ba))),
             (jpre.delta_position(j, jnp.asarray(bg), jnp.asarray(ba)),
              tpre.delta_position(t, _t(bg), _t(ba)))]
    R0 = np.array([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]], np.float32)
    args = (R0, np.array([0.3, -0.2, 1.0], np.float32), np.array([0.5, 0.1, -0.2], np.float32))
    pj = jpre.predict_state(j, *(jnp.asarray(a) for a in args), jnp.asarray(bg), jnp.asarray(ba))
    pt = tpre.predict_state(t, *(_t(a) for a in args), _t(bg), _t(ba))
    pairs += list(zip(pj, pt))
    for a, b in pairs:
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=3e-5)


def test_merge_windows_is_the_concatenated_integration(window):
    w = window
    half = w["n"] // 2
    parts = [(_t(w[k][:half]), _t(w[k][half:])) for k in ("acc", "gyro", "dt", "valid")]
    merged = tpre.merge_windows(parts[0][0], parts[1][0], parts[2][0], parts[3][0],
                                parts[0][1], parts[1][1], parts[2][1], parts[3][1],
                                _t(BG), _t(BA), **NOISE)
    for name in FIELDS + ("C",):
        assert torch.equal(getattr(merged, name), getattr(w["t"], name)), name


# ---------------------------------------------------------------------------
# tests/test_imu.py's gates on the port (same tolerances)
# ---------------------------------------------------------------------------

def _integrate(accs, gyros, dts, bg=None, ba=None):
    n = len(dts)
    return tpre.integrate(_t(accs), _t(gyros), _t(dts), torch.ones(n),
                          torch.zeros(3) if bg is None else bg,
                          torch.zeros(3) if ba is None else ba, **NOISE)


@pytest.fixture(scope="module")
def one_second():
    accs, gyros, dts, truth = _simulated(1.0)
    return _integrate(accs, gyros, dts), truth


def test_port_matches_ground_truth_motion(one_second):
    st, (R_gt, v_gt, p_gt) = one_second
    g = np.array([0, 0, -tpre.GRAVITY])
    np.testing.assert_allclose(float(st.dT), 1.0, atol=1e-5)
    np.testing.assert_allclose(st.dR.numpy(), R_gt, atol=5e-3)
    np.testing.assert_allclose(st.dV.numpy(), v_gt - g, atol=2e-2)
    np.testing.assert_allclose(st.dP.numpy(), p_gt - 0.5 * g, atol=2e-2)


def test_port_bias_jacobian_first_order():
    accs, gyros, dts, _ = _simulated(0.5)
    st0 = _integrate(accs, gyros, dts)
    db_g = torch.tensor([0.002, -0.001, 0.0015])
    db_a = torch.tensor([0.01, -0.02, 0.015])
    st1 = _integrate(accs, gyros, dts, db_g, db_a)
    np.testing.assert_allclose(tpre.delta_rotation(st0, db_g).numpy(), st1.dR.numpy(), atol=1e-4)
    np.testing.assert_allclose(tpre.delta_velocity(st0, db_g, db_a).numpy(), st1.dV.numpy(),
                               atol=1e-3)
    np.testing.assert_allclose(tpre.delta_position(st0, db_g, db_a).numpy(), st1.dP.numpy(),
                               atol=1e-3)


def test_port_covariance_psd_and_prediction(one_second):
    st, (R_gt, v_gt, p_gt) = one_second
    C = st.C.numpy().astype(np.float64)
    assert np.linalg.eigvalsh(0.5 * (C + C.T)).min() > -1e-12
    assert C[0, 0] > 0 and C[3, 3] > 0 and C[6, 6] > 0 and C[9, 9] > 0
    z = torch.zeros(3)
    R2, p2, v2 = tpre.predict_state(st, torch.eye(3), z, z, z, z)
    np.testing.assert_allclose(R2.numpy(), R_gt, atol=5e-3)
    np.testing.assert_allclose(v2.numpy(), v_gt, atol=2e-2)
    np.testing.assert_allclose(p2.numpy(), p_gt, atol=2e-2)


def test_port_gs_residual_zero_only_at_true_scale(one_second):
    st, (R_gt, v_gt, p_gt) = one_second
    data, _ = tfac.preint_edge_data(st)
    s_true = 2.5
    z = torch.zeros(3)
    args = ({"R": torch.eye(3), "t": z}, {"v": z}, {"b": z}, {"b": z},
            {"R": _t(R_gt), "t": _t(p_gt / s_true)}, {"v": _t(v_gt / s_true)})
    r_true = tfac.inertial_gs_residual(*args, {"R": torch.eye(3)},
                                       {"s": torch.tensor([s_true])}, data)
    r_wrong = tfac.inertial_gs_residual(*args, {"R": torch.eye(3)}, {"s": torch.ones(1)}, data)
    assert float(r_true.abs().max()) < 5e-2 and float(r_wrong.abs().max()) > 0.1
    r = tfac.inertial_residual({"R": torch.eye(3), "t": z}, {"v": z}, {"b": z}, {"b": z},
                               {"R": _t(R_gt), "t": _t(p_gt)}, {"v": _t(v_gt)}, data)
    assert float(r.abs().max()) < 3e-2


# ---------------------------------------------------------------------------
# factors against the JAX package
# ---------------------------------------------------------------------------

def _states(seed):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(2):
        w = rng.normal(size=3) * 0.3
        R = tlie.so3_exp(_t(w)).numpy()
        out.append(dict(R=R, t=rng.normal(size=3).astype(np.float32),
                        v=rng.normal(size=3).astype(np.float32),
                        bg=(rng.normal(size=3) * 1e-3).astype(np.float32),
                        ba=(rng.normal(size=3) * 1e-2).astype(np.float32)))
    return out


def _pack(st, lib):
    conv = jnp.asarray if lib == "jax" else _t
    return ({"R": conv(st["R"]), "t": conv(st["t"])}, {"v": conv(st["v"])},
            {"b": conv(st["bg"])}, {"b": conv(st["ba"])})


@pytest.mark.parametrize("which", ["inertial", "gs", "rw", "bias_prior", "pose_prior"])
def test_factor_residuals_match_jax(window, which):
    s1, s2 = _states(3)
    dj, _ = jfac.preint_edge_data(window["j"])
    dt, _ = tfac.preint_edge_data(window["t"])
    p1j, v1j, bgj, baj = _pack(s1, "jax")
    p1t, v1t, bgt, bat = _pack(s1, "torch")
    p2j, v2j, _, _ = _pack(s2, "jax")
    p2t, v2t, _, _ = _pack(s2, "torch")
    if which == "inertial":
        rj = jfac.inertial_residual(p1j, v1j, bgj, baj, p2j, v2j, dj)
        rt = tfac.inertial_residual(p1t, v1t, bgt, bat, p2t, v2t, dt)
    elif which == "gs":
        Rg = s2["R"]
        rj = jfac.inertial_gs_residual(p1j, v1j, bgj, baj, p2j, v2j, {"R": jnp.asarray(Rg)},
                                       {"s": jnp.asarray(1.7)}, dj)
        rt = tfac.inertial_gs_residual(p1t, v1t, bgt, bat, p2t, v2t, {"R": _t(Rg)},
                                       {"s": torch.tensor([1.7])}, dt)
    elif which == "rw":
        rj = jfac.bias_rw_residual(bgj, {"b": jnp.asarray(s2["bg"])}, None)
        rt = tfac.bias_rw_residual(bgt, {"b": _t(s2["bg"])}, None)
    elif which == "bias_prior":
        rj = jfac.bias_prior_residual(baj, {"prior": jnp.asarray(s2["ba"])})
        rt = tfac.bias_prior_residual(bat, {"prior": _t(s2["ba"])})
    else:
        prior = {"R0": s2["R"], "t0": s2["t"], "v0": s2["v"], "bg0p": s2["bg"],
                 "ba0p": s2["ba"]}
        rj = jfac.prior_pose_imu_residual(p1j, v1j, bgj, baj,
                                          {k: jnp.asarray(v) for k, v in prior.items()})
        rt = tfac.prior_pose_imu_residual(p1t, v1t, bgt, bat,
                                          {k: _t(v) for k, v in prior.items()})
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), atol=1e-5)


def test_edge_informations_match_jax(window):
    j, t = window["j"], window["t"]
    _, ij = jfac.preint_edge_data(j)
    _, it = tfac.preint_edge_data(t)
    for a, b in ((it, ij), (tfac.gyro_rw_info(t), jfac.gyro_rw_info(j)),
                 (tfac.acc_rw_info(t), jfac.acc_rw_info(j))):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-3, atol=1e-3 * np.abs(b).max())
    rw = tfac.rw_info6(t).numpy()
    np.testing.assert_array_equal(rw[:3, :3], tfac.gyro_rw_info(t).numpy())
    np.testing.assert_array_equal(rw[3:, 3:], tfac.acc_rw_info(t).numpy())
    assert not rw[:3, 3:].any() and not rw[3:, :3].any()


def test_gs_jacobians_match_jax_in_float32(window):
    """Forward-mode Jacobians of the gravity-scale residual in the vertex
    tangents (pose, velocity, biases, the 2-DoF gravity and the [..., 1]
    scale) agree with JAX's and stay float32."""
    s1, s2 = _states(5)
    dj, _ = jfac.preint_edge_data(window["j"])
    dt, _ = tfac.preint_edge_data(window["t"])

    def res_j(d):
        p1 = jfac.vipose_retract({"R": jnp.asarray(s1["R"]), "t": jnp.asarray(s1["t"])}, d[:6])
        g = jfac.gdir_retract({"R": jnp.asarray(s2["R"])}, d[15:17])
        s = jfac.scale_retract({"s": jnp.asarray(1.3)}, d[17:18])
        return jfac.inertial_gs_residual(
            p1, {"v": jnp.asarray(s1["v"]) + d[6:9]}, {"b": jnp.asarray(s1["bg"]) + d[9:12]},
            {"b": jnp.asarray(s1["ba"]) + d[12:15]},
            {"R": jnp.asarray(s2["R"]), "t": jnp.asarray(s2["t"])},
            {"v": jnp.asarray(s2["v"])}, g, s, dj)

    def res_t(d):
        p1 = tfac.vipose_retract({"R": _t(s1["R"]), "t": _t(s1["t"])}, d[:6])
        g = tfac.gdir_retract({"R": _t(s2["R"])}, d[15:17])
        s = tfac.scale_retract({"s": torch.tensor([1.3])}, d[17:18])
        return tfac.inertial_gs_residual(
            p1, {"v": _t(s1["v"]) + d[6:9]}, {"b": _t(s1["bg"]) + d[9:12]},
            {"b": _t(s1["ba"]) + d[12:15]}, {"R": _t(s2["R"]), "t": _t(s2["t"])},
            {"v": _t(s2["v"])}, g, s, dt)

    Jj = np.asarray(jax.jit(jax.jacfwd(res_j))(jnp.zeros(18)))
    Jt = jacfwd(res_t)(torch.zeros(18))
    assert Jt.dtype == torch.float32
    np.testing.assert_allclose(Jt.numpy(), Jj, atol=1e-4 * max(1.0, np.abs(Jj).max()))


@pytest.mark.parametrize("which", ["inertial", "gs", "prior"])
def test_closed_form_jacobians_equal_forward_mode(window, which):
    """factors' closed-form Jacobians (g2o's linearizeOplus) against jacfwd
    of the same residuals through the vertex retractions, within 1e-4 of
    the largest entry."""
    s1, s2 = _states(7)
    dt, _ = tfac.preint_edge_data(window["t"])
    dt = dict(dt, bg0=dt["bg0"] + 2e-3, ba0=dt["ba0"] - 1e-2)  # a bias away from the window's
    p1, v1, bg, ba = _pack(s1, "torch")
    p2, v2, _, _ = _pack(s2, "torch")
    Rg = tlie.so3_exp(_t([0.1, -0.05, 0.2]))

    def states(d):
        return (tfac.vipose_retract(p1, d[0:6]), {"v": v1["v"] + d[6:9]},
                {"b": bg["b"] + d[9:12]}, {"b": ba["b"] + d[12:15]},
                tfac.vipose_retract(p2, d[15:21]), {"v": v2["v"] + d[21:24]},
                tfac.gdir_retract({"R": Rg}, d[24:26]),
                tfac.scale_retract({"s": torch.tensor([1.4])}, d[26:27]))

    if which == "inertial":
        r, Js = tfac.inertial_jacobians(*states(torch.zeros(27))[:6], dt)
        J_ad = jacfwd(lambda d: tfac.inertial_residual(*states(d)[:6], dt))(torch.zeros(27))
        J = torch.cat(Js, dim=-1)
        J_ad = J_ad[:, :24]
    elif which == "gs":
        r, Js = tfac.inertial_gs_jacobians(*states(torch.zeros(27)), dt)
        J_ad = jacfwd(lambda d: tfac.inertial_gs_residual(*states(d), dt))(torch.zeros(27))
        J = torch.cat(Js, dim=-1)
    else:
        prior = {"R0": _t(s2["R"]), "t0": _t(s2["t"]), "v0": _t(s2["v"]), "bg0p": _t(s2["bg"]),
                 "ba0p": _t(s2["ba"])}

        def res(d):
            st = states(d)
            return tfac.prior_pose_imu_residual(st[0], st[1], st[2], st[3], prior)

        J = tfac.prior_pose_imu_jacobian(p1, prior)
        J_ad = jacfwd(res)(torch.zeros(27))[:, :15]
    scale = max(1.0, float(J_ad.abs().max()))
    np.testing.assert_allclose(J.numpy(), J_ad.numpy(), atol=1e-4 * scale)
