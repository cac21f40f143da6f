"""The port's Sim(3) algebra, Sim3 solver and essential graph against the
JAX package (ops/lie.py Sim3 and quaternions, lm/edges.py Sim3 and
relative-pose edges, graphopt/sim3_solver.py, graphopt/essential.py), on
the same numpy-seeded inputs. Tolerances as tests/test_graphopt.py:23-34
(R 1e-5, s 1e-5, t 1e-4) where they apply, else 1e-4:

- sim3_exp / log / mul / inv / apply and the quaternions, with the
  small-angle and small-sigma branches, and the Sim3 edges' residuals and
  Jacobians (vmap of jacfwd, as the LM engine takes them);
- horn_sim3 (free and fixed scale), sim3_ransac with the JAX package's
  minimal sets handed in (inlier masks equal, R 1e-4, t 1e-3, s 1e-4),
  optimize_sim3 (inliers equal);
- the 7-DoF and 4-DoF essential graphs on a drifted loop within 1e-4,
  build_essential_edges and correct_map_after_pgo on a map state.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import jacfwd, vmap

from orb_slam3_tpu.atlas import state as jstate
from orb_slam3_tpu.frontend import camera as jcam
from orb_slam3_tpu.graphopt import essential as jess
from orb_slam3_tpu.graphopt import sim3_solver as jsim
from orb_slam3_tpu.lm import edges as jedges
from orb_slam3_tpu.ops import lie as jlie
from orb_slam3_tpu_torch import convert
from orb_slam3_tpu_torch.atlas import state as tstate
from orb_slam3_tpu_torch.graphopt import essential as tess
from orb_slam3_tpu_torch.graphopt import sim3_solver as tsim
from orb_slam3_tpu_torch.lm import edges as tedges
from orb_slam3_tpu_torch.ops import lie as tlie

K_NP = np.asarray([400.0, 400.0, 320.0, 240.0, 0, 0, 0, 0], np.float32)


def T(a):
    return torch.from_numpy(np.array(a))


def _xi(n=8, seed=0):
    xi = (np.random.default_rng(seed).normal(size=(n, 7)) * 0.4).astype(np.float32)
    xi[0, 3:6] = 0.0           # no rotation
    xi[1, 6] = 0.0             # no scale change
    xi[2, 3:] = 1e-9           # both tiny
    xi[3, 3:6] = [0.0, 0.0, 3.0]
    return xi


def _sim3_ops(lie, xi, X):
    """Every Sim3 / quaternion op of `lie` on the same inputs, in order."""
    R, t, s = lie.sim3_exp(xi)
    a, b = slice(0, 4), slice(4, 8)
    q = lie.rot_to_quat(R)
    return (R, t, s, lie.sim3_log(R, t, s),
            *lie.sim3_mul(R[a], t[a], s[a], R[b], t[b], s[b]), *lie.sim3_inv(R, t, s),
            lie.sim3_apply(R, t, s, X), q, lie.quat_to_rot(q))


def test_sim3_ops_match_jax():
    xi = _xi()
    X = np.random.default_rng(1).normal(size=(8, 3)).astype(np.float32)
    want = jax.jit(lambda a, b: _sim3_ops(jlie, a, b))(jnp.asarray(xi),
                                                                   jnp.asarray(X))
    got = _sim3_ops(tlie, T(xi), T(X))
    # R, t, s, log, mul (R, t, s), inv (R, t, s), apply, quaternion, its rotation
    tol = [1e-5, 1e-4, 1e-5, 1e-4, 1e-4, 1e-4, 1e-4, 1e-4, 1e-4, 1e-4, 1e-4, 1e-5, 1e-5]
    for g, w, atol in zip(got, want, tol):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=atol)
    np.testing.assert_allclose(got[-1].numpy(), got[0].numpy(), atol=1e-5)


def _edge_inputs(seed=2, n=6):
    rng = np.random.default_rng(seed)
    xi = (rng.normal(size=(3 * n, 7)) * 0.3).astype(np.float32)
    xi[:n, 6] = 0.0
    Rs, ts, ss = jlie.sim3_exp(jnp.asarray(xi))
    return [np.asarray(a) for a in (Rs, ts, ss)], n


def test_sim3_edge_jacobians_are_the_same_batched_and_alone():
    """The port alone (the JAX parity below is slow: its compile): the
    relative Sim3 edge's Jacobians from vmap(jacfwd) over a batch equal
    jacfwd edge by edge; torch.linalg.solve inside sim3_log gave wrong
    tangents to every batch element after the first."""
    (R, t, s), n = _edge_inputs()
    i, j, m = slice(0, n), slice(n, 2 * n), slice(2 * n, 3 * n)

    def tres(d, Ri, ti, si, Rj_, tj_, sj_, Rm, tm, sm):
        a = tedges.sim3_retract({"R": Ri, "t": ti, "s": si}, d[:7])
        b = tedges.sim3_retract({"R": Rj_, "t": tj_, "s": sj_}, d[7:])
        return tedges.relative_sim3_residual(a, b, {"R_ji": Rm, "t_ji": tm, "s_ji": sm})

    args = [T(a) for a in (R[i], t[i], s[i], R[j], t[j], s[j], R[m], t[m], s[m])]
    batched = vmap(jacfwd(tres))(torch.zeros(n, 14), *args)
    for e in range(n):
        alone = jacfwd(tres)(torch.zeros(14), *[a[e] for a in args])
        torch.testing.assert_close(batched[e], alone, atol=1e-5, rtol=0)
    assert batched.dtype == torch.float32


@pytest.mark.slow
def test_sim3_edges_match_jax_under_vmap_jacfwd():
    """Residuals and Jacobians of the pose-graph edges over a batch, the way
    the LM engine linearizes them (the batch is where torch.linalg.solve's
    forward derivative went wrong; sim3_log solves by Cramer's rule)."""
    (R, t, s), n = _edge_inputs()
    i, j, m = slice(0, n), slice(n, 2 * n), slice(2 * n, 3 * n)

    def jres(d, Ri, ti, si, Rj_, tj_, sj_, Rm, tm, sm):
        a = jedges.sim3_retract({"R": Ri, "t": ti, "s": si}, d[:7])
        b = jedges.sim3_retract({"R": Rj_, "t": tj_, "s": sj_}, d[7:])
        return jedges.relative_sim3_residual(a, b, {"R_ji": Rm, "t_ji": tm, "s_ji": sm})

    def tres(d, Ri, ti, si, Rj_, tj_, sj_, Rm, tm, sm):
        a = tedges.sim3_retract({"R": Ri, "t": ti, "s": si}, d[:7])
        b = tedges.sim3_retract({"R": Rj_, "t": tj_, "s": sj_}, d[7:])
        return tedges.relative_sim3_residual(a, b, {"R_ji": Rm, "t_ji": tm, "s_ji": sm})

    args = (R[i], t[i], s[i], R[j], t[j], s[j], R[m], t[m], s[m])
    z = np.zeros((n, 14), np.float32)
    want_r, want_J = jax.jit(lambda *a: (jax.vmap(jres)(*a), jax.vmap(jax.jacfwd(jres))(*a)))(
        jnp.asarray(z), *map(jnp.asarray, args))
    got_r = vmap(tres)(T(z), *map(T, args))
    got_J = vmap(jacfwd(tres))(T(z), *map(T, args))
    np.testing.assert_allclose(got_r.numpy(), np.asarray(want_r), atol=1e-4)
    np.testing.assert_allclose(got_J.numpy(), np.asarray(want_J), atol=1e-4)

    # the relative SE3 edge and the Sim3 point edges (both directions)
    r_se3 = tedges.relative_se3_residual({"R": T(R[0]), "t": T(t[0])},
                                         {"R": T(R[1]), "t": T(t[1])},
                                         {"R_ji": T(R[2]), "t_ji": T(t[2])})
    w_se3 = jedges.relative_se3_residual({"R": R[0], "t": t[0]}, {"R": R[1], "t": t[1]},
                                         {"R_ji": R[2], "t_ji": t[2]})
    np.testing.assert_allclose(r_se3.numpy(), np.asarray(w_se3), atol=1e-4)
    data = {"uv": np.array([300.0, 200.0], np.float32), "K": K_NP,
            "Xc": np.array([0.3, -0.2, 5.0], np.float32)}
    for inverse in (False, True):
        got = tedges.make_sim3_point_residual(0, inverse)(
            {"R": T(R[3]), "t": T(t[3]), "s": T(s[3])}, {k: T(v) for k, v in data.items()})
        want = jedges.make_sim3_point_residual(0, inverse)(
            {"R": R[3], "t": t[3], "s": s[3]}, data)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-3)


def test_horn_sim3_matches_jax():
    rng = np.random.default_rng(0)
    P = (rng.normal(size=(50, 3)) * 2.0).astype(np.float32)
    Rg, tg, sg = jlie.sim3_exp(jnp.array([0.5, -1.0, 2.0, 0.3, -0.2, 0.5, 0.53]))
    Q = np.asarray(sg * (jnp.asarray(P) @ Rg.T) + tg) + 0.01 * rng.normal(size=(50, 3))
    Q = Q.astype(np.float32)
    w = rng.uniform(0.2, 1.0, 50).astype(np.float32)
    for fix in (False, True):
        Rj, tj, sj = jsim.horn_sim3(jnp.asarray(P), jnp.asarray(Q), jnp.asarray(w), fix)
        Rt, tt, st = tsim.horn_sim3(T(P), T(Q), T(w), fix)
        np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), atol=1e-5)
        np.testing.assert_allclose(float(st), float(sj), atol=1e-5)
        np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=1e-4)


@pytest.fixture(scope="module")
def sim3_problem():
    """Two 'maps' of one scene related by a Sim3 (drift), 25% wrong
    matches (tests/test_graphopt.py's RANSAC case)."""
    key = jax.random.PRNGKey(2)
    n = 80
    X1 = jnp.concatenate([jax.random.uniform(key, (n, 2), minval=-2, maxval=2),
                          jax.random.uniform(jax.random.PRNGKey(3), (n, 1), minval=4,
                                             maxval=8)], axis=-1)
    Rd, td, sd = jlie.sim3_exp(jnp.array([0.2, -0.1, 0.3, 0.05, 0.1, -0.04, 0.15]))
    X2 = sd * (X1 @ Rd.T) + td
    X2 = X2.at[:20].set(jax.random.uniform(jax.random.PRNGKey(4), (20, 3), minval=-5, maxval=5))
    K = jnp.asarray(K_NP)
    uv1 = jcam.pinhole_project(K, X1)
    uv2 = jcam.pinhole_project(K, sd * (X1 @ Rd.T) + td)
    return dict(K=K, X1=X1, X2=X2, uv1=uv1, uv2=uv2, valid=jnp.ones(n, bool),
                I=jnp.eye(3), z=jnp.zeros(3))


def test_sim3_ransac_matches_jax_with_its_sets(sim3_problem):
    p = sim3_problem
    key = jax.random.PRNGKey(5)
    base = (p["X1"], p["X2"], p["valid"], p["I"], p["z"], p["I"], p["z"], p["uv1"], p["uv2"])
    for fix in (False, True):
        want = jax.jit(jsim.sim3_ransac, static_argnames=("kind", "fix_scale"))(
            key, jcam.PINHOLE, p["K"], *base, fix_scale=fix)
        g = jnp.where(p["valid"][None, :], jax.random.uniform(key, (128, 80)), -1.0)
        sets = T(np.asarray(jax.lax.top_k(g, 3)[1]))
        got = tsim.sim3_ransac(jcam.PINHOLE, T(p["K"]), *map(T, base), sets=sets, fix_scale=fix)
        np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=1e-4)
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=1e-3)
        np.testing.assert_allclose(float(got[2]), float(want[2]), atol=1e-4)
        assert int(got[4]) == int(want[4])
    assert int(want[4]) < 80


def test_optimize_sim3_matches_jax(sim3_problem):
    p = sim3_problem
    X1, X2 = np.asarray(p["X1"]), np.asarray(p["X2"])
    Rd, td, sd = jlie.sim3_exp(jnp.array([0.2, -0.1, 0.3, 0.05, 0.1, -0.04, 0.15]))
    Ri, ti, si = jlie.sim3_inv(Rd, td, sd)                   # S12: cam2 -> cam1
    dR, dt, ds = jlie.sim3_exp(jnp.array([0.004, -0.006, 0.002, 0.002, -0.001, 0.0015, 0.004]))
    R0, t0, s0 = jlie.sim3_mul(dR, dt, ds, Ri, ti, si)
    # 10 of the 20 wrong matches stay in (all 20 drive the reference's
    # undamped Gauss-Newton to a point behind the camera, NaN in JAX)
    valid = np.ones(80, bool)
    valid[10:20] = False
    valid_inv = valid.copy()
    valid_inv[::3] = False
    for fix in (False, True):
        want = jsim.optimize_sim3(jcam.PINHOLE, p["K"], jnp.asarray(X1), jnp.asarray(X2),
                                  p["uv1"], p["uv2"], jnp.asarray(valid), R0, t0, s0,
                                  valid_inv=jnp.asarray(valid_inv), fix_scale=fix)
        got = tsim.optimize_sim3(jcam.PINHOLE, T(p["K"]), T(X1), T(X2), T(p["uv1"]),
                                 T(p["uv2"]), T(valid), T(R0), T(t0), float(s0),
                                 valid_inv=T(valid_inv), fix_scale=fix)
        np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=1e-5)
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=1e-4)
        np.testing.assert_allclose(float(got[2]), float(want[2]), atol=1e-5)
    assert int(want[4]) >= 55


def _drifted_loop(n, seed, yaw_only=False):
    """A circle of n poses with growing drift and the true relative poses of
    consecutive keyframes plus the loop edge (tests/test_graphopt.py)."""
    ang = np.linspace(0, 2 * np.pi, n, endpoint=False)
    t_gt = np.stack([np.cos(ang), np.sin(ang), 0.1 * np.sin(2 * ang)], -1)
    R_gt = np.asarray(jlie.so3_exp(jnp.asarray(np.stack([0 * ang, 0 * ang, ang], -1),
                                               jnp.float32)))
    rng = np.random.default_rng(seed)
    R0, t0 = [], []
    for i in range(n):
        if yaw_only:
            dR = np.asarray(jlie.so3_exp(jnp.asarray([0.0, 0.0, 0.04 * rng.normal() * i / n])))
            R0.append(dR @ R_gt[i])
            t0.append(t_gt[i] + 0.05 * rng.normal(size=3) * (i / n))
        else:
            dR, dt = jlie.se3_exp(jnp.asarray(0.03 * rng.normal(size=6) * (i / n), jnp.float32))
            Ri, ti = jlie.se3_mul(dR, dt, jnp.asarray(R_gt[i]),
                                  jnp.asarray(t_gt[i] * (1.0 + 0.35 * i / n)))
            R0.append(np.asarray(Ri))
            t0.append(np.asarray(ti))
    src = np.arange(n, dtype=np.int32)
    dst = (src + 1) % n
    Rr, tr = [], []
    for i in range(n):
        Ri, ti = jlie.se3_inv(jnp.asarray(R_gt[i]), jnp.asarray(t_gt[i]))
        a, b = jlie.se3_mul(jnp.asarray(R_gt[dst[i]]), jnp.asarray(t_gt[dst[i]]), Ri, ti)
        Rr.append(np.asarray(a))
        tr.append(np.asarray(b))
    fixed = np.zeros(n, bool)
    fixed[0] = True
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return f32(np.stack(R0)), f32(np.stack(t0)), fixed, src, dst, f32(np.stack(Rr)), \
        f32(np.stack(tr))


def _check_7dof(n, iters):
    R0, t0, fixed, src, dst, Rr, tr = _drifted_loop(n, 0)
    s0 = np.ones(n, np.float32)
    want = jax.jit(jess.optimize_essential_graph, static_argnames=("iters",))(
        jnp.asarray(R0), jnp.asarray(t0), jnp.asarray(s0), jnp.asarray(fixed), jnp.asarray(src),
        jnp.asarray(dst), jnp.asarray(Rr), jnp.asarray(tr), jnp.ones(n), jnp.ones(n, bool),
        iters=iters)
    got = tess.optimize_essential_graph(T(R0), T(t0), T(s0), T(fixed), T(src), T(dst), T(Rr),
                                        T(tr), torch.ones(n), torch.ones(n, dtype=torch.bool),
                                        iters=iters)
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4)
    assert float(got[3].cost) < 0.05 * float(got[3].cost0)


def _check_4dof(n, iters):
    R0, t0, fixed, src, dst, Rr, tr = _drifted_loop(n, 1, yaw_only=True)
    want = jax.jit(jess.optimize_essential_graph_4dof, static_argnames=("iters",))(
        jnp.asarray(R0), jnp.asarray(t0), jnp.asarray(fixed), jnp.asarray(src),
        jnp.asarray(dst), jnp.asarray(Rr), jnp.asarray(tr), jnp.ones(n, bool), iters=iters)
    got = tess.optimize_essential_graph_4dof(T(R0), T(t0), T(fixed), T(src), T(dst), T(Rr),
                                             T(tr), torch.ones(n, dtype=torch.bool), iters=iters)
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4)
    np.testing.assert_allclose(got[0].numpy()[:, 2, 2], R0[:, 2, 2], atol=1e-5)


def test_essential_graph_7dof_closes_a_drifted_loop():
    """The port alone (the JAX parity below is slow: its compile): an
    8-keyframe loop with growing scale drift, 10 iterations, the camera
    centres pulled to the truth."""
    R0, t0, fixed, src, dst, Rr, tr = _drifted_loop(8, 0)
    n = len(src)
    R, t, s, st = tess.optimize_essential_graph(
        T(R0), T(t0), torch.ones(n), T(fixed), T(src), T(dst), T(Rr), T(tr), torch.ones(n),
        torch.ones(n, dtype=torch.bool), iters=10)
    assert float(st.cost) < 0.01 * float(st.cost0)
    centres = -torch.einsum("nij,ni->nj", R, t / s[:, None]).numpy()
    ang = np.linspace(0, 2 * np.pi, n, endpoint=False)
    gt = np.stack([np.cos(ang), np.sin(ang), 0.1 * np.sin(2 * ang)], -1)
    gt_c = -np.einsum("nji,nj->ni", np.asarray(jlie.so3_exp(jnp.asarray(
        np.stack([0 * ang, 0 * ang, ang], -1), jnp.float32))), gt)
    assert np.abs(centres - gt_c).max() < 0.05


def test_essential_graph_4dof_keeps_roll_and_pitch():
    """The port alone: a yaw-and-translation drifted loop, 6 iterations;
    the third rotation row's z entry (gravity) stays, the cost drops."""
    R0, t0, fixed, src, dst, Rr, tr = _drifted_loop(8, 1, yaw_only=True)
    n = len(src)
    R, t, st = tess.optimize_essential_graph_4dof(T(R0), T(t0), T(fixed), T(src), T(dst), T(Rr),
                                                  T(tr), torch.ones(n, dtype=torch.bool), iters=6)
    np.testing.assert_allclose(R.numpy()[:, 2, 2], R0[:, 2, 2], atol=1e-5)
    assert float(st.cost) < 0.1 * float(st.cost0)


@pytest.mark.slow
@pytest.mark.parametrize("n,iters", [(8, 6), (16, 20)])
def test_essential_graph_7dof_matches_jax(n, iters):
    """Against the JAX package, the 16-keyframe case at tests/test_graphopt.py's
    size (20 iterations)."""
    _check_7dof(n, iters)


@pytest.mark.slow
@pytest.mark.parametrize("n,iters", [(8, 6), (12, 20)])
def test_essential_graph_4dof_matches_jax(n, iters):
    _check_4dof(n, iters)


def test_essential_edges_and_map_correction_match_jax():
    """build_essential_edges (tree + covisibility >= 100 + a loop edge) and
    correct_map_after_pgo on a map state with a spanning tree, landmarks
    hosted by keyframes and an invalid keyframe."""
    rng = np.random.default_rng(3)
    K, L = 8, 64
    s = tstate.empty(kmax=K, fmax=16, lmax=L, device="cpu")
    R, t, _ = tlie.sim3_exp(T((rng.normal(size=(K, 7)) * 0.2).astype(np.float32)))
    valid = np.array([1, 1, 1, 1, 0, 1, 1, 0], bool)
    parent = np.array([-1, 0, 1, 2, 3, 3, 5, 6], np.int32)
    import dataclasses
    s = dataclasses.replace(
        s, kf_R=R, kf_t=t, kf_valid=T(valid), kf_parent=T(parent), n_kf=torch.tensor(8),
        lm_pos=T(rng.normal(size=(L, 3)).astype(np.float32)),
        lm_valid=T(rng.random(L) > 0.2), lm_first_kf=T(rng.integers(-1, K, L).astype(np.int32)))
    W = rng.integers(0, 200, (K, K)).astype(np.int32)
    W = np.triu(W, 1) + np.triu(W, 1).T
    js = jstate.MapState(**{k: jnp.asarray(v) for k, v in convert.map_state_arrays(s).items()})
    loop = (np.array([6]), np.array([1]), np.asarray(R[2:3]), np.asarray(t[2:3]),
            np.array([1.1], np.float32))
    want = jess.build_essential_edges(js, jnp.asarray(W), extra_edges=loop)
    got = tess.build_essential_edges(s, T(W), extra_edges=loop)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6)

    nR, nt, ns = tlie.sim3_exp(T((rng.normal(size=(K, 7)) * 0.2).astype(np.float32)))
    want_s = jess.correct_map_after_pgo(js, js.kf_R, js.kf_t, jnp.asarray(nR.numpy()),
                                        jnp.asarray(nt.numpy()), jnp.asarray(ns.numpy()))
    got_s = tess.correct_map_after_pgo(s, s.kf_R, s.kf_t, nR, nt, ns)
    for name in ("lm_pos", "kf_R", "kf_t"):
        np.testing.assert_allclose(getattr(got_s, name).numpy(),
                                   np.asarray(getattr(want_s, name)), atol=1e-4)
