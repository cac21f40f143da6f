"""The port's LM engine (lm/{problem,edges,dense,schur}) against the JAX
package, on test_lm_schur.py's multi-view scene (3 cameras, 40 points, two
cameras fixed).

- schur.solve and dense.solve reach JAX's poses within 1e-3 and its final
  cost within 1%;
- inv3x3 matches within 1e-5;
- each ported residual (mono and stereo, full and pose-only) and its
  Jacobians through the retracts match within 1e-4 relative;
- a system that is not positive definite (negative information) gives what
  JAX gives: NaN from the Cholesky, a zero step, no accepted iteration and
  the state unchanged, not an exception.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam3_tpu.frontend import camera as jcam
from orb_slam3_tpu.lm import dense as jdense
from orb_slam3_tpu.lm import edges as jedges
from orb_slam3_tpu.lm import schur as jschur
from orb_slam3_tpu.lm.problem import EdgeBatch as JEdgeBatch
from orb_slam3_tpu.lm.problem import Problem as JProblem
from orb_slam3_tpu.ops import lie as jlie
from orb_slam3_tpu_torch.frontend import camera as tcam
from orb_slam3_tpu_torch.lm import dense as tdense
from orb_slam3_tpu_torch.lm import edges as tedges
from orb_slam3_tpu_torch.lm import schur as tschur
from orb_slam3_tpu_torch.lm.problem import EdgeBatch, Problem
from test_lm_schur import build_ba_problem, multi_view_scene

torch.set_num_threads(1)
ITERS = 15


def T(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def scene():
    scene_fn = jax.jit(multi_view_scene, static_argnums=(1, 2, 3))  # one compile, not eager ops
    X, R, t, uv = scene_fn(jax.random.PRNGKey(0), 3, 40, 0.2)
    X0 = X + 0.1 * jax.random.normal(jax.random.PRNGKey(1), X.shape)
    dxi = 0.03 * jax.random.normal(jax.random.PRNGKey(2), (3, 6))
    dxi = dxi.at[0].set(0.0).at[1].set(0.0)
    dR, dt = jlie.se3_exp(dxi)
    R0, t0 = jlie.se3_mul(dR, dt, R, t)
    fixed = jnp.array([True, True, False])
    return dict(R0=R0, t0=t0, X0=X0, uv=uv, fixed=fixed,
                bap=build_ba_problem(R0, t0, X0, uv, fixed, huber=float(np.sqrt(5.991))))


def _port_ba(sc, info_sign=1.0):
    b = sc["bap"]
    res = tedges.make_mono_residual(tcam.PINHOLE)
    return tschur.BAProblem(
        cams=tedges.make_pose_block(T(sc["R0"]), T(sc["t0"]), T(sc["fixed"])),
        points=T(sc["X0"]), point_fixed=T(b.point_fixed),
        cam_idx=T(b.cam_idx), lm_idx=T(b.lm_idx),
        obs_data={k: T(v) for k, v in b.obs_data.items()},
        obs_info=info_sign * T(b.obs_info), obs_mask=T(b.obs_mask), cam_edges=(),
        residual_dim=2, residual=lambda c, x, d: res(c, {"x": x}, d), huber_delta=b.huber_delta,
    )


@pytest.fixture(scope="module")
def schur_runs(scene):
    """JAX and port Schur solves, normal and with negated information; one
    jit of the JAX solve for both."""
    jsolve = jax.jit(lambda p: jschur.solve(p, num_iters=ITERS, lam0=1e-6))
    out = {}
    for sign in (1.0, -1.0):
        jp = dataclasses.replace(scene["bap"], obs_info=sign * scene["bap"].obs_info)
        out[sign] = (jsolve(jp), tschur.solve(_port_ba(scene, sign), num_iters=ITERS, lam0=1e-6))
    return out


def test_schur_solve_matches_jax(schur_runs):
    (jp, js), (tp, ts) = schur_runs[1.0]
    assert int(ts.accepted) >= 1 and float(ts.cost) < 0.5 * float(ts.cost0)
    np.testing.assert_allclose(float(ts.cost0), float(js.cost0), rtol=1e-5)
    np.testing.assert_allclose(float(ts.cost), float(js.cost), rtol=0.01)
    for k in ("R", "t"):
        np.testing.assert_allclose(tp.cams.state[k].numpy(), np.asarray(jp.cams.state[k]), atol=1e-3)
    np.testing.assert_allclose(tp.points.numpy(), np.asarray(jp.points), atol=1e-3)


def test_schur_solve_not_positive_definite_rejects(schur_runs, scene):
    (jp, js), (tp, ts) = schur_runs[-1.0]
    assert int(js.accepted) == 0 and int(ts.accepted) == 0
    np.testing.assert_array_equal(tp.cams.state["t"].numpy(), np.asarray(scene["t0"]))
    np.testing.assert_array_equal(tp.points.numpy(), np.asarray(scene["X0"]))
    assert float(ts.cost) == float(ts.cost0)


def _dense_problems(sc, sign):
    b = sc["bap"]
    jres = jedges.make_mono_residual(jcam.PINHOLE)
    jp = JProblem(
        blocks={"pose": jedges.make_pose_block(sc["R0"], sc["t0"], fixed=sc["fixed"]),
                "point": jedges.make_point_block(sc["X0"], fixed=jnp.zeros(40, bool))},
        edges=(JEdgeBatch(indices=(b.cam_idx, b.lm_idx), data=b.obs_data,
                          info=sign * b.obs_info, mask=b.obs_mask,
                          vertex_blocks=("pose", "point"), residual_dim=2,
                          residual=jres, huber_delta=None),))
    tp = Problem(
        blocks={"pose": tedges.make_pose_block(T(sc["R0"]), T(sc["t0"]), T(sc["fixed"])),
                "point": tedges.make_point_block(T(sc["X0"]), torch.zeros(40, dtype=torch.bool))},
        edges=(EdgeBatch(indices=(T(b.cam_idx), T(b.lm_idx)),
                         data={k: T(v) for k, v in b.obs_data.items()},
                         info=sign * T(b.obs_info), mask=T(b.obs_mask),
                         vertex_blocks=("pose", "point"), residual_dim=2,
                         residual=tedges.make_mono_residual(tcam.PINHOLE)),))
    return jp, tp


@pytest.fixture(scope="module")
def dense_runs(scene):
    jsolve = jax.jit(lambda p: jdense.solve(p, num_iters=ITERS, lam0=1e-6))
    out = {}
    for sign in (1.0, -1.0):
        jp, tp = _dense_problems(scene, sign)
        out[sign] = (jsolve(jp), tdense.solve(tp, num_iters=ITERS, lam0=1e-6))
    return out


def test_dense_solve_matches_jax(dense_runs):
    (jp, js), (tp, ts) = dense_runs[1.0]
    assert int(ts.accepted) >= 1
    np.testing.assert_allclose(float(ts.cost), float(js.cost), rtol=0.01)
    for k in ("R", "t"):
        np.testing.assert_allclose(tp.blocks["pose"].state[k].numpy(),
                                   np.asarray(jp.blocks["pose"].state[k]), atol=1e-3)
    np.testing.assert_allclose(tp.blocks["point"].state["x"].numpy(),
                               np.asarray(jp.blocks["point"].state["x"]), atol=1e-3)


def test_dense_solve_not_positive_definite_rejects(dense_runs, scene):
    (jp, js), (tp, ts) = dense_runs[-1.0]
    assert int(js.accepted) == 0 and int(ts.accepted) == 0
    np.testing.assert_array_equal(tp.blocks["pose"].state["t"].numpy(), np.asarray(scene["t0"]))
    np.testing.assert_array_equal(tp.blocks["point"].state["x"].numpy(), np.asarray(scene["X0"]))


def test_inv3x3_matches_jax():
    rng = np.random.default_rng(0)
    A = rng.normal(size=(64, 3, 3)).astype(np.float32)
    M = A @ A.transpose(0, 2, 1) + 0.5 * np.eye(3, dtype=np.float32)
    M[0] = 0.0  # singular: the determinant floor
    ref = np.asarray(jschur.inv3x3(jnp.asarray(M)))
    got = tschur.inv3x3(T(M)).numpy()
    np.testing.assert_allclose(got[1:], ref[1:], rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_allclose(got[1:] @ M[1:], np.broadcast_to(np.eye(3), (63, 3, 3)), atol=1e-3)


@pytest.mark.parametrize("name", ["mono", "mono_pose_only", "stereo", "stereo_pose_only"])
def test_edge_residuals_and_jacobians_match_jax(name):
    """Each ported residual, and its Jacobians through the retracts, on 16
    random edges: within 1e-4 relative."""
    rng = np.random.default_rng(3)
    n = 16
    xi = rng.normal(0, 0.1, (n, 6)).astype(np.float32)
    R, t = (np.asarray(a) for a in jlie.se3_exp(jnp.asarray(xi)))
    X = np.concatenate([rng.uniform(-1, 1, (n, 2)), rng.uniform(3, 6, (n, 1))], 1).astype(np.float32)
    K = np.tile(np.float32([450, 450, 320, 240, 0, 0, 0, 0]), (n, 1))
    data = {"K": K, "uv": rng.uniform(0, 600, (n, 2)).astype(np.float32),
            "uvr": rng.uniform(0, 600, (n, 3)).astype(np.float32),
            "bf": np.full(n, 40.0, np.float32), "Xw": X}
    stereo = name.startswith("stereo")
    keys = ("uvr", "K", "bf") if stereo else ("uv", "K")
    pose_only = name.endswith("pose_only")
    if pose_only:
        keys = keys + ("Xw",)
    make = f"make_{name.split('_')[0]}{'_pose_only' if pose_only else ''}_residual"
    jres, tres = getattr(jedges, make)(0), getattr(tedges, make)(0)
    jd = {k: jnp.asarray(data[k]) for k in keys}
    td = {k: T(data[k]) for k in keys}
    jpose, tpose = {"R": jnp.asarray(R), "t": jnp.asarray(t)}, {"R": T(R), "t": T(t)}
    z6 = np.zeros((n, 6), np.float32)
    z3 = np.zeros((n, 3), np.float32)
    if pose_only:
        def jf(d6, p, d):
            return jres(jedges.se3_retract(p, d6), d)

        def tf(d6, p, d):
            return tres(tedges.se3_retract(p, d6), d)

        jargs, targs = (jnp.asarray(z6), jpose, jd), (T(z6), tpose, td)
        jr = jax.jit(jax.vmap(jres))(jpose, jd)
        tr = torch.func.vmap(tres)(tpose, td)
        argnums = 0
    else:
        def jf(d6, d3, p, x, d):
            return jres(jedges.se3_retract(p, d6), {"x": x + d3}, d)

        def tf(d6, d3, p, x, d):
            return tres(tedges.se3_retract(p, d6), {"x": x + d3}, d)

        jargs = (jnp.asarray(z6), jnp.asarray(z3), jpose, jnp.asarray(X), jd)
        targs = (T(z6), T(z3), tpose, T(X), td)
        jr = jax.jit(jax.vmap(jres))(jpose, {"x": jnp.asarray(X)}, jd)
        tr = torch.func.vmap(tres)(tpose, {"x": T(X)}, td)
        argnums = (0, 1)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=1e-4, atol=1e-3)
    jJ = jax.jit(jax.vmap(jax.jacfwd(jf, argnums=argnums)))(*jargs)
    tJ = torch.func.vmap(torch.func.jacfwd(tf, argnums=argnums))(*targs)
    for a, b in zip(jax.tree_util.tree_leaves(jJ), (tJ,) if pose_only else tJ):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-4, atol=1e-2)
