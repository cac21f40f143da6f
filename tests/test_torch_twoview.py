"""The port's matching functions and two-view reconstruction against the
JAX package.

Matching (mutual filter, rotation histogram, init search, brute force) is
exact. Two-view reconstruction runs the scenes of test_matching_twoview.py
(general, planar, 40 outliers, pure rotation) with the minimal sets JAX
draws handed to both sides: success and used_h equal, R within 1e-3,
t . t_jax > 0.9999, good equal on >= 99% of the rows.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam3_tpu.frontend import camera as jcam
from orb_slam3_tpu.frontend import matching as jm
from orb_slam3_tpu.frontend import two_view as jtv
from orb_slam3_tpu.ops import lie as jlie
from orb_slam3_tpu_torch.frontend import matching as tm
from orb_slam3_tpu_torch.frontend import two_view as ttv

torch.set_num_threads(1)
K_NP = np.asarray([450.0, 450.0, 320.0, 240.0, 0, 0, 0, 0], np.float32)


def T(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    return np.asarray(x)


def test_mutual_filter_and_brute_force_exact():
    rng = np.random.default_rng(0)
    a = rng.integers(0, 256, (60, 32), dtype=np.uint8)
    b = a[rng.permutation(60)] ^ (rng.uniform(size=(60, 32)) < 0.03).astype(np.uint8)
    b[:10] = rng.integers(0, 256, (10, 32), dtype=np.uint8)
    va, vb = rng.uniform(size=60) > 0.1, rng.uniform(size=60) > 0.1
    for ratio in (0.75, 0.9):
        ji, jd, jok = jm.search_by_brute_force(jnp.asarray(a), jnp.asarray(va), jnp.asarray(b),
                                               jnp.asarray(vb), ratio=ratio)
        ti, td, tok = tm.search_by_brute_force(T(a), T(va), T(b), T(vb), ratio=ratio)
        np.testing.assert_array_equal(tok.numpy(), _np(jok))
        np.testing.assert_array_equal(ti.numpy(), _np(ji))
        np.testing.assert_array_equal(td.numpy(), _np(jd))
    idx_ab, idx_ba = rng.integers(0, 60, 60), rng.integers(0, 60, 60)
    idx_ba[idx_ab[:30]] = np.arange(30)
    ok = rng.uniform(size=60) > 0.2
    np.testing.assert_array_equal(
        tm.mutual_filter(T(idx_ab), T(ok), T(idx_ba)).numpy(),
        _np(jm.mutual_filter(jnp.asarray(idx_ab), jnp.asarray(ok), jnp.asarray(idx_ba))))


def test_search_for_initialization_exact():
    rng = np.random.default_rng(1)
    n = 200
    xy0 = rng.uniform(0, 300, (n, 2)).astype(np.float32)
    xy1 = (xy0 + rng.normal(0, 20, (n, 2))).astype(np.float32)
    d0 = rng.integers(0, 256, (n, 32), dtype=np.uint8)
    d1 = d0 ^ (rng.uniform(size=(n, 32)) < 0.04).astype(np.uint8)
    v0, v1 = rng.uniform(size=n) > 0.05, rng.uniform(size=n) > 0.05
    ji, jok = jm.search_for_initialization(*(jnp.asarray(x) for x in (xy0, d0, v0, xy1, d1, v1)))
    ti, tok = tm.search_for_initialization(*(T(x) for x in (xy0, d0, v0, xy1, d1, v1)))
    assert int(jok.sum()) > 100
    np.testing.assert_array_equal(tok.numpy(), _np(jok))
    np.testing.assert_array_equal(ti.numpy(), _np(ji))


@pytest.mark.parametrize("case", ["spread", "tie"])
def test_rotation_consistency_exact(case):
    rng = np.random.default_rng(2)
    n = 120
    ang_b = rng.uniform(0, 2 * np.pi, n).astype(np.float32)
    idx = rng.permutation(n)
    rot = rng.choice([0.1, 0.75, 1.4, 3.0], n, p=[0.5, 0.3, 0.15, 0.05])
    if case == "tie":
        # bins 2, 9 and 14 hold 30 matches each and bin 20 holds 30 too: the
        # tie for the third place straddles the top-3 cutoff; lax.top_k
        # keeps the lower bin
        rot = np.repeat(np.deg2rad([2 * 12 + 6, 9 * 12 + 6, 14 * 12 + 6, 20 * 12 + 6]), 30)
    ang_a = (ang_b[idx] + rot).astype(np.float32)
    ok = np.ones(n, bool)
    if case == "spread":
        ok[::7] = False
    got = tm.rotation_consistency(T(ang_a), T(ang_b), T(idx), T(ok)).numpy()
    ref = _np(jm.rotation_consistency(jnp.asarray(ang_a), jnp.asarray(ang_b),
                                      jnp.asarray(idx), jnp.asarray(ok)))
    np.testing.assert_array_equal(got, ref)
    if case == "tie":
        assert got[:90].all() and not got[90:].any()


def _scene(planar: bool, seed=0, n=200, noise=0.4):
    """test_matching_twoview.TestTwoView._scene."""
    rng = np.random.default_rng(seed)
    z = np.full(n, 5.0) if planar else rng.uniform(4, 9, n)
    X = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n), z], axis=-1)
    X = jnp.asarray(X, jnp.float32)
    R, t = jlie.se3_exp(jnp.array([0.3, 0.02, 0.05, -0.02, 0.08, 0.01]))
    K = jnp.asarray(K_NP)
    p0 = jcam.pinhole_project(K, X)
    p1 = jcam.pinhole_project(K, jlie.se3_apply(R, t, X))
    p0 = p0 + noise * jax.random.normal(jax.random.PRNGKey(seed), p0.shape)
    p1 = p1 + noise * jax.random.normal(jax.random.PRNGKey(seed + 1), p1.shape)
    return p0, p1


def _cases():
    out = {}
    p0, p1 = _scene(False)
    out["general"] = (p0, p1, 7)
    p0, p1 = _scene(True)
    out["planar"] = (p0, p1, 8)
    p0, p1 = _scene(False, seed=3)
    p1 = p1.at[:40].set(jax.random.uniform(jax.random.PRNGKey(9), (40, 2), minval=0, maxval=600))
    out["outliers"] = (p0, p1, 10)
    rng = np.random.default_rng(4)
    # 200 points like the other scenes (150 in test_matching_twoview.py), so
    # that reconstruct compiles once
    X = jnp.asarray(np.stack([rng.uniform(-2, 2, 200), rng.uniform(-1.5, 1.5, 200),
                              rng.uniform(4, 9, 200)], axis=-1), jnp.float32)
    Rrot = jlie.so3_exp(jnp.array([0.0, 0.05, 0.01]))
    # with exact projections both models score every point at the maximum
    # and the H/F choice is a tie that f32 rounding breaks either way; the
    # pixel noise of the other scenes makes it a real choice
    p0 = jcam.pinhole_project(jnp.asarray(K_NP), X)
    p1 = jcam.pinhole_project(jnp.asarray(K_NP), (Rrot @ X.T).T)
    p0 = p0 + 0.4 * jax.random.normal(jax.random.PRNGKey(12), p0.shape)
    p1 = p1 + 0.4 * jax.random.normal(jax.random.PRNGKey(13), p1.shape)
    out["rotation"] = (p0, p1, 11)
    return out


@pytest.fixture(scope="module")
def twoview_results():
    """JAX and port results per scene; one jit of reconstruct per shape."""
    rec = jax.jit(lambda k, a, b, v: jtv.reconstruct(k, a, b, v, jnp.asarray(K_NP)))
    results = {}
    for name, (p0, p1, seed) in _cases().items():
        valid = jnp.ones(p0.shape[0], bool)
        key = jax.random.PRNGKey(seed)
        sets = jtv._sample_minimal_sets(jax.random.split(key)[0], valid)
        jres = {k: np.asarray(v) for k, v in rec(key, p0, p1, valid).items()}
        tres = ttv.reconstruct(T(p0), T(p1), torch.ones(p0.shape[0], dtype=torch.bool),
                               T(K_NP), sets=T(sets))
        results[name] = (jres, {k: v.numpy() for k, v in tres.items()})
    return results


@pytest.mark.parametrize("name", ["general", "planar", "outliers", "rotation"])
def test_reconstruct_matches_jax(twoview_results, name):
    j, t = twoview_results[name]
    assert bool(t["success"]) == bool(j["success"])
    assert bool(t["used_h"]) == bool(j["used_h"])
    assert bool(j["success"]) == (name != "rotation")
    if not j["success"]:
        return
    np.testing.assert_allclose(t["R"], j["R"], atol=1e-3)
    assert float(np.dot(t["t"], j["t"])) > 0.9999
    assert (t["good"] == j["good"]).mean() >= 0.99
    assert abs(int(t["n_good"]) - int(j["n_good"])) <= max(2, 0.01 * int(j["n_good"]))


def test_triangulate_matches_jax():
    rng = np.random.default_rng(5)
    P0 = np.concatenate([np.eye(3), np.zeros((3, 1))], 1).astype(np.float32)
    P1 = np.concatenate([np.eye(3), np.array([[-0.3], [0.0], [0.05]])], 1).astype(np.float32)
    X = np.stack([rng.uniform(-1, 1, 50), rng.uniform(-1, 1, 50), rng.uniform(3, 6, 50)], 1)
    p0 = (X[:, :2] / X[:, 2:]).astype(np.float32)
    X1 = X @ P1[:, :3].T + P1[:, 3]
    p1 = (X1[:, :2] / X1[:, 2:]).astype(np.float32)
    ref = _np(jtv.triangulate(*(jnp.asarray(a) for a in (P0, P1, p0, p1))))
    got = ttv.triangulate(T(P0), T(P1), T(p0), T(p1)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(got, X, rtol=1e-2)
