"""The port's Atlas (atlas/{state,ops,invariants}) against the JAX package
on a toy map like test_compaction.py's.

Every op gives the same map as JAX's, field by field: exactly for
integers, flags, descriptors and copied floats, within 1e-6 where floats
are computed (the gauge transform) and within 1e-5 for the landmark
statistics. Also covered: the overflow refusal of add_landmarks near lmax,
compact's permutation, grow, the invariant checks on a healthy and a
corrupted map, and local_map_mask with a tie at the 80-keyframe cutoff.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam3_tpu.atlas import invariants as jinv
from orb_slam3_tpu.atlas import ops as jops
from orb_slam3_tpu.atlas import state as jstate
from orb_slam3_tpu.tracking import track as jtrack
from orb_slam3_tpu_torch import convert
from orb_slam3_tpu_torch.atlas import invariants as tinv
from orb_slam3_tpu_torch.atlas import ops as tops
from orb_slam3_tpu_torch.atlas import state as tstate
from orb_slam3_tpu_torch.tracking import track as ttrack

torch.set_num_threads(1)
KMAX, FMAX, LMAX = 8, 16, 64


def T(a):
    return torch.from_numpy(np.array(a))


def assert_same_map(t, j, atol=0.0):
    for f in dataclasses.fields(tstate.MapState):
        a = getattr(t, f.name).numpy()
        b = np.asarray(getattr(j, f.name))
        assert a.shape == b.shape, f.name
        if a.dtype.kind == "f" and atol:
            np.testing.assert_allclose(a, b, atol=atol, rtol=0, err_msg=f.name)
        else:
            np.testing.assert_array_equal(a, b, err_msg=f.name)


def toy_maps(n_kf=6, n_lm=16):
    """(port map, JAX map, lm rows): the same keyframes and landmarks added
    on both sides."""
    rng = np.random.default_rng(0)
    t = tstate.empty(kmax=KMAX, fmax=FMAX, lmax=LMAX, device="cpu")
    j = jstate.empty(kmax=KMAX, fmax=FMAX, lmax=LMAX)
    prev = None
    for k in range(n_kf):
        xy = rng.uniform(0, 300, (FMAX, 2)).astype(np.float32)
        octv = rng.integers(0, 4, FMAX).astype(np.int32)
        desc = rng.integers(0, 255, (FMAX, 32)).astype(np.uint8)
        R = np.eye(3, dtype=np.float32)
        tt = np.asarray([0.1 * k, 0, 0], np.float32)
        kw = {} if prev is None else dict(parent=prev, prev=prev)
        j, jr = jops.add_keyframe(j, jnp.asarray(R), jnp.asarray(tt), float(k), jnp.asarray(xy),
                                  jnp.asarray(octv), jnp.zeros((FMAX,)), jnp.asarray(desc),
                                  jnp.ones((FMAX,), bool), **kw)
        t, tr = tops.add_keyframe(t, T(R), T(tt), float(k), T(xy), T(octv),
                                  torch.zeros(FMAX), T(desc), torch.ones(FMAX, dtype=torch.bool),
                                  **kw)
        assert int(jr) == int(tr) == k
        prev = k
    pos = rng.uniform(-1, 1, (n_lm, 3)).astype(np.float32) + np.float32([0, 0, 3])
    desc = rng.integers(0, 255, (n_lm, 32)).astype(np.uint8)
    args = (pos, desc, np.zeros(n_lm, np.int32), np.ones(n_lm, bool),
            np.zeros(n_lm, np.int32), np.arange(n_lm, dtype=np.int32))
    j, jrows = jops.add_landmarks(j, *(jnp.asarray(a) for a in args))
    t, trows = tops.add_landmarks(t, *(T(a) for a in args))
    np.testing.assert_array_equal(trows.numpy(), np.asarray(jrows))
    # kf 1..3 observe landmarks through their features
    for k in (1, 2, 3):
        feat = rng.permutation(FMAX)[:n_lm].astype(np.int32)
        ok = rng.uniform(size=n_lm) > 0.2
        j = jops.add_observations(j, k, jnp.asarray(feat), jrows, jnp.asarray(ok))
        t = tops.add_observations(t, k, T(feat), trows, T(ok))
    return t, j, np.asarray(jrows)


@pytest.fixture(scope="module")
def maps():
    return toy_maps()


def test_insertions_match_jax(maps):
    t, j, rows = maps
    assert_same_map(t, j)
    assert not tinv.check_all(t) and not jinv.check_all(j)


def test_overflow_refusal_near_lmax(maps):
    t, j, _ = maps
    rng = np.random.default_rng(1)
    m = 60  # 16 rows used: 48 fit, the valid ones past the end are refused
    valid = rng.uniform(size=m) > 0.1
    args = (rng.uniform(-1, 1, (m, 3)).astype(np.float32),
            rng.integers(0, 255, (m, 32)).astype(np.uint8), np.full(m, 4, np.int32), valid,
            np.full(m, 4, np.int32), rng.integers(0, FMAX, m).astype(np.int32))
    j2, jrows = jops.add_landmarks(j, *(jnp.asarray(a) for a in args))
    t2, trows = tops.add_landmarks(t, *(T(a) for a in args))
    np.testing.assert_array_equal(trows.numpy(), np.asarray(jrows))
    assert (trows.numpy() == -1).sum() > valid.sum() - 48 - 1
    assert int(t2.n_lm) == LMAX
    assert_same_map(t2, j2)


def test_edits_match_jax(maps):
    t, j, rows = maps
    kill = np.zeros(16, bool)
    kill[[2, 5, 9]] = True
    j1 = jax.jit(jops.invalidate_landmarks)(j, jnp.asarray(rows), jnp.asarray(kill))
    t1 = tops.invalidate_landmarks(t, T(rows), T(kill))
    assert_same_map(t1, j1)

    vis = dataclasses.replace(j1, lm_visible=j1.lm_visible + 3, lm_found=j1.lm_found + 1)
    tvis = dataclasses.replace(t1, lm_visible=t1.lm_visible + 3, lm_found=t1.lm_found + 1)
    old, new, do = np.int32([0, 1, 7]), np.int32([4, 4, 8]), np.array([True, True, False])
    j2 = jax.jit(jops.replace_landmark)(vis, jnp.asarray(old), jnp.asarray(new), jnp.asarray(do))
    t2 = tops.replace_landmark(tvis, T(old), T(new), T(do))
    assert_same_map(t2, j2)

    Ryw = np.asarray([[0.8, -0.6, 0], [0.6, 0.8, 0], [0, 0, 1]], np.float32)
    j3 = jax.jit(jops.apply_scaled_rotation)(j2, jnp.asarray(Ryw), 1.7, 0)
    t3 = tops.apply_scaled_rotation(t2, T(Ryw), 1.7, 0)
    assert_same_map(t3, j3, atol=1e-6)

    j4 = jax.jit(lambda m: jops.change_map_id(jops.create_map(m), 0, 5))(j3)
    t4 = tops.change_map_id(tops.create_map(t3), 0, 5)
    assert_same_map(t4, j4, atol=1e-6)
    j5, t5 = jax.jit(jops.reset_active_map)(j4), tops.reset_active_map(t4)
    assert_same_map(t5, j5, atol=1e-6)
    # ops never write into their input
    assert_same_map(t, j)


def test_compact_and_grow_match_jax(maps):
    t, j, rows = maps
    j = dataclasses.replace(j, kf_valid=j.kf_valid.at[2].set(False),
                            kf_parent=j.kf_parent.at[3].set(1), kf_prev=j.kf_prev.at[3].set(1))
    t = dataclasses.replace(t, kf_valid=t.kf_valid.clone(), kf_parent=t.kf_parent.clone(),
                            kf_prev=t.kf_prev.clone())
    t.kf_valid[2], t.kf_parent[3], t.kf_prev[3] = False, 1, 1
    kill = jnp.ones(5, bool)
    j = jax.jit(jops.invalidate_landmarks)(j, jnp.asarray(rows[5:10]), kill)
    t = tops.invalidate_landmarks(t, T(rows[5:10]), T(kill))
    j2, jk, jl = jax.jit(jops.compact)(j)
    t2, tk, tl = tops.compact(t)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    assert_same_map(t2, j2)
    assert not tinv.check_all(t2)
    assert_same_map(tops.grow(t2, kmax=12, lmax=80), jax.jit(jops.grow, static_argnames=("kmax", "lmax"))(j2, kmax=12, lmax=80))


def test_update_landmark_stats_matches_jax(maps):
    t, j, _ = maps
    got = tstate.update_landmark_stats(t)
    ref = jax.jit(jstate.update_landmark_stats)(j)
    for name in ("lm_normal", "lm_max_dist", "lm_min_dist"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(ref, name)),
                                   atol=1e-5, rtol=1e-5)
    assert float(got.lm_max_dist.max()) > 0


def test_graph_queries_match_jax(maps):
    t, j, rows = maps
    W_t, W_j = tstate.covisibility_weights(t), jax.jit(jstate.covisibility_weights)(j)
    np.testing.assert_array_equal(W_t.numpy(), np.asarray(W_j))
    assert W_t.max() > 0
    np.testing.assert_array_equal(tstate.essential_edges(t, W_t, min_weight=5).numpy(),
                                  np.asarray(jax.jit(jstate.essential_edges, static_argnames="min_weight")(
                                      j, W_j, min_weight=5)))
    dist = np.linspace(0.5, 4.0, LMAX).astype(np.float32)
    jst = jax.jit(jstate.update_landmark_stats)(j)
    tst = convert.map_state(jst, device="cpu")
    np.testing.assert_array_equal(tstate.predict_octave(tst, T(dist)).numpy(),
                                  np.asarray(jax.jit(jstate.predict_octave)(jst, jnp.asarray(dist))))
    req = np.asarray(rows[[0, 3, 8, 15, 1]], np.int32)
    np.testing.assert_array_equal(
        tstate.compute_distinctive_descriptors(t, T(req)).lm_desc.numpy(),
        np.asarray(jax.jit(jstate.compute_distinctive_descriptors)(j, jnp.asarray(req)).lm_desc))


def test_invariants_same_reports(maps):
    t, j, rows = maps
    # corrupt: a dead landmark still observed, a parent pointing at a culled
    # keyframe, a temporal link forward in time, an orphan landmark
    j = dataclasses.replace(
        j, lm_valid=j.lm_valid.at[rows[3]].set(False).at[40].set(True),
        kf_valid=j.kf_valid.at[1].set(False), kf_prev=j.kf_prev.at[4].set(5))
    t = convert.map_state(j, device="cpu")
    ref = jinv.check_all(j)
    assert len(ref) >= 4
    assert tinv.check_all(t) == ref


def test_map_state_round_trip(maps):
    t, j, _ = maps
    back = jstate.MapState(**{k: jnp.asarray(v) for k, v in convert.map_state_arrays(t).items()})
    assert_same_map(convert.map_state(back, device="cpu"), j)


def _local_map_case():
    """100 keyframes; the reference row's covisibility weights tie at the
    80-keyframe cutoff (rows 60..99 all weigh 5)."""
    rng = np.random.default_rng(3)
    K, F, L = 100, 12, 600
    kf_feat_lm = rng.integers(-1, L, (K, F)).astype(np.int32)
    kf_feat_valid = rng.uniform(size=(K, F)) > 0.1
    kf_valid = np.ones(K, bool)
    kf_valid[7] = False
    lm_valid = rng.uniform(size=L) > 0.05
    lm_map_id = np.where(rng.uniform(size=L) > 0.1, 0, 1).astype(np.int32)
    W = np.concatenate([rng.integers(6, 50, 60), np.full(40, 5)]).astype(np.int32)
    W[3] = 0
    return (kf_feat_lm, kf_feat_valid, kf_valid, lm_valid, lm_map_id, np.int32(0), W, np.int32(10))


def test_local_map_mask_tie_at_cutoff():
    args = _local_map_case()
    ref = np.asarray(jtrack.local_map_mask(*(jnp.asarray(a) for a in args)))
    got = ttrack.local_map_mask(*(T(a) for a in args[:5]), 0, T(args[6]), 10).numpy()
    np.testing.assert_array_equal(got, ref)
    # 57 rows weigh more than 5 (rows 3, 7 and 10 are zeroed), so the tie
    # fills 23 places in row order: rows 60..82 are in, 83..99 are out
    only_late = np.zeros(100, bool)
    only_late[83:] = True
    lm_late = set(args[0][only_late].ravel()) - set(args[0][~only_late].ravel())
    assert lm_late and not any(got[l] for l in lm_late if l >= 0)
