"""The port's place recognition against the JAX package (place/vocab.py,
place/recognition.py), on the same numpy-seeded inputs:

- train: the same descriptors give the same tree (centers) and idf weights;
  transform_words equal, sparse_bow ids equal and values within 1e-6,
  bow_vector / l1_score / sparse_l1_score within 1e-6; load_orb_text reads
  the reference's text format into the same tables;
- KeyframeDB: query scores within 1e-6; reloc_candidates and loop_candidates
  (with and without covisibility groups) give the same indices, with
  planted score and integer covisibility-weight ties;
- pnp_ransac with the JAX package's minimal sets handed in: inlier masks
  equal, R within 1e-4, t within 1e-3; mlpnp_refine from the same start:
  inliers equal, R within 1e-5, t within 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam3_tpu.frontend import camera as jcam
from orb_slam3_tpu.ops import lie as jlie
from orb_slam3_tpu.place import recognition as jrec
from orb_slam3_tpu.place import vocab as jvocab
from orb_slam3_tpu_torch import convert
from orb_slam3_tpu_torch.place import recognition as trec
from orb_slam3_tpu_torch.place import vocab as tvocab

K_NP = np.asarray([350.0, 350.0, 256.0, 192.0, 0, 0, 0, 0], np.float32)


def T(a, dtype=None):
    return torch.from_numpy(np.array(a, dtype=dtype))


@pytest.fixture(scope="module")
def vocabs():
    """One descriptor sample through both trainers, and frames of noisy
    copies of its descriptors (view-like: each frame keeps a slice)."""
    rng = np.random.default_rng(0)
    base = rng.integers(0, 256, (1500, 32), dtype=np.uint8)
    jv = jvocab.train(base, branching=8, depth=3)
    tv = tvocab.train(base, branching=8, depth=3, device="cpu")

    def frame(lo, hi, flips=6, seed=0):
        r = np.random.default_rng(seed)
        d = base[lo:hi].copy()
        bits = r.integers(0, 256, (hi - lo, 32)) < flips
        d ^= (bits * r.integers(1, 256, (hi - lo, 32))).astype(np.uint8)
        valid = r.random(hi - lo) > 0.05
        return d, valid

    frames = [frame(100 * k, 100 * k + 300, seed=k) for k in range(8)]
    return jv, tv, frames


def test_train_gives_the_same_tree_and_weights(vocabs):
    jv, tv, _ = vocabs
    assert tv.n_words == jv.n_words == 512
    np.testing.assert_array_equal(tv.centers.numpy(), np.asarray(jv.centers))
    np.testing.assert_allclose(tv.weights.numpy(), np.asarray(jv.weights), rtol=0, atol=1e-6)
    conv = convert.vocabulary(jv, device="cpu")
    np.testing.assert_array_equal(conv.centers.numpy(), tv.centers.numpy())


def test_words_and_bow_vectors_match_jax(vocabs):
    jv, tv, frames = vocabs
    bows_j, bows_t = [], []
    for d, valid in frames[:4]:
        wj = np.asarray(jvocab.transform_words(jv, jnp.asarray(d), jnp.asarray(valid)))
        wt = tvocab.transform_words(tv, T(d), T(valid)).numpy()
        np.testing.assert_array_equal(wt, wj)
        bj = jvocab.sparse_bow(jv, jnp.asarray(d), jnp.asarray(valid))
        bt = tvocab.sparse_bow(tv, T(d), T(valid))
        np.testing.assert_array_equal(bt.ids.numpy(), np.asarray(bj.ids))
        np.testing.assert_allclose(bt.vals.numpy(), np.asarray(bj.vals), rtol=0, atol=1e-6)
        dj = jvocab.bow_vector(jv, jnp.asarray(d), jnp.asarray(valid))
        dt = tvocab.bow_vector(tv, T(d), T(valid))
        np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=0, atol=1e-6)
        bows_j.append((bj, dj))
        bows_t.append((bt, dt))
    for (bj, dj), (bt, dt) in zip(bows_j[1:], bows_t[1:]):
        np.testing.assert_allclose(float(tvocab.l1_score(bows_t[0][1], dt)),
                                   float(jvocab.l1_score(bows_j[0][1], dj)), atol=1e-6)
        np.testing.assert_allclose(float(tvocab.sparse_l1_score(bows_t[0][0], bt, tv.n_words)),
                                   float(jvocab.sparse_l1_score(bows_j[0][0], bj, jv.n_words)),
                                   atol=1e-6)


def test_load_orb_text_matches_jax(tmp_path):
    """An incomplete 3-ary tree of depth 2 in the reference's ORBvoc.txt
    format (one node with two children, one early leaf)."""
    rng = np.random.default_rng(11)
    d = rng.integers(0, 256, (16, 32)).astype(np.uint8)
    lines = ["3 2 0 0"]
    nodes = [(0, 0), (0, 0), (0, 1)]            # level 1: ids 1, 2, 3 (3 a leaf)
    nodes += [(1, 1)] * 3 + [(2, 1)] * 2        # level 2: 1 has 3 children, 2 has 2
    for i, (pid, leaf) in enumerate(nodes):
        lines.append(f"{pid} {leaf} " + " ".join(str(int(x)) for x in d[i])
                     + f" {0.5 + 0.1 * i:.3f}")
    path = tmp_path / "voc.txt"
    path.write_text("\n".join(lines) + "\n")
    jv = jvocab.load_orb_text(str(path))
    tv = tvocab.load_orb_text(str(path), device="cpu")
    assert (tv.branching, tv.depth) == (jv.branching, jv.depth) == (3, 2)
    np.testing.assert_array_equal(tv.centers.numpy(), np.asarray(jv.centers))
    np.testing.assert_array_equal(tv.weights.numpy(), np.asarray(jv.weights))
    q = rng.integers(0, 256, (40, 32)).astype(np.uint8)
    np.testing.assert_array_equal(
        tvocab.transform_words(tv, T(q), torch.ones(40, dtype=torch.bool)).numpy(),
        np.asarray(jvocab.transform_words(jv, jnp.asarray(q), jnp.ones(40, bool))))


def _dbs(jv, tv, frames, kmax=16, rows=(0, 1, 2, 3, 5, 6, 7), slots=256):
    jdb = jrec.KeyframeDB.empty(kmax, jv.n_words, slots=slots)
    tdb = trec.KeyframeDB.empty(kmax, tv.n_words, slots=slots)
    for r in rows:
        d, valid = frames[r]
        jdb = jdb.add(r, jvocab.sparse_bow(jv, jnp.asarray(d), jnp.asarray(valid)))
        tdb = tdb.add(r, tvocab.sparse_bow(tv, T(d), T(valid)))
    return jdb, tdb


def test_keyframe_db_scores_and_candidates_match_jax(vocabs):
    jv, tv, frames = vocabs
    jdb, tdb = _dbs(jv, tv, frames)
    conv = convert.keyframe_db(jdb, device="cpu")
    np.testing.assert_array_equal(conv.ids.numpy(), tdb.ids.numpy())
    np.testing.assert_allclose(conv.vals.numpy(), tdb.vals.numpy(), atol=1e-6)
    d, valid = frames[4]                      # a query between stored rows 3 and 5
    jq = jvocab.sparse_bow(jv, jnp.asarray(d), jnp.asarray(valid))
    tq = tvocab.sparse_bow(tv, T(d), T(valid))
    np.testing.assert_allclose(trec.query(tdb, tq).numpy(), np.asarray(jrec.query(jdb, jq)),
                               atol=1e-6)
    for got, want in zip(trec.reloc_candidates(tdb, tq), jrec.reloc_candidates(jdb, jq)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)

    # covisibility groups with integer ties (weights 0, 5, 5, 5, ...)
    K = 16
    W = np.zeros((K, K), np.int32)
    for i in range(8):
        for j in range(8):
            if i != j and abs(i - j) <= 3:
                W[i, j] = 5 if abs(i - j) > 1 else 20
    covis = np.zeros(K, bool)
    covis[[3, 5]] = True
    for covis_W in (None, W):
        got = trec.loop_candidates(tdb, tq, 4, T(covis), 0.0,
                                   covis_W=None if covis_W is None else T(covis_W))
        want = jrec.loop_candidates(jdb, jq, 4, jnp.asarray(covis), 0.0,
                                    covis_W=None if covis_W is None else jnp.asarray(covis_W))
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=1e-6)
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


def test_candidate_ties_keep_the_lower_row():
    """Two stored rows with the same BoW give equal scores: both packages
    rank the lower row first (lax.top_k's order)."""
    ids = np.array([3, 7, 9, 16], np.int32)
    vals = np.array([0.25, 0.25, 0.5, 0.0], np.float32)
    jdb = jrec.KeyframeDB.empty(8, 16, slots=4)
    tdb = trec.KeyframeDB.empty(8, 16, slots=4)
    for r in (6, 2, 4):
        jdb = jdb.add(r, jvocab.SparseBow(jnp.asarray(ids), jnp.asarray(vals)))
        tdb = tdb.add(r, tvocab.SparseBow(T(ids), T(vals)))
    qj = jvocab.SparseBow(jnp.asarray(ids), jnp.asarray(vals))
    qt = tvocab.SparseBow(T(ids), T(vals))
    want = np.asarray(jrec.reloc_candidates(jdb, qj)[0])
    assert list(want) == [2, 4, 6]
    np.testing.assert_array_equal(trec.reloc_candidates(tdb, qt)[0].numpy(), want)


def _pnp_problem(seed=0, n=160, n_out=40):
    key = jax.random.PRNGKey(seed)
    X = jnp.concatenate([jax.random.uniform(key, (n, 2), minval=-3, maxval=3),
                         jax.random.uniform(jax.random.PRNGKey(seed + 1), (n, 1), minval=4,
                                            maxval=9)], axis=-1)
    R_gt, t_gt = jlie.se3_exp(jnp.array([0.2, -0.1, 0.15, 0.05, -0.1, 0.02]))
    K = jnp.asarray(K_NP)
    uv = jcam.pinhole_project(K, jlie.se3_apply(R_gt, t_gt, X))
    uv = uv + 0.5 * jax.random.normal(jax.random.PRNGKey(seed + 2), uv.shape)
    uv = uv.at[:n_out].set(jax.random.uniform(jax.random.PRNGKey(seed + 3), (n_out, 2),
                                              minval=0, maxval=500))
    valid = np.ones(n, bool)
    valid[-10:] = False
    return K, uv, X, jnp.asarray(valid), (R_gt, t_gt)


def test_pnp_ransac_finds_the_pose_through_the_outliers():
    """The port alone (the JAX parity below is slow: its compile): 160
    correspondences, 40 wrong, 10 invalid; the sets drawn from a CPU
    generator."""
    K, uv, X, valid, (R_gt, t_gt) = _pnp_problem()
    R, t, inl, n = trec.pnp_ransac(jcam.PINHOLE, T(K), T(uv), T(X), T(valid),
                                   generator=torch.Generator().manual_seed(4))
    assert int(n) > 90 and not bool(inl[-10:].any())
    np.testing.assert_allclose(R.numpy(), np.asarray(R_gt), atol=0.02)
    np.testing.assert_allclose(t.numpy(), np.asarray(t_gt), atol=0.1)


@pytest.mark.slow
def test_pnp_ransac_matches_jax_with_its_sets():
    K, uv, X, valid, (R_gt, t_gt) = _pnp_problem()
    key = jax.random.PRNGKey(4)
    Rj, tj, inlj, nj = jax.jit(jrec.pnp_ransac, static_argnums=(1,))(key, jcam.PINHOLE, K,
                                                                      uv, X, valid)
    g = jnp.where(valid[None, :], jax.random.uniform(key, (128, uv.shape[0])), -1.0)
    sets = np.asarray(jax.lax.top_k(g, 6)[1])
    Rt, tt, inlt, nt = trec.pnp_ransac(jcam.PINHOLE, T(K), T(uv), T(X), T(valid),
                                       sets=T(sets))
    assert int(nj) > 90
    np.testing.assert_array_equal(inlt.numpy(), np.asarray(inlj))
    assert int(nt) == int(nj)
    np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), atol=1e-4)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=1e-3)
    # the generator path draws its own sets and finds the same pose
    Rg, tg, _, ng = trec.pnp_ransac(jcam.PINHOLE, T(K), T(uv), T(X), T(valid),
                                    generator=torch.Generator().manual_seed(4))
    assert int(ng) > 90
    np.testing.assert_allclose(Rg.numpy(), np.asarray(R_gt), atol=0.02)


def test_mlpnp_refine_matches_jax():
    K, uv, X, valid, (R_gt, t_gt) = _pnp_problem(seed=7)
    dR, dt = jlie.se3_exp(jnp.array([0.02, -0.01, 0.03, 0.01, -0.008, 0.005]))
    R0, t0 = jlie.se3_mul(dR, dt, R_gt, t_gt)
    inv_s2 = jnp.asarray(1.0 / 1.2 ** (2 * (np.arange(uv.shape[0]) % 3)), jnp.float32)
    Rj, tj, inlj, nj = jrec.mlpnp_refine(jcam.PINHOLE, K, R0, t0, uv, X, inv_s2, valid)
    Rt, tt, inlt, nt = trec.mlpnp_refine(jcam.PINHOLE, T(K), T(R0), T(t0), T(uv), T(X),
                                         T(inv_s2), T(valid))
    np.testing.assert_array_equal(inlt.numpy(), np.asarray(inlj))
    np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), atol=1e-5)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=1e-4)
    assert int(nt) == int(nj) > 90
