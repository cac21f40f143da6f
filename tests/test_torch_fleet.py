"""The fleet step and batched extraction of the port.

- pose_ba_plain at B = 8 equals 8 calls at B = 1 (the plain version of K2
  over the fleet's batch);
- the fleet step (K2 once over the B sessions) equals each session's own
  step (`fleet._track_one`) at tests/test_fleet.py's sizes (B 8, 128x192,
  L 256, OrbConfig(200, 2)): R and t within 1e-5, n equal (over four gloo
  ranks in tests/test_torch_parallel.py);
- orb.extract_batched equals orb.extract under
  tests/test_extract_batching.py's tolerances (positions 1e-4, validity
  and descriptors exact on valid rows, angles 1e-5), at that test's size;
- behind `slow` (eager JAX, ~30 s): `_track_one` agrees with the JAX
  `_track_one` for b in {0, 3, 6}, the JAX features fed to the port
  (`orb.extract` differs between the packages in a few keypoints,
  tests/test_torch_frontend.py); extract_batched's keypoints agree with the
  eager JAX extract_batched on tests/test_extract_batching.py's image; and
  extract_batched equals extract at full width.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

from orb_slam3_tpu_torch.frontend import camera as tcam
from orb_slam3_tpu_torch.frontend import orb as torb
from orb_slam3_tpu_torch.parallel import fleet as tfleet
from orb_slam3_tpu_torch.tracking import pose_kernel as tpk

from test_extract_batching import synth_image

torch.set_num_threads(2)
B, H, W, L = 8, 128, 192, 256
K_NP = np.asarray([120.0, 120.0, 96.0, 64.0, 0, 0, 0, 0], np.float32)


def fleet_inputs():
    """tests/test_fleet.py's batch: blob frames and random local maps."""
    rng = np.random.default_rng(0)
    imgs = np.zeros((B, H, W), np.float32)
    for b in range(B):
        xs = rng.integers(8, W - 8, 300)
        ys = rng.integers(8, H - 8, 300)
        for x, y in zip(xs, ys):
            imgs[b, y:y + 3, x:x + 3] = rng.uniform(50, 255)
    lm_pos = np.concatenate([rng.uniform(-1, 1, (B, L, 2)), rng.uniform(2, 5, (B, L, 1))],
                            axis=2).astype(np.float32)
    lm_desc = rng.integers(0, 256, (B, L, 32)).astype(np.uint8)
    return (imgs, lm_pos, lm_desc, np.ones((B, L), bool), np.full((B, L), 8.0, np.float32),
            np.full((B, L), 0.5, np.float32), np.zeros((B, L, 3), np.float32),
            np.tile(np.eye(3, dtype=np.float32), (B, 1, 1)), np.zeros((B, 3), np.float32))


def seeded_fleet_inputs():
    """The batch with each local map seeded from its frame's own keypoints
    (so that every session matches and its pose BA has inliers), from a
    perturbed start pose."""
    from orb_slam3_tpu_torch import entry

    args = list(fleet_inputs())
    cfg = torb.OrbConfig(200, 2)
    for b in range(B):
        f = torb.extract(torch.from_numpy(args[0][b]), cfg)
        sc = entry.make_scene(f.xy.numpy(), f.octave.numpy(), f.descriptors.numpy(),
                              f.valid.numpy(), K_NP, 2, L, seed=b)
        for i, k in enumerate(("lm_pos", "lm_desc", "lm_valid", "lm_max_dist", "lm_min_dist",
                               "lm_normal", "R0", "t0"), start=1):
            args[i][b] = sc[k]
    return tuple(args)


def test_pose_ba_plain_at_b8_equals_eight_calls():
    rng = np.random.default_rng(3)
    N = 300
    K = torch.tensor(np.tile(K_NP[:4], (8, 1)))
    Xw = torch.tensor(np.concatenate([rng.uniform(-1, 1, (8, N, 2)),
                                      rng.uniform(2, 5, (8, N, 1))], 2), dtype=torch.float32)
    R0 = torch.eye(3).repeat(8, 1, 1)
    t0 = torch.tensor(rng.normal(0, 0.02, (8, 3)), dtype=torch.float32)
    uv = (Xw[..., :2] / Xw[..., 2:] * K[:, None, :2] + K[:, None, 2:4]
          + torch.tensor(rng.normal(0, 0.5, (8, N, 2)), dtype=torch.float32))
    inv = torch.ones(8, N)
    valid = torch.tensor(rng.random((8, N)) > 0.1)
    R, t, inl, n = tpk.pose_ba_plain(K, R0, t0, uv, Xw, inv, valid)
    for b in range(8):
        Rb, tb, ib, nb = tpk.pose_ba_plain(K[b:b + 1], R0[b:b + 1], t0[b:b + 1], uv[b:b + 1],
                                           Xw[b:b + 1], inv[b:b + 1], valid[b:b + 1])
        torch.testing.assert_close(R[b], Rb[0], rtol=0, atol=1e-6)
        torch.testing.assert_close(t[b], tb[0], rtol=0, atol=1e-6)
        assert torch.equal(inl[b], ib[0]) and int(n[b]) == int(nb[0])


@pytest.fixture(scope="module")
def seeded():
    return seeded_fleet_inputs()


def _one(args, b, cfg):
    sf = cfg.scale_factors("cpu")
    K = torch.from_numpy(K_NP)
    return tfleet._track_one(*(torch.from_numpy(a[b]) for a in args), cfg_orb=cfg,
                             kind=tcam.PINHOLE, K=K, img_wh=(float(W), float(H)),
                             scale_factors=sf, match_radius=15.0)


@pytest.mark.parametrize("inputs", ["test_fleet", "seeded"])
def test_fleet_step_equals_each_session(inputs, seeded):
    args = fleet_inputs() if inputs == "test_fleet" else seeded
    cfg = torb.OrbConfig(200, 2)
    step = tfleet.make_fleet_step(cfg, K_NP, img_wh=(W, H), device="cpu")
    R, t, n = step(*args)
    assert R.shape == (B, 3, 3) and t.shape == (B, 3) and n.shape == (B,)
    for b in range(B):
        Rr, tr, nr = _one(args, b, cfg)
        assert int(nr) == int(n[b])
        torch.testing.assert_close(R[b], Rr, rtol=0, atol=1e-5)
        torch.testing.assert_close(t[b], tr, rtol=0, atol=1e-5)
    if inputs == "seeded":
        assert int(n.min()) >= 50


@pytest.mark.slow
def test_track_one_agrees_with_the_jax_package(seeded):
    """The JAX _track_one (eager) on sessions 0, 3, 6 of the seeded batch,
    with the JAX features fed to the port's step (orb.extract patched)."""
    from orb_slam3_tpu.frontend import camera as jcam
    from orb_slam3_tpu.frontend import orb as jorb
    from orb_slam3_tpu.parallel import fleet as jfleet
    from orb_slam3_tpu_torch import convert

    cfg_j = jorb.OrbConfig(n_features=200, n_levels=2)
    cfg_t = torb.OrbConfig(200, 2)
    Kj = jcam.make_pinhole(120.0, 120.0, 96.0, 64.0)
    sf = jnp.asarray([cfg_j.scale_factor ** i for i in range(cfg_j.n_levels)])
    orig = torb.extract
    try:
        for b in (0, 3, 6):
            a = [jnp.asarray(x[b]) for x in seeded]
            Rj, tj, nj = jfleet._track_one(*a, cfg_orb=cfg_j, kind=jcam.PINHOLE, K=Kj,
                                           img_wh=(float(W), float(H)), scale_factors=sf,
                                           match_radius=15.0)
            f = jorb.extract(a[0], cfg_j)
            feats = convert.features(f.xy, f.response, f.angle, f.octave, f.descriptors,
                                     f.valid, "cpu")
            torb.extract = lambda img, cfg: feats  # noqa: E731
            Rt, tt, nt = _one(seeded, b, cfg_t)
            torb.extract = orig
            assert int(nt) == int(nj) >= 50
            np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), rtol=0, atol=1e-5)
            np.testing.assert_allclose(tt.numpy(), np.asarray(tj), rtol=0, atol=1e-4)
    finally:
        torb.extract = orig


def _compare_levels(a, b, cfg):
    """tests/test_extract_batching.py's comparison, level by level over the
    rows both hold."""
    off_a = off_b = 0
    for lvl, n in enumerate(cfg.features_per_level()):
        na = int((a.octave == lvl).sum())
        sa, sb = slice(off_a, off_a + na), slice(off_b, off_b + na)
        v = a.valid[sa].numpy()
        np.testing.assert_array_equal(b.valid[sb].numpy(), v)
        np.testing.assert_allclose(b.xy[sb].numpy()[v], a.xy[sa].numpy()[v], atol=1e-4)
        np.testing.assert_array_equal(b.descriptors[sb].numpy()[v], a.descriptors[sa].numpy()[v])
        np.testing.assert_allclose(b.angle[sb].numpy()[v], a.angle[sa].numpy()[v], atol=1e-5)
        assert bool((b.octave[sb] == lvl).all())
        off_a, off_b = off_a + na, off_b + n
    assert off_b == b.xy.shape[0]


@pytest.mark.parametrize("size", ["test", pytest.param("full", marks=pytest.mark.slow)])
def test_extract_batched_equals_extract(size):
    if size == "test":
        cfg, img = torb.OrbConfig(400, 4), synth_image()
    else:
        cfg, img = torb.OrbConfig(1000, 8), synth_image(1, 480, 752, 2500)
    im = torch.from_numpy(img)
    _compare_levels(torb.extract(im, cfg), torb.extract_batched(im, cfg), cfg)


@pytest.mark.slow
def test_extract_batched_agrees_with_the_jax_one():
    """The eager JAX extract_batched on tests/test_extract_batching.py's
    image: the same valid keypoints (positions 1e-4, levels exact), their
    angles within 1e-4 and descriptors equal on >= 97% of them (the JAX
    function edge-pads under the blur where the port continues each level
    as the blur's own reflect-101 border; the rest follows from the
    packages' extraction differences, tests/test_torch_frontend.py)."""
    from orb_slam3_tpu.frontend import orb as jorb

    cfg_j = jorb.OrbConfig(n_features=400, n_levels=4)
    img = synth_image()
    want = jorb.extract_batched(jnp.asarray(img), cfg_j)
    got = torb.extract_batched(torch.from_numpy(img), torb.OrbConfig(400, 4))
    v = np.asarray(want.valid)
    np.testing.assert_array_equal(got.valid.numpy(), v)
    np.testing.assert_allclose(got.xy.numpy()[v], np.asarray(want.xy)[v], atol=1e-4)
    np.testing.assert_array_equal(got.octave.numpy(), np.asarray(want.octave))
    np.testing.assert_allclose(got.angle.numpy()[v], np.asarray(want.angle)[v], atol=1e-4)
    same = (got.descriptors.numpy()[v] == np.asarray(want.descriptors)[v]).all(-1)
    assert same.mean() >= 0.97, same.mean()
