"""The port's stereo matcher and RGB-D depth binding against the JAX package
(frontend/stereo.py), on the same numpy inputs.

- match_stereo on a PlaneScene stereo pair at 256x192 (baseline 0.12), with
  left keypoints drawn on the scene and right keypoints at their true
  disparity (sub-pixel noise, near-duplicate descriptors) among
  distractors: the descriptor stage's index, distance and ok exact; after
  the SAD parabola and the median rule, ok exact, ur within 1e-3 px and
  depth within 1e-4 relative where both accept.
- Planted cases, exact everywhere: an even count of accepted matches whose
  two middle distances differ (jnp.nanmedian averages them; torch.nanmedian
  would return the lower one and reject the worst match), and right
  keypoints on both sides of the disparity range's edges.
- depth_from_rgbd on the scene's depth map, keypoints on holes, on depth
  steps and outside the image, two depth factors: every output exact.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

from orb_slam3_tpu.frontend import matching as jm
from orb_slam3_tpu.frontend import stereo as js
from orb_slam3_tpu_torch.frontend import stereo as ts
from synthetic_scene import PlaneScene, orbit_trajectory

torch.set_num_threads(1)
WH = (256, 192)
K_NP = np.asarray([200.0, 200.0, 128.0, 96.0, 0, 0, 0, 0], np.float32)
SF = np.asarray([1.2 ** i for i in range(4)], np.float32)
BASELINE = 0.12
BF = 200.0 * BASELINE
PLANTED = 8


def _flip(desc, n_bits, rng):
    """desc with exactly n_bits of its 256 bits flipped."""
    out = desc.copy()
    bits = np.unpackbits(out)
    bits[rng.choice(256, n_bits, replace=False)] ^= 1
    return np.packbits(bits)


@pytest.fixture(scope="module")
def scene_pair():
    """A rectified pair of the PlaneScene and its left depth map, with 300
    left keypoints and 340 right ones (their true partners, shuffled among
    distractors)."""
    scene = PlaneScene(K_NP, img_wh=WH, two_planes=True, seed=2)
    R, t = orbit_trajectory(3)
    left, right = scene.render_stereo(R[2], t[2], BASELINE)
    _, depth = scene.render_with_depth(R[2], t[2])
    rng = np.random.default_rng(5)
    n = 300
    u = rng.uniform(30, WH[0] - 10, n)
    v = rng.uniform(8, WH[1] - 8, n)
    z = depth[v.astype(int), u.astype(int)]
    oct_l = rng.integers(0, 4, n)
    desc_l = rng.integers(0, 256, (n, 32)).astype(np.uint8)
    partner = np.flatnonzero((rng.random(n) < 0.85) & (z > 0))
    ur = u[partner] - BF / z[partner] + rng.normal(0, 0.3, partner.size)
    vr = v[partner] + rng.normal(0, 0.6, partner.size)
    oct_r = np.clip(oct_l[partner] + rng.integers(-1, 2, partner.size), 0, 3)
    desc_r = np.stack([_flip(desc_l[i], int(rng.integers(0, 60)), rng) for i in partner])
    m = 340 - partner.size
    ur = np.concatenate([ur, rng.uniform(0, WH[0], m)])
    vr = np.concatenate([vr, rng.uniform(0, WH[1], m)])
    oct_r = np.concatenate([oct_r, rng.integers(0, 4, m)])
    desc_r = np.concatenate([desc_r, rng.integers(0, 256, (m, 32)).astype(np.uint8)])
    perm = rng.permutation(340)
    f32 = np.float32
    return dict(
        xy_l=np.stack([u, v], 1).astype(f32), oct_l=oct_l.astype(np.int32), desc_l=desc_l,
        valid_l=rng.random(n) < 0.97,
        xy_r=np.stack([ur, vr], 1)[perm].astype(f32), oct_r=oct_r[perm].astype(np.int32),
        desc_r=desc_r[perm], valid_r=rng.random(340) < 0.97,
        img_l=left.astype(f32), img_r=right.astype(f32), depth=depth.astype(f32))


ORDER = ("xy_l", "oct_l", "desc_l", "valid_l", "xy_r", "oct_r", "desc_r", "valid_r")


def _jax_rows(c, bf, min_z, max_desc_dist=75.0):
    """The descriptor stage of the JAX match_stereo (stereo.py:44-58)."""
    xy_l, oct_l, desc_l, valid_l, xy_r, oct_r, desc_r, valid_r = (jnp.asarray(c[k])
                                                                    for k in ORDER)
    sf = jnp.asarray(SF)
    sf_l = sf[jnp.clip(oct_l, 0, 3)]
    m = jnp.abs(xy_l[:, None, 1] - xy_r[None, :, 1]) <= (2.0 * sf_l)[:, None]
    m = m & (jnp.abs(oct_l[:, None] - oct_r[None, :]) <= 1)
    disp = xy_l[:, None, 0] - xy_r[None, :, 0]
    max_d = jnp.float32(bf) / jnp.maximum(jnp.float32(min_z), 1e-6)
    m = m & (disp > 0.1) & (disp <= max_d) & valid_l[:, None] & valid_r[None, :]
    return jm.masked_best_match(jm.hamming_matrix(desc_l, desc_r), m, max_dist=max_desc_dist)


def _both(c, bf, min_z):
    j = js.match_stereo(*(jnp.asarray(c[k]) for k in ORDER), jnp.asarray(c["img_l"]),
                        jnp.asarray(c["img_r"]), jnp.asarray(SF), bf, min_z)
    t = ts.match_stereo(*(torch.from_numpy(np.asarray(c[k])) for k in ORDER),
                        torch.from_numpy(c["img_l"]), torch.from_numpy(c["img_r"]),
                        torch.from_numpy(SF), bf, min_z)
    return [np.asarray(a) for a in j], [a.numpy() for a in t]


def _rows_equal(c, bf, min_z):
    j = [np.asarray(a) for a in _jax_rows(c, bf, min_z)]
    t = ts.match_rows(*(torch.from_numpy(np.asarray(c[k])) for k in ORDER),
                      torch.from_numpy(SF), bf, min_z)
    np.testing.assert_array_equal(t[2].numpy(), j[2])
    np.testing.assert_array_equal(t[0].numpy()[j[2]], j[0][j[2]])
    np.testing.assert_array_equal(t[1].numpy(), j[1])
    return j


def test_match_stereo_matches_jax_on_a_scene_pair(scene_pair):
    j_rows = _rows_equal(scene_pair, BF, 0.1)
    assert j_rows[2].sum() >= 150, j_rows[2].sum()
    (ur_j, d_j, ok_j), (ur_t, d_t, ok_t) = _both(scene_pair, BF, 0.1)
    np.testing.assert_array_equal(ok_t, ok_j)
    assert 100 <= ok_j.sum() < j_rows[2].sum(), (ok_j.sum(), j_rows[2].sum())
    np.testing.assert_allclose(ur_t[ok_j], ur_j[ok_j], atol=1e-3)
    np.testing.assert_allclose(d_t[ok_j], d_j[ok_j], rtol=1e-4)
    np.testing.assert_array_equal(ur_t[~ok_j], -1.0)
    np.testing.assert_array_equal(d_t[~ok_j], 0.0)


def _planted(dists, rows, ul, ur, rng, shift=10):
    """Left keypoints at (ul, rows) of octave 0, each with one right partner at
    (ur, rows) whose descriptor is dists[i] bits away; a smooth random
    texture as the left image and the same shifted by `shift` px as the
    right one."""
    n = len(dists)
    desc_l = rng.integers(0, 256, (PLANTED, 32)).astype(np.uint8)
    desc_r = np.stack([_flip(desc_l[i], dists[i], rng) for i in range(n)]
                      + [desc_l[i] for i in range(n, PLANTED)])
    tex = rng.uniform(0, 255, (WH[1] // 4 + 1, WH[0] // 4 + 8)).astype(np.float32)
    img = np.kron(tex, np.ones((4, 4), np.float32))[:WH[1], :WH[0] + 20]
    # padded to PLANTED rows with invalid keypoints: one JAX compile for all cases
    pad = lambda a: np.concatenate([a, np.zeros((PLANTED - n,) + a.shape[1:], a.dtype)])  # noqa: E731
    valid = np.arange(PLANTED) < n
    f32 = np.float32
    return dict(
        xy_l=pad(np.stack([ul, rows], 1).astype(f32)), oct_l=np.zeros(PLANTED, np.int32),
        desc_l=desc_l, valid_l=valid, xy_r=pad(np.stack([ur, rows], 1).astype(f32)),
        oct_r=np.zeros(PLANTED, np.int32), desc_r=desc_r, valid_r=valid,
        img_l=np.ascontiguousarray(img[:, :WH[0]]),
        img_r=np.ascontiguousarray(img[:, shift:shift + WH[0]]))


def test_even_count_median_is_the_mean_of_the_middle_pair():
    """Accepted distances 10, 10, 20, 30: the JAX median is 15 and its
    threshold 31.5 keeps all four; the lower middle value (10) would give
    21 and reject the 30."""
    rng = np.random.default_rng(9)
    ul = np.array([60.0, 110.0, 160.0, 210.0])
    c = _planted([10, 10, 20, 30], rows=np.array([30.0, 70.0, 110.0, 150.0]), ul=ul,
                 ur=ul - 10.0, rng=rng)
    _rows_equal(c, BF, 0.1)
    (ur_j, d_j, ok_j), (ur_t, d_t, ok_t) = _both(c, BF, 0.1)
    assert ok_j.tolist() == ok_t.tolist() == [True] * 4 + [False] * 4
    np.testing.assert_allclose(ur_t, ur_j, atol=1e-3)
    np.testing.assert_allclose(d_t, d_j, rtol=1e-4)
    # an odd count (one match more at 10): median 10, the 30 goes on both sides
    ul5 = np.append(ul, 240.0)
    c5 = _planted([10, 10, 20, 30, 10], rows=np.array([30.0, 70.0, 110.0, 150.0, 180.0]),
                  ul=ul5, ur=ul5 - 10.0, rng=rng)
    (_, _, ok_j5), (_, _, ok_t5) = _both(c5, BF, 0.1)
    assert ok_j5.tolist() == ok_t5.tolist() == [True, True, True, False, True] + [False] * 3


def test_disparity_range_edges_are_exact():
    """bf 20, min_z 0.5: the range is (0.1, 40]. Each left keypoint has one
    right keypoint on its row at a disparity on or next to an edge."""
    rng = np.random.default_rng(10)
    disp = np.array([40.0, 40.0 + 2 ** -8, 39.99, 0.125, 0.1 - 2 ** -9, 0.10000001, 20.0])
    n = disp.size
    ul = np.linspace(60.0, 230.0, n).astype(np.float32).astype(np.float64)
    rows = np.linspace(20.0, 170.0, n)
    c = _planted([5] * n, rows=rows, ul=ul, ur=ul - disp, rng=rng, shift=0)
    j = _rows_equal(c, 20.0, 0.5)
    got = (c["xy_l"][:, 0] - c["xy_r"][:, 0])
    expect = (got > np.float32(0.1)) & (got <= np.float32(40.0)) & c["valid_l"]
    np.testing.assert_array_equal(j[2], expect)
    # both sides of both edges occur (the others depend on f32 rounding of ur)
    assert expect[[0, 1, 3, 4]].tolist() == [True, False, True, False]
    (ur_j, d_j, ok_j), (ur_t, d_t, ok_t) = _both(c, 20.0, 0.5)
    np.testing.assert_array_equal(ok_t, ok_j)
    np.testing.assert_allclose(ur_t[ok_j], ur_j[ok_j], atol=1e-3)


@pytest.mark.parametrize("depth_factor", [1.0, 0.5])
def test_depth_from_rgbd_matches_jax(scene_pair, depth_factor):
    rng = np.random.default_rng(11)
    depth = scene_pair["depth"].copy()
    depth[40:60, 40:80] = 0.0  # a hole
    h, w = depth.shape
    edge = np.arange(38.0, 82.0, 2.0)  # along the hole's rim, inside and out
    xy = np.concatenate([
        np.stack([rng.uniform(-1.5, w + 1.5, 400), rng.uniform(-1.5, h + 1.5, 400)], 1),
        np.stack([edge, np.full_like(edge, 39.3)], 1),
        np.stack([edge, np.full_like(edge, 60.6)], 1),
        [[39.5, 50.0], [80.2, 59.9], [0.0, 0.0], [w - 0.5, h - 0.5], [-0.7, 10.0]],
    ]).astype(np.float32)
    j = [np.asarray(a) for a in js.depth_from_rgbd(jnp.asarray(xy), jnp.asarray(depth), BF,
                                                   depth_factor)]
    t = [a.numpy() for a in ts.depth_from_rgbd(torch.from_numpy(xy), torch.from_numpy(depth),
                                               BF, depth_factor)]
    for a, b, name in zip(t, j, ("ur", "depth", "ok")):
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert 100 < j[2].sum() < len(xy) - 40, j[2].sum()
