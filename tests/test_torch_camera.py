"""The port's camera models, keypoint undistortion, subpixel refinement and
ToBody edges against the JAX package, on the same numpy inputs.

- kb8_project within 1e-3 px, kb8_unproject within 1e-5 on the unit ray,
  the round trip of test_native_misc.py; jacfwd of project (vmapped, one
  point on the optical axis) within 1e-3 relative of jax.jacfwd, float32.
- undistort_points_radtan within 1e-3 px; the Tracker's undistorted
  keypoints on test_rectify.py's frame within 1e-2 px of the JAX
  undistortion of the same raw keypoints.
- refine_corners_flat within 1e-4 on the same patches, and OrbConfig(
  subpixel=True) extraction moving each keypoint by at most 1 px of its
  level.
- make_tobody_residual / make_tobody_pose_only_residual within 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import jacfwd, vmap

from orb_slam3_tpu.frontend import camera as jcam
from orb_slam3_tpu.frontend import orb as jorb
from orb_slam3_tpu.lm import edges as jedges
from orb_slam3_tpu.ops import lie as jlie
from orb_slam3_tpu_torch.frontend import camera as tcam
from orb_slam3_tpu_torch.frontend import orb as torb
from orb_slam3_tpu_torch.lm import edges as tedges
from orb_slam3_tpu_torch.tracking import tracker as ttrk

torch.set_num_threads(1)
K8 = np.asarray([260.0, 260.0, 256.0, 192.0, 0.01, -0.005, 0.002, -0.001], np.float32)
K_PIN = np.asarray([450.0, 450.0, 376.0, 240.0, 0, 0, 0, 0], np.float32)
DIST = np.asarray([-0.28, 0.07, 1e-4, -1e-4, 0.0], np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _fov_points(n=300, seed=0):
    """Camera-frame points up to ~80 deg off the axis, one on the axis."""
    rng = np.random.default_rng(seed)
    theta = rng.uniform(0.0, 1.4, n)
    phi = rng.uniform(0, 2 * np.pi, n)
    z = rng.uniform(0.5, 8.0, n)
    r = z * np.tan(theta)
    X = np.stack([r * np.cos(phi), r * np.sin(phi), z], -1).astype(np.float32)
    X[0] = (0.0, 0.0, 3.0)
    return X


def test_kb8_project_and_unproject_match_jax():
    X = _fov_points()
    uv_j = np.asarray(jcam.kb8_project(jnp.asarray(K8), jnp.asarray(X)))
    uv_t = tcam.project(tcam.KB8, _t(K8), _t(X)).numpy()
    np.testing.assert_allclose(uv_t, uv_j, atol=1e-3, rtol=0)
    ray_j = np.asarray(jcam.kb8_unproject(jnp.asarray(K8), jnp.asarray(uv_j)))
    ray_t = tcam.unproject(tcam.KB8, _t(K8), _t(uv_j)).numpy()
    unit = lambda r: r / np.linalg.norm(r, axis=-1, keepdims=True)  # noqa: E731
    np.testing.assert_allclose(unit(ray_t), unit(ray_j), atol=1e-5, rtol=0)
    assert ray_t.dtype == np.float32 and (ray_t[:, 2] == 1).all()


def test_kb8_round_trip():
    """test_native_misc.py's round trip, on the port."""
    K = _t(np.asarray([280.0, 280.0, 320.0, 240.0, 0.02, -0.01, 0.005, -0.002], np.float32))
    rng = np.random.default_rng(1)
    X = np.stack([rng.uniform(-3, 3, 200), rng.uniform(-2, 2, 200), rng.uniform(1, 8, 200)],
                 -1).astype(np.float32)
    rays = tcam.kb8_unproject(K, tcam.kb8_project(K, _t(X))).numpy()
    np.testing.assert_allclose(rays[:, :2] * X[:, 2:3], X[:, :2], rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("kind", [tcam.PINHOLE, tcam.KB8])
def test_jacfwd_of_project_matches_jax(kind):
    K = K8 if kind == tcam.KB8 else K_PIN
    X = _fov_points(64, seed=2)[:, :]
    X = X[X[:, 2] > 0.2 * np.linalg.norm(X[:, :2], axis=1)]  # in front, inside the pinhole's reach
    J_j = np.asarray(jax.vmap(jax.jacfwd(lambda x: jcam.project(kind, jnp.asarray(K), x)))(
        jnp.asarray(X)))
    J_t = vmap(jacfwd(lambda x: tcam.project(kind, _t(K), x)))(_t(X))
    assert J_t.dtype == torch.float32
    np.testing.assert_allclose(J_t.numpy(), J_j, rtol=1e-3, atol=1e-3 * np.abs(J_j).max())
    assert np.isfinite(J_t.numpy()).all()


def test_undistort_points_radtan_matches_jax():
    rng = np.random.default_rng(3)
    uv = np.stack([rng.uniform(0, 752, 500), rng.uniform(0, 480, 500)], -1).astype(np.float32)
    got = tcam.undistort_points_radtan(_t(K_PIN), _t(DIST), _t(uv)).numpy()
    ref = np.asarray(jcam.undistort_points_radtan(jnp.asarray(K_PIN), jnp.asarray(DIST),
                                                  jnp.asarray(uv)))
    np.testing.assert_allclose(got, ref, atol=1e-3, rtol=0)


def _blob_frame():
    """test_rectify.py::test_tracker_undistorts_keypoints's frame."""
    rng = np.random.default_rng(1)
    img = np.zeros((480, 752), np.float32)
    xs = rng.integers(20, 730, 800)
    ys = rng.integers(20, 460, 800)
    for x, y in zip(xs, ys):
        img[y:y + 4, x:x + 4] = rng.uniform(60, 255)
    return img


def test_tracker_undistorts_keypoints_like_jax():
    """The JAX Tracker's keypoints are undistort_points_radtan of the raw
    extraction (test_rectify.py holds it). The port's Tracker against the
    JAX undistortion of the same raw keypoints (the port's extraction,
    which test_torch_frontend.py holds to the JAX one)."""
    img = _blob_frame()
    tcfg = ttrk.TrackerConfig(K=K_PIN, img_wh=(752, 480), orb=torb.OrbConfig(300, 2),
                              dist_coeffs=DIST, kmax=8, lmax=1024)
    tf = ttrk.Tracker(tcfg, device="cpu")._extract(_t(img))
    traw = torb.extract(_t(img), tcfg.orb)
    ref = np.asarray(jcam.undistort_points_radtan(jnp.asarray(K_PIN), jnp.asarray(DIST),
                                                  jnp.asarray(traw.xy.numpy())))
    same = traw.valid.numpy()
    assert same.sum() >= 250
    np.testing.assert_allclose(tf.xy.numpy()[same], ref[same], atol=1e-2, rtol=0)
    # the distortion moved the keypoints; the descriptors are the raw image's
    assert np.abs(tf.xy.numpy() - traw.xy.numpy())[same].max() > 1.0
    assert torch.equal(tf.descriptors, traw.descriptors)
    # no distortion (or a KB8 camera): the keypoints are the raw ones
    plain = ttrk.Tracker(ttrk.TrackerConfig(K=K_PIN, img_wh=(752, 480), orb=tcfg.orb,
                                            dist_coeffs=np.zeros(5, np.float32)), device="cpu")
    assert torch.equal(plain._extract(_t(img)).xy, traw.xy)


def test_refine_corners_flat_matches_jax():
    img = _blob_frame()
    rng = np.random.default_rng(4)
    xy = np.stack([rng.integers(30, 720, 400), rng.integers(30, 450, 400)], -1).astype(np.int32)
    patches = np.array(jorb.gather_patches_flat(jnp.asarray(img), jnp.asarray(xy)))
    patches[:5] = 7.0  # flat patches: a singular structure tensor, offset 0
    ref = np.asarray(jorb.refine_corners_flat(jnp.asarray(patches)))
    got = torb.refine_corners_flat(_t(patches)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)
    assert (got[:5] == 0).all() and np.abs(got).max() > 0.1


def test_subpixel_extraction():
    """OrbConfig(subpixel=True): the same keypoints and descriptors (the
    patches stay at the integer corner), each moved by its level's
    refine_corners_flat offset, at most 1 px of that level."""
    img = _blob_frame()[:192, :256].copy()
    sub = torb.extract(_t(img), torb.OrbConfig(200, 2, subpixel=True))
    plain = torb.extract(_t(img), torb.OrbConfig(200, 2))
    assert torch.equal(sub.descriptors, plain.descriptors) and torch.equal(sub.valid, plain.valid)
    scale = 1.2 ** plain.octave.numpy()[:, None]
    moved = np.abs(sub.xy.numpy() - plain.xy.numpy()) / scale
    assert moved.max() > 0.05 and moved.max() <= 1.0 + 1e-5


def test_tobody_residuals_match_jax():
    rng = np.random.default_rng(5)
    R_rl = np.asarray(jlie.so3_exp(jnp.asarray([0.0, -0.5, 0.0])), np.float32)
    t_rl = (-R_rl @ np.array([0.1, 0.0, 0.0])).astype(np.float32)
    R = np.asarray(jlie.so3_exp(jnp.asarray([0.1, 0.05, -0.02])), np.float32)
    t = np.array([0.2, -0.1, 0.3], np.float32)
    X = np.concatenate([rng.uniform(-1, 3, (8, 2)), rng.uniform(3, 7, (8, 1))], 1).astype(
        np.float32)
    uv = rng.uniform(50, 400, (8, 2)).astype(np.float32)
    jr, jp = jedges.make_tobody_residual(jcam.KB8), jedges.make_tobody_pose_only_residual(jcam.KB8)
    tr, tp = tedges.make_tobody_residual(tcam.KB8), tedges.make_tobody_pose_only_residual(tcam.KB8)
    for i in range(8):
        jd = {"uv": jnp.asarray(uv[i]), "K": jnp.asarray(K8), "R_rl": jnp.asarray(R_rl),
              "t_rl": jnp.asarray(t_rl)}
        td = {k: _t(np.asarray(v)) for k, v in jd.items()}
        ref = np.asarray(jr({"R": jnp.asarray(R), "t": jnp.asarray(t)}, {"x": jnp.asarray(X[i])},
                            jd))
        got = tr({"R": _t(R), "t": _t(t)}, {"x": _t(X[i])}, td).numpy()
        np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)
        ref_p = np.asarray(jp({"R": jnp.asarray(R), "t": jnp.asarray(t)},
                              dict(jd, Xw=jnp.asarray(X[i]))))
        got_p = tp({"R": _t(R), "t": _t(t)}, dict(td, Xw=_t(X[i]))).numpy()
        np.testing.assert_allclose(got_p, ref_p, atol=1e-4, rtol=0)
