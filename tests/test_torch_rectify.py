"""The port's stereo rectification and the System's resize against the JAX
package, on the same numpy inputs, with inline K / D / R / P values (the
reference's legacy EuRoC file is not needed).

- build_remap equal to the JAX package's (the same numpy algorithm), with
  R = I and with a rotated R;
- remap_bilinear and StereoRectifier within 1e-4;
- the System's Camera.newWidth/newHeight resize (F.interpolate, half-pixel
  centres, no antialiasing) within 1e-3 of jax.image.resize(..., "bilinear",
  antialias=False), down and up;
- the raw renderer through rad-tan distortion, rectified, gives the
  pinhole render of the same pose without an offset (the EuRoC rectified
  session's frames), and its undistortion converges in the corners.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from orb_slam3_tpu.frontend import rectify as jrect
from orb_slam3_tpu.ops import lie as jlie
from orb_slam3_tpu_torch import entry
from orb_slam3_tpu_torch.frontend import rectify as trect

torch.set_num_threads(1)
WH = (752, 480)


def _sides(rotated: bool):
    K = np.array([[entry.EUROC_K[0], 0, entry.EUROC_K[2]], [0, entry.EUROC_K[1], entry.EUROC_K[3]],
                  [0, 0, 1]])
    R = (np.asarray(jlie.so3_exp(jnp.asarray([0.01, -0.02, 0.005])), np.float64) if rotated
         else np.eye(3))
    P = np.array([[450.0, 0, 376.0, 0], [0, 450.0, 240.0, 0], [0, 0, 1, 0]])
    Pr = P.copy()
    Pr[0, 3] = -450.0 * 0.11
    D = np.asarray(entry.EUROC_D)
    return dict(K=K, D=D, R=R, P=P), dict(K=K, D=D[:4], R=R.T, P=Pr)


@pytest.mark.parametrize("rotated", [False, True])
def test_build_remap_equals_jax(rotated):
    for side in _sides(rotated):
        args = (side["K"], side["D"], side["R"], side["P"], *WH)
        ours = trect.build_remap(*args)
        ref = jrect.build_remap(*args)
        assert ours.dtype == np.float32 and ours.shape == (WH[1], WH[0], 2)
        np.testing.assert_array_equal(ours, ref)


def test_remap_bilinear_and_rectifier_match_jax():
    left, right = _sides(True)
    rng = np.random.default_rng(0)
    img_l = rng.uniform(0, 255, (WH[1], WH[0])).astype(np.float32)
    img_r = rng.uniform(0, 255, (WH[1], WH[0])).astype(np.float32)
    m = jrect.build_remap(left["K"], left["D"], left["R"], left["P"], *WH)
    m[:3, :3] = (-5.0, 900.0)  # samples outside the image read the clamped border
    ref = np.asarray(jrect.remap_bilinear(jnp.asarray(img_l), jnp.asarray(m)))
    got = trect.remap_bilinear(torch.from_numpy(img_l), torch.from_numpy(m)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)
    jl, jr = jrect.StereoRectifier(left, right, *WH)(img_l, img_r)
    tl, tr = trect.StereoRectifier(left, right, *WH, device="cpu")(img_l, img_r)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=0)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=1e-4, rtol=0)


@pytest.mark.parametrize("src,dst", [((752, 480), (600, 350)), ((256, 192), (320, 240))])
def test_resize_matches_jax_image_resize(src, dst):
    img = np.random.default_rng(1).uniform(0, 255, (src[1], src[0])).astype(np.float32)
    ref = np.asarray(jax.image.resize(jnp.asarray(img), (dst[1], dst[0]), "bilinear",
                                      antialias=False))
    got = F.interpolate(torch.from_numpy(img)[None, None], size=(dst[1], dst[0]),
                        mode="bilinear", align_corners=False, antialias=False)[0, 0].numpy()
    np.testing.assert_allclose(got, ref, atol=1e-3, rtol=0)


def test_radtan_render_rectifies_to_the_pinhole_render():
    planes = entry.plane_scene(2)
    R, t = entry.orbit_trajectory(3)
    raw = entry.render_radtan(planes, entry.EUROC_K, entry.EUROC_D, WH, R[2], t[2])
    left, _ = _sides(False)
    rect = trect.StereoRectifier(left, left, *WH, device="cpu")(raw, raw)[0].numpy()
    pin = entry.render_planes(planes, entry.FULL_K, WH, R[2], t[2])
    # rectified pixels whose source lies inside the raw image
    m = trect.build_remap(left["K"], left["D"], left["R"], left["P"], *WH)
    inside = (m[..., 0] > 1) & (m[..., 0] < WH[0] - 2) & (m[..., 1] > 1) & (m[..., 1] < WH[1] - 2)
    assert inside.mean() > 0.95
    # no offset: the error (the blur of resampling twice) grows when the
    # pinhole render moves by half a pixel either way
    err = np.abs(rect - pin)[inside].mean()
    for dx, dy in ((0.5, 0.0), (-0.5, 0.0), (0.0, 0.5), (0.0, -0.5)):
        K2 = (450.0, 450.0, 376.0 + dx, 240.0 + dy)
        moved = np.abs(rect - entry.render_planes(planes, K2, WH, R[2], t[2]))[inside].mean()
        assert err < 0.9 * moved, (err, moved, dx, dy)
    # and the distortion is real: the raw image is not the pinhole one
    assert np.abs(raw - pin).mean() > 10.0
    # the undistortion behind the raw render converged at the corners
    us, vs = np.meshgrid(np.array([0.0, WH[0] - 1.0]), np.array([0.0, WH[1] - 1.0]))
    rays = entry.radtan_undistort_np(np.asarray(entry.EUROC_K), entry.EUROC_D, us, vs)
    x, y = rays[..., 0], rays[..., 1]
    k1, k2, p1, p2, k3 = entry.EUROC_D
    r2 = x * x + y * y
    rad = 1 + r2 * (k1 + r2 * (k2 + r2 * k3))
    u = entry.EUROC_K[0] * (x * rad + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)) + entry.EUROC_K[2]
    v = entry.EUROC_K[1] * (y * rad + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y) + entry.EUROC_K[3]
    np.testing.assert_allclose(np.stack([u, v]), np.stack([us, vs]), atol=1e-6)
