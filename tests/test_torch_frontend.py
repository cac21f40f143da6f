"""ORB front end of the PyTorch port against the JAX package.

Same numpy frame (a blob-textured 256x192 image, 256 features over 4
levels) through both packages on the CPU: pyramid and blur, FAST scores,
keypoint selection on one shared response map, and the full extraction.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam3_tpu.frontend import fast as jfast
from orb_slam3_tpu.frontend import orb as jorb
from orb_slam3_tpu.frontend import pyramid as jpyr
from orb_slam3_tpu.frontend import select as jselect
from orb_slam3_tpu_torch import entry as tentry
from orb_slam3_tpu_torch.frontend import fast as tfast
from orb_slam3_tpu_torch.frontend import orb as torb
from orb_slam3_tpu_torch.frontend import pyramid as tpyr
from orb_slam3_tpu_torch.frontend import select as tselect

torch.set_num_threads(1)

H, W = 192, 256
CFG_ARGS = dict(n_features=256, n_levels=4)


@pytest.fixture(scope="module")
def frame():
    return tentry.blob_frame(H, W, seed=5)


def test_pyramid_and_blur(frame):
    jl = jpyr.build_pyramid(jnp.asarray(frame), 4, 1.2)
    tl = tpyr.build_pyramid(torch.from_numpy(frame), 4, 1.2)
    assert [tuple(t.shape) for t in tl] == [tuple(j.shape) for j in jl]
    for j, t in zip(jl, tl):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-3)
        np.testing.assert_allclose(
            tpyr.gaussian_blur(t).numpy(),
            np.asarray(jpyr.gaussian_blur(jnp.asarray(t.numpy()))), atol=1e-3,
        )


def test_fast_score(frame):
    s_j = np.asarray(jfast.fast_score(jnp.asarray(frame)))
    s_t = tfast.fast_score(torch.from_numpy(frame)).numpy()
    np.testing.assert_allclose(s_t, s_j, atol=1e-3)
    d_j = np.asarray(jfast.detect(jnp.asarray(frame), 20.0, 7.0, 35, 19))
    d_t = tfast.detect(torch.from_numpy(frame), 20.0, 7.0, 35, 19).numpy()
    np.testing.assert_allclose(d_t, d_j, atol=1e-3)


def test_select_keypoints_exact(frame):
    resp = np.array(jfast.detect(jnp.asarray(frame), 20.0, 7.0, 35, 19))
    # plant exact ties inside one cell and across cells: the order must follow
    # the JAX tie-breaking (lower index first) bit for bit
    resp[40, 40] = resp[41, 44] = resp[100, 200] = 55.0
    xy_j, s_j, v_j = jselect.select_keypoints(jnp.asarray(resp), 120, cell=35)
    xy_t, s_t, v_t = tselect.select_keypoints(torch.from_numpy(resp), 120, cell=35)
    np.testing.assert_array_equal(xy_t.numpy(), np.asarray(xy_j))
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
    np.testing.assert_array_equal(v_t.numpy(), np.asarray(v_j))


def test_extract_matches_jax(frame):
    # JAX runs op by op here: jitted, XLA:CPU fuses the blur's multiply-adds
    # into FMAs and moves a few descriptor bits; the port rounds each product
    f_j = jorb.extract(jnp.asarray(frame), jorb.OrbConfig(**CFG_ARGS))
    f_t = torb.extract(torch.from_numpy(frame), torb.OrbConfig(**CFG_ARGS))
    valid_j = np.asarray(f_j.valid)
    assert valid_j.shape == tuple(f_t.valid.shape)
    assert valid_j.sum() > 200
    both = valid_j & f_t.valid.numpy()
    same_kp = (
        both
        & np.all(np.asarray(f_j.xy) == f_t.xy.numpy(), axis=1)
        & (np.asarray(f_j.octave) == f_t.octave.numpy())
    )
    assert same_kp.sum() >= 0.99 * valid_j.sum(), (same_kp.sum(), valid_j.sum())
    same_desc = same_kp & np.all(
        np.asarray(f_j.descriptors) == f_t.descriptors.numpy(), axis=1
    )
    assert same_desc.sum() >= 0.99 * same_kp.sum(), (same_desc.sum(), same_kp.sum())
    # bit-level agreement over all descriptor bits of the common keypoints
    xor = np.bitwise_xor(np.asarray(f_j.descriptors), f_t.descriptors.numpy())[same_kp]
    bit_share = 1.0 - np.unpackbits(xor).sum() / (xor.size * 8)
    assert bit_share >= 0.999, bit_share
    np.testing.assert_allclose(
        f_t.angle.numpy()[same_kp], np.asarray(f_j.angle)[same_kp], atol=1e-4
    )
