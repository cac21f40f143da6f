"""Kernel K1 (projection-windowed descriptor search) of the PyTorch port.

The port's plain version runs on the CPU against the JAX package's XLA
formulation (matching.search_by_projection) and its Pallas kernel in
interpret mode, on the case of tests/test_match_kernel.py plus a planted
tie at the best distance (must reject) and rows where nothing passes
(idx 0). `ok` must agree exactly, idx and dist wherever ok. The CUDA
kernel against the plain version is in test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import torch
from jax.experimental.pallas import tpu as pltpu

from orb_slam3_tpu.frontend import match_kernel as jmk
from orb_slam3_tpu.frontend import matching as jmatch
from orb_slam3_tpu_torch.frontend import match_kernel as tmk
from orb_slam3_tpu_torch.frontend import matching as tmatch

torch.set_num_threads(1)
N_LEVELS = 4


def _case(seed=7, N=300, M=250):
    """tests/test_match_kernel.py's case, with a tie and empty rows planted."""
    rng = np.random.default_rng(seed)
    uv_pred = rng.uniform(0, 640, (N, 2)).astype(np.float32)
    kp_xy = rng.uniform(0, 640, (M, 2)).astype(np.float32)
    pred_desc = rng.integers(0, 256, (N, 32)).astype(np.uint8)
    kp_desc = rng.integers(0, 256, (M, 32)).astype(np.uint8)
    kp_desc[: M // 2] = pred_desc[: M // 2]
    kp_xy[: M // 2] = uv_pred[: M // 2] + rng.uniform(-3, 3, (M // 2, 2)).astype(np.float32)
    pred_oct = rng.integers(0, N_LEVELS, N).astype(np.int32)
    kp_oct = rng.integers(0, N_LEVELS, M).astype(np.int32)
    kp_oct[: M // 2] = pred_oct[: M // 2]
    pred_valid = rng.uniform(size=N) > 0.1
    kp_valid = rng.uniform(size=M) > 0.1
    # planted tie: keypoint M-1 duplicates keypoint 3 (same descriptor, same
    # place, same octave), so landmark 3 sees two columns at its best distance
    pred_valid[3] = kp_valid[3] = kp_valid[M - 1] = True
    kp_desc[M - 1], kp_xy[M - 1], kp_oct[M - 1] = kp_desc[3], kp_xy[3], kp_oct[3]
    # empty rows: one invalid landmark, one far outside every window
    pred_valid[10] = False
    pred_valid[11] = True
    uv_pred[11] = (5000.0, 5000.0)
    return dict(uv_pred=uv_pred, pred_octave=pred_oct, pred_desc=pred_desc,
                pred_valid=pred_valid, kp_xy=kp_xy, kp_octave=kp_oct,
                kp_desc=kp_desc, kp_valid=kp_valid)


def _scales():
    return np.asarray([1.2 ** i for i in range(N_LEVELS)], np.float32)


def _port(c, device="cpu"):
    t = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in c.items()}
    sf = torch.from_numpy(_scales()).to(device)
    return tmatch.search_by_projection(
        t["uv_pred"], t["pred_octave"], t["pred_desc"], t["pred_valid"],
        t["kp_xy"], t["kp_octave"], t["kp_desc"], t["kp_valid"],
        10.0, sf, max_dist=tmatch.TH_HIGH, ratio=0.8, level_lo=-1, level_hi=1,
    )


def _assert_same(a, b):
    idx_a, d_a, ok_a = (np.asarray(x) for x in a)
    idx_b, d_b, ok_b = (np.asarray(x) for x in b)
    np.testing.assert_array_equal(ok_a, ok_b)
    np.testing.assert_array_equal(idx_a[ok_b], idx_b[ok_b])
    np.testing.assert_array_equal(d_a[ok_b], d_b[ok_b])


def test_plain_matches_jax_xla_and_pallas():
    c = _case()
    j = {k: jnp.asarray(v) for k, v in c.items()}
    sf = jnp.asarray(_scales())
    ref = jmatch.search_by_projection(
        j["uv_pred"], j["pred_octave"], j["pred_desc"], j["pred_valid"],
        j["kp_xy"], j["kp_octave"], j["kp_desc"], j["kp_valid"],
        10.0, sf, max_dist=jmatch.TH_HIGH, ratio=0.8, level_lo=-1, level_hi=1,
    )
    radius = 10.0 * sf[jnp.clip(j["pred_octave"], 0, N_LEVELS - 1)]
    with pltpu.force_tpu_interpret_mode():
        pallas = jmk.search_by_projection_pallas(
            j["uv_pred"], j["pred_octave"], j["pred_desc"], j["pred_valid"],
            j["kp_xy"], j["kp_octave"], j["kp_desc"], j["kp_valid"], radius,
            max_dist=jmatch.TH_HIGH, ratio=0.8, level_lo=-1, level_hi=1,
        )
    port = [x.numpy() for x in _port(c)]
    _assert_same(port, ref)
    _assert_same(port, pallas)
    idx, dist, ok = port
    assert ok.sum() > 50  # the planted matches are found
    # the tie at the best distance makes second == best: rejected
    assert dist[3] == 0 and not ok[3]
    # rows where nothing passes: argmin of an all-BIG row
    for r in (10, 11):
        assert (idx[r], dist[r], ok[r]) == (0, tmk.BIG, False)
    np.testing.assert_array_equal(dist[10:12], np.asarray(ref[1])[10:12])
    np.testing.assert_array_equal(idx[10:12], np.asarray(ref[0])[10:12])


def test_hamming_matrix_exact():
    rng = np.random.default_rng(0)
    a = rng.integers(0, 256, (40, 32)).astype(np.uint8)
    b = rng.integers(0, 256, (30, 32)).astype(np.uint8)
    ref = np.unpackbits(a[:, None, :] ^ b[None, :, :], axis=-1).sum(-1)
    got = tmatch.hamming_matrix(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(
        got, np.asarray(jmatch.hamming_matrix(jnp.asarray(a), jnp.asarray(b)))
    )
