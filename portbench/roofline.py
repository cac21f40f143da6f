"""The least time K1 and K2 could take on their inputs, and the peaks they are
held to.

Frozen copies of `chip_smoke.k1_bound`, `chip_smoke.k2_bound` and
`chip_smoke.bound_ms` at commit 356070c, with the window and octave tests of
`orb_slam3_tpu_torch/frontend/matching.{window_mask, octave_mask}` written
out here, so that nothing of the program computes the yardstick.

Peaks: NVIDIA's H100 SXM data sheet, dense, at the full 700 W: HBM at
3.35 TB/s, and 67 TFLOP/s of float32 outside the tensor cores, the only
non-tensor rate it gives, applied to every scalar op (float, integer and
compare alike). Both kernels are scalar code.
"""

from __future__ import annotations

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bytes_per_s": 3.35e12, "ops_per_s": 67e12},
}


def k1_bound(args, kwargs):
    """(bytes, ops) one K1 call needs: `search_by_projection_kernel`'s
    arguments (uv_pred, pred_octave, pred_desc, pred_valid, kp_xy,
    kp_octave, kp_desc, kp_valid, radius) and its level window."""
    uv, po, _pd, pv, kp, ko, _kd, kv, radius = args
    lo, hi = kwargs.get("level_lo", -1), kwargs.get("level_hi", 1)
    N, M = uv.shape[0], kp.shape[0]
    nbytes = N * (8 + 4 + 32 + 1 + 4) + M * (8 + 4 + 32 + 1) + N * (4 + 4 + 1)
    d = (uv[:, None, :] - kp[None, :, :]).abs()
    window = (d <= radius[:, None, None]).all(dim=-1) & pv[:, None] & kv[None, :]
    o, p = ko[None, :], po[:, None]
    gated = window & (o >= p + lo) & (o <= p + hi)
    # binning the keypoints once (~12 ops each), a gate test for the
    # keypoints inside each window (9 ops), and per gated-in pair the
    # descriptor distance and the best / second update (27 ops)
    ops = M * 12 + int(window.sum()) * 9 + int(gated.sum()) * 27
    return nbytes, ops


def k2_bound(args, kwargs):
    """(bytes, ops) one K2 call needs: `pose_ba`'s arguments (K, R0, t0,
    uv, Xw, inv_sigma2, valid), ur when stereo rows are given, and its
    rounds and iterations. Only valid rows count."""
    K, R0, t0, uv, Xw, isig, valid = args[:7]
    ur = kwargs.get("ur", args[7] if len(args) > 7 else None)
    rounds = kwargs.get("rounds", 3)
    iters = kwargs.get("iters", 6)
    B, N = uv.shape[0], uv.shape[1]
    n_valid = int(valid.sum())
    n_stereo = int((valid & (ur >= 0)).sum()) if ur is not None else 0
    nbytes = B * N + n_valid * (8 + 12 + 4 + (4 if ur is not None else 0))
    nbytes += B * (16 + 36 + 12 + (4 if ur is not None else 0))
    nbytes += B * (36 + 12 + 4) + B * N
    # one sweep over the valid rows per Gauss-Newton iteration plus one per
    # round; ~200 ops a mono row, ~85 more with a uR residual
    sweeps = rounds * (1 + iters)
    return nbytes, sweeps * (n_valid * 200 + n_stereo * 85)


def bound_s(nbytes, ops, peak):
    """The larger of bytes over bandwidth and ops over the scalar rate."""
    return max(nbytes / peak["bytes_per_s"], ops / peak["ops_per_s"])
