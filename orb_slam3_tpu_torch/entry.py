"""Entry point of the port: the per-frame visual tracking step.

`entry()` is the counterpart of the JAX package's `__graft_entry__.entry()`:
one full tracking step (ORB extraction, local-map projection matching
through kernel K1, motion-only pose BA through kernel K2) at the flagship
width, 752x480 with 1000 features over 8 levels and a 2048-landmark local
map. It returns `(track_step, example_args)` on CUDA unless the caller
passes `device="cpu"`.

`blob_frame` and `make_scene` build a self-consistent tracking scene from
a seed: landmarks lifted from a frame's own keypoints plus random map slots,
and a perturbed start pose. The frame landmarks must all be matched and the
true pose recovered.
"""

from __future__ import annotations

import numpy as np
import torch

from . import device as device_mod
from .frontend import camera as cam
from .frontend import orb
from .ops import lie
from .tracking import track

FULL_WH = (752, 480)
FULL_L = 2048
START_XI = (0.03, -0.02, 0.05, 0.004, -0.003, 0.002)  # (rho, phi) off the truth


def make_track_step(cfg: orb.OrbConfig, K, img_wh, radius_px: float = 15.0):
    """track_step(img, lm_pos, lm_desc, lm_valid, lm_max_dist, lm_min_dist,
    lm_normal, R0, t0) -> (R, t, n_inliers) on the device of K."""
    scale_factors = cfg.scale_factors(K.device)
    img_wh = (float(img_wh[0]), float(img_wh[1]))

    def track_step(img, lm_pos, lm_desc, lm_valid, lm_maxd, lm_mind,
                   lm_normal, R0, t0):
        feats = orb.extract(img, cfg)
        idx, ok, _visible, _, _d = track.match_local_map(
            cam.PINHOLE, K, R0, t0, lm_pos, lm_desc, lm_valid,
            lm_maxd, lm_mind, lm_normal,
            feats.xy, feats.descriptors, feats.octave, feats.valid,
            radius_px, scale_factors, img_wh=img_wh,
        )
        idx = idx.long()
        oct_m = torch.clamp(feats.octave[idx], 0, cfg.n_levels - 1).long()
        inv_sig2 = 1.0 / (scale_factors[oct_m] ** 2)
        R, t, _inl, n = track.pose_optimize(
            cam.PINHOLE, K, R0, t0, feats.xy[idx].contiguous(), lm_pos,
            inv_sig2, ok,
        )
        return R, t, n

    return track_step


def entry(device=None):
    """(track_step, example_args) at full width on `device` (default CUDA).
    The example arguments are those of the JAX entry(): a uniform-noise
    frame and random landmarks, made from numpy seed 0."""
    dev = device_mod.resolve(device)
    cfg = orb.OrbConfig(n_features=1000, n_levels=8)
    K = cam.make_pinhole(450.0, 450.0, 376.0, 240.0, device=dev)
    step = make_track_step(cfg, K, FULL_WH)

    L = FULL_L
    rng = np.random.default_rng(0)
    f32 = dict(dtype=torch.float32, device=dev)
    img = torch.tensor(rng.uniform(0, 255, (FULL_WH[1], FULL_WH[0])), **f32)
    lm_pos = torch.tensor(
        np.concatenate([rng.uniform(-3, 3, (L, 2)), rng.uniform(4, 9, (L, 1))], axis=1),
        **f32,
    )
    lm_desc = torch.tensor(rng.integers(0, 256, (L, 32)), dtype=torch.uint8, device=dev)
    example_args = (
        img, lm_pos, lm_desc, torch.ones(L, dtype=torch.bool, device=dev),
        torch.full((L,), 8.0, **f32), torch.full((L,), 2.0, **f32),
        torch.zeros((L, 3), **f32),
        torch.eye(3, **f32), torch.zeros(3, **f32),
    )
    return step, example_args


def blob_frame(h: int, w: int, seed: int = 1, n_blobs=None):
    """Blob-textured float32 frame drawn like the JAX bench's hot-path frames
    (bench.py): square blobs of side 3-9 and value 40-255 on black. The blob
    count defaults to the bench's 2500 per 752x480, scaled by area."""
    if n_blobs is None:
        n_blobs = int(round(2500 * h * w / (752 * 480)))
    rng = np.random.default_rng(seed)
    img = np.zeros((h, w), np.float32)
    xs = rng.integers(10, w - 12, n_blobs)
    ys = rng.integers(10, h - 10, n_blobs)
    side = rng.integers(3, 10, n_blobs)
    val = rng.uniform(40, 255, n_blobs)
    for x, y, s, v in zip(xs, ys, side, val):
        img[y:y + s, x:x + s] = v
    return img


def make_scene(xy, octave, desc, valid, K, n_levels: int, L: int,
               scale: float = 1.2, seed: int = 0, start_xi=START_XI):
    """Self-consistent local map for a frame's own features (numpy in,
    numpy out, float32 / uint8 / bool as the packages hold them).

    Every valid keypoint becomes a landmark at depth U[4, 8] on its ray under
    the true pose (identity), with the keypoint's descriptor,
    max_dist = |X| * scale**octave, min_dist = max_dist / scale**(levels-1)
    and a unit normal towards the camera's view. The remaining L - n slots
    are random valid landmarks with random descriptors (like entry()'s
    example map). Rows are shuffled. Tracking starts from
    exp(start_xi) * truth. Returns a dict with lm_pos, lm_desc, lm_valid,
    lm_max_dist, lm_min_dist, lm_normal, R0, t0, R_true, t_true, n_frame."""
    rng = np.random.default_rng(seed)
    K = np.asarray(K, np.float64)
    fx, fy, cx, cy = K[:4]
    keep = np.flatnonzero(np.asarray(valid))
    n_frame = min(len(keep), L)
    keep = keep[:n_frame]
    uv = np.asarray(xy, np.float64)[keep]
    depth = rng.uniform(4.0, 8.0, n_frame)
    X = np.stack([(uv[:, 0] - cx) / fx * depth, (uv[:, 1] - cy) / fy * depth, depth], 1)
    dist = np.linalg.norm(X, axis=1)
    maxd = dist * scale ** np.asarray(octave, np.float64)[keep]
    mind = maxd / scale ** (n_levels - 1)
    normal = X / dist[:, None]
    d_frame = np.asarray(desc, np.uint8)[keep]

    n_rand = L - n_frame
    Xr = np.concatenate([rng.uniform(-3, 3, (n_rand, 2)), rng.uniform(4, 9, (n_rand, 1))], 1)
    d_rand = rng.integers(0, 256, (n_rand, 32)).astype(np.uint8)

    perm = rng.permutation(L)
    lm_pos = np.concatenate([X, Xr])[perm]
    lm_desc = np.concatenate([d_frame, d_rand])[perm]
    lm_maxd = np.concatenate([maxd, np.full(n_rand, 8.0)])[perm]
    lm_mind = np.concatenate([mind, np.full(n_rand, 2.0)])[perm]
    lm_normal = np.concatenate([normal, np.zeros((n_rand, 3))])[perm]

    R0, t0 = (a.numpy() for a in lie.se3_exp(torch.tensor(start_xi, dtype=torch.float64)))
    f = np.float32
    return dict(
        lm_pos=lm_pos.astype(f), lm_desc=np.ascontiguousarray(lm_desc),
        lm_valid=np.ones(L, bool), lm_max_dist=lm_maxd.astype(f),
        lm_min_dist=lm_mind.astype(f), lm_normal=lm_normal.astype(f),
        R0=R0.astype(f), t0=t0.astype(f),
        R_true=np.eye(3, dtype=f), t_true=np.zeros(3, f), n_frame=n_frame,
    )
