"""Oriented FAST + rotated BRIEF over the full pyramid (port of
orb_slam3_tpu/frontend/orb.py).

`ORBextractor::operator()`: per-level FAST with the dual-threshold fallback
and spatial selection, IC_Angle intensity-centroid orientation, 7x7 sigma=2
blur, and the 256-pair steered BRIEF with the learned ORB pattern
(assets/orb_pattern.npy, the public constant shared with OpenCV).

Patches are read with direct index gathers on an edge-padded image (the
JAX package's one-hot matmul gathers were a TPU layout device). The
IC-angle moments stay one f32 matmul against the same weight table.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch
import torch.nn.functional as F

from . import fast as fast_mod
from . import pyramid as pyr_mod
from . import select as select_mod

HALF_PATCH = 15  # IC_Angle radius (ORBextractor.cc:57 HALF_PATCH_SIZE)
PATCH = 41       # gathered patch size (centre 20; covers rotated BRIEF +-19)
PR = PATCH // 2

_PATTERN = np.load(
    os.path.join(os.path.dirname(__file__), "assets", "orb_pattern.npy")
).astype(np.float32)  # [256, 4] = x1, y1, x2, y2


def _umax_table():
    """Circular-patch row extents, built exactly like the ORBextractor ctor."""
    hp = HALF_PATCH
    umax = np.zeros(hp + 2, dtype=np.int32)
    vmax = int(np.floor(hp * np.sqrt(2.0) / 2 + 1))
    vmin = int(np.ceil(hp * np.sqrt(2.0) / 2))
    for v in range(vmax + 1):
        umax[v] = int(round(np.sqrt(hp * hp - v * v)))
    v0 = 0
    for v in range(hp, vmin - 1, -1):
        while umax[v0] == umax[v0 + 1]:
            v0 += 1
        umax[v] = v0
        v0 += 1
    return umax[: hp + 1]


def _ic_angle_mask_and_coords():
    """(mask, u, v), each [31, 31] float32, for IC_Angle."""
    us, vs = np.meshgrid(
        np.arange(-HALF_PATCH, HALF_PATCH + 1),
        np.arange(-HALF_PATCH, HALF_PATCH + 1),
    )
    mask = np.abs(us) <= _umax_table()[np.abs(vs)]
    return mask.astype(np.float32), us.astype(np.float32), vs.astype(np.float32)


def _ic_weight_full_np():
    """[1681, 2] moment weights over the full flat 41x41 patch (zero outside
    the 31x31 IC disc): the moments are one matmul."""
    mask, us, vs = _ic_angle_mask_and_coords()
    W = np.zeros((PATCH, PATCH, 2), np.float32)
    sl = slice(PR - HALF_PATCH, PR + HALF_PATCH + 1)
    W[sl, sl, 0] = mask * us
    W[sl, sl, 1] = mask * vs
    return W.reshape(-1, 2)


_IC_W_FULL_NP = _ic_weight_full_np()
_CONSTS: dict = {}


def _consts(device):
    """(IC weights [1681, 2], pattern A [256, 2], pattern B [256, 2]) on device."""
    key = str(device)
    if key not in _CONSTS:
        _CONSTS[key] = (
            torch.from_numpy(_IC_W_FULL_NP).to(device),
            torch.from_numpy(_PATTERN[:, 0:2].copy()).to(device),
            torch.from_numpy(_PATTERN[:, 2:4].copy()).to(device),
        )
    return _CONSTS[key]


def gather_patches_flat_multi(imgs, xy_int):
    """imgs [C, H, W] sharing keypoint coords, integer xy [N, 2] (x, y) ->
    [C, N, 1681] flattened 41x41 patches centred on each keypoint, read from
    the edge-padded images."""
    _, h, w = imgs.shape
    padded = F.pad(imgs, (PR, PR, PR, PR), mode="replicate")
    x = torch.clamp(xy_int[:, 0], 0, w - 1)
    y = torch.clamp(xy_int[:, 1], 0, h - 1)
    di = torch.arange(PATCH, device=imgs.device)
    rows = (y[:, None] + di[None, :])[:, :, None]   # [N, 41, 1]
    cols = (x[:, None] + di[None, :])[:, None, :]   # [N, 1, 41]
    patches = padded[:, rows, cols]                 # [C, N, 41, 41]
    return patches.reshape(imgs.shape[0], -1, PATCH * PATCH)


def ic_angle_flat(flat_patches):
    """Intensity-centroid angle of [N, 1681] raw patches (IC_Angle,
    ORBextractor.cc:76-105): one [N, 1681] @ [1681, 2] f32 matmul."""
    w_full, _, _ = _consts(flat_patches.device)
    m = flat_patches @ w_full  # [N, 2] = (m10, m01)
    return torch.atan2(m[:, 1], m[:, 0])


def brief_descriptors_flat(flat_patches, angles):
    """Steered BRIEF: [N, 1681] blurred patches + [N] angles -> [N, 32] uint8.

    Sample coordinates follow computeOrbDescriptor (ORBextractor.cc:107-148):
    col = round(x cos - y sin), row = round(x sin + y cos), half to even.
    Bit k of byte j compares pair 8j + k (LSB first)."""
    _, pat_a, pat_b = _consts(flat_patches.device)
    a = torch.cos(angles)[:, None]
    b = torch.sin(angles)[:, None]

    def rot(P):
        px, py = P[None, :, 0], P[None, :, 1]
        col = torch.round(px * a - py * b).to(torch.int64) + PR
        row = torch.round(px * b + py * a).to(torch.int64) + PR
        return row.clamp(0, PATCH - 1), col.clamp(0, PATCH - 1)

    n = flat_patches.shape[0]
    P3 = flat_patches.reshape(n, PATCH, PATCH)
    nidx = torch.arange(n, device=flat_patches.device)[:, None]
    ra, ca = rot(pat_a)
    rb, cb = rot(pat_b)
    bits = (P3[nidx, ra, ca] < P3[nidx, rb, cb]).to(torch.int32)  # [N, 256]
    shifts = torch.arange(8, dtype=torch.int32, device=flat_patches.device)
    return (bits.reshape(n, 32, 8) << shifts).sum(dim=-1).to(torch.uint8)


@dataclasses.dataclass(frozen=True)
class OrbConfig:
    n_features: int = 1000
    n_levels: int = 8
    scale_factor: float = 1.2
    ini_th_fast: float = 20.0
    min_th_fast: float = 7.0
    cell: int = 35
    border: int = 19  # EDGE_THRESHOLD (ORBextractor.cc:73)
    # subpixel corner refinement is off the tracking path (default False in
    # the JAX package too); its port arrives with the slice that needs it
    subpixel: bool = False

    def features_per_level(self):
        """Geometric feature budget per level (ORBextractor ctor :409-430)."""
        factor = 1.0 / self.scale_factor
        n_first = self.n_features * (1 - factor) / (1 - factor ** self.n_levels)
        per = []
        total = 0
        for lvl in range(self.n_levels - 1):
            k = int(round(n_first * factor ** lvl))
            per.append(k)
            total += k
        per.append(max(self.n_features - total, 0))
        return per

    def scale_factors(self, device):
        """[n_levels] float32 tensor of scale_factor ** level."""
        return torch.tensor(
            [self.scale_factor ** i for i in range(self.n_levels)],
            dtype=torch.float32, device=device,
        )


@dataclasses.dataclass
class Features:
    """Fixed-capacity keypoint set in level-0 pixel coordinates."""

    xy: torch.Tensor           # [N, 2] float32 (x, y) at level-0 scale
    response: torch.Tensor     # [N] float32
    angle: torch.Tensor        # [N] float32 radians
    octave: torch.Tensor       # [N] int32
    descriptors: torch.Tensor  # [N, 32] uint8
    valid: torch.Tensor        # [N] bool


def extract_level_patches(img, n_max: int, cfg: OrbConfig):
    """One level: detect + select + patch gather, in level coordinates.
    Returns (xy, score, valid, raw_flat, blur_flat)."""
    if cfg.subpixel:
        raise NotImplementedError("subpixel refinement is not ported yet")
    resp = fast_mod.detect(
        img, cfg.ini_th_fast, cfg.min_th_fast, cell=cfg.cell, border=cfg.border
    )
    xy, score, valid = select_mod.select_keypoints(resp, n_max, cell=cfg.cell)
    xy_int = xy.to(torch.int64)
    blurred = pyr_mod.gaussian_blur(img)
    both = gather_patches_flat_multi(torch.stack([img, blurred]), xy_int)
    return xy, score, valid, both[0], both[1]


def extract(img, cfg: OrbConfig = OrbConfig()):
    """Full-pyramid ORB extraction: [H, W] image -> Features on img's device.

    Per-level detection, selection and gather on the true level shapes, then
    one orientation + descriptor pass over all levels' patches. Arrays have
    the static size sum(features_per_level) (padded with valid=False), with
    coordinates scaled to level 0 (`ORBextractor.cc:1152-1161`)."""
    img = img.to(torch.float32)
    levels = pyr_mod.build_pyramid(img, cfg.n_levels, cfg.scale_factor)
    budgets = cfg.features_per_level()

    parts = []
    for lvl, (lv_img, n_lvl) in enumerate(zip(levels, budgets)):
        if n_lvl == 0:
            continue
        xy, score, valid, raw_flat, blur_flat = extract_level_patches(lv_img, n_lvl, cfg)
        scale = cfg.scale_factor ** lvl
        octave = torch.full((xy.shape[0],), lvl, dtype=torch.int32, device=img.device)
        parts.append((xy * scale, score, octave, valid, raw_flat, blur_flat))

    angles = ic_angle_flat(torch.cat([p[4] for p in parts]))
    desc = brief_descriptors_flat(torch.cat([p[5] for p in parts]), angles)
    return Features(
        xy=torch.cat([p[0] for p in parts]),
        response=torch.cat([p[1] for p in parts]),
        angle=angles,
        octave=torch.cat([p[2] for p in parts]),
        descriptors=desc,
        valid=torch.cat([p[3] for p in parts]),
    )
