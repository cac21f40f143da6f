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


def refine_corners_flat(raw_flat, win: int = 4, iters: int = 3):
    """Subpixel corner refinement on [N, 1681] raw patches by the normal
    equations of cv::cornerSubPix: q = G^-1 sum w (grad grad^T) p over a
    (2 win + 1)^2 window, iterated with the Gaussian weight re-centred on
    the current estimate (the JAX package's `refine_corners_flat`; the
    reference keeps integer FAST corners). Returns [N, 2] offsets clamped
    to +-1 px, unchanged where the structure tensor is near-singular."""
    n = raw_flat.shape[0]
    P3 = raw_flat.reshape(n, PATCH, PATCH)
    lo, hi = PR - win, PR + win + 1
    Ix = 0.5 * (P3[:, lo:hi, lo + 1:hi + 1] - P3[:, lo:hi, lo - 1:hi - 1])
    Iy = 0.5 * (P3[:, lo + 1:hi + 1, lo:hi] - P3[:, lo - 1:hi - 1, lo:hi])
    ar = torch.arange(-win, win + 1, dtype=torch.float32, device=raw_flat.device)
    dy, dx = torch.meshgrid(ar, ar, indexing="ij")
    dx, dy = dx[None], dy[None]
    sig2 = 2.0 * (win / 2.0) ** 2
    Ixx, Ixy, Iyy = Ix * Ix, Ix * Iy, Iy * Iy
    off = torch.zeros((n, 2), dtype=torch.float32, device=raw_flat.device)
    for _ in range(iters):
        wj = torch.exp(-((dx - off[:, 0, None, None]) ** 2
                         + (dy - off[:, 1, None, None]) ** 2) / sig2)
        gxx = torch.sum(wj * Ixx, dim=(1, 2))
        gxy = torch.sum(wj * Ixy, dim=(1, 2))
        gyy = torch.sum(wj * Iyy, dim=(1, 2))
        bx = torch.sum(wj * (Ixx * dx + Ixy * dy), dim=(1, 2))
        by = torch.sum(wj * (Ixy * dx + Iyy * dy), dim=(1, 2))
        det = gxx * gyy - gxy * gxy
        scale = torch.clamp(gxx + gyy, min=1e-9)
        ok = det > 1e-6 * scale * scale
        det_s = torch.where(ok, det, 1.0)
        new = torch.stack([(gyy * bx - gxy * by) / det_s, (gxx * by - gxy * bx) / det_s], dim=-1)
        off = torch.where(ok[:, None], torch.clamp(new, -1.0, 1.0), off)
    return off


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
    # gradient-based subpixel corner refinement (refine_corners_flat); off
    # by default, as in the JAX package
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
    Returns (xy, score, valid, raw_flat, blur_flat); with cfg.subpixel, xy
    carries refine_corners_flat's offsets (the patches stay gathered at the
    integer corner)."""
    resp = fast_mod.detect(
        img, cfg.ini_th_fast, cfg.min_th_fast, cell=cfg.cell, border=cfg.border
    )
    xy, score, valid = select_mod.select_keypoints(resp, n_max, cell=cfg.cell)
    xy_int = xy.to(torch.int64)
    blurred = pyr_mod.gaussian_blur(img)
    both = gather_patches_flat_multi(torch.stack([img, blurred]), xy_int)
    if cfg.subpixel:
        xy = xy + refine_corners_flat(both[0])
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


def _wrap_padded(lv, H0: int, W0: int, r: int = 3):
    """Level `lv` [h, w] in the corner of an [H0, W0] frame whose rows and
    columns just past the level (r of them) and the frame's last r rows and
    columns hold the level's circular continuation: torch.roll over the
    frame then reads, for every pixel of the level, the neighbours a roll
    over the level alone reads (fast._shifted's wrap-around)."""
    h, w = lv.shape
    t = F.pad(lv[None, None], (r, r, r, r), mode="circular")[0, 0]   # [h + 2r, w + 2r]
    out = torch.zeros((H0, W0), dtype=lv.dtype, device=lv.device)
    out[:h + r, :w + r] = t[r:, r:]
    out[H0 - r:, :w + r] = t[:r, r:]
    out[:h + r, W0 - r:] = t[r:, :r]
    out[H0 - r:, W0 - r:] = t[:r, :r]
    return out


def _reflect_padded(lv, H0: int, W0: int, r: int = 3):
    """Level `lv` [h, w] in the corner of an [H0, W0] frame, continued by r
    reflect-101 rows and columns (the blur's own border) and edge values
    beyond."""
    h, w = lv.shape
    t = F.pad(lv[None, None], (0, r, 0, r), mode="reflect")
    return F.pad(t, (0, W0 - w - r, 0, H0 - h - r), mode="replicate")[0, 0]


def extract_batched(img, cfg: OrbConfig = OrbConfig()):
    """All pyramid levels at once (port of the JAX package's experimental
    `extract_batched`, `frontend/orb.py:393`): every level is placed in a
    frame of the level-0 shape and stacked, so FAST, the cell fallback,
    non-max suppression, selection, the blur, the patch gather, orientation
    and BRIEF each run once over [n_levels, H, W] (or every level's
    keypoints), instead of once per level. The output contract is
    `extract`'s: static size sum(features_per_level), level-0
    coordinates.

    Where the JAX function edge-pads each level, this one pads it so that
    the batched passes see what the per-level passes see: a circular
    continuation for FAST (its wrap-around near the border), the fallback's
    cells cut to the level's extent, and a reflect-101 continuation under
    the blur. Every valid keypoint then equals `extract`'s (position,
    octave, angle, descriptor); invalid rows hold other placeholders."""
    img = img.to(torch.float32)
    dev = img.device
    Lv = cfg.n_levels
    H0, W0 = img.shape
    levels = pyr_mod.build_pyramid(img, Lv, cfg.scale_factor)
    shapes = [tuple(lv.shape) for lv in levels]
    budgets = cfg.features_per_level()
    n_per = max(budgets)
    raw = torch.stack([levels[0]] + [_wrap_padded(lv, H0, W0) for lv in levels[1:]])
    hs = torch.tensor([h for h, _ in shapes], device=dev)[:, None, None]
    ws = torch.tensor([w for _, w in shapes], device=dev)[:, None, None]
    ys = torch.arange(H0, device=dev)[None, :, None]
    xs = torch.arange(W0, device=dev)[None, None, :]

    # FAST, with the per-cell high-threshold fallback on each level's extent
    s = fast_mod.fast_score(raw)
    zero = torch.zeros_like(s)
    r_hi = torch.where(s > cfg.ini_th_fast, s, zero)
    r_lo = torch.where(s > cfg.min_th_fast, s, zero)
    cell = cfg.cell
    ph, pw = (-H0) % cell, (-W0) % cell
    inside = (ys < hs) & (xs < ws)
    rh = F.pad(torch.where(inside, r_hi, zero), (0, pw, 0, ph))
    ncy, ncx = (H0 + ph) // cell, (W0 + pw) // cell
    has_hi = rh.reshape(Lv, ncy, cell, ncx, cell).amax(dim=(2, 4)) > 0.0
    use_lo = (~has_hi).repeat_interleave(cell, 1).repeat_interleave(cell, 2)[:, :H0, :W0]
    resp = fast_mod.nonmax_3x3(torch.where(use_lo, r_lo, r_hi))
    b = cfg.border
    in_border = (ys >= b) & (ys < hs - b) & (xs >= b) & (xs < ws - b)
    resp = torch.where(in_border, resp, zero)

    # selection to the largest budget, cut to each level's budget below
    xy, score, valid = select_mod.select_keypoints(resp, n_per, cell=cfg.cell)
    n_sel = xy.shape[1]
    lvl = torch.arange(Lv, device=dev)[:, None].expand(Lv, n_sel)

    # one gather of every keypoint's raw and blurred patch
    blur = pyr_mod.gaussian_blur(torch.stack(
        [levels[0]] + [_reflect_padded(lv, H0, W0) for lv in levels[1:]]))
    both = F.pad(torch.stack([raw, blur]), (PR, PR, PR, PR), mode="replicate")
    xi = torch.minimum(torch.clamp(xy[..., 0].to(torch.int64), min=0), ws[:, :, 0] - 1)
    yi = torch.minimum(torch.clamp(xy[..., 1].to(torch.int64), min=0), hs[:, :, 0] - 1)
    di = torch.arange(PATCH, device=dev)
    rows = (yi.reshape(-1)[:, None] + di[None, :])[:, :, None]
    cols = (xi.reshape(-1)[:, None] + di[None, :])[:, None, :]
    patches = both[:, lvl.reshape(-1)[:, None, None], rows, cols].reshape(2, -1, PATCH * PATCH)
    if cfg.subpixel:
        xy = xy + refine_corners_flat(patches[0]).reshape(Lv, n_sel, 2)
    angles = ic_angle_flat(patches[0])
    desc = brief_descriptors_flat(patches[1], angles)

    scales = torch.tensor([cfg.scale_factor ** l for l in range(Lv)], dtype=torch.float32,
                          device=dev)
    keep = torch.tensor(np.concatenate([np.arange(l * n_sel, l * n_sel + min(budgets[l], n_sel))
                                        for l in range(Lv)]), dtype=torch.long, device=dev)
    return Features(
        xy=(xy * scales[:, None, None]).reshape(-1, 2)[keep],
        response=score.reshape(-1)[keep],
        angle=angles[keep],
        octave=lvl.reshape(-1).to(torch.int32)[keep],
        descriptors=desc[keep],
        valid=valid.reshape(-1)[keep],
    )
