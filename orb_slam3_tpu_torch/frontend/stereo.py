"""Stereo matching and RGB-D depth binding (port of
orb_slam3_tpu/frontend/stereo.py).

`Frame::ComputeStereoMatches` (`Frame.cc:811-981`) and
`Frame::ComputeStereoFromRGBD` (`:984-1006`) as dense masked ops: one
[Nl, Nr] Hamming matrix gated by the row band, the octave gate and the
disparity range, the best match per left keypoint, an octave-strided SAD
sweep on gathered strips refined by a parabola, then the median-distance
rejection. The JAX package computes both on XLA, outside any Pallas kernel;
here they are plain torch ops on any device. `match_stereo_fisheye`
matches a non-rectified (KB8 fisheye) pair by descriptor alone and
triangulates each match (`Frame::ComputeStereoFishEyeMatches`,
`KannalaBrandt8::TriangulateMatches`), in plain torch ops as well.
"""

from __future__ import annotations

import torch

from . import camera as cam
from . import matching, two_view

SAD_W = 5    # half window (11x11 patch, Frame.cc:906-949 uses w = 5)
SAD_L = 5    # disparity search half-range of the subpixel refinement


def _f32(value, device):
    return torch.full((), float(value), dtype=torch.float32, device=device)


def _sample(img, y, x):
    """Nearest pixel at (y, x), clamped to the image; torch.round rounds
    half to even, as jnp.round does."""
    h, w = img.shape
    xi = torch.clamp(torch.round(x).to(torch.int32), 0, w - 1).long()
    yi = torch.clamp(torch.round(y).to(torch.int32), 0, h - 1).long()
    return img[yi, xi]


def _nanmedian(values, ok):
    """jnp.nanmedian of `values` where `ok`, NaN where none is: the mean of
    the two middle values for an even count (torch.nanmedian returns the
    lower one). On the device, no host read."""
    n = ok.sum()
    srt = torch.sort(torch.where(ok, values, torch.inf)).values
    last = values.shape[0] - 1
    lo = srt[torch.clamp((n - 1) // 2, 0, last)]
    hi = srt[torch.clamp(n // 2, 0, last)]
    return torch.where(n > 0, 0.5 * lo + 0.5 * hi, torch.nan)


def match_rows(xy_l, oct_l, desc_l, valid_l, xy_r, oct_r, desc_r, valid_r,
               scale_factors, bf, min_z, max_desc_dist: float = 75.0):
    """The descriptor stage of match_stereo: for each left keypoint the
    nearest right descriptor (first on ties) among the right keypoints on
    its row band, within one octave and inside the disparity range
    (0.1, bf / min_z]. Returns (idx [Nl] int64, dist [Nl] int32, ok [Nl],
    max_d 0-dim f32)."""
    dev = xy_l.device
    n_levels = scale_factors.shape[0]
    # row band: |v_l - v_r| <= 2 * the left octave's scale; octave gate: the
    # right keypoint within one level (Frame.cc:836-838)
    sf_l = scale_factors[torch.clamp(oct_l, 0, n_levels - 1).long()]
    m = (xy_l[:, None, 1] - xy_r[None, :, 1]).abs() <= (2.0 * sf_l)[:, None]
    m = m & ((oct_l[:, None] - oct_r[None, :]).abs() <= 1)
    # disparity range 0.1 < uL - uR <= maxD, in f32 as the JAX program has it
    disp = xy_l[:, None, 0] - xy_r[None, :, 0]
    max_d = _f32(bf, dev) / torch.clamp(_f32(min_z, dev), min=1e-6)
    m = m & (disp > 0.1) & (disp <= max_d)
    m = m & valid_l[:, None] & valid_r[None, :]
    idx, best, ok = matching.masked_best_match(
        matching.hamming_matrix(desc_l, desc_r), m, max_dist=max_desc_dist)
    return idx, best, ok, max_d


def match_stereo(xy_l, oct_l, desc_l, valid_l, xy_r, oct_r, desc_r, valid_r,
                 img_l, img_r, scale_factors, bf, min_z, max_desc_dist: float = 75.0):
    """Match left keypoints to right keypoints of a rectified pair.
    min_z is the least depth (the disparity range is (0.1, bf / min_z]).
    Returns (ur [Nl], depth [Nl], ok [Nl]); ur = -1 and depth = 0 where
    unmatched."""
    dev = xy_l.device
    n_levels = scale_factors.shape[0]
    idx, best, ok, max_d = match_rows(xy_l, oct_l, desc_l, valid_l, xy_r, oct_r, desc_r,
                                      valid_r, scale_factors, bf, min_z, max_desc_dist)
    sf_l = scale_factors[torch.clamp(oct_l, 0, n_levels - 1).long()]

    # subpixel refinement: an 11x11 SAD window slid over 11 disparities at
    # the left keypoint's octave stride; all windows share one [11, 21]
    # strip of the right image (nearest sampling, as the JAX program)
    ul, v = xy_l[:, 0], xy_l[:, 1]
    ur0 = xy_r[idx, 0]
    st = sf_l[:, None]
    offs = torch.arange(-SAD_W, SAD_W + 1, dtype=torch.float32, device=dev)
    strip_offs = torch.arange(-(SAD_W + SAD_L), SAD_W + SAD_L + 1, dtype=torch.float32,
                              device=dev)
    ys = (v[:, None] + offs[None, :] * st)[:, :, None]             # [N, 11, 1]
    xs_l = (ul[:, None] + offs[None, :] * st)[:, None, :]          # [N, 1, 11]
    xs_r = (ur0[:, None] + strip_offs[None, :] * st)[:, None, :]   # [N, 1, 21]
    patch_l = _sample(img_l, ys.expand(-1, -1, xs_l.shape[2]), xs_l.expand(-1, ys.shape[1], -1))
    strip_r = _sample(img_r, ys.expand(-1, -1, xs_r.shape[2]), xs_r.expand(-1, ys.shape[1], -1))
    windows = strip_r.unfold(2, 2 * SAD_W + 1, 1).permute(0, 2, 1, 3)  # [N, 11 disp, 11, 11]
    sads = (patch_l[:, None] - windows).abs().sum(dim=(2, 3))       # [N, 11]
    k_c = torch.clamp(torch.argmin(sads, dim=1), 1, 2 * SAD_L - 1)
    s1, s2, s3 = (torch.gather(sads, 1, (k_c + o)[:, None])[:, 0] for o in (-1, 0, 1))
    denom = torch.clamp(s1 + s3 - 2.0 * s2, min=1e-6)
    delta = torch.clamp(0.5 * (s1 - s3) / denom, -1.0, 1.0)
    ur = ur0 + ((k_c.to(torch.float32) - SAD_L) + delta) * sf_l
    disparity = ul - ur
    ok = ok & (disparity > 0.1) & (disparity <= max_d)

    # median-distance rejection (Frame.cc:967-980): drop the matches whose
    # descriptor distance exceeds 1.5 * 1.4 * the median of the accepted ones
    best_f = best.to(torch.float32)
    med = _nanmedian(best_f, ok)
    ok = ok & (best_f <= 1.5 * 1.4 * torch.where(torch.isnan(med), 1e9, med))

    depth = torch.where(ok, _f32(bf, dev) / torch.clamp(disparity, min=1e-6), 0.0)
    return torch.where(ok, ur, -1.0), depth, ok


def depth_from_rgbd(xy, depth_map, bf, depth_factor: float = 1.0,
                    max_rel_spread: float = 0.05):
    """Sample the depth map at the keypoints (coordinates truncated, as the
    JAX int32 cast does) and make the virtual right coordinate
    ur = u - bf / z. A keypoint whose 3x3 neighbourhood spreads by more than
    max_rel_spread of its depth (an occlusion boundary) or touches a hole
    gets none. Returns (ur [N], depth [N], ok [N])."""
    h, w = depth_map.shape
    xi = torch.clamp(xy[:, 0].to(torch.int32), 0, w - 1).long()
    yi = torch.clamp(xy[:, 1].to(torch.int32), 0, h - 1).long()
    z = depth_map[yi, xi] * depth_factor
    pad = torch.nn.functional.pad(depth_map[None, None], (1, 1, 1, 1),
                                  mode="replicate")[0, 0] * depth_factor
    neigh = torch.stack([pad[yi + dy, xi + dx] for dy in (0, 1, 2) for dx in (0, 1, 2)], dim=-1)
    zmin = neigh.amin(dim=-1)
    zmax = neigh.amax(dim=-1)
    flat = (zmax - zmin) <= max_rel_spread * torch.clamp(z, min=1e-6)
    ok = (z > 0) & flat & (zmin > 0)
    ur = torch.where(ok, xy[:, 0] - _f32(bf, xy.device) / torch.clamp(z, min=1e-6), -1.0)
    return ur, torch.where(ok, z, 0.0), ok


def match_stereo_fisheye(kind: int, K_l, K_r, R_rl, t_rl, xy_l, desc_l, valid_l,
                         xy_r, desc_r, valid_r, ratio: float = 0.7,
                         max_cos_parallax: float = 0.9998, max_reproj_px: float = 3.0):
    """Non-rectified stereo: brute-force descriptor matching (ratio 0.7, the
    lower index first on ties, then the cross-check; BFMatcher knn in
    `Frame.cc:1126-1164`), then for each match the DLT triangulation of the
    two unprojected rays against [I|0] and [R_rl|t_rl] (X_r = R_rl X_l +
    t_rl), kept where the rays' parallax cosine is under 0.9998, the point
    lies more than 0.05 in front of both cameras and it reprojects within
    3 px in both images (`KannalaBrandt8::TriangulateMatches`).

    Returns (depth [Nl], the z of the point in the left camera, 0 where
    there is none; good [Nl])."""
    idx, _, ok = matching.search_by_brute_force(desc_l, valid_l, desc_r, valid_r,
                                                ratio=ratio, max_dist=matching.TH_LOW)
    uv_r = xy_r[idx]
    ray_l = cam.unproject(kind, K_l, xy_l)
    ray_r = cam.unproject(kind, K_r, uv_r)   # in the right camera's frame
    p0 = ray_l[:, :2] / torch.clamp(ray_l[:, 2:3], min=1e-9)
    p1 = ray_r[:, :2] / torch.clamp(ray_r[:, 2:3], min=1e-9)
    dev = xy_l.device
    P0 = torch.cat([torch.eye(3, device=dev), torch.zeros((3, 1), device=dev)], dim=1)
    P1 = torch.cat([R_rl, t_rl[:, None]], dim=1)
    X_l = two_view.triangulate(P0, P1, p0, p1)

    # parallax of the two rays, both in the left camera's frame
    ray_r_l = ray_r @ R_rl
    cosp = torch.sum(ray_l * ray_r_l, dim=-1) / torch.clamp(
        torch.linalg.norm(ray_l, dim=-1) * torch.linalg.norm(ray_r_l, dim=-1), min=1e-9)
    X_r = X_l @ R_rl.T + t_rl
    err_l = torch.linalg.norm(cam.project(kind, K_l, X_l) - xy_l, dim=-1)
    err_r = torch.linalg.norm(cam.project(kind, K_r, X_r) - uv_r, dim=-1)
    good = (ok & (cosp < max_cos_parallax) & (X_l[:, 2] > 0.05) & (X_r[:, 2] > 0.05)
            & (err_l < max_reproj_px) & (err_r < max_reproj_px))
    return torch.where(good, X_l[:, 2], 0.0), good
