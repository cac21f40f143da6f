"""Fleet tracking: a batch of independent sessions' tracking steps (port of
orb_slam3_tpu/parallel/fleet.py).

Serving many cameras (robots, dataset segments) at once scales over
SESSIONS: each runs the per-frame hot path of `Tracking.cc:1794-2332`
(ORB extraction, local-map projection matching through K1, motion-only
pose BA through K2) on its own frame and local map. The B sessions are
split over the ranks of a process group (a world of one runs all B on its
card). Per rank, each local session extracts and matches in turn, and
then K2 runs ONCE over the rank's sessions through its batch dimension (one
thread-block cluster per session), not once per session; every rank ends
with the whole batch's results (an all_gather).

    step = make_fleet_step(cfg_orb, K, img_wh=(752, 480))
    R, t, n = step(imgs [B,H,W], lm_pos [B,L,3], lm_desc [B,L,32] u8,
                   lm_valid [B,L], lm_max_dist [B,L], lm_min_dist [B,L],
                   lm_normal [B,L,3], R0 [B,3,3], t0 [B,3])

`_track_one` is one session's step, the JAX `_track_one`; each session's
(R, t, n) of the fleet step equals it.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from .. import device as device_mod
from ..frontend import camera as cam
from ..frontend import orb
from ..tracking import pose_kernel, track


def _match_one(img, lm_pos, lm_desc, lm_valid, lm_maxd, lm_mind, lm_normal, R0, t0, *,
               cfg_orb, kind, K, img_wh, scale_factors, match_radius):
    """Extraction and the local-map match of one session: the inputs of its
    pose BA, (uv [L,2], inv_sigma2 [L], ok [L])."""
    feats = orb.extract(img, cfg_orb)
    idx, ok, _visible, _, _d = track.match_local_map(
        kind, K, R0, t0, lm_pos, lm_desc, lm_valid, lm_maxd, lm_mind, lm_normal,
        feats.xy, feats.descriptors, feats.octave, feats.valid,
        match_radius, scale_factors, img_wh=img_wh)
    idx = idx.long()
    oct_m = torch.clamp(feats.octave[idx], 0, cfg_orb.n_levels - 1).long()
    inv_sig2 = 1.0 / (scale_factors[oct_m] ** 2)
    return feats.xy[idx].contiguous(), inv_sig2, ok


def _track_one(img, lm_pos, lm_desc, lm_valid, lm_maxd, lm_mind, lm_normal, R0, t0, *,
               cfg_orb, kind, K, img_wh, scale_factors, match_radius):
    """One session's tracking step: (R, t, n_inliers)."""
    uv, inv_sig2, ok = _match_one(
        img, lm_pos, lm_desc, lm_valid, lm_maxd, lm_mind, lm_normal, R0, t0,
        cfg_orb=cfg_orb, kind=kind, K=K, img_wh=img_wh, scale_factors=scale_factors,
        match_radius=match_radius)
    R, t, _inl, n = track.pose_optimize(kind, K, R0, t0, uv, lm_pos, inv_sig2, ok)
    return R, t, n


def make_fleet_step(cfg_orb, K, kind=cam.PINHOLE, img_wh=(752.0, 480.0),
                    match_radius: float = 15.0, group=None, device=None):
    """The fleet step on `device` (default CUDA; K is moved there) over
    `group` (default: the default group when one is initialised, else a
    world of one). The batch must be a multiple of the group's size; rank
    r tracks sessions [r * B / world, (r + 1) * B / world)."""
    dev = device_mod.resolve(device)
    K = torch.as_tensor(K, dtype=torch.float32).to(dev)
    scale_factors = cfg_orb.scale_factors(dev)
    img_wh = (float(img_wh[0]), float(img_wh[1]))
    if group is None and dist.is_available() and dist.is_initialized():
        world, rank = dist.get_world_size(), dist.get_rank()
    elif group is not None:
        world, rank = dist.get_world_size(group), dist.get_rank(group)
    else:
        world, rank = 1, 0
    kw = dict(cfg_orb=cfg_orb, kind=kind, K=K, img_wh=img_wh, scale_factors=scale_factors,
              match_radius=match_radius)

    def step(imgs, lm_pos, lm_desc, lm_valid, lm_maxd, lm_mind, lm_normal, R0, t0):
        args = [torch.as_tensor(a).to(dev) for a in
                (imgs, lm_pos, lm_desc, lm_valid, lm_maxd, lm_mind, lm_normal, R0, t0)]
        B = args[0].shape[0]
        if B % world:
            raise ValueError(f"a batch of {B} sessions over {world} ranks")
        b = B // world
        local = [a[rank * b:(rank + 1) * b] for a in args]
        if kind == cam.PINHOLE:
            m = [_match_one(*(a[i] for a in local), **kw) for i in range(b)]
            uv, inv_sig2, ok = (torch.stack(x) for x in zip(*m))
            R, t, _inl, n = pose_kernel.pose_ba(
                K[None, :4].expand(b, 4).contiguous(), local[7].contiguous(),
                local[8].contiguous(), uv, local[1].contiguous(), inv_sig2, ok)
        else:  # KB8: the plain pose BA, per session (track.pose_optimize)
            R, t, n = (torch.stack(x) for x in zip(
                *[_track_one(*(a[i] for a in local), **kw) for i in range(b)]))
        if world == 1:
            return R, t, n
        out = []
        for x in (R, t, n.to(torch.int32)):
            parts = [torch.empty_like(x) for _ in range(world)]
            dist.all_gather(parts, x.contiguous(), group=group)
            out.append(torch.cat(parts))
        return tuple(out)

    return step
