"""Global bundle adjustment of a MapState over a process group (port of
orb_slam3_tpu/parallel/map_ba.py).

The multi-process path of `Optimizer::GlobalBundleAdjustemnt`
(`Optimizer.cc:52`) / `LoopClosing::RunGlobalBundleAdjustment`
(`LoopClosing.cc:2268`): every rank flattens the active map's observation
graph (`mapping/global_ba.extract_global_problem`), the landmark axis is
sharded over the group (`dist_ba.shard_ba_problem`), the sharded Schur LM
runs (`dist_ba.dist_ba_solve`), and the gathered poses and landmarks are
written back on every rank. The camera list is padded to a multiple of
`cam_bucket` with fixed copies of the first camera and the per-shard edges
to a multiple of `edge_bucket` (the JAX package's buckets, which keep a
growing map on one compiled shape). At a world of one with both buckets 1
this is `global_ba` to the bit.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from .. import device as device_mod
from ..atlas.state import MapState, to_device
from ..lm import edges as lm_edges
from ..mapping import global_ba as gba
from . import dist_ba


def solve_map(s: MapState, K8, reduce, kind: int = 0, n_fixed: int = 2, num_iters: int = 10,
              huber_delta: float | None = 5.991 ** 0.5, cam_bucket: int = 8,
              edge_bucket: int = 1024):
    """The sharded global BA of the active map under `reduce` (n_dev its
    size, this rank's shard its rank). Returns (state, costs)."""
    kf_rows, cam_idx, lm_idx, uv, info = gba.extract_global_problem(s)
    if len(kf_rows) < 3 or len(cam_idx) == 0:
        return s, []
    sharded = dist_ba.shard_ba_problem(
        reduce.size, s.lm_pos.cpu().numpy(), ~s.lm_valid.cpu().numpy(), cam_idx, lm_idx, uv,
        info, np.ones(len(cam_idx), bool), edge_bucket=edge_bucket)
    n_real = len(kf_rows)
    n_pad = -(-n_real // cam_bucket) * cam_bucket - n_real
    rows_p = np.concatenate([kf_rows, np.full(n_pad, kf_rows[0])])
    pos = np.arange(len(rows_p))
    fixed = (pos < n_fixed) | (pos >= n_real)
    rows_t = torch.as_tensor(rows_p, dtype=torch.long, device=s.device)
    cam_state = {"R": s.kf_R[rows_t], "t": s.kf_t[rows_t]}
    cams, pts, costs = dist_ba.dist_ba_solve(
        gba._ba_residual(kind), lm_edges.se3_retract, cam_state, fixed, K8, *sharded,
        num_iters=num_iters, huber_delta=huber_delta, reduce=reduce, device=s.device)
    return gba.write_back(s, kf_rows, cams, pts.reshape(-1, 3)[:s.lmax]), costs


def distributed_global_ba(s: MapState, K8, group=None, kind: int = 0, n_fixed: int = 2,
                          num_iters: int = 10, huber_delta: float | None = 5.991 ** 0.5,
                          cam_bucket: int = 8, edge_bucket: int = 1024, device=None):
    """Global BA of the active map with its landmarks sharded over `group`
    (default: the default group, which must be initialised,
    `multihost.init_distributed`), on `device` (default CUDA; the map is
    moved there). Every rank passes the same map and gets the same result."""
    dev = device_mod.resolve(device)
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("distributed_global_ba needs an initialised process group "
                           "(multihost.init_distributed)")
    s = to_device(s, dev)
    out, _ = solve_map(s, K8, dist_ba.GroupReduce(group), kind, n_fixed, num_iters,
                       huber_delta, cam_bucket, edge_bucket)
    return out

