"""Bundle adjustment with the landmark axis sharded over a process group
(port of orb_slam3_tpu/parallel/dist_ba.py).

SURVEY.md §2.4's layout: each rank holds a block of landmarks and every
edge that observes one of them, eliminates ITS landmark blocks and sums
the reduced camera system over the group; the camera states are
replicated (K * 6 floats). The linear algebra is `lm/schur._schur_solve`
with a group `reduce` (`GroupReduce`: one all_reduce of the packed
[KC, KC] + [KC] system and the cost per iteration, a MAX for the damping
floor), and the loop is `lm/schur.solve_halving`, the one the single-card
global BA runs: at a world of one the two give the same bits.

Layout (host numpy, `shard_ba_problem`, equal to the JAX package's):
- landmarks [n_dev, Lp, 3]: shard d owns rows [d * Lp, (d + 1) * Lp);
- edges [n_dev, Ep, ...]: each edge on its landmark's shard, in the
  original order, its landmark index local to the shard; padding edges
  carry mask False.

On the card the collectives run on NCCL's stream; `torch.distributed`
orders them after the caller's current stream (the solver's) and the
caller's stream after them, through events, so a solve on a side stream
(the background global BA's) stays ordered.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..lm import schur
from ..lm.problem import VertexBlock


def shard_ba_problem(n_dev: int, points, point_fixed, cam_idx, lm_idx,
                     obs_uv, obs_info, obs_mask, edge_bucket: int = 1):
    """Block-partition the landmarks over n_dev shards and route each
    (unmasked) edge to its landmark's shard. Returns numpy (points_s
    [n_dev, Lp, 3], pfix_s [n_dev, Lp], cam_s, lml_s, uv_s, info_s,
    mask_s [n_dev, Ep, ...]); Ep is rounded up to a multiple of
    edge_bucket."""
    points = np.asarray(points, np.float32)
    point_fixed = np.asarray(point_fixed, bool)
    cam_idx, lm_idx = np.asarray(cam_idx), np.asarray(lm_idx)
    obs_mask = np.asarray(obs_mask, bool)
    L = points.shape[0]
    Lp = -(-L // n_dev)
    points_s = np.zeros((n_dev * Lp, 3), np.float32)
    pfix_s = np.ones(n_dev * Lp, bool)
    points_s[:L], pfix_s[:L] = points, point_fixed

    owner = np.clip(lm_idx // Lp, 0, n_dev - 1)
    counts = np.bincount(owner[obs_mask], minlength=n_dev)
    Ep = max(int(counts.max()), 1)
    Ep = -(-Ep // edge_bucket) * edge_bucket
    e = np.flatnonzero(obs_mask)
    d = owner[e]
    order = np.argsort(d, kind="stable")
    e, d = e[order], d[order]
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    j = np.arange(len(e)) - starts[d]
    cam_s = np.zeros((n_dev, Ep), np.int32)
    lml_s = np.zeros((n_dev, Ep), np.int32)
    uv_s = np.zeros((n_dev, Ep, 2), np.float32)
    info_s = np.zeros((n_dev, Ep), np.float32)
    mask_s = np.zeros((n_dev, Ep), bool)
    cam_s[d, j] = cam_idx[e]
    lml_s[d, j] = lm_idx[e] - d * Lp
    uv_s[d, j] = np.asarray(obs_uv)[e]
    info_s[d, j] = np.asarray(obs_info)[e]
    mask_s[d, j] = True
    return (points_s.reshape(n_dev, Lp, 3), pfix_s.reshape(n_dev, Lp),
            cam_s, lml_s, uv_s, info_s, mask_s)


class GroupReduce:
    """`lm/schur`'s reductions over a torch.distributed group: the sums
    packed into one all_reduce, the maximum as one MAX all_reduce."""

    def __init__(self, group=None):
        self.group = group
        self.size = dist.get_world_size(group)
        self.rank = dist.get_rank(group)

    def _all_reduce(self, t, op):
        """`t` reduced in place over the group; returns it."""
        dist.all_reduce(t, op=op, group=self.group)
        return t

    def sum(self, tensors):
        flat = self._all_reduce(torch.cat([t.reshape(-1) for t in tensors]), dist.ReduceOp.SUM)
        out, i = [], 0
        for t in tensors:
            out.append(flat[i:i + t.numel()].reshape(t.shape))
            i += t.numel()
        return out

    def max(self, t):
        return self._all_reduce(t.clone(), dist.ReduceOp.MAX)


def all_gather_rows(t: torch.Tensor, reduce) -> torch.Tensor:
    """[n_dev, ...] from every rank's [...], in shard order (a world of one:
    t[None])."""
    if reduce.size == 1:
        return t[None]
    out = [torch.empty_like(t) for _ in range(reduce.size)]
    dist.all_gather(out, t.contiguous(), group=reduce.group)
    return torch.stack(out)


def dist_ba_solve(residual, cam_retract, cam_state, cam_fixed, K8,
                  points_s, pfix_s, cam_s, lml_s, uv_s, info_s, mask_s,
                  num_iters: int = 10, lam0: float = 1e-5, C: int = 6,
                  huber_delta: float | None = None, reduce=None, device=None):
    """The LM loop over the group's shards. The sharded arrays are the
    [n_dev, ...] layout of `shard_ba_problem` (every rank passes all of it
    and solves row `rank`), n_dev the group's size; cam_state a dict of
    [Kc, ...] tensors, replicated. `reduce` defaults to the default group
    (`GroupReduce()`), or the world of one when no group is initialised.
    Returns (cam_state, points_s [n_dev, Lp, 3] gathered from every rank,
    the cost at each linearization point [floats])."""
    if reduce is None:
        reduce = GroupReduce() if dist.is_available() and dist.is_initialized() else schur.LOCAL
    n_dev = points_s.shape[0]
    if n_dev != reduce.size:
        raise ValueError(f"{n_dev} shards for a group of {reduce.size}")
    r = reduce.rank
    dev = torch.device(device) if device is not None else next(iter(cam_state.values())).device
    f = lambda a, dt=torch.float32: torch.as_tensor(np.asarray(a)[r], dtype=dt, device=dev)  # noqa: E731
    E = np.asarray(cam_s).shape[1]
    p = schur.BAProblem(
        cams=VertexBlock(state={k: v.to(dev) for k, v in cam_state.items()},
                         fixed=torch.as_tensor(cam_fixed, dtype=torch.bool, device=dev),
                         tangent_dim=C, retract=cam_retract),
        points=f(points_s), point_fixed=f(pfix_s, torch.bool),
        cam_idx=f(cam_s, torch.int32), lm_idx=f(lml_s, torch.int32),
        obs_data={"uv": f(uv_s),
                  "K": torch.as_tensor(K8, dtype=torch.float32, device=dev).expand(E, 8)},
        obs_info=f(info_s), obs_mask=f(mask_s, torch.bool), cam_edges=(), residual_dim=2,
        residual=residual, huber_delta=huber_delta)
    p, costs = schur.solve_halving(p, num_iters, lam0, reduce)
    return (p.cams.state, all_gather_rows(p.points, reduce),
            torch.stack(costs).tolist() if costs else [])
