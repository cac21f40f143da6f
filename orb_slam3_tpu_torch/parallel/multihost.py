"""Multi-host layer: process groups, the two-level reduction and the
cross-host Atlas (port of orb_slam3_tpu/parallel/multihost.py).

- `init_distributed`: `torch.distributed.init_process_group` over a TCP
  store at the coordinator (NCCL between cards, gloo for CPU processes);
  nothing happens when a group is already initialised.
- `two_level_mesh(n_hosts, devs_per_host)`: the ranks host-major (rank =
  host * devs_per_host + dev), one subgroup per host and one group of the
  host leaders (each host's first rank). `TwoLevelReduce` sums within the
  host first, then across the leaders, then broadcasts within the host:
  the JAX package's ICI-before-DCN order, so only one [KC, KC] + [KC]
  system per host crosses hosts per iteration.
- `dist_gba_two_level`: the global BA of `map_ba` with the landmarks
  sharded over every rank and that reduction.
- `HostedAtlas`: an Atlas partitioned across hosts by map id; `ship_map`
  appends one map's keyframes and landmarks to another host's arena
  (growing it) through the standard add operations, and the receiving
  session takes the combined arena with `Tracker.adopt_map`. As in the JAX
  package, the bookkeeping and the merge run in one process here.
"""

from __future__ import annotations

import dataclasses
import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

from .. import device as device_mod
from ..atlas import ops as atlas_ops
from ..atlas.state import MapState, to_device, update_landmark_stats
from . import dist_ba, map_ba


def init_distributed(coordinator: str | None = None, num_processes: int | None = None,
                     process_id: int | None = None, device=None, timeout_s: float = 300.0):
    """Join the process group of a multi-process launch: `coordinator`
    "host:port" (default MASTER_ADDR:MASTER_PORT), `num_processes`
    (WORLD_SIZE), `process_id` (RANK). The backend follows `device`
    (default CUDA: NCCL, with this rank's card current; "cpu": gloo). A no-op
    when a group is already initialised."""
    if dist.is_initialized():
        return
    dev = device_mod.resolve(device)
    env = os.environ
    if coordinator is None:
        coordinator = f"{env.get('MASTER_ADDR', '127.0.0.1')}:{env['MASTER_PORT']}"
    world = int(num_processes if num_processes is not None else env.get("WORLD_SIZE", 1))
    rank = int(process_id if process_id is not None else env.get("RANK", 0))
    if dev.type == "cuda":
        torch.cuda.set_device(dev.index if dev.index is not None
                              else rank % torch.cuda.device_count())
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=f"tcp://{coordinator}", world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))


@dataclasses.dataclass
class TwoLevelMesh:
    """A (host, dev) arrangement of the default group's ranks."""

    n_hosts: int
    devs_per_host: int
    host_group: object      # this rank's host
    leader_group: object    # the hosts' first ranks (None off the leaders)
    host_leader: int        # the global rank of this host's leader

    @property
    def size(self) -> int:
        return self.n_hosts * self.devs_per_host


def two_level_mesh(n_hosts: int, devs_per_host: int) -> TwoLevelMesh:
    """The groups of a (host, dev) layout over the default group, whose
    size must be n_hosts * devs_per_host. Every rank must call this (group
    creation is collective)."""
    world, rank = dist.get_world_size(), dist.get_rank()
    if world != n_hosts * devs_per_host:
        raise ValueError(f"{n_hosts} x {devs_per_host} ranks, but the world has {world}")
    host_group = None
    for h in range(n_hosts):
        g = dist.new_group(list(range(h * devs_per_host, (h + 1) * devs_per_host)))
        if rank // devs_per_host == h:
            host_group = g
    leaders = dist.new_group([h * devs_per_host for h in range(n_hosts)])
    me = rank // devs_per_host
    return TwoLevelMesh(n_hosts, devs_per_host, host_group,
                        leaders if rank % devs_per_host == 0 else None, me * devs_per_host)


class TwoLevelReduce(dist_ba.GroupReduce):
    """`lm/schur`'s reductions staged within the host, across the host
    leaders, then broadcast within the host; the shards follow the global
    rank."""

    def __init__(self, mesh: TwoLevelMesh):
        super().__init__(None)
        self.mesh = mesh

    def _all_reduce(self, t, op):
        m = self.mesh
        dist.all_reduce(t, op=op, group=m.host_group)
        if m.leader_group is not None:
            dist.all_reduce(t, op=op, group=m.leader_group)
        dist.broadcast(t, src=m.host_leader, group=m.host_group)
        return t


def dist_gba_two_level(s: MapState, K8, mesh: TwoLevelMesh, kind: int = 0, n_fixed: int = 2,
                       num_iters: int = 10, huber_delta: float | None = 5.991 ** 0.5,
                       cam_bucket: int = 8, edge_bucket: int = 1024, device=None):
    """`map_ba.distributed_global_ba` with the landmark shards over host x
    dev and the two-level reduction. Returns (state, costs); a map too
    small to solve comes back unchanged with no cost."""
    dev = device_mod.resolve(device)
    return map_ba.solve_map(to_device(s, dev), K8, TwoLevelReduce(mesh), kind, n_fixed,
                            num_iters, huber_delta, cam_bucket, edge_bucket)


def _np(a):
    return a.detach().cpu().numpy()


@dataclasses.dataclass
class HostedAtlas:
    """An Atlas partitioned across hosts by map id: `host_maps[h]` is the
    MapState resident on host h, `host_of_map` the owner of each map id."""

    host_maps: list
    host_of_map: dict

    @staticmethod
    def create(n_hosts: int, states):
        hm = list(states)
        if len(hm) != n_hosts:
            raise ValueError(f"{len(hm)} states for {n_hosts} hosts")
        host_of = {}
        for h, st in enumerate(hm):
            for mid in np.unique(_np(st.kf_map_id)[_np(st.kf_valid)]):
                host_of[int(mid)] = h
        return HostedAtlas(host_maps=hm, host_of_map=host_of)

    def ship_map(self, map_id: int, to_host: int):
        """Move map `map_id`'s keyframes and landmarks into host `to_host`'s
        arena (the transfer of a cross-host merge): the receiver grows
        when it lacks room, keyframes are appended with `add_keyframe` and
        their feature bindings, spanning-tree parents and previous links
        remapped, landmarks appended as rows; the rows are invalidated on
        the sender. The receiver's active map stays active."""
        src_host = self.host_of_map[map_id]
        if src_host == to_host:
            return
        src, dst = self.host_maps[src_host], self.host_maps[to_host]
        kv = _np(src.kf_valid) & (_np(src.kf_map_id) == map_id)
        lv = _np(src.lm_valid) & (_np(src.lm_map_id) == map_id)
        kf_rows, lm_rows = np.flatnonzero(kv), np.flatnonzero(lv)
        need_kf = int(dst.n_kf) + len(kf_rows) + 1
        need_lm = int(dst.n_lm) + len(lm_rows) + 1
        if need_kf >= dst.kmax or need_lm >= dst.lmax:
            dst = atlas_ops.grow(dst, kmax=max(dst.kmax, int(1.5 * need_kf)),
                                 lmax=max(dst.lmax, int(1.5 * need_lm)))
        dev = dst.device
        n0 = int(dst.n_lm)
        lm_remap = -np.ones(src.lmax, np.int64)
        lm_remap[lm_rows] = n0 + np.arange(len(lm_rows))
        orig_active = dst.active_map
        # appended keyframes carry the shipped map's id (add_keyframe stamps
        # the active map); the receiver's own active map comes back below
        dst = dataclasses.replace(dst, active_map=torch.tensor(map_id, dtype=torch.int32,
                                                               device=dev))
        kf_remap = {}
        feat_lm_src = _np(src.kf_feat_lm)
        on = lambda a: a.to(dev)  # noqa: E731
        for r in kf_rows:
            fl = feat_lm_src[r]
            fl_new = np.where(fl >= 0, lm_remap[np.clip(fl, 0, src.lmax - 1)], -1)
            dst, new_r = atlas_ops.add_keyframe(
                dst, on(src.kf_R[r]), on(src.kf_t[r]), float(src.kf_timestamp[r]),
                on(src.kf_feat_xy[r]), on(src.kf_feat_octave[r]), on(src.kf_feat_angle[r]),
                on(src.kf_feat_desc[r]), on(src.kf_feat_valid[r]),
                feat_lm=torch.as_tensor(fl_new, dtype=torch.int32, device=dev),
                feat_ur=on(src.kf_feat_ur[r]), feat_depth=on(src.kf_feat_depth[r]),
                vel=on(src.kf_vel[r]), bg=on(src.kf_bg[r]), ba=on(src.kf_ba[r]))
            kf_remap[int(r)] = int(new_r)
        kf_parent, kf_prev = _np(dst.kf_parent).copy(), _np(dst.kf_prev).copy()
        src_parent, src_prev = _np(src.kf_parent), _np(src.kf_prev)
        for r in kf_rows:
            nr = kf_remap[int(r)]
            kf_parent[nr] = kf_remap.get(int(src_parent[r]), -1)
            kf_prev[nr] = kf_remap.get(int(src_prev[r]), -1)
        first_new = np.array([kf_remap.get(int(f), 0) for f in _np(src.lm_first_kf)[lm_rows]],
                             np.int32)
        n0 = int(dst.n_lm)
        idx = torch.arange(n0, n0 + len(lm_rows), device=dev)
        if len(lm_rows) and n0 + len(lm_rows) > dst.lmax:
            raise RuntimeError("receiver arena full")
        lm_rows_t = torch.as_tensor(lm_rows, dtype=torch.long, device=src.device)

        def put(a, v):
            a = a.clone()
            a[idx] = v.to(dev) if torch.is_tensor(v) else torch.as_tensor(v, device=dev)
            return a

        dst = dataclasses.replace(
            dst,
            kf_parent=torch.as_tensor(kf_parent, device=dev),
            kf_prev=torch.as_tensor(kf_prev, device=dev),
            lm_pos=put(dst.lm_pos, src.lm_pos[lm_rows_t]),
            lm_desc=put(dst.lm_desc, src.lm_desc[lm_rows_t]),
            lm_valid=put(dst.lm_valid, True),
            lm_map_id=put(dst.lm_map_id, torch.tensor(map_id, dtype=torch.int32)),
            lm_first_kf=put(dst.lm_first_kf, torch.as_tensor(first_new)),
            n_lm=torch.tensor(n0 + len(lm_rows), dtype=torch.int32, device=dev),
        )
        dst = dataclasses.replace(
            dst, active_map=orig_active,
            n_maps=torch.maximum(dst.n_maps, torch.tensor(map_id + 1, dtype=torch.int32,
                                                          device=dev)))
        dst = update_landmark_stats(dst)
        src_dev = src.device
        self.host_maps[src_host] = dataclasses.replace(
            src, kf_valid=src.kf_valid & ~torch.as_tensor(kv, device=src_dev),
            lm_valid=src.lm_valid & ~torch.as_tensor(lv, device=src_dev))
        self.host_maps[to_host] = dst
        self.host_of_map[map_id] = to_host
