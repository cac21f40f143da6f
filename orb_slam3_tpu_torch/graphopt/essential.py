"""Essential-graph pose-graph optimization and the loop-correction algebra
(port of orb_slam3_tpu/graphopt/essential.py).

Roles of `Optimizer::OptimizeEssentialGraph` (`Optimizer.cc:1501-1782`:
Sim3 vertices over spanning-tree, loop and strong-covisibility edges, 20 LM
iterations), its 4-DoF inertial variant (`OptimizeEssentialGraph4DoF`,
`Optimizer.cc:5292`: yaw and translation only) and the landmark pass of
`LoopClosing::CorrectLoop` (`LoopClosing.cc:1092-1107`: each map point
moves with its reference keyframe's correction). Built on the dense LM
engine (`lm/dense`) with the relative-pose edges of `lm/edges`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..atlas.state import MapState
from ..lm import dense, edges as lm_edges
from ..lm.problem import EdgeBatch, Problem, VertexBlock
from ..ops import lie


def optimize_essential_graph(kf_R, kf_t, kf_s, fixed, src, dst, R_rel, t_rel, s_rel,
                             edge_valid, iters: int = 20):
    """Pose-graph optimization over Sim3 keyframe vertices kf_(R, t, s)
    [K, ...] (s = 1 for SE3 poses); edges src -> dst [E] measure S_rel =
    S_dst S_src^-1; `fixed` [K] holds vertices (the loop keyframe,
    `Optimizer.cc:1544`). Returns the optimized (R, t, s) and the LM stats."""
    block = lm_edges.make_sim3_block(kf_R, kf_t, kf_s, fixed)
    eb = EdgeBatch(indices=(src, dst), data={"R_ji": R_rel, "t_ji": t_rel, "s_ji": s_rel},
                   info=torch.where(edge_valid, 1.0, 0.0), mask=edge_valid,
                   vertex_blocks=("sim3", "sim3"), residual_dim=7,
                   residual=lm_edges.relative_sim3_residual)
    solved, stats = dense.solve(Problem(blocks={"sim3": block}, edges=(eb,)),
                                num_iters=iters, lam0=1e-8)
    st = solved.blocks["sim3"].state
    return st["R"], st["t"], st["s"], stats


def correct_map_after_pgo(s: MapState, old_R, old_t, new_R, new_t, new_s) -> MapState:
    """Move every landmark with its reference keyframe's correction, X' =
    S_new^-1 T_old X (through lm_first_kf), and give the keyframes their new
    poses as SE3 [R, t / s] (`Optimizer.cc:1745-1752`,
    `LoopClosing.cc:2453-2486`)."""
    ref = torch.clamp(s.lm_first_kf, 0, s.kmax - 1).long()
    Xc = torch.einsum("lij,lj->li", old_R[ref], s.lm_pos) + old_t[ref]
    Rn, tn, sn = new_R[ref], new_t[ref], new_s[ref]
    Xw = torch.einsum("lji,lj->li", Rn, Xc - tn) / torch.clamp(sn, min=1e-9)[:, None]
    lm_ok = s.lm_valid & (s.lm_first_kf >= 0)
    kf_t_new = new_t / torch.clamp(new_s, min=1e-9)[:, None]
    return dataclasses.replace(
        s,
        lm_pos=torch.where(lm_ok[:, None], Xw, s.lm_pos),
        kf_R=torch.where(s.kf_valid[:, None, None], new_R, s.kf_R),
        kf_t=torch.where(s.kf_valid[:, None], kf_t_new, s.kf_t),
    )


def build_essential_edges(s: MapState, W, min_weight: int = 100, extra_edges=None):
    """Edges (src, dst, R_rel, t_rel, s_rel, valid) measured from the
    current poses: spanning-tree and covisibility >= min_weight edges
    (`Optimizer.cc:1550-1720`), undirected and deduplicated (src < dst, row
    major), then `extra_edges` = (src, dst, R_rel, t_rel, s_rel) loop
    constraints. T_rel = T_dst T_src^-1. The adjacency is built on the host
    (numpy); the relative poses in one batched call on the map's device."""
    K = s.kmax
    dev = s.device
    kv = s.kf_valid.cpu().numpy()
    parent = s.kf_parent.cpu().numpy()
    A = np.asarray(W.cpu().numpy() if torch.is_tensor(W) else W) >= min_weight
    rows = np.flatnonzero(kv & (parent >= 0))
    A[rows, parent[rows]] = True
    A &= kv[:, None] & kv[None, :]
    src, dst = np.nonzero(np.triu(A | A.T, 1))
    src_t = torch.as_tensor(src, dtype=torch.long, device=dev)
    dst_t = torch.as_tensor(dst, dtype=torch.long, device=dev)
    Rr = torch.einsum("eij,ekj->eik", s.kf_R[dst_t], s.kf_R[src_t])
    tr = s.kf_t[dst_t] - torch.einsum("eij,ej->ei", Rr, s.kf_t[src_t])
    sr = torch.ones((len(src),), dtype=torch.float32, device=dev)
    src_t, dst_t = src_t.to(torch.int32), dst_t.to(torch.int32)
    if extra_edges is not None:
        es, ed, eR, et, esc = (torch.as_tensor(np.asarray(a) if not torch.is_tensor(a) else a,
                                               device=dev) for a in extra_edges)
        src_t = torch.cat([src_t, es.to(torch.int32)])
        dst_t = torch.cat([dst_t, ed.to(torch.int32)])
        Rr = torch.cat([Rr, eR.to(torch.float32)])
        tr = torch.cat([tr, et.to(torch.float32)])
        sr = torch.cat([sr, esc.to(torch.float32)])
    valid = torch.ones((src_t.shape[0],), dtype=torch.bool, device=dev)
    return src_t, dst_t, Rr, tr, sr, valid


def _pose4_retract(state, delta):
    """VertexPose4DoF update (`G2oTypes.h:155-189`): translation and yaw
    only; delta = (dx, dy, dz, dyaw)."""
    dyaw = torch.cat([torch.zeros_like(delta[..., :2]), delta[..., 3:4]], dim=-1)
    return {"R": lie.so3_exp(dyaw) @ state["R"], "t": state["t"] + delta[..., :3]}


def optimize_essential_graph_4dof(kf_R, kf_t, fixed, src, dst, R_rel, t_rel, edge_valid,
                                  iters: int = 20):
    """4-DoF pose-graph optimization (OptimizeEssentialGraph4DoF): SE3
    relative constraints over yaw + translation vertices, for loop
    correction on inertial maps where gravity fixes roll and pitch and the
    scale is metric. Returns (R, t, LM stats)."""
    block = VertexBlock(state={"R": kf_R, "t": kf_t}, fixed=fixed, tangent_dim=4,
                        retract=_pose4_retract)
    eb = EdgeBatch(indices=(src, dst), data={"R_ji": R_rel, "t_ji": t_rel},
                   info=torch.where(edge_valid, 1.0, 0.0), mask=edge_valid,
                   vertex_blocks=("pose4", "pose4"), residual_dim=6,
                   residual=lm_edges.relative_se3_residual)
    solved, stats = dense.solve(Problem(blocks={"pose4": block}, edges=(eb,)),
                                num_iters=iters, lam0=1e-8)
    st = solved.blocks["pose4"].state
    return st["R"], st["t"], stats
