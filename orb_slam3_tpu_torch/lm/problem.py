"""Factor-graph problems for the batched LM engine (port of
orb_slam3_tpu/lm/problem.py).

g2o's pointer hypergraph becomes flat batches: a *vertex block* is a batch
of homogeneous vertices with a manifold `retract`, an *edge batch* a batch of
homogeneous factors with per-edge vertex indices, data, information, robust
kernel and mask. Residuals and Jacobians come from `torch.func.vmap` over
one edge's residual and `torch.func.jacfwd` over its tangents, so every
edge type is defined by a single-edge residual function. Residual functions
must be traceable by vmap: no `.item()`, no Python branch on a tensor's
value, no in-place op.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

import torch
from torch.func import jacfwd, vmap

from ..ops import robust
from ..utils.threads import FORWARD_AD


@dataclasses.dataclass(frozen=True)
class VertexBlock:
    """N homogeneous manifold vertices. state: dict of tensors with leading
    dim N; fixed [N] bool rows get no update; retract(single_state, delta
    [tangent_dim]) -> single_state."""

    state: Any
    fixed: torch.Tensor
    tangent_dim: int
    retract: Callable

    @property
    def num(self) -> int:
        return next(iter(self.state.values())).shape[0]


@dataclasses.dataclass(frozen=True)
class EdgeBatch:
    """E homogeneous factors: indices (one [E] tensor per vertex slot), data
    (dict of per-edge tensors), info [E] or [E, Dr, Dr], mask [E] bool,
    residual(vertex_state_1, ..., data_slice) -> [Dr], and the Huber
    threshold on sqrt(chi2) (None: no robust kernel). `jacobian`, when
    given, returns (residual, (J_slot1 [Dr, d_1], ...)) for one edge in
    the blocks' retraction tangents and replaces forward-mode
    differentiation of `residual`."""

    indices: Tuple[torch.Tensor, ...]
    data: Any
    info: torch.Tensor
    mask: torch.Tensor
    vertex_blocks: Tuple[str, ...]
    residual_dim: int
    residual: Callable
    huber_delta: Optional[float] = None
    jacobian: Optional[Callable] = None

    @property
    def num(self) -> int:
        return self.indices[0].shape[0]


@dataclasses.dataclass(frozen=True)
class Problem:
    blocks: dict
    edges: Tuple[EdgeBatch, ...]


def gather_state(state: dict, idx) -> dict:
    return {k: v[idx] for k, v in state.items()}


def edge_residuals(problem: Problem, edge: EdgeBatch):
    """Raw residuals [E, Dr] of one edge batch at the current state."""
    states = [gather_state(problem.blocks[n].state, i)
              for n, i in zip(edge.vertex_blocks, edge.indices)]
    return vmap(edge.residual)(*states, edge.data)


def apply_info(info, r):
    """Omega @ r for scalar or full information."""
    if info.ndim == 1:
        return info[:, None] * r
    return torch.einsum("eij,ej->ei", info, r)


def edge_chi2(edge: EdgeBatch, r):
    """Per-edge chi2 = r^T Omega r, [E]."""
    return torch.sum(r * apply_info(edge.info, r), dim=-1)


def robust_weights(edge: EdgeBatch, chi2):
    """IRLS weight per edge (1 inside the kernel), 0 where masked."""
    w = (torch.ones_like(chi2) if edge.huber_delta is None
         else robust.huber_weight(chi2, edge.huber_delta))
    return torch.where(edge.mask, w, 0.0)


def edge_cost(edge: EdgeBatch, chi2):
    """Total robust cost of an edge batch (g2o activeRobustChi2)."""
    rho = chi2 if edge.huber_delta is None else robust.huber_rho(chi2, edge.huber_delta)
    return torch.sum(torch.where(edge.mask, rho, 0.0))


def total_cost(problem: Problem):
    return sum(edge_cost(e, edge_chi2(e, edge_residuals(problem, e))) for e in problem.edges)


def linearize_edge(problem: Problem, edge: EdgeBatch):
    """Residuals [E, Dr] and per-slot tangent Jacobians ([E, Dr, d_s] each)
    of one edge batch: the edge's closed form where it has one, else
    forward-mode through each block's retract at 0."""
    blocks = [problem.blocks[n] for n in edge.vertex_blocks]
    states = [gather_state(b.state, i) for b, i in zip(blocks, edge.indices)]
    if edge.jacobian is not None:
        return vmap(edge.jacobian)(*states, edge.data)
    retracts = [b.retract for b in blocks]

    def with_deltas(deltas, *states_and_data):
        new_states = [ret(s, d) for ret, s, d in zip(retracts, states_and_data[:-1], deltas)]
        return edge.residual(*new_states, states_and_data[-1])

    dev = edge.info.device
    zeros = tuple(torch.zeros((edge.num, b.tangent_dim), dtype=torch.float32, device=dev)
                  for b in blocks)
    r = vmap(edge.residual)(*states, edge.data)
    with FORWARD_AD:
        jacs = vmap(jacfwd(with_deltas, argnums=0))(zeros, *states, edge.data)
    return r, jacs
