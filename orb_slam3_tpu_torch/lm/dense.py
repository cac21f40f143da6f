"""Dense Levenberg-Marquardt over a factor-graph Problem (port of
orb_slam3_tpu/lm/dense.py).

For the small and medium optimizers of the reference (motion-only pose
optimization, Sim3 refinement, inertial-only initialization, pose-graph
optimization). The normal equations are one dense [D, D] matrix assembled
by summing each edge's J^T W J blocks into place, and solved by one
Cholesky. Damping follows g2o's Levenberg (`optimization_algorithm_
levenberg.cpp`): gain-ratio update of lambda, ni-doubling on rejection.
The iterations are a Python loop; accepting or rejecting a step stays on
the device (`torch.where`), so a solve reads nothing back to the host.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch
from torch.func import vmap

from ..ops.scatter import add_at
from .problem import Problem, apply_info, edge_chi2, edge_cost, linearize_edge, \
    robust_weights, total_cost


def block_layout(problem: Problem):
    """name -> (offset, tangent_dim, num), and the total dimension."""
    layout, off = {}, 0
    for name, b in problem.blocks.items():
        layout[name] = (off, b.tangent_dim, b.num)
        off += b.tangent_dim * b.num
    return layout, off


def _device(problem: Problem):
    return next(iter(problem.blocks.values())).fixed.device


def assemble_normal_equations(problem: Problem):
    """Dense H [D, D], g = J^T W r [D] and the total robust cost, with the
    robust weights and edge masks applied (fixed vertices are projected out
    by the caller with `fix_mask`)."""
    layout, dim = block_layout(problem)
    dev = _device(problem)
    H = torch.zeros((dim, dim), dtype=torch.float32, device=dev)
    g = torch.zeros((dim,), dtype=torch.float32, device=dev)
    cost = torch.zeros((), dtype=torch.float32, device=dev)
    for edge in problem.edges:
        r, jacs = linearize_edge(problem, edge)
        chi2 = edge_chi2(edge, r)
        w = robust_weights(edge, chi2)
        cost = cost + edge_cost(edge, chi2)
        wr = w[:, None] * apply_info(edge.info, r)
        row_idx = []
        for slot, name in enumerate(edge.vertex_blocks):
            off, d, _ = layout[name]
            base = off + edge.indices[slot].long() * d
            row_idx.append(base[:, None] + torch.arange(d, device=dev)[None, :])
        for a, Ja in enumerate(jacs):
            g = add_at(g, row_idx[a], torch.einsum("eri,er->ei", Ja, wr))
            for b, Jb in enumerate(jacs):
                if edge.info.ndim == 1:
                    WJb = (w * edge.info)[:, None, None] * Jb
                else:
                    WJb = w[:, None, None] * torch.einsum("eij,ejb->eib", edge.info, Jb)
                Hab = torch.einsum("eri,erj->eij", Ja, WJb)
                ri = row_idx[a][:, :, None].expand_as(Hab)
                ci = row_idx[b][:, None, :].expand_as(Hab)
                H = add_at(H, (ri, ci), Hab)
    return H, g, cost


def fix_mask(problem: Problem):
    """[D] float: 1 for free coordinates, 0 for those of fixed vertices."""
    parts = [torch.where(b.fixed[:, None], 0.0, 1.0).expand(b.num, b.tangent_dim).reshape(-1)
             for b in problem.blocks.values()]
    return torch.cat(parts).to(torch.float32)


def apply_delta(problem: Problem, delta):
    """Retract a flat tangent step onto every vertex block."""
    layout, _ = block_layout(problem)
    blocks = {}
    for name, b in problem.blocks.items():
        off, d, n = layout[name]
        db = torch.where(b.fixed[:, None], 0.0, delta[off: off + n * d].reshape(n, d))
        blocks[name] = dataclasses.replace(b, state=vmap(b.retract)(b.state, db))
    return Problem(blocks=blocks, edges=problem.edges)


def select_problem(accept, new: Problem, old: Problem) -> Problem:
    """`new` where the 0-dim bool `accept` holds, else `old`, on the device."""
    blocks = {
        name: dataclasses.replace(b, state={k: torch.where(accept, v, old.blocks[name].state[k])
                                            for k, v in b.state.items()})
        for name, b in new.blocks.items()
    }
    return Problem(blocks=blocks, edges=old.edges)


def cholesky_solve(A, b):
    """x = A^-1 b by Cholesky; NaN (not an exception) where A is not
    positive definite, as jax.scipy.linalg.cho_factor gives it."""
    L, info = torch.linalg.cholesky_ex(A)
    L = torch.where(info == 0, L, float("nan"))
    return torch.cholesky_solve(b[:, None], L)[:, 0], L


class LMStats(NamedTuple):
    cost0: torch.Tensor
    cost: torch.Tensor
    lam: torch.Tensor
    accepted: torch.Tensor  # number of accepted iterations


def solve(problem: Problem, num_iters: int, lam0: float = 1e-5):
    """`num_iters` Levenberg-Marquardt iterations: one linearization and one
    Cholesky solve each; a rejected step keeps the state and raises lambda;
    a non-finite step becomes zero and is rejected."""
    dev = _device(problem)
    f32 = dict(dtype=torch.float32, device=dev)
    lam = torch.tensor(lam0, **f32)
    ni = torch.tensor(2.0, **f32)
    accepted = torch.zeros((), dtype=torch.int64, device=dev)
    m = fix_mask(problem)
    cost0 = total_cost(problem)
    p = problem
    for _ in range(num_iters):
        H, g, cost = assemble_normal_equations(p)
        # project out fixed coordinates, keeping H SPD: M H M + (1 - M) I
        H = H * m[:, None] * m[None, :] + torch.diag(1.0 - m)
        g = g * m
        # relative (Marquardt) damping plus a floor: absolute lambda I is
        # invisible in f32 against curvatures ~ fx^2 * n_obs
        dH = torch.diagonal(H)
        damp = lam * dH + 1e-6 * torch.clamp(dH.max(), min=1.0)
        delta, _ = cholesky_solve(H + torch.diag(damp), -g)
        bad = ~torch.isfinite(delta).all()
        delta = torch.where(bad, 0.0, delta)
        p_new = apply_delta(p, delta)
        new_cost = total_cost(p_new)
        # g2o gain ratio: (F - F') / (0.5 delta^T (damp delta - g))
        rho = (cost - new_cost) / torch.clamp(torch.dot(delta, damp * delta - g), min=1e-12)
        accept = (new_cost < cost) & ~bad
        lam = torch.clamp(torch.where(
            accept, lam * torch.clamp(1.0 - (2.0 * rho - 1.0) ** 3, min=1.0 / 3.0), lam * ni),
            1e-12, 1e10)
        ni = torch.where(accept, 2.0, ni * 2.0)
        p = select_problem(accept, p_new, p)
        accepted = accepted + accept.to(torch.int64)
    return p, LMStats(cost0=cost0, cost=total_cost(p), lam=lam, accepted=accepted)
