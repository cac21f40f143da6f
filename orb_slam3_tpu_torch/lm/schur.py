"""Schur-complement Levenberg-Marquardt for bundle adjustment (port of
orb_slam3_tpu/lm/schur.py).

g2o's BlockSolver_6_3 with marginalized landmarks (`Optimizer.cc:60, 1116,
2383, 3498`). Visual edges couple one camera (tangent dim C) with one
landmark; camera-camera factors go through the dense engine. Per LM
iteration:
  1. residuals and Jacobians Jc [E,Dr,C], Jl [E,Dr,3] of the visual edges
     (vmap of jacfwd);
  2. per-landmark sums Hll [L,3,3], gl [L,3] and the landmark-major camera
     coupling B [L, K*C, 3], damped and inverted in closed form;
  3. the reduced camera system S = Hcc - B Hll^-1 B^T, solved by Cholesky
     with two rounds of iterative refinement, then the landmark
     back-substitution.

Steps 1-2 and the back-substitution touch only the landmarks (and their
edges) a process holds; step 3 is replicated. So one `_schur_solve` serves
one device and a group of them (`parallel/dist_ba.py`): the landmark
elimination is rank-local, the reduced camera system and the cost are
summed over the group by `reduce` (and the damping floor's maximum taken
over it), and every rank solves the same camera system. `LOCAL` is the
world of one: the same operations, no communication, the same bits.

The JAX package sums over the landmark axis with [E, L] one-hot matmuls
(dense work for the TPU's matrix unit; 262 MB of f32 at E = 8000 and
L = 8192). Here the same sums are `ops.scatter.add_at` over the landmark
index, which on the card sorts the indices and adds each row's values in a
fixed order, so an iteration gives the same bits from run to run; masked
edges add nothing and are kept off the landmark rows' sums. The per-camera
sums stay one-hot matmuls (few cameras, thousands of edges each).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch
from torch.func import jacfwd, vmap

from ..ops import robust
from ..ops.scatter import add_at
from ..utils.threads import FORWARD_AD
from . import dense
from .problem import EdgeBatch, Problem, VertexBlock, apply_info, gather_state, total_cost


@dataclasses.dataclass(frozen=True)
class BAProblem:
    """Camera-landmark BA with optional camera-camera factors.

    cams: VertexBlock of K cameras; points [L,3]; point_fixed [L] bool;
    cam_idx / lm_idx [E] incidence; obs_data dict of [E, ...]; obs_info [E]
    or [E,Dr,Dr]; obs_mask [E] bool; cam_edges: EdgeBatches over block
    "cam"; residual(cam_state, point [3], data_slice) -> [Dr]; `jacobian`,
    when given, returns (residual, Jc [Dr, C], Jl [Dr, 3]) of one edge and
    replaces forward-mode differentiation."""

    cams: VertexBlock
    points: torch.Tensor
    point_fixed: torch.Tensor
    cam_idx: torch.Tensor
    lm_idx: torch.Tensor
    obs_data: Any
    obs_info: torch.Tensor
    obs_mask: torch.Tensor
    cam_edges: Tuple[EdgeBatch, ...]
    residual_dim: int
    residual: Callable
    huber_delta: Optional[float] = None
    jacobian: Optional[Callable] = None


class BAStats(NamedTuple):
    cost0: torch.Tensor
    cost: torch.Tensor
    lam: torch.Tensor
    accepted: torch.Tensor


class LocalReduce:
    """The reductions of `_schur_solve` over a world of one: identities."""

    size = 1
    rank = 0

    def sum(self, tensors):
        return tensors

    def max(self, t):
        return t


LOCAL = LocalReduce()


def inv3x3(M):
    """Closed-form adjugate inverse of [..., 3, 3] blocks (elementwise work,
    no batched LU); the determinant is floored at +-1e-30."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    D = -(b * i - c * h)
    E = a * i - c * g
    F = -(a * h - b * g)
    G = b * f - c * e
    H = -(a * f - c * d)
    I = a * e - b * d
    det = a * A + b * B + c * C
    det = torch.where(torch.abs(det) < 1e-30, torch.where(det < 0, -1e-30, 1e-30), det)
    adj = torch.stack([
        torch.stack([A, D, G], dim=-1),
        torch.stack([B, E, H], dim=-1),
        torch.stack([C, F, I], dim=-1),
    ], dim=-2)
    return adj * (1.0 / det)[..., None, None]


def _gathered(p: BAProblem):
    return gather_state(p.cams.state, p.cam_idx), p.points[p.lm_idx]


def _linearize_obs(p: BAProblem):
    """Residuals and Jacobians of the visual edges at the current state."""
    cam_states, X = _gathered(p)
    if p.jacobian is not None:
        return vmap(p.jacobian)(cam_states, X, p.obs_data)
    retract = p.cams.retract

    def f(dc, dx, cam_s, x, data):
        return p.residual(retract(cam_s, dc), x + dx, data)

    E, dev = p.cam_idx.shape[0], p.points.device
    zc = torch.zeros((E, p.cams.tangent_dim), dtype=torch.float32, device=dev)
    zx = torch.zeros((E, 3), dtype=torch.float32, device=dev)
    r = vmap(p.residual)(cam_states, X, p.obs_data)
    with FORWARD_AD:
        Jc, Jl = vmap(jacfwd(f, argnums=(0, 1)))(zc, zx, cam_states, X, p.obs_data)
    return r, Jc, Jl


def _obs_cost_and_weights(p: BAProblem, r):
    chi2 = torch.sum(r * apply_info(p.obs_info, r), dim=-1)
    if p.huber_delta is None:
        w, rho = torch.ones_like(chi2), chi2
    else:
        w = robust.huber_weight(chi2, p.huber_delta)
        rho = robust.huber_rho(chi2, p.huber_delta)
    return (torch.where(p.obs_mask, w, 0.0),
            torch.sum(torch.where(p.obs_mask, rho, 0.0)), chi2)


def _cam_only_problem(p: BAProblem) -> Problem:
    return Problem(blocks={"cam": p.cams}, edges=p.cam_edges)


def obs_chi2(p: BAProblem):
    """Per-observation chi2 at the current state [E] (outlier gating between
    rounds, `Optimizer.cc:1413-1475`)."""
    cam_states, X = _gathered(p)
    r = vmap(p.residual)(cam_states, X, p.obs_data)
    return torch.sum(r * apply_info(p.obs_info, r), dim=-1)


def ba_cost(p: BAProblem, reduce=LOCAL):
    """The robust cost of the visual edges (summed over `reduce`'s group)
    plus the camera-camera factors'."""
    cam_states, X = _gathered(p)
    _, cost, _ = _obs_cost_and_weights(p, vmap(p.residual)(cam_states, X, p.obs_data))
    cost, = reduce.sum([cost])
    if p.cam_edges:
        cost = cost + total_cost(_cam_only_problem(p))
    return cost


def _apply_step(p: BAProblem, dc, dl):
    dc = torch.where(p.cams.fixed[:, None], 0.0, dc)
    dl = torch.where(p.point_fixed[:, None], 0.0, dl)
    state = vmap(p.cams.retract)(p.cams.state, dc)
    return dataclasses.replace(p, cams=dataclasses.replace(p.cams, state=state),
                               points=p.points + dl)


def _schur_solve(p: BAProblem, lam, reduce=LOCAL):
    """One damped Gauss-Newton step by landmark elimination. Returns
    (dc [K,C], dl [L,3], cost at the linearization point, predicted
    decrease). Under a group's `reduce`, p holds this rank's landmarks and
    their edges; dc, the cost and the prediction are the group's, dl this
    rank's."""
    K, C, L = p.cams.num, p.cams.tangent_dim, p.points.shape[0]
    KC = K * C
    dev = p.points.device
    f32 = dict(dtype=torch.float32, device=dev)

    r, Jc, Jl = _linearize_obs(p)
    w, cost, _ = _obs_cost_and_weights(p, r)
    Wr = w[:, None] * apply_info(p.obs_info, r)
    if p.obs_info.ndim == 1:
        WJc = (w * p.obs_info)[:, None, None] * Jc
        WJl = (w * p.obs_info)[:, None, None] * Jl
    else:
        WJc = w[:, None, None] * torch.einsum("eij,ejc->eic", p.obs_info, Jc)
        WJl = w[:, None, None] * torch.einsum("eij,ejc->eic", p.obs_info, Jl)

    Hcc_e = torch.einsum("erc,erd->ecd", Jc, WJc)
    Hll_e = torch.einsum("era,erb->eab", Jl, WJl)
    Hcl_e = torch.einsum("erc,era->eca", Jc, WJl)
    gc_e = torch.einsum("erc,er->ec", Jc, Wr)
    gl_e = torch.einsum("era,er->ea", Jl, Wr)

    ci, li = p.cam_idx.long(), p.lm_idx.long()
    cam_free = torch.where(p.cams.fixed, 0.0, 1.0)
    lm_free = torch.where(p.point_fixed, 0.0, 1.0)
    Hcl_e = Hcl_e * (cam_free[ci] * lm_free[li])[:, None, None]

    # visual edges touch one camera: their Hcc is block diagonal. The few
    # cameras take thousands of edges each, so their sums are a one-hot
    # matmul (fixed order) rather than a scatter
    onehot_k = (ci[:, None] == torch.arange(K, device=dev)[None, :]).to(torch.float32)
    Hcc_diag = torch.einsum("ek,ecd->kcd", onehot_k, Hcc_e)
    Hcc = torch.einsum("kcd,kj->kcjd", Hcc_diag, torch.eye(K, **f32))
    gc = onehot_k.T @ gc_e

    # landmark blocks with relative (Marquardt) damping and a floor:
    # absolute damping vanishes in f32 against Hll ~ fx^2 * n_obs
    valid = p.obs_mask
    Hll = add_at(torch.zeros((L, 3, 3), **f32), li, Hll_e, valid)
    dHll = torch.diagonal(Hll, dim1=-2, dim2=-1)
    # the group's maximum, so that every rank damps as one device would
    floor_l = 1e-6 * torch.clamp(reduce.max(dHll.max()), min=1.0)
    Hll = Hll + torch.diag_embed(lam * dHll + floor_l)
    Hll = torch.where(p.point_fixed[:, None, None], torch.eye(3, **f32), Hll)
    Hll_inv = inv3x3(Hll)
    gl = add_at(torch.zeros((L, 3), **f32), li, gl_e, valid) * lm_free[:, None]

    # landmark-major camera coupling B [L, K*C, 3]
    B2 = add_at(torch.zeros((L, K, C, 3), **f32), (li, ci), Hcl_e, valid).reshape(L, KC, 3)
    BW = torch.einsum("lkc,lcd->lkd", B2, Hll_inv)
    S_fill = torch.einsum("lkd,ljd->kj", BW, B2)
    b_fill = torch.einsum("lkd,ld->k", BW, gl)

    # the reduced camera system, summed over the group; from here on every
    # rank computes the same camera step
    S_fill, b_fill, Hcc, gc, cost = reduce.sum([S_fill, b_fill, Hcc, gc, cost])
    if p.cam_edges:
        Hcam, gcam, cost_cam = dense.assemble_normal_equations(_cam_only_problem(p))
        Hcc = Hcc + Hcam.reshape(K, C, K, C)
        gc = gc + gcam.reshape(K, C)
        cost = cost + cost_cam

    m = cam_free[:, None].expand(K, C).reshape(KC)
    S = Hcc.reshape(KC, KC) - S_fill
    S = S * m[:, None] * m[None, :] + torch.diag(1.0 - m)
    dS = torch.diagonal(S)
    floor_s = 1e-6 * torch.clamp(dS.max(), min=1.0)
    S = S + torch.diag(lam * dS + floor_s)
    rhs = (-gc.reshape(KC) + b_fill) * m

    # Cholesky and two rounds of f32 iterative refinement (g2o runs double)
    dc, Lc = dense.cholesky_solve(S, rhs)
    for _ in range(2):
        dc = dc + torch.cholesky_solve((rhs - S @ dc)[:, None], Lc)[:, 0]

    Hlc_dc = torch.einsum("lkd,k->ld", B2, dc)
    dl = torch.einsum("lab,lb->la", Hll_inv, -gl - Hlc_dc) * lm_free[:, None]
    lm_terms, = reduce.sum([torch.stack([torch.sum(dHll * dl * dl), torch.sum(gl * dl)])])
    pred = 0.5 * (lam * (torch.sum(dS * dc * dc) + lm_terms[0])
                  - (torch.sum(gc.reshape(KC) * m * dc) + lm_terms[1]))
    return dc.reshape(K, C), dl, cost, pred


def solve(p: BAProblem, num_iters: int, lam0: float = 1e-5):
    """LM with g2o's gain-ratio damping (see dense.solve). A step that is
    not finite (a Cholesky of a matrix that is not positive definite gives
    NaN) becomes zero and is rejected. Accept / reject stays on the device."""
    dev = p.points.device
    lam = torch.tensor(lam0, dtype=torch.float32, device=dev)
    ni = torch.tensor(2.0, dtype=torch.float32, device=dev)
    accepted = torch.zeros((), dtype=torch.int64, device=dev)
    cost0 = ba_cost(p)
    for _ in range(num_iters):
        dc, dl, cost, pred = _schur_solve(p, lam)
        bad = ~(torch.isfinite(dc).all() & torch.isfinite(dl).all())
        dc = torch.where(bad, 0.0, dc)
        dl = torch.where(bad, 0.0, dl)
        cand = _apply_step(p, dc, dl)
        new_cost = ba_cost(cand)
        rho = (cost - new_cost) / torch.clamp(pred, min=1e-12)
        accept = (new_cost < cost) & ~bad
        lam = torch.clamp(torch.where(
            accept, lam * torch.clamp(1.0 - (2.0 * rho - 1.0) ** 3, min=1.0 / 3.0), lam * ni),
            1e-12, 1e10)
        ni = torch.where(accept, 2.0, ni * 2.0)
        state = {k: torch.where(accept, v, p.cams.state[k]) for k, v in cand.cams.state.items()}
        p = dataclasses.replace(p, cams=dataclasses.replace(p.cams, state=state),
                                points=torch.where(accept, cand.points, p.points))
        accepted = accepted + accept.to(torch.int64)
    return p, BAStats(cost0=cost0, cost=ba_cost(p), lam=lam, accepted=accepted)


def solve_halving(p: BAProblem, num_iters: int, lam0: float = 1e-5, reduce=LOCAL):
    """LM with the JAX package's distributed schedule (parallel/dist_ba.py):
    one linearization and one Schur solve per iteration, the step kept when
    the cost drops (lambda x 0.5, floored at 1e-12), else lambda x 4
    (capped at 1e10), decided on the device. The global BA of one device
    and of a group both run this loop. Returns (problem, costs at each
    linearization point [tensors])."""
    lam = torch.tensor(lam0, dtype=torch.float32, device=p.points.device)
    costs = []
    for _ in range(num_iters):
        dc, dl, cost, _ = _schur_solve(p, lam, reduce)
        costs.append(cost)
        cand = _apply_step(p, dc, dl)
        accept = ba_cost(cand, reduce) < cost
        lam = torch.where(accept, torch.clamp(lam * 0.5, min=1e-12),
                          torch.clamp(lam * 4.0, max=1e10))
        state = {k: torch.where(accept, v, p.cams.state[k]) for k, v in cand.cams.state.items()}
        p = dataclasses.replace(p, cams=dataclasses.replace(p.cams, state=state),
                                points=torch.where(accept, cand.points, p.points))
    return p, costs
