"""Keyframe database, relocalization and loop / merge candidates (port of
orb_slam3_tpu/place/recognition.py).

Roles of `KeyFrameDatabase` (`KeyFrameDatabase.cc`:
DetectRelocalizationCandidates :733, DetectNBestCandidates :604),
`Tracking::Relocalization` (`Tracking.cc:3609-3761`: BoW candidates ->
PnP RANSAC -> pose optimization) and the MLPnP refinement
(`MLPnPsolver.cpp`). The inverted file is a [Kmax, S] table of sparse BoW
pairs: a query densifies the query vector once and gathers it at every
stored pair. PnP is a batched 6-point DLT RANSAC, every hypothesis solved
in one batched SVD.

Tie order follows the JAX package's `lax.top_k` (lower index first,
`matching.top_k_stable`); the RANSAC minimal sets are drawn from a CPU
`torch.Generator`, or handed in as `sets`, so a seed gives the same sets on
any device.
"""

from __future__ import annotations

import dataclasses

import torch
from torch.func import jacfwd

from ..frontend import camera as cam
from ..frontend import matching
from ..ops import lie, robust
from ..utils.threads import FORWARD_AD
from . import vocab as vocab_mod


@dataclasses.dataclass(frozen=True)
class KeyframeDB:
    """Sparse per-keyframe BoW storage: ids [Kmax, S] int32 (sentinel
    n_words), vals [Kmax, S] f32, valid [Kmax] bool. Memory grows with
    keyframes and features, not with the vocabulary."""

    ids: torch.Tensor
    vals: torch.Tensor
    valid: torch.Tensor
    n_words: int

    @staticmethod
    def empty(kmax: int, n_words: int, slots: int = 1024, device=None) -> "KeyframeDB":
        return KeyframeDB(
            ids=torch.full((kmax, slots), n_words, dtype=torch.int32, device=device),
            vals=torch.zeros((kmax, slots), dtype=torch.float32, device=device),
            valid=torch.zeros((kmax,), dtype=torch.bool, device=device),
            n_words=n_words,
        )

    def add(self, kf_row: int, bow: vocab_mod.SparseBow) -> "KeyframeDB":
        """A copy with keyframe `kf_row`'s BoW pairs stored (padded with
        empty slots, or cut to the table's S slots)."""
        S, F = self.ids.shape[1], bow.ids.shape[0]
        ids = torch.full((S,), self.n_words, dtype=torch.int32, device=self.ids.device)
        vals = torch.zeros((S,), dtype=torch.float32, device=self.ids.device)
        n = min(S, F)
        ids[:n], vals[:n] = bow.ids[:n], bow.vals[:n]
        out = KeyframeDB(self.ids.clone(), self.vals.clone(), self.valid.clone(), self.n_words)
        out.ids[kf_row], out.vals[kf_row], out.valid[kf_row] = ids, vals, True
        return out


def query(db: KeyframeDB, bow: vocab_mod.SparseBow, exclude_mask=None):
    """L1 scores of every stored keyframe [Kmax]; -1 where not stored or
    excluded. 1 - 0.5 |a - b|_1 = sum over common words of min(a_i, b_i)."""
    W = db.n_words
    dense = torch.zeros((W + 1,), dtype=torch.float32, device=db.ids.device)
    dense = dense.index_put((bow.ids.long(),), bow.vals, accumulate=True)
    contrib = torch.minimum(dense[torch.clamp(db.ids, 0, W).long()], db.vals)
    s = torch.sum(torch.where(db.ids < W, contrib, 0.0), dim=1)
    s = torch.where(db.valid, s, -1.0)
    if exclude_mask is not None:
        s = torch.where(exclude_mask, -1.0, s)
    return s


def reloc_candidates(db: KeyframeDB, bow, top_n: int = 3):
    """DetectRelocalizationCandidates: the best-scoring keyframes above 0.75
    of the best score (`KeyFrameDatabase.cc:733-850`). (idx, vals, ok)."""
    vals, idx = matching.top_k_stable(query(db, bow), top_n)
    ok = (vals >= 0.75 * torch.clamp(vals[0], min=1e-9)) & (vals > 0.0)
    return idx, vals, ok


def _top_k_rows(x, k: int):
    """Row-wise top_k with lax.top_k's order (ties to the lower index)."""
    idx = torch.argsort(-x, dim=1, stable=True)[:, :k]
    return torch.gather(x, 1, idx), idx


def loop_candidates(db: KeyframeDB, bow, query_kf: int, covis_row, min_covis_score,
                    top_n: int = 3, covis_W=None, group_size: int = 10):
    """DetectNBestCandidates for loop / merge (`KeyFrameDatabase.cc:
    604-729`): the query keyframe and `covis_row` [Kmax] are excluded and a
    candidate must score at least min_covis_score. With the covisibility
    weights covis_W [Kmax, Kmax] each candidate's score is summed over its
    group_size best covisible keyframes, groups are ranked by that sum, and
    the best-scoring member of each winning group is returned.
    (idx, vals, ok)."""
    K = db.valid.shape[0]
    exclude = covis_row.clone()
    exclude[query_kf] = True
    s = query(db, bow, exclude_mask=exclude)
    s = torch.where(s >= min_covis_score, s, -1.0)
    if covis_W is None:
        vals, idx = matching.top_k_stable(s, top_n)
        return idx, vals, vals > 0.0
    sp = torch.clamp(s, min=0.0)
    topw, topi = _top_k_rows(covis_W, min(group_size, K - 1))
    member = sp[topi] * (topw > 0)
    acc = torch.where(s > 0, sp + torch.sum(member, dim=1), -1.0)
    mem_scores = torch.cat([sp[:, None], member], dim=1)
    mem_ids = torch.cat([torch.arange(K, device=topi.device)[:, None], topi], dim=1)
    best_m = torch.argmax(mem_scores, dim=1)
    best_kf = torch.gather(mem_ids, 1, best_m[:, None])[:, 0]
    vals, gidx = matching.top_k_stable(acc, top_n)
    return best_kf[gidx], vals, vals > 0.0


# ---------------------------------------------------------------------------
# Batched DLT PnP RANSAC (the role of MLPnPsolver::iterate)
# ---------------------------------------------------------------------------

def _dlt_pnp(Xw, xn, w):
    """[..., P, 3] world points, [..., P, 2] normalized image points and
    [..., P] row weights -> (R, t): the 11-dof DLT, its rotation block
    orthogonalized. The null vector's sign cancels."""
    X, Y, Z = Xw[..., 0], Xw[..., 1], Xw[..., 2]
    u, v = xn[..., 0], xn[..., 1]
    o, z = torch.ones_like(X), torch.zeros_like(X)
    r1 = torch.stack([X, Y, Z, o, z, z, z, z, -u * X, -u * Y, -u * Z, -u], -1)
    r2 = torch.stack([z, z, z, z, X, Y, Z, o, -v * X, -v * Y, -v * Z, -v], -1)
    A = torch.cat([r1 * w[..., None], r2 * w[..., None]], dim=-2)
    _, _, Vt = torch.linalg.svd(A, full_matrices=False)
    P = Vt[..., -1, :].reshape(*Vt.shape[:-2], 3, 4)
    U, S, Vt2 = torch.linalg.svd(P[..., :3])
    sgn = torch.sign(torch.linalg.det(U @ Vt2))
    R = sgn[..., None, None] * (U @ Vt2)
    scale = torch.mean(S, dim=-1) * sgn
    scale = torch.where(torch.abs(scale) < 1e-12, 1e-12, scale)
    return R, P[..., 3] / scale[..., None]


def sample_sets(generator: torch.Generator, valid, n_hyp: int, k: int):
    """[n_hyp, k] index sets: the k largest of uniform draws per hypothesis,
    invalid entries at -1 (the JAX package's uniform + top_k); drawn on the
    generator's device and moved to valid's."""
    g = torch.rand((n_hyp, valid.shape[0]), generator=generator,
                   device=generator.device).to(valid.device)
    g = torch.where(valid[None, :], g, -1.0)
    return torch.argsort(-g, dim=1, stable=True)[:, :k]


def pnp_ransac(kind: int, K8, uv, Xw, valid, generator: torch.Generator | None = None,
               sets=None, n_hyp: int = 128, inlier_px: float = 4.0, min_set: int = 6):
    """Batched RANSAC PnP over correspondences uv [N, 2] (pixels) <-> Xw
    [N, 3]: n_hyp DLT hypotheses on minimal sets (`sets` [n_hyp, min_set],
    else drawn with `generator`), scored by reprojection inliers; the best
    refit on its inliers by a weighted DLT and kept if it scores no fewer.
    Returns (R, t, inlier mask, n inliers)."""
    if sets is None:
        if generator is None:
            raise ValueError("pnp_ransac needs a torch.Generator or the minimal sets")
        sets = sample_sets(generator, valid, n_hyp, min_set)
    sets = sets.long()
    n = uv.shape[0]
    fx, fy, cx, cy = K8[0], K8[1], K8[2], K8[3]
    xn = torch.stack([(uv[:, 0] - cx) / fx, (uv[:, 1] - cy) / fy], dim=-1)
    Rs, ts = _dlt_pnp(Xw[sets], xn[sets], torch.ones(sets.shape, dtype=uv.dtype,
                                                     device=uv.device))
    H = Rs.shape[0]
    Xc = torch.einsum("hij,nj->hni", Rs, Xw) + ts[:, None, :]
    pred = cam.project(kind, K8, Xc.reshape(-1, 3)).reshape(H, n, 2)
    err = torch.linalg.norm(pred - uv[None], dim=-1)
    inl = (err < inlier_px) & (Xc[..., 2] > 0) & valid[None, :]
    scores = torch.sum(inl, dim=1)
    best = torch.argmax(scores)

    R_r, t_r = _dlt_pnp(Xw, xn, inl[best].to(torch.float32))
    Xc_r = lie.se3_apply(R_r, t_r, Xw)
    err_r = torch.linalg.norm(cam.project(kind, K8, Xc_r) - uv, dim=-1)
    inl_r = (err_r < inlier_px) & (Xc_r[:, 2] > 0) & valid
    better = torch.sum(inl_r) >= scores[best]
    inl_out = torch.where(better, inl_r, inl[best])
    return (torch.where(better, R_r, Rs[best]), torch.where(better, t_r, ts[best]),
            inl_out, torch.sum(inl_out))


# ---------------------------------------------------------------------------
# MLPnP-style maximum-likelihood pose refinement
# ---------------------------------------------------------------------------

def mlpnp_refine(kind: int, K8, R0, t0, uv, Xw, inv_sigma2, valid, iters: int = 8):
    """Maximum-likelihood PnP refinement on bearing residuals (the core of
    the reference's MLPnP, `MLPnPsolver.cpp:73`): r_i = N_i^T normalize(R X_i
    + t) in R^2, N_i = [r, s] spanning the null space of the measured
    bearing, Huber-weighted damped Gauss-Newton; a step is kept when the
    cost drops, on the device. Inliers are judged in pixel chi2 (< 5.991).
    Returns (R, t, inlier mask, n inliers)."""
    fx = K8[0]
    rays = cam.unproject(kind, K8, uv)
    v = rays / torch.linalg.norm(rays, dim=-1, keepdim=True)
    ez = torch.tensor([0.0, 0.0, 1.0], dtype=v.dtype, device=v.device).expand_as(v)
    ex = torch.tensor([1.0, 0.0, 0.0], dtype=v.dtype, device=v.device).expand_as(v)
    a = torch.where(torch.abs(v[:, 2:3]) < 0.9, ez, ex)
    r1 = torch.linalg.cross(v, a)
    r1 = r1 / torch.clamp(torch.linalg.norm(r1, dim=-1, keepdim=True), min=1e-9)
    r2 = torch.linalg.cross(v, r1)
    w_info = inv_sigma2  # relative weighting is what matters

    def residual_flat(dxi, R, t):
        Rn, tn = lie.se3_lplus(R, t, dxi)
        Xc = lie.se3_apply(Rn, tn, Xw)
        u = Xc / torch.clamp(torch.linalg.norm(Xc, dim=-1, keepdim=True), min=1e-9)
        return torch.stack([torch.sum(r1 * u, dim=-1), torch.sum(r2 * u, dim=-1)], dim=-1)

    z6 = torch.zeros(6, dtype=uv.dtype, device=uv.device)
    R, t = R0, t0
    lam = torch.tensor(1e-3, dtype=uv.dtype, device=uv.device)
    for _ in range(iters):
        r = residual_flat(z6, R, t)
        with FORWARD_AD:
            J = jacfwd(lambda d: residual_flat(d, R, t).reshape(-1))(z6).reshape(-1, 2, 6)
        c2 = torch.sum(r * r, dim=-1) * w_info
        w = robust.huber_weight(c2 * fx ** 2, robust.CHI2_2DOF ** 0.5) * w_info * valid
        H = torch.einsum("nri,n,nrj->ij", J, w, J)
        g = torch.einsum("nri,n,nr->i", J, w, r)
        dH = torch.diagonal(H)
        Hd = H + torch.diag(lam * dH + 1e-10 * torch.clamp(dH.max(), min=1.0))
        dxi = torch.linalg.solve_ex(Hd, -g)[0]
        ok = torch.isfinite(dxi).all()
        Rn, tn = lie.se3_lplus(R, t, torch.where(ok, dxi, 0.0))
        c_old = torch.sum(torch.where(valid, c2, 0.0))
        r_new = residual_flat(z6, Rn, tn)
        c_new = torch.sum(torch.where(valid, torch.sum(r_new * r_new, dim=-1) * w_info, 0.0))
        accept = (c_new < c_old) & ok
        R, t = torch.where(accept, Rn, R), torch.where(accept, tn, t)
        lam = torch.where(accept, lam * 0.5, lam * 4.0)
    Xc = lie.se3_apply(R, t, Xw)
    chi2 = torch.sum((uv - cam.project(kind, K8, Xc)) ** 2, dim=-1) * inv_sigma2
    inl = valid & (chi2 < 5.991) & (Xc[:, 2] > 0)
    return R, t, inl, torch.sum(inl)
