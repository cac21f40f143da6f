"""Two-view reconstruction for monocular map initialization (port of
orb_slam3_tpu/frontend/two_view.py).

`TwoViewReconstruction` (`TwoViewReconstruction.cc`): RANSAC of a
homography and a fundamental matrix over 200 minimal sets of 8 matches as
one batch axis (batched SVDs, dense [hypothesis, match] scoring), model
choice by score ratio, refit on the best hypothesis's inliers, and motion
recovery from the 4 essential-matrix and 8 homography candidates
(`DecomposeE:887-905`, `ReconstructH:582-752`) with the cheirality,
reprojection and parallax checks of `CheckRT:753-871`.

Singular vectors may come out with other signs than JAX's (cuSOLVER or
LAPACK); the null vectors used here (H, F, the DLT point) do not depend on
the sign, and the candidate lists may differ in order and sign but the
chosen candidate does not. Nothing here reads the device back to the host.
"""

from __future__ import annotations

import torch

N_HYP = 200
CHI2_H = 5.991
CHI2_F = 3.841
SCORE_TH = 5.991  # both models score against this (TwoViewReconstruction.cc:285,346)


def _normalize(pts, valid):
    """Mean / mean-absolute-deviation normalization (Normalize, :487-530).
    valid is float [N]. Returns (normalized points, T [3,3])."""
    wsum = torch.clamp(valid.sum(), min=1.0)
    mean = torch.sum(pts * valid[:, None], dim=0) / wsum
    d = torch.abs(pts - mean) * valid[:, None]
    meandev = torch.sum(d, dim=0) / wsum
    s = 1.0 / torch.clamp(meandev, min=1e-8)
    z, o = torch.zeros_like(s[0]), torch.ones_like(s[0])
    T = torch.stack([
        torch.stack([s[0], z, -mean[0] * s[0]]),
        torch.stack([z, s[1], -mean[1] * s[1]]),
        torch.stack([z, z, o]),
    ])
    return (pts - mean) * s, T


def sample_minimal_sets(generator: torch.Generator, valid, n_hyp: int = N_HYP, k: int = 8):
    """[n_hyp, k] int64 indices of valid matches: the k largest of uniform
    draws per hypothesis, invalid matches pushed to -1 (Gumbel top-k as in
    the JAX package). The draws are made on the generator's device and then
    moved, so a CPU generator gives the same sets on any device."""
    g = torch.rand((n_hyp, valid.shape[0]), generator=generator,
                   device=generator.device).to(valid.device)
    g = torch.where(valid[None, :], g, -1.0)
    return torch.topk(g, k, dim=1).indices


def _null_vector(A):
    """Right singular vector of the smallest singular value, per batch."""
    # full_matrices only when there are fewer rows than columns: the last
    # row of Vh is then the null space the thin SVD would leave out
    _, _, Vh = torch.linalg.svd(A, full_matrices=A.shape[-2] < A.shape[-1])
    return Vh[..., -1, :]


def _homography_dlt(p0, p1, w=None):
    """DLT homography per hypothesis: [H, P, 2] x2 -> [H, 3, 3]; optional
    row weights w [H, P] (0 removes a correspondence)."""
    x, y = p0[..., 0], p0[..., 1]
    u, v = p1[..., 0], p1[..., 1]
    z, o = torch.zeros_like(x), torch.ones_like(x)
    r1 = torch.stack([z, z, z, -x, -y, -o, v * x, v * y, v], dim=-1)
    r2 = torch.stack([x, y, o, z, z, z, -u * x, -u * y, -u], dim=-1)
    if w is not None:
        r1 = r1 * w[..., None]
        r2 = r2 * w[..., None]
    h = _null_vector(torch.cat([r1, r2], dim=-2))
    return h.reshape(*h.shape[:-1], 3, 3)


def _fundamental_8pt(p0, p1, w=None):
    """8-point fundamental with the rank-2 projection: [H, P, 2] x2 ->
    [H, 3, 3]; optional row weights w [H, P]."""
    x, y = p0[..., 0], p0[..., 1]
    u, v = p1[..., 0], p1[..., 1]
    A = torch.stack([u * x, u * y, u, v * x, v * y, v, x, y, torch.ones_like(x)], dim=-1)
    if w is not None:
        A = A * w[..., None]
    F = _null_vector(A).reshape(*x.shape[:-1], 3, 3)
    U, S, Vh = torch.linalg.svd(F)
    S = torch.cat([S[..., :2], torch.zeros_like(S[..., 2:])], dim=-1)
    return U @ (S[..., None] * Vh)


def _homog(p):
    return torch.cat([p, torch.ones_like(p[..., :1])], dim=-1)


def _score_homography(H, Hinv, p0, p1, valid, sigma=1.0):
    """Symmetric transfer error score (CheckHomography, :237-330).
    Returns (scores [H], inliers [H, N])."""
    inv_s2 = 1.0 / (sigma * sigma)

    def transfer(M, a, b):
        q = torch.einsum("hij,nj->hni", M, _homog(a))
        w = q[..., 2:]
        q = q[..., :2] / torch.where(torch.abs(w) < 1e-12, 1e-12, w)
        return torch.sum((b[None] - q) ** 2, dim=-1) * inv_s2

    chi2_1 = transfer(Hinv, p1, p0)
    chi2_2 = transfer(H, p0, p1)
    in1, in2 = chi2_1 < CHI2_H, chi2_2 < CHI2_H
    sc = torch.where(in1, SCORE_TH - chi2_1, 0.0) + torch.where(in2, SCORE_TH - chi2_2, 0.0)
    sc = sc * valid[None, :]
    return torch.sum(sc, dim=1), in1 & in2 & (valid[None, :] > 0)


def _score_fundamental(F, p0, p1, valid, sigma=1.0):
    """Point-to-epipolar-line error both ways (CheckFundamental, :332-430).
    Returns (scores [H], inliers [H, N])."""
    inv_s2 = 1.0 / (sigma * sigma)
    ph0, ph1 = _homog(p0), _homog(p1)
    l1 = torch.einsum("hij,nj->hni", F, ph0)
    num1 = torch.einsum("hni,ni->hn", l1, ph1)
    chi2_1 = num1 ** 2 / torch.clamp(l1[..., 0] ** 2 + l1[..., 1] ** 2, min=1e-12) * inv_s2
    l0 = torch.einsum("hji,nj->hni", F, ph1)
    num0 = torch.einsum("hni,ni->hn", l0, ph0)
    chi2_0 = num0 ** 2 / torch.clamp(l0[..., 0] ** 2 + l0[..., 1] ** 2, min=1e-12) * inv_s2
    in1, in0 = chi2_1 < CHI2_F, chi2_0 < CHI2_F
    sc = torch.where(in1, SCORE_TH - chi2_1, 0.0) + torch.where(in0, SCORE_TH - chi2_0, 0.0)
    sc = sc * valid[None, :]
    return torch.sum(sc, dim=1), in1 & in0 & (valid[None, :] > 0)


def triangulate(P0, P1, p0, p1):
    """Batched DLT triangulation (GeometricTools::Triangulate,
    `GeometricTools.cc:41-68`): P* [3,4], p* [N,2] -> [N,3]."""
    A = torch.stack([
        p0[:, 0, None] * P0[2] - P0[0],
        p0[:, 1, None] * P0[2] - P0[1],
        p1[:, 0, None] * P1[2] - P1[0],
        p1[:, 1, None] * P1[2] - P1[1],
    ], dim=1)
    Xh = _null_vector(A)
    w = Xh[:, 3]
    w = torch.where(torch.abs(w) < 1e-12, 1e-12, w)
    return Xh[:, :3] / w[:, None]


def _kmat(K):
    z, o = torch.zeros_like(K[0]), torch.ones_like(K[0])
    return torch.stack([
        torch.stack([K[0], z, K[2]]), torch.stack([z, K[1], K[3]]), torch.stack([z, z, o]),
    ])


def _check_rt(R, t, p0, p1, valid, K, sigma2=1.0):
    """Cheirality, reprojection and parallax checks of one (R, t) candidate
    (CheckRT, :753-871). Returns (n_good, good [N], parallax_deg, X [N,3])."""
    fx, fy, cx, cy = K[0], K[1], K[2], K[3]
    Km = _kmat(K)
    eye34 = torch.eye(3, 4, dtype=R.dtype, device=R.device)
    P0 = Km @ eye34
    P1 = Km @ torch.cat([R, t[:, None]], dim=1)
    X = triangulate(P0, P1, p0, p1)

    finite = torch.all(torch.isfinite(X), dim=-1)
    O2 = -(R.T @ t)
    n1 = X
    n2 = X - O2
    norm = lambda v: torch.sqrt(torch.sum(v * v, dim=-1))
    cosp = torch.sum(n1 * n2, dim=-1) / torch.clamp(norm(n1) * norm(n2), min=1e-12)
    z1 = X[:, 2]
    Xc2 = (R @ X.T).T + t
    z2 = Xc2[:, 2]
    depth_ok = (z1 > 0) & (z2 > 0)
    z1s, z2s = torch.clamp(z1, min=1e-9), torch.clamp(z2, min=1e-9)
    uv0 = torch.stack([fx * X[:, 0] / z1s + cx, fy * X[:, 1] / z1s + cy], dim=-1)
    uv1 = torch.stack([fx * Xc2[:, 0] / z2s + cx, fy * Xc2[:, 1] / z2s + cy], dim=-1)
    e0 = torch.sum((uv0 - p0) ** 2, dim=-1)
    e1 = torch.sum((uv1 - p1) ** 2, dim=-1)
    reproj_ok = (e0 < 4.0 * sigma2) & (e1 < 4.0 * sigma2)

    good = finite & depth_ok & reproj_ok & valid & (cosp < 0.99998)
    n_good = good.sum()
    # the 50th-smallest cosine among the good points (the reference's
    # percentile trick), as an angle
    cos_sorted = torch.sort(torch.where(good, cosp, 1.0)).values
    idx = torch.clamp(n_good - 1, min=0, max=49)
    parallax = torch.rad2deg(torch.arccos(torch.clamp(cos_sorted[idx], -1.0, 1.0)))
    return n_good, good, parallax, X


def _decompose_E(E):
    """The 4 (R, t) candidates of an essential matrix (DecomposeE)."""
    U, _, Vh = torch.linalg.svd(E)
    U = U * torch.sign(torch.linalg.det(U))
    Vh = Vh * torch.sign(torch.linalg.det(Vh))
    W = torch.tensor([[0.0, -1, 0], [1, 0, 0], [0, 0, 1]], dtype=E.dtype, device=E.device)
    R1 = U @ W @ Vh
    R2 = U @ W.T @ Vh
    t = U[:, 2]
    t = t / torch.clamp(torch.sqrt(torch.sum(t * t)), min=1e-12)
    return [(R1, t), (R1, -t), (R2, t), (R2, -t)]


def _decompose_H(H, K):
    """Faugeras SVD decomposition of a homography into 8 (R, t) candidates
    (ReconstructH, :582-752)."""
    fx, fy, cx, cy = K[0], K[1], K[2], K[3]
    z, o = torch.zeros_like(fx), torch.ones_like(fx)
    Kinv = torch.stack([
        torch.stack([1.0 / fx, z, -cx / fx]), torch.stack([z, 1.0 / fy, -cy / fy]),
        torch.stack([z, z, o]),
    ])
    A = Kinv @ H @ _kmat(K)
    U, d, Vh = torch.linalg.svd(A)
    s = torch.linalg.det(U) * torch.linalg.det(Vh)
    d1, d2, d3 = d[0], d[1], d[2]
    aux1 = torch.sqrt(torch.clamp((d1 * d1 - d2 * d2) / (d1 * d1 - d3 * d3), min=0.0))
    aux3 = torch.sqrt(torch.clamp((d2 * d2 - d3 * d3) / (d1 * d1 - d3 * d3), min=0.0))
    sx1 = (1.0, 1.0, -1.0, -1.0)
    sx3 = (1.0, -1.0, 1.0, -1.0)
    unit = lambda v: v / torch.clamp(torch.sqrt(torch.sum(v * v)), min=1e-12)
    sq = torch.sqrt(torch.clamp((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3), min=0.0))

    out = []
    # case d' = d2
    aux_st = sq / ((d1 + d3) * d2)
    ct = (d2 * d2 + d1 * d3) / ((d1 + d3) * d2)
    for i in range(4):
        x1, x3 = sx1[i] * aux1, sx3[i] * aux3
        st = torch.sign(x1 * x3 + 1e-30) * aux_st
        Rp = torch.stack([torch.stack([ct, z, -st]), torch.stack([z, o, z]),
                          torch.stack([st, z, ct])])
        out.append((s * U @ Rp @ Vh, unit(U @ (torch.stack([x1, z, -x3]) * (d1 - d3)))))
    # case d' = -d2
    aux_sp = sq / ((d1 - d3) * d2)
    cp = (d1 * d3 - d2 * d2) / ((d1 - d3) * d2)
    for i in range(4):
        x1, x3 = sx1[i] * aux1, sx3[i] * aux3
        sp = torch.sign(x1 * x3 + 1e-30) * aux_sp
        Rp = torch.stack([torch.stack([cp, z, sp]), torch.stack([z, -o, z]),
                          torch.stack([sp, z, -cp])])
        out.append((s * U @ Rp @ Vh, unit(U @ (torch.stack([x1, z, x3]) * (d1 + d3)))))
    return out


def _inv(M):
    """Inverse that does not raise on a singular matrix (like jnp.linalg.inv,
    the result is then not finite)."""
    return torch.linalg.inv_ex(M)[0]


def reconstruct(p0, p1, valid, K, generator: torch.Generator | None = None, sets=None,
                sigma: float = 1.0, min_triangulated: int = 50,
                min_parallax_deg: float = 1.0):
    """Full two-view reconstruction of matched undistorted pixels p0, p1
    [N, 2] (same index = match) with valid [N] bool and camera K [8].

    The 200 minimal sets come from `sets` [200, 8] when given, else are drawn
    with `generator` (sample_minimal_sets). Returns a dict: success, R, t
    (camera 1 from camera 0, unit t), X [N,3], good [N], used_h and n_good."""
    if sets is None:
        if generator is None:
            raise ValueError("reconstruct needs a torch.Generator or the minimal sets")
        sets = sample_minimal_sets(generator, valid)
    sets = sets.long()
    vf = valid.to(torch.float32)
    pn0, T0 = _normalize(p0, vf)
    pn1, T1 = _normalize(p1, vf)
    s0, s1 = pn0[sets], pn1[sets]

    Hn = _homography_dlt(s0, s1)
    T1inv = _inv(T1)
    Hmat = torch.einsum("ij,hjk,kl->hil", T1inv, Hn, T0)
    h22 = Hmat[:, 2:3, 2:3]
    Hmat = Hmat / torch.where(torch.abs(h22) < 1e-12, 1e-12, h22)
    h_scores, h_inliers = _score_homography(Hmat, _inv(Hmat), p0, p1, vf, sigma)

    Fn = _fundamental_8pt(s0, s1)
    Fmat = torch.einsum("ji,hjk,kl->hil", T1, Fn, T0)
    f_scores, f_inliers = _score_fundamental(Fmat, p0, p1, vf, sigma)

    bh, bf = torch.argmax(h_scores), torch.argmax(f_scores)
    SH, SF = h_scores[bh], f_scores[bf]
    use_h = SH / torch.clamp(SH + SF, min=1e-12) > 0.50  # TwoViewReconstruction.cc:133

    # refit each model on all inliers of its best hypothesis
    wh = h_inliers[bh].to(torch.float32)[None]
    wf = f_inliers[bf].to(torch.float32)[None]
    bestH = T1inv @ _homography_dlt(pn0[None], pn1[None], wh)[0] @ T0
    bestH = bestH / torch.where(torch.abs(bestH[2, 2]) < 1e-12, 1e-12, bestH[2, 2])
    bestF = T1.T @ _fundamental_8pt(pn0[None], pn1[None], wf)[0] @ T0
    _, inl_h = _score_homography(bestH[None], _inv(bestH)[None], p0, p1, vf, sigma)
    _, inl_f = _score_fundamental(bestF[None], p0, p1, vf, sigma)
    inl_h, inl_f = inl_h[0], inl_f[0]

    Km = _kmat(K)
    E = Km.T @ bestF @ Km
    cands = _decompose_E(E) + _decompose_H(bestH, K)
    results = [_check_rt(R, t, p0, p1, inl_f if i < 4 else inl_h, K, sigma * sigma)
               for i, (R, t) in enumerate(cands)]

    def pick(res, inl_mask):
        n_goods = torch.stack([r[0] for r in res])
        best = torch.argmax(n_goods)
        max_good = n_goods[best]
        n_similar = torch.sum(n_goods > 0.7 * max_good)
        min_good = torch.clamp(0.9 * inl_mask.sum().to(torch.float32), min=min_triangulated)
        parallax = torch.stack([r[2] for r in res])[best]
        ok = (max_good >= min_good) & (n_similar == 1) & (parallax > min_parallax_deg)
        return best, max_good, ok

    bi_f, ng_f, ok_f = pick(results[:4], inl_f)
    bi_h, ng_h, ok_h = pick(results[4:], inl_h)
    # prefer the score-chosen model; fall back to the other when the chosen
    # one fails its own acceptance checks
    take_h = torch.where(use_h, ok_h | ~ok_f, ok_h & ~ok_f)
    best = torch.where(take_h, 4 + bi_h, bi_f)
    return {
        "success": ok_f | ok_h,
        "R": torch.stack([c[0] for c in cands])[best],
        "t": torch.stack([c[1] for c in cands])[best],
        "X": torch.stack([r[3] for r in results])[best],
        "good": torch.stack([r[1] for r in results])[best],
        "used_h": take_h,
        "n_good": torch.where(take_h, ng_h, ng_f),
    }

