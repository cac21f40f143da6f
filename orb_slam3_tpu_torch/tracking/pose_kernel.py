"""K2: motion-only pose BA (mono and mixed stereo) as one CUDA kernel.

Replaces the Pallas kernel `orb_slam3_tpu/tracking/pose_kernel.py::_pose_kernel`.
`Optimizer::PoseOptimization` (`Optimizer.cc:814-1113`) as rounds x iters
damped Gauss-Newton steps on one SE3 pose: Huber weights (delta sqrt(5.991)
mono, sqrt(7.815) stereo rows) in rounds 0-1, analytic pinhole Jacobians
for the left update, stereo rows (ur >= 0) adding uR = uL - bf/z, 6x6 normal
equations + lambda I solved by an unrolled Cholesky, Rodrigues retraction,
acceptance when the gated cost sum(min(chi2, gate) * mask) drops, and
mask = (chi2 < gate) & valid after each round.

Batched: problem b of B is one CUDA block (csrc/pose_kernel.cu). `pose_ba`
launches the kernel for CUDA tensors and runs `pose_ba_plain` (the same
arithmetic, vectorised over rows) for CPU tensors only. `launches` counts
kernel launches.
"""

from __future__ import annotations

import ctypes
import math

import torch

CHI2_MONO = 5.991
CHI2_STEREO = 7.815
launches = 0


def _rodrigues(px, py, pz):
    """Axis-angle scalars -> (dR 9 row-major, V 9): exp and left Jacobian."""
    th2 = px * px + py * py + pz * pz
    small = th2 < 1e-12
    th = torch.sqrt(torch.where(small, torch.ones_like(th2), th2))
    sin_t, cos_t = torch.sin(th), torch.cos(th)
    a = torch.where(small, 1.0 - th2 / 6.0, sin_t / th)
    b = torch.where(small, 0.5 - th2 / 24.0, (1.0 - cos_t) / th2)
    c = torch.where(small, 1.0 / 6.0 - th2 / 120.0, (th - sin_t) / (th2 * th))
    zero = torch.zeros_like(px)
    W = (zero, -pz, py, pz, zero, -px, -py, px, zero)
    xx, yy, zz = px * px, py * py, pz * pz
    xy, xz, yz = px * py, px * pz, py * pz
    W2 = (-(yy + zz), xy, xz, xy, -(xx + zz), yz, xz, yz, -(xx + yy))
    eye = (1.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 1.0)
    dR = [eye[i] + a * W[i] + b * W2[i] for i in range(9)]
    V = [eye[i] + b * W[i] + c * W2[i] for i in range(9)]
    return dR, V


def _mat3_mul(A, B):
    return [
        A[3 * i + 0] * B[0 + j] + A[3 * i + 1] * B[3 + j] + A[3 * i + 2] * B[6 + j]
        for i in range(3)
        for j in range(3)
    ]


def _mat3_vec(A, v):
    return [A[3 * i + 0] * v[0] + A[3 * i + 1] * v[1] + A[3 * i + 2] * v[2] for i in range(3)]


def _chol_solve6(H, g):
    """Unrolled 6x6 SPD Cholesky solve, pivots floored at 1e-12."""
    n = 6
    L = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            s = H[i][j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = torch.sqrt(torch.clamp(s, min=1e-12)) if i == j else s / L[j][j]
    y = [None] * n
    for i in range(n):
        s = g[i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return x


def pose_ba_plain(K, R0, t0, uv, Xw, inv_sigma2, valid, ur=None, bf=None,
                  rounds: int = 3, iters: int = 6):
    """The kernel's arithmetic in plain torch ops, over a batch of B problems.

    K [B, >=4] (fx, fy, cx, cy, ...), R0 [B,3,3], t0 [B,3], uv [B,N,2],
    Xw [B,N,3], inv_sigma2 [B,N], valid [B,N] bool; stereo when ur [B,N]
    (ur < 0: mono row) and bf [B] are given.
    Returns (R [B,3,3], t [B,3], inlier [B,N] bool, n [B] int32)."""
    stereo = ur is not None
    B = R0.shape[0]
    col = lambda a: a[:, None]  # [B] -> [B, 1], broadcast over rows
    fx, fy, cx, cy = (col(K[:, i]) for i in range(4))
    X0, X1, X2 = Xw[..., 0], Xw[..., 1], Xw[..., 2]
    U, Vv = uv[..., 0], uv[..., 1]
    isg = inv_sigma2
    val = valid.to(torch.float32)
    if stereo:
        bfc = col(bf)
        has_ur = (ur >= 0.0).to(torch.float32)
        gate = torch.where(has_ur > 0, CHI2_STEREO, CHI2_MONO).to(torch.float32)
        delta = torch.sqrt(gate)
    else:
        gate = torch.full_like(isg, CHI2_MONO)
        delta = CHI2_MONO ** 0.5

    def chi2_of(R, t):
        x = R[0] * X0 + R[1] * X1 + R[2] * X2 + t[0]
        y = R[3] * X0 + R[4] * X1 + R[5] * X2 + t[1]
        z = R[6] * X0 + R[7] * X1 + R[8] * X2 + t[2]
        zs = torch.where(z.abs() < 1e-9, 1e-9, z)
        u_pred = fx * x / zs + cx
        ru = U - u_pred
        rv = Vv - (fy * y / zs + cy)
        c2 = ru * ru + rv * rv
        rw = None
        if stereo:
            rw = (ur - (u_pred - bfc / zs)) * has_ur
            c2 = c2 + rw * rw
        c2 = c2 * isg
        return torch.where(z > 0, c2, 1e9), (x, y, z, ru, rv, rw)

    def gated_cost(R, t, mask):
        c2, _ = chi2_of(R, t)
        return torch.sum(torch.minimum(c2, gate) * mask, dim=-1, keepdim=True)

    R0f, t0f = R0.reshape(B, 9), t0.reshape(B, 3)
    pose = [col(R0f[:, i]) for i in range(9)] + [col(t0f[:, i]) for i in range(3)]
    mask = val
    zero = torch.zeros_like(pose[0])
    for round_i in range(rounds):
        use_huber = round_i < 2  # kernel dropped in rounds 3/4 (Optimizer.cc:999)
        lam = torch.full_like(pose[0], 1e-3)
        c_cur = gated_cost(pose[:9], pose[9:], mask)
        for _ in range(iters):
            R, t = pose[:9], pose[9:]
            c2, (x, y, z, ru, rv, rw) = chi2_of(R, t)
            zs = torch.where(z.abs() < 1e-9, 1e-9, z)
            zi = 1.0 / zs
            if use_huber:
                e = torch.sqrt(torch.clamp(c2, min=1e-18))
                w_rob = torch.where(e <= delta, 1.0, delta / e)
            else:
                w_rob = 1.0
            w = w_rob * isg * mask

            # analytic d(pred)/d(rho, phi) for the left-multiplicative update
            xz, yz = x * zi, y * zi
            Ju = (fx * zi, None, -fx * xz * zi,
                  -fx * xz * yz, fx * (1.0 + xz * xz), -fx * yz)
            Jv = (None, fy * zi, -fy * yz * zi,
                  -fy * (1.0 + yz * yz), fy * xz * yz, fy * xz)
            if stereo:
                # uR = u - bf/z: d uR/dXc = [fx zi, 0, (bf - fx x) zi^2]
                q = (bfc - fx * x) * zi * zi
                Jw = (fx * zi * has_ur, None, q * has_ur,
                      q * y * has_ur, (fx - q * x) * has_ur, -fx * yz * has_ur)
            else:
                Jw = (None,) * 6

            H = [[None] * 6 for _ in range(6)]
            g = [None] * 6
            for i in range(6):
                for j in range(i + 1):
                    acc = None
                    for Jr in (Ju, Jv, Jw):
                        if Jr[i] is not None and Jr[j] is not None:
                            term = Jr[i] * Jr[j]
                            acc = term if acc is None else acc + term
                    s = zero if acc is None else torch.sum(acc * w, dim=-1, keepdim=True)
                    H[i][j] = s
                    H[j][i] = s
                acc = None
                for Jr, rr in ((Ju, ru), (Jv, rv), (Jw, rw)):
                    if Jr[i] is not None:
                        term = Jr[i] * rr
                        acc = term if acc is None else acc + term
                g[i] = torch.sum(acc * w, dim=-1, keepdim=True)
            for i in range(6):
                H[i][i] = H[i][i] + lam

            dxi = _chol_solve6(H, g)
            ok = torch.isfinite(dxi[0])
            for k in range(1, 6):
                ok = ok & torch.isfinite(dxi[k])
            dxi = [torch.where(ok, d, 0.0) for d in dxi]

            dRm, Vm = _rodrigues(dxi[3], dxi[4], dxi[5])
            dt = _mat3_vec(Vm, dxi[:3])
            Rn = _mat3_mul(dRm, R)
            tn_ = _mat3_vec(dRm, t)
            tn = [tn_[i] + dt[i] for i in range(3)]

            c_new = gated_cost(Rn, tn, mask)
            acc_step = c_new < c_cur
            pose = [torch.where(acc_step, a, b) for a, b in zip(Rn + tn, R + t)]
            lam = torch.where(acc_step, lam * 0.5, lam * 4.0)
            c_cur = torch.where(acc_step, c_new, c_cur)
        # reclassify against `valid` for the next round
        c2, _ = chi2_of(pose[:9], pose[9:])
        mask = torch.where(c2 < gate, val, 0.0)

    R = torch.cat(pose[:9], dim=-1).reshape(B, 3, 3)
    t = torch.cat(pose[9:], dim=-1)
    inl = mask > 0
    return R, t, inl, inl.sum(dim=-1).to(torch.int32)


def _lib():
    from ..kernels import build

    lib = build.load("pose_kernel")
    fn = lib.pose_kernel_launch
    if fn.argtypes is None:
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [P, P, P, P, P, P, I, I, I, I, I, F, F, F, P, P, P, P, P]
        fn.restype = I
    return fn


def pose_ba(K, R0, t0, uv, Xw, inv_sigma2, valid, ur=None, bf=None,
            rounds: int = 3, iters: int = 6):
    """Batched motion-only pose BA; arguments and results as `pose_ba_plain`.
    CUDA tensors launch K2 (one block per problem); CPU tensors run the
    plain version."""
    if R0.device.type == "cpu":
        return pose_ba_plain(K, R0, t0, uv, Xw, inv_sigma2, valid, ur, bf,
                             rounds=rounds, iters=iters)
    if R0.device.type != "cuda":
        raise ValueError(f"pose_ba: unsupported device {R0.device}")
    from ..kernels.build import check_tensor

    dev = R0.device
    B, N = uv.shape[0], uv.shape[1]
    stereo = ur is not None
    f32 = torch.float32
    if K.ndim != 2 or K.shape[1] < 4:
        raise ValueError("K: expected [B, >=4] (fx, fy, cx, cy, ...)")
    for name, t, dtype, shape in (
        ("K", K, f32, (B, K.shape[1])), ("R0", R0, f32, (B, 3, 3)),
        ("t0", t0, f32, (B, 3)), ("uv", uv, f32, (B, N, 2)), ("Xw", Xw, f32, (B, N, 3)),
        ("inv_sigma2", inv_sigma2, f32, (B, N)), ("valid", valid, torch.bool, (B, N)),
    ) + ((("ur", ur, f32, (B, N)), ("bf", bf, f32, (B,))) if stereo else ()):
        check_tensor(name, t, dtype, shape, dev)
    if stereo:
        bf_col = bf[:, None]
    else:
        bf_col = torch.zeros((B, 1), dtype=f32, device=dev)
    sc = torch.cat([K[:, :4], R0.reshape(B, 9), t0, bf_col], dim=1).contiguous()

    R = torch.empty((B, 3, 3), dtype=f32, device=dev)
    t = torch.empty((B, 3), dtype=f32, device=dev)
    inl = torch.empty((B, N), dtype=torch.bool, device=dev)
    n = torch.empty((B,), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _lib()(
        sc.data_ptr(), Xw.data_ptr(), uv.data_ptr(), inv_sigma2.data_ptr(),
        valid.data_ptr(), ur.data_ptr() if stereo else None,
        B, N, int(rounds), int(iters), int(stereo),
        CHI2_MONO, CHI2_STEREO, math.sqrt(CHI2_MONO),
        R.data_ptr(), t.data_ptr(), inl.data_ptr(), n.data_ptr(), stream,
    )
    if rc != 0:
        raise RuntimeError(f"pose_kernel launch failed with CUDA error {rc}")
    global launches
    launches += 1
    return R, t, inl, n
