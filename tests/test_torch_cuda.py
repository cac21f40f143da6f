"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Imports neither jax nor the JAX package, so it runs on a machine with
PyTorch and a CUDA card alone:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Without a card every test skips (the kernels have no CPU mode).
"""

import numpy as np
import pytest
import torch

from orb_slam3_tpu_torch.frontend import match_kernel as mk
from orb_slam3_tpu_torch.ops import lie
from orb_slam3_tpu_torch.tracking import pose_kernel as pk


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from orb_slam3_tpu_torch import device

    return device.resolve("cuda")


def _k1_case(seed, N, M):
    rng = np.random.default_rng(seed)
    uv = rng.uniform(0, 640, (N, 2)).astype(np.float32)
    kp = rng.uniform(0, 640, (M, 2)).astype(np.float32)
    pd = rng.integers(0, 256, (N, 32)).astype(np.uint8)
    kd = rng.integers(0, 256, (M, 32)).astype(np.uint8)
    P = min(N, M) // 2
    kd[:P] = pd[:P]
    kp[:P] = uv[:P] + rng.uniform(-3, 3, (P, 2)).astype(np.float32)
    po = rng.integers(0, 4, N).astype(np.int32)
    ko = rng.integers(0, 4, M).astype(np.int32)
    ko[:P] = po[:P]
    kp[M - 1], kd[M - 1], ko[M - 1] = kp[3], kd[3], ko[3]  # a tie at landmark 3
    pv = rng.uniform(size=N) > 0.1
    kv = rng.uniform(size=M) > 0.1
    pv[3] = kv[3] = kv[M - 1] = True
    radius = (10.0 * 1.2 ** po).astype(np.float32)
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in
            (uv, po, pd, pv, kp, ko, kd, kv, radius)]


@pytest.mark.parametrize("N,M", [(300, 250), (2048, 1000), (37, 2100)])
def test_k1_kernel_matches_plain(cuda, N, M):
    args = _k1_case(0, N, M)
    kw = dict(max_dist=100, ratio=0.8, level_lo=-1, level_hi=1)
    ref = mk.search_by_projection_plain(*args, **kw)
    before = mk.launches
    got = [x.cpu() for x in mk.search_by_projection_kernel(*[a.to(cuda) for a in args], **kw)]
    torch.cuda.synchronize()
    assert mk.launches == before + 1
    assert torch.equal(got[2], ref[2])
    ok = ref[2]
    assert torch.equal(got[0][ok], ref[0][ok]) and torch.equal(got[1][ok], ref[1][ok])
    assert not got[2][3]  # the tie rejects
    assert ok.sum() > 0.3 * min(N, M)


def _k2_case(B, N, stereo, seed):
    rng = np.random.default_rng(seed)
    Xw = np.concatenate([rng.uniform(-3, 3, (B, N, 2)), rng.uniform(4, 9, (B, N, 1))], 2)
    Rt, tt = lie.se3_exp(torch.from_numpy(rng.normal(size=(B, 6)) * 0.05))
    Xc = ((Rt[:, None] @ torch.from_numpy(Xw)[..., None])[..., 0] + tt[:, None]).numpy()
    uv = np.stack([450 * Xc[..., 0] / Xc[..., 2] + 376, 450 * Xc[..., 1] / Xc[..., 2] + 240], -1)
    uv += rng.normal(size=uv.shape) * 0.5
    uv[:, : N // 10] += rng.uniform(20, 60, (B, N // 10, 2))
    f = lambda a: torch.tensor(np.asarray(a), dtype=torch.float32)
    args = [f(np.tile([450.0, 450.0, 376.0, 240.0], (B, 1))), f(np.tile(np.eye(3), (B, 1, 1))),
            f(np.zeros((B, 3))), f(uv), f(Xw), f(1.0 / 1.44 ** rng.integers(0, 8, (B, N))),
            torch.from_numpy(rng.uniform(size=(B, N)) > 0.05)]
    kw = {}
    if stereo:
        ur = uv[..., 0] - 45.0 / Xc[..., 2] + rng.normal(size=(B, N)) * 0.5
        kw = dict(ur=f(np.where(rng.uniform(size=(B, N)) < 0.5, ur, -1.0)), bf=f(np.full(B, 45.0)))
    return args, kw


@pytest.mark.parametrize("B,N,stereo", [(1, 300, False), (1, 256, True), (1, 2048, False),
                                        (4, 2048, True), (3, 5, False)])
def test_k2_kernel_matches_plain(cuda, B, N, stereo):
    args, kw = _k2_case(B, N, stereo, seed=B * 100 + N)
    R_r, t_r, m_r, n_r = pk.pose_ba_plain(*args, **kw)
    before = pk.launches
    out = pk.pose_ba(*[a.to(cuda) for a in args], **{k: v.to(cuda) for k, v in kw.items()})
    R_g, t_g, m_g, n_g = (x.cpu() for x in out)
    torch.cuda.synchronize()
    assert pk.launches == before + 1
    assert torch.equal(n_g, n_r) and torch.equal(m_g, m_r)
    # block reductions sum rows in another order than torch.sum
    torch.testing.assert_close(R_g, R_r, atol=1e-5, rtol=0)
    torch.testing.assert_close(t_g, t_r, atol=1e-4, rtol=0)


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    args = [a.to(cuda) for a in _k1_case(1, 8, 8)]
    kw = dict(max_dist=100, ratio=0.8, level_lo=-1, level_hi=1)
    bad = list(args)
    bad[1] = bad[1].long()  # int64 octaves
    with pytest.raises(TypeError):
        mk.search_by_projection_kernel(*bad, **kw)
    k2, _ = _k2_case(1, 16, False, 0)
    k2 = [a.to(cuda) for a in k2]
    k2[3] = k2[3].double()
    with pytest.raises(TypeError):
        pk.pose_ba(*k2)
