"""The port's CUDA kernels against their plain PyTorch versions, and the
plain-torch paths around them (the depth frontend, KB8, the inertial
solvers) on the card against the CPU, on a card; the background mapper's
stream (K1 / K2 on a side stream, the stage timer's stream-local sync, a
short session mapping on its own stream); K2 at the fleet's batch (B = 8)
and the fleet step (K1 eight times, K2 once, each session equal to its own
step); an Atlas saved from a card session reloaded exactly; the PNG
codec's round trip of a card frame; the live viewer on a card session; an
arena grown mid-session handed to the mapper on its own stream.

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


# N = 16384: the fuse and merge sites once the arena has grown (the largest
# lmax chip_smoke.py phase 16's scale-full reaches)
@pytest.mark.parametrize("N,M", [(300, 250), (2048, 1000), (37, 2100), (8192, 1000),
                                 (16384, 1000)])
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


def _k1_edge_case(name, seed=3, N=300, M=250):
    """One of the binning's edge cases, as (args, ratio)."""
    args = [a.numpy().copy() for a in _k1_case(seed, N, M)]
    uv, po, pd, pv, kp, ko, kd, kv, radius = args
    ratio = 0.8
    if name == "far_keypoints":
        # keypoints far outside the frame stretch the grid; a landmark sits on one
        kp[-20:] = np.random.default_rng(seed).uniform(-1e5, 1e5, (20, 2))
        uv[5], pd[5], po[5], pv[5], kv[M - 7], ko[M - 7] = kp[M - 7], kd[M - 7], 0, True, True, 0
    elif name == "border_windows":
        # keypoints exactly on the window's edge (|dx| == r passes the gate)
        r = radius[:40]
        kp[:40, 0] = uv[:40, 0] + np.where(np.arange(40) % 2, r, -r)
        kp[:40, 1] = uv[:40, 1] + np.where(np.arange(40) % 3 == 0, r, 0.0)
        kp[:40] = np.where((np.abs(kp[:40] - uv[:40]) <= r[:, None]), kp[:40], uv[:40])
    elif name == "large_radius":
        radius[:] = 250.0
    elif name == "one_cell":
        kp[:] = 320.0 + np.random.default_rng(seed).uniform(0, 1e-3, (M, 2))
        uv[:] = 320.0
    elif name == "tie_in_later_cell":
        # landmark 0 sees two copies of one descriptor; the lower index lies
        # lower in the image, in a grid row visited after the higher index's
        ratio = None
        kp[:, 1] = np.random.default_rng(seed).uniform(0, 640, M)
        uv[0] = (320.0, 300.0)
        radius[0] = 40.0
        kv[[2, 9]] = True
        kd[[2, 9]] = pd[0]
        ko[[2, 9]] = po[0]
        kp[2] = (320.0, 330.0)
        kp[9] = (320.0, 270.0)
        kp[0] = (5.0, 5.0)  # keypoint 0 shares the descriptor: keep it away
        pv[0] = True
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in args], ratio


K1_EDGE = ["far_keypoints", "border_windows", "large_radius", "one_cell", "tie_in_later_cell"]


@pytest.mark.parametrize("name", K1_EDGE)
def test_k1_binning_edge_cases(cuda, name):
    """Exact equality everywhere, not only where ok."""
    args, ratio = _k1_edge_case(name)
    kw = dict(max_dist=100, ratio=ratio, level_lo=-1, level_hi=1)
    ref = mk.search_by_projection_plain(*args, **kw)
    got = [x.cpu() for x in mk.search_by_projection_kernel(*[a.to(cuda) for a in args], **kw)]
    torch.cuda.synchronize()
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    if name == "tie_in_later_cell":
        assert (got[0][0].item(), got[1][0].item(), bool(got[2][0])) == (2, 0, True)


@pytest.mark.parametrize("N", [5, 37, 2048])
def test_k1_no_keypoints(cuda, N):
    args = [a.to(cuda) for a in _k1_case(0, N, 4)]
    for i in (4, 5, 6, 7):  # M = 0
        args[i] = args[i][:0].contiguous()
    idx, dist, ok = (x.cpu() for x in mk.search_by_projection_kernel(
        *args, max_dist=100, ratio=0.8, level_lo=-1, level_hi=1))
    assert (idx == 0).all() and (dist == mk.BIG).all() and not ok.any()


def _k2_case(B, N, stereo, seed, frac_mono=0.5):
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
        kw = dict(ur=f(np.where(rng.uniform(size=(B, N)) < 1.0 - frac_mono, ur, -1.0)),
                  bf=f(np.full(B, 45.0)))
    return args, kw


# N: cluster sizes 1 (5, 256), 2 (257) and 8 (2048, 2049: a ragged edge),
# 8192 (the bootstrap's arena: every staged row in use) and 9000 rows, past
# the 8 x 1024 rows staged in shared memory; B = 8 is the fleet's batch (8
# clusters of 8 CTAs at N = 2048); the stereo template at N = 16384, the
# grown arena's rows in chip_smoke.py phase 16's scale-full
K2_CASES = [(1, 300, False), (1, 256, True), (1, 2048, False), (4, 2048, True),
            (3, 5, False)] + [(B, N, stereo) for N in (5, 256, 257, 2048, 2049, 8192, 9000)
                              for B in (1, 4) for stereo in (False, True)] + [
    (8, 2048, False), (8, 2048, True), (8, 300, False), (8, 9000, False), (1, 16384, True)]


@pytest.mark.parametrize("B,N,stereo", K2_CASES)
def test_k2_kernel_matches_plain(cuda, B, N, stereo):
    args, kw = _k2_case(B, N, stereo, seed=B * 100 + N)
    R_r, t_r, m_r, n_r = pk.pose_ba_plain(*args, **kw)
    before = pk.launches
    out = pk.pose_ba(*[a.to(cuda) for a in args], **{k: v.to(cuda) for k, v in kw.items()})
    R_g, t_g, m_g, n_g = (x.cpu() for x in out)
    torch.cuda.synchronize()
    assert pk.launches == before + 1
    assert torch.equal(n_g, n_r) and torch.equal(m_g, m_r)
    # cluster reductions sum rows in another order than torch.sum
    torch.testing.assert_close(R_g, R_r, atol=1e-5, rtol=0)
    torch.testing.assert_close(t_g, t_r, atol=1e-4, rtol=0)


@pytest.mark.parametrize("N,C", [(5, 1), (256, 1), (257, 2), (2048, 8), (2049, 8), (9000, 8)])
def test_k2_cluster_size(cuda, N, C):
    assert pk.cluster_size(N) == C


@pytest.mark.parametrize("B,N,stereo", [(1, 2048, False), (4, 2049, True), (1, 9000, True)])
def test_k2_is_bitwise_deterministic(cuda, B, N, stereo):
    """The cluster sums partials in rank order: two calls give the same bits."""
    args, kw = _k2_case(B, N, stereo, seed=7)
    args = [a.to(cuda) for a in args]
    kw = {k: v.to(cuda) for k, v in kw.items()}
    first = [x.cpu() for x in pk.pose_ba(*args, **kw)]
    second = [x.cpu() for x in pk.pose_ba(*args, **kw)]
    for a, b in zip(first, second):
        assert torch.equal(a, b)


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


def _k1_fuse_case(name):
    """The fuse call site's shapes and settings (N = 8192 landmarks, M = 1000
    keypoints, radius 2 px at the predicted octave, max_dist 35, ratio 0.8)
    in the two cases the tracking call never meets: a keyframe whose every
    feature is already bound (no valid keypoint), and a covisibility pool
    that leaves a sparse set of valid landmarks."""
    args = [a.numpy().copy() for a in _k1_case(11, 8192, 1000)]
    uv, po, pd, pv, kp, ko, kd, kv, radius = args
    radius[:] = 2.0 * 1.2 ** po
    P = 500
    kp[:P] = uv[:P] + np.random.default_rng(12).uniform(-1.5, 1.5, (P, 2)).astype(np.float32)
    if name == "no_valid_keypoint":
        kv[:] = False
    else:
        pv[:] = np.random.default_rng(13).uniform(size=8192) < 0.03
        pv[:P:7] = True
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in args]


@pytest.mark.parametrize("name", ["no_valid_keypoint", "sparse_landmarks"])
def test_k1_at_the_fuse_call(cuda, name):
    """Exact equality everywhere at the fuse call's shapes."""
    args = _k1_fuse_case(name)
    kw = dict(max_dist=35, ratio=0.8, level_lo=-1, level_hi=1)
    ref = mk.search_by_projection_plain(*args, **kw)
    got = [x.cpu() for x in mk.search_by_projection_kernel(*[a.to(cuda) for a in args], **kw)]
    torch.cuda.synchronize()
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    if name == "no_valid_keypoint":
        assert not got[2].any() and (got[1] == mk.BIG).all()
    else:
        assert 20 <= int(got[2].sum()) <= int(args[3].sum())


def test_fuse_inversion_is_deterministic_on_the_card(cuda):
    """Several landmarks on one feature: the highest row wins on the card as
    on the CPU, every time."""
    from orb_slam3_tpu_torch.mapping import fuse

    rng = np.random.default_rng(5)
    idx = torch.from_numpy(rng.integers(0, 50, 8192).astype(np.int32))
    ok = torch.from_numpy(rng.uniform(size=8192) < 0.2)
    ref = fuse.invert_matches(idx, ok, 1000)
    rows = np.arange(8192)
    want = np.full(1000, -1)
    for f in range(1000):
        hit = rows[ok.numpy() & (idx.numpy() == f)]
        if hit.size:
            want[f] = hit.max()
    assert ref.tolist() == want.tolist()
    for _ in range(3):
        assert torch.equal(fuse.invert_matches(idx.to(cuda), ok.to(cuda), 1000).cpu(), ref)


# --------------------------------------------------------------- depth sensors
@pytest.mark.parametrize("N,frac_mono", [(9192, 1.0), (8192, 0.5), (8192, 0.0)])
def test_k2_at_the_depth_call_sites(cuda, N, frac_mono):
    """K2 at the shapes the depth sensors give it: the mono template over
    the localization call's map rows plus VO rows (N = lmax + F = 9192), and
    the stereo template over a tracked depth frame's rows (N = lmax = 8192)
    with mono rows (ur < 0) interleaved at 50% and at 0%."""
    args, kw = _k2_case(1, N, frac_mono < 1.0, seed=N + int(100 * frac_mono),
                        frac_mono=frac_mono)
    if kw:
        assert int((kw["ur"] < 0).sum()) == pytest.approx(frac_mono * N, abs=0.02 * N)
    R_r, t_r, m_r, n_r = pk.pose_ba_plain(*args, **kw)
    before = pk.launches
    R_g, t_g, m_g, n_g = (x.cpu() for x in pk.pose_ba(
        *[a.to(cuda) for a in args], **{k: v.to(cuda) for k, v in kw.items()}))
    torch.cuda.synchronize()
    assert pk.launches == before + 1
    assert torch.equal(n_g, n_r) and torch.equal(m_g, m_r)
    torch.testing.assert_close(R_g, R_r, atol=1e-5, rtol=0)
    torch.testing.assert_close(t_g, t_r, atol=1e-4, rtol=0)


def test_k1_at_the_vo_point_call(cuda, monkeypatch):
    """K1 at the localization call over the previous frame's VO points, as
    track.match_local_map hands it over: N = F = 1000 points with the
    distance range (0, 1e6] and zero normals (so every one is predicted at
    the top octave and searched with that octave's radius) against M = 1000
    keypoints on 8 octaves, 200 of them at the VO points' projections with
    their descriptors. The kernel equals its plain version exactly on the
    inputs the call gave it."""
    from orb_slam3_tpu_torch.tracking import track

    rng = np.random.default_rng(21)
    F = 1000
    uv = np.stack([rng.uniform(5, 747, F), rng.uniform(5, 475, F)], 1)
    z = rng.uniform(1.0, 6.0, F)
    X = np.stack([(uv[:, 0] - 376) / 450 * z, (uv[:, 1] - 240) / 450 * z, z], 1)
    desc = rng.integers(0, 256, (F, 32)).astype(np.uint8)
    kp = np.stack([rng.uniform(0, 752, F), rng.uniform(0, 480, F)], 1)
    kd = rng.integers(0, 256, (F, 32)).astype(np.uint8)
    ko = rng.integers(0, 8, F)
    kp[:200] = uv[:200] + rng.uniform(-2, 2, (200, 2))
    kd[:200], ko[:200] = desc[:200], 7
    f = lambda a: torch.tensor(np.asarray(a), dtype=torch.float32, device=cuda)  # noqa: E731
    sf = 1.2 ** torch.arange(8, dtype=torch.float32, device=cuda)
    seen = []
    orig = mk.search_by_projection_kernel

    def record(*a, **kw):
        seen.append((a, kw))
        return orig(*a, **kw)

    monkeypatch.setattr(mk, "search_by_projection_kernel", record)
    idx, ok, _, _, _ = track.match_local_map(
        0, f([450.0, 450.0, 376.0, 240.0, 0, 0, 0, 0]), torch.eye(3, device=cuda),
        torch.zeros(3, device=cuda), f(X), torch.from_numpy(desc).to(cuda),
        torch.ones(F, dtype=torch.bool, device=cuda), torch.full((F,), 1e6, device=cuda),
        torch.zeros(F, device=cuda), torch.zeros((F, 3), device=cuda), f(kp),
        torch.from_numpy(kd).to(cuda), torch.from_numpy(ko.astype(np.int32)).to(cuda),
        torch.ones(F, dtype=torch.bool, device=cuda), 4.0, sf, img_wh=(752.0, 480.0))
    (a, kw), = seen
    assert (a[1] == 7).all()  # every VO point at the top octave
    ref = mk.search_by_projection_plain(*a, **kw)
    got = [x for x in mk.search_by_projection_kernel(*a, **kw)]
    torch.cuda.synchronize()
    for g, r in zip(got, ref):
        assert torch.equal(g.cpu(), r.cpu())
    assert torch.equal(ok.cpu(), ref[2].cpu()) and int(ok.sum()) >= 100


@pytest.fixture(scope="module")
def stereo_frame():
    """A full-width PlaneScene stereo pair and its left depth map (the
    port's numpy renderer), with the ORB features of both images."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from orb_slam3_tpu_torch import entry
    from orb_slam3_tpu_torch.frontend import orb

    planes = entry.plane_scene(2)
    R, t = entry.orbit_trajectory(4)
    left, right = entry.render_stereo(planes, entry.FULL_K, entry.FULL_WH, R[3], t[3], 0.12)
    depth = entry.render_with_depth(planes, entry.FULL_K, entry.FULL_WH, R[3], t[3])[1]
    cfg = orb.OrbConfig(1000, 8)
    fl = orb.extract(torch.from_numpy(left), cfg)
    fr = orb.extract(torch.from_numpy(right), cfg)
    return dict(left=torch.from_numpy(left), right=torch.from_numpy(right),
                depth=torch.from_numpy(depth), fl=fl, fr=fr, sf=cfg.scale_factors("cpu"))


def test_match_stereo_on_the_card_matches_the_cpu(cuda, stereo_frame):
    from orb_slam3_tpu_torch.frontend import stereo

    c = stereo_frame
    fl, fr = c["fl"], c["fr"]
    args = (fl.xy, fl.octave, fl.descriptors, fl.valid, fr.xy, fr.octave, fr.descriptors,
            fr.valid, c["left"], c["right"], c["sf"])
    ur_c, d_c, ok_c = stereo.match_stereo(*args, 450.0 * 0.12, 0.1)
    ur_g, d_g, ok_g = (x.cpu() for x in stereo.match_stereo(*[a.to(cuda) for a in args],
                                                             450.0 * 0.12, 0.1))
    assert torch.equal(ok_g, ok_c) and int(ok_c.sum()) >= 300
    torch.testing.assert_close(ur_g[ok_c], ur_c[ok_c], atol=1e-3, rtol=0)
    torch.testing.assert_close(d_g[ok_c], d_c[ok_c], atol=0, rtol=1e-4)


def test_depth_from_rgbd_on_the_card_matches_the_cpu(cuda, stereo_frame):
    from orb_slam3_tpu_torch.frontend import stereo

    c = stereo_frame
    out_c = stereo.depth_from_rgbd(c["fl"].xy, c["depth"], 45.0, 1.0)
    out_g = [x.cpu() for x in stereo.depth_from_rgbd(c["fl"].xy.to(cuda), c["depth"].to(cuda),
                                                     45.0, 1.0)]
    for g, r in zip(out_g, out_c):
        assert torch.equal(g, r)
    assert int(out_c[2].sum()) >= 500


# ---------------------------------------------------------------- fisheye slice
K8 = [260.0, 260.0, 256.0, 192.0, 0.01, -0.005, 0.002, -0.001]


def _kb8_points(seed, n=2000):
    rng = np.random.default_rng(seed)
    theta = rng.uniform(0.0, 1.3, n)
    phi = rng.uniform(0, 2 * np.pi, n)
    z = rng.uniform(0.5, 8.0, n)
    r = z * np.tan(theta)
    X = np.stack([r * np.cos(phi), r * np.sin(phi), z], -1)
    X[0] = (0.0, 0.0, 3.0)  # on the optical axis
    return torch.tensor(X, dtype=torch.float32)


def test_kb8_camera_on_the_card_matches_the_cpu(cuda):
    """KB8 project / unproject, their Jacobian and the rad-tan undistortion
    (plain torch ops) on the card against the CPU."""
    from torch.func import jacfwd, vmap

    from orb_slam3_tpu_torch.frontend import camera as cam

    K = torch.tensor(K8)
    X = _kb8_points(31)
    uv_c = cam.project(cam.KB8, K, X)
    uv_g = cam.project(cam.KB8, K.to(cuda), X.to(cuda)).cpu()
    torch.testing.assert_close(uv_g, uv_c, atol=1e-3, rtol=0)
    ray_c = cam.unproject(cam.KB8, K, uv_c)
    ray_g = cam.unproject(cam.KB8, K.to(cuda), uv_c.to(cuda)).cpu()
    unit = lambda r: r / r.norm(dim=-1, keepdim=True)  # noqa: E731
    torch.testing.assert_close(unit(ray_g), unit(ray_c), atol=1e-5, rtol=0)
    jac = vmap(jacfwd(lambda k, x: cam.kb8_project(k, x), argnums=1), in_dims=(None, 0))
    J_c, J_g = jac(K, X[:200]), jac(K.to(cuda), X[:200].to(cuda)).cpu()
    assert J_g.dtype == torch.float32 and bool(torch.isfinite(J_g).all())
    torch.testing.assert_close(J_g, J_c, rtol=1e-3, atol=1e-3 * float(J_c.abs().max()))
    Kp = torch.tensor([458.654, 457.296, 367.215, 248.375, 0, 0, 0, 0])
    D = torch.tensor([-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05, 0.0])
    uv = torch.rand(1000, 2) * torch.tensor([752.0, 480.0])
    und_c = cam.undistort_points_radtan(Kp, D, uv)
    und_g = cam.undistort_points_radtan(Kp.to(cuda), D.to(cuda), uv.to(cuda)).cpu()
    torch.testing.assert_close(und_g, und_c, atol=1e-3, rtol=0)


def _fisheye_pair(seed=3, n=1000):
    """A KB8 stereo rig's keypoints (0.3 m baseline): n left keypoints, their
    right partners with the same descriptor among distractors."""
    from orb_slam3_tpu_torch.frontend import camera as cam

    rng = np.random.default_rng(seed)
    K = torch.tensor(K8)
    X = torch.tensor(np.concatenate([rng.uniform(-6, 6, (n, 2)), rng.uniform(1.5, 8, (n, 1))],
                                    1), dtype=torch.float32)
    t_rl = torch.tensor([-0.3, 0.0, 0.0])
    uv_l = cam.project(cam.KB8, K, X) + torch.tensor(rng.normal(size=(n, 2)) * 0.2,
                                                      dtype=torch.float32)
    uv_r = cam.project(cam.KB8, K, X + t_rl) + torch.tensor(rng.normal(size=(n, 2)) * 0.2,
                                                             dtype=torch.float32)
    desc = torch.from_numpy(rng.integers(0, 256, (n, 32)).astype(np.uint8))
    perm = torch.from_numpy(rng.permutation(n))
    valid = torch.from_numpy(rng.uniform(size=n) > 0.1)
    return (K, K, torch.eye(3), t_rl, uv_l, desc, valid, uv_r[perm], desc[perm], valid[perm]), X


def test_match_stereo_fisheye_on_the_card_matches_the_cpu(cuda):
    from orb_slam3_tpu_torch.frontend import camera as cam
    from orb_slam3_tpu_torch.frontend import stereo

    args, X = _fisheye_pair()
    d_c, g_c = stereo.match_stereo_fisheye(cam.KB8, *args)
    d_g, g_g = (x.cpu() for x in stereo.match_stereo_fisheye(cam.KB8, *[a.to(cuda) for a in args]))
    assert float((g_g == g_c).float().mean()) >= 0.99 and int(g_c.sum()) >= 500
    both = g_g & g_c
    torch.testing.assert_close(d_g[both], d_c[both], rtol=1e-4, atol=0)
    rel = ((d_c[g_c] - X[g_c, 2]).abs() / X[g_c, 2])
    assert float(rel.median()) < 0.06


def test_remap_bilinear_on_the_card_matches_the_cpu(cuda):
    from orb_slam3_tpu_torch.frontend import rectify

    K = np.array([[458.654, 0, 367.215], [0, 457.296, 248.375], [0, 0, 1]])
    P = np.array([[450.0, 0, 376.0, 0], [0, 450.0, 240.0, 0], [0, 0, 1, 0]])
    m = torch.from_numpy(rectify.build_remap(K, [-0.2834, 0.0740, 1.94e-4, 1.76e-5, 0], np.eye(3),
                                             P, 752, 480))
    img = torch.rand(480, 752) * 255
    out_c = rectify.remap_bilinear(img, m)
    out_g = rectify.remap_bilinear(img.to(cuda), m.to(cuda)).cpu()
    torch.testing.assert_close(out_g, out_c, atol=1e-3, rtol=0)


def _kb8_pose_case(seed, n=8192, stereo=False):
    from orb_slam3_tpu_torch.frontend import camera as cam

    rng = np.random.default_rng(seed)
    K = torch.tensor(K8)
    Xw = torch.tensor(np.concatenate([rng.uniform(-5, 5, (n, 2)), rng.uniform(2, 8, (n, 1))], 1),
                      dtype=torch.float32)
    R_t, t_t = lie.se3_exp(torch.tensor([0.05, -0.02, 0.08, 0.02, -0.03, 0.01]))
    Xc = Xw @ R_t.T + t_t
    uv = cam.project(cam.KB8, K, Xc) + torch.tensor(rng.normal(size=(n, 2)) * 0.5,
                                                     dtype=torch.float32)
    uv[: n // 10] += 30.0
    R0, t0 = lie.se3_exp(torch.tensor([0.03, -0.02, 0.02, 0.01, 0.02, -0.01]))
    R0, t0 = R0 @ R_t, R0 @ t_t + t0
    inv = torch.tensor(1.0 / 1.44 ** rng.integers(0, 8, n), dtype=torch.float32)
    valid = torch.from_numpy(rng.uniform(size=n) < 0.15)
    args = [K, R0, t0, uv, Xw, inv, valid]
    if stereo:
        ur = uv[:, 0] - 78.0 / Xc[:, 2] + torch.tensor(rng.normal(size=n) * 0.3,
                                                       dtype=torch.float32)
        ur[torch.from_numpy(rng.uniform(size=n) < 0.4)] = -1.0
        args = [K, 78.0, R0, t0, uv, ur, Xw, inv, valid]
    return args


@pytest.mark.parametrize("stereo", [False, True])
def test_kb8_pose_ba_on_the_card_matches_the_cpu(cuda, stereo):
    """KB8 pose BA has no kernel (plain torch ops on the card, as the JAX
    package keeps it on XLA): card and CPU within R 1e-5 / t 1e-4, the same
    inliers; K2 does not launch."""
    from orb_slam3_tpu_torch.frontend import camera as cam
    from orb_slam3_tpu_torch.tracking import track

    args = _kb8_pose_case(41, stereo=stereo)
    fn = track.pose_optimize_stereo if stereo else track.pose_optimize
    R_c, t_c, m_c, n_c = fn(cam.KB8, *args)
    before = pk.launches
    out = fn(cam.KB8, *[a.to(cuda) if torch.is_tensor(a) else a for a in args])
    R_g, t_g, m_g, n_g = (x.cpu() for x in out)
    assert pk.launches == before
    assert torch.equal(m_g, m_c) and int(n_g) == int(n_c) >= 800
    torch.testing.assert_close(R_g, R_c, atol=1e-5, rtol=0)
    torch.testing.assert_close(t_g, t_c, atol=1e-4, rtol=0)


def test_kb8_two_cam_on_the_card_matches_the_cpu(cuda):
    from orb_slam3_tpu_torch.frontend import camera as cam
    from orb_slam3_tpu_torch.tracking import track

    K, R0, t0, uv, Xw, inv, valid = _kb8_pose_case(43)
    R_rl, t_rl = torch.eye(3), torch.tensor([-0.3, 0.0, 0.0])
    R_t, t_t = lie.se3_exp(torch.tensor([0.05, -0.02, 0.08, 0.02, -0.03, 0.01]))
    uv_r = cam.project(cam.KB8, K, Xw @ R_t.T + t_t + t_rl)
    args = (K, K, R_rl, t_rl, R0, t0, uv, Xw, inv, valid, uv_r, Xw, inv, valid.flip(0))
    out_c = track.pose_optimize_two_cam(cam.KB8, *args)
    out_g = [x.cpu() for x in track.pose_optimize_two_cam(cam.KB8, *[a.to(cuda) for a in args])]
    assert torch.equal(out_g[2], out_c[2]) and torch.equal(out_g[3], out_c[3])
    assert int(out_g[4]) == int(out_c[4]) and int(out_c[3].sum()) >= 500
    torch.testing.assert_close(out_g[0], out_c[0], atol=1e-5, rtol=0)
    torch.testing.assert_close(out_g[1], out_c[1], atol=1e-4, rtol=0)


def test_k1_at_the_right_camera_call(cuda, monkeypatch):
    """K1 at the fisheye rig's right-camera search, as track_frame_visual
    calls it: the local map (N = 8192) projected through T_rl with the KB8
    camera against the right image's M = 1000 keypoints; the kernel equals
    its plain version exactly on the inputs the call gave it."""
    from orb_slam3_tpu_torch.frontend import camera as cam
    from orb_slam3_tpu_torch.tracking import track

    rng = np.random.default_rng(47)
    N, M = 8192, 1000
    K = torch.tensor(K8, device=cuda)
    X = torch.tensor(np.concatenate([rng.uniform(-8, 8, (N, 2)), rng.uniform(2, 8, (N, 1))], 1),
                     dtype=torch.float32, device=cuda)
    R_rl, t_rl = torch.eye(3, device=cuda), torch.tensor([-0.3, 0.0, 0.0], device=cuda)
    R, t = torch.eye(3, device=cuda), torch.zeros(3, device=cuda)
    uv = cam.project(cam.KB8, K, X + t_rl).cpu().numpy()
    desc = rng.integers(0, 256, (N, 32)).astype(np.uint8)
    kp = np.stack([rng.uniform(0, 512, M), rng.uniform(0, 384, M)], 1)
    kd = rng.integers(0, 256, (M, 32)).astype(np.uint8)
    ko = rng.integers(0, 8, M).astype(np.int32)
    inside = np.flatnonzero((uv[:, 0] >= 0) & (uv[:, 0] < 512) & (uv[:, 1] >= 0)
                            & (uv[:, 1] < 384))
    hit = rng.choice(inside, 400, replace=False)
    kp[:400], kd[:400], ko[:400] = uv[hit] + rng.uniform(-2, 2, (400, 2)), desc[hit], 0
    # distances from the right camera's centre: every landmark predicted at
    # octave 1, its band 0..2 holding the planted keypoints
    dist = torch.linalg.norm(X + t_rl, dim=-1)
    seen = []
    orig = mk.search_by_projection_kernel

    def record(*a, **kw):
        seen.append((a, kw))
        return orig(*a, **kw)

    monkeypatch.setattr(mk, "search_by_projection_kernel", record)
    f = lambda a: torch.tensor(np.asarray(a), dtype=torch.float32, device=cuda)  # noqa: E731
    _, ok, _, _, _ = track.match_local_map(
        cam.KB8, K, R_rl @ R, R_rl @ t + t_rl, X, torch.from_numpy(desc).to(cuda),
        torch.ones(N, dtype=torch.bool, device=cuda), dist * 1.1, dist / 1.2 ** 7,
        torch.zeros((N, 3), device=cuda), f(kp), torch.from_numpy(kd).to(cuda),
        torch.from_numpy(ko).to(cuda), torch.ones(M, dtype=torch.bool, device=cuda), 4.0,
        1.2 ** torch.arange(8, dtype=torch.float32, device=cuda), img_wh=(512.0, 384.0))
    (a, kw), = seen
    ref = mk.search_by_projection_plain(*a, **kw)
    got = mk.search_by_projection_kernel(*a, **kw)
    torch.cuda.synchronize()
    for g, r in zip(got, ref):
        assert torch.equal(g.cpu(), r.cpu())
    assert torch.equal(ok.cpu(), ref[2].cpu()) and int(ok.sum()) >= 200


def _merge_map(dev, N=8192, M=1000, n_lm=900, seed=11):
    """A map at the merge site's shapes (lmax N = 8192, F = M = 1000):
    keyframes 1-3 observe n_lm landmarks; keyframe 0's features are bound
    to duplicates of them; landmark n_lm - 1 has a second keeper (same
    point and descriptor, features of its own), so two keepers match one
    duplicate's feature."""
    import dataclasses

    from orb_slam3_tpu_torch.atlas import state as tstate

    rng = np.random.default_rng(seed)
    K = 8
    X = np.stack([rng.uniform(-2.0, 2.0, n_lm), rng.uniform(-1.4, 1.4, n_lm),
                  rng.uniform(4.0, 6.0, n_lm)], -1).astype(np.float32)
    desc = rng.integers(0, 256, (n_lm, 32), dtype=np.uint8)
    kf_R = np.tile(np.eye(3, dtype=np.float32), (K, 1, 1))
    kf_t = np.zeros((K, 3), np.float32)
    kf_t[:4, 0] = -0.05 * np.arange(4)
    fxy = np.zeros((K, M, 2), np.float32)
    fdesc = np.zeros((K, M, 32), np.uint8)
    flm = np.full((K, M), -1, np.int32)
    fval = np.zeros((K, M), bool)
    pos = np.zeros((N, 3), np.float32)
    ldesc = np.zeros((N, 32), np.uint8)
    lval = np.zeros(N, bool)
    first = np.full(N, -1, np.int32)
    keeper2, dup0 = n_lm, n_lm + 1
    for rows, k0 in ((np.arange(n_lm), 1), (np.array([keeper2]), 1),
                     (dup0 + np.arange(n_lm), 0)):
        src = rows if k0 else rows - dup0
        src = np.minimum(src, n_lm - 1)
        pos[rows], ldesc[rows], lval[rows], first[rows] = X[src], desc[src], True, k0
    for k in range(4):
        Xc = X + kf_t[k]
        uv = 450.0 * Xc[:, :2] / Xc[:, 2:] + np.array([376.0, 240.0], np.float32)
        fxy[k, :n_lm], fdesc[k, :n_lm], fval[k, :n_lm] = uv, desc, True
        flm[k, :n_lm] = dup0 + np.arange(n_lm) if k == 0 else np.arange(n_lm)
        if k:
            fxy[k, n_lm], fdesc[k, n_lm], fval[k, n_lm], flm[k, n_lm] = \
                uv[-1] + 0.3, desc[-1], True, keeper2
    kv = np.arange(K) < 4
    parent = np.where(np.arange(K) < 4, np.arange(K) - 1, -1).astype(np.int32)
    t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    s = tstate.empty(kmax=K, fmax=M, lmax=N, device=dev)
    s = dataclasses.replace(
        s, kf_R=t(kf_R), kf_t=t(kf_t), kf_valid=t(kv), kf_parent=t(parent), kf_feat_xy=t(fxy),
        kf_feat_desc=t(fdesc), kf_feat_lm=t(flm), kf_feat_valid=t(fval), lm_pos=t(pos),
        lm_desc=t(ldesc), lm_valid=t(lval), lm_first_kf=t(first),
        kf_map_id=torch.zeros(K, dtype=torch.int32, device=dev),
        lm_map_id=torch.zeros(N, dtype=torch.int32, device=dev),
        n_kf=torch.tensor(4, dtype=torch.int32, device=dev),
        n_lm=torch.tensor(int(lval.sum()), dtype=torch.int32, device=dev),
        lm_visible=t(rng.integers(1, 9, N).astype(np.int32)),
        lm_found=t(rng.integers(1, 5, N).astype(np.int32)))
    return tstate.update_landmark_stats(s), keeper2, dup0


def test_k1_at_the_merge_call(cuda, monkeypatch):
    """K1 at merge_duplicates_at_keyframe's shapes (N = 8192 landmarks
    against M = 1000 bound keypoints, radius 3 px x scale, ratio 0.9,
    max_dist 35, band -1..+1) with planted duplicates and a two-winner
    conflict: the kernel equals its plain version exactly on the call's
    inputs, and the merge on the card equals the merge on the CPU."""
    import dataclasses

    from orb_slam3_tpu_torch.mapping import fuse

    s, keeper2, dup0 = _merge_map(cuda)
    sf = 1.2 ** torch.arange(8, dtype=torch.float32)
    K = torch.tensor([450.0, 450.0, 376.0, 240.0, 0, 0, 0, 0])
    seen = []
    orig = mk.search_by_projection_kernel

    def record(*a, **kw):
        seen.append((a, kw))
        return orig(*a, **kw)

    monkeypatch.setattr(mk, "search_by_projection_kernel", record)
    before = mk.launches
    sg, ng = fuse.merge_duplicates_at_keyframe(0, K.to(cuda), s, 0, sf.to(cuda))
    assert mk.launches == before + 1
    (a, kw), = seen
    assert a[0].shape[0] == 8192 and a[4].shape[0] == 1000
    assert (kw["ratio"], kw["max_dist"], kw["level_lo"], kw["level_hi"]) == (0.9, 35, -1, 1)
    ref = mk.search_by_projection_plain(*a, **kw)
    got = orig(*a, **kw)
    torch.cuda.synchronize()
    for g, r in zip(got, ref):
        assert torch.equal(g.cpu(), r.cpu())
    s_cpu = dataclasses.replace(s, **{f.name: getattr(s, f.name).cpu()
                                      for f in dataclasses.fields(s)})
    sc, nc = fuse.merge_duplicates_at_keyframe(0, K, s_cpu, 0, sf)
    assert int(ng) == int(nc) >= 900
    for name in ("kf_feat_lm", "lm_valid", "lm_visible", "lm_found"):
        assert torch.equal(getattr(sg, name).cpu(), getattr(sc, name)), name
    assert int(sg.kf_feat_lm[0, 899]) == keeper2 and not bool(sg.lm_valid[dup0 + 899])


def test_k2_at_the_relocalization_call(cuda, monkeypatch):
    """K2 at the relocalization site: the mono template over N = F = 1000
    rows from a PnP-RANSAC / MLPnP initialised pose (30% wrong matches,
    5% invalid rows), as Tracker._try_relocalize calls it; within R 1e-5 /
    t 1e-4 of its plain version on the call's inputs."""
    from orb_slam3_tpu_torch.place import recognition
    from orb_slam3_tpu_torch.tracking import track

    rng = np.random.default_rng(5)
    N = 1000
    f = lambda a: torch.tensor(np.asarray(a), dtype=torch.float32, device=cuda)  # noqa: E731
    X = np.concatenate([rng.uniform(-3, 3, (N, 2)), rng.uniform(4, 9, (N, 1))], 1)
    R_gt, t_gt = lie.se3_exp(torch.tensor([0.2, -0.1, 0.15, 0.05, -0.1, 0.02]))
    Xc = (R_gt @ torch.from_numpy(X).float().T).T + t_gt
    uv = np.ascontiguousarray((450.0 * Xc[:, :2] / Xc[:, 2:] + torch.tensor([376.0, 240.0])).numpy())
    uv += rng.normal(size=uv.shape) * 0.5
    uv[:300] = rng.uniform(0, [752, 480], (300, 2))
    K = f([450.0, 450.0, 376.0, 240.0, 0, 0, 0, 0])
    valid = torch.from_numpy(rng.uniform(size=N) > 0.05).to(cuda)
    inv_s2 = f(1.0 / 1.44 ** rng.integers(0, 8, N))
    R, t, inl, n_inl = recognition.pnp_ransac(0, K, f(uv), f(X), valid,
                                              generator=torch.Generator().manual_seed(3))
    R, t, inl, _ = recognition.mlpnp_refine(0, K, R, t, f(uv), f(X), inv_s2, valid)
    seen = []
    orig = pk.pose_ba

    def record(*a, **kw):
        seen.append((a, kw))
        return orig(*a, **kw)

    monkeypatch.setattr(pk, "pose_ba", record)
    before = pk.launches
    R2, t2, _, n2 = track.pose_optimize(0, K, R, t, f(uv), f(X), inv_s2, inl)
    assert pk.launches == before + 1 and int(n_inl) > 500 and int(n2) > 500
    (a, kw), = seen
    assert a[3].shape == (1, N, 2)
    R_r, t_r, m_r, n_r = pk.pose_ba_plain(*a, **kw)
    R_g, t_g, m_g, n_g = (x.cpu() for x in orig(*a, **kw))
    assert torch.equal(n_g, n_r.cpu()) and torch.equal(m_g, m_r.cpu())
    torch.testing.assert_close(R_g, R_r.cpu(), atol=1e-5, rtol=0)
    torch.testing.assert_close(t_g, t_r.cpu(), atol=1e-4, rtol=0)
    torch.testing.assert_close(R2.cpu(), R_gt, atol=2e-3, rtol=0)


# ---------------------------------------------------------------------------
# the inertial path: the pose-inertial optimization and the VI local BA
# (plain torch) on the card against the CPU, and K1 / K2 at the inertial
# tracking site (N = lmax = 8192 landmarks, M = 1000 keypoints, from the
# IMU's prediction)
# ---------------------------------------------------------------------------

def _body_states(n_frames):
    """Body states (camera = body) and IMU packets of entry's
    vi_render_trajectory: (R_wb [N,3,3], p [N,3], v [N,3] by central
    differences, packets)."""
    from orb_slam3_tpu_torch import entry

    R_cw, t_cw, packets = entry.vi_render_trajectory(n_frames + 1)
    R_wb = np.swapaxes(R_cw, 1, 2)
    p = -np.einsum("nij,ni->nj", R_cw, t_cw)
    v = np.gradient(p, 0.1, axis=0)
    return R_wb[:n_frames], p[:n_frames], v[:n_frames], packets


def _window(packets, noise, bg=None):
    """The packets concatenated and preintegrated on the CPU."""
    from orb_slam3_tpu_torch.imu import preintegration as pre

    rows = np.concatenate(packets)
    f = lambda a: torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))  # noqa: E731
    return pre.integrate(f(rows[:, 4:7]), f(rows[:, 1:4]), f(np.full(len(rows), 0.005)),
                         torch.ones(len(rows)), torch.zeros(3) if bg is None else bg,
                         torch.zeros(3), **noise)


VI_NOISE = dict(noise_gyro=1.7e-3, noise_acc=2e-2, walk_gyro=1.9e-4, walk_acc=3e-2)
K_VI = (350.0, 350.0, 256.0, 192.0)


def _vi_pose_case(variant, seed=0, n=600):
    from orb_slam3_tpu_torch.imu import factors

    R_wb, p, v, packets = _body_states(3)
    win = _window(packets[2:3], VI_NOISE)
    data, info = factors.preint_edge_data(win)
    f = lambda a: torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))  # noqa: E731
    z3 = torch.zeros(3)
    prev = {"R": f(R_wb[1]), "t": f(p[1]), "v": f(v[1]), "bg": z3, "ba": z3}
    rng = np.random.default_rng(seed)
    Xc = np.stack([rng.uniform(-1.5, 1.5, n), rng.uniform(-1, 1, n), rng.uniform(4, 9, n)], -1)
    Xw = Xc @ R_wb[2].T + p[2]
    uv = Xc[:, :2] / Xc[:, 2:] * np.array(K_VI[:2]) + np.array(K_VI[2:])
    uv += 0.5 * rng.standard_normal(uv.shape)
    uv[:40] += 40.0  # outliers
    bf = 40.0 if variant == "stereo" else 0.0
    ur = np.where(np.arange(n) % 2 == 0, uv[:, 0] - bf / Xc[:, 2], -1.0) if bf else -np.ones(n)
    R0, t0 = lie.se3_rplus(f(R_wb[2]), f(p[2]), f(rng.normal(0, 0.02, 6)))
    cur = {"R": R0, "t": t0, "v": f(v[2] + rng.normal(0, 0.1, 3)), "bg": z3, "ba": z3}
    kw = {}
    if variant == "last_frame":
        kw = dict(prior_data={"R0": prev["R"], "t0": prev["t"], "v0": prev["v"],
                              "bg0p": z3, "ba0p": z3},
                  prior_H=torch.diag(f(np.r_[np.full(6, 1e3), np.full(3, 1e2),
                                             np.full(6, 1e5)])), free_prev=True)
    args = (0, f(list(K_VI) + [0.0] * 4), bf, torch.eye(3), torch.zeros(3), prev, cur, data,
            info, factors.rw_info6(win), f(uv), f(ur), f(Xw), torch.ones(n),
            torch.ones(n, dtype=torch.bool))
    return args, kw


def _to(x, dev):
    """Every tensor of x (nested tuples, lists and dicts) on dev."""
    if isinstance(x, dict):
        return {k: _to(v, dev) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(_to(v, dev) for v in x)
    return x.to(dev) if torch.is_tensor(x) else x


@pytest.mark.parametrize("variant", ["last_kf", "stereo", "last_frame"])
def test_pose_inertial_optimize_on_the_card_matches_the_cpu(cuda, variant):
    from orb_slam3_tpu_torch.tracking import vi_pose_opt

    args, kw = _vi_pose_case(variant)
    cur_c, inl_c, n_c, H_c = vi_pose_opt.pose_inertial_optimize(*args, **kw)
    cur_g, inl_g, n_g, H_g = vi_pose_opt.pose_inertial_optimize(*_to(args, cuda), **_to(kw, cuda))
    assert cur_g["R"].device.type == cuda.type
    for k, atol in (("R", 1e-4), ("t", 1e-4), ("v", 1e-3), ("bg", 1e-5), ("ba", 1e-4)):
        np.testing.assert_allclose(cur_g[k].cpu().numpy(), cur_c[k].numpy(), atol=atol,
                                   err_msg=k)
    assert torch.equal(inl_g.cpu(), inl_c) and int(n_g) == int(n_c)
    assert not inl_c[:40].any() and int(n_c) > 500
    Hc = H_c.numpy()
    np.testing.assert_allclose(H_g.cpu().numpy(), Hc, atol=1e-3 * np.abs(Hc).max())


def test_local_inertial_ba_on_the_card_matches_the_cpu(cuda):
    from orb_slam3_tpu_torch.imu import factors, preintegration as pre, vi_ba

    R_wb, p, v, packets = _body_states(10)
    kf = [0, 3, 6, 9]
    wins = [_window(packets[a + 1:b + 1], VI_NOISE) for a, b in zip(kf[:-1], kf[1:])]
    stack = pre.stack(wins)
    data, info = factors.preint_edge_data(stack)
    rng = np.random.default_rng(1)
    W, L = len(kf), 300
    Xc0 = np.stack([rng.uniform(-2, 2, L), rng.uniform(-1.5, 1.5, L), rng.uniform(5, 10, L)], -1)
    X = Xc0 @ R_wb[0].T + p[0]
    Rcw = np.swapaxes(R_wb[kf], 1, 2)
    Xc = np.einsum("kij,klj->kli", Rcw, X[None] - p[kf][:, None])
    uv = Xc[..., :2] / Xc[..., 2:] * np.array(K_VI[:2]) + np.array(K_VI[2:])
    uv = (uv + 0.5 * rng.standard_normal(uv.shape)).reshape(-1, 2)
    f = lambda a: torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))  # noqa: E731
    dp = rng.normal(0, 0.02, (W, 6))
    dp[0] = 0.0
    Rp, tp = lie.se3_rplus(f(R_wb[kf]), f(p[kf]), f(dp))
    src = torch.arange(W - 1, dtype=torch.int32)
    fixed = torch.zeros(W, dtype=torch.bool)
    fixed[0] = True
    args = (0, f(list(K_VI) + [0.0] * 4), torch.eye(3), torch.zeros(3), Rp, tp,
            f(v[kf] + rng.normal(0, 0.1, (W, 3))), torch.zeros(W, 3), torch.zeros(W, 3), fixed,
            f(X + rng.normal(0, 0.05, X.shape)), torch.zeros(L, dtype=torch.bool),
            torch.arange(W).repeat_interleave(L), torch.arange(L).repeat(W), f(uv),
            torch.ones(W * L), torch.ones(W * L, dtype=torch.bool), data, info,
            factors.rw_info6(stack), src, src + 1, torch.ones(W - 1, dtype=torch.bool))
    out_c = vi_ba.local_inertial_ba(*args, iters=6, bias_prior=(1e2, 1e5))
    out_g = vi_ba.local_inertial_ba(*_to(args, cuda), iters=6, bias_prior=(1e2, 1e5))
    assert out_g[0].device.type == cuda.type
    assert float(out_c[6].cost) < 0.1 * float(out_c[6].cost0)
    for i, atol in zip(range(6), (1e-4, 1e-4, 1e-3, 1e-5, 1e-4, 1e-3)):
        np.testing.assert_allclose(out_g[i].cpu().numpy(), out_c[i].numpy(), atol=atol,
                                   err_msg=str(i))


def test_k1_and_k2_at_the_inertial_tracking_site(cuda):
    """The local-map match (K1) and the motion-only BA (K2) of the fused
    step at an inertial frame's shapes (N = 8192, M = 1000) from the pose
    the IMU predicts over a frame's packet, on the card against their
    plain versions: K1 exact, K2 within R 1e-5 / t 1e-4."""
    from orb_slam3_tpu_torch import entry
    from orb_slam3_tpu_torch.frontend import camera as cam
    from orb_slam3_tpu_torch.frontend import orb
    from orb_slam3_tpu_torch.imu import preintegration as pre
    from orb_slam3_tpu_torch.tracking import track

    cfg = orb.OrbConfig(n_features=1000, n_levels=8)
    img = entry.blob_frame(480, 752, seed=4)
    feats = orb.extract(torch.from_numpy(img), cfg)
    K = cam.make_pinhole(450.0, 450.0, 376.0, 240.0, device="cpu")
    scene = entry.make_scene(feats.xy.numpy(), feats.octave.numpy(), feats.descriptors.numpy(),
                             feats.valid.numpy(), K.numpy(), cfg.n_levels, 8192)
    _, _, _, packets = _body_states(2)
    win = _window(packets[1:2], VI_NOISE)
    # the previous body state 0.1 s back along a 0.2 m/s drift: the
    # prediction lands within a few mm of the frame's true pose
    v = torch.tensor([0.2, 0.0, 0.0])
    R_pred, t_pred, _ = pre.predict_state(win, torch.eye(3), -0.1 * v, v, torch.zeros(3),
                                          torch.zeros(3))
    R_cw, t_cw = lie.se3_inv(lie.normalize_rotation(R_pred @ torch.from_numpy(scene["R0"])),
                             t_pred)
    R_cw = R_cw.contiguous()
    lm = [torch.from_numpy(scene[k]) for k in ("lm_pos", "lm_desc", "lm_valid", "lm_max_dist",
                                                  "lm_min_dist", "lm_normal")]
    sf = cfg.scale_factors("cpu")

    def site(dev):
        m = [a.to(dev) for a in lm]
        fx = [a.to(dev) for a in (feats.xy, feats.descriptors, feats.octave, feats.valid)]
        idx, ok, _, _, _ = track.match_local_map(0, K.to(dev), R_cw.to(dev), t_cw.to(dev), *m,
                                                 *fx, 4.0, sf.to(dev), img_wh=(752.0, 480.0))
        idx = idx.long()
        inv = 1.0 / sf.to(dev)[torch.clamp(fx[2][idx], 0, 7).long()] ** 2
        return (idx, ok), track.pose_optimize(0, K.to(dev), R_cw.to(dev), t_cw.to(dev),
                                              fx[0][idx].contiguous(), m[0], inv, ok)

    (idx_c, ok_c), pose_c = site("cpu")
    k1, k2 = mk.launches, pk.launches
    (idx_g, ok_g), pose_g = site(cuda)
    torch.cuda.synchronize()
    assert mk.launches == k1 + 1 and pk.launches == k2 + 1
    assert torch.equal(ok_g.cpu(), ok_c) and torch.equal(idx_g.cpu()[ok_c], idx_c[ok_c])
    assert int(ok_c.sum()) > 400
    np.testing.assert_allclose(pose_g[0].cpu().numpy(), pose_c[0].numpy(), atol=1e-5)
    np.testing.assert_allclose(pose_g[1].cpu().numpy(), pose_c[1].numpy(), atol=1e-4)


# ---------------------------------------------------------------------------
# the background mapper's stream
# ---------------------------------------------------------------------------

def test_k1_and_k2_on_a_side_stream_give_the_default_streams_bits(cuda):
    """The wrappers launch on PyTorch's current stream: inside
    torch.cuda.stream(side), where the mapper thread runs, K1 and K2 give
    the bits they give on the default stream, and the launches land on the
    side stream (the default stream is held by nothing)."""
    args1 = [a.to(cuda) for a in _k1_case(5, 8192, 1000)]
    kw1 = dict(max_dist=100, ratio=0.8, level_lo=-1, level_hi=1)
    args2, kw2 = _k2_case(1, 8192, True, seed=21)
    args2 = [a.to(cuda) for a in args2]
    kw2 = {k: v.to(cuda) for k, v in kw2.items()}
    ref1 = [x.cpu() for x in mk.search_by_projection_kernel(*args1, **kw1)]
    ref2 = [x.cpu() for x in pk.pose_ba(*args2, **kw2)]
    side = torch.cuda.Stream(cuda)
    side.wait_stream(torch.cuda.current_stream(cuda))
    with torch.cuda.stream(side):
        got1 = mk.search_by_projection_kernel(*args1, **kw1)
        got2 = pk.pose_ba(*args2, **kw2)
        done = torch.cuda.Event()
        done.record(side)
    done.synchronize()
    for a, b in zip([x.cpu() for x in got1] + [x.cpu() for x in got2], ref1 + ref2):
        assert torch.equal(a, b)


def test_stage_sync_waits_for_its_own_stream_only(cuda):
    """StageTimer.stage_sync waits for the calling thread's current stream:
    a stage on the default stream does not wait for a spin kernel queued
    on another stream (torch.cuda.synchronize would)."""
    from orb_slam3_tpu_torch.utils.timing import StageTimer

    timer = StageTimer()
    x = torch.ones(1000, device=cuda)
    (x * 2).sum().item()  # warm-up
    side = torch.cuda.Stream(cuda)
    spin = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
    with torch.cuda.stream(side):
        spin[0].record(side)
        torch.cuda._sleep(1_000_000_000)  # ~0.5 s at the H100's boost clock
        spin[1].record(side)
    with timer.stage_sync("own", cuda):
        y = x * 2
    own_ms = timer.samples["own"][0]
    with timer.stage("all"):
        torch.cuda.synchronize(cuda)
    spin_ms = spin[0].elapsed_time(spin[1])
    assert spin_ms > 200.0 and own_ms < 0.25 * spin_ms, (own_ms, spin_ms)
    assert timer.samples["all"][0] > own_ms
    assert float(y.sum()) == 2000.0


def test_async_session_on_the_card_maps_on_its_own_stream(cuda):
    """A 10-frame monocular session at 256x192 on the free-running mapper:
    it maps on the mapper thread's own stream (K1's fuse launches come from
    the "mapper" thread), tracks, and shutdown() returns within its
    timeout."""
    import time

    from orb_slam3_tpu_torch import entry
    from orb_slam3_tpu_torch.atlas import invariants
    from orb_slam3_tpu_torch.frontend import orb
    from orb_slam3_tpu_torch.mapping import fuse

    small = dict(img_wh=(256, 192), K=(200.0, 200.0, 128.0, 96.0))
    frames = entry.plane_sequence(10, **small)[0]
    cfg = entry.tracker_config(cuda, orb=orb.OrbConfig(300, 4), kmax=16, lmax=1024,
                               local_window=4, **small)
    streams = set()
    orig = fuse.fuse_into_keyframe

    def fuse_rec(*a, **kw):
        streams.add(torch.cuda.current_stream(cuda).cuda_stream)
        return orig(*a, **kw)

    fuse.fuse_into_keyframe = fuse_rec
    try:
        mapper_k1 = mk.launches_by_thread.get("mapper", 0)
        system = entry.slam(frames, cfg)
    finally:
        fuse.fuse_into_keyframe = orig
    tr = system.tracker
    m = tr.async_mapper
    assert m is not None and m._stream is not None and m.n_processed >= 1
    assert streams == {m._stream.cuda_stream}
    assert m._stream.cuda_stream != torch.cuda.current_stream(cuda).cuda_stream
    assert mk.launches_by_thread.get("mapper", 0) > mapper_k1
    ts, R, t, ok = tr.poses()
    assert ok[-4:].all() and invariants.check_all(tr.map) == []
    thread = m._thread
    t0 = time.perf_counter()
    system.shutdown()
    assert time.perf_counter() - t0 < 30.0 and not thread.is_alive()


@pytest.fixture(scope="module")
def card_session():
    """A 10-frame monocular session at 256x192 on the card (synchronous
    schedule), shut down."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from orb_slam3_tpu_torch import device, entry
    from orb_slam3_tpu_torch.frontend import orb

    dev = device.resolve("cuda")
    small = dict(img_wh=(256, 192), K=(200.0, 200.0, 128.0, 96.0))
    frames = entry.plane_sequence(10, **small)[0]
    cfg = entry.tracker_config(dev, orb=orb.OrbConfig(300, 4), kmax=16, lmax=1024,
                               local_window=4, async_mapping=False, pipeline_depth=1, **small)
    system = entry.slam(frames, cfg)
    system.shutdown()
    return system, frames


def test_an_atlas_saved_from_a_card_map_reloads_exactly(cuda, card_session, tmp_path):
    import dataclasses

    from orb_slam3_tpu_torch.api import checkpoint
    from orb_slam3_tpu_torch.api.system import System

    system, _ = card_session
    path = str(tmp_path / "atlas.npz")
    system.save_atlas(path)
    s = system.tracker.map
    assert int(s.kf_valid.sum()) >= 2
    for dev in (cuda, "cpu"):
        got, _ = checkpoint.load_atlas(path, device=dev)
        for f in dataclasses.fields(s):
            a = getattr(got, f.name)
            assert a.device.type == torch.device(dev).type
            assert torch.equal(a.cpu(), getattr(s, f.name).cpu()), f.name
    resumed = System(config=system.tracker.cfg, atlas_path=path)
    assert resumed.tracker.map.kf_R.is_cuda and int(resumed.tracker.map.active_map) == 1
    resumed.shutdown()


def test_codec_round_trip_of_a_card_frame(cuda, card_session):
    from orb_slam3_tpu_torch.utils import png

    _, frames = card_session
    img = torch.as_tensor(np.asarray(frames[3]), device=cuda).round().clamp(0, 255).to(
        torch.uint8)
    for filt in range(5):
        back = torch.from_numpy(png.decode(png.encode(img.cpu().numpy(), filt))).to(cuda)
        assert torch.equal(back, img)


def test_viewer_reads_a_card_session(cuda, card_session):
    import json
    import urllib.request

    from orb_slam3_tpu_torch.utils import png

    system, _ = card_session
    v = system.start_viewer(port=0)
    try:
        base = f"http://127.0.0.1:{v.port}"
        stats = json.loads(urllib.request.urlopen(base + "/stats.json", timeout=10).read())
        assert stats["n_keyframes"] >= 2
        for ep in ("/map.png", "/frame.png"):
            assert urllib.request.urlopen(base + ep, timeout=30).read()[:8] == png.SIGNATURE
    finally:
        system.shutdown()


def test_the_fleet_step_launches_k2_once_over_eight_sessions(cuda):
    """The fleet at B = 8 (tests/test_fleet.py's sizes, local maps seeded
    from each frame's keypoints): K1 launched 8 times and K2 once, each
    session's (R, t, n) equal to its own step on the card."""
    from orb_slam3_tpu_torch import entry
    from orb_slam3_tpu_torch.frontend import camera as cam
    from orb_slam3_tpu_torch.frontend import orb
    from orb_slam3_tpu_torch.parallel import fleet

    B, H, W, L = 8, 128, 192, 256
    K = np.asarray([120.0, 120.0, 96.0, 64.0, 0, 0, 0, 0], np.float32)
    cfg = orb.OrbConfig(200, 2)
    cols = [[] for _ in range(9)]
    for b in range(B):
        img = entry.blob_frame(H, W, seed=b)
        f = orb.extract(torch.from_numpy(img), cfg)
        sc = entry.make_scene(f.xy.numpy(), f.octave.numpy(), f.descriptors.numpy(),
                              f.valid.numpy(), K, 2, L, seed=b)
        for i, a in enumerate([img] + [sc[k] for k in (
                "lm_pos", "lm_desc", "lm_valid", "lm_max_dist", "lm_min_dist", "lm_normal",
                "R0", "t0")]):
            cols[i].append(a)
    args = [torch.as_tensor(np.stack(c), device=cuda) for c in cols]
    step = fleet.make_fleet_step(cfg, K, img_wh=(W, H))
    k1, k2 = mk.launches, pk.launches
    R, t, n = step(*args)
    torch.cuda.synchronize()
    assert (mk.launches - k1, pk.launches - k2) == (8, 1)
    Kt = torch.as_tensor(K, device=cuda)
    for b in range(B):
        Rb, tb, nb = fleet._track_one(*(a[b] for a in args), cfg_orb=cfg, kind=cam.PINHOLE, K=Kt,
                                      img_wh=(float(W), float(H)),
                                      scale_factors=cfg.scale_factors(cuda), match_radius=15.0)
        assert int(nb) == int(n[b]) >= 50
        torch.testing.assert_close(R[b], Rb, rtol=0, atol=1e-5)
        torch.testing.assert_close(t[b], tb, rtol=0, atol=1e-4)


# ---------------------------------------------------------------------------
# the reference's operating scale: the grown arena (chip_smoke.py phase 16)
# ---------------------------------------------------------------------------

def test_a_grown_arena_reaches_the_mapper_on_its_own_stream(cuda):
    """A free-running RGB-D session at 256x192 with kmax 8, lmax 1024 and a
    keyframe every frame: the tracker compacts and doubles the arena while
    the mapper thread maps on its own stream. The mapper's next package
    takes the grown state across with record_stream (runtime/mapper.
    hand_over, after the package's event) and maps it on its stream; the
    session stays sound."""
    from orb_slam3_tpu_torch import entry
    from orb_slam3_tpu_torch.atlas import invariants
    from orb_slam3_tpu_torch.atlas import state as atlas_state
    from orb_slam3_tpu_torch.frontend import orb
    from orb_slam3_tpu_torch.mapping import fuse
    from orb_slam3_tpu_torch.runtime import mapper as mapper_mod

    K, wh = (200.0, 200.0, 128.0, 96.0), (256, 192)
    planes = entry.plane_scene(11)
    R, t = entry.orbit_trajectory(12, advance=0.02)
    frames = [entry.render_with_depth(planes, K, wh, R[i], t[i]) for i in range(12)]
    cfg = entry.tracker_config(cuda, img_wh=wh, K=K, sensor="rgbd", bf=20.0,
                               orb=orb.OrbConfig(300, 4), kmax=8, lmax=1024, local_window=4,
                               kf_max_frames=1)
    handed, fuse_at = [], []
    o_hand, o_fuse = mapper_mod.hand_over, fuse.fuse_into_keyframe

    def hand_rec(obj, stream):
        if isinstance(obj, atlas_state.MapState) and stream is not None:
            handed.append((obj.kmax, obj.lmax, stream.cuda_stream))
        return o_hand(obj, stream)

    def fuse_rec(kind, K8, s, *a, **kw):
        fuse_at.append((s.kmax, s.lmax, torch.cuda.current_stream(cuda).cuda_stream))
        return o_fuse(kind, K8, s, *a, **kw)

    mapper_mod.hand_over, fuse.fuse_into_keyframe = hand_rec, fuse_rec
    try:
        system = entry.slam(frames, cfg)
    finally:
        mapper_mod.hand_over, fuse.fuse_into_keyframe = o_hand, o_fuse
    tr = system.tracker
    m = tr.async_mapper
    try:
        assert tr.cfg.async_mapping and m._stream is not None
        side = m._stream.cuda_stream
        assert side != torch.cuda.current_stream(cuda).cuda_stream
        assert tr.map.kmax > 8 and tr.map.lmax > 1024
        assert (m._state.kmax, m._state.lmax) == (tr.map.kmax, tr.map.lmax)
        grown = (tr.map.kmax, tr.map.lmax)
        assert (grown[0], grown[1], side) in handed, handed
        assert {f[2] for f in fuse_at} == {side}
        assert any(f[:2] == grown for f in fuse_at), fuse_at
        ts, Rs, ts_, ok = tr.poses()
        assert ok[-4:].all() and invariants.check_all(tr.map) == []
    finally:
        system.shutdown()
